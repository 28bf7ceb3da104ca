"""Sprite-shard dataset and the batch loader that feeds the device
(counterpart: lunaris_orion_tpu/data/dataset.py).

Data contract (the reference's, train_hybrid.py:100-147 /
generate.py:858-904): a directory of
  * `sprites*.npy` -- uint8 arrays of shape (N, H, W, 3), H = W = 128,
  * `labels*.csv`  -- rows with columns filename, category, prompt, seed,
    pixel_size, guidance_scale, pag_scale, num_steps,
with as many rows in all as sprites.

Sprites stay uint8 on the host; the train step normalizes them on the
device. Batches are gathered from the memory maps by the native C++
gatherer (`data/native.py`, built with g++ at first use), or, where it
does not build, with numpy fancy indexing, one sorted read a shard;
`SpriteDataset.native` says which. On a CUDA device a prefetch thread
copies each batch into pinned memory and on to the card on a side stream,
so host reads overlap the step; with `device_data` the loader's whole
subset stays resident on the card and only an index vector crosses a
batch. Labels are read with the `csv` module.

Across ranks, every rank walks the same per-epoch permutation and gathers
only its data-axis slice of each global batch (`BatchLoader`'s
`data_shard`); the ranks of a model row, which share a data index, load
the same rows.
"""

from __future__ import annotations

import csv
import logging
import queue
import threading
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from lunaris_orion_tpu_torch.data.native import NativeGatherer

logger = logging.getLogger(__name__)
# The gather path is logged once a process.
_logged_path = False

LABEL_COLUMNS = ("filename", "category", "prompt", "seed", "pixel_size",
                 "guidance_scale", "pag_scale", "num_steps")


def _column(values: List[str]) -> np.ndarray:
    """A CSV column as pandas reads it: int64 when every value is an
    integer, float64 when every value is a number, else str objects."""
    for kind in (int, float):
        try:
            return np.array([kind(v) for v in values],
                            np.int64 if kind is int else np.float64)
        except ValueError:
            pass
    return np.array(values, dtype=object)


def _read_labels(files: List[Path]) -> Dict[str, np.ndarray]:
    """The rows of every labels file, in file order, column by column (the
    first file's header names the columns)."""
    names: Optional[List[str]] = None
    rows: List[Dict[str, str]] = []
    for f in files:
        with open(f, newline="") as fh:
            reader = csv.DictReader(fh)
            names = names or list(reader.fieldnames or ())
            rows.extend(reader)
    return {c: _column([r.get(c, "") for r in rows]) for c in names or ()}


class SpriteDataset:
    """Memory-mapped multi-shard sprite dataset with CSV metadata."""

    def __init__(self, data_dir: str, *, image_size: int = 128,
                 load_labels: bool = True, validate_counts: bool = True):
        self.data_dir = Path(data_dir)
        self.image_size = image_size
        self.sprites_files = sorted(self.data_dir.glob("sprites*.npy"))
        self.labels_files = sorted(self.data_dir.glob("labels*.csv"))
        if not self.sprites_files or (load_labels and not self.labels_files):
            raise ValueError(
                f"No sprites or labels files found in {data_dir}")

        self.shards: List[np.ndarray] = []
        for f in self.sprites_files:
            arr = np.load(f, mmap_mode="r")
            if arr.shape[1:] != (image_size, image_size, 3):
                raise ValueError(
                    f"Expected {image_size}x{image_size}x3 images in {f}, "
                    f"got {arr.shape[1:]}")
            self.shards.append(arr)
            logger.info("Loaded %s with %d images", f.name, len(arr))
        self.cumulative = np.cumsum([0] + [len(s) for s in self.shards])
        self._native = None
        try:
            self._native = NativeGatherer(self.shards)
        except Exception as e:  # no toolchain: the numpy gather
            logger.debug("native gather disabled: %s", e)
        global _logged_path
        if not _logged_path:
            _logged_path = True
            logger.info("Batch gather: %s", "native (C++)" if self.native
                        else "numpy")

        self.labels: Optional[Dict[str, np.ndarray]] = None
        if load_labels and self.labels_files:
            self.labels = _read_labels(self.labels_files)
            n_rows = len(next(iter(self.labels.values()), ()))
            if validate_counts and n_rows != len(self):
                raise ValueError(
                    f"Mismatch between total sprites ({len(self)}) and "
                    f"labels ({n_rows})")

    def __len__(self) -> int:
        return int(self.cumulative[-1])

    @property
    def native(self) -> bool:
        """True when `gather` runs the native C++ gatherer."""
        return self._native is not None

    def metadata(self, idx: int) -> dict:
        if self.labels is None:
            return {}
        return {c: self.labels[c][idx] for c in LABEL_COLUMNS
                if c in self.labels}

    def metadata_batch(self, indices: np.ndarray) -> dict:
        """Column-wise metadata for a batch of indices: {column: np.ndarray}.
        The reference's per-sample 8-field metadata dict
        (train_hybrid.py:186-195), vectorized. Empty without labels."""
        if self.labels is None:
            return {}
        idx = np.asarray(indices)
        return {c: self.labels[c][idx] for c in LABEL_COLUMNS
                if c in self.labels}

    def gather(self, indices: np.ndarray) -> np.ndarray:
        """Vectorized uint8 gather across shards -> [n, H, W, 3], by the
        native gatherer when it was built (`native`)."""
        if self._native is not None:
            return self._native.gather(indices)
        return self.gather_numpy(indices)

    def gather_numpy(self, indices: np.ndarray) -> np.ndarray:
        """The numpy gather: one sorted read a shard."""
        indices = np.asarray(indices)
        shard_ids = np.searchsorted(self.cumulative, indices, side="right") - 1
        out = np.empty((len(indices), self.image_size, self.image_size, 3),
                       np.uint8)
        for sid in np.unique(shard_ids):
            sel = np.flatnonzero(shard_ids == sid)
            local = indices[sel] - self.cumulative[sid]
            order = np.argsort(local)  # sorted memmap reads
            out[sel[order]] = self.shards[sid][local[order]]
        return out


def train_val_split(n: int, val_fraction: float, seed: int
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic shuffled split (reference: random_split 90/10 with the
    global torch seed, train_hybrid.py:551-555)."""
    perm = np.random.default_rng(seed).permutation(n)
    n_val = int(round(n * val_fraction))
    return perm[n_val:], perm[:n_val]


class BatchLoader:
    """Yields uint8 batches [accum, micro_b, H, W, 3] ([n, H, W, 3] with
    `squeeze_accum`): numpy arrays when `device` is None, tensors on
    `device` otherwise.

    Shuffles per epoch with np.random.default_rng((seed, epoch)) and drops
    the ragged tail (reference drop_last=True, train_hybrid.py:569): the
    JAX package's order, batch for batch. On a CUDA device a prefetch
    thread stages `prefetch` batches ahead: pinned host memory, a
    non-blocking copy on a side stream, and an event that the consuming
    stream waits on. With `device_data` this loader's subset is gathered
    once into a uint8 tensor on `device` and each batch is an
    `index_select` from it. `with_indices` also yields the batch's dataset
    indices.

    `data_shard` (index, count): this rank's place on the data axis. The
    global batch [accum, batch_size] is cut along its batch axis (axis 1;
    the flat batch with `squeeze_accum`) into `count` equal slices and the
    loader yields slice `index`: [accum, batch_size / count] (the JAX
    package's `_local_slice`).
    """

    def __init__(self, dataset: SpriteDataset, indices: np.ndarray, *,
                 batch_size: int, accum_steps: int = 1, seed: int = 0,
                 shuffle: bool = True,
                 device: Optional[torch.device | str] = None,
                 prefetch: int = 2, squeeze_accum: bool = False,
                 with_indices: bool = False,
                 device_data: bool = False,
                 data_shard: Tuple[int, int] = (0, 1)):
        self.ds = dataset
        self.indices = np.asarray(indices)
        self.batch_size = batch_size
        self.accum = accum_steps
        self.seed = seed
        self.shuffle = shuffle
        self.device = None if device is None else torch.device(device)
        self.prefetch = max(int(prefetch), 1)
        self.squeeze_accum = squeeze_accum and accum_steps == 1
        self.with_indices = with_indices
        self.data_shard = (int(data_shard[0]), int(data_shard[1]))
        if batch_size % self.data_shard[1]:
            raise ValueError(f"global batch {batch_size} is not divisible by "
                             f"{self.data_shard[1]} data ranks")
        self.epoch = 0
        self._corpus: Optional[torch.Tensor] = None
        if device_data:
            if self.device is None:
                raise ValueError("device_data needs a device")
            # Corpus rows follow self.indices; epochs permute positions.
            self._corpus = torch.from_numpy(
                dataset.gather(self.indices)).to(self.device)
            self._order = np.argsort(self.indices)
            self._sorted = self.indices[self._order]

    def __len__(self) -> int:
        return len(self.indices) // (self.batch_size * self.accum)

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def _chunks(self) -> Iterator[np.ndarray]:
        """Each batch's dataset indices, in this epoch's order: this rank's
        data-axis slice of the global batch."""
        idx = self.indices
        if self.shuffle:
            rng = np.random.default_rng((self.seed, self.epoch))
            idx = rng.permutation(idx)
        step = self.batch_size * self.accum
        i, n = self.data_shard
        for start in range(0, len(idx) - step + 1, step):
            chunk = idx[start:start + step]
            if n > 1:
                chunk = chunk.reshape(self.accum, n, -1)[:, i].reshape(-1)
            yield chunk

    def _shape(self, flat):
        return flat if self.squeeze_accum else flat.reshape(
            self.accum, -1, *flat.shape[1:])

    def _extras(self, chunk: np.ndarray) -> tuple:
        return (self._shape(chunk),) if self.with_indices else ()

    def _host_batches(self) -> Iterator[tuple]:
        for chunk in self._chunks():
            yield (self._shape(self.ds.gather(chunk)), *self._extras(chunk))

    def _device_batches(self) -> Iterator[tuple]:
        """Batches gathered on the device from the resident corpus: the
        same order as the host path; an int64 position vector crosses."""
        for chunk in self._chunks():
            pos = self._order[np.searchsorted(self._sorted, chunk)]
            pos = torch.from_numpy(pos.astype(np.int64)).to(self.device)
            yield (self._shape(self._corpus.index_select(0, pos)),
                   *self._extras(chunk))

    def _staged_batches(self) -> Iterator[tuple]:
        """Host batches copied to the card by a prefetch thread: pinned
        memory, a non-blocking copy on a side stream, an event the
        consuming stream waits on, and record_stream so the caching
        allocator does not hand the batch's memory out again while that
        stream may still read it."""
        dev = self.device
        side = torch.cuda.Stream(dev)
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        sentinel = object()
        err: list = []

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def producer():
            try:
                with torch.cuda.device(dev), torch.cuda.stream(side):
                    for host, *extras in self._host_batches():
                        batch = torch.from_numpy(host).pin_memory().to(
                            dev, non_blocking=True)
                        ready = torch.cuda.Event()
                        ready.record(side)
                        if not put((batch, ready, extras)):
                            return
            except Exception as e:  # raised again by the consumer
                err.append(e)
            finally:
                put(sentinel)

        t = threading.Thread(target=producer, daemon=True,
                             name="batch-prefetch")
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                batch, ready, extras = item
                compute = torch.cuda.current_stream(dev)
                compute.wait_event(ready)
                batch.record_stream(compute)
                yield (batch, *extras)
        finally:
            stop.set()
            t.join(timeout=60)
        if err:
            raise err[0]

    def __iter__(self):
        if self._corpus is not None:
            items = self._device_batches()
        elif self.device is None:
            items = self._host_batches()
        elif self.device.type == "cuda":
            items = self._staged_batches()
        else:
            items = ((torch.from_numpy(b), *extras)
                     for b, *extras in self._host_batches())
        for item in items:
            yield item if len(item) > 1 else item[0]
