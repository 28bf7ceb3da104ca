"""The port's native batch gatherer (data/native.py + native/gather.cpp,
built with g++ at first use) against the numpy gather and against the JAX
package's own `NativeGatherer` / `native_shuffle` (lunaris_orion_tpu/
data/native.py), on a corpus of 3 shards."""

import numpy as np
import pytest
from test_torch_kernels import torch_threads  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    """3 sprite shards of 7, 1 and 12 images at 16 px, as memory maps (the
    loader's form), in a dataset directory with their labels."""
    from lunaris_orion_tpu_torch.data.synthetic import write_synthetic_dataset
    d = tmp_path_factory.mktemp("native")
    for i, n in enumerate((7, 1, 12)):
        write_synthetic_dataset(d / f"part{i}", n, image_size=16, seed=i)
    out = d / "sprites"
    out.mkdir()
    arrays = []
    for i in range(3):
        (sprites,) = (d / f"part{i}").glob("sprites*.npy")
        (labels,) = (d / f"part{i}").glob("labels*.csv")
        np.save(out / f"sprites_{i}.npy", np.load(sprites))
        (out / f"labels_{i}.csv").write_text(labels.read_text())
        arrays.append(np.load(out / f"sprites_{i}.npy", mmap_mode="r"))
    return out, arrays


def _indices():
    """Unsorted, repeated, across every shard boundary (7 and 8)."""
    return np.array([19, 0, 7, 7, 6, 8, 3, 19, 12, 0, 8, 1, 18, 6])


def test_native_gather_is_the_numpy_gather(shards):
    """The dataset gathers through the native library (g++ builds it) and
    returns the numpy gather's bytes, and the JAX package's gatherer's; an
    index outside the corpus raises IndexError."""
    from lunaris_orion_tpu.data.native import NativeGatherer as JaxGatherer
    from lunaris_orion_tpu_torch.data import native
    from lunaris_orion_tpu_torch.data.dataset import SpriteDataset
    path, arrays = shards
    ds = SpriteDataset(str(path), image_size=16)
    assert ds.native and len(ds) == 20
    assert native.library_path().is_file()
    idx = _indices()
    got = ds.gather(idx)
    assert got.dtype == np.uint8 and got.shape == (len(idx), 16, 16, 3)
    np.testing.assert_array_equal(got, ds.gather_numpy(idx))
    np.testing.assert_array_equal(got, JaxGatherer(arrays).gather(idx))
    assert ds.gather(idx[:0]).shape == (0, 16, 16, 3)
    for bad in ([20], [-1]):
        with pytest.raises(IndexError):
            ds.gather(np.array(bad))


@pytest.mark.parametrize("seed", [0, 7, 2**63 + 5])
def test_native_shuffle_is_the_jax_shuffle(seed):
    """SplitMix64 Fisher-Yates: the port's `native_shuffle` is the JAX
    package's, bit for bit, for unsorted, repeated indices; it leaves its
    input as it was and permutes it."""
    from lunaris_orion_tpu.data.native import native_shuffle as jax_shuffle
    from lunaris_orion_tpu_torch.data.native import native_shuffle
    idx = np.array([5, 3, 3, 9, 0, 12, 7, 7, 1, 2, 30, 4], np.int64)
    keep = idx.copy()
    got = native_shuffle(idx, seed)
    np.testing.assert_array_equal(idx, keep)
    np.testing.assert_array_equal(got, jax_shuffle(idx.copy(), seed))
    np.testing.assert_array_equal(np.sort(got), np.sort(keep))
    assert not np.array_equal(got, keep)
