"""The training loop of the port (counterpart: lunaris_orion_tpu/train/loop.py).

`Trainer.train()` follows the JAX package's loop line by line:
  * trigger flags (--log_every, --save_every, --eval_save_freq,
    --sample_every) count micro-batches, as the reference's global_step
    does (train_hybrid.py:945-952);
  * per-step metrics stay on the device and are read on the host only at
    log boundaries; after queueing a step the host waits for the step two
    before it (an event recorded after each step), not for all of them;
  * epoch summary: mean loss, validation through `make_eval_step`, the
    best slot, early stopping on the epoch loss (the reference's never
    fires, SURVEY.md §2.2 #19);
  * periodic saves with rotation, a save on SIGINT, comparison grids and
    prior grids rendered in the training compute dtype;
  * a hang watchdog that exits with code 66 (`tools/supervise_train.py`);
  * with --cached_prompt_embeddings, the per-sample prompt-embedding table
    (`compute_embed_table`) is refreshed at every epoch that
    --embed_refresh_epochs divides; it stays on the device and each
    batch's rows are gathered there by the loader's indices.

Across ranks (`torchrun`, `--mesh_shape D M`): a (data, model) mesh of
`torch.distributed` ranks (`parallel.mesh`, the JAX package's
`train/loop.py:259-298`). --batch_size is the global batch; each rank
loads its data-axis slice. A model axis above 1 splits the VAE's
bottleneck FC pair by latent column (tensor parallelism) and, without
--attn_impl ring / allgather, the teacher's experts (expert parallelism);
ring / allgather split the teacher attention's tokens over it instead of
the experts, and need it above 1. The state is built whole, resumed
whole, then cut to each rank's part (`parallel.sharding.shard_state`); a
save gathers it back, so rank 0 writes the file a single process writes.
Rank 0 logs, writes TensorBoard and checkpoints; the ranks of data index
0 render the grids together; the metrics, the validation and the early
stop are the global batch's on every rank; the prompt-embedding table is
computed in row slices by the embed step (under expert parallelism, each
rank's experts' share summed over the model axis) and all-gathered, so
every rank holds all of it.

The JAX package compiles the step ahead and checks XLA's memory analysis
against the device (`_plan_and_compile`). Here `_plan` measures instead:
one probe micro-step (forward + backward) on copies of the models at each
candidate (remat off, then on; then half the batch, down to batch // 8),
its peak `torch.cuda.max_memory_allocated` plus the two AdamW moments,
against 0.92 of the device's memory (one AdamW moment in bf16 with
--bf16_momentum). The probe leaves the training state as it was, bit for
bit. Across ranks every rank takes the plan of the rank that needs the
most.
"""

from __future__ import annotations

import copy
import logging
import math
import os
import signal
import threading
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from lunaris_orion_tpu_torch.config import TrainConfig
from lunaris_orion_tpu_torch.data.dataset import (BatchLoader, SpriteDataset,
                                                  train_val_split)
from lunaris_orion_tpu_torch.device import resolve_device
from lunaris_orion_tpu_torch.models import teacher as teacher_mod
from lunaris_orion_tpu_torch.ops.rng import device_generator
from lunaris_orion_tpu_torch.parallel.collectives import (all_gather_tiled,
                                                         broadcast_)
from lunaris_orion_tpu_torch.parallel.mesh import (DATA_AXIS, MODEL_AXIS,
                                                   Mesh, init_mesh, launched)
from lunaris_orion_tpu_torch.parallel.sharding import (shard_state,
                                                       with_layout)
from lunaris_orion_tpu_torch.train.checkpoint import (CheckpointService,
                                                      load_checkpoint_file)
from lunaris_orion_tpu_torch.train.state import TrainState, create_state, state_for
from lunaris_orion_tpu_torch.train.step import (_compute_dtype,
                                                make_embed_step,
                                                make_eval_step,
                                                make_micro_step,
                                                make_train_step,
                                                normalize_images,
                                                step_parallel)
from lunaris_orion_tpu_torch.utils.hbm import device_memory_bytes
from lunaris_orion_tpu_torch.utils.image import comparison_grid, sample_grid
from lunaris_orion_tpu_torch.utils.logging import setup_logging
from lunaris_orion_tpu_torch.utils.metrics import MetricsWriter

# The memory plan's budget: the share of the device a step may take.
MEMORY_BUDGET = 0.92


class HangWatchdog:
    """Exits the process when no training heartbeat lands within
    `timeout_s` (a wedged device call blocks the host for ever; nothing in
    the process can recover it, so a supervisor restarts from the last
    checkpoint). A daemon thread polls; on a hang it logs CRITICAL and
    calls `on_hang()`, by default `os._exit(66)`, the contract of
    `tools/supervise_train.py`. Size the timeout above a step and above a
    checkpoint save."""

    EXIT_CODE = 66

    def __init__(self, timeout_s: float, logger,
                 on_hang: Optional[Callable[[], None]] = None,
                 poll_s: float = 10.0):
        self.timeout_s = float(timeout_s or 0)
        self.logger = logger
        self.poll_s = poll_s
        self._on_hang = on_hang or (lambda: os._exit(self.EXIT_CODE))
        self._last = time.monotonic()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def beat(self) -> None:
        self._last = time.monotonic()

    def start(self) -> None:
        if self.timeout_s > 0 and self._thread is None:
            self.beat()
            self._thread = threading.Thread(
                target=self._run, daemon=True, name="hang-watchdog")
            self._thread.start()

    def stop(self) -> None:
        self._stop.set()

    def _run(self) -> None:
        while not self._stop.wait(self.poll_s):
            idle = time.monotonic() - self._last
            if idle > self.timeout_s:
                self.logger.critical(
                    "HangWatchdog: no training heartbeat for %.0f s "
                    "(timeout %.0f s); a device call is wedged and the "
                    "process cannot recover. Exiting %d; restart with "
                    "--resume_from <output_dir>/checkpoints.",
                    idle, self.timeout_s, self.EXIT_CODE)
                self._on_hang()
                return


class EarlyStopping:
    """Patience counter on epoch loss (train_hybrid.py:206-225)."""

    def __init__(self, patience: int = 7, min_delta: float = 0.0):
        self.patience = patience
        self.min_delta = min_delta
        self.counter = 0
        self.best_loss: Optional[float] = None
        self.early_stop = False

    def __call__(self, loss: float) -> None:
        if self.best_loss is None:
            self.best_loss = loss
        elif loss > self.best_loss + self.min_delta:
            self.counter += 1
            if self.counter >= self.patience:
                self.early_stop = True
        else:
            self.best_loss = loss
            self.counter = 0


def _fmt(metrics: dict) -> str:
    return " ".join(f"{k}={float(v):.4f}" for k, v in sorted(metrics.items()))


def _attn_impl(cfg: TrainConfig) -> str:
    """The teacher attention's impl from the two knobs, by the JAX
    package's rule (conflicts between --attn_impl and --use_pallas raise),
    mapped to the port's: 'auto', 'full', 'ring', 'allgather', or 'flash'
    for both the JAX package's 'flash' (its XLA composition) and 'pallas':
    the port has one flash attention, K2. With --no-use_pallas,
    'allgather' runs without K2 (`step_parallel`'s cp_kernel)."""
    impl = getattr(cfg, "attn_impl", "auto")
    if impl != "auto":
        if cfg.use_pallas is True and impl != "pallas":
            raise ValueError(
                f"--attn_impl {impl} conflicts with --use_pallas; drop one")
        if cfg.use_pallas is False and impl == "pallas":
            raise ValueError(
                "--attn_impl pallas conflicts with --no-use_pallas")
    elif cfg.use_pallas is not None:
        impl = "pallas" if cfg.use_pallas else "flash"
    return {"pallas": "flash"}.get(impl, impl)


def compute_embed_table(embed_fn, state: TrainState, dataset: SpriteDataset,
                        *, batch_size: int, embedding_dim: int,
                        device: torch.device,
                        mesh: Optional[Mesh] = None) -> torch.Tensor:
    """The per-sample prompt-embedding table [len(dataset), embedding_dim]
    f32 on `device` (the JAX package's `compute_embed_table`): the dataset
    in chunks of `batch_size` through `embed_fn` (`make_embed_step`).
    Across ranks each data rank embeds its row slice of a chunk (a short
    last slice padded with the chunk's last row) and the slices are
    all-gathered over the data axis, so every rank holds the full table
    (the model axis's first rank's, which its peers take). Under expert
    parallelism every rank of the model axis runs the embed step on the
    same rows, each its own experts, whose share the step sums over the
    axis. Eval mode is per sample, so neither padding nor the split
    changes a row."""
    table = torch.empty(len(dataset), embedding_dim, dtype=torch.float32,
                        device=device)
    data = None if mesh is None else mesh.data
    for start in range(0, len(dataset), batch_size):
        idx = np.arange(start, min(start + batch_size, len(dataset)))
        if data is None:
            imgs = torch.from_numpy(dataset.gather(idx)).to(device)
            table[start:start + len(idx)] = embed_fn(state, imgs)
            continue
        per = -(-len(idx) // data.size)
        mine = idx[data.index * per:(data.index + 1) * per]
        mine = np.concatenate([mine, np.full(per - len(mine), idx[-1])])
        emb = embed_fn(state, torch.from_numpy(dataset.gather(mine)).to(device))
        table[start:start + len(idx)] = all_gather_tiled(
            emb, data, 0)[:len(idx)]
    if mesh is not None and mesh.model.size > 1:
        broadcast_([table], mesh.model)
    return table


def _check_mesh(cfg: TrainConfig, impl: str) -> None:
    """The mesh rules of the JAX Trainer that need no process group:
    context parallelism needs a model axis above 1 that divides the token
    count."""
    mp = 1 if cfg.mesh_shape is None else int(cfg.mesh_shape[1])
    if impl in ("ring", "allgather"):
        if mp <= 1:
            shape = dict(zip((DATA_AXIS, MODEL_AXIS),
                             cfg.mesh_shape or ("world size", 1)))
            raise ValueError(
                f"--attn_impl {impl} needs a mesh model axis > 1 (context "
                f"parallelism shards tokens over it); got mesh {shape}. "
                "Pass --mesh_shape DATA MODEL")
        n_tok = cfg.image_size * cfg.image_size
        if n_tok % mp:
            raise ValueError(
                f"--attn_impl {impl}: token count {n_tok} (image_size^2) is "
                f"not divisible by the model axis size {mp}")


class _NoMetrics:
    """The MetricsWriter of a rank that does not write (every rank but 0)."""

    def log(self, *args, **kwargs) -> None:
        pass

    def close(self) -> None:
        pass


def _rank_logger(rank: int) -> logging.Logger:
    """Every rank but 0 logs warnings to the console only."""
    logger = logging.getLogger(f"lunaris.rank{rank}")
    if not logger.handlers:
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter(
            f"%(asctime)s %(levelname)s [rank {rank}] %(message)s",
            datefmt="%H:%M:%S"))
        logger.addHandler(h)
    logger.setLevel(logging.WARNING)
    logger.propagate = False
    return logger


def _param_bytes(state: TrainState) -> int:
    """The bytes of the parameters this rank holds (its part under tensor
    and expert parallelism)."""
    return sum(p.numel() * p.element_size()
               for m in (state.vae, state.teacher) for p in m.parameters())


class Trainer:
    """Builds the run from a TrainConfig: device, data, state (fresh, a .pt
    file, or a checkpoint directory), the memory plan, the steps.

    The options `fast_rng`, `donate_state`, `compile`, `num_workers`,
    `chunk_size` and `memory_efficient` are accepted and change nothing:
    fast_rng picks JAX's PRNG implementation (the port draws from torch
    generators), donate_state lets XLA reuse the state's buffers (the
    port updates the state in place), compile / num_workers / chunk_size /
    memory_efficient are the reference's flags that it parses and ignores
    too (the loader is one thread, the attention blocking is the
    kernels')."""

    def __init__(self, cfg: TrainConfig):
        self.attn_impl = _attn_impl(cfg)
        _check_mesh(cfg, self.attn_impl)
        self.cfg = cfg
        # The card unless asked for the CPU; no card raises. Under torchrun
        # (or with a mesh over more than one rank) a process group: NCCL on
        # cuda:LOCAL_RANK, gloo on the CPU.
        want = "cpu" if cfg.force_cpu else "cuda"
        self.mesh: Optional[Mesh] = None
        if launched() or (cfg.mesh_shape is not None
                          and math.prod(cfg.mesh_shape) > 1):
            self.mesh = init_mesh(cfg.mesh_shape, device=want)
            self.device = self.mesh.device
        else:
            self.device = resolve_device(want)
        self.main = self.mesh is None or self.mesh.is_main
        self.vcfg = cfg.vae_config()
        self.tcfg = cfg.teacher_config()
        self._axes = {}
        if self.mesh is not None:
            self._axes = dict(mesh=self.mesh)
            if self.attn_impl in ("ring", "allgather"):
                self._axes.update(cp_mesh=self.mesh, cp_axis=MODEL_AXIS,
                                  cp_batch_axis=DATA_AXIS)
        self.out_dir = Path(cfg.output_dir)
        if self.main:
            self.logger = setup_logging(str(self.out_dir))
            self.metrics = MetricsWriter(str(self.out_dir / "tensorboard"))
        else:
            self.logger = _rank_logger(self.mesh.rank)
            self.metrics = _NoMetrics()
        (self.out_dir / "eval_samples").mkdir(parents=True, exist_ok=True)
        if cfg.debug_nans:
            # Anomaly detection: every backward op checks for NaN; slow,
            # a debugging aid as JAX's nan checking is.
            torch.autograd.set_detect_anomaly(True)
        self.logger.info("Device: %s (%s)", self.device,
                         torch.cuda.get_device_name(self.device)
                         if self.device.type == "cuda" else "host")
        if self.mesh is not None:
            self.logger.info("Mesh: %s over %s",
                             dict(zip((DATA_AXIS, MODEL_AXIS),
                                      self.mesh.shape)), self.mesh.backend)
        self._interrupted = False

        # --- data ---------------------------------------------------------
        self.dataset = SpriteDataset(cfg.data_dir, image_size=cfg.image_size)
        self.tr_idx, self.va_idx = train_val_split(
            len(self.dataset), cfg.val_fraction, cfg.seed)

        # --- state: fresh or resume ---------------------------------------
        self.ckpt = CheckpointService(str(self.out_dir / "checkpoints"),
                                      keep_n=cfg.keep_n_checkpoints,
                                      log=self.logger, mesh=self.mesh)
        self.state = create_state(cfg, self.device, cfg.seed, self.vcfg,
                                  self.tcfg)
        self.resume_ms = None
        if cfg.resume_from:
            t0 = time.perf_counter()
            if cfg.resume_from.endswith(".pt"):
                # A reference-layout file: params, BN stats, both AdamW
                # states and the schedule position carry over; baseline and
                # generator too when the port wrote it.
                load_checkpoint_file(cfg.resume_from, self.state, cfg)
            else:
                same = (Path(cfg.resume_from).absolute()
                        == (self.out_dir / "checkpoints").absolute())
                resume = self.ckpt if same else CheckpointService(
                    cfg.resume_from, keep_n=cfg.keep_n_checkpoints,
                    log=self.logger, mesh=self.mesh)
                resume.restore(self.state, config=cfg)
                if not same:
                    resume.close()
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.resume_ms = (time.perf_counter() - t0) * 1e3
            self.logger.info("Resumed from %s at step %d in %.1f ms",
                             cfg.resume_from, self.state.step, self.resume_ms)
        if self.mesh is not None and self.mesh.model.size > 1:
            shard_state(self.state, self.mesh, shard_experts=self.attn_impl
                        not in ("ring", "allgather"))
            layout = self.state.layout
            self.logger.info("Model axis %d: %s", self.mesh.model.size,
                             "nothing split" if layout is None else
                             ", ".join(n for n, on in (
                                 ("FC pair split", layout.tp),
                                 ("experts split", layout.ep)) if on))

        # --- memory plan, steps --------------------------------------------
        self.cfg, self.remat, self.plan_need = self._plan(cfg)
        cfg = self.cfg
        self.train_step = make_train_step(cfg, remat=self.remat,
                                          attn_impl=self.attn_impl,
                                          **self._axes)
        self.eval_step = make_eval_step(cfg, attn_impl=self.attn_impl,
                                        **self._axes)

        # --- loaders ------------------------------------------------------
        device_data = cfg.device_data
        shard = ((0, 1) if self.mesh is None
                 else (self.mesh.data.index, self.mesh.data.size))
        if device_data and shard[1] > 1:
            self.logger.warning(
                "--device_data: a corpus resident on each of %d data ranks "
                "is not implemented; streaming instead", shard[1])
            device_data = False
        if device_data:
            corpus = ((len(self.tr_idx) + len(self.va_idx))
                      * cfg.image_size * cfg.image_size * 3)
            total = device_memory_bytes(self.device)
            if (self.plan_need and total
                    and self.plan_need + corpus > MEMORY_BUDGET * total):
                self.logger.warning(
                    "--device_data: corpus %.2f GB + step %.2f GB exceeds "
                    "the %.2f GB budget; streaming instead",
                    corpus / 2**30, self.plan_need / 2**30,
                    MEMORY_BUDGET * total / 2**30)
                device_data = False
            else:
                self.logger.info(
                    "--device_data: corpus resident on %s (%.2f GB; batches "
                    "gather on the device)", self.device, corpus / 2**30)
        self.train_loader = BatchLoader(
            self.dataset, self.tr_idx, batch_size=cfg.batch_size,
            # steps_per_call K: the loader stages K*accum micro-batches at
            # once; train() runs K steps on them.
            accum_steps=cfg.gradient_accumulation_steps * cfg.steps_per_call,
            seed=cfg.seed, device=self.device, prefetch=cfg.prefetch_depth,
            with_indices=cfg.cached_prompt_embeddings,
            device_data=device_data, data_shard=shard)
        self.val_loader = BatchLoader(
            self.dataset, self.va_idx, batch_size=cfg.batch_size,
            accum_steps=1, seed=cfg.seed, shuffle=False, squeeze_accum=True,
            device=self.device, prefetch=cfg.prefetch_depth,
            device_data=device_data, data_shard=shard)
        self.logger.info("Dataset: %d sprites (%d train / %d val batches)",
                         len(self.dataset), len(self.train_loader),
                         len(self.val_loader))
        n_vae = sum(p.numel() for p in self.state.vae.parameters())
        n_teacher = sum(p.numel() for p in self.state.teacher.parameters())
        self.logger.info("VAE params: %s | Teacher params: %s%s",
                         f"{n_vae:,}", f"{n_teacher:,}",
                         "" if self.state.layout is None
                         else " (this rank's part)")
        self.early = EarlyStopping(cfg.early_stopping_patience)
        self._embed_fn = None
        self._embed_table: Optional[torch.Tensor] = None

    # ------------------------------------------------------------------
    def _probe(self, cfg: TrainConfig, remat: bool) -> None:
        """One micro-step (forward + backward) at `cfg` on copies of the
        models, with their own generator, baseline and gradients: the
        training state is left as it was, bit for bit."""
        st = self.state
        probe = state_for(cfg, copy.deepcopy(st.vae), copy.deepcopy(st.teacher),
                          generator=torch.Generator().manual_seed(cfg.seed))
        probe.layout = st.layout
        micro = make_micro_step(cfg, remat=remat, attn_impl=self.attn_impl,
                                par=step_parallel(cfg, **self._axes))
        b = cfg.batch_size // (1 if self.mesh is None else self.mesh.data.size)
        images = torch.zeros((b, cfg.image_size, cfg.image_size,
                              3), dtype=torch.uint8, device=self.device)
        pe = (torch.zeros(b, self.tcfg.embedding_dim,
                          device=self.device)
              if cfg.cached_prompt_embeddings else None)
        micro(probe, images, probe.baseline, probe.baseline_initialized, pe)

    def _probe_need(self, cfg: TrainConfig, remat: bool) -> float:
        """Device bytes one training step at `cfg` needs: the peak of
        `_probe` (the copied models, their gradients and the activations)
        above what was allocated before it, plus the two AdamW moments (the
        first in bf16 with bf16_momentum); inf when the probe runs out of
        memory."""
        dev = self.device
        torch.cuda.synchronize(dev)
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        try:
            self._probe(cfg, remat)
            torch.cuda.synchronize(dev)
            moments = 1.5 if cfg.bf16_momentum else 2.0
            need = (torch.cuda.max_memory_allocated(dev) - base
                    + moments * _param_bytes(self.state))
        except torch.cuda.OutOfMemoryError:
            need = math.inf
        torch.cuda.empty_cache()
        return need if self.mesh is None else self.mesh.world_max(need)

    def _plan(self, cfg: TrainConfig) -> Tuple[TrainConfig, bool,
                                               Optional[float]]:
        """(config with the batch that fits, remat, bytes the step needs).
        The JAX package's rule: with cfg.remat None try remat off, then on;
        if neither fits in MEMORY_BUDGET of the device, halve the batch,
        down to batch_size // 8. Without a memory figure (the CPU) the
        first candidate is taken."""
        remats = (False, True) if cfg.remat is None else (bool(cfg.remat),)
        total = device_memory_bytes(self.device)
        if total is None:
            self.logger.info("Memory plan: batch %d, remat=%s (no device "
                             "memory figure on %s)", cfg.batch_size,
                             remats[0], self.device)
            return cfg, remats[0], None
        min_bs = max(cfg.batch_size // 8, 1)
        bs = cfg.batch_size
        while True:
            trial = cfg.replace(batch_size=bs)
            for remat in remats:
                t0 = time.perf_counter()
                need = self._probe_need(trial, remat)
                self.logger.info(
                    "Memory probe: batch %d remat=%s needs %.2f GiB of the "
                    "%.2f GiB budget (%.1f s, the kernels' first build "
                    "included)", bs, remat, need / 2**30,
                    MEMORY_BUDGET * total / 2**30, time.perf_counter() - t0)
                if need < MEMORY_BUDGET * total:
                    if bs != cfg.batch_size:
                        self.logger.warning("Memory plan: batch_size %d -> %d",
                                            cfg.batch_size, bs)
                    self.logger.info(
                        "Memory plan: batch %d, remat=%s, peak %.2f GiB of "
                        "%.2f GiB", bs, remat, need / 2**30, total / 2**30)
                    return trial, remat, need
            if bs <= min_bs:
                raise RuntimeError(
                    f"train step does not fit the device even at batch "
                    f"{min_bs}; reduce model dims or raise "
                    "gradient_accumulation_steps")
            bs //= 2

    def _refresh_embed_table(self) -> None:
        """Recompute the prompt-embedding table from the current teacher
        (eval mode; the JAX package's `_refresh_embed_table`)."""
        if self._embed_fn is None:
            self._embed_fn = make_embed_step(self.cfg,
                                             attn_impl=self.attn_impl,
                                             **self._axes)
        t0 = time.perf_counter()
        self._embed_table = compute_embed_table(
            self._embed_fn, self.state, self.dataset,
            batch_size=self.cfg.batch_size,
            embedding_dim=self.tcfg.embedding_dim, device=self.device,
            mesh=self.mesh)
        self._sync()
        self.logger.info("Prompt-embedding table refreshed (%d samples, "
                         "%.1f ms)", len(self.dataset),
                         (time.perf_counter() - t0) * 1e3)

    def _prompt_embeddings(self, idx: np.ndarray) -> torch.Tensor:
        """The table's rows for a batch's dataset indices [A, B], gathered
        on the device: [A, B, E]."""
        rows = torch.from_numpy(np.ascontiguousarray(idx, np.int64))
        return self._embed_table[rows.to(self.device)]

    # ------------------------------------------------------------------
    def _handle_interrupt(self, signum, frame):
        self.logger.warning("Interrupt received; saving checkpoint...")
        self._interrupted = True

    def _micro_crossed(self, every: int, step: int) -> bool:
        """True if any micro-step in the last optimizer step hit `every`
        (the reference counts micro-batches, train_hybrid.py:945-952)."""
        return self._crossed_range(every, step - 1, step)

    def _crossed_range(self, every: int, lo: int, hi: int) -> bool:
        """True if any micro-step in optimizer steps (lo, hi] hit `every`."""
        a = self.cfg.gradient_accumulation_steps
        return ((hi * a) // every != (lo * a) // every) if every > 0 else False

    @torch.no_grad()
    def _save_eval_samples(self, batch4: torch.Tensor) -> None:
        """Original-vs-recon grid (eval mode, mean latent) of the batch in
        flight (train_hybrid.py:718-789, 951-952), in the training compute
        dtype. Across ranks: rank 0's batch, scored by the ranks of data
        index 0 (context parallelism needs all of them); rank 0 saves."""
        if self.mesh is not None and self.mesh.data.index != 0:
            return
        par = with_layout(step_parallel(self.cfg, **self._axes),
                          self.state.layout)
        x = normalize_images(batch4, _compute_dtype(self.cfg))
        recon, _, _ = self.state.vae(x, sample_posterior=False,
                                     tp=par and par.tp)
        out = teacher_mod.apply(self.state.teacher, recon,
                                attn_impl=self.attn_impl, par=par)
        if not self.main:
            return
        grid = comparison_grid(
            x.float().cpu().numpy(), recon.float().cpu().numpy(),
            quality=out["quality_scores"].float().cpu().numpy(),
            semantic=out["semantic_score"].float().cpu().numpy())
        path = (self.out_dir / "eval_samples"
                / f"comparison_{self.state.step}_{int(time.time())}.png")
        grid.save(path)
        self.logger.info("Saved eval grid -> %s", path)

    @torch.no_grad()
    def _save_prior_samples(self) -> None:
        """Prior-decode grid every --sample_every micro-steps (the
        reference parses the flag and never implements it, SURVEY.md
        §2.8). z comes from its own generator, seeded by (seed, step): the
        training generator does not advance. The ranks of data index 0
        decode (together, under tensor parallelism); rank 0 saves."""
        if self.mesh is not None and self.mesh.data.index != 0:
            return
        par = with_layout(step_parallel(self.cfg, **self._axes),
                          self.state.layout)
        gen = device_generator(self.cfg.seed * 1_000_003 + self.state.step,
                               self.device)
        imgs = self.state.vae.sample(4, gen, dtype=_compute_dtype(self.cfg),
                                     tp=par and par.tp)
        if not self.main:
            return
        path = (self.out_dir / "eval_samples"
                / f"samples_{self.state.step}_{int(time.time())}.png")
        sample_grid(imgs.float().cpu().numpy()).save(path)
        self.logger.info("Saved prior-sample grid -> %s", path)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _save(self, step: int, **kw) -> None:
        t0 = time.perf_counter()
        self.ckpt.save(step, self.state, config=self.cfg, **kw)
        self.logger.info("Checkpoint step %d%s handed to the writer in "
                         "%.1f ms", step, " (best)" if kw.get("best") else "",
                         (time.perf_counter() - t0) * 1e3)

    def _profiler(self):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        return profile(activities=acts)

    # ------------------------------------------------------------------
    def train(self) -> dict:
        cfg = self.cfg
        old_sigint = signal.signal(signal.SIGINT, self._handle_interrupt)
        result = {"stopped_early": False, "epochs": 0, "best_loss": math.inf}
        best_loss = (self.state.best_loss if math.isfinite(self.state.best_loss)
                     else math.inf)
        host_step = self.state.step
        spc = max(int(cfg.steps_per_call), 1)
        acc = cfg.gradient_accumulation_steps
        watchdog = HangWatchdog(cfg.hang_watchdog_secs, self.logger)
        watchdog.start()
        prof = None
        try:
            cached = cfg.cached_prompt_embeddings
            for epoch in range(cfg.num_epochs):
                self.train_loader.set_epoch(epoch)
                if cached and epoch % max(cfg.embed_refresh_epochs, 1) == 0:
                    self._refresh_embed_table()
                t_epoch = time.perf_counter()
                losses: List[torch.Tensor] = []   # read at epoch end only
                done: List[torch.cuda.Event] = []
                n_img = 0
                for item in self.train_loader:
                    batch, pe = ((item[0], self._prompt_embeddings(item[1]))
                                 if cached else (item, None))
                    if (cfg.profile_steps > 0 and epoch == 0
                            and host_step == 2 and self.main):
                        prof = self._profiler()
                        prof.__enter__()
                    prev_step = host_step
                    step_metrics: List[Dict[str, torch.Tensor]] = []
                    for k in range(spc):
                        self.state, m = self.train_step(
                            self.state, batch[k * acc:(k + 1) * acc],
                            None if pe is None else pe[k * acc:(k + 1) * acc])
                        step_metrics.append(m)
                        losses.append(m["total_loss"])
                        if self.device.type == "cuda":
                            ev = torch.cuda.Event()
                            ev.record()
                            done.append(ev)
                    host_step += spc
                    if prof is not None and host_step >= 2 + cfg.profile_steps:
                        self._sync()
                        prof.__exit__(None, None, None)
                        (self.out_dir / "profile").mkdir(exist_ok=True)
                        trace = self.out_dir / "profile" / "trace.json"
                        prof.export_chrome_trace(str(trace))
                        prof = None
                        self.logger.info("Profiler trace -> %s", trace)
                    # A sliding window: wait for the step two before this
                    # one, so the host queues ahead without running away.
                    if len(done) >= 3:
                        done[-3].synchronize()
                        del done[:-3]
                    # Heartbeat after the wait: a wedged device call stops
                    # it, and the watchdog fires.
                    watchdog.beat()
                    n_img += cfg.batch_size * acc * spc

                    for s in range(prev_step + 1, host_step + 1):
                        if self._micro_crossed(cfg.log_every, s):
                            ms = step_metrics[s - prev_step - 1]
                            self.metrics.log(ms, s * acc)
                            self.logger.info("step %d | %s", s, _fmt(ms))
                    if self._crossed_range(cfg.eval_save_freq, prev_step,
                                           host_step):
                        self._save_eval_samples(batch[0, :4])
                    if self._crossed_range(cfg.sample_every, prev_step,
                                           host_step):
                        self._save_prior_samples()
                    if self._crossed_range(cfg.save_every, prev_step,
                                           host_step):
                        self._save(host_step)
                    if self._interrupted:
                        raise KeyboardInterrupt
                self._sync()
                dt = time.perf_counter() - t_epoch

                # ---- epoch summary --------------------------------------
                avg_loss = (torch.stack(losses).double().mean().item()
                            if losses else math.nan)
                t_val = time.perf_counter()
                val_sums: Dict[str, List[torch.Tensor]] = {}
                for vb in self.val_loader:
                    for k, v in self.eval_step(self.state, vb).items():
                        val_sums.setdefault(k, []).append(v)
                    watchdog.beat()
                val_metrics = {k: float(torch.stack(v).double().mean())
                               for k, v in val_sums.items()}
                val_ms = (time.perf_counter() - t_val) * 1e3
                ips = n_img / dt if dt > 0 else 0.0
                self.logger.info(
                    "epoch %d/%d | avg_loss=%.4f | %s | %.1f sprites/s (%.1fs)",
                    epoch + 1, cfg.num_epochs, avg_loss,
                    _fmt(val_metrics), ips, dt)
                self.logger.info("validation: %d batches in %.1f ms",
                                 len(self.val_loader), val_ms)
                if self.device.type == "cuda":
                    val_metrics["device_mem_gb"] = (
                        torch.cuda.memory_allocated(self.device) / 2**30)
                self.metrics.log({"epoch_loss": avg_loss,
                                  "sprites_per_sec": ips, **val_metrics},
                                 host_step * acc, prefix="epoch")

                is_best = math.isfinite(avg_loss) and avg_loss < best_loss
                if is_best:
                    best_loss = avg_loss
                    self.state.best_loss = best_loss
                self._save(host_step, best=is_best, force=True)
                watchdog.beat()
                result["epochs"] = epoch + 1
                result["best_loss"] = best_loss

                self.early(avg_loss if math.isfinite(avg_loss) else math.inf)
                if self.early.early_stop:
                    self.logger.info("Early stopping at epoch %d", epoch + 1)
                    result["stopped_early"] = True
                    break
        except KeyboardInterrupt:
            self.logger.warning("Interrupted; saving final checkpoint")
            self._save(host_step, force=True)
            result["interrupted"] = True
        finally:
            if prof is not None:
                prof.__exit__(None, None, None)
            watchdog.stop()
            t0 = time.perf_counter()
            self.ckpt.wait()
            self.logger.info("Checkpoint writes finished %.1f ms after the "
                             "loop", (time.perf_counter() - t0) * 1e3)
            self.metrics.close()
            signal.signal(signal.SIGINT, old_sigint)
        return result
