"""Checkpoints of the port (counterpart: lunaris_orion_tpu/train/checkpoint.py,
with `torch.save` in place of Orbax).

Layout under the checkpoint directory:
  steps/<step>.pt   the newest `keep_n` step checkpoints (older ones rotate out)
  best.pt           the checkpoint of the best epoch loss
  config.json       the run's TrainConfig, written once

Each .pt is a reference-layout checkpoint (train_hybrid.py:594-615; the
keys lunaris_orion_tpu/utils/torch_compat.py `torch_checkpoint_from_state`
writes): global_step, vae_state_dict, teacher_state_dict, vae_optimizer,
teacher_optimizer, vae_scheduler, teacher_scheduler, best_loss and args,
plus baseline, baseline_initialized and generator_state, which make the
port's own resume exact. Every tensor is a CPU tensor. So the port's
ImageGenerator reads one, and the JAX Trainer resumes from one with
`--resume_from <file>.pt`. A .pt without the three extra keys (a reference
run's, or one `lunaris-convert to-torch` wrote) resets the baseline and
seeds the generator from cfg.seed, as the JAX package does on a reference
resume.

A save copies the state to the host in the caller's thread, then writes
the file in a background thread, as Orbax's asynchronous saves do;
`wait()` waits for the writes and raises the first that failed.

Across ranks (`mesh`): rank 0 writes; every rank keeps the list of saved
steps, and `wait()` (which `restore` calls first) ends on a barrier of all
ranks after rank 0's writes, so every rank resumes from the same, whole
file. A state split over the model axis (tensor and expert parallelism)
is gathered first by the ranks of data index 0 (`gather_state`), so the
file is the one a single process writes; a resume loads it into a whole
state, which the Trainer then cuts to each rank's part.
"""

from __future__ import annotations

import json
import logging
import math
import os
import time
from concurrent.futures import Future, ThreadPoolExecutor
from pathlib import Path
from typing import Any, Dict, List, Optional

import torch

from lunaris_orion_tpu_torch.config import TrainConfig
from lunaris_orion_tpu_torch.parallel.mesh import Mesh
from lunaris_orion_tpu_torch.parallel.sharding import gather_state
from lunaris_orion_tpu_torch.train.schedule import torch_scheduler_state
from lunaris_orion_tpu_torch.train.state import ClippedAdamW, TrainState
from lunaris_orion_tpu_torch.utils.convert import load_reference_checkpoint

logger = logging.getLogger(__name__)


def _to_cpu(obj: Any) -> Any:
    """A copy of obj with every tensor copied to the host (the live
    tensors go on changing in place)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def _optimizer(opt: ClippedAdamW, base_lr: float, sched: Dict) -> Dict:
    """torch AdamW's state_dict with the param group the reference saves:
    lr at the checkpoint's step and the scheduler's initial_lr. A bf16
    first moment (bf16_momentum) is written as its f32 values, exactly, as
    the JAX package's writer does: the reference layout is f32, and torch's
    load_state_dict casts moments to the parameter's dtype anyway."""
    sd = opt.opt.state_dict()
    sd["state"] = {i: {k: v.float() if k == "exp_avg" else v
                       for k, v in st.items()}
                   for i, st in sd["state"].items()}
    sd["param_groups"] = [dict(g, lr=sched["_last_lr"][0], initial_lr=base_lr)
                          for g in sd["param_groups"]]
    return sd


def checkpoint_dict(state: TrainState, cfg: TrainConfig) -> Dict:
    """The state as a reference-layout checkpoint dict, on the host (a
    whole state: `gather_state` first for a rank's part)."""
    if state.layout is not None:
        raise ValueError("checkpoint_dict needs the whole state "
                         "(parallel.sharding.gather_state)")
    scheds = {name: torch_scheduler_state(lr, cfg.scheduler_t0, cfg.min_lr,
                                          state.step)
              for name, lr in (("vae", cfg.vae_lr),
                               ("teacher", cfg.teacher_lr))}
    return _to_cpu({
        "global_step": int(state.step),
        "vae_state_dict": state.vae.state_dict(),
        "teacher_state_dict": state.teacher.state_dict(),
        "vae_optimizer": _optimizer(state.vae_opt, cfg.vae_lr, scheds["vae"]),
        "teacher_optimizer": _optimizer(state.teacher_opt, cfg.teacher_lr,
                                        scheds["teacher"]),
        "vae_scheduler": scheds["vae"],
        "teacher_scheduler": scheds["teacher"],
        "best_loss": float(state.best_loss),
        "args": cfg.to_dict(),
        "baseline": state.baseline,
        "baseline_initialized": state.baseline_initialized,
        "generator_state": state.generator.get_state(),
    })


def load_checkpoint_file(path: str, state: TrainState, cfg: TrainConfig
                         ) -> TrainState:
    """Load a reference-layout .pt into `state` (models on their device,
    optimizers, step, best_loss; baseline and generator as the module
    docstring says) and return it. The reference attention's rel_pos_cache
    buffers are dropped (`load_reference_checkpoint`). `state` is whole;
    `shard_state` cuts it afterwards."""
    if state.layout is not None:
        raise ValueError("load_checkpoint_file loads into a whole state; "
                         "cut it afterwards (parallel.sharding.shard_state)")
    _, ckpt = load_reference_checkpoint(str(path), cfg)
    state.vae.load_state_dict(ckpt["vae_state_dict"], strict=True)
    state.teacher.load_state_dict(ckpt["teacher_state_dict"], strict=True)
    for opt, key in ((state.vae_opt, "vae_optimizer"),
                     (state.teacher_opt, "teacher_optimizer")):
        if key in ckpt:
            opt.opt.load_state_dict(ckpt[key])
    state.step = int(ckpt.get("global_step", 0))
    state.best_loss = float(ckpt.get("best_loss", math.inf))
    dev = state.baseline.device
    if "generator_state" in ckpt:
        state.baseline = ckpt["baseline"].to(dev, torch.float32, copy=True)
        state.baseline_initialized = ckpt["baseline_initialized"].to(
            dev, torch.bool, copy=True)
        state.generator.set_state(ckpt["generator_state"])
    else:
        state.baseline = torch.zeros((), dtype=torch.float32, device=dev)
        state.baseline_initialized = torch.zeros((), dtype=torch.bool,
                                                 device=dev)
        state.generator.manual_seed(cfg.seed)
    return state


def checkpoint_file(directory: str, *, best: bool = False,
                    step: Optional[int] = None) -> Optional[Path]:
    """The .pt that a CheckpointService directory holds for the best slot,
    `step`, or the latest step; None when there is none (for instance an
    Orbax directory of the JAX package)."""
    root = Path(directory)
    if best:
        path = root / "best.pt"
    elif step is not None:
        path = root / "steps" / f"{step}.pt"
    else:
        steps = [int(p.stem) for p in (root / "steps").glob("*.pt")
                 if p.stem.isdigit()]
        path = root / "steps" / f"{max(steps)}.pt" if steps else None
    return path if path is not None and path.is_file() else None


def _save_file(obj: Dict, path: Path) -> None:
    tmp = path.with_name(path.name + ".tmp")
    torch.save(obj, tmp)
    os.replace(tmp, path)


class CheckpointService:
    def __init__(self, directory: str, *, keep_n: int = 5,
                 log: Optional[logging.Logger] = None,
                 mesh: Optional[Mesh] = None):
        self.log = log or logger
        self.mesh = mesh
        self.writes = mesh is None or mesh.is_main
        self.root = Path(directory).absolute()
        self.steps_dir = self.root / "steps"
        self.steps_dir.mkdir(parents=True, exist_ok=True)
        self.keep_n = max(int(keep_n), 1)
        self._steps = sorted(int(p.stem) for p in self.steps_dir.glob("*.pt")
                             if p.stem.isdigit())
        self._writer = ThreadPoolExecutor(max_workers=1,
                                          thread_name_prefix="checkpoint")
        self._pending: List[Future] = []

    @property
    def best_path(self) -> Path:
        return self.root / "best.pt"

    def step_path(self, step: int) -> Path:
        return self.steps_dir / f"{step}.pt"

    # -- save ---------------------------------------------------------------

    def save(self, step: int, state: TrainState, *,
             config: Optional[TrainConfig] = None, best: bool = False,
             force: bool = False) -> None:
        """Save `state` as step `step` (skipped when that step is already
        saved: a periodic and an epoch-end save can land on one step) and,
        with `best`, as the best slot. `config` is the run's config: the
        checkpoint's `args`, and config.json the first time. `force` is the
        JAX package's Orbax flag (save off the save interval); this service
        keeps no interval, so every call saves."""
        cfg = config or self.load_config() or TrainConfig()
        if config is not None and self.writes:
            cfg_path = self.root / "config.json"
            if not cfg_path.exists():
                cfg_path.write_text(json.dumps(config.to_dict(), indent=2,
                                               default=str))
        new_step = step not in self._steps
        if not (new_step or best):
            return
        drop: List[int] = []
        if new_step:
            self._steps = sorted(self._steps + [step])
            drop, self._steps = (self._steps[:-self.keep_n],
                                 self._steps[-self.keep_n:])
        if self.mesh is not None and state.layout is not None:
            if self.mesh.data.index != 0:
                return
            state = gather_state(state, self.mesh)
        if not self.writes:
            return
        obj = checkpoint_dict(state, cfg)
        self._pending.append(self._writer.submit(
            self._write, obj, step if new_step else None, best, drop))

    def _write(self, obj: Dict, step: Optional[int], best: bool,
               drop: List[int]) -> None:
        t0 = time.perf_counter()
        if step is not None:
            _save_file(obj, self.step_path(step))
        if best:
            _save_file(obj, self.best_path)
        for old in drop:
            self.step_path(old).unlink(missing_ok=True)
        self.log.info("Checkpoint step %d written in %.1f ms%s",
                      obj["global_step"], (time.perf_counter() - t0) * 1e3,
                      " (and best.pt)" if best else "")

    def wait(self) -> None:
        pending, self._pending = self._pending, []
        for f in pending:
            f.result()
        if self.mesh is not None:
            self.mesh.barrier()

    # -- restore ------------------------------------------------------------

    def latest_step(self) -> Optional[int]:
        return self._steps[-1] if self._steps else None

    def restore(self, state: TrainState, *, step: Optional[int] = None,
                best: bool = False, config: Optional[TrainConfig] = None
                ) -> TrainState:
        """Load the latest step (or `step`, or the best slot) into `state`,
        whose models sit on the device to restore onto."""
        self.wait()
        if best:
            path = self.best_path
        else:
            step = step if step is not None else self.latest_step()
            path = None if step is None else self.step_path(step)
        if path is None or not path.exists():
            raise FileNotFoundError(f"no checkpoint under {self.root}")
        self.log.info("Restoring checkpoint %s", path)
        return load_checkpoint_file(
            str(path), state, config or self.load_config() or TrainConfig())

    def load_config(self) -> Optional[TrainConfig]:
        cfg_path = self.root / "config.json"
        if not cfg_path.exists():
            return None
        return TrainConfig.from_dict(json.loads(cfg_path.read_text()))

    def close(self):
        try:
            self.wait()
        finally:
            self._writer.shutdown(wait=True)
