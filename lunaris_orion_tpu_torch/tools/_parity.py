"""What the long parity runs share (counterpart: the shared parts of the JAX
package's `tools/parity_curves.py` and `tools/parity_hybrid.py`).

The parity tools run the port's own train steps for hundreds of optimizer
steps from one committed init, on one synthetic uint8 stream, and hold
each curve against the JAX package's curve for the same run, which is
committed under `parity_ref/` beside this file (the port never imports
JAX). A run is a preset and a mode:

  vae.deterministic, vae.sampled            the VAE step, 300 x 16
  hybrid_d16.deterministic                  the hybrid step, 200 x 8
  hybrid_d16.deterministic_w256             ... with a 256-token window
  hybrid_d16.sampled

Deterministic runs take z = mu on both sides (`deterministic_z`), so every
input is the same and the curves overlay within rounding; sampled runs
draw eps from each side's own generator. A run's divergence is the largest
relative gap over the back half of the steps (`back_half_divergence`),
held against the bands that the JAX package's own parity runs measured
(`bands`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from lunaris_orion_tpu_torch.config import TeacherConfig, TrainConfig, VAEConfig
from lunaris_orion_tpu_torch.models.teacher import LunarMoETeacher
from lunaris_orion_tpu_torch.models.vae import LunarisCoreVAE

REF_DIR = Path(__file__).resolve().parent / "parity_ref"
INIT = REF_DIR / "init.pt"
BANDS = REF_DIR / "bands.json"
INIT_SEED = 7          # torch.manual_seed of the init and of sampled runs

# The hybrid metrics (tools/parity_hybrid.py:63-64).
METRICS = ("recon_loss", "kl_loss", "quality_reward", "semantic_reward",
           "baseline", "pg_loss", "teacher_loss")
# The VAE tool's names for recon and KL, and the band keys of each.
VAE_METRICS = ("recon", "kl")


@dataclass(frozen=True)
class Preset:
    name: str
    steps: int
    batch: int
    vae: VAEConfig
    teacher: Optional[TeacherConfig] = None
    train: Optional[TrainConfig] = None


VAE_CFG = VAEConfig(latent_dim=24, image_size=32, base_channels=16)

PRESETS: Dict[str, Preset] = {
    # tools/parity_curves.py's config.
    "vae": Preset("vae", 300, 16, VAE_CFG),
    # tools/parity_hybrid.py:43-53 with feature_dim 64 (was 24): head size
    # 16 at 4 heads, one of K2's compiled head sizes; no other width moves.
    "hybrid_d16": Preset(
        "hybrid_d16", 200, 8, VAE_CFG,
        TeacherConfig(num_experts=2, feature_dim=64, extractor_dim=16,
                      extractor_stem=8, branch_dim=8, expert_layers=2,
                      intermediate_dim=16, embedding_dim=8, num_heads=4,
                      rel_pos_size=4, image_size=32, dropout_rate=0.0),
        TrainConfig(mixed_precision=False, gradient_accumulation_steps=1,
                    vae_lr=1e-4, teacher_lr=1e-4, scheduler_t0=10)),
}

# run name -> (preset, sampled, attention window)
RUNS: Dict[str, tuple] = {
    "vae.deterministic": ("vae", False, 0),
    "vae.sampled": ("vae", True, 0),
    "hybrid_d16.deterministic": ("hybrid_d16", False, 0),
    "hybrid_d16.deterministic_w256": ("hybrid_d16", False, 256),
    "hybrid_d16.sampled": ("hybrid_d16", True, 0),
}


def run_name(preset: str, sampled: bool, window: int = 0) -> str:
    mode = "sampled" if sampled else "deterministic"
    return f"{preset}.{mode}" + (f"_w{window}" if window else "")


def teacher_config(preset: Preset, window: int = 0) -> TeacherConfig:
    return dataclasses.replace(preset.teacher, attn_window=window or None)


def make_data(steps: int, batch: int, size: int, seed: int = 0) -> np.ndarray:
    """Deterministic uint8 sprite stream [steps, batch, size, size, 3]:
    blocky 4x4 cells, byte for byte the JAX tools' (parity_curves.py:37-44)."""
    rng = np.random.default_rng(seed)
    cells = rng.integers(0, 256, (steps * batch, size // 4, size // 4, 3),
                         dtype=np.uint8)
    up = np.repeat(np.repeat(cells, 4, axis=1), 4, axis=2)
    return up.reshape(steps, batch, size, size, 3)


def floor_for(metric: str) -> float:
    """The denominator's floor: 0 for the VAE's recon (as the JAX tool
    divides by it bare), 1e-3 for every other metric."""
    return 0.0 if metric == "recon" else 1e-3


def back_half_divergence(port: Sequence[float], ref: Sequence[float],
                         floor: float) -> float:
    """max over the back half of |port - ref| / max(|ref|, floor): the JAX
    tools' formula (parity_curves.py:206-210, parity_hybrid.py:283-288),
    divided by the reference (the JAX curve) where they divide by their
    PyTorch side."""
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    if port.shape != ref.shape:
        raise ValueError(f"curves of {port.shape} and {ref.shape} steps")
    h = len(ref) // 2
    gap = np.abs(port[h:] - ref[h:])
    return float(np.max(gap / np.maximum(np.abs(ref[h:]), floor)))


def divergences(port: Dict[str, List[float]], ref: Dict[str, List[float]]
                ) -> Dict[str, float]:
    """back_half_divergence of every metric of `ref` (cut to the steps
    `port` ran)."""
    out = {}
    for k, r in ref.items():
        p = port[k]
        out[k] = back_half_divergence(p, r[:len(p)], floor_for(k))
    return out


@contextlib.contextmanager
def deterministic_z() -> Iterator[None]:
    """LunarisCoreVAE.reparameterize returns mu (z = mu) inside the block,
    and is restored on exit: the deterministic mode of the tools, as
    tools/parity_hybrid.py:194-195 patches the JAX package's."""
    orig = LunarisCoreVAE.__dict__["reparameterize"]
    LunarisCoreVAE.reparameterize = staticmethod(
        lambda mu, logvar, *a, **k: mu)
    try:
        yield
    finally:
        LunarisCoreVAE.reparameterize = orig


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def reference(run: str) -> dict:
    """The committed JAX curves of `run` ({"curves": {metric: [...]}, ...})."""
    path = REF_DIR / f"{run}.json"
    if not path.exists():
        raise FileNotFoundError(f"{path}: no JAX reference for {run!r}")
    return load_json(path)


def bands(preset: str) -> Dict[str, Dict[str, float]]:
    """{"deterministic": {metric: band}, "sampled": {...}} of a preset:
    the back-half divergences that the JAX package's parity runs measured
    against an independent PyTorch loop (docs/parity_curves.json for
    `vae`, docs/parity_hybrid.json for the hybrid), copied into
    parity_ref/bands.json."""
    return load_json(BANDS)["bands"]["vae" if preset == "vae" else "hybrid"]


def load_init(preset: Preset, device: torch.device | str = "cpu"):
    """The committed init (parity_ref/init.pt, a reference-layout
    checkpoint: torch.manual_seed(7), then the reference VAE, then the
    hybrid_d16 teacher) as the port's models on `device`. Returns (vae,
    teacher); the teacher is None for the `vae` preset."""
    from lunaris_orion_tpu_torch.utils.convert import load_reference_checkpoint
    _, ckpt = load_reference_checkpoint(str(INIT), TrainConfig())
    vae = LunarisCoreVAE(preset.vae)
    vae.load_state_dict(ckpt["vae_state_dict"], strict=True)
    teacher = None
    if preset.teacher is not None:
        teacher = LunarMoETeacher(preset.teacher)
        teacher.load_state_dict(ckpt["teacher_state_dict"], strict=True)
        teacher = teacher.to(device)
    return vae.to(device), teacher


def check_reference(run: str, steps: int) -> dict:
    """The reference of `run`, checked to hold `steps` steps and to come
    from the same JAX sources as bands.json (every file of parity_ref/
    carries the sha256 of the sources it was made from)."""
    ref = reference(run)
    if ref["jax_source_sha256"] != load_json(BANDS)["jax_source_sha256"]:
        raise ValueError(f"{run}: reference made from other JAX sources "
                         "than parity_ref/bands.json")
    n = min(len(v) for v in ref["curves"].values())
    if steps > n:
        raise ValueError(f"{run}: the reference holds {n} steps, not {steps}")
    return ref


def write_json(path: str | Path, obj: dict) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(obj, indent=1) + "\n")


def drive(run, steps: int) -> Optional[float]:
    """Take steps 0 .. steps - 1 of a tool's run (`run.step(i)`, its device
    `run.device`); returns ms a step by the host clock over the steps after
    the first, with the card's queue drained at both ends (None for one
    step)."""
    t0 = None
    for i in range(steps):
        if i == 1:
            _sync(run.device)
            t0 = time.perf_counter()
        run.step(i)
    _sync(run.device)
    return None if t0 is None else (time.perf_counter() - t0) * 1e3 / (
        steps - 1)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def parse_modes(modes: str) -> List[str]:
    out = [m.strip() for m in modes.split(",") if m.strip()]
    bad = [m for m in out if m not in ("deterministic", "sampled")]
    if bad or not out:
        raise ValueError(f"modes are deterministic and sampled, not {bad}")
    return out


def verdict(value: float, band: Dict[str, Dict[str, float]], metric: str,
            sampled: bool) -> str:
    """Where a divergence falls. A deterministic run: "met" within the
    deterministic band, "between" within the sampled band (a card sums
    in other orders than the runs the bands came from, so this is a
    finding to write down, not a failure), else "past" (a failure). A sampled run: "met" or "missed" its sampled band
    (it fails only on a value that is not finite)."""
    if not np.isfinite(value):
        return "past"
    if sampled:
        return "met" if value <= band["sampled"][metric] else "missed"
    if value <= band["deterministic"][metric]:
        return "met"
    return "between" if value <= band["sampled"][metric] else "past"


def failures(run: str, div: Dict[str, float], curves: Dict[str, list],
             band: Dict[str, Dict[str, float]], sampled: bool) -> List[str]:
    """What fails a run: a curve value that is not finite, and in a
    deterministic run a divergence past the sampled band."""
    out = [f"{run}: {k} is not finite" for k, v in curves.items()
           if not np.all(np.isfinite(v))]
    out += [f"{run}: {k} {v:.3e} past the sampled band "
            f"{band['sampled'][k]:.3e}" for k, v in div.items()
            if verdict(v, band, k, sampled) == "past"]
    return out


def summary_line(run: str, div: Dict[str, float],
                 band: Dict[str, Dict[str, float]], sampled: bool) -> str:
    """One line: each metric's divergence beside its deterministic and
    sampled bands, and its verdict."""
    parts = [f"{k}={v:.3e} (det {band['deterministic'][k]:.3e}, sampled "
             f"{band['sampled'][k]:.3e}: {verdict(v, band, k, sampled)})"
             for k, v in div.items()]
    return f"[parity] {run}: " + " ".join(parts)


def exit_code(out: dict, preset: str, band: Dict[str, Dict[str, float]]
              ) -> int:
    """1 when a mode of a tool's output fails (`failures`), else 0."""
    bad = []
    for mode, r in out.items():
        if isinstance(r, dict) and "max_rel_divergence" in r:
            bad += failures(f"{preset}.{mode}", r["max_rel_divergence"],
                            r["port"], band, mode.startswith("sampled"))
    for line in bad:
        print(f"[parity] FAIL {line}", file=sys.stderr, flush=True)
    return 1 if bad else 0
