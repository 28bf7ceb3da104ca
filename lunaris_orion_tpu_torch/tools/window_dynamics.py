"""Training dynamics of the port's step under `--attn_window` against
global attention.

The counterpart of `tools/window_dynamics.py`: the port's product step
(`train.step.make_train_step(cfg, remat=False)`) at the full default width
(128 px, latent 256, feature 128 at 8 heads, 4 experts x 3 blocks), bf16,
batch 8, from one `create_state(seed=0)` per mode, on 16 batches of
`data.synthetic.make_sprites(batch * 16, 128, seed=7)` taken in turn. The
modes are global attention and a window of 256 tokens; each records the
trajectories of total, recon, KL and quality loss, quality reward and
pg_loss, and its ms a step. On a card the step runs the bf16 K2 forward
and fused backward (globally, or over the folded windows), K1 at the
VAE's 16 sites and K3.

    python -m lunaris_orion_tpu_torch.tools.window_dynamics [--device cpu]
        [--steps 150] [--windows 0,256] [--image_size 128] [--batch 8]
        [--out F]

ms a step is the host clock over the steps after the first (the card's
queue drained at both ends). The last line of stdout is the JSON {mode:
{"window", "steps", "batch", "wall_s", "ms_per_step", "trajectories"}};
`--out` writes it to a file too (the tool never writes to docs/). A
smaller `--image_size` (with `--batch`) lets it run on the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from lunaris_orion_tpu_torch.config import TrainConfig
from lunaris_orion_tpu_torch.data.synthetic import make_sprites
from lunaris_orion_tpu_torch.device import resolve_device
from lunaris_orion_tpu_torch.tools import _parity as P
from lunaris_orion_tpu_torch.tools._timing import card_line
from lunaris_orion_tpu_torch.train.state import create_state
from lunaris_orion_tpu_torch.train.step import make_train_step

KEYS = ("total_loss", "recon_loss", "kl_loss", "quality_loss",
        "quality_reward", "pg_loss")
BATCHES = 16                     # distinct batches, taken in turn


class WindowRun:
    """One mode, a step at a time (as `parity_curves.VAERun`)."""

    def __init__(self, device: torch.device | str, window: int, batch: int,
                 image_size: int = 128):
        self.device = torch.device(device)
        self.batch = batch
        cfg = TrainConfig(batch_size=batch, gradient_accumulation_steps=1,
                          mixed_precision=True, attn_window=window,
                          image_size=image_size)
        self.state = create_state(cfg, self.device, 0)
        self.train_step = make_train_step(cfg, remat=False)
        self.data = torch.from_numpy(make_sprites(
            batch * BATCHES, image_size, seed=7)).to(self.device)
        self.metrics = []

    def step(self, i: int) -> None:
        j = (i % BATCHES) * self.batch
        _, m = self.train_step(self.state, self.data[j:j + self.batch][None])
        self.metrics.append(torch.stack([m[k].float() for k in KEYS]))

    def trajectories(self):
        rows = torch.stack(self.metrics).cpu().tolist()
        return {k: [r[j] for r in rows] for j, k in enumerate(KEYS)}


def run_mode(device: torch.device | str, window: int, steps: int, batch: int,
             image_size: int = 128) -> dict:
    run = WindowRun(device, window, batch, image_size)
    t0 = time.perf_counter()
    ms = P.drive(run, steps)
    return {"window": window or "global", "steps": steps, "batch": batch,
            "wall_s": time.perf_counter() - t0, "ms_per_step": ms,
            "trajectories": run.trajectories()}


def tail_means(result: dict) -> dict:
    """Each trajectory's mean over its last fifth (the JAX tool's summary)."""
    tail = max(1, result["steps"] // 5)
    return {k: float(np.mean(v[-tail:]))
            for k, v in result["trajectories"].items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--windows", default="0,256",
                    help="comma list; 0 = global")
    ap.add_argument("--image_size", type=int, default=128)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    out = {"device": str(device), "card": card_line(device)}
    for w in (int(x) for x in args.windows.split(",")):
        name = str(w or "global")
        out[name] = r = run_mode(device, w, args.steps, args.batch,
                                 args.image_size)
        means = " ".join(f"{k} {v:.5f}" for k, v in tail_means(r).items())
        print(f"[window] {name}: {r['ms_per_step']:.1f} ms/step; tail means "
              f"{means}", flush=True)
        if not all(np.all(np.isfinite(v))
                   for v in r["trajectories"].values()):
            print(f"[window] {name}: a loss is not finite", file=sys.stderr)
            return 1
    if args.out:
        P.write_json(args.out, out)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
