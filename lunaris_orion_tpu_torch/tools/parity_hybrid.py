"""Loss-curve parity of the port's hybrid train step with the JAX package's.

The counterpart of `tools/parity_hybrid.py`: the port's product step,
`train.step.make_train_step(cfg, remat=False, attn_impl=...)` on a
`create_state` whose models hold the committed init, for 200 steps of
batch 8 (one micro-batch, f32, dropout 0) at the `hybrid_d16` preset
(32 px; the JAX tool's widths with feature_dim 64, so that the teacher's
attention runs at head size 16, which K2 compiles). On a card the step
launches K1, K3 and K2 (f32: `flash_fwd_tf32` and `flash_bwd_fused_tf32`;
with `--attn_window 256` the f32 window bodies `flash_fwd_window_tf32` and
`flash_bwd_window_tf32` over the four folded windows of 256 tokens).
Modes as in `parity_curves`: deterministic (z = mu, `deterministic_z`)
and sampled (the port's generator, seeded 7). The seven metrics of the
JAX tool are held to the committed JAX curves of the same run.

    python -m lunaris_orion_tpu_torch.tools.parity_hybrid [--device cpu]
        [--steps 200] [--attn_impl flash|full] [--attn_window 0|256]
        [--modes deterministic,sampled] [--out F]

`--attn_impl` defaults to flash (K2) on a card and full on the CPU; at
dropout 0 both compute the same function. The last line of stdout is the
JSON {mode: {"port": {metric: [...]}, "max_rel_divergence": {...},
"ms_per_step"}, ...} (a windowed mode is named `deterministic_w256`);
`--out` writes it to a file too. Exit code 1 when a deterministic
divergence is past its sampled band.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
from typing import Dict, List

import torch

from lunaris_orion_tpu_torch.device import resolve_device
from lunaris_orion_tpu_torch.tools import _parity as P
from lunaris_orion_tpu_torch.tools._timing import card_line
from lunaris_orion_tpu_torch.train.state import create_state
from lunaris_orion_tpu_torch.train.step import make_train_step

PRESET = P.PRESETS["hybrid_d16"]


def default_impl(device: torch.device) -> str:
    return "flash" if device.type == "cuda" else "full"


class HybridRun:
    """One mode of the tool, a step at a time (as `parity_curves.VAERun`)."""

    def __init__(self, device: torch.device | str, steps: int, sampled: bool,
                 window: int = 0, attn_impl: str | None = None):
        self.device = torch.device(device)
        self.sampled = sampled
        tcfg = P.teacher_config(PRESET, window)
        self.state = create_state(PRESET.train, self.device, P.INIT_SEED,
                                  vcfg=PRESET.vae, tcfg=tcfg)
        vae, teacher = P.load_init(PRESET)
        self.state.vae.load_state_dict(vae.state_dict(), strict=True)
        self.state.teacher.load_state_dict(teacher.state_dict(), strict=True)
        self.state.generator = torch.Generator().manual_seed(P.INIT_SEED)
        self.train_step = make_train_step(
            PRESET.train, remat=False,
            attn_impl=attn_impl or default_impl(self.device))
        self.data = torch.from_numpy(P.make_data(
            steps, PRESET.batch, PRESET.vae.image_size)).to(self.device)
        self.metrics: List[torch.Tensor] = []

    def step(self, i: int) -> None:
        z = contextlib.nullcontext() if self.sampled else P.deterministic_z()
        with z:
            _, m = self.train_step(self.state, self.data[i][None])
        self.metrics.append(torch.stack([m[k].float() for k in P.METRICS]))

    def curves(self) -> Dict[str, List[float]]:
        rows = torch.stack(self.metrics).cpu().tolist()
        return {k: [r[j] for r in rows] for j, k in enumerate(P.METRICS)}


def run_mode(device: torch.device | str, steps: int, sampled: bool,
             window: int = 0, attn_impl: str | None = None) -> dict:
    """One mode at full length, as `parity_curves.run_mode`."""
    ref = P.check_reference(P.run_name(PRESET.name, sampled, window), steps)
    run = HybridRun(device, steps, sampled, window, attn_impl)
    ms = P.drive(run, steps)
    curves = run.curves()
    return {"port": curves,
            "max_rel_divergence": P.divergences(curves, ref["curves"]),
            "ms_per_step": ms}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=PRESET.steps)
    ap.add_argument("--attn_impl", choices=("flash", "full"), default=None)
    ap.add_argument("--attn_window", type=int, choices=(0, 256), default=0)
    ap.add_argument("--modes", default="deterministic,sampled")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    impl = args.attn_impl or default_impl(device)
    out = {"device": str(device), "card": card_line(device),
           "steps": args.steps, "batch": PRESET.batch, "attn_impl": impl,
           "attn_window": args.attn_window}
    band = P.bands(PRESET.name)
    for mode in P.parse_modes(args.modes):
        sampled = mode == "sampled"
        run = P.run_name(PRESET.name, sampled, args.attn_window)
        key = run.split(".", 1)[1]
        out[key] = run_mode(device, args.steps, sampled, args.attn_window,
                            impl)
        print(P.summary_line(run, out[key]["max_rel_divergence"], band,
                             sampled), flush=True)
    if args.out:
        P.write_json(args.out, out)
    print(json.dumps(out), flush=True)
    return P.exit_code(out, PRESET.name, band)


if __name__ == "__main__":
    sys.exit(main())
