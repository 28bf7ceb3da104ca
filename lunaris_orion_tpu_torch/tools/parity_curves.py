"""Loss-curve parity of the port's VAE step with the JAX package's.

The counterpart of `tools/parity_curves.py`: the port's LunarisCoreVAE
forward, MSE + KL through `train.losses.recon_kl` (K3 on a card), loss =
recon + 0.1 KL, and one ClippedAdamW update a step (clip 1.0, AdamW with
cosine warm restarts from 1e-4, T0 10, eta_min 1e-6), for 300 steps of
batch 16 at 32 px (latent 24, base width 16), from the committed init and
on the JAX tool's synthetic stream (`_parity`). Modes:

  deterministic  z = mu: every input is the JAX run's, so the curves must
                 overlay within the rounding of two implementations
  sampled        z = mu + eps exp(logvar / 2), eps from the port's own
                 generator (seeded 7): the curves agree within the band
                 that sampling leaves

Each mode's curves are held to the JAX curves of the same run, committed
in `parity_ref/`: the largest relative gap over the back half of the steps
against the bands the JAX package's own parity runs measured.

    python -m lunaris_orion_tpu_torch.tools.parity_curves [--device cpu]
        [--steps 300] [--modes deterministic,sampled] [--out F]

The last line of stdout is the JSON {mode: {"port": {"recon", "kl"},
"max_rel_divergence": {...}, "ms_per_step"}, "device": ..., "card": ...};
`--out` writes it to a file too. Exit code 1 when a deterministic
divergence is past its sampled band.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List

import torch

from lunaris_orion_tpu_torch.config import TrainConfig
from lunaris_orion_tpu_torch.device import resolve_device
from lunaris_orion_tpu_torch.ops.rng import device_generator, new_seed
from lunaris_orion_tpu_torch.tools import _parity as P
from lunaris_orion_tpu_torch.tools._timing import card_line
from lunaris_orion_tpu_torch.train import losses
from lunaris_orion_tpu_torch.train.state import ClippedAdamW
from lunaris_orion_tpu_torch.train.step import normalize_images

PRESET = P.PRESETS["vae"]
KL_WEIGHT = 0.1


class VAERun:
    """One mode of the tool, a step at a time: `step(i)` takes optimizer
    step i on batch i of the stream, `curves()` reads the losses."""

    def __init__(self, device: torch.device | str, steps: int, sampled: bool):
        self.device = torch.device(device)
        self.sampled = sampled
        self.vae, _ = P.load_init(PRESET, self.device)
        self.vae.train()
        self.opt = ClippedAdamW(self.vae, 1e-4, TrainConfig())
        self.gen = torch.Generator().manual_seed(P.INIT_SEED)
        self.data = torch.from_numpy(P.make_data(
            steps, PRESET.batch, PRESET.vae.image_size)).to(self.device)
        self.losses: List[torch.Tensor] = []

    def step(self, i: int) -> None:
        x = normalize_images(self.data[i], torch.float32)
        recon, mu, logvar = self.vae(
            x, device_generator(new_seed(self.gen), self.device),
            sample_posterior=self.sampled)
        rl, kl = losses.recon_kl(recon, x, mu, logvar)
        self.opt.zero_grad()
        (rl + KL_WEIGHT * kl).backward()
        self.opt.step(i)
        self.losses.append(torch.stack([rl.detach(), kl.detach()]))

    def curves(self) -> Dict[str, List[float]]:
        rows = torch.stack(self.losses).cpu().tolist()
        return {k: [r[j] for r in rows] for j, k in enumerate(P.VAE_METRICS)}


def run_mode(device: torch.device | str, steps: int, sampled: bool) -> dict:
    """One mode at full length: the port's curves, their divergence from
    the committed JAX curves and ms a step (host clock, first step left
    out)."""
    ref = P.check_reference(P.run_name("vae", sampled), steps)
    run = VAERun(device, steps, sampled)
    ms = P.drive(run, steps)
    curves = run.curves()
    return {"port": curves,
            "max_rel_divergence": P.divergences(curves, ref["curves"]),
            "ms_per_step": ms}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=PRESET.steps)
    ap.add_argument("--modes", default="deterministic,sampled")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    out = {"device": str(device), "card": card_line(device),
           "steps": args.steps, "batch": PRESET.batch}
    band = P.bands("vae")
    for mode in P.parse_modes(args.modes):
        sampled = mode == "sampled"
        out[mode] = run_mode(device, args.steps, sampled)
        print(P.summary_line(P.run_name("vae", sampled),
                             out[mode]["max_rel_divergence"], band, sampled),
              flush=True)
    if args.out:
        P.write_json(args.out, out)
    print(json.dumps(out), flush=True)
    return P.exit_code(out, "vae", band)


if __name__ == "__main__":
    sys.exit(main())
