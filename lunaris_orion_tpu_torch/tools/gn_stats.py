"""Formulations of K1's moment reduction (sum x, sum x^2 per image and
channel) against the card's memory rate.

The counterpart of `tools/bench_gn_stats2.py`. Per shape, in bf16:

  torch         x.float() summed over H and W in one reduction
  torch_staged  reduce W, then H
  k1_pass1      the port's K1 pass 1 alone (`gn_mish.group_stats`: one
                partial per batch, group and split)
  par_tnK       `gn_stats.lane_sums_partials`: one partial per tile of K
                rows of 128, every tile independent, then a fold

each with its milliseconds and the GB/s of the one read of x.

    python -m lunaris_orion_tpu_torch.tools.gn_stats [--shapes 128,128,128,32 ...]

The table goes to stdout; its last line is the JSON list of rows
{"shape", "variant", "ms", "gb_s"}.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from lunaris_orion_tpu_torch.device import resolve_device
from lunaris_orion_tpu_torch.ops.cuda import gn_mish as k1
from lunaris_orion_tpu_torch.ops.cuda import gn_stats
from lunaris_orion_tpu_torch.tools._timing import card_line, time_ms

SHAPES = ((128, 128, 128, 32), (128, 128, 128, 64), (128, 64, 64, 128))
TILE_ROWS = (512, 2048)


def _torch(x):
    x32 = x.float()
    return x32.sum(dim=(1, 2)), x32.square().sum(dim=(1, 2))


def _torch_staged(x):
    x32 = x.float()
    return x32.sum(dim=2).sum(dim=1), x32.square().sum(dim=2).sum(dim=1)


def measure(shape, dtype: torch.dtype, device: torch.device, reps: int,
            seed: int):
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(shape, generator=g, device=device).to(dtype)
    read_gb = x.numel() * x.element_size() / 1e9
    variants = [("torch", lambda: _torch(x)),
                ("torch_staged", lambda: _torch_staged(x)),
                ("k1_pass1", lambda: k1.group_stats(x, groups=8))]
    rows_of_128 = x[0].numel() // gn_stats.LANES
    for tn in TILE_ROWS:
        if rows_of_128 % min(rows_of_128, tn) == 0:
            variants.append((f"par_tn{tn}", lambda tn=tn:
                             gn_stats.lane_sums_partials(x, tn)))
    rows = []
    for tag, fn in variants:
        ms = time_ms(fn, device, reps)
        rows.append({"shape": list(shape), "variant": tag,
                     "ms": round(ms, 4), "gb_s": round(read_gb / ms * 1e3, 1)})
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shapes", nargs="+", default=None,
                    help="B,H,W,C ... (default: the three widest VAE stages "
                         "at batch 128)")
    ap.add_argument("--dtype", choices=("bf16", "f32"), default="bf16")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    shapes = SHAPES if args.shapes is None else tuple(
        tuple(int(n) for n in s.split(",")) for s in args.shapes)
    print(f"device: {card_line(device)}", flush=True)
    rows = []
    for shape in shapes:
        print(f"shape {shape} {args.dtype}:", flush=True)
        for row in measure(shape, dtype, device, args.reps, args.seed):
            print(f"  {row['variant']:>14} {row['ms']:8.3f} ms  "
                  f"{row['gb_s']:6.0f} GB/s", flush=True)
            rows.append(row)
    print(json.dumps(rows), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
