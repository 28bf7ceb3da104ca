"""K5 against its parts: is one fused GN-apply + Mish + conv3x3 kernel
faster than K1 followed by a library convolution?

The counterpart of `tools/bench_fusion_overlap.py`. At one stage shape
(default: the widest, [128, 128, 128, 64] conv3x3 64 -> 64, bf16):

  conv_alone    conv3x3(y)                 F.conv2d (cuDNN), channels_last
  gnmish_alone  mish(GroupNorm(y))         the port's K1
  chain         conv3x3(mish(GroupNorm(y)))  K1, then F.conv2d
  stats_alone   per-channel mean of y and y^2 (the reduction half of GN)
  fused         the GroupNorm fold (torch), then K5 (`gn_mish_conv3`)

The two convolution cases use the library as the JAX tool left them to its
compiler; K1 and K5 are the port's own kernels.

    python -m lunaris_orion_tpu_torch.tools.fusion_overlap [--batch 128]

One JSON line per case {"case", "ms"}, then the summary line with
sum_parts_ms, chain_ms, overlap_already_ms and
pipelined_kernel_ceiling_saving_ms (chain minus its larger part: the most a
kernel that overlaps the two parts perfectly could save).
"""

from __future__ import annotations

import argparse
import json
import sys

import torch
import torch.nn.functional as F

from lunaris_orion_tpu_torch.device import resolve_device
from lunaris_orion_tpu_torch.ops.cuda import fused_stage as k5
from lunaris_orion_tpu_torch.ops.cuda import gn_mish as k1
from lunaris_orion_tpu_torch.tools._timing import card_line, time_ms


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def measure(batch: int, hw: int, cin: int, cout: int, dtype: torch.dtype,
            device: torch.device, reps: int, seed: int):
    g = torch.Generator(device=device).manual_seed(seed)
    y = torch.randn(batch, hw, hw, cin, generator=g, device=device).to(dtype)
    w = (0.05 * torch.randn(3, 3, cin, cout, generator=g,
                            device=device)).to(dtype)
    scale = torch.full((cin,), 1.1, device=device)
    bias = torch.full((cin,), 0.05, device=device)
    wb = torch.zeros(cout, device=device)
    w_oihw = w.permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)

    def conv(x):                      # NHWC in, NCHW channels_last view out
        return F.conv2d(x.permute(0, 3, 1, 2), w_oihw, padding=1)

    def stats(x):
        x32 = x.float()
        return torch.stack([x32.mean(dim=(1, 2)),
                            x32.square().mean(dim=(1, 2))])

    def fused(x):
        alpha, beta = k1.group_affine(x, scale, bias)
        return k5.gn_mish_conv3(x, alpha, beta, w, wb)

    cases = {
        "conv_alone": lambda: conv(y),
        "gnmish_alone": lambda: k1.gn_mish(y, scale, bias),
        "chain": lambda: conv(k1.gn_mish(y, scale, bias)),
        "stats_alone": lambda: stats(y),
        "fused": lambda: fused(y),
    }
    tflop = 2 * batch * hw * hw * cin * cout * 9 / 1e12
    res = {}
    with torch.no_grad():
        for name, fn in cases.items():
            ms = time_ms(fn, device, reps)
            res[name] = ms
            extra = ""
            if name in ("conv_alone", "chain", "fused"):
                extra = f" ({tflop / ms * 1e3:.1f} TFLOP/s on the conv MACs)"
            log(f"  {name}: {ms:.3f} ms{extra}")
            print(json.dumps({"case": name, "ms": round(ms, 4)}), flush=True)
    serial = res["conv_alone"] + res["gnmish_alone"]
    ceiling = res["chain"] - max(res["conv_alone"], res["gnmish_alone"])
    return res, {
        "sum_parts_ms": round(serial, 4),
        "chain_ms": round(res["chain"], 4),
        "overlap_already_ms": round(serial - res["chain"], 4),
        "pipelined_kernel_ceiling_saving_ms": round(ceiling, 4),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--hw", type=int, default=128)
    ap.add_argument("--cin", type=int, default=64)
    ap.add_argument("--cout", type=int, default=64)
    ap.add_argument("--dtype", choices=("bf16", "f32"), default="bf16")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    log(f"device: {card_line(device)}; [{args.batch}, {args.hw}, {args.hw}, "
        f"{args.cin}] -> {args.cout} {args.dtype}")
    _, summary = measure(args.batch, args.hw, args.cin, args.cout, dtype,
                         device, args.reps, args.seed)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
