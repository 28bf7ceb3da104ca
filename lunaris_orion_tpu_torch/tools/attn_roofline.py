"""What each stage of the K2 forward costs on the card.

The counterpart of `tools/bench_attn_roofline.py`: the port's K2 forward
kernels themselves (bf16: the tensor-core body; `--dtype f32`: the CUDA-core
body), cut after ONE more stage of the online-softmax chain each
(`ops/cuda/flash_attention_stages.py`), timed at the teacher's shape (B 8,
H 8, N 16384, d 16, bf16, dropout 0):

  dots    q k^T, the cast of p and p v
  bias    + the per-key bias add
  maxsub  + the running max and the subtraction
  exp     + exp(s - m)
  sum     + the row sum l (the full chain)
  shipped `flash_attention` at dropout 0 (the same kernel instance as sum,
          plus the scaling of q)

All stages keep the m / l carries, o = acc / l and the lse write, so the
difference of two neighbouring rows is the named stage. With `--sdpa` a
last row times `F.scaled_dot_product_attention` on the same inputs (a
yardstick; the port never calls it).

    python -m lunaris_orion_tpu_torch.tools.attn_roofline [--dtype f32] [--sdpa]

Rows go to stderr as they are measured; the last line of stdout is the JSON
list of rows {"stage", "fwd_ms", "delta_ms"}.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch
import torch.nn.functional as F

from lunaris_orion_tpu_torch.device import resolve_device
from lunaris_orion_tpu_torch.ops.cuda import flash_attention as k2
from lunaris_orion_tpu_torch.ops.cuda import flash_attention_stages as stages
from lunaris_orion_tpu_torch.tools._timing import card_line, time_ms


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def sdpa_ms(q, k, v, bias, *, backward: bool = False, dropout_p: float = 0.0,
            reps: int = 5):
    """Median ms of `F.scaled_dot_product_attention(q, k, v, attn_mask=bias)`
    under the fused backends (none of which holds the N x N scores), or of
    its backward (dq, dk, dv from one `autograd.grad`) when `backward`.
    `dropout_p` draws torch's own masks, not the port's hash.
    Returns (ms, note): ms is None, and note says why, when no fused backend
    takes these inputs; any other error (out of memory, a failed launch)
    is raised."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    mask = bias.to(q.dtype)[None, :, None, :].expand(
        q.shape[0], -1, q.shape[2], -1)
    fused = [SDPBackend.EFFICIENT_ATTENTION, SDPBackend.CUDNN_ATTENTION,
             SDPBackend.FLASH_ATTENTION]
    try:
        with sdpa_kernel(fused):
            if not backward:
                with torch.no_grad():
                    return time_ms(lambda: F.scaled_dot_product_attention(
                        q, k, v, attn_mask=mask, dropout_p=dropout_p),
                        q.device, reps, 1), "fused"
            leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
            out = F.scaled_dot_product_attention(*leaves, attn_mask=mask,
                                                 dropout_p=dropout_p)
            do = torch.ones_like(out)
            return time_ms(lambda: torch.autograd.grad(
                out, leaves, do, retain_graph=True), q.device, reps, 1), "fused"
    except RuntimeError as e:
        if "No available kernel" not in str(e):
            raise
        return None, f"no fused backend took the inputs: {str(e)[:200]}"


def measure(batch: int, heads: int, tokens: int, head_dim: int,
            dtype: torch.dtype, device: torch.device, reps: int, seed: int,
            sdpa: bool):
    g = torch.Generator(device=device).manual_seed(seed)
    q, k, v = (torch.randn(batch, heads, tokens, head_dim, generator=g,
                           device=device).to(dtype) for _ in range(3))
    bias = 0.1 * torch.randn(heads, tokens, generator=g, device=device)
    qs = q * torch.tensor(head_dim ** -0.5, dtype=dtype, device=device)
    block_k = stages.KERNEL_BLOCK_K
    rows, prev = [], None
    for stage in stages.STAGES:
        ms = time_ms(lambda: stages.flash_fwd_stage(qs, k, v, bias, stage,
                                                    block_k), device, reps, 1)
        rows.append({"stage": stage, "fwd_ms": round(ms, 3),
                     "delta_ms": None if prev is None else round(ms - prev, 3)})
        prev = ms
        log(f"  {rows[-1]}")
    with torch.no_grad():
        ms = time_ms(lambda: k2.flash_attention(q, k, v, bias), device, reps, 1)
    rows.append({"stage": "shipped", "fwd_ms": round(ms, 3),
                 "delta_ms": round(ms - prev, 3)})
    log(f"  {rows[-1]}")
    if sdpa:
        ms, note = sdpa_ms(q, k, v, bias, reps=reps)
        rows.append({"stage": "sdpa", "note": note, "delta_ms": None,
                     "fwd_ms": None if ms is None else round(ms, 3)})
        log(f"  {rows[-1]}")
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--heads", type=int, default=8)
    ap.add_argument("--tokens", type=int, default=16384)
    ap.add_argument("--head_dim", type=int, default=16)
    ap.add_argument("--dtype", choices=("bf16", "f32"), default="bf16")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sdpa", action="store_true",
                    help="also time F.scaled_dot_product_attention")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    log(f"device: {card_line(device)}; B {args.batch} H {args.heads} N "
        f"{args.tokens} d {args.head_dim} {args.dtype}")
    rows = measure(args.batch, args.heads, args.tokens, args.head_dim, dtype,
                   device, args.reps, args.seed, args.sdpa)
    print(json.dumps(rows), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
