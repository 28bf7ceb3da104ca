"""K1's moment reduction from per-tile partials: every tile independent.

`lane_sums_partials` sends a tensor on the CPU to `lane_sums_plain` and a
tensor on a CUDA device to the hand-written kernel in `csrc/gn_stats.cu`;
it raises on any other device and never falls back. The kernel replaces
`tools/bench_gn_stats2.py` `_par_kernel` and computes what `pal_par`
computes.

x [B, H, W, C] is viewed as [B, M, 128] with M = H*W*C/128. A lane period
is P*128 consecutive elements, P = max(C/128, 1); lane j of a period holds
channel j mod C. The result is (s1, s2), each [B, P*128] f32: per image and
lane the sums of x and of x^2.

On CUDA each (image, tile of `tile_rows` rows of 128) block writes its own
partial sums, and a second small kernel adds the tiles in index order, so
two runs give the same bits.

`launches` counts the kernel launches; the plain version does not count.
"""

from __future__ import annotations

import torch

from lunaris_orion_tpu_torch.ops.cuda import _build

launches = 0

LANES = 128
_THREADS = 256


def _tiling(h: int, w: int, c: int, tile_rows: int):
    """(period rows p, tile rows tn, tiles nt) of an image [h, w, c], as
    `pal_par` cuts it; ValueError where it could not."""
    if (c % LANES != 0 and LANES % c != 0) or (h * w * c) % LANES != 0:
        raise ValueError(f"lane_sums: C={c} must divide or be a multiple of "
                         f"{LANES}, and H*W*C a multiple of {LANES}")
    m = (h * w * c) // LANES
    p = max(c // LANES, 1)
    tn = min(m, tile_rows)
    if tn <= 0 or m % tn != 0 or tn % p != 0:
        raise ValueError(f"lane_sums: tile_rows={tile_rows} must divide the "
                         f"{m} rows of an image and hold whole periods of {p}")
    return p, tn, m // tn


def supported_shape(h: int, w: int, c: int, tile_rows: int,
                    dtype: torch.dtype = torch.bfloat16) -> bool:
    """Can the kernel take x [*, h, w, c] in tiles of `tile_rows` rows? The
    shapes `_tiling` accepts, with a period that is a power of two of at
    most 256 16-byte vectors (C <= 1024 in f32, 2048 in bf16)."""
    try:
        p, _, _ = _tiling(h, w, c, tile_rows)
    except ValueError:
        return False
    lanes = p * LANES
    vec = 8 if dtype == torch.bfloat16 else 4
    return lanes & (lanes - 1) == 0 and lanes // vec <= _THREADS


def lane_sums_plain(x: torch.Tensor, tile_rows: int = 512):
    """The plain version: per-lane sums of x and x^2 over each image, f32.
    `tile_rows` only checks the tiling; the sums do not depend on it."""
    p, _, _ = _tiling(*x.shape[1:], tile_rows)
    x32 = x.float().reshape(x.shape[0], -1, p * LANES)
    return x32.sum(dim=1), x32.square().sum(dim=1)


def _kernel(x: torch.Tensor, tile_rows: int):
    b, h, w, c = x.shape
    p, tn, nt = _tiling(h, w, c, tile_rows)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"lane_sums: dtype {x.dtype} is not f32 or bf16")
    if not x.is_contiguous() or x.data_ptr() % 16 != 0:
        raise ValueError("lane_sums: x must be contiguous and 16-byte aligned")
    if not supported_shape(h, w, c, tile_rows, x.dtype) or b > 65535:
        raise ValueError(f"lane_sums: {tuple(x.shape)} {x.dtype} is outside "
                         "the kernel's shapes (see supported_shape)")
    lanes = p * LANES
    partial = torch.empty(b, nt, 2, lanes, device=x.device,
                          dtype=torch.float32)
    sums = torch.empty(b, 2, lanes, device=x.device, dtype=torch.float32)
    err = _build.library().lunaris_lane_sums_partials(
        x.data_ptr(), partial.data_ptr(), sums.data_ptr(), b, lanes, tn // p,
        nt, int(x.dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "lane_sums_partials")
    global launches
    launches += 1
    return sums[:, 0], sums[:, 1]


def lane_sums_partials(x: torch.Tensor, tile_rows: int = 512):
    """Per-lane sums of x and x^2 over each image of x [B, H, W, C]
    (contiguous, f32 or bf16), from per-tile partials of `tile_rows` rows of
    128. Returns (s1, s2), each [B, P*128] f32. On CUDA the shape must
    satisfy `supported_shape`, else ValueError."""
    if x.dim() != 4:
        raise ValueError("lane_sums: x must be [B, H, W, C]")
    if x.device.type == "cpu":
        return lane_sums_plain(x, tile_rows)
    if x.device.type != "cuda":
        raise ValueError(f"lane_sums: unsupported device {x.device}")
    return _kernel(x, tile_rows)
