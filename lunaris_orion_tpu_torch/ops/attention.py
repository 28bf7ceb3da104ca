"""Spatial multi-head attention over feature maps
(counterpart: lunaris_orion_tpu/ops/attention.py).

The JAX package's corrected form of the reference attention: full softmax
attention over all H*W tokens, with the factorized rel-pos term added per
key. The `auto` rule is the JAX package's: N <= 1024 tokens runs
`full_attention`; above that, the K2 forward (`ops/cuda/flash_attention.py`):
the kernel on a CUDA device, its plain blockwise version on the CPU.
Windowed, ring and allgather attention are not ported yet and raise.

Public functions keep the JAX package's layouts: feature maps NHWC
[B, H, W, C]; q, k, v [B, heads, N, d]; bias [heads, N].
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from lunaris_orion_tpu_torch.ops import layers
from lunaris_orion_tpu_torch.ops.cuda import flash_attention as k2


def interp_align_corners(p: torch.Tensor, out_len: int) -> torch.Tensor:
    """1-D linear interpolation with align_corners=True along the last axis
    (torch F.interpolate bilinear on an [S, 1] map). p: [heads, S]."""
    s = p.shape[-1]
    if out_len == s:
        return p
    if out_len == 1 or s == 1:
        return p[..., :1].expand(*p.shape[:-1], out_len)
    scale = (s - 1) / (out_len - 1)
    t = torch.arange(out_len, dtype=torch.float32, device=p.device) * scale
    lo = torch.floor(t).long().clamp(0, s - 2)
    frac = t - lo.float()
    return p[..., lo] * (1.0 - frac) + p[..., lo + 1] * frac


def rel_pos_bias(rel_pos_h: torch.Tensor, rel_pos_w: torch.Tensor,
                 h: int, w: int) -> torch.Tensor:
    """[heads, N] f32 additive key bias from the factorized [heads, S]
    parameters."""
    rh = interp_align_corners(rel_pos_h.float(), h)             # [heads, H]
    rw = interp_align_corners(rel_pos_w.float(), w)             # [heads, W]
    return (rh[:, :, None] + rw[:, None, :]).reshape(rh.shape[0], h * w)


def multihead_qkv(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                  num_heads: int):
    """x [B, H, W, C] -> q, k, v each [B, heads, N, d] (views) through the
    1x1 qkv conv (weight [3C, C, 1, 1]), which on NHWC is a linear."""
    b, h, w, c = x.shape
    qkv = layers.linear(x, weight.reshape(weight.shape[0], c), bias)
    qkv = qkv.reshape(b, h * w, 3, num_heads, c // num_heads)
    qkv = qkv.permute(2, 0, 3, 1, 4)                            # [3,B,h,N,d]
    return qkv[0], qkv[1], qkv[2]


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   bias: Optional[torch.Tensor]) -> torch.Tensor:
    """O(N^2)-memory attention in f32 for small N; bias [heads, N] or None."""
    d = q.shape[-1]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (d ** -0.5)
    if bias is not None:
        s = s + bias.float()[None, :, None, :]
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p, v.float()).to(q.dtype)


class SpatialAttention(nn.Module):
    """qkv 1x1 conv -> attention (+ per-key rel-pos bias) -> proj 1x1 conv,
    under the reference's parameter names (lunar_evaluator.py
    PixelArtAttention): qkv, proj, rel_pos_h [1, heads, S, 1],
    rel_pos_w [1, heads, 1, S], and the reference's rel-pos cache-validity
    buffer last_spatial_shapes, kept so that reference state_dicts load
    strictly (this module keeps no cache)."""

    def __init__(self, channels: int, num_heads: int = 8,
                 rel_pos_size: int = 8):
        super().__init__()
        self.num_heads = num_heads
        self.rel_pos_h = nn.Parameter(torch.zeros(1, num_heads, rel_pos_size, 1))
        self.rel_pos_w = nn.Parameter(torch.zeros(1, num_heads, 1, rel_pos_size))
        self.register_buffer("last_spatial_shapes", torch.zeros(2))
        self.qkv = nn.Conv2d(channels, channels * 3, 1)
        self.proj = nn.Conv2d(channels, channels, 1)

    def forward(self, x: torch.Tensor, *, impl: str = "auto",
                window: Optional[int] = None) -> torch.Tensor:
        """x [B, H, W, C] -> [B, H, W, C] (eval mode).

        impl: 'auto' (N <= 1024 -> 'full', else 'flash'), 'full', or
        'flash' (the K2 forward)."""
        b, h, w, c = x.shape
        n = h * w
        if window is not None and window < n:
            raise NotImplementedError(
                "windowed attention (attn_window) is not ported yet")
        if impl == "auto":
            impl = "full" if n <= 1024 else "flash"
        q, k, v = multihead_qkv(x, self.qkv.weight, self.qkv.bias,
                                self.num_heads)
        bias = rel_pos_bias(self.rel_pos_h[0, :, :, 0],
                            self.rel_pos_w[0, :, 0, :], h, w)
        if impl == "full":
            out = full_attention(q, k, v, bias)
        elif impl == "flash":
            out, _ = k2.flash_attention(q.contiguous(), k.contiguous(),
                                        v.contiguous(), bias)
        elif impl in ("ring", "allgather"):
            raise NotImplementedError(
                f"impl={impl!r} (context parallelism) is not ported yet")
        else:
            raise ValueError(f"unknown attention impl {impl!r}")
        out = out.transpose(1, 2).reshape(b, h, w, c)
        return layers.linear(out, self.proj.weight.reshape(c, c),
                             self.proj.bias)
