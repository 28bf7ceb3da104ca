"""Spatial multi-head attention over feature maps
(counterpart: lunaris_orion_tpu/ops/attention.py).

The JAX package's corrected form of the reference attention: full softmax
attention over all H*W tokens, with the factorized rel-pos term added per
key. The `auto` rule is the JAX package's: N <= 1024 tokens runs
`full_attention`; above that, K2 (`ops/cuda/flash_attention.py`): the
kernels on a CUDA device, their plain blockwise versions on the CPU.
Train mode adds dropout on the attention probabilities (Bernoulli on the
full path, K2's hash on the flash and windowed paths) and on the projected
output. A `window` below N runs `local_window_attention`: K2 over the
windows folded into the head axis. Ring and allgather attention are not
ported yet and raise.

Public functions keep the JAX package's layouts: feature maps NHWC
[B, H, W, C]; q, k, v [B, heads, N, d]; bias [heads, N].
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from lunaris_orion_tpu_torch.ops import layers
from lunaris_orion_tpu_torch.ops.cuda import flash_attention as k2
from lunaris_orion_tpu_torch.ops.rng import device_generator, int32_seed


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
                   bias: Optional[torch.Tensor], *, dropout_rate: float = 0.0,
                   generator: Optional[torch.Generator] = None
                   ) -> torch.Tensor:
    """O(N^2)-memory attention in f32 for small N; bias [heads, N] or None.
    With a generator, Bernoulli dropout on the probabilities."""
    d = q.shape[-1]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (d ** -0.5)
    if bias is not None:
        s = s + bias.float()[None, :, None, :]
    p = layers.dropout(torch.softmax(s, dim=-1), dropout_rate,
                       generator=generator)
    return torch.matmul(p, v.float()).to(q.dtype)


class WindowTilingError(ValueError):
    """A window cannot tile this input's token count (N % window != 0): a
    type of its own, so that callers that fall back to global attention
    (`QualityEvaluator.score_directory`) catch the contract, not a
    message."""


def local_window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           bias: torch.Tensor, *, window: int,
                           dropout_rate: float = 0.0, seed: int = 0,
                           bwd: Optional[str] = None) -> torch.Tensor:
    """Attention in which each token sees only the keys of its own
    contiguous window of the flattened token axis (the JAX package's
    `local_window_attention`). q, k, v [B, heads, N, d] contiguous, bias
    [heads, N] f32; returns o [B, heads, N, d].

    The windows fold into the head axis: q, k, v become views
    [B, heads * nW, W, d] and bias [heads * nW, W], and one K2 call (with
    its backward, and its plain version on the CPU) runs every window at
    once. `window` <= 0 raises ValueError; `window` >= N is global
    attention; N % window != 0 raises WindowTilingError. A call with more
    than K2's MAX_ROWS rows runs in batch chunks, each numbered by
    `row_offset` as rows of the one call, so the dropout mask does not
    depend on the chunking. Dropout is K2's hash over (seed, folded row,
    position in the window): the JAX package draws its windowed masks from
    jax.random instead, so the masks differ from it."""
    b, h, n, d = q.shape
    if window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    window = min(window, n)
    if n % window != 0:
        raise WindowTilingError(f"window {window} must divide N={n}")
    rows = h * (n // window)                  # folded heads an image
    if rows > k2.MAX_ROWS:
        raise ValueError(f"local_window_attention: {h} heads x {n // window} "
                         f"windows exceed K2's {k2.MAX_ROWS} rows a call")
    fold = lambda t: t.reshape(t.shape[0], rows, window, d)
    bias_w = bias.reshape(rows, window)
    chunk = k2.MAX_ROWS // rows
    outs = [k2.flash_attention(
        fold(q[i:i + chunk]), fold(k[i:i + chunk]), fold(v[i:i + chunk]),
        bias_w, dropout_rate=dropout_rate, seed=seed, row_offset=i * rows,
        bwd=bwd)[0] for i in range(0, b, chunk)]
    out = outs[0] if len(outs) == 1 else torch.cat(outs)
    return out.reshape(b, h, n, d)


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
                window: Optional[int] = None, dropout_rate: float = 0.0,
                seeds: Optional[Tuple[int, int]] = None,
                bwd: Optional[str] = None) -> torch.Tensor:
        """x [B, H, W, C] -> [B, H, W, C].

        impl: 'auto' (N <= 1024 -> 'full', else 'flash'), 'full', or
        'flash' (K2). A `window` below N overrides it with
        `local_window_attention`, as in the JAX package. seeds:
        (attention, projection) seeds of train-mode dropout at
        `dropout_rate`; None runs without dropout. bwd: K2's backward
        variant on CUDA (None: its default)."""
        b, h, w, c = x.shape
        n = h * w
        if window is not None and window <= 0:
            raise ValueError(f"window must be positive, got {window} "
                             "(use None / --attn_window 0 for global)")
        windowed = window is not None and window < n
        if windowed and impl in ("ring", "allgather"):
            raise ValueError(f"window={window} cannot combine with "
                             f"impl={impl!r}")
        if windowed:
            impl = "window"
        elif impl == "auto":
            impl = "full" if n <= 1024 else "flash"
        drop = seeds is not None and dropout_rate > 0.0
        q, k, v = multihead_qkv(x, self.qkv.weight, self.qkv.bias,
                                self.num_heads)
        bias = rel_pos_bias(self.rel_pos_h[0, :, :, 0],
                            self.rel_pos_w[0, :, 0, :], h, w)
        if impl == "full":
            out = full_attention(
                q, k, v, bias, dropout_rate=dropout_rate,
                generator=device_generator(seeds[0], x.device) if drop else None)
        elif impl == "window":
            out = local_window_attention(
                q.contiguous(), k.contiguous(), v.contiguous(), bias,
                window=window, dropout_rate=dropout_rate if drop else 0.0,
                seed=int32_seed(seeds[0]) if drop else 0, bwd=bwd)
        elif impl == "flash":
            out, _ = k2.flash_attention(
                q.contiguous(), k.contiguous(), v.contiguous(), bias,
                dropout_rate=dropout_rate if drop else 0.0,
                seed=int32_seed(seeds[0]) if drop else 0, bwd=bwd)
        elif impl in ("ring", "allgather"):
            raise NotImplementedError(
                f"impl={impl!r} (context parallelism) is not ported yet")
        else:
            raise ValueError(f"unknown attention impl {impl!r}")
        out = out.transpose(1, 2).reshape(b, h, w, c)
        out = layers.linear(out, self.proj.weight.reshape(c, c),
                            self.proj.bias)
        return layers.dropout(
            out, dropout_rate,
            generator=device_generator(seeds[1], x.device) if drop else None)
