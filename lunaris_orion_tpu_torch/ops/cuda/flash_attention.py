"""K2 forward -- flash attention with a per-key bias and hash dropout.

`flash_attention` sends tensors on the CPU to `attention_plain` and tensors
on a CUDA device to the hand-written kernel in
`csrc/flash_attention_fwd.cu`; it raises on any other device and never
falls back. The kernel replaces `lunaris_orion_tpu/ops/pallas/
flash_attention.py` `_fwd_kernel` and computes what `attention_bhnd`
computes, returning the row log-sum-exp as well (the backward needs it).

Dropout is the JAX package's stateless hash (`_keep_mask`), bit for bit,
so that a backward kernel can regenerate the mask from (seed, row, k, q).

`launches` counts the kernel launches made by `flash_attention`; the plain
version does not count.
"""

from __future__ import annotations

import numpy as np
import torch

from lunaris_orion_tpu_torch.ops.cuda import _build

launches = 0

HEAD_DIMS = (8, 16, 48, 64)          # the kernel's compiled head sizes
_M32 = 0xFFFFFFFF
C1 = 0x9E3779B9
C2 = 0x85EBCA6B
C3 = 0xC2B2AE35


def dropout_threshold(keep_prob: float) -> int:
    """uint32 threshold of `bits < threshold`, clamped to 2**32 - 1 as in
    `_dropout_threshold` (a keep_prob that rounds to 1.0 keeps all)."""
    return min(int(keep_prob * 4294967296.0), _M32)


def _inv_keep(dropout_rate: float) -> float:
    """f32 value of 1 / (1 - rate), the factor the TPU kernel applies."""
    return float(np.float32(1.0 / (1.0 - dropout_rate)))


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2**32 for int64 a and a constant c < 2**32, in int64
    without overflow: the uint32 multiply torch lacks."""
    a = a & _M32
    lo, hi = a & 0xFFFF, a >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & _M32


def keep_mask(row_seed: torch.Tensor, k_abs: torch.Tensor,
              q_abs: torch.Tensor, threshold: int) -> torch.Tensor:
    """The hash keep-mask in torch, bit-identical to `_keep_mask`.

    Values are held as int64 in [0, 2**32), so the right shift is the
    logical one and the compare is unsigned. Arguments broadcast:
    row_seed (uint32 values), k_abs and q_abs (absolute positions)."""
    h = (row_seed + _mul32(k_abs, C2) + _mul32(q_abs, C3)) & _M32
    h = h ^ (h >> 15)
    return _mul32(h, C2) < threshold


def row_seeds(seed: int, bh: int, row_offset: int = 0,
              device=None) -> torch.Tensor:
    """[BH] uint32 values (as int64) of seed ^ ((row + row_offset) * C1)."""
    rows = torch.arange(bh, device=device, dtype=torch.int64) + row_offset
    return (seed & _M32) ^ _mul32(rows, C1)


def _check_shapes(q, k, v, bias):
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError("q, k, v must be [B, H, N, d] with k.shape == v.shape")
    b, h, _, d = q.shape
    if k.shape[0] != b or k.shape[1] != h or k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ "
                         "in B, H or d")
    if bias.shape != (h, k.shape[2]):
        raise ValueError(f"bias must be [H, Nk] = [{h}, {k.shape[2]}], got "
                         f"{tuple(bias.shape)}")


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: torch.Tensor, *, dropout_rate: float = 0.0,
                    seed: int = 0, q_offset: int = 0, row_offset: int = 0,
                    max_elems: int = 2**26):
    """The plain version of K2: blockwise over q, two passes per block.

    Same rounding points as the kernel: q scaled by d^-1/2 in its own dtype;
    scores and softmax statistics in f32; the dropped, rescaled
    probabilities rounded to v's dtype before P.V; the row sum from the
    undropped probabilities. Memory stays at about `max_elems` scores per
    block. Returns (o [B, H, Nq, d] in q's dtype, lse [B*H, Nq] f32)."""
    _check_shapes(q, k, v, bias)
    b, h, nq, d = q.shape
    nk = k.shape[2]
    dt = q.dtype
    qs = (q * torch.tensor(d ** -0.5, dtype=dt, device=q.device)).float()
    kt = k.float().transpose(-1, -2)
    vf = v.float()
    bias4 = bias.float()[None, :, None, :]
    use_drop = dropout_rate > 0.0
    if use_drop:
        threshold = dropout_threshold(1.0 - dropout_rate)
        inv_keep = _inv_keep(dropout_rate)
        rs = row_seeds(seed, b * h, row_offset, q.device).reshape(b, h, 1, 1)
        k_abs = torch.arange(nk, device=q.device, dtype=torch.int64)
    o = torch.empty_like(q)
    lse = torch.empty(b, h, nq, device=q.device, dtype=torch.float32)
    bq = max(1, min(nq, max_elems // max(1, b * h * nk)))
    for i0 in range(0, nq, bq):
        i1 = min(nq, i0 + bq)
        s = torch.matmul(qs[:, :, i0:i1], kt) + bias4          # [B,H,bq,Nk]
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
        l_sum = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
        if use_drop:
            q_abs = torch.arange(q_offset + i0, q_offset + i1,
                                 device=q.device, dtype=torch.int64)[:, None]
            keep = keep_mask(rs, k_abs, q_abs, threshold)
            p = torch.where(keep, p * inv_keep, torch.zeros_like(p))
        p = p.to(v.dtype).float()
        o[:, :, i0:i1] = (torch.matmul(p, vf) / l_sum).to(dt)
        lse[:, :, i0:i1] = (m + torch.log(l_sum)).squeeze(-1)
    return o, lse.reshape(b * h, nq)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: torch.Tensor, *, dropout_rate: float = 0.0,
                    seed: int = 0, q_offset: int = 0, row_offset: int = 0):
    """K2 forward. q [B, H, Nq, d], k/v [B, H, Nk, d] (contiguous, f32 or
    bf16, one dtype), bias [H, Nk] f32. `seed` is an int32 value;
    `q_offset` is the absolute position of q's first row and `row_offset`
    that of the first B*H row, as seen by the dropout hash (both 0 for the
    square single-device call). Returns (o [B, H, Nq, d], lse [B*H, Nq])."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, bias, dropout_rate=dropout_rate,
                               seed=seed, q_offset=q_offset,
                               row_offset=row_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    _check_shapes(q, k, v, bias)
    if q.dtype not in (torch.float32, torch.bfloat16) or not (
            q.dtype == k.dtype == v.dtype):
        raise ValueError("flash_attention: q, k, v must share one dtype, "
                         f"f32 or bf16 (got {q.dtype}, {k.dtype}, {v.dtype})")
    for name, t in (("q", q), ("k", k), ("v", v), ("bias", bias)):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be contiguous "
                             f"on {q.device}")
    if bias.dtype != torch.float32:
        raise ValueError("flash_attention: bias must be f32")
    b, h, nq, d = q.shape
    nk = k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} not in {HEAD_DIMS}")
    if b * h > 65535 or not 0 <= dropout_rate < 1.0:
        raise ValueError("flash_attention: B*H must be <= 65535 and "
                         "0 <= dropout_rate < 1")
    scale = float(torch.tensor(d ** -0.5, dtype=q.dtype))
    use_drop = dropout_rate > 0.0
    o = torch.empty_like(q)
    lse = torch.empty(b * h, nq, device=q.device, dtype=torch.float32)
    err = _build.library().lunaris_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
        o.data_ptr(), lse.data_ptr(), b * h, h, nq, nk, d, scale,
        int(use_drop),
        dropout_threshold(1.0 - dropout_rate) if use_drop else 0,
        _inv_keep(dropout_rate) if use_drop else 1.0,
        seed & _M32, q_offset, row_offset, int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention")
    global launches
    launches += 1
    return o, lse
