"""K2 -- flash attention with a per-key bias and hash dropout, forward and
backward.

`flash_attention` is a `torch.autograd.Function`. It sends tensors on the
CPU to the plain versions (`attention_plain`, `attention_bwd_plain`) and
tensors on a CUDA device to the hand-written kernels; it raises on any
other device and never falls back.
  forward   `csrc/flash_attention_fwd.cuh` (instances and entry point in
            `csrc/flash_attention_fwd*.cu`), replacing lunaris_orion_tpu/ops/
            pallas/flash_attention.py `_fwd_kernel`; returns the row
            log-sum-exp as well, which the backward needs. Three
            hand-written bodies, chosen by type and head size
            (`forward_instance`):
            "wgmma" bf16 at d 48, 64: two warpgroups of 64 query rows,
                    wgmma m64n128k16 for q k^T and m64n{d}k16 for p v with
                    p in registers, K, V and the bias fed by TMA through
                    mbarriers (dropout compiled in or out); bf16 at d 16
                    and 32 where Nq and Nk are at least NARROW_MIN_ROWS[d]:
                    its narrow form (three warpgroups, [rows][d] tiles
                    whose row is the swizzle's span, 32 or 64 bytes, the
                    bias as a k-step of its own, each tile's softmax under
                    the tile before's p v);
                    f32 at d 16, 32, 48 and 64 where Nq and Nk are at least
                    TF32_WGMMA_MIN_ROWS[d]: flash_fwd_wgmma_tf32,
                    TF32_WGMMA_ROWS[d] / 64 warpgroups of 64 rows, wgmma
                    in three TF32 passes a product on key tiles that a
                    pre-pass (`tf32_tiles`) split into hi and lo and laid
                    out as wgmma reads them;
            "window" bf16 and f32 at d 16 and 32 where Nq = Nk = W, a
                    multiple of 64 up to WINDOW_MAX (the windowed fold,
                    `window_shape`; f32 by default where it was faster,
                    `window_default`): bf16 flash_fwd_window
                    (`csrc/flash_attention_window.cuh`), a persistent block
                    whose two warpgroups take a window each, Q, K and V of
                    the next one loaded by TMA while they compute this one,
                    the softmax exact in one pass over all W keys (wgmma for
                    q k^T and p v); f32 flash_fwd_window_tf32
                    (`csrc/flash_attention_window_tf32.cuh`), the same walk
                    with each window's f32 q, K and V landed by TMA and split
                    into TF32 hi and lo inside the kernel (no pre-pass), every
                    product in three TF32 passes on wgmma;
            "mma"   d 16, 32, 48, 64 where Nq or Nk is short off the window
                    shapes (f32 at each, bf16 at d 16 and 32; the f32 fold at
                    48 and 64; bf16 at 48 and 64 by `body="mma"`): both
                    products on the
                    tensor cores, p kept in registers between them: bf16 on
                    mma.sync m16n8k16; f32 on m16n8k8 tf32 in three passes
                    (hi and lo of each operand: a_lo b_hi + a_hi b_lo +
                    a_hi b_hi), which hold f32's bars where one TF32 pass
                    would not (`tf32_round`, `split_tf32` emulate the
                    rounding);
            "simt"  d 8, on the CUDA cores.
            At d 16 dropout and a ragged Nk are compiled in (four instances
            a body); the other head sizes of "mma" test both at run time.
  backward  `csrc/flash_attention_bwd.cuh` (instances and entry point in
            `csrc/flash_attention_bwd*.cu`), in one of two variants:
            "fused"  one dk/dv kernel that also adds dq into an f32 buffer
                     with 16-byte atomic reductions (replaces
                     `_bwd_fused_kernel`), so scores, exp and mask are
                     computed once; its dq varies from run to run in the
                     last bits (`fused_instance`): "wgmma" for bf16 at d 48
                     and 64 (five wgmma products a query tile, K and V in
                     shared memory, fed by TMA) and at d 16 and 32 where Nq
                     and Nk are at least NARROW_MIN_ROWS[d] (its narrow form:
                     three warpgroups of 64 keys that meet only at the ds
                     tiles),
                     and for f32 at d 16, 32, 48 and 64 where Nq and Nk are
                     at least TF32_WGMMA_BWD_MIN_ROWS[d]
                     (flash_bwd_wgmma_tf32: TF32_WGMMA_BWD_KEYS[d] / 64
                     warpgroups of 64 keys, the five products in three TF32
                     passes on wgmma, on the pre-pass's tiles; at 48 and 64
                     every shape),
                     "window" for bf16 at d 16 and 32 on the window shapes
                     (flash_bwd_window: a window whole in one warpgroup,
                     delta in the kernel, dq written once: no f32 buffer, no
                     atomics, the same bits on every run; f32
                     flash_bwd_window_tf32 the same in three TF32 passes,
                     no pre-pass, by `body="window"`: slower than mma.sync),
                     "mma" at d 16 and 32 where the rows are short
                     (five products on the tensor cores; f32 in three TF32
                     passes), "simt" at d 8;
            "split"  the dk/dv kernel and a dq kernel (replace
                     `_bwd_dkv_kernel` and `_bwd_dq_kernel`), each with the
                     forward's "mma" and "simt" bodies
                     (`backward_instance`): "mma" for
                     bf16 at d 16, 32, 48, 64 (four and three products on
                     the tensor cores, p and ds kept in registers between
                     them, dbias without atomics), "simt" for f32 and bf16
                     d 8.
            A call that names no variant takes `default_bwd`, the variant
            measured faster for its type and head size.
The result is what `attention_bhnd` and its custom VJP compute, except that
the forward takes q unscaled: the d^-1/2 factor on dq is applied inside.

Dropout is the JAX package's stateless hash (`_keep_mask`), bit for bit, so
the backward regenerates the forward's mask from (seed, row, k, q).

At dropout 0 the forward goes through the operator
`lunaris_orion::flash_attention_fwd` (`ops/library.py`; CUDA kernel
`forward_kernel`, CPU kernel `attention_plain`): inside the autograd
Function, and alone when no gradient is recorded, so that eager and
traced (`torch.export`) code take one route into the kernel.

`launches`, `bwd_fused_launches`, `bwd_dkv_launches` and `bwd_dq_launches`
count the kernel launches; the plain versions do not count.
`wgmma_launches` and `bwd_wgmma_launches` count, among them, the launches
of the warpgroup bodies, `narrow_launches` and `bwd_narrow_launches`,
among those, the narrow ones (bf16 d 16 and 32), and `tf32_wgmma_launches` and
`bwd_tf32_wgmma_launches` the f32 ones (d 16, 32, 48, 64). `window_launches`
and `bwd_window_launches` count the window bodies' launches, bf16 and f32
(not among the warpgroup counts). `split_launches` counts the
launches of the f32 bodies' pre-pass (`tf32_tiles`): one a forward, two a
backward.
`shard_launches` and `bwd_shard_launches` count, among them, the forward
and backward launches on a q shard (q_offset > 0: context parallelism).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from lunaris_orion_tpu_torch.ops.cuda import _build

launches = 0
bwd_fused_launches = 0
bwd_dkv_launches = 0
bwd_dq_launches = 0
shard_launches = 0
bwd_shard_launches = 0
wgmma_launches = 0
bwd_wgmma_launches = 0
narrow_launches = 0
bwd_narrow_launches = 0
tf32_wgmma_launches = 0
bwd_tf32_wgmma_launches = 0
split_launches = 0
window_launches = 0
bwd_window_launches = 0

HEAD_DIMS = (8, 16, 32, 48, 64)      # the kernels' compiled head sizes
MAX_ROWS = 65535                     # B*H a launch takes (the grid's y)
MMA_HEAD_DIMS = (16, 32, 48, 64)     # those of the tensor-core forward
MMA_BWD_HEAD_DIMS = (16, 32, 48, 64) # the split backward's (dk/dv, dq; bf16)
MMA_FUSED_HEAD_DIMS = (16, 32)       # the fused backward's
WGMMA_HEAD_DIMS = (16, 32, 48, 64)   # the warpgroup bodies' (bf16)
NARROW_HEAD_DIMS = (16, 32)          # of those, the narrow bodies' (rows of 32, 64 bytes)
# By head size: where Nq or Nk is shorter the narrow bodies' set-up a
# block (a producer, a ring, barriers) is not paid back. Timed in turns on
# an H100 (PERF.md section 6) at dropout 0.1: at d 16 the mma.sync bodies
# win at N 256, 512 and 1024 and lose from 2048 on; at d 32, where
# mma.sync's products cost more, they win at N 256 only. mma.sync keeps
# those short rows where the window bodies do not take them (Nq != Nk,
# or N not a multiple of 64 up to WINDOW_MAX).
NARROW_MIN_ROWS = {16: 2048, 32: 512}
# The window bodies (bf16: flash_fwd_window, flash_bwd_window; f32:
# flash_fwd_window_tf32, flash_bwd_window_tf32, three TF32 passes split in
# the kernel): both types at these head sizes on Nq = Nk = W, W a multiple
# of WINDOW_STEP up to WINDOW_MAX (`window_shape`), the default where
# `window_default` says. The f32 fold at d 48 and 64 keeps its global
# bodies (mma.sync forward, warpgroup backward).
WINDOW_HEAD_DIMS = (16, 32)
WINDOW_MAX = 256
WINDOW_STEP = 64
TF32_WGMMA_HEAD_DIMS = (16, 32, 48, 64)  # the f32 warpgroup bodies' (three TF32 passes)
# By head size: where Nq or Nk is shorter the f32 warpgroup forward's
# pre-pass and set-up are not paid back, and the fused backward's at
# TF32_WGMMA_BWD_MIN_ROWS (chip_smoke.py phases 4 and 7 time both bodies in
# turns at N 256 to 4096; PERF.md section 6): mma.sync takes the short rows
# at d 16 and 32 (on the windowed fold where the f32 window bodies are not
# the default, `window_default`). At d 48 and 64 the backward's
# warpgroup body beats the CUDA-core one it replaced at every N measured,
# N 256 (the windowed fold) included.
TF32_WGMMA_MIN_ROWS = {16: 2048, 32: 2048, 48: 1024, 64: 1024}
TF32_WGMMA_BWD_MIN_ROWS = {16: 2048, 32: 2048, 48: 0, 64: 0}
# The f32 warpgroup forward's query rows a block and the fused backward's
# keys a block (64 a consumer warpgroup), as the C side builds them
# (`lunaris_k2_fwd_wgmma_tf32_rows`, `lunaris_k2_bwd_wgmma_tf32_keys`).
TF32_WGMMA_ROWS = {16: 192, 32: 192, 48: 128, 64: 128}
TF32_WGMMA_BWD_KEYS = {16: 128, 32: 128, 48: 64, 64: 64}
FWD_BODIES = ("simt", "mma", "wgmma")  # the C entry points' `body` argument
# What HEAD_DIMS allow for the teacher's 8 heads.
SUPPORTED = (f"d in {HEAD_DIMS}: feature_dim "
             f"{', '.join(str(8 * d) for d in HEAD_DIMS)} at 8 heads")
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
                    max_elems: int = 2**26, block_k: int | None = None):
    """The plain version of K2: blockwise over q, two passes per block.

    Same rounding points as the kernel: q scaled by d^-1/2 in its own dtype;
    scores and softmax statistics in f32; the dropped, rescaled
    probabilities rounded to v's dtype before P.V; the row sum from the
    undropped probabilities. Memory stays at about `max_elems` scores per
    block.

    With `block_k` the softmax runs online over key blocks of that size, as
    the kernels run it: p is taken against the running max and rounded to
    v's dtype before later blocks correct it. In f32 the two agree to
    rounding; in bf16 p rounds at another magnitude, so a kernel's bf16
    output is held element by element against this form at the kernel's own
    key tile. The window body's (flash_fwd_window) is `block_k` = W = Nk:
    one key block, the exact softmax it takes in one pass. Returns
    (o [B, H, Nq, d] in q's dtype, lse [B*H, Nq] f32)."""
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

    def dropped(p, i0, i1, k0, k1):
        if not use_drop:
            return p
        q_abs = torch.arange(q_offset + i0, q_offset + i1, device=q.device,
                             dtype=torch.int64)[:, None]
        keep = keep_mask(rs, k_abs[k0:k1], q_abs, threshold)
        return torch.where(keep, p * inv_keep, torch.zeros_like(p))

    o = torch.empty_like(q)
    lse = torch.empty(b, h, nq, device=q.device, dtype=torch.float32)
    bq = max(1, min(nq, max_elems // max(1, b * h * (block_k or nk))))
    for i0 in range(0, nq, bq):
        i1 = min(nq, i0 + bq)
        if block_k is None:
            s = torch.matmul(qs[:, :, i0:i1], kt) + bias4      # [B,H,bq,Nk]
            m = s.amax(dim=-1, keepdim=True)
            p = torch.exp(s - m)
            l_sum = p.sum(dim=-1, keepdim=True)
            p = dropped(p, i0, i1, 0, nk).to(v.dtype).float()
            acc = torch.matmul(p, vf)
        else:
            rows = (b, h, i1 - i0, 1)
            acc = torch.zeros(b, h, i1 - i0, d, device=q.device)
            m = torch.full(rows, -1e30, device=q.device)
            l_sum = torch.zeros(rows, device=q.device)
            for k0 in range(0, nk, block_k):
                k1 = min(nk, k0 + block_k)
                s = (torch.matmul(qs[:, :, i0:i1], kt[..., k0:k1])
                     + bias4[..., k0:k1])
                m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
                corr = torch.exp(m - m_new)
                p = torch.exp(s - m_new)
                l_sum = l_sum * corr + p.sum(dim=-1, keepdim=True)
                p = dropped(p, i0, i1, k0, k1).to(v.dtype).float()
                acc = acc * corr + torch.matmul(p, vf[:, :, k0:k1])
                m = m_new
        l_sum = l_sum.clamp_min(1e-30)
        o[:, :, i0:i1] = (acc / l_sum).to(dt)
        lse[:, :, i0:i1] = (m + torch.log(l_sum)).squeeze(-1)
    return o, lse.reshape(b * h, nq)


def attention_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        bias: torch.Tensor, o: torch.Tensor, lse: torch.Tensor,
                        do: torch.Tensor, *, dropout_rate: float = 0.0,
                        seed: int = 0, q_offset: int = 0, row_offset: int = 0,
                        max_elems: int = 2**26):
    """The plain version of the K2 backward kernels: blockwise over q.

    Same rounding points as the kernels (and the TPU kernels): scores from
    the forward's scaled q, p = exp(s - lse) in f32; ds = p (dp - delta)
    rounded to q's dtype before the dq and dk products; the dropped,
    rescaled p rounded to dO's dtype before the dv product; dbias from the
    unrounded f32 ds, summed over the batch; delta = rowsum(f32(o) f32(dO)).
    dq carries the d^-1/2 factor of the scaling inside the forward. It is
    the plain twin of every fused backward body, the window ones
    (flash_bwd_window, flash_bwd_window_tf32, which form delta and write dq
    themselves) included.
    Returns (dq, dk, dv in the inputs' dtype, dbias [H, Nk] f32)."""
    _check_shapes(q, k, v, bias)
    b, h, nq, d = q.shape
    nk = k.shape[2]
    dt = q.dtype
    scale = torch.tensor(d ** -0.5, dtype=dt, device=q.device)
    qs = (q * scale).float()
    kf, vf, dof = k.float(), v.float(), do.float()
    bias4 = bias.float()[None, :, None, :]
    lse4 = lse.reshape(b, h, nq, 1)
    delta = (o.float() * dof).sum(-1, keepdim=True)             # [B,H,Nq,1]
    use_drop = dropout_rate > 0.0
    if use_drop:
        threshold = dropout_threshold(1.0 - dropout_rate)
        inv_keep = _inv_keep(dropout_rate)
        rs = row_seeds(seed, b * h, row_offset, q.device).reshape(b, h, 1, 1)
        k_abs = torch.arange(nk, device=q.device, dtype=torch.int64)
    dq = torch.empty_like(q)
    dk = torch.zeros(b, h, nk, d, device=q.device, dtype=torch.float32)
    dv = torch.zeros_like(dk)
    dbias = torch.zeros(b, h, nk, device=q.device, dtype=torch.float32)
    bq = max(1, min(nq, max_elems // max(1, b * h * nk)))
    for i0 in range(0, nq, bq):
        i1 = min(nq, i0 + bq)
        s = torch.matmul(qs[:, :, i0:i1], kf.transpose(-1, -2)) + bias4
        p = torch.exp(s - lse4[:, :, i0:i1])                    # [B,H,bq,Nk]
        dp = torch.matmul(dof[:, :, i0:i1], vf.transpose(-1, -2))
        pv = p
        if use_drop:
            q_abs = torch.arange(q_offset + i0, q_offset + i1,
                                 device=q.device, dtype=torch.int64)[:, None]
            keep = keep_mask(rs, k_abs, q_abs, threshold)
            dp = torch.where(keep, dp * inv_keep, torch.zeros_like(dp))
            pv = torch.where(keep, p * inv_keep, torch.zeros_like(p))
        ds = p * (dp - delta[:, :, i0:i1])
        dsc = ds.to(dt).float()
        dq[:, :, i0:i1] = torch.matmul(dsc, kf).to(dt) * scale
        dk += torch.matmul(dsc.transpose(-1, -2), qs[:, :, i0:i1])
        dv += torch.matmul(pv.to(do.dtype).float().transpose(-1, -2),
                           dof[:, :, i0:i1])
        dbias += ds.sum(dim=2)
    return dq, dk.to(dt), dv.to(dt), dbias.sum(dim=0)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """f32 x rounded to TF32 (10 mantissa bits), to nearest with ties away
    from zero: the kernels' `cvt.rna.tf32.f32`, in integer operations on
    the f32 bits. Tests and measurements only."""
    bits = x.float().contiguous().view(torch.int32).to(torch.int64) & _M32
    bits = (bits + 0x1000) & 0xFFFFE000
    bits = torch.where(bits >= 2**31, bits - 2**32, bits)
    return bits.to(torch.int32).view(torch.float32)


def split_tf32(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo), both TF32, with hi + lo = x to within 2^-22 |x|: the
    operands of the kernels' three-pass products (hi = tf32(x), lo =
    tf32(x - hi); x - hi is exact in f32). Tests and measurements only."""
    hi = tf32_round(x)
    return hi, tf32_round(x.float() - hi)


# The f32 warpgroup bodies' pre-pass (csrc/flash_attention_tf32_split.cu):
# modes, and the rows of a tile (keys or queries) and of a backward query
# sub-tile at d 48 and 64.
TF32_TILE = 64
TF32_SUB = 16
TF32_FWD, TF32_BWD_Q, TF32_BWD_K = 0, 1, 2
_LOG2E = float(np.float32(1.4426950408889634))


def tf32_tile_bytes(mode: int, d: int) -> int:
    """The bytes of one tile of the pre-pass (`flash_attention_common.cuh`,
    "the TF32 tiles"): a forward key tile 1024 d, a backward query tile
    2048 d + 512, a backward key tile 8192 at d 16 and 1536 d at 48, 64."""
    if mode == TF32_FWD:
        return 1024 * d
    if mode == TF32_BWD_Q:
        return 2048 * d + 512
    return 8192 if d == 16 else 1536 * d


def _sw32(r, c):
    """Byte offset of f32 element (r, c) of a [rows][8] tile with the 32-byte
    swizzle (csrc/flash_attention_common.cuh `sw32_offset`)."""
    return r * 32 + ((((c >> 2) ^ (r >> 2)) & 1) << 4) + (c & 3) * 4


def _sw128(r, c):
    """The same in a [rows][32] atom with the 128-byte swizzle
    (`sw128_offset`)."""
    return r * 128 + ((((c >> 2) ^ r) & 7) << 4) + (c & 3) * 4


def perm8(k):
    """Where key (or query) k of a tile sits along the k of a transposed
    TF32 operand: within each 8, 2t at t and 2t + 1 at t + 4 (`perm8`)."""
    return (k & -8) | ((k & 1) << 2) | ((k & 7) >> 1)


def tf32_tile_count(mode: int, n: int) -> int:
    """Tiles of the pre-pass a BH row: ceil(N / 64), and for TF32_BWD_K an
    even count (a block of the d 16 backward takes two)."""
    if mode == TF32_BWD_K:
        return 2 * -(-n // (2 * TF32_TILE))
    return -(-n // TF32_TILE)


def _tile_maps(mode: int, d: int):
    """Where the pre-pass puts each operand of a tile, as byte offsets
    within the tile: [(source, hi offsets, lo offsets)], each [64 rows, d],
    source 0 the call's `a` (k; qs = q d^-1/2), 1 its `b` (v; dO); then the
    offsets [64] of -lse log2 e and of delta (TF32_BWD_Q), else None. "Rows"
    are [R][8] tiles of the 32-byte swizzle, d / 8 of them (lo 4 R d bytes
    on); "trows" the same transposed, [d][8] a k-step of 8 rows; "cols" the
    transposed [2 d][32] atoms of the 128-byte swizzle, rows d.. lo."""
    r = torch.arange(TF32_TILE)[:, None]
    c = torch.arange(d)[None, :]

    def rows(base, rr, n):
        off = base + (c >> 3) * 32 * n + _sw32(rr, c & 7)
        return off, off + 4 * n * d

    def trows(base, rr, col, n):
        off = base + (rr >> 3) * 32 * d + _sw32(c, col & 7)
        return off, off + 4 * n * d

    def cols(base, col):
        atom = base + (r >> 5) * 256 * d
        return atom + _sw128(c, col & 31), atom + _sw128(d + c, col & 31)

    if mode == TF32_FWD:
        return [(0, *rows(0, r, TF32_TILE)), (1, *cols(512 * d, perm8(r)))], None
    if mode == TF32_BWD_K:
        if d == 16:
            return [(0, *cols(0, r))], None
        return [(0, *rows(0, r, TF32_TILE)), (1, *rows(512 * d, r, TF32_TILE)),
                (0, *trows(1024 * d, r, r, TF32_TILE))], None
    if d == 16:
        stats = 2048 * d + 4 * r[:, 0]
        return [(0, *rows(0, r, TF32_TILE)), (1, *rows(8192, r, TF32_TILE)),
                (0, *cols(16384, perm8(r))), (1, *cols(24576, perm8(r)))], (
                    stats, stats + 4 * TF32_TILE)
    sub = (r // TF32_SUB) * (512 * d + 128)
    rs = r % TF32_SUB
    stats = (sub + 512 * d + 4 * rs)[:, 0]
    return [(0, *rows(sub, rs, TF32_SUB)), (1, *rows(sub + 128 * d, rs, TF32_SUB)),
            (0, *trows(sub + 256 * d, rs, perm8(rs), TF32_SUB)),
            (1, *trows(sub + 384 * d, rs, perm8(rs), TF32_SUB))], (
                stats, stats + 4 * TF32_SUB)


def tf32_tiles_plain(mode: int, a, b=None, lse=None, delta=None,
                     scale: float = 1.0) -> torch.Tensor:
    """The plain version of the pre-pass `tf32_tiles`: the same bytes, as
    an f32 tensor [BH, tiles, tf32_tile_bytes(mode, d) / 4], d 16, 32, 48
    or 64 (`_tile_maps` says where each value goes).

    TF32_FWD: a = k, b = v [B, H, N, d] f32; a key tile is K hi and K lo
    as rows, then V^T as two atoms (keys 0-31, 32-63), rows 0..d-1 V hi,
    d..2d-1 V lo, keys permuted by `perm8`. TF32_BWD_Q: a = q, b = dO, lse
    [B*H, N], delta [B, H, N], scale d^-1/2: at d 16 qs = q * scale and dO
    as the forward's K, qs^T and dO^T as its V^T, then -lse log2 e (-inf
    past N) and delta; at d 32, 48, 64 four sub-tiles of 16 queries, each
    qs and dO as rows, qs^T and dO^T as transposed rows (queries
    permuted), then its 16 of -lse log2 e and of delta. TF32_BWD_K: a = k
    (b = v at d 32, 48, 64); d 16: K^T as the forward's V^T, keys in
    order; d 32, 48, 64: K and V as rows, then K^T as transposed rows; an
    even count of tiles.
    Rows past N are zeros; hi and lo are `split_tf32`'s."""
    bsz, h, n, d = a.shape
    if d not in TF32_WGMMA_HEAD_DIMS:
        raise ValueError(f"tf32_tiles: head size in {TF32_WGMMA_HEAD_DIMS}")
    if mode not in (TF32_FWD, TF32_BWD_Q, TF32_BWD_K):
        raise ValueError(f"tf32_tiles: no mode {mode}")
    bh, tiles = bsz * h, tf32_tile_count(mode, n)
    pad = tiles * TF32_TILE - n
    out = torch.zeros(bh, tiles, tf32_tile_bytes(mode, d) // 4,
                      dtype=torch.float32, device=a.device)
    shaped = lambda x: torch.nn.functional.pad(
        x.float().reshape(bh, n, d), (0, 0, 0, pad)).reshape(
            bh, tiles, TF32_TILE, d)
    if mode == TF32_BWD_Q:
        a = a.float() * torch.tensor(scale, dtype=torch.float32)
    maps, stats = _tile_maps(mode, d)
    split = {}
    for src, hi_off, lo_off in maps:
        if src not in split:
            split[src] = split_tf32(shaped((a, b)[src]))
        hi, lo = split[src]
        out[:, :, hi_off.to(a.device) // 4] = hi
        out[:, :, lo_off.to(a.device) // 4] = lo
    if stats is not None:
        nl = -lse.reshape(bh, n).float() * torch.tensor(_LOG2E)
        out[:, :, stats[0].to(a.device) // 4] = torch.nn.functional.pad(
            nl, (0, pad), value=-float("inf")).reshape(bh, tiles, TF32_TILE)
        out[:, :, stats[1].to(a.device) // 4] = torch.nn.functional.pad(
            delta.reshape(bh, n).float(), (0, pad)).reshape(
                bh, tiles, TF32_TILE)
    return out


def tf32_tiles(mode: int, a, b=None, lse=None, delta=None,
               scale: float = 1.0, out=None) -> torch.Tensor:
    """The f32 warpgroup bodies' pre-pass (`tf32_tiles_plain` says what it
    writes): on a CUDA tensor one launch of csrc/flash_attention_tf32_split.cu
    into `out` (allocated when None), counted in `split_launches`; on a CPU
    tensor the plain version."""
    if a.device.type == "cpu":
        return tf32_tiles_plain(mode, a, b, lse, delta, scale)
    bsz, h, n, d = a.shape
    shape = (bsz * h, tf32_tile_count(mode, n), tf32_tile_bytes(mode, d) // 4)
    if out is None:
        out = torch.empty(shape, dtype=torch.float32, device=a.device)
    if out.shape != shape or not out.is_contiguous() or out.data_ptr() % 16:
        raise ValueError(f"tf32_tiles: out must be a contiguous {shape}, "
                         "16-byte aligned")
    ptr = lambda t: None if t is None else t.data_ptr()
    err = _build.library().lunaris_k2_tf32_split(
        mode, a.data_ptr(), ptr(b), ptr(lse), ptr(delta), out.data_ptr(),
        bsz * h, n, d, scale, torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(err, "tf32_tiles")
    global split_launches
    split_launches += 1
    return out


BWD_VARIANTS = ("fused", "split")


def default_bwd(dtype: torch.dtype, d: int) -> str:
    """The backward variant a call takes when it names none: the one measured
    faster in turns on an H100 80GB HBM3 at 700 W (`chip_smoke.py` phase 7;
    PERF.md section 6). "fused" where one pass's saving, scores, exp and
    mask computed once for all three gradients, outweighs adding dq across
    key blocks: on the tensor cores at d 16, 32, 48 and 64 in both types
    (the warpgroup bodies where the rows are long, at d 48 and 64 at every
    N; mma.sync at d 16 and 32 where they are short; in bf16 about half the
    split pair's time at d 48 and 64 at B16 H8 N16384; f32's split pair
    runs on the CUDA cores), and in f32 at d 8 on the CUDA cores (1.38-1.57
    against 1.47-1.64 ms at B2 H8 N4096 in two runs). "split" in bf16 at
    d 8, where the two measured within noise."""
    if dtype == torch.bfloat16:
        return ("fused" if d in MMA_FUSED_HEAD_DIMS + WGMMA_HEAD_DIMS
                else "split")
    return "fused"


def _check_kernel_inputs(name: str, tensors, dropout_rate: float):
    """Validate what the kernels take; returns (scale, dropout args)."""
    q, k, v, bias = tensors[:4]
    _check_shapes(q, k, v, bias)
    if q.dtype not in (torch.float32, torch.bfloat16) or not (
            q.dtype == k.dtype == v.dtype):
        raise ValueError(f"{name}: q, k, v must share one dtype, f32 or bf16 "
                         f"(got {q.dtype}, {k.dtype}, {v.dtype})")
    for i, t in enumerate(tensors):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name}: argument {i} must be contiguous on "
                             f"{q.device}")
    if bias.dtype != torch.float32:
        raise ValueError(f"{name}: bias must be f32")
    b, h, _, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"{name}: no kernel for head dim {d} ({SUPPORTED})")
    if b * h > MAX_ROWS or not 0 <= dropout_rate < 1.0:
        raise ValueError(f"{name}: B*H must be <= {MAX_ROWS} and "
                         "0 <= dropout_rate < 1")
    use_drop = dropout_rate > 0.0
    scale = float(torch.tensor(d ** -0.5, dtype=q.dtype))
    return scale, (int(use_drop),
                   dropout_threshold(1.0 - dropout_rate) if use_drop else 0,
                   _inv_keep(dropout_rate) if use_drop else 1.0)


def _body(name: str, dtype: torch.dtype, d: int, mma_dims: tuple,
          body: str | None, f32: bool = True, wgmma: str | None = None) -> str:
    """The body a call of `name` takes: the tensor cores ("mma") at the head
    sizes `mma_dims` for bf16, and for f32 too where `f32` (three TF32
    passes); the CUDA cores ("simt") otherwise; and for bf16 at
    WGMMA_HEAD_DIMS and f32 at TF32_WGMMA_HEAD_DIMS, where the kernel has a
    warpgroup body ("wgmma": wgmma fed by TMA), that one. `wgmma` names the
    body it replaced there (f32: the forward's "mma", the fused backward's
    "mma" at d 16 and 32 and "simt" at 48, 64), which
    `body` may still name, as it may name "mma" wherever the kernel has a
    tensor-core body. `body` "simt" reaches the CUDA-core kernel where
    the tensor-core one is the default (f32 at every head size, bf16 at
    d 16): measurements and tests compare the two; the autograd path never
    passes it."""
    if dtype not in (torch.float32, torch.bfloat16) or d not in HEAD_DIMS:
        raise ValueError(f"{name}: no kernel for {dtype}, head dim {d} (f32 "
                         f"or bf16, {SUPPORTED})")
    mma = d in mma_dims and (f32 or dtype == torch.bfloat16)
    warpgroup = wgmma is not None and d in (
        WGMMA_HEAD_DIMS if dtype == torch.bfloat16 else TF32_WGMMA_HEAD_DIMS)
    default = "wgmma" if warpgroup else "mma" if mma else "simt"
    body = body or default
    ok = body in FWD_BODIES and (
        body == default or (warpgroup and body == wgmma)
        or (body == "mma" and mma)
        or (body == "simt" and (dtype == torch.float32 or d == 16)))
    if not ok:
        wg = (f"; wgmma: bf16 at d in {WGMMA_HEAD_DIMS}, f32 at d in "
              f"{TF32_WGMMA_HEAD_DIMS}" if wgmma else "")
        raise ValueError(f"{name}: body {body!r} does not take {dtype} at "
                         f"head dim {d} (tensor cores: bf16"
                         f"{', f32' if f32 else ''} at d in {mma_dims}{wg})")
    return body


def _short_rows_body(dtype: torch.dtype, d: int, nq: int, nk: int,
                     backward: bool = False) -> str | None:
    """The body a call at d 16 and 32 (bf16 and f32) or 48, 64 (f32, the
    forward) takes where its rows are short, else None (the default of
    `_body`): the narrow warpgroup bodies (bf16) start a producer, a ring
    and their barriers per block, and the f32 ones a pre-pass as well,
    which short rows (a 32 px model, a short q shard, the f32 fold at d 48
    and 64) do not pay back. A window shape (`window_shape`) takes the
    window bodies ahead of this rule where `window_default` says
    (`_window_body`). Elsewhere both types keep mma.sync: bf16 under
    NARROW_MIN_ROWS[d], f32's forward under TF32_WGMMA_MIN_ROWS[d] and its
    fused backward (`backward`) under TF32_WGMMA_BWD_MIN_ROWS[d] (0 at d 48
    and 64, whose fused backward has no mma.sync body)."""
    bf16 = dtype == torch.bfloat16
    if bf16 and d in NARROW_HEAD_DIMS and min(nq, nk) < NARROW_MIN_ROWS[d]:
        return "mma"
    rows = TF32_WGMMA_BWD_MIN_ROWS if backward else TF32_WGMMA_MIN_ROWS
    if not bf16 and d in TF32_WGMMA_HEAD_DIMS and min(nq, nk) < rows[d]:
        return "mma"
    return None


def window_shape(dtype: torch.dtype, d: int, nq: int, nk: int) -> bool:
    """Whether the window bodies take a call: bf16 or f32 at d in
    WINDOW_HEAD_DIMS, Nq = Nk = W with W a multiple of WINDOW_STEP up to
    WINDOW_MAX (the windowed fold at windows 64, 128, 192 and 256)."""
    return (dtype in (torch.bfloat16, torch.float32) and d in WINDOW_HEAD_DIMS
            and nq == nk and nk % WINDOW_STEP == 0 and 0 < nk <= WINDOW_MAX)


def window_default(dtype: torch.dtype, d: int, dropout_rate: float,
                   backward: bool = False) -> bool:
    """Whether a window shape takes the window body by default: where it was
    faster in turns than the mma.sync body it replaced, on an H100 at B16
    H8 N16384 W256 (chip_smoke.py phase 16 (a); PERF.md section 6). bf16:
    forward and fused backward at d 16 and 32. f32: the forward at d 16,
    and at d 32 without dropout (with it mma.sync was faster); the fused
    backward nowhere (its window body ran a fifth slower than
    flash_bwd_fused_tf32), which `body="window"` still reaches."""
    if dtype == torch.bfloat16:
        return True
    return not backward and (d == 16 or dropout_rate == 0.0)


def _window_body(name: str, dtype: torch.dtype, d: int, nq: int, nk: int,
                 body: str | None, dropout_rate: float,
                 backward: bool = False) -> bool:
    """Whether a call takes the window body: by default on every window
    shape where `window_default` says so; `body="window"` asks for it and
    raises off those shapes. Any other `body` (say "mma", for turns against
    the body it replaced) goes to `_body`."""
    if body == "window" and not window_shape(dtype, d, nq, nk):
        raise ValueError(
            f"{name}: body 'window' takes bf16 or f32 at d in "
            f"{WINDOW_HEAD_DIMS} "
            f"with Nq = Nk a multiple of {WINDOW_STEP} up to {WINDOW_MAX} "
            f"(got {dtype}, d {d}, Nq {nq}, Nk {nk})")
    return body == "window" or (
        body is None and window_shape(dtype, d, nq, nk)
        and window_default(dtype, d, dropout_rate, backward))


class ForwardInstance(NamedTuple):
    """The forward kernel instance a call launches."""
    body: str            # "window", "wgmma", "mma" (tensor cores) or "simt"
    head_dim: int
    block_k: int         # keys a tile
    rows: int            # query rows a block
    q_blocks: int        # blocks along Nq (the last one guards its rows)
    dropout: str         # "off" / "on": compiled in; "runtime": tested per tile
    ragged: bool         # the instance masks the last key tile


def forward_instance(dtype: torch.dtype, d: int, nq: int, nk: int,
                     dropout_rate: float,
                     body: str | None = None) -> ForwardInstance:
    """Which forward instance (dtype, d, Nq, Nk, dropout) takes: the rule of
    the C dispatch (`csrc/flash_attention_fwd*.cu`), as a pure function.

    bf16 at d 48 and 64 takes the warpgroup body ("wgmma": 128 query rows
    and key tiles of 128 a block, dropout compiled in or out, every Nk in
    one instance: the bias masks the keys past it); `body="mma"` reaches
    the tensor-core body it replaced there. bf16 at d 16 and 32 takes the
    narrow warpgroup body ("wgmma", 192 query rows a block, key tiles of
    128 at d 16 and 64 at d 32) where Nq and Nk are both at least
    NARROW_MIN_ROWS[d], the mma.sync body where either is shorter (the
    windowed fold); `body` reaches either, and "simt" at d 16. f32 at d 16,
    32, 48 and 64 takes its own warpgroup body ("wgmma", TF32_WGMMA_ROWS[d]
    query rows a block, key tiles of 64 from the pre-pass) where Nq and Nk
    are both at least TF32_WGMMA_MIN_ROWS[d], the mma.sync body where
    either is shorter; `body` reaches either. d 16, 32, 48, 64
    otherwise take the tensor-core body of their type (f32: three TF32
    passes, keys in tiles of 32 at d 48 and 64), d 8 the CUDA-core body
    (`body` as in `_body`). At d 16 dropout and raggedness are template parameters; the
    other head sizes of those bodies have one instance each, which masks
    the last key tile and reads the dropout flag at run time. Nq only sets
    the grid: every instance guards the rows past it. Ahead of all that,
    bf16 and f32 at d 16 and 32 on Nq = Nk = W (`window_shape`: the
    windowed fold) take the window bodies ("window": a window of W queries
    a step of a persistent block, its one key tile the whole window, so
    `block_k` and `rows` are W; dropout compiled in or out; f32 in three
    TF32 passes, split in the kernel), by default where `window_default`
    says; `body` reaches either there."""
    if _window_body("flash_attention", dtype, d, nq, nk, body, dropout_rate):
        return ForwardInstance("window", d, nk, nq, 1,
                               "on" if dropout_rate > 0.0 else "off", False)
    body = _body("flash_attention", dtype, d, MMA_HEAD_DIMS,
                 body or _short_rows_body(dtype, d, nq, nk), wgmma="mma")
    if body == "wgmma":
        if dtype == torch.float32:
            rows, block_k = TF32_WGMMA_ROWS[d], TF32_TILE
        else:
            rows = 192 if d in NARROW_HEAD_DIMS else 128
            block_k = 64 if d == 32 else 128
        return ForwardInstance(body, d, block_k, rows, -(-nq // rows),
                               "on" if dropout_rate > 0.0 else "off",
                               nk % block_k != 0)
    if body == "mma":
        block_k = 32 if dtype == torch.float32 and d > 32 else 64
        rows = 128 if d == 16 else 64
    else:
        block_k, rows = 64 if d <= 16 else 32, 128
    if d == 16:
        dropout, ragged = "on" if dropout_rate > 0.0 else "off", nk % block_k != 0
    else:
        dropout, ragged = "runtime", True
    return ForwardInstance(body, d, block_k, rows, -(-nq // rows), dropout,
                           ragged)


def forward_kernel(q, k, v, bias, *, dropout_rate: float = 0.0, seed: int = 0,
                   q_offset: int = 0, row_offset: int = 0,
                   body: str | None = None):
    """One launch of the K2 forward kernel on CUDA tensors, without autograd:
    (o, lse). `body` as in `forward_instance`. Counts the launch."""
    scale, drop = _check_kernel_inputs("flash_attention", (q, k, v, bias),
                                       dropout_rate)
    b, h, nq, d = q.shape
    inst = forward_instance(q.dtype, d, nq, k.shape[2], dropout_rate, body)
    if inst.body != "simt" and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: the tensor-core kernel copies 16 "
                         "bytes at a time; q, k, v must be aligned to that")
    global launches, shard_launches, wgmma_launches, narrow_launches
    global tf32_wgmma_launches, window_launches
    if inst.body == "window":
        o = torch.empty_like(q)
        lse = torch.empty(b * h, nq, device=q.device, dtype=torch.float32)
        err = _build.library().lunaris_k2_window_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            o.data_ptr(), lse.data_ptr(), b * h, h, nq, d,
            int(q.dtype == torch.bfloat16), scale, *drop, seed & _M32,
            q_offset, row_offset,
            torch.cuda.current_stream(q.device).cuda_stream)
        _build.check(err, "flash_attention (window)")
        launches += 1
        shard_launches += q_offset > 0
        window_launches += 1
        return o, lse
    f32_wg = inst.body == "wgmma" and q.dtype == torch.float32
    split = tf32_tiles(TF32_FWD, k, v) if f32_wg else None
    o = torch.empty_like(q)
    lse = torch.empty(b * h, nq, device=q.device, dtype=torch.float32)
    err = _build.library().lunaris_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
        o.data_ptr(), lse.data_ptr(), b * h, h, nq, k.shape[2], d, scale,
        *drop, seed & _M32, q_offset, row_offset,
        int(q.dtype == torch.bfloat16), FWD_BODIES.index(inst.body),
        None if split is None else split.data_ptr(),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention")
    launches += 1
    shard_launches += q_offset > 0
    wgmma_launches += inst.body == "wgmma"
    narrow_launches += (inst.body == "wgmma" and d in NARROW_HEAD_DIMS
                        and not f32_wg)
    tf32_wgmma_launches += f32_wg
    return o, lse


DKV, DKV_FUSED_DQ, DQ = 0, 1, 2      # the C entry point's kernel ids


class BackwardInstance(NamedTuple):
    """The dk/dv and dq kernel instances a split backward launches. dk/dv:
    a block owns `dkv_rows` keys and walks the queries in tiles of
    `dkv_block_q`; dq: a block owns `dq_rows` queries and walks the keys in
    tiles of `dq_block_k`."""
    body: str            # "mma" (tensor cores) or "simt" (CUDA cores)
    head_dim: int
    dkv_block_q: int
    dkv_rows: int
    dkv_blocks: int      # blocks along Nk (the last one guards its keys)
    dq_block_k: int
    dq_rows: int
    dq_blocks: int       # blocks along Nq (the last one guards its rows)
    dropout: str         # "off" / "on": compiled in; "runtime": a flag
    dkv_ragged: bool     # dk/dv's instance fills the last query tile
    dq_ragged: bool      # dq's instance fills the last key tile


def backward_instance(dtype: torch.dtype, d: int, nq: int, nk: int,
                      dropout_rate: float,
                      body: str | None = None) -> BackwardInstance:
    """Which dk/dv and dq instances (dtype, d, Nq, Nk, dropout) take: the
    rule of the C dispatch (`csrc/flash_attention_bwd*.cu`), as a pure
    function.

    bf16 at d 16, 32, 48, 64 takes the tensor-core bodies, everything else
    (f32 at every head size) the CUDA-core bodies (`body` as in `_body`).
    On the tensor cores at d 16
    dropout and the raggedness of the walked operand (Nq for dk/dv, Nk for
    dq) are template parameters; the other head sizes, and the CUDA-core
    bodies at every head size, have one instance each, which fills the last
    tile and reads the dropout flag at run time. The fused variant's rule is
    `fused_instance`."""
    body = _body("flash_attention_bwd", dtype, d, MMA_BWD_HEAD_DIMS, body,
                 f32=False)
    tile, rows = _bwd_tile_rows(body, d)
    if body == "mma" and d == 16:
        dropout = "on" if dropout_rate > 0.0 else "off"
        dkv_ragged, dq_ragged = nq % tile != 0, nk % tile != 0
    else:
        dropout, dkv_ragged, dq_ragged = "runtime", True, True
    return BackwardInstance(body, d, tile, rows, -(-nk // rows), tile, rows,
                            -(-nq // rows), dropout, dkv_ragged, dq_ragged)


def _bwd_tile_rows(body: str, d: int) -> tuple[int, int]:
    """(rows of the walked operand a tile, rows a block owns) of a backward
    body at head size d."""
    if body == "mma":
        return 64, 128 if d == 16 else 64
    return 32, 128 if d <= 16 else 32


class FusedInstance(NamedTuple):
    """The kernel instance a fused backward launches: a block owns `rows`
    keys, walks the queries in tiles of `block_q` (each block from its own
    first tile) and adds each tile's dq into a zeroed f32 buffer (the
    window body: a warpgroup owns a window's W keys and W queries and
    writes dq itself)."""
    body: str            # "window", "wgmma", "mma" (tensor cores) or "simt"
    head_dim: int
    block_q: int
    rows: int
    blocks: int          # blocks along Nk (the last one guards its keys)
    dropout: str         # "off" / "on": compiled in; "runtime": a flag
    ragged: bool         # the instance fills the last query tile


def fused_instance(dtype: torch.dtype, d: int, nq: int, nk: int,
                   dropout_rate: float,
                   body: str | None = None) -> FusedInstance:
    """Which fused backward instance (dtype, d, Nq, Nk, dropout) takes: the
    rule of the C dispatch, as a pure function.

    bf16 at d 48 and 64 takes the warpgroup body ("wgmma": 128 keys a
    block, query tiles of 64, dropout compiled in or out, every Nq in one
    instance); `body="simt"` reaches the CUDA-core body it replaced there.
    bf16 at d 16 and 32 takes the narrow warpgroup body ("wgmma": 192
    keys a block, query tiles of 64) where Nq and Nk are both at least
    NARROW_MIN_ROWS[d], else the mma.sync body, which `body="mma"` reaches
    at every shape. f32 at d 16 and 32 takes its own warpgroup body
    ("wgmma": TF32_WGMMA_BWD_KEYS[d] keys a block, query tiles of 64 from
    the pre-pass, at d 32 in sub-tiles of 16) where Nq and Nk are both at
    least TF32_WGMMA_BWD_MIN_ROWS[d], else the mma.sync body, which
    `body="mma"` reaches at every shape; f32 at d 48 and 64 the same body
    at its width ("wgmma": 64 keys a block, query tiles of 64 in sub-tiles
    of 16) at every shape (TF32_WGMMA_BWD_MIN_ROWS[d] is 0: the CUDA-core
    body it replaced, which `body="simt"` reaches, loses at every N).
    d 16 and 32 take the tensor-core body of their type (bf16: the dk/dv
    body with a fifth product, dq; f32: its own body, five products in
    three TF32 passes), d 8 the CUDA-core body.
    `body` as in `_body`. On the tensor cores a block owns 256 keys in bf16
    at d 16 (8 warps), 64 otherwise; f32 walks the queries in tiles of 64
    at d 16 and 32 at d 32; at d 16 dropout and a ragged Nq are template
    parameters; every other instance of those bodies fills the last query
    tile and reads the dropout flag at run time. Ahead of all that, bf16 at
    d 16 and 32 on Nq = Nk = W (`window_shape`) takes the window body
    ("window": W keys and W queries in one warpgroup, dropout compiled in
    or out), and f32 there by `body="window"` (three TF32 passes, split in
    the kernel; `window_default`); `body="mma"` still reaches the mma.sync
    body each replaced."""
    if _window_body("flash_attention_bwd", dtype, d, nq, nk, body,
                    dropout_rate, backward=True):
        return FusedInstance("window", d, nq, nk, 1,
                             "on" if dropout_rate > 0.0 else "off", False)
    body = _body("flash_attention_bwd", dtype, d, MMA_FUSED_HEAD_DIMS,
                 body or _short_rows_body(dtype, d, nq, nk, backward=True),
                 wgmma="mma" if d in NARROW_HEAD_DIMS else "simt")
    if body == "wgmma":
        rows = (TF32_WGMMA_BWD_KEYS[d] if dtype == torch.float32
                else 192 if d in NARROW_HEAD_DIMS else 128)
        return FusedInstance(body, d, 64, rows, -(-nk // rows),
                             "on" if dropout_rate > 0.0 else "off",
                             nq % 64 != 0)
    tile, rows = _bwd_tile_rows(body, d)
    if body == "mma" and dtype == torch.float32:
        tile, rows = (64 if d == 16 else 32), 64
    if body == "mma" and d == 16:
        if dtype == torch.bfloat16:
            rows = 256       # 8 warps: half the dq reductions (PERF.md)
        dropout = "on" if dropout_rate > 0.0 else "off"
        ragged = nq % tile != 0
    else:
        dropout, ragged = "runtime", True
    return FusedInstance(body, d, tile, rows, -(-nk // rows), dropout, ragged)


def launch_bwd_kernel(kernel: int, q, k, v, bias, do, lse, delta, *,
                      dq=None, dk=None, dv=None, dbias_bh=None, dq_acc=None,
                      o=None, dropout_rate=0.0, seed=0, q_offset=0,
                      row_offset=0, body: str | None = None):
    """One launch of a K2 backward kernel into preallocated outputs:
    DKV writes dk, dv, dbias_bh [B*H, Nk]; DKV_FUSED_DQ also adds into the
    zeroed f32 dq_acc [B, H, Nq, d]; DQ writes dq. delta [B, H, Nq] f32 is
    rowsum(f32(o) f32(dO)). `body` as in `backward_instance` (DKV and DQ)
    and `fused_instance` (DKV_FUSED_DQ). The window body (DKV_FUSED_DQ on a
    window shape) takes o instead of delta, which it forms itself, and
    writes dq (d^-1/2 applied) instead of adding into dq_acc. Counts the
    launch."""
    b, h, nq, d = q.shape
    rule = fused_instance if kernel == DKV_FUSED_DQ else backward_instance
    body = rule(q.dtype, d, nq, k.shape[2], dropout_rate, body).body
    window = body == "window"
    inputs = (q, k, v, bias, do, lse) + ((o,) if window else (delta,))
    if any(t is None for t in inputs):
        raise ValueError("flash_attention_bwd: the window body takes o, the "
                         "others delta")
    scale, drop = _check_kernel_inputs("flash_attention_bwd", inputs,
                                       dropout_rate)
    if do.dtype != q.dtype or lse.dtype != torch.float32 or (
            inputs[-1].dtype != (q.dtype if window else torch.float32)):
        raise ValueError("flash_attention_bwd: dO (and o) must have q's "
                         "dtype and lse, delta must be f32")
    f32_wg = body == "wgmma" and q.dtype == torch.float32
    outs = {DKV: (dk, dv, dbias_bh),
            DKV_FUSED_DQ: (dq, dk, dv, dbias_bh) if window
            else (dk, dv, dbias_bh, dq_acc), DQ: (dq,)}[kernel]
    if any(t is None or t.device != q.device or not t.is_contiguous()
           for t in outs):
        raise ValueError(f"flash_attention_bwd: kernel {kernel} needs "
                         "contiguous outputs on q's device")
    if body != "simt" and any(t.data_ptr() % 16 for t in (q, k, v, do)
                              + inputs[6:] * window):
        raise ValueError("flash_attention_bwd: the tensor-core kernels copy "
                         "16 bytes at a time; q, k, v, dO (and o) must be "
                         "aligned to that")
    global bwd_fused_launches, bwd_dkv_launches, bwd_dq_launches
    global bwd_shard_launches, bwd_wgmma_launches, bwd_narrow_launches
    global bwd_tf32_wgmma_launches, bwd_window_launches
    ptr = lambda t: None if t is None else t.data_ptr()
    if window:
        err = _build.library().lunaris_k2_window_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            o.data_ptr(), do.data_ptr(), lse.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), dbias_bh.data_ptr(), b * h, h, nq,
            d, int(q.dtype == torch.bfloat16), scale, *drop, seed & _M32,
            q_offset, row_offset,
            torch.cuda.current_stream(q.device).cuda_stream)
        _build.check(err, "flash_attention_bwd (window)")
        bwd_shard_launches += q_offset > 0
        bwd_window_launches += 1
        bwd_fused_launches += 1
        return
    split = None
    if f32_wg:
        # The pre-pass's query tiles, then its key tiles, in one buffer.
        nk = k.shape[2]
        sizes = [b * h * tf32_tile_count(m, n) * tf32_tile_bytes(m, d) // 4
                 for m, n in ((TF32_BWD_Q, nq), (TF32_BWD_K, nk))]
        split = torch.empty(sum(sizes), dtype=torch.float32, device=q.device)
        tf32_tiles(TF32_BWD_Q, q, do, lse, delta, scale,
                   out=split[:sizes[0]].view(
                       b * h, tf32_tile_count(TF32_BWD_Q, nq), -1))
        tf32_tiles(TF32_BWD_K, k, v, out=split[sizes[0]:].view(
            b * h, tf32_tile_count(TF32_BWD_K, nk), -1))
    err = _build.library().lunaris_flash_attention_bwd(
        kernel, q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(), ptr(dq), ptr(dk),
        ptr(dv), ptr(dbias_bh), ptr(dq_acc), b * h, h, nq, k.shape[2], d,
        scale, *drop, seed & _M32, q_offset, row_offset,
        int(q.dtype == torch.bfloat16), FWD_BODIES.index(body), ptr(split),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention_bwd")
    bwd_shard_launches += q_offset > 0
    bwd_wgmma_launches += body == "wgmma"
    bwd_narrow_launches += (body == "wgmma" and d in NARROW_HEAD_DIMS
                            and not f32_wg)
    bwd_tf32_wgmma_launches += f32_wg
    if kernel == DKV_FUSED_DQ:
        bwd_fused_launches += 1
    elif kernel == DKV:
        bwd_dkv_launches += 1
    else:
        bwd_dq_launches += 1


def flash_attention_bwd(q, k, v, bias, o, lse, do, *, dropout_rate=0.0,
                        seed=0, q_offset=0, row_offset=0, variant=None,
                        body: str | None = None):
    """The K2 backward kernels on CUDA tensors (the arguments of
    `attention_bwd_plain`, contiguous). variant: "fused" or "split" (see
    the module docstring); None takes `default_bwd`. `body` picks the fused
    variant's body as in `fused_instance` (measurements time the window
    body's call against the mma.sync one's). The window body is one launch:
    delta and dq are the kernel's; every other body takes delta from a
    PyTorch pass and, fused, dq from a zeroed f32 buffer cast and scaled
    after it. Returns (dq, dk, dv, dbias [H, Nk] f32)."""
    variant = variant or default_bwd(q.dtype, q.shape[3])
    if variant not in BWD_VARIANTS:
        raise ValueError(f"flash_attention_bwd: variant {variant!r} not in "
                         f"{BWD_VARIANTS}")
    if o.shape != q.shape or o.dtype != q.dtype:
        raise ValueError("flash_attention_bwd: o must match q")
    b, h, nq, d = q.shape
    nk = k.shape[2]
    out = dict(dk=torch.empty_like(k), dv=torch.empty_like(v),
               dbias_bh=torch.empty(b * h, nk, device=q.device,
                                    dtype=torch.float32))
    kw = dict(dropout_rate=dropout_rate, seed=seed, q_offset=q_offset,
              row_offset=row_offset)
    fused = variant == "fused"
    if fused and fused_instance(q.dtype, d, nq, nk, dropout_rate,
                                body).body == "window":
        dq = torch.empty_like(q)
        launch_bwd_kernel(DKV_FUSED_DQ, q, k, v, bias, do, lse, None, o=o,
                          dq=dq, body="window", **out, **kw)
        return dq, out["dk"], out["dv"], out["dbias_bh"].reshape(
            b, h, nk).sum(dim=0)
    if body is not None and not fused:
        raise ValueError("flash_attention_bwd: `body` picks the fused "
                         "variant's body")
    delta = (o.float() * do.float()).sum(-1)
    if fused:
        out["dq_acc"] = torch.zeros(b, h, nq, d, device=q.device,
                                    dtype=torch.float32)
        launch_bwd_kernel(DKV_FUSED_DQ, q, k, v, bias, do, lse, delta,
                          body=body, **out, **kw)
        scale = torch.tensor(d ** -0.5, dtype=q.dtype, device=q.device)
        dq = out["dq_acc"].to(q.dtype) * scale
    else:
        dq = torch.empty_like(q)
        launch_bwd_kernel(DKV, q, k, v, bias, do, lse, delta, **out, **kw)
        launch_bwd_kernel(DQ, q, k, v, bias, do, lse, delta, dq=dq, **kw)
    dbias = out["dbias_bh"].reshape(b, h, nk).sum(dim=0)
    return dq, out["dk"], out["dv"], dbias


class _FlashAttention(torch.autograd.Function):
    """o, lse = K2(q, k, v, bias); gradients to q, k, v and bias."""

    @staticmethod
    def forward(ctx, q, k, v, bias, dropout_rate, seed, q_offset, row_offset,
                bwd):
        if dropout_rate == 0.0:
            o, lse = torch.ops.lunaris_orion.flash_attention_fwd.default(
                q, k, v, bias, q_offset, row_offset)
        elif q.device.type == "cpu":
            o, lse = attention_plain(q, k, v, bias, dropout_rate=dropout_rate,
                                     seed=seed, q_offset=q_offset,
                                     row_offset=row_offset)
        else:
            o, lse = forward_kernel(q, k, v, bias, dropout_rate=dropout_rate,
                                    seed=seed, q_offset=q_offset,
                                    row_offset=row_offset)
        ctx.save_for_backward(q, k, v, bias, o, lse)
        ctx.args = dict(dropout_rate=dropout_rate, seed=seed,
                        q_offset=q_offset, row_offset=row_offset)
        ctx.bwd = bwd
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, bias, o, lse = ctx.saved_tensors
        do = do.contiguous()
        if q.device.type == "cpu":
            grads = attention_bwd_plain(q, k, v, bias, o, lse, do, **ctx.args)
        else:
            grads = flash_attention_bwd(q, k, v, bias, o, lse, do,
                                        variant=ctx.bwd, **ctx.args)
        return (*grads, None, None, None, None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: torch.Tensor, *, dropout_rate: float = 0.0,
                    seed: int = 0, q_offset: int = 0, row_offset: int = 0,
                    bwd: str | None = None):
    """K2 with its backward. q [B, H, Nq, d], k/v [B, H, Nk, d] (contiguous,
    f32 or bf16, one dtype), bias [H, Nk] f32. `seed` is an int32 value;
    `q_offset` is the absolute position of q's first row and `row_offset`
    that of the first B*H row, as seen by the dropout hash (both 0 for the
    square single-device call). `bwd` picks the backward kernels on CUDA
    ("fused" or "split"; None: `default_bwd`). Returns (o [B, H, Nq, d],
    lse [B*H, Nq]); o is differentiable in q, k, v and bias. At dropout 0
    with no gradient to record it calls the operator alone."""
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if bwd is not None and bwd not in BWD_VARIANTS:
        raise ValueError(f"flash_attention: bwd {bwd!r} not in {BWD_VARIANTS}")
    if dropout_rate == 0.0 and not (torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v, bias))):
        return torch.ops.lunaris_orion.flash_attention_fwd.default(
            q, k, v, bias, q_offset, row_offset)
    return _FlashAttention.apply(q, k, v, bias, dropout_rate, seed, q_offset,
                                 row_offset, bwd)
