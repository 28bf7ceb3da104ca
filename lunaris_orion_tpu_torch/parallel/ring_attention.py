"""Context parallelism over a process group: the teacher attention's tokens
split over the ranks of one mesh axis (counterpart:
lunaris_orion_tpu/parallel/ring_attention.py).

Each rank holds a shard of N/p tokens of q, k, v and the per-key bias and
computes its q shard's attention over all N keys, in one of two ways:

  * `ring_attention` rotates the k/v/bias chunks around the ring with
    `ppermute` and folds each into an online-softmax carry in plain torch
    (`_accum_chunk`). The JAX ring is XLA ops, not a Pallas kernel, so
    plain torch is its counterpart. Each block of keys is checkpointed
    (recomputed in the backward, as `jax.checkpoint` does), so memory
    stays O(B H N/p d); the gradient flows through `ppermute`'s backward,
    the inverse rotation.
  * `allgather_attention` all-gathers k, v and the bias once a call and
    runs K2 (`ops/cuda/flash_attention.py`) on the q shard against all
    keys, with the shard's absolute `q_offset`: the kernels on a card,
    their plain twins on the CPU. The all-gather's backward is a
    reduce-scatter of K2's dk, dv and dbias.

Dropout is K2's hash over (seed, absolute row b*H + h, absolute key,
absolute query), so every shard draws the masks the single-device call
draws: `b0` is the shard's first global batch row when the batch is
itself split over a data axis.

`ring_attention_sharded` is the global view: q, k, v [B, H, N, d] and bias
[H, N] that every rank of the axis holds whole enter through
`split_entry` and the output leaves through `gather_exit`
(parallel/collectives.py), so every gradient that leaves the region is
whole and the same on every rank of the axis.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from lunaris_orion_tpu_torch.ops.cuda import flash_attention as k2
from lunaris_orion_tpu_torch.parallel.collectives import (
    all_gather_tiled, gather_exit, ppermute, split_entry)
from lunaris_orion_tpu_torch.parallel.mesh import AxisGroup

MODES = ("ring", "allgather")


def _int32(x):
    """The int32 with the bits of a uint32 value (an int or an int64
    tensor in [0, 2**32))."""
    if isinstance(x, int):
        return x - 2**32 if x >= 2**31 else x
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def keep_mask_qk(row_seed: torch.Tensor, q0: int, k0: int, nq: int, nk: int,
                 keep_prob: float) -> torch.Tensor:
    """[B, H, nq, nk] boolean keep-mask of the queries q0.. against the keys
    k0.. (absolute positions), bit-identical to K2's (`_keep_mask_qk`).
    row_seed: [B, H, 1, 1] from `row_seed_bh`.

    The hash of K2's `keep_mask`, taken as the JAX package takes it: int32
    arithmetic that wraps (two's complement, as XLA's and the card's), a
    logical shift by masking, and the unsigned compare by flipping the sign
    bit; the [nq, nk] part that depends on no row is formed once. A quarter
    of the int64 form's memory traffic over the [B, H, nq, nk] tiles."""
    dev = row_seed.device
    k_abs = torch.arange(k0, k0 + nk, device=dev, dtype=torch.int64)
    q_abs = torch.arange(q0, q0 + nq, device=dev, dtype=torch.int64)[:, None]
    kq = _int32((k2._mul32(k_abs, k2.C2) + k2._mul32(q_abs, k2.C3))
                & k2._M32)
    h = _int32(row_seed) + kq
    h = h ^ ((h >> 15) & 0x1FFFF)
    h = h * _int32(k2.C2)
    flip = torch.iinfo(torch.int32).min
    return (h ^ flip) < _int32(k2.dropout_threshold(keep_prob) ^ 2**31)


def row_seed_bh(seed: int, b: int, h: int, b0: int = 0,
                device=None) -> torch.Tensor:
    """[B, H, 1, 1] per-(batch, head) hash seed, seed ^ (row * C1) with
    row = (b0 + b) * H + h (`_row_seed_bh`)."""
    return k2.row_seeds(seed, b * h, b0 * h, device).reshape(b, h, 1, 1)


def _sub_step(acc, m, l, q32, k_blk, v_blk, bias_blk, q0: int, k0: int,
              scale: float, dropout_rate: float, row_seed):
    """One block of keys folded into the carry (acc, m, l)."""
    s = torch.matmul(q32, k_blk.float().transpose(-1, -2)) * scale
    if bias_blk is not None:
        s = s + bias_blk.float()[None, :, None, :]
    m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
    p = torch.exp(s - m_new)
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(dim=-1, keepdim=True)
    if dropout_rate > 0.0 and row_seed is not None:
        keep = keep_mask_qk(row_seed, q0, k0, q32.shape[2], k_blk.shape[2],
                            1.0 - dropout_rate)
        p = torch.where(keep, p / (1.0 - dropout_rate), torch.zeros_like(p))
    acc_new = acc * corr + torch.matmul(p, v_blk.float())
    return acc_new, m_new, l_new


def _accum_chunk(acc, m, l, q32, k_chunk, v_chunk, bias_chunk, *, q0: int,
                 k0: int, scale: float, block_k: int, dropout_rate: float,
                 row_seed: Optional[torch.Tensor]):
    """Fold one k/v chunk [B, H, nc, d] (bias [H, nc] or None) into the
    online-softmax carry, in blocks of at most `block_k` keys (the largest
    divisor of nc up to it), each checkpointed: score tiles stay
    [B, H, nl, block_k] and are recomputed in the backward."""
    nc = k_chunk.shape[2]
    bk = min(block_k, nc)
    while nc % bk:
        bk -= 1
    grad = torch.is_grad_enabled()
    for j in range(0, nc, bk):
        args = (acc, m, l, q32, k_chunk[:, :, j:j + bk], v_chunk[:, :, j:j + bk],
                None if bias_chunk is None else bias_chunk[:, j:j + bk],
                q0, k0 + j, scale, dropout_rate, row_seed)
        acc, m, l = (checkpoint(_sub_step, *args, use_reentrant=False)
                     if grad else _sub_step(*args))
    return acc, m, l


def _carry(q: torch.Tensor):
    b, h, nl, d = q.shape
    dev = q.device
    return (torch.zeros(b, h, nl, d, device=dev),
            torch.full((b, h, nl, 1), -torch.inf, device=dev),
            torch.zeros(b, h, nl, 1, device=dev))


def _row_seed(q, dropout_rate, seed, b0):
    if dropout_rate > 0.0 and seed is not None:
        return row_seed_bh(seed, q.shape[0], q.shape[1], b0, q.device)
    return None


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   bias: Optional[torch.Tensor], *, axis: AxisGroup,
                   dropout_rate: float = 0.0, seed: Optional[int] = None,
                   block_k: int = 512, b0: int = 0) -> torch.Tensor:
    """The per-shard ring body. q, k, v [B, H, N/p, d]: this rank's shard of
    the token axis; bias [H, N/p] or None. Returns the local output shard
    of softmax(q k_full^T d^-1/2 + bias_full) v_full, with K2's hash
    dropout at `dropout_rate` when `seed` (an int32 value) is given."""
    p, idx = axis.size, axis.index
    b, h, nl, d = q.shape
    q32 = q.float()
    row_seed = _row_seed(q, dropout_rate, seed, b0)
    acc, m, l = _carry(q)
    # Receive from the right: after s steps rank i holds the chunk that
    # started on rank (i + s) % p.
    perm = [((i + 1) % p, i) for i in range(p)]
    kc, vc, bc, src = k, v, bias, idx
    for s in range(p):
        acc, m, l = _accum_chunk(
            acc, m, l, q32, kc, vc, bc, q0=idx * nl, k0=src * nl,
            scale=d ** -0.5, block_k=block_k, dropout_rate=dropout_rate,
            row_seed=row_seed)
        if s + 1 < p:
            kc, vc = ppermute(kc, axis, perm), ppermute(vc, axis, perm)
            if bc is not None:
                bc = ppermute(bc, axis, perm)
            src = (src + 1) % p
    return (acc / torch.clamp(l, min=1e-30)).to(q.dtype)


def allgather_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        bias: Optional[torch.Tensor], *, axis: AxisGroup,
                        dropout_rate: float = 0.0, seed: Optional[int] = None,
                        block_k: int = 512, b0: int = 0,
                        use_kernel: bool = True,
                        bwd: Optional[str] = None) -> torch.Tensor:
    """The per-shard allgather body, with `ring_attention`'s contract: k, v
    and the bias gathered once, then K2 on (this q shard x all keys) at
    q_offset = index * N/p and row_offset = b0 * H (the kernel on a CUDA
    tensor, which launches or raises; its plain twin on a CPU tensor).
    `use_kernel` False folds the gathered keys with `_accum_chunk` instead
    (no kernel: `--no-use_pallas`). `bwd` picks K2's backward on a card."""
    b, h, nl, d = q.shape
    n = nl * axis.size
    if seed is None:
        dropout_rate = 0.0
    k_full = all_gather_tiled(k, axis, 2)
    v_full = all_gather_tiled(v, axis, 2)
    bias_full = None if bias is None else all_gather_tiled(bias, axis, 1)
    q0 = axis.index * nl
    if use_kernel:
        if bias_full is None:
            bias_full = torch.zeros(h, n, device=q.device)
        out, _ = k2.flash_attention(
            q.contiguous(), k_full.contiguous(), v_full.contiguous(),
            bias_full.float().contiguous(), dropout_rate=dropout_rate,
            seed=0 if seed is None else seed, q_offset=q0, row_offset=b0 * h,
            bwd=bwd)
        return out
    acc, m, l = _carry(q)
    acc, _, l = _accum_chunk(
        acc, m, l, q.float(), k_full, v_full, bias_full, q0=q0, k0=0,
        scale=d ** -0.5, block_k=block_k, dropout_rate=dropout_rate,
        row_seed=_row_seed(q, dropout_rate, seed, b0))
    return (acc / torch.clamp(l, min=1e-30)).to(q.dtype)


def ring_attention_sharded(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           bias: Optional[torch.Tensor], *, axis: AxisGroup,
                           dropout_rate: float = 0.0,
                           seed: Optional[int] = None, block_k: int = 512,
                           b0: int = 0, mode: str = "ring",
                           use_kernel: bool = True,
                           bwd: Optional[str] = None) -> torch.Tensor:
    """Context-parallel attention on the global view: q, k, v [B, H, N, d]
    and bias [H, N] (or None), the same on every rank of `axis`, split on
    the token axis, run by `mode` ('ring' or 'allgather'), and gathered
    back: returns [B, H, N, d] on every rank. `b0`: the first global batch
    row of these B rows (the batch's data-axis shard)."""
    if mode not in MODES:
        raise ValueError(f"mode must be 'ring' or 'allgather', got {mode!r}")
    n = q.shape[2]
    if n % axis.size:
        raise ValueError(f"N={n} not divisible by the axis size {axis.size}")
    qs, ks, vs = (split_entry(t, axis, 2) for t in (q, k, v))
    bs = None if bias is None else split_entry(bias, axis, 1)
    kw = dict(axis=axis, dropout_rate=dropout_rate, seed=seed,
              block_k=block_k, b0=b0)
    if mode == "ring":
        out = ring_attention(qs, ks, vs, bs, **kw)
    else:
        out = allgather_attention(qs, ks, vs, bs, use_kernel=use_kernel,
                                  bwd=bwd, **kw)
    return gather_exit(out, axis, 2)
