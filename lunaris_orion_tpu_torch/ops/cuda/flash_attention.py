"""K2 -- flash attention with a per-key bias and hash dropout, forward and
backward.

`flash_attention` is a `torch.autograd.Function`. It sends tensors on the
CPU to the plain versions (`attention_plain`, `attention_bwd_plain`) and
tensors on a CUDA device to the hand-written kernels; it raises on any
other device and never falls back.
  forward   `csrc/flash_attention_fwd.cuh` (instances and entry point in
            `csrc/flash_attention_fwd*.cu`), replacing lunaris_orion_tpu/ops/
            pallas/flash_attention.py `_fwd_kernel`; returns the row
            log-sum-exp as well, which the backward needs. Two hand-written
            bodies, chosen by type and head size (`forward_instance`):
            "mma"   bf16 at d 16, 32, 48, 64: both products on the tensor
                    cores (mma.sync m16n8k16), p kept in registers between
                    them;
            "simt"  f32 at every head size (TF32 would cost three decimal
                    digits) and bf16 at d 8, on the CUDA cores.
            At d 16 dropout and a ragged Nk are compiled in (four instances
            a body); the other head sizes test both at run time.
  backward  `csrc/flash_attention_bwd.cuh` (instances and entry point in
            `csrc/flash_attention_bwd*.cu`), in one of two variants:
            "fused"  one dk/dv kernel that also adds dq into an f32 buffer
                     with 16-byte atomic reductions (replaces
                     `_bwd_fused_kernel`), so scores, exp and mask are
                     computed once; its dq varies from run to run in the
                     last bits (`fused_instance`): "mma" for bf16 at d 16
                     and 32 (five products on the tensor cores), "simt"
                     for f32, bf16 d 8, 48 and 64;
            "split"  the dk/dv kernel and a dq kernel (replace
                     `_bwd_dkv_kernel` and `_bwd_dq_kernel`), each with the
                     forward's two bodies (`backward_instance`): "mma" for
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

`launches`, `bwd_fused_launches`, `bwd_dkv_launches` and `bwd_dq_launches`
count the kernel launches; the plain versions do not count.
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

HEAD_DIMS = (8, 16, 32, 48, 64)      # the kernels' compiled head sizes
MMA_HEAD_DIMS = (16, 32, 48, 64)     # those of the tensor-core body (bf16)
MMA_BWD_HEAD_DIMS = (16, 32, 48, 64) # those of the backward's (dk/dv, dq)
MMA_FUSED_HEAD_DIMS = (16, 32)       # those of the fused backward's
FWD_BODIES = ("simt", "mma")         # the C entry points' `body` argument
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
    key tile. Returns (o [B, H, Nq, d] in q's dtype, lse [B*H, Nq] f32)."""
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
    dq carries the d^-1/2 factor of the scaling inside the forward.
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


BWD_VARIANTS = ("fused", "split")


def default_bwd(dtype: torch.dtype, d: int) -> str:
    """The backward variant a call takes when it names none: the one measured
    faster in turns on an H100 80GB HBM3 at 700 W (`chip_smoke.py` phase 7;
    PERF.md section 6). "fused" where one pass's saving, scores, exp and
    mask computed once for all three gradients, outweighs adding dq across
    key blocks: on the tensor cores (bf16 at d 16 and 32), and on the CUDA
    cores where four threads share a row (f32 at d 32, 48, 64), whose dot
    products the dq kernel would repeat with shuffles. "split" elsewhere:
    on the CUDA cores at one thread a row (f32 at d 8 and 16, bf16 at d 8;
    f32 at d 16: 249.1 against 259.1 ms), and at bf16 d 48 and 64, where
    only split has tensor-core kernels."""
    if dtype == torch.bfloat16:
        return "fused" if d in MMA_FUSED_HEAD_DIMS else "split"
    return "fused" if d > 16 else "split"


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
    if b * h > 65535 or not 0 <= dropout_rate < 1.0:
        raise ValueError(f"{name}: B*H must be <= 65535 and "
                         "0 <= dropout_rate < 1")
    use_drop = dropout_rate > 0.0
    scale = float(torch.tensor(d ** -0.5, dtype=q.dtype))
    return scale, (int(use_drop),
                   dropout_threshold(1.0 - dropout_rate) if use_drop else 0,
                   _inv_keep(dropout_rate) if use_drop else 1.0)


def _body(name: str, dtype: torch.dtype, d: int, mma_dims: tuple,
          body: str | None) -> str:
    """The body a call of `name` takes: the tensor cores ("mma") for bf16 at
    the head sizes `mma_dims`, the CUDA cores ("simt") otherwise. `body`
    "simt" reaches the CUDA-core kernel at bf16 d 16, where the tensor-core
    one is the default: measurements and tests compare the two; the
    autograd path never passes it."""
    if dtype not in (torch.float32, torch.bfloat16) or d not in HEAD_DIMS:
        raise ValueError(f"{name}: no kernel for {dtype}, head dim {d} (f32 "
                         f"or bf16, {SUPPORTED})")
    default = ("mma" if dtype == torch.bfloat16 and d in mma_dims
               else "simt")
    body = body or default
    if body not in FWD_BODIES or (body != default and (
            body == "mma" or d != 16)):
        raise ValueError(f"{name}: body {body!r} does not take {dtype} at "
                         f"head dim {d} (tensor cores: bf16 at d in "
                         f"{mma_dims})")
    return body


class ForwardInstance(NamedTuple):
    """The forward kernel instance a call launches."""
    body: str            # "mma" (tensor cores) or "simt" (CUDA cores)
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

    bf16 at d 16, 32, 48, 64 takes the tensor-core body, everything else the
    CUDA-core body (`body` as in `_body`). At d 16 dropout and raggedness are
    template parameters; the other head sizes have one instance each, which
    masks the last key tile and reads the dropout flag at run time. Nq only
    sets the grid: every instance guards the rows past it."""
    body = _body("flash_attention", dtype, d, MMA_HEAD_DIMS, body)
    if body == "mma":
        block_k, rows = 64, 128 if d == 16 else 64
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
    if inst.body == "mma" and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: the tensor-core kernel copies 16 "
                         "bytes at a time; q, k, v must be aligned to that")
    o = torch.empty_like(q)
    lse = torch.empty(b * h, nq, device=q.device, dtype=torch.float32)
    err = _build.library().lunaris_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
        o.data_ptr(), lse.data_ptr(), b * h, h, nq, k.shape[2], d, scale,
        *drop, seed & _M32, q_offset, row_offset,
        int(q.dtype == torch.bfloat16), FWD_BODIES.index(inst.body),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention")
    global launches
    launches += 1
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
    the CUDA-core bodies (`body` as in `_body`). On the tensor cores at d 16
    dropout and the raggedness of the walked operand (Nq for dk/dv, Nk for
    dq) are template parameters; the other head sizes, and the CUDA-core
    bodies at every head size, have one instance each, which fills the last
    tile and reads the dropout flag at run time. The fused variant's rule is
    `fused_instance`."""
    body = _body("flash_attention_bwd", dtype, d, MMA_BWD_HEAD_DIMS, body)
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
    first tile) and adds each tile's dq into a zeroed f32 buffer."""
    body: str            # "mma" (tensor cores) or "simt" (CUDA cores)
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

    bf16 at d 16 and 32 takes the tensor-core body (the dk/dv body with a
    fifth product, dq), everything else the CUDA-core body: at d 48 and 64
    the dk/dv body alone fills the registers. `body` as in `_body`. On the
    tensor cores a block owns 256 keys at d 16 (8 warps) and 64 at d 32;
    at d 16 dropout and a ragged Nq are template parameters; every other
    instance fills the last query tile and reads the dropout flag at run
    time."""
    body = _body("flash_attention_bwd", dtype, d, MMA_FUSED_HEAD_DIMS, body)
    tile, rows = _bwd_tile_rows(body, d)
    if body == "mma" and d == 16:
        rows = 256           # 8 warps: half the dq reductions (PERF.md)
        dropout = "on" if dropout_rate > 0.0 else "off"
        ragged = nq % tile != 0
    else:
        dropout, ragged = "runtime", True
    return FusedInstance(body, d, tile, rows, -(-nk // rows), dropout, ragged)


def launch_bwd_kernel(kernel: int, q, k, v, bias, do, lse, delta, *,
                      dq=None, dk=None, dv=None, dbias_bh=None, dq_acc=None,
                      dropout_rate=0.0, seed=0, q_offset=0, row_offset=0,
                      body: str | None = None):
    """One launch of a K2 backward kernel into preallocated outputs:
    DKV writes dk, dv, dbias_bh [B*H, Nk]; DKV_FUSED_DQ also adds into the
    zeroed f32 dq_acc [B, H, Nq, d]; DQ writes dq. delta [B, H, Nq] f32 is
    rowsum(f32(o) f32(dO)). `body` as in `backward_instance` (DKV and DQ)
    and `fused_instance` (DKV_FUSED_DQ). Counts the launch."""
    scale, drop = _check_kernel_inputs(
        "flash_attention_bwd", (q, k, v, bias, do, lse, delta),
        dropout_rate)
    if do.dtype != q.dtype or lse.dtype != torch.float32 or (
            delta.dtype != torch.float32):
        raise ValueError("flash_attention_bwd: dO must have q's dtype and "
                         "lse, delta must be f32")
    b, h, nq, d = q.shape
    rule = fused_instance if kernel == DKV_FUSED_DQ else backward_instance
    body = rule(q.dtype, d, nq, k.shape[2], dropout_rate, body).body
    outs = {DKV: (dk, dv, dbias_bh), DKV_FUSED_DQ: (dk, dv, dbias_bh, dq_acc),
            DQ: (dq,)}[kernel]
    if any(t is None or t.device != q.device or not t.is_contiguous()
           for t in outs):
        raise ValueError(f"flash_attention_bwd: kernel {kernel} needs "
                         "contiguous outputs on q's device")
    if body == "mma" and any(t.data_ptr() % 16 for t in (q, k, v, do)):
        raise ValueError("flash_attention_bwd: the tensor-core kernels copy "
                         "16 bytes at a time; q, k, v, dO must be aligned to "
                         "that")
    ptr = lambda t: None if t is None else t.data_ptr()
    err = _build.library().lunaris_flash_attention_bwd(
        kernel, q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(), ptr(dq), ptr(dk),
        ptr(dv), ptr(dbias_bh), ptr(dq_acc), b * h, h, nq, k.shape[2], d,
        scale, *drop, seed & _M32, q_offset, row_offset,
        int(q.dtype == torch.bfloat16), FWD_BODIES.index(body),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention_bwd")
    global bwd_fused_launches, bwd_dkv_launches, bwd_dq_launches
    if kernel == DKV_FUSED_DQ:
        bwd_fused_launches += 1
    elif kernel == DKV:
        bwd_dkv_launches += 1
    else:
        bwd_dq_launches += 1


def flash_attention_bwd(q, k, v, bias, o, lse, do, *, dropout_rate=0.0,
                        seed=0, q_offset=0, row_offset=0, variant=None):
    """The K2 backward kernels on CUDA tensors (the arguments of
    `attention_bwd_plain`, contiguous). variant: "fused" or "split" (see
    the module docstring); None takes `default_bwd`. Returns (dq, dk, dv,
    dbias [H, Nk] f32)."""
    variant = variant or default_bwd(q.dtype, q.shape[3])
    if variant not in BWD_VARIANTS:
        raise ValueError(f"flash_attention_bwd: variant {variant!r} not in "
                         f"{BWD_VARIANTS}")
    if o.shape != q.shape or o.dtype != q.dtype:
        raise ValueError("flash_attention_bwd: o must match q")
    b, h, nq, d = q.shape
    nk = k.shape[2]
    delta = (o.float() * do.float()).sum(-1)
    out = dict(dk=torch.empty_like(k), dv=torch.empty_like(v),
               dbias_bh=torch.empty(b * h, nk, device=q.device,
                                    dtype=torch.float32))
    kw = dict(dropout_rate=dropout_rate, seed=seed, q_offset=q_offset,
              row_offset=row_offset)
    if variant == "fused":
        out["dq_acc"] = torch.zeros(b, h, nq, d, device=q.device,
                                    dtype=torch.float32)
        launch_bwd_kernel(DKV_FUSED_DQ, q, k, v, bias, do, lse, delta,
                          **out, **kw)
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
        if q.device.type == "cpu":
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
    lse [B*H, Nq]); o is differentiable in q, k, v and bias."""
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if bwd is not None and bwd not in BWD_VARIANTS:
        raise ValueError(f"flash_attention: bwd {bwd!r} not in {BWD_VARIANTS}")
    return _FlashAttention.apply(q, k, v, bias, dropout_rate, seed, q_offset,
                                 row_offset, bwd)
