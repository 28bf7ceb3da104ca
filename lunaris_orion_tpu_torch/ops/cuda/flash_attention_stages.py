"""The K2 stage family -- the K2 forward cut after a named stage of the
online-softmax chain: the instrument that says what each stage costs.

`flash_fwd_stage` sends tensors on the CPU to `flash_fwd_stage_plain` and
tensors on a CUDA device to the hand-written kernels of
`csrc/flash_attention_stages.cu`; it raises on any other device and never
falls back. The kernels replace `tools/bench_attn_roofline.py`
`_stage_kernel` and compute what `_stage_fwd` computes, in the port's
row layout ([B, H, N, d] instead of the TPU's [B*H, d, N]). They are the
K2 forward's own two bodies (`csrc/flash_attention_fwd.cuh`) with the stage
as a template parameter: bf16 on the tensor-core body, f32 on the
CUDA-core body, so the instrument reads the kernel that ships.

Per key block of `block_k` keys, with s = q k^T (q arrives scaled):

    "dots"    p = s                            the running max stays 0
    "bias"    s += bias[h, k]
    "maxsub"  m_new = max(m, max s); corr = exp(m - m_new); s -= m_new
    "exp"     p = exp(s)
    "sum"     l = l corr + sum p               (before: l = l corr + 1)

and always acc = acc corr + round(p) v; at the end l = max(l, 1e-30),
o = acc / l, lse = m + log l. Each stage includes the ones above it. Below
"sum" the carry l gains 1 per key BLOCK, so the result depends on
`block_k`; on CUDA it must equal the kernel's key tile (`KERNEL_BLOCK_K`).
At "sum" the result is `flash_attention` at dropout 0 of the unscaled q,
on CUDA bit for bit (the same kernel instance).

`launches` counts the kernel launches; the plain version does not count.
"""

from __future__ import annotations

import torch

from lunaris_orion_tpu_torch.ops.cuda import _build
from lunaris_orion_tpu_torch.ops.cuda.flash_attention import _check_shapes

launches = 0

STAGES = ("dots", "bias", "maxsub", "exp", "sum")
HEAD_DIM = 16                        # the kernels' one compiled head size
KERNEL_BLOCK_K = 64                  # and their key tile, in both types
NEG_INF = -1e30


def _check(q, k, v, bias, stage, block_k):
    _check_shapes(q, k, v, bias)
    if stage not in STAGES:
        raise ValueError(f"flash_fwd_stage: stage {stage!r} not in {STAGES}")
    if block_k <= 0 or k.shape[2] % block_k != 0:
        raise ValueError(f"flash_fwd_stage: Nk = {k.shape[2]} must be a "
                         f"multiple of block_k = {block_k}")


def flash_fwd_stage_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          bias: torch.Tensor, stage: str, block_k: int,
                          max_elems: int = 2**26):
    """The plain version: a loop over key blocks of `block_k`, blockwise
    over q so that about `max_elems` scores are alive at once. Scores and
    carries in f32; p rounded to v's dtype before P.V.
    Returns (o [B, H, Nq, d] in q's dtype, lse [B*H, Nq] f32)."""
    _check(q, k, v, bias, stage, block_k)
    lvl = STAGES.index(stage)
    b, h, nq, d = q.shape
    nk = k.shape[2]
    qf, kt, vf = q.float(), k.float().transpose(-1, -2), v.float()
    bias4 = bias.float()[None, :, None, :]
    o = torch.empty_like(q)
    lse = torch.empty(b, h, nq, device=q.device, dtype=torch.float32)
    bq = max(1, min(nq, max_elems // max(1, b * h * block_k)))
    for i0 in range(0, nq, bq):
        i1 = min(nq, i0 + bq)
        rows = (b, h, i1 - i0, 1)
        acc = torch.zeros(b, h, i1 - i0, d, device=q.device)
        m = torch.full(rows, NEG_INF if lvl >= 2 else 0.0, device=q.device)
        l_sum = torch.zeros(rows, device=q.device)
        for k0 in range(0, nk, block_k):
            s = torch.matmul(qf[:, :, i0:i1], kt[..., k0:k0 + block_k])
            if lvl >= 1:
                s = s + bias4[..., k0:k0 + block_k]
            if lvl >= 2:
                m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
                corr = torch.exp(m - m_new)
                s = s - m_new
                l_sum, acc, m = l_sum * corr, acc * corr, m_new
            p = torch.exp(s) if lvl >= 3 else s
            l_sum = l_sum + (p.sum(dim=-1, keepdim=True) if lvl >= 4 else 1.0)
            acc = acc + torch.matmul(p.to(v.dtype).float(),
                                     vf[:, :, k0:k0 + block_k])
        l_sum = l_sum.clamp_min(1e-30)
        o[:, :, i0:i1] = (acc / l_sum).to(q.dtype)
        lse[:, :, i0:i1] = (m + torch.log(l_sum)).squeeze(-1)
    return o, lse.reshape(b * h, nq)


def _kernel(q, k, v, bias, stage, block_k):
    _check(q, k, v, bias, stage, block_k)
    b, h, nq, d = q.shape
    if q.dtype not in (torch.float32, torch.bfloat16) or not (
            q.dtype == k.dtype == v.dtype) or bias.dtype != torch.float32:
        raise ValueError("flash_fwd_stage: q, k, v must share one dtype, f32 "
                         "or bf16, and bias must be f32")
    for i, t in enumerate((q, k, v, bias)):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"flash_fwd_stage: argument {i} must be "
                             f"contiguous on {q.device}")
    if d != HEAD_DIM or b * h > 65535:
        raise ValueError(f"flash_fwd_stage: head dim {d} is not {HEAD_DIM} "
                         "(the kernel's one size) or B*H is above 65535")
    if block_k != KERNEL_BLOCK_K:
        raise ValueError(
            f"flash_fwd_stage: block_k = {block_k}, but the kernel's key "
            f"tile is {KERNEL_BLOCK_K} and the stages below 'sum' depend "
            "on it")
    o = torch.empty_like(q)
    lse = torch.empty(b * h, nq, device=q.device, dtype=torch.float32)
    err = _build.library().lunaris_flash_attention_stage(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
        o.data_ptr(), lse.data_ptr(), b * h, h, nq, k.shape[2], d,
        STAGES.index(stage), int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_fwd_stage")
    global launches
    launches += 1
    return o, lse


def flash_fwd_stage(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: torch.Tensor, stage: str, block_k: int):
    """The K2 forward cut after `stage` (one of STAGES). q [B, H, Nq, d]
    already scaled by d^-1/2, k/v [B, H, Nk, d] (contiguous, f32 or bf16,
    one dtype), bias [H, Nk] f32, Nk a multiple of `block_k`. Returns
    (o [B, H, Nq, d], lse [B*H, Nq] f32). On CUDA d must be HEAD_DIM and
    block_k must be KERNEL_BLOCK_K, else ValueError."""
    if q.device.type == "cpu":
        return flash_fwd_stage_plain(q, k, v, bias, stage, block_k)
    if q.device.type != "cuda":
        raise ValueError(f"flash_fwd_stage: unsupported device {q.device}")
    return _kernel(q, k, v, bias, stage, block_k)
