"""The design accuracy of K2's f32 tensor-core bodies (csrc/
flash_attention_fwd.cuh `flash_fwd_tf32`, csrc/flash_attention_bwd.cuh
`flash_bwd_fused_tf32`), on the CPU: every product there is three TF32
passes, a_lo b_hi + a_hi b_lo + a_hi b_hi with hi = tf32(x), lo = tf32(x -
hi), rounded to nearest with ties away (`cvt.rna`). `tf32_round` and
`split_tf32` emulate that rounding; here the emulated forward and backward
are held against float64 at the teacher's magnitudes (q, k, v ~ N(0, 1),
bias 0.5 N(0, 1), 4096 keys), and one pass is shown to miss phase 4's f32
bar of 1e-5. The emulated forward also agrees with the JAX package's
Pallas kernel (interpret mode). The kernels themselves are held against the
plain version on a CUDA card by tests/test_torch_kernels.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lunaris_orion_tpu.ops.pallas import flash_attention as fa
from lunaris_orion_tpu_torch.ops.cuda import flash_attention as k2


def _inputs(b, h, nq, nk, d, seed):
    r = np.random.default_rng(seed)
    q = r.standard_normal((b, h, nq, d)).astype(np.float32)
    k = r.standard_normal((b, h, nk, d)).astype(np.float32)
    v = r.standard_normal((b, h, nk, d)).astype(np.float32)
    bias = (0.5 * r.standard_normal((h, nk))).astype(np.float32)
    do = r.standard_normal((b, h, nq, d)).astype(np.float32)
    return [torch.from_numpy(x) for x in (q, k, v, bias, do)]


def _mm(a, b, passes):
    """a @ b with f32 sums over TF32 operands: three passes (the small
    cross terms first, as the kernels order them) or one."""
    if passes == 1:
        return k2.tf32_round(a) @ k2.tf32_round(b)
    ah, al = k2.split_tf32(a)
    bh, bl = k2.split_tf32(b)
    return (al @ bh + ah @ bl) + ah @ bh


def _keep(b, h, nq, nk, rate, seed):
    """The forward's hash mask [B, H, Nq, Nk], or None at rate 0."""
    if rate == 0.0:
        return None
    rs = k2.row_seeds(seed, b * h).reshape(b, h, 1, 1)
    return k2.keep_mask(rs, torch.arange(nk), torch.arange(nq)[:, None],
                        k2.dropout_threshold(1.0 - rate))


def _forward(q, k, v, bias, keep, rate, passes=None):
    """o, lse, p: with `passes` the kernels' arithmetic (f32, TF32 operands
    in that many passes), else float64 throughout."""
    dt = torch.float32 if passes else torch.float64
    q, k, v, bias = (x.to(dt) for x in (q, k, v, bias))
    qs = q * torch.tensor(q.shape[-1] ** -0.5, dtype=torch.float32).to(dt)
    mm = (lambda a, b: _mm(a, b, passes)) if passes else torch.matmul
    s = mm(qs, k.transpose(-1, -2)) + bias[None, :, None, :]
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l_sum = p.sum(-1, keepdim=True)
    pd = p if keep is None else torch.where(keep, p * k2._inv_keep(rate), 0.0)
    o = mm(pd, v) / l_sum
    return o, (m + torch.log(l_sum)).squeeze(-1), qs


def _backward(q, k, v, bias, do, keep, rate, passes=None):
    """dq, dk, dv, dbias of the fused kernel's five products, as
    `attention_bwd_plain` forms them, with `passes` as in `_forward`."""
    dt = torch.float32 if passes else torch.float64
    o, lse, qs = _forward(q, k, v, bias, keep, rate, passes)
    k, v, bias, do = (x.to(dt) for x in (k, v, bias, do))
    mm = (lambda a, b: _mm(a, b, passes)) if passes else torch.matmul
    s = mm(qs, k.transpose(-1, -2)) + bias[None, :, None, :]
    p = torch.exp(s - lse[..., None])
    dp = mm(do, v.transpose(-1, -2))
    pv = p
    if keep is not None:
        dp = torch.where(keep, dp * k2._inv_keep(rate), 0.0)
        pv = torch.where(keep, p * k2._inv_keep(rate), 0.0)
    ds = p * (dp - (o * do).sum(-1, keepdim=True))
    scale = q.shape[-1] ** -0.5
    return (mm(ds, k) * scale, mm(ds.transpose(-1, -2), qs),
            mm(pv.transpose(-1, -2), do), ds.sum((0, 2)))


@pytest.mark.parametrize("d", [16, 32])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_three_tf32_passes_hold_the_forward_to_f64(d, rate):
    """Three passes: o and lse within 1e-6 of float64 (f32's own rounding
    is ~1e-7 on o, half an ulp of lse ~ 9 is 5e-7). One pass: o misses
    phase 4's f32 bar of 1e-5, which is why the kernels take three."""
    q, k, v, bias, _ = _inputs(1, 2, 512, 4096, d, seed=d)
    keep = _keep(1, 2, 512, 4096, rate, seed=-1234567)
    ref_o, ref_lse, _ = _forward(q, k, v, bias, keep, rate)
    o3, lse3, _ = _forward(q, k, v, bias, keep, rate, passes=3)
    o1, lse1, _ = _forward(q, k, v, bias, keep, rate, passes=1)
    err3 = (o3.double() - ref_o).abs().max().item()
    err1 = (o1.double() - ref_o).abs().max().item()
    assert err3 <= 1e-6, err3
    assert (lse3.double() - ref_lse).abs().max().item() <= 1e-6
    assert err1 > 1e-5, err1
    assert err1 > 30 * err3


@pytest.mark.parametrize("d", [16, 32])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_three_tf32_passes_hold_the_backward_to_f64(d, rate):
    """The fused backward's five products in three passes: every gradient
    within 1e-5 of its largest magnitude of float64 (f32 sums over 512
    queries leave ~1e-6), a tenth of phase 7's f32 bar (1e-4 of the
    largest + 1e-6). One pass misses that bar in every gradient."""
    q, k, v, bias, do = _inputs(1, 2, 512, 2048, d, seed=100 + d)
    keep = _keep(1, 2, 512, 2048, rate, seed=99)
    ref = _backward(q, k, v, bias, do, keep, rate)
    three = _backward(q, k, v, bias, do, keep, rate, passes=3)
    one = _backward(q, k, v, bias, do, keep, rate, passes=1)
    for name, g3, g1, r in zip(("dq", "dk", "dv", "dbias"), three, one, ref):
        top = r.abs().max().item()
        assert (g3.double() - r).abs().max().item() <= 1e-5 * top, name
        assert (g1.double() - r).abs().max().item() > 1e-4 * top + 1e-6, name


@pytest.mark.parametrize("rate,seed", [(0.0, 0), (0.1, 1234567)])
def test_three_tf32_passes_match_pallas(rate, seed):
    """The emulated three-pass forward against the JAX package's Pallas
    kernel (interpret mode), at phase 4's f32 bar."""
    q, k, v, bias, _ = _inputs(1, 2, 256, 256, 16, seed=7)
    want = np.asarray(fa.attention_bhnd(
        *(jnp.asarray(x.numpy()) for x in (q, k, v, bias)),
        dropout_rate=rate, seed=jnp.int32(seed)))
    o, _, _ = _forward(q, k, v, bias, _keep(1, 2, 256, 256, rate, seed), rate,
                       passes=3)
    np.testing.assert_allclose(o.numpy(), want, atol=1e-5, rtol=0)


def test_tf32_round_is_rna_on_the_bits():
    """Ties go away from zero, the low 13 bits clear, and hi + lo carries
    x to within 2^-22 of |x|."""
    x = torch.tensor([1.0, 1 + 2**-11, 1 + 3 * 2**-11, -(1 + 2**-11),
                      1 + 2**-12, -0.0, 3 * 2**-11 + 2**-22])
    want = torch.tensor([1.0, 1 + 2**-10, 1 + 2**-9, -(1 + 2**-10), 1.0,
                         -0.0, 3 * 2**-11])
    got = k2.tf32_round(x)
    assert torch.equal(got, want)
    assert not (got.view(torch.int32) & 0x1FFF).any()
    r = torch.from_numpy(np.random.default_rng(3).standard_normal(4096)
                         .astype(np.float32)) * 10.0
    hi, lo = k2.split_tf32(r)
    assert not ((hi.view(torch.int32) | lo.view(torch.int32)) & 0x1FFF).any()
    assert ((hi.double() + lo.double() - r.double()).abs()
            <= 2.0**-22 * r.double().abs()).all()
    assert ((k2.tf32_round(r).double() - r.double()).abs()
            <= 2.0**-11 * r.double().abs()).all()
