"""The PyTorch port's hand-written CUDA kernels against their plain PyTorch
versions, on a CUDA card. Without one every test here skips.

This file imports torch and the port only (no jax), so it also runs on a
machine without jax, skipping the repository's jax-based conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from lunaris_orion_tpu_torch.ops.cuda import flash_attention as k2
from lunaris_orion_tpu_torch.ops.cuda import gn_mish as k1
from lunaris_orion_tpu_torch.ops.cuda import loss_epilogue as k3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    return torch.device("cuda")


def _bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    e = torch.floor(torch.log2(x.float().abs().clamp_min(1e-30)))
    return torch.exp2(e - 7)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(8, 16, 16, 256), (8, 32, 32, 128),
                                   (8, 64, 64, 64), (8, 128, 128, 32),
                                   (3, 7, 9, 48), (2, 4, 4, 512)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gn_mish_kernel_matches_plain(cuda, shape, dtype):
    r = np.random.default_rng(sum(shape))
    c = shape[-1]
    x = torch.from_numpy(
        (0.5 + 2 * r.standard_normal(shape)).astype(np.float32)).to(cuda, dtype)
    w = torch.from_numpy((1 + 0.1 * r.standard_normal(c)).astype(np.float32)).to(cuda)
    b = torch.from_numpy((0.1 * r.standard_normal(c)).astype(np.float32)).to(cuda)
    before = k1.launches
    got = k1.gn_mish(x, w, b)
    torch.cuda.synchronize()
    assert k1.launches == before + 1
    ref = k1.gn_mish_plain(x, w, b)
    err = (got.float() - ref.float()).abs()
    if dtype == torch.float32:
        assert err.max().item() <= 1e-5
    else:  # 2 bf16 ulps of the plain value (+1e-6 for values near 0)
        assert (err <= 2 * _bf16_ulp(ref) + 1e-6).all()
    assert torch.equal(got, k1.gn_mish(x, w, b)), "runs must give the same bits"


@pytest.mark.gpu
def test_gn_mish_rejects_non_nhwc(cuda):
    x = torch.zeros(2, 8, 8, 32, device=cuda).permute(0, 3, 1, 2)  # NCHW view
    w = torch.ones(8, device=cuda)
    with pytest.raises(ValueError, match="contiguous NHWC"):
        k1.gn_mish(x, w, w)


@pytest.mark.gpu
@pytest.mark.parametrize("n,d", [(4096, 8), (2000, 16), (4096, 48),
                                 (1000, 64), (300, 8)])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_matches_plain(cuda, n, d, rate, dtype):
    r = np.random.default_rng(n + d)
    q, k, v = (torch.from_numpy(r.standard_normal((2, 4, n, d)).astype(
        np.float32)).to(cuda, dtype) for _ in range(3))
    bias = torch.from_numpy(
        (0.5 * r.standard_normal((4, n))).astype(np.float32)).to(cuda)
    before = k2.launches
    o, lse = k2.flash_attention(q, k, v, bias, dropout_rate=rate, seed=-77)
    torch.cuda.synchronize()
    assert k2.launches == before + 1
    ro, rlse = k2.attention_plain(q, k, v, bias, dropout_rate=rate, seed=-77)
    err = (o.float() - ro.float()).abs().max().item()
    if dtype == torch.float32:
        assert err <= 1e-5
    else:  # 2 bf16 ulps at the output's largest magnitude
        assert err <= 2 * 2.0 ** -7 * ro.float().abs().max().item()
    assert (lse - rlse).abs().max().item() <= 1e-4


@pytest.mark.gpu
def test_flash_attention_rectangular_offsets(cuda):
    """A q shard at q_offset, and batch rows at row_offset, see the same
    dropout mask as the full call."""
    r = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(r.standard_normal((2, 2, 512, 16)).astype(
        np.float32)).to(cuda) for _ in range(3))
    bias = torch.zeros(2, 512, device=cuda)
    full, _ = k2.flash_attention(q, k, v, bias, dropout_rate=0.2, seed=9)
    shard, _ = k2.flash_attention(q[:, :, 256:].contiguous(), k, v, bias,
                                  dropout_rate=0.2, seed=9, q_offset=256)
    rows, _ = k2.flash_attention(q[1:].contiguous(), k[1:].contiguous(),
                                 v[1:].contiguous(), bias, dropout_rate=0.2,
                                 seed=9, row_offset=2)
    torch.testing.assert_close(shard, full[:, :, 256:], atol=1e-6, rtol=0)
    torch.testing.assert_close(rows, full[1:], atol=1e-6, rtol=0)


# --- K2 backward -------------------------------------------------------------

def _bwd_inputs(cuda, b, h, nq, nk, d, dtype, seed, rate=0.0):
    r = np.random.default_rng(seed)
    mk = lambda *shape: torch.from_numpy(
        r.standard_normal(shape).astype(np.float32)).to(cuda, dtype)
    q, k, v = mk(b, h, nq, d), mk(b, h, nk, d), mk(b, h, nk, d)
    bias = torch.from_numpy(
        (0.5 * r.standard_normal((h, nk))).astype(np.float32)).to(cuda)
    do = mk(b, h, nq, d)
    o, lse = k2.attention_plain(q, k, v, bias, dropout_rate=rate, seed=-77)
    return q, k, v, bias, o, lse, do


def _close(got, ref, dtype, name):
    """f32: 1e-4 of the largest magnitude (sums of up to N terms in other
    orders; the fused dq's atomics in any order). bf16: 2 bf16 ulps there
    (ds and p are rounded to bf16 per term, and a term near a rounding
    boundary may round the other way). dbias is f32 in both."""
    scale = ref.float().abs().max().item()
    tol = (1e-4 * scale + 1e-6 if dtype == torch.float32 or name == "dbias"
           else 2 * 2.0 ** -7 * scale)
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= tol, f"{name}: max_abs_err {err:.3e} > {tol:.3e}"


@pytest.mark.gpu
@pytest.mark.parametrize("variant", ["fused", "split"])
@pytest.mark.parametrize("n,d", [(4096, 8), (2000, 16), (4096, 48),
                                 (1000, 64), (300, 8)])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_bwd_kernels_match_plain(cuda, variant, n, d, rate,
                                                dtype):
    args = _bwd_inputs(cuda, 2, 4, n, n, d, dtype, seed=n + d, rate=rate)
    counts = (k2.bwd_fused_launches, k2.bwd_dkv_launches, k2.bwd_dq_launches)
    got = k2.flash_attention_bwd(*args, dropout_rate=rate, seed=-77,
                                 variant=variant)
    torch.cuda.synchronize()
    after = (k2.bwd_fused_launches, k2.bwd_dkv_launches, k2.bwd_dq_launches)
    assert [a - b for a, b in zip(after, counts)] == (
        [1, 0, 0] if variant == "fused" else [0, 1, 1])
    ref = k2.attention_bwd_plain(*args, dropout_rate=rate, seed=-77)
    for name, g, r in zip(("dq", "dk", "dv", "dbias"), got, ref):
        assert g.dtype == r.dtype and g.shape == r.shape, name
        _close(g, r, dtype, name)


@pytest.mark.gpu
@pytest.mark.parametrize("variant", ["fused", "split"])
def test_flash_attention_bwd_offsets(cuda, variant):
    """A q shard at q_offset gets the full call's dq rows; batch row 1 at
    row_offset gets the full call's dq, dk, dv rows (same dropout masks)."""
    q, k, v, bias, _, _, do = _bwd_inputs(cuda, 2, 2, 512, 512, 16,
                                          torch.float32, seed=3)
    kw = dict(dropout_rate=0.2, seed=9)

    def grads(q, k, v, do, **extra):
        o, lse = k2.attention_plain(q, k, v, bias, **kw, **extra)
        return k2.flash_attention_bwd(q, k, v, bias, o, lse, do,
                                      variant=variant, **kw, **extra)
    full = grads(q, k, v, do)
    shard = grads(q[:, :, 256:].contiguous(), k, v,
                  do[:, :, 256:].contiguous(), q_offset=256)
    rows = grads(*(t[1:].contiguous() for t in (q, k, v, do)), row_offset=2)
    _close(shard[0], full[0][:, :, 256:], torch.float32, "dq")
    for name, a, b in zip(("dq", "dk", "dv"), rows[:3], full[:3]):
        _close(a, b[1:], torch.float32, name)


@pytest.mark.gpu
def test_flash_attention_autograd_on_cuda(cuda):
    """On a CUDA tensor the output carries the autograd.Function, and its
    backward launches the chosen variant's kernels."""
    q, k, v, bias, _, _, do = _bwd_inputs(cuda, 1, 2, 2048, 2048, 16,
                                          torch.float32, seed=5)
    for variant, counter in (("fused", "bwd_fused_launches"),
                             ("split", "bwd_dq_launches")):
        ts = [t.clone().requires_grad_() for t in (q, k, v, bias)]
        o, _ = k2.flash_attention(*ts, bwd=variant)
        assert type(o.grad_fn).__name__ == "_FlashAttentionBackward"
        before = getattr(k2, counter)
        o.backward(do)
        assert getattr(k2, counter) == before + 1
        assert all(t.grad is not None and t.grad.abs().sum() > 0 for t in ts)


# --- K3 ----------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("shape,latent", [((16, 128, 128, 3), 256),
                                          ((3, 7, 9, 3), 5)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mse_kl_kernel_matches_plain(cuda, shape, latent, dtype):
    r = np.random.default_rng(latent)
    mk = lambda s, lo, hi: torch.from_numpy(
        r.uniform(lo, hi, s).astype(np.float32)).to(cuda, dtype)
    args = (mk(shape, -1, 1), mk(shape, -1, 1), mk((shape[0], latent), -2, 2),
            mk((shape[0], latent), -1, 1))
    before = k3.launches
    got = k3.mse_kl(*args)
    torch.cuda.synchronize()
    assert k3.launches == before + 1
    ref = k3.mse_kl_plain(*args)
    for g, w in zip(got, ref):   # f32 sums in other orders: rtol 1e-5
        torch.testing.assert_close(g, w, atol=0, rtol=1e-5)
    again = k3.mse_kl(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, again)), \
        "runs must give the same bits"


# --- gradients through the kernels reach every parameter ----------------------

@pytest.mark.gpu
def test_every_parameter_gets_a_gradient_on_cuda(cuda):
    """One backward on the card, through K1 (16 sites), K3, and K2 forward
    and backward (48 px: N = 2304, d = 8): every VAE and teacher parameter
    gets a non-zero gradient (the teacher's loss reads all its outputs)."""
    from lunaris_orion_tpu_torch import TrainConfig
    from lunaris_orion_tpu_torch.models import teacher as tteacher
    from lunaris_orion_tpu_torch.models.teacher import LunarMoETeacher
    from lunaris_orion_tpu_torch.models.vae import LunarisCoreVAE
    from lunaris_orion_tpu_torch.train.losses import recon_kl

    cfg = TrainConfig(image_size=48, latent_dim=16, feature_dim=16,
                      embedding_dim=8, num_experts=2)
    g = torch.Generator().manual_seed(0)
    vae = LunarisCoreVAE(cfg.vae_config())
    vae.reset_parameters(g)
    teacher = LunarMoETeacher(dataclasses.replace(cfg.teacher_config(),
                                                  num_heads=2))
    teacher.reset_parameters(g)
    vae.to(cuda)
    teacher.to(cuda)
    x = torch.rand(2, 48, 48, 3, generator=g).to(cuda) * 2 - 1
    launched = lambda: (k1.launches, k2.launches,  # K2 bwd: either variant
                        k2.bwd_fused_launches + k2.bwd_dq_launches,
                        k3.launches)
    counts = launched()
    recon, mu, logvar = vae(x, torch.Generator(device=cuda).manual_seed(1))
    assert type(recon.grad_fn).__name__ != "NoneType"
    rl, kl = recon_kl(recon, x, mu, logvar)
    out = tteacher.apply(teacher, recon, train=True,
                         generator=torch.Generator().manual_seed(2),
                         prompt_embedding=torch.ones(2, 8, device=cuda))
    (rl + kl + sum(v.float().sum() for v in out.values())).backward()
    torch.cuda.synchronize()
    after = launched()
    assert all(a > b for a, b in zip(after, counts)), (counts, after)
    for model in (vae, teacher):
        for name, p in model.named_parameters():
            assert p.grad is not None, name
            assert p.grad.abs().sum() > 0, name
