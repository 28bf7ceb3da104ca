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
import torch.nn.functional as F

from lunaris_orion_tpu_torch.ops.cuda import flash_attention as k2
from lunaris_orion_tpu_torch.ops.cuda import flash_attention_stages as stages
from lunaris_orion_tpu_torch.ops.cuda import fused_stage as k5
from lunaris_orion_tpu_torch.ops.cuda import gn_mish as k1
from lunaris_orion_tpu_torch.ops.cuda import gn_stats
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


# --- K5 GN-apply + Mish + conv3x3 ---------------------------------------------

def _k5_inputs(cuda, b, h, w, cin, cout, dtype, seed, beta_mean=0.0):
    r = np.random.default_rng(seed)
    f = lambda a: torch.from_numpy(a.astype(np.float32)).to(cuda)
    y = f(2.0 * r.standard_normal((b, h, w, cin))).to(dtype)
    alpha = f(1.0 + 0.2 * r.standard_normal((b, cin)))
    beta = f(beta_mean + 0.1 * r.standard_normal((b, cin)))
    wt = f(0.05 * r.standard_normal((3, 3, cin, cout)))
    wb = f(0.1 * r.standard_normal(cout))
    return y, alpha, beta, wt, wb


def _bf16_ulp(x):
    e = torch.floor(torch.log2(x.float().abs().clamp_min(1e-30)))
    return torch.exp2(e - 7)


def _k5_bf16_agree(got, ref) -> bool:
    """The bf16 bar of K5. The kernel rounds where the plain version rounds,
    so only the order of the f32 sums differs: an element is off by the last
    rounding (2 ulps of its reference, plus an eighth of the largest
    element's ulp near zero), and at most 1 element in 1000 differs at all
    (measured on an H100: 1 in 4000 to 1 in 20000)."""
    err = (got.float() - ref.float()).abs()
    top = ref.float().abs().max()
    return ((err > 0).float().mean().item() <= 1e-3 and bool(
        (err <= 2 * _bf16_ulp(ref) + _bf16_ulp(top) / 8).all()))


def _k5_plain_without(y, alpha, beta, w, wb, skip):
    """`gn_mish_conv3_plain` with the rounding to y's dtype left out at one
    point: "affine", "mish", "w" or "wb" (None: every point kept)."""
    dt = y.dtype
    b, h, wd, _ = y.shape
    rnd = lambda t, name: t.float() if name == skip else t.to(dt).float()
    g = rnd(y.float() * alpha[:, None, None, :] + beta[:, None, None, :],
            "affine")
    g = rnd(g * torch.tanh(F.softplus(g)), "mish")
    gp = F.pad(g, (0, 0, 1, 1, 1, 1))
    w32 = rnd(w, "w")
    out = torch.zeros(b, h, wd, w.shape[3], device=y.device)
    for dy in range(3):
        for dx in range(3):
            out += torch.matmul(gp[:, dy:dy + h, dx:dx + wd, :], w32[dy, dx])
    return (out + rnd(wb, "wb")).to(dt)


@pytest.mark.gpu
@pytest.mark.parametrize("skip", ["affine", "mish", "w", "wb"])
def test_gn_mish_conv3_bf16_bar_sees_each_rounding_point(cuda, skip):
    """A plain version with one rounding point left out fails the bf16 bar
    that the kernel passes: the bar holds every rounding point of the
    kernel, not only its f32 structure."""
    args = _k5_inputs(cuda, 2, 32, 32, 64, 64, torch.bfloat16, seed=5,
                      beta_mean=1.0)
    got = k5.gn_mish_conv3(*args)
    assert torch.equal(_k5_plain_without(*args, None),
                       k5.gn_mish_conv3_plain(*args))
    assert _k5_bf16_agree(got, k5.gn_mish_conv3_plain(*args))
    assert not _k5_bf16_agree(got, _k5_plain_without(*args, skip))


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,w,cin,cout", [
    (2, 32, 32, 64, 64), (2, 64, 64, 32, 32), (2, 32, 32, 128, 64),
    (8, 128, 128, 64, 64), (3, 13, 37, 8, 32), (1, 5, 70, 24, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gn_mish_conv3_kernel_matches_plain(cuda, b, h, w, cin, cout, dtype):
    assert k5.supported_shape(h, w, cin, cout)
    args = _k5_inputs(cuda, b, h, w, cin, cout, dtype, seed=h + w + cin,
                      beta_mean=1.0)           # mish(beta) != 0 at the halo
    before = k5.launches
    got = k5.gn_mish_conv3(*args)
    torch.cuda.synchronize()
    assert k5.launches == before + 1
    assert got.shape == (b, h, w, cout) and got.dtype == dtype
    ref = k5.gn_mish_conv3_plain(*args)
    err = (got.float() - ref.float()).abs()
    if dtype == torch.float32:
        # 9 * Cin f32 products summed in another order: the JAX package's bar.
        assert (err <= 2e-5 + 2e-5 * ref.abs()).all(), err.max().item()
    else:
        assert _k5_bf16_agree(got, ref), (err.max().item(),
                                          (err > 0).float().mean().item())
    assert torch.equal(got, k5.gn_mish_conv3(*args)), "same bits every run"


@pytest.mark.gpu
def test_gn_mish_conv3_rejects_unsupported(cuda):
    y, alpha, beta, w, wb = _k5_inputs(cuda, 1, 8, 8, 16, 32, torch.float32, 0)
    with pytest.raises(ValueError, match="outside the kernel's shapes"):
        k5.gn_mish_conv3(y[..., :12].contiguous(), alpha[:, :12].contiguous(),
                         beta[:, :12].contiguous(), w[:, :, :12].contiguous(),
                         wb)
    with pytest.raises(ValueError, match="outside the kernel's shapes"):
        k5.gn_mish_conv3(y, alpha, beta, w[..., :16].contiguous(), wb[:16])
    with pytest.raises(ValueError, match="contiguous"):
        k5.gn_mish_conv3(y.transpose(1, 2), alpha, beta, w, wb)
    with pytest.raises(ValueError, match="f32 or bf16"):
        k5.gn_mish_conv3(y.half(), alpha, beta, w, wb)


# --- the K2 stage family -----------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("stage", stages.STAGES)
@pytest.mark.parametrize("n", [4096, 1000, 192])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_fwd_stage_kernel_matches_plain(cuda, stage, n, dtype):
    d = stages.HEAD_DIM
    r = np.random.default_rng(n + d)
    nk = -(-n // 64) * 64                       # a ragged Nq, whole key tiles
    mk = lambda *shape: torch.from_numpy(
        r.standard_normal(shape).astype(np.float32)).to(cuda)
    q = (mk(2, 4, n, d) * d ** -0.5).to(dtype)
    k, v = mk(2, 4, nk, d).to(dtype), mk(2, 4, nk, d).to(dtype)
    bias = 0.5 * mk(4, nk)
    block_k = stages.KERNEL_BLOCK_K
    before = stages.launches
    o, lse = stages.flash_fwd_stage(q, k, v, bias, stage, block_k)
    torch.cuda.synchronize()
    assert stages.launches == before + 1
    ro, rlse = stages.flash_fwd_stage_plain(q, k, v, bias, stage, block_k)
    ref = ro.float()
    scale = ref.abs().max().item()       # no floor: o is small past "exp"
    err = (o.float() - ref).abs()
    # f32: up to Nk terms summed in another order, 2e-5 of the largest
    # magnitude. bf16: that, plus 2 ulps of each element's own reference for
    # the last rounding, and at most 1 element in 100 may differ at all
    # (measured on an H100: 1 ulp, 1 in 900 at Nk 16384).
    bar = 2e-5 * scale
    if dtype == torch.bfloat16:
        bar = bar + 2 * _bf16_ulp(ref)
        assert (err > 0).float().mean().item() <= 1e-2
    assert (err <= bar).all(), (err.max().item(), scale)
    assert (lse - rlse).abs().max().item() <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_fwd_stage_sum_is_the_forward_kernel(cuda, dtype):
    """At "sum" the stage kernel is the forward kernel without dropout,
    operation for operation: the same bits."""
    r = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(r.standard_normal((2, 4, 2048, 16)).astype(
        np.float32)).to(cuda, dtype) for _ in range(3))
    bias = torch.from_numpy(
        (0.5 * r.standard_normal((4, 2048))).astype(np.float32)).to(cuda)
    o, lse = k2.flash_attention(q, k, v, bias)
    qs = q * torch.tensor(16 ** -0.5, dtype=dtype, device=cuda)
    so, slse = stages.flash_fwd_stage(qs, k, v, bias, "sum", 64)
    assert torch.equal(so, o) and torch.equal(slse, lse)


@pytest.mark.gpu
def test_flash_fwd_stage_rejects_unsupported(cuda):
    q, k, v = (torch.zeros(1, 2, 256, 16, device=cuda) for _ in range(3))
    bias = torch.zeros(2, 256, device=cuda)
    with pytest.raises(ValueError, match="key tile"):
        stages.flash_fwd_stage(q, k, v, bias, "dots", 128)
    q8, k8, v8 = (torch.zeros(1, 2, 256, 8, device=cuda) for _ in range(3))
    with pytest.raises(ValueError, match="head dim"):
        stages.flash_fwd_stage(q8, k8, v8, bias, "dots", 64)
    with pytest.raises(ValueError, match="one dtype"):
        stages.flash_fwd_stage(q, k.bfloat16(), v, bias, "dots", 64)


# --- lane sums from per-tile partials, and K1's pass 1 alone --------------------

@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(128, 128, 128, 32), (128, 128, 128, 64),
                                   (128, 64, 64, 128), (2, 16, 16, 256),
                                   (3, 8, 8, 1024), (2, 16, 16, 8)])
@pytest.mark.parametrize("tile_rows", [512, 2048])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lane_sums_kernel_matches_plain(cuda, shape, tile_rows, dtype):
    b, h, w, c = shape
    rows = h * w * c // 128
    tile_rows = min(tile_rows, rows)
    assert gn_stats.supported_shape(h, w, c, tile_rows, dtype)
    g = torch.Generator(device=cuda).manual_seed(sum(shape))
    x = (1.0 + 2.0 * torch.randn(shape, generator=g, device=cuda)).to(dtype)
    before = gn_stats.launches
    s1, s2 = gn_stats.lane_sums_partials(x, tile_rows)
    torch.cuda.synchronize()
    assert gn_stats.launches == before + 1
    r1, r2 = gn_stats.lane_sums_plain(x, tile_rows)
    assert s1.shape == r1.shape == (b, max(c, 128))
    for got, ref in ((s1, r1), (s2, r2)):   # sums in another order
        assert (got - ref).abs().max().item() <= 2e-5 * ref.abs().max().item()
    t1, t2 = gn_stats.lane_sums_partials(x, tile_rows)
    assert torch.equal(s1, t1) and torch.equal(s2, t2), "same bits every run"


@pytest.mark.gpu
def test_lane_sums_rejects_unsupported(cuda):
    with pytest.raises(ValueError, match="outside the kernel's shapes"):
        gn_stats.lane_sums_partials(torch.zeros(1, 4, 4, 384, device=cuda), 3)
    with pytest.raises(ValueError, match="f32 or bf16"):
        gn_stats.lane_sums_partials(
            torch.zeros(1, 16, 16, 32, device=cuda, dtype=torch.float16))
    x = torch.zeros(1, 16, 16, 64, device=cuda)[..., :32]      # not contiguous
    with pytest.raises(ValueError, match="contiguous"):
        gn_stats.lane_sums_partials(x)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(128, 128, 128, 32), (8, 16, 16, 256),
                                   (3, 7, 9, 48)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_group_stats_pass1_matches_plain(cuda, shape, dtype):
    g = torch.Generator(device=cuda).manual_seed(sum(shape))
    x = (0.5 + 2.0 * torch.randn(shape, generator=g, device=cuda)).to(dtype)
    before = k1.stats_launches
    mean, inv = k1.group_stats(x, groups=8)
    torch.cuda.synchronize()
    assert k1.stats_launches == before + 1
    rmean, rinv = k1.group_stats_plain(x, groups=8)
    torch.testing.assert_close(mean, rmean, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(inv, rinv, atol=1e-5, rtol=1e-4)
