"""K5 in the PyTorch port (lunaris_orion_tpu_torch/ops/cuda/fused_stage.py):
its plain version against the JAX package's Pallas kernel
`gn_mish_conv3_pallas` (interpret mode on the CPU) and its XLA oracle
`gn_mish_conv3_reference`, from the same numpy inputs, and the wrapper's
device contract. The kernel itself is held against its plain version on a
CUDA card by tests/test_torch_kernels.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lunaris_orion_tpu.ops.pallas import fused_stage as jfs
from lunaris_orion_tpu.ops.pallas import gn_mish as jk1
from lunaris_orion_tpu_torch.ops.cuda import _build
from lunaris_orion_tpu_torch.ops.cuda import fused_stage as k5
from lunaris_orion_tpu_torch.ops.cuda import gn_mish as k1


def _inputs(b, h, cin, cout, seed, *, beta_mean=0.0):
    r = np.random.default_rng(seed)
    y = (2.0 * r.standard_normal((b, h, h, cin))).astype(np.float32)
    alpha = (1.0 + 0.2 * r.standard_normal((b, cin))).astype(np.float32)
    beta = (beta_mean + 0.1 * r.standard_normal((b, cin))).astype(np.float32)
    w = (0.05 * r.standard_normal((3, 3, cin, cout))).astype(np.float32)
    wb = (0.1 * r.standard_normal(cout)).astype(np.float32)
    return y, alpha, beta, w, wb


def _plain(args, dtype=torch.float32):
    y, *rest = (torch.from_numpy(a) for a in args)
    return k5.gn_mish_conv3_plain(y.to(dtype), *rest).float().numpy()


def _jax(fn, args, dtype=jnp.float32, **kw):
    y, *rest = (jnp.asarray(a) for a in args)
    return np.asarray(fn(y.astype(dtype), *rest, **kw), np.float32)


# The shapes of the JAX package's own K5 test. f32 on both sides; the nine
# taps are summed in another order: atol = rtol = 2e-5, its bar.
@pytest.mark.parametrize("h,cin,cout,band", [(32, 64, 64, 8),
                                             (64, 32, 32, 32),
                                             (32, 128, 64, 16)])
def test_plain_matches_pallas_and_reference(h, cin, cout, band):
    args = _inputs(2, h, cin, cout, seed=h + cin + cout)
    got = _plain(args)
    np.testing.assert_allclose(
        got, _jax(jfs.gn_mish_conv3_pallas, args, band=band),
        atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(got, _jax(jfs.gn_mish_conv3_reference, args),
                               atol=2e-5, rtol=2e-5)


# The alpha / beta entry (`gn_mish.group_affine_kernel`, on the CPU its plain
# version) through K5, against the JAX path the tool times: K1's stats-only
# Pallas entry (interpret mode) folded with the GroupNorm weight and bias,
# then the K5 Pallas kernel. f32 on both sides; moments and taps summed in
# other orders: 2e-5, K5's bar.
@pytest.mark.parametrize("h,cin,cout,band", [(32, 64, 64, 8),
                                             (64, 32, 32, 32),
                                             (32, 128, 64, 16)])
def test_group_affine_kernel_through_k5_matches_pallas(h, cin, cout, band):
    y, _, _, w, wb = _inputs(2, h, cin, cout, seed=h + cin + 1)
    r = np.random.default_rng(cin)
    gamma = (1 + 0.1 * r.standard_normal(cin)).astype(np.float32)
    bias = (0.1 * r.standard_normal(cin)).astype(np.float32)
    alpha, beta = k1.group_affine_kernel(
        torch.from_numpy(y), torch.from_numpy(gamma), torch.from_numpy(bias))
    ref_a, ref_b = k1.group_affine(
        torch.from_numpy(y), torch.from_numpy(gamma), torch.from_numpy(bias))
    assert torch.equal(alpha, ref_a) and torch.equal(beta, ref_b)
    mean, inv = jk1.group_stats_pallas(jnp.asarray(y), groups=8)
    cg = cin // 8
    ja = np.repeat(np.asarray(inv), cg, axis=1) * gamma
    jb = bias - np.repeat(np.asarray(mean * inv), cg, axis=1) * gamma
    np.testing.assert_allclose(alpha.numpy(), ja, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(beta.numpy(), jb, atol=2e-5, rtol=2e-5)
    got = k5.gn_mish_conv3(torch.from_numpy(y), alpha, beta,
                           torch.from_numpy(w), torch.from_numpy(wb)).numpy()
    want = _jax(jfs.gn_mish_conv3_pallas, (y, ja.astype(np.float32),
                                           jb.astype(np.float32), w, wb),
                band=band)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)


# The body rule: bf16 on the tensor cores at every shape the kernel takes
# (a Cin of 8 or 24 ends with a half chunk padded with zeros), f32 on the
# CUDA cores.
@pytest.mark.parametrize("dtype,cin,cout,body", [
    (torch.bfloat16, 64, 64, "mma"), (torch.bfloat16, 32, 32, "mma"),
    (torch.bfloat16, 8, 32, "mma"), (torch.bfloat16, 24, 64, "mma"),
    (torch.float32, 64, 64, "simt"), (torch.float32, 8, 32, "simt")])
def test_kernel_body_rule(dtype, cin, cout, body):
    assert k5.supported_shape(16, 16, cin, cout)
    assert k5.kernel_body(dtype) == body
    assert k5.kernel_body(dtype, "simt") == "simt"


def test_kernel_body_refusals():
    with pytest.raises(ValueError, match="bf16 only"):
        k5.kernel_body(torch.float32, "mma")
    with pytest.raises(ValueError, match="body 'wgmma'"):
        k5.kernel_body(torch.bfloat16, "wgmma")
    with pytest.raises(ValueError, match="f32 or bf16"):
        k5.kernel_body(torch.float16)
    # Shapes are `supported_shape`'s, which both bodies share.
    assert not k5.supported_shape(16, 16, 12, 64)
    assert not k5.supported_shape(16, 16, 64, 48)


def test_bf16_rounding_points_match():
    """bf16 activations: the affine is rounded to bf16 before mish, mish
    again, and the weights and the conv bias are cast to bf16. The JAX
    package's bar for this case is 2e-2."""
    args = _inputs(1, 32, 64, 64, seed=7)
    got = _plain(args, torch.bfloat16)
    for fn, kw in ((jfs.gn_mish_conv3_pallas, dict(band=8)),
                   (jfs.gn_mish_conv3_reference, {})):
        np.testing.assert_allclose(got, _jax(fn, args, jnp.bfloat16, **kw),
                                   atol=2e-2, rtol=2e-2)


def test_halo_is_zero_after_mish():
    """With a large beta, mish(beta) is far from 0: a halo computed as
    mish(0 * alpha + beta) instead of 0 moves every border pixel."""
    args = _inputs(1, 32, 32, 32, seed=11, beta_mean=3.0)
    y, alpha, beta, w, wb = args
    got = _plain(args)
    np.testing.assert_allclose(
        got, _jax(jfs.gn_mish_conv3_pallas, args, band=8), atol=2e-5,
        rtol=2e-5)
    # The wrong halo: pad y with zeros BEFORE the affine and mish.
    yp = torch.from_numpy(np.pad(y, ((0, 0), (1, 1), (1, 1), (0, 0))))
    wrong = k5.gn_mish_conv3_plain(
        yp, torch.from_numpy(alpha), torch.from_numpy(beta),
        torch.from_numpy(w), torch.from_numpy(wb))[:, 1:-1, 1:-1].numpy()
    border = np.abs(wrong - got)[:, 0].max()
    inner = np.abs(wrong - got)[:, 2:-2, 2:-2].max()
    assert border > 0.1 and inner < 1e-5, (border, inner)


def test_group_affine_is_k1s_fold():
    """K5 after `group_affine` and a 1x1-like identity check: mish(y * A +
    B') through K5's prologue equals K1's plain version."""
    r = np.random.default_rng(5)
    y = torch.from_numpy((0.5 + 2 * r.standard_normal((2, 8, 8, 16))).astype(
        np.float32))
    gamma = torch.from_numpy((1 + 0.1 * r.standard_normal(16)).astype(np.float32))
    bias = torch.from_numpy((0.1 * r.standard_normal(16)).astype(np.float32))
    alpha, beta = k1.group_affine(y, gamma, bias)
    w = torch.zeros(3, 3, 16, 32)
    w[1, 1] = torch.eye(16, 32)                  # centre tap copies channels
    out = k5.gn_mish_conv3(y, alpha, beta, w, torch.zeros(32))
    np.testing.assert_allclose(out[..., :16].numpy(),
                               k1.gn_mish_plain(y, gamma, bias).numpy(),
                               atol=1e-6, rtol=1e-6)
    assert out[..., 16:].abs().max() == 0


def test_supported_shape_and_argument_checks():
    for h, cin, cout in ((32, 64, 64), (64, 32, 32), (32, 128, 64),
                         (128, 64, 64), (7, 8, 32)):
        assert k5.supported_shape(h, h, cin, cout)
    assert not k5.supported_shape(32, 32, 12, 64)      # Cin not a multiple of 8
    assert not k5.supported_shape(32, 32, 64, 48)      # Cout not compiled
    y, alpha, beta, w, wb = (torch.from_numpy(a)
                             for a in _inputs(1, 8, 8, 32, seed=0))
    with pytest.raises(ValueError, match=r"\[3, 3, Cin, Cout\]"):
        k5.gn_mish_conv3(y, alpha, beta, w[:, :, :4], wb)
    with pytest.raises(ValueError, match="alpha, beta"):
        k5.gn_mish_conv3(y, alpha[:, :4], beta, w, wb)


def test_cpu_runs_plain_and_other_devices_raise(monkeypatch):
    """A CPU tensor takes the plain version without building anything; a
    tensor elsewhere never falls back to it."""
    def no_build():
        raise AssertionError("the CPU path must not build the kernels")
    monkeypatch.setattr(_build, "library", no_build)
    args = [torch.from_numpy(a) for a in _inputs(1, 8, 8, 32, seed=1)]
    before = k5.launches
    out = k5.gn_mish_conv3(*args)
    assert out.shape == (1, 8, 8, 32) and k5.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        k5.gn_mish_conv3(*(a.to("meta") for a in args))
