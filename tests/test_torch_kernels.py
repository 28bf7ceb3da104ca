"""The PyTorch port's hand-written CUDA kernels against their plain PyTorch
versions, on a CUDA card. Without one every test here skips.

This file imports torch and the port only (no jax), so it also runs on a
machine without jax, skipping the repository's jax-based conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels.py
"""

import numpy as np
import pytest
import torch

from lunaris_orion_tpu_torch.ops.cuda import flash_attention as k2
from lunaris_orion_tpu_torch.ops.cuda import gn_mish as k1


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
