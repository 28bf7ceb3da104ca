"""K3 in the PyTorch port (lunaris_orion_tpu_torch/ops/cuda/loss_epilogue.py):
the plain version of the kernel's order of summation against the plain
version and the JAX package's Pallas kernel `mse_kl_pallas` (interpret mode
on the CPU), the launch geometry, and the wrapper's device contract. The
kernel itself is held against both plain versions on a CUDA card by
tests/test_torch_kernels.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lunaris_orion_tpu.ops.pallas.loss_epilogue import mse_kl_pallas
from lunaris_orion_tpu_torch.ops.cuda import _build
from lunaris_orion_tpu_torch.ops.cuda import loss_epilogue as k3


def _inputs(shape, latent, dtype, seed):
    """recon, x, mu, logvar as torch tensors of `dtype` and the same values
    as f32 numpy arrays (exact in bf16 when dtype is bf16)."""
    r = np.random.default_rng(seed)
    vals = [r.uniform(-1, 1, shape), r.uniform(-1, 1, shape),
            r.uniform(-2, 2, (shape[0], latent)),
            r.uniform(-1, 1, (shape[0], latent))]
    ts = [torch.from_numpy(v.astype(np.float32)).to(dtype) for v in vals]
    return ts, [t.float().numpy() for t in ts]


# B 1 and 3: n_img 105, so n is no multiple of the vector (a tail of values
# after the last whole vector); B 16: no tail. L 1, 3, 256.
@pytest.mark.parametrize("shape", [(1, 5, 7, 3), (3, 5, 7, 3),
                                   (16, 8, 8, 3)])
@pytest.mark.parametrize("latent", [1, 3, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_blocked_order_matches_plain_and_pallas(shape, latent, dtype):
    """The kernel's order of summation (each thread's slice, a fixed tree
    over a block, the blocks in index order) for the vector and the scalar
    form and for one block or many, against `mse_kl_plain` (rel 1e-6: f32
    sums in another order) and the JAX package's kernel in interpret mode
    (rel 1e-5: its per-sample sums, then its own means)."""
    ts, arrays = _inputs(shape, latent, dtype, seed=sum(shape) + latent)
    plain = k3.mse_kl_plain(*ts)
    jax_dtype = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    pallas = mse_kl_pallas(*(jnp.asarray(a, dtype=jax_dtype) for a in arrays))
    n, m = ts[0].numel(), ts[2].numel()
    seen = set()
    for sms in (132, 1):
        for aligned in (True, False):
            geo = k3.geometry(n, m, ts[0].element_size(), sms, aligned)
            seen.add(geo)
            got = k3.mse_kl_blocked_plain(*ts, geo)
            for g, p, j in zip(got, plain, pallas):
                assert g.dtype == torch.float32 and g.dim() == 0
                torch.testing.assert_close(g, p, atol=0, rtol=1e-6)
                np.testing.assert_allclose(float(g), float(j), rtol=1e-5)
    assert len({g.vec for g in seen}) == 2


@pytest.mark.parametrize("n,m,itemsize,sms,want", [
    (16 * 128 * 128 * 3, 16 * 256, 4, 132, (4, 264)),
    (16 * 128 * 128 * 3, 16 * 256, 2, 132, (8, 192)),
    (105, 3, 4, 132, (4, 1)),
    (5000, 1, 4, 2, (4, 3)),
    (128 * 128 * 128 * 3, 128 * 256, 2, 1000, (8, 1024))])
def test_geometry(n, m, itemsize, sms, want):
    """Two blocks an SM, fewer where there is less than a vector a thread,
    never more than the last block stages (MAX_BLOCKS)."""
    geo = k3.geometry(n, m, itemsize, sms)
    assert (geo.vec, geo.blocks) == want
    assert k3.geometry(n, m, itemsize, sms, aligned=False).vec == 1


def test_cpu_tensors_take_plain_version_and_do_not_count(monkeypatch):
    """CPU tensors go to `mse_kl_plain`, bit for bit, build nothing and
    count no launch; gradients flow; other devices and the comparison entry
    on the CPU raise."""
    def no_build():
        raise AssertionError("the CPU path must not build the kernels")
    monkeypatch.setattr(_build, "library", no_build)
    ts, _ = _inputs((2, 4, 4, 3), 8, torch.float32, seed=5)
    ts = [t.requires_grad_() for t in ts]
    before = k3.launches
    got = k3.mse_kl(*ts)
    assert k3.launches == before
    for g, r in zip(got, k3.mse_kl_plain(*ts)):
        assert torch.equal(g, r)
    (got[0] + got[1]).backward()
    assert all(t.grad is not None for t in ts)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        k3.mse_kl_kernel(*ts)
    with pytest.raises(ValueError, match="unsupported device"):
        k3.mse_kl(*(t.detach().to("meta") for t in ts))
