"""The port's context-parallel attention (lunaris_orion_tpu_torch/parallel)
against the JAX package's, on the CPU.

The JAX side runs in this process on the forced host devices of
tests/conftest.py; the port's side runs in 4 gloo ranks (a (2, 2) mesh)
started with `torch.multiprocessing` spawn, which import torch only (this
module imports JAX inside its tests, so a rank that imports it by name
pulls in no JAX). One spawn runs every check of the port's side and writes
its results to a file a rank; the comparisons run here. Every tolerance is
stated beside its comparison."""

import functools

import numpy as np
import pytest
import torch
from test_torch_kernels import torch_threads  # noqa: F401 (autouse)

B, H, N, D = 4, 2, 64, 8
SEED = 321
RATE = 0.25
# The port's modes: the ring, allgather on K2 (its plain twin here) and
# allgather without a kernel (`--no-use_pallas`: the gathered keys folded
# as the ring folds them).
MODES = {"ring": dict(mode="ring"), "allgather": dict(mode="allgather"),
         "allgather_fold": dict(mode="allgather", use_kernel=False)}


def _inputs():
    r = np.random.default_rng(0)
    q, k, v = (r.standard_normal((B, H, N, D)).astype(np.float32)
               for _ in range(3))
    bias = (r.standard_normal((H, N)) * 0.1).astype(np.float32)
    return q, k, v, bias


def _ranks(rank, path):
    """One rank of the (2, 2) mesh (row-major over the ranks, as the JAX
    package lays devices out; a shape that is not the world's raises): each
    model row runs every mode on the whole batch (b0 = 0), with and without
    dropout, with gradients; then on its data-axis half of the batch (b0 =
    its first global row)."""
    torch.set_num_threads(1)
    from lunaris_orion_tpu_torch.parallel import (close_mesh, init_mesh,
                                                  make_mesh)
    from lunaris_orion_tpu_torch.parallel import collectives as col
    from lunaris_orion_tpu_torch.parallel.ring_attention import (
        ring_attention_sharded)
    mesh = init_mesh((2, 2), device="cpu")
    out = {}
    try:
        for shape in ((3, 1), (4,)):
            try:
                make_mesh(shape)
            except ValueError:
                pass
            else:
                raise AssertionError(f"make_mesh{shape} on 4 ranks")
        assert (mesh.data.ranks, mesh.model.ranks) == (
            ((0, 2), (1, 3))[rank % 2], ((0, 1), (2, 3))[rank // 2])
        m = mesh.model
        # The collectives' gradients: all_gather_tiled's is the summed
        # cotangent's own slice, ppermute's the inverse rotation.
        x = torch.full((2,), float(m.index + 1), requires_grad=True)
        w = torch.arange(4.0) * (m.index + 1)
        (col.all_gather_tiled(x, m, 0) * w).sum().backward()
        total = torch.arange(4.0) * 3
        assert torch.equal(x.grad, total[2 * m.index:2 * m.index + 2])
        x = torch.full((2,), float(m.index), requires_grad=True)
        y = col.ppermute(x, m, [(1, 0), (0, 1)])
        assert torch.equal(y.detach(), torch.full((2,), float(1 - m.index)))
        (y * (m.index + 1)).sum().backward()
        assert torch.equal(x.grad, torch.full((2,), float(2 - m.index)))

        inputs = [torch.from_numpy(a) for a in _inputs()]
        for mode, kw in MODES.items():
            for rate in (0.0, RATE):
                xs = [t.clone().requires_grad_() for t in inputs]
                o = ring_attention_sharded(
                    *xs, axis=m, dropout_rate=rate,
                    seed=SEED if rate else None, **kw)
                o.sin().sum().backward()
                tag = f"{mode}_{rate}"
                out[f"{tag}_out"] = o.detach().numpy()
                for name, t in zip(("q", "k", "v", "bias"), xs):
                    out[f"{tag}_d{name}"] = t.grad.numpy()
            bl = B // mesh.data.size
            rows = slice(mesh.data.index * bl, (mesh.data.index + 1) * bl)
            with torch.no_grad():
                o = ring_attention_sharded(
                    *(t[rows] for t in inputs[:3]), inputs[3], axis=m,
                    dropout_rate=RATE, seed=SEED, b0=mesh.data.index * bl,
                    **kw)
            out[f"{mode}_rows_out"] = o.numpy()
        np.savez(path / f"rank{rank}.npz", **out)
    finally:
        close_mesh()


@pytest.fixture(scope="module")
def port_results(tmp_path_factory):
    from lunaris_orion_tpu_torch.parallel.launch import spawn
    path = tmp_path_factory.mktemp("cp")
    spawn(_ranks, 4, (path,))
    return [dict(np.load(path / f"rank{r}.npz")) for r in range(4)]


def _jax_mesh(shape, names):
    import jax
    from jax.sharding import Mesh
    n = int(np.prod(shape))
    return Mesh(np.asarray(jax.devices()[:n]).reshape(shape), names)


@functools.lru_cache(maxsize=None)
def _jax_sharded(mode, rate):
    """The JAX package's `ring_attention_sharded` on a 2-device mesh: the
    output and the gradients of sum(sin(out)) in q, k, v and the bias."""
    import jax
    import jax.numpy as jnp
    from lunaris_orion_tpu.parallel import ring_attention as ra
    q, k, v, bias = (jnp.asarray(a) for a in _inputs())
    kw = dict(mesh=_jax_mesh((2,), ("seq",)), axis="seq", dropout_rate=rate,
              mode=mode, seed=jnp.int32(SEED) if rate else None)
    out = ra.ring_attention_sharded(q, k, v, bias, **kw)
    grads = jax.grad(lambda *a: jnp.sum(jnp.sin(ra.ring_attention_sharded(
        *a, **kw))), argnums=(0, 1, 2, 3))(q, k, v, bias)
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("rate", [0.0, RATE])
def test_sharded_attention_matches_jax(port_results, mode, rate):
    """`ring_attention_sharded` on a 2-device JAX mesh against the port's
    over a model axis of 2 ranks (allgather_fold: the port's allgather
    without K2, against the JAX allgather): the output and the gradients
    of sum(sin(out)) in q, k, v and the bias at atol 1e-5 / rtol 1e-5
    (f32), with dropout 0 and with K2's hash dropout at 0.25 (a mask that
    differed in one element would move the output by a whole
    probability). The gradients leave the region whole: the same on every
    rank of the mesh, bit for bit."""
    want, grads = _jax_sharded(MODES[mode]["mode"], rate)
    tag = f"{mode}_{rate}"
    for r, got in enumerate(port_results):
        np.testing.assert_allclose(got[f"{tag}_out"], want, atol=1e-5,
                                   rtol=1e-5, err_msg=f"rank {r}")
        for name, g in zip(("q", "k", "v", "bias"), grads):
            np.testing.assert_allclose(got[f"{tag}_d{name}"], g, atol=1e-5,
                                       rtol=1e-5, err_msg=f"rank {r} d{name}")
            np.testing.assert_array_equal(got[f"{tag}_d{name}"],
                                          port_results[0][f"{tag}_d{name}"])


@pytest.mark.parametrize("mode", list(MODES))
def test_batch_axis_dropout_global_rows(port_results, mode):
    """tests/test_ring_attention.py's case with a data axis: the batch split
    over 2 data ranks and the tokens over 2 model ranks, dropout 0.25.
    Each rank's rows seed from their global batch rows, so each data
    rank's output is its rows of the JAX package's (a (2, 2) JAX mesh with
    batch_axis="data"), at atol 1e-5 / rtol 1e-5."""
    import jax.numpy as jnp
    from lunaris_orion_tpu.parallel import ring_attention as ra
    q, k, v, bias = (jnp.asarray(a) for a in _inputs())
    want = np.asarray(ra.ring_attention_sharded(
        q, k, v, bias, mesh=_jax_mesh((2, 2), ("data", "seq")), axis="seq",
        dropout_rate=RATE, seed=jnp.int32(SEED), batch_axis="data",
        mode=MODES[mode]["mode"]))
    bl = B // 2
    for r, got in enumerate(port_results):
        d = r // 2
        np.testing.assert_allclose(got[f"{mode}_rows_out"],
                                   want[d * bl:(d + 1) * bl], atol=1e-5,
                                   rtol=1e-5, err_msg=f"rank {r}")


@pytest.mark.parametrize("b0", [0, 3])
def test_keep_mask_bit_identical_to_jax(b0):
    """The port's `keep_mask_qk` / `row_seed_bh` against the JAX package's
    `_keep_mask_qk` / `_row_seed_bh` on a q shard at an offset against a
    chunk of keys at another, rows from global batch row b0: the same
    bits."""
    import jax.numpy as jnp
    from lunaris_orion_tpu.parallel import ring_attention as ra
    from lunaris_orion_tpu_torch.parallel import ring_attention as pra
    keep = 1.0 - RATE
    want = ra._keep_mask_qk(
        ra._row_seed_bh(jnp.int32(SEED), 2, 3, jnp.int32(b0)),
        jnp.int32(32), jnp.int32(96), 16, 64, keep)
    got = pra.keep_mask_qk(pra.row_seed_bh(SEED, 2, 3, b0), 32, 96, 16, 64,
                           keep)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
