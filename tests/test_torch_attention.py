"""K2 forward and the spatial attention module in the PyTorch port
(lunaris_orion_tpu_torch/ops/cuda/flash_attention.py, ops/attention.py):
the plain version (two-pass, and its online form at a kernel's key tile)
against the JAX package's Pallas kernel `attention_bhnd` (interpret mode on
the CPU), the dropout hash bit for bit against `_keep_mask`, the wrapper's
choice of kernel instance, and the module against
`spatial_attention_reference`. The kernels themselves are held against the
plain version on a CUDA card by tests/test_torch_kernels.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lunaris_orion_tpu.ops import attention as jattn
from lunaris_orion_tpu.ops import dispatch
from lunaris_orion_tpu.ops.pallas import flash_attention as fa
from lunaris_orion_tpu_torch.ops.attention import SpatialAttention
from lunaris_orion_tpu_torch.ops.cuda import flash_attention as k2
from lunaris_orion_tpu_torch.parallel import AxisGroup, Parallel
from test_torch_kernels import torch_threads  # noqa: F401 (autouse)


def _qkvb(b, h, nq, nk, d, seed):
    r = np.random.default_rng(seed)
    q = r.standard_normal((b, h, nq, d)).astype(np.float32)
    k = r.standard_normal((b, h, nk, d)).astype(np.float32)
    v = r.standard_normal((b, h, nk, d)).astype(np.float32)
    bias = (0.5 * r.standard_normal((h, nk))).astype(np.float32)
    return q, k, v, bias


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


# (rate, seed, d, n): every rate at d 8 and 16 and N 256 and 2304; d 32 (the
# head size of feature_dim 256) at N 256 for every rate and at N 2304 once;
# d 48 and 64 (the mid-range and H100-tier recipes' feature_dim 384 and 512)
# at N 256, one seed without dropout and one with.
_PARITY = [(rate, seed, d, n)
           for rate, seed in ((0.0, 0), (0.1, 1234567), (0.1, -987654321))
           for d, n in ((8, 256), (8, 2304), (16, 256), (16, 2304), (32, 256))]
_PARITY.append((0.1, 1234567, 32, 2304))
_PARITY += [(rate, seed, d, 256)
            for rate, seed in ((0.0, 0), (0.1, -987654321)) for d in (48, 64)]


@pytest.mark.parametrize("rate,seed,d,n", _PARITY)
def test_plain_matches_pallas(n, d, rate, seed):
    q, k, v, bias = _qkvb(1, 2, n, n, d, seed=n + d)
    want = np.asarray(fa.attention_bhnd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(bias),
        dropout_rate=rate, seed=jnp.int32(seed)))
    got, lse = k2.attention_plain(*_t(q, k, v, bias), dropout_rate=rate,
                                  seed=seed)
    assert lse.shape == (2, n) and torch.isfinite(lse).all()
    # f32 throughout; the plain version's two-pass softmax and the kernel's
    # online one differ in rounding only: atol 1e-5 (|o| is O(1)).
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("n,block_k", [(256, 64), (300, 64), (2304, 32)])
@pytest.mark.parametrize("d", [8, 16])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_online_plain_matches_pallas_and_two_pass(n, block_k, d, rate):
    """The plain version's online form (key blocks of a kernel's tile, p
    taken against the running max) against the Pallas kernel, where
    N % 128 == 0 lets it run, and against the two-pass form; f32, the two
    softmaxes differ in rounding only: atol 1e-5 on o and on lse."""
    q, k, v, bias = _qkvb(1, 2, n, n, d, seed=n + d)
    kw = dict(dropout_rate=rate, seed=77)
    got, lse = k2.attention_plain(*_t(q, k, v, bias), block_k=block_k, **kw)
    ref, rlse = k2.attention_plain(*_t(q, k, v, bias), **kw)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(lse.numpy(), rlse.numpy(), atol=1e-5, rtol=0)
    if n % 128 == 0:
        want = np.asarray(fa.attention_bhnd(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(bias),
            dropout_rate=rate, seed=jnp.int32(77)))
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("n", [256, 300])
@pytest.mark.parametrize("d", [16, 32, 48, 64])
def test_online_plain_at_the_warpgroup_tile(n, d):
    """The online form at the warpgroup bodies' key tile (128 at d 16, 48
    and 64, 64 at d 32), with dropout: against the two-pass form, and
    against the Pallas kernel where N % 128 == 0; f32, atol 1e-5. At d 16
    and 32 it is the narrow body's rounding: p v summed from zero a key
    tile, then o = o corr + p v."""
    q, k, v, bias = _qkvb(1, 2, n, n, d, seed=n + d)
    kw = dict(dropout_rate=0.1, seed=-5)
    inst = k2.forward_instance(BF16, d, n, n, 0.1, body="wgmma")
    got, lse = k2.attention_plain(*_t(q, k, v, bias), block_k=inst.block_k,
                                  **kw)
    ref, rlse = k2.attention_plain(*_t(q, k, v, bias), **kw)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(lse.numpy(), rlse.numpy(), atol=1e-5, rtol=0)
    if n % 128 == 0:
        want = np.asarray(fa.attention_bhnd(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(bias),
            dropout_rate=0.1, seed=jnp.int32(-5)))
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_online_plain_rounds_p_against_the_running_max():
    """In bf16 the online form rounds p before later blocks correct it, so
    it differs from the two-pass form, by less than 2 bf16 ulps of the
    largest output; a q-blocking and a shard at q_offset leave it as it is."""
    q, k, v, bias = _qkvb(2, 2, 300, 300, 16, seed=6)
    tq = [t.bfloat16() for t in _t(q, k, v)] + _t(bias)
    kw = dict(dropout_rate=0.2, seed=5)
    a, lse_a = k2.attention_plain(*tq, block_k=64, **kw)
    two, _ = k2.attention_plain(*tq, **kw)
    diff = (a.float() - two.float()).abs().max().item()
    assert 0 < diff <= 2 * 2.0 ** -7 * two.float().abs().max().item()
    b, lse_b = k2.attention_plain(*tq, block_k=64, max_elems=4 * 64 * 7, **kw)
    assert torch.equal(a, b) and torch.equal(lse_a, lse_b)
    c, _ = k2.attention_plain(tq[0][:, :, 100:], *tq[1:], block_k=64,
                              q_offset=100, **kw)
    assert torch.equal(c, a[:, :, 100:])


BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("dtype,d,nq,nk,rate,want", [
    # the teacher's shape: serving (dropout 0) and training (0.1); bf16
    # takes the narrow warpgroup body, 192 rows and 128 keys a tile, f32 its
    # own warpgroup body, 192 rows and the pre-pass's key tiles of 64
    (BF16, 16, 16384, 16384, 0.0, ("wgmma", 128, 192, 86, "off", False)),
    (BF16, 16, 16384, 16384, 0.1, ("wgmma", 128, 192, 86, "on", False)),
    (F32, 16, 16384, 16384, 0.0, ("wgmma", 64, 192, 86, "off", False)),
    (F32, 16, 16384, 16384, 0.1, ("wgmma", 64, 192, 86, "on", False)),
    # a q shard against the full keys (the context-parallel call)
    (BF16, 16, 4096, 16384, 0.1, ("wgmma", 128, 192, 22, "on", False)),
    # the card tests' shapes: ragged N, the other head sizes
    (BF16, 16, 2000, 2000, 0.0, ("mma", 64, 128, 16, "off", True)),
    (BF16, 16, 2000, 2000, 0.1, ("mma", 64, 128, 16, "on", True)),
    (BF16, 16, 2100, 2100, 0.1, ("wgmma", 128, 192, 11, "on", True)),
    # the windowed fold (Nq = Nk = the window, 256) takes the window body:
    # one block a window, its one key tile the whole window
    (BF16, 16, 256, 256, 0.0, ("window", 256, 256, 1, "off", False)),
    (BF16, 16, 256, 256, 0.1, ("window", 256, 256, 1, "on", False)),
    (BF16, 16, 64, 64, 0.1, ("window", 64, 64, 1, "on", False)),
    # other short rows keep the mma.sync body at d 16: any call with fewer
    # than NARROW_MIN_ROWS of either off the window shapes
    (BF16, 16, 320, 320, 0.0, ("mma", 64, 128, 3, "off", False)),
    (BF16, 16, 256, 512, 0.1, ("mma", 64, 128, 2, "on", False)),
    (F32, 16, 2000, 2000, 0.1, ("mma", 64, 128, 16, "on", True)),
    (F32, 16, 4096, 16384, 0.1, ("wgmma", 64, 192, 22, "on", False)),
    (F32, 16, 2100, 2100, 0.0, ("wgmma", 64, 192, 11, "off", True)),
    (F32, 16, 300, 300, 0.0, ("mma", 64, 128, 3, "off", True)),
    (BF16, 16, 1000, 1024, 0.0, ("mma", 64, 128, 8, "off", False)),
    (BF16, 8, 4096, 4096, 0.1, ("simt", 64, 128, 32, "runtime", True)),
    (BF16, 8, 300, 300, 0.0, ("simt", 64, 128, 3, "runtime", True)),
    # bf16 at d 48 and 64: the warpgroup body, 128 rows and keys a tile,
    # dropout compiled in or out, every Nk in one instance
    (BF16, 48, 4096, 4096, 0.1, ("wgmma", 128, 128, 32, "on", False)),
    (BF16, 64, 1000, 1000, 0.0, ("wgmma", 128, 128, 8, "off", True)),
    (BF16, 64, 16384, 16384, 0.1, ("wgmma", 128, 128, 128, "on", False)),
    (BF16, 48, 8192, 16384, 0.0, ("wgmma", 128, 128, 64, "off", False)),
    # f32 at d 48 and 64: its warpgroup body, 128 rows, the pre-pass's key
    # tiles of 64, where neither Nq nor Nk is under TF32_WGMMA_MIN_ROWS[d];
    # mma.sync's run-time instance (keys in tiles of 32) where one is
    (F32, 48, 4096, 4096, 0.0, ("wgmma", 64, 128, 32, "off", False)),
    (F32, 64, 1000, 1000, 0.1, ("mma", 32, 64, 16, "runtime", True)),
    (F32, 8, 4096, 4096, 0.1, ("simt", 64, 128, 32, "runtime", True)),
    # head size 32 (feature_dim 256, the low-end recipe): bf16 takes the
    # narrow warpgroup body (key tiles of 64) on long rows (the teacher's N
    # at the serving batch and in training, a ragged N, a q shard),
    # mma.sync's one run-time instance on short rows (the windowed fold);
    # f32 its own warpgroup body (192 rows, the pre-pass's key tiles of 64)
    # on long rows, mma.sync's on short ones (a ragged 2000); the fold takes
    # the window body in bf16, in f32 at d 16 and at d 32 without dropout
    # (`window_default`: where it was faster)
    (BF16, 32, 16384, 16384, 0.0, ("wgmma", 64, 192, 86, "off", False)),
    (BF16, 32, 16384, 16384, 0.1, ("wgmma", 64, 192, 86, "on", False)),
    (BF16, 32, 4096, 4096, 0.1, ("wgmma", 64, 192, 22, "on", False)),
    (BF16, 32, 2100, 2100, 0.1, ("wgmma", 64, 192, 11, "on", True)),
    (BF16, 32, 8192, 16384, 0.1, ("wgmma", 64, 192, 43, "on", False)),
    (BF16, 32, 2000, 2000, 0.0, ("wgmma", 64, 192, 11, "off", True)),
    (BF16, 32, 256, 256, 0.1, ("window", 256, 256, 1, "on", False)),
    (BF16, 32, 192, 192, 0.0, ("window", 192, 192, 1, "off", False)),
    (BF16, 32, 32, 32, 0.0, ("mma", 64, 64, 1, "runtime", True)),
    (BF16, 32, 300, 4096, 0.0, ("mma", 64, 64, 5, "runtime", True)),
    (F32, 32, 16384, 16384, 0.1, ("wgmma", 64, 192, 86, "on", False)),
    (F32, 32, 2000, 2000, 0.0, ("mma", 64, 64, 32, "runtime", True)),
    (F32, 32, 4096, 16384, 0.0, ("wgmma", 64, 192, 22, "off", False)),
    (F32, 32, 2100, 2100, 0.1, ("wgmma", 64, 192, 11, "on", True)),
    (F32, 32, 256, 256, 0.1, ("mma", 64, 64, 4, "runtime", True)),
    (F32, 32, 64, 64, 0.0, ("window", 64, 64, 1, "off", False)),
    (F32, 16, 256, 256, 0.0, ("window", 256, 256, 1, "off", False)),
    (F32, 16, 192, 192, 0.1, ("window", 192, 192, 1, "on", False)),
    (F32, 16, 320, 320, 0.1, ("mma", 64, 128, 3, "on", False)),
    (F32, 48, 256, 256, 0.1, ("mma", 32, 64, 4, "runtime", True)),
])
def test_forward_instance(dtype, d, nq, nk, rate, want):
    """The kernel instance is a pure function of (dtype, d, Nq, Nk,
    dropout): bf16 and f32 at d 16 and 32 on the window shapes the window
    bodies where `window_default` says (f32 at d 32 with dropout and at d
    48 keep mma.sync there),
    bf16 at d 16 and 32 (unless Nq or Nk is short), 48 and 64 and
    f32 at d 16, 32, 48 and 64 (unless Nq or Nk is short) take the
    warpgroup bodies, d 16, 32 (and f32 at 48, 64) the tensor cores on
    mma.sync where they are short (f32:
    three TF32 passes, keys in tiles of 32 at d 48 and 64), d 8 the CUDA
    cores; at d 16 dropout and a ragged Nk are compiled in."""
    body, block_k, rows, q_blocks, dropout, ragged = want
    inst = k2.forward_instance(dtype, d, nq, nk, rate)
    assert inst == k2.ForwardInstance(body, d, block_k, rows, q_blocks,
                                      dropout, ragged)
    assert inst == k2.forward_instance(dtype, d, nq, nk, rate)
    assert inst.q_blocks * inst.rows >= nq > (inst.q_blocks - 1) * inst.rows


@pytest.mark.parametrize("d,nq,nk,rate,want", [
    # the earlier f32 instances, which the tensor-core body replaced
    (16, 16384, 16384, 0.0, (64, 128, 128, "off", False)),
    (16, 16384, 16384, 0.1, (64, 128, 128, "on", False)),
    (16, 2000, 2000, 0.1, (64, 128, 16, "on", True)),
    (32, 16384, 16384, 0.1, (32, 128, 128, "runtime", True)),
    (48, 4096, 4096, 0.0, (32, 128, 32, "runtime", True)),
    (64, 1000, 1000, 0.1, (32, 128, 8, "runtime", True)),
])
def test_forward_instance_f32_cuda_cores(d, nq, nk, rate, want):
    """`body="simt"` reaches f32's CUDA-core kernel at every head size, for
    the comparisons of phase 4 and the card tests."""
    block_k, rows, q_blocks, dropout, ragged = want
    inst = k2.forward_instance(F32, d, nq, nk, rate, body="simt")
    assert inst == k2.ForwardInstance("simt", d, block_k, rows, q_blocks,
                                      dropout, ragged)


def test_forward_instance_body_argument():
    """`body="simt"` reaches the CUDA-core kernel where the tensor-core one
    is the default (measurements compare them); nothing else is on offer."""
    old = k2.forward_instance(BF16, 16, 16384, 16384, 0.1, body="simt")
    assert old == k2.ForwardInstance("simt", 16, 64, 128, 128, "on", False)
    assert k2.forward_instance(BF16, 16, 64, 64, 0.0, body="mma").body == "mma"
    assert k2.forward_instance(F32, 16, 64, 64, 0.0, body="mma").body == "mma"
    for d in k2.MMA_HEAD_DIMS:
        assert k2.forward_instance(F32, d, 64, 64, 0.0, body="simt").body == \
            "simt"
    for d in k2.TF32_WGMMA_HEAD_DIMS:
        assert k2.forward_instance(F32, d, 64, 64, 0.0, body="wgmma").body \
            == "wgmma"
    for dtype, d, body in ((F32, 8, "mma"), (BF16, 8, "mma"),
                           (BF16, 64, "simt"), (F32, 8, "wgmma"),
                           (BF16, 32, "simt")):
        with pytest.raises(ValueError, match="does not take"):
            k2.forward_instance(dtype, d, 64, 64, 0.0, body=body)
    for dtype, d in ((torch.float16, 16), (BF16, 24), (F32, 128)):
        with pytest.raises(ValueError, match="no kernel"):
            k2.forward_instance(dtype, d, 64, 64, 0.0)
    # the refusal names the widths a teacher of 8 heads can have
    with pytest.raises(ValueError, match="feature_dim 64, 128, 256, 384, 512"):
        k2.forward_instance(BF16, 24, 64, 64, 0.0)
    assert set(k2.MMA_HEAD_DIMS) < set(k2.HEAD_DIMS)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("w", [64, 128, 192, 256])
@pytest.mark.parametrize("d", [16, 32])
@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "f32"])
def test_window_bodies_take_the_fold(d, w, rate, dtype):
    """bf16 and f32 at d 16 and 32 with Nq = Nk = W, W a multiple of 64 up
    to 256 (the windowed fold at windows 64, 128, 192 and 256) reach the
    window bodies (f32: three TF32 passes, split in the kernel): the
    forward with one key block of W (the plain twin's `block_k`), a window
    a step of a persistent block, dropout compiled in or out; the fused
    backward with the window's W keys and W queries in one warpgroup.
    They are the default where they were faster in turns on the card
    (`window_default`): bf16 both; f32 the forward at d 16, and at d 32
    without dropout, not the backward. The fused variant is the default
    backward. `body` reaches either body, for the turns on the card; the
    split backward keeps its pair (bf16 mma.sync, f32 the CUDA cores).
    Their launches have counters of their own (f32's none of the pre-pass
    or the f32 warpgroup bodies); a CPU tensor takes the plain versions
    and counts nothing."""
    assert k2.window_shape(dtype, d, w, w)
    on = "on" if rate else "off"
    fwd_default = dtype == BF16 or d == 16 or rate == 0.0
    assert k2.window_default(dtype, d, rate) == fwd_default
    assert k2.window_default(dtype, d, rate, backward=True) == (dtype == BF16)
    window_fwd = k2.ForwardInstance("window", d, w, w, 1, on, False)
    window_bwd = k2.FusedInstance("window", d, w, w, 1, on, False)
    assert k2.forward_instance(dtype, d, w, w, rate, body="window") == \
        window_fwd
    assert k2.fused_instance(dtype, d, w, w, rate, body="window") == \
        window_bwd
    assert (k2.forward_instance(dtype, d, w, w, rate) == window_fwd) == \
        fwd_default
    assert (k2.fused_instance(dtype, d, w, w, rate) == window_bwd) == \
        (dtype == BF16)
    assert k2.default_bwd(dtype, d) == "fused"
    assert k2.forward_instance(dtype, d, w, w, rate, body="mma").body == "mma"
    assert k2.fused_instance(dtype, d, w, w, rate, body="mma").body == "mma"
    assert k2.backward_instance(dtype, d, w, w, rate).body == (
        "mma" if dtype == BF16 else "simt")
    with pytest.raises(ValueError, match="does not take"):
        k2.backward_instance(dtype, d, w, w, rate, body="window")
    counts = (k2.window_launches, k2.bwd_window_launches, k2.launches,
              k2.split_launches, k2.tf32_wgmma_launches)
    q, k, v, bias = (t.to(dtype) for t in _t(*_qkvb(1, 2, w, w, d, seed=w)))
    q.requires_grad_()
    o, _ = k2.flash_attention(q, k, v, bias.float(), dropout_rate=rate,
                              seed=3)
    o.float().sum().backward()
    assert torch.isfinite(q.grad.float()).all()
    assert (k2.window_launches, k2.bwd_window_launches, k2.launches,
            k2.split_launches, k2.tf32_wgmma_launches) == counts


@pytest.mark.parametrize("dtype,d,nq,nk", [
    (BF16, 16, 32, 32), (BF16, 16, 320, 320), (BF16, 32, 512, 512),
    (BF16, 16, 256, 128), (BF16, 32, 64, 256), (F32, 48, 256, 256),
    (F32, 64, 64, 64), (BF16, 48, 256, 256), (BF16, 64, 128, 128),
    (BF16, 8, 256, 256), (F32, 16, 320, 320), (F32, 32, 256, 512),
    (F32, 16, 32, 32), (F32, 8, 256, 256)])
def test_window_bodies_leave_other_shapes(dtype, d, nq, nk):
    """Every other shape takes what it took before the window bodies: a
    window under 64 or over 256 or not a multiple of 64, unequal Nq and Nk,
    and both types at d 8, 48 and 64. `body="window"` refuses them."""
    assert not k2.window_shape(dtype, d, nq, nk)
    for rule in (k2.forward_instance, k2.fused_instance):
        assert rule(dtype, d, nq, nk, 0.1).body != "window"
        with pytest.raises(ValueError, match="body 'window' takes"):
            rule(dtype, d, nq, nk, 0.1, body="window")


@pytest.mark.parametrize("d", [48, 64])
def test_warpgroup_bodies_at_the_recipe_head_sizes(d):
    """bf16 at d 48 and 64 (feature_dim 384 and 512 at 8 heads, the docs'
    mid-range and H100-tier recipes) takes the warpgroup bodies: the
    forward with key tiles of 128, the fused backward with 128 keys a block
    and query tiles of 64, and the fused variant by default; `body` still
    reaches the bodies they replaced, for the comparisons in turns."""
    assert d in k2.WGMMA_HEAD_DIMS and set(k2.WGMMA_HEAD_DIMS) == set(
        k2.MMA_HEAD_DIMS)
    fwd = k2.forward_instance(BF16, d, 16384, 16384, 0.1)
    assert (fwd.body, fwd.block_k, fwd.rows) == ("wgmma", 128, 128)
    old = k2.forward_instance(BF16, d, 16384, 16384, 0.1, body="mma")
    assert (old.body, old.block_k, old.rows) == ("mma", 64, 64)
    assert k2.default_bwd(BF16, d) == "fused"
    bwd = k2.fused_instance(BF16, d, 16384, 16384, 0.1)
    assert (bwd.body, bwd.block_q, bwd.rows, bwd.blocks) == (
        "wgmma", 64, 128, 128)
    assert k2.fused_instance(BF16, d, 16384, 16384, 0.1,
                             body="simt").body == "simt"
    # f32 has its own bodies at these head sizes: at 64 rows the forward
    # keeps mma.sync, the fused backward takes its warpgroup body at every N
    # (`test_tf32_warpgroup_bodies_at_the_recipe_widths`)
    assert k2.forward_instance(F32, d, 64, 64, 0.0).body == "mma"
    assert k2.fused_instance(F32, d, 64, 64, 0.0).body == "wgmma"
    assert k2.fused_instance(F32, d, 64, 64, 0.0, body="simt").body == "simt"


@pytest.mark.parametrize("nq,nk,rate", [(16384, 16384, 0.0),
                                         (16384, 16384, 0.1),
                                         (8192, 16384, 0.1), (2000, 300, 0.0),
                                         (256, 256, 0.1)])
def test_narrow_bodies_at_the_default_width(nq, nk, rate):
    """bf16 at d 16 (feature_dim 128 at 8 heads, `TrainConfig()`'s width)
    takes the narrow warpgroup bodies where neither Nq nor Nk is shorter
    than NARROW_MIN_ROWS[16]: the forward with three warpgroups of 64 rows
    and key tiles of 128, the fused backward with 192 keys a block and query
    tiles of 64, the fused variant by default; the windowed fold (N = 256)
    takes the window bodies, other shorter rows keep the mma.sync bodies,
    which `body="mma"` reaches at every shape, as `body="simt"` reaches the
    CUDA-core ones. The split backward has no warpgroup body. Both counters
    count the narrow bodies' launches among the warpgroup ones."""
    assert k2.NARROW_HEAD_DIMS == (16, 32) and 16 in k2.WGMMA_HEAD_DIMS
    long = min(nq, nk) >= k2.NARROW_MIN_ROWS[16]
    fwd = k2.forward_instance(BF16, 16, nq, nk, rate)
    bwd = k2.fused_instance(BF16, 16, nq, nk, rate)
    if long:
        assert (fwd.body, fwd.block_k, fwd.rows) == ("wgmma", 128, 192)
        assert (bwd.body, bwd.block_q, bwd.rows) == ("wgmma", 64, 192)
        assert bwd.blocks == -(-nk // 192)
    elif k2.window_shape(BF16, 16, nq, nk):
        assert (fwd.body, fwd.block_k, fwd.rows) == ("window", nk, nq)
        assert (bwd.body, bwd.block_q, bwd.rows) == ("window", nq, nk)
    else:
        assert (fwd.body, fwd.block_k, fwd.rows) == ("mma", 64, 128)
        assert (bwd.body, bwd.rows) == ("mma", 256)
    assert k2.default_bwd(BF16, 16) == "fused"
    for body in ("wgmma", "mma", "simt"):
        assert k2.forward_instance(BF16, 16, nq, nk, rate, body=body).body \
            == body
        assert k2.fused_instance(BF16, 16, nq, nk, rate, body=body).body \
            == body
    old = k2.forward_instance(BF16, 16, nq, nk, rate, body="mma")
    assert (old.block_k, old.rows, old.dropout) == (
        64, 128, "on" if rate else "off")
    assert k2.backward_instance(BF16, 16, nq, nk, rate).body == "mma"
    with pytest.raises(ValueError, match="does not take"):
        k2.backward_instance(BF16, 16, nq, nk, rate, body="wgmma")
    # f32 has its own bodies at d 16, on its own threshold, and its own
    # window forward on the fold (the backward keeps mma.sync there)
    f32 = "wgmma" if min(nq, nk) >= k2.TF32_WGMMA_MIN_ROWS[16] else "mma"
    assert k2.forward_instance(F32, 16, nq, nk, rate).body == (
        "window" if k2.window_shape(F32, 16, nq, nk) else f32)
    assert k2.fused_instance(F32, 16, nq, nk, rate).body == f32


@pytest.mark.parametrize("nq,nk,rate", [(16384, 16384, 0.0),
                                         (16384, 16384, 0.1),
                                         (8192, 16384, 0.1), (2100, 2100, 0.1),
                                         (2000, 2000, 0.0), (512, 1000, 0.1),
                                         (300, 16384, 0.0), (256, 256, 0.1)])
def test_narrow_bodies_at_the_low_end_width(nq, nk, rate):
    """bf16 at d 32 (feature_dim 256 at 8 heads, the docs' low-end recipe)
    takes the narrow warpgroup bodies where neither Nq nor Nk is shorter
    than NARROW_MIN_ROWS[32] (512: the crossover measured at d 32), as d
    16 does: the forward with three warpgroups of 64 rows and key tiles of
    64, dropout compiled in or out, the fused backward with 192 keys a block
    and query tiles of 64, the fused variant by default. The windowed fold
    (N 256) takes the window bodies; other shorter rows (a q shard of 300
    rows) keep mma.sync's run-time instances (64 rows, 64 keys a block), which
    `body="mma"` reaches at every shape; there is no CUDA-core bf16 body at
    d 32, and the split backward has no warpgroup body. f32 at d 32 has its
    own warpgroup bodies, on its own thresholds."""
    assert 32 in k2.NARROW_HEAD_DIMS and 32 in k2.WGMMA_HEAD_DIMS
    long = min(nq, nk) >= k2.NARROW_MIN_ROWS[32]
    fwd = k2.forward_instance(BF16, 32, nq, nk, rate)
    bwd = k2.fused_instance(BF16, 32, nq, nk, rate)
    if long:
        assert fwd == k2.ForwardInstance("wgmma", 32, 64, 192, -(-nq // 192),
                                         "on" if rate else "off",
                                         nk % 64 != 0)
        assert bwd == k2.FusedInstance("wgmma", 32, 64, 192, -(-nk // 192),
                                       "on" if rate else "off", nq % 64 != 0)
    elif k2.window_shape(BF16, 32, nq, nk):
        assert fwd == k2.ForwardInstance("window", 32, nk, nq, 1,
                                         "on" if rate else "off", False)
        assert bwd == k2.FusedInstance("window", 32, nq, nk, 1,
                                       "on" if rate else "off", False)
    else:
        assert fwd == k2.forward_instance(BF16, 32, nq, nk, rate, body="mma")
        assert bwd == k2.fused_instance(BF16, 32, nq, nk, rate, body="mma")
    assert k2.default_bwd(BF16, 32) == "fused"
    for body in ("wgmma", "mma"):
        assert k2.forward_instance(BF16, 32, nq, nk, rate, body=body).body \
            == body
        assert k2.fused_instance(BF16, 32, nq, nk, rate, body=body).body \
            == body
    old = k2.forward_instance(BF16, 32, nq, nk, rate, body="mma")
    assert (old.block_k, old.rows, old.dropout) == (64, 64, "runtime")
    old = k2.fused_instance(BF16, 32, nq, nk, rate, body="mma")
    assert (old.block_q, old.rows, old.dropout) == (64, 64, "runtime")
    with pytest.raises(ValueError, match="does not take"):
        k2.forward_instance(BF16, 32, nq, nk, rate, body="simt")
    with pytest.raises(ValueError, match="does not take"):
        k2.fused_instance(BF16, 32, nq, nk, rate, body="simt")
    assert k2.backward_instance(BF16, 32, nq, nk, rate).body == "mma"
    with pytest.raises(ValueError, match="does not take"):
        k2.backward_instance(BF16, 32, nq, nk, rate, body="wgmma")
    for rule, rows, fold in (
            (k2.forward_instance, k2.TF32_WGMMA_MIN_ROWS,
             k2.window_shape(F32, 32, nq, nk) and rate == 0.0),
            (k2.fused_instance, k2.TF32_WGMMA_BWD_MIN_ROWS, False)):
        assert rule(F32, 32, nq, nk, rate).body == (
            "window" if fold else
            "wgmma" if min(nq, nk) >= rows[32] else "mma")


@pytest.mark.parametrize("nq,nk,rate", [(16384, 16384, 0.0),
                                         (16384, 16384, 0.1),
                                         (8192, 16384, 0.1), (4096, 4096, 0.1),
                                         (2048, 2048, 0.0), (2047, 16384, 0.1),
                                         (1024, 1024, 0.1), (256, 256, 0.1)])
def test_tf32_warpgroup_bodies_at_the_default_width(nq, nk, rate):
    """f32 at d 16 (the default type and width) takes its warpgroup bodies
    where neither Nq nor Nk is shorter than TF32_WGMMA_MIN_ROWS[16]: the
    forward with three warpgroups of 64 rows on the pre-pass's key tiles of
    64, the fused backward with 128 keys a block and query tiles of 64, the
    fused variant by default. The windowed fold (N 256) takes the f32
    window forward (its backward keeps mma.sync, `window_default`); other
    shorter rows (a 32 px model, N 1024) keep the mma.sync bodies, which
    `body="mma"` reaches at every shape, as `body="simt"` reaches the
    CUDA-core ones;
    f32 at d 32 follows its own thresholds, the split backward and bf16
    keep their bodies (d 32: `test_tf32_warpgroup_bodies_at_the_low_end_width`;
    d 48 and 64: `test_tf32_warpgroup_bodies_at_the_recipe_widths`)."""
    assert k2.TF32_WGMMA_HEAD_DIMS == (16, 32, 48, 64)
    assert k2.TF32_WGMMA_BWD_MIN_ROWS[16] == k2.TF32_WGMMA_MIN_ROWS[16]
    long = min(nq, nk) >= k2.TF32_WGMMA_MIN_ROWS[16]
    fwd = k2.forward_instance(F32, 16, nq, nk, rate)
    bwd = k2.fused_instance(F32, 16, nq, nk, rate)
    if long:
        assert fwd == k2.ForwardInstance("wgmma", 16, 64, 192, -(-nq // 192),
                                         "on" if rate else "off",
                                         nk % 64 != 0)
        assert bwd == k2.FusedInstance("wgmma", 16, 64, 128, -(-nk // 128),
                                       "on" if rate else "off", nq % 64 != 0)
    elif k2.window_shape(F32, 16, nq, nk):
        assert (fwd.body, fwd.block_k, fwd.rows) == ("window", nk, nq)
        assert (bwd.body, bwd.block_q, bwd.rows) == ("mma", 64, 64)
    else:
        assert (fwd.body, fwd.block_k, fwd.rows) == ("mma", 64, 128)
        assert (bwd.body, bwd.block_q, bwd.rows) == ("mma", 64, 64)
    assert k2.default_bwd(F32, 16) == "fused"
    for body in ("wgmma", "mma", "simt"):
        assert k2.forward_instance(F32, 16, nq, nk, rate, body=body).body \
            == body
        assert k2.fused_instance(F32, 16, nq, nk, rate, body=body).body \
            == body
    old = k2.forward_instance(F32, 16, nq, nk, rate, body="mma")
    assert (old.block_k, old.rows) == (64, 128)
    assert k2.backward_instance(F32, 16, nq, nk, rate).body == "simt"
    with pytest.raises(ValueError, match="does not take"):
        k2.backward_instance(F32, 16, nq, nk, rate, body="wgmma")
    fold = k2.window_shape(F32, 32, nq, nk) and rate == 0.0
    assert k2.forward_instance(F32, 32, nq, nk, rate).body == (
        "window" if fold else
        "wgmma" if min(nq, nk) >= k2.TF32_WGMMA_MIN_ROWS[32] else "mma")
    assert k2.forward_instance(F32, 32, nq, nk, rate,
                               body="wgmma").body == "wgmma"
    assert k2.fused_instance(F32, 32, nq, nk, rate).body == (
        "wgmma" if min(nq, nk) >= k2.TF32_WGMMA_BWD_MIN_ROWS[32] else "mma")
    assert k2.forward_instance(BF16, 16, nq, nk, rate) == \
        k2.forward_instance(BF16, 16, nq, nk, rate, body=(
            "window" if k2.window_shape(BF16, 16, nq, nk) else
            "wgmma" if min(nq, nk) >= k2.NARROW_MIN_ROWS[16] else "mma"))


@pytest.mark.parametrize("nq,nk,rate", [(16384, 16384, 0.0),
                                         (16384, 16384, 0.1),
                                         (8192, 16384, 0.1), (4096, 4096, 0.1),
                                         (2100, 2000, 0.0), (1000, 4096, 0.1),
                                         (300, 16384, 0.0), (256, 256, 0.1)])
def test_tf32_warpgroup_bodies_at_the_low_end_width(nq, nk, rate):
    """f32 at d 32 (feature_dim 256: the low-end width, in the CLIs'
    default precision) takes the f32 warpgroup bodies where neither Nq nor
    Nk is shorter than their thresholds (TF32_WGMMA_MIN_ROWS[32] for the
    forward, TF32_WGMMA_BWD_MIN_ROWS[32] for the fused backward): the
    forward with TF32_WGMMA_ROWS[32] rows a block on the pre-pass's key
    tiles of 64, the fused backward with TF32_WGMMA_BWD_KEYS[32] keys a
    block and query tiles of 64, dropout compiled in or out. The windowed
    fold (N 256) takes the f32 window forward without dropout
    (`window_default`); with dropout, and other shorter rows (a short q
    shard), keep the mma.sync bodies in both directions (64 rows a block,
    keys in tiles of 64; 64 keys a block, query tiles of 32; one run-time
    instance each), which `body="mma"` reaches at every shape; the split
    backward stays on the CUDA cores."""
    assert 32 in k2.TF32_WGMMA_HEAD_DIMS and 32 in k2.MMA_FUSED_HEAD_DIMS
    fwd = k2.forward_instance(F32, 32, nq, nk, rate)
    bwd = k2.fused_instance(F32, 32, nq, nk, rate)
    old_fwd = k2.forward_instance(F32, 32, nq, nk, rate, body="mma")
    old_bwd = k2.fused_instance(F32, 32, nq, nk, rate, body="mma")
    assert old_fwd == k2.ForwardInstance("mma", 32, 64, 64, -(-nq // 64),
                                         "runtime", True)
    assert old_bwd == k2.FusedInstance("mma", 32, 32, 64, -(-nk // 64),
                                       "runtime", True)
    rows, keys = k2.TF32_WGMMA_ROWS[32], k2.TF32_WGMMA_BWD_KEYS[32]
    fold = k2.window_shape(F32, 32, nq, nk) and rate == 0.0
    if min(nq, nk) >= k2.TF32_WGMMA_MIN_ROWS[32]:
        assert fwd == k2.ForwardInstance("wgmma", 32, 64, rows, -(-nq // rows),
                                         "on" if rate else "off",
                                         nk % 64 != 0)
    elif fold:
        assert fwd == k2.ForwardInstance("window", 32, nk, nq, 1,
                                         "on" if rate else "off", False)
    else:
        assert fwd == old_fwd
    if min(nq, nk) >= k2.TF32_WGMMA_BWD_MIN_ROWS[32]:
        assert bwd == k2.FusedInstance("wgmma", 32, 64, keys, -(-nk // keys),
                                       "on" if rate else "off", nq % 64 != 0)
    else:
        assert bwd == old_bwd
    # the teacher's N takes the warpgroup bodies, the windowed fold at
    # dropout 0.1 mma.sync
    assert (fwd.body, bwd.body) == (("wgmma", "wgmma") if min(nq, nk) >= 4096
                                    else ("mma", "mma") if max(nq, nk) <= 256
                                    else (fwd.body, bwd.body))
    assert k2.default_bwd(F32, 32) == "fused"
    for body in ("wgmma", "mma", "simt"):
        assert k2.forward_instance(F32, 32, nq, nk, rate, body=body).body \
            == body
        assert k2.fused_instance(F32, 32, nq, nk, rate, body=body).body \
            == body
    assert k2.backward_instance(F32, 32, nq, nk, rate).body == "simt"
    with pytest.raises(ValueError, match="does not take"):
        k2.backward_instance(F32, 32, nq, nk, rate, body="wgmma")


@pytest.mark.parametrize("d", [48, 64])
@pytest.mark.parametrize("nq,nk,rate", [(16384, 16384, 0.0),
                                         (16384, 16384, 0.1),
                                         (8192, 16384, 0.1), (2100, 2100, 0.1),
                                         (1024, 1024, 0.0), (300, 16384, 0.0),
                                         (256, 256, 0.1)])
def test_tf32_warpgroup_bodies_at_the_recipe_widths(d, nq, nk, rate):
    """f32 at d 48 and 64 (feature_dim 384 and 512: the mid-range and
    H100-tier widths, in the CLIs' default precision) takes the f32
    warpgroup bodies where neither Nq nor Nk is shorter than
    TF32_WGMMA_MIN_ROWS[d]: the forward with two warpgroups of 64 rows on
    the pre-pass's key tiles of 64, the fused backward with 64 keys a block
    and query tiles of 64, dropout compiled in or out. Shorter rows keep the
    bodies they replaced, which `body` reaches at every shape: the forward's
    mma.sync one (keys in tiles of 32, one run-time instance); the fused
    backward keeps its warpgroup body at every N (TF32_WGMMA_BWD_MIN_ROWS[d]
    is 0: the CUDA-core body it replaced loses even at N 256)."""
    long = min(nq, nk) >= k2.TF32_WGMMA_MIN_ROWS[d]
    assert k2.TF32_WGMMA_BWD_MIN_ROWS[d] == 0
    fwd = k2.forward_instance(F32, d, nq, nk, rate)
    bwd = k2.fused_instance(F32, d, nq, nk, rate)
    old_fwd = k2.forward_instance(F32, d, nq, nk, rate, body="mma")
    old_bwd = k2.fused_instance(F32, d, nq, nk, rate, body="simt")
    assert (old_fwd.block_k, old_fwd.rows, old_fwd.dropout) == (
        32, 64, "runtime")
    assert (old_bwd.block_q, old_bwd.rows, old_bwd.dropout) == (
        32, 32, "runtime")
    assert bwd == k2.FusedInstance("wgmma", d, 64, 64, -(-nk // 64),
                                   "on" if rate else "off", nq % 64 != 0)
    if long:
        assert fwd == k2.ForwardInstance("wgmma", d, 64, 128, -(-nq // 128),
                                         "on" if rate else "off",
                                         nk % 64 != 0)
    else:
        assert fwd == old_fwd
    assert k2.default_bwd(F32, d) == "fused"
    for body in ("wgmma", "mma"):
        assert k2.forward_instance(F32, d, nq, nk, rate, body=body).body \
            == body
    for body in ("wgmma", "simt"):
        assert k2.fused_instance(F32, d, nq, nk, rate, body=body).body \
            == body
    with pytest.raises(ValueError, match="does not take"):
        k2.fused_instance(F32, d, nq, nk, rate, body="mma")
    assert k2.backward_instance(F32, d, nq, nk, rate).body == "simt"
    with pytest.raises(ValueError, match="does not take"):
        k2.backward_instance(F32, d, nq, nk, rate, body="wgmma")
    assert k2.forward_instance(BF16, d, nq, nk, rate).body == "wgmma"


def test_tf32_tiles_on_the_cpu_take_the_plain_version():
    """The pre-pass's wrapper on CPU tensors is its plain version and does
    not count; its tile counts follow N (the backward's key tiles in
    pairs)."""
    r = np.random.default_rng(0)
    k, v = (torch.from_numpy(r.standard_normal((1, 2, 100, 16)).astype(
        np.float32)) for _ in range(2))
    before = k2.split_launches
    got = k2.tf32_tiles(k2.TF32_FWD, k, v)
    assert k2.split_launches == before
    assert torch.equal(got, k2.tf32_tiles_plain(k2.TF32_FWD, k, v))
    assert got.shape == (2, 2, 4096)
    assert [k2.tf32_tile_count(m, n) for m in (0, 1, 2) for n in (64, 65, 129)] \
        == [1, 2, 3, 1, 2, 3, 2, 2, 4]
    with pytest.raises(ValueError, match=r"head size in \(16, 32, 48, 64\)"):
        k2.tf32_tiles(k2.TF32_FWD, k[..., :8], v[..., :8])


def test_rectangular_q_offset_matches_pallas():
    """A shard of q rows (Nq = N/2) at q_offset against the full keys: the
    context-parallel call. Dropout masks must see absolute q positions."""
    n, d, rate, seed = 2304, 8, 0.1, 42
    q, k, v, bias = _qkvb(1, 2, n, n, d, seed=9)
    qs, off = q[:, :, n // 2:], n // 2
    want = np.asarray(fa.attention_bhnd(
        jnp.asarray(qs), jnp.asarray(k), jnp.asarray(v), jnp.asarray(bias),
        dropout_rate=rate, seed=jnp.int32(seed), q_offset=jnp.int32(off)))
    got, _ = k2.attention_plain(*_t(qs, k, v, bias), dropout_rate=rate,
                                seed=seed, q_offset=off)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    full, _ = k2.attention_plain(*_t(q, k, v, bias), dropout_rate=rate,
                                 seed=seed)
    torch.testing.assert_close(got, full[:, :, n // 2:], atol=1e-6, rtol=0)


def test_row_offset_and_blocking_do_not_change_the_result():
    q, k, v, bias = _qkvb(2, 2, 300, 300, 8, seed=4)
    tq = _t(q, k, v, bias)
    a, lse_a = k2.attention_plain(*tq, dropout_rate=0.2, seed=5)
    b, lse_b = k2.attention_plain(*tq, dropout_rate=0.2, seed=5,
                                  max_elems=4 * 300 * 7)   # 7-row q blocks
    torch.testing.assert_close(a, b, atol=1e-6, rtol=0)
    torch.testing.assert_close(lse_a, lse_b, atol=1e-6, rtol=0)
    # batch row 1 alone, numbered as row 1 of the full call
    c, _ = k2.attention_plain(*_t(q[1:], k[1:], v[1:], bias),
                              dropout_rate=0.2, seed=5, row_offset=2)
    torch.testing.assert_close(c, a[1:], atol=1e-6, rtol=0)


def test_keep_mask_bit_exact_with_int32_wraparound():
    """The torch hash equals `_keep_mask` bit for bit, over random seeds and
    coordinates near 2**31, where int32 arithmetic wraps."""
    r = np.random.default_rng(0)
    for keep in (0.9, 0.5, 1.0 - 1e-17):
        for _ in range(4):
            rs = int(r.integers(-2**31, 2**31, dtype=np.int64))
            k0 = int(r.integers(0, 2**31 - 64))
            q0 = int(r.integers(0, 2**31 - 64))
            if _ == 0:
                k0, q0 = 2**31 - 40, 2**31 - 30   # k0+63 and q0+63 wrap
            want = np.asarray(fa._keep_mask(jnp.int32(rs), jnp.int32(k0),
                                            jnp.int32(q0), (64, 64), keep))
            k_abs = torch.arange(k0, k0 + 64, dtype=torch.int64)[:, None]
            q_abs = torch.arange(q0, q0 + 64, dtype=torch.int64)[None, :]
            got = k2.keep_mask(torch.tensor(rs & 0xFFFFFFFF), k_abs, q_abs,
                               k2.dropout_threshold(keep))
            np.testing.assert_array_equal(got.numpy(), want)


def test_row_seeds_match_pallas():
    for seed in (0, 7, -5, 2**31 - 1, -2**31):
        want = np.asarray(fa._row_seeds(jnp.int32(seed), 6, jnp.int32(3)))
        got = k2.row_seeds(seed, 6, 3)
        np.testing.assert_array_equal(
            got.numpy(), want[:, 0, 0].astype(np.int64) & 0xFFFFFFFF)


def test_cpu_tensor_takes_plain_version_and_does_not_count():
    tq = _t(*_qkvb(1, 2, 64, 64, 8, seed=1))
    before = k2.launches
    o, lse = k2.flash_attention(*tq)
    assert k2.launches == before
    o2, lse2 = k2.attention_plain(*tq)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)


def test_other_device_raises():
    q = torch.empty(1, 2, 64, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        k2.flash_attention(q, q, q, torch.empty(2, 64, device="meta"))


# --- the attention module -------------------------------------------------

def _module_pair(channels, heads, key):
    jp = jattn.attention_init(jax.random.PRNGKey(key), channels,
                              num_heads=heads, rel_pos_size=4)
    # rel-pos at N(0, 0.02^2) barely moves the scores; widen it so the
    # per-key bias is exercised.
    jp = dict(jp, rel_pos_h=jp["rel_pos_h"] * 25, rel_pos_w=jp["rel_pos_w"] * 25)
    m = SpatialAttention(channels, heads, rel_pos_size=4)
    conv = lambda p: (torch.from_numpy(np.array(p["w"]).transpose(3, 2, 0, 1).copy()),
                      torch.from_numpy(np.array(p["b"])))
    with torch.no_grad():
        m.qkv.weight.copy_(conv(jp["qkv"])[0])
        m.qkv.bias.copy_(conv(jp["qkv"])[1])
        m.proj.weight.copy_(conv(jp["proj"])[0])
        m.proj.bias.copy_(conv(jp["proj"])[1])
        m.rel_pos_h.copy_(torch.from_numpy(np.array(jp["rel_pos_h"]))[None, :, :, None])
        m.rel_pos_w.copy_(torch.from_numpy(np.array(jp["rel_pos_w"]))[None, :, None, :])
    return jp, m.eval()


@pytest.mark.parametrize("hw", [32, 48])
def test_spatial_attention_matches_reference(hw):
    """N = 1024 runs the full path on both sides; N = 2304 runs K2's plain
    version here and the Pallas kernel (interpret mode) in JAX."""
    jp, m = _module_pair(16, 2, key=hw)
    x = np.random.default_rng(hw).standard_normal((2, hw, hw, 16)).astype(np.float32)
    if hw * hw > 1024:
        dispatch.set_override("attention", "pallas")
    try:
        want = np.asarray(jattn.spatial_attention_reference(
            jp, jnp.asarray(x), num_heads=2))
    finally:
        dispatch.set_override("attention", None)
    with torch.no_grad():
        got = m(torch.from_numpy(x))
    # f32; conv, softmax and blocking orders differ: atol 1e-5, rtol 1e-4.
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-4)


def test_rel_pos_bias_matches_reference():
    r = np.random.default_rng(2)
    ph, pw = (r.standard_normal((3, 8)).astype(np.float32) for _ in range(2))
    from lunaris_orion_tpu_torch.ops.attention import rel_pos_bias
    for h, w in ((8, 8), (13, 5), (1, 7), (128, 128)):
        want = np.asarray(jattn.rel_pos_bias(
            {"rel_pos_h": jnp.asarray(ph), "rel_pos_w": jnp.asarray(pw)}, h, w))
        got = rel_pos_bias(torch.from_numpy(ph), torch.from_numpy(pw), h, w)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


def test_windowed_and_context_parallel_modes_raise():
    """Windowed attention runs since it was ported (against the JAX
    package's windowed path at atol 1e-5, rtol 1e-4; a non-positive window
    raises ValueError). Context parallelism raises by the JAX package's
    rules (tests/test_ring_attention.py): without a context-parallel axis,
    with a token count the axis size does not divide, or with a window."""
    jp, m = _module_pair(16, 2, key=0)
    x = np.random.default_rng(0).standard_normal((1, 8, 8, 16)).astype(
        np.float32)
    want = np.asarray(jattn.spatial_attention_reference(
        jp, jnp.asarray(x), num_heads=2, window=16))
    with torch.no_grad():
        got = m(torch.from_numpy(x), window=16)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-4)
    with pytest.raises(ValueError, match="positive"):
        m(torch.from_numpy(x), window=0)
    for impl in ("ring", "allgather"):
        with pytest.raises(ValueError, match="needs cp_mesh"):
            m(torch.from_numpy(x), impl=impl)
        three = Parallel(cp=AxisGroup(None, 0, 3, (0, 1, 2)))
        with pytest.raises(ValueError, match="not divisible"):
            m(torch.from_numpy(x), impl=impl, par=three)
        with pytest.raises(ValueError, match="cannot combine"):
            m(torch.from_numpy(x), impl=impl, window=16, par=three)
