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
# head size of feature_dim 256) at N 256 for every rate and at N 2304 once.
_PARITY = [(rate, seed, d, n)
           for rate, seed in ((0.0, 0), (0.1, 1234567), (0.1, -987654321))
           for d, n in ((8, 256), (8, 2304), (16, 256), (16, 2304), (32, 256))]
_PARITY.append((0.1, 1234567, 32, 2304))


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
    # the teacher's shape: serving (dropout 0) and training (0.1)
    (BF16, 16, 16384, 16384, 0.0, ("mma", 64, 128, 128, "off", False)),
    (BF16, 16, 16384, 16384, 0.1, ("mma", 64, 128, 128, "on", False)),
    (F32, 16, 16384, 16384, 0.0, ("simt", 64, 128, 128, "off", False)),
    (F32, 16, 16384, 16384, 0.1, ("simt", 64, 128, 128, "on", False)),
    # a q shard against the full keys (the context-parallel call)
    (BF16, 16, 4096, 16384, 0.1, ("mma", 64, 128, 32, "on", False)),
    # the card tests' shapes: ragged N, the other head sizes
    (BF16, 16, 2000, 2000, 0.0, ("mma", 64, 128, 16, "off", True)),
    (BF16, 16, 2000, 2000, 0.1, ("mma", 64, 128, 16, "on", True)),
    (F32, 16, 2000, 2000, 0.1, ("simt", 64, 128, 16, "on", True)),
    (BF16, 16, 1000, 1024, 0.0, ("mma", 64, 128, 8, "off", False)),
    (BF16, 8, 4096, 4096, 0.1, ("simt", 64, 128, 32, "runtime", True)),
    (BF16, 8, 300, 300, 0.0, ("simt", 64, 128, 3, "runtime", True)),
    (BF16, 48, 4096, 4096, 0.1, ("mma", 64, 64, 64, "runtime", True)),
    (BF16, 64, 1000, 1000, 0.0, ("mma", 64, 64, 16, "runtime", True)),
    (F32, 48, 4096, 4096, 0.0, ("simt", 32, 128, 32, "runtime", True)),
    (F32, 64, 1000, 1000, 0.1, ("simt", 32, 128, 8, "runtime", True)),
    (F32, 8, 4096, 4096, 0.1, ("simt", 64, 128, 32, "runtime", True)),
    # head size 32 (feature_dim 256): one run-time instance a body
    (BF16, 32, 4096, 4096, 0.1, ("mma", 64, 64, 64, "runtime", True)),
    (BF16, 32, 2000, 2000, 0.0, ("mma", 64, 64, 32, "runtime", True)),
    (F32, 32, 16384, 16384, 0.1, ("simt", 32, 128, 128, "runtime", True)),
])
def test_forward_instance(dtype, d, nq, nk, rate, want):
    """The kernel instance is a pure function of (dtype, d, Nq, Nk,
    dropout): bf16 at d 16, 32, 48, 64 takes the tensor cores, the rest the
    CUDA cores; at d 16 dropout and a ragged Nk are compiled in."""
    body, block_k, rows, q_blocks, dropout, ragged = want
    inst = k2.forward_instance(dtype, d, nq, nk, rate)
    assert inst == k2.ForwardInstance(body, d, block_k, rows, q_blocks,
                                      dropout, ragged)
    assert inst == k2.forward_instance(dtype, d, nq, nk, rate)
    assert inst.q_blocks * inst.rows >= nq > (inst.q_blocks - 1) * inst.rows


def test_forward_instance_body_argument():
    """`body="simt"` reaches the CUDA-core kernel where the tensor-core one
    is the default (measurements compare them); nothing else is on offer."""
    old = k2.forward_instance(BF16, 16, 16384, 16384, 0.1, body="simt")
    assert old == k2.ForwardInstance("simt", 16, 64, 128, 128, "on", False)
    assert k2.forward_instance(BF16, 16, 64, 64, 0.0, body="mma").body == "mma"
    for dtype, d, body in ((F32, 16, "mma"), (BF16, 8, "mma"),
                           (BF16, 64, "simt"), (BF16, 16, "wgmma")):
        with pytest.raises(ValueError, match="does not take"):
            k2.forward_instance(dtype, d, 64, 64, 0.0, body=body)
    for dtype, d in ((torch.float16, 16), (BF16, 24), (F32, 128)):
        with pytest.raises(ValueError, match="no kernel"):
            k2.forward_instance(dtype, d, 64, 64, 0.0)
    # the refusal names the widths a teacher of 8 heads can have
    with pytest.raises(ValueError, match="feature_dim 64, 128, 256, 384, 512"):
        k2.forward_instance(BF16, 24, 64, 64, 0.0)
    assert set(k2.MMA_HEAD_DIMS) < set(k2.HEAD_DIMS)


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
    _, m = _module_pair(16, 2, key=0)
    x = torch.zeros(1, 8, 8, 16)
    with pytest.raises(NotImplementedError):
        m(x, window=16)
    with pytest.raises(NotImplementedError):
        m(x, impl="allgather")
