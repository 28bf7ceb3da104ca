"""K2's backward in the PyTorch port (lunaris_orion_tpu_torch/ops/cuda/
flash_attention.py): the gradients of `flash_attention`, which on the CPU
run `attention_bwd_plain`, against `jax.grad` of the JAX package's Pallas
kernel `attention_bhnd` (interpret mode on the CPU) through both of its
backward decompositions. The kernels themselves are held against the plain
version on a CUDA card by tests/test_torch_kernels.py."""

import jax
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
    return q, k, v, bias, do


def _jax_grads(q, k, v, bias, do, **kw):
    def loss(q, k, v, bias):
        o = fa.attention_bhnd(q, k, v, bias, **kw)
        return jnp.sum(o * jnp.asarray(do))
    return [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2, 3))(
        *map(jnp.asarray, (q, k, v, bias)))]


def _port_grads(q, k, v, bias, do, **kw):
    ts = [torch.from_numpy(x).requires_grad_() for x in (q, k, v, bias)]
    o, _ = k2.flash_attention(*ts, **kw)
    o.backward(torch.from_numpy(do))
    return [t.grad.numpy() for t in ts]


# (rate, seed, d, n, fused): every case at d 8 and 16 and N 256 and 2304; d 32
# (the head size of feature_dim 256) at N 256 for every (rate, fused) and at
# N 2304 once.
_PARITY = [(rate, seed, d, n, fused)
           for rate, seed in ((0.0, 0), (0.1, -987654321))
           for d, n in ((8, 256), (8, 2304), (16, 256), (16, 2304), (32, 256))
           for fused in ("1", "0")]
_PARITY.append((0.1, -987654321, 32, 2304, "1"))


@pytest.mark.parametrize("rate,seed,d,n,fused", _PARITY)
def test_grads_match_pallas(monkeypatch, fused, n, d, rate, seed):
    """dq, dk, dv and dbias against both TPU backward decompositions
    (LUNARIS_ATTN_FUSED_BWD=1: `_bwd_fused_kernel`; 0: `_bwd_dq_kernel` +
    `_bwd_dkv_kernel`)."""
    monkeypatch.setenv("LUNARIS_ATTN_FUSED_BWD", fused)
    q, k, v, bias, do = _inputs(1, 2, n, n, d, seed=n + d)
    want = _jax_grads(q, k, v, bias, do, dropout_rate=rate,
                      seed=jnp.int32(seed))
    got = _port_grads(q, k, v, bias, do, dropout_rate=rate, seed=seed)
    # f32 throughout; blockings and summation orders differ: atol 1e-5.
    for name, g, w in zip(("dq", "dk", "dv", "dbias"), got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=0, err_msg=name)


@pytest.mark.parametrize("fused", ["1", "0"])
def test_rectangular_q_offset_grads_match_pallas(monkeypatch, fused):
    """A shard of q rows (Nq = N/2) at q_offset against all N keys, with
    dropout: the backward must regenerate masks at absolute q positions."""
    monkeypatch.setenv("LUNARIS_ATTN_FUSED_BWD", fused)
    n, d, rate, seed = 2304, 8, 0.1, 42
    q, k, v, bias, do = _inputs(1, 2, n // 2, n, d, seed=9)
    kw = dict(dropout_rate=rate, seed=seed)
    want = _jax_grads(q, k, v, bias, do, dropout_rate=rate,
                      seed=jnp.int32(seed), q_offset=jnp.int32(n // 2))
    got = _port_grads(q, k, v, bias, do, q_offset=n // 2, **kw)
    for name, g, w in zip(("dq", "dk", "dv", "dbias"), got, want):
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=0, err_msg=name)


def test_blocking_and_row_offset_do_not_change_the_grads():
    """attention_bwd_plain's q blocking (max_elems) changes sums' order
    only; batch row 1 alone, numbered as row 1 of the full call
    (row_offset), gets row 1's gradients."""
    q, k, v, bias, do = (torch.from_numpy(x) for x in
                         _inputs(2, 2, 300, 300, 8, seed=4))
    kw = dict(dropout_rate=0.2, seed=5)
    o, lse = k2.attention_plain(q, k, v, bias, **kw)
    full = k2.attention_bwd_plain(q, k, v, bias, o, lse, do, **kw)
    blocked = k2.attention_bwd_plain(q, k, v, bias, o, lse, do,
                                     max_elems=4 * 300 * 7, **kw)
    for a, b in zip(full, blocked):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0)
    o1, lse1 = k2.attention_plain(q[1:], k[1:], v[1:], bias, row_offset=2,
                                  **kw)
    row = k2.attention_bwd_plain(q[1:], k[1:], v[1:], bias, o1, lse1, do[1:],
                                 row_offset=2, **kw)
    for a, b in zip(row[:3], full[:3]):
        torch.testing.assert_close(a, b[1:], atol=1e-6, rtol=0)


def test_bf16_plain_rounds_like_the_kernels():
    """bf16: dq, dk, dv come back in bf16 and track the f32 gradients
    within bf16's precision through ~N-term sums."""
    q, k, v, bias, do = (torch.from_numpy(x) for x in
                         _inputs(1, 2, 256, 256, 16, seed=6))
    o, lse = k2.attention_plain(q, k, v, bias)
    g32 = k2.attention_bwd_plain(q, k, v, bias, o, lse, do)
    qb, kb, vb, dob = (t.bfloat16() for t in (q, k, v, do))
    ob, lseb = k2.attention_plain(qb, kb, vb, bias)
    g16 = k2.attention_bwd_plain(qb, kb, vb, bias, ob, lseb, dob)
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), g16, g32):
        assert a.dtype == (torch.float32 if name == "dbias" else torch.bfloat16)
        scale = b.abs().max().item()
        assert (a.float() - b).abs().max().item() <= 0.05 * scale, name


def test_output_carries_the_autograd_function():
    """The wrapper's output is the autograd.Function's, on the CPU as on a
    card: a backward runs K2's backward, not autograd of the plain forward
    (whose graph would not exist on a card, where the kernel fills o)."""
    q, k, v, bias, _ = (torch.from_numpy(x) for x in
                        _inputs(1, 2, 64, 64, 8, seed=1))
    o, lse = k2.flash_attention(q.requires_grad_(), k, v, bias)
    assert type(o.grad_fn).__name__ == "_FlashAttentionBackward"
    assert lse.grad_fn is o.grad_fn or not lse.requires_grad


def test_bwd_variant_is_checked():
    q, k, v, bias, _ = (torch.from_numpy(x) for x in
                        _inputs(1, 2, 64, 64, 8, seed=1))
    with pytest.raises(ValueError, match="bwd"):
        k2.flash_attention(q, k, v, bias, bwd="three-kernel")


F32, BF16 = torch.float32, torch.bfloat16


@pytest.mark.parametrize("dtype,d,nq,nk,rate,want", [
    # body, tile, rows, dkv blocks, dq blocks, dropout, dkv ragged, dq ragged
    (BF16, 16, 4096, 4096, 0.1, ("mma", 64, 128, 32, 32, "on", False, False)),
    (BF16, 16, 4096, 4096, 0.0, ("mma", 64, 128, 32, 32, "off", False, False)),
    (BF16, 16, 2000, 2000, 0.1, ("mma", 64, 128, 16, 16, "on", True, True)),
    (BF16, 16, 300, 300, 0.0, ("mma", 64, 128, 3, 3, "off", True, True)),
    (BF16, 16, 2000, 4096, 0.1, ("mma", 64, 128, 32, 16, "on", True, False)),
    (BF16, 16, 4096, 300, 0.1, ("mma", 64, 128, 3, 32, "on", False, True)),
    (BF16, 48, 4096, 4096, 0.1, ("mma", 64, 64, 64, 64, "runtime", True, True)),
    (BF16, 64, 2000, 300, 0.0, ("mma", 64, 64, 5, 32, "runtime", True, True)),
    (BF16, 8, 4096, 4096, 0.1, ("simt", 32, 128, 32, 32, "runtime", True, True)),
    (F32, 16, 4096, 4096, 0.1, ("simt", 32, 128, 32, 32, "runtime", True, True)),
    (F32, 16, 300, 2000, 0.0, ("simt", 32, 128, 16, 3, "runtime", True, True)),
    (F32, 48, 4096, 4096, 0.1, ("simt", 32, 32, 128, 128, "runtime", True, True)),
    (F32, 64, 2000, 2000, 0.1, ("simt", 32, 32, 63, 63, "runtime", True, True)),
    (F32, 8, 300, 300, 0.1, ("simt", 32, 128, 3, 3, "runtime", True, True)),
    # head size 32 (feature_dim 256): one run-time instance a body
    (BF16, 32, 4096, 4096, 0.1, ("mma", 64, 64, 64, 64, "runtime", True, True)),
    (BF16, 32, 2000, 300, 0.0, ("mma", 64, 64, 5, 32, "runtime", True, True)),
    (F32, 32, 2000, 300, 0.0, ("simt", 32, 32, 10, 63, "runtime", True, True)),
])
def test_backward_instance(dtype, d, nq, nk, rate, want):
    """The dk/dv and dq instances are a pure function of (dtype, d, Nq, Nk,
    dropout): bf16 at d 16, 32, 48, 64 takes the tensor cores, the rest the
    CUDA cores; on the tensor cores at d 16 dropout and the raggedness of the
    walked operand (Nq for dk/dv, Nk for dq) are compiled in."""
    body, tile, rows, dkv_blocks, dq_blocks, dropout, dkv_r, dq_r = want
    inst = k2.backward_instance(dtype, d, nq, nk, rate)
    assert inst == k2.BackwardInstance(body, d, tile, rows, dkv_blocks, tile,
                                       rows, dq_blocks, dropout, dkv_r, dq_r)
    assert inst == k2.backward_instance(dtype, d, nq, nk, rate)
    assert inst.dkv_blocks * inst.dkv_rows >= nk > (
        inst.dkv_blocks - 1) * inst.dkv_rows
    assert inst.dq_blocks * inst.dq_rows >= nq > (
        inst.dq_blocks - 1) * inst.dq_rows
    # the forward's rule picks the same body for the same call
    assert inst.body == k2.forward_instance(dtype, d, nq, nk, rate).body


@pytest.mark.parametrize("dtype,d,body", [(F32, 16, "mma"), (BF16, 8, "mma"),
                                          (BF16, 48, "simt"),
                                          (BF16, 64, "simt"),
                                          (F32, 64, "mma"),
                                          (BF16, 16, "wgmma")])
def test_backward_instance_refuses_a_body_it_has_not(dtype, d, body):
    with pytest.raises(ValueError, match="does not take"):
        k2.backward_instance(dtype, d, 64, 64, 0.0, body=body)


def test_backward_instance_body_argument():
    """`body="simt"` reaches the CUDA-core kernels where the tensor-core ones
    are the default (measurements compare them); naming the default is
    allowed; other types and head sizes have no kernel."""
    old = k2.backward_instance(BF16, 16, 16384, 16384, 0.1, body="simt")
    assert old == k2.BackwardInstance("simt", 16, 32, 128, 128, 32, 128, 128,
                                      "runtime", True, True)
    assert k2.backward_instance(BF16, 16, 64, 64, 0.0, body="mma").body == "mma"
    assert k2.backward_instance(F32, 16, 64, 64, 0.0, body="simt").body == "simt"
    for dtype, d in ((torch.float16, 16), (BF16, 24)):
        with pytest.raises(ValueError, match="no kernel"):
            k2.backward_instance(dtype, d, 64, 64, 0.0)
    assert set(k2.MMA_BWD_HEAD_DIMS) < set(k2.HEAD_DIMS)


@pytest.mark.parametrize("dtype,d,nq,nk,rate,want", [
    # body, query tile, keys a block, blocks, dropout, ragged Nq
    (BF16, 16, 16384, 16384, 0.1, ("mma", 64, 256, 64, "on", False)),
    (BF16, 16, 4096, 4096, 0.0, ("mma", 64, 256, 16, "off", False)),
    (BF16, 16, 2000, 300, 0.1, ("mma", 64, 256, 2, "on", True)),
    (BF16, 16, 300, 2000, 0.0, ("mma", 64, 256, 8, "off", True)),
    (BF16, 32, 4096, 4096, 0.1, ("mma", 64, 64, 64, "runtime", True)),
    (BF16, 32, 300, 2000, 0.0, ("mma", 64, 64, 32, "runtime", True)),
    # the dk/dv body fills the registers at d 48 and 64: CUDA cores
    (BF16, 48, 4096, 4096, 0.1, ("simt", 32, 32, 128, "runtime", True)),
    (BF16, 64, 2000, 2000, 0.0, ("simt", 32, 32, 63, "runtime", True)),
    (BF16, 8, 4096, 4096, 0.1, ("simt", 32, 128, 32, "runtime", True)),
    (F32, 16, 16384, 16384, 0.1, ("simt", 32, 128, 128, "runtime", True)),
    (F32, 32, 2000, 2000, 0.1, ("simt", 32, 32, 63, "runtime", True)),
    (F32, 64, 300, 300, 0.0, ("simt", 32, 32, 10, "runtime", True)),
])
def test_fused_instance(dtype, d, nq, nk, rate, want):
    """The fused backward's instance is a pure function of (dtype, d, Nq,
    Nk, dropout): bf16 at d 16 and 32 takes the tensor cores (dk/dv's body
    with the dq product), the rest the CUDA cores; on the tensor cores at
    d 16 dropout and a ragged Nq are compiled in. A block walks the query
    tiles of a split dk/dv block of the same body and owns its keys, twice
    as many on the tensor cores at d 16 (8 warps)."""
    body, tile, rows, blocks, dropout, ragged = want
    inst = k2.fused_instance(dtype, d, nq, nk, rate)
    assert inst == k2.FusedInstance(body, d, tile, rows, blocks, dropout,
                                    ragged)
    assert inst.blocks * inst.rows >= nk > (inst.blocks - 1) * inst.rows
    if body == "mma" or d not in k2.MMA_BWD_HEAD_DIMS:
        split = k2.backward_instance(dtype, d, nq, nk, rate)
        assert (split.body, split.dkv_block_q) == (body, tile)
        assert rows == split.dkv_rows * (2 if (body, d) == ("mma", 16) else 1)
    assert set(k2.MMA_FUSED_HEAD_DIMS) < set(k2.MMA_BWD_HEAD_DIMS)


@pytest.mark.parametrize("dtype,d,want", [
    (BF16, 16, "fused"), (BF16, 32, "fused"), (BF16, 8, "split"),
    (BF16, 48, "split"), (BF16, 64, "split"), (F32, 8, "split"),
    (F32, 16, "split"), (F32, 32, "fused"), (F32, 48, "fused"),
    (F32, 64, "fused"),
])
def test_default_bwd(dtype, d, want):
    """A call that names no backward variant takes the one measured faster:
    fused on the tensor cores (bf16 at d 16 and 32) and on the CUDA cores
    where four threads share a row (f32 at d 32 to 64); split on the CUDA
    cores at one thread a row and where only split has tensor cores (bf16
    at d 48 and 64)."""
    assert k2.default_bwd(dtype, d) == want
    fused = k2.fused_instance(dtype, d, 4096, 4096, 0.1)
    split = k2.backward_instance(dtype, d, 4096, 4096, 0.1)
    if want == "split" and dtype == BF16:
        assert fused.body == "simt"
    if want == "fused":
        assert fused.body == split.body


def test_fused_instance_body_argument():
    """`body="simt"` reaches the CUDA-core fused kernel at bf16 d 16, where
    the tensor-core one is the default; nothing else is on offer."""
    old = k2.fused_instance(BF16, 16, 16384, 16384, 0.1, body="simt")
    assert old == k2.FusedInstance("simt", 16, 32, 128, 128, "runtime", True)
    for dtype, d, body in ((F32, 16, "mma"), (BF16, 32, "simt"),
                           (BF16, 48, "mma"), (BF16, 16, "wgmma")):
        with pytest.raises(ValueError, match="does not take"):
            k2.fused_instance(dtype, d, 64, 64, 0.0, body=body)


def test_launch_bwd_kernel_checks_the_body_before_it_launches():
    """The wrapper refuses, on any device, a body the call has no kernel
    for, and names the head sizes each kernel takes on the tensor cores:
    the fused one bf16 at d 16 and 32, dk/dv and dq bf16 at d 16 to 64."""
    q, k, v, bias, do = (torch.from_numpy(x) for x in
                         _inputs(1, 2, 64, 64, 16, seed=1))
    lse = torch.zeros(2, 64)
    delta = torch.zeros(1, 2, 64)
    with pytest.raises(ValueError, match=r"does not take .*bf16 at d in "
                                         r"\(16, 32\)"):
        k2.launch_bwd_kernel(k2.DKV_FUSED_DQ, q, k, v, bias, do, lse, delta,
                             body="mma")
    wide = [t.bfloat16() for t in (torch.zeros(1, 2, 64, 48),) * 3]
    with pytest.raises(ValueError, match=r"does not take .*\(16, 32\)"):
        k2.launch_bwd_kernel(k2.DKV_FUSED_DQ, *wide, bias, wide[0], lse,
                             delta, body="mma")
    with pytest.raises(ValueError, match=r"does not take .*"
                                         r"\(16, 32, 48, 64\)"):
        k2.launch_bwd_kernel(k2.DQ, q, k, v, bias, do, lse, delta, body="mma")
