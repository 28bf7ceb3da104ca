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


# The bf16 bar of the K2 forward, element by element against the plain
# version's online form at the kernel's key tile (which rounds p where the
# kernel does): 2 bf16 ulps of the element's own reference for the last
# rounding, plus a share of the largest output, and a ceiling on the share of
# elements that differ at all. A score that differs in its last f32 bits can
# round p the other way in bf16 and move o by 2^-8 p / l |v|. CUDA cores
# (f32 FMA sums, expf): 2e-5 of the largest, 1 element in 100 (measured on an
# H100: 4e-7, 1 in 900). Tensor cores (truncating sums, ex2.approx on a
# rounded product): 1e-3, 3 in 100 (measured: 1.8e-4 at N 300, 9 in 1000 at
# N 16384). An element in the wrong place is off by a tenth of the largest.
_K2_BF16_BAR = {"simt": (2e-5, 1e-2), "mma": (1e-3, 3e-2)}


def _k2_bf16_close(got, ref, body):
    share, ceiling = _K2_BF16_BAR[body]
    ref = ref.float()
    err = (got.float() - ref).abs()
    top = ref.abs().max().item()
    assert (err > 0).float().mean().item() <= ceiling
    assert (err <= 2 * _bf16_ulp(ref) + share * top).all(), (
        err.max().item(), top)


def _k2_inputs(cuda, b, h, nq, nk, d, dtype, seed):
    r = np.random.default_rng(seed)
    mk = lambda *shape: torch.from_numpy(
        r.standard_normal(shape).astype(np.float32)).to(cuda, dtype)
    q, k, v = mk(b, h, nq, d), mk(b, h, nk, d), mk(b, h, nk, d)
    bias = torch.from_numpy(
        (0.5 * r.standard_normal((h, nk))).astype(np.float32)).to(cuda)
    return q, k, v, bias


# (4096, 16) and (2000, 16): the teacher's head size at whole key tiles and
# at a ragged N, so that with both rates every (dropout, ragged) instance of
# both bodies runs.
@pytest.mark.gpu
@pytest.mark.parametrize("n,d", [(4096, 8), (4096, 16), (2000, 16),
                                 (4096, 32), (2000, 32), (4096, 48),
                                 (1000, 64), (300, 8)])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_matches_plain(cuda, n, d, rate, dtype):
    q, k, v, bias = _k2_inputs(cuda, 2, 4, n, n, d, dtype, seed=n + d)
    inst = k2.forward_instance(dtype, d, n, n, rate)
    assert inst.body == ("mma" if dtype == torch.bfloat16 and d >= 16
                         else "simt")
    before = k2.launches
    o, lse = k2.flash_attention(q, k, v, bias, dropout_rate=rate, seed=-77)
    torch.cuda.synchronize()
    assert k2.launches == before + 1
    ro, rlse = k2.attention_plain(q, k, v, bias, dropout_rate=rate, seed=-77)
    err = (o.float() - ro.float()).abs().max().item()
    if dtype == torch.float32:
        assert err <= 1e-5
    else:
        # The two-pass plain version rounds p at another magnitude: 2 bf16
        # ulps at the output's largest. Element by element: the online form.
        assert err <= 2 * 2.0 ** -7 * ro.float().abs().max().item()
        oo, olse = k2.attention_plain(q, k, v, bias, dropout_rate=rate,
                                      seed=-77, block_k=inst.block_k)
        _k2_bf16_close(o, oo, inst.body)
        assert (lse - olse).abs().max().item() <= 1e-4
    assert (lse - rlse).abs().max().item() <= 1e-4
    assert torch.equal(o, k2.flash_attention(
        q, k, v, bias, dropout_rate=rate, seed=-77)[0]), "same bits every run"


@pytest.mark.gpu
@pytest.mark.parametrize("n", [4096, 2000, 300])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_flash_attention_bodies_agree(cuda, n, rate):
    """The tensor-core bf16 kernel against the CUDA-core bf16 kernel it
    replaced, at the teacher's head size on the same inputs: both have key
    tiles of 64 and round where the plain version's online form rounds, so
    they meet the tensor-core bar against each other."""
    q, k, v, bias = _k2_inputs(cuda, 2, 4, n, n, 16, torch.bfloat16, seed=n)
    kw = dict(dropout_rate=rate, seed=31)
    before = k2.launches
    new, lse_new = k2.forward_kernel(q, k, v, bias, **kw)
    old, lse_old = k2.forward_kernel(q, k, v, bias, body="simt", **kw)
    assert k2.launches == before + 2
    _k2_bf16_close(new, old, "mma")
    assert (lse_new - lse_old).abs().max().item() <= 1e-4
    with pytest.raises(ValueError, match="does not take"):
        k2.forward_kernel(q.float(), k.float(), v.float(), bias, body="mma")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_rectangular_offsets(cuda, dtype):
    """A q shard at q_offset, and batch rows at row_offset, see the same
    dropout mask as the full call: the same values in f32 (1e-6), the same
    bits in bf16 (every row's arithmetic is its own in both calls)."""
    q, k, v, _ = _k2_inputs(cuda, 2, 2, 512, 512, 16, dtype, seed=0)
    bias = torch.zeros(2, 512, device=cuda)
    full, _ = k2.flash_attention(q, k, v, bias, dropout_rate=0.2, seed=9)
    shard, _ = k2.flash_attention(q[:, :, 256:].contiguous(), k, v, bias,
                                  dropout_rate=0.2, seed=9, q_offset=256)
    rows, _ = k2.flash_attention(q[1:].contiguous(), k[1:].contiguous(),
                                 v[1:].contiguous(), bias, dropout_rate=0.2,
                                 seed=9, row_offset=2)
    if dtype == torch.float32:
        torch.testing.assert_close(shard, full[:, :, 256:], atol=1e-6, rtol=0)
        torch.testing.assert_close(rows, full[1:], atol=1e-6, rtol=0)
    else:
        assert torch.equal(shard, full[:, :, 256:])
        assert torch.equal(rows, full[1:])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,body", [(torch.float32, None),
                                        (torch.bfloat16, None),
                                        (torch.bfloat16, "simt")])
@pytest.mark.parametrize("nq,nk,q_offset,row_offset", [(512, 512, 0, 0),
                                                       (200, 300, 70, 3)])
def test_flash_attention_dropout_mask_positions(cuda, dtype, body, nq, nk,
                                                q_offset, row_offset):
    """The kernel's dropout mask, position by position, is the hash. With
    q = 0 and bias = 0 every p is 1 / Nk; v is 1 at (key k0 + j, column j) and
    0 elsewhere, so o[row, j] is 0 exactly where the mask drops key k0 + j
    for that row: a fragment coordinate mixed up (row r with r + 8, a column
    pair, a key tile) moves the zeros."""
    b, h, d, rate, seed = 2, 2, 16, 0.3, 123
    q = torch.zeros(b, h, nq, d, device=cuda, dtype=dtype)
    k = torch.zeros(b, h, nk, d, device=cuda, dtype=dtype)
    bias = torch.zeros(h, nk, device=cuda)
    rs = k2.row_seeds(seed, b * h, row_offset, cuda).reshape(b, h, 1, 1)
    q_abs = torch.arange(q_offset, q_offset + nq, device=cuda)[:, None]
    for k0 in (0, 8, 56, 121, nk - 16):
        v = torch.zeros(b, h, nk, d, device=cuda, dtype=dtype)
        v[:, :, k0:k0 + d] = torch.eye(d, device=cuda, dtype=dtype)
        o, _ = k2.forward_kernel(q, k, v, bias, dropout_rate=rate, seed=seed,
                                 q_offset=q_offset, row_offset=row_offset,
                                 body=body)
        keep = k2.keep_mask(rs, torch.arange(k0, k0 + d, device=cuda), q_abs,
                            k2.dropout_threshold(1.0 - rate))
        assert torch.equal(o != 0, keep), k0
        assert 0.6 < keep.float().mean().item() < 0.8


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


# The bf16 bar of the K2 backward, element by element against the plain
# backward (which rounds ds and the dropped p to bf16 where the kernels do and
# sums in f32): 2 bf16 ulps of the element's own reference for the last
# rounding, plus 1e-3 of the largest gradient, and a ceiling on the share of
# elements that differ at all. The earlier bar, 2 ulps of the largest
# (1.6e-2 of it), would pass one misplaced term of an N-term sum. A score that
# differs in its last f32 bits can round ds or p the other way in bf16 and
# move a sum by 2^-8 of one term: that one flipped term is what the 1e-3
# allows on either body (measured on an H100: 8e-5 on the CUDA cores, in the
# fused dq at d 64, whose four threads a row sum in another order; 4.6e-4 on
# the tensor cores, whose sums truncate and whose exp is ex2.approx). The
# ceiling tells the bodies apart: 1 element in 100 on the CUDA cores
# (measured: 1 in 500), 5 in 100 on the tensor cores (measured: 1 in 1000 at
# N 256, 2 in 100 at N 16384, where more terms can flip). The fused
# tensor-core dq is held to the same bar: its blocks add their f32 partials
# with atomics in any order, which moves its last f32 bits from run to run
# and, through the final rounding to bf16, an element by 1 ulp at most. A
# term in the wrong place moves an element by a tenth of the largest or more,
# a wrong mask every element.
_K2_BWD_BF16_BAR = {"simt": (1e-3, 1e-2), "mma": (1e-3, 5e-2)}


def _close(got, ref, dtype, name, body="simt"):
    """f32, and dbias in both types: 1e-4 of the largest magnitude (sums of
    up to N terms in other orders; the fused dq's atomics in any order).
    bf16: `_K2_BWD_BF16_BAR`, element by element."""
    ref = ref.float()
    top = ref.abs().max().item()
    err = (got.float() - ref).abs()
    if dtype == torch.float32 or name == "dbias":
        tol = 1e-4 * top + 1e-6
        assert err.max().item() <= tol, (
            f"{name}: max_abs_err {err.max().item():.3e} > {tol:.3e}")
        return
    share, ceiling = _K2_BWD_BF16_BAR[body]
    differ = (err > 0).float().mean().item()
    assert differ <= ceiling, f"{name}: {differ:.2e} of the elements differ"
    assert (err <= 2 * _bf16_ulp(ref) + share * top).all(), (
        f"{name}: max_abs_err {err.max().item():.3e} at largest {top:.3e}")


def _bwd_split(args, body=None, **kw):
    """The split backward through `launch_bwd_kernel`, which takes `body`:
    (dq, dk, dv, dbias) as `flash_attention_bwd` returns them."""
    q, k, v, bias, o, lse, do = args
    b, h, _, _ = q.shape
    nk = k.shape[2]
    delta = (o.float() * do.float()).sum(-1)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dbias_bh = torch.empty(b * h, nk, device=q.device)
    k2.launch_bwd_kernel(k2.DKV, q, k, v, bias, do, lse, delta, dk=dk, dv=dv,
                         dbias_bh=dbias_bh, body=body, **kw)
    k2.launch_bwd_kernel(k2.DQ, q, k, v, bias, do, lse, delta, dq=dq,
                         body=body, **kw)
    return dq, dk, dv, dbias_bh.reshape(b, h, nk).sum(dim=0)


def _bwd_fused(args, body=None, **kw):
    """The fused backward through `launch_bwd_kernel`, which takes `body`:
    (dq, dk, dv, dbias) as `flash_attention_bwd` returns them."""
    q, k, v, bias, o, lse, do = args
    b, h, nq, d = q.shape
    nk = k.shape[2]
    delta = (o.float() * do.float()).sum(-1)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    dbias_bh = torch.empty(b * h, nk, device=q.device)
    dq_acc = torch.zeros(b, h, nq, d, device=q.device)
    k2.launch_bwd_kernel(k2.DKV_FUSED_DQ, q, k, v, bias, do, lse, delta,
                         dk=dk, dv=dv, dbias_bh=dbias_bh, dq_acc=dq_acc,
                         body=body, **kw)
    dq = dq_acc.to(q.dtype) * torch.tensor(d ** -0.5, dtype=q.dtype,
                                           device=q.device)
    return dq, dk, dv, dbias_bh.reshape(b, h, nk).sum(dim=0)


def _bwd_body(variant, dtype, d, nq, nk, rate):
    rule = k2.fused_instance if variant == "fused" else k2.backward_instance
    return rule(dtype, d, nq, nk, rate).body


# (2000, 2000, 16): the teacher's head size at a ragged N; (2000, 300, 16) and
# (300, 2000, 16): rectangular with ragged tails on both sides, so that with
# both rates every (dropout, ragged) instance of the tensor-core bodies runs
# (4096 x 4096 at d 16: the whole-tile instances, in the bodies-agree test);
# d 32 (feature_dim 256): every kernel's run-time instance, both rates.
@pytest.mark.gpu
@pytest.mark.parametrize("variant", ["fused", "split"])
@pytest.mark.parametrize("nq,nk,d", [(4096, 4096, 8), (2000, 2000, 16),
                                     (2000, 2000, 32), (300, 2000, 32),
                                     (4096, 4096, 48), (1000, 1000, 64),
                                     (300, 300, 8), (2000, 300, 16),
                                     (300, 2000, 16)])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_bwd_kernels_match_plain(cuda, variant, nq, nk, d,
                                                rate, dtype):
    args = _bwd_inputs(cuda, 2, 4, nq, nk, d, dtype, seed=nq + d, rate=rate)
    body = _bwd_body(variant, dtype, d, nq, nk, rate)
    mma_dims = (16, 32) if variant == "fused" else (16, 32, 48, 64)
    assert body == ("mma" if dtype == torch.bfloat16 and d in mma_dims
                    else "simt")
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
        _close(g, r, dtype, name, body)
    # The same bits every run, but the fused dq: its atomics add in any order.
    again = k2.flash_attention_bwd(*args, dropout_rate=rate, seed=-77,
                                   variant=variant)
    for name, g, r in zip(("dq", "dk", "dv", "dbias"), got, again):
        if variant == "split" or name != "dq":
            assert torch.equal(g, r), f"{name}: same bits every run"


@pytest.mark.gpu
@pytest.mark.parametrize("nq,nk", [(4096, 4096), (2000, 2000), (2000, 300),
                                   (300, 2000)])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_flash_attention_bwd_bodies_agree(cuda, nq, nk, rate):
    """bf16 at the teacher's head size: the CUDA-core kernels (`body="simt"`:
    dk/dv and dq, and the fused one) meet their bar against the plain
    backward, and the tensor-core kernels meet theirs against the CUDA-core
    kernels' output on the same inputs (both round ds and p where the plain
    backward does)."""
    args = _bwd_inputs(cuda, 2, 4, nq, nk, 16, torch.bfloat16, seed=nq + nk,
                       rate=rate)
    kw = dict(dropout_rate=rate, seed=-77)
    ref = k2.attention_bwd_plain(*args, **kw)
    for run, counters in ((_bwd_split, ("bwd_dkv_launches", "bwd_dq_launches")),
                          (_bwd_fused, ("bwd_fused_launches",))):
        counts = [getattr(k2, c) for c in counters]
        new, old = run(args, **kw), run(args, body="simt", **kw)
        torch.cuda.synchronize()
        assert [getattr(k2, c) for c in counters] == [n + 2 for n in counts]
        for name, n, o, r in zip(("dq", "dk", "dv", "dbias"), new, old, ref):
            _close(o, r, torch.bfloat16, name, "simt")
            _close(n, o, torch.bfloat16, name, "mma")
        f32 = tuple(t.float() if t.dtype == torch.bfloat16 else t for t in args)
        with pytest.raises(ValueError, match="does not take"):
            run(f32, body="mma")


@pytest.mark.gpu
@pytest.mark.parametrize("variant", ["fused", "split"])
@pytest.mark.parametrize("dtype,body", [(torch.float32, None),
                                        (torch.bfloat16, None),
                                        (torch.bfloat16, "simt")])
@pytest.mark.parametrize("nq,nk,q_offset,row_offset", [(512, 512, 0, 0),
                                                       (200, 300, 70, 3)])
def test_flash_attention_bwd_dropout_mask_positions(cuda, variant, dtype, body,
                                                    nq, nk, q_offset,
                                                    row_offset):
    """The backward kernels' dropout masks, position by position, are the
    hash. With q = 0, bias = 0 and lse = 0 every p is 1; o = 0 makes delta 0.
    dk/dv: dO is 1 at (query q0 + c, column c) and 0 elsewhere, so dv[key, c]
    is 0 exactly where the mask drops (query q0 + c, key). dq: k is 1 at
    (key k0 + c, column c), v and dO are ones (dp = 16), so dq[query, c] is 0
    exactly where the mask drops (query, key k0 + c). A fragment coordinate
    mixed up (row r with r + 8, a column pair, a tile, keys with queries, a
    transpose of the fused form's ds) moves the zeros."""
    run = _bwd_fused if variant == "fused" else _bwd_split
    b, h, d, rate, seed = 2, 2, 16, 0.3, 123
    zeros = lambda n: torch.zeros(b, h, n, d, device=cuda, dtype=dtype)
    ones = lambda n: torch.ones(b, h, n, d, device=cuda, dtype=dtype)
    eye = torch.eye(d, device=cuda, dtype=dtype)
    bias = torch.zeros(h, nk, device=cuda)
    lse = torch.zeros(b * h, nq, device=cuda)
    kw = dict(dropout_rate=rate, seed=seed, q_offset=q_offset,
              row_offset=row_offset)
    rs = k2.row_seeds(seed, b * h, row_offset, cuda).reshape(b, h, 1, 1)
    keep = k2.keep_mask(rs, torch.arange(nk, device=cuda),
                        torch.arange(q_offset, q_offset + nq,
                                     device=cuda)[:, None],
                        k2.dropout_threshold(1.0 - rate))   # [b, h, nq, nk]
    assert 0.6 < keep.float().mean().item() < 0.8
    for q0 in (0, 8, 56, 121, nq - 16):
        do = zeros(nq)
        do[:, :, q0:q0 + d] = eye
        _, _, dv, _ = run((zeros(nq), zeros(nk), ones(nk), bias, zeros(nq),
                           lse, do), body=body, **kw)
        assert torch.equal(dv != 0, keep[:, :, q0:q0 + d].transpose(2, 3)), q0
    for k0 in (0, 8, 56, 121, nk - 16):
        k = zeros(nk)
        k[:, :, k0:k0 + d] = eye
        dq, _, _, _ = run((zeros(nq), k, ones(nk), bias, zeros(nq), lse,
                           ones(nq)), body=body, **kw)
        assert torch.equal(dq != 0, keep[:, :, :, k0:k0 + d]), k0


@pytest.mark.gpu
@pytest.mark.parametrize("variant", ["fused", "split"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [16, 32])
def test_flash_attention_bwd_offsets(cuda, variant, dtype, d):
    """A q shard at q_offset gets the full call's dq rows; batch row 1 at
    row_offset gets the full call's dq, dk, dv rows (same dropout masks)."""
    q, k, v, bias, _, _, do = _bwd_inputs(cuda, 2, 2, 512, 512, d, dtype,
                                          seed=3)
    kw = dict(dropout_rate=0.2, seed=9)
    body = _bwd_body(variant, dtype, d, 512, 512, 0.2)

    def grads(q, k, v, do, **extra):
        o, lse = k2.attention_plain(q, k, v, bias, **kw, **extra)
        return k2.flash_attention_bwd(q, k, v, bias, o, lse, do,
                                      variant=variant, **kw, **extra)
    full = grads(q, k, v, do)
    shard = grads(q[:, :, 256:].contiguous(), k, v,
                  do[:, :, 256:].contiguous(), q_offset=256)
    rows = grads(*(t[1:].contiguous() for t in (q, k, v, do)), row_offset=2)
    _close(shard[0], full[0][:, :, 256:], dtype, "dq", body)
    for name, a, b in zip(("dq", "dk", "dv"), rows[:3], full[:3]):
        _close(a, b[1:], dtype, name, body)


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
    block_k = stages.KERNEL_BLOCK_K
    nk = -(-n // block_k) * block_k             # a ragged Nq, whole key tiles
    mk = lambda *shape: torch.from_numpy(
        r.standard_normal(shape).astype(np.float32)).to(cuda)
    q = (mk(2, 4, n, d) * d ** -0.5).to(dtype)
    k, v = mk(2, 4, nk, d).to(dtype), mk(2, 4, nk, d).to(dtype)
    bias = 0.5 * mk(4, nk)
    before = stages.launches
    o, lse = stages.flash_fwd_stage(q, k, v, bias, stage, block_k)
    torch.cuda.synchronize()
    assert stages.launches == before + 1
    ro, rlse = stages.flash_fwd_stage_plain(q, k, v, bias, stage, block_k)
    ref = ro.float()
    scale = ref.abs().max().item()       # no floor: o is small past "exp"
    err = (o.float() - ref).abs()
    # f32 (the CUDA-core body): up to Nk terms summed in another order, 2e-5
    # of the largest magnitude. bf16 (the tensor-core body): the forward's
    # bar, 2 ulps of each element's own reference for the last rounding plus
    # 1e-3 of the largest, and at most 3 elements in 100 may differ at all
    # (measured on an H100: 1.6e-4, 9 in 1000 at Nk 16384).
    bar = 2e-5 * scale
    if dtype == torch.bfloat16:
        share, ceiling = _K2_BF16_BAR["mma"]
        bar = share * scale + 2 * _bf16_ulp(ref)
        assert (err > 0).float().mean().item() <= ceiling
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
    so, slse = stages.flash_fwd_stage(qs, k, v, bias, "sum",
                                      stages.KERNEL_BLOCK_K)
    assert torch.equal(so, o) and torch.equal(slse, lse)


@pytest.mark.gpu
def test_flash_fwd_stage_rejects_unsupported(cuda):
    q, k, v = (torch.zeros(1, 2, 256, 16, device=cuda) for _ in range(3))
    bias = torch.zeros(2, 256, device=cuda)
    tile = stages.KERNEL_BLOCK_K
    with pytest.raises(ValueError, match="key tile"):
        stages.flash_fwd_stage(q, k, v, bias, "dots", 2 * tile)
    q8, k8, v8 = (torch.zeros(1, 2, 256, 8, device=cuda) for _ in range(3))
    with pytest.raises(ValueError, match="head dim"):
        stages.flash_fwd_stage(q8, k8, v8, bias, "dots", tile)
    with pytest.raises(ValueError, match="one dtype"):
        stages.flash_fwd_stage(q, k.bfloat16(), v, bias, "dots", tile)


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
