"""The design of K2's f32 window bodies (csrc/flash_attention_window_tf32.cuh
`flash_fwd_window_tf32`, `flash_bwd_window_tf32`: the windowed fold in f32,
three TF32 passes a product, split inside the kernel), on the CPU.

Their arithmetic is emulated here, at the kernels' rounding points and in
their order: the in-kernel split (hi = tf32(x), lo = tf32(x - hi), cvt.rna),
the pass order (a_lo b_hi, a_hi b_lo, a_hi b_hi, a k-step of 8 at a time; at
d 16 p v, dk, dv and dq as a_hi [b_hi; b_lo] and a_lo b_hi, added small
terms first), the exact one-pass softmax over the window's 256 key slots, p
split in registers, p v from zero a chunk of 64 keys; the backward's walk of
a window's key groups and, for each, its query groups in sub-tiles, dk and
dv from zero a pair, dq of each pair from zero and summed in key-group
order.
The emulation is held against float64 (the bars of the f32 warpgroup
bodies in tests/test_torch_tf32.py: o and lse 1e-6, gradients 1e-5 of their
largest) and against the JAX package's Pallas kernel and its gradients in
interpret mode on the folded shape (1e-5). The tiles the kernels write by
index maps of their own (the landed rows, V^T and qs^T in `perm8` order,
K^T, ds) are read back through the wgmma descriptors' addressing and give
the plain products. The kernels themselves are held against the plain
versions on a card by tests/test_torch_kernels.py and chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lunaris_orion_tpu.ops.pallas import flash_attention as fa
from lunaris_orion_tpu_torch.ops.cuda import flash_attention as k2
from test_torch_kernels import torch_threads  # noqa: F401 (autouse)
from test_torch_tf32 import _backward, _forward, _inputs, _keep, _kmajor, _x3

SLOTS = 256                      # the forward's key slots a window (kWinMax)
_L2E = torch.tensor(k2._LOG2E)


def _split(x):
    return k2.split_tf32(x)


def _steps(a, b, c):
    """a + x @ y^T over k-steps of 8 along the last dim, three passes each
    (x lo y hi, x hi y lo, x hi y hi): (xh, xl), (yh, yl) split pairs."""
    (xh, xl), (yh, yl) = b, c
    for kd in range(xh.shape[-1] // 8):
        s = slice(8 * kd, 8 * kd + 8)
        tr = lambda y: y[..., s].transpose(-1, -2)
        part = xl[..., s] @ tr(yh)
        a = part if a is None else a + part
        a = a + xh[..., s] @ tr(yl)
        a = a + xh[..., s] @ tr(yh)
    return a


def _x3_or_steps(a, b):
    """x @ y^T over a group from zero: at d 16 (x lo y hi + x hi y lo) + x
    hi y hi, each summed over the group (a_hi [b_hi; b_lo] in one m64n32k8
    and a_lo b_hi); at d 32 the three passes a k-step of 8 into one sum."""
    (xh, xl), (yh, yl) = a, b
    if yh.shape[-2] == 16:
        tr = lambda y: y.transpose(-1, -2)
        return _x3(xh, xl, tr(yh), tr(yl))
    return _steps(None, a, b)


def _fma32(a, b, c):
    """f32 fma: a b + c rounded once."""
    return (a.double() * b.double() + c.double()).float()


def _fwd_window_tf32(q, k, v, bias, keep, rate):
    """o, lse of flash_fwd_window_tf32's arithmetic in f32 on the fold
    [B, H', W, d] (W a multiple of 64 up to 256): 256 key slots (K and V
    zeros past W, the bias -inf there); qs = q d^-1/2 in f32, split; s =
    bias + three passes a k-step; the max over every key; p = 2^fma(s,
    log2 e, -m log2 e); each lane's share of the row sum (keys 8 j + 2 t +
    e) in one chain from zero a chunk of 64 keys, the chunks added, the
    lanes' shares summed at the end; p dropped and split; p v from zero a
    chunk (`_x3_or_steps`), the chunks added to o from zero; o / l, lse =
    m + log l."""
    b, h, w, d = q.shape
    pad = lambda x: torch.nn.functional.pad(x, (0, 0, 0, SLOTS - w))
    qs = _split(q * torch.tensor(d ** -0.5, dtype=torch.float32))
    kp, vp = _split(pad(k)), _split(pad(v))
    bias_p = torch.nn.functional.pad(bias, (0, SLOTS - w), value=-float("inf"))
    s = _steps(bias_p[None, :, None, :].expand(b, h, w, SLOTS), qs, kp)
    m = s.amax(-1, keepdim=True)
    p = torch.exp2(_fma32(s, _L2E, -m * _L2E))
    lanes = torch.zeros(b, h, w, 4)
    for ch in range(SLOTS // 64):
        part = p[..., 64 * ch:64 * ch + 64].reshape(b, h, w, 8, 4, 2)
        lq = torch.zeros(b, h, w, 4)
        for j in range(8):
            for e in range(2):
                lq += part[..., j, :, e]
        lanes = lanes + lq
    l_sum = (lanes[..., :1] + lanes[..., 1:2]) + (lanes[..., 2:3]
                                                  + lanes[..., 3:])
    if keep is not None:
        keep = torch.nn.functional.pad(keep, (0, SLOTS - w))
        p = torch.where(keep, p * k2._inv_keep(rate), 0.0)
    ph, pl = _split(p)
    vh, vl = (x.transpose(-1, -2) for x in vp)            # [d, keys]
    o = torch.zeros(b, h, w, d)
    for ch in range(SLOTS // 64):
        c = slice(64 * ch, 64 * ch + 64)
        o = o + _x3_or_steps((ph[..., c], pl[..., c]), (vh[..., c], vl[..., c]))
    l_sum = l_sum.clamp_min(1e-30)
    return o / l_sum, (m + torch.log(l_sum)).squeeze(-1)


def _bwd_window_tf32(q, k, v, bias, do, o, lse, keep, rate):
    """dq, dk, dv, dbias of flash_bwd_window_tf32's arithmetic in f32 on the
    fold: delta = rowsum(o dO) by f32 fmas along the row, -lse log2 e; for
    each 64-key group (k, v split), each 64-query group in sub-tiles of 32
    queries at d 16 and 16 at d 32: s^T = bias + three passes a k-step (k lo
    qs hi, k hi qs lo, k hi qs hi), dp^T from zero the same way; p =
    2^fma(s, log2 e, -lse log2 e); ds = p (dp' - delta), pv; dk and dv from
    zero a pair over its 64 queries (`_x3_or_steps`), added to the group's;
    dq of the pair from zero over its 64 keys the same way, added to the
    sum of the key groups before in their order; finally dq d^-1/2 in f32,
    dbias summed over the batch."""
    b, h, w, d = q.shape
    ng, sub = w // 64, 32 if d == 16 else 16
    scale = torch.tensor(d ** -0.5, dtype=torch.float32)
    qs, dos = _split(q * scale), _split(do)
    kk_, vv_ = _split(k), _split(v)
    delta = torch.zeros(b, h, w)
    for i in range(d):
        delta = _fma32(o[..., i], do[..., i], delta)
    nl = -lse * _L2E
    inv = k2._inv_keep(rate)
    dq = torch.zeros(b, h, w, d)
    dk, dv, db = (torch.zeros(b, h, w, d), torch.zeros(b, h, w, d),
                  torch.zeros(b, h, w))
    for kg in range(ng):
        ks = slice(64 * kg, 64 * kg + 64)
        kg_k = [x[..., ks, :] for x in kk_]
        kg_v = [x[..., ks, :] for x in vv_]
        for qg in range(ng):
            ds_pair, pv_pair = [], []
            for hh in range(64 // sub):
                qr = slice(64 * qg + sub * hh, 64 * qg + sub * hh + sub)
                s = _steps(bias[None, :, ks, None].expand(b, h, 64, sub), kg_k,
                           [x[..., qr, :] for x in qs])
                dp = _steps(None, kg_v, [x[..., qr, :] for x in dos])
                p = torch.exp2(_fma32(s, _L2E, nl[..., None, qr]))
                pv = p
                if keep is not None:
                    kinv = torch.where(keep[..., qr, ks].transpose(-1, -2),
                                       inv, 0.0)
                    dp, pv = dp * kinv, p * kinv
                ds = p * (dp - delta[..., None, qr])
                db[..., ks] += ds.sum(-1)
                ds_pair.append(ds)
                pv_pair.append(pv)
            # dk += ds^T qs, dv += pv^T dO over the pair's 64 queries
            q64 = slice(64 * qg, 64 * qg + 64)
            qT = [x[..., q64, :].transpose(-1, -2) for x in qs]
            oT = [x[..., q64, :].transpose(-1, -2) for x in dos]
            dk[..., ks, :] += _x3_or_steps(_split(torch.cat(ds_pair, -1)), qT)
            dv[..., ks, :] += _x3_or_steps(_split(torch.cat(pv_pair, -1)), oT)
            dsq = torch.cat(ds_pair, -1).transpose(-1, -2)   # [64 q, 64 keys]
            kT = [x.transpose(-1, -2) for x in kg_k]         # [d, keys]
            dqp = _x3_or_steps(_split(dsq), kT)
            dq[..., q64, :] = dqp if kg == 0 else dq[..., q64, :] + dqp
    return dq * scale, dk, dv, db.sum(0)


# (d, W): the default and the low-end width, the smallest and the recipe's
# window; two images of two folded rows.
WINDOWS = [(16, 64), (16, 256), (32, 64), (32, 256)]


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("d,w", WINDOWS)
def test_f32_window_forward_holds_to_f64(d, w, rate):
    """flash_fwd_window_tf32's arithmetic: o and lse within 1e-6 of
    float64, the f32 warpgroup bodies' bar."""
    q, k, v, bias, _ = _inputs(2, 2, w, w, d, seed=d + w)
    keep = _keep(2, 2, w, w, rate, seed=-1234567)
    ref_o, ref_lse, _ = _forward(q, k, v, bias, keep, rate)
    o, lse = _fwd_window_tf32(q, k, v, bias, keep, rate)
    assert (o.double() - ref_o).abs().max().item() <= 1e-6
    assert (lse.double() - ref_lse).abs().max().item() <= 1e-6


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("d,w", WINDOWS)
def test_f32_window_backward_holds_to_f64(d, w, rate):
    """flash_bwd_window_tf32's arithmetic (the emulated forward's o and
    lse): every gradient within 1e-5 of its largest magnitude of float64."""
    q, k, v, bias, do = _inputs(2, 2, w, w, d, seed=100 + d + w)
    keep = _keep(2, 2, w, w, rate, seed=99)
    ref = _backward(q, k, v, bias, do, keep, rate)
    o, lse = _fwd_window_tf32(q, k, v, bias, keep, rate)
    got = _bwd_window_tf32(q, k, v, bias, do, o, lse, keep, rate)
    for name, g, r in zip(("dq", "dk", "dv", "dbias"), got, ref):
        top = r.abs().max().item()
        assert (g.double() - r).abs().max().item() <= 1e-5 * top, name


@pytest.mark.parametrize("d,w,rate,seed", [(16, 256, 0.0, 0),
                                           (16, 64, 0.1, 1234567),
                                           (32, 256, 0.1, -987654321),
                                           (32, 64, 0.0, 0)])
def test_f32_window_bodies_match_pallas(d, w, rate, seed):
    """The emulated f32 window forward and backward against the JAX
    package's Pallas kernel and its gradients (interpret mode) on the
    folded shape (Nq = Nk = W, the windows as rows), at 1e-5."""
    q, k, v, bias, do = _inputs(1, 2, w, w, d, seed=17 + d + w)
    keep = _keep(1, 2, w, w, rate, seed)
    jq, jk, jv, jb = (jnp.asarray(x.numpy()) for x in (q, k, v, bias))
    kw = dict(dropout_rate=rate, seed=jnp.int32(seed))
    want = np.asarray(fa.attention_bhnd(jq, jk, jv, jb, **kw))
    o, lse = _fwd_window_tf32(q, k, v, bias, keep, rate)
    np.testing.assert_allclose(o.numpy(), want, atol=1e-5, rtol=0)
    loss = lambda *a: jnp.sum(fa.attention_bhnd(*a, **kw) * jnp.asarray(
        do.numpy()))
    grads = jax.grad(loss, argnums=(0, 1, 2, 3))(jq, jk, jv, jb)
    got = _bwd_window_tf32(q, k, v, bias, do, o, lse, keep, rate)
    for name, g, r in zip(("dq", "dk", "dv", "dbias"), got, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-5,
                                   rtol=0, err_msg=name)


# --- the index maps: the kernels' offsets (t32_row_offset, t32_atom_offset
# and the producer's walk of a landed tile), mirrored, and the descriptors'
# addressing (`_kmajor`) ----------------------------------------------------

def _row_off(d, r, c):
    """t32_row_offset<D>: f32 (r, c) of a [rows][d] tile whose row is the
    swizzle's span (64 bytes at d 16, 128 at d 32), as TMA lands it."""
    span = d // 4
    return r * 4 * d + ((((c >> 2) ^ (r // (8 // span))) & (span - 1)) << 4) \
        + (c & 3) * 4


def _atom_off(d, row, k):
    """t32_atom_offset<D>: (row, k) of [2 d][32] atoms, 128-byte swizzle."""
    return (k >> 5) * 256 * d + k2._sw128(row, k & 31)


def _landed(x, d):
    """The bytes (as f32) of x [.., rows, d] landed as rows."""
    rows = x.shape[-2]
    r, c = torch.arange(rows)[:, None], torch.arange(d)[None, :]
    out = torch.zeros(*x.shape[:-2], rows * d)
    out[..., (_row_off(d, r, c) // 4).flatten()] = x.flatten(-2)
    return out


def _transposed(tile, d, order):
    """The producer's walk of a landed tile [.., rows * d] (chunk i: row i //
    (d / 4), dims 4 ((i % (d / 4)) ^ the row's swizzle) ..), each value
    split and written as hi at atom row `dim`, lo at d + dim, column
    order(row): the kernels' V^T and qs^T / dO^T (order `perm8`) and K^T
    (the keys in order, from the fragments)."""
    span = d // 4
    rows = tile.shape[-1] // d
    i = torch.arange(rows * span)
    r = i // span
    col = 4 * ((i % span) ^ ((r // (8 // span)) & (span - 1)))
    out = torch.zeros(*tile.shape[:-1], 2 * d * rows)
    hi, lo = _split(tile)
    for e in range(4):
        src = 4 * i + e
        dst_hi = _atom_off(d, col + e, order(r)) // 4
        dst_lo = _atom_off(d, d + col + e, order(r)) // 4
        out[..., dst_hi] = hi[..., src]
        out[..., dst_lo] = lo[..., src]
    return out


def _b_operand(atoms, d, steps):
    """hi, lo [.., d, 8 steps] as the kernels' descriptors read the atoms:
    k-step j at atom j // 4, 32 bytes j % 4 on, lo d rows down."""
    m = torch.cat([_kmajor(atoms, (j // 4) * 256 * d + (j % 4) * 32, 2 * d,
                           128, 1024) for j in range(steps)], -1)
    return m[..., :d, :], m[..., d:, :]


@pytest.mark.parametrize("d", [16, 32])
def test_f32_window_maps_give_the_plain_products(d):
    """Each tile the f32 window bodies write by an index map of their own,
    read back through their wgmma descriptors, is its operand: K hi and lo
    (split in place where TMA landed them: q k^T's B) are `split_tf32` of K
    bit for bit; V^T (p v's B, keys in `perm8` order) times p as the
    registers hold it is p v bit for bit, and not in key order; qs^T (dk's
    B, the same for dO^T and dv) times ds^T as held is ds^T qs; K^T (dq's
    B, keys in order) times the ds tile ([64 queries][64 keys], 128-byte
    atoms) is ds k."""
    r = np.random.default_rng(d)
    mk = lambda *s: torch.from_numpy(r.standard_normal(s).astype(np.float32))
    held = torch.argsort(k2.perm8(torch.arange(SLOTS)))
    # K: a k-step of 8 dims is 32 bytes on within the row; 64-key chunks
    k = mk(2, SLOTS, d)
    land = _landed(k, d)
    hi, lo = _split(land)                   # the split in place, chunk-wise
    want = _split(k)
    for ch in range(4):
        for kd in range(d // 8):
            start = ch * 64 * 4 * d + 32 * kd
            for got, x in zip((hi, lo), want):
                g = _kmajor(got, start, 64, 4 * d, 32 * d)
                ref = x[..., 64 * ch:64 * ch + 64, 8 * kd:8 * kd + 8]
                assert torch.equal(g.view(torch.int32), ref.view(torch.int32))
    # V^T from the landed V: p v
    v = k2.tf32_round(mk(2, SLOTS, d))
    p = k2.tf32_round(torch.from_numpy(r.uniform(0, 1, (2, 40, SLOTS))
                                       .astype(np.float32)))
    vth, vtl = _b_operand(_transposed(_landed(v, d), d, k2.perm8), d,
                          SLOTS // 8)
    assert not vtl.any()                    # v is TF32 already: lo is zero
    want = p.double() @ v.double()
    assert torch.equal(p[..., held].double() @ vth.transpose(-1, -2).double(),
                       want)
    assert not torch.equal(p.double() @ vth.transpose(-1, -2).double(), want)
    # qs^T of a query group (64 rows): ds^T qs
    qs = k2.tf32_round(mk(2, 64, d))
    dst = k2.tf32_round(mk(2, 64, 64))      # [keys, queries]
    qth, _ = _b_operand(_transposed(_landed(qs, d), d, k2.perm8), d, 8)
    assert torch.equal(dst[..., held[:64]].double()
                       @ qth.transpose(-1, -2).double(),
                       dst.double() @ qs.double())
    # K^T of a key group (keys in order) and the ds tile: ds k
    kg = k2.tf32_round(mk(2, 64, d))
    kth, _ = _b_operand(_transposed(_landed(kg, d), d, lambda x: x), d, 8)
    ds = k2.tf32_round(mk(2, 64, 64))       # [queries, keys]
    qq, kq = torch.arange(64)[:, None], torch.arange(64)[None, :]
    tile = torch.zeros(2, 4096)
    tile[..., ((kq >> 5) * 8192 + k2._sw128(qq, kq & 31)) // 4] = ds
    a = torch.cat([_kmajor(tile, (j // 4) * 8192 + (j % 4) * 32, 64, 128, 1024)
                   for j in range(8)], -1)
    assert torch.equal(a, ds)
    assert torch.equal(a.double() @ kth.transpose(-1, -2).double(),
                       ds.double() @ kg.double())
