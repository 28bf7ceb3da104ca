"""The design accuracy of K2's f32 tensor-core bodies (csrc/
flash_attention_fwd.cuh `flash_fwd_tf32`, csrc/flash_attention_bwd.cuh
`flash_bwd_fused_tf32`), on the CPU: every product there is three TF32
passes, a_lo b_hi + a_hi b_lo + a_hi b_hi with hi = tf32(x), lo = tf32(x -
hi), rounded to nearest with ties away (`cvt.rna`). `tf32_round` and
`split_tf32` emulate that rounding; here the emulated forward and backward
are held against float64 at the teacher's magnitudes (q, k, v ~ N(0, 1),
bias 0.5 N(0, 1), 4096 keys), and one pass is shown to miss phase 4's f32
bar of 1e-5. The emulated forward also agrees with the JAX package's
Pallas kernel (interpret mode). The kernels themselves are held against the
plain version on a CUDA card by tests/test_torch_kernels.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lunaris_orion_tpu.ops.pallas import flash_attention as fa
from lunaris_orion_tpu_torch.ops.cuda import flash_attention as k2
from test_torch_kernels import torch_threads  # noqa: F401 (autouse)


def _inputs(b, h, nq, nk, d, seed):
    r = np.random.default_rng(seed)
    q = r.standard_normal((b, h, nq, d)).astype(np.float32)
    k = r.standard_normal((b, h, nk, d)).astype(np.float32)
    v = r.standard_normal((b, h, nk, d)).astype(np.float32)
    bias = (0.5 * r.standard_normal((h, nk))).astype(np.float32)
    do = r.standard_normal((b, h, nq, d)).astype(np.float32)
    return [torch.from_numpy(x) for x in (q, k, v, bias, do)]


def _mm(a, b, passes):
    """a @ b with f32 sums over TF32 operands: three passes (the small
    cross terms first, as the kernels order them) or one."""
    if passes == 1:
        return k2.tf32_round(a) @ k2.tf32_round(b)
    ah, al = k2.split_tf32(a)
    bh, bl = k2.split_tf32(b)
    return (al @ bh + ah @ bl) + ah @ bh


def _keep(b, h, nq, nk, rate, seed):
    """The forward's hash mask [B, H, Nq, Nk], or None at rate 0."""
    if rate == 0.0:
        return None
    rs = k2.row_seeds(seed, b * h).reshape(b, h, 1, 1)
    return k2.keep_mask(rs, torch.arange(nk), torch.arange(nq)[:, None],
                        k2.dropout_threshold(1.0 - rate))


def _forward(q, k, v, bias, keep, rate, passes=None):
    """o, lse, p: with `passes` the kernels' arithmetic (f32, TF32 operands
    in that many passes), else float64 throughout."""
    dt = torch.float32 if passes else torch.float64
    q, k, v, bias = (x.to(dt) for x in (q, k, v, bias))
    qs = q * torch.tensor(q.shape[-1] ** -0.5, dtype=torch.float32).to(dt)
    mm = (lambda a, b: _mm(a, b, passes)) if passes else torch.matmul
    s = mm(qs, k.transpose(-1, -2)) + bias[None, :, None, :]
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l_sum = p.sum(-1, keepdim=True)
    pd = p if keep is None else torch.where(keep, p * k2._inv_keep(rate), 0.0)
    o = mm(pd, v) / l_sum
    return o, (m + torch.log(l_sum)).squeeze(-1), qs


def _backward(q, k, v, bias, do, keep, rate, passes=None):
    """dq, dk, dv, dbias of the fused kernel's five products, as
    `attention_bwd_plain` forms them, with `passes` as in `_forward`."""
    dt = torch.float32 if passes else torch.float64
    o, lse, qs = _forward(q, k, v, bias, keep, rate, passes)
    k, v, bias, do = (x.to(dt) for x in (k, v, bias, do))
    mm = (lambda a, b: _mm(a, b, passes)) if passes else torch.matmul
    s = mm(qs, k.transpose(-1, -2)) + bias[None, :, None, :]
    p = torch.exp(s - lse[..., None])
    dp = mm(do, v.transpose(-1, -2))
    pv = p
    if keep is not None:
        dp = torch.where(keep, dp * k2._inv_keep(rate), 0.0)
        pv = torch.where(keep, p * k2._inv_keep(rate), 0.0)
    ds = p * (dp - (o * do).sum(-1, keepdim=True))
    scale = q.shape[-1] ** -0.5
    return (mm(ds, k) * scale, mm(ds.transpose(-1, -2), qs),
            mm(pv.transpose(-1, -2), do), ds.sum((0, 2)))


@pytest.mark.parametrize("d", [16, 32])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_three_tf32_passes_hold_the_forward_to_f64(d, rate):
    """Three passes: o and lse within 1e-6 of float64 (f32's own rounding
    is ~1e-7 on o, half an ulp of lse ~ 9 is 5e-7). One pass: o misses
    phase 4's f32 bar of 1e-5, which is why the kernels take three."""
    q, k, v, bias, _ = _inputs(1, 2, 512, 4096, d, seed=d)
    keep = _keep(1, 2, 512, 4096, rate, seed=-1234567)
    ref_o, ref_lse, _ = _forward(q, k, v, bias, keep, rate)
    o3, lse3, _ = _forward(q, k, v, bias, keep, rate, passes=3)
    o1, lse1, _ = _forward(q, k, v, bias, keep, rate, passes=1)
    err3 = (o3.double() - ref_o).abs().max().item()
    err1 = (o1.double() - ref_o).abs().max().item()
    assert err3 <= 1e-6, err3
    assert (lse3.double() - ref_lse).abs().max().item() <= 1e-6
    assert err1 > 1e-5, err1
    assert err1 > 30 * err3


@pytest.mark.parametrize("d", [16, 32])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_three_tf32_passes_hold_the_backward_to_f64(d, rate):
    """The fused backward's five products in three passes: every gradient
    within 1e-5 of its largest magnitude of float64 (f32 sums over 512
    queries leave ~1e-6), a tenth of phase 7's f32 bar (1e-4 of the
    largest + 1e-6). One pass misses that bar in every gradient."""
    q, k, v, bias, do = _inputs(1, 2, 512, 2048, d, seed=100 + d)
    keep = _keep(1, 2, 512, 2048, rate, seed=99)
    ref = _backward(q, k, v, bias, do, keep, rate)
    three = _backward(q, k, v, bias, do, keep, rate, passes=3)
    one = _backward(q, k, v, bias, do, keep, rate, passes=1)
    for name, g3, g1, r in zip(("dq", "dk", "dv", "dbias"), three, one, ref):
        top = r.abs().max().item()
        assert (g3.double() - r).abs().max().item() <= 1e-5 * top, name
        assert (g1.double() - r).abs().max().item() > 1e-4 * top + 1e-6, name


@pytest.mark.parametrize("rate,seed", [(0.0, 0), (0.1, 1234567)])
def test_three_tf32_passes_match_pallas(rate, seed):
    """The emulated three-pass forward against the JAX package's Pallas
    kernel (interpret mode), at phase 4's f32 bar."""
    q, k, v, bias, _ = _inputs(1, 2, 256, 256, 16, seed=7)
    want = np.asarray(fa.attention_bhnd(
        *(jnp.asarray(x.numpy()) for x in (q, k, v, bias)),
        dropout_rate=rate, seed=jnp.int32(seed)))
    o, _, _ = _forward(q, k, v, bias, _keep(1, 2, 256, 256, rate, seed), rate,
                       passes=3)
    np.testing.assert_allclose(o.numpy(), want, atol=1e-5, rtol=0)


def test_tf32_round_is_rna_on_the_bits():
    """Ties go away from zero, the low 13 bits clear, and hi + lo carries
    x to within 2^-22 of |x|."""
    x = torch.tensor([1.0, 1 + 2**-11, 1 + 3 * 2**-11, -(1 + 2**-11),
                      1 + 2**-12, -0.0, 3 * 2**-11 + 2**-22])
    want = torch.tensor([1.0, 1 + 2**-10, 1 + 2**-9, -(1 + 2**-10), 1.0,
                         -0.0, 3 * 2**-11])
    got = k2.tf32_round(x)
    assert torch.equal(got, want)
    assert not (got.view(torch.int32) & 0x1FFF).any()
    r = torch.from_numpy(np.random.default_rng(3).standard_normal(4096)
                         .astype(np.float32)) * 10.0
    hi, lo = k2.split_tf32(r)
    assert not ((hi.view(torch.int32) | lo.view(torch.int32)) & 0x1FFF).any()
    assert ((hi.double() + lo.double() - r.double()).abs()
            <= 2.0**-22 * r.double().abs()).all()
    assert ((k2.tf32_round(r).double() - r.double()).abs()
            <= 2.0**-11 * r.double().abs()).all()


# --- the f32 warpgroup bodies at d 16 (flash_fwd_wgmma_tf32,
# flash_bwd_wgmma_tf32): the pre-pass's tiles as wgmma reads them, and the
# bodies' arithmetic on them -------------------------------------------------

def _kmajor(tile, start, rows, span, sbo):
    """A K-major TF32 operand [rows, 8] as wgmma reads it from a tile (the
    tile's bytes as f32 values, last dim): row n at byte start + (n // 8)
    sbo + (n % 8) span, element k 4 k further on, the swizzle of `span`
    bytes (32: bit 4 ^= bit 7; 128: bits 4-6 ^= bits 7-9) on the address,
    the tile's start being 1024-aligned. `start`, `span` and `sbo` are the
    kernels' descriptors (hopper.cuh)."""
    n = torch.arange(rows)[:, None]
    k = torch.arange(8)[None, :]
    addr = start + (n // 8) * sbo + (n % 8) * span + 4 * k
    addr = addr ^ (((addr >> 7) & (span // 16 - 1)) << 4)
    return tile[..., addr // 4]


def _rows(tile, base, row0, rows):
    """hi, lo [.., rows, 16] of a row-major pair of [64][8] tiles (32-byte
    swizzle; lo 4096 bytes on), rows row0.. : q k^T's, s^T's, dp^T's B."""
    return [torch.cat([_kmajor(tile, base + lo + kd * 2048 + row0 * 32, rows,
                               32, 256) for kd in (0, 1)], -1)
            for lo in (0, 4096)]


def _cols(tile, base, k0, steps):
    """hi, lo [.., 16, 8 steps] of a transposed pair ([32][32] atoms, 128-byte
    swizzle, rows 16-31 lo), k-steps k0 / 8 .. : p v's, dk's, dv's, dq's B."""
    m = torch.cat([_kmajor(tile, base + ((k0 // 8 + j) // 4) * 4096
                           + ((k0 // 8 + j) % 4) * 32, 32, 128, 1024)
                   for j in range(steps)], -1)
    return m[..., :16, :], m[..., 16:, :]


# The keys (queries) of a tile in the order the registers hold them along
# p v's (dk's, dv's) k: position i holds key _AS_HELD[i].
_AS_HELD = torch.argsort(k2.perm8(torch.arange(64)))


def _x3(ah, al, bh, bl):
    """One three-pass product, the kernels' order: small terms first."""
    return (al @ bh + ah @ bl) + ah @ bh


def _rows_d(tile, base, rows, d, n):
    """hi, lo [.., rows, d] of a row pair of a tile of n rows: [n][8] tiles
    (32-byte swizzle), one a k-step of 8 dims, lo 4 n d bytes on: the rows
    of the d 32, 48 and 64 bodies (K, V; qs, dO)."""
    return [torch.cat([_kmajor(tile, base + lo + kd * 32 * n, rows, 32, 256)
                       for kd in range(d // 8)], -1) for lo in (0, 4 * n * d)]


def _trows(tile, base, steps, d, n):
    """hi, lo [.., d, 8 steps] of transposed rows of a tile of n rows: a
    [d][8] tile (32-byte swizzle) a k-step of 8 rows, lo 4 n d bytes on:
    qs^T, dO^T and K^T of the d 32, 48 and 64 backward."""
    return [torch.cat([_kmajor(tile, base + lo + j * 32 * d, d, 32, 256)
                       for j in range(steps)], -1) for lo in (0, 4 * n * d)]


def _cols_d(tile, base, steps, d):
    """hi, lo [.., d, 8 steps] of the forward's V^T at head size d: [2 d][32]
    atoms (128-byte swizzle), rows d .. 2 d - 1 lo, 256 d bytes apart."""
    m = torch.cat([_kmajor(tile, base + (j // 4) * 256 * d + (j % 4) * 32,
                           2 * d, 128, 1024) for j in range(steps)], -1)
    return m[..., :d, :], m[..., d:, :]


def _fwd_wgmma_tf32(q, k, v, bias, keep, rate):
    """o, lse of flash_fwd_wgmma_tf32's arithmetic in f32, on the pre-pass's
    tiles as its descriptors read them: key tiles of 64; s = bias + three
    passes a k-step of 8 (q lo K hi, q hi K lo, q hi K hi); the online
    softmax with each lane's share of the row sum (keys 8 j + 2 t + e: a
    tile's in two chains by j % 2, then added) summed over the row's 4
    lanes at the end; p dropped, taken as
    the registers hold it and split; p v from zero a tile: at d 16 (p hi V
    lo + p lo V hi) + p hi V hi, at d 32, 48 and 64 the three passes a
    k-step of 8 keys into one sum; o = o corr + pv."""
    b, h, nq, d = q.shape
    nk = k.shape[2]
    qh, ql = k2.split_tf32(q * torch.tensor(d ** -0.5, dtype=torch.float32))
    blob = k2.tf32_tiles_plain(k2.TF32_FWD, k, v).reshape(b, h, -1, 256 * d)
    tiles = blob.shape[2]
    bias = torch.nn.functional.pad(bias, (0, 64 * tiles - nk),
                                   value=-float("inf"))
    o = torch.zeros(b, h, nq, d)
    m = torch.full((b, h, nq, 1), -1e30)
    l_sum = torch.zeros(b, h, nq, 4)              # lane t's share
    for t in range(tiles):
        tile = blob[:, :, t]
        if d == 16:
            kh, kl = _rows(tile, 0, 0, 64)
            vth, vtl = _cols(tile, 8192, 0, 8)
        else:
            kh, kl = _rows_d(tile, 0, 64, d, 64)
            vth, vtl = _cols_d(tile, 512 * d, 8, d)
        s = bias[None, :, None, 64 * t:64 * t + 64].expand(b, h, nq, 64)
        for kd in range(d // 8):
            c = slice(8 * kd, 8 * kd + 8)
            tr = lambda x: x[..., c].transpose(-1, -2)
            s = s + ql[..., c] @ tr(kh)
            s = s + qh[..., c] @ tr(kl)
            s = s + qh[..., c] @ tr(kh)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        lq = torch.zeros(2, b, h, nq, 4)
        for j in range(8):
            for e in range(2):
                lq[j % 2] += p.reshape(b, h, nq, 8, 4, 2)[..., j, :, e]
        l_sum = l_sum * corr + (lq[0] + lq[1])
        if keep is not None:
            kt = torch.nn.functional.pad(keep, (0, 64 * tiles - nk))
            p = torch.where(kt[..., 64 * t:64 * t + 64], p * k2._inv_keep(rate),
                            0.0)
        ph, pl = k2.split_tf32(p[..., _AS_HELD])
        if d == 16:
            pv = _x3(ph, pl, vth.transpose(-1, -2), vtl.transpose(-1, -2))
        else:
            pv = torch.zeros(b, h, nq, d)
            for j in range(8):
                c = slice(8 * j, 8 * j + 8)
                tr = lambda x: x[..., c].transpose(-1, -2)
                pv = pv + pl[..., c] @ tr(vth)
                pv = pv + ph[..., c] @ tr(vtl)
                pv = pv + ph[..., c] @ tr(vth)
        o = o * corr + pv
        m = m_new
    l_sum = (l_sum[..., :1] + l_sum[..., 1:2]) + (l_sum[..., 2:3]
                                                  + l_sum[..., 3:])
    return o / l_sum, (m + torch.log(l_sum)).squeeze(-1)


def _bwd_wgmma_tf32(q, k, v, bias, do, o, lse, keep, rate):
    """dq, dk, dv, dbias of flash_bwd_wgmma_tf32's arithmetic in f32, on the
    pre-pass's tiles as its descriptors read them: query tiles of 64 in two
    halves of 32; s^T = bias + three passes a k-step (k lo qs hi, k hi qs lo,
    k hi qs hi), dp^T from zero the same way; p = 2^(s log2 e - lse log2 e);
    ds and pv as the registers hold them, split; dk and dv from zero a tile,
    three passes, then added; dq = (ds hi K lo + ds lo K hi) + ds hi K hi
    over each 64 keys (a consumer warpgroup) and query tile, summed."""
    b, h, nq, d = q.shape
    nk = k.shape[2]
    scale = float(torch.tensor(d ** -0.5, dtype=torch.float32))
    delta = (o * do).sum(-1)
    qb = k2.tf32_tiles_plain(k2.TF32_BWD_Q, q, do, lse.reshape(b * h, nq),
                             delta, scale).reshape(b, h, -1, 8320)
    kb = k2.tf32_tiles_plain(k2.TF32_BWD_K, k).reshape(b, h, -1, 2048)
    tq, nkp = qb.shape[2], 64 * kb.shape[2]
    pad = lambda x: torch.nn.functional.pad(x, (0, 0, 0, nkp - nk))
    khi, klo = k2.split_tf32(pad(k))
    vhi, vlo = k2.split_tf32(pad(v))
    bk = torch.nn.functional.pad(bias, (0, nkp - nk))[None, :, :, None]
    if keep is not None:
        keep = torch.nn.functional.pad(keep, (0, nkp - nk, 0, 64 * tq - nq))
    dk, dv = torch.zeros(b, h, nkp, d), torch.zeros(b, h, nkp, d)
    db = torch.zeros(b, h, nkp)
    dq = torch.zeros(b, h, 64 * tq, d)
    held = _AS_HELD[:32]
    kts = [[x.transpose(-1, -2) for x in _cols(kb[:, :, w], 0, 0, 8)]
           for w in range(kb.shape[2])]                # K^T hi, lo: [64, 16]
    for t in range(tq):
        tile = qb[:, :, t]
        tk, tv = torch.zeros(b, h, nkp, d), torch.zeros(b, h, nkp, d)
        ds_tile = []
        for hf in (0, 1):
            qsh, qsl = _rows(tile, 0, 32 * hf, 32)
            doh, dol = _rows(tile, 8192, 32 * hf, 32)
            s, dp = bk.expand(b, h, nkp, 32), torch.zeros(b, h, nkp, 32)
            for kd in (0, 1):
                c = slice(8 * kd, 8 * kd + 8)
                tr = lambda x: x[..., c].transpose(-1, -2)
                s = s + klo[..., c] @ tr(qsh)
                s = s + khi[..., c] @ tr(qsl)
                s = s + khi[..., c] @ tr(qsh)
                dp = dp + vlo[..., c] @ tr(doh)
                dp = dp + vhi[..., c] @ tr(dol)
                dp = dp + vhi[..., c] @ tr(doh)
            rows = slice(32 * hf, 32 * hf + 32)
            nl = tile[..., 8192:8256][..., None, rows]
            dl = tile[..., 8256:8320][..., None, rows]
            p = torch.exp2(s * torch.tensor(k2._LOG2E) + nl)
            pv = p
            if keep is not None:
                kt = keep[..., 64 * t + 32 * hf:64 * t + 32 * hf + 32, :]
                kinv = torch.where(kt.transpose(-1, -2), k2._inv_keep(rate), 0.0)
                dp, pv = dp * kinv, p * kinv
            ds = p * (dp - dl)
            db += ds.sum(-1)
            ds_tile.append(ds)
            dsh, dsl = k2.split_tf32(ds[..., held])
            pvh, pvl = k2.split_tf32(pv[..., held])
            qth, qtl = _cols(tile, 16384, 32 * hf, 4)
            oth, otl = _cols(tile, 24576, 32 * hf, 4)
            tk = tk + _x3(dsh, dsl, qth.transpose(-1, -2), qtl.transpose(-1, -2))
            tv = tv + _x3(pvh, pvl, oth.transpose(-1, -2), otl.transpose(-1, -2))
        dk, dv = dk + tk, dv + tv
        dsq = torch.cat(ds_tile, -1).transpose(-1, -2)       # [.., 64 q, keys]
        for w, (kth, ktl) in enumerate(kts):
            dh, dlo = k2.split_tf32(dsq[..., 64 * w:64 * w + 64])
            dq[:, :, 64 * t:64 * t + 64] += _x3(dh, dlo, kth, ktl)
    return (dq[:, :, :nq] * scale, dk[:, :, :nk], dv[:, :, :nk],
            db[..., :nk].sum(0))


def _bwd_wgmma_tf32_wide(q, k, v, bias, do, o, lse, keep, rate):
    """dq, dk, dv, dbias of flash_bwd_wgmma_tf32's arithmetic at d 32, 48
    and 64 in f32, on the pre-pass's tiles as its descriptors read them:
    warpgroups of 64 keys (K, V and K^T from the warpgroup's key tile; at d
    32 two a block, whose arithmetic is each one's), query tiles of 64 in
    sub-tiles of 16; s^T = bias + three passes a k-step of 8 dims (k lo qs
    hi, k hi qs lo, k hi qs hi), dp^T from zero the same way; p = 2^(s log2
    e - lse log2 e); ds and pv as the registers hold them, split; dk and dv
    from zero a query tile, three passes a k-step of 8 queries into one sum,
    then added; dq of each block and query tile from zero, three passes a
    k-step of 8 keys (ds lo K hi, ds hi K lo, ds hi K hi), summed."""
    b, h, nq, d = q.shape
    nk = k.shape[2]
    scale = float(torch.tensor(d ** -0.5, dtype=torch.float32))
    delta = (o * do).sum(-1)
    sub = (512 * d + 128) // 4                     # a sub-tile's floats
    qb = k2.tf32_tiles_plain(k2.TF32_BWD_Q, q, do, lse.reshape(b * h, nq),
                             delta, scale).reshape(b, h, -1, 4 * sub)
    kb = k2.tf32_tiles_plain(k2.TF32_BWD_K, k, v).reshape(b, h, -1, 384 * d)
    tq, blocks = qb.shape[2], kb.shape[2]
    nkp = 64 * blocks
    side = lambda base: [torch.cat(x, -2) for x in zip(
        *(_rows_d(kb[:, :, w], base, 64, d, 64) for w in range(blocks)))]
    khi, klo = side(0)
    vhi, vlo = side(512 * d)
    kts = [_trows(kb[:, :, w], 1024 * d, 8, d, 64) for w in range(blocks)]
    bk = torch.nn.functional.pad(bias, (0, nkp - nk))[None, :, :, None]
    if keep is not None:
        keep = torch.nn.functional.pad(keep, (0, nkp - nk, 0, 64 * tq - nq))
    dk, dv = torch.zeros(b, h, nkp, d), torch.zeros(b, h, nkp, d)
    db = torch.zeros(b, h, nkp)
    dq = torch.zeros(b, h, 64 * tq, d)
    held = _AS_HELD[:16]
    for t in range(tq):
        tk, tv = torch.zeros(b, h, nkp, d), torch.zeros(b, h, nkp, d)
        ds_tile = []
        for u in range(4):
            st = qb[:, :, t, u * sub:(u + 1) * sub]
            qsh, qsl = _rows_d(st, 0, 16, d, 16)
            doh, dol = _rows_d(st, 128 * d, 16, d, 16)
            qth, qtl = _trows(st, 256 * d, 2, d, 16)
            oth, otl = _trows(st, 384 * d, 2, d, 16)
            nl = st[..., None, 128 * d:128 * d + 16]
            dl = st[..., None, 128 * d + 16:128 * d + 32]
            s, dp = bk.expand(b, h, nkp, 16), torch.zeros(b, h, nkp, 16)
            for kd in range(d // 8):
                c = slice(8 * kd, 8 * kd + 8)
                tr = lambda x: x[..., c].transpose(-1, -2)
                s = s + klo[..., c] @ tr(qsh)
                s = s + khi[..., c] @ tr(qsl)
                s = s + khi[..., c] @ tr(qsh)
                dp = dp + vlo[..., c] @ tr(doh)
                dp = dp + vhi[..., c] @ tr(dol)
                dp = dp + vhi[..., c] @ tr(doh)
            p = torch.exp2(s * torch.tensor(k2._LOG2E) + nl)
            pv = p
            if keep is not None:
                kt = keep[..., 64 * t + 16 * u:64 * t + 16 * u + 16, :]
                kinv = torch.where(kt.transpose(-1, -2), k2._inv_keep(rate), 0.0)
                dp, pv = dp * kinv, p * kinv
            ds = p * (dp - dl)
            db += ds.sum(-1)
            ds_tile.append(ds)
            dsh, dsl = k2.split_tf32(ds[..., held])
            pvh, pvl = k2.split_tf32(pv[..., held])
            for j in range(2):
                c = slice(8 * j, 8 * j + 8)
                tr = lambda x: x[..., c].transpose(-1, -2)
                tv = tv + pvl[..., c] @ tr(oth)
                tv = tv + pvh[..., c] @ tr(otl)
                tv = tv + pvh[..., c] @ tr(oth)
                tk = tk + dsl[..., c] @ tr(qth)
                tk = tk + dsh[..., c] @ tr(qtl)
                tk = tk + dsh[..., c] @ tr(qth)
        dk, dv = dk + tk, dv + tv
        dsq = torch.cat(ds_tile, -1).transpose(-1, -2)       # [.., 64 q, keys]
        for w, (kth, ktl) in enumerate(kts):                 # [d, 64 keys]
            acc = torch.zeros(b, h, 64, d)
            for kk in range(8):
                dh, dlo = k2.split_tf32(dsq[..., 64 * w + 8 * kk:64 * w + 8 * kk + 8])
                c = slice(8 * kk, 8 * kk + 8)
                tr = lambda x: x[..., c].transpose(-1, -2)
                acc = acc + dlo @ tr(kth)
                acc = acc + dh @ tr(ktl)
                acc = acc + dh @ tr(kth)
            dq[:, :, 64 * t:64 * t + 64] += acc
    return (dq[:, :, :nq] * scale, dk[:, :, :nk], dv[:, :, :nk],
            db[..., :nk].sum(0))


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_wgmma_tf32_forward_holds_to_f64(rate):
    """flash_fwd_wgmma_tf32's arithmetic (key tiles of 64, its pass order, p
    v from zero a tile, the operands read through the pre-pass's layout):
    o and lse within 1e-6 of float64, the bars the mma.sync body's design
    is held to above; a ragged Nk on the last tile."""
    q, k, v, bias, _ = _inputs(1, 2, 256, 4000, 16, seed=16)
    keep = _keep(1, 2, 256, 4000, rate, seed=-1234567)
    ref_o, ref_lse, _ = _forward(q, k, v, bias, keep, rate)
    o, lse = _fwd_wgmma_tf32(q, k, v, bias, keep, rate)
    assert (o.double() - ref_o).abs().max().item() <= 1e-6
    assert (lse.double() - ref_lse).abs().max().item() <= 1e-6


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_wgmma_tf32_backward_holds_to_f64(rate):
    """flash_bwd_wgmma_tf32's arithmetic (query tiles of 64 in halves of 32,
    its pass order, dk and dv from zero a tile, dq over 64 keys a tile and
    summed, the operands read through the pre-pass's layout): every
    gradient within 1e-5 of its largest magnitude of float64, the mma.sync
    body's bar above; ragged Nq and Nk."""
    q, k, v, bias, do = _inputs(1, 2, 300, 1000, 16, seed=116)
    keep = _keep(1, 2, 300, 1000, rate, seed=99)
    ref = _backward(q, k, v, bias, do, keep, rate)
    o, lse = _fwd_wgmma_tf32(q, k, v, bias, keep, rate)
    got = _bwd_wgmma_tf32(q, k, v, bias, do, o, lse, keep, rate)
    for name, g, r in zip(("dq", "dk", "dv", "dbias"), got, ref):
        top = r.abs().max().item()
        assert (g.double() - r).abs().max().item() <= 1e-5 * top, name


@pytest.mark.parametrize("rate,seed", [(0.0, 0), (0.1, 1234567)])
def test_wgmma_tf32_bodies_match_pallas(rate, seed):
    """The emulated f32 warpgroup forward and backward against the JAX
    package's Pallas kernel and its gradients (interpret mode), at 1e-5."""
    q, k, v, bias, do = _inputs(1, 2, 256, 256, 16, seed=17)
    keep = _keep(1, 2, 256, 256, rate, seed)
    jq, jk, jv, jb = (jnp.asarray(x.numpy()) for x in (q, k, v, bias))
    kw = dict(dropout_rate=rate, seed=jnp.int32(seed))
    want = np.asarray(fa.attention_bhnd(jq, jk, jv, jb, **kw))
    o, lse = _fwd_wgmma_tf32(q, k, v, bias, keep, rate)
    np.testing.assert_allclose(o.numpy(), want, atol=1e-5, rtol=0)
    loss = lambda *a: jnp.sum(fa.attention_bhnd(*a, **kw) * jnp.asarray(
        do.numpy()))
    grads = jax.grad(loss, argnums=(0, 1, 2, 3))(jq, jk, jv, jb)
    got = _bwd_wgmma_tf32(q, k, v, bias, do, o, lse, keep, rate)
    for name, g, w in zip(("dq", "dk", "dv", "dbias"), got, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=0, err_msg=name)


def test_permuted_transposed_operand_gives_the_plain_product():
    """perm8 puts key 2t + e of each 8 at k index t + 4 e: the C fragment
    element the kernels take as A element (e * 2 + row half) holds it. So p
    as the registers hold it times V^T read through the pre-pass's permuted
    atoms is p v, bit for bit with the product in key order."""
    for t in range(4):
        for e in range(2):
            assert k2.perm8(2 * t + e) == t + 4 * e
            assert k2.perm8(8 + 2 * t + e) == 8 + t + 4 * e
    r = np.random.default_rng(5)
    p = torch.from_numpy(r.uniform(0, 1, (2, 3, 40, 64)).astype(np.float32))
    v = torch.from_numpy(r.standard_normal((2, 3, 64, 16)).astype(np.float32))
    p, v = k2.tf32_round(p), k2.tf32_round(v)
    tile = k2.tf32_tiles_plain(k2.TF32_FWD, torch.zeros_like(v), v)[:, 0]
    vth, vtl = _cols(tile.reshape(2, 3, -1), 8192, 0, 8)
    assert not vtl.any()            # v is TF32 already: its lo is zero
    got = p[..., _AS_HELD].double() @ vth.transpose(-1, -2).double()
    want = p.double() @ v.double()
    assert torch.equal(got, want)
    assert not torch.equal(p.double() @ vth.transpose(-1, -2).double(), want)


@pytest.mark.parametrize("mode", [0, 1, 2])
@pytest.mark.parametrize("n", [64, 300])
def test_tf32_tiles_plain_holds_split_tf32_as_wgmma_reads_it(mode, n):
    """Every operand of the pre-pass's tiles, read through the kernels'
    descriptors, is `split_tf32` of its source bit for bit (qs = q d^-1/2 in
    f32), in its row or permuted column; rows past N are zeros, -lse log2 e
    is -inf there; each tile's bytes are written once."""
    r = np.random.default_rng(mode + n)
    mk = lambda *s: torch.from_numpy(r.standard_normal(s).astype(np.float32))
    a, b = mk(2, 3, n, 16), mk(2, 3, n, 16)
    lse, delta = mk(6, n), mk(2, 3, n)
    scale = float(torch.tensor(0.25))
    blob = k2.tf32_tiles_plain(mode, a, b, lse, delta, scale)
    tiles = k2.tf32_tile_count(mode, n)
    assert blob.shape == (6, tiles, k2.tf32_tile_bytes(mode, 16) // 4)
    pad = lambda x: torch.nn.functional.pad(
        x.reshape(6, n, 16), (0, 0, 0, 64 * tiles - n)).reshape(
            6, tiles, 64, 16)
    src = {0: (a, b), 1: (a * torch.tensor(scale), b), 2: (a,)}[mode]
    for i, x in enumerate(src):
        hi, lo = k2.split_tf32(pad(x))
        if mode == 1 or (mode, i) == (0, 0):   # rows (K; qs, dO)
            got = _rows(blob, 8192 * i, 0, 64)
            for g, w in zip(got, (hi, lo)):
                assert torch.equal(g.view(torch.int32), w.view(torch.int32))
        if mode > 0 or i == 1:             # transposed (V; qs, dO; K)
            base = {0: 8192, 1: 16384 + 8192 * i, 2: 0}[mode]
            got = _cols(blob, base, 0, 8)
            order = torch.arange(64) if mode == 2 else _AS_HELD
            for g, w in zip(got, (hi, lo)):
                want = w[..., order, :].transpose(-1, -2)
                assert torch.equal(g.view(torch.int32), want.view(torch.int32))
    if mode == 1:
        nl = blob[..., 8192:8256].reshape(6, -1)
        want = -lse * torch.tensor(k2._LOG2E)
        assert torch.equal(nl[:, :n], want)
        assert torch.isneginf(nl[:, n:]).all()
        assert torch.equal(blob[..., 8256:8320].reshape(6, -1)[:, :n],
                           delta.reshape(6, n))
    # each byte once: the maps are a permutation of the tile
    maps, stats = k2._tile_maps(mode, 16)
    flat = torch.cat([x.flatten() for _, hi, lo in maps for x in (hi, lo)]
                     + ([x.flatten() for x in stats] if stats else []))
    assert torch.equal(flat.sort().values,
                       4 * torch.arange(k2.tf32_tile_bytes(mode, 16) // 4))


# --- the f32 warpgroup bodies at d 32, 48 and 64 (the low-end, mid-range and
# H100-tier widths): two forward warpgroups on key tiles of 1024 d bytes;
# backward warpgroups of 64 keys on query sub-tiles of 16 ---------------------

@pytest.mark.parametrize("d", [32, 48, 64])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_wgmma_tf32_wide_forward_holds_to_f64(d, rate):
    """flash_fwd_wgmma_tf32's arithmetic at d 32, 48 and 64 (key tiles of 64,
    p v from zero a tile with the three passes a k-step in one sum, the
    operands read through the pre-pass's layout at that width): o and lse
    within 1e-6 of float64; a ragged Nk on the last tile."""
    q, k, v, bias, _ = _inputs(1, 2, 256, 4000, d, seed=d + int(10 * rate))
    keep = _keep(1, 2, 256, 4000, rate, seed=-1234567)
    ref_o, ref_lse, _ = _forward(q, k, v, bias, keep, rate)
    o, lse = _fwd_wgmma_tf32(q, k, v, bias, keep, rate)
    assert (o.double() - ref_o).abs().max().item() <= 1e-6
    assert (lse.double() - ref_lse).abs().max().item() <= 1e-6


@pytest.mark.parametrize("d", [32, 48, 64])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_wgmma_tf32_wide_backward_holds_to_f64(d, rate):
    """flash_bwd_wgmma_tf32's arithmetic at d 32, 48 and 64 (64 keys a warpgroup,
    query sub-tiles of 16, dk and dv from zero a query tile of 64, dq of a
    block and tile from zero, the operands read through the pre-pass's
    layout at that width): every gradient within 1e-5 of its largest
    magnitude of float64; ragged Nq and Nk."""
    q, k, v, bias, do = _inputs(1, 2, 300, 1000, d, seed=100 + d)
    keep = _keep(1, 2, 300, 1000, rate, seed=99)
    ref = _backward(q, k, v, bias, do, keep, rate)
    o, lse = _fwd_wgmma_tf32(q, k, v, bias, keep, rate)
    got = _bwd_wgmma_tf32_wide(q, k, v, bias, do, o, lse, keep, rate)
    for name, g, r in zip(("dq", "dk", "dv", "dbias"), got, ref):
        top = r.abs().max().item()
        assert (g.double() - r).abs().max().item() <= 1e-5 * top, name


@pytest.mark.parametrize("d,rate,seed", [(32, 0.0, 0), (32, 0.1, 1234567),
                                         (48, 0.0, 0), (64, 0.1, 1234567)])
def test_wgmma_tf32_wide_bodies_match_pallas(d, rate, seed):
    """The emulated f32 warpgroup forward and backward at d 32, 48 and 64
    against the JAX package's Pallas kernel and its gradients (interpret
    mode), at 1e-5."""
    q, k, v, bias, do = _inputs(1, 2, 256, 256, d, seed=17 + d)
    keep = _keep(1, 2, 256, 256, rate, seed)
    jq, jk, jv, jb = (jnp.asarray(x.numpy()) for x in (q, k, v, bias))
    kw = dict(dropout_rate=rate, seed=jnp.int32(seed))
    want = np.asarray(fa.attention_bhnd(jq, jk, jv, jb, **kw))
    o, lse = _fwd_wgmma_tf32(q, k, v, bias, keep, rate)
    np.testing.assert_allclose(o.numpy(), want, atol=1e-5, rtol=0)
    loss = lambda *a: jnp.sum(fa.attention_bhnd(*a, **kw) * jnp.asarray(
        do.numpy()))
    grads = jax.grad(loss, argnums=(0, 1, 2, 3))(jq, jk, jv, jb)
    got = _bwd_wgmma_tf32_wide(q, k, v, bias, do, o, lse, keep, rate)
    for name, g, w in zip(("dq", "dk", "dv", "dbias"), got, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=0, err_msg=name)


@pytest.mark.parametrize("d", [32, 48, 64])
@pytest.mark.parametrize("mode", [0, 1, 2])
def test_tf32_tiles_plain_wide_holds_split_tf32_as_wgmma_reads_it(d, mode):
    """At d 32, 48 and 64 every operand of the pre-pass's tiles, read through
    the kernels' descriptors at that width, is `split_tf32` of its source
    bit for bit (qs = q d^-1/2 in f32), in its row or transposed row or
    permuted atom column; rows past N are zeros, -lse log2 e is -inf there;
    each tile's bytes are written once."""
    n = 300
    r = np.random.default_rng(mode + d)
    mk = lambda *s: torch.from_numpy(r.standard_normal(s).astype(np.float32))
    a, b = mk(2, 3, n, d), mk(2, 3, n, d)
    lse, delta = mk(6, n), mk(2, 3, n)
    scale = float(torch.tensor(d ** -0.5))
    blob = k2.tf32_tiles_plain(mode, a, b, lse, delta, scale)
    tiles = k2.tf32_tile_count(mode, n)
    assert blob.shape == (6, tiles, k2.tf32_tile_bytes(mode, d) // 4)
    pad = lambda x: torch.nn.functional.pad(
        x.reshape(6, n, d), (0, 0, 0, 64 * tiles - n)).reshape(
            6, tiles, 64, d)
    same = lambda got, want: all(
        torch.equal(g.view(torch.int32), w.view(torch.int32))
        for g, w in zip(got, want))
    if mode == 0:
        assert same(_rows_d(blob, 0, 64, d, 64), k2.split_tf32(pad(a)))
        vt = [w[..., _AS_HELD, :].transpose(-1, -2)
              for w in k2.split_tf32(pad(b))]
        assert same(_cols_d(blob, 512 * d, 8, d), vt)
    elif mode == 2:
        kh, kl = k2.split_tf32(pad(a))
        assert same(_rows_d(blob, 0, 64, d, 64), (kh, kl))
        assert same(_rows_d(blob, 512 * d, 64, d, 64), k2.split_tf32(pad(b)))
        assert same(_trows(blob, 1024 * d, 8, d, 64),
                    (kh.transpose(-1, -2), kl.transpose(-1, -2)))
    else:
        sub = (512 * d + 128) // 4
        qs = k2.split_tf32(pad(a * torch.tensor(scale)))
        dos = k2.split_tf32(pad(b))
        nl = torch.nn.functional.pad(-lse * torch.tensor(k2._LOG2E),
                                     (0, 64 * tiles - n),
                                     value=-float("inf")).reshape(6, tiles, 64)
        dl = torch.nn.functional.pad(delta.reshape(6, n),
                                     (0, 64 * tiles - n)).reshape(6, tiles, 64)
        for u in range(4):
            st = blob[..., u * sub:(u + 1) * sub]
            rows = slice(16 * u, 16 * u + 16)
            part = lambda pair: [x[..., rows, :] for x in pair]
            held = lambda pair: [x[..., rows, :][..., _AS_HELD[:16], :]
                                 .transpose(-1, -2) for x in pair]
            assert same(_rows_d(st, 0, 16, d, 16), part(qs))
            assert same(_rows_d(st, 128 * d, 16, d, 16), part(dos))
            assert same(_trows(st, 256 * d, 2, d, 16), held(qs))
            assert same(_trows(st, 384 * d, 2, d, 16), held(dos))
            assert torch.equal(st[..., 128 * d:128 * d + 16], nl[..., rows])
            assert torch.equal(st[..., 128 * d + 16:128 * d + 32],
                               dl[..., rows])
    # each byte once: the maps are a permutation of the tile
    maps, stats = k2._tile_maps(mode, d)
    flat = torch.cat([x.flatten() for _, hi, lo in maps for x in (hi, lo)]
                     + ([x.flatten() for x in stats] if stats else []))
    assert torch.equal(flat.sort().values,
                       4 * torch.arange(k2.tf32_tile_bytes(mode, d) // 4))
