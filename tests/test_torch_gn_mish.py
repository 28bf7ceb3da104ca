"""K1 in the PyTorch port (lunaris_orion_tpu_torch/ops/cuda/gn_mish.py):
its plain version against the JAX package's Pallas kernel
`group_norm_mish_pallas` (interpret mode on the CPU) and the wrapper's
device contract. The kernel itself is held against its plain version on a
CUDA card by tests/test_torch_kernels.py."""

import ctypes
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lunaris_orion_tpu.ops import layers as jlayers
from lunaris_orion_tpu.ops.pallas.gn_mish import group_norm_mish_pallas
from lunaris_orion_tpu_torch.ops import layers
from lunaris_orion_tpu_torch.ops.cuda import _build
from lunaris_orion_tpu_torch.ops.cuda import gn_mish as k1
from test_torch_kernels import torch_threads  # noqa: F401 (autouse)


def _inputs(shape, seed, *, mean=0.0, std=1.0):
    r = np.random.default_rng(seed)
    c = shape[-1]
    x = (mean + std * r.standard_normal(shape)).astype(np.float32)
    scale = (1.0 + 0.1 * r.standard_normal(c)).astype(np.float32)
    bias = (0.1 * r.standard_normal(c)).astype(np.float32)
    return x, scale, bias


def _jax(x, scale, bias, groups=8):
    return np.asarray(group_norm_mish_pallas(
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), groups=groups))


@pytest.mark.parametrize("shape", [(2, 16, 16, 32), (2, 8, 8, 64),
                                   (1, 8, 8, 256)])
def test_plain_matches_pallas(shape):
    x, scale, bias = _inputs(shape, seed=sum(shape))
    got = k1.gn_mish_plain(torch.from_numpy(x), torch.from_numpy(scale),
                           torch.from_numpy(bias), groups=8)
    # f32 on both sides; the sums run in different orders, so the stats
    # differ in the last bits: atol 1e-5 / rtol 1e-4.
    np.testing.assert_allclose(got.numpy(), _jax(x, scale, bias),
                               atol=1e-5, rtol=1e-4)


def test_variance_clamp_large_mean():
    """|mean| >> std: E[x^2] - mean^2 cancels and goes negative in f32 for
    some groups, which only the clamp at 0 keeps finite. With gamma = 0 the
    exact output is mish(beta), whatever the garbage variance."""
    shape = (1, 8, 8, 64)
    x, _, bias = _inputs(shape, seed=3, mean=1000.0, std=1e-3)
    scale = np.zeros(shape[-1], np.float32)
    xt = torch.from_numpy(x)
    s1 = xt.mean(dim=(1, 2)).reshape(1, 8, 8).mean(-1)
    s2 = xt.square().mean(dim=(1, 2)).reshape(1, 8, 8).mean(-1)
    assert (s2 - s1.square() < 0).any(), "input no longer hits the clamp"
    got = k1.gn_mish_plain(xt, torch.from_numpy(scale),
                           torch.from_numpy(bias)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, _jax(x, scale, bias), atol=1e-5,
                               rtol=1e-4)
    expect = torch.nn.functional.mish(torch.from_numpy(bias)).numpy()
    np.testing.assert_allclose(got, np.broadcast_to(expect, shape),
                               atol=1e-6, rtol=1e-6)


def test_layer_matches_plain_on_nchw_channels_last():
    """ops.layers.group_norm_mish on a channels_last NCHW tensor is K1 on
    its NHWC view, returned as channels_last NCHW."""
    x, scale, bias = _inputs((2, 8, 8, 32), seed=5)
    nchw = torch.from_numpy(x).permute(0, 3, 1, 2)
    assert nchw.is_contiguous(memory_format=torch.channels_last)
    y = layers.group_norm_mish(nchw, torch.from_numpy(scale),
                               torch.from_numpy(bias), groups=8)
    assert y.is_contiguous(memory_format=torch.channels_last)
    ref = k1.gn_mish_plain(torch.from_numpy(x), torch.from_numpy(scale),
                           torch.from_numpy(bias))
    torch.testing.assert_close(y.permute(0, 2, 3, 1), ref, atol=0, rtol=0)


def test_group_norm_matches_jax_layer():
    """ops.layers.group_norm (no mish) on NCHW against the JAX package's
    layers.group_norm on the same NHWC values."""
    x, scale, bias = _inputs((2, 8, 8, 32), seed=8, mean=3.0)
    want = np.asarray(jlayers.group_norm(
        {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
        jnp.asarray(x), groups=8))
    got = layers.group_norm(torch.from_numpy(x).permute(0, 3, 1, 2),
                            torch.from_numpy(scale), torch.from_numpy(bias),
                            groups=8)
    # f32, sums in different orders: atol 1e-5 / rtol 1e-4
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               atol=1e-5, rtol=1e-4)


def test_bf16_plain_casts_once():
    """bf16 input: f32 arithmetic and one cast, i.e. the f32 result of the
    bf16 values rounded to bf16 (exact equality)."""
    x, scale, bias = _inputs((1, 8, 8, 32), seed=6)
    xb = torch.from_numpy(x).bfloat16()
    got = k1.gn_mish_plain(xb, torch.from_numpy(scale), torch.from_numpy(bias))
    ref = k1.gn_mish_plain(xb.float(), torch.from_numpy(scale),
                           torch.from_numpy(bias)).bfloat16()
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, ref, atol=0, rtol=0)


def test_cpu_tensor_takes_plain_version_and_does_not_count():
    x, scale, bias = _inputs((1, 8, 8, 32), seed=7)
    before = k1.launches
    y = k1.gn_mish(torch.from_numpy(x), torch.from_numpy(scale),
                   torch.from_numpy(bias))
    assert k1.launches == before
    torch.testing.assert_close(y, k1.gn_mish_plain(
        torch.from_numpy(x), torch.from_numpy(scale), torch.from_numpy(bias)))


def test_group_affine_kernel_on_cpu_is_group_affine(monkeypatch):
    """On a CPU tensor the alpha / beta entry is `group_affine`, bit for bit,
    builds nothing and counts nothing; elsewhere it raises."""
    def no_build():
        raise AssertionError("the CPU path must not build the kernels")
    monkeypatch.setattr(_build, "library", no_build)
    x, scale, bias = (torch.from_numpy(a) for a in _inputs((2, 8, 8, 32),
                                                           seed=12))
    before = k1.affine_launches
    got = k1.group_affine_kernel(x, scale, bias)
    assert k1.affine_launches == before
    for a, r in zip(got, k1.group_affine(x, scale, bias)):
        assert a.shape == (2, 32) and a.dtype == torch.float32
        assert torch.equal(a, r)
    with pytest.raises(ValueError, match="unsupported device"):
        k1.group_affine_kernel(x.to("meta"), scale.to("meta"),
                               bias.to("meta"))


@pytest.mark.parametrize("shape,groups", [((2, 8, 8, 32), 8),
                                          ((1, 5, 3, 12), 4)])
def test_group_partials_plain_folds_to_group_stats(shape, groups):
    """Pass 1's plain version (one split) folded as the card's partials are
    gives `group_stats_plain`."""
    x, _, _ = _inputs(shape, seed=13)
    x = torch.from_numpy(x)
    part = k1.group_partials(x, groups=groups)
    assert part.shape == (shape[0], groups, 1, 2)
    n = shape[1] * shape[2] * (shape[3] // groups)
    mean = part[..., 0].sum(dim=2) / n
    var = (part[..., 1].sum(dim=2) / n - mean.square()).clamp_min(0.0)
    rmean, rinv = k1.group_stats_plain(x, groups=groups)
    torch.testing.assert_close(mean, rmean, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(torch.rsqrt(var + 1e-5), rinv, atol=1e-5,
                               rtol=1e-4)
    with pytest.raises(ValueError, match="unsupported device"):
        k1.group_partials(x.to("meta"), groups=groups)


@pytest.mark.parametrize("shape,groups,splits", [
    ((2, 8, 8, 32), 8, 1), ((2, 8, 8, 32), 8, 3), ((1, 5, 3, 12), 4, 7),
    ((2, 16, 16, 64), 8, 64), ((1, 4, 4, 2048), 8, 256),
    ((3, 6, 7, 24), 8, 50)])
def test_fold_partials_plain_matches_group_affine(shape, groups, splits):
    """The fold in the kernel's order (splits summed one by one, then mean,
    clamped variance and inv_std per group) from pass 1's plain partials,
    cut into `splits` as the kernel's grid cuts the pixels (splits past the
    last pixel included), against `group_affine`'s moments in f32."""
    x, scale, bias = (torch.from_numpy(a) for a in _inputs(
        shape, seed=sum(shape) + splits, mean=0.5, std=2.0))
    part = k1.group_partials_plain(x, groups=groups, splits=splits)
    assert part.shape == (shape[0], groups, splits, 2)
    torch.testing.assert_close(part.sum(dim=2, keepdim=True),
                               k1.group_partials_plain(x, groups=groups),
                               atol=1e-3, rtol=1e-5)
    n_set = shape[1] * shape[2] * (shape[3] // groups)
    got = k1.fold_partials_plain(part, scale, bias, n_set=n_set)
    for a, r in zip(got, k1.group_affine(x, scale, bias, groups=groups)):
        assert a.shape == (shape[0], shape[3]) and a.dtype == torch.float32
        torch.testing.assert_close(a, r, atol=1e-5, rtol=1e-4)


# C 8, 64, 256: the Pallas kernel in interpret mode; C 24, which its lanes
# of 128 cannot pack, is what the JAX package runs there: the XLA
# composition of `layers.group_norm_mish`.
@pytest.mark.parametrize("c", [8, 24, 64, 256])
@pytest.mark.parametrize("splits", [2, 5])
def test_apply_from_split_partials_matches_jax(c, splits):
    """The apply alone on a CPU tensor (the plain fold of pass 1's partials
    in `splits`, then y = mish(x * A + B')) against the JAX package's
    K1 on the same values."""
    shape = (2, 16, 16, c)
    x, scale, bias = _inputs(shape, seed=c + splits, mean=0.3, std=1.5)
    xt = torch.from_numpy(x)
    part = k1.group_partials_plain(xt, groups=8, splits=splits)
    got = k1.gn_mish_apply(xt, part, torch.from_numpy(scale),
                           torch.from_numpy(bias), groups=8).numpy()
    if c == 24:
        want = np.asarray(jlayers.group_norm_mish(
            {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
            jnp.asarray(x), groups=8))
    else:
        want = _jax(x, scale, bias)
    # f32 on both sides, moments summed in other orders: atol 1e-5 / rtol 1e-4
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4)


def _walk_apply(geo: k1.ApplyGeometry, hw: int, c: int) -> np.ndarray:
    """The index mapping of the apply's kernel (`gn_mish_apply_fold`) for
    one image, loop for loop: hits[pixel, channel], and a check that every
    value's A and B' are read at its own channel."""
    hits = np.zeros((hw, c), np.int64)
    cols = c // geo.vec
    tc = min(cols, k1.THREADS)
    rows = k1.THREADS // tc
    per = -(-hw // geo.blocks)                 # the kernel's own division
    assert (tc, rows, per) == (geo.tc, geo.rows, geo.pixels)
    lanes = np.arange(geo.vec)
    for blk in range(geo.blocks):
        p0 = blk * per
        p1 = min(hw, p0 + per)
        for t in range(k1.THREADS):
            row = t // tc
            if row >= rows:
                continue
            for col in range(t % tc, cols, tc):
                alpha_at = col * geo.vec + lanes    # a[i], b[i] in registers
                p, seen = p0 + row, []
                while p + 3 * rows < p1:            # four pixels in flight
                    seen += [p, p + rows, p + 2 * rows, p + 3 * rows]
                    p += 4 * rows
                while p < p1:
                    seen.append(p)
                    p += rows
                for pix in seen:
                    addr = pix * c + col * geo.vec + lanes
                    assert (addr % c == alpha_at).all()
                    hits[addr // c, addr % c] += 1
    return hits


@pytest.mark.parametrize("b,hw,c,itemsize,aligned,sms", [
    (8, 256, 256, 2, True, 132), (2, 37, 64, 2, True, 132),
    (1, 12, 2048, 2, True, 132), (1, 9, 2048, 4, True, 132),
    (3, 63, 24, 2, True, 132), (2, 30, 40, 2, True, 4),
    (2, 50, 12, 4, True, 4), (2, 45, 64, 2, False, 132),
    (4, 100, 8, 4, True, 132), (1, 200, 48, 2, True, 8),
    (2, 17, 1000, 4, False, 132)])
def test_apply_geometry_covers_each_value_once(b, hw, c, itemsize, aligned,
                                               sms):
    """Every (pixel, channel) of an image is applied exactly once, with the
    A and B' of its own channel; the vector form (16 bytes) exactly where C
    is a multiple of the vector and the addresses are aligned."""
    splits = k1.stats_splits(b, hw, c, 8, sms)
    geo = k1.apply_geometry(b, hw, c, itemsize, 8, splits, sms, aligned)
    want_vec = 16 // itemsize if aligned and c % (16 // itemsize) == 0 else 1
    assert geo.vec == want_vec
    assert geo.blocks >= 1 and (geo.blocks - 1) * geo.pixels < hw
    assert (_walk_apply(geo, hw, c) == 1).all()


def test_apply_geometry_bounds_the_repeated_fold():
    """Each apply block folds its image's 2 G splits partials again: at
    every batch, a block covers at least 16 times as many values; pass 1
    never gives the fold more than MAX_FOLD groups x splits."""
    for b in (1, 2, 8, 16, 128):
        for hw, c in ((256, 256), (16384, 32), (4096, 64), (16384, 64),
                      (64, 2048)):
            splits = k1.stats_splits(b, hw, c, 8, 132)
            assert 8 * splits <= k1.MAX_FOLD
            geo = k1.apply_geometry(b, hw, c, 2, 8, splits, 132)
            assert geo.pixels * c >= 16 * 2 * 8 * splits or geo.blocks == 1
    assert k1.stats_splits(1, 128 * 128, 256, 8, 132) == k1.MAX_FOLD // 8


def test_apply_alone_and_kernel_entry_on_cpu(monkeypatch):
    """On a CPU tensor the apply-alone entry is its plain version and counts
    nothing; the comparison entry needs a card."""
    def no_build():
        raise AssertionError("the CPU path must not build the kernels")
    monkeypatch.setattr(_build, "library", no_build)
    x, scale, bias = (torch.from_numpy(a) for a in _inputs((2, 8, 8, 32),
                                                           seed=14))
    part = k1.group_partials(x)
    before = k1.apply_launches
    got = k1.gn_mish_apply(x, part, scale, bias)
    assert k1.apply_launches == before
    assert torch.equal(got, k1.gn_mish_apply_plain(x, part, scale, bias))
    torch.testing.assert_close(got, k1.gn_mish_plain(x, scale, bias),
                               atol=1e-6, rtol=1e-5)
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        k1.gn_mish_kernel(x, scale, bias)
    with pytest.raises(ValueError, match="unsupported device"):
        k1.gn_mish_apply(x.to("meta"), part.to("meta"), scale.to("meta"),
                         bias.to("meta"))


_C_TYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
            "int": ctypes.c_int, "float": ctypes.c_float,
            "long long": ctypes.c_longlong, "unsigned int": ctypes.c_uint}


def test_c_entry_points_match_their_ctypes_signatures():
    """Every `extern "C"` entry point of csrc/ that `_build.SIGNATURES`
    names takes the arguments, in number and type, that ctypes passes (none
    for the bf16 warpgroup bodies' shared-memory reports; the narrow and
    the f32 ones' take the head size), and every one that
    returns a CUDA error or an int is named there."""
    found = {}
    for src in _build.sources():
        for name, args in re.findall(
                r'extern "C" int (\w+)\(([^)]*)\)', src.read_text()):
            found[name] = tuple(
                _C_TYPES[re.sub(r"\s*\w+$", "", a.strip())]
                for a in args.split(",") if a.strip())
    assert set(_build.SIGNATURES) == set(found)
    for name, argtypes in _build.SIGNATURES.items():
        assert tuple(argtypes) == found[name], name


def test_other_device_raises():
    x = torch.empty(1, 8, 8, 32, device="meta")
    w = torch.empty(32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        k1.gn_mish(x, w, w)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """The kernel modules import without nvcc or a card; an explicit build
    without nvcc names what is missing."""
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "CUDA_ROOTS", ())
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc()


def test_build_dir_tracks_source_content():
    d = _build.build_dir()
    assert d.parent == _build.BUILD_ROOT
    assert [p.name for p in _build.sources()] == [
        "flash_attention_bwd.cu", "flash_attention_bwd_mma_d32.cu",
        "flash_attention_bwd_mma_dkv.cu", "flash_attention_bwd_mma_dq.cu",
        "flash_attention_bwd_mma_fused.cu",
        "flash_attention_bwd_simt_bf16.cu", "flash_attention_bwd_simt_f32.cu",
        "flash_attention_bwd_simt_f32_d32.cu",
        "flash_attention_bwd_simt_f32_wide.cu",
        "flash_attention_bwd_tf32_fused.cu",
        "flash_attention_bwd_wgmma_d16.cu",
        "flash_attention_bwd_wgmma_d16_drop.cu",
        "flash_attention_bwd_wgmma_d32.cu",
        "flash_attention_bwd_wgmma_d32_drop.cu",
        "flash_attention_bwd_wgmma_d48.cu",
        "flash_attention_bwd_wgmma_d48_drop.cu",
        "flash_attention_bwd_wgmma_d64.cu",
        "flash_attention_bwd_wgmma_d64_drop.cu",
        "flash_attention_bwd_wgmma_tf32_d16.cu",
        "flash_attention_bwd_wgmma_tf32_d16_drop.cu",
        "flash_attention_bwd_wgmma_tf32_d32.cu",
        "flash_attention_bwd_wgmma_tf32_d32_drop.cu",
        "flash_attention_bwd_wgmma_tf32_d48.cu",
        "flash_attention_bwd_wgmma_tf32_d48_drop.cu",
        "flash_attention_bwd_wgmma_tf32_d64.cu",
        "flash_attention_bwd_wgmma_tf32_d64_drop.cu",
        "flash_attention_bwd_window_d16.cu",
        "flash_attention_bwd_window_d16_drop.cu",
        "flash_attention_bwd_window_d32.cu",
        "flash_attention_bwd_window_d32_drop.cu",
        "flash_attention_bwd_window_tf32_d16.cu",
        "flash_attention_bwd_window_tf32_d16_drop.cu",
        "flash_attention_bwd_window_tf32_d32.cu",
        "flash_attention_bwd_window_tf32_d32_drop.cu", "flash_attention_fwd.cu",
        "flash_attention_fwd_d32.cu", "flash_attention_fwd_mma.cu",
        "flash_attention_fwd_simt_bf16.cu", "flash_attention_fwd_simt_f32.cu",
        "flash_attention_fwd_simt_f32_wide.cu", "flash_attention_fwd_tf32.cu",
        "flash_attention_fwd_wgmma_d16.cu",
        "flash_attention_fwd_wgmma_d16_drop.cu",
        "flash_attention_fwd_wgmma_d32.cu",
        "flash_attention_fwd_wgmma_d32_drop.cu",
        "flash_attention_fwd_wgmma_d48.cu",
        "flash_attention_fwd_wgmma_d48_drop.cu",
        "flash_attention_fwd_wgmma_d64.cu",
        "flash_attention_fwd_wgmma_d64_drop.cu",
        "flash_attention_fwd_wgmma_tf32_d16.cu",
        "flash_attention_fwd_wgmma_tf32_d16_drop.cu",
        "flash_attention_fwd_wgmma_tf32_d32.cu",
        "flash_attention_fwd_wgmma_tf32_d32_drop.cu",
        "flash_attention_fwd_wgmma_tf32_d48.cu",
        "flash_attention_fwd_wgmma_tf32_d48_drop.cu",
        "flash_attention_fwd_wgmma_tf32_d64.cu",
        "flash_attention_fwd_wgmma_tf32_d64_drop.cu",
        "flash_attention_fwd_window_d16.cu",
        "flash_attention_fwd_window_d16_drop.cu",
        "flash_attention_fwd_window_d32.cu",
        "flash_attention_fwd_window_d32_drop.cu",
        "flash_attention_fwd_window_tf32_d16.cu",
        "flash_attention_fwd_window_tf32_d16_drop.cu",
        "flash_attention_fwd_window_tf32_d32.cu",
        "flash_attention_fwd_window_tf32_d32_drop.cu",
        "flash_attention_stages.cu", "flash_attention_tf32_split.cu",
        "flash_attention_window.cu", "fused_stage.cu", "fused_stage_mma.cu", "gn_mish.cu", "gn_stats.cu",
        "loss_epilogue.cu"]
    assert d == _build.build_dir()


def test_build_dir_tracks_shared_header(monkeypatch, tmp_path):
    """An edit to a header the sources share gives another build directory,
    as an edit to a source does."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "a.cu").write_text('#include "common.cuh"\n')
    (csrc / "common.cuh").write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", csrc)
    first = _build.build_dir()
    (csrc / "common.cuh").write_text("// two\n")
    second = _build.build_dir()
    (csrc / "a.cu").write_text('#include "common.cuh"\n// edited\n')
    assert len({first, second, _build.build_dir()}) == 3
    monkeypatch.undo()
    real = _build.CSRC
    used = [p.name for p in real.glob("*.cu")
            if '#include "common.cuh"' in p.read_text()]
    assert used and (real / "common.cuh").is_file()
    # The K2 forward's bodies live in a header of their own, which the
    # forward's sources and the stage family include; every header a source
    # or header names is one that the hash covers.
    fwd = [p.name for p in real.glob("*.cu")
           if '#include "flash_attention_fwd.cuh"' in p.read_text()]
    assert len(fwd) == 24 and "flash_attention_stages.cu" in fwd
    # Likewise the K2 backward's bodies, and what both share (the Hopper
    # instructions of the warpgroup bodies among it).
    bwd = [p.name for p in real.glob("*.cu")
           if '#include "flash_attention_bwd.cuh"' in p.read_text()]
    assert len(bwd) == 26 and all(n.startswith("flash_attention_bwd")
                                 for n in bwd)
    for header in ("flash_attention_fwd.cuh", "flash_attention_bwd.cuh"):
        assert '#include "flash_attention_common.cuh"' in (
            real / header).read_text()
    assert '#include "hopper.cuh"' in (
        real / "flash_attention_common.cuh").read_text()
    hashed = {p.name for p in real.glob("*.cuh")}
    for src in (*real.glob("*.cu"), *real.glob("*.cuh")):
        named = re.findall(r'#include "([^"]+)"', src.read_text())
        assert set(named) <= hashed, (src.name, named)


def test_build_runs_one_compiler_per_source_and_logs_times(monkeypatch, tmp_path):
    """`build()` with a stand-in compiler: one compile per source and one
    link, the library renamed into place, and `build.log` holding each
    source's output and compile time."""
    fake = tmp_path / "nvcc"
    fake.write_text('#!/bin/bash\nprev=""\nfor a in "$@"; do\n'
                    '  if [ "$prev" = "-o" ]; then out="$a"; fi; prev="$a"\n'
                    'done\necho "ptxas info : $*"\ntouch "$out"\n')
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "nvcc", lambda: str(fake))
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "_build")
    lib = _build.build()
    assert lib.is_file() and lib.parent == _build.build_dir()
    assert sorted(p.name for p in lib.parent.iterdir()) == ["build.log",
                                                            lib.name]
    log = (lib.parent / "build.log").read_text()
    for src in _build.sources():
        assert f" {src.name}\n" in log
    assert log.count("nvcc seconds: ") == len(_build.sources())
    assert log.count("ptxas info : -shared ") == 1    # the stand-in's echo
    assert _build.build() == lib                    # built once, then reused
