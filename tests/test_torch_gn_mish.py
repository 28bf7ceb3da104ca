"""K1 in the PyTorch port (lunaris_orion_tpu_torch/ops/cuda/gn_mish.py):
its plain version against the JAX package's Pallas kernel
`group_norm_mish_pallas` (interpret mode on the CPU) and the wrapper's
device contract. The kernel itself is held against its plain version on a
CUDA card by tests/test_torch_kernels.py."""

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
        "flash_attention_bwd_simt_f32_wide.cu", "flash_attention_fwd.cu",
        "flash_attention_fwd_d32.cu", "flash_attention_fwd_mma.cu",
        "flash_attention_fwd_simt_bf16.cu", "flash_attention_fwd_simt_f32.cu",
        "flash_attention_fwd_simt_f32_wide.cu", "flash_attention_stages.cu",
        "fused_stage.cu", "gn_mish.cu", "gn_stats.cu", "loss_epilogue.cu"]
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
    assert len(fwd) == 7 and "flash_attention_stages.cu" in fwd
    # Likewise the K2 backward's bodies, and what both share.
    bwd = [p.name for p in real.glob("*.cu")
           if '#include "flash_attention_bwd.cuh"' in p.read_text()]
    assert len(bwd) == 9 and all(n.startswith("flash_attention_bwd")
                                 for n in bwd)
    for header in ("flash_attention_fwd.cuh", "flash_attention_bwd.cuh"):
        assert '#include "flash_attention_common.cuh"' in (
            real / header).read_text()
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
