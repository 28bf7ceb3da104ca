"""The port's measurement tools (lunaris_orion_tpu_torch/tools/) and the two
kernels only they reach, on the CPU: the plain versions of the K2 stage
family and of the per-tile lane sums against the Pallas kernels of
tools/bench_attn_roofline.py and tools/bench_gn_stats2.py (run in interpret
mode), and each tool's `main` at a tiny size. The kernels themselves are
held against their plain versions on a CUDA card by
tests/test_torch_kernels.py."""

import functools
import importlib.util
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from lunaris_orion_tpu.ops.pallas import gn_mish as jk1
from lunaris_orion_tpu_torch.ops.cuda import flash_attention as k2
from lunaris_orion_tpu_torch.ops.cuda import flash_attention_stages as stages
from lunaris_orion_tpu_torch.ops.cuda import gn_mish as k1
from lunaris_orion_tpu_torch.ops.cuda import gn_stats
from lunaris_orion_tpu_torch.tools import (attn_roofline, fusion_overlap,
                                           gn_stats as gn_stats_tool)

TOOLS = Path(__file__).resolve().parent.parent / "tools"


def _load_tool(name, monkeypatch):
    """A JAX tool as a module, with its `pallas_call`s (which have no
    `interpret` argument) run in interpret mode for this test."""
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    spec = importlib.util.spec_from_file_location(name, TOOLS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _attn_inputs(b, h, n, d, seed):
    r = np.random.default_rng(seed)
    q, k, v = (r.standard_normal((b, h, n, d)).astype(np.float32)
               for _ in range(3))
    bias = (0.5 * r.standard_normal((h, n))).astype(np.float32)
    return q * np.float32(d ** -0.5), k, v, bias


# ---- the K2 stage family ---------------------------------------------------

@pytest.mark.parametrize("stage", stages.STAGES)
def test_stage_plain_matches_pallas_stage_kernel(stage, monkeypatch):
    """B*H 4, H 2, N 256, d 16, f32, key blocks of 64 on both sides; the
    scores are summed in another order: atol 1e-5 on o and lse."""
    tool = _load_tool("bench_attn_roofline", monkeypatch)
    tool.BQ, tool.BK = 128, 64
    qs, k, v, bias = _attn_inputs(2, 2, 256, 16, seed=3)
    t = lambda a: jnp.asarray(a).swapaxes(2, 3).reshape(4, 16, 256)
    o_j, lse_j = tool._stage_fwd(t(qs), t(k), t(v),
                                 jnp.asarray(bias)[:, None, :], stage)
    o, lse = stages.flash_fwd_stage(*(torch.from_numpy(a)
                                      for a in (qs, k, v, bias)), stage, 64)
    scale = max(1.0, float(np.abs(np.asarray(o_j)).max()))
    np.testing.assert_allclose(
        o.reshape(4, 256, 16).numpy(), np.asarray(o_j).swapaxes(1, 2),
        atol=1e-5 * scale, rtol=1e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j)[:, 0],
                               atol=1e-5, rtol=1e-5)


def test_stage_sum_is_the_shipped_forward():
    """At "sum" the chain is complete: the result is `flash_attention` at
    dropout 0 of the unscaled q, whatever the key block."""
    qs, k, v, bias = (torch.from_numpy(a)
                      for a in _attn_inputs(1, 2, 256, 16, seed=4))
    ref_o, ref_lse = k2.attention_plain(qs * 4.0, k, v, bias)
    for block_k in (64, 128):
        o, lse = stages.flash_fwd_stage(qs, k, v, bias, "sum", block_k)
        np.testing.assert_allclose(o.numpy(), ref_o.numpy(), atol=1e-5)
        np.testing.assert_allclose(lse.numpy(), ref_lse.numpy(), atol=1e-5)


def test_stages_below_sum_depend_on_the_key_block():
    """Below "sum" l gains 1 per key block, so a block of 128 gives another
    "dots" result than a block of 64: o scales by the number of blocks."""
    qs, k, v, bias = (torch.from_numpy(a)
                      for a in _attn_inputs(1, 2, 256, 16, seed=5))
    o64, lse64 = stages.flash_fwd_stage(qs, k, v, bias, "dots", 64)
    o128, lse128 = stages.flash_fwd_stage(qs, k, v, bias, "dots", 128)
    np.testing.assert_allclose(o128.numpy(), 2.0 * o64.numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(lse64.numpy(), np.log(4.0), rtol=1e-6)
    np.testing.assert_allclose(lse128.numpy(), np.log(2.0), rtol=1e-6)


def test_stage_argument_checks():
    qs, k, v, bias = (torch.from_numpy(a)
                      for a in _attn_inputs(1, 2, 128, 16, seed=6))
    with pytest.raises(ValueError, match="stage"):
        stages.flash_fwd_stage(qs, k, v, bias, "softmax", 64)
    with pytest.raises(ValueError, match="multiple of block_k"):
        stages.flash_fwd_stage(qs, k, v, bias, "dots", 48)
    with pytest.raises(ValueError, match="unsupported device"):
        stages.flash_fwd_stage(*(a.to("meta") for a in (qs, k, v, bias)),
                               "dots", 64)
    assert stages.KERNEL_BLOCK_K == 64 and stages.HEAD_DIM == 16


# ---- lane sums from per-tile partials --------------------------------------

@pytest.mark.parametrize("shape,tile_rows", [((2, 16, 16, 32), 16),
                                             ((2, 8, 8, 128), 32),
                                             ((1, 4, 4, 256), 8)])
def test_lane_sums_plain_matches_pallas(shape, tile_rows, monkeypatch):
    """Against `pal_par` (per-tile partials) and against K1's own
    `_lane_sums` (serial accumulation); sums in other orders: 2e-5 of the
    largest sum."""
    tool = _load_tool("bench_gn_stats2", monkeypatch)
    r = np.random.default_rng(sum(shape))
    x = (1.0 + 3.0 * r.standard_normal(shape)).astype(np.float32)
    s1, s2 = gn_stats.lane_sums_partials(torch.from_numpy(x), tile_rows)
    lanes = max(shape[3], 128)
    assert s1.shape == s2.shape == (shape[0], lanes)
    for ref in (tool.pal_par(jnp.asarray(x), tile_rows),
                jk1._lane_sums(jnp.asarray(x))[:2]):
        for got, want in zip((s1, s2), ref):
            want = np.asarray(want).reshape(shape[0], lanes)
            np.testing.assert_allclose(got.numpy(), want,
                                       atol=2e-5 * np.abs(want).max(), rtol=0)
    # Folded to channels they are the plain per-channel sums.
    c = shape[3]                       # lane j holds channel j mod C
    c1 = s1.reshape(shape[0], -1, c).sum(dim=1)
    want1 = x.sum(axis=(1, 2))
    np.testing.assert_allclose(c1.numpy(), want1,
                               atol=2e-5 * np.abs(want1).max(), rtol=0)


def test_group_stats_matches_pallas_stats_entry():
    """`group_stats` (K1's pass 1 alone) against `group_stats_pallas`."""
    r = np.random.default_rng(8)
    x = (1.0 + 3.0 * r.standard_normal((2, 16, 16, 32))).astype(np.float32)
    mean, inv = k1.group_stats(torch.from_numpy(x), groups=8)
    m_j, i_j = jk1.group_stats_pallas(jnp.asarray(x), groups=8)
    np.testing.assert_allclose(mean.numpy(), np.asarray(m_j), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(inv.numpy(), np.asarray(i_j), atol=1e-5,
                               rtol=1e-4)


def test_lane_sums_shapes():
    for shape in ((128, 128, 32), (128, 128, 64), (64, 64, 128)):
        for tn in (512, 2048):
            for dt in (torch.bfloat16, torch.float32):
                assert gn_stats.supported_shape(*shape, tn, dt)
    assert not gn_stats.supported_shape(8, 8, 48, 8)       # 48 and 128
    assert not gn_stats.supported_shape(8, 8, 384, 3)      # period not 2^k
    assert not gn_stats.supported_shape(16, 16, 32, 48)    # 64 rows / 48
    with pytest.raises(ValueError, match="tile_rows"):
        gn_stats.lane_sums_partials(torch.zeros(1, 16, 16, 32), 48)
    with pytest.raises(ValueError, match="unsupported device"):
        gn_stats.lane_sums_partials(torch.zeros(1, 16, 16, 32, device="meta"))


# ---- the tools' entry points -----------------------------------------------

def _last_json(capsys):
    out = capsys.readouterr().out.strip().splitlines()
    return out, json.loads(out[-1])


def test_attn_roofline_main_on_cpu(capsys):
    rc = attn_roofline.main(["--device", "cpu", "--batch", "1", "--heads", "2",
                             "--tokens", "256", "--dtype", "f32", "--reps",
                             "1"])
    _, rows = _last_json(capsys)
    assert rc == 0
    assert [r["stage"] for r in rows] == [*stages.STAGES, "shipped"]
    assert rows[0]["delta_ms"] is None
    for prev, row in zip(rows, rows[1:]):
        assert row["fwd_ms"] > 0
        assert row["delta_ms"] == pytest.approx(
            row["fwd_ms"] - prev["fwd_ms"], abs=2e-3)


def test_gn_stats_main_on_cpu(capsys):
    rc = gn_stats_tool.main(["--device", "cpu", "--shapes", "2,16,16,32",
                             "2,8,8,128", "--reps", "1"])
    out, rows = _last_json(capsys)
    assert rc == 0 and out[0].startswith("device: cpu")
    want = ["torch", "torch_staged", "k1_pass1", "par_tn512", "par_tn2048"]
    assert [r["variant"] for r in rows] == want * 2
    assert {tuple(r["shape"]) for r in rows} == {(2, 16, 16, 32),
                                                 (2, 8, 8, 128)}
    assert all(r["ms"] > 0 and r["gb_s"] >= 0 for r in rows)


def test_fusion_overlap_main_on_cpu(capsys):
    rc = fusion_overlap.main(["--device", "cpu", "--batch", "2", "--hw", "16",
                              "--cin", "16", "--cout", "32", "--reps", "1"])
    out, summary = _last_json(capsys)
    cases = [json.loads(line) for line in out[:-1]]
    assert rc == 0
    assert [c["case"] for c in cases] == ["conv_alone", "gnmish_alone",
                                          "chain", "stats_alone", "fused"]
    assert all(c["ms"] > 0 for c in cases)
    assert set(summary) == {"sum_parts_ms", "chain_ms", "overlap_already_ms",
                            "pipelined_kernel_ceiling_saving_ms"}
    ms = {c["case"]: c["ms"] for c in cases}
    assert summary["chain_ms"] == ms["chain"]
    assert summary["sum_parts_ms"] == pytest.approx(
        ms["conv_alone"] + ms["gnmish_alone"], abs=2e-4)


def test_fusion_overlap_cases_agree():
    """The tool's `fused` case computes what its `chain` case computes: K5
    after the GroupNorm fold equals K1 followed by the convolution."""
    r = np.random.default_rng(9)
    y = torch.from_numpy(r.standard_normal((2, 16, 16, 16)).astype(np.float32))
    w = torch.from_numpy((0.05 * r.standard_normal((3, 3, 16, 32))).astype(
        np.float32))
    scale, bias = torch.full((16,), 1.1), torch.full((16,), 0.05)
    from lunaris_orion_tpu_torch.ops.cuda import fused_stage as k5
    alpha, beta = k1.group_affine(y, scale, bias)
    fused = k5.gn_mish_conv3(y, alpha, beta, w, torch.zeros(32))
    chain = torch.nn.functional.conv2d(
        k1.gn_mish(y, scale, bias).permute(0, 3, 1, 2),
        w.permute(3, 2, 0, 1), padding=1).permute(0, 2, 3, 1)
    np.testing.assert_allclose(fused.numpy(), chain.numpy(), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("tool", [attn_roofline, gn_stats_tool,
                                  fusion_overlap])
def test_tools_need_a_card_by_default(tool):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    with pytest.raises(RuntimeError, match="cuda"):
        tool.main([])
