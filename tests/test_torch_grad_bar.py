"""`chip_smoke.py` phase 9's gradient bar against a wrong K2 backward.

Phase 9 holds the card's gradients of a 64 px train step against the CPU's
at 1e-3 of each tensor's largest, and the parameters of the teacher's
conv -> BatchNorm blocks at 2e-2 (`chip_smoke.grad_ratios`). Here both
sides are the CPU's plain versions, and one side's K2 backward returns one
of its gradients 1 % off: the bar must fail the attention's own parameters,
which take that gradient directly, by more than twice. A uniform 2e-2 bar
would not see that error.
"""

from __future__ import annotations

import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402
from lunaris_orion_tpu_torch.ops.cuda import flash_attention as k2  # noqa: E402


@pytest.fixture(scope="module")
def reference():
    grads, _, _, before_bn = chip_smoke.grad_step(torch, "cpu")
    return grads, before_bn


def test_grad_bar_names_the_conv_batchnorm_blocks(reference):
    grads, before_bn = reference
    teacher = {k for k in grads if k.startswith("teacher.")}
    assert before_bn < teacher
    assert not any(".attention." in k for k in before_bn)
    for block in ("feature_extractor.conv1.0.weight",
                  "feature_extractor.color_branch.1.bias",
                  "feature_extractor.fusion.2.weight",
                  "experts.0.0.conv2.0.weight",
                  "experts.0.0.shortcut.0.weight"):
        assert "teacher." + block in before_bn


@pytest.mark.parametrize("wrong", [0, 1, 2, 3],
                         ids=["dq", "dk", "dv", "dbias"])
def test_grad_bar_fails_a_one_percent_k2_error(reference, wrong, monkeypatch):
    """wrong: which of K2's (dq, dk, dv, dbias) is 1 % off."""
    grads, before_bn = reference
    plain = k2.attention_bwd_plain

    def off(*args, **kw):
        out = list(plain(*args, **kw))
        out[wrong] = out[wrong] * 1.01
        return tuple(out)

    monkeypatch.setattr(k2, "attention_bwd_plain", off)
    off_grads = chip_smoke.grad_step(torch, "cpu")[0]
    ratios = chip_smoke.grad_ratios(grads, off_grads, before_bn)
    worst = max((r, k) for k, r in ratios.items())
    assert worst[0] > 2.0 and ".attention." in worst[1], worst
    everywhere = chip_smoke.grad_ratios(
        grads, off_grads, {k for k in grads if k.startswith("teacher.")})
    assert max(everywhere.values()) < 1.0
