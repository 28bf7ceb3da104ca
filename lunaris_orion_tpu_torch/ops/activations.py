"""Activation functions (counterpart: lunaris_orion_tpu/ops/activations.py)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def mish(x: torch.Tensor) -> torch.Tensor:
    """x * tanh(softplus(x)) in f32, cast back to x's dtype. The softplus is
    the stable form: x above 20, else log1p(exp(x))."""
    x32 = x.float()
    return (x32 * torch.tanh(F.softplus(x32))).to(x.dtype)


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.2) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope)
