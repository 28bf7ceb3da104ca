"""Core layers: conv / linear / norms / dropout / pooling
(counterpart: lunaris_orion_tpu/ops/layers.py).

Layout, chosen once here for the whole port: inside the models,
activations are NCHW tensors in `torch.channels_last` memory format. cuDNN
runs its NHWC convolutions on them, and `x.permute(0, 2, 3, 1)` is a
contiguous NHWC view, with no copy, for the K1 kernel and the attention.
Weights keep the PyTorch reference's layouts (conv [O, I/g, k, k],
transposed conv [I, O, k, k], linear [O, I]), so a reference state_dict
loads as it is.

Precision follows the JAX package: parameters stay f32 and are cast to the
activations' dtype at each conv and linear; norm statistics are f32
whatever the activations' dtype, with one cast back.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from lunaris_orion_tpu_torch.ops.cuda import gn_mish as k1


def conv2d(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, *,
           stride: int = 1, padding: Optional[int] = None,
           groups: int = 1) -> torch.Tensor:
    """Conv with padding k//2 unless given (the reference's 'same-ish')."""
    k = weight.shape[-1]
    pad = k // 2 if padding is None else padding
    return F.conv2d(x, weight.to(x.dtype), bias.to(x.dtype), stride=stride,
                    padding=pad, groups=groups)


def conv_transpose_421(x: torch.Tensor, weight: torch.Tensor,
                       bias: torch.Tensor) -> torch.Tensor:
    """ConvTranspose2d(k=4, s=2, p=1) on the reference's [I, O, 4, 4]
    weight: output 2x the input's H and W."""
    return F.conv_transpose2d(x, weight.to(x.dtype), bias.to(x.dtype),
                              stride=2, padding=1)


def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: torch.Tensor) -> torch.Tensor:
    return F.linear(x, weight.to(x.dtype), bias.to(x.dtype))


def _group_stats(x32: torch.Tensor, groups: int, eps: float):
    """Per-(B, G) mean and inv_std of NCHW x32 from per-channel moments,
    variance clamped at 0 (`_gn_stats`)."""
    b, c = x32.shape[:2]
    cg = c // groups
    s1 = x32.mean(dim=(2, 3))                                    # [B, C]
    s2 = x32.square().mean(dim=(2, 3))
    mean = s1.reshape(b, groups, cg).mean(dim=2)                 # [B, G]
    var = s2.reshape(b, groups, cg).mean(dim=2) - mean.square()
    return mean, torch.rsqrt(var.clamp_min(0.0) + eps)


def group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, *,
               groups: int = 8, eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm(groups, C) over NCHW x, stats in f32."""
    c = x.shape[1]
    cg = c // groups
    mean, inv = _group_stats(x.float(), groups, eps)
    scale = inv.repeat_interleave(cg, dim=1) * weight.float()     # [B, C]
    shift = bias.float() - (mean * inv).repeat_interleave(cg, dim=1) * weight.float()
    out = x.float() * scale[:, :, None, None] + shift[:, :, None, None]
    return out.to(x.dtype)


def group_norm_mish(x: torch.Tensor, weight: torch.Tensor,
                    bias: torch.Tensor, *, groups: int = 8,
                    eps: float = 1e-5) -> torch.Tensor:
    """mish(GroupNorm(x)) on NCHW x through K1: the kernel for a CUDA
    tensor (which must be channels_last), its plain version for a CPU one.
    Returns a channels_last NCHW tensor."""
    y = k1.gn_mish(x.permute(0, 2, 3, 1), weight.float(), bias.float(),
                   groups=groups, eps=eps)
    return y.permute(0, 3, 1, 2)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, *,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis, in f32."""
    out = F.layer_norm(x.float(), x.shape[-1:], weight.float(), bias.float(),
                       eps)
    return out.to(x.dtype)


def batch_norm(x: torch.Tensor, running_mean: torch.Tensor,
               running_var: torch.Tensor, weight: torch.Tensor,
               bias: torch.Tensor, *, eps: float = 1e-5) -> torch.Tensor:
    """BatchNorm2d in eval mode (running statistics) over NCHW x, in f32."""
    out = F.batch_norm(x.float(), running_mean.float(), running_var.float(),
                       weight.float(), bias.float(), training=False, eps=eps)
    return out.to(x.dtype)


def batch_norm_train(x: torch.Tensor, running_mean: torch.Tensor,
                     running_var: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor, *, momentum: float = 0.1,
                     eps: float = 1e-5):
    """BatchNorm2d in train mode over NCHW x, in f32: normalize with the
    biased batch statistics. Returns (y, new_running_mean, new_running_var)
    without touching the buffers; the running variance takes the unbiased
    batch variance (torch semantics, JAX `batch_norm(train=True)`)."""
    x32 = x.float()
    mean = x32.mean(dim=(0, 2, 3))
    centered = x32 - mean[None, :, None, None]
    var = centered.square().mean(dim=(0, 2, 3))
    n = x.shape[0] * x.shape[2] * x.shape[3]
    with torch.no_grad():
        new_mean = (1 - momentum) * running_mean + momentum * mean
        new_var = (1 - momentum) * running_var + momentum * (
            var * (n / max(n - 1, 1)))
    out = (centered * torch.rsqrt(var + eps)[None, :, None, None]
           * weight.float()[None, :, None, None]
           + bias.float()[None, :, None, None])
    return out.to(x.dtype), new_mean, new_var


def _dropout(x: torch.Tensor, rate: float,
             generator: Optional[torch.Generator], mask_shape) -> torch.Tensor:
    if generator is None or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(mask_shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


def dropout(x: torch.Tensor, rate: float, *,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Elementwise dropout, keep = 1 - rate, kept values scaled by 1/keep.
    The identity without a generator (eval) or at rate 0."""
    return _dropout(x, rate, generator, x.shape)


def dropout2d(x: torch.Tensor, rate: float, *,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Channel dropout (torch Dropout2d) over NCHW x: whole channels of a
    sample are kept or zeroed. The identity without a generator or at
    rate 0."""
    return _dropout(x, rate, generator, (x.shape[0], x.shape[1], 1, 1))


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """AdaptiveAvgPool2d(1) + flatten: NCHW -> [B, C]."""
    return x.mean(dim=(2, 3))
