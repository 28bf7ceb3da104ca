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
from lunaris_orion_tpu_torch.parallel.collectives import all_reduce_sum
from lunaris_orion_tpu_torch.parallel.mesh import AxisGroup


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
                    eps: float = 1e-5, plain: bool = False) -> torch.Tensor:
    """mish(GroupNorm(x)) on NCHW x through K1: the kernel for a CUDA
    tensor (which must be channels_last), its plain version for a CPU one.
    `plain` runs the plain version on any device (the exporter's portable
    form). Returns a channels_last NCHW tensor."""
    fn = k1.gn_mish_plain if plain else k1.gn_mish
    y = fn(x.permute(0, 2, 3, 1), weight.float(), bias.float(),
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
                     eps: float = 1e-5, axis: Optional[AxisGroup] = None):
    """BatchNorm2d in train mode over NCHW x, in f32: normalize with the
    biased batch statistics. Returns (y, new_running_mean, new_running_var)
    without touching the buffers; the running variance takes the unbiased
    batch variance (torch semantics, JAX `batch_norm(train=True)`).

    With `axis` (the data axis) the batch is the global batch split over
    its ranks, as under the JAX package's SPMD `jnp.mean`: the sum and the
    sum of centered squares are all-reduced (their gradients too) and the
    counts are global."""
    x32 = x.float()
    n = x.shape[0] * x.shape[2] * x.shape[3]
    total = x32.sum(dim=(0, 2, 3))
    if axis is not None:
        total = all_reduce_sum(total, axis)
        n *= axis.size
    mean = total / n
    centered = x32 - mean[None, :, None, None]
    sq = centered.square().sum(dim=(0, 2, 3))
    if axis is not None:
        sq = all_reduce_sum(sq, axis)
    var = sq / n
    with torch.no_grad():
        new_mean = (1 - momentum) * running_mean + momentum * mean
        new_var = (1 - momentum) * running_var + momentum * (
            var * (n / max(n - 1, 1)))
    out = (centered * torch.rsqrt(var + eps)[None, :, None, None]
           * weight.float()[None, :, None, None]
           + bias.float()[None, :, None, None])
    return out.to(x.dtype), new_mean, new_var


def global_rows(shape, rows: Optional[AxisGroup]):
    """The shape of a draw whose first axis is this rank's share of the
    global batch, and the slice of it that is this rank's: every rank
    draws the global batch's numbers and keeps its rows, so a draw gives
    each sample what the single-process step gives it."""
    if rows is None:
        return tuple(shape), slice(None)
    b = shape[0]
    return (b * rows.size, *shape[1:]), slice(rows.index * b,
                                              (rows.index + 1) * b)


def global_cols(shape, cols: Optional[AxisGroup]):
    """A draw's shape with its second axis widened from this rank's
    columns to every rank's of `cols` (tensor parallelism's model axis)."""
    if cols is None:
        return tuple(shape)
    return (shape[0], shape[1] * cols.size, *shape[2:])


def own_cols(x: torch.Tensor, cols: Optional[AxisGroup]) -> torch.Tensor:
    """This rank's columns of a draw made at `global_cols`' shape."""
    if cols is None:
        return x
    per = x.shape[1] // cols.size
    return x[:, cols.index * per:(cols.index + 1) * per]


def _dropout(x: torch.Tensor, rate: float,
             generator: Optional[torch.Generator], mask_shape,
             rows: Optional[AxisGroup]) -> torch.Tensor:
    if generator is None or rate == 0.0:
        return x
    keep = 1.0 - rate
    shape, own = global_rows(mask_shape, rows)
    mask = torch.rand(shape, generator=generator, device=x.device)[own] < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


def skip_dropout(shape, rate: float, *,
                 generator: Optional[torch.Generator],
                 rows: Optional[AxisGroup], device) -> None:
    """Draw and discard the mask `dropout` would draw for an x of `shape`:
    a rank that skips a layer another rank runs (an expert it does not
    own) keeps its generator where the single-process step's would be."""
    if generator is not None and rate != 0.0:
        torch.rand(global_rows(shape, rows)[0], generator=generator,
                   device=device)


def dropout(x: torch.Tensor, rate: float, *,
            generator: Optional[torch.Generator] = None,
            rows: Optional[AxisGroup] = None) -> torch.Tensor:
    """Elementwise dropout, keep = 1 - rate, kept values scaled by 1/keep.
    The identity without a generator (eval) or at rate 0. `rows`: the data
    axis x's batch is split over (`global_rows`)."""
    return _dropout(x, rate, generator, x.shape, rows)


def dropout2d(x: torch.Tensor, rate: float, *,
              generator: Optional[torch.Generator] = None,
              rows: Optional[AxisGroup] = None) -> torch.Tensor:
    """Channel dropout (torch Dropout2d) over NCHW x: whole channels of a
    sample are kept or zeroed. The identity without a generator or at
    rate 0. `rows` as in `dropout`."""
    return _dropout(x, rate, generator, (x.shape[0], x.shape[1], 1, 1), rows)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """AdaptiveAvgPool2d(1) + flatten: NCHW -> [B, C]."""
    return x.mean(dim=(2, 3))
