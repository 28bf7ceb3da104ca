"""K1 -- fused GroupNorm + Mish over NHWC activations.

`gn_mish` sends a tensor on the CPU to `gn_mish_plain` and a tensor on a
CUDA device to the hand-written kernel in `csrc/gn_mish.cu`; it raises on
any other device and never falls back. The kernel replaces
`lunaris_orion_tpu/ops/pallas/gn_mish.py` (`_stats_kernel`, `_apply_kernel`)
and computes exactly what `group_norm_mish_pallas` computes.

`launches` counts the kernel launches made by `gn_mish` (one per call on a
CUDA tensor); the plain version does not count.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from lunaris_orion_tpu_torch.ops.cuda import _build

launches = 0

MAX_CHANNELS = 2048          # the kernel's per-block channel table
_THREADS = 256


def gn_mish_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                  *, groups: int = 8, eps: float = 1e-5) -> torch.Tensor:
    """mish(GroupNorm(groups)(x) * weight + bias) for x [B, H, W, C].

    The JAX package's formulation: per-channel moments reduced over H, W in
    f32, folded to per-(B, G) mean and E[x^2]; variance clamped at 0;
    y = x * A + B' with A = weight * inv_std and B' = bias - mean * inv_std
    * weight; mish in f32; one cast back to x's dtype."""
    b, h, w, c = x.shape
    cg = c // groups
    x32 = x.float()
    s1 = x32.mean(dim=(1, 2))                                  # [B, C]
    s2 = x32.square().mean(dim=(1, 2))
    mean = s1.reshape(b, groups, cg).mean(dim=2)               # [B, G]
    var = (s2.reshape(b, groups, cg).mean(dim=2) - mean.square()).clamp_min(0.0)
    inv = torch.rsqrt(var + eps)
    w32, b32 = weight.float(), bias.float()
    a = inv.repeat_interleave(cg, dim=1) * w32                 # [B, C]
    bp = b32 - (mean * inv).repeat_interleave(cg, dim=1) * w32
    y = x32 * a[:, None, None, :] + bp[:, None, None, :]
    return (y * torch.tanh(F.softplus(y))).to(x.dtype)


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def gn_mish(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
            *, groups: int = 8, eps: float = 1e-5) -> torch.Tensor:
    """K1 on x [B, H, W, C] (contiguous NHWC, f32 or bf16) with f32
    weight/bias [C]; returns a new NHWC tensor of x's dtype."""
    if x.device.type == "cpu":
        return gn_mish_plain(x, weight, bias, groups=groups, eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"gn_mish: unsupported device {x.device}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(
            "gn_mish: x must be a contiguous NHWC [B, H, W, C] tensor (the "
            "NHWC view of a channels_last NCHW tensor is one)")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"gn_mish: dtype {x.dtype} is not f32 or bf16")
    b, h, w, c = x.shape
    if c % groups != 0 or c > MAX_CHANNELS:
        raise ValueError(f"gn_mish: C={c} must be a multiple of groups="
                         f"{groups} and at most {MAX_CHANNELS}")
    for name, t in (("weight", weight), ("bias", bias)):
        if (t.dtype != torch.float32 or t.shape != (c,)
                or t.device != x.device or not t.is_contiguous()):
            raise ValueError(f"gn_mish: {name} must be contiguous f32 [{c}] "
                             f"on {x.device}")
    hw = h * w
    if hw * c >= 2**31:
        raise ValueError("gn_mish: one image must hold fewer than 2**31 "
                         "elements")
    # Pass 1: about 4 blocks per SM, each summing at least ~8k elements.
    # Pass 2: about 8 blocks per SM (a full SM's threads), grid-stride.
    sms = _sm_count(x.device.index or 0)
    splits = max(1, min(-(-4 * sms // b), -(-hw * c // 8192), hw))
    apply_blocks = max(1, min(-(-8 * sms // b), -(-hw * c // _THREADS)))
    y = torch.empty_like(x)
    partial = torch.empty(b * groups * splits * 2, device=x.device,
                          dtype=torch.float32)
    affine = torch.empty(b * 2 * c, device=x.device, dtype=torch.float32)
    err = _build.library().lunaris_gn_mish(
        x.data_ptr(), y.data_ptr(), weight.data_ptr(), bias.data_ptr(),
        partial.data_ptr(), affine.data_ptr(), b, hw, c, groups, splits,
        apply_blocks, eps, int(x.dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "gn_mish")
    global launches
    launches += 1
    return y
