"""K1 -- fused GroupNorm + Mish over NHWC activations.

`gn_mish` sends a tensor on the CPU to `gn_mish_plain` and a tensor on a
CUDA device to the hand-written kernel in `csrc/gn_mish.cu`; it raises on
any other device and never falls back. The kernel replaces
`lunaris_orion_tpu/ops/pallas/gn_mish.py` (`_stats_kernel`, `_apply_kernel`)
and computes exactly what `group_norm_mish_pallas` computes.

`gn_mish` is a `torch.autograd.Function`: its backward is the
vector-Jacobian product of `gn_mish_plain`, recomputed from the saved
input, as the JAX package differentiates its Pallas K1 through the XLA
composition (`ops/dispatch.py` `pallas_fwd_xla_bwd`).

`group_stats` is the stats-only entry (the counterpart of
`group_stats_pallas`): the kernel's pass 1 alone, folded to per-(B, G) mean
and inv_std.

`launches` counts the kernel launches made by `gn_mish` (one per call on a
CUDA tensor) and `stats_launches` those made by `group_stats`; the plain
versions do not count.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from lunaris_orion_tpu_torch.ops.cuda import _build

launches = 0
stats_launches = 0

MAX_CHANNELS = 2048          # the kernel's per-block channel table
_THREADS = 256


def group_affine(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                 *, groups: int = 8, eps: float = 1e-5):
    """GroupNorm(groups) of x [B, H, W, C] folded to (A, B'), each [B, C]
    f32: normalising x and applying weight / bias is x * A + B'.

    The JAX package's formulation: per-channel moments reduced over H, W in
    f32, folded to per-(B, G) mean and E[x^2]; variance clamped at 0;
    A = weight * inv_std and B' = bias - mean * inv_std * weight."""
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
    return a, bp


def gn_mish_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                  *, groups: int = 8, eps: float = 1e-5) -> torch.Tensor:
    """mish(GroupNorm(groups)(x) * weight + bias) for x [B, H, W, C]:
    y = x * A + B' with `group_affine`'s fold, in f32; mish in f32; one cast
    back to x's dtype."""
    a, bp = group_affine(x, weight, bias, groups=groups, eps=eps)
    y = x.float() * a[:, None, None, :] + bp[:, None, None, :]
    return (y * torch.tanh(F.softplus(y))).to(x.dtype)


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check_x(name: str, x: torch.Tensor, groups: int) -> None:
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(
            f"{name}: x must be a contiguous NHWC [B, H, W, C] tensor (the "
            "NHWC view of a channels_last NCHW tensor is one)")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: dtype {x.dtype} is not f32 or bf16")
    _, h, w, c = x.shape
    if c % groups != 0 or c > MAX_CHANNELS:
        raise ValueError(f"{name}: C={c} must be a multiple of groups="
                         f"{groups} and at most {MAX_CHANNELS}")
    if h * w * c >= 2**31:
        raise ValueError(f"{name}: one image must hold fewer than 2**31 "
                         "elements")


def _stats_splits(x: torch.Tensor) -> int:
    """Pass 1's grid: about 4 blocks per SM, each summing at least ~8k
    elements."""
    b, h, w, c = x.shape
    sms = _sm_count(x.device.index or 0)
    return max(1, min(-(-4 * sms // b), -(-h * w * c // 8192), h * w))


def _kernel(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
            groups: int, eps: float) -> torch.Tensor:
    _check_x("gn_mish", x, groups)
    b, h, w, c = x.shape
    for name, t in (("weight", weight), ("bias", bias)):
        if (t.dtype != torch.float32 or t.shape != (c,)
                or t.device != x.device or not t.is_contiguous()):
            raise ValueError(f"gn_mish: {name} must be contiguous f32 [{c}] "
                             f"on {x.device}")
    hw = h * w
    # Pass 2: about 8 blocks per SM (a full SM's threads), grid-stride.
    splits = _stats_splits(x)
    apply_blocks = max(1, min(-(-8 * _sm_count(x.device.index or 0) // b),
                              -(-hw * c // _THREADS)))
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


def group_stats_plain(x: torch.Tensor, *, groups: int = 8, eps: float = 1e-5):
    """Per-(B, G) (mean, inv_std) of GroupNorm over x [B, H, W, C], f32:
    `group_affine`'s moments (variance clamped at 0)."""
    b, h, w, c = x.shape
    x32 = x.float().reshape(b, h * w, groups, c // groups)
    mean = x32.mean(dim=(1, 3))
    var = (x32.square().mean(dim=(1, 3)) - mean.square()).clamp_min(0.0)
    return mean, torch.rsqrt(var + eps)


def group_stats(x: torch.Tensor, *, groups: int = 8, eps: float = 1e-5):
    """The stats-only entry: per-(B, G) (mean, inv_std) of x [B, H, W, C].
    On CUDA it launches the kernel's pass 1 alone (one partial per batch,
    group and split, no atomics) and folds the few partials with torch; on
    the CPU it is `group_stats_plain`."""
    if x.device.type == "cpu":
        return group_stats_plain(x, groups=groups, eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"group_stats: unsupported device {x.device}")
    _check_x("group_stats", x, groups)
    b, h, w, c = x.shape
    splits = _stats_splits(x)
    partial = torch.empty(b, groups, splits, 2, device=x.device,
                          dtype=torch.float32)
    err = _build.library().lunaris_gn_stats_pass1(
        x.data_ptr(), partial.data_ptr(), b, h * w, c, groups, splits,
        int(x.dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "group_stats")
    global stats_launches
    stats_launches += 1
    sums = partial.sum(dim=2) / float(h * w * (c // groups))
    mean = sums[..., 0]
    var = (sums[..., 1] - mean.square()).clamp_min(0.0)
    return mean, torch.rsqrt(var + eps)


class _GnMish(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, groups, eps):
        ctx.save_for_backward(x, weight, bias)
        ctx.groups, ctx.eps = groups, eps
        if x.device.type == "cpu":
            return gn_mish_plain(x, weight, bias, groups=groups, eps=eps)
        return _kernel(x, weight, bias, groups, eps)

    @staticmethod
    def backward(ctx, dy):
        saved = ctx.saved_tensors
        inputs = [t.detach().requires_grad_(need)
                  for t, need in zip(saved, ctx.needs_input_grad)]
        with torch.enable_grad():
            y = gn_mish_plain(*inputs, groups=ctx.groups, eps=ctx.eps)
        wanted = [t for t in inputs if t.requires_grad]
        got = iter(torch.autograd.grad(y, wanted, dy) if wanted else ())
        return (*(next(got) if t.requires_grad else None for t in inputs),
                None, None)


def gn_mish(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
            *, groups: int = 8, eps: float = 1e-5) -> torch.Tensor:
    """K1 on x [B, H, W, C] (contiguous NHWC, f32 or bf16) with f32
    weight/bias [C]; returns a new NHWC tensor of x's dtype,
    differentiable in x, weight and bias."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"gn_mish: unsupported device {x.device}")
    return _GnMish.apply(x, weight, bias, groups, eps)
