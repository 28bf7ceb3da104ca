"""K1 -- fused GroupNorm + Mish over NHWC activations.

`gn_mish` sends a tensor on the CPU to `gn_mish_plain` and a tensor on a
CUDA device to the hand-written kernel in `csrc/gn_mish.cu`; it raises on
any other device and never falls back. The kernel replaces
`lunaris_orion_tpu/ops/pallas/gn_mish.py` (`_stats_kernel`, `_apply_kernel`)
and computes exactly what `group_norm_mish_pallas` computes.

`gn_mish` is a `torch.autograd.Function`: its backward is the
vector-Jacobian product of `gn_mish_plain`, recomputed from the saved
input, as the JAX package differentiates its Pallas K1 through the XLA
composition (`ops/dispatch.py` `pallas_fwd_xla_bwd`). Its forward, and
`gn_mish` itself when no gradient is recorded, call the operator
`lunaris_orion::gn_mish` (`ops/library.py`), whose CUDA kernel is
`_kernel` and whose CPU kernel is `gn_mish_plain`: eager and traced
(`torch.export`) code take one route into the kernel.

On a CUDA tensor K1 is two launches: pass 1 (per-split partial sums),
then the apply, whose blocks each fold their image's partials into the
affine before they apply it (`apply_geometry` gives its launch geometry).
`gn_mish_kernel` reaches the same path with another mish (`MISH_FORMS`)
or the earlier three-launch form (pass 1, fold, a grid-stride apply), for
comparisons; `gn_mish` never passes them.

`group_stats` is the stats-only entry (the counterpart of
`group_stats_pallas`): the kernel's pass 1 alone (`group_partials`), folded
to per-(B, G) mean and inv_std. `gn_mish_apply` is the apply alone, from x
and pass 1's partials. `group_affine_kernel` is pass 1 and the kernel's
fold without the apply: `group_affine` on the card, the alpha and beta that
K5 (`fused_stage.gn_mish_conv3`) takes.

`launches` counts the calls of the two-launch path (`gn_mish`,
`gn_mish_kernel`; one per call on a CUDA tensor), `apply_launches` those
of the apply alone (`gn_mish_apply`), `stats_launches` those of pass 1
alone (`group_partials`, `group_stats`) and `affine_launches` those of
`group_affine_kernel`; the plain versions and the earlier form do not
count.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from lunaris_orion_tpu_torch.ops.cuda import _build

launches = 0
apply_launches = 0
stats_launches = 0
affine_launches = 0

MAX_CHANNELS = 2048          # the kernel's per-block channel table
MAX_FOLD = 2048              # groups x splits that the fold stages
THREADS = 256                # a block of pass 1 and of the apply
# What the apply evaluates after the affine (the C entry's `mish`): the
# exp / log1p / tanh chain that K5 also uses, the one-exp form
# v n / (n + 2) with n = e (e + 2), e = exp(v), or nothing (a probe of the
# apply's cost without its activation, for measurement only). `gn_mish`
# ships the one-exp form: with the full chain the bf16 apply is bound by
# issue slots, not bytes (on an H100, half again the time of the apply
# without mish; the one-exp form within a tenth of it). It is held to the
# bars of the plain version: 1e-5 in f32, 2 ulps an element in bf16.
MISH_FORMS = ("exact", "fast", "none")
MISH = "fast"


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


def stats_splits(b: int, hw: int, c: int, groups: int, sms: int) -> int:
    """Pass 1's grid an image: about 4 blocks per SM, each summing at least
    ~8k elements, and at most MAX_FOLD / groups, so that the fold stages
    an image's partials in shared memory."""
    return max(1, min(-(-4 * sms // b), -(-hw * c // 8192), hw,
                      MAX_FOLD // groups))


def _stats_splits(x: torch.Tensor, groups: int) -> int:
    b, h, w, c = x.shape
    return stats_splits(b, h * w, c, groups, _sm_count(x.device.index or 0))


class ApplyGeometry(NamedTuple):
    """The apply's launch: grid (blocks, B) of THREADS threads. A block
    covers `pixels` consecutive pixels of one image (the last block fewer);
    thread t owns vector columns t % tc, t % tc + tc, ... of `vec` channels
    each and walks the block's pixels t // tc, t // tc + rows, ...; threads
    with t // tc >= rows idle."""
    vec: int          # channels a load: 16 bytes, or 1 (the scalar form)
    tc: int           # threads that share a pixel
    rows: int         # pixels a block walks side by side
    blocks: int       # blocks an image
    pixels: int       # pixels a block


def apply_geometry(b: int, hw: int, c: int, itemsize: int, groups: int,
                   splits: int, sms: int, aligned: bool = True
                   ) -> ApplyGeometry:
    """The apply's geometry for x [b, hw, c] of `itemsize`-byte values,
    with pass 1's `splits`. The vector form needs c a multiple of the
    16-byte vector and x and y 16-byte aligned (`aligned`). Blocks: about
    16 an SM over the batch, each covering at least one pixel a thread row
    and at least 16 times the 2 * groups * splits partials it folds."""
    v = 16 // itemsize
    vec = v if aligned and c % v == 0 else 1
    tc = min(c // vec, THREADS)
    rows = THREADS // tc
    blocks = max(1, min(-(-16 * sms // b), -(-hw // rows),
                        hw * c // (32 * groups * splits)))
    pixels = -(-hw // blocks)
    return ApplyGeometry(vec, tc, rows, -(-hw // pixels), pixels)


def _check_affine(name: str, x: torch.Tensor, weight: torch.Tensor,
                  bias: torch.Tensor, groups: int) -> None:
    _check_x(name, x, groups)
    c = x.shape[3]
    for arg, t in (("weight", weight), ("bias", bias)):
        if (t.dtype != torch.float32 or t.shape != (c,)
                or t.device != x.device or not t.is_contiguous()):
            raise ValueError(f"{name}: {arg} must be contiguous f32 [{c}] "
                             f"on {x.device}")


def _apply_geometry(x: torch.Tensor, y: torch.Tensor, groups: int,
                    splits: int) -> ApplyGeometry:
    b, h, w, c = x.shape
    return apply_geometry(b, h * w, c, x.element_size(), groups, splits,
                          _sm_count(x.device.index or 0),
                          x.data_ptr() % 16 == 0 and y.data_ptr() % 16 == 0)


def _mish_form(name: str, mish: str) -> int:
    if mish not in MISH_FORMS:
        raise ValueError(f"{name}: mish must be one of {MISH_FORMS}, got "
                         f"{mish!r}")
    return MISH_FORMS.index(mish)


def _kernel(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
            groups: int, eps: float, mish: str = MISH) -> torch.Tensor:
    _check_affine("gn_mish", x, weight, bias, groups)
    form = _mish_form("gn_mish", mish)
    b, h, w, c = x.shape
    y = torch.empty_like(x)
    splits = _stats_splits(x, groups)
    geo = _apply_geometry(x, y, groups, splits)
    partial = torch.empty(b * groups * splits * 2, device=x.device,
                          dtype=torch.float32)
    err = _build.library().lunaris_gn_mish(
        x.data_ptr(), y.data_ptr(), weight.data_ptr(), bias.data_ptr(),
        partial.data_ptr(), b, h * w, c, groups, splits, geo.blocks, eps,
        int(x.dtype == torch.bfloat16), form,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "gn_mish")
    global launches
    launches += 1
    return y


def _earlier_kernel(x: torch.Tensor, weight: torch.Tensor,
                    bias: torch.Tensor, groups: int,
                    eps: float) -> torch.Tensor:
    _check_affine("gn_mish", x, weight, bias, groups)
    b, h, w, c = x.shape
    splits = _stats_splits(x, groups)
    # The earlier apply's grid: about 8 blocks per SM, grid-stride.
    apply_blocks = max(1, min(-(-8 * _sm_count(x.device.index or 0) // b),
                              -(-h * w * c // THREADS)))
    y = torch.empty_like(x)
    partial = torch.empty(b * groups * splits * 2, device=x.device,
                          dtype=torch.float32)
    affine = torch.empty(2 * b * c, device=x.device, dtype=torch.float32)
    err = _build.library().lunaris_gn_mish_earlier(
        x.data_ptr(), y.data_ptr(), weight.data_ptr(), bias.data_ptr(),
        partial.data_ptr(), affine.data_ptr(), b, h * w, c, groups, splits,
        apply_blocks, eps, int(x.dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "gn_mish (earlier form)")
    return y


def gn_mish_kernel(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                   *, groups: int = 8, eps: float = 1e-5, mish: str = MISH,
                   earlier: bool = False) -> torch.Tensor:
    """K1's forward on a CUDA tensor, for comparisons: the two-launch path
    with the apply's `mish` form (one of MISH_FORMS; `gn_mish` takes MISH),
    or with `earlier` the three-launch form (pass 1, the fold kernel, a
    grid-stride apply with the exact mish; not counted). No autograd."""
    if x.device.type != "cuda":
        raise ValueError(f"gn_mish_kernel: needs a CUDA tensor, got "
                         f"{x.device}")
    if earlier:
        return _earlier_kernel(x, weight, bias, groups, eps)
    return _kernel(x, weight, bias, groups, eps, mish)


def fold_partials_plain(partial: torch.Tensor, weight: torch.Tensor,
                        bias: torch.Tensor, *, n_set: int,
                        eps: float = 1e-5):
    """The fold in the kernel's order: partial [B, G, splits, 2] (sums of x
    and x^2 over `n_set` values a group) -> (A, B'), each [B, C] f32.
    The splits are summed one by one in index order, as `fold_affine`
    does; mean, variance clamped at 0, inv_std = 1 / sqrt(var + eps)."""
    s1 = torch.zeros(partial.shape[:2], dtype=torch.float32,
                     device=partial.device)
    s2 = torch.zeros_like(s1)
    for k in range(partial.shape[2]):
        s1 = s1 + partial[:, :, k, 0]
        s2 = s2 + partial[:, :, k, 1]
    mean = s1 / n_set
    var = (s2 / n_set - mean * mean).clamp_min(0.0)
    inv = 1.0 / torch.sqrt(var + eps)
    cg = weight.shape[0] // partial.shape[1]
    w32, b32 = weight.float(), bias.float()
    a = inv.repeat_interleave(cg, dim=1) * w32
    bp = b32 - (mean * inv).repeat_interleave(cg, dim=1) * w32
    return a, bp


def gn_mish_apply_plain(x: torch.Tensor, partial: torch.Tensor,
                        weight: torch.Tensor, bias: torch.Tensor, *,
                        groups: int = 8, eps: float = 1e-5) -> torch.Tensor:
    """The plain apply: `fold_partials_plain` of pass 1's partials, then
    y = mish(x * A + B') in f32, one cast to x's dtype."""
    b, h, w, c = x.shape
    a, bp = fold_partials_plain(partial, weight, bias,
                                n_set=h * w * (c // groups), eps=eps)
    y = x.float() * a[:, None, None, :] + bp[:, None, None, :]
    return (y * torch.tanh(F.softplus(y))).to(x.dtype)


def gn_mish_apply(x: torch.Tensor, partial: torch.Tensor,
                  weight: torch.Tensor, bias: torch.Tensor, *,
                  groups: int = 8, eps: float = 1e-5,
                  mish: str = MISH) -> torch.Tensor:
    """The apply alone (the counterpart of `group_partials`): y from x
    [B, H, W, C] and pass 1's partial [B, G, splits, 2] f32. On a CUDA
    tensor it launches the apply, whose blocks fold the partials
    themselves, with the apply's `mish` form, and counts it in
    `apply_launches`; on a CPU tensor it is `gn_mish_apply_plain`."""
    if x.device.type == "cpu":
        return gn_mish_apply_plain(x, partial, weight, bias, groups=groups,
                                   eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"gn_mish_apply: unsupported device {x.device}")
    _check_affine("gn_mish_apply", x, weight, bias, groups)
    form = _mish_form("gn_mish_apply", mish)
    b, h, w, c = x.shape
    if (partial.dtype != torch.float32 or partial.dim() != 4
            or partial.shape[:2] != (b, groups) or partial.shape[3] != 2
            or partial.shape[2] * groups > MAX_FOLD
            or partial.device != x.device or not partial.is_contiguous()):
        raise ValueError(f"gn_mish_apply: partial must be contiguous f32 "
                         f"[{b}, {groups}, splits, 2] on {x.device} with "
                         f"groups x splits at most {MAX_FOLD}")
    y = torch.empty_like(x)
    splits = partial.shape[2]
    geo = _apply_geometry(x, y, groups, splits)
    err = _build.library().lunaris_gn_mish_apply(
        x.data_ptr(), y.data_ptr(), partial.data_ptr(), weight.data_ptr(),
        bias.data_ptr(), b, h * w, c, groups, splits, geo.blocks, eps,
        int(x.dtype == torch.bfloat16), form,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "gn_mish_apply")
    global apply_launches
    apply_launches += 1
    return y


def group_stats_plain(x: torch.Tensor, *, groups: int = 8, eps: float = 1e-5):
    """Per-(B, G) (mean, inv_std) of GroupNorm over x [B, H, W, C], f32:
    `group_affine`'s moments (variance clamped at 0)."""
    b, h, w, c = x.shape
    x32 = x.float().reshape(b, h * w, groups, c // groups)
    mean = x32.mean(dim=(1, 3))
    var = (x32.square().mean(dim=(1, 3)) - mean.square()).clamp_min(0.0)
    return mean, torch.rsqrt(var + eps)


def group_partials_plain(x: torch.Tensor, *, groups: int = 8,
                         splits: int = 1) -> torch.Tensor:
    """The plain version of pass 1: [B, G, splits, 2] f32, the sums of x
    and x^2 of each group over the pixels of each split, split k holding
    pixels [k * per, (k + 1) * per) with per = ceil(H * W / splits), as the
    kernel's grid cuts them (a split past the last pixel sums to 0)."""
    b, h, w, c = x.shape
    hw = h * w
    per = -(-hw // splits)
    x32 = F.pad(x.float().reshape(b, hw, groups, c // groups),
                (0, 0, 0, 0, 0, per * splits - hw))
    x32 = x32.reshape(b, splits, per, groups, c // groups)
    return torch.stack([x32.sum(dim=(2, 4)), x32.square().sum(dim=(2, 4))],
                       dim=-1).transpose(1, 2).contiguous()


def group_partials(x: torch.Tensor, *, groups: int = 8) -> torch.Tensor:
    """The kernel's pass 1 alone on x [B, H, W, C]: partial [B, G, splits,
    2] f32, the sums of x and x^2 of each group over the pixels of each
    split (no atomics: the same bits every run). On a CUDA tensor it
    launches pass 1 and counts it in `stats_launches`; on a CPU tensor it
    is `group_partials_plain`."""
    if x.device.type == "cpu":
        return group_partials_plain(x, groups=groups)
    if x.device.type != "cuda":
        raise ValueError(f"group_partials: unsupported device {x.device}")
    _check_x("group_partials", x, groups)
    b, h, w, c = x.shape
    partial = torch.empty(b, groups, _stats_splits(x, groups), 2,
                          device=x.device, dtype=torch.float32)
    err = _build.library().lunaris_gn_stats_pass1(
        x.data_ptr(), partial.data_ptr(), b, h * w, c, groups,
        partial.shape[2], int(x.dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "group_partials")
    global stats_launches
    stats_launches += 1
    return partial


def group_stats(x: torch.Tensor, *, groups: int = 8, eps: float = 1e-5):
    """The stats-only entry: per-(B, G) (mean, inv_std) of x [B, H, W, C].
    On CUDA it launches the kernel's pass 1 alone (`group_partials`) and
    folds the few partials with torch; on the CPU it is
    `group_stats_plain`."""
    if x.device.type == "cpu":
        return group_stats_plain(x, groups=groups, eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"group_stats: unsupported device {x.device}")
    b, h, w, c = x.shape
    sums = group_partials(x, groups=groups).sum(dim=2) / float(
        h * w * (c // groups))
    mean = sums[..., 0]
    var = (sums[..., 1] - mean.square()).clamp_min(0.0)
    return mean, torch.rsqrt(var + eps)


def group_affine_kernel(x: torch.Tensor, weight: torch.Tensor,
                        bias: torch.Tensor, *, groups: int = 8,
                        eps: float = 1e-5):
    """`group_affine` by the kernel: (A, B'), each a contiguous [B, C] f32
    tensor, from pass 1 and the fold of K1 with no torch reduction on the
    way. On a CUDA tensor it launches the two kernels (weight, bias: f32
    [C] on the same card); on a CPU tensor it is `group_affine`; it raises
    elsewhere."""
    if x.device.type == "cpu":
        return group_affine(x, weight, bias, groups=groups, eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"group_affine_kernel: unsupported device {x.device}")
    _check_affine("group_affine_kernel", x, weight, bias, groups)
    b, h, w, c = x.shape
    splits = _stats_splits(x, groups)
    partial = torch.empty(b * groups * splits * 2, device=x.device,
                          dtype=torch.float32)
    affine = torch.empty(2, b, c, device=x.device, dtype=torch.float32)
    err = _build.library().lunaris_gn_affine(
        x.data_ptr(), weight.data_ptr(), bias.data_ptr(), partial.data_ptr(),
        affine[0].data_ptr(), affine[1].data_ptr(), b, h * w, c, groups,
        splits, eps, int(x.dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "group_affine_kernel")
    global affine_launches
    affine_launches += 1
    return affine[0], affine[1]


class _GnMish(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, groups, eps):
        ctx.save_for_backward(x, weight, bias)
        ctx.groups, ctx.eps = groups, eps
        return torch.ops.lunaris_orion.gn_mish.default(x, weight, bias,
                                                       groups, eps)

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
    differentiable in x, weight and bias. Without a gradient to record it
    calls the operator alone."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"gn_mish: unsupported device {x.device}")
    if not (torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, weight, bias))):
        return torch.ops.lunaris_orion.gn_mish.default(x, weight, bias,
                                                       groups, eps)
    return _GnMish.apply(x, weight, bias, groups, eps)
