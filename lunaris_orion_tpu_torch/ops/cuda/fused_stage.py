"""K5 -- GroupNorm-apply + Mish + conv3x3 in one kernel.

`gn_mish_conv3` sends tensors on the CPU to `gn_mish_conv3_plain` and
tensors on a CUDA device to the hand-written kernel in
`csrc/fused_stage.cu`; it raises on any other device and never falls back.
The kernel replaces `lunaris_orion_tpu/ops/pallas/fused_stage.py` `_kernel`
and computes what `gn_mish_conv3_pallas` computes:

    conv3x3_same(mish(y * alpha + beta)) + wb

with the GroupNorm statistics already folded by the caller into the
per-(batch, channel) affine alpha = inv_std * gamma and
beta = bias - mean * inv_std * gamma (`gn_mish.group_affine` does that
fold). No backward: the JAX function has none.

`launches` counts the kernel launches made by `gn_mish_conv3`; the plain
version does not count.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from lunaris_orion_tpu_torch.ops.cuda import _build

launches = 0

COUTS = (32, 64)             # the kernel's compiled output widths
CIN_CHUNK = 8                # it walks the input channels in chunks of 8


def supported_shape(h: int, w: int, cin: int, cout: int) -> bool:
    """Can the kernel take y [*, h, w, cin] -> [*, h, w, cout]? Any h and w
    (ragged tiles are masked), cin a multiple of 8, cout 32 or 64."""
    return (h >= 1 and w >= 1 and cin >= CIN_CHUNK and cin % CIN_CHUNK == 0
            and cout in COUTS and -(-h // 8) <= 65535)


def _check_shapes(y, alpha, beta, w, wb):
    if y.dim() != 4 or w.dim() != 4 or tuple(w.shape[:3]) != (3, 3, y.shape[3]):
        raise ValueError("gn_mish_conv3: y must be [B, H, W, Cin] and w "
                         f"[3, 3, Cin, Cout], got {tuple(y.shape)} and "
                         f"{tuple(w.shape)}")
    b, _, _, cin = y.shape
    if alpha.shape != (b, cin) or beta.shape != (b, cin) or (
            wb.shape != (w.shape[3],)):
        raise ValueError(f"gn_mish_conv3: alpha, beta must be [{b}, {cin}] "
                         f"and wb [{w.shape[3]}]")


def gn_mish_conv3_plain(y: torch.Tensor, alpha: torch.Tensor,
                        beta: torch.Tensor, w: torch.Tensor,
                        wb: torch.Tensor) -> torch.Tensor:
    """The plain version of K5, with the rounding points of
    `gn_mish_conv3_reference`: the affine in f32, rounded to y's dtype; mish
    in f32 on the rounded value, rounded again; w and wb cast to y's dtype;
    the convolution and the bias add in f32 (the padding is zero after mish);
    one cast of the result. Nine shifted matrix products, one per tap."""
    _check_shapes(y, alpha, beta, w, wb)
    dt = y.dtype
    b, h, wd, cin = y.shape
    cout = w.shape[3]
    g = (y.float() * alpha.float()[:, None, None, :]
         + beta.float()[:, None, None, :]).to(dt).float()
    g = (g * torch.tanh(F.softplus(g))).to(dt).float()
    gp = F.pad(g, (0, 0, 1, 1, 1, 1))                 # zero halo, after mish
    w32 = w.to(dt).float()
    out = torch.zeros(b, h, wd, cout, device=y.device, dtype=torch.float32)
    for dy in range(3):
        for dx in range(3):
            out += torch.matmul(gp[:, dy:dy + h, dx:dx + wd, :], w32[dy, dx])
    return (out + wb.to(dt).float()).to(dt)


def _kernel(y, alpha, beta, w, wb):
    _check_shapes(y, alpha, beta, w, wb)
    if y.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"gn_mish_conv3: dtype {y.dtype} is not f32 or bf16")
    b, h, wd, cin = y.shape
    cout = w.shape[3]
    if not supported_shape(h, wd, cin, cout) or b > 65535:
        raise ValueError(
            f"gn_mish_conv3: [{b}, {h}, {wd}, {cin}] -> {cout} is outside "
            f"the kernel's shapes (Cin a multiple of {CIN_CHUNK}, Cout in "
            f"{COUTS}, B <= 65535)")
    if alpha.dtype != torch.float32 or beta.dtype != torch.float32:
        raise ValueError("gn_mish_conv3: alpha and beta must be f32")
    w, wb = w.to(y.dtype), wb.to(y.dtype)
    for name, t in (("y", y), ("alpha", alpha), ("beta", beta), ("w", w),
                    ("wb", wb)):
        if t.device != y.device or not t.is_contiguous():
            raise ValueError(f"gn_mish_conv3: {name} must be contiguous on "
                             f"{y.device}")
    out = torch.empty(b, h, wd, cout, device=y.device, dtype=y.dtype)
    err = _build.library().lunaris_gn_mish_conv3(
        y.data_ptr(), alpha.data_ptr(), beta.data_ptr(), w.data_ptr(),
        wb.data_ptr(), out.data_ptr(), b, h, wd, cin, cout,
        int(y.dtype == torch.bfloat16),
        torch.cuda.current_stream(y.device).cuda_stream)
    _build.check(err, "gn_mish_conv3")
    global launches
    launches += 1
    return out


def gn_mish_conv3(y: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor,
                  w: torch.Tensor, wb: torch.Tensor) -> torch.Tensor:
    """K5: conv3x3_same(mish(y * alpha + beta)) + wb for y [B, H, W, Cin]
    (contiguous NHWC, f32 or bf16), alpha / beta [B, Cin] f32, w
    [3, 3, Cin, Cout] and wb [Cout] (cast to y's dtype). Returns
    [B, H, W, Cout] in y's dtype. On CUDA the shape must satisfy
    `supported_shape`, else ValueError."""
    if y.device.type == "cpu":
        return gn_mish_conv3_plain(y, alpha, beta, w, wb)
    if y.device.type != "cuda":
        raise ValueError(f"gn_mish_conv3: unsupported device {y.device}")
    return _kernel(y, alpha, beta, w, wb)
