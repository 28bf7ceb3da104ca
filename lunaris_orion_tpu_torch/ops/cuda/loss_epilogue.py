"""K3 -- the fused MSE + KL loss epilogue of the VAE.

`mse_kl` sends tensors on the CPU to `mse_kl_plain` and tensors on a CUDA
device to the hand-written kernel in `csrc/loss_epilogue.cu`; it raises on
any other device and never falls back. The kernel replaces
`lunaris_orion_tpu/ops/pallas/loss_epilogue.py` `_kernel` and computes what
`mse_kl_pallas` computes:

    recon_loss = mean((recon - x)^2)
    kl_loss    = -0.5 * mean(1 + logvar - mu^2 - exp(logvar))

`mse_kl` is a `torch.autograd.Function` whose backward is the
vector-Jacobian product of `mse_kl_plain`, as the JAX package
differentiates K3 through `_recon_kl_xla`.

`launches` counts the kernel launches made by `mse_kl`; the plain version
does not count.
"""

from __future__ import annotations

from typing import Tuple

import torch

from lunaris_orion_tpu_torch.ops.cuda import _build

launches = 0


def mse_kl_plain(recon: torch.Tensor, x: torch.Tensor, mu: torch.Tensor,
                 logvar: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(recon_loss, kl_loss) as f32 scalars, every reduction in f32
    (`_recon_kl_xla`)."""
    recon_loss = (recon.float() - x.float()).square().mean()
    lv = logvar.float()
    kl_loss = -0.5 * (1.0 + lv - mu.float().square() - torch.exp(lv)).mean()
    return recon_loss, kl_loss


def _kernel(recon, x, mu, logvar):
    if recon.dim() != 4 or x.shape != recon.shape or mu.dim() != 2 or (
            logvar.shape != mu.shape) or mu.shape[0] != recon.shape[0]:
        raise ValueError("mse_kl: recon and x must be [B, H, W, C] and mu, "
                         "logvar [B, L]")
    if recon.dtype not in (torch.float32, torch.bfloat16) or any(
            t.dtype != recon.dtype for t in (x, mu, logvar)):
        raise ValueError("mse_kl: the four inputs must share one dtype, f32 "
                         "or bf16")
    for name, t in (("recon", recon), ("x", x), ("mu", mu),
                    ("logvar", logvar)):
        if t.device != recon.device or not t.is_contiguous():
            raise ValueError(f"mse_kl: {name} must be contiguous on "
                             f"{recon.device}")
    b, l = mu.shape
    n_img = recon[0].numel()
    sse = torch.empty(b, device=recon.device, dtype=torch.float32)
    kl = torch.empty_like(sse)
    err = _build.library().lunaris_mse_kl(
        recon.data_ptr(), x.data_ptr(), mu.data_ptr(), logvar.data_ptr(),
        sse.data_ptr(), kl.data_ptr(), b, n_img, l,
        int(recon.dtype == torch.bfloat16),
        torch.cuda.current_stream(recon.device).cuda_stream)
    _build.check(err, "mse_kl")
    global launches
    launches += 1
    return sse.sum() / (b * n_img), -0.5 * kl.sum() / (b * l)


class _MseKl(torch.autograd.Function):
    @staticmethod
    def forward(ctx, recon, x, mu, logvar):
        ctx.save_for_backward(recon, x, mu, logvar)
        if recon.device.type == "cpu":
            return mse_kl_plain(recon, x, mu, logvar)
        return _kernel(recon, x, mu, logvar)

    @staticmethod
    def backward(ctx, d_recon_loss, d_kl_loss):
        inputs = [t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        with torch.enable_grad():
            outs = mse_kl_plain(*inputs)
        wanted = [t for t in inputs if t.requires_grad]
        got = iter(torch.autograd.grad(outs, wanted,
                                       (d_recon_loss, d_kl_loss),
                                       allow_unused=True) if wanted else ())
        return tuple(next(got) if t.requires_grad else None for t in inputs)


def mse_kl(recon: torch.Tensor, x: torch.Tensor, mu: torch.Tensor,
           logvar: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3: recon, x [B, H, W, C] and mu, logvar [B, L] (contiguous, one
    dtype, f32 or bf16) -> (recon_loss, kl_loss) f32 scalars,
    differentiable in all four inputs."""
    if recon.device.type not in ("cpu", "cuda"):
        raise ValueError(f"mse_kl: unsupported device {recon.device}")
    return _MseKl.apply(recon, x, mu, logvar)
