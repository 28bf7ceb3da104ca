"""K3 -- the fused MSE + KL loss epilogue of the VAE.

`mse_kl` sends tensors on the CPU to `mse_kl_plain` and tensors on a CUDA
device to the hand-written kernel in `csrc/loss_epilogue.cu`; it raises on
any other device and never falls back. The kernel replaces
`lunaris_orion_tpu/ops/pallas/loss_epilogue.py` `_kernel` and computes what
`mse_kl_pallas` computes:

    recon_loss = mean((recon - x)^2)
    kl_loss    = -0.5 * mean(1 + logvar - mu^2 - exp(logvar))

On a CUDA tensor it is one launch on every SM that writes both finished
scalars (`geometry` gives its grid, `mse_kl_blocked_plain` its order of
summation); no torch reduction follows it. The last block finds that it
is last from a ticket counter that it resets; the wrapper keeps one
counter per (device, stream), so calls on several streams may overlap.
`mse_kl_kernel(...,
earlier=True)` reaches the earlier form (one block per sample, then torch
sums), for comparisons; `mse_kl` never passes it.

`mse_kl` is a `torch.autograd.Function` whose backward is the
vector-Jacobian product of `mse_kl_plain`, as the JAX package
differentiates K3 through `_recon_kl_xla`.

`launches` counts the kernel launches made by `mse_kl` and
`mse_kl_kernel`; the plain versions and the earlier form do not count.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import torch

from lunaris_orion_tpu_torch.ops.cuda import _build

launches = 0

THREADS = 512                # a block of the kernel
MAX_BLOCKS = 1024            # partials the last block stages
# The ticket counter of the last block, one per (device, stream): it is 0
# between launches, and launches on one stream run one after another.
_counters: dict = {}


def mse_kl_plain(recon: torch.Tensor, x: torch.Tensor, mu: torch.Tensor,
                 logvar: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(recon_loss, kl_loss) as f32 scalars, every reduction in f32
    (`_recon_kl_xla`)."""
    recon_loss = (recon.float() - x.float()).square().mean()
    lv = logvar.float()
    kl_loss = -0.5 * (1.0 + lv - mu.float().square() - torch.exp(lv)).mean()
    return recon_loss, kl_loss


class Geometry(NamedTuple):
    """The kernel's launch: `blocks` blocks of THREADS threads; thread
    g = block * THREADS + t sums the `vec`-value vectors g, g + S, g + 2 S,
    ... (S = blocks * THREADS) of the flat recon - x, then tail value g
    (the n % vec values after the last whole vector), then the values g,
    g + S, ... of the flat mu and logvar."""
    vec: int          # values a load: 16 bytes, or 1 (the scalar form)
    blocks: int


def geometry(n: int, m: int, itemsize: int, sms: int,
             aligned: bool = True) -> Geometry:
    """The grid for n image values and m latent values of `itemsize` bytes:
    2 blocks an SM, fewer where there is less than a vector a thread; the
    vector form where recon and x are 16-byte aligned."""
    vec = 16 // itemsize if aligned else 1
    work = max(-(-n // vec), m)
    return Geometry(vec, max(1, min(2 * sms, MAX_BLOCKS,
                                    -(-work // THREADS))))


def _strided_sums(terms: torch.Tensor, threads: int) -> torch.Tensor:
    """terms [k, threads]: each column summed in row order, in f32, each
    add rounded once (an f32 fma of the kernel: the f64 sum of f32 values
    and a product of two is exact, then rounded)."""
    acc = torch.zeros(threads, dtype=torch.float64)
    for row in terms.double():
        acc = (acc + row).float().double()
    return acc.float()


def mse_kl_blocked_plain(recon: torch.Tensor, x: torch.Tensor,
                         mu: torch.Tensor, logvar: torch.Tensor,
                         geo: Geometry) -> Tuple[torch.Tensor, torch.Tensor]:
    """(recon_loss, kl_loss) summed in the kernel's order for the launch
    `geo`: each thread's slice in order (`Geometry`), a fixed tree over a
    block's threads, the blocks' partials in index order; both divisions
    last. Runs on the CPU."""
    threads = geo.blocks * THREADS
    r = recon.detach().float().cpu().flatten()
    d = r - x.detach().float().cpu().flatten()
    n, v = d.numel(), geo.vec
    nv = n // v
    rows = -(-nv // threads)
    sq = d[:nv * v].double().square()
    sq = torch.cat([sq, sq.new_zeros(rows * threads * v - nv * v)])
    sq = sq.reshape(rows, threads, v).permute(0, 2, 1).reshape(-1, threads)
    tail = sq.new_zeros(1, threads)
    tail[0, :n - nv * v] = d[nv * v:].double().square()
    sse = _strided_sums(torch.cat([sq, tail]), threads)
    lv = logvar.detach().float().cpu().flatten()
    mv = mu.detach().float().cpu().flatten()
    terms = 1.0 + lv - mv * mv - torch.exp(lv)
    m = terms.numel()
    terms = torch.cat([terms, terms.new_zeros(-(-m // threads) * threads - m)])
    kl = _strided_sums(terms.reshape(-1, threads), threads)

    def tree_then_blocks(per_thread):
        red = per_thread.reshape(geo.blocks, THREADS).clone()
        s = THREADS // 2
        while s:
            red[:, :s] = red[:, :s] + red[:, s:2 * s]
            s //= 2
        total = torch.zeros((), dtype=torch.float32)
        for part in red[:, 0]:
            total = total + part
        return total

    return (tree_then_blocks(sse) / n,
            -0.5 * tree_then_blocks(kl) / m)


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(recon, x, mu, logvar):
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


def _counter(device: torch.device, stream: int) -> torch.Tensor:
    """The ticket counter of (device, stream), made (zeroed on that stream)
    at the first launch there."""
    key = (device.index, stream)
    if key not in _counters:
        _counters[key] = torch.zeros(1, dtype=torch.int32, device=device)
    return _counters[key]


def _kernel(recon, x, mu, logvar):
    """One launch; the two losses are 0-d views of its one output tensor.
    The launch's ticket counter is kept per (device, stream), so launches
    on several streams do not share one."""
    _check(recon, x, mu, logvar)
    n, m = recon.numel(), mu.numel()
    geo = geometry(n, m, recon.element_size(),
                   _sm_count(recon.device.index or 0),
                   recon.data_ptr() % 16 == 0 and x.data_ptr() % 16 == 0)
    stream = torch.cuda.current_stream(recon.device).cuda_stream
    out = torch.empty(2 + 2 * geo.blocks, device=recon.device,
                      dtype=torch.float32)
    err = _build.library().lunaris_mse_kl(
        recon.data_ptr(), x.data_ptr(), mu.data_ptr(), logvar.data_ptr(),
        out.data_ptr(), _counter(recon.device, stream).data_ptr(), n, m,
        geo.blocks, int(recon.dtype == torch.bfloat16), stream)
    _build.check(err, "mse_kl")
    global launches
    launches += 1
    return out[0], out[1]


def _earlier_kernel(recon, x, mu, logvar):
    _check(recon, x, mu, logvar)
    b, l = mu.shape
    n_img = recon[0].numel()
    sse = torch.empty(b, device=recon.device, dtype=torch.float32)
    kl = torch.empty_like(sse)
    err = _build.library().lunaris_mse_kl_per_sample(
        recon.data_ptr(), x.data_ptr(), mu.data_ptr(), logvar.data_ptr(),
        sse.data_ptr(), kl.data_ptr(), b, n_img, l,
        int(recon.dtype == torch.bfloat16),
        torch.cuda.current_stream(recon.device).cuda_stream)
    _build.check(err, "mse_kl (earlier form)")
    return sse.sum() / (b * n_img), -0.5 * kl.sum() / (b * l)


def mse_kl_kernel(recon: torch.Tensor, x: torch.Tensor, mu: torch.Tensor,
                  logvar: torch.Tensor, *, earlier: bool = False
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3's forward on CUDA tensors, for comparisons: the one-launch kernel,
    or with `earlier` the earlier form (one block per sample, then torch
    sums; not counted). No autograd."""
    if recon.device.type != "cuda":
        raise ValueError(f"mse_kl_kernel: needs CUDA tensors, got "
                         f"{recon.device}")
    if earlier:
        return _earlier_kernel(recon, x, mu, logvar)
    return _kernel(recon, x, mu, logvar)


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
