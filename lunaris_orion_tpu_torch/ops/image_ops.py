"""Device-side pixelate / palette-quantize in torch (counterpart:
lunaris_orion_tpu/ops/image_ops.py, plain jnp there: no Pallas kernel, so
library calls are right here too).

The reference's pixelation post-process is host-side PIL
(generate.py:619-637): LANCZOS downscale by pixel_size -> 64-color
median-cut quantize -> NEAREST upscale. This is the batched on-device
equivalent, on whatever device the images lie:
  * LANCZOS-3 downscale as two depthwise strided convolutions (`F.conv2d`)
    over an edge-replicated border,
  * a palette per image by k-means (Lloyd iterations: `argmin` over the
    squared distances, one-hot matrix products for the means; median-cut
    is host-sequential),
  * NEAREST upscale as `repeat_interleave`.
The host PIL path in `data/synthesis.py` stays the byte-exact path for
dataset generation. Images are NHWC [B, H, W, 3], as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

LUMA = (0.299, 0.587, 0.114)


def lanczos_kernel(scale: int, a: int = 3) -> np.ndarray:
    """1-D Lanczos-a resampling filter for an integer downscale factor."""
    support = a * scale
    x = (np.arange(2 * support) - support + 0.5) / scale
    k = np.sinc(x) * np.sinc(x / a)
    return (k / k.sum()).astype(np.float32)


def lanczos_downscale(images: torch.Tensor, factor: int) -> torch.Tensor:
    """[B, H, W, C] -> [B, H/f, W/f, C] f32 via separable Lanczos-3: the
    border replicated (PIL renormalizes in-bounds taps; a zero pad would
    darken the border), then a vertical and a horizontal depthwise conv
    of stride `factor`."""
    k = torch.from_numpy(lanczos_kernel(factor)).to(images.device)
    t = k.numel()
    pad = (t - factor) // 2
    c = images.shape[-1]
    x = images.float().permute(0, 3, 1, 2)
    x = F.pad(x, (pad, pad, pad, pad), mode="replicate")
    x = F.conv2d(x, k.view(1, 1, t, 1).expand(c, 1, t, 1), stride=(factor, 1),
                 groups=c)
    x = F.conv2d(x, k.view(1, 1, 1, t).expand(c, 1, 1, t), stride=(1, factor),
                 groups=c)
    return x.permute(0, 2, 3, 1)


def _sq_dist(p: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """[..., P, K] squared distances of pixels p [..., P, 3] to colours
    c [..., K, 3], from the differences. The JAX package expands them
    (|p|^2 - 2 p.c + |c|^2), which at 0..255 loses the small distances to
    cancellation in f32: on decoded sprites 1.6 % of pixels then pick
    another colour than in f64, and the card and the CPU disagree. The
    differences give the f64 assignment in f32 there, and the JAX
    package's wherever its form is exact."""
    return (p.unsqueeze(-2) - c.unsqueeze(-3)).square().sum(-1)


def kmeans_palette(pixels: torch.Tensor, num_colors: int = 64,
                   iters: int = 8) -> torch.Tensor:
    """pixels [..., P, 3] -> palette [..., num_colors, 3] by Lloyd
    iterations from a deterministic init: the pixels at evenly spaced
    ranks of a stable sort by luminance. A colour that no pixel picks
    keeps its place."""
    p = pixels.float()
    n = p.shape[-2]
    luma = p @ torch.tensor(LUMA, device=p.device)
    order = torch.argsort(luma, dim=-1, stable=True)
    idx = (torch.arange(num_colors, device=p.device) * (n - 1)
           ) // max(num_colors - 1, 1)
    centroids = torch.gather(p, -2, order[..., idx, None].expand(
        *p.shape[:-2], num_colors, 3))
    for _ in range(iters):
        assign = F.one_hot(_sq_dist(p, centroids).argmin(-1),
                           num_colors).float()                 # [..., P, K]
        counts = assign.sum(-2).unsqueeze(-1)                  # [..., K, 1]
        sums = assign.transpose(-1, -2) @ p
        centroids = torch.where(counts > 0, sums / counts.clamp_min(1),
                                centroids)
    return centroids


def quantize_to_palette(pixels: torch.Tensor,
                        palette: torch.Tensor) -> torch.Tensor:
    """Each pixel [..., P, 3] replaced by its nearest palette colour
    [..., K, 3] (the first of equals)."""
    nearest = _sq_dist(pixels, palette).argmin(-1)             # [..., P]
    return torch.gather(palette, -2, nearest[..., None].expand(
        *nearest.shape, 3))


def pixelate_device(images: torch.Tensor, *, pixel_size: int = 8,
                    num_colors: int = 64) -> torch.Tensor:
    """uint8 or float (0..255 scale) [B, H, W, 3] -> pixelated uint8
    [B, H, W, 3] on the images' device: Lanczos downscale, a k-means
    palette a sprite, nearest-colour quantize, NEAREST upscale, rounded
    half to even and clipped to 0..255."""
    small = lanczos_downscale(images, pixel_size)              # [B, h, w, 3]
    b, h, w, _ = small.shape
    px = small.reshape(b, h * w, 3)
    q = quantize_to_palette(px, kmeans_palette(px, num_colors))
    up = q.reshape(b, h, w, 3).repeat_interleave(pixel_size, 1)
    up = up.repeat_interleave(pixel_size, 2)
    return up.round().clamp(0, 255).to(torch.uint8)
