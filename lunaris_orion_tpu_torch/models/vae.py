"""LunarisCoreVAE -- convolutional VAE with U-Net-style additive skips
(counterpart: lunaris_orion_tpu/models/vae.py).

Parameter names are the PyTorch reference's (lunar_generate.py:84-291):
encoder.down{i} = Sequential(Conv, GroupNorm, Mish, ResBlock),
encoder.fc_mu / fc_logvar, decoder.fc, decoder.up{i} = Sequential(ConvT,
GroupNorm, Mish), decoder.final_conv. A reference state_dict loads with
strict=True, and the bottleneck reshape is the reference's (C, H, W) order.

Images and skips cross the public functions as NHWC [B, H, W, C], as in
the JAX package; inside, activations are channels_last NCHW (see
`ops/layers.py`). Every GroupNorm+Mish runs through K1.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from lunaris_orion_tpu.config import VAEConfig
from lunaris_orion_tpu_torch.ops import layers
from lunaris_orion_tpu_torch.ops.activations import mish


def torch_default_init_(module: nn.Module, generator: torch.Generator) -> None:
    """PyTorch's default init of a conv / transposed conv / linear, drawn
    from `generator`: U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for weight and
    bias, fan_in from weight dim 1 (so a ConvTranspose2d's fan_in is
    out_ch * k * k, as in torch)."""
    w = module.weight
    bound = 1.0 / math.sqrt(w.shape[1] * w[0, 0].numel())
    with torch.no_grad():
        w.uniform_(-bound, bound, generator=generator)
        module.bias.uniform_(-bound, bound, generator=generator)


def _conv_gn_mish(seq: nn.Sequential, x: torch.Tensor, *,
                  stride: int = 1) -> torch.Tensor:
    """Sequential(Conv, GroupNorm, Mish[, ...]) with the GN+Mish on K1."""
    conv, gn = seq[0], seq[1]
    y = layers.conv2d(x, conv.weight, conv.bias, stride=stride)
    return layers.group_norm_mish(y, gn.weight, gn.bias, groups=gn.num_groups)


class ResBlock(nn.Module):
    """lunar_generate.py:28-53: two Conv->GN->Mish units, 1x1 shortcut when
    the width changes, Mish after the sum."""

    def __init__(self, cin: int, cout: int, groups: int):
        super().__init__()
        self.conv1 = nn.Sequential(nn.Conv2d(cin, cout, 3, padding=1),
                                   nn.GroupNorm(groups, cout), nn.Mish())
        self.conv2 = nn.Sequential(nn.Conv2d(cout, cout, 3, padding=1),
                                   nn.GroupNorm(groups, cout), nn.Mish())
        self.shortcut = nn.Conv2d(cin, cout, 1) if cin != cout else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = (x if self.shortcut is None else
                    layers.conv2d(x, self.shortcut.weight, self.shortcut.bias))
        out = _conv_gn_mish(self.conv2, _conv_gn_mish(self.conv1, x))
        return mish(out + identity)


class LunarisCoreVAE(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        g, chans, n = cfg.gn_groups, cfg.channels, cfg.num_down
        self.encoder = nn.Module()
        cin = 3
        for i, ch in enumerate(chans):
            setattr(self.encoder, f"down{i + 1}", nn.Sequential(
                nn.Conv2d(cin, ch, 3, stride=2, padding=1),
                nn.GroupNorm(g, ch), nn.Mish(), ResBlock(ch, ch, g)))
            cin = ch
        self.encoder.fc_mu = nn.Linear(cfg.bottleneck_dim, cfg.latent_dim)
        self.encoder.fc_logvar = nn.Linear(cfg.bottleneck_dim, cfg.latent_dim)

        self.decoder = nn.Module()
        self.decoder.fc = nn.Linear(cfg.latent_dim, cfg.bottleneck_dim)
        out_head = max(cfg.base_channels // 2, g)
        for i in range(n):
            cout = chans[n - 2 - i] if i < n - 1 else out_head
            setattr(self.decoder, f"up{i + 1}", nn.Sequential(
                nn.ConvTranspose2d(chans[n - 1 - i], cout, 4, stride=2,
                                   padding=1),
                nn.GroupNorm(g, cout), nn.Mish()))
        self.decoder.final_conv = nn.Conv2d(out_head, 3, 3, padding=1)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The JAX package's init: torch defaults for convs and linears,
        ones/zeros for GroupNorm, drawn from `generator`."""
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
                torch_default_init_(m, generator)
            elif isinstance(m, nn.GroupNorm):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)

    def encode(self, x: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, List[torch.Tensor]]:
        """x [B, H, W, 3] in [-1, 1] -> (mu, logvar, skips [B, h, w, c]).
        Skips are taken after every down block but the last."""
        h = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        skips: List[torch.Tensor] = []
        n = self.cfg.num_down
        for i in range(n):
            blk = getattr(self.encoder, f"down{i + 1}")
            h = _conv_gn_mish(blk, h, stride=2)
            h = blk[3](h)
            if i < n - 1:
                skips.append(h.permute(0, 2, 3, 1))
        flat = h.flatten(1)                                 # (C, H, W) order
        mu = layers.linear(flat, self.encoder.fc_mu.weight,
                           self.encoder.fc_mu.bias)
        logvar = layers.linear(flat, self.encoder.fc_logvar.weight,
                               self.encoder.fc_logvar.bias)
        return mu, logvar, skips

    def decode(self, z: torch.Tensor,
               skips: Sequence[torch.Tensor] = ()) -> torch.Tensor:
        """z [B, latent] (+ optional encoder skips) -> [B, H, W, 3] in
        [-1, 1], in z's dtype. Skip fusion is guarded by len(skips), so the
        skip-free prior decode works (lunar_generate.py:211-224, 288-291)."""
        cfg = self.cfg
        n, hw = cfg.num_down, cfg.bottleneck_hw
        h = layers.linear(z, self.decoder.fc.weight, self.decoder.fc.bias)
        h = h.reshape(z.shape[0], cfg.channels[-1], hw, hw).contiguous(
            memory_format=torch.channels_last)
        for i in range(n):
            blk = getattr(self.decoder, f"up{i + 1}")
            conv, gn = blk[0], blk[1]
            h = layers.conv_transpose_421(h, conv.weight, conv.bias)
            h = layers.group_norm_mish(h, gn.weight, gn.bias,
                                       groups=gn.num_groups)
            j = n - 2 - i
            if 0 <= j < len(skips):
                h = h + skips[j].permute(0, 3, 1, 2)
        fc = self.decoder.final_conv
        return torch.tanh(layers.conv2d(h, fc.weight, fc.bias)).permute(0, 2, 3, 1)

    @staticmethod
    def reparameterize(mu: torch.Tensor, logvar: torch.Tensor,
                       generator: Optional[torch.Generator] = None
                       ) -> torch.Tensor:
        """z = mu + eps * exp(0.5 logvar), eps drawn in f32 from
        `generator` (lunar_generate.py:248-261)."""
        std = torch.exp(0.5 * logvar.float())
        eps = torch.randn(mu.shape, generator=generator, device=mu.device,
                          dtype=torch.float32)
        return (mu.float() + eps * std).to(mu.dtype)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                sample_posterior: bool = True):
        """(recon [B, H, W, 3], mu, logvar) (lunar_generate.py:263-276)."""
        mu, logvar, skips = self.encode(x)
        z = self.reparameterize(mu, logvar, generator) if sample_posterior else mu
        return self.decode(z, skips), mu, logvar

    def sample(self, num_samples: int, generator: torch.Generator, *,
               temperature: float = 1.0,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """Decode N(0, I) * temperature latents with no skips
        (lunar_generate.py:278-291)."""
        device = self.decoder.fc.weight.device
        z = torch.randn(num_samples, self.cfg.latent_dim, generator=generator,
                        device=device, dtype=dtype) * temperature
        return self.decode(z)
