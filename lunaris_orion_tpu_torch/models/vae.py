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

Under tensor parallelism (`tp`, the model axis; `parallel/sharding.py`)
the rank holds the latent columns [m L/M, (m+1) L/M) of fc_mu and
fc_logvar and the same latent rows of decoder.fc: the bottleneck features
enter through `sum_entry`, mu, logvar and z are this rank's columns, and
decoder.fc's partial output leaves through `sum_exit` before its bias.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from lunaris_orion_tpu_torch.config import VAEConfig
from lunaris_orion_tpu_torch.ops import layers
from lunaris_orion_tpu_torch.ops.activations import mish
from lunaris_orion_tpu_torch.parallel.collectives import sum_entry, sum_exit
from lunaris_orion_tpu_torch.parallel.mesh import AxisGroup


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

    def _check_split(self, tp: Optional[AxisGroup]) -> None:
        """The FC pair's latent columns must be those `tp` gives a rank."""
        held = self.encoder.fc_mu.weight.shape[0]
        want = self.cfg.latent_dim // (1 if tp is None else tp.size)
        if held != want:
            raise ValueError(
                f"the VAE holds {held} of {self.cfg.latent_dim} latent "
                f"columns, a model axis of {1 if tp is None else tp.size} "
                "gives each rank "
                f"{want} (parallel.sharding.shard_state cuts a state)")

    def encode(self, x: torch.Tensor, tp: Optional[AxisGroup] = None
               ) -> Tuple[torch.Tensor, torch.Tensor, List[torch.Tensor]]:
        """x [B, H, W, 3] in [-1, 1] -> (mu, logvar, skips [B, h, w, c]).
        Skips are taken after every down block but the last. With `tp`,
        mu and logvar are this rank's latent columns."""
        self._check_split(tp)
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
        if tp is not None:
            flat = sum_entry(flat, tp)
        mu = layers.linear(flat, self.encoder.fc_mu.weight,
                           self.encoder.fc_mu.bias)
        logvar = layers.linear(flat, self.encoder.fc_logvar.weight,
                               self.encoder.fc_logvar.bias)
        return mu, logvar, skips

    def decode(self, z: torch.Tensor, skips: Sequence[torch.Tensor] = (),
               *, plain: bool = False,
               tp: Optional[AxisGroup] = None) -> torch.Tensor:
        """z [B, latent] (+ optional encoder skips) -> [B, H, W, 3] in
        [-1, 1], in z's dtype. Skip fusion is guarded by len(skips), so the
        skip-free prior decode works (lunar_generate.py:211-224, 288-291).
        `plain` runs K1's plain version on any device (the exporter's
        portable form) instead of the kernel. With `tp`, z is this rank's
        latent columns and the output is whole on every rank."""
        cfg = self.cfg
        n, hw = cfg.num_down, cfg.bottleneck_hw
        fc = self.decoder.fc
        if tp is None:
            h = layers.linear(z, fc.weight, fc.bias)
        else:
            self._check_split(tp)
            h = sum_exit(torch.nn.functional.linear(z, fc.weight.to(z.dtype)),
                         tp) + fc.bias.to(z.dtype)
        h = h.reshape(z.shape[0], cfg.channels[-1], hw, hw).contiguous(
            memory_format=torch.channels_last)
        for i in range(n):
            blk = getattr(self.decoder, f"up{i + 1}")
            conv, gn = blk[0], blk[1]
            h = layers.conv_transpose_421(h, conv.weight, conv.bias)
            h = layers.group_norm_mish(h, gn.weight, gn.bias,
                                       groups=gn.num_groups, plain=plain)
            j = n - 2 - i
            if 0 <= j < len(skips):
                h = h + skips[j].permute(0, 3, 1, 2)
        fc = self.decoder.final_conv
        return torch.tanh(layers.conv2d(h, fc.weight, fc.bias)).permute(0, 2, 3, 1)

    @staticmethod
    def reparameterize(mu: torch.Tensor, logvar: torch.Tensor,
                       generator: Optional[torch.Generator] = None,
                       rows: Optional[AxisGroup] = None,
                       cols: Optional[AxisGroup] = None) -> torch.Tensor:
        """z = mu + eps * exp(0.5 logvar), eps drawn in f32 from
        `generator` (lunar_generate.py:248-261). `rows`: the data axis the
        batch is split over; `cols`: the model axis the latent columns are
        split over (tensor parallelism). eps is then this rank's rows and
        columns of the global draw (`layers.global_rows`)."""
        std = torch.exp(0.5 * logvar.float())
        shape, own = layers.global_rows(mu.shape, rows)
        eps = torch.randn(layers.global_cols(shape, cols),
                          generator=generator, device=mu.device,
                          dtype=torch.float32)[own]
        return (mu.float() + layers.own_cols(eps, cols) * std).to(mu.dtype)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                sample_posterior: bool = True,
                rows: Optional[AxisGroup] = None,
                tp: Optional[AxisGroup] = None):
        """(recon [B, H, W, 3], mu, logvar) (lunar_generate.py:263-276).
        `rows` as in `reparameterize`; `tp`: the model axis of tensor
        parallelism (mu and logvar are then this rank's columns, recon is
        whole)."""
        mu, logvar, skips = self.encode(x, tp)
        if not sample_posterior:
            z = mu
        elif rows is None and tp is None:
            z = self.reparameterize(mu, logvar, generator)
        else:
            z = self.reparameterize(mu, logvar, generator, rows, tp)
        return self.decode(z, skips, tp=tp), mu, logvar

    def sample(self, num_samples: int, generator: torch.Generator, *,
               temperature: float = 1.0,
               dtype: torch.dtype = torch.float32,
               tp: Optional[AxisGroup] = None) -> torch.Tensor:
        """Decode N(0, I) * temperature latents with no skips
        (lunar_generate.py:278-291). With `tp`, each rank decodes its
        columns of the same draw."""
        device = self.decoder.fc.weight.device
        z = torch.randn(num_samples, self.cfg.latent_dim, generator=generator,
                        device=device, dtype=dtype) * temperature
        return self.decode(layers.own_cols(z, tp), tp=tp)
