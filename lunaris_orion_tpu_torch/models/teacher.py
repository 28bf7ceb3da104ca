"""LunarMoETeacher -- Mixture-of-Experts pixel-art quality critic
(counterpart: lunaris_orion_tpu/models/teacher.py).

Parameter names are the PyTorch reference's (lunar_evaluator.py:278-462):
feature_extractor.*, experts.{e}.{layer}.*, gate, quality_heads.{e},
semantic_head, style_net, prompt_net; BatchNorm running statistics are
buffers. A reference state_dict loads with strict=True.

The experts run one after another (a loop over an nn.ModuleList); the JAX
package vmaps them. Each expert block's attention is `SpatialAttention`,
which at more than 1024 tokens runs the K2 forward. The semantic score
uses the JAX package's fix: it is conditioned on the *provided* prompt
embedding.

Images enter NHWC [B, H, W, 3], as in the JAX package; inside, activations
are channels_last NCHW (see `ops/layers.py`).

Train mode (`apply(..., train=True)`) is the JAX package's: BatchNorm
normalizes with batch statistics and the running statistics advance once
per call; with a generator, dropout runs in the extractor, the heads, the
expert blocks (Dropout2d) and the attention. With remat, each expert
block's main path (conv1 -> drop -> attention -> conv2 -> drop) runs under
`torch.utils.checkpoint`, as `jax.checkpoint` wraps it: its seeds are drawn
before it runs and its BatchNorm statistics leave it as outputs, so the
replay in the backward draws the same masks and updates nothing twice.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from lunaris_orion_tpu_torch.config import TeacherConfig
from lunaris_orion_tpu_torch.ops import layers
from lunaris_orion_tpu_torch.ops.activations import leaky_relu
from lunaris_orion_tpu_torch.ops.attention import SpatialAttention
from lunaris_orion_tpu_torch.ops.rng import device_generator, new_seed


def kaiming_out_init_(module: nn.Module, generator: torch.Generator) -> None:
    """kaiming_normal_(mode='fan_out', nonlinearity='leaky_relu', a=0.01),
    zero bias: the teacher's init (lunar_evaluator.py:399-406)."""
    w = module.weight
    gain = (2.0 / (1.0 + 0.01 ** 2)) ** 0.5
    std = gain / (w.shape[0] * w[0, 0].numel()) ** 0.5
    with torch.no_grad():
        w.normal_(0.0, std, generator=generator)
        module.bias.zero_()


@dataclass
class _Train:
    """What one train-mode call threads through the modules."""
    host: Optional[torch.Generator]   # seeds; None: no dropout
    remat: bool
    bwd: Optional[str]                # K2's backward variant
    device_gen: Optional[torch.Generator] = None  # dropout outside remat
    updates: List[Tuple[nn.BatchNorm2d, torch.Tensor, torch.Tensor]] = field(
        default_factory=list)


def _bn(bn: nn.BatchNorm2d, x: torch.Tensor, stats: Optional[list] = None
        ) -> torch.Tensor:
    """Eval: running statistics. Train (`stats` is a list): batch
    statistics; the new running statistics are appended to `stats`."""
    if stats is None:
        return layers.batch_norm(x, bn.running_mean, bn.running_var,
                                 bn.weight, bn.bias, eps=bn.eps)
    y, mean, var = layers.batch_norm_train(
        x, bn.running_mean, bn.running_var, bn.weight, bn.bias,
        momentum=bn.momentum, eps=bn.eps)
    stats += [mean, var]
    return y


class ConvLeakyBN(nn.Sequential):
    """Conv -> LeakyReLU(0.2) -> BatchNorm under Sequential indices 0/1/2."""

    def __init__(self, cin: int, cout: int, k: int):
        super().__init__(nn.Conv2d(cin, cout, k, padding=k // 2),
                         nn.LeakyReLU(0.2), nn.BatchNorm2d(cout))

    def forward(self, x: torch.Tensor, stats: Optional[list] = None
                ) -> torch.Tensor:
        conv, _, bn = self
        return _bn(bn, leaky_relu(layers.conv2d(x, conv.weight, conv.bias)),
                   stats)


class Branch(nn.Sequential):
    """Depthwise conv -> pointwise conv -> LeakyReLU -> BatchNorm
    (the extractor's edge/color/detail branches, indices 0/1/2/3)."""

    def __init__(self, stem: int, cout: int, k: int):
        super().__init__(nn.Conv2d(stem, stem, k, padding=k // 2, groups=stem),
                         nn.Conv2d(stem, cout, 1), nn.LeakyReLU(0.2),
                         nn.BatchNorm2d(cout))

    def forward(self, x: torch.Tensor, stats: Optional[list] = None
                ) -> torch.Tensor:
        dw, pw, _, bn = self
        y = layers.conv2d(x, dw.weight, dw.bias, groups=dw.groups)
        return _bn(bn, leaky_relu(layers.conv2d(y, pw.weight, pw.bias)), stats)


def _record(train: Optional[_Train], bns, stats: Optional[list]) -> None:
    """Queue the running-statistics updates of `bns`, in order."""
    if train is not None:
        train.updates += zip(bns, stats[0::2], stats[1::2])


class FeatureExtractor(nn.Module):
    """PixelArtFeatureExtractor (lunar_evaluator.py:57-112)."""

    def __init__(self, cfg: TeacherConfig):
        super().__init__()
        st, br = cfg.extractor_stem, cfg.branch_dim
        self.dropout_rate = cfg.dropout_rate
        self.conv1 = ConvLeakyBN(3, st, 3)
        self.edge_branch = Branch(st, br, 3)
        self.color_branch = Branch(st, br, 5)
        self.detail_branch = Branch(st, br, 3)
        self.fusion = ConvLeakyBN(br * 3, cfg.extractor_dim, 1)

    def forward(self, x: torch.Tensor, train: Optional[_Train] = None
                ) -> torch.Tensor:
        stats = None if train is None else []
        x = self.conv1(x, stats)
        combined = torch.cat([self.edge_branch(x, stats),
                              self.color_branch(x, stats),
                              self.detail_branch(x, stats)], dim=1)
        combined = layers.dropout(
            combined, self.dropout_rate,
            generator=None if train is None else train.device_gen)
        out = self.fusion(combined, stats)
        _record(train, [m[-1] for m in (self.conv1, self.edge_branch,
                                        self.color_branch, self.detail_branch,
                                        self.fusion)], stats)
        return out


class ExpertBlock(nn.Module):
    """conv1 -> attention -> conv2, * layer_scale, + shortcut, LeakyReLU
    (lunar_evaluator.py:234-275)."""

    def __init__(self, cin: int, cout: int, cfg: TeacherConfig):
        super().__init__()
        self.dropout_rate = cfg.dropout_rate
        self.attn_window = cfg.attn_window
        self.layer_scale = nn.Parameter(
            torch.full((1, cout, 1, 1), cfg.layer_scale_init))
        self.conv1 = ConvLeakyBN(cin, cout, 3)
        self.attention = SpatialAttention(cout, cfg.num_heads,
                                          cfg.rel_pos_size)
        self.conv2 = ConvLeakyBN(cout, cout, 3)
        self.shortcut = (nn.Sequential(nn.Conv2d(cin, cout, 1),
                                       nn.BatchNorm2d(cout))
                         if cin != cout else None)

    def _path(self, x: torch.Tensor, train: bool,
              seeds: Optional[Tuple[int, ...]], bwd: Optional[str]):
        """The main path; returns (out, *new running stats of conv1's and
        conv2's BatchNorm in train mode). seeds: (Dropout2d after conv1,
        Dropout2d after conv2, attention, projection), or None: no
        dropout."""
        stats = [] if train else None
        drop1, drop2 = ((device_generator(s, x.device) for s in seeds[:2])
                        if seeds else (None, None))
        out = layers.dropout2d(self.conv1(x, stats), self.dropout_rate,
                               generator=drop1)
        out = self.attention(out.permute(0, 2, 3, 1), window=self.attn_window,
                             dropout_rate=self.dropout_rate,
                             seeds=seeds[2:] if seeds else None,
                             bwd=bwd).permute(0, 3, 1, 2)
        out = layers.dropout2d(self.conv2(out, stats), self.dropout_rate,
                               generator=drop2)
        return (out * self.layer_scale.to(out.dtype), *(stats or ()))

    def forward(self, x: torch.Tensor, train: Optional[_Train] = None
                ) -> torch.Tensor:
        stats = None if train is None else []
        if self.shortcut is None:
            identity = x
        else:
            conv, bn = self.shortcut
            identity = _bn(bn, layers.conv2d(x, conv.weight, conv.bias), stats)
        seeds = None
        if train is not None and train.host is not None:
            seeds = tuple(new_seed(train.host) for _ in range(4))
        bwd = None if train is None else train.bwd
        if train is not None and train.remat and torch.is_grad_enabled():
            # The masks come from `seeds`, not the global RNG state.
            out, *path_stats = checkpoint(self._path, x, True, seeds, bwd,
                                          use_reentrant=False,
                                          preserve_rng_state=False)
        else:
            out, *path_stats = self._path(x, train is not None, seeds, bwd)
        if train is not None:
            bns = [self.shortcut[1]] if self.shortcut is not None else []
            _record(train, bns + [self.conv1[2], self.conv2[2]],
                    stats + path_stats)
        return leaky_relu(out + identity, 0.2)


class Head(nn.Sequential):
    """The reference's head Sequential: AdaptiveAvgPool2d, Flatten, [LayerNorm,]
    Linear, LeakyReLU, Dropout, Linear. `forward` takes pooled features
    [B, in] (the pooling happens outside, as in the JAX package) and the
    teacher's dropout rate, as the JAX package's heads do."""

    def __init__(self, cin: int, hidden: int, cout: int, *, ln: bool = True):
        mods = [nn.AdaptiveAvgPool2d(1), nn.Flatten()]
        if ln:
            mods.append(nn.LayerNorm(cin))
        mods += [nn.Linear(cin, hidden), nn.LeakyReLU(0.2), nn.Dropout(0.1),
                 nn.Linear(hidden, cout)]
        super().__init__(*mods)

    def forward(self, x: torch.Tensor, rate: float = 0.0,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        mods = list(self)[2:]
        if isinstance(mods[0], nn.LayerNorm):
            ln = mods.pop(0)
            x = layers.layer_norm(x, ln.weight, ln.bias, eps=ln.eps)
        fc1, _, _, fc2 = mods
        x = leaky_relu(layers.linear(x, fc1.weight, fc1.bias), 0.2)
        x = layers.dropout(x, rate, generator=generator)
        return layers.linear(x, fc2.weight, fc2.bias)


class LunarMoETeacher(nn.Module):
    def __init__(self, cfg: TeacherConfig):
        super().__init__()
        self.cfg = cfg
        self.feature_extractor = FeatureExtractor(cfg)
        self.experts = nn.ModuleList([
            nn.Sequential(*[ExpertBlock(
                cfg.extractor_dim if li == 0 else cfg.feature_dim,
                cfg.feature_dim, cfg) for li in range(cfg.expert_layers)])
            for _ in range(cfg.num_experts)])
        self.gate = Head(cfg.extractor_dim, cfg.intermediate_dim,
                         cfg.num_experts, ln=False)
        self.quality_heads = nn.ModuleList([
            Head(cfg.feature_dim, cfg.intermediate_dim // 4, 4)
            for _ in range(cfg.num_experts)])
        self.semantic_head = Head(cfg.feature_dim, cfg.intermediate_dim // 2, 1)
        self.style_net = Head(cfg.feature_dim, cfg.intermediate_dim // 2,
                              cfg.embedding_dim)
        self.prompt_net = Head(cfg.feature_dim, cfg.intermediate_dim // 2,
                               cfg.embedding_dim)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The JAX package's init, drawn from `generator`: kaiming fan-out
        for every conv and linear, BatchNorm/LayerNorm at ones/zeros with
        fresh running statistics, rel-pos at N(0, 0.02^2), layer_scale at
        cfg.layer_scale_init."""
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                kaiming_out_init_(m, generator)
            elif isinstance(m, (nn.BatchNorm2d, nn.LayerNorm)):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
                if isinstance(m, nn.BatchNorm2d):
                    m.reset_running_stats()
            elif isinstance(m, SpatialAttention):
                with torch.no_grad():
                    m.rel_pos_h.normal_(0.0, 0.02, generator=generator)
                    m.rel_pos_w.normal_(0.0, 0.02, generator=generator)
            elif isinstance(m, ExpertBlock):
                nn.init.constant_(m.layer_scale, self.cfg.layer_scale_init)

    def forward(self, x: torch.Tensor,
                prompt_embedding: Optional[torch.Tensor] = None, *,
                train: Optional[_Train] = None) -> Dict[str, torch.Tensor]:
        """x [B, H, W, 3] -> the output dict of the JAX package's
        `teacher.apply`: quality_scores [B, 4] (sigmoid), expert_weights
        [B, E], style_embedding / prompt_embedding [B, emb], semantic_score
        [B, 1]. Eval mode unless `train` is given (see `apply`)."""
        rate = self.cfg.dropout_rate
        gen = None if train is None else train.device_gen
        feats = self.feature_extractor(x.permute(0, 3, 1, 2), train)
        gate_logits = self.gate(layers.global_avg_pool(feats), rate, gen)
        w = torch.softmax(gate_logits.float(), dim=-1)            # [B, E]

        pooled_ex = []
        for expert in self.experts:
            h = feats
            for block in expert:
                h = block(h, train)
            pooled_ex.append(layers.global_avg_pool(h))
        pooled = torch.stack(pooled_ex)                           # [E, B, C]

        quality = torch.stack([head(p, rate, gen) for head, p in
                               zip(self.quality_heads, pooled_ex)])
        weighted = torch.einsum("ebq,be->bq", quality.float(), w)
        combined = torch.einsum("ebc,be->bc", pooled.float(), w).to(feats.dtype)
        style = self.style_net(combined, rate, gen)
        own_prompt = self.prompt_net(combined, rate, gen)
        semantic = torch.sigmoid(
            self.semantic_head(pooled_ex[0], rate, gen).float())
        if prompt_embedding is not None:
            a = own_prompt.float()
            b = prompt_embedding.detach().float()
            cos = (a * b).sum(-1) / torch.clamp(
                a.norm(dim=-1) * b.norm(dim=-1), min=1e-8)
            semantic = semantic * cos[:, None]
        return {
            "quality_scores": torch.sigmoid(weighted),
            "expert_weights": w,
            "style_embedding": style,
            "prompt_embedding": own_prompt,
            "semantic_score": semantic,
        }


def apply(model: LunarMoETeacher, x: torch.Tensor, *,
          prompt_embedding: Optional[torch.Tensor] = None,
          train: bool = False, generator: Optional[torch.Generator] = None,
          remat: bool = True, bwd: Optional[str] = None
          ) -> Dict[str, torch.Tensor]:
    """The JAX package's `teacher.apply`. train=False: the eval forward.
    train=True: BatchNorm on batch statistics, the running statistics
    advanced once (in place: the port's BatchNorm buffers are the JAX
    package's returned stats); with `generator` (a CPU torch.Generator, the
    source of every seed) dropout is on. `remat` checkpoints each expert
    block's main path when gradients are recorded. `bwd` picks K2's
    backward kernels on CUDA. Attention follows the `auto` rule."""
    if not train:
        return model(x, prompt_embedding)
    t = _Train(host=generator, remat=remat, bwd=bwd,
               device_gen=None if generator is None else device_generator(
                   new_seed(generator), x.device))
    out = model(x, prompt_embedding, train=t)
    with torch.no_grad():
        for bn, mean, var in t.updates:
            bn.running_mean.copy_(mean)
            bn.running_var.copy_(var)
            bn.num_batches_tracked += 1
    return out
