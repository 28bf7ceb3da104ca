"""LunarMoETeacher -- Mixture-of-Experts pixel-art quality critic, eval mode
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
are channels_last NCHW (see `ops/layers.py`). Only eval mode (train=False)
is ported.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn

from lunaris_orion_tpu.config import TeacherConfig
from lunaris_orion_tpu_torch.ops import layers
from lunaris_orion_tpu_torch.ops.activations import leaky_relu
from lunaris_orion_tpu_torch.ops.attention import SpatialAttention


def kaiming_out_init_(module: nn.Module, generator: torch.Generator) -> None:
    """kaiming_normal_(mode='fan_out', nonlinearity='leaky_relu', a=0.01),
    zero bias: the teacher's init (lunar_evaluator.py:399-406)."""
    w = module.weight
    gain = (2.0 / (1.0 + 0.01 ** 2)) ** 0.5
    std = gain / (w.shape[0] * w[0, 0].numel()) ** 0.5
    with torch.no_grad():
        w.normal_(0.0, std, generator=generator)
        module.bias.zero_()


def _bn(bn: nn.BatchNorm2d, x: torch.Tensor) -> torch.Tensor:
    return layers.batch_norm(x, bn.running_mean, bn.running_var, bn.weight,
                             bn.bias, eps=bn.eps)


class ConvLeakyBN(nn.Sequential):
    """Conv -> LeakyReLU(0.2) -> BatchNorm under Sequential indices 0/1/2."""

    def __init__(self, cin: int, cout: int, k: int):
        super().__init__(nn.Conv2d(cin, cout, k, padding=k // 2),
                         nn.LeakyReLU(0.2), nn.BatchNorm2d(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv, _, bn = self
        return _bn(bn, leaky_relu(layers.conv2d(x, conv.weight, conv.bias)))


class Branch(nn.Sequential):
    """Depthwise conv -> pointwise conv -> LeakyReLU -> BatchNorm
    (the extractor's edge/color/detail branches, indices 0/1/2/3)."""

    def __init__(self, stem: int, cout: int, k: int):
        super().__init__(nn.Conv2d(stem, stem, k, padding=k // 2, groups=stem),
                         nn.Conv2d(stem, cout, 1), nn.LeakyReLU(0.2),
                         nn.BatchNorm2d(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dw, pw, _, bn = self
        y = layers.conv2d(x, dw.weight, dw.bias, groups=dw.groups)
        return _bn(bn, leaky_relu(layers.conv2d(y, pw.weight, pw.bias)))


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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv1(x)
        combined = torch.cat([self.edge_branch(x), self.color_branch(x),
                              self.detail_branch(x)], dim=1)
        return self.fusion(layers.dropout(combined, self.dropout_rate))


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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.shortcut is None:
            identity = x
        else:
            conv, bn = self.shortcut
            identity = _bn(bn, layers.conv2d(x, conv.weight, conv.bias))
        out = layers.dropout2d(self.conv1(x), self.dropout_rate)
        out = self.attention(out.permute(0, 2, 3, 1),
                             window=self.attn_window).permute(0, 3, 1, 2)
        out = layers.dropout2d(self.conv2(out), self.dropout_rate)
        out = out * self.layer_scale.to(out.dtype)
        return leaky_relu(out + identity, 0.2)


class Head(nn.Sequential):
    """The reference's head Sequential: AdaptiveAvgPool2d, Flatten, [LayerNorm,]
    Linear, LeakyReLU, Dropout, Linear. `forward` takes pooled features
    [B, in] (the pooling happens outside, as in the JAX package)."""

    def __init__(self, cin: int, hidden: int, cout: int, *, ln: bool = True):
        mods = [nn.AdaptiveAvgPool2d(1), nn.Flatten()]
        if ln:
            mods.append(nn.LayerNorm(cin))
        mods += [nn.Linear(cin, hidden), nn.LeakyReLU(0.2), nn.Dropout(0.1),
                 nn.Linear(hidden, cout)]
        super().__init__(*mods)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mods = list(self)[2:]
        if isinstance(mods[0], nn.LayerNorm):
            ln = mods.pop(0)
            x = layers.layer_norm(x, ln.weight, ln.bias, eps=ln.eps)
        fc1, _, drop, fc2 = mods
        x = leaky_relu(layers.linear(x, fc1.weight, fc1.bias), 0.2)
        x = layers.dropout(x, drop.p)
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
                prompt_embedding: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
        """x [B, H, W, 3] -> the output dict of the JAX package's
        `teacher.apply(train=False)`: quality_scores [B, 4] (sigmoid),
        expert_weights [B, E], style_embedding / prompt_embedding
        [B, emb], semantic_score [B, 1]."""
        feats = self.feature_extractor(x.permute(0, 3, 1, 2))
        gate_logits = self.gate(layers.global_avg_pool(feats))
        w = torch.softmax(gate_logits.float(), dim=-1)            # [B, E]

        pooled_ex = []
        for expert in self.experts:
            pooled_ex.append(layers.global_avg_pool(expert(feats)))
        pooled = torch.stack(pooled_ex)                           # [E, B, C]

        quality = torch.stack([head(p) for head, p in
                               zip(self.quality_heads, pooled_ex)])
        weighted = torch.einsum("ebq,be->bq", quality.float(), w)
        combined = torch.einsum("ebc,be->bc", pooled.float(), w).to(feats.dtype)
        own_prompt = self.prompt_net(combined)
        semantic = torch.sigmoid(self.semantic_head(pooled_ex[0]).float())
        if prompt_embedding is not None:
            a = own_prompt.float()
            b = prompt_embedding.float()
            cos = (a * b).sum(-1) / torch.clamp(
                a.norm(dim=-1) * b.norm(dim=-1), min=1e-8)
            semantic = semantic * cos[:, None]
        return {
            "quality_scores": torch.sigmoid(weighted),
            "expert_weights": w,
            "style_embedding": self.style_net(combined),
            "prompt_embedding": own_prompt,
            "semantic_score": semantic,
        }


def apply(model: LunarMoETeacher, x: torch.Tensor, *,
          prompt_embedding: Optional[torch.Tensor] = None,
          train: bool = False) -> Dict[str, torch.Tensor]:
    """The JAX package's `teacher.apply` for train=False: the model's
    forward. Train mode (batch statistics, dropout) is not ported yet."""
    if train:
        raise NotImplementedError("teacher train mode is not ported yet")
    return model(x, prompt_embedding)
