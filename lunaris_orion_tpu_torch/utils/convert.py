"""Weights between the JAX package and the port, with numpy only
(counterpart: lunaris_orion_tpu/utils/torch_compat.py, reverse direction).

The port's modules carry the PyTorch reference's parameter names, so a
reference checkpoint (or one written by `lunaris-convert to-torch`) loads
into them as it is. These converters take the JAX package's parameter
trees (as numpy arrays) to the same state_dict layout:

  HWIO conv weight            -> [O, I, kh, kw]
  dilated-conv HWIO weight    -> ConvTranspose2d [I, O, kh, kw], unflipped
  linear [I, O]               -> [O, I]
  NHWC bottleneck order       -> the reference's (C, H, W) order
  stacked expert axis [E, ...] -> experts.{e}.*, quality_heads.{e}.*
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from lunaris_orion_tpu.config import TeacherConfig, TrainConfig, VAEConfig
from lunaris_orion_tpu.utils.torch_compat import train_config_from_reference_args


def _f32(x) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x, np.float32))


def _conv(out: Dict, prefix: str, p: Mapping) -> None:
    out[f"{prefix}.weight"] = _f32(p["w"]).transpose(3, 2, 0, 1)
    out[f"{prefix}.bias"] = _f32(p["b"])


def _convT(out: Dict, prefix: str, p: Mapping) -> None:
    out[f"{prefix}.weight"] = _f32(p["w"])[::-1, ::-1].transpose(2, 3, 0, 1)
    out[f"{prefix}.bias"] = _f32(p["b"])


def _linear(out: Dict, prefix: str, p: Mapping) -> None:
    out[f"{prefix}.weight"] = _f32(p["w"]).T
    out[f"{prefix}.bias"] = _f32(p["b"])


def _norm(out: Dict, prefix: str, p: Mapping) -> None:
    out[f"{prefix}.weight"] = _f32(p["scale"])
    out[f"{prefix}.bias"] = _f32(p["bias"])


def _cbn(out: Dict, conv: str, bn: str, p: Mapping, s: Mapping) -> None:
    _conv(out, conv, p["conv"])
    _norm(out, bn, p["bn"])
    out[f"{bn}.running_mean"] = _f32(s["bn"]["mean"])
    out[f"{bn}.running_var"] = _f32(s["bn"]["var"])
    out[f"{bn}.num_batches_tracked"] = np.asarray(0, np.int64)


def _mlp(out: Dict, prefix: str, p: Mapping) -> None:
    if "ln" in p:
        _norm(out, f"{prefix}.2", p["ln"])
        _linear(out, f"{prefix}.3", p["fc1"])
        _linear(out, f"{prefix}.6", p["fc2"])
    else:
        _linear(out, f"{prefix}.2", p["fc1"])
        _linear(out, f"{prefix}.5", p["fc2"])


def _index(tree, e: int):
    """Slice expert e out of a tree of stacked [E, ...] leaves."""
    if isinstance(tree, Mapping):
        return {k: _index(v, e) for k, v in tree.items()}
    return np.asarray(tree)[e]


def _to_torch(sd: Dict) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v, order="C")) for k, v in sd.items()}


def vae_state_dict_from_jax(params: Mapping, cfg: VAEConfig
                            ) -> Dict[str, torch.Tensor]:
    """JAX `vae.init` tree -> the port's (the reference's) state_dict."""
    out: Dict = {}
    enc, dec = params["encoder"], params["decoder"]
    c, hw = cfg.channels[-1], cfg.bottleneck_hw
    for i in range(cfg.num_down):
        t, blk = f"encoder.down{i + 1}", enc[f"down{i}"]
        _conv(out, f"{t}.0", blk["conv"])
        _norm(out, f"{t}.1", blk["gn"])
        res = blk["res"]
        _conv(out, f"{t}.3.conv1.0", res["conv1"])
        _norm(out, f"{t}.3.conv1.1", res["gn1"])
        _conv(out, f"{t}.3.conv2.0", res["conv2"])
        _norm(out, f"{t}.3.conv2.1", res["gn2"])
        if "shortcut" in res:
            _conv(out, f"{t}.3.shortcut", res["shortcut"])
    for name in ("fc_mu", "fc_logvar"):
        w = _f32(enc[name]["w"]).reshape(hw, hw, c, -1).transpose(2, 0, 1, 3)
        _linear(out, f"encoder.{name}",
                {"w": w.reshape(c * hw * hw, -1), "b": enc[name]["b"]})
    wfc = _f32(dec["fc"]["w"]).reshape(-1, hw, hw, c).transpose(0, 3, 1, 2)
    bfc = _f32(dec["fc"]["b"]).reshape(hw, hw, c).transpose(2, 0, 1)
    _linear(out, "decoder.fc", {"w": wfc.reshape(-1, c * hw * hw),
                                "b": bfc.reshape(-1)})
    for i in range(cfg.num_down):
        up = dec[f"up{i}"]
        _convT(out, f"decoder.up{i + 1}.0", up["conv"])
        _norm(out, f"decoder.up{i + 1}.1", up["gn"])
    _conv(out, "decoder.final_conv", dec["final"])
    return _to_torch(out)


def teacher_state_dict_from_jax(params: Mapping, stats: Mapping,
                                cfg: TeacherConfig
                                ) -> Dict[str, torch.Tensor]:
    """JAX `teacher.init` trees (params, batch_stats) -> the port's (the
    reference's) state_dict, with the expert axis unstacked."""
    out: Dict = {}
    fx = "feature_extractor"
    ep, es = params["extractor"], stats["extractor"]
    _cbn(out, f"{fx}.conv1.0", f"{fx}.conv1.2", ep["conv1"], es["conv1"])
    for name in ("edge", "color", "detail"):
        br = f"{fx}.{name}_branch"
        _conv(out, f"{br}.0", ep[name]["dw"])
        _cbn(out, f"{br}.1", f"{br}.3", ep[name], es[name])
    _cbn(out, f"{fx}.fusion.0", f"{fx}.fusion.2", ep["fusion"], es["fusion"])

    for e in range(cfg.num_experts):
        for li in range(cfg.expert_layers):
            bp = _index(params["experts"][f"layer{li}"], e)
            bs = _index(stats["experts"][f"layer{li}"], e)
            t = f"experts.{e}.{li}"
            out[f"{t}.layer_scale"] = _f32(bp["layer_scale"]).reshape(1, -1, 1, 1)
            _cbn(out, f"{t}.conv1.0", f"{t}.conv1.2", bp["conv1"], bs["conv1"])
            attn = bp["attn"]
            out[f"{t}.attention.rel_pos_h"] = _f32(attn["rel_pos_h"])[None, :, :, None]
            out[f"{t}.attention.rel_pos_w"] = _f32(attn["rel_pos_w"])[None, :, None, :]
            out[f"{t}.attention.last_spatial_shapes"] = np.zeros(2, np.float32)
            _conv(out, f"{t}.attention.qkv", attn["qkv"])
            _conv(out, f"{t}.attention.proj", attn["proj"])
            _cbn(out, f"{t}.conv2.0", f"{t}.conv2.2", bp["conv2"], bs["conv2"])
            if "shortcut" in bp:
                _cbn(out, f"{t}.shortcut.0", f"{t}.shortcut.1",
                     bp["shortcut"], bs["shortcut"])

    _mlp(out, "gate", params["gate"])
    for e in range(cfg.num_experts):
        _mlp(out, f"quality_heads.{e}", _index(params["quality_heads"], e))
    _mlp(out, "semantic_head", params["semantic_head"])
    _mlp(out, "style_net", params["style_net"])
    _mlp(out, "prompt_net", params["prompt_net"])
    return _to_torch(out)


def load_reference_checkpoint(path: str, config: Optional[TrainConfig] = None
                              ) -> Tuple[TrainConfig, Dict]:
    """torch.load a reference-layout checkpoint (train_hybrid.py:594-615:
    vae_state_dict, teacher_state_dict, global_step, args) onto the CPU.

    Returns (cfg, ckpt): cfg from `config`, else from the checkpoint's own
    vars(args) snapshot, else the defaults. The reference attention's
    `rel_pos_cache` buffers (present once a forward has filled them) are a
    cache of values the port recomputes, and are dropped."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    for key in ("vae_state_dict", "teacher_state_dict"):
        if key not in ckpt:
            raise KeyError(f"{path}: no {key!r} (a reference training "
                           "checkpoint holds both models)")
    ckpt["teacher_state_dict"] = {
        k: v for k, v in ckpt["teacher_state_dict"].items()
        if not k.endswith("rel_pos_cache")}
    cfg = config or (train_config_from_reference_args(ckpt["args"])
                     if "args" in ckpt else TrainConfig())
    return cfg, ckpt
