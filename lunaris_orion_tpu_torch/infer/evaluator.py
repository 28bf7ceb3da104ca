"""Teacher-based quality scoring of existing images
(counterpart: lunaris_orion_tpu/infer/evaluator.py, `lunaris-evaluate`).

Scores a directory of PNGs and `sprites*.npy` shards with the MoE teacher
of a checkpoint: per image the four quality heads, their mean, the
semantic score and the gate's expert weights.

Precision policy, the generator's: f32 (the default) is full f32, TF32 off
for convolutions and matrix products while the teacher runs (K2's f32
products are three TF32 passes each, held at f32's bars, whatever
`allow_tf32` says); bf16=True is the fast mode (bf16 activations, f32
parameters cast at each layer).

`attn_window` overrides the checkpoint's teacher attention window for
scoring (a stated deviation from global attention). A shape group whose
token count the window cannot tile is scored with global attention and its
entries are marked `attn_mode: "global-fallback"`, with a warning.
"""

from __future__ import annotations

import warnings
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from lunaris_orion_tpu_torch.config import TrainConfig
from lunaris_orion_tpu_torch.device import resolve_device
from lunaris_orion_tpu_torch.infer.generator import checkpoint_path, full_f32
from lunaris_orion_tpu_torch.models.teacher import LunarMoETeacher
from lunaris_orion_tpu_torch.ops.attention import WindowTilingError
from lunaris_orion_tpu_torch.utils.convert import load_reference_checkpoint

QUALITY_NAMES = ("edge_quality", "color_consistency", "detail", "overall")


class QualityEvaluator:
    """Loads the teacher of a reference-layout checkpoint and scores images
    on one device."""

    def __init__(self, checkpoint: str, *, best: bool = False,
                 step: Optional[int] = None,
                 config: Optional[TrainConfig] = None,
                 attn_window: Optional[int] = None, bf16: bool = False,
                 device: str = "cuda"):
        """checkpoint: a reference-layout .pt or a checkpoint directory of
        the port's trainer (`checkpoint_path`). The config comes from the
        checkpoint's vars(args) snapshot unless `config` is given.
        attn_window: the teacher attention window for scoring (0: global);
        None keeps the checkpoint's own."""
        path = checkpoint_path(checkpoint, best=best, step=step)
        self.device = resolve_device(device)
        self.cfg, ckpt = load_reference_checkpoint(str(path), config)
        if attn_window is not None:
            self.cfg = self.cfg.replace(attn_window=attn_window)
        self.tcfg = self.cfg.teacher_config()
        self.teacher = LunarMoETeacher(self.tcfg)
        self.teacher.load_state_dict(ckpt["teacher_state_dict"], strict=True)
        self.teacher.to(self.device).eval()
        self.compute_dtype = torch.bfloat16 if bf16 else torch.float32

    @torch.inference_mode()
    def _score(self, x: torch.Tensor, global_attn: bool):
        with full_f32():
            out = self.teacher(x.to(self.compute_dtype),
                               global_attn=global_attn)
        return (out["quality_scores"].float().cpu().numpy(),
                out["expert_weights"].float().cpu().numpy(),
                out["semantic_score"].float().cpu().numpy())

    def score_batch(self, images: np.ndarray, *,
                    global_attn: bool = False) -> List[Dict]:
        """images: uint8 [n, H, W, 3] or float in [-1, 1]. Per image: the
        four quality metrics, mean_quality, semantic_score and the expert
        weights. global_attn scores without the attention window (the
        fallback of `score_directory`)."""
        x = torch.from_numpy(np.ascontiguousarray(images)).to(self.device)
        if x.dtype == torch.uint8:
            x = x.float() / 127.5 - 1.0
        q, w, s = self._score(x, global_attn)
        return [{**{n: float(q[i, j]) for j, n in enumerate(QUALITY_NAMES)},
                 "mean_quality": float(q[i].mean()),
                 "semantic_score": float(s[i, 0]),
                 "expert_weights": [float(v) for v in w[i]]}
                for i in range(len(q))]

    def score_directory(self, path: str, *, batch_size: int = 64) -> Dict:
        """Scores every PNG (grouped by shape, each group in batches) and
        every `sprites*.npy` shard under `path`; keys are file names and
        `<shard>[<i>]`."""
        from PIL import Image
        p = Path(path)
        results: Dict[str, Dict] = {}
        by_shape: Dict[tuple, List] = {}
        for f in sorted(p.glob("*.png")):
            arr = np.asarray(Image.open(f).convert("RGB"), np.uint8)
            by_shape.setdefault(arr.shape, []).append((f.name, arr))

        def score_group(pairs):
            global_attn = False
            for start in range(0, len(pairs), batch_size):
                chunk = pairs[start:start + batch_size]
                imgs = np.stack([a for _, a in chunk])
                try:
                    scores = self.score_batch(imgs, global_attn=global_attn)
                except WindowTilingError as e:
                    warnings.warn(
                        f"attn_window cannot tile shape {imgs.shape[1:]} "
                        f"({e}); scoring this group with global attention "
                        "-- its scores are marked attn_mode="
                        "'global-fallback'", stacklevel=3)
                    global_attn = True
                    scores = self.score_batch(imgs, global_attn=True)
                if global_attn:
                    for s in scores:
                        s["attn_mode"] = "global-fallback"
                for (key, _), s in zip(chunk, scores):
                    results[key] = s

        for items in by_shape.values():
            score_group(items)
        for shard in sorted(p.glob("sprites*.npy")):
            arr = np.load(shard, mmap_mode="r")
            score_group([(f"{shard.name}[{i}]", arr[i])
                         for i in range(len(arr))])
        return results
