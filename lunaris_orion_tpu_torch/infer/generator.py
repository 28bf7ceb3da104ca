"""Checkpoint-driven generation with quality-threshold rejection sampling
(counterpart: lunaris_orion_tpu/infer/generator.py).

Draw z ~ N(0, I) * temperature, decode it with the VAE, score the images
with the teacher, keep those whose mean quality reaches the threshold, and
retry up to max_attempts rounds; slots still empty are filled with the
best-scoring rejects. Outputs: PNGs named with their scores, a grid image
and JSON metadata.

Precision policy. f32 (the default) is full f32, as the JAX package's f32
scoring is: TF32 is turned off for convolutions and matrix products while
decode+score runs. K2's f32 products run on the tensor cores as three TF32
passes each, held at f32's bars, whatever `allow_tf32` says (the flags
govern PyTorch's own operators only). bf16=True is the fast mode: z and the
activations are bf16, the parameters stay f32 and are cast at each layer,
and norm statistics and the attention's softmax stay f32, as in the JAX
package.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from lunaris_orion_tpu_torch.config import TrainConfig
from lunaris_orion_tpu_torch.utils.image import sample_grid, save_png, to_uint8
from lunaris_orion_tpu_torch.device import full_f32, resolve_device
from lunaris_orion_tpu_torch.models.teacher import LunarMoETeacher
from lunaris_orion_tpu_torch.models.vae import LunarisCoreVAE
from lunaris_orion_tpu_torch.train.checkpoint import checkpoint_file
from lunaris_orion_tpu_torch.utils.convert import load_reference_checkpoint


def checkpoint_path(checkpoint: str, *, best: bool = False,
                    step: Optional[int] = None) -> Path:
    """The .pt that `checkpoint` names: the file itself, or from a
    checkpoint directory of the port's `CheckpointService` its latest step,
    `step`, or with `best` its best slot. An Orbax directory of the JAX
    package raises, naming the conversion."""
    if str(checkpoint).endswith(".pt"):
        if best or step is not None:
            raise ValueError("best= and step= select a checkpoint in a "
                             "directory; a .pt file is a single checkpoint")
        return Path(checkpoint)
    path = checkpoint_file(str(checkpoint), best=best, step=step)
    if path is None:
        raise ValueError(
            f"{checkpoint}: no {'best.pt' if best else 'steps/*.pt'} of the "
            "port's trainer here. Convert an Orbax checkpoint directory with "
            "the JAX package first: lunaris-convert to-torch --checkpoint "
            "<dir> --out latest.pt")
    return path


class ImageGenerator:
    """Loads a reference-layout checkpoint and generates quality-filtered
    sprites on one device."""

    def __init__(self, checkpoint: str, *, config: Optional[TrainConfig] = None,
                 bf16: bool = False, device: str = "cuda", best: bool = False,
                 step: Optional[int] = None):
        """checkpoint: a reference-layout .pt (train_hybrid.py:594-615), as
        the PyTorch reference, `lunaris-convert to-torch` or the port's
        trainer writes it, or a checkpoint directory of the port's
        `CheckpointService`: its latest step, `step`, or with `best` its
        best slot. The model config comes from the checkpoint's vars(args)
        snapshot unless `config` is given. An Orbax directory of the JAX
        package cannot be read here: convert it to a .pt first."""
        path = checkpoint_path(checkpoint, best=best, step=step)
        self.device = resolve_device(device)
        self.cfg, ckpt = load_reference_checkpoint(str(path), config)
        self.vcfg = self.cfg.vae_config()
        self.tcfg = self.cfg.teacher_config()
        self.step = int(ckpt.get("global_step", 0))
        self.vae = LunarisCoreVAE(self.vcfg)
        self.vae.load_state_dict(ckpt["vae_state_dict"], strict=True)
        self.teacher = LunarMoETeacher(self.tcfg)
        self.teacher.load_state_dict(ckpt["teacher_state_dict"], strict=True)
        self.vae.to(self.device).eval()
        self.teacher.to(self.device).eval()
        self.compute_dtype = torch.bfloat16 if bf16 else torch.float32

    @torch.inference_mode()
    def decode_and_score(self, z: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """z [B, latent] -> (images f32 [B, H, W, 3] in [-1, 1], mean
        quality [B] f32, semantic score [B] f32)."""
        with full_f32():
            imgs = self.vae.decode(z.to(self.compute_dtype))
            out = self.teacher(imgs)
        quality = out["quality_scores"].float().mean(dim=-1)
        sem = out["semantic_score"][:, 0].float()
        return imgs.float(), quality, sem

    def generate(self, num_samples: int = 4, *, temperature: float = 1.0,
                 quality_threshold: float = 0.7, max_attempts: int = 5,
                 seed: Optional[int] = None) -> Tuple[np.ndarray, List[Dict]]:
        """Returns (images uint8 [n, H, W, 3], per-image metadata).

        z comes from a torch.Generator on the device seeded with `seed`
        (time-based when None). torch draws other numbers than jax.random
        from the same seed, so a seed does not reproduce the JAX package's
        images."""
        g = torch.Generator(device=self.device)
        g.manual_seed(seed if seed is not None else time.time_ns() % 2**31)
        kept_imgs: List[np.ndarray] = []
        kept_meta: List[Dict] = []
        fallback: List[Tuple[float, np.ndarray, Dict]] = []

        for attempt in range(max_attempts):
            z = torch.randn(num_samples, self.vcfg.latent_dim, generator=g,
                            device=self.device) * temperature
            imgs, quality, sem = self.decode_and_score(z)
            imgs_np = to_uint8(imgs.cpu().numpy())
            q_np = quality.cpu().numpy()
            s_np = sem.cpu().numpy()
            for i in range(num_samples):
                meta = {"quality": float(q_np[i]),
                        "semantic": float(s_np[i]),
                        "temperature": temperature,
                        "attempt": attempt,
                        "checkpoint_step": self.step}
                if q_np[i] >= quality_threshold and len(kept_imgs) < num_samples:
                    kept_imgs.append(imgs_np[i])
                    kept_meta.append(meta)
                else:
                    fallback.append((float(q_np[i]), imgs_np[i], meta))
            if len(kept_imgs) >= num_samples:
                break

        if len(kept_imgs) < num_samples and fallback:
            fallback.sort(key=lambda t: -t[0])
            for _, img, meta in fallback[:num_samples - len(kept_imgs)]:
                kept_imgs.append(img)
                kept_meta.append(dict(meta, below_threshold=True))
        return np.stack(kept_imgs), kept_meta

    def save_outputs(self, images: np.ndarray, metadata: List[Dict],
                     output_dir: str, *, prompt: str = "",
                     save_metadata: bool = True) -> List[Path]:
        """PNGs named with their scores + grid + metadata JSON."""
        out = Path(output_dir)
        out.mkdir(parents=True, exist_ok=True)
        ts = int(time.time())
        paths = []
        for i, (img, meta) in enumerate(zip(images, metadata)):
            p = out / f"sample_{ts}_{i}_q{meta['quality']:.3f}.png"
            save_png(img.astype(np.float32) / 127.5 - 1.0, p)
            paths.append(p)
        grid_path = out / f"grid_{ts}.png"
        sample_grid(images.astype(np.float32) / 127.5 - 1.0).save(grid_path)
        paths.append(grid_path)
        if save_metadata:
            meta_path = out / f"metadata_{ts}.json"
            meta_path.write_text(json.dumps(
                {"prompt": prompt, "generated_at": ts, "samples": metadata},
                indent=2))
            paths.append(meta_path)
        return paths
