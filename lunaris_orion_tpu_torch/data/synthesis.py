"""Dataset synthesis tool — the reference's generate.py re-designed (the
port's own copy of lunaris_orion_tpu/data/synthesis.py: PIL and numpy, the
JAX copy's bytes from the same seed in one process (the procedural painter
keys on Python's string `hash`, which PYTHONHASHSEED fixes across
processes); `ops/image_ops.py` is the batched device-side pixelation).

Pipeline (generate.py:779-904): prompt engine -> image backend -> pixelation
post-process (LANCZOS downscale by pixel_size, 64-color quantize, NEAREST
upscale, :619-637) -> PNG + per-batch JSON metadata -> final export of
sprites_{ts}_batch{n}.npy stacks + labels_{ts}_batch{n}.csv with the 8
columns the trainer reads (:858-904). SIGINT-safe partial export (:906-971).

The image backend is pluggable:
  * DiffusersBackend wraps a Sana PAG pipeline when `diffusers` + weights are
    available (the reference hard-requires it, generate.py:44-52);
  * ProceduralBackend draws deterministic procedural sprites so the full
    pipeline (prompts, pixelation, export, contract) runs in hermetic/TPU
    environments with no model download.
"""

from __future__ import annotations

import json
import logging
import signal
import time
from pathlib import Path
from typing import Dict, List, Optional, Protocol

import numpy as np
from PIL import Image

from lunaris_orion_tpu_torch.data.prompts import PromptEngine, CategoryParams

logger = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# Pixelation post-process (reference generate.py:619-637)
# ---------------------------------------------------------------------------

def pixelate_image(img: Image.Image, pixel_size: int,
                   num_colors: int = 64) -> Image.Image:
    """LANCZOS downscale by pixel_size -> palette quantize -> NEAREST upscale."""
    w, h = img.size
    small = img.resize((max(w // pixel_size, 1), max(h // pixel_size, 1)),
                       Image.LANCZOS)
    small = small.quantize(colors=num_colors, method=Image.MEDIANCUT)
    small = small.convert("RGB")
    return small.resize((w, h), Image.NEAREST)


# ---------------------------------------------------------------------------
# Image backends
# ---------------------------------------------------------------------------

class ImageBackend(Protocol):
    def generate(self, prompt: str, *, seed: int, params: CategoryParams,
                 image_size: int) -> Image.Image: ...


class ProceduralBackend:
    """Deterministic procedural sprite painter keyed on (prompt, seed).

    Draws symmetric blob sprites with category-dependent palettes — enough
    structure for the teacher/VAE pipeline to have signal, zero deps.
    """

    def generate(self, prompt: str, *, seed: int, params: CategoryParams,
                 image_size: int) -> Image.Image:
        rng = np.random.default_rng((hash(prompt) & 0x7FFFFFFF, seed))
        g = image_size // params.pixel_size
        palette = rng.integers(32, 256, (6, 3))
        bg = rng.integers(0, 48, (3,))
        half = rng.integers(0, 6, (g, (g + 1) // 2))
        mask_half = rng.random((g, (g + 1) // 2)) < 0.55
        grid_idx = np.concatenate(
            [half, half[:, : g // 2][:, ::-1]], axis=1)  # mirror symmetry
        mask = np.concatenate(
            [mask_half, mask_half[:, : g // 2][:, ::-1]], axis=1)
        # hollow out corners for a sprite-ish silhouette
        yy, xx = np.mgrid[0:g, 0:g]
        r = ((yy - g / 2) ** 2 + (xx - g / 2) ** 2) ** 0.5
        mask &= r < g * (0.35 + 0.2 * rng.random())
        img = np.where(mask[..., None], palette[grid_idx], bg[None, None])
        img = np.repeat(np.repeat(img, params.pixel_size, 0),
                        params.pixel_size, 1).astype(np.uint8)
        return Image.fromarray(img)


class DiffusersBackend:
    """Sana PAG diffusion backend (reference generate.py:44-52). Optional:
    requires `diffusers` and downloadable weights."""

    def __init__(self, model_id: str = "Efficient-Large-Model/Sana_600M_512px_diffusers",
                 device: str = "cuda"):
        try:
            import torch
            from diffusers import SanaPAGPipeline
        except ImportError as e:  # pragma: no cover
            raise RuntimeError(
                "diffusers backend unavailable; use ProceduralBackend") from e
        self._torch = torch
        self.pipe = SanaPAGPipeline.from_pretrained(
            model_id, torch_dtype=torch.bfloat16).to(device)
        self.device = device

    def generate(self, prompt: str, *, seed: int, params: CategoryParams,
                 image_size: int) -> Image.Image:  # pragma: no cover
        gen = self._torch.Generator(self.device).manual_seed(seed)
        out = self.pipe(
            prompt=prompt, height=image_size, width=image_size,
            guidance_scale=params.guidance_scale,
            pag_scale=params.pag_scale,
            num_inference_steps=params.num_steps,
            generator=gen)
        return out.images[0].resize((image_size, image_size), Image.LANCZOS)


# ---------------------------------------------------------------------------
# The synthesis loop
# ---------------------------------------------------------------------------

class DatasetSynthesizer:
    def __init__(self, output_dir: str, *, backend: Optional[ImageBackend] = None,
                 image_size: int = 128, seed: Optional[int] = None,
                 save_pngs: bool = True):
        self.out = Path(output_dir)
        self.out.mkdir(parents=True, exist_ok=True)
        if save_pngs:
            (self.out / "images").mkdir(exist_ok=True)
        self.backend = backend or ProceduralBackend()
        self.image_size = image_size
        self.engine = PromptEngine(seed)
        self.rng = np.random.default_rng(seed)
        self.save_pngs = save_pngs
        self.sprites: List[np.ndarray] = []
        self.records: List[Dict] = []
        self.batch_num = 0
        self._stop = False

    def _handle_sigint(self, signum, frame):
        logger.warning("SIGINT: exporting partial dataset...")
        self._stop = True

    def generate_batch(self, batch_size: int = 25,
                       category: Optional[str] = None) -> int:
        """One batch: prompts -> backend -> pixelate -> accumulate.
        Returns images produced."""
        made = 0
        for _ in range(batch_size):
            if self._stop:
                break
            prompt, cat = self.engine.unique_prompt(category)
            params = self.engine.params_for(cat)
            seed = int(self.rng.integers(2 ** 31))
            img = self.backend.generate(prompt, seed=seed, params=params,
                                        image_size=self.image_size)
            img = pixelate_image(img, params.pixel_size)
            arr = np.asarray(img, np.uint8)
            idx = len(self.records)
            fname = f"sprite_{idx:06d}.png"
            if self.save_pngs:
                img.save(self.out / "images" / fname)
            self.sprites.append(arr)
            self.records.append({
                "filename": fname,
                "category": cat,
                "prompt": prompt,
                "seed": seed,
                "pixel_size": params.pixel_size,
                "guidance_scale": params.guidance_scale,
                "pag_scale": params.pag_scale,
                "num_steps": params.num_steps,
            })
            made += 1
        # per-batch metadata JSON (generate.py:812-856)
        meta_path = self.out / f"metadata_batch{self.batch_num}.json"
        meta_path.write_text(json.dumps(
            self.records[-made:] if made else [], indent=2))
        self.batch_num += 1
        return made

    def export(self, *, tag: Optional[str] = None) -> Dict[str, str]:
        """Final export: sprites_{ts}_batch{n}.npy + labels_{ts}_batch{n}.csv
        (generate.py:858-904)."""
        import csv
        if not self.sprites:
            return {}
        ts = tag or time.strftime("%Y%m%d_%H%M%S")
        spath = self.out / f"sprites_{ts}_batch{self.batch_num}.npy"
        lpath = self.out / f"labels_{ts}_batch{self.batch_num}.csv"
        np.save(spath, np.stack(self.sprites))
        with open(lpath, "w", newline="") as f:
            wr = csv.DictWriter(f, fieldnames=list(self.records[0].keys()))
            wr.writeheader()
            wr.writerows(self.records)
        logger.info("Exported %d sprites -> %s / %s",
                    len(self.sprites), spath.name, lpath.name)
        return {"sprites": str(spath), "labels": str(lpath)}

    def run(self, total: int = 2000, batch_size: int = 25) -> Dict[str, str]:
        """Batches rotating through categories, SIGINT-safe
        (generate.py:906-971)."""
        from lunaris_orion_tpu_torch.data.prompts import CATEGORY_WEIGHTS
        cats = list(CATEGORY_WEIGHTS)
        old = signal.signal(signal.SIGINT, self._handle_sigint)
        try:
            i = 0
            while len(self.records) < total and not self._stop:
                cat = cats[i % len(cats)]
                n = min(batch_size, total - len(self.records))
                self.generate_batch(n, category=cat)
                i += 1
                if i % 4 == 0:
                    logger.info("Synthesized %d/%d", len(self.records), total)
            return self.export()
        finally:
            signal.signal(signal.SIGINT, old)
