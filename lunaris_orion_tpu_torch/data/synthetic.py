"""Synthetic dataset writer for tests and smoke runs (the port's own copy
of lunaris_orion_tpu/data/synthetic.py: the same bytes and the same CSV
for the same arguments).

Writes the on-disk contract that SpriteDataset reads (sprites_*.npy uint8
(N, H, W, 3) + labels_*.csv with the 8 columns of generate.py:887-896):
blocky random-palette sprites, not diffusion output.
"""

from __future__ import annotations

import csv
from pathlib import Path

import numpy as np

from lunaris_orion_tpu_torch.data.dataset import LABEL_COLUMNS

_CATEGORIES = ("character", "monster", "item", "environment", "weapon",
               "food", "vehicle", "building", "nature", "effect")


def make_sprites(n: int, image_size: int = 128, *, seed: int = 0,
                 pixel_size: int = 8) -> np.ndarray:
    """Blocky random-palette sprites, uint8 [n, s, s, 3]."""
    rng = np.random.default_rng(seed)
    small = image_size // pixel_size
    palettes = rng.integers(0, 256, (n, 8, 3), dtype=np.uint8)
    idx = rng.integers(0, 8, (n, small, small))
    imgs = np.take_along_axis(
        palettes[:, :, None, None, :],
        idx[:, None, :, :, None], axis=1)[:, 0]
    return np.repeat(np.repeat(imgs, pixel_size, 1), pixel_size, 2)


def write_synthetic_dataset(data_dir: str, n: int, *, image_size: int = 128,
                            seed: int = 0, shards: int = 1) -> Path:
    """Writes `shards` sprite shards + matching labels CSVs; returns the dir."""
    out = Path(data_dir)
    out.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed + 1)
    per = [n // shards + (1 if i < n % shards else 0) for i in range(shards)]
    gid = 0
    for si, cnt in enumerate(per):
        sprites = make_sprites(cnt, image_size, seed=seed + si)
        np.save(out / f"sprites_synth_batch{si}.npy", sprites)
        with open(out / f"labels_synth_batch{si}.csv", "w", newline="") as f:
            wr = csv.DictWriter(f, fieldnames=list(LABEL_COLUMNS))
            wr.writeheader()
            for j in range(cnt):
                cat = _CATEGORIES[int(rng.integers(len(_CATEGORIES)))]
                wr.writerow({
                    "filename": f"synth_{gid:06d}.png",
                    "category": cat,
                    "prompt": f"[CATEGORY]{cat}[STYLE]synthetic[END]",
                    "seed": int(rng.integers(2**31)),
                    "pixel_size": 8,
                    "guidance_scale": 7.0,
                    "pag_scale": 3.0,
                    "num_steps": 25,
                })
                gid += 1
    return out
