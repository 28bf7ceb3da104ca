"""Image export: tensor->PNG conversion and eval comparison grids.

Reference behavior: _save_eval_samples renders <=4 original/reconstruction
pairs side by side annotated with quality & semantic scores
(train_hybrid.py:718-789); inference saves PNGs + a matplotlib-style grid
(simple_generation.py:136-218). Pure PIL here.
"""

from __future__ import annotations



import numpy as np
from PIL import Image, ImageDraw


def to_uint8(img) -> np.ndarray:
    """[-1,1] float NHWC/HWC -> uint8."""
    arr = np.asarray(img, np.float32)
    return np.clip((arr + 1.0) * 127.5, 0, 255).astype(np.uint8)


def save_png(img, path: str) -> None:
    Image.fromarray(to_uint8(img)).save(path)


def comparison_grid(originals, recons, *, quality=None, semantic=None,
                    max_rows: int = 4, pad: int = 4,
                    label_h: int = 14) -> Image.Image:
    """Rows of [original | reconstruction] with score annotations."""
    orig = to_uint8(originals)[:max_rows]
    rec = to_uint8(recons)[:max_rows]
    n, h, w = orig.shape[0], orig.shape[1], orig.shape[2]
    canvas = Image.new("RGB", (2 * w + 3 * pad, n * (h + label_h + pad) + pad),
                       (24, 24, 24))
    draw = ImageDraw.Draw(canvas)
    for i in range(n):
        y = pad + i * (h + label_h + pad)
        canvas.paste(Image.fromarray(orig[i]), (pad, y))
        canvas.paste(Image.fromarray(rec[i]), (2 * pad + w, y))
        label = "orig | recon"
        if quality is not None:
            q = np.asarray(quality)[i]
            label += f"  q={np.mean(q):.3f}"
        if semantic is not None:
            label += f"  sem={float(np.asarray(semantic)[i]):.3f}"
        draw.text((pad, y + h + 1), label, fill=(220, 220, 220))
    return canvas


def sample_grid(images, *, cols: int = 4, pad: int = 4) -> Image.Image:
    arr = to_uint8(images)
    n, h, w = arr.shape[0], arr.shape[1], arr.shape[2]
    rows = (n + cols - 1) // cols
    canvas = Image.new("RGB", (cols * (w + pad) + pad, rows * (h + pad) + pad),
                       (24, 24, 24))
    for i in range(n):
        r, c = divmod(i, cols)
        canvas.paste(Image.fromarray(arr[i]),
                     (pad + c * (w + pad), pad + r * (h + pad)))
    return canvas
