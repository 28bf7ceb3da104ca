"""Evaluation CLI of the port -- the flags of `lunaris-evaluate`
(lunaris_orion_tpu/cli/evaluate.py): --checkpoint --input --output
--batch_size --best --device --attn_window --bf16.

    python -m lunaris_orion_tpu_torch.cli.evaluate --checkpoint latest.pt \
        --input generated --output scores.json

--device defaults to cuda and raises without a card; --device cpu runs the
kernels' plain PyTorch versions on the CPU.
"""

from __future__ import annotations

import argparse
import json


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Score images with the MoE quality teacher (PyTorch port)")
    p.add_argument("--checkpoint", type=str, required=True,
                   help="reference-layout .pt checkpoint, or the port "
                        "trainer's checkpoint directory (its latest step)")
    p.add_argument("--input", type=str, required=True,
                   help="directory of PNGs and/or sprites_*.npy shards")
    p.add_argument("--output", type=str, default=None,
                   help="write scores JSON here (default: stdout summary)")
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--best", action="store_true",
                   help="load the best slot (best.pt) of the checkpoint "
                        "directory")
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (default; fails without a card) or 'cpu'")
    p.add_argument("--attn_window", type=int, default=None,
                   help="teacher attention window in tokens for scoring "
                        "(local-window attention, a stated deviation from "
                        "global attention; 0 = global). Default: the "
                        "checkpoint's setting. A PNG shape the window cannot "
                        "tile is scored with global attention and marked "
                        "attn_mode 'global-fallback'")
    p.add_argument("--bf16", action="store_true",
                   help="score with bf16 activations (fast mode; default "
                        "full f32)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from lunaris_orion_tpu_torch.infer.evaluator import QualityEvaluator

    ev = QualityEvaluator(args.checkpoint, best=args.best,
                          attn_window=args.attn_window, bf16=args.bf16,
                          device=args.device)
    results = ev.score_directory(args.input, batch_size=args.batch_size)
    if args.output:
        with open(args.output, "w") as f:
            json.dump(results, f, indent=2)
    if results:
        import numpy as np
        mean_q = float(np.mean([r["mean_quality"] for r in results.values()]))
        print(f"Scored {len(results)} images: mean quality {mean_q:.4f}"
              + (f"; wrote {args.output}" if args.output else ""))
    else:
        print("No images found.")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
