"""Generation CLI of the port -- the flags of `lunaris-generate`
(lunaris_orion_tpu/cli/generate.py): --checkpoint --prompt --num_samples
--output_dir --seed --temperature --quality_threshold --max_attempts
--device --no_metadata --best --bf16.

    python -m lunaris_orion_tpu_torch.cli.generate --checkpoint latest.pt \
        --num_samples 8 --output_dir generated

--device defaults to cuda and raises without a card; --device cpu runs the
kernels' plain PyTorch versions on the CPU.
"""

from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Generate pixel art from a checkpoint (PyTorch port)")
    p.add_argument("--checkpoint", type=str, required=True,
                   help="reference-layout .pt checkpoint (the PyTorch "
                        "reference's, `lunaris-convert to-torch` output, "
                        "or the port trainer's), or the port trainer's "
                        "checkpoint directory (its latest step)")
    p.add_argument("--prompt", type=str, default="",
                   help="recorded in metadata (unconditional decoder)")
    p.add_argument("--num_samples", type=int, default=4)
    p.add_argument("--output_dir", type=str, default="generated")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--quality_threshold", type=float, default=0.7)
    p.add_argument("--max_attempts", type=int, default=5)
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (default; fails without a card) or 'cpu'")
    p.add_argument("--no_metadata", action="store_true")
    p.add_argument("--best", action="store_true",
                   help="load the best slot (best.pt) of the checkpoint "
                        "directory")
    p.add_argument("--bf16", action="store_true",
                   help="decode+score with bf16 activations (fast mode; "
                        "default full f32)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from lunaris_orion_tpu_torch.infer.generator import ImageGenerator

    gen = ImageGenerator(args.checkpoint, best=args.best, bf16=args.bf16,
                         device=args.device)
    images, metadata = gen.generate(
        args.num_samples, temperature=args.temperature,
        quality_threshold=args.quality_threshold,
        max_attempts=args.max_attempts, seed=args.seed)
    paths = gen.save_outputs(images, metadata, args.output_dir,
                             prompt=args.prompt,
                             save_metadata=not args.no_metadata)
    kept = sum(1 for m in metadata if not m.get("below_threshold"))
    print(f"Generated {len(images)} images ({kept} above threshold "
          f"{args.quality_threshold}); wrote {len(paths)} files to "
          f"{args.output_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
