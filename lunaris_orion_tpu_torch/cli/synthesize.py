"""Dataset-synthesis CLI of the port -- the flags of `lunaris-synthesize`
(lunaris_orion_tpu/cli/synthesize.py; the reference's generate.py main
loop, generate.py:906-971): prompts -> an image backend -> pixelation ->
sprites_*.npy + labels_*.csv, which `data.dataset` reads.

    python -m lunaris_orion_tpu_torch.cli.synthesize --output_dir dataset \
        --total 2000
"""

from __future__ import annotations

import argparse
import logging


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Synthesize a sprite dataset (PyTorch port)")
    p.add_argument("--output_dir", type=str, default="dataset")
    p.add_argument("--total", type=int, default=2000)
    p.add_argument("--batch_size", type=int, default=25)
    p.add_argument("--image_size", type=int, default=128)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--backend", choices=["procedural", "diffusers"],
                   default="procedural",
                   help="'diffusers' needs downloadable Sana weights")
    p.add_argument("--model_id", type=str,
                   default="Efficient-Large-Model/Sana_600M_512px_diffusers")
    p.add_argument("--no_pngs", action="store_true",
                   help="skip per-image PNGs, write only npy/csv")
    return p


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO)
    args = build_parser().parse_args(argv)
    from lunaris_orion_tpu_torch.data.synthesis import (DatasetSynthesizer,
                                                        DiffusersBackend,
                                                        ProceduralBackend)
    backend = (DiffusersBackend(args.model_id)
               if args.backend == "diffusers" else ProceduralBackend())
    synth = DatasetSynthesizer(args.output_dir, backend=backend,
                               image_size=args.image_size, seed=args.seed,
                               save_pngs=not args.no_pngs)
    paths = synth.run(total=args.total, batch_size=args.batch_size)
    print(f"Done: {paths}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
