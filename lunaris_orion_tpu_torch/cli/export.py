"""Export CLI of the port -- the flags of `lunaris-export`
(lunaris_orion_tpu/cli/export.py), over torch.export: a serving bundle of
the decode+score (`generate`) and teacher-scoring (`score`) programs with
the checkpoint's weights stored once in weights.bin, loadable by
`infer.exporter.ServingBundle` with no model code.

    python -m lunaris_orion_tpu_torch.cli.export --checkpoint latest.pt \
        --out bundle --batch 8 16 --bf16

--attn cuda (the default) exports programs that launch the hand-written
kernels through their torch.library operators, for the card only; --attn
plain exports the kernels' plain twins for each device of --platforms.
--device defaults to cuda and raises without a card.
"""

from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Export serving programs (torch.export) from a "
                    "checkpoint (PyTorch port)")
    p.add_argument("--checkpoint", type=str, required=True,
                   help="reference-layout .pt, or the port trainer's "
                        "checkpoint directory (its latest step)")
    p.add_argument("--out", type=str, required=True,
                   help="output bundle directory")
    p.add_argument("--batch", type=int, nargs="+", default=[16],
                   help="serving batch size(s); one program per size "
                        "(shapes are static -- the bundle dispatches on the "
                        "input's leading dim)")
    p.add_argument("--functions", type=str, nargs="+",
                   default=["generate", "score"],
                   choices=["generate", "score"],
                   help="which entry points to export")
    p.add_argument("--best", action="store_true",
                   help="export the best slot (best.pt) of the directory")
    p.add_argument("--bf16", action="store_true",
                   help="bf16 activations in the programs (default f32, "
                        "with TF32 off at every call)")
    p.add_argument("--attn", type=str, default="cuda",
                   choices=["cuda", "plain"],
                   help="'cuda' = the programs launch K1 and the K2 forward "
                        "through their torch.library operators (CUDA only; "
                        "loading needs lunaris_orion_tpu_torch.ops.library); "
                        "'plain' = the kernels' plain twins, any device, "
                        "torch alone (slow references)")
    p.add_argument("--platforms", type=str, default=None,
                   help="comma-separated devices to export a plain program "
                        "for, e.g. 'cuda,cpu' (default: --device)")
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (default; fails without a card) or 'cpu'")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from lunaris_orion_tpu_torch.infer.exporter import export_serving_bundle

    platforms = args.platforms.split(",") if args.platforms else None
    manifest = export_serving_bundle(
        args.checkpoint, args.out, batch_sizes=args.batch,
        functions=args.functions, best=args.best, bf16=args.bf16,
        attn=args.attn, platforms=platforms, device=args.device)
    names = ", ".join(sorted(manifest["functions"]))
    print(f"Exported {len(manifest['functions'])} program(s) to "
          f"{args.out}: {names} (step {manifest['checkpoint_step']}, "
          f"attn={manifest['attn']})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
