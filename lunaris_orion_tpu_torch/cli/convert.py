"""Checkpoint conversion CLI of the port (counterpart:
lunaris_orion_tpu/cli/convert.py).

The port's checkpoints already are reference-layout .pt files
(`train/checkpoint.py`), so its two directions move between one .pt and a
checkpoint directory of the port's trainer:

    # Reference .pt -> a directory: `lunaris-train-torch --resume_from`,
    # `lunaris-generate-torch --checkpoint` and the exporter read it
    lunaris-convert-torch to-port --checkpoint latest.pt --out run/checkpoints

    # A directory's latest step (or --step, or --best) -> one .pt without
    # the port's own keys (baseline, baseline_initialized,
    # generator_state): what the reference trainer and `lunaris-convert
    # to-jax` read
    lunaris-convert-torch to-torch --checkpoint run/checkpoints --out latest.pt

`to-port` writes the checkpoint's tensors as they are, under
steps/<global_step>.pt (and best.pt with --best), and config.json from
the checkpoint's vars(args) snapshot (`utils.convert.
train_config_from_reference_args`) with the dims overrides, after loading
both state dicts into models of that config (strict). The port reads no
Orbax directory (that needs jax): the JAX package's `lunaris-convert
to-torch` turns one into a .pt first.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

DIMS = ("latent_dim", "embedding_dim", "feature_dim", "num_experts")
PORT_KEYS = ("baseline", "baseline_initialized", "generator_state")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Convert checkpoints between a reference .pt and a "
                    "checkpoint directory of the port")
    sub = p.add_subparsers(dest="cmd", required=True)

    tp = sub.add_parser("to-port", help="reference .pt -> port directory")
    tp.add_argument("--checkpoint", required=True, help="latest.pt / best.pt")
    tp.add_argument("--out", required=True,
                    help="checkpoint directory to create")
    tp.add_argument("--best", action="store_true",
                    help="also fill the 'best' slot (best.pt)")
    for flag in DIMS:
        tp.add_argument(f"--{flag}", type=int, default=None,
                        help=f"override {flag} (default: checkpoint args)")

    tt = sub.add_parser("to-torch", help="port directory -> reference .pt")
    tt.add_argument("--checkpoint", required=True,
                    help="checkpoint directory (output_dir/checkpoints)")
    tt.add_argument("--out", required=True, help=".pt file to write")
    tt.add_argument("--step", type=int, default=None,
                    help="specific step (default: latest)")
    tt.add_argument("--best", action="store_true",
                    help="export the 'best' slot instead of latest")
    return p


def _to_port(args) -> int:
    import torch

    from lunaris_orion_tpu_torch.config import TrainConfig
    from lunaris_orion_tpu_torch.models.teacher import LunarMoETeacher
    from lunaris_orion_tpu_torch.models.vae import LunarisCoreVAE
    from lunaris_orion_tpu_torch.utils.convert import (
        train_config_from_reference_args)

    ckpt = torch.load(args.checkpoint, map_location="cpu", weights_only=True)
    cfg = (train_config_from_reference_args(ckpt["args"])
           if "args" in ckpt else TrainConfig())
    overrides = {k: getattr(args, k) for k in DIMS
                 if getattr(args, k) is not None}
    cfg = cfg.replace(**overrides)
    # The port's readers take the config from the file's args.
    ckpt["args"] = {**ckpt.get("args", cfg.to_dict()), **overrides}
    LunarisCoreVAE(cfg.vae_config()).load_state_dict(
        ckpt["vae_state_dict"], strict=True)
    LunarMoETeacher(cfg.teacher_config()).load_state_dict(
        {k: v for k, v in ckpt["teacher_state_dict"].items()
         if not k.endswith("rel_pos_cache")}, strict=True)

    out = Path(args.out)
    (out / "steps").mkdir(parents=True, exist_ok=True)
    step = int(ckpt.get("global_step", 0))
    torch.save(ckpt, out / "steps" / f"{step}.pt")
    if args.best:
        torch.save(ckpt, out / "best.pt")
    (out / "config.json").write_text(json.dumps(cfg.to_dict(), indent=2,
                                                default=str))
    print(f"Converted {args.checkpoint} -> {args.out} at step {step} "
          f"(latent={cfg.latent_dim}, feature={cfg.feature_dim}, "
          f"experts={cfg.num_experts}"
          f"{', best slot filled' if args.best else ''})")
    return 0


def _to_torch(args) -> int:
    import torch

    from lunaris_orion_tpu_torch.train.checkpoint import checkpoint_file

    path = checkpoint_file(args.checkpoint, best=args.best, step=args.step)
    if path is None:
        raise FileNotFoundError(
            f"no {'best.pt' if args.best else 'steps/*.pt'} of the port's "
            f"trainer in {args.checkpoint}")
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    out = {k: v for k, v in ckpt.items() if k not in PORT_KEYS}
    torch.save(out, args.out)
    print(f"Exported step {out.get('global_step', 0)} -> {args.out} "
          f"(reference train_hybrid.py resume format)")
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return _to_port(args) if args.cmd == "to-port" else _to_torch(args)


if __name__ == "__main__":
    raise SystemExit(main())
