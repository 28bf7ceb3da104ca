"""Training CLI of the port -- the flags of `lunaris-train`
(lunaris_orion_tpu/cli/train.py): the same names and defaults, plus
--device.

    python -m lunaris_orion_tpu_torch.cli.train --data_dir sprites \
        --output_dir output --mixed_precision

--device defaults to cuda and raises without a card; --device cpu (or
--force_cpu) runs the kernels' plain PyTorch versions on the CPU. Flags
of the JAX package that steer what the port does not have (--fast_rng,
--compile, --num_workers, --chunk_size, --memory_efficient) are accepted
and change nothing (`train.loop.Trainer`); the options not ported yet,
a --mesh_shape over more than one device and --attn_impl ring /
allgather, raise NotImplementedError by name.
"""

from __future__ import annotations

import argparse

import numpy as np

from lunaris_orion_tpu_torch.config import TrainConfig


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Hybrid VAE+Teacher pixel-art training (PyTorch port)")
    d = TrainConfig()

    g = p.add_argument_group("data")
    g.add_argument("--data_dir", type=str, required=True,
                   help="dir with sprites_*.npy + labels_*.csv")
    g.add_argument("--output_dir", type=str, default=d.output_dir)
    g.add_argument("--resume_from", type=str, default=None,
                   help="checkpoint dir to resume from (the latest step), "
                        "or a reference-layout .pt file (params, BN stats, "
                        "AdamW moments, schedule position)")

    g = p.add_argument_group("training")
    g.add_argument("--batch_size", type=int, default=d.batch_size)
    g.add_argument("--gradient_accumulation_steps", type=int,
                   default=d.gradient_accumulation_steps)
    g.add_argument("--chunk_size", type=int, default=d.chunk_size,
                   help="compat flag; the attention's blocking is the "
                        "kernels' own")
    g.add_argument("--num_epochs", type=int, default=d.num_epochs)
    g.add_argument("--num_workers", type=int, default=d.num_workers,
                   help="compat flag; one prefetch thread feeds the device")
    g.add_argument("--seed", type=int, default=d.seed)
    g.add_argument("--compile", action="store_true",
                   help="compat flag; no effect")
    g.add_argument("--mixed_precision", action="store_true",
                   help="bf16 activations, f32 parameters, gradients and "
                        "optimizer state (no loss scaling)")

    g = p.add_argument_group("model")
    g.add_argument("--latent_dim", type=int, default=d.latent_dim)
    g.add_argument("--embedding_dim", type=int, default=d.embedding_dim)
    g.add_argument("--feature_dim", type=int, default=d.feature_dim)
    g.add_argument("--num_experts", type=int, default=d.num_experts)

    g = p.add_argument_group("optimizer")
    g.add_argument("--vae_lr", type=float, default=d.vae_lr)
    g.add_argument("--teacher_lr", type=float, default=d.teacher_lr)
    g.add_argument("--min_lr", type=float, default=d.min_lr)
    g.add_argument("--weight_decay", type=float, default=d.weight_decay)
    g.add_argument("--max_grad_norm", type=float, default=d.max_grad_norm)
    g.add_argument("--scheduler_t0", type=int, default=d.scheduler_t0)

    g = p.add_argument_group("loss weights")
    g.add_argument("--recon_weight", type=float, default=d.recon_weight)
    g.add_argument("--kl_weight", type=float, default=d.kl_weight)
    g.add_argument("--quality_weight", type=float, default=d.quality_weight)

    g = p.add_argument_group("logging / checkpoints")
    g.add_argument("--log_every", type=int, default=d.log_every)
    g.add_argument("--save_every", type=int, default=d.save_every)
    g.add_argument("--sample_every", type=int, default=d.sample_every)
    g.add_argument("--keep_n_checkpoints", type=int,
                   default=d.keep_n_checkpoints)
    g.add_argument("--early_stopping_patience", type=int,
                   default=d.early_stopping_patience)
    g.add_argument("--eval_save_freq", type=int, default=d.eval_save_freq)

    g = p.add_argument_group("rl")
    g.add_argument("--reward_scale", type=float, default=d.reward_scale)
    g.add_argument("--semantic_weight", type=float, default=d.semantic_weight)
    g.add_argument("--baseline_momentum", type=float,
                   default=d.baseline_momentum)

    g = p.add_argument_group("device")
    g.add_argument("--device", type=str, default="cuda",
                   choices=("cuda", "cpu"),
                   help="'cuda' (default; fails without a card) or 'cpu' "
                        "(the kernels' plain PyTorch versions)")
    g.add_argument("--force_cpu", action="store_true",
                   help="the same as --device cpu")
    g.add_argument("--memory_efficient", action="store_true",
                   help="compat flag (a no-op in the reference too)")

    g = p.add_argument_group("extensions of the JAX package")
    g.add_argument("--image_size", type=int, default=d.image_size)
    g.add_argument("--mesh_shape", type=int, nargs=2, default=None,
                   metavar=("DATA", "MODEL"),
                   help="device mesh; more than one device is not ported "
                        "yet and raises")
    g.add_argument("--val_fraction", type=float, default=d.val_fraction)
    g.add_argument("--prefetch_depth", type=int, default=d.prefetch_depth)
    g.add_argument("--steps_per_call", type=int, default=d.steps_per_call,
                   help="optimizer steps run on one staged load of K x "
                        "accumulation micro-batches (the same math as 1; "
                        "metrics log at their exact steps, checkpoints and "
                        "grids land on K-step boundaries, epochs drop "
                        "trailing batches that do not fill K steps)")
    g.add_argument("--device_data", action=argparse.BooleanOptionalAction,
                   default=d.device_data,
                   help="keep the corpus resident on the device and gather "
                        "batches there (an index vector crosses a batch); "
                        "streams instead when it does not fit beside the "
                        "step")
    g.add_argument("--hang_watchdog_secs", type=float,
                   default=d.hang_watchdog_secs,
                   help=">0: exit(66) if no training heartbeat lands within "
                        "this many seconds (a wedged device call); a "
                        "supervisor restarts with --resume_from. Size it "
                        "above a step and a checkpoint save")
    g.add_argument("--profile_steps", type=int, default=d.profile_steps,
                   help=">0: write a torch.profiler trace of that many "
                        "steps to output_dir/profile")
    g.add_argument("--debug_nans", action="store_true",
                   help="autograd anomaly detection (slow; debugging aid)")
    g.add_argument("--use_pallas", action=argparse.BooleanOptionalAction,
                   default=d.use_pallas,
                   help="either form runs the flash attention (K2); "
                        "default: the auto rule (full attention up to 1024 "
                        "tokens)")
    g.add_argument("--attn_impl", type=str, default=d.attn_impl,
                   choices=("auto", "full", "flash", "pallas", "ring",
                            "allgather"),
                   help="teacher attention: 'auto' (full up to 1024 tokens, "
                        "else K2), 'full', 'flash' or 'pallas' (both K2); "
                        "'ring' / 'allgather' (context parallelism) are not "
                        "ported yet and raise")
    g.add_argument("--attn_window", type=int, default=d.attn_window,
                   help="teacher attention window in tokens (0 = global): "
                        "each token attends within its contiguous window of "
                        "the flattened token axis, K2 over the windows "
                        "folded into the heads; 256 is the recommended "
                        "recipe at 128 px")
    g.add_argument("--fuse_teacher", action=argparse.BooleanOptionalAction,
                   default=d.fuse_teacher,
                   help="run the teacher's two calls a micro-batch as one "
                        "forward over [x; recon] at twice the batch "
                        "(BatchNorm statistics joint over both halves)")
    g.add_argument("--bf16_momentum", action="store_true",
                   default=d.bf16_momentum,
                   help="keep AdamW's first moments in bf16 (second moments "
                        "stay f32)")
    g.add_argument("--cached_prompt_embeddings", action="store_true",
                   default=d.cached_prompt_embeddings,
                   help="take prompt embeddings from a per-sample table "
                        "refreshed every --embed_refresh_epochs epochs, "
                        "instead of a teacher call on the inputs each "
                        "micro-batch")
    g.add_argument("--embed_refresh_epochs", type=int,
                   default=d.embed_refresh_epochs)
    g.add_argument("--remat", action=argparse.BooleanOptionalAction,
                   default=d.remat,
                   help="force recomputation of each expert block in the "
                        "backward on/off; default: the memory plan turns "
                        "it off when the step fits the device")
    g.add_argument("--fast_rng", action=argparse.BooleanOptionalAction,
                   default=d.fast_rng,
                   help="the JAX package's PRNG choice; no effect here "
                        "(the port draws from torch generators)")
    return p


def config_from_args(args: argparse.Namespace) -> TrainConfig:
    kw = vars(args).copy()
    device = kw.pop("device")
    kw["force_cpu"] = kw["force_cpu"] or device == "cpu"
    if kw.get("mesh_shape") is not None:
        kw["mesh_shape"] = tuple(kw["mesh_shape"])
    return TrainConfig(**kw)


def trainer_from_args(argv=None):
    """The Trainer that `main(argv)` runs (state restored, not trained)."""
    args = build_parser().parse_args(argv)
    np.random.seed(args.seed)
    from lunaris_orion_tpu_torch.train.loop import Trainer
    return Trainer(config_from_args(args))


def main(argv=None) -> int:
    trainer = trainer_from_args(argv)
    result = trainer.train()
    trainer.logger.info("Done: %s", result)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
