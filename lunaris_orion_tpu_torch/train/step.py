"""The hybrid train step (counterpart: lunaris_orion_tpu/train/step.py).

One call is one optimizer step over `gradient_accumulation_steps`
micro-batches (the JAX package's `lax.scan` becomes a Python loop). Per
micro-batch, as the reference's `_process_batch` (train_hybrid.py:838-905):
  1. normalize uint8 -> [-1, 1] in the compute dtype, on the device;
  2. the teacher on the inputs, in train mode, without gradients: its
     BatchNorm statistics advance and dropout is on; its prompt embeddings
     are detached;
  3. the VAE forward with a posterior sample, then MSE + KL (K3);
  4. the teacher on recon.detach(), conditioned on those embeddings;
  5. the hybrid losses; one backward of vae_loss + teacher_loss
     accumulates both models' f32 gradients;
  6. the baseline EMA advances on the device.
Then the gradients are averaged over the micro-batches, each model's are
clipped by their own global norm, each model takes one AdamW update, and
the metrics are averaged over the micro-batches (`baseline` is the current
EMA). Nothing in the step waits for the device.

Precision: mixed_precision runs bf16 activations with f32 parameters cast
at each layer, f32 gradients and f32 optimizer state, as the serving path
does (not torch.autocast).
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from lunaris_orion_tpu_torch.config import TrainConfig
from lunaris_orion_tpu_torch.models import teacher as teacher_mod
from lunaris_orion_tpu_torch.ops.rng import device_generator, new_seed
from lunaris_orion_tpu_torch.train import losses
from lunaris_orion_tpu_torch.train.losses import LossWeights
from lunaris_orion_tpu_torch.train.state import TrainState

Metrics = Dict[str, torch.Tensor]


def normalize_images(batch: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """uint8 [0, 255] -> [-1, 1] in `dtype` (train_hybrid.py:181); a float
    batch is only cast."""
    if batch.dtype == torch.uint8:
        return batch.to(dtype) / torch.tensor(127.5, dtype=dtype) - 1.0
    return batch.to(dtype)


def _compute_dtype(cfg: TrainConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.mixed_precision else torch.float32


def _not_ported(cfg: TrainConfig, cp_mesh, cp_axis, cp_batch_axis) -> None:
    for name, value in (("cp_mesh", cp_mesh), ("cp_axis", cp_axis),
                        ("cp_batch_axis", cp_batch_axis)):
        if value is not None:
            raise NotImplementedError(
                f"{name} (context parallelism) is not ported yet")
    for name in ("fuse_teacher", "cached_prompt_embeddings", "bf16_momentum",
                 "attn_window"):
        if getattr(cfg, name):
            raise NotImplementedError(f"{name} is not ported yet")


def make_train_step(cfg: TrainConfig, *, remat: bool = True,
                    attn_bwd: str | None = None,
                    cp_mesh=None, cp_axis=None, cp_batch_axis=None
                    ) -> Callable[[TrainState, torch.Tensor],
                                  Tuple[TrainState, Metrics]]:
    """Returns train_step(state, images [A, mb, H, W, 3] on the state's
    device) -> (state, metrics). The state is updated in place and
    returned. `attn_bwd` picks K2's backward kernels on CUDA ("fused" or
    "split"; None: `flash_attention.default_bwd`, by type and head size).
    The models' configs come with the state;
    the teacher's attention follows the `auto` rule."""
    _not_ported(cfg, cp_mesh, cp_axis, cp_batch_axis)
    w = LossWeights(cfg.recon_weight, cfg.kl_weight, cfg.quality_weight,
                    cfg.reward_scale, cfg.semantic_weight,
                    cfg.baseline_momentum)
    dtype = _compute_dtype(cfg)
    teacher_kw = dict(train=True, remat=remat, bwd=attn_bwd)

    def train_step(state: TrainState, images: torch.Tensor
                   ) -> Tuple[TrainState, Metrics]:
        vae, teacher = state.vae, state.teacher
        state.vae_opt.zero_grad()
        state.teacher_opt.zero_grad()
        baseline, binit = state.baseline, state.baseline_initialized
        stacked = []
        for batch in images:
            x = normalize_images(batch, dtype)
            with torch.no_grad():
                t1 = teacher_mod.apply(teacher, x, generator=state.generator,
                                       **teacher_kw)
            recon, mu, logvar = vae(
                x, device_generator(new_seed(state.generator), x.device))
            recon_loss, kl_loss = losses.recon_kl(recon, x, mu, logvar)
            t2 = teacher_mod.apply(
                teacher, recon.detach(),
                prompt_embedding=t1["prompt_embedding"].detach(),
                generator=state.generator, **teacher_kw)
            vae_loss, teacher_loss, baseline, binit, metrics = (
                losses.hybrid_losses(
                    recon_loss=recon_loss, kl_loss=kl_loss,
                    quality_scores=t2["quality_scores"],
                    semantic_score=t2["semantic_score"], baseline=baseline,
                    baseline_initialized=binit, w=w))
            (vae_loss + teacher_loss).backward()
            stacked.append(metrics)

        inv = 1.0 / len(stacked)
        for opt in (state.vae_opt, state.teacher_opt):
            for p in opt.params:
                if p.grad is not None:
                    p.grad.mul_(inv)
            opt.step(state.step)
        out = {k: torch.stack([m[k] for m in stacked]).float().mean()
               for k in stacked[0]}
        out["baseline"] = baseline          # the current EMA
        state.step += 1
        state.baseline, state.baseline_initialized = baseline, binit
        return state, out

    return train_step


def make_eval_step(cfg: TrainConfig, *, cp_mesh=None, cp_axis=None,
                   cp_batch_axis=None
                   ) -> Callable[[TrainState, torch.Tensor], Metrics]:
    """Deterministic validation: the reconstruction from the mean latent,
    MSE + KL, and the teacher's quality in eval mode. images [B, H, W, 3]."""
    _not_ported(cfg, cp_mesh, cp_axis, cp_batch_axis)
    dtype = _compute_dtype(cfg)

    @torch.no_grad()
    def eval_step(state: TrainState, images: torch.Tensor) -> Metrics:
        x = normalize_images(images, dtype)
        recon, mu, logvar = state.vae(x, sample_posterior=False)
        recon_loss, kl_loss = losses.recon_kl(recon, x, mu, logvar)
        t_out = teacher_mod.apply(state.teacher, recon)
        return {
            "val_recon_loss": recon_loss,
            "val_kl_loss": kl_loss,
            "val_loss": cfg.recon_weight * recon_loss + cfg.kl_weight * kl_loss,
            "val_quality": t_out["quality_scores"].float().mean(),
        }

    return eval_step


def make_embed_step(cfg: TrainConfig, **kwargs):
    """The cached prompt-embedding table's step: not ported yet."""
    raise NotImplementedError("make_embed_step (cached prompt embeddings) is "
                              "not ported yet")
