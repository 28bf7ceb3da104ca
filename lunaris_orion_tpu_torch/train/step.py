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

Two options change steps 2 and 4, as in the JAX package:
  * cached_prompt_embeddings: the step takes each micro-batch's prompt
    embeddings [A, mb, E] from a table (`make_embed_step`, refreshed by the
    Trainer) and skips step 2, so the teacher's BatchNorm statistics
    advance once a micro-batch;
  * fuse_teacher: steps 2 and 4 become one teacher forward, with
    gradients, over [x; recon.detach()] at 2 mb; the recon half's semantic
    score is multiplied by the cosine between its prompt embedding and the
    x half's (detached) afterwards, which is what the teacher does inside
    when given the embedding. BatchNorm statistics are joint over 2 mb and
    advance once.

Precision: mixed_precision runs bf16 activations with f32 parameters cast
at each layer, f32 gradients and f32 optimizer state (AdamW's first moment
in bf16 with bf16_momentum), as the serving path does (not
torch.autocast).
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


def _not_ported(cp_mesh, cp_axis, cp_batch_axis) -> None:
    for name, value in (("cp_mesh", cp_mesh), ("cp_axis", cp_axis),
                        ("cp_batch_axis", cp_batch_axis)):
        if value is not None:
            raise NotImplementedError(
                f"{name} (context parallelism) is not ported yet")


def make_micro_step(cfg: TrainConfig, *, remat: bool = True,
                    attn_bwd: str | None = None, attn_impl: str = "auto"
                    ) -> Callable[..., Tuple[torch.Tensor, torch.Tensor,
                                             Metrics]]:
    """Returns micro_step(state, batch [mb, H, W, 3], baseline,
    baseline_initialized, pe_cached=None) -> (baseline,
    baseline_initialized, metrics): one micro-batch's forwards and backward
    (steps 1-6 of the module docstring, or the options' forms), which adds
    its gradients to the models' .grad. pe_cached [mb, E]: the cached
    prompt embeddings, needed with cfg.cached_prompt_embeddings."""
    w = LossWeights(cfg.recon_weight, cfg.kl_weight, cfg.quality_weight,
                    cfg.reward_scale, cfg.semantic_weight,
                    cfg.baseline_momentum)
    dtype = _compute_dtype(cfg)
    cached = bool(cfg.cached_prompt_embeddings)
    fuse = bool(cfg.fuse_teacher) and not cached
    teacher_kw = dict(train=True, remat=remat, bwd=attn_bwd,
                      attn_impl=attn_impl)

    def micro_step(state: TrainState, batch: torch.Tensor,
                   baseline: torch.Tensor, binit: torch.Tensor,
                   pe_cached: torch.Tensor | None = None):
        teacher = state.teacher
        x = normalize_images(batch, dtype)
        if cached:
            if pe_cached is None:
                raise ValueError("cached_prompt_embeddings: the step needs "
                                 "the micro-batch's prompt embeddings")
            prompt = pe_cached.detach().float()
        elif not fuse:
            with torch.no_grad():
                prompt = teacher_mod.apply(
                    teacher, x, generator=state.generator,
                    **teacher_kw)["prompt_embedding"].detach()
        recon, mu, logvar = state.vae(
            x, device_generator(new_seed(state.generator), x.device))
        recon_loss, kl_loss = losses.recon_kl(recon, x, mu, logvar)
        if fuse:
            t = teacher_mod.apply(teacher, torch.cat([x, recon.detach()]),
                                  generator=state.generator, **teacher_kw)
            b = x.shape[0]
            emb = t["prompt_embedding"]
            quality = t["quality_scores"][b:]
            semantic = t["semantic_score"][b:] * teacher_mod.prompt_cosine(
                emb[b:], emb[:b].detach())[:, None]
        else:
            t = teacher_mod.apply(teacher, recon.detach(),
                                  prompt_embedding=prompt,
                                  generator=state.generator, **teacher_kw)
            quality, semantic = t["quality_scores"], t["semantic_score"]
        vae_loss, teacher_loss, baseline, binit, metrics = (
            losses.hybrid_losses(
                recon_loss=recon_loss, kl_loss=kl_loss,
                quality_scores=quality, semantic_score=semantic,
                baseline=baseline, baseline_initialized=binit, w=w))
        (vae_loss + teacher_loss).backward()
        return baseline, binit, metrics

    return micro_step


def make_train_step(cfg: TrainConfig, *, remat: bool = True,
                    attn_bwd: str | None = None, attn_impl: str = "auto",
                    cp_mesh=None, cp_axis=None, cp_batch_axis=None
                    ) -> Callable[..., Tuple[TrainState, Metrics]]:
    """Returns train_step(state, images [A, mb, H, W, 3] on the state's
    device, prompt_embs [A, mb, E] with cfg.cached_prompt_embeddings) ->
    (state, metrics). The state is updated in place and returned.
    `attn_bwd` picks K2's backward kernels on CUDA ("fused" or "split";
    None: `flash_attention.default_bwd`, by type and head size).
    `attn_impl` is the teacher attention's impl: 'auto' (the JAX package's
    rule), 'full' or 'flash' (K2); the teacher's attn_window overrides it.
    The models' configs come with the state."""
    _not_ported(cp_mesh, cp_axis, cp_batch_axis)
    micro_step = make_micro_step(cfg, remat=remat, attn_bwd=attn_bwd,
                                 attn_impl=attn_impl)

    def train_step(state: TrainState, images: torch.Tensor,
                   prompt_embs: torch.Tensor | None = None
                   ) -> Tuple[TrainState, Metrics]:
        state.vae_opt.zero_grad()
        state.teacher_opt.zero_grad()
        baseline, binit = state.baseline, state.baseline_initialized
        stacked = []
        for i, batch in enumerate(images):
            baseline, binit, metrics = micro_step(
                state, batch, baseline, binit,
                None if prompt_embs is None else prompt_embs[i])
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


def make_eval_step(cfg: TrainConfig, *, attn_impl: str = "auto",
                   cp_mesh=None, cp_axis=None, cp_batch_axis=None
                   ) -> Callable[[TrainState, torch.Tensor], Metrics]:
    """Deterministic validation: the reconstruction from the mean latent,
    MSE + KL, and the teacher's quality in eval mode. images [B, H, W, 3].
    `attn_impl` as in `make_train_step`."""
    _not_ported(cp_mesh, cp_axis, cp_batch_axis)
    dtype = _compute_dtype(cfg)

    @torch.no_grad()
    def eval_step(state: TrainState, images: torch.Tensor) -> Metrics:
        x = normalize_images(images, dtype)
        recon, mu, logvar = state.vae(x, sample_posterior=False)
        recon_loss, kl_loss = losses.recon_kl(recon, x, mu, logvar)
        t_out = teacher_mod.apply(state.teacher, recon, attn_impl=attn_impl)
        return {
            "val_recon_loss": recon_loss,
            "val_kl_loss": kl_loss,
            "val_loss": cfg.recon_weight * recon_loss + cfg.kl_weight * kl_loss,
            "val_quality": t_out["quality_scores"].float().mean(),
        }

    return eval_step


def make_embed_step(cfg: TrainConfig, *, attn_impl: str = "auto",
                    cp_mesh=None, cp_axis=None, cp_batch_axis=None
                    ) -> Callable[[TrainState, torch.Tensor], torch.Tensor]:
    """The cached table's step: eval-mode prompt embeddings, images
    [B, H, W, 3] uint8 -> [B, embedding_dim] f32, in the training compute
    dtype. `attn_impl` as in `make_train_step`."""
    _not_ported(cp_mesh, cp_axis, cp_batch_axis)
    dtype = _compute_dtype(cfg)

    @torch.no_grad()
    def embed_step(state: TrainState, images: torch.Tensor) -> torch.Tensor:
        out = teacher_mod.apply(state.teacher, normalize_images(images, dtype),
                                attn_impl=attn_impl)
        return out["prompt_embedding"].float()

    return embed_step
