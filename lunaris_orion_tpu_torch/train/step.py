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

Across ranks (`mesh`, a `parallel.Mesh`): the batch a rank takes is its
data-axis share of the global batch. BatchNorm uses the global batch's
moments, every random draw gives the rank the global draw's rows, the
losses' batch statistics are global (`losses.hybrid_losses`), and after
the accumulation, before the clip, the gradients are averaged over the
data axis only; the metrics are averaged over it too. A model axis
above 1 splits the work of one sample over its ranks, which take the same
samples: context parallelism (`cp_mesh`, `cp_axis`; attn_impl 'ring' or
'allgather') splits the teacher attention's tokens (every gradient that
leaves the attention is whole on each rank,
`parallel/ring_attention.py`), tensor parallelism the VAE's bottleneck
FC pair by latent column, and expert parallelism the teacher's experts
(`parallel/sharding.py`; the state is a rank's part, from `shard_state`;
without context parallelism both apply, with it the FC pair only, by the
JAX package's rule). A split parameter's gradient is the rank's own. The
rest of their work is the same work done twice, which a
non-deterministic kernel (cuDNN's, on a card) can leave apart in the
last bits, so the replicated parameters' gradients, the replicated
BatchNorm statistics, the baseline and the metrics are then taken from
the model axis's first rank (`broadcast_`): the ranks of a model row take
the same AdamW update and the same decisions.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from lunaris_orion_tpu_torch.config import TrainConfig
from lunaris_orion_tpu_torch.models import teacher as teacher_mod
from lunaris_orion_tpu_torch.ops.rng import device_generator, new_seed
from lunaris_orion_tpu_torch.parallel.collectives import (all_reduce_mean_,
                                                         broadcast_)
from lunaris_orion_tpu_torch.parallel.mesh import DATA_AXIS, Mesh, Parallel
from lunaris_orion_tpu_torch.parallel.sharding import expert_index, with_layout
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


def step_parallel(cfg: TrainConfig, mesh: Optional[Mesh] = None,
                  cp_mesh: Optional[Mesh] = None, cp_axis: Optional[str] = None,
                  cp_batch_axis: Optional[str] = None) -> Optional[Parallel]:
    """The axes a step's modules read: the data axis of `mesh` (or of
    `cp_mesh`), with `cp_axis` the context-parallel axis of `cp_mesh`, and
    the model axis. Where the FC pair and the experts split is the
    state's own record (`sharding.with_layout(par, state.layout)`, taken
    at each call). `cp_batch_axis` is the JAX signature's name of the
    axis the batch is split over: None or 'data'. None without a mesh."""
    if (cp_mesh is None) != (cp_axis is None):
        raise ValueError("context parallelism needs cp_mesh and cp_axis")
    if cp_batch_axis not in (None, DATA_AXIS):
        raise ValueError(f"cp_batch_axis must be None or {DATA_AXIS!r}, got "
                         f"{cp_batch_axis!r}")
    if mesh is not None and cp_mesh is not None and mesh is not cp_mesh:
        raise ValueError("mesh and cp_mesh must be one mesh")
    mesh = mesh or cp_mesh
    if mesh is None:
        return None
    cp = None
    if cp_axis is not None:
        if cp_axis == DATA_AXIS:
            raise ValueError("the batch is split over the data axis; context "
                             "parallelism runs over the model axis")
        cp = mesh.axis(cp_axis)
    return Parallel(data=mesh.data, cp=cp,
                    cp_kernel=getattr(cfg, "use_pallas", None) is not False,
                    model=mesh.model if mesh.model.size > 1 else None)


def make_micro_step(cfg: TrainConfig, *, remat: bool = True,
                    attn_bwd: str | None = None, attn_impl: str = "auto",
                    par: Optional[Parallel] = None
                    ) -> Callable[..., Tuple[torch.Tensor, torch.Tensor,
                                             Metrics]]:
    """Returns micro_step(state, batch [mb, H, W, 3], baseline,
    baseline_initialized, pe_cached=None) -> (baseline,
    baseline_initialized, metrics): one micro-batch's forwards and backward
    (steps 1-6 of the module docstring, or the options' forms), which adds
    its gradients to the models' .grad. pe_cached [mb, E]: the cached
    prompt embeddings, needed with cfg.cached_prompt_embeddings. `par`:
    the mesh's axes (`step_parallel`); the state's layout adds its tensor
    / expert axes."""
    w = LossWeights(cfg.recon_weight, cfg.kl_weight, cfg.quality_weight,
                    cfg.reward_scale, cfg.semantic_weight,
                    cfg.baseline_momentum)
    dtype = _compute_dtype(cfg)
    cached = bool(cfg.cached_prompt_embeddings)
    fuse = bool(cfg.fuse_teacher) and not cached
    data = par and par.data

    def micro_step(state: TrainState, batch: torch.Tensor,
                   baseline: torch.Tensor, binit: torch.Tensor,
                   pe_cached: torch.Tensor | None = None):
        teacher = state.teacher
        split = with_layout(par, state.layout)
        tp = split and split.tp
        teacher_kw = dict(train=True, remat=remat, bwd=attn_bwd,
                          attn_impl=attn_impl, par=split)
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
            x, device_generator(new_seed(state.generator), x.device),
            rows=data, tp=tp)
        recon_loss, kl_loss = losses.recon_kl(recon, x, mu, logvar, tp)
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
                baseline=baseline, baseline_initialized=binit, w=w,
                data=data))
        (vae_loss + teacher_loss).backward()
        return baseline, binit, metrics

    return micro_step


def make_train_step(cfg: TrainConfig, *, remat: bool = True,
                    attn_bwd: str | None = None, attn_impl: str = "auto",
                    mesh: Optional[Mesh] = None, cp_mesh: Optional[Mesh] = None,
                    cp_axis: Optional[str] = None,
                    cp_batch_axis: Optional[str] = None
                    ) -> Callable[..., Tuple[TrainState, Metrics]]:
    """Returns train_step(state, images [A, mb, H, W, 3] on the state's
    device, prompt_embs [A, mb, E] with cfg.cached_prompt_embeddings) ->
    (state, metrics). The state is updated in place and returned.
    `attn_bwd` picks K2's backward kernels on CUDA ("fused" or "split";
    None: `flash_attention.default_bwd`, by type and head size).
    `attn_impl` is the teacher attention's impl: 'auto' (the JAX package's
    rule), 'full', 'flash' (K2), or 'ring' / 'allgather' (context
    parallelism over `cp_axis` of `cp_mesh`, the model axis); the
    teacher's attn_window overrides the first three. `mesh`: data
    parallelism over its data axis (the module docstring); `cp_mesh` is
    that mesh too. The models' configs come with the state."""
    par = step_parallel(cfg, mesh, cp_mesh, cp_axis, cp_batch_axis)
    data = par and par.data
    model = par and par.model
    micro_step = make_micro_step(cfg, remat=remat, attn_bwd=attn_bwd,
                                 attn_impl=attn_impl, par=par)

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
        ep = state.layout and state.layout.ep
        held = [(p.grad, part) for opt in (state.vae_opt, state.teacher_opt)
                for p, part in zip(opt.params, opt.split)
                if p.grad is not None]
        grads = [g for g, _ in held]
        for g in grads:
            g.mul_(inv)
        if data is not None:
            all_reduce_mean_(grads, data)
        if model is not None:
            broadcast_([g for g, part in held if not part], model)
        for opt in (state.vae_opt, state.teacher_opt):
            opt.step(state.step)
        out = {k: torch.stack([m[k] for m in stacked]).float().mean()
               for k in stacked[0]}
        if data is not None:
            all_reduce_mean_(list(out.values()), data)
        if model is not None:
            broadcast_(list(out.values()) + [baseline] + [
                b for k, b in state.teacher.named_buffers()
                if "running" in k and (ep is None
                                       or expert_index(k) is None)], model)
        out["baseline"] = baseline          # the current EMA
        state.step += 1
        state.baseline, state.baseline_initialized = baseline, binit
        return state, out

    return train_step


def make_eval_step(cfg: TrainConfig, *, attn_impl: str = "auto",
                   mesh: Optional[Mesh] = None, cp_mesh: Optional[Mesh] = None,
                   cp_axis: Optional[str] = None,
                   cp_batch_axis: Optional[str] = None
                   ) -> Callable[[TrainState, torch.Tensor], Metrics]:
    """Deterministic validation: the reconstruction from the mean latent,
    MSE + KL, and the teacher's quality in eval mode. images [B, H, W, 3]
    (a rank's data-axis share of the batch; the metrics are averaged over
    the data axis). `attn_impl` and the mesh as in `make_train_step`."""
    par = step_parallel(cfg, mesh, cp_mesh, cp_axis, cp_batch_axis)
    dtype = _compute_dtype(cfg)

    @torch.no_grad()
    def eval_step(state: TrainState, images: torch.Tensor) -> Metrics:
        x = normalize_images(images, dtype)
        split = with_layout(par, state.layout)
        tp = split and split.tp
        recon, mu, logvar = state.vae(x, sample_posterior=False, tp=tp)
        recon_loss, kl_loss = losses.recon_kl(recon, x, mu, logvar, tp)
        t_out = teacher_mod.apply(state.teacher, recon, attn_impl=attn_impl,
                                  par=split)
        out = {
            "val_recon_loss": recon_loss,
            "val_kl_loss": kl_loss,
            "val_loss": cfg.recon_weight * recon_loss + cfg.kl_weight * kl_loss,
            "val_quality": t_out["quality_scores"].float().mean(),
        }
        if par is not None:
            out = {k: v.float().clone() for k, v in out.items()}
            all_reduce_mean_(list(out.values()), par.data)
            if par.model is not None:
                broadcast_(list(out.values()), par.model)
        return out

    return eval_step


def make_embed_step(cfg: TrainConfig, *, attn_impl: str = "auto",
                    mesh: Optional[Mesh] = None, cp_mesh: Optional[Mesh] = None,
                    cp_axis: Optional[str] = None,
                    cp_batch_axis: Optional[str] = None
                    ) -> Callable[[TrainState, torch.Tensor], torch.Tensor]:
    """The cached table's step: eval-mode prompt embeddings, images
    [B, H, W, 3] uint8 -> [B, embedding_dim] f32, in the training compute
    dtype, per sample (no collective but context parallelism's).
    `attn_impl` and the mesh as in `make_train_step`."""
    par = step_parallel(cfg, mesh, cp_mesh, cp_axis, cp_batch_axis)
    dtype = _compute_dtype(cfg)

    @torch.no_grad()
    def embed_step(state: TrainState, images: torch.Tensor) -> torch.Tensor:
        out = teacher_mod.apply(state.teacher, normalize_images(images, dtype),
                                attn_impl=attn_impl,
                                par=with_layout(par, state.layout))
        return out["prompt_embedding"].float()

    return embed_step
