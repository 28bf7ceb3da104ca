"""Hybrid VAE + teacher losses with the policy-gradient reward term
(counterpart: lunaris_orion_tpu/train/losses.py; formulas of the reference's
`_process_batch`, train_hybrid.py:838-896).

    recon_loss   = mean((recon - images)^2)
    kl_loss      = -0.5 * mean(1 + logvar - mu^2 - exp(logvar))
    reward       = mean_q(quality) + semantic_weight * semantic
    baseline    <- EMA(momentum) of mean reward
    advantage    = (reward - baseline).detach() * reward_scale
    pg_loss      = -(advantage * recon_loss).mean()
    vae_loss     = recon_w * recon + kl_w * kl + pg_loss
    teacher_loss = quality_w * (-mean(quality_scores))

All reductions in f32. One backward of vae_loss + teacher_loss gives the
reference's two backward passes: the advantage is detached, the teacher
sees recon.detach(), and the prompt embeddings of the first teacher call
are detached.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from lunaris_orion_tpu_torch.ops.cuda import loss_epilogue as k3


class LossWeights(NamedTuple):
    recon_weight: float = 1.0
    kl_weight: float = 0.1
    quality_weight: float = 0.5
    reward_scale: float = 0.1
    semantic_weight: float = 0.5
    baseline_momentum: float = 0.9


def recon_kl(recon: torch.Tensor, images: torch.Tensor, mu: torch.Tensor,
             logvar: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """MSE + KL (train_hybrid.py:858-862) through K3: the kernel on a CUDA
    device, its plain version on the CPU."""
    return k3.mse_kl(recon.contiguous(), images.contiguous(),
                     mu.contiguous(), logvar.contiguous())


def hybrid_losses(*, recon_loss: torch.Tensor, kl_loss: torch.Tensor,
                  quality_scores: torch.Tensor,
                  semantic_score: Optional[torch.Tensor],
                  baseline: torch.Tensor, baseline_initialized: torch.Tensor,
                  w: LossWeights):
    """Returns (vae_loss, teacher_loss, new_baseline, new_initialized,
    metrics). baseline is an f32 scalar tensor and baseline_initialized a
    bool scalar tensor, both on the device: nothing here waits for it."""
    q32 = quality_scores.float()
    quality_reward = q32.mean(dim=1, keepdim=True)               # [B, 1]
    semantic_reward = (torch.zeros_like(quality_reward)
                       if semantic_score is None else semantic_score.float())
    total_reward = quality_reward + w.semantic_weight * semantic_reward

    mean_reward = total_reward.mean().detach()
    new_baseline = torch.where(
        baseline_initialized,
        w.baseline_momentum * baseline
        + (1.0 - w.baseline_momentum) * mean_reward,
        mean_reward)
    new_initialized = torch.ones_like(baseline_initialized)

    advantage = (total_reward - new_baseline).detach() * w.reward_scale
    pg_loss = -(advantage * recon_loss).mean()

    vae_loss = w.recon_weight * recon_loss + w.kl_weight * kl_loss + pg_loss
    quality_loss = -q32.mean()
    teacher_loss = w.quality_weight * quality_loss

    metrics: Dict[str, torch.Tensor] = {
        "recon_loss": recon_loss,
        "kl_loss": kl_loss,
        "quality_loss": quality_loss,
        "pg_loss": pg_loss,
        "semantic_reward": semantic_reward.mean(),
        "quality_reward": quality_reward.mean(),
        "baseline": new_baseline,
        "advantage": advantage.mean(),
        "vae_loss": vae_loss,
        "teacher_loss": teacher_loss,
        "total_loss": vae_loss + teacher_loss,
        "quality_scores": q32.mean(),
    }
    metrics = {k: v.detach() for k, v in metrics.items()}
    return vae_loss, teacher_loss, new_baseline, new_initialized, metrics
