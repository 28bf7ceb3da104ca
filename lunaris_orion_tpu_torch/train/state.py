"""Train state and optimizers (counterpart: lunaris_orion_tpu/train/state.py).

The JAX package carries one pytree through its jitted step; here the state
holds the two models (whose parameters and BatchNorm buffers the step
updates in place), their optimizers, the RL baseline on the device, and the
host generator that every random draw of the step starts from.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch
import torch.nn as nn

from lunaris_orion_tpu_torch.config import TeacherConfig, TrainConfig, VAEConfig
from lunaris_orion_tpu_torch.models.teacher import LunarMoETeacher
from lunaris_orion_tpu_torch.models.vae import LunarisCoreVAE
from lunaris_orion_tpu_torch.train.schedule import cosine_warm_restarts


class ClippedAdamW:
    """One model's optimizer: the JAX package's
    optax.chain(clip_by_global_norm(max_grad_norm), adamw(cosine warm
    restarts, b1=0.9, b2=0.999, eps=1e-8, weight_decay)) as
    torch.optim.AdamW, with the learning rate set from the schedule at the
    optax count (the number of earlier updates) before each update."""

    def __init__(self, module: nn.Module, base_lr: float, cfg: TrainConfig):
        self.params: List[nn.Parameter] = list(module.parameters())
        self.schedule = cosine_warm_restarts(base_lr, cfg.scheduler_t0,
                                             cfg.min_lr)
        self.max_norm = cfg.max_grad_norm
        self.opt = torch.optim.AdamW(self.params, lr=base_lr,
                                     betas=(0.9, 0.999), eps=1e-8,
                                     weight_decay=cfg.weight_decay)

    def zero_grad(self) -> None:
        self.opt.zero_grad(set_to_none=True)

    @torch.no_grad()
    def step(self, count: int) -> torch.Tensor:
        """Clip the gradients by their global norm, then take one AdamW
        update at lr = schedule(count). A parameter without a gradient gets
        a zero one, as in optax, so weight decay still applies to it.
        Returns the global norm before clipping (a device scalar)."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        norm = torch.stack([g.float().square().sum() for g in grads]).sum().sqrt()
        clip = norm >= self.max_norm
        for g in grads:
            g.copy_(torch.where(clip, (g / norm) * self.max_norm, g))
        for group in self.opt.param_groups:
            group["lr"] = self.schedule(count)
        self.opt.step()
        return norm


def make_optimizers(cfg: TrainConfig, vae: nn.Module, teacher: nn.Module
                    ) -> Tuple[ClippedAdamW, ClippedAdamW]:
    """The VAE's and the teacher's optimizers (train_hybrid.py:504-527 and
    the per-step clip at :913-914)."""
    if cfg.bf16_momentum:
        raise NotImplementedError("bf16_momentum is not ported yet")
    return (ClippedAdamW(vae, cfg.vae_lr, cfg),
            ClippedAdamW(teacher, cfg.teacher_lr, cfg))


@dataclass
class TrainState:
    step: int                            # optimizer steps taken
    vae: LunarisCoreVAE
    teacher: LunarMoETeacher
    vae_opt: ClippedAdamW
    teacher_opt: ClippedAdamW
    baseline: torch.Tensor               # f32 scalar on the device
    baseline_initialized: torch.Tensor   # bool scalar on the device
    best_loss: float
    generator: torch.Generator           # CPU: source of every random draw


def create_state(cfg: TrainConfig, device: torch.device | str, seed: int,
                 vcfg: Optional[VAEConfig] = None,
                 tcfg: Optional[TeacherConfig] = None) -> TrainState:
    """Fresh models (the JAX package's init distributions, drawn from
    torch.Generator(seed)) on `device`, with their optimizers."""
    device = torch.device(device)
    g = torch.Generator().manual_seed(seed)
    vae = LunarisCoreVAE(vcfg or cfg.vae_config())
    vae.reset_parameters(g)
    teacher = LunarMoETeacher(tcfg or cfg.teacher_config())
    teacher.reset_parameters(g)
    return state_for(cfg, vae.to(device), teacher.to(device), generator=g)


def state_for(cfg: TrainConfig, vae: LunarisCoreVAE,
              teacher: LunarMoETeacher, *, step: int = 0,
              generator: Optional[torch.Generator] = None) -> TrainState:
    """A TrainState around two models on one device: new optimizers, the
    baseline unset, `generator` (default: seeded with cfg.seed)."""
    device = next(vae.parameters()).device
    vae_opt, teacher_opt = make_optimizers(cfg, vae, teacher)
    return TrainState(
        step=step, vae=vae, teacher=teacher, vae_opt=vae_opt,
        teacher_opt=teacher_opt,
        baseline=torch.zeros((), dtype=torch.float32, device=device),
        baseline_initialized=torch.zeros((), dtype=torch.bool, device=device),
        best_loss=math.inf,
        generator=generator or torch.Generator().manual_seed(cfg.seed))
