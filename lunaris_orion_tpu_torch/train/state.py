"""Train state and optimizers (counterpart: lunaris_orion_tpu/train/state.py).

The JAX package carries one pytree through its jitted step; here the state
holds the two models (whose parameters and BatchNorm buffers the step
updates in place), their optimizers, the RL baseline on the device, and the
host generator that every random draw of the step starts from.
"""

from __future__ import annotations

import copy
import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch
import torch.nn as nn

from lunaris_orion_tpu_torch.config import TeacherConfig, TrainConfig, VAEConfig
from lunaris_orion_tpu_torch.models.teacher import LunarMoETeacher
from lunaris_orion_tpu_torch.models.vae import LunarisCoreVAE
from lunaris_orion_tpu_torch.parallel.collectives import sum_over
from lunaris_orion_tpu_torch.parallel.mesh import AxisGroup
from lunaris_orion_tpu_torch.train.schedule import cosine_warm_restarts


class ClippedAdamW:
    """One model's optimizer: the JAX package's
    optax.chain(clip_by_global_norm(max_grad_norm), adamw(cosine warm
    restarts, b1=0.9, b2=0.999, eps=1e-8, weight_decay)) as
    torch.optim.AdamW, with the learning rate set from the schedule at the
    optax count (the number of earlier updates) before each update.

    With cfg.bf16_momentum the first moment is kept in bf16, the second in
    f32, as optax's `scale_by_adam(mu_dtype=bfloat16)` keeps them; torch's
    AdamW keeps its state in the parameter's dtype, so this mode takes its
    own update (`_bf16_update`), which follows optax's order of operations.
    `opt` still holds the state and the param group, so state_dict and
    load_state_dict are torch's."""

    B1, B2, EPS = 0.9, 0.999, 1e-8

    def __init__(self, module: nn.Module, base_lr: float, cfg: TrainConfig):
        self.params: List[nn.Parameter] = list(module.parameters())
        self.schedule = cosine_warm_restarts(base_lr, cfg.scheduler_t0,
                                             cfg.min_lr)
        self.max_norm = cfg.max_grad_norm
        self.bf16_momentum = bool(getattr(cfg, "bf16_momentum", False))
        self.weight_decay = cfg.weight_decay
        self.opt = self._adamw(self.params, base_lr)
        # Under tensor / expert parallelism (`parallel/sharding.py`): which
        # of `params` are this rank's part of a split parameter, and the
        # model axis they are split over.
        self.split: List[bool] = [False] * len(self.params)
        self.axis: Optional[AxisGroup] = None

    def _adamw(self, params, lr: float) -> torch.optim.AdamW:
        return torch.optim.AdamW(params, lr=lr, betas=(self.B1, self.B2),
                                 eps=self.EPS, weight_decay=self.weight_decay)

    def over(self, module: nn.Module, moments: Dict[str, dict], *,
             split: Set[str] = frozenset(),
             axis: Optional[AxisGroup] = None) -> "ClippedAdamW":
        """This optimizer's settings over the parameters of `module` (its
        learning rate as it stands), with the AdamW state `moments` by
        parameter name; `split` names the parameters that are a rank's
        part of a split one, over `axis` (`shard_state`, `gather_state`)."""
        new = copy.copy(self)
        named = list(module.named_parameters())
        new.params = [p for _, p in named]
        new.opt = self._adamw(new.params, self.opt.param_groups[0]["lr"])
        for n, p in named:
            if moments.get(n):
                new.opt.state[p] = moments[n]
        new.split = [n in split for n, _ in named]
        new.axis = axis if any(new.split) else None
        return new

    def global_norm(self, grads: Sequence[torch.Tensor]) -> torch.Tensor:
        """The global norm of the gradients: under a split, the split
        parameters' sums of squares over every rank of the model axis,
        the replicated ones' counted once."""
        squares = [g.float().square().sum() for g in grads]
        if self.axis is None:
            return torch.stack(squares).sum().sqrt()
        whole = [s for s, part in zip(squares, self.split) if not part]
        parts = [s for s, part in zip(squares, self.split) if part]
        total = sum_over(torch.stack(parts).sum(), self.axis)
        if whole:
            total = torch.stack(whole).sum() + total
        return total.sqrt()

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
        norm = self.global_norm(grads)
        clip = norm >= self.max_norm
        for g in grads:
            g.copy_(torch.where(clip, (g / norm) * self.max_norm, g))
        for group in self.opt.param_groups:
            group["lr"] = self.schedule(count)
        if self.bf16_momentum:
            self._bf16_update()
        else:
            self.opt.step()
        return norm

    def _bf16_update(self) -> None:
        """optax's scale_by_adam(mu_dtype=bfloat16) -> add_decayed_weights
        -> scale_by_learning_rate, as the JAX package's jitted step computes
        it: the new first moment (1 - b1) g + b1 mu is f32 (b1 rounded to
        bf16, as JAX's weak-typed scalar is, the product not rounded), it
        drives the update unrounded and is stored rounded to bf16 (optax's
        `tree.cast` after the update). Un-jitted optax also rounds b1 mu to
        bf16 and differs in the last bit of some moments. A moment loaded
        from a checkpoint comes back in the parameter's dtype (torch's
        load_state_dict casts it) and holds bf16 values, so casting it back
        is exact."""
        group = self.opt.param_groups[0]
        lr, wd = np.float32(group["lr"]), group["weight_decay"]
        b1 = float(torch.tensor(self.B1, dtype=torch.bfloat16))
        for p in self.params:
            st = self.opt.state[p]
            if not st:
                st["step"] = torch.tensor(0.0)
                st["exp_avg"] = torch.zeros_like(p, dtype=torch.bfloat16)
                st["exp_avg_sq"] = torch.zeros_like(p)
            elif st["exp_avg"].dtype != torch.bfloat16:
                st["exp_avg"] = st["exp_avg"].to(torch.bfloat16)
            st["step"] += 1
            t = np.float32(st["step"].item())
            g, nu = p.grad, st["exp_avg_sq"]
            mu = g * (1 - self.B1) + st["exp_avg"].float() * b1
            nu.mul_(self.B2).add_(g * g * (1 - self.B2))
            mu_hat = mu / float(np.float32(1) - np.float32(self.B1) ** t)
            nu_hat = nu / float(np.float32(1) - np.float32(self.B2) ** t)
            upd = mu_hat / (nu_hat.sqrt() + self.EPS)
            p.add_((upd + wd * p) * float(-lr))
            st["exp_avg"].copy_(mu)


def make_optimizers(cfg: TrainConfig, vae: nn.Module, teacher: nn.Module
                    ) -> Tuple[ClippedAdamW, ClippedAdamW]:
    """The VAE's and the teacher's optimizers (train_hybrid.py:504-527 and
    the per-step clip at :913-914)."""
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
    # A rank's part of a state split over the model axis: the
    # `parallel.sharding.Layout` it was cut by (`shard_state`), else None.
    layout: Any = None


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
