"""Tensor and expert parallelism: which part of each parameter, buffer and
AdamW moment a rank of the model axis holds (counterpart:
lunaris_orion_tpu/parallel/sharding.py).

The JAX package's placement plan, over the port's parameter names (the
PyTorch reference's, `encoder.fc_mu.weight`, `experts.{e}.{layer}.*`,
`quality_heads.{e}.*`, ...):
  * TP: the VAE's bottleneck FC pair. `fc_mu` / `fc_logvar` are split by
    latent column: their `nn.Linear` weight [latent, bottleneck] (the
    transpose of the JAX `w`) on dim 0, their bias on dim 0. The decoder's
    `fc` weight [bottleneck, latent] is split on dim 1 (latent rows of the
    JAX `w`); its bias stays whole. z stays split between the two, so only
    the latent activations and one sum of the decoder FC's partial
    outputs cross ranks. Needs latent % M == 0.
  * EP: the teacher's experts. The JAX package stacks them on a leading
    axis [E, ...]; here they are a `ModuleList` of E modules, so model rank
    m owns the experts [m E/M, (m+1) E/M) whole: their parameters, their
    quality heads and their BatchNorm buffers. A rank's teacher holds
    None in place of the other ranks' experts and heads, so its
    state_dict keeps the global names. Needs E % M == 0 and
    `shard_experts` (off under context parallelism, whose tokens take the
    model axis, as in the JAX package).
A split that does not divide falls back to replicated, as the JAX rule
does. AdamW's moments follow their parameter.

`shard_state` takes a full `TrainState` to one rank's; `gather_state`
takes a rank's back to the full one on the host (the checkpoints': every
rank of the model axis calls it, and each gets the full state). The
state's `layout` is the one record of how it is split: the steps read
their tensor / expert axes from it (`with_layout`).
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, Optional, Tuple, Union

import torch
import torch.nn as nn

from lunaris_orion_tpu_torch.parallel.collectives import (broadcast_,
                                                         gather_over)
from lunaris_orion_tpu_torch.parallel.mesh import AxisGroup, Mesh, Parallel

# param_spec's value for a leaf of one expert: it lies whole on the rank
# that owns the expert.
EXPERT = "expert"
Spec = Union[None, int, str]

_EXPERT_LISTS = ("experts", "quality_heads")
_HOST = torch.device("cpu")
_TP_ROWS = ("fc_mu.weight", "fc_logvar.weight", "fc_mu.bias",
            "fc_logvar.bias")
_TP_COLS = ("decoder.fc.weight",)


def expert_index(name: str) -> Optional[int]:
    """The expert a leaf belongs to (`experts.{e}.*`, `quality_heads.{e}.*`,
    with or without a prefix), or None."""
    parts = name.split(".")
    for i, part in enumerate(parts[:-1]):
        if part in _EXPERT_LISTS and parts[i + 1].isdigit():
            return int(parts[i + 1])
    return None


def _named(name: str, suffixes) -> bool:
    return any(name == s or name.endswith("." + s) for s in suffixes)


def param_spec(name: str, tensor: torch.Tensor, *, model_size: int,
               num_experts: int, latent_dim: int,
               shard_experts: bool = True) -> Spec:
    """The split of one parameter, buffer or moment over the model axis:
    the dimension split into `model_size` equal parts (TP), EXPERT (the
    leaf of one expert, held whole by the rank that owns the expert: EP),
    or None (replicated). The JAX rule's conditions: nothing splits on a
    model axis of 1; experts split when `shard_experts` and E % M == 0;
    the FC pair when latent % M == 0 and the leaf's latent dimension is
    `latent_dim`. Unlike the JAX rule, an expert's 0-d leaves (BatchNorm's
    `num_batches_tracked`, which the JAX package does not keep) go with
    their expert."""
    shape = tuple(tensor.shape)
    if model_size <= 1:
        return None
    if (shard_experts and expert_index(name) is not None
            and num_experts % model_size == 0):
        return EXPERT
    if latent_dim % model_size == 0:
        if _named(name, _TP_ROWS) and shape and shape[0] == latent_dim:
            return 0
        if _named(name, _TP_COLS) and len(shape) == 2 \
                and shape[1] == latent_dim:
            return 1
    return None


def split_axes(model: AxisGroup, *, num_experts: int, latent_dim: int,
               shard_experts: bool = True
               ) -> Tuple[Optional[AxisGroup], Optional[AxisGroup]]:
    """(tp, ep): the model axis where the FC pair, and where the experts,
    split over it by `param_spec`'s rule; None where they stay whole."""
    if model.size <= 1:
        return None, None
    tp = model if latent_dim % model.size == 0 else None
    ep = model if shard_experts and num_experts % model.size == 0 else None
    return tp, ep


@dataclass(frozen=True)
class Layout:
    """How a rank's state is split: over `axis` (the model axis), by
    `param_spec` with these sizes."""
    axis: AxisGroup
    num_experts: int
    latent_dim: int
    shard_experts: bool

    def _split(self) -> Tuple[Optional[AxisGroup], Optional[AxisGroup]]:
        return split_axes(self.axis, num_experts=self.num_experts,
                          latent_dim=self.latent_dim,
                          shard_experts=self.shard_experts)

    @property
    def tp(self) -> Optional[AxisGroup]:
        """The axis the FC pair splits over, or None (`split_axes`)."""
        return self._split()[0]

    @property
    def ep(self) -> Optional[AxisGroup]:
        """The axis the experts split over, or None (`split_axes`)."""
        return self._split()[1]

    def spec(self, name: str, tensor: torch.Tensor) -> Spec:
        return param_spec(name, tensor, model_size=self.axis.size,
                          num_experts=self.num_experts,
                          latent_dim=self.latent_dim,
                          shard_experts=self.shard_experts)

    def owner(self, expert: int) -> int:
        """The model-axis index of the rank that owns `expert`."""
        return expert // (self.num_experts // self.axis.size)

    def part(self, name: str, full: torch.Tensor) -> Optional[torch.Tensor]:
        """This rank's part of the full tensor `name` (a view), or None
        when it is another rank's expert's."""
        spec = self.spec(name, full)
        if spec == EXPERT:
            return (full if self.owner(expert_index(name)) == self.axis.index
                    else None)
        if spec is None:
            return full
        per = full.shape[spec] // self.axis.size
        return full.narrow(spec, self.axis.index * per, per)


def layout_for(mesh: Mesh, *, num_experts: int, latent_dim: int,
               shard_experts: bool = True) -> Optional[Layout]:
    """The layout of a state on `mesh`, or None when nothing splits."""
    tp, ep = split_axes(mesh.model, num_experts=num_experts,
                        latent_dim=latent_dim, shard_experts=shard_experts)
    if tp is None and ep is None:
        return None
    return Layout(mesh.model, num_experts, latent_dim, shard_experts)


def with_layout(par: Optional[Parallel], layout: Optional[Layout]
                ) -> Optional[Parallel]:
    """The axes a step reads for a state split by `layout` (the state's
    own, `shard_state`): `par` with its `tp` / `ep` set where the state is
    split, and None where it is whole."""
    if par is None:
        return None
    return dataclasses.replace(par, tp=layout and layout.tp,
                               ep=layout and layout.ep)


def _set_param(module: nn.Module, name: str, value: torch.Tensor) -> None:
    owner, _, leaf = name.rpartition(".")
    setattr(module.get_submodule(owner), leaf,
            nn.Parameter(value, requires_grad=True))


def _moment_part(layout: Layout, name: str, st: dict) -> dict:
    """A parameter's AdamW state cut like the parameter (the 0-d step
    count stays)."""
    return {k: (layout.part(name, v).clone()
                if torch.is_tensor(v) and v.dim() else v)
            for k, v in st.items()}


def _shard_model(module: nn.Module, opt, layout: Layout):
    """Cut one model and its optimizer to this rank's part, in place of
    the model; returns the new optimizer."""
    moments = {n: opt.opt.state.get(p) for n, p in module.named_parameters()}
    split = {n for n, p in module.named_parameters()
             if layout.spec(n, p) is not None}
    for attr in _EXPERT_LISTS:
        experts = getattr(module, attr, None)
        if experts is not None and layout.ep:
            for e in range(len(experts)):
                if layout.owner(e) != layout.axis.index:
                    experts[e] = None
    for name, p in list(module.named_parameters()):
        if isinstance(layout.spec(name, p), int):
            _set_param(module, name, layout.part(name, p.detach()).clone())
    own = {n: _moment_part(layout, n, moments[n])
           for n, _ in module.named_parameters() if moments[n]}
    return opt.over(module, own, split=split, axis=layout.axis)


def shard_state(state, mesh: Mesh, *, shard_experts: bool = True):
    """Cut a full TrainState (every rank of the model axis holds the same
    one) to this rank's part, in place, and return it: the split
    parameters, their moments and the owned experts' buffers. Nothing
    changes where nothing splits (`layout_for` None)."""
    if getattr(state, "layout", None) is not None:
        raise ValueError("shard_state: the state is already split")
    layout = layout_for(mesh, num_experts=state.teacher.cfg.num_experts,
                        latent_dim=state.vae.cfg.latent_dim,
                        shard_experts=shard_experts)
    if layout is None:
        return state
    state.vae_opt = _shard_model(state.vae, state.vae_opt, layout)
    state.teacher_opt = _shard_model(state.teacher, state.teacher_opt, layout)
    state.layout = layout
    return state


def _gather_model(local: nn.Module, opt, full: nn.Module, layout: Layout):
    """The full model (`full`, a fresh module of the same config on the
    host, filled in place) and its optimizer from every rank's part. Each
    tensor is gathered on the rank's device and moved to the host at
    once, so the device holds one full tensor (or one expert) at a time."""
    axis = layout.axis
    mine = local.state_dict()
    local_params = dict(local.named_parameters())
    moments = {n: opt.opt.state.get(p) or {} for n, p in local_params.items()}
    held = [st for st in moments.values() if st]   # alike on every rank
    step = held[0]["step"] if held else None
    mu_dtype = held[0]["exp_avg"].dtype if held else None
    params = dict(full.named_parameters())
    out: Dict[str, torch.Tensor] = {}
    out_m: Dict[str, dict] = {n: {} for n in params} if held else {}
    experts = defaultdict(list)        # expert -> [(dict, key, name, like)]
    for name, like in full.state_dict().items():
        entries = [(out, name, like)]
        if held and name in params:
            st = out_m[name]
            st["step"] = step.to(_HOST, copy=True)
            entries += [(st, "exp_avg", like.to(mu_dtype)),
                        (st, "exp_avg_sq", like)]
        spec = layout.spec(name, like)
        for target, key, proto in entries:
            src = (mine.get(name) if target is out
                   else moments.get(name, {}).get(key))
            if spec == EXPERT:
                experts[expert_index(name)].append((target, key, src, proto))
            elif spec is None:
                target[key] = src.detach().to(_HOST, copy=True)
            else:
                target[key] = gather_over(src, axis, spec).to(_HOST)
    dev = next(local.parameters()).device
    for e in sorted(experts):
        own = layout.owner(e) == axis.index
        tensors = [src.detach().clone() if own
                   else torch.empty_like(proto, device=dev)
                   for _, _, src, proto in experts[e]]
        broadcast_(tensors, axis, src=layout.owner(e))
        for (target, key, _, _), t in zip(experts[e], tensors):
            target[key] = t.to(_HOST)
    full.load_state_dict(out, strict=True)
    return full, opt.over(full, out_m)


def gather_state(state, mesh: Optional[Mesh] = None):
    """The full TrainState from this rank's part (every rank of the model
    axis calls it and gets the same full state, in new models and
    optimizers on the host, so a save never holds the whole state on the
    device); the state itself when it is not split. `mesh` must be the
    one it was split over."""
    layout = getattr(state, "layout", None)
    if layout is None:
        return state
    if mesh is not None and mesh.model.ranks != layout.axis.ranks:
        raise ValueError("gather_state: the state was split over another "
                         "model axis")
    from lunaris_orion_tpu_torch.models.teacher import LunarMoETeacher
    from lunaris_orion_tpu_torch.models.vae import LunarisCoreVAE
    with torch.device(_HOST):
        vae = LunarisCoreVAE(state.vae.cfg)
        teacher = LunarMoETeacher(state.teacher.cfg)
    vae, vae_opt = _gather_model(state.vae, state.vae_opt, vae, layout)
    teacher, teacher_opt = _gather_model(state.teacher, state.teacher_opt,
                                         teacher, layout)
    return dataclasses.replace(state, vae=vae, teacher=teacher,
                               vae_opt=vae_opt, teacher_opt=teacher_opt,
                               layout=None)
