"""The (data, model) grid of ranks (counterpart:
lunaris_orion_tpu/parallel/mesh.py).

The JAX package lays its devices out as `np.asarray(devices).reshape(
mesh_shape)`; here each device is one `torch.distributed` rank and the
grid is the same row-major layout over the ranks: rank r sits at data
index r // M and model index r % M of a (D, M) mesh. Each rank gets two
process groups: its peers along the data axis (the ranks of its model
column, which hold different samples and average their gradients) and
along the model axis (the ranks of its data row, which hold the same
samples and split the teacher attention's tokens under context
parallelism, the bottleneck FC pair under tensor parallelism and the
teacher's experts under expert parallelism).

`init_mesh` starts the process group from the environment `torchrun`
sets (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT): NCCL on
cuda:LOCAL_RANK by default, gloo on the CPU when the caller asks for the
CPU.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from lunaris_orion_tpu_torch.device import resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"
AXES = (DATA_AXIS, MODEL_AXIS)
TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


@dataclass(frozen=True)
class AxisGroup:
    """One axis of the mesh as a rank sees it: the process group of its
    peers along the axis (`ranks`, global ranks in axis order), its own
    index on the axis and the axis size."""
    group: Any
    index: int
    size: int
    ranks: Tuple[int, ...]


@dataclass(frozen=True)
class Mesh:
    shape: Tuple[int, int]
    rank: int
    device: torch.device
    backend: str
    data: AxisGroup
    model: AxisGroup

    def axis(self, name: str) -> AxisGroup:
        if name not in AXES:
            raise ValueError(f"mesh axis must be one of {AXES}, got {name!r}")
        return self.data if name == DATA_AXIS else self.model

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def barrier(self) -> None:
        """Every rank of the world waits for all the others."""
        if self.backend == "nccl":
            dist.barrier(device_ids=[self.device.index])
        else:
            dist.barrier()

    def world_max(self, value: float) -> float:
        """The largest of every rank's `value` (a decision all ranks must
        take alike, such as the memory plan's)."""
        dev = self.device if self.backend == "nccl" else torch.device("cpu")
        t = torch.tensor([value], dtype=torch.float64, device=dev)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return float(t.item())


@dataclass(frozen=True)
class Parallel:
    """What the modules of a step read of the mesh. `data`: the axis the
    batch is split over (BatchNorm takes the global batch's moments, a
    random draw gives this rank the global draw's rows, the losses' batch
    statistics are global). `cp`: the axis the teacher attention's tokens
    are split over (context parallelism), or None. `cp_kernel` False runs
    the allgather mode without K2 (`--no-use_pallas`). `tp`: the axis the
    VAE's bottleneck FC pair is split over by latent column (tensor
    parallelism), `ep`: the axis the teacher's experts are split over
    (expert parallelism), each None where the state is not split so
    (`sharding.with_layout`, from the state's layout); under context
    parallelism the Trainer splits the FC pair and not the experts, as
    the JAX package does. `model`: the model axis when it
    is above 1; its ranks take the same samples, so what they compute
    alike is taken from its first rank."""
    data: Optional[AxisGroup] = None
    cp: Optional[AxisGroup] = None
    cp_kernel: bool = True
    tp: Optional[AxisGroup] = None
    ep: Optional[AxisGroup] = None
    model: Optional[AxisGroup] = None

    def b0(self, batch: int) -> int:
        """The first global batch row of a local batch of `batch` rows."""
        return 0 if self.data is None else self.data.index * batch


def make_mesh(mesh_shape: Optional[Sequence[int]] = None, *,
              device: torch.device | str = "cpu") -> Mesh:
    """The mesh over the initialised default process group. Default shape:
    (world_size, 1), every rank on the data axis. A shape whose product is
    not the world size raises. Every rank must call it (it creates one
    group for each data row and one for each model column, in one order on
    every rank)."""
    n, rank = dist.get_world_size(), dist.get_rank()
    shape = (n, 1) if mesh_shape is None else tuple(int(s) for s in mesh_shape)
    if len(shape) != 2 or math.prod(shape) != n:
        raise ValueError(f"mesh_shape {shape} does not lay out the "
                         f"{n} ranks of the world as (data, model)")
    # The JAX package's np.asarray(devices).reshape(mesh_shape), over ranks.
    ranks = np.arange(n).reshape(shape)
    mine = {}
    for name, lines in ((MODEL_AXIS, ranks), (DATA_AXIS, ranks.T)):
        for line in lines:
            members = tuple(int(r) for r in line)
            group = dist.new_group(list(members))
            if rank in members:
                mine[name] = AxisGroup(group, members.index(rank),
                                       len(members), members)
    return Mesh(shape, rank, torch.device(device), dist.get_backend(),
                mine[DATA_AXIS], mine[MODEL_AXIS])


def launched() -> bool:
    """True under `torchrun` (or any launcher that sets its environment)."""
    return all(k in os.environ for k in TORCHRUN_ENV)


def init_mesh(mesh_shape: Optional[Sequence[int]] = None, *,
              device: torch.device | str = "cuda",
              backend: Optional[str] = None) -> Mesh:
    """Start (or join) the default process group and build the mesh.

    `device` "cuda" takes cuda:LOCAL_RANK and NCCL; "cuda:N" takes that
    card; "cpu" takes gloo. No card with "cuda" raises, as
    `resolve_device` does. `backend` overrides the transport (gloo on
    CUDA tensors is for tests on one card: `parallel.collectives` stages
    what gloo has no CUDA form of through the host). Without an
    initialised group, the environment of `torchrun` is required."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        if not launched():
            raise RuntimeError(
                "a mesh needs a process group: run under torchrun "
                f"(it sets {', '.join(TORCHRUN_ENV)})")
        dist.init_process_group(
            backend or ("nccl" if dev.type == "cuda" else "gloo"),
            init_method="env://", rank=int(os.environ["RANK"]),
            world_size=int(os.environ["WORLD_SIZE"]))
    return make_mesh(mesh_shape, device=dev)


def close_mesh() -> None:
    """Destroy the default process group (and with it every axis group)."""
    if dist.is_initialized():
        dist.destroy_process_group()
