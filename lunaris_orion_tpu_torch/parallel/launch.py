"""Start N ranks on this host in the environment `torchrun` gives them
(RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT), with
`torch.multiprocessing.spawn`: the tests' gloo ranks on the CPU and the
smoke run's two ranks on one card. A rank that raises ends the others and
raises in the caller."""

from __future__ import annotations

import os
import socket
from typing import Callable, Sequence

import torch.multiprocessing as mp


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _entry(rank: int, fn: Callable, world: int, port: int,
           args: Sequence) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    fn(rank, *args)


def spawn(fn: Callable, nprocs: int, args: Sequence = ()) -> None:
    """Run fn(rank, *args) in `nprocs` new processes and wait for all of
    them. `fn` must be importable by name (a module-level function)."""
    mp.spawn(_entry, args=(fn, nprocs, free_port(), tuple(args)),
             nprocs=nprocs, join=True)
