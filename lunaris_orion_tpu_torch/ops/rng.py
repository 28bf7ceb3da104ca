"""Random draws of a train-mode call, from one host `torch.Generator`
(counterpart of the JAX package's key splitting, `models/teacher.py`
`_Rng`).

Every draw starts from a fresh seed taken from the host generator: no draw
waits for the device, and a draw made from a seed can be made again. A
checkpointed (remat) region takes its seeds before it runs, so the backward
replays it with the same dropout masks and the same K2 seed.

torch and jax.random give different numbers from the same seed; the tests
compare the two packages with dropout off, or hand both the same noise.
"""

from __future__ import annotations

import torch


def new_seed(host: torch.Generator) -> int:
    """A fresh 63-bit seed from a CPU generator (a device generator would
    make the host wait for the device)."""
    if host.device.type != "cpu":
        raise ValueError("seeds come from a CPU torch.Generator")
    return int(torch.randint(0, 2**63 - 1, (), generator=host))


def device_generator(seed: int, device: torch.device) -> torch.Generator:
    """A generator on `device` seeded with `seed`."""
    return torch.Generator(device=device).manual_seed(seed)


def int32_seed(seed: int) -> int:
    """An int32 seed for K2's dropout hash, in [0, 2**31 - 1) as the JAX
    package draws it (`jax.random.randint(rng, (), 0, 2**31 - 1)`)."""
    return seed % (2**31 - 1)
