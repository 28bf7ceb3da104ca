"""LR schedule (counterpart: lunaris_orion_tpu/train/schedule.py).

torch's CosineAnnealingWarmRestarts(T_0, T_mult=2, eta_min) as a closed
form of the optimizer-step count, stepped once per optimizer step as the
reference steps it (train_hybrid.py:516-527, 924-926).
"""

from __future__ import annotations

import math
from typing import Callable


def cosine_warm_restarts(base_lr: float, t0: int, eta_min: float = 0.0,
                         t_mult: int = 2) -> Callable[[int], float]:
    """Returns schedule(step) -> lr. For t_mult = 2 the cycle holding step t
    starts at t0 (2^n - 1) and lasts t0 2^n steps, n = floor(log2(t/t0 + 1)),
    found here in integers so that a restart lands exactly on its step."""
    if t_mult not in (1, 2):
        raise ValueError("closed form implemented for t_mult in {1, 2}")

    def schedule(step: int) -> float:
        if t_mult == 1:
            t_cur, cycle_len = step % t0, t0
        else:
            n = (step // t0 + 1).bit_length() - 1
            t_cur, cycle_len = step - t0 * (2**n - 1), t0 * 2**n
        cos = 0.5 * (1.0 + math.cos(math.pi * t_cur / cycle_len))
        return eta_min + (base_lr - eta_min) * cos

    return schedule
