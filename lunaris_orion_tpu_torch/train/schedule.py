"""LR schedule (counterpart: lunaris_orion_tpu/train/schedule.py).

torch's CosineAnnealingWarmRestarts(T_0, T_mult=2, eta_min) as a closed
form of the optimizer-step count, stepped once per optimizer step as the
reference steps it (train_hybrid.py:516-527, 924-926).
"""

from __future__ import annotations

import math
from typing import Callable, Dict


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


def torch_scheduler_state(base_lr: float, t0: int, eta_min: float,
                          count: int, *, t_mult: int = 2) -> Dict:
    """The state_dict of torch's CosineAnnealingWarmRestarts at optimizer
    step `count`, as the reference checkpoints it (train_hybrid.py:594-615;
    the port's own copy of lunaris_orion_tpu/utils/torch_compat.py
    `scheduler_to_torch_sd`). The port needs no scheduler object: the
    schedule is a closed form of the count."""
    if count <= 0:
        t_i, t_cur = t0, 0
    elif t_mult == 1:
        t_i, t_cur = t0, count % t0
    else:
        n = int(math.floor(math.log2(count / t0 + 1.0)))
        t_i = t0 * (t_mult ** n)
        t_cur = count - t0 * (t_mult ** n - 1)
    lr = eta_min + (base_lr - eta_min) * 0.5 * (
        1.0 + math.cos(math.pi * t_cur / t_i))
    return {"T_0": t0, "T_i": t_i, "T_mult": t_mult, "eta_min": eta_min,
            "base_lrs": [base_lr], "last_epoch": count, "T_cur": t_cur,
            "_step_count": count + 1, "_last_lr": [lr]}
