"""Timing for the measurement tools: CUDA events around warmed runs on a
card, the host clock on the CPU (where a time says nothing about the card
and only shows that the tool runs)."""

from __future__ import annotations

import statistics
import subprocess
import time
from typing import Callable

import torch


def time_ms(fn: Callable[[], object], device: torch.device | str,
            reps: int = 10, warmup: int = 2) -> float:
    """Median milliseconds of `reps` runs of fn() after `warmup` runs."""
    device = torch.device(device)
    for _ in range(warmup):
        fn()
    times = []
    if device.type != "cuda":
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)
    torch.cuda.synchronize(device)
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def card_line(device: torch.device | str) -> str:
    """What the numbers were taken on: for a CUDA device the line that
    `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` prints
    (the card's name and power limit), else "cpu (host clock)"."""
    if torch.device(device).type != "cuda":
        return "cpu (host clock)"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[torch.device(device).index or 0]
