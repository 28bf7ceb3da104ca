"""Device memory capacity for the trainer's memory plan (counterpart of
lunaris_orion_tpu/utils/hbm.py `device_hbm_bytes`)."""

from __future__ import annotations

from typing import Optional

import torch


def device_memory_bytes(device: torch.device | str) -> Optional[int]:
    """Total bytes of a CUDA device (`torch.cuda.mem_get_info`); None for
    the CPU, which has no figure the plan could hold a step against."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return int(torch.cuda.mem_get_info(device)[1])
