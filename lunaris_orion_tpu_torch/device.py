"""Device selection. A request for CUDA without a card raises: the port
never falls back to the CPU on its own."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """torch.device for "cuda" (or "cuda:N") or "cpu"; raises RuntimeError
    when CUDA is asked for and torch sees no card."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but torch.cuda."
                "is_available() is False; pass --device cpu (device='cpu') "
                "to run the plain PyTorch versions on the CPU")
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"unsupported device {str(device)!r}: use 'cuda' or 'cpu'")
