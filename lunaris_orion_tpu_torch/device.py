"""Device selection and the f32 policy. A request for CUDA without a card
raises: the port never falls back to the CPU on its own."""

from __future__ import annotations

import contextlib

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


@contextlib.contextmanager
def full_f32():
    """TF32 off for cuDNN convolutions and CUDA matrix products, restored
    on exit: the full-f32 policy of decoding and scoring. The flags govern
    PyTorch's own operators; K2's f32 products are three TF32 passes each,
    held at f32's bars, whatever they say."""
    conv, mm = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = conv
        torch.backends.cuda.matmul.allow_tf32 = mm
