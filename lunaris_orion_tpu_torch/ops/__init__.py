"""Tensor operations of the port: activations, layers, attention, and the
hand-written CUDA kernels under `ops/cuda`. Importing this package
registers K1 and the K2 forward as `torch.library` operators
(`ops/library.py`)."""

from lunaris_orion_tpu_torch.ops import library  # noqa: F401
