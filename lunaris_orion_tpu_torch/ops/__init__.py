"""Tensor operations of the port: activations, layers, attention, and the
hand-written CUDA kernels under `ops/cuda`."""
