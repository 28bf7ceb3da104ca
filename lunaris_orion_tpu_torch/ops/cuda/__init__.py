"""Hand-written Hopper kernels (CUDA C++ in `lunaris_orion_tpu_torch/csrc`),
each beside its plain PyTorch version.

Importing these modules builds nothing: `_build.library()` compiles the
sources with nvcc at the first launch on a CUDA tensor."""
