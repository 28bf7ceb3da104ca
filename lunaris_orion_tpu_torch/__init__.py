"""lunaris_orion_tpu_torch -- the PyTorch and CUDA port of lunaris_orion_tpu,
for one NVIDIA H100.

The JAX package beside it is the reference: every module here is tested
against its counterpart there. This package imports torch and never jax.
From the JAX package it imports only framework-free modules:
`lunaris_orion_tpu.config`, `lunaris_orion_tpu.utils.image` and
`lunaris_orion_tpu.utils.torch_compat.train_config_from_reference_args`.

What is ported:
- the serving path of `lunaris-generate`: the VAE prior decode and the MoE
  teacher's scoring (`infer/generator.py`, `cli/generate.py`);
- the hybrid train step that `lunaris-train` runs (`train/step.py`
  `make_train_step`, with `train/{losses,schedule,state}.py`).
Their kernels are written by hand for Hopper (CUDA C++ in `csrc/`), each
beside its plain PyTorch version: GroupNorm+Mish (K1, `ops/cuda/gn_mish.py`),
flash attention forward and backward (K2, `ops/cuda/flash_attention.py`)
and the MSE+KL loss epilogue (K3, `ops/cuda/loss_epilogue.py`).
"""

__version__ = "0.1.0"

from lunaris_orion_tpu.config import (  # noqa: F401
    TeacherConfig,
    TrainConfig,
    VAEConfig,
)
