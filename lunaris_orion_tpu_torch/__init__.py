"""lunaris_orion_tpu_torch -- the PyTorch and CUDA port of lunaris_orion_tpu,
for one NVIDIA H100.

The JAX package beside it is the reference: every module here is tested
against its counterpart there. This package imports torch, never jax, and
nothing of the JAX package: it keeps its own copies of the configuration
dataclasses (`config.py`) and the PNG helpers (`utils/image.py`).

What is ported:
- the serving path of `lunaris-generate`: the VAE prior decode and the MoE
  teacher's scoring (`infer/generator.py`, `cli/generate.py`);
- the hybrid train step that `lunaris-train` runs (`train/step.py`
  `make_train_step`, with `train/{losses,schedule,state}.py`).
Their kernels are written by hand for Hopper (CUDA C++ in `csrc/`), each
beside its plain PyTorch version: GroupNorm+Mish (K1, `ops/cuda/gn_mish.py`),
flash attention forward and backward (K2, `ops/cuda/flash_attention.py`)
and the MSE+KL loss epilogue (K3, `ops/cuda/loss_epilogue.py`);
- the three measurement tools of the kernels (`tools/attn_roofline.py`,
  `tools/gn_stats.py`, `tools/fusion_overlap.py`) with the kernels only they
  reach: the K2 forward cut after a named softmax stage
  (`ops/cuda/flash_attention_stages.py`), the GroupNorm lane sums from
  per-tile partials (`ops/cuda/gn_stats.py`) and GN-apply+Mish+conv3x3 (K5,
  `ops/cuda/fused_stage.py`).
"""

__version__ = "0.1.0"

from lunaris_orion_tpu_torch.config import (  # noqa: F401
    TeacherConfig,
    TrainConfig,
    VAEConfig,
)
