"""K1 and the K2 forward as `torch.library` operators, so that a traced,
serialized program (`torch.export`, `infer/exporter.py`) calls the
hand-written kernels: the counterpart of the Mosaic custom calls that a
JAX Pallas export embeds.

    lunaris_orion::gn_mish(x, weight, bias, groups, eps) -> y
        K1 (`ops/cuda/gn_mish.py`): pass 1, then the apply with the fold.
    lunaris_orion::flash_attention_fwd(q, k, v, bias, q_offset, row_offset)
        -> (o, lse)
        the K2 forward (`ops/cuda/flash_attention.py`) at dropout 0.

Each operator has three implementations:
  CUDA  the wrapper's one launch function (`gn_mish._kernel`,
        `flash_attention.forward_kernel`), which counts the launch;
  CPU   the kernel's plain twin (`gn_mish_plain`, `attention_plain`), as
        every wrapper of the port runs a CPU tensor;
  fake  the output's shape, dtype and strides, as the kernel allocates
        them: K1 a tensor like x (contiguous NHWC); K2 o like q and lse f32
        [B*H, Nq]. `torch.export` traces through it.
No other device has an implementation: the dispatcher raises.

The registration is a `torch.library.Library("lunaris_orion", "DEF")`
with a kernel a dispatch key, not `torch.library.custom_op`: the same
operators without custom_op's Python layer on each call (K1 at the main
path's sizes is host-bound; `chip_smoke.py` phase 3 times the two
registrations against the bare launch). The operators have no autograd
formula: `gn_mish.gn_mish` and `flash_attention.flash_attention` call them
inside their `autograd.Function`s, whose backwards are unchanged, and
directly when no gradient is recorded.

Importing `lunaris_orion_tpu_torch.ops` (any module of it) registers the
operators; the kernels build at the first launch on a CUDA tensor. A
program exported with them loads only in a process that has imported this
module first.
"""

from __future__ import annotations

import torch

from lunaris_orion_tpu_torch.ops.cuda import flash_attention as k2
from lunaris_orion_tpu_torch.ops.cuda import gn_mish as k1

NAMESPACE = "lunaris_orion"

_LIB = torch.library.Library(NAMESPACE, "DEF")
_LIB.define("gn_mish(Tensor x, Tensor weight, Tensor bias, int groups, "
            "float eps) -> Tensor")
_LIB.define("flash_attention_fwd(Tensor q, Tensor k, Tensor v, Tensor bias, "
            "int q_offset, int row_offset) -> (Tensor, Tensor)")


def _gn_mish_cuda(x, weight, bias, groups, eps):
    return k1._kernel(x, weight, bias, groups, eps)


def _gn_mish_cpu(x, weight, bias, groups, eps):
    return k1.gn_mish_plain(x, weight, bias, groups=groups, eps=eps)


def _gn_mish_fake(x, weight, bias, groups, eps):
    return torch.empty_like(x)


def _flash_fwd_cuda(q, k, v, bias, q_offset, row_offset):
    return k2.forward_kernel(q, k, v, bias, q_offset=q_offset,
                             row_offset=row_offset)


def _flash_fwd_cpu(q, k, v, bias, q_offset, row_offset):
    return k2.attention_plain(q, k, v, bias, q_offset=q_offset,
                              row_offset=row_offset)


def _flash_fwd_fake(q, k, v, bias, q_offset, row_offset):
    b, h, nq, _ = q.shape
    return torch.empty_like(q), q.new_empty((b * h, nq), dtype=torch.float32)


for _name, _cuda, _cpu, _fake in (
        ("gn_mish", _gn_mish_cuda, _gn_mish_cpu, _gn_mish_fake),
        ("flash_attention_fwd", _flash_fwd_cuda, _flash_fwd_cpu,
         _flash_fwd_fake)):
    _LIB.impl(_name, _cuda, "CUDA")
    _LIB.impl(_name, _cpu, "CPU")
    torch.library.register_fake(f"{NAMESPACE}::{_name}", _fake, lib=_LIB)

gn_mish = torch.ops.lunaris_orion.gn_mish.default
flash_attention_fwd = torch.ops.lunaris_orion.flash_attention_fwd.default
