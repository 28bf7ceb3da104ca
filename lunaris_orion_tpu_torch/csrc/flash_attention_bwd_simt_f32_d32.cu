// K2 backward -- the f32 instances of the CUDA-core bodies `flash_bwd_dkv`
// (plain and with the fused dq) and `flash_bwd_dq` (flash_attention_bwd.cuh)
// at head size 32: the f32 split path (the fused one is the earlier kernel
// that measurements hold the TF32 tensor-core body against).

#include "flash_attention_bwd.cuh"

int lunaris_k2_bwd_simt_f32_d32(const LunarisK2BwdArgs& a, int kernel,
                                cudaStream_t s) {
  return launch_simt<float, 32>(kernel, a, s);
}
