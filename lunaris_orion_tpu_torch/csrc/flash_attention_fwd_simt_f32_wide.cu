// K2 forward -- the f32 instances of the CUDA-core body `flash_fwd_simt`
// (flash_attention_fwd.cuh) at d 48 and 64: the earlier kernels that
// measurements hold the TF32 tensor-core body against.

#include "flash_attention_fwd.cuh"

int lunaris_k2_fwd_simt_f32_wide(const LunarisK2FwdArgs& a, int d,
                                 cudaStream_t s) {
  return launch_simt_full_wide<float>(a, d, s);
}
