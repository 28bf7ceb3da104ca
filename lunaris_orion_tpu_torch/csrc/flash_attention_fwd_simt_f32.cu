// K2 forward -- the f32 instances of the CUDA-core body `flash_fwd_simt`
// (flash_attention_fwd.cuh) at d 8 and 16: the f32 path at d 8, and at d 16
// the earlier kernel that measurements hold the TF32 tensor-core body against.

#include "flash_attention_fwd.cuh"

int lunaris_k2_fwd_simt_f32(const LunarisK2FwdArgs& a, int d, cudaStream_t s) {
  return launch_simt_full<float>(a, d, s);
}
