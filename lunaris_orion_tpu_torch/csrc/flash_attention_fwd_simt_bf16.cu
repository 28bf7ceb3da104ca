// K2 forward -- the bf16 instances of the CUDA-core body `flash_fwd_simt`
// (flash_attention_fwd.cuh) at d 8 and 16: the bf16 path at d 8, and at d 16
// the earlier kernel that measurements hold the tensor-core body against
// (d 32, 48 and 64 in bf16 exist on the tensor cores only).

#include "flash_attention_fwd.cuh"

int lunaris_k2_fwd_simt_bf16(const LunarisK2FwdArgs& a, int d, cudaStream_t s) {
  return launch_simt_full<__nv_bfloat16>(a, d, s);
}
