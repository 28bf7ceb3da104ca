// K2 backward -- the tensor-core instances at head size 32 (bf16): the dk/dv
// body `flash_bwd_dkv_mma` alone and in its single-pass form with dq, and
// the dq body `flash_bwd_dq_mma` (flash_attention_bwd.cuh), one instance
// each that tests dropout and raggedness at run time.

#include "flash_attention_bwd.cuh"

int lunaris_k2_bwd_mma_bf16_d32(const LunarisK2BwdArgs& a, int kernel,
                                cudaStream_t s) {
  switch (kernel) {
    case kBwdDkv: return launch_dkv_mma<32, kDropRuntime, true>(a, s);
    case kBwdDkvFusedDq: return launch_dkv_mma<32, kDropRuntime, true, true>(a, s);
    case kBwdDq: return launch_dq_mma<32, kDropRuntime, true>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
