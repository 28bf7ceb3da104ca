// K2 backward -- the bf16 instances of the CUDA-core bodies
// (flash_attention_bwd.cuh): all three kernels at d 8 (the bf16 path there)
// and at d 16 (the earlier kernels that measurements hold the tensor-core
// bodies against), and `flash_bwd_dkv` with the fused dq at d 48 and 64, the
// earlier kernel that measurements hold the fused warpgroup body
// (flash_bwd_wgmma) against. d 32 in bf16 exists on the tensor cores only.

#include "flash_attention_bwd.cuh"

int lunaris_k2_bwd_simt_bf16(const LunarisK2BwdArgs& a, int d, int kernel,
                             cudaStream_t s) {
  using bf16 = __nv_bfloat16;
  switch (d) {
    case 8: return launch_simt<bf16, 8>(kernel, a, s);
    case 16: return launch_simt<bf16, 16>(kernel, a, s);
    case 48:
      if (kernel == kBwdDkvFusedDq) return launch_dkv<bf16, 48, true>(a, s);
      break;
    case 64:
      if (kernel == kBwdDkvFusedDq) return launch_dkv<bf16, 64, true>(a, s);
      break;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
