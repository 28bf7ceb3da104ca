// K2 backward -- the f32 instances of the CUDA-core bodies `flash_bwd_dkv`
// (plain and with the fused dq) and `flash_bwd_dq` (flash_attention_bwd.cuh)
// at d 8 and 16: the f32 path (at d 16 the fused one is the earlier kernel
// that measurements hold the TF32 tensor-core body against).

#include "flash_attention_bwd.cuh"

int lunaris_k2_bwd_simt_f32(const LunarisK2BwdArgs& a, int d, int kernel,
                            cudaStream_t s) {
  switch (d) {
    case 8: return launch_simt<float, 8>(kernel, a, s);
    case 16: return launch_simt<float, 16>(kernel, a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
