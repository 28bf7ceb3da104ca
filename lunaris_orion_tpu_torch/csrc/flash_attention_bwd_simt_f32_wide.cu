// K2 backward -- the f32 instances of the CUDA-core bodies `flash_bwd_dkv`
// (plain and with the fused dq) and `flash_bwd_dq` (flash_attention_bwd.cuh)
// at d 48 and 64: the f32 path.

#include "flash_attention_bwd.cuh"

int lunaris_k2_bwd_simt_f32_wide(const LunarisK2BwdArgs& a, int d, int kernel,
                                 cudaStream_t s) {
  switch (d) {
    case 48: return launch_simt<float, 48>(kernel, a, s);
    case 64: return launch_simt<float, 64>(kernel, a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
