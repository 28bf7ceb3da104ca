// K2 backward -- one instance of the f32 fused warpgroup body
// `flash_bwd_wgmma_tf32` (flash_attention_bwd.cuh): f32 at head size 32,
// with dropout, on the tiles of the pre-pass (flash_attention_tf32_split.cu).
// Every Nq and Nk: zeros and -inf mask the rows past them.

#include "flash_attention_bwd.cuh"

int lunaris_k2_bwd_wgmma_tf32_d32_drop(const LunarisK2BwdArgs& a, const void* split,
                                  cudaStream_t s) {
  return launch_bwd_wgmma_tf32<32, kDropOn>(a, split, s);
}
