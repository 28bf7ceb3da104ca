// K2 forward -- one instance of the f32 warpgroup body `flash_fwd_wgmma_tf32`
// (flash_attention_fwd.cuh): f32 at head size 32, with dropout, on the key
// tiles of the pre-pass (flash_attention_tf32_split.cu). Every Nk: the bias
// masks the keys past it.

#include "flash_attention_fwd.cuh"

int lunaris_k2_fwd_wgmma_tf32_d32_drop(const LunarisK2FwdArgs& a, const void* split,
                                  cudaStream_t s) {
  return launch_wgmma_tf32<32, kDropOn>(a, split, s);
}
