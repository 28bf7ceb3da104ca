// K2 backward -- one instance of the narrow fused warpgroup body
// `flash_bwd_wgmma_narrow` (flash_attention_bwd.cuh): bf16 at head size 32,
// without dropout. Every Nq and Nk: zeros and -inf mask the rows past them.

#include "flash_attention_bwd.cuh"

int lunaris_k2_bwd_wgmma_d32(const LunarisK2BwdArgs& a, cudaStream_t s) {
  return launch_bwd_wgmma_narrow<32, kDropOff>(a, s);
}
