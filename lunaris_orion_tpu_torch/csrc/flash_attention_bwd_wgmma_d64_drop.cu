// K2 backward -- one instance of the fused warpgroup body `flash_bwd_wgmma`
// (flash_attention_bwd.cuh): bf16 at head size 64, with dropout compiled in.
// Every Nq and Nk: zeros and -inf mask the rows past them.

#include "flash_attention_bwd.cuh"

int lunaris_k2_bwd_wgmma_d64_drop(const LunarisK2BwdArgs& a, cudaStream_t s) {
  return launch_bwd_wgmma<64, kDropOn>(a, s);
}
