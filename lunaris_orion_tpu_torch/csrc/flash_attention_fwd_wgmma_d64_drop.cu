// K2 forward -- one instance of the warpgroup body `flash_fwd_wgmma`
// (flash_attention_fwd.cuh): bf16 at head size 64, with dropout compiled in.
// Every Nk: the bias masks the keys past it.

#include "flash_attention_fwd.cuh"

int lunaris_k2_fwd_wgmma_d64_drop(const LunarisK2FwdArgs& a, cudaStream_t s) {
  return launch_wgmma<64, kDropOn>(a, s);
}
