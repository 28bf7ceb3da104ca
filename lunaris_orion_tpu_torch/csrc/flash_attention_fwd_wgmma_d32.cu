// K2 forward -- one instance of the narrow warpgroup body
// `flash_fwd_wgmma_narrow` (flash_attention_fwd.cuh): bf16 at head size 32,
// without dropout. Every Nk: the bias masks the keys past it.

#include "flash_attention_fwd.cuh"

int lunaris_k2_fwd_wgmma_d32(const LunarisK2FwdArgs& a, cudaStream_t s) {
  return launch_wgmma_narrow<32, kDropOff>(a, s);
}
