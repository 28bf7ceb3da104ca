// K2 backward -- the instances of the tensor-core body `flash_bwd_dkv_mma`
// (flash_attention_bwd.cuh) in its single-pass form, which also adds dq, for
// bf16 at d 16, with dropout and a ragged Nq compiled in (four instances).
// d 32 is in flash_attention_bwd_mma_d32.cu; at d 48 and 64 the dk/dv body
// alone fills the registers (238 and 255), so the fused form there is the
// warpgroup body (flash_attention_bwd_wgmma_d*.cu).

#include "flash_attention_bwd.cuh"

int lunaris_k2_bwd_fused_mma_bf16(const LunarisK2BwdArgs& a, int d,
                                  cudaStream_t s) {
  if (d != 16) return static_cast<int>(cudaErrorInvalidValue);
  const bool ragged = a.Nq % kBwdMmaTile != 0;
  if (a.use_dropout)
    return ragged ? launch_dkv_mma<16, kDropOn, true, true>(a, s)
                  : launch_dkv_mma<16, kDropOn, false, true>(a, s);
  return ragged ? launch_dkv_mma<16, kDropOff, true, true>(a, s)
                : launch_dkv_mma<16, kDropOff, false, true>(a, s);
}
