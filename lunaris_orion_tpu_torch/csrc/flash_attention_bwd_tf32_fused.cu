// K2 backward -- the instances of the f32 fused tensor-core body
// `flash_bwd_fused_tf32` (flash_attention_bwd.cuh, three TF32 passes a
// product): at d 16 with dropout and a ragged Nq compiled in (four
// instances), at d 32 one instance that tests both at run time.

#include "flash_attention_bwd.cuh"

int lunaris_k2_bwd_fused_tf32(const LunarisK2BwdArgs& a, int d,
                              cudaStream_t s) {
  switch (d) {
    case 16: {
      const bool ragged = a.Nq % bwd_tf32_tile(16) != 0;
      if (a.use_dropout)
        return ragged ? launch_fused_tf32<16, kDropOn, true>(a, s)
                      : launch_fused_tf32<16, kDropOn, false>(a, s);
      return ragged ? launch_fused_tf32<16, kDropOff, true>(a, s)
                    : launch_fused_tf32<16, kDropOff, false>(a, s);
    }
    case 32: return launch_fused_tf32<32, kDropRuntime, true>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
