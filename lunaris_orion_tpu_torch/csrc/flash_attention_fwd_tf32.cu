// K2 forward -- the instances of the f32 tensor-core body `flash_fwd_tf32`
// (flash_attention_fwd.cuh, three TF32 passes a product): the full chain at
// d 16 with dropout and raggedness compiled in (four instances), and at d 32,
// 48 and 64 one instance each that tests both at run time.

#include "flash_attention_fwd.cuh"

int lunaris_k2_fwd_tf32(const LunarisK2FwdArgs& a, int d, cudaStream_t s) {
  constexpr int F = kLevelFull;
  const bool ragged = a.Nk % tf32_block_k(16) != 0;
  switch (d) {
    case 16:
      if (a.use_dropout)
        return ragged ? launch_tf32<16, F, kDropOn, true>(a, s)
                      : launch_tf32<16, F, kDropOn, false>(a, s);
      return ragged ? launch_tf32<16, F, kDropOff, true>(a, s)
                    : launch_tf32<16, F, kDropOff, false>(a, s);
    case 32: return launch_tf32<32, F, kDropRuntime, true>(a, s);
    case 48: return launch_tf32<48, F, kDropRuntime, true>(a, s);
    case 64: return launch_tf32<64, F, kDropRuntime, true>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
