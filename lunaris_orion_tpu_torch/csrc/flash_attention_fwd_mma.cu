// K2 forward -- the instances of the tensor-core body `flash_fwd_mma`
// (flash_attention_fwd.cuh) for bf16: the full chain at d 16 with dropout and
// raggedness compiled in (four instances), and at d 48 and 64 one instance
// each that tests both at run time.

#include "flash_attention_fwd.cuh"

int lunaris_k2_fwd_mma_bf16(const LunarisK2FwdArgs& a, int d, cudaStream_t s) {
  constexpr int F = kLevelFull;
  const bool ragged = a.Nk % kMmaBK != 0;
  switch (d) {
    case 16:
      if (a.use_dropout)
        return ragged ? launch_mma<16, F, kDropOn, true>(a, s)
                      : launch_mma<16, F, kDropOn, false>(a, s);
      return ragged ? launch_mma<16, F, kDropOff, true>(a, s)
                    : launch_mma<16, F, kDropOff, false>(a, s);
    case 48: return launch_mma<48, F, kDropRuntime, true>(a, s);
    case 64: return launch_mma<64, F, kDropRuntime, true>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
