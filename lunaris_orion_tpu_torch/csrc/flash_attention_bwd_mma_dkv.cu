// K2 backward -- the instances of the tensor-core dk/dv body
// `flash_bwd_dkv_mma` (flash_attention_bwd.cuh) for bf16: at d 16 with
// dropout and a ragged Nq compiled in (four instances), at d 48 and 64 one
// instance each that tests both at run time.

#include "flash_attention_bwd.cuh"

int lunaris_k2_bwd_dkv_mma_bf16(const LunarisK2BwdArgs& a, int d,
                                cudaStream_t s) {
  const bool ragged = a.Nq % kBwdMmaTile != 0;
  switch (d) {
    case 16:
      if (a.use_dropout)
        return ragged ? launch_dkv_mma<16, kDropOn, true>(a, s)
                      : launch_dkv_mma<16, kDropOn, false>(a, s);
      return ragged ? launch_dkv_mma<16, kDropOff, true>(a, s)
                    : launch_dkv_mma<16, kDropOff, false>(a, s);
    case 48: return launch_dkv_mma<48, kDropRuntime, true>(a, s);
    case 64: return launch_dkv_mma<64, kDropRuntime, true>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
