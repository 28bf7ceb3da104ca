// K2 forward -- the instances at head size 32: the tensor-core body
// `flash_fwd_mma` for bf16 and the CUDA-core body `flash_fwd_simt` for f32
// (flash_attention_fwd.cuh), one instance each that tests dropout and
// raggedness at run time.

#include "flash_attention_fwd.cuh"

int lunaris_k2_fwd_d32(const LunarisK2FwdArgs& a, int is_bf16, int body,
                       cudaStream_t s) {
  constexpr int F = kLevelFull;
  if (is_bf16 && body == 1) return launch_mma<32, F, kDropRuntime, true>(a, s);
  if (!is_bf16 && body == 0)
    return launch_simt<float, 32, F, kDropRuntime, true>(a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
