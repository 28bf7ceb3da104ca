// K2 forward -- the C entry point of the flash-attention forward, for Hopper
// (sm_90a). The kernels are in flash_attention_fwd.cuh, which says what they
// replace, what bounds them and what their design does about it; their
// instances are compiled one translation unit a body and type
// (flash_attention_fwd_mma.cu, flash_attention_fwd_simt_{f32,bf16}.cu, and
// flash_attention_fwd_simt_f32_wide.cu for d 48 and 64), so that the
// compilers run side by side.

#include "flash_attention_fwd.cuh"

// q: [BH, Nq, d]; k, v: [BH, Nk, d]; f32 (is_bf16 = 0) or bf16 (is_bf16 = 1),
// contiguous. bias: [H, Nk] f32. o: [BH, Nq, d] in the input type;
// lse: [BH, Nq] f32. scale: d^-1/2 already rounded to the input type.
// threshold: the uint32 keep threshold, inv_keep: f32(1 / (1 - rate)).
// body: 1 the tensor-core kernel (bf16 at d 16, 48 or 64), 0 the CUDA-core
// kernel (f32 at d 8, 16, 48 or 64; bf16 at d 8 or 16). The caller chooses;
// nothing here falls from one to the other.
// Returns the cudaError_t of the launch.
extern "C" int lunaris_flash_attention_fwd(
    const void* q, const void* k, const void* v, const void* bias, void* o,
    void* lse, int BH, int H, int Nq, int Nk, int d, float scale,
    int use_dropout, unsigned int threshold, float inv_keep,
    unsigned int seed, int q_offset, int row_offset, int is_bf16, int body,
    void* stream) {
  if (BH <= 0 || H <= 0 || Nq <= 0 || Nk <= 0 || BH > 65535 ||
      (body != 0 && body != 1) || (body == 1 && !is_bf16))
    return static_cast<int>(cudaErrorInvalidValue);
  const LunarisK2FwdArgs a{q, k, v, static_cast<const float*>(bias), o,
                           static_cast<float*>(lse), BH, H, Nq, Nk, scale,
                           use_dropout, threshold, inv_keep, seed, q_offset,
                           row_offset};
  auto s = static_cast<cudaStream_t>(stream);
  if (body == 1) return lunaris_k2_fwd_mma_bf16(a, d, s);
  if (d <= 16)
    return is_bf16 ? lunaris_k2_fwd_simt_bf16(a, d, s)
                   : lunaris_k2_fwd_simt_f32(a, d, s);
  return is_bf16 ? static_cast<int>(cudaErrorInvalidValue)
                 : lunaris_k2_fwd_simt_f32_wide(a, d, s);
}
