// K2 backward -- the C entry point of the flash-attention backward, for
// Hopper (sm_90a). The kernels are in flash_attention_bwd.cuh, which says
// what they replace, what bounds them and what their design does about it;
// their instances are compiled one translation unit a body, type and kernel
// (flash_attention_bwd_mma_{dkv,dq,fused}.cu, flash_attention_bwd_simt_{f32,
// f32_wide,bf16}.cu, and flash_attention_bwd_{mma,simt_f32}_d32.cu for head
// size 32), so that the compilers run side by side.

#include "flash_attention_bwd.cuh"

// One launch of a K2 backward kernel on `stream`.
// kernel: 0 = dkv (writes dk, dv, dbias_bh), 1 = dkv with fused dq (also
// adds into dq_acc, a zeroed f32 [BH, Nq, d] buffer), 2 = dq (writes dq).
// Pointers a kernel does not use may be null. q, dout: [BH, Nq, d]; k, v:
// [BH, Nk, d]; f32 (is_bf16 = 0) or bf16 (is_bf16 = 1), contiguous. bias:
// [H, Nk] f32; lse, delta: [BH, Nq] f32; dbias_bh: [BH, Nk] f32. scale:
// d^-1/2 rounded to the input type.
// body: 1 the tensor-core kernels (bf16: dkv and dq at d 16, 32, 48 or 64,
// the fused one at d 16 or 32), 0 the CUDA-core kernels (every kernel in f32
// at d 8, 16, 32, 48 or 64; in bf16 every kernel at d 8 or 16 and the fused
// one at d 48 or 64). The caller chooses; nothing here falls from one to the
// other.
// Returns the cudaError_t of the launch.
extern "C" int lunaris_flash_attention_bwd(
    int kernel, const void* q, const void* k, const void* v, const void* bias,
    const void* dout, const void* lse, const void* delta, void* dq, void* dk,
    void* dv, void* dbias_bh, void* dq_acc, int BH, int H, int Nq, int Nk,
    int d, float scale, int use_dropout, unsigned int threshold,
    float inv_keep, unsigned int seed, int q_offset, int row_offset,
    int is_bf16, int body, void* stream) {
  if (BH <= 0 || H <= 0 || Nq <= 0 || Nk <= 0 || BH > 65535 ||
      (body != 0 && body != 1) || (body == 1 && !is_bf16))
    return static_cast<int>(cudaErrorInvalidValue);
  const LunarisK2BwdArgs a{
      q, k, v, static_cast<const float*>(bias), dout,
      static_cast<const float*>(lse), static_cast<const float*>(delta), dq, dk,
      dv, static_cast<float*>(dbias_bh), static_cast<float*>(dq_acc), BH, H,
      Nq, Nk, scale, use_dropout, threshold, inv_keep, seed, q_offset,
      row_offset};
  auto s = static_cast<cudaStream_t>(stream);
  if (body == 1) {
    if (d == 32) return lunaris_k2_bwd_mma_bf16_d32(a, kernel, s);
    switch (kernel) {
      case kBwdDkv: return lunaris_k2_bwd_dkv_mma_bf16(a, d, s);
      case kBwdDkvFusedDq: return lunaris_k2_bwd_fused_mma_bf16(a, d, s);
      case kBwdDq: return lunaris_k2_bwd_dq_mma_bf16(a, d, s);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (is_bf16) return lunaris_k2_bwd_simt_bf16(a, d, kernel, s);
  if (d == 32) return lunaris_k2_bwd_simt_f32_d32(a, kernel, s);
  return d <= 16 ? lunaris_k2_bwd_simt_f32(a, d, kernel, s)
                 : lunaris_k2_bwd_simt_f32_wide(a, d, kernel, s);
}
