// K2 forward -- the C entry point of the flash-attention forward, for Hopper
// (sm_90a). The kernels are in flash_attention_fwd.cuh, which says what they
// replace, what bounds them and what their design does about it; their
// instances are compiled one translation unit a body and type
// (flash_attention_fwd_mma.cu, flash_attention_fwd_tf32.cu,
// flash_attention_fwd_simt_{f32,bf16}.cu, flash_attention_fwd_simt_f32_wide.cu
// for d 48 and 64, flash_attention_fwd_d32.cu for bf16's tensor-core and
// f32's CUDA-core body at d 32, and flash_attention_fwd_wgmma_d*.cu for the
// warpgroup bodies, an instance a file; the f32 ones' pre-pass in
// flash_attention_tf32_split.cu), so that the compilers run side by
// side.

#include "flash_attention_fwd.cuh"

// q: [BH, Nq, d]; k, v: [BH, Nk, d]; f32 (is_bf16 = 0) or bf16 (is_bf16 = 1),
// contiguous. bias: [H, Nk] f32. o: [BH, Nq, d] in the input type;
// lse: [BH, Nq] f32. scale: d^-1/2 already rounded to the input type.
// threshold: the uint32 keep threshold, inv_keep: f32(1 / (1 - rate)).
// body: 2 the warpgroup kernel (bf16 at d 16, 32, 48 or 64: wgmma fed by
// TMA; at d 16 and 32 its narrow form; f32 at d 16, 32, 48 or 64:
// flash_fwd_wgmma_tf32, on the key tiles that lunaris_k2_tf32_split wrote
// into `split` for this call), 1 the
// tensor-core kernel on mma.sync (at d 16, 32, 48 or 64: bf16 products, or
// three TF32 passes for f32), 0 the CUDA-core kernel (f32 at d 8, 16, 32, 48
// or 64; bf16 at d 8 or 16). The caller chooses; nothing here falls from one
// to the other.
// Returns the cudaError_t of the launch.
extern "C" int lunaris_flash_attention_fwd(
    const void* q, const void* k, const void* v, const void* bias, void* o,
    void* lse, int BH, int H, int Nq, int Nk, int d, float scale,
    int use_dropout, unsigned int threshold, float inv_keep,
    unsigned int seed, int q_offset, int row_offset, int is_bf16, int body,
    const void* split, void* stream) {
  if (BH <= 0 || H <= 0 || Nq <= 0 || Nk <= 0 || BH > 65535 ||
      body < 0 || body > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const LunarisK2FwdArgs a{q, k, v, static_cast<const float*>(bias), o,
                           static_cast<float*>(lse), BH, H, Nq, Nk, scale,
                           use_dropout, threshold, inv_keep, seed, q_offset,
                           row_offset};
  auto s = static_cast<cudaStream_t>(stream);
  if (body == 2 && !is_bf16) {
    switch (d) {
      case 16: return use_dropout ? lunaris_k2_fwd_wgmma_tf32_d16_drop(a, split, s)
                                  : lunaris_k2_fwd_wgmma_tf32_d16(a, split, s);
      case 32: return use_dropout ? lunaris_k2_fwd_wgmma_tf32_d32_drop(a, split, s)
                                  : lunaris_k2_fwd_wgmma_tf32_d32(a, split, s);
      case 48: return use_dropout ? lunaris_k2_fwd_wgmma_tf32_d48_drop(a, split, s)
                                  : lunaris_k2_fwd_wgmma_tf32_d48(a, split, s);
      case 64: return use_dropout ? lunaris_k2_fwd_wgmma_tf32_d64_drop(a, split, s)
                                  : lunaris_k2_fwd_wgmma_tf32_d64(a, split, s);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (body == 2) {
    switch (d) {
      case 16: return use_dropout ? lunaris_k2_fwd_wgmma_d16_drop(a, s)
                                  : lunaris_k2_fwd_wgmma_d16(a, s);
      case 32: return use_dropout ? lunaris_k2_fwd_wgmma_d32_drop(a, s)
                                  : lunaris_k2_fwd_wgmma_d32(a, s);
      case 48: return use_dropout ? lunaris_k2_fwd_wgmma_d48_drop(a, s)
                                  : lunaris_k2_fwd_wgmma_d48(a, s);
      case 64: return use_dropout ? lunaris_k2_fwd_wgmma_d64_drop(a, s)
                                  : lunaris_k2_fwd_wgmma_d64(a, s);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (body == 1 && !is_bf16) return lunaris_k2_fwd_tf32(a, d, s);
  if (d == 32) return lunaris_k2_fwd_d32(a, is_bf16, body, s);
  if (body == 1) return lunaris_k2_fwd_mma_bf16(a, d, s);
  if (d <= 16)
    return is_bf16 ? lunaris_k2_fwd_simt_bf16(a, d, s)
                   : lunaris_k2_fwd_simt_f32(a, d, s);
  return is_bf16 ? static_cast<int>(cudaErrorInvalidValue)
                 : lunaris_k2_fwd_simt_f32_wide(a, d, s);
}

// The dynamic shared memory a launch of the warpgroup body takes (its ring
// of K, V and bias tiles and its barriers), for the build report.
extern "C" int lunaris_k2_fwd_wgmma_smem_bytes() { return wg_fwd_smem_bytes(); }
// The same for the narrow warpgroup body at head size d (16 or 32).
extern "C" int lunaris_k2_fwd_wgmma_narrow_smem_bytes(int d) {
  return d == 32 ? nw_fwd_smem_bytes(32, nw_block_k(32))
                 : nw_fwd_smem_bytes(16, nw_block_k(16));
}
// The same for the f32 warpgroup body at head size d (16, 32, 48 or 64).
extern "C" int lunaris_k2_fwd_wgmma_tf32_smem_bytes(int d) {
  return t32_fwd_smem_bytes(d == 16 || d == 32 || d == 48 ? d : 64);
}
// Its query rows a block (64 a consumer warpgroup), which
// `flash_attention.forward_instance` mirrors.
extern "C" int lunaris_k2_fwd_wgmma_tf32_rows(int d) {
  return fwd_t32_rows(d == 16 || d == 32 || d == 48 ? d : 64);
}
