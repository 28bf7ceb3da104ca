// K2 on the windowed fold -- the C entry points of the window bodies, for
// Hopper (sm_90a). The kernels are in flash_attention_window.cuh (bf16) and
// flash_attention_window_tf32.cuh (f32, three TF32 passes), which say what
// they replace, what bounds them and what their design does about it; their
// instances are compiled one translation unit each
// (flash_attention_{fwd,bwd}_window{,_tf32}_d{16,32}{,_drop}.cu), so that
// the compilers run side by side.

#include "flash_attention_window.cuh"
#include "flash_attention_window_tf32.cuh"

// The forward: q, k, v [BH, W, d] bf16 (is_bf16) or f32, contiguous; bias
// [H, W] f32; o [BH, W, d] in q's type; lse [BH, W] f32. d 16 or 32, W a
// multiple of 64 in 64..256. scale: d^-1/2 rounded to q's type; threshold:
// the uint32 keep threshold, inv_keep: f32(1 / (1 - rate)). Returns the
// cudaError_t of the launch (cudaErrorInvalidValue for a shape it does not
// take).
extern "C" int lunaris_k2_window_fwd(
    const void* q, const void* k, const void* v, const void* bias, void* o,
    void* lse, int BH, int H, int W, int d, int is_bf16, float scale,
    int use_dropout, unsigned int threshold, float inv_keep, unsigned int seed,
    int q_offset, int row_offset, void* stream) {
  LunarisK2WindowArgs a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.bias = static_cast<const float*>(bias);
  a.o = o;
  a.lse = static_cast<float*>(lse);
  a.BH = BH;
  a.H = H;
  a.W = W;
  a.scale = scale;
  a.use_dropout = use_dropout;
  a.threshold = threshold;
  a.inv_keep = inv_keep;
  a.seed = seed;
  a.q_offset = q_offset;
  a.row_offset = row_offset;
  auto s = static_cast<cudaStream_t>(stream);
  if (!is_bf16) {
    switch (d) {
      case 16: return use_dropout ? lunaris_k2_fwd_window_tf32_d16_drop(a, s)
                                  : lunaris_k2_fwd_window_tf32_d16(a, s);
      case 32: return use_dropout ? lunaris_k2_fwd_window_tf32_d32_drop(a, s)
                                  : lunaris_k2_fwd_window_tf32_d32(a, s);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  switch (d) {
    case 16: return use_dropout ? lunaris_k2_fwd_window_d16_drop(a, s)
                                : lunaris_k2_fwd_window_d16(a, s);
    case 32: return use_dropout ? lunaris_k2_fwd_window_d32_drop(a, s)
                                : lunaris_k2_fwd_window_d32(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The fused backward: the forward's arguments with o and lse read, dout
// [BH, W, d] in q's type; writes dq, dk, dv [BH, W, d] in q's type and
// dbias_bh [BH, W] f32, each once (no buffer to zero, no atomics).
extern "C" int lunaris_k2_window_bwd(
    const void* q, const void* k, const void* v, const void* bias,
    const void* o, const void* dout, const void* lse, void* dq, void* dk,
    void* dv, void* dbias_bh, int BH, int H, int W, int d, int is_bf16,
    float scale, int use_dropout, unsigned int threshold, float inv_keep,
    unsigned int seed, int q_offset, int row_offset, void* stream) {
  LunarisK2WindowArgs a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.bias = static_cast<const float*>(bias);
  a.o = const_cast<void*>(o);
  a.lse = static_cast<float*>(const_cast<void*>(lse));
  a.dout = dout;
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.dbias_bh = static_cast<float*>(dbias_bh);
  a.BH = BH;
  a.H = H;
  a.W = W;
  a.scale = scale;
  a.use_dropout = use_dropout;
  a.threshold = threshold;
  a.inv_keep = inv_keep;
  a.seed = seed;
  a.q_offset = q_offset;
  a.row_offset = row_offset;
  auto s = static_cast<cudaStream_t>(stream);
  if (!is_bf16) {
    switch (d) {
      case 16: return use_dropout ? lunaris_k2_bwd_window_tf32_d16_drop(a, s)
                                  : lunaris_k2_bwd_window_tf32_d16(a, s);
      case 32: return use_dropout ? lunaris_k2_bwd_window_tf32_d32_drop(a, s)
                                  : lunaris_k2_bwd_window_tf32_d32(a, s);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  switch (d) {
    case 16: return use_dropout ? lunaris_k2_bwd_window_d16_drop(a, s)
                                : lunaris_k2_bwd_window_d16(a, s);
    case 32: return use_dropout ? lunaris_k2_bwd_window_d32_drop(a, s)
                                : lunaris_k2_bwd_window_d32(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The dynamic shared memory a launch takes at head size d (16 or 32), for
// the build report.
extern "C" int lunaris_k2_window_fwd_smem_bytes(int d) {
  return win_fwd_smem_bytes(d == 32 ? 32 : 16);
}
extern "C" int lunaris_k2_window_bwd_smem_bytes(int d) {
  return win_bwd_smem_bytes(d == 32 ? 32 : 16);
}
// The same for the f32 bodies.
extern "C" int lunaris_k2_window_tf32_fwd_smem_bytes(int d) {
  return t32w_fwd_smem_bytes(d == 32 ? 32 : 16);
}
extern "C" int lunaris_k2_window_tf32_bwd_smem_bytes(int d) {
  return t32w_bwd_smem_bytes(d == 32 ? 32 : 16);
}
