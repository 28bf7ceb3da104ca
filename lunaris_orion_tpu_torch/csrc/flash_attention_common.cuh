// K2 -- what the flash-attention forward (flash_attention_fwd.cuh) and
// backward (flash_attention_bwd.cuh) share: the constants of the dropout
// hash, the dropout modes a kernel is compiled for, and the thin wrappers
// around the Hopper (sm_90a) instructions that the tensor-core bodies are
// built from (cp.async, ldmatrix, movmatrix, mma.sync m16n8k16 bf16,
// mma.sync m16n8k8 tf32 with cvt.rna for the three-pass f32 products,
// ex2.approx; the warpgroup bodies' mbarriers, TMA and wgmma are in
// hopper.cuh). The build hashes this header with the sources.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

// The stateless hash of `_keep_mask`, in uint32 arithmetic:
//   row_seed = seed ^ ((bh + row_offset) * C1)
//   h = row_seed + k_abs * C2 + q_abs * C3;  h ^= h >> 15;  h *= C2
//   keep = h < threshold
constexpr uint32_t kC1 = 0x9E3779B9u;
constexpr uint32_t kC2 = 0x85EBCA6Bu;
constexpr uint32_t kC3 = 0xC2B2AE35u;

// The hash's last two steps and the test, on h = row_seed + k_abs C2 + q_abs C3.
__device__ __forceinline__ bool keep_hash(uint32_t h, uint32_t threshold) {
  h ^= h >> 15;
  h *= kC2;
  return h < threshold;
}

// Dropout as a template parameter: compiled out, compiled in, or decided by
// the arguments' use_dropout at run time (one instance for a head size that
// only tests and small configurations reach).
constexpr int kDropOff = 0;
constexpr int kDropOn = 1;
constexpr int kDropRuntime = 2;

constexpr float kLog2e = 1.4426950408889634f;

// 16 bytes, or 16 bytes of zeros when src_bytes is 0.
__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem,
                                            int src_bytes) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_4(void* smem, const void* gmem,
                                           int src_bytes) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 bf16 matrices; lane l gives the address of row l % 8 of matrix
// l / 8, and gets of matrix i, in r[i], elements (l / 4, 2 (l % 4) + {0, 1}).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* smem) {
  const uint32_t src = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(src)
      : "memory");
}

// The same, each matrix transposed: elements (2 (l % 4) + {0, 1}, l / 4).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* smem) {
  const uint32_t src = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(src)
      : "memory");
}

// An 8x8 bf16 matrix held as lane l's elements (l / 4, 2 (l % 4) + {0, 1}),
// transposed across the warp in the same layout.
__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t x) {
  uint32_t y;
  asm("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

// d[16 x 8] = a[16 x 16] b[16 x 8] + c, bf16 operands, f32 sums. With
// g = lane / 4 and t = lane % 4: a = {(g, 2t..), (g + 8, 2t..), (g, 2t + 8..),
// (g + 8, 2t + 8..)}, b = {(2t.., g), (2t + 8.., g)}, c and d = {(g, 2t),
// (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1)}; ".." is a pair, the lower index
// in the low half of the register. c may repeat a register or be a constant:
// a first product needs no copy to start from.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1, float c0,
                                         float c1, float c2, float c3) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(c0),
        "f"(c1), "f"(c2), "f"(c3));
}

// d += a b.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  mma_bf16(d, a, b0, b1, d[0], d[1], d[2], d[3]);
}

// x rounded to TF32 (10 mantissa bits), to nearest with ties away from zero,
// returned as the f32 bits of the result. mma.sync's tf32 operands only
// ignore their low 13 bits, which truncates: an operand is rounded here.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(y) : "f"(x));
  return y;
}

// x as hi + lo, both TF32: hi = tf32(x); x - hi is exact in f32, and lo is
// it rounded to TF32, so hi + lo is x to within 2^-22 of |x|.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// The same on four values, as floats (the f32 bits of TF32 values), for
// the shared-memory tiles that hold them.
__device__ __forceinline__ void split_tf32(const float4 x, float4& hi,
                                           float4& lo) {
  uint32_t h, l;
  split_tf32(x.x, h, l); hi.x = __uint_as_float(h); lo.x = __uint_as_float(l);
  split_tf32(x.y, h, l); hi.y = __uint_as_float(h); lo.y = __uint_as_float(l);
  split_tf32(x.z, h, l); hi.z = __uint_as_float(h); lo.z = __uint_as_float(l);
  split_tf32(x.w, h, l); hi.w = __uint_as_float(h); lo.w = __uint_as_float(l);
}

// d[16 x 8] += a[16 x 8] b[8 x 8], TF32 operands, f32 sums. With g = lane / 4
// and t = lane % 4: a = {(g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)},
// b = {(t, g), (t + 4, g)}, d = {(g, 2t), (g, 2t + 1), (g + 8, 2t),
// (g + 8, 2t + 1)}.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b in three TF32 passes, the f32 product to within f32 rounding:
// a_lo b_hi and a_hi b_lo, the two small cross terms, first, then a_hi b_hi
// (CUTLASS's 3xTF32 order; a_lo b_lo is below f32's last bit). bh and bl are
// b's hi and lo fragments.
__device__ __forceinline__ void mma_tf32x3(float (&d)[4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           uint32_t bh0, uint32_t bh1,
                                           uint32_t bl0, uint32_t bl1) {
  mma_tf32(d, al, bh0, bh1);
  mma_tf32(d, ah, bl0, bl1);
  mma_tf32(d, ah, bh0, bh1);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// f32 b as b1 + b2 + b3, three bf16 values whose sum is b exactly (each
// takes the next 8 of b's 24 significant bits); -inf as (-inf, 0, 0).
// Returns the 16 bytes (b1, b2, b3, 0, 0, 0, 0, 0).
__device__ __forceinline__ uint4 split_bf16x3(float b) {
  const __nv_bfloat16 h1 = __float2bfloat16_rn(b);
  const float f1 = __bfloat162float(h1);
  const float r1 = isinf(f1) ? 0.f : b - f1;
  const __nv_bfloat16 h2 = __float2bfloat16_rn(r1);
  const __nv_bfloat16 h3 = __float2bfloat16_rn(r1 - __bfloat162float(h2));
  const auto bits = [](__nv_bfloat16 h) {
    return static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(&h));
  };
  return make_uint4(bits(h1) | bits(h2) << 16, bits(h3), 0u, 0u);
}

// Row r of a narrow [rows][16] tile (hopper.cuh's 32-byte swizzle) as
// (b1, b2, b3, 0, .., 0): the bias of the narrow bodies' bias k-step, the
// B (forward: keys as n) or A (backward: keys as m) operand whose product
// with [1 1 1 0 .. 0] is b.
__device__ __forceinline__ void write_bias_row(uint8_t* tile, int r, float b) {
  *reinterpret_cast<uint4*>(tile + narrow_offset<16>(r, 0)) = split_bf16x3(b);
  *reinterpret_cast<uint4*>(tile + narrow_offset<16>(r, 8)) =
      make_uint4(0u, 0u, 0u, 0u);
}

// Row r of a narrow [rows][16] tile as [1 1 1 0 .. 0] (bf16).
__device__ __forceinline__ void write_ones_row(uint8_t* tile, int r) {
  *reinterpret_cast<uint4*>(tile + narrow_offset<16>(r, 0)) =
      make_uint4(0x3F803F80u, 0x00003F80u, 0u, 0u);
  *reinterpret_cast<uint4*>(tile + narrow_offset<16>(r, 8)) =
      make_uint4(0u, 0u, 0u, 0u);
}

// The mma.sync / wgmma A fragment of [1 1 1 0 .. 0] in every row (lane's
// t = lane % 4): columns 0-2 are bf16 1.0.
__device__ __forceinline__ void ones3_fragment(uint32_t (&a)[4], int t) {
  const uint32_t x = t == 0 ? 0x3F803F80u : t == 1 ? 0x00003F80u : 0u;
  a[0] = a[1] = x;
  a[2] = a[3] = 0u;
}

// ---- the TF32 tiles of the f32 warpgroup bodies (d 16, 32, 48, 64) -----------
//
// wgmma reads TF32 operands K-major only, and reads an f32 word as TF32 by
// dropping its low 13 bits. So a pre-pass (flash_attention_tf32_split.cu)
// splits the f32 operands of a call into TF32 hi and lo once (`split_tf32`,
// cvt.rna) and lays them out as the bodies' wgmma read them, tile after
// tile, so that a producer moves a tile with one bulk copy. A tile covers
// kTf32Rows keys or queries; rows past N are zeros. "Rows" below are
// [rows][8] tiles, one k-step of 8 a row of 32 bytes with the 32-byte
// swizzle, D / 8 of them; "atoms" [rows][32] with the 128-byte swizzle.
//   tf32_fwd_tile_bytes(D) = 1024 D  a key tile of the forward: K hi, then
//       K lo as rows (64 keys), then V^T as two atoms (keys 0-31, 32-63),
//       each D rows of V hi (dim r) then D rows of V lo, the keys permuted
//       by `perm8`.
//   tf32_bwd_q_tile_bytes(D) = 2048 D + 512  a query tile of the backward.
//       D 16: qs hi, qs lo, dO hi, dO lo as the forward's K, qs^T and dO^T
//       as its V^T (queries permuted by `perm8`), then 64 f32 of -lse log2 e
//       (-inf past Nq) and 64 of delta (0 past Nq). D 32-64: four sub-tiles
//       of kTf32SubRows queries, each tf32_bwd_sub_bytes(D) = 512 D + 128:
//       qs hi, qs lo, dO hi, dO lo as rows (16 queries), qs^T hi, qs^T lo,
//       dO^T hi, dO^T lo as rows too (D dims, a k-step of 8 queries each,
//       permuted by `perm8`), then 16 f32 of -lse log2 e and 16 of delta.
//   tf32_bwd_k_tile_bytes(D)  keys of the backward. D 16 (8192): K^T as the
//       forward's V^T, the keys in order. D 32-64 (1536 D): K hi, K lo, V
//       hi, V lo as rows (64 keys), then K^T hi, K^T lo as rows (D dims, a
//       k-step of 8 keys each, the keys in order).
constexpr int kTf32Rows = 64;
constexpr int kTf32SubRows = 16;
__host__ __device__ constexpr int tf32_fwd_tile_bytes(int d) { return 1024 * d; }
__host__ __device__ constexpr int tf32_bwd_q_tile_bytes(int d) {
  return 2048 * d + 512;
}
__host__ __device__ constexpr int tf32_bwd_sub_bytes(int d) { return 512 * d + 128; }
__host__ __device__ constexpr int tf32_bwd_k_tile_bytes(int d) {
  return d == 16 ? 8192 : 1536 * d;
}

// The byte offset of f32 element (r, c) in a [rows][8] tile with the
// 32-byte swizzle (hopper.cuh: chunk c / 4 of row r at (c / 4) ^ ((r / 4) % 2)).
__host__ __device__ __forceinline__ int sw32_offset(int r, int c) {
  return r * 32 + ((((c >> 2) ^ (r >> 2)) & 1) << 4) + (c & 3) * 4;
}

// The same in a [rows][32] atom with the 128-byte swizzle (chunk c / 4 of
// row r at (c / 4) ^ (r % 8)).
__host__ __device__ __forceinline__ int sw128_offset(int r, int c) {
  return r * 128 + ((((c >> 2) ^ r) & 7) << 4) + (c & 3) * 4;
}

// Where key (or query) k of a tile sits along the k of a transposed operand:
// within each 8, 2t at t and 2t + 1 at t + 4. A score's C fragment holds a
// lane's keys 2t and 2t + 1, the tf32 A fragment its k indices t and t + 4,
// so the scores, once exponentiated, are p v's A fragment as they lie.
__host__ __device__ __forceinline__ int perm8(int k) {
  return (k & ~7) | ((k & 1) << 2) | ((k & 7) >> 1);
}

// A pair of bf16 values times scale, rounded to bf16 again.
__device__ __forceinline__ uint32_t scale_bf16x2(uint32_t x, float scale) {
  const float2 f =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x));
  return pack_bf16(f.x * scale, f.y * scale);
}

}  // namespace
