// K2 -- what the flash-attention forward (flash_attention_fwd.cuh) and
// backward (flash_attention_bwd.cuh) share: the constants of the dropout
// hash, the dropout modes a kernel is compiled for, and the thin wrappers
// around the Hopper (sm_90a) instructions that the tensor-core bodies are
// built from (cp.async, ldmatrix, movmatrix, mma.sync m16n8k16 bf16,
// ex2.approx). The build hashes this header with the sources.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>

#include "common.cuh"

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

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// A pair of bf16 values times scale, rounded to bf16 again.
__device__ __forceinline__ uint32_t scale_bf16x2(uint32_t x, float scale) {
  const float2 f =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x));
  return pack_bf16(f.x * scale, f.y * scale);
}

}  // namespace
