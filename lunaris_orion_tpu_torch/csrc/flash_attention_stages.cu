// K2 stage family -- the K2 forward cut after a named stage of the
// online-softmax chain, for Hopper (sm_90a). A measuring instrument: the time
// of stage n minus the time of stage n-1 is what that stage costs inside the
// forward kernel.
//
// Replaces tools/bench_attn_roofline.py `_stage_kernel` (launched by
// `_stage_fwd`).
//
// Same grid, tile and layout as `flash_fwd` in flash_attention_fwd.cu (one
// thread per query row, 128 rows a block, keys staged in shared memory as
// f32 in tiles of BK = 64), with the stage as a template parameter, no
// dropout, and q taken as it comes (the caller scales it). Compiled for the
// teacher's head size d = 16 only: it is that shape the instrument reads.
// Per key tile, with s = q k^T:
//   level 0 "dots"    p = s                                  m stays 0
//   level 1 "bias"    s += bias[h, k]
//   level 2 "maxsub"  m_new = max(m, max s); corr = exp(m - m_new); s -= m_new
//   level 3 "exp"     p = exp(s)
//   level 4 "sum"     l = l corr + sum p          (below: l = l corr + 1)
// and always acc = acc corr + round_T(p) v; at the end l = max(l, 1e-30),
// o = acc / l, lse = m + log l. Below "maxsub" m starts at 0 and corr is 1;
// from "maxsub" on m starts at -1e30. Below "sum" the carry l gains 1 per
// key TILE, so o and lse depend on the tile size: the caller must pass a
// block_k equal to this kernel's BK. At "sum" the kernel is `flash_fwd`
// without dropout, operation for operation.
//
// Nk must be a multiple of BK (a masked key has no meaning below "exp");
// a ragged Nq is masked.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kRows = 128;

template <typename T, int D, int BK, int LVL>
__global__ void __launch_bounds__(kRows)
flash_fwd_stage(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const float* __restrict__ bias,
                T* __restrict__ o, float* __restrict__ lse, int H, int Nq,
                int Nk) {
  __shared__ __align__(16) float ks[BK][D];
  __shared__ __align__(16) float vs[BK][D];
  __shared__ float bs[BK];

  const int bh = blockIdx.y;
  const int row = blockIdx.x * kRows + threadIdx.x;
  const bool valid = row < Nq;
  const T* kb = k + static_cast<long long>(bh) * Nk * D;
  const T* vb = v + static_cast<long long>(bh) * Nk * D;
  const float* biasb = bias + static_cast<long long>(bh % H) * Nk;

  float qr[D];
  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = 0.f;
    acc[d] = 0.f;
  }
  if (valid) {
    const T* qrow = q + (static_cast<long long>(bh) * Nq + row) * D;
#pragma unroll
    for (int d = 0; d < D; ++d) qr[d] = to_f32(qrow[d]);
  }
  float m = LVL >= 2 ? -1e30f : 0.f;
  float l = 0.f;

  for (int k0 = 0; k0 < Nk; k0 += BK) {
    __syncthreads();
    for (int i = threadIdx.x; i < BK * D; i += kRows) {
      const int j = i / D;
      const int d = i % D;
      const long long off = static_cast<long long>(k0 + j) * D + d;
      ks[j][d] = to_f32(kb[off]);
      vs[j][d] = to_f32(vb[off]);
    }
    if (LVL >= 1)
      for (int j = threadIdx.x; j < BK; j += kRows) bs[j] = biasb[k0 + j];
    __syncthreads();
    if (!valid) continue;

    float s[BK];
    float m_new = m;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) dot = fmaf(qr[d], ks[j][d], dot);
      if (LVL >= 1) dot += bs[j];
      s[j] = dot;
      if (LVL >= 2) m_new = fmaxf(m_new, dot);
    }
    if (LVL >= 2) {
      const float corr = expf(m - m_new);
      l *= corr;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] *= corr;
    }
    if (LVL < 4) l += 1.f;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      float p = s[j];
      if (LVL >= 2) p -= m_new;
      if (LVL >= 3) p = expf(p);
      if (LVL >= 4) l += p;
      p = round_to<T>(p);
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] = fmaf(p, vs[j][d], acc[d]);
    }
    m = m_new;
  }

  if (valid) {
    l = fmaxf(l, 1e-30f);
    T* orow = o + (static_cast<long long>(bh) * Nq + row) * D;
#pragma unroll
    for (int d = 0; d < D; ++d) orow[d] = from_f32<T>(acc[d] / l);
    lse[static_cast<long long>(bh) * Nq + row] = m + logf(l);
  }
}

template <typename T, int D, int LVL>
int launch(const void* q, const void* k, const void* v, const float* bias,
           void* o, float* lse, int BH, int H, int Nq, int Nk,
           cudaStream_t stream) {
  constexpr int BK = 64;
  if (Nk % BK != 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((Nq + kRows - 1) / kRows, BH);
  flash_fwd_stage<T, D, BK, LVL><<<grid, kRows, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), bias, static_cast<T*>(o), lse, H, Nq, Nk);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int dispatch_stage(int stage, const void* q, const void* k, const void* v,
                   const float* bias, void* o, float* lse, int BH, int H,
                   int Nq, int Nk, cudaStream_t s) {
  switch (stage) {
    case 0: return launch<T, D, 0>(q, k, v, bias, o, lse, BH, H, Nq, Nk, s);
    case 1: return launch<T, D, 1>(q, k, v, bias, o, lse, BH, H, Nq, Nk, s);
    case 2: return launch<T, D, 2>(q, k, v, bias, o, lse, BH, H, Nq, Nk, s);
    case 3: return launch<T, D, 3>(q, k, v, bias, o, lse, BH, H, Nq, Nk, s);
    case 4: return launch<T, D, 4>(q, k, v, bias, o, lse, BH, H, Nq, Nk, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q: [BH, Nq, d] (already scaled); k, v: [BH, Nk, d]; f32 (is_bf16 = 0) or
// bf16 (is_bf16 = 1), contiguous. bias: [H, Nk] f32. o: [BH, Nq, d] in the
// input type; lse: [BH, Nq] f32. d: 16. stage: 0..4 (dots, bias, maxsub,
// exp, sum). Nk a multiple of the key tile, 64.
// Returns the cudaError_t of the launch.
extern "C" int lunaris_flash_attention_stage(
    const void* q, const void* k, const void* v, const void* bias, void* o,
    void* lse, int BH, int H, int Nq, int Nk, int d, int stage, int is_bf16,
    void* stream) {
  if (BH <= 0 || H <= 0 || Nq <= 0 || Nk <= 0 || BH > 65535 || d != 16)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  auto b = static_cast<const float*>(bias);
  auto l = static_cast<float*>(lse);
  if (is_bf16)
    return dispatch_stage<__nv_bfloat16, 16>(stage, q, k, v, b, o, l, BH, H,
                                             Nq, Nk, s);
  return dispatch_stage<float, 16>(stage, q, k, v, b, o, l, BH, H, Nq, Nk, s);
}
