// K2 forward -- flash attention over spatial tokens with a per-key bias and
// hash dropout on the probabilities, for Hopper (sm_90a).
//
// Replaces lunaris_orion_tpu/ops/pallas/flash_attention.py `_fwd_kernel`
// (launched by `_fwd`, reached through `attention_bhnd`).
//
//   o   = softmax(q k^T d^-1/2 + bias[h, k]) v     (dropout on the probabilities)
//   lse = m + log(l)
//
// Layout: q [BH, Nq, d], k/v [BH, Nk, d], each row's d values contiguous
// (the TPU kernel carried [BH, d, N] for its 128-wide lanes; that choice does
// not carry over). bias [H, Nk] f32, indexed by bh % H. o [BH, Nq, d] in the
// input type, lse [BH, Nq] f32.
//
// Rounding points match the TPU kernel: q is scaled by d^-1/2 in the input
// type; scores, running max, row sums and the accumulator are f32; the
// (dropped, rescaled) probabilities are rounded to v's type before P.V;
// o = acc / max(l, 1e-30). The row sum l uses the undropped probabilities.
//
// Dropout: the stateless hash of `_keep_mask`, bit for bit, in uint32
// arithmetic where wrap-around is defined:
//   row_seed = seed ^ ((bh + row_offset) * C1)
//   h = row_seed + k_abs * C2 + q_abs * C3,  q_abs = q_offset + q
//   h ^= h >> 15;  h *= C2;  keep = h < threshold
// The bh index is the row within this call: a caller that runs the experts
// one call each numbers each expert's rows 0..BH-1 under its own seed, as the
// JAX package's vmap over experts does. A later kernel that folds the experts
// into one batch must keep that per-expert row index.
//
// Bound: compute and exp. At d = 16 the kernel does O(N^2 d) work on O(N d)
// bytes. This first version runs on the CUDA cores: one thread owns one query
// row (q and the f32 accumulator in registers), a block of 128 rows walks the
// keys in tiles staged in shared memory as f32, so every thread of the block
// reads the same k/v element at once (a broadcast). Ragged Nq and Nk are
// masked. Tensor cores (mma.sync, wgmma) and TMA staging are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>

#include "common.cuh"

namespace {

constexpr uint32_t kC1 = 0x9E3779B9u;
constexpr uint32_t kC2 = 0x85EBCA6Bu;
constexpr uint32_t kC3 = 0xC2B2AE35u;
constexpr int kRows = 128;

template <typename T, int D, int BK>
__global__ void __launch_bounds__(kRows)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const float* __restrict__ bias,
          T* __restrict__ o, float* __restrict__ lse, int H, int Nq, int Nk,
          float scale, int use_dropout, uint32_t threshold, float inv_keep,
          uint32_t seed, int q_offset, int row_offset) {
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
    for (int d = 0; d < D; ++d) qr[d] = round_to<T>(to_f32(qrow[d]) * scale);
  }
  float m = -1e30f;
  float l = 0.f;
  const uint32_t row_seed =
      seed ^ (static_cast<uint32_t>(bh + row_offset) * kC1);
  const uint32_t q_term = static_cast<uint32_t>(q_offset + row) * kC3;

  for (int k0 = 0; k0 < Nk; k0 += BK) {
    __syncthreads();
    for (int i = threadIdx.x; i < BK * D; i += kRows) {
      const int j = i / D;
      const int d = i % D;
      const bool in = k0 + j < Nk;
      const long long off = static_cast<long long>(k0 + j) * D + d;
      ks[j][d] = in ? to_f32(kb[off]) : 0.f;
      vs[j][d] = in ? to_f32(vb[off]) : 0.f;
    }
    for (int j = threadIdx.x; j < BK; j += kRows)
      bs[j] = k0 + j < Nk ? biasb[k0 + j] : 0.f;
    __syncthreads();
    if (!valid) continue;

    float s[BK];
    float m_new = m;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) dot = fmaf(qr[d], ks[j][d], dot);
      dot += bs[j];
      s[j] = k0 + j < Nk ? dot : -INFINITY;
      m_new = fmaxf(m_new, s[j]);
    }
    const float corr = expf(m - m_new);
    l *= corr;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] *= corr;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      float p = expf(s[j] - m_new);
      l += p;
      if (use_dropout) {
        uint32_t h = row_seed + static_cast<uint32_t>(k0 + j) * kC2 + q_term;
        h ^= h >> 15;
        h *= kC2;
        p = h < threshold ? p * inv_keep : 0.f;
      }
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

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const float* bias,
           void* o, float* lse, int BH, int H, int Nq, int Nk, float scale,
           int use_dropout, uint32_t threshold, float inv_keep, uint32_t seed,
           int q_offset, int row_offset, cudaStream_t stream) {
  constexpr int BK = D <= 16 ? 64 : 32;
  const dim3 grid((Nq + kRows - 1) / kRows, BH);
  flash_fwd<T, D, BK><<<grid, kRows, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), bias, static_cast<T*>(o), lse, H, Nq, Nk,
      scale, use_dropout, threshold, inv_keep, seed, q_offset, row_offset);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int d, const void* q, const void* k, const void* v,
             const float* bias, void* o, float* lse, int BH, int H, int Nq,
             int Nk, float scale, int use_dropout, uint32_t threshold,
             float inv_keep, uint32_t seed, int q_offset, int row_offset,
             cudaStream_t s) {
  switch (d) {
    case 8:
      return launch<T, 8>(q, k, v, bias, o, lse, BH, H, Nq, Nk, scale,
                          use_dropout, threshold, inv_keep, seed, q_offset,
                          row_offset, s);
    case 16:
      return launch<T, 16>(q, k, v, bias, o, lse, BH, H, Nq, Nk, scale,
                           use_dropout, threshold, inv_keep, seed, q_offset,
                           row_offset, s);
    case 48:
      return launch<T, 48>(q, k, v, bias, o, lse, BH, H, Nq, Nk, scale,
                           use_dropout, threshold, inv_keep, seed, q_offset,
                           row_offset, s);
    case 64:
      return launch<T, 64>(q, k, v, bias, o, lse, BH, H, Nq, Nk, scale,
                           use_dropout, threshold, inv_keep, seed, q_offset,
                           row_offset, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q: [BH, Nq, d]; k, v: [BH, Nk, d]; f32 (is_bf16 = 0) or bf16 (is_bf16 = 1),
// contiguous. bias: [H, Nk] f32. o: [BH, Nq, d] in the input type;
// lse: [BH, Nq] f32. scale: d^-1/2 already rounded to the input type.
// threshold: the uint32 keep threshold, inv_keep: f32(1 / (1 - rate)).
// Returns the cudaError_t of the launch.
extern "C" int lunaris_flash_attention_fwd(
    const void* q, const void* k, const void* v, const void* bias, void* o,
    void* lse, int BH, int H, int Nq, int Nk, int d, float scale,
    int use_dropout, unsigned int threshold, float inv_keep,
    unsigned int seed, int q_offset, int row_offset, int is_bf16,
    void* stream) {
  if (BH <= 0 || H <= 0 || Nq <= 0 || Nk <= 0 || BH > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  auto b = static_cast<const float*>(bias);
  auto l = static_cast<float*>(lse);
  if (is_bf16)
    return dispatch<__nv_bfloat16>(d, q, k, v, b, o, l, BH, H, Nq, Nk, scale,
                                   use_dropout, threshold, inv_keep, seed,
                                   q_offset, row_offset, s);
  return dispatch<float>(d, q, k, v, b, o, l, BH, H, Nq, Nk, scale,
                         use_dropout, threshold, inv_keep, seed, q_offset,
                         row_offset, s);
}
