// K2 backward -- gradients of flash attention with a per-key bias and hash
// dropout, for Hopper (sm_90a).
//
// Replaces lunaris_orion_tpu/ops/pallas/flash_attention.py
// `_bwd_dq_kernel` and `_bwd_dkv_kernel` (the two-kernel backward) and
// `_bwd_fused_kernel` (the single-pass backward), launched in `_vjp_bwd`.
//
// With qs = round_T(q * d^-1/2) (the forward's scaled q), per (query i, key j):
//   s   = qs_i . k_j + bias_j          p   = exp(s - lse_i)
//   dp  = dO_i . v_j                   keep = the forward's hash mask
//   dpd = keep ? dp / (1 - rate) : 0   pv  = keep ? p / (1 - rate) : 0
//   ds  = p * (dpd - delta_i),         delta_i = sum_d f32(O_i) f32(dO_i)
//   dk_j += round_T(ds) qs_i    dv_j += round_T(pv) dO_i    dbias_j += ds
//   dq_i += round_T(ds) k_j;    dq = round_T(round_T(dq) * d^-1/2)
// These are the TPU kernels' rounding points: ds is rounded to the input type
// before the dq and dk products, the dropped probabilities before the dv
// product, and dbias sums the unrounded f32 ds. The forward takes unscaled q
// and scales it inside, so the chain rule's d^-1/2 on dq is applied here.
//
// Layout: q, dO, O [BH, Nq, d]; k, v [BH, Nk, d]; bias [H, Nk] f32 indexed
// by bh % H; lse, delta [BH, Nq] f32. Outputs dq [BH, Nq, d], dk, dv
// [BH, Nk, d] in the input type, dbias_bh [BH, Nk] f32 (the caller sums it
// over the batch in a fixed order).
//
// Dropout regenerates the forward's mask from absolute (row_seed, k, q):
// the same uint32 hash as flash_attention_fwd.cu, so any tiling of either
// kernel sees the same bits. q positions are q_offset + row; rows of BH are
// numbered from row_offset.
//
// Two kernels, designed for the card rather than copied block by block:
//   dkv: one block per (BH row, block of keys); each key row is owned by TPR
//        threads that keep k, v and the f32 dk, dv accumulators in registers
//        and walk all query rows in tiles staged in shared memory. dbias for
//        the block's keys is a per-thread sum: no atomics.
//   dq:  one block per (BH row, block of queries); each query row keeps qs,
//        dO and the f32 dq accumulator in registers and walks the keys.
// kFusedDq (the single-pass form of `_bwd_fused_kernel`): dkv also forms
// dq. After each query tile its threads park round_T(ds) in shared memory,
// the block reduces ds^T k over its keys, and adds the tile's dq partial
// into a zeroed f32 [BH, Nq, d] buffer with atomicAdd, so scores, exp and
// the mask are computed once per (query, key) pair. The order of those
// atomic adds varies from run to run: dq is then order-dependent in its
// last bits. Blocks start their query walk at different tiles so that the
// blocks of one BH row do not add into the same rows at the same time.
//
// Bound: compute and exp, as the forward. This first version runs on the
// CUDA cores with f32 accumulators; at d = 16 one thread owns one row
// (4 x 16 registers of row state), at d = 48 and 64 four threads share a
// row and combine their partial dot products with warp shuffles, which
// keeps the row state at 64 registers a thread. Tensor cores (mma.sync,
// wgmma) and TMA staging are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>

#include "common.cuh"

namespace {

constexpr uint32_t kC1 = 0x9E3779B9u;
constexpr uint32_t kC2 = 0x85EBCA6Bu;
constexpr uint32_t kC3 = 0xC2B2AE35u;
constexpr int kThreads = 128;
constexpr int kTile = 32;  // query rows (dkv) or key rows (dq) per staged tile

// Sum over the TPR consecutive lanes that share one row.
template <int TPR> __device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int m = 1; m < TPR; m <<= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

__device__ __forceinline__ bool keep_bit(uint32_t row_seed, uint32_t k_term,
                                         int q_abs, uint32_t threshold) {
  uint32_t h = row_seed + k_term + static_cast<uint32_t>(q_abs) * kC3;
  h ^= h >> 15;
  h *= kC2;
  return h < threshold;
}

// Threads per row: one up to d = 16, four above. Thread `part` of a row owns
// the dims part, part + TPR, part + 2 TPR, ... (interleaved, so the TPR
// threads of a row read neighbouring shared-memory words).
template <int D> struct Split {
  static constexpr int TPR = D <= 16 ? 1 : 4;
  static constexpr int DPT = D / TPR;
  static constexpr int ROWS = kThreads / TPR;
};

template <typename T, int D, bool kFusedDq>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const float* __restrict__ bias,
              const T* __restrict__ dout, const float* __restrict__ lse,
              const float* __restrict__ delta, T* __restrict__ dk,
              T* __restrict__ dv, float* __restrict__ dbias_bh,
              float* __restrict__ dq_acc, int H, int Nq, int Nk, float scale,
              int use_dropout, uint32_t threshold, float inv_keep,
              uint32_t seed, int q_offset, int row_offset) {
  constexpr int TPR = Split<D>::TPR;
  constexpr int DPT = Split<D>::DPT;
  constexpr int ROWS = Split<D>::ROWS;
  __shared__ __align__(16) float qs[kTile][D];
  __shared__ __align__(16) float dos[kTile][D];
  __shared__ float ls[kTile];
  __shared__ float dls[kTile];
  // Fused dq only (sized 1 otherwise): the block's keys and the tile's ds.
  __shared__ float ks[kFusedDq ? ROWS : 1][kFusedDq ? D : 1];
  __shared__ float dss[kFusedDq ? kTile : 1][kFusedDq ? ROWS + 1 : 1];

  const int bh = blockIdx.y;
  const int lrow = threadIdx.x / TPR;
  const int part = threadIdx.x % TPR;
  const int row = blockIdx.x * ROWS + lrow;  // key index
  const bool valid = row < Nk;
  const long long kv_off = (static_cast<long long>(bh) * Nk + row) * D;

  float kr[DPT], vr[DPT], dkr[DPT], dvr[DPT];
#pragma unroll
  for (int e = 0; e < DPT; ++e) {
    const int d = e * TPR + part;
    kr[e] = valid ? to_f32(k[kv_off + d]) : 0.f;
    vr[e] = valid ? to_f32(v[kv_off + d]) : 0.f;
    dkr[e] = 0.f;
    dvr[e] = 0.f;
    if constexpr (kFusedDq) ks[lrow][d] = kr[e];
  }
  const float bias_k = valid ? bias[static_cast<long long>(bh % H) * Nk + row] : 0.f;
  float db = 0.f;
  const uint32_t row_seed =
      seed ^ (static_cast<uint32_t>(bh + row_offset) * kC1);
  const uint32_t k_term = static_cast<uint32_t>(row) * kC2;

  const int n_tiles = (Nq + kTile - 1) / kTile;
  const int first = kFusedDq ? blockIdx.x % n_tiles : 0;
  for (int t = 0; t < n_tiles; ++t) {
    int tile = first + t;
    if (tile >= n_tiles) tile -= n_tiles;
    const int q0 = tile * kTile;
    __syncthreads();
    for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
      const int j = i / D;
      const int d = i % D;
      const bool in = q0 + j < Nq;
      const long long off = (static_cast<long long>(bh) * Nq + q0 + j) * D + d;
      qs[j][d] = in ? round_to<T>(to_f32(q[off]) * scale) : 0.f;
      dos[j][d] = in ? to_f32(dout[off]) : 0.f;
    }
    for (int j = threadIdx.x; j < kTile; j += kThreads) {
      const bool in = q0 + j < Nq;
      const long long off = static_cast<long long>(bh) * Nq + q0 + j;
      ls[j] = in ? lse[off] : INFINITY;  // p = exp(s - inf) = 0 past Nq
      dls[j] = in ? delta[off] : 0.f;
    }
    __syncthreads();

#pragma unroll 4
    for (int i = 0; i < kTile; ++i) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int e = 0; e < DPT; ++e) {
        const int d = e * TPR + part;
        s = fmaf(qs[i][d], kr[e], s);
        dp = fmaf(dos[i][d], vr[e], dp);
      }
      s = row_sum<TPR>(s) + bias_k;
      dp = row_sum<TPR>(dp);
      const float p = expf(s - ls[i]);
      float pv = p;
      if (use_dropout) {
        const bool keep = keep_bit(row_seed, k_term, q_offset + q0 + i, threshold);
        dp = keep ? dp * inv_keep : 0.f;
        pv = keep ? p * inv_keep : 0.f;
      }
      const float ds = p * (dp - dls[i]);
      const float dsc = round_to<T>(ds);
      const float pvc = round_to<T>(pv);
      db += ds;
#pragma unroll
      for (int e = 0; e < DPT; ++e) {
        const int d = e * TPR + part;
        dkr[e] = fmaf(dsc, qs[i][d], dkr[e]);
        dvr[e] = fmaf(pvc, dos[i][d], dvr[e]);
      }
      if constexpr (kFusedDq) {
        if (part == 0) dss[i][lrow] = valid ? dsc : 0.f;
      }
    }

    if constexpr (kFusedDq) {
      __syncthreads();
      // dq[q0 + i][d] += sum over this block's keys of ds[i][j] * k[j][d]
      for (int o = threadIdx.x; o < kTile * D; o += kThreads) {
        const int i = o / D;
        const int d = o % D;
        if (q0 + i >= Nq) continue;
        float acc = 0.f;
#pragma unroll 8
        for (int j = 0; j < ROWS; ++j) acc = fmaf(dss[i][j], ks[j][d], acc);
        atomicAdd(dq_acc + (static_cast<long long>(bh) * Nq + q0 + i) * D + d, acc);
      }
    }
  }

  if (valid) {
#pragma unroll
    for (int e = 0; e < DPT; ++e) {
      const int d = e * TPR + part;
      dk[kv_off + d] = from_f32<T>(dkr[e]);
      dv[kv_off + d] = from_f32<T>(dvr[e]);
    }
    if (part == 0) dbias_bh[static_cast<long long>(bh) * Nk + row] = db;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const float* __restrict__ bias,
             const T* __restrict__ dout, const float* __restrict__ lse,
             const float* __restrict__ delta, T* __restrict__ dq, int H,
             int Nq, int Nk, float scale, int use_dropout, uint32_t threshold,
             float inv_keep, uint32_t seed, int q_offset, int row_offset) {
  constexpr int TPR = Split<D>::TPR;
  constexpr int DPT = Split<D>::DPT;
  constexpr int ROWS = Split<D>::ROWS;
  __shared__ __align__(16) float ks[kTile][D];
  __shared__ __align__(16) float vs[kTile][D];
  __shared__ float bs[kTile];

  const int bh = blockIdx.y;
  const int part = threadIdx.x % TPR;
  const int row = blockIdx.x * ROWS + threadIdx.x / TPR;  // query index
  const bool valid = row < Nq;
  const long long q_off = (static_cast<long long>(bh) * Nq + row) * D;
  const float* biasb = bias + static_cast<long long>(bh % H) * Nk;
  const T* kb = k + static_cast<long long>(bh) * Nk * D;
  const T* vb = v + static_cast<long long>(bh) * Nk * D;

  float qr[DPT], dor[DPT], dqr[DPT];
#pragma unroll
  for (int e = 0; e < DPT; ++e) {
    const int d = e * TPR + part;
    qr[e] = valid ? round_to<T>(to_f32(q[q_off + d]) * scale) : 0.f;
    dor[e] = valid ? to_f32(dout[q_off + d]) : 0.f;
    dqr[e] = 0.f;
  }
  const long long r_off = static_cast<long long>(bh) * Nq + row;
  const float lse_i = valid ? lse[r_off] : INFINITY;
  const float delta_i = valid ? delta[r_off] : 0.f;
  const uint32_t row_seed =
      seed ^ (static_cast<uint32_t>(bh + row_offset) * kC1);

  for (int k0 = 0; k0 < Nk; k0 += kTile) {
    __syncthreads();
    for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
      const int j = i / D;
      const int d = i % D;
      const bool in = k0 + j < Nk;
      const long long off = static_cast<long long>(k0 + j) * D + d;
      ks[j][d] = in ? to_f32(kb[off]) : 0.f;
      vs[j][d] = in ? to_f32(vb[off]) : 0.f;
    }
    for (int j = threadIdx.x; j < kTile; j += kThreads)
      bs[j] = k0 + j < Nk ? biasb[k0 + j] : -INFINITY;  // p = 0 past Nk
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kTile; ++j) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int e = 0; e < DPT; ++e) {
        const int d = e * TPR + part;
        s = fmaf(qr[e], ks[j][d], s);
        dp = fmaf(dor[e], vs[j][d], dp);
      }
      s = row_sum<TPR>(s) + bs[j];
      dp = row_sum<TPR>(dp);
      const float p = expf(s - lse_i);
      if (use_dropout) {
        const bool keep = keep_bit(row_seed, static_cast<uint32_t>(k0 + j) * kC2,
                                   q_offset + row, threshold);
        dp = keep ? dp * inv_keep : 0.f;
      }
      const float dsc = round_to<T>(p * (dp - delta_i));
#pragma unroll
      for (int e = 0; e < DPT; ++e) dqr[e] = fmaf(dsc, ks[j][e * TPR + part], dqr[e]);
    }
  }

  if (valid) {
#pragma unroll
    for (int e = 0; e < DPT; ++e)
      dq[q_off + e * TPR + part] = from_f32<T>(round_to<T>(dqr[e]) * scale);
  }
}

struct Args {
  const void* q; const void* k; const void* v; const float* bias;
  const void* dout; const float* lse; const float* delta;
  void* dq; void* dk; void* dv; float* dbias_bh; float* dq_acc;
  int BH, H, Nq, Nk; float scale; int use_dropout; uint32_t threshold;
  float inv_keep; uint32_t seed; int q_offset, row_offset;
  cudaStream_t stream;
};

template <typename T, int D, bool kFusedDq>
int launch_dkv(const Args& a) {
  const dim3 grid((a.Nk + Split<D>::ROWS - 1) / Split<D>::ROWS, a.BH);
  flash_bwd_dkv<T, D, kFusedDq><<<grid, kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.bias, static_cast<const T*>(a.dout),
      a.lse, a.delta, static_cast<T*>(a.dk), static_cast<T*>(a.dv),
      a.dbias_bh, a.dq_acc, a.H, a.Nq, a.Nk, a.scale, a.use_dropout,
      a.threshold, a.inv_keep, a.seed, a.q_offset, a.row_offset);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_dq(const Args& a) {
  const dim3 grid((a.Nq + Split<D>::ROWS - 1) / Split<D>::ROWS, a.BH);
  flash_bwd_dq<T, D><<<grid, kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.bias, static_cast<const T*>(a.dout),
      a.lse, a.delta, static_cast<T*>(a.dq), a.H, a.Nq, a.Nk, a.scale,
      a.use_dropout, a.threshold, a.inv_keep, a.seed, a.q_offset,
      a.row_offset);
  return static_cast<int>(cudaGetLastError());
}

// kernel: 0 = dkv, 1 = dkv with fused dq, 2 = dq.
template <typename T, int D>
int launch(int kernel, const Args& a) {
  switch (kernel) {
    case 0: return launch_dkv<T, D, false>(a);
    case 1: return launch_dkv<T, D, true>(a);
    case 2: return launch_dq<T, D>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int dispatch(int d, int kernel, const Args& a) {
  switch (d) {
    case 8: return launch<T, 8>(kernel, a);
    case 16: return launch<T, 16>(kernel, a);
    case 48: return launch<T, 48>(kernel, a);
    case 64: return launch<T, 64>(kernel, a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// One launch of a K2 backward kernel on `stream`.
// kernel: 0 = dkv (writes dk, dv, dbias_bh), 1 = dkv with fused dq (also
// adds into dq_acc, a zeroed f32 [BH, Nq, d] buffer), 2 = dq (writes dq).
// Pointers a kernel does not use may be null. q, dout: [BH, Nq, d]; k, v:
// [BH, Nk, d]; f32 (is_bf16 = 0) or bf16 (is_bf16 = 1), contiguous. bias:
// [H, Nk] f32; lse, delta: [BH, Nq] f32; dbias_bh: [BH, Nk] f32. scale:
// d^-1/2 rounded to the input type. Returns the cudaError_t of the launch.
extern "C" int lunaris_flash_attention_bwd(
    int kernel, const void* q, const void* k, const void* v, const void* bias,
    const void* dout, const void* lse, const void* delta, void* dq, void* dk,
    void* dv, void* dbias_bh, void* dq_acc, int BH, int H, int Nq, int Nk,
    int d, float scale, int use_dropout, unsigned int threshold,
    float inv_keep, unsigned int seed, int q_offset, int row_offset,
    int is_bf16, void* stream) {
  if (BH <= 0 || H <= 0 || Nq <= 0 || Nk <= 0 || BH > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{q, k, v, static_cast<const float*>(bias), dout,
         static_cast<const float*>(lse), static_cast<const float*>(delta),
         dq, dk, dv, static_cast<float*>(dbias_bh),
         static_cast<float*>(dq_acc), BH, H, Nq, Nk, scale, use_dropout,
         threshold, inv_keep, seed, q_offset, row_offset,
         static_cast<cudaStream_t>(stream)};
  if (is_bf16) return dispatch<__nv_bfloat16>(d, kernel, a);
  return dispatch<float>(d, kernel, a);
}
