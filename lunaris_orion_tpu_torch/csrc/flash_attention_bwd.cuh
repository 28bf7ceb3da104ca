// K2 backward -- the kernel bodies of the gradients of flash attention with a
// per-key bias and hash dropout, for Hopper (sm_90a). Included by the
// flash_attention_bwd*.cu sources; the build hashes this header with them.
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
// Dropout regenerates the forward's mask from absolute (row_seed, k, q): the
// hash of flash_attention_common.cuh, so any tiling of either kernel sees the
// same bits. q positions are q_offset + row; rows of BH are numbered from
// row_offset.
//
// Bound. At the teacher's d = 16 the pair does 14 N^2 d operations on O(N d)
// bytes: operations. On the tensor cores the seven products are 7.9 ms at
// B 16, H 8, N 16384, so what is left on the CUDA cores bounds the kernels:
// per score one ex2 on the special-function units (16 a clock an SM), the
// FMA before it, ds = p (dpd - delta), the row sum of ds, the packs to bf16
// and, with dropout, the hash (five integer instructions at half the f32
// rate) and two selects.
//
// Two bodies a kernel:
//
//   flash_bwd_dkv_mma, flash_bwd_dq_mma   bf16, D a multiple of 16, on the
//       tensor cores with mma.sync m16n8k16 (bf16 x bf16 -> f32); 4 warps a
//       block, a warp owns two 16-row tiles at d = 16 (one fragment of the
//       walked operand serves both) and one at d 32, 48 and 64.
//     dkv: one block per (BH row, 128 or 64 keys). K and V of a warp's keys
//       are A fragments, read once and kept in registers with the keys'
//       bias. The block walks the queries in tiles of 64 that arrive by
//       cp.async in a ring of 2 or 3 (q, dO as bf16, rows padded by 16 bytes
//       against bank conflicts; lse, delta as f32). The thread that copied a
//       chunk of q scales and rounds it in place once it has landed (qs is
//       needed by two products, through plain and transposed fragments), and
//       turns lse into -lse log2 e (-inf past Nq, so that p = 0 there; q and
//       dO past Nq are zeros). Per 16 queries: s^T = k qs^T with the bias as
//       the c operand and dp^T = v dO^T (the tile's rows are the `col`
//       operand: ldmatrix), p = ex2(fma(s, log2 e, -lse log2 e)), the hash
//       from the fragment's own (key, query) coordinates, then ds and pv are
//       packed to bf16 in registers as the A fragments of dk += ds^T qs and
//       dv += pv^T dO (the same rows through ldmatrix.trans): p and ds never
//       touch shared memory, and only 16 queries' scores are live at a time.
//       dbias is this lane's f32 sum of ds, reduced over the 4 lanes of a
//       key with shuffles at the end and written once: no atomics, the same
//       order every run.
//     dq: one block per (BH row, 128 or 64 queries), the forward's shape.
//       qs (scaled and rounded once) and dO are A fragments in registers
//       with the rows' -lse log2 e and delta; K, V and the bias arrive in a
//       cp.async ring of key tiles of 64; the thread that copied a bias past
//       Nk sets it to -inf (K and V there are zeros), so p = 0 and no score
//       is masked. s = qs k^T (bias as the c operand), dp = dO v^T (K's and
//       V's rows are the `col` operand: ldmatrix), ds packed in registers as
//       the A fragment of dq += ds k (K through ldmatrix.trans).
//     Both sum their second products from zero over one tile of 64 and add
//     that to the f32 accumulators with one rounded add (the tensor cores'
//     own sums truncate, and N / 64 tiles follow each other). Rows past the
//     end of the block's own operand (keys in dkv, queries in dq) are
//     independent of the others: they read zeros and are not stored.
//     dkv with FUSED (the single-pass form of `_bwd_fused_kernel`, bf16 at
//       d 16 and 32): a fifth product per 16 queries, dq += round(ds) k over
//       the warp's keys. The ds fragments are the A operand of ds^T qs with
//       keys as rows; movmatrix.trans turns each 8 x 8 block in registers
//       into the A operand with queries as rows, and k's B fragments are kf
//       transposed the same way once, before the query walk. Each warp
//       parks its tile's f32 partial in shared memory; after the tile the
//       block sums its warps' partials in a fixed order and adds them to a
//       zeroed f32 [BH, Nq, d] buffer with one 16-byte reduction
//       (red.global.add.v4.f32) a chunk. So scores, ex2 and the hash are
//       computed once per (query, key) pair, and dq is order-dependent in its
//       last bits; dk, dv and dbias are not. 8 warps (256 keys) a block at
//       d 16, 4 at d 32; blocks start their query walk at their own tile so
//       that the blocks of one BH row do not add into the same rows at once.
//       At d 48 and 64 the dk/dv body alone fills the registers: the fused
//       form keeps its CUDA-core kernel there.
//   flash_bwd_dkv, flash_bwd_dq   f32 or bf16, on the CUDA cores (the first
//       version): each row is owned by TPR threads that keep it and its f32
//       accumulators in registers and walk the other operand in tiles of 32
//       staged in shared memory as f32; at d = 16 one thread owns one row,
//       at d = 32, 48 and 64 four threads share a row and combine their
//       partial dot products with warp shuffles. They are the f32 path, the
//       bf16 path at d = 8, and at d = 16 the earlier bf16 kernels that
//       measurements compare the tensor-core bodies with.
//     kFusedDq (the single-pass form on the CUDA cores: f32, and bf16 at
//       d 8, 48 and 64): dkv also forms dq. After each query tile its threads
//       park round_T(ds) in shared memory, the block reduces ds^T k over its
//       keys, and adds the tile's dq partial into a zeroed f32 [BH, Nq, d]
//       buffer with atomicAdd, so scores, exp and the mask are computed once
//       per (query, key) pair. The order of those atomic adds varies from
//       run to run: dq is then order-dependent in its last bits. Blocks
//       start their query walk at different tiles so that the blocks of one
//       BH row do not add into the same rows at the same time.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W, at B 16, H 8, N 16384,
// d 16, dropout 0.1, bf16, in turns in one process (chip_smoke.py, phase 7):
// dkv 141.7-142.2 ms on the CUDA cores, 35.4-35.9 ms on the tensor cores;
// dq 113.0 and 22.9 ms; the pair 58.3 ms where the backward of
// F.scaled_dot_product_attention takes 92.8 ms. Neither kernel is held by
// occupancy (dkv: 168-186 registers, two blocks an SM; eight warps of one
// tile at 128 registers were no faster): the per-score work on the CUDA
// cores, the ex2 and the mma each need about 9 ms at that shape and overlap
// only in part (PERF.md). The fused form on the tensor cores pays the
// per-score work once for the three gradients (PERF.md).

#pragma once

#include "flash_attention_common.cuh"

// Arguments of every backward kernel. Pointers a kernel does not use may be
// null. scale: d^-1/2 already rounded to the input type. threshold: the
// uint32 keep threshold, inv_keep: f32(1 / (1 - rate)). dq_acc: the fused
// variant's zeroed f32 [BH, Nq, d] buffer.
struct LunarisK2BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const float* bias;
  const void* dout;
  const float* lse;
  const float* delta;
  void* dq;
  void* dk;
  void* dv;
  float* dbias_bh;
  float* dq_acc;
  int BH, H, Nq, Nk;
  float scale;
  int use_dropout;
  uint32_t threshold;
  float inv_keep;
  uint32_t seed;
  int q_offset, row_offset;
};

// kernel ids of the C entry point.
constexpr int kBwdDkv = 0;
constexpr int kBwdDkvFusedDq = 1;
constexpr int kBwdDq = 2;

// One translation unit each (flash_attention_bwd_*.cu). Each returns the
// cudaError_t of the launch, cudaErrorInvalidValue for a head size or kernel
// it was not compiled for.
int lunaris_k2_bwd_simt_f32(const LunarisK2BwdArgs& a, int d, int kernel,
                            cudaStream_t s);
int lunaris_k2_bwd_simt_f32_wide(const LunarisK2BwdArgs& a, int d, int kernel,
                                 cudaStream_t s);
int lunaris_k2_bwd_simt_bf16(const LunarisK2BwdArgs& a, int d, int kernel,
                             cudaStream_t s);
int lunaris_k2_bwd_dkv_mma_bf16(const LunarisK2BwdArgs& a, int d,
                                cudaStream_t s);
int lunaris_k2_bwd_dq_mma_bf16(const LunarisK2BwdArgs& a, int d,
                               cudaStream_t s);
int lunaris_k2_bwd_fused_mma_bf16(const LunarisK2BwdArgs& a, int d,
                                  cudaStream_t s);
// Head size 32: every kernel of one body and type.
int lunaris_k2_bwd_mma_bf16_d32(const LunarisK2BwdArgs& a, int kernel,
                                cudaStream_t s);
int lunaris_k2_bwd_simt_f32_d32(const LunarisK2BwdArgs& a, int kernel,
                                cudaStream_t s);

namespace {

// ---- the CUDA-core bodies ---------------------------------------------------

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
  return keep_hash(row_seed + k_term + static_cast<uint32_t>(q_abs) * kC3,
                   threshold);
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

template <typename T, int D, bool kFusedDq>
int launch_dkv(const LunarisK2BwdArgs& a, cudaStream_t stream) {
  const dim3 grid((a.Nk + Split<D>::ROWS - 1) / Split<D>::ROWS, a.BH);
  flash_bwd_dkv<T, D, kFusedDq><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.bias, static_cast<const T*>(a.dout),
      a.lse, a.delta, static_cast<T*>(a.dk), static_cast<T*>(a.dv),
      a.dbias_bh, a.dq_acc, a.H, a.Nq, a.Nk, a.scale, a.use_dropout,
      a.threshold, a.inv_keep, a.seed, a.q_offset, a.row_offset);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_dq(const LunarisK2BwdArgs& a, cudaStream_t stream) {
  const dim3 grid((a.Nq + Split<D>::ROWS - 1) / Split<D>::ROWS, a.BH);
  flash_bwd_dq<T, D><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.bias, static_cast<const T*>(a.dout),
      a.lse, a.delta, static_cast<T*>(a.dq), a.H, a.Nq, a.Nk, a.scale,
      a.use_dropout, a.threshold, a.inv_keep, a.seed, a.q_offset,
      a.row_offset);
  return static_cast<int>(cudaGetLastError());
}

// All three kernels of one type and head size on the CUDA cores.
template <typename T, int D>
int launch_simt(int kernel, const LunarisK2BwdArgs& a, cudaStream_t s) {
  switch (kernel) {
    case kBwdDkv: return launch_dkv<T, D, false>(a, s);
    case kBwdDkvFusedDq: return launch_dkv<T, D, true>(a, s);
    case kBwdDq: return launch_dq<T, D>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---- the tensor-core bodies -------------------------------------------------

constexpr int kBwdMmaTile = 64;  // rows of the walked operand a tile

// Warps a block, and 16-row tiles a warp: two at d = 16, where one fragment
// of the walked operand then serves both, one at the wider heads, whose
// accumulators fill the registers. The fused form at d = 16 takes 8 warps (256
// keys): half the dq reductions into device memory, at the same 8 warps an SM
// (255 registers a thread, one block). Timed in turns on an H100 against 4
// warps, 8 were faster at d = 16 and slower at d = 32.
__host__ __device__ constexpr int bwd_mma_warps(int d, bool fused = false) {
  return fused && d <= 16 ? 8 : 4;
}
__host__ __device__ constexpr int bwd_mma_tiles(int d) { return d <= 16 ? 2 : 1; }
__host__ __device__ constexpr int bwd_mma_rows(int d, bool fused = false) {
  return 16 * bwd_mma_tiles(d) * bwd_mma_warps(d, fused);
}

// Tiles in flight: two bf16 matrices of [tile][d + 8] and two f32 vectors a
// stage; static shared memory stays under 48 KB at every D.
__host__ __device__ constexpr int bwd_mma_stages(int d) {
  return 3 * (2 * kBwdMmaTile * (d + 8) * 2 + 2 * kBwdMmaTile * 4) <= 48 * 1024
             ? 3 : 2;
}

// The fused form's dq partials of one query tile, one [tile][d + 8] f32
// matrix a warp (rows padded by 32 bytes: the float2 stores of a C fragment
// and the float4 reads of the reduction meet no bank conflict), in dynamic
// shared memory beside the static ring.
__host__ __device__ constexpr int bwd_mma_dq_part_bytes(int d) {
  return bwd_mma_warps(d, true) * kBwdMmaTile * (d + 8) * 4;
}

// A bf16 matrix's rows [row0, row0 + 16) x columns [16 kd, 16 kd + 16), kd <
// KD, as the A fragments of mma_bf16, read from device memory: `base` is the
// matrix's first element, `ld` its row length, rows at or past `rows` read
// as zeros, every pair times `scale` and rounded again (1: as it is).
template <int KD>
__device__ __forceinline__ void load_a_fragments(
    uint32_t (&f)[KD][4], const __nv_bfloat16* base, int ld, int row0, int rows,
    int lane, float scale) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kd = 0; kd < KD; ++kd)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + g + (i & 1) * 8;
      const int col = kd * 16 + (i >> 1) * 8 + 2 * t;
      uint32_t x = 0u;
      if (row < rows)
        x = *reinterpret_cast<const uint32_t*>(
            base + static_cast<long long>(row) * ld + col);
      f[kd][i] = scale == 1.f ? x : scale_bf16x2(x, scale);
    }
}

// FUSED: the single-pass form, which also adds dq into a.dq_acc.
template <int D, int DROP, bool RAGGED, bool FUSED = false>
__global__ void __launch_bounds__(32 * bwd_mma_warps(D, FUSED))
flash_bwd_dkv_mma(const LunarisK2BwdArgs a) {
  static_assert(D % 16 == 0, "the tensor-core body takes whole k-steps of 16");
  using bf16 = __nv_bfloat16;
  constexpr int W = bwd_mma_warps(D, FUSED);
  constexpr int MT = bwd_mma_tiles(D);
  constexpr int BQ = kBwdMmaTile;
  constexpr int THREADS = 32 * W;
  constexpr int ST = bwd_mma_stages(D);
  constexpr int LD = D + 8;        // a row and 16 bytes: ldmatrix without conflicts
  constexpr int LDQ = D + 8;       // a row of a dq partial, f32
  constexpr int KD = D / 16;       // k-steps of k qs^T; pairs of d tiles of dk
  __shared__ __align__(16) bf16 qs[ST][BQ][LD];
  __shared__ __align__(16) bf16 dos[ST][BQ][LD];
  __shared__ __align__(16) float ls[ST][BQ];    // -lse log2 e once landed
  __shared__ __align__(16) float dls[ST][BQ];
  extern __shared__ __align__(16) float dq_part[];  // FUSED: [W][BQ][LDQ]

  const int Nq = a.Nq, Nk = a.Nk;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = lane >> 2;         // the fragment's row (and row + 8): a key
  const int t = lane & 3;          // the fragment's column pair: queries
  const int bh = blockIdx.y;
  // Key g of this warp's first 16-key tile; tile mt, half r: + 16 mt + 8 r.
  const int key0 = (blockIdx.x * W + (tid >> 5)) * 16 * MT;
  const bf16* qb = static_cast<const bf16*>(a.q) + static_cast<long long>(bh) * Nq * D;
  const bf16* dob = static_cast<const bf16*>(a.dout) + static_cast<long long>(bh) * Nq * D;
  const float* lseb = a.lse + static_cast<long long>(bh) * Nq;
  const float* deltab = a.delta + static_cast<long long>(bh) * Nq;
  const bool drop = DROP == kDropOn || (DROP == kDropRuntime && a.use_dropout);
  const int tiles = (Nq + BQ - 1) / BQ;
  // The query tile of step i of the walk. The fused form starts each block
  // at its own tile, so that the blocks of one BH row do not add into the
  // same dq rows at once.
  const int first = FUSED ? blockIdx.x % tiles : 0;
  auto walk = [&](int i) {
    if constexpr (!FUSED) return i;
    const int x = first + i;
    return x < tiles ? x : x - tiles;
  };

  auto load_tile = [&](int i) {
    const int st = i % ST;
    const int q0 = walk(i) * BQ;
    for (int c = tid; c < BQ * (D / 8); c += THREADS) {
      const int r = c / (D / 8);
      const int d0 = (c % (D / 8)) * 8;
      const bool in = !RAGGED || q0 + r < Nq;
      const long long off = static_cast<long long>(in ? q0 + r : 0) * D + d0;
      cp_async_16(&qs[st][r][d0], qb + off, in ? 16 : 0);
      cp_async_16(&dos[st][r][d0], dob + off, in ? 16 : 0);
    }
    for (int c = tid; c < BQ; c += THREADS) {
      const bool in = !RAGGED || q0 + c < Nq;
      cp_async_4(&ls[st][c], lseb + (in ? q0 + c : 0), in ? 4 : 0);
      cp_async_4(&dls[st][c], deltab + (in ? q0 + c : 0), in ? 4 : 0);
    }
  };
  // What this thread copied of a tile, once it has landed: q becomes qs,
  // lse becomes -lse log2 e, or -inf past Nq (p = 0 there).
  auto finish_tile = [&](int i) {
    const int st = i % ST;
    const int q0 = walk(i) * BQ;
    for (int c = tid; c < BQ * (D / 8); c += THREADS) {
      uint4* chunk = reinterpret_cast<uint4*>(&qs[st][c / (D / 8)][(c % (D / 8)) * 8]);
      uint4 x = *chunk;
      x.x = scale_bf16x2(x.x, a.scale);
      x.y = scale_bf16x2(x.y, a.scale);
      x.z = scale_bf16x2(x.z, a.scale);
      x.w = scale_bf16x2(x.w, a.scale);
      *chunk = x;
    }
    for (int c = tid; c < BQ; c += THREADS)
      ls[st][c] = !RAGGED || q0 + c < Nq ? -ls[st][c] * kLog2e : -INFINITY;
  };

  // The first tiles go out before k and v are read.
#pragma unroll
  for (int i = 0; i < ST - 1; ++i) {
    if (i < tiles) load_tile(i);
    cp_async_commit();
  }

  // k and v as the A fragments of k qs^T and v dO^T, with the keys' bias
  // and the key's part of the hash.
  uint32_t kf[MT][KD][4], vf[MT][KD][4];
  float bk[MT][2], db[MT][2];
  uint32_t k_term[MT][2];
  float dk[MT][2 * KD][4], dv[MT][2 * KD][4];
  {
    const bf16* kb = static_cast<const bf16*>(a.k) + static_cast<long long>(bh) * Nk * D;
    const bf16* vb = static_cast<const bf16*>(a.v) + static_cast<long long>(bh) * Nk * D;
    const float* biasb = a.bias + static_cast<long long>(bh % a.H) * Nk;
    const uint32_t row_seed =
        a.seed ^ (static_cast<uint32_t>(bh + a.row_offset) * kC1);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      load_a_fragments<KD>(kf[mt], kb, D, key0 + 16 * mt, Nk, lane, 1.f);
      load_a_fragments<KD>(vf[mt], vb, D, key0 + 16 * mt, Nk, lane, 1.f);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int key = key0 + 16 * mt + 8 * r + g;
        bk[mt][r] = key < Nk ? biasb[key] : 0.f;
        db[mt][r] = 0.f;
        k_term[mt][r] = row_seed + static_cast<uint32_t>(key) * kC2;
      }
#pragma unroll
      for (int n = 0; n < 2 * KD; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) dk[mt][n][i] = dv[mt][n][i] = 0.f;
    }
  }
  // FUSED: k as the B fragments of ds k, the same for every query tile:
  // each 8 x 8 block of kf transposed, kq[mt][kd][2 c + r] holding keys
  // 8 r.. of the warp's tile mt and the d columns 16 kd + 8 c + g.
  uint32_t kq[FUSED ? MT : 1][FUSED ? KD : 1][4];
  if constexpr (FUSED) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int kd = 0; kd < KD; ++kd)
#pragma unroll
        for (int i = 0; i < 4; ++i) kq[mt][kd][i] = movmatrix_trans(kf[mt][kd][i]);
  }

  // ldmatrix: this lane's row and column offset within a 16 x 16 block of a
  // tile [query][d]: as the `col` operand of k qs^T (matrices: queries 0-7
  // d 0-7, queries 0-7 d 8-15, queries 8-15 d 0-7, queries 8-15 d 8-15) and,
  // transposed, of ds^T qs (queries 0-7 d 0-7, queries 8-15 d 0-7, queries
  // 0-7 d 8-15, queries 8-15 d 8-15).
  const int mi = lane >> 3;
  const int c_row = (mi >> 1) * 8 + (lane & 7), c_col = (mi & 1) * 8;
  const int t_row = (mi & 1) * 8 + (lane & 7), t_col = (mi >> 1) * 8;

  for (int it = 0; it < tiles; ++it) {
    cp_async_wait<ST - 2>();       // this thread's copies of the tile landed
    finish_tile(it);
    __syncthreads();               // the tile is whole; the one before is read
    if (it + ST - 1 < tiles) load_tile(it + ST - 1);
    cp_async_commit();
    const int st = it % ST;
    const int q0 = walk(it) * BQ;
    const uint32_t q_term = static_cast<uint32_t>(a.q_offset + q0 + 2 * t) * kC3;

    // The tile's share of dk and dv, summed from zero.
    float tk[MT][2 * KD][4], tv[MT][2 * KD][4];
#pragma unroll
    for (int j = 0; j < BQ / 16; ++j) {
      // Scores of 16 queries, transposed: rows are keys. Fragment n covers
      // queries 16 j + 8 n + 2 t + {0, 1}.
      float s[MT][2][4], dp[MT][2][4];
#pragma unroll
      for (int kd = 0; kd < KD; ++kd) {
        uint32_t qf[4], dof[4];
        ldmatrix_x4(qf, &qs[st][16 * j + c_row][16 * kd + c_col]);
        ldmatrix_x4(dof, &dos[st][16 * j + c_row][16 * kd + c_col]);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          if (kd == 0) {
            mma_bf16(s[mt][0], kf[mt][0], qf[0], qf[1], bk[mt][0], bk[mt][0],
                     bk[mt][1], bk[mt][1]);
            mma_bf16(s[mt][1], kf[mt][0], qf[2], qf[3], bk[mt][0], bk[mt][0],
                     bk[mt][1], bk[mt][1]);
            mma_bf16(dp[mt][0], vf[mt][0], dof[0], dof[1], 0.f, 0.f, 0.f, 0.f);
            mma_bf16(dp[mt][1], vf[mt][0], dof[2], dof[3], 0.f, 0.f, 0.f, 0.f);
          } else {
            mma_bf16(s[mt][0], kf[mt][kd], qf[0], qf[1]);
            mma_bf16(s[mt][1], kf[mt][kd], qf[2], qf[3]);
            mma_bf16(dp[mt][0], vf[mt][kd], dof[0], dof[1]);
            mma_bf16(dp[mt][1], vf[mt][kd], dof[2], dof[3]);
          }
        }
      }

      // Per query: -lse log2 e and delta, two values a fragment.
      float2 nl[2], dl[2];
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        nl[n] = *reinterpret_cast<const float2*>(&ls[st][16 * j + 8 * n + 2 * t]);
        dl[n] = *reinterpret_cast<const float2*>(&dls[st][16 * j + 8 * n + 2 * t]);
      }
      uint32_t dsf[MT][4], pvf[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          float ds[4], pv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p =
                ex2(fmaf(s[mt][n][i], kLog2e, i & 1 ? nl[n].y : nl[n].x));
            float dpd = dp[mt][n][i];
            pv[i] = p;
            if (drop) {
              const bool keep = keep_hash(
                  k_term[mt][i >> 1] + q_term +
                      static_cast<uint32_t>(16 * j + 8 * n + (i & 1)) * kC3,
                  a.threshold);
              dpd = keep ? dpd * a.inv_keep : 0.f;
              pv[i] = keep ? p * a.inv_keep : 0.f;
            }
            ds[i] = p * (dpd - (i & 1 ? dl[n].y : dl[n].x));
            db[mt][i >> 1] += ds[i];
          }
          // Rows g (i = 0, 1) and g + 8 (i = 2, 3) of the A fragment's
          // columns 8 n + 2 t + {0, 1}.
          dsf[mt][2 * n] = pack_bf16(ds[0], ds[1]);
          dsf[mt][2 * n + 1] = pack_bf16(ds[2], ds[3]);
          pvf[mt][2 * n] = pack_bf16(pv[0], pv[1]);
          pvf[mt][2 * n + 1] = pack_bf16(pv[2], pv[3]);
        }
      }

      // dk += ds^T qs, dv += pv^T dO over these 16 queries.
#pragma unroll
      for (int dd = 0; dd < KD; ++dd) {
        uint32_t qt[4], dot[4];
        ldmatrix_x4_trans(qt, &qs[st][16 * j + t_row][16 * dd + t_col]);
        ldmatrix_x4_trans(dot, &dos[st][16 * j + t_row][16 * dd + t_col]);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          if (j == 0) {
            mma_bf16(tk[mt][2 * dd], dsf[mt], qt[0], qt[1], 0.f, 0.f, 0.f, 0.f);
            mma_bf16(tk[mt][2 * dd + 1], dsf[mt], qt[2], qt[3], 0.f, 0.f, 0.f, 0.f);
            mma_bf16(tv[mt][2 * dd], pvf[mt], dot[0], dot[1], 0.f, 0.f, 0.f, 0.f);
            mma_bf16(tv[mt][2 * dd + 1], pvf[mt], dot[2], dot[3], 0.f, 0.f, 0.f, 0.f);
          } else {
            mma_bf16(tk[mt][2 * dd], dsf[mt], qt[0], qt[1]);
            mma_bf16(tk[mt][2 * dd + 1], dsf[mt], qt[2], qt[3]);
            mma_bf16(tv[mt][2 * dd], pvf[mt], dot[0], dot[1]);
            mma_bf16(tv[mt][2 * dd + 1], pvf[mt], dot[2], dot[3]);
          }
        }
      }

      if constexpr (FUSED) {
        // dq of these 16 queries over the warp's keys, ds k: ds^T's 8 x 8
        // blocks transposed in registers are the A fragment (rows now
        // queries), the warp's MT tiles sum in the accumulators. Fragment n
        // covers d columns 8 n + 2 t + {0, 1} of queries g and g + 8.
        float tq[2 * KD][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const uint32_t dsq[4] = {
              movmatrix_trans(dsf[mt][0]), movmatrix_trans(dsf[mt][2]),
              movmatrix_trans(dsf[mt][1]), movmatrix_trans(dsf[mt][3])};
#pragma unroll
          for (int n = 0; n < 2 * KD; ++n) {
            const uint32_t* b = kq[mt][n >> 1] + 2 * (n & 1);
            if (mt == 0)
              mma_bf16(tq[n], dsq, b[0], b[1], 0.f, 0.f, 0.f, 0.f);
            else
              mma_bf16(tq[n], dsq, b[0], b[1]);
          }
        }
        float* part = dq_part + ((tid >> 5) * BQ + 16 * j + g) * LDQ + 2 * t;
#pragma unroll
        for (int n = 0; n < 2 * KD; ++n) {
          *reinterpret_cast<float2*>(part + 8 * n) = make_float2(tq[n][0], tq[n][1]);
          *reinterpret_cast<float2*>(part + 8 * LDQ + 8 * n) =
              make_float2(tq[n][2], tq[n][3]);
        }
      }
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < 2 * KD; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          dk[mt][n][i] += tk[mt][n][i];
          dv[mt][n][i] += tv[mt][n][i];
        }

    if constexpr (FUSED) {
      // The block's dq of the tile: the W warps' partials summed in a fixed
      // order, then added to dq_acc with one 16-byte reduction a chunk. The
      // next tile's barrier keeps its partials from overwriting these.
      __syncthreads();
      float* acc = a.dq_acc + (static_cast<long long>(bh) * Nq + q0) * D;
      for (int c = tid; c < BQ * (D / 4); c += THREADS) {
        const int r = c / (D / 4);
        const int d0 = (c % (D / 4)) * 4;
        if (RAGGED && q0 + r >= Nq) break;   // rows only grow with c
        float4 s = *reinterpret_cast<const float4*>(dq_part + r * LDQ + d0);
#pragma unroll
        for (int w = 1; w < W; ++w) {
          const float4 x =
              *reinterpret_cast<const float4*>(dq_part + (w * BQ + r) * LDQ + d0);
          s.x += x.x;
          s.y += x.y;
          s.z += x.z;
          s.w += x.w;
        }
        atomicAdd(reinterpret_cast<float4*>(acc + r * D + d0), s);
      }
    }
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float dbr = db[mt][r];
      dbr += __shfl_xor_sync(0xffffffffu, dbr, 1);
      dbr += __shfl_xor_sync(0xffffffffu, dbr, 2);
      const int key = key0 + 16 * mt + 8 * r + g;
      if (key < Nk) {
        const long long off = (static_cast<long long>(bh) * Nk + key) * D;
        bf16* dkrow = static_cast<bf16*>(a.dk) + off;
        bf16* dvrow = static_cast<bf16*>(a.dv) + off;
#pragma unroll
        for (int n = 0; n < 2 * KD; ++n) {
          *reinterpret_cast<uint32_t*>(dkrow + 8 * n + 2 * t) =
              pack_bf16(dk[mt][n][2 * r], dk[mt][n][2 * r + 1]);
          *reinterpret_cast<uint32_t*>(dvrow + 8 * n + 2 * t) =
              pack_bf16(dv[mt][n][2 * r], dv[mt][n][2 * r + 1]);
        }
        if (t == 0) a.dbias_bh[static_cast<long long>(bh) * Nk + key] = dbr;
      }
    }
}

template <int D, int DROP, bool RAGGED>
__global__ void __launch_bounds__(32 * bwd_mma_warps(D))
flash_bwd_dq_mma(const LunarisK2BwdArgs a) {
  static_assert(D % 16 == 0, "the tensor-core body takes whole k-steps of 16");
  using bf16 = __nv_bfloat16;
  constexpr int W = bwd_mma_warps(D);
  constexpr int MT = bwd_mma_tiles(D);
  constexpr int BK = kBwdMmaTile;
  constexpr int THREADS = 32 * W;
  constexpr int ST = bwd_mma_stages(D);
  constexpr int LD = D + 8;
  constexpr int KD = D / 16;       // k-steps of qs k^T; pairs of d tiles of dq
  __shared__ __align__(16) bf16 ks[ST][BK][LD];
  __shared__ __align__(16) bf16 vs[ST][BK][LD];
  __shared__ __align__(16) float bs[ST][BK];

  const int Nq = a.Nq, Nk = a.Nk;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = lane >> 2;         // the fragment's row (and row + 8): a query
  const int t = lane & 3;          // the fragment's column pair: keys
  const int bh = blockIdx.y;
  // Row g of this warp's first 16-row tile; tile mt, half r: + 16 mt + 8 r.
  const int row0 = (blockIdx.x * W + (tid >> 5)) * 16 * MT;
  const bf16* kb = static_cast<const bf16*>(a.k) + static_cast<long long>(bh) * Nk * D;
  const bf16* vb = static_cast<const bf16*>(a.v) + static_cast<long long>(bh) * Nk * D;
  const float* biasb = a.bias + static_cast<long long>(bh % a.H) * Nk;
  const bool drop = DROP == kDropOn || (DROP == kDropRuntime && a.use_dropout);
  const int tiles = (Nk + BK - 1) / BK;

  auto load_tile = [&](int tile) {
    const int st = tile % ST;
    const int k0 = tile * BK;
    for (int c = tid; c < BK * (D / 8); c += THREADS) {
      const int r = c / (D / 8);
      const int d0 = (c % (D / 8)) * 8;
      const bool in = !RAGGED || k0 + r < Nk;
      const long long off = static_cast<long long>(in ? k0 + r : 0) * D + d0;
      cp_async_16(&ks[st][r][d0], kb + off, in ? 16 : 0);
      cp_async_16(&vs[st][r][d0], vb + off, in ? 16 : 0);
    }
    for (int c = tid; c < BK; c += THREADS) {
      const bool in = !RAGGED || k0 + c < Nk;
      cp_async_4(&bs[st][c], biasb + (in ? k0 + c : 0), in ? 4 : 0);
    }
  };

#pragma unroll
  for (int i = 0; i < ST - 1; ++i) {
    if (i < tiles) load_tile(i);
    cp_async_commit();
  }

  // qs (scaled and rounded once) and dO as A fragments, with the rows'
  // -lse log2 e (-inf past Nq), delta and the query's part of the hash.
  uint32_t qf[MT][KD][4], dof[MT][KD][4];
  float nl[MT][2], dl[MT][2];
  uint32_t q_term[MT][2];
  float dq[MT][2 * KD][4];
  {
    const bf16* qb = static_cast<const bf16*>(a.q) + static_cast<long long>(bh) * Nq * D;
    const bf16* dob = static_cast<const bf16*>(a.dout) + static_cast<long long>(bh) * Nq * D;
    const uint32_t row_seed =
        a.seed ^ (static_cast<uint32_t>(bh + a.row_offset) * kC1);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      load_a_fragments<KD>(qf[mt], qb, D, row0 + 16 * mt, Nq, lane, a.scale);
      load_a_fragments<KD>(dof[mt], dob, D, row0 + 16 * mt, Nq, lane, 1.f);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + 16 * mt + 8 * r + g;
        const long long off = static_cast<long long>(bh) * Nq + row;
        nl[mt][r] = row < Nq ? -a.lse[off] * kLog2e : -INFINITY;
        dl[mt][r] = row < Nq ? a.delta[off] : 0.f;
        q_term[mt][r] =
            row_seed + static_cast<uint32_t>(a.q_offset + row) * kC3;
      }
#pragma unroll
      for (int n = 0; n < 2 * KD; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) dq[mt][n][i] = 0.f;
    }
  }

  // ldmatrix offsets within a 16 x 16 block of a tile [key][d]: as the `col`
  // operand of qs k^T and dO v^T, and transposed as that of ds k.
  const int mi = lane >> 3;
  const int c_row = (mi >> 1) * 8 + (lane & 7), c_col = (mi & 1) * 8;
  const int t_row = (mi & 1) * 8 + (lane & 7), t_col = (mi >> 1) * 8;

  for (int tile = 0; tile < tiles; ++tile) {
    cp_async_wait<ST - 2>();       // this thread's copies of the tile landed
    const int st = tile % ST;
    const int k0 = tile * BK;
    if (RAGGED && k0 + BK > Nk)    // p = 0 past Nk (k and v there are zeros)
      for (int c = tid; c < BK; c += THREADS)
        if (k0 + c >= Nk) bs[st][c] = -INFINITY;
    __syncthreads();               // the tile is whole; the one before is read
    if (tile + ST - 1 < tiles) load_tile(tile + ST - 1);
    cp_async_commit();
    const uint32_t k_term = static_cast<uint32_t>(k0 + 2 * t) * kC2;

    // The tile's share of dq, summed from zero.
    float tq[MT][2 * KD][4];
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      // Scores of 16 keys. Fragment n covers keys 16 j + 8 n + 2 t + {0, 1}.
      float s[MT][2][4], dp[MT][2][4];
      float2 b[2];
#pragma unroll
      for (int n = 0; n < 2; ++n)
        b[n] = *reinterpret_cast<const float2*>(&bs[st][16 * j + 8 * n + 2 * t]);
#pragma unroll
      for (int kd = 0; kd < KD; ++kd) {
        uint32_t kf[4], vf[4];
        ldmatrix_x4(kf, &ks[st][16 * j + c_row][16 * kd + c_col]);
        ldmatrix_x4(vf, &vs[st][16 * j + c_row][16 * kd + c_col]);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          if (kd == 0) {
            mma_bf16(s[mt][0], qf[mt][0], kf[0], kf[1], b[0].x, b[0].y, b[0].x,
                     b[0].y);
            mma_bf16(s[mt][1], qf[mt][0], kf[2], kf[3], b[1].x, b[1].y, b[1].x,
                     b[1].y);
            mma_bf16(dp[mt][0], dof[mt][0], vf[0], vf[1], 0.f, 0.f, 0.f, 0.f);
            mma_bf16(dp[mt][1], dof[mt][0], vf[2], vf[3], 0.f, 0.f, 0.f, 0.f);
          } else {
            mma_bf16(s[mt][0], qf[mt][kd], kf[0], kf[1]);
            mma_bf16(s[mt][1], qf[mt][kd], kf[2], kf[3]);
            mma_bf16(dp[mt][0], dof[mt][kd], vf[0], vf[1]);
            mma_bf16(dp[mt][1], dof[mt][kd], vf[2], vf[3]);
          }
        }
      }

      uint32_t dsf[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          float ds[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = ex2(fmaf(s[mt][n][i], kLog2e, nl[mt][i >> 1]));
            float dpd = dp[mt][n][i];
            if (drop) {
              const bool keep = keep_hash(
                  q_term[mt][i >> 1] + k_term +
                      static_cast<uint32_t>(16 * j + 8 * n + (i & 1)) * kC2,
                  a.threshold);
              dpd = keep ? dpd * a.inv_keep : 0.f;
            }
            ds[i] = p * (dpd - dl[mt][i >> 1]);
          }
          dsf[mt][2 * n] = pack_bf16(ds[0], ds[1]);
          dsf[mt][2 * n + 1] = pack_bf16(ds[2], ds[3]);
        }

      // dq += ds k over these 16 keys.
#pragma unroll
      for (int dd = 0; dd < KD; ++dd) {
        uint32_t kt[4];
        ldmatrix_x4_trans(kt, &ks[st][16 * j + t_row][16 * dd + t_col]);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          if (j == 0) {
            mma_bf16(tq[mt][2 * dd], dsf[mt], kt[0], kt[1], 0.f, 0.f, 0.f, 0.f);
            mma_bf16(tq[mt][2 * dd + 1], dsf[mt], kt[2], kt[3], 0.f, 0.f, 0.f, 0.f);
          } else {
            mma_bf16(tq[mt][2 * dd], dsf[mt], kt[0], kt[1]);
            mma_bf16(tq[mt][2 * dd + 1], dsf[mt], kt[2], kt[3]);
          }
        }
      }
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < 2 * KD; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) dq[mt][n][i] += tq[mt][n][i];
  }

  // dq = round(round(dq) d^-1/2): the TPU kernel's two roundings.
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 16 * mt + 8 * r + g;
      if (row < Nq) {
        bf16* dqrow = static_cast<bf16*>(a.dq) +
                      (static_cast<long long>(bh) * Nq + row) * D;
#pragma unroll
        for (int n = 0; n < 2 * KD; ++n)
          *reinterpret_cast<uint32_t*>(dqrow + 8 * n + 2 * t) = scale_bf16x2(
              pack_bf16(dq[mt][n][2 * r], dq[mt][n][2 * r + 1]), a.scale);
      }
    }
}

// cp.async moves 16 bytes of q, dO, k and v (rows are aligned when the
// tensors are) and 4 of lse, delta and the bias.
inline bool bwd_mma_aligned(const LunarisK2BwdArgs& a) {
  return reinterpret_cast<uintptr_t>(a.q) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(a.k) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(a.v) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(a.dout) % 16 == 0;
}

// RAGGED: of the walked operand, Nq here. FUSED also adds dq into dq_acc,
// whose rows take 16-byte reductions.
template <int D, int DROP, bool RAGGED, bool FUSED = false>
int launch_dkv_mma(const LunarisK2BwdArgs& a, cudaStream_t stream) {
  if ((!RAGGED && a.Nq % kBwdMmaTile != 0) || !bwd_mma_aligned(a) ||
      reinterpret_cast<uintptr_t>(a.dk) % 4 != 0 ||
      reinterpret_cast<uintptr_t>(a.dv) % 4 != 0 ||
      (FUSED && (a.dq_acc == nullptr ||
                 reinterpret_cast<uintptr_t>(a.dq_acc) % 16 != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int rows = bwd_mma_rows(D, FUSED);
  const dim3 grid((a.Nk + rows - 1) / rows, a.BH);
  const auto kernel = flash_bwd_dkv_mma<D, DROP, RAGGED, FUSED>;
  constexpr int smem = FUSED ? bwd_mma_dq_part_bytes(D) : 0;
  if (smem > 0) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<grid, 32 * bwd_mma_warps(D, FUSED), smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// RAGGED: of the walked operand, Nk here.
template <int D, int DROP, bool RAGGED>
int launch_dq_mma(const LunarisK2BwdArgs& a, cudaStream_t stream) {
  if ((!RAGGED && a.Nk % kBwdMmaTile != 0) || !bwd_mma_aligned(a) ||
      reinterpret_cast<uintptr_t>(a.dq) % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((a.Nq + bwd_mma_rows(D) - 1) / bwd_mma_rows(D), a.BH);
  flash_bwd_dq_mma<D, DROP, RAGGED>
      <<<grid, 32 * bwd_mma_warps(D), 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
