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
// Two bodies a kernel, and for the fused kernel three more: in f32 on three
// TF32 passes, and in bf16 on wgmma at d 48 and 64 (flash_bwd_wgmma) and at
// d 16 and 32 (flash_bwd_wgmma_narrow; their own notes below):
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
//       d 16 and 32 where Nq or Nk is shorter than the narrow body pays
//       back, the windowed fold): a fifth product per 16 queries,
//       dq += round(ds) k over the warp's keys. The ds fragments are the A operand of ds^T qs with
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
//       form there is flash_bwd_wgmma, which keeps K and V in shared memory.
//   flash_bwd_fused_tf32   f32 at D 16 and 32, the fused form only: the
//       five products on mma.sync m16n8k8 tf32 in three passes (its own
//       note, below).
//   flash_bwd_dkv, flash_bwd_dq   f32 or bf16, on the CUDA cores (the first
//       version): each row is owned by TPR threads that keep it and its f32
//       accumulators in registers and walk the other operand in tiles of 32
//       staged in shared memory as f32; at d = 16 one thread owns one row,
//       at d = 32, 48 and 64 four threads share a row and combine their
//       partial dot products with warp shuffles. They are the f32 split
//       path, the bf16 path at d = 8, and at d = 16 the earlier bf16 kernels
//       that measurements compare the tensor-core bodies with.
//     kFusedDq (the single-pass form on the CUDA cores: f32 and bf16 at
//       d 8, f32 at 48 and 64; f32 at d 16 and 32 and bf16 at 16, 48 and 64
//       for comparisons): dkv also forms
//       dq. After each query tile its threads
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
int lunaris_k2_bwd_fused_tf32(const LunarisK2BwdArgs& a, int d,
                              cudaStream_t s);
// Head size 32: every kernel of one body and type.
int lunaris_k2_bwd_mma_bf16_d32(const LunarisK2BwdArgs& a, int kernel,
                                cudaStream_t s);
// The fused kernel's warpgroup body, bf16 at d 48 and 64, one translation
// unit an instance (flash_attention_bwd_wgmma_d{48,64}{,_drop}.cu).
int lunaris_k2_bwd_wgmma_d48(const LunarisK2BwdArgs& a, cudaStream_t s);
int lunaris_k2_bwd_wgmma_d48_drop(const LunarisK2BwdArgs& a, cudaStream_t s);
int lunaris_k2_bwd_wgmma_d64(const LunarisK2BwdArgs& a, cudaStream_t s);
int lunaris_k2_bwd_wgmma_d64_drop(const LunarisK2BwdArgs& a, cudaStream_t s);
// The narrow fused warpgroup body, bf16 at d 16 and 32
// (flash_attention_bwd_wgmma_d{16,32}{,_drop}.cu).
int lunaris_k2_bwd_wgmma_d16(const LunarisK2BwdArgs& a, cudaStream_t s);
int lunaris_k2_bwd_wgmma_d16_drop(const LunarisK2BwdArgs& a, cudaStream_t s);
int lunaris_k2_bwd_wgmma_d32(const LunarisK2BwdArgs& a, cudaStream_t s);
int lunaris_k2_bwd_wgmma_d32_drop(const LunarisK2BwdArgs& a, cudaStream_t s);
int lunaris_k2_bwd_simt_f32_d32(const LunarisK2BwdArgs& a, int kernel,
                                cudaStream_t s);
// The f32 fused warpgroup body at d 16, 32, 48 and 64
// (flash_attention_bwd_wgmma_tf32_d{16,32,48,64}{,_drop}.cu), on the tiles
// the pre-pass wrote (`split`: flash_attention_tf32_split.cu).
int lunaris_k2_bwd_wgmma_tf32_d16(const LunarisK2BwdArgs& a, const void* split,
                                  cudaStream_t s);
int lunaris_k2_bwd_wgmma_tf32_d16_drop(const LunarisK2BwdArgs& a,
                                       const void* split, cudaStream_t s);
int lunaris_k2_bwd_wgmma_tf32_d32(const LunarisK2BwdArgs& a, const void* split,
                                  cudaStream_t s);
int lunaris_k2_bwd_wgmma_tf32_d32_drop(const LunarisK2BwdArgs& a,
                                       const void* split, cudaStream_t s);
int lunaris_k2_bwd_wgmma_tf32_d48(const LunarisK2BwdArgs& a, const void* split,
                                  cudaStream_t s);
int lunaris_k2_bwd_wgmma_tf32_d48_drop(const LunarisK2BwdArgs& a,
                                       const void* split, cudaStream_t s);
int lunaris_k2_bwd_wgmma_tf32_d64(const LunarisK2BwdArgs& a, const void* split,
                                  cudaStream_t s);
int lunaris_k2_bwd_wgmma_tf32_d64_drop(const LunarisK2BwdArgs& a,
                                       const void* split, cudaStream_t s);

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

// ---- the fused tensor-core body for f32: three TF32 passes ------------------

constexpr int kBwdTf32Warps = 4;    // a warp owns 16 keys: 64 keys a block
constexpr int kBwdTf32Keys = 16 * kBwdTf32Warps;
constexpr int kBwdTf32Stages = 2;
// Queries a tile of the walk: 64, and 32 at d 32, where the ring, the
// block's k and the dq partials would otherwise hold one block an SM.
__host__ __device__ constexpr int bwd_tf32_tile(int d) { return d <= 16 ? 64 : 32; }
// A stage of the ring, in floats: qs and dO, each as TF32 hi and lo in rows
// of d + 4 (the fragments' reads meet no bank conflict), -lse log2 e, delta.
__host__ __device__ constexpr int bwd_tf32_stage_floats(int d) {
  return 4 * bwd_tf32_tile(d) * (d + 4) + 2 * bwd_tf32_tile(d);
}
// The ring, the block's k as hi and lo (the B operand of ds k), and each
// warp's dq partial of a tile in rows of d + 8 (float2 stores of a C
// fragment without bank conflicts).
__host__ __device__ constexpr int bwd_tf32_smem_bytes(int d) {
  return 4 * (kBwdTf32Stages * bwd_tf32_stage_floats(d) +
              2 * kBwdTf32Keys * (d + 4) +
              kBwdTf32Warps * bwd_tf32_tile(d) * (d + 8));
}

// flash_bwd_fused_tf32  f32 at D 16 and 32: flash_bwd_dkv_mma<..., FUSED>
// carried to 32-bit fragments, its five products (s^T = k qs^T, dp^T =
// v dO^T, dk += ds^T qs, dv += pv^T dO, dq += ds k) on mma.sync m16n8k8 tf32
// in three passes each (mma_tf32x3), which hold f32's accuracy. It computes
// what flash_bwd_dkv<float, D, true> computes: dk, dv and dbias of a block's
// keys, and dq added into the zeroed f32 dq_acc (its last bits vary from run
// to run with the order of the atomic adds; dk, dv and dbias do not).
//   k and v of a warp's 16 keys are A fragments, split into TF32 hi and lo
//   once, with the keys' bias (the c operand of the first pass of s^T). The
//   queries arrive in a cp.async ring of two tiles (q, dO, lse, delta); the
//   thread that copied a chunk scales q, splits q and dO in place (hi) and
//   beside (lo), and turns lse into -lse log2 e (-inf past Nq, so p = 0).
//   Per 16 queries: s^T and dp^T, p = ex2(fma(s, log2 e, -lse log2 e)), the
//   hash from the C fragment's own (key, query), ds and pv in f32. dk and dv
//   take ds^T and pv^T straight from the C fragments: an 8-query score tile
//   is a k-step with k index t as query 2t and t + 4 as 2t + 1, and qs / dO
//   are read in that order (rows 2t and 2t + 1 of the tile). The block's
//   other warps, then the blocks of a BH row, sum dq as in the bf16 body:
//   each warp's partial in shared memory, summed in a fixed order and added
//   with one 16-byte reduction a chunk; blocks start their walk at their
//   own tile.
// Where the 32-bit fragments differ from the bf16 ones:
//   - ldmatrix and movmatrix move 16-bit elements. The B operands are read
//     with 32-bit shared loads from rows of d + 4 floats. dq's A operand,
//     ds with queries as rows, is ds^T's C fragment transposed across the
//     warp: for keys 8 kk + 2t and + 1, queries g and g + 8, lanes 8t +
//     g / 2 and 8t + 4 + g / 2 hold the values; two shuffles a value (the
//     source lane cannot know which of its pair a reader wants) and a
//     select. k, the B operand of ds k, is staged once in shared memory as
//     hi and lo and read in the same key order.
//   - The dropout hash is taken on s^T's C fragment, before any
//     permutation, so k_abs and q_abs are the true key and query.
//   - Fragments are twice the bf16 body's registers: 4 warps of 16 keys
//     (the bf16 body: 8 warps of 32 at d 16), and 32-query tiles at d 32.
template <int D, int DROP, bool RAGGED>
__global__ void __launch_bounds__(32 * kBwdTf32Warps)
flash_bwd_fused_tf32(const LunarisK2BwdArgs a) {
  static_assert(D % 8 == 0 && D <= 32, "the fused TF32 body takes d 16 and 32");
  constexpr int W = kBwdTf32Warps;
  constexpr int BQ = bwd_tf32_tile(D);
  constexpr int THREADS = 32 * W;
  constexpr int ST = kBwdTf32Stages;
  constexpr int LD = D + 4;
  constexpr int LDQ = D + 8;
  constexpr int KD = D / 8;        // k-steps over d; d tiles of dk, dv, dq
  constexpr int SF = bwd_tf32_stage_floats(D);
  constexpr int M = BQ * LD;       // one matrix of a stage
  extern __shared__ __align__(16) float tf32_bwd_smem[];
  float* const kbh = tf32_bwd_smem + ST * SF;   // [kBwdTf32Keys][LD]: k hi
  float* const kbl = kbh + kBwdTf32Keys * LD;   // and lo
  float* const dq_part = kbl + kBwdTf32Keys * LD;  // [W][BQ][LDQ]

  const int Nq = a.Nq, Nk = a.Nk;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;         // the fragment's row (and row + 8): a key
  const int t = lane & 3;          // the fragment's column pair: queries
  const int bh = blockIdx.y;
  const int key0 = (blockIdx.x * W + warp) * 16;   // this warp's 16 keys
  const float* qb = static_cast<const float*>(a.q) + static_cast<long long>(bh) * Nq * D;
  const float* dob = static_cast<const float*>(a.dout) + static_cast<long long>(bh) * Nq * D;
  const float* kb = static_cast<const float*>(a.k) + static_cast<long long>(bh) * Nk * D;
  const float* vb = static_cast<const float*>(a.v) + static_cast<long long>(bh) * Nk * D;
  const float* lseb = a.lse + static_cast<long long>(bh) * Nq;
  const float* deltab = a.delta + static_cast<long long>(bh) * Nq;
  const bool drop = DROP == kDropOn || (DROP == kDropRuntime && a.use_dropout);
  const int tiles = (Nq + BQ - 1) / BQ;
  const int first = blockIdx.x % tiles;
  auto walk = [&](int i) {
    const int x = first + i;
    return x < tiles ? x : x - tiles;
  };

  // A stage: [qh, ql, doh, dol] matrices of [BQ][LD], then ls, dls [BQ].
  auto load_tile = [&](int i) {
    float* s = tf32_bwd_smem + (i % ST) * SF;
    const int q0 = walk(i) * BQ;
    for (int c = tid; c < BQ * (D / 4); c += THREADS) {
      const int r = c / (D / 4);
      const int d0 = (c % (D / 4)) * 4;
      const bool in = !RAGGED || q0 + r < Nq;
      const long long off = static_cast<long long>(in ? q0 + r : 0) * D + d0;
      cp_async_16(s + r * LD + d0, qb + off, in ? 16 : 0);
      cp_async_16(s + 2 * M + r * LD + d0, dob + off, in ? 16 : 0);
    }
    for (int c = tid; c < BQ; c += THREADS) {
      const bool in = !RAGGED || q0 + c < Nq;
      cp_async_4(s + 4 * M + c, lseb + (in ? q0 + c : 0), in ? 4 : 0);
      cp_async_4(s + 4 * M + BQ + c, deltab + (in ? q0 + c : 0), in ? 4 : 0);
    }
  };
  auto finish_tile = [&](int i) {
    float* s = tf32_bwd_smem + (i % ST) * SF;
    const int q0 = walk(i) * BQ;
    for (int c = tid; c < BQ * (D / 4); c += THREADS) {
      const int o = (c / (D / 4)) * LD + (c % (D / 4)) * 4;
      float4 x = *reinterpret_cast<const float4*>(s + o);
      x.x *= a.scale;
      x.y *= a.scale;
      x.z *= a.scale;
      x.w *= a.scale;
      float4 h, l;
      split_tf32(x, h, l);
      *reinterpret_cast<float4*>(s + o) = h;
      *reinterpret_cast<float4*>(s + M + o) = l;
      split_tf32(*reinterpret_cast<const float4*>(s + 2 * M + o), h, l);
      *reinterpret_cast<float4*>(s + 2 * M + o) = h;
      *reinterpret_cast<float4*>(s + 3 * M + o) = l;
    }
    float* ls = s + 4 * M;
    for (int c = tid; c < BQ; c += THREADS)
      ls[c] = !RAGGED || q0 + c < Nq ? -ls[c] * kLog2e : -INFINITY;
  };

  // The first tiles go out before k and v are read.
#pragma unroll
  for (int i = 0; i < ST - 1; ++i) {
    if (i < tiles) load_tile(i);
    cp_async_commit();
  }

  // The block's keys, the B operand of ds k, as hi and lo (zeros past Nk).
  for (int c = tid; c < kBwdTf32Keys * D; c += THREADS) {
    const int r = c / D, d = c % D;
    const int key = blockIdx.x * kBwdTf32Keys + r;
    uint32_t h, l;
    split_tf32(key < Nk ? kb[static_cast<long long>(key) * D + d] : 0.f, h, l);
    kbh[r * LD + d] = __uint_as_float(h);
    kbl[r * LD + d] = __uint_as_float(l);
  }

  // k and v as the A fragments of s^T and dp^T (key g, dims 8 kd + t and
  // + 4), with the keys' bias and the key's part of the hash.
  uint32_t kh[KD][4], kl[KD][4], vh[KD][4], vl[KD][4];
  float bk[2], db[2];
  uint32_t k_term[2];
  float dk[KD][4], dv[KD][4];
  {
    const float* biasb = a.bias + static_cast<long long>(bh % a.H) * Nk;
    const uint32_t row_seed =
        a.seed ^ (static_cast<uint32_t>(bh + a.row_offset) * kC1);
#pragma unroll
    for (int kd = 0; kd < KD; ++kd)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = key0 + g + (i & 1) * 8;
        const long long off = static_cast<long long>(key) * D + 8 * kd + t + (i >> 1) * 4;
        split_tf32(key < Nk ? kb[off] : 0.f, kh[kd][i], kl[kd][i]);
        split_tf32(key < Nk ? vb[off] : 0.f, vh[kd][i], vl[kd][i]);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = key0 + 8 * r + g;
      bk[r] = key < Nk ? biasb[key] : 0.f;
      db[r] = 0.f;
      k_term[r] = row_seed + static_cast<uint32_t>(key) * kC2;
    }
#pragma unroll
    for (int n = 0; n < KD; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) dk[n][i] = dv[n][i] = 0.f;
  }
  const float* kwh = kbh + warp * 16 * LD;   // this warp's keys in kbh, kbl
  const float* kwl = kbl + warp * 16 * LD;
  const bool odd = g & 1;

  for (int it = 0; it < tiles; ++it) {
    cp_async_wait<ST - 2>();       // this thread's copies of the tile landed
    finish_tile(it);
    __syncthreads();               // the tile is whole; the one before is read
    if (it + ST - 1 < tiles) load_tile(it + ST - 1);
    cp_async_commit();
    const float* qh = tf32_bwd_smem + (it % ST) * SF;
    const float* ql = qh + M;
    const float* doh = qh + 2 * M;
    const float* dol = qh + 3 * M;
    const float* ls = qh + 4 * M;
    const float* dls = ls + BQ;
    const int q0 = walk(it) * BQ;
    const uint32_t q_term = static_cast<uint32_t>(a.q_offset + q0 + 2 * t) * kC3;

    // The tile's share of dk and dv, summed from zero.
    float tk[KD][4], tv[KD][4];
#pragma unroll
    for (int j = 0; j < BQ / 16; ++j) {
      // s^T and dp^T of 16 queries: tile n covers queries 16 j + 8 n +
      // {2t, 2t + 1}; the B fragments: query 16 j + 8 n + g, dims 8 kd + t
      // and + 4.
      float s[2][4], dp[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        s[n][0] = s[n][1] = bk[0];
        s[n][2] = s[n][3] = bk[1];
        dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
#pragma unroll
        for (int kd = 0; kd < KD; ++kd) {
          const int o = (16 * j + 8 * n + g) * LD + 8 * kd + t;
          mma_tf32x3(s[n], kh[kd], kl[kd], __float_as_uint(qh[o]),
                     __float_as_uint(qh[o + 4]), __float_as_uint(ql[o]),
                     __float_as_uint(ql[o + 4]));
          mma_tf32x3(dp[n], vh[kd], vl[kd], __float_as_uint(doh[o]),
                     __float_as_uint(doh[o + 4]), __float_as_uint(dol[o]),
                     __float_as_uint(dol[o + 4]));
        }
      }

      // p, the mask, ds and pv: ds in place of s, pv in place of dp.
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const float2 nl = *reinterpret_cast<const float2*>(ls + 16 * j + 8 * n + 2 * t);
        const float2 dl = *reinterpret_cast<const float2*>(dls + 16 * j + 8 * n + 2 * t);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = ex2(fmaf(s[n][i], kLog2e, i & 1 ? nl.y : nl.x));
          float dpd = dp[n][i];
          float pv = p;
          if (drop) {
            const bool keep = keep_hash(
                k_term[i >> 1] + q_term +
                    static_cast<uint32_t>(16 * j + 8 * n + (i & 1)) * kC3,
                a.threshold);
            dpd = keep ? dpd * a.inv_keep : 0.f;
            pv = keep ? p * a.inv_keep : 0.f;
          }
          const float ds = p * (dpd - (i & 1 ? dl.y : dl.x));
          db[i >> 1] += ds;
          s[n][i] = ds;
          dp[n][i] = pv;
        }
      }

      // dk += ds^T qs, dv += pv^T dO: the C fragment {c0, c1, c2, c3} of
      // tile n is the A fragment {a0, a2, a1, a3}, k index t the query 2t.
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        uint32_t dsh[4], dsl[4], pvh[4], pvl[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int c = (i & 1) * 2 + (i >> 1);   // a_i = c_c
          split_tf32(s[n][c], dsh[i], dsl[i]);
          split_tf32(dp[n][c], pvh[i], pvl[i]);
        }
#pragma unroll
        for (int dd = 0; dd < KD; ++dd) {
          const int o = (16 * j + 8 * n + 2 * t) * LD + 8 * dd + g;
          if (j == 0 && n == 0)
#pragma unroll
            for (int i = 0; i < 4; ++i) tk[dd][i] = tv[dd][i] = 0.f;
          mma_tf32x3(tk[dd], dsh, dsl, __float_as_uint(qh[o]),
                     __float_as_uint(qh[o + LD]), __float_as_uint(ql[o]),
                     __float_as_uint(ql[o + LD]));
          mma_tf32x3(tv[dd], pvh, pvl, __float_as_uint(doh[o]),
                     __float_as_uint(doh[o + LD]), __float_as_uint(dol[o]),
                     __float_as_uint(dol[o + LD]));
        }
      }

      // dq of these 16 queries over the warp's 16 keys, ds k. k-step kk
      // takes keys 8 kk + 2t (k index t) and 8 kk + 2t + 1 (t + 4); the A
      // fragment's rows are queries g and g + 8, held in ds^T's C fragments
      // by lanes 8t + g / 2 and 8t + 4 + g / 2 (score tile 0 and 1, entry
      // 2 kk + g % 2).
      float tq[KD][4];
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        uint32_t ah[4], al[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int src = 8 * t + (i >> 1) * 4 + (g >> 1);
          const float* c = s[i & 1];
          const float e = __shfl_sync(0xffffffffu, c[2 * kk], src);
          const float o = __shfl_sync(0xffffffffu, c[2 * kk + 1], src);
          split_tf32(odd ? o : e, ah[i], al[i]);
        }
#pragma unroll
        for (int dn = 0; dn < KD; ++dn) {
          const int o = (8 * kk + 2 * t) * LD + 8 * dn + g;
          if (kk == 0)
#pragma unroll
            for (int i = 0; i < 4; ++i) tq[dn][i] = 0.f;
          mma_tf32x3(tq[dn], ah, al, __float_as_uint(kwh[o]),
                     __float_as_uint(kwh[o + LD]), __float_as_uint(kwl[o]),
                     __float_as_uint(kwl[o + LD]));
        }
      }
      float* part = dq_part + (warp * BQ + 16 * j + g) * LDQ + 2 * t;
#pragma unroll
      for (int dn = 0; dn < KD; ++dn) {
        *reinterpret_cast<float2*>(part + 8 * dn) = make_float2(tq[dn][0], tq[dn][1]);
        *reinterpret_cast<float2*>(part + 8 * LDQ + 8 * dn) =
            make_float2(tq[dn][2], tq[dn][3]);
      }
    }
#pragma unroll
    for (int n = 0; n < KD; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        dk[n][i] += tk[n][i];
        dv[n][i] += tv[n][i];
      }

    // The block's dq of the tile: the W warps' partials summed in a fixed
    // order, then added to dq_acc with one 16-byte reduction a chunk. The
    // next tile's barrier keeps its partials from overwriting these.
    __syncthreads();
    float* acc = a.dq_acc + (static_cast<long long>(bh) * Nq + q0) * D;
    for (int c = tid; c < BQ * (D / 4); c += THREADS) {
      const int r = c / (D / 4);
      const int d0 = (c % (D / 4)) * 4;
      if (RAGGED && q0 + r >= Nq) break;   // rows only grow with c
      float4 sum = *reinterpret_cast<const float4*>(dq_part + r * LDQ + d0);
#pragma unroll
      for (int w = 1; w < W; ++w) {
        const float4 x =
            *reinterpret_cast<const float4*>(dq_part + (w * BQ + r) * LDQ + d0);
        sum.x += x.x;
        sum.y += x.y;
        sum.z += x.z;
        sum.w += x.w;
      }
      atomicAdd(reinterpret_cast<float4*>(acc + r * D + d0), sum);
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float dbr = db[r];
    dbr += __shfl_xor_sync(0xffffffffu, dbr, 1);
    dbr += __shfl_xor_sync(0xffffffffu, dbr, 2);
    const int key = key0 + 8 * r + g;
    if (key < Nk) {
      const long long off = (static_cast<long long>(bh) * Nk + key) * D;
      float* dkrow = static_cast<float*>(a.dk) + off;
      float* dvrow = static_cast<float*>(a.dv) + off;
#pragma unroll
      for (int n = 0; n < KD; ++n) {
        *reinterpret_cast<float2*>(dkrow + 8 * n + 2 * t) =
            make_float2(dk[n][2 * r], dk[n][2 * r + 1]);
        *reinterpret_cast<float2*>(dvrow + 8 * n + 2 * t) =
            make_float2(dv[n][2 * r], dv[n][2 * r + 1]);
      }
      if (t == 0) a.dbias_bh[static_cast<long long>(bh) * Nk + key] = dbr;
    }
  }
}

// RAGGED: of the walked operand, Nq.
template <int D, int DROP, bool RAGGED>
int launch_fused_tf32(const LunarisK2BwdArgs& a, cudaStream_t stream) {
  if ((!RAGGED && a.Nq % bwd_tf32_tile(D) != 0) || !bwd_mma_aligned(a) ||
      reinterpret_cast<uintptr_t>(a.dk) % 8 != 0 ||
      reinterpret_cast<uintptr_t>(a.dv) % 8 != 0 || a.dq_acc == nullptr ||
      reinterpret_cast<uintptr_t>(a.dq_acc) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = flash_bwd_fused_tf32<D, DROP, RAGGED>;
  constexpr int smem = bwd_tf32_smem_bytes(D);
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.Nk + kBwdTf32Keys - 1) / kBwdTf32Keys, a.BH);
  kernel<<<grid, 32 * kBwdTf32Warps, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// ---- the fused warpgroup body: wgmma fed by TMA -----------------------------

// flash_bwd_wgmma  bf16 at D 48 and 64, the single-pass form of
//   `_bwd_fused_kernel`. flash_bwd_dkv_mma holds K and V of its keys as
//   register fragments beside the dk and dv accumulators, which fills the
//   registers at d 48 and 64 (238 and 255) before a fifth product fits.
//   Here K and V stay in shared memory as wgmma operands:
//   - A block owns 128 keys: two consumer warpgroups of 64 keys each, and a
//     producer warp. K and V of the block arrive once by TMA; the query walk
//     (tiles of 64, each block from its own first tile, as the mma.sync
//     fused body) comes through a ring of 3 stages: q and dO by TMA (columns
//     past d and rows past Nq as zeros), -lse log2 e (-inf past Nq, so that
//     p = 0 there) and delta by the lanes of the producer warpgroup's one
//     working warp, which also scale q into qs = round(q d^-1/2) in place
//     once the tile has landed. The producer warpgroup gives its registers
//     to the consumers (setmaxnreg: 40 against 232 a thread).
//   - Per tile, each warpgroup: s^T = k qs^T (bias as the accumulator's
//     start) and dp^T = v dO^T by wgmma m64n64k16 with both operands in
//     shared memory (K-major); p, the hash from each element's own (key,
//     query), ds and pv in registers at the TPU kernel's rounding points;
//     dv += pv^T dO and dk += ds^T qs by wgmma m64n{d}k16 with the packed
//     bf16 accumulators as A from registers and dO, qs read MN-major; dk and
//     dv accumulate in registers over the whole walk.
//   - dq = ds k over the block's 128 keys: each warpgroup writes its bf16
//     ds^T into a double-buffered [128 keys][64 queries] tile (the 128-byte
//     swizzle), the two meet at a named barrier, and warpgroup w forms
//     columns [w d/2, (w + 1) d/2) of the tile's dq by wgmma m64n{d/2}k16
//     (ds MN-major, K MN-major), then adds them to the zeroed f32 dq buffer
//     with 16-byte reductions (red.global.add.v4.f32): lanes t and t ^ 1
//     swap one pair of columns with a shuffle, so each lane holds four
//     neighbouring columns of one row.
//   - dbias: per-key f32 sums over the 4 lanes of a key, no atomics, the
//     same order every run.
//   Dropout is a template parameter; a ragged Nq or Nk costs nothing per
//   score (zeros and -inf, as above). dk, dv and dbias are the same on
//   every run; dq's last bits depend on the order of the reductions.

constexpr int kBwdWgKeys = 128;                  // keys a block
constexpr int kBwdWgBQ = 64;                     // queries a tile
constexpr int kBwdWgThreads = 3 * 128;           // two consumer warpgroups, a producer
constexpr int kBwdWgStages = 3;
constexpr int kBwdWgKvBytes = kBwdWgKeys * 128;  // K or V of the block
constexpr int kBwdWgQBytes = kBwdWgBQ * 128;     // a q or dO tile
constexpr int kBwdWgDsBytes = kBwdWgKeys * kBwdWgBQ * 2;  // a ds^T tile

// K, V, the ring ([stage][q, dO]), two ds^T tiles, [stage][BQ] -lse log2 e
// and delta, the barriers, and 1024 bytes to align the tiles.
__host__ __device__ constexpr int wg_bwd_smem_bytes() {
  return 1024 + 2 * kBwdWgKvBytes + kBwdWgStages * 2 * kBwdWgQBytes +
         2 * kBwdWgDsBytes + kBwdWgStages * 2 * kBwdWgBQ * 4 +
         (1 + 3 * kBwdWgStages) * 8;
}

struct K2BwdMaps {
  CUtensorMap q, k, v, dout;
};

// The consumer warpgroups of flash_bwd_wgmma.
template <int D, int DROP>
__device__ __forceinline__ void consume_bwd_wgmma(
    const LunarisK2BwdArgs& a, const uint8_t* ks, const uint8_t* vs,
    const uint8_t* ring, uint8_t* dsb, const float* ls, const float* dls,
    uint64_t* kv_bar, uint64_t* full, uint64_t* empty, int tiles, int first) {
  using bf16 = __nv_bfloat16;
  constexpr int ST = kBwdWgStages;
  constexpr int BQ = kBwdWgBQ;
  constexpr int KD = D / 16;       // k-steps of k qs^T and v dO^T
  constexpr int DH = D / 2;        // dq columns a warpgroup
  const int Nq = a.Nq, Nk = a.Nk;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bh = blockIdx.y;
  auto walk = [&](int i) {
    const int x = first + i;
    return x < tiles ? x : x - tiles;
  };
  const int wg = warp >> 2;        // the consumer warpgroup
  const int g = lane >> 2;         // the accumulator's row (and row + 8): a key
  const int t = lane & 3;          // its column pair: queries
  const int key_l = wg * 64 + (warp & 3) * 16 + g;   // within the block
  const int key0 = blockIdx.x * kBwdWgKeys + key_l;
  const bool drop = DROP == kDropOn;
  const uint8_t* kw = ks + wg * 64 * 128;          // this warpgroup's keys
  const uint8_t* vw = vs + wg * 64 * 128;

  float bk[2], db[2] = {0.f, 0.f};
  uint32_t k_term[2];
  {
    const float* biasb = a.bias + static_cast<long long>(bh % a.H) * Nk;
    const uint32_t row_seed = a.seed ^ (static_cast<uint32_t>(bh + a.row_offset) * kC1);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = key0 + 8 * r;
      bk[r] = key < Nk ? biasb[key] : 0.f;
      k_term[r] = row_seed + static_cast<uint32_t>(key) * kC2;
    }
  }
  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

  mbar_wait(kv_bar, 0);
  for (int i = 0; i < tiles; ++i) {
    const int st = i % ST;
    const int q0 = walk(i) * BQ;
    const uint8_t* qt = ring + st * 2 * kBwdWgQBytes;
    const uint8_t* dot = qt + kBwdWgQBytes;
    const float* lt = ls + st * BQ;
    const float* dlt = dls + st * BQ;
    uint8_t* dst = dsb + (i & 1) * kBwdWgDsBytes;
    mbar_wait(&full[st], (i / ST) & 1);

    // s^T = k qs^T + bias (the accumulator's start), dp^T = v dO^T: rows are
    // this warpgroup's keys, columns the tile's queries.
    float s[32], dp[32];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[4 * j] = s[4 * j + 1] = bk[0];
      s[4 * j + 2] = s[4 * j + 3] = bk[1];
    }
#pragma unroll
    for (int x = 0; x < 32; ++x) dp[x] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kd = 0; kd < KD; ++kd)
      wgmma_ss<64, 0, 0>(s, wgmma_desc(kw + 32 * kd), wgmma_desc(qt + 32 * kd), 1);
#pragma unroll
    for (int kd = 0; kd < KD; ++kd)
      wgmma_ss<64, 0, 0>(dp, wgmma_desc(vw + 32 * kd), wgmma_desc(dot + 32 * kd), 1);
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_pin(s);
    wgmma_pin(dp);

    // p, the mask, ds and pv; packed as the A fragments of the k-steps over
    // the queries (chunks 2 kk and 2 kk + 1 are k-step kk), and ds^T to
    // shared memory for dq.
    const uint32_t q_term = static_cast<uint32_t>(a.q_offset + q0 + 2 * t) * kC3;
    uint32_t dsf[4][4], pvf[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 nl = *reinterpret_cast<const float2*>(lt + 8 * j + 2 * t);
      const float2 dl = *reinterpret_cast<const float2*>(dlt + 8 * j + 2 * t);
      float ds[4], pv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = ex2(fmaf(s[4 * j + e], kLog2e, e & 1 ? nl.y : nl.x));
        float dpd = dp[4 * j + e];
        pv[e] = p;
        if (drop) {
          const bool keep = keep_hash(
              k_term[e >> 1] + q_term + static_cast<uint32_t>(8 * j + (e & 1)) * kC3,
              a.threshold);
          dpd = keep ? dpd * a.inv_keep : 0.f;
          pv[e] = keep ? p * a.inv_keep : 0.f;
        }
        ds[e] = p * (dpd - (e & 1 ? dl.y : dl.x));
        db[e >> 1] += ds[e];
      }
      const int h = 2 * (j & 1);
      dsf[j >> 1][h] = pack_bf16(ds[0], ds[1]);
      dsf[j >> 1][h + 1] = pack_bf16(ds[2], ds[3]);
      pvf[j >> 1][h] = pack_bf16(pv[0], pv[1]);
      pvf[j >> 1][h + 1] = pack_bf16(pv[2], pv[3]);
      // rows key_l and key_l + 8, 16-byte chunk j (queries 8 j..), swizzled
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<uint32_t*>(dst + (key_l + 8 * r) * 128 +
                                     ((j ^ g) << 4) + 4 * t) = dsf[j >> 1][h + r];
    }

    // dv += pv^T dO, dk += ds^T qs over the tile's 64 queries.
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<D, 1>(dv, pvf[kk], wgmma_desc(dot + 2048 * kk), 1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<D, 1>(dk, dsf[kk], wgmma_desc(qt + 2048 * kk), 1);
    wgmma_commit();

    // dq of the tile over the block's 128 keys, this warpgroup's columns.
    fence_async_shared();
    named_barrier(1, 256);
    float dq[DH / 2];
#pragma unroll
    for (int x = 0; x < DH / 2; ++x) dq[x] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBwdWgKeys / 16; ++kk)
      wgmma_ss<DH, 1, 1>(dq, wgmma_desc(dst + 2048 * kk),
                         wgmma_desc(ks + 2048 * kk + wg * DH * 2), 1);
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_pin(dk);
    wgmma_pin(dv);
    wgmma_pin(dq);
    mbar_arrive(&empty[st]);

    // Rows q0 + 16 (warp % 4) + g (+ 8): the lanes of a column quad swap a
    // pair so that lane t even adds columns 8 j + 2 t.. + 3 of row g and
    // lane t odd those of row g + 8 from 8 j + 2 (t - 1).
    const int qrow = q0 + (warp & 3) * 16 + g + (t & 1) * 8;
    float* accrow = a.dq_acc + (static_cast<long long>(bh) * Nq + qrow) * D + wg * DH;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      const float sx = t & 1 ? dq[4 * j] : dq[4 * j + 2];
      const float sy = t & 1 ? dq[4 * j + 1] : dq[4 * j + 3];
      const float rx = __shfl_xor_sync(0xffffffffu, sx, 1);
      const float ry = __shfl_xor_sync(0xffffffffu, sy, 1);
      const float4 val = t & 1 ? make_float4(rx, ry, dq[4 * j + 2], dq[4 * j + 3])
                               : make_float4(dq[4 * j], dq[4 * j + 1], rx, ry);
      if (qrow < Nq)
        atomicAdd(reinterpret_cast<float4*>(accrow + 8 * j + 2 * (t & 2)), val);
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float dbr = db[r];
    dbr += __shfl_xor_sync(0xffffffffu, dbr, 1);
    dbr += __shfl_xor_sync(0xffffffffu, dbr, 2);
    const int key = key0 + 8 * r;
    if (key < Nk) {
      const long long off = (static_cast<long long>(bh) * Nk + key) * D;
      bf16* dkrow = static_cast<bf16*>(a.dk) + off;
      bf16* dvrow = static_cast<bf16*>(a.dv) + off;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<uint32_t*>(dkrow + 8 * j + 2 * t) =
            pack_bf16(dk[4 * j + 2 * r], dk[4 * j + 2 * r + 1]);
        *reinterpret_cast<uint32_t*>(dvrow + 8 * j + 2 * t) =
            pack_bf16(dv[4 * j + 2 * r], dv[4 * j + 2 * r + 1]);
      }
      if (t == 0) a.dbias_bh[static_cast<long long>(bh) * Nk + key] = dbr;
    }
  }
}

template <int D, int DROP>
__global__ void __launch_bounds__(kBwdWgThreads, 1)
flash_bwd_wgmma(const LunarisK2BwdArgs a, const __grid_constant__ K2BwdMaps maps) {
  static_assert(D == 48 || D == 64, "the warpgroup body takes d 48 and 64");
  constexpr int ST = kBwdWgStages;
  constexpr int BQ = kBwdWgBQ;
  extern __shared__ uint8_t bwd_wg_smem[];
  uint8_t* ks = bwd_wg_smem + ((1024 - (smem_addr(bwd_wg_smem) & 1023)) & 1023);
  uint8_t* vs = ks + kBwdWgKvBytes;
  uint8_t* ring = vs + kBwdWgKvBytes;
  uint8_t* dsb = ring + ST * 2 * kBwdWgQBytes;
  float* ls = reinterpret_cast<float*>(dsb + 2 * kBwdWgDsBytes);
  float* dls = ls + ST * BQ;
  uint64_t* kv_bar = reinterpret_cast<uint64_t*>(dls + ST * BQ);
  uint64_t* tma_bar = kv_bar + 1;
  uint64_t* full = tma_bar + ST;
  uint64_t* empty = full + ST;

  const int Nq = a.Nq;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.y;
  const int tiles = (Nq + BQ - 1) / BQ;
  const int first = blockIdx.x % tiles;
  auto walk = [&](int i) {
    const int x = first + i;
    return x < tiles ? x : x - tiles;
  };

  if (tid == 0) {
    mbar_init(kv_bar, 1);
    for (int i = 0; i < ST; ++i) {
      mbar_init(&tma_bar[i], 1);
      mbar_init(&full[i], 32);
      mbar_init(&empty[i], 256);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 8) {  // the producer warpgroup: one warp loads
    setmaxnreg_dec<40>();
    if (warp != 8) return;
    if (lane == 0) {
      mbar_arrive_tx(kv_bar, 2 * kBwdWgKvBytes);
      tma_load_3d(ks, &maps.k, kv_bar, 0, blockIdx.x * kBwdWgKeys, bh);
      tma_load_3d(vs, &maps.v, kv_bar, 0, blockIdx.x * kBwdWgKeys, bh);
    }
    const float* lseb = a.lse + static_cast<long long>(bh) * Nq;
    const float* deltab = a.delta + static_cast<long long>(bh) * Nq;
    for (int i = 0; i < tiles; ++i) {
      const int st = i % ST;
      const int q0 = walk(i) * BQ;
      uint8_t* qt = ring + st * 2 * kBwdWgQBytes;
      if (i >= ST) mbar_wait(&empty[st], ((i / ST) & 1) ^ 1);
      if (lane == 0) {
        mbar_arrive_tx(&tma_bar[st], 2 * kBwdWgQBytes);
        tma_load_3d(qt, &maps.q, &tma_bar[st], 0, q0, bh);
        tma_load_3d(qt + kBwdWgQBytes, &maps.dout, &tma_bar[st], 0, q0, bh);
      }
      for (int c = lane; c < BQ; c += 32) {
        const bool in = q0 + c < Nq;
        ls[st * BQ + c] = in ? -lseb[q0 + c] * kLog2e : -INFINITY;
        dls[st * BQ + c] = in ? deltab[q0 + c] : 0.f;
      }
      // q becomes qs in place, a 16-byte chunk at a time (the swizzle moves
      // chunks, not the values within them).
      mbar_wait(&tma_bar[st], (i / ST) & 1);
      uint4* chunk = reinterpret_cast<uint4*>(qt);
      for (int c = lane; c < kBwdWgQBytes / 16; c += 32) {
        uint4 x = chunk[c];
        x.x = scale_bf16x2(x.x, a.scale);
        x.y = scale_bf16x2(x.y, a.scale);
        x.z = scale_bf16x2(x.z, a.scale);
        x.w = scale_bf16x2(x.w, a.scale);
        chunk[c] = x;
      }
      fence_async_shared();
      mbar_arrive(&full[st]);
    }
  } else {
    setmaxnreg_inc<232>();
    consume_bwd_wgmma<D, DROP>(a, ks, vs, ring, dsb, ls, dls, kv_bar, full,
                               empty, tiles, first);
  }
}

template <int D, int DROP>
int launch_bwd_wgmma(const LunarisK2BwdArgs& a, cudaStream_t stream) {
  if (!bwd_mma_aligned(a) || reinterpret_cast<uintptr_t>(a.dk) % 4 != 0 ||
      reinterpret_cast<uintptr_t>(a.dv) % 4 != 0 || a.dq_acc == nullptr ||
      reinterpret_cast<uintptr_t>(a.dq_acc) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  K2BwdMaps maps;
  if (!bf16_tile_map(&maps.q, a.q, a.BH, a.Nq, D, kBwdWgBQ) ||
      !bf16_tile_map(&maps.dout, a.dout, a.BH, a.Nq, D, kBwdWgBQ) ||
      !bf16_tile_map(&maps.k, a.k, a.BH, a.Nk, D, kBwdWgKeys) ||
      !bf16_tile_map(&maps.v, a.v, a.BH, a.Nk, D, kBwdWgKeys))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = flash_bwd_wgmma<D, DROP>;
  constexpr int smem = wg_bwd_smem_bytes();
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.Nk + kBwdWgKeys - 1) / kBwdWgKeys, a.BH);
  kernel<<<grid, kBwdWgThreads, smem, stream>>>(a, maps);
  return static_cast<int>(cudaGetLastError());
}

// ---- the narrow fused warpgroup body: d 16 and 32 ---------------------------

// flash_bwd_wgmma_narrow  bf16 at D 16 and 32, the single-pass form of
//   `_bwd_fused_kernel` at the default width and at the low-end recipe's
//   (feature_dim 256). Five products a (query, key) pair are cheap at d 16
//   (bound 5.6 ms at B16 H8 N16384; 11.1 at d 32); the work per
//   score binds: the ex2 (8.2 ms there on the special-function units), its
//   FMA, ds = p (dpd - delta), the row sum of ds, two packs and, with
//   dropout, the hash, several times the special-function floor in issue
//   slots alone. flash_bwd_dkv_mma<.., FUSED> runs it in series with its
//   mma.sync products, warp by warp; flash_bwd_wgmma's two warpgroups meet
//   at a named barrier every tile. Here:
//   - A block owns 192 keys: three consumer warpgroups of 64 keys each
//     (instantiated on their index, so that every shared-memory descriptor
//     is uniform), and a producer warp. K, V (narrow [rows][16] tiles,
//     hopper.cuh), the keys' bias split into three bf16 parts (a [keys][16]
//     tile) and a [1 1 1 0 ..] tile arrive once; the query walk (tiles of
//     64, each block from its own first tile) comes through a ring of 4: q
//     and dO by TMA (zeros past Nq; three loads in flight), -lse log2 e
//     (-inf past Nq) and delta by the producer's lanes, which also scale q
//     in place.
//   - Per tile, a warpgroup issues s^T = bias + k qs^T (the bias k-step from
//     zero, as the forward's) and dp^T = v dO^T (wgmma m64n64k16, both
//     operands in shared memory), works out p, the mask, ds and pv in
//     registers at the TPU kernel's rounding points, and adds dv += pv^T dO
//     and dk += ds^T qs (wgmma m64n16k16, A from registers); dk and dv
//     accumulate in registers over the whole walk. Every wgmma a tile issues
//     is done before the next, and the three warpgroups run free of each
//     other: one's per-score work runs while another's products do.
//   - ds^T goes to shared memory with stmatrix into a [192 keys][64 queries]
//     tile (128-byte swizzle), three of them in turn. dq = ds k over the
//     block's 192 keys (wgmma m64n16k16, both MN-major) is formed one tile
//     later by the warpgroup whose turn it is (tile i: warpgroup i % 3), and
//     added to the zeroed f32 dq buffer with 16-byte reductions. The
//     warpgroups meet only through the ds tiles' mbarriers (`ds_full`: all
//     three wrote theirs; `ds_empty`: the owner read it).
//   - dbias: per-key f32 sums over the 4 lanes of a key, no atomics.
//   Dropout is a template parameter; a ragged Nq or Nk costs nothing per
//   score. dk, dv and dbias are the same on every run; dq's last bits
//   depend on the order of the reductions. With dropout the keep factor is
//   one select, (keep ? 1 / (1 - rate) : 0), that multiplies dp and p.
//   At D 32 K, V, q and dO are [rows][32] tiles with the 64-byte swizzle
//   (the bias and ones tiles stay [rows][16], read through descriptors of
//   their own); s^T takes q's two k-steps after the bias k-step, dp^T two,
//   dv and dk are m64n32k16 a k-step and dq has n 32: dk, dv and dq take
//   16 registers a thread each.
// Measured on an H100 (PERF.md section 6): 22.7 instructions a 32 scores
// with dropout (flash_bwd_dkv_mma<16, .., FUSED>: 31.9), issue-bound; the
// per-tile work (descriptors, waits, stores) is about 8 of them. At d 32:
// 24.4 (flash_bwd_dkv_mma<32, .., FUSED>, which tests dropout at run time,
// 52.8), 25 % of the tensor cores' bound at B16 H8 N16384.

constexpr int kBwdNwConsumers = 3;               // warpgroups of 64 keys
constexpr int kBwdNwKeys = 64 * kBwdNwConsumers; // keys a block
constexpr int kBwdNwBQ = 64;                     // queries a tile
constexpr int kBwdNwThreads = 128 * (kBwdNwConsumers + 1);
constexpr int kBwdNwStages = 4;
constexpr int kBwdNwDsTiles = kBwdNwConsumers;   // tile i's is i % 3, its owner's
constexpr int kBwdNwBiasBytes = kBwdNwKeys * 32; // the bias tile, [keys][16]
constexpr int kBwdNwOnesBytes = kBwdNwBQ * 32;   // the ones tile, [BQ][16]
constexpr int kBwdNwDsBytes = kBwdNwKeys * kBwdNwBQ * 2;  // a ds^T tile
// K or V ([keys][D]); a q or dO tile ([BQ][D]).
__host__ __device__ constexpr int nw_bwd_kv_bytes(int d) { return kBwdNwKeys * 2 * d; }
__host__ __device__ constexpr int nw_bwd_q_bytes(int d) { return kBwdNwBQ * 2 * d; }

// K, V, the bias tile, the ones tile, the ring ([stage][q, dO]), the ds^T
// tiles, [stage][BQ] -lse log2 e and delta, the barriers, and 1024 bytes to
// align the tiles.
__host__ __device__ constexpr int nw_bwd_smem_bytes(int d) {
  return 1024 + 2 * nw_bwd_kv_bytes(d) + kBwdNwBiasBytes + kBwdNwOnesBytes +
         kBwdNwStages * 2 * nw_bwd_q_bytes(d) + kBwdNwDsTiles * kBwdNwDsBytes +
         kBwdNwStages * 2 * kBwdNwBQ * 4 +
         (1 + 3 * kBwdNwStages + 2 * kBwdNwDsTiles) * 8;
}

// Consumer warpgroup WG of flash_bwd_wgmma_narrow: keys 64 WG .. of the
// block.
template <int D, int DROP, int WG>
__device__ __forceinline__ void consume_bwd_narrow(
    const LunarisK2BwdArgs& a, const uint8_t* ks, const uint8_t* vs,
    const uint8_t* bs, const uint8_t* ones, const uint8_t* ring, uint8_t* dsb,
    const float* ls, const float* dls, uint64_t* kv_bar, uint64_t* full,
    uint64_t* empty, uint64_t* ds_full, uint64_t* ds_empty, int tiles,
    int first) {
  using bf16 = __nv_bfloat16;
  constexpr int ST = kBwdNwStages;
  constexpr int NB = kBwdNwDsTiles;
  constexpr int BQ = kBwdNwBQ;
  constexpr int KS = D / 16;       // k-steps of s^T's and dp^T's products
  constexpr uint32_t HI = kNarrowDescHi<D>;          // K, V, q, dO
  constexpr uint32_t HI16 = kNarrowDescHi<16>;       // the bias and ones tiles
  constexpr uint32_t ROW16 = 16 * 2 * D >> 4;        // 16 rows of D, in 16 bytes
  constexpr uint32_t ROW16_16 = 16 * 32 >> 4;        // 16 rows of 16
  constexpr int QBYTES = nw_bwd_q_bytes(D);
  const int Nq = a.Nq, Nk = a.Nk;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bh = blockIdx.y;
  auto walk = [&](int i) {
    const int x = first + i;
    return x < tiles ? x : x - tiles;
  };
  const int g = lane >> 2;         // the accumulator's row (and row + 8): a key
  const int t = lane & 3;          // its column pair: queries
  const int key_l = WG * 64 + (warp & 3) * 16 + g;   // within the block
  const int key0 = blockIdx.x * kBwdNwKeys + key_l;
  const bool drop = DROP == kDropOn;
  // Descriptors' low halves: this warpgroup's keys of K, V and the bias,
  // the ones tile, the block's K for dq, the ring and the ds^T tiles.
  const uint32_t k_lo = desc_lo(ks) + WG * 4 * ROW16;
  const uint32_t v_lo = desc_lo(vs) + WG * 4 * ROW16;
  const uint32_t b_lo = desc_lo(bs) + WG * 4 * ROW16_16;
  const uint32_t ones_lo = desc_lo(ones), kq_lo = desc_lo(ks);
  const uint32_t ring_lo = desc_lo(ring), ds_lo = desc_lo(dsb);

  float db[2] = {0.f, 0.f};
  uint32_t k_term[2];
  {
    const uint32_t row_seed = a.seed ^ (static_cast<uint32_t>(bh + a.row_offset) * kC1);
#pragma unroll
    for (int r = 0; r < 2; ++r)
      k_term[r] = row_seed + static_cast<uint32_t>(key0 + 8 * r) * kC2;
  }
  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
  // ds and pv as the A fragments of dk and dv over the tile's queries
  // (8-query chunks 2 kk and 2 kk + 1 are k-step kk).
  uint32_t dsf[4][4], pvf[4][4];
  float dq[D / 2];

  // dq of walk tile i over the block's keys, added to dq_acc: rows q0 +
  // 16 (warp % 4) + g (+ 8). The lanes of a column quad swap a pair so
  // that lane t even adds columns 8 c + 2 t .. + 3 of row g and lane t odd
  // those of row g + 8 from 8 c + 2 (t - 1).
  auto dq_tile = [&](int i) {
    const int b = i % NB;
    mbar_wait(&ds_full[b], (i / NB) & 1);
    const uint32_t dst = ds_lo + b * (kBwdNwDsBytes >> 4);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBwdNwKeys / 16; ++kk)
      wgmma_ss<D, 1, 1>(dq, desc_of(dst + kk * (2048 >> 4), kSw128DescHi),
                        desc_of(kq_lo + kk * ROW16, HI), kk > 0);
    wgmma_commit();
  };
  auto dq_add = [&](int i) {
    const int qrow = walk(i) * BQ + (warp & 3) * 16 + g + (t & 1) * 8;
    float* accrow = a.dq_acc + (static_cast<long long>(bh) * Nq + qrow) * D;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      const float sx = t & 1 ? dq[4 * c] : dq[4 * c + 2];
      const float sy = t & 1 ? dq[4 * c + 1] : dq[4 * c + 3];
      const float rx = __shfl_xor_sync(0xffffffffu, sx, 1);
      const float ry = __shfl_xor_sync(0xffffffffu, sy, 1);
      const float4 val = t & 1 ? make_float4(rx, ry, dq[4 * c + 2], dq[4 * c + 3])
                               : make_float4(dq[4 * c], dq[4 * c + 1], rx, ry);
      if (qrow < Nq)
        atomicAdd(reinterpret_cast<float4*>(accrow + 8 * c + 2 * (t & 2)), val);
    }
  };

  mbar_wait(kv_bar, 0);
  for (int i = 0; i < tiles; ++i) {
    const int st = i % ST;
    const int q0 = walk(i) * BQ;
    const uint32_t qt = ring_lo + st * (2 * QBYTES >> 4);
    const uint32_t dot = qt + (QBYTES >> 4);
    const float* lt = ls + st * BQ;
    const float* dlt = dls + st * BQ;
    const int b = i % NB;
    mbar_wait(&full[st], (i / ST) & 1);

    // s^T = bias + k qs^T and dp^T = v dO^T: rows are this warpgroup's
    // keys, columns the tile's queries (k-step kk 32 kk bytes on within the
    // rows).
    float s[32], dp[32];
    wgmma_fence();
    wgmma_ss<64, 0, 0>(s, desc_of(b_lo, HI16), desc_of(ones_lo, HI16), 0);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      wgmma_ss<64, 0, 0>(s, desc_of(k_lo + 2 * kk, HI), desc_of(qt + 2 * kk, HI), 1);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      wgmma_ss<64, 0, 0>(dp, desc_of(v_lo + 2 * kk, HI), desc_of(dot + 2 * kk, HI),
                         kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_pin(s);
    wgmma_pin(dp);

    // The hash of (key r, query q0 + 8 j + 2 t + c) is base[r] + (8 j + c)
    // C3: the query's term stepped by a constant.
    const uint32_t q_term = static_cast<uint32_t>(a.q_offset + q0 + 2 * t) * kC3;
    const uint32_t base[2] = {k_term[0] + q_term, k_term[1] + q_term};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 nl = *reinterpret_cast<const float2*>(lt + 8 * j + 2 * t);
      const float2 dl = *reinterpret_cast<const float2*>(dlt + 8 * j + 2 * t);
      float ds[4], pv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = ex2(fmaf(s[4 * j + e], kLog2e, e & 1 ? nl.y : nl.x));
        float dpd = dp[4 * j + e];
        pv[e] = p;
        if (drop) {
          const bool keep = keep_hash(
              base[e >> 1] + static_cast<uint32_t>(8 * j + (e & 1)) * kC3,
              a.threshold);
          const float kinv = keep ? a.inv_keep : 0.f;
          dpd *= kinv;
          pv[e] = p * kinv;
        }
        ds[e] = p * (dpd - (e & 1 ? dl.y : dl.x));
        db[e >> 1] += ds[e];
      }
      const int h = 2 * (j & 1);
      dsf[j >> 1][h] = pack_bf16(ds[0], ds[1]);
      dsf[j >> 1][h + 1] = pack_bf16(ds[2], ds[3]);
      pvf[j >> 1][h] = pack_bf16(pv[0], pv[1]);
      pvf[j >> 1][h + 1] = pack_bf16(pv[2], pv[3]);
    }

    // ds^T to tile b for dq: k-step kk's four 8x8 blocks are (keys 0-7,
    // queries 16 kk..), (keys 8-15, the same), (keys 0-7, 16 kk + 8..),
    // (keys 8-15, the same); rows of 128 bytes, 128-byte swizzle.
    if (i >= NB) mbar_wait(&ds_empty[b], (i / NB - 1) & 1);
    {
      uint8_t* dst = dsb + b * kBwdNwDsBytes;
      const int row = WG * 64 + (warp & 3) * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int chunk = 2 * kk + (lane >> 4);
        stmatrix_x4(dst + row * 128 + ((chunk ^ (lane & 7)) << 4),
                    dsf[kk][0], dsf[kk][1], dsf[kk][2], dsf[kk][3]);
      }
    }
    fence_async_shared();
    mbar_arrive(&ds_full[b]);

    // dv += pv^T dO, dk += ds^T qs over the tile's 64 queries.
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<D, 1>(dv, pvf[kk], desc_of(dot + kk * ROW16, HI), 1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<D, 1>(dk, dsf[kk], desc_of(qt + kk * ROW16, HI), 1);
    wgmma_commit();
    const bool owner = i > 0 && (i - 1) % NB == WG;
    if (owner) dq_tile(i - 1);
    wgmma_wait<0>();
    wgmma_pin(dk);
    wgmma_pin(dv);
    wgmma_pin(dsf);
    wgmma_pin(pvf);
    mbar_arrive(&empty[st]);
    if (owner) {
      wgmma_pin(dq);
      mbar_arrive(&ds_empty[(i - 1) % NB]);
      dq_add(i - 1);
    }
  }
  if ((tiles - 1) % NB == WG) {
    dq_tile(tiles - 1);
    wgmma_wait<0>();
    wgmma_pin(dq);
    dq_add(tiles - 1);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float dbr = db[r];
    dbr += __shfl_xor_sync(0xffffffffu, dbr, 1);
    dbr += __shfl_xor_sync(0xffffffffu, dbr, 2);
    const int key = key0 + 8 * r;
    if (key < Nk) {
      const long long off = (static_cast<long long>(bh) * Nk + key) * D;
      bf16* dkrow = static_cast<bf16*>(a.dk) + off;
      bf16* dvrow = static_cast<bf16*>(a.dv) + off;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<uint32_t*>(dkrow + 8 * j + 2 * t) =
            pack_bf16(dk[4 * j + 2 * r], dk[4 * j + 2 * r + 1]);
        *reinterpret_cast<uint32_t*>(dvrow + 8 * j + 2 * t) =
            pack_bf16(dv[4 * j + 2 * r], dv[4 * j + 2 * r + 1]);
      }
      if (t == 0) a.dbias_bh[static_cast<long long>(bh) * Nk + key] = dbr;
    }
  }
}

template <int D, int DROP>
__global__ void __launch_bounds__(kBwdNwThreads, 1)
flash_bwd_wgmma_narrow(const LunarisK2BwdArgs a,
                       const __grid_constant__ K2BwdMaps maps) {
  static_assert(D == 16 || D == 32, "the narrow warpgroup body takes d 16 and 32");
  constexpr int ST = kBwdNwStages;
  constexpr int NB = kBwdNwDsTiles;
  constexpr int BQ = kBwdNwBQ;
  constexpr int KV = nw_bwd_kv_bytes(D);
  constexpr int QBYTES = nw_bwd_q_bytes(D);
  extern __shared__ uint8_t bwd_nw_smem[];
  uint8_t* ks = bwd_nw_smem + ((1024 - (smem_addr(bwd_nw_smem) & 1023)) & 1023);
  uint8_t* vs = ks + KV;
  uint8_t* bs = vs + KV;
  uint8_t* ones = bs + kBwdNwBiasBytes;
  uint8_t* ring = ones + kBwdNwOnesBytes;
  uint8_t* dsb = ring + ST * 2 * QBYTES;
  float* ls = reinterpret_cast<float*>(dsb + NB * kBwdNwDsBytes);
  float* dls = ls + ST * BQ;
  uint64_t* kv_bar = reinterpret_cast<uint64_t*>(dls + ST * BQ);
  uint64_t* tma_bar = kv_bar + 1;
  uint64_t* full = tma_bar + ST;
  uint64_t* empty = full + ST;
  uint64_t* ds_full = empty + ST;
  uint64_t* ds_empty = ds_full + NB;

  const int Nq = a.Nq, Nk = a.Nk;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.y;
  const int tiles = (Nq + BQ - 1) / BQ;
  const int first = blockIdx.x % tiles;
  auto walk = [&](int i) {
    const int x = first + i;
    return x < tiles ? x : x - tiles;
  };

  if (tid == 0) {
    mbar_init(kv_bar, 32);
    for (int i = 0; i < ST; ++i) {
      mbar_init(&tma_bar[i], 1);
      mbar_init(&full[i], 32);
      mbar_init(&empty[i], 128 * kBwdNwConsumers);
    }
    for (int i = 0; i < NB; ++i) {
      mbar_init(&ds_full[i], 128 * kBwdNwConsumers);
      mbar_init(&ds_empty[i], 128);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 4 * kBwdNwConsumers) {
    // The producer warpgroup: one warp loads, the registers go to the
    // consumers (3 x 128 x 160 + 128 x 32 = the block's 512 x 128).
    setmaxnreg_dec<32>();
    if (warp != 4 * kBwdNwConsumers) return;
    const int key0 = blockIdx.x * kBwdNwKeys;
    if (lane == 0) {
      mbar_expect_tx(kv_bar, 2 * KV);
      tma_load_3d(ks, &maps.k, kv_bar, 0, key0, bh);
      tma_load_3d(vs, &maps.v, kv_bar, 0, key0, bh);
    }
    {
      const float* biasb = a.bias + static_cast<long long>(bh % a.H) * Nk;
      for (int r = lane; r < kBwdNwKeys; r += 32)
        write_bias_row(bs, r, key0 + r < Nk ? biasb[key0 + r] : 0.f);
      for (int r = lane; r < BQ; r += 32) write_ones_row(ones, r);
      fence_async_shared();
      mbar_arrive(kv_bar);
    }
    const float* lseb = a.lse + static_cast<long long>(bh) * Nq;
    const float* deltab = a.delta + static_cast<long long>(bh) * Nq;
    // q and dO of walk tile i by TMA into its stage, once the stage is free.
    auto load = [&](int i) {
      const int st = i % ST;
      if (i >= ST) mbar_wait(&empty[st], ((i / ST) & 1) ^ 1);
      if (lane == 0) {
        uint8_t* qt = ring + st * 2 * QBYTES;
        const int q0 = walk(i) * BQ;
        mbar_arrive_tx(&tma_bar[st], 2 * QBYTES);
        tma_load_3d(qt, &maps.q, &tma_bar[st], 0, q0, bh);
        tma_load_3d(qt + QBYTES, &maps.dout, &tma_bar[st], 0, q0, bh);
      }
    };
    // The ring's first tiles go out at once; then each tile is published
    // (its lse and delta written, q scaled in place once it has landed),
    // and the stage of the tile before it, once free, takes the next load:
    // ST - 1 loads stay in flight while the consumers work.
    for (int i = 0; i < ST && i < tiles; ++i) load(i);
    for (int i = 0; i < tiles; ++i) {
      const int st = i % ST;
      const int q0 = walk(i) * BQ;
      uint8_t* qt = ring + st * 2 * QBYTES;
      for (int c = lane; c < BQ; c += 32) {
        const bool in = q0 + c < Nq;
        ls[st * BQ + c] = in ? -lseb[q0 + c] * kLog2e : -INFINITY;
        dls[st * BQ + c] = in ? deltab[q0 + c] : 0.f;
      }
      // q becomes qs in place, a 16-byte chunk at a time (the swizzle moves
      // chunks, not the values within them).
      mbar_wait(&tma_bar[st], (i / ST) & 1);
      uint4* chunk = reinterpret_cast<uint4*>(qt);
      for (int c = lane; c < QBYTES / 16; c += 32) {
        uint4 x = chunk[c];
        x.x = scale_bf16x2(x.x, a.scale);
        x.y = scale_bf16x2(x.y, a.scale);
        x.z = scale_bf16x2(x.z, a.scale);
        x.w = scale_bf16x2(x.w, a.scale);
        chunk[c] = x;
      }
      fence_async_shared();
      mbar_arrive(&full[st]);
      if (i >= 1 && i - 1 + ST < tiles) load(i - 1 + ST);
    }
  } else {
    setmaxnreg_inc<160>();
#define LUNARIS_BWD_NW_CONSUMER(W)                                            \
  consume_bwd_narrow<D, DROP, W>(a, ks, vs, bs, ones, ring, dsb, ls, dls,      \
                                 kv_bar, full, empty, ds_full, ds_empty,       \
                                 tiles, first)
    switch (warp >> 2) {
      case 0: LUNARIS_BWD_NW_CONSUMER(0); break;
      case 1: LUNARIS_BWD_NW_CONSUMER(1); break;
      default: LUNARIS_BWD_NW_CONSUMER(2); break;
    }
#undef LUNARIS_BWD_NW_CONSUMER
  }
}

// ---- the f32 fused warpgroup body: d 16, three TF32 passes on wgmma ----------
// (d 32, 48 and 64: below, "the f32 fused warpgroup body at d 32, 48 and
// 64")

// flash_bwd_wgmma_tf32  f32 at D 16, the single-pass form of
//   `_bwd_fused_kernel` at the default type and width, where Nq and Nk are
//   long. Its five products in three TF32 passes bound it (33 ms at B16 H8
//   N16384, the ex2 8.2 ms); flash_bwd_fused_tf32 issues them on mma.sync,
//   16 x 8 x 8 a warp at a time. tf32 wgmma reads both shared-memory
//   operands K-major, and an f32 word as TF32 by dropping its low bits, so
//   a pre-pass (flash_attention_tf32_split.cu) writes every operand once a
//   call as hi and lo, laid out as the products read them: each query tile
//   of 64 as qs and dO ([64][8] tiles, 32-byte swizzle: the B of s^T =
//   k qs^T and dp^T = v dO^T) and as qs^T and dO^T ([32][32] atoms, 128-byte
//   swizzle, rows 0-15 hi, 16-31 lo, queries permuted by `perm8`: the B of
//   dk += ds^T qs and dv += pv^T dO), with -lse log2 e and delta; the keys
//   as K^T (the B of dq += ds k). Here:
//   - A block owns 128 keys: two consumer warpgroups of 64 keys and a
//     producer warp. K^T of the block arrives once, the query walk (tiles of
//     64, each block from its own first tile) through a ring of 3, one bulk
//     copy (TMA) a tile. k and v of a warpgroup's keys are A fragments in
//     registers, split once, with the keys' bias.
//   - A query tile goes in two halves of 32 queries (the registers of p,
//     ds and pv in hi and lo): s^T = bias + k qs^T and dp^T = v dO^T, wgmma
//     m64n32k8 in three passes a k-step; p, the hash on the score's own
//     (key, query), ds and pv in f32 at the TPU kernel's rounding points;
//     ds and pv split into hi and lo in registers, where the score's C
//     fragment is the A fragment of dk and dv as it lies (the queries of
//     qs^T and dO^T are permuted to match), and dk, dv summed from zero a
//     tile by wgmma m64n16k8 in three passes, then added with one f32 add.
//   - ds goes to shared memory as well, hi and lo, [64 queries][64 keys]
//     with the 128-byte swizzle: dq = ds k over the warpgroup's keys is
//     wgmma m64n32k8 (ds hi times [K hi; K lo]) and m64n16k8 (ds lo times
//     K hi), both operands in shared memory, added to the zeroed f32 dq
//     buffer with 16-byte reductions. The two warpgroups meet only at the
//     ring.
//   - dbias: per-key f32 sums over the 4 lanes of a key, no atomics.
//   Dropout is a template parameter; a ragged Nq or Nk costs nothing per
//   score (zeros, -inf and K^T's zeros). dk, dv and dbias are the same on
//   every run; dq's last bits depend on the order of the reductions.
// It computes what flash_bwd_fused_tf32 computes, at the same rounding
// points, every product in three TF32 passes with cvt.rna splits.


constexpr int kBwdT32Consumers = 2;                   // warpgroups of 64 keys
constexpr int kBwdT32Keys = 64 * kBwdT32Consumers;    // keys a block
constexpr int kBwdT32BQ = kTf32Rows;                  // queries a tile
constexpr int kBwdT32Threads = 128 * (kBwdT32Consumers + 1);
constexpr int kBwdT32Stages = 3;
constexpr int kBwdT32StageBytes = 33 * 1024;          // a query tile, 1024-aligned
constexpr int kBwdT32DsBytes = kBwdT32BQ * 64 * 4;    // ds hi or lo of a warpgroup

// The ring of query tiles, each warpgroup's ds hi and lo ([64 queries][64
// keys]), the block's K^T tiles, the barriers, and 1024 bytes to align the
// tiles.
__host__ __device__ constexpr int t32_bwd_smem_bytes16() {
  return 1024 + kBwdT32Stages * kBwdT32StageBytes +
         kBwdT32Consumers * 2 * kBwdT32DsBytes +
         kBwdT32Consumers * tf32_bwd_k_tile_bytes(16) + (1 + 2 * kBwdT32Stages) * 8;
}

// The consumer warpgroups of flash_bwd_wgmma_tf32: warpgroup `wg` owns keys
// 64 wg .. of the block. Every wgmma is done before its registers are
// touched again.
template <int DROP>
__device__ __forceinline__ void consume_bwd_tf32(
    const LunarisK2BwdArgs& a, const uint8_t* ring, uint8_t* dsb,
    const uint8_t* kts, uint64_t* kv_bar, uint64_t* full, uint64_t* empty,
    int tiles, int first) {
  constexpr int D = 16;
  constexpr int ST = kBwdT32Stages;
  constexpr int BQ = kBwdT32BQ;
  constexpr uint32_t HI32 = kNarrowDescHi<16>;   // [rows][8] f32, 32-byte swizzle
  const int Nq = a.Nq, Nk = a.Nk;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wg = warp >> 2;
  const int bh = blockIdx.y;
  const int g = lane >> 2;         // the accumulator's row (and row + 8): a key
  const int t = lane & 3;          // its column pair: queries
  const int key_l = (warp & 3) * 16 + g;           // within the warpgroup
  const int key0 = blockIdx.x * kBwdT32Keys + wg * 64 + key_l;
  const bool drop = DROP == kDropOn;
  auto walk = [&](int i) {
    const int x = first + i;
    return x < tiles ? x : x - tiles;
  };
  uint8_t* dsh = dsb + wg * 2 * kBwdT32DsBytes;    // ds hi, then lo
  uint8_t* dsl = dsh + kBwdT32DsBytes;
  const uint32_t ds_lo = desc_lo(dsh);
  const uint32_t kt_lo = desc_lo(kts + wg * tf32_bwd_k_tile_bytes(16));
  const uint32_t ring_lo = desc_lo(ring);

  // k and v of the warp's keys as the A fragments of s^T and dp^T (keys g,
  // g + 8; d 8 kd + t, + 4), split once; the keys' bias and hash term.
  uint32_t kh[2][4], kl[2][4], vh[2][4], vl[2][4];
  float bk[2], db[2] = {0.f, 0.f};
  uint32_t k_term[2];
  {
    const float* kb = static_cast<const float*>(a.k) + static_cast<long long>(bh) * Nk * D;
    const float* vb = static_cast<const float*>(a.v) + static_cast<long long>(bh) * Nk * D;
    const float* biasb = a.bias + static_cast<long long>(bh % a.H) * Nk;
    const uint32_t row_seed = a.seed ^ (static_cast<uint32_t>(bh + a.row_offset) * kC1);
#pragma unroll
    for (int kd = 0; kd < 2; ++kd)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = key0 + (i & 1) * 8;
        const long long off = static_cast<long long>(key) * D + 8 * kd + t + (i >> 1) * 4;
        split_tf32(key < Nk ? kb[off] : 0.f, kh[kd][i], kl[kd][i]);
        split_tf32(key < Nk ? vb[off] : 0.f, vh[kd][i], vl[kd][i]);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = key0 + 8 * r;
      bk[r] = key < Nk ? biasb[key] : 0.f;
      k_term[r] = row_seed + static_cast<uint32_t>(key) * kC2;
    }
  }
  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

  mbar_wait(kv_bar, 0);
  for (int i = 0; i < tiles; ++i) {
    const int st = i % ST;
    const int q0 = walk(i) * BQ;
    const uint32_t qt = ring_lo + st * (kBwdT32StageBytes >> 4);
    const float* nlt = reinterpret_cast<const float*>(ring + st * kBwdT32StageBytes + 32768);
    const float* dlt = nlt + BQ;
    mbar_wait(&full[st], (i / ST) & 1);

    float tk[D / 2], tv[D / 2];    // the tile's dk and dv, from zero
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // s^T = bias + k qs^T and dp^T = v dO^T over queries 32 h .. + 31.
      float s[16], dp[16];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[4 * j] = s[4 * j + 1] = bk[0];
        s[4 * j + 2] = s[4 * j + 3] = bk[1];
      }
      wgmma_fence();
#pragma unroll
      for (int kd = 0; kd < 2; ++kd) {
        const uint64_t qh = desc_of(qt + (kd * 2048 + h * 1024 >> 4), HI32);
        const uint64_t ql = desc_of(qt + (4096 + kd * 2048 + h * 1024 >> 4), HI32);
        wgmma_tf32_rs_n32(s, kl[kd], qh, 1);
        wgmma_tf32_rs_n32(s, kh[kd], ql, 1);
        wgmma_tf32_rs_n32(s, kh[kd], qh, 1);
      }
#pragma unroll
      for (int kd = 0; kd < 2; ++kd) {
        const uint64_t oh = desc_of(qt + (8192 + kd * 2048 + h * 1024 >> 4), HI32);
        const uint64_t ol = desc_of(qt + (12288 + kd * 2048 + h * 1024 >> 4), HI32);
        wgmma_tf32_rs_n32(dp, vl[kd], oh, kd > 0);
        wgmma_tf32_rs_n32(dp, vh[kd], ol, 1);
        wgmma_tf32_rs_n32(dp, vh[kd], oh, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      wgmma_pin(s);
      wgmma_pin(dp);

      // p, the mask, ds and pv; ds and pv split into the A fragments of dk
      // and dv (chunk j's C fragment {(g, 2t), (g, 2t + 1), (g + 8, 2t),
      // (g + 8, 2t + 1)} is k-step j's {a0, a2, a1, a3}), and ds into the
      // [query][key] tiles of dq.
      const uint32_t q_term = static_cast<uint32_t>(a.q_offset + q0 + 32 * h + 2 * t) * kC3;
      uint32_t dsfh[4][4], dsfl[4][4], pvfh[4][4], pvfl[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 nl = *reinterpret_cast<const float2*>(nlt + 32 * h + 8 * j + 2 * t);
        const float2 dl = *reinterpret_cast<const float2*>(dlt + 32 * h + 8 * j + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = ex2(fmaf(s[4 * j + e], kLog2e, e & 1 ? nl.y : nl.x));
          float dpd = dp[4 * j + e];
          float pv = p;
          if (drop) {
            const bool keep = keep_hash(
                k_term[e >> 1] + q_term + static_cast<uint32_t>(8 * j + (e & 1)) * kC3,
                a.threshold);
            const float kinv = keep ? a.inv_keep : 0.f;
            dpd *= kinv;
            pv = p * kinv;
          }
          const float ds = p * (dpd - (e & 1 ? dl.y : dl.x));
          db[e >> 1] += ds;
          const int ai = (e & 1) * 2 + (e >> 1);
          split_tf32(ds, dsfh[j][ai], dsfl[j][ai]);
          split_tf32(pv, pvfh[j][ai], pvfl[j][ai]);
          const int kq = key_l + 8 * (e >> 1);
          const int off = (kq >> 5) * 8192 +
                          sw128_offset(32 * h + 8 * j + 2 * t + (e & 1), kq & 31);
          *reinterpret_cast<uint32_t*>(dsh + off) = dsfh[j][ai];
          *reinterpret_cast<uint32_t*>(dsl + off) = dsfl[j][ai];
        }
      }

      // dv += pv^T dO, dk += ds^T qs over the half's 32 queries (k-step j:
      // atom h of dO^T / qs^T, 32 bytes a k-step; rows 16-31 are lo).
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int acc = h > 0 || j > 0;
        const uint64_t oth = desc_of(qt + (24576 + h * 4096 + j * 32 >> 4), kSw128DescHi);
        const uint64_t otl = desc_of(qt + (26624 + h * 4096 + j * 32 >> 4), kSw128DescHi);
        const uint64_t qth = desc_of(qt + (16384 + h * 4096 + j * 32 >> 4), kSw128DescHi);
        const uint64_t qtl = desc_of(qt + (18432 + h * 4096 + j * 32 >> 4), kSw128DescHi);
        wgmma_tf32_rs_n16(tv, pvfl[j], oth, acc);
        wgmma_tf32_rs_n16(tv, pvfh[j], otl, 1);
        wgmma_tf32_rs_n16(tv, pvfh[j], oth, 1);
        wgmma_tf32_rs_n16(tk, dsfl[j], qth, acc);
        wgmma_tf32_rs_n16(tk, dsfh[j], qtl, 1);
        wgmma_tf32_rs_n16(tk, dsfh[j], qth, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      wgmma_pin(tk);
      wgmma_pin(tv);
      wgmma_pin(dsfh);
      wgmma_pin(dsfl);
      wgmma_pin(pvfh);
      wgmma_pin(pvfl);
    }
    mbar_arrive(&empty[st]);

    // dq of the tile over the warpgroup's 64 keys, once every warp of the
    // warpgroup has written its ds.
    fence_async_shared();
    named_barrier(1 + wg, 128);
    float dq2[16], dq1[8];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const uint32_t step = (kk >> 2) * 8192 + (kk & 3) * 32 >> 4;
      const uint64_t b = desc_of(kt_lo + ((kk >> 2) * 4096 + (kk & 3) * 32 >> 4), kSw128DescHi);
      wgmma_tf32_ss_n32(dq2, desc_of(ds_lo + step, kSw128DescHi), b, kk > 0);
      wgmma_tf32_ss_n16(dq1, desc_of(ds_lo + (kBwdT32DsBytes >> 4) + step, kSw128DescHi),
                        b, kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_pin(dq2);
    wgmma_pin(dq1);
    named_barrier(1 + wg, 128);    // ds is read: the next tile may write it
    float dq[D / 2];
#pragma unroll
    for (int e = 0; e < D / 2; ++e) dq[e] = (dq2[8 + e] + dq1[e]) + dq2[e];
    // Rows q0 + 16 (warp % 4) + g (+ 8): the lanes of a column quad swap a
    // pair, so that lane t even adds columns 8 c + 2 t .. + 3 of row g and
    // lane t odd those of row g + 8 from 8 c + 2 (t - 1).
    const int qrow = q0 + (warp & 3) * 16 + g + (t & 1) * 8;
    float* accrow = a.dq_acc + (static_cast<long long>(bh) * Nq + qrow) * D;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      const float sx = t & 1 ? dq[4 * c] : dq[4 * c + 2];
      const float sy = t & 1 ? dq[4 * c + 1] : dq[4 * c + 3];
      const float rx = __shfl_xor_sync(0xffffffffu, sx, 1);
      const float ry = __shfl_xor_sync(0xffffffffu, sy, 1);
      const float4 val = t & 1 ? make_float4(rx, ry, dq[4 * c + 2], dq[4 * c + 3])
                               : make_float4(dq[4 * c], dq[4 * c + 1], rx, ry);
      if (qrow < Nq)
        atomicAdd(reinterpret_cast<float4*>(accrow + 8 * c + 2 * (t & 2)), val);
    }
#pragma unroll
    for (int e = 0; e < D / 2; ++e) {
      dk[e] += tk[e];
      dv[e] += tv[e];
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float dbr = db[r];
    dbr += __shfl_xor_sync(0xffffffffu, dbr, 1);
    dbr += __shfl_xor_sync(0xffffffffu, dbr, 2);
    const int key = key0 + 8 * r;
    if (key < Nk) {
      const long long off = (static_cast<long long>(bh) * Nk + key) * D;
      float* dkrow = static_cast<float*>(a.dk) + off;
      float* dvrow = static_cast<float*>(a.dv) + off;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<float2*>(dkrow + 8 * j + 2 * t) =
            make_float2(dk[4 * j + 2 * r], dk[4 * j + 2 * r + 1]);
        *reinterpret_cast<float2*>(dvrow + 8 * j + 2 * t) =
            make_float2(dv[4 * j + 2 * r], dv[4 * j + 2 * r + 1]);
      }
      if (t == 0) a.dbias_bh[static_cast<long long>(bh) * Nk + key] = dbr;
    }
  }
}

// ---- the f32 fused warpgroup body at d 32, 48 and 64 --------------------------

// flash_bwd_wgmma_tf32 at D 32, 48 and 64 (the low-end, mid-range and
//   H100-tier widths): the same five products in three TF32 passes, but the
//   d 16 layout does not fit. There a warpgroup keeps k and v as A fragments
//   in registers (4 D a thread in hi and lo: 256 at D 64) and a query tile of
//   64 in shared memory (2048 D + 512 bytes: 131,584 at D 64). So here:
//   - A consumer warpgroup owns 64 keys; a block is one of them (D 48 and 64)
//     or two (D 32) and a producer warp (160 or 288 threads; no setmaxnreg:
//     the 255 or 224 registers a thread may hold suffice). Each warpgroup's
//     key tile of the pre-pass (1536 D bytes) arrives once, in three bulk
//     copies: K and V as rows (the A of s^T = k qs^T and dp^T = v dO^T, read
//     from shared memory) and K^T as rows (the B of dq += ds k).
//   - Queries come in sub-tiles of 16 (512 D + 128 bytes: qs, dO, qs^T, dO^T
//     in hi and lo, -lse log2 e, delta), four to a query tile of 64, through
//     a ring of 3 (D 64) or 4 (D 32, 48) that the block's warpgroups share,
//     one bulk copy a sub-tile: s^T and dp^T are wgmma m64n16k8 in three
//     passes a k-step of 8 dims, both operands in shared memory.
//   - p, the hash on the score's own (key, query), ds and pv in f32 at the TPU
//     kernel's rounding points, split into hi and lo where the score's C
//     fragment is the A fragment of dk and dv as it lies (the sub-tile's
//     queries of qs^T and dO^T are permuted by `perm8`); dk and dv summed
//     from zero a query tile of 64 (wgmma m64n{D}k8, three passes a k-step
//     of 8 queries), then added with one f32 add: wgmma's sums truncate, so
//     dk and dv never sit in a product's accumulator across the walk.
//   - ds goes to shared memory as well, hi and lo, as rows [64 queries][8
//     keys] a k-step, a buffer a warpgroup: once the query tile's four
//     sub-tiles are in, dq = ds k over the warpgroup's keys is wgmma
//     m64n{D}k8 in three passes a k-step of 8 keys into one accumulator from
//     zero, added to the zeroed f32 dq buffer with 16-byte reductions.
//   - dbias: per-key f32 sums over the 4 lanes of a key, no atomics.
//   Registers a thread: dk, dv and their tile sums (2 D), s and dp (16), the
//   fragments of ds and pv (32). Shared memory at D 64: 99,072 bytes of ring,
//   98,304 of keys, 32,768 of ds: 231,224 with the barriers and the
//   alignment, of 232,448. At D 32 one warpgroup's keys and ds take 81,920
//   bytes, so a second one fits beside a ring of 4 (231,496): two
//   warpgroups on one SM hide each other's chain of products, the ring's
//   sub-tiles serve 128 keys, and the grid halves.
// Dropout is a template parameter; a ragged Nq or Nk costs nothing per score
// (zeros, -inf). dk, dv and dbias are the same on every run; dq's last bits
// depend on the order of the reductions.

__host__ __device__ constexpr int bwd_t32w_stages(int d) { return d == 64 ? 3 : 4; }
// The consumer warpgroups a block: two at D 32, which beat one by 16 % at
// B2, B8 and B16 H8 N16384 on an H100 (timed in turns; PERF.md); one at D 48
// and 64, where a second does not fit.
__host__ __device__ constexpr int bwd_t32w_groups(int d) {
  return d == 32 ? 2 : 1;
}
// A sub-tile's place in the ring: its bytes rounded up to the 32-byte
// swizzle's period.
__host__ __device__ constexpr int bwd_t32w_stage_bytes(int d) {
  return (tf32_bwd_sub_bytes(d) + 255) / 256 * 256;
}
constexpr int kBwdT32wDsBytes = kTf32Rows * 64 * 4;   // ds hi or lo: 64 queries x 64 keys
__host__ __device__ constexpr int bwd_t32_threads(int d) {
  return d == 16 ? 128 * (kBwdT32Consumers + 1) : 128 * bwd_t32w_groups(d) + 32;
}
__host__ __device__ constexpr int bwd_t32_keys(int d) {
  return d == 16 ? kBwdT32Keys : 64 * bwd_t32w_groups(d);
}

// D 16: see t32_bwd_smem_bytes16. D 32, 48, 64: the ring of query sub-tiles,
// each warpgroup's key tile and ds hi and lo, the barriers, and 1024 bytes
// of alignment.
__host__ __device__ constexpr int t32_bwd_smem_bytes(int d) {
  return d == 16 ? t32_bwd_smem_bytes16()
                 : 1024 + bwd_t32w_stages(d) * bwd_t32w_stage_bytes(d) +
                       bwd_t32w_groups(d) *
                           (tf32_bwd_k_tile_bytes(d) + 2 * kBwdT32wDsBytes) +
                       (1 + 2 * bwd_t32w_stages(d)) * 8;
}

// A consumer warpgroup of flash_bwd_wgmma_tf32 at D 32, 48 and 64: warpgroup
// wg of the block owns keys 64 (G blockIdx.x + wg) .., its key tile at kts
// and its ds at dsb. Every wgmma is done before its registers are touched
// again.
template <int D, int DROP>
__device__ __forceinline__ void consume_bwd_tf32_wide(
    const LunarisK2BwdArgs& a, const uint8_t* ring, uint8_t* dsb,
    const uint8_t* kts, uint64_t* kv_bar, uint64_t* full, uint64_t* empty,
    int tiles, int first) {
  constexpr int ST = bwd_t32w_stages(D);
  constexpr int SB = bwd_t32w_stage_bytes(D);
  constexpr int KD = D / 8;        // k-steps of s^T and dp^T
  constexpr uint32_t HI32 = kNarrowDescHi<16>;   // [rows][8] f32, 32-byte swizzle
  const int Nq = a.Nq, Nk = a.Nk;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wg = warp >> 2, wq = warp & 3;         // warpgroup, warp within it
  const int bh = blockIdx.y;
  const int g = lane >> 2;         // the accumulator's row (and row + 8): a key
  const int t = lane & 3;          // its column pair: queries
  const int key_l = wq * 16 + g;                   // within the warpgroup
  const int key0 = (blockIdx.x * bwd_t32w_groups(D) + wg) * 64 + key_l;
  const bool drop = DROP == kDropOn;
  auto walk = [&](int i) {
    const int x = first + i;
    return x < tiles ? x : x - tiles;
  };
  uint8_t* dsh = dsb;              // ds hi, then lo
  uint8_t* dsl = dsb + kBwdT32wDsBytes;
  const uint32_t ds_lo = desc_lo(dsb);
  const uint32_t kt_lo = desc_lo(kts);
  const uint32_t ring_lo = desc_lo(ring);

  float bk[2], db[2] = {0.f, 0.f};
  uint32_t k_term[2];
  {
    const float* biasb = a.bias + static_cast<long long>(bh % a.H) * Nk;
    const uint32_t row_seed = a.seed ^ (static_cast<uint32_t>(bh + a.row_offset) * kC1);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = key0 + 8 * r;
      bk[r] = key < Nk ? biasb[key] : 0.f;
      k_term[r] = row_seed + static_cast<uint32_t>(key) * kC2;
    }
  }
  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

  mbar_wait(kv_bar, 0);
  for (int i = 0; i < tiles; ++i) {
    const int q0 = walk(i) * kTf32Rows;
    float tk[D / 2], tv[D / 2];    // the tile's dk and dv, from zero
#pragma unroll 1
    for (int sub = 0; sub < kTf32Rows / kTf32SubRows; ++sub) {
      const int u = 4 * i + sub;
      const int st = u % ST;
      const uint32_t qt = ring_lo + st * (SB >> 4);
      const float* nlt = reinterpret_cast<const float*>(ring + st * SB + 512 * D);
      const float* dlt = nlt + kTf32SubRows;
      mbar_wait(&full[st], (u / ST) & 1);

      // s^T = bias + k qs^T and dp^T = v dO^T over the sub-tile's 16 queries.
      float s[8], dp[8];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        s[4 * j] = s[4 * j + 1] = bk[0];
        s[4 * j + 2] = s[4 * j + 3] = bk[1];
      }
      wgmma_fence();
#pragma unroll
      for (int kd = 0; kd < KD; ++kd) {
        const uint64_t kh = desc_of(kt_lo + (kd * 2048 >> 4), HI32);
        const uint64_t kl = desc_of(kt_lo + (256 * D + kd * 2048 >> 4), HI32);
        const uint64_t qh = desc_of(qt + (kd * 512 >> 4), HI32);
        const uint64_t ql = desc_of(qt + (64 * D + kd * 512 >> 4), HI32);
        wgmma_tf32_ss_n16(s, kl, qh, 1);
        wgmma_tf32_ss_n16(s, kh, ql, 1);
        wgmma_tf32_ss_n16(s, kh, qh, 1);
      }
#pragma unroll
      for (int kd = 0; kd < KD; ++kd) {
        const uint64_t vh = desc_of(kt_lo + (512 * D + kd * 2048 >> 4), HI32);
        const uint64_t vl = desc_of(kt_lo + (768 * D + kd * 2048 >> 4), HI32);
        const uint64_t oh = desc_of(qt + (128 * D + kd * 512 >> 4), HI32);
        const uint64_t ol = desc_of(qt + (192 * D + kd * 512 >> 4), HI32);
        wgmma_tf32_ss_n16(dp, vl, oh, kd > 0);
        wgmma_tf32_ss_n16(dp, vh, ol, 1);
        wgmma_tf32_ss_n16(dp, vh, oh, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      wgmma_pin(s);
      wgmma_pin(dp);

      // p, the mask, ds and pv; ds and pv split into the A fragments of dk
      // and dv (chunk j's C fragment {(g, 2t), (g, 2t + 1), (g + 8, 2t),
      // (g + 8, 2t + 1)} is k-step j's {a0, a2, a1, a3}), and ds into the
      // [query][key] rows of dq.
      const uint32_t q_term =
          static_cast<uint32_t>(a.q_offset + q0 + kTf32SubRows * sub + 2 * t) * kC3;
      uint32_t dsfh[2][4], dsfl[2][4], pvfh[2][4], pvfl[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float2 nl = *reinterpret_cast<const float2*>(nlt + 8 * j + 2 * t);
        const float2 dl = *reinterpret_cast<const float2*>(dlt + 8 * j + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = ex2(fmaf(s[4 * j + e], kLog2e, e & 1 ? nl.y : nl.x));
          float dpd = dp[4 * j + e];
          float pv = p;
          if (drop) {
            const bool keep = keep_hash(
                k_term[e >> 1] + q_term + static_cast<uint32_t>(8 * j + (e & 1)) * kC3,
                a.threshold);
            const float kinv = keep ? a.inv_keep : 0.f;
            dpd *= kinv;
            pv = p * kinv;
          }
          const float ds = p * (dpd - (e & 1 ? dl.y : dl.x));
          db[e >> 1] += ds;
          const int ai = (e & 1) * 2 + (e >> 1);
          split_tf32(ds, dsfh[j][ai], dsfl[j][ai]);
          split_tf32(pv, pvfh[j][ai], pvfl[j][ai]);
          const int kq = key_l + 8 * (e >> 1);
          const int off = (kq >> 3) * 2048 +
                          sw32_offset(kTf32SubRows * sub + 8 * j + 2 * t + (e & 1), kq & 7);
          *reinterpret_cast<uint32_t*>(dsh + off) = dsfh[j][ai];
          *reinterpret_cast<uint32_t*>(dsl + off) = dsfl[j][ai];
        }
      }

      // dv += pv^T dO, dk += ds^T qs over the sub-tile's 16 queries (k-step
      // j: rows j of dO^T / qs^T, D rows of 32 bytes; lo 64 D bytes on).
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int acc = sub > 0 || j > 0;
        const uint32_t qth = qt + (256 * D + j * 32 * D >> 4);
        const uint32_t oth = qt + (384 * D + j * 32 * D >> 4);
        wgmma_tf32_rs<D>(tv, pvfl[j], desc_of(oth, HI32), acc);
        wgmma_tf32_rs<D>(tv, pvfh[j], desc_of(oth + (64 * D >> 4), HI32), 1);
        wgmma_tf32_rs<D>(tv, pvfh[j], desc_of(oth, HI32), 1);
        wgmma_tf32_rs<D>(tk, dsfl[j], desc_of(qth, HI32), acc);
        wgmma_tf32_rs<D>(tk, dsfh[j], desc_of(qth + (64 * D >> 4), HI32), 1);
        wgmma_tf32_rs<D>(tk, dsfh[j], desc_of(qth, HI32), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      wgmma_pin(tk);
      wgmma_pin(tv);
      wgmma_pin(dsfh);
      wgmma_pin(dsfl);
      wgmma_pin(pvfh);
      wgmma_pin(pvfl);
      mbar_arrive(&empty[st]);
    }

    // dq of the query tile over the warpgroup's 64 keys, once each of its
    // warps has written its ds.
    fence_async_shared();
    named_barrier(1 + wg, 128);
    float dq[D / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const uint64_t ah = desc_of(ds_lo + (kk * 2048 >> 4), HI32);
      const uint64_t al = desc_of(ds_lo + (kBwdT32wDsBytes + kk * 2048 >> 4), HI32);
      const uint64_t bh_ = desc_of(kt_lo + (1024 * D + kk * 32 * D >> 4), HI32);
      const uint64_t bl = desc_of(kt_lo + (1280 * D + kk * 32 * D >> 4), HI32);
      wgmma_tf32_ss<D>(dq, al, bh_, kk > 0);
      wgmma_tf32_ss<D>(dq, ah, bl, 1);
      wgmma_tf32_ss<D>(dq, ah, bh_, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_pin(dq);
    named_barrier(1 + wg, 128);    // ds is read: the next tile may write it
    // Rows q0 + 16 wq + g (+ 8): the lanes of a column quad swap a pair,
    // so that lane t even adds columns 8 c + 2 t .. + 3 of row g and lane t
    // odd those of row g + 8 from 8 c + 2 (t - 1).
    const int qrow = q0 + wq * 16 + g + (t & 1) * 8;
    float* accrow = a.dq_acc + (static_cast<long long>(bh) * Nq + qrow) * D;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      const float sx = t & 1 ? dq[4 * c] : dq[4 * c + 2];
      const float sy = t & 1 ? dq[4 * c + 1] : dq[4 * c + 3];
      const float rx = __shfl_xor_sync(0xffffffffu, sx, 1);
      const float ry = __shfl_xor_sync(0xffffffffu, sy, 1);
      const float4 val = t & 1 ? make_float4(rx, ry, dq[4 * c + 2], dq[4 * c + 3])
                               : make_float4(dq[4 * c], dq[4 * c + 1], rx, ry);
      if (qrow < Nq)
        atomicAdd(reinterpret_cast<float4*>(accrow + 8 * c + 2 * (t & 2)), val);
    }
#pragma unroll
    for (int e = 0; e < D / 2; ++e) {
      dk[e] += tk[e];
      dv[e] += tv[e];
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float dbr = db[r];
    dbr += __shfl_xor_sync(0xffffffffu, dbr, 1);
    dbr += __shfl_xor_sync(0xffffffffu, dbr, 2);
    const int key = key0 + 8 * r;
    if (key < Nk) {
      const long long off = (static_cast<long long>(bh) * Nk + key) * D;
      float* dkrow = static_cast<float*>(a.dk) + off;
      float* dvrow = static_cast<float*>(a.dv) + off;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<float2*>(dkrow + 8 * j + 2 * t) =
            make_float2(dk[4 * j + 2 * r], dk[4 * j + 2 * r + 1]);
        *reinterpret_cast<float2*>(dvrow + 8 * j + 2 * t) =
            make_float2(dv[4 * j + 2 * r], dv[4 * j + 2 * r + 1]);
      }
      if (t == 0) a.dbias_bh[static_cast<long long>(bh) * Nk + key] = dbr;
    }
  }
}

// split: the pre-pass's query tiles (ceil(Nq / 64) a BH row), then its key
// tiles (2 ceil(Nk / 128) a BH row).
template <int D, int DROP>
__global__ void __launch_bounds__(bwd_t32_threads(D), 1)
flash_bwd_wgmma_tf32(const LunarisK2BwdArgs a, const uint8_t* split) {
  constexpr int QTB = tf32_bwd_q_tile_bytes(D);
  constexpr int KTB = tf32_bwd_k_tile_bytes(D);
  constexpr int BQ = kTf32Rows;
  extern __shared__ uint8_t bwd_t32_smem[];
  uint8_t* ring = bwd_t32_smem + ((1024 - (smem_addr(bwd_t32_smem) & 1023)) & 1023);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.y;
  const int tiles = (a.Nq + BQ - 1) / BQ;
  const int first = blockIdx.x % tiles;
  const int ktiles = 2 * ((a.Nk + 2 * kTf32Rows - 1) / (2 * kTf32Rows));
  const uint8_t* q_src = split + static_cast<long long>(bh) * tiles * QTB;
  const uint8_t* k_src = split + static_cast<long long>(a.BH) * tiles * QTB +
                         static_cast<long long>(bh) * ktiles * KTB;

  if constexpr (D == 16) {
    constexpr int ST = kBwdT32Stages;
    uint8_t* dsb = ring + ST * kBwdT32StageBytes;
    uint8_t* kts = dsb + kBwdT32Consumers * 2 * kBwdT32DsBytes;
    uint64_t* kv_bar = reinterpret_cast<uint64_t*>(kts + kBwdT32Consumers * KTB);
    uint64_t* full = kv_bar + 1;
    uint64_t* empty = full + ST;
    if (tid == 0) {
      mbar_init(kv_bar, 1);
      for (int i = 0; i < ST; ++i) {
        mbar_init(&full[i], 1);
        mbar_init(&empty[i], 128 * kBwdT32Consumers);
      }
      mbar_fence_init();
    }
    __syncthreads();

    if (warp >= 4 * kBwdT32Consumers) {
      // The producer warpgroup: one lane loads, the registers go to the
      // consumers (2 x 128 x 232 + 128 x 40 = the block's 384 x 168).
      setmaxnreg_dec<40>();
      if (warp != 4 * kBwdT32Consumers || lane != 0) return;
      mbar_arrive_tx(kv_bar, kBwdT32Consumers * KTB);
      bulk_load(kts, k_src + static_cast<long long>(2 * blockIdx.x) * KTB,
                kBwdT32Consumers * KTB, kv_bar);
      for (int i = 0; i < tiles; ++i) {
        const int st = i % ST;
        const int x = first + i;
        if (i >= ST) mbar_wait(&empty[st], ((i / ST) & 1) ^ 1);
        mbar_arrive_tx(&full[st], QTB);
        bulk_load(ring + st * kBwdT32StageBytes,
                  q_src + static_cast<long long>(x < tiles ? x : x - tiles) * QTB,
                  QTB, &full[st]);
      }
    } else {
      setmaxnreg_inc<232>();
      consume_bwd_tf32<DROP>(a, ring, dsb, kts, kv_bar, full, empty, tiles, first);
    }
  } else {
    constexpr int ST = bwd_t32w_stages(D);
    constexpr int SB = bwd_t32w_stage_bytes(D);
    constexpr int SUB = tf32_bwd_sub_bytes(D);
    constexpr int G = bwd_t32w_groups(D);
    uint8_t* kts = ring + ST * SB;                 // G key tiles
    uint8_t* dsb = kts + G * KTB;                  // G ds buffers (hi, lo)
    uint64_t* kv_bar = reinterpret_cast<uint64_t*>(dsb + G * 2 * kBwdT32wDsBytes);
    uint64_t* full = kv_bar + 1;
    uint64_t* empty = full + ST;
    if (tid == 0) {
      mbar_init(kv_bar, 1);
      for (int i = 0; i < ST; ++i) {
        mbar_init(&full[i], 1);
        mbar_init(&empty[i], 128 * G);
      }
      mbar_fence_init();
    }
    __syncthreads();

    if (warp >= 4 * G) {
      // The producer warp: one lane loads the block's G key tiles, three
      // copies a tile (K, V, K^T), then walks the query sub-tiles.
      if (lane != 0) return;
      const uint8_t* kb = k_src + static_cast<long long>(blockIdx.x) * G * KTB;
      mbar_arrive_tx(kv_bar, G * KTB);
      for (int c = 0; c < 3 * G; ++c)
        bulk_load(kts + c * (KTB / 3), kb + c * (KTB / 3), KTB / 3, kv_bar);
      for (int u = 0; u < 4 * tiles; ++u) {
        const int st = u % ST;
        const int x = first + u / 4;
        if (u >= ST) mbar_wait(&empty[st], ((u / ST) & 1) ^ 1);
        mbar_arrive_tx(&full[st], SUB);
        bulk_load(ring + st * SB,
                  q_src + static_cast<long long>(x < tiles ? x : x - tiles) * QTB +
                      (u % 4) * SUB,
                  SUB, &full[st]);
      }
    } else {
      const int wg = warp >> 2;
      consume_bwd_tf32_wide<D, DROP>(a, ring, dsb + wg * 2 * kBwdT32wDsBytes,
                                     kts + wg * KTB, kv_bar, full, empty,
                                     tiles, first);
    }
  }
}

template <int D, int DROP>
int launch_bwd_wgmma_tf32(const LunarisK2BwdArgs& a, const void* split,
                          cudaStream_t stream) {
  if (split == nullptr || reinterpret_cast<uintptr_t>(split) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(a.dk) % 8 != 0 ||
      reinterpret_cast<uintptr_t>(a.dv) % 8 != 0 || a.dq_acc == nullptr ||
      reinterpret_cast<uintptr_t>(a.dq_acc) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = flash_bwd_wgmma_tf32<D, DROP>;
  constexpr int smem = t32_bwd_smem_bytes(D);
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.Nk + bwd_t32_keys(D) - 1) / bwd_t32_keys(D), a.BH);
  kernel<<<grid, bwd_t32_threads(D), smem, stream>>>(
      a, static_cast<const uint8_t*>(split));
  return static_cast<int>(cudaGetLastError());
}

template <int D, int DROP>
int launch_bwd_wgmma_narrow(const LunarisK2BwdArgs& a, cudaStream_t stream) {
  if (!bwd_mma_aligned(a) || reinterpret_cast<uintptr_t>(a.dk) % 4 != 0 ||
      reinterpret_cast<uintptr_t>(a.dv) % 4 != 0 || a.dq_acc == nullptr ||
      reinterpret_cast<uintptr_t>(a.dq_acc) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  K2BwdMaps maps;
  if (!bf16_narrow_tile_map(&maps.q, a.q, a.BH, a.Nq, D, kBwdNwBQ) ||
      !bf16_narrow_tile_map(&maps.dout, a.dout, a.BH, a.Nq, D, kBwdNwBQ) ||
      !bf16_narrow_tile_map(&maps.k, a.k, a.BH, a.Nk, D, kBwdNwKeys) ||
      !bf16_narrow_tile_map(&maps.v, a.v, a.BH, a.Nk, D, kBwdNwKeys))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = flash_bwd_wgmma_narrow<D, DROP>;
  constexpr int smem = nw_bwd_smem_bytes(D);
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.Nk + kBwdNwKeys - 1) / kBwdNwKeys, a.BH);
  kernel<<<grid, kBwdNwThreads, smem, stream>>>(a, maps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
