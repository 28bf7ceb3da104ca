// K2 forward -- the two kernel bodies of the flash-attention forward and of
// its stage family, for Hopper (sm_90a). Included by the flash_attention_fwd*
// sources (the full chain) and by flash_attention_stages.cu (the chain cut
// after a named stage); the build hashes this header with the sources.
//
// Replaces lunaris_orion_tpu/ops/pallas/flash_attention.py `_fwd_kernel`
// (launched by `_fwd`, reached through `attention_bhnd`) and, cut after a
// stage, tools/bench_attn_roofline.py `_stage_kernel`.
//
//   o   = softmax(q k^T d^-1/2 + bias[h, k]) v     (dropout on the probabilities)
//   lse = m + log(l)
//
// Layout: q [BH, Nq, d], k/v [BH, Nk, d], each row's d values contiguous
// (the TPU kernel carried [BH, d, N] for its 128-wide lanes; that choice does
// not carry over). bias [H, Nk] f32, indexed by bh % H. o [BH, Nq, d] in the
// input type, lse [BH, Nq] f32.
//
// Rounding points match the TPU kernel: q is scaled by d^-1/2 and rounded to
// the input type; scores, running max, row sums and the accumulator are f32;
// the (dropped, rescaled) probabilities are rounded to v's type before P.V;
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
// Bound. At the teacher's d = 16 the kernel does 4 N^2 d operations on O(N d)
// bytes: operations, by two orders of magnitude. On the tensor cores the two
// products are about 1 ms at B 8, H 8, N 16384, so what is left bounds the
// kernel: per score one exp on the special-function units (16 a clock an SM:
// 4 to 5 ms for the 1.7e10 scores of that shape), the max, the subtraction,
// the row sum, the pack to bf16 and, with dropout, the hash.
//
// Two bodies, both templated on the head size D, the stage level LVL (4 =
// the full chain), the dropout mode and whether Nk may be ragged:
//
//   flash_fwd_mma   bf16, D a multiple of 16. Both products run on the tensor
//       cores with mma.sync m16n8k16 (bf16 x bf16 -> f32). A warp owns 32
//       query rows at d = 16 (two 16-row tiles; one at d 48 and 64), 4 warps
//       a block: 128 rows halve what a block reads of K and V against 64,
//       and that traffic, not the products, bounded the first version. q is
//       the A fragment, scaled and rounded once. K, V (bf16, rows padded by
//       16 bytes against bank conflicts) and the bias arrive by cp.async in a
//       ring of 2 or 3 key tiles of 64, so the next tile loads under this
//       one's math; K's rows are the `col` operand of q k^T (ldmatrix), V's
//       of p v (ldmatrix.trans). The bias is the c operand of the first
//       q k^T product. The f32 score fragments of two neighbouring 8-key
//       tiles, once exponentiated, dropped and packed, are the A fragment of
//       p v: p never leaves the registers. p v is summed from zero each key
//       tile and added to the running accumulator with one rounded f32 FMA
//       (the tensor cores' own sums truncate). The row max is reduced across
//       the 4 lanes of a row with shuffles; the row sum stays a per-lane
//       partial until the end. exp is ex2.approx on fma(s, log2 e,
//       -m log2 e): one FMA and one special-function instruction a score.
//       The hash takes k_abs and q_abs from the fragment's own coordinates.
//       Only the last key tile is masked.
//   flash_fwd_simt  f32 or bf16, on the CUDA cores: one thread owns one query
//       row (q and the f32 accumulator in registers), a block of 128 rows
//       walks the keys in tiles staged in shared memory as f32, so every
//       thread of the block reads the same k/v element at once (a broadcast).
//       It is the f32 path (TF32 would cost three decimal digits), the bf16
//       path at d = 8, and at d = 16 the earlier bf16 kernel that
//       measurements compare the tensor-core body with.
//
// Stage levels (q arrives scaled, the entry point passes scale = 1; no
// dropout, whole key tiles), per key tile with s = q k^T:
//   0 "dots"    p = s                                  m stays 0
//   1 "bias"    s += bias[h, k]
//   2 "maxsub"  m_new = max(m, max s); corr = exp(m - m_new); s -= m_new
//   3 "exp"     p = exp(s)
//   4 "sum"     l = l corr + sum p          (below: l = l corr + 1)
// and always acc = acc corr + round_T(p) v. Below "maxsub" m starts at 0 and
// corr is 1; from "maxsub" on m starts at -1e30. Below "sum" the carry l
// gains 1 per key TILE, so o and lse depend on the tile size.
//
// A ragged Nq is guarded in every instance (a test per row at the loads and
// stores, none per score); RAGGED is about Nk alone.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>

#include "common.cuh"

// Arguments of every forward kernel. scale: d^-1/2 already rounded to the
// input type (1 for the stage family). threshold: the uint32 keep threshold,
// inv_keep: f32(1 / (1 - rate)).
struct LunarisK2FwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const float* bias;
  void* o;
  float* lse;
  int BH, H, Nq, Nk;
  float scale;
  int use_dropout;
  uint32_t threshold;
  float inv_keep;
  uint32_t seed;
  int q_offset, row_offset;
};

// The full chain, one translation unit each (flash_attention_fwd_*.cu; the
// CUDA-core body's wide head sizes, 48 and 64, compile longest and have
// their own, in f32 only: in bf16 they take the tensor cores). Each returns
// the cudaError_t of the launch, cudaErrorInvalidValue for a head size it was
// not compiled for.
int lunaris_k2_fwd_simt_f32(const LunarisK2FwdArgs& a, int d, cudaStream_t s);
int lunaris_k2_fwd_simt_f32_wide(const LunarisK2FwdArgs& a, int d, cudaStream_t s);
int lunaris_k2_fwd_simt_bf16(const LunarisK2FwdArgs& a, int d, cudaStream_t s);
int lunaris_k2_fwd_mma_bf16(const LunarisK2FwdArgs& a, int d, cudaStream_t s);

namespace {

constexpr uint32_t kC1 = 0x9E3779B9u;
constexpr uint32_t kC2 = 0x85EBCA6Bu;
constexpr uint32_t kC3 = 0xC2B2AE35u;

constexpr int kLevelFull = 4;
// Dropout as a template parameter: compiled out, compiled in, or decided by
// args.use_dropout at run time (one instance for a head size that only tests
// and small configurations reach).
constexpr int kDropOff = 0;
constexpr int kDropOn = 1;
constexpr int kDropRuntime = 2;

constexpr int kSimtRows = 128;

__host__ __device__ constexpr int simt_block_k(int d) { return d <= 16 ? 64 : 32; }

template <typename T, int D, int LVL, int DROP, bool RAGGED>
__global__ void __launch_bounds__(kSimtRows)
flash_fwd_simt(const LunarisK2FwdArgs a) {
  constexpr int BK = simt_block_k(D);
  __shared__ __align__(16) float ks[BK][D];
  __shared__ __align__(16) float vs[BK][D];
  __shared__ float bs[BK];

  const int Nq = a.Nq, Nk = a.Nk;
  const int bh = blockIdx.y;
  const int row = blockIdx.x * kSimtRows + threadIdx.x;
  const bool valid = row < Nq;
  const T* kb = static_cast<const T*>(a.k) + static_cast<long long>(bh) * Nk * D;
  const T* vb = static_cast<const T*>(a.v) + static_cast<long long>(bh) * Nk * D;
  const float* biasb = a.bias + static_cast<long long>(bh % a.H) * Nk;
  const bool drop = DROP == kDropOn || (DROP == kDropRuntime && a.use_dropout);

  float qr[D];
  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = 0.f;
    acc[d] = 0.f;
  }
  if (valid) {
    const T* qrow =
        static_cast<const T*>(a.q) + (static_cast<long long>(bh) * Nq + row) * D;
#pragma unroll
    for (int d = 0; d < D; ++d)
      qr[d] = round_to<T>(to_f32(qrow[d]) * a.scale);
  }
  float m = LVL >= 2 ? -1e30f : 0.f;
  float l = 0.f;
  const uint32_t row_seed =
      a.seed ^ (static_cast<uint32_t>(bh + a.row_offset) * kC1);
  const uint32_t q_term = static_cast<uint32_t>(a.q_offset + row) * kC3;

  for (int k0 = 0; k0 < Nk; k0 += BK) {
    __syncthreads();
    for (int i = threadIdx.x; i < BK * D; i += kSimtRows) {
      const int j = i / D;
      const int d = i % D;
      const bool in = !RAGGED || k0 + j < Nk;
      const long long off = static_cast<long long>(k0 + j) * D + d;
      ks[j][d] = in ? to_f32(kb[off]) : 0.f;
      vs[j][d] = in ? to_f32(vb[off]) : 0.f;
    }
    if (LVL >= 1)
      for (int j = threadIdx.x; j < BK; j += kSimtRows)
        bs[j] = !RAGGED || k0 + j < Nk ? biasb[k0 + j] : 0.f;
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
      s[j] = !RAGGED || k0 + j < Nk ? dot : -INFINITY;
      if (LVL >= 2) m_new = fmaxf(m_new, s[j]);
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
      if (drop) {
        uint32_t h = row_seed + static_cast<uint32_t>(k0 + j) * kC2 + q_term;
        h ^= h >> 15;
        h *= kC2;
        p = h < a.threshold ? p * a.inv_keep : 0.f;
      }
      p = round_to<T>(p);
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] = fmaf(p, vs[j][d], acc[d]);
    }
    m = m_new;
  }

  if (valid) {
    l = fmaxf(l, 1e-30f);
    T* orow = static_cast<T*>(a.o) + (static_cast<long long>(bh) * Nq + row) * D;
#pragma unroll
    for (int d = 0; d < D; ++d) orow[d] = from_f32<T>(acc[d] / l);
    a.lse[static_cast<long long>(bh) * Nq + row] = m + logf(l);
  }
}

template <typename T, int D, int LVL, int DROP, bool RAGGED>
int launch_simt(const LunarisK2FwdArgs& a, cudaStream_t stream) {
  if (!RAGGED && a.Nk % simt_block_k(D) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((a.Nq + kSimtRows - 1) / kSimtRows, a.BH);
  flash_fwd_simt<T, D, LVL, DROP, RAGGED><<<grid, kSimtRows, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The full chain on the CUDA cores. At the teacher's d = 16 dropout and
// raggedness are compiled in (four instances); the other head sizes keep one
// instance that tests both at run time.
template <typename T>
int launch_simt_full(const LunarisK2FwdArgs& a, int d, cudaStream_t s) {
  constexpr int F = kLevelFull;
  const bool ragged = a.Nk % simt_block_k(16) != 0;
  switch (d) {
    case 8: return launch_simt<T, 8, F, kDropRuntime, true>(a, s);
    case 16:
      if (a.use_dropout)
        return ragged ? launch_simt<T, 16, F, kDropOn, true>(a, s)
                      : launch_simt<T, 16, F, kDropOn, false>(a, s);
      return ragged ? launch_simt<T, 16, F, kDropOff, true>(a, s)
                    : launch_simt<T, 16, F, kDropOff, false>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch_simt_full_wide(const LunarisK2FwdArgs& a, int d, cudaStream_t s) {
  constexpr int F = kLevelFull;
  switch (d) {
    case 48: return launch_simt<T, 48, F, kDropRuntime, true>(a, s);
    case 64: return launch_simt<T, 64, F, kDropRuntime, true>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---- the tensor-core body ---------------------------------------------------

constexpr int kMmaBK = 64;       // keys a tile
constexpr float kLog2e = 1.4426950408889634f;

// Warps a block, and 16-row tiles a warp: two at d = 16, where a block's 128
// rows halve what it reads of K and V against 64 and a K or V fragment
// serves both tiles; one at the wider heads, whose accumulators fill the
// registers.
__host__ __device__ constexpr int mma_warps(int) { return 4; }
__host__ __device__ constexpr int mma_tiles(int d) { return d <= 16 ? 2 : 1; }
__host__ __device__ constexpr int mma_rows(int d) {
  return 16 * mma_tiles(d) * mma_warps(d);
}

// Key tiles in flight: static shared memory stays under 48 KB at every D.
__host__ __device__ constexpr int mma_stages(int d, int bk) {
  return 3 * 2 * bk * (d + 8) * 2 + 3 * bk * 4 <= 48 * 1024 ? 3 : 2;
}

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

template <int D, int LVL, int DROP, bool RAGGED>
__global__ void __launch_bounds__(32 * mma_warps(D))
flash_fwd_mma(const LunarisK2FwdArgs a) {
  static_assert(D % 16 == 0, "the tensor-core body takes whole k-steps of 16");
  using bf16 = __nv_bfloat16;
  constexpr int W = mma_warps(D);
  constexpr int MT = mma_tiles(D);
  constexpr int BK = kMmaBK;
  constexpr int THREADS = 32 * W;
  constexpr int ST = mma_stages(D, BK);
  constexpr int LD = D + 8;        // a row and 16 bytes: ldmatrix without conflicts
  constexpr int KD = D / 16;       // k-steps of q k^T; pairs of d tiles of p v
  constexpr int NT = BK / 8;       // 8-key score tiles
  __shared__ __align__(16) bf16 ks[ST][BK][LD];
  __shared__ __align__(16) bf16 vs[ST][BK][LD];
  __shared__ __align__(16) float bs[ST][BK];

  const int Nq = a.Nq, Nk = a.Nk;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = lane >> 2;         // the fragment's row (and row + 8)
  const int t = lane & 3;          // the fragment's column pair
  const int bh = blockIdx.y;
  // Row g of this warp's first 16-row tile; tile mt, half r: + 16 mt + 8 r.
  const int row0 = (blockIdx.x * W + (tid >> 5)) * 16 * MT + g;
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
    if (LVL >= 1)
      for (int c = tid; c < BK; c += THREADS) {
        const bool in = !RAGGED || k0 + c < Nk;
        cp_async_4(&bs[st][c], biasb + (in ? k0 + c : 0), in ? 4 : 0);
      }
  };

  // The first tiles go out before q is read.
#pragma unroll
  for (int i = 0; i < ST - 1; ++i) {
    if (i < tiles) load_tile(i);
    cp_async_commit();
  }

  // q as the A fragments of q k^T, scaled and rounded once.
  uint32_t qf[MT][KD][4];
  {
    const bf16* qb = static_cast<const bf16*>(a.q) + static_cast<long long>(bh) * Nq * D;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int kd = 0; kd < KD; ++kd)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = row0 + 16 * mt + (i & 1) * 8;
          const int col = kd * 16 + (i >> 1) * 8 + 2 * t;
          uint32_t x = 0u;
          if (row < Nq)
            x = *reinterpret_cast<const uint32_t*>(
                qb + static_cast<long long>(row) * D + col);
          qf[mt][kd][i] = scale_bf16x2(x, a.scale);
        }
  }

  float acc[MT][2 * KD][4];
  float m[MT][2], l[MT][2];        // rows g and g + 8; l is this lane's share
  uint32_t q_term[MT][2];
  const uint32_t row_seed =
      a.seed ^ (static_cast<uint32_t>(bh + a.row_offset) * kC1);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int n = 0; n < 2 * KD; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][n][i] = 0.f;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m[mt][r] = LVL >= 2 ? -1e30f : 0.f;
      l[mt][r] = 0.f;
      q_term[mt][r] =
          row_seed +
          static_cast<uint32_t>(a.q_offset + row0 + 16 * mt + 8 * r) * kC3;
    }
  }

  // ldmatrix: this lane's row and column offset within a 16 x 16 block, for
  // K (matrices: keys 0-7 d 0-7, keys 0-7 d 8-15, keys 8-15 d 0-7, keys 8-15
  // d 8-15) and for V (keys 0-7 d 0-7, keys 8-15 d 0-7, keys 0-7 d 8-15,
  // keys 8-15 d 8-15).
  const int mi = lane >> 3;
  const int k_row = (mi >> 1) * 8 + (lane & 7), k_col = (mi & 1) * 8;
  const int v_row = (mi & 1) * 8 + (lane & 7), v_col = (mi >> 1) * 8;

  for (int tile = 0; tile < tiles; ++tile) {
    cp_async_wait<ST - 2>();       // this tile has landed
    __syncthreads();               // for every thread; the tile before is read
    if (tile + ST - 1 < tiles) load_tile(tile + ST - 1);
    cp_async_commit();
    const int st = tile % ST;
    const int k0 = tile * BK;

    // s = q k^T (+ bias): the bias is the first product's c operand.
    float s[MT][NT][4];
#pragma unroll
    for (int j = 0; j < NT / 2; ++j) {
      float2 b[2] = {make_float2(0.f, 0.f), make_float2(0.f, 0.f)};
      if (LVL >= 1) {
        b[0] = *reinterpret_cast<const float2*>(&bs[st][16 * j + 2 * t]);
        b[1] = *reinterpret_cast<const float2*>(&bs[st][16 * j + 8 + 2 * t]);
      }
#pragma unroll
      for (int kd = 0; kd < KD; ++kd) {
        uint32_t kf[4];
        ldmatrix_x4(kf, &ks[st][16 * j + k_row][16 * kd + k_col]);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          if (kd == 0) {
            mma_bf16(s[mt][2 * j], qf[mt][0], kf[0], kf[1], b[0].x, b[0].y,
                     b[0].x, b[0].y);
            mma_bf16(s[mt][2 * j + 1], qf[mt][0], kf[2], kf[3], b[1].x, b[1].y,
                     b[1].x, b[1].y);
          } else {
            mma_bf16(s[mt][2 * j], qf[mt][kd], kf[0], kf[1]);
            mma_bf16(s[mt][2 * j + 1], qf[mt][kd], kf[2], kf[3]);
          }
        }
      }
    }
    if (RAGGED && k0 + BK > Nk) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (k0 + 8 * n + 2 * t + (i & 1) >= Nk) s[mt][n][i] = -INFINITY;
    }

    float corr[MT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      corr[mt][0] = corr[mt][1] = 1.f;
      if (LVL >= 2) {
        float mx[2] = {m[mt][0], m[mt][1]};
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          mx[0] = fmaxf(mx[0], fmaxf(s[mt][n][0], s[mt][n][1]));
          mx[1] = fmaxf(mx[1], fmaxf(s[mt][n][2], s[mt][n][3]));
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          corr[mt][r] = ex2((m[mt][r] - mx[r]) * kLog2e);
          m[mt][r] = mx[r];
          l[mt][r] *= corr[mt][r];
        }
        const float neg[2] = {-mx[0] * kLog2e, -mx[1] * kLog2e};
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            float p = s[mt][n][i];
            if (LVL >= 3) p = ex2(fmaf(p, kLog2e, neg[i >> 1]));
            else p -= mx[i >> 1];
            if (LVL >= 4) l[mt][i >> 1] += p;
            s[mt][n][i] = p;
          }
      }
      if (LVL < 4) {               // 1 a key tile, over the row's 4 lanes
        l[mt][0] += 0.25f;
        l[mt][1] += 0.25f;
      }
      if (drop) {
        const uint32_t k_term = static_cast<uint32_t>(k0 + 2 * t) * kC2;
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            uint32_t h = q_term[mt][i >> 1] + k_term +
                         static_cast<uint32_t>(8 * n + (i & 1)) * kC2;
            h ^= h >> 15;
            h *= kC2;
            s[mt][n][i] = h < a.threshold ? s[mt][n][i] * a.inv_keep : 0.f;
          }
      }
    }

    // pv = round_bf16(p) v, summed from zero a tile (the tensor cores'
    // sums truncate: a short chain, then one rounded f32 add), and
    // acc = acc corr + pv. Two neighbouring score tiles are one A fragment.
    float pv[MT][2 * KD][4];
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
      uint32_t pf[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        pf[mt][0] = pack_bf16(s[mt][2 * kk][0], s[mt][2 * kk][1]);
        pf[mt][1] = pack_bf16(s[mt][2 * kk][2], s[mt][2 * kk][3]);
        pf[mt][2] = pack_bf16(s[mt][2 * kk + 1][0], s[mt][2 * kk + 1][1]);
        pf[mt][3] = pack_bf16(s[mt][2 * kk + 1][2], s[mt][2 * kk + 1][3]);
      }
#pragma unroll
      for (int dd = 0; dd < KD; ++dd) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, &vs[st][16 * kk + v_row][16 * dd + v_col]);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          if (kk == 0) {
            mma_bf16(pv[mt][2 * dd], pf[mt], vf[0], vf[1], 0.f, 0.f, 0.f, 0.f);
            mma_bf16(pv[mt][2 * dd + 1], pf[mt], vf[2], vf[3], 0.f, 0.f, 0.f,
                     0.f);
          } else {
            mma_bf16(pv[mt][2 * dd], pf[mt], vf[0], vf[1]);
            mma_bf16(pv[mt][2 * dd + 1], pf[mt], vf[2], vf[3]);
          }
        }
      }
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < 2 * KD; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          acc[mt][n][i] = fmaf(acc[mt][n][i], corr[mt][i >> 1], pv[mt][n][i]);
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float lr = l[mt][r];
      lr += __shfl_xor_sync(0xffffffffu, lr, 1);
      lr += __shfl_xor_sync(0xffffffffu, lr, 2);
      lr = fmaxf(lr, 1e-30f);
      const int row = row0 + 16 * mt + 8 * r;
      if (row < Nq) {
        bf16* orow = static_cast<bf16*>(a.o) + (static_cast<long long>(bh) * Nq + row) * D;
#pragma unroll
        for (int n = 0; n < 2 * KD; ++n)
          *reinterpret_cast<uint32_t*>(orow + 8 * n + 2 * t) = pack_bf16(
              acc[mt][n][2 * r] / lr, acc[mt][n][2 * r + 1] / lr);
        if (t == 0)
          a.lse[static_cast<long long>(bh) * Nq + row] = m[mt][r] + logf(lr);
      }
    }
}

template <int D, int LVL, int DROP, bool RAGGED>
int launch_mma(const LunarisK2FwdArgs& a, cudaStream_t stream) {
  // cp.async moves 16 bytes: k and v must be aligned to that (rows are).
  if ((!RAGGED && a.Nk % kMmaBK != 0) ||
      reinterpret_cast<uintptr_t>(a.k) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(a.v) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(a.q) % 4 != 0 ||
      reinterpret_cast<uintptr_t>(a.o) % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((a.Nq + mma_rows(D) - 1) / mma_rows(D), a.BH);
  flash_fwd_mma<D, LVL, DROP, RAGGED>
      <<<grid, 32 * mma_warps(D), 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
