// K2 forward -- the four kernel bodies of the flash-attention forward and of
// its stage family, for Hopper (sm_90a). Included by the flash_attention_fwd*
// sources (the full chain) and by flash_attention_stages.cu (the chain cut
// after a named stage); the build hashes this header with the sources. The
// hash constants, the dropout modes and the wrappers of cp.async, ldmatrix,
// mma.sync, the TF32 split and ex2 are in flash_attention_common.cuh, shared
// with the backward.
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
// Three bodies templated on the head size D, the stage level LVL (4 = the
// full chain), the dropout mode and whether Nk may be ragged, and two more,
// flash_fwd_wgmma (bf16 at d 48 and 64) and flash_fwd_wgmma_narrow (bf16 at
// d 16 and 32), the full chain only (their own notes below), on the D and the
// dropout mode alone:
//
//   flash_fwd_mma   bf16, D a multiple of 16 (at d 16 and 32 the short rows
//       of the windowed fold since the narrow body). Both products run on
//       the tensor cores with mma.sync m16n8k16 (bf16 x bf16 -> f32). A
//       warp owns 32 query rows at d = 16 (two 16-row tiles; one at d 32,
//       48, 64), 4 warps a block: 128 rows halve what a block reads of K
//       and V against 64,
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
//   flash_fwd_tf32  f32, D a multiple of 16: flash_fwd_mma's design on
//       mma.sync m16n8k8 tf32, each product in three TF32 passes, which hold
//       f32's accuracy where one pass would not (its own note, below).
//   flash_fwd_simt  f32 or bf16, on the CUDA cores: one thread owns one query
//       row (q and the f32 accumulator in registers), a block of 128 rows
//       walks the keys in tiles staged in shared memory as f32, so every
//       thread of the block reads the same k/v element at once (a broadcast).
//       It is the f32 and bf16 path at d = 8, and the earlier kernel that
//       measurements compare the tensor-core bodies with (f32 at every head
//       size, bf16 at d = 16).
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

#include "flash_attention_common.cuh"

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
int lunaris_k2_fwd_tf32(const LunarisK2FwdArgs& a, int d, cudaStream_t s);
// Head size 32, both bodies (is_bf16 and body as the entry point's).
int lunaris_k2_fwd_d32(const LunarisK2FwdArgs& a, int is_bf16, int body,
                       cudaStream_t s);
// The warpgroup body, bf16 at d 48 and 64, one translation unit an instance
// (flash_attention_fwd_wgmma_d{48,64}{,_drop}.cu).
int lunaris_k2_fwd_wgmma_d48(const LunarisK2FwdArgs& a, cudaStream_t s);
int lunaris_k2_fwd_wgmma_d48_drop(const LunarisK2FwdArgs& a, cudaStream_t s);
int lunaris_k2_fwd_wgmma_d64(const LunarisK2FwdArgs& a, cudaStream_t s);
int lunaris_k2_fwd_wgmma_d64_drop(const LunarisK2FwdArgs& a, cudaStream_t s);
// The narrow warpgroup body, bf16 at d 16 and 32
// (flash_attention_fwd_wgmma_d{16,32}{,_drop}.cu).
int lunaris_k2_fwd_wgmma_d16(const LunarisK2FwdArgs& a, cudaStream_t s);
int lunaris_k2_fwd_wgmma_d16_drop(const LunarisK2FwdArgs& a, cudaStream_t s);
int lunaris_k2_fwd_wgmma_d32(const LunarisK2FwdArgs& a, cudaStream_t s);
int lunaris_k2_fwd_wgmma_d32_drop(const LunarisK2FwdArgs& a, cudaStream_t s);
// The f32 warpgroup body at d 16, 32, 48 and 64
// (flash_attention_fwd_wgmma_tf32_d{16,32,48,64}{,_drop}.cu), on the key
// tiles the pre-pass wrote (`split`: flash_attention_tf32_split.cu).
int lunaris_k2_fwd_wgmma_tf32_d16(const LunarisK2FwdArgs& a, const void* split,
                                  cudaStream_t s);
int lunaris_k2_fwd_wgmma_tf32_d16_drop(const LunarisK2FwdArgs& a,
                                       const void* split, cudaStream_t s);
int lunaris_k2_fwd_wgmma_tf32_d32(const LunarisK2FwdArgs& a, const void* split,
                                  cudaStream_t s);
int lunaris_k2_fwd_wgmma_tf32_d32_drop(const LunarisK2FwdArgs& a,
                                       const void* split, cudaStream_t s);
int lunaris_k2_fwd_wgmma_tf32_d48(const LunarisK2FwdArgs& a, const void* split,
                                  cudaStream_t s);
int lunaris_k2_fwd_wgmma_tf32_d48_drop(const LunarisK2FwdArgs& a,
                                       const void* split, cudaStream_t s);
int lunaris_k2_fwd_wgmma_tf32_d64(const LunarisK2FwdArgs& a, const void* split,
                                  cudaStream_t s);
int lunaris_k2_fwd_wgmma_tf32_d64_drop(const LunarisK2FwdArgs& a,
                                       const void* split, cudaStream_t s);

namespace {

constexpr int kLevelFull = 4;
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

// ---- the tensor-core body for f32: three TF32 passes ------------------------

// Keys a tile: 64, and 32 at d 48 and 64, whose score and accumulator
// fragments would otherwise fill the registers.
__host__ __device__ constexpr int tf32_block_k(int d) { return d <= 32 ? 64 : 32; }
// 16-row tiles a warp (two at d 16, as the bf16 body), 4 warps a block.
__host__ __device__ constexpr int tf32_tiles(int d) { return d <= 16 ? 2 : 1; }
constexpr int kTf32Warps = 4;
constexpr int kTf32Stages = 2;
__host__ __device__ constexpr int tf32_rows(int d) {
  return 16 * tf32_tiles(d) * kTf32Warps;
}
// A stage of the ring, in floats: K and V, each as TF32 hi and lo in rows of
// d + 4 (the B fragments' reads meet no bank conflict), and the bias.
__host__ __device__ constexpr int tf32_stage_floats(int d) {
  return 4 * tf32_block_k(d) * (d + 4) + tf32_block_k(d);
}
__host__ __device__ constexpr int tf32_smem_bytes(int d) {
  return kTf32Stages * tf32_stage_floats(d) * 4;
}

// flash_fwd_tf32  f32 at D 16, 32, 48, 64: flash_fwd_mma's design carried to
// 32-bit fragments, both products on mma.sync m16n8k8 tf32 in three passes
// (mma_tf32x3: a_lo b_hi + a_hi b_lo + a_hi b_hi), which hold the f32
// product: one TF32 pass would leave o 1e-4 from f64 at the teacher's
// magnitudes, past the f32 bar of 1e-5 (tests/test_torch_tf32.py). It
// computes what flash_fwd_simt<float> computes: q scaled by d^-1/2 in f32,
// scores, running max, row sums and the accumulator in f32, the same hash.
//   q is split into TF32 hi and lo once, as the A fragments of q k^T. K, V
//   and the bias arrive by cp.async in a ring of two key tiles; the thread
//   that copied a chunk splits it once it has landed, hi in place and lo
//   beside it, so that no warp splits a tile again. The bias is the c
//   operand of the first pass. The row max is reduced across a row's 4
//   lanes with shuffles; exp is ex2.approx on one FMA, as in the bf16 body.
//   p v is summed from zero a tile and added to acc with one f32 FMA.
// Where the 32-bit fragments differ from the bf16 ones:
//   - ldmatrix moves 16-bit elements, so both B operands are read with
//     32-bit shared loads: K's fragment (key g, dims t and t + 4) from rows
//     of d + 4 floats, V's (keys 2t and 2t + 1, dim g) from the same.
//   - The C fragment of s (a lane holds keys 2t and 2t + 1) is not the A
//     fragment of p v (k indices t and t + 4). p stays in registers by
//     permuting the keys of p v: k index t is key 2t, t + 4 is key 2t + 1,
//     and V's rows are read in that order. The hash is taken on s's C
//     fragment, before the permutation, so k_abs is always the true key.
//   - Shared memory and the q fragments are twice the bf16 body's (f32, hi
//     and lo): the ring is dynamic shared memory, 2 tiles deep.
// On long rows flash_fwd_wgmma_tf32 (below) takes over at every head size.
// Two blocks an SM: without that minimum ptxas held two of the stage
// instances (LVL 0 and 3) to 128 and 168 registers, and they spilled.
template <int D, int LVL, int DROP, bool RAGGED>
__global__ void __launch_bounds__(32 * kTf32Warps, 2)
flash_fwd_tf32(const LunarisK2FwdArgs a) {
  static_assert(D % 16 == 0, "whole 16-row tiles of q and 8-wide d tiles");
  constexpr int W = kTf32Warps;
  constexpr int MT = tf32_tiles(D);
  constexpr int BK = tf32_block_k(D);
  constexpr int THREADS = 32 * W;
  constexpr int ST = kTf32Stages;
  constexpr int LD = D + 4;
  constexpr int KD = D / 8;        // k-steps of q k^T; d tiles of p v
  constexpr int NT = BK / 8;       // 8-key score tiles; k-steps of p v
  constexpr int SF = tf32_stage_floats(D);
  constexpr int M = BK * LD;       // one matrix of a stage
  extern __shared__ __align__(16) float tf32_smem[];  // [ST][kh, kl, vh, vl, bias]

  const int Nq = a.Nq, Nk = a.Nk;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int bh = blockIdx.y;
  const int row0 = (blockIdx.x * W + (tid >> 5)) * 16 * MT + g;
  const float* kb = static_cast<const float*>(a.k) + static_cast<long long>(bh) * Nk * D;
  const float* vb = static_cast<const float*>(a.v) + static_cast<long long>(bh) * Nk * D;
  const float* biasb = a.bias + static_cast<long long>(bh % a.H) * Nk;
  const bool drop = DROP == kDropOn || (DROP == kDropRuntime && a.use_dropout);
  const int tiles = (Nk + BK - 1) / BK;

  auto load_tile = [&](int tile) {
    float* s = tf32_smem + (tile % ST) * SF;
    const int k0 = tile * BK;
    for (int c = tid; c < BK * (D / 4); c += THREADS) {
      const int r = c / (D / 4);
      const int d0 = (c % (D / 4)) * 4;
      const bool in = !RAGGED || k0 + r < Nk;
      const long long off = static_cast<long long>(in ? k0 + r : 0) * D + d0;
      cp_async_16(s + r * LD + d0, kb + off, in ? 16 : 0);
      cp_async_16(s + 2 * M + r * LD + d0, vb + off, in ? 16 : 0);
    }
    if (LVL >= 1)
      for (int c = tid; c < BK; c += THREADS) {
        const bool in = !RAGGED || k0 + c < Nk;
        cp_async_4(s + 4 * M + c, biasb + (in ? k0 + c : 0), in ? 4 : 0);
      }
  };
  // What this thread copied of a tile, once it has landed: K and V split
  // into TF32 hi (in place) and lo (the next matrix).
  auto split_tile = [&](int tile) {
    float* s = tf32_smem + (tile % ST) * SF;
    for (int c = tid; c < BK * (D / 4); c += THREADS) {
      const int o = (c / (D / 4)) * LD + (c % (D / 4)) * 4;
#pragma unroll
      for (int x = 0; x < 2; ++x) {  // K, V
        float4* hi = reinterpret_cast<float4*>(s + 2 * x * M + o);
        float4 h, l;
        split_tf32(*hi, h, l);
        *hi = h;
        *reinterpret_cast<float4*>(s + (2 * x + 1) * M + o) = l;
      }
    }
  };

#pragma unroll
  for (int i = 0; i < ST - 1; ++i) {
    if (i < tiles) load_tile(i);
    cp_async_commit();
  }

  // q as the A fragments of q k^T: scaled in f32 and split once.
  uint32_t qh[MT][KD][4], ql[MT][KD][4];
  {
    const float* qb = static_cast<const float*>(a.q) + static_cast<long long>(bh) * Nq * D;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int kd = 0; kd < KD; ++kd)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = row0 + 16 * mt + (i & 1) * 8;
          const int col = 8 * kd + t + (i >> 1) * 4;
          const float x = row < Nq ? qb[static_cast<long long>(row) * D + col] * a.scale
                                   : 0.f;
          split_tf32(x, qh[mt][kd][i], ql[mt][kd][i]);
        }
  }

  float acc[MT][KD][4];
  float m[MT][2], l[MT][2];        // rows g and g + 8; l is this lane's share
  uint32_t q_term[MT][2];
  const uint32_t row_seed =
      a.seed ^ (static_cast<uint32_t>(bh + a.row_offset) * kC1);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int n = 0; n < KD; ++n)
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

  for (int tile = 0; tile < tiles; ++tile) {
    cp_async_wait<ST - 2>();       // this thread's copies of the tile landed
    split_tile(tile);
    __syncthreads();               // the tile is whole; the one before is read
    if (tile + ST - 1 < tiles) load_tile(tile + ST - 1);
    cp_async_commit();
    const float* kh = tf32_smem + (tile % ST) * SF;
    const float* vh = kh + 2 * M;
    const float* bs = kh + 4 * M;
    const int k0 = tile * BK;

    // s = q k^T (+ bias): the bias is the c operand of the first pass. K's
    // B fragment: key 8 n + g, dims 8 kd + t and + 4.
    float s[MT][NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      float2 b = make_float2(0.f, 0.f);
      if (LVL >= 1) b = *reinterpret_cast<const float2*>(bs + 8 * n + 2 * t);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        s[mt][n][0] = s[mt][n][2] = b.x;
        s[mt][n][1] = s[mt][n][3] = b.y;
      }
#pragma unroll
      for (int kd = 0; kd < KD; ++kd) {
        const float* kr = kh + (8 * n + g) * LD + 8 * kd + t;
        const uint32_t bh0 = __float_as_uint(kr[0]), bh1 = __float_as_uint(kr[4]);
        const uint32_t bl0 = __float_as_uint(kr[M]), bl1 = __float_as_uint(kr[M + 4]);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          mma_tf32x3(s[mt][n], qh[mt][kd], ql[mt][kd], bh0, bh1, bl0, bl1);
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

    // pv = p v, summed from zero a tile, and acc = acc corr + pv. Score tile
    // n is k-step n: its C fragment {(g, 2t), (g, 2t+1), (g+8, 2t),
    // (g+8, 2t+1)} is the A fragment {a0, a2, a1, a3} with k index t as key
    // 2t and t + 4 as key 2t + 1; V's B fragment takes rows 2t and 2t + 1.
    float pv[MT][KD][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      uint32_t ph[MT][4], pl[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        split_tf32(s[mt][n][0], ph[mt][0], pl[mt][0]);
        split_tf32(s[mt][n][2], ph[mt][1], pl[mt][1]);
        split_tf32(s[mt][n][1], ph[mt][2], pl[mt][2]);
        split_tf32(s[mt][n][3], ph[mt][3], pl[mt][3]);
      }
#pragma unroll
      for (int dd = 0; dd < KD; ++dd) {
        const float* vr = vh + (8 * n + 2 * t) * LD + 8 * dd + g;
        const uint32_t bh0 = __float_as_uint(vr[0]), bh1 = __float_as_uint(vr[LD]);
        const uint32_t bl0 = __float_as_uint(vr[M]), bl1 = __float_as_uint(vr[M + LD]);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          if (n == 0)
#pragma unroll
            for (int i = 0; i < 4; ++i) pv[mt][dd][i] = 0.f;
          mma_tf32x3(pv[mt][dd], ph[mt], pl[mt], bh0, bh1, bl0, bl1);
        }
      }
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < KD; ++n)
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
        float* orow = static_cast<float*>(a.o) + (static_cast<long long>(bh) * Nq + row) * D;
#pragma unroll
        for (int n = 0; n < KD; ++n)
          *reinterpret_cast<float2*>(orow + 8 * n + 2 * t) = make_float2(
              acc[mt][n][2 * r] / lr, acc[mt][n][2 * r + 1] / lr);
        if (t == 0)
          a.lse[static_cast<long long>(bh) * Nq + row] = m[mt][r] + logf(lr);
      }
    }
}

template <int D, int LVL, int DROP, bool RAGGED>
int launch_tf32(const LunarisK2FwdArgs& a, cudaStream_t stream) {
  // cp.async moves 16 bytes of k and v; q and o move 8 at a time.
  if ((!RAGGED && a.Nk % tf32_block_k(D) != 0) ||
      reinterpret_cast<uintptr_t>(a.k) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(a.v) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(a.q) % 8 != 0 ||
      reinterpret_cast<uintptr_t>(a.o) % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = flash_fwd_tf32<D, LVL, DROP, RAGGED>;
  constexpr int smem = tf32_smem_bytes(D);
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.Nq + tf32_rows(D) - 1) / tf32_rows(D), a.BH);
  kernel<<<grid, 32 * kTf32Warps, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// ---- the warpgroup body: wgmma fed by TMA -----------------------------------

// flash_fwd_wgmma  bf16 at D 48 and 64, the recipes' head sizes (feature_dim
//   384 and 512 at 8 heads). flash_fwd_mma was sized for d 16: at d 48 and 64
//   its four warps own one 16-row tile each, so every K and V fragment is
//   read from shared memory again for each 16 rows, and its static ring fits
//   only 2 stages at d 64. Here:
//   - A block is two consumer warpgroups of 64 query rows each (128 rows)
//     and one producer warp. The producer keeps a ring of 3 key tiles of 128
//     in dynamic shared memory: K and V arrive by TMA (one box each, rows of
//     128 bytes with the 128-byte swizzle; columns past d and keys past Nk
//     arrive as zeros), the bias by its 32 lanes, -inf past Nk, so a key past
//     the end scores -inf and no score is masked. `full` barriers carry the
//     tile to the consumers, `empty` barriers carry it back.
//   - s = qs k^T is wgmma m64n128k16 with q's A fragments in registers
//     (scaled and rounded once, as flash_fwd_mma) and K from shared memory
//     (K-major); the accumulator starts at the keys' bias.
//   - The online softmax runs on the accumulator in registers (the row max
//     across a row's 4 lanes with shuffles, exp as ex2.approx on one FMA),
//     the hash from each element's own (key, query), then p is packed to
//     bf16 in registers: the accumulator's layout is the A fragment's, so
//     o += p v is wgmma m64n{d}k16 with p from registers and V from shared
//     memory (MN-major). o is rescaled by the row's correction before the
//     product adds to it.
//   Dropout is a template parameter; a ragged Nk costs nothing per score
//   (the bias masks it), so one instance takes every Nk.
// Rounding points are flash_fwd_mma's, except that p v adds into o on the
// tensor cores instead of being summed from zero a tile and added with one
// f32 FMA: o's sums truncate over the whole walk, which moves a bf16 output
// by far less than its last bit.

constexpr int kWgBK = 128;                          // keys a tile
constexpr int kWgConsumers = 2;                     // warpgroups of 64 rows
constexpr int kWgRows = 64 * kWgConsumers;          // query rows a block
constexpr int kWgThreads = 128 * (kWgConsumers + 1); // and a producer warpgroup
constexpr int kWgStages = 3;
constexpr int kWgTileBytes = kWgBK * 128;           // one K or V tile

// The ring ([stage][K, V] tiles, then [stage][keys] f32 bias), the
// barriers, and 1024 bytes to align the tiles to the swizzle's period.
__host__ __device__ constexpr int wg_fwd_smem_bytes() {
  return 1024 + kWgStages * (2 * kWgTileBytes + kWgBK * 4) + 2 * kWgStages * 8;
}

struct K2FwdMaps {
  CUtensorMap k, v;
};

// The consumer warpgroups of flash_fwd_wgmma.
template <int D, int DROP>
__device__ __forceinline__ void consume_fwd_wgmma(
    const LunarisK2FwdArgs& a, const uint8_t* ring, const float* bias_ring,
    uint64_t* full, uint64_t* empty, int tiles) {
  using bf16 = __nv_bfloat16;
  constexpr int BK = kWgBK;
  constexpr int ST = kWgStages;
  constexpr int KD = D / 16;       // k-steps of q k^T
  constexpr int NJ = BK / 8;       // 8-key column chunks of s
  const int Nq = a.Nq;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bh = blockIdx.y;
  const int g = lane >> 2;         // the fragment's row (and row + 8)
  const int t = lane & 3;          // the fragment's column pair
  const int row0 = blockIdx.x * kWgRows + (warp >> 2) * 64 + (warp & 3) * 16 + g;
  const bool drop = DROP == kDropOn;

  // q as the A fragments of q k^T, scaled and rounded once.
  uint32_t qf[KD][4];
  {
    const bf16* qb = static_cast<const bf16*>(a.q) + static_cast<long long>(bh) * Nq * D;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = row0 + (i & 1) * 8;
        const int col = kd * 16 + (i >> 1) * 8 + 2 * t;
        uint32_t x = 0u;
        if (row < Nq)
          x = *reinterpret_cast<const uint32_t*>(qb + static_cast<long long>(row) * D + col);
        qf[kd][i] = scale_bf16x2(x, a.scale);
      }
  }

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {-1e30f, -1e30f}, l[2] = {0.f, 0.f};  // l: this lane's share
  const uint32_t row_seed = a.seed ^ (static_cast<uint32_t>(bh + a.row_offset) * kC1);
  const uint32_t q_term[2] = {
      row_seed + static_cast<uint32_t>(a.q_offset + row0) * kC3,
      row_seed + static_cast<uint32_t>(a.q_offset + row0 + 8) * kC3};

  // s = q k^T + bias of a key tile, issued once the tile has landed: the
  // bias is the accumulator's start.
  float s[BK / 2];
  auto scores = [&](int tile) {
    const int st = tile % ST;
    const uint8_t* kt = ring + st * 2 * kWgTileBytes;
    const float* bt = bias_ring + st * BK;
    mbar_wait(&full[st], (tile / ST) & 1);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float2 b = *reinterpret_cast<const float2*>(bt + 8 * j + 2 * t);
      s[4 * j] = s[4 * j + 2] = b.x;
      s[4 * j + 1] = s[4 * j + 3] = b.y;
    }
    wgmma_fence();
#pragma unroll
    for (int kd = 0; kd < KD; ++kd)
      wgmma_rs<BK, 0>(s, qf[kd], wgmma_desc(kt + 32 * kd), 1);
  };
  scores(0);
  wgmma_commit();
  wgmma_wait<0>();
  wgmma_pin(s);

  for (int tile = 0; tile < tiles; ++tile) {
    const int st = tile % ST;
    const int k0 = tile * BK;
    const uint8_t* kt = ring + st * 2 * kWgTileBytes;

    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s[4 * j], s[4 * j + 1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      corr[r] = ex2((m[r] - mx[r]) * kLog2e);
      m[r] = mx[r];
      l[r] *= corr[r];
    }
    const float neg[2] = {-mx[0] * kLog2e, -mx[1] * kLog2e};
    const uint32_t k_term = static_cast<uint32_t>(k0 + 2 * t) * kC2;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float p = ex2(fmaf(s[4 * j + i], kLog2e, neg[i >> 1]));
        l[i >> 1] += p;
        if (drop) {
          const bool keep = keep_hash(
              q_term[i >> 1] + k_term + static_cast<uint32_t>(8 * j + (i & 1)) * kC2,
              a.threshold);
          p = keep ? p * a.inv_keep : 0.f;
        }
        s[4 * j + i] = p;
      }

    // o = o corr + round_bf16(p) v: p's 8-key chunks 2 kk and 2 kk + 1 are
    // the A fragment of k-step kk.
    uint32_t pf[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pf[kk][i] = pack_bf16(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[4 * j] *= corr[0];
      o[4 * j + 1] *= corr[0];
      o[4 * j + 2] *= corr[1];
      o[4 * j + 3] *= corr[1];
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_rs<D, 1>(o, pf[kk], wgmma_desc(kt + kWgTileBytes + 2048 * kk), 1);
    // The next tile's scores right behind p v, under one wait: the tensor
    // cores take both back to back while this warpgroup waits once a tile.
    if (tile + 1 < tiles) scores(tile + 1);
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_pin(o);
    wgmma_pin(s);
    mbar_arrive(&empty[st]);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lr = l[r];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    lr = fmaxf(lr, 1e-30f);
    const int row = row0 + 8 * r;
    if (row < Nq) {
      bf16* orow = static_cast<bf16*>(a.o) + (static_cast<long long>(bh) * Nq + row) * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(orow + 8 * j + 2 * t) =
            pack_bf16(o[4 * j + 2 * r] / lr, o[4 * j + 2 * r + 1] / lr);
      if (t == 0) a.lse[static_cast<long long>(bh) * Nq + row] = m[r] + logf(lr);
    }
  }
}

template <int D, int DROP>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_fwd_wgmma(const LunarisK2FwdArgs a, const __grid_constant__ K2FwdMaps maps) {
  static_assert(D == 48 || D == 64, "the warpgroup body takes d 48 and 64");
  constexpr int BK = kWgBK;
  constexpr int ST = kWgStages;
  extern __shared__ uint8_t fwd_wg_smem[];
  uint8_t* ring = fwd_wg_smem + ((1024 - (smem_addr(fwd_wg_smem) & 1023)) & 1023);
  float* bias_ring = reinterpret_cast<float*>(ring + ST * 2 * kWgTileBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(bias_ring + ST * BK);
  uint64_t* empty = full + ST;

  const int Nk = a.Nk;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.y;
  const int tiles = (Nk + BK - 1) / BK;

  if (tid == 0) {
    for (int i = 0; i < ST; ++i) {
      mbar_init(&full[i], 32);
      mbar_init(&empty[i], 128 * kWgConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 4 * kWgConsumers) {
    // The producer warpgroup: one warp loads, the registers go to the
    // consumers (2 x 128 x 232 + 128 x 40 = the block's 384 x 168).
    setmaxnreg_dec<40>();
    if (warp != 4 * kWgConsumers) return;
    const float* biasb = a.bias + static_cast<long long>(bh % a.H) * Nk;
    for (int tile = 0; tile < tiles; ++tile) {
      const int st = tile % ST;
      const int k0 = tile * BK;
      if (tile >= ST) mbar_wait(&empty[st], ((tile / ST) & 1) ^ 1);
      for (int c = lane; c < BK; c += 32)
        bias_ring[st * BK + c] = k0 + c < Nk ? biasb[k0 + c] : -INFINITY;
      if (lane == 0) {
        uint8_t* kt = ring + st * 2 * kWgTileBytes;
        mbar_arrive_tx(&full[st], 2 * kWgTileBytes);
        tma_load_3d(kt, &maps.k, &full[st], 0, k0, bh);
        tma_load_3d(kt + kWgTileBytes, &maps.v, &full[st], 0, k0, bh);
      } else {
        mbar_arrive(&full[st]);
      }
    }
  } else {
    setmaxnreg_inc<232>();
    consume_fwd_wgmma<D, DROP>(a, ring, bias_ring, full, empty, tiles);
  }
}

template <int D, int DROP>
int launch_wgmma(const LunarisK2FwdArgs& a, cudaStream_t stream) {
  // TMA reads k and v from 16-byte aligned rows; q and o move 4 bytes.
  if (reinterpret_cast<uintptr_t>(a.k) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(a.v) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(a.q) % 4 != 0 ||
      reinterpret_cast<uintptr_t>(a.o) % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  K2FwdMaps maps;
  if (!bf16_tile_map(&maps.k, a.k, a.BH, a.Nk, D, kWgBK) ||
      !bf16_tile_map(&maps.v, a.v, a.BH, a.Nk, D, kWgBK))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = flash_fwd_wgmma<D, DROP>;
  constexpr int smem = wg_fwd_smem_bytes();
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.Nq + kWgRows - 1) / kWgRows, a.BH);
  kernel<<<grid, kWgThreads, smem, stream>>>(a, maps);
  return static_cast<int>(cudaGetLastError());
}

// ---- the narrow warpgroup body: d 16 and 32 ---------------------------------

// flash_fwd_wgmma_narrow  bf16 at D 16, the default width (feature_dim 128 at
//   8 heads), and D 32 (feature_dim 256: the docs' low-end recipe). At
//   d 16 the products are cheap (4 N^2 d operations: 1.1 ms at
//   B8 H8 N16384) and the work per score binds: one ex2 on the special-
//   function units (16 a clock an SM: 4.1 ms there), its FMA, the max, the
//   row sum, the pack and, with dropout, the hash. flash_fwd_mma runs that
//   work in series with its mma.sync products; flash_fwd_wgmma's layout
//   ([rows][64], 128-byte swizzle) would multiply zeros in three of q k^T's
//   four k-steps at d 16. Here:
//   - Tiles of [rows][16] with the 32-byte swizzle (hopper.cuh): K and V of a
//     key tile are 4 KB each. A block is three consumer warpgroups of 64
//     query rows and one producer warp that keeps a ring of 4 key tiles of
//     128 in flight (K and V by TMA, zeros past Nk) and writes each tile's
//     bias.
//   - The bias is a k-step of its own: the producer writes it split into
//     three bf16 parts b1 + b2 + b3 (exactly the f32 bias; -inf past Nk) in
//     columns 0-2 of a [keys][16] tile, and s = [1 1 1 0 ..] [b1 b2 b3 0 ..]^T
//     + qs k^T is one wgmma m64n128k16 from zero (scale_d 0) and one more
//     with q's A fragment in registers: no instruction a score sets the
//     accumulator to the bias, and a key past Nk scores -inf.
//   - Each consumer warpgroup overlaps its products with its per-score work
//     (FlashAttention-3's intra-warpgroup order): tile j's q k^T and tile
//     j - 1's p v (wgmma m64n16k16 with p from registers, V MN-major, summed
//     from zero) go out together; tile j's softmax runs as soon as its
//     scores land, under tile j - 1's p v; then o = o corr + p v is one f32
//     FMA an element in registers. Three consumer warpgroups (160 registers
//     each) share the special-function units and the tensor cores and meet
//     only at the ring.
//   - The softmax is flash_fwd_wgmma's: the row max across a row's 4 lanes
//     with shuffles, exp as ex2.approx on one FMA, the row sum of the
//     undropped p, the hash from each element's own (key, query) with the
//     key's term stepped by a constant, p dropped, rescaled and packed to
//     bf16 in registers as p v's A fragment.
//   Dropout is a template parameter; one instance takes every Nk.
//   At D 32 K and V are [rows][32] tiles with the 64-byte swizzle and key
//   tiles are 64 (4 KB each; nw_block_k); the bias tile stays [keys][16]
//   with the 32-byte one, so the bias k-step reads it through a descriptor
//   of its own. q k^T is the bias k-step and two of q's (the second 32
//   bytes on within K's row), p v a wgmma m64n32k16 a k-step, and o, pv
//   and q's fragments take 20 registers more a thread than at D 16.
// Rounding points are flash_fwd_mma's: p v is summed from zero a key tile
// (of 128 here) and added to o with one rounded f32 FMA; the scores' bias
// is added in the tensor core's f32 sum ahead of q k^T, as
// flash_fwd_wgmma's accumulator starts at it.
// Measured on an H100 (PERF.md section 6): 6.1 instructions and 1.03 ex2 a
// 32 scores without dropout, about 9.3 scores a clock an SM, 60 % of the
// ex2 rate a microbenchmark reaches; with dropout the hash makes it 13.2
// instructions a 32 scores and issue-bound. At d 32: 7.4 and 14.8
// instructions a 32 scores (flash_fwd_mma<32>, which tests dropout at run
// time, 29.5), 30 % of the tensor cores' bound and 56 % of the
// special-function floor at B16 H8 N16384 without dropout.

constexpr int kNwStages = 4;

constexpr int kNwConsumers = 3;                     // warpgroups of 64 rows
constexpr int kNwRows = 64 * kNwConsumers;          // query rows a block
constexpr int kNwThreads = 128 * (kNwConsumers + 1);

// Keys a tile at head size d. Timed in turns on an H100 (PERF.md section
// 6) at d 32, B8 H8 N16384: tiles of 64 took 7.30 ms at dropout 0 against
// 8.14 with tiles of 128 (and 8.58 with two consumer warpgroups at 232
// registers); at dropout 0.1 the three were within 2 % (11.78, 11.79,
// 11.56).
__host__ __device__ constexpr int nw_block_k(int d) { return d == 32 ? 64 : 128; }

// A stage: K and V as [BK][D] tiles, then the bias as a [BK][16] tile.
__host__ __device__ constexpr int nw_tile_bytes(int d, int bk) { return bk * 2 * d; }
__host__ __device__ constexpr int nw_stage_bytes(int d, int bk) {
  return 2 * nw_tile_bytes(d, bk) + bk * 32;
}
__host__ __device__ constexpr int nw_fwd_smem_bytes(int d, int bk) {
  return 1024 + kNwStages * nw_stage_bytes(d, bk) + 2 * kNwStages * 8;
}

// The consumer warpgroups of flash_fwd_wgmma_narrow. Every wgmma that a
// tile issues is done before the next tile starts, and no instruction
// touches the registers of a wgmma in flight (its accumulator or its A
// fragment): ptxas serialises every wgmma of a body that breaks either
// (C7514, C7515) and then nothing runs under the products.
template <int D, int DROP>
__device__ __forceinline__ void consume_fwd_narrow(
    const LunarisK2FwdArgs& a, const uint8_t* ring, uint64_t* full,
    uint64_t* empty, int tiles) {
  using bf16 = __nv_bfloat16;
  constexpr int BK = nw_block_k(D);
  constexpr int ST = kNwStages;
  constexpr int NJ = BK / 8;       // 8-key column chunks of s
  constexpr int KS = D / 16;       // q's k-steps
  constexpr uint32_t HI = kNarrowDescHi<D>;        // K and V
  constexpr uint32_t HI_BIAS = kNarrowDescHi<16>;  // the bias tile
  constexpr int TILE = nw_tile_bytes(D, BK);
  const int Nq = a.Nq;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bh = blockIdx.y;
  const int g = lane >> 2;         // the fragment's row (and row + 8)
  const int t = lane & 3;          // the fragment's column pair
  const int row0 = blockIdx.x * kNwRows + (warp >> 2) * 64 + (warp & 3) * 16 + g;
  const bool drop = DROP == kDropOn;
  const uint32_t ring_lo = desc_lo(ring);

  // q as the A fragments of q k^T (k-step kk: columns 16 kk ..), scaled
  // and rounded once.
  uint32_t qf[KS][4], ones[4];
  {
    const bf16* qb = static_cast<const bf16*>(a.q) + static_cast<long long>(bh) * Nq * D;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = row0 + (i & 1) * 8;
        const int col = 16 * kk + (i >> 1) * 8 + 2 * t;
        uint32_t x = 0u;
        if (row < Nq)
          x = *reinterpret_cast<const uint32_t*>(qb + static_cast<long long>(row) * D + col);
        qf[kk][i] = scale_bf16x2(x, a.scale);
      }
  }
  ones3_fragment(ones, t);

  float o[D / 2];                  // the tiles done, in registers
  float pv[D / 2];                 // one tile's p v (wgmma, from zero)
  float s[BK / 2];                 // one tile's scores, then its p in place
  uint32_t pf[BK / 16][4];         // p as p v's A fragments (k-step kk:
                                   // 8-key chunks 2 kk and 2 kk + 1)
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {-1e30f, -1e30f}, l[2] = {0.f, 0.f};  // l: this lane's share
  float corr[2] = {1.f, 1.f};      // exp(m before - m after) of the last tile
  const uint32_t row_seed = a.seed ^ (static_cast<uint32_t>(bh + a.row_offset) * kC1);
  const uint32_t q_term[2] = {
      row_seed + static_cast<uint32_t>(a.q_offset + row0) * kC3,
      row_seed + static_cast<uint32_t>(a.q_offset + row0 + 8) * kC3};
  const uint32_t stage_lo = nw_stage_bytes(D, BK) >> 4;

  // s = bias + qs k^T of tile j: the bias k-step from zero, then q's (the
  // k-step kk 32 kk bytes on within K's row).
  auto issue_scores = [&](int j) {
    const int st = j % ST;
    const uint32_t kt = ring_lo + st * stage_lo;
    mbar_wait(&full[st], (j / ST) & 1);
    wgmma_fence();
    wgmma_rs<BK, 0>(s, ones, desc_of(kt + (2 * TILE >> 4), HI_BIAS), 0);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      wgmma_rs<BK, 0>(s, qf[kk], desc_of(kt + 2 * kk, HI), 1);
    wgmma_commit();
  };
  // pv = round_bf16(p) v of tile j, from zero.
  auto issue_pv = [&](int j) {
    const uint32_t vt = ring_lo + (j % ST) * stage_lo + (TILE >> 4);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_rs<D, 1>(pv, pf[kk], desc_of(vt + kk * (16 * 2 * D >> 4), HI),
                     kk > 0);
    wgmma_commit();
  };
  // The online softmax of tile j on s, in place: s becomes p (dropped and
  // rescaled); l and m move on, corr is this tile's correction.
  auto softmax = [&](int j) {
    // The row max as four chains a row, not one of 32.
    float mq[2][4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      mq[0][c] = fmaxf(s[4 * c], s[4 * c + 1]);
      mq[1][c] = fmaxf(s[4 * c + 2], s[4 * c + 3]);
    }
#pragma unroll
    for (int c = 4; c < NJ; ++c) {
      mq[0][c & 3] = fmaxf(mq[0][c & 3], fmaxf(s[4 * c], s[4 * c + 1]));
      mq[1][c & 3] = fmaxf(mq[1][c & 3], fmaxf(s[4 * c + 2], s[4 * c + 3]));
    }
    float mx[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(fmaxf(m[r], fmaxf(mq[r][0], mq[r][1])),
                    fmaxf(mq[r][2], mq[r][3]));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      corr[r] = ex2((m[r] - mx[r]) * kLog2e);
      m[r] = mx[r];
      l[r] *= corr[r];
    }
    const float neg[2] = {-mx[0] * kLog2e, -mx[1] * kLog2e};
    // The hash of (row r, key k0 + 8 c + 2 t + e) is base[r] + (8 c + e) C2:
    // the key's term stepped by a constant.
    const uint32_t k_term = static_cast<uint32_t>(j * BK + 2 * t) * kC2;
    const uint32_t base[2] = {q_term[0] + k_term, q_term[1] + k_term};
    float lq[2][2] = {{0.f, 0.f}, {0.f, 0.f}};      // the tile's sums, 2 chains a row
#pragma unroll
    for (int c = 0; c < NJ; ++c)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float p = ex2(fmaf(s[4 * c + i], kLog2e, neg[i >> 1]));
        lq[i >> 1][c & 1] += p;
        if (drop) {
          const bool keep = keep_hash(
              base[i >> 1] + static_cast<uint32_t>(8 * c + (i & 1)) * kC2,
              a.threshold);
          p *= keep ? a.inv_keep : 0.f;
        }
        s[4 * c + i] = p;
      }
    l[0] += lq[0][0] + lq[0][1];
    l[1] += lq[1][0] + lq[1][1];
  };
  auto pack_p = [&]() {
#pragma unroll
    for (int c = 0; c < NJ; ++c) {
      pf[c >> 1][2 * (c & 1)] = pack_bf16(s[4 * c], s[4 * c + 1]);
      pf[c >> 1][2 * (c & 1) + 1] = pack_bf16(s[4 * c + 2], s[4 * c + 3]);
    }
  };
  // o = o corr + pv: the tile before's p v, at its own correction.
  auto add_pv = [&](const float (&c)[2]) {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = fmaf(o[i], c[(i >> 1) & 1], pv[i]);
  };

  // Tile j: its scores, then tile j - 1's p v, which runs under tile j's
  // softmax; tile j's p v goes out with tile j + 1's scores.
  issue_scores(0);
  wgmma_wait<0>();
  wgmma_pin(s);
  softmax(0);
  pack_p();
  for (int j = 1; j < tiles; ++j) {
    const float corr_last[2] = {corr[0], corr[1]};
    issue_scores(j);
    issue_pv(j - 1);
    wgmma_wait<1>();
    wgmma_pin(s);
    softmax(j);
    wgmma_wait<0>();
    wgmma_pin(pv);
    wgmma_pin(pf);
    mbar_arrive(&empty[(j - 1) % ST]);
    add_pv(corr_last);
    pack_p();
  }
  issue_pv(tiles - 1);
  wgmma_wait<0>();
  wgmma_pin(pv);
  wgmma_pin(pf);
  add_pv(corr);

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lr = l[r];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    lr = fmaxf(lr, 1e-30f);
    const int row = row0 + 8 * r;
    if (row < Nq) {
      bf16* orow = static_cast<bf16*>(a.o) + (static_cast<long long>(bh) * Nq + row) * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(orow + 8 * j + 2 * t) =
            pack_bf16(o[4 * j + 2 * r] / lr, o[4 * j + 2 * r + 1] / lr);
      if (t == 0) a.lse[static_cast<long long>(bh) * Nq + row] = m[r] + logf(lr);
    }
  }
}

template <int D, int DROP>
__global__ void __launch_bounds__(kNwThreads, 1)
flash_fwd_wgmma_narrow(const LunarisK2FwdArgs a,
                       const __grid_constant__ K2FwdMaps maps) {
  static_assert(D == 16 || D == 32, "the narrow warpgroup body takes d 16 and 32");
  constexpr int BK = nw_block_k(D);
  constexpr int ST = kNwStages;
  constexpr int TILE = nw_tile_bytes(D, BK);
  constexpr int STAGE = nw_stage_bytes(D, BK);
  extern __shared__ uint8_t fwd_nw_smem[];
  uint8_t* ring = fwd_nw_smem + ((1024 - (smem_addr(fwd_nw_smem) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + ST * STAGE);
  uint64_t* empty = full + ST;

  const int Nk = a.Nk;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.y;
  const int tiles = (Nk + BK - 1) / BK;

  if (tid == 0) {
    for (int i = 0; i < ST; ++i) {
      mbar_init(&full[i], 32);
      mbar_init(&empty[i], 128 * kNwConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 4 * kNwConsumers) {
    // The producer warpgroup: one warp loads, the registers go to the
    // consumers (3 x 128 x 160 + 128 x 32 = the block's 512 x 128).
    setmaxnreg_dec<32>();
    if (warp != 4 * kNwConsumers) return;
    const float* biasb = a.bias + static_cast<long long>(bh % a.H) * Nk;
    for (int tile = 0; tile < tiles; ++tile) {
      const int st = tile % ST;
      const int k0 = tile * BK;
      uint8_t* kt = ring + st * STAGE;
      if (tile >= ST) mbar_wait(&empty[st], ((tile / ST) & 1) ^ 1);
      if (lane == 0) {
        mbar_expect_tx(&full[st], 2 * TILE);
        tma_load_3d(kt, &maps.k, &full[st], 0, k0, bh);
        tma_load_3d(kt + TILE, &maps.v, &full[st], 0, k0, bh);
      }
      uint8_t* bt = kt + 2 * TILE;
      for (int c = lane; c < BK; c += 32)
        write_bias_row(bt, c, k0 + c < Nk ? biasb[k0 + c] : -INFINITY);
      fence_async_shared();        // the bias, for the consumers' wgmma
      mbar_arrive(&full[st]);
    }
  } else {
    setmaxnreg_inc<160>();
    consume_fwd_narrow<D, DROP>(a, ring, full, empty, tiles);
  }
}

template <int D, int DROP>
int launch_wgmma_narrow(const LunarisK2FwdArgs& a, cudaStream_t stream) {
  constexpr int BK = nw_block_k(D);
  // TMA reads k and v from 16-byte aligned rows; q and o move 4 bytes.
  if (reinterpret_cast<uintptr_t>(a.k) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(a.v) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(a.q) % 4 != 0 ||
      reinterpret_cast<uintptr_t>(a.o) % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  K2FwdMaps maps;
  if (!bf16_narrow_tile_map(&maps.k, a.k, a.BH, a.Nk, D, BK) ||
      !bf16_narrow_tile_map(&maps.v, a.v, a.BH, a.Nk, D, BK))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = flash_fwd_wgmma_narrow<D, DROP>;
  constexpr int smem = nw_fwd_smem_bytes(D, BK);
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.Nq + kNwRows - 1) / kNwRows, a.BH);
  kernel<<<grid, kNwThreads, smem, stream>>>(a, maps);
  return static_cast<int>(cudaGetLastError());
}

// ---- the f32 warpgroup body: d 16, 32, 48, 64, three TF32 passes on wgmma --

// flash_fwd_wgmma_tf32  f32 at D 16, the default type and width (feature_dim
//   128 at 8 heads), and at D 32, 48 and 64 (the low-end, mid-range and
//   H100-tier widths, feature_dim 256, 384 and 512), where Nq and Nk are
//   long.
//   flash_fwd_tf32 runs its three TF32 passes a product on mma.sync, which
//   issues a warp's 16 x 8 x 8 at a time and reaches a share of the tensor
//   cores' rate; here the products bound the call (three passes: 6.7 ms at
//   B8 H8 N16384 d 16, 26.7 at d 64; the ex2 4.1 ms), and wgmma is Hopper's
//   way to their full rate. tf32 wgmma reads both shared-memory operands
//   K-major and reads an f32 word by dropping its low bits, so:
//   - A pre-pass (flash_attention_tf32_split.cu) splits K and V into TF32
//     hi and lo once a call (cvt.rna, as `split_tf32`) and writes each key
//     tile of 64 as wgmma reads it: K hi and lo as [64][8] tiles, 32-byte
//     swizzle (q k^T's B, keys as n), and V^T as [2 D][32] atoms, 128-byte
//     swizzle, rows 0 .. D - 1 V hi and D .. 2 D - 1 V lo (p v's B, keys as
//     k).
//   - A block is consumer warpgroups of 64 query rows (three at D 16 and 32,
//     two at D 48 and 64) and a producer warp that keeps a ring of key tiles
//     (4 at D 16, 32 and 48, 3 at 64: 1024 D bytes a tile): each tile is one
//     bulk copy (TMA), and its lanes write the tile's bias (-inf past Nk).
//   - s = qs k^T starts at the bias in the accumulator and adds three passes
//     of wgmma m64n64k8 a k-step (q lo K hi, q hi K lo, q hi K hi), q's hi
//     and lo A fragments in registers, scaled in f32 and split once.
//   - The online softmax runs on the accumulator as flash_fwd_tf32's: the
//     row max over a row's 4 lanes, exp as ex2.approx on one FMA, the row sum
//     of the undropped p, the hash on the score's own (key, query), then p is
//     split into hi and lo in registers. A lane holds keys 2t and 2t + 1 of
//     each 8, and tf32's A fragment k indices t and t + 4: the pre-pass
//     permuted V^T's keys the same way (`perm8`), so p's C fragment is p v's
//     A fragment as it lies.
//   - p v a key tile, summed from zero (wgmma's sums truncate, so o itself
//     never sits in a product's accumulator). D 16: p hi times [V hi; V lo]
//     is one wgmma m64n32k8 (its columns 16-31 are the hi x lo pass), p lo
//     times V hi one m64n16k8; the three are added, small terms first. D 32,
//     48 and 64, whose registers hold q's fragments (D), o (D / 2), p hi and
//     lo (64) and one p v accumulator (D / 2) at 232 a thread (at D 32 at
//     160), but not three: the three passes a k-step into one m64n{D}k8
//     accumulator, small terms first. Then o = o corr + pv with one f32 FMA.
//   The warpgroups meet only at the ring: one's softmax runs while another's
//   products do. Dropout is a template parameter; one instance takes every
//   Nk (the bias masks the keys past it, their K and V are zeros).
// It computes what flash_fwd_tf32 computes (the same rounding points: q
// scaled in f32, scores, max, sums and o in f32, each product three TF32
// passes with cvt.rna splits, p v summed from zero a tile of 64 keys).

// The consumer warpgroups: three at 160 registers at D 16 and 32 (at D 32
// three beat two at 232 by 8-12 % at B8 and B16 H8 N16384 on an H100, timed
// in turns; PERF.md), two at D 48 and 64.
__host__ __device__ constexpr int fwd_t32_consumers(int d) {
  return d <= 32 ? 3 : 2;
}
__host__ __device__ constexpr int fwd_t32_rows(int d) { return 64 * fwd_t32_consumers(d); }
__host__ __device__ constexpr int fwd_t32_threads(int d) {
  return 128 * (fwd_t32_consumers(d) + 1);
}
__host__ __device__ constexpr int fwd_t32_stages(int d) { return d == 64 ? 3 : 4; }
constexpr int kFwdT32BK = kTf32Rows;                   // keys a tile

// The ring of key tiles, [stage][64] f32 bias, the barriers, and 1024 bytes
// to align the tiles to the swizzle's period.
__host__ __device__ constexpr int t32_fwd_smem_bytes(int d) {
  return 1024 + fwd_t32_stages(d) * (tf32_fwd_tile_bytes(d) + kFwdT32BK * 4) +
         2 * fwd_t32_stages(d) * 8;
}

// The consumer warpgroups of flash_fwd_wgmma_tf32. Every wgmma is done
// before its registers are touched again (ptxas serialises the wgmma of a
// body that breaks this: C7514, C7515).
template <int D, int DROP>
__device__ __forceinline__ void consume_fwd_tf32(
    const LunarisK2FwdArgs& a, const uint8_t* ring, const float* bias_ring,
    uint64_t* full, uint64_t* empty, int tiles) {
  constexpr int BK = kFwdT32BK;
  constexpr int ST = fwd_t32_stages(D);
  constexpr int TB = tf32_fwd_tile_bytes(D);
  constexpr int KD = D / 8;        // k-steps of q k^T
  constexpr int NJ = BK / 8;       // 8-key column chunks of s; k-steps of p v
  constexpr uint32_t HI32 = kNarrowDescHi<16>;   // [rows][8] f32, 32-byte swizzle
  const int Nq = a.Nq;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bh = blockIdx.y;
  const int g = lane >> 2;         // the fragment's row (and row + 8)
  const int t = lane & 3;          // the fragment's column pair
  const int row0 = blockIdx.x * fwd_t32_rows(D) + (warp >> 2) * 64 + (warp & 3) * 16 + g;
  const bool drop = DROP == kDropOn;
  const uint32_t ring_lo = desc_lo(ring);

  // q as the A fragments of q k^T (rows g, g + 8; d 8 kd + t, + 4), scaled
  // in f32 and split once.
  uint32_t qh[KD][4], ql[KD][4];
  {
    const float* qb = static_cast<const float*>(a.q) + static_cast<long long>(bh) * Nq * D;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = row0 + (i & 1) * 8;
        const float x = row < Nq ? qb[static_cast<long long>(row) * D + 8 * kd + t + (i >> 1) * 4] * a.scale
                                 : 0.f;
        split_tf32(x, qh[kd][i], ql[kd][i]);
      }
  }

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {-1e30f, -1e30f}, l[2] = {0.f, 0.f};  // l: this lane's share
  const uint32_t row_seed = a.seed ^ (static_cast<uint32_t>(bh + a.row_offset) * kC1);
  const uint32_t q_term[2] = {
      row_seed + static_cast<uint32_t>(a.q_offset + row0) * kC3,
      row_seed + static_cast<uint32_t>(a.q_offset + row0 + 8) * kC3};

  for (int tile = 0; tile < tiles; ++tile) {
    const int st = tile % ST;
    const uint32_t kt = ring_lo + st * (TB >> 4);
    const float* bt = bias_ring + st * BK;
    mbar_wait(&full[st], (tile / ST) & 1);

    // s = bias + qs k^T: three passes a k-step, the small terms first.
    float s[BK / 2];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float2 b = *reinterpret_cast<const float2*>(bt + 8 * j + 2 * t);
      s[4 * j] = s[4 * j + 2] = b.x;
      s[4 * j + 1] = s[4 * j + 3] = b.y;
    }
    wgmma_fence();
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      const uint64_t kh = desc_of(kt + kd * (2048 >> 4), HI32);
      const uint64_t kl = desc_of(kt + (256 * D + kd * 2048 >> 4), HI32);
      wgmma_tf32_rs_n64(s, ql[kd], kh, 1);
      wgmma_tf32_rs_n64(s, qh[kd], kl, 1);
      wgmma_tf32_rs_n64(s, qh[kd], kh, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_pin(s);

    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s[4 * j], s[4 * j + 1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      corr[r] = ex2((m[r] - mx[r]) * kLog2e);
      m[r] = mx[r];
      l[r] *= corr[r];
    }
    const float neg[2] = {-mx[0] * kLog2e, -mx[1] * kLog2e};
    const uint32_t k_term = static_cast<uint32_t>(tile * BK + 2 * t) * kC2;
    // p, dropped and split: chunk j's C fragment {(g, 2t), (g, 2t + 1),
    // (g + 8, 2t), (g + 8, 2t + 1)} is k-step j's A fragment {a0, a2, a1, a3}.
    // The tile's row sums go in two chains a row from zero, then into l
    // once: adding each p to l itself would cost lse f32's last bit.
    uint32_t ph[NJ][4], pl[NJ][4];
    float lq[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float p = ex2(fmaf(s[4 * j + i], kLog2e, neg[i >> 1]));
        lq[i >> 1][j & 1] += p;
        if (drop) {
          const bool keep = keep_hash(
              q_term[i >> 1] + k_term + static_cast<uint32_t>(8 * j + (i & 1)) * kC2,
              a.threshold);
          p = keep ? p * a.inv_keep : 0.f;
        }
        const int ai = (i & 1) * 2 + (i >> 1);
        split_tf32(p, ph[j][ai], pl[j][ai]);
      }
    l[0] += lq[0][0] + lq[0][1];
    l[1] += lq[1][0] + lq[1][1];

    const uint32_t vt = kt + (512 * D >> 4);
    if constexpr (D == 16) {
      // pv = p v from zero: p hi [V hi; V lo] (n32) and p lo V hi (n16).
      float pv2[16], pv1[8];
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const uint64_t v = desc_of(vt + ((j >> 2) * 4096 + (j & 3) * 32 >> 4), kSw128DescHi);
        wgmma_tf32_rs_n32(pv2, ph[j], v, j > 0);
        wgmma_tf32_rs_n16(pv1, pl[j], v, j > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      wgmma_pin(pv2);
      wgmma_pin(pv1);
      wgmma_pin(ph);
      wgmma_pin(pl);
      mbar_arrive(&empty[st]);
#pragma unroll
      for (int i = 0; i < D / 2; ++i)
        o[i] = fmaf(o[i], corr[(i >> 1) & 1], (pv2[8 + i] + pv1[i]) + pv2[i]);
    } else {
      // pv = p v from zero, three passes a k-step into one accumulator:
      // p lo V hi, p hi V lo, p hi V hi.
      float pv[D / 2];
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const uint32_t vh = vt + ((j >> 2) * 256 * D + (j & 3) * 32 >> 4);
        const uint64_t h = desc_of(vh, kSw128DescHi);
        const uint64_t lo = desc_of(vh + (128 * D >> 4), kSw128DescHi);
        wgmma_tf32_rs<D>(pv, pl[j], h, j > 0);
        wgmma_tf32_rs<D>(pv, ph[j], lo, 1);
        wgmma_tf32_rs<D>(pv, ph[j], h, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      wgmma_pin(pv);
      wgmma_pin(ph);
      wgmma_pin(pl);
      mbar_arrive(&empty[st]);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] = fmaf(o[i], corr[(i >> 1) & 1], pv[i]);
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lr = l[r];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    lr = fmaxf(lr, 1e-30f);
    const int row = row0 + 8 * r;
    if (row < Nq) {
      float* orow = static_cast<float*>(a.o) + (static_cast<long long>(bh) * Nq + row) * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<float2*>(orow + 8 * j + 2 * t) =
            make_float2(o[4 * j + 2 * r] / lr, o[4 * j + 2 * r + 1] / lr);
      if (t == 0) a.lse[static_cast<long long>(bh) * Nq + row] = m[r] + logf(lr);
    }
  }
}

template <int D, int DROP>
__global__ void __launch_bounds__(fwd_t32_threads(D), 1)
flash_fwd_wgmma_tf32(const LunarisK2FwdArgs a, const uint8_t* split) {
  constexpr int BK = kFwdT32BK;
  constexpr int ST = fwd_t32_stages(D);
  constexpr int TB = tf32_fwd_tile_bytes(D);
  constexpr int C = fwd_t32_consumers(D);
  extern __shared__ uint8_t fwd_t32_smem[];
  uint8_t* ring = fwd_t32_smem + ((1024 - (smem_addr(fwd_t32_smem) & 1023)) & 1023);
  float* bias_ring = reinterpret_cast<float*>(ring + ST * TB);
  uint64_t* full = reinterpret_cast<uint64_t*>(bias_ring + ST * BK);
  uint64_t* empty = full + ST;

  const int Nk = a.Nk;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.y;
  const int tiles = (Nk + BK - 1) / BK;

  if (tid == 0) {
    for (int i = 0; i < ST; ++i) {
      mbar_init(&full[i], 32);
      mbar_init(&empty[i], 128 * C);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 4 * C) {
    // The producer warpgroup: one warp loads, the registers go to the
    // consumers (three: 3 x 128 x 160 + 128 x 32 = the block's 512 x 128;
    // two: 2 x 128 x 232 + 128 x 40 <= 384 x 168).
    if constexpr (C == 3) setmaxnreg_dec<32>();
    else setmaxnreg_dec<40>();
    if (warp != 4 * C) return;
    const float* biasb = a.bias + static_cast<long long>(bh % a.H) * Nk;
    const uint8_t* src = split + static_cast<long long>(bh) * tiles * TB;
    for (int tile = 0; tile < tiles; ++tile) {
      const int st = tile % ST;
      const int k0 = tile * BK;
      if (tile >= ST) mbar_wait(&empty[st], ((tile / ST) & 1) ^ 1);
      for (int c = lane; c < BK; c += 32)
        bias_ring[st * BK + c] = k0 + c < Nk ? biasb[k0 + c] : -INFINITY;
      if (lane == 0) {
        mbar_arrive_tx(&full[st], TB);
        bulk_load(ring + st * TB, src + static_cast<long long>(tile) * TB, TB,
                  &full[st]);
      } else {
        mbar_arrive(&full[st]);
      }
    }
  } else {
    if constexpr (C == 3) setmaxnreg_inc<160>();
    else setmaxnreg_inc<232>();
    consume_fwd_tf32<D, DROP>(a, ring, bias_ring, full, empty, tiles);
  }
}

template <int D, int DROP>
int launch_wgmma_tf32(const LunarisK2FwdArgs& a, const void* split,
                      cudaStream_t stream) {
  // The tiles move 16 bytes at a time; q is read 4 bytes, o written 8.
  if (split == nullptr || reinterpret_cast<uintptr_t>(split) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(a.o) % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = flash_fwd_wgmma_tf32<D, DROP>;
  constexpr int smem = t32_fwd_smem_bytes(D);
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.Nq + fwd_t32_rows(D) - 1) / fwd_t32_rows(D), a.BH);
  kernel<<<grid, fwd_t32_threads(D), smem, stream>>>(
      a, static_cast<const uint8_t*>(split));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
