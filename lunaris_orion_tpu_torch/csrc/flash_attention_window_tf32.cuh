// K2 over closed windows in f32 -- the bodies of the flash-attention forward
// and fused backward for the windowed fold at the CLIs' default precision,
// for Hopper (sm_90a): f32 at head size 16 and 32, Nq = Nk = W, W a multiple
// of 64 and at most 256, every product in three TF32 passes on wgmma.
// Included by the flash_attention_{fwd,bwd}_window_tf32_d{16,32}{,_drop}.cu
// instances and the entry points in flash_attention_window.cu; the build
// hashes this header with the sources. The arguments, the tensor maps'
// struct and the grid are flash_attention_window.cuh's (the bf16 bodies),
// the TF32 split, `perm8` and the hash flash_attention_common.cuh's, the
// wgmma and TMA wrappers hopper.cuh's.
//
// Replaces, on the windowed fold in f32, lunaris_orion_tpu/ops/pallas/
// flash_attention.py `_fwd_kernel` and `_bwd_fused_kernel`. It computes
// what flash_fwd_wgmma_tf32 and flash_bwd_wgmma_tf32 compute, at their
// rounding points: q scaled in f32; scores, the row max and sum, lse, o and
// the gradients in f32; each product a_lo b_hi + a_hi b_lo + a_hi b_hi with
// hi = cvt.rna(x), lo = cvt.rna(x - hi), the small terms first; p v, dk, dv
// and dq summed from zero a group of 64 and added in f32 (wgmma's own sums
// truncate). The window's row in the call (plus row_offset) is the hash's
// row, as in the bf16 bodies.
//
// Bound. At B16 H8 N16384 W256 d 16 a call holds 5.4e8 scores: the three
// passes of the forward's two products take 0.21 ms at 495 TFLOP/s (the
// backward's five 0.52), its bytes 0.16, one exp a score on the
// special-function units 0.13. flash_fwd_tf32 and flash_bwd_fused_tf32,
// which these replace there (1.04 and 3.05 ms), issue a warp's m16n8k8 at a
// time; the f32 warpgroup bodies of the long rows read tiles that a
// pre-pass split and laid out, which at this element count costs about what
// the whole forward does. A window is closed and small (16 KB a tensor at
// d 16), so the split is the kernel's own, a window at a time:
//   - A persistent block (one an SM) of consumer warpgroups (two at d 16,
//     one at d 32, where a window's tiles in split form take twice the
//     bytes) and a producer warpgroup whose warps serve them: window i of a
//     block goes to consumer i % C through that consumer's own stage(s),
//     which its share of the producer's warps fills.
//   - Forward: TMA lands the window's f32 q, K and V (boxes of 256 rows,
//     zeros past W); the producer's warps split K into hi (in place) and lo,
//     and V into V^T hi and lo as [2 D][32] atoms whose keys `perm8` orders
//     (tf32 wgmma reads both operands K-major, so the transposed operand is
//     written by threads), and write the bias (-inf past W). The consumer
//     takes 64 queries a step against all 256 key slots: s = bias + qs k^T
//     as four wgmma m64n64k8 tiles in three passes a k-step (q read from the
//     landed tile, scaled and split in registers), the softmax exact in one
//     pass (no rescaling), p split in registers where its C fragment is p
//     v's A fragment, and p v a k-step of 8 keys at a time (A from
//     registers; at d 16 p hi [V hi; V lo] as one m64n32k8 and p lo V hi,
//     at d 32 three passes), from zero a group of 64 keys, the next
//     k-step's exps under the one before's products. Every wgmma covers the
//     256 key slots whatever W: a product that a run-time W switched off
//     would make ptxas serialise every wgmma of the body (C7515).
//   - Backward, one launch: the producer's warps write, for each (64-key
//     group, 64-query group) pair of a window in turn, the query group's qs
//     = q d^-1/2 and dO as rows (the B of s^T = k qs^T and dp^T = v dO^T)
//     and as qs^T and dO^T atoms, queries ordered by `perm8` (the B of dk +=
//     ds^T qs and dv += pv^T dO), each in hi and lo, with -lse log2 e and
//     delta = rowsum(o dO), into the consumer's ring. The consumer walks its
//     window's key groups (k and v read and split in registers, the A of s^T
//     and dp^T; K^T hi and lo written from them for dq = ds k), and for each
//     the query groups in sub-tiles of 32 queries at d 16, 16 at d 32 (the
//     registers of ds and pv in hi and lo; at d 16 dk, dv and dq take ds hi
//     or pv hi times [hi; lo] of their B in one m64n32k8, as p v does); ds
//     goes to a [64 queries][64 keys] tile in hi and lo, and dq's part of
//     each pair is summed in key-group order in the consumer's f32 tile of
//     shared memory, each thread its own values, and written once times
//     d^-1/2: no dq buffer in device memory, no atomics, no pre-pass; dq,
//     dk, dv and dbias are the same bits every run.
// Measured (chip_smoke.py phase 16 (a), PERF.md): the forward beats the
// mma.sync body at d 16 and at d 32 without dropout, the backward does not
// (its one warpgroup a window runs its chain of products in series), so
// the dispatch rule takes each where it was faster (`window_default`).
// Dropout is a template parameter. ptxas must not spill or serialise a
// wgmma (C7512, C7514, C7515, C7518, C7520): chip_smoke.py's build phase
// holds every instance to that.

#pragma once

#include "flash_attention_window.cuh"

// The instances, one translation unit each
// (flash_attention_{fwd,bwd}_window_tf32_d{16,32}{,_drop}.cu). Each returns
// the cudaError_t of the launch.
int lunaris_k2_fwd_window_tf32_d16(const LunarisK2WindowArgs& a, cudaStream_t s);
int lunaris_k2_fwd_window_tf32_d16_drop(const LunarisK2WindowArgs& a, cudaStream_t s);
int lunaris_k2_fwd_window_tf32_d32(const LunarisK2WindowArgs& a, cudaStream_t s);
int lunaris_k2_fwd_window_tf32_d32_drop(const LunarisK2WindowArgs& a, cudaStream_t s);
int lunaris_k2_bwd_window_tf32_d16(const LunarisK2WindowArgs& a, cudaStream_t s);
int lunaris_k2_bwd_window_tf32_d16_drop(const LunarisK2WindowArgs& a, cudaStream_t s);
int lunaris_k2_bwd_window_tf32_d32(const LunarisK2WindowArgs& a, cudaStream_t s);
int lunaris_k2_bwd_window_tf32_d32_drop(const LunarisK2WindowArgs& a, cudaStream_t s);

namespace {

// The consumer warpgroups a block (and the producer warpgroup's 128 threads
// split among them): two at d 16, one at d 32.
__host__ __device__ constexpr int t32w_consumers(int d) { return d == 16 ? 2 : 1; }
__host__ __device__ constexpr int t32w_threads(int d) {
  return 128 * (t32w_consumers(d) + 1);
}

// Window i of block b is b + i * gridDim.x; consumer c of C takes i = c,
// c + C, ..., its u-th in turn. -1 past the call's windows.
template <int C>
__device__ __forceinline__ int t32w_win_of(int c, int u, int BH) {
  const int w = blockIdx.x + (c + C * u) * gridDim.x;
  return w < BH ? w : -1;
}

// x as it is, but opaque to the compiler: a descriptor formed from it where
// a wgmma uses it is formed there, not hoisted out of the loop around it
// (the forward's 32 k-steps of V^T in hi and lo, and the backward's
// operands, would hold as many registers a loop and spill).
__device__ __forceinline__ uint32_t t32w_fresh(uint32_t x) {
  asm volatile("" : "+r"(x));
  return x;
}

// "Rows": an f32 [rows][D] tile whose row (4 D bytes) is the swizzle's span,
// as TMA lands it (`f32_row_tile_map`): the byte offset of (r, c). wgmma
// reads it K-major (a k-step of 8 is 32 bytes on within the row; 8-row
// groups 32 D bytes apart) through the high half kT32RowDescHi<D>.
template <int D>
__host__ __device__ __forceinline__ int t32_row_offset(int r, int c) {
  constexpr int span = D / 4;                   // 16-byte chunks a row
  return r * 4 * D + ((((c >> 2) ^ (r / (8 / span))) & (span - 1)) << 4) +
         (c & 3) * 4;
}
template <int D>
constexpr uint32_t kT32RowDescHi = D == 16 ? kNarrowDescHi<32> : kSw128DescHi;

// "Atoms": a transposed operand as [2 D][32] f32 atoms with the 128-byte
// swizzle, 256 D bytes each, rows 0 .. D - 1 hi and D .. 2 D - 1 lo, its k
// index (keys or queries) along the row, 32 an atom: the byte offset of (row,
// k). wgmma reads it K-major through kSw128DescHi, a k-step of 8 32 bytes on.
template <int D>
__host__ __device__ __forceinline__ int t32_atom_offset(int row, int k) {
  return (k >> 5) * 256 * D + sw128_offset(row, k & 31);
}

// ---- the forward ------------------------------------------------------------

// A stage: the landed q, K hi (split in place) and K lo, the landed V, then
// V^T hi and lo as eight atoms, then the bias (kWinMax f32). One stage a
// consumer (a deeper ring does not fit beside the other consumer's at d 16,
// nor at all at d 32).
__host__ __device__ constexpr int t32w_tile_bytes(int d) { return kWinMax * 4 * d; }
__host__ __device__ constexpr int t32w_fwd_stage_bytes(int d) {
  return 6 * t32w_tile_bytes(d) + kWinMax * 4;
}
// The stages, three barriers a consumer (landed, full, empty), and 1024
// bytes to align the tiles.
__host__ __device__ constexpr int t32w_fwd_smem_bytes(int d) {
  return 1024 + t32w_consumers(d) * (t32w_fwd_stage_bytes(d) + 24);
}

// The producer threads `pt` (0 .. 128 / C - 1) of consumer c in the forward:
// each window's q, K and V by TMA (thread 0), the bias, then, once they have
// landed, K split in place into hi and lo, and V^T hi and lo.
template <int D>
__device__ __forceinline__ void produce_fwd_window_tf32(
    const LunarisK2WindowArgs& a, const K2WindowMaps& maps, uint8_t* stage,
    uint64_t* landed, uint64_t* full, uint64_t* empty, int c, int pt) {
  constexpr int C = t32w_consumers(D);
  constexpr int P = 128 / C;
  constexpr int TILE = t32w_tile_bytes(D);
  constexpr int SPAN = D / 4;                   // 16-byte chunks a row
  const int W = a.W;
  float4* kh = reinterpret_cast<float4*>(stage + TILE);
  float4* kl = reinterpret_cast<float4*>(stage + 2 * TILE);
  const float4* vland = reinterpret_cast<const float4*>(stage + 3 * TILE);
  uint8_t* vt = stage + 4 * TILE;
  float* bias_s = reinterpret_cast<float*>(stage + 6 * TILE);
  for (int u = 0;; ++u) {
    const int w = t32w_win_of<C>(c, u, a.BH);
    if (w < 0) break;
    if (u > 0) mbar_wait(empty, (u - 1) & 1);
    if (pt == 0) {
      mbar_arrive_tx(landed, 3 * TILE);
      tma_load_3d(stage, &maps.q, landed, 0, 0, w);
      tma_load_3d(stage + TILE, &maps.k, landed, 0, 0, w);
      tma_load_3d(stage + 3 * TILE, &maps.v, landed, 0, 0, w);
    }
    const float* bw = a.bias + static_cast<long long>(w % a.H) * W;
#pragma unroll 1
    for (int r = pt; r < kWinMax; r += P) bias_s[r] = r < W ? bw[r] : -INFINITY;
    mbar_wait(landed, u & 1);
    // K: the swizzle moves 16-byte chunks, so a chunk splits where it lies.
#pragma unroll 1
    for (int i = pt; i < kWinMax * SPAN; i += P) {
      float4 hi, lo;
      split_tf32(kh[i], hi, lo);
      kh[i] = hi;
      kl[i] = lo;
    }
    // V^T: chunk i holds key r's dims 4 (i % SPAN ^ the row's swizzle) ..
#pragma unroll 1
    for (int i = pt; i < kWinMax * SPAN; i += P) {
      const int r = i / SPAN;
      const int col = 4 * ((i % SPAN) ^ ((r / (8 / SPAN)) & (SPAN - 1)));
      const float4 x = vland[i];
      const float xs[4] = {x.x, x.y, x.z, x.w};
      const int key = perm8(r);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        uint32_t h, l;
        split_tf32(xs[e], h, l);
        *reinterpret_cast<uint32_t*>(vt + t32_atom_offset<D>(col + e, key)) = h;
        *reinterpret_cast<uint32_t*>(vt + t32_atom_offset<D>(D + col + e, key)) = l;
      }
    }
    fence_async_shared();          // the split tiles and the bias, for wgmma
    mbar_arrive(full);
  }
}

// Consumer warpgroup c of flash_fwd_window_tf32: its windows, 64 queries (a
// task) at a time. Every wgmma issues on every path, nothing between a
// wgmma and its wait branches, and no instruction touches the registers of
// a wgmma in flight.
template <int D, int DROP>
__device__ __forceinline__ void consume_fwd_window_tf32(
    const LunarisK2WindowArgs& a, const uint8_t* stage, uint64_t* full,
    uint64_t* empty, int c) {
  constexpr int C = t32w_consumers(D);
  constexpr int TILE = t32w_tile_bytes(D);
  constexpr int KD = D / 8;                     // k-steps of q k^T
  constexpr uint32_t HI = kT32RowDescHi<D>;     // K hi and lo
  constexpr uint32_t CHUNK = 64 * 4 * D >> 4;   // 64 rows of K, in 16 bytes
  constexpr uint32_t ATOM = 256 * D >> 4;       // an atom of V^T
  constexpr uint32_t LO = 128 * D >> 4;         // from an atom's hi rows to its lo
  const int W = a.W, nch = W / 64;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wq = warp & 3;         // the warp within its warpgroup
  const int g = lane >> 2;         // the fragment's row (and row + 8)
  const int t = lane & 3;          // the fragment's column pair
  const bool drop = DROP == kDropOn;
  const float* bias_s = reinterpret_cast<const float*>(stage + 6 * TILE);
  const uint32_t kh_lo = desc_lo(stage) + (TILE >> 4);
  const uint32_t vt_lo = desc_lo(stage) + (4 * TILE >> 4);

  for (int u = 0;; ++u) {
    const int w = t32w_win_of<C>(c, u, a.BH);
    if (w < 0) break;
    const uint32_t row_seed = a.seed ^ (static_cast<uint32_t>(w + a.row_offset) * kC1);
    mbar_wait(full, u & 1);

    for (int rg = 0; rg < nch; ++rg) {
      const int row0 = rg * 64 + wq * 16 + g;      // rows row0 and row0 + 8
      // q as the A fragments of q k^T (rows g, g + 8; d 8 kd + t, + 4),
      // scaled in f32 and split once.
      uint32_t qh[KD][4], ql[KD][4];
#pragma unroll
      for (int kd = 0; kd < KD; ++kd)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float x = *reinterpret_cast<const float*>(
              stage + t32_row_offset<D>(row0 + (i & 1) * 8, 8 * kd + t + (i >> 1) * 4));
          split_tf32(x * a.scale, qh[kd][i], ql[kd][i]);
        }

      // s = bias + qs k^T over the stage's kWinMax keys, 64 a chunk: the
      // bias in the accumulator, then three passes a k-step, the small terms
      // first. Keys past W score -inf (their bias) on zero rows of K.
      float s[4][32];
#pragma unroll
      for (int ch = 0; ch < 4; ++ch)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 b = *reinterpret_cast<const float2*>(bias_s + 64 * ch + 8 * j + 2 * t);
          s[ch][4 * j] = s[ch][4 * j + 2] = b.x;
          s[ch][4 * j + 1] = s[ch][4 * j + 3] = b.y;
        }
      // The bias lands in s's registers before the fence (a write the
      // compiler sank past it made ptxas add a warpgroup.arrive of its own
      // in a divergent path and serialise every wgmma, C7520).
#pragma unroll
      for (int ch = 0; ch < 4; ++ch) wgmma_pin(s[ch]);
      wgmma_fence();
#pragma unroll
      for (int ch = 0; ch < 4; ++ch)
#pragma unroll
        for (int kd = 0; kd < KD; ++kd) {
          const uint32_t kb = t32w_fresh(kh_lo) + ch * CHUNK + 2 * kd;
          const uint64_t kh = desc_of(kb, HI);
          const uint64_t kl = desc_of(kb + (TILE >> 4), HI);
          wgmma_tf32_rs_n64(s[ch], ql[kd], kh, 1);
          wgmma_tf32_rs_n64(s[ch], qh[kd], kl, 1);
          wgmma_tf32_rs_n64(s[ch], qh[kd], kh, 1);
        }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int ch = 0; ch < 4; ++ch) wgmma_pin(s[ch]);

      // The row max over every key, across a row's 4 lanes.
      float mx[2] = {-1e30f, -1e30f};
#pragma unroll
      for (int ch = 0; ch < 4; ++ch)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          mx[0] = fmaxf(mx[0], fmaxf(s[ch][4 * j], s[ch][4 * j + 1]));
          mx[1] = fmaxf(mx[1], fmaxf(s[ch][4 * j + 2], s[ch][4 * j + 3]));
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      }
      const float neg[2] = {-mx[0] * kLog2e, -mx[1] * kLog2e};
      const uint32_t q_term = row_seed + static_cast<uint32_t>(a.q_offset + row0) * kC3;

      // p a k-step of 8 keys at a time: exp (0 past W), the row sum of the
      // undropped p (one chain a row from zero a chunk), the mask, the
      // split into the A fragments of p v (k-step ks: chunk j's C fragment
      // {(g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1)} is {a0, a2, a1,
      // a3}: V^T's keys are in `perm8` order); p v from zero a chunk of 64
      // keys, out while the next k-step's exps run, its fragments free once
      // it is done, two k-steps on. At D 16 p hi times [V hi; V lo] is one
      // m64n32k8 (an atom's 2 D rows) and p lo V hi one m64n16k8, added at
      // the chunk's end small terms first; at D 32 the three passes a
      // k-step go into one m64n32k8 sum. o sums the chunks from zero (o
      // taken from the first chunk's pv shared its registers, and ptxas
      // serialised the wgmma, C7520).
      float o[D / 2], pv[D / 2], l[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
      float pv2[D == 16 ? 16 : 1];
      uint32_t ph[2][4], pl[2][4];
#pragma unroll
      for (int ch = 0; ch < 4; ++ch) {
        float lq[2] = {0.f, 0.f};
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int ks = 8 * ch + j;
          const int b = ks & 1;
          const uint32_t k_term = static_cast<uint32_t>(64 * ch + 8 * j + 2 * t) * kC2;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float p = ex2(fmaf(s[ch][4 * j + e], kLog2e, neg[e >> 1]));
            lq[e >> 1] += p;
            if (drop) {
              const bool keep = keep_hash(
                  q_term + static_cast<uint32_t>(8 * (e >> 1)) * kC3 + k_term +
                      static_cast<uint32_t>(e & 1) * kC2,
                  a.threshold);
              p = keep ? p * a.inv_keep : 0.f;
            }
            const int ai = (e & 1) * 2 + (e >> 1);
            split_tf32(p, ph[b][ai], pl[b][ai]);
          }
          const uint32_t vh = t32w_fresh(vt_lo) + (ks >> 2) * ATOM + 2 * (ks & 3);
          wgmma_fence();
          if constexpr (D == 16) {
            wgmma_tf32_rs_n32(pv2, ph[b], desc_of(vh, kSw128DescHi), j > 0);
            wgmma_tf32_rs_n16(pv, pl[b], desc_of(vh, kSw128DescHi), j > 0);
          } else {
            wgmma_tf32_rs<D>(pv, pl[b], desc_of(vh, kSw128DescHi), j > 0);
            wgmma_tf32_rs<D>(pv, ph[b], desc_of(vh + LO, kSw128DescHi), 1);
            wgmma_tf32_rs<D>(pv, ph[b], desc_of(vh, kSw128DescHi), 1);
          }
          wgmma_commit();
          wgmma_wait<1>();
          wgmma_pin(ph[b ^ 1]);
          wgmma_pin(pl[b ^ 1]);
        }
        wgmma_wait<0>();
        wgmma_pin(pv);
        wgmma_pin(pv2);
        wgmma_pin(ph);
        wgmma_pin(pl);
        if constexpr (D == 16) {
#pragma unroll
          for (int i = 0; i < D / 2; ++i) pv[i] = (pv2[8 + i] + pv[i]) + pv2[i];
        }
#pragma unroll
        for (int i = 0; i < D / 2; ++i) o[i] += pv[i];
        l[0] += lq[0];
        l[1] += lq[1];
      }

      // o / l and lse, rows row0 and row0 + 8, with no branch: the
      // accurate division and logf branch, and a branch among the
      // registers of the next task's products makes ptxas serialise every
      // wgmma of the body (C7518, C7520), so __fdividef (2 ulps) and
      // __logf, and lse from the quad's four lanes (one value).
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float lr = l[r];
        lr += __shfl_xor_sync(0xffffffffu, lr, 1);
        lr += __shfl_xor_sync(0xffffffffu, lr, 2);
        lr = fmaxf(lr, 1e-30f);
        const long long at = static_cast<long long>(w) * W + row0 + 8 * r;
        float* orow = static_cast<float*>(a.o) + at * D;
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          *reinterpret_cast<float2*>(orow + 8 * j + 2 * t) =
              make_float2(__fdividef(o[4 * j + 2 * r], lr),
                          __fdividef(o[4 * j + 2 * r + 1], lr));
        a.lse[at] = mx[r] + __logf(lr);
      }
    }
    mbar_arrive(empty);
  }
}

// flash_fwd_window_tf32  f32 at D 16 and 32 on the windowed fold (the
// file's head says what it replaces and why).
template <int D, int DROP>
__global__ void __launch_bounds__(t32w_threads(D), 1)
flash_fwd_window_tf32(const LunarisK2WindowArgs a,
                      const __grid_constant__ K2WindowMaps maps) {
  static_assert(D == 16 || D == 32, "the f32 window bodies take d 16 and 32");
  constexpr int C = t32w_consumers(D);
  constexpr int STAGE = t32w_fwd_stage_bytes(D);
  extern __shared__ uint8_t fwd_t32w_smem[];
  uint8_t* ring = align1024(fwd_t32w_smem);
  uint64_t* landed = reinterpret_cast<uint64_t*>(ring + C * STAGE);
  uint64_t* full = landed + C;
  uint64_t* empty = full + C;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;

  if (tid == 0) {
    for (int i = 0; i < C; ++i) {
      mbar_init(&landed[i], 1);
      mbar_init(&full[i], 128 / C);
      mbar_init(&empty[i], 128);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 4 * C) {
    // The producer warpgroup: warp pw serves consumer pw % C; at two
    // consumers its registers go to them (2 x 128 x 232 + 128 x 40 <= the
    // SM's 65536), at one the block's 256 threads need no move.
    if constexpr (C == 2) setmaxnreg_dec<40>();
    const int pw = warp - 4 * C;
    const int c = pw % C;
    produce_fwd_window_tf32<D>(a, maps, ring + c * STAGE, &landed[c], &full[c],
                               &empty[c], c, (pw / C) * 32 + lane);
  } else {
    if constexpr (C == 2) setmaxnreg_inc<232>();
    const int c = warp >> 2;
    consume_fwd_window_tf32<D, DROP>(a, ring + c * STAGE, &full[c], &empty[c], c);
  }
}

// ---- the fused backward -----------------------------------------------------

// The queries of a sub-tile of s^T and dp^T: 32 at d 16, 16 at d 32 (the
// registers of ds and pv in hi and lo beside k and v in hi and lo).
__host__ __device__ constexpr int t32w_sub(int d) { return d == 16 ? 32 : 16; }
// The stages of a consumer's ring of (key group, query group) pairs: one at
// d 16, where two would not fit beside the other consumer's; two at d 32.
__host__ __device__ constexpr int t32w_bwd_stages(int d) { return d == 16 ? 1 : 2; }
// A pair's stage: qs hi, qs lo, dO hi, dO lo as rows [64][D] (256 D bytes
// each), qs^T then dO^T as two atoms each (queries 0-31, 32-63), then 64 f32
// of -lse log2 e and 64 of delta, rounded up to 1024 bytes.
__host__ __device__ constexpr int t32w_bwd_stage_bytes(int d) { return 2048 * d + 1024; }
constexpr int kT32wDsBytes = 64 * 64 * 4;      // ds hi or lo: [64 queries][64 keys]
// K^T of a key group, hi and lo, as two atoms (keys in order).
__host__ __device__ constexpr int t32w_kt_bytes(int d) { return 512 * d; }
// A consumer's dq of a window: kWinMax x D f32.
__host__ __device__ constexpr int t32w_dq_bytes(int d) { return kWinMax * 4 * d; }
// A consumer's part: its ring, ds hi and lo, K^T, dq.
__host__ __device__ constexpr int t32w_bwd_part_bytes(int d) {
  return t32w_bwd_stages(d) * t32w_bwd_stage_bytes(d) + 2 * kT32wDsBytes +
         t32w_kt_bytes(d) + t32w_dq_bytes(d);
}
// The parts, two barriers a stage (full, empty), and 1024 bytes to align.
__host__ __device__ constexpr int t32w_bwd_smem_bytes(int d) {
  return 1024 + t32w_consumers(d) * (t32w_bwd_part_bytes(d) + 16 * t32w_bwd_stages(d));
}

// The producer threads `pt` of consumer c in the backward: for each of its
// windows, key group by key group, each query group's stage (see
// t32w_bwd_stage_bytes), read from device memory 16 bytes at a time.
template <int D>
__device__ __forceinline__ void produce_bwd_window_tf32(
    const LunarisK2WindowArgs& a, uint8_t* ring, uint64_t* full,
    uint64_t* empty, int c, int pt) {
  constexpr int C = t32w_consumers(D);
  constexpr int P = 128 / C;
  constexpr int ST = t32w_bwd_stages(D);
  constexpr int SB = t32w_bwd_stage_bytes(D);
  constexpr int SPAN = D / 4;
  const int W = a.W, ng = W / 64;
  int x = 0;                       // the consumer's (key group, query group) pairs
  for (int u = 0;; ++u) {
    const int w = t32w_win_of<C>(c, u, a.BH);
    if (w < 0) break;
    for (int kg = 0; kg < ng; ++kg) {
      for (int qg = 0; qg < ng; ++qg, ++x) {
        const int st = x % ST;
        uint8_t* s = ring + st * SB;
        if (x >= ST) mbar_wait(&empty[st], ((x / ST) & 1) ^ 1);
        const long long q0 = static_cast<long long>(w) * W + qg * 64;
        // qs (which 0) and dO (1): rows hi, lo at 512 D which + 0, 256 D;
        // atoms at 1024 D + 512 D which, the query's column `perm8`'s.
#pragma unroll 1
        for (int i = pt; i < 2 * 64 * SPAN; i += P) {
          const int which = i / (64 * SPAN);
          const int j = i % (64 * SPAN);
          const int r = j / SPAN, col = 4 * (j % SPAN);
          const float4 v = reinterpret_cast<const float4*>(
              static_cast<const float*>(which ? a.dout : a.q) + q0 * D)[j];
          const float xs[4] = {v.x, v.y, v.z, v.w};
          uint8_t* rows = s + 512 * D * which;
          uint8_t* atoms = s + 1024 * D + 512 * D * which;
          const int qc = perm8(r);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            uint32_t h, l;
            split_tf32(which ? xs[e] : xs[e] * a.scale, h, l);
            *reinterpret_cast<uint32_t*>(rows + t32_row_offset<D>(r, col + e)) = h;
            *reinterpret_cast<uint32_t*>(rows + 256 * D + t32_row_offset<D>(r, col + e)) = l;
            *reinterpret_cast<uint32_t*>(atoms + t32_atom_offset<D>(col + e, qc)) = h;
            *reinterpret_cast<uint32_t*>(atoms + t32_atom_offset<D>(D + col + e, qc)) = l;
          }
        }
        // -lse log2 e and delta = rowsum(o dO), summed in order along the row.
        float* nls = reinterpret_cast<float*>(s + 2048 * D);
#pragma unroll 1
        for (int r = pt; r < 64; r += P) {
          const float4* orow = reinterpret_cast<const float4*>(
              static_cast<const float*>(a.o) + (q0 + r) * D);
          const float4* drow = reinterpret_cast<const float4*>(
              static_cast<const float*>(a.dout) + (q0 + r) * D);
          float acc = 0.f;
#pragma unroll 1
          for (int cc = 0; cc < SPAN; ++cc) {
            const float4 y = orow[cc], z = drow[cc];
            acc = fmaf(y.x, z.x, acc);
            acc = fmaf(y.y, z.y, acc);
            acc = fmaf(y.z, z.z, acc);
            acc = fmaf(y.w, z.w, acc);
          }
          nls[64 + r] = acc;
          nls[r] = -a.lse[q0 + r] * kLog2e;
        }
        fence_async_shared();      // the stage, for the consumer's wgmma
        mbar_arrive(&full[st]);
      }
    }
  }
}

// Consumer warpgroup c of flash_bwd_window_tf32: its windows, a 64-key group
// at a time, each against the window's 64-query groups. Every wgmma a
// sub-tile or a pair issues is done before the next starts.
template <int D, int DROP>
__device__ __forceinline__ void consume_bwd_window_tf32(
    const LunarisK2WindowArgs& a, const uint8_t* ring, uint8_t* dsb,
    uint8_t* kt, float2* dqs, uint64_t* full, uint64_t* empty, int c) {
  constexpr int C = t32w_consumers(D);
  constexpr int ST = t32w_bwd_stages(D);
  constexpr int SB = t32w_bwd_stage_bytes(D);
  constexpr int QS = t32w_sub(D);
  constexpr int KD = D / 8;                     // k-steps of s^T and dp^T
  constexpr uint32_t HI = kT32RowDescHi<D>;     // qs and dO rows
  constexpr uint32_t ROWS = 256 * D >> 4;       // a rows tile, in 16 bytes
  constexpr uint32_t SUB = QS * 4 * D >> 4;     // a sub-tile's rows
  constexpr uint32_t ATOM = 256 * D >> 4;       // an atom
  constexpr uint32_t LO = 128 * D >> 4;         // an atom's hi rows to its lo
  const int W = a.W, ng = W / 64;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wq = warp & 3;
  const int g = lane >> 2;         // the accumulator's row (and row + 8): a key
  const int t = lane & 3;          // its column pair: queries
  const int key_l = wq * 16 + g;   // within the key group
  const bool drop = DROP == kDropOn;
  const float scale = a.scale;
  const uint32_t ring_lo = desc_lo(ring), ds_lo = desc_lo(dsb), kt_lo = desc_lo(kt);
  uint8_t* dsl = dsb + kT32wDsBytes;
  // A thread's pair i of query group qg's dq in the f32 tile: pair-major,
  // so that a warp's 8-byte accesses hit 32 banks.
  const auto dq_at = [&](int qg, int i) {
    return dqs + (qg * (D / 4) + i) * 128 + (threadIdx.x & 127);
  };

  int x = 0;                       // the (key group, query group) pairs so far
  for (int u = 0;; ++u) {
    const int w = t32w_win_of<C>(c, u, a.BH);
    if (w < 0) break;
    const uint32_t row_seed = a.seed ^ (static_cast<uint32_t>(w + a.row_offset) * kC1);
    const float* bw = a.bias + static_cast<long long>(w % a.H) * W;
    const float* kb = static_cast<const float*>(a.k) + static_cast<long long>(w) * W * D;
    const float* vb = static_cast<const float*>(a.v) + static_cast<long long>(w) * W * D;

    for (int kg = 0; kg < ng; ++kg) {
      const int key = kg * 64 + key_l;             // keys key and key + 8
      // k and v of the warp's keys as the A fragments of s^T and dp^T (keys
      // g, g + 8; d 8 kd + t, + 4), split once; K^T hi and lo from them, the
      // B of dq = ds k (every dq product of the group before is done: the
      // warpgroup met after the last).
      uint32_t kh[KD][4], kl[KD][4], vh[KD][4], vl[KD][4];
#pragma unroll
      for (int kd = 0; kd < KD; ++kd)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int kq = key_l + (i & 1) * 8, dim = 8 * kd + t + (i >> 1) * 4;
          const long long off = static_cast<long long>(kg * 64 + kq) * D + dim;
          split_tf32(kb[off], kh[kd][i], kl[kd][i]);
          split_tf32(vb[off], vh[kd][i], vl[kd][i]);
          *reinterpret_cast<uint32_t*>(kt + t32_atom_offset<D>(dim, kq)) = kh[kd][i];
          *reinterpret_cast<uint32_t*>(kt + t32_atom_offset<D>(D + dim, kq)) = kl[kd][i];
        }
      const float bk[2] = {bw[key], bw[key + 8]};
      const uint32_t k_term[2] = {row_seed + static_cast<uint32_t>(key) * kC2,
                                  row_seed + static_cast<uint32_t>(key + 8) * kC2};
      float dk[D / 2], dv[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
      float db[2] = {0.f, 0.f};

      for (int qg = 0; qg < ng; ++qg, ++x) {
        const int st = x % ST;
        const uint32_t qt = ring_lo + st * (SB >> 4);
        const float* nls = reinterpret_cast<const float*>(ring + st * SB + 2048 * D);
        const float* dls = nls + 64;
        mbar_wait(&full[st], (x / ST) & 1);

        float tk[D / 2], tv[D / 2];  // the pair's dk and dv, from zero
        float tk2[D == 16 ? 16 : 1], tv2[D == 16 ? 16 : 1];
#pragma unroll
        for (int h = 0; h < 64 / QS; ++h) {
          // s^T = bias + k qs^T and dp^T = v dO^T over the sub-tile's queries.
          float s[QS / 2], dp[QS / 2];
#pragma unroll
          for (int j = 0; j < QS / 8; ++j) {
            s[4 * j] = s[4 * j + 1] = bk[0];
            s[4 * j + 2] = s[4 * j + 3] = bk[1];
          }
          wgmma_fence();
#pragma unroll
          for (int kd = 0; kd < KD; ++kd) {
            const uint32_t qr = t32w_fresh(qt) + h * SUB + 2 * kd;
            wgmma_tf32_rs<QS>(s, kl[kd], desc_of(qr, HI), 1);
            wgmma_tf32_rs<QS>(s, kh[kd], desc_of(qr + ROWS, HI), 1);
            wgmma_tf32_rs<QS>(s, kh[kd], desc_of(qr, HI), 1);
          }
#pragma unroll
          for (int kd = 0; kd < KD; ++kd) {
            const uint32_t orr = t32w_fresh(qt) + 2 * ROWS + h * SUB + 2 * kd;
            wgmma_tf32_rs<QS>(dp, vl[kd], desc_of(orr, HI), kd > 0);
            wgmma_tf32_rs<QS>(dp, vh[kd], desc_of(orr + ROWS, HI), 1);
            wgmma_tf32_rs<QS>(dp, vh[kd], desc_of(orr, HI), 1);
          }
          wgmma_commit();
          wgmma_wait<0>();
          wgmma_pin(s);
          wgmma_pin(dp);

          // p, the mask, ds and pv at the TPU kernel's rounding points; ds
          // and pv split into the A fragments of dk and dv (chunk j's C
          // fragment is k-step j's {a0, a2, a1, a3}: the atoms' queries are
          // in `perm8` order), ds into the [query][key] tile of dq. The hash
          // of (key r, query q0 + 8 j + 2 t + e) is k_term[r] + q_term + (8 j
          // + e) C3.
          const uint32_t q_term =
              static_cast<uint32_t>(a.q_offset + qg * 64 + h * QS + 2 * t) * kC3;
          uint32_t dsfh[QS / 8][4], dsfl[QS / 8][4], pvfh[QS / 8][4], pvfl[QS / 8][4];
#pragma unroll
          for (int j = 0; j < QS / 8; ++j) {
            const float2 nl = *reinterpret_cast<const float2*>(nls + h * QS + 8 * j + 2 * t);
            const float2 dl = *reinterpret_cast<const float2*>(dls + h * QS + 8 * j + 2 * t);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float p = ex2(fmaf(s[4 * j + e], kLog2e, e & 1 ? nl.y : nl.x));
              float dpd = dp[4 * j + e];
              float pvv = p;
              if (drop) {
                const bool keep = keep_hash(
                    k_term[e >> 1] + q_term + static_cast<uint32_t>(8 * j + (e & 1)) * kC3,
                    a.threshold);
                const float kinv = keep ? a.inv_keep : 0.f;
                dpd *= kinv;
                pvv = p * kinv;
              }
              const float ds = p * (dpd - (e & 1 ? dl.y : dl.x));
              db[e >> 1] += ds;
              const int ai = (e & 1) * 2 + (e >> 1);
              split_tf32(ds, dsfh[j][ai], dsfl[j][ai]);
              split_tf32(pvv, pvfh[j][ai], pvfl[j][ai]);
              const int qq = h * QS + 8 * j + 2 * t + (e & 1), kq = key_l + 8 * (e >> 1);
              const int off = (kq >> 5) * 8192 + sw128_offset(qq, kq & 31);
              *reinterpret_cast<uint32_t*>(dsb + off) = dsfh[j][ai];
              *reinterpret_cast<uint32_t*>(dsl + off) = dsfl[j][ai];
            }
          }

          // dv += pv^T dO, dk += ds^T qs over the sub-tile (k-step j: 8
          // queries, 32 bytes on within the atom's rows), from zero a pair.
          wgmma_fence();
#pragma unroll
          for (int j = 0; j < QS / 8; ++j) {
            const int q8 = h * QS + 8 * j;
            const uint32_t qtr = t32w_fresh(qt) + (1024 * D >> 4) + (q8 >> 5) * ATOM +
                                 ((q8 & 31) >> 2);
            const uint32_t otr = qtr + (512 * D >> 4);
            const int acc = h > 0 || j > 0;
            if constexpr (D == 16) {
              wgmma_tf32_rs_n32(tv2, pvfh[j], desc_of(otr, kSw128DescHi), acc);
              wgmma_tf32_rs_n16(tv, pvfl[j], desc_of(otr, kSw128DescHi), acc);
              wgmma_tf32_rs_n32(tk2, dsfh[j], desc_of(qtr, kSw128DescHi), acc);
              wgmma_tf32_rs_n16(tk, dsfl[j], desc_of(qtr, kSw128DescHi), acc);
            } else {
              wgmma_tf32_rs<D>(tv, pvfl[j], desc_of(otr, kSw128DescHi), acc);
              wgmma_tf32_rs<D>(tv, pvfh[j], desc_of(otr + LO, kSw128DescHi), 1);
              wgmma_tf32_rs<D>(tv, pvfh[j], desc_of(otr, kSw128DescHi), 1);
              wgmma_tf32_rs<D>(tk, dsfl[j], desc_of(qtr, kSw128DescHi), acc);
              wgmma_tf32_rs<D>(tk, dsfh[j], desc_of(qtr + LO, kSw128DescHi), 1);
              wgmma_tf32_rs<D>(tk, dsfh[j], desc_of(qtr, kSw128DescHi), 1);
            }
          }
          wgmma_commit();
          wgmma_wait<0>();
          wgmma_pin(tk);
          wgmma_pin(tv);
          wgmma_pin(tk2);
          wgmma_pin(tv2);
          wgmma_pin(dsfh);
          wgmma_pin(dsfl);
          wgmma_pin(pvfh);
          wgmma_pin(pvfl);
        }
        mbar_arrive(&empty[st]);

        // dq of the query group over the key group = ds k, from zero, once
        // every warp of the warpgroup has written its ds (and K^T): three
        // passes a k-step of 8 keys, both operands in shared memory.
        fence_async_shared();
        named_barrier(1 + c, 128);
        float dqp[D / 2], dq2[D == 16 ? 16 : 1];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
          const uint32_t ah = t32w_fresh(ds_lo) + (kk >> 2) * (8192 >> 4) + 2 * (kk & 3);
          const uint32_t al = ah + (kT32wDsBytes >> 4);
          const uint32_t bh = t32w_fresh(kt_lo) + (kk >> 2) * ATOM + 2 * (kk & 3);
          if constexpr (D == 16) {
            wgmma_tf32_ss_n32(dq2, desc_of(ah, kSw128DescHi), desc_of(bh, kSw128DescHi), kk > 0);
            wgmma_tf32_ss_n16(dqp, desc_of(al, kSw128DescHi), desc_of(bh, kSw128DescHi), kk > 0);
          } else {
            wgmma_tf32_ss<D>(dqp, desc_of(al, kSw128DescHi), desc_of(bh, kSw128DescHi), kk > 0);
            wgmma_tf32_ss<D>(dqp, desc_of(ah, kSw128DescHi), desc_of(bh + LO, kSw128DescHi), 1);
            wgmma_tf32_ss<D>(dqp, desc_of(ah, kSw128DescHi), desc_of(bh, kSw128DescHi), 1);
          }
        }
        wgmma_commit();
        wgmma_wait<0>();
        wgmma_pin(dqp);
        wgmma_pin(dq2);
        if constexpr (D == 16) {
#pragma unroll
          for (int i = 0; i < D / 2; ++i) dqp[i] = (dq2[8 + i] + dqp[i]) + dq2[i];
        }
        named_barrier(1 + c, 128);   // ds and K^T are read: they may be written
        // Added to the key groups' sum so far, in their order, a thread's own
        // values.
#pragma unroll
        for (int i = 0; i < D / 4; ++i) {
          const float2 was = *dq_at(qg, i);
          *dq_at(qg, i) = kg > 0 ? make_float2(was.x + dqp[2 * i], was.y + dqp[2 * i + 1])
                                 : make_float2(dqp[2 * i], dqp[2 * i + 1]);
        }
        if constexpr (D == 16) {
#pragma unroll
          for (int i = 0; i < D / 2; ++i) {
            tk[i] = (tk2[8 + i] + tk[i]) + tk2[i];
            tv[i] = (tv2[8 + i] + tv[i]) + tv2[i];
          }
        }
#pragma unroll
        for (int i = 0; i < D / 2; ++i) {
          dk[i] += tk[i];
          dv[i] += tv[i];
        }
      }

      // dk, dv and dbias of the key group.
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float dbr = db[r];
        dbr += __shfl_xor_sync(0xffffffffu, dbr, 1);
        dbr += __shfl_xor_sync(0xffffffffu, dbr, 2);
        const long long at = static_cast<long long>(w) * W + key + 8 * r;
        float* dkrow = static_cast<float*>(a.dk) + at * D;
        float* dvrow = static_cast<float*>(a.dv) + at * D;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          *reinterpret_cast<float2*>(dkrow + 8 * j + 2 * t) =
              make_float2(dk[4 * j + 2 * r], dk[4 * j + 2 * r + 1]);
          *reinterpret_cast<float2*>(dvrow + 8 * j + 2 * t) =
              make_float2(dv[4 * j + 2 * r], dv[4 * j + 2 * r + 1]);
        }
        a.dbias_bh[at] = dbr;      // the quad's four lanes, one value
      }
    }

    // dq, once: the key groups' sum times d^-1/2 in f32.
    for (int qg = 0; qg < ng; ++qg) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const long long at = static_cast<long long>(w) * W + qg * 64 + key_l + 8 * r;
        float* dqrow = static_cast<float*>(a.dq) + at * D;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          const float2 v = *dq_at(qg, 2 * j + r);
          *reinterpret_cast<float2*>(dqrow + 8 * j + 2 * t) =
              make_float2(v.x * scale, v.y * scale);
        }
      }
    }
  }
}

// flash_bwd_window_tf32  the fused backward in f32 at D 16 and 32 on the
// windowed fold (the file's head).
template <int D, int DROP>
__global__ void __launch_bounds__(t32w_threads(D), 1)
flash_bwd_window_tf32(const LunarisK2WindowArgs a) {
  static_assert(D == 16 || D == 32, "the f32 window bodies take d 16 and 32");
  constexpr int C = t32w_consumers(D);
  constexpr int ST = t32w_bwd_stages(D);
  constexpr int SB = t32w_bwd_stage_bytes(D);
  constexpr int PART = t32w_bwd_part_bytes(D);
  extern __shared__ uint8_t bwd_t32w_smem[];
  uint8_t* base = align1024(bwd_t32w_smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + C * PART);
  uint64_t* empty = full + C * ST;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;

  if (tid == 0) {
    for (int i = 0; i < C * ST; ++i) {
      mbar_init(&full[i], 128 / C);
      mbar_init(&empty[i], 128);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 4 * C) {
    if constexpr (C == 2) setmaxnreg_dec<40>();
    const int pw = warp - 4 * C;
    const int c = pw % C;
    produce_bwd_window_tf32<D>(a, base + c * PART, full + c * ST, empty + c * ST,
                               c, (pw / C) * 32 + lane);
  } else {
    if constexpr (C == 2) setmaxnreg_inc<232>();
    const int c = warp >> 2;
    uint8_t* part = base + c * PART;
    uint8_t* dsb = part + ST * SB;
    uint8_t* kt = dsb + 2 * kT32wDsBytes;
    consume_bwd_window_tf32<D, DROP>(
        a, part, dsb, kt, reinterpret_cast<float2*>(kt + t32w_kt_bytes(D)),
        full + c * ST, empty + c * ST, c);
  }
}

// ---- launches ---------------------------------------------------------------

// The shapes both bodies take and the alignment their 16-byte reads and
// 8-byte writes need.
inline bool t32w_shape_ok(const LunarisK2WindowArgs& a, bool backward) {
  const auto misaligned = [](const void* p, uintptr_t n) {
    return reinterpret_cast<uintptr_t>(p) % n != 0;
  };
  if (a.BH <= 0 || a.H <= 0 || a.W < 64 || a.W > kWinMax || a.W % 64 != 0 ||
      misaligned(a.q, 16) || misaligned(a.k, 16) || misaligned(a.v, 16) ||
      misaligned(a.o, backward ? 16 : 8))
    return false;
  return !backward || !(misaligned(a.dout, 16) || misaligned(a.dq, 8) ||
                        misaligned(a.dk, 8) || misaligned(a.dv, 8));
}

template <int D, int DROP>
int launch_fwd_window_tf32(const LunarisK2WindowArgs& a, cudaStream_t stream) {
  K2WindowMaps maps{};
  if (!t32w_shape_ok(a, false) ||
      !f32_row_tile_map(&maps.q, a.q, a.BH, a.W, D, kWinMax) ||
      !f32_row_tile_map(&maps.k, a.k, a.BH, a.W, D, kWinMax) ||
      !f32_row_tile_map(&maps.v, a.v, a.BH, a.W, D, kWinMax))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = flash_fwd_window_tf32<D, DROP>;
  constexpr int smem = t32w_fwd_smem_bytes(D);
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<win_grid(a.BH), t32w_threads(D), smem, stream>>>(a, maps);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int DROP>
int launch_bwd_window_tf32(const LunarisK2WindowArgs& a, cudaStream_t stream) {
  if (!t32w_shape_ok(a, true)) return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = flash_bwd_window_tf32<D, DROP>;
  constexpr int smem = t32w_bwd_smem_bytes(D);
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<win_grid(a.BH), t32w_threads(D), smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
