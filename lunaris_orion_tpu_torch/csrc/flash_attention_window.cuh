// K2 over closed windows -- the bodies of the flash-attention forward and
// fused backward for the windowed fold, for Hopper (sm_90a): bf16 at head
// size 16 and 32, Nq = Nk = W, W a multiple of 64 and at most 256.
// Included by the flash_attention_{fwd,bwd}_window*.cu instances and the
// entry points in flash_attention_window.cu; the build hashes this header
// with the sources. The hash, the bias split and the wgmma / TMA wrappers
// are flash_attention_common.cuh's and hopper.cuh's.
//
// Replaces, on the windowed fold, lunaris_orion_tpu/ops/pallas/
// flash_attention.py `_fwd_kernel` and `_bwd_fused_kernel`.
// `local_window_attention` (ops/attention.py) folds the windows of the
// token axis into the head axis, so that K2 runs on [BH, W, d] with BH =
// B * heads * N / W rows of W queries and W keys each, and a bias [H, W]
// (H = heads * N / W) indexed by bh % H. The math, the rounding points and
// the dropout hash are those of the other K2 bodies (flash_attention_fwd.cuh
// and flash_attention_bwd.cuh say them), on bh = the window's row in the
// call (plus row_offset), the key's and the query's position in it.
//
// Bound. At B16 H8 N16384 W256 a call holds 5.4e8 scores: the bytes (q, k,
// v, o at 67 MB each in bf16) and the products take about 0.08 ms each,
// the one exp a score on the special-function units 0.13 ms (16 a clock an
// SM), which is the floor. flash_fwd_mma and the fused flash_bwd_dkv_mma,
// which these replace there, run 128 queries (or keys) a block with an
// online softmax over 4 key tiles, load each window's K and V once a block
// (twice a window), and pay a block's set-up per 128 x 256 scores; the
// backward's wrapper adds delta, a zeroed f32 dq buffer and its cast in
// PyTorch passes that move several times the kernel's own bytes. A window
// is closed, and that allows:
//   - One window per step of a persistent block. A block (one an SM) is two
//     consumer warpgroups and a producer warpgroup, of which one warp a
//     consumer loads: window i of the block goes to consumer i % 2, through
//     that consumer's own ring of stages (two a consumer, one in the
//     backward at d 32), so the next window's TMA loads run under this
//     one's work and the two consumers never wait for each other.
//   - The whole window in shared memory: its Q, K and V (and dO) as narrow
//     tiles (hopper.cuh: the row is the swizzle's span; the forward's of
//     256 rows, zeros past W), each loaded once for all its queries.
//   - An exact softmax in one pass (forward): a consumer warpgroup takes 64
//     queries at a time against all of the window's keys, s = bias + qs k^T
//     as four wgmma m64n64 tiles in registers (128 f32 a thread; the keys
//     past a W under 256 score -inf), the row max, then exp2, the row sum,
//     the mask and the bf16 pack 8 keys at a time, each 16 keys' p v
//     (wgmma m64n{D}k16, p from registers) going out while the next keys'
//     exps run. No rescaling.
//   - dq complete inside the block (backward): a consumer warpgroup walks
//     the window's 64-key groups and, for each, its 64-query groups,
//     summing dq of all W queries over the key groups (in registers, W /
//     64 accumulators of m64n16, at d 16; in an f32 tile of shared memory
//     at d 32) while dk, dv and dbias of the key group sum in registers
//     over the queries; dq = ds k goes through one ds^T tile in shared
//     memory. So there is no f32 buffer in device memory, no atomics and no
//     cast pass: dq is written once in bf16, and dq, dk, dv and dbias are
//     the same bits on every run. delta = rowsum(o dO) is the producer's,
//     from o and dO.
//   - The bias as a k-step of its own, as the narrow bodies take it: split
//     into three bf16 parts b1 + b2 + b3 (exactly the f32 bias), it enters
//     the scores' f32 sum ahead of q k^T, with no instruction a score.

#pragma once

#include "flash_attention_common.cuh"

// Arguments of both window bodies. q, k, v, dout, o, dq, dk, dv: [BH, W, D]
// bf16; bias [H, W] f32; lse, dbias_bh [BH, W] f32. The forward writes o
// and lse, the backward reads them and writes dq, dk, dv and dbias_bh.
// scale: d^-1/2 rounded to bf16; threshold: the uint32 keep threshold,
// inv_keep: f32(1 / (1 - rate)).
struct LunarisK2WindowArgs {
  const void* q;
  const void* k;
  const void* v;
  const float* bias;
  void* o;
  float* lse;
  const void* dout;
  void* dq;
  void* dk;
  void* dv;
  float* dbias_bh;
  int BH, H, W;
  float scale;
  int use_dropout;
  uint32_t threshold;
  float inv_keep;
  uint32_t seed;
  int q_offset, row_offset;
};

// The instances, one translation unit each
// (flash_attention_{fwd,bwd}_window_d{16,32}{,_drop}.cu). Each returns the
// cudaError_t of the launch.
int lunaris_k2_fwd_window_d16(const LunarisK2WindowArgs& a, cudaStream_t s);
int lunaris_k2_fwd_window_d16_drop(const LunarisK2WindowArgs& a, cudaStream_t s);
int lunaris_k2_fwd_window_d32(const LunarisK2WindowArgs& a, cudaStream_t s);
int lunaris_k2_fwd_window_d32_drop(const LunarisK2WindowArgs& a, cudaStream_t s);
int lunaris_k2_bwd_window_d16(const LunarisK2WindowArgs& a, cudaStream_t s);
int lunaris_k2_bwd_window_d16_drop(const LunarisK2WindowArgs& a, cudaStream_t s);
int lunaris_k2_bwd_window_d32(const LunarisK2WindowArgs& a, cudaStream_t s);
int lunaris_k2_bwd_window_d32_drop(const LunarisK2WindowArgs& a, cudaStream_t s);

namespace {

constexpr int kWinMax = 256;                        // keys (and queries) a window at most
constexpr int kWinConsumers = 2;                    // warpgroups, a window each
constexpr int kWinThreads = 128 * (kWinConsumers + 1);
constexpr int kWinDsBytes = 64 * 64 * 2;            // a consumer's ds^T tile
constexpr int kWinOnesBytes = 64 * 32;              // the ones tile, [64][16]

// A narrow [kWinMax][D] tile; the forward's stage (Q, K, V, the bias as a
// [kWinMax][16] tile) and its stages a consumer; the backward's (Q, K, V,
// dO, then kWinMax f32 of -lse log2 e and of delta) and its stages a
// consumer: one at d 32, where two would not fit beside the other
// consumer's.
__host__ __device__ constexpr int win_tile_bytes(int d) { return kWinMax * 2 * d; }
__host__ __device__ constexpr int win_fwd_stage_bytes(int d) {
  return 3 * win_tile_bytes(d) + kWinMax * 32;
}
constexpr int kWinFwdStages = 2;
__host__ __device__ constexpr int win_bwd_stage_bytes(int d) {
  return 4 * win_tile_bytes(d) + kWinMax * 8;
}
__host__ __device__ constexpr int win_bwd_stages(int d) { return d == 16 ? 2 : 1; }
// Where the backward sums dq over a window's key groups: in registers at d
// 16 (four m64n16 accumulators), in a consumer's f32 tile of shared memory
// at d 32, where four m64n32 accumulators beside dk, dv, s and dp would
// spill (each group's product from zero, then added in the key groups'
// order, a thread's own values: no barrier).
__host__ __device__ constexpr bool win_dq_in_smem(int d) { return d == 32; }
__host__ __device__ constexpr int win_dq_smem_bytes(int d) {
  return win_dq_in_smem(d) ? kWinMax * d * 4 : 0;
}

// The stages, their barriers (full, empty; the backward also one for its
// TMA bytes) and 1024 bytes to align the tiles; the backward adds the
// consumers' ds^T tiles, the ones tile and at d 32 the consumers' dq.
__host__ __device__ constexpr int win_fwd_smem_bytes(int d) {
  return 1024 + kWinConsumers * kWinFwdStages * (win_fwd_stage_bytes(d) + 16);
}
__host__ __device__ constexpr int win_bwd_smem_bytes(int d) {
  return 1024 + kWinConsumers * win_bwd_stages(d) * (win_bwd_stage_bytes(d) + 24) +
         kWinConsumers * (kWinDsBytes + win_dq_smem_bytes(d)) + kWinOnesBytes;
}

struct K2WindowMaps {
  CUtensorMap q, k, v, dout;
};

// Window i of block b is b + i * gridDim.x; consumer c takes i = c, c + 2,
// ..., its u-th in stage u % stages. -1 past the call's windows.
__device__ __forceinline__ int win_of(int c, int u, int BH) {
  const int w = blockIdx.x + (c + kWinConsumers * u) * gridDim.x;
  return w < BH ? w : -1;
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024 - (smem_addr(p) & 1023)) & 1023);
}

// ---- the forward ------------------------------------------------------------

// Consumer warpgroup c of flash_fwd_window: its windows, 64 queries (a
// task) at a time. A task's scores land whole before its softmax; p v goes
// out a k-step of 16 keys at a time while the next keys' exps run, the
// fragments of two k-steps in registers (a chunk's 16 each at d 32 spill).
// Every wgmma issues on every path, nothing between a wgmma and its wait
// branches (not the epilogue's divisions and log, whose accurate forms do:
// a branch there makes ptxas serialise every wgmma of the body, C7518),
// and no instruction touches the registers of a wgmma in flight.
template <int D, int DROP>
__device__ __forceinline__ void consume_fwd_window(const LunarisK2WindowArgs& a,
                                                   const uint8_t* ring,
                                                   uint64_t* full,
                                                   uint64_t* empty, int c) {
  using bf16 = __nv_bfloat16;
  constexpr int ST = kWinFwdStages;
  constexpr int TILE = win_tile_bytes(D);
  constexpr int STAGE = win_fwd_stage_bytes(D);
  constexpr int KS = D / 16;                        // q's k-steps
  constexpr uint32_t HI = kNarrowDescHi<D>;         // Q, K, V
  constexpr uint32_t HI16 = kNarrowDescHi<16>;      // the bias tile
  constexpr uint32_t CHUNK_K = 64 * 2 * D >> 4;     // 64 rows of K, in 16 bytes
  constexpr uint32_t CHUNK_B = 64 * 32 >> 4;        // 64 rows of the bias tile
  constexpr uint32_t ROW16 = 16 * 2 * D >> 4;       // 16 rows of V
  const int W = a.W, nch = W / 64;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wq = warp & 3;         // the warp within its warpgroup
  const int g = lane >> 2;         // the fragment's row (and row + 8)
  const int t = lane & 3;          // the fragment's column pair
  const bool drop = DROP == kDropOn;
  const uint32_t ring_lo = desc_lo(ring);
  uint32_t ones[4];
  ones3_fragment(ones, t);

  float o[D / 2];                  // a task's o
  float mx[2], lq[2][2];           // its row max and row sums (2 chains a row)
  // o / l and lse of the task, rows at and at + 8.
  auto epilogue = [&](long long at) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float lr = lq[r][0] + lq[r][1];
      lr += __shfl_xor_sync(0xffffffffu, lr, 1);
      lr += __shfl_xor_sync(0xffffffffu, lr, 2);
      lr = fmaxf(lr, 1e-30f);
      bf16* orow = static_cast<bf16*>(a.o) + (at + 8 * r) * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(orow + 8 * j + 2 * t) =
            pack_bf16(__fdividef(o[4 * j + 2 * r], lr),
                      __fdividef(o[4 * j + 2 * r + 1], lr));
      a.lse[at + 8 * r] = mx[r] + __logf(lr);  // the quad's four lanes, one value
    }
  };

  for (int u = 0;; ++u) {
    const int w = win_of(c, u, a.BH);
    if (w < 0) break;
    const int st = u % ST;
    const uint8_t* qs = ring + st * STAGE;
    const uint32_t k_lo = ring_lo + st * (STAGE >> 4) + (TILE >> 4);
    const uint32_t v_lo = k_lo + (TILE >> 4);
    const uint32_t b_lo = v_lo + (TILE >> 4);
    const uint32_t row_seed = a.seed ^ (static_cast<uint32_t>(w + a.row_offset) * kC1);
    mbar_wait(&full[st], (u / ST) & 1);

    for (int rg = 0; rg < nch; ++rg) {
      const int row0 = rg * 64 + wq * 16 + g;      // rows row0 and row0 + 8
      // q as the A fragments of q k^T (k-step kk: columns 16 kk ..), from
      // the stage by ldmatrix, scaled and rounded once.
      uint32_t qf[KS][4];
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const int mi = lane >> 3;
        const int row = rg * 64 + wq * 16 + (mi & 1) * 8 + (lane & 7);
        uint32_t x[4];
        ldmatrix_x4(x, qs + narrow_offset<D>(row, 16 * kk + (mi >> 1) * 8));
#pragma unroll
        for (int i = 0; i < 4; ++i) qf[kk][i] = scale_bf16x2(x[i], a.scale);
      }

      // s = bias + qs k^T over the stage's kWinMax keys, 64 keys a chunk:
      // the bias k-step from zero, then q's (32 bytes on within K's row a
      // k-step). Keys past W score -inf (their bias) on zero rows of K.
      float s[4][32];
      wgmma_fence();
#pragma unroll
      for (int ch = 0; ch < 4; ++ch) {
        wgmma_rs<64, 0>(s[ch], ones, desc_of(b_lo + ch * CHUNK_B, HI16), 0);
#pragma unroll
        for (int kk = 0; kk < KS; ++kk)
          wgmma_rs<64, 0>(s[ch], qf[kk], desc_of(k_lo + ch * CHUNK_K + 2 * kk, HI), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int ch = 0; ch < 4; ++ch) wgmma_pin(s[ch]);

      // The row max over every key, across a row's 4 lanes.
      mx[0] = mx[1] = -1e30f;
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
      // The hash of (row r, key 64 ch + 8 j + 2 t + e) is base[r] +
      // (64 ch + 8 j + e) C2: the key's term stepped by a constant.
      const uint32_t base[2] = {
          row_seed + static_cast<uint32_t>(a.q_offset + row0) * kC3 +
              static_cast<uint32_t>(2 * t) * kC2,
          row_seed + static_cast<uint32_t>(a.q_offset + row0 + 8) * kC3 +
              static_cast<uint32_t>(2 * t) * kC2};

      // p 8 keys at a time: exp (0 past W), the row sum of the undropped
      // p, the mask, the bf16 pack as p v's A fragment (k-step ks: keys
      // 16 ks ..); each k-step's p v (V's rows past W are zeros) out while
      // the next keys' exps run, its fragment free once it is done, two
      // k-steps on.
      uint32_t pf[2][4];
      lq[0][0] = lq[0][1] = lq[1][0] = lq[1][1] = 0.f;
#pragma unroll
      for (int ch = 0; ch < 4; ++ch) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int ks = 4 * ch + (j >> 1);
          uint32_t (&pc)[4] = pf[ks & 1];
          float p[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            p[e] = ex2(fmaf(s[ch][4 * j + e], kLog2e, neg[e >> 1]));
            lq[e >> 1][j & 1] += p[e];
            if (drop) {
              const bool keep = keep_hash(
                  base[e >> 1] + static_cast<uint32_t>(64 * ch + 8 * j + (e & 1)) * kC2,
                  a.threshold);
              p[e] *= keep ? a.inv_keep : 0.f;
            }
          }
          pc[2 * (j & 1)] = pack_bf16(p[0], p[1]);
          pc[2 * (j & 1) + 1] = pack_bf16(p[2], p[3]);
          if (j & 1) {
            wgmma_fence();
            wgmma_rs<D, 1>(o, pc, desc_of(v_lo + ks * ROW16, HI), ks > 0);
            wgmma_commit();
            wgmma_wait<1>();
            wgmma_pin(pf[(ks + 1) & 1]);
          }
        }
      }
      wgmma_wait<0>();
      wgmma_pin(o);
      wgmma_pin(pf[0]);
      wgmma_pin(pf[1]);
      epilogue(static_cast<long long>(w) * W + row0);
    }
    mbar_arrive(&empty[st]);
  }
}

// flash_fwd_window  bf16 at D 16 and 32 on the windowed fold (the file's
// head says what it replaces and why). The producer warp of a consumer
// loads each of its windows' Q, K and V by TMA (one box of kWinMax rows
// each: zeros past W) and writes the window's bias tile (-inf past W); the
// consumer reads q's fragments from the stage with ldmatrix. Every wgmma
// covers the stage's kWinMax keys, whatever W: a product that a run-time W
// switched off would make ptxas serialise every wgmma of the body (C7515),
// and a window under 256 is not the recipe's.
template <int D, int DROP>
__global__ void __launch_bounds__(kWinThreads, 1)
flash_fwd_window(const LunarisK2WindowArgs a,
                 const __grid_constant__ K2WindowMaps maps) {
  static_assert(D == 16 || D == 32, "the window bodies take d 16 and 32");
  constexpr int ST = kWinFwdStages;
  constexpr int TILE = win_tile_bytes(D);
  constexpr int STAGE = win_fwd_stage_bytes(D);
  extern __shared__ uint8_t fwd_win_smem[];
  uint8_t* ring = align1024(fwd_win_smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kWinConsumers * ST * STAGE);
  uint64_t* empty = full + kWinConsumers * ST;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;

  if (tid == 0) {
    for (int i = 0; i < kWinConsumers * ST; ++i) {
      mbar_init(&full[i], 32);
      mbar_init(&empty[i], 128);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 4 * kWinConsumers) {
    // The producer warpgroup: warp c loads for consumer c, the registers go
    // to the consumers (2 x 128 x 232 + 128 x 40 <= the SM's 65536).
    setmaxnreg_dec<40>();
    const int c = warp - 4 * kWinConsumers;
    if (c >= kWinConsumers) return;
    const int W = a.W;
    uint8_t* mine = ring + c * ST * STAGE;
    for (int u = 0;; ++u) {
      const int w = win_of(c, u, a.BH);
      if (w < 0) break;
      const int st = u % ST;
      uint8_t* s = mine + st * STAGE;
      uint64_t* f = &full[c * ST + st];
      if (u >= ST) mbar_wait(&empty[c * ST + st], ((u / ST) & 1) ^ 1);
      if (lane == 0) {
        mbar_expect_tx(f, 3 * TILE);
        tma_load_3d(s, &maps.q, f, 0, 0, w);
        tma_load_3d(s + TILE, &maps.k, f, 0, 0, w);
        tma_load_3d(s + 2 * TILE, &maps.v, f, 0, 0, w);
      }
      const float* bw = a.bias + static_cast<long long>(w % a.H) * W;
      for (int r = lane; r < kWinMax; r += 32)
        write_bias_row(s + 3 * TILE, r, r < W ? bw[r] : -INFINITY);
      fence_async_shared();        // the bias, for the consumer's wgmma
      mbar_arrive(f);
    }
  } else {
    setmaxnreg_inc<232>();
    const int c = warp >> 2;
    consume_fwd_window<D, DROP>(a, ring + c * ST * STAGE, full + c * ST,
                                empty + c * ST, c);
  }
}

// ---- the fused backward -----------------------------------------------------

// Consumer warpgroup c of flash_bwd_window: its windows, a 64-key group at a
// time, each against the window's 64-query groups. Every wgmma a (keys,
// queries) pair issues is done before the next pair starts.
template <int D, int DROP>
__device__ __forceinline__ void consume_bwd_window(
    const LunarisK2WindowArgs& a, const uint8_t* ring, uint8_t* dsb,
    const uint8_t* ones, float2* dqs, uint64_t* full, uint64_t* empty,
    int c) {
  using bf16 = __nv_bfloat16;
  constexpr int ST = win_bwd_stages(D);
  constexpr int TILE = win_tile_bytes(D);
  constexpr int STAGE = win_bwd_stage_bytes(D);
  constexpr int KS = D / 16;                        // k-steps of s^T's and dp^T's products
  constexpr uint32_t HI = kNarrowDescHi<D>;         // Q, K, V, dO
  constexpr uint32_t HI16 = kNarrowDescHi<16>;      // the ones tile
  constexpr uint32_t GROUP = 64 * 2 * D >> 4;       // 64 rows of a tile, in 16 bytes
  constexpr uint32_t ROW16 = 16 * 2 * D >> 4;       // 16 rows
  const int W = a.W, ng = W / 64;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wq = warp & 3;
  const int g = lane >> 2;         // the accumulator's row (and row + 8): a key
  const int t = lane & 3;          // its column pair: queries
  const bool drop = DROP == kDropOn;
  const uint32_t ring_lo = desc_lo(ring);
  const uint32_t ones_lo = desc_lo(ones), ds_lo = desc_lo(dsb);
  const float scale = a.scale;
  constexpr bool SMEM_DQ = win_dq_in_smem(D);
  // A thread's pair i of query group qg's dq in the shared tile: pair-major,
  // so that a warp's 8-byte accesses hit 32 banks.
  const auto dq_at = [&](int qg, int i) {
    return dqs + (qg * (D / 4) + i) * 128 + (threadIdx.x & 127);
  };

  for (int u = 0;; ++u) {
    const int w = win_of(c, u, a.BH);
    if (w < 0) break;
    const int st = u % ST;
    const uint32_t q_lo = ring_lo + st * (STAGE >> 4);
    const uint32_t k_lo = q_lo + (TILE >> 4);
    const uint32_t v_lo = k_lo + (TILE >> 4);
    const uint32_t do_lo = v_lo + (TILE >> 4);
    const float* nls = reinterpret_cast<const float*>(ring + st * STAGE + 4 * TILE);
    const float* dls = nls + kWinMax;
    const uint32_t row_seed = a.seed ^ (static_cast<uint32_t>(w + a.row_offset) * kC1);
    const float* bw = a.bias + static_cast<long long>(w % a.H) * W;
    mbar_wait(&full[st], (u / ST) & 1);

    // dq of query group qg over the key groups done (in shared memory at d
    // 32: then dq[0] holds one group's product).
    float dq[SMEM_DQ ? 1 : 4][D / 2];
    for (int kg = 0; kg < ng; ++kg) {
      const int key = kg * 64 + wq * 16 + g;       // keys key and key + 8
      const uint32_t kb = kg * GROUP;
      // The keys' bias as the A fragment of the bias k-step: columns 0-2
      // of rows g and g + 8 are its three bf16 parts.
      uint32_t bf[4];
      {
        const uint4 b0 = split_bf16x3(bw[key]), b1 = split_bf16x3(bw[key + 8]);
        bf[0] = t == 0 ? b0.x : t == 1 ? b0.y : 0u;
        bf[1] = t == 0 ? b1.x : t == 1 ? b1.y : 0u;
        bf[2] = bf[3] = 0u;
      }
      const uint32_t k_term[2] = {row_seed + static_cast<uint32_t>(key) * kC2,
                                  row_seed + static_cast<uint32_t>(key + 8) * kC2};
      float dk[D / 2], dv[D / 2];
      float db[2] = {0.f, 0.f};

#pragma unroll
      for (int qg = 0; qg < 4; ++qg) {
        if (qg < ng) {
          const uint32_t qb = qg * GROUP;
          // s^T = bias + k qs^T and dp^T = v dO^T: rows are the group's
          // keys, columns the query group's queries.
          float s[32], dp[32];
          wgmma_fence();
          wgmma_rs<64, 0>(s, bf, desc_of(ones_lo, HI16), 0);
#pragma unroll
          for (int kk = 0; kk < KS; ++kk)
            wgmma_ss<64, 0, 0>(s, desc_of(k_lo + kb + 2 * kk, HI),
                               desc_of(q_lo + qb + 2 * kk, HI), 1);
#pragma unroll
          for (int kk = 0; kk < KS; ++kk)
            wgmma_ss<64, 0, 0>(dp, desc_of(v_lo + kb + 2 * kk, HI),
                               desc_of(do_lo + qb + 2 * kk, HI), kk > 0);
          wgmma_commit();
          wgmma_wait<0>();
          wgmma_pin(s);
          wgmma_pin(dp);

          // p, the mask, ds and pv at the TPU kernel's rounding points; the
          // hash of (key r, query 64 qg + 8 j + 2 t + e) is base[r] +
          // (8 j + e) C3.
          const uint32_t q_term = static_cast<uint32_t>(a.q_offset + qg * 64 + 2 * t) * kC3;
          const uint32_t base[2] = {k_term[0] + q_term, k_term[1] + q_term};
          uint32_t dsf[4][4], pvf[4][4];
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float2 nl = *reinterpret_cast<const float2*>(nls + qg * 64 + 8 * j + 2 * t);
            const float2 dl = *reinterpret_cast<const float2*>(dls + qg * 64 + 8 * j + 2 * t);
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

          // ds^T to the consumer's [64 keys][64 queries] tile (rows of 128
          // bytes, 128-byte swizzle) for dq: k-step kk's four 8x8 blocks are
          // (keys 0-7, queries 16 kk..), (keys 8-15, ..), (keys 0-7,
          // 16 kk + 8..), (keys 8-15, ..). The wgmma that read the tile last
          // is done: every warp of the warpgroup waited for it before the
          // products above, which start only once all four have issued them.
          {
            const int row = wq * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              const int chunk = 2 * kk + (lane >> 4);
              stmatrix_x4(dsb + row * 128 + ((chunk ^ (lane & 7)) << 4),
                          dsf[kk][0], dsf[kk][1], dsf[kk][2], dsf[kk][3]);
            }
          }
          fence_async_shared();
          named_barrier(1 + c, 128);

          // dv += pv^T dO, dk += ds^T qs over the query group; dq of the
          // query group += ds k over the key group.
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_rs<D, 1>(dv, pvf[kk], desc_of(do_lo + qb + kk * ROW16, HI),
                           qg > 0 || kk > 0);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_rs<D, 1>(dk, dsf[kk], desc_of(q_lo + qb + kk * ROW16, HI),
                           qg > 0 || kk > 0);
          float (&dqa)[D / 2] = dq[SMEM_DQ ? 0 : qg];
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_ss<D, 1, 1>(dqa, desc_of(ds_lo + kk * (2048 >> 4), kSw128DescHi),
                              desc_of(k_lo + kb + kk * ROW16, HI),
                              SMEM_DQ ? kk > 0 : kg > 0 || kk > 0);
          wgmma_commit();
          wgmma_wait<0>();
          wgmma_pin(dk);
          wgmma_pin(dv);
          wgmma_pin(dqa);
          wgmma_pin(dsf);
          wgmma_pin(pvf);
          if constexpr (SMEM_DQ) {
#pragma unroll
            for (int i = 0; i < D / 4; ++i) {
              const float2 was = *dq_at(qg, i);
              *dq_at(qg, i) = make_float2(dqa[2 * i] + (kg > 0 ? was.x : 0.f),
                                          dqa[2 * i + 1] + (kg > 0 ? was.y : 0.f));
            }
          }
        }
      }

      // dk, dv and dbias of the key group.
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float dbr = db[r];
        dbr += __shfl_xor_sync(0xffffffffu, dbr, 1);
        dbr += __shfl_xor_sync(0xffffffffu, dbr, 2);
        const long long at = static_cast<long long>(w) * W + key + 8 * r;
        bf16* dkrow = static_cast<bf16*>(a.dk) + at * D;
        bf16* dvrow = static_cast<bf16*>(a.dv) + at * D;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          *reinterpret_cast<uint32_t*>(dkrow + 8 * j + 2 * t) =
              pack_bf16(dk[4 * j + 2 * r], dk[4 * j + 2 * r + 1]);
          *reinterpret_cast<uint32_t*>(dvrow + 8 * j + 2 * t) =
              pack_bf16(dv[4 * j + 2 * r], dv[4 * j + 2 * r + 1]);
        }
        if (t == 0) a.dbias_bh[at] = dbr;
      }
    }
    mbar_arrive(&empty[st]);

    // dq, once: rounded to bf16, then times d^-1/2 in bf16 (the TPU
    // kernel's and the plain version's two roundings).
#pragma unroll
    for (int qg = 0; qg < 4; ++qg) {
      if (qg < ng) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const long long at = static_cast<long long>(w) * W + qg * 64 + wq * 16 + g + 8 * r;
          bf16* dqrow = static_cast<bf16*>(a.dq) + at * D;
#pragma unroll
          for (int j = 0; j < D / 8; ++j) {
            float2 x;
            if constexpr (SMEM_DQ) x = *dq_at(qg, 2 * j + r);
            else x = make_float2(dq[qg][4 * j + 2 * r], dq[qg][4 * j + 2 * r + 1]);
            const float x0 = __bfloat162float(__float2bfloat16_rn(x.x));
            const float x1 = __bfloat162float(__float2bfloat16_rn(x.y));
            *reinterpret_cast<uint32_t*>(dqrow + 8 * j + 2 * t) =
                pack_bf16(x0 * scale, x1 * scale);
          }
        }
      }
    }
  }
}

// flash_bwd_window  the fused backward at D 16 and 32 on the windowed fold
// (the file's head). The producer warp of a consumer loads each of its
// windows' Q, K, V and dO by TMA, writes -lse log2 e and delta =
// rowsum(f32(o) f32(dO)) (o and dO read from global memory, 16 bytes at a
// time, summed in order along the row), and scales q in place once it has
// landed.
template <int D, int DROP>
__global__ void __launch_bounds__(kWinThreads, 1)
flash_bwd_window(const LunarisK2WindowArgs a,
                 const __grid_constant__ K2WindowMaps maps) {
  static_assert(D == 16 || D == 32, "the window bodies take d 16 and 32");
  using bf16 = __nv_bfloat16;
  constexpr int ST = win_bwd_stages(D);
  constexpr int TILE = win_tile_bytes(D);
  constexpr int STAGE = win_bwd_stage_bytes(D);
  extern __shared__ uint8_t bwd_win_smem[];
  uint8_t* ring = align1024(bwd_win_smem);
  uint8_t* dsb = ring + kWinConsumers * ST * STAGE;
  uint8_t* ones = dsb + kWinConsumers * kWinDsBytes;
  float2* dqs = reinterpret_cast<float2*>(ones + kWinOnesBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(
      ones + kWinOnesBytes + kWinConsumers * win_dq_smem_bytes(D));
  uint64_t* empty = full + kWinConsumers * ST;
  uint64_t* landed = empty + kWinConsumers * ST;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;

  if (tid == 0) {
    for (int i = 0; i < kWinConsumers * ST; ++i) {
      mbar_init(&full[i], 32);
      mbar_init(&empty[i], 128);
      mbar_init(&landed[i], 1);
    }
    mbar_fence_init();
  }
  if (tid < 64) write_ones_row(ones, tid);
  fence_async_shared();            // the ones tile, for the consumers' wgmma
  __syncthreads();

  if (warp >= 4 * kWinConsumers) {
    setmaxnreg_dec<40>();
    const int c = warp - 4 * kWinConsumers;
    if (c >= kWinConsumers) return;
    const int W = a.W;
    uint8_t* mine = ring + c * ST * STAGE;
    for (int u = 0;; ++u) {
      const int w = win_of(c, u, a.BH);
      if (w < 0) break;
      const int st = u % ST;
      uint8_t* s = mine + st * STAGE;
      uint64_t* lb = &landed[c * ST + st];
      if (u >= ST) mbar_wait(&empty[c * ST + st], ((u / ST) & 1) ^ 1);
      if (lane == 0) {
        mbar_arrive_tx(lb, 4 * W * 2 * D);
        tma_load_3d(s, &maps.q, lb, 0, 0, w);
        tma_load_3d(s + TILE, &maps.k, lb, 0, 0, w);
        tma_load_3d(s + 2 * TILE, &maps.v, lb, 0, 0, w);
        tma_load_3d(s + 3 * TILE, &maps.dout, lb, 0, 0, w);
      }
      float* nls = reinterpret_cast<float*>(s + 4 * TILE);
      float* dls = nls + kWinMax;
      const long long at = static_cast<long long>(w) * W;
      const uint4* ob = reinterpret_cast<const uint4*>(static_cast<const bf16*>(a.o) + at * D);
      const uint4* dob = reinterpret_cast<const uint4*>(static_cast<const bf16*>(a.dout) + at * D);
      for (int r = lane; r < W; r += 32) {
        float acc = 0.f;
#pragma unroll 1
        for (int cc = 0; cc < D / 8; ++cc) {     // 16 bytes at a time: 40 registers
          const uint4 x = ob[r * (D / 8) + cc], y = dob[r * (D / 8) + cc];
          const uint32_t xs[4] = {x.x, x.y, x.z, x.w}, ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float2 xf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xs[i]));
            const float2 yf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ys[i]));
            acc = fmaf(xf.x, yf.x, acc);
            acc = fmaf(xf.y, yf.y, acc);
          }
        }
        dls[r] = acc;
        nls[r] = -a.lse[at + r] * kLog2e;
      }
      // q becomes qs in place, a 16-byte chunk at a time (the swizzle moves
      // chunks, not the values within them).
      mbar_wait(lb, (u / ST) & 1);
      uint4* chunk = reinterpret_cast<uint4*>(s);
#pragma unroll 1
      for (int cc = lane; cc < W * 2 * D / 16; cc += 32) {
        uint4 x = chunk[cc];
        x.x = scale_bf16x2(x.x, a.scale);
        x.y = scale_bf16x2(x.y, a.scale);
        x.z = scale_bf16x2(x.z, a.scale);
        x.w = scale_bf16x2(x.w, a.scale);
        chunk[cc] = x;
      }
      fence_async_shared();
      mbar_arrive(&full[c * ST + st]);
    }
  } else {
    setmaxnreg_inc<232>();
    const int c = warp >> 2;
    consume_bwd_window<D, DROP>(a, ring + c * ST * STAGE, dsb + c * kWinDsBytes,
                                ones, dqs + c * win_dq_smem_bytes(D) / 8,
                                full + c * ST, empty + c * ST, c);
  }
}

// ---- launches ---------------------------------------------------------------

// One block an SM, or one a window where the call has fewer.
inline int win_grid(int BH) {
  static const int sms = [] {
    int dev = 0, n = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      n = 132;
    return n;
  }();
  return BH < sms ? BH : sms;
}

// The shapes both bodies take, the alignment TMA and the 16-byte reads need,
// and the tensor maps: a box of W rows a window for the backward, of
// kWinMax for the forward (rows past W arrive as zeros).
inline bool win_prepare(const LunarisK2WindowArgs& a, int d, bool backward,
                        K2WindowMaps* maps) {
  const auto misaligned = [](const void* p, uintptr_t n) {
    return reinterpret_cast<uintptr_t>(p) % n != 0;
  };
  if (a.BH <= 0 || a.H <= 0 || a.W < 64 || a.W > kWinMax || a.W % 64 != 0 ||
      misaligned(a.q, 16) || misaligned(a.k, 16) || misaligned(a.v, 16) ||
      misaligned(a.o, backward ? 16 : 4))
    return false;
  if (backward && (misaligned(a.dout, 16) || misaligned(a.dq, 4) ||
                   misaligned(a.dk, 4) || misaligned(a.dv, 4)))
    return false;
  const int box = backward ? a.W : kWinMax;
  return bf16_narrow_tile_map(&maps->q, a.q, a.BH, a.W, d, box) &&
         bf16_narrow_tile_map(&maps->k, a.k, a.BH, a.W, d, box) &&
         bf16_narrow_tile_map(&maps->v, a.v, a.BH, a.W, d, box) &&
         (!backward || bf16_narrow_tile_map(&maps->dout, a.dout, a.BH, a.W, d, box));
}

template <int D, int DROP>
int launch_fwd_window(const LunarisK2WindowArgs& a, cudaStream_t stream) {
  K2WindowMaps maps{};
  if (!win_prepare(a, D, false, &maps)) return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = flash_fwd_window<D, DROP>;
  constexpr int smem = win_fwd_smem_bytes(D);
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<win_grid(a.BH), kWinThreads, smem, stream>>>(a, maps);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int DROP>
int launch_bwd_window(const LunarisK2WindowArgs& a, cudaStream_t stream) {
  K2WindowMaps maps{};
  if (!win_prepare(a, D, true, &maps)) return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = flash_bwd_window<D, DROP>;
  constexpr int smem = win_bwd_smem_bytes(D);
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<win_grid(a.BH), kWinThreads, smem, stream>>>(a, maps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
