// K2 -- the pre-pass of the f32 warpgroup bodies flash_fwd_wgmma_tf32 and
// flash_bwd_wgmma_tf32 (d 16): the operands of a call split into TF32 hi
// and lo and laid out as their wgmma read them (flash_attention_common.cuh,
// "the TF32 tiles"). Part of the port of lunaris_orion_tpu/ops/pallas/
// flash_attention.py `_fwd_kernel` and `_bwd_fused_kernel`: the TPU kernels
// take f32 operands as they are, and so does the plain version; here the
// tensor cores' three TF32 passes need each operand as hi + lo, and wgmma
// reads them from shared memory K-major only, so the transposed operands
// (V^T, qs^T, dO^T, K^T) are written here too. Once a call, instead of once
// for every block that reads a tile.
//
// Bound: bytes. It reads the operands once and writes each twice (hi, lo)
// or four times (the forward's V, the backward's q and dO: rows and
// transposed), about 0.3 ms at B16 H8 N16384 on an H100. A thread takes one
// element at a time: reads are coalesced, writes land in one tile of 8 to
// 33 KB, which the L2 cache gathers.

#include "flash_attention_common.cuh"

namespace {

constexpr int kSplitThreads = 256;
constexpr int kSplitFwd = 0;     // k, v -> kTf32FwdTileBytes a key tile
constexpr int kSplitBwdQ = 1;    // q, dO, lse, delta -> kTf32BwdQTileBytes
constexpr int kSplitBwdK = 2;    // k -> kTf32BwdKTileBytes

template <int MODE>
__host__ __device__ constexpr int split_tile_bytes() {
  return MODE == kSplitFwd ? kTf32FwdTileBytes
         : MODE == kSplitBwdQ ? kTf32BwdQTileBytes : kTf32BwdKTileBytes;
}

__device__ __forceinline__ void put(uint8_t* tile, int off, uint32_t bits) {
  *reinterpret_cast<uint32_t*>(tile + off) = bits;
}

// Element (r, d) of a tile as a row-major pair (hi at `base`, lo at base +
// 4096): [64][8] tiles of d 0-7 and 8-15, 32-byte swizzle.
__device__ __forceinline__ void put_rows(uint8_t* tile, int base, int r, int d,
                                         float x) {
  uint32_t hi, lo;
  split_tf32(x, hi, lo);
  const int off = base + (d >> 3) * 2048 + sw32_offset(r, d & 7);
  put(tile, off, hi);
  put(tile, off + 4096, lo);
}

// The same element transposed: row d (hi) and 16 + d (lo) of the [32][32]
// atom of key r / 32, at column `col`.
__device__ __forceinline__ void put_cols(uint8_t* tile, int base, int r, int d,
                                         int col, float x) {
  uint32_t hi, lo;
  split_tf32(x, hi, lo);
  const int atom = base + (r >> 5) * 4096;
  put(tile, atom + sw128_offset(d, col & 31), hi);
  put(tile, atom + sw128_offset(16 + d, col & 31), lo);
}

template <int MODE>
__global__ void __launch_bounds__(kSplitThreads)
k2_tf32_split(const float* a, const float* b, const float* lse,
              const float* delta, uint8_t* out, int N, float scale) {
  constexpr int D = 16;
  const int tile = blockIdx.x, bh = blockIdx.y;
  uint8_t* t = out + (static_cast<long long>(bh) * gridDim.x + tile) *
                         split_tile_bytes<MODE>();
  for (int e = threadIdx.x; e < kTf32Rows * D; e += kSplitThreads) {
    const int r = e / D, d = e % D;
    const int row = tile * kTf32Rows + r;
    const bool in = row < N;
    const long long src = (static_cast<long long>(bh) * N + (in ? row : 0)) * D + d;
    const float x = in ? a[src] : 0.f;
    if (MODE == kSplitFwd) {
      put_rows(t, 0, r, d, x);
      put_cols(t, 8192, r, d, perm8(r), in ? b[src] : 0.f);
    } else if (MODE == kSplitBwdQ) {
      const float qs = x * scale;
      const float y = in ? b[src] : 0.f;
      put_rows(t, 0, r, d, qs);
      put_rows(t, 8192, r, d, y);
      put_cols(t, 16384, r, d, perm8(r), qs);
      put_cols(t, 24576, r, d, perm8(r), y);
    } else {
      put_cols(t, 0, r, d, r, x);
    }
  }
  if (MODE == kSplitBwdQ)
    for (int r = threadIdx.x; r < kTf32Rows; r += kSplitThreads) {
      const int row = tile * kTf32Rows + r;
      const long long i = static_cast<long long>(bh) * N + row;
      float* f = reinterpret_cast<float*>(t + 32768);
      f[r] = row < N ? -lse[i] * kLog2e : -INFINITY;
      f[kTf32Rows + r] = row < N ? delta[i] : 0.f;
    }
}

template <int MODE>
int launch_split(const void* a, const void* b, const void* lse,
                 const void* delta, void* out, int BH, int N, float scale,
                 cudaStream_t stream) {
  // The backward's key tiles go in pairs, one a consumer warpgroup of a block.
  const int tiles = MODE == kSplitBwdK ? 2 * ((N + 2 * kTf32Rows - 1) / (2 * kTf32Rows))
                                       : (N + kTf32Rows - 1) / kTf32Rows;
  const dim3 grid(tiles, BH);
  k2_tf32_split<MODE><<<grid, kSplitThreads, 0, stream>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<uint8_t*>(out), N, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// mode 0: a = k, b = v [BH, N, 16] f32 -> out, ceil(N / 64) key tiles of
// kTf32FwdTileBytes a BH row. mode 1: a = q, b = dO [BH, N, 16], lse and
// delta [BH, N] f32, scale d^-1/2 -> ceil(N / 64) query tiles of
// kTf32BwdQTileBytes. mode 2: a = k -> 2 ceil(N / 128) key tiles of
// kTf32BwdKTileBytes. out is 16-byte aligned and holds BH x tiles x the tile
// bytes. Returns the cudaError_t of the launch.
extern "C" int lunaris_k2_tf32_split(int mode, const void* a, const void* b,
                                     const void* lse, const void* delta,
                                     void* out, int BH, int N, int d,
                                     float scale, void* stream) {
  if (BH <= 0 || BH > 65535 || N <= 0 || d != 16 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kSplitFwd: return launch_split<kSplitFwd>(a, b, lse, delta, out, BH, N, scale, s);
    case kSplitBwdQ: return launch_split<kSplitBwdQ>(a, b, lse, delta, out, BH, N, scale, s);
    case kSplitBwdK: return launch_split<kSplitBwdK>(a, b, lse, delta, out, BH, N, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
