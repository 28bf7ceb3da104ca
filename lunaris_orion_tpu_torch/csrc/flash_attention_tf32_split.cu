// K2 -- the pre-pass of the f32 warpgroup bodies flash_fwd_wgmma_tf32 and
// flash_bwd_wgmma_tf32 (d 16, 32, 48, 64): the operands of a call split into
// TF32 hi and lo and laid out as their wgmma read them
// (flash_attention_common.cuh, "the TF32 tiles"). Part of the port of
// lunaris_orion_tpu/ops/pallas/flash_attention.py `_fwd_kernel` and
// `_bwd_fused_kernel`: the TPU kernels take f32 operands as they are, and so
// does the plain version; here the tensor cores' three TF32 passes need each
// operand as hi + lo, and wgmma reads them from shared memory K-major only,
// so the transposed operands (V^T, qs^T, dO^T, K^T) are written here too.
// Once a call, instead of once for every block that reads a tile.
//
// Bound: bytes. It reads the operands once and writes each twice (hi, lo)
// or four times (the forward's V, the backward's q and dO, and at d 32, 48
// and 64 its K: rows and transposed), about 0.3 ms at B16 H8 N16384 d 16 on an
// H100. A thread takes one element at a time: reads are coalesced, writes
// land in one tile of 8 to 131 KB, which the L2 cache gathers.

#include "flash_attention_common.cuh"

namespace {

constexpr int kSplitThreads = 256;
constexpr int kSplitFwd = 0;     // k, v -> tf32_fwd_tile_bytes a key tile
constexpr int kSplitBwdQ = 1;    // q, dO, lse, delta -> tf32_bwd_q_tile_bytes
constexpr int kSplitBwdK = 2;    // k (and v at d 32-64) -> tf32_bwd_k_tile_bytes

template <int MODE, int D>
__host__ __device__ constexpr int split_tile_bytes() {
  return MODE == kSplitFwd ? tf32_fwd_tile_bytes(D)
         : MODE == kSplitBwdQ ? tf32_bwd_q_tile_bytes(D) : tf32_bwd_k_tile_bytes(D);
}

__device__ __forceinline__ void put(uint8_t* tile, int off, uint32_t bits) {
  *reinterpret_cast<uint32_t*>(tile + off) = bits;
}

// Element (r, d) of R rows as a row pair (hi at `base`, lo 4 R D bytes on):
// [R][8] tiles of d 0-7, 8-15, .., 32-byte swizzle.
template <int R, int D>
__device__ __forceinline__ void put_rows(uint8_t* tile, int base, int r, int d,
                                         float x) {
  uint32_t hi, lo;
  split_tf32(x, hi, lo);
  const int off = base + (d >> 3) * (32 * R) + sw32_offset(r, d & 7);
  put(tile, off, hi);
  put(tile, off + 4 * R * D, lo);
}

// The same element transposed into rows (hi at `base`, lo 4 R D bytes on):
// row d of the [D][8] tile of k-step r / 8, at column `col` % 8.
template <int R, int D>
__device__ __forceinline__ void put_trows(uint8_t* tile, int base, int r, int d,
                                          int col, float x) {
  uint32_t hi, lo;
  split_tf32(x, hi, lo);
  const int off = base + (r >> 3) * (32 * D) + sw32_offset(d, col & 7);
  put(tile, off, hi);
  put(tile, off + 4 * R * D, lo);
}

// The same element transposed into atoms: row d (hi) and D + d (lo) of the
// [2 D][32] atom of key r / 32, at column `col`.
template <int D>
__device__ __forceinline__ void put_cols(uint8_t* tile, int base, int r, int d,
                                         int col, float x) {
  uint32_t hi, lo;
  split_tf32(x, hi, lo);
  const int atom = base + (r >> 5) * (256 * D);
  put(tile, atom + sw128_offset(d, col & 31), hi);
  put(tile, atom + sw128_offset(D + d, col & 31), lo);
}

template <int MODE, int D>
__global__ void __launch_bounds__(kSplitThreads)
k2_tf32_split(const float* a, const float* b, const float* lse,
              const float* delta, uint8_t* out, int N, float scale) {
  constexpr int R = kTf32Rows;
  constexpr int S = kTf32SubRows;
  const int tile = blockIdx.x, bh = blockIdx.y;
  uint8_t* t = out + (static_cast<long long>(bh) * gridDim.x + tile) *
                         split_tile_bytes<MODE, D>();
  for (int e = threadIdx.x; e < R * D; e += kSplitThreads) {
    const int r = e / D, d = e % D;
    const int row = tile * R + r;
    const bool in = row < N;
    const long long src = (static_cast<long long>(bh) * N + (in ? row : 0)) * D + d;
    const float x = in ? a[src] : 0.f;
    if (MODE == kSplitFwd) {
      put_rows<R, D>(t, 0, r, d, x);
      put_cols<D>(t, 512 * D, r, d, perm8(r), in ? b[src] : 0.f);
    } else if (MODE == kSplitBwdQ) {
      const float qs = x * scale;
      const float y = in ? b[src] : 0.f;
      if (D == 16) {
        put_rows<R, D>(t, 0, r, d, qs);
        put_rows<R, D>(t, 8192, r, d, y);
        put_cols<D>(t, 16384, r, d, perm8(r), qs);
        put_cols<D>(t, 24576, r, d, perm8(r), y);
      } else {
        const int base = (r / S) * tf32_bwd_sub_bytes(D), rs = r % S;
        put_rows<S, D>(t, base, rs, d, qs);
        put_rows<S, D>(t, base + 128 * D, rs, d, y);
        put_trows<S, D>(t, base + 256 * D, rs, d, perm8(rs), qs);
        put_trows<S, D>(t, base + 384 * D, rs, d, perm8(rs), y);
      }
    } else if (D == 16) {
      put_cols<D>(t, 0, r, d, r, x);
    } else {
      put_rows<R, D>(t, 0, r, d, x);
      put_rows<R, D>(t, 512 * D, r, d, in ? b[src] : 0.f);
      put_trows<R, D>(t, 1024 * D, r, d, r, x);
    }
  }
  if (MODE == kSplitBwdQ)
    for (int r = threadIdx.x; r < R; r += kSplitThreads) {
      const int row = tile * R + r;
      const long long i = static_cast<long long>(bh) * N + row;
      // -lse log2 e and delta: after the tile (d 16) or each sub-tile.
      float* f = reinterpret_cast<float*>(
          t + (D == 16 ? 2048 * D : (r / S) * tf32_bwd_sub_bytes(D) + 512 * D));
      const int n = D == 16 ? R : S, j = D == 16 ? r : r % S;
      f[j] = row < N ? -lse[i] * kLog2e : -INFINITY;
      f[n + j] = row < N ? delta[i] : 0.f;
    }
}

template <int MODE, int D>
int launch_split(const void* a, const void* b, const void* lse,
                 const void* delta, void* out, int BH, int N, float scale,
                 cudaStream_t stream) {
  // The backward's key tiles go in pairs (at d 16 a block takes two).
  const int tiles = MODE == kSplitBwdK ? 2 * ((N + 2 * kTf32Rows - 1) / (2 * kTf32Rows))
                                       : (N + kTf32Rows - 1) / kTf32Rows;
  const dim3 grid(tiles, BH);
  k2_tf32_split<MODE, D><<<grid, kSplitThreads, 0, stream>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<uint8_t*>(out), N, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_split_mode(int mode, const void* a, const void* b, const void* lse,
                      const void* delta, void* out, int BH, int N, float scale,
                      cudaStream_t s) {
  switch (mode) {
    case kSplitFwd: return launch_split<kSplitFwd, D>(a, b, lse, delta, out, BH, N, scale, s);
    case kSplitBwdQ: return launch_split<kSplitBwdQ, D>(a, b, lse, delta, out, BH, N, scale, s);
    case kSplitBwdK: return launch_split<kSplitBwdK, D>(a, b, lse, delta, out, BH, N, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// mode 0: a = k, b = v [BH, N, d] f32 -> out, ceil(N / 64) key tiles of
// tf32_fwd_tile_bytes(d) a BH row. mode 1: a = q, b = dO [BH, N, d], lse and
// delta [BH, N] f32, scale d^-1/2 -> ceil(N / 64) query tiles of
// tf32_bwd_q_tile_bytes(d). mode 2: a = k (and b = v at d 32, 48, 64) ->
// 2 ceil(N / 128) key tiles of tf32_bwd_k_tile_bytes(d). d: 16, 32, 48 or 64.
// out is 16-byte aligned and holds BH x tiles x the tile bytes. Returns the
// cudaError_t of the launch.
extern "C" int lunaris_k2_tf32_split(int mode, const void* a, const void* b,
                                     const void* lse, const void* delta,
                                     void* out, int BH, int N, int d,
                                     float scale, void* stream) {
  if (BH <= 0 || BH > 65535 || N <= 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16: return launch_split_mode<16>(mode, a, b, lse, delta, out, BH, N, scale, s);
    case 32: return launch_split_mode<32>(mode, a, b, lse, delta, out, BH, N, scale, s);
    case 48: return launch_split_mode<48>(mode, a, b, lse, delta, out, BH, N, scale, s);
    case 64: return launch_split_mode<64>(mode, a, b, lse, delta, out, BH, N, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
