// K5 -- GroupNorm-apply + Mish + conv3x3 ("same") on the tensor cores, bf16,
// for Hopper (sm_90a): the body `lunaris_gn_mish_conv3` (fused_stage.cu)
// launches for bf16 activations.
//
// Replaces lunaris_orion_tpu/ops/pallas/fused_stage.py `_kernel` and
// computes what fused_stage.cu's CUDA-core body computes, with the same
// rounding points:
//
//   g   = bf16(mish(bf16(f32(y) * alpha[b, c] + beta[b, c])))
//   out = bf16(conv3x3_same(g, w) + wb)
//
// g and w are bf16, so each product is exact in f32 and only the order of
// the 9 * Cin-term sums differs from the plain version.
//
// Bound: at the tool's shape ([128, 128, 128, 64] -> 64) bytes and
// tensor-core operations tie (about 0.16 ms each); the mish of every halo
// element (about 70 instructions on the CUDA cores and MUFU) costs as much
// again. The design is an implicit GEMM: rows are output pixels, columns are
// Cout (32 or 64), depth is 9 taps x Cin. One block of 8 warps owns a 16 x 16
// tile of output pixels of one image; warp w owns tile rows 2w and 2w + 1
// (two m16 tiles of 16 pixels) x Cout in f32 registers. Cin is walked in
// chunks of 16, the mma's k:
//   - the chunk's 18 x 18 x 16 halo of y and its [9][16][Cout] weights are
//     copied into shared memory by 16-byte cp.async, double-buffered, so the
//     next chunk's copy runs under this chunk's work;
//   - every thread applies alpha, beta and mish_f32 to its 8-channel pieces
//     of the halo in place and rounds them to bf16; pixels outside the image
//     are written as 0, so the padding is zero after mish;
//   - a tap (dy, dx) is then an offset into the halo tile: the A fragments
//     come from ldmatrix at the shifted pixels, the B fragments from the
//     weights by ldmatrix.trans; mma.sync.m16n8k16 sums the chunk's 9 x 16
//     products from zero, and the f32 totals take them in one rounded add.
// Halo pixels are 48 bytes apart (16 channels + 16 bytes of padding) and
// weight rows (Cout + 8) * 2 bytes, so the 8 rows of each ldmatrix matrix fall
// on distinct banks. A Cin that is not a multiple of 16 ends with a half
// chunk whose upper 8 channels are zero in both operands. The TPU kernel's
// three width-shifted copies and its one-band lag served the TPU's matrix
// unit and its sequential grid; here blocks run in parallel and two blocks an
// SM overlap one block's mish with the other's products.
//
// f32 activations stay on the CUDA-core body: TF32 products would miss the
// f32 bar (2e-5).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "flash_attention_common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kTH = 16;                       // output tile rows
constexpr int kTW = 16;                       // output tile columns (one m16)
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kCK = 16;                       // channels a chunk: the mma's k
constexpr int kHR = kTH + 2;                  // halo rows
constexpr int kHC = kTW + 2;                  // halo columns
constexpr int kHaloPix = kHR * kHC;
constexpr int kPix = kCK + 8;                 // bf16 a halo pixel, padded
constexpr int kHaloElems = kHaloPix * kPix;

template <int COUT> __host__ __device__ constexpr int w_row() {
  return COUT + 8;
}
template <int COUT> __host__ __device__ constexpr int stage_elems() {
  return kHaloElems + 9 * kCK * w_row<COUT>();
}
template <int COUT> constexpr int smem_bytes() {
  return 2 * stage_elems<COUT>() * static_cast<int>(sizeof(bf16));
}

// Start the copies of chunk ci0 (nch = 8 or 16 channels) into one stage:
// the halo as 16-byte halves of pixels (zero-filled outside the image and
// past nch), then the [9][16][Cout] weights (zero-filled past nch).
template <int COUT>
__device__ __forceinline__ void load_chunk(bf16* st, const bf16* yb,
                                           const bf16* w, int r0, int c0,
                                           int H, int W, int Cin, int ci0,
                                           int nch) {
  for (int u = threadIdx.x; u < 2 * kHaloPix; u += kThreads) {
    const int pix = u >> 1, half = u & 1;
    const int r = r0 - 1 + pix / kHC, c = c0 - 1 + pix % kHC;
    const bool ok = r >= 0 && r < H && c >= 0 && c < W && half * 8 < nch;
    const bf16* src =
        ok ? yb + (static_cast<long long>(r) * W + c) * Cin + ci0 + half * 8
           : yb;
    cp_async_16(st + pix * kPix + half * 8, src, ok ? 16 : 0);
  }
  constexpr int units = COUT / 8;
  bf16* ws = st + kHaloElems;
  for (int u = threadIdx.x; u < 9 * kCK * units; u += kThreads) {
    const int row = u / units, cu = u % units;
    const int tap = row / kCK, k = row % kCK;
    const bool ok = k < nch;
    const bf16* src =
        ok ? w + (static_cast<long long>(tap) * Cin + ci0 + k) * COUT + cu * 8
           : w;
    cp_async_16(ws + row * w_row<COUT>() + cu * 8, src, ok ? 16 : 0);
  }
  cp_async_commit();
}

// g = bf16(mish(bf16(x * alpha + beta))) on the chunk's halo, in place; 0
// outside the image and past nch. Multiply and add are rounded separately,
// as in the CUDA-core body and the plain version.
__device__ __forceinline__ void mish_halo(bf16* st, const float* ab,
                                          const float* bb, int r0, int c0,
                                          int H, int W, int ci0, int nch) {
  const int half = threadIdx.x & 1;          // kThreads is even: fixed
  float a[8], s[8];
  const bool live = half * 8 < nch;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    a[i] = live ? ab[ci0 + half * 8 + i] : 0.f;
    s[i] = live ? bb[ci0 + half * 8 + i] : 0.f;
  }
  for (int u = threadIdx.x; u < 2 * kHaloPix; u += kThreads) {
    const int pix = u >> 1;
    const int r = r0 - 1 + pix / kHC, c = c0 - 1 + pix % kHC;
    uint4* p = reinterpret_cast<uint4*>(st + pix * kPix + half * 8);
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (live && r >= 0 && r < H && c >= 0 && c < W) {
      uint32_t wd[4] = {p->x, p->y, p->z, p->w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float g[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          // A bf16 is the upper half of an f32.
          const float x = __uint_as_float(j ? wd[i] & 0xFFFF0000u : wd[i] << 16);
          const float n = round_to<bf16>(
              __fadd_rn(__fmul_rn(x, a[2 * i + j]), s[2 * i + j]));
          g[j] = mish_f32(n);
        }
        wd[i] = pack_bf16(g[0], g[1]);
      }
      v = make_uint4(wd[0], wd[1], wd[2], wd[3]);
    }
    *p = v;
  }
}

// Each chunk's 9 x 16 products are summed from zero in the mma and added to
// the f32 totals with one rounded add: the tensor cores' f32 sums truncate,
// and with all 9 * Cin products in the accumulators the share of outputs
// that round the other way grows with Cin. The chunk is taken one pair of
// n8 tiles at a time, so that its partial takes 16 registers and two
// blocks fit an SM.
template <int COUT>
__global__ void __launch_bounds__(kThreads, 2)
gn_mish_conv3_mma(const bf16* __restrict__ y, const float* __restrict__ alpha,
                  const float* __restrict__ beta, const bf16* __restrict__ w,
                  const bf16* __restrict__ wb, bf16* __restrict__ out, int H,
                  int W, int Cin) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  constexpr int NT = COUT / 8;                // n8 tiles
  constexpr int WR = w_row<COUT>();

  const int b = blockIdx.z;
  const int r0 = blockIdx.y * kTH;
  const int c0 = blockIdx.x * kTW;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const bf16* yb = y + static_cast<long long>(b) * H * W * Cin;
  const float* ab = alpha + static_cast<long long>(b) * Cin;
  const float* bb = beta + static_cast<long long>(b) * Cin;
  const int chunks = (Cin + kCK - 1) / kCK;

  float acc[2][NT][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][n][i] = 0.f;

  // ldmatrix addresses within a stage. A (x4): lane l gives halo pixel
  // (row, column l % 16) at channels 8 (l / 16) ..; B (x4.trans): weight row
  // k = l % 8 + 8 ((l / 8) % 2) at columns 8 (l / 16) ...
  const int a_off = (2 * warp * kHC + (lane & 15)) * kPix + (lane >> 4) * 8;
  const int b_off =
      kHaloElems + ((lane & 7) + ((lane >> 3) & 1) * 8) * WR + (lane >> 4) * 8;

  load_chunk<COUT>(smem, yb, w, r0, c0, H, W, Cin, 0, min(kCK, Cin));
  for (int ch = 0; ch < chunks; ++ch) {
    bf16* st = smem + (ch & 1) * stage_elems<COUT>();
    const int ci0 = ch * kCK;
    cp_async_wait<0>();
    __syncthreads();       // chunk ch has landed; chunk ch - 1 is consumed
    if (ch + 1 < chunks)
      load_chunk<COUT>(smem + ((ch + 1) & 1) * stage_elems<COUT>(), yb, w, r0,
                       c0, H, W, Cin, ci0 + kCK, min(kCK, Cin - ci0 - kCK));
    mish_halo(st, ab, bb, r0, c0, H, W, ci0, min(kCK, Cin - ci0));
    __syncthreads();

#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      // Memory-ordering points between n pairs and between taps: without
      // them ptxas loads the fragments of later taps early and keeps the 12
      // distinct A fragments of the chunk live across the n pairs (48
      // registers), and spills at the 128 that two blocks an SM allow.
      if (np > 0) __syncwarp();
      float part[2][2][4];
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        if (tap > 0) __syncwarp();
        const int dy = tap / 3, dx = tap % 3;
        uint32_t af[2][4], bf[4];
#pragma unroll
        for (int m = 0; m < 2; ++m)
          ldmatrix_x4(af[m], st + a_off + ((m + dy) * kHC + dx) * kPix);
        ldmatrix_x4_trans(bf, st + b_off + tap * kCK * WR + np * 16);
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            if (tap == 0)
              mma_bf16(part[m][j], af[m], bf[2 * j], bf[2 * j + 1], 0.f, 0.f,
                       0.f, 0.f);
            else
              mma_bf16(part[m][j], af[m], bf[2 * j], bf[2 * j + 1]);
          }
      }
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[m][2 * np + j][i] += part[m][j][i];
    }
  }

  // Fragment (g, 2t..) and (g + 8, 2t..) of n8 tile n: pixels g and g + 8 of
  // the m tile's row, output channels 8n + 2t and 8n + 2t + 1.
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const int r = r0 + 2 * warp + m;
    if (r >= H) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int c = c0 + g + 8 * half;
      if (c >= W) continue;
      bf16* orow = out + ((static_cast<long long>(b) * H + r) * W + c) * COUT;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int co = 8 * n + 2 * t;
        *reinterpret_cast<uint32_t*>(orow + co) =
            pack_bf16(acc[m][n][2 * half] + __bfloat162float(wb[co]),
                      acc[m][n][2 * half + 1] + __bfloat162float(wb[co + 1]));
      }
    }
  }
}

template <int COUT>
int launch(const void* y, const float* alpha, const float* beta, const void* w,
           const void* wb, void* out, int B, int H, int W, int Cin,
           cudaStream_t stream) {
  const auto kernel = gn_mish_conv3_mma<COUT>;
  constexpr int smem = smem_bytes<COUT>();
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((W + kTW - 1) / kTW, (H + kTH - 1) / kTH, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(y), alpha, beta, static_cast<const bf16*>(w),
      static_cast<const bf16*>(wb), static_cast<bf16*>(out), H, W, Cin);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The tensor-core body of lunaris_gn_mish_conv3 (bf16 only): the same
// arguments; y and w 16-byte aligned.
int lunaris_gn_mish_conv3_mma(const void* y, const float* alpha,
                              const float* beta, const void* w, const void* wb,
                              void* out, int B, int H, int W, int Cin,
                              int Cout, cudaStream_t stream) {
  if (Cin % 8 != 0 || (H + kTH - 1) / kTH > 65535 ||
      reinterpret_cast<uintptr_t>(y) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (Cout) {
    case 32:
      return launch<32>(y, alpha, beta, w, wb, out, B, H, W, Cin, stream);
    case 64:
      return launch<64>(y, alpha, beta, w, wb, out, B, H, W, Cin, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
