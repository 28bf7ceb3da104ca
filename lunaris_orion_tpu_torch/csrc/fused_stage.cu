// K5 -- GroupNorm-apply + Mish + conv3x3 ("same") over NHWC activations in
// one kernel, for Hopper (sm_90a).
//
// Replaces lunaris_orion_tpu/ops/pallas/fused_stage.py `_kernel` (launched by
// `gn_mish_conv3_pallas`; oracle `gn_mish_conv3_reference`).
//
//   g   = mish(round_T(f32(y) * alpha[b, c] + beta[b, c]))     rounded to T
//   out = round_T(conv3x3_same(g, w) + wb)                     f32 accumulation
//
// T is y's type (f32 or bf16). Rounding points are the TPU kernel's: the
// affine is rounded to T before mish, mish runs in f32 on the rounded value
// and is rounded to T again, w and wb arrive already cast to T, products and
// sums are f32, and the result is cast once. The 1-pixel halo is zero AFTER
// mish: a padded pixel contributes 0, not mish(beta).
//
// Layout: y [B, H, W, Cin], out [B, H, W, Cout], w [3, 3, Cin, Cout]
// (HWIO), alpha/beta [B, Cin] f32, wb [Cout] in T.
//
// This file holds the CUDA-core body, which f32 takes, and the C entry,
// which picks a body (`body`): bf16 goes to the tensor-core body in
// fused_stage_mma.cu; "simt" reaches this one for bf16 too, so that the two
// can be compared.
//
// Bound: at the measured shape (B 128, 128 x 128, 64 -> 64, bf16) bytes and
// tensor-core operations tie (about 0.16 ms each). This body runs on the
// CUDA cores and is bound by their f32 FMA rate and by the shared-memory
// reads that feed it. Here one block owns an 8 x 32 tile of output pixels of
// one image, one pixel per thread, with all Cout accumulators in registers.
// Cin is walked in chunks of 8: the block stages the chunk's normalised +
// mish'd 10 x 34 halo tile channel-major in shared memory (so a warp's 32
// pixels read consecutive words) and the chunk's 9 x 8 x Cout weights, which
// every thread reads at the same address (a broadcast), four at a time.
// Ragged H and W are masked.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kTH = 8;
constexpr int kTW = 32;
constexpr int kThreads = kTH * kTW;
constexpr int kCK = 8;

// Two blocks an SM: without the cap the Cout = 64 kernel takes 130 registers
// a thread, and one block of 8 warps cannot hide the shared-memory reads.
template <typename T, int COUT>
__global__ void __launch_bounds__(kThreads, 2)
gn_mish_conv3(const T* __restrict__ y, const float* __restrict__ alpha,
              const float* __restrict__ beta, const T* __restrict__ w,
              const T* __restrict__ wb, T* __restrict__ out, int H, int W,
              int Cin) {
  __shared__ float gs[kCK][kTH + 2][kTW + 2];
  __shared__ __align__(16) float ws[9][kCK][COUT];

  const int b = blockIdx.z;
  const int r0 = blockIdx.y * kTH;
  const int c0 = blockIdx.x * kTW;
  const int pr = threadIdx.x / kTW;
  const int pc = threadIdx.x % kTW;
  const T* yb = y + static_cast<long long>(b) * H * W * Cin;
  const float* ab = alpha + static_cast<long long>(b) * Cin;
  const float* bb = beta + static_cast<long long>(b) * Cin;

  float acc[COUT];
#pragma unroll
  for (int co = 0; co < COUT; ++co) acc[co] = 0.f;

  for (int ci0 = 0; ci0 < Cin; ci0 += kCK) {
    __syncthreads();
    // The chunk's halo tile: channel fastest in the index, so a thread group
    // reads kCK consecutive channels of one pixel.
    for (int i = threadIdx.x; i < kCK * (kTH + 2) * (kTW + 2); i += kThreads) {
      const int ck = i % kCK;
      const int pix = i / kCK;
      const int tc = pix % (kTW + 2);
      const int tr = pix / (kTW + 2);
      const int r = r0 + tr - 1;
      const int c = c0 + tc - 1;
      float g = 0.f;
      if (r >= 0 && r < H && c >= 0 && c < W) {
        const int ci = ci0 + ck;
        const float x = to_f32(yb[(static_cast<long long>(r) * W + c) * Cin + ci]);
        // Multiply and add rounded separately, as the plain version does.
        const float n = round_to<T>(__fadd_rn(__fmul_rn(x, ab[ci]), bb[ci]));
        g = round_to<T>(mish_f32(n));
      }
      gs[ck][tr][tc] = g;
    }
    for (int i = threadIdx.x; i < 9 * kCK * COUT; i += kThreads) {
      const int co = i % COUT;
      const int ck = (i / COUT) % kCK;
      const int tap = i / (COUT * kCK);
      ws[tap][ck][co] =
          to_f32(w[(static_cast<long long>(tap) * Cin + ci0 + ck) * COUT + co]);
    }
    __syncthreads();

#pragma unroll 1
    for (int ck = 0; ck < kCK; ++ck) {
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const float g = gs[ck][pr + tap / 3][pc + tap % 3];
        const float4* wrow = reinterpret_cast<const float4*>(ws[tap][ck]);
#pragma unroll
        for (int c4 = 0; c4 < COUT / 4; ++c4) {
          const float4 wv = wrow[c4];
          acc[4 * c4 + 0] = fmaf(g, wv.x, acc[4 * c4 + 0]);
          acc[4 * c4 + 1] = fmaf(g, wv.y, acc[4 * c4 + 1]);
          acc[4 * c4 + 2] = fmaf(g, wv.z, acc[4 * c4 + 2]);
          acc[4 * c4 + 3] = fmaf(g, wv.w, acc[4 * c4 + 3]);
        }
      }
    }
  }

  const int r = r0 + pr;
  const int c = c0 + pc;
  if (r < H && c < W) {
    T* orow = out + ((static_cast<long long>(b) * H + r) * W + c) * COUT;
#pragma unroll
    for (int co = 0; co < COUT; ++co)
      orow[co] = from_f32<T>(acc[co] + to_f32(wb[co]));
  }
}

template <typename T, int COUT>
int launch(const void* y, const float* alpha, const float* beta, const void* w,
           const void* wb, void* out, int B, int H, int W, int Cin,
           cudaStream_t stream) {
  const dim3 grid((W + kTW - 1) / kTW, (H + kTH - 1) / kTH, B);
  gn_mish_conv3<T, COUT><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(y), alpha, beta, static_cast<const T*>(w),
      static_cast<const T*>(wb), static_cast<T*>(out), H, W, Cin);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int cout, const void* y, const float* alpha, const float* beta,
             const void* w, const void* wb, void* out, int B, int H, int W,
             int Cin, cudaStream_t s) {
  switch (cout) {
    case 32:
      return launch<T, 32>(y, alpha, beta, w, wb, out, B, H, W, Cin, s);
    case 64:
      return launch<T, 64>(y, alpha, beta, w, wb, out, B, H, W, Cin, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

int lunaris_gn_mish_conv3_mma(const void* y, const float* alpha,
                              const float* beta, const void* w, const void* wb,
                              void* out, int B, int H, int W, int Cin,
                              int Cout, cudaStream_t stream);

// y: [B, H, W, Cin], out: [B, H, W, Cout], w: [3, 3, Cin, Cout], wb: [Cout],
// all f32 (is_bf16 = 0) or all bf16 (is_bf16 = 1), contiguous.
// alpha, beta: [B, Cin] f32. Cin a multiple of 8, Cout 32 or 64.
// body: 0 the CUDA cores (this file), 1 the tensor cores (bf16 only;
// fused_stage_mma.cu; y and w 16-byte aligned).
// Returns the cudaError_t of the launch.
extern "C" int lunaris_gn_mish_conv3(const void* y, const void* alpha,
                                     const void* beta, const void* w,
                                     const void* wb, void* out, int B, int H,
                                     int W, int Cin, int Cout, int is_bf16,
                                     int body, void* stream) {
  if (B <= 0 || B > 65535 || H <= 0 || W <= 0 || Cin <= 0 || Cin % kCK != 0 ||
      (H + kTH - 1) / kTH > 65535 || body < 0 || body > 1 ||
      (body == 1 && !is_bf16))
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  auto a = static_cast<const float*>(alpha);
  auto bt = static_cast<const float*>(beta);
  if (body == 1)
    return lunaris_gn_mish_conv3_mma(y, a, bt, w, wb, out, B, H, W, Cin, Cout,
                                     s);
  if (is_bf16)
    return dispatch<__nv_bfloat16>(Cout, y, a, bt, w, wb, out, B, H, W, Cin, s);
  return dispatch<float>(Cout, y, a, bt, w, wb, out, B, H, W, Cin, s);
}
