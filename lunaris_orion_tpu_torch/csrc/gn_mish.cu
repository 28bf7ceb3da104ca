// K1 -- fused GroupNorm + Mish over NHWC activations, for Hopper (sm_90a).
//
// Replaces lunaris_orion_tpu/ops/pallas/gn_mish.py `_stats_kernel` (pass 1)
// and `_apply_kernel` (pass 2), reached through `group_norm_mish_pallas`.
//
//   y = mish(x * A + B'),  A = gamma * inv_std,  B' = beta - (mean * inv_std) * gamma
//
// with per-(batch, group) mean and inv_std = 1 / sqrt(max(E[x^2] - mean^2, 0) + eps),
// the clamp of `_fold_stats`. All arithmetic is f32; the output is cast once.
//
// Bound: device-memory bandwidth. The kernel reads x twice (stats, apply)
// and writes y once; the arithmetic per element is a few FMAs and one
// exp/log1p/tanh chain. Its design is one read for the stats and one read
// and write for the apply. The TPU kernel packed channels into 128-wide
// lanes for its vector unit; here a group's C/G channels are contiguous
// inside each pixel, and a block lays its threads across channels (fast
// axis) and pixels (slow axis) so that a warp reads consecutive addresses.
//
// Determinism: no float atomics. Pass 1 writes one partial per
// (batch, group, split) into a scratch buffer, each reduced in a fixed
// order; a small fold kernel sums the splits in order. Two runs give the
// same bits.
//
// Launch: three kernels on the caller's stream: stats (grid splits x B),
// fold (grid B), apply (grid blocks x B). Each launch is checked with
// cudaGetLastError and the first error is returned to the caller.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxChannels = 2048;

// Pass 1. Block (split, b) sums pixels [p0, p1) of x[b] per channel: thread
// (tx, ty) owns channel c0 + tx and walks pixels p0 + ty, p0 + ty + ty_n, ...
// The ty_n pixel lanes of each channel are folded in order through shared
// memory, then each group's channels are folded in order, and the block
// writes partial[b, g, split, {sum x, sum x^2}].
template <typename T>
__global__ void __launch_bounds__(kThreads)
gn_stats_partial(const T* __restrict__ x, float* __restrict__ partial,
                 int hw, int C, int G, int splits) {
  __shared__ float red1[kThreads];
  __shared__ float red2[kThreads];
  __shared__ float ch1[kMaxChannels];
  __shared__ float ch2[kMaxChannels];

  const int b = blockIdx.y;
  const int split = blockIdx.x;
  const int per = (hw + splits - 1) / splits;
  const int p0 = split * per;
  const int p1 = min(hw, p0 + per);
  const int tx_n = C < kThreads ? C : kThreads;
  const int ty_n = kThreads / tx_n;
  const int tx = threadIdx.x % tx_n;
  const int ty = threadIdx.x / tx_n;
  const T* xb = x + static_cast<long long>(b) * hw * C;

  for (int c0 = 0; c0 < C; c0 += tx_n) {
    const int c = c0 + tx;
    float s1 = 0.f, s2 = 0.f;
    if (ty < ty_n && c < C) {
      for (int p = p0 + ty; p < p1; p += ty_n) {
        const float v = to_f32(xb[static_cast<long long>(p) * C + c]);
        s1 += v;
        s2 += v * v;
      }
    }
    red1[threadIdx.x] = s1;
    red2[threadIdx.x] = s2;
    __syncthreads();
    if (threadIdx.x < tx_n && c < C) {
      float a = 0.f, q = 0.f;
      for (int j = 0; j < ty_n; ++j) {
        a += red1[j * tx_n + threadIdx.x];
        q += red2[j * tx_n + threadIdx.x];
      }
      ch1[c] = a;
      ch2[c] = q;
    }
    __syncthreads();
  }

  const int cg = C / G;
  for (int g = threadIdx.x; g < G; g += kThreads) {
    float a = 0.f, q = 0.f;
    for (int j = 0; j < cg; ++j) {
      a += ch1[g * cg + j];
      q += ch2[g * cg + j];
    }
    float* out = partial + ((static_cast<long long>(b) * G + g) * splits + split) * 2;
    out[0] = a;
    out[1] = q;
  }
}

// Fold. Block b sums the splits of each group in order, forms mean and
// inv_std (variance clamped at 0), and writes the per-channel affine
// affine[b, 0, c] = A, affine[b, 1, c] = B'.
__global__ void __launch_bounds__(kThreads)
gn_fold(const float* __restrict__ partial, const float* __restrict__ gamma,
        const float* __restrict__ beta, float* __restrict__ affine,
        int C, int G, int splits, float n_set, float eps) {
  __shared__ float g_mean[kMaxChannels];
  __shared__ float g_inv[kMaxChannels];
  const int b = blockIdx.x;
  for (int g = threadIdx.x; g < G; g += kThreads) {
    const float* in = partial + (static_cast<long long>(b) * G + g) * splits * 2;
    float a = 0.f, q = 0.f;
    for (int s = 0; s < splits; ++s) {
      a += in[2 * s];
      q += in[2 * s + 1];
    }
    const float mean = a / n_set;
    const float var = fmaxf(q / n_set - mean * mean, 0.f);
    g_mean[g] = mean;
    g_inv[g] = 1.f / sqrtf(var + eps);
  }
  __syncthreads();
  const int cg = C / G;
  float* out = affine + static_cast<long long>(b) * 2 * C;
  for (int c = threadIdx.x; c < C; c += kThreads) {
    const int g = c / cg;
    const float inv = g_inv[g];
    out[c] = inv * gamma[c];
    out[C + c] = beta[c] - (g_mean[g] * inv) * gamma[c];
  }
}

// Pass 2. Grid (blocks, B): a grid-stride walk over the hw * C elements of x[b].
template <typename T>
__global__ void __launch_bounds__(kThreads)
gn_mish_apply(const T* __restrict__ x, T* __restrict__ y,
              const float* __restrict__ affine, int hw, int C) {
  const int b = blockIdx.y;
  const long long base = static_cast<long long>(b) * hw * C;
  const int count = hw * C;
  const float* a = affine + static_cast<long long>(b) * 2 * C;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < count;
       i += gridDim.x * blockDim.x) {
    const int c = i % C;
    const float v = to_f32(x[base + i]) * a[c] + a[C + c];
    y[base + i] = from_f32<T>(mish_f32(v));
  }
}

template <typename T>
int launch(const void* x, void* y, const float* gamma, const float* beta,
           float* partial, float* affine, int B, int hw, int C, int G,
           int splits, int apply_blocks, float eps, cudaStream_t stream) {
  gn_stats_partial<T><<<dim3(splits, B), kThreads, 0, stream>>>(
      static_cast<const T*>(x), partial, hw, C, G, splits);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const float n_set = static_cast<float>(hw) * static_cast<float>(C / G);
  gn_fold<<<B, kThreads, 0, stream>>>(partial, gamma, beta, affine, C, G,
                                       splits, n_set, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  gn_mish_apply<T><<<dim3(apply_blocks, B), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), affine, hw, C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, y: [B, hw, C] contiguous (NHWC), f32 (is_bf16 = 0) or bf16 (is_bf16 = 1).
// gamma, beta: [C] f32. partial: [B, G, splits, 2] f32 scratch.
// affine: [B, 2, C] f32 scratch. Returns the cudaError_t of the launches.
extern "C" int lunaris_gn_mish(const void* x, void* y, const void* gamma,
                               const void* beta, void* partial, void* affine,
                               int B, int hw, int C, int G, int splits,
                               int apply_blocks, float eps, int is_bf16,
                               void* stream) {
  if (C > kMaxChannels || G <= 0 || C % G != 0 || splits <= 0 || apply_blocks <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  auto g = static_cast<const float*>(gamma);
  auto bt = static_cast<const float*>(beta);
  auto pa = static_cast<float*>(partial);
  auto af = static_cast<float*>(affine);
  if (is_bf16)
    return launch<__nv_bfloat16>(x, y, g, bt, pa, af, B, hw, C, G, splits,
                                 apply_blocks, eps, s);
  return launch<float>(x, y, g, bt, pa, af, B, hw, C, G, splits, apply_blocks,
                       eps, s);
}

// Pass 1 alone: partial[b, g, split, {sum x, sum x^2}] of x [B, hw, C], for
// a caller that wants the moments without the apply (the stats-only entry,
// and the measurement of this pass by itself). Same arguments as above.
extern "C" int lunaris_gn_stats_pass1(const void* x, void* partial, int B,
                                      int hw, int C, int G, int splits,
                                      int is_bf16, void* stream) {
  if (C > kMaxChannels || G <= 0 || C % G != 0 || splits <= 0 || B <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  auto pa = static_cast<float*>(partial);
  if (is_bf16)
    gn_stats_partial<__nv_bfloat16><<<dim3(splits, B), kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), pa, hw, C, G, splits);
  else
    gn_stats_partial<float><<<dim3(splits, B), kThreads, 0, s>>>(
        static_cast<const float*>(x), pa, hw, C, G, splits);
  return static_cast<int>(cudaGetLastError());
}

// The name of a cudaError_t returned by any entry point of this library.
extern "C" const char* lunaris_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
