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
// inside each pixel.
//
// Pass 1 reads 16 bytes a thread (8 bf16 or 4 f32 consecutive channels of
// one pixel), neighbouring threads neighbouring addresses, and keeps those
// channels' sums in registers while it walks its pixels four at a time, as
// the lane-sums kernel (gn_stats.cu) does. Where C is not a multiple of the
// vector width it reads one element a thread (the scalar form).
//
// Determinism: no float atomics. Pass 1 writes one partial per
// (batch, group, split) into a scratch buffer, each reduced in a fixed
// order; a small fold kernel sums the splits in order. Two runs give the
// same bits.
//
// Launch: three kernels on the caller's stream: stats (grid splits x B),
// fold (grid B), apply (grid blocks x B). Each launch is checked with
// cudaGetLastError and the first error is returned to the caller. The
// affine entry launches the first two only: K5's alpha and beta.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxChannels = 2048;
constexpr int kUnroll = 4;                   // pixels a thread has in flight

// V consecutive values of T at p (16 bytes when V * sizeof(T) is 16) as f32.
template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* p, float (&out)[V]) {
  if constexpr (V == 8) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const unsigned int wds[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {            // a bf16 is the upper half of an f32
      out[2 * i] = __uint_as_float(wds[i] << 16);
      out[2 * i + 1] = __uint_as_float(wds[i] & 0xFFFF0000u);
    }
  } else if constexpr (V == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  } else {
    out[0] = to_f32(*p);
  }
}

// Pass 1. Block (split, b) sums pixels [p0, p1) of x[b]. A pixel's C channels
// are cols = C / V vectors of V channels. Thread t owns vector column
// col0 + t % tc (tc = min(cols, kThreads)) for each col0 = 0, tc, 2 tc, ...,
// and walks pixels p0 + t / tc, stepping rows = kThreads / tc pixels. The
// rows of each channel are folded in order through shared memory, then each
// group's channels in order, and the block writes
// partial[b, g, split, {sum x, sum x^2}].
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
gn_stats_partial(const T* __restrict__ x, float* __restrict__ partial,
                 int hw, int C, int G, int splits) {
  __shared__ float red1[kThreads * V];
  __shared__ float red2[kThreads * V];
  __shared__ float ch1[kMaxChannels];
  __shared__ float ch2[kMaxChannels];

  const int b = blockIdx.y;
  const int split = blockIdx.x;
  const int per = (hw + splits - 1) / splits;
  const int p0 = split * per;
  const int p1 = min(hw, p0 + per);
  const int cols = C / V;
  const int tc = min(cols, kThreads);
  const int rows = kThreads / tc;
  const int row = threadIdx.x / tc;
  const int tcol = threadIdx.x % tc;
  const T* xb = x + static_cast<long long>(b) * hw * C;

  for (int col0 = 0; col0 < cols; col0 += tc) {
    const int col = col0 + tcol;
    float s1[V], s2[V], v[kUnroll][V];
#pragma unroll
    for (int i = 0; i < V; ++i) s1[i] = s2[i] = 0.f;
    if (row < rows && col < cols) {
      const T* xc = xb + col * V;
      int p = p0 + row;
      for (; p + (kUnroll - 1) * rows < p1; p += kUnroll * rows) {
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          load_vec<T, V>(xc + static_cast<long long>(p + u * rows) * C, v[u]);
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
#pragma unroll
          for (int i = 0; i < V; ++i) {
            s1[i] += v[u][i];
            s2[i] = fmaf(v[u][i], v[u][i], s2[i]);
          }
      }
      for (; p < p1; p += rows) {
        load_vec<T, V>(xc + static_cast<long long>(p) * C, v[0]);
#pragma unroll
        for (int i = 0; i < V; ++i) {
          s1[i] += v[0][i];
          s2[i] = fmaf(v[0][i], v[0][i], s2[i]);
        }
      }
    }
    // red[row][tcol * V + i]: rows * tc * V <= kThreads * V floats.
#pragma unroll
    for (int i = 0; i < V; ++i) {
      red1[threadIdx.x * V + i] = s1[i];
      red2[threadIdx.x * V + i] = s2[i];
    }
    __syncthreads();
    const int width = min(tc, cols - col0) * V;   // channels of this pass
    for (int j = threadIdx.x; j < width; j += kThreads) {
      float a = 0.f, q = 0.f;
      for (int r = 0; r < rows; ++r) {
        a += red1[r * tc * V + j];
        q += red2[r * tc * V + j];
      }
      ch1[col0 * V + j] = a;
      ch2[col0 * V + j] = q;
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
// A = alpha[b, c] and B' = beta_out[b, c], each [B, C].
__global__ void __launch_bounds__(kThreads)
gn_fold(const float* __restrict__ partial, const float* __restrict__ gamma,
        const float* __restrict__ beta, float* __restrict__ alpha,
        float* __restrict__ beta_out, int C, int G, int splits, float n_set,
        float eps) {
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
  const long long o = static_cast<long long>(b) * C;
  for (int c = threadIdx.x; c < C; c += kThreads) {
    const int g = c / cg;
    const float inv = g_inv[g];
    alpha[o + c] = inv * gamma[c];
    beta_out[o + c] = beta[c] - (g_mean[g] * inv) * gamma[c];
  }
}

// Pass 2. Grid (blocks, B): a grid-stride walk over the hw * C elements of x[b].
template <typename T>
__global__ void __launch_bounds__(kThreads)
gn_mish_apply(const T* __restrict__ x, T* __restrict__ y,
              const float* __restrict__ alpha, const float* __restrict__ beta,
              int hw, int C) {
  const int b = blockIdx.y;
  const long long base = static_cast<long long>(b) * hw * C;
  const int count = hw * C;
  const float* a = alpha + static_cast<long long>(b) * C;
  const float* bp = beta + static_cast<long long>(b) * C;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < count;
       i += gridDim.x * blockDim.x) {
    const int c = i % C;
    const float v = to_f32(x[base + i]) * a[c] + bp[c];
    y[base + i] = from_f32<T>(mish_f32(v));
  }
}

bool bad_shape(int B, int C, int G, int splits) {
  return B <= 0 || B > 65535 || C > kMaxChannels || G <= 0 || C % G != 0 ||
         splits <= 0;
}

// Pass 1 on the vector form where C and x's address allow it.
template <typename T>
int stats(const void* x, float* partial, int B, int hw, int C, int G,
          int splits, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const dim3 grid(splits, B);
  const T* xt = static_cast<const T*>(x);
  if (C % V == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0)
    gn_stats_partial<T, V><<<grid, kThreads, 0, stream>>>(xt, partial, hw, C,
                                                           G, splits);
  else
    gn_stats_partial<T, 1><<<grid, kThreads, 0, stream>>>(xt, partial, hw, C,
                                                           G, splits);
  return static_cast<int>(cudaGetLastError());
}

// Pass 1 and the fold: alpha, beta_out [B, C] each.
template <typename T>
int affine(const void* x, const float* gamma, const float* beta,
           float* partial, float* alpha, float* beta_out, int B, int hw, int C,
           int G, int splits, float eps, cudaStream_t stream) {
  const int err = stats<T>(x, partial, B, hw, C, G, splits, stream);
  if (err != 0) return err;
  const float n_set = static_cast<float>(hw) * static_cast<float>(C / G);
  gn_fold<<<B, kThreads, 0, stream>>>(partial, gamma, beta, alpha, beta_out,
                                       C, G, splits, n_set, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* x, void* y, const float* gamma, const float* beta,
           float* partial, float* affine_buf, int B, int hw, int C, int G,
           int splits, int apply_blocks, float eps, cudaStream_t stream) {
  float* alpha = affine_buf;
  float* beta_out = affine_buf + static_cast<long long>(B) * C;
  const int err = affine<T>(x, gamma, beta, partial, alpha, beta_out, B, hw, C,
                            G, splits, eps, stream);
  if (err != 0) return err;
  gn_mish_apply<T><<<dim3(apply_blocks, B), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), alpha, beta_out, hw, C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, y: [B, hw, C] contiguous (NHWC), f32 (is_bf16 = 0) or bf16 (is_bf16 = 1).
// gamma, beta: [C] f32. partial: [B, G, splits, 2] f32 scratch.
// affine: [2, B, C] f32 scratch. Returns the cudaError_t of the launches.
extern "C" int lunaris_gn_mish(const void* x, void* y, const void* gamma,
                               const void* beta, void* partial, void* affine,
                               int B, int hw, int C, int G, int splits,
                               int apply_blocks, float eps, int is_bf16,
                               void* stream) {
  if (bad_shape(B, C, G, splits) || apply_blocks <= 0)
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

// Pass 1 and the fold alone: the GroupNorm of x folded to alpha[b, c] =
// A and beta_out[b, c] = B', each [B, C] f32 (K5's affine). Arguments as
// above.
extern "C" int lunaris_gn_affine(const void* x, const void* gamma,
                                 const void* beta, void* partial, void* alpha,
                                 void* beta_out, int B, int hw, int C, int G,
                                 int splits, float eps, int is_bf16,
                                 void* stream) {
  if (bad_shape(B, C, G, splits))
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  auto g = static_cast<const float*>(gamma);
  auto bt = static_cast<const float*>(beta);
  auto pa = static_cast<float*>(partial);
  auto a = static_cast<float*>(alpha);
  auto bo = static_cast<float*>(beta_out);
  if (is_bf16)
    return affine<__nv_bfloat16>(x, g, bt, pa, a, bo, B, hw, C, G, splits, eps,
                                 s);
  return affine<float>(x, g, bt, pa, a, bo, B, hw, C, G, splits, eps, s);
}

// Pass 1 alone: partial[b, g, split, {sum x, sum x^2}] of x [B, hw, C], for
// a caller that wants the moments without the apply (the stats-only entry,
// and the measurement of this pass by itself). Same arguments as above.
extern "C" int lunaris_gn_stats_pass1(const void* x, void* partial, int B,
                                      int hw, int C, int G, int splits,
                                      int is_bf16, void* stream) {
  if (bad_shape(B, C, G, splits))
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  auto pa = static_cast<float*>(partial);
  if (is_bf16)
    return stats<__nv_bfloat16>(x, pa, B, hw, C, G, splits, s);
  return stats<float>(x, pa, B, hw, C, G, splits, s);
}

// The name of a cudaError_t returned by any entry point of this library.
extern "C" const char* lunaris_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
