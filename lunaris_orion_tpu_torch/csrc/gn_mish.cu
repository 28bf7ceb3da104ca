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
// and writes y once. The TPU kernel packed channels into 128-wide lanes for
// its vector unit; here a group's C/G channels are contiguous inside each
// pixel.
//
// Both passes read (and the apply writes) 16 bytes a thread: 8 bf16 or 4
// f32 consecutive channels of one pixel, neighbouring threads neighbouring
// addresses. A thread owns fixed vector columns and walks pixels four at a
// time, so the channel of each value is known without a division, and the
// apply keeps its columns' A and B' in registers. Where C is not a multiple
// of the vector width, or x or y is not 16-byte aligned, the same kernels
// run one element a thread (the scalar form).
//
// With mish's full exp / log1p / tanh chain (about 50 instructions an
// element against about 5 for the rest) the bf16 apply is bound by issue
// slots rather than bytes: on an H100 it took half again the time of the
// apply without mish. So the apply takes the caller's `MishForm`, and the
// port ships `mish_fast`, one ex2 and one reciprocal, within a tenth of the
// apply without mish. K5 keeps mish_f32.
//
// Determinism: no float atomics. Pass 1 writes one partial per
// (batch, group, split), each reduced in a fixed order; the fold sums the
// splits in index order. Two runs give the same bits.
//
// Launch: two kernels on the caller's stream: stats (grid splits x B), then
// the apply (grid blocks x B), each of whose blocks first folds its image's
// partials into A and B' in shared memory (`fold_affine`). The affine entry
// (K5's alpha and beta) launches stats and the fold kernel `gn_fold`, which
// calls the same `fold_affine`. The earlier three-launch form (stats, fold,
// a grid-stride apply) stays callable for timing against. Each launch is
// checked with cudaGetLastError and the first error is returned.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxChannels = 2048;
constexpr int kMaxFold = 2048;               // groups x splits a fold stages
constexpr int kUnroll = 4;                   // pixels a thread has in flight

// What the apply evaluates after the affine: mish_f32 (the chain K5 and the
// earlier apply use), mish_fast, or nothing (a probe that times the apply
// without its activation).
enum MishForm : int { kMishExact = 0, kMishFast = 1, kMishNone = 2 };

// mish(v) = v tanh(log1p(e)) = v n / (n + 2), with e = exp(v) and
// n = e (e + 2); above 20 it is v in f32, as in mish_f32 (and n would
// overflow past 44).
__device__ __forceinline__ float mish_fast(float v) {
  const float e = __expf(v);
  const float n = e * (e + 2.f);
  return v > 20.f ? v : v * __fdividef(n, n + 2.f);
}

template <int M>
__device__ __forceinline__ float activate(float v) {
  if constexpr (M == kMishExact) return mish_f32(v);
  else if constexpr (M == kMishFast) return mish_fast(v);
  else return v;
}

// V f32 values to T at p, each rounded to nearest even as from_f32 does.
template <typename T, int V>
__device__ __forceinline__ void store_vec(T* p, const float (&v)[V]) {
  if constexpr (V == 8) {
    unsigned int wds[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      wds[i] = *reinterpret_cast<const unsigned int*>(&h);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(wds[0], wds[1], wds[2], wds[3]);
  } else if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    *p = from_f32<T>(v[0]);
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

// Floats of shared memory `fold_affine` stages: the partials, then mean and
// inv_std per group.
__host__ __device__ constexpr int fold_floats(int G, int splits) {
  return 2 * G * splits + 2 * G;
}

// The fold, by the whole block, of one image's partials [G, splits, 2]:
// each group's splits summed in index order, mean and inv_std (variance
// clamped at 0), then the per-channel affine alpha[c] = A and
// beta_out[c] = B' for c < C, in shared or global memory. `stage` is
// fold_floats(G, splits) floats of shared memory. The caller synchronises
// before it reads alpha or beta_out.
__device__ void fold_affine(const float* __restrict__ partial,
                            const float* __restrict__ gamma,
                            const float* __restrict__ beta, float* alpha,
                            float* beta_out, int C, int G, int splits,
                            float n_set, float eps, float* stage) {
  const int n = 2 * G * splits;
  for (int i = threadIdx.x; i < n; i += blockDim.x) stage[i] = partial[i];
  float* g_mean = stage + n;
  float* g_inv = g_mean + G;
  __syncthreads();
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    const float* in = stage + 2 * g * splits;
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
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const int g = c / cg;
    const float inv = g_inv[g];
    alpha[c] = inv * gamma[c];
    beta_out[c] = beta[c] - (g_mean[g] * inv) * gamma[c];
  }
}

// The fold alone: block b writes alpha[b, :] and beta_out[b, :], each [B, C]
// (K5's affine, and the earlier apply's).
__global__ void __launch_bounds__(kThreads)
gn_fold(const float* __restrict__ partial, const float* __restrict__ gamma,
        const float* __restrict__ beta, float* __restrict__ alpha,
        float* __restrict__ beta_out, int C, int G, int splits, float n_set,
        float eps) {
  extern __shared__ float stage[];
  const long long b = blockIdx.x;
  fold_affine(partial + b * G * splits * 2, gamma, beta, alpha + b * C,
              beta_out + b * C, C, G, splits, n_set, eps, stage);
}

// Pass 2 with the fold. Block (blk, b) folds b's partials into A and B' for
// all C channels in shared memory, then applies y = mish(x * A + B') to
// pixels [p0, p1) of x[b], p0 = blk * ceil(hw / blocks). Threads are laid
// out as in pass 1: thread t owns vector columns t % tc, t % tc + tc, ...
// and walks pixels p0 + t / tc, stepping rows = kThreads / tc, four in
// flight; it reads its column's A and B' into registers once.
template <typename T, int V, int M>
__global__ void __launch_bounds__(kThreads)
gn_mish_apply_fold(const T* __restrict__ x, T* __restrict__ y,
                   const float* __restrict__ partial,
                   const float* __restrict__ gamma,
                   const float* __restrict__ beta, int hw, int C, int G,
                   int splits, float n_set, float eps) {
  extern __shared__ float smem[];
  float* a_s = smem;
  float* b_s = smem + C;
  const int b = blockIdx.y;
  fold_affine(partial + static_cast<long long>(b) * G * splits * 2, gamma,
              beta, a_s, b_s, C, G, splits, n_set, eps, smem + 2 * C);
  __syncthreads();

  const int per = (hw + gridDim.x - 1) / gridDim.x;
  const int p0 = blockIdx.x * per;
  const int p1 = min(hw, p0 + per);
  const int cols = C / V;
  const int tc = min(cols, kThreads);
  const int rows = kThreads / tc;
  const int row = threadIdx.x / tc;
  if (row >= rows) return;
  const long long base = static_cast<long long>(b) * hw * C;
  for (int col = threadIdx.x % tc; col < cols; col += tc) {
    float a[V], bb[V], v[kUnroll][V];
#pragma unroll
    for (int i = 0; i < V; ++i) {
      a[i] = a_s[col * V + i];
      bb[i] = b_s[col * V + i];
    }
    const T* xc = x + base + col * V;
    T* yc = y + base + col * V;
    int p = p0 + row;
    for (; p + (kUnroll - 1) * rows < p1; p += kUnroll * rows) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        load_vec<T, V>(xc + static_cast<long long>(p + u * rows) * C, v[u]);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
        for (int i = 0; i < V; ++i) v[u][i] = activate<M>(v[u][i] * a[i] + bb[i]);
        store_vec<T, V>(yc + static_cast<long long>(p + u * rows) * C, v[u]);
      }
    }
    for (; p < p1; p += rows) {
      load_vec<T, V>(xc + static_cast<long long>(p) * C, v[0]);
#pragma unroll
      for (int i = 0; i < V; ++i) v[0][i] = activate<M>(v[0][i] * a[i] + bb[i]);
      store_vec<T, V>(yc + static_cast<long long>(p) * C, v[0]);
    }
  }
}

// The earlier apply: grid (blocks, B), a grid-stride walk over the hw * C
// elements of x[b], one element a thread, A and B' read from [B, C].
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
         splits <= 0 || G * splits > kMaxFold;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

float set_size(int hw, int C, int G) {
  return static_cast<float>(hw) * static_cast<float>(C / G);
}

// Pass 1 on the vector form where C and x's address allow it.
template <typename T>
int stats(const void* x, float* partial, int B, int hw, int C, int G,
          int splits, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const dim3 grid(splits, B);
  const T* xt = static_cast<const T*>(x);
  if (C % V == 0 && aligned16(x))
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
  const size_t smem = sizeof(float) * fold_floats(G, splits);
  gn_fold<<<B, kThreads, smem, stream>>>(partial, gamma, beta, alpha, beta_out,
                                          C, G, splits, set_size(hw, C, G),
                                          eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int V>
void apply_form(const T* x, T* y, const float* partial, const float* gamma,
                const float* beta, int B, int hw, int C, int G, int splits,
                int blocks, float eps, int mish, cudaStream_t stream) {
  const dim3 grid(blocks, B);
  const size_t smem = sizeof(float) * (2 * C + fold_floats(G, splits));
  const float n_set = set_size(hw, C, G);
  if (mish == kMishExact)
    gn_mish_apply_fold<T, V, kMishExact><<<grid, kThreads, smem, stream>>>(
        x, y, partial, gamma, beta, hw, C, G, splits, n_set, eps);
  else if (mish == kMishFast)
    gn_mish_apply_fold<T, V, kMishFast><<<grid, kThreads, smem, stream>>>(
        x, y, partial, gamma, beta, hw, C, G, splits, n_set, eps);
  else
    gn_mish_apply_fold<T, V, kMishNone><<<grid, kThreads, smem, stream>>>(
        x, y, partial, gamma, beta, hw, C, G, splits, n_set, eps);
}

// The apply with the fold, on the vector form where C and the addresses of
// x and y allow it.
template <typename T>
int apply(const void* x, void* y, const float* partial, const float* gamma,
          const float* beta, int B, int hw, int C, int G, int splits,
          int blocks, float eps, int mish, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  if (C % V == 0 && aligned16(x) && aligned16(y))
    apply_form<T, V>(xt, yt, partial, gamma, beta, B, hw, C, G, splits,
                     blocks, eps, mish, stream);
  else
    apply_form<T, 1>(xt, yt, partial, gamma, beta, B, hw, C, G, splits,
                     blocks, eps, mish, stream);
  return static_cast<int>(cudaGetLastError());
}

// The earlier form: pass 1, the fold into affine_buf [2, B, C], and the
// grid-stride apply.
template <typename T>
int launch_earlier(const void* x, void* y, const float* gamma,
                   const float* beta, float* partial, float* affine_buf, int B,
                   int hw, int C, int G, int splits, int apply_blocks,
                   float eps, cudaStream_t stream) {
  float* alpha = affine_buf;
  float* beta_out = affine_buf + static_cast<long long>(B) * C;
  const int err = affine<T>(x, gamma, beta, partial, alpha, beta_out, B, hw, C,
                            G, splits, eps, stream);
  if (err != 0) return err;
  gn_mish_apply<T><<<dim3(apply_blocks, B), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), alpha, beta_out, hw, C);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* x, void* y, const float* gamma, const float* beta,
           float* partial, int B, int hw, int C, int G, int splits,
           int apply_blocks, float eps, int mish, cudaStream_t stream) {
  const int err = stats<T>(x, partial, B, hw, C, G, splits, stream);
  if (err != 0) return err;
  return apply<T>(x, y, partial, gamma, beta, B, hw, C, G, splits,
                  apply_blocks, eps, mish, stream);
}

bool bad_mish(int mish) {
  return mish != kMishExact && mish != kMishFast && mish != kMishNone;
}

}  // namespace

// x, y: [B, hw, C] contiguous (NHWC), f32 (is_bf16 = 0) or bf16 (is_bf16 = 1).
// gamma, beta: [C] f32. partial: [B, G, splits, 2] f32 scratch. mish: the
// apply's MishForm. Two launches: pass 1, then the apply with the fold.
// Returns the cudaError_t of the launches.
extern "C" int lunaris_gn_mish(const void* x, void* y, const void* gamma,
                               const void* beta, void* partial, int B, int hw,
                               int C, int G, int splits, int apply_blocks,
                               float eps, int is_bf16, int mish,
                               void* stream) {
  if (bad_shape(B, C, G, splits) || apply_blocks <= 0 || bad_mish(mish))
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  auto g = static_cast<const float*>(gamma);
  auto bt = static_cast<const float*>(beta);
  auto pa = static_cast<float*>(partial);
  if (is_bf16)
    return launch<__nv_bfloat16>(x, y, g, bt, pa, B, hw, C, G, splits,
                                 apply_blocks, eps, mish, s);
  return launch<float>(x, y, g, bt, pa, B, hw, C, G, splits, apply_blocks,
                       eps, mish, s);
}

// The earlier three-launch form (pass 1, fold, grid-stride apply with
// mish_f32), kept for timing against: arguments as above, with affine a
// [2, B, C] f32 scratch.
extern "C" int lunaris_gn_mish_earlier(const void* x, void* y,
                                       const void* gamma, const void* beta,
                                       void* partial, void* affine, int B,
                                       int hw, int C, int G, int splits,
                                       int apply_blocks, float eps,
                                       int is_bf16, void* stream) {
  if (bad_shape(B, C, G, splits) || apply_blocks <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  auto g = static_cast<const float*>(gamma);
  auto bt = static_cast<const float*>(beta);
  auto pa = static_cast<float*>(partial);
  auto af = static_cast<float*>(affine);
  if (is_bf16)
    return launch_earlier<__nv_bfloat16>(x, y, g, bt, pa, af, B, hw, C, G,
                                         splits, apply_blocks, eps, s);
  return launch_earlier<float>(x, y, g, bt, pa, af, B, hw, C, G, splits,
                               apply_blocks, eps, s);
}

// The apply alone, with its fold: y from x and pass 1's partial
// [B, G, splits, 2]. Arguments as for lunaris_gn_mish.
extern "C" int lunaris_gn_mish_apply(const void* x, void* y,
                                     const void* partial, const void* gamma,
                                     const void* beta, int B, int hw, int C,
                                     int G, int splits, int apply_blocks,
                                     float eps, int is_bf16, int mish,
                                     void* stream) {
  if (bad_shape(B, C, G, splits) || apply_blocks <= 0 || bad_mish(mish))
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  auto g = static_cast<const float*>(gamma);
  auto bt = static_cast<const float*>(beta);
  auto pa = static_cast<const float*>(partial);
  if (is_bf16)
    return apply<__nv_bfloat16>(x, y, pa, g, bt, B, hw, C, G, splits,
                                apply_blocks, eps, mish, s);
  return apply<float>(x, y, pa, g, bt, B, hw, C, G, splits, apply_blocks, eps,
                      mish, s);
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
