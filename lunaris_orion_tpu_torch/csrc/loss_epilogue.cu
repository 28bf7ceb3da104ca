// K3 -- the VAE loss epilogue: the mean squared reconstruction error and
// the KL term, for Hopper (sm_90a).
//
// Replaces lunaris_orion_tpu/ops/pallas/loss_epilogue.py `_kernel`
// (launched in `mse_kl_pallas`, selected by train/losses.py `recon_kl`).
//
//   out[0] = sum over B*H*W*C of (recon - x)^2 / (B*H*W*C)
//   out[1] = -1/2 sum over B*L of (1 + logvar - mu^2 - exp(logvar)) / (B*L)
//
// all in f32 whatever the input type. The TPU kernel wrote per-sample sums
// that its caller reduced; both losses are sums over everything, so here
// the inputs are flat arrays and the kernel writes the finished scalars.
//
// Bound: device-memory bandwidth; it reads each input once (at the training
// shape, 16 x 128 x 128 x 3 per image tensor: 3 MB f32), a few microseconds
// of work, so one launch on every SM with nothing after it. Each thread
// sums a grid-stride slice of 16-byte vectors (8 bf16 or 4 f32; a scalar
// form where an address is not 16-byte aligned) in order, then the n % V
// tail and its slice of mu and logvar; each block folds its threads' sums
// by a fixed tree and writes its two partials. The last block to finish
// (a counter that it resets to 0 for the next launch) sums the blocks'
// partials in index order and writes the two scalars. No float atomics,
// so two runs give the same bits.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kMaxBlocks = 1024;

// Fixed-order tree sum of the block's per-thread values; the result is
// valid in thread 0.
__device__ float block_sum(float v, float* red) {
  red[threadIdx.x] = v;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
    __syncthreads();
  }
  const float out = red[0];
  __syncthreads();
  return out;
}

// recon, x: n values; mu, logvar: m values. out: [2 + 2 * gridDim.x] f32,
// the two losses, then the blocks' partial sums of each. counter: 0 on
// entry, and 0 again when the kernel ends.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
mse_kl_total(const T* __restrict__ recon, const T* __restrict__ x,
             const T* __restrict__ mu, const T* __restrict__ logvar,
             float* __restrict__ out, unsigned int* __restrict__ counter,
             long long n, int m) {
  __shared__ float red[kThreads];
  __shared__ float part[2 * kMaxBlocks];
  __shared__ bool last;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long nv = n / V;
  float acc = 0.f;
  for (long long i = t; i < nv; i += stride) {
    float r[V], xv[V];
    load_vec<T, V>(recon + i * V, r);
    load_vec<T, V>(x + i * V, xv);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float diff = r[k] - xv[k];
      acc = fmaf(diff, diff, acc);
    }
  }
  if (t < n - nv * V) {
    const float diff = to_f32(recon[nv * V + t]) - to_f32(x[nv * V + t]);
    acc = fmaf(diff, diff, acc);
  }
  float acc_kl = 0.f;
  for (long long i = t; i < m; i += stride) {
    const float mv = to_f32(mu[i]);
    const float lv = to_f32(logvar[i]);
    acc_kl += 1.f + lv - mv * mv - expf(lv);
  }
  const float s = block_sum(acc, red);
  const float k = block_sum(acc_kl, red);
  float* partials = out + 2;
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = s;
    partials[gridDim.x + blockIdx.x] = k;
    __threadfence();                          // the partials, then the ticket
    last = atomicAdd(counter, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int i = threadIdx.x; i < 2 * gridDim.x; i += kThreads)
    part[i] = __ldcg(partials + i);           // from L2: other blocks wrote them
  __syncthreads();
  if (threadIdx.x == 0) {
    float a = 0.f, q = 0.f;
    for (int i = 0; i < gridDim.x; ++i) {
      a += part[i];
      q += part[gridDim.x + i];
    }
    out[0] = a / static_cast<float>(n);
    out[1] = -0.5f * q / static_cast<float>(m);
    *counter = 0u;
  }
}

template <typename T>
int launch_total(const void* recon, const void* x, const void* mu,
                 const void* logvar, float* out, unsigned int* counter,
                 long long n, int m, int blocks, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  auto r = static_cast<const T*>(recon);
  auto xt = static_cast<const T*>(x);
  auto mt = static_cast<const T*>(mu);
  auto lt = static_cast<const T*>(logvar);
  if (reinterpret_cast<uintptr_t>(recon) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(x) % 16 == 0)
    mse_kl_total<T, V><<<blocks, kThreads, 0, stream>>>(r, xt, mt, lt, out,
                                                        counter, n, m);
  else
    mse_kl_total<T, 1><<<blocks, kThreads, 0, stream>>>(r, xt, mt, lt, out,
                                                        counter, n, m);
  return static_cast<int>(cudaGetLastError());
}

// The earlier kernel: one block per sample, which writes that sample's sums
// sse[b] and kl[b] for the caller to reduce.
template <typename T>
__global__ void __launch_bounds__(kThreads)
mse_kl_per_sample(const T* __restrict__ recon, const T* __restrict__ x,
                  const T* __restrict__ mu, const T* __restrict__ logvar,
                  float* __restrict__ sse, float* __restrict__ kl,
                  long long n_img, int L) {
  __shared__ float red[kThreads];
  const int b = blockIdx.x;
  const T* rb = recon + b * n_img;
  const T* xb = x + b * n_img;
  float acc = 0.f;
  for (long long i = threadIdx.x; i < n_img; i += kThreads) {
    const float diff = to_f32(rb[i]) - to_f32(xb[i]);
    acc = fmaf(diff, diff, acc);
  }
  const float s = block_sum(acc, red);
  const T* mb = mu + static_cast<long long>(b) * L;
  const T* lb = logvar + static_cast<long long>(b) * L;
  float acc_kl = 0.f;
  for (int i = threadIdx.x; i < L; i += kThreads) {
    const float m = to_f32(mb[i]);
    const float lv = to_f32(lb[i]);
    acc_kl += 1.f + lv - m * m - expf(lv);
  }
  const float k = block_sum(acc_kl, red);
  if (threadIdx.x == 0) {
    sse[b] = s;
    kl[b] = k;
  }
}

}  // namespace

// recon, x: n contiguous values; mu, logvar: m contiguous values; all f32
// (is_bf16 = 0) or all bf16 (is_bf16 = 1). out: [2 + 2 * blocks] f32, of
// which out[0] and out[1] are the two losses. counter: one unsigned int, 0
// before the launch and left 0 by it; launches that share it must be
// ordered (one stream). Returns the cudaError_t of the launch.
extern "C" int lunaris_mse_kl(const void* recon, const void* x,
                              const void* mu, const void* logvar, void* out,
                              void* counter, long long n, int m, int blocks,
                              int is_bf16, void* stream) {
  if (n <= 0 || m <= 0 || blocks <= 0 || blocks > kMaxBlocks)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  auto o = static_cast<float*>(out);
  auto c = static_cast<unsigned int*>(counter);
  if (is_bf16)
    return launch_total<__nv_bfloat16>(recon, x, mu, logvar, o, c, n, m,
                                       blocks, s);
  return launch_total<float>(recon, x, mu, logvar, o, c, n, m, blocks, s);
}

// The earlier form, kept for timing against: recon, x: [B, n_img]; mu,
// logvar: [B, L]; sse, kl: [B] f32, the per-sample sums. Returns the
// cudaError_t of the launch.
extern "C" int lunaris_mse_kl_per_sample(const void* recon, const void* x,
                                         const void* mu, const void* logvar,
                                         void* sse, void* kl, int B,
                                         long long n_img, int L, int is_bf16,
                                         void* stream) {
  if (B <= 0 || n_img <= 0 || L <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  auto o1 = static_cast<float*>(sse);
  auto o2 = static_cast<float*>(kl);
  if (is_bf16) {
    using T = __nv_bfloat16;
    mse_kl_per_sample<T><<<B, kThreads, 0, s>>>(
        static_cast<const T*>(recon), static_cast<const T*>(x),
        static_cast<const T*>(mu), static_cast<const T*>(logvar), o1, o2,
        n_img, L);
  } else {
    mse_kl_per_sample<float><<<B, kThreads, 0, s>>>(
        static_cast<const float*>(recon), static_cast<const float*>(x),
        static_cast<const float*>(mu), static_cast<const float*>(logvar), o1,
        o2, n_img, L);
  }
  return static_cast<int>(cudaGetLastError());
}
