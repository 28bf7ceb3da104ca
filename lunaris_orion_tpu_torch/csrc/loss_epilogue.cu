// K3 -- the VAE loss epilogue: per-sample sum of squared reconstruction
// errors and KL sum, for Hopper (sm_90a).
//
// Replaces lunaris_orion_tpu/ops/pallas/loss_epilogue.py `_kernel`
// (launched in `mse_kl_pallas`, selected by train/losses.py `recon_kl`).
//
//   sse[b] = sum over H*W*C of (recon - x)^2
//   kl[b]  = sum over L of (1 + logvar - mu^2 - exp(logvar))
//
// all in f32 whatever the input type. The caller forms the two scalars,
// sum(sse) / (B*H*W*C) and -1/2 sum(kl) / (B*L), as the TPU kernel's caller
// does.
//
// Bound: device-memory bandwidth; it reads each input once (at the
// training shape, 16 x 128 x 128 x 3 per image tensor: 3 MB f32). One block
// per sample: each thread sums a grid-stride slice in order, then the block
// folds the threads' partials by a fixed tree in shared memory. No float
// atomics, so two runs give the same bits.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 512;

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
mse_kl(const T* __restrict__ recon, const T* __restrict__ x,
       const T* __restrict__ mu, const T* __restrict__ logvar,
       float* __restrict__ sse, float* __restrict__ kl, long long n_img,
       int L) {
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

// recon, x: [B, n_img] (a sample's H*W*C values contiguous); mu, logvar:
// [B, L]; all f32 (is_bf16 = 0) or all bf16 (is_bf16 = 1). sse, kl: [B] f32.
// Returns the cudaError_t of the launch.
extern "C" int lunaris_mse_kl(const void* recon, const void* x,
                              const void* mu, const void* logvar, void* sse,
                              void* kl, int B, long long n_img, int L,
                              int is_bf16, void* stream) {
  if (B <= 0 || n_img <= 0 || L <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  auto o1 = static_cast<float*>(sse);
  auto o2 = static_cast<float*>(kl);
  if (is_bf16) {
    using T = __nv_bfloat16;
    mse_kl<T><<<B, kThreads, 0, s>>>(
        static_cast<const T*>(recon), static_cast<const T*>(x),
        static_cast<const T*>(mu), static_cast<const T*>(logvar), o1, o2,
        n_img, L);
  } else {
    mse_kl<float><<<B, kThreads, 0, s>>>(
        static_cast<const float*>(recon), static_cast<const float*>(x),
        static_cast<const float*>(mu), static_cast<const float*>(logvar), o1,
        o2, n_img, L);
  }
  return static_cast<int>(cudaGetLastError());
}
