// K1 lane sums from per-tile partials -- the GroupNorm moment reduction with
// every tile independent, for Hopper (sm_90a).
//
// Replaces tools/bench_gn_stats2.py `_par_kernel` (launched by `pal_par`).
//
// x [B, H, W, C] is viewed as [B, M, 128] with M = H*W*C/128. One lane
// period is L = P*128 consecutive elements, P = max(C/128, 1): element e of
// an image belongs to lane e mod L, and lane j holds channel j mod C. The
// result is, per image and lane, s1 = sum x and s2 = sum x^2 in f32.
//
//   pass 1  block (tile t, image b) reduces rows [t*tn, (t+1)*tn) of 128 to
//           L lane sums and writes partial[b, t, {s1, s2}, L];
//   pass 2  block b adds the nt partials of each lane in index order and
//           writes sums[b, {s1, s2}, L].
//
// Bound: device-memory bandwidth, one read of x. Each thread reads 16 bytes
// at a time (8 bf16 or 4 f32 values of consecutive lanes), neighbouring
// threads neighbouring addresses, and keeps its lanes' sums in registers
// while it walks the tile's periods with a stride of 256 / (L/V) periods.
// The thread groups are then folded in index order through shared memory:
// no atomics, so two runs give the same bits. The TPU version's point (no
// grid step revisits an output block) is the natural form here: blocks run
// in any order and share nothing.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kThreads = 256;

template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int kN = 4;
  __device__ static void load(const float* p, float (&out)[4]) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ static void load(const __nv_bfloat16* p, float (&out)[8]) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const unsigned int wds[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // A bf16 is the upper half of an f32.
      out[2 * i] = __uint_as_float(wds[i] << 16);
      out[2 * i + 1] = __uint_as_float(wds[i] & 0xFFFF0000u);
    }
  }
};

// Pass 1. L: lanes of a period; periods: periods per tile. Thread t owns the
// V lanes [V * (t % cols), ...) with cols = L / V, and the periods
// t / cols, t / cols + groups, ... with groups = kThreads / cols.
template <typename T>
__global__ void __launch_bounds__(kThreads)
lane_sums_partial(const T* __restrict__ x, float* __restrict__ partial, int L,
                  int periods, int nt, long long image_elems) {
  constexpr int V = Vec<T>::kN;
  __shared__ float red1[kThreads * V];
  __shared__ float red2[kThreads * V];

  const int t = blockIdx.x;
  const int b = blockIdx.y;
  const int cols = L / V;
  const int groups = kThreads / cols;
  const int col = threadIdx.x % cols;
  const int grp = threadIdx.x / cols;
  const T* tile = x + static_cast<long long>(b) * image_elems +
                  static_cast<long long>(t) * periods * L;

  float s1[V], s2[V], val[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    s1[i] = 0.f;
    s2[i] = 0.f;
  }
  for (int p = grp; p < periods; p += groups) {
    Vec<T>::load(tile + static_cast<long long>(p) * L + col * V, val);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      s1[i] += val[i];
      s2[i] = fmaf(val[i], val[i], s2[i]);
    }
  }
  // red[grp][lane]: groups * L = kThreads * V floats.
#pragma unroll
  for (int i = 0; i < V; ++i) {
    red1[grp * L + col * V + i] = s1[i];
    red2[grp * L + col * V + i] = s2[i];
  }
  __syncthreads();
  float* out = partial + (static_cast<long long>(b) * nt + t) * 2 * L;
  for (int lane = threadIdx.x; lane < L; lane += kThreads) {
    float a = 0.f, q = 0.f;
    for (int g = 0; g < groups; ++g) {
      a += red1[g * L + lane];
      q += red2[g * L + lane];
    }
    out[lane] = a;
    out[L + lane] = q;
  }
}

// Pass 2. Block b: sums[b, :, :] = sum over t, in order, of partial[b, t].
__global__ void __launch_bounds__(kThreads)
lane_sums_fold(const float* __restrict__ partial, float* __restrict__ sums,
               int L2, int nt) {
  const int b = blockIdx.x;
  const float* in = partial + static_cast<long long>(b) * nt * L2;
  for (int j = threadIdx.x; j < L2; j += kThreads) {
    float a = 0.f;
    for (int t = 0; t < nt; ++t) a += in[static_cast<long long>(t) * L2 + j];
    sums[static_cast<long long>(b) * L2 + j] = a;
  }
}

template <typename T>
int launch(const void* x, float* partial, float* sums, int B, int L,
           int periods, int nt, cudaStream_t stream) {
  constexpr int V = Vec<T>::kN;
  const int cols = L / V;
  if (L % V != 0 || cols > kThreads || kThreads % cols != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long image_elems = static_cast<long long>(nt) * periods * L;
  lane_sums_partial<T><<<dim3(nt, B), kThreads, 0, stream>>>(
      static_cast<const T*>(x), partial, L, periods, nt, image_elems);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  lane_sums_fold<<<B, kThreads, 0, stream>>>(partial, sums, 2 * L, nt);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: [B, nt * periods * L] contiguous, f32 (is_bf16 = 0) or bf16 (1), its
// address a multiple of 16. L: lanes of a period, a power of two with
// L / V <= 256 (V = 4 for f32, 8 for bf16). periods: periods in a tile.
// partial: [B, nt, 2, L] f32 scratch. sums: [B, 2, L] f32.
// Returns the cudaError_t of the launches.
extern "C" int lunaris_lane_sums_partials(const void* x, void* partial,
                                          void* sums, int B, int L,
                                          int periods, int nt, int is_bf16,
                                          void* stream) {
  if (B <= 0 || B > 65535 || L <= 0 || periods <= 0 || nt <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  auto pa = static_cast<float*>(partial);
  auto su = static_cast<float*>(sums);
  if (is_bf16)
    return launch<__nv_bfloat16>(x, pa, su, B, L, periods, nt, s);
  return launch<float>(x, pa, su, B, L, periods, nt, s);
}
