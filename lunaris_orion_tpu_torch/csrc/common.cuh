// Conversions, 16-byte loads and the activation shared by the kernels of this directory.
// The build hashes this header with the sources, so an edit builds anew.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

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

// Round an f32 value to T and back: the cast the TPU kernels make before
// their matrix unit.
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f32<T>(from_f32<T>(v));
}

__device__ __forceinline__ float mish_f32(float v) {
  // Stable softplus: log1p(exp(v)) overflows past ~88; above 20 it equals v in f32.
  const float sp = v > 20.f ? v : log1pf(expf(v));
  return v * tanhf(sp);
}

}  // namespace
