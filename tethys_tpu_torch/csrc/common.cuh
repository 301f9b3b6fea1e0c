// Shared helpers for the port's CUDA kernels.
//
// Every kernel source exports one C function (see utils/kernel_lib.py for
// the ctypes signatures).  Each C function launches on the stream it is
// given, allocates nothing, never synchronises, and returns
// cudaGetLastError() so that the Python wrapper can raise on a refused
// launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define TETHYS_EXPORT extern "C" __attribute__((visibility("default")))

namespace tethys {

template <typename T>
__device__ __forceinline__ float to_f32(T x);

template <>
__device__ __forceinline__ float to_f32<float>(float x) {
  return x;
}

template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);

template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}

// Round to nearest even, as torch's and jax's float32 -> bfloat16 casts do.
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Rounds x to T and back: the value a cast to the compute dtype keeps.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32<T>(from_f32<T>(x));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

}  // namespace tethys
