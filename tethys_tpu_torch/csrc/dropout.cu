// Dropout y = keep ? x * scale : 0, scale = 1 / (1 - rate), on a flat
// contiguous tensor; the backward is the same launch on dy with the same
// seed.
//
// Replaces tethys_tpu/ops/pallas_dropout.py::_kernel (launched by _run, via
// fused_dropout and module_dropout).  The TPU kernel seeded the core's PRNG
// per 512-row block; here the mask is Philox at the element's flat index
// (philox.cuh), so it does not depend on the launch shape and the plain
// torch version draws the same bits.
//
// What bounds it on an H100: device memory.  It reads and writes each
// element once, so its floor is 2 * bytes / 3.35 TB/s; the Philox rounds
// (about 100 integer operations per four elements) stay under that at bf16.
// The design: each thread takes one group of four consecutive elements
// (one Philox call, its four outputs one per element), moved as one 16-byte
// (f32) or 8-byte (bf16) vector when both pointers allow it.
#include "common.cuh"
#include "philox.cuh"

namespace {

template <typename T>
struct Vec4;
template <>
struct Vec4<float> {
  using type = float4;
};
template <>
struct Vec4<__nv_bfloat16> {
  using type = uint2;
};

template <typename T>
__global__ void __launch_bounds__(256)
    dropout_kernel(const T* __restrict__ x, T* __restrict__ y, long long n,
                   uint32_t seed, uint32_t threshold, float scale,
                   bool vectors) {
  using V = typename Vec4<T>::type;
  const long long groups = (n + 3) / 4;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       g < groups; g += stride) {
    const uint4 r = tethys::philox4x32_10((uint64_t)g, seed);
    const long long i0 = 4 * g;
    if (vectors && i0 + 4 <= n) {
      alignas(16) T v[4];
      *reinterpret_cast<V*>(v) = *reinterpret_cast<const V*>(x + i0);
#pragma unroll
      for (int lane = 0; lane < 4; ++lane) {
        const bool keep = tethys::philox_lane(r, lane) >= threshold;
        v[lane] = tethys::from_f32<T>(
            keep ? tethys::to_f32<T>(v[lane]) * scale : 0.f);
      }
      *reinterpret_cast<V*>(y + i0) = *reinterpret_cast<const V*>(v);
    } else {
      for (int lane = 0; lane < 4 && i0 + lane < n; ++lane) {
        const bool keep = tethys::philox_lane(r, lane) >= threshold;
        y[i0 + lane] = tethys::from_f32<T>(
            keep ? tethys::to_f32<T>(x[i0 + lane]) * scale : 0.f);
      }
    }
  }
}

template <typename T>
int launch(const void* x, void* y, long long n, uint32_t seed,
           uint32_t threshold, float scale, cudaStream_t stream) {
  const bool vectors = ((uintptr_t)x % (4 * sizeof(T))) == 0 &&
                       ((uintptr_t)y % (4 * sizeof(T))) == 0;
  const long long groups = (n + 3) / 4;
  long long blocks = (groups + 255) / 256;
  if (blocks > 132 * 32) blocks = 132 * 32;  // grid-stride beyond this
  dropout_kernel<T><<<(int)blocks, 256, 0, stream>>>(
      (const T*)x, (T*)y, n, seed, threshold, scale, vectors);
  return (int)cudaGetLastError();
}

}  // namespace

// x, y: n contiguous f32 (is_bf16 = 0) or bf16 elements; y may not alias x.
// threshold = uint32(rate * 2^32) and scale = 1 / (1 - rate) as the
// wrapper computes them.
TETHYS_EXPORT int tethys_dropout(const void* x, void* y, long long n,
                                 uint32_t seed, uint32_t threshold,
                                 float scale, int is_bf16, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return launch<__nv_bfloat16>(x, y, n, seed, threshold, scale, s);
  return launch<float>(x, y, n, seed, threshold, scale, s);
}
