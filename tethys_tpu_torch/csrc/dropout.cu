// Dropout y = keep ? x * scale : 0, scale = 1 / (1 - rate), on a contiguous
// tensor that may be one shard of a larger one; the backward is the same
// launch on dy with the same seed and window.
//
// Replaces tethys_tpu/ops/pallas_dropout.py::_kernel (launched by _run, via
// fused_dropout and module_dropout).  The TPU kernel seeded the core's PRNG
// per 512-row block; here the mask is Philox at the element's flat index in
// the UNSHARDED tensor (philox.cuh), so it depends neither on the launch
// shape nor on how a tensor is sharded: a shard's mask is the slice of the
// whole tensor's mask, as the JAX package's dropout gathers a sharded input
// and draws at the global index (pallas_dropout.py:78-127).
//
// The window.  The shard is a run of segments, each `seg_len` contiguous
// elements of x; segment s starts at the unsharded flat index
//   (s / seg_per_outer) * outer_stride + (s % seg_per_outer) * row_stride
//   + base.
// A whole tensor is one segment at base 0 (every element at its own flat
// index: the bits the kernel drew before it took a window); a shard of rows
// along T (sequence parallelism) is one segment per outer index; a shard of
// columns (a column-parallel product's output) one segment per row.  The
// wrapper (ops/dropout.py) folds a window into that form.
//
// What bounds it on an H100: device memory.  It reads and writes each
// element once, so its floor is 2 * bytes / 3.35 TB/s; the Philox rounds
// (about 100 integer operations per four elements) stay under that at bf16.
// The design: thread (x, y) of block (bx, by, bz) takes groups of four
// consecutive elements of a segment, the segments of one outer index along
// y and the outer indices along z, each dimension a grid-stride loop, so a
// segment's start is computed once per segment and no group divides.  The
// block is 256 threads, as wide in x as the segment has groups (32 at
// least), so a shard of short rows fills its warps.  A group is one Philox
// call, its four outputs one per element, when its first unsharded index is
// a multiple of 4, else the two calls that cover it; moved as one 16-byte
// (f32) or 8-byte (bf16) vector when the group is whole and both pointers
// allow it.  The kernel is compiled twice: for windows whose every group
// starts at a multiple of 4 (the whole tensor and every window of the
// training paths) and for the rest.  One kernel for both held a second
// Philox call's registers (48 a thread against 28-29 for sm_90a), which
// cost the whole tensor a third of its time on an H100.
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

struct Window {
  long long seg_len;        // contiguous elements of x per segment
  long long seg_per_outer;  // segments per outer index
  long long outer_stride;   // unsharded elements per outer index
  long long row_stride;     // unsharded elements between a segment and the next
  long long base;           // unsharded index of segment 0's first element
};

// Four elements of x at i0 (len of them, 1 .. 4) whose keep bits are
// lanes 0 .. 3 of `bits`; one 16-byte (f32) or 8-byte (bf16) vector when
// whole and aligned.
template <typename T>
__device__ __forceinline__ void apply4(const T* __restrict__ x,
                                       T* __restrict__ y, long long i0,
                                       int len, const uint32_t bits[4],
                                       uint32_t threshold, float scale,
                                       bool vectors) {
  using V = typename Vec4<T>::type;
  if (vectors && len == 4) {
    alignas(16) T v[4];
    *reinterpret_cast<V*>(v) = *reinterpret_cast<const V*>(x + i0);
#pragma unroll
    for (int lane = 0; lane < 4; ++lane) {
      const bool keep = bits[lane] >= threshold;
      v[lane] = tethys::from_f32<T>(
          keep ? tethys::to_f32<T>(v[lane]) * scale : 0.f);
    }
    *reinterpret_cast<V*>(y + i0) = *reinterpret_cast<const V*>(v);
  } else {
#pragma unroll
    for (int lane = 0; lane < 4; ++lane) {  // constant lanes: bits in registers
      if (lane < len) {
        const bool keep = bits[lane] >= threshold;
        y[i0 + lane] = tethys::from_f32<T>(
            keep ? tethys::to_f32<T>(x[i0 + lane]) * scale : 0.f);
      }
    }
  }
}

// Segment (z, j) (outer index z, segment j of it) holds elements
// (z * seg_per_outer + j) * seg_len .. + seg_len - 1 of x; its group k is
// elements 4k .. 4k + 3 of it, whose first unsharded index is n0.
// kAligned: every n0 is a multiple of 4 (the whole tensor and every window
// whose offsets and segments are), so no group takes a second Philox call.
template <typename T, bool kAligned>
__global__ void __launch_bounds__(256)
    dropout_kernel(const T* __restrict__ x, T* __restrict__ y,
                   long long outers, Window w, uint32_t seed,
                   uint32_t threshold, float scale, bool vectors) {
  const long long per_seg = (w.seg_len + 3) / 4;
  for (long long z = blockIdx.z; z < outers; z += gridDim.z) {
    for (long long j = (long long)blockIdx.y * blockDim.y + threadIdx.y;
         j < w.seg_per_outer; j += (long long)gridDim.y * blockDim.y) {
      const long long x0 = (z * w.seg_per_outer + j) * w.seg_len;
      const long long u0 = z * w.outer_stride + j * w.row_stride + w.base;
      for (long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
           k < per_seg; k += (long long)gridDim.x * blockDim.x) {
        const uint64_t n0 = (uint64_t)(u0 + 4 * k);
        const uint32_t off = (uint32_t)(n0 & 3);
        const uint4 r0 = tethys::philox4x32_10(n0 >> 2, seed);
        uint32_t bits[4] = {r0.x, r0.y, r0.z, r0.w};
        if (!kAligned && off) {
          const uint4 r1 = tethys::philox4x32_10((n0 >> 2) + 1, seed);
#pragma unroll
          for (int lane = 0; lane < 4; ++lane) {
            const int t = (int)off + lane;
            bits[lane] = t < 4 ? tethys::philox_lane(r0, t)
                               : tethys::philox_lane(r1, t - 4);
          }
        }
        apply4(x, y, x0 + 4 * k, (int)min(4LL, w.seg_len - 4 * k), bits,
               threshold, scale, vectors);
      }
    }
  }
}

template <typename T>
int launch(const void* x, void* y, long long n, const Window& w,
           uint32_t seed, uint32_t threshold, float scale,
           cudaStream_t stream) {
  const long long segments = n / w.seg_len;
  const long long outers = segments / w.seg_per_outer;
  // Whole groups sit at multiples of 4 elements of x when every segment
  // does.
  const bool vectors = ((uintptr_t)x % (4 * sizeof(T))) == 0 &&
                       ((uintptr_t)y % (4 * sizeof(T))) == 0 &&
                       (segments == 1 || w.seg_len % 4 == 0);
  const bool aligned = w.base % 4 == 0 &&
                       (segments == 1 || (w.row_stride % 4 == 0 &&
                                          w.outer_stride % 4 == 0));
  const long long per_seg = (w.seg_len + 3) / 4;
  int tx = 32;
  while (tx < 256 && tx < per_seg) tx *= 2;
  const dim3 block(tx, 256 / tx);
  long long gx = (per_seg + tx - 1) / tx;
  long long gy = (w.seg_per_outer + block.y - 1) / block.y;
  if (gx > 132 * 32) gx = 132 * 32;  // grid-stride beyond these
  if (gy > 65535) gy = 65535;
  const dim3 grid((unsigned)gx, (unsigned)gy,
                  (unsigned)(outers < 65535 ? outers : 65535));
  if (aligned)
    dropout_kernel<T, true><<<grid, block, 0, stream>>>(
        (const T*)x, (T*)y, outers, w, seed, threshold, scale, vectors);
  else
    dropout_kernel<T, false><<<grid, block, 0, stream>>>(
        (const T*)x, (T*)y, outers, w, seed, threshold, scale, vectors);
  return (int)cudaGetLastError();
}

}  // namespace

// x, y: n contiguous f32 (is_bf16 = 0) or bf16 elements; y may not alias x.
// The window (see above): seg_len divides n, seg_per_outer divides the
// segment count; a whole tensor is seg_len = n, seg_per_outer = 1, strides
// 0, base 0.
// threshold = uint32(rate * 2^32) and scale = 1 / (1 - rate) as the wrapper
// computes them.
TETHYS_EXPORT int tethys_dropout(const void* x, void* y, long long n,
                                 long long seg_len, long long seg_per_outer,
                                 long long outer_stride, long long row_stride,
                                 long long base, uint32_t seed,
                                 uint32_t threshold, float scale, int is_bf16,
                                 void* stream) {
  if (n <= 0 || seg_len <= 0 || n % seg_len || seg_per_outer <= 0 ||
      (n / seg_len) % seg_per_outer || outer_stride < 0 || row_stride < 0 ||
      base < 0)
    return (int)cudaErrorInvalidValue;
  const Window w{seg_len, seg_per_outer, outer_stride, row_stride, base};
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return launch<__nv_bfloat16>(x, y, n, w, seed, threshold, scale, s);
  return launch<float>(x, y, n, w, seed, threshold, scale, s);
}
