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

// ---- bf16 tensor-core helpers (sm_80+ instructions, used on sm_90a) -------
//
// mma.sync m16n8k16, bf16 inputs, f32 sums.  Fragments of lane l, with
// g = l / 4 and tg = l % 4 (PTX ISA, "Matrix Fragments for mma.m16n8k16"):
//   A (16 x 16, row-major): a[0] = (g, 2tg..2tg+1), a[1] = (g + 8, 2tg..),
//                           a[2] = (g, 2tg+8..),    a[3] = (g + 8, 2tg+8..)
//   B (16 x 8):             b[0] = (k 2tg..2tg+1, n g), b[1] = (k 2tg+8.., n g)
//   C (16 x 8, f32):        c[0..1] = (g, 2tg..2tg+1), c[2..3] = (g + 8, ..)
// so the C fragments of two neighbouring n-tiles, packed to bf16 pairs, are
// the A fragment of the next product over those 16 columns.
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Four 8 x 8 bf16 matrices from shared memory; lanes 8i .. 8i + 7 give the
// row addresses of matrix i (16-byte aligned), r[i] receives its fragment.
// Plain: lane l gets row l / 4, columns 2 (l % 4) and + 1.  Transposed:
// rows 2 (l % 4) and + 1 of column l / 4.
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const void* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// Two floats rounded to bf16 (nearest even) in one register, lo first.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Asynchronous copies into shared memory (cp.async).  ok = false copies
// nothing and zero-fills the destination; src must still be a valid
// address.  16 bytes needs both addresses 16-byte aligned, 4 bytes 4.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(a),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(a),
               "l"(src), "r"(ok ? 4 : 0));
}

// A kVec-byte copy (16 or 4; both addresses kVec-aligned) that reads only
// the first n bytes of src (0 <= n <= kVec) and zero-fills the rest.
template <int kVec>
__device__ __forceinline__ void cp_async_n(void* dst, const void* src, int n) {
  static_assert(kVec == 16 || kVec == 4, "cp.async takes 16 or 4 bytes here");
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(dst);
  if constexpr (kVec == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(a),
                 "l"(src), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(a),
                 "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Waits until at most kPending of this thread's committed groups are in
// flight; a __syncthreads() after it makes every thread's copies visible.
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// cp_async_wait with a count known at run time, 0 to 3.
__device__ __forceinline__ void cp_async_wait_dyn(int pending) {
  switch (pending) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    default: cp_async_wait<3>(); break;
  }
}

// Rows row0 .. row0 + kRows - 1 of a row-major [n_rows, D] bf16 matrix into
// dst [kRows][DMAX + 8] in shared memory, zeros at rows >= n_rows and
// columns >= D (D <= DMAX).  kVec: 16-byte cp.async copies, which the
// caller commits and waits for (D % 8 == 0 and src 16-byte aligned); else
// 2-byte loads and stores, done when the call returns.
template <int kRows, int DMAX, bool kVec, int kThreads>
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16* dst,
                                               const __nv_bfloat16* src,
                                               int row0, int n_rows, int D) {
  constexpr int kLd = DMAX + 8;
  if constexpr (kVec) {
    constexpr int kChunks = DMAX / 8;
    static_assert(kRows * kChunks % kThreads == 0, "whole copies a thread");
#pragma unroll
    for (int it = 0; it < kRows * kChunks / kThreads; ++it) {
      const int i = threadIdx.x + it * kThreads;
      const int r = i / kChunks, c = (i % kChunks) * 8;
      const bool ok = row0 + r < n_rows && c < D;
      cp_async16(dst + r * kLd + c,
                 ok ? src + (long long)(row0 + r) * D + c : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < kRows * DMAX; i += kThreads) {
      const int r = i / DMAX, c = i % DMAX;
      dst[r * kLd + c] = (row0 + r < n_rows && c < D)
                             ? src[(long long)(row0 + r) * D + c]
                             : __float2bfloat16_rn(0.f);
    }
  }
}

// kVec consecutive elements of T as raw bits: one 16-byte word where kVec
// elements fill 16 bytes (8 bf16 or 4 f32), else kVec scalars.  load_pack
// reads them (the 16-byte form needs a 16-byte aligned address), unpack
// widens them to f32, store_pack rounds kVec floats to T (nearest even) and
// writes them.
template <typename T, int kVec>
struct Pack {
  T v[kVec];
};
template <>
struct Pack<float, 4> {
  uint4 u;
};
template <>
struct Pack<__nv_bfloat16, 8> {
  uint4 u;
};

template <typename T, int kVec>
__device__ __forceinline__ Pack<T, kVec> load_pack(const T* p) {
  Pack<T, kVec> r;
  if constexpr (kVec * sizeof(T) == 16) {
    r.u = __ldg(reinterpret_cast<const uint4*>(p));
  } else {
#pragma unroll
    for (int i = 0; i < kVec; ++i) r.v[i] = p[i];
  }
  return r;
}

template <typename T, int kVec>
__device__ __forceinline__ void unpack(const Pack<T, kVec>& r, float* f) {
  if constexpr (kVec * sizeof(T) != 16) {
#pragma unroll
    for (int i = 0; i < kVec; ++i) f[i] = to_f32<T>(r.v[i]);
  } else if constexpr (sizeof(T) == 4) {
    f[0] = __uint_as_float(r.u.x);
    f[1] = __uint_as_float(r.u.y);
    f[2] = __uint_as_float(r.u.z);
    f[3] = __uint_as_float(r.u.w);
  } else {
    const uint32_t w[4] = {r.u.x, r.u.y, r.u.z, r.u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
}

template <typename T, int kVec>
__device__ __forceinline__ void store_pack(T* p, const float* f) {
  if constexpr (kVec * sizeof(T) != 16) {
#pragma unroll
    for (int i = 0; i < kVec; ++i) p[i] = from_f32<T>(f[i]);
  } else if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<uint4*>(p) =
        make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                   __float_as_uint(f[2]), __float_as_uint(f[3]));
  } else {
    *reinterpret_cast<uint4*>(p) =
        make_uint4(pack_bf16x2(f[0], f[1]), pack_bf16x2(f[2], f[3]),
                   pack_bf16x2(f[4], f[5]), pack_bf16x2(f[6], f[7]));
  }
}

// The current device's number of SMs (host side; read once per device).
inline int sm_count() {
  static int cached[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 64 && cached[dev]) return cached[dev];
  int n = 0;
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  if (dev < 64) cached[dev] = n;
  return n;
}

// Max (is_max) or sum of v over a block of kWarps full warps, returned to
// every thread.  s_red holds kWarps floats; the block must reach the call
// together.
template <int kWarps>
__device__ float block_reduce(float v, float* s_red, bool is_max) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = is_max ? warp_max(v) : warp_sum(v);
  if (lane == 0) s_red[warp] = v;
  __syncthreads();
  float r = s_red[0];
  for (int w = 1; w < kWarps; ++w) r = is_max ? fmaxf(r, s_red[w]) : r + s_red[w];
  __syncthreads();  // s_red may be reused by the next reduction
  return r;
}

}  // namespace tethys
