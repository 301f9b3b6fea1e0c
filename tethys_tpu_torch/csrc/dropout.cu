// Dropout y = keep ? x * scale : 0, scale = 1 / (1 - rate), on a contiguous
// tensor that may be one shard of a larger one; the backward is the same
// launch on dy with the same seed and window.
//
// Replaces tethys_tpu/ops/pallas_dropout.py:29 `_kernel` (launched by
// _run, via fused_dropout and module_dropout).  The TPU kernel seeded the
// core's PRNG per 512-row block; here the mask is Philox at the element's
// flat index in the UNSHARDED tensor (philox.cuh), so it depends neither on
// the launch shape nor on how a tensor is sharded: a shard's mask is the
// slice of the whole tensor's mask, as the JAX package's dropout gathers a
// sharded input and draws at the global index (pallas_dropout.py:78-127).
//
// The window.  The shard is a run of segments, each `seg_len` contiguous
// elements of x; segment s starts at the unsharded flat index
//   u(s) = (s / seg_per_outer) * outer_stride + (s % seg_per_outer) * row_stride
//          + base.
// A whole tensor is one segment at base 0; a shard of rows along T
// (sequence parallelism, a probabilities' head or row window) is one
// segment per outer index; a shard of columns (a column-parallel product's
// output) one segment per row.  ops/dropout.py folds a window into that
// form.
//
// What bounds it on an H100: its bytes and its instructions, nearly
// equally.  It reads and writes each element once, 2 * bytes / 3.35 TB/s.
// Each 4 elements take one Philox4x32-10 call (10 rounds of two
// IMAD.WIDE.U32 and two LOP3), then the keep test and the scale, and each
// slot its arithmetic below.  In the SASS (scripts/dropout_probe.py) the
// bf16 loop holds 303 instructions for a slot of 8 elements: 37.9 an
// element, 28.5 of them integer, 10.4 the Philox rounds' IMAD.WIDE.U32
// and LOP3 (f32: 182 for 4; 45.5, 34.0, 12.0), a static count over every
// path of the body, so above what one slot runs.  Timed on an H100 at
// 700 W by the same script, a build of this source without its loads
// takes 89% of the kernel's time at [16, 1500, 512] bf16 (0.0194 against
// 0.0219 ms; copy_ of the same bytes 0.0201) and all of it on a row or
// column shard, whose slots take the window's arithmetic: in bf16 the
// kernel is as bound by issuing its instructions as by its bytes, so
// staging the loads through shared memory (TMA) would not shorten it,
// and the whole tensor takes a shortcut through `locate`.  In f32 (half
// the elements a byte) the load-free build takes 58%: bytes bound it.
//
// The design.  A segment is cut into slots of 16 bytes of elements (8 bf16,
// 4 f32) whose first unsharded index is a multiple of 4, so a slot is whole
// Philox counters: one call per 4 elements whatever the window, where the
// earlier kernel took two for every group of an unaligned window.  Slot 0
// is the segment's ragged head and the last its tail.  The head ends where
// the slots start 16-byte aligned in x when the window keeps x and the
// unsharded index 4-aligned together (the whole tensor, the row and column
// shards), else at the first multiple of 4 of the unsharded index (the
// probabilities' windows at T = 99, whose segments start 0 or 2 mod 4).
// A whole slot moves as one 16-byte load and store where aligned, as
// pairs (4 or 8 bytes) where 2 elements off, element by element
// elsewhere; one instantiation a dtype takes every window.  In bf16 the
// grid is persistent: as many blocks as the card holds at once (the
// occupancy the kernel reports, ops/dropout.plan), fewer for a small
// tensor, which then takes one slot a thread; in f32 every slot has its
// own thread.  A thread loads its slot before the slot's Philox rounds,
// so they run while the load is in flight: 16-byte loads from 2048
// threads an SM (29 registers in bf16, 26 in f32), where the earlier
// kernel loaded 8 bytes of bf16 between its Philox calls.  A slot finds
// its segment by a multiply and a shift (no division); offsets inside a
// segment are 32-bit, the segment's bases 64-bit.
#include <type_traits>

#include "common.cuh"
#include "philox.cuh"

namespace {

constexpr int kThreads = 256;  // ops/dropout.THREADS

struct Window {
  long long seg_len;        // contiguous elements of x per segment
  long long seg_per_outer;  // segments per outer index
  long long outer_stride;   // unsharded elements per outer index
  long long row_stride;     // unsharded elements between a segment and the next
  long long base;           // unsharded index of segment 0's first element
};

// w / d as (w * m) >> p, exact for w < 2^31 (tested against // in
// tests/test_torch_dropout_plan.py).
struct Divider {
  uint32_t m, p;
};

Divider divider(uint32_t d) {
  uint32_t bits = 0;
  while ((1ull << bits) < d) ++bits;
  const uint32_t p = 31 + bits;
  return {(uint32_t)((1ull << p) / d + 1), p};
}

__device__ __forceinline__ uint32_t divide(uint32_t w, Divider d) {
  return (uint32_t)(((uint64_t)w * d.m) >> d.p);
}

struct Plan {
  Window w;
  uint32_t slots_per_seg;  // ceil(seg_len / kVec) + 1
  uint32_t slots;          // segments * slots_per_seg
  Divider per_seg, per_outer;
};

// Where slot `w` lies: x index x0 of its position 0, unsharded index n0
// there (a multiple of 4), and its positions lo <= e < hi inside the
// segment (modelled by tests/test_torch_dropout_plan.py's slot_table).
struct Slot {
  long long x0, n0;
  int lo, hi;
};

template <int kVec>
__device__ __forceinline__ Slot locate(const Plan& p, uint32_t w) {
  Slot s;
  if (p.slots == p.slots_per_seg && p.w.base == 0) {
    // One segment at base 0 (a whole tensor): the arithmetic below at
    // seg 0, without its multiplies (the kernel is near its issue limit in
    // bf16, where a slot takes two Philox calls).
    const int o = ((int)w - 1) * kVec;
    s.x0 = s.n0 = o;
    s.lo = max(0, -o);
    s.hi = min(kVec, (int)p.w.seg_len - o);
    return s;
  }
  const uint32_t seg = divide(w, p.per_seg);
  const int k = (int)(w - seg * p.slots_per_seg) - 1;
  const uint32_t outer =
      p.w.seg_per_outer > 1 ? divide(seg, p.per_outer) : seg;
  const long long u = (long long)outer * p.w.outer_stride +
                      (long long)(seg - outer * (uint32_t)p.w.seg_per_outer) *
                          p.w.row_stride +
                      p.w.base;
  const long long x_seg = (long long)seg * p.w.seg_len;
  const int head = ((u - x_seg) & 3) == 0 ? (int)(-x_seg & (kVec - 1))
                                           : (int)(-u & 3);
  const int o = head + k * kVec;
  const int len = (int)p.w.seg_len;
  s.x0 = x_seg + o;
  s.n0 = u + o;
  s.lo = max(0, -o);
  s.hi = min(kVec, len - o);
  return s;
}

// Elements a load or store of slot s moves: kVec (one 16-byte access)
// where it is whole and 16-byte aligned, 2 where whole and at an even
// index (the odd windows' segments 2 mod 4 off), else 1.
template <int kVec>
__device__ __forceinline__ int access_width(const Slot& s, bool vectors) {
  if (!vectors || s.lo != 0 || s.hi != kVec) return 1;
  return (s.x0 & (kVec - 1)) == 0 ? kVec : (s.x0 & 1) == 0 ? 2 : 1;
}

// Positions lo <= e < hi of a slot from src to dst, `width` at a time.
template <typename T, int kVec>
__device__ __forceinline__ void copy_slot(const T* src, T* dst, int width,
                                          int lo, int hi) {
  using Pair = std::conditional_t<sizeof(T) == 2, uint32_t, uint2>;
  if (width == kVec) {
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
  } else if (width == 2) {
#pragma unroll
    for (int e = 0; e < kVec / 2; ++e)
      reinterpret_cast<Pair*>(dst)[e] = reinterpret_cast<const Pair*>(src)[e];
  } else {
#pragma unroll
    for (int e = 0; e < kVec; ++e)
      if (e >= lo && e < hi) dst[e] = src[e];
  }
}

// Four elements whose keep bits are r's words: x * scale or 0 in f32,
// rounded once to T (bf16 two at a time).
template <typename T>
__device__ __forceinline__ void keep_or_zero(T* v, const uint4& r,
                                             uint32_t threshold, float scale) {
  const uint32_t bits[4] = {r.x, r.y, r.z, r.w};
  float f[4];
#pragma unroll
  for (int lane = 0; lane < 4; ++lane)
    f[lane] = bits[lane] >= threshold ? tethys::to_f32<T>(v[lane]) * scale
                                      : 0.f;
  if constexpr (sizeof(T) == 2) {
    reinterpret_cast<uint32_t*>(v)[0] = tethys::pack_bf16x2(f[0], f[1]);
    reinterpret_cast<uint32_t*>(v)[1] = tethys::pack_bf16x2(f[2], f[3]);
  } else {
#pragma unroll
    for (int lane = 0; lane < 4; ++lane) v[lane] = f[lane];
  }
}

// One slot a thread a pass: the slot's load is issued before its Philox
// rounds, which run while it is in flight.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    dropout_kernel(const T* __restrict__ x, T* __restrict__ y, Plan p,
                   bool vectors, uint32_t seed, uint32_t threshold,
                   float scale) {
  constexpr int kVec = 16 / sizeof(T);
  for (uint32_t w = blockIdx.x * kThreads + threadIdx.x; w < p.slots;
       w += gridDim.x * kThreads) {
    const Slot s = locate<kVec>(p, w);
    if (s.lo >= s.hi) continue;  // an empty head or tail
    const int width = access_width<kVec>(s, vectors);
    alignas(16) T v[kVec];
    copy_slot<T, kVec>(x + s.x0, v, width, s.lo, s.hi);
    // Counters n0 / 4 .. n0 / 4 + kVec / 4 - 1; n0 may lie below 0 for a
    // head slot, whose positions before the segment are not written.
    const uint64_t c0 = (uint64_t)(s.n0 >> 2);
#pragma unroll
    for (int c = 0; c < kVec / 4; ++c)
      keep_or_zero(v + 4 * c, tethys::philox4x32_10(c0 + c, seed), threshold,
                   scale);
    copy_slot<T, kVec>(v, y + s.x0, width, s.lo, s.hi);
  }
}

template <typename T>
int launch(const void* x, void* y, const Plan& p, int blocks, bool vectors,
           uint32_t seed, uint32_t threshold, float scale,
           cudaStream_t stream) {
  dropout_kernel<T><<<blocks, kThreads, 0, stream>>>(
      (const T*)x, (T*)y, p, vectors, seed, threshold, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int occupancy(int* out) {
  int blocks = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, dropout_kernel<T>, kThreads, 0);
  out[0] = blocks;
  out[1] = tethys::sm_count();
  return (int)err;
}

}  // namespace

// x, y: n contiguous f32 (is_bf16 = 0) or bf16 elements; y may not alias x.
// The window (see above): seg_len divides n and is below 2^30,
// seg_per_outer divides the segment count, and the launch has fewer than
// 2^31 slots (ops/dropout.plan cuts a larger shard into launches of at
// most 2^29 elements, each a run of the window at its own base); a whole
// tensor is seg_len = n, seg_per_outer = 1, strides 0, base 0.  blocks:
// the grid (ops/dropout.plan); vectors: x and y are 16-byte aligned.
// threshold = uint32(rate * 2^32) and scale = 1 / (1 - rate) as the
// wrapper computes them.
TETHYS_EXPORT int tethys_dropout(const void* x, void* y, long long n,
                                 long long seg_len, long long seg_per_outer,
                                 long long outer_stride, long long row_stride,
                                 long long base, int blocks, int vectors,
                                 uint32_t seed, uint32_t threshold,
                                 float scale, int is_bf16, void* stream) {
  if (n <= 0 || seg_len <= 0 || seg_len >= (1LL << 30) || n % seg_len ||
      seg_per_outer <= 0 || (n / seg_len) % seg_per_outer ||
      outer_stride < 0 || row_stride < 0 || base < 0 || blocks <= 0)
    return (int)cudaErrorInvalidValue;
  const long long vec = is_bf16 ? 8 : 4;
  const long long per_seg = (seg_len + vec - 1) / vec + 1;
  const long long slots = n / seg_len * per_seg;
  if (slots >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const Plan p{{seg_len, seg_per_outer, outer_stride, row_stride, base},
               (uint32_t)per_seg, (uint32_t)slots, divider((uint32_t)per_seg),
               divider((uint32_t)seg_per_outer)};
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return launch<__nv_bfloat16>(x, y, p, blocks, vectors != 0, seed,
                                 threshold, scale, s);
  return launch<float>(x, y, p, blocks, vectors != 0, seed, threshold, scale,
                       s);
}

// out[0]: blocks an SM (the kernel's occupancy at kThreads); out[1]: SMs.
TETHYS_EXPORT int tethys_dropout_occupancy(int is_bf16, int* out) {
  return is_bf16 ? occupancy<__nv_bfloat16>(out) : occupancy<float>(out);
}
