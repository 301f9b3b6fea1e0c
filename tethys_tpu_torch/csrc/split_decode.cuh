// One query token against a transposed cache [D, T], with the key axis
// split over a thread-block cluster: the kernel that csrc/decode_self.cu and
// csrc/q8_cross.cu instantiate (see their source notes for what each
// computes and why it is built this way).
//
// One cluster of S <= 8 blocks per (batch, head); rank r owns the columns
// [r * chunk, min(n_valid, (r + 1) * chunk)).  The host picks S (at least
// min_cols columns a rank) so that the waves of B * H * S blocks on the
// card, times the columns each block holds, are fewest.  A block loads its slice as tiles of D rows x tc columns (up to
// 16 KB, so a whole slice at whisper's shapes: one K tile and one V tile)
// into a ring of up to 4 tiles in shared memory, every copy issued at the
// start where the ring holds them all (cp.async, 16 or 4 bytes a copy, or
// plain element loads when the rows are not 4-byte aligned).  Then, in the
// order of the Pallas kernels:
//   1. scores over the slice in f32 into shared memory, the block's max;
//   2. the cluster's max m: every block stores its max into every block's
//      shared memory (st.async, counted by an mbarrier there) and combines
//      the S values;
//   3. the block's sum of exp(s - m), then the cluster's sum l the same way,
//      added in rank order by every block;
//   4. p = exp(s - m) / l (times the column's V scale in the int8 kernel),
//      rounded to the compute dtype, then the block's partial out[d] over
//      its slice in f32;
//   5. every other rank stores its partial into rank 0's shared memory;
//      rank 0 adds the S partials in rank order and rounds the output once.
// No atomics, and no cluster-wide barrier after the first: a cluster
// barrier's release compiles to a GPU-scope memory fence, which cost about
// a microsecond each.  Two launches on the same inputs give the same bits.
// Columns at or past n_valid are never read; copies that straddle the end
// read only the valid bytes and zero-fill the rest.
#pragma once

#include <cooperative_groups.h>
#include <math.h>

#include <algorithm>

#include "common.cuh"
#include "hopper.cuh"

namespace tethys {
namespace split_decode {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSm = 8;     // __launch_bounds__: at most 64 registers
constexpr int kMaxRing = 4;  // tiles of a block in flight (cp_async_wait_dyn)
constexpr int kTileBytes = 16384;   // a tile's most bytes
constexpr int kMaxTile = 512;       // a tile's most columns
constexpr int kMaxCluster = 8;      // the portable cluster size
// The output pass: thread (r, c) sums rows r, r + kRowGroups, ... over the
// column quads c, c + kQuadLanes, ...; the kQuadLanes lanes of a row set
// are neighbours in one warp.
constexpr int kRowGroups = 16;
constexpr int kQuadLanes = kThreads / kRowGroups;
constexpr int kMaxRows = 16;
constexpr int kMaxD = kRowGroups * kMaxRows;  // 256

struct Params {
  const void* q;      // [BH, D], compute dtype
  void* k;            // [BH, D, ld] caches
  void* v;
  const float* sk;    // [BH, ld] column scales (int8 caches only)
  const float* sv;
  const void* k_new;  // [BH, D], written at column n_valid - 1 (append only)
  const void* v_new;
  void* out;          // [BH, D], compute dtype
  int D, ld, n_valid;
  int chunk, chunk_pad, tc, groups, slots;  // from the Plan
};

// st.async: v into the shared memory of cluster rank `rank` at the offset of
// `local` (a variable every block of the cluster has at the same offset),
// counted as 4 bytes of the transactions of that block's barrier `bar`.
__device__ __forceinline__ void push(float* local, uint64_t* bar, int rank,
                                     float v) {
  uint32_t ra, rb;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(ra) : "r"(hopper::smem_u32(local)), "r"(rank));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(rb) : "r"(hopper::smem_u32(bar)), "r"(rank));
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];\n" ::"r"(ra), "r"(__float_as_uint(v)), "r"(rb)
      : "memory");
}

// Raw bits of one cache element, for the element-wise loads.
template <int kSize> struct Bits;
template <> struct Bits<1> { using type = uint8_t; };
template <> struct Bits<2> { using type = uint16_t; };
template <> struct Bits<4> { using type = uint32_t; };

// Four consecutive cache elements from shared memory, as f32.  int8: each
// byte b + 128 goes into the mantissa of 2^23 by a byte permute, and one
// f32 subtraction of 2^23 + 128 leaves b exactly, which costs less than
// the int-to-float conversions (a quarter of the FFMA rate on an SM).
__device__ __forceinline__ void load4(const int8_t* p, float* f) {
  const uint32_t w = *reinterpret_cast<const uint32_t*>(p) ^ 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __int_as_float(__byte_perm(w, 0x4b000000u, 0x7540 + i)) - 8388736.f;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* f) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  f[0] = __uint_as_float(u.x << 16);
  f[1] = __uint_as_float(u.x & 0xffff0000u);
  f[2] = __uint_as_float(u.y << 16);
  f[3] = __uint_as_float(u.y & 0xffff0000u);
}

__device__ __forceinline__ void load4(const float* p, float* f) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x;
  f[1] = v.y;
  f[2] = v.z;
  f[3] = v.w;
}

// Columns [0, tc) of D rows of src (row stride ld) into dst [D][tc]; columns
// at or past n (which may be <= 0) are zeros and are not read.  kVec > 0:
// cp.async copies the caller commits; 0: loads done when this returns.
// Thread i takes copies i, i + kThreads, ... in row-major order.
template <typename E, int kVec>
__device__ __forceinline__ void load_tile(E* dst, const E* src, int D, int ld,
                                          int tc, int n) {
  constexpr int kPer = kVec > 0 ? kVec / (int)sizeof(E) : 1;
  const int nv = tc / kPer, dd = kThreads / nv, dv = kThreads - dd * nv;
  int d = threadIdx.x / nv, v = threadIdx.x - d * nv;
  while (d < D) {
    const int c = v * kPer, valid = min(max(n - c, 0), kPer);
    const E* s = src + (long long)d * ld + c;
    if constexpr (kVec > 0) {
      cp_async_n<kVec>(dst + d * tc + c, valid ? s : src,
                       valid * (int)sizeof(E));
    } else {
      using R = typename Bits<sizeof(E)>::type;
      reinterpret_cast<R*>(dst)[d * tc + c] =
          valid ? *reinterpret_cast<const R*>(s) : R(0);
    }
    d += dd;
    v += dv;
    if (v >= nv) {
      v -= nv;
      ++d;
    }
  }
}

// T: the compute dtype of q and out; E: the cache's element; kQ8: int8
// caches with column scales (else the caches are T and the kernel appends
// k_new, v_new at column n_valid - 1); kVec: the copy width in bytes.
template <typename T, typename E, bool kQ8, int kVec>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    split_decode_kernel(Params p) {
  namespace cg = cooperative_groups;
  const cg::cluster_group cluster = cg::this_cluster();
  const int S = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const long long bh = blockIdx.x / S;
  const int tid = threadIdx.x;
  const int D = p.D, ld = p.ld, tc = p.tc, G = p.groups, slots = p.slots;
  const int lo = rank * p.chunk, hi = min(p.n_valid, lo + p.chunk);
  const int len = max(hi - lo, 0), nk = (len + tc - 1) / tc;
  // The append's column, the last valid one: never read from the cache.
  const int idx = p.n_valid - 1;
  const bool owns_idx = !kQ8 && idx >= lo && idx < hi;
  const int load_hi = owns_idx ? idx : hi;

  // The three exchanges (every rank's max, every rank's sum, the other
  // ranks' partial outputs to rank 0), each an mbarrier that completes
  // when all of its bytes have landed.
  __shared__ __align__(8) uint64_t s_bar[3];
  __shared__ float s_m[kMaxCluster], s_l[kMaxCluster];
  __shared__ float s_red[kWarps];
  extern __shared__ __align__(16) uint8_t smem[];
  E* ring = reinterpret_cast<E*>(smem);                      // [slots][D][tc]
  // [G][tc] score partials, then (rank 0) [S][D] partial outputs.
  float* s_part = reinterpret_cast<float*>(ring + slots * D * tc);
  float* s_out = s_part;
  float* s_p = s_part + max(G * tc, (S * D + 3) & ~3);  // [chunk_pad]: s, p
  float* s_sk = s_p + p.chunk_pad;           // int8: [chunk_pad] each
  float* s_sv = s_sk + (kQ8 ? p.chunk_pad : 0);
  float* s_q = s_sv + (kQ8 ? p.chunk_pad : 0);  // [D]
  E* s_new = reinterpret_cast<E*>(s_q + D);     // append: [2][D]

  if (tid == 0) {
    for (int i = 0; i < 3; ++i) hopper::mbar_init(&s_bar[i], 1);
    hopper::fence_barrier_init();
    hopper::mbar_arrive_expect_tx(&s_bar[0], 4 * S);
    hopper::mbar_arrive_expect_tx(&s_bar[1], 4 * S);
    hopper::mbar_arrive_expect_tx(&s_bar[2], rank == 0 ? 4 * (S - 1) * D : 0);
  }
  // Every block's barriers exist before any block stores into it: arrive
  // now, wait before the first store.
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  E* kc = static_cast<E*>(p.k) + bh * D * ld;
  E* vc = static_cast<E*>(p.v) + bh * D * ld;
  // Tile j < nk is K's tile j, then V's; one commit group each (the
  // scales ride with the first), empty groups past the end.
  auto issue = [&](int j) {
    if (j < 2 * nk) {
      const int c0 = lo + (j < nk ? j : j - nk) * tc;
      load_tile<E, kVec>(ring + (j % slots) * D * tc, (j < nk ? kc : vc) + c0,
                         D, ld, tc, load_hi - c0);
    }
    cp_async_commit();
  };
  if constexpr (kQ8) {
    const float* skr = p.sk + bh * ld + lo;
    const float* svr = p.sv + bh * ld + lo;
    for (int t = tid; t < p.chunk_pad; t += kThreads) {
      const int bytes = t < len ? 4 : 0;
      cp_async_n<4>(s_sk + t, bytes ? skr + t : p.sk, bytes);
      cp_async_n<4>(s_sv + t, bytes ? svr + t : p.sv, bytes);
    }
  }
  for (int j = 0; j < slots; ++j) issue(j);

  // q and, for the append, the new column, while the tiles are in flight.
  for (int d = tid; d < D; d += kThreads) {
    s_q[d] = to_f32<T>(static_cast<const T*>(p.q)[bh * D + d]);
    if constexpr (!kQ8) {
      const E kn = static_cast<const E*>(p.k_new)[bh * D + d];
      const E vn = static_cast<const E*>(p.v_new)[bh * D + d];
      s_new[d] = kn;
      s_new[D + d] = vn;
      if (owns_idx) {
        kc[(long long)d * ld + idx] = kn;
        vc[(long long)d * ld + idx] = vn;
      }
    }
  }

  // 1. Scores: thread (g, c) sums rows [g D / G, (g + 1) D / G) of the
  // column quad c; the G partials are added in order of g.
  const int n4 = tc / 4, sg = tid / n4, sc = tid - sg * n4;
  float local_max = -INFINITY;
  for (int j = 0; j < nk; ++j) {
    cp_async_wait_dyn(slots - 1);
    __syncthreads();
    E* tile = ring + (j % slots) * D * tc;
    const int c0 = lo + j * tc, w = min(tc, hi - c0);
    if (owns_idx && idx < c0 + w) {
      for (int d = tid; d < D; d += kThreads) tile[d * tc + idx - c0] = s_new[d];
      __syncthreads();
    }
    if (sg < G) {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      const E* col = tile + 4 * sc;
      for (int d = sg * D / G; d < (sg + 1) * D / G; ++d) {
        float kv[4];
        load4(col + d * tc, kv);
        const float qd = s_q[d];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i] = fmaf(qd, kv[i], acc[i]);
      }
      *reinterpret_cast<float4*>(s_part + sg * tc + 4 * sc) =
          make_float4(acc[0], acc[1], acc[2], acc[3]);
    }
    __syncthreads();
    for (int t = tid; t < w; t += kThreads) {
      float s = s_part[t];
      for (int g = 1; g < G; ++g) s += s_part[g * tc + t];
      if constexpr (kQ8) s *= s_sk[c0 - lo + t];
      s_p[c0 - lo + t] = s;
      local_max = fmaxf(local_max, s);
    }
    __syncthreads();
    issue(j + slots);
  }

  // 2-3. The cluster's max and sum: thread r < S stores the block's value
  // into rank r's s_m[rank] (then s_l[rank]); each block combines the S
  // values in rank order.
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  const float m_blk = block_reduce<kWarps>(local_max, s_red, true);
  if (tid < S) push(&s_m[rank], &s_bar[0], tid, m_blk);
  hopper::mbar_wait(&s_bar[0], 0);
  float m = s_m[0];
  for (int r = 1; r < S; ++r) m = fmaxf(m, s_m[r]);
  float local_sum = 0.f;
  for (int t = tid; t < len; t += kThreads) {
    const float e = expf(s_p[t] - m);
    s_p[t] = e;
    local_sum += e;
  }
  const float l_blk = block_reduce<kWarps>(local_sum, s_red, false);
  if (tid < S) push(&s_l[rank], &s_bar[1], tid, l_blk);
  hopper::mbar_wait(&s_bar[1], 0);
  float l = s_l[0];
  for (int r = 1; r < S; ++r) l += s_l[r];

  // 4. p with the global m and l, rounded as the Pallas kernels round it.
  for (int t = tid; t < p.chunk_pad; t += kThreads) {
    float pt = 0.f;
    if (t < len) pt = kQ8 ? round_to<T>(s_p[t] / l * s_sv[t]) : round_to<T>(s_p[t] / l);
    s_p[t] = pt;
  }
  // The partial output, in registers across the tiles.
  const int oc = tid % kQuadLanes, orow = tid / kQuadLanes;
  float acc[kMaxRows];
#pragma unroll
  for (int i = 0; i < kMaxRows; ++i) acc[i] = 0.f;
  for (int j = nk; j < 2 * nk; ++j) {
    cp_async_wait_dyn(slots - 1);
    __syncthreads();
    E* tile = ring + (j % slots) * D * tc;
    const int c0 = lo + (j - nk) * tc, w = min(tc, hi - c0);
    if (owns_idx && idx < c0 + w) {
      for (int d = tid; d < D; d += kThreads) tile[d * tc + idx - c0] = s_new[D + d];
      __syncthreads();
    }
    const float* pp = s_p + (c0 - lo);
    for (int c = oc; c < (w + 3) / 4; c += kQuadLanes) {
      const float4 p4 = *reinterpret_cast<const float4*>(pp + 4 * c);
      const E* col = tile + 4 * c;
#pragma unroll
      for (int i = 0; i < kMaxRows; ++i) {
        const int d = orow + kRowGroups * i;
        if (d >= D) break;
        float vv[4];
        load4(col + d * tc, vv);
        acc[i] = fmaf(p4.x, vv[0], acc[i]);
        acc[i] = fmaf(p4.y, vv[1], acc[i]);
        acc[i] = fmaf(p4.z, vv[2], acc[i]);
        acc[i] = fmaf(p4.w, vv[3], acc[i]);
      }
    }
    __syncthreads();
    issue(j + slots);
  }
  cp_async_wait<0>();

  // 5. The kQuadLanes lanes of a row set add their sums; every other rank
  // stores its partial into rank 0's s_out[rank] and is done; rank 0 adds
  // the S partials in rank order and rounds once.
  const unsigned lanes = 0xffu << ((tid & 31) & ~(kQuadLanes - 1));
#pragma unroll
  for (int i = 0; i < kMaxRows; ++i) {
    const int d = orow + kRowGroups * i;
    if (d >= D) break;
    float a = acc[i];
#pragma unroll
    for (int off = kQuadLanes / 2; off > 0; off >>= 1)
      a += __shfl_xor_sync(lanes, a, off);
    if (oc == 0) {
      if (rank == 0)
        s_out[d] = a;
      else
        push(&s_out[rank * D + d], &s_bar[2], 0, a);
    }
  }
  if (rank == 0) {
    __syncthreads();
    hopper::mbar_wait(&s_bar[2], 0);
    for (int d = tid; d < D; d += kThreads) {
      float sum = s_out[d];
      for (int r = 1; r < S; ++r) sum += s_out[r * D + d];
      static_cast<T*>(p.out)[bh * D + d] = from_f32<T>(sum);
    }
  }
}

inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

// How a launch splits the work: S blocks a cluster, chunk columns a rank,
// tiles of tc columns, G row groups in the score pass, ring slots, shared
// memory.
struct Plan {
  int S, chunk, chunk_pad, tc, groups, slots;
  size_t smem;
};

inline Plan plan_for(int S, int n_valid, int D, int esize, bool q8) {
  Plan pl;
  pl.chunk = ceil_div(ceil_div(n_valid, S), 16) * 16;
  pl.S = ceil_div(n_valid, pl.chunk);  // every rank holds a column
  const int tc = std::min(kMaxTile, kTileBytes / (D * esize) / 16 * 16);
  pl.tc = std::min(std::max(tc, 16), pl.chunk);
  pl.chunk_pad = ceil_div(pl.chunk, pl.tc) * pl.tc;
  pl.groups = std::min(D, std::max(1, kThreads / (pl.tc / 4)));
  // Every tile of the slice in flight at once where kMaxRing allows.
  pl.slots = std::min(kMaxRing, 2 * (pl.chunk_pad / pl.tc));
  pl.smem = (size_t)pl.slots * D * pl.tc * esize +
            sizeof(float) * ((size_t)std::max(pl.groups * pl.tc,
                                              (pl.S * D + 3) & ~3) +
                             (size_t)pl.chunk_pad * (q8 ? 3 : 1) + D) +
            (q8 ? 0 : (size_t)2 * D * esize);
  return pl;
}

constexpr size_t kMaxSmem = 227 * 1024;  // a block's dynamic shared memory

// S (at most kMaxCluster, at least min_cols columns a rank): the one whose
// waves of blocks times the columns a block holds is least (the larger S
// on a tie), among those whose slice fits a block's shared memory.
inline Plan make_plan(int BH, int n_valid, int D, int esize, bool q8,
                      int min_cols) {
  const long long sms = sm_count();
  const int s_max = std::min(kMaxCluster, ceil_div(n_valid, min_cols));
  Plan best = plan_for(s_max, n_valid, D, esize, q8);
  long long best_cost = -1;
  for (int S = s_max; S >= 1; --S) {
    const Plan pl = plan_for(S, n_valid, D, esize, q8);
    if (pl.smem > kMaxSmem) break;  // fewer ranks need more
    // An SM's 228 KB of shared memory, 1 KB of it reserved for each block.
    const long long per_sm = std::min<long long>(
        kBlocksPerSm, 233472 / ((long long)pl.smem + 1024 + 256));
    const long long waves = ((long long)BH * pl.S + per_sm * sms - 1) /
                            (per_sm * sms);
    const long long cost = waves * pl.chunk;
    if (best_cost < 0 || cost < best_cost) {
      best = pl;
      best_cost = cost;
    }
  }
  return best;
}

// The widest copy every row start of both caches allows: 16, 4 or 0
// (element loads).
inline int copy_bytes(const void* a, const void* b, long long row_bytes) {
  const uintptr_t addr = (uintptr_t)a | (uintptr_t)b;
  if (row_bytes % 16 == 0 && addr % 16 == 0) return 16;
  if (row_bytes % 4 == 0 && addr % 4 == 0) return 4;
  return 0;
}

template <typename T, typename E, bool kQ8, int kVec>
int launch_kernel(const Params& p, const Plan& pl, int BH, cudaStream_t stream) {
  const auto kernel = split_decode_kernel<T, E, kQ8, kVec>;
  // All of the SM's shared memory for blocks, so that kBlocksPerSm reside.
  static const cudaError_t carveout = cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
  if (carveout != cudaSuccess) return (int)carveout;
  if (pl.smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)pl.smem);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)BH * pl.S);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = pl.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = pl.S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Launches the instantiation of the copy width copy_bytes allows.
template <typename T, typename E, bool kQ8>
int launch(Params p, int BH, int min_cols, cudaStream_t stream) {
  if (BH <= 0 || p.D <= 0 || p.D > kMaxD || p.ld <= 0 || p.n_valid <= 0 ||
      p.n_valid > p.ld)
    return (int)cudaErrorInvalidValue;
  const Plan pl = make_plan(BH, p.n_valid, p.D, (int)sizeof(E), kQ8, min_cols);
  if (pl.smem > kMaxSmem || (long long)BH * pl.S > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  p.chunk = pl.chunk;
  p.chunk_pad = pl.chunk_pad;
  p.tc = pl.tc;
  p.groups = pl.groups;
  p.slots = pl.slots;
  switch (copy_bytes(p.k, p.v, (long long)p.ld * sizeof(E))) {
    case 16:
      return launch_kernel<T, E, kQ8, 16>(p, pl, BH, stream);
    case 4:
      return launch_kernel<T, E, kQ8, 4>(p, pl, BH, stream);
    default:
      return launch_kernel<T, E, kQ8, 0>(p, pl, BH, stream);
  }
}

}  // namespace split_decode
}  // namespace tethys
