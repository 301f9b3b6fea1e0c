// GroupNorm reductions over x [B, T, C] (f32 or bf16, f32 sums), one
// launch a call, two modes of one engine:
// - forward (tethys_gn_stats): the per-(batch, group) mean, biased variance
//   and rstd = 1 / sqrt(var + eps) over (T, C / G), each f32 [B, G];
// - backward (tethys_gn_grad_sums): with the forward's mean and rstd, per
//   (batch, channel) A = sum_t dy * xhat and B = sum_t dy, xhat = (x - mean)
//   * rstd, each f32 [B, C] (dgamma and dbeta are their sums over the
//   batch), and per (batch, group) s1 = sum_c gamma B / n and s2 =
//   sum_c gamma A / n, n = T * C / G: the group means of dy * gamma and
//   dy * gamma * xhat that the apply backward takes (csrc/gn_apply.cu).
//
// Replaces tethys_tpu/ops/pallas_gn.py:50 _stats_kernel together with the
// Chan combine the JAX side runs after it (pallas_gn.py:84-106); the
// backward mode replaces the joint stats pass of the closed-form VJP,
// tethys_tpu/ops/norms.py:108-115 (_gn_core's bwd_rule; XLA there, not
// Pallas).  The TPU kernel needed T to be a multiple of a chunk that is
// itself a multiple of 8; here any T is taken.
//
// What bounds it on an H100: device memory.  It reads x (and dy) once and
// writes a few floats per (batch, group or channel): the floor is those
// bytes over 3.35 TB/s (63 us for wav2vec2-base's first GroupNorm input,
// [32, 6400, 512] bf16); the arithmetic, a few flops an element, is far
// below the FP32 rate.  The design, for that floor:
// - 16 bytes a thread a row: a thread owns kVec = 8 bf16 or 4 f32
//   channels, so the 16 threads of a 128-channel tile read 256 contiguous
//   bytes of a row (a scalar form, kVec = 1, takes misaligned views);
// - four rows a step (two of x and two of dy in the backward),
//   double-buffered in registers: a thread issues the next step's loads
//   before it reduces the current ones, so a block keeps 32 KB in flight
//   while it computes, and one or two blocks an SM hold the card's
//   bandwidth (Little's law at about a microsecond of latency);
// - the grid is the occupancy the kernel really gets: the host (ops/
//   group_norm.py stats_plan) asks cudaOccupancyMaxActiveBlocksPerMultiprocessor
//   for blocks an SM and launches at most that many blocks on the SMs,
//   clusters of S blocks that loop over the work items (batch, channel
//   tile), so every block is resident in the one wave;
// - T is split over the cluster: rank r reduces rows [r T / S, (r + 1) T /
//   S) of an item; the block's row slots meet in shared memory by a
//   pairwise tree, then rank 0 reads every rank's per-channel summary through DSMEM
//   in rank order and folds channels into groups (a warp a group, an xor
//   butterfly over its lanes), so no partials go to
//   device memory, there is no second launch, and two launches give the
//   same bits.
// Forward numerics: (count, mean, M2) a channel by Chan's combine of
// four-row batches, never E[x^2] - mu^2, which loses digits when conv
// activations sit far from zero.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;
using namespace tethys;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxCluster = 8;  // the portable cluster size

struct Moments {
  float n, mean, m2;
};

// Chan's parallel combine of two (count, mean, M2) summaries.
__device__ __forceinline__ Moments chan(Moments a, Moments b) {
  const float n = a.n + b.n;
  if (n == 0.f) return a;
  const float delta = b.mean - a.mean;
  const float wb = b.n / n;
  return {n, a.mean + delta * wb, a.m2 + b.m2 + delta * delta * a.n * wb};
}

struct Params {
  const void* x;         // [b, t, c]
  const void* dy;        // [b, t, c], backward only
  const float* mean;     // [b, groups], backward only
  const float* rstd;     // [b, groups], backward only
  const float* gamma;    // [c], backward only
  float* out;            // forward: [3, b, groups]; backward: [2, b, c]
  float* s;              // backward: [2, b, groups]
  int b, t, c, groups, n_ctile, n_items;
  float eps;
};

// Rows [first, last) of the T rows that cluster rank r of S reduces.
__device__ __forceinline__ int rank_row(int t, int r, int S) {
  return (int)((long long)t * r / S);
}

template <typename T, int kVec, bool kBwd>
__device__ __forceinline__ void gn_reduce(const Params& p) {
  // Per row slot and tile channel: the forward's (mean, M2) or the
  // backward's (A, B); after the slot combine, slot 0's row holds the
  // block's per-channel summary, which rank 0 reads through DSMEM.
  __shared__ float s0[kThreads * kVec], s1[kThreads * kVec];
  const cg::cluster_group cluster = cg::this_cluster();
  const int S = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int ctile = p.c / p.n_ctile, tpr = ctile / kVec, slots = kThreads / tpr;
  const int j = threadIdx.x % tpr, slot = threadIdx.x / tpr;
  const int pg = p.c / p.groups;
  const T* x = (const T*)p.x;
  const T* dy = (const T*)p.dy;
  // Rows a thread loads a step (of x, and of dy in the backward): with the
  // next step's in flight, 128 bytes a thread.
  constexpr int kRows = kBwd ? 2 : 4;

  for (int item = blockIdx.x / S; item < p.n_items;
       item += (int)gridDim.x / S) {
    const int b = item / p.n_ctile, c0 = (item % p.n_ctile) * ctile;
    const int t1 = rank_row(p.t, rank + 1, S);
    if (slot < slots) {
      const int ch = c0 + j * kVec;
      float acc0[kVec], acc1[kVec], mu[kVec], rs[kVec];
#pragma unroll
      for (int v = 0; v < kVec; ++v) {
        acc0[v] = acc1[v] = 0.f;
        if constexpr (kBwd) {
          const int g = b * p.groups + (ch + v) / pg;
          mu[v] = p.mean[g];
          rs[v] = p.rstd[g];
        }
      }
      float n = 0.f;
      const long long base = (long long)b * p.t * p.c + ch;
      int row = rank_row(p.t, rank, S) + slot;
      Pack<T, kVec> cx[kRows] = {}, cd[kRows] = {}, nx[kRows] = {},
                    nd[kRows] = {};
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        const int r = row + u * slots;
        if (r < t1) {
          cx[u] = load_pack<T, kVec>(x + base + (long long)r * p.c);
          if constexpr (kBwd)
            cd[u] = load_pack<T, kVec>(dy + base + (long long)r * p.c);
        }
      }
      while (row < t1) {
        const int next = row + kRows * slots;
#pragma unroll
        for (int u = 0; u < kRows; ++u) {
          const int r = next + u * slots;
          if (r < t1) {
            nx[u] = load_pack<T, kVec>(x + base + (long long)r * p.c);
            if constexpr (kBwd)
              nd[u] = load_pack<T, kVec>(dy + base + (long long)r * p.c);
          }
        }
        const int nb = min(kRows, (t1 - row + slots - 1) / slots);
        if constexpr (kBwd) {
#pragma unroll
          for (int u = 0; u < kRows; ++u) {
            if (u >= nb) break;
            float f[kVec], d[kVec];
            unpack<T, kVec>(cx[u], f);
            unpack<T, kVec>(cd[u], d);
#pragma unroll
            for (int v = 0; v < kVec; ++v) {
              const float xh = (f[v] - mu[v]) * rs[v];
              acc0[v] += d[v] * xh;
              acc1[v] += d[v];
            }
          }
        } else {
          float f[kRows][kVec];
#pragma unroll
          for (int u = 0; u < kRows; ++u) unpack<T, kVec>(cx[u], f[u]);
          const float nbf = (float)nb, n_new = n + nbf;
          const float wb = nbf / n_new, inv_nb = 1.f / nbf;
#pragma unroll
          for (int v = 0; v < kVec; ++v) {
            float sum = f[0][v];
#pragma unroll
            for (int u = 1; u < kRows; ++u)
              if (u < nb) sum += f[u][v];
            const float bm = sum * inv_nb;
            float m2 = 0.f;
#pragma unroll
            for (int u = 0; u < kRows; ++u)
              if (u < nb) m2 += (f[u][v] - bm) * (f[u][v] - bm);
            const float delta = bm - acc0[v];
            acc0[v] += delta * wb;
            acc1[v] += m2 + delta * delta * n * wb;
          }
          n = n_new;
        }
#pragma unroll
        for (int u = 0; u < kRows; ++u) {
          cx[u] = nx[u];
          if constexpr (kBwd) cd[u] = nd[u];
        }
        row = next;
      }
#pragma unroll
      for (int v = 0; v < kVec; ++v) {
        s0[slot * ctile + j * kVec + v] = acc0[v];
        s1[slot * ctile + j * kVec + v] = acc1[v];
      }
    }
    __syncthreads();
    // The block's summary a channel, into slot 0: the slots by a pairwise
    // tree (slot q takes q + h, h = 1, 2, 4, ...), all channels at once.
    // Slot q holds the rows congruent to q modulo slots; a subtree of w
    // slots from q, the rows count(q, w).
    const int rows = t1 - rank_row(p.t, rank, S);
    const auto count = [&](int q, int w) {
      w = min(w, slots - q);
      return (float)(rows / slots * w + min(max(rows % slots - q, 0), w));
    };
    for (int h = 1; h < slots; h *= 2) {
      const int pairs = (slots - 1) / (2 * h) + 1;
      for (int i = threadIdx.x; i < pairs * ctile; i += kThreads) {
        const int q = i / ctile * 2 * h, e = i % ctile;
        if (q + h >= slots) continue;
        const int lo = q * ctile + e, hi = (q + h) * ctile + e;
        if constexpr (kBwd) {
          s0[lo] += s0[hi];
          s1[lo] += s1[hi];
        } else {
          const Moments m = chan(Moments{count(q, h), s0[lo], s1[lo]},
                                 Moments{count(q + h, h), s0[hi], s1[hi]});
          s0[lo] = m.mean;
          s1[lo] = m.m2;
        }
      }
      __syncthreads();
    }
    // Every rank's summary is in its shared memory (a cluster of one needs
    // no cluster barrier, whose release is a fence).
    if (S > 1) cluster.sync();
    if (rank == 0) {
      // The item's per-channel result: the ranks in rank order.
      for (int e = threadIdx.x; e < ctile; e += kThreads) {
        if constexpr (kBwd) {
          float a = s0[e], bs = s1[e];
          for (int r = 1; r < S; ++r) {
            a += cluster.map_shared_rank(s0, r)[e];
            bs += cluster.map_shared_rank(s1, r)[e];
          }
          s0[e] = a;
          s1[e] = bs;
          const long long o = (long long)b * p.c + c0 + e;
          p.out[o] = a;
          p.out[(long long)p.b * p.c + o] = bs;
        } else {
          Moments m = {(float)rank_row(p.t, 1, S), s0[e], s1[e]};
          for (int r = 1; r < S; ++r)
            m = chan(m, Moments{(float)(rank_row(p.t, r + 1, S) -
                                        rank_row(p.t, r, S)),
                                cluster.map_shared_rank(s0, r)[e],
                                cluster.map_shared_rank(s1, r)[e]});
          s0[e] = m.mean;
          s1[e] = m.m2;
        }
      }
      __syncthreads();
      // Channels into groups: a warp a group, lane k folding channels k,
      // k + 32, ... of it in order, then the lanes by an xor butterfly.
      const int lane = threadIdx.x & 31, bg = p.b * p.groups;
      for (int gl = threadIdx.x >> 5; gl < ctile / pg; gl += kThreads / 32) {
        const int e0 = gl * pg, g = b * p.groups + (c0 + e0) / pg;
        if constexpr (kBwd) {
          float u = 0.f, w = 0.f;
          for (int k = lane; k < pg; k += 32) {
            const float gam = p.gamma[c0 + e0 + k];
            u += s1[e0 + k] * gam;
            w += s0[e0 + k] * gam;
          }
          u = warp_sum(u);
          w = warp_sum(w);
          if (lane == 0) {
            const float n = (float)p.t * (float)pg;
            p.s[g] = u / n;
            p.s[bg + g] = w / n;
          }
        } else {
          const float tf = (float)p.t;
          Moments m = {0.f, 0.f, 0.f};
          for (int k = lane; k < pg; k += 32)
            m = chan(m, Moments{tf, s0[e0 + k], s1[e0 + k]});
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            m = chan(m, Moments{__shfl_xor_sync(0xffffffffu, m.n, off),
                                __shfl_xor_sync(0xffffffffu, m.mean, off),
                                __shfl_xor_sync(0xffffffffu, m.m2, off)});
          if (lane == 0) {
            const float var = m.m2 / m.n;
            p.out[g] = m.mean;
            p.out[bg + g] = var;
            p.out[2 * bg + g] = 1.f / sqrtf(var + p.eps);
          }
        }
      }
    }
    // The other ranks' shared memory stays until rank 0 has read it, and
    // rank 0's until its fold is done.
    if (S > 1) cluster.sync(); else __syncthreads();
  }
}

// Two kernels, so that a profile names the modes apart.
template <typename T, int kVec>
__global__ void __launch_bounds__(kThreads, 2)
    gn_moments_kernel(const Params p) {
  gn_reduce<T, kVec, false>(p);
}

template <typename T, int kVec>
__global__ void __launch_bounds__(kThreads, 2)
    gn_grad_sums_kernel(const Params p) {
  gn_reduce<T, kVec, true>(p);
}

template <typename T, int kVec, bool kBwd>
auto kernel_of() {
  if constexpr (kBwd)
    return gn_grad_sums_kernel<T, kVec>;
  else
    return gn_moments_kernel<T, kVec>;
}

template <typename T, int kVec, bool kBwd>
int launch_kernel(const Params& p, int cluster, int n_clusters,
                  cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(cluster * n_clusters));
  cfg.blockDim = dim3(kThreads);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;  // a cluster of one: a plain launch
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, kernel_of<T, kVec, kBwd>(), p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <bool kBwd>
int launch(Params p, int cluster, int n_clusters, int is_bf16, int vec,
           cudaStream_t stream) {
  if (p.b <= 0 || p.t <= 0 || p.c <= 0 || p.groups <= 0 ||
      p.c % p.groups != 0 || p.n_ctile <= 0 || p.groups % p.n_ctile != 0 ||
      cluster < 1 || cluster > kMaxCluster || n_clusters < 1 ||
      (long long)cluster * n_clusters > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int k = vec ? (is_bf16 ? 8 : 4) : 1, ctile = p.c / p.n_ctile;
  if (ctile % k != 0 || ctile / k > kThreads)
    return (int)cudaErrorInvalidValue;
  p.n_items = p.b * p.n_ctile;
  if (is_bf16)
    return vec ? launch_kernel<__nv_bfloat16, 8, kBwd>(p, cluster, n_clusters,
                                                       stream)
               : launch_kernel<__nv_bfloat16, 1, kBwd>(p, cluster, n_clusters,
                                                       stream);
  return vec ? launch_kernel<float, 4, kBwd>(p, cluster, n_clusters, stream)
             : launch_kernel<float, 1, kBwd>(p, cluster, n_clusters, stream);
}

template <typename T, int kVec, bool kBwd>
int occupancy(int cluster, int* out) {
  const auto kernel = kernel_of<T, kVec, kBwd>();
  cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], kernel, kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  out[1] = sm_count();
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)cluster);
  cfg.blockDim = dim3(kThreads);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaOccupancyMaxActiveClusters(&out[2], kernel, &cfg);
}

template <bool kBwd>
int occupancy_of(int is_bf16, int vec, int cluster, int* out) {
  if (is_bf16)
    return vec ? occupancy<__nv_bfloat16, 8, kBwd>(cluster, out)
               : occupancy<__nv_bfloat16, 1, kBwd>(cluster, out);
  return vec ? occupancy<float, 4, kBwd>(cluster, out)
             : occupancy<float, 1, kBwd>(cluster, out);
}

}  // namespace

// Forward mode.  x: [b, t, c] contiguous f32 (is_bf16 = 0) or bf16, 16-byte
// aligned with c a multiple of 16 bytes where vec = 1; out: f32 [3, b,
// groups] (mean, var, rstd).  The plan (ops/group_norm.py stats_plan):
// n_ctile channel tiles of whole groups, clusters of `cluster` blocks,
// n_clusters of them.
TETHYS_EXPORT int tethys_gn_stats(const void* x, float* out, int b, int t,
                                  int c, int groups, int n_ctile, int cluster,
                                  int n_clusters, float eps, int is_bf16,
                                  int vec, void* stream) {
  Params p = {x, nullptr, nullptr, nullptr, nullptr, out, nullptr,
              b, t, c, groups, n_ctile, 0, eps};
  return launch<false>(p, cluster, n_clusters, is_bf16, vec,
                       (cudaStream_t)stream);
}

// Backward mode.  x, dy: [b, t, c], one dtype; mean, rstd: f32 [b, groups]
// from the forward; gamma: f32 [c]; sums: f32 [2, b, c] (A, B); s: f32 [2,
// b, groups] (s1, s2).
TETHYS_EXPORT int tethys_gn_grad_sums(const void* x, const void* dy,
                                      const float* mean, const float* rstd,
                                      const float* gamma, float* sums,
                                      float* s, int b, int t, int c,
                                      int groups, int n_ctile, int cluster,
                                      int n_clusters, int is_bf16, int vec,
                                      void* stream) {
  Params p = {x, dy, mean, rstd, gamma, sums, s,
              b, t, c, groups, n_ctile, 0, 0.f};
  return launch<true>(p, cluster, n_clusters, is_bf16, vec,
                      (cudaStream_t)stream);
}

// What a plan needs to know: out[0] blocks an SM (the kernel's occupancy),
// out[1] the SMs, out[2] the clusters of `cluster` blocks that fit at once.
TETHYS_EXPORT int tethys_gn_stats_occupancy(int bwd, int is_bf16, int vec,
                                            int cluster, int* out) {
  if (cluster < 1 || cluster > kMaxCluster) return (int)cudaErrorInvalidValue;
  return bwd ? occupancy_of<true>(is_bf16, vec, cluster, out)
             : occupancy_of<false>(is_bf16, vec, cluster, out);
}
