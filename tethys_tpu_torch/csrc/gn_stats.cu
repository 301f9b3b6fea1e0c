// GroupNorm statistics: the exact per-(batch, group) mean and biased
// variance over (T, C / G) of x [B, T, C], reading x once, in its own dtype
// (f32 or bf16), with f32 accumulation.
//
// Replaces tethys_tpu/ops/pallas_gn.py::_stats_kernel (launched by
// chunk_stats, via group_moments) together with the Chan combine the JAX
// side runs after it (pallas_gn.py:84-106).  The TPU kernel needed T to be
// a multiple of a chunk that is itself a multiple of 8; here any T is taken
// and the last chunk may be ragged.
//
// What bounds it on an H100: device memory.  It reads each element once and
// writes a few floats per (batch, chunk, channel), so its floor is the bytes
// of x over 3.35 TB/s (63 us for wav2vec2-base's first GroupNorm input,
// [32, 6400, 512] bf16); the arithmetic, a few flops per element, is far
// below the FP32 rate.  The design:
// - pass 1 (gn_partials_kernel): a block of 128 threads runs along C, one
//   channel a thread, so a warp's loads of one row are contiguous; blockIdx
//   picks (channel tile, chunk of rows, batch).  A thread loads 16 rows at a
//   time into registers (16 loads in flight), takes their mean and centred
//   M2 there (two passes in registers, never E[x^2] - mu^2, which loses
//   digits when conv activations sit far from zero), and merges them into
//   its running (count, mean, M2) with Chan's formula.  It writes the
//   chunk's per-channel (mean, M2) to [B, n_chunks, C] partials.
// - pass 2 (gn_combine_kernel): one block per (group, batch) merges, per
//   channel, the chunks with their counts (the last chunk may be shorter),
//   then the group's channels, each of count T, by Chan in registers and a
//   tree in shared memory, and writes mean and M2 / (T * C/G).
// The wrapper (ops/group_norm.py) picks the chunk so that B * n_chunks *
// ceil(C / 128) blocks fill the 132 SMs even at T = 100.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 16;  // rows a thread holds in registers at once

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
    gn_partials_kernel(const T* __restrict__ x, float* __restrict__ part_mean,
                       float* __restrict__ part_m2, int t_len, int c,
                       int chunk, int n_chunks) {
  const int ch = blockIdx.x * kThreads + threadIdx.x;
  const int k = blockIdx.y;
  const int b = blockIdx.z;
  if (ch >= c) return;
  const int t0 = k * chunk;
  const int t1 = min(t0 + chunk, t_len);
  const T* p = x + ((long long)b * t_len + t0) * c + ch;
  Moments acc = {0.f, 0.f, 0.f};
  for (int t = t0; t < t1; t += kRows) {
    const int rows = min(kRows, t1 - t);
    float v[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      v[r] = r < rows ? tethys::to_f32<T>(p[(long long)(t - t0 + r) * c])
                      : 0.f;
    float s = 0.f;
#pragma unroll
    for (int r = 0; r < kRows; ++r) s += v[r];
    const float mean = s / (float)rows;
    float m2 = 0.f;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float d = r < rows ? v[r] - mean : 0.f;
      m2 += d * d;
    }
    acc = chan(acc, Moments{(float)rows, mean, m2});
  }
  const long long o = ((long long)b * n_chunks + k) * c + ch;
  part_mean[o] = acc.mean;
  part_m2[o] = acc.m2;
}

__global__ void __launch_bounds__(kThreads)
    gn_combine_kernel(const float* __restrict__ part_mean,
                      const float* __restrict__ part_m2,
                      float* __restrict__ mean_g, float* __restrict__ var_g,
                      int t_len, int c, int groups, int chunk, int n_chunks) {
  const int g = blockIdx.x;
  const int b = blockIdx.y;
  const int pg = c / groups;
  Moments acc = {0.f, 0.f, 0.f};
  for (int j = threadIdx.x; j < pg; j += kThreads) {
    const int ch = g * pg + j;
    Moments per_channel = {0.f, 0.f, 0.f};
    for (int k = 0; k < n_chunks; ++k) {
      const long long o = ((long long)b * n_chunks + k) * c + ch;
      const float count = (float)min(chunk, t_len - k * chunk);
      per_channel = chan(per_channel, Moments{count, part_mean[o], part_m2[o]});
    }
    acc = chan(acc, per_channel);
  }
  __shared__ Moments tree[kThreads];
  tree[threadIdx.x] = acc;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s)
      tree[threadIdx.x] = chan(tree[threadIdx.x], tree[threadIdx.x + s]);
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    const Moments m = tree[0];
    mean_g[b * groups + g] = m.mean;
    var_g[b * groups + g] = m.m2 / m.n;
  }
}

template <typename T>
int launch(const void* x, float* part_mean, float* part_m2, float* mean_g,
           float* var_g, int b, int t_len, int c, int groups, int chunk,
           cudaStream_t stream) {
  const int n_chunks = (t_len + chunk - 1) / chunk;
  const dim3 grid1((c + kThreads - 1) / kThreads, n_chunks, b);
  gn_partials_kernel<T><<<grid1, kThreads, 0, stream>>>(
      (const T*)x, part_mean, part_m2, t_len, c, chunk, n_chunks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gn_combine_kernel<<<dim3(groups, b), kThreads, 0, stream>>>(
      part_mean, part_m2, mean_g, var_g, t_len, c, groups, chunk, n_chunks);
  return (int)cudaGetLastError();
}

}  // namespace

// x: [b, t_len, c] contiguous f32 (is_bf16 = 0) or bf16; part_mean and
// part_m2: f32 scratch of b * ceil(t_len / chunk) * c each; mean_g, var_g:
// f32 [b, groups].  c must be a multiple of groups; chunk >= 1.
TETHYS_EXPORT int tethys_gn_stats(const void* x, float* part_mean,
                                  float* part_m2, float* mean_g, float* var_g,
                                  int b, int t_len, int c, int groups,
                                  int chunk, int is_bf16, void* stream) {
  if (b <= 0 || t_len <= 0 || c <= 0 || groups <= 0 || c % groups != 0 ||
      chunk <= 0 || b > 65535 || (t_len + chunk - 1) / chunk > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return launch<__nv_bfloat16>(x, part_mean, part_m2, mean_g, var_g, b,
                                 t_len, c, groups, chunk, s);
  return launch<float>(x, part_mean, part_m2, mean_g, var_g, b, t_len, c,
                       groups, chunk, s);
}
