// One-token decoder self-attention with the KV-cache append, in one launch.
//
// Replaces tethys_tpu/ops/pallas_decode.py::_kernel (launched by
// _pallas_self, via decode_self_attention).  For each (batch, head) it
//   1. writes k_new and v_new as column idx of the transposed caches
//      [B, H, D, T_max], in place;
//   2. computes the scores q . k[:, t] for t <= idx in f32;
//   3. takes an f32 softmax over them and rounds the probabilities to the
//      compute dtype;
//   4. writes out[d] = sum_t p[t] v[d, t] in the compute dtype.
// Positions past idx are never read, which is what the TPU kernel's mask
// (-1e9 before the softmax) amounts to.
//
// What bounds it on an H100: device memory, and at serving sizes launch
// latency.  It reads 2 * D * (idx + 1) cache values per (batch, head) and
// does one multiply-add per value read.  The design: one block of 128
// threads per (batch, head).  Scores are computed one position per thread,
// reading the [D, T] slab along T so that a warp reads contiguous memory;
// the output is one warp per d, lanes striding along T, reduced by
// shuffles.  The new column is taken from shared memory rather than read
// back from the cache it was just written to.  idx arrives as a kernel
// argument, so a host loop over decode steps never waits on the device.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

__device__ float block_reduce(float v, float* s_red, bool is_max) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = is_max ? tethys::warp_max(v) : tethys::warp_sum(v);
  if (lane == 0) s_red[warp] = v;
  __syncthreads();
  float r = s_red[0];
  for (int w = 1; w < kWarps; ++w)
    r = is_max ? fmaxf(r, s_red[w]) : r + s_red[w];
  __syncthreads();  // s_red may be reused by the next reduction
  return r;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    decode_self_kernel(const T* __restrict__ q, const T* __restrict__ k_new,
                       const T* __restrict__ v_new, T* k_buf, T* v_buf,
                       T* __restrict__ out, int D, int Tmax, int idx) {
  extern __shared__ float smem[];
  float* s_q = smem;           // [D]
  float* s_k = s_q + D;        // [D] the new key column
  float* s_v = s_k + D;        // [D] the new value column
  float* s_p = s_v + D;        // [idx + 1] scores, then probabilities
  __shared__ float s_red[kWarps];

  const int tid = threadIdx.x;
  const long long bh = blockIdx.x;
  T* kb = k_buf + bh * (long long)D * Tmax;
  T* vb = v_buf + bh * (long long)D * Tmax;

  for (int d = tid; d < D; d += kThreads) {
    const T kv = k_new[bh * D + d];
    const T vv = v_new[bh * D + d];
    kb[(long long)d * Tmax + idx] = kv;
    vb[(long long)d * Tmax + idx] = vv;
    s_q[d] = tethys::to_f32<T>(q[bh * D + d]);
    s_k[d] = tethys::to_f32<T>(kv);
    s_v[d] = tethys::to_f32<T>(vv);
  }
  __syncthreads();

  float local_max = -INFINITY;
  for (int t = tid; t <= idx; t += kThreads) {
    float acc = 0.f;
    if (t == idx) {
      for (int d = 0; d < D; ++d) acc = fmaf(s_q[d], s_k[d], acc);
    } else {
      for (int d = 0; d < D; ++d)
        acc = fmaf(s_q[d], tethys::to_f32<T>(kb[(long long)d * Tmax + t]), acc);
    }
    s_p[t] = acc;
    local_max = fmaxf(local_max, acc);
  }
  const float m = block_reduce(local_max, s_red, true);

  float local_sum = 0.f;
  for (int t = tid; t <= idx; t += kThreads) {
    const float p = expf(s_p[t] - m);
    s_p[t] = p;
    local_sum += p;
  }
  const float l = block_reduce(local_sum, s_red, false);

  for (int t = tid; t <= idx; t += kThreads)
    s_p[t] = tethys::round_to<T>(s_p[t] / l);
  __syncthreads();

  const int lane = tid & 31, warp = tid >> 5;
  for (int d = warp; d < D; d += kWarps) {
    float acc = 0.f;
    for (int t = lane; t <= idx; t += 32) {
      const float vv = (t == idx)
                           ? s_v[d]
                           : tethys::to_f32<T>(vb[(long long)d * Tmax + t]);
      acc = fmaf(s_p[t], vv, acc);
    }
    acc = tethys::warp_sum(acc);
    if (lane == 0) out[bh * D + d] = tethys::from_f32<T>(acc);
  }
}

template <typename T>
int launch(const void* q, const void* k_new, const void* v_new, void* k_buf,
           void* v_buf, void* out, int BH, int D, int Tmax, int idx,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * (3 * D + idx + 1);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        decode_self_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  decode_self_kernel<T><<<BH, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k_new, (const T*)v_new, (T*)k_buf, (T*)v_buf,
      (T*)out, D, Tmax, idx);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k_new, v_new [B, H, 1, D]; k_buf, v_buf [B, H, D, T_max] (updated in
// place); out [B, H, 1, D].  All f32 (is_bf16 = 0) or all bf16, contiguous.
// 0 <= idx < T_max.
TETHYS_EXPORT int tethys_decode_self(const void* q, const void* k_new,
                                     const void* v_new, void* k_buf,
                                     void* v_buf, void* out, int B, int H,
                                     int D, int Tmax, int idx, int is_bf16,
                                     void* stream) {
  if (B <= 0 || H <= 0 || D <= 0 || Tmax <= 0 || idx < 0 || idx >= Tmax)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return launch<__nv_bfloat16>(q, k_new, v_new, k_buf, v_buf, out, B * H, D,
                                 Tmax, idx, s);
  return launch<float>(q, k_new, v_new, k_buf, v_buf, out, B * H, D, Tmax,
                       idx, s);
}
