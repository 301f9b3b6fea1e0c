// One-token cross-attention against int8 caches with per-column scales.
//
// Replaces tethys_tpu/ops/pallas_decode.py::_q8_cross_kernel (launched by
// _pallas_q8_cross, via decode_cross_attention_q8).  For each (batch, head)
// with transposed caches k8, v8 [D, Tk] (int8) and scales sk, sv [Tk] (f32):
//   1. scores[t] = (sum_d q[d] * k8[d, t]) * sk[t], the sum in f32 (k8 cast
//      to the query's dtype is exact, so each product is exact in f32);
//   2. positions t >= kv_len are left out (the TPU kernel's -1e9 mask);
//   3. an f32 softmax, then p[t] * sv[t] rounded to the compute dtype;
//   4. out[d] = sum_t p[t] * v8[d, t] in f32, rounded to the compute dtype.
//
// What bounds it on an H100: device memory.  It reads 2 * D * Tk bytes of
// int8 cache and 8 * Tk bytes of scales per (batch, head) and does about
// one multiply-add per byte.  The design: one block of 256 threads per
// (batch, head).  The score pass gives each thread VEC consecutive
// positions and walks d, so a warp reads 32 * VEC contiguous bytes of a
// cache row per load (VEC = 4, one char4, whenever Tk is a multiple of 4 and
// the pointers are 4-byte aligned, else single bytes).  The scores stay in
// f32 in shared memory (4 * Tk bytes: 6 KB at Tk 1500).  The output pass is
// one warp per row d, lanes striding along t with the same vector loads,
// reduced by shuffles.  Columns at or past kv_len are never read.  One
// block per (batch, head) gives 128 blocks at whisper-base b16, under one
// wave of 132 SMs: splitting Tk across blocks is later work.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <int VEC>
__device__ __forceinline__ void load_i8(const int8_t* p, float* f);

template <>
__device__ __forceinline__ void load_i8<4>(const int8_t* p, float* f) {
  const char4 c = *reinterpret_cast<const char4*>(p);
  f[0] = c.x;
  f[1] = c.y;
  f[2] = c.z;
  f[3] = c.w;
}

template <>
__device__ __forceinline__ void load_i8<1>(const int8_t* p, float* f) {
  f[0] = *p;
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    q8_cross_kernel(const T* __restrict__ q, const int8_t* __restrict__ k8,
                    const float* __restrict__ sk,
                    const int8_t* __restrict__ v8,
                    const float* __restrict__ sv, T* __restrict__ out, int D,
                    int Tk, int kv_len) {
  extern __shared__ float smem[];
  float* s_q = smem;       // [D]
  float* s_p = s_q + D;    // [Tk] scores, then probabilities
  __shared__ float s_red[kWarps];

  const int tid = threadIdx.x;
  const long long bh = blockIdx.x;
  const int8_t* kb = k8 + bh * (long long)D * Tk;
  const int8_t* vb = v8 + bh * (long long)D * Tk;
  const float* skb = sk + bh * Tk;
  const float* svb = sv + bh * Tk;

  for (int d = tid; d < D; d += kThreads) s_q[d] = tethys::to_f32<T>(q[bh * D + d]);
  __syncthreads();

  // Columns [0, t_end) hold every valid one; t_end <= Tk as Tk % VEC == 0.
  const int t_end = (kv_len + VEC - 1) / VEC * VEC;
  float local_max = -INFINITY;
  for (int t0 = tid * VEC; t0 < t_end; t0 += kThreads * VEC) {
    float acc[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[v] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float kv[VEC];
      load_i8<VEC>(kb + (long long)d * Tk + t0, kv);
      const float qd = s_q[d];
#pragma unroll
      for (int v = 0; v < VEC; ++v) acc[v] = fmaf(qd, kv[v], acc[v]);
    }
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      const int t = t0 + v;
      if (t < kv_len) {
        const float s = acc[v] * skb[t];
        s_p[t] = s;
        local_max = fmaxf(local_max, s);
      }
    }
  }
  const float m = tethys::block_reduce<kWarps>(local_max, s_red, true);

  float local_sum = 0.f;
  for (int t = tid; t < kv_len; t += kThreads) {
    const float e = expf(s_p[t] - m);
    s_p[t] = e;
    local_sum += e;
  }
  const float l = tethys::block_reduce<kWarps>(local_sum, s_red, false);

  for (int t = tid; t < t_end; t += kThreads)
    s_p[t] = t < kv_len ? tethys::round_to<T>(s_p[t] / l * svb[t]) : 0.f;
  __syncthreads();

  const int lane = tid & 31, warp = tid >> 5;
  for (int d = warp; d < D; d += kWarps) {
    const int8_t* row = vb + (long long)d * Tk;
    float acc = 0.f;
#pragma unroll 4
    for (int t0 = lane * VEC; t0 < t_end; t0 += 32 * VEC) {
      float vv[VEC];
      load_i8<VEC>(row + t0, vv);
#pragma unroll
      for (int v = 0; v < VEC; ++v) acc = fmaf(s_p[t0 + v], vv[v], acc);
    }
    acc = tethys::warp_sum(acc);
    if (lane == 0) out[bh * D + d] = tethys::from_f32<T>(acc);
  }
}

template <typename T, int VEC>
int launch(const void* q, const void* k8, const void* sk, const void* v8,
           const void* sv, void* out, int BH, int D, int Tk, int kv_len,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)D + Tk);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        q8_cross_kernel<T, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  q8_cross_kernel<T, VEC><<<BH, kThreads, smem, stream>>>(
      (const T*)q, (const int8_t*)k8, (const float*)sk, (const int8_t*)v8,
      (const float*)sv, (T*)out, D, Tk, kv_len);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k8, const void* sk, const void* v8,
             const void* sv, void* out, int BH, int D, int Tk, int kv_len,
             cudaStream_t stream) {
  const bool vec4 = Tk % 4 == 0 && (uintptr_t)k8 % 4 == 0 &&
                    (uintptr_t)v8 % 4 == 0;
  if (vec4)
    return launch<T, 4>(q, k8, sk, v8, sv, out, BH, D, Tk, kv_len, stream);
  return launch<T, 1>(q, k8, sk, v8, sv, out, BH, D, Tk, kv_len, stream);
}

}  // namespace

// q [B, H, 1, D] and out [B, H, 1, D] f32 (is_bf16 = 0) or bf16; k8, v8
// int8 [B, H, D, Tk]; sk, sv f32 [B, H, 1, Tk]; all contiguous, BH = B * H;
// 1 <= kv_len <= Tk.
TETHYS_EXPORT int tethys_q8_cross(const void* q, const void* k8,
                                  const void* sk, const void* v8,
                                  const void* sv, void* out, int BH, int D,
                                  int Tk, int kv_len, int is_bf16,
                                  void* stream) {
  if (BH <= 0 || D <= 0 || Tk <= 0 || kv_len <= 0 || kv_len > Tk)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return dispatch<__nv_bfloat16>(q, k8, sk, v8, sv, out, BH, D, Tk, kv_len,
                                   s);
  return dispatch<float>(q, k8, sk, v8, sv, out, BH, D, Tk, kv_len, s);
}
