// Flash attention forward: o = softmax(q k^T, keys >= kv_len masked) v and
// the per-row log-sum-exp, on [B*H, T, D] with q pre-scaled.
//
// Replaces tethys_tpu/ops/pallas_attention.py::_fwd_kernel (launched by
// _flash_fwd, via flash_attention) at dropout rate 0.  The TPU kernel took
// the whole key range of whisper's 1500 frames as one [512, 2048] VMEM
// block; here one block of 256 threads owns BQ = 64 query rows of one
// (batch, head) and streams the keys through shared memory BK = 64 at a
// time with the online softmax (running max m and sum l per row), so
// nothing the size of the [Tq, Tk] score matrix reaches device memory.
//
// What bounds it on an H100: arithmetic.  At Tq = Tk = 1500, D = 64 it does
// 2 * 1500 * 1500 * 64 multiply-adds per (batch, head) against under 1 MB of
// q, k, v and o.  This first version runs them on the FP32 units (FFMA, no
// tensor cores): each thread keeps a 4 x 4 tile of scores and a 4 x D/16
// tile of the output in registers, so every shared-memory load feeds 2-4
// FMAs.  bf16 inputs are widened to f32 in shared memory; the scores, the
// softmax and the sums are f32, and the probabilities are rounded to the
// input dtype before the P @ V product, as the TPU kernel rounds them.
// wgmma and TMA are the next step (ROADMAP.md, queue 2).
//
// Masking: keys at or past min(kv_len, Tk) get probability 0 and key tiles
// wholly past it are never loaded, so every tile the loop sees holds at
// least one valid key.  Query rows at or past Tq are zero-filled and not
// written.  Neither T needs padding by the caller.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;  // query rows per block
constexpr int kBK = 64;  // keys per shared-memory tile
constexpr int kPad = 4;  // keeps float4 alignment, spreads banks
constexpr int kRows = 4; // query rows per thread
constexpr int kCols = 4; // key columns per thread

template <int DMAX>
constexpr int smem_floats() {
  return DMAX * (kBQ + kPad)    // q, transposed [d][row]
         + DMAX * (kBK + kPad)  // k, transposed [d][key]
         + kBK * DMAX           // v [key][d]
         + kBK * (kBQ + kPad);  // p, transposed [key][row]
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int Tq, int Tk, int D,
                     int kv_len) {
  constexpr int kOutCols = DMAX / 16;  // output columns per thread
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* sQ = smem;
  float* sK = sQ + DMAX * (kBQ + kPad);
  float* sV = sK + DMAX * (kBK + kPad);
  float* sP = sV + kBK * DMAX;

  const int tid = threadIdx.x;
  const int tx = tid & 15;  // 16 threads share a row group
  const int ty = tid >> 4;  // row group: rows ty*4 .. ty*4+3
  const long long bh = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const int kv_end = min(kv_len, Tk);

  const T* qb = q + bh * (long long)Tq * D;
  const T* kb = k + bh * (long long)Tk * D;
  const T* vb = v + bh * (long long)Tk * D;

  for (int e = tid; e < kBQ * DMAX; e += kThreads) {
    const int r = e / DMAX, d = e % DMAX;
    const int row = q0 + r;
    sQ[d * (kBQ + kPad) + r] =
        (row < Tq && d < D) ? tethys::to_f32<T>(qb[(long long)row * D + d]) : 0.f;
  }

  float m[kRows], l[kRows], acc[kRows][kOutCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kOutCols; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < kv_end; k0 += kBK) {
    __syncthreads();  // the previous tile's sV and sP are consumed
    for (int e = tid; e < kBK * DMAX; e += kThreads) {
      const int c = e / DMAX, d = e % DMAX;
      const int key = k0 + c;
      const bool ok = key < kv_end && d < D;
      const long long off = (long long)key * D + d;
      sK[d * (kBK + kPad) + c] = ok ? tethys::to_f32<T>(kb[off]) : 0.f;
      sV[c * DMAX + d] = ok ? tethys::to_f32<T>(vb[off]) : 0.f;
    }
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DMAX; ++d) {
      const float4 qv =
          *reinterpret_cast<const float4*>(&sQ[d * (kBQ + kPad) + ty * kRows]);
      const float qr[kRows] = {qv.x, qv.y, qv.z, qv.w};
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float kv = sK[d * (kBK + kPad) + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < kRows; ++i) s[i][j] = fmaf(qr[i], kv, s[i][j]);
      }
    }

    // Online softmax; the 16 threads of a row group hold its 64 columns.
    bool valid[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j) valid[j] = k0 + tx + 16 * j < kv_end;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        if (valid[j]) mx = fmaxf(mx, s[i][j]);
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);  // 0 on the first tile
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = valid[j] ? expf(s[i][j] - m_new) : 0.f;
        sum += p;
        s[i][j] = tethys::round_to<T>(p);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = alpha * l[i] + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kOutCols; ++j) acc[i][j] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      *reinterpret_cast<float4*>(
          &sP[(tx + 16 * j) * (kBQ + kPad) + ty * kRows]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    }
    __syncthreads();

    const int n_keys = min(kBK, kv_end - k0);
    for (int c = 0; c < n_keys; ++c) {
      const float4 pv =
          *reinterpret_cast<const float4*>(&sP[c * (kBQ + kPad) + ty * kRows]);
      const float pr[kRows] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
      for (int j = 0; j < kOutCols; ++j) {
        const float vv = sV[c * DMAX + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < kRows; ++i) acc[i][j] = fmaf(pr[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + ty * kRows + i;
    if (row >= Tq) continue;
    const float inv = 1.f / l[i];
#pragma unroll
    for (int j = 0; j < kOutCols; ++j) {
      const int d = tx + 16 * j;
      if (d < D)
        o[(bh * Tq + row) * D + d] = tethys::from_f32<T>(acc[i][j] * inv);
    }
    if (tx == 0) lse[bh * Tq + row] = m[i] + logf(l[i]);
  }
}

template <typename T, int DMAX>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int BH, int Tq, int Tk, int D, int kv_len, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<DMAX>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Tq + kBQ - 1) / kBQ, BH);
  flash_fwd_kernel<T, DMAX><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, (float*)lse, Tq, Tk, D,
      kv_len);
  return (int)cudaGetLastError();
}

}  // namespace

// q [BH, Tq, D], k and v [BH, Tk, D], all f32 (is_bf16 = 0) or bf16, all
// contiguous -> o [BH, Tq, D] in the same dtype, lse [BH, Tq] f32.
// 1 <= D <= 128, kv_len >= 1; BH <= 65535.
TETHYS_EXPORT int tethys_flash_fwd(const void* q, const void* k,
                                   const void* v, void* o, void* lse, int BH,
                                   int Tq, int Tk, int D, int kv_len,
                                   int is_bf16, void* stream) {
  if (BH <= 0 || BH > 65535 || Tq <= 0 || Tk <= 0 || D <= 0 || D > 128 ||
      kv_len <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) {
    if (D <= 64)
      return launch<__nv_bfloat16, 64>(q, k, v, o, lse, BH, Tq, Tk, D, kv_len, s);
    return launch<__nv_bfloat16, 128>(q, k, v, o, lse, BH, Tq, Tk, D, kv_len, s);
  }
  if (D <= 64) return launch<float, 64>(q, k, v, o, lse, BH, Tq, Tk, D, kv_len, s);
  return launch<float, 128>(q, k, v, o, lse, BH, Tq, Tk, D, kv_len, s);
}
