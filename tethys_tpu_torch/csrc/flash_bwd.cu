// Flash attention backward: dq, dk, dv of o = dropout(softmax(q k^T)) v on
// [B*H, T, D], with P recomputed from the forward's lse and the dropout
// mask regenerated from its seed.
//
// Replaces tethys_tpu/ops/pallas_attention.py::_bwd_dkv_dq_kernel (body
// _bwd_dkv_kernel with dq_ref; launched by _flash_bwd when the keys fit one
// block, Tk <= 2048, which is every length Whisper meets).  Per (q tile,
// key tile), as the TPU kernel computes it:
//
//   s  = q k^T (keys >= kv_len masked),   p = exp(s - lse)
//   dv += (M.p)^T do            M.p rounded to the input dtype
//   dp = do v^T, masked by M
//   ds = p . (dp - delta * (1 - r)),   delta = rowsum(do . o) (the wrapper's)
//   dk += ds^T q,  dq += ds k    ds rounded to the input dtype
//
// and dk, dv, dq are scaled by 1 / (1 - r) in the epilogue.  M is Philox at
// (bh * Tq + row) * Tk + col (philox.cuh), the forward's mask.
//
// The TPU grid ran the q blocks of one key block in order, carrying dk and
// dv in VMEM scratch.  Here one block of 256 threads owns a 64-key tile of
// one (batch, head) and loops over every 64-row q tile, keeping dk and dv
// in registers; dq rows receive a partial sum from every key tile, added
// with atomicAdd into an f32 buffer the wrapper zeroes and later casts.  So
// there is no Tk limit and no second pass: this one kernel also covers the
// TPU's Tk > 2048 pair (_bwd_dq_kernel, _bwd_dkv_kernel).
//
// What bounds it on an H100: arithmetic, five products of 64 x 64 x D per
// tile pair on the FP32 units (no tensor cores yet), fed from shared memory.
// Each thread keeps a 4 x 4 tile of s and dp and a 4 x D/16 tile of dk, dv
// and dq; operands that run along the contraction are read as float4.
// Tiles are widened to f32 in shared memory, row strides padded by 4 floats
// so float4 rows stay aligned and the two row groups of a warp fall in
// different banks.  Ragged edges: rows >= Tq and keys >= min(kv_len, Tk)
// are zero-filled and get p = 0; key tiles wholly past kv_len write zeros.
#include <math.h>

#include "common.cuh"
#include "philox.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;   // query rows per tile
constexpr int kBK = 64;   // keys per block
constexpr int kRows = 4;  // rows (queries or keys) per thread
constexpr int kCols = 4;  // key columns per thread in s and dp
constexpr int kTS = kBK + 4;  // row stride of the [64][64] p and ds tiles

template <int DMAX>
constexpr int kRowStride = DMAX + 4;  // [64][DMAX] q, do, k, v tiles

template <int DMAX>
constexpr int smem_floats() {
  return 4 * 64 * kRowStride<DMAX>  // k, v, q, do
         + 2 * kBQ * kTS              // p (dropped, rounded), ds (rounded)
         + 2 * kBQ                    // lse, delta
         + kBQ * 2;                   // keep bits, 64 per row
}

template <typename T, int DMAX, bool kDropout>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, float* __restrict__ dq_acc, int Tq,
                     int Tk, int D, int kv_len, uint32_t seed,
                     uint32_t threshold, float keep_prob, float inv) {
  constexpr int kD = kRowStride<DMAX>;
  constexpr int kOut = DMAX / 16;  // d columns per thread
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* sK = smem;
  float* sV = sK + kBK * kD;
  float* sQ = sV + kBK * kD;
  float* sDO = sQ + kBQ * kD;
  float* sP = sDO + kBQ * kD;
  float* sDS = sP + kBQ * kTS;
  float* sLse = sDS + kBQ * kTS;
  float* sDelta = sLse + kBQ;
  uint16_t* sMask = reinterpret_cast<uint16_t*>(sDelta + kBQ);

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const long long bh = blockIdx.y;
  const int k0 = blockIdx.x * kBK;
  const int kv_end = min(kv_len, Tk);

  float acc_dk[kRows][kOut], acc_dv[kRows][kOut];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < kOut; ++j) acc_dk[i][j] = acc_dv[i][j] = 0.f;

  if (k0 < kv_end) {
    const T* kb = k + bh * (long long)Tk * D;
    const T* vb = v + bh * (long long)Tk * D;
    for (int e = tid; e < kBK * DMAX; e += kThreads) {
      const int c = e / DMAX, d = e % DMAX;
      const int key = k0 + c;
      const bool ok = key < kv_end && d < D;
      const long long off = (long long)key * D + d;
      sK[c * kD + d] = ok ? tethys::to_f32<T>(kb[off]) : 0.f;
      sV[c * kD + d] = ok ? tethys::to_f32<T>(vb[off]) : 0.f;
    }
    const T* qb = q + bh * (long long)Tq * D;
    const T* dob = dout + bh * (long long)Tq * D;
    bool key_ok[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j) key_ok[j] = k0 + tx + 16 * j < kv_end;

    for (int q0 = 0; q0 < Tq; q0 += kBQ) {
      __syncthreads();  // the previous tile's readers are done
      for (int e = tid; e < kBQ * DMAX; e += kThreads) {
        const int r = e / DMAX, d = e % DMAX;
        const int row = q0 + r;
        const bool ok = row < Tq && d < D;
        const long long off = (long long)row * D + d;
        sQ[r * kD + d] = ok ? tethys::to_f32<T>(qb[off]) : 0.f;
        sDO[r * kD + d] = ok ? tethys::to_f32<T>(dob[off]) : 0.f;
      }
      if (tid < kBQ) {
        const int row = q0 + tid;
        sLse[tid] = row < Tq ? lse[bh * Tq + row] : 0.f;
        sDelta[tid] = row < Tq ? delta[bh * Tq + row] : 0.f;
      }
      if constexpr (kDropout) {
        const int r = tid >> 2, quarter = tid & 3;
        const uint64_t n0 = ((uint64_t)bh * Tq + (q0 + r)) * (uint64_t)Tk +
                            (uint64_t)(k0 + 16 * quarter);
        sMask[r * 4 + quarter] =
            (uint16_t)tethys::keep_bits16(n0, seed, threshold);
      }
      __syncthreads();

      // s = q k^T and dp = do v^T: rows ty*4 + i, keys tx + 16 j.
      float s[kRows][kCols], dp[kRows][kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
      for (int d = 0; d < DMAX; d += 4) {
        float4 qv[kRows], dov[kRows], kv[kCols], vv[kCols];
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          qv[i] = *reinterpret_cast<const float4*>(&sQ[(ty * kRows + i) * kD + d]);
          dov[i] = *reinterpret_cast<const float4*>(&sDO[(ty * kRows + i) * kD + d]);
        }
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          kv[j] = *reinterpret_cast<const float4*>(&sK[(tx + 16 * j) * kD + d]);
          vv[j] = *reinterpret_cast<const float4*>(&sV[(tx + 16 * j) * kD + d]);
        }
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
          for (int j = 0; j < kCols; ++j) {
            s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
            s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
            s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
            s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
            dp[i][j] = fmaf(dov[i].x, vv[j].x, dp[i][j]);
            dp[i][j] = fmaf(dov[i].y, vv[j].y, dp[i][j]);
            dp[i][j] = fmaf(dov[i].z, vv[j].z, dp[i][j]);
            dp[i][j] = fmaf(dov[i].w, vv[j].w, dp[i][j]);
          }
      }

#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int r = ty * kRows + i;
        const bool row_ok = q0 + r < Tq;
        const float row_lse = sLse[r];
        const float delta_s = sDelta[r] * keep_prob;
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          const float p = (row_ok && key_ok[j]) ? expf(s[i][j] - row_lse) : 0.f;
          bool keep = true;
          if constexpr (kDropout) keep = (sMask[r * 4 + j] >> tx) & 1u;
          const float ds = p * ((keep ? dp[i][j] : 0.f) - delta_s);
          sP[r * kTS + tx + 16 * j] = tethys::round_to<T>(keep ? p : 0.f);
          sDS[r * kTS + tx + 16 * j] = tethys::round_to<T>(ds);
        }
      }
      __syncthreads();

      // dv += p^T do and dk += ds^T q: keys ty*4 + i, dims tx + 16 j.
      const int n_rows = min(kBQ, Tq - q0);
      for (int r = 0; r < n_rows; ++r) {
        const float4 pv = *reinterpret_cast<const float4*>(&sP[r * kTS + ty * kRows]);
        const float4 dsv = *reinterpret_cast<const float4*>(&sDS[r * kTS + ty * kRows]);
        const float pr[kRows] = {pv.x, pv.y, pv.z, pv.w};
        const float dsr[kRows] = {dsv.x, dsv.y, dsv.z, dsv.w};
#pragma unroll
        for (int j = 0; j < kOut; ++j) {
          const float dov = sDO[r * kD + tx + 16 * j];
          const float qv = sQ[r * kD + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < kRows; ++i) {
            acc_dv[i][j] = fmaf(pr[i], dov, acc_dv[i][j]);
            acc_dk[i][j] = fmaf(dsr[i], qv, acc_dk[i][j]);
          }
        }
      }

      // dq rows ty*4 + i, dims tx + 16 j: this key tile's share.
      float dq[kRows][kOut];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kOut; ++j) dq[i][j] = 0.f;
      const int n_keys = min(kBK, kv_end - k0);
      for (int c = 0; c < n_keys; c += 4) {
        float4 dsv[kRows];
#pragma unroll
        for (int i = 0; i < kRows; ++i)
          dsv[i] = *reinterpret_cast<const float4*>(&sDS[(ty * kRows + i) * kTS + c]);
#pragma unroll
        for (int j = 0; j < kOut; ++j) {
          const int d = tx + 16 * j;
          const float k0v = sK[c * kD + d], k1v = sK[(c + 1) * kD + d];
          const float k2v = sK[(c + 2) * kD + d], k3v = sK[(c + 3) * kD + d];
#pragma unroll
          for (int i = 0; i < kRows; ++i) {
            dq[i][j] = fmaf(dsv[i].x, k0v, dq[i][j]);
            dq[i][j] = fmaf(dsv[i].y, k1v, dq[i][j]);
            dq[i][j] = fmaf(dsv[i].z, k2v, dq[i][j]);
            dq[i][j] = fmaf(dsv[i].w, k3v, dq[i][j]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int row = q0 + ty * kRows + i;
        if (row >= Tq) continue;
#pragma unroll
        for (int j = 0; j < kOut; ++j) {
          const int d = tx + 16 * j;
          if (d < D) atomicAdd(&dq_acc[(bh * Tq + row) * D + d], dq[i][j] * inv);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int key = k0 + ty * kRows + i;
    if (key >= Tk) continue;
#pragma unroll
    for (int j = 0; j < kOut; ++j) {
      const int d = tx + 16 * j;
      if (d < D) {
        const long long off = (bh * Tk + key) * D + d;
        dk[off] = tethys::from_f32<T>(acc_dk[i][j] * inv);
        dv[off] = tethys::from_f32<T>(acc_dv[i][j] * inv);
      }
    }
  }
}

template <typename T, int DMAX, bool kDropout>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, void* dk, void* dv,
           void* dq_acc, int BH, int Tq, int Tk, int D, int kv_len,
           uint32_t seed, uint32_t threshold, float keep_prob, float inv,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<DMAX>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_kernel<T, DMAX, kDropout>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Tk + kBK - 1) / kBK, BH);
  flash_bwd_kernel<T, DMAX, kDropout><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
      (const float*)lse, (const float*)delta, (T*)dk, (T*)dv,
      (float*)dq_acc, Tq, Tk, D, kv_len, seed, threshold, keep_prob, inv);
  return (int)cudaGetLastError();
}

template <typename T, bool kDropout>
int dispatch_d(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv,
               void* dq_acc, int BH, int Tq, int Tk, int D, int kv_len,
               uint32_t seed, uint32_t threshold, float keep_prob, float inv,
               cudaStream_t s) {
  if (D <= 64)
    return launch<T, 64, kDropout>(q, k, v, dout, lse, delta, dk, dv, dq_acc,
                                   BH, Tq, Tk, D, kv_len, seed, threshold,
                                   keep_prob, inv, s);
  return launch<T, 128, kDropout>(q, k, v, dout, lse, delta, dk, dv, dq_acc,
                                  BH, Tq, Tk, D, kv_len, seed, threshold,
                                  keep_prob, inv, s);
}

}  // namespace

// q, dout [BH, Tq, D], k, v [BH, Tk, D] in one dtype (f32 when is_bf16 = 0,
// else bf16), lse and delta [BH, Tq] f32, all contiguous -> dk, dv
// [BH, Tk, D] in that dtype, and dq (already scaled by inv) ADDED into the
// f32 buffer dq_acc [BH, Tq, D], which the caller zeroes.  With dropout = 0
// threshold, keep_prob and inv must be 0, 1 and 1.  1 <= D <= 128,
// kv_len >= 1, BH <= 65535.
TETHYS_EXPORT int tethys_flash_bwd(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse, const void* delta,
                                   void* dk, void* dv, void* dq_acc, int BH,
                                   int Tq, int Tk, int D, int kv_len,
                                   int is_bf16, int dropout, uint32_t seed,
                                   uint32_t threshold, float keep_prob,
                                   float inv, void* stream) {
  if (BH <= 0 || BH > 65535 || Tq <= 0 || Tk <= 0 || D <= 0 || D > 128 ||
      kv_len <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) {
    if (dropout)
      return dispatch_d<__nv_bfloat16, true>(q, k, v, dout, lse, delta, dk, dv,
                                             dq_acc, BH, Tq, Tk, D, kv_len,
                                             seed, threshold, keep_prob, inv, s);
    return dispatch_d<__nv_bfloat16, false>(q, k, v, dout, lse, delta, dk, dv,
                                            dq_acc, BH, Tq, Tk, D, kv_len,
                                            seed, threshold, keep_prob, inv, s);
  }
  if (dropout)
    return dispatch_d<float, true>(q, k, v, dout, lse, delta, dk, dv, dq_acc,
                                   BH, Tq, Tk, D, kv_len, seed, threshold,
                                   keep_prob, inv, s);
  return dispatch_d<float, false>(q, k, v, dout, lse, delta, dk, dv, dq_acc,
                                  BH, Tq, Tk, D, kv_len, seed, threshold,
                                  keep_prob, inv, s);
}
