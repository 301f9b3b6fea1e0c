// Flash attention forward: o = dropout(softmax(q k^T, keys >= kv_len
// masked)) v and the per-row log-sum-exp, on [B*H, T, D] with q pre-scaled.
//
// Replaces tethys_tpu/ops/pallas_attention.py::_fwd_kernel (launched by
// _flash_fwd, via flash_attention).  Two entry points: tethys_flash_fwd
// (rate 0, serving) and tethys_flash_fwd_dropout (training), each kernel a
// template with the dropout code compiled in or out.  The TPU kernel took
// the whole key range of whisper's 1500 frames as one [512, 2048] VMEM
// block; here one block owns 64 query rows of one (batch, head) and streams
// the keys through shared memory 64 at a time with the online softmax
// (running max m and sum l per row), so nothing the size of the [Tq, Tk]
// score matrix reaches device memory.
//
// What bounds it on an H100: arithmetic.  At Tq = Tk = 1500, D = 64 it does
// 2 * 1500 * 1500 * 64 multiply-adds per (batch, head) against under 1 MB of
// q, k, v and o.  Two kernels:
//
// * bf16 runs on the tensor cores (flash_fwd_mma_kernel): 4 warps, 16 query
//   rows each.  q stays in registers as mma A fragments for the whole loop;
//   k and v tiles come in by 16-byte cp.async in a 2-stage ring (the next
//   tile's copy overlaps this tile's products), kept as bf16 in rows padded
//   by 8 elements so that ldmatrix is free of bank conflicts.  S = q k^T
//   and the online softmax run on the mma accumulator fragments (row max
//   and sum across the 4 lanes of a quad by shuffles); the unnormalised
//   probabilities are rounded to bf16 and repacked in registers as the A
//   fragments of P v, with v read by ldmatrix.trans, so P never touches
//   shared memory.  exp(s - m) is taken as exp2(s log2(e) - m log2(e)),
//   one FFMA and one MUFU op.  Bases that are not 16-byte aligned, or
//   D % 8 != 0, take 2-byte loads into the same tiles (kVec = false).
// * f32 keeps FFMA on the FP32 units (flash_fwd_f32_kernel), exact f32
//   products as the CPU's: 256 threads, each a 4 x 4 tile of scores and a
//   4 x D/16 tile of the output in registers, tiles widened in shared
//   memory.
//
// Numerics of both, as the TPU kernel and plain_flash_fwd: f32 scores,
// sums and accumulators; the probabilities are rounded to the input dtype
// before the P @ V product (bf16: by the repack; f32: a no-op).  Dropout,
// as in the TPU kernel: the running max m and sum l come from the undropped
// probabilities, a dropped probability is zeroed before its rounding and the
// P @ V product, the output is acc * (scale / l) with scale = 1 / (1 - rate),
// and lse = m + log l is unchanged.  The keep bit of (row, col) is Philox at
// the counter (bh * Tq + row) * Tk + col (philox.cuh), independent of the
// tiling; each tile's 64 x 64 bits are drawn into shared memory by the whole
// block (in the bf16 kernel while the next tile's copies are in flight).
//
// Masking: keys at or past min(kv_len, Tk) get probability 0 and key tiles
// wholly past it are never loaded, so every tile the loop sees holds at
// least one valid key.  Query rows at or past Tq are zero-filled and not
// written.  Neither T needs padding by the caller.  wgmma and TMA are the
// next step (ROADMAP.md, queue 2).
#include <math.h>

#include "common.cuh"
#include "philox.cuh"

namespace {

constexpr int kBQ = 64;  // query rows per block
constexpr int kBK = 64;  // keys per shared-memory tile
using bf16 = __nv_bfloat16;

// ---- bf16 on the tensor cores ---------------------------------------------

constexpr int kMmaThreads = 128;  // 4 warps x 16 query rows
constexpr float kLog2e = 1.4426950408889634f;

template <int DMAX>
constexpr int mma_smem_bytes() {
  return (int)sizeof(bf16) * (kBQ + 4 * kBK) * (DMAX + 8)  // q, 2 x (k, v)
         + kBQ * 2 * (int)sizeof(uint32_t);                 // keep bits
}

// At D <= 64 four blocks fit an SM's shared memory (4 x 46.6 KB), if the
// registers fit too: at most 128 a thread.
template <int DMAX, bool kDropout, bool kVec>
__global__ void __launch_bounds__(kMmaThreads, DMAX == 64 ? 4 : 1)
    flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, bf16* __restrict__ o,
                         float* __restrict__ lse, int Tq, int Tk, int D,
                         int kv_len, uint32_t seed, uint32_t threshold,
                         float scale) {
  constexpr int LD = DMAX + 8;       // row stride of every tile, in bf16
  constexpr int kSteps = DMAX / 16;  // k-steps of q k^T over d
  constexpr int kOut = DMAX / 8;     // n-tiles of the output over d
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sK = sQ + kBQ * LD;      // two stages
  bf16* sV = sK + 2 * kBK * LD;  // two stages
  // keep bits: row r's keys 32h .. 32h + 31 in sMask[2 r + h]
  uint32_t* sMask = reinterpret_cast<uint32_t*>(sV + 2 * kBK * LD);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tg = lane & 3;
  const long long bh = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const int kv_end = min(kv_len, Tk);
  const int n_tiles = (kv_end + kBK - 1) / kBK;
  const bf16* kb = k + bh * (long long)Tk * D;
  const bf16* vb = v + bh * (long long)Tk * D;
  // ldmatrix row addresses: a_* for A (plain) and B (trans) operands, b_*
  // for B (plain); see common.cuh.
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8, a_col = (lane >> 4) * 8;
  const int b_row = (lane & 7) + ((lane >> 4) << 3), b_col = ((lane >> 3) & 1) * 8;

  tethys::load_tile_bf16<kBQ, DMAX, kVec, kMmaThreads>(
      sQ, q + bh * (long long)Tq * D, q0, Tq, D);
  tethys::cp_async_commit();
  tethys::load_tile_bf16<kBK, DMAX, kVec, kMmaThreads>(sK, kb, 0, kv_end, D);
  tethys::load_tile_bf16<kBK, DMAX, kVec, kMmaThreads>(sV, vb, 0, kv_end, D);
  tethys::cp_async_commit();
  tethys::cp_async_wait<1>();
  __syncthreads();
  uint32_t qf[kSteps][4];
#pragma unroll
  for (int ks = 0; ks < kSteps; ++ks)
    tethys::ldmatrix_x4(qf[ks], sQ + (16 * warp + a_row) * LD + 16 * ks + a_col);

  // Rows g and g + 8 of the warp's 16: m, l (this lane's share of the sum
  // until the epilogue) and the output fragments.
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float m2[2];  // m * log2(e): exp(s - m) = exp2(s * log2(e) - m2)
  float acc[kOut][4];
#pragma unroll
  for (int n = 0; n < kOut; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int st = it & 1, k0 = it * kBK;
    const bool next = it + 1 < n_tiles;
    if (next) {
      tethys::load_tile_bf16<kBK, DMAX, kVec, kMmaThreads>(
          sK + (st ^ 1) * kBK * LD, kb, k0 + kBK, kv_end, D);
      tethys::load_tile_bf16<kBK, DMAX, kVec, kMmaThreads>(
          sV + (st ^ 1) * kBK * LD, vb, k0 + kBK, kv_end, D);
      tethys::cp_async_commit();
    }
    if constexpr (kDropout) {
      const int r = tid >> 1, h = tid & 1;
      sMask[tid] = tethys::keep_bits<32>(
          ((uint64_t)bh * Tq + (q0 + r)) * (uint64_t)Tk + (uint64_t)(k0 + 32 * h),
          seed, threshold);
    }
    if (next)
      tethys::cp_async_wait<1>();
    else
      tethys::cp_async_wait<0>();
    __syncthreads();
    const bf16* cK = sK + st * kBK * LD;
    const bf16* cV = sV + st * kBK * LD;

    // S = q k^T: 8 n-tiles of 8 keys, c[0..1] row g, c[2..3] row g + 8.
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks)
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        uint32_t b[4];
        tethys::ldmatrix_x4(b, cK + (16 * p + b_row) * LD + 16 * ks + b_col);
        tethys::mma_bf16(s[2 * p], qf[ks], b);
        tethys::mma_bf16(s[2 * p + 1], qf[ks], b + 2);
      }
    if (k0 + kBK > kv_end) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (k0 + 8 * j + 2 * tg + (c & 1) >= kv_end) s[j][c] = -INFINITY;
    }

    // Online softmax: the 4 lanes of a quad hold a row's 64 columns.
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float alpha = exp2f((m[r] - mx[r]) * kLog2e);  // 0 on tile 0
      m[r] = mx[r];
      m2[r] = mx[r] * kLog2e;
      l[r] *= alpha;
#pragma unroll
      for (int n = 0; n < kOut; ++n) {
        acc[n][2 * r] *= alpha;
        acc[n][2 * r + 1] *= alpha;
      }
    }
    uint32_t keep[2][2];
    if constexpr (kDropout) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        keep[r][0] = sMask[2 * (16 * warp + g + 8 * r)];
        keep[r][1] = sMask[2 * (16 * warp + g + 8 * r) + 1];
      }
    }
    // P, rounded to bf16, as the A fragments of P v (k-step t: keys 16t ..).
    uint32_t pa[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float p[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        p[c] = exp2f(fmaf(s[j][c], kLog2e, -m2[c >> 1]));
        l[c >> 1] += p[c];
        if constexpr (kDropout) {
          const int bit = 8 * (j & 3) + 2 * tg + (c & 1);
          if (!((keep[c >> 1][j >> 2] >> bit) & 1u)) p[c] = 0.f;
        }
      }
      pa[j >> 1][(j & 1) * 2] = tethys::pack_bf16x2(p[0], p[1]);
      pa[j >> 1][(j & 1) * 2 + 1] = tethys::pack_bf16x2(p[2], p[3]);
    }
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int np = 0; np < kOut / 2; ++np) {
        uint32_t b[4];
        tethys::ldmatrix_x4_trans(b, cV + (16 * t + a_row) * LD + 16 * np + a_col);
        tethys::mma_bf16(acc[2 * np], pa[t], b);
        tethys::mma_bf16(acc[2 * np + 1], pa[t], b + 2);
      }
    __syncthreads();  // this stage is read; the next copy may overwrite it
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = q0 + 16 * warp + g + 8 * r;
    if (row >= Tq) continue;
    const float f = scale / l[r];
    bf16* orow = o + (bh * Tq + row) * D;
#pragma unroll
    for (int n = 0; n < kOut; ++n) {
      const int d = 8 * n + 2 * tg;
      if (kVec) {
        if (d < D)
          *reinterpret_cast<uint32_t*>(orow + d) =
              tethys::pack_bf16x2(acc[n][2 * r] * f, acc[n][2 * r + 1] * f);
      } else {
        if (d < D) orow[d] = __float2bfloat16_rn(acc[n][2 * r] * f);
        if (d + 1 < D) orow[d + 1] = __float2bfloat16_rn(acc[n][2 * r + 1] * f);
      }
    }
    if (tg == 0) lse[bh * Tq + row] = m[r] + logf(l[r]);
  }
}

// ---- f32 on the FP32 units ------------------------------------------------

constexpr int kThreads = 256;
constexpr int kPad = 4;  // keeps float4 alignment, spreads banks
constexpr int kRows = 4; // query rows per thread
constexpr int kCols = 4; // key columns per thread

template <int DMAX, bool kDropout>
constexpr int smem_floats() {
  return DMAX * (kBQ + kPad)    // q, transposed [d][row]
         + DMAX * (kBK + kPad)  // k, transposed [d][key]
         + kBK * DMAX           // v [key][d]
         + kBK * (kBQ + kPad)   // p, transposed [key][row]
         + (kDropout ? kBQ * 2 : 0);  // keep bits, 64 per row
}

template <int DMAX, bool kDropout>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o,
                         float* __restrict__ lse, int Tq, int Tk, int D,
                         int kv_len, uint32_t seed, uint32_t threshold,
                         float scale) {
  constexpr int kOutCols = DMAX / 16;  // output columns per thread
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* sQ = smem;
  float* sK = sQ + DMAX * (kBQ + kPad);
  float* sV = sK + DMAX * (kBK + kPad);
  float* sP = sV + kBK * DMAX;
  // keep bits: row r's keys 16j .. 16j + 15 in sMask[r * 4 + j]
  uint16_t* sMask = reinterpret_cast<uint16_t*>(sP + kBK * (kBQ + kPad));

  const int tid = threadIdx.x;
  const int tx = tid & 15;  // 16 threads share a row group
  const int ty = tid >> 4;  // row group: rows ty*4 .. ty*4+3
  const long long bh = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const int kv_end = min(kv_len, Tk);

  const float* qb = q + bh * (long long)Tq * D;
  const float* kb = k + bh * (long long)Tk * D;
  const float* vb = v + bh * (long long)Tk * D;

  for (int e = tid; e < kBQ * DMAX; e += kThreads) {
    const int r = e / DMAX, d = e % DMAX;
    const int row = q0 + r;
    sQ[d * (kBQ + kPad) + r] =
        (row < Tq && d < D) ? qb[(long long)row * D + d] : 0.f;
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
      sK[d * (kBK + kPad) + c] = ok ? kb[off] : 0.f;
      sV[c * DMAX + d] = ok ? vb[off] : 0.f;
    }
    if constexpr (kDropout) {
      const int r = tid >> 2, quarter = tid & 3;  // 64 rows x 4 quarters
      const uint64_t n0 = ((uint64_t)bh * Tq + (q0 + r)) * (uint64_t)Tk +
                          (uint64_t)(k0 + 16 * quarter);
      sMask[r * 4 + quarter] =
          (uint16_t)tethys::keep_bits<16>(n0, seed, threshold);
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
        float p = valid[j] ? expf(s[i][j] - m_new) : 0.f;
        sum += p;
        if constexpr (kDropout) {
          if (!((sMask[(ty * kRows + i) * 4 + j] >> tx) & 1u)) p = 0.f;
        }
        s[i][j] = p;
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
    const float inv = scale / l[i];
#pragma unroll
    for (int j = 0; j < kOutCols; ++j) {
      const int d = tx + 16 * j;
      if (d < D) o[(bh * Tq + row) * D + d] = acc[i][j] * inv;
    }
    if (tx == 0) lse[bh * Tq + row] = m[i] + logf(l[i]);
  }
}

// ---- launch ---------------------------------------------------------------

template <int DMAX, bool kDropout, bool kVec>
int launch_mma(const void* q, const void* k, const void* v, void* o,
               void* lse, int BH, int Tq, int Tk, int D, int kv_len,
               uint32_t seed, uint32_t threshold, float scale,
               cudaStream_t stream) {
  const int smem = mma_smem_bytes<DMAX>();
  auto kernel = flash_fwd_mma_kernel<DMAX, kDropout, kVec>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Tq + kBQ - 1) / kBQ, BH);
  kernel<<<grid, kMmaThreads, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, (float*)lse,
      Tq, Tk, D, kv_len, seed, threshold, scale);
  return (int)cudaGetLastError();
}

template <int DMAX, bool kDropout>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               void* lse, int BH, int Tq, int Tk, int D, int kv_len,
               uint32_t seed, uint32_t threshold, float scale,
               cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<DMAX, kDropout>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32_kernel<DMAX, kDropout>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Tq + kBQ - 1) / kBQ, BH);
  flash_fwd_f32_kernel<DMAX, kDropout><<<grid, kThreads, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o,
      (float*)lse, Tq, Tk, D, kv_len, seed, threshold, scale);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return (uintptr_t)p % 16 == 0; }

template <int DMAX, bool kDropout>
int dispatch_bf16(const void* q, const void* k, const void* v, void* o,
                  void* lse, int BH, int Tq, int Tk, int D, int kv_len,
                  uint32_t seed, uint32_t threshold, float scale,
                  cudaStream_t s) {
  if (D % 8 == 0 && aligned16(q) && aligned16(k) && aligned16(v) &&
      aligned16(o))
    return launch_mma<DMAX, kDropout, true>(q, k, v, o, lse, BH, Tq, Tk, D,
                                            kv_len, seed, threshold, scale, s);
  return launch_mma<DMAX, kDropout, false>(q, k, v, o, lse, BH, Tq, Tk, D,
                                           kv_len, seed, threshold, scale, s);
}

template <bool kDropout>
int dispatch(const void* q, const void* k, const void* v, void* o, void* lse,
             int BH, int Tq, int Tk, int D, int kv_len, int is_bf16,
             uint32_t seed, uint32_t threshold, float scale, void* stream) {
  if (BH <= 0 || BH > 65535 || Tq <= 0 || Tk <= 0 || D <= 0 || D > 128 ||
      kv_len <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) {
    if (D <= 64)
      return dispatch_bf16<64, kDropout>(q, k, v, o, lse, BH, Tq, Tk, D,
                                         kv_len, seed, threshold, scale, s);
    return dispatch_bf16<128, kDropout>(q, k, v, o, lse, BH, Tq, Tk, D,
                                        kv_len, seed, threshold, scale, s);
  }
  if (D <= 64)
    return launch_f32<64, kDropout>(q, k, v, o, lse, BH, Tq, Tk, D, kv_len,
                                    seed, threshold, scale, s);
  return launch_f32<128, kDropout>(q, k, v, o, lse, BH, Tq, Tk, D, kv_len,
                                   seed, threshold, scale, s);
}

}  // namespace

// q [BH, Tq, D], k and v [BH, Tk, D], all f32 (is_bf16 = 0) or bf16, all
// contiguous -> o [BH, Tq, D] in the same dtype, lse [BH, Tq] f32.
// 1 <= D <= 128, kv_len >= 1; BH <= 65535.
TETHYS_EXPORT int tethys_flash_fwd(const void* q, const void* k,
                                   const void* v, void* o, void* lse, int BH,
                                   int Tq, int Tk, int D, int kv_len,
                                   int is_bf16, void* stream) {
  return dispatch<false>(q, k, v, o, lse, BH, Tq, Tk, D, kv_len, is_bf16, 0u,
                         0u, 1.f, stream);
}

// The same with attention dropout: keep = Philox bits >= threshold
// (threshold = uint32(rate * 2^32)), scale = 1 / (1 - rate), both as the
// wrapper computes them.
TETHYS_EXPORT int tethys_flash_fwd_dropout(const void* q, const void* k,
                                           const void* v, void* o, void* lse,
                                           int BH, int Tq, int Tk, int D,
                                           int kv_len, int is_bf16,
                                           uint32_t seed, uint32_t threshold,
                                           float scale, void* stream) {
  return dispatch<true>(q, k, v, o, lse, BH, Tq, Tk, D, kv_len, is_bf16, seed,
                        threshold, scale, stream);
}
