// Flash attention backward: dq, dk, dv of o = dropout(softmax(q k^T)) v on
// [B*H, T, D], with P recomputed from the forward's lse and the dropout
// mask regenerated from its seed.
//
// Replaces the three backward kernels of tethys_tpu/ops/pallas_attention.py:
// _bwd_dkv_dq_kernel (launched by _flash_bwd when the keys fit one block,
// Tk <= 2048, which is every length Whisper meets) and the pair it takes
// above that, _bwd_dq_kernel and _bwd_dkv_kernel.  Per (q tile, key tile),
// as the TPU kernels compute it:
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
// dv in VMEM scratch.  Here one block owns a 64-key tile of one (batch,
// head) and loops over every 64-row q tile, keeping dk and dv in registers;
// dq rows receive a partial sum from every key tile, added into an f32
// buffer the wrapper zeroes and later casts.  So there is no Tk limit and
// no second pass: one kernel covers every Tk, where the TPU needs two above
// 2048 keys.
//
// What bounds it on an H100: arithmetic, five products of 64 x 64 x D per
// tile pair.  Two kernels:
//
// * bf16 runs on the tensor cores (flash_bwd_mma_kernel): 4 warps.  k and
//   v stay resident in shared memory as bf16; q, do, lse and delta come in
//   by cp.async in a 2-stage ring, the next q tile's copies overlapping this
//   tile's products.  Warp w computes s = q k^T and dp = do v^T for q rows
//   16w .. 16w + 15 (mma.sync m16n8k16, f32 sums), forms p and ds on the
//   accumulator fragments, and stages M.p and ds as bf16 in shared memory;
//   then dv += (M.p)^T do and dk += ds^T q for keys 16w .. 16w + 15 read
//   them back by ldmatrix.trans.  dq's share ds k takes ds straight from
//   registers (the C fragments repacked as A fragments) and is added to the
//   f32 buffer two floats at a time (Hopper's float2 atomicAdd, a vector
//   reduction in L2).  p = exp2(s log2(e) - lse log2(e)).  Tiles keep rows
//   padded by 8 bf16, so ldmatrix and the staging stores are free of bank
//   conflicts.  Bases that are not
//   16-byte aligned, or D % 8 != 0, take 2-byte loads and scalar atomics
//   in the same kernel (kVec = false).
// * f32 keeps FFMA on the FP32 units (flash_bwd_f32_kernel), exact f32
//   products as the CPU's: 256 threads, each a 4 x 4 tile of s and dp and
//   a 4 x D/16 tile of dk, dv and dq; tiles in shared memory with row
//   strides padded by 4 floats; dq by scalar atomicAdd.
//
// Ragged edges: rows >= Tq and keys >= min(kv_len, Tk) are zero-filled and
// get p = 0; key tiles wholly past kv_len write zeros.  wgmma and TMA are
// the next step (ROADMAP.md, queue 2).
#include <math.h>

#include "common.cuh"
#include "philox.cuh"

namespace {

constexpr int kBQ = 64;   // query rows per tile
constexpr int kBK = 64;   // keys per block
using bf16 = __nv_bfloat16;

// ---- bf16 on the tensor cores ---------------------------------------------

constexpr int kMmaThreads = 128;  // 4 warps
constexpr int kLdP = kBK + 8;     // row stride of the staged p and ds
constexpr float kLog2e = 1.4426950408889634f;  // exp(x) = exp2(x log2(e))

template <int DMAX>
constexpr int mma_smem_bytes() {
  return (int)sizeof(bf16) * (6 * 64 * (DMAX + 8)  // k, v, 2 x (q, do)
                              + 2 * kBQ * kLdP)    // p, ds
         + (int)sizeof(float) * 4 * kBQ            // 2 x (lse, delta)
         + (int)sizeof(uint32_t) * 2 * kBQ;        // keep bits
}

// At D <= 64 three blocks fit an SM's shared memory (3 x 75 KB), if the
// registers fit too: at most 170 a thread.
template <int DMAX, bool kDropout, bool kVec>
__global__ void __launch_bounds__(kMmaThreads, DMAX == 64 ? 3 : 1)
    flash_bwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const bf16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         bf16* __restrict__ dk, bf16* __restrict__ dv,
                         float* __restrict__ dq_acc, int Tq, int Tk, int D,
                         int kv_len, uint32_t seed, uint32_t threshold,
                         float keep_prob, float inv) {
  constexpr int LD = DMAX + 8;       // row stride of the k, v, q, do tiles
  constexpr int kSteps = DMAX / 16;  // k-steps over d
  constexpr int kOut = DMAX / 8;     // n-tiles over d
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + kBK * LD;
  bf16* sQ = sV + kBK * LD;        // two stages
  bf16* sDO = sQ + 2 * kBQ * LD;   // two stages
  bf16* sP = sDO + 2 * kBQ * LD;   // [q row][key], M.p
  bf16* sDS = sP + kBQ * kLdP;     // [q row][key], ds
  float* sLse = reinterpret_cast<float*>(sDS + kBQ * kLdP);  // two stages
  float* sDelta = sLse + 2 * kBQ;                             // two stages
  // keep bits: q row r's keys 32h .. 32h + 31 in sMask[2 r + h]
  uint32_t* sMask = reinterpret_cast<uint32_t*>(sDelta + 2 * kBQ);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tg = lane & 3;
  const long long bh = blockIdx.y;
  const int k0 = blockIdx.x * kBK;
  const int kv_end = min(kv_len, Tk);
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8, a_col = (lane >> 4) * 8;
  const int b_row = (lane & 7) + ((lane >> 4) << 3), b_col = ((lane >> 3) & 1) * 8;

  float acc_dk[kOut][4], acc_dv[kOut][4];
#pragma unroll
  for (int n = 0; n < kOut; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc_dk[n][c] = acc_dv[n][c] = 0.f;

  if (k0 < kv_end) {
    const bf16* qb = q + bh * (long long)Tq * D;
    const bf16* dob = dout + bh * (long long)Tq * D;
    // q tile q0 into ring stage st (one commit group with anything before).
    auto load_q_tile = [&](int st, int q0) {
      tethys::load_tile_bf16<kBQ, DMAX, kVec, kMmaThreads>(
          sQ + st * kBQ * LD, qb, q0, Tq, D);
      tethys::load_tile_bf16<kBQ, DMAX, kVec, kMmaThreads>(
          sDO + st * kBQ * LD, dob, q0, Tq, D);
      const int r = tid & (kBQ - 1);
      const bool ok = q0 + r < Tq;
      const float* src = (tid < kBQ ? lse : delta) + bh * Tq + (ok ? q0 + r : 0);
      tethys::cp_async4((tid < kBQ ? sLse : sDelta) + st * kBQ + r, src, ok);
      tethys::cp_async_commit();
    };
    tethys::load_tile_bf16<kBK, DMAX, kVec, kMmaThreads>(
        sK, k + bh * (long long)Tk * D, k0, kv_end, D);
    tethys::load_tile_bf16<kBK, DMAX, kVec, kMmaThreads>(
        sV, v + bh * (long long)Tk * D, k0, kv_end, D);
    load_q_tile(0, 0);

    const int n_q = (Tq + kBQ - 1) / kBQ;
    const int r0 = 16 * warp + g;  // this lane's rows r0 and r0 + 8
    for (int jt = 0; jt < n_q; ++jt) {
      const int st = jt & 1, q0 = jt * kBQ;
      const bool next = jt + 1 < n_q;
      if (next) load_q_tile(st ^ 1, q0 + kBQ);
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
      const bf16* cQ = sQ + st * kBQ * LD;
      const bf16* cDO = sDO + st * kBQ * LD;

      // s = q k^T and dp = do v^T for rows r0, r0 + 8, the 64 keys.
      float s[8][4], dp[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[j][c] = dp[j][c] = 0.f;
#pragma unroll
      for (int ks = 0; ks < kSteps; ++ks) {
        uint32_t qa[4], da[4];
        tethys::ldmatrix_x4(qa, cQ + (16 * warp + a_row) * LD + 16 * ks + a_col);
        tethys::ldmatrix_x4(da, cDO + (16 * warp + a_row) * LD + 16 * ks + a_col);
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          uint32_t b[4];
          tethys::ldmatrix_x4(b, sK + (16 * p + b_row) * LD + 16 * ks + b_col);
          tethys::mma_bf16(s[2 * p], qa, b);
          tethys::mma_bf16(s[2 * p + 1], qa, b + 2);
          tethys::ldmatrix_x4(b, sV + (16 * p + b_row) * LD + 16 * ks + b_col);
          tethys::mma_bf16(dp[2 * p], da, b);
          tethys::mma_bf16(dp[2 * p + 1], da, b + 2);
        }
      }

      // p, M.p and ds on the fragments; M.p and ds to shared memory, ds
      // also as the A fragments of ds k (k-step t: keys 16t ..).
      bool row_ok[2];
      float row_lse[2], row_delta[2];  // lse in log2 units
      uint32_t keep[2][2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int rr = r0 + 8 * r;
        row_ok[r] = q0 + rr < Tq;
        row_lse[r] = sLse[st * kBQ + rr] * kLog2e;
        row_delta[r] = sDelta[st * kBQ + rr] * keep_prob;
        if constexpr (kDropout) {
          keep[r][0] = sMask[2 * rr];
          keep[r][1] = sMask[2 * rr + 1];
        }
      }
      uint32_t dsa[4][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float pd[4], ds[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int r = c >> 1, col = 8 * j + 2 * tg + (c & 1);
          const float p = (row_ok[r] && k0 + col < kv_end)
                              ? exp2f(fmaf(s[j][c], kLog2e, -row_lse[r]))
                              : 0.f;
          bool kept = true;
          if constexpr (kDropout) kept = (keep[r][j >> 2] >> (col & 31)) & 1u;
          ds[c] = p * ((kept ? dp[j][c] : 0.f) - row_delta[r]);
          pd[c] = kept ? p : 0.f;
        }
        const uint32_t d01 = tethys::pack_bf16x2(ds[0], ds[1]);
        const uint32_t d23 = tethys::pack_bf16x2(ds[2], ds[3]);
        const int col = 8 * j + 2 * tg;
        *reinterpret_cast<uint32_t*>(sP + r0 * kLdP + col) =
            tethys::pack_bf16x2(pd[0], pd[1]);
        *reinterpret_cast<uint32_t*>(sP + (r0 + 8) * kLdP + col) =
            tethys::pack_bf16x2(pd[2], pd[3]);
        *reinterpret_cast<uint32_t*>(sDS + r0 * kLdP + col) = d01;
        *reinterpret_cast<uint32_t*>(sDS + (r0 + 8) * kLdP + col) = d23;
        dsa[j >> 1][(j & 1) * 2] = d01;
        dsa[j >> 1][(j & 1) * 2 + 1] = d23;
      }

      // This key tile's share of dq rows r0, r0 + 8: ds k, 16 columns at a
      // time, added to the f32 buffer.
#pragma unroll
      for (int np = 0; np < kOut / 2; ++np) {
        float dq[2][4] = {};
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          uint32_t b[4];
          tethys::ldmatrix_x4_trans(b, sK + (16 * t + a_row) * LD + 16 * np + a_col);
          tethys::mma_bf16(dq[0], dsa[t], b);
          tethys::mma_bf16(dq[1], dsa[t], b + 2);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int d = 16 * np + 8 * h + 2 * tg;
            if (!row_ok[r] || d >= D) continue;
            float* dst = dq_acc + (bh * Tq + q0 + r0 + 8 * r) * D + d;
            if constexpr (kVec) {
              atomicAdd(reinterpret_cast<float2*>(dst),
                        make_float2(dq[h][2 * r] * inv, dq[h][2 * r + 1] * inv));
            } else {
              atomicAdd(dst, dq[h][2 * r] * inv);
              if (d + 1 < D) atomicAdd(dst + 1, dq[h][2 * r + 1] * inv);
            }
          }
      }
      __syncthreads();  // sP and sDS complete

      // dv += (M.p)^T do and dk += ds^T q for keys 16w .. 16w + 15.
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        uint32_t pa[4], sa[4];
        tethys::ldmatrix_x4_trans(pa, sP + (16 * t + b_row) * kLdP + 16 * warp + b_col);
        tethys::ldmatrix_x4_trans(sa, sDS + (16 * t + b_row) * kLdP + 16 * warp + b_col);
#pragma unroll
        for (int np = 0; np < kOut / 2; ++np) {
          uint32_t b[4];
          tethys::ldmatrix_x4_trans(b, cDO + (16 * t + a_row) * LD + 16 * np + a_col);
          tethys::mma_bf16(acc_dv[2 * np], pa, b);
          tethys::mma_bf16(acc_dv[2 * np + 1], pa, b + 2);
          tethys::ldmatrix_x4_trans(b, cQ + (16 * t + a_row) * LD + 16 * np + a_col);
          tethys::mma_bf16(acc_dk[2 * np], sa, b);
          tethys::mma_bf16(acc_dk[2 * np + 1], sa, b + 2);
        }
      }
      __syncthreads();  // the stage, sP and sDS are read
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + 16 * warp + g + 8 * r;
    if (key >= Tk) continue;
    const long long off = (bh * Tk + key) * D;
#pragma unroll
    for (int n = 0; n < kOut; ++n) {
      const int d = 8 * n + 2 * tg;
      const float k_lo = acc_dk[n][2 * r] * inv, k_hi = acc_dk[n][2 * r + 1] * inv;
      const float v_lo = acc_dv[n][2 * r] * inv, v_hi = acc_dv[n][2 * r + 1] * inv;
      if constexpr (kVec) {
        if (d < D) {
          *reinterpret_cast<uint32_t*>(dk + off + d) = tethys::pack_bf16x2(k_lo, k_hi);
          *reinterpret_cast<uint32_t*>(dv + off + d) = tethys::pack_bf16x2(v_lo, v_hi);
        }
      } else {
        if (d < D) {
          dk[off + d] = __float2bfloat16_rn(k_lo);
          dv[off + d] = __float2bfloat16_rn(v_lo);
        }
        if (d + 1 < D) {
          dk[off + d + 1] = __float2bfloat16_rn(k_hi);
          dv[off + d + 1] = __float2bfloat16_rn(v_hi);
        }
      }
    }
  }
}

// ---- f32 on the FP32 units ------------------------------------------------

constexpr int kThreads = 256;
constexpr int kRows = 4;  // rows (queries or keys) per thread
constexpr int kCols = 4;  // key columns per thread in s and dp
constexpr int kTS = kBK + 4;  // row stride of the [64][64] p and ds tiles

template <int DMAX>
constexpr int kRowStride = DMAX + 4;  // [64][DMAX] q, do, k, v tiles

template <int DMAX>
constexpr int smem_floats() {
  return 4 * 64 * kRowStride<DMAX>  // k, v, q, do
         + 2 * kBQ * kTS              // p (dropped), ds
         + 2 * kBQ                    // lse, delta
         + kBQ * 2;                   // keep bits, 64 per row
}

template <int DMAX, bool kDropout>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv,
                         float* __restrict__ dq_acc, int Tq, int Tk, int D,
                         int kv_len, uint32_t seed, uint32_t threshold,
                         float keep_prob, float inv) {
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
    const float* kb = k + bh * (long long)Tk * D;
    const float* vb = v + bh * (long long)Tk * D;
    for (int e = tid; e < kBK * DMAX; e += kThreads) {
      const int c = e / DMAX, d = e % DMAX;
      const int key = k0 + c;
      const bool ok = key < kv_end && d < D;
      const long long off = (long long)key * D + d;
      sK[c * kD + d] = ok ? kb[off] : 0.f;
      sV[c * kD + d] = ok ? vb[off] : 0.f;
    }
    const float* qb = q + bh * (long long)Tq * D;
    const float* dob = dout + bh * (long long)Tq * D;
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
        sQ[r * kD + d] = ok ? qb[off] : 0.f;
        sDO[r * kD + d] = ok ? dob[off] : 0.f;
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
            (uint16_t)tethys::keep_bits<16>(n0, seed, threshold);
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
          sP[r * kTS + tx + 16 * j] = keep ? p : 0.f;
          sDS[r * kTS + tx + 16 * j] = p * ((keep ? dp[i][j] : 0.f) - delta_s);
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
        dk[off] = acc_dk[i][j] * inv;
        dv[off] = acc_dv[i][j] * inv;
      }
    }
  }
}

// ---- launch ---------------------------------------------------------------

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *dk, *dv, *dq_acc;
  int BH, Tq, Tk, D, kv_len;
  uint32_t seed, threshold;
  float keep_prob, inv;
};

template <int DMAX, bool kDropout, bool kVec>
int launch_mma(const Args& a, cudaStream_t stream) {
  const int smem = mma_smem_bytes<DMAX>();
  auto kernel = flash_bwd_mma_kernel<DMAX, kDropout, kVec>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.Tk + kBK - 1) / kBK, a.BH);
  kernel<<<grid, kMmaThreads, smem, stream>>>(
      (const bf16*)a.q, (const bf16*)a.k, (const bf16*)a.v,
      (const bf16*)a.dout, (const float*)a.lse, (const float*)a.delta,
      (bf16*)a.dk, (bf16*)a.dv, (float*)a.dq_acc, a.Tq, a.Tk, a.D, a.kv_len,
      a.seed, a.threshold, a.keep_prob, a.inv);
  return (int)cudaGetLastError();
}

template <int DMAX, bool kDropout>
int launch_f32(const Args& a, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<DMAX>();
  auto kernel = flash_bwd_f32_kernel<DMAX, kDropout>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.Tk + kBK - 1) / kBK, a.BH);
  kernel<<<grid, kThreads, smem, stream>>>(
      (const float*)a.q, (const float*)a.k, (const float*)a.v,
      (const float*)a.dout, (const float*)a.lse, (const float*)a.delta,
      (float*)a.dk, (float*)a.dv, (float*)a.dq_acc, a.Tq, a.Tk, a.D,
      a.kv_len, a.seed, a.threshold, a.keep_prob, a.inv);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return (uintptr_t)p % 16 == 0; }

template <int DMAX, bool kDropout>
int dispatch_d(const Args& a, int is_bf16, cudaStream_t s) {
  if (!is_bf16) return launch_f32<DMAX, kDropout>(a, s);
  const bool vec = a.D % 8 == 0 && aligned16(a.q) && aligned16(a.k) &&
                   aligned16(a.v) && aligned16(a.dout) && aligned16(a.dk) &&
                   aligned16(a.dv) && aligned16(a.dq_acc);
  return vec ? launch_mma<DMAX, kDropout, true>(a, s)
             : launch_mma<DMAX, kDropout, false>(a, s);
}

template <bool kDropout>
int dispatch(const Args& a, int is_bf16, cudaStream_t s) {
  return a.D <= 64 ? dispatch_d<64, kDropout>(a, is_bf16, s)
                   : dispatch_d<128, kDropout>(a, is_bf16, s);
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
  const Args a{q,  k,  v,  dout, lse,    delta,     dk,        dv,  dq_acc,
               BH, Tq, Tk, D,    kv_len, seed, threshold, keep_prob, inv};
  cudaStream_t s = (cudaStream_t)stream;
  return dropout ? dispatch<true>(a, is_bf16, s)
                 : dispatch<false>(a, is_bf16, s);
}
