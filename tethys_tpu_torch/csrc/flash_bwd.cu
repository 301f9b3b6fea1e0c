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
//   ds = p . (dp - delta * (1 - r)),   delta = rowsum(do . o)
//   dk += ds^T q,  dq += ds k    ds rounded to the input dtype
//
// and dk, dv, dq are scaled by 1 / (1 - r) in the epilogue.  M is Philox at
// (bh * Tq + row) * Tk + col (philox.cuh), the forward's mask.
//
// The TPU grid ran the q blocks of one key block in order, carrying dk and
// dv in VMEM scratch.  Here one block owns a key tile of one (batch, head)
// and loops over every q tile, keeping dk and dv in registers; dq rows
// receive a partial sum from every key tile, added into an f32 buffer.  So
// there is no Tk limit and no second pass: one kernel covers every Tk,
// where the TPU needs two above 2048 keys.  tethys_flash_bwd launches three
// kernels on the stream: a pass that forms delta (what the JAX package
// computes in XLA before its kernel) and zeroes the f32 dq buffer, the
// route's kernel, and for bf16 a pass that rounds dq.
//
// What bounds it on an H100: arithmetic, five products of the tile pair's
// size, and with dropout the keep bits' Philox rounds (as the forward's).
// The caller picks one of three routes by shape (ops/flash_attention.py:
// flash_route) and passes its code; a route that cannot take the operands
// returns an error, and none falls back to another:
//
// * "wgmma" (bf16, D % 16 == 0, 16-byte aligned bases).  A block owns 128
//   keys: a producer warpgroup whose warp 0 loads k and v once by TMA
//   (128-byte swizzle, boxes of 64 columns), then q and do tile by tile
//   (64 rows) into a 3-stage ring (2 at D > 64), lane 0 by TMA and every
//   lane a row pair of lse and delta (rows past Tq read as 0), and two
//   consumer warpgroups of 64 keys each.  A consumer computes s^T = k q^T
//   and dp^T = v do^T by wgmma from shared memory in two groups, takes
//   p = exp2(s log2(e) - lse log2(e)) under the dp^T product, forms M.p
//   and ds in the accumulator layout, which is that of the register A
//   operand of dv += (M.p)^T do and dk += ds^T q (do and q read MN-major
//   through the descriptor), and stages ds^T in shared memory for its dq
//   share, ds k over its 64 keys (ds^T an MN-major A, k an MN-major B).
//   Its dq partial goes through shared memory (128-byte swizzled f32) to
//   dq_acc by a TMA reduce-add (cp.reduce.async.bulk.tensor, a reduction
//   in L2).  The q tiles run as a software pipeline: tile t + 1's s^T and
//   dp^T are issued behind tile t's dv, dk and dq, so the tensor cores do
//   not wait for a consumer's elementwise work between tiles; the two
//   consumers share nothing but the q ring and run apart.  With dropout a
//   fourth warpgroup joins the producer's to draw each tile's 64 x 128 keep
//   bits into a 2-stage ring in shared memory.  dk and dv are scaled,
//   rounded, staged in the consumer's rows of the k and v tiles and stored
//   by TMA (keys past Tk clipped).
// * "mma" (the other bf16 shapes): flash_bwd_mma_kernel, 4 warps, a
//   64-key tile.  k and v stay resident in shared memory as bf16; q, do,
//   lse and delta come in by cp.async in a 2-stage ring.  Warp w computes
//   s = q k^T and dp = do v^T for q rows 16w .. 16w + 15 (mma.sync
//   m16n8k16, f32 sums), forms p and ds on the accumulator fragments, and
//   stages M.p and ds as bf16 in shared memory; then dv += (M.p)^T do and
//   dk += ds^T q for keys 16w .. 16w + 15 read them back by ldmatrix.trans.
//   dq's share ds k takes ds straight from registers and is added to the
//   f32 buffer two floats at a time (float2 atomicAdd, a vector reduction
//   in L2).  Tiles keep rows padded by 8 bf16, so ldmatrix and the staging
//   stores are free of bank conflicts.  Bases that are not 16-byte
//   aligned, or D % 8 != 0, take 2-byte loads and scalar atomics in the
//   same kernel (kVec = false).
// * "ffma" (f32): flash_bwd_f32_kernel keeps FFMA on the FP32 units, exact
//   f32 products as the CPU's: 256 threads, each a 4 x 4 tile of s and dp
//   and a 4 x D/16 tile of dk, dv and dq; tiles in shared memory with row
//   strides padded by 4 floats; dq by scalar atomicAdd into dq itself.
//
// Ragged edges: rows >= Tq and keys >= min(kv_len, Tk) get p = 0; key tiles
// wholly past kv_len write zeros and add nothing to dq.
#include <math.h>
#include <string.h>

#include "hopper.cuh"
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

// ---- bf16, route "wgmma": TMA + wgmma, warp-specialised -------------------

namespace hp = tethys::hopper;

constexpr int kWgBK = 128;              // keys per block
constexpr int kWgBQ = 64;               // query rows per tile
// Threads: a producer warpgroup, 2 consumers and, with dropout, a fourth
// warpgroup that draws keep bits beside the producer's.
template <bool kDropout>
__host__ __device__ constexpr int wg_threads() {
  return kDropout ? 512 : 384;
}
constexpr int kPanelK = kWgBK * 128;    // one 64-column panel of k or v
constexpr int kPanelQ = kWgBQ * 128;    // of a q or do tile
constexpr int kDsBytes = 64 * 128;      // a warpgroup's ds^T [64 keys][64 rows]
constexpr int kMaskWords = kWgBQ * kWgBK / 32;  // a tile's keep bits
constexpr int kMaskStages = 2;  // tiles of keep bits the drawers run ahead
// Registers a thread.  setmaxnreg moves registers only among the block's
// own warps, and the launch gives each of 384 threads 65536 / 384 = 168
// (rounded down to 8), each of 512 threads 128; so a producer and two
// consumer warps hold at most 3 x 168, and with a drawing warp 4 x 128.
// The consumers hold dk, dv, dq and a tile's s^T, dp^T and their bf16
// fragments; with dropout the producer and the drawing warpgroup run
// Philox.
template <bool kDropout>
struct WgRegs {
  static constexpr int kProducer = kDropout ? 48 : 40;
  static constexpr int kConsumer = kDropout ? 208 : 232;
  static_assert(kDropout ? 2 * kProducer + 2 * kConsumer <= 4 * 128
                         : kProducer + 2 * kConsumer <= 3 * 168,
                "more registers than the block holds");
};

// Stages of the q / do ring: 3 where they fit beside the rest.
template <int DMAX>
__host__ __device__ constexpr int wg_stages() {
  return DMAX == 64 ? 3 : 2;
}

template <int DMAX>
constexpr int wg_smem_bytes() {
  return 1024 + (DMAX / 64) * (2 * kPanelK + 2 * wg_stages<DMAX>() * kPanelQ) +
         2 * kDsBytes + 2 * kWgBQ * DMAX * (int)sizeof(float)  // dq partials
         + 2 * wg_stages<DMAX>() * kWgBQ * (int)sizeof(float)  // lse, delta
         + kMaskStages * kMaskWords * (int)sizeof(uint32_t)    // keep bits
         + 16 * 8;                                             // barriers
}

struct WgParams {
  CUtensorMap q, k, v, dout;  // [BH, T, D] bf16 as (D, T, BH)
  CUtensorMap dk, dv;         // stores, boxes of 64 keys
  CUtensorMap dq;             // dq_acc [BH, Tq, D] f32, reduce-adds
  const float *lse, *delta;   // [BH, Tq]
  bf16 *dk_out, *dv_out;      // for key tiles wholly past kv_len
  int Tq, Tk, D, kv_len;
  uint32_t seed, threshold;
  float keep_prob, inv;
};

template <int DMAX, bool kDropout>
__global__ void __launch_bounds__(wg_threads<kDropout>(), 1)
    flash_bwd_wgmma_kernel(const __grid_constant__ WgParams p) {
  constexpr int kPanels = DMAX / 64;
  constexpr int kStages = wg_stages<DMAX>();
  constexpr int kAcc = DMAX / 2;  // dk, dv, dq accumulators a thread
  const int bh = blockIdx.y, k0 = blockIdx.x * kWgBK;
  const int kv_end = min(p.kv_len, p.Tk);
  if (k0 >= kv_end) {
    // Keys wholly past kv_len: zero gradients, no dq share.
    const long long base = ((long long)bh * p.Tk + k0) * p.D;
    const int n = (min(k0 + kWgBK, p.Tk) - k0) * p.D;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      p.dk_out[base + i] = __float2bfloat16_rn(0.f);
      p.dv_out[base + i] = __float2bfloat16_rn(0.f);
    }
    return;
  }
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sK = (uint8_t*)(((uintptr_t)smem_raw + 1023) & ~(uintptr_t)1023);
  uint8_t* sV = sK + kPanels * kPanelK;
  uint8_t* sQ = sV + kPanels * kPanelK;             // kStages stages
  uint8_t* sDO = sQ + kStages * kPanels * kPanelQ;  // kStages stages
  uint8_t* sDS = sDO + kStages * kPanels * kPanelQ; // one a warpgroup
  // dq partials, one a warpgroup: DMAX / 32 chunks of 32 columns
  uint8_t* sDQ = sDS + 2 * kDsBytes;
  float* sLse = (float*)(sDQ + 2 * kWgBQ * DMAX * 4);  // kStages stages
  float* sDelta = sLse + kStages * kWgBQ;           // kStages stages
  // keep bits, kMaskStages stages: q row r's keys 32 h .. 32 h + 31 in
  // word 4 r + h
  uint32_t* sMask = (uint32_t*)(sDelta + kStages * kWgBQ);
  uint64_t* bar = (uint64_t*)(sMask + kMaskStages * kMaskWords);
  uint64_t* kv_full = bar;
  uint64_t* q_full = bar + 1;             // kStages
  uint64_t* q_empty = bar + 1 + kStages;  // kStages
  uint64_t* m_full = bar + 1 + 2 * kStages;  // kMaskStages each
  uint64_t* m_empty = m_full + kMaskStages;

  const int n_q = (p.Tq + kWgBQ - 1) / kWgBQ;
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    hp::mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      hp::mbar_init(&q_full[s], 32);    // the producer warp's lanes
      hp::mbar_init(&q_empty[s], 256);  // every consumer thread
    }
    for (int s = 0; s < kMaskStages; ++s) {
      hp::mbar_init(&m_full[s], 256);   // the drawing threads
      hp::mbar_init(&m_empty[s], 256);  // every consumer thread
    }
    hp::fence_barrier_init();
  }
  __syncthreads();

  using Regs = WgRegs<kDropout>;
  if (wg == 0 || wg == 3) {
    // Producer: warp 0 loads k and v once, then q and do by TMA (lane 0)
    // and the rows' lse and delta (every lane; rows past Tq read as 0)
    // tile by tile.  With dropout, warpgroups 0 and 3 draw each tile's
    // keep bits, two tiles ahead at most.
    hp::setmaxnreg_dec<Regs::kProducer>();
    const int lane = threadIdx.x & 31;
    const bool loader = threadIdx.x < 32;
    const int drawer = (threadIdx.x & 127) + (wg == 3 ? 128 : 0);
    if (threadIdx.x == 0) {
      hp::mbar_arrive_expect_tx(kv_full, 2 * kPanels * kPanelK);
      for (int pn = 0; pn < kPanels; ++pn) {
        hp::tma_load_3d(sK + pn * kPanelK, &p.k, kv_full, 64 * pn, k0, bh);
        hp::tma_load_3d(sV + pn * kPanelK, &p.v, kv_full, 64 * pn, k0, bh);
      }
    }
    const float* lse = p.lse + (long long)bh * p.Tq;
    const float* delta = p.delta + (long long)bh * p.Tq;
    for (int t = 0; t < n_q; ++t) {
      if (loader) {
        const int s = t % kStages;
        float rows[4];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int row = t * kWgBQ + lane + 32 * i;
          rows[2 * i] = row < p.Tq ? lse[row] : 0.f;
          rows[2 * i + 1] = row < p.Tq ? delta[row] : 0.f;
        }
        hp::mbar_wait(&q_empty[s], ((t / kStages) & 1) ^ 1);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          sLse[s * kWgBQ + lane + 32 * i] = rows[2 * i];
          sDelta[s * kWgBQ + lane + 32 * i] = rows[2 * i + 1];
        }
        if (lane == 0) {
          hp::mbar_arrive_expect_tx(&q_full[s], 2 * kPanels * kPanelQ);
          for (int pn = 0; pn < kPanels; ++pn) {
            hp::tma_load_3d(sQ + (s * kPanels + pn) * kPanelQ, &p.q,
                            &q_full[s], 64 * pn, t * kWgBQ, bh);
            hp::tma_load_3d(sDO + (s * kPanels + pn) * kPanelQ, &p.dout,
                            &q_full[s], 64 * pn, t * kWgBQ, bh);
          }
        } else {
          hp::mbar_arrive(&q_full[s]);
        }
      }
      if constexpr (kDropout) {
        const int s = t % kMaskStages;
        hp::mbar_wait(&m_empty[s], ((t / kMaskStages) & 1) ^ 1);
        uint32_t* words = sMask + s * kMaskWords;
#pragma unroll 1
        for (int w = drawer; w < kMaskWords; w += 256)
          words[w] = tethys::keep_bits<32>(
              ((uint64_t)bh * p.Tq + (t * kWgBQ + (w >> 2))) * (uint64_t)p.Tk +
                  (uint64_t)(k0 + 32 * (w & 3)),
              p.seed, p.threshold);
        hp::mbar_arrive(&m_full[s]);
      } else if (!loader) {
        break;
      }
    }
    return;
  }

  // Consumers: warpgroup cw owns keys 64 cw .. 64 cw + 63 of the block.
  // Accumulator layouts: s^T, dp^T [64 keys x 64 rows]: x[4 j + 2 h + c] is
  // key 16 warp + g + 8 h, q row 8 j + 2 qd + c; dk, dv [64 keys x DMAX]
  // and dq [64 rows x DMAX]: x[4 n + 2 h + c] is key (row) 16 warp + g +
  // 8 h, column 8 n + 2 qd + c.
  hp::setmaxnreg_inc<Regs::kConsumer>();
  const int cw = wg - 1, ctid = threadIdx.x & 127;
  const int warp = ctid >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, qd = lane & 3;
  float dk_acc[kAcc], dv_acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  hp::fence_operands<kAcc>(dk_acc);
  hp::fence_operands<kAcc>(dv_acc);
  hp::mbar_wait(kv_full, 0);

  // s^T = k q^T, then dp^T = v do^T, over d, of tile t, in two groups.
  float st[32], dpt[32], dq_acc[kAcc];
  auto sdp_products = [&](int t) {
    const int s = t % kStages;
    hp::mbar_wait(&q_full[s], (t / kStages) & 1);
    const uint8_t* cQ = sQ + s * kPanels * kPanelQ;
    const uint8_t* cDO = sDO + s * kPanels * kPanelQ;
    hp::wgmma_fence();
#pragma unroll
    for (int pn = 0; pn < kPanels; ++pn) {
      const uint64_t da = hp::desc_sw128(sK + pn * kPanelK + cw * (kPanelK / 2));
      const uint64_t db = hp::desc_sw128(cQ + pn * kPanelQ);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hp::wgmma_ss_m64n64k16<0, 0>(st, da + 2 * kk, db + 2 * kk,
                                     (pn | kk) != 0);
    }
    hp::wgmma_commit();
#pragma unroll
    for (int pn = 0; pn < kPanels; ++pn) {
      const uint64_t da = hp::desc_sw128(sV + pn * kPanelK + cw * (kPanelK / 2));
      const uint64_t db = hp::desc_sw128(cDO + pn * kPanelQ);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hp::wgmma_ss_m64n64k16<0, 0>(dpt, da + 2 * kk, db + 2 * kk,
                                     (pn | kk) != 0);
    }
    hp::wgmma_commit();
  };
  // This warpgroup's ds^T and dq partial.
  uint8_t* cDS = sDS + cw * kDsBytes;
  uint8_t* cDQ = sDQ + cw * (kWgBQ * DMAX * 4);
  // dq * inv of tile t into 32-column chunks of [64 rows][128 bytes],
  // 128-byte swizzled, added into dq_acc by TMA (rows past Tq clipped).
  auto dq_out = [&](int t) {
    hp::fence_operands<kAcc>(dq_acc);
#pragma unroll
    for (int n = 0; n < kAcc / 4; ++n)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * warp + g + 8 * h;
        const int u = 2 * (n & 3) + (qd >> 1);
        *reinterpret_cast<float2*>(cDQ + (n >> 2) * 8192 + r * 128 +
                                   ((u ^ (r & 7)) << 4) + 8 * (qd & 1)) =
            make_float2(dq_acc[4 * n + 2 * h] * p.inv,
                        dq_acc[4 * n + 2 * h + 1] * p.inv);
      }
    hp::fence_async_smem();
    hp::named_barrier_sync(4 + cw, 128);
    if (ctid == 0) {
      for (int ch = 0; ch < DMAX / 32 && 32 * ch < p.D; ++ch)
        hp::tma_reduce_add_3d(&p.dq, cDQ + ch * 8192, 32 * ch, t * kWgBQ, bh);
      hp::bulk_commit();
    }
  };
  // Tile t - 1's dv, dk and dq products are done: its stage goes back to
  // the producer, and its dq partial out.
  uint32_t pa[4][4], da[4][4];
  auto retire = [&](int t) {
    hp::fence_operands<kAcc>(dv_acc);
    hp::fence_operands<kAcc>(dk_acc);
    hp::fence_operands_u32<16>(&pa[0][0]);
    hp::fence_operands_u32<16>(&da[0][0]);
    hp::mbar_arrive(&q_empty[t % kStages]);
    dq_out(t);
  };

  // A software pipeline over the q tiles: tile t + 1's s^T and dp^T are
  // issued behind tile t's dv, dk and dq, so the tensor cores never wait
  // for this warpgroup's elementwise work between tiles.  The two
  // warpgroups share only the q ring: each adds its own 64 keys' share of
  // dq, so neither waits for the other.
  sdp_products(0);
  for (int t = 0; t < n_q; ++t) {
    const int s = t % kStages, q0 = t * kWgBQ;
    const uint8_t* cQ = sQ + s * kPanels * kPanelQ;
    const uint8_t* cDO = sDO + s * kPanels * kPanelQ;
    const float* cLse = sLse + s * kWgBQ;
    const float* cDelta = sDelta + s * kWgBQ;

    // p = exp(s - lse) while dp^T runs; 0 past Tq and kv_len.
    hp::wgmma_wait<1>();
    hp::fence_operands<32>(st);
    if (t > 0) retire(t - 1);
    const bool edge = q0 + kWgBQ > p.Tq || k0 + kWgBK > kv_end;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 lse2 = *reinterpret_cast<const float2*>(cLse + 8 * j + 2 * qd);
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int i = 4 * j + 2 * h + c;
          st[i] = exp2f(fmaf(st[i], kLog2e, -(c ? lse2.y : lse2.x) * kLog2e));
          if (edge && (q0 + 8 * j + 2 * qd + c >= p.Tq ||
                       k0 + 64 * cw + 16 * warp + g + 8 * h >= kv_end))
            st[i] = 0.f;
        }
    }
    // Keep words: row 8 j + 2 qd + c, the 32 keys that hold this warp's 16.
    uint32_t kw[16];
    if constexpr (kDropout) {
      hp::mbar_wait(&m_full[t % kMaskStages], (t / kMaskStages) & 1);
      const uint32_t* words = sMask + (t % kMaskStages) * kMaskWords + 2 * cw + (warp >> 1);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) kw[2 * j + c] = words[4 * (8 * j + 2 * qd + c)];
      hp::mbar_arrive(&m_empty[t % kMaskStages]);
    }
    hp::wgmma_wait<0>();
    hp::fence_operands<32>(dpt);

    // M.p and ds = p (M.dp - delta (1 - r)) as bf16 A fragments of dv and
    // dk (k-step t4: rows 16 t4 ..); ds^T also to shared memory for dq
    // (128-byte swizzled, [key][row]; tile t - 1's dq product, its last
    // reader, is done).
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 d2 = *reinterpret_cast<const float2*>(cDelta + 8 * j + 2 * qd);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float pd[2], ds[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int i = 4 * j + 2 * h + c;
          bool kept = true;
          if constexpr (kDropout)
            kept = (kw[2 * j + c] >> (16 * (warp & 1) + g + 8 * h)) & 1u;
          ds[c] = st[i] * ((kept ? dpt[i] : 0.f) - (c ? d2.y : d2.x) * p.keep_prob);
          pd[c] = kept ? st[i] : 0.f;
        }
        pa[j >> 1][(j & 1) * 2 + h] = tethys::pack_bf16x2(pd[0], pd[1]);
        da[j >> 1][(j & 1) * 2 + h] = tethys::pack_bf16x2(ds[0], ds[1]);
      }
    }
    // dv += (M.p)^T do and dk += ds^T q (do and q read MN-major), one
    // group, with ds^T staged between them.
    hp::wgmma_fence();
#pragma unroll
    for (int t4 = 0; t4 < 4; ++t4) {
      const uint64_t db = hp::desc_sw128_mn(cDO + t4 * 2048, kPanelQ);
      if constexpr (DMAX == 64)
        hp::wgmma_rs_m64n64k16<1>(dv_acc, pa[t4], db);
      else
        hp::wgmma_rs_m64n128k16<1>(dv_acc, pa[t4], db);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int key = 16 * warp + g + 8 * h;
        *reinterpret_cast<uint32_t*>(cDS + key * 128 + ((j ^ (key & 7)) << 4) +
                                     4 * qd) = da[j >> 1][(j & 1) * 2 + h];
      }
#pragma unroll
    for (int t4 = 0; t4 < 4; ++t4) {
      const uint64_t db = hp::desc_sw128_mn(cQ + t4 * 2048, kPanelQ);
      if constexpr (DMAX == 64)
        hp::wgmma_rs_m64n64k16<1>(dk_acc, da[t4], db);
      else
        hp::wgmma_rs_m64n128k16<1>(dk_acc, da[t4], db);
    }
    hp::wgmma_commit();
    // dq's share of these 64 keys, ds k (ds^T an MN-major A, k an MN-major
    // B), once the warpgroup's ds^T is in place; its last reduce-add has
    // read the dq buffer by then.
    hp::fence_async_smem();
    if (ctid == 0) hp::bulk_wait_read<0>();
    hp::named_barrier_sync(4 + cw, 128);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t a = hp::desc_sw128_mn(cDS + kk * 2048, kDsBytes);
      const uint64_t b =
          hp::desc_sw128_mn(sK + cw * (kPanelK / 2) + kk * 2048, kPanelK);
      if constexpr (DMAX == 64)
        hp::wgmma_ss_m64n64k16<1, 1>(dq_acc, a, b, kk != 0);
      else
        hp::wgmma_ss_m64n128k16<1, 1>(dq_acc, a, b, kk != 0);
    }
    hp::wgmma_commit();
    if (t + 1 < n_q) sdp_products(t + 1);
  }
  hp::wgmma_wait<0>();
  retire(n_q - 1);

  // Epilogue: every product that reads this warpgroup's rows of k and v is
  // done; dk and dv * inv, rounded to bf16, go into those rows and out by
  // TMA (keys past Tk clipped).
#pragma unroll
  for (int n = 0; n < kAcc / 4; ++n)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 64 * cw + 16 * warp + g + 8 * h;
      const int off = (n >> 3) * kPanelK + r * 128 + (((n & 7) ^ (r & 7)) << 4) + 4 * qd;
      *reinterpret_cast<uint32_t*>(sK + off) = tethys::pack_bf16x2(
          dk_acc[4 * n + 2 * h] * p.inv, dk_acc[4 * n + 2 * h + 1] * p.inv);
      *reinterpret_cast<uint32_t*>(sV + off) = tethys::pack_bf16x2(
          dv_acc[4 * n + 2 * h] * p.inv, dv_acc[4 * n + 2 * h + 1] * p.inv);
    }
  hp::fence_async_smem();
  hp::named_barrier_sync(4 + cw, 128);
  if (ctid == 0) {
    if (k0 + 64 * cw < p.Tk) {
      for (int pn = 0; pn < kPanels && 64 * pn < p.D; ++pn) {
        const int off = pn * kPanelK + cw * (kPanelK / 2);
        hp::tma_store_3d(&p.dk, sK + off, 64 * pn, k0 + 64 * cw, bh);
        hp::tma_store_3d(&p.dv, sV + off, 64 * pn, k0 + 64 * cw, bh);
      }
    }
    hp::bulk_commit();
    hp::bulk_wait<0>();
  }
}

// ---- around the kernels: delta and the dq buffer before, dq's cast after --

// delta = rowsum(do . o) in f32 (what the JAX package computes in XLA
// before its kernel), and the row of the f32 dq buffer, into which every
// key tile adds its share, zeroed.  kGroup lanes a row, each 16 bytes of o
// and do at a time (kVec = true: D a multiple of 16 bytes' elements, bases
// aligned), or one element at a time.
template <typename T, int kGroup, bool kVec>
__global__ void __launch_bounds__(256)
    flash_bwd_prep_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                          float* __restrict__ delta, float* __restrict__ dq_acc,
                          long long rows, int D) {
  constexpr int kElems = kVec ? 16 / (int)sizeof(T) : 1;
  const int lane = threadIdx.x % kGroup;
  const long long stride = (long long)gridDim.x * blockDim.x / kGroup;
  // The loop runs alike on a warp's lanes (its first row decides), so that
  // the shuffles below see every lane.
  for (long long first = ((long long)blockIdx.x * blockDim.x +
                          (threadIdx.x & ~31)) / kGroup;
       first < rows; first += stride) {
    const long long row = first + (threadIdx.x & 31) / kGroup;
    const long long base = row * D;
    float sum = 0.f;
    for (int d = lane * kElems; row < rows && d < D; d += kGroup * kElems) {
      if constexpr (kVec) {
        const uint4 a = *reinterpret_cast<const uint4*>(o + base + d);
        const uint4 b = *reinterpret_cast<const uint4*>(dout + base + d);
        const T* x = reinterpret_cast<const T*>(&a);
        const T* y = reinterpret_cast<const T*>(&b);
#pragma unroll
        for (int i = 0; i < kElems; ++i)
          sum = fmaf(tethys::to_f32<T>(y[i]), tethys::to_f32<T>(x[i]), sum);
#pragma unroll
        for (int i = 0; i < kElems; i += 4)
          *reinterpret_cast<float4*>(dq_acc + base + d + i) =
              make_float4(0.f, 0.f, 0.f, 0.f);
      } else {
        sum = fmaf(tethys::to_f32<T>(dout[base + d]), tethys::to_f32<T>(o[base + d]),
                   sum);
        dq_acc[base + d] = 0.f;
      }
    }
#pragma unroll
    for (int off = kGroup / 2; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0 && row < rows) delta[row] = sum;
  }
}

// dq = the f32 buffer rounded to bf16 (nearest even), 4 values a step.
__global__ void __launch_bounds__(256)
    flash_bwd_cast_kernel(const float* __restrict__ src, bf16* __restrict__ dst,
                          long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long n4 = n / 4;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += stride) {
    const float4 x = reinterpret_cast<const float4*>(src)[i];
    uint2 y;
    y.x = tethys::pack_bf16x2(x.x, x.y);
    y.y = tethys::pack_bf16x2(x.z, x.w);
    reinterpret_cast<uint2*>(dst)[i] = y;
  }
  for (long long i = 4 * n4 + (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += stride)
    dst[i] = __float2bfloat16_rn(src[i]);
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
int launch_wgmma(const Args& a, cudaStream_t stream) {
  WgParams p;
  memset(&p, 0, sizeof p);
  const cuuint64_t D = a.D, Tq = a.Tq, Tk = a.Tk, BH = a.BH;
  const cuuint64_t q_dims[3] = {D, Tq, BH}, k_dims[3] = {D, Tk, BH};
  const cuuint64_t q_strides[2] = {D * 2, Tq * D * 2};
  const cuuint64_t k_strides[2] = {D * 2, Tk * D * 2};
  const cuuint32_t q_box[3] = {64, kWgBQ, 1}, k_box[3] = {64, kWgBK, 1};
  const cuuint32_t out_box[3] = {64, kWgBK / 2, 1};
  int err = hp::encode_bf16_map(&p.q, a.q, 3, q_dims, q_strides, q_box);
  if (!err) err = hp::encode_bf16_map(&p.dout, a.dout, 3, q_dims, q_strides, q_box);
  if (!err) err = hp::encode_bf16_map(&p.k, a.k, 3, k_dims, k_strides, k_box);
  if (!err) err = hp::encode_bf16_map(&p.v, a.v, 3, k_dims, k_strides, k_box);
  if (!err) err = hp::encode_bf16_map(&p.dk, a.dk, 3, k_dims, k_strides, out_box);
  if (!err) err = hp::encode_bf16_map(&p.dv, a.dv, 3, k_dims, k_strides, out_box);
  if (!err) {
    const cuuint64_t strides[2] = {D * 4, Tq * D * 4};
    const cuuint32_t box[3] = {32, kWgBQ, 1};
    err = hp::encode_map(&p.dq, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, a.dq_acc, 3,
                         q_dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
  }
  if (err) return err;
  p.lse = (const float*)a.lse;
  p.delta = (const float*)a.delta;
  p.dk_out = (bf16*)a.dk;
  p.dv_out = (bf16*)a.dv;
  p.Tq = a.Tq;
  p.Tk = a.Tk;
  p.D = a.D;
  p.kv_len = a.kv_len;
  p.seed = a.seed;
  p.threshold = a.threshold;
  p.keep_prob = a.keep_prob;
  p.inv = a.inv;
  const int smem = wg_smem_bytes<DMAX>();
  const auto kernel = flash_bwd_wgmma_kernel<DMAX, kDropout>;
  cudaError_t cerr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (cerr != cudaSuccess) return (int)cerr;
  const dim3 grid((a.Tk + kWgBK - 1) / kWgBK, a.BH);
  kernel<<<grid, wg_threads<kDropout>(), smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// Route codes; ops/flash_attention.py's ROUTES in this order.
enum Route { kFfma = 0, kMma = 1, kWgmma = 2 };

template <int DMAX, bool kDropout>
int dispatch_d(const Args& a, int route, cudaStream_t s) {
  switch (route) {
    case kFfma:
      return launch_f32<DMAX, kDropout>(a, s);
    case kMma: {
      const bool vec = a.D % 8 == 0 && aligned16(a.q) && aligned16(a.k) &&
                       aligned16(a.v) && aligned16(a.dout) && aligned16(a.dk) &&
                       aligned16(a.dv) && aligned16(a.dq_acc);
      return vec ? launch_mma<DMAX, kDropout, true>(a, s)
                 : launch_mma<DMAX, kDropout, false>(a, s);
    }
    case kWgmma:
      // TMA needs 16-byte aligned bases and row strides, wgmma 16-deep
      // steps over d.
      if (a.D % 16 || !aligned16(a.q) || !aligned16(a.k) || !aligned16(a.v) ||
          !aligned16(a.dout) || !aligned16(a.dk) || !aligned16(a.dv) ||
          !aligned16(a.dq_acc))
        return (int)cudaErrorInvalidValue;
      return launch_wgmma<DMAX, kDropout>(a, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename T, int kGroup, bool kVec>
int launch_prep_as(const void* o, const void* dout, void* delta, void* dq_acc,
                   long long rows, int D, cudaStream_t s) {
  const long long blocks = (rows * kGroup + 255) / 256;
  const int grid = (int)(blocks < 32 * 132 ? blocks : 32 * 132);
  flash_bwd_prep_kernel<T, kGroup, kVec><<<grid, 256, 0, s>>>(
      (const T*)o, (const T*)dout, (float*)delta, (float*)dq_acc, rows, D);
  return (int)cudaGetLastError();
}

// The pass before the kernel: 16-byte vectors and the fewest lanes a row
// (a power of two) that cover it, else one element a lane.
template <typename T>
int launch_prep(const void* o, const void* dout, void* delta, void* dq_acc,
                long long rows, int D, cudaStream_t s) {
  constexpr int kElems = 16 / (int)sizeof(T);
  if (D % kElems || !aligned16(o) || !aligned16(dout) || !aligned16(dq_acc))
    return launch_prep_as<T, 32, false>(o, dout, delta, dq_acc, rows, D, s);
  const int vecs = D / kElems;
  if (vecs <= 2)
    return launch_prep_as<T, 2, true>(o, dout, delta, dq_acc, rows, D, s);
  if (vecs <= 4)
    return launch_prep_as<T, 4, true>(o, dout, delta, dq_acc, rows, D, s);
  if (vecs <= 8)
    return launch_prep_as<T, 8, true>(o, dout, delta, dq_acc, rows, D, s);
  if (vecs <= 16)
    return launch_prep_as<T, 16, true>(o, dout, delta, dq_acc, rows, D, s);
  return launch_prep_as<T, 32, true>(o, dout, delta, dq_acc, rows, D, s);
}

}  // namespace

// The gradients of o = flash_fwd(q, k, v): q, o, dout [BH, Tq, D], k, v
// [BH, Tk, D] in one dtype (f32 when is_bf16 = 0, else bf16), lse [BH, Tq]
// f32, all contiguous -> dq [BH, Tq, D], dk, dv [BH, Tk, D] in that dtype.
// Three launches on the stream: delta = rowsum(dout . o) into delta
// [BH, Tq] f32 and zeros into the f32 buffer dq_acc [BH, Tq, D]; the
// kernel of the route, which adds every key tile's share of dq (scaled by
// inv) into dq_acc; for bf16, dq = dq_acc rounded.  For f32, dq is dq_acc
// itself (the same pointer).  With dropout = 0 threshold, keep_prob and inv
// must be 0, 1 and 1.  1 <= D <= 128, kv_len >= 1, BH <= 65535.  route: a
// Route code (ffma for f32; mma or, with D % 16 == 0 and 16-byte aligned
// bases, wgmma for bf16); a route that does not take the operands returns
// an error.
TETHYS_EXPORT int tethys_flash_bwd(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, const void* lse,
                                   void* delta, void* dq_acc, void* dq,
                                   void* dk, void* dv, int BH, int Tq, int Tk,
                                   int D, int kv_len, int is_bf16, int dropout,
                                   uint32_t seed, uint32_t threshold,
                                   float keep_prob, float inv, int route,
                                   void* stream) {
  if (BH <= 0 || BH > 65535 || Tq <= 0 || Tk <= 0 || D <= 0 || D > 128 ||
      kv_len <= 0 || (route == kFfma) == (is_bf16 != 0) ||
      (!is_bf16 && dq != dq_acc))
    return (int)cudaErrorInvalidValue;
  const Args a{q,  k,  v,  dout, lse,    delta,     dk,        dv,  dq_acc,
               BH, Tq, Tk, D,    kv_len, seed, threshold, keep_prob, inv};
  cudaStream_t s = (cudaStream_t)stream;
  const long long rows = (long long)BH * Tq;
  int err = is_bf16 ? launch_prep<bf16>(o, dout, delta, dq_acc, rows, D, s)
                    : launch_prep<float>(o, dout, delta, dq_acc, rows, D, s);
  if (err) return err;
  if (D <= 64)
    err = dropout ? dispatch_d<64, true>(a, route, s)
                  : dispatch_d<64, false>(a, route, s);
  else
    err = dropout ? dispatch_d<128, true>(a, route, s)
                  : dispatch_d<128, false>(a, route, s);
  if (err || !is_bf16) return err;
  const long long n = rows * D;
  const long long blocks = (n / 4 + 255) / 256;
  const int grid = (int)(blocks < 32 * 132 ? (blocks > 0 ? blocks : 1) : 32 * 132);
  flash_bwd_cast_kernel<<<grid, 256, 0, s>>>((const float*)dq_acc, (bf16*)dq, n);
  return (int)cudaGetLastError();
}
