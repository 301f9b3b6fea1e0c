// Flash attention forward: o = dropout(softmax(q k^T, keys >= kv_len
// masked)) v and the per-row log-sum-exp, on [B*H, T, D] with q pre-scaled.
//
// Replaces tethys_tpu/ops/pallas_attention.py::_fwd_kernel (launched by
// _flash_fwd, via flash_attention).  Two entry points: tethys_flash_fwd
// (rate 0, serving) and tethys_flash_fwd_dropout (training), each kernel a
// template with the dropout code compiled in or out.  The TPU kernel took
// the whole key range of whisper's 1500 frames as one [512, 2048] VMEM
// block; here a block owns a tile of query rows of one (batch, head) and
// streams the keys through shared memory with the online softmax (running
// max m and sum l per row), so nothing the size of the [Tq, Tk] score
// matrix reaches device memory.
//
// What bounds it on an H100: arithmetic, 2 * Tq * Tk * D multiply-adds per
// (batch, head) against under 1 MB of q, k, v and o at 1500 frames, and
// at the softmax one exp a score (the SFU's 16 a clock an SM against the
// tensor cores' 1024 multiply-adds); with dropout, the keep bits' Philox
// rounds (24 IMAD.WIDE and ~73 instructions a call of 4 bits, SASS:
// scripts/flash_probe.py).  The caller picks one of three routes by shape
// (ops/flash_attention.py: flash_route) and passes its code; a route that
// cannot take the operands returns an error, and none falls back to
// another:
//
// * "wgmma" (bf16, D % 16 == 0, 16-byte aligned bases: every shape of the
//   main path).  A block owns 128 query rows: a producer warpgroup whose
//   thread 0 loads q once and k and v in 128-key tiles by TMA (128-byte
//   swizzle, boxes of 64 columns, rows past T read as zeros) into a
//   3-stage ring (2 at D > 64) with full/empty mbarriers, and two consumer
//   warpgroups of 64 rows each (setmaxnreg gives them the registers).  A
//   consumer computes S = q k^T by wgmma m64n128k16 from shared memory (f32
//   sums in registers), takes the online softmax on the accumulator in the
//   exp2 form, rounds P to bf16 in registers and multiplies O += P v by
//   wgmma with P as the register A operand and v read MN-major through the
//   descriptor.  Tile j's S product is issued together with tile j - 1's
//   P v, the softmax of S runs under P v, and P is repacked and O rescaled
//   once P v is done (no register of a product in flight is written, so
//   ptxas keeps the products asynchronous).  The two consumers take turns
//   to issue their products (ping-pong on named barriers 6 and 7), so one's
//   softmax runs under the other's products.  With dropout a fourth
//   warpgroup joins the producer's: their 256 threads draw each tile's
//   128 x 128 keep bits as whole Philox counters along the keys into a
//   2-stage ring in shared memory while the consumers multiply.  O is
//   scaled, rounded, staged in the q tile's rows and stored by TMA, which
//   clips rows past Tq and columns past D.
// * "mma" (the other bf16 shapes: misaligned bases, D % 16 != 0):
//   flash_fwd_mma_kernel, 4 warps, 16 query rows each.  q stays in
//   registers as mma A fragments for the whole loop; k and v tiles of 64
//   keys come in by 16-byte cp.async in a 2-stage ring (2-byte loads where
//   a base is not 16-byte aligned or D % 8 != 0, kVec = false), kept as
//   bf16 in rows padded by 8 elements so that ldmatrix is free of bank
//   conflicts.  S = q k^T by mma.sync m16n8k16 and the online softmax on
//   its fragments; P is repacked in registers as the A fragments of P v,
//   with v read by ldmatrix.trans.
// * "ffma" (f32): flash_fwd_f32_kernel keeps FFMA on the FP32 units, exact
//   f32 products as the CPU's: 256 threads, each a 4 x 4 tile of scores and
//   a 4 x D/16 tile of the output in registers, tiles widened in shared
//   memory.
//
// Numerics of all three, as the TPU kernel and plain_flash_fwd: f32
// scores, sums and accumulators; the probabilities are rounded to the
// input dtype before the P @ V product (bf16: by the repack; f32: a no-op).
// exp(s - m) is exp2(s log2(e) - m log2(e)).  Dropout, as in the TPU
// kernel: the running max m and sum l come from the undropped
// probabilities, a dropped probability is zeroed before its rounding and
// the P @ V product, the output is acc * (scale / l) with scale =
// 1 / (1 - rate), and lse = m + log l is unchanged.  The keep bit of (row,
// col) is Philox at the counter (bh * Tq + row) * Tk + col (philox.cuh),
// independent of the tiling and the route.
//
// Masking: keys at or past min(kv_len, Tk) get probability 0 and key tiles
// wholly past it are never loaded, so every tile the loop sees holds at
// least one valid key.  Query rows at or past Tq are zero-filled and not
// written.  Neither T needs padding by the caller.
#include <math.h>
#include <string.h>

#include "hopper.cuh"
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

// ---- bf16, route "wgmma": TMA + wgmma, warp-specialised -------------------

namespace hp = tethys::hopper;

constexpr int kWgBQ = 128;              // query rows per block
constexpr int kWgBK = 128;              // keys per tile
// Threads: a producer warpgroup, 2 consumers and, with dropout, a fourth
// warpgroup that draws keep bits beside the producer's.
template <bool kDropout>
__host__ __device__ constexpr int wg_threads() {
  return kDropout ? 512 : 384;
}
constexpr int kMaskWords = kWgBQ * kWgBK / 32;  // a tile's keep bits
constexpr int kMaskStages = 2;  // tiles of keep bits the drawers run ahead
constexpr int kPanelQ = kWgBQ * 128;    // one 64-column panel of the q tile
constexpr int kPanelK = kWgBK * 128;    // of a k or v tile
// Registers a thread.  setmaxnreg moves registers only among the block's
// own warps, and the launch gives each of 384 threads 65536 / 384 = 168
// (rounded down to 8), each of 512 threads 128; so a producer and two
// consumer warps hold at most 3 x 168, and with a drawing warp 4 x 128.
// Without dropout the producer only issues loads; with it, it and the
// drawing warpgroup run Philox (8 calls in flight a thread).
template <bool kDropout>
struct WgRegs {
  static constexpr int kProducer = kDropout ? 56 : 40;
  static constexpr int kConsumer = kDropout ? 200 : 232;
  static_assert(kDropout ? 2 * kProducer + 2 * kConsumer <= 4 * 128
                         : kProducer + 2 * kConsumer <= 3 * 168,
                "more registers than the block holds");
};

// Stages of the k / v ring: 3 where they fit beside the rest, so that the
// producer runs two tiles ahead.
template <int DMAX>
__host__ __device__ constexpr int wg_stages() {
  return DMAX == 64 ? 3 : 2;
}

template <int DMAX>
constexpr int wg_smem_bytes() {
  return 1024 + (DMAX / 64) * (kPanelQ + 2 * wg_stages<DMAX>() * kPanelK) +
         kMaskStages * kMaskWords * (int)sizeof(uint32_t) + 32 * 8;  // barriers
}

struct WgParams {
  CUtensorMap q, k, v, o;  // [BH, T, D] as (D, T, BH), boxes of 64 columns
  float* lse;
  int Tq, Tk, kv_len;
  uint32_t seed, threshold;
  float scale;
};

// The online softmax of one 64 x 128 tile of S in its accumulator layout
// (s[4 j + 2 h + c]: row g + 8 h of the warp's 16, key 8 j + 2 qd + c), in
// place: keys >= kv_end masked, m and l updated (l this thread's share of
// the undropped sum), alpha the factor of the sums so far, s the
// unnormalised probabilities.
__device__ __forceinline__ void wg_softmax(float* s, float* m, float* l,
                                           float* alpha, int k0, int kv_end,
                                           int qd) {
  if (k0 + kWgBK > kv_end) {
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (k0 + 8 * j + 2 * qd + (c & 1) >= kv_end) s[4 * j + c] = -INFINITY;
  }
  float mx[2] = {m[0], m[1]}, m2[2];
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    mx[0] = fmaxf(mx[0], fmaxf(s[4 * j], s[4 * j + 1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    alpha[h] = exp2f((m[h] - mx[h]) * kLog2e);  // 0 on the first tile
    m[h] = mx[h];
    m2[h] = mx[h] * kLog2e;
    l[h] *= alpha[h];
  }
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    s[i] = exp2f(fmaf(s[i], kLog2e, -m2[(i >> 1) & 1]));
    l[(i >> 1) & 1] += s[i];
  }
}

// P (in s), dropped where its keep bit is 0 and rounded to bf16, as the A
// fragments of P V (pa[t]: keys 16 t .. 16 t + 15).  keep[4 h + w]: row
// g + 8 h's keys 32 w .. 32 w + 31.
template <bool kDropout>
__device__ __forceinline__ void wg_pack_p(const float* s, uint32_t (*pa)[4],
                                          int qd, const uint32_t* keep) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    float p[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      p[c] = s[4 * j + c];
      if constexpr (kDropout) {
        const int bit = 8 * (j & 3) + 2 * qd + (c & 1);
        if (!((keep[4 * (c >> 1) + (j >> 2)] >> bit) & 1u)) p[c] = 0.f;
      }
    }
    pa[j >> 1][(j & 1) * 2] = tethys::pack_bf16x2(p[0], p[1]);
    pa[j >> 1][(j & 1) * 2 + 1] = tethys::pack_bf16x2(p[2], p[3]);
  }
}

// One drawing thread's share (thread t of kDrawers) of tile j's keep bits:
// word 4 r + h holds row r's keys 32 h .. 32 h + 31, as whole Philox
// counters along the keys (8 calls a word when Tk % 4 == 0).
template <int kDrawers>
__device__ __forceinline__ void wg_draw_mask(uint32_t* words, int t,
                                             uint64_t row0, int Tk, int k0,
                                             uint32_t seed,
                                             uint32_t threshold) {
#pragma unroll 1
  for (int w = t; w < kMaskWords; w += kDrawers)
    words[w] = tethys::keep_bits<32>(
        (row0 + (w >> 2)) * (uint64_t)Tk + (uint64_t)(k0 + 32 * (w & 3)),
        seed, threshold);
}

template <int DMAX, bool kDropout>
__global__ void __launch_bounds__(wg_threads<kDropout>(), 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ WgParams p) {
  constexpr int kPanels = DMAX / 64;
  constexpr int kOut = DMAX / 2;  // output accumulators a thread
  constexpr int kStages = wg_stages<DMAX>();
  extern __shared__ uint8_t smem_raw[];
  // 128-byte swizzled boxes and wgmma tiles need 1024-byte alignment.
  uint8_t* sQ = (uint8_t*)(((uintptr_t)smem_raw + 1023) & ~(uintptr_t)1023);
  uint8_t* sK = sQ + kPanels * kPanelQ;            // kStages stages
  uint8_t* sV = sK + kStages * kPanels * kPanelK;  // kStages stages
  // keep bits, kMaskStages stages: row r's keys 32 h .. 32 h + 31 in
  // word 4 r + h
  uint32_t* sMask = (uint32_t*)(sV + kStages * kPanels * kPanelK);
  uint64_t* bar = (uint64_t*)(sMask + kMaskStages * kMaskWords);
  uint64_t* q_full = bar;
  uint64_t* k_full = bar + 1;              // kStages each
  uint64_t* k_empty = k_full + kStages;
  uint64_t* v_full = k_empty + kStages;
  uint64_t* v_empty = v_full + kStages;
  uint64_t* m_full = v_empty + kStages;    // kMaskStages each
  uint64_t* m_empty = m_full + kMaskStages;

  const int bh = blockIdx.y, q0 = blockIdx.x * kWgBQ;
  const int kv_end = min(p.kv_len, p.Tk);
  const int n_tiles = (kv_end + kWgBK - 1) / kWgBK;
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    hp::mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      hp::mbar_init(&k_full[s], 1);
      hp::mbar_init(&k_empty[s], 256);  // every consumer thread
      hp::mbar_init(&v_full[s], 1);
      hp::mbar_init(&v_empty[s], 256);
    }
    for (int s = 0; s < kMaskStages; ++s) {
      hp::mbar_init(&m_full[s], 256);   // the drawing threads
      hp::mbar_init(&m_empty[s], 256);  // every consumer thread
    }
    hp::fence_barrier_init();
  }
  __syncthreads();

  using Regs = WgRegs<kDropout>;
  const uint64_t row0 = (uint64_t)bh * p.Tq + q0;  // the block's first row
  if (wg == 0 || wg == 3) {
    // Producer: thread 0 issues every load.  With dropout, warpgroups 0
    // and 3 draw each tile's keep bits while the consumers multiply (thread
    // 0 between its loads), two tiles ahead at most.
    hp::setmaxnreg_dec<Regs::kProducer>();
    const int t = threadIdx.x & 127, drawer = wg == 0 ? t : 128 + t;
    for (int j = 0; j < n_tiles; ++j) {
      if (threadIdx.x == 0) {
        const int s = j % kStages;
        const uint32_t ph = ((j / kStages) & 1) ^ 1;
        if (j == 0) {
          hp::mbar_arrive_expect_tx(q_full, kPanels * kPanelQ);
          for (int pn = 0; pn < kPanels; ++pn)
            hp::tma_load_3d(sQ + pn * kPanelQ, &p.q, q_full, 64 * pn, q0, bh);
        }
        hp::mbar_wait(&k_empty[s], ph);
        hp::mbar_arrive_expect_tx(&k_full[s], kPanels * kPanelK);
        for (int pn = 0; pn < kPanels; ++pn)
          hp::tma_load_3d(sK + (s * kPanels + pn) * kPanelK, &p.k, &k_full[s],
                          64 * pn, j * kWgBK, bh);
        hp::mbar_wait(&v_empty[s], ph);
        hp::mbar_arrive_expect_tx(&v_full[s], kPanels * kPanelK);
        for (int pn = 0; pn < kPanels; ++pn)
          hp::tma_load_3d(sV + (s * kPanels + pn) * kPanelK, &p.v, &v_full[s],
                          64 * pn, j * kWgBK, bh);
      }
      if constexpr (kDropout) {
        hp::mbar_wait(&m_empty[j % kMaskStages], ((j / kMaskStages) & 1) ^ 1);
        wg_draw_mask<256>(sMask + (j % kMaskStages) * kMaskWords, drawer, row0, p.Tk,
                          j * kWgBK, p.seed, p.threshold);
        hp::mbar_arrive(&m_full[j % kMaskStages]);
      } else if (threadIdx.x != 0) {
        break;
      }
    }
    return;
  }

  // Consumers: warpgroup cw owns rows 64 cw .. 64 cw + 63 of the block.
  hp::setmaxnreg_inc<Regs::kConsumer>();
  const int cw = wg - 1, ctid = threadIdx.x & 127;
  const int warp = ctid >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, qd = lane & 3;
  const int rows[2] = {64 * cw + 16 * warp + g, 64 * cw + 16 * warp + g + 8};

  float s_acc[64];
  float o_acc[kOut];
  uint32_t pa[8][4];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < kOut; ++i) o_acc[i] = 0.f;
  hp::fence_operands<kOut>(o_acc);

  // S = q k^T over d, the stage's k tile.
  auto s_product = [&](int st) {
    const uint8_t* kt = sK + st * kPanels * kPanelK;
    hp::wgmma_fence();
#pragma unroll
    for (int pn = 0; pn < kPanels; ++pn) {
      const uint64_t da = hp::desc_sw128(sQ + pn * kPanelQ + cw * (kPanelQ / 2));
      const uint64_t db = hp::desc_sw128(kt + pn * kPanelK);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hp::wgmma_ss_m64n128k16<0, 0>(s_acc, da + 2 * kk, db + 2 * kk,
                                      (pn | kk) != 0);
    }
    hp::wgmma_commit();
  };
  // O += P v over the stage's 128 keys: v read MN-major (d contiguous).
  auto pv_product = [&](int st) {
    const uint8_t* vt = sV + st * kPanels * kPanelK;
    hp::wgmma_fence();
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const uint64_t db = hp::desc_sw128_mn(vt + t * 2048, kPanelK);
      if constexpr (DMAX == 64)
        hp::wgmma_rs_m64n64k16<1>(o_acc, pa[t], db);
      else
        hp::wgmma_rs_m64n128k16<1>(o_acc, pa[t], db);
    }
    hp::wgmma_commit();
  };
  // This thread's keep words of tile j: rows[h], keys 32 w .. 32 w + 31.
  auto keep_words = [&](int j, uint32_t* keep) {
    if constexpr (kDropout) {
      hp::mbar_wait(&m_full[j % kMaskStages], (j / kMaskStages) & 1);
      const uint32_t* words = sMask + (j % kMaskStages) * kMaskWords;
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int w = 0; w < 4; ++w) keep[4 * h + w] = words[4 * rows[h] + w];
      hp::mbar_arrive(&m_empty[j % kMaskStages]);
    }
  };
  // Ping-pong: the warpgroups take turns to issue their products (named
  // barriers 6 and 7), so that one's softmax runs under the other's
  // products.  Warpgroup 0 goes first; each issue passes the turn on, but
  // warpgroup 1's last, which nobody waits for.
  const int n_issues = n_tiles + 1;
  int issue = 0;
  auto my_turn = [&]() { hp::named_barrier_sync(6 + cw, 256); };
  auto pass_turn = [&]() {
    if (++issue < n_issues || cw == 0) hp::named_barrier_arrive(7 - cw, 256);
  };
  if (cw == 1) hp::named_barrier_arrive(6, 256);

  uint32_t keep[8];
  float alpha[2];
  hp::mbar_wait(q_full, 0);
  hp::mbar_wait(&k_full[0], 0);
  my_turn();
  s_product(0);
  pass_turn();
  keep_words(0, keep);
  hp::wgmma_wait<0>();
  hp::fence_operands<64>(s_acc);
  hp::mbar_arrive(&k_empty[0]);
  wg_softmax(s_acc, m, l, alpha, 0, kv_end, qd);
  wg_pack_p<kDropout>(s_acc, pa, qd, keep);
  // Tile j's S product and tile j - 1's P v are in flight together; the
  // keep bits are drawn and the softmax of S runs under P v; P is repacked
  // and O rescaled once that is done, so no register of a product in
  // flight is written.
  for (int j = 1; j < n_tiles; ++j) {
    const int s = j % kStages, sp = (j - 1) % kStages;
    hp::mbar_wait(&k_full[s], (j / kStages) & 1);
    hp::mbar_wait(&v_full[sp], ((j - 1) / kStages) & 1);
    my_turn();
    s_product(s);
    pv_product(sp);
    pass_turn();
    keep_words(j, keep);
    hp::wgmma_wait<1>();
    hp::fence_operands<64>(s_acc);
    hp::mbar_arrive(&k_empty[s]);
    wg_softmax(s_acc, m, l, alpha, j * kWgBK, kv_end, qd);
    hp::wgmma_wait<0>();
    hp::fence_operands<kOut>(o_acc);
    hp::fence_operands_u32<32>(&pa[0][0]);
    hp::mbar_arrive(&v_empty[sp]);
#pragma unroll
    for (int n = 0; n < kOut / 4; ++n) {
      o_acc[4 * n] *= alpha[0];
      o_acc[4 * n + 1] *= alpha[0];
      o_acc[4 * n + 2] *= alpha[1];
      o_acc[4 * n + 3] *= alpha[1];
    }
    wg_pack_p<kDropout>(s_acc, pa, qd, keep);
  }
  {
    const int sl = (n_tiles - 1) % kStages;
    hp::mbar_wait(&v_full[sl], ((n_tiles - 1) / kStages) & 1);
    my_turn();
    pv_product(sl);
    pass_turn();
    hp::wgmma_wait<0>();
    hp::fence_operands<kOut>(o_acc);
    hp::fence_operands_u32<32>(&pa[0][0]);
  }

  // Epilogue: o = acc * (scale / l) rounded to bf16 into this warpgroup's
  // rows of the q tile (free now), 128-byte swizzled, then stored by TMA,
  // which clips rows past Tq and columns past D.
  float f[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    f[h] = p.scale / l[h];
    const int row = q0 + rows[h];
    if (qd == 0 && row < p.Tq) p.lse[(long long)bh * p.Tq + row] = m[h] + logf(l[h]);
  }
  uint8_t* sO = sQ + cw * (kPanelQ / 2);
#pragma unroll
  for (int n = 0; n < kOut / 4; ++n)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * warp + g + 8 * h;
      const int off = (n >> 3) * kPanelQ + r * 128 + (((n & 7) ^ (r & 7)) << 4) + 4 * qd;
      *reinterpret_cast<uint32_t*>(sO + off) = tethys::pack_bf16x2(
          o_acc[4 * n + 2 * h] * f[h], o_acc[4 * n + 2 * h + 1] * f[h]);
    }
  hp::fence_async_smem();
  hp::named_barrier_sync(2 + cw, 128);
  if (ctid == 0 && q0 + 64 * cw < p.Tq) {
    for (int pn = 0; pn < kPanels; ++pn)
      hp::tma_store_3d(&p.o, sO + pn * kPanelQ, 64 * pn, q0 + 64 * cw, bh);
    hp::bulk_commit();
    hp::bulk_wait<0>();
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
int launch_wgmma(const void* q, const void* k, const void* v, void* o,
                 void* lse, int BH, int Tq, int Tk, int D, int kv_len,
                 uint32_t seed, uint32_t threshold, float scale,
                 cudaStream_t stream) {
  WgParams p;
  memset(&p, 0, sizeof p);
  const cuuint64_t e = 2;  // bytes a bf16
  const cuuint64_t q_dims[3] = {(cuuint64_t)D, (cuuint64_t)Tq, (cuuint64_t)BH};
  const cuuint64_t k_dims[3] = {(cuuint64_t)D, (cuuint64_t)Tk, (cuuint64_t)BH};
  const cuuint64_t q_strides[2] = {D * e, (cuuint64_t)Tq * D * e};
  const cuuint64_t k_strides[2] = {D * e, (cuuint64_t)Tk * D * e};
  const cuuint32_t q_box[3] = {64, kWgBQ, 1}, k_box[3] = {64, kWgBK, 1};
  const cuuint32_t o_box[3] = {64, kWgBQ / 2, 1};
  int err = hp::encode_bf16_map(&p.q, q, 3, q_dims, q_strides, q_box);
  if (!err) err = hp::encode_bf16_map(&p.k, k, 3, k_dims, k_strides, k_box);
  if (!err) err = hp::encode_bf16_map(&p.v, v, 3, k_dims, k_strides, k_box);
  if (!err) err = hp::encode_bf16_map(&p.o, o, 3, q_dims, q_strides, o_box);
  if (err) return err;
  p.lse = (float*)lse;
  p.Tq = Tq;
  p.Tk = Tk;
  p.kv_len = kv_len;
  p.seed = seed;
  p.threshold = threshold;
  p.scale = scale;
  const int smem = wg_smem_bytes<DMAX>();
  const auto kernel = flash_fwd_wgmma_kernel<DMAX, kDropout>;
  cudaError_t cerr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (cerr != cudaSuccess) return (int)cerr;
  const dim3 grid((Tq + kWgBQ - 1) / kWgBQ, BH);
  kernel<<<grid, wg_threads<kDropout>(), smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// Route codes; ops/flash_attention.py's ROUTES in this order.
enum Route { kFfma = 0, kMma = 1, kWgmma = 2 };

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
             uint32_t seed, uint32_t threshold, float scale, int route,
             void* stream) {
  if (BH <= 0 || BH > 65535 || Tq <= 0 || Tk <= 0 || D <= 0 || D > 128 ||
      kv_len <= 0 || (route == kFfma) == (is_bf16 != 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (route) {
    case kFfma:
      if (D <= 64)
        return launch_f32<64, kDropout>(q, k, v, o, lse, BH, Tq, Tk, D,
                                        kv_len, seed, threshold, scale, s);
      return launch_f32<128, kDropout>(q, k, v, o, lse, BH, Tq, Tk, D, kv_len,
                                       seed, threshold, scale, s);
    case kMma:
      if (D <= 64)
        return dispatch_bf16<64, kDropout>(q, k, v, o, lse, BH, Tq, Tk, D,
                                           kv_len, seed, threshold, scale, s);
      return dispatch_bf16<128, kDropout>(q, k, v, o, lse, BH, Tq, Tk, D,
                                          kv_len, seed, threshold, scale, s);
    case kWgmma:
      // TMA needs 16-byte aligned bases and row strides (D % 8), wgmma
      // 16-deep steps over d.
      if (D % 16 || !aligned16(q) || !aligned16(k) || !aligned16(v) ||
          !aligned16(o))
        return (int)cudaErrorInvalidValue;
      if (D <= 64)
        return launch_wgmma<64, kDropout>(q, k, v, o, lse, BH, Tq, Tk, D,
                                          kv_len, seed, threshold, scale, s);
      return launch_wgmma<128, kDropout>(q, k, v, o, lse, BH, Tq, Tk, D,
                                         kv_len, seed, threshold, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q [BH, Tq, D], k and v [BH, Tk, D], all f32 (is_bf16 = 0) or bf16, all
// contiguous -> o [BH, Tq, D] in the same dtype, lse [BH, Tq] f32.
// 1 <= D <= 128, kv_len >= 1; BH <= 65535.  route: a Route code (ffma for
// f32; mma or, with D % 16 == 0 and 16-byte aligned bases, wgmma for
// bf16); a route that does not take the operands returns an error.
TETHYS_EXPORT int tethys_flash_fwd(const void* q, const void* k,
                                   const void* v, void* o, void* lse, int BH,
                                   int Tq, int Tk, int D, int kv_len,
                                   int is_bf16, int route, void* stream) {
  return dispatch<false>(q, k, v, o, lse, BH, Tq, Tk, D, kv_len, is_bf16, 0u,
                         0u, 1.f, route, stream);
}

// The same with attention dropout: keep = Philox bits >= threshold
// (threshold = uint32(rate * 2^32)), scale = 1 / (1 - rate), both as the
// wrapper computes them.
TETHYS_EXPORT int tethys_flash_fwd_dropout(const void* q, const void* k,
                                           const void* v, void* o, void* lse,
                                           int BH, int Tq, int Tk, int D,
                                           int kv_len, int is_bf16,
                                           uint32_t seed, uint32_t threshold,
                                           float scale, int route,
                                           void* stream) {
  return dispatch<true>(q, k, v, o, lse, BH, Tq, Tk, D, kv_len, is_bf16, seed,
                        threshold, scale, route, stream);
}
