// Projections fused with the head split and the head merge.
//
// tethys_proj_split replaces tethys_tpu/ops/pallas_qkv.py::_proj_split_kernel
// (launched by _project_split_call, via project_split): for up to three
// matrices W_z [N, K] (torch's Linear layout) it computes
//   y = x @ W_z^T (f32 sum) -> rounded to the compute dtype -> + b_z, rounded
//     -> * scale_z, rounded,
// and writes y[b, t, n] straight to out_z[b, n / d, t, n % d], so the
// [B, T, N] projection never exists in device memory.
//
// tethys_merge_proj replaces pallas_qkv.py::_merge_proj_kernel (launched by
// _merge_project_call, via merge_project): the same product with its left
// operand gathered from attn[b, k / d, t, k % d], then rounded, then + b and
// rounded, written to out [B, T, N].
//
// One GEMM, both operands K-contiguous ("TN"), M = B * T rows.  The caller
// picks one of four routes by shape (ops/qkv.py: proj_route) and passes its
// code; a route that cannot take the operands returns an error, and no
// route falls back to another.
//
// "wgmma" (bf16; M > 64, K, N and d multiples of 64, 16-byte aligned
// operands): the encoder's and the cross-KV precompute's shapes, where the
// operations bound it (2 M N K a matrix: 24000 x 512 x 512 x 3 at
// whisper-base b16) and the bytes nearly do (x read once, 3 outputs
// written).  With K only 512 a tile has 8 K slices, so its epilogue
// (128 x 256 outputs rounded, staged and stored) weighs nearly as much as
// its products.  A
// persistent kernel, one block an SM, walks 128 x 256 output tiles in (M
// tile, matrix, N tile) order, so the blocks in flight share their x rows
// in L2.  A producer warp streams 64-deep K slices of x and W through a
// 3-stage ring in shared memory by TMA (128-byte swizzle), with full/empty
// mbarriers; two consumer warpgroups (setmaxnreg moves registers to them)
// each multiply 64 rows by wgmma m64n256k16 with f32 sums, one
// slice's products in flight behind the next.  The head layouts are TMA
// boxes: an M tile holds nb batches of tb time steps (tb = min(T, 128), nb
// = 128 / tb), so it never crosses a batch mid-way; merge_proj's A slice
// is the box attn[b0:b0+nb, k0 / d, t0:t0+tb, k0 % d : +64] of a 4-D map,
// and proj_split's epilogue stores each 64-column chunk as the box
// out_z[b0:b0+nb, n / d, t0:t0+tb, n % d : +64].  TMA zero-fills reads past
// T, B and N and clips the stores there.  The epilogue rounds in the
// Pallas kernel's order, two columns at a time in bf16x2, with the tile's
// bias read from memory before the products and staged in shared memory,
// into a swizzled staging tile that one thread stores by TMA while the next
// tile's loads are already in flight.
//
// "stream" (bf16; M <= 64, the same alignment): decode steps and the cross
// q projection, where reading W bounds it (3 x 512 x 512 bf16 = 1.5 MB at
// whisper-base, 0.5 us of HBM) and launch latency sets the time.  Each
// block owns 16 columns of one matrix and a K chunk, copies its W slab and
// the x rows of the chunk into shared memory with cp.async all at once (the
// whole read in flight), and 4 warps multiply the 16-row tiles by mma.sync
// m16n8k16 (M = 16 fills one tile).  Where the columns make too few blocks
// for 132 SMs (one 512-wide matrix: 32), a thread-block cluster of up to 8
// blocks splits K; the f32 partial sums meet through distributed shared
// memory in rank order before the one epilogue, so each output is rounded
// once, as the Pallas kernel rounds it.
//
// "mma" (bf16, any shape): the other bf16 shapes (d, K or N not multiples
// of 64, misaligned views).  64 x 64 output tiles over (N, M) and
// gridDim.z over the matrices, 4 warps each a 32 x 32 quarter as 2 x 4
// mma.sync m16n8k16 products, 32-deep K slices staged through shared memory
// (rows padded to 80 bytes), 16-byte loads where K (and d for the merge's
// gather) is a multiple of 8 and the pointers are aligned, else 2-byte
// loads; the head gather and scatter are index arithmetic.
//
// "ffma" (f32): exact f32 products, as on the CPU (no TF32, which would
// break the f32 serving gates): 256 threads each hold a 4 x 4 block of FFMA
// sums over 16-deep f32 slices of a 64 x 64 tile.
#include <cooperative_groups.h>
#include <string.h>

#include "hopper.cuh"

namespace {

constexpr int kBM = 64, kBN = 64, kBK = 16, kThreads = 256;

struct Mats {
  const void* w[3];
  const void* bias[3];
  void* out[3];
  float scale[3];
};

// Row m of the left operand, column k: x[m, k], or for the merge's gather
// attn[b, k / d, t, k % d] with m = b * seq + t.
template <bool kGather>
__device__ __forceinline__ long long a_offset(int m, int k, int K, int seq,
                                              int heads, int hd) {
  if (!kGather) return (long long)m * K + k;
  const int b = m / seq, t = m - b * seq, h = k / hd, c = k - h * hd;
  return (((long long)b * heads + h) * seq + t) * hd + c;
}

// The epilogue of one output: round the f32 sum to T, + bias, round,
// * scale, round; written to out_z[b, n / d, t, n % d] (kSplit) or
// out[m, n].
template <typename T, bool kSplit>
__device__ __forceinline__ void store_out(const Mats& mats, int z, int m,
                                          int n, float acc, int N, int seq,
                                          int heads, int hd) {
  float y = tethys::round_to<T>(acc);
  y = tethys::round_to<T>(y + tethys::to_f32<T>(((const T*)mats.bias[z])[n]));
  y *= mats.scale[z];
  long long off;
  if (kSplit) {
    const int b = m / seq, t = m - b * seq, h = n / hd, c = n - h * hd;
    off = (((long long)b * heads + h) * seq + t) * hd + c;
  } else {
    off = (long long)m * N + n;
  }
  ((T*)mats.out[z])[off] = tethys::from_f32<T>(y);
}

// kGather: A is attn [B, H, T, d] read as [B * T, H * d] (merge_proj); else
// A is x [B * T, K].  kSplit: out is [B, N / d, T, d] (proj_split); else
// [B * T, N].  The f32 kernel.
template <typename T, bool kGather, bool kSplit>
__global__ void __launch_bounds__(kThreads)
    proj_kernel(const T* __restrict__ a, Mats mats, int M, int N, int K,
                int seq, int heads, int hd) {
  __shared__ float s_a[kBK][kBM + 1];
  __shared__ float s_b[kBK][kBN + 1];
  const int z = blockIdx.z;
  const T* __restrict__ w = (const T*)mats.w[z];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;

  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += kBK) {
#pragma unroll
    for (int i = 0; i < kBM * kBK / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      const int row = idx / kBK, col = idx % kBK;
      const int m = m0 + row, n = n0 + row, k = k0 + col;
      float av = 0.f, bv = 0.f;
      if (m < M && k < K)
        av = tethys::to_f32<T>(a[a_offset<kGather>(m, k, K, seq, heads, hd)]);
      if (n < N && k < K) bv = tethys::to_f32<T>(w[(long long)n * K + k]);
      s_a[col][row] = av;
      s_b[col][row] = bv;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float ar[4], br[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ar[i] = s_a[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) br[j] = s_b[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < N)
        store_out<T, kSplit>(mats, z, m, n, acc[i][j], N, seq, heads, hd);
    }
  }
}

// ---- bf16, route "mma": mma.sync on 64 x 64 tiles, any shape -------------

constexpr int kMmaThreads = 128, kMmaBK = 32, kLd = kMmaBK + 8;
using bf16 = __nv_bfloat16;

// VEC consecutive bf16 of row r (of rows, K long) from column k, zeros past
// the edges, stored at dst.  VEC 8: one 16-byte load (K % 8 == 0, aligned).
template <int VEC>
__device__ __forceinline__ void load_vec(bf16* dst, const bf16* src,
                                         bool row_ok, int k, int K) {
  if (VEC == 8) {
    uint4 v = make_uint4(0, 0, 0, 0);
    if (row_ok && k < K) v = *reinterpret_cast<const uint4*>(src);
    *reinterpret_cast<uint4*>(dst) = v;
  } else {
    *dst = (row_ok && k < K) ? *src : __float2bfloat16_rn(0.f);
  }
}

__device__ __forceinline__ uint32_t ld_pair(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <int VEC, bool kGather, bool kSplit>
__global__ void __launch_bounds__(kMmaThreads)
    proj_mma_kernel(const bf16* __restrict__ a, Mats mats, int M, int N,
                    int K, int seq, int heads, int hd) {
  __shared__ __align__(16) bf16 s_a[kBM][kLd];
  __shared__ __align__(16) bf16 s_b[kBN][kLd];
  const int z = blockIdx.z;
  const bf16* __restrict__ w = (const bf16*)mats.w[z];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tg = lane & 3;          // mma fragment coordinates
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;

  float acc[2][4][4] = {};
  for (int k0 = 0; k0 < K; k0 += kMmaBK) {
    constexpr int kPerRow = kMmaBK / VEC;
    for (int i = tid; i < kBM * kPerRow; i += kMmaThreads) {
      const int row = i / kPerRow, kv = (i % kPerRow) * VEC, k = k0 + kv;
      const int m = m0 + row, n = n0 + row;
      load_vec<VEC>(&s_a[row][kv],
                    a + (m < M && k < K
                             ? a_offset<kGather>(m, k, K, seq, heads, hd) : 0),
                    m < M, k, K);
      load_vec<VEC>(&s_b[row][kv], w + (n < N ? (long long)n * K + k : 0),
                    n < N, k, K);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kMmaBK; kk += 16) {
      uint32_t af[2][4], bfr[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = wm + 16 * i + g;
        af[i][0] = ld_pair(&s_a[r][kk + 2 * tg]);
        af[i][1] = ld_pair(&s_a[r + 8][kk + 2 * tg]);
        af[i][2] = ld_pair(&s_a[r][kk + 8 + 2 * tg]);
        af[i][3] = ld_pair(&s_a[r + 8][kk + 8 + 2 * tg]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = wn + 8 * j + g;
        bfr[j][0] = ld_pair(&s_b[c][kk + 2 * tg]);
        bfr[j][1] = ld_pair(&s_b[c][kk + 8 + 2 * tg]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) tethys::mma_bf16(acc[i][j], af[i], bfr[j]);
    }
    __syncthreads();
  }

  // acc[i][j][2 * r + c] is the sum of row g + 8 r, column 2 tg + c of the
  // (i, j) 16 x 8 product.
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int m = m0 + wm + 16 * i + g + 8 * r;
          const int n = n0 + wn + 8 * j + 2 * tg + c;
          if (m < M && n < N)
            store_out<bf16, kSplit>(mats, z, m, n, acc[i][j][2 * r + c], N,
                                    seq, heads, hd);
        }
}

bool aligned16(const void* p) { return (uintptr_t)p % 16 == 0; }

// ---- bf16, route "wgmma": persistent, warp-specialised, TMA + wgmma -------

namespace hp = tethys::hopper;

constexpr int kWgBM = 128, kWgBN = 256, kWgBK = 64, kWgStages = 3;
constexpr int kWgThreads = 384;                  // 1 producer + 2 consumer WGs
constexpr int kASlice = kWgBM * kWgBK * 2;       // 16 KB
constexpr int kBSlice = kWgBN * kWgBK * 2;       // 32 KB
constexpr int kChunkBytes = kWgBM * 64 * 2;      // 64 output columns, 16 KB
constexpr int kChunks = kWgBN / 64;
constexpr int kWgSmem = 1024 + kWgStages * (kASlice + kBSlice) +
                        kChunks * kChunkBytes + kWgBN * 2 +
                        2 * kWgStages * 8;

struct WgParams {
  CUtensorMap a;       // x [B, T, K] as (K, T, B); attn [B, H, T, d] as (d, T, H, B)
  CUtensorMap w[3];    // W_z [N, K] as (K, N)
  CUtensorMap out[3];  // out_z [B, H, T, d] as (d, T, H, B); out [B, T, N] as (N, T, B)
  const bf16* bias[3];
  float scale[3];
  int n_mats, N, K, hd;
  int tb, nb;          // an M tile: nb batches of tb time steps
  int t_tiles;         // M tiles along T
  int m_tiles;         // ceil(B / nb) * t_tiles
  int n_tiles;         // ceil(N / 256)
  uint32_t a_bytes;    // one A box
};

struct TileCoord {
  int z, n0, b0, t0;
};

__device__ __forceinline__ TileCoord tile_coord(const WgParams& p, int tile) {
  const int per_m = p.n_mats * p.n_tiles;
  const int mt = tile / per_m, rest = tile - mt * per_m;
  const int z = rest / p.n_tiles, nt = rest - z * p.n_tiles;
  const int bg = mt / p.t_tiles, tt = mt - bg * p.t_tiles;
  return {z, nt * kWgBN, bg * p.nb, tt * p.tb};
}

// The Pallas kernel's epilogue for two neighbouring columns: round the f32
// sums, + bias rounded (one bf16x2 add rounds the exact sum), * scale in
// f32, rounded.
__device__ __forceinline__ uint32_t epilogue(float acc0, float acc1,
                                             __nv_bfloat162 bias,
                                             float scale) {
  const __nv_bfloat162 y = __hadd2(__floats2bfloat162_rn(acc0, acc1), bias);
  if (scale == 1.f) return *reinterpret_cast<const uint32_t*>(&y);
  const float2 f = __bfloat1622float2(y);
  return tethys::pack_bf16x2(f.x * scale, f.y * scale);
}

template <bool kGather, bool kSplit>
__global__ void __launch_bounds__(kWgThreads, 1)
    proj_wgmma_kernel(const __grid_constant__ WgParams p) {
  extern __shared__ uint8_t smem_raw[];
  // 128-byte swizzled TMA boxes and wgmma tiles need 1024-byte alignment.
  uint8_t* s_a = (uint8_t*)(((uintptr_t)smem_raw + 1023) & ~(uintptr_t)1023);
  uint8_t* s_b = s_a + kWgStages * kASlice;
  uint8_t* s_out = s_b + kWgStages * kBSlice;
  uint32_t* s_bias = (uint32_t*)(s_out + kChunks * kChunkBytes);
  uint64_t* full = (uint64_t*)(s_bias + kWgBN / 2);
  uint64_t* empty = full + kWgStages;
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kWgStages; ++s) {
      hp::mbar_init(&full[s], 1);
      hp::mbar_init(&empty[s], 256);  // every consumer thread
    }
    hp::fence_barrier_init();
  }
  __syncthreads();
  const int tiles = p.m_tiles * p.n_mats * p.n_tiles;
  const int k_slices = p.K / kWgBK;

  if (wg == 0) {
    // Producer: one thread keeps the ring full, across tile boundaries.
    hp::setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const TileCoord c = tile_coord(p, tile);
        for (int ks = 0; ks < k_slices; ++ks, ++it) {
          const int s = it % kWgStages;
          hp::mbar_wait(&empty[s], ((it / kWgStages) & 1) ^ 1);
          hp::mbar_arrive_expect_tx(&full[s], p.a_bytes + kBSlice);
          const int k0 = ks * kWgBK;
          if constexpr (kGather)
            hp::tma_load_4d(s_a + s * kASlice, &p.a, &full[s], k0 % p.hd,
                            c.t0, k0 / p.hd, c.b0);
          else
            hp::tma_load_3d(s_a + s * kASlice, &p.a, &full[s], k0, c.t0,
                            c.b0);
          hp::tma_load_2d(s_b + s * kBSlice, &p.w[c.z], &full[s], k0, c.n0);
        }
      }
    }
    return;
  }

  // Consumers: warpgroup cw owns rows 64 cw .. 64 cw + 63 of each tile.
  hp::setmaxnreg_inc<232>();
  const int ctid = threadIdx.x - 128, cw = wg - 1;
  const int warp = (threadIdx.x / 32) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const TileCoord c = tile_coord(p, tile);
    // The tile's bias, two columns a thread, read now and staged in shared
    // memory at the epilogue: its latency hides behind the products.
    uint32_t bias2 = 0;
    if (ctid < kWgBN / 2 && c.n0 + 2 * ctid < p.N)
      bias2 = *reinterpret_cast<const uint32_t*>(p.bias[c.z] + c.n0 + 2 * ctid);
    float acc[kWgBN / 2];
#pragma unroll
    for (int i = 0; i < kWgBN / 2; ++i) acc[i] = 0.f;
    hp::fence_operands<kWgBN / 2>(acc);
    int prev = -1;
    for (int ks = 0; ks < k_slices; ++ks, ++it) {
      const int s = it % kWgStages;
      hp::mbar_wait(&full[s], (it / kWgStages) & 1);
      const uint64_t da =
          hp::desc_sw128(s_a + s * kASlice + cw * (kASlice / 2));
      const uint64_t db = hp::desc_sw128(s_b + s * kBSlice);
      hp::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kWgBK / 16; ++kk)
        hp::wgmma_m64n256k16(acc, da + 2 * kk, db + 2 * kk);
      hp::wgmma_commit();
      // The previous slice's products are done: hand its stage back.
      hp::wgmma_wait<1>();
      if (prev >= 0) hp::mbar_arrive(&empty[prev]);
      prev = s;
    }
    hp::wgmma_wait<0>();
    hp::fence_operands<kWgBN / 2>(acc);
    hp::mbar_arrive(&empty[prev]);

    // Epilogue: the staging tile is free once the last tile's stores have
    // read it.  Element (r, col) of 64-column chunk col / 64 sits at row r
    // (128 bytes), 16-byte group (col % 64) / 8 XOR r % 8, as TMA's 128-byte
    // swizzle expects.
    const float scale = p.scale[c.z];
    if (ctid < kWgBN / 2) s_bias[ctid] = bias2;
    if (ctid == 0) hp::bulk_wait_read<0>();
    hp::named_barrier_sync(1, 256);
#pragma unroll
    for (int j = 0; j < kWgBN / 8; ++j) {
      const __nv_bfloat162 bias =
          *reinterpret_cast<const __nv_bfloat162*>(&s_bias[4 * j + q]);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = cw * 64 + warp * 16 + g + 8 * h;
        const int off = (j >> 3) * kChunkBytes + r * 128 +
                        (((j & 7) ^ (r & 7)) << 4) + q * 4;
        *reinterpret_cast<uint32_t*>(s_out + off) = epilogue(
            acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1], bias, scale);
      }
    }
    hp::fence_async_smem();
    hp::named_barrier_sync(1, 256);
    if (ctid == 0) {
      for (int h = 0; h < kChunks; ++h) {
        const int n = c.n0 + 64 * h;
        if (n >= p.N) break;
        if constexpr (kSplit)
          hp::tma_store_4d(&p.out[c.z], s_out + h * kChunkBytes, n % p.hd,
                           c.t0, n / p.hd, c.b0);
        else
          hp::tma_store_3d(&p.out[c.z], s_out + h * kChunkBytes, n, c.t0,
                           c.b0);
      }
      hp::bulk_commit();
    }
  }
  if (ctid == 0) hp::bulk_wait<0>();
}

template <bool kGather, bool kSplit>
int launch_wgmma(const void* a, const Mats& mats, int n_mats, int B, int T,
                 int K, int N, int hd, cudaStream_t stream) {
  WgParams p;
  memset(&p, 0, sizeof p);
  const int tb = T < kWgBM ? T : kWgBM, nb = kWgBM / tb;
  p.n_mats = n_mats;
  p.N = N;
  p.K = K;
  p.hd = hd;
  p.tb = tb;
  p.nb = nb;
  p.t_tiles = (T + tb - 1) / tb;
  p.m_tiles = (B + nb - 1) / nb * p.t_tiles;
  p.n_tiles = (N + kWgBN - 1) / kWgBN;
  p.a_bytes = 64 * tb * nb * 2;
  const cuuint64_t e = 2;  // bytes a bf16
  const cuuint32_t b_tb = tb, b_nb = nb;
  int err;
  if (kGather) {
    const int H = K / hd;
    const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)T, (cuuint64_t)H,
                                (cuuint64_t)B};
    const cuuint64_t strides[3] = {hd * e, T * hd * e, (cuuint64_t)H * T * hd * e};
    const cuuint32_t box[4] = {64, b_tb, 1, b_nb};
    err = hp::encode_bf16_map(&p.a, a, 4, dims, strides, box);
  } else {
    const cuuint64_t dims[3] = {(cuuint64_t)K, (cuuint64_t)T, (cuuint64_t)B};
    const cuuint64_t strides[2] = {K * e, (cuuint64_t)T * K * e};
    const cuuint32_t box[3] = {64, b_tb, b_nb};
    err = hp::encode_bf16_map(&p.a, a, 3, dims, strides, box);
  }
  for (int z = 0; z < n_mats && !err; ++z) {
    const cuuint64_t w_dims[2] = {(cuuint64_t)K, (cuuint64_t)N};
    const cuuint64_t w_strides[1] = {K * e};
    const cuuint32_t w_box[2] = {64, kWgBN};
    err = hp::encode_bf16_map(&p.w[z], mats.w[z], 2, w_dims, w_strides, w_box);
    if (err) break;
    if (kSplit) {
      const int H = N / hd;
      const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)T,
                                  (cuuint64_t)H, (cuuint64_t)B};
      const cuuint64_t strides[3] = {hd * e, T * hd * e,
                                     (cuuint64_t)H * T * hd * e};
      const cuuint32_t box[4] = {64, b_tb, 1, b_nb};
      err = hp::encode_bf16_map(&p.out[z], mats.out[z], 4, dims, strides, box);
    } else {
      const cuuint64_t dims[3] = {(cuuint64_t)N, (cuuint64_t)T, (cuuint64_t)B};
      const cuuint64_t strides[2] = {N * e, (cuuint64_t)T * N * e};
      const cuuint32_t box[3] = {64, b_tb, b_nb};
      err = hp::encode_bf16_map(&p.out[z], mats.out[z], 3, dims, strides, box);
    }
    p.bias[z] = (const bf16*)mats.bias[z];
    p.scale[z] = mats.scale[z];
  }
  if (err) return err;
  const auto kernel = proj_wgmma_kernel<kGather, kSplit>;
  cudaError_t cerr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kWgSmem);
  if (cerr != cudaSuccess) return (int)cerr;
  const long long tiles = (long long)p.m_tiles * n_mats * p.n_tiles;
  const int sms = tethys::sm_count();
  const int grid = (int)(tiles < sms ? tiles : sms);
  kernel<<<grid, kWgThreads, kWgSmem, stream>>>(p);
  return (int)cudaGetLastError();
}

// ---- bf16, route "stream": M <= 64, one pass over W -----------------------

constexpr int kStThreads = 128, kStBN = 16, kStMaxM = 64, kStMaxCluster = 8;
constexpr int kStSmemMax = 232448;  // an H100 block's shared memory

// Shared memory of one block: x rows [m_pad][k_chunk + 8], its W slab
// [16][k_chunk + 8] (rows padded by 16 bytes: the fragment loads of a warp
// hit 32 banks), and the 4 warps' partial sums [4][m_pad][16] f32.
int stream_smem(int m_pad, int k_chunk) {
  return (m_pad + kStBN) * (k_chunk + 8) * 2 + 4 * m_pad * kStBN * 4;
}

template <bool kGather, bool kSplit>
__global__ void __launch_bounds__(kStThreads)
    proj_stream_kernel(const bf16* __restrict__ a, Mats mats, int M, int N,
                       int K, int seq, int heads, int hd, int k_chunk) {
  namespace cg = cooperative_groups;
  extern __shared__ __align__(16) uint8_t smem_st[];
  const cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int per_mat = N / kStBN, tile = blockIdx.x / cs;
  const int z = tile / per_mat, n0 = (tile - z * per_mat) * kStBN;
  const int k0 = rank * k_chunk, m_pad = (M + 15) & ~15, ld = k_chunk + 8;
  bf16* s_x = (bf16*)smem_st;
  bf16* s_w = s_x + m_pad * ld;
  float* s_red = (float*)(s_w + kStBN * ld);
  const bf16* __restrict__ w = (const bf16*)mats.w[z];
  const int tid = threadIdx.x, chunks = k_chunk / 8;

  // The block's whole share of W and x in flight at once (16-byte copies;
  // x rows past M read as zeros).
  for (int i = tid; i < kStBN * chunks; i += kStThreads) {
    const int r = i / chunks, col = (i - r * chunks) * 8;
    tethys::cp_async16(s_w + r * ld + col,
                       w + (long long)(n0 + r) * K + k0 + col, true);
  }
  for (int i = tid; i < m_pad * chunks; i += kStThreads) {
    const int r = i / chunks, col = (i - r * chunks) * 8;
    const bool ok = r < M;
    tethys::cp_async16(
        s_x + r * ld + col,
        ok ? a + a_offset<kGather>(r, k0 + col, K, seq, heads, hd) : a, ok);
  }
  tethys::cp_async_commit();
  tethys::cp_async_wait<0>();
  __syncthreads();

  // Warp w takes the 16-deep steps w, w + 4, ... of the chunk.
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, q = lane & 3;
  const int m_tiles = m_pad / 16;
  float acc[4][2][4] = {};
  for (int kk = 16 * warp; kk < k_chunk; kk += 64) {
    uint32_t bfr[2][2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const bf16* wr = s_w + (8 * j + g) * ld + kk + 2 * q;
      bfr[j][0] = ld_pair(wr);
      bfr[j][1] = ld_pair(wr + 8);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (i >= m_tiles) break;
      const bf16* xr = s_x + (16 * i + g) * ld + kk + 2 * q;
      const uint32_t af[4] = {ld_pair(xr), ld_pair(xr + 8 * ld),
                              ld_pair(xr + 8), ld_pair(xr + 8 * ld + 8)};
#pragma unroll
      for (int j = 0; j < 2; ++j) tethys::mma_bf16(acc[i][j], af, bfr[j]);
    }
  }

  // The 4 warps' sums, then the cluster's, each in a fixed order.
  const int n_out = m_pad * kStBN;
  float* mine = s_red + warp * n_out;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (i >= m_tiles) break;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          mine[(16 * i + g + 8 * h) * kStBN + 8 * j + 2 * q + c] =
              acc[i][j][2 * h + c];
  }
  __syncthreads();
  for (int e = tid; e < n_out; e += kStThreads)
    s_red[e] = ((s_red[e] + s_red[n_out + e]) + s_red[2 * n_out + e]) +
               s_red[3 * n_out + e];
  cluster.sync();
  if (rank == 0) {
    for (int e = tid; e < n_out; e += kStThreads) {
      const int m = e / kStBN;
      if (m >= M) continue;
      float sum = s_red[e];
      for (int r = 1; r < cs; ++r) sum += cluster.map_shared_rank(s_red, r)[e];
      store_out<bf16, kSplit>(mats, z, m, n0 + e % kStBN, sum, N, seq, heads,
                              hd);
    }
  }
  cluster.sync();  // the other ranks' shared memory stays until rank 0 read it
}

template <bool kGather, bool kSplit>
int launch_stream(const void* a, const Mats& mats, int n_mats, int M, int N,
                  int K, int seq, int heads, int hd, cudaStream_t stream) {
  if (M > kStMaxM || N % kStBN || K % 64) return (int)cudaErrorInvalidValue;
  const int tiles = n_mats * (N / kStBN), m_pad = (M + 15) & ~15;
  const int sms = tethys::sm_count();
  // Split K over a cluster until the blocks cover the SMs (or the chunk
  // fits in shared memory), keeping whole 64-deep slices a block.
  int cs = 1;
  while (cs < kStMaxCluster && (K / 64) % (2 * cs) == 0 &&
         (tiles * cs < sms || stream_smem(m_pad, K / cs) > kStSmemMax))
    cs *= 2;
  const int k_chunk = K / cs, smem = stream_smem(m_pad, k_chunk);
  if (smem > kStSmemMax) return (int)cudaErrorInvalidValue;
  const auto kernel = proj_stream_kernel<kGather, kSplit>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles * cs);
  cfg.blockDim = dim3(kStThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, (const bf16*)a, mats, M, N, K, seq,
                           heads, hd, k_chunk);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// ---- dispatch --------------------------------------------------------------

// Route codes, as ops/qkv.py: ROUTES.
enum Route { kFfma = 0, kMma = 1, kWgmma = 2, kStream = 3 };

template <typename T, bool kGather, bool kSplit>
int launch(const void* a, const Mats& mats, int n_mats, int M, int N, int K,
           int seq, int heads, int hd, cudaStream_t stream) {
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, n_mats);
  if (grid.y > 65535) return (int)cudaErrorInvalidConfiguration;
  if constexpr (sizeof(T) == 4) {
    proj_kernel<T, kGather, kSplit><<<grid, kThreads, 0, stream>>>(
        (const T*)a, mats, M, N, K, seq, heads, hd);
  } else {
    bool vec8 = K % 8 == 0 && (!kGather || hd % 8 == 0) && aligned16(a);
    for (int z = 0; z < n_mats; ++z) vec8 = vec8 && aligned16(mats.w[z]);
    if (vec8)
      proj_mma_kernel<8, kGather, kSplit><<<grid, kMmaThreads, 0, stream>>>(
          (const bf16*)a, mats, M, N, K, seq, heads, hd);
    else
      proj_mma_kernel<1, kGather, kSplit><<<grid, kMmaThreads, 0, stream>>>(
          (const bf16*)a, mats, M, N, K, seq, heads, hd);
  }
  return (int)cudaGetLastError();
}

// Whether the "wgmma" and "stream" routes take these operands: K, N and
// the head dim multiples of 64, every pointer 16-byte aligned.
bool hopper_ok(const void* a, const Mats& mats, int n_mats, int K, int N,
               int hd) {
  if (K % 64 || N % 64 || hd % 64 || !aligned16(a)) return false;
  for (int z = 0; z < n_mats; ++z)
    if (!aligned16(mats.w[z]) || !aligned16(mats.bias[z]) ||
        !aligned16(mats.out[z]))
      return false;
  return true;
}

template <bool kGather, bool kSplit>
int dispatch(int route, int is_bf16, const void* a, const Mats& mats,
             int n_mats, int B, int T, int K, int N, int heads, int hd,
             cudaStream_t s) {
  const int M = B * T;
  if ((route == kFfma) == (is_bf16 != 0)) return (int)cudaErrorInvalidValue;
  switch (route) {
    case kFfma:
      return launch<float, kGather, kSplit>(a, mats, n_mats, M, N, K, T,
                                            heads, hd, s);
    case kMma:
      return launch<bf16, kGather, kSplit>(a, mats, n_mats, M, N, K, T,
                                           heads, hd, s);
    case kWgmma:
      if (!hopper_ok(a, mats, n_mats, K, N, hd))
        return (int)cudaErrorInvalidValue;
      return launch_wgmma<kGather, kSplit>(a, mats, n_mats, B, T, K, N, hd,
                                           s);
    case kStream:
      if (!hopper_ok(a, mats, n_mats, K, N, hd) || M > kStMaxM)
        return (int)cudaErrorInvalidValue;
      return launch_stream<kGather, kSplit>(a, mats, n_mats, M, N, K, T,
                                            heads, hd, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x [B, T, K]; w_z [N, K]; b_z [N]; out_z [B, N / D, T, D]; z < n_mats <= 3;
// all f32 (is_bf16 = 0) or all bf16, contiguous; N % D == 0.  route: a
// Route code.
TETHYS_EXPORT int tethys_proj_split(
    const void* x, const void* w0, const void* w1, const void* w2,
    const void* b0, const void* b1, const void* b2, void* o0, void* o1,
    void* o2, float s0, float s1, float s2, int n_mats, int B, int T, int K,
    int N, int D, int is_bf16, int route, void* stream) {
  if (n_mats < 1 || n_mats > 3 || B <= 0 || T <= 0 || K <= 0 || N <= 0 ||
      D <= 0 || N % D != 0)
    return (int)cudaErrorInvalidValue;
  const Mats mats = {{w0, w1, w2}, {b0, b1, b2}, {o0, o1, o2}, {s0, s1, s2}};
  return dispatch<false, true>(route, is_bf16, x, mats, n_mats, B, T, K, N,
                               N / D, D, (cudaStream_t)stream);
}

// attn [B, H, T, D]; w [N, H * D]; b [N]; out [B, T, N]; all f32 (is_bf16 =
// 0) or all bf16, contiguous.  route: a Route code.
TETHYS_EXPORT int tethys_merge_proj(const void* attn, const void* w,
                                    const void* b, void* out, int B, int H,
                                    int T, int D, int N, int is_bf16,
                                    int route, void* stream) {
  if (B <= 0 || H <= 0 || T <= 0 || D <= 0 || N <= 0)
    return (int)cudaErrorInvalidValue;
  const Mats mats = {{w, w, w}, {b, b, b}, {out, out, out}, {1.f, 1.f, 1.f}};
  return dispatch<true, false>(route, is_bf16, attn, mats, 1, B, T, H * D, N,
                               H, D, (cudaStream_t)stream);
}
