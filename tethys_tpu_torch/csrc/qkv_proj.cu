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
// What bounds them on an H100: at the encoder's M = B * T = 24000 rows the
// operations (2 * M * N * K each); at a decode step (M = B) reading W.  The
// design: one GEMM, both operands K-contiguous ("TN"), 64 x 64 output tiles
// over (N, M) and gridDim.z over the matrices.  bf16 runs on the tensor
// cores: 4 warps, each a 32 x 32 quarter of the tile as 2 x 4 mma.sync
// m16n8k16 products with f32 sums, 32-deep K slices staged through shared
// memory as bf16 (rows padded to 80 bytes so that a warp's fragment loads
// hit 32 distinct banks), 16-byte global loads where K (and the head dim
// for the merge's gather) is a multiple of 8 and the pointers are aligned,
// else 2-byte loads.  f32 stays exact: 256 threads each holding a 4 x 4
// block of FFMA sums over 16-deep f32 slices.  The head gather and scatter
// are index arithmetic in the tile loads and in the epilogue.  Any T and
// any N % d == 0 (checked by the wrapper); ragged tile edges are masked.
// No cp.async pipelining, no wgmma: later work.
#include "common.cuh"

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

// ---- bf16 on the tensor cores ---------------------------------------------

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

}  // namespace

// x [B, T, K]; w_z [N, K]; b_z [N]; out_z [B, N / D, T, D]; z < n_mats <= 3;
// all f32 (is_bf16 = 0) or all bf16, contiguous; N % D == 0.
TETHYS_EXPORT int tethys_proj_split(
    const void* x, const void* w0, const void* w1, const void* w2,
    const void* b0, const void* b1, const void* b2, void* o0, void* o1,
    void* o2, float s0, float s1, float s2, int n_mats, int B, int T, int K,
    int N, int D, int is_bf16, void* stream) {
  if (n_mats < 1 || n_mats > 3 || B <= 0 || T <= 0 || K <= 0 || N <= 0 ||
      D <= 0 || N % D != 0)
    return (int)cudaErrorInvalidValue;
  const Mats mats = {{w0, w1, w2}, {b0, b1, b2}, {o0, o1, o2}, {s0, s1, s2}};
  cudaStream_t s = (cudaStream_t)stream;
  const int M = B * T, H = N / D;
  if (is_bf16)
    return launch<__nv_bfloat16, false, true>(x, mats, n_mats, M, N, K, T, H,
                                              D, s);
  return launch<float, false, true>(x, mats, n_mats, M, N, K, T, H, D, s);
}

// attn [B, H, T, D]; w [N, H * D]; b [N]; out [B, T, N]; all f32 (is_bf16 =
// 0) or all bf16, contiguous.
TETHYS_EXPORT int tethys_merge_proj(const void* attn, const void* w,
                                    const void* b, void* out, int B, int H,
                                    int T, int D, int N, int is_bf16,
                                    void* stream) {
  if (B <= 0 || H <= 0 || T <= 0 || D <= 0 || N <= 0)
    return (int)cudaErrorInvalidValue;
  const Mats mats = {{w, w, w}, {b, b, b}, {out, out, out}, {1.f, 1.f, 1.f}};
  cudaStream_t s = (cudaStream_t)stream;
  const int M = B * T, K = H * D;
  if (is_bf16)
    return launch<__nv_bfloat16, true, false>(attn, mats, 1, M, N, K, T, H, D,
                                              s);
  return launch<float, true, false>(attn, mats, 1, M, N, K, T, H, D, s);
}
