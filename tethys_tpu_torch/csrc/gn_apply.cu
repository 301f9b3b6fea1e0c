// GroupNorm's two elementwise passes over x [B, T, C] (f32 or bf16), with
// the per-(batch, group) vectors of csrc/gn_stats.cu:
// - forward (tethys_gn_apply): y = gamma * ((x - mean) * rstd) + beta, in
//   the JAX order (tethys_tpu/ops/norms.py:68), computed in f32 and written
//   once in x's dtype (the module's compute dtype);
// - backward (tethys_gn_apply_bwd): dx = rstd * (dy * gamma - s1 - xhat *
//   s2), xhat = (x - mean) * rstd recomputed from x, written in x's dtype
//   (the closed form of norms.py:116, with s1 and s2 from the backward
//   mode of gn_stats.cu).
// Each operation is rounded where the plain version (ops/group_norm.py)
// rounds it (no fused multiply-adds), so the kernel and the plain version
// give the same f32 values from the same vectors.
//
// Replaces the elementwise part of tethys_tpu/ops/norms.py _gn_core
// (forward :62 and :68, backward :116), which XLA fuses on the TPU: no
// Pallas kernel exists for it.
//
// What bounds it on an H100: device memory, x in and y out (forward), x
// and dy in and dx out (backward), each byte once, over 3.35 TB/s; the
// arithmetic is a few flops an element.  The design, for that floor:
// - 16 bytes a thread a row (8 bf16 or 4 f32 channels; a scalar form,
//   kVec = 1, takes misaligned views), neighbouring threads on
//   neighbouring bytes;
// - a thread keeps its channels for the whole launch: gamma and beta are
//   read once a block into registers; the [B, G] vectors are read a row
//   through L1 (one load per vector where the thread's channels share a
//   group);
// - a grid-stride loop over rows, two rows a step (their loads issued
//   together), on a grid of the occupancy the kernel gets (ops/
//   group_norm.py apply_grid): one wave, every block resident.
#include "common.cuh"

using namespace tethys;

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 2;  // rows a thread has in flight

struct Params {
  const void* x;        // [b, t, c]
  const void* dy;       // [b, t, c], backward only
  const float* gamma;   // [c]
  const float* beta;    // [c], forward only
  const float* mean;    // [b, groups]
  const float* rstd;    // [b, groups]
  const float* s;       // [2, b, groups] (s1, s2), backward only
  void* out;            // y or dx, [b, t, c], x's dtype
  int b, t, c, groups;
};

// v[i] = vec[bg + group of channel c + i]: one load where the kVec channels
// share a group.
template <int kVec>
__device__ __forceinline__ void load_groups(const float* vec, int bg, int c,
                                            int pg, bool one, float* v) {
  if (one) {
    const float a = __ldg(vec + bg + c / pg);
#pragma unroll
    for (int i = 0; i < kVec; ++i) v[i] = a;
  } else {
#pragma unroll
    for (int i = 0; i < kVec; ++i) v[i] = __ldg(vec + bg + (c + i) / pg);
  }
}

template <typename T, int kVec, bool kBwd>
__device__ __forceinline__ void gn_pass(const Params& p) {
  const int chunks = p.c / kVec, tpr = min(chunks, kThreads);
  const int slots = kThreads / tpr, slot = threadIdx.x / tpr;
  if (slot >= slots) return;
  const int pg = p.c / p.groups, rows = p.b * p.t;
  const int stride = (int)gridDim.x * slots;
  const T* x = (const T*)p.x;
  const T* dy = (const T*)p.dy;
  T* out = (T*)p.out;
  const float* s2 = kBwd ? p.s + p.b * p.groups : nullptr;
  // One chunk a thread unless c > kThreads * kVec.
  for (int j = threadIdx.x % tpr; j < chunks; j += tpr) {
    const int c = j * kVec;
    const bool one = c / pg == (c + kVec - 1) / pg;
    float gam[kVec], bet[kVec];
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      gam[i] = __ldg(p.gamma + c + i);
      bet[i] = kBwd ? 0.f : __ldg(p.beta + c + i);
    }
    for (int row = (int)blockIdx.x * slots + slot; row < rows;
         row += kRows * stride) {
      Pack<T, kVec> px[kRows] = {}, pd[kRows] = {};
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        const int r = row + u * stride;
        if (r < rows) {
          const long long o = (long long)r * p.c + c;
          px[u] = load_pack<T, kVec>(x + o);
          if constexpr (kBwd) pd[u] = load_pack<T, kVec>(dy + o);
        }
      }
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        const int r = row + u * stride;
        if (r >= rows) break;
        const int bg = (r / p.t) * p.groups;
        float f[kVec], mu[kVec], rs[kVec], y[kVec];
        unpack<T, kVec>(px[u], f);
        load_groups<kVec>(p.mean, bg, c, pg, one, mu);
        load_groups<kVec>(p.rstd, bg, c, pg, one, rs);
        if constexpr (kBwd) {
          float d[kVec], a1[kVec], a2[kVec];
          unpack<T, kVec>(pd[u], d);
          load_groups<kVec>(p.s, bg, c, pg, one, a1);
          load_groups<kVec>(s2, bg, c, pg, one, a2);
#pragma unroll
          for (int i = 0; i < kVec; ++i) {
            const float xh = __fmul_rn(__fsub_rn(f[i], mu[i]), rs[i]);
            const float t = __fsub_rn(__fmul_rn(d[i], gam[i]), a1[i]);
            y[i] = __fmul_rn(rs[i], __fsub_rn(t, __fmul_rn(xh, a2[i])));
          }
        } else {
#pragma unroll
          for (int i = 0; i < kVec; ++i) {
            const float xh = __fmul_rn(__fsub_rn(f[i], mu[i]), rs[i]);
            y[i] = __fadd_rn(__fmul_rn(gam[i], xh), bet[i]);
          }
        }
        store_pack<T, kVec>(out + (long long)r * p.c + c, y);
      }
    }
  }
}

// Two kernels, so that a profile names the passes apart.
template <typename T, int kVec>
__global__ void __launch_bounds__(kThreads) gn_apply_kernel(const Params p) {
  gn_pass<T, kVec, false>(p);
}

template <typename T, int kVec>
__global__ void __launch_bounds__(kThreads)
    gn_apply_bwd_kernel(const Params p) {
  gn_pass<T, kVec, true>(p);
}

template <typename T, int kVec, bool kBwd>
int launch_kernel(const Params& p, int n_blocks, cudaStream_t stream) {
  if constexpr (kBwd)
    gn_apply_bwd_kernel<T, kVec><<<n_blocks, kThreads, 0, stream>>>(p);
  else
    gn_apply_kernel<T, kVec><<<n_blocks, kThreads, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

template <bool kBwd>
int launch(const Params& p, int n_blocks, int is_bf16, int vec,
           cudaStream_t stream) {
  if (p.b <= 0 || p.t <= 0 || p.c <= 0 || p.groups <= 0 ||
      p.c % p.groups != 0 || n_blocks < 1 ||
      (long long)p.b * p.t > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (vec && p.c % (is_bf16 ? 8 : 4) != 0) return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return vec ? launch_kernel<__nv_bfloat16, 8, kBwd>(p, n_blocks, stream)
               : launch_kernel<__nv_bfloat16, 1, kBwd>(p, n_blocks, stream);
  return vec ? launch_kernel<float, 4, kBwd>(p, n_blocks, stream)
             : launch_kernel<float, 1, kBwd>(p, n_blocks, stream);
}

template <typename T, int kVec, bool kBwd>
int occupancy(int* out) {
  out[1] = sm_count();
  if constexpr (kBwd)
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &out[0], gn_apply_bwd_kernel<T, kVec>, kThreads, 0);
  else
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &out[0], gn_apply_kernel<T, kVec>, kThreads, 0);
}

template <bool kBwd>
int occupancy_of(int is_bf16, int vec, int* out) {
  if (is_bf16)
    return vec ? occupancy<__nv_bfloat16, 8, kBwd>(out)
               : occupancy<__nv_bfloat16, 1, kBwd>(out);
  return vec ? occupancy<float, 4, kBwd>(out) : occupancy<float, 1, kBwd>(out);
}

}  // namespace

// Forward.  x, y: [b, t, c] contiguous, one dtype (f32 if is_bf16 = 0, else
// bf16; 16-byte aligned with c a multiple of 16 bytes where vec = 1);
// gamma, beta: f32 [c]; mean, rstd: f32 [b, groups].
TETHYS_EXPORT int tethys_gn_apply(const void* x, const float* gamma,
                                  const float* beta, const float* mean,
                                  const float* rstd, void* y, int b, int t,
                                  int c, int groups, int n_blocks,
                                  int is_bf16, int vec, void* stream) {
  const Params p = {x, nullptr, gamma, beta, mean, rstd, nullptr, y,
                    b, t, c, groups};
  return launch<false>(p, n_blocks, is_bf16, vec, (cudaStream_t)stream);
}

// Backward.  x, dy, dx: [b, t, c], one dtype; gamma: f32 [c]; mean, rstd:
// f32 [b, groups]; s: f32 [2, b, groups] (s1, s2).
TETHYS_EXPORT int tethys_gn_apply_bwd(const void* x, const void* dy,
                                      const float* gamma, const float* mean,
                                      const float* rstd, const float* s,
                                      void* dx, int b, int t, int c,
                                      int groups, int n_blocks, int is_bf16,
                                      int vec, void* stream) {
  const Params p = {x, dy, gamma, nullptr, mean, rstd, s, dx,
                    b, t, c, groups};
  return launch<true>(p, n_blocks, is_bf16, vec, (cudaStream_t)stream);
}

// out[0]: blocks an SM (the kernel's occupancy); out[1]: the SMs.
TETHYS_EXPORT int tethys_gn_apply_occupancy(int bwd, int is_bf16, int vec,
                                            int* out) {
  return bwd ? occupancy_of<true>(is_bf16, vec, out)
             : occupancy_of<false>(is_bf16, vec, out);
}
