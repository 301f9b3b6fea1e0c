// One-token cross-attention against int8 caches with per-column scales,
// the key axis split over a thread-block cluster.
//
// Replaces tethys_tpu/ops/pallas_decode.py::_q8_cross_kernel (launched by
// _pallas_q8_cross, via decode_cross_attention_q8).  For each (batch, head)
// with transposed caches k8, v8 [D, Tk] (int8) and scales sk, sv [Tk] (f32):
//   1. scores[t] = (sum_d q[d] * k8[d, t]) * sk[t], the sum in f32 (k8 cast
//      to the query's dtype is exact, so each product is exact in f32);
//   2. positions t >= kv_len are left out (the TPU kernel's -1e9 mask);
//   3. m and l over all kv_len positions, then p[t] = exp(s[t] - m) / l *
//      sv[t] rounded to the compute dtype;
//   4. out[d] = sum_t p[t] * v8[d, t] in f32, rounded to the compute dtype.
//
// What bounds it on an H100: device memory.  It reads 2 * D * Tk bytes of
// int8 cache and 8 * Tk bytes of scales per (batch, head), about one
// multiply-add per byte: 26.1 MB at whisper-base b16 (B 16, H 8, D 64,
// Tk 1500), 7.8 us at 3.35 TB/s.
//
// The first design (one block of 256 threads per (batch, head)) lost most of
// that: 128 blocks left SMs of the 132 idle, and each block had one char4 a
// thread in flight, so the caches streamed at about 0.5 TB/s.  This one
// (csrc/split_decode.cuh) splits the keys over a cluster of S <= 8 blocks:
// S = 8 at B 16 x H 8 gives 1024 blocks of 192 keys, each of which issues
// its whole K and V slice at once as 4-byte cp.async copies (16-byte when
// Tk % 16 == 0; Tk 1500 rows are 4-byte aligned only).  The blocks of a
// cluster exchange their max, their sum and their partial outputs through
// distributed shared memory (st.async, counted by mbarriers), in rank order,
// so p is rounded with the global m and l as in the Pallas kernel; the
// flash-decoding combine (rescaling per-split outputs by exp(m_i - m)) would
// round p before l is known and give other bf16 results.  Rows that are not
// 4-byte aligned (Tk % 4 != 0, a misaligned base) take byte loads.  What
// is left of the bound: the blocks load, then convert and multiply, in lock
// step, and 29 KB of shared memory a block fits 7 blocks an SM.
//
// Not Triton: the exchange of m and l between blocks and the rank-order sum
// of the partials in distributed shared memory have no Triton counterpart.
#include "split_decode.cuh"

namespace {

constexpr int kMinCols = 64;  // keys a rank holds at least

}  // namespace

// q [B, H, 1, D] and out [B, H, 1, D] f32 (is_bf16 = 0) or bf16; k8, v8
// int8 [B, H, D, Tk]; sk, sv f32 [B, H, 1, Tk]; all contiguous, BH = B * H;
// 1 <= kv_len <= Tk, D <= 256.
TETHYS_EXPORT int tethys_q8_cross(const void* q, const void* k8,
                                  const void* sk, const void* v8,
                                  const void* sv, void* out, int BH, int D,
                                  int Tk, int kv_len, int is_bf16,
                                  void* stream) {
  namespace sd = tethys::split_decode;
  const sd::Params p = {q, const_cast<void*>(k8), const_cast<void*>(v8),
                        (const float*)sk, (const float*)sv, nullptr, nullptr,
                        out, D, Tk, kv_len};
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return sd::launch<__nv_bfloat16, int8_t, true>(p, BH, kMinCols, s);
  return sd::launch<float, int8_t, true>(p, BH, kMinCols, s);
}

// The cluster size tethys_q8_cross takes for these sizes on the current
// device.
TETHYS_EXPORT int tethys_q8_cross_cluster(int BH, int D, int kv_len) {
  if (BH <= 0 || D <= 0 || kv_len <= 0) return 0;
  return tethys::split_decode::make_plan(BH, kv_len, D, 1, true, kMinCols).S;
}
