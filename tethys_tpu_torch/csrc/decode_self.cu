// One-token decoder self-attention with the KV-cache append, in one launch,
// the key axis split over a thread-block cluster.
//
// Replaces tethys_tpu/ops/pallas_decode.py::_kernel (launched by
// _pallas_self, via decode_self_attention).  For each (batch, head) it
//   1. writes k_new and v_new as column idx of the transposed caches
//      [B, H, D, T_max], in place;
//   2. computes the scores q . k[:, t] for t <= idx in f32;
//   3. takes an f32 softmax over them and rounds p = exp(s - m) / l to the
//      compute dtype;
//   4. writes out[d] = sum_t p[t] v[d, t], summed in f32, in the compute
//      dtype.
// Positions past idx are never read, which is what the TPU kernel's mask
// (-1e9 before the softmax) amounts to.
//
// What bounds it on an H100: device memory, and at serving sizes launch
// latency.  It reads 2 * D * idx cache values per (batch, head) and writes
// one column, one multiply-add per value: 4.2 MB at whisper-base b16 bf16
// (B 16, H 8, D 64) at idx 127, 1.3 us at 3.35 TB/s.
//
// The first design (one block of 128 threads per (batch, head)) read 2-byte
// elements in a D-long loop per thread with one load in flight, and 128
// blocks left SMs idle: 13x its bound.  This one (csrc/split_decode.cuh)
// splits the idx + 1 columns over a cluster of S <= 8 blocks of at least 32
// columns each (S = 1 at small idx, 4 at idx 127 with B 16 x H 8, 7 at
// idx 447), each block issuing its whole K and V slice at once as 16-byte
// cp.async copies (4-byte, or 2-byte loads, when the rows of an odd
// max_length or a misaligned base do not allow 16).  The rank that holds
// column idx writes the new column into both caches and puts it into its
// tiles from shared memory: the cache column it writes is never read back.
// The blocks exchange their max, their sum and their partial outputs
// through distributed shared memory (st.async, counted by mbarriers), in
// rank order, so p is rounded with the global m and l as the Pallas kernel
// rounds it, and no atomics are used.  idx arrives as a kernel argument, so
// a host loop over decode steps never waits on the device.
//
// Not Triton: the exchange of m and l between blocks and the rank-order sum
// of the partials in distributed shared memory have no Triton counterpart.
#include "split_decode.cuh"

namespace {

constexpr int kMinCols = 32;  // columns a rank holds at least

}  // namespace

// q, k_new, v_new [B, H, 1, D]; k_buf, v_buf [B, H, D, T_max] (updated in
// place); out [B, H, 1, D].  All f32 (is_bf16 = 0) or all bf16, contiguous.
// 0 <= idx < T_max, D <= 256.
TETHYS_EXPORT int tethys_decode_self(const void* q, const void* k_new,
                                     const void* v_new, void* k_buf,
                                     void* v_buf, void* out, int B, int H,
                                     int D, int Tmax, int idx, int is_bf16,
                                     void* stream) {
  if (B <= 0 || H <= 0 || D <= 0 || Tmax <= 0 || idx < 0 || idx >= Tmax)
    return (int)cudaErrorInvalidValue;
  namespace sd = tethys::split_decode;
  const sd::Params p = {q, k_buf, v_buf, nullptr, nullptr, k_new, v_new,
                        out, D, Tmax, idx + 1};
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return sd::launch<__nv_bfloat16, __nv_bfloat16, false>(p, B * H, kMinCols,
                                                           s);
  return sd::launch<float, float, false>(p, B * H, kMinCols, s);
}

// The cluster size tethys_decode_self takes for these sizes on the current
// device.
TETHYS_EXPORT int tethys_decode_self_cluster(int BH, int D, int idx,
                                             int is_bf16) {
  if (BH <= 0 || D <= 0 || idx < 0) return 0;
  return tethys::split_decode::make_plan(BH, idx + 1, D, is_bf16 ? 2 : 4,
                                         false, kMinCols).S;
}
