// Head merge permute [B, H, T, d] -> [B, T, H*d], the inverse of
// split_heads.cu.
//
// Replaces tethys_tpu/ops/pallas_transpose.py::_merge_kernel (launched by
// _merge_call).  The JAX package runs it as split_heads' backward
// (_split_bwd): the forward merge stays plain (MERGE_IMPL = "xla"), as it
// does here.
//
// What bounds it on an H100: device memory, as for the split (2 * bytes /
// 3.35 TB/s).  The design mirrors split_heads.cu with the roles swapped:
// threads are numbered in the OUTPUT's order, so a warp writes 512
// contiguous bytes of [T, H*d] rows and reads whole 16-byte pieces of each
// head's row; each thread moves a 16-byte vector when a head row of d
// values is a whole number of them and both pointers are 16-byte aligned,
// else a 4- or 2-byte element.
#include "common.cuh"

namespace {

template <typename V>
__global__ void __launch_bounds__(256)
    merge_heads_kernel(const V* __restrict__ x, V* __restrict__ y,
                       long long n, int T, int H, int dv) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int c = (int)(i % dv);
    long long r = i / dv;
    const int h = (int)(r % H);
    r /= H;
    const int t = (int)(r % T);
    const long long b = r / T;
    y[i] = x[((b * H + h) * T + t) * dv + c];
  }
}

template <typename V>
int launch(const void* x, void* y, int B, int T, int H, int dv,
           cudaStream_t stream) {
  const long long n = (long long)B * T * H * dv;
  long long blocks = (n + 255) / 256;
  if (blocks > 132 * 64) blocks = 132 * 64;  // grid-stride beyond this
  merge_heads_kernel<V><<<(int)blocks, 256, 0, stream>>>(
      (const V*)x, (V*)y, n, T, H, dv);
  return (int)cudaGetLastError();
}

bool aligned(const void* p, int bytes) {
  return ((uintptr_t)p % bytes) == 0;
}

}  // namespace

// x [B, H, T, D] -> y [B, T, H*D], elements of elem_bytes (2 or 4) bytes,
// both contiguous.
TETHYS_EXPORT int tethys_merge_heads(const void* x, void* y, int B, int T,
                                     int H, int D, int elem_bytes,
                                     void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || D <= 0 ||
      (elem_bytes != 2 && elem_bytes != 4))
    return (int)cudaErrorInvalidValue;
  const long long row_bytes = (long long)D * elem_bytes;
  cudaStream_t s = (cudaStream_t)stream;
  if (row_bytes % 16 == 0 && aligned(x, 16) && aligned(y, 16))
    return launch<uint4>(x, y, B, T, H, (int)(row_bytes / 16), s);
  if (row_bytes % 4 == 0 && aligned(x, 4) && aligned(y, 4))
    return launch<uint32_t>(x, y, B, T, H, (int)(row_bytes / 4), s);
  if (elem_bytes == 2)
    return launch<uint16_t>(x, y, B, T, H, D, s);
  return (int)cudaErrorInvalidValue;
}
