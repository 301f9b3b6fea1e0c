// Head split permute [B, T, H*d] -> [B, H, T, d].
//
// Replaces tethys_tpu/ops/pallas_transpose.py::_split_kernel (launched by
// _split_call, via split_heads).  The TPU kernel moved whole [T, H*d] rows
// into VMEM and sliced lanes in registers, because XLA's own transpose ran
// at a tenth of HBM bandwidth there.
//
// What bounds it on an H100: device memory.  It reads and writes each byte
// once and computes nothing, so its floor is 2 * bytes / 3.35 TB/s.  The
// design: each thread moves one 16-byte vector (4 f32 or 8 bf16 values)
// whenever a head's row of d values is a whole number of vectors and both
// pointers are 16-byte aligned, else one 4- or 2-byte element.  Threads are
// numbered in the input's order, so a warp reads 512 contiguous bytes along
// H*d and writes whole 16-byte pieces of each head's row.  The kernel copies
// bytes and so serves every dtype of that width; T = 1 (a decode step) is
// the same code.
#include "common.cuh"

namespace {

template <typename V>
__global__ void __launch_bounds__(256)
    split_heads_kernel(const V* __restrict__ x, V* __restrict__ y,
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
    y[((b * H + h) * T + t) * dv + c] = x[i];
  }
}

template <typename V>
int launch(const void* x, void* y, int B, int T, int H, int dv,
           cudaStream_t stream) {
  const long long n = (long long)B * T * H * dv;
  long long blocks = (n + 255) / 256;
  if (blocks > 132 * 64) blocks = 132 * 64;  // grid-stride beyond this
  split_heads_kernel<V><<<(int)blocks, 256, 0, stream>>>(
      (const V*)x, (V*)y, n, T, H, dv);
  return (int)cudaGetLastError();
}

bool aligned(const void* p, int bytes) {
  return ((uintptr_t)p % bytes) == 0;
}

}  // namespace

// x [B, T, H*D] -> y [B, H, T, D], elements of elem_bytes (2 or 4) bytes,
// both contiguous.
TETHYS_EXPORT int tethys_split_heads(const void* x, void* y, int B, int T,
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
