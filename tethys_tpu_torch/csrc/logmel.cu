// Fused framing -> window-DFT -> power -> mel -> log, on the tensor cores.
//
// Replaces tethys_tpu/audio/pallas_logmel.py::_kernel (launched by
// fused_log_mel).  For each frame of each waveform row it computes
//   re = frame @ C, im = frame @ S      (C, S: the window-folded real DFT)
//   out = log((re^2 + im^2) @ mel + 1e-6)
// and writes only out: the frames, re, im and the power never reach device
// memory.
//
// What bounds it on an H100: arithmetic.  Per frame it does 2 n_fft n_bins
// + n_bins n_mels multiply-adds (177k at 400 taps, 201 bins, 80 mels)
// against 640 bytes of audio in and 320 out.  The TPU kernel split every
// f32 product into three bf16 MXU passes; here every product is three TF32
// mma.sync passes (m16n8k8), a_hi b_hi + a_hi b_lo + a_lo b_hi summed in
// f32, with hi = x rounded to TF32 and lo = x - hi: about 21 bits of each
// operand, close to f32, at the tensor cores' rate.  The tensor cores cut
// (not round) the bits of a sum below its largest term, so the DFT's sums
// over 400 taps are formed 8 taps at a time in the tensor cores and added
// up by f32 adds.  The design:
//
// * Folded taps.  The periodic Hann window is symmetric, w[N - n] = w[n],
//   so C[N - n] = C[n] and S[N - n] = -S[n]: re = sum over n <= N/2 of
//   (x[n] + x[N - n]) Cf[n], im = sum of (x[n] - x[N - n]) S[n], with Cf
//   = C but halved at n = 0 and N/2 (where x[N - n] is x[n] itself; at
//   n = 0 both are 0, as w[0] = 0).  201 taps instead of 400 halve the
//   DFT's products; the sums and differences are formed in f32 before the
//   split.
// * Transposed products.  re^T = C^T frames^T: A is C^T (bins x taps), B
//   the frames (taps x frames).  Warp w owns bins [16 w, 16 w + 16) of both
//   C and S for all kFrames frames of the block, so re and im of a (bin,
//   frame) pair land in the same thread's registers and the power is formed
//   there; 201 bins take 13 warps (208 bins, 3% padding) and no bin loop.
//   A block takes 96 or 64 frames (frame_tile: whichever wastes fewer
//   slots of whole waves, 64 on a tie), one block an SM.
// * C and S arrive split into hi and lo on the host, in fragment order
//   ([warp][tap step][Cf hi, Cf lo, S hi, S lo][lane][4]); each thread copies
//   its own 64 bytes of the next tap step by cp.async into a 2-stage ring in
//   shared memory while it multiplies the current one, and reads back only
//   what it copied (no block barrier in the tap loop).  The frames are
//   split in registers.
// * Framing in the kernel.  A block takes kFrames consecutive frames of
//   one row and loads their (kFrames - 1) hop + n_fft samples once.  Frame
//   r, tap k sits at r hop + k, and hop = 160 is 0 mod 32, so the eight
//   frames of a B fragment would hit one bank; the samples are stored with
//   `skew` floats after every hop of them, so that frames lie hop + skew
//   = 4 (mod 32) floats apart and a fragment's 32 loads hit 32 banks.
// * The mel product follows on the tensor cores too (out^T = mel^T
//   power^T, 3xTF32): the power goes to shared memory over the samples,
//   mel^T comes split in fragment order from L2, and only the tap steps of
//   8 bins where a tile of 16 mel bands has a nonzero weight are taken
//   (the filters are bands).  Log and store come last; frames past the
//   row's end are computed on zeros and never stored.
#include "common.cuh"

namespace {

// x = hi + lo to about 21 bits.  hi: x rounded to TF32 (10 mantissa bits,
// to nearest, ties away from zero) by integer operations, which issue at
// the full rate where cvt.rna.tf32.f32 does not; lo = x - hi, exact in f32,
// whose low 13 bits the tensor cores ignore (so lo is truncated to TF32).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d += a b, one m16n8k8 TF32 product.  Fragments of lane l, g = l / 4,
// t = l % 4 (PTX ISA, "Matrix Fragments for mma.m16n8k8", .tf32):
//   A (16 x 8): a[0] = (g, t), a[1] = (g + 8, t), a[2] = (g, t + 4),
//               a[3] = (g + 8, t + 4)
//   B (8 x 8):  b0 = (k t, n g), b1 = (k t + 4, n g)
//   C (16 x 8): c[0], c[1] = (g, 2t), (g, 2t + 1); c[2], c[3] = row g + 8
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A B fragment split into TF32 high and low parts.
struct BSplit {
  uint32_t h0, h1, l0, l1;
};

__device__ __forceinline__ BSplit split_b(float b0, float b1) {
  BSplit b;
  split_tf32(b0, b.h0, b.l0);
  split_tf32(b1, b.h1, b.l1);
  return b;
}

// d += a b in 3xTF32 (the two small cross terms first) through a fresh
// sum.  A sum carried over all the taps in the tensor cores' accumulator
// lost bits in proportion to its own size on the card (their adds align
// to the larger term and cut, not round, the bits below): several times
// the f32 version's error where a bin's power nearly cancels.  So the
// three products of one step of 8 go into a sum that starts at 0, and
// that sum is added to d by an f32 add.
__device__ __forceinline__ void mma_3xtf32(float* d, const uint32_t* a_hi,
                                           const uint32_t* a_lo,
                                           const BSplit& b) {
  float s[4];
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(s[0]), "=f"(s[1]), "=f"(s[2]), "=f"(s[3])
      : "r"(a_lo[0]), "r"(a_lo[1]), "r"(a_lo[2]), "r"(a_lo[3]), "r"(b.h0),
        "r"(b.h1), "f"(0.f));
  mma_tf32(s, a_hi, b.l0, b.l1);
  mma_tf32(s, a_hi, b.h0, b.h1);
#pragma unroll
  for (int i = 0; i < 4; ++i) d[i] += s[i];
}

__device__ __forceinline__ void as_u32(uint32_t* r, float4 v) {
  r[0] = __float_as_uint(v.x);
  r[1] = __float_as_uint(v.y);
  r[2] = __float_as_uint(v.z);
  r[3] = __float_as_uint(v.w);
}

// Floats a frame lies from the next in shared memory: hop + skew = 4 (mod
// 32), so the 8 frames x 4 taps of a B fragment fall on 32 banks.
int skew_for(int hop) { return (36 - hop % 32) % 32; }

constexpr int kMaxWarps = 16;  // 256 bins

// region: floats of shared memory before the ring, enough for the block's
// samples and for the power tile [kFrames][16 warps + 4].
template <int kFrames>
__global__ void __launch_bounds__(kMaxWarps * 32, 1)
    log_mel_kernel(const float* __restrict__ wave,
                   const float4* __restrict__ dft,
                   const float4* __restrict__ mel,
                   const int2* __restrict__ mel_steps,
                   float* __restrict__ out, long long row_stride,
                   int frames_per_row, int frame_blocks, int n_fft, int hop,
                   int skew, int n_mels, int region, bool vec16) {
  constexpr int kTiles = kFrames / 8;    // n-tiles of frames
  constexpr int kGroups = kFrames / 32;  // frame groups of the mel product
  extern __shared__ __align__(16) float smem[];
  const int warps = blockDim.x >> 5;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int row = blockIdx.x / frame_blocks;
  const int f0 = (blockIdx.x % frame_blocks) * kFrames;
  const int n_steps = (n_fft / 2 + 8) / 8;  // folded taps 0 .. N/2
  const int pitch = hop + skew;
  const int bins = warps * 16;
  const int pow_pitch = bins + 4;  // = 4 or 20 (mod 32): no bank conflicts
  float* s_wave = smem;
  float4* s_ring = reinterpret_cast<float4*>(smem + region);
  const int stage = warps * 128;  // float4s of one ring stage

  // The block's samples, zeros past the row's last frame.
  const float* src = wave + (long long)row * row_stride + (long long)f0 * hop;
  const int run = (kFrames - 1) * hop + n_fft;
  const int valid = min(run, (frames_per_row - 1 - f0) * hop + n_fft);
  if (vec16) {
    for (int i = tid * 4; i < run; i += blockDim.x * 4) {
      const int n = 4 * min(max(valid - i, 0), 4);
      tethys::cp_async_n<16>(s_wave + i + (i / hop) * skew,
                             n ? src + i : src, n);
    }
  } else {
    for (int i = tid; i < run; i += blockDim.x)
      tethys::cp_async4(s_wave + i + (i / hop) * skew,
                        i < valid ? src + i : src, i < valid);
  }

  // This thread's 4 x 16 bytes of C^T and S^T fragments per tap step.
  const float4* a_src = dft + (long long)warp * n_steps * 128 + lane;
  float4* a_dst = s_ring + warp * 128 + lane;
  auto load_a = [&](int step) {
    const float4* s = a_src + step * 128;
    float4* d = a_dst + (step & 1) * stage;
#pragma unroll
    for (int c = 0; c < 4; ++c) tethys::cp_async16(d + c * 32, s + c * 32, true);
  };
  load_a(0);
  tethys::cp_async_commit();
  tethys::cp_async_wait<0>();
  __syncthreads();

  float acc[2][kTiles][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < kTiles; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][j][i] = 0.f;

  const float* wb = s_wave + g * pitch;  // frame g
  auto tap = [&](int k) { return k + (k / hop) * skew; };  // its offset
  for (int s = 0; s < n_steps; ++s) {
    asm volatile("" ::: "memory");  // the last step's reads stay before
    if (s + 1 < n_steps) load_a(s + 1);
    tethys::cp_async_commit();
    tethys::cp_async_wait<1>();
    asm volatile("" ::: "memory");
    const float4* a = a_dst + (s & 1) * stage;
    uint32_t c_hi[4], c_lo[4], s_hi[4], s_lo[4];
    as_u32(c_hi, a[0]);
    as_u32(c_lo, a[32]);
    as_u32(s_hi, a[64]);
    as_u32(s_lo, a[96]);
    // Folded taps n and n + 4 of this lane, with their mirrors N - n.
    const int n = s * 8 + t;
    const int d0 = tap(n), d1 = tap(n + 4);
    const int m0 = tap(n ? n_fft - n : 0), m1 = tap(n_fft - n - 4);
#pragma unroll
    for (int j = 0; j < kTiles; ++j) {
      const float* f = wb + j * 8 * pitch;
      const float x0 = f[d0], x1 = f[d1], y0 = f[m0], y1 = f[m1];
      mma_3xtf32(acc[0][j], c_hi, c_lo, split_b(x0 + y0, x1 + y1));
      mma_3xtf32(acc[1][j], s_hi, s_lo, split_b(x0 - y0, x1 - y1));
    }
  }
  __syncthreads();  // every warp is done with the samples

  // The power tile [kFrames][pow_pitch] over the samples: rows g and g + 8
  // of this warp's bins, frames 8 j + 2 t and + 1.
  float* s_pow = smem;
  {
    float* p = s_pow + 2 * t * pow_pitch + warp * 16 + g;
#pragma unroll
    for (int j = 0; j < kTiles; ++j) {
      float* q = p + j * 8 * pow_pitch;
      const float* re = acc[0][j];
      const float* im = acc[1][j];
      q[0] = re[0] * re[0] + im[0] * im[0];
      q[pow_pitch] = re[1] * re[1] + im[1] * im[1];
      q[8] = re[2] * re[2] + im[2] * im[2];
      q[pow_pitch + 8] = re[3] * re[3] + im[3] * im[3];
    }
  }
  __syncthreads();

  // out^T = mel^T power^T: a task is 16 mel bands x 32 frames.
  const int m_tiles = (n_mels + 15) / 16;
  const int bin_steps = bins / 8;
  for (int task = warp; task < m_tiles * kGroups; task += warps) {
    const int mt = task / kGroups, fg = task % kGroups;
    const int2 range = mel_steps[mt];
    float macc[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) macc[j][i] = 0.f;
    const float4* ma = mel + (long long)mt * bin_steps * 64 + lane;
    const float* pb = s_pow + (fg * 32 + g) * pow_pitch + t;
    float4 nh = make_float4(0.f, 0.f, 0.f, 0.f), nl = nh;
    if (range.x < range.y) {
      nh = __ldg(ma + range.x * 64);
      nl = __ldg(ma + range.x * 64 + 32);
    }
    for (int ks = range.x; ks < range.y; ++ks) {
      uint32_t m_hi[4], m_lo[4];
      as_u32(m_hi, nh);
      as_u32(m_lo, nl);
      if (ks + 1 < range.y) {  // the next step's fragments in flight
        nh = __ldg(ma + (ks + 1) * 64);
        nl = __ldg(ma + (ks + 1) * 64 + 32);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float* p = pb + j * 8 * pow_pitch + ks * 8;
        mma_3xtf32(macc[j], m_hi, m_lo, split_b(p[0], p[4]));
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int f = f0 + fg * 32 + j * 8 + 2 * t;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = mt * 16 + g + (i >> 1) * 8, fi = f + (i & 1);
        if (m < n_mels && fi < frames_per_row)
          out[((long long)row * frames_per_row + fi) * n_mels + m] =
              logf(macc[j][i] + 1e-6f);
      }
    }
  }
}

template <int kFrames>
int launch(const float* wave, const float4* dft, const float4* mel,
           const int2* mel_steps, float* out, int rows, long long row_stride,
           int frames_per_row, int n_fft, int hop, int n_bins, int n_mels,
           cudaStream_t stream) {
  const int warps = (n_bins + 15) / 16;
  const int skew = skew_for(hop);
  const int run = (kFrames - 1) * hop + n_fft;
  const int wave_floats = run + ((run - 1) / hop) * skew;
  const int pow_floats = kFrames * (warps * 16 + 4);
  const int region = (max(wave_floats, pow_floats) + 3) / 4 * 4;
  const size_t smem = (size_t)region * 4 + 2 * (size_t)warps * 128 * 16;
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  auto kernel = log_mel_kernel<kFrames>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int frame_blocks = (frames_per_row + kFrames - 1) / kFrames;
  const bool vec16 = (uintptr_t)wave % 16 == 0 && row_stride % 4 == 0;
  kernel<<<rows * frame_blocks, warps * 32, smem, stream>>>(
      wave, dft, mel, mel_steps, out, row_stride, frames_per_row,
      frame_blocks, n_fft, hop, skew, n_mels, region, vec16);
  return (int)cudaGetLastError();
}

// Frames a block takes: 96 or 64, whichever leaves the fewest frame slots
// in whole waves of one block an SM, and 64 on a tie (measured faster at
// 16 x 2998, where both fill 384 slots): 4 x 2998 frames take 96 (128
// blocks, one wave of 132 SMs), one 30 s row 64 (47 blocks).
int frame_tile(int rows, int frames_per_row) {
  const long long sms = tethys::sm_count();
  long long best = 0;
  int tile = 64;
  for (int f : {96, 64}) {
    const long long blocks = (long long)rows * ((frames_per_row + f - 1) / f);
    const long long slots = (blocks + sms - 1) / sms * f;
    if (best == 0 || slots <= best) best = slots, tile = f;
  }
  return tile;
}

}  // namespace

// wave: the waveform's first sample; frame f of row r, tap k is
// wave[r * row_stride + f * hop + k].  dft [ceil(n_bins / 16),
// ceil((n_fft / 2 + 1) / 8), 4, 32, 4] (folded taps) and mel [ceil(n_mels / 16), 2 ceil(n_bins / 16), 2, 32, 4] f32 in
// fragment order, mel_steps [ceil(n_mels / 16), 2] int32 (audio/logmel.py
// _kernel_operands) -> out [rows, frames_per_row, n_mels] f32.  n_fft and
// hop multiples of 8, n_bins <= 256.
TETHYS_EXPORT int tethys_log_mel(const void* wave, const void* dft,
                                 const void* mel, const void* mel_steps,
                                 void* out, int rows, long long row_stride,
                                 int frames_per_row, int n_fft, int hop,
                                 int n_bins, int n_mels, void* stream) {
  if (rows <= 0 || frames_per_row <= 0 || n_fft <= 0 || hop <= 0 ||
      n_fft % 8 || hop % 8 || n_bins <= 0 || n_bins > 16 * kMaxWarps ||
      n_mels <= 0)
    return (int)cudaErrorInvalidValue;
  auto go = frame_tile(rows, frames_per_row) == 96 ? launch<96> : launch<64>;
  return go((const float*)wave, (const float4*)dft, (const float4*)mel,
            (const int2*)mel_steps, (float*)out, rows, row_stride,
            frames_per_row, n_fft, hop, n_bins, n_mels,
            (cudaStream_t)stream);
}

// The message for an error code the C functions return.
TETHYS_EXPORT const char* tethys_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
