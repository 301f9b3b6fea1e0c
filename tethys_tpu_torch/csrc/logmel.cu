// Fused window-DFT -> power -> mel -> log for framed audio.
//
// Replaces tethys_tpu/audio/pallas_logmel.py::_kernel (launched by
// fused_log_mel).  Framing stays outside the kernel, as there; each block
// takes FRAMES frames and computes
//   re = frames @ cos, im = frames @ sin      (Hann window folded in)
//   power = re^2 + im^2
//   out = log(power @ mel + 1e-6)
// without writing re, im or power to device memory.
//
// What bounds it on an H100: arithmetic.  Per frame it does 2 * n_fft *
// n_bins + n_bins * n_mels multiply-adds (about 177k at 400 taps, 201 bins,
// 80 mels) against 1.6 KB read, so it is far above the memory roofline.
// The TPU kernel split every product into three bf16 passes because the MXU
// rounds f32 operands; Hopper's FP32 units need no split, so the products
// are plain f32 FFMA (no TF32, no bf16).  The design keeps the DFT as a
// register-tiled matrix product: 256 threads = 8 frame groups x 32 bin
// lanes, each thread holding 4 frames x ceil(n_bins/32) bins of re and im
// in registers, with taps streamed through shared memory TAPS at a time.
// The power tile then reuses the same shared memory for the mel product.
// Rows past n_rows are masked in the kernel, so the caller pads nothing.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kFrames = 32;             // frames per block
constexpr int kTaps = 16;               // taps per shared-memory step
constexpr int kGroups = kThreads / 32;  // frame groups (one per warp)
constexpr int kFramesPerThread = kFrames / kGroups;
constexpr int kMaxBinSteps = 8;         // bins per lane: up to 256 bins

__global__ void __launch_bounds__(kThreads)
    log_mel_kernel(const float* __restrict__ frames,
                   const float* __restrict__ cos_m,
                   const float* __restrict__ sin_m,
                   const float* __restrict__ mel_m, float* __restrict__ out,
                   int n_rows, int n_fft, int n_bins, int n_mels) {
  __shared__ float s_frames[kFrames][kTaps];
  // cos and sin chunks [kTaps][bin_pad] each; after the DFT the same space
  // holds the power tile [kFrames][bin_pad].
  __shared__ float s_cs[2 * kTaps * 32 * kMaxBinSteps];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int group = tid >> 5;
  const int bin_steps = (n_bins + 31) / 32;
  const int bin_pad = bin_steps * 32;
  const long long row0 = (long long)blockIdx.x * kFrames;
  float* s_cos = s_cs;
  float* s_sin = s_cs + kTaps * bin_pad;

  float re[kFramesPerThread][kMaxBinSteps];
  float im[kFramesPerThread][kMaxBinSteps];
#pragma unroll
  for (int i = 0; i < kFramesPerThread; ++i) {
#pragma unroll
    for (int j = 0; j < kMaxBinSteps; ++j) {
      re[i][j] = 0.f;
      im[i][j] = 0.f;
    }
  }

  for (int k0 = 0; k0 < n_fft; k0 += kTaps) {
    for (int e = tid; e < kFrames * kTaps; e += kThreads) {
      const int r = e / kTaps, c = e % kTaps;
      const long long row = row0 + r;
      const int tap = k0 + c;
      s_frames[r][c] = (row < n_rows && tap < n_fft)
                           ? frames[row * n_fft + tap]
                           : 0.f;
    }
    for (int e = tid; e < kTaps * bin_pad; e += kThreads) {
      const int c = e / bin_pad, bin = e % bin_pad;
      const int tap = k0 + c;
      const bool ok = tap < n_fft && bin < n_bins;
      s_cos[e] = ok ? cos_m[(long long)tap * n_bins + bin] : 0.f;
      s_sin[e] = ok ? sin_m[(long long)tap * n_bins + bin] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < kTaps; ++c) {
      float f[kFramesPerThread];
#pragma unroll
      for (int i = 0; i < kFramesPerThread; ++i)
        f[i] = s_frames[group * kFramesPerThread + i][c];
#pragma unroll
      for (int j = 0; j < kMaxBinSteps; ++j) {
        if (j < bin_steps) {
          const float cv = s_cos[c * bin_pad + lane + 32 * j];
          const float sv = s_sin[c * bin_pad + lane + 32 * j];
#pragma unroll
          for (int i = 0; i < kFramesPerThread; ++i) {
            re[i][j] = fmaf(f[i], cv, re[i][j]);
            im[i][j] = fmaf(f[i], sv, im[i][j]);
          }
        }
      }
    }
    __syncthreads();
  }

  float* s_pow = s_cs;  // [kFrames][bin_pad]; bins >= n_bins hold 0
#pragma unroll
  for (int i = 0; i < kFramesPerThread; ++i) {
#pragma unroll
    for (int j = 0; j < kMaxBinSteps; ++j) {
      if (j < bin_steps) {
        const int r = group * kFramesPerThread + i;
        s_pow[r * bin_pad + lane + 32 * j] =
            re[i][j] * re[i][j] + im[i][j] * im[i][j];
      }
    }
  }
  __syncthreads();

  for (int e = tid; e < kFrames * n_mels; e += kThreads) {
    const int r = e / n_mels, m = e % n_mels;
    const long long row = row0 + r;
    if (row >= n_rows) continue;
    float acc = 0.f;
    for (int b = 0; b < n_bins; ++b)
      acc = fmaf(s_pow[r * bin_pad + b], mel_m[(long long)b * n_mels + m], acc);
    out[row * n_mels + m] = logf(acc + 1e-6f);
  }
}

}  // namespace

// frames [n_rows, n_fft] f32, cos/sin [n_fft, n_bins] f32, mel [n_bins,
// n_mels] f32 -> out [n_rows, n_mels] f32.  n_bins <= 256.
TETHYS_EXPORT int tethys_log_mel(const void* frames, const void* cos_m,
                                 const void* sin_m, const void* mel_m,
                                 void* out, int n_rows, int n_fft, int n_bins,
                                 int n_mels, void* stream) {
  if (n_rows <= 0 || n_fft <= 0 || n_bins <= 0 || n_mels <= 0 ||
      n_bins > 32 * kMaxBinSteps)
    return (int)cudaErrorInvalidValue;
  const int blocks = (n_rows + kFrames - 1) / kFrames;
  log_mel_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)frames, (const float*)cos_m, (const float*)sin_m,
      (const float*)mel_m, (float*)out, n_rows, n_fft, n_bins, n_mels);
  return (int)cudaGetLastError();
}

// The message for an error code the C functions return.
TETHYS_EXPORT const char* tethys_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
