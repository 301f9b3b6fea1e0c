// Counter-based Philox4x32-10 (Salmon et al., "Parallel random numbers:
// as easy as 1, 2, 3", SC'11), the dropout bits of the port.
//
// The TPU kernels seeded the core's PRNG per block, so their masks depended
// on the tiling.  Here the keep bit of an element is a pure function of
// (seed, flat element index n):
//
//   bits(seed, n) = philox4x32_10(counter = n / 4, key = (seed, 0))[n % 4]
//   keep          = bits >= threshold,  threshold = uint32(rate * 2^32)
//
// with the 64-bit counter in the first two counter words.  The dropout
// kernel indexes its flat input, the flash kernels the [B*H, Tq, Tk]
// probability matrix ((bh * Tq + row) * Tk + col), so a backward pass
// regenerates its forward's mask from the seed alone, and the plain torch
// version (ops/dropout.py) computes the same bits.
#pragma once

#include <stdint.h>

namespace tethys {

constexpr uint32_t kPhiloxM0 = 0xD2511F53u;
constexpr uint32_t kPhiloxM1 = 0xCD9E8D57u;
constexpr uint32_t kPhiloxW0 = 0x9E3779B9u;
constexpr uint32_t kPhiloxW1 = 0xBB67AE85u;

__device__ __forceinline__ uint4 philox4x32_10(uint64_t counter,
                                               uint32_t seed) {
  uint32_t c0 = (uint32_t)counter, c1 = (uint32_t)(counter >> 32);
  uint32_t c2 = 0, c3 = 0;
  uint32_t k0 = seed, k1 = 0;
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    const uint32_t lo0 = kPhiloxM0 * c0, hi0 = __umulhi(kPhiloxM0, c0);
    const uint32_t lo1 = kPhiloxM1 * c2, hi1 = __umulhi(kPhiloxM1, c2);
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
    k0 += kPhiloxW0;
    k1 += kPhiloxW1;
  }
  return make_uint4(c0, c1, c2, c3);
}

__device__ __forceinline__ uint32_t philox_lane(const uint4& r, int lane) {
  return lane == 0 ? r.x : lane == 1 ? r.y : lane == 2 ? r.z : r.w;
}

// Keep bits of the kN <= 32 consecutive elements n0 .. n0 + kN - 1 (bit e
// for element n0 + e): kN / 4 Philox calls when n0 % 4 == 0, else one more.
template <int kN>
__device__ __forceinline__ uint32_t keep_bits(uint64_t n0, uint32_t seed,
                                              uint32_t threshold) {
  static_assert(kN % 4 == 0 && kN <= 32, "whole Philox outputs, one word");
  uint32_t bits = 0;
  if ((n0 & 3) == 0) {  // whole counters: lane i of call c is bit 4c + i
#pragma unroll
    for (int c = 0; c < kN / 4; ++c) {
      const uint4 r = philox4x32_10((n0 >> 2) + c, seed);
      bits |= ((uint32_t)(r.x >= threshold) | (uint32_t)(r.y >= threshold) << 1 |
               (uint32_t)(r.z >= threshold) << 2 | (uint32_t)(r.w >= threshold) << 3)
              << (4 * c);
    }
    return bits;
  }
  const uint64_t last = (n0 + kN - 1) >> 2;
#pragma unroll 1
  for (uint64_t c = n0 >> 2; c <= last; ++c) {
    const uint4 r = philox4x32_10(c, seed);
#pragma unroll
    for (int lane = 0; lane < 4; ++lane) {
      const long long e = (long long)(4 * c + lane) - (long long)n0;
      if (e >= 0 && e < kN && philox_lane(r, lane) >= threshold)
        bits |= 1u << e;
    }
  }
  return bits;
}

}  // namespace tethys
