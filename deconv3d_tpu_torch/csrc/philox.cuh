// Philox4x32-10 (Salmon et al., SC'11) — the sweeps' counter-based random
// bits, bit-identical to deconv3d_tpu_torch/ops/philox.py.
//
// Counter layout (see ops/philox.py):
//   key     = (chain key low word, chain key high word)
//   counter = (lambda >> 2, absolute sweep, color, stream << 24 | spaxel row)
// word (lambda & 3) of the block is the uniform of wavelength lambda in
// streams 0 (MH jump), 2 and 3 (exact-Gibbs Box-Muller u1, u2); word 0 of
// the stream-1 block at lambda = 0 is the MH accept uniform.
#pragma once

#include <cstdint>

namespace deconv3d {

constexpr uint32_t kPhiloxM0 = 0xD2511F53u;
constexpr uint32_t kPhiloxM1 = 0xCD9E8D57u;
constexpr uint32_t kPhiloxW0 = 0x9E3779B9u;
constexpr uint32_t kPhiloxW1 = 0xBB67AE85u;
constexpr uint32_t kStreamJump = 0u;
constexpr uint32_t kStreamAccept = 1u;
constexpr uint32_t kStreamNormalU1 = 2u;
constexpr uint32_t kStreamNormalU2 = 3u;

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0,
                                               uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += kPhiloxW0;
      k1 += kPhiloxW1;
    }
    const uint32_t hi0 = __umulhi(kPhiloxM0, c.x);
    const uint32_t lo0 = kPhiloxM0 * c.x;
    const uint32_t hi1 = __umulhi(kPhiloxM1, c.z);
    const uint32_t lo1 = kPhiloxM1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

// (2k+1) * 2^-24 with k the top 23 bits: exact in float32, in (0, 1),
// never 0.5, symmetric about 0.5.
__device__ __forceinline__ float bits_to_uniform(uint32_t bits) {
  return (2.0f * static_cast<float>(bits >> 9) + 1.0f) * 5.9604644775390625e-08f;
}

__device__ __forceinline__ float lambda_uniform(uint32_t k0, uint32_t k1,
                                                uint32_t sweep, uint32_t color,
                                                uint32_t ij, uint32_t lam,
                                                uint32_t stream) {
  const uint4 w = philox4x32_10(
      make_uint4(lam >> 2, sweep, color, (stream << 24) | ij), k0, k1);
  const uint32_t word = (lam & 3u) == 0u ? w.x
                      : (lam & 3u) == 1u ? w.y
                      : (lam & 3u) == 2u ? w.z
                                         : w.w;
  return bits_to_uniform(word);
}

__device__ __forceinline__ float jump_uniform(uint32_t k0, uint32_t k1,
                                              uint32_t sweep, uint32_t color,
                                              uint32_t ij, uint32_t lam) {
  return lambda_uniform(k0, k1, sweep, color, ij, lam, kStreamJump);
}

__device__ __forceinline__ float accept_uniform(uint32_t k0, uint32_t k1,
                                                uint32_t sweep, uint32_t color,
                                                uint32_t ij) {
  const uint4 w = philox4x32_10(
      make_uint4(0u, sweep, color, (kStreamAccept << 24) | ij), k0, k1);
  return bits_to_uniform(w.x);
}

}  // namespace deconv3d
