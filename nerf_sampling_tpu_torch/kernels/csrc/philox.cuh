// Counter-based Philox4x32-10 for the kernels' in-kernel draws (K3, K6).
//
// Replaces the TPU core's PRNG (pltpu.prng_seed / prng_random_bits in
// nerf_sampling_tpu/kernels/ops.py:493-513). A draw is a pure function of
// (key, counter): the kernels key it by (seed, global ray index), so a ray's
// draws depend neither on the block layout nor on the other rays, and no
// generator state lives in memory. kernels/philox.py reproduces every draw
// on the host (tested against the Random123 known-answer vectors).
#pragma once

#include <cstdint>

namespace nst {

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
  constexpr uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;
  constexpr uint32_t kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const uint32_t hi0 = __umulhi(kM0, c.x), lo0 = kM0 * c.x;
    const uint32_t hi1 = __umulhi(kM1, c.z), lo1 = kM1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
    k.x += kW0;
    k.y += kW1;
  }
  return c;
}

// [0, 1) from the top 24 bits of a word (exact in fp32).
__device__ __forceinline__ float uniform24(uint32_t x) {
  return (float)(x >> 8) * 5.9604644775390625e-08f;  // 2^-24
}

// Draw k of ray `ray` (K6's t_rand then u): word k % 4 of block k / 4.
__device__ __forceinline__ float hier_uniform(uint32_t seed, uint32_t ray, uint32_t k) {
  const uint4 w = philox4x32_10(make_uint4(k >> 2, 0u, 0u, 0u), make_uint2(seed, ray));
  const uint32_t lane = k & 3u;
  return uniform24(lane == 0 ? w.x : lane == 1 ? w.y : lane == 2 ? w.z : w.w);
}

// Standard normal s of ray `ray` (K3): Box-Muller over words 0 and 1 of
// block (s, 1), u1 kept off 0 by half a step. Accurate logf/sqrtf/cosf.
__device__ __forceinline__ float gaussian_normal(uint32_t seed, uint32_t ray, uint32_t s) {
  const uint4 w = philox4x32_10(make_uint4(s, 1u, 0u, 0u), make_uint2(seed, ray));
  const float u1 = uniform24(w.x) + 2.98023223876953125e-08f;  // + 2^-25
  const float u2 = uniform24(w.y);
  return sqrtf(-2.f * logf(u1)) * cosf(6.28318530717958647692f * u2);
}

}  // namespace nst
