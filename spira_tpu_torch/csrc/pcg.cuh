// PCG4D counter hash (Jarzynski & Olano, JCGT 2020) on native uint32_t.
//
// Bit-identical to spira_tpu_torch/core/pcg.py and spira_tpu/core/pcg.py:
// every draw is a pure function of (pixel, sample, stream, seed).
#pragma once

#include <cstdint>

namespace spira {

// float32(2*pi), the constant the Python tracers multiply by.
constexpr float kTwoPi = 6.28318548202514648f;

__device__ __forceinline__ void pcg4d(uint32_t& a, uint32_t& b, uint32_t& c,
                                      uint32_t& d) {
  a = a * 1664525u + 1013904223u;
  b = b * 1664525u + 1013904223u;
  c = c * 1664525u + 1013904223u;
  d = d * 1664525u + 1013904223u;
  a += b * d;
  b += c * a;
  c += a * b;
  d += b * c;
  a ^= a >> 16;
  b ^= b >> 16;
  c ^= c >> 16;
  d ^= d >> 16;
  a += b * d;
  b += c * a;
  c += a * b;
  d += b * c;
}

// Top 24 bits times 2^-24: exact in float32, in [0, 1).
__device__ __forceinline__ float to_uniform(uint32_t bits) {
  return static_cast<float>(static_cast<int>(bits >> 8)) * (1.0f / 16777216.0f);
}

struct Uniform4 {
  float x, y, z, w;
};

__device__ __forceinline__ Uniform4 uniform4(uint32_t pixel, uint32_t sample,
                                             uint32_t stream, uint32_t seed) {
  uint32_t a = pixel, b = sample, c = stream, d = seed;
  pcg4d(a, b, c, d);
  return {to_uniform(a), to_uniform(b), to_uniform(c), to_uniform(d)};
}

// Two standard normals from two uniforms (precise logf/sqrtf/cosf/sinf).
__device__ __forceinline__ void box_muller(float u1, float u2, float& g1,
                                           float& g2) {
  const float r = sqrtf(-2.0f * logf(fmaxf(u1, 1e-10f)));
  const float theta = kTwoPi * u2;
  g1 = r * cosf(theta);
  g2 = r * sinf(theta);
}

}  // namespace spira
