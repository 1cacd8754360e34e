// Helpers shared by filters.cu, fused_filters.cu and post.cuh: strided
// planes, libjxl's Mirror() and edge clamping, and the exact
// FastLinearToSRGB exponent trick of the sRGB output (host and device: CPU
// tests build them with g++).

#pragma once

#include <math.h>
#include <stdint.h>

#if defined(__CUDACC__)
#include <cuda_runtime.h>
#define JXL_CUNROLL _Pragma("unroll")
#else
// a host build (the CPU tests): the qualifiers mean nothing there
#include <string.h>
#define __host__
#define __device__
#define __forceinline__ inline
#define JXL_CUNROLL
#endif

namespace jxl {

struct Planes {
  const float* p;
  long long plane_stride;  // elements between channels
  int row_stride;          // elements between rows
};

// libjxl Mirror(): -1 -> 0, -2 -> 1, n -> n - 1 (numpy "symmetric"),
// repeated for reaches wider than the plane.
__host__ __device__ __forceinline__ int mirror(int i, int n) {
  while ((unsigned)i >= (unsigned)n) i = i < 0 ? -i - 1 : 2 * n - 1 - i;
  return i;
}

__host__ __device__ __forceinline__ int clampi(int i, int n) {
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

struct SrgbParams {
  float m[9];          // opsin inverse, row-major
  float cbrt_bias, bias;
  float scale;         // 255 or 65535
  uint32_t mul[16];    // FastLinearToSRGB exponent multipliers
};

__host__ __device__ __forceinline__ uint32_t bits_of(float v) {
#if defined(__CUDA_ARCH__)
  return __float_as_uint(v);
#else
  uint32_t u;
  memcpy(&u, &v, 4);
  return u;
#endif
}

__host__ __device__ __forceinline__ float float_of(uint32_t u) {
#if defined(__CUDA_ARCH__)
  return __uint_as_float(u);
#else
  float v;
  memcpy(&v, &u, 4);
  return v;
#endif
}

// tpu_real.fast_linear_to_srgb_device: the exact exponent bit trick;
// mul: the 16 exponent multipliers.
__host__ __device__ __forceinline__ float fast_linear_to_srgb(
    float v, const uint32_t* mul) {
  const uint32_t vb = bits_of(v);
  const float v025 = float_of((vb | 0x3e800000u) & 0x3effffffu);
  const float d1 = v025 * 0.059914046f + -0.108894556f;
  const float d2 = d1 * v025 + 0.107963754f;
  const float pw = d2 * v025 + 0.018092343f;
  const uint32_t e = ((vb >> 23) - 118u) & 0xfu;
  return v < 0.0031308f ? v * 12.92f : pw * float_of(mul[e]) + -0.055f;
}

// XYB -> linear -> sRGB codes of one pixel, clip(floor(srgb * scale +
// 0.5), 0, scale) per channel (the real-format output of tpu_real /
// filters_pallas _srgb_out, same op order), with the multiplier table at
// `mul` (s.mul, or a copy in shared memory).
__host__ __device__ __forceinline__ void xyb_to_srgb_codes(
    float X, float Y, float B, const SrgbParams& s, const uint32_t* mul,
    float q[3]) {
  const float gr = Y + X + s.cbrt_bias;
  const float gg = Y - X + s.cbrt_bias;
  const float gb = B + s.cbrt_bias;
  const float ml = gr * gr * gr - s.bias;
  const float mm = gg * gg * gg - s.bias;
  const float ms = gb * gb * gb - s.bias;
JXL_CUNROLL
  for (int c = 0; c < 3; ++c) {
    const float v = s.m[3 * c] * ml + s.m[3 * c + 1] * mm + s.m[3 * c + 2] * ms;
    const float r = floorf(fast_linear_to_srgb(v, mul) * s.scale + 0.5f);
    q[c] = fminf(fmaxf(r, 0.0f), s.scale);
  }
}

}  // namespace jxl
