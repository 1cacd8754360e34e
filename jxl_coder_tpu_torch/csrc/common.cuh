// Helpers shared by filters.cu and fused_filters.cu: strided planes,
// libjxl's Mirror() and edge clamping (host and device: a CPU test builds
// them with g++), and the exact FastLinearToSRGB exponent trick of the
// sRGB output.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

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

// tpu_real.fast_linear_to_srgb_device: the exact exponent bit trick;
// mul: the 16 exponent multipliers.
__device__ __forceinline__ float fast_linear_to_srgb(float v,
                                                     const uint32_t* mul) {
  const uint32_t vb = __float_as_uint(v);
  const float v025 = __uint_as_float((vb | 0x3e800000u) & 0x3effffffu);
  const float d1 = v025 * 0.059914046f + -0.108894556f;
  const float d2 = d1 * v025 + 0.107963754f;
  const float pw = d2 * v025 + 0.018092343f;
  const uint32_t e = ((vb >> 23) - 118u) & 0xfu;
  return v < 0.0031308f ? v * 12.92f : pw * __uint_as_float(mul[e]) + -0.055f;
}

// XYB -> linear -> sRGB codes of one pixel, clip(floor(srgb * scale +
// 0.5), 0, scale) per channel (the real-format output of tpu_real /
// filters_pallas _srgb_out, same op order), with the multiplier table at
// `mul` (s.mul, or a copy in shared memory).
__device__ __forceinline__ void xyb_to_srgb_codes(float X, float Y, float B,
                                                  const SrgbParams& s,
                                                  const uint32_t* mul,
                                                  float q[3]) {
  const float gr = Y + X + s.cbrt_bias;
  const float gg = Y - X + s.cbrt_bias;
  const float gb = B + s.cbrt_bias;
  const float ml = gr * gr * gr - s.bias;
  const float mm = gg * gg * gg - s.bias;
  const float ms = gb * gb * gb - s.bias;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float v = s.m[3 * c] * ml + s.m[3 * c + 1] * mm + s.m[3 * c + 2] * ms;
    const float r = floorf(fast_linear_to_srgb(v, mul) * s.scale + 0.5f);
    q[c] = fminf(fmaxf(r, 0.0f), s.scale);
  }
}

}  // namespace jxl
