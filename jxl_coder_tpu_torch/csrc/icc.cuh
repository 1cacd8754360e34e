// The arithmetic of one pixel of the ICC -> sRGB step (icc.cu), as a
// __host__ __device__ function: the kernel runs it on the card, and a CPU
// test builds this header with g++ and holds it to the plain twin
// (ops/icc_apply.py transform_plain) and to littlecms.
//
// It is littlecms's 8-bit matrix-shaper program (cmsopt.c MatShaperEval16)
// over the tables host/ops/icc.py plan builds as littlecms builds them:
// each channel's code through its input shaper (1.14 fixed point), the
// 3x3 matrix in 1.14 fixed point with its rounding ((sum + 0x2000) >> 14
// in int32; the host checks that the sums stay in int32), a clamp to
// [0, 16384], then the output shaper's 8-bit sRGB code.  Integers only, so
// the codes are the twin's and littlecms's exactly.

#pragma once

#include <stdint.h>

#if defined(__CUDACC__)
#define JXL_ICC_HD __host__ __device__ __forceinline__
#else
#define JXL_ICC_HD static inline
#endif

namespace jxl_icc {

constexpr int kShaper1 = 3 * 256;   // int32 input shapers
constexpr int kMatrix = 9;          // int32, after them
constexpr int kWords = 780;         // the int32 part, padded
constexpr int kShaper2 = 16385;     // uint8 output shaper, after the words
constexpr int kShaper2Padded = 16388;

// src: the pixel's C samples (C 1, 3 or 4); dst: its 3 (C 1) or C outputs.
// A 16-bit sample goes through its top byte and comes out as (c << 8) | c;
// a fourth channel (alpha) is copied.
template <typename T, int C>
JXL_ICC_HD void icc_pixel(const T* src, T* dst, const int32_t* shaper1,
                          const int32_t* m, const uint8_t* shaper2) {
  constexpr unsigned kShift = sizeof(T) == 1 ? 0 : 8;
  const unsigned c0 = (unsigned)src[0] >> kShift;
  const unsigned c1 = C == 1 ? c0 : (unsigned)src[1] >> kShift;
  const unsigned c2 = C == 1 ? c0 : (unsigned)src[2] >> kShift;
  const int32_t r = shaper1[c0], g = shaper1[256 + c1], b = shaper1[512 + c2];
  for (int i = 0; i < 3; ++i) {
    int32_t l = (m[3 * i] * r + m[3 * i + 1] * g + m[3 * i + 2] * b + 0x2000) >>
                14;
    l = l < 0 ? 0 : (l > 16384 ? 16384 : l);
    const unsigned c = shaper2[l];
    dst[i] = (T)(sizeof(T) == 1 ? c : ((c << 8) | c));
  }
  if (C == 4) dst[3] = src[3];
}

}  // namespace jxl_icc
