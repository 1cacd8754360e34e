// The arithmetic of one pixel of the ICC -> sRGB step (icc.cu), as a
// __host__ __device__ function: the kernel runs it on the card, and a CPU
// test builds this header with g++ and holds it to the plain twin
// (ops/icc_apply.py transform_plain) and to littlecms.
//
// icc_pixel is littlecms's 8-bit matrix-shaper program (cmsopt.c
// MatShaperEval16) over the tables host/ops/icc.py plan builds as littlecms
// builds them: each channel's code through its input shaper (1.14 fixed
// point, 0x7fffffff where the curve reaches 131072), the 3x3 matrix in 1.14
// fixed point with its rounding ((sum + 0x2000) >> 14, the sum wrapping in
// int32 as littlecms's does), a clamp to [0, 16384], then the output
// shaper's 8-bit sRGB code.
//
// clut_pixel is littlecms's 8-bit CLUT program (cmsopt.c PrelinEval8) over
// the tables host/ops/icc_lut.py builds: each channel's code to its grid
// node (an offset into the CLUT) and its 16-bit fraction, through the
// prelinearisation curves where littlecms has them; tetrahedral
// interpolation on the 33^3 16-bit CLUT with littlecms's fixed-point
// rounding (Rest + 0x8001, then (Rest + (Rest >> 16)) >> 16, in int32);
// FROM_16_TO_8 on output.  Integers only, so the codes are the twin's and
// littlecms's exactly.

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

constexpr int kGrid = 33;                        // the CLUT's points per axis
constexpr int kOpta2 = 3 * kGrid * kGrid;        // red's stride
constexpr int kOpta1 = 3 * kGrid;                // green's
constexpr int kClutWords = 6 * 256;  // int32 node offsets, then fractions
constexpr int kClutValues = kGrid * kGrid * kGrid * 3;  // uint16 after them

// int32 arithmetic as two's complement wraps it (littlecms's sums)
JXL_ICC_HD int32_t wrap_add(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a + (uint32_t)b);
}
JXL_ICC_HD int32_t wrap_mul(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a * (uint32_t)b);
}

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
    int32_t l = wrap_add(wrap_add(wrap_add(wrap_mul(m[3 * i], r),
                                           wrap_mul(m[3 * i + 1], g)),
                                  wrap_mul(m[3 * i + 2], b)),
                         0x2000) >>
                14;
    l = l < 0 ? 0 : (l > 16384 ? 16384 : l);
    const unsigned c = shaper2[l];
    dst[i] = (T)(sizeof(T) == 1 ? c : ((c << 8) | c));
  }
  if (C == 4) dst[3] = src[3];
}

// src: the pixel's C samples (C 1, 3 or 4); dst: its 3 (C 1) or C outputs.
// offs / fracs: each channel's 256 node offsets and fractions (red, green,
// blue); lut: the CLUT, red the slowest axis.
template <typename T, int C>
JXL_ICC_HD void clut_pixel(const T* src, T* dst, const int32_t* offs,
                           const int32_t* fracs, const uint16_t* lut) {
  constexpr unsigned kShift = sizeof(T) == 1 ? 0 : 8;
  const unsigned c0 = (unsigned)src[0] >> kShift;
  const unsigned c1 = C == 1 ? c0 : (unsigned)src[1] >> kShift;
  const unsigned c2 = C == 1 ? c0 : (unsigned)src[2] >> kShift;
  const int32_t X0 = offs[c0], Y0 = offs[256 + c1], Z0 = offs[512 + c2];
  const int32_t rx = fracs[c0], ry = fracs[256 + c1], rz = fracs[512 + c2];
  const int32_t X1 = X0 + (rx == 0 ? 0 : kOpta2);
  const int32_t Y1 = Y0 + (ry == 0 ? 0 : kOpta1);
  const int32_t Z1 = Z0 + (rz == 0 ? 0 : 3);
  // PrelinEval8's six tetrahedra, tested in its order: the corners after
  // the first and second steps from (X0, Y0, Z0) to (X1, Y1, Z1), and the
  // fraction of the axis each step moves along (the products are littlecms's
  // c1 * rx + c2 * ry + c3 * rz, summed in another order: int32 wraps alike)
  int32_t a, b, r1, r2, r3;
  if (rx >= ry && ry >= rz) {
    a = X1 + Y0 + Z0, b = X1 + Y1 + Z0, r1 = rx, r2 = ry, r3 = rz;
  } else if (rx >= rz && rz >= ry) {
    a = X1 + Y0 + Z0, b = X1 + Y0 + Z1, r1 = rx, r2 = rz, r3 = ry;
  } else if (rz >= rx && rx >= ry) {
    a = X0 + Y0 + Z1, b = X1 + Y0 + Z1, r1 = rz, r2 = rx, r3 = ry;
  } else if (ry >= rx && rx >= rz) {
    a = X0 + Y1 + Z0, b = X1 + Y1 + Z0, r1 = ry, r2 = rx, r3 = rz;
  } else if (ry >= rz && rz >= rx) {
    a = X0 + Y1 + Z0, b = X0 + Y1 + Z1, r1 = ry, r2 = rz, r3 = rx;
  } else {
    a = X0 + Y0 + Z1, b = X0 + Y1 + Z1, r1 = rz, r2 = ry, r3 = rx;
  }
  const int32_t o = X0 + Y0 + Z0, e = X1 + Y1 + Z1;
  for (int ch = 0; ch < 3; ++ch) {
    const int32_t v0 = lut[o + ch], va = lut[a + ch], vb = lut[b + ch],
                  ve = lut[e + ch];
    const int32_t rest = wrap_add(
        wrap_add(wrap_add(wrap_mul(va - v0, r1), wrap_mul(vb - va, r2)),
                 wrap_mul(ve - vb, r3)),
        0x8001);
    const unsigned w =
        (unsigned)(v0 + (wrap_add(rest, rest >> 16) >> 16)) & 0xFFFFu;
    const unsigned c = ((w * 65281u + 8388608u) >> 24) & 0xFFu;
    dst[ch] = (T)(sizeof(T) == 1 ? c : ((c << 8) | c));
  }
  if (C == 4) dst[3] = src[3];
}

}  // namespace jxl_icc
