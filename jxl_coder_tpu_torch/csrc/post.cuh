// The output encoding A7 (post.cu encode_output_kernel) and its pooled
// variant S1 (pool_output_kernel) as __host__ __device__ functions: the
// kernels run them on the card, and a CPU test builds this header with g++
// and runs their walks thread by thread against the plain twin
// (vardct/post.py encode_output_plain).
//
// A launch encodes one output spec, chosen on the host (dispatch): the
// kind (sRGB, gamma, a signalled encoding, YCbCr), the transfer function
// and whether a gamut matrix applies are template arguments, so each
// instantiation is straight-line code whose constants are read at fixed
// offsets of the launch's parameters, and a spec without a gamut matrix
// runs no identity product (as the twin).  The arithmetic is the twin's,
// operation by operation: full-precision powf / logf / sqrtf and IEEE
// division, -fmad=false on the card and -ffp-contract=off on the host.
//
// A7's walk: on a frame that fills the card's threads at 4 pixels a
// thread, a thread encodes kPix = 4 adjacent pixels of a row (their independent chains
// interleaved), else one (pixels_a_thread).  Where the planes start on a
// 16-byte boundary with row and plane strides a multiple of 4 floats, a
// 4-pixel thread reads each plane's values in one 16-byte load, else one
// value at a time (a cropped view, an odd stride); where the width is a
// multiple of 4 its 12 codes go out as whole words (3 x 4 bytes at u8, 3
// x 8 at u16), else one code at a time (a ragged row's last group takes
// the scalar path on both sides).  S1's
// walk: a thread an output pixel, the mean of its down x down cell (the
// last row and column repeated past the edge, summed row by row).

#pragma once

#include "common.cuh"

#if defined(__CUDACC__)
#define JXL_PHD __host__ __device__ __forceinline__
#define JXL_PHOST __host__ inline
#define JXL_PUNROLL _Pragma("unroll")
#else
#define JXL_PHD static inline
#define JXL_PHOST static inline
#define JXL_PUNROLL
#endif

namespace jxl_post {

using jxl::SrgbParams;

// prm, as vardct/post.py _output_params lays it out
enum {
  P_EXP = 0,     // gamma, or the HLG inverse OOTF's exponent (1 - g) / g
  P_DISP = 1,    // 255 / intensity_target
  P_GM = 2,      // the 3x3 gamut matrix, row-major (identity when none)
  P_LUMA = 11,   // the luma weights of the signalled primaries
  P_HLG = 14,    // HLG a, b, c
  P_PQ = 17,     // PQ m1, m2, c1, c2, c3
  P_SRGB_E = 22, P_BT709_E = 23, P_DCI_E = 24, P_TWELFTH = 25,
  P_PQ_SCALE = 26,  // 255 / 10000
  N_PRM = 27
};

// the spec's kind (vardct/post.py KIND)
enum { K_SRGB = 0, K_GAMMA = 1, K_ENC = 2, K_YCBCR = 3 };
// the transfer functions with a case of their own (headers.
// TransferFunction); any other encodes as sRGB (T_SRGB)
enum { T_BT709 = 1, T_LINEAR = 8, T_SRGB = 13, T_PQ = 16, T_DCI = 17,
       T_HLG = 18 };

struct OutParams {
  float maxv;        // 2^bits - 1
  float prm[N_PRM];
  SrgbParams srgb;   // kind 0: the multipliers are read from a copy
};

constexpr int kPix = 4;    // adjacent pixels a thread on a large frame (A7)
static_assert(kPix % 4 == 0, "a thread's pixels are whole 16-byte loads");
constexpr int kGX = 32;    // threads across a block
constexpr int kGY = 8;     // rows a block

JXL_PHD int imin(int a, int b) { return a < b ? a : b; }

JXL_PHD float sgn(float v) {
  return (float)((v > 0.0f) - (v < 0.0f));
}

// LINEAR_TO_TRC.get(trc, linear_to_srgb) of ops/color.py on v >= 0
template <int TRC>
JXL_PHD float linear_to_trc(float v, const OutParams& p) {
  if constexpr (TRC == T_LINEAR) {
    return v;
  } else if constexpr (TRC == T_BT709) {
    return v < 0.018f ? v * 4.5f
                      : 1.099f * powf(v, p.prm[P_BT709_E]) - 0.099f;
  } else if constexpr (TRC == T_PQ) {
    const float q = powf(v, p.prm[P_PQ]);
    return powf((p.prm[P_PQ + 2] + p.prm[P_PQ + 3] * q) /
                    (1.0f + p.prm[P_PQ + 4] * q),
                p.prm[P_PQ + 1]);
  } else if constexpr (TRC == T_DCI) {
    return powf(v, p.prm[P_DCI_E]);
  } else if constexpr (TRC == T_HLG) {
    return v <= p.prm[P_TWELFTH]
               ? sqrtf(3.0f * v)
               : p.prm[P_HLG] *
                         logf(fmaxf(12.0f * v - p.prm[P_HLG + 1], 1e-12f)) +
                     p.prm[P_HLG + 2];
  } else {
    return v <= 0.0031308f ? v * 12.92f
                           : 1.055f * powf(v, p.prm[P_SRGB_E]) - 0.055f;
  }
}

// one pixel's XYB (the YCbCr kind: Cb, Y, Cr) -> its three codes,
// clip(floor(v * maxv + 0.5)); mul: the sRGB multipliers (kind 0)
template <int KIND, int TRC, bool GM>
JXL_PHD void encode_pixel(float X, float Y, float B, const OutParams& p,
                          const uint32_t* mul, float q[3]) {
  if constexpr (KIND == K_SRGB) {
    jxl::xyb_to_srgb_codes(X, Y, B, p.srgb, mul, q);
    return;
  } else {
    float enc[3];
    if constexpr (KIND == K_YCBCR) {
      // (Cb, Y, Cr): the f32 values of 128 / 255 and of BT.601's constants
      const float yp = Y + 0.501960814f;
      enc[0] = yp + 1.40199995f * B;
      enc[1] = (yp - 0.344136f * X) - 0.714136004f * B;
      enc[2] = yp + 1.77199996f * X;
    } else {
      const SrgbParams& s = p.srgb;
      const float gr = Y + X + s.cbrt_bias;
      const float gg = Y - X + s.cbrt_bias;
      const float gb = B + s.cbrt_bias;
      const float ml = gr * gr * gr - s.bias;
      const float mm = gg * gg * gg - s.bias;
      const float ms = gb * gb * gb - s.bias;
      float lin[3];
      JXL_PUNROLL
      for (int c = 0; c < 3; ++c)
        lin[c] = s.m[3 * c] * ml + s.m[3 * c + 1] * mm + s.m[3 * c + 2] * ms;
      if constexpr (KIND == K_GAMMA) {
        JXL_PUNROLL
        for (int c = 0; c < 3; ++c)
          enc[c] = powf(fmaxf(lin[c], 0.0f), p.prm[P_EXP]);
      } else {
        float l[3];
        JXL_PUNROLL
        for (int c = 0; c < 3; ++c)
          l[c] = GM ? p.prm[P_GM + 3 * c] * lin[0] +
                          p.prm[P_GM + 3 * c + 1] * lin[1] +
                          p.prm[P_GM + 3 * c + 2] * lin[2]
                    : lin[c];
        if constexpr (TRC == T_HLG) {
          float d[3];
          JXL_PUNROLL
          for (int c = 0; c < 3; ++c) d[c] = l[c] * p.prm[P_DISP];
          const float yd = p.prm[P_LUMA] * d[0] + p.prm[P_LUMA + 1] * d[1] +
                           p.prm[P_LUMA + 2] * d[2];
          const float f = yd > 1e-9f ? powf(fabsf(yd), p.prm[P_EXP]) : 0.0f;
          JXL_PUNROLL
          for (int c = 0; c < 3; ++c) {
            const float sc = d[c] * f;
            enc[c] = sgn(sc) * linear_to_trc<T_HLG>(fminf(fabsf(sc), 1.0f), p);
          }
        } else {
          JXL_PUNROLL
          for (int c = 0; c < 3; ++c)
            enc[c] = sgn(l[c]) *
                     linear_to_trc<TRC>(TRC == T_PQ
                                            ? fabsf(l[c]) * p.prm[P_PQ_SCALE]
                                            : fabsf(l[c]),
                                        p);
        }
      }
    }
    JXL_PUNROLL
    for (int c = 0; c < 3; ++c)
      q[c] = fminf(fmaxf(floorf(enc[c] * p.maxv + 0.5f), 0.0f), p.maxv);
  }
}

// ---- the launch's plan ----

// whether A7's threads read each plane's kPix values in one 16-byte load
JXL_PHOST bool vector_loads(const float* in, long long plane, long long row) {
  return (uintptr_t)in % 16 == 0 && plane % 4 == 0 && row % 4 == 0;
}

// whether they store their codes as whole words
JXL_PHOST bool vector_stores(const void* out, int W) {
  return W % kPix == 0 && (uintptr_t)out % 16 == 0;
}

// A7's pixels a thread: kPix where the frame fills the card's resident
// threads (sms x 2048) at kPix pixels a thread, else 1 (a small frame
// keeps more threads in flight to hide each pixel's latency)
JXL_PHOST int pixels_a_thread(int H, int W, int sms) {
  return (long long)H * W >= (long long)kPix * sms * 2048 ? kPix : 1;
}

// the launch's parameters from the wrapper's host arrays (prm: N_PRM
// floats; srgb: the opsin inverse (9), the cube-root bias and the bias;
// mul: the 16 FastLinearToSRGB multipliers); true where the gamut
// matrix is not the identity
JXL_PHOST bool out_params(int bits, const float* prm, const float* srgb,
                        const uint32_t* mul, OutParams& p) {
  p.maxv = (float)((1 << bits) - 1);
  JXL_PUNROLL
  for (int i = 0; i < N_PRM; ++i) p.prm[i] = prm[i];
  JXL_PUNROLL
  for (int i = 0; i < 9; ++i) p.srgb.m[i] = srgb[i];
  p.srgb.cbrt_bias = srgb[9];
  p.srgb.bias = srgb[10];
  p.srgb.scale = p.maxv;
  JXL_PUNROLL
  for (int i = 0; i < 16; ++i) p.srgb.mul[i] = mul[i];
  bool gm = false;
  JXL_PUNROLL
  for (int i = 0; i < 9; ++i)
    gm = gm || prm[P_GM + i] != (i % 4 == 0 ? 1.0f : 0.0f);
  return gm;
}

template <class OutT, class R>
JXL_PHOST int dispatch_enc(int trc, bool gm, R& r) {
  switch (trc) {
    case T_BT709:
      return gm ? r.template run<OutT, K_ENC, T_BT709, true>()
                : r.template run<OutT, K_ENC, T_BT709, false>();
    case T_LINEAR:
      return gm ? r.template run<OutT, K_ENC, T_LINEAR, true>()
                : r.template run<OutT, K_ENC, T_LINEAR, false>();
    case T_PQ:
      return gm ? r.template run<OutT, K_ENC, T_PQ, true>()
                : r.template run<OutT, K_ENC, T_PQ, false>();
    case T_DCI:
      return gm ? r.template run<OutT, K_ENC, T_DCI, true>()
                : r.template run<OutT, K_ENC, T_DCI, false>();
    case T_HLG:
      return gm ? r.template run<OutT, K_ENC, T_HLG, true>()
                : r.template run<OutT, K_ENC, T_HLG, false>();
    default:
      return gm ? r.template run<OutT, K_ENC, T_SRGB, true>()
                : r.template run<OutT, K_ENC, T_SRGB, false>();
  }
}

template <class OutT, class R>
JXL_PHOST int dispatch_kind(int kind, int trc, bool gm, R& r) {
  switch (kind) {
    case K_SRGB:
      return r.template run<OutT, K_SRGB, T_SRGB, false>();
    case K_GAMMA:
      return r.template run<OutT, K_GAMMA, T_SRGB, false>();
    case K_ENC:
      return dispatch_enc<OutT>(trc, gm, r);
    case K_YCBCR:
      return r.template run<OutT, K_YCBCR, T_SRGB, false>();
    default:
      return -1;
  }
}

// calls r.template run<OutT, KIND, TRC, GM>() for the spec (bits <= 8:
// u8 codes, else u16); -1 for a kind it does not know
template <class R>
JXL_PHOST int dispatch(int kind, int trc, bool gm, int bits, R& r) {
  return bits <= 8 ? dispatch_kind<uint8_t>(kind, trc, gm, r)
                   : dispatch_kind<uint16_t>(kind, trc, gm, r);
}

// ---- the walks ----

JXL_PHD void load4(const float* src, float v[4]) {
#if defined(__CUDA_ARCH__)
  const float4 t = __ldg(reinterpret_cast<const float4*>(src));
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
#else
  memcpy(v, src, 16);
#endif
}

// PIX pixels' codes as whole words at dst, which the caller has aligned:
// 3 PIX / 4 words of 4 bytes (u8), 3 PIX / 4 of 8 (u16)
template <int PIX>
JXL_PHD void store_group(uint8_t* dst, const float (&q)[PIX][3]) {
  constexpr int kW = 3 * PIX / 4;
  uint32_t w[kW];
  JXL_PUNROLL
  for (int k = 0; k < kW; ++k) {
    w[k] = 0;
    JXL_PUNROLL
    for (int b = 0; b < 4; ++b)
      w[k] |= (uint32_t)q[(4 * k + b) / 3][(4 * k + b) % 3] << (8 * b);
  }
#if defined(__CUDA_ARCH__)
  JXL_PUNROLL
  for (int k = 0; k < kW; ++k) reinterpret_cast<uint32_t*>(dst)[k] = w[k];
#else
  memcpy(dst, w, 4 * kW);
#endif
}

template <int PIX>
JXL_PHD void store_group(uint16_t* dst, const float (&q)[PIX][3]) {
  constexpr int kW = 3 * PIX / 2;
  uint32_t w[kW];
  JXL_PUNROLL
  for (int k = 0; k < kW; ++k)
    w[k] = (uint32_t)q[(2 * k) / 3][(2 * k) % 3] |
           (uint32_t)q[(2 * k + 1) / 3][(2 * k + 1) % 3] << 16;
#if defined(__CUDA_ARCH__)
  JXL_PUNROLL
  for (int k = 0; k < kW / 2; ++k)
    reinterpret_cast<uint2*>(dst)[k] = make_uint2(w[2 * k], w[2 * k + 1]);
#else
  memcpy(dst, w, 4 * kW);
#endif
}

// A7: group g (pixels PIX g ...) of row y of the (3, H, W) planes; PIX is
// kPix or 1 (pixels_a_thread), the vector paths kPix's
template <int PIX, class OutT, int KIND, int TRC, bool GM>
JXL_PHD void encode_group(const float* in, long long plane, long long row,
                          OutT* out, int W, int y, int g, bool vin,
                          bool vout, const OutParams& p,
                          const uint32_t* mul) {
  const int x0 = g * PIX;
  const int n = imin(PIX, W - x0);
  const float* src = in + (long long)y * row + x0;
  float v[3][PIX];
  if (PIX % 4 == 0 && vin && n == PIX) {
    JXL_PUNROLL
    for (int c = 0; c < 3; ++c)
      JXL_PUNROLL
      for (int j = 0; j < PIX; j += 4) load4(src + c * plane + j, v[c] + j);
  } else {
    JXL_PUNROLL
    for (int c = 0; c < 3; ++c)
      JXL_PUNROLL
      for (int j = 0; j < PIX; ++j)
        v[c][j] = j < n ? src[c * plane + j] : 0.0f;
  }
  float q[PIX][3];
  JXL_PUNROLL
  for (int j = 0; j < PIX; ++j)
    encode_pixel<KIND, TRC, GM>(v[0][j], v[1][j], v[2][j], p, mul, q[j]);
  OutT* dst = out + ((long long)y * W + x0) * 3;
  bool words = false;
  if constexpr (PIX % 4 == 0) {
    words = vout && n == PIX;
    if (words) store_group<PIX>(dst, q);
  }
  if (!words) {
    for (int j = 0; j < n; ++j)
      JXL_PUNROLL
      for (int c = 0; c < 3; ++c) dst[3 * j + c] = (OutT)q[j][c];
  }
}

// S1: output pixel (x, y) of the (ceil(H / down), ceil(W / down)) codes
template <class OutT, int KIND, int TRC, bool GM>
JXL_PHD void encode_pooled(const float* in, long long plane, long long row,
                           OutT* out, int H, int W, int down, int x, int y,
                           const OutParams& p, const uint32_t* mul) {
  const int Wo = (W + down - 1) / down;
  float sx = 0.0f, sy = 0.0f, sb = 0.0f;
  for (int dy = 0; dy < down; ++dy) {
    const long long r = (long long)imin(y * down + dy, H - 1) * row;
    for (int dx = 0; dx < down; ++dx) {
      const long long o = r + imin(x * down + dx, W - 1);
      sx = sx + in[o];
      sy = sy + in[plane + o];
      sb = sb + in[2 * plane + o];
    }
  }
  const float n = (float)(down * down);
  float q[3];
  encode_pixel<KIND, TRC, GM>(sx / n, sy / n, sb / n, p, mul, q);
  OutT* dst = out + ((long long)y * Wo + x) * 3;
  JXL_PUNROLL
  for (int c = 0; c < 3; ++c) dst[c] = (OutT)q[c];
}

}  // namespace jxl_post
