// The arithmetic of one composed pixel (kernel A10, compose.cu), as a
// __host__ __device__ function: the kernel runs it on the card, and a CPU
// test builds this header with g++ and holds it to the JAX package's numpy
// composition (jxl_coder_tpu/api.py:821-961, _compose_frame).
//
// Every value is a float64, every operation is the reference's, in its
// order (the build has no FMA contraction), and each code is rint (half to
// even), then clipped to [0, maxv]: so the codes are the reference's.  Three
// details decide them:
//   - every blend reads the background alpha from before this frame's
//     blend (the reference's _ba0 snapshot), whatever an earlier channel
//     of the pixel wrote;
//   - an extra channel that the colour's BLEND already wrote (its alpha,
//     when its own mode is BLEND too) is skipped; any other mode of it
//     reads the value that BLEND wrote;
//   - a grey image has one colour channel (ncolor).

#pragma once

#include <math.h>
#include <stdint.h>

#if defined(__CUDACC__)
#define JXL_CHD __host__ __device__ __forceinline__
#else
#define JXL_CHD static inline
#endif

namespace jxl_blend {

constexpr int kMaxExtra = 8;
constexpr int kMaxChannels = 3 + kMaxExtra;

// BlendMode of the frame header
enum { kReplace = 0, kAdd = 1, kBlend = 2, kAlphaWeightedAdd = 3, kMul = 4 };

struct Blend {
  int mode, alpha, clamp;   // BlendingInfo's mode, alpha_channel, clamp
};

struct Params {
  int nch, ncolor, n_ec;    // channels of a pixel: colour, then extra
  double maxv;              // 255 or 65535
  Blend colour;
  Blend ec[kMaxExtra];
  int assoc[kMaxExtra];     // extra channel i's alpha_associated
};

JXL_CHD double clip_unit(double v) { return v < 0.0 ? 0.0 : (v > 1.0 ? 1.0 : v); }

// np.clip(np.rint(v), 0, maxv)
JXL_CHD double to_code(double v, double maxv) {
  const double r = rint(v);
  return r < 0.0 ? 0.0 : (r > maxv ? maxv : r);
}

// src, dst: the pixel's nch values in the frame and on the canvas; dst is
// updated in place.
template <typename T>
JXL_CHD void compose_pixel(const T* src, T* dst, const Params& p) {
  double s[kMaxChannels], d[kMaxChannels], ba0[kMaxExtra];
  for (int c = 0; c < p.nch; ++c) {
    s[c] = (double)src[c];
    d[c] = (double)dst[c];
  }
  for (int i = 0; i < p.n_ec; ++i) ba0[i] = d[p.ncolor + i] / p.maxv;
  const double maxv = p.maxv;
  const Blend& cb = p.colour;
  // the colour channels
  if (cb.mode == kReplace) {
    for (int c = 0; c < p.ncolor; ++c) d[c] = s[c];
  } else if (cb.mode == kAdd) {
    for (int c = 0; c < p.ncolor; ++c) d[c] = to_code(s[c] + d[c], maxv);
  } else if (cb.mode == kBlend) {
    double fa = s[p.ncolor + cb.alpha] / maxv;
    const double ba = ba0[cb.alpha];
    if (cb.clamp) fa = clip_unit(fa);
    const double na = fa + ba * (1.0 - fa);
    double out[3];
    for (int c = 0; c < p.ncolor; ++c) {
      if (p.assoc[cb.alpha])
        out[c] = s[c] + d[c] * (1.0 - fa);
      else
        out[c] = na > 0.0 ? (s[c] * fa + d[c] * (ba * (1.0 - fa))) / na : 0.0;
    }
    d[p.ncolor + cb.alpha] = to_code(na * maxv, maxv);
    for (int c = 0; c < p.ncolor; ++c) d[c] = to_code(out[c], maxv);
  } else if (cb.mode == kAlphaWeightedAdd) {
    double fa = s[p.ncolor + cb.alpha] / maxv;
    if (cb.clamp) fa = clip_unit(fa);
    for (int c = 0; c < p.ncolor; ++c) d[c] = to_code(d[c] + s[c] * fa, maxv);
  } else {  // kMul
    for (int c = 0; c < p.ncolor; ++c) {
      double sc = s[c];
      if (cb.clamp) sc = sc < 0.0 ? 0.0 : (sc > maxv ? maxv : sc);
      d[c] = to_code(sc * d[c] / maxv, maxv);
    }
  }
  // the extra channels, each by its own blending
  for (int i = 0; i < p.n_ec; ++i) {
    const int e = p.ncolor + i;
    const Blend& b = p.ec[i];
    if (cb.mode == kBlend && cb.alpha == i && b.mode == kBlend) continue;
    if (b.mode == kReplace) {
      d[e] = s[e];
    } else if (b.mode == kAdd) {
      d[e] = to_code(s[e] + d[e], maxv);
    } else if (b.mode == kBlend) {
      double fa = s[p.ncolor + b.alpha] / maxv;
      const double ba = ba0[b.alpha];
      if (b.clamp) fa = clip_unit(fa);
      if (b.alpha == i) {
        // the alpha channel itself: source-over coverage
        d[e] = to_code((fa + ba * (1.0 - fa)) * maxv, maxv);
      } else if (p.assoc[b.alpha]) {
        d[e] = to_code(s[e] + d[e] * (1.0 - fa), maxv);
      } else {
        const double na = fa + ba * (1.0 - fa);
        d[e] = to_code(na > 0.0 ? (s[e] * fa + d[e] * ba * (1.0 - fa)) / na : 0.0,
                       maxv);
      }
    } else if (b.mode == kAlphaWeightedAdd) {
      double fa = s[p.ncolor + b.alpha] / maxv;
      if (b.clamp) fa = clip_unit(fa);
      d[e] = to_code(d[e] + s[e] * fa, maxv);
    } else {  // kMul
      double se = s[e];
      if (b.clamp) se = se < 0.0 ? 0.0 : (se > maxv ? maxv : se);
      d[e] = to_code(se * d[e] / maxv, maxv);
    }
  }
  for (int c = 0; c < p.nch; ++c) dst[c] = (T)d[c];
}

}  // namespace jxl_blend
