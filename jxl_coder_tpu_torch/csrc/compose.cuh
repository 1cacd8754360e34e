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
//     of the pixel wrote: from the pixel on entry when one launch blends
//     every channel, else from a copy of the window made before the
//     first launch (more than kMaxExtra extra channels);
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

// extra channels a launch blends; more go in further launches, each its
// own group of up to kMaxExtra (the colour blended by the first), reading
// the background alpha from a copy of the window made before the first
constexpr int kMaxExtra = 8;

// BlendMode of the frame header
enum { kReplace = 0, kAdd = 1, kBlend = 2, kAlphaWeightedAdd = 3, kMul = 4 };

struct Blend {
  int mode, alpha, clamp;   // BlendingInfo's mode, alpha_channel, clamp
  int assoc;                // alpha_associated of its alpha channel
};

struct Params {
  int nch, ncolor, n_ec;    // channels of a pixel: colour, then extra
  double maxv;              // 255 or 65535
  int colour_on;            // this launch blends the colour channels
  Blend colour;
  int g0, ng;               // this launch's extra channels g0 .. g0 + ng - 1
  Blend ec[kMaxExtra];      // theirs
};

// The launch of extra channels from g0 on, from compose's int32
// parameters (ops/compose.py blend_params: nch, ncolor, n_ec, the colour's
// mode, alpha channel and clamp, then per extra channel its mode, alpha
// channel, clamp and alpha_associated); false when they do not fit.
JXL_CHD bool params_of(const int* ip, double maxv, int g0, Params* p) {
  p->nch = ip[0];
  p->ncolor = ip[1];
  p->n_ec = ip[2];
  if (p->n_ec < 0 || (p->ncolor != 1 && p->ncolor != 3) ||
      p->nch != p->ncolor + p->n_ec || g0 < 0 ||
      (g0 > 0 && g0 >= p->n_ec) || g0 % kMaxExtra)
    return false;
  p->maxv = maxv;
  const int n_ec = p->n_ec;
  auto blend = [ip, n_ec](int mode, int alpha, int clamp) {
    const int assoc = alpha >= 0 && alpha < n_ec ? ip[9 + 4 * alpha] : 0;
    return Blend{mode, alpha, clamp, assoc};
  };
  p->colour_on = g0 == 0;
  p->colour = blend(ip[3], ip[4], ip[5]);
  p->g0 = g0;
  p->ng = n_ec - g0 < kMaxExtra ? n_ec - g0 : kMaxExtra;
  for (int k = 0; k < kMaxExtra; ++k) {
    const int i = g0 + k;
    p->ec[k] = k < p->ng ? blend(ip[6 + 4 * i], ip[7 + 4 * i], ip[8 + 4 * i])
                         : Blend{0, 0, 0, 0};
  }
  return true;
}

JXL_CHD double clip_unit(double v) { return v < 0.0 ? 0.0 : (v > 1.0 ? 1.0 : v); }

// np.clip(np.rint(v), 0, maxv)
JXL_CHD double to_code(double v, double maxv) {
  const double r = rint(v);
  return r < 0.0 ? 0.0 : (r > maxv ? maxv : r);
}

// src, dst: the pixel's nch values in the frame and on the canvas; dst is
// updated in place: the colour channels when p.colour_on, then extra
// channels g0 .. g0 + ng - 1.  bg: the pixel's canvas values before this
// frame's blend, whose alpha channels BLEND reads; nullptr when this launch
// blends every channel (n_ec <= kMaxExtra), which reads them from dst on
// entry.
template <typename T>
JXL_CHD void compose_pixel(const T* src, T* dst, const T* bg,
                           const Params& p) {
  const double maxv = p.maxv;
  const int nc = p.ncolor;
  double ba0[kMaxExtra];
  if (bg == nullptr)
    for (int i = 0; i < p.n_ec && i < kMaxExtra; ++i)
      ba0[i] = (double)dst[nc + i] / maxv;
  auto back = [&](int a) {
    return bg != nullptr ? (double)bg[nc + a] / maxv : ba0[a];
  };
  const Blend& cb = p.colour;
  // the colour channels
  if (p.colour_on) {
    if (cb.mode == kReplace) {
      for (int c = 0; c < nc; ++c) dst[c] = src[c];
    } else if (cb.mode == kAdd) {
      for (int c = 0; c < nc; ++c)
        dst[c] = (T)to_code((double)src[c] + (double)dst[c], maxv);
    } else if (cb.mode == kBlend) {
      double fa = (double)src[nc + cb.alpha] / maxv;
      const double ba = back(cb.alpha);
      if (cb.clamp) fa = clip_unit(fa);
      const double na = fa + ba * (1.0 - fa);
      for (int c = 0; c < nc; ++c) {
        const double s = (double)src[c], d = (double)dst[c];
        const double out =
            cb.assoc ? s + d * (1.0 - fa)
                     : (na > 0.0 ? (s * fa + d * (ba * (1.0 - fa))) / na : 0.0);
        dst[c] = (T)to_code(out, maxv);
      }
      dst[nc + cb.alpha] = (T)to_code(na * maxv, maxv);
    } else if (cb.mode == kAlphaWeightedAdd) {
      double fa = (double)src[nc + cb.alpha] / maxv;
      if (cb.clamp) fa = clip_unit(fa);
      for (int c = 0; c < nc; ++c)
        dst[c] = (T)to_code((double)dst[c] + (double)src[c] * fa, maxv);
    } else {  // kMul
      for (int c = 0; c < nc; ++c) {
        double sc = (double)src[c];
        if (cb.clamp) sc = sc < 0.0 ? 0.0 : (sc > maxv ? maxv : sc);
        dst[c] = (T)to_code(sc * (double)dst[c] / maxv, maxv);
      }
    }
  }
  // this launch's extra channels, each by its own blending
  for (int k = 0; k < p.ng; ++k) {
    const int i = p.g0 + k, e = nc + i;
    const Blend& b = p.ec[k];
    if (cb.mode == kBlend && cb.alpha == i && b.mode == kBlend) continue;
    const double s = (double)src[e], d = (double)dst[e];
    double v = 0.0;
    if (b.mode == kReplace) {
      dst[e] = src[e];
      continue;
    } else if (b.mode == kAdd) {
      v = s + d;
    } else if (b.mode == kBlend) {
      double fa = (double)src[nc + b.alpha] / maxv;
      const double ba = back(b.alpha);
      if (b.clamp) fa = clip_unit(fa);
      if (b.alpha == i) {
        // the alpha channel itself: source-over coverage
        v = (fa + ba * (1.0 - fa)) * maxv;
      } else if (b.assoc) {
        v = s + d * (1.0 - fa);
      } else {
        const double na = fa + ba * (1.0 - fa);
        v = na > 0.0 ? (s * fa + d * ba * (1.0 - fa)) / na : 0.0;
      }
    } else if (b.mode == kAlphaWeightedAdd) {
      double fa = (double)src[nc + b.alpha] / maxv;
      if (b.clamp) fa = clip_unit(fa);
      v = d + s * fa;
    } else {  // kMul
      double se = s;
      if (b.clamp) se = se < 0.0 ? 0.0 : (se > maxv ? maxv : se);
      v = se * d / maxv;
    }
    dst[e] = (T)to_code(v, maxv);
  }
}

}  // namespace jxl_blend
