// Kernel A10's program (compose.cu): the arithmetic of one composed pixel
// and the row walk of a block, as __host__ __device__ functions.  The
// kernel runs them on the card; a CPU test builds this header with g++,
// runs every block's phases over its threads one after another, and holds
// the canvas to the JAX package's numpy composition
// (jxl_coder_tpu/api.py:821-961, _compose_frame).
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
//   - a grey image has one colour channel (NC).
// Nothing is indexed at run time outside memory: the colour's channels
// and a launch's extra channels are compile-time counts (NC, and NE at
// least the launch's ng), each extra channel's blending is read at a
// constant offset of the launch's Params, and the background alphas' codes
// sit packed in two registers, read by a shift.  A u8 code's value / 255
// is a table of the 256 divisions (the same IEEE quotients); codes become
// float64 and float64 become codes by exact bit arithmetic (dbl, to_code),
// not by conversion instructions.

#pragma once

#include <math.h>
#include <stdint.h>
#include <string.h>

#if defined(__CUDACC__)
#define JXL_CHD __host__ __device__ __forceinline__
#define JXL_CHD_MEMBER __host__ __device__ __forceinline__
#define JXL_CUNROLL _Pragma("unroll")
#else
#define JXL_CHD static inline
#define JXL_CHD_MEMBER inline
#define JXL_CUNROLL
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
  double rcp;               // 1 / maxv
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
  p->rcp = 1.0 / maxv;
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

// the instantiation that blends ng extra channels: 2 (none, alpha, alpha
// and depth) or 8
JXL_CHD int ne_of(int ng) { return ng <= 2 ? 2 : kMaxExtra; }

JXL_CHD double clip_unit(double v) { return v < 0.0 ? 0.0 : (v > 1.0 ? 1.0 : v); }

// a code as a float64, exactly: the bits of 2^52 + v, less 2^52 (one
// integer or and one addition, no conversion instruction)
JXL_CHD double dbl(unsigned v) {
  const int64_t bits = 0x4330000000000000ll | (int64_t)v;
  double d;
  memcpy(&d, &bits, 8);
  return d - 4503599627370496.0;
}

// np.clip(np.rint(v), 0, maxv) for T's maxv: v + 1.5 * 2^52 rounds v to an
// integer, half to even, as rint does (|v| < 2^51; every value here is
// under 2^18), and its low 32 bits are that integer
template <typename T>
JXL_CHD T to_code(double v) {
  const double t = v + 6755399441055744.0;
  int64_t bits;
  memcpy(&bits, &t, 8);
  const int r = (int)(int32_t)(uint32_t)(uint64_t)bits;
  const int maxi = (int)(T)~0u;
  return (T)(r < 0 ? 0 : (r > maxi ? maxi : r));
}

// code / maxv, the IEEE quotient: from the table of the 256 for u8 (lut),
// else the product by 1 / maxv corrected by one fused residual step, which
// gives the quotient for every 16-bit code (the CPU test checks all 65,536)
template <typename T>
JXL_CHD double unit(T v, const Params& p, const double* lut) {
  if (lut != nullptr) return lut[v];
  const double d = dbl(v), q = d * p.rcp;
  return fma(fma(-q, p.maxv, d), p.rcp, q);
}

// the background alphas' codes of a launch that blends every channel, up
// to kMaxExtra of them, 16 bits each in two words: read by a shift at the
// alpha channel's index, so nothing is indexed at run time
struct Alphas {
  uint64_t lo, hi;
  JXL_CHD_MEMBER unsigned at(int a) const {
    return (unsigned)((a < 4 ? lo >> (16 * a) : hi >> (16 * (a - 4))) &
                      0xFFFFu);
  }
};

// the blend of the launch's colour and extra channels on one pixel, in
// place on dst (its nch values; src the frame's).  bg: the pixel's canvas
// values before this frame's blend, whose alpha channels BLEND reads;
// nullptr when this launch blends every channel (n_ec <= kMaxExtra), which
// reads them from dst on entry.  NC is p.ncolor and NE >= p.ng.
template <typename T, int NC, int NE>
JXL_CHD void compose_pixel(const T* src, T* dst, const T* bg, const Params& p,
                           const double* lut) {
  const double maxv = p.maxv;
  Alphas ba0{0, 0};
  if (bg == nullptr) {
    JXL_CUNROLL
    for (int k = 0; k < NE; ++k) {
      if (k >= p.ng) break;
      const uint64_t c = dst[NC + k];
      if (k < 4)
        ba0.lo |= c << (16 * k);
      else
        ba0.hi |= c << (16 * (k - 4));
    }
  }
  // the background alpha a
  auto back = [&](int a) {
    return unit<T>(bg != nullptr ? bg[NC + a] : (T)ba0.at(a), p, lut);
  };
  const Blend& cb = p.colour;
  // the colour channels
  if (p.colour_on) {
    if (cb.mode == kReplace) {
      JXL_CUNROLL
      for (int c = 0; c < NC; ++c) dst[c] = src[c];
    } else if (cb.mode == kAdd) {
      JXL_CUNROLL
      for (int c = 0; c < NC; ++c)
        dst[c] = to_code<T>(dbl(src[c]) + dbl(dst[c]));
    } else if (cb.mode == kBlend) {
      double fa = unit(src[NC + cb.alpha], p, lut);
      const double ba = back(cb.alpha);
      if (cb.clamp) fa = clip_unit(fa);
      const double na = fa + ba * (1.0 - fa);
      JXL_CUNROLL
      for (int c = 0; c < NC; ++c) {
        const double s = dbl(src[c]), d = dbl(dst[c]);
        const double out =
            cb.assoc ? s + d * (1.0 - fa)
                     : (na > 0.0 ? (s * fa + d * (ba * (1.0 - fa))) / na : 0.0);
        dst[c] = to_code<T>(out);
      }
      dst[NC + cb.alpha] = to_code<T>(na * maxv);
    } else if (cb.mode == kAlphaWeightedAdd) {
      double fa = unit(src[NC + cb.alpha], p, lut);
      if (cb.clamp) fa = clip_unit(fa);
      JXL_CUNROLL
      for (int c = 0; c < NC; ++c)
        dst[c] = to_code<T>(dbl(dst[c]) + dbl(src[c]) * fa);
    } else {  // kMul
      JXL_CUNROLL
      for (int c = 0; c < NC; ++c) {
        double sc = dbl(src[c]);
        if (cb.clamp) sc = sc < 0.0 ? 0.0 : (sc > maxv ? maxv : sc);
        dst[c] = to_code<T>(sc * dbl(dst[c]) / maxv);
      }
    }
  }
  // this launch's extra channels, each by its own blending
  JXL_CUNROLL
  for (int k = 0; k < NE; ++k) {
    if (k >= p.ng) break;
    const int i = p.g0 + k, e = NC + i;
    const Blend& b = p.ec[k];
    if (cb.mode == kBlend && cb.alpha == i && b.mode == kBlend) continue;
    const double s = dbl(src[e]), d = dbl(dst[e]);
    double v = 0.0;
    if (b.mode == kReplace) {
      dst[e] = src[e];
      continue;
    } else if (b.mode == kAdd) {
      v = s + d;
    } else if (b.mode == kBlend) {
      double fa = unit(src[NC + b.alpha], p, lut);
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
      double fa = unit(src[NC + b.alpha], p, lut);
      if (b.clamp) fa = clip_unit(fa);
      v = d + s * fa;
    } else {  // kMul
      double se = s;
      if (b.clamp) se = se < 0.0 ? 0.0 : (se > maxv ? maxv : se);
      v = se * d / maxv;
    }
    dst[e] = to_code<T>(v);
  }
}

// ---- the row walk -------------------------------------------------------
//
// A block takes a segment of px pixels of each of `rows` window rows (a
// whole row when it fits kSegBytes, then as many rows as fit).  Phases:
//   load: the segment's bytes of the frame, of the canvas (and of the
//     background copy) into shared memory, 16-byte vectors from the
//     aligned address at or before the segment's first byte, each row its
//     own slot;
//   blend: a pixel a thread, compose_pixel on the staged values, in place
//     in the canvas's slot;
//   store: the canvas slot back, a 16-byte store for each vector inside the
//     segment and the bytes of the segment one at a time in the partial
//     vectors at its two ends, so that no byte outside the window (nor
//     outside the segment: its neighbours belong to other blocks) is
//     written.
// Reads of a partial vector's other bytes stay inside the allocation (its
// 16-byte granule); their values are never used.  Persistent blocks that
// take segments in turn, the next one's loads in flight (cp.async into two
// buffers), ran 37% slower on an H100 80GB HBM3 than a block a segment.

constexpr int kThreads = 256;
constexpr int kSegBytes = 4096;   // a staged segment's canvas bytes, at most
constexpr int kMaxRows = 32;      // window rows a block, at most
constexpr int kLutBytes = 256 * 8;

JXL_CHD int round16(int n) { return (n + 15) & ~15; }

struct Geo {
  int px;      // pixels of a segment: a multiple of 16, or the window's width
  int rows;    // window rows a block
  int nseg;    // segments of a row
  int slot;    // bytes of a staged segment's slot (16-byte vectors)
  int nbuf;    // staged arrays: frame, canvas (and the background copy)
  int lut;     // the u8 table's bytes in front of the slots (0 for u16)
};

JXL_CHD Geo geo_of(int cw, int ch, int pxb, bool bg, bool u8) {
  Geo g;
  g.px = kSegBytes / pxb / 16 * 16;
  if (g.px < 16) g.px = 16;
  g.rows = 1;
  if (g.px >= cw) {
    g.px = cw;
    g.rows = kSegBytes / (cw * pxb);
    if (g.rows > kMaxRows) g.rows = kMaxRows;
    if (g.rows > ch) g.rows = ch;
    if (g.rows < 1) g.rows = 1;
  }
  g.nseg = (cw + g.px - 1) / g.px;
  // a vector straddling each end: one more than the segment's bytes need
  g.slot = round16(g.px * pxb) + 16;
  g.nbuf = bg ? 3 : 2;
  g.lut = u8 ? kLutBytes : 0;
  return g;
}

JXL_CHD int shared_bytes(const Geo& g) {
  return g.lut + g.nbuf * g.rows * g.slot;
}

// a 16-byte copy: one vector load or store on the card
JXL_CHD void copy16(void* dst, const void* src) {
#if defined(__CUDA_ARCH__)
  *static_cast<uint4*>(dst) = *static_cast<const uint4*>(src);
#else
  memcpy(dst, src, 16);
#endif
}

// One launch's program.  canvas: (H, canvas_w, nch) of T; src: (h, src_w,
// nch); bg: the window's canvas values before the first launch, (ch, cw,
// nch), or null; the window: the frame's pixels from (sx, sy) go to the
// canvas from (dx, dy), cw x ch of them.
template <typename T, int NC, int NE>
struct Walk {
  T* canvas;
  const T* src;
  const T* bg;
  int canvas_w, src_w, sx, sy, dx, dy, cw, ch;
  Params p;
  Geo g;

  // row r of block (seg, rb): the window row, its first pixel and count
  JXL_CHD_MEMBER bool row(int seg, int rb, int r, int& y, int& x0,
                          int& n) const {
    y = rb * g.rows + r;
    x0 = seg * g.px;
    n = cw - x0 < g.px ? cw - x0 : g.px;
    return r < g.rows && y < ch;
  }

  // array j's bytes of row y from pixel x0 on: the frame's, the canvas's
  // or the background copy's
  JXL_CHD_MEMBER const char* start(int j, int y, int x0) const {
    const long long pxb = (long long)p.nch * sizeof(T);
    if (j == 0)
      return (const char*)src + ((long long)(sy + y) * src_w + sx + x0) * pxb;
    if (j == 1)
      return (const char*)canvas +
             ((long long)(dy + y) * canvas_w + dx + x0) * pxb;
    return (const char*)bg + ((long long)y * cw + x0) * pxb;
  }

  JXL_CHD_MEMBER char* slot(char* s, int j, int r) const {
    return s + g.lut + (j * g.rows + r) * g.slot;
  }

  // the u8 table, and the staged vectors of every array and row
  JXL_CHD_MEMBER void load(int k, int seg, int rb, char* s) const {
    if (g.lut && k < 256) ((double*)s)[k] = (double)k / p.maxv;
    const int vps = g.slot / 16, pxb = p.nch * (int)sizeof(T);
    for (int idx = k; idx < g.rows * vps; idx += kThreads) {
      const int r = g.rows == 1 ? 0 : idx / vps, v = idx - r * vps;
      int y, x0, n;
      if (!row(seg, rb, r, y, x0, n)) continue;
      for (int j = 0; j < g.nbuf; ++j) {
        const char* a = start(j, y, x0);
        const char* a0 = (const char*)((uintptr_t)a & ~(uintptr_t)15);
        if (a0 + 16 * v < a + n * pxb) copy16(slot(s, j, r) + 16 * v, a0 + 16 * v);
      }
    }
  }

  JXL_CHD_MEMBER void blend(int k, int seg, int rb, char* s) const {
    const int pxb = p.nch * (int)sizeof(T);
    const double* lut = g.lut ? (const double*)s : nullptr;
    for (int idx = k; idx < g.rows * g.px; idx += kThreads) {
      const int r = g.rows == 1 ? 0 : idx / g.px, i = idx - r * g.px;
      int y, x0, n;
      if (!row(seg, rb, r, y, x0, n) || i >= n) continue;
      // the pixel in each slot: past the slot's misalignment
      auto at = [&](int j) {
        return slot(s, j, r) + ((uintptr_t)start(j, y, x0) & 15) + i * pxb;
      };
      compose_pixel<T, NC, NE>((const T*)at(0), (T*)at(1),
                               g.nbuf == 3 ? (const T*)at(2) : nullptr, p,
                               lut);
    }
  }

  JXL_CHD_MEMBER void store(int k, int seg, int rb, char* s) const {
    const int vps = g.slot / 16, pxb = p.nch * (int)sizeof(T);
    for (int idx = k; idx < g.rows * vps; idx += kThreads) {
      const int r = g.rows == 1 ? 0 : idx / vps, v = idx - r * vps;
      int y, x0, n;
      if (!row(seg, rb, r, y, x0, n)) continue;
      char* a = (char*)start(1, y, x0);
      char* end = a + n * pxb;
      char* b0 = (char*)((uintptr_t)a & ~(uintptr_t)15) + 16 * v;
      if (b0 >= end) continue;
      const char* q = slot(s, 1, r) + 16 * v;
      if (b0 >= a && b0 + 16 <= end) {
        copy16(b0, q);
      } else {
        for (int e = 0; e < 16; ++e)
          if (b0 + e >= a && b0 + e < end) b0[e] = q[e];
      }
    }
  }

  // the block's phases in order; each(f) runs f for every thread of the
  // block, then a barrier (the host's test runs every block's phase before
  // any block's next, so f keeps copies of what it reads)
  template <typename Each>
  JXL_CHD_MEMBER void run(int seg, int rb, char* s, Each each) const {
    each([this, seg, rb, s](int k) { load(k, seg, rb, s); });
    each([this, seg, rb, s](int k) { blend(k, seg, rb, s); });
    each([this, seg, rb, s](int k) { store(k, seg, rb, s); });
  }
};

}  // namespace jxl_blend
