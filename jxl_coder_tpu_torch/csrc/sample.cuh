// S3's tile program (sample.cu's resample_kernel) as __host__ __device__
// functions: the kernel runs them on the card, and a CPU test builds this
// header with g++, runs every block's phases over its threads one after
// another, and holds the result to the dense twin.
//
// A block computes a tile of ty x tx output pixels of the kept rows and
// columns in one launch:
//   tables / window: the u8 units (a table of the 256), the tile's band
//     entries and weights into shared memory, and the input columns
//     [xw0, xw1) that its horizontal bands read (warp 0);
//   then for each chunk of cw input columns of that window:
//     vertical: the tile's ty rows over the chunk's columns into a float32
//       tile `tv` in shared memory, a unit (a pixel's C values up to 4
//       channels, else one value) a thread: its band's codes read from
//       device memory (the tile's other rows find them in L1), made units,
//       alpha premultiplied, summed in the band's order (fmaf, k
//       ascending);
//     horizontal: each output unit over the chunk's columns of its band,
//       continued from the last column chunk; after the last, alpha
//       divided out, clipped and rounded to its code in an output tile in
//       shared memory;
//   store: the output tile's rows to device memory by 16-byte stores, single
//     values at the ends.
// The sums are the two-pass kernel's they replace, in its order: each
// output equals it bit for bit.  Column chunks exist so that any plan fits
// in shared memory (a 240x downscale, a 4K-wide single output); the host's
// plan_tiles picks the sizes from the band widths so that the usual plans
// take one chunk.  Staging the input window in shared memory first (by
// 16-byte loads, units made once) was slower on an H100 (PERF.md §6):
// the extra phase and its shared memory cost more blocks an SM than the
// L1 re-reads it saves.

#pragma once

#include <stddef.h>
#include <stdint.h>
#include <string.h>

#if defined(__CUDACC__)
#define JXL_SHD __host__ __device__ __forceinline__
#define JXL_SHD_MEMBER __host__ __device__ __forceinline__
#define JXL_UNROLL _Pragma("unroll")
#else
#include <math.h>

#include <algorithm>
using std::max;
using std::min;
#define JXL_SHD static inline
#define JXL_SHD_MEMBER inline
#define JXL_UNROLL
#endif

namespace jxl_sample {

constexpr int kThreads = 256;
constexpr int kMaxTY = 16;           // output rows a block
constexpr int kMaxTX = 64;           // output columns a block
constexpr size_t kBudget = 48 * 1024;  // shared bytes a block: 4 an SM

// one pass's band: output o's weights w[o * stride + k], k < len[o], at
// input indices first[o] + k
struct Band {
  const int* first;
  const int* len;
  const float* w;
  int stride;
};

// the tile sizes: ty x tx output pixels a block; input chunks of cw
// columns
struct Tiles {
  int ty, tx, cw;
};

JXL_SHD size_t round16(size_t n) { return (n + 15) & ~(size_t)15; }

// the byte offsets of the shared arrays for a tile shape: the u8 units,
// the window, the tile's band entries (first and length of its rows, then
// of its columns), their weights (when they take at most kWeightBytes),
// tv, the horizontal sums between column chunks, the output tile
constexpr size_t kWeightBytes = 16 * 1024;

struct Layout {
  int cwe;       // values a row of tv: cw * C
  int outb;      // bytes a row of the output tile
  int wsm;       // the weights staged: vertical ty x vs, horizontal tx x hs
  size_t lut, part, band, wv, wh, tv, hacc, out, total;
};

JXL_SHD Layout layout_of(Tiles t, int C, int size, int vs, int hs) {
  Layout l;
  l.cwe = t.cw * C;
  l.outb = (int)round16((size_t)t.tx * C * size) + 16;
  const size_t wbytes = ((size_t)t.ty * vs + (size_t)t.tx * hs) * 4;
  l.wsm = wbytes <= kWeightBytes;
  l.lut = 0;
  l.part = l.lut + 256 * sizeof(float);
  l.band = l.part + 16;
  l.wv = l.band + 2 * (kMaxTY + kMaxTX) * sizeof(int);
  l.wh = l.wv + (l.wsm ? (size_t)t.ty * vs * 4 : 0);
  l.tv = round16(l.wh + (l.wsm ? (size_t)t.tx * hs * 4 : 0));
  l.hacc = l.tv + round16((size_t)t.ty * l.cwe * sizeof(float));
  l.out = l.hacc + round16((size_t)t.ty * t.tx * C * sizeof(float));
  l.total = l.out + (size_t)t.ty * l.outb;
  return l;
}

// The tile shape for a call: start at kMaxTY x kMaxTX (tx a power of
// two), estimate the input columns a tile reads from the horizontal band's
// width and the ratio W / cols (the plan's scale along x), halve ty then
// tx until tv holds the tile's window, then cut the window into chunks of
// fewer columns.  The estimate only sets the speed: the kernel computes
// each block's true window and loops over as many chunks as it needs.  A
// zero ty means that not even one sample of C channels fits.
JXL_SHD Tiles plan_tiles(int W, int C, int size, int rows, int cols,
                         int v_stride, int h_stride) {
  const double sx = (double)W / (cols > 0 ? cols : 1);
  int tx = 1;
  while (tx < cols && tx < kMaxTX) tx *= 2;
  Tiles t{min(kMaxTY, max(rows, 1)), tx, 1};
  auto fits = [&](Tiles x) {
    return layout_of(x, C, size, v_stride, h_stride).total <= kBudget;
  };
  for (;;) {
    const double span = (t.tx - 1) * sx + h_stride + 1;
    t.cw = max(1, (int)(span < W ? span : W));
    if (fits(t)) return t;
    if (t.ty > 4) {
      t.ty = (t.ty + 1) / 2;
    } else if (t.tx > 8) {
      t.tx /= 2;
    } else {
      break;
    }
  }
  while (!fits(t) && t.cw > 1) t.cw = (t.cw + 1) / 2;
  while (!fits(t) && t.ty > 1) t.ty = (t.ty + 1) / 2;
  while (!fits(t) && t.tx > 1) t.tx /= 2;
  if (!fits(t)) t.ty = 0;
  return t;
}

// a code to its unit value, as the two-pass kernel divided it
template <typename T>
JXL_SHD float to_unit(T v, float maxv) {
  return (float)v / maxv;
}

template <typename T>
JXL_SHD T to_code(float v, float maxv) {
  if constexpr (sizeof(T) == 4) {
    return v;
  } else {
    return (T)rintf(v * maxv);
  }
}

// a 16-byte copy: one vector load or store on the card
JXL_SHD void copy16(void* dst, const void* src) {
#if defined(__CUDA_ARCH__)
  *static_cast<uint4*>(dst) = *static_cast<const uint4*>(src);
#else
  memcpy(dst, src, 16);
#endif
}

// the input columns a block's tile reads
struct Window {
  int xw0, xw1;
};

// One block's program over an input (H, W, C) of T.  ALPHA: the last of
// C (2 or 4) channels is unassociated alpha; then an output unit is a
// pixel (C values), else one sample.  C = 0 means the channel count is
// the runtime `c`.
template <typename T, int C, bool ALPHA>
struct Resample {
  const T* in;
  T* out;
  int W, c;
  float maxv;
  Band v, h;
  int rows, cols;
  Tiles t;
  Layout l;

  JXL_SHD_MEMBER int nc() const { return C > 0 ? C : c; }

  // block b's first output row and column, and how many it has of each
  JXL_SHD_MEMBER void tile(int b, int& r0, int& p0, int& ny, int& nx) const {
    const int bx_n = (cols + t.tx - 1) / t.tx;
    r0 = b / bx_n * t.ty;
    p0 = b % bx_n * t.tx;
    ny = min(t.ty, rows - r0);
    nx = min(t.tx, cols - p0);
  }

  // every thread: the u8 units, the tile's band entries and weights into
  // shared memory; warp 0 also: the window, the least first and the
  // largest end over the tile's rows and over its columns (lanes over
  // the entries, then a reduction across the warp: shuffles on the card,
  // lane 31 over the 32 partials on the host, whose threads run in order)
  JXL_SHD_MEMBER void tables(int k, int b, char* s) const {
    float* lut = (float*)(s + l.lut);
    if (k < 256) lut[k] = to_unit<float>((float)k, maxv);
    int r0, p0, ny, nx;
    tile(b, r0, p0, ny, nx);
    int* band = (int*)(s + l.band);
    for (int i = k; i < ny; i += kThreads) {
      band[i] = v.first[r0 + i];
      band[kMaxTY + i] = v.len[r0 + i];
    }
    for (int i = k; i < nx; i += kThreads) {
      band[2 * kMaxTY + i] = h.first[p0 + i];
      band[2 * kMaxTY + kMaxTX + i] = h.len[p0 + i];
    }
    if (l.wsm) {
      // the tile's rows (columns) of weights are one contiguous run
      float* wv = (float*)(s + l.wv);
      float* wh = (float*)(s + l.wh);
      const float* gv = v.w + (long long)r0 * v.stride;
      const float* gh = h.w + (long long)p0 * h.stride;
      for (int i = k; i < ny * v.stride; i += kThreads) wv[i] = gv[i];
      for (int i = k; i < nx * h.stride; i += kThreads) wh[i] = gh[i];
    }
    if (k >= 32) return;
    int x = 1 << 30, y = 0;
    for (int i = k; i < nx; i += 32) {
      const int f = h.first[p0 + i];
      x = min(x, f);
      y = max(y, f + h.len[p0 + i]);
    }
    int* part = (int*)(s + l.part);
#if defined(__CUDA_ARCH__)
    for (int o = 16; o > 0; o >>= 1) {
      x = min(x, __shfl_xor_sync(0xffffffffu, x, o));
      y = max(y, __shfl_xor_sync(0xffffffffu, y, o));
    }
    if (k == 0) {
      part[0] = x;
      part[1] = y;
    }
#else
    part[0] = k == 0 ? x : min(part[0], x);
    part[1] = k == 0 ? y : max(part[1], y);
#endif
  }

  JXL_SHD_MEMBER Window window(const char* s) const {
    const int* part = (const int*)(s + l.part);
    Window w{part[0], part[1]};
    if (w.xw1 <= w.xw0) w.xw1 = w.xw0 = 0;
    return w;
  }

  // row ry's (column pp's) weights: staged, else in device memory
  JXL_SHD_MEMBER const float* wrow(const char* s, int r0, int ry) const {
    return l.wsm ? (const float*)(s + l.wv) + ry * v.stride
                 : v.w + (long long)(r0 + ry) * v.stride;
  }
  JXL_SHD_MEMBER const float* wcol(const char* s, int p0, int pp) const {
    return l.wsm ? (const float*)(s + l.wh) + pp * h.stride
                 : h.w + (long long)(p0 + pp) * h.stride;
  }

  JXL_SHD_MEMBER float unit(T v, const float* lut) const {
    if constexpr (sizeof(T) == 1) {
      return lut[v];
    } else {
      return to_unit<T>(v, maxv);
    }
  }

  // tv: the tile's rows over input columns [cx0, cx1), each unit (a
  // pixel's C values up to 4 channels, else one value) a thread at a
  // time: its band's codes read from device memory (the tile's other rows
  // read them again from L1), made units (u8 through the table), alpha
  // premultiplied, summed in the band's order
  JXL_SHD_MEMBER void vertical(int k, int b, int cx0, int cx1,
                               char* s) const {
    const float* lut = (const float*)(s + l.lut);
    float* tv = (float*)(s + l.tv);
    const int* band = (const int*)(s + l.band);
    int r0, p0, ny, nx;
    tile(b, r0, p0, ny, nx);
    constexpr int U = C > 0 ? C : 1;
    const int per_px = nc() / U;
    const int row_items = (cx1 - cx0) * per_px;
    const long long pitch = (long long)W * nc();
    for (int j = k; j < ny * row_items; j += kThreads) {
      const int ry = j / row_items, rem = j - ry * row_items;
      const int x = rem / per_px, c0 = (rem - x * per_px) * U;
      const int n = band[kMaxTY + ry];
      const float* w = wrow(s, r0, ry);
      const T* src = in + ((long long)band[ry] * W + cx0 + x) * nc() + c0;
      float acc[U];
JXL_UNROLL
      for (int q = 0; q < U; ++q) acc[q] = 0.0f;
      for (int kk = 0; kk < n; ++kk, src += pitch) {
        float u[U];
JXL_UNROLL
        for (int q = 0; q < U; ++q) u[q] = unit(src[q], lut);
        if (ALPHA) {
JXL_UNROLL
          for (int q = 0; q < U - 1; ++q) u[q] = u[q] * u[U - 1];
        }
        const float wk = w[kk];
JXL_UNROLL
        for (int q = 0; q < U; ++q) acc[q] = fmaf(wk, u[q], acc[q]);
      }
      float* dst = tv + (long long)ry * l.cwe + x * nc() + c0;
JXL_UNROLL
      for (int q = 0; q < U; ++q) dst[q] = acc[q];
    }
  }

  // each output unit over tv's columns [cx0, cx1) of its band, continued
  // from hacc (first: from 0); last: alpha divided out, clipped, its codes
  // into the output tile (row ry at ry * outb, from the 16-byte offset of
  // its first output in device memory)
  JXL_SHD_MEMBER void horizontal(int k, int b, int cx0, int cx1, bool first,
                          bool last, char* s) const {
    const float* tv = (const float*)(s + l.tv);
    float* hacc = (float*)(s + l.hacc);
    char* s_out = s + l.out;
    int r0, p0, ny, nx;
    tile(b, r0, p0, ny, nx);
    // a unit: a pixel's C values (C up to 4), else one value
    constexpr int U = C > 0 ? C : 1;
    const int per_px = nc() / U;
    // items (row, column, unit) with the columns padded to a power of two
    int sh = 0;
    while ((1 << sh) < t.tx) ++sh;
    const int* band = (const int*)(s + l.band) + 2 * kMaxTY;
    for (int j = k; j < (ny << sh) * per_px; j += kThreads) {
      const int u = j % per_px, px = j / per_px;
      const int ry = px >> sh, pp = px & ((1 << sh) - 1), c0 = u * U;
      if (pp >= nx) continue;
      const int f = band[pp];
      const int ka = max(0, cx0 - f), kb = min(band[kMaxTX + pp], cx1 - f);
      const float* w = wcol(s, p0, pp);
      float* ha = hacc + ((long long)ry * t.tx + pp) * nc() + c0;
      float acc[U];
JXL_UNROLL
      for (int q = 0; q < U; ++q) acc[q] = first ? 0.0f : ha[q];
      const float* src = tv + (long long)ry * l.cwe + c0;
      for (int kk = ka; kk < kb; ++kk) {
        const float wk = w[kk];
        const float* col = src + (long long)(f + kk - cx0) * nc();
JXL_UNROLL
        for (int q = 0; q < U; ++q) acc[q] = fmaf(wk, col[q], acc[q]);
      }
      if (!last) {
JXL_UNROLL
        for (int q = 0; q < U; ++q) ha[q] = acc[q];
        continue;
      }
      if (ALPHA) {
        const float a = fminf(fmaxf(acc[U - 1], 1e-6f), 1.0f);
JXL_UNROLL
        for (int q = 0; q < U - 1; ++q) acc[q] = acc[q] / a;
      }
      const uintptr_t g =
          (uintptr_t)(out + ((long long)(r0 + ry) * cols + p0) * nc());
      T* dst = (T*)(s_out + (long long)ry * l.outb + (g & 15)) +
               pp * nc() + c0;
JXL_UNROLL
      for (int q = 0; q < U; ++q)
        dst[q] = to_code<T>(fminf(fmaxf(acc[q], 0.0f), 1.0f), maxv);
    }
  }

  // the block's phases in order; each(f) runs f for every thread of the
  // block, then a barrier (on the host: f(0) .. f(kThreads - 1)).  Every
  // pass runs at least once, so an empty window still writes its codes.
  template <typename Each>
  JXL_SHD_MEMBER void run(int b, char* s, Each each) const {
    each([&](int k) { tables(k, b, s); });
    const Window w = window(s);
    const int ncx = max(1, (w.xw1 - w.xw0 + t.cw - 1) / t.cw);
    for (int cx = 0; cx < ncx; ++cx) {
      const int cx0 = w.xw0 + cx * t.cw, cx1 = min(cx0 + t.cw, w.xw1);
      each([&](int k) { vertical(k, b, cx0, cx1, s); });
      each([&](int k) { horizontal(k, b, cx0, cx1, cx == 0, cx == ncx - 1, s); });
    }
    each([&](int k) { store(k, b, s); });
  }

  // the output tile's rows to device memory: each row's bytes cut at
  // 16-byte boundaries of device memory into slots, the rows' slots spread
  // over the threads; a whole slot is one 16-byte store, a slot at either
  // end of the row takes its values one at a time
  JXL_SHD_MEMBER void store(int k, int b, const char* s) const {
    int r0, p0, ny, nx;
    tile(b, r0, p0, ny, nx);
    const int n = nx * nc();
    const int slots = (int)((n * sizeof(T) + 15) / 16) + 1;
    for (int j = k; j < ny * slots; j += kThreads) {
      const int ry = j / slots;
      T* dst = out + ((long long)(r0 + ry) * cols + p0) * nc();
      const uintptr_t a = (uintptr_t)dst, end = a + n * sizeof(T);
      const T* src =
          (const T*)(s + l.out + (long long)ry * l.outb + (a & 15));
      const uintptr_t b0 = (a & ~(uintptr_t)15) + 16 * (uintptr_t)(j % slots);
      if (b0 >= end) continue;
      if (b0 >= a && b0 + 16 <= end) {
        const int e = (int)((b0 - a) / sizeof(T));
        copy16(dst + e, src + e);
      } else {
        const uintptr_t lo = b0 > a ? b0 : a, hi = b0 + 16 < end ? b0 + 16 : end;
        for (int e = (int)((lo - a) / sizeof(T)); e < (int)((hi - a) / sizeof(T));
             ++e)
          dst[e] = src[e];
      }
    }
  }
};

}  // namespace jxl_sample
