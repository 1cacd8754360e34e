// The spline overlay A9's arithmetic and its walk over a tile's points
// (overlay.cu splines_kernel), as __host__ __device__ functions: the kernel
// runs them on the card, and a CPU test builds this header with g++ and
// runs the kernel's phases thread by thread against tile_by_points, the
// point-by-point walk of the kernel this one replaced, bit for bit.
//
// A tile of TW x TH pixels is a block of TW x TY threads; a thread owns a
// column and kRows rows (ty, ty + TY, ...), and a warp 8 columns and all
// TH rows (pixel_of), so that a point's box meets few warps and most of
// their lanes.  The tile's listed points are taken kChunk at a time:
//   stage: lane k of warp 0 copies point k's record (centre, |sigma|,
//     intensity, colour, box) into shared memory a chunk ahead (cp.async
//     on the card, while the block accumulates the chunk before), clips
//     its box to the tile and stores what the other phases read (the
//     centre, 1 / (sigma sqrt 2), 0.25 |sigma| intensity, the colour, the
//     clipped box, its offset in the chunk's boundary array: a prefix sum
//     over the lanes);
//   erfs: all threads, the chunk's boundary erfs one an index (the
//     stager maps each index to its point): a point's ncol + 1 column
//     boundaries x - 0.5 (x from its first clipped column to one past its
//     last), then its nrow + 1 row boundaries, and only
//     those: column x's upper boundary (x + 0.5 - c) / (sigma sqrt 2) and
//     column x + 1's lower one are the same double, as both x + 0.5 and
//     (x + 1) - 0.5 are exact;
//   accumulate: each pixel adds the chunk's points in list order, with ex
//     and ey the differences of adjacent boundary erfs: the old kernel's
//     erf differences to the bit, its blob scale * (ey * ex) and its fp64
//     sums.
// -fmad=false on the card, -ffp-contract=off on the host: each operation
// rounds once, in this order.  The host's exp is glibc's, the card's
// CUDA's; the two may differ in the last bit.

#pragma once

#include <math.h>
#include <stdint.h>

#if defined(__CUDACC__)
#define JXL_OHD __host__ __device__ __forceinline__
#else
#define JXL_OHD static inline
#endif

namespace jxl_ov {

constexpr int TW = 64;                    // tile width
constexpr int TH = 16;                    // tile height
constexpr int TY = 4;                     // thread rows
constexpr int kRows = TH / TY;            // rows a thread
constexpr int kThreads = TW * TY;
constexpr int kChunk = 32;                // points a chunk: warp 0's lanes
constexpr int kBounds = TW + 1 + TH + 1;  // a point's boundaries at most

// the launch's arguments: planes (3, H, W) f32 in place; points (M, 7)
// f64 (cx, cy, |sigma|, intensity, colour X, Y, B); boxes (M, 4) int32
// inclusive (x0, x1, y0, y1) inside the frame; the tile lists
struct SplineArgs {
  float* xyb;
  long long plane;
  int H, W;
  const double* points;
  const int* boxes;
  const int* tiles;
  const int* offs;
  const int* items;
  int tiles_x;
};

// a point's record as a stager copies it
struct alignas(16) PointLoad {
  int box[4];
  double v[7];
};

// a staged point: what a pixel reads first, in 16-byte pairs
struct alignas(16) PointRec {
  double scale, col[3], cx, cy, inv;
};

// an inclusive box
struct alignas(16) Box {
  int x0, x1, y0, y1;
};

struct alignas(16) SplineShared {
  PointLoad raw[kChunk];             // the next chunk's records
  PointRec pt[2][kChunk];
  Box box[2][kChunk];                // the box clipped to the tile
  int off[2][kChunk + 1];            // boundary offsets; [kChunk] the total
  double e[kChunk * kBounds];        // the chunk's boundary erfs
  uint8_t owner[kChunk * kBounds];   // the point of each boundary
};

// a thread's sums and which of its rows a box touched
struct PixelSums {
  double acc[kRows][3];
  bool touched[kRows];
};

// splines.py _erf: Abramowitz-Stegun 7.1.26, sign(x) * y
JXL_OHD double erf_as(double x) {
  const double sign = x > 0.0 ? 1.0 : (x < 0.0 ? -1.0 : 0.0);
  const double ax = fabs(x);
  const double tt = 1.0 / (1.0 + 0.3275911 * ax);
  const double y =
      1.0 - (((((1.061405429 * tt - 1.453152027) * tt) + 1.421413741) * tt -
              0.284496736) * tt + 0.254829592) * tt * exp(-ax * ax);
  return sign * y;
}

// erf((i + 0.5 - c) * inv) - erf((i - 0.5 - c) * inv), as draw_points
JXL_OHD double erf_diff(int i, double c, double inv) {
  const double d = (double)i;
  return erf_as((d + 0.5 - c) * inv) - erf_as((d - 0.5 - c) * inv);
}

// thread t's column tx and first row ty: warp w the columns 8w .. 8w + 7
JXL_OHD void pixel_of(int t, int& tx, int& ty) {
  tx = ((t >> 5) << 3) | (t & 7);
  ty = (t >> 3) & 3;
}

JXL_OHD void tile_origin(const SplineArgs& a, int blk, int& tx0, int& ty0) {
  const int t = a.tiles[blk];
  tx0 = (t % a.tiles_x) * TW;
  ty0 = (t / a.tiles_x) * TH;
}

JXL_OHD void load_point(const SplineArgs& a, int j, PointLoad& p) {
  for (int f = 0; f < 7; ++f) p.v[f] = a.points[7ll * j + f];
  for (int f = 0; f < 4; ++f) p.box[f] = a.boxes[4ll * j + f];
}

// point j's record into dst: on the card asynchronously (copy_wait
// completes it for the copying thread)
JXL_OHD void copy_point(const SplineArgs& a, int j, PointLoad& dst) {
#if defined(__CUDA_ARCH__)
  const unsigned box = (unsigned)__cvta_generic_to_shared(dst.box);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(box),
               "l"(a.boxes + 4ll * j));
  for (int f = 0; f < 7; ++f) {
    const unsigned v = (unsigned)__cvta_generic_to_shared(dst.v + f);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(v),
                 "l"(a.points + 7ll * j + f));
  }
  asm volatile("cp.async.commit_group;\n" ::);
#else
  load_point(a, j, dst);
#endif
}

JXL_OHD void copy_wait() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_all;\n" ::);
#endif
}

// the point's box clipped to the tile at (tx0, ty0) into cl; returns its
// boundary count, 0 for a listed point whose box misses the tile (cl then
// holds no column, so no pixel reads its boundaries)
JXL_OHD int clip_point(const PointLoad& p, int tx0, int ty0, Box& cl) {
  cl.x0 = p.box[0] > tx0 ? p.box[0] : tx0;
  cl.x1 = p.box[1] < tx0 + TW - 1 ? p.box[1] : tx0 + TW - 1;
  cl.y0 = p.box[2] > ty0 ? p.box[2] : ty0;
  cl.y1 = p.box[3] < ty0 + TH - 1 ? p.box[3] : ty0 + TH - 1;
  if (cl.x1 < cl.x0 || cl.y1 < cl.y0) {
    cl.x1 = cl.x0 - 1;
    return 0;
  }
  return (cl.x1 - cl.x0 + 2) + (cl.y1 - cl.y0 + 2);
}

// point k of the chunk in buffer buf, its cnt boundaries from offset off
// (the owner map is the next chunk's: the erfs of the one before have run)
JXL_OHD void stage_point(const PointLoad& p, const Box& cl, int off, int cnt,
                         int k, int buf, SplineShared& s) {
  PointRec& r = s.pt[buf][k];
  r.cx = p.v[0];
  r.cy = p.v[1];
  r.inv = 1.0 / (p.v[2] * 1.4142135623730951);
  r.scale = 0.25 * p.v[2] * p.v[3];
  for (int c = 0; c < 3; ++c) r.col[c] = p.v[4 + c];
  s.box[buf][k] = cl;
  for (int f = off; f < off + cnt; ++f) s.owner[f] = (uint8_t)k;
}

// thread t's boundary erfs of the chunk in buffer buf
JXL_OHD void chunk_erfs(int t, int buf, SplineShared& s) {
  const int* off = s.off[buf];
  const int total = off[kChunk];
  for (int f = t; f < total; f += kThreads) {
    const int k = s.owner[f];
    const PointRec& r = s.pt[buf][k];
    const Box cl = s.box[buf][k];
    const int i = f - off[k], ncb = cl.x1 - cl.x0 + 2;
    s.e[f] = i < ncb ? erf_as(((double)(cl.x0 + i) - 0.5 - r.cx) * r.inv)
                     : erf_as(((double)(cl.y0 + i - ncb) - 0.5 - r.cy) *
                              r.inv);
  }
}

// the pixels of thread (tx, ty) add the chunk's first nk points in order
JXL_OHD void chunk_accumulate(int tx, int ty, int tx0, int ty0, int buf,
                              int nk, const SplineShared& s, PixelSums& ps) {
  const int x = tx0 + tx;
  for (int k = 0; k < nk; ++k) {
    const Box cl = s.box[buf][k];
    if (x < cl.x0 || x > cl.x1) continue;
    const PointRec& r = s.pt[buf][k];
    const double* e = s.e + s.off[buf][k];
    const int ncb = cl.x1 - cl.x0 + 2;
    const double ex = e[x - cl.x0 + 1] - e[x - cl.x0];
    for (int rr = 0; rr < kRows; ++rr) {
      const int y = ty0 + ty + rr * TY;
      if (y < cl.y0 || y > cl.y1) continue;
      const int yi = ncb + y - cl.y0;
      const double ey = e[yi + 1] - e[yi];
      const double blob = r.scale * (ey * ex);
      ps.acc[rr][0] += r.col[0] * blob;
      ps.acc[rr][1] += r.col[1] * blob;
      ps.acc[rr][2] += r.col[2] * blob;
      ps.touched[rr] = true;
    }
  }
}

// the f32 of each touched pixel's sums added to the planes
JXL_OHD void write_pixels(int tx, int ty, int tx0, int ty0,
                          const SplineArgs& a, const PixelSums& ps) {
  const int x = tx0 + tx;
  if (x >= a.W) return;
  for (int rr = 0; rr < kRows; ++rr) {
    const int y = ty0 + ty + rr * TY;
    if (!ps.touched[rr] || y >= a.H) continue;
    const long long i = (long long)y * a.W + x;
    a.xyb[i] = a.xyb[i] + (float)ps.acc[rr][0];
    a.xyb[a.plane + i] = a.xyb[a.plane + i] + (float)ps.acc[rr][1];
    a.xyb[2 * a.plane + i] = a.xyb[2 * a.plane + i] + (float)ps.acc[rr][2];
  }
}

// The kernel this one replaced, for the host's test: listed tile blk point
// by point, the tile's 64 column and 16 row erf differences of each point
// (each boundary twice), then each pixel in the box adds the blob.
inline void tile_by_points(const SplineArgs& a, int blk) {
  int tx0, ty0;
  tile_origin(a, blk, tx0, ty0);
  double acc[TH][TW][3] = {};
  bool touched[TH][TW] = {};
  for (int k = a.offs[blk]; k < a.offs[blk + 1]; ++k) {
    PointLoad p;
    load_point(a, a.items[k], p);
    const double inv = 1.0 / (p.v[2] * 1.4142135623730951);
    double ex[TW], ey[TH];
    for (int i = 0; i < TW; ++i) ex[i] = erf_diff(tx0 + i, p.v[0], inv);
    for (int i = 0; i < TH; ++i) ey[i] = erf_diff(ty0 + i, p.v[1], inv);
    const double scale = 0.25 * p.v[2] * p.v[3];
    for (int ry = 0; ry < TH; ++ry)
      for (int rx = 0; rx < TW; ++rx) {
        const int x = tx0 + rx, y = ty0 + ry;
        if (x < p.box[0] || x > p.box[1] || y < p.box[2] || y > p.box[3])
          continue;
        const double blob = scale * (ey[ry] * ex[rx]);
        for (int c = 0; c < 3; ++c) acc[ry][rx][c] += p.v[4 + c] * blob;
        touched[ry][rx] = true;
      }
  }
  for (int ry = 0; ry < TH && ty0 + ry < a.H; ++ry)
    for (int rx = 0; rx < TW && tx0 + rx < a.W; ++rx) {
      if (!touched[ry][rx]) continue;
      const long long i = (long long)(ty0 + ry) * a.W + tx0 + rx;
      for (int c = 0; c < 3; ++c)
        a.xyb[c * a.plane + i] = a.xyb[c * a.plane + i] +
                                 (float)acc[ry][rx][c];
    }
}

}  // namespace jxl_ov
