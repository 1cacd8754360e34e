// The patch and spline overlay of a VarDCT frame: patches (A8) and
// splines (A9), each a kernel with a plain C entry point (vardct/overlay.py
// binds them; their plain twins are there too).
//
// They replace the `overlay` step of fn_post in the JAX package's device
// path (jxl_coder_tpu/vardct/tpu_full.py:835-840), X * mul + add per
// channel over dense (3, H, W) mul / add planes that the host builds
// (patches.patches_to_affine, plus Splines.render cast to f32 into add;
// dec_real.py:1063-1088).  That route moves 24 B a pixel of planes the
// host made; these kernels touch only the pixels the overlay changes.
// The host lists, per 64 x 16 tile, the patches (or the spline points)
// whose box meets it, in order (CSR); one thread block takes one listed
// tile, 64 x 4 threads, each thread 4 rows of one column.
//   A8 patches_kernel: each pixel walks its tile's patches in dictionary
//      order and blends each one's source (the reference frame's XYB
//      planes at the patch's offset) as patches_to_affine reads the mode:
//      ADD and both ALPHA_ADD add (no extra-channel planes), MUL multiplies
//      by the source (clipped to [0, 1] with clamp), REPLACE and both
//      BLEND modes replace.  In sequence, one f32 rounding per blend,
//      where the JAX route composes mul / add first (about 1 ulp apart).
//      Bound by bytes: the patch pixels' source read, plane read and
//      plane write, 3 x 12 B a pixel.
//   A9 splines_kernel: the tile's listed points (centre, |sigma|,
//      intensity, colour, box) 32 at a time (overlay.cuh's walk): warp 0
//      stages a chunk's records in shared memory, copying the next chunk's
//      by cp.async while the block accumulates; all threads compute the
//      chunk's boundary erfs of box and tile, each boundary once
//      (Splines.render's ex / ey are differences of adjacent ones), and
//      a warp takes 8 columns of the tile; then each pixel in a box
//      adds colour * (0.25 |sigma| intensity * (ey * ex)) into an fp64
//      sum, in list order, and the plane gets the f32 of the sum.  Two
//      barriers a chunk.  The Abramowitz-Stegun erf of splines.py in fp64,
//      not CUDA's erf; CUDA's exp may differ from the host's in the last
//      bit.  Bound by its fp64 operations (chip_smoke.py SPLINE_OPS), with
//      the touched pixels' planes read and written beside them.
// -fmad=false: every operation rounds once, in the twins' order.

#include <cuda_runtime.h>
#include <stdint.h>

#include "overlay.cuh"

namespace {

constexpr int TW = 64;   // tile width
constexpr int TH = 16;   // tile height
constexpr int TY = 4;    // thread rows: each thread takes TH / TY rows
constexpr int NSLOT = 4; // reference frame slots

// patches.py blend modes
constexpr int kReplace = 1, kAdd = 2, kMul = 3, kBlendAbove = 4,
              kBlendBelow = 5, kAlphaAddAbove = 6, kAlphaAddBelow = 7;

struct Refs {
  const float* p[NSLOT];   // (3, h, w) f32 XYB planes of each slot
  int h[NSLOT], w[NSLOT];
};

__device__ __forceinline__ float blend(int mode, bool clamp, float v,
                                       float s) {
  switch (mode) {
    case kAdd:
    case kAlphaAddAbove:
    case kAlphaAddBelow:
      return v + s;
    case kMul:
      return v * (clamp ? fminf(fmaxf(s, 0.0f), 1.0f) : s);
    case kReplace:
    case kBlendAbove:
    case kBlendBelow:
      return s;
    default:
      return v;
  }
}

// patches: (P, 8) int32 rows (x, y, w, h, slot, x0, y0, mode | clamp << 8)
__global__ void __launch_bounds__(TW * TY)
    patches_kernel(float* __restrict__ xyb, long long plane, int H, int W,
                   Refs refs, const int* __restrict__ patches,
                   const int* __restrict__ tiles,
                   const int* __restrict__ offs,
                   const int* __restrict__ items, int tiles_x) {
  const int t = tiles[blockIdx.x];
  const int x = (t % tiles_x) * TW + threadIdx.x;
  const int y0 = (t / tiles_x) * TH;
  const int begin = offs[blockIdx.x], end = offs[blockIdx.x + 1];
  if (x >= W) return;
  for (int r = threadIdx.y; r < TH; r += TY) {
    const int y = y0 + r;
    if (y >= H) break;
    const long long i = (long long)y * W + x;
    float v0 = xyb[i], v1 = xyb[plane + i], v2 = xyb[2 * plane + i];
    bool touched = false;
    for (int k = begin; k < end; ++k) {
      const int* p = patches + 8 * items[k];
      const int dx = x - p[0], dy = y - p[1];
      if (dx < 0 || dy < 0 || dx >= p[2] || dy >= p[3]) continue;
      const int slot = p[4];
      const int rw = refs.w[slot];
      const long long rplane = (long long)refs.h[slot] * rw;
      const float* src = refs.p[slot] + (long long)(p[6] + dy) * rw + p[5] +
                         dx;
      const int mode = p[7] & 0xff;
      const bool clamp = (p[7] >> 8) != 0;
      v0 = blend(mode, clamp, v0, src[0]);
      v1 = blend(mode, clamp, v1, src[rplane]);
      v2 = blend(mode, clamp, v2, src[2 * rplane]);
      touched = true;
    }
    if (touched) {
      xyb[i] = v0;
      xyb[plane + i] = v1;
      xyb[2 * plane + i] = v2;
    }
  }
}

using jxl_ov::PixelSums;
using jxl_ov::PointLoad;
using jxl_ov::SplineArgs;
using jxl_ov::SplineShared;
using jxl_ov::kChunk;

// lane k of warp 0 stages point k of a chunk from its copied record
// (valid: k is one of the chunk's points): the clipped box, the boundary
// offsets by a prefix sum over the lanes, the record
__device__ __forceinline__ void stage_chunk(bool valid, int lane, int buf,
                                            int tx0, int ty0,
                                            SplineShared& s) {
  jxl_ov::Box cl;
  jxl_ov::copy_wait();
  const PointLoad& p = s.raw[lane];
  const int cnt = valid ? jxl_ov::clip_point(p, tx0, ty0, cl) : 0;
  int inc = cnt;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += v;
  }
  if (valid) jxl_ov::stage_point(p, cl, inc - cnt, cnt, lane, buf, s);
  s.off[buf][lane] = inc - cnt;
  if (lane == 31) s.off[buf][kChunk] = inc;
}

__global__ void __launch_bounds__(jxl_ov::kThreads, 4)
    splines_kernel(SplineArgs a) {
  __shared__ SplineShared s;
  const int tid = threadIdx.x;
  const bool stager = tid < 32;
  int tx, ty, tx0, ty0;
  jxl_ov::pixel_of(tid, tx, ty);
  jxl_ov::tile_origin(a, blockIdx.x, tx0, ty0);
  const int begin = a.offs[blockIdx.x], end = a.offs[blockIdx.x + 1];
  const int nch = (end - begin + kChunk - 1) / kChunk;
  PixelSums ps;
#pragma unroll
  for (int r = 0; r < jxl_ov::kRows; ++r) {
    ps.acc[r][0] = ps.acc[r][1] = ps.acc[r][2] = 0.0;
    ps.touched[r] = false;
  }
  int j_next = -1;   // a stager's point of the next chunk
  if (stager) {
    const int k0 = begin + tid, k1 = k0 + kChunk;
    if (k0 < end) jxl_ov::copy_point(a, a.items[k0], s.raw[tid]);
    if (k1 < end) j_next = a.items[k1];
    stage_chunk(k0 < end, tid, 0, tx0, ty0, s);
  }
  __syncthreads();
  for (int ch = 0; ch < nch; ++ch) {
    const int buf = ch & 1;
    const int nk = min(kChunk, end - begin - ch * kChunk);
    jxl_ov::chunk_erfs(tid, buf, s);
    __syncthreads();
    const bool more = ch + 1 < nch, valid = j_next >= 0;
    if (valid) {
      jxl_ov::copy_point(a, j_next, s.raw[tid]);
      const int k2 = begin + (ch + 2) * kChunk + tid;
      j_next = k2 < end ? a.items[k2] : -1;
    }
    jxl_ov::chunk_accumulate(tx, ty, tx0, ty0, buf, nk, s, ps);
    if (stager && more) stage_chunk(valid, tid, buf ^ 1, tx0, ty0, s);
    __syncthreads();
  }
  jxl_ov::write_pixels(tx, ty, tx0, ty0, a, ps);
}

}  // namespace

extern "C" {

// ref_ptrs: NSLOT device pointers (0 for an empty slot); ref_dims: NSLOT
// heights then NSLOT widths.  Both are host arrays, copied into the
// launch parameters.
int jxl_overlay_patches(float* xyb, long long plane, int H, int W,
                        const unsigned long long* ref_ptrs,
                        const int* ref_dims, const int* patches,
                        const int* tiles, const int* offs, const int* items,
                        int ntiles, int tiles_x, cudaStream_t stream) {
  Refs refs;
  for (int s = 0; s < NSLOT; ++s) {
    refs.p[s] = reinterpret_cast<const float*>(ref_ptrs[s]);
    refs.h[s] = ref_dims[s];
    refs.w[s] = ref_dims[NSLOT + s];
  }
  patches_kernel<<<ntiles, dim3(TW, TY), 0, stream>>>(
      xyb, plane, H, W, refs, patches, tiles, offs, items, tiles_x);
  return (int)cudaGetLastError();
}

int jxl_draw_splines(float* xyb, long long plane, int H, int W,
                     const double* points, const int* boxes,
                     const int* tiles, const int* offs, const int* items,
                     int ntiles, int tiles_x, cudaStream_t stream) {
  const SplineArgs a{xyb, plane, H, W, points, boxes, tiles, offs, items,
                     tiles_x};
  splines_kernel<<<ntiles, jxl_ov::kThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
