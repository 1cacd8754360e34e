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
//   A9 splines_kernel: per listed point (centre, |sigma|, intensity,
//      colour, box), the erf differences of the tile's 64 columns and 16
//      rows go to shared memory (Splines.render's ex / ey, computed
//      once a column or row), then each pixel in the box adds
//      colour * (0.25 |sigma| intensity * (ey * ex)) into an fp64 sum, in
//      list order, and the plane gets the f32 of the sum.  The
//      Abramowitz-Stegun erf of splines.py in fp64, not CUDA's erf; CUDA's
//      exp may differ from the host's in the last bit.  Bound by bytes at
//      the streams' sizes (the touched pixels' planes read and written),
//      with the fp64 operations beside it (chip_smoke.py SPLINE_OPS).
// -fmad=false: every operation rounds once, in the twins' order.

#include <cuda_runtime.h>
#include <stdint.h>

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

// splines.py _erf: Abramowitz-Stegun 7.1.26, sign(x) * y
__device__ __forceinline__ double erf_as(double x) {
  const double sign = x > 0.0 ? 1.0 : (x < 0.0 ? -1.0 : 0.0);
  const double ax = fabs(x);
  const double tt = 1.0 / (1.0 + 0.3275911 * ax);
  const double y =
      1.0 - (((((1.061405429 * tt - 1.453152027) * tt) + 1.421413741) * tt -
              0.284496736) * tt + 0.254829592) * tt * exp(-ax * ax);
  return sign * y;
}

// erf((i + 0.5 - c) * inv) - erf((i - 0.5 - c) * inv), as draw_points
__device__ __forceinline__ double erf_diff(int i, double c, double inv) {
  const double d = (double)i;
  return erf_as((d + 0.5 - c) * inv) - erf_as((d - 0.5 - c) * inv);
}

// points: (M, 7) f64 (cx, cy, |sigma|, intensity, colour X, Y, B);
// boxes: (M, 4) int32 inclusive (x0, x1, y0, y1), inside the frame
__global__ void __launch_bounds__(TW * TY)
    splines_kernel(float* __restrict__ xyb, long long plane, int H, int W,
                   const double* __restrict__ points,
                   const int* __restrict__ boxes,
                   const int* __restrict__ tiles,
                   const int* __restrict__ offs,
                   const int* __restrict__ items, int tiles_x) {
  __shared__ double s_ex[TW], s_ey[TH], s_pt[7];
  __shared__ int s_box[4];
  const int t = tiles[blockIdx.x];
  const int tx0 = (t % tiles_x) * TW, ty0 = (t / tiles_x) * TH;
  const int tid = threadIdx.y * TW + threadIdx.x;
  const int x = tx0 + threadIdx.x;
  const int begin = offs[blockIdx.x], end = offs[blockIdx.x + 1];
  double acc[TH / TY][3];
  bool touched[TH / TY];
#pragma unroll
  for (int r = 0; r < TH / TY; ++r) {
    acc[r][0] = acc[r][1] = acc[r][2] = 0.0;
    touched[r] = false;
  }
  for (int k = begin; k < end; ++k) {
    const int j = items[k];
    __syncthreads();  // the last point's shared values are read
    if (tid < 7) s_pt[tid] = points[7LL * j + tid];
    if (tid >= 32 && tid < 36) s_box[tid - 32] = boxes[4LL * j + tid - 32];
    __syncthreads();
    const double inv = 1.0 / (s_pt[2] * 1.4142135623730951);
    if (tid < TW)
      s_ex[tid] = erf_diff(tx0 + tid, s_pt[0], inv);
    else if (tid < TW + TH)
      s_ey[tid - TW] = erf_diff(ty0 + tid - TW, s_pt[1], inv);
    __syncthreads();
    if (x < s_box[0] || x > s_box[1]) continue;
    const double scale = 0.25 * s_pt[2] * s_pt[3];
#pragma unroll
    for (int r = 0; r < TH / TY; ++r) {
      const int ry = threadIdx.y + r * TY;
      const int y = ty0 + ry;
      if (y < s_box[2] || y > s_box[3]) continue;
      const double blob = scale * (s_ey[ry] * s_ex[threadIdx.x]);
      acc[r][0] += s_pt[4] * blob;
      acc[r][1] += s_pt[5] * blob;
      acc[r][2] += s_pt[6] * blob;
      touched[r] = true;
    }
  }
  if (x >= W) return;
#pragma unroll
  for (int r = 0; r < TH / TY; ++r) {
    const int y = ty0 + threadIdx.y + r * TY;
    if (!touched[r] || y >= H) continue;
    const long long i = (long long)y * W + x;
    xyb[i] = xyb[i] + (float)acc[r][0];
    xyb[plane + i] = xyb[plane + i] + (float)acc[r][1];
    xyb[2 * plane + i] = xyb[2 * plane + i] + (float)acc[r][2];
  }
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
  splines_kernel<<<ntiles, dim3(TW, TY), 0, stream>>>(
      xyb, plane, H, W, points, boxes, tiles, offs, items, tiles_x);
  return (int)cudaGetLastError();
}

}  // extern "C"
