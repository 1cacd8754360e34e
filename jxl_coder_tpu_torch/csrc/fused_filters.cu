// The round-1 codec's restoration filters, one tile pass per frame: TPU
// kernels 5 and 6 of jxl_coder_tpu/vardct/filters_pallas.py (kernels 3
// and 4, the real-format chain, are instantiations of kernel 2's tile
// pass in filters.cu).
//
//   legacy_kernel<GAB, EPF, OutT> replaces fused_gab_epf (_kernel, #5)
//     and fused_filters2 (_kernel2, #6): the round-1 codec's gaborish
//     (normalised 3x3, edge replicate) and one plus-shaped EPF pass
//     (pointwise 3-channel SAD, weight max(0, 1 - sad * inv), num / den),
//     optionally followed by XYB -> sRGB8 or sRGB16, the codes of the jnp
//     chain (pipeline.xyb_to_srgb8 / xyb_to_u16, glibc's powf on the
//     CPU) bit for bit.  The EPF's inverse sigma is a per-pixel map (the
//     JAX functions' row-padded interface) or, on the pipeline's route,
//     the per-8x8-block quant field, divided in the kernel.
//
// Borders: the input rows a caller passes may carry `pad` rows of real or
// replicated neighbours above and below (the JAX functions' padded
// interface); rows beyond those and columns are clamped (edge
// replication).  No width or height gate.
//
// legacy_kernel is designed for the H100.  Each thread block owns a 64 x
// 16 output tile.  It stages the input window (rows y0-2 .. y0+17, columns
// x0-2 .. x0+65, three channels) in shared memory once: interior tiles by
// 16-byte cp.async from the aligned column x0-4, edge tiles by clamped
// 4-byte copies.  Gaborish is then made once per window position from
// shared memory, down column strips that keep the rows above and below
// in registers, into a second buffer; a column past the image's left or
// right edge takes the gaborish of its clamped column (the EPF's x
// neighbour there is the replicated gaborish output), rows past the top
// and bottom the gaborish of the clamped input rows.  Each thread then
// filters a group of 4 horizontally adjacent pixels from 16-byte shared
// reads and writes each plane's 4 values in one store (16 B of f32, 8 B
// of u16, 4 B of u8 codes).  The sRGB epilogue makes the cubes and the
// opsin mix once per pixel and reads each channel's code from a table in
// place of the twin's arithmetic (v * 12.92, or glibc's powf past the
// linear segment): at 8 bits the code at the start of a bucket of 2^16
// float bit patterns and where it steps; at 16 bits a quadratic per
// bucket, rounded, and where it lies within 1/64 of a half (~3% of
// values) the code's least value from a table of 65,537 (fused_filters.
// u8_code_table / u16_code_tables).  Both give the twin's codes on every
// float in [0, 1], in integers, with no branch and no conversion.
//
// What bounds it on the H100.  At 4K d1.0 (epf_iters 1): the XYB planes
// in (99.5 MB) and the output (24.9 MB u8, 49.8 MB u16, 99.5 MB f32),
// 0.037-0.060 ms at 3.35 TB/s.  What holds it above that is the
// instruction rate: its time follows its instruction count (PERF.md §6),
// which is why the codes come from tables (glibc's powf in float64 took
// many times their instructions) and the EPF makes each horizontal
// pair's SAD once.  A persistent grid that loads the next window while
// it filters this one was slower (more registers, with spills).
//
// Frames: a launch may filter N frames of one size at once (the round-1
// branch of decode_frames_batch, jxl_coder_tpu/animation.py:416-425, a
// jax.vmap of kernel 6's chain): blockIdx.z is the frame, and each frame's
// input planes, quant field and output sit at their own strides.  A frame
// filters exactly as a launch of it alone would.
//
// Every kernel builds with -fmad=false and sums in the twins' order
// (explicit fmaf only where XLA fuses: the 3x3 opsin mix).

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using namespace jxl;

// asynchronous copies global -> shared (cp.async): 4 bytes through L1,
// 16 bytes (both addresses 16-byte aligned) through L2 only
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src)
               : "memory");
}

// *ptr where pred holds, else +inf: a predicated load, no branch
__device__ __forceinline__ float ldg_if(bool pred, const float* ptr) {
  float v = __int_as_float(0x7f800000);
  asm("{\n\t.reg .pred q;\n\tsetp.ne.s32 q, %2, 0;\n\t@q ld.global.nc.f32 %0, [%1];\n\t}"
      : "+f"(v) : "l"(ptr), "r"(static_cast<int>(pred)));
  return v;
}

// ---------------------------------------------------------------------------
// Kernels 5 and 6: the round-1 gaborish + EPF (+ sRGB8 / sRGB16)

struct LegacyParams {
  float kc, ke, km;    // pipeline.gaborish_kernel(): corner, edge, centre
  float cs[3];         // pipeline.EPF_CHANNEL_SCALE
  float m[9];          // xyb.INV_OPSIN, row-major
  float cbrt_bias, opsin_bias;
  float inv_den;       // float32(distance) * 4: inverse sigma = qf / inv_den
  // the code tables of fused_filters (u8_code_table, u16_code_tables)
  // on the device, by buckets of 2^16 float bit patterns; the first two
  // indexed by a value's top 16 bits (their row 0 is bucket code_lo)
  const int2* u8codes;   // (base code, float bits of the next step)
  const float4* u16poly; // (c0, c1, c2, 0)
  const float* u16thr;   // the least v of each code, 65537 of them
  int code_lo;
};

// pipeline.linear_to_codes of one linear value v in [0, 1]: linear_to_srgb
// (v * 12.92 on the linear segment, glibc's powf above it), round half to
// even, clip, read from the code tables, which give those codes exactly
// (bucket 0 for the values below the tables, whose codes are 0).  No
// branch and no conversion: a thread's 12 values send their table reads
// together (a branch per value would wait out each read in turn).
template <typename OutT>
__device__ __forceinline__ int legacy_code(float v, const LegacyParams& p) {
  const int b = max(__float_as_int(v), p.code_lo << 16) >> 16;
  if constexpr (sizeof(OutT) == 1) {
    const int2 e = __ldg(p.u8codes + b);
    return e.x + (v >= __int_as_float(e.y) ? 1 : 0);
  } else {
    const float4 f = __ldg(p.u16poly + b);
    const float d = v - __int_as_float(b << 16);
    const float t = f.x + (f.z * d + f.y) * d;  // -0.5 < t < 65537
    const float s = t + 12582912.0f;
    const int ri = __float_as_int(s) - 0x4b400000;  // rint(t)
    const float r = s - 12582912.0f;
    // t within 1/64 of a half (t is within 2^-7 of the twin's unrounded
    // code): the code is floor(t) or one more, as v lies below or above
    // that code's least value
    const bool near = fabsf(t - r) > 0.5f - 1.0f / 64.0f;
    const int fl = ri - (t < r ? 1 : 0);
    const float least = ldg_if(near, p.u16thr + (min(fl, 65535) + 1));
    return near ? fl + (v >= least ? 1 : 0) : min(ri, 65535);
  }
}

// pipeline.xyb_to_srgb8 / xyb_to_u16 of one pixel: xyb_to_linear_rgb (the
// cubes once, the mix as a sequential fused sum, fp.contract3), clipped
// to [0, 1] by the last FMA's saturation, then each channel's code.
template <typename OutT>
__device__ __forceinline__ void legacy_codes(float X, float Y, float B,
                                             const LegacyParams& p, int q[3]) {
  const float g0 = (X + Y) + p.cbrt_bias;
  const float g1 = (Y - X) + p.cbrt_bias;
  const float g2 = B + p.cbrt_bias;
  const float m0 = g0 * g0 * g0 - p.opsin_bias;
  const float m1 = g1 * g1 * g1 - p.opsin_bias;
  const float m2 = g2 * g2 * g2 - p.opsin_bias;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float v = p.m[3 * c] * m0;
    v = fmaf(p.m[3 * c + 1], m1, v);
    q[c] = legacy_code<OutT>(__saturatef(fmaf(p.m[3 * c + 2], m2, v)), p);
  }
}

__device__ __forceinline__ float lane(const float4& v, int i) {
  return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
}

constexpr int LTW = 64, LTH = 16;      // legacy_kernel's output tile
constexpr int LNT = LTW * LTH / 4;     // one 4-pixel group a thread
constexpr int LX = LTW + 8;            // a staged row: columns x0-4 .. x0+LTW+3
constexpr int XR = LTH + 4;            // input rows y0-2 .. y0+LTH+1
constexpr int GR = LTH + 2;            // gaborish rows y0-1 .. y0+LTH
constexpr int PXP = XR * LX, PGP = GR * LX;
constexpr int GSH = 6;                 // rows of a gaborish strip
static_assert(GR % GSH == 0 && (LTW + 2) * (GR / GSH) <= LNT,
              "the gaborish strips take one sweep of the block");

// the EPF's inverse sigma: none, a per-pixel float map, or the int32
// per-block quant field divided in the kernel
enum { EPF_NONE = 0, EPF_PIXEL = 1, EPF_BLOCK = 2 };

// in points at the image's row 0; rows [-pad, H + pad) are readable.
// inv: EPF_PIXEL, the float map (row stride inv_stride, rows like in's);
// EPF_BLOCK, qf (qf_rows rows of row stride inv_stride), pixel row y
// reading block row (y + qf_row) >> 3 clamped to the field.  out: (3, H,
// W) float32 planes, or uint8 / uint16 sRGB codes.  Frame blockIdx.z's
// in, inv and out lie frame_in, frame_inv_bytes and frame_out further on.
template <bool GAB, int EPF, typename OutT>
__global__ void __launch_bounds__(LNT, 4)
    legacy_kernel(Planes in, int pad, int H, int W,
                  const void* __restrict__ inv, int inv_stride, int qf_rows,
                  int qf_row, OutT* __restrict__ out, LegacyParams p,
                  long long frame_in, long long frame_inv_bytes,
                  long long frame_out) {
  // X: the input window, column x0-4+k at k; G: the gaborish output at
  // rows y0-1 .. y0+LTH, same columns
  __shared__ __align__(16) float X[3 * PXP];
  __shared__ __align__(16) float G[GAB ? 3 * PGP : 4];
  constexpr bool CODES = sizeof(OutT) < 4;
  in.p += blockIdx.z * frame_in;
  inv = static_cast<const char*>(inv) + blockIdx.z * frame_inv_bytes;
  out += blockIdx.z * frame_out;
  const int tid = threadIdx.x;
  const int x0 = blockIdx.x * LTW, y0 = blockIdx.y * LTH;
  const int ylo = -pad, yhi = H + pad - 1;

  // the window, every copy in flight before one wait
  const bool vec = x0 >= 4 && x0 + LTW + 4 <= W && y0 - 2 >= ylo &&
                   y0 + LTH + 1 <= yhi &&
                   (reinterpret_cast<uintptr_t>(in.p) & 15) == 0 &&
                   (in.row_stride & 3) == 0 && (in.plane_stride & 3) == 0;
  if (vec) {
    constexpr int V = LX / 4;
    const float* base = in.p + (long long)(y0 - 2) * in.row_stride + (x0 - 4);
    for (int i = tid; i < XR * V; i += LNT) {
      const int r = i / V, v = i - r * V;
      const float* src = base + (long long)r * in.row_stride + 4 * v;
      float* dst = X + r * LX + 4 * v;
      cp_async16(dst, src);
      cp_async16(dst + PXP, src + in.plane_stride);
      cp_async16(dst + 2 * PXP, src + 2 * in.plane_stride);
    }
  } else {
    constexpr int C = LTW + 4;  // columns x0-2 .. x0+LTW+1
    for (int i = tid; i < XR * C; i += LNT) {
      const int r = i / C, c = i - r * C;
      const int gy = min(max(y0 - 2 + r, ylo), yhi);
      const float* src = in.p + (long long)gy * in.row_stride + clampi(x0 - 2 + c, W);
      float* dst = X + r * LX + 2 + c;
      cp_async4(dst, src);
      cp_async4(dst + PXP, src + in.plane_stride);
      cp_async4(dst + 2 * PXP, src + 2 * in.plane_stride);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // gaborish at columns x0-1 .. x0+LTW (k = 3 .. LTW+4), pipeline.
  // apply_gaborish's sum tap by tap in row-major order
  if constexpr (GAB) {
    constexpr int NC = LTW + 2;
    for (int it = tid; it < NC * (GR / GSH); it += LNT) {
      const int k = it % NC + 3, r0 = (it / NC) * GSH;
      const int gx = x0 - 4 + k;
      const int ks = (unsigned)gx < (unsigned)W ? k : clampi(gx, W) - (x0 - 4);
      // the taps are symmetric (corner kc, edge ke, centre km), so a row's
      // products serve every tap that reads them: (kc, ke, kc) as the row
      // above or below, (ke, km, ke) as the middle row
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        const float* xc = X + ch * PXP + r0 * LX + ks - 1;
        float a0 = p.kc * xc[0], a1 = p.ke * xc[1], a2 = p.kc * xc[2];
        float b0 = p.kc * xc[LX], b1 = p.ke * xc[LX + 1], b2 = p.kc * xc[LX + 2];
        float m0 = p.ke * xc[LX], m1 = p.km * xc[LX + 1], m2 = p.ke * xc[LX + 2];
        float* g = G + ch * PGP + r0 * LX + k;
#pragma unroll
        for (int s = 0; s < GSH; ++s) {
          const float* xd = xc + (s + 2) * LX;
          const float d0 = p.kc * xd[0], d1 = p.ke * xd[1], d2 = p.kc * xd[2];
          float v = 0.0f;
          v = v + a0;
          v = v + a1;
          v = v + a2;
          v = v + m0;
          v = v + m1;
          v = v + m2;
          v = v + d0;
          v = v + d1;
          v = v + d2;
          g[s * LX] = v;
          a0 = b0; a1 = b1; a2 = b2;
          b0 = d0; b1 = d1; b2 = d2;
          m0 = p.ke * xd[0]; m1 = p.km * xd[1]; m2 = p.ke * xd[2];
        }
      }
    }
    __syncthreads();
  }

  // the EPF and the output of pixels x .. x+3 of row y
  const int r = tid / (LTW / 4), j = tid % (LTW / 4);
  const int y = y0 + r, x = x0 + 4 * j;
  if (y >= H || x >= W) return;
  // the group in plane 0 of the EPF's input (the gaborish output, or the
  // staged input)
  const float* S = GAB ? G + (r + 1) * LX + 4 * j + 4 : X + (r + 2) * LX + 4 * j + 4;
  constexpr int PS = GAB ? PGP : PXP;
  float4 ct[3];
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) ct[ch] = *reinterpret_cast<const float4*>(S + ch * PS);
  float o[3][4];
  if constexpr (EPF != EPF_NONE) {
    float iv[4];
    if constexpr (EPF == EPF_BLOCK) {
      // pipeline.inv_sigma_map's one division
      const int by = min(max((y + qf_row) >> 3, 0), qf_rows - 1);
      const int q = static_cast<const int*>(inv)[by * inv_stride + (x >> 3)];
      const float v = static_cast<float>(q) / p.inv_den;
#pragma unroll
      for (int i = 0; i < 4; ++i) iv[i] = v;
    } else {
      const float* ip = static_cast<const float*>(inv) + (long long)y * inv_stride + x;
#pragma unroll
      for (int i = 0; i < 4; ++i) iv[i] = x + i < W ? ip[i] : 0.0f;
    }
    float4 up[3], dn[3];
    float lf[3], rt[3];
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      up[ch] = *reinterpret_cast<const float4*>(S + ch * PS - LX);
      dn[ch] = *reinterpret_cast<const float4*>(S + ch * PS + LX);
      lf[ch] = S[ch * PS - 1];
      rt[ch] = S[ch * PS + 4];
    }
    // the group's row at columns -1 .. 4, and the channel-weighted SAD of
    // a pair: |a - b| = |b - a|, so the 5 horizontal pairs are made once
    // for the two pixels each belongs to (and, with one inverse sigma for
    // the group, so are their weights)
    auto row = [&](int ch, int i) {
      return i < 0 ? lf[ch] : (i > 3 ? rt[ch] : lane(ct[ch], i));
    };
    auto sad = [&](float a0, float a1, float a2, float b0, float b1, float b2) {
      return fabsf(a0 - b0) * p.cs[0] + fabsf(a1 - b1) * p.cs[1] + fabsf(a2 - b2) * p.cs[2];
    };
    auto weight = [](float d, float inv) { return fmaxf(1.0f - d * inv, 0.0f); };
    float sh[5];  // pair (i - 1, i)
#pragma unroll
    for (int i = 0; i < 5; ++i)
      sh[i] = sad(row(0, i - 1), row(1, i - 1), row(2, i - 1), row(0, i), row(1, i), row(2, i));
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // pipeline._EPF_TAPS_CROSS: (0,-1), (-1,0), (0,0), (1,0), (0,1)
      float t[5][3];
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        t[0][ch] = row(ch, i - 1);
        t[1][ch] = lane(up[ch], i);
        t[2][ch] = lane(ct[ch], i);
        t[3][ch] = lane(dn[ch], i);
        t[4][ch] = row(ch, i + 1);
      }
      const float w[5] = {
          weight(sh[i], iv[i]),
          weight(sad(t[1][0], t[1][1], t[1][2], t[2][0], t[2][1], t[2][2]), iv[i]),
          1.0f,
          weight(sad(t[3][0], t[3][1], t[3][2], t[2][0], t[2][1], t[2][2]), iv[i]),
          weight(sh[i + 1], iv[i])};
      float n0 = 0.0f, n1 = 0.0f, n2 = 0.0f, den = 0.0f;
#pragma unroll
      for (int k = 0; k < 5; ++k) {
        n0 = n0 + t[k][0] * w[k];
        n1 = n1 + t[k][1] * w[k];
        n2 = n2 + t[k][2] * w[k];
        den = den + w[k];
      }
      o[0][i] = n0 / den;
      o[1][i] = n1 / den;
      o[2][i] = n2 / den;
    }
  } else {
#pragma unroll
    for (int ch = 0; ch < 3; ++ch)
#pragma unroll
      for (int i = 0; i < 4; ++i) o[ch][i] = lane(ct[ch], i);
  }

  const long long plane = (long long)H * W;
  OutT* const dst = out + (long long)y * W + x;
  const bool whole = x + 4 <= W && (W & 3) == 0;
  if constexpr (!CODES) {
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      if (whole) {
        *reinterpret_cast<float4*>(dst + ch * plane) =
            make_float4(o[ch][0], o[ch][1], o[ch][2], o[ch][3]);
      } else {
        for (int i = 0; i < 4 && x + i < W; ++i) dst[ch * plane + i] = o[ch][i];
      }
    }
  } else {
    // every lane's codes (a column past W holds its clamped column's
    // values), packed by shifts
    int q[4][3];
#pragma unroll
    for (int i = 0; i < 4; ++i) legacy_codes<OutT>(o[0][i], o[1][i], o[2][i], p, q[i]);
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      if (whole) {
        const unsigned a = q[0][ch], b = q[1][ch], c = q[2][ch], d = q[3][ch];
        if constexpr (sizeof(OutT) == 1)
          *reinterpret_cast<unsigned*>(dst + ch * plane) = a | b << 8 | c << 16 | d << 24;
        else
          *reinterpret_cast<uint2*>(dst + ch * plane) = make_uint2(a | b << 16, c | d << 16);
      } else {
        for (int i = 0; i < 4 && x + i < W; ++i) dst[ch * plane + i] = (OutT)q[i][ch];
      }
    }
  }
}

// the frame count and each frame's strides (in: floats, inv: bytes, out:
// elements)
struct Frames {
  int n;
  long long in, inv_bytes, out;
};

template <bool GAB, int EPF, typename OutT>
cudaError_t run_legacy(const Planes& in, int pad, int H, int W,
                       const void* inv, int inv_stride, int qf_rows,
                       int qf_row, void* out, const LegacyParams& p,
                       const Frames& f, cudaStream_t s) {
  const dim3 grid((W + LTW - 1) / LTW, (H + LTH - 1) / LTH, f.n);
  legacy_kernel<GAB, EPF, OutT><<<grid, LNT, 0, s>>>(
      in, pad, H, W, inv, inv_stride, qf_rows, qf_row,
      static_cast<OutT*>(out), p, f.in, f.inv_bytes, f.out);
  return cudaGetLastError();
}

template <bool GAB, int EPF>
cudaError_t run_legacy_out(int out_kind, const Planes& in, int pad, int H,
                           int W, const void* inv, int inv_stride,
                           int qf_rows, int qf_row, void* out,
                           const LegacyParams& p, const Frames& f,
                           cudaStream_t s) {
  switch (out_kind) {
    case 0: return run_legacy<GAB, EPF, float>(in, pad, H, W, inv, inv_stride, qf_rows, qf_row, out, p, f, s);
    case 1: return run_legacy<GAB, EPF, uint8_t>(in, pad, H, W, inv, inv_stride, qf_rows, qf_row, out, p, f, s);
    case 2: return run_legacy<GAB, EPF, uint16_t>(in, pad, H, W, inv, inv_stride, qf_rows, qf_row, out, p, f, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Round-1 filters.  in: three planes with channel stride `plane_stride`
// and row stride `row_stride`, pointing at row 0, with `pad` readable
// rows above and below.  epf: 0 none; 1 the per-pixel inverse sigma map
// `inv` (float32, row stride inv_stride, pointing at row 0 and padded as
// in is; gab and an f32 or u8 output only); 2 the per-8x8-block quant
// field `inv` (int32, qf_rows rows of row stride inv_stride; pixel row y
// reads block row (y + qf_row) >> 3, clamped to the field).  out_kind:
// 0 float32, 1 uint8, 2 uint16 sRGB, contiguous (3, H, W).  consts:
// k[9], cs[3], m[9], cbrt_bias, opsin_bias, inv_den; u8codes,
// u16poly, u16thr: the code tables on the device (LegacyParams), needed
// for out_kind 1 / 2; code_lo: the top 16 bits of their bucket 0.
// frames: how many frames of this size to filter in the launch; frame i's
// in, inv and out lie i * frame_in floats, i * frame_inv_bytes bytes and
// i * frame_out elements further on (frames 1 and 0 strides: one frame).
extern "C" int jxl_legacy_filters(const float* in, long long plane_stride,
                                  int row_stride, int pad, int H, int W,
                                  const void* inv, int inv_stride,
                                  int qf_rows, int qf_row, void* out,
                                  int gab, int epf, int out_kind,
                                  const float* consts, const void* u8codes,
                                  const void* u16poly, const void* u16thr,
                                  int code_lo, int frames, long long frame_in,
                                  long long frame_inv_bytes,
                                  long long frame_out, void* stream) {
  if (H <= 0 || W <= 0 || frames <= 0) return cudaSuccess;
  if (frames > 65535) return cudaErrorInvalidValue;
  const Frames f{frames, frame_in, frame_inv_bytes, frame_out};
  if ((out_kind == 1 && u8codes == nullptr) ||
      (out_kind == 2 && (u16poly == nullptr || u16thr == nullptr)))
    return cudaErrorInvalidValue;
  LegacyParams p;
  const float* k = consts;  // the 3x3 taps, row-major: symmetric
  if (k[2] != k[0] || k[6] != k[0] || k[8] != k[0] || k[3] != k[1] ||
      k[5] != k[1] || k[7] != k[1])
    return cudaErrorInvalidValue;
  p.kc = k[0];
  p.ke = k[1];
  p.km = k[4];
  for (int i = 0; i < 3; ++i) p.cs[i] = consts[9 + i];
  for (int i = 0; i < 9; ++i) p.m[i] = consts[12 + i];
  p.cbrt_bias = consts[21];
  p.opsin_bias = consts[22];
  p.inv_den = consts[23];
  p.u8codes = static_cast<const int2*>(u8codes) - code_lo;
  p.u16poly = static_cast<const float4*>(u16poly) - code_lo;
  p.u16thr = static_cast<const float*>(u16thr);
  p.code_lo = code_lo;
  const Planes pl{in, plane_stride, row_stride};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (epf) {
    case EPF_NONE:
      return gab ? run_legacy_out<true, EPF_NONE>(out_kind, pl, pad, H, W, inv, inv_stride, qf_rows, qf_row, out, p, f, s)
                 : run_legacy_out<false, EPF_NONE>(out_kind, pl, pad, H, W, inv, inv_stride, qf_rows, qf_row, out, p, f, s);
    case EPF_BLOCK:
      return gab ? run_legacy_out<true, EPF_BLOCK>(out_kind, pl, pad, H, W, inv, inv_stride, qf_rows, qf_row, out, p, f, s)
                 : run_legacy_out<false, EPF_BLOCK>(out_kind, pl, pad, H, W, inv, inv_stride, qf_rows, qf_row, out, p, f, s);
    case EPF_PIXEL:
      if (!gab || out_kind > 1) return cudaErrorInvalidValue;
      return run_legacy_out<true, EPF_PIXEL>(out_kind, pl, pad, H, W, inv, inv_stride, qf_rows, qf_row, out, p, f, s);
    default:
      return cudaErrorInvalidValue;
  }
}
