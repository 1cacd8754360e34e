// Fused restoration filters, one tile pass per frame: the TPU kernels
// 3-6 of jxl_coder_tpu/vardct/filters_pallas.py.
//
//   legacy_kernel<GAB, EPF, SRGB> replaces fused_gab_epf (_kernel, #5)
//     and fused_filters2 (_kernel2, #6): the round-1 codec's gaborish
//     (normalised 3x3, edge replicate) and one plus-shaped EPF pass
//     (pointwise 3-channel SAD, weight max(0, 1 - sad * inv), num / den),
//     optionally followed by XYB -> sRGB8 with glibc's powf, which is
//     what the jnp chain (pipeline.xyb_to_srgb8) runs on the CPU.
//   real_kernel<MIRROR, EPF2, OutT> replaces fused_real_filters
//     (_kernel_chain + _chain_math, #3; MIRROR) and fused_real_gab_epf1
//     (_kernel_real, #4; edge borders, no EPF2): the real-format gaborish,
//     EPF pass 1 (5-tap patch SADs summed over adjacent-difference planes,
//     2/3 on block borders, active where inv < 0), EPF pass 2 (pointwise
//     SADs on the edge-replicated pass-1 output) and FastLinearToSRGB.
//
// Each thread block owns a 32 x 8 output tile.  It computes the
// gaborish output of the tile and its halo into shared memory (1 pixel
// for the legacy EPF; 3 for the real-format EPF1 + EPF2, whose
// difference planes and pass-1 output also stay in shared memory), then
// filters from there, so the halo rows never make a round trip through
// device memory.  The halo is made by index math: the input rows a
// caller passes may carry `pad` rows of real or replicated neighbours
// above and below (the JAX functions' padded interface); rows beyond
// those are clamped, and the gaborish / EPF output is extended by
// libjxl's Mirror() or by edge replication as each TPU kernel does.  No
// width or height gate.
//
// What bounds it on the H100: at 4K the legacy kernel moves 12 B/px of
// XYB in, 4 B/px of inv and 12 (f32) or 3 (u8) B/px out, ~230 MB, ~70
// us at 3.35 TB/s; the real-format chain 12 B/px in and 12 or 3 out.
// The gaborish recompute over the halo (1.3x for the legacy tile, 2.1x
// for the real-format one, 27 cached loads each), the EPF SADs from
// shared memory and, for sRGB8, powf in float64 add a few hundred
// instructions per pixel on top; the tile is sized for occupancy, not
// tuned.  Every kernel builds with -fmad=false and sums in the twins'
// order (explicit fmaf only where XLA fuses: the 3x3 opsin mix).

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using namespace jxl;

constexpr int TX = 32, TY = 8, NT = TX * TY;

// glibc's powf tables (ops/fp.py POWF_F64 / POWF_I64).
struct PowfTables {
  double log2[32];  // (invc, logc) x 16
  double log2_poly[5];
  double exp2_poly[3];
  double shift;
  long long exp2[32];
  long long shift_bits;
};

// x ** y as glibc's powf rounds it, for positive normal x: ops/fp.py
// powf, operation for operation, in float64 without contraction.
__device__ float powf_glibc(float x, float y, const PowfTables& t) {
  const long long ix = (long long)__float_as_int(x);
  const long long tmp = ix - 0x3f330000LL;
  const int i = (int)((tmp >> 19) & 15);
  const long long k = tmp >> 23;
  const double z = (double)__int_as_float((int)(ix - k * (1LL << 23)));
  const double* A = t.log2_poly;
  const double r = z * t.log2[2 * i] - 1.0;
  const double y0 = t.log2[2 * i + 1] + (double)k;
  const double r2 = r * r;
  const double p5 = A[0] * r + A[1];
  const double p3 = A[2] * r + A[3];
  const double r4 = r2 * r2;
  double q = A[4] * r + y0;
  q = p3 * r2 + q;
  const double logx = p5 * r4 + q;
  const double xd = (double)y * logx;
  const double kd = xd + t.shift;
  const long long ki = __double_as_longlong(kd) - t.shift_bits;
  const double rr = xd - (kd - t.shift);
  const double s = __longlong_as_double(t.exp2[ki & 31] + ki * (1LL << 47));
  const double* C = t.exp2_poly;
  const double zz = C[0] * rr + C[1];
  double out = C[2] * rr + 1.0;
  out = zz * (rr * rr) + out;
  return (float)(out * s);
}

struct LegacyParams {
  float k[9];          // pipeline.gaborish_kernel(), row-major (dy, dx)
  float cs[3];         // pipeline.EPF_CHANNEL_SCALE
  float m[9];          // xyb.INV_OPSIN, row-major
  float cbrt_bias, opsin_bias;
  float inv_gamma;     // float32(1 / 2.4)
  PowfTables pw;
};

// pipeline.xyb_to_srgb8 for channel c: xyb_to_linear_rgb (the mix as a
// sequential fused sum, fp.contract3), clip, linear_to_srgb, round half
// to even.
__device__ uint8_t legacy_srgb8(float X, float Y, float B, int c,
                                const LegacyParams& p) {
  const float g0 = (X + Y) + p.cbrt_bias;
  const float g1 = (Y - X) + p.cbrt_bias;
  const float g2 = B + p.cbrt_bias;
  const float m0 = g0 * g0 * g0 - p.opsin_bias;
  const float m1 = g1 * g1 * g1 - p.opsin_bias;
  const float m2 = g2 * g2 * g2 - p.opsin_bias;
  float v = p.m[3 * c] * m0;
  v = fmaf(p.m[3 * c + 1], m1, v);
  v = fmaf(p.m[3 * c + 2], m2, v);
  v = fmaxf(fminf(fmaxf(v, 0.0f), 1.0f), 0.0f);
  const float s = v <= 0.0031308f
                      ? v * 12.92f
                      : 1.055f * powf_glibc(v, p.inv_gamma, p.pw) - 0.055f;
  return (uint8_t)fminf(fmaxf(rintf(s * 255.0f), 0.0f), 255.0f);
}

// in / inv point at the image's row 0; rows [-pad, H + pad) are
// readable.  inv: per-pixel inverse sigma, read at the centre pixel only.
// out: (3, H, W) float32, or uint8 with SRGB.
template <bool GAB, bool EPF, bool SRGB>
__global__ void __launch_bounds__(NT)
    legacy_kernel(Planes in, int pad, int H, int W,
                  const float* __restrict__ inv, int inv_stride,
                  void* __restrict__ out, LegacyParams p) {
  // gaborish output (or the input without GAB) at rows y0-1 .. y0+TY and
  // columns x0-1 .. x0+TX; columns clamp to the image, so the EPF's x
  // neighbour past the edge is the replicated gaborish OUTPUT, while its
  // y neighbour is the gaborish of the clamped input rows.
  __shared__ float P[3][TY + 2][TX + 2];
  const int x0 = blockIdx.x * TX, y0 = blockIdx.y * TY;
  const int tid = threadIdx.y * TX + threadIdx.x;
  const int ylo = -pad, yhi = H + pad - 1;
  if constexpr (GAB || EPF) {
    for (int i = tid; i < (TY + 2) * (TX + 2); i += NT) {
      const int r = i / (TX + 2), c = i % (TX + 2);
      const int yy = y0 - 1 + r;
      const int xx = clampi(x0 - 1 + c, W);
      for (int ch = 0; ch < 3; ++ch) {
        float v;
        if constexpr (GAB) {
          v = 0.0f;
          for (int dy = 0; dy < 3; ++dy) {
            const int sy = min(max(yy + dy - 1, ylo), yhi);
            for (int dx = 0; dx < 3; ++dx)
              v = v + p.k[3 * dy + dx] * at(in, ch, sy, clampi(xx + dx - 1, W));
          }
        } else {
          v = at(in, ch, min(max(yy, ylo), yhi), xx);
        }
        P[ch][r][c] = v;
      }
    }
    __syncthreads();
  }
  const int x = x0 + threadIdx.x, y = y0 + threadIdx.y;
  if (x >= W || y >= H) return;
  const int ly = threadIdx.y + 1, lx = threadIdx.x + 1;
  float o[3];
  if constexpr (EPF) {
    const float c0 = P[0][ly][lx], c1 = P[1][ly][lx], c2 = P[2][ly][lx];
    const float iv = inv[(long long)y * inv_stride + x];
    // pipeline._EPF_TAPS_CROSS: (0,-1), (-1,0), (0,0), (1,0), (0,1)
    const int tdy[5] = {0, -1, 0, 1, 0};
    const int tdx[5] = {-1, 0, 0, 0, 1};
    float n0 = 0.0f, n1 = 0.0f, n2 = 0.0f, den = 0.0f;
#pragma unroll
    for (int t = 0; t < 5; ++t) {
      const float s0 = P[0][ly + tdy[t]][lx + tdx[t]];
      const float s1 = P[1][ly + tdy[t]][lx + tdx[t]];
      const float s2 = P[2][ly + tdy[t]][lx + tdx[t]];
      float w = 1.0f;
      if (t != 2) {
        const float sad = fabsf(s0 - c0) * p.cs[0] + fabsf(s1 - c1) * p.cs[1] +
                          fabsf(s2 - c2) * p.cs[2];
        w = fmaxf(1.0f - sad * iv, 0.0f);
      }
      n0 = n0 + s0 * w;
      n1 = n1 + s1 * w;
      n2 = n2 + s2 * w;
      den = den + w;
    }
    o[0] = n0 / den;
    o[1] = n1 / den;
    o[2] = n2 / den;
  } else if constexpr (GAB) {
    for (int ch = 0; ch < 3; ++ch) o[ch] = P[ch][ly][lx];
  } else {
    for (int ch = 0; ch < 3; ++ch) o[ch] = at(in, ch, y, x);
  }
  const long long plane = (long long)H * W, px = (long long)y * W + x;
  for (int ch = 0; ch < 3; ++ch) {
    if constexpr (SRGB)
      static_cast<uint8_t*>(out)[ch * plane + px] =
          legacy_srgb8(o[0], o[1], o[2], ch, p);
    else
      static_cast<float*>(out)[ch * plane + px] = o[ch];
  }
}

struct RealParams {
  float k[9];          // gaborish taps / (1 + 4 (w1 + w2)), row-major
  float cs[3];         // dec_real.EPF_CHANNEL_SCALE
  float border_mul;    // 2/3 on block-border pixels
  float pass2_scale;   // EPF2 slope over EPF1's
  SrgbParams srgb;
};

template <bool MIRROR>
__device__ __forceinline__ int fold(int i, int n) {
  return MIRROR ? mirror(i, n) : clampi(i, n);
}

// in points at the image's row 0 with rows [-pad, H + pad) readable;
// inv: per-8x8-block EPF1 slope (negative where active, 0 where not).
// out: (3, H, W) of OutT (float, or uint8 / uint16 sRGB codes).
template <bool MIRROR, bool EPF2, typename OutT>
__global__ void __launch_bounds__(NT)
    real_kernel(Planes in, int pad, int H, int W,
                const float* __restrict__ inv, int inv_stride,
                OutT* __restrict__ out, RealParams p) {
  constexpr int GH = TY + 6, GW = TX + 6;
  // gaborish at rows y0-3 .. y0+TY+2, columns x0-3 .. x0+TX+2, folded
  // into the image (Mirror or edge); Dh / Dv: the channel-weighted
  // absolute differences of horizontal / vertical neighbours in G.
  __shared__ float G[3][GH][GW];
  __shared__ float Dh[GH][GW - 1];
  __shared__ float Dv[GH - 1][GW];
  // EPF1 output at rows y0-1 .. y0+TY, columns x0-1 .. x0+TX, edge
  // replicated at the image border (EPF2 only).
  __shared__ float E[EPF2 ? 3 : 1][TY + 2][TX + 2];
  const int x0 = blockIdx.x * TX, y0 = blockIdx.y * TY;
  const int tid = threadIdx.y * TX + threadIdx.x;
  const int ylo = -pad, yhi = H + pad - 1;
  for (int i = tid; i < GH * GW; i += NT) {
    const int r = i / GW, c = i % GW;
    const int R = fold<MIRROR>(y0 - 3 + r, H), C = fold<MIRROR>(x0 - 3 + c, W);
    for (int ch = 0; ch < 3; ++ch) {
      float v = 0.0f;
      for (int dy = 0; dy < 3; ++dy) {
        const int sy = min(max(R + dy - 1, ylo), yhi);
        for (int dx = 0; dx < 3; ++dx)
          v = v + p.k[3 * dy + dx] * at(in, ch, sy, clampi(C + dx - 1, W));
      }
      G[ch][r][c] = v;
    }
  }
  __syncthreads();
  for (int i = tid; i < GH * (GW - 1); i += NT) {
    const int r = i / (GW - 1), c = i % (GW - 1);
    float d = 0.0f;
    for (int ch = 0; ch < 3; ++ch)
      d = d + p.cs[ch] * fabsf(G[ch][r][c] - G[ch][r][c + 1]);
    Dh[r][c] = d;
  }
  for (int i = tid; i < (GH - 1) * GW; i += NT) {
    const int r = i / GW, c = i % GW;
    float d = 0.0f;
    for (int ch = 0; ch < 3; ++ch)
      d = d + p.cs[ch] * fabsf(G[ch][r][c] - G[ch][r + 1][c]);
    Dv[r][c] = d;
  }
  __syncthreads();

  // EPF1 at image pixel (R, C), which lies in rows y0-1 .. y0+TY.
  auto epf1 = [&](int R, int C, float o[3]) {
    const int lr = R - (y0 - 3), lc = C - (x0 - 3);
    const float iv = inv[(R >> 3) * inv_stride + (C >> 3)];
    for (int ch = 0; ch < 3; ++ch) o[ch] = G[ch][lr][lc];
    if (!(iv < 0.0f)) return;
    const bool border = (R & 7) == 0 || (R & 7) == 7 || (C & 7) == 0 ||
                        (C & 7) == 7;
    const float ivb = border ? iv * p.border_mul : iv;
    // patch taps (0,0), (0,1), (0,-1), (1,0), (-1,0)
    const int ty[5] = {0, 0, 0, 1, -1};
    const int tx[5] = {0, 1, -1, 0, 0};
    float sad[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int t = 0; t < 5; ++t) {
      sad[0] = sad[0] + Dh[lr + ty[t]][lc + tx[t]];          // ( 0,  1)
      sad[1] = sad[1] + Dh[lr + ty[t]][lc + tx[t] - 1];      // ( 0, -1)
      sad[2] = sad[2] + Dv[lr + ty[t]][lc + tx[t]];          // ( 1,  0)
      sad[3] = sad[3] + Dv[lr + ty[t] - 1][lc + tx[t]];      // (-1,  0)
    }
    const int ndy[4] = {0, 0, 1, -1}, ndx[4] = {1, -1, 0, 0};
    float den = 1.0f, n[3] = {o[0], o[1], o[2]};
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      const float w = fmaxf(1.0f + sad[d] * ivb, 0.0f);
      den = den + w;
      for (int ch = 0; ch < 3; ++ch)
        n[ch] = n[ch] + w * G[ch][lr + ndy[d]][lc + ndx[d]];
    }
    const float inv_den = 1.0f / den;
    for (int ch = 0; ch < 3; ++ch) o[ch] = n[ch] * inv_den;
  };

  const int x = x0 + threadIdx.x, y = y0 + threadIdx.y;
  float o[3];
  if constexpr (EPF2) {
    for (int i = tid; i < (TY + 2) * (TX + 2); i += NT) {
      const int r = i / (TX + 2), c = i % (TX + 2);
      float e[3];
      epf1(clampi(y0 - 1 + r, H), clampi(x0 - 1 + c, W), e);
      for (int ch = 0; ch < 3; ++ch) E[ch][r][c] = e[ch];
    }
    __syncthreads();
    if (x >= W || y >= H) return;
    const int ly = threadIdx.y + 1, lx = threadIdx.x + 1;
    for (int ch = 0; ch < 3; ++ch) o[ch] = E[ch][ly][lx];
    const float iv = inv[(y >> 3) * inv_stride + (x >> 3)];
    if (iv < 0.0f) {
      const bool border = (y & 7) == 0 || (y & 7) == 7 || (x & 7) == 0 ||
                          (x & 7) == 7;
      const float inv2 = (border ? iv * p.border_mul : iv) * p.pass2_scale;
      const int ndy[4] = {0, 0, 1, -1}, ndx[4] = {1, -1, 0, 0};
      float den = 1.0f, n[3] = {o[0], o[1], o[2]};
#pragma unroll
      for (int d = 0; d < 4; ++d) {
        float nb[3], sad = 0.0f;
        for (int ch = 0; ch < 3; ++ch) {
          nb[ch] = E[ch][ly + ndy[d]][lx + ndx[d]];
          sad = sad + p.cs[ch] * fabsf(o[ch] - nb[ch]);
        }
        const float w = fmaxf(1.0f + sad * inv2, 0.0f);
        den = den + w;
        for (int ch = 0; ch < 3; ++ch) n[ch] = n[ch] + w * nb[ch];
      }
      const float inv_den = 1.0f / den;
      for (int ch = 0; ch < 3; ++ch) o[ch] = n[ch] * inv_den;
    }
  } else {
    if (x >= W || y >= H) return;
    epf1(y, x, o);
  }
  const long long plane = (long long)H * W, px = (long long)y * W + x;
  if constexpr (sizeof(OutT) == 4) {
    for (int ch = 0; ch < 3; ++ch) out[ch * plane + px] = o[ch];
  } else {
    float q[3];
    xyb_to_srgb_codes(o[0], o[1], o[2], p.srgb, p.srgb.mul, q);
    for (int ch = 0; ch < 3; ++ch) out[ch * plane + px] = (OutT)q[ch];
  }
}

dim3 tiles(int H, int W) { return dim3((W + TX - 1) / TX, (H + TY - 1) / TY); }

template <bool GAB, bool EPF, bool SRGB>
void launch_legacy(const Planes& in, int pad, int H, int W, const float* inv,
                   int inv_stride, void* out, const LegacyParams& p,
                   cudaStream_t s) {
  legacy_kernel<GAB, EPF, SRGB><<<tiles(H, W), dim3(TX, TY), 0, s>>>(
      in, pad, H, W, inv, inv_stride, out, p);
}

template <bool MIRROR, bool EPF2, typename OutT>
void launch_real(const Planes& in, int pad, int H, int W, const float* inv,
                 int inv_stride, void* out, const RealParams& p,
                 cudaStream_t s) {
  real_kernel<MIRROR, EPF2, OutT><<<tiles(H, W), dim3(TX, TY), 0, s>>>(
      in, pad, H, W, inv, inv_stride, static_cast<OutT*>(out), p);
}

void copy_powf(PowfTables& t, const double* f64, const long long* i64) {
  for (int i = 0; i < 32; ++i) t.log2[i] = f64[i];
  for (int i = 0; i < 5; ++i) t.log2_poly[i] = f64[32 + i];
  for (int i = 0; i < 3; ++i) t.exp2_poly[i] = f64[37 + i];
  t.shift = f64[40];
  for (int i = 0; i < 32; ++i) t.exp2[i] = i64[i];
  t.shift_bits = i64[32];
}

}  // namespace

// in: three planes with channel stride `plane_stride` and row stride
// `row_stride`, pointing at row 0, with `pad` readable rows above and
// below; inv likewise per pixel (unused without epf).  out: contiguous
// (3, H, W) float32, or uint8 with srgb.  consts: k[9], cs[3], m[9],
// cbrt_bias, opsin_bias, inv_gamma; pw_f64 / pw_i64: the powf tables.
extern "C" int jxl_legacy_filters(const float* in, long long plane_stride,
                                  int row_stride, int pad, int H, int W,
                                  const float* inv, int inv_stride, void* out,
                                  int gab, int epf, int srgb,
                                  const float* consts, const double* pw_f64,
                                  const long long* pw_i64, void* stream) {
  if (H <= 0 || W <= 0) return cudaSuccess;
  LegacyParams p;
  for (int i = 0; i < 9; ++i) p.k[i] = consts[i];
  for (int i = 0; i < 3; ++i) p.cs[i] = consts[9 + i];
  for (int i = 0; i < 9; ++i) p.m[i] = consts[12 + i];
  p.cbrt_bias = consts[21];
  p.opsin_bias = consts[22];
  p.inv_gamma = consts[23];
  copy_powf(p.pw, pw_f64, pw_i64);
  const Planes pl{in, plane_stride, row_stride};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((gab ? 4 : 0) | (epf ? 2 : 0) | (srgb ? 1 : 0)) {
    case 1: launch_legacy<false, false, true>(pl, pad, H, W, inv, inv_stride, out, p, s); break;
    case 2: launch_legacy<false, true, false>(pl, pad, H, W, inv, inv_stride, out, p, s); break;
    case 3: launch_legacy<false, true, true>(pl, pad, H, W, inv, inv_stride, out, p, s); break;
    case 4: launch_legacy<true, false, false>(pl, pad, H, W, inv, inv_stride, out, p, s); break;
    case 5: launch_legacy<true, false, true>(pl, pad, H, W, inv, inv_stride, out, p, s); break;
    case 6: launch_legacy<true, true, false>(pl, pad, H, W, inv, inv_stride, out, p, s); break;
    case 7: launch_legacy<true, true, true>(pl, pad, H, W, inv, inv_stride, out, p, s); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// Real-format chain.  in / pad as above; inv: per-block EPF1 slope with
// row stride inv_stride.  mirror: 1 for fused_real_filters (Mirror
// borders), 0 for fused_real_gab_epf1 (edge); epf2: run EPF pass 2;
// out_kind: 0 float32, 1 uint8, 2 uint16 sRGB.  consts: k[9], cs[3],
// border_mul, pass2_scale; srgb: 9 opsin-inverse floats, cbrt_bias, bias;
// mul: 16 uint32.
extern "C" int jxl_real_filters(const float* in, long long plane_stride,
                                int row_stride, int pad, int H, int W,
                                const float* inv, int inv_stride, void* out,
                                int mirror, int epf2, int out_kind,
                                const float* consts, const float* srgb,
                                const uint32_t* mul, void* stream) {
  if (H <= 0 || W <= 0) return cudaSuccess;
  RealParams p;
  for (int i = 0; i < 9; ++i) p.k[i] = consts[i];
  for (int i = 0; i < 3; ++i) p.cs[i] = consts[9 + i];
  p.border_mul = consts[12];
  p.pass2_scale = consts[13];
  for (int i = 0; i < 9; ++i) p.srgb.m[i] = srgb[i];
  p.srgb.cbrt_bias = srgb[9];
  p.srgb.bias = srgb[10];
  p.srgb.scale = out_kind == 2 ? 65535.0f : 255.0f;
  for (int i = 0; i < 16; ++i) p.srgb.mul[i] = mul[i];
  const Planes pl{in, plane_stride, row_stride};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((mirror ? 8 : 0) | (epf2 ? 4 : 0) | out_kind) {
    case 0: launch_real<false, false, float>(pl, pad, H, W, inv, inv_stride, out, p, s); break;
    case 1: launch_real<false, false, uint8_t>(pl, pad, H, W, inv, inv_stride, out, p, s); break;
    case 8: launch_real<true, false, float>(pl, pad, H, W, inv, inv_stride, out, p, s); break;
    case 9: launch_real<true, false, uint8_t>(pl, pad, H, W, inv, inv_stride, out, p, s); break;
    case 10: launch_real<true, false, uint16_t>(pl, pad, H, W, inv, inv_stride, out, p, s); break;
    case 12: launch_real<true, true, float>(pl, pad, H, W, inv, inv_stride, out, p, s); break;
    case 13: launch_real<true, true, uint8_t>(pl, pad, H, W, inv, inv_stride, out, p, s); break;
    case 14: launch_real<true, true, uint16_t>(pl, pad, H, W, inv, inv_stride, out, p, s); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
