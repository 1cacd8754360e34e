// The VarDCT post stages: noise (A5), upsampling (A6) and the output
// encoding (A7, with the quarter-scale decode's `down` pool, S1, as a
// variant), each a kernel with a plain C entry point (vardct/post.py binds
// them; their plain twins are there too).
//
// They replace jnp passes of the JAX package's device path (fn_post in
// jxl_coder_tpu/vardct/tpu_full.py), not Pallas kernels:
//   A5 noise_kernel: _conv_subbox_device (:606), _noise_strength_device
//      (:619) and the combine (:841-855).  X/Y/B += k0 * (red -+ green),
//      red and green from the 5x5 mirrored box of three random planes and
//      the 8-knot lut of (Y +- X) / 2.  Bound by bytes: 36 B a pixel (XYB
//      read and written, the random planes read) against ~43 operations.
//      A block owns a 32 x 8 tile; the random planes' tile with
//      its 2-pixel mirrored halo sits in shared memory (each sample read
//      from device memory about 1.6 times, not 25), the lut too.
//   A6 upsample_kernel<N>: _upsample_plane_device (:632).  Each output
//      pixel is its phase's 25 weights times its 5x5 mirrored source
//      window, clamped to the window's [min, max].  A thread per source
//      pixel computes the window's min and max once and writes its N x N
//      outputs; the source tile with its halo and the N*N*25 weights
//      (at most 6.4 KB) are in shared memory; blockIdx.z walks the planes,
//      so the three colour planes (or the extra channels) take one launch.
//      Bound by bytes at every N (4 + 4 N^2 B against ~52 N^2 operations
//      a source pixel).
//   A7 encode_output_kernel<OutT, false>: _encode_output_device (:676) with
//      _xyb_to_linear_device (:649) and _quantize_device (:669).  A pixel
//      a thread: XYB -> linear -> [3x3 gamut] -> sRGB (xyb_to_srgb_codes of
//      common.cuh, kernel 2's own output step), gamma, PQ, HLG with the
//      inverse OOTF, or a named transfer function -> floor(v * max + 0.5)
//      clipped.  Its byte bound is 12 B in and 3 or 6 B out a pixel; the
//      PQ and HLG cases' powf / logf calls make it issue-bound in practice.
//      Its YCbCr case (kind 3, a JPEG recompression frame; _encode_output_
//      device's "ycbcr", tpu_full.py:685-690): the planes are (Cb, Y, Cr),
//      Y + 128/255, then BT.601 in f32 in the reference's order, then the
//      same codes; no transfer function.
//   S1 encode_output_kernel<OutT, true>: the `down` stage of fn_post
//      (tpu_full.py:862-876) read by A7.  Each output pixel first averages
//      its down x down cell of the XYB planes (rows and columns past the
//      edge repeat the last one, as the reference's edge padding), summed
//      row by row, then encodes the means as A7 does.  The quarter-scale
//      decode's planes are read once and 1/16 of the codes written: bound
//      by bytes (12 B read a source pixel).  The pool needs no shared
//      memory: a thread's 4 x 4 cell is 4 rows of 16 contiguous bytes a
//      plane, and a warp's cells are neighbours.  down 1 is the plain A7
//      instantiation, unchanged.
// Full-precision powf / logf / expf / sqrtf (no --use_fast_math), and
// -fmad=false, so each operation rounds once, in the twins' order.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using namespace jxl;

constexpr int TW = 32;   // tile width (a warp)
constexpr int TH = 8;    // tile height
constexpr int R = 2;     // the 5x5 window's reach
constexpr int SW = TW + 2 * R;
constexpr int SH = TH + 2 * R;
constexpr float kNoiseK0 = -0.8730846f;

__host__ __device__ inline unsigned cdiv(long long a, int b) {
  return (unsigned)((a + b - 1) / b);
}

// ---- A5 ----

// The 8-knot piecewise-linear lut at v (noise.py _strength: scale 6,
// clamped below 0, flat beyond knot 7).
__device__ __forceinline__ float strength(const float* lut, float v) {
  const float sc = fmaxf(v * 6.0f, 0.0f);
  const float fl = floorf(sc);
  const bool over = sc >= 7.0f;
  const int idx = over ? 6 : min((int)fl, 6);
  const float frac = over ? 1.0f : sc - fl;
  return lut[idx] * (1.0f - frac) + lut[min(idx + 1, 7)] * frac;
}

__global__ void __launch_bounds__(TW * TH)
    noise_kernel(float* __restrict__ xyb, long long plane,
                 const float* __restrict__ rnd,
                 const float* __restrict__ lut, int H, int W) {
  __shared__ float s_rnd[3][SH][SW];
  __shared__ float s_lut[8];
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
  const int tid = threadIdx.y * TW + threadIdx.x;
  if (tid < 8) s_lut[tid] = lut[tid];
  for (int i = tid; i < 3 * SH * SW; i += TW * TH) {
    const int c = i / (SH * SW), r = i % (SH * SW);
    const int gy = mirror(y0 + r / SW - R, H);
    const int gx = mirror(x0 + r % SW - R, W);
    s_rnd[c][r / SW][r % SW] = rnd[c * plane + (long long)gy * W + gx];
  }
  __syncthreads();
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int x = x0 + tx, y = y0 + ty;
  if (x >= W || y >= H) return;
  float conv[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float s = 0.0f;
#pragma unroll
    for (int dy = 0; dy < 5; ++dy)
#pragma unroll
      for (int dx = 0; dx < 5; ++dx) s = s + s_rnd[c][ty + dy][tx + dx];
    conv[c] = s_rnd[c][ty + R][tx + R] - s / 25.0f;
  }
  const long long o = (long long)y * W + x;
  const float X = xyb[o], Y = xyb[plane + o], B = xyb[2 * plane + o];
  const float sr = strength(s_lut, (Y + X) * 0.5f);
  const float sg = strength(s_lut, (Y - X) * 0.5f);
  // / 128 is a power of two: the product by its inverse is exact
  const float red = sr * (conv[2] + conv[0] * 0.0078125f);
  const float green = sg * (conv[2] + conv[1] * 0.0078125f);
  xyb[o] = X + kNoiseK0 * (red - green);
  xyb[plane + o] = Y + kNoiseK0 * (red + green);
  xyb[2 * plane + o] = B + kNoiseK0 * (red + green);
}

// ---- A6 ----

template <int N>
__global__ void __launch_bounds__(TW * TH)
    upsample_kernel(const float* __restrict__ in, long long in_plane,
                    long long in_row, const float* __restrict__ ker,
                    float* __restrict__ out, int H, int W) {
  __shared__ float s_in[SH][SW];
  __shared__ float s_k[N * N * 25];
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
  const int tid = threadIdx.y * TW + threadIdx.x;
  const float* src = in + blockIdx.z * in_plane;
  for (int i = tid; i < SH * SW; i += TW * TH) {
    const int gy = mirror(y0 + i / SW - R, H);
    const int gx = mirror(x0 + i % SW - R, W);
    s_in[i / SW][i % SW] = src[(long long)gy * in_row + gx];
  }
  for (int i = tid; i < N * N * 25; i += TW * TH) s_k[i] = ker[i];
  __syncthreads();
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int x = x0 + tx, y = y0 + ty;
  if (x >= W || y >= H) return;
  float win[25];
  float lo = s_in[ty][tx], hi = lo;
#pragma unroll
  for (int k = 0; k < 25; ++k) {
    win[k] = s_in[ty + k / 5][tx + k % 5];
    lo = fminf(lo, win[k]);
    hi = fmaxf(hi, win[k]);
  }
  const long long ow = (long long)W * N;
  float* dst = out + blockIdx.z * ((long long)H * N * ow) +
               (long long)y * N * ow + (long long)x * N;
  for (int py = 0; py < N; ++py) {
#pragma unroll
    for (int px = 0; px < N; ++px) {
      const float* k = s_k + (py * N + px) * 25;
      float acc = k[0] * win[0];
#pragma unroll
      for (int j = 1; j < 25; ++j) acc = acc + k[j] * win[j];
      dst[py * ow + px] = fminf(fmaxf(acc, lo), hi);
    }
  }
}

// ---- A7 ----

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

struct OutParams {
  int kind;      // 0 sRGB, 1 gamma, 2 a signalled encoding, 3 YCbCr
  int trc;       // its transfer function (headers.TransferFunction)
  float maxv;    // 2^bits - 1
  float prm[N_PRM];
  SrgbParams srgb;
};

__device__ __forceinline__ float sgn(float v) {
  return (float)((v > 0.0f) - (v < 0.0f));
}

// LINEAR_TO_TRC.get(trc, linear_to_srgb) of ops/color.py on v >= 0
__device__ __forceinline__ float linear_to_trc(float v, int trc,
                                               const float* p) {
  switch (trc) {
    case 8:
      return v;
    case 1:
      return v < 0.018f ? v * 4.5f : 1.099f * powf(v, p[P_BT709_E]) - 0.099f;
    case 16: {
      const float q = powf(v, p[P_PQ]);
      return powf((p[P_PQ + 2] + p[P_PQ + 3] * q) / (1.0f + p[P_PQ + 4] * q),
                  p[P_PQ + 1]);
    }
    case 17:
      return powf(v, p[P_DCI_E]);
    case 18:
      return v <= p[P_TWELFTH]
                 ? sqrtf(3.0f * v)
                 : p[P_HLG] * logf(fmaxf(12.0f * v - p[P_HLG + 1], 1e-12f)) +
                       p[P_HLG + 2];
    default:
      return v <= 0.0031308f ? v * 12.92f
                             : 1.055f * powf(v, p[P_SRGB_E]) - 0.055f;
  }
}

// H, W: the planes' size; without POOL the output's too, with POOL the
// output is (ceil(H / down), ceil(W / down)).
template <typename OutT, bool POOL>
__global__ void __launch_bounds__(TW * TH)
    encode_output_kernel(const float* __restrict__ in, long long plane,
                         long long row, OutT* __restrict__ out, int H, int W,
                         int down, OutParams p) {
  const int x = blockIdx.x * TW + threadIdx.x;
  const int y = blockIdx.y * TH + threadIdx.y;
  const int Wo = POOL ? (W + down - 1) / down : W;
  const int Ho = POOL ? (H + down - 1) / down : H;
  if (x >= Wo || y >= Ho) return;
  float X, Y, B;
  if (POOL) {
    float sx = 0.0f, sy = 0.0f, sb = 0.0f;
    for (int dy = 0; dy < down; ++dy) {
      const long long r = (long long)min(y * down + dy, H - 1) * row;
      for (int dx = 0; dx < down; ++dx) {
        const long long o = r + min(x * down + dx, W - 1);
        sx = sx + in[o];
        sy = sy + in[plane + o];
        sb = sb + in[2 * plane + o];
      }
    }
    const float n = (float)(down * down);
    X = sx / n;
    Y = sy / n;
    B = sb / n;
  } else {
    const long long o = (long long)y * row + x;
    X = in[o];
    Y = in[plane + o];
    B = in[2 * plane + o];
  }
  OutT* dst = out + ((long long)y * Wo + x) * 3;
  float q[3];
  if (p.kind == 0) {
    xyb_to_srgb_codes(X, Y, B, p.srgb, p.srgb.mul, q);
  } else if (p.kind == 3) {
    // (Cb, Y, Cr): the f32 values of 128 / 255 and of BT.601's constants
    const float yp = Y + 0.501960814f;
    const float enc[3] = {yp + 1.40199995f * B,
                          (yp - 0.344136f * X) - 0.714136004f * B,
                          yp + 1.77199996f * X};
#pragma unroll
    for (int c = 0; c < 3; ++c)
      q[c] = fminf(fmaxf(floorf(enc[c] * p.maxv + 0.5f), 0.0f), p.maxv);
  } else {
    const SrgbParams& s = p.srgb;
    const float gr = Y + X + s.cbrt_bias;
    const float gg = Y - X + s.cbrt_bias;
    const float gb = B + s.cbrt_bias;
    const float ml = gr * gr * gr - s.bias;
    const float mm = gg * gg * gg - s.bias;
    const float ms = gb * gb * gb - s.bias;
    float lin[3], enc[3];
#pragma unroll
    for (int c = 0; c < 3; ++c)
      lin[c] = s.m[3 * c] * ml + s.m[3 * c + 1] * mm + s.m[3 * c + 2] * ms;
    if (p.kind == 1) {
#pragma unroll
      for (int c = 0; c < 3; ++c)
        enc[c] = powf(fmaxf(lin[c], 0.0f), p.prm[P_EXP]);
    } else {
      const float* g = p.prm + P_GM;
      float l[3];
#pragma unroll
      for (int c = 0; c < 3; ++c)
        l[c] = g[3 * c] * lin[0] + g[3 * c + 1] * lin[1] +
               g[3 * c + 2] * lin[2];
      if (p.trc == 18) {
        float d[3];
#pragma unroll
        for (int c = 0; c < 3; ++c) d[c] = l[c] * p.prm[P_DISP];
        const float* lw = p.prm + P_LUMA;
        const float yd = lw[0] * d[0] + lw[1] * d[1] + lw[2] * d[2];
        const float f = yd > 1e-9f ? powf(fabsf(yd), p.prm[P_EXP]) : 0.0f;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float sc = d[c] * f;
          enc[c] = sgn(sc) * linear_to_trc(fminf(fabsf(sc), 1.0f), 18, p.prm);
        }
      } else {
        const float scale = p.trc == 16 ? p.prm[P_PQ_SCALE] : 1.0f;
#pragma unroll
        for (int c = 0; c < 3; ++c)
          enc[c] = sgn(l[c]) * linear_to_trc(fabsf(l[c]) * scale, p.trc, p.prm);
      }
    }
#pragma unroll
    for (int c = 0; c < 3; ++c)
      q[c] = fminf(fmaxf(floorf(enc[c] * p.maxv + 0.5f), 0.0f), p.maxv);
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) dst[c] = (OutT)q[c];
}

template <int N>
cudaError_t launch_upsample(const float* in, long long in_plane,
                            long long in_row, const float* ker, float* out,
                            int C, int H, int W, cudaStream_t s) {
  const dim3 grid(cdiv(W, TW), cdiv(H, TH), C);
  upsample_kernel<N><<<grid, dim3(TW, TH), 0, s>>>(in, in_plane, in_row, ker,
                                                   out, H, W);
  return cudaGetLastError();
}

}  // namespace

// xyb: (3, H, W) contiguous, plane = H * W; rnd: (3, H, W) contiguous;
// lut: 8 floats.  In place.
extern "C" int jxl_add_noise(float* xyb, long long plane, const float* rnd,
                             const float* lut, int H, int W, void* stream) {
  if (H <= 0 || W <= 0) return cudaSuccess;
  const dim3 grid(cdiv(W, TW), cdiv(H, TH));
  noise_kernel<<<grid, dim3(TW, TH), 0, static_cast<cudaStream_t>(stream)>>>(
      xyb, plane, rnd, lut, H, W);
  return cudaGetLastError();
}

// in: C planes (H, W) with the given plane and row strides; ker: (n, n, 5,
// 5); out: (C, n * H, n * W) contiguous.
extern "C" int jxl_upsample(const float* in, long long in_plane,
                            long long in_row, const float* ker, float* out,
                            int C, int H, int W, int n, void* stream) {
  if (C <= 0 || H <= 0 || W <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 2:
      return launch_upsample<2>(in, in_plane, in_row, ker, out, C, H, W, s);
    case 4:
      return launch_upsample<4>(in, in_plane, in_row, ker, out, C, H, W, s);
    case 8:
      return launch_upsample<8>(in, in_plane, in_row, ker, out, C, H, W, s);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename OutT>
void launch_encode_output(const float* in, long long plane, long long row,
                          void* out, int H, int W, int down,
                          const OutParams& p, cudaStream_t s) {
  const int Ho = (H + down - 1) / down, Wo = (W + down - 1) / down;
  const dim3 grid(cdiv(Wo, TW), cdiv(Ho, TH));
  if (down == 1)
    encode_output_kernel<OutT, false><<<grid, dim3(TW, TH), 0, s>>>(
        in, plane, row, static_cast<OutT*>(out), H, W, 1, p);
  else
    encode_output_kernel<OutT, true><<<grid, dim3(TW, TH), 0, s>>>(
        in, plane, row, static_cast<OutT*>(out), H, W, down, p);
}

// in: (3, H, W) XYB with the given plane and row strides; out: (ceil(H /
// down), ceil(W / down), 3) uint8 (bits <= 8) or uint16, each pixel the
// encoding of its down x down cell's mean (down 1: of the pixel); kind 0
// sRGB, 1 gamma, 2 the signalled encoding with transfer function trc, 3
// YCbCr (the planes are Cb, Y, Cr); prm:
// N_PRM floats; srgb: the opsin inverse (9), the cube-root bias and the
// bias; mul: the 16 FastLinearToSRGB multipliers.
extern "C" int jxl_encode_output(const float* in, long long plane,
                                 long long row, void* out, int H, int W,
                                 int down, int kind, int trc, int bits,
                                 const float* prm, const float* srgb,
                                 const uint32_t* mul, void* stream) {
  if (H <= 0 || W <= 0) return cudaSuccess;
  if (kind < 0 || kind > 3 || bits < 1 || bits > 16 || down < 1)
    return cudaErrorInvalidValue;
  OutParams p;
  p.kind = kind;
  p.trc = trc;
  p.maxv = (float)((1 << bits) - 1);
  for (int i = 0; i < N_PRM; ++i) p.prm[i] = prm[i];
  for (int i = 0; i < 9; ++i) p.srgb.m[i] = srgb[i];
  p.srgb.cbrt_bias = srgb[9];
  p.srgb.bias = srgb[10];
  p.srgb.scale = p.maxv;
  for (int i = 0; i < 16; ++i) p.srgb.mul[i] = mul[i];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bits <= 8)
    launch_encode_output<uint8_t>(in, plane, row, out, H, W, down, p, s);
  else
    launch_encode_output<uint16_t>(in, plane, row, out, H, W, down, p, s);
  return cudaGetLastError();
}
