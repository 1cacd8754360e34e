// The sampled decode's pixel ops (S4): the reformat with its HDR -> SDR
// tone map, the alpha ops, the unpackers and the transparency scan, each
// with a plain C entry point (ops/pack.py, ops/tone.py and ops/alpha.py
// bind them; their plain twins are there).
//
// They replace jitted jnp code of the JAX package, not Pallas kernels:
//   reformat_kernel<T>: the tail of decode_sampled (jxl_coder_tpu/api.py:
//      1197-1214): codes / maxv; when asked, hdr_to_sdr (ops/color.py:310:
//      the stream's TRC to linear as encoding_trc_to_linear, the BT.2408
//      rational scale with the stream's luma row for PQ and HLG, the 3x3
//      to sRGB primaries, clip, linear_to_srgb, rint to codes and back to
//      [0, 1]); grey to RGB and an opaque alpha; then one of the packers of
//      ops/pack.py:12-60 (RGBA8888, F16, RGB565, RGBA1010102), or the
//      codes themselves (ops/tone.py's hdr_to_sdr).  A pixel a thread,
//      every step in registers: the codes are read once and the packed
//      pixel written once, so it is bound by bytes (3-8 B in, 2-8 B out)
//      but for the tone map's powf / expf, which make it issue-bound.
//   alpha_u8_kernel / alpha_f32_kernel: ops/alpha.py:11-43, premultiply
//      and unpremultiply of (..., 4) uint8 (the reference's integer
//      rounding) and float32.
//   unpack_kernel: ops/pack.py from_rgb565 / from_rgba1010102.
//   scan_kernel<T>: ops/alpha.py has_transparency: a flag set by any
//      alpha below its type's maximum (1.0 for floats).
// Full-precision powf / expf / logf (no --use_fast_math) and -fmad=false:
// each operation rounds once, in the twins' order; the 3-term dot products
// are explicit fmaf chains, as XLA's CPU dot sums a 3-term contraction
// (ops/fp.py contract3).  rintf is round half to even, as jnp.round.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__host__ __device__ inline unsigned cdiv(long long a, int b) {
  return (unsigned)((a + b - 1) / b);
}

// the tone map's parameters, as ops/tone.py params lays them out
enum {
  T_TRC = 0,      // the stream's transfer function (-1: a gamma)
  T_GAMMA = 1,    // gamma_to_linear's exponent, 1 / (gamma / 1e7)
  T_SCALE = 2,    // PQ 10000 / 203, HLG intensity_target / 203, else 1
  T_WA = 3,       // the BT.2408 weights a and b (PQ and HLG)
  T_WB = 4,
  T_LUMA = 5,     // the stream's luma row (3)
  T_M = 8,        // the 3x3 to sRGB primaries, row-major
  T_PQ = 17,      // PQ 1 / m2, c1, c2, c3, 1 / m1
  T_HLG = 22,     // HLG a, b, c
  T_E = 25,       // 1 / 0.45, 2.4, 2.6, 1 / 2.4
  N_T = 29
};

struct Tone {
  int on;         // 0: no tone map
  int trc;
  float p[N_T];
};

// TRC_TO_LINEAR.get(trc, srgb_to_linear), gamma_to_linear, then
// encoding_trc_to_linear's scale (ops/color.py:19-118,243-255)
__device__ __forceinline__ float to_linear(float v, const Tone& t) {
  const float* p = t.p;
  switch (t.trc) {
    case -1:
      return powf(fmaxf(v, 0.0f), p[T_GAMMA]);
    case 8:
      return v;
    case 1:
      return v < 0.081f ? v / 4.5f
                        : powf((v + 0.099f) / 1.099f, p[T_E]);
    case 16: {
      const float q = powf(fmaxf(v, 0.0f), p[T_PQ]);
      const float num = fmaxf(q - p[T_PQ + 1], 0.0f);
      const float den = p[T_PQ + 2] - p[T_PQ + 3] * q;
      return powf(num / den, p[T_PQ + 4]) * p[T_SCALE];
    }
    case 17:
      return powf(fmaxf(v, 0.0f), p[T_E + 2]);
    case 18: {
      const float x = fmaxf(v, 0.0f);
      const float l = x <= 0.5f ? x * x / 3.0f
                                : (expf((x - p[T_HLG + 2]) / p[T_HLG]) +
                                   p[T_HLG + 1]) / 12.0f;
      return l * p[T_SCALE];
    }
    default:
      return v <= 0.04045f ? v / 12.92f
                           : powf((v + 0.055f) / 1.055f, p[T_E + 1]);
  }
}

// hdr_to_sdr on one pixel's [0, 1] values v[0..2] -> the SDR codes / maxv
__device__ __forceinline__ void tone_to_sdr(float v[4], float maxv,
                                            const Tone& t) {
  const float* p = t.p;
  float lin[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) lin[c] = to_linear(v[c], t);
  if (t.trc == 16 || t.trc == 18) {
    const float* l = p + T_LUMA;
    float light = l[0] * lin[0];
    light = fmaf(l[1], lin[1], light);
    light = fmaf(l[2], lin[2], light);
    const float scale = light == 0.0f ? 1.0f
                                      : (1.0f + p[T_WA] * light) /
                                            (1.0f + p[T_WB] * light);
#pragma unroll
    for (int c = 0; c < 3; ++c) lin[c] = fminf(lin[c] * scale, 1.0f);
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float* m = p + T_M + 3 * c;
    float s = m[0] * lin[0];
    s = fmaf(m[1], lin[1], s);
    s = fmaf(m[2], lin[2], s);
    const float x = fminf(fmaxf(s, 0.0f), 1.0f);
    const float e = x <= 0.0031308f ? x * 12.92f
                                    : 1.055f * powf(x, p[T_E + 3]) - 0.055f;
    v[c] = fminf(fmaxf(rintf(e * maxv), 0.0f), maxv);
  }
}

__device__ __forceinline__ uint32_t q(float v, float scale) {
  return (uint32_t)fminf(fmaxf(rintf(v * scale), 0.0f), scale);
}

// fmt: 0 the codes (C channels, the tone-mapped colour), 1 RGBA8888, 2
// RGBA F16, 3 RGB565, 4 RGBA1010102.  Past 4 channels (C > 4) 8888 and F16
// pack every channel, C wide, 565 the first three and 1010102 the first
// four, as the reference's packers do on its (H, W, C) floats.
template <typename T>
__global__ void __launch_bounds__(THREADS)
    reformat_kernel(const T* __restrict__ in, long long n, int C, float maxv,
                    Tone tone, int fmt, void* __restrict__ out) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const T* src = in + i * C;
  float v[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) v[c] = c < C ? (float)src[c] : 0.0f;
  if (tone.on && C >= 3) {
#pragma unroll
    for (int c = 0; c < 3; ++c) v[c] = v[c] / maxv;
    tone_to_sdr(v, maxv, tone);   // v[0..2]: codes again
  }
  if (fmt == 0) {
    T* dst = static_cast<T*>(out) + i * C;
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (c < C) dst[c] = (T)v[c];
    for (int c = 4; c < C; ++c) dst[c] = src[c];
    return;
  }
  float r, g, b, a;
#pragma unroll
  for (int c = 0; c < 4; ++c) v[c] = v[c] / maxv;
  if (C <= 2) {
    r = g = b = v[0];
    a = C == 2 ? v[1] : 1.0f;
  } else {
    r = v[0];
    g = v[1];
    b = v[2];
    a = C >= 4 ? v[3] : 1.0f;
  }
  const int wide = C > 4 ? C : 4;
  switch (fmt) {
    case 1: {
      uint8_t* dst = static_cast<uint8_t*>(out) + i * wide;
      dst[0] = (uint8_t)q(r, 255.0f);
      dst[1] = (uint8_t)q(g, 255.0f);
      dst[2] = (uint8_t)q(b, 255.0f);
      dst[3] = (uint8_t)q(a, 255.0f);
      for (int c = 4; c < C; ++c)
        dst[c] = (uint8_t)q((float)src[c] / maxv, 255.0f);
      break;
    }
    case 2: {
      __half* dst = static_cast<__half*>(out) + i * wide;
      dst[0] = __float2half_rn(r);
      dst[1] = __float2half_rn(g);
      dst[2] = __float2half_rn(b);
      dst[3] = __float2half_rn(a);
      for (int c = 4; c < C; ++c)
        dst[c] = __float2half_rn((float)src[c] / maxv);
      break;
    }
    case 3:
      static_cast<uint16_t*>(out)[i] =
          (uint16_t)((q(r, 31.0f) << 11) | (q(g, 63.0f) << 5) | q(b, 31.0f));
      break;
    default:
      static_cast<uint32_t*>(out)[i] = q(r, 1023.0f) | (q(g, 1023.0f) << 10) |
                                       (q(b, 1023.0f) << 20) |
                                       (q(a, 3.0f) << 30);
  }
}

// op: 0 premultiply, 1 unpremultiply; (n, 4) pixels
__global__ void __launch_bounds__(THREADS)
    alpha_u8_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                    long long n, int op) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const uint8_t* s = in + 4 * i;
  uint8_t* d = out + 4 * i;
  const uint32_t a = s[3];
  for (int c = 0; c < 3; ++c) {
    const uint32_t v = s[c];
    uint32_t r;
    if (op == 0)
      r = (v * a + 127u) / 255u;
    else
      r = a == 0 ? 0u : min((v * 255u + a / 2u) / a, 255u);
    d[c] = (uint8_t)r;
  }
  d[3] = (uint8_t)a;
}

__global__ void __launch_bounds__(THREADS)
    alpha_f32_kernel(const float* __restrict__ in, float* __restrict__ out,
                     long long n, int op) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const float* s = in + 4 * i;
  float* d = out + 4 * i;
  const float a = s[3];
  for (int c = 0; c < 3; ++c)
    d[c] = op == 0 ? s[c] * a : (a > 0.0f ? s[c] / fmaxf(a, 1e-9f) : 0.0f);
  d[3] = a;
}

// fmt 3: (n,) uint16 RGB565 -> (n, 3); fmt 4: (n,) uint32 RGBA1010102 ->
// (n, 4) f32.  Each field times the float32 of 1 / its maximum, as XLA
// compiles the reference's division by a constant.
__global__ void __launch_bounds__(THREADS)
    unpack_kernel(const void* __restrict__ in, long long n, int fmt,
                  float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  if (fmt == 3) {
    const uint32_t v = static_cast<const uint16_t*>(in)[i];
    float* d = out + 3 * i;
    d[0] = (float)((v >> 11) & 31u) * (1.0f / 31.0f);
    d[1] = (float)((v >> 5) & 63u) * (1.0f / 63.0f);
    d[2] = (float)(v & 31u) * (1.0f / 31.0f);
  } else {
    const uint32_t v = static_cast<const uint32_t*>(in)[i];
    float* d = out + 4 * i;
    d[0] = (float)(v & 1023u) * (1.0f / 1023.0f);
    d[1] = (float)((v >> 10) & 1023u) * (1.0f / 1023.0f);
    d[2] = (float)((v >> 20) & 1023u) * (1.0f / 1023.0f);
    d[3] = (float)((v >> 30) & 3u) * (1.0f / 3.0f);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    scan_kernel(const T* __restrict__ in, long long n, T opaque,
                int* __restrict__ flag) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i < n && in[i] < opaque) *flag = 1;   // every writer stores 1
}

template <typename T>
void launch_reformat(const void* in, long long n, int C, float maxv,
                     const Tone& tone, int fmt, void* out, cudaStream_t s) {
  reformat_kernel<T><<<cdiv(n, THREADS), THREADS, 0, s>>>(
      static_cast<const T*>(in), n, C, maxv, tone, fmt, out);
}

}  // namespace

// in: (n, C) pixels, C 1..4, dtype 0 uint8, 1 uint16, 2 float32; maxv 255,
// 65535 or 1; tone: N_T floats (the first a flag, the second the transfer
// function) or null; fmt as reformat_kernel's; out: (n, C) of the input's
// type (fmt 0), (n, 4) uint8 / half (1, 2), (n,) uint16 / uint32 (3, 4).
extern "C" int jxl_reformat(const void* in, int dtype, long long n, int C,
                            float maxv, const float* tone, int fmt, void* out,
                            void* stream) {
  if (n <= 0) return cudaSuccess;
  if (C < 1 || fmt < 0 || fmt > 4 || (fmt == 0 && dtype == 2))
    return cudaErrorInvalidValue;
  Tone t{};
  if (tone != nullptr) {
    t.on = 1;
    t.trc = (int)tone[T_TRC];
    for (int i = 0; i < N_T; ++i) t.p[i] = tone[i];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      launch_reformat<uint8_t>(in, n, C, maxv, t, fmt, out, s);
      break;
    case 1:
      launch_reformat<uint16_t>(in, n, C, maxv, t, fmt, out, s);
      break;
    case 2:
      launch_reformat<float>(in, n, C, maxv, t, fmt, out, s);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// in, out: (n, 4); dtype 0 uint8, 2 float32; op 0 premultiply, 1
// unpremultiply
extern "C" int jxl_alpha(const void* in, void* out, int dtype, long long n,
                         int op, void* stream) {
  if (n <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    alpha_u8_kernel<<<cdiv(n, THREADS), THREADS, 0, s>>>(
        static_cast<const uint8_t*>(in), static_cast<uint8_t*>(out), n, op);
  else if (dtype == 2)
    alpha_f32_kernel<<<cdiv(n, THREADS), THREADS, 0, s>>>(
        static_cast<const float*>(in), static_cast<float*>(out), n, op);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

extern "C" int jxl_unpack(const void* in, long long n, int fmt, float* out,
                          void* stream) {
  if (n <= 0) return cudaSuccess;
  if (fmt != 3 && fmt != 4) return cudaErrorInvalidValue;
  unpack_kernel<<<cdiv(n, THREADS), THREADS, 0,
                  static_cast<cudaStream_t>(stream)>>>(in, n, fmt, out);
  return cudaGetLastError();
}

// in: n alpha samples, dtype 0 uint8, 1 uint16, 2 float32; flag: one int,
// zeroed by the caller, set to 1 if any sample is below its maximum
extern "C" int jxl_scan_alpha(const void* in, int dtype, long long n,
                              int* flag, void* stream) {
  if (n <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = cdiv(n, THREADS);
  if (dtype == 0)
    scan_kernel<uint8_t><<<grid, THREADS, 0, s>>>(
        static_cast<const uint8_t*>(in), n, (uint8_t)255, flag);
  else if (dtype == 1)
    scan_kernel<uint16_t><<<grid, THREADS, 0, s>>>(
        static_cast<const uint16_t*>(in), n, (uint16_t)65535, flag);
  else if (dtype == 2)
    scan_kernel<float><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(in), n, 1.0f, flag);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}
