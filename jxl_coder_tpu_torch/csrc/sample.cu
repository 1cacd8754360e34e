// The sampled decode's resampling: the 8x box of codes (S2) and the
// separable banded resample (S3), each with a plain C entry point
// (ops/sample.py and ops/resize.py bind them; their plain twins are there).
//
// They replace jitted jnp code of the JAX package, not Pallas kernels:
//   S2 box_kernel<T>: the 8x box average of a full decode's codes in
//      decode_thumbnail (jxl_coder_tpu/api.py:1062-1069,1101-1107): the
//      edge-padded mean of each 8 x 8 cell, np.rint (half to even).  The
//      sum is an integer below 2^22, so the kernel rounds it exactly with
//      integer arithmetic.  A thread an output sample (any channel
//      count: a sample is one channel of a pixel); bound by bytes
//      (each code read once, 1/64 of them written).
//   S3 resample_v_kernel<T> then resample_h_kernel<T>: resize_plane_stack
//      (jxl_coder_tpu/ops/resize.py:108) inside rescale_image (:131):
//      codes / maxv, alpha premultiplied, a vertical then a horizontal
//      pass of resample_matrix's weights, alpha unpremultiplied (clip(a,
//      1e-6, 1)), clip to [0, 1], rint(v * maxv).  The TPU form is two
//      dense matmuls (the MXU wants them); here each output reads only
//      its row's nonzero band (first index, length, weights, from the
//      host), so the work is ~(taps) multiply-adds an output and the
//      kernel is bound by bytes: the codes read once, the vertical
//      result (f32, only the kept rows) written and read once, the
//      output written once.  A thread a (row, column) of each pass, its
//      channels in groups of G in registers (G = C up to 4 channels, a
//      template parameter; beyond, groups of 4, the last one masked;
//      alpha is premultiplied only at C 2 or 4, one group, as the
//      reference).  Sums use fmaf in the band's order.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BOX = 8;
constexpr int THREADS = 256;

__host__ __device__ inline unsigned cdiv(long long a, int b) {
  return (unsigned)((a + b - 1) / b);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    box_kernel(const T* __restrict__ in, T* __restrict__ out, int H, int W,
               int C, int Ho, int Wo) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= (long long)Ho * Wo * C) return;
  const int c = (int)(i % C);
  const long long px = i / C;
  const int ox = (int)(px % Wo), oy = (int)(px / Wo);
  uint32_t s = 0;
  for (int dy = 0; dy < BOX; ++dy) {
    const long long row = (long long)min(oy * BOX + dy, H - 1) * W;
#pragma unroll
    for (int dx = 0; dx < BOX; ++dx)
      s += in[(row + min(ox * BOX + dx, W - 1)) * C + c];
  }
  // rint(s / 64), half to even
  uint32_t q = s >> 6;
  const uint32_t r = s & 63u;
  q += (r > 32u || (r == 32u && (q & 1u))) ? 1u : 0u;
  out[i] = (T)q;
}

// one pass's band: row o's weights w[o * stride + k], k < len[o], at input
// indices first[o] + k
struct Band {
  const int* first;
  const int* len;
  const float* w;
  int stride;
};

template <typename T>
__device__ __forceinline__ float unit(T v, float maxv) {
  return (float)v / maxv;
}

// t (rows, W, C) f32: row r of the kept rows, every column; the channels
// in groups of G, alpha premultiplied (premul: C == G, C 2 or 4)
template <typename T, int G>
__global__ void __launch_bounds__(THREADS)
    resample_v_kernel(const T* __restrict__ in, int W, int C, float maxv,
                      int premul, Band b, int rows, float* __restrict__ t) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= (long long)rows * W) return;
  const int x = (int)(i % W), r = (int)(i / W);
  const int f = b.first[r], n = b.len[r];
  const float* w = b.w + (long long)r * b.stride;
  for (int c0 = 0; c0 < C; c0 += G) {
    float acc[G];
#pragma unroll
    for (int c = 0; c < G; ++c) acc[c] = 0.0f;
    for (int k = 0; k < n; ++k) {
      const T* p = in + ((long long)(f + k) * W + x) * C + c0;
      float v[G];
#pragma unroll
      for (int c = 0; c < G; ++c)
        v[c] = c0 + c < C ? unit(p[c], maxv) : 0.0f;
      if (premul) {
        const float a = v[G - 1];
#pragma unroll
        for (int c = 0; c < G - 1; ++c) v[c] = v[c] * a;
      }
      const float wk = w[k];
#pragma unroll
      for (int c = 0; c < G; ++c) acc[c] = fmaf(wk, v[c], acc[c]);
    }
    float* dst = t + i * C + c0;
#pragma unroll
    for (int c = 0; c < G; ++c)
      if (c0 + c < C) dst[c] = acc[c];
  }
}

template <typename T>
__device__ __forceinline__ T store(float v, float maxv);
template <>
__device__ __forceinline__ uint8_t store<uint8_t>(float v, float maxv) {
  return (uint8_t)rintf(v * maxv);
}
template <>
__device__ __forceinline__ uint16_t store<uint16_t>(float v, float maxv) {
  return (uint16_t)rintf(v * maxv);
}
template <>
__device__ __forceinline__ float store<float>(float v, float) {
  return v;
}

// out (rows, cols, C): column p of the kept columns; the channels in
// groups of G, alpha divided out (unpremul: C == G, C 2 or 4)
template <typename T, int G>
__global__ void __launch_bounds__(THREADS)
    resample_h_kernel(const float* __restrict__ t, int W, int C, float maxv,
                      int unpremul, Band b, int rows, int cols,
                      T* __restrict__ out) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= (long long)rows * cols) return;
  const int p = (int)(i % cols), r = (int)(i / cols);
  const int f = b.first[p], n = b.len[p];
  const float* w = b.w + (long long)p * b.stride;
  for (int c0 = 0; c0 < C; c0 += G) {
    const float* src = t + ((long long)r * W + f) * C + c0;
    float acc[G];
#pragma unroll
    for (int c = 0; c < G; ++c) acc[c] = 0.0f;
    for (int k = 0; k < n; ++k) {
      const float wk = w[k];
#pragma unroll
      for (int c = 0; c < G; ++c)
        if (c0 + c < C) acc[c] = fmaf(wk, src[k * C + c], acc[c]);
    }
    if (unpremul) {
      const float a = fminf(fmaxf(acc[G - 1], 1e-6f), 1.0f);
#pragma unroll
      for (int c = 0; c < G - 1; ++c) acc[c] = acc[c] / a;
    }
    T* dst = out + i * C + c0;
#pragma unroll
    for (int c = 0; c < G; ++c)
      if (c0 + c < C)
        dst[c] = store<T>(fminf(fmaxf(acc[c], 0.0f), 1.0f), maxv);
  }
}

template <typename T, int G>
cudaError_t resample_g(const void* in, int W, int C, float maxv, int alpha,
                       Band v, int rows, Band h, int cols, float* t,
                       void* out, cudaStream_t s) {
  resample_v_kernel<T, G>
      <<<cdiv((long long)rows * W, THREADS), THREADS, 0, s>>>(
          static_cast<const T*>(in), W, C, maxv, alpha, v, rows, t);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  resample_h_kernel<T, G>
      <<<cdiv((long long)rows * cols, THREADS), THREADS, 0, s>>>(
          t, W, C, maxv, alpha, h, rows, cols, static_cast<T*>(out));
  return cudaGetLastError();
}

// the group width: C up to 4 channels, else 4
template <typename T>
cudaError_t resample(const void* in, int W, int C, float maxv, int alpha,
                     Band v, int rows, Band h, int cols, float* t, void* out,
                     cudaStream_t s) {
  switch (C) {
    case 1:
      return resample_g<T, 1>(in, W, C, maxv, alpha, v, rows, h, cols, t,
                              out, s);
    case 2:
      return resample_g<T, 2>(in, W, C, maxv, alpha, v, rows, h, cols, t,
                              out, s);
    case 3:
      return resample_g<T, 3>(in, W, C, maxv, alpha, v, rows, h, cols, t,
                              out, s);
    default:
      return resample_g<T, 4>(in, W, C, maxv, alpha, v, rows, h, cols, t,
                              out, s);
  }
}

}  // namespace

// in: (H, W, C) contiguous, any C >= 1, dtype 0 uint8, 1 uint16; out:
// (ceil(H / 8), ceil(W / 8), C) of the same type.
extern "C" int jxl_box_codes(const void* in, void* out, int dtype, int H,
                             int W, int C, void* stream) {
  if (H <= 0 || W <= 0 || C <= 0) return cudaSuccess;
  const int Ho = (H + BOX - 1) / BOX, Wo = (W + BOX - 1) / BOX;
  const unsigned grid = cdiv((long long)Ho * Wo * C, THREADS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    box_kernel<uint8_t><<<grid, THREADS, 0, s>>>(
        static_cast<const uint8_t*>(in), static_cast<uint8_t*>(out), H, W, C,
        Ho, Wo);
  else if (dtype == 1)
    box_kernel<uint16_t><<<grid, THREADS, 0, s>>>(
        static_cast<const uint16_t*>(in), static_cast<uint16_t*>(out), H, W,
        C, Ho, Wo);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

// in: (H, W, C) contiguous, dtype 0 uint8, 1 uint16, 2 float32, C >= 1;
// maxv 255, 65535 or 1; alpha (C 2 or 4 only): premultiply the last
// channel into the others before and divide after; the vertical band (rows entries) gives
// the kept output rows, the horizontal (cols entries) the kept columns;
// t: (rows, W, C) f32 scratch; out: (rows, cols, C) of the input's type.
extern "C" int jxl_resample(const void* in, int dtype, int W, int C,
                            float maxv, int alpha, const int* v_first,
                            const int* v_len, const float* v_w, int v_stride,
                            int rows, const int* h_first, const int* h_len,
                            const float* h_w, int h_stride, int cols,
                            float* t, void* out, void* stream) {
  if (rows <= 0 || cols <= 0 || W <= 0) return cudaSuccess;
  if (C < 1 || (alpha && C != 2 && C != 4)) return cudaErrorInvalidValue;
  const Band v{v_first, v_len, v_w, v_stride};
  const Band h{h_first, h_len, h_w, h_stride};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return resample<uint8_t>(in, W, C, maxv, alpha, v, rows, h, cols, t,
                               out, s);
    case 1:
      return resample<uint16_t>(in, W, C, maxv, alpha, v, rows, h, cols, t,
                                out, s);
    case 2:
      return resample<float>(in, W, C, maxv, alpha, v, rows, h, cols, t, out,
                             s);
    default:
      return cudaErrorInvalidValue;
  }
}
