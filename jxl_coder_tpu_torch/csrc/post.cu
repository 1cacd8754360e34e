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
//   A7 encode_output_kernel<OutT, KIND, TRC, GM>: _encode_output_device
//      (:676) with _xyb_to_linear_device (:649) and _quantize_device
//      (:669): XYB -> linear -> [3x3 gamut] -> sRGB (xyb_to_srgb_codes of
//      common.cuh, kernel 2's own output step), gamma, PQ, HLG with the
//      inverse OOTF, or a named transfer function -> floor(v * max + 0.5)
//      clipped; its YCbCr kind (a JPEG recompression frame; "ycbcr",
//      tpu_full.py:685-690): the planes are (Cb, Y, Cr), Y + 128/255, then
//      BT.601 in f32 in the reference's order, then the same codes.  Its
//      byte bound is 12 B in and 3 or 6 B out a pixel; the powf / logf /
//      IEEE divisions of PQ, HLG, gamma, BT.709 and DCI make those
//      bound by instruction throughput (PQ: six powf and three divisions
//      a pixel).  So each
//      spec is an instantiation of its own (post.cuh dispatch: straight-
//      line code, constants at fixed parameter offsets, the sRGB
//      multipliers in shared memory, no identity gamut product).  On a
//      frame that fills the card's threads at 4 pixels a thread, a thread
//      encodes kPix = 4 adjacent pixels, whose independent chains the compiler
//      interleaves: 16-byte loads from each plane where the planes' base
//      and strides allow, and its 12 (u8) or 24 (u16) bytes of codes
//      stored as 3 words where the width is a multiple of 4; on a smaller
//      one a pixel a thread, so that more threads hide the latency
//      (post.cuh encode_group, pixels_a_thread; a scalar path for the
//      rest).
//   S1 pool_output_kernel<OutT, KIND, TRC, GM>: the `down` stage of
//      fn_post (tpu_full.py:862-876) read by A7.  Each output pixel first
//      averages its down x down cell of the XYB planes (rows and columns
//      past the edge repeat the last one, as the reference's edge
//      padding), summed row by row, then encodes the means as A7 does.
//      The quarter-scale decode's planes are read once and 1/16 of the
//      codes written: bound by bytes (12 B read a source pixel).  The pool
//      needs no shared memory: a thread's 4 x 4 cell is 4 rows of 16
//      contiguous bytes a plane, and a warp's cells are neighbours.
// Full-precision powf / logf / expf / sqrtf (no --use_fast_math), and
// -fmad=false, so each operation rounds once, in the twins' order.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "common.cuh"
#include "post.cuh"

namespace {

using namespace jxl;
using namespace jxl_post;

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

// ---- A7 and S1 (their arithmetic and walks in post.cuh) ----

// the sRGB kind's 16 multipliers from the parameters into shared memory,
// at fixed offsets (a run-time index into the parameters would put them
// on the stack)
__device__ __forceinline__ void stage_mul(const OutParams& p,
                                          uint32_t* s_mul) {
  const int t = threadIdx.y * blockDim.x + threadIdx.x;
  if (t < 16) {
    uint32_t m = 0;
#pragma unroll
    for (int i = 0; i < 16; ++i)
      if (t == i) m = p.srgb.mul[i];
    s_mul[t] = m;
  }
  __syncthreads();
}

// A7: a thread PIX adjacent pixels of a row, a block kGX x kGY threads
template <int PIX, typename OutT, int KIND, int TRC, bool GM>
__global__ void __launch_bounds__(kGX * kGY)
    encode_output_kernel(const float* __restrict__ in, long long plane,
                         long long row, OutT* __restrict__ out, int H, int W,
                         int vin, int vout, OutParams p) {
  __shared__ uint32_t s_mul[16];
  if (KIND == K_SRGB) stage_mul(p, s_mul);
  const int g = blockIdx.x * kGX + threadIdx.x;
  const int y = blockIdx.y * kGY + threadIdx.y;
  if (y >= H || g * PIX >= W) return;
  encode_group<PIX, OutT, KIND, TRC, GM>(in, plane, row, out, W, y, g,
                                         vin != 0, vout != 0, p, s_mul);
}

// S1: a thread an output pixel
template <typename OutT, int KIND, int TRC, bool GM>
__global__ void __launch_bounds__(kGX * kGY)
    pool_output_kernel(const float* __restrict__ in, long long plane,
                       long long row, OutT* __restrict__ out, int H, int W,
                       int down, OutParams p) {
  __shared__ uint32_t s_mul[16];
  if (KIND == K_SRGB) stage_mul(p, s_mul);
  const int x = blockIdx.x * kGX + threadIdx.x;
  const int y = blockIdx.y * kGY + threadIdx.y;
  if (x >= (W + down - 1) / down || y >= (H + down - 1) / down) return;
  encode_pooled<OutT, KIND, TRC, GM>(in, plane, row, out, H, W, down, x, y,
                                     p, s_mul);
}

// launches the spec's kernel (dispatch picks the instantiation)
struct OutputLaunch {
  const float* in;
  long long plane, row;
  void* out;
  int H, W, down, pix;
  const OutParams& p;
  cudaStream_t s;

  template <int PIX, typename OutT, int KIND, int TRC, bool GM>
  void encode(OutT* o) {
    const dim3 grid(cdiv(cdiv(W, PIX), kGX), cdiv(H, kGY));
    encode_output_kernel<PIX, OutT, KIND, TRC, GM><<<grid, dim3(kGX, kGY), 0,
                                                     s>>>(
        in, plane, row, o, H, W, vector_loads(in, plane, row),
        vector_stores(out, W), p);
  }

  template <typename OutT, int KIND, int TRC, bool GM>
  int run() {
    OutT* o = static_cast<OutT*>(out);
    if (down == 1) {
      if (pix == kPix)
        encode<kPix, OutT, KIND, TRC, GM>(o);
      else
        encode<1, OutT, KIND, TRC, GM>(o);
    } else {
      const dim3 grid(cdiv(cdiv(W, down), kGX), cdiv(cdiv(H, down), kGY));
      pool_output_kernel<OutT, KIND, TRC, GM><<<grid, dim3(kGX, kGY), 0, s>>>(
          in, plane, row, o, H, W, down, p);
    }
    return 0;
  }
};

constexpr int kMaxDevices = 64;

// the current device's SM count, read once a device
cudaError_t sm_count(int& sms) {
  static std::atomic<int> cache[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  sms = cache[dev].load();
  if (sms == 0) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    cache[dev].store(sms);
  }
  return cudaSuccess;
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
  int sms = 0;
  const cudaError_t err = sm_count(sms);
  if (err != cudaSuccess) return err;
  OutParams p;
  const bool gm = out_params(bits, prm, srgb, mul, p);
  OutputLaunch launch{in, plane, row, out, H, W, down,
                      pixels_a_thread(H, W, sms), p,
                      static_cast<cudaStream_t>(stream)};
  if (dispatch(kind, trc, gm, bits, launch) != 0) return cudaErrorInvalidValue;
  return cudaGetLastError();
}
