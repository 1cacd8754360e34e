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
//   S3 resample_kernel<T, C, ALPHA>: resize_plane_stack
//      (jxl_coder_tpu/ops/resize.py:108) inside rescale_image (:131):
//      codes / maxv, alpha premultiplied, a vertical then a horizontal
//      pass of resample_matrix's weights, alpha unpremultiplied (clip(a,
//      1e-6, 1)), clip to [0, 1], rint(v * maxv).  The TPU form is two
//      dense matmuls (the MXU wants them); here each output reads only
//      its row's nonzero band (first index, length, weights, from the
//      host), so the work is ~(taps) multiply-adds an output and the
//      kernel is bound by bytes: the codes read once, the output written
//      once.  One launch, a block a tile of output pixels (sample.cuh's
//      program): the band tables in shared memory, the vertical sums of
//      the tile's rows into a float32 tile in shared memory (a pixel's
//      channels a thread, codes to units through a table for u8), the
//      horizontal sums from it, the output rows stored by 16-byte
//      stores.  The two-pass kernel it replaces wrote and read the
//      vertical sums of every input column through device memory
//      (float32, 3.2x the kernel's own bytes at 4K RGB8 -> FHD), divided
//      each tap's code, and launched twice.  C is a template parameter up
//      to 4 channels (alpha only at C 2 or 4, as the reference), a
//      runtime count beyond.  Sums use fmaf in the band's order, as the
//      two-pass kernel's: each output equals its, bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sample.cuh"

namespace {

using namespace jxl_sample;

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

// a phase of the block program: this thread's part, then the barrier
struct BlockEach {
  template <typename F>
  __host__ __device__ void operator()(F phase) const {
#if defined(__CUDA_ARCH__)
    phase((int)threadIdx.x);
    __syncthreads();
#endif
  }
};

template <typename T, int C, bool ALPHA>
__global__ void __launch_bounds__(kThreads)
    resample_kernel(Resample<T, C, ALPHA> R) {
  extern __shared__ __align__(16) char s[];
  R.run(blockIdx.x, s, BlockEach{});
}

template <typename T, int C, bool ALPHA>
cudaError_t resample_tiles(const void* in, int W, int c, float maxv, Band v,
                           int rows, Band h, int cols, void* out,
                           cudaStream_t s) {
  Resample<T, C, ALPHA> R;
  R.in = static_cast<const T*>(in);
  R.out = static_cast<T*>(out);
  R.W = W;
  R.c = c;
  R.maxv = maxv;
  R.v = v;
  R.h = h;
  R.rows = rows;
  R.cols = cols;
  R.t = plan_tiles(W, c, sizeof(T), rows, cols, v.stride, h.stride);
  if (R.t.ty == 0) return cudaErrorInvalidValue;
  R.l = layout_of(R.t, c, sizeof(T), v.stride, h.stride);
  // the most shared memory an SM can give: several blocks an SM
  cudaError_t err = cudaFuncSetAttribute(
      resample_kernel<T, C, ALPHA>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kBudget);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(resample_kernel<T, C, ALPHA>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)((rows + R.t.ty - 1) / R.t.ty) *
                           ((cols + R.t.tx - 1) / R.t.tx);
  resample_kernel<T, C, ALPHA>
      <<<(unsigned)blocks, kThreads, R.l.total, s>>>(R);
  return cudaGetLastError();
}

// the channel count as a template parameter up to 4 channels (alpha only
// at 2 or 4), a runtime one beyond
template <typename T>
cudaError_t resample(const void* in, int W, int C, float maxv, int alpha,
                     Band v, int rows, Band h, int cols, void* out,
                     cudaStream_t s) {
  switch (C) {
    case 1:
      return resample_tiles<T, 1, false>(in, W, C, maxv, v, rows, h, cols,
                                         out, s);
    case 2:
      return alpha ? resample_tiles<T, 2, true>(in, W, C, maxv, v, rows, h,
                                                cols, out, s)
                   : resample_tiles<T, 2, false>(in, W, C, maxv, v, rows, h,
                                                 cols, out, s);
    case 3:
      return resample_tiles<T, 3, false>(in, W, C, maxv, v, rows, h, cols,
                                         out, s);
    case 4:
      return alpha ? resample_tiles<T, 4, true>(in, W, C, maxv, v, rows, h,
                                                cols, out, s)
                   : resample_tiles<T, 4, false>(in, W, C, maxv, v, rows, h,
                                                 cols, out, s);
    default:
      return resample_tiles<T, 0, false>(in, W, C, maxv, v, rows, h, cols,
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
// channel into the others before and divide after; the vertical band (rows
// entries) gives the kept output rows, the horizontal (cols entries) the
// kept columns; t: unused (the two-pass kernel's scratch; pass null);
// out: (rows, cols, C) of the input's type.  One launch.
extern "C" int jxl_resample(const void* in, int dtype, int W, int C,
                            float maxv, int alpha, const int* v_first,
                            const int* v_len, const float* v_w, int v_stride,
                            int rows, const int* h_first, const int* h_len,
                            const float* h_w, int h_stride, int cols,
                            float* t, void* out, void* stream) {
  if (rows <= 0 || cols <= 0 || W <= 0) return cudaSuccess;
  if (C < 1 || (alpha && C != 2 && C != 4)) return cudaErrorInvalidValue;
  (void)t;
  const Band v{v_first, v_len, v_w, v_stride};
  const Band h{h_first, h_len, h_w, h_stride};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return resample<uint8_t>(in, W, C, maxv, alpha, v, rows, h, cols, out,
                               s);
    case 1:
      return resample<uint16_t>(in, W, C, maxv, alpha, v, rows, h, cols, out,
                                s);
    case 2:
      return resample<float>(in, W, C, maxv, alpha, v, rows, h, cols, out,
                             s);
    default:
      return cudaErrorInvalidValue;
  }
}
