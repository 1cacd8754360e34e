// The ICC -> sRGB step: a still's 8-bit or 16-bit samples from an RGB
// profile to sRGB, in one pass (ops/icc_apply.py binds both kernels; their
// plain twins transform_plain and clut_transform_plain are there).
//
// It replaces no Pallas kernel: the JAX package converts on the host with
// littlecms (jxl_coder_tpu/ops/icc_apply.py:22-61, perceptual intent with
// black-point compensation, 8-bit samples), on a decoded Modular still
// (api.py:563-568) and on a lossy encode's input (api.py:231-239).  The
// port reads the profile on the host (host/ops/icc.py plan) into the
// tables littlecms's 8-bit matrix-shaper path builds: three 256-entry
// input shapers and the matrix in 1.14 fixed point (int32), and the
// 16,385-entry output shaper (8-bit sRGB codes), 19,508 bytes in all.
//
// A thread a pixel, in a grid-stride loop over as many blocks as fill the
// card (each block stages the tables once): the input shapers and the
// output shaper in shared memory (19.4 KB), the matrix in registers;
// icc.cuh's icc_pixel, integers only, so the codes are littlecms's.  A
// 16-bit sample goes through its top byte and comes out as (c << 8) | c,
// a grey pixel's code feeds all three channels and three come out, a
// fourth channel (alpha) is copied.
//
// What bounds it on the H100: bytes.  Each sample is read once and each
// output written once (4K RGB8: 49.8 MB, 0.0149 ms at 3.35 TB/s); the
// work is 9 int32 multiply-adds and 6 shared-memory reads a pixel.
//
// clut_kernel is the same step for the profiles littlecms converts by its
// 8-bit CLUT program (a lookup-table profile, or a matrix / TRC profile
// whose black point moves): icc.cuh's clut_pixel, a thread a pixel in a
// grid-stride loop, each channel's 256 node offsets and fractions staged
// in shared memory (6 KB), the 33^3 x 3 16-bit CLUT (215,622 bytes) read
// from global memory through the read-only cache: 12 gathers a pixel, a
// tetrahedron's 4 corners x 3 channels.

#include <cuda_runtime.h>
#include <stdint.h>

#include "icc.cuh"

namespace {

using namespace jxl_icc;

constexpr int THREADS = 256;

template <typename T, int C>
__global__ void __launch_bounds__(THREADS)
    icc_kernel(const T* __restrict__ in, T* __restrict__ out,
               const uint8_t* __restrict__ tab, long long n) {
  __shared__ int32_t shaper1[kShaper1];
  __shared__ uint32_t shaper2[kShaper2Padded / 4];
  const int32_t* words = reinterpret_cast<const int32_t*>(tab);
  const uint32_t* s2 = reinterpret_cast<const uint32_t*>(tab + 4 * kWords);
  for (int i = threadIdx.x; i < kShaper1; i += THREADS) shaper1[i] = words[i];
  for (int i = threadIdx.x; i < kShaper2Padded / 4; i += THREADS)
    shaper2[i] = s2[i];
  int32_t m[kMatrix];
#pragma unroll
  for (int k = 0; k < kMatrix; ++k) m[k] = __ldg(words + kShaper1 + k);
  __syncthreads();
  const uint8_t* s2b = reinterpret_cast<const uint8_t*>(shaper2);
  for (long long p = (long long)blockIdx.x * THREADS + threadIdx.x; p < n;
       p += (long long)gridDim.x * THREADS)
    icc_pixel<T, C>(in + p * C, out + p * (C == 1 ? 3 : C), shaper1, m, s2b);
}

template <typename T, int C>
__global__ void __launch_bounds__(THREADS)
    clut_kernel(const T* __restrict__ in, T* __restrict__ out,
                const uint8_t* __restrict__ tab, long long n) {
  __shared__ int32_t offs[3 * 256];
  __shared__ int32_t fracs[3 * 256];
  const int32_t* words = reinterpret_cast<const int32_t*>(tab);
  const uint16_t* __restrict__ lut =
      reinterpret_cast<const uint16_t*>(tab + 4 * kClutWords);
  for (int i = threadIdx.x; i < 3 * 256; i += THREADS) {
    offs[i] = words[i];
    fracs[i] = words[3 * 256 + i];
  }
  __syncthreads();
  for (long long p = (long long)blockIdx.x * THREADS + threadIdx.x; p < n;
       p += (long long)gridDim.x * THREADS)
    clut_pixel<T, C>(in + p * C, out + p * (C == 1 ? 3 : C), offs, fracs,
                     lut);
}

// 8 blocks of 256 threads fill an SM; more would only stage the tables
// again
unsigned grid_for(long long n) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long need = (n + THREADS - 1) / THREADS;
  return (unsigned)(need < 8LL * sms ? need : 8LL * sms);
}

template <typename T, bool Clut>
cudaError_t run(const void* in, void* out, int C, long long n,
                const uint8_t* tab, cudaStream_t s) {
  const unsigned grid = grid_for(n);
  const T* i = static_cast<const T*>(in);
  T* o = static_cast<T*>(out);
  switch (C) {
    case 1:
      if (Clut)
        clut_kernel<T, 1><<<grid, THREADS, 0, s>>>(i, o, tab, n);
      else
        icc_kernel<T, 1><<<grid, THREADS, 0, s>>>(i, o, tab, n);
      break;
    case 3:
      if (Clut)
        clut_kernel<T, 3><<<grid, THREADS, 0, s>>>(i, o, tab, n);
      else
        icc_kernel<T, 3><<<grid, THREADS, 0, s>>>(i, o, tab, n);
      break;
    case 4:
      if (Clut)
        clut_kernel<T, 4><<<grid, THREADS, 0, s>>>(i, o, tab, n);
      else
        icc_kernel<T, 4><<<grid, THREADS, 0, s>>>(i, o, tab, n);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <bool Clut>
cudaError_t run_dtype(const void* in, void* out, int dtype, int C,
                      long long n, const uint8_t* tab, cudaStream_t s) {
  if (n <= 0) return cudaSuccess;
  if (dtype == 0) return run<uint8_t, Clut>(in, out, C, n, tab, s);
  if (dtype == 1) return run<uint16_t, Clut>(in, out, C, n, tab, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// in: n pixels of C samples (C 1, 3 or 4), contiguous, dtype 0 uint8, 1
// uint16; out: n pixels of 3 (C 1) or C samples of the same type; tab: the
// 19,508 bytes of host/ops/icc.py Transform.packed on the device, 4-byte
// aligned.
extern "C" int jxl_icc_to_srgb(const void* in, void* out, int dtype, int C,
                               long long n, const uint8_t* tab,
                               void* stream) {
  return run_dtype<false>(in, out, dtype, C, n, tab,
                          static_cast<cudaStream_t>(stream));
}

// As jxl_icc_to_srgb, through the CLUT program; tab: the 221,768 bytes of
// host/ops/icc_lut.py ClutTransform.packed on the device, 4-byte aligned.
extern "C" int jxl_icc_clut_to_srgb(const void* in, void* out, int dtype,
                                    int C, long long n, const uint8_t* tab,
                                    void* stream) {
  return run_dtype<true>(in, out, dtype, C, n, tab,
                         static_cast<cudaStream_t>(stream));
}

