// Kernel A10: one animation frame composed onto the canvas, in place
// (ops/compose.py binds it; its plain twin compose_plain is there).
//
// It replaces numpy code of the JAX package, not a Pallas kernel:
// _compose_frame (jxl_coder_tpu/api.py:821-961), which blends a decoded
// frame's crop window onto the canvas by the frame header's blending (the
// colour by blending_info, each extra channel by its ec_blending_info; the
// five blend modes, clamp, associated alpha).  The window is clipped on
// the host.  A thread owns one canvas pixel of the window and runs
// compose.cuh's compose_pixel over its channels in float64: the codes
// equal the reference's.  Up to kMaxExtra (8) extra channels one launch
// blends every channel; beyond, one launch per group of 8 extra channels
// (the colour with the first), each reading the background alpha from a
// copy of the window the wrapper makes before the first.
//
// What bounds it on the H100: bytes.  Each window pixel's frame values and
// canvas values are read once and the canvas values written once (FHD
// RGBA8: 24.9 MB, 0.0074 ms at 3.35 TB/s); the float64 arithmetic is ~40
// operations a pixel, far under the card's fp64 rate.  Neighbouring
// threads take neighbouring pixels, so a warp's reads and writes are one
// contiguous run of the row.

#include <cuda_runtime.h>
#include <stdint.h>

#include "compose.cuh"

namespace {

using namespace jxl_blend;

constexpr int TX = 32, TY = 8;

template <typename T>
__global__ void __launch_bounds__(TX* TY)
    compose_kernel(T* __restrict__ canvas, int canvas_w,
                   const T* __restrict__ src, int src_w,
                   const T* __restrict__ bg, int sx, int sy, int dx, int dy,
                   int cw, int ch, Params p) {
  const int x = blockIdx.x * TX + threadIdx.x;
  const int y = blockIdx.y * TY + threadIdx.y;
  if (x >= cw || y >= ch) return;
  const T* s = src + ((long long)(sy + y) * src_w + sx + x) * p.nch;
  T* d = canvas + ((long long)(dy + y) * canvas_w + dx + x) * p.nch;
  const T* b = bg != nullptr ? bg + ((long long)y * cw + x) * p.nch : nullptr;
  compose_pixel<T>(s, d, b, p);
}

}  // namespace

// canvas: (H, canvas_w, nch) contiguous, dtype 0 uint8, 1 uint16, updated
// in place; src: (h, src_w, nch) of the same type.  The window: the frame's
// pixels from (sx, sy) go to the canvas from (dx, dy), cw x ch of them.
// ip: nch, ncolor, n_ec, the colour's mode, alpha channel and clamp, then
// per extra channel its mode, alpha channel, clamp and alpha_associated;
// maxv 255 or 65535.  This launch blends the extra channels from g0 (a
// multiple of 8) on, up to 8 of them, and the colour when g0 is 0; bg: the
// window's canvas values before the first launch, (ch, cw, nch), needed
// when n_ec > 8, else null.
extern "C" int jxl_compose(void* canvas, int dtype, int canvas_w,
                           const void* src, int src_w, const void* bg,
                           int sx, int sy, int dx, int dy, int cw, int ch,
                           const int* ip, double maxv, int g0,
                           void* stream) {
  if (cw <= 0 || ch <= 0) return cudaSuccess;
  Params p;
  if (!params_of(ip, maxv, g0, &p) || (p.n_ec > kMaxExtra && bg == nullptr))
    return cudaErrorInvalidValue;
  const dim3 grid((cw + TX - 1) / TX, (ch + TY - 1) / TY), block(TX, TY);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    compose_kernel<uint8_t><<<grid, block, 0, s>>>(
        static_cast<uint8_t*>(canvas), canvas_w,
        static_cast<const uint8_t*>(src), src_w,
        static_cast<const uint8_t*>(bg), sx, sy, dx, dy, cw, ch, p);
  else if (dtype == 1)
    compose_kernel<uint16_t><<<grid, block, 0, s>>>(
        static_cast<uint16_t*>(canvas), canvas_w,
        static_cast<const uint16_t*>(src), src_w,
        static_cast<const uint16_t*>(bg), sx, sy, dx, dy, cw, ch, p);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}
