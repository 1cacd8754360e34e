// Kernel A10: one animation frame composed onto the canvas, in place
// (ops/compose.py binds it; its plain twin compose_plain is there).
//
// It replaces numpy code of the JAX package, not a Pallas kernel:
// _compose_frame (jxl_coder_tpu/api.py:821-961), which blends a decoded
// frame's crop window onto the canvas by the frame header's blending (the
// colour by blending_info, each extra channel by its ec_blending_info; the
// five blend modes, clamp, associated alpha).  The window is clipped on
// the host.  compose.cuh holds the program: a block stages a segment of
// window rows of the frame and of the canvas in shared memory by 16-byte
// loads, blends a pixel a thread (compose_pixel, float64, the codes equal
// the reference's), and stores the canvas segment back by 16-byte stores,
// the partial vectors at its ends a byte at a time.  Up to kMaxExtra (8)
// extra channels one launch blends every channel; beyond, one launch per
// group of 8 extra channels (the colour with the first), each reading the
// background alpha from a copy of the window the wrapper makes before the
// first.  compose_kernel<T, NC, NE> is instantiated on the sample type, the
// colour's channels (1, 3) and 2 or 8 extra channels, the least that holds
// the launch's (8 instantiations; 20, on each of 0, 1, 2, 4 and 8, ran no
// faster and took 30 s to build): no blending is indexed at run time, so
// nothing lives in local memory (ptxas: 0 bytes of stack).
//
// What bounds it on the H100: bytes.  Each window pixel's frame values and
// canvas values are read once and the canvas values written once (FHD
// RGBA + depth u8: 31.1 MB, 0.0093 ms at 3.35 TB/s); the float64 work is
// ~40 operations a pixel with up to four IEEE divisions (a u8 code's
// quotient by 255 comes from a table of the 256).  The design it
// replaces, a thread a pixel reading its bytes at a stride of nch with
// Params copied to a 272-byte stack, ran at 10.8x the byte bound.

#include <cuda_runtime.h>
#include <stdint.h>

#include "compose.cuh"

namespace {

using namespace jxl_blend;

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

template <typename T, int NC, int NE>
__global__ void __launch_bounds__(kThreads)
    compose_kernel(Walk<T, NC, NE> w) {
  extern __shared__ __align__(16) char s[];
  w.run(blockIdx.x, blockIdx.y, s, BlockEach{});
}

template <typename T, int NC, int NE>
cudaError_t launch(void* canvas, int canvas_w, const void* src, int src_w,
                   const void* bg, int sx, int sy, int dx, int dy, int cw,
                   int ch, const Params& p, cudaStream_t s) {
  Walk<T, NC, NE> w;
  w.canvas = static_cast<T*>(canvas);
  w.src = static_cast<const T*>(src);
  w.bg = static_cast<const T*>(bg);
  w.canvas_w = canvas_w;
  w.src_w = src_w;
  w.sx = sx;
  w.sy = sy;
  w.dx = dx;
  w.dy = dy;
  w.cw = cw;
  w.ch = ch;
  w.p = p;
  w.g = geo_of(cw, ch, p.nch * (int)sizeof(T), bg != nullptr,
               sizeof(T) == 1);
  const dim3 grid(w.g.nseg, (ch + w.g.rows - 1) / w.g.rows);
  compose_kernel<T, NC, NE>
      <<<grid, kThreads, shared_bytes(w.g), s>>>(w);
  return cudaGetLastError();
}

template <typename T, int NC>
cudaError_t by_extra(void* canvas, int canvas_w, const void* src, int src_w,
                     const void* bg, int sx, int sy, int dx, int dy, int cw,
                     int ch, const Params& p, cudaStream_t s) {
  if (ne_of(p.ng) == 2)
    return launch<T, NC, 2>(canvas, canvas_w, src, src_w, bg, sx, sy, dx, dy,
                            cw, ch, p, s);
  return launch<T, NC, kMaxExtra>(canvas, canvas_w, src, src_w, bg, sx, sy,
                                  dx, dy, cw, ch, p, s);
}

template <typename T>
cudaError_t by_colour(void* canvas, int canvas_w, const void* src, int src_w,
                      const void* bg, int sx, int sy, int dx, int dy, int cw,
                      int ch, const Params& p, cudaStream_t s) {
  if (p.ncolor == 1)
    return by_extra<T, 1>(canvas, canvas_w, src, src_w, bg, sx, sy, dx, dy,
                          cw, ch, p, s);
  return by_extra<T, 3>(canvas, canvas_w, src, src_w, bg, sx, sy, dx, dy, cw,
                        ch, p, s);
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return by_colour<uint8_t>(canvas, canvas_w, src, src_w, bg, sx, sy, dx,
                              dy, cw, ch, p, s);
  if (dtype == 1)
    return by_colour<uint16_t>(canvas, canvas_w, src, src_w, bg, sx, sy, dx,
                               dy, cw, ch, p, s);
  return cudaErrorInvalidValue;
}
