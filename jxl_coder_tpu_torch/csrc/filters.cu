// Restoration filters and output for the VarDCT decode: gaborish ->
// EPF pass 0 -> EPF pass 1 -> EPF pass 2 -> XYB -> sRGB8/16 (HWC).
//
// Replaces the TPU kernel jxl_coder_tpu/vardct/filters_pallas.py
// (fused_real_filters3 -> _kernel_chain3 + _chain_math + _srgb_out) and
// the jnp chain it falls back to (tpu_real.gaborish_device / epf_device,
// tpu_full._epf2_device, tpu_real.xyb_to_srgb8_device and
// tpu_full._xyb_to_srgb16_device).  Unlike the TPU kernel it has no
// width or height gate (each thread masks the ragged edge itself), takes
// per-channel gaborish weights, and runs EPF pass 0 (epf_iters 3), which
// the repo's own encoder emits at every distance >= 2.0.
//
// One launch per stage through device memory: each stage's border rule
// (Mirror for gaborish and EPF passes 0/1, edge replication for pass 2)
// stays local.  Constants (channel scales, the 2/3 border multiplier,
// the opsin inverse, the FastLinearToSRGB tables) are passed in from
// host/vardct/dec_real.py (the port's copy of the JAX package's
// dec_real) by the Python wrappers.
//
// What bounds it on the H100.  Each stage reads and writes three f32
// planes, 24 B/px: at 4K ~200 MB, ~60 us at 3.35 TB/s, and the whole
// epf_iters 1 chain (gaborish, EPF1, sRGB8: 24 + 24 + 15 B/px) ~150 us.
// Gaborish and the sRGB output take ~0.2 ms each at 4K, ~30% of that
// bound.  The EPF passes are further off: their neighbour reads (5-tap patches x 4 or 12
// offsets x 3 channels, ~135 loads per pixel for pass 1) come from L1,
// and with the Mirror index math they bound pass 1 at ~1 ms per 4K
// frame.  Staging a tile with its halo in shared memory, and fusing the
// stages into one tile pass as the TPU kernel does in VMEM (~15 B/px of
// HBM traffic), is later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using namespace jxl;

struct GabParams {
  float w1[3], w2[3], norm[3];
};

// tpu_real.gaborish_device, per channel weights.
__global__ void gaborish_kernel(Planes in, float* __restrict__ out, int H,
                                int W, GabParams g) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  const int c = blockIdx.z;
  if (x >= W || y >= H) return;
  const int ym = mirror(y - 1, H), yp = mirror(y + 1, H);
  const int xm = mirror(x - 1, W), xp = mirror(x + 1, W);
  const float s1 = at(in, c, ym, x) + at(in, c, yp, x) + at(in, c, y, xm) +
                   at(in, c, y, xp);
  const float s2 = at(in, c, ym, xm) + at(in, c, ym, xp) + at(in, c, yp, xm) +
                   at(in, c, yp, xp);
  const float v = at(in, c, y, x) + g.w1[c] * s1 + g.w2[c] * s2;
  out[((long long)c * H + y) * W + x] = v / g.norm[c];
}

struct EpfParams {
  float cs[3];        // EPF_CHANNEL_SCALE
  float border_mul;   // 2/3 on block-border pixels
};

__constant__ int kDiamond12[12][2] = {{0, 1}, {0, -1}, {1, 0}, {-1, 0},
                                      {1, 1}, {1, -1}, {-1, 1}, {-1, -1},
                                      {0, 2}, {0, -2}, {2, 0}, {-2, 0}};
__constant__ int kTaps[5][2] = {{0, 0}, {0, 1}, {0, -1}, {1, 0}, {-1, 0}};

// PASS 0: 12-tap diamond, 5-tap patch SAD, Mirror borders
//         (tpu_real.epf_device with EPF_OFFS_DIAMOND12).
// PASS 1: 4-neighbour cross, 5-tap patch SAD, Mirror borders
//         (tpu_real.epf1_device).
// PASS 2: 4-neighbour cross, pointwise SAD, edge-replicated borders, the
//         border multiplier applied to the SAD (tpu_full._epf2_device).
// inv: per-block slope (negative where the block is active, 0 where not).
template <int PASS>
__global__ void epf_kernel(Planes in, float* __restrict__ out, int H, int W,
                           const float* __restrict__ inv, int inv_stride,
                           EpfParams e) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= W || y >= H) return;
  const long long o = (long long)y * W + x;
  const long long plane = (long long)H * W;
  const float iv = inv[(y >> 3) * inv_stride + (x >> 3)];
  const float c0 = at(in, 0, y, x), c1 = at(in, 1, y, x), c2 = at(in, 2, y, x);
  if (!(iv < 0.0f)) {
    out[o] = c0;
    out[plane + o] = c1;
    out[2 * plane + o] = c2;
    return;
  }
  const int ry = y & 7, rx = x & 7;
  const bool border = ry == 0 || ry == 7 || rx == 0 || rx == 7;
  constexpr int NOFF = PASS == 0 ? 12 : 4;
  float wsum = 1.0f, a0 = c0, a1 = c1, a2 = c2;
  for (int k = 0; k < NOFF; ++k) {
    const int dy = kDiamond12[k][0], dx = kDiamond12[k][1];
    float sad = 0.0f;
    float n0, n1, n2;
    if (PASS == 2) {
      const int yy = clampi(y + dy, H), xx = clampi(x + dx, W);
      n0 = at(in, 0, yy, xx);
      n1 = at(in, 1, yy, xx);
      n2 = at(in, 2, yy, xx);
      sad = sad + e.cs[0] * fabsf(c0 - n0);
      sad = sad + e.cs[1] * fabsf(c1 - n1);
      sad = sad + e.cs[2] * fabsf(c2 - n2);
      const float w = fmaxf(0.0f, 1.0f + sad * (border ? e.border_mul : 1.0f) * iv);
      wsum = wsum + w;
      a0 = a0 + w * n0;
      a1 = a1 + w * n1;
      a2 = a2 + w * n2;
    } else {
      for (int c = 0; c < 3; ++c) {
        for (int t = 0; t < 5; ++t) {
          const int ty = kTaps[t][0], tx = kTaps[t][1];
          const float a = at(in, c, mirror(y + ty, H), mirror(x + tx, W));
          const float b =
              at(in, c, mirror(y + dy + ty, H), mirror(x + dx + tx, W));
          sad = sad + e.cs[c] * fabsf(a - b);
        }
      }
      const float ivb = border ? iv * e.border_mul : iv;
      const float w = fmaxf(0.0f, 1.0f + sad * ivb);
      const int yy = mirror(y + dy, H), xx = mirror(x + dx, W);
      wsum = wsum + w;
      a0 = a0 + w * at(in, 0, yy, xx);
      a1 = a1 + w * at(in, 1, yy, xx);
      a2 = a2 + w * at(in, 2, yy, xx);
    }
  }
  out[o] = a0 / wsum;
  out[plane + o] = a1 / wsum;
  out[2 * plane + o] = a2 / wsum;
}

// XYB planes -> interleaved (H, W, 3) sRGB at 8 or 16 bits.
template <typename T>
__global__ void srgb_kernel(Planes in, T* __restrict__ out, int H, int W,
                            SrgbParams s) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= W || y >= H) return;
  const float X = at(in, 0, y, x), Y = at(in, 1, y, x), B = at(in, 2, y, x);
  T* px = out + ((long long)y * W + x) * 3;
  for (int c = 0; c < 3; ++c) px[c] = (T)xyb_to_srgb_code(X, Y, B, c, s);
}

dim3 grid2d(int H, int W, int z, dim3 block) {
  return dim3((W + block.x - 1) / block.x, (H + block.y - 1) / block.y, z);
}

}  // namespace

// in: three planes at `in` with channel stride `plane_stride` and row
// stride `row_stride` (a cropped view is fine); out: contiguous (3, H, W).
extern "C" int jxl_gaborish(const float* in, long long plane_stride,
                            int row_stride, float* out, int H, int W,
                            float w1x, float w2x, float w1y, float w2y,
                            float w1b, float w2b, float nx, float ny,
                            float nb, void* stream) {
  if (H <= 0 || W <= 0) return cudaSuccess;
  const dim3 block(32, 8);
  GabParams g{{w1x, w1y, w1b}, {w2x, w2y, w2b}, {nx, ny, nb}};
  gaborish_kernel<<<grid2d(H, W, 3, block), block, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      Planes{in, plane_stride, row_stride}, out, H, W, g);
  return cudaGetLastError();
}

extern "C" int jxl_epf(int pass, const float* in, long long plane_stride,
                       int row_stride, float* out, int H, int W,
                       const float* inv, int inv_stride, float cs0, float cs1,
                       float cs2, float border_mul, void* stream) {
  if (H <= 0 || W <= 0) return cudaSuccess;
  const dim3 block(32, 8);
  const dim3 grid = grid2d(H, W, 1, block);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Planes p{in, plane_stride, row_stride};
  const EpfParams e{{cs0, cs1, cs2}, border_mul};
  switch (pass) {
    case 0: epf_kernel<0><<<grid, block, 0, s>>>(p, out, H, W, inv, inv_stride, e); break;
    case 1: epf_kernel<1><<<grid, block, 0, s>>>(p, out, H, W, inv, inv_stride, e); break;
    case 2: epf_kernel<2><<<grid, block, 0, s>>>(p, out, H, W, inv, inv_stride, e); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// out: (H, W, 3) uint8 (bits16 == 0) or uint16 (bits16 == 1).
// consts: 9 opsin-inverse floats, cbrt_bias, bias; mul: 16 uint32.
extern "C" int jxl_xyb_to_srgb(const float* in, long long plane_stride,
                               int row_stride, void* out, int H, int W,
                               int bits16, const float* consts,
                               const uint32_t* mul, void* stream) {
  if (H <= 0 || W <= 0) return cudaSuccess;
  SrgbParams s;
  for (int i = 0; i < 9; ++i) s.m[i] = consts[i];
  s.cbrt_bias = consts[9];
  s.bias = consts[10];
  s.scale = bits16 ? 65535.0f : 255.0f;
  for (int i = 0; i < 16; ++i) s.mul[i] = mul[i];
  const dim3 block(32, 8);
  const dim3 grid = grid2d(H, W, 1, block);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Planes p{in, plane_stride, row_stride};
  if (bits16)
    srgb_kernel<uint16_t><<<grid, block, 0, st>>>(p, static_cast<uint16_t*>(out), H, W, s);
  else
    srgb_kernel<uint8_t><<<grid, block, 0, st>>>(p, static_cast<uint8_t*>(out), H, W, s);
  return cudaGetLastError();
}
