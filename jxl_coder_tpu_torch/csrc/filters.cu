// Restoration filters and output, one tile pass: TPU kernels 2, 3 and 4.
//
//   Kernel 2, mode CHAIN, replaces jxl_coder_tpu/vardct/filters_pallas.py:751
//     (fused_real_filters3 -> _kernel_chain3 + _chain_math + _srgb_out) and
//     the jnp chain it falls back to (tpu_real.gaborish_device /
//     epf_device, tpu_full._epf2_device, tpu_real.xyb_to_srgb8_device and
//     tpu_full._xyb_to_srgb16_device): gaborish -> EPF pass 0 -> EPF pass 1
//     -> EPF pass 2 -> XYB -> sRGB8/16 (HWC) on the image planes, the
//     slopes made from the per-block sigma map.  Unlike the TPU kernel it
//     has no width or height gate, takes per-channel gaborish weights, and
//     runs EPF pass 0 (epf_iters 3), which the repo's own encoder emits at
//     every distance >= 2.0.
//     A launch writes a window of the image's rows from a slab of them
//     (jxl_restore_window): the whole image, or a shard of the
//     multi-device decode, equal to the same rows of the whole-image
//     launch.
//   Kernels 3 and 4, modes PADDED_MIRROR and PADDED_EDGE, replace
//     filters_pallas.py:588 fused_real_filters (_kernel_chain +
//     _chain_math: gaborish -> EPF1 (-> EPF2) (-> sRGB8/16)) and :794
//     fused_real_gab_epf1 (_kernel_real: gaborish -> EPF1 (-> sRGB8)): the
//     same tile pass on the JAX functions' row-padded planes, with the
//     caller's per-block EPF1 slope and one set of gaborish weights.
//
// chain_kernel<GAB, PA, EPF2, OutT, MODE>: each thread block owns a 64 x
// 16 output tile.  It loads the three input planes over the tile and its
// halo (1 pixel for gaborish, 2 for EPF1 or 3 for EPF0, 1 for EPF2) into
// shared memory once, all copies in flight before one wait: an interior
// tile with gaborish copies whole rows by 16-byte cp.async from the
// aligned column x0 - 4 (the planes' rows start 32-byte aligned, the
// halo's first column does not) and reads them at an offset; edge tiles
// copy 4 bytes at a time from the positions the mode's window sources
// give.  It then computes each stage over a window that shrinks by that
// stage's reach: the gaborish output, the channel-weighted difference
// planes of the EPF pass (2 for EPF1, 6 for EPF0's diamond; a patch SAD
// is then a 5-tap cross sum of one plane), the pass's output with the
// 1-pixel halo EPF2 reads, and the last stage's tile.  The sRGB codes are
// staged as HWC bytes and leave with 16-byte stores.  epf_iters <= 2 is
// one launch; epf_iters 3 is two, a gaborish + EPF0 pass to f32 planes
// and then the EPF1 + EPF2 + output pass (fusing EPF0 too would take a
// 7-pixel halo and six more planes).
//
// Borders (the window sources below).  Kernel 2 reads the input of
// gaborish, EPF0 and EPF1 extended by libjxl's Mirror(), EPF2's by edge
// replication.  Kernels 3 and 4 read the caller's pad rows above and
// below the image as data (rows past them clamp) and clamp columns; the
// gaborish output is extended by Mirror() (kernel 3) or edge replication
// (kernel 4), EPF2's input by edge replication.  A tile whose window
// crosses the image edge loads the input from those sources, computes
// each stage over its window as an interior tile does, then overwrites
// every window position outside the image with the stage's value at the
// folded position (fixup); interior tiles skip both.  Images narrower
// than the halo fold through mirror()'s loop.  The 2/3 block-border rule
// and the per-block slopes use global coordinates.
//
// Slopes.  Kernel 2 reads the per-block sigma map and computes each
// pass's slope itself, once per block of the tile: c / max(sigma, 1e-9)
// where sigma >= the gate, else 0, with c = KINV * EPF1_INV_SCALE *
// scale rounded to f32 on the host: the one division of
// vardct/filters.py epf_inv, so the slope is bit-equal to it.  Kernels 3
// and 4 take the EPF1 slope as the caller gives it (negative where
// active); EPF2's is (slope x 2/3 on block borders) x pass2_scale, in
// fused_filters._real_plain's order.
//
// What bounds it on the H100: bytes.  At 4K d1.0 e7 (epf_iters 1, u8)
// it reads the three f32 planes (99.5 MB) and writes 24.9 MB of codes,
// 125 MB, 0.037 ms at 3.35 TB/s; its ~170 f32 operations per pixel
// (gaborish 27, EPF1 71, sRGB 69) are 0.021 ms at 67 TFLOP/s.  Kernels 3
// and 4 move the same bytes plus 8 pad rows.  What the design does about
// it: every intermediate stays on chip, so the planes are read once and
// the codes written once (per-stage launches wrote and re-read three f32
// planes per stage); the halo (~1.5x the tile's input at epf_iters 1) is
// read again from L2.  What holds it above the bound is the work per
// pixel, not bytes or load instructions (the 16-byte window copies
// gained little over 4-byte ones): ~60 shared-memory accesses and ~340
// instructions per output pixel (counted from the code), in a 64 x 16
// tile whose strips are too short to keep more neighbours in registers.
//
// ptxas (-Xptxas=-v, sm_90a, CUDA 12.8): the main path's
// chain_kernel<true, 1, false, uint8_t, CHAIN> 48 registers and 38,784 B
// of dynamic shared memory (5 blocks per SM); with EPF2 (<true, 1, true,
// *>) 54-56 registers, 45-52 KB; the EPF0 pass <*, 0, false, float> 32
// registers, 55,824 B; without EPF (<*, -1, false, *>) 27-32 registers,
// 13-34 KB; kernels 3 and 4 take kernel 2's registers at the same
// geometry (48, and 54-56 with EPF2).  No instantiation spills.
//
// Every source builds with -fmad=false: gaborish, EPF2 and the output sum
// in the plain chain's order; EPF0/1 sum each patch SAD per tap over the
// channel-weighted difference planes, not per channel (within 1e-5).

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using namespace jxl;

constexpr int TW = 64, TH = 16, NT = 256;
// per-block slope tables: block rows (y0 >> 3) - 1 .. (y0 + TH) >> 3 and
// columns likewise, enough for a pass's output window of radius <= 1
constexpr int SBY = TH / 8 + 2, SBX = TW / 8 + 2, NSB = SBY * SBX;

struct ChainParams {
  float w1[3], w2[3], inv_norm[3];  // gaborish weights per channel
  float cs[3];                  // EPF_CHANNEL_SCALE
  float border_mul;             // 2/3 on block-border pixels
  float gate;                   // EPF_SIGMA_GATE (kernel 2)
  float slope[2];               // c of pass A (EPF0 or EPF1) and of EPF2 (kernel 2)
  float pass2_scale;            // EPF2's slope over EPF1's (kernels 3 and 4)
  SrgbParams srgb;
};

// The per-block map the passes' slopes come from: kernel 2's sigma, or
// kernels 3 and 4's EPF1 slope.  Blocks outside rows x cols read as 0.
struct Slopes {
  const float* p;
  int rows, cols;
  int stride;  // floats between the map's rows
  int row0;    // the image's block row of the map's first row
};

// The rows a launch writes and the rows it reads: kernel 2 on the whole
// image writes rows [0, H) and reads rows [0, H); windowed, it writes
// rows [r0, r0 + rows) of an image whose true height is H from a slab
// that holds the image's rows [lo, hi) (input row 0 at image row lo), at
// least 8 of them past each end of the window unless the slab ends at
// the image's edge.  Kernels 3 and 4 write [0, H) and read [-pad, H +
// pad), input row 0 at image row 0.
struct Window {
  int r0, rows;
  int lo, hi;
};

// Window sources: where each window position of the input comes from,
// and where a stage's output outside the image is folded to, per mode
// (host and device: tests/test_torch_fused_filters.py builds them with
// g++ and holds them to the plain twins' indices).
enum Mode { CHAIN = 0, PADDED_MIRROR = 1, PADDED_EDGE = 2 };

// a stage's output at window position i of a plane n long: Mirror() or
// edge replication
template <bool MIRROR>
__host__ __device__ __forceinline__ int fold(int i, int n) {
  return MIRROR ? mirror(i, n) : clampi(i, n);
}

// the input row window row gy loads: kernel 2 the Mirror()ed image row;
// kernels 3 and 4 the row itself where the caller's `pad` rows above and
// below the image hold it, else the last of them
template <int MODE>
__host__ __device__ __forceinline__ int source_row(int gy, int n, int pad) {
  if (MODE == CHAIN) return mirror(gy, n);
  return gy < -pad ? -pad : (gy > n + pad - 1 ? n + pad - 1 : gy);
}

// the input column window column gx loads: Mirror()ed or clamped
template <int MODE>
__host__ __device__ __forceinline__ int source_col(int gx, int n) {
  return fold<MODE == CHAIN>(gx, n);
}

// the gaborish output's border: edge replication for kernel 4, Mirror()
// for kernels 2 and 3
template <int MODE>
__host__ __device__ constexpr bool gab_mirror() { return MODE != PADDED_EDGE; }
// (end of the window sources)

template <bool GAB, int PA, bool EPF2, typename OutT>
struct Geo {
  static constexpr int RA = PA == 0 ? 3 : (PA == 1 ? 2 : 0);
  static constexpr int R2 = EPF2 ? 1 : 0;        // pass A output
  static constexpr int R1 = R2 + RA;             // pass A input
  static constexpr int R0 = R1 + (GAB ? 1 : 0);  // the loaded input
  static constexpr int ND = PA == 0 ? 6 : (PA == 1 ? 2 : 0);
  __host__ __device__ static constexpr int cols(int r) { return TW + 2 * r; }
  __host__ __device__ static constexpr int plane(int r) { return (TH + 2 * r) * (TW + 2 * r); }
  __host__ __device__ static constexpr int up4(int n) { return (n + 3) & ~3; }
  // the input window's rows in shared memory: with gaborish, LX floats
  // from the 16-byte aligned column x0 - up4(R0), window column c at
  // OX + c; without (X is then the pass's input) the window's own width
  static constexpr int LX = GAB ? TW + 2 * up4(R0) : cols(R0);
  static constexpr int OX = GAB ? up4(R0) - R0 : 0;
  static constexpr int PX = (TH + 2 * R0) * LX;
  // float offsets into dynamic shared memory: X the input, D the
  // difference planes and A2 pass A's output before EPF2 (over the dead
  // X once gaborish has read it), G the gaborish output (X itself
  // without gaborish), S the slope tables, the FastLinearToSRGB table,
  // then the staged output codes.  A is the buffer the last stage reads
  // before the output: A2, or without a pass the gaborish output.
  static constexpr int X = 0, X_END = up4(3 * PX);
  static constexpr int D = GAB ? X : X_END;
  static constexpr int A2 = D + up4(ND * plane(R1));
  static constexpr int A2_END = A2 + (PA >= 0 && EPF2 ? up4(3 * plane(R2)) : 0);
  static constexpr int G = GAB ? (X_END > A2_END ? X_END : A2_END) : X;
  static constexpr int A = PA < 0 ? G : A2;
  static constexpr int S = GAB ? G + up4(3 * plane(R1)) : A2_END;
  static constexpr int MUL = S + up4(2 * NSB);
  static constexpr int STAGE = MUL + 16;
  static constexpr int STAGE_BYTES =
      sizeof(OutT) == 4 ? 0 : TH * TW * 3 * (int)sizeof(OutT);
  __host__ __device__ static constexpr int bytes() { return STAGE * 4 + STAGE_BYTES; }
};

// asynchronous copies global -> shared (cp.async): 4 bytes through L1,
// 16 bytes (both addresses 16-byte aligned) through L2 only
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ bool block_border(int y, int x) {
  const int ry = y & 7, rx = x & 7;
  return ry == 0 || ry == 7 || rx == 0 || rx == 7;
}

// Window positions of a radius-R buffer outside the image take the
// stage's value at the folded position (Mirror or edge), which lies in
// the image and in the window; positions past the fold's reach are never
// read for an image pixel and are left alone.
template <int R, bool MIRROR>
__device__ void fixup(float* B, int y0, int x0, int H, int W) {
  constexpr int C = TW + 2 * R, P = (TH + 2 * R) * C;
  for (int i = threadIdx.x; i < P; i += NT) {
    const int r = i / C, c = i - r * C;
    const int gy = y0 - R + r, gx = x0 - R + c;
    if ((unsigned)gy < (unsigned)H && (unsigned)gx < (unsigned)W) continue;
    if (gy >= H + R || gx >= W + R) continue;
    const int sy = fold<MIRROR>(gy, H), sx = fold<MIRROR>(gx, W);
    const int j = (sy - (y0 - R)) * C + (sx - (x0 - R));
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) B[ch * P + i] = B[ch * P + j];
  }
}

// rows per thread for a strip pass over a window `cols` wide: enough
// strips for one sweep of the block's threads
__host__ __device__ constexpr int strip_rows(int rows, int cols) {
  return (rows + NT / cols - 1) / (NT / cols);
}

// in: the image's row w.lo (kernel 2) or row 0 (kernels 3 and 4, with
// `pad` readable rows above and below it); out: the window's (3, rows, W)
// float32 planes or (rows, W, 3) codes.
template <bool GAB, int PA, bool EPF2, typename OutT, int MODE>
__global__ void __launch_bounds__(NT)
    chain_kernel(Planes in, int pad, int H, int W, Window w, Slopes sl,
                 OutT* __restrict__ out, ChainParams p) {
  using Gm = Geo<GAB, PA, EPF2, OutT>;
  constexpr int R0 = Gm::R0, R1 = Gm::R1, R2 = Gm::R2, RA = Gm::RA;
  constexpr int C0 = Gm::cols(R0), NR0 = TH + 2 * R0;
  constexpr int LX = Gm::LX, OX = Gm::OX, PX = Gm::PX;
  constexpr int C1 = Gm::cols(R1), P1 = Gm::plane(R1), NR1 = TH + 2 * R1;
  constexpr int C2 = Gm::cols(R2), P2 = Gm::plane(R2), NR2 = TH + 2 * R2;
  constexpr int PF = TH * TW;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* const X = smem + Gm::X;
  float* const G = smem + Gm::G;
  float* const D = smem + Gm::D;
  float* const A = smem + Gm::A;
  float* const S = smem + Gm::S;
  uint32_t* const mul = reinterpret_cast<uint32_t*>(smem + Gm::MUL);
  OutT* const stage = reinterpret_cast<OutT*>(smem + Gm::STAGE);
  const int tid = threadIdx.x;
  const int x0 = blockIdx.x * TW, y0 = w.r0 + blockIdx.y * TH;
  // the input's row 0 is image row `row0`; a tile whose window crosses the
  // image's edge or the slab's loads from the window sources (clamped to
  // the slab: rows past it reach no output row of the window)
  const int row0 = MODE == CHAIN ? w.lo : 0;
  const bool edge = x0 < R0 || y0 < R0 || x0 + TW + R0 > W || y0 + TH + R0 > H ||
                    y0 - R0 < w.lo || y0 + TH + R0 > w.hi;

  // the FastLinearToSRGB table (a lookup per channel and pixel: shared
  // memory serves the warp's 16 classes at once, constant memory would not)
  if (tid < 16) mul[tid] = p.srgb.mul[tid];
  // slopes of the blocks the passes read (0 outside the map): kernel 2
  // pass A's and EPF2's from the sigma map, kernels 3 and 4 the caller's
  // EPF1 slope as it is (EPF2 scales it per pixel)
  if constexpr (PA >= 0) {
    constexpr int NTAB = MODE == CHAIN ? 2 : 1;
    for (int i = tid; i < NTAB * NSB; i += NT) {
      const int t = i / NSB, j = i - t * NSB;
      const int br = (y0 >> 3) - 1 + j / SBX - sl.row0, bc = (x0 >> 3) - 1 + j % SBX;
      float v = 0.0f;
      if ((unsigned)br < (unsigned)sl.rows && (unsigned)bc < (unsigned)sl.cols) {
        const float s = sl.p[br * sl.stride + bc];
        if constexpr (MODE == CHAIN)
          v = s >= p.gate ? p.slope[t] / fmaxf(s, 1e-9f) : 0.0f;
        else
          v = s;
      }
      S[i] = v;
    }
  }
  auto slope = [&](int t, int gy, int gx) {
    return S[t * NSB + ((gy >> 3) - (y0 >> 3) + 1) * SBX +
             ((gx >> 3) - (x0 >> 3) + 1)];
  };
  auto in_image = [&](int gy, int gx) {
    return (unsigned)gy < (unsigned)H && (unsigned)gx < (unsigned)W;
  };
  // the last stage's pixel (r, c) of the tile: f32 planes straight out,
  // or its codes into the HWC staging rows
  auto emit = [&](int r, int c, const float* o) {
    if constexpr (sizeof(OutT) == 4) {
      const int gy = y0 + r, gx = x0 + c;
      if (gy < w.r0 + w.rows && gx < W) {
#pragma unroll
        for (int ch = 0; ch < 3; ++ch)
          out[((long long)ch * w.rows + gy - w.r0) * W + gx] = o[ch];
      }
    } else {
      float q[3];
      xyb_to_srgb_codes(o[0], o[1], o[2], p.srgb, mul, q);
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) stage[(r * TW + c) * 3 + ch] = (OutT)q[ch];
    }
  };

  // the input over the window of radius R0, every copy in flight at once,
  // then one wait: with gaborish, an interior tile whose aligned rows lie
  // in the image copies them 16 bytes at a time; else 4 bytes at a time,
  // from the window sources on an edge tile
  bool vec = false;
  if constexpr (GAB) {
    constexpr int A0 = Gm::up4(R0);
    vec = !edge && x0 >= A0 && x0 + TW + A0 <= W &&
          (reinterpret_cast<uintptr_t>(in.p) & 15) == 0 &&
          (in.row_stride & 3) == 0 && (in.plane_stride & 3) == 0;
    if (vec) {
      constexpr int V = LX / 4, NV = NR0 * V;
      const float* base = in.p + (long long)(y0 - R0 - row0) * in.row_stride + (x0 - A0);
      for (int i = tid; i < 3 * NV; i += NT) {
        const int ch = i / NV, j = i - ch * NV, r = j / V, v = j - r * V;
        cp_async16(&X[ch * PX + r * LX + 4 * v],
                   base + ch * in.plane_stride + (long long)r * in.row_stride + 4 * v);
      }
    }
  }
  if (!vec) {
    for (int i = tid; i < NR0 * C0; i += NT) {
      const int r = i / C0, c = i - r * C0;
      int gy = y0 - R0 + r, gx = x0 - R0 + c;
      if (edge) {
        gy = min(max(source_row<MODE>(gy, H, pad), w.lo), w.hi - 1);
        gx = source_col<MODE>(gx, W);
      }
      const float* src = in.p + (long long)(gy - row0) * in.row_stride + gx;
      float* dst = X + r * LX + OX + c;
      cp_async4(dst, src);
      cp_async4(dst + PX, src + in.plane_stride);
      cp_async4(dst + 2 * PX, src + 2 * in.plane_stride);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // gaborish over the window of radius R1 (vardct/filters.py
  // gaborish_plain's sums), each thread down a strip of one column with
  // the three input rows it reads in registers
  if constexpr (GAB) {
    constexpr int SH = strip_rows(NR1, C1), NS = (NR1 + SH - 1) / SH;
    for (int it = tid; it < C1 * NS; it += NT) {
      const int c = it % C1, r0 = (it / C1) * SH;
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        const float* xc = X + ch * PX + r0 * LX + OX + c;  // above-left of G(r0, c)
        float a0 = xc[0], a1 = xc[1], a2 = xc[2];
        float b0 = xc[LX], b1 = xc[LX + 1], b2 = xc[LX + 2];
        float* g = G + ch * P1 + r0 * C1 + c;
#pragma unroll
        for (int k = 0; k < SH; ++k) {
          if (r0 + k >= NR1) break;
          const float* xd = xc + (k + 2) * LX;
          const float d0 = xd[0], d1 = xd[1], d2 = xd[2];
          const float s1 = a1 + d1 + b0 + b2;
          const float s2 = a0 + a2 + d0 + d2;
          const float v = b1 + p.w1[ch] * s1 + p.w2[ch] * s2;
          g[k * C1] = v * p.inv_norm[ch];
          a0 = b0; a1 = b1; a2 = b2;
          b0 = d0; b1 = d1; b2 = d2;
        }
      }
    }
    __syncthreads();
    if constexpr (PA >= 0) {
      if (edge) {
        fixup<R1, gab_mirror<MODE>()>(G, y0, x0, H, W);
        __syncthreads();
      }
    }
  }

  if constexpr (PA >= 0) {
    const float* I = G;  // the pass's input, radius R1
    // the channel-weighted difference planes
    if constexpr (PA == 1) {
      for (int i = tid; i < P1; i += NT) {
        const int r = i / C1, c = i - r * C1;
        const bool hok = c + 1 < C1, vok = r + 1 < NR1;
        float dh = 0.0f, dv = 0.0f;
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) {
          const float* q = I + ch * P1 + i;
          const float v0 = q[0];
          if (hok) dh = dh + p.cs[ch] * fabsf(v0 - q[1]);
          if (vok) dv = dv + p.cs[ch] * fabsf(v0 - q[C1]);
        }
        D[i] = dh;
        D[P1 + i] = dv;
      }
    } else {
      constexpr int kDiff[6][2] = {{0, 1}, {1, 0}, {1, 1}, {1, -1}, {0, 2}, {2, 0}};
      for (int i = tid; i < P1; i += NT) {
        const int r = i / C1, c = i - r * C1;
        float d[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) {
          const float* q = I + ch * P1 + i;
          const float v0 = q[0];
#pragma unroll
          for (int k = 0; k < 6; ++k) {
            const int dy = kDiff[k][0], dx = kDiff[k][1];
            if (r + dy < NR1 && c + dx >= 0 && c + dx < C1)
              d[k] = d[k] + p.cs[ch] * fabsf(v0 - q[dy * C1 + dx]);
          }
        }
#pragma unroll
        for (int k = 0; k < 6; ++k) D[k * P1 + i] = d[k];
      }
    }
    __syncthreads();

    if constexpr (PA == 1) {
      // EPF1 down column strips of the window of radius R2: each patch
      // SAD is a 5-tap cross sum of Dh or Dv, summed in the plain twin's
      // tap order (0,0), (0,1), (0,-1), (1,0), (-1,0); the rows above and
      // below stay in registers, and the (-1, 0) SAD is the (1, 0) SAD of
      // the row above
      constexpr int SH = strip_rows(NR2, C2), NS = (NR2 + SH - 1) / SH;
      for (int it = tid; it < C2 * NS; it += NT) {
        const int c2 = it % C2, r0 = (it / C2) * SH;
        const int gx = x0 - R2 + c2;
        const float* dh = D + c2 + RA;       // column x of Dh
        const float* dv = D + P1 + c2 + RA;  // column x of Dv
        const float* ic = I + c2 + RA;       // column x of the input
        int lr = r0 + RA;
        float hu_m = dh[(lr - 1) * C1 - 1], hu_0 = dh[(lr - 1) * C1];
        float hc_m2 = dh[lr * C1 - 2], hc_m = dh[lr * C1 - 1];
        float hc_0 = dh[lr * C1], hc_p = dh[lr * C1 + 1];
        float vu_0 = dv[(lr - 1) * C1];
        float vc_m = dv[lr * C1 - 1], vc_0 = dv[lr * C1], vc_p = dv[lr * C1 + 1];
        float cv_up = dv[(lr - 1) * C1] + dv[(lr - 1) * C1 + 1] +
                      dv[(lr - 1) * C1 - 1] + vc_0 + dv[(lr - 2) * C1];
        float gu[3], gc[3];
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) {
          gu[ch] = ic[ch * P1 + (lr - 1) * C1];
          gc[ch] = ic[ch * P1 + lr * C1];
        }
#pragma unroll
        for (int k = 0; k < SH; ++k) {
          const int r2 = r0 + k;
          if (r2 >= NR2) break;
          lr = r2 + RA;
          const float* hn = dh + (lr + 1) * C1;
          const float hd_m2 = hn[-2], hd_m = hn[-1], hd_0 = hn[0], hd_p = hn[1];
          const float* vn = dv + (lr + 1) * C1;
          const float vd_m = vn[-1], vd_0 = vn[0], vd_p = vn[1];
          float gd[3], gl[3], gr[3];
#pragma unroll
          for (int ch = 0; ch < 3; ++ch) {
            const float* q = ic + ch * P1 + lr * C1;
            gd[ch] = q[C1];
            gl[ch] = q[-1];
            gr[ch] = q[1];
          }
          const float cv = vc_0 + vc_p + vc_m + vd_0 + vu_0;
          const int gy = y0 - R2 + r2;
          float o[3] = {gc[0], gc[1], gc[2]};
          const float iv = in_image(gy, gx) ? slope(0, gy, gx) : 0.0f;
          if (iv < 0.0f) {
            const float ivb = block_border(gy, gx) ? iv * p.border_mul : iv;
            const float sad[4] = {hc_0 + hc_p + hc_m + hd_0 + hu_0,     // ( 0,  1)
                                  hc_m + hc_0 + hc_m2 + hd_m + hu_m,    // ( 0, -1)
                                  cv,                                    // ( 1,  0)
                                  cv_up};                                // (-1,  0)
            float wsum = 1.0f;
            auto term = [&](float sd, const float* nb) {
              const float w = fmaxf(1.0f + sd * ivb, 0.0f);
              wsum = wsum + w;
#pragma unroll
              for (int ch = 0; ch < 3; ++ch) o[ch] = o[ch] + w * nb[ch];
            };
            term(sad[0], gr);
            term(sad[1], gl);
            term(sad[2], gd);
            term(sad[3], gu);
            const float rw = 1.0f / wsum;
#pragma unroll
            for (int ch = 0; ch < 3; ++ch) o[ch] = o[ch] * rw;
          }
          if constexpr (EPF2) {
#pragma unroll
            for (int ch = 0; ch < 3; ++ch) A[ch * P2 + r2 * C2 + c2] = o[ch];
          } else {
            emit(r2, c2, o);
          }
          hu_m = hc_m; hu_0 = hc_0;
          hc_m2 = hd_m2; hc_m = hd_m; hc_0 = hd_0; hc_p = hd_p;
          vu_0 = vc_0;
          vc_m = vd_m; vc_0 = vd_0; vc_p = vd_p;
          cv_up = cv;
#pragma unroll
          for (int ch = 0; ch < 3; ++ch) {
            gu[ch] = gc[ch];
            gc[ch] = gd[ch];
          }
        }
      }
    } else {
      // EPF0, the 12-offset diamond (a pass of its own: no EPF2 follows)
      constexpr int kOff[12][2] = {{0, 1}, {0, -1}, {1, 0}, {-1, 0},
                                   {1, 1}, {1, -1}, {-1, 1}, {-1, -1},
                                   {0, 2}, {0, -2}, {2, 0}, {-2, 0}};
      // offset k is d or -d of plane kOffPlane[k]; the SAD of -d reads the
      // plane at q - d
      constexpr int kOffPlane[12] = {0, 0, 1, 1, 2, 3, 3, 2, 4, 4, 5, 5};
      constexpr bool kOffNeg[12] = {false, true, false, true, false, false,
                                    true, true, false, true, false, true};
      constexpr int kTap[5][2] = {{0, 0}, {0, 1}, {0, -1}, {1, 0}, {-1, 0}};
      for (int i = tid; i < PF; i += NT) {
        const int r = i / TW, c = i - r * TW;
        const int gy = y0 + r, gx = x0 + c;
        const int li = (r + RA) * C1 + c + RA;
        float o[3];
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) o[ch] = I[ch * P1 + li];
        const float iv = in_image(gy, gx) ? slope(0, gy, gx) : 0.0f;
        if (iv < 0.0f) {
          const float ivb = block_border(gy, gx) ? iv * p.border_mul : iv;
          float wsum = 1.0f;
#pragma unroll
          for (int k = 0; k < 12; ++k) {
            const int dy = kOff[k][0], dx = kOff[k][1];
            const float* dk = D + kOffPlane[k] * P1 + (kOffNeg[k] ? li + dy * C1 + dx : li);
            float sad = 0.0f;
#pragma unroll
            for (int t = 0; t < 5; ++t) sad = sad + dk[kTap[t][0] * C1 + kTap[t][1]];
            const float w = fmaxf(1.0f + sad * ivb, 0.0f);
            wsum = wsum + w;
#pragma unroll
            for (int ch = 0; ch < 3; ++ch)
              o[ch] = o[ch] + w * I[ch * P1 + li + dy * C1 + dx];
          }
          const float rw = 1.0f / wsum;
#pragma unroll
          for (int ch = 0; ch < 3; ++ch) o[ch] = o[ch] * rw;
        }
        emit(r, c, o);
      }
    }
  }

  if constexpr (EPF2) {
    __syncthreads();
    if (edge) {
      fixup<R2, false>(A, y0, x0, H, W);
      __syncthreads();
    }
    // EPF2 down column strips of the tile: pointwise SADs against the
    // edge-replicated EPF1 output; kernel 2 puts the 2/3 multiplier on the
    // SAD (tpu_full._epf2_device), kernels 3 and 4 on the slope
    // (fused_filters._real_plain)
    constexpr int SH = strip_rows(TH, TW), NS = (TH + SH - 1) / SH;
    for (int it = tid; it < TW * NS; it += NT) {
      const int c = it % TW, r0 = (it / TW) * SH;
      const int gx = x0 + c;
      const float* a = A + (r0 + 1) * C2 + c + 1;  // EPF1 at tile (r0, c)
      float au[3], ac[3];
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        au[ch] = a[ch * P2 - C2];
        ac[ch] = a[ch * P2];
      }
#pragma unroll
      for (int k = 0; k < SH; ++k) {
        const int r = r0 + k;
        if (r >= TH) break;
        float ad[3], al[3], ar[3];
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) {
          const float* q = a + ch * P2 + k * C2;
          ad[ch] = q[C2];
          al[ch] = q[-1];
          ar[ch] = q[1];
        }
        const int gy = y0 + r;
        float o[3] = {ac[0], ac[1], ac[2]};
        const float iv =
            (gy < H && gx < W) ? slope(MODE == CHAIN ? 1 : 0, gy, gx) : 0.0f;
        if (iv < 0.0f) {
          const bool bb = block_border(gy, gx);
          const float m = bb ? p.border_mul : 1.0f;
          const float iv2 = (bb ? iv * p.border_mul : iv) * p.pass2_scale;
          float wsum = 1.0f;
          auto term = [&](const float* nb) {
            float sad = 0.0f;
#pragma unroll
            for (int ch = 0; ch < 3; ++ch)
              sad = sad + p.cs[ch] * fabsf(ac[ch] - nb[ch]);
            const float w = MODE == CHAIN ? fmaxf(1.0f + sad * m * iv, 0.0f)
                                          : fmaxf(1.0f + sad * iv2, 0.0f);
            wsum = wsum + w;
#pragma unroll
            for (int ch = 0; ch < 3; ++ch) o[ch] = o[ch] + w * nb[ch];
          };
          term(ar);
          term(al);
          term(ad);
          term(au);
          const float rw = 1.0f / wsum;
#pragma unroll
          for (int ch = 0; ch < 3; ++ch) o[ch] = o[ch] * rw;
        }
        emit(r, c, o);
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) {
          au[ch] = ac[ch];
          ac[ch] = ad[ch];
        }
      }
    }
  }

  if constexpr (PA < 0) {
    // gaborish or nothing: the last stage's tile is A (= G, or X)
    for (int i = tid; i < PF; i += NT) {
      const int r = i / TW, c = i - r * TW;
      const float o[3] = {A[i], A[PF + i], A[2 * PF + i]};
      emit(r, c, o);
    }
  }

  // the staged codes out: 16-byte stores where the tile's rows are whole
  // and 16-byte aligned, else one code at a time
  if constexpr (sizeof(OutT) != 4) {
    __syncthreads();
    constexpr int ROW = TW * 3;  // codes per tile row
    const int ncols = min(TW, W - x0);
    const int end = w.r0 + w.rows;
    if (ncols == TW && ((long long)W * 3 * sizeof(OutT)) % 16 == 0) {
      constexpr int V = ROW * (int)sizeof(OutT) / 16;
      const uint4* s4 = reinterpret_cast<const uint4*>(stage);
      for (int i = tid; i < TH * V; i += NT) {
        const int r = i / V, v = i - r * V;
        const int gy = y0 + r;
        if (gy < end)
          reinterpret_cast<uint4*>(out + ((long long)(gy - w.r0) * W + x0) * 3)[v] = s4[i];
      }
    } else {
      for (int i = tid; i < TH * ROW; i += NT) {
        const int r = i / ROW, e = i - r * ROW;
        const int gy = y0 + r;
        if (gy < end && e < ncols * 3)
          out[((long long)(gy - w.r0) * W + x0) * 3 + e] = stage[i];
      }
    }
  }
}

template <bool GAB, int PA, bool EPF2, typename OutT, int MODE>
cudaError_t run(const Planes& in, int pad, int H, int W, const Window& w,
                const Slopes& sl, void* out, const ChainParams& p, cudaStream_t s) {
  auto* kern = chain_kernel<GAB, PA, EPF2, OutT, MODE>;
  constexpr int bytes = Geo<GAB, PA, EPF2, OutT>::bytes();
  const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((W + TW - 1) / TW, (w.rows + TH - 1) / TH);
  kern<<<grid, NT, bytes, s>>>(in, pad, H, W, w, sl, static_cast<OutT*>(out), p);
  return cudaGetLastError();
}

template <bool GAB, int PA, bool EPF2, int MODE>
cudaError_t run_out(int out_kind, const Planes& in, int pad, int H, int W,
                    const Window& w, const Slopes& sl, void* out,
                    const ChainParams& p, cudaStream_t s) {
  switch (out_kind) {
    case 0: return run<GAB, PA, EPF2, float, MODE>(in, pad, H, W, w, sl, out, p, s);
    case 1: return run<GAB, PA, EPF2, uint8_t, MODE>(in, pad, H, W, w, sl, out, p, s);
    case 2: return run<GAB, PA, EPF2, uint16_t, MODE>(in, pad, H, W, w, sl, out, p, s);
    default: return cudaErrorInvalidValue;
  }
}

template <bool GAB>
cudaError_t run_gab(int pass_a, int epf2, int out_kind, const Planes& in,
                    int H, int W, const Window& w, const Slopes& sl, void* out,
                    const ChainParams& p, cudaStream_t s) {
  if (pass_a < 0 && !epf2)
    return run_out<GAB, -1, false, CHAIN>(out_kind, in, 0, H, W, w, sl, out, p, s);
  if (pass_a == 1 && !epf2)
    return run_out<GAB, 1, false, CHAIN>(out_kind, in, 0, H, W, w, sl, out, p, s);
  if (pass_a == 1 && epf2)
    return run_out<GAB, 1, true, CHAIN>(out_kind, in, 0, H, W, w, sl, out, p, s);
  // EPF0 runs as its own pass to f32 planes
  if (pass_a == 0 && !epf2 && out_kind == 0)
    return run<GAB, 0, false, float, CHAIN>(in, 0, H, W, w, sl, out, p, s);
  return cudaErrorInvalidValue;
}

// consts: w1[3], w2[3], 1 / norm[3], cs[3], border_mul, then the mode's
// own (see the entry points)
ChainParams chain_params(const float* consts, const float* srgb,
                         const uint32_t* mul, int out_kind) {
  ChainParams p{};
  for (int c = 0; c < 3; ++c) {
    p.w1[c] = consts[c];
    p.w2[c] = consts[3 + c];
    p.inv_norm[c] = consts[6 + c];
    p.cs[c] = consts[9 + c];
  }
  p.border_mul = consts[12];
  for (int i = 0; i < 9; ++i) p.srgb.m[i] = srgb[i];
  p.srgb.cbrt_bias = srgb[9];
  p.srgb.bias = srgb[10];
  p.srgb.scale = out_kind == 2 ? 65535.0f : 255.0f;
  for (int i = 0; i < 16; ++i) p.srgb.mul[i] = mul[i];
  return p;
}

}  // namespace

// Kernel 2 in a row window (the whole image: lo = r0 = 0, hi = rows =
// H, sig_row0 = 0).  in: three planes with channel stride
// `plane_stride` and row stride `row_stride` (a cropped view is fine)
// holding rows [lo, hi) of an H x W image; out: its rows [r0, r0 + rows),
// equal to the same rows of the launch on the whole image when the slab
// holds 8 rows past each end of the window or reaches the image's edge
// (the chain reads at most 7 rows away: gaborish 1, EPF0 3, EPF1 2, EPF2
// 1).  Borders fold at the image's rows 0 and H - 1 only.  sigma: the
// per-block EPF sigma map of the image's block rows sig_row0 ..
// sig_row0 + sig_rows - 1, sig_cols wide, row-major (unused without EPF).
// gab: run gaborish first; pass_a: -1 none, 0 EPF0, 1 EPF1; epf2: run
// EPF2 after EPF1.  out_kind: 0 float32 (3, rows, W), 1 uint8 or 2 uint16
// (rows, W, 3) sRGB.  consts: w1[3], w2[3], 1 / norm[3], cs[3],
// border_mul, gate, slope c of pass A, slope c of EPF2; srgb: 9
// opsin-inverse floats, cbrt_bias, bias; mul: 16 uint32.
extern "C" int jxl_restore_window(const float* in, long long plane_stride,
                                  int row_stride, int H, int W, int lo, int hi,
                                  int r0, int rows, const float* sigma,
                                  int sig_row0, int sig_rows, int sig_cols,
                                  void* out, int gab, int pass_a, int epf2,
                                  int out_kind, const float* consts,
                                  const float* srgb, const uint32_t* mul,
                                  void* stream) {
  if (rows <= 0 || W <= 0) return cudaSuccess;
  if (r0 < 0 || r0 + rows > H || lo < 0 || hi > H || lo > r0 || hi < r0 + rows)
    return cudaErrorInvalidValue;
  ChainParams p = chain_params(consts, srgb, mul, out_kind);
  p.gate = consts[13];
  p.slope[0] = consts[14];
  p.slope[1] = consts[15];
  const Planes pl{in, plane_stride, row_stride};
  const Window w{r0, rows, lo, hi};
  const Slopes sl{sigma, sig_rows, sig_cols, sig_cols, sig_row0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return gab ? run_gab<true>(pass_a, epf2, out_kind, pl, H, W, w, sl, out, p, s)
             : run_gab<false>(pass_a, epf2, out_kind, pl, H, W, w, sl, out, p, s);
}

// Kernels 3 (mirror 1) and 4 (mirror 0): gaborish -> EPF1 (-> EPF2 with
// epf2, kernel 3 only) -> out.  in: the image's row 0 of three planes
// strided as above, with `pad` readable rows above and below it.  inv:
// the per-8x8-block EPF1 slope (negative where active), at least
// ceil(H / 8) x ceil(W / 8) blocks with row stride inv_stride.  out_kind:
// as above (kernel 4: 0 or 1).  consts: w1[3], w2[3], 1 / norm[3] (one
// weight pair in all three), cs[3], border_mul, pass2_scale; srgb, mul as
// above.
extern "C" int jxl_restore_padded(const float* in, long long plane_stride,
                                  int row_stride, int pad, int H, int W,
                                  const float* inv, int inv_stride, void* out,
                                  int mirror, int epf2, int out_kind,
                                  const float* consts, const float* srgb,
                                  const uint32_t* mul, void* stream) {
  if (H <= 0 || W <= 0) return cudaSuccess;
  if (pad < 0) return cudaErrorInvalidValue;
  ChainParams p = chain_params(consts, srgb, mul, out_kind);
  p.pass2_scale = consts[13];
  const Planes pl{in, plane_stride, row_stride};
  const Window w{0, H, -pad, H + pad};
  const Slopes sl{inv, (H + 7) / 8, (W + 7) / 8, inv_stride, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mirror && epf2)
    return run_out<true, 1, true, PADDED_MIRROR>(out_kind, pl, pad, H, W, w, sl, out, p, s);
  if (mirror)
    return run_out<true, 1, false, PADDED_MIRROR>(out_kind, pl, pad, H, W, w, sl, out, p, s);
  if (epf2 || out_kind > 1) return cudaErrorInvalidValue;
  return run_out<true, 1, false, PADDED_EDGE>(out_kind, pl, pad, H, W, w, sl, out, p, s);
}
