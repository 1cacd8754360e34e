// The VarDCT encoder front: kernels E1-E4 and the winners' gather, each with
// a plain C entry point (vardct/enc_kernels.py binds them; their plain
// PyTorch twins are there too).
//
// They replace the jitted JAX front end of
// jxl_coder_tpu/vardct/enc_device.py, which holds no Pallas kernel:
//   E1 front_planes_kernel<ITERS> (_front's first half,
//      enc_device.py:111-119, with tpu_real.gaborish_device): sRGB samples
//      -> linear (glibc's powf, the twin's ops/fp.py powf, in float64
//      steps; a u8 code through a table of the 256 values the same
//      function gives) -> the 3x3 opsin mix (the twin's fp.contract3:
//      sequential, each step fused in float64) -> cbrt (powf(|x|, 1/3)) ->
//      X, Y, B - Y, then ITERS (0-4) Neumann steps err -= gab(err), out +=
//      err on each plane.  encode.cuh's strip walk: a 4-warp block walks
//      a strip of 64 columns (56 of output) and 64 output rows down the
//      frame in chunks of 8 rows; every thread computes the XYB of the
//      chunk's pixels once into shared memory (powf's tables copied there),
//      then warp c runs plane c's steps in registers, a lane two columns, a
//      three-row window per step with the horizontal neighbours by shuffle,
//      no barrier between steps; the frame's edge is each step's
//      one-sample replicate pad, by clamped neighbours.  So the planes
//      equal the twin's to the bit.  Bound by bytes (the samples read once,
//      12 B written a pixel), with the cbrt's float64 steps close behind.
//      The design it replaces (a 32 x 16 tile in a 40 x 24 window
//      a block, XYB on the whole window, each of the 12 plane-steps a pass
//      over shared memory with a barrier and an edge-copy pass) ran at 27x
//      that bound.
//   E2 front_blocks_kernel (_front's second half, :120-152): a thread block
//      a 64-px tile, a warp a row of its 8x8 blocks.  Per block: the DCT8
//      analysis (the basis in shared memory, two passes of 8-term sums),
//      jnp.gradient of Y (central inside, one-sided at the frame edges),
//      the activity sqrt(gy^2 + gx^2), its block mean and median (ranks by
//      counting: the 32nd and 33rd values, s31 * 0.5 + s32 * 0.5 as
//      jnp.median's linear interpolation), the masking field; the tile's
//      CfL sums over AC coefficients reduced in the block in a fixed order.
//      Bound by bytes (the planes read once, co written once).
//   E3 dct_costs_kernel<CY, CX> (_costs' quant_cost and candidate loop,
//      :174-279): per varblock its region's DCT (anaH @ reg @ anaW^T; DCT8
//      reads E2's co), the biased quantisation with the deadzone in scan
//      order, CfL-subtracted X / B, the squared errors, the LLF term from
//      the DC means, the rate proxy; int16 values and an f32 cost out.
//      Bound by operations (the two products, then the quantiser's three
//      IEEE divisions a value), over the card's f32 rate.  What held the
//      first design (a varblock a block, a thread an output as a 32-term
//      sum) back: pass 2 read anaW with a stride of W across the warp
//      (a 32-way bank conflict at W = 32), two shared loads and two
//      instructions a term, the channels one after another behind six
//      barriers, the LLF term on one thread while the block waited, and
//      64-thread blocks for DCT8.  The design now: every block has 192
//      threads, as many varblocks as fill them (1 at 32x32, 12 for DCT8),
//      all three channels at once; each thread owns a 4 x 4 output tile of
//      one channel (encode.cuh tile_product: 8 values from shared memory in
//      two 16-byte loads for 16 fused multiply-adds a step, k ascending from
//      0, so an output's value does not depend on its tile), the bases
//      transposed and the intermediate stored transposed (padded below 32
//      rows), so that no read conflicts; 16-byte loads of the region; a
//      thread a covered position for the LLF term; the quantiser a scan
//      position a thread (encode.cuh quant_position); partial sums reduced
//      by 8-lane shuffles then the varblock's segments in order (a run
//      repeats itself to the bit).  The fused products round otherwise than
//      the twin's torch.matmul, so values agree but at quantisation ties.
//   E4 special_costs_kernel (_costs' special branch, :280-321): one launch
//      a special transform, a persistent block an SM with the transform's
//      64x63 analysis and 63x64 response matrices in shared memory (97
//      KB of its 225 KB opt-in, loaded once a block) and two groups of 256
//      threads, each with its own barrier and batch buffers (encode.cuh's
//      batch walk): a group takes every 2G-th 8x8 block of the frame (G
//      blocks), queues the eligible ones and runs them 64 at a time: the
//      two products of a channel as (64 x 64) . (64 x 63) and (64 x 63) .
//      (63 x 64), each thread a 4 x 4 register tile (tile_product), Y
//      first, then X and B from Y's reconstruction kept in registers; the
//      quantiser's divisions by q from a table, without a branch; the
//      values out through shared memory in coalesced rows.  Ineligible
//      blocks get zero values and cost 1e30 without computing.  Bound by
//      operations.
//   gather_kernel (_sel_gather_jit, :424-436): the winners' rows of every
//      source back to back, int16; rows past a source clip to its last
//      (jnp.take's mode="clip").  Bound by bytes (each output byte read
//      once and written once).  One flat walk over the output of all
//      sources (encode.cuh gather_vector): the grid covers the output's
//      16-byte vectors exactly, a thread one of them, read as the aligned
//      16-byte chunks of its source rows (2-byte aligned) and stored
//      whole.
// -fmad=false: each f32 operation rounds once, in the twins' order (E3's
// products are explicit fused multiply-adds); the sums of E2-E4 run in
// another order than torch's, so those kernels agree with their twins
// within a tolerance (vals equal but at quantisation ties).  The
// per-value arithmetic (glibc's powf, the XYB of a pixel, the masking field
// of a block, the quantiser, the rate proxy) is encode.cuh's, which a CPU
// test holds to the twins bit for bit; E3's tile product, quantiser and LLF
// term are there too, and a CPU test holds them, in the kernel's tiles, to
// the twin under the tie rule.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "encode.cuh"

namespace {

using jxl_enc::Bias;
using jxl_enc::adjust;
using jxl_enc::quantize;
using jxl_enc::token_cost;

__host__ __device__ inline unsigned cdiv(long long a, int b) {
  return (unsigned)((a + b - 1) / b);
}

// ---------------------------------------------------------------------------
// E1

using jxl_enc::FrontShared;
using jxl_enc::FrontStrip;
using jxl_enc::kE1Chunk;
using jxl_enc::kE1Out;
using jxl_enc::kE1Rows;
using jxl_enc::kE1Side;
using jxl_enc::kE1Threads;

// encode.cuh PlaneWalk's lanes on the card: a lane's own float, shuffles
struct CardLanes {
  using F = float;
  using B = bool;
  static __host__ __device__ __forceinline__ int lane() {
#if defined(__CUDA_ARCH__)
    return (int)(threadIdx.x & 31);
#else
    return 0;
#endif
  }
  static __host__ __device__ __forceinline__ B at(int x0, int col) {
    return x0 + 2 * lane() == col;
  }
  static __host__ __device__ __forceinline__ F left(F v) {
#if defined(__CUDA_ARCH__)
    return __shfl_up_sync(0xffffffffu, v, 1);
#else
    return v;
#endif
  }
  static __host__ __device__ __forceinline__ F right(F v) {
#if defined(__CUDA_ARCH__)
    return __shfl_down_sync(0xffffffffu, v, 1);
#else
    return v;
#endif
  }
  static __host__ __device__ __forceinline__ F pick(B c, F a, F b) {
    return c ? a : b;
  }
  static __host__ __device__ __forceinline__ F div(F a, float b) {
#if defined(__CUDA_ARCH__)
    return __fdiv_rn(a, b);
#else
    return a / b;
#endif
  }
  // the lane's two output columns of a row (lanes past the halo, inside
  // the frame), one 8-byte store
  static __host__ __device__ __forceinline__ void store(float* row, int x0,
                                                        int pw, F a, F b) {
    const int l = lane(), col = x0 + 2 * l;
    if (l >= kE1Side / 2 && l < 32 - kE1Side / 2 && col < pw)
      *reinterpret_cast<float2*>(row + col) = make_float2(a, b);
  }
};

template <int ITERS>
__global__ void __launch_bounds__(kE1Threads)
    front_planes_kernel(const void* __restrict__ pix, int code,
                        float* __restrict__ out, int ph, int pw,
                        const float* __restrict__ consts) {
  __shared__ FrontShared s;
  const int k = threadIdx.x, warp = k >> 5, lane = k & 31;
  jxl_enc::front_tables(k, consts, s);
  __syncthreads();
  const FrontStrip st =
      jxl_enc::front_strip(blockIdx.x, blockIdx.y, ph, ITERS);
  jxl_enc::PlaneWalk<ITERS, CardLanes> walk;
  walk.init(st.x0, pw);
  const jxl_enc::FrontConsts kc = s.k;   // in registers across the barriers
  float* plane = out + (long long)min(warp, 2) * ph * pw;
  int buf = 0;
  for (int tc = st.a0; tc <= st.t_end; tc += kE1Chunk, buf ^= 1) {
    jxl_enc::front_xyb(k, pix, code, ph, pw, st, tc, buf, s);
    __syncthreads();
    if (warp < 3) {
#pragma unroll 1
      for (int r = 0; r < kE1Chunk && tc + r <= st.t_end; ++r) {
        const float2 x =
            *reinterpret_cast<const float2*>(&s.xyb[buf][warp][r][2 * lane]);
        walk.row(tc + r, x.x, x.y, st, ph, pw, kc, plane);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// E2

constexpr int E2_THREADS = 256;              // 8 warps: a warp a block row

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, o));
  return v;   // lane 0 holds the sum
}

__global__ void __launch_bounds__(E2_THREADS)
    front_blocks_kernel(const float* __restrict__ planes,
                        float* __restrict__ co, float* __restrict__ small,
                        int ph, int pw, const float* __restrict__ ana) {
  __shared__ float s_ana[64];
  __shared__ float s_b[8][3][64];
  __shared__ float s_t[8][3][64];
  __shared__ float s_act[8][64];
  __shared__ float s_med[8][2];
  __shared__ float s_cfl[8][3];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid < 64) s_ana[tid] = ana[tid];
  __syncthreads();
  const int ys_b = ph >> 3, xs_b = pw >> 3;
  const int nb = ys_b * xs_b;
  const int ntx = (xs_b + 7) >> 3, nty = (ys_b + 7) >> 3, nt = ntx * nty;
  const int by = blockIdx.y * 8 + warp;
  const long long plane = (long long)ph * pw;
  const float* Yp = planes + plane;
  float cy2 = 0.0f, cxy = 0.0f, cby = 0.0f;
  for (int j = 0; j < 8 && by < ys_b; ++j) {
    const int bx = blockIdx.x * 8 + j;
    if (bx >= xs_b) break;
    // this lane's two samples: p = lane, lane + 32 (row p / 8, column p % 8)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = lane + 32 * h;
      const int y = by * 8 + (p >> 3), x = bx * 8 + (p & 7);
#pragma unroll
      for (int c = 0; c < 3; ++c)
        s_b[warp][c][p] = planes[c * plane + (long long)y * pw + x];
      // jnp.gradient of Y at unit spacing
      float gy, gx;
      if (y == 0)
        gy = __fsub_rn(Yp[(long long)pw + x], Yp[x]);
      else if (y == ph - 1)
        gy = __fsub_rn(Yp[(long long)y * pw + x],
                       Yp[(long long)(y - 1) * pw + x]);
      else
        gy = __fmul_rn(__fsub_rn(Yp[(long long)(y + 1) * pw + x],
                                 Yp[(long long)(y - 1) * pw + x]),
                       0.5f);
      const float* row = Yp + (long long)y * pw;
      if (x == 0)
        gx = __fsub_rn(row[1], row[0]);
      else if (x == pw - 1)
        gx = __fsub_rn(row[x], row[x - 1]);
      else
        gx = __fmul_rn(__fsub_rn(row[x + 1], row[x - 1]), 0.5f);
      s_act[warp][p] =
          __fsqrt_rn(__fadd_rn(__fmul_rn(gy, gy), __fmul_rn(gx, gx)));
    }
    __syncwarp();
    // the median: the values of rank 31 and 32 (ties by index)
    float asum = 0.0f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = lane + 32 * h;
      const float v = s_act[warp][p];
      asum = __fadd_rn(asum, v);
      int rank = 0;
      for (int q = 0; q < 64; ++q) {
        const float u = s_act[warp][q];
        rank += (u < v) || (u == v && q < p);
      }
      if (rank == 31) s_med[warp][0] = v;
      if (rank == 32) s_med[warp][1] = v;
    }
    asum = warp_sum(asum);
    // the DCT8 analysis: t = ANA @ b (over rows), co = t @ ANA^T
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = lane + 32 * h, kk = p >> 3, xx = p & 7;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        float a = 0.0f;
#pragma unroll
        for (int yy = 0; yy < 8; ++yy)
          a = __fadd_rn(a, __fmul_rn(s_ana[kk * 8 + yy],
                                     s_b[warp][c][yy * 8 + xx]));
        s_t[warp][c][p] = a;
      }
    }
    __syncwarp();
    float cv[2][3];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = lane + 32 * h, kk = p >> 3, ll = p & 7;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        float a = 0.0f;
#pragma unroll
        for (int xx = 0; xx < 8; ++xx)
          a = __fadd_rn(a, __fmul_rn(s_t[warp][c][kk * 8 + xx],
                                     s_ana[ll * 8 + xx]));
        cv[h][c] = a;
        co[(((long long)c * ys_b + by) * xs_b + bx) * 64 + p] = a;
        if (p == 0) small[nb + 3 * nt + (long long)c * nb + by * xs_b + bx] = a;
      }
      if (p != 0) {
        cy2 = __fadd_rn(cy2, __fmul_rn(cv[h][1], cv[h][1]));
        cxy = __fadd_rn(cxy, __fmul_rn(cv[h][0], cv[h][1]));
        cby = __fadd_rn(cby, __fmul_rn(cv[h][2], cv[h][1]));
      }
    }
    __syncwarp();
    if (lane == 0) {
      const float mean = fmaxf(__fdiv_rn(asum, 64.0f), 0.0f);
      const float med = __fadd_rn(__fmul_rn(s_med[warp][0], 0.5f),
                                  __fmul_rn(s_med[warp][1], 0.5f));
      small[by * xs_b + bx] = jxl_enc::mask_of(mean, med);
    }
    __syncwarp();
  }
  cy2 = warp_sum(cy2);
  cxy = warp_sum(cxy);
  cby = warp_sum(cby);
  if (lane == 0) {
    s_cfl[warp][0] = cy2;
    s_cfl[warp][1] = cxy;
    s_cfl[warp][2] = cby;
  }
  __syncthreads();
  if (tid < 3) {
    float a = 0.0f;
    for (int w = 0; w < 8; ++w) a = __fadd_rn(a, s_cfl[w][tid]);
    small[nb + tid * nt + blockIdx.y * ntx + blockIdx.x] = a;
  }
}

// ---------------------------------------------------------------------------
// The quantiser's constants

using jxl_enc::QuantConsts;

// ---------------------------------------------------------------------------
// E3

struct CostTables {
  const float *anaH, *anaW;   // (h, h), (w, w)
  const int* order;           // the scan tail's natural indices (tail)
  const float* tab;           // (3, tail) dequant steps in that order
  const int* pos;             // the covered positions (cov)
  const float *anY, *anX, *rs;  // (cy, cy), (cx, cx), (cy, cx)
};

struct CostArgs {
  const float* src;   // planes (3, ph, pw), or co (3, ys_b, xs_b, 64)
  const int* qf;
  const float *fx, *fb, *dqdc;
  int16_t* vals;      // (n, 3, tail)
  float* cost;        // (n)
  int ys_b, xs_b, nxc, cov, tail;
  QuantConsts k;
};

constexpr int E3_THREADS = 192;   // 6 warps
constexpr int E3_SEG = 8;         // lanes of a first-level reduction

// E3's geometry for cy x cx blocks: each thread owns a 4 x 4 output tile
// of one channel of one varblock, so a varblock takes 3 * N / 16 threads
// and a thread block as many varblocks as fill its 192 threads (DCT8 has
// no product: 16 threads share a varblock's 189 values)
template <int CY, int CX>
struct E3Shape {
  static constexpr int H = 8 * CY, W = 8 * CX, N = H * W, COV = CY * CX;
  static constexpr bool FROM_CO = CY == 1 && CX == 1;
  static constexpr int TPV = FROM_CO ? 16 : 3 * N / 16;   // threads a varblock
  static constexpr int V = E3_THREADS / TPV;              // varblocks a block
  // the intermediate's row (a region column, its H values side by side),
  // padded below 32 so that pass 1's 16-byte stores spread over the banks
  static constexpr int SH = H == 32 ? H : H + 4;
  static_assert(V * TPV == E3_THREADS && TPV % E3_SEG == 0 && TPV >= 12,
                "a varblock's threads fill whole reduction segments");
};

__host__ __device__ constexpr bool e3_is_max(int i) {
  return i >= 3 && (i - 3) % 3 == 0;
}

template <int CY, int CX>
__global__ void __launch_bounds__(E3_THREADS)
    dct_costs_kernel(CostArgs a, CostTables t, int n) {
  using S = E3Shape<CY, CX>;
  constexpr int H = S::H, W = S::W, N = S::N, TPV = S::TPV, V = S::V;
  constexpr int NSEG = TPV / E3_SEG;
  constexpr bool FROM_CO = S::FROM_CO;
  __shared__ __align__(16) float s_co[V * 3 * N];   // region, then its DCT
  __shared__ __align__(16) float s_tt[FROM_CO ? 4 : V * 3 * W * S::SH];
  __shared__ __align__(16) float s_aHT[FROM_CO ? 4 : H * H];  // anaH^T
  __shared__ __align__(16) float s_aWT[FROM_CO ? 4 : W * W];  // anaW^T
  __shared__ float s_sc[V][3];                      // inv_qac, fx, fb
  __shared__ float s_llf[V][3][S::COV];             // squared LLF errors
  __shared__ float s_part[V * NSEG][12];
  __shared__ float s_tot[V][12];
  const int tid = threadIdx.x;
  const int vb = tid / TPV, lt = tid % TPV;
  const int blk = blockIdx.x * V + vb;
  const bool live = blk < n;
  const int by0 = live ? (blk / a.nxc) * CY : 0;
  const int bx0 = live ? (blk % a.nxc) * CX : 0;
  const int ph = a.ys_b * 8, pw = a.xs_b * 8;
  const long long nb = (long long)a.ys_b * a.xs_b;
  if (lt == 0 && live) {
    int qmin = a.qf[by0 * a.xs_b + bx0];
    for (int y = 0; y < CY; ++y)
      for (int x = 0; x < CX; ++x)
        qmin = min(qmin, a.qf[(by0 + y) * a.xs_b + bx0 + x]);
    const float qfv = __fdiv_rn((float)qmin, a.k.igs);
    s_sc[vb][0] = __fdiv_rn(1.0f, qfv);
    s_sc[vb][1] = a.fx[by0 * a.xs_b + bx0];
    s_sc[vb][2] = a.fb[by0 * a.xs_b + bx0];
  }
  if constexpr (FROM_CO) {
    // E2's 3 x 64 coefficients of each varblock, 16-byte loads
    for (int i = lt; i < 3 * 16 && live; i += TPV) {
      const int c = i >> 4, q = i & 15;
      *reinterpret_cast<float4*>(s_co + (vb * 3 + c) * 64 + 4 * q) =
          *reinterpret_cast<const float4*>(
              a.src + (((long long)c * a.ys_b + by0) * a.xs_b + bx0) * 64 +
              4 * q);
    }
  } else {
    for (int i = tid; i < H * H; i += E3_THREADS)
      s_aHT[(i % H) * H + i / H] = t.anaH[i];
    for (int i = tid; i < W * W; i += E3_THREADS)
      s_aWT[(i % W) * W + i / W] = t.anaW[i];
    // the varblocks' regions, all three channels, 16-byte loads
    constexpr int Q = W / 4;
    for (int i = tid; i < V * 3 * H * Q; i += E3_THREADS) {
      const int v = i / (3 * H * Q), r = i % (3 * H * Q);
      const int c = r / (H * Q), y = (r / Q) % H, q = r % Q;
      const int b = blockIdx.x * V + v;
      if (b >= n) continue;
      const int y0 = (b / a.nxc) * H, x0 = (b % a.nxc) * W;
      *reinterpret_cast<float4*>(s_co + ((v * 3 + c) * H + y) * W + 4 * q) =
          *reinterpret_cast<const float4*>(
              a.src + ((long long)c * ph + y0 + y) * pw + x0 + 4 * q);
    }
  }
  __syncthreads();
  const float* co = s_co + vb * 3 * N;
  if constexpr (!FROM_CO) {
    // a thread: channel c of its varblock, a 4 x 4 tile
    constexpr int G = N / 16;
    const int c = lt / G, g = lt % G;
    float* reg = s_co + (vb * 3 + c) * N;
    float* tt = s_tt + (vb * 3 + c) * W * S::SH;
    float acc[4][4];
    // pass 1: T = anaH @ reg, stored transposed (tt[x][k])
    {
      const int k0 = 4 * (g % (H / 4)), x0 = 4 * (g / (H / 4));
      jxl_enc::tile_product<H, 4, 4>(s_aHT + k0, H, reg + x0, W, acc);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<float4*>(tt + (x0 + j) * S::SH + k0) =
            make_float4(acc[0][j], acc[1][j], acc[2][j], acc[3][j]);
    }
    __syncthreads();
    // pass 2: co = T @ anaW^T, over the region it replaces
    {
      const int l0 = 4 * (g % (W / 4)), k0 = 4 * (g / (W / 4));
      jxl_enc::tile_product<W, 4, 4>(tt + k0, S::SH, s_aWT + l0, W, acc);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        *reinterpret_cast<float4*>(reg + (k0 + i) * W + l0) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
    __syncthreads();
  }
  // the LLF term: a thread a covered position of a channel
  if (lt < 3 * S::COV && live) {
    const int c = lt / S::COV, j = lt % S::COV;
    const float* dq = a.dqdc + c * nb;
    float e;
    if constexpr (FROM_CO) {
      const float d = __fsub_rn(dq[by0 * a.xs_b + bx0], co[c * N]);
      e = __fmul_rn(d, d);
    } else {
      e = jxl_enc::llf_error(t.anY, t.anX, t.rs, dq, a.xs_b, by0, bx0, CY,
                             CX, j, co[c * N + t.pos[j]]);
    }
    s_llf[vb][c][j] = e;
  }
  // the quantiser over the scan tail: error sums Y, X, B; then per channel
  // X, Y, B: last, bits, count
  const float inv_qac = s_sc[vb][0], fxa = s_sc[vb][1], fba = s_sc[vb][2];
  float v[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) v[i] = 0.0f;
  int16_t* vout = a.vals + (long long)blk * 3 * a.tail;
  for (int j = lt; j < a.tail && live; j += TPV) {
    const int p = __ldg(t.order + j);
    const float f[3] = {co[p], co[N + p], co[2 * N + p]};
    const float tab[3] = {__ldg(t.tab + j), __ldg(t.tab + a.tail + j),
                          __ldg(t.tab + 2 * a.tail + j)};
    float q[3], e[3];
    jxl_enc::quant_position(f, tab, inv_qac, fxa, fba, a.k.bias, a.k.dz, q,
                            e);
    v[0] = __fadd_rn(v[0], e[1]);
    v[1] = __fadd_rn(v[1], e[0]);
    v[2] = __fadd_rn(v[2], e[2]);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      vout[c * a.tail + j] = (int16_t)(int)q[c];
      if (q[c] != 0.0f) {
        v[3 + 3 * c] = (float)(j + 1);
        v[4 + 3 * c] =
            __fadd_rn(v[4 + 3 * c], log2f(__fadd_rn(1.0f, fabsf(q[c]))));
        v[5 + 3 * c] = __fadd_rn(v[5 + 3 * c], 1.0f);
      }
    }
  }
  // a fixed-order reduction: 8 lanes by xor shuffles, then the varblock's
  // segments in order, so that a run repeats itself to the bit
#pragma unroll
  for (int i = 0; i < 12; ++i)
#pragma unroll
    for (int o = E3_SEG / 2; o > 0; o >>= 1) {
      const float u = __shfl_xor_sync(0xffffffffu, v[i], o);
      v[i] = e3_is_max(i) ? fmaxf(v[i], u) : __fadd_rn(v[i], u);
    }
  if (tid % E3_SEG == 0)
#pragma unroll
    for (int i = 0; i < 12; ++i) s_part[tid / E3_SEG][i] = v[i];
  __syncthreads();
  if (lt < 12) {
    float s = s_part[vb * NSEG][lt];
    for (int k = 1; k < NSEG; ++k) {
      const float u = s_part[vb * NSEG + k][lt];
      s = e3_is_max(lt) ? fmaxf(s, u) : __fadd_rn(s, u);
    }
    s_tot[vb][lt] = s;
  }
  __syncthreads();
  if (lt == 0 && live) {
    const float* r = s_tot[vb];
    float dist = __fmul_rn(a.k.area_w[1], r[0]);
    dist = __fadd_rn(dist, __fmul_rn(a.k.area_w[0], r[1]));
    dist = __fadd_rn(dist, __fmul_rn(a.k.area_w[2], r[2]));
    for (int c = 0; c < 3; ++c) {
      float s = 0.0f;
      for (int j = 0; j < S::COV; ++j) s = __fadd_rn(s, s_llf[vb][c][j]);
      dist = __fadd_rn(dist, __fmul_rn(a.k.area_w[c], s));
    }
    float rate = 0.0f;
    for (int c = 0; c < 3; ++c)
      rate = __fadd_rn(rate, token_cost((int)r[3 + 3 * c], r[4 + 3 * c],
                                        (int)r[5 + 3 * c]));
    a.cost[blk] = __fadd_rn(rate, __fmul_rn(a.k.lam, dist));
  }
}

// ---------------------------------------------------------------------------
// E4

using jxl_enc::E4Thread;
using jxl_enc::SpecialArgs;
using jxl_enc::SpecialBatch;
using jxl_enc::SpecialMats;
using jxl_enc::kE4Batch;
using jxl_enc::kE4Groups;
using jxl_enc::kE4Ring;
using jxl_enc::kE4Seg;
using jxl_enc::kE4Threads;

constexpr size_t kE4Smem =
    sizeof(SpecialMats) + kE4Groups * sizeof(SpecialBatch);
static_assert(kE4Smem <= 232448, "a block's opt-in shared memory");
constexpr int kE4MaxDevices = 64;

// group h's barrier: named barrier 1 + h, its kE4Threads threads
__device__ __forceinline__ void group_sync(int h) {
  asm volatile("bar.sync %0, %1;" ::"r"(1 + h), "r"(kE4Threads));
}

// encode.cuh's batch walk: group h of this block is walker w; warp 0 of a
// group appends a round's eligible blocks to its ring by ballot, in
// block order; every full batch runs at once, the rest after the last
// round
__global__ void __launch_bounds__(kE4Threads * kE4Groups, 1)
    special_costs_kernel(SpecialArgs a) {
  extern __shared__ __align__(16) unsigned char e4_smem[];
  SpecialMats& m = *reinterpret_cast<SpecialMats*>(e4_smem);
  const int h = threadIdx.x / kE4Threads, t = threadIdx.x % kE4Threads;
  SpecialBatch& s = reinterpret_cast<SpecialBatch*>(
      e4_smem + sizeof(SpecialMats))[h];
  const int lane = t & 31;
  const int w = blockIdx.x * kE4Groups + h, nw = gridDim.x * kE4Groups;
  const long long nb = (long long)a.ys_b * a.xs_b;
  E4Thread st;
  jxl_enc::e4_load(threadIdx.x, kE4Threads * kE4Groups, a, m);
  if (t == 0) s.head = s.count = 0;
  __syncthreads();
  for (int r = 0;; ++r) {
    const bool done = jxl_enc::e4_block(w, nw, (long long)r * kE4Seg) >= nb;
    if (!done) {
      if (t < 32) {
        int tail = s.head + s.count;
        for (int i = 0; i < kE4Seg; i += 32) {
          const long long n =
              jxl_enc::e4_block(w, nw, (long long)r * kE4Seg + i + lane);
          const bool e = n < nb && a.elig[n];
          const unsigned mk = __ballot_sync(0xffffffffu, e);
          if (e)
            s.ring[(tail + __popc(mk & ((1u << lane) - 1u))) &
                   (kE4Ring - 1)] = (int)n;
          tail += __popc(mk);
        }
        if (lane == 0) s.count = tail - s.head;
      }
      jxl_enc::e4_clear(t, w, nw, r, a);
    }
    group_sync(h);
    for (;;) {
      const int count = s.count;
      if (count < kE4Batch && !(done && count > 0)) break;
      const int nbat = count < kE4Batch ? count : kE4Batch;
      jxl_enc::e4_slot(t, nbat, a, s);
      group_sync(h);
#pragma unroll
      for (int oi = 0; oi < 3; ++oi) {
        const int c = oi == 1 ? 0 : (oi == 0 ? 1 : 2);   // Y, X, B
        jxl_enc::e4_input(t, c, a, m, s, st);
        if (oi) jxl_enc::e4_reduce(t, oi == 1 ? 1 : 0, s);
        group_sync(h);
        jxl_enc::e4_quant(t, c, a, m, s);
        group_sync(h);
        jxl_enc::e4_recon(t, c, a, m, s, st);
        group_sync(h);
      }
      jxl_enc::e4_reduce(t, 2, s);
      group_sync(h);
      jxl_enc::e4_cost(t, nbat, a, s);
      if (t == 0) {
        s.head += nbat;
        s.count = count - nbat;
      }
      group_sync(h);
    }
    if (done) break;
    // every warp has read s.count before warp 0 appends the next round
    group_sync(h);
  }
}

// ---------------------------------------------------------------------------
// The winners' gather

// 8 blocks an SM (at most 32 registers): every warp slot of the SM holds a
// vector's loads in flight
__global__ void __launch_bounds__(jxl_enc::kGatherThreads, 8)
    gather_kernel(jxl_enc::GatherPlan p, int16_t* __restrict__ out) {
  // the plan in shared memory: its per-source arrays are read at run-time
  // indices, which in the parameters would put them on the stack
  __shared__ jxl_enc::GatherPlan s;
  if (threadIdx.x == 0) s = p;
  __syncthreads();
  jxl_enc::gather_vector(s, blockIdx.x * jxl_enc::kGatherThreads + threadIdx.x,
                         out);
}

// qk: 1 - QUANT_BIAS[c] (3), QUANT_BIAS_NUM, the distortion weights (3);
// f32, from the host
QuantConsts quant_consts(float igs, float lam, float dz, const float* qk) {
  QuantConsts k;
  for (int c = 0; c < 3; ++c) {
    k.bias[c].qb = qk[c];
    k.bias[c].qbn = qk[3];
    k.area_w[c] = qk[4 + c];
  }
  k.dz = dz;
  k.igs = igs;
  k.lam = lam;
  return k;
}

}  // namespace

extern "C" {

int jxl_enc_front_planes(const void* pix, int code, float* out, int ph,
                         int pw, int iters, const float* consts,
                         cudaStream_t stream) {
  const dim3 grid(cdiv(pw, kE1Out), cdiv(ph, kE1Rows));
  switch (iters) {
    case 0:
      front_planes_kernel<0><<<grid, kE1Threads, 0, stream>>>(
          pix, code, out, ph, pw, consts);
      break;
    case 1:
      front_planes_kernel<1><<<grid, kE1Threads, 0, stream>>>(
          pix, code, out, ph, pw, consts);
      break;
    case 2:
      front_planes_kernel<2><<<grid, kE1Threads, 0, stream>>>(
          pix, code, out, ph, pw, consts);
      break;
    case 3:
      front_planes_kernel<3><<<grid, kE1Threads, 0, stream>>>(
          pix, code, out, ph, pw, consts);
      break;
    case 4:
      front_planes_kernel<4><<<grid, kE1Threads, 0, stream>>>(
          pix, code, out, ph, pw, consts);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int jxl_enc_front_blocks(const float* planes, float* co, float* small,
                         int ph, int pw, const float* ana,
                         cudaStream_t stream) {
  const dim3 grid(cdiv(pw / 8, 8), cdiv(ph / 8, 8));
  front_blocks_kernel<<<grid, E2_THREADS, 0, stream>>>(planes, co, small, ph,
                                                       pw, ana);
  return (int)cudaGetLastError();
}

// tabs: the device pointers of anaH, anaW, order, tab, pos, anY, anX, rs
// (host array); qk: quant_consts' (weights area * D_c)
int jxl_enc_dct_costs(const float* src, const int* qf, const float* fx,
                      const float* fb, const float* dqdc,
                      const unsigned long long* tabs, int16_t* vals,
                      int ys_b, int xs_b, int cy, int cx, float igs,
                      float lam, float dz, float* cost, int cov, int tail,
                      const float* qk, cudaStream_t stream) {
  CostTables t;
  t.anaH = (const float*)tabs[0];
  t.anaW = (const float*)tabs[1];
  t.order = (const int*)tabs[2];
  t.tab = (const float*)tabs[3];
  t.pos = (const int*)tabs[4];
  t.anY = (const float*)tabs[5];
  t.anX = (const float*)tabs[6];
  t.rs = (const float*)tabs[7];
  CostArgs a;
  a.src = src;
  a.qf = qf;
  a.fx = fx;
  a.fb = fb;
  a.dqdc = dqdc;
  a.vals = vals;
  a.cost = cost;
  a.ys_b = ys_b;
  a.xs_b = xs_b;
  a.nxc = xs_b / cx;
  a.cov = cov;
  a.tail = tail;
  a.k = quant_consts(igs, lam, dz, qk);
  const unsigned n = (unsigned)((ys_b / cy) * (xs_b / cx));
  if (n == 0) return 0;
#define JXL_SHAPE(Y, X)                                                   \
  if (cy == Y && cx == X) {                                               \
    constexpr int V = E3Shape<Y, X>::V;                                   \
    dct_costs_kernel<Y, X><<<(n + V - 1) / V, E3_THREADS, 0, stream>>>(   \
        a, t, (int)n);                                                    \
    return (int)cudaGetLastError();                                       \
  }
  JXL_SHAPE(1, 1)
  JXL_SHAPE(1, 2)
  JXL_SHAPE(2, 1)
  JXL_SHAPE(2, 2)
  JXL_SHAPE(2, 4)
  JXL_SHAPE(4, 2)
  JXL_SHAPE(4, 4)
#undef JXL_SHAPE
  return (int)cudaErrorInvalidValue;
}

// mats: the device pointers of r0, R1, A (host array); qk: quant_consts'
// (weights D_c)
int jxl_enc_special_costs(const float* planes, const int* qf, const float* fx,
                          const float* fb, const float* dqdc,
                          const uint8_t* elig,
                          const unsigned long long* mats, int ys_b,
                          int xs_b, float igs, float lam, float dz,
                          int16_t* vals, float* cost, const float* qk,
                          cudaStream_t stream) {
  SpecialArgs a;
  a.planes = planes;
  a.qf = qf;
  a.fx = fx;
  a.fb = fb;
  a.dqdc = dqdc;
  a.elig = elig;
  a.r0 = (const float*)mats[0];
  a.R1 = (const float*)mats[1];
  a.A = (const float*)mats[2];
  a.vals = vals;
  a.cost = cost;
  a.ys_b = ys_b;
  a.xs_b = xs_b;
  a.k = quant_consts(igs, lam, dz, qk);
  const long long nb = (long long)ys_b * xs_b;
  if (nb == 0) return 0;
  const int smem = (int)kE4Smem, threads = kE4Threads * kE4Groups;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  // the shared-memory opt-in and the resident blocks, once a device
  static std::atomic<int> resident[kE4MaxDevices];
  if (dev >= kE4MaxDevices) return (int)cudaErrorInvalidDevice;
  if (resident[dev].load() == 0) {
    int sms = 0, per_sm = 0;
    err = cudaFuncSetAttribute(special_costs_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, special_costs_kernel, threads, smem);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    resident[dev].store(sms * per_sm);
  }
  // no more walkers than rounds of blocks
  const long long rounds = (nb + kE4Seg - 1) / kE4Seg;
  long long grid = resident[dev].load();
  if (grid * kE4Groups > rounds) grid = (rounds + kE4Groups - 1) / kE4Groups;
  special_costs_kernel<<<(unsigned)grid, threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// desc: per source (src, idx, rows, row length, rows in the source, output
// offset), int64 (host array); out: 16-byte aligned
int jxl_enc_gather_rows(const long long* desc, int n, int16_t* out,
                        cudaStream_t stream) {
  jxl_enc::GatherPlan p;
  if (jxl_enc::gather_plan(desc, n, p) != 0 || (uintptr_t)out % 16)
    return (int)cudaErrorInvalidValue;
  if (p.total == 0) return 0;
  gather_kernel<<<jxl_enc::gather_blocks(p), jxl_enc::kGatherThreads, 0,
                  stream>>>(p, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
