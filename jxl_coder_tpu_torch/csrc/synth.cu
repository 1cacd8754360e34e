// VarDCT synthesis for one strategy family: coefficients -> XYB pixels
// written straight into the (3, H8, W8) frame planes.
//
// Replaces the TPU kernel jxl_coder_tpu/vardct/synth_pallas.py:129
// (synth_family_pallas -> _kernel) and the jnp path it shadows,
// jxl_coder_tpu/vardct/tpu_full.py (_synth_family, both branches), plus
// the perm_inv gather + 24-slice detile of tpu_full._build_fn: the
// epilogue stores each pixel at (bys*8 + y, bxs*8 + x), so no tile rows
// and no assembly pass exist.
//
// Per varblock:  the int8 exception list added in -> AdjustQuantBias ->
// x tab*qm -> x inv_qac -> CfL (X += xf*Y, B += bf*Y) -> LLF corner from
// the DC image -> separable inverse DCT (rows, then columns) in fp32 FMA.
// Every kernel here does all of it from the family's packed arrays and
// the DC image: no torch operation runs before a launch.  The TPU kernel multiplied by a
// dense K x K Kronecker basis in a 3-pass bf16 split; the separable form
// costs K*(bh+bw) FMAs instead of K*K and never builds the matrix.
//
// Special 1-block families (IDENTITY, DCT2X2, DCT4X4, DCT4X8, DCT8X4,
// AFV0-3) take the second mode: a per-channel (64 scan x 64 pixel)
// response matrix, with the custom-dequant ratio already folded in on
// the host, and CfL through the default Y response.
//
// What bounds it on the H100: the frame planes it writes.  At 4K the
// int8 coefficients are 3 B/px in and the f32 planes 12 B/px out, about
// 130 MB with the per-row scalars, or ~39 us at 3.35 TB/s; the DCT8
// inverse transform is 48 FMA/px (~12 us of fp32 at 67 TFLOP/s).
//
// synth_dct8_kernel takes the DCT8 family, ~97% of a photo's blocks.
// A warp takes 4 consecutive family rows at once, kDct8Groups times:
// lane (j, ky) owns row ky of varblock j in all three channels, so all
// 32 lanes work and CfL needs no shuffle.  It loads its three
// coefficient rows with one vector load each (8 B of int8), adds its
// rows' int8 exceptions itself (a binary search of the sorted list per
// warp, then a warp-uniform walk: the family is never widened to int32),
// applies AdjustQuantBias (its num / v looked up in a per-block table of
// the same single divisions for the int8 range), tab*qm and inv_qac in
// registers, takes the DC sample straight from the DC image, runs the
// 8-point row transform in fp32 FMAs with the basis as launch
// parameters, transposes through a 3 KB per-warp tile in shared memory,
// runs the column transform and stores each output row as two float4.
// The general kernel's form, one 192-thread block per varblock with
// three __syncthreads phases, was bound by block scheduling on DCT8.
// What still holds it above its bound (~2.4x at 4K) is instructions:
// the dequant, the exception walk and 16 FMAs per pixel per channel.
//
// synth_dct_kernel keeps the other DCT families: one varblock per thread
// block staged in shared memory (6*K floats: 96 KB for DCT64X64), the
// integer coefficients first, then the exceptions (a binary search and a
// walk, one entry per thread), then the dequantised values and the LLF
// (ana_basis @ DC window @ ana_basis^T, times the resampling scales).
// DCT128X128 and the DCT256 families (up to 1.5 MB of staging per
// varblock) stage in a global scratch buffer the wrapper allocates
// instead; they are rare and slow, and no TPU path ever ran them.
//
// ptxas (-Xptxas=-v, sm_90a, CUDA 12.8): synth_dct8_kernel 80 registers
// (int8, the photo case), 80 (int16, 4 bytes spilled) and 93 (int32),
// 13,312 B of static shared memory (the per-warp tiles and the quotient
// table), 6 blocks of 128 threads per SM by registers; synth_dct_kernel
// 32 registers (40 with the scratch buffer) and 6*K floats of dynamic
// shared memory; synth_special_kernel 39 registers, 1,536 B.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPadSentinel = 1 << 20;   // tpu_full._PAD_SENTINEL

struct BiasParams {
  float qb[3];   // 1 - QUANT_BIAS[c]
  float num;     // QUANT_BIAS_NUM
};

// AdjustQuantBias, exactly as tpu_full._bias_device: |v| > 1 -> v -
// num / v, else v * (1 - bias[c]).
__device__ __forceinline__ float adjust_bias(float v, float qb, float num) {
  const float safe = (v == 0.0f) ? 1.0f : v;
  return fabsf(v) > 1.0f ? v - num / safe : v * qb;
}

// the first entry of the sorted exception list at or after flat index lo
__device__ __forceinline__ int first_fix(const long long* __restrict__ fix_idx,
                                         int n_fix, long long lo) {
  int f = 0, hi = n_fix;
  while (f < hi) {
    const int mid = (f + hi) >> 1;
    if (fix_idx[mid] < lo) f = mid + 1; else hi = mid;
  }
  return f;
}

// Adds this varblock's exceptions (flat indices [lo, lo + n)) to its
// integer coefficients V in shared or scratch memory; the caller
// synchronises before and after.
__device__ __forceinline__ void add_fixes(int* V, long long lo, int n,
                                          const long long* __restrict__ fix_idx,
                                          const int* __restrict__ fix_val,
                                          int n_fix) {
  for (int j = first_fix(fix_idx, n_fix, lo) + threadIdx.x; j < n_fix;
       j += blockDim.x) {
    const long long idx = fix_idx[j];
    if (idx >= lo + n) break;
    atomicAdd(&V[idx - lo], fix_val[j]);
  }
}

// SCRATCH selects global staging at compile time, so the shared-memory
// form keeps shared-memory loads: a pointer that may be either compiles
// to generic loads.
template <typename T, bool SCRATCH>
__global__ void synth_dct_kernel(
    const T* __restrict__ coef, const float* __restrict__ tab,
    const float* __restrict__ dc, int ys, int xs,
    const float* __restrict__ anY, const float* __restrict__ anX,
    const float* __restrict__ rs, const long long* __restrict__ fix_idx,
    const int* __restrict__ fix_val, int n_fix,
    const float* __restrict__ inv_qac, const float* __restrict__ xf,
    const float* __restrict__ bf, const int* __restrict__ bys,
    const int* __restrict__ bxs, const float* __restrict__ Ah,
    const float* __restrict__ Aw, float* __restrict__ out, int bh, int bw,
    int H8, int W8, BiasParams bp, float qm0, float qm1, float qm2,
    float* __restrict__ scratch) {
  extern __shared__ float smem[];
  const int K = bh * bw;
  // bh and bw are powers of two: index math by shifts and masks
  const int lbw = __ffs(bw) - 1, lK = __ffs(K) - 1;
  const int b = blockIdx.x;
  float* work = SCRATCH ? scratch + (size_t)b * 6 * K : smem;
  float* C = work;          // (3, bh, bw) dequantized coefficients
  float* Tm = work + 3 * K; // (3, bh, bw) after the row transform
  int* V = reinterpret_cast<int*>(Tm);  // first: the integer coefficients
  const int by = bys[b];
  if (by == kPadSentinel) return;
  const int bx = bxs[b];
  const int cy = bh >> 3, cx = bw >> 3;
  const float iq = inv_qac[b], fx = xf[b], fb = bf[b];
  const T* cb = coef + (size_t)b * 3 * K;
  for (int i = threadIdx.x; i < 3 * K; i += blockDim.x) V[i] = (int)cb[i];
  __syncthreads();
  if (n_fix > 0) {
    add_fixes(V, (long long)b * 3 * K, 3 * K, fix_idx, fix_val, n_fix);
    __syncthreads();
  }
  for (int i = threadIdx.x; i < 3 * K; i += blockDim.x) {
    const int c = i >> lK, k = i & (K - 1);
    const int ky = k >> lbw, kx = k & (bw - 1);
    const float qm = c == 0 ? qm0 : (c == 1 ? qm1 : qm2);
    float d;
    if (ky < cy && kx < cx) {
      // the LLF corner: ana_basis(cy) @ DC window @ ana_basis(cx)^T,
      // times the resampling scales (synth.llf_from_dc)
      d = 0.0f;
      for (int y = 0; y < cy; ++y) {
        const float* dr = dc + ((size_t)c * ys + min(by + y, ys - 1)) * xs;
        float r = 0.0f;
        for (int x = 0; x < cx; ++x)
          r = fmaf(dr[min(bx + x, xs - 1)], anX[kx * cx + x], r);
        d = fmaf(anY[ky * cy + y], r, d);
      }
      d = d * rs[ky * cx + kx];
    } else {
      d = adjust_bias((float)V[i], bp.qb[c], bp.num) * (tab[i] * qm) * iq;
      if (c != 1) {
        const float dy =
            adjust_bias((float)V[K + k], bp.qb[1], bp.num) * (tab[K + k] * qm1) * iq;
        d = d + (c == 0 ? fx : fb) * dy;
      }
    }
    C[i] = d;
  }
  __syncthreads();
  // rows: T[c, ky, x] = sum_kx C[c, ky, kx] * Aw[kx, x]
  for (int i = threadIdx.x; i < 3 * K; i += blockDim.x) {
    const int row = i >> lbw, x = i & (bw - 1);
    const float* cr = C + row * bw;
    float acc = 0.0f;
    for (int l = 0; l < bw; ++l) acc = fmaf(cr[l], Aw[l * bw + x], acc);
    Tm[i] = acc;
  }
  __syncthreads();
  // columns: pix[c, y, x] = sum_ky Ah[ky, y] * T[c, ky, x]
  for (int i = threadIdx.x; i < 3 * K; i += blockDim.x) {
    const int c = i >> lK, p = i & (K - 1);
    const int y = p >> lbw, x = p & (bw - 1);
    const float* tc = Tm + c * K;
    float acc = 0.0f;
    for (int k = 0; k < bh; ++k) acc = fmaf(Ah[k * bh + y], tc[k * bw + x], acc);
    const int row = by * 8 + y, col = bx * 8 + x;
    if (row < H8 && col < W8) out[((size_t)c * H8 + row) * W8 + col] = acc;
  }
}

template <typename T>
__global__ void synth_special_kernel(
    const T* __restrict__ coef, const float* __restrict__ resp,
    const float* __restrict__ resp_y, const float* __restrict__ dc, int ys,
    int xs, const long long* __restrict__ fix_idx,
    const int* __restrict__ fix_val, int n_fix,
    const float* __restrict__ inv_qac, const float* __restrict__ xf,
    const float* __restrict__ bf, const int* __restrict__ bys,
    const int* __restrict__ bxs, float* __restrict__ out, int H8, int W8,
    BiasParams bp, float qm0, float qm1, float qm2) {
  __shared__ int Vi[3 * 64];
  __shared__ float V[3 * 64];
  const int b = blockIdx.x;
  const int by = bys[b];
  if (by == kPadSentinel) return;
  const int bx = bxs[b];
  const int i = threadIdx.x;           // 192 threads: (c, pixel)
  const int c = i >> 6, p = i & 63;
  Vi[i] = (int)coef[(size_t)b * 192 + i];
  if (n_fix > 0) {
    __syncthreads();
    add_fixes(Vi, (long long)b * 192, 192, fix_idx, fix_val, n_fix);
  }
  __syncthreads();
  V[i] = adjust_bias((float)Vi[i], bp.qb[c], bp.num);
  __syncthreads();
  const float iq = inv_qac[b];
  const float* rc = resp + (size_t)c * 64 * 64;
  float acc = 0.0f;
  for (int s = 1; s < 64; ++s) acc = fmaf(V[c * 64 + s], rc[s * 64 + p], acc);
  const float qm = c == 0 ? qm0 : (c == 1 ? qm1 : qm2);
  float pix = acc * (iq * qm);
  // the LLF of a 1-block transform is the DC sample
  pix = pix + dc[((size_t)c * ys + by) * xs + bx] * rc[p];
  if (c != 1) {
    float ay = 0.0f;
    for (int s = 1; s < 64; ++s) ay = fmaf(V[64 + s], resp_y[s * 64 + p], ay);
    const float acY = ay * iq;
    pix = pix + (c == 0 ? xf[b] : bf[b]) * acY;
  }
  const int row = by * 8 + (p >> 3), col = bx * 8 + (p & 7);
  if (row < H8 && col < W8) out[((size_t)c * H8 + row) * W8 + col] = pix;
}

constexpr int kDct8Warps = 4;   // warps per thread block
constexpr int kDct8Groups = 2;  // groups of 4 consecutive rows per warp

// one coefficient row (8 values) of T, one or two vector loads
__device__ __forceinline__ void load_row(const int8_t* p, int v[8]) {
  const int2 w = __ldg(reinterpret_cast<const int2*>(p));
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[k] = (int)(int8_t)(w.x >> (8 * k));
    v[4 + k] = (int)(int8_t)(w.y >> (8 * k));
  }
}

__device__ __forceinline__ void load_row(const int16_t* p, int v[8]) {
  const int4 w = __ldg(reinterpret_cast<const int4*>(p));
  const int s[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[2 * k] = (int)(int16_t)s[k];
    v[2 * k + 1] = s[k] >> 16;
  }
}

__device__ __forceinline__ void load_row(const int32_t* p, int v[8]) {
  const int4 a = __ldg(reinterpret_cast<const int4*>(p));
  const int4 b = __ldg(reinterpret_cast<const int4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// The DCT8 family (see the note above).  coef: (n, 3, 64) basis-ordered;
// fix_idx / fix_val: the n_fix entries of the int8 exception list,
// flat indices into coef sorted ascending.
struct Dct8Basis {
  float A[64];  // synthesis.cos_basis(8), A[k * 8 + x]: kernel parameters,
                // so the row pass reads them as constant operands
};

template <typename T>
__global__ void __launch_bounds__(32 * kDct8Warps) synth_dct8_kernel(
    const T* __restrict__ coef, const float* __restrict__ tab,
    const float* __restrict__ dc, int ys, int xs,
    const int* __restrict__ bys, const int* __restrict__ bxs,
    const float* __restrict__ inv_qac, const float* __restrict__ xf,
    const float* __restrict__ bf, const long long* __restrict__ fix_idx,
    const int* __restrict__ fix_val, int n_fix, float* __restrict__ out,
    int n, int H8, int W8, BiasParams bp, float qm0, float qm1, float qm2,
    Dct8Basis basis) {
  // per warp: the row transforms of its 4 varblocks (3 x 8 x 8 each)
  __shared__ __align__(16) float Tw[kDct8Warps][4 * 192];
  // num / v for the int8 range, each the same single division as
  // adjust_bias's (v = 0 is never looked up: |v| > 1 only)
  __shared__ float quot[256];
  for (int i = threadIdx.x; i < 256; i += blockDim.x)
    quot[i] = bp.num / (float)(i - 128);
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int j = lane >> 3, ky = lane & 7;  // varblock j of the group, row ky
  const float qb[3] = {bp.qb[0], bp.qb[1], bp.qb[2]};
  const float qm[3] = {qm0, qm1, qm2};
  float tq[3][8], ay[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
#pragma unroll
    for (int c = 0; c < 3; ++c) tq[c][k] = tab[c * 64 + ky * 8 + k] * qm[c];  // synth._tabqm
    ay[k] = basis.A[k * 8 + ky];  // column pass: A[k, y]
  }
  // AdjustQuantBias(v) * tab*qm, its num / v looked up
  auto deq = [&](int vi, int c, int k) {
    const float vf = (float)vi;
    float q;
    if ((unsigned)(vi + 128) < 256u) q = quot[vi + 128];
    else q = bp.num / vf;
    return (fabsf(vf) > 1.0f ? vf - q : vf * qb[c]) * tq[c][k];
  };
  float* tile = Tw[warp] + j * 192;
  const int g0 = (blockIdx.x * kDct8Warps + warp) * kDct8Groups * 4;
  if (g0 >= n) return;
  int f = n_fix > 0 ? first_fix(fix_idx, n_fix, (long long)g0 * 192) : 0;
  for (int g = 0; g < kDct8Groups; ++g) {
    const int base = g0 + 4 * g;  // the group's first family row
    if (base >= n) break;
    const int b = min(base + j, n - 1);  // a lane past n stores nothing
    int v[3][8];
#pragma unroll
    for (int c = 0; c < 3; ++c) load_row(coef + (long long)b * 192 + c * 64 + ky * 8, v[c]);
    // the group's exceptions (a warp-uniform walk)
    const long long lo = (long long)base * 192;
    for (; f < n_fix; ++f) {
      const long long idx = fix_idx[f];
      if (idx >= lo + 4 * 192) break;
      const int off = (int)(idx - lo) - j * 192 - ky * 8;
      const int val = fix_val[f];
#pragma unroll
      for (int c = 0; c < 3; ++c)
#pragma unroll
        for (int k = 0; k < 8; ++k)
          if (off == c * 64 + k) v[c][k] += val;
    }
    const int by = bys[b], bx = bxs[b];
    const bool live = base + j < n && by != kPadSentinel;
    const float iq = inv_qac[b], fx = xf[b], fb = bf[b];
    float dY[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) dY[k] = deq(v[1][k], 1, k) * iq;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float d[8];
#pragma unroll
      for (int k = 0; k < 8; ++k)  // CfL: X += xf * Y, B += bf * Y
        d[k] = c == 1 ? dY[k] : deq(v[c][k], c, k) * iq + (c == 0 ? fx : fb) * dY[k];
      if (ky == 0) d[0] = live ? dc[((size_t)c * ys + by) * xs + bx] : 0.0f;  // the LLF
      // rows: T[c, ky, x] = sum_kx d[kx] * A[kx, x]
      float t[8];
#pragma unroll
      for (int x = 0; x < 8; ++x) {
        float acc = 0.0f;
#pragma unroll
        for (int l = 0; l < 8; ++l) acc = fmaf(d[l], basis.A[l * 8 + x], acc);
        t[x] = acc;
      }
      float4* t4 = reinterpret_cast<float4*>(tile + c * 64 + ky * 8);
      t4[0] = make_float4(t[0], t[1], t[2], t[3]);
      t4[1] = make_float4(t[4], t[5], t[6], t[7]);
    }
    __syncwarp();
    // columns: pix[c, y, x] = sum_k A[k, y] * T[c, k, x], y = ky
    const int row = by * 8 + ky, col = bx * 8;
    const bool store = live && row < H8 && col + 8 <= W8;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float4* t4 = reinterpret_cast<const float4*>(tile + c * 64);
      float px[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const float4 lo4 = t4[2 * k], hi4 = t4[2 * k + 1];
        px[0] = fmaf(ay[k], lo4.x, px[0]);
        px[1] = fmaf(ay[k], lo4.y, px[1]);
        px[2] = fmaf(ay[k], lo4.z, px[2]);
        px[3] = fmaf(ay[k], lo4.w, px[3]);
        px[4] = fmaf(ay[k], hi4.x, px[4]);
        px[5] = fmaf(ay[k], hi4.y, px[5]);
        px[6] = fmaf(ay[k], hi4.z, px[6]);
        px[7] = fmaf(ay[k], hi4.w, px[7]);
      }
      if (store) {
        float4* o = reinterpret_cast<float4*>(out + ((size_t)c * H8 + row) * W8 + col);
        o[0] = make_float4(px[0], px[1], px[2], px[3]);
        o[1] = make_float4(px[4], px[5], px[6], px[7]);
      }
    }
    __syncwarp();  // the tile is rewritten by the next group
  }
}

template <typename T>
cudaError_t launch_dct8(const void* coef, const float* tab,
                        const Dct8Basis& basis, const float* dc, int ys, int xs, const int* bys,
                        const int* bxs, const float* inv_qac, const float* xf,
                        const float* bf, const long long* fix_idx,
                        const int* fix_val, int n_fix, float* out, int n,
                        int H8, int W8, BiasParams bp, float qm0, float qm1,
                        float qm2, cudaStream_t s) {
  constexpr int rows = kDct8Warps * kDct8Groups * 4;
  synth_dct8_kernel<T><<<(n + rows - 1) / rows, 32 * kDct8Warps, 0, s>>>(
      static_cast<const T*>(coef), tab, dc, ys, xs, bys, bxs, inv_qac, xf,
      bf, fix_idx, fix_val, n_fix, out, n, H8, W8, bp, qm0, qm1, qm2, basis);
  return cudaGetLastError();
}

// one family's arguments, as jxl_synth_family takes them
struct FamilyArgs {
  const void* coef;
  const float *mat, *mat_y, *dc;
  int ys, xs;
  const float *anY, *anX, *rs;
  const long long* fix_idx;
  const int* fix_val;
  int n_fix;
  const float *inv_qac, *xf, *bf;
  const int *bys, *bxs;
  const float *Ah, *Aw;
  float *out, *scratch;
  int n, bh, bw, H8, W8;
  BiasParams bp;
  float qm0, qm1, qm2;
};

template <typename T>
cudaError_t launch(int special, const FamilyArgs& a, cudaStream_t stream) {
  const T* c = static_cast<const T*>(a.coef);
  if (special) {
    synth_special_kernel<T><<<a.n, 192, 0, stream>>>(
        c, a.mat, a.mat_y, a.dc, a.ys, a.xs, a.fix_idx, a.fix_val, a.n_fix,
        a.inv_qac, a.xf, a.bf, a.bys, a.bxs, a.out, a.H8, a.W8, a.bp, a.qm0,
        a.qm1, a.qm2);
    return cudaGetLastError();
  }
  const int K = a.bh * a.bw;
  const int threads = 3 * K < 256 ? 3 * K : 256;
  if (a.scratch) {
    synth_dct_kernel<T, true><<<a.n, threads, 0, stream>>>(
        c, a.mat, a.dc, a.ys, a.xs, a.anY, a.anX, a.rs, a.fix_idx, a.fix_val,
        a.n_fix, a.inv_qac, a.xf, a.bf, a.bys, a.bxs, a.Ah, a.Aw, a.out, a.bh,
        a.bw, a.H8, a.W8, a.bp, a.qm0, a.qm1, a.qm2, a.scratch);
    return cudaGetLastError();
  }
  const size_t smem = (size_t)6 * K * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        synth_dct_kernel<T, false>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  synth_dct_kernel<T, false><<<a.n, threads, smem, stream>>>(
      c, a.mat, a.dc, a.ys, a.xs, a.anY, a.anX, a.rs, a.fix_idx, a.fix_val,
      a.n_fix, a.inv_qac, a.xf, a.bf, a.bys, a.bxs, a.Ah, a.Aw, a.out, a.bh,
      a.bw, a.H8, a.W8, a.bp, a.qm0, a.qm1, a.qm2, a.scratch);
  return cudaGetLastError();
}

}  // namespace

// coef: (n, 3, K) int8/int16/int32 (coef_bytes 1/2/4), basis-ordered
// (special: scan-ordered, K = 64).  mat: the dequant steps tab (3, K)
// for DCT families (times qm in the kernel), the response matrices
// (3, 64, 64) for special ones; mat_y: the default Y response (64, 64),
// special only.  dc: (3, ys, xs) DC image; anY / anX / rs: the LLF's
// (cy, cy) / (cx, cx) analysis bases and (cy, cx) resampling scales,
// DCT families only.  fix_idx (int64) / fix_val (int32): the n_fix
// entries of the exception list, sorted by flat index into coef.  Ah/Aw:
// the (bh, bh) / (bw, bw) cosine bases, DCT families only.  out: (3, H8,
// W8) float32.  scratch: null (stage in shared memory) or n * 6 * K
// floats of global memory, for families whose staging exceeds shared
// memory.  Returns the launch's cudaError_t.
extern "C" int jxl_synth_family(
    int special, int coef_bytes, const void* coef, const float* mat,
    const float* mat_y, const float* dc, int ys, int xs, const float* anY,
    const float* anX, const float* rs, const long long* fix_idx,
    const int* fix_val, int n_fix, const float* inv_qac, const float* xf,
    const float* bf, const int* bys, const int* bxs, const float* Ah,
    const float* Aw, float* out, float* scratch, int n, int bh, int bw,
    int H8, int W8, float qb0, float qb1, float qb2, float num, float qm0,
    float qm1, float qm2, void* stream) {
  if (n <= 0) return cudaSuccess;
  if (special && (bh != 8 || bw != 8)) return cudaErrorInvalidValue;
  if (bh < 8 || bw < 8 || (bh & (bh - 1)) || (bw & (bw - 1)))
    return cudaErrorInvalidValue;  // every strategy: 8 .. 256, powers of two
  const FamilyArgs a{coef, mat, mat_y, dc, ys, xs, anY, anX, rs, fix_idx,
                     fix_val, n_fix, inv_qac, xf, bf, bys, bxs, Ah, Aw, out,
                     scratch, n, bh, bw, H8, W8, {{qb0, qb1, qb2}, num}, qm0,
                     qm1, qm2};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (coef_bytes) {
    case 1: return launch<int8_t>(special, a, s);
    case 2: return launch<int16_t>(special, a, s);
    case 4: return launch<int32_t>(special, a, s);
    default: return cudaErrorInvalidValue;
  }
}

// The DCT8 family.  coef: (n, 3, 64) int8/int16/int32 (coef_bytes 1/2/4),
// basis-ordered; tab: (3, 64) dequant steps; A: host pointer to the
// (8, 8) cosine basis, copied into the launch parameters;
// dc: (3, ys, xs) DC image; fix_idx (int64) / fix_val (int32): the
// n_fix entries of the exception list, sorted by flat index into coef
// (n_fix 0: none).  out: (3, H8, W8) float32.
extern "C" int jxl_synth_dct8(
    int coef_bytes, const void* coef, const float* tab, const float* A,
    const float* dc, int ys, int xs, const int* bys, const int* bxs,
    const float* inv_qac, const float* xf, const float* bf,
    const long long* fix_idx, const int* fix_val, int n_fix, float* out,
    int n, int H8, int W8, float qb0, float qb1, float qb2, float num,
    float qm0, float qm1, float qm2, void* stream) {
  if (n <= 0) return cudaSuccess;
  BiasParams bp{{qb0, qb1, qb2}, num};
  Dct8Basis basis;
  for (int i = 0; i < 64; ++i) basis.A[i] = A[i];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (coef_bytes) {
    case 1:
      return launch_dct8<int8_t>(coef, tab, basis, dc, ys, xs, bys, bxs, inv_qac,
                                 xf, bf, fix_idx, fix_val, n_fix, out, n, H8,
                                 W8, bp, qm0, qm1, qm2, s);
    case 2:
      return launch_dct8<int16_t>(coef, tab, basis, dc, ys, xs, bys, bxs, inv_qac,
                                  xf, bf, fix_idx, fix_val, n_fix, out, n, H8,
                                  W8, bp, qm0, qm1, qm2, s);
    case 4:
      return launch_dct8<int32_t>(coef, tab, basis, dc, ys, xs, bys, bxs, inv_qac,
                                  xf, bf, fix_idx, fix_val, n_fix, out, n, H8,
                                  W8, bp, qm0, qm1, qm2, s);
    default:
      return cudaErrorInvalidValue;
  }
}
