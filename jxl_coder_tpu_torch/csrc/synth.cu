// VarDCT synthesis for one strategy family: coefficients -> XYB pixels
// written straight into the (3, H8, W8) frame planes.
//
// Replaces the TPU kernel jxl_coder_tpu/vardct/synth_pallas.py
// (synth_family_pallas -> _kernel) and the jnp path it shadows,
// jxl_coder_tpu/vardct/tpu_full.py (_synth_family, both branches), plus
// the perm_inv gather + 24-slice detile of tpu_full._build_fn: the
// epilogue stores each pixel at (bys*8 + y, bxs*8 + x), so no tile rows
// and no assembly pass exist.
//
// Per varblock:  AdjustQuantBias -> x tab*qm -> x inv_qac -> CfL
// (X += xf*Y, B += bf*Y) -> LLF corner from the DC image (computed in
// torch before the launch, passed in `llf`) -> separable inverse DCT
// (rows, then columns) in fp32 FMA.  The TPU kernel multiplied by a
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
// 125 MB, or ~37 us at 3.35 TB/s; the DCT8 inverse transform is
// 48 FMA/px (~12 us of fp32 at 67 TFLOP/s).  This first form stages one
// varblock per thread block in shared memory (6*K floats: 1.5 KB for
// DCT8, 96 KB for DCT64X64) and is bound by block scheduling and
// __syncthreads latency on the DCT8 family, not by bandwidth; packing
// several DCT8 blocks per thread block is the next step.  DCT128X128
// and the DCT256 families (up to 1.5 MB of staging per varblock) stage
// in a global scratch buffer the wrapper allocates instead; they are
// rare and slow, and no TPU path ever ran them.

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

// SCRATCH selects global staging at compile time, so the shared-memory
// form keeps shared-memory loads: a pointer that may be either compiles
// to generic loads.
template <typename T, bool SCRATCH>
__global__ void synth_dct_kernel(
    const T* __restrict__ coef, const float* __restrict__ tabqm,
    const float* __restrict__ llf, const float* __restrict__ inv_qac,
    const float* __restrict__ xf, const float* __restrict__ bf,
    const int* __restrict__ bys, const int* __restrict__ bxs,
    const float* __restrict__ Ah, const float* __restrict__ Aw,
    float* __restrict__ out, int bh, int bw, int H8, int W8,
    BiasParams bp, float* __restrict__ scratch) {
  extern __shared__ float smem[];
  const int K = bh * bw;
  const int b = blockIdx.x;
  float* work = SCRATCH ? scratch + (size_t)b * 6 * K : smem;
  float* C = work;          // (3, bh, bw) dequantized coefficients
  float* Tm = work + 3 * K; // (3, bh, bw) after the row transform
  const int by = bys[b];
  if (by == kPadSentinel) return;
  const int bx = bxs[b];
  const int cy = bh >> 3, cx = bw >> 3, ncl = cy * cx;
  const float iq = inv_qac[b], fx = xf[b], fb = bf[b];
  const T* cb = coef + (size_t)b * 3 * K;

  for (int i = threadIdx.x; i < 3 * K; i += blockDim.x) {
    const int c = i / K, k = i - c * K;
    const int ky = k / bw, kx = k - ky * bw;
    float d;
    if (ky < cy && kx < cx) {
      d = llf[((size_t)b * 3 + c) * ncl + ky * cx + kx];
    } else {
      d = adjust_bias((float)cb[i], bp.qb[c], bp.num) * tabqm[i] * iq;
      if (c != 1) {
        const float dy =
            adjust_bias((float)cb[K + k], bp.qb[1], bp.num) * tabqm[K + k] * iq;
        d = d + (c == 0 ? fx : fb) * dy;
      }
    }
    C[i] = d;
  }
  __syncthreads();
  // rows: T[c, ky, x] = sum_kx C[c, ky, kx] * Aw[kx, x]
  for (int i = threadIdx.x; i < 3 * K; i += blockDim.x) {
    const int row = i / bw, x = i - row * bw;
    const float* cr = C + row * bw;
    float acc = 0.0f;
    for (int l = 0; l < bw; ++l) acc = fmaf(cr[l], Aw[l * bw + x], acc);
    Tm[i] = acc;
  }
  __syncthreads();
  // columns: pix[c, y, x] = sum_ky Ah[ky, y] * T[c, ky, x]
  for (int i = threadIdx.x; i < 3 * K; i += blockDim.x) {
    const int c = i / K, p = i - c * K;
    const int y = p / bw, x = p - y * bw;
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
    const float* __restrict__ resp_y, const float* __restrict__ llf,
    const float* __restrict__ inv_qac, const float* __restrict__ xf,
    const float* __restrict__ bf, const int* __restrict__ bys,
    const int* __restrict__ bxs, float* __restrict__ out, int H8, int W8,
    BiasParams bp, float qm0, float qm1, float qm2) {
  __shared__ float V[3 * 64];
  const int b = blockIdx.x;
  const int by = bys[b];
  if (by == kPadSentinel) return;
  const int bx = bxs[b];
  const int i = threadIdx.x;           // 192 threads: (c, pixel)
  const int c = i >> 6, p = i & 63;
  V[i] = adjust_bias((float)coef[(size_t)b * 192 + i], bp.qb[c], bp.num);
  __syncthreads();
  const float iq = inv_qac[b];
  const float* rc = resp + (size_t)c * 64 * 64;
  float acc = 0.0f;
  for (int s = 1; s < 64; ++s) acc = fmaf(V[c * 64 + s], rc[s * 64 + p], acc);
  const float qm = c == 0 ? qm0 : (c == 1 ? qm1 : qm2);
  float pix = acc * (iq * qm);
  pix = pix + llf[(size_t)b * 3 + c] * rc[p];
  if (c != 1) {
    float ay = 0.0f;
    for (int s = 1; s < 64; ++s) ay = fmaf(V[64 + s], resp_y[s * 64 + p], ay);
    const float acY = ay * iq;
    pix = pix + (c == 0 ? xf[b] : bf[b]) * acY;
  }
  const int row = by * 8 + (p >> 3), col = bx * 8 + (p & 7);
  if (row < H8 && col < W8) out[((size_t)c * H8 + row) * W8 + col] = pix;
}

template <typename T>
cudaError_t launch(int special, const void* coef, const float* mat,
                   const float* mat_y, const float* llf, const float* inv_qac,
                   const float* xf, const float* bf, const int* bys,
                   const int* bxs, const float* Ah, const float* Aw,
                   float* out, float* scratch, int n, int bh, int bw, int H8,
                   int W8, BiasParams bp, float qm0, float qm1, float qm2,
                   cudaStream_t stream) {
  const T* c = static_cast<const T*>(coef);
  if (special) {
    synth_special_kernel<T><<<n, 192, 0, stream>>>(
        c, mat, mat_y, llf, inv_qac, xf, bf, bys, bxs, out, H8, W8, bp, qm0,
        qm1, qm2);
    return cudaGetLastError();
  }
  const int K = bh * bw;
  const int threads = 3 * K < 256 ? 3 * K : 256;
  if (scratch) {
    synth_dct_kernel<T, true><<<n, threads, 0, stream>>>(
        c, mat, llf, inv_qac, xf, bf, bys, bxs, Ah, Aw, out, bh, bw, H8, W8,
        bp, scratch);
    return cudaGetLastError();
  }
  const size_t smem = (size_t)6 * K * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        synth_dct_kernel<T, false>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  synth_dct_kernel<T, false><<<n, threads, smem, stream>>>(
      c, mat, llf, inv_qac, xf, bf, bys, bxs, Ah, Aw, out, bh, bw, H8, W8, bp,
      scratch);
  return cudaGetLastError();
}

}  // namespace

// coef: (n, 3, K) int8/int16/int32 (coef_bytes 1/2/4), basis-ordered
// (special: scan-ordered, K = 64).  mat: tab*qm (3, K) for DCT families,
// the response matrices (3, 64, 64) for special ones; mat_y: the default
// Y response (64, 64), special only.  llf: (n, 3, cy*cx).  Ah/Aw: the
// (bh, bh) / (bw, bw) cosine bases, DCT families only.  out: (3, H8, W8)
// float32.  scratch: null (stage in shared memory) or n * 6 * K floats
// of global memory, for families whose staging exceeds shared memory.
// Returns the launch's cudaError_t.
extern "C" int jxl_synth_family(
    int special, int coef_bytes, const void* coef, const float* mat,
    const float* mat_y, const float* llf, const float* inv_qac,
    const float* xf, const float* bf, const int* bys, const int* bxs,
    const float* Ah, const float* Aw, float* out, float* scratch, int n,
    int bh, int bw, int H8, int W8, float qb0, float qb1, float qb2,
    float num, float qm0, float qm1, float qm2, void* stream) {
  if (n <= 0) return cudaSuccess;
  if (special && (bh != 8 || bw != 8)) return cudaErrorInvalidValue;
  BiasParams bp{{qb0, qb1, qb2}, num};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (coef_bytes) {
    case 1:
      return launch<int8_t>(special, coef, mat, mat_y, llf, inv_qac, xf, bf,
                            bys, bxs, Ah, Aw, out, scratch, n, bh, bw, H8, W8,
                            bp, qm0, qm1, qm2, s);
    case 2:
      return launch<int16_t>(special, coef, mat, mat_y, llf, inv_qac, xf, bf,
                             bys, bxs, Ah, Aw, out, scratch, n, bh, bw, H8,
                             W8, bp, qm0, qm1, qm2, s);
    case 4:
      return launch<int32_t>(special, coef, mat, mat_y, llf, inv_qac, xf, bf,
                             bys, bxs, Ah, Aw, out, scratch, n, bh, bw, H8,
                             W8, bp, qm0, qm1, qm2, s);
    default:
      return cudaErrorInvalidValue;
  }
}
