// JPEG recompression's pixels: the block IDCT (J1) and the chroma
// upsampling + YCbCr -> RGB (J2), each with a plain C entry point
// (jpeg/pixels.py binds them; their plain twins are there too).
//
// They replace jitted jnp and numpy code of the JAX package, not Pallas
// kernels:
//   J1 idct_kernel: the dequantisation, de-zigzag, idct2d (vardct/dct.py:47,
//      an f32 einsum pair) and +128 of a recompressed JPEG's components
//      (jxl_coder_tpu/jpeg/wire.py:739-748, transcode.py:254-263).  In: each
//      component's quantised coefficients, int16 in zigzag order, block
//      after block, and its 64 quantisation values; out: its f32 plane in
//      raster order.  Every component takes one launch: a flat grid of
//      tiles, each a row of BPB 8x8 blocks of one component (no idle
//      blocks for the smaller chroma grids).  A tile's 256 threads first
//      stage the DCT basis, the zigzag table and the component's
//      quantisation values in shared memory (from global memory: a
//      warp-divergent read of kernel parameters or __constant__ memory
//      serialises), then 64 threads a block load its 64 coefficients (one
//      contiguous 128 B run), dequantise them and store them de-zigzagged;
//      the two separable passes follow, a thread an output sample, each a
//      sum of 8 products in the order of the twin's fp.matmul (products
//      0-3 into four accumulators, products 4-7 fused into them in
//      float64 and rounded to f32 once more, then (a0 + a1) + (a2 + a3)),
//      which is the order XLA's CPU dot sums, so the planes equal the
//      twin's and the JAX function's bit for bit.  Each block's samples
//      sit 72 floats apart in shared memory, so a warp's reads across its
//      4 blocks fall in distinct banks.  A warp's 32 threads store one row
//      of 4 blocks: 128 contiguous bytes.  Bound by bytes (2 B read, 4 B
//      written a sample).
//   J2 rgb_kernel<TRIANGLE, ROUND, GREY>: the chroma upsampling and BT.601
//      of wire.py:749-769 (triangle: (3a + b) / 4 per upsampled axis, the
//      horizontal pass first, edges repeated; +0.5 before the truncation)
//      and transcode.py:264-282 (nearest, np.repeat by any integer factor;
//      no +0.5; a grey image repeats Y).  A thread an output pixel: it
//      fetches its chroma samples by the reference's rule from the planes
//      at their own sizes, then the colour transform with the reference's
//      f32 constants in its order, the clip and the truncation to u8.
//      Bound by bytes (each plane read once, 3 B written a pixel).
// -fmad=false: each f32 operation rounds once, in the twins' order.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BPB = 4;               // 8x8 blocks a thread block
constexpr int THREADS = 64 * BPB;
constexpr int MAX_COMPS = 4;
constexpr int STRIDE = 72;           // a block's samples in shared memory
constexpr int TW = 32, TH = 8;       // J2's thread block

__host__ __device__ inline unsigned cdiv(long long a, int b) {
  return (unsigned)((a + b - 1) / b);
}

struct Comp {
  long long coef;    // offset of its first coefficient
  long long out;     // offset of its plane
  int bh, bw;        // its block grid
  int tiles;         // bh * ceil(bw / BPB)
};

struct IdctParams {
  Comp comp[MAX_COMPS];
  int n;
};

// fp.fma: the product is exact in float64; the sum rounds there, then to f32
__device__ __forceinline__ float fused(float a, float b, float c) {
  return __double2float_rn((double)a * (double)b + (double)c);
}

// quant: (n, 64) f32, zigzag order; basis: M[k * 8 + i], the DCT-II basis
// k at sample i; zigzag: the natural index of zigzag index k
__global__ void __launch_bounds__(THREADS)
    idct_kernel(const int16_t* __restrict__ coef,
                const float* __restrict__ quant,
                const float* __restrict__ basis,
                const int* __restrict__ zigzag, float* __restrict__ out,
                IdctParams p) {
  __shared__ float s_m[64], s_q[64];
  __shared__ int s_zz[64];
  __shared__ float s_c[BPB * STRIDE];   // dequantised, natural order
  __shared__ float s_t[BPB * STRIDE];   // after the first pass
  int t = blockIdx.x, ci = 0;
  while (ci < p.n - 1 && t >= p.comp[ci].tiles) t -= p.comp[ci++].tiles;
  const Comp cp = p.comp[ci];
  const int gx = (cp.bw + BPB - 1) / BPB;
  const int by = t / gx, bx0 = (t % gx) * BPB;
  const int tid = threadIdx.x;
  if (tid < 64)
    s_m[tid] = basis[tid];
  else if (tid < 128)
    s_zz[tid - 64] = zigzag[tid - 64];
  else if (tid < 192)
    s_q[tid - 128] = quant[ci * 64 + tid - 128];
  __syncthreads();
  {
    const int b = tid >> 6, k = tid & 63;
    if (bx0 + b < cp.bw) {
      const long long blk = (long long)by * cp.bw + bx0 + b;
      s_c[b * STRIDE + s_zz[k]] =
          (float)coef[cp.coef + blk * 64 + k] * s_q[k];
    }
  }
  __syncthreads();
  // a warp: one row i of the BPB blocks, 8 columns l each
  const int i = tid / (8 * BPB), b = (tid >> 3) % BPB, l = tid & 7;
  const bool live = bx0 + b < cp.bw;
  const float* c = s_c + b * STRIDE;
  if (live) {
    // t[i][l] = sum_j M[j][i] * c[j][l]
    float a[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) a[r] = s_m[r * 8 + i] * c[r * 8 + l];
#pragma unroll
    for (int j = 4; j < 8; ++j)
      a[j & 3] = fused(s_m[j * 8 + i], c[j * 8 + l], a[j & 3]);
    s_t[b * STRIDE + i * 8 + l] = (a[0] + a[1]) + (a[2] + a[3]);
  }
  __syncthreads();
  if (!live) return;
  // o[i][l] = sum_k t[i][k] * M[k][l]
  const float* tr = s_t + b * STRIDE + i * 8;
  float a[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) a[r] = tr[r] * s_m[r * 8 + l];
#pragma unroll
  for (int k = 4; k < 8; ++k)
    a[k & 3] = fused(tr[k], s_m[k * 8 + l], a[k & 3]);
  const float o = ((a[0] + a[1]) + (a[2] + a[3])) + 128.0f;
  out[cp.out + (long long)(by * 8 + i) * (cp.bw * 8) + (bx0 + b) * 8 + l] = o;
}

struct Plane {
  const float* p;
  int h, w;          // the plane's own size
  int fy, fx;        // its upsampling factors (1 or 2 for TRIANGLE)
};

// the plane's sample at output pixel (y, x)
template <bool TRIANGLE>
__device__ __forceinline__ float sample(const Plane& q, int y, int x) {
  if (!TRIANGLE) return q.p[(long long)(y / q.fy) * q.w + x / q.fx];
  // the horizontal pass at a row of the plane: (3 a + its neighbour) / 4
  auto across = [&](int r) -> float {
    const float* row = q.p + (long long)r * q.w;
    if (q.fx == 1) return row[x];
    const int j = x >> 1;
    const int nb = (x & 1) ? min(j + 1, q.w - 1) : max(j - 1, 0);
    return (3.0f * row[j] + row[nb]) * 0.25f;
  };
  if (q.fy == 1) return across(y);
  const int i = y >> 1;
  const int nb = (y & 1) ? min(i + 1, q.h - 1) : max(i - 1, 0);
  return (3.0f * across(i) + across(nb)) * 0.25f;
}

template <bool ROUND>
__device__ __forceinline__ uint8_t code(float v) {
  if (ROUND) v = v + 0.5f;
  return (uint8_t)(int)fminf(fmaxf(v, 0.0f), 255.0f);
}

template <bool TRIANGLE, bool ROUND, bool GREY>
__global__ void __launch_bounds__(TW * TH)
    rgb_kernel(Plane py, Plane pcb, Plane pcr, uint8_t* __restrict__ out,
               int H, int W) {
  const int x = blockIdx.x * TW + threadIdx.x;
  const int y = blockIdx.y * TH + threadIdx.y;
  if (x >= W || y >= H) return;
  uint8_t* dst = out + ((long long)y * W + x) * 3;
  const float Y = sample<TRIANGLE>(py, y, x);
  if (GREY) {
    const uint8_t v = code<ROUND>(Y);
    dst[0] = v;
    dst[1] = v;
    dst[2] = v;
    return;
  }
  const float cb = sample<TRIANGLE>(pcb, y, x) - 128.0f;
  const float cr = sample<TRIANGLE>(pcr, y, x) - 128.0f;
  dst[0] = code<ROUND>(Y + 1.402f * cr);
  dst[1] = code<ROUND>((Y - 0.344136f * cb) - 0.714136f * cr);
  dst[2] = code<ROUND>(Y + 1.772f * cb);
}

template <bool TRIANGLE, bool ROUND>
void launch_rgb(const Plane* planes, bool grey, uint8_t* out, int H, int W,
                cudaStream_t s) {
  const dim3 grid(cdiv(W, TW), cdiv(H, TH));
  const Plane& cb = planes[grey ? 0 : 1];
  const Plane& cr = planes[grey ? 0 : 2];
  if (grey)
    rgb_kernel<TRIANGLE, ROUND, true><<<grid, dim3(TW, TH), 0, s>>>(
        planes[0], cb, cr, out, H, W);
  else
    rgb_kernel<TRIANGLE, ROUND, false><<<grid, dim3(TW, TH), 0, s>>>(
        planes[0], cb, cr, out, H, W);
}

}  // namespace

// coef: every component's (bh, bw, 64) int16 coefficients back to back;
// comps: per component its coefficient offset, plane offset, bh, bw (4
// long longs); quant: (n, 64) f32, zigzag order; basis: the 8x8 DCT-II
// matrix; zigzag: 64 ints; out: the (bh * 8, bw * 8) f32 planes back to
// back.  quant, basis and zigzag are device memory.
extern "C" int jxl_jpeg_idct(const int16_t* coef, float* out, int n,
                             const long long* comps, const float* quant,
                             const float* basis, const int* zigzag,
                             void* stream) {
  if (n < 1 || n > MAX_COMPS) return cudaErrorInvalidValue;
  IdctParams p;
  p.n = n;
  long long tiles = 0;
  for (int c = 0; c < n; ++c) {
    p.comp[c].coef = comps[4 * c];
    p.comp[c].out = comps[4 * c + 1];
    p.comp[c].bh = (int)comps[4 * c + 2];
    p.comp[c].bw = (int)comps[4 * c + 3];
    p.comp[c].tiles = p.comp[c].bh * (int)cdiv(p.comp[c].bw, BPB);
    tiles += p.comp[c].tiles;
  }
  if (tiles == 0) return cudaSuccess;
  idct_kernel<<<(unsigned)tiles, THREADS, 0,
                static_cast<cudaStream_t>(stream)>>>(coef, quant, basis,
                                                     zigzag, out, p);
  return cudaGetLastError();
}

// planes: n (1 grey, or 3: Y, Cb, Cr) f32 planes, each contiguous with
// dims[4 * c ..] = h, w, fy, fx; out: (H, W, 3) uint8; triangle: the
// (3a + b) / 4 upsampling (factors 1 or 2), else nearest; round: +0.5
// before the truncation.
extern "C" int jxl_ycbcr_to_rgb(const float* const* planes, const int* dims,
                                int n, uint8_t* out, int H, int W,
                                int triangle, int round, void* stream) {
  if (n != 1 && n != 3) return cudaErrorInvalidValue;
  if (H <= 0 || W <= 0) return cudaSuccess;
  Plane q[3];
  for (int c = 0; c < n; ++c) {
    q[c] = Plane{planes[c], dims[4 * c], dims[4 * c + 1], dims[4 * c + 2],
                 dims[4 * c + 3]};
    if (q[c].fy < 1 || q[c].fx < 1 || (triangle && (q[c].fy > 2 ||
                                                     q[c].fx > 2)))
      return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool grey = n == 1;
  if (triangle && round)
    launch_rgb<true, true>(q, grey, out, H, W, s);
  else if (triangle)
    launch_rgb<true, false>(q, grey, out, H, W, s);
  else if (round)
    launch_rgb<false, true>(q, grey, out, H, W, s);
  else
    launch_rgb<false, false>(q, grey, out, H, W, s);
  return cudaGetLastError();
}
