// The Modular inverse transforms: the squeeze row scan, the inverse RCT and
// the palette gather, over int32 channel planes (the arithmetic and the
// indexing are in modular.cuh).
//
// Replace the JAX package's device loops in jxl_coder_tpu/modular/device.py:
// _unsqueeze_1d_jnp (:62, its lax.scan at :91), _rct_inverse_jnp (:98) and
// the palette gather of undo_transforms_device (:162-178).  They are held
// to the int64 host oracle, jxl_coder_tpu/modular/transform.py, not to
// device.py: its SmoothTendency in int32 wraps from about 2^28 (fault R1).
// Here each output is the int64 value cut to int32, as numpy's
// .astype(np.int32) cuts it: the unsqueeze step runs in int32 only where
// every sum of it fits (the carry and the step's inputs under 2^27), and
// the RCT's sums are int64.
//
// unsqueeze: what bounds it on the H100 is the serial chain, not bytes.
// Each line (a row for a horizontal squeeze, a column for a vertical one)
// carries its last output into the next step's SmoothTendency, so a line is
// one thread and the line's length is the time.  A block is 32 lines: one
// warp walks them along the squeeze axis in chunks of kChunk steps in
// shared memory, while three helper warps bring the next chunk of averages
// and residuals in by cp.async and store the last chunk's outputs, both
// coalesced.  Along a row (horizontal), a thread per row reading its row
// directly would touch 32 cache lines per load; staging turns that into
// row segments, and the same staging serves the vertical squeeze, whose
// loads coalesce either way, so both take one path.  Line pitches in
// shared memory are odd, so a warp reading one step of 32 lines, or 32
// steps of one line, hits 32 banks.  The walk runs the int32 step over a
// chunk and, if the carry or an input left 2^27, the chunk again in
// int64: on 4K planes on an H100 SXM (700 W) the int32 step is 1.37x
// (horizontal) and 1.79x (vertical) faster than the int64 one
// (modular_vs_other.py).
//
// rct_inverse: one thread per pixel over three planes, bound by bytes (12 B
// in, 12 B out).  palette_inverse: one thread per pixel gathering num_c
// values from the palette (the meta channel, small and read through the
// read-only cache), bound by bytes (4 B in, 4 * num_c B out).

#include <cuda_runtime.h>
#include <stdint.h>

#include "modular.cuh"

namespace {

using namespace jxl_modular;

__device__ __forceinline__ void async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// Warp 0 walks chunk c of its 32 lines while the kHelpers warps bring
// chunk c + 1 in by cp.async and store chunk c - 1's outputs (two buffers
// of each), so the walk waits on no load or store; one barrier a chunk.
__global__ void __launch_bounds__(kLines * (1 + kHelpers))
    unsqueeze_kernel(Unsqueeze u) {
  __shared__ int s_avg[2][kLines * kAvgPitch];
  __shared__ int s_res[2][kLines * kAvgPitch];
  __shared__ int s_out[2][kLines * kOutPitch];
  const int l0 = blockIdx.x * kLines;
  const bool walker = threadIdx.x < kLines;
  const int h = threadIdx.x - kLines;  // a helper's index
  long long left = 0;
  if (!walker) {
    u.load(h, kHelpers, l0, 0, s_avg[0], s_res[0]);
    async_commit();
    async_wait_all();
  }
  __syncthreads();
  int b = 0;
  for (int k0 = 0; k0 < u.na; k0 += kChunk, b ^= 1) {
    if (walker) {
      u.walk(threadIdx.x, l0, k0, s_avg[b], s_res[b], s_out[b], left);
    } else {
      if (k0 + kChunk < u.na) {
        u.load(h, kHelpers, l0, k0 + kChunk, s_avg[b ^ 1], s_res[b ^ 1]);
        async_commit();
      }
      if (k0 > 0) u.store(h, kHelpers, l0, k0 - kChunk, s_out[b ^ 1]);
      async_wait_all();
    }
    __syncthreads();
  }
  if (!walker) u.store(h, kHelpers, l0, (u.na - 1) / kChunk * kChunk,
                       s_out[b ^ 1]);
}

__global__ void rct_kernel(const int* __restrict__ c0,
                           const int* __restrict__ c1,
                           const int* __restrict__ c2, long long rs0,
                           long long rs1, long long rs2, int* __restrict__ out,
                           int H, int W, int typ, int perm) {
  const long long n = (long long)H * W;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const long long y = i / W, x = i - y * W;
    long long o[3];
    rct_components(c0[y * rs0 + x], c1[y * rs1 + x], c2[y * rs2 + x], typ, o);
#pragma unroll
    for (int k = 0; k < 3; ++k)
      out[rct_channel(perm, k) * n + i] = (int)o[k];
  }
}

__global__ void palette_kernel(const int* __restrict__ pal, long long pal_rs,
                               int nb, const int* __restrict__ idx,
                               long long idx_rs, int* __restrict__ out, int H,
                               int W, int num_c) {
  const long long n = (long long)H * W;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const long long y = i / W, x = i - y * W;
    const int v = idx[y * idx_rs + x];
    for (int c = 0; c < num_c; ++c)
      out[c * n + i] = palette_value(pal + c * pal_rs, nb, v);
  }
}

// a grid-stride loop over at most 32 blocks of `threads` per SM
int grid_for(long long n, int threads) {
  const long long blocks = (n + threads - 1) / threads;
  return (int)(blocks < 132 * 32 ? blocks : 132 * 32);
}

}  // namespace

// avg (lines, na) or (na, lines) with row stride avg_rs; res likewise with
// nr steps; out contiguous, (lines, na + nr) or (na + nr, lines).
extern "C" int jxl_unsqueeze(const int* avg, long long avg_rs, const int* res,
                             long long res_rs, int* out, int lines, int na,
                             int nr, int horizontal, void* stream) {
  if (lines <= 0 || na <= 0) return cudaSuccess;
  Unsqueeze u;
  u.avg = avg;
  u.res = res;
  u.out = out;
  u.pa = horizontal ? Plane{avg_rs, 1} : Plane{1, avg_rs};
  u.pr = horizontal ? Plane{res_rs, 1} : Plane{1, res_rs};
  u.po = horizontal ? Plane{na + nr, 1} : Plane{1, lines};
  u.lines = lines;
  u.na = na;
  u.nr = nr;
  u.horizontal = horizontal;
  unsqueeze_kernel<<<(lines + kLines - 1) / kLines,
                     kLines * (1 + kHelpers), 0,
                     static_cast<cudaStream_t>(stream)>>>(u);
  return cudaGetLastError();
}

// c0..c2: (H, W) planes with row strides rs0..rs2; out: (3, H, W);
// rct_type in [0, 42).
extern "C" int jxl_rct_inverse(const int* c0, const int* c1, const int* c2,
                               long long rs0, long long rs1, long long rs2,
                               int* out, int H, int W, int rct_type,
                               void* stream) {
  if (H <= 0 || W <= 0) return cudaSuccess;
  const int threads = 256;
  rct_kernel<<<grid_for((long long)H * W, threads), threads, 0,
               static_cast<cudaStream_t>(stream)>>>(
      c0, c1, c2, rs0, rs1, rs2, out, H, W, rct_type % 7, rct_type / 7);
  return cudaGetLastError();
}

// pal: (num_c, >= nb) with row stride pal_rs; idx: (H, W) with row stride
// idx_rs; out: (num_c, H, W).
extern "C" int jxl_palette_inverse(const int* pal, long long pal_rs, int nb,
                                   const int* idx, long long idx_rs, int* out,
                                   int H, int W, int num_c, void* stream) {
  if (H <= 0 || W <= 0 || num_c <= 0) return cudaSuccess;
  const int threads = 256;
  palette_kernel<<<grid_for((long long)H * W, threads), threads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      pal, pal_rs, nb, idx, idx_rs, out, H, W, num_c);
  return cudaGetLastError();
}
