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
// warp walks them along the squeeze axis in chunks of kChunk steps, while
// kHelpers (11) helper warps bring a later chunk of averages and residuals
// in by cp.async, turn each step into a 16-byte record of its carry-free terms
// (the average, the residual, 2 (a - next), 6 - 3 next - a) and each
// line's range flag (modular.cuh step_fits: the inputs alone bound the
// next carry, so the walk checks only the carry a chunk starts from), and
// store an earlier chunk's outputs, all coalesced.  A walker's step is one
// 16-byte shared load, the chain and one 8-byte shared store: a lone warp
// issues in order, so everything off the chain leaves it.  With 3 or 7
// helpers the horizontal squeeze's chunks waited on them at the barrier
// (PERF.md §6).  Along a row
// (horizontal), a thread per row reading its row directly would touch 32
// cache lines per load; staging turns that into row segments, and the
// same staging serves the vertical squeeze, whose loads coalesce either
// way, so both take one path.  Raw line pitches in shared memory are odd,
// records are step-major and outputs padded to 33 lines, so neither the
// walker nor the helpers meet a bank conflict worth counting.  A chunk
// whose range check fails is walked again in int64 from device memory.
// Every channel of a squeeze step is one launch (jxl_unsqueeze_batch:
// the block finds its channel in a table on the card); jxl_unsqueeze is a
// batch of one, its channel passed by value.  Fewer lines a block would
// not help: a lone walker's step latency, not the count of lines, sets
// the time while there are fewer than 132 x 32 lines.

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

__device__ __forceinline__ void helpers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"r"(kLines * kHelpers));
}

// Warp 0 walks chunk c of its 32 lines from the records while the kHelpers
// warps make chunk c + 1's records (after its cp.async lands: a barrier of
// the helpers alone), bring chunk c + 2 in by cp.async and store chunk
// c - 1's outputs (two buffers of each), so the walk waits on no load,
// store or carry-free operation; one block barrier a chunk.  A batched
// launch (table non-null) finds its channel by the first blocks of the
// table's n entries; a single one is `one`.
__global__ void __launch_bounds__(kLines * (1 + kHelpers))
    unsqueeze_kernel(const UnsqueezeDesc* __restrict__ table, int n,
                     Unsqueeze one) {
  extern __shared__ __align__(16) unsigned char smem[];
  UnsqueezeShared& sh = *reinterpret_cast<UnsqueezeShared*>(smem);
  int blk = blockIdx.x;
  Unsqueeze u = one;
  if (table) {
    const int d = unsqueeze_find(table, n, blk);
    u = unsqueeze_of(table[d]);
    blk -= (int)table[d].block0;
  }
  const int l0 = blk * kLines;
  const bool walker = threadIdx.x < kLines;
  const int h = threadIdx.x - kLines;  // a helper's index
  const int chunks = (u.na + kChunk - 1) / kChunk;
  long long left = 0;
  if (!walker) {
    u.load(h, kHelpers, l0, 0, sh.avg[0], sh.res[0]);
    async_commit();
    async_wait_all();
    helpers_sync();
    u.prep(h, kHelpers, l0, 0, sh.avg[0], sh.res[0], sh.rec[0], sh.ok[0]);
    if (chunks > 1) {
      u.load(h, kHelpers, l0, kChunk, sh.avg[1], sh.res[1]);
      async_commit();
    }
  }
  __syncthreads();
  for (int c = 0; c < chunks; ++c) {
    const int b = c & 1, k0 = c * kChunk;
    if (walker) {
      u.walk(threadIdx.x, kHelpers, l0, k0, sh.rec[b], sh.ok[b], sh.out[b],
             left);
    } else {
      if (c + 1 < chunks) {
        async_wait_all();
        helpers_sync();
        u.prep(h, kHelpers, l0, k0 + kChunk, sh.avg[b ^ 1], sh.res[b ^ 1],
               sh.rec[b ^ 1], sh.ok[b ^ 1]);
        if (c + 2 < chunks) {
          u.load(h, kHelpers, l0, k0 + 2 * kChunk, sh.avg[b], sh.res[b]);
          async_commit();
        }
      }
      if (c > 0) u.store(h, kHelpers, l0, k0 - kChunk, sh.out[b ^ 1]);
    }
    __syncthreads();
  }
  if (!walker)
    u.store(h, kHelpers, l0, (chunks - 1) * kChunk, sh.out[(chunks - 1) & 1]);
}

cudaError_t launch_unsqueeze(const UnsqueezeDesc* table, int n,
                             const Unsqueeze& one, long long blocks,
                             cudaStream_t s) {
  const int bytes = (int)sizeof(UnsqueezeShared);
  cudaError_t err = cudaFuncSetAttribute(
      unsqueeze_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(unsqueeze_kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  unsqueeze_kernel<<<(unsigned)blocks, kLines * (1 + kHelpers), bytes, s>>>(
      table, n, one);
  return cudaGetLastError();
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
// nr steps; out contiguous, (lines, na + nr) or (na + nr, lines).  A batch
// of one.
extern "C" int jxl_unsqueeze(const int* avg, long long avg_rs, const int* res,
                             long long res_rs, int* out, int lines, int na,
                             int nr, int horizontal, void* stream) {
  if (lines <= 0 || na <= 0) return cudaSuccess;
  return launch_unsqueeze(
      nullptr, 0,
      unsqueeze_of(avg, avg_rs, res, res_rs, out, lines, na, nr, horizontal),
      (lines + kLines - 1) / kLines, static_cast<cudaStream_t>(stream));
}

// table: n UnsqueezeDesc on the card, each a channel as jxl_unsqueeze
// takes it (lines > 0, na > 0) with its first block, block0, the sum of
// ceil(lines / 32) over the entries before it; blocks: that sum over all
// n.  One launch for every channel of a squeeze step.
extern "C" int jxl_unsqueeze_batch(const void* table, int n, long long blocks,
                                   void* stream) {
  if (n <= 0 || blocks <= 0) return cudaSuccess;
  return launch_unsqueeze(static_cast<const UnsqueezeDesc*>(table), n,
                          Unsqueeze{}, blocks,
                          static_cast<cudaStream_t>(stream));
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
