// Detile: gathered 8x8 tiles -> raster planes (kernel 7).
//
//   out[c, 8*by + py, 8*bx + px] = src[rows[by*NX + bx], c*64 + 8*py + px]
//
// src is (N_src, 192) f32, one row per tile (3 channels x 8 x 8); rows is
// an optional int32 index of NY*NX rows (the identity when null); out is
// (3, 8*NY, 8*NX) f32.
//
// Replaces the TPU kernel research/detile_probe.py v2 -> _detile_dma_kernel,
// and the detile (the transpose to raster) of the DCT8-only frame path,
// jxl_coder_tpu/vardct/tpu_real.py synth_from_dcp.  The TPU kernel issues
// 24 strided DMAs per block row, one for each (c, py) output row.
//
// What bounds it on the H100: pure data movement.  Each tile is read once
// (768 B) and written once: at 4K (129,600 tiles) ~199 MB, ~59 us at
// 3.35 TB/s.  Both sides must stay coalesced, but a tile row and a raster
// row cut the same data along different axes: a tile's 768 B are one
// contiguous source row, while a raster row takes 32 B from each of NX
// tiles.  So a thread block takes a segment of kTiles tiles of one block
// row, reads each tile's row with 16-byte loads into shared memory, and
// writes the segment's 24 raster row pieces (8*kTiles floats each) with
// 16-byte stores.  Each staged tile is padded to 200 floats, so the
// eight 16-byte reads of a quarter warp (4 tiles x 2 halves of a
// 32-byte tile row) fall on distinct banks.  A row index outside
// [0, N_src) writes NaN for its tile instead of reading past src.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTiles = 32;       // tiles per thread block (256 px wide)
constexpr int kThreads = 256;
constexpr int kStride = 200;     // staged floats per tile (192 + 8 pad)

__global__ void __launch_bounds__(kThreads)
detile_kernel(const float4* __restrict__ src, const int* __restrict__ rows,
              long long n_src, int NX, float4* __restrict__ out,
              long long plane4, int row4) {
  __shared__ float4 tiles[kTiles * kStride / 4];
  const int by = blockIdx.y;
  const int bx0 = blockIdx.x * kTiles;
  const int nt = min(kTiles, NX - bx0);

  // load: 48 float4 per tile row, consecutive threads on consecutive
  // addresses within a tile
  for (int i = threadIdx.x; i < nt * 48; i += kThreads) {
    const int t = i / 48, k = i - t * 48;
    const long long tile = (long long)by * NX + bx0 + t;
    const long long r = rows ? (long long)rows[tile] : tile;
    float4 v;
    if (r >= 0 && r < n_src) {
      v = src[r * 48 + k];
    } else {
      const float nan = __int_as_float(0x7fc00000);
      v = make_float4(nan, nan, nan, nan);
    }
    tiles[t * (kStride / 4) + k] = v;
  }
  __syncthreads();

  // store: output row (c, py) of this segment is 2*nt float4; float4 j
  // is half (j & 1) of tile row py of tile j >> 1, channel c
  const int per_row = 2 * nt;
  for (int i = threadIdx.x; i < 24 * per_row; i += kThreads) {
    const int cp = i / per_row, j = i - cp * per_row;
    const int c = cp >> 3, py = cp & 7;
    const int t = j >> 1, half = j & 1;
    const float4 v = tiles[t * (kStride / 4) + c * 16 + py * 2 + half];
    out[c * plane4 + (long long)(8 * by + py) * row4 + 2 * bx0 + j] = v;
  }
}

}  // namespace

// src: (n_src, 192) f32, 16-byte aligned; rows: NY*NX int32 or null;
// out: (3, 8*NY, 8*NX) f32, 16-byte aligned.
extern "C" int jxl_detile(const float* src, long long n_src, const int* rows,
                          int NY, int NX, float* out, void* stream) {
  if (NY <= 0 || NX <= 0) return cudaSuccess;
  const dim3 grid((NX + kTiles - 1) / kTiles, NY);
  const int row4 = 2 * NX;                             // 8*NX floats / 4
  const long long plane4 = (long long)8 * NY * row4;
  detile_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(src), rows, n_src, NX,
      reinterpret_cast<float4*>(out), plane4, row4);
  return cudaGetLastError();
}
