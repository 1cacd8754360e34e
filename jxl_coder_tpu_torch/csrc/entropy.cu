// The AC entropy decode of a VarDCT frame's pass groups, on the card:
// from the codestream's bytes to the frame's quantised coefficients, in
// natural order at each varblock's slot of the frame-global BlockArrays
// layout, bit-exact with the host decoder (host/native/hostcodec.cpp
// decode_ac_group_native).
//
// Replaces the JAX package's device entropy decode,
// jxl_coder_tpu/entropy/device.py _compiled_kernel (a jitted lax.scan,
// not a Pallas kernel), which decodes every group in lockstep, one
// vector lane per group, so that each step costs the slowest lane's.
//
// What bounds it on the H100: not bytes.  The whole frame's compressed
// stream is a few MB, microseconds at 3.35 TB/s.  Each group is one
// serial chain of dependent steps: a token's context needs the previous
// token's value, its alias entry needs the rANS state the previous token
// left, and the state needs the entry.  So the kernel's time is the
// longest group's tokens times the latency of one token's chain (the
// cluster map read, the alias entry load, the state update, the bit
// reads, the context arithmetic).
//
// What the design does about it: one group per thread block of one
// warp, decoded by lane 0, so that each group runs its chain at its own
// pace and no lane waits for another group's branches (the TPU's
// lockstep serialised them).  The block's other lanes only stage, into
// shared memory: the group's histogram slice of the context -> cluster
// map (<= 7.9 KB), the zeroed 3 x 32 x 32 nonzero map and, when they
// fit in kStageBytes, the pass's alias entries (2 KB a cluster) and
// hybrid uint configs, so that every table read on a token's chain is a
// shared-memory read with 32-bit addressing (larger tables are read from
// global memory by the other instantiation).  The next coefficient's
// cluster is read for both values of the current one before its decode,
// and the config beside the alias entry, off the chain.  The bits sit in
// a 64-bit register refilled a word at a time.  At most ~107 KB of
// shared memory a block leaves room for two blocks an SM, so a frame of
// more groups than SMs (135 at 4K, on 132 SMs) needs no second wave.  A
// group owns all its passes (each with its own rANS state and tables)
// and adds value << shift into its own slots: no atomics.

#include <cuda_runtime.h>
#include <stdint.h>

#include "entropy.cuh"

namespace {

using namespace jxl_entropy;

constexpr int kThreads = 32;
// per pass: log_alpha, alias base (words), config base, cluster map base,
// shift, alias words, configs
constexpr int kPassInts = 7;
// the largest pass tables staged in shared memory
constexpr int kStageBytes = 96 * 1024;

struct Args {
  const uint32_t* words;
  long long nwords;
  const int32_t* anchors;      // (kAnchorInts, N), N = group_start[G]
  const int64_t* offs;         // (N + 1,)
  const int32_t* group_start;  // (G + 1,)
  const int64_t* streams;      // (P, G, 3): start bit, end bit, ctx base
  const int32_t* passes;       // (P, kPassInts)
  const uint32_t* alias;
  const uint32_t* configs;
  const uint8_t* cmap;
  const int32_t* orders;
  const int32_t* order_off;    // (P, kOrderBuckets, 3) offsets into
                               // orders, or -1
  const uint16_t* ctx_tabs;    // kCoeffNumNonzeroCtx, kCoeffFreqCtx (64 each)
  int num_ctxs, num_passes, num_groups;
  int stage_words;             // the largest pass's alias words + configs
  int32_t* out;
  int32_t* status;             // (G,)
  uint32_t* states;            // (P, G) final rANS states
  int64_t* tokens;             // (G,)
};

template <bool kStaged>
__global__ void __launch_bounds__(kThreads) groups_kernel(Args a) {
  extern __shared__ __align__(16) uint32_t tables_s[];  // alias, configs
  __shared__ uint8_t cmap_s[kMaxGroupCtxs];
  __shared__ uint8_t nz_s[3 * kGroupBlocks * kGroupBlocks];
  __shared__ uint16_t tabs_s[128];
  __shared__ int status_s;
  const int g = blockIdx.x;
  const int lane = threadIdx.x;
  const int n_ctx = a.num_ctxs * (kNonzeroBuckets + kZeroDensityCtxs);
  const int first = a.group_start[g];
  const int n_anchors = a.group_start[g + 1] - first;
  for (int i = lane; i < 128; i += kThreads) tabs_s[i] = a.ctx_tabs[i];
  if (lane == 0) status_s = 0;
  int64_t tokens = 0;
  for (int p = 0; p < a.num_passes; p++) {
    const int32_t* pp = a.passes + p * kPassInts;
    const int64_t* st = a.streams + ((int64_t)p * a.num_groups + g) * 3;
    const uint8_t* cmap = a.cmap + pp[3] + st[2];
    for (int i = lane; i < n_ctx; i += kThreads) cmap_s[i] = cmap[i];
    if (kStaged) {
      for (int i = lane; i < pp[5]; i += kThreads)
        tables_s[i] = a.alias[pp[1] + i];
      for (int i = lane; i < pp[6]; i += kThreads)
        tables_s[pp[5] + i] = a.configs[pp[2] + i];
    }
    for (int i = lane; i < 3 * kGroupBlocks * kGroupBlocks; i += kThreads)
      nz_s[i] = 0;
    __syncthreads();
    if (lane == 0) {
      PassTables t;
      t.cmap = cmap_s;
      t.alias = kStaged ? tables_s : a.alias + pp[1];
      t.configs = kStaged ? tables_s + pp[5] : a.configs + pp[2];
      t.orders = a.orders;
      t.order_off = a.order_off + p * kOrderBuckets * 3;
      t.nz_ctx = tabs_s;
      t.freq_ctx = tabs_s + 64;
      t.log_alpha = pp[0];
      t.num_ctxs = a.num_ctxs;
      t.shift = pp[4];
      t.add = p > 0;
      Bits b;
      bits_init(b, a.words, a.nwords, st[0], st[1]);
      int s = 0;
      uint32_t state = bits_read(b, 32, s);
      if (!(s & kStop))
        s |= decode_group_pass(a.anchors + first,
                               a.group_start[a.num_groups], n_anchors,
                               a.offs + first, t, b, state, nz_s, a.out,
                               tokens);
      a.states[(int64_t)p * a.num_groups + g] = state;
      status_s = s;
    }
    __syncthreads();
    if (status_s) break;
  }
  if (lane == 0) {
    a.status[g] = status_s;
    a.tokens[g] = tokens;
  }
}

}  // namespace

extern "C" int jxl_entropy_groups(
    const void* words, long long nwords, const void* anchors,
    const void* offs, const void* group_start, const void* streams,
    const void* passes, const void* alias, const void* configs,
    const void* cmap, const void* orders, const void* order_off,
    const void* ctx_tabs, int num_ctxs, int num_passes, int num_groups,
    int stage_words, void* out, void* status, void* states, void* tokens,
    cudaStream_t stream) {
  Args a;
  a.words = static_cast<const uint32_t*>(words);
  a.nwords = nwords;
  a.anchors = static_cast<const int32_t*>(anchors);
  a.offs = static_cast<const int64_t*>(offs);
  a.group_start = static_cast<const int32_t*>(group_start);
  a.streams = static_cast<const int64_t*>(streams);
  a.passes = static_cast<const int32_t*>(passes);
  a.alias = static_cast<const uint32_t*>(alias);
  a.configs = static_cast<const uint32_t*>(configs);
  a.cmap = static_cast<const uint8_t*>(cmap);
  a.orders = static_cast<const int32_t*>(orders);
  a.order_off = static_cast<const int32_t*>(order_off);
  a.ctx_tabs = static_cast<const uint16_t*>(ctx_tabs);
  a.num_ctxs = num_ctxs;
  a.num_passes = num_passes;
  a.num_groups = num_groups;
  a.stage_words = stage_words;
  a.out = static_cast<int32_t*>(out);
  a.status = static_cast<int32_t*>(status);
  a.states = static_cast<uint32_t*>(states);
  a.tokens = static_cast<int64_t*>(tokens);
  if (stage_words <= kStageBytes / 4) {
    const int smem = stage_words * 4;
    if (smem > 48 * 1024)
      cudaFuncSetAttribute(groups_kernel<true>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    groups_kernel<true><<<num_groups, kThreads, smem, stream>>>(a);
  } else {
    groups_kernel<false><<<num_groups, kThreads, 0, stream>>>(a);
  }
  return (int)cudaGetLastError();
}
