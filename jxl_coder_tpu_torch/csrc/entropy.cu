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
// What held the first design back (one warp a group, lane 0 doing it all,
// 358 cycles a token of the longest group against the chain's ~37): a
// warp issues in order, so every instruction that waited on memory held
// the next token's chain too.  Each nonzero coefficient loaded its
// position from the coefficient order in global memory and stored to it
// (in later passes after loading the old value), the bits were refilled
// by a global load used at once, each varblock began with 12 global loads
// of its anchor, and the values and the bit buffer were 64-bit.  Moving
// those off the chain showed the next limit: a lone warp pays for every
// branch it takes and issues its instructions one after another, so the
// token loop's instruction count and its branches set the time.
//
// What the design does about it: one group per thread block of four
// warps, split by role.  All four stage the pass's tables into shared
// memory: the group's histogram slice of the context -> cluster map
// (<= 7.9 KB), the zeroed 3 x 32 x 32 nonzero map, the group's anchors
// packed one word each (entropy.cuh pack_anchor, 4 KB) and, when they fit
// in kStageBytes, the pass's alias entries (2 KB a cluster) and hybrid
// uint configs (larger tables are read from global memory by the other
// instantiation).  Lane 0 of warp 0 then runs only the
// chain (entropy.cuh decode_group_pass): every table read is a
// shared-memory read, the values are 32-bit (a hybrid uint past 32 bits
// takes a rare 64-bit path), the bits sit in two 32-bit words shifted by
// funnel shifts and refilled from a word loaded one refill ahead, and the
// coefficient loop is software-pipelined: each token's alias entry is
// loaded as soon as the token before it has its state and cluster, and
// that token's other work runs while the load is in flight.  On its common
// path the loop takes no branch but its own: the renormalisation, the
// refill and the record are predicated, and a symbol not below its split,
// or the sink's next publication, leaves the loop.  For a nonzero coefficient
// lane 0 writes one 16-byte record (anchor, channel, k, the uint) into a
// ring in shared memory and never touches the output.  Warp 1 drains the
// ring 32 records at a time (entropy.cuh apply_record: the coefficient
// order, value << shift added at its slot, the int32 overflow check); a
// pass writes each position once, so the records apply in any order, and
// the barrier between passes keeps a pass's additions before the next
// one's.  Head and tail are acquire / release counters in shared memory;
// the chain publishes its head every kBatch records and waits only when
// the scatter is more than kRing - kBatch records behind.  At most ~111 KB of shared memory a
// block leaves room for two blocks an SM, so a frame of more groups than
// SMs (135 at 4K, on 132 SMs) needs no second wave.  A group owns all its
// passes (each with its own rANS state and tables) and its own slots: no
// atomics.

#include <cuda_runtime.h>
#include <stdint.h>

#include "entropy.cuh"

namespace {

using namespace jxl_entropy;

// warp 0: lane 0 runs the token chain; warp 1: the scatter; all four warps
// stage the pass's tables
constexpr int kThreads = 128;
// per pass: log_alpha, alias base (words), config base, cluster map base,
// shift, alias words, configs
constexpr int kPassInts = 7;
// the largest pass tables staged in shared memory: with the static ~23 KB
// a block takes at most 111 KB, so that two blocks fit an SM
constexpr int kStageBytes = 88 * 1024;
constexpr int kMaxAnchors = kGroupBlocks * kGroupBlocks;
constexpr int kRing = 512;     // records in flight between chain and scatter
constexpr int kBatch = 256;    // the chain publishes its head every 256

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

__device__ __forceinline__ uint32_t smem(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void st_release(uint32_t* p, uint32_t v) {
  asm volatile("st.release.cta.shared.u32 [%0], %1;" ::"r"(smem(p)), "r"(v)
               : "memory");
}

__device__ __forceinline__ uint32_t ld_acquire(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.acquire.cta.shared.u32 %0, [%1];"
               : "=r"(v)
               : "r"(smem(p))
               : "memory");
  return v;
}

// The records between the chain and the scatter: slot i & (kRing - 1),
// head and tail counted from 0 in each pass, done set after the last head
struct Ring {
  uint4 rec[kRing];
  uint32_t head, tail, done;
};

// The chain's end of the ring: a nonzero coefficient costs lane 0 one
// 16-byte shared store and an add, both predicated, and no branch.  The
// chain's loop stops where the sink is no longer open, every kBatch
// records: room() publishes the head, waits until the scatter has left
// room for kBatch more, and sets the next stop.
struct RingSink {
  Ring* r;
  uint32_t base;   // the records' shared-memory address
  uint32_t head, stop;

  __device__ bool open() const { return head != stop; }

  __device__ void put(bool keep, uint32_t where, uint32_t lo, uint32_t hi) {
    asm volatile(
        "{\n\t.reg .pred p;\n\tsetp.ne.u32 p, %0, 0;\n\t"
        "@p st.shared.v4.u32 [%1], {%2, %3, %4, %4};\n\t}" ::"r"(
            (uint32_t)keep),
        "r"(base + ((head & (kRing - 1)) << 4)), "r"(where), "r"(lo), "r"(hi));
    head += keep;
  }

  __device__ void publish() { st_release(&r->head, head); }

  __device__ void room() {
    publish();
    while (head + kBatch - ld_acquire(&r->tail) > (uint32_t)kRing)
      __nanosleep(32);
    stop = head + kBatch;
  }
};

// The scatter warp: what the chain has published, 32 records at once (a
// pass writes each position once), until the chain is done.  Returns
// whether a sum left int32.
__device__ int drain(const Scatter& s, Ring* r, int lane) {
  int over = 0;
  uint32_t tail = 0;
  for (;;) {
    uint32_t fin = 0, h = 0;
    if (lane == 0) {
      fin = ld_acquire(&r->done);
      h = ld_acquire(&r->head);
    }
    fin = __shfl_sync(0xffffffffu, fin, 0);
    h = __shfl_sync(0xffffffffu, h, 0);
    for (uint32_t i = tail + lane; i < h; i += 32) {
      const uint4 e = r->rec[i & (kRing - 1)];
      over |= apply_record(s, e.x, e.y, e.z);
    }
    if (h != tail) {
      __syncwarp();
      if (lane == 0) st_release(&r->tail, h);
      tail = h;
    } else if (!fin) {
      __nanosleep(64);
    }
    if (fin) break;
  }
  return __any_sync(0xffffffffu, over);
}

template <bool kStaged>
__global__ void __launch_bounds__(kThreads) groups_kernel(Args a) {
  extern __shared__ __align__(16) uint32_t tables_s[];  // alias, configs
  __shared__ uint8_t cmap_s[kMaxGroupCtxs];
  __shared__ uint8_t nz_s[3 * kGroupBlocks * kGroupBlocks];
  __shared__ uint16_t tabs_s[128];
  __shared__ uint32_t anchors_s[kMaxAnchors];
  __shared__ Ring ring;
  __shared__ int chain_s, over_s;
  const int g = blockIdx.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n_ctx = a.num_ctxs * (kNonzeroBuckets + kZeroDensityCtxs);
  const int first = a.group_start[g];
  const int n_anchors = a.group_start[g + 1] - first;
  // a group holds at most 32 x 32 varblocks (build_anchors)
  const bool fits = n_anchors <= kMaxAnchors;
  for (int i = tid; i < 128; i += kThreads) tabs_s[i] = a.ctx_tabs[i];
  for (int i = tid; i < n_anchors && fits; i += kThreads)
    anchors_s[i] = pack_anchor(a.anchors + first + i,
                               a.group_start[a.num_groups]);
  uint32_t tokens = 0;
  int status = fits ? 0 : kErrIndex;
  for (int p = 0; p < a.num_passes && !status; p++) {
    const int32_t* pp = a.passes + p * kPassInts;
    const int64_t* st = a.streams + ((int64_t)p * a.num_groups + g) * 3;
    const uint8_t* cmap = a.cmap + pp[3] + st[2];
    for (int i = tid; i < n_ctx; i += kThreads) cmap_s[i] = cmap[i];
    if (kStaged) {
      for (int i = tid; i < pp[5]; i += kThreads)
        tables_s[i] = a.alias[pp[1] + i];
      for (int i = tid; i < pp[6]; i += kThreads)
        tables_s[pp[5] + i] = a.configs[pp[2] + i];
    }
    for (int i = tid; i < 3 * kGroupBlocks * kGroupBlocks; i += kThreads)
      nz_s[i] = 0;
    if (tid == 0) {
      ring.head = ring.tail = ring.done = 0;
      chain_s = over_s = 0;
    }
    __syncthreads();
    if (tid == 0) {
      PassTables t;
      t.cmap = cmap_s;
      t.alias = kStaged ? tables_s : a.alias + pp[1];
      t.configs = kStaged ? tables_s + pp[5] : a.configs + pp[2];
      t.nz_ctx = tabs_s;
      t.freq_ctx = tabs_s + 64;
      t.log_alpha = pp[0];
      t.num_ctxs = a.num_ctxs;
      Bits b;
      bits_init(b, a.words, a.nwords, st[0], st[1]);
      int s = 0;
      uint32_t state = bits_read(b, 32, s);
      RingSink sink{&ring, smem(ring.rec), 0u, (uint32_t)kBatch};
      if (!(s & kStop))
        s |= decode_group_pass(anchors_s, n_anchors, t, b, state, nz_s,
                               sink, tokens);
      sink.publish();
      st_release(&ring.done, 1u);
      a.states[(int64_t)p * a.num_groups + g] = state;
      chain_s = s;
    } else if (warp == 1) {
      Scatter sc;
      sc.out = a.out;
      sc.offs = a.offs + first;
      sc.anchors = anchors_s;
      sc.orders = a.orders;
      sc.order_off = a.order_off + p * kOrderBuckets * 3;
      sc.shift = pp[4];
      sc.add = p > 0;
      const int over = drain(sc, &ring, lane);
      if (lane == 0) over_s = over;
    }
    __syncthreads();
    status = chain_s | (over_s ? kErrOverflow : 0);
    // the next pass's staging rewrites what this pass read
    __syncthreads();
  }
  if (tid == 0) {
    a.status[g] = status;
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
    cudaFuncSetAttribute(groups_kernel<true>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    groups_kernel<true><<<num_groups, kThreads, smem, stream>>>(a);
  } else {
    groups_kernel<false><<<num_groups, kThreads, 0, stream>>>(a);
  }
  return (int)cudaGetLastError();
}
