// The AC entropy decode of one VarDCT pass group, token by token: the
// port of hostcodec.cpp's decode_ac_group_native with read_symbol_ans,
// read_uint_cfg and br_u (host/native/hostcodec.cpp), operation for
// operation, split in two: the token chain (decode_group_pass), which
// hands each nonzero coefficient to a sink as a record, and the scatter
// (apply_record), which adds it into the output.  Every function here is
// __host__ __device__: entropy.cu's kernel runs them on the card, and a
// CPU test builds this header with g++ (the sink a ring drained when
// full) and decodes the test streams' groups with it against the host
// decoder.

#pragma once

#include <stdint.h>

#if !defined(__CUDACC__)
#include <algorithm>
using std::max;
using std::min;
#endif

#if defined(__CUDACC__)
#define JXL_HD __host__ __device__ __forceinline__
#else
#define JXL_HD static inline
#endif

#define JXL_UNLIKELY(x) __builtin_expect(!!(x), 0)

namespace jxl_entropy {

// status bits: the native decoder's codes, and the port's own for a
// coefficient that leaves int32 after its pass's shift is added
constexpr int kErrUint = 2;       // a hybrid uint of 32 bits or more
constexpr int kErrNonzeros = 8;   // nz >= size - covered + 1
constexpr int kErrIndex = 9;      // coefficient index k >= size
constexpr int kErrOverrun = 16;   // a read past the section's end
constexpr int kErrOverflow = 32;  // the shifted sum outside int32
// the codes that end the group's decode after the token that set them
// (an overflow is recorded and the decode goes on)
constexpr int kStop = kErrUint | kErrNonzeros | kErrIndex | kErrOverrun;

constexpr int kGroupBlocks = 32;      // an AC group is 32 x 32 blocks
constexpr int kNonzeroBuckets = 37;
constexpr int kZeroDensityCtxs = 458;
constexpr int kMaxBlockCtxs = 16;     // block contexts per histogram
constexpr int kOrderBuckets = 13;     // coefficient orders per channel
// one histogram's contexts: the group's slice of the cluster map
constexpr int kMaxGroupCtxs =
    kMaxBlockCtxs * (kNonzeroBuckets + kZeroDensityCtxs);
// an anchor (a varblock, in the group's raster order) has kAnchorInts
// int32 fields, stored field-major (field f of anchor i at f * stride + i):
// bx, by (group-local blocks), covered, log2(covered), coefficients per
// channel, cx, cy, order bucket, block context of channels x, y, b, and
// one unused
constexpr int kAnchorInts = 12;

JXL_HD uint32_t load_word(const uint32_t* p) {
#if defined(__CUDA_ARCH__)
  return __ldg(p);
#else
  return *p;
#endif
}

// x << n and x >> n for n <= 32 (0 at 32)
JXL_HD uint32_t shl32(uint32_t x, int n) {
#if defined(__CUDA_ARCH__)
  return __funnelshift_lc(0u, x, n);
#else
  return n >= 32 ? 0u : x << n;
#endif
}

JXL_HD uint32_t shr32(uint32_t x, int n) {
#if defined(__CUDA_ARCH__)
  return __funnelshift_rc(x, 0u, n);
#else
  return n >= 32 ? 0u : x >> n;
#endif
}

// alias entry i of a table of two-word entries, both words in one load
// (a plain load: the kernel stages the table in shared memory when it
// fits)
JXL_HD void load_entry(const uint32_t* table, uint32_t i, uint32_t& e0,
                       uint32_t& e1) {
#if defined(__CUDA_ARCH__)
  const uint2 e = reinterpret_cast<const uint2*>(table)[i];
  e0 = e.x;
  e1 = e.y;
#else
  e0 = table[2 * i];
  e1 = table[2 * i + 1];
#endif
}

// br_u's bit reader over the whole codestream as little-endian 32-bit
// words: the next 32 to 63 bits in two 32-bit registers (lo first),
// shifted by funnel shifts, refilled a word at a time from a word loaded
// one refill ahead (an L1 hit, some tokens earlier), so that a refill
// never waits on memory.  Word indices are 32-bit.  A read past the
// section's end returns 0, consumes nothing and sets the overrun code; no
// word past the buffer is ever loaded.
struct Bits {
  const uint32_t* words;
  uint32_t next;         // the word after `ahead`
  uint32_t last;         // the buffer's last word: loads stop there
  uint32_t lo, hi;       // the next `avail` bits, lo first, 0 above them
  uint32_t ahead;        // the next word to enter the buffer
  int avail;
  uint32_t left;         // bits left in the section
};

JXL_HD void load_ahead(Bits& b) {
  b.ahead = load_word(b.words + b.next);
  b.next += b.next < b.last;
}

// the buffer back to 32 bits or more (the compiler predicates it: no
// branch)
JXL_HD void refill(Bits& b) {
  if (b.avail < 32) {
    b.lo |= b.ahead << b.avail;
    b.hi = shr32(b.ahead, 32 - b.avail);
    b.avail += 32;
    load_ahead(b);
  }
}

// drops n <= 32 bits of the buffer
JXL_HD void bits_skip(Bits& b, int n) {
#if defined(__CUDA_ARCH__)
  b.lo = __funnelshift_rc(b.lo, b.hi, n);
#else
  b.lo = n >= 32 ? b.hi : n == 0 ? b.lo : (b.lo >> n) | (b.hi << (32 - n));
#endif
  b.hi = shr32(b.hi, n);
  b.avail -= n;
}

// start <= end <= 32 * nwords, and a section shorter than 2^32 bits
JXL_HD void bits_init(Bits& b, const uint32_t* words, int64_t nwords,
                      int64_t start, int64_t end) {
  b.words = words;
  b.last = (uint32_t)(nwords - 1);
  b.next = (start >> 5) < (int64_t)b.last ? (uint32_t)(start >> 5) : b.last;
  b.left = (uint32_t)(end - start);
  b.lo = b.hi = 0;
  b.avail = 0;
  load_ahead(b);
  refill(b);
  bits_skip(b, (int)(start & 31));
}

// n <= 32
JXL_HD uint32_t bits_read(Bits& b, int n, int& status) {
  if ((uint32_t)n > b.left) {
    status |= kErrOverrun;
    return 0;
  }
  refill(b);
  const uint32_t v = b.lo & ~shl32(0xFFFFFFFFu, n);
  bits_skip(b, n);
  b.left -= n;
  return v;
}

// read_uint_cfg: cfg = split_exponent | msb_in_token << 8 | lsb_in_token << 16.
// Returns the value's low 32 bits and its bits above them in `hi`: a value
// of more than 32 bits takes the rare 64-bit path.
JXL_HD uint32_t read_uint(uint32_t cfg, uint32_t token, Bits& b,
                          int& status, uint32_t& hi) {
  hi = 0;
  const int se = cfg & 0xFF, msb = (cfg >> 8) & 0xFF, lsb = cfg >> 16;
  const uint32_t split = 1u << se;
  if (token < split) return token;
  const int n = se - (msb + lsb) + (int)((token - split) >> (msb + lsb));
  if (n >= 32) {
    status |= kErrUint;
    return 0;
  }
  const uint32_t low = token & ((1u << lsb) - 1);
  const uint32_t msbits = ((token >> lsb) & ((1u << msb) - 1)) | (1u << msb);
  const uint32_t bits = bits_read(b, n, status);
  if (msb + 1 + n + lsb <= 32) return (((msbits << n) | bits) << lsb) | low;
  const uint64_t u = ((((uint64_t)msbits << n) | bits) << lsb) | low;
  hi = (uint32_t)(u >> 32);
  return (uint32_t)u;
}

// What the token chain of one pass of one group reads besides its bits.
struct PassTables {
  const uint8_t* cmap;       // the group's histogram: context -> cluster
  const uint32_t* alias;     // the pass's entries, cluster << log_alpha
  const uint32_t* configs;   // the pass's hybrid uint configs by cluster
  const uint16_t* nz_ctx;    // kCoeffNumNonzeroCtx
  const uint16_t* freq_ctx;  // kCoeffFreqCtx
  int log_alpha;
  int num_ctxs;              // block contexts
};

// The alias entry of cluster `cl` for `state` (read_symbol_ans's lookup):
// two words per bucket, entry (cl << log_alpha) | bucket of the pass's
// table,
//   word 0 = cutoff | right << 8 | offset << 16
//   word 1 = freq[bucket] | freq[right] << 16
// (cutoff <= 128, symbols < 256, offsets < 4096, frequencies <= 4096),
// and the cluster's hybrid uint config, loaded beside it.
JXL_HD void entry_of(const PassTables& t, uint32_t cl, uint32_t state,
                     uint32_t& e0, uint32_t& e1, uint32_t& cfg) {
  cfg = t.configs[cl];
  load_entry(t.alias,
             (cl << t.log_alpha) | ((state & 0xFFF) >> (12 - t.log_alpha)),
             e0, e1);
}

// The symbol of a token from its entry (the buffer holding 32 bits or
// more): the state update, and the renormalisation of 16 bits or none
// without a branch.
JXL_HD uint32_t decode_symbol(const PassTables& t, uint32_t e0, uint32_t e1,
                              uint32_t& state, Bits& b, int& status) {
  const int log_entry = 12 - t.log_alpha;
  const uint32_t idx = state & 0xFFF;
  const uint32_t bucket = idx >> log_entry;
  const uint32_t pos = idx & ((1u << log_entry) - 1);
  const uint32_t cutoff = e0 & 0xFF;
  const bool low = pos < cutoff;
  const uint32_t sym = low ? bucket : (e0 >> 8) & 0xFF;
  const uint32_t off = low ? pos : (e0 >> 16) + pos - cutoff;
  const uint32_t freq = low ? e1 & 0xFFFF : e1 >> 16;
  const uint32_t next = freq * (state >> 12) + off;
  // both outcomes of the renormalisation, then one select
  const bool need = next < (1u << 16);
  const bool over = need && b.left < 16;
  state = need ? next << 16 | (over ? 0u : b.lo & 0xFFFF) : next;
  const int m = need && !over ? 16 : 0;
  bits_skip(b, m);
  b.left -= m;
  status |= over ? kErrOverrun : 0;
  return sym;
}

// Whether a symbol is its token's value: below its config's split
// (read_uint_cfg's first case)
JXL_HD bool is_value(uint32_t sym, uint32_t cfg) {
  const uint32_t se = cfg & 0xFF;
  return se < 32 && sym < (1u << se);
}

// One token of cluster `cl`: its value, the bits above 32 in `hi`.
JXL_HD uint32_t read_cluster(const PassTables& t, uint32_t cl,
                             uint32_t& state, Bits& b, int& status,
                             uint32_t& hi) {
  uint32_t e0, e1, cfg;
  entry_of(t, cl, state, e0, e1, cfg);
  const uint32_t sym = decode_symbol(t, e0, e1, state, b, status);
  return read_uint(cfg, sym, b, status, hi);
}

// The nonzero count's context from the neighbours' spread counts.
JXL_HD int nonzero_context(const uint8_t* nzrow, int bx, int by,
                           int num_ctxs, int bctx) {
  int predicted;
  if (by == 0)
    predicted = bx == 0 ? 32 : nzrow[bx - 1];
  else if (bx == 0)
    predicted = nzrow[(by - 1) * kGroupBlocks];
  else
    predicted = (nzrow[(by - 1) * kGroupBlocks + bx]
                 + nzrow[by * kGroupBlocks + bx - 1] + 1) / 2;
  if (predicted >= 64) predicted = 64;
  const int pctx = predicted < 8 ? predicted : 4 + predicted / 2;
  return pctx * num_ctxs + bctx;
}

// An anchor (the kAnchorInts fields at a[f * stride]) packed in one word
// for the pass's shared memory: bx, by (5 bits each), log2 cx, log2 cy (3
// each), the order bucket (4) and the block contexts of channels x, y, b
// (4 each).  covered = cx * cy, its log2 and the coefficients per channel
// (64 * covered) follow from them for every strategy.
JXL_HD uint32_t log2_of(uint32_t x) {   // x a power of two
  uint32_t l = 0;
  while ((2u << l) <= x) ++l;
  return l;
}

JXL_HD uint32_t pack_anchor(const int32_t* a, int64_t stride) {
  const uint32_t lcx = log2_of((uint32_t)a[5 * stride]);
  const uint32_t lcy = log2_of((uint32_t)a[6 * stride]);
  return (uint32_t)a[0] | (uint32_t)a[stride] << 5 | lcx << 10 | lcy << 13
         | (uint32_t)a[7 * stride] << 16 | (uint32_t)a[8 * stride] << 20
         | (uint32_t)a[9 * stride] << 24 | (uint32_t)a[10 * stride] << 28;
}

JXL_HD int anchor_bucket(uint32_t w) { return (w >> 16) & 15; }
JXL_HD int anchor_log2cov(uint32_t w) { return ((w >> 10) & 7) + ((w >> 13) & 7); }

// A decoded nonzero coefficient as the chain hands it to the scatter: k,
// channel c and anchor ai in one word (k < 65536, c < 3, ai < 1024), its
// hybrid uint (unpack_signed not yet applied) in two.
JXL_HD uint32_t record_where(int ai, int c, int k) {
  return (uint32_t)ai | (uint32_t)c << 10 | (uint32_t)k << 12;
}

// What the scatter of one pass reads and writes.
struct Scatter {
  int32_t* out;              // the frame's coefficients
  const int64_t* offs;       // the group's anchors' slots
  const uint32_t* anchors;   // the group's packed anchors
  const int32_t* orders;     // the pass's coefficient orders, flat
  const int32_t* order_off;  // (order bucket, channel) -> offset, or -1
  int shift;                 // the pass's coefficient shift
  bool add;                  // false in the first pass: the slots are 0
};

// Adds a record's value << shift at its natural position in its anchor's
// 3 x size slot of `out` (the first pass stores it: its slots are known
// to be 0).  Returns 1 for a sum outside int32 (the host widens to int64
// instead), which is stored cut to int32.  Within a pass every position is
// written at most once, so records apply in any order.
JXL_HD int apply_record(const Scatter& s, uint32_t where, uint32_t lo,
                        uint32_t hi) {
  const int ai = where & 1023, c = (where >> 10) & 3, k = where >> 12;
  const uint32_t w = s.anchors[ai];
  const int64_t size = (int64_t)64 << anchor_log2cov(w);
  const int oo = s.order_off[anchor_bucket(w) * 3 + c];
  const int p = oo >= 0 ? (int)load_word((const uint32_t*)s.orders + oo + k)
                        : k;
  int32_t* dst = s.out + s.offs[ai] + c * size + p;
  // unpack_signed of the 64-bit uint
  const uint64_t u = (uint64_t)hi << 32 | lo;
  const int64_t v = (int64_t)(u >> 1) ^ -(int64_t)(u & 1);
  const int64_t acc = (s.add ? (int64_t)*dst : 0) + v * ((int64_t)1 << s.shift);
  *dst = (int32_t)acc;
  return acc != (int64_t)(int32_t)acc;
}

// decode_ac_group_native's token chain for one pass of one group: the
// anchors (packed) in raster order, channels y, x, b, each a nonzero count
// and then coefficients by zero-density context until the count is
// spent.  Each coefficient token calls sink.put(nonzero, where, lo, hi),
// which keeps a record for apply_record of each nonzero one, while
// sink.open(); then sink.room() (which publishes the records and waits
// for room) and the decode goes on.  The chain itself writes nothing else
// but the nonzero map.  nz_map is the group's 3 x 32 x 32 spread counts, zeroed.
// Returns the status without the overflow code (the scatter's); `tokens`
// counts the tokens read.
#if defined(__CUDACC__)
#pragma nv_exec_check_disable   // the card's Sink is __device__ only
#endif
template <class Sink>
JXL_HD int decode_group_pass(const uint32_t* anchors, int n_anchors,
                             const PassTables& t, Bits& b, uint32_t& state,
                             uint8_t* nz_map, Sink& sink, uint32_t& tokens) {
  int status = 0;
  refill(b);
  for (int ai = 0; ai < n_anchors; ai++) {
    const uint32_t w = anchors[ai];
    const int bx = w & 31, by = (w >> 5) & 31;
    const int cx = 1 << ((w >> 10) & 7), cy = 1 << ((w >> 13) & 7);
    const int log2cov = anchor_log2cov(w), cov = 1 << log2cov;
    const int size = 64 << log2cov;
    for (int ci = 0; ci < 3; ci++) {
      const int c = ci < 2 ? ci ^ 1 : 2;   // channels y, x, b
      const int bctx = (w >> (20 + 4 * c)) & 15;
      uint8_t* nzrow = nz_map + c * kGroupBlocks * kGroupBlocks;
      uint32_t nz_hi;
      const uint32_t nz = read_cluster(
          t, t.cmap[nonzero_context(nzrow, bx, by, t.num_ctxs, bctx)],
          state, b, status, nz_hi);
      refill(b);
      ++tokens;
      if (status & kStop) break;
      if (nz_hi || nz >= (uint32_t)(size - cov + 1)) {
        status |= kErrNonzeros;
        break;
      }
      int nzeros = (int)nz;   // < size here
      const uint8_t spread = (uint8_t)((nzeros + cov - 1) >> log2cov);
      for (int yy = 0; yy < cy; yy++)
        for (int xx = 0; xx < cx; xx++)
          nzrow[(by + yy) * kGroupBlocks + bx + xx] = spread;
      // (with no nonzeros the contexts below would index past the tables:
      // kCoeffNumNonzeroCtx[0] is a sentinel)
      if (nzeros == 0) continue;
      const int ctx_off =
          t.num_ctxs * kNonzeroBuckets + kZeroDensityCtxs * bctx;
      const int prev = nzeros > (size >> 4) ? 0 : 1;
      // the zero-density contexts' clusters; the next token's is read for
      // both values of this one ahead of its decode, off the chain
      const uint8_t* zd = t.cmap + ctx_off;
      uint32_t cl = zd[(t.nz_ctx[(nzeros + cov - 1) >> log2cov]
                        + t.freq_ctx[cov >> log2cov]) * 2 + prev];
      // The coefficients, software-pipelined: each token's alias entry is
      // loaded as soon as the token before it has its state and cluster,
      // and the rest of that token's work (its record, the refill, the
      // next contexts) runs while the load is in flight.  The common path
      // takes no branch but the loop's own: a token whose symbol is not
      // its value leaves the inner loop, and so does the sink where it
      // publishes (sink.open()).  Carried: the nonzero-count contexts of
      // nzeros and nzeros - 1, and the frequency context of k + 1.
      const uint32_t where = record_where(ai, c, 0);
      int k = cov;
      uint32_t ctx_a = t.nz_ctx[(nzeros + cov - 1) >> log2cov];
      uint32_t ctx_b = t.nz_ctx[(max(nzeros - 1, 1) + cov - 1) >> log2cov];
      uint32_t f1 = t.freq_ctx[min((k + 1) >> log2cov, 63)];
      uint32_t e0, e1, cfg;
      entry_of(t, cl, state, e0, e1, cfg);
      for (;;) {
        uint32_t sym = 0, cl0 = 0, cl1 = 0, ctx_c = 0, f2 = 0;
        bool slow = false;
        for (; nzeros > 0 && k < size && !(status & kStop) && sink.open();
             k++) {
          cl0 = zd[(ctx_a + f1) * 2];
          cl1 = zd[(ctx_b + f1) * 2 + 1];
          ctx_c = t.nz_ctx[(max(nzeros - 2, 1) + cov - 1) >> log2cov];
          f2 = t.freq_ctx[min((k + 2) >> log2cov, 63)];
          sym = decode_symbol(t, e0, e1, state, b, status);
          if (JXL_UNLIKELY(!is_value(sym, cfg))) {
            slow = true;
            break;
          }
          const bool nonzero = sym != 0 && !(status & kStop);
          cl = nonzero ? cl1 : cl0;
          entry_of(t, cl, state, e0, e1, cfg);
          ++tokens;
          sink.put(nonzero, where | (uint32_t)k << 12, sym, 0);
          refill(b);
          nzeros -= nonzero;
          ctx_a = nonzero ? ctx_b : ctx_a;
          ctx_b = nonzero ? ctx_c : ctx_b;
          f1 = f2;
        }
        if (slow) {   // the rest of read_uint_cfg for this token
          uint32_t hi;
          const uint32_t u = read_uint(t.configs[cl], sym, b, status, hi);
          ++tokens;
          const bool nonzero = (u | hi) != 0 && !(status & kStop);
          sink.put(nonzero, where | (uint32_t)k << 12, u, hi);
          refill(b);
          nzeros -= nonzero;
          cl = nonzero ? cl1 : cl0;
          ctx_a = nonzero ? ctx_b : ctx_a;
          ctx_b = nonzero ? ctx_c : ctx_b;
          f1 = f2;
          ++k;
          entry_of(t, cl, state, e0, e1, cfg);
          continue;
        }
        if (nzeros <= 0 || k >= size || (status & kStop)) break;
        sink.room();
      }
      if (status & kStop) break;
      if (nzeros > 0) {
        status |= kErrIndex;
        break;
      }
    }
    if (status & kStop) break;
  }
  return status;
}

}  // namespace jxl_entropy
