// The AC entropy decode of one VarDCT pass group, token by token: the
// port of hostcodec.cpp's decode_ac_group_native with read_symbol_ans,
// read_uint_cfg and br_u (host/native/hostcodec.cpp), operation for
// operation.  Every function here is __host__ __device__: entropy.cu's
// kernel runs them on the card, and a CPU test builds this header with
// g++ and decodes the test streams' groups with it against the host
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
// words: up to 63 bits in a register, refilled a word at a time, with
// 32-bit bookkeeping.  A read past the section's end returns 0, consumes
// nothing and sets the overrun code; no word past the buffer is ever
// loaded.
struct Bits {
  const uint32_t* next;  // the next word to load
  const uint32_t* last;  // the buffer's last word: loads stop there
  uint64_t buf;          // the next `avail` bits
  int avail;
  uint32_t left;         // bits left in the section
};

JXL_HD void refill(Bits& b) {
  if (b.avail < 32) {
    b.buf |= (uint64_t)load_word(b.next) << b.avail;
    b.avail += 32;
    if (b.next < b.last) ++b.next;
  }
}

// start <= end <= 32 * nwords, and a section shorter than 2^32 bits
JXL_HD void bits_init(Bits& b, const uint32_t* words, int64_t nwords,
                      int64_t start, int64_t end) {
  b.next = words + (start >> 5);
  b.last = words + nwords - 1;
  if (b.next > b.last) b.next = b.last;
  b.left = (uint32_t)(end - start);
  b.buf = 0;
  b.avail = 0;
  refill(b);
  b.buf >>= (start & 31);
  b.avail -= (int)(start & 31);
}

// n <= 32
JXL_HD uint32_t bits_read(Bits& b, int n, int& status) {
  if ((uint32_t)n > b.left) {
    status |= kErrOverrun;
    return 0;
  }
  refill(b);
  const uint32_t v = (uint32_t)(b.buf & ((1ull << n) - 1));
  b.buf >>= n;
  b.avail -= n;
  b.left -= n;
  return v;
}

// read_symbol_ans for cluster cl: its alias entries are two words per
// bucket, entry (cl << log_alpha) | bucket of the pass's table,
//   word 0 = cutoff | right << 8 | offset << 16
//   word 1 = freq[bucket] | freq[right] << 16
// (cutoff <= 128, symbols < 256, offsets < 4096, frequencies <= 4096)
JXL_HD uint32_t read_symbol(uint32_t& state, const uint32_t* alias,
                            uint32_t cl, int log_alpha, Bits& b,
                            int& status) {
  const int log_entry = 12 - log_alpha;
  const uint32_t idx = state & 0xFFF;
  const uint32_t bucket = idx >> log_entry;
  const uint32_t pos = idx & ((1u << log_entry) - 1);
  uint32_t e0, e1;
  load_entry(alias, (cl << log_alpha) | bucket, e0, e1);
  const uint32_t cutoff = e0 & 0xFF;
  uint32_t sym, off, freq;
  if (pos < cutoff) {
    sym = bucket;
    off = pos;
    freq = e1 & 0xFFFF;
  } else {
    sym = (e0 >> 8) & 0xFF;
    off = (e0 >> 16) + pos - cutoff;
    freq = e1 >> 16;
  }
  state = freq * (state >> 12) + off;
  if (state < (1u << 16)) state = (state << 16) | bits_read(b, 16, status);
  return sym;
}

// read_uint_cfg: cfg = split_exponent | msb_in_token << 8 | lsb_in_token << 16
JXL_HD uint64_t read_uint(uint32_t cfg, uint32_t token, Bits& b,
                          int& status) {
  const int se = cfg & 0xFF, msb = (cfg >> 8) & 0xFF, lsb = cfg >> 16;
  const uint32_t split = 1u << se;
  if (token < split) return token;
  const int n = se - (msb + lsb) + (int)((token - split) >> (msb + lsb));
  if (n >= 32) {
    status |= kErrUint;
    return 0;
  }
  const uint64_t low = token & ((1u << lsb) - 1);
  const uint64_t msbits = ((token >> lsb) & ((1u << msb) - 1)) | (1u << msb);
  return (((msbits << n) | bits_read(b, n, status)) << lsb) | low;
}

// What one pass of one group reads besides its bits.
struct PassTables {
  const uint8_t* cmap;       // the group's histogram: context -> cluster
  const uint32_t* alias;     // the pass's entries, cluster << log_alpha
  const uint32_t* configs;   // the pass's hybrid uint configs by cluster
  const int32_t* orders;     // the pass's coefficient orders, flat
  const int32_t* order_off;  // (order bucket, channel) -> offset, or -1
  const uint16_t* nz_ctx;    // kCoeffNumNonzeroCtx
  const uint16_t* freq_ctx;  // kCoeffFreqCtx
  int log_alpha;
  int num_ctxs;              // block contexts
  int shift;                 // the pass's coefficient shift
  bool add;                  // false in the first pass: the slots are 0
};

// One token of cluster `cl`: its symbol and its value.  The config is
// loaded first, beside the alias entry, so that its load is off the chain.
JXL_HD uint64_t read_cluster(const PassTables& t, uint32_t cl,
                             uint32_t& state, Bits& b, int& status) {
  const uint32_t cfg = t.configs[cl];
  const uint32_t sym = read_symbol(state, t.alias, cl, t.log_alpha, b,
                                   status);
  return read_uint(cfg, sym, b, status);
}

// One token: the cluster of context `ctx`, its symbol and its value.
JXL_HD uint64_t read_token(const PassTables& t, int ctx, uint32_t& state,
                           Bits& b, int& status) {
  return read_cluster(t, t.cmap[ctx], state, b, status);
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

// Adds value << shift at vals[p] (the first pass stores it: its slots
// are known to be 0, so no load waits on the chain); a sum outside int32
// sets `overflow` (the host widens to int64 instead).  The overflow is
// kept apart from the status so that no later token waits on the load.
JXL_HD void accumulate(int32_t* vals, int p, int64_t v, const PassTables& t,
                       int& overflow) {
  const int64_t acc = (t.add ? (int64_t)vals[p] : 0)
                      + v * ((int64_t)1 << t.shift);
  overflow |= acc != (int64_t)(int32_t)acc;
  vals[p] = (int32_t)acc;
}

// decode_ac_group_native for one pass of one group: the anchors in raster
// order, channels y, x, b, each a nonzero count and then coefficients by
// zero-density context until the count is spent.  Each value is added,
// shifted, at its natural position inside its anchor's 3 x size slot of
// `out` (offs: the anchors' frame-global offsets).  nz_map is the group's
// 3 x 32 x 32 spread counts, zeroed.  Returns the status; `tokens` counts
// the tokens read.
JXL_HD int decode_group_pass(const int32_t* anchors, int64_t stride,
                             int n_anchors, const int64_t* offs,
                             const PassTables& t,
                             Bits& b, uint32_t& state, uint8_t* nz_map,
                             int32_t* out, int64_t& tokens) {
  int status = 0, overflow = 0;
  for (int ai = 0; ai < n_anchors; ai++) {
    const int32_t* a = anchors + ai;
    const int bx = a[0], by = a[stride], cov = a[2 * stride];
    const int log2cov = a[3 * stride], size = a[4 * stride];
    const int cx = a[5 * stride], cy = a[6 * stride], bucket = a[7 * stride];
    for (int ci = 0; ci < 3; ci++) {
      const int c = ci < 2 ? ci ^ 1 : 2;   // channels y, x, b
      const int bctx = a[(8 + c) * stride];
      uint8_t* nzrow = nz_map + c * kGroupBlocks * kGroupBlocks;
      const uint64_t nz = read_token(
          t, nonzero_context(nzrow, bx, by, t.num_ctxs, bctx), state, b,
          status);
      ++tokens;
      if (status & kStop) break;
      if (nz >= (uint64_t)(size - cov + 1)) {
        status |= kErrNonzeros;
        break;
      }
      int nzeros = (int)nz;   // < size here
      const uint8_t spread = (uint8_t)((nzeros + cov - 1) >> log2cov);
      for (int yy = 0; yy < cy; yy++)
        for (int xx = 0; xx < cx; xx++)
          nzrow[(by + yy) * kGroupBlocks + bx + xx] = spread;
      const int oo = t.order_off[bucket * 3 + c];
      const int32_t* order = oo >= 0 ? t.orders + oo : nullptr;
      int32_t* vals = out + offs[ai] + (int64_t)c * size;
      const int ctx_off =
          t.num_ctxs * kNonzeroBuckets + kZeroDensityCtxs * bctx;
      int prev = nzeros > (size >> 4) ? 0 : 1;
      // the zero-density contexts' clusters; the next token's is read for
      // both values of this one ahead of its decode, off the chain
      const uint8_t* zd = t.cmap + ctx_off;
      uint32_t cl = zd[(t.nz_ctx[(nzeros + cov - 1) >> log2cov]
                        + t.freq_ctx[cov >> log2cov]) * 2 + prev];
      for (int k = cov; nzeros > 0; k++) {
        if (k >= size) {
          status |= kErrIndex;
          break;
        }
        const int f1 = t.freq_ctx[min((k + 1) >> log2cov, 63)];
        const uint32_t cl0 =
            zd[(t.nz_ctx[(nzeros + cov - 1) >> log2cov] + f1) * 2];
        const uint32_t cl1 = zd[(t.nz_ctx[(max(nzeros - 1, 1) + cov - 1)
                                          >> log2cov] + f1) * 2 + 1];
        const uint64_t u = read_cluster(t, cl, state, b, status);
        ++tokens;
        if (status & kStop) break;
        // unpack_signed
        const int64_t v = (int64_t)(u >> 1) ^ -(int64_t)(u & 1);
        if (v != 0) {
          const int p =
              order ? (int)load_word((const uint32_t*)order + k) : k;
          accumulate(vals, p, v, t, overflow);
        }
        prev = v != 0;
        nzeros -= prev;
        cl = prev ? cl1 : cl0;
      }
      if (status & kStop) break;
    }
    if (status & kStop) break;
  }
  return status | (overflow ? kErrOverflow : 0);
}

}  // namespace jxl_entropy
