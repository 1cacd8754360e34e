// The arithmetic and the indexing of modular.cu's kernels, as
// __host__ __device__ functions: the kernels run them on the card, and a
// CPU test builds this header with g++, runs each kernel's program over
// its threads one after another, and holds it to the JAX package's int64
// host oracle (jxl_coder_tpu/modular/transform.py).

#pragma once

#include <stdint.h>

#include <type_traits>

#if !defined(__CUDACC__)
#include <algorithm>
using std::min;
#endif

#if defined(__CUDACC__)
#define JXL_HD __host__ __device__ __forceinline__
#define JXL_HD_MEMBER __host__ __device__ __forceinline__
#else
#define JXL_HD static inline
#define JXL_HD_MEMBER inline
#endif

namespace jxl_modular {

constexpr int kLines = 32;              // lines per block (one warp)
constexpr int kHelpers = 11;             // warps that load, prepare, store
constexpr int kChunk = 40;              // steps staged at a time
constexpr int kAvgPitch = kChunk + 1;   // the chunk's averages and the next
constexpr int kOutLines = kLines + 1;   // a step's output pairs, padded
// |v| < 2^27 for the carry and a step's average, next average and
// residual keeps every sum of the step inside int32 (4a - 3c - b + 6 <
// 2^30.3, the tendency and the residual's difference < 2^29.3, the
// outputs < 2^30), so the step in int32 equals the step in int64
constexpr int kFastBits = 27;

// the unsigned type of S's width: the steps' sums wrap in it rather than
// overflow
template <typename S>
using Wrap = typename std::make_unsigned<S>::type;

template <typename S>
JXL_HD bool fits_fast(S v) {
  return (Wrap<S>)v + ((Wrap<S>)1 << kFastBits) <
         ((Wrap<S>)1 << (kFastBits + 1));
}

// transform.smooth_tendency in S (int or long long), without branches:
// both clamped quotients, then the select.  In the rising branch the
// numerator is <= -6 and in the falling one >= 6, so C's truncating
// division is the reference's floor division where each is selected;
// where both hold (a == b == c) the rising branch wins, as np.where(m2,
// ...) is applied last.  In long long every sum of int32 inputs is exact;
// in int they are exact for |a|, |b|, |c| < 2^27, and outside that range
// they wrap to a defined wrong value, which the caller detects and
// discards.
template <typename S>
JXL_HD S smooth_tendency(S a, S b, S c) {
  using U = Wrap<S>;
  const S ab = (S)(2u * ((U)a - (U)b));
  const S bc = (S)(2u * ((U)b - (U)c));
  const U base = 4u * (U)a - 3u * (U)c - (U)b;
  S x = (S)(base + 6u) / 12;
  x = x - (x & 1) > ab ? (S)((U)ab + 1u) : x;
  x = x + (x & 1) > bc ? bc : x;
  S y = (S)(base - 6u) / 12;
  y = y + (y & 1) < ab ? (S)((U)ab - 1u) : y;
  y = y - (y & 1) < bc ? bc : y;
  return (a <= b && b <= c) ? y : ((a >= b && b >= c) ? x : 0);
}

// One step of transform._unsqueeze_1d in S: the two outputs from the carry
// `left`, the average a, the next average and the residual r.
template <typename S>
JXL_HD void unsqueeze_step(S left, S a, S next, S r, S& first, S& second) {
  using U = Wrap<S>;
  const U diff = (U)r + (U)smooth_tendency(left, a, next);
  // truncation toward zero: a negative diff rounds up
  const S half = (S)(diff + (diff >> (8 * sizeof(S) - 1))) >> 1;
  first = (S)((U)a + (U)half);
  second = (S)((U)first - diff);
}

// A 4-byte copy from device memory into shared memory: asynchronous on
// the card (cp.async, completed by the kernel's wait), a plain copy on the
// host.
JXL_HD void copy4(int* dst, const int* src) {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
#else
  *dst = *src;
#endif
}

// Line l, step k of a plane: at l * line + k * step (one of them 1).
struct Plane {
  long long line, step;
};

// A step's carry-free terms, made by the helper warps while the walker is
// a chunk behind: the average a, the residual r, bc = 2 (a - next) and
// k6 = 6 - 3 next - a (the tendency's numerator less 4 left, plus 6).
struct alignas(16) Step {
  int a, r, bc, k6;
};

// A step's two outputs, stored by the walker as one 8-byte value.
struct alignas(8) Pair {
  int v[2];
};

// unsqueeze_step in int32 from the carry and the step's record: the same
// operations on the same values, with the carry-free ones done before.
// a <= next is bc <= 0 (no wrap when |a|, |next| < 2^27).
JXL_HD void unsqueeze_fast(int left, Step s, int& first, int& second) {
  using U = unsigned;
  const int ab = (int)(2u * ((U)left - (U)s.a));
  const U num = 4u * (U)left + (U)s.k6;
  // (num - 12) / 12 is one less than num / 12 unless 0 < num < 12
  const int q = (int)num / 12;
  int x = q;
  x = x - (x & 1) > ab ? (int)((U)ab + 1u) : x;
  x = x + (x & 1) > s.bc ? s.bc : x;
  int y = q - (int)(num - 1u >= 11u);
  y = y + (y & 1) < ab ? (int)((U)ab - 1u) : y;
  y = y - (y & 1) < s.bc ? s.bc : y;
  const int tend = (left <= s.a && s.bc <= 0)
                       ? y
                       : ((left >= s.a && s.bc >= 0) ? x : 0);
  const U diff = (U)s.r + (U)tend;
  const int half = (int)(diff + (diff >> 31)) >> 1;
  first = (int)((U)s.a + (U)half);
  second = (int)((U)first - diff);
}

// Whether a step's int32 form equals its int64 one and leaves a carry
// under 2^27, from its inputs alone.  The tendency lies between 0 and
// bc = 2 (a - next): in the falling branch (left >= a >= next) the
// numerator 4 (left - a) + 3 (a - next) + 6 is positive, so x starts at
// >= 0, its first clamp sets ab + 1 >= 1, and its second keeps x <= bc
// (x + (x & 1) > bc sets bc, else x <= bc); the rising branch mirrors it,
// and the third case is 0.  So |diff| <= |r| + |bc|, and the carry
// first - diff = a + half - diff lies within ceil(|diff| / 2) of a.  With
// |a|, |next|, |r| < 2^27 and |a| + ceil((|r| + |bc|) / 2) < 2^27, and a
// carry under 2^27 coming in, every sum of the step fits in int32 and the
// next carry is under 2^27 again: a chunk whose steps all pass needs only
// its incoming carry checked.
JXL_HD bool step_fits(int a, int next, int r) {
  if (!(fits_fast(a) && fits_fast(next) && fits_fast(r))) return false;
  // |a|, |next|, |r| <= 2^27 now: these sums stay under 2^31
  const int bc = a > next ? a - next : next - a;
  const int reach = (a < 0 ? -a : a) + ((r < 0 ? -r : r) + 2 * bc + 1) / 2;
  return reach < (1 << kFastBits);
}

// One unsqueeze block's work, a chunk of kChunk steps at a time, in four
// phases: the helper warps load a chunk's averages and residuals (raw),
// turn them into the walker's records and range flags (prep), and store
// an earlier chunk's outputs (store), while the walking warp walks the
// chunk before (walk).  The CPU test runs each phase for every thread in
// turn.  avg has na steps, res nr (na or na - 1), out na + nr.
struct Unsqueeze {
  const int* avg;
  Plane pa;
  const int* res;
  Plane pr;
  int* out;
  Plane po;
  int lines, na, nr, horizontal;

  // averages k0 .. k0 + kChunk (the last is the next step's average,
  // clamped to na - 1: the last step's "next" is its own average) and
  // residuals k0 .. k0 + kChunk - 1, copied by helper thread h of nw warps.
  // Horizontal: each warp copies row segments, consecutive threads on
  // consecutive steps; vertical: thread h % 32 copies its own column,
  // consecutive threads on consecutive columns.
  JXL_HD_MEMBER void copy(int line, int l, int j, int k0, int* s_avg,
                          int* s_res) const {
    const int k = min(k0 + j, na - 1);
    copy4(s_avg + l * kAvgPitch + j, avg + line * pa.line + k * pa.step);
    if (j < kChunk && k0 + j < nr)
      copy4(s_res + l * kAvgPitch + j,
            res + line * pr.line + (k0 + j) * pr.step);
  }

  JXL_HD_MEMBER void load(int h, int nw, int l0, int k0, int* s_avg,
                          int* s_res) const {
    const int w = h / kLines, lane = h % kLines;
    if (horizontal) {
      for (int l = w; l < kLines && l0 + l < lines; l += nw)
        for (int j = lane; j < kAvgPitch; j += kLines)
          copy(l0 + l, l, j, k0, s_avg, s_res);
    } else if (l0 + lane < lines) {
      for (int j = w; j < kAvgPitch; j += nw)
        copy(l0 + lane, lane, j, k0, s_avg, s_res);
    }
  }

  // the chunk's records, step j of line l at j * kLines + l, and helper
  // warp w's range flag of line l at w * kLines + l (1: every step it made
  // passes step_fits).  Helper h makes the steps h / 32, h / 32 + nw, ...
  // of line h % 32.
  JXL_HD_MEMBER void prep(int h, int nw, int l0, int k0, const int* s_avg,
                          const int* s_res, Step* s_rec, int* s_ok) const {
    const int w = h / kLines, l = h % kLines;
    int ok = 1;
    if (l0 + l < lines) {
      const int n = min(kChunk, na - k0);
      for (int j = w; j < n; j += nw) {
        const int a = s_avg[l * kAvgPitch + j];
        const int next = s_avg[l * kAvgPitch + j + 1];
        const bool walked = k0 + j < nr;
        const int r = walked ? s_res[l * kAvgPitch + j] : 0;
        using U = unsigned;
        s_rec[j * kLines + l] = Step{a, r, (int)(2u * ((U)a - (U)next)),
                                     (int)(6u - 3u * (U)next - (U)a)};
        if (walked && !step_fits(a, next, r)) ok = 0;
      }
    }
    s_ok[w * kLines + l] = ok;
  }

  // thread t's line through the chunk from its carry `left` (at k0 == 0
  // the first average): the int32 step from the records, and again in
  // int64 from device memory if the incoming carry or a step's inputs
  // failed the range check
  JXL_HD_MEMBER void walk(int t, int nw, int l0, int k0,
                          const Step* __restrict__ s_rec,
                          const int* __restrict__ s_ok,
                          Pair* __restrict__ s_out, long long& left) const {
    if (l0 + t >= lines) return;
    if (k0 == 0) left = s_rec[t].a;
    const int steps = min(kChunk, nr - k0);  // the steps with a residual
    bool ok = fits_fast(left);
    for (int w = 0; w < nw; ++w) ok = ok & (s_ok[w * kLines + t] != 0);
    int carry = (int)left;
    // the next step's record is loaded while this one's chain runs (the
    // records have a row past the chunk)
    Step q = s_rec[t];
#if defined(__CUDACC__)
#pragma unroll 8
#endif
    for (int j = 0; j < steps; ++j) {
      const Step next = s_rec[(j + 1) * kLines + t];
      int first;
      unsqueeze_fast(carry, q, first, carry);
      s_out[j * kOutLines + t] = Pair{{first, carry}};
      q = next;
    }
    if (ok) {
      left = carry;
    } else {
      const long long line = l0 + t;
      for (int j = 0; j < steps; ++j) {
        const int k = k0 + j;
        long long first;
        unsqueeze_step<long long>(
            left, avg[line * pa.line + k * pa.step],
            avg[line * pa.line + min(k + 1, na - 1) * pa.step],
            res[line * pr.line + k * pr.step], first, left);
        s_out[j * kOutLines + t] = Pair{{(int)first, (int)left}};
      }
    }
    // an odd length's last step has no residual: its output is the average
    if (steps < kChunk && k0 + steps < na)
      s_out[steps * kOutLines + t].v[0] = s_rec[steps * kLines + t].a;
  }

  // the chunk's outputs from shared memory, by helper thread h of nw warps
  JXL_HD_MEMBER void store(int h, int nw, int l0, int k0,
                           const Pair* s_out) const {
    const int w = h / kLines, lane = h % kLines;
    const int n_out = min(2 * kChunk, na + nr - 2 * k0);
    const int* so = reinterpret_cast<const int*>(s_out);
    if (horizontal) {
      for (int l = w; l < kLines && l0 + l < lines; l += nw)
        for (int j = lane; j < n_out; j += kLines)
          out[(l0 + l) * po.line + 2 * k0 + j] =
              so[2 * ((j >> 1) * kOutLines + l) + (j & 1)];
    } else if (l0 + lane < lines) {
      for (int j = w; j < n_out; j += nw)
        out[(2 * k0 + j) * po.step + l0 + lane] =
            so[2 * ((j >> 1) * kOutLines + lane) + (j & 1)];
    }
  }
};

// jxl_unsqueeze's arguments as a block program's plane: avg (lines, na) or
// (na, lines) with row stride avg_rs, res likewise with nr steps, out
// contiguous, (lines, na + nr) or (na + nr, lines)
JXL_HD Unsqueeze unsqueeze_of(const int* avg, long long avg_rs,
                              const int* res, long long res_rs, int* out,
                              int lines, int na, int nr, int horizontal) {
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
  return u;
}

// One channel of a batched launch, as the wrapper writes it (int64 each):
// jxl_unsqueeze's arguments, then the channel's first block.
struct UnsqueezeDesc {
  long long avg, avg_rs, res, res_rs, out, lines, na, nr, horizontal, block0;
};

// the entry of a batched launch's table that block `blk` belongs to
JXL_HD int unsqueeze_find(const UnsqueezeDesc* table, int n, long long blk) {
  int d = 0;
  for (int i = 1; i < n; ++i)
    if (blk >= table[i].block0) d = i;
  return d;
}

JXL_HD Unsqueeze unsqueeze_of(const UnsqueezeDesc& d) {
  return unsqueeze_of((const int*)d.avg, d.avg_rs, (const int*)d.res,
                      d.res_rs, (int*)d.out, (int)d.lines, (int)d.na,
                      (int)d.nr, (int)d.horizontal);
}

// The shared arrays of an unsqueeze block, two buffers of each: the raw
// chunk, its records and flags, the outputs.
struct UnsqueezeShared {
  int avg[2][kLines * kAvgPitch];
  int res[2][kLines * kAvgPitch];
  Step rec[2][(kChunk + 1) * kLines];
  int ok[2][kHelpers * kLines];
  Pair out[2][kChunk * kOutLines];
};

// transform._PERMUTATIONS[perm][i]: the channel that takes the inverse's
// component i
JXL_HD int rct_channel(int perm, int i) {
  return perm < 3 ? (i + perm) % 3 : (perm - i) % 3;
}

// transform._rct_inverse_type: o = the inverse's components for stored
// channels (a, b, c); the caller writes o[i] to channel rct_channel(perm, i)
JXL_HD void rct_components(long long a, long long b, long long c, int typ,
                           long long o[3]) {
  switch (typ) {
    case 0: o[0] = a; o[1] = b; o[2] = c; break;
    case 1: o[0] = a; o[1] = b; o[2] = c + a; break;
    case 2: o[0] = a; o[1] = b + a; o[2] = c; break;
    case 3: o[0] = a; o[1] = b + a; o[2] = c + a; break;
    case 4: o[0] = a; o[1] = b + ((a + c) >> 1); o[2] = c; break;
    case 5: {  // the third += first happens before the second uses it
      const long long c2 = c + a;
      o[0] = a; o[1] = b + ((a + c2) >> 1); o[2] = c2;
      break;
    }
    default: {  // 6, YCoCg
      const long long tmp = a - (c >> 1);
      const long long g = c + tmp;
      const long long bb = tmp - (b >> 1);
      o[0] = bb + b; o[1] = g; o[2] = bb;
    }
  }
}

// transform.palette_inverse without deltas, for one index v and the
// palette's row of channel c: v in [0, nb) reads the row, v >= nb gives
// v - nb, a negative v gives 0 (fault R2, kept as the reference has it)
JXL_HD int palette_value(const int* row, int nb, int v) {
  if (v >= 0 && v < nb) return row[v];
  return v >= nb ? v - nb : 0;
}

}  // namespace jxl_modular
