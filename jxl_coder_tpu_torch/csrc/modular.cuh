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
constexpr int kHelpers = 3;             // warps that load and store for it
constexpr int kChunk = 40;              // steps staged at a time
constexpr int kAvgPitch = kChunk + 1;   // the chunk's averages and the next
constexpr int kOutPitch = 2 * kChunk + 1;
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

// One unsqueeze block's work on one chunk, in three phases: the helper
// warps load the next chunk and store the last one's outputs while the
// walking warp walks this one; the CPU test runs each phase for every
// thread in turn.  avg has na steps, res nr (na or na - 1), out na + nr.
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

  // thread t's line through the chunk from its carry `left` (at k0 == 0
  // the first average): the int32 step throughout, and again with the
  // int64 step if the carry or a step's inputs left 2^27
  JXL_HD_MEMBER void walk(int t, int l0, int k0,
                          const int* __restrict__ s_avg,
                          const int* __restrict__ s_res,
                          int* __restrict__ s_out, long long& left) const {
    if (l0 + t >= lines) return;
    const int* sa = s_avg + t * kAvgPitch;
    const int* sr = s_res + t * kAvgPitch;
    int* so = s_out + t * kOutPitch;
    if (k0 == 0) left = sa[0];
    const int steps = min(kChunk, nr - k0);  // the steps with a residual
    bool ok = fits_fast(left);
    int carry = (int)left;
#if defined(__CUDACC__)
#pragma unroll 8
#endif
    for (int j = 0; j < steps; ++j) {
      const int a = sa[j], next = sa[j + 1], r = sr[j];
      ok = ok & fits_fast(a) & fits_fast(next) & fits_fast(r);
      int first;
      unsqueeze_step(carry, a, next, r, first, carry);
      so[2 * j] = first;
      so[2 * j + 1] = carry;
      ok = ok & fits_fast(carry);
    }
    if (ok) {
      left = carry;
    } else {
      for (int j = 0; j < steps; ++j) {
        long long first;
        unsqueeze_step<long long>(left, sa[j], sa[j + 1], sr[j], first, left);
        so[2 * j] = (int)first;
        so[2 * j + 1] = (int)left;
      }
    }
    // an odd length's last step has no residual: its output is the average
    if (steps < kChunk && k0 + steps < na) so[2 * steps] = sa[steps];
  }

  // the chunk's outputs from shared memory, by helper thread h of nw warps
  JXL_HD_MEMBER void store(int h, int nw, int l0, int k0,
                           const int* s_out) const {
    const int w = h / kLines, lane = h % kLines;
    const int n_out = min(2 * kChunk, na + nr - 2 * k0);
    if (horizontal) {
      for (int l = w; l < kLines && l0 + l < lines; l += nw)
        for (int j = lane; j < n_out; j += kLines)
          out[(l0 + l) * po.line + 2 * k0 + j] = s_out[l * kOutPitch + j];
    } else if (l0 + lane < lines) {
      for (int j = w; j < n_out; j += nw)
        out[(2 * k0 + j) * po.step + l0 + lane] =
            s_out[lane * kOutPitch + j];
    }
  }
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
