// The per-value arithmetic of the encoder front's kernels (encode.cu) as
// __host__ __device__ functions: the kernels run them on the card, and a CPU
// test builds this header with g++ and holds them to the plain twins
// (vardct/enc_kernels.py, ops/fp.py) bit for bit.
//
// Each operation rounds once, in the twins' order: the card's build has no
// FMA contraction (-fmad=false), the host's none either (-ffp-contract=off);
// IEEE division, square root and round-half-to-even are the defaults of both.

#pragma once

#include <math.h>
#include <stdint.h>
#include <string.h>

#if defined(__CUDACC__)
#define JXL_EHD __host__ __device__ __forceinline__
#define JXL_EHD_MEMBER __host__ __device__ __forceinline__
#define JXL_UNROLL(n) _Pragma(#n)
#else
#define JXL_EHD static inline
#define JXL_EHD_MEMBER inline
#define JXL_UNROLL(n)
#endif

namespace jxl_enc {

// glibc's powf tables (sysdeps/ieee754/flt-32): __powf_log2_data's (invc,
// logc) per subinterval, then __exp2f_data's bits(2^(i/32)) - (i << 47)
#define JXL_LOG2_TAB                                                        \
  {0x1.661ec79f8f3bep+0,  -0x1.efec65b963019p-2, 0x1.571ed4aaf883dp+0,       \
   -0x1.b0b6832d4fca4p-2, 0x1.49539f0f010b0p+0,  -0x1.7418b0a1fb77bp-2,      \
   0x1.3c995b0b80385p+0,  -0x1.39de91a6dcf7bp-2, 0x1.30d190c8864a5p+0,       \
   -0x1.01d9bf3f2b631p-2, 0x1.25e227b0b8ea0p+0,  -0x1.97c1d1b3b7af0p-3,      \
   0x1.1bb4a4a1a343fp+0,  -0x1.2f9e393af3c9fp-3, 0x1.12358f08ae5bap+0,       \
   -0x1.960cbbf788d5cp-4, 0x1.0953f419900a7p+0,  -0x1.a6f9db6475fcep-5,      \
   0x1.0000000000000p+0,  0x0.0p+0,              0x1.e608cfd9a47acp-1,       \
   0x1.338ca9f24f53dp-4,  0x1.ca4b31f026aa0p-1,  0x1.476a9543891bap-3,       \
   0x1.b2036576afce6p-1,  0x1.e840b4ac4e4d2p-3,  0x1.9c2d163a1aa2dp-1,       \
   0x1.40645f0c6651cp-2,  0x1.886e6037841edp-1,  0x1.88e9c2c1b9ff8p-2,       \
   0x1.767dcf5534862p-1,  0x1.ce0a44eb17bccp-2}
#define JXL_EXP2_TAB                                                        \
  {0x3ff0000000000000ull, 0x3fefd9b0d3158574ull, 0x3fefb5586cf9890full,     \
   0x3fef9301d0125b51ull, 0x3fef72b83c7d517bull, 0x3fef54873168b9aaull,     \
   0x3fef387a6e756238ull, 0x3fef1e9df51fdee1ull, 0x3fef06fe0a31b715ull,     \
   0x3feef1a7373aa9cbull, 0x3feedea64c123422ull, 0x3feece086061892dull,     \
   0x3feebfdad5362a27ull, 0x3feeb42b569d4f82ull, 0x3feeab07dd485429ull,     \
   0x3feea47eb03a5585ull, 0x3feea09e667f3bcdull, 0x3fee9f75e8ec5f74ull,     \
   0x3feea11473eb0187ull, 0x3feea589994cce13ull, 0x3feeace5422aa0dbull,     \
   0x3feeb737b0cdc5e5ull, 0x3feec49182a3f090ull, 0x3feed503b23e255dull,     \
   0x3feee89f995ad3adull, 0x3feeff76f2fb5e47ull, 0x3fef199bdd85529cull,     \
   0x3fef3720dcef9069ull, 0x3fef5818dcfba487ull, 0x3fef7c97337b9b5full,     \
   0x3fefa4afa2a490daull, 0x3fefd0765b6e4540ull}

#if defined(__CUDACC__)
__device__ const double kLog2TabD[32] = JXL_LOG2_TAB;
__device__ const unsigned long long kExp2TabD[32] = JXL_EXP2_TAB;
#endif
static const double kLog2TabH[32] = JXL_LOG2_TAB;
static const unsigned long long kExp2TabH[32] = JXL_EXP2_TAB;

// glibc's powf tables where a caller keeps them: the constant arrays above
// (device globals on the card), or a copy in E1's shared memory
struct PowTabs {
  const double* log2;               // (invc, logc) of each subinterval
  const unsigned long long* exp2;   // bits(2^(i/32)) - (i << 47)
};

JXL_EHD PowTabs global_tabs() {
#if defined(__CUDA_ARCH__)
  return PowTabs{kLog2TabD, kExp2TabD};
#else
  return PowTabs{kLog2TabH, kExp2TabH};
#endif
}

JXL_EHD int32_t f2i(float f) {
  int32_t i;
  memcpy(&i, &f, 4);
  return i;
}

JXL_EHD float i2f(int32_t i) {
  float f;
  memcpy(&f, &i, 4);
  return f;
}

JXL_EHD int64_t d2ll(double d) {
  int64_t i;
  memcpy(&i, &d, 8);
  return i;
}

JXL_EHD double ll2d(int64_t i) {
  double d;
  memcpy(&d, &i, 8);
  return d;
}

// x ** y for a positive normal float x, rounded as glibc rounds it (the
// twin's ops/fp.py powf, step for step in float64)
JXL_EHD float powf_glibc(float x, float y, PowTabs t) {
  const double A0 = 0x1.27616c9496e0bp-2, A1 = -0x1.71969a075c67ap-2,
               A2 = 0x1.ec70a6ca7baddp-2, A3 = -0x1.7154748bef6c8p-1,
               A4 = 0x1.71547652ab82bp+0;
  const double C0 = 0x1.c6af84b912394p-5, C1 = 0x1.ebfce50fac4f3p-3,
               C2 = 0x1.62e42ff0c52d6p-1;
  const double SHIFT = 0x1.8p52 / 32;
  const int64_t ix = f2i(x);
  const int64_t tmp = ix - 0x3f330000ll;
  const int i = (int)((tmp >> 19) & 15);
  const int64_t k = tmp >> 23;
  const double z = (double)i2f((int32_t)(ix - k * (1ll << 23)));
  const double r = z * t.log2[2 * i] - 1.0;
  const double y0 = t.log2[2 * i + 1] + (double)k;
  const double r2 = r * r;
  const double p5 = A0 * r + A1;
  const double p3 = A2 * r + A3;
  const double r4 = r2 * r2;
  double q = A4 * r + y0;
  q = p3 * r2 + q;
  const double logx = p5 * r4 + q;
  const double xd = (double)y * logx;
  const double kd = xd + SHIFT;
  const int64_t ki = d2ll(kd) - d2ll(SHIFT);
  const double rr = xd - (kd - SHIFT);
  const double s = ll2d((int64_t)(t.exp2[ki & 31] +
                                  (unsigned long long)ki * (1ull << 47)));
  const double zz = C0 * rr + C1;
  double out = C2 * rr + 1.0;
  out = zz * (rr * rr) + out;
  return (float)(out * s);
}

JXL_EHD float powf_glibc(float x, float y) {
  return powf_glibc(x, y, global_tabs());
}

// fp.fma: the product is exact in float64; the sum rounds there, then to f32
JXL_EHD float fused(float a, float b, float c) {
  return (float)((double)a * (double)b + (double)c);
}

// a sample (0: u8, 1: u16, 2: f32) -> [0, 1], the IEEE division
JXL_EHD float unit_sample(const void* pix, int code, long long i) {
  if (code == 0) return (float)((const uint8_t*)pix)[i] / 255.0f;
  if (code == 1) return (float)((const uint16_t*)pix)[i] / 65535.0f;
  return ((const float*)pix)[i];
}

JXL_EHD float srgb_to_linear(float f, PowTabs t = global_tabs()) {
  return f <= 0.04045f ? f / 12.92f
                       : powf_glibc((f + 0.055f) / 1.055f, 2.4f, t);
}

// jnp.cbrt as glibc's powf(|x|, 1/3) with the sign; 0 stays 0
JXL_EHD float cbrt_glibc(float x, PowTabs t = global_tabs()) {
  if (x == 0.0f) return x;
  const float a = powf_glibc(fabsf(x), (float)(1.0 / 3.0), t);
  return x < 0.0f ? -a : a;
}

// the opsin mix (row-major 3x3 m), cbrt and X, Y, B - Y of one pixel's
// linear samples: fp.contract3, then the twin's steps
JXL_EHD void xyb_of(const float* m, float bias, float cbrt_bias,
                    const float lin[3], float out[3],
                    PowTabs t = global_tabs()) {
  float g[3];
  for (int i = 0; i < 3; ++i) {
    float acc = m[3 * i] * lin[0];
    acc = fused(m[3 * i + 1], lin[1], acc);
    acc = fused(m[3 * i + 2], lin[2], acc);
    g[i] = cbrt_glibc(acc + bias, t) - cbrt_bias;
  }
  const float Y = (g[0] + g[1]) * 0.5f;
  out[0] = (g[0] - g[1]) * 0.5f;
  out[1] = Y;
  out[2] = g[2] - Y;
}

JXL_EHD float pow0(float x, float y) { return x > 0.0f ? powf_glibc(x, y) : 0.0f; }

// the masking field of one block from its activity mean and median
JXL_EHD float mask_of(float mean, float med) {
  const float blk = sqrtf(mean * fminf(mean, 4.0f * med));
  const float m = (1.0f + 4.3f * pow0(blk, 0.68f)) + 52.0f * pow0(blk, 1.6f);
  return fminf(fmaxf(m, 1.0f), 4.0f);
}

// the quantiser (enc_device.py:47-69): qb = 1 - QUANT_BIAS[c], qbn =
// QUANT_BIAS_NUM
struct Bias {
  float qb, qbn;
};

JXL_EHD float adjust(float q, Bias b) {
  const float safe = q == 0.0f ? 1.0f : q;
  return fabsf(q) > 1.0f ? q - b.qbn / safe : q * b.qb;
}

JXL_EHD float quantize(float r, Bias b, float dz) {
  const float q0 = rintf(r);
  float bq = q0, be = fabsf(adjust(q0, b) - r);
  for (int d = -1; d <= 1; d += 2) {
    const float q = q0 + (float)d;
    const float e = fabsf(adjust(q, b) - r);
    if (e < be) {
      bq = q;
      be = e;
    }
  }
  return fabsf(r) < dz ? 0.0f : bq;
}

// the rate proxy of one channel's scan tail from its (last, bits, count)
JXL_EHD float token_cost(int last, float bits, int cnt) {
  if (cnt == 0) return 2.0f;
  return ((2.0f + 1.1f * (float)last) + bits) + (float)cnt;
}

// a * b + c rounded once
JXL_EHD float fma_rn(float a, float b, float c) {
#if defined(__CUDA_ARCH__)
  return __fmaf_rn(a, b, c);
#else
  return fmaf(a, b, c);
#endif
}

// n consecutive floats; on the card as 16-byte loads (p 16-byte aligned)
template <int n>
JXL_EHD void load_run(const float* p, float (&v)[n]) {
#if defined(__CUDA_ARCH__)
  if constexpr (n % 4 == 0) {
    for (int i = 0; i < n; i += 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + i);
      v[i] = q.x;
      v[i + 1] = q.y;
      v[i + 2] = q.z;
      v[i + 3] = q.w;
    }
    return;
  }
#endif
  for (int i = 0; i < n; ++i) v[i] = p[i];
}

// E3's product step, one thread's TM x TN output tile:
//   acc[i][j] = sum over k = 0, 1, ..., K - 1 of a[k * as + i] * b[k * bs + j]
// each term one fused multiply-add from 0.0f, in ascending k, so that an
// output's value is the same whatever tile holds it.  a and b are the
// shared-memory operands laid out so that the TM (TN) values of one k sit
// side by side.
template <int K, int TM, int TN>
JXL_EHD void tile_product(const float* a, int as, const float* b, int bs,
                          float (&acc)[TM][TN]) {
  for (int i = 0; i < TM; ++i)
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;
  JXL_UNROLL(unroll 4)
  for (int k = 0; k < K; ++k) {
    float av[TM], bv[TN];
    load_run<TM>(a + k * as, av);
    load_run<TN>(b + k * bs, bv);
    JXL_UNROLL(unroll)
    for (int i = 0; i < TM; ++i)
      JXL_UNROLL(unroll)
      for (int j = 0; j < TN; ++j) acc[i][j] = fma_rn(av[i], bv[j], acc[i][j]);
  }
}

// E3's quantisation of one scan position (enc_device.py:174-279): f are
// its coefficients (X, Y, B), tab its three dequant steps, inv_qac the
// varblock's 1 / qf, fx / fb its CfL factors.  Y first; X and B quantise
// what the dequantised Y leaves (CfL).  q gets the quantised values, e
// the squared reconstruction errors, both by channel (X, Y, B).
JXL_EHD void quant_position(const float f[3], const float tab[3],
                            float inv_qac, float fx, float fb,
                            const Bias bias[3], float dz, float q[3],
                            float e[3]) {
  const float stepY = tab[1] * inv_qac;
  q[1] = quantize(f[1] / stepY, bias[1], dz);
  const float dqY = adjust(q[1], bias[1]) * stepY;
  const float dY = dqY - f[1];
  e[1] = dY * dY;
  for (int c = 0; c < 3; c += 2) {
    const float cf = c == 0 ? fx : fb;
    const float sub = f[c] - cf * dqY;
    const float step = tab[c] * inv_qac;
    q[c] = quantize(sub / step, bias[c], dz);
    const float rec = adjust(q[c], bias[c]) * step + cf * dqY;
    const float d = rec - f[c];
    e[c] = d * d;
  }
}

// the squared LLF error of covered position j of a cy x cx varblock: the
// varblock's dequantised DC means (dq, a plane with row stride xs_b, from
// block (by0, bx0)) through its cy / cx bases (anY, anX) and the resample
// rs, against tl, the coefficient at that position
JXL_EHD float llf_error(const float* anY, const float* anX, const float* rs,
                        const float* dq, long long xs_b, int by0, int bx0,
                        int cy, int cx, int j, float tl) {
  const int kk = j / cx, ll = j % cx;
  float acc2 = 0.0f;
  for (int xx = 0; xx < cx; ++xx) {
    float acc1 = 0.0f;
    for (int yy = 0; yy < cy; ++yy)
      acc1 = acc1 + anY[kk * cy + yy] * dq[(by0 + yy) * xs_b + bx0 + xx];
    acc2 = acc2 + acc1 * anX[ll * cx + xx];
  }
  const float d = acc2 * rs[kk * cx + ll] - tl;
  return d * d;
}

// ---- E1's strip walk (encode.cu front_planes_kernel) ----------------------
//
// A block of 4 warps walks a strip of kE1Cols frame columns down the frame:
// output rows [y0, y1), kE1Out columns from the strip's start, with
// kE1Side columns of halo on each side and ITERS rows of halo above and
// below (clamped at the frame's edges).  In chunks of kE1Chunk walk rows:
//   xyb: every thread, the XYB of a pixel of the chunk at a time into a
//     shared chunk (two, taken in turn, so one barrier a chunk): each
//     sample once, at 64 / 56 x (rows + 2 ITERS) / rows of the output's
//     pixels (1.29x at 64 rows a strip; strips of 128 rows, 1.21x, ran
//     16% slower on an H100 80GB HBM3);
//   walk: warp c the plane c of the chunk's rows, a lane 2 adjacent
//     columns.  Each of the ITERS steps keeps in registers a window of the
//     three rows of the step before it that it needs (a row with its
//     left and right neighbours, taken by a shuffle from the next lanes);
//     walk row t brings the plane's row t, then step s computes its row
//     t - s from its window and hands the row on to step s + 1.  The
//     frame's edge is the twin's one-sample replicate pad of every step: a
//     lane at column 0 is its own left neighbour, at column pw - 1 its own
//     right one, the frame's row 0 fills a window's upper row too, and a
//     step past the frame's last row hands on its last row again.  The
//     output adds the steps in the twin's order, acc = (((x + e1) + e2) +
//     e3) + e4, each step's sum held for a row until the next step adds.
// A halo lane's values past kE1Side - 1 steps from the strip are junk that
// never reaches an output column.  The host's test runs the same code with
// a warp's 32 lanes as arrays (the lane policy L).

constexpr int kE1Threads = 128;             // 4 warps
constexpr int kE1Cols = 64;                 // a strip's columns, 2 a lane
constexpr int kE1Side = 4;                  // halo columns on each side
constexpr int kE1Out = kE1Cols - 2 * kE1Side;
constexpr int kE1Rows = 64;                 // output rows of a strip
constexpr int kE1Chunk = 8;                 // walk rows an XYB chunk

// the opsin matrix (row-major), the biases, gaborish's weights
struct FrontConsts {
  float m[9];
  float bias, cbrt_bias, w1, w2, norm;
};

struct FrontShared {
  double log2[32];
  unsigned long long exp2[32];
  float lin8[256];                          // a u8 code's linear value
  FrontConsts k;
  float xyb[2][3][kE1Chunk][kE1Cols];       // two chunks of X, Y, B - Y
};

// a block's strip: its first column (the halo's), its output rows and the
// rows its walk takes
struct FrontStrip {
  int x0, y0, y1, a0, t_end;
  bool top;   // the walk starts at the frame's row 0
};

JXL_EHD FrontStrip front_strip(int bx, int by, int ph, int iters) {
  FrontStrip st;
  st.x0 = bx * kE1Out - kE1Side;
  st.y0 = by * kE1Rows;
  st.y1 = st.y0 + kE1Rows < ph ? st.y0 + kE1Rows : ph;
  st.top = st.y0 - iters <= 0;
  st.a0 = st.top ? 0 : st.y0 - iters;
  st.t_end = st.y1 - 1 + iters;
  return st;
}

// the block's tables: glibc's powf tables, the constants, the u8 linear
// values (srgb_to_linear of unit_sample: the same bits as computing them)
JXL_EHD void front_tables(int k, const float* consts, FrontShared& s) {
  const PowTabs g = global_tabs();
  if (k < 32) {
    s.log2[k] = g.log2[k];
    s.exp2[k] = g.exp2[k];
  }
  if (k < 14) (&s.k.m[0])[k] = consts[k];
  for (int v = k; v < 256; v += kE1Threads) {
    const uint8_t c = (uint8_t)v;
    s.lin8[v] = srgb_to_linear(unit_sample(&c, 0, 0), g);
  }
}

// thread k's pixels of the chunk of walk rows from tc: their X, Y, B - Y
// into shared chunk buf (0 outside the frame)
JXL_EHD void front_xyb(int k, const void* pix, int code, int ph, int pw,
                       const FrontStrip& st, int tc, int buf,
                       FrontShared& s) {
  const PowTabs tabs{s.log2, s.exp2};
  JXL_UNROLL(unroll 1)
  for (int e = k; e < kE1Chunk * kE1Cols; e += kE1Threads) {
    const int r = e / kE1Cols, col = e % kE1Cols;
    const int t = tc + r, gx = st.x0 + col;
    float xyb[3] = {0.0f, 0.0f, 0.0f};
    if (t <= ph - 1 && t <= st.t_end && gx >= 0 && gx < pw) {
      const long long base = ((long long)t * pw + gx) * 3;
      float lin[3];
      for (int c = 0; c < 3; ++c)
        lin[c] = code == 0 ? s.lin8[((const uint8_t*)pix)[base + c]]
                           : srgb_to_linear(unit_sample(pix, code, base + c),
                                            tabs);
      xyb_of(s.k.m, s.k.bias, s.k.cbrt_bias, lin, xyb, tabs);
    }
    for (int c = 0; c < 3; ++c) s.xyb[buf][c][r][col] = xyb[c];
  }
}

// The walk of one plane by one warp.  L is the lane policy: L::F a lane's
// float (on the host, the warp's 32), L::B a lane's flag; at flags the
// lanes whose first column is a given one, left / right shift a value by
// one lane (lane 0 / 31 keep their own), pick selects, div is the IEEE
// division, store writes the lanes' two output columns of a row.
template <int ITERS, class L>
struct PlaneWalk {
  using F = typename L::F;
  using B = typename L::B;
  static constexpr int N = ITERS > 0 ? ITERS : 1;
  struct Row {
    F l, a, b, r;   // the lane's two columns and their outer neighbours
  };
  Row w[N][3];      // w[s]: step s + 1's window, rows y - 1, y, y + 1
  F ha[N], hb[N];   // ha[s - 1]: step s's sum at the row step s + 1 takes
  B first, last;    // lanes whose columns start / end the frame's rows

  JXL_EHD_MEMBER void init(int x0, int pw) {
    first = L::at(x0, 0);
    last = L::at(x0, pw - 2);
    const F z(0.0f);
    const Row zr{z, z, z, z};
    for (int s = 0; s < N; ++s) {
      w[s][0] = w[s][1] = w[s][2] = zr;
      ha[s] = hb[s] = z;
    }
  }

  JXL_EHD_MEMBER Row row_of(F a, F b) const {
    Row r;
    r.a = a;
    r.b = b;
    r.l = L::pick(first, a, L::left(b));
    r.r = L::pick(last, b, L::right(a));
    return r;
  }

  // a row into window s; the frame's row 0 fills the upper rows too
  JXL_EHD_MEMBER void push(int s, const Row& x, bool fill) {
    w[s][0] = fill ? x : w[s][1];
    w[s][1] = fill ? x : w[s][2];
    w[s][2] = x;
  }

  // gaborish at the window's middle row: err - gab(err), the twin's order
  JXL_EHD_MEMBER void gab(const Row (&v)[3], const FrontConsts& k, F& ea,
                          F& eb) const {
    const Row &t = v[0], &m = v[1], &d = v[2];
    F s1 = ((t.a + d.a) + m.l) + m.b;
    F s2 = ((t.l + t.b) + d.l) + d.b;
    ea = m.a - L::div((m.a + k.w1 * s1) + k.w2 * s2, k.norm);
    s1 = ((t.b + d.b) + m.a) + m.r;
    s2 = ((t.a + t.r) + d.a) + d.r;
    eb = m.b - L::div((m.b + k.w1 * s1) + k.w2 * s2, k.norm);
  }

  // walk row t: the plane's row t (xa, xb; past the frame, its last row
  // again), then each step's row t - s; the output row to `out` (the
  // plane) when it lies in [y0, y1)
  JXL_EHD_MEMBER void row(int t, F xa, F xb, const FrontStrip& st, int ph,
                          int pw, const FrontConsts& k, float* out) {
    if (ITERS == 0) {
      if (t >= st.y0 && t < st.y1) L::store(out + (long long)t * pw, st.x0, pw, xa, xb);
      return;
    }
    push(0, t <= ph - 1 ? row_of(xa, xb) : w[0][2], t == 0);
    F na[N], nb[N];
    JXL_UNROLL(unroll)
    for (int s = 0; s < N; ++s) {
      na[s] = ha[s];
      nb[s] = hb[s];
    }
    JXL_UNROLL(unroll)
    for (int s = 1; s <= ITERS; ++s) {
      const int y = t - s;
      if (y < (st.top ? 0 : st.a0 + s)) break;
      if (y > ph - 1) {
        if (s < ITERS) push(s, w[s][2], false);
        continue;
      }
      F ea, eb;
      gab(w[s - 1], k, ea, eb);
      const int h = s >= 2 ? s - 2 : 0;
      const F aa = (s == 1 ? w[0][1].a : ha[h]) + ea;
      const F ab = (s == 1 ? w[0][1].b : hb[h]) + eb;
      if (s < ITERS) {
        na[s - 1] = aa;
        nb[s - 1] = ab;
        push(s, row_of(ea, eb), y == 0);
      } else if (y >= st.y0 && y < st.y1) {
        L::store(out + (long long)y * pw, st.x0, pw, aa, ab);
      }
    }
    JXL_UNROLL(unroll)
    for (int s = 0; s < N; ++s) {
      ha[s] = na[s];
      hb[s] = nb[s];
    }
  }
};

}  // namespace jxl_enc
