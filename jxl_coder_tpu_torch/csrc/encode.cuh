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

// the quantiser's constants of E3 / E4
struct QuantConsts {
  Bias bias[3];
  float area_w[3];   // area * D_c, or D_c for the specials
  float dz, igs, lam;
};

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


// ---- E4's batch walk (encode.cu special_costs_kernel) ---------------------
//
// A persistent thread block an SM holds one special transform's matrices
// in shared memory (SpecialMats: A with a zero 64th column, R1 and r0, 97
// KB, read once a block, and the quantiser's tables) and runs kE4Groups
// groups of kE4Threads threads, each with its own batch buffers
// (SpecialBatch) and barrier.  Group h of block g is walker w = kE4Groups
// g + h of W = kE4Groups x blocks; walker w takes the frame's 8x8 blocks
// w, w + W, w + 2W, ... (an even share of the eligible ones wherever they
// cluster), kE4Seg at a time: a round's eligible blocks join the walker's
// ring of pending blocks, its ineligible ones get zero values and cost
// 1e30 there and then (e4_clear, a warp a block).  Each batch of kE4Batch
// pending blocks (at the end, what is left) runs the channels in the
// twin's order, Y, X, B, in phases separated by the group's barrier:
//   e4_slot: a pending block a slot: its index, 1 / qf, CfL factors, DC;
//   e4_input: thread (bg, cg) owns the tile of kE4Slots slots from
//     kE4Slots bg and pixel positions 4 cg .. 4 cg + 3 (a 16-byte row load
//     a slot): tc = pixel - dc * r0 (kept in registers), the product's
//     input (X and B subtract f * recY, Y's reconstruction at the same
//     positions, kept in registers too) into inT, position-major;
//   e4_quant: g = in . A on the same tile of slots x coefficients
//     (tile_product: 16-byte loads, fused multiply-adds, k ascending from
//     0), the quantiser a value, the values into qv, the dequantised
//     values into dqT (coefficient-major), the tile's rate partials
//     (last, bits, count);
//   e4_recon: the batch's values of the channel out, a warp a slot's 63
//     in two coalesced stores; rec = dq . R1 on the tile of slots x
//     positions, the tile's squared errors;
//   e4_reduce: a (slot, quantity) a thread, the 16 column groups'
//     partials in order (the maxima for last);
//   e4_cost: a slot a thread, distortion and rate in the old kernel's
//     order.
// The quantiser is quantize's: the IEEE quotient of the ratio, then, for
// a thread whose ratios all lie inside the tables, QUANT_BIAS_NUM / q of
// the integer candidates from a table of those quotients
// (SpecialMats.qbn_over, made by the same division) and log2(1 + |q|)
// from a table of log2f's values, without a branch; otherwise quantize
// itself.
// inT and dqT rows hold 4 floats of padding: the 16-byte stores of a
// quarter warp then meet 4-way, not 8-way, bank conflicts; the reads
// (a broadcast pair of slots, 16 consecutive columns) meet none.  A
// block's values and cost depend on its own inputs alone, not on the
// batch, slot, walker or thread block that takes it.

constexpr int kE4Threads = 256;            // a group: 8 warps, 16 x 16 tiles
constexpr int kE4Groups = 2;               // groups a thread block
constexpr int kE4Slots = 4;                // slots a thread's tile
constexpr int kE4Batch = 16 * kE4Slots;    // 8x8 blocks a batch
constexpr int kE4Seg = 128;                // 8x8 blocks a round
constexpr int kE4Ring = 256;               // pending blocks (power of 2)
constexpr int kE4Row = kE4Batch + 4;       // inT / dqT row stride
constexpr int kE4Vals = 3 * 63;            // values an 8x8 block
constexpr int kE4Tab = 256;                // the quantiser's table entries
static_assert(kE4Threads == 256 && kE4Slots % 4 == 0, "16 x 16 tiles");
static_assert(kE4Ring >= kE4Batch - 1 + kE4Seg, "a round fits the ring");

struct SpecialArgs {
  const float* planes;        // (3, 8 ys_b, 8 xs_b)
  const int* qf;
  const float *fx, *fb, *dqdc;
  const uint8_t* elig;
  const float *r0, *R1, *A;   // (3, 64), (3, 63, 64), (3, 64, 63)
  int16_t* vals;              // (nb, 3, 63)
  float* cost;
  int ys_b, xs_b;
  QuantConsts k;
};

// what a thread block's groups share
struct alignas(16) SpecialMats {
  float A[3][64][64];           // column 63 zero
  float R1[3][63][64];
  float r0[3][64];
  float qbn_over[kE4Tab];       // QUANT_BIAS_NUM / i
  float log1p2[kE4Tab];         // log2f(1 + i)
};

// a group's batch
struct alignas(16) SpecialBatch {
  float inT[64][kE4Row];        // the channel's inputs: [position][slot]
  float dqT[63][kE4Row];        // dequantised values: [coefficient][slot]
  float part[4][kE4Batch][16];  // err, last, bits, count by column group
  float tot[kE4Batch][12];      // err X Y B ... as the old kernel's v[]
  int16_t qv[kE4Batch][64];     // the channel's values, to be written out
  float inv[kE4Batch], f[3][kE4Batch], dcb[3][kE4Batch];
  int blk[kE4Batch];            // the slot's 8x8 block, -1 past the batch
  int ring[kE4Ring];
  int head, count;
};

// a thread's registers across a batch's phases
struct E4Thread {
  float tc[kE4Slots][4];     // the channel's tc at the tile's slots
  float recY[kE4Slots][4];   // Y's reconstruction there
};

// thread t's tile: slots b0 .. b0 + kE4Slots - 1, columns c0 .. c0 + 3
JXL_EHD void e4_tile(int t, int& b0, int& c0) {
  const int lane = t & 31, warp = t >> 5;
  b0 = kE4Slots * (2 * warp + (lane >> 4));
  c0 = 4 * (lane & 15);
}

// four floats; on the card one 16-byte store (p 16-byte aligned)
JXL_EHD void store4(float* p, float x, float y, float z, float w) {
#if defined(__CUDA_ARCH__)
  *reinterpret_cast<float4*>(p) = make_float4(x, y, z, w);
#else
  p[0] = x;
  p[1] = y;
  p[2] = z;
  p[3] = w;
#endif
}

// a column of a thread's tile, its slots' values, to row[b0 ...]
JXL_EHD void store_slots(float* row, const float (&v)[kE4Slots][4], int jj) {
  JXL_UNROLL(unroll)
  for (int i = 0; i < kE4Slots; i += 4)
    store4(row + i, v[i][jj], v[i + 1][jj], v[i + 2][jj], v[i + 3][jj]);
}

// adjust(q, b) of an integer q with |q| < kE4Tab, QUANT_BIAS_NUM / q
// from the table (qbn / -i is -(qbn / i) exactly); no branch
JXL_EHD float adjust_fast(float q, Bias b, const SpecialMats& m) {
  const float aq = fabsf(q);
  const float d = m.qbn_over[aq < (float)kE4Tab ? (int)aq : 0];
  return aq > 1.0f ? q - (q < 0.0f ? -d : d) : q * b.qb;
}

// quantize(r, b, dz) for |r| < kE4Tab - 2, where every candidate is in the
// table: the same candidates in the same order, the same bits
JXL_EHD float quantize_fast(float r, Bias b, float dz, const SpecialMats& m) {
  const float q0 = rintf(r);
  float bq = q0, be = fabsf(adjust_fast(q0, b, m) - r);
  for (int d = -1; d <= 1; d += 2) {
    const float q = q0 + (float)d;
    const float e = fabsf(adjust_fast(q, b, m) - r);
    bq = e < be ? q : bq;
    be = e < be ? e : be;
  }
  return fabsf(r) < dz ? 0.0f : bq;
}

// the quantiser's tables (qbn: QUANT_BIAS_NUM)
JXL_EHD void e4_tables(int t, int nthreads, float qbn, SpecialMats& m) {
  for (int i = t; i < kE4Tab; i += nthreads) {
    m.qbn_over[i] = i > 1 ? qbn / (float)i : 0.0f;
    m.log1p2[i] = log2f(1.0f + (float)i);
  }
}

JXL_EHD void e4_load(int t, int nthreads, const SpecialArgs& a,
                     SpecialMats& m) {
  for (int i = t; i < 3 * 64 * 64; i += nthreads) {
    const int c = i >> 12, k = (i >> 6) & 63, j = i & 63;
    m.A[c][k][j] = j < 63 ? a.A[(c * 64 + k) * 63 + j] : 0.0f;
  }
  for (int i = t; i < 3 * 63 * 64; i += nthreads)
    (&m.R1[0][0][0])[i] = a.R1[i];
  for (int i = t; i < 3 * 64; i += nthreads) (&m.r0[0][0])[i] = a.r0[i];
  e4_tables(t, nthreads, a.k.bias[0].qbn, m);
}

// walker w's i-th 8x8 block of W walkers
JXL_EHD long long e4_block(int w, int nw, long long i) {
  return w + (long long)nw * i;
}

// round r's ineligible blocks of walker w: zero values and cost 1e30, a
// warp a block, its lanes along the values
JXL_EHD void e4_clear(int t, int w, int nw, int r, const SpecialArgs& a) {
  const long long nb = (long long)a.ys_b * a.xs_b;
  const int warp = t >> 5, lane = t & 31;
  for (int i = warp; i < kE4Seg; i += kE4Threads / 32) {
    const long long n = e4_block(w, nw, (long long)r * kE4Seg + i);
    if (n >= nb) break;
    if (a.elig[n]) continue;
    for (int v = lane; v < kE4Vals; v += 32) a.vals[n * kE4Vals + v] = 0;
    if (lane == 0) a.cost[n] = 1e30f;
  }
}

// the batch's first nbat pending blocks into the slots
JXL_EHD void e4_slot(int t, int nbat, const SpecialArgs& a,
                     SpecialBatch& s) {
  if (t >= kE4Batch) return;
  if (t >= nbat) {   // an empty slot: zero inputs, finite ratios
    s.blk[t] = -1;
    s.inv[t] = 1.0f;
    for (int c = 0; c < 3; ++c) s.f[c][t] = s.dcb[c][t] = 0.0f;
    return;
  }
  const int n = s.ring[(s.head + t) & (kE4Ring - 1)];
  const long long nb = (long long)a.ys_b * a.xs_b;
  s.blk[t] = n;
  s.inv[t] = 1.0f / ((float)a.qf[n] / a.k.igs);
  s.f[0][t] = a.fx[n];
  s.f[1][t] = 0.0f;
  s.f[2][t] = a.fb[n];
  for (int c = 0; c < 3; ++c) s.dcb[c][t] = a.dqdc[c * nb + n];
}

JXL_EHD void e4_input(int t, int c, const SpecialArgs& a,
                      const SpecialMats& m, SpecialBatch& s, E4Thread& st) {
  int b0, p0;
  e4_tile(t, b0, p0);
  const long long pw = 8ll * a.xs_b, plane = 8ll * a.ys_b * pw;
  float in[kE4Slots][4];
  JXL_UNROLL(unroll)
  for (int i = 0; i < kE4Slots; ++i) {
    const int n = s.blk[b0 + i];
    float px[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (n >= 0)
      load_run<4>(a.planes + c * plane +
                      (8ll * (n / a.xs_b) + (p0 >> 3)) * pw +
                      8 * (n % a.xs_b) + (p0 & 7),
                  px);
    JXL_UNROLL(unroll)
    for (int jj = 0; jj < 4; ++jj) {
      const float tc =
          n >= 0 ? px[jj] - s.dcb[c][b0 + i] * m.r0[c][p0 + jj] : 0.0f;
      st.tc[i][jj] = tc;
      in[i][jj] = c == 1 || n < 0
                      ? tc
                      : tc - s.f[c][b0 + i] * st.recY[i][jj];
    }
  }
  JXL_UNROLL(unroll)
  for (int jj = 0; jj < 4; ++jj) store_slots(&s.inT[p0 + jj][b0], in, jj);
}

JXL_EHD void e4_quant(int t, int c, const SpecialArgs& a,
                      const SpecialMats& m, SpecialBatch& s) {
  int b0, j0;
  e4_tile(t, b0, j0);
  float g[kE4Slots][4], dq[kE4Slots][4];
  tile_product<64, kE4Slots, 4>(&s.inT[0][b0], kE4Row, &m.A[c][0][j0], 64,
                                g);
  const Bias bias = a.k.bias[c];
  // the tile's ratios; a thread with one past the tables takes quantize
  float q[kE4Slots][4], lb[kE4Slots][4];
  bool fast = true;
  JXL_UNROLL(unroll)
  for (int i = 0; i < kE4Slots; ++i)
    JXL_UNROLL(unroll)
    for (int jj = 0; jj < 4; ++jj) {
      q[i][jj] = g[i][jj] / s.inv[b0 + i];
      fast = fast && fabsf(q[i][jj]) < (float)(kE4Tab - 2);
    }
  if (fast) {
    JXL_UNROLL(unroll)
    for (int i = 0; i < kE4Slots; ++i)
      JXL_UNROLL(unroll)
      for (int jj = 0; jj < 4; ++jj) {
        q[i][jj] = quantize_fast(q[i][jj], bias, a.k.dz, m);
        dq[i][jj] = adjust_fast(q[i][jj], bias, m) * s.inv[b0 + i];
        lb[i][jj] = m.log1p2[(int)fabsf(q[i][jj])];
      }
  } else {
    JXL_UNROLL(unroll)
    for (int i = 0; i < kE4Slots; ++i)
      JXL_UNROLL(unroll)
      for (int jj = 0; jj < 4; ++jj) {
        q[i][jj] = quantize(q[i][jj], bias, a.k.dz);
        dq[i][jj] = adjust(q[i][jj], bias) * s.inv[b0 + i];
        lb[i][jj] = log2f(1.0f + fabsf(q[i][jj]));
      }
  }
  JXL_UNROLL(unroll)
  for (int i = 0; i < kE4Slots; ++i) {
    const int b = b0 + i, n = s.blk[b];
    float last = 0.0f, bits = 0.0f, cnt = 0.0f;
    JXL_UNROLL(unroll)
    for (int jj = 0; jj < 4; ++jj) {
      const int j = j0 + jj;
      const bool live = n >= 0 && j < 63, nz = live && q[i][jj] != 0.0f;
      s.qv[b][j] = (int16_t)(int)q[i][jj];
      dq[i][jj] = live ? dq[i][jj] : 0.0f;
      last = nz ? (float)(j + 1) : last;
      bits = bits + (nz ? lb[i][jj] : 0.0f);   // + 0 keeps bits' bits
      cnt = cnt + (nz ? 1.0f : 0.0f);
    }
    s.part[1][b][j0 >> 2] = last;
    s.part[2][b][j0 >> 2] = bits;
    s.part[3][b][j0 >> 2] = cnt;
  }
  JXL_UNROLL(unroll)
  for (int jj = 0; jj < 4; ++jj)
    if (j0 + jj < 63) store_slots(&s.dqT[j0 + jj][b0], dq, jj);
}

JXL_EHD void e4_recon(int t, int c, const SpecialArgs& a,
                      const SpecialMats& m, SpecialBatch& s, E4Thread& st) {
  const int lane = t & 31;
  for (int b = t >> 5; b < kE4Batch; b += kE4Threads / 32) {
    const int n = s.blk[b];
    if (n < 0) break;
    int16_t* out = a.vals + (long long)n * kE4Vals + c * 63;
    out[lane] = s.qv[b][lane];
    if (lane < 31) out[32 + lane] = s.qv[b][32 + lane];
  }
  int b0, p0;
  e4_tile(t, b0, p0);
  float rec[kE4Slots][4];
  tile_product<63, kE4Slots, 4>(&s.dqT[0][b0], kE4Row, &m.R1[c][0][p0], 64,
                                rec);
  JXL_UNROLL(unroll)
  for (int i = 0; i < kE4Slots; ++i) {
    float err = 0.0f;
    JXL_UNROLL(unroll)
    for (int jj = 0; jj < 4; ++jj) {
      float r = rec[i][jj];
      if (c == 1)
        st.recY[i][jj] = r;
      else
        r = r + s.f[c][b0 + i] * st.recY[i][jj];
      const float d = r - st.tc[i][jj];
      err = err + d * d;
    }
    s.part[0][b0 + i][p0 >> 2] = err;
  }
}

// channel c's partials: quantity u % 4 of slot u / 4 for u = t, t +
// kE4Threads, ...
JXL_EHD void e4_reduce(int t, int c, SpecialBatch& s) {
  for (int u = t; u < 4 * kE4Batch; u += kE4Threads) {
    const int b = u >> 2, q = u & 3;
    float v = s.part[q][b][0];
    for (int g = 1; g < 16; ++g)
      v = q == 1 ? fmaxf(v, s.part[q][b][g]) : v + s.part[q][b][g];
    s.tot[b][q == 0 ? (c == 1 ? 0 : (c == 0 ? 1 : 2)) : 3 * c + q + 2] = v;
  }
}

JXL_EHD void e4_cost(int t, int nbat, const SpecialArgs& a,
                     const SpecialBatch& s) {
  if (t >= nbat) return;
  const float* r = s.tot[t];
  float dist = a.k.area_w[1] * r[0];
  dist = dist + a.k.area_w[0] * r[1];
  dist = dist + a.k.area_w[2] * r[2];
  float rate = 0.0f;
  for (int c = 0; c < 3; ++c)
    rate = rate + token_cost((int)r[3 + 3 * c], r[4 + 3 * c],
                             (int)r[5 + 3 * c]);
  a.cost[s.blk[t]] = rate + a.k.lam * dist;
}

// ---------------------------------------------------------------------------
// The winners' gather G (encode.cu gather_kernel): every source's selected
// rows back to back in one flat int16 output, a row index past a source
// clipped to it (jnp.take's mode="clip").
//
// One flat walk over the output: a thread owns one 16-byte output vector
// (8 elements; a warp's stores are 512 contiguous bytes) and stores it
// whole (the output starts on a 16-byte boundary; the final partial vector
// element by element).  A vector is one or more segments, each a run of
// one source row: the element's source (the prefix of output elements in
// the plan), its row and column, the row's clipped index.  Rows are only
// 2-byte aligned (3 x 63 int16 is 378 bytes), so a segment is read as the
// one or two aligned 16-byte chunks that hold it and shifted into place
// (gather_window): two loads for a vector inside a row, which neighbouring
// threads share through L1, and no load of a chunk that holds none of its
// bytes.  The first two segments' index and chunk loads are in flight
// before any is used; a third and later (rows shorter than a vector)
// take a loop.

constexpr int kGatherMax = 16;       // sources a launch
constexpr int kGatherThreads = 256;  // a block, a 16-byte vector a thread

// the launch's parameters; host-side from the wrapper's descriptors
struct GatherPlan {
  const int16_t* src[kGatherMax];   // (rows in the source, row_len)
  const int32_t* idx[kGatherMax];   // the selected rows, one per output row
  uint32_t row_len[kGatherMax];     // elements a row
  uint32_t last[kGatherMax];        // rows in the source - 1
  uint32_t pre[kGatherMax];         // output elements before the source
  uint32_t total;                   // output elements
  int n;                            // sources
};

// desc: per source (src, idx, rows, row length, rows in the source, output
// offset) int64, as the wrapper lays it out.  -1 where the walk cannot
// take it: no source or more than kGatherMax, an output offset that is not
// the sources' prefix, an output of 2^31 elements or more, or rows taken
// from a source without rows.
JXL_EHD int gather_plan(const long long* desc, int n, GatherPlan& p) {
  if (n < 1 || n > kGatherMax) return -1;
  long long off = 0;
  for (int k = 0; k < kGatherMax; ++k) {
    const long long* d = desc + 6 * (k < n ? k : 0);
    const long long rows = k < n ? d[2] : 0;
    if (rows < 0 || d[3] < 0 || (k < n && d[5] != off)) return -1;
    if (rows > 0 && d[4] < 1) return -1;
    p.src[k] = (const int16_t*)(uintptr_t)d[0];
    p.idx[k] = (const int32_t*)(uintptr_t)d[1];
    p.row_len[k] = (uint32_t)d[3];
    p.last[k] = rows > 0 ? (uint32_t)(d[4] - 1) : 0u;
    p.pre[k] = (uint32_t)off;
    off += rows * d[3];
    if (off >= (1ll << 31)) return -1;
  }
  p.total = (uint32_t)off;
  p.n = n;
  return 0;
}

// the grid: blocks of kGatherThreads threads, a vector a thread
JXL_EHD uint32_t gather_blocks(const GatherPlan& p) {
  const uint32_t vecs = (p.total + 7) / 8;
  return (vecs + kGatherThreads - 1) / kGatherThreads;
}

// one segment: output elements [lo, hi) of a vector from the source
// elements at `first` on
struct GatherSeg {
  uintptr_t chunk;   // the 16-byte chunk where the window starts
  uint32_t shift;    // bytes into it
  uint32_t lo, hi;
  bool c0, c1;       // chunk / chunk + 16 hold bytes of the segment
};

// the segment that starts at output element e, position pos of its
// vector, and ends at the vector's end `end` or its row's
JXL_EHD GatherSeg gather_seg(const GatherPlan& p, uint32_t e, uint32_t pos,
                             uint32_t end) {
  int k = 0;
  for (int j = 1; j < kGatherMax; ++j) k += j < p.n && p.pre[j] <= e;
  const uint32_t len = p.row_len[k];
  const uint32_t local = e - p.pre[k];
  const uint32_t row = local / len;
  const uint32_t col = local - row * len;
  const int32_t i = p.idx[k][row];
  const uint32_t r = i < 0 ? 0u : ((uint32_t)i > p.last[k] ? p.last[k]
                                                            : (uint32_t)i);
  const uint32_t n = (end - e < len - col) ? end - e : len - col;
  const uintptr_t first = (uintptr_t)(p.src[k] + (size_t)r * len + col);
  // the window's start: the bytes of output element 0 of the vector
  const uintptr_t win = first - 2 * pos;
  GatherSeg s;
  s.chunk = win & ~(uintptr_t)15;
  s.shift = (uint32_t)(win - s.chunk);
  s.lo = pos;
  s.hi = pos + n;
  s.c0 = s.chunk + 16 > first;
  s.c1 = s.chunk + 16 < first + 2 * n;
  return s;
}

#if !defined(JXL_GATHER_LOAD16)
#if defined(__CUDA_ARCH__)
#define JXL_GATHER_LOAD16(dst, addr)                                     \
  do {                                                                   \
    const uint4 v_ = __ldg(reinterpret_cast<const uint4*>(addr));        \
    (dst)[0] = v_.x;                                                     \
    (dst)[1] = v_.y;                                                     \
    (dst)[2] = v_.z;                                                     \
    (dst)[3] = v_.w;                                                     \
  } while (0)
#else
#define JXL_GATHER_LOAD16(dst, addr) memcpy((dst), (const void*)(addr), 16)
#endif
#endif

// the segment's chunks: c[0..3] and c[4..7], zero where not loaded
JXL_EHD void gather_load(const GatherSeg& s, uint32_t (&c)[8]) {
  for (int i = 0; i < 8; ++i) c[i] = 0;
  if (s.c0) JXL_GATHER_LOAD16(c, s.chunk);
  if (s.c1) JXL_GATHER_LOAD16(c + 4, s.chunk + 16);
}

JXL_EHD uint32_t funnel16(uint32_t lo, uint32_t hi) {
#if defined(__CUDA_ARCH__)
  return __funnelshift_r(lo, hi, 16);
#else
  return (uint32_t)((((uint64_t)hi << 32) | lo) >> 16);
#endif
}

// the 16 bytes at `shift` (even) of the chunks c, merged into the output
// words w where the segment's elements [lo, hi) fall
JXL_EHD void gather_window(const GatherSeg& s, const uint32_t (&c)[8],
                           uint32_t (&w)[4]) {
  const uint32_t q = s.shift >> 2;
  uint32_t d[5];
  JXL_UNROLL(unroll)
  for (int i = 0; i < 5; ++i) {
    const uint32_t a = q & 2 ? c[i + 2] : c[i];
    const uint32_t b = q & 2 ? c[i + 3] : c[i + 1];
    d[i] = q & 1 ? b : a;
  }
  JXL_UNROLL(unroll)
  for (int i = 0; i < 4; ++i) {
    const uint32_t v = s.shift & 2 ? funnel16(d[i], d[i + 1]) : d[i];
    const uint32_t e0 = 2 * i, e1 = 2 * i + 1;
    const uint32_t m = (e0 >= s.lo && e0 < s.hi ? 0xffffu : 0u) |
                       (e1 >= s.lo && e1 < s.hi ? 0xffff0000u : 0u);
    w[i] = (w[i] & ~m) | (v & m);
  }
}

// output vector v (elements 8 v ... up to the total)
JXL_EHD void gather_vector(const GatherPlan& p, uint32_t v, int16_t* out) {
  const uint32_t e = v * 8;
  if (e >= p.total) return;
  const uint32_t end = p.total - e < 8 ? p.total : e + 8;
  // the first two segments' index and chunk loads before any is used
  const GatherSeg a = gather_seg(p, e, 0, end);
  const bool two = e + a.hi < end;
  GatherSeg b = a;
  if (two) b = gather_seg(p, e + a.hi, a.hi, end);
  uint32_t ca[8], cb[8];
  gather_load(a, ca);
  if (two) gather_load(b, cb);
  uint32_t w[4] = {0, 0, 0, 0};
  gather_window(a, ca, w);
  if (two) {
    gather_window(b, cb, w);
    // rows shorter than what is left of the vector
    for (uint32_t pos = b.hi; e + pos < end;) {
      const GatherSeg s = gather_seg(p, e + pos, pos, end);
      uint32_t c[8];
      gather_load(s, c);
      gather_window(s, c, w);
      pos = s.hi;
    }
  }
  int16_t* dst = out + e;
  if (end - e == 8) {
#if defined(__CUDA_ARCH__)
    *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
#else
    memcpy(dst, w, 16);
#endif
  } else {
    // the output's last, partial vector (fixed indices: w stays in
    // registers)
    JXL_UNROLL(unroll)
    for (uint32_t i = 0; i < 8; ++i)
      if (i < end - e) dst[i] = (int16_t)(w[i >> 1] >> (16 * (i & 1)));
  }
}

}  // namespace jxl_enc
