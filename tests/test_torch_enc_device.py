"""The encoder front's device layer on the CPU (the twins of kernels E1-E4
and of the winners' gather, ``vardct/enc_kernels.py``, driven through
``vardct/enc_device.Front``) against the JAX package's jitted front end
(``jxl_coder_tpu/vardct/enc_device.py``), on the same seeded inputs.

Tolerances: E1's planes within 1e-6 (float32 planes of magnitude < 1; the
twin rounds glibc's powf as XLA's CPU backend does, but XLA may fuse the
gaborish sums); E2's coefficients within 2e-6 of their largest magnitude,
the masking field (values in [1, 4]) within 1e-4 (the JAX function's own
field moves by 2.1e-5 between a fresh XLA compile and an executable loaded
from the persistent compile cache: its powers of the block activity), the
DC slice within 1e-6 and ytox / ytob equal; E3 / E4's quantised values equal except at ties (a value whose
quantiser decision changes when its ratio moves by 1e-5 relative) and
costs within 1e-5 relative; the gather equal.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jxl_coder_tpu.vardct import enc_device as JD
from jxl_coder_tpu.vardct import enc_real as JR
from jxl_coder_tpu_torch.host.vardct import enc_real as PR
from jxl_coder_tpu_torch.host.vardct import selected as SEL
from jxl_coder_tpu_torch.vardct import enc_kernels as EK
from jxl_coder_tpu_torch.vardct.enc_device import Front

# a ragged frame (17 x 25 blocks: partial 64-px tiles) and one narrower
# than a tile (5 x 7 blocks)
SIZES = [(136, 200), (40, 56)]


def _image(h, w, seed=4):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([120 + 80 * np.sin(yy / 29) + 20 * np.cos(xx / 13),
                    110 + 70 * np.sin((xx + yy) / 43),
                    100 + 60 * np.cos(yy / 17)], -1)
    img += rng.normal(0, 9, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def _unit(pad):
    if pad.dtype == np.uint8:
        return pad.astype(np.float32) / np.float32(255.0)
    if pad.dtype == np.uint16:
        return pad.astype(np.float32) / np.float32(65535.0)
    return pad.astype(np.float32)


_CACHE = {}


def _jax_stage(h, w):
    """The JAX front and costs of one size (every candidate shape, every
    special transform on a seeded eligibility mask), once per process."""
    if (h, w) in _CACHE:
        return _CACHE[(h, w)]
    pad = _image(h, w)
    planes, co, mask, ytox, ytob, co_dc = JD.run_front(_unit(pad), 4)
    ys_b, xs_b = h // 8, w // 8
    rng = np.random.default_rng(1)
    inputs = dict(
        qf_map=rng.integers(3, 12, (ys_b, xs_b)).astype(np.int32),
        fx_blk=rng.normal(0, 0.1, (ys_b, xs_b)),
        fb_blk=rng.normal(0, 0.1, (ys_b, xs_b)),
        dq_dc=co_dc.copy(), igs=65536 / 6000, lam=0.05,
        cands=JR._EFFORT_CANDS["full"], deadzone=JR.AC_DEADZONE,
        specials=JR._SPECIAL_CANDS,
        special_eligible=rng.random((ys_b, xs_b)) < 0.5)
    pending = JD.run_costs_dispatch(planes, co, **inputs)
    cost8, cost_data, vals_list, meta = JD.run_costs_fetch(pending)
    out = dict(pad=pad, planes=np.asarray(planes), co=np.asarray(co),
               front=(mask, ytox, ytob, co_dc), inputs=inputs,
               costs=(cost8, cost_data, [np.asarray(v) for v in vals_list],
                      meta), vals_dev=vals_list)
    _CACHE[(h, w)] = out
    return out


# --------------------------------------------------------------------------
# The pieces of E1 / E2 against jnp

def test_gradient_is_jnp_gradient():
    a = np.random.default_rng(0).normal(size=(9, 11)).astype(np.float32)
    gy, gx = jnp.gradient(jnp.asarray(a))
    t = torch.from_numpy(a)
    assert np.array_equal(EK._gradient(t, 0).numpy(), np.asarray(gy))
    assert np.array_equal(EK._gradient(t, 1).numpy(), np.asarray(gx))


def test_median_of_64_is_jnp_median():
    rng = np.random.default_rng(1)
    a = rng.random((50, 64)).astype(np.float32)
    a[:10, :40] = 0.25                 # ties across the middle ranks
    srt = torch.from_numpy(a).sort(-1).values
    ours = (srt[:, 31] * 0.5 + srt[:, 32] * 0.5).numpy()
    assert np.array_equal(ours, np.asarray(jnp.median(jnp.asarray(a), -1)))


def test_powers_of_zero_and_cbrt_signs():
    x = torch.tensor([0.0, 1e-3, 0.5, 2.0])
    assert EK._pow0(x, 0.68)[0] == 0
    assert np.allclose(EK._pow0(x, 1.6).numpy(), x.numpy() ** 1.6,
                       rtol=1e-6)
    c = EK._cbrt(torch.tensor([-8.0, 0.0, 27.0]))
    assert c.tolist() == [-2.0, 0.0, 3.0]


# --------------------------------------------------------------------------
# E1 + E2 against run_front

@pytest.mark.parametrize("h,w", SIZES)
def test_front_equals_the_jax_front(h, w):
    st = _jax_stage(h, w)
    front = Front("cpu")
    planes, co, mask, ytox, ytob, co_dc = front.run_front_fetch(
        front.run_front_dispatch(st["pad"], 4))
    jmask, jx, jb, jdc = st["front"]
    assert np.abs(planes.numpy() - st["planes"]).max() <= 1e-6
    assert np.abs(co.numpy() - st["co"]).max() <= \
        2e-6 * np.abs(st["co"]).max()
    assert np.abs(mask - jmask).max() <= 1e-4
    assert np.array_equal(ytox, jx) and np.array_equal(ytob, jb)
    assert np.abs(co_dc - jdc).max() <= 1e-6


@pytest.mark.parametrize("dtype,gab", [(np.uint16, 4), (np.float32, 0)])
def test_front_takes_u16_and_float_samples(dtype, gab):
    pad = _image(40, 56, seed=9).astype(np.float32) / 255.0
    pad = (pad * 65535).astype(np.uint16) if dtype == np.uint16 else pad
    jp, jco, jmask, jx, jb, jdc = JD.run_front(_unit(pad), gab)
    front = Front("cpu")
    planes, co, mask, ytox, ytob, co_dc = front.run_front_fetch(
        front.run_front_dispatch(pad, gab))
    assert np.abs(planes.numpy() - np.asarray(jp)).max() <= 1e-6
    assert np.abs(mask - jmask).max() <= 1e-4
    assert np.array_equal(ytox, jx) and np.array_equal(ytob, jb)


# --------------------------------------------------------------------------
# E3 + E4 against run_costs

@pytest.mark.parametrize("h,w", SIZES)
def test_costs_equal_the_jax_costs(h, w):
    st = _jax_stage(h, w)
    jc8, jcd, jvals, jmeta = st["costs"]
    front = Front("cpu")
    pending = front.run_costs_dispatch(
        torch.from_numpy(st["planes"].copy()),
        torch.from_numpy(st["co"].copy()), **st["inputs"])
    c8, cd, vals, meta = front.run_costs_fetch(pending)
    assert meta == jmeta
    assert np.allclose(c8, jc8, rtol=1e-5, atol=0)
    assert np.array_equal(vals[0].numpy(), jvals[0])
    elig = st["inputs"]["special_eligible"]
    for k, (sid, cy, cx, nyc, nxc, cov) in enumerate(meta):
        ours, ref = vals[k + 1].numpy(), jvals[k + 1]
        diff = ours != ref
        if sid in JR._SPECIAL_CANDS:
            diff &= elig[:, :, None, None]     # values only where eligible
        assert diff.mean() <= 1e-4, (sid, diff.mean())
        rows = ~diff.reshape(nyc * nxc, -1).any(-1)
        cost, jcost = cd[sid][0].ravel(), jcd[sid][0].ravel()
        assert np.array_equal(cost >= 1e29, jcost >= 1e29)
        fin = rows & (jcost < 1e29)
        assert np.allclose(cost[fin], jcost[fin], rtol=1e-5, atol=0), sid
        assert np.array_equal(cd[sid][1], jcd[sid][1])


def test_tie_rule_finds_the_quantiser_boundaries():
    dz = float(np.float32(PR.AC_DEADZONE))
    r = torch.tensor([[dz, 3.0, 0.2, -5.0]] * 3)
    t = EK.ties(r, PR.AC_DEADZONE)
    # at the deadzone the decision moves; away from every boundary it holds
    assert t[:, 0].all() and not t[:, 2].any()
    v, ratios = EK.dct_costs_plain(
        torch.zeros((3, 1, 1, 8, 8)), torch.ones((1, 1), dtype=torch.int32),
        torch.zeros((1, 1)), torch.zeros((1, 1)), torch.zeros((3, 1, 1)),
        1.0, 1.0, 0, 1, 1, PR.AC_DEADZONE, torch.zeros(1),
        return_ratios=True)
    assert ratios.shape == v.shape == (1, 1, 3, 63)


def test_the_tie_check_catches_a_fault_in_y():
    """The card check's rule (EK.tie_faults) on the twins' own values: a
    varblock whose Y values are one off is a fault, and so is a Y value off
    a tie beside a Y flip at a tie; X / B values beside a Y flip at a tie
    are excused (at its coefficient; for E4 anywhere in the block)."""
    dz = PR.AC_DEADZONE
    g = torch.Generator().manual_seed(5)
    planes = torch.rand((3, 32, 48), generator=g) - 0.5
    qf = torch.full((4, 6), 6, dtype=torch.int32)
    fx, fb = (0.1 * (torch.rand((4, 6), generator=g) - 0.5)
              for _ in range(2))
    sid, cy, cx = next(c for c in PR._EFFORT_CANDS["full"]
                       if c[1:] == (2, 2))
    vals, ratios = EK.dct_costs_plain(
        planes, qf, fx, fb, torch.zeros((3, 4, 6)), 0.5, 1.0, sid, cy, cx,
        dz, torch.empty(6), return_ratios=True)
    spec, sratios = EK.special_costs_plain(
        planes, qf, fx, fb, torch.zeros((3, 4, 6)), 0.5, 1.0,
        torch.ones((4, 6), dtype=torch.bool), PR._SPECIAL_CANDS[0], dz,
        torch.empty(24), return_ratios=True)
    for v, r, block_dep in ((vals, ratios, False), (spec, sratios, True)):
        assert not EK.tie_faults(v != v, r, dz, block_dep).any()
        got = v.clone()
        got[1, 2, 1] += 1                 # one varblock's Y, all of it
        bad = EK.tie_faults(got != v, r, dz, block_dep)
        assert int(bad.sum()) == int((~EK.ties(r, dz)[1, 2, 1]).sum()) > 0
        assert bad[1, 2, 1].sum() == bad.sum()
    # synthetic ratios: 3.3 is no tie, the deadzone is one
    r = torch.full((2, 2, 3, 5), 3.3)
    assert not EK.ties(r, dz).any()
    r[0, 0, 1, 2] = float(np.float32(dz))
    diff = torch.zeros(r.shape, dtype=torch.bool)
    diff[0, 0, :, 2] = True               # Y flips at a tie, X / B beside it
    assert not EK.tie_faults(diff, r, dz).any()
    diff[0, 0, 0, 4] = True               # X elsewhere in the block
    assert EK.tie_faults(diff, r, dz).nonzero().tolist() == [[0, 0, 0, 4]]
    assert not EK.tie_faults(diff, r, dz, block_dep=True).any()
    diff[0, 0, 1, 4] = True               # Y off a tie, in the same block
    assert EK.tie_faults(diff, r, dz, block_dep=True).nonzero().tolist() == \
        [[0, 0, 1, 4]]


# --------------------------------------------------------------------------
# The winners' gather against fetch_selected

def test_gather_equals_fetch_selected():
    st = _jax_stage(*SIZES[0])
    jc8, jcd, _, jmeta = st["costs"]
    inputs = st["inputs"]
    full = list(inputs["cands"]) + [(s, 1, 1) for s in inputs["specials"]]
    acs_map, _ = JR._greedy_decide(full, jcd, jc8, inputs["qf_map"],
                                   *inputs["qf_map"].shape)
    ref = JD.fetch_selected(st["vals_dev"], jmeta, acs_map)
    vals = [torch.from_numpy(v.copy()) for v in st["costs"][2]]
    front = Front("cpu")
    ours = front.fetch_selected_fetch(front.fetch_selected_dispatch(
        vals, jmeta, acs_map))
    assert isinstance(ours, SEL.SelectedFlat)
    for name in ("bys", "bxs", "sids", "sizes", "offs", "vals"):
        assert np.array_equal(getattr(ours, name), getattr(ref, name)), name
    assert len(set(ours.sids.tolist())) > 2     # several sources gathered
    # a group's window keeps its anchors, relative, with their values
    win = ours.window(8, 8, 8, 16)
    inside = ((ours.bys >= 8) & (ours.bys < 16) & (ours.bxs >= 8)
              & (ours.bxs < 24))
    assert np.array_equal(win.bys, ours.bys[inside] - 8)
    assert np.array_equal(win.bxs, ours.bxs[inside] - 8)
    assert np.array_equal(win.vals, np.concatenate(
        [ours.vals[ours.offs[i]:ours.offs[i + 1]]
         for i in np.nonzero(inside)[0]]))


def test_gather_rows_clips_like_jnp_take():
    src = torch.arange(2 * 3 * 3 * 4, dtype=torch.int16).reshape(2, 3, 3, 4)
    out = EK.gather_rows([src], [torch.tensor([5, 9, -2],
                                              dtype=torch.int32)])
    rows = src.reshape(6, 12)
    assert torch.equal(out, torch.cat([rows[5], rows[5], rows[0]]))


# --------------------------------------------------------------------------
# The wrappers' checks and the device rule

def test_wrappers_reject_what_the_kernels_do_not_take():
    with pytest.raises(ValueError):
        EK.front_planes(torch.zeros((12, 16, 3), dtype=torch.uint8))
    with pytest.raises(ValueError):
        EK.front_planes(torch.zeros((8, 8, 3), dtype=torch.float64))
    with pytest.raises(ValueError):
        EK.front_blocks(torch.zeros((3, 8, 12)))
    qf = torch.ones((2, 2), dtype=torch.int32)
    f = torch.zeros((2, 2))
    with pytest.raises(ValueError):      # a 32x32 shape does not fit
        EK.dct_costs(torch.zeros((3, 16, 16)), qf, f, f,
                     torch.zeros((3, 2, 2)), 1.0, 1.0, 5, 4, 4, 0.58,
                     torch.zeros(1))
    with pytest.raises(ValueError):      # DCT8 is not a special
        EK.special_costs(torch.zeros((3, 16, 16)), qf, f, f,
                         torch.zeros((3, 2, 2)), 1.0, 1.0,
                         torch.ones((2, 2), dtype=torch.bool), 0, 0.58,
                         torch.zeros(4))


@pytest.mark.parametrize("offset", [1, 2, 3])
def test_unaligned_views_are_refused_before_a_launch(offset):
    """E3's, E4's and A9's wrappers refuse a source that does not start
    on a 16-byte boundary (their kernels read it in 16-byte loads) with
    _build.check_aligned, before any launch; a view 16 bytes in passes."""
    from jxl_coder_tpu_torch import _build
    base = torch.zeros(64)
    assert base.data_ptr() % 16 == 0
    _build.check_aligned(base[4:], "planes")
    with pytest.raises(ValueError, match="16-byte aligned"):
        _build.check_aligned(base[offset:], "planes")
    with pytest.raises(ValueError, match="boxes"):
        _build.check_aligned(torch.zeros(68, dtype=torch.int32)[
            offset:offset + 64].view(16, 4), "boxes")


def test_a_cuda_front_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        Front("cuda")


# --------------------------------------------------------------------------
# csrc/encode.cuh, the kernels' per-value arithmetic, built with g++

_ENC_RUN = r"""
#include <algorithm>
#include <vector>
#include "encode.cuh"
using namespace jxl_enc;
static const float *g_aHT, *g_aWT;   // E3's bases, transposed

// E1's lanes on the host: a warp's 32 lanes as arrays, the shuffles as
// shifts (lane 0 / 31 keep their own value, as __shfl_up / down_sync)
struct Lanes32 {
  float v[32];
  Lanes32() = default;
  explicit Lanes32(float x) { for (float& e : v) e = x; }
};
static Lanes32 operator+(const Lanes32& a, const Lanes32& b) {
  Lanes32 r;
  for (int l = 0; l < 32; ++l) r.v[l] = a.v[l] + b.v[l];
  return r;
}
static Lanes32 operator-(const Lanes32& a, const Lanes32& b) {
  Lanes32 r;
  for (int l = 0; l < 32; ++l) r.v[l] = a.v[l] - b.v[l];
  return r;
}
static Lanes32 operator*(float a, const Lanes32& b) {
  Lanes32 r;
  for (int l = 0; l < 32; ++l) r.v[l] = a * b.v[l];
  return r;
}
struct Mask32 {
  bool v[32];
};
struct HostLanes {
  using F = Lanes32;
  using B = Mask32;
  static B at(int x0, int col) {
    B m;
    for (int l = 0; l < 32; ++l) m.v[l] = x0 + 2 * l == col;
    return m;
  }
  static F left(const F& x) {
    F r = x;
    for (int l = 1; l < 32; ++l) r.v[l] = x.v[l - 1];
    return r;
  }
  static F right(const F& x) {
    F r = x;
    for (int l = 0; l < 31; ++l) r.v[l] = x.v[l + 1];
    return r;
  }
  static F pick(const B& c, const F& a, const F& b) {
    F r;
    for (int l = 0; l < 32; ++l) r.v[l] = c.v[l] ? a.v[l] : b.v[l];
    return r;
  }
  static F div(const F& a, float b) {
    F r;
    for (int l = 0; l < 32; ++l) r.v[l] = a.v[l] / b;
    return r;
  }
  static void store(float* row, int x0, int pw, const F& a, const F& b) {
    for (int l = kE1Side / 2; l < 32 - kE1Side / 2; ++l) {
      const int col = x0 + 2 * l;
      if (col < pw) {
        row[col] = a.v[l];
        row[col + 1] = b.v[l];
      }
    }
  }
};
// E1 (encode.cu front_planes_kernel) block after block: the tables and
// each chunk's XYB over the block's threads one after another, then the
// three warps' walks of the chunk's rows, a warp's lanes as arrays
template <int ITERS>
static void front_walk(const void* pix, int code, float* out, int ph, int pw,
                       const float* consts) {
  std::vector<FrontShared> sv(1);
  FrontShared& s = sv[0];
  for (int by = 0; by < (ph + kE1Rows - 1) / kE1Rows; ++by)
    for (int bx = 0; bx < (pw + kE1Out - 1) / kE1Out; ++bx) {
      for (int k = 0; k < kE1Threads; ++k) front_tables(k, consts, s);
      const FrontStrip st = front_strip(bx, by, ph, ITERS);
      PlaneWalk<ITERS, HostLanes> walks[3];
      for (auto& w : walks) w.init(st.x0, pw);
      int buf = 0;
      for (int tc = st.a0; tc <= st.t_end; tc += kE1Chunk, buf ^= 1) {
        for (int k = 0; k < kE1Threads; ++k)
          front_xyb(k, pix, code, ph, pw, st, tc, buf, s);
        for (int c = 0; c < 3; ++c)
          for (int r = 0; r < kE1Chunk && tc + r <= st.t_end; ++r) {
            Lanes32 a, b;
            for (int l = 0; l < 32; ++l) {
              a.v[l] = s.xyb[buf][c][r][2 * l];
              b.v[l] = s.xyb[buf][c][r][2 * l + 1];
            }
            walks[c].row(tc + r, a, b, st, ph, pw, s.k,
                         out + (long long)c * ph * pw);
          }
      }
    }
}
extern "C" int enc_front_walk(const void* pix, int code, float* out, int ph,
                              int pw, int iters, const float* consts) {
  switch (iters) {
    case 0: front_walk<0>(pix, code, out, ph, pw, consts); return 0;
    case 1: front_walk<1>(pix, code, out, ph, pw, consts); return 0;
    case 2: front_walk<2>(pix, code, out, ph, pw, consts); return 0;
    case 3: front_walk<3>(pix, code, out, ph, pw, consts); return 0;
    case 4: front_walk<4>(pix, code, out, ph, pw, consts); return 0;
  }
  return 1;
}
extern "C" void enc_powf(const float* x, int n, float y, float* out) {
  for (int i = 0; i < n; ++i) out[i] = powf_glibc(x[i], y);
}
extern "C" void enc_xyb(const uint8_t* pix, int n, const float* k,
                        float* out) {
  for (int i = 0; i < n; ++i) {
    float lin[3];
    for (int c = 0; c < 3; ++c)
      lin[c] = srgb_to_linear(unit_sample(pix, 0, 3ll * i + c));
    xyb_of(k, k[9], k[10], lin, out + 3 * i);
  }
}
extern "C" void enc_mask(const float* mean, const float* med, int n,
                         float* out) {
  for (int i = 0; i < n; ++i) out[i] = mask_of(mean[i], med[i]);
}
extern "C" void enc_quantize(const float* r, int n, float qb, float qbn,
                             float dz, float* out) {
  for (int i = 0; i < n; ++i) out[i] = quantize(r[i], Bias{qb, qbn}, dz);
}

// E3 (encode.cu dct_costs_kernel) one varblock after another: the region's
// two passes through tile_product in 4 x 4 tiles with the kernel's layouts
// (its products bit for bit), quant_position and llf_error; the sums in
// plain order (the kernel reduces in a tree)
template <int H, int W>
static void e3_dct(const float* src, long long ph, long long pw, int y0,
                   int x0, float* co) {
  std::vector<float> reg(H * W), tt(W * H), aHT(H * H), aWT(W * W);
  for (int c = 0; c < 3; ++c) {
    for (int y = 0; y < H; ++y)
      for (int x = 0; x < W; ++x)
        reg[y * W + x] = src[(c * ph + y0 + y) * pw + x0 + x];
    for (int k0 = 0; k0 < H; k0 += 4)
      for (int xb = 0; xb < W; xb += 4) {
        float acc[4][4];
        tile_product<H, 4, 4>(g_aHT + k0, H, reg.data() + xb, W, acc);
        for (int i = 0; i < 4; ++i)
          for (int j = 0; j < 4; ++j) tt[(xb + j) * H + k0 + i] = acc[i][j];
      }
    for (int k0 = 0; k0 < H; k0 += 4)
      for (int l0 = 0; l0 < W; l0 += 4) {
        float acc[4][4];
        tile_product<W, 4, 4>(tt.data() + k0, H, g_aWT + l0, W, acc);
        for (int i = 0; i < 4; ++i)
          for (int j = 0; j < 4; ++j)
            co[c * H * W + (k0 + i) * W + l0 + j] = acc[i][j];
      }
  }
}

extern "C" void enc_dct_costs(
    const float* src, const int* qf, const float* fx, const float* fb,
    const float* dqdc, const float* anaH, const float* anaW,
    const int* order, const float* tab, const int* pos, const float* anY,
    const float* anX, const float* rs, int ys_b, int xs_b, int cy, int cx,
    float igs, float lam, float dz, const float* qk, int cov, int tail,
    int16_t* vals, float* cost) {
  const int H = 8 * cy, W = 8 * cx, N = H * W;
  const long long ph = 8ll * ys_b, pw = 8ll * xs_b, nb = 1ll * ys_b * xs_b;
  std::vector<float> aHT(H * H), aWT(W * W), co(3 * N);
  for (int i = 0; i < H * H; ++i) aHT[(i % H) * H + i / H] = anaH[i];
  for (int i = 0; i < W * W; ++i) aWT[(i % W) * W + i / W] = anaW[i];
  g_aHT = aHT.data();
  g_aWT = aWT.data();
  const Bias bias[3] = {{qk[0], qk[3]}, {qk[1], qk[3]}, {qk[2], qk[3]}};
  const int nyc = ys_b / cy, nxc = xs_b / cx;
  for (int blk = 0; blk < nyc * nxc; ++blk) {
    const int by0 = blk / nxc * cy, bx0 = blk % nxc * cx;
    if (cy == 1 && cx == 1)
      for (int c = 0; c < 3; ++c)
        for (int p = 0; p < 64; ++p)
          co[c * 64 + p] = src[((c * ys_b + by0) * xs_b + bx0) * 64ll + p];
    else if (H == 8) e3_dct<8, 16>(src, ph, pw, by0 * 8, bx0 * 8, co.data());
    else if (W == 8) e3_dct<16, 8>(src, ph, pw, by0 * 8, bx0 * 8, co.data());
    else if (H == 16 && W == 16)
      e3_dct<16, 16>(src, ph, pw, by0 * 8, bx0 * 8, co.data());
    else if (H == 16) e3_dct<16, 32>(src, ph, pw, by0 * 8, bx0 * 8, co.data());
    else if (W == 16) e3_dct<32, 16>(src, ph, pw, by0 * 8, bx0 * 8, co.data());
    else e3_dct<32, 32>(src, ph, pw, by0 * 8, bx0 * 8, co.data());
    int qmin = qf[by0 * xs_b + bx0];
    for (int y = 0; y < cy; ++y)
      for (int x = 0; x < cx; ++x)
        qmin = std::min(qmin, qf[(by0 + y) * xs_b + bx0 + x]);
    const float inv_qac = 1.0f / ((float)qmin / igs);
    const float fxa = fx[by0 * xs_b + bx0], fba = fb[by0 * xs_b + bx0];
    float err[3] = {0, 0, 0}, bits[3] = {0, 0, 0};
    int last[3] = {0, 0, 0}, cnt[3] = {0, 0, 0};
    for (int j = 0; j < tail; ++j) {
      const int p = order[j];
      const float f[3] = {co[p], co[N + p], co[2 * N + p]};
      const float t3[3] = {tab[j], tab[tail + j], tab[2 * tail + j]};
      float q[3], e[3];
      quant_position(f, t3, inv_qac, fxa, fba, bias, dz, q, e);
      for (int c = 0; c < 3; ++c) {
        err[c] = err[c] + e[c];
        vals[(blk * 3ll + c) * tail + j] = (int16_t)(int)q[c];
        if (q[c] != 0.0f) {
          last[c] = j + 1;
          bits[c] = bits[c] + log2f(1.0f + fabsf(q[c]));
          cnt[c] += 1;
        }
      }
    }
    float dist = qk[5] * err[1];
    dist = dist + qk[4] * err[0];
    dist = dist + qk[6] * err[2];
    for (int c = 0; c < 3; ++c) {
      const float* dq = dqdc + c * nb;
      float s = 0.0f;
      for (int j = 0; j < cov; ++j) {
        if (cy == 1 && cx == 1) {
          const float d = dq[by0 * xs_b + bx0] - co[c * N];
          s = s + d * d;
        } else {
          s = s + llf_error(anY, anX, rs, dq, xs_b, by0, bx0, cy, cx, j,
                            co[c * N + pos[j]]);
        }
      }
      dist = dist + qk[4 + c] * s;
    }
    float rate = 0.0f;
    for (int c = 0; c < 3; ++c)
      rate = rate + token_cost(last[c], bits[c], cnt[c]);
    cost[blk] = rate + lam * dist;
  }
}

// E4 (encode.cu special_costs_kernel) as `walkers` groups one after
// another, each the kernel's walk: its rounds of blocks in the kernel's
// order, the ring appended in block order (the kernel's ballot), every
// phase run for the group's threads one after another between the
// kernel's barriers
extern "C" void enc_special_costs(
    const float* planes, const int* qf, const float* fx, const float* fb,
    const float* dqdc, const uint8_t* elig, const float* r0, const float* R1,
    const float* A, int ys_b, int xs_b, float igs, float lam, float dz,
    const float* qk, int walkers, int16_t* vals, float* cost) {
  SpecialArgs a{planes, qf, fx, fb, dqdc, elig, r0, R1, A, vals, cost,
                ys_b, xs_b, {}};
  for (int c = 0; c < 3; ++c) {
    a.k.bias[c] = Bias{qk[c], qk[3]};
    a.k.area_w[c] = qk[4 + c];
  }
  a.k.dz = dz;
  a.k.igs = igs;
  a.k.lam = lam;
  std::vector<SpecialMats> mv(1);
  std::vector<SpecialBatch> sv(1);
  SpecialMats& m = mv[0];
  SpecialBatch& s = sv[0];
  std::vector<E4Thread> st(kE4Threads);
  const long long nb = 1ll * ys_b * xs_b;
  const int order[3] = {1, 0, 2};
  for (int t = 0; t < kE4Threads; ++t) e4_load(t, kE4Threads, a, m);
  for (int w = 0; w < walkers; ++w) {
    s.head = s.count = 0;
    for (int r = 0;; ++r) {
      const bool done = e4_block(w, walkers, 1ll * r * kE4Seg) >= nb;
      if (!done) {
        for (int i = 0; i < kE4Seg; ++i) {
          const long long n = e4_block(w, walkers, 1ll * r * kE4Seg + i);
          if (n < nb && elig[n])
            s.ring[(s.head + s.count++) & (kE4Ring - 1)] = (int)n;
        }
        for (int t = 0; t < kE4Threads; ++t) e4_clear(t, w, walkers, r, a);
      }
      for (;;) {
        const int count = s.count;
        if (count < kE4Batch && !(done && count > 0)) break;
        const int nbat = std::min(count, kE4Batch);
        for (int t = 0; t < kE4Threads; ++t) e4_slot(t, nbat, a, s);
        for (int oi = 0; oi < 3; ++oi) {
          const int c = order[oi];
          for (int t = 0; t < kE4Threads; ++t) {
            e4_input(t, c, a, m, s, st[t]);
            if (oi) e4_reduce(t, order[oi - 1], s);
          }
          for (int t = 0; t < kE4Threads; ++t) e4_quant(t, c, a, m, s);
          for (int t = 0; t < kE4Threads; ++t)
            e4_recon(t, c, a, m, s, st[t]);
        }
        for (int t = 0; t < kE4Threads; ++t) e4_reduce(t, 2, s);
        for (int t = 0; t < kE4Threads; ++t) e4_cost(t, nbat, a, s);
        s.head += nbat;
        s.count = count - nbat;
      }
      if (done) break;
    }
  }
}

// E4's quantiser from its tables against quantize, on ratios inside them
extern "C" int enc_quantize_tab(const float* r, int n, const float* qk,
                                float dz) {
  std::vector<SpecialMats> mv(1);
  e4_tables(0, 1, qk[3], mv[0]);
  int bad = 0;
  for (int c = 0; c < 3; ++c) {
    const Bias b{qk[c], qk[3]};
    for (int i = 0; i < n; ++i) {
      if (!(fabsf(r[i]) < (float)(kE4Tab - 2))) continue;
      const float q = quantize_fast(r[i], b, dz, mv[0]);
      bad += q != quantize(r[i], b, dz);
      bad += adjust_fast(q, b, mv[0]) != adjust(q, b);
    }
  }
  for (int i = 0; i < kE4Tab; ++i)
    bad += mv[0].log1p2[i] != log2f(1.0f + fabsf((float)i));
  return bad;
}
"""


@pytest.fixture(scope="module")
def enc_host(tmp_path_factory):
    """csrc/encode.cuh built for the host with g++ (no FMA contraction, as
    the kernels' -fmad=false)."""
    import ctypes
    import shutil
    import subprocess
    from jxl_coder_tpu_torch import _build
    gxx = shutil.which("g++")
    assert gxx, "g++ builds the port's host codec; it is needed here too"
    tmp = tmp_path_factory.mktemp("encode")
    cpp, so = tmp / "run.cpp", tmp / "librun.so"
    cpp.write_text(_ENC_RUN)
    subprocess.run([gxx, "-O2", "-std=c++17", "-Wall", "-Werror",
                    "-ffp-contract=off", "-shared", "-fPIC", "-I",
                    str(_build.CSRC), "-o", str(so), str(cpp)], check=True)
    lib = ctypes.CDLL(str(so))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.enc_powf.argtypes = [p, i, f, p]
    lib.enc_xyb.argtypes = [p, i, p, p]
    lib.enc_mask.argtypes = [p, p, i, p]
    lib.enc_quantize.argtypes = [p, i, f, f, f, p]
    lib.enc_dct_costs.argtypes = [p] * 13 + [i] * 4 + [f] * 3 + [p, i, i,
                                                                 p, p]
    lib.enc_front_walk.argtypes = [p, i, p, i, i, i, p]
    lib.enc_special_costs.argtypes = [p] * 9 + [i, i, f, f, f, p, i, p,
                                                 p]
    lib.enc_quantize_tab.argtypes = [p, i, p, f]
    return lib


def _ptr(a):
    return a.ctypes.data


def test_kernel_powf_is_the_twins_powf(enc_host):
    rng = np.random.default_rng(3)
    x = np.concatenate([
        np.exp(rng.uniform(-80, 80, 200_000)),          # every exponent
        rng.uniform(0.0038, 1.2, 200_000),              # cbrt / sRGB inputs
        rng.uniform(1e-6, 0.05, 50_000)]).astype(np.float32)
    for y in (2.4, 1 / 3, 0.68, 1.6):
        out = np.empty_like(x)
        enc_host.enc_powf(_ptr(x), len(x), float(np.float32(y)), _ptr(out))
        ref = EK.fp.powf(torch.from_numpy(x), y).numpy()
        assert np.array_equal(out.view(np.int32), ref.view(np.int32)), y


def test_kernel_xyb_is_the_twins_on_every_grey_and_random_colours(enc_host):
    rng = np.random.default_rng(4)
    grey = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, 1)
    pix = np.concatenate([grey, rng.integers(0, 256, (65_280, 3))]).astype(
        np.uint8).reshape(8, -1, 3)
    k = EK._front_consts(torch.device("cpu")).numpy()
    out = np.empty(pix.shape, np.float32)
    enc_host.enc_xyb(_ptr(pix), pix.shape[0] * pix.shape[1], _ptr(k),
                     _ptr(out))
    ref = EK.front_planes_plain(torch.from_numpy(pix), 0).permute(
        1, 2, 0).numpy()
    assert np.array_equal(out.view(np.int32), ref.view(np.int32))


# frames of one strip (narrower than its 56 output columns, and as wide),
# of two strips across, and taller than a strip (64 rows) and than two:
# the frame's edge falls inside a strip's halo at every step
FRONT_WALK_SIZES = [(8, 8), (8, 16), (40, 56), (64, 96), (144, 48)]


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.float32])
@pytest.mark.parametrize("h,w", FRONT_WALK_SIZES)
def test_kernel_front_walk_equals_the_twin(enc_host, h, w, dtype):
    """E1's strip walk (encode.cuh front_tables, front_xyb and PlaneWalk in
    the kernel's blocks, chunks and warps), built with g++, against
    front_planes_plain at every gab_iters 0-4: 0 differences."""
    img = _image(h, w, seed=h + w)
    if dtype == np.uint8:
        pix, view = img, img
    elif dtype == np.uint16:
        rng = np.random.default_rng(h * w)
        pix = (img.astype(np.uint16) * 257 + rng.integers(
            0, 257, img.shape)).astype(np.uint16)
        view = pix.view(np.int16)
    else:
        pix = (img.astype(np.float32) / np.float32(255.0) * np.float32(
            0.98)).astype(np.float32)
        view = pix
    code = {np.uint8: 0, np.uint16: 1, np.float32: 2}[dtype]
    k = EK._front_consts(torch.device("cpu")).numpy()
    for gab in range(5):
        out = np.full((3, h, w), np.nan, np.float32)
        assert enc_host.enc_front_walk(_ptr(np.ascontiguousarray(pix)), code,
                                       _ptr(out), h, w, gab, _ptr(k)) == 0
        ref = EK.front_planes_plain(torch.from_numpy(view), gab).numpy()
        assert np.array_equal(out.view(np.int32), ref.view(np.int32)), gab


def test_kernel_mask_and_quantiser_are_the_twins(enc_host):
    rng = np.random.default_rng(5)
    mean = np.abs(rng.normal(0, 0.05, 100_000)).astype(np.float32)
    med = (mean * rng.uniform(0, 1.2, mean.shape)).astype(np.float32)
    mean[:100] = 0
    med[100:200] = 0
    out = np.empty_like(mean)
    enc_host.enc_mask(_ptr(mean), _ptr(med), len(mean), _ptr(out))
    ref = EK._mask_of(torch.from_numpy(mean), torch.from_numpy(med)).numpy()
    assert np.array_equal(out.view(np.int32), ref.view(np.int32))
    r = np.concatenate([rng.normal(0, 6, 100_000),
                        np.arange(-40, 40) + 0.5,             # half ties
                        np.linspace(-1.5, 1.5, 3001)]).astype(np.float32)
    for c in range(3):
        qb = np.float32(1.0 - EK.S.QUANT_BIAS[c])
        q = np.empty_like(r)
        enc_host.enc_quantize(_ptr(r), len(r), float(qb),
                              float(np.float32(EK.S.QUANT_BIAS_NUM)),
                              float(np.float32(PR.AC_DEADZONE)), _ptr(q))
        ref = EK._quantize(torch.from_numpy(r), c,
                           float(np.float32(PR.AC_DEADZONE))).numpy()
        assert np.array_equal(q, ref), c


@pytest.mark.parametrize("sid,cy,cx", [(0, 1, 1)] + PR._EFFORT_CANDS["full"])
def test_kernel_dct_costs_arithmetic_meets_the_tie_rule(sid, cy, cx,
                                                        enc_host):
    """E3's arithmetic (encode.cuh's tile_product in the kernel's 4 x 4
    tiles and layouts, quant_position, llf_error), built with g++, against
    dct_costs_plain on the front's planes of a seeded 256 x 384 frame: the
    values equal but at quantisation ties, on a share of at most 1e-5, and
    the costs within 1e-4 where a varblock's values agree (the card's
    rule, chip_smoke.enc_check_quant)."""
    pad = _image(256, 384, seed=9)
    planes = EK.front_planes_plain(torch.from_numpy(pad), 4)
    co, _small = EK.front_blocks_plain(planes)
    ys_b, xs_b = 32, 48
    rng = np.random.default_rng(sid)
    qf = torch.from_numpy(rng.integers(2, 16, (ys_b, xs_b)).astype(np.int32))
    fx, fb = (torch.from_numpy(rng.normal(0, 0.1, (ys_b, xs_b)).astype(
        np.float32)) for _ in range(2))
    dq = co[:, :, :, 0, 0].contiguous()
    igs, lam = 10.92, 0.05
    src = (co if sid == 0 else planes).contiguous()
    nyc, nxc = ys_b // cy, xs_b // cx
    cost_ref = torch.empty(nyc * nxc)
    ref, ratios = EK.dct_costs_plain(src, qf, fx, fb, dq, igs, lam, sid, cy,
                                     cx, PR.AC_DEADZONE, cost_ref,
                                     return_ratios=True)
    t = EK._host_tables(sid, cy, cx)
    st = EK.STRATEGIES[sid]
    qk = EK._quant_consts(EK._weights(st.covered))
    vals = np.zeros(ref.shape, np.int16)
    cost = np.zeros(nyc * nxc, np.float32)
    arrs = [np.ascontiguousarray(x.numpy()) for x in (src, qf, fx, fb, dq)]
    arrs += [t[k] for k in ("anaH", "anaW", "order", "tab", "pos", "anY",
                            "anX", "rs")]
    enc_host.enc_dct_costs(*[_ptr(x) for x in arrs], ys_b, xs_b, cy, cx,
                           float(np.float32(igs)), float(np.float32(lam)),
                           float(np.float32(PR.AC_DEADZONE)), _ptr(qk),
                           st.covered, st.num_coeffs - st.covered,
                           _ptr(vals), _ptr(cost))
    diff = torch.from_numpy(vals) != ref
    assert not EK.tie_faults(diff, ratios, PR.AC_DEADZONE).any()
    assert float(diff.float().mean()) <= 1e-5
    rows = ~diff.flatten(2).any(-1).reshape(-1).numpy()
    rel = np.abs(cost - cost_ref.numpy()) / np.abs(cost_ref.numpy())
    assert rows.any() and rel[rows].max() <= 1e-4, rel[rows].max()


@pytest.mark.parametrize("sid", PR._SPECIAL_CANDS)
def test_kernel_special_costs_walk_meets_the_tie_rule(sid, enc_host):
    """E4's batch walk (encode.cuh's e4_* phases in the kernel's tiles,
    rounds and batches), built with g++, against special_costs_plain on a
    seeded 19 x 23-block frame (437 blocks: 3 rounds and a part for one
    walker) with ~40% of its blocks ineligible: zero values and cost 1e30
    there; the values equal but at quantisation ties (tie_faults with
    block_dep) and the costs within 1e-4 where a block's values agree (the
    card's rule, chip_smoke.enc_check_quant).  24 blocks have every ratio
    at a decision boundary of the quantiser (pixels made through R1 from
    the midpoints of adjacent dequantised values), so ties occur; 8 have
    ratios past the quantiser's tables; no batch is full at the end of a
    walk; one and three walkers give the same bits."""
    ys_b, xs_b = 19, 23
    nb = ys_b * xs_b
    planes = EK.front_planes_plain(torch.from_numpy(
        _image(8 * ys_b, 8 * xs_b, seed=sid)), 4).numpy().copy()
    co, _small = EK.front_blocks_plain(torch.from_numpy(planes))
    dq = np.ascontiguousarray(co[:, :, :, 0, 0].numpy())
    rng = np.random.default_rng(sid)
    qf = rng.integers(2, 16, (ys_b, xs_b)).astype(np.int32)
    fx, fb = (rng.normal(0, 0.1, (ys_b, xs_b)).astype(np.float32)
              for _ in range(2))
    elig = rng.random((ys_b, xs_b)) < 0.6
    igs, lam = 10.92, 0.05
    r0, R1, A = EK._special_host(sid)
    tied = np.flatnonzero(elig)[:24]
    for n in tied:
        by, bx = divmod(int(n), xs_b)
        fx[by, bx] = fb[by, bx] = 0.0
        inv = np.float32(1.0) / (np.float32(qf[by, bx]) / np.float32(igs))
        for c in range(3):
            q = torch.from_numpy(rng.integers(-3, 3, 63).astype(np.float32))
            mid = (EK._adjust(q, c).double() + EK._adjust(q + 1, c).double()
                   ) / 2
            px = (mid.numpy() * float(inv)) @ R1[c].astype(np.float64) \
                + float(dq[c, by, bx]) * r0[c].astype(np.float64)
            planes[c, 8 * by:8 * by + 8, 8 * bx:8 * bx + 8] = \
                px.reshape(8, 8)
    big = np.flatnonzero(elig)[24:32]   # ratios past the quantiser's tables
    for n in big:
        by, bx = divmod(int(n), xs_b)
        planes[:, 8 * by:8 * by + 8, 8 * bx:8 * bx + 8] *= 3000.0
    t = torch.from_numpy
    cost_ref = torch.empty(nb)
    ref, ratios = EK.special_costs_plain(
        t(planes), t(qf), t(fx), t(fb), t(dq), igs, lam, t(elig), sid,
        PR.AC_DEADZONE, cost_ref, return_ratios=True)
    qk = EK._quant_consts([float(np.float32(d)) for d in EK.D_WEIGHTS])
    outs = []
    for walkers in (1, 3):
        vals = np.full((ys_b, xs_b, 3, 63), 7, np.int16)
        cost = np.full(nb, np.nan, np.float32)
        arrs = [planes, qf, fx, fb, dq, elig.astype(np.uint8), r0, R1, A]
        enc_host.enc_special_costs(*[_ptr(x) for x in arrs], ys_b, xs_b,
                                   float(np.float32(igs)),
                                   float(np.float32(lam)),
                                   float(np.float32(PR.AC_DEADZONE)),
                                   _ptr(qk), walkers, _ptr(vals),
                                   _ptr(cost))
        outs.append((vals, cost))
    assert np.array_equal(outs[0][0], outs[1][0])
    assert np.array_equal(outs[0][1].view(np.int32), outs[1][1].view(np.int32))
    vals, cost = outs[1]
    flat = elig.reshape(-1)
    assert int(flat.sum()) % 64 and (nb % 128)
    assert not vals[~elig].any() and np.all(cost[~flat] == np.float32(1e30))
    diff = torch.from_numpy(vals) != ref
    assert not EK.tie_faults(diff, ratios, PR.AC_DEADZONE,
                             block_dep=True).any()
    assert EK.ties(ratios, PR.AC_DEADZONE).reshape(nb, 3, 63)[tied].any()
    assert float(ratios.reshape(nb, -1)[big].abs().max()) > 2 * 512
    natural = flat.copy()
    natural[tied] = False
    assert float(diff.reshape(nb, -1)[natural].float().mean()) <= 1e-5
    rows = ~diff.reshape(nb, -1).any(-1).numpy() & flat
    rel = np.abs(cost - cost_ref.numpy()) / np.abs(cost_ref.numpy())
    assert rows.any() and rel[rows].max() <= 1e-4, rel[rows].max()


def test_kernel_e4_quantiser_tables_are_quantize(enc_host):
    """E4's quantiser (encode.cuh quantize_fast, adjust_fast:
    QUANT_BIAS_NUM / q and log2(1 + |q|) from tables) against quantize and
    adjust, for each channel's bias, on every ratio inside the tables up
    to their edge, at the half-way ties, the deadzone and signed zero: 0
    differences (past the edge the kernel takes quantize itself)."""
    rng = np.random.default_rng(22)
    r = np.concatenate([rng.normal(0, 6, 100_000),
                        rng.normal(0, 2000, 20_000),
                        np.arange(-600, 600) + 0.5,
                        np.linspace(-1.5, 1.5, 3001),
                        [0.0, -0.0, 253.49, 253.5, -253.5, 1e9, -1e9]]
                       ).astype(np.float32)
    qk = EK._quant_consts([float(np.float32(d)) for d in EK.D_WEIGHTS])
    assert enc_host.enc_quantize_tab(_ptr(r), len(r), _ptr(qk),
                                     float(np.float32(PR.AC_DEADZONE))) == 0


# --------------------------------------------------------------------------
# csrc/encode.cuh, the winners' gather walk, built with g++

_GATHER_RUN = r"""
#include <stdint.h>
#include <string.h>
#include <vector>
// every 16-byte chunk the walk loads, in order
static std::vector<uintptr_t> g_loads;
#define JXL_GATHER_LOAD16(w, a)                   \
  do {                                            \
    g_loads.push_back((uintptr_t)(a));            \
    memcpy((w), (const void*)(uintptr_t)(a), 16); \
  } while (0)
#include "encode.cuh"
using namespace jxl_enc;

// the kernel's grid (gather_plan, gather_blocks) run block by block,
// thread by thread; loads: the chunks' addresses (up to cap), n_loads
// their count
extern "C" int gather_run(const long long* desc, int n, int16_t* out,
                          uint64_t* loads, long long cap, long long* n_loads,
                          long long* blocks) {
  GatherPlan p;
  if (gather_plan(desc, n, p) != 0) return -1;
  g_loads.clear();
  const uint32_t nb = gather_blocks(p);
  for (uint32_t b = 0; b < nb; ++b)
    for (int t = 0; t < kGatherThreads; ++t)
      gather_vector(p, b * kGatherThreads + t, out);
  *blocks = nb;
  *n_loads = (long long)g_loads.size();
  for (size_t i = 0; i < g_loads.size() && (long long)i < cap; ++i)
    loads[i] = g_loads[i];
  return 0;
}
"""


@pytest.fixture(scope="module")
def gather_host(tmp_path_factory):
    """encode.cuh's gather walk built for the host with g++, its chunk
    loads recorded."""
    import ctypes
    import shutil
    import subprocess
    from jxl_coder_tpu_torch import _build
    gxx = shutil.which("g++")
    assert gxx, "g++ builds the port's host codec; it is needed here too"
    tmp = tmp_path_factory.mktemp("gather")
    cpp, so = tmp / "run.cpp", tmp / "librun.so"
    cpp.write_text(_GATHER_RUN)
    subprocess.run([gxx, "-O2", "-std=c++17", "-Wall", "-Werror",
                    "-shared", "-fPIC", "-I", str(_build.CSRC), "-o",
                    str(so), str(cpp)], check=True)
    fn = ctypes.CDLL(str(so)).gather_run
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [p, i, p, p, ll, p, p]
    return fn


def _gather_walk(fn, shapes, seed, below=3, past=3):
    """Sources (ny, nx, tail, rows taken) at 2-byte offsets 0-7 elements
    past a 16-byte boundary in one arena, row indices drawn from [-below,
    rows + past), through the host build -> (output, the twin's output,
    the sentinels past the end, the chunk addresses, each source's chunk
    range, the blocks)."""
    import ctypes
    rng = np.random.default_rng(seed)
    arena = np.zeros(64 + sum(ny * nx * 3 * t + 16
                              for ny, nx, t, _ in shapes), np.int16)
    off = (-arena.ctypes.data % 16) // 2
    views, idxs, extents = [], [], []
    for k, (ny, nx, t, m) in enumerate(shapes):
        off += k % 8
        n = ny * nx * 3 * t
        v = arena[off:off + n]
        v[:] = rng.integers(-32768, 32767, n)
        a0 = v.ctypes.data
        if n:
            extents.append((a0 & ~15, (a0 + 2 * n - 1) & ~15))
        off += n + 8
        views.append(v.reshape(ny, nx, 3, t))
        idxs.append(rng.integers(-below, ny * nx + past, m).astype(np.int32))
    desc = np.zeros((len(shapes), 6), np.int64)
    total = 0
    for k, (v, ix) in enumerate(zip(views, idxs)):
        desc[k] = (v.ctypes.data, ix.ctypes.data, len(ix), 3 * v.shape[3],
                   v.shape[0] * v.shape[1], total)
        total += len(ix) * 3 * v.shape[3]
    buf = np.full(total + 64, 12345, np.int16)
    out = buf[(-buf.ctypes.data % 16) // 2:][:total + 40]
    cap = 1 << 20
    loads = np.zeros(cap, np.uint64)
    n_loads, blocks = ctypes.c_longlong(), ctypes.c_longlong()
    assert fn(desc.ctypes.data, len(shapes), out.ctypes.data,
              loads.ctypes.data, cap, ctypes.byref(n_loads),
              ctypes.byref(blocks)) == 0
    assert n_loads.value <= cap
    ref = EK.gather_rows_plain([torch.from_numpy(v.copy()) for v in views],
                               [torch.from_numpy(ix) for ix in idxs]).numpy()
    return (out[:total], ref, out[total:], loads[:n_loads.value], extents,
            blocks.value)


# (sources as (ny, nx, tail, rows taken)): a source no row is taken from, a
# one-row source, row lengths 189 (DCT8 and the specials) and 3024 (32x32),
# rows shorter than a 16-byte vector (3 to 15 elements), and 1-16 sources
GATHER_CASES = [
    [(5, 7, 63, 40)],
    [(1, 1, 63, 1)],
    [(4, 4, 1008, 9), (3, 3, 63, 0), (1, 1, 63, 3)],
    [(3, 3, 63, 0), (2, 2, 63, 5), (2, 2, 63, 0)],
    [(2, 3, 1, 17), (1, 2, 2, 11), (3, 1, 4, 13), (1, 1, 5, 2)],
] + [[(1 + (k * j) % 4, 1 + (k + j) % 5, (1, 2, 5, 63, 252, 1008)[
    (k + 2 * j) % 6], (3 * k + 7 * j) % 31) for j in range(k)]
    for k in range(1, 17)]


@pytest.mark.parametrize("case", range(len(GATHER_CASES)))
def test_gather_walk_equals_the_twin(gather_host, case):
    """The gather's flat walk (encode.cuh gather_plan, gather_blocks,
    gather_vector), built with g++, on sources at every 2-byte offset
    from a 16-byte boundary, indices below 0 and past the end: its output
    equals gather_rows_plain (0 differences), nothing is written past it,
    the grid has no block without output, and every chunk it loads is
    16-byte aligned and holds bytes of a source."""
    out, ref, after, loads, extents, blocks = _gather_walk(
        gather_host, GATHER_CASES[case], seed=case)
    assert np.array_equal(out, ref)
    assert (after == 12345).all()
    assert blocks == -(-len(ref) // (256 * 8))
    assert (loads % 16 == 0).all()
    inside = np.zeros(len(loads), bool)
    for lo, hi in extents:
        inside |= (loads >= lo) & (loads <= hi)
    assert inside.all()


def test_gather_walk_reads_a_vector_inside_a_row_in_two_chunks(gather_host):
    """A vector inside one row of 189 elements loads the one or two
    chunks that hold it, no more: on 40 rows, fewer than 2.1 chunk loads
    a vector."""
    out, ref, _, loads, _, _ = _gather_walk(gather_host, [(8, 8, 63, 40)],
                                            seed=3)
    assert np.array_equal(out, ref)
    assert len(loads) < 2.1 * (len(ref) / 8)


def test_gather_plan_refuses_what_the_walk_cannot_take(gather_host):
    """gather_plan returns -1 (the C entry: cudaErrorInvalidValue) for
    rows taken from a source without rows; the wrapper raises first."""
    import ctypes
    desc = np.asarray([[16, 32, 4, 189, 0, 0]], np.int64)
    z = ctypes.c_longlong()
    assert gather_host(desc.ctypes.data, 1, None, None, 0, ctypes.byref(z),
                       ctypes.byref(z)) == -1
    with pytest.raises(ValueError, match="without rows"):
        EK.gather_rows([torch.zeros((0, 3, 3, 63), dtype=torch.int16)],
                       [torch.zeros(2, dtype=torch.int32)])
