"""The port's fused filter kernels (jxl_coder_tpu_torch.vardct.
fused_filters, TPU kernels 3-6) on the CPU: each entry point's plain
twin against its Pallas kernel run in interpret mode, and the unpadded
form the pipeline calls (the inverse sigma made per block from the
quant field, f32 / sRGB8 / sRGB16 out) against the jnp chain at ragged
sizes, the round-1 16-bit decode included.

Tolerances: float32 within 1e-5 (same formulas; XLA fuses some
a * b + c into one rounding); 8-bit output within 1 code on < 0.1% of
values; 16-bit within 64 codes.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from jxl_coder_tpu import codec as JC
from jxl_coder_tpu.vardct import filters_pallas as FPJ
from jxl_coder_tpu.vardct import pipeline as JP
from jxl_coder_tpu_torch import api, codec
from jxl_coder_tpu_torch.vardct import filters as F
from jxl_coder_tpu_torch.vardct import fused_filters as FF
from jxl_coder_tpu_torch.vardct import pipeline as P
from port_fixtures import smooth_frame

TOL_F32 = 1e-5
PAD = FF.PAD


def _xyb(h, w, seed):
    """XYB-like planes plus noise, rows padded by PAD with neighbours of
    the same statistics (the padded interface takes any rows there)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h + 2 * PAD, 0:w]
    base = np.stack([0.02 * np.sin(xx / 7.0), 0.45 + 0.2 * np.cos(yy / 5.0),
                     0.4 + 0.2 * np.sin((xx + yy) / 9.0)])
    return (base + rng.normal(0, 0.01, base.shape)).astype(np.float32)


def _compare(got, ref, kind):
    got = np.asarray(got)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    if kind == "f32":
        assert np.abs(got - ref).max() <= TOL_F32
        return
    d = np.abs(got.astype(int) - ref.astype(int))
    if kind == "u16":
        assert d.max() <= 64
    else:
        assert d.max() <= 1 and (d > 0).mean() < 1e-3


@pytest.mark.parametrize("h,w", [(32, 128), (48, 256)])
def test_fused_gab_epf_vs_pallas(h, w):
    x = _xyb(h, w, seed=h)
    inv = np.random.default_rng(w).uniform(0.5, 3.0, (h + 2 * PAD, w)
                                           ).astype(np.float32)
    stacked = np.concatenate([x, inv[None]])
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(FPJ.fused_gab_epf(jnp.asarray(stacked), tile=8))
    _compare(FF.fused_gab_epf(torch.from_numpy(stacked)).numpy(), ref, "f32")


@pytest.mark.parametrize("to_srgb", [False, True])
def test_fused_filters2_vs_pallas(to_srgb):
    h, w = 32, 128
    x = _xyb(h, w, seed=7)
    inv = np.random.default_rng(8).uniform(0.5, 3.0, (h + 2 * PAD, w)
                                           ).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(FPJ.fused_filters2(jnp.asarray(x), jnp.asarray(inv),
                                            tile=16, to_srgb=to_srgb))
    got = FF.fused_filters2(torch.from_numpy(x), torch.from_numpy(inv),
                            to_srgb)
    _compare(got.numpy(), ref, "u8" if to_srgb else "f32")


def _inv_blocks(h, w, seed):
    sigma = np.random.default_rng(seed).uniform(
        0.0, 2.5, (-(-h // 8), -(-w // 8))).astype(np.float32)
    return F.epf_inv(torch.from_numpy(sigma), 1.0)


# the Pallas kernels' width and a narrower one that is not a multiple of
# 128 (interpret mode is slow on the CPU)
REAL_SHAPES = [(32, 128), (16, 72)]


@pytest.mark.parametrize("h,w", REAL_SHAPES)
@pytest.mark.parametrize("epf_iters,out", [
    (1, "f32"), (1, "u8"), (2, "f32"), (2, "u8"), (2, "u16")])
def test_fused_real_filters_vs_pallas(epf_iters, out, h, w):
    x = _xyb(h, w, seed=10 + epf_iters)
    inv = _inv_blocks(h, w, seed=11)
    kw = dict(epf_iters=epf_iters, to_srgb=out != "f32",
              bits=16 if out == "u16" else 8)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(FPJ.fused_real_filters(
            jnp.asarray(x), jnp.asarray(inv.numpy()), tile=8, **kw))
    got = FF.fused_real_filters(torch.from_numpy(x), inv, **kw)
    _compare(got.numpy(), ref, out)


@pytest.mark.parametrize("h,w", REAL_SHAPES)
@pytest.mark.parametrize("out", ["f32", "u8"])
def test_fused_real_gab_epf1_vs_pallas(out, h, w):
    x = _xyb(h, w, seed=13)
    inv = _inv_blocks(h, w, seed=14)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(FPJ.fused_real_gab_epf1(
            jnp.asarray(x), jnp.asarray(inv.numpy()), tile=8,
            to_srgb=out == "u8"))
    got = FF.fused_real_gab_epf1(torch.from_numpy(x), inv, out == "u8")
    _compare(got.numpy(), ref, out)


@pytest.mark.parametrize("h,w,epf_iters", [(40, 72, 1), (37, 61, 2)])
def test_fused_real_filters_equals_the_three_stage_chain(h, w, epf_iters):
    """Kernel 3 on edge-padded planes is kernel 2's chain (gaborish ->
    EPF1 -> EPF2, its plain version) on the unpadded ones, at any H x W; kernel 4
    differs from it only within 2 pixels of the border (edge instead of
    Mirror)."""
    x = _xyb(h, w, seed=15)[:, PAD:-PAD]
    xp = np.pad(x, ((0, 0), (PAD, PAD), (0, 0)), mode="edge")
    sigma = np.random.default_rng(16).uniform(
        0.0, 2.5, (-(-h // 8), -(-w // 8))).astype(np.float32)
    sig = torch.from_numpy(sigma)
    chain = F.filter_chain_plain(torch.from_numpy(x), sig, True, epf_iters,
                                 (FF.DEFAULT_GW1, FF.DEFAULT_GW2) * 3, 0.9,
                                 6.5)
    got = FF.fused_real_filters(torch.from_numpy(xp), F.epf_inv(sig, 1.0),
                                epf_iters=epf_iters, pass2_scale=6.5)
    assert np.abs(got.numpy() - chain.numpy()).max() <= TOL_F32
    if epf_iters == 1:
        g4 = FF.fused_real_gab_epf1(torch.from_numpy(xp), F.epf_inv(sig, 1.0))
        inner = (slice(None), slice(2, -2), slice(2, -2))
        assert np.abs(g4.numpy()[inner] - chain.numpy()[inner]).max() \
            <= TOL_F32


def _qf(h, w, seed):
    """A seeded per-8x8-block quant field for an h x w image."""
    return np.random.default_rng(seed).integers(
        1, 40, (-(-h // 8), -(-w // 8))).astype(np.int32)


def _jnp_chain(x, qf, distance, gab, epf, qf_row=0):
    """pipeline.apply_filters as reconstruct_xyb pads it, the inverse
    sigma from JP.inv_sigma_map (rows qf_row .. of the field, clamped)."""
    h, w = x.shape[1:]
    inv = np.asarray(JP.inv_sigma_map(jnp.asarray(qf), jnp.float32(distance)))
    inv = inv[np.clip(np.arange(h) + qf_row, 0, inv.shape[0] - 1)][:, :w]
    halo = JP.filter_halo(int(epf), gab)
    return JP.apply_filters(JP.pad_rows(jnp.asarray(x), halo),
                            JP.pad_rows(jnp.asarray(inv), halo), int(epf),
                            gab)


@pytest.mark.parametrize("h,w,gab,epf,to_srgb", [
    (21, 45, True, True, True), (21, 45, True, True, False),
    (13, 30, False, True, False), (13, 30, True, False, True),
    (9, 17, False, False, True)])
def test_legacy_filters_unpadded_vs_jnp_chain(h, w, gab, epf, to_srgb):
    """The pipeline's form: unpadded planes of any size, halos made by
    clamping, the inverse sigma per block; the reference pads rows as
    reconstruct_xyb does."""
    x = _xyb(h, w, seed=h * w)[:, PAD:-PAD]
    qf = _qf(h, w, seed=w)
    ref = _jnp_chain(x, qf, 1.25, gab, epf)
    if to_srgb:
        ref = JP.xyb_to_srgb8(ref)
    got = FF.legacy_filters(torch.from_numpy(x), torch.from_numpy(qf), 1.25,
                            gab, epf, "u8" if to_srgb else "f32")
    _compare(got.numpy(), np.asarray(ref), "u8" if to_srgb else "f32")


@pytest.mark.parametrize("h,w,gab,epf", [
    (21, 45, True, True), (13, 30, False, True), (9, 17, True, False),
    (8, 16, False, False)])
def test_legacy_filters_u16_vs_jnp_chain(h, w, gab, epf):
    """The 16-bit route's output: xyb_to_u16 of the filtered planes."""
    x = _xyb(h, w, seed=h + w)[:, PAD:-PAD]
    qf = _qf(h, w, seed=h)
    ref = JP.xyb_to_u16(_jnp_chain(x, qf, 0.8, gab, epf))
    got = FF.legacy_filters(torch.from_numpy(x), torch.from_numpy(qf), 0.8,
                            gab, epf, "u16")
    _compare(got.numpy(), np.asarray(ref), "u16")


@pytest.mark.parametrize("gab,epf", [(True, True), (True, False),
                                     (False, True), (False, False)])
@pytest.mark.parametrize("h,w", [(21, 45), (13, 30), (9, 17), (1, 1)])
def test_block_inv_twin_equals_the_per_pixel_twin(h, w, gab, epf):
    """legacy_filters' twin, which reads the quant field per block,
    equals the per-pixel twin fed pipeline.inv_sigma_map bit for bit, for
    every output."""
    x = torch.from_numpy(_xyb(h, w, seed=3 * h + w)[:, PAD:-PAD].copy())
    qf = torch.from_numpy(_qf(h, w, seed=h * w))
    inv = P.inv_sigma_map(qf, 1.5)[:h, :w]
    for out in FF.OUTS:
        got = FF.legacy_filters(x, qf, 1.5, gab, epf, out)
        ref = FF._legacy_plain(x, inv, 0, gab, epf, out)
        assert got.dtype == ref.dtype and torch.equal(got, ref), out


@pytest.mark.parametrize("halo", [1, 2])
def test_block_inv_rows_clamp_as_pad_rows(halo):
    """The epf_iters >= 2 route: planes padded by `halo` rows read the
    field from row -halo, clamped as pipeline.pad_rows clamps the map."""
    h, w = 19, 26
    qf = torch.from_numpy(_qf(h, w, seed=halo))
    ref = P.pad_rows(P.inv_sigma_map(qf, 2.0), halo)[:, :w]
    got = FF.block_inv(qf, 2.0, ref.shape[0], w, -halo)
    assert torch.equal(got, ref)
    x = _xyb(h + 2 * halo, w, seed=halo)[:, PAD:-PAD]
    twin = FF.legacy_filters(torch.from_numpy(x), qf, 2.0, False, True,
                             "f32", qf_row=-halo)
    ref_chain = _jnp_chain(x, qf.numpy(), 2.0, False, True, qf_row=-halo)
    _compare(twin.numpy(), np.asarray(ref_chain), "f32")


@pytest.mark.parametrize("distance", [0.1, 0.5, 1.0, 1.25, 2.0, 3.7, 25.0])
def test_kernel_inverse_sigma_is_bit_equal_to_inv_sigma_map(distance):
    """The kernel's one division, float32(qf) / inv_den(distance), is
    pipeline.inv_sigma_map's value bit for bit."""
    qf = np.arange(1, 20000, dtype=np.int32).reshape(1, -1)
    kernel = np.float32(qf) / FF.inv_den(distance)
    ref = P.inv_sigma_blocks(torch.from_numpy(qf), distance).numpy()
    assert kernel.dtype == np.float32 and np.array_equal(kernel, ref)


def _frame(h, w, seed):
    """Seeded round-1 arrays (AC, DC, qf, CfL) for the port and for JAX."""
    rng = np.random.default_rng(seed)
    ny, nx = -(-h // 8), -(-w // 8)
    ac = rng.integers(-6, 7, (3, ny, nx, 8, 8)).astype(np.int16)
    ac[rng.random(ac.shape) < 0.6] = 0
    ac[:, :, :, 0, 0] = 0
    dc = np.stack([rng.integers(-20, 20, (ny, nx)),
                   rng.integers(300, 500, (ny, nx)),
                   rng.integers(-40, 40, (ny, nx))]).astype(np.int32)
    qf = rng.integers(4, 12, (ny, nx)).astype(np.int32)
    ty, tx = -(-ny // 8), -(-nx // 8)
    cfl = [rng.integers(-8, 8, (ty, tx)), rng.integers(56, 72, (ty, tx))]
    arrays = (ac, dc, qf) + tuple(c.astype(np.int32) for c in cfl)
    return ([torch.from_numpy(a) for a in arrays] + [1.25],
            [jnp.asarray(a) for a in arrays] + [jnp.float32(1.25)])


@pytest.mark.parametrize("h,w,gab,epf_iters", [
    (24, 40, True, 1), (16, 136, True, 0), (24, 40, False, 1),
    (16, 24, True, 2), (16, 24, False, 0)])
def test_reconstruct_u16_vs_jax(h, w, gab, epf_iters):
    """The u16 route's twin against the JAX package's reconstruct_xyb +
    xyb_to_u16 on JAX's CPU."""
    port, jax_args = _frame(h, w, seed=h * w + epf_iters)
    ref = JP.xyb_to_u16(JP.reconstruct_xyb(*jax_args, epf_iters=epf_iters,
                                           gab=gab))
    got = P.reconstruct_u16(*port, epf_iters=epf_iters, gab=gab)
    _compare(got.numpy(), np.asarray(ref), "u16")


@pytest.mark.parametrize("h,w,speed,distance", [
    (29, 41, 0, 1.0), (40, 56, 4, 1.0), (33, 24, 2, 2.5)])
def test_decode_16bit_vs_jax_codec(h, w, speed, distance):
    """codec.decode_vardct_still on the CPU (the u16 route) against
    jxl_coder_tpu.codec.decode_vardct_still on a 16-bit stream."""
    img = smooth_frame(h, w, seed=w, dtype=np.uint16)
    data = JC.encode_vardct_still(img, distance, decoding_speed=speed)
    parts = api._read_frame(data)
    ref = JC.decode_vardct_still(*parts)
    got = codec.decode_vardct_still(*parts, device="cpu")
    assert got.shape == (h, w, 3) and ref.dtype == np.uint16
    _compare(got, ref, "u16")


def test_fused_entry_points_check_their_inputs():
    x = torch.zeros((3, 2 * PAD, 16))
    with pytest.raises(ValueError, match="no image rows"):
        FF._legacy_launch(x, PAD, True, FF._EPF_PIXEL, "f32", x[0])
    with pytest.raises(ValueError, match="inv must be"):
        FF._legacy_launch(torch.zeros((3, 8, 24)), 0, True, FF._EPF_BLOCK,
                          "u8", torch.zeros((1, 3), dtype=torch.float32))
    with pytest.raises(ValueError, match="out must be"):
        FF._legacy_launch(torch.zeros((3, 8, 24)), 0, True, FF._EPF_NONE,
                          "u32")
    with pytest.raises(ValueError, match="inv_blocks"):
        FF._padded_launch(torch.zeros((3, 24, 16)), torch.zeros((1, 1)),
                          True, False, 0.1, 0.05, 1.0, 0)
    with pytest.raises(ValueError, match="unsupported device"):
        FF._padded_launch(torch.zeros((3, 24, 16)), torch.zeros((2, 2)),
                          True, False, 0.1, 0.05, 1.0, 0)


_CODE_SHIM = r"""
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
using std::max;
using std::min;
#define __device__
#define __forceinline__ inline
struct int2 { int x, y; };
struct float4 { float x, y, z, w; };
static inline int __float_as_int(float f) { int i; memcpy(&i, &f, 4); return i; }
static inline float __int_as_float(int i) { float f; memcpy(&f, &i, 4); return f; }
template <typename T> static inline T __ldg(const T* p) { return *p; }
static inline float ldg_if(bool pred, const float* p) {
  return pred ? *p : INFINITY;
}
"""

_CODE_RUN = r"""
template <typename OutT>
static void run(const float* v, long n, const LegacyParams& p, int* out) {
  for (long i = 0; i < n; ++i) out[i] = legacy_code<OutT>(v[i], p);
}
static LegacyParams params(const void* u8, const void* poly, const void* thr,
                           int code_lo) {
  LegacyParams p{};
  p.u8codes = static_cast<const int2*>(u8) - code_lo;
  p.u16poly = static_cast<const float4*>(poly) - code_lo;
  p.u16thr = static_cast<const float*>(thr);
  p.code_lo = code_lo;
  return p;
}
extern "C" void codes(int u16, const float* v, long n, const void* u8,
                      const void* poly, const void* thr, int code_lo,
                      int* out) {
  const LegacyParams p = params(u8, poly, thr, code_lo);
  if (u16) run<uint16_t>(v, n, p, out); else run<uint8_t>(v, n, p, out);
}
// the floats with bit patterns [lo, hi) whose code is not 0
extern "C" long nonzero(int u16, uint32_t lo, uint32_t hi, const void* u8,
                        const void* poly, const void* thr, int code_lo) {
  const LegacyParams p = params(u8, poly, thr, code_lo);
  long n = 0;
  for (uint32_t u = lo; u < hi; ++u) {
    float v;
    memcpy(&v, &u, 4);
    n += (u16 ? legacy_code<uint16_t>(v, p) : legacy_code<uint8_t>(v, p)) != 0;
  }
  return n;
}
"""


@pytest.mark.parametrize("out", ["u8", "u16"])
def test_kernel_codes_equal_the_twins_on_every_float(tmp_path, out):
    """legacy_kernel's legacy_code, built for the host with g++ from
    csrc/fused_filters.cu and fed fused_filters' code tables, gives
    pipeline.linear_to_codes' code for every float in [0, 1]: the linear
    segment (v * 12.92, in float32 as the twin rounds it), glibc's powf
    past it, and 0 below the tables."""
    import ctypes
    import shutil
    import subprocess
    from jxl_coder_tpu_torch import _build
    gxx = shutil.which("g++")
    assert gxx, "g++ builds the port's host codec; it is needed here too"
    src = (_build.CSRC / "fused_filters.cu").read_text()
    body = src[src.index("struct LegacyParams {"):
               src.index("// pipeline.xyb_to_srgb8 / xyb_to_u16 of one pixel")]
    cpp, so = tmp_path / "codes.cpp", tmp_path / "libcodes.so"
    cpp.write_text(_CODE_SHIM + body + _CODE_RUN)
    subprocess.run([gxx, "-O2", "-std=c++17", "-ffp-contract=off",
                    "-shared", "-fPIC", "-o", str(so), str(cpp)], check=True)
    lib = ctypes.CDLL(str(so))
    P_, I_ = ctypes.c_void_p, ctypes.c_int
    lib.codes.argtypes = [I_, P_, ctypes.c_long, P_, P_, P_, I_, P_]
    lib.nonzero.argtypes = [I_, ctypes.c_uint32, ctypes.c_uint32, P_, P_,
                            P_, I_]
    lib.nonzero.restype = ctypes.c_long
    u16, scale = out == "u16", (255 if out == "u8" else 65535)
    tables = [t.ctypes.data for t in
              (FF.u8_code_table(),) + FF.u16_code_tables()]
    lo = FF.CODE_LO << 16
    assert lib.nonzero(u16, 0, lo, *tables, FF.CODE_LO) == 0
    assert (P.linear_to_codes(_bits(lo - 1, lo), scale) == 0).all()
    end_lin = int(FF.LINEAR_END.view(np.uint32)) + 1
    end = int(np.float32(1.0).view(np.uint32)) + 1
    for a in range(lo, end, 1 << 23):
        v = _bits(a, min(a + (1 << 23), end))
        got = np.empty(v.numel(), np.int32)
        lib.codes(u16, v.numpy().ctypes.data, v.numel(), *tables,
                  FF.CODE_LO, got.ctypes.data)
        if a + (1 << 23) <= end_lin:     # the twin's linear segment alone
            x = v.numpy() * np.float32(12.92) * np.float32(scale)
            ref = np.clip(np.rint(x), 0, scale)
        else:
            ref = P.linear_to_codes(v, scale).numpy()
        assert np.array_equal(got, ref.astype(np.int32)), float(v[0])


_SOURCES_SHIM = r"""
#define __host__
#define __device__
#define __forceinline__ inline
"""

_SOURCES_RUN = r"""
template <int MODE>
static void one(int i, int n, int pad, int* o) {
  o[0] = source_row<MODE>(i, n, pad);
  o[1] = source_col<MODE>(i, n);
  o[2] = fold<gab_mirror<MODE>()>(i, n);
}
// window positions -r .. n + r - 1 of a plane n long: the input row and
// column each loads, where the gaborish output there is folded from, and
// where EPF2's input is (edge replication in every mode)
extern "C" void sources(int mode, int n, int pad, int r, int* rows,
                        int* cols, int* gab, int* epf2) {
  for (int i = -r; i < n + r; ++i) {
    int o[3];
    if (mode == CHAIN) one<CHAIN>(i, n, pad, o);
    else if (mode == PADDED_MIRROR) one<PADDED_MIRROR>(i, n, pad, o);
    else one<PADDED_EDGE>(i, n, pad, o);
    rows[i + r] = o[0];
    cols[i + r] = o[1];
    gab[i + r] = o[2];
    epf2[i + r] = fold<false>(i, n);
  }
}
"""


@pytest.fixture(scope="module")
def window_sources(tmp_path_factory):
    """csrc/filters.cu's window sources (with common.cuh's mirror and
    clampi) built for the host with g++."""
    import ctypes
    import shutil
    import subprocess
    from jxl_coder_tpu_torch import _build
    gxx = shutil.which("g++")
    assert gxx, "g++ builds the port's host codec; it is needed here too"
    common = (_build.CSRC / "common.cuh").read_text()
    src = (_build.CSRC / "filters.cu").read_text()
    body = (common[common.index("// libjxl Mirror()"):
                   common.index("struct SrgbParams")]
            + src[src.index("// Window sources:"):
                  src.index("// (end of the window sources)")])
    tmp = tmp_path_factory.mktemp("sources")
    cpp, so = tmp / "sources.cpp", tmp / "libsources.so"
    cpp.write_text(_SOURCES_SHIM + body + _SOURCES_RUN)
    subprocess.run([gxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-o",
                    str(so), str(cpp)], check=True)
    fn = ctypes.CDLL(str(so)).sources
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 4
    return fn


@pytest.mark.parametrize("mode", ["chain", "padded_mirror", "padded_edge"])
def test_window_sources_equal_the_twins_indices(window_sources, mode):
    """Kernels 2-4's window sources give, at every window position out to
    the widest halo the tile pass loads (4), for planes 1 to 20 long and
    0 to 4 pad rows: the input row and column their plain twins read
    (kernel 2: Mirror()ed, filters._mirror_index; kernels 3 and 4: the
    caller's pad rows by fused_filters._padded_rows, clamped past them,
    columns clamped), the gaborish output's fold (_mirror_index for
    kernels 2 and 3, clamped for kernel 4) and EPF2's edge-replicated
    input."""
    R = 4
    code = {"chain": 0, "padded_mirror": 1, "padded_edge": 2}[mode]
    for n in range(1, 21):
        idx = np.arange(-R, n + R)
        clamped = np.clip(idx, 0, n - 1)
        mirrored = F._mirror_index(n, R, "cpu").numpy()
        for pad in range(5):
            got = np.zeros((4, n + 2 * R), np.int32)
            window_sources(code, n, pad, R, *(g.ctypes.data for g in got))
            rows, cols, gab, epf2 = got
            if mode == "chain":
                want_rows = want_cols = want_gab = mirrored
            else:
                planes = torch.arange(n + 2 * pad, dtype=torch.float32)
                want_rows = FF._padded_rows(planes.view(1, -1, 1), pad, R)[
                    0, :, 0].long().numpy() - pad
                want_cols = clamped
                want_gab = mirrored if mode == "padded_mirror" else clamped
            what = f"{mode} n {n} pad {pad}"
            assert np.array_equal(rows, want_rows), what
            assert np.array_equal(cols, want_cols), what
            assert np.array_equal(gab, want_gab), what
            assert np.array_equal(epf2, clamped), what


def _bits(lo, hi):
    """The float32 values with bit patterns [lo, hi)."""
    return torch.arange(lo, hi, dtype=torch.int64).to(torch.int32).view(
        torch.float32)
