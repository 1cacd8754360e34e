"""The VarDCT post stages of the PyTorch port on the CPU: each kernel's
plain twin (vardct/post.py: noise A5, upsampling A6, the output encoding
A7) against the JAX package's device function (tpu_full.py:606-725), the
Modular output's upsampling against jxl_coder_tpu.codec.
_finalize_modular_planes, and the frames the port still declines.

Tolerances: the f32 twins within 1e-6 absolute (sums and products in
another order than XLA's fused ones); the codes within 2, except PQ,
whose slope near black moves codes by tens for a last-bit difference
(the JAX package's own bound, tests/test_device_post.py:89-112): mean
< 0.5, 99.9th percentile <= 8, max <= 64.  The Modular output is exact
for integer channels and within 1 code on < 0.1% of pixels for XYB.
Streams decoded end to end are in test_torch_post_decode.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jxl_coder_tpu import codec as ref_codec
from jxl_coder_tpu.bitstream import container as jax_container
from jxl_coder_tpu.bitstream.frame_header import read_frame_header as jax_rfh
from jxl_coder_tpu.bitstream.headers import read_image_header as jax_rih
from jxl_coder_tpu.bitstream.reader import BitReader as JaxBitReader
from jxl_coder_tpu.vardct import tpu_full as TF
from jxl_coder_tpu.vardct.noise import NOISE_K0
from jxl_coder_tpu_torch import api, reference
from jxl_coder_tpu_torch.host.bitstream.frame_header import write_frame_header
from jxl_coder_tpu_torch.host.bitstream.writer import BitWriter
from jxl_coder_tpu_torch.host.codec import write_image_header
from jxl_coder_tpu_torch.host.ops.upsample import _kernels as up_kernels
from jxl_coder_tpu_torch.modular import output as MOUT
from jxl_coder_tpu_torch.vardct import post
import port_fixtures as F

SIZES = [(1, 1), (2, 3), (4, 4), (5, 2), (3, 7), (17, 33), (40, 64)]
LUMA709 = (0.2126, 0.7152, 0.0722)
LUMA2020 = (0.2627, 0.678, 0.0593)


def _xyb(h, w, seed, hdr=False):
    """Seeded XYB planes in the range decoded frames reach (brighter
    than SDR white for the HDR specs)."""
    rng = np.random.default_rng(seed)
    top = 1.6 if hdr else 0.85
    y = rng.uniform(0.0, top, (h, w))
    return np.stack([rng.normal(0.0, 0.012, (h, w)), y,
                     y + rng.normal(0.0, 0.04, (h, w))]).astype(np.float32)


def _codes_within(got, ref, pq: bool):
    assert got.shape == ref.shape and got.dtype == ref.dtype
    d = np.abs(got.astype(np.int64) - ref.astype(np.int64))
    if pq:
        assert d.mean() < 0.5 and np.percentile(d, 99.9) <= 8 and \
            d.max() <= 64, (d.mean(), d.max())
    else:
        assert d.max() <= 2, d.max()


# ---- A5: noise ----

@jax.jit
def _jax_noise(xyb, rnd, lut):
    """fn_post's noise stage (tpu_full.py:841-855)."""
    X, Y, B = xyb[0], xyb[1], xyb[2]
    conv_r, conv_g, conv_cor = (TF._conv_subbox_device(rnd[c])
                                for c in range(3))
    sr = TF._noise_strength_device(lut, (Y + X) * 0.5)
    sg = TF._noise_strength_device(lut, (Y - X) * 0.5)
    red = sr * (conv_cor + conv_r / jnp.float32(128.0))
    green = sg * (conv_cor + conv_g / jnp.float32(128.0))
    k0 = jnp.float32(NOISE_K0)
    return jnp.stack([X + k0 * (red - green), Y + k0 * (red + green),
                      B + k0 * (red + green)])


@pytest.mark.parametrize("h,w", SIZES)
def test_noise_twin_equals_the_jax_noise_stage(h, w):
    xyb = _xyb(h, w, 1)
    rnd = post.noise_random(w, h, "cpu").numpy()
    lut = np.asarray(reference.photon_noise_lut(3200), np.float32)
    got = post.add_noise(torch.from_numpy(xyb.copy()),
                         torch.from_numpy(rnd), torch.from_numpy(lut))
    ref = np.asarray(_jax_noise(xyb, rnd, lut))
    assert np.abs(got.numpy() - ref).max() <= 1e-6


def test_noise_random_planes_are_the_host_copy_and_cached():
    a = post.noise_random(70, 45, "cpu")
    assert post.noise_random(70, 45, "cpu") is a
    from jxl_coder_tpu.vardct.noise import noise_planes
    assert np.array_equal(a.numpy(), noise_planes(70, 45))


# ---- A6: upsampling ----

@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("h,w", SIZES[:5] + [(17, 33)])
def test_upsample_twin_equals_the_jax_upsampler(n, h, w):
    planes = _xyb(h, w, 2)
    ker = np.asarray(up_kernels(n), np.float32)
    got = post.upsample(torch.from_numpy(planes), torch.from_numpy(ker))
    fn = jax.jit(TF._upsample_plane_device)
    ref = np.stack([np.asarray(fn(p, ker)) for p in planes])
    assert got.shape == (3, n * h, n * w)
    assert np.abs(got.numpy() - ref).max() <= 1e-6


def test_upsample_with_signalled_weights():
    """Custom up2 weights (CustomTransformData) build other kernels."""
    w = tuple(np.linspace(-0.05, 0.6, 15))
    ker = np.asarray(up_kernels(2, w), np.float32)
    planes = _xyb(9, 14, 3)
    got = post.upsample(torch.from_numpy(planes), torch.from_numpy(ker))
    ref = np.stack([np.asarray(TF._upsample_plane_device(p, ker))
                    for p in planes])
    assert np.abs(got.numpy() - ref).max() <= 1e-6


# ---- A7: the output encoding ----

SPECS = {
    "srgb": ("srgb",),
    "gamma": ("gamma", 1 / 2.2),
    "pq_srgb": ("enc", 16, None, 1000.0, LUMA709),
    "pq_2100": ("enc", 16, "2020", 4000.0, LUMA2020),
    "hlg_srgb": ("enc", 18, None, 1000.0, LUMA709),
    "hlg_2100": ("enc", 18, "2020", 1000.0, LUMA2020),
    "srgb_2020": ("enc", 13, "2020", 255.0, LUMA2020),
    "bt709": ("enc", 1, None, 255.0, LUMA709),
    "linear": ("enc", 8, None, 255.0, LUMA709),
    "dci": ("enc", 17, None, 255.0, LUMA709),
}


def _spec(key):
    spec = SPECS[key]
    if spec[0] == "enc" and spec[2] == "2020":
        from jxl_coder_tpu_torch.host.ops import color as HC
        gm = (HC.gamut_xyz_to_rgb(HC.PRIMARIES["bt2020"], HC.ILLUMINANT_D65)
              @ HC.gamut_rgb_to_xyz(HC.PRIMARIES["srgb"], HC.ILLUMINANT_D65))
        spec = spec[:2] + (tuple(gm.astype(np.float32).reshape(-1).tolist()),
                           ) + spec[3:]
    return spec


@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("key", list(SPECS))
def test_encode_output_twin_equals_the_jax_output_stage(key, bits):
    spec = _spec(key)
    xyb = np.concatenate([_xyb(h, w, 4, hdr=spec[0] == "enc").reshape(3, -1)
                          for h, w in SIZES], 1)[:, None, :]
    got = post.encode_output(torch.from_numpy(xyb), spec, bits)
    ref = np.asarray(TF._encode_output_device(*map(jnp.asarray, xyb), spec,
                                              bits))
    _codes_within(got.numpy(), ref, spec[:2] == ("enc", 16))


def test_encode_output_srgb_is_kernel_2s_output_step():
    """The "srgb" spec's codes are those of restore_and_output with every
    filter off (kernel 2's output step)."""
    from jxl_coder_tpu_torch.vardct import filters
    xyb = torch.from_numpy(_xyb(19, 23, 5))
    for bits, out in ((8, "u8"), (16, "u16")):
        a = post.encode_output(xyb, ("srgb",), bits)
        b = filters.restore_and_output(xyb, None, False, 0, (0.0,) * 6, 1.0,
                                       1.0, out)
        assert torch.equal(a, b)


def test_encode_output_takes_a_cropped_view():
    xyb = torch.from_numpy(_xyb(20, 30, 6))
    spec = _spec("hlg_2100")
    a = post.encode_output(xyb[:, 3:17, 2:25], spec, 16)
    b = post.encode_output(xyb[:, 3:17, 2:25].contiguous(), spec, 16)
    assert torch.equal(a, b)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    x = torch.zeros((3, 4, 5))
    with pytest.raises(ValueError):
        post.encode_output(x.double(), ("srgb",), 8)
    with pytest.raises(ValueError):
        post.encode_output(x, ("cmyk",), 8)
    with pytest.raises(ValueError):
        post.upsample(x, torch.zeros((3, 3, 5, 5)))
    with pytest.raises(ValueError):
        post.add_noise(x, torch.zeros((3, 4, 4)), torch.zeros(8))


# ---- the Modular output's upsampling ----

def _jax_headers(data):
    cs = jax_container.extract_codestream(data).codestream
    br = JaxBitReader(cs)
    hdr = jax_rih(br)
    return hdr, jax_rfh(br, hdr)


def _finalize_both(n, nch, xyb=False, ec_up=None, bits=8, seed=7):
    """Seeded coded planes through the port's modular_pixels and the JAX
    package's _finalize_modular_planes (then its clip and stack,
    api.py:558-561), headers from a written stream."""
    h, w = 45, 61
    hdr, fh = F.modular_headers(h, w, nch, bits, xyb=xyb)
    fh.upsampling = n
    fh.ec_upsampling = [ec_up or n] * len(fh.ec_upsampling)
    bw = BitWriter()
    write_image_header(bw, hdr)
    write_frame_header(bw, fh, hdr)
    bw.zero_pad_to_byte()
    data = bw.to_bytes()
    jhdr, jfh = _jax_headers(data)
    cw, ch = fh.coded_size(hdr)
    rng = np.random.default_rng(seed)
    if xyb:
        y = rng.integers(100, 1600, (ch, cw))
        planes = [y, rng.integers(-120, 120, (ch, cw)),
                  rng.integers(-200, 200, (ch, cw))]
    else:
        planes = [rng.integers(0, 1 << bits, (ch, cw)) for _ in range(3)]
    for _ in range(nch - 3):
        e = ec_up or n
        planes.append(rng.integers(0, 1 << bits, (-(-h // e), -(-w // e))))
    planes = [p.astype(np.int32) for p in planes]
    dcq = (1.0 / 4096, 1.0 / 512, 1.0 / 256)
    got = MOUT.modular_pixels([torch.from_numpy(p) for p in planes], hdr, fh,
                              dcq).numpy()
    ref = ref_codec._finalize_modular_planes(planes, jhdr, jfh, dcq)
    maxval = (1 << bits) - 1
    ref = np.stack([np.clip(p, 0, maxval) for p in ref], -1).astype(
        np.uint8 if bits <= 8 else np.uint16)
    return got, ref


@pytest.mark.parametrize("n,nch,bits,ec_up", [
    (2, 3, 8, None), (4, 4, 8, None), (8, 3, 8, None), (2, 4, 16, None),
    (2, 4, 8, 1), (1, 4, 8, 2)])
def test_modular_upsampling_equals_the_jax_finalize(n, nch, bits, ec_up):
    """Integer channels: equal at 8 bits.  At 16 bits the upsampled
    float32 values are ~256x larger, so the last bit of the 25-term sum,
    which numpy's einsum (BLAS) takes in another order, decides rint on
    about 0.1% of them: there within 1 code."""
    got, ref = _finalize_both(n, nch, bits=bits, ec_up=ec_up)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    d = np.abs(got.astype(np.int64) - ref.astype(np.int64))
    if bits == 8:
        assert d.max() == 0
    else:
        assert d.max() <= 1 and (d > 0).mean() < 5e-3


@pytest.mark.parametrize("n", [2, 4])
def test_modular_xyb_upsampling_within_one_code(n):
    got, ref = _finalize_both(n, 3, xyb=True)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    d = np.abs(got.astype(int) - ref.astype(int))
    assert d.max() <= 1 and (d > 0).mean() < 1e-3


def test_upsampled_modular_stream_decodes_as_the_jax_package():
    from jxl_coder_tpu import api as ref_api
    rgba = np.concatenate([F.bench_frame(38, 51), (np.arange(38 * 51).reshape(
        38, 51) % 251).astype(np.uint8)[..., None]], -1)
    data = F.upsampled_modular_still(rgba, 2)
    got, info = api.decode(data, device="cpu")
    ref, _ = ref_api.decode(data)
    assert got.shape == (38, 51, 4) and np.array_equal(got, ref)


# ---- what still raises ----

def _rewritten(data, **changes):
    """The stream with its frame header's fields changed (the sections
    stay; the decode must refuse the frame before it reads them).  A
    YCbCr frame is signalled only where the image is not XYB-encoded."""
    cs, hdr, fh, toc = api._read_frame(data)
    for k, v in changes.items():
        setattr(fh, k, v)
    if fh.do_ycbcr:
        hdr.metadata.xyb_encoded = False
    bw = BitWriter()
    write_image_header(bw, hdr)
    write_frame_header(bw, fh, hdr)
    from jxl_coder_tpu_torch.host.bitstream.frame_header import write_toc
    write_toc(bw, [toc.section(i).size for i in range(len(toc.entries))])
    head = bw.to_bytes()
    body = cs[toc.section(0).offset:]
    return head + body


@pytest.mark.parametrize("feature,changes", [
    ("patches", dict(flags=0x2)), ("splines", dict(flags=0x10)),
    ("a DC frame", dict(flags=0x20)),
    ("YCbCr", dict(do_ycbcr=True, jpeg_upsampling=(0, 1, 0)))])
def test_frames_outside_the_slice_raise(feature, changes):
    """A chroma-subsampled YCbCr frame without a jbrd box is outside the
    port's slice (a 4:4:4 one decodes since the JPEG routes,
    tests/test_torch_jpeg.py).  Patches, splines and a DC frame decode
    now, so a flag set on a stream without their payload (a patch
    dictionary, splines, an LF frame before the frame) is a corrupt stream,
    where the JAX package raises BitstreamError."""
    data = reference.encode_vardct(F.smooth_frame(40, 48), distance=1.0,
                                   effort=5)
    bad = _rewritten(data, **changes)
    if feature == "YCbCr":
        with pytest.raises(NotImplementedError, match=feature):
            api.decode(bad, device="cpu")
    else:
        with pytest.raises(api.InvalidJXLError):
            api.decode(bad, device="cpu")


def test_device_entropy_with_extra_channels_raises():
    img = F.smooth_frame(40, 48)
    data = reference.encode_vardct(img, distance=1.0, effort=5,
                                   alpha=np.full((40, 48), 200))
    assert api.decode(data, device="cpu")[0].shape == (40, 48, 4)
    with pytest.raises(NotImplementedError, match="extra channels"):
        api.decode(data, device="cpu", entropy="device")


def test_post_config_of_a_plain_frame_is_empty():
    data = reference.encode_vardct(F.smooth_frame(40, 48), distance=1.0,
                                   effort=5)
    cfg, _inputs, _hdr = api.prepare(data, "cpu")
    assert cfg.post.colour_empty and cfg.post.ec == ()
    assert dataclasses.replace(cfg.post) == cfg.post


# ---- csrc/post.cuh, A7's and S1's walks, built with g++ ----

_POST_RUN = r"""
#include <stdint.h>
#include "post.cuh"
using namespace jxl_post;

// the kernels' threads one after another: A7's groups of kPix pixels, or
// S1's output pixels
struct HostRun {
  const float* in;
  long long plane, row;
  void* out;
  int H, W, down, pix;
  bool vin, vout;
  const OutParams& p;

  template <int PIX, class OutT, int KIND, int TRC, bool GM>
  void encode(OutT* o) {
    for (int y = 0; y < H; ++y)
      for (int g = 0; g * PIX < W; ++g)
        encode_group<PIX, OutT, KIND, TRC, GM>(in, plane, row, o, W, y, g,
                                               vin, vout, p, p.srgb.mul);
  }

  template <class OutT, int KIND, int TRC, bool GM>
  int run() {
    OutT* o = static_cast<OutT*>(out);
    if (down == 1) {
      if (pix == kPix)
        encode<kPix, OutT, KIND, TRC, GM>(o);
      else
        encode<1, OutT, KIND, TRC, GM>(o);
    } else {
      for (int y = 0; y < (H + down - 1) / down; ++y)
        for (int x = 0; x < (W + down - 1) / down; ++x)
          encode_pooled<OutT, KIND, TRC, GM>(in, plane, row, o, H, W, down,
                                             x, y, p, p.srgb.mul);
    }
    return 0;
  }
};

// jxl_encode_output's plan and dispatch on the host, pix pixels a thread
// (kPix or 1); scalar: no vector loads or stores.  Returns the paths
// taken (1: 16-byte loads, 2: word stores), or -1.
extern "C" int post_run(const float* in, long long plane, long long row,
                        void* out, int H, int W, int down, int kind, int trc,
                        int bits, const float* prm, const float* srgb,
                        const uint32_t* mul, int scalar, int pix) {
  OutParams p;
  const bool gm = out_params(bits, prm, srgb, mul, p);
  const bool vin = !scalar && vector_loads(in, plane, row);
  const bool vout = !scalar && vector_stores(out, W);
  HostRun r{in, plane, row, out, H, W, down, pix, vin, vout, p};
  if (dispatch(kind, trc, gm, bits, r) != 0) return -1;
  return (int)vin | (int)vout << 1;
}

extern "C" int post_pixels(int H, int W, int sms) {
  return pixels_a_thread(H, W, sms);
}
"""


@pytest.fixture(scope="module")
def post_host(tmp_path_factory):
    """csrc/post.cuh built for the host with g++ (no FMA contraction, as
    the kernels' -fmad=false; glibc's powf / logf / sqrtf)."""
    import ctypes
    import shutil
    import subprocess
    from jxl_coder_tpu_torch import _build
    gxx = shutil.which("g++")
    assert gxx, "g++ builds the port's host codec; it is needed here too"
    tmp = tmp_path_factory.mktemp("post")
    cpp, so = tmp / "run.cpp", tmp / "librun.so"
    cpp.write_text(_POST_RUN)
    subprocess.run([gxx, "-O2", "-std=c++17", "-Wall", "-Werror",
                    "-ffp-contract=off", "-shared", "-fPIC", "-I",
                    str(_build.CSRC), "-o", str(so), str(cpp)], check=True)
    lib = ctypes.CDLL(str(so))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.post_run.argtypes = [p, ll, ll, p, i, i, i, i, i, i, p, p, p, i, i]
    lib.post_pixels.argtypes = [i, i, i]
    return lib


def _aligned(shape, dtype, extra=0):
    """An array of `shape` starting on a 16-byte boundary (and `extra`
    elements in)."""
    n = int(np.prod(shape))
    size = np.dtype(dtype).itemsize
    buf = np.zeros(n + extra + 16, dtype)
    k = (-buf.ctypes.data % 16) // size
    return buf[k + extra:k + extra + n].reshape(shape)


def _host_codes(lib, x, spec, bits, down=1, scalar=False, pix=4):
    """post.cuh's walk on the (3, H, W) float32 view x, pix pixels a thread
    -> (codes, paths)."""
    from jxl_coder_tpu_torch.vardct import color
    _, h, w = x.shape
    out = _aligned((-(-h // down), -(-w // down), 3),
                   np.uint8 if bits <= 8 else np.uint16)
    prm = post._output_params(spec)
    trc = spec[1] if spec[0] == "enc" else 0
    paths = lib.post_run(x.ctypes.data, x.strides[0] // 4, x.strides[1] // 4,
                         out.ctypes.data, h, w, down, post.KIND[spec[0]],
                         trc, bits, prm.ctypes.data,
                         color._CONSTS.ctypes.data, color._MUL.ctypes.data,
                         int(scalar), pix)
    assert paths >= 0
    return out, paths


def _host_cases():
    """Seeded planes: widths 1-9 (ragged groups of 4), 70x131 and 64x128,
    each contiguous on a 16-byte boundary, and a view cropped out of wider
    planes one row and one column in (row stride past W, base off the
    boundary)."""
    for h, w in [(3, k) for k in range(1, 10)] + [(70, 131), (64, 128)]:
        for crop in (False, True):
            big = _xyb(h + 2, w + 5, h * 131 + w, hdr=True)
            if crop:
                x = _aligned(big.shape, np.float32)
                x[...] = big
                yield f"{w}x{h} cropped", x[:, 1:h + 1, 1:w + 1]
            else:
                x = _aligned((3, h, w), np.float32)
                x[...] = big[:, :h, :w]
                yield f"{w}x{h}", x


# the specs whose codes involve no pow, log or sqrt
_EXACT = ("srgb", "ycbcr", "linear")
_HOST_SPECS = dict(SPECS, ycbcr=("ycbcr",))


@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("key", list(_HOST_SPECS))
def test_kernel_walk_equals_the_twin_on_glibc_pow(post_host, key, bits,
                                                  monkeypatch):
    """A7's walk (post.cuh encode_group, 4 pixels a thread and 1) and
    S1's (encode_pooled, down 4), built with g++, through the launch's own
    plan and dispatch, on both the vector path (16-byte loads, word
    stores) and the scalar path, against encode_output_plain /
    encode_output_down_plain with the twin's pow made glibc's powf
    (ops/fp.py powf, the host build's): 0 codes differ, for every spec at
    8 and 16 bits."""
    from jxl_coder_tpu_torch.ops import fp
    spec = _HOST_SPECS[key] if key == "ycbcr" else _spec(key)
    monkeypatch.setattr(post, "_pow",
                        lambda v, e: fp.powf(v, float(np.float32(e))))
    seen = set()
    for what, x in _host_cases():
        t = torch.from_numpy(np.ascontiguousarray(x))
        ref = post.encode_output_plain(t, spec, bits).numpy()
        for scalar in (False, True):
            got, paths = _host_codes(post_host, x, spec, bits, scalar=scalar)
            seen.add(paths)
            assert np.array_equal(got, ref), (what, scalar)
        got, _ = _host_codes(post_host, x, spec, bits, pix=1)
        assert np.array_equal(got, ref), (what, "a pixel a thread")
        got, _ = _host_codes(post_host, x, spec, bits, down=4)
        assert np.array_equal(
            got, post.encode_output_down_plain(t, spec, bits, 4).numpy()), what
    # contiguous planes of a width that is a multiple of 4 take both vector
    # paths, a cropped view of one word stores alone (it loads one value at
    # a time), the other widths neither
    assert seen == {0, 2, 3}


@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("key", list(_HOST_SPECS))
def test_kernel_walk_against_the_twin(post_host, key, bits):
    """The same walk against the twin as it is (torch's CPU pow, log and
    sqrt): the specs without them (sRGB, YCbCr, linear) equal; the others
    within 1 code on at most 0.1% of codes, PQ at 16 bits on at most 0.2%
    (0.18% and 0.14% of these codes differ by 1 with sRGB and BT.2100
    primaries; every other spec 0.004% or less).  That bound is glibc's
    powf against torch's pow: the previous test shows the walk equal to
    the twin once the twin takes glibc's powf."""
    spec = _HOST_SPECS[key] if key == "ycbcr" else _spec(key)
    diffs, n = [], 0
    for what, x in _host_cases():
        got, _ = _host_codes(post_host, x, spec, bits)
        ref = post.encode_output_plain(
            torch.from_numpy(np.ascontiguousarray(x)), spec, bits).numpy()
        d = np.abs(got.astype(np.int64) - ref.astype(np.int64))
        diffs.append(d.reshape(-1))
    d = np.concatenate(diffs)
    if key in _EXACT:
        assert d.max() == 0
    else:
        share = 0.002 if key.startswith("pq") and bits == 16 else 0.001
        assert d.max() <= 1 and (d > 0).mean() <= share, (
            d.max(), (d > 0).mean())


def test_a_small_frame_takes_a_pixel_a_thread(post_host):
    """pixels_a_thread: 4 pixels a thread where the frame fills the card's
    resident threads at 4 a thread (on 132 SMs: 4K, FHD, the 1284x964
    frames of the upsampled post streams), else 1 (their 720x480 frames)."""
    for h, w in ((2160, 3840), (1080, 1920), (964, 1284)):
        assert post_host.post_pixels(h, w, 132) == 4
    for h, w in ((480, 720), (1, 1)):
        assert post_host.post_pixels(h, w, 132) == 1
    assert post_host.post_pixels(964, 1284, 160) == 1
