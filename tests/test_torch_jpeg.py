"""The JPEG routes of the PyTorch port on the CPU (the kernels' plain
twins) against the JAX package: ``construct`` / ``reconstruct_jpeg`` and
``api.decode`` of what they write.

Route 1 is a 4:4:4 (or grey) recompressed JPEG, a do_ycbcr VarDCT frame
(synthesis, kernel 2 with f32 out, A7's "ycbcr" case); route 2 a
chroma-subsampled one and route 3 the round-1 private container, both
through kernels J1 (the block IDCT) and J2 (chroma upsampling and
YCbCr -> RGB) of ``csrc/jpeg.cu``, whose twins are ``jpeg/pixels.py``.

Tolerances: construct's bytes and reconstruct's JPEG are equal; decoded
pixels are held to the 8-bit contract (at most 1 code, on under 0.1% of
values) and come out equal; J1's and J2's twins equal the JAX package's
``idct2d`` and the numpy tails of its render bit for bit; A7's "ycbcr"
twin is within 1 code on under 0.1% of values of the JAX package's device
output step (XLA may fuse its multiply-adds).
"""

import dataclasses
import io

import numpy as np
import pytest
import torch
from PIL import Image

from jxl_coder_tpu import api as ref_api
from jxl_coder_tpu.jpeg import transcode as ref_tc
from jxl_coder_tpu_torch import api, reference
from jxl_coder_tpu_torch.host.bitstream import container as C
from jxl_coder_tpu_torch.host.jpeg import transcode as TC
from jxl_coder_tpu_torch.host.jpeg.parser import ZIGZAG, parse_jpeg
from jxl_coder_tpu_torch.host.jpeg.writer import write_jpeg
from jxl_coder_tpu_torch.host.vardct.dec_real import ycbcr_planes_to_rgb
from jxl_coder_tpu_torch.jpeg import pixels as PX
from jxl_coder_tpu_torch.vardct import post
import port_fixtures as F

RGBA_8888 = int(api.PreferredColorConfig.RGBA_8888)


def _img(h=45, w=67, seed=4, noise=6.0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([120 + 60 * np.sin(yy / 11), 100 + 50 * np.cos(xx / 7),
                     80 + 40 * np.sin((xx + yy) / 13)], -1)
    return np.clip(base + rng.normal(0, noise, base.shape), 0,
                   255).astype(np.uint8)


def _pil(img, **kw):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", **kw)
    return buf.getvalue()


_Q16 = [min(3000, 16 + i * j * 7) for j in range(8) for i in range(8)]

# label: (the JPEG, whether construct writes the round-1 container)
JPEGS = {
    "pil_q85_444": lambda: _pil(_img(), quality=85, subsampling=0),
    "pil_q70_420": lambda: _pil(_img(), quality=70, subsampling=2),
    "pil_q90_422": lambda: _pil(_img(), quality=90, subsampling=1),
    "pil_q40_420": lambda: _pil(_img(noise=10), quality=40, subsampling=2),
    "pil_q98_444": lambda: _pil(_img(), quality=98, subsampling=0),
    "pil_grey": lambda: _pil(_img()[:, :, 0], quality=75),
    "pil_odd_420": lambda: _pil(_img(41, 53, noise=7), quality=70,
                                subsampling=2),
    "pil_restart": lambda: _pil(_img(48, 64), quality=60,
                                restart_marker_blocks=2),
    "pil_progressive_444": lambda: _pil(_img(), quality=80, progressive=True,
                                        subsampling=0),
    "pil_progressive_420": lambda: _pil(_img(), quality=75, progressive=True,
                                        subsampling=2),
    "pil_progressive_grey": lambda: _pil(_img()[:, :, 0], quality=70,
                                         progressive=True),
    "pil_q16_tables": lambda: _pil(_img(), qtables=[_Q16, _Q16],
                                   subsampling=2),
    "pil_optimized": lambda: _pil(_img(), quality=85, optimize=True),
    "fixture_444": lambda: F.baseline_jpeg(_img(), 90, 0),
    "fixture_422": lambda: F.baseline_jpeg(_img(), 90, 1),
    "fixture_420": lambda: F.baseline_jpeg(_img(37, 58), 80, 2),
    "fixture_grey": lambda: F.baseline_jpeg(_img(), 85, grey=True),
    "fixture_restart": lambda: F.baseline_jpeg(_img(), 90, 2, restart=3),
}
# the round-1 container (what construct writes when the wire format
# refuses a JPEG), written directly
ROUND1 = ("pil_q70_420", "pil_q85_444", "pil_grey", "fixture_422")
CASES = [(k, False) for k in JPEGS] + [(k, True) for k in ROUND1]
IDS = [k + ("-round1" if r1 else "") for k, r1 in CASES]


@pytest.fixture(scope="module")
def streams():
    """label -> (jpeg, the JAX package's JXL), made once."""
    out = {}
    for label, r1 in CASES:
        jpeg = JPEGS[label]()
        out[label, r1] = (jpeg, ref_tc.construct(jpeg) if r1
                          else ref_api.construct(jpeg))
    return out


def _within_contract(got: np.ndarray, ref: np.ndarray, what: str) -> None:
    assert got.shape == ref.shape and got.dtype == ref.dtype, what
    d = np.abs(got.astype(np.int64) - ref.astype(np.int64))
    assert d.max() <= 1 and (d > 0).mean() < 1e-3, (what, d.max(),
                                                     (d > 0).mean())


@pytest.mark.parametrize("label,r1", CASES, ids=IDS)
def test_construct_and_reconstruct_equal_the_reference(streams, label, r1):
    """The port's construct writes the JAX package's bytes, and
    reconstruct_jpeg gives the JPEG back byte for byte, as the JAX
    package's does."""
    jpeg, ref = streams[label, r1]
    data = TC.construct(jpeg) if r1 else api.construct(jpeg)
    assert data == ref
    assert api.reconstruct_jpeg(data) == jpeg
    assert ref_api.reconstruct_jpeg(data) == jpeg
    if not r1:
        assert C.extract_codestream(data).jpeg_reconstruction_data


def _route(data: bytes) -> int:
    if TC.is_constructed(data):
        return 3
    return 2 if api._subsampled_jpeg(data) else 1


@pytest.mark.parametrize("label,r1", CASES, ids=IDS)
def test_decode_equals_the_reference(streams, label, r1):
    """api.decode(device="cpu") against jxl_coder_tpu.api.decode, within
    the 8-bit contract, and the same BasicInfo; routes 2 and 3 against the
    float64 oracle too, route 1 against the float64 host decoder."""
    jpeg, data = streams[label, r1]
    got, info = api.decode(data, device="cpu")
    ref, ref_info = ref_api.decode(data)
    _within_contract(got, ref, label)
    assert dataclasses.asdict(info) == dataclasses.asdict(ref_info)
    route = _route(data)
    comps = parse_jpeg(jpeg).components
    subsampled = len(comps) > 1 and any((c.h, c.v) != (1, 1) for c in comps)
    assert route == (3 if r1 else 2 if subsampled else 1)
    oracle = (reference.decode_float64(data) if route == 1
              else reference.jpeg_pixels_float64(data))
    _within_contract(got, oracle, f"{label} float64")


@pytest.mark.parametrize("label,r1", [("pil_q70_420", False),
                                      ("fixture_422", False),
                                      ("pil_q85_444", True),
                                      ("pil_grey", True)])
def test_route_renders_equal_the_reference(streams, label, r1):
    """jpeg/wire.decode_subsampled_to_pixels and jpeg/transcode.
    decode_to_pixels (routes 2 and 3 without the api) equal the JAX
    package's functions of the same names."""
    from jxl_coder_tpu.jpeg import wire as ref_wire
    from jxl_coder_tpu_torch.jpeg import transcode as JTC
    from jxl_coder_tpu_torch.jpeg import wire as JWIRE
    data = streams[label, r1][1]
    if r1:
        got, ref = (JTC.decode_to_pixels(data, "cpu"),
                    ref_tc.decode_to_pixels(data))
    else:
        got, ref = (JWIRE.decode_subsampled_to_pixels(data, "cpu"),
                    ref_wire.decode_subsampled_to_pixels(data))
    _within_contract(got, ref, label)


@pytest.mark.parametrize("label,r1", [("pil_q70_420", False),
                                      ("pil_q85_444", True)])
def test_jpeg_routes_launch_no_synthesis(streams, monkeypatch, label, r1):
    """Routes 2 and 3 run J1 and J2 once each (their twins on the CPU),
    and no VarDCT synthesis or host float64 decode."""
    from jxl_coder_tpu_torch.vardct import synth
    calls = []
    for name in ("jpeg_idct_plain", "ycbcr_to_rgb_plain"):
        orig = getattr(PX, name)

        def wrapped(*a, _orig=orig, _name=name, **k):
            calls.append(_name)
            return _orig(*a, **k)
        monkeypatch.setattr(PX, name, wrapped)

    def refuse(*a, **k):
        raise AssertionError("synthesis on a JPEG route")
    monkeypatch.setattr(synth, "synth_family", refuse)
    monkeypatch.setattr(synth, "synth_dct8", refuse)
    api.decode(streams[label, r1][1], device="cpu")
    assert calls == ["jpeg_idct_plain", "ycbcr_to_rgb_plain"]


def test_route1_runs_a7_ycbcr(streams, monkeypatch):
    """A 4:4:4 recompressed JPEG's output step is A7's "ycbcr" case, after
    kernel 2 with f32 out."""
    specs = []
    orig = post.encode_output

    def wrapped(xyb, spec, bits):
        specs.append(spec)
        return orig(xyb, spec, bits)
    monkeypatch.setattr(post, "encode_output", wrapped)
    api.decode(streams["pil_q85_444", False][1], device="cpu")
    assert specs == [("ycbcr",)]


@pytest.mark.parametrize("label", ["pil_q85_444", "fixture_grey"])
def test_device_entropy_route_equals_the_host_route(streams, label):
    """construct's 4:4:4 and grey frames (ANS, no LZ77) decode on the
    device entropy route (its twin here) equal to the host route."""
    data = streams[label, False][1]
    assert np.array_equal(api.decode(data, device="cpu", entropy="device")[0],
                          api.decode(data, device="cpu")[0])


def test_decode_batch_equals_decode(streams):
    """A mixed batch of the three routes and a VarDCT still: each output
    equals decode's."""
    datas = [streams[k][1] for k in (("pil_q85_444", False),
                                     ("pil_q70_420", False),
                                     ("pil_grey", True),
                                     ("fixture_422", False))]
    datas.append(reference.encode_vardct(F.smooth_frame(40, 56),
                                         distance=1.0, effort=5))
    outs = api.decode_batch(datas, device="cpu")
    for out, data in zip(outs, datas):
        assert np.array_equal(out, api.decode(data, device="cpu")[0])


def _box8(px: np.ndarray) -> np.ndarray:
    h, w = px.shape[:2]
    th, tw = -(-h // 8), -(-w // 8)
    pad = px[np.minimum(np.arange(th * 8), h - 1)][
        :, np.minimum(np.arange(tw * 8), w - 1)].astype(np.float64)
    return pad.reshape(th, 8, tw, 8, -1).mean(axis=(1, 3))


def test_thumbnail_444_is_the_dc_in_ycbcr(streams):
    """A 4:4:4 recompressed JPEG's thumbnail is its DC image through A7's
    "ycbcr" case, equal to the float64 oracle and within 2 codes of the
    8x box of its full decode (the DC is each block's mean).  The JAX
    package reads the YCbCr DC as XYB there (R13): its thumbnail is far
    from the decode's box."""
    data = streams["pil_q85_444", False][1]
    thumb, info = api.decode_thumbnail(data, device="cpu")
    assert np.array_equal(thumb, reference.thumbnail_float64(data))
    full = api.decode(data, device="cpu")[0]
    box = _box8(full)
    assert thumb.shape == box.shape
    assert np.abs(thumb - box).max() <= 2
    ref_thumb = ref_api.decode_thumbnail(data)[0]
    assert np.abs(ref_thumb - box).mean() > 20
    assert dataclasses.asdict(info) == dataclasses.asdict(
        ref_api.decode_thumbnail(data)[1])


def test_thumbnail_420_decodes_whole(streams):
    """A subsampled recompressed JPEG's thumbnail: the JAX package raises
    (R12); the port decodes it whole and takes S2's 8x box of its codes."""
    data = streams["pil_q70_420", False][1]
    with pytest.raises(ref_api.InvalidJXLError):
        ref_api.decode_thumbnail(data)
    thumb, _ = api.decode_thumbnail(data, device="cpu")
    full = api.decode(data, device="cpu")[0]
    assert np.array_equal(thumb, np.rint(_box8(full)).astype(np.uint8))


def test_decode_frames_of_a_subsampled_jpeg(streams):
    """decode_frames of a subsampled recompressed JPEG is its one frame by
    the JPEG route; the JAX package reads the frame with one block grid and
    raises (R17).  A 4:4:4 one decodes in both."""
    data = streams["pil_q70_420", False][1]
    frames, durations, info = api.decode_frames(data, device="cpu")
    assert durations == [0] and len(frames) == 1
    assert np.array_equal(frames[0], api.decode(data, device="cpu")[0])
    with pytest.raises(ref_api.InvalidJXLError):
        ref_api.decode_frames(data)
    data = streams["pil_q85_444", False][1]
    _within_contract(api.decode_frames(data, device="cpu")[0][0],
                     ref_api.decode_frames(data)[0][0], "4:4:4 frames")


def test_round1_container_has_no_basic_info(streams):
    """The round-1 container has no codestream box: basic_info, the
    thumbnail and decode_sampled raise InvalidJXLError in both packages
    (decode makes its BasicInfo up)."""
    data = streams["pil_q70_420", True][1]
    for fn in (lambda d: api.decode_thumbnail(d, device="cpu"),
               lambda d: api.decode_sampled(d, 10, 10, device="cpu"),
               api.basic_info):
        with pytest.raises(api.InvalidJXLError):
            fn(data)
    with pytest.raises(ref_api.InvalidJXLError):
        ref_api.decode_thumbnail(data)


@pytest.mark.parametrize("label", ["pil_q85_444", "pil_q70_420"])
def test_decode_sampled_routes(streams, monkeypatch, label):
    """decode_sampled at the thumbnail size, at the quarter size (4:4:4: S1
    with "ycbcr", equal in shape and within the contract of the JAX
    package's device route; 4:2:0: ineligible, a full decode, as the JAX
    package) and at a larger size, against the JAX package where it does
    not raise."""
    data = streams[label, False][1]
    h, w = 45, 67
    quarter = api._decode_downsampled(data, 4, device="cpu")
    if label.endswith("420"):
        assert quarter is None
    else:
        monkeypatch.setenv("JXL_TPU_DEVICE", "1")
        monkeypatch.setenv("JXL_TPU_DEVICE_STRICT", "1")
        ref_q = ref_api._decode_downsampled(data, 4)[0]
        _within_contract(quarter[0], ref_q, "quarter")
        monkeypatch.setenv("JXL_TPU_DEVICE", "0")
        monkeypatch.setenv("JXL_TPU_DEVICE_STRICT", "0")
    for tw, th in ((-(-w // 8), -(-h // 8)), (-(-w // 4), -(-h // 4)),
                   (40, 30)):
        out, info = api.decode_sampled(data, tw, th, RGBA_8888,
                                       device="cpu")
        assert out.shape[-1] == 4 and out.dtype == np.uint8
        if (tw, th) == (40, 30):
            ref = ref_api.decode_sampled(data, tw, th, RGBA_8888)[0]
            assert out.shape == ref.shape
            d = np.abs(out.astype(int) - ref.astype(int))
            assert d.max() <= 2 and (d > 1).mean() < 1e-3


def test_entry_points_refuse_what_is_not_a_jpeg():
    plain = reference.encode_vardct(F.smooth_frame(16, 16), distance=1.0,
                                    effort=5)
    with pytest.raises(api.InvalidJXLError):
        api.reconstruct_jpeg(plain)
    with pytest.raises(api.InvalidJXLError):
        api.construct(b"\xff\xd8\xff\xd9")


def test_multi_dri_jpeg_is_refused():
    """A JPEG that redefines its restart interval cannot be represented
    (jbrd stores one), in both packages."""
    jpeg = F.baseline_jpeg(_img(), 90, 0, restart=2)
    dri = jpeg.index(b"\xff\xdd")
    sos = jpeg.index(b"\xff\xda")
    twice = jpeg[:sos] + jpeg[dri:dri + 6] + jpeg[sos:]
    with pytest.raises(api.InvalidJXLError):
        api.construct(twice)
    with pytest.raises(ref_api.InvalidJXLError):
        ref_api.construct(twice)


def test_subsampled_frame_without_jbrd_raises(streams):
    """A subsampled YCbCr frame whose jbrd box is gone is not a
    recompressed JPEG: the port's VarDCT path raises NotImplementedError
    naming the ROADMAP item (its synthesis takes one block grid)."""
    data = streams["pil_q70_420", False][1]
    bare = C.extract_codestream(data).codestream
    with pytest.raises(NotImplementedError, match="without jbrd"):
        api.decode(bare, device="cpu")


# ---- the fixture writer ---------------------------------------------------

@pytest.mark.parametrize("kw", [dict(subsampling=0), dict(subsampling=1),
                                dict(subsampling=2), dict(grey=True),
                                dict(subsampling=2, restart=4),
                                dict(quality=30, subsampling=0)],
                         ids=["444", "422", "420", "grey", "restart", "q30"])
def test_baseline_jpeg_fixture(kw):
    """port_fixtures.baseline_jpeg writes a JPEG that PIL decodes within 2
    codes of the port's route-2 / route-3 decode (4:4:4 and grey take
    route 3: no chroma upsampling to differ in), and that parse_jpeg ->
    write_jpeg gives back byte for byte."""
    jpeg = F.baseline_jpeg(_img(53, 77), **kw)
    assert write_jpeg(parse_jpeg(jpeg)) == jpeg
    pil = np.asarray(Image.open(io.BytesIO(jpeg)).convert("RGB"))
    if kw.get("subsampling") in (1, 2):
        data = api.construct(jpeg)
        assert api._subsampled_jpeg(data)
    else:
        data = TC.construct(jpeg)
    got = api.decode(data, device="cpu")[0]
    assert got.shape == pil.shape
    assert np.abs(got.astype(int) - pil.astype(int)).max() <= 2


# ---- the kernels' twins ---------------------------------------------------

def _seeded_components(rng, grids):
    coeffs, quant = [], []
    for bh, bw in grids:
        c = rng.integers(-60, 60, (bh, bw, 64))
        c[:, :, 0] = rng.integers(-1000, 1000, (bh, bw))
        c[:, :, 20:] *= rng.random((bh, bw, 44)) < 0.2
        coeffs.append(c)
        quant.append(rng.integers(1, 120, 64).astype(np.float32))
    flat = np.concatenate([c.reshape(-1) for c in coeffs]).astype(np.int16)
    return coeffs, flat, np.stack(quant)


@pytest.mark.parametrize("grids", [[(1, 1)], [(3, 5), (2, 3), (2, 3)],
                                   [(7, 2), (7, 1), (4, 1), (9, 9)]],
                         ids=["1x1", "420", "ragged4"])
def test_j1_twin_equals_jax_idct(grids):
    """J1's twin: each plane equals the JAX package's dequant, de-zigzag,
    idct2d and +128 (jpeg/wire.py:739-748) bit for bit."""
    import jax.numpy as jnp
    from jxl_coder_tpu.vardct.dct import idct2d
    rng = np.random.default_rng(len(grids))
    coeffs, flat, quant = _seeded_components(rng, grids)
    got = PX.jpeg_idct(torch.from_numpy(flat), grids, torch.from_numpy(quant))
    for c, (bh, bw) in enumerate(grids):
        deq = coeffs[c].astype(np.float32) * quant[c][None, None, :]
        blocks = np.zeros((bh, bw, 64), np.float32)
        blocks[:, :, ZIGZAG] = deq
        pix = np.asarray(idct2d(jnp.asarray(blocks.reshape(bh, bw, 8, 8))))
        ref = pix.transpose(0, 2, 1, 3).reshape(bh * 8, bw * 8) + 128.0
        assert got[c].shape == ref.shape
        assert np.array_equal(got[c].numpy(), ref)


def _ref_triangle(plane, hs, vs):
    """jpeg/wire.py:757-767, numpy f32."""
    for axis, s in ((1, hs), (0, vs)):
        for _ in range(s):
            p = np.moveaxis(plane, axis, 0)
            up = np.empty((p.shape[0] * 2,) + p.shape[1:], p.dtype)
            prev = np.vstack([p[:1], p[:-1]])
            nxt = np.vstack([p[1:], p[-1:]])
            up[0::2] = (3 * p + prev) / 4
            up[1::2] = (3 * p + nxt) / 4
            plane = np.moveaxis(up, 0, axis)
    return plane


def _planes(rng, h, w, factors):
    return [(rng.random((-(-h // fy), -(-w // fx))) * 300 - 20).astype(
        np.float32) for fy, fx in factors]


@pytest.mark.parametrize("shift", [(0, 0), (1, 0), (0, 1), (1, 1)],
                         ids=["1x1", "2x1", "1x2", "2x2"])
@pytest.mark.parametrize("size", [(1, 1), (9, 13), (16, 7)])
def test_j2_twin_triangle_equals_the_reference(shift, size):
    """J2's twin in the wire route's mode (triangle, +0.5) equals
    jpeg/wire.py:749-769's numpy for every shift pair, from 1x1 up."""
    h, w = size
    hs, vs = shift
    rng = np.random.default_rng(h * 31 + w + 7 * hs + vs)
    factors = [(1, 1), (1 << vs, 1 << hs), (1 << vs, 1 << hs)]
    planes = _planes(rng, h, w, factors)
    got = PX.ycbcr_to_rgb([torch.from_numpy(p) for p in planes], factors, h,
                          w, True, True).numpy()
    up = [planes[0][:h, :w]] + [_ref_triangle(p, hs, vs)[:h, :w]
                                for p in planes[1:]]
    y, cb, cr = up[0], up[1] - 128.0, up[2] - 128.0
    r = y + 1.402 * cr
    g = y - 0.344136 * cb - 0.714136 * cr
    b = y + 1.772 * cb
    ref = np.clip(np.stack([r, g, b], axis=-1) + 0.5, 0, 255).astype(np.uint8)
    assert np.array_equal(got, ref)


@pytest.mark.parametrize("factors", [[(1, 1)] * 3, [(1, 1), (2, 2), (2, 2)],
                                     [(1, 1), (1, 4), (1, 4)], [(1, 1)]],
                         ids=["444", "420", "411", "grey"])
def test_j2_twin_nearest_equals_the_reference(factors):
    """J2's twin in the round-1 route's mode (nearest, no +0.5) equals
    jpeg/transcode.py:264-282's numpy, a grey image repeating Y."""
    h, w = 11, 19
    rng = np.random.default_rng(len(factors) + factors[-1][1])
    planes = _planes(rng, h, w, factors)
    got = PX.ycbcr_to_rgb([torch.from_numpy(p) for p in planes], factors, h,
                          w, False, False).numpy()
    up = [np.repeat(np.repeat(p, fy, axis=0), fx, axis=1)[:h, :w]
          for p, (fy, fx) in zip(planes, factors)]
    if len(up) == 1:
        y = np.clip(up[0], 0, 255)
        ref = np.repeat(y[:, :, None], 3, axis=2).astype(np.uint8)
    else:
        y, cb, cr = up[0], up[1] - 128.0, up[2] - 128.0
        r = y + 1.402 * cr
        g = y - 0.344136 * cb - 0.714136 * cr
        b = y + 1.772 * cb
        ref = np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)
    assert np.array_equal(got, ref)


def test_j2_refuses_a_triangle_factor_above_2():
    p = torch.zeros((2, 2))
    with pytest.raises(ValueError):
        PX.ycbcr_to_rgb([p, p, p], [(1, 1), (1, 4), (1, 4)], 2, 8, True,
                        True)


@pytest.mark.parametrize("bits", [8, 16])
def test_a7_ycbcr_twin_against_the_reference(bits):
    """A7's "ycbcr" twin against the JAX package's device output step
    (tpu_full._encode_output_device, ("ycbcr",))."""
    from jxl_coder_tpu.vardct import tpu_full as TF
    rng = np.random.default_rng(bits)
    xyb = (rng.random((3, 37, 53)) - 0.5).astype(np.float32)
    xyb[1] *= 1.1
    got = post.encode_output(torch.from_numpy(xyb), ("ycbcr",), bits).numpy()
    ref = np.asarray(TF._encode_output_device(xyb[0], xyb[1], xyb[2],
                                              ("ycbcr",), bits))
    _within_contract(got, ref, "a7 ycbcr")
    host = ycbcr_planes_to_rgb(xyb[0], xyb[1], xyb[2], bits)
    assert np.array_equal(got, host)


def test_package_exports_the_transcoders():
    import jxl_coder_tpu_torch as P
    assert P.construct is api.construct
    assert P.reconstruct_jpeg is api.reconstruct_jpeg
