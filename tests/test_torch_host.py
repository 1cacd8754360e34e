"""The port's own host layers (jxl_coder_tpu_torch/host) vs the JAX
package's, which they copy: the parse state, the host encoder's bytes,
the native host codec the port builds, the float64 host decode, and the
Modular copies (the forward transforms, the frame decoder, the codec's
Modular frame decode).
All of them are integer or float64 paths with the same code, so every
comparison is exact; so are the post stages' host copies (noise,
upsampling, the transfer functions, gamut matrices and the inverse
Modular transforms), the host encoder's bytes under each of its
options, and the float64 decode of noise, alpha and upsampled frames.
The one exception: XLA's own exp and log in the HLG transfer functions,
against correctly rounded ones in the copy, within two ulps.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest

from jxl_coder_tpu import api as jax_api
from jxl_coder_tpu import native as jax_native
from jxl_coder_tpu.bitstream import container as jax_container
from jxl_coder_tpu.bitstream.frame_header import (read_frame_header as
                                                  jax_read_frame_header,
                                                  read_toc as jax_read_toc)
from jxl_coder_tpu.bitstream.headers import read_image_header as jax_rih
from jxl_coder_tpu.bitstream.reader import BitReader as JaxBitReader
from jxl_coder_tpu.vardct import dec_real as jax_dec
from jxl_coder_tpu.vardct.enc_real import encode_vardct_real as jax_encode
from jxl_coder_tpu_torch import _build, api, reference
from jxl_coder_tpu_torch.host import native as port_native
from jxl_coder_tpu_torch.host.bitstream.reader import BitReader
from jxl_coder_tpu_torch.host.vardct import dec_real as port_dec
from jxl_coder_tpu_torch.modular import device as MDEV
from jxl_coder_tpu_torch.vardct.parse import parse_frame
import port_fixtures as F
from port_fixtures import bench_frame, sharp_frame, smooth_frame

# (image, distance, effort): all DCT8 at effort 2; a ragged two-group
# frame at effort 5; the special 1-block transforms at effort 7
STREAMS = {
    "e2": (lambda: smooth_frame(72, 104), 1.0, 2),
    "e5_ragged": (lambda: bench_frame(261, 333), 2.5, 5),
    "e7_sharp": (lambda: sharp_frame(137, 203), 1.0, 7),
}


def _stream(key):
    make, distance, effort = STREAMS[key]
    return reference.encode_vardct(make(), distance=distance, effort=effort)


def _jax_read_frame(data):
    """The JAX package's own container, header and TOC reads."""
    cs = jax_container.extract_codestream(data).codestream
    br = JaxBitReader(cs)
    hdr = jax_rih(br)
    fh = jax_read_frame_header(br, hdr)
    ng, ndc = fh.counts(hdr)
    n = 1 if (ng == 1 and fh.passes.num_passes == 1) else (
        2 + ndc + ng * fh.passes.num_passes)
    return cs, hdr, fh, jax_read_toc(br, n)


def _raster(ba):
    """A BlockArrays' blocks in raster order: (ids, bxs, bys, ncv, every
    block's coefficients concatenated)."""
    order = np.lexsort((ba.bxs, ba.bys))
    coeffs = np.concatenate([ba.coeffs[ba.offs[i]:ba.offs[i + 1]]
                             for i in order])
    return (ba.ids[order], ba.bxs[order], ba.bys[order], ba.ncv[order],
            coeffs)


@pytest.mark.parametrize("key", list(STREAMS))
def test_parse_state_equals_the_jax_parse_only_state(monkeypatch, key):
    data = _stream(key)
    # dec_real returns its parse-only state only with the device switch on
    monkeypatch.setenv("JXL_TPU_DEVICE", "1")
    ref = jax_dec.decode_vardct_frame(*_jax_read_frame(data),
                                      parse_only=True)
    got = parse_frame(*api._read_frame(data))
    assert isinstance(ref, dict) and set(got) == set(ref)
    for k in ("qf_map", "sharp_map", "ytox_glob", "ytob_glob"):
        assert got[k].dtype == ref[k].dtype
        assert np.array_equal(got[k], ref[k]), k
    for c in range(3):
        assert np.array_equal(got["dc_glob"][c], ref["dc_glob"][c])
    for k in ("bits", "h", "w"):
        assert got[k] == ref[k]
    # dec_real concatenates its AC groups in the order its threads finish
    a, b = _raster(got["blocks_glob"]), _raster(ref["blocks_glob"])
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    # the copies are other classes: compare their fields
    lf_a, lf_b = got["lf"], ref["lf"]
    for f in dataclasses.fields(lf_b):
        if f.name not in ("gtree", "gcode", "mfd"):
            x, y = getattr(lf_a, f.name), getattr(lf_b, f.name)
            if dataclasses.is_dataclass(y):
                x, y = dataclasses.astuple(x), dataclasses.astuple(y)
            assert x == y, f.name
    rf_a, rf_b = got["fh"].restoration_filter, ref["fh"].restoration_filter
    assert vars(rf_a) == vars(rf_b)


@pytest.mark.parametrize("kwargs", [
    dict(make=lambda: smooth_frame(72, 104), distance=1.0, effort=2),
    dict(make=lambda: sharp_frame(137, 203), distance=1.0, effort=7),
    dict(make=lambda: bench_frame(261, 333), distance=2.5, effort=5,
         progressive=True),
], ids=["e2", "e7_sharp", "e5_ragged_progressive"])
def test_encoder_copy_writes_the_jax_host_encoders_bytes(monkeypatch,
                                                         kwargs):
    kwargs = dict(kwargs)
    img = kwargs.pop("make")()
    monkeypatch.setenv("JXL_TPU_DEVICE", "0")     # its host branch
    assert reference.encode_vardct(img, **kwargs) == jax_encode(img,
                                                                **kwargs)


def test_port_built_host_codec_decodes_an_ac_group_as_the_jax_native_path():
    assert jax_native.get_lib() is not None
    # the port's library: built from its own copy into the build
    # directory, not the JAX package's
    lib = port_native.get_lib()
    assert Path(lib._name).parent == _build.BUILD_DIR
    assert Path(jax_native.get_lib()._name).parent != _build.BUILD_DIR

    data = _stream("e5_ragged")
    out = []
    for dec, (cs, hdr, fh, toc), Reader in (
            (port_dec, api._read_frame(data), BitReader),
            (jax_dec, _jax_read_frame(data), JaxBitReader)):
        def section(i):
            s = toc.section(i)
            return Reader(cs[s.offset:s.offset + s.size])
        w, h = fh.coded_size(hdr)
        ng, ndc = fh.counts(hdr)
        lf = dec.read_lf_global(section(0), fh, hdr, w, h)
        lg = dec.read_lf_group(section(1), lf, min(256, -(-w // 8)),
                               min(256, -(-h // 8)), 0, ndc)
        hf = dec.read_hf_global(section(1 + ndc), lf, ng, 1, ndc)
        sub = dec._lf_group_view(lg, 0, 0, 32, 32)
        dc_q = np.stack([sub.dc.channels[i].data for i in (1, 0, 2)])
        br = section(2 + ndc)
        histo = br.u((hf.num_histograms - 1).bit_length()) \
            if hf.num_histograms > 1 else 0
        out.append(dec.read_pass_group(br, lf, hf, sub, 32, 32, 0, histo,
                                       dc_q, as_arrays=True))
    for f in ("ids", "bxs", "bys", "ncv", "offs", "coeffs"):
        assert np.array_equal(getattr(out[0], f), getattr(out[1], f)), f


@pytest.mark.parametrize("bits16", [False, True])
def test_float64_reference_equals_the_jax_host_decode(monkeypatch, bits16):
    img = bench_frame(90, 150)
    data = reference.encode_vardct(img, distance=1.0, effort=5,
                                   bit_depth=16 if bits16 else None)
    monkeypatch.setenv("JXL_TPU_DEVICE", "0")
    ref, _ = jax_api.decode(data)
    got = reference.decode_float64(data)
    assert got.dtype == (np.uint16 if bits16 else np.uint8)
    assert got.dtype == ref.dtype and np.array_equal(got, ref)


def test_host_codec_build_failure_raises(monkeypatch, tmp_path):
    """A host codec that cannot be built raises; nothing falls back."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    broken = tmp_path / "src"
    broken.mkdir()
    (broken / "hostcodec.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(_build, "HOST_SRC", broken)
    _build.load_host.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            _build.load_host("hostcodec")
        monkeypatch.setenv("PATH", str(tmp_path))
        with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
            _build.load_host("hostcodec")
    finally:
        _build.load_host.cache_clear()
    assert not list((tmp_path / "build").glob("*.so"))


# ---- the Modular host copies: forward transforms, frame decoder, codec ----

def _modular_pair(rng, n=3, h=19, w=27):
    """The same seeded channels as a JAX-package and a port ModularImage."""
    from jxl_coder_tpu.modular.image import Channel as RC, ModularImage as RI
    from jxl_coder_tpu_torch.host.modular.image import Channel, ModularImage
    planes = [rng.integers(-900, 900, (h, w)).astype(np.int32)
              for _ in range(n)]
    return (RI([RC(w, h, data=p.copy()) for p in planes]),
            ModularImage([Channel(w, h, data=p.copy()) for p in planes]))


def _same_channels(a, b):
    assert a.nb_meta_channels == b.nb_meta_channels
    assert len(a.channels) == len(b.channels)
    for x, y in zip(a.channels, b.channels):
        assert (x.width, x.height, x.hshift, x.vshift) == \
            (y.width, y.height, y.hshift, y.vshift)
        assert x.data.dtype == y.data.dtype and np.array_equal(x.data, y.data)


@pytest.mark.parametrize("rct_type", range(42))
def test_rct_forward_copy_equals_the_original(rct_type):
    from jxl_coder_tpu.modular import transform as RT
    from jxl_coder_tpu_torch.host.modular import transform as PT
    ref, port = _modular_pair(np.random.default_rng(rct_type))
    RT.rct_forward(ref, RT.Transform(id=0, rct_type=rct_type))
    PT.rct_forward(port, PT.Transform(id=0, rct_type=rct_type))
    _same_channels(ref, port)


@pytest.mark.parametrize("kind", ["palette", "squeeze", "squeeze_odd"])
def test_palette_and_squeeze_forward_copies_equal_the_originals(kind):
    from jxl_coder_tpu.modular import transform as RT
    from jxl_coder_tpu_torch.host.modular import transform as PT
    rng = np.random.default_rng(4)
    ref, port = _modular_pair(rng, h=33 if kind == "squeeze_odd" else 32,
                              w=17 if kind == "squeeze_odd" else 40)
    if kind == "palette":
        cols = rng.integers(0, 50, (3, 7))
        pick = rng.integers(0, 7, (32, 40))
        for img in (ref, port):
            for c in range(3):
                img.channels[c].data = cols[c][pick].astype(np.int32)
        RT.palette_forward(ref, RT.Transform(id=1, num_c=3, nb_colours=7))
        PT.palette_forward(port, PT.Transform(id=1, num_c=3, nb_colours=7))
    else:
        rt, pt = RT.Transform(id=2), PT.Transform(id=2)
        RT.squeeze_forward(ref, rt)
        PT.squeeze_forward(port, pt)
        assert [dataclasses.asdict(s) for s in rt.squeezes] == \
            [dataclasses.asdict(s) for s in pt.squeezes]
    _same_channels(ref, port)


MODULAR_STREAMS = {
    # a JAX api.encode stream of two groups; the port's fixture writers:
    # group-local RCT in six groups, a palette over four groups, a squeeze
    "jax_two_groups": lambda: jax_api.encode(smooth_frame(21, 1030),
                                             lossless=True, effort=2),
    "group_rct": lambda: F.group_rct_still(bench_frame(140, 270)),
    "palette_groups": lambda: F.modular_still(F.posterized_frame(140, 150),
                                              palette=True, group_shift=0),
    "squeezed": lambda: F.squeezed_still(bench_frame(40, 52)),
}


@pytest.mark.parametrize("key", list(MODULAR_STREAMS))
def test_modular_frame_decode_copy_equals_the_original(monkeypatch, key):
    """host/codec.py decode_modular_frame (channel planes on the host,
    host/modular/frame.py's deferred group chains undone on the CPU
    device) against jxl_coder_tpu.codec.decode_modular_frame."""
    from jxl_coder_tpu import codec as ref_codec
    from jxl_coder_tpu_torch.host import codec as port_codec
    monkeypatch.delenv("JXL_TPU_MODULAR_DEVICE", raising=False)
    data = MODULAR_STREAMS[key]()
    ref = ref_codec.decode_modular_frame(*_jax_read_frame(data))
    cs, hdr, fh, toc = api._read_frame(data)
    assert [(c.width, c.height) for c in port_codec.frame_channel_layout(
        hdr, fh).channels] == [(c.width, c.height) for c in
                               ref_codec.frame_channel_layout(
                                   *_jax_read_frame(data)[1:3]).channels]
    raw, dc_quant = port_codec.decode_modular_frame(cs, hdr, fh, toc)
    planes = MDEV.undo_frame(raw, "cpu")
    assert dc_quant == port_codec.DEFAULT_DC_QUANT
    assert len(planes) == len(ref)
    for a, b in zip(planes, ref):
        assert a.device.type == "cpu" and np.array_equal(a.numpy(), b)


def test_frame_decoder_defers_the_group_chains():
    """The port's frame decoder hands over the group streams' raw (RCT'd)
    planes and one recorded chain per group; the device layer undoes
    them."""
    from jxl_coder_tpu_torch.host.bitstream.reader import BitReader
    from jxl_coder_tpu_torch.host.modular.frame import ModularFrameDecoder
    img = bench_frame(140, 270)
    cs, hdr, fh, toc = api._read_frame(F.group_rct_still(img))
    ng, ndc = fh.counts(hdr)
    mfd = ModularFrameDecoder.for_frame(hdr, fh, None, None, True,
                                        *fh.coded_size(hdr))
    sec = toc.section(0)
    br = BitReader(cs[sec.offset:sec.offset + sec.size])
    assert br.bool() and not br.bool()     # default DC quant, no tree
    mfd.read_global(br)
    for gi in range(ng):
        sec = toc.section(2 + ndc + gi)
        mfd.read_group(BitReader(cs[sec.offset:sec.offset + sec.size]), gi,
                       ndc, ng)
    assert len(mfd.chains) == ng
    assert [c.header.transforms[0].rct_type for c in mfd.chains] == \
        [(6 + 5 * g) % 42 for g in range(ng)]
    raw = np.stack([c.data for c in mfd.image.channels], -1)
    assert not np.array_equal(raw, img)
    out = np.stack([p.numpy() for p in MDEV.undo_frame(mfd.planes(), "cpu")],
                   -1)
    assert np.array_equal(out, img)


# ---- the post stages' host copies (PR 9) ----

def test_noise_copy_equals_the_original():
    from jxl_coder_tpu.vardct import noise as RN
    from jxl_coder_tpu_torch.host.vardct import noise as PN
    for w, h in ((1, 1), (300, 270), (513, 260), (17, 600)):
        assert np.array_equal(RN.noise_planes(w, h).view(np.int32),
                              PN.noise_planes(w, h).view(np.int32))
    rng = np.random.default_rng(9)
    planes = [rng.normal(0.2, 0.2, (37, 45)).astype(np.float32)
              for _ in range(3)]
    lut = list(rng.random(8) * 0.4)
    a = RN.add_noise(*[p.copy() for p in planes], lut)
    b = PN.add_noise(*[p.copy() for p in planes], lut)
    for x, y in zip(a, b):
        assert np.array_equal(x, y)
    from jxl_coder_tpu_torch.host.bitstream.writer import BitWriter
    w = BitWriter()
    for v in range(0, 1024, 130):
        w.u(v, 10)
    data = w.to_bytes()
    assert RN.read_noise_lut(JaxBitReader(data)) == \
        PN.read_noise_lut(BitReader(data))


@pytest.mark.parametrize("n", [2, 4, 8])
def test_upsample_copy_equals_the_original(n):
    from jxl_coder_tpu.ops import upsample as RU
    from jxl_coder_tpu_torch.host.ops import upsample as PU
    p = np.random.default_rng(n).random((23, 31)).astype(np.float32)
    assert np.array_equal(RU.upsample_plane(p, n), PU.upsample_plane(p, n))
    w = tuple(np.linspace(-0.05, 0.6, 15))
    assert np.array_equal(RU.upsample_plane(p, 2, w),
                          PU.upsample_plane(p, 2, w))


TRC_PAIRS = ["srgb", "bt709", "pq", "hlg", "dci"]


@pytest.mark.parametrize("name", TRC_PAIRS)
def test_transfer_function_copies_round_as_the_originals(name):
    """Both directions on every 8- and 16-bit code and a sweep of linear
    values: equal bit for bit (glibc powf, the originals' float64 numpy
    steps), HLG within two ulps (XLA's exp and log, one ulp from the
    correctly rounded ones, then a sum and a division)."""
    import jax.numpy as jnp
    from jxl_coder_tpu.ops import color as RC
    from jxl_coder_tpu_torch.host.ops import color as PC
    codes = np.concatenate([np.arange(256) / 255.0,
                            np.arange(65536) / 65535.0])
    lin = np.concatenate([np.linspace(0, 40, 100001),
                          np.geomspace(1e-8, 1, 50001)]).astype(np.float32)
    ulps = 2 if name == "hlg" else 0
    for fn, x in ((f"{name}_to_linear", codes), (f"linear_to_{name}", lin)):
        a = np.asarray(getattr(RC, fn)(jnp.asarray(x) if x is lin else x))
        b = getattr(PC, fn)(x)
        assert a.dtype == b.dtype == np.float32
        d = np.abs(a.view(np.int32).astype(np.int64)
                   - b.view(np.int32).astype(np.int64))
        assert d.max() <= ulps, (fn, d.max())


def test_gamut_copies_equal_the_originals():
    from jxl_coder_tpu.ops import color as RC
    from jxl_coder_tpu_torch.host.ops import color as PC
    assert PC.PRIMARIES == RC.PRIMARIES
    for prim in RC.PRIMARIES.values():
        for white in (RC.ILLUMINANT_D65, RC.ILLUMINANT_DCI, RC.ILLUMINANT_E):
            assert np.array_equal(PC.gamut_rgb_to_xyz(prim, white),
                                  RC.gamut_rgb_to_xyz(prim, white))
            assert np.array_equal(PC.gamut_xyz_to_rgb(prim, white),
                                  RC.gamut_xyz_to_rgb(prim, white))


@pytest.mark.parametrize("kind", ["rct", "palette", "squeeze"])
def test_inverse_transform_copies_equal_the_originals(kind):
    from jxl_coder_tpu.modular import transform as RT
    from jxl_coder_tpu_torch.host.modular import transform as PT
    rng = np.random.default_rng(5)
    ref, port = _modular_pair(rng, h=29, w=35)
    if kind == "palette":
        cols = rng.integers(0, 50, (3, 7))
        pick = rng.integers(0, 7, (29, 35))
        for img in (ref, port):
            for c in range(3):
                img.channels[c].data = cols[c][pick].astype(np.int32)
    fwd = {"rct": ("rct_forward", dict(id=0, rct_type=13)),
           "palette": ("palette_forward", dict(id=1, num_c=3, nb_colours=7)),
           "squeeze": ("squeeze_forward", dict(id=2))}[kind]
    inv = {"rct": "rct_inverse", "palette": "palette_inverse",
           "squeeze": "squeeze_inverse"}[kind]
    rt, pt = RT.Transform(**fwd[1]), PT.Transform(**fwd[1])
    getattr(RT, fwd[0])(ref, rt)
    getattr(PT, fwd[0])(port, pt)
    getattr(RT, inv)(ref, rt)
    getattr(PT, inv)(port, pt)
    _same_channels(ref, port)


def _ce(mod, trc=13, prim=1, gamma=None):
    ce = mod.ColourEncoding()
    ce.transfer_function, ce.primaries = trc, prim
    if gamma is not None:
        ce.have_gamma, ce.gamma = True, int(round(gamma * 1e7))
    return ce


ENCODER_OPTIONS = {
    "alpha8": lambda img, img16, H: (img, dict(
        alpha=np.arange(img.shape[0] * img.shape[1]).reshape(
            img.shape[:2]) % 256)),
    "alpha16_two_groups": lambda img, img16, H: (
        np.concatenate([img16] * 3, 1), dict(alpha=np.tile(
            np.arange(img.shape[1] * 3) * 211 % 65536, (img.shape[0], 1)))),
    "uint16": lambda img, img16, H: (img16, {}),
    "float": lambda img, img16, H: (img16 / 65535.0, {}),
    "noise": lambda img, img16, H: (img, dict(
        noise_lut=reference.photon_noise_lut(3200))),
    "pq_2100": lambda img, img16, H: (img16, dict(
        colour=_ce(H, 16, 9), intensity_target=4000.0)),
    "hlg_2100": lambda img, img16, H: (img, dict(
        colour=_ce(H, 18, 9), intensity_target=1000.0)),
    "bt709": lambda img, img16, H: (img, dict(colour=_ce(H, 1, 1))),
    "linear": lambda img, img16, H: (img16, dict(colour=_ce(H, 8, 1))),
    "srgb_2020": lambda img, img16, H: (img, dict(colour=_ce(H, 13, 9))),
    "gamma": lambda img, img16, H: (img, dict(colour=_ce(H, gamma=1 / 2.2))),
}


@pytest.mark.parametrize("option", list(ENCODER_OPTIONS))
def test_encoder_copy_writes_the_jax_bytes_under_each_option(monkeypatch,
                                                             option):
    """The card has no JAX: its streams with alpha, colour encodings,
    16-bit or float input and noise come from this copy."""
    from jxl_coder_tpu.bitstream import headers as JH
    from jxl_coder_tpu_torch.host.bitstream import headers as PH
    monkeypatch.setenv("JXL_TPU_DEVICE", "0")     # its host branch
    img = smooth_frame(72, 104)
    img16 = img.astype(np.uint16) * 257 + np.arange(
        104, dtype=np.uint16)[None, :, None]
    px, kw_p = ENCODER_OPTIONS[option](img, img16, PH)
    _, kw_j = ENCODER_OPTIONS[option](img, img16, JH)
    assert reference.encode_vardct(px, distance=1.0, effort=7, **kw_p) == \
        jax_encode(px, distance=1.0, effort=7, **kw_j)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_encoder_copy_writes_the_jax_bytes_of_an_upsampled_frame(
        monkeypatch, n):
    """fh with upsampling n and hdr at the full size: the frame coded at
    1/n (the route chip_smoke.py's upsampled streams take)."""
    from jxl_coder_tpu.bitstream import frame_header as JF, headers as JH
    from jxl_coder_tpu_torch.host.bitstream import (frame_header as PF,
                                                    headers as PH)
    monkeypatch.setenv("JXL_TPU_DEVICE", "0")
    H, W = 21 * n + 3, 17 * n + 5
    small = smooth_frame(H, W)[::n, ::n]
    streams = []
    for hm, fm, enc in ((PH, PF, reference.encode_vardct),
                        (JH, JF, jax_encode)):
        m = hm.ImageMetadata()
        m.bit_depth = hm.BitDepth(False, 8, 0)
        hdr = hm.ImageHeader(size=hm.SizeHeader(xsize=W, ysize=H),
                             metadata=m)
        streams.append(enc(small, distance=1.0, effort=7,
                           fh=fm.FrameHeader(upsampling=n), hdr=hdr))
    assert streams[0] == streams[1]


POST_STREAMS = {
    "noise": lambda: reference.encode_vardct(
        smooth_frame(61, 77), noise_lut=reference.photon_noise_lut(800)),
    "rgba_two_groups": lambda: reference.encode_vardct(
        smooth_frame(40, 300), alpha=np.arange(12000).reshape(40, 300) % 256),
    "upsampled_4x": lambda: _upsampled_stream(4),
    "gamma": lambda: reference.encode_vardct(
        smooth_frame(40, 48), colour=_ce(__import__(
            "jxl_coder_tpu_torch.host.bitstream.headers",
            fromlist=["x"]), gamma=1 / 2.2)),
    "pq_2100_16bit": lambda: reference.encode_vardct(
        smooth_frame(40, 48).astype(np.uint16) * 257, colour=_ce(__import__(
            "jxl_coder_tpu_torch.host.bitstream.headers",
            fromlist=["x"]), 16, 9), intensity_target=4000.0),
    "hlg_2100": lambda: reference.encode_vardct(
        smooth_frame(40, 48), colour=_ce(__import__(
            "jxl_coder_tpu_torch.host.bitstream.headers",
            fromlist=["x"]), 18, 9), intensity_target=1000.0),
}


def _upsampled_stream(n):
    from jxl_coder_tpu_torch.host.bitstream import (frame_header as PF,
                                                    headers as PH)
    H, W = 21 * n + 3, 17 * n + 5
    m = PH.ImageMetadata()
    m.bit_depth = PH.BitDepth(False, 8, 0)
    hdr = PH.ImageHeader(size=PH.SizeHeader(xsize=W, ysize=H), metadata=m)
    return reference.encode_vardct(smooth_frame(H, W)[::n, ::n],
                                   fh=PF.FrameHeader(upsampling=n), hdr=hdr)


@pytest.mark.parametrize("key", list(POST_STREAMS))
def test_float64_reference_with_post_stages_equals_the_jax_host_decode(
        monkeypatch, key):
    """Noise, alpha, upsampling and the output encodings on the host:
    equal, but HLG within one code (XLA's exp and log, and its dot)."""
    data = POST_STREAMS[key]()
    monkeypatch.setenv("JXL_TPU_DEVICE", "0")
    ref, _ = jax_api.decode(data)
    got = reference.decode_float64(data)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    d = np.abs(got.astype(np.int64) - ref.astype(np.int64))
    assert d.max() <= (1 if key.startswith("hlg") else 0), d.max()
