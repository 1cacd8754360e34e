"""The port's encoders on the CPU against the JAX package: ``api.encode``
(lossless Modular: the effort ladder and the palette body, host code;
lossy VarDCT with the encoder front's twins, ``device="cpu"``),
``animation.AnimatedEncoder``, ``gif_to_jxl`` / ``apng_to_jxl``.

Parity: lossless bytes equal ``jxl_coder_tpu.api.encode``'s; lossy bytes
equal the JAX device route's (``JXL_TPU_DEVICE=1``) on the images where
that route equals its own float64 host route, and elsewhere meet
``tests/test_enc_device.py``'s criterion against it (size within 2% or
64 B, decoded PSNR within 0.1 dB).  Every stream decodes with the JAX
package's ``api.decode`` and with the port's (CPU) within one code of it.
"""

import io

import numpy as np
import pytest
import torch

import jxl_coder_tpu.animation as ref_anim
import jxl_coder_tpu.api as ref_api
from jxl_coder_tpu.vardct.enc_real import encode_vardct_real as ref_real
from jxl_coder_tpu_torch import animation, api
from jxl_coder_tpu_torch.host.api import InvalidImageSizeError
from jxl_coder_tpu_torch.host.bitstream.headers import (ColourEncoding,
                                                        TransferFunction)
from jxl_coder_tpu_torch.host.vardct import enc_real as PR
from jxl_coder_tpu_torch.vardct import enc_kernels as EK
from jxl_coder_tpu_torch.vardct.enc_device import Front
import port_fixtures as F


def _test_image(h=160, w=256, seed=4):
    """tests/test_enc_device.py's image."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([120 + 80 * np.sin(yy / 29) + 20 * np.cos(xx / 13),
                    110 + 70 * np.sin((xx + yy) / 43),
                    100 + 60 * np.cos(yy / 17)], -1)
    img += rng.normal(0, 9, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def _psnr(a, b, peak=255.0):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 10 * np.log10(peak ** 2 / mse)


@pytest.fixture
def jax_routes(monkeypatch):
    """fn() under the JAX package's device route (JXL_TPU_DEVICE=1) and
    under its float64 host route."""
    def both(fn):
        monkeypatch.setenv("JXL_TPU_DEVICE", "1")
        monkeypatch.setenv("JXL_TPU_DEVICE_STRICT", "1")
        dev = fn()
        monkeypatch.setenv("JXL_TPU_DEVICE", "0")
        return dev, fn()
    return both


def _decodes_alike(data):
    """The JAX package and the port (CPU) decode `data` within one code."""
    ref, _ = ref_api.decode(data)
    ours, _ = api.decode(data, device="cpu")
    assert ours.shape == ref.shape and ours.dtype == ref.dtype
    assert np.abs(ours.astype(np.int64) - ref.astype(np.int64)).max() <= 1
    return ref


def _lossy_parity(ours, ref_dev, ref_host, img=None):
    """Bytes equal the JAX device route's where it equals its host route;
    elsewhere the size / PSNR criterion (the size alone for animations)."""
    if ref_dev == ref_host:
        assert ours == ref_dev
        return
    assert abs(len(ours) - len(ref_dev)) <= max(64, 0.02 * len(ref_dev))
    if img is not None:
        a = _decodes_alike(ours)
        b, _ = ref_api.decode(ref_dev)
        assert abs(_psnr(a, img) - _psnr(b, img)) < 0.1


# --------------------------------------------------------------------------
# Lossless: the effort ladder, byte for byte

def _lossless_image(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    top = 256 if dtype == np.uint8 else 65536
    h, w, c = shape
    yy, xx = np.mgrid[0:h, 0:w]
    base = (xx * 7 + yy * 13)[..., None] % top
    noise = rng.integers(0, max(2, top // 64), (h, w, c))
    return ((base + noise) % top).astype(dtype)


@pytest.mark.parametrize("effort", range(1, 11))
@pytest.mark.parametrize("nch", [1, 3, 4])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_lossless_ladder_equals_the_jax_encoder(effort, nch, dtype):
    img = _lossless_image((13, 21, nch), dtype, effort * 7 + nch)
    data = api.encode(img, lossless=True, effort=effort, device="cpu")
    assert data == ref_api.encode(img, lossless=True, effort=effort)
    out, _ = api.decode(data, device="cpu")
    assert np.array_equal(out.reshape(img.shape), img)


@pytest.mark.parametrize("nch", [1, 3, 4])
def test_lossless_one_pixel(nch):
    img = np.full((1, 1, nch), 200, np.uint8)
    data = api.encode(img, effort=7, device="cpu")
    assert data == ref_api.encode(img, effort=7)


def test_palette_body_and_icc_profile():
    rng = np.random.default_rng(5)
    img = (rng.integers(0, 6, (40, 52, 3)) * 40).astype(np.uint8)
    for effort in (2, 7):
        data = api.encode(img, effort=effort, device="cpu")
        assert data == ref_api.encode(img, effort=effort)
    icc = bytes(range(256)) * 2
    data = api.encode(img, effort=3, icc=icc, device="cpu")
    assert data == ref_api.encode(img, effort=3, icc=icc)
    assert ref_api.decode(data)[0].shape == img.shape


def test_grey_2d_input_and_an_unsupported_channel_count():
    img = _lossless_image((9, 10, 1), np.uint8, 1)[..., 0]
    assert api.encode(img, device="cpu") == ref_api.encode(img)
    with pytest.raises(InvalidImageSizeError):
        api.encode(np.zeros((4, 4, 2), np.uint8), device="cpu")


# --------------------------------------------------------------------------
# Lossy: the twins against the JAX device route

@pytest.mark.parametrize("kw", [
    dict(),
    dict(quality=50, progressive=True),
    dict(photon_noise_iso=3200),
    dict(quality=95, effort=3),
    dict(decoding_speed=2),
])
def test_lossy_equals_the_jax_device_route(jax_routes, kw):
    img = _test_image(64, 96)
    ours = api.encode(img, lossless=False, device="cpu", **kw)
    ref_dev, ref_host = jax_routes(
        lambda: ref_api.encode(img, lossless=False, **kw))
    _lossy_parity(ours, ref_dev, ref_host, img)
    _decodes_alike(ours)


@pytest.mark.parametrize("kind", ["rgba", "u16", "float", "grey"])
def test_lossy_inputs_equal_the_jax_device_route(jax_routes, kind):
    img = _test_image(40, 72, seed=6)
    if kind == "rgba":
        a = np.random.default_rng(2).integers(0, 256, img.shape[:2])
        img = np.concatenate([img, a[..., None].astype(np.uint8)], -1)
    elif kind == "u16":
        img = img.astype(np.uint16) * 257
    elif kind == "float":
        img = img.astype(np.float32) / 255.0
    else:
        img = img[..., 1]
    ours = api.encode(img, lossless=False, device="cpu")
    ref_dev, ref_host = jax_routes(
        lambda: ref_api.encode(img, lossless=False))
    _lossy_parity(ours, ref_dev, ref_host,
                  img if img.ndim == 3 and img.shape[2] == 3
                  and img.dtype == np.uint8 else None)
    _decodes_alike(ours)


def test_few_colours_take_the_lossless_stream():
    rng = np.random.default_rng(8)
    cells = (rng.integers(0, 4, (6, 8, 3)) * 60).astype(np.uint8)
    img = np.repeat(np.repeat(cells, 8, 0), 8, 1)      # flat 8x8 cells
    ours = api.encode(img, lossless=False, device="cpu")
    assert ours == ref_api.encode(img, lossless=False)
    assert np.array_equal(api.decode(ours, device="cpu")[0], img)


def test_text_takes_the_patch_path_with_the_front(jax_routes):
    """The patch path re-enters the frame encoder on the filled
    background; the front runs there too."""
    img = F.text_frame(96, 160)
    ours = api.encode(img, lossless=False, quality=90, device="cpu")
    _lossy_parity(ours, *jax_routes(
        lambda: ref_api.encode(img, lossless=False, quality=90)), img)
    _decodes_alike(ours)


# tests/test_enc_device.py's three tests, on the port's device route

def test_device_encode_matches_host_quality():
    img = _test_image()
    d_dev = PR.encode_vardct_real(img, distance=1.0, effort=7,
                                  front=Front("cpu"))
    d_host = PR.encode_vardct_real(img, distance=1.0, effort=7)
    out_dev, _ = api.decode(d_dev, device="cpu")
    out_host, _ = api.decode(d_host, device="cpu")
    assert abs(len(d_dev) - len(d_host)) <= max(64, len(d_host) * 0.02)
    assert abs(_psnr(out_dev, img) - _psnr(out_host, img)) < 0.1


def test_device_encode_distances():
    img = _test_image(96, 128)
    prev = None
    for dist in (0.5, 1.0, 2.5):
        d = PR.encode_vardct_real(img, distance=dist, effort=5,
                                  front=Front("cpu"))
        out, _ = api.decode(d, device="cpu")
        assert out.shape == img.shape
        if prev is not None:
            assert len(d) < prev
        prev = len(d)


def test_device_encode_uint16():
    img = (_test_image(80, 96).astype(np.uint16) << 8)
    d = PR.encode_vardct_real(img, distance=1.0, effort=5, bit_depth=16,
                              front=Front("cpu"))
    out, _ = api.decode(d, device="cpu")
    assert out.dtype == np.uint16
    assert _psnr(out >> 8, img >> 8) > 27


def test_device_route_equals_the_jax_device_route(jax_routes):
    img = _test_image()
    ours = PR.encode_vardct_real(img, distance=1.0, effort=7,
                                 front=Front("cpu"))
    _lossy_parity(ours, *jax_routes(
        lambda: ref_real(img, distance=1.0, effort=7)), img)


# --------------------------------------------------------------------------
# The route rule, the raises

class _Spy(Front):
    def __init__(self):
        super().__init__("cpu")
        self.calls = 0

    def run_front_dispatch(self, *a, **k):
        self.calls += 1
        return super().run_front_dispatch(*a, **k)


def test_a_signalled_colour_encoding_never_runs_the_front():
    img = _test_image(40, 48)
    ce = ColourEncoding()
    ce.transfer_function = TransferFunction.LINEAR
    spy = _Spy()
    with_colour = PR.encode_vardct_real(img, distance=1.0, colour=ce,
                                        front=spy)
    assert spy.calls == 0
    assert with_colour == PR.encode_vardct_real(img, distance=1.0, colour=ce)
    PR.encode_vardct_real(img, distance=1.0, front=spy)
    assert spy.calls == 1


def test_a_failing_front_raises():
    class Broken(Front):
        def run_costs_dispatch(self, *a, **k):
            raise RuntimeError("kernel failed")

    with pytest.raises(RuntimeError, match="kernel failed"):
        PR.encode_vardct_real(_test_image(16, 16), front=Broken("cpu"))


def test_lossy_icc_raises_by_design():
    """A lossy encode converts its pixels from the profile first
    (ops/icc_apply.py): a profile littlecms converts through a lookup
    table (which raised NotImplementedError until the CLUT program)
    converts, and one it rejects passes the pixels through, as the JAX
    package does (bytes equal)."""
    import port_fixtures as F
    img = _test_image(16, 16)
    assert api.encode(img, lossless=False, icc=F.lut_profile(),
                      device="cpu") == \
        ref_api.encode(img, lossless=False, icc=F.lut_profile())
    assert api.encode(img, lossless=False, icc=b"\0" * 128, device="cpu") \
        == ref_api.encode(img, lossless=False, icc=b"\0" * 128)


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        api.encode(_test_image(16, 16), lossless=False)
    with pytest.raises(RuntimeError):
        animation.AnimatedEncoder(16, 16)


def test_the_encode_runs_each_kernel_twin_once_per_call(monkeypatch):
    calls = {}
    for name in ("front_planes", "front_blocks", "dct_costs",
                 "special_costs", "gather_rows"):
        fn = getattr(EK, name)

        def counted(*a, _fn=fn, _n=name, **k):
            calls[_n] = calls.get(_n, 0) + 1
            return _fn(*a, **k)
        monkeypatch.setattr(EK, name, counted)
    img = F.text_frame(48, 64)
    PR.encode_vardct_real(img, distance=1.0, effort=7, front=Front("cpu"),
                          try_patches=False)
    specials = PR._special_eligibility(img, 6, 8).any()
    assert calls["front_planes"] == calls["front_blocks"] == 1
    assert calls["dct_costs"] == 1 + 6
    assert calls.get("special_costs", 0) == (5 if specials else 0)
    assert calls["gather_rows"] == 1


# --------------------------------------------------------------------------
# AnimatedEncoder, gif / apng

def _frames(n, h=40, w=56, nch=4, seed=3):
    rng = np.random.default_rng(seed)
    base = _test_image(h, w, seed)
    out = []
    for k in range(n):
        f = np.roll(base, 6 * k, 1)
        if nch == 4:
            a = rng.integers(0, 256, (h, w, 1)).astype(np.uint8)
            f = np.concatenate([f, a], -1)
        out.append(f)
    return out


@pytest.mark.parametrize("lossless,ec_distance", [(True, 0.0), (False, 0.0),
                                                  (False, 1.5)])
def test_animated_encoder_equals_the_jax_encoder(jax_routes, lossless,
                                                 ec_distance):
    ours = animation.AnimatedEncoder(56, 40, num_loops=3, lossless=lossless,
                                     quality=85, ec_distance=ec_distance,
                                     device="cpu")
    for k, f in enumerate(_frames(3)):
        ours.add_frame(f, 40 + k)

    def reference():
        ref = ref_anim.AnimatedEncoder(56, 40, num_loops=3,
                                       lossless=lossless, quality=85,
                                       ec_distance=ec_distance)
        for k, f in enumerate(_frames(3)):
            ref.add_frame(f, 40 + k)
        return ref.encode()
    data = ours.encode()
    _lossy_parity(data, *jax_routes(reference))
    frames, durations, _ = api.decode_frames(data, device="cpu")
    assert len(frames) == 3 and frames[0].shape == (40, 56, 4)
    assert list(durations) == [40, 41, 42]


def test_animated_encoder_checks_its_frames():
    enc = animation.AnimatedEncoder(8, 8, device="cpu")
    with pytest.raises(RuntimeError):
        enc.encode()
    with pytest.raises(ValueError):
        enc.add_frame(np.zeros((8, 9, 3), np.uint8), 10)
    enc.add_frame(np.zeros((8, 8, 3), np.uint8), 10)
    enc.encode()
    with pytest.raises(RuntimeError):
        enc.add_frame(np.zeros((8, 8, 3), np.uint8), 10)


@pytest.mark.parametrize("lossless", [True, False])
def test_fixture_animation_is_the_package_encoder(lossless):
    """port_fixtures.animated_stream writes its headers through
    animation's and its frames as animation.encode_frame_into does (a lossy
    frame on the float64 host front); its bytes equal the JAX encoder's
    and, lossless, the package's AnimatedEncoder's."""
    frames = _frames(3, nch=4 if lossless else 3)
    data = F.animated_stream(frames, lossless, 80, num_loops=2,
                             durations=[30, 40, 50])
    ref = ref_anim.AnimatedEncoder(56, 40, num_loops=2, lossless=lossless,
                                   quality=80)
    ours = animation.AnimatedEncoder(56, 40, num_loops=2, lossless=lossless,
                                     quality=80, device="cpu")
    for f, d in zip(frames, (30, 40, 50)):
        ref.add_frame(f, d)
        ours.add_frame(f, d)
    assert data == ref.encode()
    if lossless:
        assert data == ours.encode()


def _pil_animation(fmt):
    Image = pytest.importorskip("PIL.Image")
    frames = [Image.fromarray(f[..., :3]) for f in _frames(3, 24, 32, 3)]
    buf = io.BytesIO()
    frames[0].save(buf, format=fmt, save_all=True,
                   append_images=frames[1:], duration=[50, 60, 70], loop=2)
    return buf.getvalue()


@pytest.mark.parametrize("fmt,lossless", [("GIF", True), ("PNG", True),
                                          ("PNG", False)])
def test_gif_and_apng_equal_the_jax_converters(jax_routes, fmt, lossless):
    src = _pil_animation(fmt)
    conv, ref_conv = ((api.gif_to_jxl, ref_api.gif_to_jxl) if fmt == "GIF"
                      else (api.apng_to_jxl, ref_api.apng_to_jxl))
    data = conv(src, lossless=lossless, quality=85, device="cpu")
    _lossy_parity(data, *jax_routes(
        lambda: ref_conv(src, lossless=lossless, quality=85)))
    assert len(api.decode_frames(data, device="cpu")[0]) == 3


def test_package_exports_the_encoders():
    import jxl_coder_tpu_torch as pkg
    assert pkg.encode is api.encode
    assert pkg.AnimatedEncoder is animation.AnimatedEncoder
    assert {"encode", "AnimatedEncoder"} <= set(pkg.__all__)
