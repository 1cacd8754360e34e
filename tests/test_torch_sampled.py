"""The sampled decode of the PyTorch port on the CPU (the kernels' plain
twins) against the JAX package, end to end: ``decode_thumbnail``,
``_decode_downsampled`` and ``decode_sampled`` of
``jxl_coder_tpu_torch.api`` against those of ``jxl_coder_tpu.api``: the
quarter route as ``tests/test_device_post.py:217`` runs it
(JXL_TPU_DEVICE=1 with STRICT: the JAX package's device route, on JAX's
CPU backend), the thumbnail and the full decode on the JAX package's
float64 host route (JXL_TPU_DEVICE=0).

Tolerances: codes within 1 on under 0.1% of values (the port converts
the DC and pools in float32 where the reference's thumbnail converts in
float64; 16-bit within 64; PQ by its mean, 99.9th percentile and maximum
as tests/test_device_post.py:89-112); decode_sampled's output, unpacked to
[0, 1], within one input code plus one output step on at least 99.9% of
values and never beyond two (the rescale's sums run in another order).
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from jxl_coder_tpu import api as ref_api
from jxl_coder_tpu.animation import AnimatedEncoder
from jxl_coder_tpu.bitstream import frame_header as JF
from jxl_coder_tpu.bitstream import headers as JH
from jxl_coder_tpu.vardct.enc_real import encode_vardct_real
from jxl_coder_tpu_torch import api
from jxl_coder_tpu_torch.ops import pack
import port_fixtures as F

# ragged: neither side a multiple of 8 or 4, so the last thumbnail and
# quarter cells are partly edge copies
H, W = 93, 130


def _jax_route(monkeypatch, device: bool):
    """The JAX package's device route (JXL_TPU_DEVICE=1, STRICT), which its
    quarter route needs, or its float64 host route."""
    monkeypatch.setenv("JXL_TPU_DEVICE", "1" if device else "0")
    monkeypatch.setenv("JXL_TPU_DEVICE_STRICT", "1" if device else "0")


@pytest.fixture
def jax_device(monkeypatch):
    _jax_route(monkeypatch, True)


@pytest.fixture
def jax_host(monkeypatch):
    _jax_route(monkeypatch, False)


def _colour(trc=13, prim=1):
    ce = JH.ColourEncoding()
    ce.transfer_function = trc
    ce.primaries = prim
    return ce


def _header(h, w, orientation=1):
    m = JH.ImageMetadata()
    m.bit_depth = JH.BitDepth(False, 8, 0)
    m.orientation = orientation
    return JH.ImageHeader(size=JH.SizeHeader(xsize=w, ysize=h), metadata=m)


@functools.lru_cache(maxsize=None)
def _plain(h=H, w=W):
    return ref_api.encode(F.smooth_frame(h, w), lossless=False, quality=90)


@functools.lru_cache(maxsize=None)
def _rgba():
    img = F.smooth_frame(H, W)
    yy, xx = np.mgrid[0:H, 0:W]
    a = np.clip(40 + (xx * 3 + yy * 2) % 256, 0, 255).astype(np.uint8)
    return ref_api.encode(np.concatenate([img, a[..., None]], -1),
                          lossless=False, quality=90)


@functools.lru_cache(maxsize=None)
def _pq():
    img = F.smooth_frame(H, W).astype(np.uint16) * 257 + 31
    return ref_api.encode(img, lossless=False, quality=90,
                          colour=_colour(16, 9), intensity_target=1000.0)


@functools.lru_cache(maxsize=None)
def _upsampled(h=H, w=W, n=2):
    full = F.smooth_frame(h, w)
    return encode_vardct_real(full[::n, ::n], distance=1.0, effort=7,
                              fh=JF.FrameHeader(upsampling=n),
                              hdr=_header(h, w))


@functools.lru_cache(maxsize=None)
def _oriented():
    img = F.smooth_frame(W, H)      # stored transposed: orientation 6
    return encode_vardct_real(img, distance=1.0, effort=7,
                              hdr=_header(W, H, orientation=6))


def _codes_close(got, ref, pq=False):
    assert got.shape == ref.shape and got.dtype == ref.dtype
    d = np.abs(got.astype(np.int64) - ref.astype(np.int64))
    if pq:
        assert d.mean() < 0.5 and np.percentile(d, 99.9) <= 8 and \
            d.max() <= 64, (d.mean(), d.max())
    elif got.dtype == np.uint16:
        assert d.max() <= 64, d.max()
    else:
        assert d.max() <= 1 and (d > 0).mean() < 1e-3, (d.max(),
                                                        (d > 0).mean())


# ---- decode_thumbnail ------------------------------------------------------

THUMBS = {
    "vardct": _plain,
    "vardct_pq16": _pq,
    "vardct_rgba": _rgba,
    "vardct_lf_frame": lambda: F.with_lf_frame(_plain()),
    "vardct_oriented": _oriented,
    "modular": lambda: ref_api.encode(F.smooth_frame(H, W), lossless=True),
    "modular_rgba16": lambda: F.modular_still(np.concatenate(
        [F.smooth_frame(H, W, dtype=np.uint16),
         F.smooth_frame(H, W, 5, np.uint16)[..., :1]], -1)),
    "upsampled_2x": _upsampled,
}


@pytest.mark.parametrize("kind", list(THUMBS))
def test_decode_thumbnail(jax_host, kind):
    data = THUMBS[kind]()
    ref, ref_info = ref_api.decode_thumbnail(data)
    got, info = api.decode_thumbnail(data, device="cpu")
    assert dataclasses.asdict(info) == dataclasses.asdict(ref_info)
    _codes_close(got, ref, pq=kind == "vardct_pq16")
    if kind.startswith("vardct"):
        assert got.shape[-1] == 3
        assert got.shape[:2] == (-(-info.ysize // 8), -(-info.xsize // 8))


def test_thumbnail_reads_no_ac(monkeypatch):
    """The DC-only parse reads no HF global and no pass group."""
    from jxl_coder_tpu_torch.vardct import parse
    data = _plain()

    def refuse(*_a, **_k):
        raise AssertionError("the thumbnail read AC data")

    monkeypatch.setattr(parse, "read_hf_global", refuse)
    monkeypatch.setattr(parse, "read_pass_group", refuse)
    got, _ = api.decode_thumbnail(data, device="cpu", entropy="device")
    assert got.shape == (12, 17, 3)


# ---- _decode_downsampled ---------------------------------------------------

QUARTER = {
    "plain": _plain,
    "noisy": lambda: ref_api.encode(F.smooth_frame(H, W), lossless=False,
                                    quality=90, photon_noise_iso=3200),
    "splines": lambda: F.with_splines(_plain(), F.seeded_splines(H, W, 3)),
    # coded at 47 x 65: the upsampled planes pass the output's 93 rows
    "upsampled_2x": _upsampled,
    "pq16": _pq,
}


@pytest.mark.parametrize("kind", list(QUARTER))
def test_decode_downsampled(jax_device, kind):
    data = QUARTER[kind]()
    ref = ref_api._decode_downsampled(data, 4)
    assert ref is not None
    got = api._decode_downsampled(data, 4, device="cpu")
    assert got is not None
    _codes_close(got[0], ref[0], pq=kind == "pq16")
    assert got[0].shape[:2] == (-(-got[1].ysize // 4), -(-got[1].xsize // 4))


@functools.lru_cache(maxsize=None)
def _animation():
    enc = AnimatedEncoder(W, H, lossless=False)
    for k in range(2):
        enc.add_frame(np.roll(F.smooth_frame(H, W), 9 * k, axis=1), 100)
    return enc.encode()


INELIGIBLE = {
    "animation": _animation,
    "extra_channels": _rgba,
    "icc": lambda: ref_api.encode(F.smooth_frame(H, W), lossless=True,
                                  icc=_icc()),
    "orientation": _oriented,
    "modular": lambda: ref_api.encode(F.smooth_frame(H, W), lossless=True),
    "patched_two_frames": lambda: F.vardct_reference_still(
        F.bench_frame(64, 96)),
    "lf_frame": lambda: F.with_lf_frame(_plain()),
}


def _icc():
    from PIL import ImageCms
    return ImageCms.ImageCmsProfile(ImageCms.createProfile("sRGB")).tobytes()


@pytest.mark.parametrize("kind", list(INELIGIBLE))
def test_decode_downsampled_declines(jax_device, kind):
    data = INELIGIBLE[kind]()
    assert ref_api._decode_downsampled(data, 4) is None
    assert api._decode_downsampled(data, 4, device="cpu") is None


# ---- decode_sampled --------------------------------------------------------

STREAMS = {"plain": _plain, "rgba": _rgba, "pq16": _pq}
# (width, height): within 1/8, within 1/4, beyond
TARGETS = [(16, 11), (33, 20), (100, 70)]
CONFIGS = [int(c) for c in api.PreferredColorConfig]


def _unit(a: np.ndarray) -> np.ndarray:
    """A packed output as [0, 1] values."""
    if a.dtype in (np.uint16, np.uint32):
        return pack.unpack_plain(torch.from_numpy(a)).numpy().astype(
            np.float64)
    if a.dtype == np.uint8:
        return a / 255.0
    return a.astype(np.float64)


def _step(a: np.ndarray) -> float:
    """The output's coarsest code step, per value."""
    return {np.dtype(np.uint16): 1 / 31, np.dtype(np.uint32): 1 / 3,
            np.dtype(np.uint8): 1 / 255}.get(a.dtype, 1 / 2048)


def _sampled_close(got, ref, in_step):
    assert got.shape == ref.shape and got.dtype == ref.dtype
    d = np.abs(_unit(got) - _unit(ref))
    one = in_step + _step(got) + 1e-6
    assert (d <= one).mean() >= 0.999 and d.max() <= 2 * one, d.max()


@pytest.mark.parametrize("stream", list(STREAMS))
@pytest.mark.parametrize("target", TARGETS, ids=["eighth", "quarter", "full"])
def test_decode_sampled(monkeypatch, stream, target):
    # the JAX package's quarter route needs its device route; a stream it
    # declines there (extra channels) decodes whole on either
    _jax_route(monkeypatch, target == TARGETS[1] and stream != "rgba")
    data = STREAMS[stream]()
    bits = ref_api.basic_info(data).bits_per_sample
    in_step = 1 / 255 if bits <= 8 else 1 / 65535
    w, h = target
    # every colour config at FIT; FILL and RESIZE (RGBA_8888) where the
    # full decode is rescaled
    modes = [(2, 2), (2, 3)] if target == TARGETS[2] else []
    for config, mode in [(c, 1) for c in CONFIGS] + modes:
        ref, ref_info = ref_api.decode_sampled(data, w, h, config, mode)
        got, info = api.decode_sampled(data, w, h, config, mode,
                                       device="cpu")
        assert dataclasses.asdict(info) == dataclasses.asdict(ref_info)
        _sampled_close(got, ref, in_step)


def test_decode_sampled_filters_and_sizes(jax_host):
    """Other resize filters (test_torch_pixel_ops.py holds all ten); a
    target at the decoded size skips the rescale; a zero target keeps the
    decode's size."""
    data = _plain()
    for fid in (api.ResizeFilter.NEAREST, api.ResizeFilter.LANCZOS):
        ref, _ = ref_api.decode_sampled(data, 57, 41, 2, 2, fid)
        got, _ = api.decode_sampled(data, 57, 41, 2, 2, fid, device="cpu")
        _sampled_close(got, ref, 1 / 255)
    for w, h in ((17, 12), (0, 0), (W, H)):
        ref, _ = ref_api.decode_sampled(data, w, h)
        got, _ = api.decode_sampled(data, w, h, device="cpu")
        _sampled_close(got, ref, 1 / 255)


def test_decode_sampled_raises():
    data = _plain()
    with pytest.raises(api.InvalidJXLError):
        api.decode_sampled(b"\xff\x0a" + data[2:40], 16, 16, device="cpu")
    with pytest.raises(api.InvalidJXLError):
        api.decode_sampled(b"not a jxl stream", 16, 16, device="cpu")
    # a profile littlecms applies by a lookup table (these raised until
    # the CLUT program) decodes as the JAX package decodes it
    icc = ref_api.encode(F.smooth_frame(H, W), lossless=True,
                         icc=F.lut_profile())
    for name, args in (("decode_sampled", (16, 11)),
                       ("decode_sampled", (60, 40)),
                       ("decode_thumbnail", ()), ("decode", ())):
        got = getattr(api, name)(icc, *args, device="cpu")[0]
        ref = getattr(ref_api, name)(icc, *args)[0]
        assert got.shape == ref.shape and np.array_equal(got, ref)
    if not torch.cuda.is_available():
        for fn in (api.decode_sampled, api.decode_thumbnail):
            with pytest.raises(RuntimeError, match="CUDA"):
                fn(data, 16, 11) if fn is api.decode_sampled else fn(data)
        with pytest.raises(RuntimeError, match="CUDA"):
            api._decode_downsampled(data, 4)


@pytest.mark.parametrize("kind", ["vardct", "vardct_pq16", "vardct_lf_frame",
                                  "vardct_oriented"])
def test_thumbnail_float64_equals_the_reference(kind):
    """The port's float64 thumbnail oracle (chip_smoke.py's reference for
    the thumbnail route) is the JAX package's host thumbnail, to the code."""
    from jxl_coder_tpu_torch import reference
    data = THUMBS[kind]()
    ref, _ = ref_api.decode_thumbnail(data)
    assert np.array_equal(reference.thumbnail_float64(data), ref)
