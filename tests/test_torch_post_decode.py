"""VarDCT stills with post stages, decoded end to end by the PyTorch port
on the CPU (jxl_coder_tpu_torch.api.decode(data, device="cpu"): the
kernels' plain twins) against jxl_coder_tpu.api.decode on both of its
routes: the device route (JXL_TPU_DEVICE=1 with STRICT, the jitted
fn_post stages on JAX's CPU backend, as tests/test_device_post.py:34-44
runs it) and the float64 host route (JXL_TPU_DEVICE=0).  Streams come
from jxl_coder_tpu.api.encode (photon noise, lossy RGBA, a signalled
colour encoding) and from encode_vardct_real with an upsampled frame
header (a frame coded at 1/n of the signalled size).

Tolerances: 8-bit within 2 codes (float32 against the float64 host and
XLA's fused order, then the noise and upsampling stages), 16-bit within
64 codes (the port's contract), PQ by its mean, 99.9th percentile and
maximum (mean < 0.5, <= 8, <= 64: tests/test_device_post.py:89-112).
Extra channels (alpha) equal exactly.
"""

import numpy as np
import pytest

from jxl_coder_tpu import api as ref_api
from jxl_coder_tpu.bitstream import frame_header as JF
from jxl_coder_tpu.bitstream import headers as JH
from jxl_coder_tpu.vardct.enc_real import encode_vardct_real
from jxl_coder_tpu_torch import api
import port_fixtures as F

ROUTES = ("1", "0")       # JXL_TPU_DEVICE: the JAX device route, the host


def _jax_decode(data, monkeypatch, route):
    monkeypatch.setenv("JXL_TPU_DEVICE", route)
    monkeypatch.setenv("JXL_TPU_DEVICE_STRICT", route)
    return ref_api.decode(data)[0]


def _check(got, ref, bits, pq=False, ncolour=3):
    assert got.shape == ref.shape and got.dtype == ref.dtype
    d = np.abs(got[..., :ncolour].astype(np.int64)
               - ref[..., :ncolour].astype(np.int64))
    if pq:
        assert d.mean() < 0.5 and np.percentile(d, 99.9) <= 8 and \
            d.max() <= 64, (d.mean(), np.percentile(d, 99.9), d.max())
    else:
        assert d.max() <= (2 if bits <= 8 else 64), d.max()
    assert np.array_equal(got[..., ncolour:], ref[..., ncolour:])


def _both_routes(data, monkeypatch, bits, pq=False):
    got, info = api.decode(data, device="cpu")
    for route in ROUTES:
        _check(got, _jax_decode(data, monkeypatch, route), bits, pq)
    return got


def _colour(trc=13, prim=1, gamma=None):
    ce = JH.ColourEncoding()
    ce.transfer_function = trc
    ce.primaries = prim
    if gamma is not None:
        ce.have_gamma = True
        ce.gamma = int(round(gamma * 1e7))
    return ce


def _img(h, w, bits=8):
    img = F.smooth_frame(h, w)
    return img if bits == 8 else img.astype(np.uint16) * 257 + 31


@pytest.mark.parametrize("iso", [800, 3200])
@pytest.mark.parametrize("bits", [8, 16])
def test_photon_noise(monkeypatch, iso, bits):
    """A size that is not a multiple of 8; the grain is there."""
    img = _img(61, 77, bits)
    data = ref_api.encode(img, lossless=False, quality=90,
                          photon_noise_iso=iso)
    got = _both_routes(data, monkeypatch, bits)
    flat, _ = api.decode(ref_api.encode(img, lossless=False, quality=90),
                         device="cpu")
    assert np.abs(got.astype(int) - flat.astype(int)).mean() > 0


@pytest.mark.parametrize("n", [2, 4, 8])
def test_upsampled_frame(monkeypatch, n):
    H, W = 21 * n + 3, 17 * n + 5
    full = F.smooth_frame(H, W)
    m = JH.ImageMetadata()
    m.bit_depth = JH.BitDepth(False, 8, 0)
    hdr = JH.ImageHeader(size=JH.SizeHeader(xsize=W, ysize=H), metadata=m)
    data = encode_vardct_real(full[::n, ::n], distance=1.0, effort=7,
                              fh=JF.FrameHeader(upsampling=n), hdr=hdr)
    got = _both_routes(data, monkeypatch, 8)
    assert got.shape == (H, W, 3)


# tests/test_hdr.py:35-42's six (transfer function, primaries, intensity
# target) cases, and a gamma
ENCODINGS = [(16, 1, 1000.0), (16, 9, 4000.0), (18, 1, 1000.0),
             (18, 9, 1000.0), (13, 9, 255.0), (1, 1, 255.0),
             ("gamma", 1, 255.0)]


@pytest.mark.parametrize("trc,prim,it", ENCODINGS,
                         ids=[f"{t}-{p}" for t, p, _ in ENCODINGS])
def test_output_encodings(monkeypatch, trc, prim, it):
    bits = 16 if trc == 16 else 8
    ce = (_colour(prim=prim, gamma=1 / 2.2) if trc == "gamma"
          else _colour(trc, prim))
    data = ref_api.encode(_img(48, 56, bits), lossless=False, quality=90,
                          colour=ce, intensity_target=it)
    _both_routes(data, monkeypatch, bits, pq=trc == 16)


@pytest.mark.parametrize("bits", [8, 16])
def test_lossy_rgba(monkeypatch, bits):
    """Alpha is a lossless extra channel: equal exactly."""
    rgb = _img(52, 300, bits)      # two AC groups: an EC stream in each
    yy, xx = np.mgrid[0:52, 0:300]
    alpha = ((xx * 7 + yy * 3) % (1 << bits)).astype(rgb.dtype)
    data = ref_api.encode(np.concatenate([rgb, alpha[..., None]], -1),
                          lossless=False, quality=90)
    got = _both_routes(data, monkeypatch, bits)
    assert got.shape == (52, 300, 4) and np.array_equal(got[..., 3], alpha)


def test_noise_alpha_and_pq_in_one_stream(monkeypatch):
    rgb = _img(40, 72, 16)
    alpha = (np.arange(40 * 72).reshape(40, 72) * 37 % 65536).astype(
        np.uint16)
    data = ref_api.encode(np.concatenate([rgb, alpha[..., None]], -1),
                          lossless=False, quality=90, photon_noise_iso=3200,
                          colour=_colour(16, 9), intensity_target=4000.0)
    got = _both_routes(data, monkeypatch, 16, pq=True)
    assert np.array_equal(got[..., 3], alpha)
