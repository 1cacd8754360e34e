"""Any channel count through the PyTorch port's pixel ops on the CPU
against the JAX package: S2 (the thumbnail's 8x box), S3 (the rescale),
S4's packers and A10 (the frame composition) on streams with 5, 6, 11 and
13 channels (RGB and 2, 3, 8 or 10 extra channels), which the kernels took
up to 4 channels (S2-S4) or 8 extra channels (A10) before.

Streams come from ``port_fixtures``: ``modular_still`` over
``modular_headers`` (alpha, then depth, thermal, selection-mask and
optional channels), ``sprite_animation(n_extra=...)`` (every blend mode,
crops past each edge, the extra channels past depth in rotated modes).

Tolerances: thumbnails and composed frames are equal; a sampled decode is
within 1 code of the JAX package's (S3's twin sums the dense matmul pair
in another order than XLA), field by field for the packed formats (F16
within 1/255 + one half-precision step).  Alpha is premultiplied only at 2
or 4 channels, as the reference.
"""

import numpy as np
import pytest
import torch

from jxl_coder_tpu import api as ref_api
from jxl_coder_tpu_torch import api
from jxl_coder_tpu_torch.ops import compose as C
from jxl_coder_tpu_torch.ops import pack as P
from jxl_coder_tpu_torch.ops import resize as RS
from jxl_coder_tpu_torch.ops import sample as S
import port_fixtures as F

CHANNELS = [5, 6, 11, 13]


def _still(nch: int, dtype=np.uint8, h: int = 37, w: int = 45) -> bytes:
    rng = np.random.default_rng(nch)
    img = rng.integers(0, 256, (h, w, nch)).astype(np.uint8)
    img[..., :3] = F.bench_frame(h, w)
    img[..., 3][::3, ::4] = 0
    img = img.astype(dtype) * (257 if dtype == np.uint16 else 1)
    return F.modular_still(img)


@pytest.fixture(scope="module")
def stills():
    return {(n, dt): _still(n, dt) for n in CHANNELS
            for dt in (np.uint8, np.uint16)}


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("nch", CHANNELS)
def test_thumbnail_equals_the_jax_package(stills, nch, dtype):
    data = stills[(nch, dtype)]
    got, info = api.decode_thumbnail(data, device="cpu")
    ref, ref_info = ref_api.decode_thumbnail(data)
    assert got.shape == ref.shape == (5, 6, nch) and got.dtype == ref.dtype
    assert np.array_equal(got, ref) and vars(info) == vars(ref_info)


def _fields(out: np.ndarray, cfg: int, bits: int):
    """A sampled decode's output as per-field codes and their tolerance."""
    if cfg == 4:                                  # RGB_565
        v = out.astype(np.int64)
        return np.stack([(v >> 11) & 31, (v >> 5) & 63, v & 31], -1), 1
    if cfg == 5:                                  # RGBA_1010102
        v = out.astype(np.int64)
        return np.stack([v & 1023, (v >> 10) & 1023, (v >> 20) & 1023,
                         (v >> 30) & 3], -1), 1
    if out.dtype == np.float16:
        return out.astype(np.float64), 1 / 255 + 2.0 ** -11
    return out.astype(np.int64), 1


@pytest.mark.parametrize("cfg", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("nch", CHANNELS)
def test_sampled_decode_equals_the_jax_package(stills, nch, cfg):
    """decode_sampled at a thumbnail target (S2 then S3), a FIT target
    and a FILL target of the full decode (S3), each packed (S4)."""
    for dtype in (np.uint8, np.uint16):
        data = stills[(nch, dtype)]
        bits = 16 if dtype == np.uint16 else 8
        for w, h, mode in ((5, 4, 3), (20, 17, 1), (60, 50, 2)):
            got, _ = api.decode_sampled(data, w, h, cfg, mode, device="cpu")
            ref, _ = ref_api.decode_sampled(data, w, h, cfg, mode)
            assert got.shape == ref.shape and got.dtype == ref.dtype, \
                (w, h, got.shape, ref.shape)
            a, tol = _fields(got, cfg, bits)
            b, _ = _fields(ref, cfg, bits)
            assert np.abs(a - b).max() <= tol, (dtype, w, h)


@pytest.mark.parametrize("nch", [2, 4, 5, 6])
def test_rescale_premultiplies_only_where_the_reference_does(nch):
    """S3's twin at 2 and 4 channels divides the alpha out (a zero alpha
    zeroes the colour); at 5 and 6 it leaves every channel alone."""
    img = torch.full((8, 8, nch), 200, dtype=torch.uint8)
    img[..., nch - 1] = 0
    out = RS.rescale_image(img, 4, 4, 3, 1)
    colour = out[..., :nch - 1]
    assert bool((colour == 0).all()) == (nch in (2, 4))
    assert bool((colour == 200).all()) == (nch not in (2, 4))


@pytest.mark.parametrize("nch", [5, 9])
def test_box_and_packers_take_any_channel_count(nch):
    """S2's and S4's twins on 5 and 9 channels: the box of each channel as
    one channel alone; 8888 / F16 pack every channel, 565 the first three,
    1010102 the first four."""
    rng = np.random.default_rng(nch)
    codes = torch.from_numpy(rng.integers(0, 256, (19, 27, nch))
                             .astype(np.uint8))
    box = S.box_codes(codes)
    for c in range(nch):
        assert torch.equal(box[..., c], S.box_codes(codes[..., c:c + 1])[
            ..., 0])
    rgba = P.convert(codes, P.RGBA8888)
    assert tuple(rgba.shape) == (19, 27, nch) and torch.equal(rgba, codes)
    assert tuple(P.convert(codes, P.RGBA_F16).shape) == (19, 27, nch)
    assert torch.equal(P.convert(codes, P.RGB565),
                       P.convert(codes[..., :3], P.RGB565))
    assert torch.equal(P.convert(codes, P.RGBA1010102),
                       P.convert(codes[..., :4], P.RGBA1010102))


@pytest.fixture(scope="module")
def sprites():
    return {n: F.sprite_animation(32, 40, 12, 14, seed=n, n_extra=n - 3)
            for n in CHANNELS}


@pytest.mark.parametrize("nch", CHANNELS)
def test_decode_frames_equals_the_jax_package(sprites, nch, monkeypatch):
    """A10's twin composes every cropped and blended frame: the frames
    equal the JAX package's, the extra channels past the eighth included,
    and A10 runs on each composed frame."""
    data = sprites[nch]
    calls = []
    plain = C.compose_plain

    def counted(*a, **k):
        calls.append(int(a[3][2]))
        return plain(*a, **k)
    monkeypatch.setattr(C, "compose_plain", counted)
    frames, durations, info = api.decode_frames(data, device="cpu")
    ref_frames, ref_durations, ref_info = ref_api.decode_frames(data)
    assert durations == ref_durations and vars(info) == vars(ref_info)
    assert len(frames) == len(ref_frames)
    for got, ref in zip(frames, ref_frames):
        assert got.shape == ref.shape and got.shape[2] == nch
        assert np.array_equal(got, ref)
    assert calls and set(calls) == {nch - 3}


@pytest.mark.parametrize("nch", [6, 13])
def test_animation_thumbnail_and_sampled_equal_the_jax_package(sprites,
                                                               nch):
    """An animation's thumbnail (its last frame through S2) and a sampled
    decode of it (S3, S4) at 6 and 13 channels."""
    data = sprites[nch]
    got, _ = api.decode_thumbnail(data, device="cpu")
    ref, _ = ref_api.decode_thumbnail(data)
    assert got.shape == ref.shape and np.array_equal(got, ref)
    got, _ = api.decode_sampled(data, 17, 11, 2, 3, device="cpu")
    ref, _ = ref_api.decode_sampled(data, 17, 11, 2, 3)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1
