"""The sampled decode's pixel ops in the PyTorch port, on the CPU: each
kernel's plain twin against the JAX package on the same inputs.

- ``host/ops/resize.py`` ``resample_matrix`` equal to the JAX one, bit for
  bit, and its ``band`` holding every nonzero weight;
- S3's twin (``ops/resize.py`` ``rescale_image``) against
  ``jxl_coder_tpu.ops.resize.rescale_image`` over the 10 filters, the 3
  scale modes, uint8 / uint16 / float32 and alpha on or off: uint8 at
  most 1 code on under 0.1% of values; uint16 at most 1 code (the float32
  products sum in another order than XLA's dot, about 1e-7 apart, which
  moves up to ~0.5% of the values that lie near a rounding boundary of
  65535 steps; the port's 16-bit contract is 64 codes); float32 within
  1e-5;
- S4's twin (``ops/pack.py``) against ``ops/pack.reformat``, each packer
  and unpacker, and ``ops/alpha.py`` against ``ops/alpha.py``: equal;
- S4's HDR mode (``ops/tone.py``) against ``ops/color.hdr_to_sdr`` on PQ,
  HLG, wide-gamut and gamma codes: at most 1 code at 8 bits, 64 at 16
  (the transfer functions' exp differs from XLA's in its last bit);
- S2's twin (``ops/sample.py``) against the reference's numpy box: equal;
- S1's twin (``vardct/post.py`` ``encode_output_down``) against the
  JAX ``down`` pool (``tpu_full.py:862-876``) followed by
  ``_encode_output_device``: at most 1 code on under 0.1% (16 bits: 64).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jxl_coder_tpu.bitstream import headers as JH
from jxl_coder_tpu.ops import alpha as JA
from jxl_coder_tpu.ops import color as JC
from jxl_coder_tpu.ops import pack as JP
from jxl_coder_tpu.ops import resize as JR
from jxl_coder_tpu.vardct import tpu_full as TF
from jxl_coder_tpu_torch.host import api as HA
from jxl_coder_tpu_torch.host.ops import resize as HR
from jxl_coder_tpu_torch.ops import alpha, pack, resize, sample, tone
from jxl_coder_tpu_torch.vardct import post


def _codes(rng, shape, dtype):
    if dtype == np.float32:
        return rng.uniform(0.0, 1.0, shape).astype(np.float32)
    top = 256 if dtype == np.uint8 else 65536
    return rng.integers(0, top, shape).astype(dtype)


def _smooth(rng, h, w, c, dtype):
    """Smooth gradients with noise: what a decoded image holds."""
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    base = np.stack([(0.5 + 0.45 * np.sin(3 * xx + 2 * k + 5 * yy))
                     for k in range(c)], -1)
    f = np.clip(base + rng.normal(0, 0.02, base.shape), 0, 1)
    if dtype == np.float32:
        return f.astype(np.float32)
    top = 255 if dtype == np.uint8 else 65535
    return np.rint(f * top).astype(dtype)


# ---- resample_matrix -------------------------------------------------------

@pytest.mark.parametrize("fid", range(1, 11))
def test_resample_matrix_equals_the_reference(fid):
    for n_in, n_out in [(1, 1), (7, 3), (37, 80), (250, 31), (64, 8),
                        (3, 17)]:
        got = HR.resample_matrix(n_in, n_out, fid)
        ref = JR.resample_matrix(n_in, n_out, fid)
        assert got.dtype == ref.dtype and np.array_equal(got, ref)
        b = HR.band(n_in, n_out, fid)
        dense = np.zeros_like(got)
        for o in range(n_out):
            n = b.length[o]
            dense[o, b.first[o]:b.first[o] + n] = b.weights[o, :n]
        assert np.array_equal(dense, got)


# ---- S3 ----------------------------------------------------------------------

RESIZE_CASES = [(fid, mode, dt, a) for fid in range(1, 11)
                for mode in (1, 2, 3)
                for dt in (np.uint8, np.uint16, np.float32)
                for a in (False, True)]


@pytest.mark.parametrize("fid,mode,dtype,with_alpha", RESIZE_CASES,
                         ids=[f"f{f}-m{m}-{np.dtype(d).name}-{'a' if a else 'o'}"
                              for f, m, d, a in RESIZE_CASES])
def test_rescale_twin_against_the_reference(fid, mode, dtype, with_alpha):
    rng = np.random.default_rng(fid * 7 + mode)
    c = 4 if with_alpha else 3
    img = _smooth(rng, 61, 83, c, dtype)
    tw, th = (37, 29) if fid % 2 else (97, 70)
    ref = JR.rescale_image(img, tw, th, scale_mode=mode, filter_id=fid)
    got = resize.rescale_image(torch.from_numpy(img), tw, th, mode,
                               fid).numpy()
    assert got.shape == ref.shape and got.dtype == ref.dtype
    if dtype == np.float32:
        assert np.abs(got - ref).max() <= 1e-5
        return
    d = np.abs(got.astype(np.int64) - ref.astype(np.int64))
    assert d.max() <= 1
    if dtype == np.uint8:
        assert (d > 0).mean() < 1e-3, (d > 0).mean()


def test_rescale_premultiplied_and_grey_alpha():
    """Associated alpha is filtered as it is; grey + alpha (C 2) is
    premultiplied like RGBA."""
    rng = np.random.default_rng(3)
    for c, pre in ((4, True), (2, False), (1, False)):
        img = _smooth(rng, 40, 52, c, np.uint8)
        ref = JR.rescale_image(img, 20, 33, scale_mode=3, filter_id=5,
                               premultiplied=pre)
        got = resize.rescale_image(torch.from_numpy(img), 20, 33, 3, 5,
                                   pre).numpy()
        d = np.abs(got.astype(np.int64) - ref.astype(np.int64))
        assert got.shape == ref.shape and d.max() <= 1


# ---- S4: the packers, the unpackers, the alpha ops -------------------------

def test_packers_equal_the_reference():
    rng = np.random.default_rng(11)
    f = rng.uniform(-0.1, 1.1, (33, 47, 4)).astype(np.float32)
    f[0, :8] = np.arange(8, dtype=np.float32)[:, None] / 255 + 0.5 / 255
    t = torch.from_numpy(f)
    pairs = [(pack.to_rgba8888, JP.to_rgba8888),
             (pack.to_rgba_f16, JP.to_rgba_f16),
             (pack.to_rgb565, JP.to_rgb565),
             (pack.to_rgba1010102, JP.to_rgba1010102)]
    for ours, theirs in pairs:
        got, ref = ours(t).numpy(), np.asarray(theirs(jnp.asarray(f)))
        assert got.dtype == ref.dtype and np.array_equal(got, ref)
    for config in HA.PreferredColorConfig:
        for bits in (8, 16):
            got = pack.reformat(t, config, bits).numpy()
            ref = JP.reformat(f, int(config), bits)
            assert got.dtype == ref.dtype and np.array_equal(got, ref)
    p565 = rng.integers(0, 1 << 16, (20, 9)).astype(np.uint16)
    p1010 = rng.integers(0, 1 << 32, (20, 9), dtype=np.uint64).astype(
        np.uint32)
    assert np.array_equal(
        pack.from_rgb565(torch.from_numpy(p565)).numpy(),
        np.asarray(JP.from_rgb565(jnp.asarray(p565))))
    assert np.array_equal(
        pack.from_rgba1010102(torch.from_numpy(p1010)).numpy(),
        np.asarray(JP.from_rgba1010102(jnp.asarray(p1010))))


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("c", [1, 3, 4])
def test_reformat_of_codes_equals_the_reference_chain(dtype, c):
    """decode_sampled's tail on codes (api.py:1206-1214): / maxv, grey to
    RGB, an opaque alpha, then reformat."""
    rng = np.random.default_rng(c)
    codes = _codes(rng, (19, 23, c), dtype)
    maxv = 255.0 if dtype == np.uint8 else 65535.0
    f = codes.astype(np.float32) / maxv
    if c == 1:
        f = np.repeat(f, 3, axis=-1)
    if f.shape[-1] == 3:
        f = np.concatenate([f, np.ones_like(f[..., :1])], axis=-1)
    for config in HA.PreferredColorConfig:
        got = pack.reformat(torch.from_numpy(codes), config,
                            16 if dtype == np.uint16 else 8).numpy()
        ref = JP.reformat(f, int(config), 16 if dtype == np.uint16 else 8)
        assert got.dtype == ref.dtype and np.array_equal(got, ref)


def test_alpha_ops_equal_the_reference():
    rng = np.random.default_rng(5)
    u8 = rng.integers(0, 256, (31, 17, 4)).astype(np.uint8)
    u8[0, :4, 3] = (0, 1, 254, 255)
    f = rng.uniform(0, 1, (31, 17, 4)).astype(np.float32)
    f[0, 0, 3] = 0.0
    for ours, theirs, x in ((alpha.premultiply_u8, JA.premultiply_u8, u8),
                            (alpha.unpremultiply_u8, JA.unpremultiply_u8, u8),
                            (alpha.premultiply_f, JA.premultiply_f, f),
                            (alpha.unpremultiply_f, JA.unpremultiply_f, f)):
        got = ours(torch.from_numpy(x)).numpy()
        ref = np.asarray(theirs(jnp.asarray(x)))
        assert got.dtype == ref.dtype and np.array_equal(got, ref)
    for a in (u8[..., 3], np.full((4, 5), 255, np.uint8),
              np.full((3,), 65535, np.uint16), np.full((3,), 7, np.uint16),
              f[..., 3], np.ones((2, 2), np.float32)):
        assert alpha.has_transparency(torch.from_numpy(a)) == \
            JA.has_transparency(a)


# ---- S4: the HDR -> SDR tone map -------------------------------------------

def _ce(trc=13, prim=1, gamma=None):
    ce = JH.ColourEncoding()
    ce.transfer_function = trc
    ce.primaries = prim
    if gamma is not None:
        ce.have_gamma = True
        ce.gamma = int(round(gamma * 1e7))
    return ce


TONE_CASES = [(16, 9, 1000.0), (16, 1, 4000.0), (18, 9, 1000.0),
              (18, 1, 600.0), (13, 9, 255.0), (1, 9, 255.0), (8, 11, 255.0),
              ("gamma", 9, 255.0)]


@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("trc,prim,it", TONE_CASES,
                         ids=[f"{t}-{p}" for t, p, _ in TONE_CASES])
def test_hdr_to_sdr_against_the_reference(trc, prim, it, bits):
    ce = _ce(prim=prim, gamma=1 / 2.2) if trc == "gamma" else _ce(trc, prim)
    assert JC.is_hdr_encoding(ce)
    dtype = np.uint8 if bits == 8 else np.uint16
    rng = np.random.default_rng(bits + prim)
    codes = _codes(rng, (29, 31, 4), dtype)
    ref = JC.hdr_to_sdr(codes, ce, it)
    got = tone.hdr_to_sdr(torch.from_numpy(codes), ce, it).numpy()
    assert got.dtype == ref.dtype and got.shape == ref.shape
    d = np.abs(got.astype(np.int64) - ref.astype(np.int64))
    assert d.max() <= (1 if bits == 8 else 64), d.max()
    assert np.array_equal(got[..., 3], codes[..., 3])


def test_is_hdr_encoding_equals_the_reference():
    from jxl_coder_tpu_torch.host.ops import color as HC
    for ce in (_ce(), _ce(16), _ce(18), _ce(13, 9), _ce(1, 1), None,
               _ce(prim=1, gamma=0.45)):
        assert HC.is_hdr_encoding(ce) == JC.is_hdr_encoding(ce)


# ---- S2 ----------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_box_codes_twin_equals_the_reference_box(dtype):
    rng = np.random.default_rng(2)
    for h, w, c in [(1, 1, 1), (8, 8, 3), (9, 17, 4), (61, 83, 2)]:
        full = _codes(rng, (h, w, c), dtype)
        th, tw = -(-h // 8), -(-w // 8)
        pad = np.pad(full, ((0, th * 8 - h), (0, tw * 8 - w), (0, 0)),
                     mode="edge")
        ref = np.rint(pad.reshape(th, 8, tw, 8, -1).mean(axis=(1, 3))
                      ).astype(dtype)
        got = sample.box_codes(torch.from_numpy(full)).numpy()
        assert got.dtype == ref.dtype and np.array_equal(got, ref)
    # ties round half to even
    ties = np.zeros((8, 16, 1), dtype)
    ties[:4, :8] = 1
    ties[:4, 8:] = 3
    got = sample.box_codes(torch.from_numpy(ties)).numpy()
    assert got.ravel().tolist() == [0, 2]


# ---- S1 ----------------------------------------------------------------------

def _jax_pool(p, down):
    """tpu_full.py:866-875, fn_post's _pool."""
    ph_, pw_ = (-p.shape[0]) % down, (-p.shape[1]) % down
    if ph_ or pw_:
        p = jnp.pad(p, ((0, ph_), (0, pw_)), mode="edge")
    return p.reshape(p.shape[0] // down, down, p.shape[1] // down,
                     down).mean(axis=(1, 3))


SPECS = [("srgb",), ("gamma", 1 / 2.2),
         ("enc", 16, None, 1000.0, (0.2627, 0.678, 0.0593)),
         ("enc", 18, None, 1000.0, (0.2627, 0.678, 0.0593)),
         ("enc", 1, None, 255.0, (0.2126, 0.7152, 0.0722))]


@pytest.mark.parametrize("down", [2, 4, 8])
@pytest.mark.parametrize("spec", SPECS, ids=[str(s[:2]) for s in SPECS])
def test_down_pool_against_the_reference(spec, down):
    rng = np.random.default_rng(down)
    h, w = 173, 250 if down == 4 else 61
    y = rng.uniform(0.0, 0.85, (h, w))
    xyb = np.stack([rng.normal(0.0, 0.012, (h, w)), y,
                    y + rng.normal(0.0, 0.04, (h, w))]).astype(np.float32)
    for bits in (8, 16):
        X, Y, B = (_jax_pool(jnp.asarray(p), down) for p in xyb)
        ref = np.asarray(TF._encode_output_device(X, Y, B, spec, bits))
        got = post.encode_output_down(torch.from_numpy(xyb), spec, bits,
                                      down).numpy()
        assert got.shape == ref.shape == (-(-h // down), -(-w // down), 3)
        d = np.abs(got.astype(np.int64) - ref.astype(np.int64))
        if bits == 16:
            assert d.max() <= 64
        else:
            assert d.max() <= 1 and (d > 0).mean() < 1e-3
