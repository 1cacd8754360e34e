"""The port's round-1 VarDCT codec (jxl_coder_tpu_torch.codec, vardct.
pipeline / dct / xyb, ops.color) against the JAX package on the CPU.

Tolerances: the encoder front (transfer functions, XYB, DCT, quantise)
is rounded as the JAX package rounds it on the CPU (ops.fp), so it is
held to equality, bytes included.  The decode side (dequant, IDCT,
filters) is held to 1e-5 in float32 (the jnp chain fuses some a * b + c
into one rounding; the port rounds each op), to 1 code on < 0.1% of
pixels at 8 bits and to 64 codes at 16 bits.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from jxl_coder_tpu import codec as JC
from jxl_coder_tpu.ops import color as JCOL
from jxl_coder_tpu.vardct import dct as JD
from jxl_coder_tpu.vardct import pipeline as JP
from jxl_coder_tpu.vardct import xyb as JX
from jxl_coder_tpu_torch import api, codec
from jxl_coder_tpu_torch.ops import color, fp
from jxl_coder_tpu_torch.vardct import dct, pipeline as P, xyb
from port_fixtures import bench_frame, smooth_frame

TOL_F32 = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _within_codes(got, ref, bits):
    assert got.shape == ref.shape and got.dtype == ref.dtype
    d = np.abs(got.astype(int) - ref.astype(int))
    if bits > 8:
        assert d.max() <= 64
    else:
        assert d.max() <= 1 and (d > 0).mean() < 1e-3


@pytest.mark.parametrize("y", [1 / 3, 2.4, 1 / 2.4])
def test_powf_rounds_as_jnp(y):
    rng = np.random.default_rng(1)
    x = np.concatenate([rng.uniform(1e-12, 1.5, 40000),
                        10.0 ** rng.uniform(-12, 0.3, 40000)]).astype(np.float32)
    ref = np.asarray(jnp.cbrt(jnp.asarray(x)) if y == 1 / 3
                     else jnp.asarray(x) ** y)
    assert np.array_equal(fp.powf(_t(x), y).numpy(), ref)


def test_transfer_functions_equal_jnp():
    rng = np.random.default_rng(2)
    v = np.concatenate([np.arange(65536) / 65535,
                        rng.uniform(-0.1, 1.2, 20000)]).astype(np.float32)
    assert np.array_equal(color.srgb_to_linear(_t(v)).numpy(),
                          np.asarray(JCOL.srgb_to_linear(jnp.asarray(v))))
    assert np.array_equal(color.linear_to_srgb(_t(v)).numpy(),
                          np.asarray(JCOL.linear_to_srgb(jnp.asarray(v))))


def test_xyb_both_ways_vs_jax():
    rng = np.random.default_rng(3)
    rgb = rng.uniform(-0.01, 1.05, (3, 24, 40)).astype(np.float32)
    fwd = xyb.linear_rgb_to_xyb(_t(rgb)).numpy()
    ref = np.asarray(JX.linear_rgb_to_xyb(jnp.asarray(rgb)))
    assert np.array_equal(fwd, ref)
    back = xyb.xyb_to_linear_rgb(_t(ref)).numpy()
    ref_back = np.asarray(JX.xyb_to_linear_rgb(jnp.asarray(ref)))
    assert np.abs(back - ref_back).max() <= 1e-6 * np.abs(ref_back).max()


@pytest.mark.parametrize("shape", [(3, 4, 5, 8, 8), (2, 8, 8)])
def test_dct_idct_vs_jax(shape):
    rng = np.random.default_rng(4)
    b = rng.normal(0, 0.3, shape).astype(np.float32)
    assert np.array_equal(dct.dct2d(_t(b)).numpy(),
                          np.asarray(JD.dct2d(jnp.asarray(b))))
    got = dct.idct2d(_t(b)).numpy()
    assert np.abs(got - np.asarray(JD.idct2d(jnp.asarray(b)))).max() <= TOL_F32
    img = rng.normal(0, 1, (3, 16, 24)).astype(np.float32)
    blocks = dct.blockify(_t(img))
    assert np.array_equal(blocks.numpy(),
                          np.asarray(JD.blockify(jnp.asarray(img))))
    assert torch.equal(dct.unblockify(blocks), _t(img))


def test_quantize_coeffs_equal_jax():
    rgb = bench_frame(40, 56).transpose(2, 0, 1)
    xyb_ref = np.asarray(JP.forward_xyb(jnp.asarray(rgb)))
    got_xyb = P.forward_xyb(_t(rgb)).numpy()
    assert np.abs(got_xyb - xyb_ref).max() <= TOL_F32
    qf = np.full((5, 7), 8, np.int32)
    q, dc = JP.quantize_coeffs(jnp.asarray(xyb_ref), jnp.asarray(qf),
                               jnp.float32(1.5))
    gq, gdc = P.quantize_coeffs(_t(xyb_ref), _t(qf), 1.5)
    assert np.array_equal(gq.numpy(), np.asarray(q))
    assert np.array_equal(gdc.numpy(), np.asarray(dc))


def _frame_arrays(h, w, seed, qf_lo=4, qf_hi=12):
    """Seeded quantised arrays in the VarDctFrameData layout."""
    rng = np.random.default_rng(seed)
    ny, nx = -(-h // 8), -(-w // 8)
    ac = rng.integers(-6, 7, (3, ny, nx, 8, 8)).astype(np.int32)
    ac[rng.random(ac.shape) < 0.6] = 0
    ac[:, :, :, 0, 0] = 0
    dc = np.stack([rng.integers(-20, 20, (ny, nx)),
                   rng.integers(300, 500, (ny, nx)),
                   rng.integers(-40, 40, (ny, nx))]).astype(np.int32)
    qf = rng.integers(qf_lo, qf_hi, (ny, nx)).astype(np.int32)
    ty, tx = -(-ny // 8), -(-nx // 8)
    cfl_x = rng.integers(-8, 8, (ty, tx)).astype(np.int32)
    cfl_b = rng.integers(56, 72, (ty, tx)).astype(np.int32)
    return ac, dc, qf, cfl_x, cfl_b, 1.25


def _both(arrays):
    ac, dc, qf, cfl_x, cfl_b, d = arrays
    jax_args = (jnp.asarray(ac.astype(np.int16)), jnp.asarray(dc),
                jnp.asarray(qf), jnp.asarray(cfl_x), jnp.asarray(cfl_b),
                jnp.float32(d))
    port_args = (_t(ac.astype(np.int16)), _t(dc), _t(qf), _t(cfl_x),
                 _t(cfl_b), d)
    return jax_args, port_args


def test_dequant_idct_vs_jax():
    jax_args, port_args = _both(_frame_arrays(24, 40, seed=5))
    ac, dc, qf, cfl_x, cfl_b, d = jax_args
    fx, fb = JP.expand_cfl(cfl_x, cfl_b, 3, 5)
    ref = np.asarray(JP.dequant_idct(ac, dc, qf, fx, fb, d))
    pac, pdc, pqf, pcx, pcb, pd = port_args
    pfx, pfb = P.expand_cfl(pcx, pcb, 3, 5)
    assert np.array_equal(pfx.numpy(), np.asarray(fx))
    got = P.dequant_idct(pac, pdc, pqf, pfx, pfb, pd).numpy()
    assert np.abs(got - ref).max() <= TOL_F32


@pytest.mark.parametrize("gab", [True, False])
@pytest.mark.parametrize("epf_iters", [0, 1, 2])
def test_apply_filters_vs_jax(gab, epf_iters):
    rng = np.random.default_rng(6 + epf_iters)
    halo = P.filter_halo(epf_iters, gab)
    img = (rng.normal(0, 0.05, (3, 20 + 2 * halo, 29))
           + np.array([0.01, 0.45, 0.4])[:, None, None]).astype(np.float32)
    inv = rng.uniform(0.5, 3.0, (20 + 2 * halo, 29)).astype(np.float32)
    ref = np.asarray(JP.apply_filters(jnp.asarray(img), jnp.asarray(inv),
                                      epf_iters, gab))
    got = P.apply_filters(_t(img), _t(inv), epf_iters, gab).numpy()
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= TOL_F32


@pytest.mark.parametrize("h,w,gab,epf_iters", [
    (24, 40, True, 1), (16, 136, True, 0), (24, 40, False, 1),
    (16, 24, True, 2), (16, 24, False, 0)])
def test_reconstruct_vs_jax(h, w, gab, epf_iters):
    jax_args, port_args = _both(_frame_arrays(h, w, seed=h + w + epf_iters))
    ref = np.asarray(JP.reconstruct_xyb(*jax_args, epf_iters=epf_iters,
                                        gab=gab))
    got = P.reconstruct_xyb(*port_args, epf_iters=epf_iters, gab=gab)
    assert np.abs(got.numpy() - ref).max() <= TOL_F32
    ref8 = np.asarray(JP.reconstruct_srgb8(*jax_args, epf_iters=epf_iters,
                                           gab=gab))
    got8 = P.reconstruct_srgb8(*port_args, epf_iters=epf_iters, gab=gab)
    _within_codes(got8.numpy(), ref8, 8)
    _within_codes(P.xyb_to_u16(got).numpy(),
                  np.asarray(JP.xyb_to_u16(jnp.asarray(ref))), 16)


@pytest.mark.parametrize("h,w,dtype,speed", [
    (64, 96, np.uint8, 0), (37, 53, np.uint8, 0), (37, 53, np.uint16, 0),
    (64, 96, np.uint8, 4)])
def test_encode_bytes_equal_jax(h, w, dtype, speed):
    img = bench_frame(h, w) if dtype == np.uint8 else \
        smooth_frame(h, w, dtype=np.uint16)
    ref = JC.encode_vardct_still(img, 1.0, decoding_speed=speed)
    assert codec.encode_vardct_still(img, 1.0, decoding_speed=speed,
                                      device="cpu") == ref


@pytest.mark.parametrize("h,w,dtype,speed,distance", [
    (64, 96, np.uint8, 0, 1.0), (45, 71, np.uint8, 2, 2.0),
    (40, 48, np.uint8, 4, 1.0), (37, 53, np.uint16, 0, 1.0),
    (48, 64, np.uint16, 2, 1.5)])
def test_decode_vs_jax(h, w, dtype, speed, distance):
    img = smooth_frame(h, w, seed=h, dtype=dtype)
    data = JC.encode_vardct_still(img, distance, decoding_speed=speed)
    parts = api._read_frame(data)
    ref = JC.decode_vardct_still(*parts)
    got = codec.decode_vardct_still(*parts, device="cpu")
    assert got.shape == (h, w, 3)
    _within_codes(got, ref, 16 if dtype == np.uint16 else 8)


def test_inputs_from_frame_data_narrows_like_the_jax_codec():
    from jxl_coder_tpu.vardct.frame import VarDctFrameData
    ac, dc, qf, cfl_x, cfl_b, d = _frame_arrays(16, 24, seed=9)
    data = VarDctFrameData(ac=ac.reshape(3, 2, 3, 64), dc=dc, qf=qf,
                           cfl_x=cfl_x, cfl_b=cfl_b, distance=d)
    arrays = P.inputs_from_frame_data(data, "cpu")
    assert arrays.ac.dtype == torch.int16 and arrays.ac.shape == (3, 2, 3, 8, 8)
    assert np.array_equal(arrays.ac.numpy(), ac)
    data.ac = data.ac.copy()
    data.ac[0, 0, 0, 5] = 40000
    assert P.inputs_from_frame_data(data, "cpu").ac.dtype == torch.int32


@pytest.mark.parametrize("fn", ["quantize_still", "encode_vardct_still",
                                "reconstruct_vardct_still",
                                "decode_vardct_still"])
def test_codec_entry_points_default_to_the_card(fn):
    """The port's entry points run on the card unless the caller asks for
    the CPU."""
    import inspect
    assert inspect.signature(getattr(codec, fn)).parameters[
        "device"].default == "cuda"


def test_decode_without_a_card_raises_before_decoding(monkeypatch):
    """With no device named and no card, decode_vardct_still raises the
    device's RuntimeError and never decodes on the CPU."""
    img = smooth_frame(16, 24, seed=1)
    parts = api._read_frame(JC.encode_vardct_still(img, 1.0))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    called = []
    for name in ("read_vardct_still", "reconstruct_vardct_still"):
        monkeypatch.setattr(codec, name,
                            lambda *a, _n=name, **k: called.append(_n))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        codec.decode_vardct_still(*parts)
    assert called == []
