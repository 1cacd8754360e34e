"""Port filter chain + sRGB output (jxl_coder_tpu_torch.vardct.filters
restore_and_output, on a CPU tensor its plain version, and color) vs the
JAX package, on seeded planes.

References: the TPU kernel filters_pallas.fused_real_filters3 run in
interpret mode (its own domain: W % 128 == 0, uniform gaborish weights,
epf_iters 1-2), and the jnp chain tpu_full._filters_chain_device for
what the kernel does not take (ragged widths, per-channel gaborish
weights, epf_iters 3, gaborish off).

Tolerances: float32 planes within 1e-5 absolute (same formulas; the
TPU kernel sums its SADs in another order); 8-bit output within 1 code
on < 0.1% of pixels; 16-bit output within 64 codes (the f32 rounding
flips of the 8-bit bound, scaled by 257).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from jxl_coder_tpu.vardct import tpu_full as TF
from jxl_coder_tpu.vardct import tpu_real as TR
from jxl_coder_tpu_torch.vardct import color as C
from jxl_coder_tpu_torch.vardct import filters as F

TOL_F32 = 1e-5
DEFAULT_GABW = (0.115169525, 0.061248592) * 3


def _planes(h, w, seed):
    """Smooth XYB-like planes plus noise, and a per-block sigma map with
    inactive blocks (sigma below the EPF gate)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([0.02 * np.sin(xx / 7.0), 0.4 + 0.2 * np.cos(yy / 5.0),
                     0.35 + 0.2 * np.sin((xx + yy) / 9.0)])
    x = (base + rng.normal(0, 0.01, base.shape)).astype(np.float32)
    sigma = rng.uniform(0.0, 2.5, (-(-h // 8), -(-w // 8))).astype(
        np.float32)
    return x, sigma


def _assert_u8(got, ref):
    d = np.abs(got.astype(int) - ref.astype(int))
    assert d.max() <= 1 and (d > 0).mean() < 1e-3


@pytest.mark.parametrize("h,w,epf_iters,out", [
    (32, 128, 1, "f32"), (32, 128, 2, "u8"), (32, 128, 2, "u16"),
    (48, 256, 2, "f32"), (48, 256, 1, "u8"), (48, 256, 1, "u16")])
def test_filters_vs_pallas_kernel(h, w, epf_iters, out):
    from jxl_coder_tpu.vardct.filters_pallas import fused_real_filters3
    x, sigma = _planes(h, w, seed=h + w + epf_iters)
    inv = F.epf_inv(torch.from_numpy(sigma), 1.0)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(fused_real_filters3(
            jnp.asarray(x[0]), jnp.asarray(x[1]), jnp.asarray(x[2]),
            jnp.asarray(inv.numpy()), tile=8, epf_iters=epf_iters,
            to_srgb=out != "f32", bits=16 if out == "u16" else 8))
    got = F.restore_and_output(torch.from_numpy(x), torch.from_numpy(sigma),
                               True, epf_iters, DEFAULT_GABW, 0.9, 6.5, out)
    if out == "f32":
        assert np.abs(got.numpy() - ref).max() <= TOL_F32
        return
    rgb = got.numpy()
    ref = np.moveaxis(ref, 0, -1)
    assert rgb.dtype == ref.dtype
    if out == "u8":
        _assert_u8(rgb, ref)
    else:
        assert np.abs(rgb.astype(int) - ref.astype(int)).max() <= 64


NONUNIFORM_GABW = (0.12, 0.05, 0.115169525, 0.061248592, 0.09, 0.07)


@pytest.mark.parametrize("h,w,gab,gabw,epf_iters", [
    (40, 200, True, NONUNIFORM_GABW, 3),
    (37, 200, True, NONUNIFORM_GABW, 1),
    (40, 200, False, DEFAULT_GABW, 3),
    (37, 203, True, DEFAULT_GABW, 2),
    (21, 45, False, DEFAULT_GABW, 1),
    (40, 200, True, NONUNIFORM_GABW, 0),
    # kernel 2's tile pass takes every configuration: epf_iters 0-3,
    # per-channel weights, gaborish off, ragged sizes and sizes below
    # its halo
    (37, 203, True, NONUNIFORM_GABW, 3),
    (37, 203, False, NONUNIFORM_GABW, 2),
    (21, 45, True, NONUNIFORM_GABW, 2),
    (21, 45, True, DEFAULT_GABW, 3),
    (21, 45, True, DEFAULT_GABW, 0),
    (21, 45, False, DEFAULT_GABW, 0),
    (3, 5, True, NONUNIFORM_GABW, 3),
    (7, 2, True, NONUNIFORM_GABW, 2),
    (13, 21, False, NONUNIFORM_GABW, 1)])
def test_filters_vs_jnp_chain(h, w, gab, gabw, epf_iters):
    x, sigma = _planes(h, w, seed=h * w + epf_iters)
    ref = TF._filters_chain_device(
        jnp.asarray(x[0]), jnp.asarray(x[1]), jnp.asarray(x[2]),
        jnp.asarray(sigma), gab, epf_iters, np.asarray(gabw, np.float32),
        0.9, 6.5)
    args = (torch.from_numpy(x), torch.from_numpy(sigma), gab, epf_iters,
            gabw, 0.9, 6.5)
    got = F.restore_and_output(*args, "f32")
    assert np.abs(got.numpy() - np.stack([np.asarray(p) for p in ref])
                  ).max() <= TOL_F32
    # with the output stage, against tpu_real's / tpu_full's on the jnp
    # chain's planes
    rgb8 = F.restore_and_output(*args, "u8").numpy()
    _assert_u8(rgb8, np.asarray(TR.xyb_to_srgb8_device(*ref)))
    rgb16 = F.restore_and_output(*args, "u16").numpy()
    ref16 = np.asarray(TF._xyb_to_srgb16_device(*ref))
    assert np.abs(rgb16.astype(int) - ref16.astype(int)).max() <= 64


def test_filters_accept_cropped_views():
    """The frame filters a crop of the block-grid planes: a strided view
    must give what its contiguous copy gives."""
    x, sigma = _planes(48, 64, seed=5)
    view = torch.from_numpy(x)[:, :41, :59]
    sig = torch.from_numpy(sigma)[:6, :8]
    for out in ("f32", "u8"):
        a = F.restore_and_output(view, sig, True, 3, NONUNIFORM_GABW, 0.9,
                                 6.5, out)
        b = F.restore_and_output(view.contiguous(), sig, True, 3,
                                 NONUNIFORM_GABW, 0.9, 6.5, out)
        assert torch.equal(a, b)
    assert torch.equal(C.xyb_to_srgb_plain(view, False),
                       C.xyb_to_srgb_plain(view.contiguous(), False))


def test_fast_linear_to_srgb_matches_jax_bit_trick():
    """The int32-view twin of the exponent trick equals tpu_real's
    uint32 version bit for bit, negative and tiny values included."""
    rng = np.random.default_rng(11)
    v = np.concatenate([rng.uniform(-0.2, 1.3, 4000),
                        10.0 ** rng.uniform(-8, 0, 1000),
                        [0.0, -0.0, 0.0031308, 1.0]]).astype(np.float32)
    got = C.fast_linear_to_srgb(torch.from_numpy(v)).numpy()
    ref = np.asarray(TR.fast_linear_to_srgb_device(jnp.asarray(v)))
    assert np.array_equal(got.view(np.uint32), ref.view(np.uint32))


@pytest.mark.parametrize("scale", [1.0, 0.9, 6.5, 0.57])
def test_kernel_slope_formula_equals_epf_inv(scale):
    """The slope the tile pass computes per block, s >= gate ? c / max(s,
    1e-9) : 0 with the f32 constants the wrapper hands it, equals
    epf_inv bit for bit, at the gate and its neighbours included."""
    consts = F.kernel_consts(DEFAULT_GABW, scale, scale)
    gate, c = consts[13], consts[14]
    assert consts[15] == c
    rng = np.random.default_rng(3)
    near = np.float32(gate) + np.arange(-4, 5, dtype=np.float32) * np.spacing(
        np.float32(gate))
    sigma = np.concatenate([rng.uniform(0.0, 3.0, 4000), near,
                            [0.0, 1e-12, 1e-9, 2.7e-1, 1e6]]).astype(np.float32)
    s = torch.from_numpy(sigma)
    f32 = (lambda v: torch.tensor(v, dtype=torch.float32))
    kernel = torch.where(s >= f32(gate), f32(c) / torch.maximum(s, f32(1e-9)),
                         f32(0.0))
    ref = F.epf_inv(s, scale)
    assert np.array_equal(kernel.numpy().view(np.uint32),
                          ref.numpy().view(np.uint32))
