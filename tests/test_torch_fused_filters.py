"""The port's fused filter kernels (jxl_coder_tpu_torch.vardct.
fused_filters, TPU kernels 3-6) on the CPU: each entry point's plain
twin against its Pallas kernel run in interpret mode, and the unpadded
form the pipeline calls against the jnp chain at ragged sizes.

Tolerances: float32 within 1e-5 (same formulas; XLA fuses some
a * b + c into one rounding); 8-bit output within 1 code on < 0.1% of
values; 16-bit within 64 codes.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from jxl_coder_tpu.vardct import filters_pallas as FPJ
from jxl_coder_tpu.vardct import pipeline as JP
from jxl_coder_tpu_torch.vardct import filters as F
from jxl_coder_tpu_torch.vardct import fused_filters as FF

TOL_F32 = 1e-5
PAD = FF.PAD


def _xyb(h, w, seed):
    """XYB-like planes plus noise, rows padded by PAD with neighbours of
    the same statistics (the padded interface takes any rows there)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h + 2 * PAD, 0:w]
    base = np.stack([0.02 * np.sin(xx / 7.0), 0.45 + 0.2 * np.cos(yy / 5.0),
                     0.4 + 0.2 * np.sin((xx + yy) / 9.0)])
    return (base + rng.normal(0, 0.01, base.shape)).astype(np.float32)


def _compare(got, ref, kind):
    got = np.asarray(got)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    if kind == "f32":
        assert np.abs(got - ref).max() <= TOL_F32
        return
    d = np.abs(got.astype(int) - ref.astype(int))
    if kind == "u16":
        assert d.max() <= 64
    else:
        assert d.max() <= 1 and (d > 0).mean() < 1e-3


@pytest.mark.parametrize("h,w", [(32, 128), (48, 256)])
def test_fused_gab_epf_vs_pallas(h, w):
    x = _xyb(h, w, seed=h)
    inv = np.random.default_rng(w).uniform(0.5, 3.0, (h + 2 * PAD, w)
                                           ).astype(np.float32)
    stacked = np.concatenate([x, inv[None]])
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(FPJ.fused_gab_epf(jnp.asarray(stacked), tile=8))
    _compare(FF.fused_gab_epf(torch.from_numpy(stacked)).numpy(), ref, "f32")


@pytest.mark.parametrize("to_srgb", [False, True])
def test_fused_filters2_vs_pallas(to_srgb):
    h, w = 32, 128
    x = _xyb(h, w, seed=7)
    inv = np.random.default_rng(8).uniform(0.5, 3.0, (h + 2 * PAD, w)
                                           ).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(FPJ.fused_filters2(jnp.asarray(x), jnp.asarray(inv),
                                            tile=16, to_srgb=to_srgb))
    got = FF.fused_filters2(torch.from_numpy(x), torch.from_numpy(inv),
                            to_srgb)
    _compare(got.numpy(), ref, "u8" if to_srgb else "f32")


def _inv_blocks(h, w, seed):
    sigma = np.random.default_rng(seed).uniform(
        0.0, 2.5, (-(-h // 8), -(-w // 8))).astype(np.float32)
    return F.epf_inv(torch.from_numpy(sigma), 1.0)


@pytest.mark.parametrize("epf_iters,out", [
    (1, "f32"), (1, "u8"), (2, "f32"), (2, "u8"), (2, "u16")])
def test_fused_real_filters_vs_pallas(epf_iters, out):
    h, w = 32, 128
    x = _xyb(h, w, seed=10 + epf_iters)
    inv = _inv_blocks(h, w, seed=11)
    kw = dict(epf_iters=epf_iters, to_srgb=out != "f32",
              bits=16 if out == "u16" else 8)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(FPJ.fused_real_filters(
            jnp.asarray(x), jnp.asarray(inv.numpy()), tile=8, **kw))
    got = FF.fused_real_filters(torch.from_numpy(x), inv, **kw)
    _compare(got.numpy(), ref, out)


@pytest.mark.parametrize("out", ["f32", "u8"])
def test_fused_real_gab_epf1_vs_pallas(out):
    h, w = 32, 128
    x = _xyb(h, w, seed=13)
    inv = _inv_blocks(h, w, seed=14)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(FPJ.fused_real_gab_epf1(
            jnp.asarray(x), jnp.asarray(inv.numpy()), tile=8,
            to_srgb=out == "u8"))
    got = FF.fused_real_gab_epf1(torch.from_numpy(x), inv, out == "u8")
    _compare(got.numpy(), ref, out)


@pytest.mark.parametrize("h,w,epf_iters", [(40, 72, 1), (37, 61, 2)])
def test_fused_real_filters_equals_the_three_stage_chain(h, w, epf_iters):
    """Kernel 3 on edge-padded planes is kernel 2's chain (gaborish ->
    EPF1 -> EPF2, its plain version) on the unpadded ones, at any H x W; kernel 4
    differs from it only within 2 pixels of the border (edge instead of
    Mirror)."""
    x = _xyb(h, w, seed=15)[:, PAD:-PAD]
    xp = np.pad(x, ((0, 0), (PAD, PAD), (0, 0)), mode="edge")
    sigma = np.random.default_rng(16).uniform(
        0.0, 2.5, (-(-h // 8), -(-w // 8))).astype(np.float32)
    sig = torch.from_numpy(sigma)
    chain = F.filter_chain_plain(torch.from_numpy(x), sig, True, epf_iters,
                                 (FF.DEFAULT_GW1, FF.DEFAULT_GW2) * 3, 0.9,
                                 6.5)
    got = FF.fused_real_filters(torch.from_numpy(xp), F.epf_inv(sig, 1.0),
                                epf_iters=epf_iters, pass2_scale=6.5)
    assert np.abs(got.numpy() - chain.numpy()).max() <= TOL_F32
    if epf_iters == 1:
        g4 = FF.fused_real_gab_epf1(torch.from_numpy(xp), F.epf_inv(sig, 1.0))
        inner = (slice(None), slice(2, -2), slice(2, -2))
        assert np.abs(g4.numpy()[inner] - chain.numpy()[inner]).max() \
            <= TOL_F32


@pytest.mark.parametrize("h,w,gab,epf,to_srgb", [
    (21, 45, True, True, True), (21, 45, True, True, False),
    (13, 30, False, True, False), (13, 30, True, False, True),
    (9, 17, False, False, True)])
def test_legacy_filters_unpadded_vs_jnp_chain(h, w, gab, epf, to_srgb):
    """The pipeline's form: unpadded planes of any size, halos made by
    clamping; the reference pads rows as reconstruct_xyb does."""
    x = _xyb(h, w, seed=h * w)[:, PAD:-PAD]
    inv = np.random.default_rng(w).uniform(0.5, 3.0, (h, w)
                                           ).astype(np.float32)
    halo = JP.filter_halo(int(epf), gab)
    ref = JP.apply_filters(JP.pad_rows(jnp.asarray(x), halo),
                           JP.pad_rows(jnp.asarray(inv), halo), int(epf), gab)
    if to_srgb:
        ref = JP.xyb_to_srgb8(ref)
    got = FF.legacy_filters(torch.from_numpy(x), torch.from_numpy(inv), gab,
                            epf, to_srgb)
    _compare(got.numpy(), np.asarray(ref), "u8" if to_srgb else "f32")


def test_fused_entry_points_check_their_inputs():
    x = torch.zeros((3, 2 * PAD, 16))
    with pytest.raises(ValueError, match="no image rows"):
        FF._legacy_launch(x, x[0], PAD, True, True, False)
    with pytest.raises(ValueError, match="inv_blocks"):
        FF._real_launch(torch.zeros((3, 24, 16)), torch.zeros((1, 1)), True,
                        False, FF._real_taps(0.1, 0.05), 1.0, 0)
