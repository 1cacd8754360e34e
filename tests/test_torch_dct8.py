"""The port's DCT8-only frame path (jxl_coder_tpu_torch.vardct.dct8) and
kernel 7's plain version (vardct.detile) vs the JAX package.

The same seeded numpy arrays go through jxl_coder_tpu.vardct.tpu_real
(the jnp chain on the CPU) and through the port's CPU path.  Random
coefficients fill every basis slot, the DC slot included, so a
transposed Kronecker product or a DC added twice does not pass.

Tolerances: DC smoothing 1e-6 absolute (the same f32 ops; DC values are
O(1)); synthesised planes 1e-4 absolute (f32 sums of 64 terms in another
order); sRGB8 within 1 code on < 0.1% of pixels (the port's decode
contract, ROADMAP); detile exactly (pure data movement).
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from jxl_coder_tpu.vardct import synthesis as S
from jxl_coder_tpu.vardct import tpu_real as TR
from jxl_coder_tpu_torch import reference as R
from jxl_coder_tpu_torch.vardct import dct8, detile as DT
from port_fixtures import bench_frame, dct8_arguments

REPO = Path(__file__).resolve().parent.parent
# 16x16 blocks is the entry() shape of __graft_entry__.py; 13x21 ragged;
# one block tall and one block wide hit tpu_real's i % (n - 1)
SHAPES = [(16, 16), (13, 21), (1, 5), (4, 1)]


def _frame_arrays(ys, xs, seed=7):
    """test_vardct.py:145-158's arrays at (ys, xs) blocks."""
    rng = np.random.default_rng(seed)
    co = rng.normal(0, 20, (3, ys, xs, 64)).astype(np.float32)
    dc = rng.integers(-200, 200, (3, ys, xs)).astype(np.int32)
    qf = rng.integers(4, 40, (ys, xs)).astype(np.int32)
    sh = rng.integers(0, 8, (ys, xs)).astype(np.int32)
    xf = rng.normal(0, 0.3, (ys, xs)).astype(np.float32)
    bf = rng.normal(1.0, 0.3, (ys, xs)).astype(np.float32)
    tb = np.stack([S.dequant_table(0, c) for c in range(3)]).astype(
        np.float32)
    return (co, dc, qf, sh, xf, bf, tb, np.float32(1.2), np.float32(0.8),
            np.asarray([0.6, 1.0, 1.5], np.float32), np.float32(0.8),
            np.float32(0.64))


def _within_one_code(got, ref):
    assert got.shape == ref.shape and got.dtype == ref.dtype
    d = np.abs(got.astype(np.int64) - ref.astype(np.int64))
    assert d.max() <= 1 and (d > 0).mean() < 1e-3, (
        d.max(), float((d > 0).mean()))


@pytest.mark.parametrize("ys,xs", SHAPES)
def test_dc_smoothing(ys, xs):
    rng = np.random.default_rng(ys * 100 + xs)
    dc = rng.normal(0, 0.02, (3, ys, xs)).astype(np.float32)
    steps = np.asarray([0.004, 0.01, 0.02], np.float32)
    ref = np.asarray(TR.dc_smoothing_device(dc, steps))
    got = dct8.dc_smoothing(torch.from_numpy(dc), steps).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    if ys == 1 or xs == 1:
        assert np.array_equal(got, dc)    # every sample is a border one


@pytest.mark.parametrize("skip_dc_smooth", [False, True])
@pytest.mark.parametrize("ys,xs", SHAPES)
def test_synth_planes(ys, xs, skip_dc_smooth):
    a = _frame_arrays(ys, xs)
    co, dc, qf, sh, xf, bf, tb, igs, qdc, dcq, qmx, qmb = a
    ref = np.stack([np.asarray(p) for p in TR.synth_dct8_planes(
        co, dc, qf, xf, bf, tb, igs, qdc, dcq, qmx, qmb, skip_dc_smooth)])
    st = dct8.to_device(*a, "cpu")
    got = dct8.synth_dct8_planes(
        st["coeffs"], st["dc"], st["qf"], st["xf"], st["bf"], st["table"],
        igs, qdc, dcq, qmx, qmb, skip_dc_smooth).numpy()
    assert got.shape == (3, 8 * ys, 8 * xs)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)


@pytest.mark.parametrize("skip_dc_smooth", [False, True])
@pytest.mark.parametrize("gab,epf_iters", [(True, 0), (True, 1), (False, 1),
                                           (True, 2), (True, 3)])
@pytest.mark.parametrize("ys,xs", SHAPES[:2])
def test_reconstruct_dct8_frame(ys, xs, gab, epf_iters, skip_dc_smooth):
    a = _frame_arrays(ys, xs)
    ref = np.asarray(TR.reconstruct_dct8_frame(*a, gab, epf_iters,
                                               skip_dc_smooth))
    got = dct8.DCT8Frame(gab, epf_iters, skip_dc_smooth)(
        dct8.to_device(*a, "cpu")).numpy()
    _within_one_code(got, ref)


def test_dct8_frame_of_a_real_stream_vs_jax_and_host():
    """An effort-2 stream (all DCT8) through the port's parse: the port's
    path against tpu_real on the same arrays, and against the float64
    host decode of the stream (a frame a multiple of 8 in each side, so
    both filter the same grid)."""
    img = bench_frame(64, 96)
    data = R.encode_vardct(img, distance=1.0, effort=2)
    args, (gab, epf_iters, skip) = dct8_arguments(data)
    assert (gab, epf_iters) == (True, 1)
    got = dct8.DCT8Frame(gab, epf_iters, skip)(
        dct8.to_device(*args, "cpu")).numpy()
    _within_one_code(got, np.asarray(TR.reconstruct_dct8_frame(
        *args, gab, epf_iters, skip)))
    _within_one_code(got, R.decode_float64(data))


@pytest.mark.parametrize("with_rows", [False, True])
def test_detile_plain(with_rows):
    rng = np.random.default_rng(3)
    ny, nx, n_src = 5, 7, 50
    src = rng.standard_normal((n_src, 192)).astype(np.float32)
    rows = (rng.permutation(n_src)[:ny * nx] if with_rows
            else np.arange(ny * nx))
    ref = np.zeros((3, 8 * ny, 8 * nx), np.float32)
    for by in range(ny):
        for bx in range(nx):
            t = src[rows[by * nx + bx]].reshape(3, 8, 8)
            ref[:, 8 * by:8 * by + 8, 8 * bx:8 * bx + 8] = t
    got = DT.detile(torch.from_numpy(src), ny, nx,
                    torch.from_numpy(rows.astype(np.int32))
                    if with_rows else None)
    assert np.array_equal(got.numpy(), ref)


def test_detile_plain_vs_the_probe():
    """detile_plain against research/detile_probe.py's v0 and its Pallas
    kernel v2 (interpreted), at the probe's own 4K shape with a seeded
    permutation subset.  A subprocess: importing the probe rewrites jax's
    compile-cache configuration."""
    code = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {str(REPO)!r})
        sys.path.insert(0, {str(REPO / "research")!r})
        import numpy as np, torch, jax
        from jax.experimental.pallas import tpu as pltpu
        import detile_probe as P
        from jxl_coder_tpu_torch.vardct.detile import detile_plain
        rng = np.random.default_rng(0)
        src = rng.standard_normal((P.NSRC, 192)).astype(np.float32)
        perm = rng.permutation(P.NSRC)[:P.NY * P.NX].astype(np.int32)
        got = detile_plain(torch.from_numpy(src), P.NY, P.NX,
                           torch.from_numpy(perm)).numpy()
        v0 = np.asarray(jax.jit(P.v0)(src, perm))
        with pltpu.force_tpu_interpret_mode():
            v2 = np.asarray(jax.jit(P.v2)(src, perm))
        print(got.shape, np.array_equal(got, v0), np.array_equal(got, v2))
    """)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, env=env)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.split() == ["(3,", "2160,", "3840)", "True", "True"]


def test_detile_checks_its_arguments():
    src = torch.zeros((10, 192))
    with pytest.raises(ValueError, match="identity index needs 12"):
        DT.detile(src, 3, 4)
    with pytest.raises(ValueError, match="int32"):
        DT.detile(src, 2, 2, torch.arange(4))
    with pytest.raises(ValueError, match="192"):
        DT.detile(torch.zeros((10, 64)), 1, 1)
