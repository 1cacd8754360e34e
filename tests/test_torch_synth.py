"""Port synthesis (jxl_coder_tpu_torch.vardct.synth) vs the JAX package.

The port's plain PyTorch twin writes each family's pixels straight into
the frame planes; the JAX references return flat 8x8 tile rows that
tpu_full._build_fn assembles with the perm_inv gather + detile, which
the helper below reproduces exactly (tpu_full.py:766-771).  Inputs are
made with numpy from a seed and handed to both sides.

Tolerances: 1e-5 absolute against the float32 JAX paths on the CPU
(same formulas, sums in another order; pixels are O(1)); 1e-4 against
the float64 host reconstruction for DCT128/256 (float32 sums of up to
256 terms per separable pass).
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from jxl_coder_tpu.vardct import tpu_full as TF
from jxl_coder_tpu.vardct.strategies import STRATEGIES
from jxl_coder_tpu_torch.vardct import inputs as I
from jxl_coder_tpu_torch.vardct import synth as SY
from port_fixtures import sharp_frame, smooth_frame, synthetic_family

TOL_F32 = 1e-5
TOL_F64 = 1e-4
DTYPES = {"int8": np.int8, "int16": np.int16, "int32": np.int32}


def _jax_frame(tiles, fams_desc, ys_b, xs_b):
    """perm_inv gather + 24-slice detile of tpu_full._build_fn."""
    perm_inv = np.zeros(ys_b * xs_b, np.int32)
    off = 0
    for (sid, n_pad, bh, bw, _cov, _sp), fam in fams_desc:
        n = int(np.sum(fam["bys"] != TF._PAD_SENTINEL))
        sh, sw = bh // 8, bw // 8
        byv = fam["bys"][:n].astype(np.int64)
        bxv = fam["bxs"][:n].astype(np.int64)
        for ty in range(sh):
            for tx in range(sw):
                perm_inv[(byv + ty) * xs_b + bxv + tx] = (
                    off + np.arange(n) * sh * sw + ty * sw + tx)
        off += n_pad * sh * sw
    all_tiles = jnp.concatenate(tiles, axis=0)
    g = all_tiles[perm_inv].reshape(ys_b, xs_b, 3, 8, 8)
    rows = [g[:, :, c, py, :] for c in range(3) for py in range(8)]
    st = jnp.stack(rows, axis=0).reshape(3, 8, ys_b, xs_b * 8)
    return np.asarray(st.transpose(0, 2, 1, 3).reshape(3, ys_b * 8,
                                                       xs_b * 8))


def _jax_synth(fam, desc, dc, qm):
    sid, n_pad, bh, bw, cov, special = desc
    famj = {k: jnp.asarray(v) for k, v in fam.items()}
    return TF._synth_family(jnp.asarray(dc), famj, sid, n_pad, bh, bw, cov,
                            special, jnp.asarray(qm))


def _port_synth(fams_desc, dc, qm, ys_b, xs_b):
    planes = torch.zeros((3, ys_b * 8, xs_b * 8))
    for d, fam in fams_desc:
        SY.synth_family(planes, I.family_from_dict(fam, d, "cpu"),
                        torch.from_numpy(dc), qm)
    return planes.numpy()


def _qm(rng):
    return np.asarray([0.8 ** rng.integers(0, 3), 1.0,
                       0.8 ** rng.integers(0, 3)], np.float32)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("sid", range(21))
def test_synth_family_vs_jax(sid, dtype):
    rng = np.random.default_rng(1000 + sid)
    desc, fam, ys_b, xs_b = synthetic_family(sid, DTYPES[dtype], rng)
    dc = rng.uniform(-0.05, 0.7, (3, ys_b, xs_b)).astype(np.float32)
    qm = _qm(rng)
    ref = _jax_frame([_jax_synth(fam, desc, dc, qm)], [(desc, fam)],
                     ys_b, xs_b)
    got = _port_synth([(desc, fam)], dc, qm, ys_b, xs_b)
    assert np.abs(got - ref).max() <= TOL_F32


@pytest.mark.parametrize("sid", [0, 1, 4, 6, 12, 14, 18])
def test_synth_family_int8_exceptions_vs_jax(sid):
    rng = np.random.default_rng(2000 + sid)
    desc, fam, ys_b, xs_b = synthetic_family(sid, np.int8, rng,
                                               fixes=True)
    dc = rng.uniform(-0.05, 0.7, (3, ys_b, xs_b)).astype(np.float32)
    qm = _qm(rng)
    ref = _jax_frame([_jax_synth(fam, desc, dc, qm)], [(desc, fam)],
                     ys_b, xs_b)
    got = _port_synth([(desc, fam)], dc, qm, ys_b, xs_b)
    assert np.abs(got - ref).max() <= TOL_F32


# the TPU kernel's own domain: T >= 2, K <= 512, no exception list.
# Its inverse transform is a 3-pass bf16 split (~2^-17 relative per
# term), so the coefficients stay at real-stream magnitudes (|q| <= 20)
# for the 1e-5 bound to measure the port and not the split.
@pytest.mark.parametrize("sid", [4, 6, 7, 8, 9, 10, 11])
def test_synth_family_vs_pallas_kernel(sid):
    from jxl_coder_tpu.vardct.synth_pallas import synth_family_pallas
    rng = np.random.default_rng(3000 + sid)
    desc, fam, ys_b, xs_b = synthetic_family(sid, np.int8, rng, vmax=20)
    dc = rng.uniform(-0.05, 0.7, (3, ys_b, xs_b)).astype(np.float32)
    qm = _qm(rng)
    _, n_pad, bh, bw, _, _ = desc
    famj = {k: jnp.asarray(v) for k, v in fam.items()}
    with pltpu.force_tpu_interpret_mode():
        tiles = synth_family_pallas(jnp.asarray(dc), famj, n_pad, bh, bw,
                                    jnp.asarray(qm))
    ref = _jax_frame([tiles], [(desc, fam)], ys_b, xs_b)
    got = _port_synth([(desc, fam)], dc, qm, ys_b, xs_b)
    assert np.abs(got - ref).max() <= TOL_F32


@pytest.mark.parametrize("fault", ["none", "bys_int64", "rows", "coef_K",
                                   "planes_f64", "dc_f64"])
def test_kernel_wrapper_checks_what_the_kernel_reads(fault):
    """The CUDA wrapper's checks on the raw-pointer arguments (run here on
    CPU tensors: they compare devices, dtypes and shapes only)."""
    rng = np.random.default_rng(5)
    desc, fam, ys_b, xs_b = synthetic_family(6, np.int16, rng)
    f = I.family_from_dict(fam, desc, "cpu")
    planes = torch.zeros((3, ys_b * 8, xs_b * 8))
    dc = torch.zeros((3, ys_b, xs_b))
    if fault == "bys_int64":
        f.bys = f.bys.long()
    elif fault == "rows":
        f.xf = f.xf[:-1]
    elif fault == "coef_K":
        f.coef = f.coef[:, :, :-1].contiguous()
    elif fault == "planes_f64":
        planes = planes.double()
    elif fault == "dc_f64":
        dc = dc.double()
    if fault == "none":
        SY._check_cuda_args(planes, f, dc)
    else:
        with pytest.raises(ValueError):
            SY._check_cuda_args(planes, f, dc)


def _stream_state(img, distance, effort):
    from jxl_coder_tpu.vardct.enc_real import encode_vardct_real
    from jxl_coder_tpu_torch.api import _read_frame
    from jxl_coder_tpu_torch.vardct.parse import parse_frame
    data = encode_vardct_real(img, distance=distance, effort=effort)
    return I.pack(parse_frame(*_read_frame(data)))


def _contrast_image():
    # coefficients reach the hundreds at d0.1: the int8 exception path
    # (test_tpu_full.test_device_int8_exception_path)
    yy, xx = np.mgrid[0:64, 0:128]
    img = np.clip(128 + 127 * np.sin(yy / 3.2) * np.sin(xx / 3.5),
                  0, 255).astype(np.uint8)
    return np.stack([img, img, img], -1)


def _stream(stream):
    if stream == "d1.0_e7":
        return _stream_state(smooth_frame(192, 256), 1.0, 7)
    if stream == "d0.1_e3_exceptions":
        static, args = _stream_state(_contrast_image(), 0.1, 3)
        assert any("fix_idx" in f for f in args[0])
        return static, args
    # sharp strokes at d0.1: the DCT8 family itself is int8 with exceptions
    static, args = _stream_state(sharp_frame(96, 128), 0.1, 7)
    assert any(d[0] == 0 and "fix_idx" in f
               for d, f in zip(static["desc"], args[0]))
    return static, args


@pytest.mark.parametrize("stream", ["d1.0_e7", "d0.1_e3_exceptions",
                                    "sharp_d0.1_e7_dct8_exceptions"])
def test_synth_stream_families_vs_jax(stream):
    static, args = _stream(stream)
    fams, dc, _qf, _sharp, _igs, qm, _perm = args
    ys_b, xs_b = static["H8"] // 8, static["W8"] // 8
    fd = list(zip(static["desc"], fams))
    tiles = [_jax_synth(f, d, dc, qm) for d, f in fd]
    ref = _jax_frame(tiles, fd, ys_b, xs_b)
    got = _port_synth(fd, dc, qm, ys_b, xs_b)
    assert np.abs(got - ref).max() <= TOL_F32
    # every family the TPU kernel takes matches it too
    from jxl_coder_tpu.vardct.synth_pallas import synth_family_pallas
    for d, f in fd:
        sid, n_pad, bh, bw, _cov, special = d
        if special or "fix_idx" in f or bh * bw // 64 < 2 or bh * bw > 512:
            continue
        famj = {k: jnp.asarray(v) for k, v in f.items()}
        with pltpu.force_tpu_interpret_mode():
            t = synth_family_pallas(jnp.asarray(dc), famj, n_pad, bh, bw,
                                    jnp.asarray(qm))
        one = _jax_frame([t], [(d, f)], ys_b, xs_b)
        mine = _port_synth([(d, f)], dc, qm, ys_b, xs_b)
        n = int(np.sum(f["bys"] != TF._PAD_SENTINEL))
        for by, bx in zip(f["bys"][:n], f["bxs"][:n]):
            win = np.s_[:, by * 8:by * 8 + bh, bx * 8:bx * 8 + bw]
            assert np.abs(mine[win] - one[win]).max() <= TOL_F32


@pytest.mark.parametrize("stream", ["d0.1_e3_exceptions",
                                    "sharp_d0.1_e7_dct8_exceptions"])
def test_exception_list_as_the_dct8_kernel_reads_it(stream):
    """family_from_dict keeps the packed list's real entries sorted by
    flat index, and the DCT8 kernel's lookup (a binary search for a run's
    first row, then a walk row by row) applied to them gives the
    coefficients the packed list gives through index_add_."""
    static, args = _stream(stream)
    seen = 0
    for d, fam in zip(static["desc"], args[0]):
        if "fix_idx" not in fam:
            continue
        key = "vals" if d[5] else "cmat"
        ref = fam[key].astype(np.int64).reshape(-1)
        np.add.at(ref, fam["fix_idx"].astype(np.int64), fam["fix_val"])
        f = I.family_from_dict(fam, d, "cpu")
        idx, val = f.fix_idx.numpy(), f.fix_val.numpy()
        assert SY.n_fixes(f) == len(idx) == np.count_nonzero(fam["fix_val"])
        assert np.all(np.diff(idx) > 0)
        assert np.array_equal(SY.coefficients(f).reshape(-1).numpy(), ref)
        n, K = fam[key].shape[0], 3 * fam[key].shape[2]
        got = fam[key].astype(np.int64).reshape(-1)
        for b0 in range(0, n, 4):                # the kernel's runs of 4 rows
            j = int(np.searchsorted(idx, b0 * K))
            for b in range(b0, min(b0 + 4, n)):
                while j < len(idx) and idx[j] < (b + 1) * K:
                    got[idx[j]] += val[j]
                    j += 1
        assert np.array_equal(got, ref)
        seen += 1
    assert seen


@pytest.mark.parametrize("sid", range(21, 27))
def test_synth_large_transforms_vs_host_float64(sid):
    """DCT128/256: the JAX path would build a 1-16 GiB Kronecker matrix;
    the separable twin is checked against dec_real.reconstruct_group."""
    from jxl_coder_tpu.vardct.dec_real import (BlockArrays, VarBlock,
                                               reconstruct_group)
    st = STRATEGIES[sid]
    rng = np.random.default_rng(4000 + sid)
    ys_b, xs_b = st.cy, st.cx
    lf = SimpleNamespace(inv_global_scale=8.0, cfl_color_factor=84,
                         cfl_base_x=0.0, cfl_base_b=1.0,
                         quant_encodings=None)
    fh = SimpleNamespace(do_ycbcr=False, x_qm_scale=3, b_qm_scale=2)
    qf = np.full((ys_b, xs_b), 40, np.int64)
    ytox = rng.integers(-20, 20, (-(-ys_b // 8), -(-xs_b // 8)))
    ytob = rng.integers(-20, 20, ytox.shape)
    lg = SimpleNamespace(qf_map=qf, ytox=ytox, ytob=ytob)
    nc = st.num_coeffs
    vals = {}
    for c in range(3):
        v = rng.integers(-6, 7, nc)
        v[rng.random(nc) < 0.9] = 0
        v[:st.covered] = 0
        vals[c] = v.astype(np.int32)
    vb = VarBlock(bx=0, by=0, strategy=sid, values=vals)
    dc = {c: rng.uniform(-0.05, 0.7, (ys_b, xs_b)) for c in range(3)}
    ref = np.stack(reconstruct_group(lf, lg, [vb], fh, dc))
    desc, fams, qm, _ = TF.prepare_families(
        lf, fh, BlockArrays.from_varblocks([vb]), qf, ytox, ytob)
    dc32 = np.stack([dc[c] for c in range(3)]).astype(np.float32)
    got = _port_synth(list(zip(desc, fams)), dc32, qm, ys_b, xs_b)
    assert np.abs(got - ref).max() <= TOL_F64
