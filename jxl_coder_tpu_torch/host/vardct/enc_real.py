"""Real-format VarDCT still encoder (wire-compatible with libjxl).

RD varblock selection over DCT8..DCT32X32 (vectorized per candidate
shape), content-adaptive global quant scale with a contrast-masking
field, per-tile chroma-from-luma, gaborish-sharpened input with the
full decode-side restoration chain signalled (gaborish + EPF +
adaptive DC smoothing), extra_precision DC in the mid-distance band,
AC deadzone, learned MA trees for the DC/meta streams, clustered rANS
histograms (native C++ stream writer).  Multi-group images produce
the full section layout: LfGlobal | LfGroup* | HfGlobal | PassGroup*.
Effort (1-10) controls the candidate breadth (_EFFORT_CANDS).

The port's copy of the host branch of ``jxl_coder_tpu/vardct/enc_real.py``:
8- and 16-bit and float input, a signalled colour encoding (``colour``,
``intensity_target``), a lossless alpha plane, the noise lut, and a
caller's frame and image headers (``fh``, ``hdr``: an upsampled frame is
coded at its reduced size; ``into_bw``: one frame into a caller's
stream), a patch dictionary (``patch_dict_bw``), and the effort-7 patch
path (``enc_patches.detect``, then ``_encode_with_patches``: a Modular
reference-only atlas frame and the main frame).  The native host codec is
required (no pure-Python fallback).  Without ``front`` its bytes equal the
JAX package's host encoder's.

The device front end comes in by injection (``front``: an object with the
six calls of ``vardct/enc_device.Front``, which the host layer does not
import): XYB, sharpening, DCT analysis, masking, CfL and the RD
quantise / cost grids run on its device in float32, the host keeps the
greedy decision, the DC and metadata tree learning, the tokens and the
bitstream.  As in the reference, only a frame without a signalled colour
encoding (``colour is None``) takes the front; a failure there raises
(the reference re-encodes on the host instead, fault R19 of ROADMAP.md).
"""

from __future__ import annotations

import os

import numpy as np

from ..bitstream.writer import BitWriter
from ..bitstream.headers import ImageHeader, ImageMetadata, SizeHeader
from ..bitstream.frame_header import (FrameHeader, Encoding,
                                      write_frame_header, write_toc)
from ..codec import write_image_header
from ..entropy.coder import TokenStream
from ..modular.image import Channel, ModularImage
from ..modular.stream import GroupHeader, encode_modular_stream
from ..modular.tree import Tree
from .strategies import STRATEGIES
from .dec_real import (DEFAULT_CTX_MAP, NONZERO_BUCKETS,
                       ZERO_DENSITY_CTX_COUNT)
from .selected import cost_meta, gather_plan, selected_from_rows
from . import synthesis as S

_BIAS = 0.0037930732552754493
_CBRT_BIAS = float(np.cbrt(_BIAS))
_OPSIN = np.array([[0.30, 0.622, 0.078],
                   [0.23, 0.692, 0.078],
                   [0.24342268924547819, 0.20476744424496821,
                    0.5518098665095536]])

NUM_CTXS = 15
LAMBDA_MULT = 1.5
# Decode-side restoration defaults matching libjxl e7 at d1.0: EPF one
# iteration with uniform sharpness 4 and adaptive DC smoothing ON
# (flags=0) — the smoothing recovers ~2.4dB in the low band on smooth
# gradients for free.
EPF_ITERS = 1
EPF_SHARPNESS = 4
DC_STEPS = (0.000244140625, 0.001953125, 0.00390625)  # x, y, b


def srgb8_to_xyb(pix: np.ndarray):
    f = pix.astype(np.float64) / 255.0
    lin = np.where(f <= 0.04045, f / 12.92,
                   ((f + 0.055) / 1.055) ** 2.4)
    mixed = lin @ _OPSIN.T
    g = np.cbrt(mixed + _BIAS) - _CBRT_BIAS
    return ((g[..., 0] - g[..., 1]) / 2,
            (g[..., 0] + g[..., 1]) / 2,
            g[..., 2])


def encoded_to_xyb(f: np.ndarray, ce=None, intensity_target=255.0):
    """(H, W, 3) float in [0, 1] in the signalled colour encoding ->
    XYB planes (linear 1.0 == SDR white == 255 nits, the convention the
    decoder's xyb_planes_to_encoding inverts)."""
    from ..ops import color as C
    f = f.astype(np.float64)
    if ce is None:
        trc = 13       # sRGB
        prim = wp = None
    else:
        trc = ce.transfer_function
        prim, wp = C.primaries_xy(ce), C.white_xy(ce)
    if trc == 16:      # PQ: absolute nits over 255-nit SDR white
        lin = np.asarray(C.pq_to_linear(f)) * (10000.0 / 255.0)
    elif trc == 18:    # HLG: display-relative + BT.2100 OOTF
        it = float(intensity_target or 1000.0)
        scene = np.asarray(C.hlg_to_linear(f))
        gam = 1.2 * 1.111 ** np.log2(it / 1000.0)
        luma = C.gamut_rgb_to_xyz(prim, wp)[1]
        ys = np.einsum("...c,c->...", scene, luma)
        disp = scene * np.where(ys > 1e-9, ys ** (gam - 1.0),
                                0.0)[..., None]
        lin = disp * (it / 255.0)
    elif ce is not None and ce.have_gamma:
        lin = f ** (1e7 / ce.gamma)
    else:
        if trc in C.TRC_TO_LINEAR:
            lin = np.asarray(C.TRC_TO_LINEAR[trc](f))
        else:
            lin = np.where(f <= 0.04045, f / 12.92,
                           ((f + 0.055) / 1.055) ** 2.4)
    if prim is not None and (prim != C.PRIMARIES["srgb"]
                             or wp != C.ILLUMINANT_D65):
        m = (C.gamut_xyz_to_rgb(C.PRIMARIES["srgb"], C.ILLUMINANT_D65)
             @ C.gamut_rgb_to_xyz(prim, wp))
        lin = lin @ m.T
    mixed = lin @ _OPSIN.T
    g = np.cbrt(np.maximum(mixed + _BIAS, 0.0)) - _CBRT_BIAS
    return ((g[..., 0] - g[..., 1]) / 2,
            (g[..., 0] + g[..., 1]) / 2,
            g[..., 2])


def _modular_substream(channels, predictor: int = 5,
                       learn: bool = False,
                       max_leaves: int = 16) -> BitWriter:
    channels = list(channels)
    if learn:
        from ..modular.learn import learn_tree
        # WP costs a sequential Python pass at learn AND encode time:
        # enable it only when the stream is small (DC images)
        use_wp = max((c.width * c.height for c in channels
                      if c.width and c.height), default=0) <= (1 << 14)
        # exclude property 1 (stream id): decoders compute their own
        # stream numbering, so splitting on it is not portable
        tree = learn_tree(channels, max_leaves=max_leaves,
                          props_allowed=[0] + list(range(2, 15)),
                          use_wp=use_wp)
    else:
        tree = Tree.single_leaf(predictor=predictor)
    bw = BitWriter()
    encode_modular_stream(bw, ModularImage(channels), GroupHeader(), tree)
    return bw


def _gaborish_sharpen(plane: np.ndarray, w1: float = 0.115169525,
                      w2: float = 0.061248592,
                      iters: int = 4) -> np.ndarray:
    """Approximate inverse of the decoder's 3x3 gaborish smoothing via a
    Neumann series: x ~= sum (I-K)^k y.  K is near identity so four
    terms leave a residual far below a quant step."""
    from .dec_real import gaborish
    out = plane.copy()
    err = plane
    for _ in range(iters):
        err = err - gaborish(err, w1, w2)
        out = out + err
    return out


# Nominal luma step multiplier (igs/qf) at distance 1.0.  libjxl e7
# measures 1.488 on low-activity content (qf 6 at global scale 7340);
# we run slightly finer (1.42) to spend the rate saved by the deadzone
# on PSNR — photo crops land at 0.91-0.96x cjxl bytes.  The
# contrast-masking curve is fitted to libjxl's content-adaptive global
# scale (igs x1.27 on sparse detail, x1.6 on dense noise).
BASE_STEP_MULT = 1.42
AC_DEADZONE = 0.58
MASK_COEF = 4.3
MASK_EXP = 0.68
# steep high-activity term: dense noise must coarsen much further than
# the photo-texture curve (round-3 fit: dense-noise rate 1.57x -> 1.06x
# cjxl e7 bytes at +0.4dB, corpus photo crops unchanged)
MASK_COEF2 = 52.0
MASK_EXP2 = 1.6
MASK_MAX = 4.0


def _masking_field(Y: np.ndarray, ys_b: int, xs_b: int) -> np.ndarray:
    """Per-block contrast-masking multiplier from local activity of the
    (sharpened) luma plane: noisy/busy blocks tolerate proportionally
    coarser quantization (libjxl raises its global quant scale the same
    way — measured igs 8.9 -> 14.3 on noise at fixed qf)."""
    gy, gx = np.gradient(Y)
    act = np.sqrt(gy * gy + gx * gx)
    act_b = act.reshape(ys_b, 8, xs_b, 8)
    mean_b = np.maximum(act_b.mean(axis=(1, 3)), 0.0)
    # screen-content guard: a sparse edge on a flat block (glyph
    # stroke) has median activity ~0 while the mean is high — masking
    # there coarsens exactly the pixels the eye locks onto.  Gate the
    # masking activity by the geometric mean with the MEDIAN, which
    # leaves dense texture/noise (median ~ mean) untouched
    med_b = np.median(act_b, axis=(1, 3))
    blk = np.sqrt(mean_b * np.minimum(mean_b, 4.0 * med_b))
    return np.clip(1.0 + MASK_COEF * np.power(blk, MASK_EXP)
                   + MASK_COEF2 * np.power(blk, MASK_EXP2),
                   1.0, MASK_MAX)


def _estimate_cfl(coY, coX, coB, ys_b: int, xs_b: int):
    """Per-64x64-tile chroma-from-luma factors on AC coefficients:
    minimize |X - tx*Y| and |(B-Y) - tb_delta*Y|.  Stored as the
    decoder's signed tags (factor = tag / 84)."""
    ty, tx_ = -(-ys_b // 8), -(-xs_b // 8)
    ytox = np.zeros((ty, tx_), np.int32)
    ytob = np.zeros((ty, tx_), np.int32)
    for t_y in range(ty):
        for t_x in range(tx_):
            ys = slice(t_y * 8, min((t_y + 1) * 8, ys_b))
            xs = slice(t_x * 8, min((t_x + 1) * 8, xs_b))
            y_ac = coY[ys, xs].reshape(-1, 64)[:, 1:].ravel()
            den = float(y_ac @ y_ac)
            if den < 1e-9:
                continue
            x_ac = coX[ys, xs].reshape(-1, 64)[:, 1:].ravel()
            b_ac = coB[ys, xs].reshape(-1, 64)[:, 1:].ravel()
            fx = float(x_ac @ y_ac) / den
            fb = float(b_ac @ y_ac) / den
            ytox[t_y, t_x] = int(np.clip(round(fx * 84.0), -128, 127))
            ytob[t_y, t_x] = int(np.clip(round(fb * 84.0), -128, 127))
    return ytox, ytob


def _token_cost_vec(vals: np.ndarray, cov: int) -> np.ndarray:
    """The token-cost rate of vals (..., size) -> rate (...)."""
    seg = vals[..., cov:]
    nz = seg != 0
    any_nz = nz.any(-1)
    last = np.where(any_nz,
                    nz.shape[-1] - np.argmax(nz[..., ::-1], axis=-1), 0)
    mag = np.abs(seg).astype(np.float64)
    bits = np.where(nz, np.log2(1.0 + mag), 0.0).sum(-1)
    cnt = nz.sum(-1)
    return np.where(any_nz, 2.0 + 1.1 * last + bits + cnt, 2.0)


# effort tiers (JxlEffort.kt 1-10) -> RD candidate breadth
_EFFORT_CANDS = {
    # sid, cy, cx — largest first
    'full': [(5, 4, 4), (10, 4, 2), (11, 2, 4), (4, 2, 2), (6, 2, 1),
             (7, 1, 2)],
    'mid': [(4, 2, 2), (6, 2, 1), (7, 1, 2)],
    'fast': [],
}

# same-size (1x1 block) alternative transforms for sharp/screen
# content: IDENTITY, DCT2X2, DCT4X4, DCT4X8, DCT8X4.  An 8x8 DCT rings
# on glyph edges; libjxl's encoder picks these at e7+ (the 4.5x rate /
# +16 dB gap on the text-on-flat probe, round-5).  Restricted to
# distance < 2 where x_qm_scale == 2 (qm == 1), matching the encoder's
# header; evaluated per 8x8 block against DCT8 in the same greedy.
_SPECIAL_CANDS = (1, 2, 3, 12, 13)


_D_WEIGHTS = (8.0, 1.0, 0.35)   # X, Y, B distortion weights (XYB space)


def _quantize_biased(ratio: np.ndarray, c: int) -> np.ndarray:
    """Quantize coefficient/step ratios accounting for the decoder's
    AdjustQuantBias shrinkage: pick the integer whose *reconstruction*
    adjust(q)*step lands closest to the target."""
    from . import synthesis as S
    q0 = np.round(ratio)
    best_q = q0.astype(np.int64)
    best_e = np.abs(S.adjust_quant_bias(best_q, c) - ratio)
    for dq in (-1, 1):
        q = q0.astype(np.int64) + dq
        e = np.abs(S.adjust_quant_bias(q, c) - ratio)
        take = e < best_e
        best_q = np.where(take, q, best_q)
        best_e = np.where(take, e, best_e)
    # deadzone: rate of a lone +-1 exceeds its distortion value below
    # ~0.58 steps (measured RD-positive on photo/noise/smooth probes)
    best_q = np.where(np.abs(ratio) < AC_DEADZONE, 0, best_q)
    return best_q


import functools as _functools


@_functools.lru_cache(maxsize=None)
def _special_mats(sid: int):
    """(r0 (3, 64), R1 (3, 63, 64), A (3, 64, 63)) for a cov==1 special
    transform: synthesis pixel rows (scan order, dequant folded in at
    inv_qac=1/qm=1) and the least-squares analysis pinv."""
    from . import synthesis as S
    R = np.stack([S.response_matrix(sid, c) for c in range(3)])
    Rf = R.reshape(3, 64, 64).astype(np.float64)
    r0 = Rf[:, 0]
    R1 = Rf[:, 1:]
    A = np.stack([np.linalg.pinv(R1[c]) for c in range(3)])
    return r0, R1, A


def _special_quantize_batch(sid, blocks_pix, dcb, qfv, igs, fxv, fbv):
    """Quantize ALL 8x8 blocks with one special transform via its
    response matrices: blocks_pix (N, 3, 64) pixel rows, dcb (N, 3)
    per-block DC means.  Returns (vals (N, 3, 64) int64 scan order,
    dist (N,)) — distortion measured in PIXEL space (the responses are
    not orthonormal, so coefficient-domain error would misrank)."""
    from . import synthesis as S
    r0, R1, A = _special_mats(sid)
    n = blocks_pix.shape[0]
    inv_qac = (igs / qfv.astype(np.float64))[:, None]
    vals = np.zeros((n, 3, 64), np.int64)
    t1 = blocks_pix[:, 1] - dcb[:, 1, None] * r0[1][None]
    gY = t1 @ A[1]
    qy = _quantize_biased(gY / inv_qac, 1)
    vals[:, 1, 1:] = qy
    dqY = S.adjust_quant_bias(qy, 1) * inv_qac
    recY = dqY @ R1[1]
    # pixel-domain error is directly comparable to the DCT8 dist
    # (ana_basis rows have norm^2 1/64, area 64 cancels it)
    dist = _D_WEIGHTS[1] * np.sum((recY - t1) ** 2, axis=-1)
    for c, f in ((0, fxv), (2, fbv)):
        tc = blocks_pix[:, c] - dcb[:, c, None] * r0[c][None]
        sub = tc - f[:, None] * recY
        g = sub @ A[c]
        q = _quantize_biased(g / inv_qac, c)
        vals[:, c, 1:] = q
        rec = (S.adjust_quant_bias(q, c) * inv_qac) @ R1[c] \
            + f[:, None] * recY
        dist += _D_WEIGHTS[c] * np.sum((rec - tc) ** 2, axis=-1)
    return vals, dist


def _quantize_batch(coeff, strategy, qfv, igs, fxv, fbv, tabs_cache,
                    dq_dc_blk):
    """Quantise N blocks of one strategy: coeff (N, 3, bh, bw), qfv/fxv/fbv (N,),
    dq_dc_blk (N, 3, cy, cx) -> (vals (N, 3, size) int64, dist (N,))."""
    from . import synthesis as S
    key = strategy
    if key not in tabs_cache:
        tabs_cache[key] = (S.scan_to_basis(strategy),
                           [S.dequant_table(strategy, c).astype(np.float64)
                            for c in range(3)])
    order, tabs = tabs_cache[key]
    st = STRATEGIES[strategy]
    cov = st.covered
    size = st.num_coeffs
    n = coeff.shape[0]
    inv_qac = igs / qfv.astype(np.float64)            # (N,)
    idx = order[cov:]
    area = float(cov * 64)
    flat = coeff.reshape(n, 3, size)
    vals = np.zeros((n, 3, size), np.int64)
    stepY = tabs[1][idx][None, :] * inv_qac[:, None]
    fY = flat[:, 1][:, idx]
    qy = _quantize_biased(fY / stepY, 1)
    vals[:, 1, cov:] = qy
    dqY = S.adjust_quant_bias(qy, 1) * stepY
    dist = area * _D_WEIGHTS[1] * np.sum((dqY - fY) ** 2, axis=-1)
    for c, f in ((0, fxv), (2, fbv)):
        tgt = flat[:, c][:, idx]
        sub = tgt - f[:, None] * dqY
        step = tabs[c][idx][None, :] * inv_qac[:, None]
        q = _quantize_biased(sub / step, c)
        vals[:, c, cov:] = q
        rec = S.adjust_quant_bias(q, c) * step + f[:, None] * dqY
        dist += area * _D_WEIGHTS[c] * np.sum((rec - tgt) ** 2, axis=-1)
    if dq_dc_blk is not None:
        # LLF reconstruction error (decoder rebuilds it from DC means)
        cy, cx = st.cy, st.cx
        anY, anX = S.ana_basis(cy), S.ana_basis(cx)
        rs = np.outer(S.resample_vec(cy), S.resample_vec(cx))
        bw_ = st.cx * 8
        pos = [(j // st.cx) * bw_ + (j % st.cx) for j in range(cov)]
        llf = np.einsum("ky,ncyx,lx->nckl", anY, dq_dc_blk, anX) \
            * rs[None, None]
        llf = llf.reshape(n, 3, cov)
        tl = coeff.reshape(n, 3, size)[:, :, pos]
        d2 = np.sum((llf - tl) ** 2, axis=-1)
        for c in range(3):
            dist += area * _D_WEIGHTS[c] * d2[:, c]
    return vals, dist


def _special_eligibility(pad_u8_or_f: np.ndarray, ys_b: int,
                         xs_b: int) -> np.ndarray:
    """Screen-content gate for the special 1x1 transforms: blocks whose
    luma activity is a SPARSE edge on a flat base (median |grad| <<
    mean).  On dense noise the token-cost proxy badly underestimates
    the real cost of 60+ dense IDENTITY tokens (and they dilute the
    shared AC histograms): unrestricted, specials doubled the
    noisy-photo rate at LOWER psnr (round-5 probe)."""
    p = pad_u8_or_f
    if p.dtype == np.uint8:
        luma = p.mean(axis=-1).astype(np.float32) / 255.0
    elif p.dtype == np.uint16:
        luma = p.mean(axis=-1).astype(np.float32) / 65535.0
    else:
        luma = p.mean(axis=-1).astype(np.float32)
    gy, gx = np.gradient(luma)
    act = np.sqrt(gy * gy + gx * gx)
    ab = act.reshape(ys_b, 8, xs_b, 8)
    mean_b = ab.mean(axis=(1, 3))
    med_b = np.median(ab, axis=(1, 3))
    return (mean_b > 0.008) & (med_b * 6.0 < mean_b)


def _select_strategies(co8, X, Y, B, qf_map, igs, fx_blk, fb_blk,
                       ys_b, xs_b, dq_dc, lam,
                       cands=_EFFORT_CANDS['full'], specials=(),
                       special_eligible=None):
    """Greedy varblock rate+distortion selection, vectorized: every
    candidate shape is quantized for ALL its aligned positions in one
    batch, then a greedy largest-first pass picks winners from the
    precomputed cost maps.  Returns (acs_map, the winners' values as a
    SelectedFlat, qf per anchor)."""
    from . import synthesis as S
    tabs_cache = {}

    # DCT8 baseline for every block
    coeff8 = np.stack([co8[c] for c in range(3)], axis=2).reshape(
        ys_b * xs_b, 3, 8, 8)
    dqdc8 = np.transpose(dq_dc, (1, 2, 0)).reshape(
        ys_b * xs_b, 3, 1, 1)
    vals8, dist8 = _quantize_batch(
        coeff8, 0, qf_map.ravel().astype(np.float64), igs,
        fx_blk.ravel(), fb_blk.ravel(), tabs_cache, dqdc8)
    rate8 = _token_cost_vec(vals8, 1).sum(-1)
    cost8 = (rate8 + lam * dist8).reshape(ys_b, xs_b)
    vals8 = vals8.reshape(ys_b, xs_b, 3, -1)

    cand_data = {}
    planes = np.stack([X, Y, B])
    for sid, cy, cx in cands:
        nyc, nxc = ys_b // cy, xs_b // cx
        if nyc == 0 or nxc == 0:
            continue
        h, w = cy * 8, cx * 8
        # all aligned regions: (3, nyc, h, nxc, w) -> (N, 3, h, w)
        reg = planes[:, :nyc * h, :nxc * w].reshape(
            3, nyc, h, nxc, w).transpose(1, 3, 0, 2, 4).reshape(
            nyc * nxc, 3, h, w)
        anaH = S.ana_basis(h)
        anaW = S.ana_basis(w)
        coeff = np.einsum("ky,ncyx,lx->nckl", anaH, reg, anaW,
                          optimize=True)
        qfm = qf_map[:nyc * cy, :nxc * cx].reshape(
            nyc, cy, nxc, cx).min(axis=(1, 3)).ravel().astype(np.float64)
        fxa = fx_blk[:nyc * cy:cy, :nxc * cx:cx].ravel()
        fba = fb_blk[:nyc * cy:cy, :nxc * cx:cx].ravel()
        dqb = dq_dc[:, :nyc * cy, :nxc * cx].reshape(
            3, nyc, cy, nxc, cx).transpose(1, 3, 0, 2, 4).reshape(
            nyc * nxc, 3, cy, cx)
        vals, dist = _quantize_batch(coeff, sid, qfm, igs, fxa, fba,
                                     tabs_cache, dqb)
        rate = _token_cost_vec(vals, cy * cx).sum(-1)
        cand_data[sid] = (vals.reshape(nyc, nxc, 3, -1),
                          (rate + lam * dist).reshape(nyc, nxc),
                          qfm.reshape(nyc, nxc).astype(np.int32))

    if specials:
        blocks_pix = planes.reshape(3, ys_b, 8, xs_b, 8).transpose(
            1, 3, 0, 2, 4).reshape(ys_b * xs_b, 3, 64)
        dcb = np.transpose(dq_dc, (1, 2, 0)).reshape(ys_b * xs_b, 3)
        qfr = qf_map.ravel().astype(np.float64)
        fxr = fx_blk.ravel()
        fbr = fb_blk.ravel()
        if special_eligible is None:
            special_eligible = np.ones((ys_b, xs_b), bool)
        eligible = special_eligible.ravel()
        for sid in specials:
            valsS, distS = _special_quantize_batch(
                sid, blocks_pix, dcb, qfr, igs, fxr, fbr)
            rateS = _token_cost_vec(valsS, 1).sum(-1)
            costS = np.where(eligible, rateS + lam * distS, 1e30)
            cand_data[sid] = (
                valsS.reshape(ys_b, xs_b, 3, -1),
                costS.reshape(ys_b, xs_b),
                qf_map.astype(np.int32))
    meta = cost_meta(ys_b, xs_b, cands, specials)
    cands = list(cands) + [(sid, 1, 1) for sid in specials]
    return _greedy_select(cands, cand_data, cost8, vals8, qf_map, meta)


def _greedy_decide(cands, cost_data, cost8, qf_map, ys_b, xs_b):
    """Greedy largest-first winner pass over precomputed cost grids;
    values are NOT touched — only cost/qf grids.  cost_data: {sid:
    (cgrid, qgrid)}.  Returns (acs_map, qf_sel).  Native C++ when
    in native C++ (hostcodec.cpp greedy_decide_native)."""
    from .. import native as native_mod
    lib = native_mod.get_lib()
    import ctypes
    kept = [(sid, cy, cx) for (sid, cy, cx) in cands
            if sid in cost_data]
    cdesc = np.empty((max(len(kept), 1), 5), np.int32)
    goffs = np.zeros(len(kept) + 1, np.int64)
    cgrids, qgrids = [], []
    for k, (sid, cy, cx) in enumerate(kept):
        cgrid, qgrid = cost_data[sid]
        nyc, nxc = cgrid.shape
        cdesc[k] = (sid, cy, cx, nyc, nxc)
        goffs[k + 1] = goffs[k] + nyc * nxc
        cgrids.append(np.ascontiguousarray(cgrid, np.float64)
                      .reshape(-1))
        qgrids.append(np.ascontiguousarray(qgrid, np.int32)
                      .reshape(-1))
    cgrid_all = (np.concatenate(cgrids) if cgrids
                 else np.zeros(1, np.float64))
    qgrid_all = (np.concatenate(qgrids) if qgrids
                 else np.zeros(1, np.int32))
    cost8_c = np.ascontiguousarray(cost8, np.float64)
    qf_c = np.ascontiguousarray(qf_map, np.int32)
    acs_map = np.empty((ys_b, xs_b), np.int32)
    qf_sel = np.empty((ys_b, xs_b), np.int32)
    dp = ctypes.POINTER(ctypes.c_double)
    ip = ctypes.POINTER(ctypes.c_int32)
    lib.greedy_decide_native(
        cost8_c.ctypes.data_as(dp), qf_c.ctypes.data_as(ip),
        ys_b, xs_b,
        np.ascontiguousarray(cdesc).ctypes.data_as(ip), len(kept),
        cgrid_all.ctypes.data_as(dp), qgrid_all.ctypes.data_as(ip),
        goffs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        acs_map.ctypes.data_as(ip), qf_sel.ctypes.data_as(ip))
    return acs_map, qf_sel


def _greedy_select(cands, cand_data, cost8, vals8, qf_map, meta):
    """Greedy winner pass, then the winners' values gathered as the
    device route's fetch gathers them (gather_plan, selected_from_rows)."""
    ys_b, xs_b = qf_map.shape
    cost_data = {sid: (c, q) for sid, (v, c, q) in cand_data.items()}
    acs_map, qf_sel = _greedy_decide(cands, cost_data, cost8, qf_map,
                                     ys_b, xs_b)
    plan, anchors = gather_plan(meta, acs_map)
    # each source's (rows, 3, num_coeffs) values and its covered prefix
    srcs = [(vals8, 1)] + [(cand_data[m[0]][0], m[5]) for m in meta]
    rows = []
    for k, ix in plan:
        v, cov = srcs[k]
        rows.append(v.reshape(-1, 3, v.shape[-1])[ix][:, :, cov:])
    flat = np.concatenate([r.reshape(-1) for r in rows])
    return (acs_map, selected_from_rows(flat, anchors,
                                        [r.shape[2] for r in rows]), qf_sel)


@_functools.lru_cache(maxsize=None)
def _strategy_luts():
    """Per-strategy-id attribute LUT arrays for the vectorized anchor
    build (covered, log2_covered, num_coeffs, cx, cy and the three
    per-channel block-context ids)."""
    ns = max(STRATEGIES) + 1
    luts = {k: np.zeros(ns, np.int32)
            for k in ("cov", "l2c", "nc", "cx", "cy", "ctx1", "ctx0",
                      "ctx2")}
    for sid, s in STRATEGIES.items():
        luts["cov"][sid] = s.covered
        luts["l2c"][sid] = s.log2_covered
        luts["nc"][sid] = s.num_coeffs
        luts["cx"][sid] = s.cx
        luts["cy"][sid] = s.cy
        luts["ctx1"][sid] = DEFAULT_CTX_MAP[1 * 13 + s.order_bucket]
        luts["ctx0"][sid] = DEFAULT_CTX_MAP[0 * 13 + s.order_bucket]
        luts["ctx2"][sid] = DEFAULT_CTX_MAP[2 * 13 + s.order_bucket]
    return luts


def _write_ac_tokens(ts, flat, xs_b, ys_b):
    """Mirror of read_pass_group's varblock walk: nonzero counts with
    spread prediction, zero-density contexts with covered/log2cov, in
    the native single-pass tokenizer, fed from a SelectedFlat: the
    anchors table is a vectorized LUT gather and the value buffer is
    used as-is."""
    import ctypes
    from .. import native as native_mod
    n = len(flat.bys)
    if n == 0:
        return
    luts = _strategy_luts()
    sids = flat.sids
    anchors = np.empty((n, 10), np.int32)
    anchors[:, 0] = flat.bxs
    anchors[:, 1] = flat.bys
    anchors[:, 2] = luts["cov"][sids]
    anchors[:, 3] = luts["l2c"][sids]
    anchors[:, 4] = luts["nc"][sids]
    anchors[:, 5] = luts["cx"][sids]
    anchors[:, 6] = luts["cy"][sids]
    anchors[:, 7] = luts["ctx1"][sids]
    anchors[:, 8] = luts["ctx0"][sids]
    anchors[:, 9] = luts["ctx2"][sids]
    anchors = np.ascontiguousarray(anchors)
    offs = np.ascontiguousarray(flat.offs, np.int64)
    vals_flat = np.ascontiguousarray(flat.vals, np.int32)
    cap = int(3 * n + offs[-1])
    out_ctx = np.empty(max(cap, 1), np.int32)
    out_val = np.empty(max(cap, 1), np.int32)
    i32p = ctypes.POINTER(ctypes.c_int32)
    m = native_mod.get_lib().encode_ac_tokens(
        anchors.ctypes.data_as(i32p), n,
        offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        vals_flat.ctypes.data_as(i32p), xs_b, ys_b, NUM_CTXS,
        out_ctx.ctypes.data_as(i32p), out_val.ctypes.data_as(i32p))
    ts.add_arrays(out_ctx[:m], out_val[:m])


def _dc_substreams(dc_int: np.ndarray, ys_b: int, xs_b: int) -> dict:
    """{LF group: its DC modular substream (learned tree)}, the groups
    on a thread pool (numpy + native work: the GIL is released)."""
    lf_b = 256
    gx_lf = -(-xs_b // lf_b)
    ngl = gx_lf * -(-ys_b // lf_b)

    def one(gi):
        lx = (gi % gx_lf) * lf_b
        ly = (gi // gx_lf) * lf_b
        gw = min(lf_b, xs_b - lx)
        gh = min(lf_b, ys_b - ly)
        return gi, _modular_substream([
            Channel(gw, gh, data=np.ascontiguousarray(
                dc_int[i, ly:ly + gh, lx:lx + gw], np.int32))
            for i in range(3)], learn=True, max_leaves=24)

    if ngl == 1:
        return dict([one(0)])
    import concurrent.futures as _fut
    with _fut.ThreadPoolExecutor(
            max_workers=min(ngl, os.cpu_count() or 2)) as ex:
        return dict(ex.map(one, range(ngl)))


def encode_vardct_real(pixels: np.ndarray, distance: float = 1.0,
                       decoding_speed: int = 0,
                       effort: int = 7, fh=None, hdr=None,
                       into_bw=None, alpha=None, colour=None,
                       bit_depth: int = None,
                       intensity_target: float = None,
                       patch_dict_bw=None,
                       try_patches: bool = True,
                       progressive: bool = False,
                       noise_lut=None, front=None) -> bytes:
    """(H, W, 3) colour -> real-format VarDCT codestream.

    pixels: uint8, uint16 or float [0, 1] in the colour encoding given
    by `colour` (None = sRGB); full input precision reaches the XYB
    front-end.  alpha: optional (H, W) int plane, encoded losslessly as
    an ALPHA extra channel.  noise_lut: 8 knots in [0, 1] (kNoise).
    fh / hdr: the frame and image headers to write (caller-owned fh
    fields such as the upsampling factor are kept, the encoder's own set
    here); `pixels` is then the coded frame, of the header's size
    divided by the upsampling.  With into_bw given too, ONE frame (header,
    TOC and sections) is written into that stream and b"" returned.
    patch_dict_bw: a serialized patch dictionary, written at the head of
    LfGlobal with flag kPatches.  At effort 7 and up, on 8-bit RGB at
    distance 0.5 and up, with no caller headers, alpha or colour
    encoding, the patch detector runs in a thread meanwhile; when it finds
    repeated glyphs the stream becomes two frames (_encode_with_patches).
    As in the original, that path drops a requested noise_lut (fault R5 of
    ROADMAP.md).
    front: the device front end (``vardct/enc_device.Front``), or None for
    the float64 host route.  Route rule: it runs only when ``colour`` is
    None (a signalled colour encoding converts on the host); the patch
    path's main frame takes it too."""
    if pixels.ndim != 3 or pixels.shape[2] != 3:
        raise ValueError("the host encoder takes (H, W, 3) pixels")
    H, W, _ = pixels.shape
    xs_b, ys_b = -(-W // 8), -(-H // 8)
    pw, ph = xs_b * 8, ys_b * 8
    if bit_depth is None:
        bit_depth = 16 if pixels.dtype == np.uint16 else 8

    pad = np.pad(pixels, ((0, ph - H), (0, pw - W), (0, 0)), mode="edge")
    # decoding-speed tiers drop decode-side filters (the reference's
    # JxlDecodingSpeed semantics); gaborish costs a 3x3 conv at decode
    use_gab = decoding_speed < 2

    # the device front end (XYB, sharpening, DCT analysis, masking, CfL,
    # then the RD quantise / cost grids) for frames without a signalled
    # colour encoding; dispatched first so that the patch detector below
    # overlaps its device work and d2h copy.  A failure raises.
    dev_pending = None
    if front is not None and colour is None:
        dev_pending = front.run_front_dispatch(pad,
                                               gab_iters=4 if use_gab else 0)

    # encoder-side patches (libjxl e7+ behaviour): repeated glyph
    # content moves to a hidden reference frame; the main frame codes the
    # rest and the dictionary adds the glyphs back.  The detector runs in
    # a worker thread (its numpy work releases the GIL) while the frame
    # below is encoded; on a hit that encode is discarded.
    _patch_box = None
    if (try_patches and fh is None and hdr is None and into_bw is None
            and alpha is None and colour is None and effort >= 7
            and distance >= 0.5 and pixels.dtype == np.uint8):
        from . import enc_patches as EPAT
        import threading as _threading
        _patch_box = {"plan": None}

        def _detect_bg():
            try:
                _patch_box["plan"] = EPAT.detect(pixels)
            except Exception:
                _patch_box["plan"] = None
        _pt = _threading.Thread(target=_detect_bg, daemon=True)
        _pt.start()
        _patch_box["thread"] = _pt

    if dev_pending is not None:
        planes_dev, co_dev, mask, ytox, ytob, co_dc = \
            front.run_front_fetch(dev_pending)
    else:
        if pad.dtype == np.uint8 and colour is None:
            X, Y, B = srgb8_to_xyb(pad)
        else:
            if pad.dtype == np.uint8:
                f = pad.astype(np.float64) / 255.0
            elif pad.dtype == np.uint16:
                f = pad.astype(np.float64) / 65535.0
            else:
                f = pad.astype(np.float64)
            X, Y, B = encoded_to_xyb(f, colour, intensity_target or 255.0)
        B = B - Y                 # CfL base factor 1.0
        if use_gab:
            X = _gaborish_sharpen(X)
            Y = _gaborish_sharpen(Y)
            B = _gaborish_sharpen(B)
        # content-adaptive global scale: per-block target step
        # s_b = BASE_STEP_MULT * distance * masking; the global scale
        # carries the masking median and the integer qf field the rest
        mask = _masking_field(Y, ys_b, xs_b)
    # scale the global quant scale with distance AND masking so the
    # integer qf field keeps its resolution around 6 (libjxl keeps
    # qf_med 5-6 at every distance; igs carries the rest)
    igs_target = 8.929 * distance * float(np.median(mask))
    gs = int(np.clip(round(65536.0 / igs_target), 257, 65535))
    igs = 65536.0 / gs
    s_field = BASE_STEP_MULT * distance * mask
    qf_map = np.clip(np.rint(igs / s_field), 1, 255).astype(np.int32)
    base_qf = int(np.clip(round(igs / (BASE_STEP_MULT * distance)),
                          1, 255))
    # DC step stays proportional to distance only (masking must not
    # coarsen DC: banding): quant_dc rises with the global scale
    qdc = int(np.clip(round(igs / (0.893 * distance)), 1, 1024))
    # extra_precision halves the DC step in the mid-distance band where
    # DC banding dominates (libjxl writes ep=1 for 2<=d<8)
    extra_precision = 1 if 1.5 <= distance < 6.0 else 0
    dc_steps = [d * igs / qdc / (1 << extra_precision)
                for d in DC_STEPS]

    if dev_pending is not None:
        # the DC terms came in the front's one flat fetch; the planes and
        # coefficients stay on the device for the cost stage
        dc_int = np.zeros((3, ys_b, xs_b), np.int64)
        dc_int[0] = np.round(co_dc[1] / dc_steps[1])
        dc_int[1] = np.round(co_dc[0] / dc_steps[0])
        dc_int[2] = np.round(co_dc[2] / dc_steps[2])
    else:
        ANA = S.ana_basis(8)

        # per-block coefficients (vectorised analysis)
        def block_coeffs(plane):
            b = plane.reshape(ys_b, 8, xs_b, 8).transpose(0, 2, 1, 3)
            return np.einsum("ky,YXyx,lx->YXkl", ANA, b, ANA)

        co = {0: block_coeffs(X), 1: block_coeffs(Y),
              2: block_coeffs(B)}
        dc_int = np.zeros((3, ys_b, xs_b), np.int64)
        dc_int[0] = np.round(co[1][:, :, 0, 0] / dc_steps[1])
        dc_int[1] = np.round(co[0][:, :, 0, 0] / dc_steps[0])
        dc_int[2] = np.round(co[2][:, :, 0, 0] / dc_steps[2])

        ytox, ytob = _estimate_cfl(co[1], co[0], co[2], ys_b, xs_b)
    fx_blk = np.repeat(np.repeat(ytox, 8, 0), 8, 1)[:ys_b, :xs_b] / 84.0
    fb_blk = np.repeat(np.repeat(ytob, 8, 0), 8, 1)[:ys_b, :xs_b] / 84.0
    # dequantized DC means per channel (X, Y, B) for LLF distortion
    dq_dc = np.stack([dc_int[1].astype(np.float64) * dc_steps[0],
                      dc_int[0].astype(np.float64) * dc_steps[1],
                      dc_int[2].astype(np.float64) * dc_steps[2]])
    # lambda: bits per unit squared XYB error, anchored to the actual
    # median luma quant step so rate and distortion are commensurate
    step_ref = (igs / max(base_qf, 1)) * float(
        np.median(S.dequant_table(0, 1)))
    lam = LAMBDA_MULT / (step_ref * step_ref)
    cands = _EFFORT_CANDS['full'] if effort >= 6 else (
        _EFFORT_CANDS['mid'] if effort >= 3 else _EFFORT_CANDS['fast'])
    specials = _SPECIAL_CANDS if (effort >= 7
                                  and distance < 2.0) else ()
    special_eligible = None
    if specials:
        special_eligible = _special_eligibility(pad, ys_b, xs_b)
        if not special_eligible.any():
            specials = ()
    if dev_pending is not None:
        pending = front.run_costs_dispatch(
            planes_dev, co_dev, qf_map, fx_blk, fb_blk, dq_dc, igs,
            lam, cands, AC_DEADZONE, specials=specials,
            special_eligible=special_eligible)
    # the DC modular substreams depend only on dc_int: learned here, while
    # the device (on its route) computes the cost grids
    dc_subs = _dc_substreams(dc_int, ys_b, xs_b)
    if dev_pending is not None:
        cost8, cost_data, vals_list, meta = front.run_costs_fetch(pending)
        full_cands = list(cands) + [(s, 1, 1) for s in specials]
        acs_map, qf_map = _greedy_decide(full_cands, cost_data, cost8,
                                         qf_map, ys_b, xs_b)
        # the winner gather runs asynchronously; the AC-metadata tree
        # learning below overlaps its device work and d2h copy
        _vals_box = {"pending": front.fetch_selected_dispatch(
            vals_list, meta, acs_map)}
    else:
        acs_map, selected, qf_map = _select_strategies(
            co, X, Y, B, qf_map, igs, fx_blk, fb_blk, ys_b, xs_b,
            dq_dc, lam, cands=cands, specials=specials,
            special_eligible=special_eligible)
        _vals_box = {"vals": selected}

    # ---- frame assembly
    if hdr is None:
        from ..bitstream.headers import (BitDepth, ExtraChannelInfo,
                                         ExtraChannelType)
        m = ImageMetadata()
        m.bit_depth = BitDepth(False, bit_depth, 0)
        if colour is not None:
            m.colour_encoding = colour
        if intensity_target:
            m.tone_mapping.intensity_target = float(intensity_target)
        if alpha is not None:
            ec = ExtraChannelInfo(type=ExtraChannelType.ALPHA)
            ec.bit_depth = BitDepth(False, bit_depth, 0)
            m.extra_channels = [ec]
        hdr = ImageHeader(size=SizeHeader(xsize=W, ysize=H), metadata=m)
    xqm = 3 if distance >= 2.0 else 2
    # progressive AC: two passes, coarse coefficients (>>1) then the
    # refinement — decoders can show pass 0 early (the decode side has
    # supported num_passes>1 since round 3)
    npasses = 2 if (progressive and alpha is None) else 1
    pflags = 0x2 if patch_dict_bw is not None else 0
    if noise_lut is not None:
        # kNoise: the decoder synthesizes film-grain style noise from
        # the 8-knot intensity lut; values quantize to 10-bit fixed point
        noise_lut = [min(1023, max(0, int(round(float(v) * 1024.0))))
                     for v in noise_lut]
        if len(noise_lut) != 8:
            raise ValueError("noise lut needs 8 knots")
        pflags |= 0x1
    if fh is None:
        fh = FrameHeader(encoding=Encoding.VARDCT, flags=pflags,
                         x_qm_scale=xqm, b_qm_scale=2)
    else:
        fh.encoding = Encoding.VARDCT
        fh.flags = pflags
        fh.x_qm_scale = xqm
        fh.b_qm_scale = 2
    if npasses == 2:
        fh.passes.num_passes = 2
        fh.passes.num_downsample = 0
        fh.passes.shift = [1]
    fh.restoration_filter.gab = use_gab
    # decoding-speed tiers progressively drop decode-side filters
    # (reference JxlDecodingSpeed semantics): ds>=1 drops EPF, ds>=2
    # also drops gaborish (via use_gab above)
    epf_it = EPF_ITERS if (use_gab and decoding_speed < 1) else 0
    if epf_it and distance >= 2.0:
        epf_it = 3
    fh.restoration_filter.epf_iters = epf_it

    if hdr.metadata.extra_channels:
        fh.ec_upsampling = [1] * len(hdr.metadata.extra_channels)
        from ..bitstream.frame_header import BlendingInfo
        fh.ec_blending_info = [BlendingInfo()
                               for _ in hdr.metadata.extra_channels]

    gd_b = 32                     # AC group: 32x32 blocks
    lf_b = 256                    # LF group: 256x256 blocks
    gx = -(-xs_b // gd_b)
    gy = -(-ys_b // gd_b)
    ng = gx * gy
    gx_lf = -(-xs_b // lf_b)
    gy_lf = -(-ys_b // lf_b)
    ndc = gx_lf * gy_lf
    group_dim = 256

    # alpha extra channel: lossless modular plane, split global /
    # per-group exactly as ModularFrameDecoder expects (frame.py:64-146)
    ec_global_in_stream = alpha is not None and W <= group_dim \
        and H <= group_dim

    def ec_global_bits():
        w_ = BitWriter()
        if alpha is None:
            return w_
        chan = Channel(W, H, data=np.ascontiguousarray(alpha, np.int32))
        rng_ = (0, 1) if ec_global_in_stream else (0, 0)
        encode_modular_stream(w_, ModularImage([chan]), GroupHeader(),
                              Tree.single_leaf(predictor=5), stream_id=0,
                              channel_range=rng_)
        return w_

    def ec_group_bits(gi):
        w_ = BitWriter()
        if alpha is None or ec_global_in_stream:
            return w_
        ax = (gi % gx) * group_dim
        ay = (gi // gx) * group_dim
        rw = min(group_dim, W - ax)
        rh = min(group_dim, H - ay)
        if rw <= 0 or rh <= 0:
            return w_
        sub = Channel(rw, rh, data=np.ascontiguousarray(
            alpha[ay:ay + rh, ax:ax + rw], np.int32))
        sid = 1 + 3 * ndc + 17 + gi
        encode_modular_stream(w_, ModularImage([sub], nb_meta_channels=0),
                              GroupHeader(), Tree.single_leaf(predictor=5),
                              stream_id=sid)
        return w_

    def lf_global_bits():
        w_ = BitWriter()
        if patch_dict_bw is not None:
            # patch dictionary precedes DcQuant when flags & kPatches
            # (read_lf_global ordering)
            w_.append_writer(patch_dict_bw)
        if noise_lut is not None:
            # NoiseParameters precede DcQuant (read_lf_global ordering:
            # patches -> splines -> noise -> dc_quant)
            for v_ in noise_lut:
                w_.u(v_, 10)
        w_.bool(True)
        w_.u32(gs, (11, 1), (11, 2049), (12, 4097), (16, 8193))
        w_.u32(qdc, 16, (5, 1), (8, 1), (16, 1))
        w_.bool(True)
        w_.bool(True)
        w_.bool(False)
        if alpha is not None:
            w_.append_writer(ec_global_bits())
        return w_

    def _meta_substream(gi):
        """AC-metadata modular substream of one LF group (ytox/ytob,
        blockinfo, sharpness)."""
        lx = (gi % gx_lf) * lf_b
        ly = (gi // gx_lf) * lf_b
        gw = min(lf_b, xs_b - lx)
        gh = min(lf_b, ys_b - ly)
        sub_acs = acs_map[ly:ly + gh, lx:lx + gw]
        sub_qf = qf_map[ly:ly + gh, lx:lx + gw]
        anchors = [(by, bx) for by in range(gh) for bx in range(gw)
                   if sub_acs[by, bx] >= 0]
        nb = len(anchors)
        blockinfo = np.zeros((2, nb), np.int32)
        blockinfo[0, :] = [int(sub_acs[a]) for a in anchors]
        blockinfo[1, :] = [int(sub_qf[a]) - 1 for a in anchors]
        cw, ch = -(-gw // 8), -(-gh // 8)
        tx0, ty0 = lx // 8, ly // 8
        sub = _modular_substream([
            Channel(cw, ch, hshift=3, vshift=3,
                    data=np.ascontiguousarray(
                        ytox[ty0:ty0 + ch, tx0:tx0 + cw], np.int32)),
            Channel(cw, ch, hshift=3, vshift=3,
                    data=np.ascontiguousarray(
                        ytob[ty0:ty0 + ch, tx0:tx0 + cw], np.int32)),
            Channel(nb, 2, data=blockinfo),
            Channel(gw, gh, data=np.full((gh, gw), EPF_SHARPNESS,
                                         np.int32))],
            learn=True, max_leaves=24)
        return nb, gw, gh, sub

    def lf_group_bits(gi):
        w_ = BitWriter()
        w_.u(extra_precision, 2)
        w_.append_writer(dc_subs[gi])
        nb, gw, gh, meta_sub = _meta_substream(gi)
        upper = gw * gh
        cb = (upper - 1).bit_length() if upper > 1 else 0
        w_.u(nb - 1, cb)
        w_.append_writer(meta_sub)
        return w_

    def hf_global_bits():
        w_ = BitWriter()
        w_.bool(True)
        if ng > 1:
            w_.u(0, (ng - 1).bit_length())  # num_histograms = 1
        w_.u32(0, 0x5F, 0x13, 0, (13, 0))
        return w_

    def _vals_maps():
        """The winners' values per pass: the first call blocks on the
        device gather (device route), so the assembly builds the DC and
        metadata substreams while it is in flight."""
        if "maps" in _vals_box:
            return _vals_box["maps"]
        vm = _vals_box.get("vals")
        if vm is None:
            vm = front.fetch_selected_fetch(_vals_box["pending"])
        if npasses == 1:
            maps = [vm]
        else:
            # split v = (v0 << 1) + v1 with v0 = round(v/2): pass 0 the
            # coarse field, pass 1 a {-1,0,1} refinement (the decoder
            # accumulates sum(v_p << shift_p))
            v0 = (vm.vals + 1) >> 1
            maps = [vm.transform(lambda v: v0),
                    vm.transform(lambda v: v - (v0 << 1))]
        _vals_box["maps"] = maps
        return maps

    # shared AC histograms must cover all groups: gather all tokens
    def group_tokens(gi, ts, p_):
        vmap = _vals_maps()[p_]
        ax = (gi % gx) * gd_b
        ay = (gi // gx) * gd_b
        gw = min(gd_b, xs_b - ax)
        gh = min(gd_b, ys_b - ay)
        sub_vals = (vmap if gw == xs_b and gh == ys_b
                    else vmap.window(ay, ax, gh, gw))
        _write_ac_tokens(ts, sub_vals, gw, gh)

    if ng == 1 and ndc == 1 and npasses == 1:
        lfgb = lf_group_bits(0)
        ts = TokenStream(NUM_CTXS * (NONZERO_BUCKETS
                                     + ZERO_DENSITY_CTX_COUNT), use_ans=True)
        group_tokens(0, ts, 0)
        tw = BitWriter()
        ts.write(tw)
        sec = lf_global_bits()
        sec.append_writer(lfgb)
        sec.append_writer(hf_global_bits())
        sec.append_writer(tw)
        sec.append_writer(ec_group_bits(0))
        sec.zero_pad_to_byte()
        payloads = [sec.to_bytes()]
    else:
        # per-group token streams share one histogram set: write
        # histograms in HfGlobal?  The AC code lives in HfGlobal and the
        # groups carry only the symbol bits; TokenStream couples both,
        # so emit a joint histogram over all groups' tokens, then write
        # each group with the shared code.
        nctx = NUM_CTXS * (NONZERO_BUCKETS + ZERO_DENSITY_CTX_COUNT)
        lf_payloads = []
        for gi in range(ndc):
            b = lf_group_bits(gi)
            b.zero_pad_to_byte()
            lf_payloads.append(b.to_bytes())
        hf = hf_global_bits()
        sections = []
        for p_ in range(npasses):
            all_ts = [TokenStream(nctx, use_ans=True)
                      for _ in range(ng)]
            for gi in range(ng):
                group_tokens(gi, all_ts[gi], p_)
            joint = TokenStream(nctx, use_ans=True)
            for t in all_ts:
                joint.extend_from(t)
            if p_ > 0:
                # per-pass HfGlobal tail: used_orders + this pass's code
                hf.u32(0, 0x5F, 0x13, 0, (13, 0))
            shared = joint.write_histograms(hf)
            for gi in range(ng):
                gw_ = BitWriter()
                all_ts[gi].write_symbols(gw_, shared)
                gw_.append_writer(ec_group_bits(gi))
                gw_.zero_pad_to_byte()
                sections.append(gw_.to_bytes())
        lfg = lf_global_bits()
        lfg.zero_pad_to_byte()
        payloads = [lfg.to_bytes()]
        payloads.extend(lf_payloads)
        hf.zero_pad_to_byte()
        payloads.append(hf.to_bytes())
        payloads.extend(sections)

    if into_bw is not None:
        write_frame_header(into_bw, fh, hdr)
        write_toc(into_bw, [len(p) for p in payloads])
        for p in payloads:
            into_bw.append_bits(p, len(p) * 8)
        return b""
    if _patch_box is not None:
        _patch_box["thread"].join()
        plan = _patch_box["plan"]
        if plan is not None:
            return _encode_with_patches(
                pixels, plan, distance=distance, effort=effort,
                decoding_speed=decoding_speed,
                intensity_target=intensity_target, front=front)
    bw = BitWriter()
    write_image_header(bw, hdr)
    write_frame_header(bw, fh, hdr)
    write_toc(bw, [len(p) for p in payloads])
    return bw.to_bytes() + b"".join(payloads)


def _encode_with_patches(pixels, plan, distance: float, effort: int,
                         decoding_speed: int = 0,
                         intensity_target: float = None,
                         front=None) -> bytes:
    """Two-frame stream: a hidden kReferenceOnly atlas frame carrying
    the distinct glyph patches (saved before the colour transform, so
    its XYB is what the dictionary adds), then the main frame with the
    glyphs' deltas taken out and flags kPatches + the dictionary at the
    head of LfGlobal."""
    from ..bitstream.headers import BitDepth
    from ..bitstream.frame_header import FrameType, RestorationFilter
    from ..codec import DEFAULT_DC_QUANT, encode_modular_frame
    from . import enc_patches as EPAT

    H, W, _ = pixels.shape
    m = ImageMetadata()
    m.bit_depth = BitDepth(False, 8, 0)
    if intensity_target:
        m.tone_mapping.intensity_target = float(intensity_target)
    hdr = ImageHeader(size=SizeHeader(xsize=W, ysize=H), metadata=m)

    bw = BitWriter()
    write_image_header(bw, hdr)

    ah, aw = plan.atlas.shape[1:]
    fh_ref = FrameHeader(frame_type=FrameType.REFERENCE_ONLY,
                         encoding=Encoding.MODULAR, is_last=False,
                         save_as_reference=1,
                         save_before_color_transform=True,
                         have_crop=True, frame_width=aw,
                         frame_height=ah,
                         # no decode-side filters on the atlas: they
                         # would smear the glyph deltas
                         restoration_filter=RestorationFilter(
                             gab=False, epf_iters=0))
    # the atlas rides a Modular lossy-XYB reference frame: quantized
    # (Y, X, B-Y) channels against the default DC dequant, holding XYB
    # deltas that the main frame's dictionary adds (BLEND_ADD)
    Xa, Ya, Ba = plan.atlas
    q0, q1, q2 = DEFAULT_DC_QUANT
    cy_p = np.rint(Ya / q1).astype(np.int32)
    cx_p = np.rint(Xa / q0).astype(np.int32)
    cb_p = (np.rint(Ba / q2) - cy_p).astype(np.int32)
    encode_modular_frame(bw, hdr, fh_ref, [cy_p, cx_p, cb_p],
                         use_ycocg=False)

    pd_bw = EPAT.serialize_dictionary(plan, num_extra=0)
    fh_main = FrameHeader(is_last=True)
    encode_vardct_real(plan.filled, distance=distance, effort=effort,
                       decoding_speed=decoding_speed, fh=fh_main,
                       hdr=hdr, into_bw=bw, patch_dict_bw=pd_bw,
                       try_patches=False, front=front)
    return bw.to_bytes()
