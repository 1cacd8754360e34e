"""The DCT8-only frame path on a torch device (``jxl_coder_tpu/vardct/
tpu_real.py``).

An all-DCT8 frame arrives as dense arrays: basis-indexed coefficients
``(3, ys, xs, 64)`` with AdjustQuantBias already applied by the caller
(the DC slot is ignored), raw integer DC ``(3, ys, xs)`` in (Y, X, B)
order, the quant field, EPF sharpness and per-block CfL factors.
``reconstruct_dct8_frame`` turns them into ``(8*ys, 8*xs, 3)`` sRGB8:
DC planes and adaptive DC smoothing (plain torch), dequant and CfL, the
8x8 IDCT as one fp32 product with the Kronecker basis ``A (x) A``, the DC
added in pixel space, kernel 7 (``detile``) to raster, then the filter
chain and the sRGB output as kernel 2's tile pass
(``filters.restore_and_output``) on the whole block grid, as
``tpu_real`` filters it.  On CPU tensors the kernels' plain versions
run; on CUDA tensors every kernel of the path launches.  ``DCT8Frame``
wraps it as an ``nn.Module`` over the tensors of ``to_device``;
``arguments`` reads the arrays from an all-DCT8 stream.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch import nn

from ..host.bitstream.reader import BitReader
from ..host.vardct import synthesis as S
from ..host.vardct.dec_real import (DC_SMOOTH_W1, DC_SMOOTH_W2,
                                    read_lf_global, read_lf_group)
from .detile import detile
from .filters import restore_and_output, sigma_map
from .parse import parse_frame

# tpu_real.apply_filters_device: default gaborish weights; EPF pass 0
# (epf_iters 3) with the diamond at slope 0.9, pass 2 at scale 6.5
_GABW = (0.115169525, 0.061248592) * 3
_PASS0_SCALE = 0.9
_PASS2_SCALE = 6.5
_F32 = np.float32


@functools.lru_cache(maxsize=None)
def _kron_basis(device: torch.device) -> torch.Tensor:
    """kron(A, A) (64, 64) f32: [k*8 + l, m*8 + n] = A[k, m] * A[l, n],
    the einsum "yxkl,km,ln->yxmn" as one product (tpu_real._idct8_basis:
    A[k, x] = a(k) cos(pi (2x+1) k / 16) in f32)."""
    k = np.arange(8)[:, None]
    x = np.arange(8)[None, :]
    a = np.where(k == 0, 1.0, np.sqrt(2.0))
    A = (a * np.cos(np.pi * (2 * x + 1) * k / 16)).astype(np.float32)
    kron = np.kron(A.astype(np.float64), A.astype(np.float64))
    return torch.from_numpy(kron.astype(np.float32)).to(device)


def dc_steps(igs, quant_dc, dcq) -> np.ndarray:
    """(3,) f32 DC quant steps dcq[c] * igs / quant_dc, rounded in f32
    op by op as the numpy f32 scalars of tpu_real.synth_dct8_planes."""
    igs, qdc = _F32(igs), _F32(quant_dc)
    return np.asarray([_F32(dcq[c]) * igs / qdc for c in range(3)],
                      np.float32)


def dc_xyb_planes(dc: torch.Tensor, steps) -> torch.Tensor:
    """Raw int DC (3, ys, xs), channel order (y, x, b) -> (3, ys, xs) f32
    XYB DC planes with the default DC CfL (tpu_real.dc_xyb_planes)."""
    s = [float(v) for v in steps]
    dcY = dc[0].to(torch.float32) * s[1]
    dcX = dc[1].to(torch.float32) * s[0] + 0.0 * dcY
    dcB = dc[2].to(torch.float32) * s[2] + 1.0 * dcY
    return torch.stack([dcX, dcY, dcB])


def dc_smoothing(dc: torch.Tensor, steps) -> torch.Tensor:
    """Adaptive DC smoothing of (3, ys, xs) f32 planes with per-channel
    steps (tpu_real.dc_smoothing_device); border samples are kept."""
    ys, xs = dc.shape[1:]
    iy = torch.arange(-1, ys + 1, device=dc.device).clamp(0, ys - 1)
    ix = torch.arange(-1, xs + 1, device=dc.device).clamp(0, xs - 1)
    return smooth_dc_rows(dc, dc[:, iy][:, :, ix], steps, 0, ys)


def smooth_dc_rows(dc: torch.Tensor, p: torch.Tensor, steps, row0: int,
                   ys: int) -> torch.Tensor:
    """dc_smoothing of (3, n, xs) planes holding the rows row0 .. row0 +
    n - 1 of a DC image ys rows tall; p: dc with the row above and the
    row below it (edge copies at the image's border) and one column edge-
    padded on each side.  The image's border rows and columns are kept."""
    w1, w2 = DC_SMOOTH_W1, DC_SMOOTH_W2
    w0 = 1.0 - 4.0 * (w1 + w2)
    n, xs = dc.shape[1:]
    sm = (w0 * dc
          + w1 * (p[:, :-2, 1:-1] + p[:, 2:, 1:-1]
                  + p[:, 1:-1, :-2] + p[:, 1:-1, 2:])
          + w2 * (p[:, :-2, :-2] + p[:, :-2, 2:]
                  + p[:, 2:, :-2] + p[:, 2:, 2:]))
    st = torch.as_tensor(np.asarray(steps, np.float32), device=dc.device)
    gap = ((sm - dc).abs() / st[:, None, None]).amax(0)
    gap = torch.clamp_min(gap, 0.5)
    mix = torch.clamp(3.0 - 4.0 * gap, 0.0, 1.0)
    out = dc + (sm - dc) * mix[None]
    # tpu_real keeps rows and columns with i % (n - 1) == 0, i.e. the
    # first and the last; jnp's x % 0 is 0, so a frame one block tall or
    # wide keeps everything, as this mask does
    ry = torch.arange(row0, row0 + n, device=dc.device)
    rx = torch.arange(xs, device=dc.device)
    keep = (((ry == 0) | (ry == ys - 1))[:, None]
            | ((rx == 0) | (rx == xs - 1))[None, :])
    return torch.where(keep[None], dc, out)


def _fp32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in full fp32.  The package turns TF32 off when it is
    imported (``_device``); a caller who turns it back on gets an error
    here, not a product that breaks the 1-code contract."""
    if a.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("the DCT8 IDCT product needs full fp32 but "
                           "torch.backends.cuda.matmul.allow_tf32 is on")
    return a @ b


def synth_tiles(coeffs, dcp, qf, xf, bf, table, igs, qm_x, qm_b
                ) -> torch.Tensor:
    """Dequant + CfL + IDCT + DC -> (ys*xs, 192) f32 tiles, row
    by*xs + bx holding channel c's 8x8 pixels at c*64 + 8*m + n."""
    _, ys, xs, _ = coeffs.shape
    dev = coeffs.device
    inv_qac = (float(_F32(igs)) / qf.to(torch.float32))[None, :, :, None]
    qm = torch.tensor([float(_F32(qm_x)), 1.0, float(_F32(qm_b))],
                      dtype=torch.float32, device=dev)[:, None, None, None]
    # the DC slot is zeroed through the table
    tab0 = table.to(torch.float32).clone()
    tab0[:, 0] = 0.0
    deq = coeffs * tab0[:, None, None, :] * inv_qac * qm
    deqY = deq[1]
    deqX = deq[0] + xf[:, :, None] * deqY
    deqB = deq[2] + bf[:, :, None] * deqY
    stacked = torch.stack([deqX, deqY, deqB], 2).reshape(ys * xs, 3, 64)
    pix = _fp32_matmul(stacked, _kron_basis(dev))
    pix = pix + dcp.permute(1, 2, 0).reshape(ys * xs, 3, 1)
    return pix.reshape(ys * xs, 192)


def synth_from_dcp(coeffs, dcp, qf, xf, bf, table, igs, qm_x, qm_b
                   ) -> torch.Tensor:
    """tpu_real.synth_from_dcp -> (3, 8*ys, 8*xs) f32 XYB planes."""
    _, ys, xs, _ = coeffs.shape
    tiles = synth_tiles(coeffs, dcp, qf, xf, bf, table, igs, qm_x, qm_b)
    return detile(tiles, ys, xs)


def synth_dct8_planes(coeffs, dc, qf, xf, bf, table, igs, quant_dc, dcq,
                      qm_x, qm_b, skip_dc_smooth) -> torch.Tensor:
    """Dequant + CfL + IDCT only -> (3, 8*ys, 8*xs) planes."""
    steps = dc_steps(igs, quant_dc, dcq)
    dcp = dc_xyb_planes(dc, steps)
    if not skip_dc_smooth:
        dcp = dc_smoothing(dcp, steps)
    return synth_from_dcp(coeffs, dcp, qf, xf, bf, table, igs, qm_x, qm_b)


def filter_and_output(planes: torch.Tensor, qf, sharp, igs, gab,
                      epf_iters) -> torch.Tensor:
    """Gaborish, then EPF passes 0-2 by epf_iters (0-3, True means 1),
    on the whole (3, 8*ys, 8*xs) block grid (tpu_real's jnp chain; the
    EPF inverse-sigma map, tpu_real._epf_inv_map, is the kernel's
    per-block slope of the sigma map), then sRGB8 -> (8*ys, 8*xs, 3)."""
    epf_iters = int(epf_iters)
    sigma = sigma_map(sharp, qf, float(_F32(igs))) if epf_iters else None
    return restore_and_output(planes, sigma, bool(gab), epf_iters, _GABW,
                              _PASS0_SCALE, _PASS2_SCALE, "u8")


def reconstruct_dct8_frame(coeffs, dc, qf, sharp, xf, bf, table,
                           igs, quant_dc, dcq, qm_x, qm_b,
                           gab, epf_iters, skip_dc_smooth) -> torch.Tensor:
    """All-DCT8 frame reconstruction -> (8*ys, 8*xs, 3) uint8 sRGB, on
    the device the tensors live on (tpu_real.reconstruct_dct8_frame,
    same arguments)."""
    planes = synth_dct8_planes(coeffs, dc, qf, xf, bf, table, igs,
                               quant_dc, dcq, qm_x, qm_b, skip_dc_smooth)
    return filter_and_output(planes, qf, sharp, igs, gab, epf_iters)


# ---- the frame's arrays from a stream ----

def _raw_dc(cs: bytes, hdr, fh, toc, xs_b: int, ys_b: int) -> np.ndarray:
    """The quantised DC ints (3, ys_b, xs_b), channel order (y, x, b),
    read again from the LF groups (parse_frame keeps only the dequantised
    planes); also checks that no LF group uses extra precision, which
    tpu_real's DC planes leave out."""
    def section(i):
        s = toc.section(0 if len(toc.entries) == 1 else i)
        return BitReader(cs[s.offset:s.offset + s.size])
    single = len(toc.entries) == 1
    br0 = section(0)
    lf = read_lf_global(br0, fh, hdr, xs_b * 8, ys_b * 8)
    _ng, ndc = fh.counts(hdr)
    gx = -(-xs_b // 256)
    dc = np.zeros((3, ys_b, xs_b), np.int32)
    for gi in range(ndc):
        lx, ly = (gi % gx) * 256, (gi // gx) * 256
        gw, gh = min(256, xs_b - lx), min(256, ys_b - ly)
        lg = read_lf_group(br0 if single else section(1 + gi), lf, gw, gh,
                           gi, ndc)
        if lg.extra_precision:
            raise ValueError("DC extra precision: not a tpu_real frame")
        for c in range(3):
            dc[c, ly:ly + gh, lx:lx + gw] = lg.dc.channels[c].data
    return dc


def arguments(data: bytes):
    """reconstruct_dct8_frame's numpy arguments (coeffs, dc, qf, sharp,
    xf, bf, table, igs, quant_dc, dcq, qm_x, qm_b) and (gab, epf_iters,
    skip_dc_smooth) from the port's parse of an all-DCT8 stream (the
    host encoder at effort <= 2 writes only DCT8; at distance < 1.5 it
    sets no DC extra precision).  AdjustQuantBias is applied here, as the
    DCT8 path expects of its caller.  Both this path and the JAX
    package's tpu_real.reconstruct_dct8_frame take these arrays."""
    from ..api import _read_frame      # api imports the device modules
    cs, hdr, fh, toc = _read_frame(data)
    state = parse_frame(cs, hdr, fh, toc)
    lf, ba = state["lf"], state["blocks_glob"]
    if (ba.ids != 0).any():
        raise ValueError("not an all-DCT8 frame")
    if (lf.cfl_base_x, lf.cfl_base_b, lf.cfl_ytox_dc, lf.cfl_ytob_dc) != \
            (0.0, 1.0, 0, 0) or getattr(lf, "quant_encodings", None):
        raise ValueError("non-default DC CfL or dequant tables")
    qf, sharp = state["qf_map"], state["sharp_map"]
    ys, xs = qf.shape
    order = S.scan_to_basis(0)
    vals = ba.coeffs[ba.offs[:-1, None] + np.arange(192)].reshape(-1, 3, 64)
    coeffs = np.zeros((3, ys, xs, 64), np.float32)
    for c in range(3):
        basis = np.zeros((len(ba.ids), 64))
        basis[:, order] = S.adjust_quant_bias(vals[:, c], c)
        coeffs[c, ba.bys, ba.bxs] = basis
    cf = 1.0 / lf.cfl_color_factor
    tiles = np.ones((8, 8))
    xf = lf.cfl_base_x + np.kron(state["ytox_glob"], tiles)[:ys, :xs] * cf
    bf = lf.cfl_base_b + np.kron(state["ytob_glob"], tiles)[:ys, :xs] * cf
    table = np.stack([S.dequant_table(0, c) for c in range(3)])
    rf = fh.restoration_filter
    args = (coeffs, _raw_dc(cs, hdr, fh, toc, xs, ys), qf.astype(np.int32),
            sharp.astype(np.int32), xf.astype(np.float32),
            bf.astype(np.float32), table.astype(np.float32),
            np.float32(lf.inv_global_scale), np.float32(lf.quant_dc),
            np.asarray(lf.dcq, np.float32),
            np.float32(0.8 ** (fh.x_qm_scale - 2)),
            np.float32(0.8 ** (fh.b_qm_scale - 2)))
    return args, (bool(rf.gab), int(rf.epf_iters), bool(fh.flags & 0x80))


_TENSORS = {"coeffs": np.float32, "dc": np.int32, "qf": np.int32,
            "sharp": np.int32, "xf": np.float32, "bf": np.float32,
            "table": np.float32}
_SCALARS = ("igs", "quant_dc", "dcq", "qm_x", "qm_b")


def to_device(coeffs, dc, qf, sharp, xf, bf, table, igs, quant_dc, dcq,
              qm_x, qm_b, device) -> dict:
    """reconstruct_dct8_frame's numpy arguments -> the frame state on
    `device`: contiguous tensors and f32 host scalars."""
    arrays = dict(coeffs=coeffs, dc=dc, qf=qf, sharp=sharp, xf=xf, bf=bf,
                  table=table)
    state = {k: torch.from_numpy(np.ascontiguousarray(a, _TENSORS[k])
                                 ).to(device) for k, a in arrays.items()}
    state.update(igs=_F32(igs), quant_dc=_F32(quant_dc),
                 dcq=np.asarray(dcq, np.float32), qm_x=_F32(qm_x),
                 qm_b=_F32(qm_b))
    return state


class DCT8Frame(nn.Module):
    """The DCT8-only frame path for one filter setting; forward(state)
    -> (8*ys, 8*xs, 3) uint8 on the device the state lives on."""

    def __init__(self, gab: bool, epf_iters: int, skip_dc_smooth: bool):
        super().__init__()
        self.gab = bool(gab)
        self.epf_iters = int(epf_iters)
        self.skip_dc_smooth = bool(skip_dc_smooth)

    def forward(self, state: dict) -> torch.Tensor:
        return reconstruct_dct8_frame(
            *(state[k] for k in _TENSORS), *(state[k] for k in _SCALARS),
            self.gab, self.epf_iters, self.skip_dc_smooth)
