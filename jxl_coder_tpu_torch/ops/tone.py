"""HDR / wide-gamut to SDR sRGB, on the device (``jxl_coder_tpu/ops/
color.py:243-341``: ``encoding_trc_to_linear``, ``transfer_tone_rec2408``
and ``hdr_to_sdr``).

``hdr_to_sdr(pixels, ce, intensity_target)`` takes (H, W, C) uint8 /
uint16 codes in the stream's colour encoding and returns SDR sRGB codes
of the same type; channels past the third (alpha) pass through.  Per
pixel: codes / maxv, the stream's transfer function to linear (PQ scaled
by 10000 / 203, HLG by intensity_target / 203, a signalled gamma by its
inverse), for PQ and HLG the BT.2408 rational luminance scale with the
stream's own luma row (``gamut_rgb_to_xyz(prim, wp)[1]``), the 3x3 from
the stream's primaries to sRGB's, clip to [0, 1], sRGB's transfer
function, round half to even to codes.  It is a mode of kernel S4
(``csrc/pixel_ops.cu`` ``reformat_kernel``, through ``pack.convert``;
``decode_sampled`` runs it fused with the packing).  ``params`` lays
the stream's constants out for the kernel, each the float32 the
reference's ``jnp`` arithmetic uses; ``sdr_codes_plain`` is the twin's
arithmetic, its pow glibc's powf as XLA's CPU backend rounds it
(``ops/fp.py``) and its 3-term dot products summed as XLA sums them.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..host.ops import color as HC
from . import fp

_F = np.float32
# the kernel's layout (csrc/pixel_ops.cu T_*)
T_TRC, T_GAMMA, T_SCALE, T_WA, T_WB, T_LUMA, T_M, T_PQ, T_HLG, T_E = (
    0, 1, 2, 3, 4, 5, 8, 17, 22, 25)
N_T = 29
# transfer_tone_rec2408's display and white brightness (nits)
DISPLAY, WHITE = 250.0, 203.0


class ToneParams(NamedTuple):
    """A stream's tone-map constants (``params``): the transfer function
    (-1 for a signalled gamma) and the kernel's N_T floats."""
    trc: int
    p: np.ndarray


def params(ce, intensity_target: float) -> ToneParams:
    """hdr_to_sdr's constants for colour encoding ce."""
    p = np.zeros(N_T, np.float32)
    trc = -1 if ce.have_gamma else int(ce.transfer_function)
    p[T_TRC] = trc
    if ce.have_gamma:
        p[T_GAMMA] = 1.0 / (ce.gamma / 1e7)
    p[T_SCALE] = {16: 10000.0 / 203.0,
                  18: intensity_target / 203.0}.get(trc, 1.0)
    ld = intensity_target / WHITE
    p[T_WA] = (DISPLAY / WHITE) / (ld * ld)
    p[T_WB] = 1.0 / (DISPLAY / WHITE)
    p[T_LUMA:T_LUMA + 3] = HC.gamut_rgb_to_xyz(
        HC.primaries_xy(ce), HC.white_xy(ce))[1].astype(np.float32)
    p[T_M:T_M + 9] = HC.to_srgb_matrix(ce).reshape(-1)
    p[T_PQ:T_PQ + 5] = (1.0 / HC._PQ_M2, HC._PQ_C1, HC._PQ_C2, HC._PQ_C3,
                        1.0 / HC._PQ_M1)
    p[T_HLG:T_HLG + 3] = (HC._HLG_A, HC._HLG_B, HC._HLG_C)
    p[T_E:T_E + 4] = (1 / 0.45, 2.4, 2.6, 1 / 2.4)
    return ToneParams(trc, p)


def _pow(x: torch.Tensor, e: float) -> torch.Tensor:
    """max(x, 0) ** e for e > 0, as glibc's powf rounds it."""
    return torch.where(x > 0, fp.powf(torch.clamp_min(x, 1e-30), e),
                       torch.zeros_like(x))


def to_linear_plain(v: torch.Tensor, tp: ToneParams) -> torch.Tensor:
    """encoding_trc_to_linear (or gamma_to_linear) of [0, 1] values."""
    p = [float(x) for x in tp.p]
    if tp.trc == -1:
        return _pow(v, p[T_GAMMA])
    if tp.trc == 8:
        return v
    if tp.trc == 1:
        return torch.where(v < _F(0.081), fp.div(v, 4.5),
                           _pow(fp.div(v + 0.099, 1.099), p[T_E]))
    if tp.trc == 16:
        q = _pow(v, p[T_PQ])
        num = torch.clamp_min(q - p[T_PQ + 1], 0.0)
        den = p[T_PQ + 2] - p[T_PQ + 3] * q
        return _pow(num / den, p[T_PQ + 4]) * p[T_SCALE]
    if tp.trc == 17:
        return _pow(v, p[T_E + 2])
    if tp.trc == 18:
        x = torch.clamp_min(v, 0.0)
        hi = fp.div(torch.exp(fp.div(x - p[T_HLG + 2], p[T_HLG]))
                    + p[T_HLG + 1], 12.0)
        return torch.where(x <= 0.5, fp.div(x * x, 3.0), hi) * p[T_SCALE]
    return torch.where(v <= _F(0.04045), fp.div(v, 12.92),
                       _pow(fp.div(v + 0.055, 1.055), p[T_E + 1]))


def _dot3(w, v) -> torch.Tensor:
    """w[0] v[0] + w[1] v[1] + w[2] v[2], summed as XLA's CPU dot sums a
    3-term contraction (the kernel's fmaf chain)."""
    acc = float(w[0]) * v[0]
    for j in (1, 2):
        acc = fp.fma(torch.full_like(v[j], float(w[j])), v[j], acc)
    return acc


def sdr_codes_plain(f: torch.Tensor, maxv: float,
                    tp: ToneParams) -> torch.Tensor:
    """(..., 3) [0, 1] values in the stream's encoding -> (..., 3) SDR sRGB
    codes as float32 (the kernel's arithmetic, op by op)."""
    p = tp.p
    lin = to_linear_plain(f, tp).movedim(-1, 0)
    if tp.trc in (16, 18):
        light = _dot3(p[T_LUMA:T_LUMA + 3], lin)
        scale = torch.where(light == 0.0, torch.ones_like(light),
                            (1.0 + float(p[T_WA]) * light)
                            / (1.0 + float(p[T_WB]) * light))
        lin = torch.clamp_max(lin * scale, 1.0)
    m = p[T_M:T_M + 9].reshape(3, 3)
    x = torch.clamp(torch.stack([_dot3(m[c], lin) for c in range(3)]),
                    0.0, 1.0)
    e = torch.where(x <= _F(0.0031308), x * 12.92,
                    1.055 * _pow(x, float(p[T_E + 3])) - 0.055)
    return torch.clamp(torch.round(e * maxv), 0.0, maxv).movedim(0, -1)


def hdr_to_sdr(pixels: torch.Tensor, ce,
               intensity_target: float) -> torch.Tensor:
    """(H, W, C >= 3) uint8 / uint16 codes in colour encoding ce -> SDR
    sRGB codes of the same type, alpha untouched: one launch of S4
    (``pack.convert``) on a CUDA tensor, its twin on a CPU one."""
    from . import pack
    if pixels.dim() != 3 or pixels.shape[-1] < 3:
        raise ValueError(f"pixels: expected (H, W, C >= 3), got "
                         f"{tuple(pixels.shape)}")
    return pack.convert(pixels, pack.CODES, params(ce, intensity_target))
