"""XYB -> linear sRGB -> sRGB8/16 output, the last stage of kernel 2.

``xyb_to_srgb_plain`` turns (3, H, W) XYB planes (a cropped view is
fine) into interleaved (H, W, 3) uint8 or uint16: the twin of
``tpu_real.xyb_to_srgb8_device`` / ``tpu_full._xyb_to_srgb16_device``
with the exact FastLinearToSRGB exponent trick, and the plain version
of the output stage of ``csrc/filters.cu``'s tile pass
(``filters.restore_and_output``), which takes its constants from here.
Writing HWC directly removes the ``moveaxis`` of ``tpu_full.py:790-791``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..host.vardct.dec_real import (_BIAS, _CBRT_BIAS, _OPSIN_INV,
                                    _POW17TO10, _POW25TO18)

_M = np.asarray(_OPSIN_INV, np.float32)
_CB = np.float32(_CBRT_BIAS)
_BIAS32 = np.float32(_BIAS)
# FastLinearToSRGB multipliers per 4-bit exponent class (all < 2^31,
# so they fit the int32 view the twin uses)
_MUL = np.asarray([(int(_POW25TO18[k]) << 18) | (int(_POW17TO10[k]) << 10)
                   | 0x40000000 for k in range(16)], np.uint32)
_CONSTS = np.concatenate([_M.reshape(9), [_CB, _BIAS32]]).astype(np.float32)


def _f(v) -> float:
    return float(np.float32(v))


def fast_linear_to_srgb(v: torch.Tensor) -> torch.Tensor:
    """tpu_real.fast_linear_to_srgb_device on an int32 view; the
    arithmetic shift keeps the low 4 bits of (vb >> 23) - 118 that the
    lookup needs."""
    vb = v.view(torch.int32)
    v025 = ((vb | 0x3e800000) & 0x3effffff).view(torch.float32)
    d1 = v025 * _f(0.059914046) + _f(-0.108894556)
    d2 = d1 * v025 + _f(0.107963754)
    pw = d2 * v025 + _f(0.018092343)
    e = ((vb >> 23) - 118) & 0xf
    mul = torch.from_numpy(_MUL.view(np.int32)).to(v.device)[e.long()]
    return torch.where(v < _f(0.0031308), v * _f(12.92),
                       pw * mul.view(torch.float32) + _f(-0.055))


def xyb_to_linear_plain(xyb: torch.Tensor):
    """tpu_full._xyb_to_linear_device: (3, H, W) XYB -> the three linear
    sRGB planes, unclamped."""
    X, Y, B = xyb[0], xyb[1], xyb[2]
    cb, bias = float(_CB), float(_BIAS32)
    g_r = Y + X + cb
    g_g = Y - X + cb
    g_b = B + cb
    ml = g_r * g_r * g_r - bias
    mm = g_g * g_g * g_g - bias
    ms = g_b * g_b * g_b - bias
    return [float(_M[c, 0]) * ml + float(_M[c, 1]) * mm
            + float(_M[c, 2]) * ms for c in range(3)]


def xyb_to_srgb_plain(xyb: torch.Tensor, bits16: bool) -> torch.Tensor:
    scale = 65535.0 if bits16 else 255.0
    out = []
    for lin in xyb_to_linear_plain(xyb):
        q = torch.floor(fast_linear_to_srgb(lin) * scale + 0.5)
        out.append(q.clamp(0.0, scale))
    return torch.stack(out, -1).to(torch.uint16 if bits16 else torch.uint8)
