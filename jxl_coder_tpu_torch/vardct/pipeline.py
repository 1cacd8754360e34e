"""Round-1 VarDCT reconstruction and encoder front on a torch device
(``jxl_coder_tpu/vardct/pipeline.py``).

Decode: dequant -> chroma-from-luma -> DC merge -> 8x8 IDCT -> gaborish
-> EPF -> XYB -> sRGB8 (``reconstruct_srgb8``), sRGB16
(``reconstruct_u16``: the JAX package's ``xyb_to_u16`` of
``reconstruct_xyb``) or XYB planes (``reconstruct_xyb``).  On a CUDA
tensor the filter tail and the output run in one launch of the fused
kernel of ``fused_filters`` (TPU kernels 5 and 6) at any H x W, which
makes the EPF's inverse sigma from the per-block quant field itself; on
a CPU tensor they run its plain twin, which is ``apply_filters`` and
``xyb_to_srgb8`` / ``xyb_to_u16`` below, the jnp chain the TPU falls
back to.

Encode: ``forward_xyb`` and ``quantize_coeffs``, summed and rounded as
the JAX package does on the CPU (``ops.fp``), so the integers match.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..host.vardct.quant import LF_STEPS, default_dequant_matrix
from ..ops.color import linear_to_srgb, srgb_to_linear
from ..ops.fp import div
from .dct import blockify, dct2d, idct2d, unblockify
from .xyb import linear_rgb_to_xyb, xyb_to_linear_rgb

GABORISH_W1 = 0.115169525
GABORISH_W2 = 0.061248592


def gaborish_kernel() -> np.ndarray:
    k = np.array([[GABORISH_W2, GABORISH_W1, GABORISH_W2],
                  [GABORISH_W1, 1.0, GABORISH_W1],
                  [GABORISH_W2, GABORISH_W1, GABORISH_W2]], np.float32)
    return k / k.sum()


def _edge_pad(img: torch.Tensor, ry: int, rx: int) -> torch.Tensor:
    """Edge-replicate the last two axes by ry rows and rx columns."""
    h, w = img.shape[-2:]
    iy = torch.arange(-ry, h + ry, device=img.device).clamp(0, h - 1)
    ix = torch.arange(-rx, w + rx, device=img.device).clamp(0, w - 1)
    return img[..., iy, :][..., ix]


def apply_gaborish(img: torch.Tensor) -> torch.Tensor:
    """(3, H, W) depthwise 3x3 smoothing with edge-replicate padding."""
    k = gaborish_kernel()
    h, w = img.shape[1:]
    pad = _edge_pad(img, 1, 1)
    out = torch.zeros_like(img)
    for dy in range(3):
        for dx in range(3):
            out = out + float(k[dy, dx]) * pad[:, dy:dy + h, dx:dx + w]
    return out


# EPF channel scales (X, Y, B) — relative SAD weights per channel.
EPF_CHANNEL_SCALE = np.array([40.0, 5.0, 3.5], np.float32)
_EPF_TAPS_CROSS = ((0, -1), (-1, 0), (0, 0), (1, 0), (0, 1))


def apply_epf(img: torch.Tensor, inv_sigma: torch.Tensor,
              iters: int = 1) -> torch.Tensor:
    """Plus-shaped 5-tap EPF, weight max(0, 1 - sad * inv_sigma) with a
    pointwise 3-channel SAD; inv_sigma: (H, W) per pixel."""
    cs = [float(s) for s in EPF_CHANNEL_SCALE]
    for _ in range(max(0, iters)):
        h, w = img.shape[1:]
        pad = _edge_pad(img, 1, 1)
        num = torch.zeros_like(img)
        den = torch.zeros((h, w), dtype=img.dtype, device=img.device)
        for (dy, dx) in _EPF_TAPS_CROSS:
            shifted = pad[:, 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
            if dy == 0 and dx == 0:
                wgt = torch.ones_like(den)
            else:
                ad = (shifted - img).abs()
                sad = ad[0] * cs[0] + ad[1] * cs[1] + ad[2] * cs[2]
                wgt = torch.clamp_min(1.0 - sad * inv_sigma, 0.0)
            num = num + shifted * wgt[None]
            den = den + wgt
        img = num / den[None]
    return img


def expand_cfl(cfl_x: torch.Tensor, cfl_b: torch.Tensor, ny: int, nx: int):
    """Per-64x64-tile factors -> per-block (nY, nX) float factors."""
    ty = torch.arange(ny, device=cfl_x.device) // 8
    tx = torch.arange(nx, device=cfl_x.device) // 8
    fx = cfl_x[ty[:, None], tx[None, :]].float() / 64.0
    fb = cfl_b[ty[:, None], tx[None, :]].float() / 64.0
    return fx, fb


def _f32(v: float) -> float:
    return float(np.float32(v))


def _steps(qf: torch.Tensor, distance: float) -> torch.Tensor:
    dm = torch.from_numpy(default_dequant_matrix(8)).to(qf.device)
    return dm[:, None, None] * _f32(distance) * div(
        8.0, qf.float()[None, :, :, None, None])


def dequant_idct(ac_coeffs: torch.Tensor, dc: torch.Tensor, qf: torch.Tensor,
                 fx: torch.Tensor, fb: torch.Tensor,
                 distance: float) -> torch.Tensor:
    """dequant + CfL + DC merge + IDCT.  ac_coeffs: (3, nY, nX, 8, 8)
    integer; dc: (3, nY, nX); qf/fx/fb: (nY, nX).  -> (3, nY*8, nX*8)."""
    coeffs = ac_coeffs.float() * _steps(qf, distance)
    cfl = torch.stack([fx, torch.zeros_like(fx), fb])
    coeffs = coeffs + cfl[:, :, :, None, None] * coeffs[1][None]
    lf_steps = torch.from_numpy(LF_STEPS).to(dc.device) * _f32(distance)
    dc_vals = dc.float() * lf_steps[:, None, None]
    dc_vals = dc_vals + cfl * dc_vals[1][None]
    dc_mask = torch.zeros((8, 8), dtype=torch.float32, device=dc.device)
    dc_mask[0, 0] = 1.0
    coeffs = (coeffs * (1.0 - dc_mask)
              + (dc_vals * 8.0)[:, :, :, None, None] * dc_mask)
    return unblockify(idct2d(coeffs))


def inv_sigma_blocks(qf: torch.Tensor, distance: float) -> torch.Tensor:
    """Per-block EPF inverse sigma from the block quant field."""
    return div(qf.float(), _f32(distance) * 4.0)


def inv_sigma_map(qf: torch.Tensor, distance: float) -> torch.Tensor:
    """Per-pixel EPF inverse sigma from the block quant field."""
    inv = inv_sigma_blocks(qf, distance)
    return inv.repeat_interleave(8, 0).repeat_interleave(8, 1)


def filter_halo(epf_iters: int, gab: bool) -> int:
    """Vertical halo rows the filter chain consumes."""
    return (1 if gab else 0) + max(0, epf_iters)


def pad_rows(arr: torch.Tensor, halo: int) -> torch.Tensor:
    """Edge-replicate `halo` rows on top/bottom (axis -2)."""
    if halo == 0:
        return arr
    return _edge_pad(arr, halo, 0)


def apply_filters(img: torch.Tensor, inv_sigma_px: torch.Tensor,
                  epf_iters: int, gab: bool) -> torch.Tensor:
    """The filter chain on a slab padded by filter_halo() rows; the same
    rows are cropped from the output."""
    halo = filter_halo(epf_iters, gab)
    if halo == 0:
        return img
    if gab:
        img = apply_gaborish(img)
    if epf_iters > 0:
        img = apply_epf(img, inv_sigma_px, iters=epf_iters)
    return img[:, halo:-halo, :]


def _filters(img: torch.Tensor, qf: torch.Tensor, distance: float,
             epf_iters: int, gab: bool, out: str) -> torch.Tensor:
    """The filter tail and the output ("f32", "u8" or "u16") through
    fused_filters.legacy_filters: one launch at epf_iters <= 1; for
    epf_iters >= 2 apply_filters' construction (pad once by the halo,
    gaborish, then each EPF pass over the whole slab, crop), then the
    output."""
    from . import fused_filters as FF   # it imports this module
    if epf_iters <= 1:
        if not (gab or epf_iters) and out == "f32":
            return img
        return FF.legacy_filters(img, qf, distance, gab, epf_iters == 1, out)
    halo = filter_halo(epf_iters, gab)
    xyb = filter_padded(pad_rows(img, halo), qf, distance, epf_iters, gab,
                        halo, -halo)
    if out == "f32":
        return xyb
    return FF.legacy_filters(xyb, None, distance, False, False, out)


def filter_padded(slab: torch.Tensor, qf: torch.Tensor, distance: float,
                  epf_iters: int, gab: bool, halo: int, qf_row: int
                  ) -> torch.Tensor:
    """apply_filters through fused_filters.legacy_filters (f32) on planes
    padded by halo = filter_halo() rows (edge copies at the image's
    borders, a neighbour shard's rows elsewhere), the halo cropped: one
    launch at epf_iters <= 1, else gaborish, then one launch per EPF pass
    over the whole slab.  qf_row: the quant field's pixel row of the
    slab's row 0."""
    from . import fused_filters as FF
    if epf_iters <= 1:
        slab = FF.legacy_filters(slab, qf, distance, gab, epf_iters == 1,
                                 "f32", qf_row=qf_row)
    else:
        if gab:
            slab = FF.legacy_filters(slab, None, distance, True, False, "f32")
        for _ in range(epf_iters):
            slab = FF.legacy_filters(slab, qf, distance, False, True, "f32",
                                     qf_row=qf_row)
    return slab[:, halo:-halo]


def _reconstruct(ac_coeffs, dc, qf, cfl_x, cfl_b, distance, epf_iters, gab,
                 out):
    _, ny, nx, _, _ = ac_coeffs.shape
    fx, fb = expand_cfl(cfl_x, cfl_b, ny, nx)
    img = dequant_idct(ac_coeffs, dc, qf, fx, fb, distance)
    return _filters(img, qf, distance, epf_iters, gab, out)


def reconstruct_xyb(ac_coeffs, dc, qf, cfl_x, cfl_b, distance: float,
                    epf_iters: int = 1, gab: bool = True) -> torch.Tensor:
    """Decode an 8x8-blocked frame to (3, nY*8, nX*8) filtered XYB; see
    dequant_idct for shapes.  On CUDA: kernel 5 (fused_gab_epf)."""
    return _reconstruct(ac_coeffs, dc, qf, cfl_x, cfl_b, distance,
                        epf_iters, gab, "f32")


def reconstruct_srgb8(ac_coeffs, dc, qf, cfl_x, cfl_b, distance: float,
                      epf_iters: int = 1, gab: bool = True) -> torch.Tensor:
    """Decode to (3, nY*8, nX*8) uint8 sRGB.  On CUDA: kernel 6
    (fused_filters2), filters and output in one launch."""
    return _reconstruct(ac_coeffs, dc, qf, cfl_x, cfl_b, distance,
                        epf_iters, gab, "u8")


def reconstruct_u16(ac_coeffs, dc, qf, cfl_x, cfl_b, distance: float,
                    epf_iters: int = 1, gab: bool = True) -> torch.Tensor:
    """Decode to (3, nY*8, nX*8) uint16 sRGB, xyb_to_u16 of
    reconstruct_xyb.  On CUDA: kernel 5 with the uint16 output, filters
    and output in one launch."""
    return _reconstruct(ac_coeffs, dc, qf, cfl_x, cfl_b, distance,
                        epf_iters, gab, "u16")


def linear_to_codes(rgb: torch.Tensor, scale: int) -> torch.Tensor:
    """Linear sRGB -> float sRGB codes 0 .. scale: clip, linear_to_srgb,
    round half to even, clip."""
    srgb = linear_to_srgb(torch.clamp(rgb, 0.0, 1.0))
    return torch.clamp(torch.round(srgb * float(scale)), 0, scale)


def xyb_to_srgb8(xyb: torch.Tensor) -> torch.Tensor:
    return linear_to_codes(xyb_to_linear_rgb(xyb), 255).to(torch.uint8)


def xyb_to_u16(xyb: torch.Tensor) -> torch.Tensor:
    return linear_to_codes(xyb_to_linear_rgb(xyb), 65535).to(
        torch.int32).to(torch.uint16)


# --------------------------------------------------------------------------
# Encoder side

def forward_xyb(srgb8: torch.Tensor) -> torch.Tensor:
    """(3, H, W) uint8 sRGB -> XYB."""
    return linear_rgb_to_xyb(srgb_to_linear(div(srgb8.float(), 255.0)))


def quantize_coeffs(xyb: torch.Tensor, qf: torch.Tensor, distance: float):
    """XYB image -> (quantised AC (3, nY, nX, 8, 8) int32, DC (3, nY, nX)
    int32).  B is coded as its residual B - Y (the decode-side CfL adds
    Y back with factor 1)."""
    xyb = torch.stack([xyb[0], xyb[1], xyb[2] + (-xyb[1])])
    coeffs = dct2d(blockify(xyb, 8))
    q = torch.round(coeffs / _steps(qf, distance)).to(torch.int32)
    lf_steps = torch.from_numpy(LF_STEPS).to(xyb.device) * _f32(distance)
    dc = torch.round((coeffs[:, :, :, 0, 0] / 8.0)
                     / lf_steps[:, None, None]).to(torch.int32)
    q[:, :, :, 0, 0] = 0
    return q, dc


class LegacyArrays(NamedTuple):
    """The decoded frame's arrays on a device, in reconstruct_*'s
    argument order."""
    ac: torch.Tensor        # (3, nY, nX, 8, 8) int16 (int32 past 32000)
    dc: torch.Tensor        # (3, nY, nX) int32
    qf: torch.Tensor        # (nY, nX) int32
    cfl_x: torch.Tensor     # (tY, tX) int32, 1/64 units
    cfl_b: torch.Tensor
    distance: float


def inputs_from_frame_data(data, device) -> LegacyArrays:
    """host.vardct.frame.VarDctFrameData (numpy) -> LegacyArrays
    on `device`, with the int16 narrowing of codec.py:531-532."""
    ny, nx = data.qf.shape
    ac = data.ac.reshape(3, ny, nx, 8, 8)
    if np.abs(ac).max(initial=0) < 32000:
        ac = ac.astype(np.int16)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return LegacyArrays(t(ac), t(data.dc.astype(np.int32)),
                        t(data.qf.astype(np.int32)),
                        t(data.cfl_x.astype(np.int32)),
                        t(data.cfl_b.astype(np.int32)), float(data.distance))
