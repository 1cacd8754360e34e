"""An embedded ICC profile applied on the device: pixels to sRGB
(``jxl_coder_tpu/ops/icc_apply.py:22-61``, the reference's
``convertUseDefinedColorSpace`` through littlecms).

``icc_to_srgb(pixels, icc)`` mirrors the JAX function case by case:
(H, W, C) uint8 or uint16 pixels in the profile's space come out in sRGB,
of the same type; 4 channels keep their alpha, 1 channel comes out as 3
(the grey repeated to RGB before the transform), 16-bit samples go
through their top 8 bits and come out as (v << 8) | v.  Where littlecms
builds no transform (a profile that is not RGB, of an abstract, link or
named-colour class, unreadable, with a table littlecms cannot read under
its tag or of the wrong channels, or pixels of 2 or 5+ channels) the
pixels come back unconverted with the reference's warning.

``host/ops/icc.py`` ``plan`` reads the profile into the program
littlecms runs for it, and ``icc_to_srgb`` makes one launch of its
kernel (``csrc/icc.cu``) on a CUDA tensor, or runs its plain twin on a
CPU one; both integer programs live in ``csrc/icc.cuh``, so kernel, twin
and littlecms give the same codes:

- ``transform`` / ``transform_plain``: littlecms's 8-bit matrix-shaper
  program, for a matrix / TRC profile whose black stays 0;
- ``clut_transform`` / ``clut_transform_plain``: its 8-bit CLUT program
  (tetrahedral interpolation on a 33^3 16-bit CLUT), for a lookup-table
  profile (``A2B0`` / ``D2B0``) and a matrix / TRC profile whose black
  point compensation moves every value.

``tables_on`` puts a read profile's tables on the device.  Each wrapper
counts its launches (``transform.launches``, ``clut_transform.launches``).
"""

from __future__ import annotations

import ctypes
import functools
import logging

import torch

from .. import _build
from ..host.ops import icc as HICC
from ..host.ops import icc_lut as HLUT

_log = logging.getLogger("jxl_coder_tpu_torch.icc")
_DTYPES = {torch.uint8: 0, torch.uint16: 1}


@functools.lru_cache(maxsize=None)
def _kernel():
    p, i = ctypes.c_void_p, ctypes.c_int
    return _build.bind(_build.load("icc"), "jxl_icc_to_srgb",
                       [p, p, i, i, ctypes.c_longlong, p])


@functools.lru_cache(maxsize=None)
def _clut_kernel():
    p, i = ctypes.c_void_p, ctypes.c_int
    return _build.bind(_build.load("icc"), "jxl_icc_clut_to_srgb",
                       [p, p, i, i, ctypes.c_longlong, p])


def tables_on(tr, dev) -> torch.Tensor:
    """A read profile's tables (``Transform.packed`` or
    ``ClutTransform.packed``, uint8) on `dev`."""
    return torch.from_numpy(tr.packed()).to(dev)


def _check(pixels: torch.Tensor) -> None:
    if pixels.dim() != 3 or pixels.dtype not in _DTYPES or \
            pixels.shape[2] not in (1, 3, 4):
        raise ValueError(f"pixels: expected (H, W, C) uint8 or uint16, C "
                         f"1, 3 or 4, got {tuple(pixels.shape)} "
                         f"{pixels.dtype}")


def transform_plain(pixels: torch.Tensor, tab: torch.Tensor) -> torch.Tensor:
    """The twin of transform."""
    _check(pixels)
    words = tab[:4 * HICC.PACKED_WORDS].view(torch.int32).to(torch.int64)
    shaper1 = words[:768].reshape(3, 256)
    m = words[768:777].tolist()
    shaper2 = tab[4 * HICC.PACKED_WORDS:].to(torch.int64)
    idx = _codes(pixels)
    r, g, b = (shaper1[k][idx[k]] for k in range(3))
    out = []
    for i in range(3):
        lv = _wrap32(m[3 * i] * r + m[3 * i + 1] * g + m[3 * i + 2] * b
                     + 0x2000) >> 14
        out.append(shaper2[torch.clamp(lv, 0, 16384)])
    return _store(pixels, out)


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 values as int32 arithmetic leaves them (two's complement)."""
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def _codes(pixels: torch.Tensor) -> list:
    """The three 8-bit codes that feed a pixel (int64): a 16-bit sample's
    top byte; a grey pixel's code thrice."""
    codes = pixels.to(torch.int64)
    if pixels.dtype == torch.uint16:
        codes = codes >> 8
    if pixels.shape[2] == 1:
        return [codes[..., 0]] * 3
    return [codes[..., k] for k in range(3)]


def _store(pixels: torch.Tensor, codes: list) -> torch.Tensor:
    """(H, W, 3 or C) output of the pixels' type from three 8-bit code
    planes, alpha copied."""
    h, w, c = pixels.shape
    out = torch.empty((h, w, 3 if c == 1 else c), dtype=pixels.dtype,
                      device=pixels.device)
    for i, code in enumerate(codes):
        if pixels.dtype == torch.uint16:
            code = (code << 8) | code
        out[..., i] = code.to(pixels.dtype)
    if c == 4:
        out[..., 3] = pixels[..., 3]
    return out


def clut_transform_plain(pixels: torch.Tensor,
                         tab: torch.Tensor) -> torch.Tensor:
    """The twin of clut_transform: PrelinEval8 in torch integer ops, in
    clut_pixel's order."""
    _check(pixels)
    words = tab[:4 * HLUT.CLUT_WORDS].view(torch.int32).to(torch.int64)
    offs, fracs = words[:768].reshape(3, 256), words[768:].reshape(3, 256)
    lut = tab[4 * HLUT.CLUT_WORDS:].view(torch.int16).to(torch.int64) & \
        0xFFFF
    idx = _codes(pixels)
    X0, Y0, Z0 = (offs[k][idx[k]] for k in range(3))
    rx, ry, rz = (fracs[k][idx[k]] for k in range(3))
    X1 = X0 + torch.where(rx == 0, 0, 3 * HLUT.GRID * HLUT.GRID)
    Y1 = Y0 + torch.where(ry == 0, 0, 3 * HLUT.GRID)
    Z1 = Z0 + torch.where(rz == 0, 0, 3)
    # PrelinEval8's six tetrahedra, tested in its order: t = 0 x >= y >= z,
    # 1 x >= z >= y, 2 z >= x >= y, 3 y >= x >= z, 4 y >= z >= x, else 5
    t = torch.full_like(rx, 5)
    for k, cond in reversed(list(enumerate([
            (rx >= ry) & (ry >= rz), (rx >= rz) & (rz >= ry),
            (rz >= rx) & (rx >= ry), (ry >= rx) & (rx >= rz),
            (ry >= rz) & (rz >= rx)]))):
        t = torch.where(cond, k, t)
    # the corners after the first and second steps, and each step's
    # fraction
    xa, xb = t <= 1, t <= 3
    ya, yb = (t == 3) | (t == 4), (t != 1) & (t != 2)
    za, zb = (t == 2) | (t == 5), (t != 0) & (t != 3)
    a = torch.where(xa, X1, X0) + torch.where(ya, Y1, Y0) + \
        torch.where(za, Z1, Z0)
    b = torch.where(xb, X1, X0) + torch.where(yb, Y1, Y0) + \
        torch.where(zb, Z1, Z0)
    r1 = torch.where(xa, rx, torch.where(ya, ry, rz))
    r3 = torch.where(~xb, rx, torch.where(~yb, ry, rz))
    r2 = rx + ry + rz - r1 - r3
    o, e = X0 + Y0 + Z0, X1 + Y1 + Z1
    out = []
    for ch in range(3):
        v0, va, vb, ve = lut[o + ch], lut[a + ch], lut[b + ch], lut[e + ch]
        rest = _wrap32((va - v0) * r1 + (vb - va) * r2 + (ve - vb) * r3
                       + 0x8001)
        w = (v0 + (_wrap32(rest + (rest >> 16)) >> 16)) & 0xFFFF
        out.append(((w * 65281 + 8388608) >> 24) & 0xFF)
    return _store(pixels, out)


def clut_transform(pixels: torch.Tensor, tab: torch.Tensor) -> torch.Tensor:
    """(H, W, C) uint8 / uint16 pixels, C 1, 3 or 4, through a profile
    read into littlecms's CLUT program (tab from tables_on of a
    ClutTransform, on the pixels' device) -> (H, W, 3 if C is 1 else C)
    sRGB pixels of the same type."""
    _check(pixels)
    if pixels.device.type == "cpu":
        return clut_transform_plain(pixels, tab)
    if tab.device != pixels.device or tab.dtype != torch.uint8 or \
            tab.numel() != HLUT.CLUT_BYTES or not tab.is_contiguous():
        raise ValueError("tab: expected tables_on's bytes of a "
                         "ClutTransform on the pixels' device")
    return _launch(_clut_kernel(), clut_transform, pixels, tab)


clut_transform.launches = 0


def _launch(kernel, wrapper, pixels: torch.Tensor,
            tab: torch.Tensor) -> torch.Tensor:
    pixels = pixels.contiguous()
    h, w, c = pixels.shape
    out = torch.empty((h, w, 3 if c == 1 else c), dtype=pixels.dtype,
                      device=pixels.device)
    if h and w:
        _build.launch(kernel, pixels.device, pixels.data_ptr(),
                      out.data_ptr(), _DTYPES[pixels.dtype], c, h * w,
                      tab.data_ptr())
        wrapper.launches += 1
    return out


def transform(pixels: torch.Tensor, tab: torch.Tensor) -> torch.Tensor:
    """(H, W, C) uint8 / uint16 pixels, C 1, 3 or 4, through a read
    profile (tab from tables_on, on the pixels' device) -> (H, W, 3 if C
    is 1 else C) sRGB pixels of the same type."""
    _check(pixels)
    if pixels.device.type == "cpu":
        return transform_plain(pixels, tab)
    if tab.device != pixels.device or tab.dtype != torch.uint8 or \
            tab.numel() != HICC.PACKED_BYTES or not tab.is_contiguous():
        raise ValueError("tab: expected tables_on's bytes of a Transform "
                         "on the pixels' device")
    return _launch(_kernel(), transform, pixels, tab)


transform.launches = 0


def icc_to_srgb(pixels: torch.Tensor, icc: bytes) -> torch.Tensor:
    """(H, W, C) uint8 / uint16 pixels in the profile's space -> sRGB, as
    jxl_coder_tpu.ops.icc_apply.icc_to_srgb returns them (module
    docstring); the pixels themselves where littlecms builds no
    transform."""
    if pixels.dtype not in _DTYPES:
        raise ValueError(f"pixels: expected uint8 or uint16, got "
                         f"{pixels.dtype}")
    try:
        if pixels.dim() != 3 or pixels.shape[2] not in (1, 3, 4):
            raise HICC.Rejected(f"pixels of shape {tuple(pixels.shape)}: "
                                f"expected 1, 3 or 4 channels")
        tr = HICC.plan(bytes(icc))
    except HICC.Rejected as e:
        # log-and-continue, as the reference does on a littlecms failure
        _log.warning("ICC -> sRGB transform failed: %s — returning pixels "
                     "unconverted", e)
        return pixels
    program = clut_transform if isinstance(tr, HLUT.ClutTransform) \
        else transform
    return program(pixels, tables_on(tr, pixels.device))
