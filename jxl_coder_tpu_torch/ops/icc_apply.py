"""An embedded ICC profile applied on the device: pixels to sRGB
(``jxl_coder_tpu/ops/icc_apply.py:22-61``, the reference's
``convertUseDefinedColorSpace`` through littlecms).

``icc_to_srgb(pixels, icc)`` mirrors the JAX function case by case:
(H, W, C) uint8 or uint16 pixels in the profile's space come out in sRGB,
of the same type; 4 channels keep their alpha, 1 channel comes out as 3
(the grey repeated to RGB before the transform), 16-bit samples go
through their top 8 bits and come out as (v << 8) | v.  Where littlecms
builds no transform (a profile that is not RGB, of an abstract, link or
named-colour class, unreadable, or pixels of 2 or 5+ channels) the
pixels come back unconverted with the reference's warning; a profile
littlecms converts by a lookup table, or whose black is not 0, raises
NotImplementedError (``host/ops/icc.py``, which reads the profile).

``transform`` applies a read profile (``tables_on``: its tables on the
device) in one launch of ``csrc/icc.cu`` on a CUDA tensor, or its plain
twin ``transform_plain`` on a CPU one: littlecms's 8-bit matrix-shaper
program in integers (``csrc/icc.cuh``), so both give littlecms's codes.
The wrapper counts its launches in ``transform.launches``.
"""

from __future__ import annotations

import ctypes
import functools
import logging

import torch

from .. import _build
from ..host.ops import icc as HICC

_log = logging.getLogger("jxl_coder_tpu_torch.icc")
_DTYPES = {torch.uint8: 0, torch.uint16: 1}


@functools.lru_cache(maxsize=None)
def _kernel():
    p, i = ctypes.c_void_p, ctypes.c_int
    return _build.bind(_build.load("icc"), "jxl_icc_to_srgb",
                       [p, p, i, i, ctypes.c_longlong, p])


def tables_on(tr: HICC.Transform, dev) -> torch.Tensor:
    """A read profile's tables (``Transform.packed``, uint8) on `dev`."""
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
    h, w, c = pixels.shape
    words = tab[:4 * HICC.PACKED_WORDS].view(torch.int32).to(torch.int64)
    shaper1 = words[:768].reshape(3, 256)
    m = words[768:777].tolist()
    shaper2 = tab[4 * HICC.PACKED_WORDS:].to(torch.int64)
    codes = pixels.to(torch.int64)
    if pixels.dtype == torch.uint16:
        codes = codes >> 8
    idx = [codes[..., 0]] * 3 if c == 1 else [codes[..., k] for k in
                                              range(3)]
    r, g, b = (shaper1[k][idx[k]] for k in range(3))
    out = torch.empty((h, w, 3 if c == 1 else c), dtype=pixels.dtype,
                      device=pixels.device)
    for i in range(3):
        lv = (m[3 * i] * r + m[3 * i + 1] * g + m[3 * i + 2] * b
              + 0x2000) >> 14
        code = shaper2[torch.clamp(lv, 0, 16384)]
        if pixels.dtype == torch.uint16:
            code = (code << 8) | code
        out[..., i] = code.to(pixels.dtype)
    if c == 4:
        out[..., 3] = pixels[..., 3]
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
        raise ValueError("tab: expected tables_on's bytes on the pixels' "
                         "device")
    pixels = pixels.contiguous()
    h, w, c = pixels.shape
    out = torch.empty((h, w, 3 if c == 1 else c), dtype=pixels.dtype,
                      device=pixels.device)
    if h and w:
        _build.launch(_kernel(), pixels.device, pixels.data_ptr(),
                      out.data_ptr(), _DTYPES[pixels.dtype], c, h * w,
                      tab.data_ptr())
        transform.launches += 1
    return out


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
    return transform(pixels, tables_on(tr, pixels.device))
