"""Pixel-format packing, on the device (``jxl_coder_tpu/ops/pack.py``):
RGBA8888, RGBA_F16, RGB565 and RGBA1010102, their unpackers, and the
PreferredColorConfig dispatch of ``reformat``.

``convert(pixels, fmt, tone)`` is kernel S4 of ``csrc/pixel_ops.cu``
(``reformat_kernel``): (H, W, C) uint8 / uint16 codes or float32 values
in [0, 1], any C -> values / maxv, optionally the HDR -> SDR tone map
of ``ops/tone.py`` on the colour (then the codes of it), grey repeated
to RGB, an opaque alpha where there is none, then one packer: ``CODES``
(the tone-mapped codes, the input's type and channels), ``RGBA8888``
((H, W, 4) uint8), ``RGBA_F16`` ((H, W, 4) float16), ``RGB565`` ((H, W)
uint16, R in the top bits) or ``RGBA1010102`` ((H, W) uint32, R in the
low bits, A in the top two).  Every rounding is half to even (``rintf``,
``torch.round``, as ``jnp.round``), so the packed codes of a float input
equal the reference's.  ``decode_sampled`` runs it once, fused, on the
rescaled codes.  ``unpack`` (``unpack_kernel``) is the inverse of the
last two.  Each wrapper counts its launches in ``.launches``; on a CPU
tensor it runs its plain twin (``convert_plain``, ``unpack_plain``), on a
CUDA tensor it launches the kernel or raises.

The reference's ``reformat`` takes (H, W, 4) floats; ``convert`` takes
what ``decode_sampled`` holds before its grey and alpha steps
(``api.py:1206-1213``), and a float (H, W, 4) input is the reference's
case.  A grey image with alpha (C 2) becomes (g, g, g, a); the reference
leaves it two channels wide (its packers then read past them).  Past four
channels (extra channels beyond alpha) RGBA8888 and RGBA_F16 pack all C,
RGB565 the first three and RGBA1010102 the first four, as the reference's
packers do with what ``decode_sampled`` hands them there.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np
import torch

from .. import _build
from ..host.api import PreferredColorConfig
from . import fp
from . import tone as T

CODES, RGBA8888, RGBA_F16, RGB565, RGBA1010102 = range(5)
# dtype -> (the kernel's type code, maxv)
_DTYPES = {torch.uint8: (0, 255.0), torch.uint16: (1, 65535.0),
           torch.float32: (2, 1.0)}


@functools.lru_cache(maxsize=None)
def _kernels():
    lib = _build.load("pixel_ops")
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
        ctypes.c_float
    return (_build.bind(lib, "jxl_reformat", [p, i, ll, i, f, p, i, p]),
            _build.bind(lib, "jxl_unpack", [p, ll, i, p]))


def fmt_of(config: int, bits_per_sample: int = 8) -> int:
    """The packer of a PreferredColorConfig (ReformatBitmap.cpp:52-63):
    DEFAULT is F16 above 8 bits and 8888 otherwise, HARDWARE 8888."""
    C = PreferredColorConfig
    if config == C.DEFAULT:
        return RGBA_F16 if bits_per_sample > 8 else RGBA8888
    fmt = {C.RGBA_8888: RGBA8888, C.RGBA_F16: RGBA_F16, C.RGB_565: RGB565,
           C.RGBA_1010102: RGBA1010102, C.HARDWARE: RGBA8888}.get(config)
    if fmt is None:
        raise ValueError(f"unknown color config {config}")
    return fmt


def _out_like(pixels: torch.Tensor, fmt: int) -> torch.Tensor:
    shape = pixels.shape[:-1]
    dev = pixels.device
    if fmt == CODES:
        return torch.empty(pixels.shape, dtype=pixels.dtype, device=dev)
    if fmt in (RGBA8888, RGBA_F16):
        return torch.empty(shape + (max(4, pixels.shape[-1]),), device=dev,
                           dtype=torch.uint8 if fmt == RGBA8888
                           else torch.float16)
    return torch.empty(shape, device=dev, dtype=torch.uint16
                       if fmt == RGB565 else torch.uint32)


def _q(v: torch.Tensor, scale: float) -> torch.Tensor:
    return torch.clamp(torch.round(v * scale), 0.0, scale).to(torch.int64)


def convert_plain(pixels: torch.Tensor, fmt: int,
                  tone: Optional[T.ToneParams] = None) -> torch.Tensor:
    """The twin of convert."""
    c = pixels.shape[-1]
    maxv = _DTYPES[pixels.dtype][1]
    v = pixels.to(torch.float32)
    if tone is not None and c >= 3:
        v = torch.cat([T.sdr_codes_plain(fp.div(v[..., :3], maxv), maxv,
                                         tone), v[..., 3:]], -1)
    if fmt == CODES:
        return v.to(pixels.dtype)
    v = fp.div(v, maxv)
    if c <= 2:
        rgb = v[..., :1].expand(v.shape[:-1] + (3,))
    else:
        rgb = v[..., :3]
    a = v[..., 3:4] if c >= 4 else (v[..., -1:] if c == 2
                                    else torch.ones_like(v[..., :1]))
    rgba = torch.cat([rgb, a], -1)
    if c > 4 and fmt in (RGBA8888, RGBA_F16):
        rgba = torch.cat([rgba, v[..., 4:]], -1)
    if fmt == RGBA8888:
        return _q(rgba, 255.0).to(torch.uint8)
    if fmt == RGBA_F16:
        return rgba.to(torch.float16)
    if fmt == RGB565:
        return ((_q(rgba[..., 0], 31.0) << 11) | (_q(rgba[..., 1], 63.0) << 5)
                | _q(rgba[..., 2], 31.0)).to(torch.uint16)
    return (_q(rgba[..., 0], 1023.0) | (_q(rgba[..., 1], 1023.0) << 10)
            | (_q(rgba[..., 2], 1023.0) << 20)
            | (_q(rgba[..., 3], 3.0) << 30)).to(torch.uint32)


def convert(pixels: torch.Tensor, fmt: int,
            tone: Optional[T.ToneParams] = None) -> torch.Tensor:
    """(..., C) uint8 / uint16 codes or float32 values, C >= 1 -> packed
    as `fmt`; tone: ``tone.params`` of the stream to map the colour (C
    >= 3) from HDR / wide gamut to SDR sRGB first, or None."""
    if pixels.dtype not in _DTYPES or pixels.dim() < 1 or \
            pixels.shape[-1] < 1:
        raise ValueError(f"pixels: expected (..., C) uint8, uint16 or "
                         f"float32, C >= 1, got {tuple(pixels.shape)} "
                         f"{pixels.dtype}")
    if fmt not in range(5) or (fmt == CODES and
                               pixels.dtype == torch.float32):
        raise ValueError(f"fmt {fmt} on {pixels.dtype}")
    if pixels.device.type == "cpu":
        return convert_plain(pixels, fmt, tone)
    pixels = pixels.contiguous()
    out = _out_like(pixels, fmt)
    n = pixels.numel() // pixels.shape[-1]
    if n:
        code, maxv = _DTYPES[pixels.dtype]
        # the constants are a host array, copied into the launch parameters
        prm = tone.p.ctypes.data if tone is not None else None
        _build.launch(_kernels()[0], pixels.device, pixels.data_ptr(), code,
                      n, pixels.shape[-1], maxv, prm, fmt, out.data_ptr())
        convert.launches += 1
    return out


convert.launches = 0


def reformat(pixels: torch.Tensor, config: int, bits_per_sample: int = 8,
             tone: Optional[T.ToneParams] = None) -> torch.Tensor:
    """PreferredColorConfig dispatch (ReformatBitmap.cpp:52-63) of
    (..., C) codes or [0, 1] floats, through convert."""
    return convert(pixels, fmt_of(config, bits_per_sample), tone)


def to_rgba8888(rgba_f: torch.Tensor) -> torch.Tensor:
    """(..., 4) float [0, 1] -> uint8 RGBA."""
    return convert(rgba_f, RGBA8888)


def to_rgba_f16(rgba_f: torch.Tensor) -> torch.Tensor:
    return convert(rgba_f, RGBA_F16)


def to_rgb565(rgb_f: torch.Tensor) -> torch.Tensor:
    """(..., 3 or 4) float -> uint16 RGB565."""
    return convert(rgb_f[..., :3], RGB565)


def to_rgba1010102(rgba_f: torch.Tensor) -> torch.Tensor:
    """(..., 4) float -> uint32 RGBA1010102 (R low bits, A top 2)."""
    return convert(rgba_f, RGBA1010102)


def unpack_plain(packed: torch.Tensor) -> torch.Tensor:
    """The twin of unpack.  Each field times the float32 of 1 / its
    maximum: XLA compiles the reference's division by a constant so."""
    v = packed.to(torch.int64)
    if packed.dtype == torch.uint16:
        parts = [((v >> 11) & 31, 31.0), ((v >> 5) & 63, 63.0),
                 (v & 31, 31.0)]
    else:
        parts = [(v & 1023, 1023.0), ((v >> 10) & 1023, 1023.0),
                 ((v >> 20) & 1023, 1023.0), ((v >> 30) & 3, 3.0)]
    return torch.stack([p.to(torch.float32) * float(np.float32(1.0 / s))
                        for p, s in parts], -1)


def unpack(packed: torch.Tensor) -> torch.Tensor:
    """uint16 RGB565 -> (..., 3) float32 (from_rgb565); uint32
    RGBA1010102 -> (..., 4) float32 (from_rgba1010102)."""
    if packed.dtype not in (torch.uint16, torch.uint32):
        raise ValueError(f"packed: expected uint16 (RGB565) or uint32 "
                         f"(RGBA1010102), got {packed.dtype}")
    if packed.device.type == "cpu":
        return unpack_plain(packed)
    packed = packed.contiguous()
    fmt = RGB565 if packed.dtype == torch.uint16 else RGBA1010102
    out = torch.empty(packed.shape + (3 if fmt == RGB565 else 4,),
                      dtype=torch.float32, device=packed.device)
    if packed.numel():
        _build.launch(_kernels()[1], packed.device, packed.data_ptr(),
                      packed.numel(), fmt, out.data_ptr())
        unpack.launches += 1
    return out


unpack.launches = 0


def from_rgb565(packed: torch.Tensor) -> torch.Tensor:
    return unpack(packed)


def from_rgba1010102(packed: torch.Tensor) -> torch.Tensor:
    return unpack(packed)
