"""A round-1 private container (jbrd + jxcf boxes) rendered to pixels:
``decode_to_pixels`` of ``jxl_coder_tpu/jpeg/transcode.py:248-282``.

The host half is ``host_planes``: the coefficient planes decoded from the
jxcf box (``host/jpeg/transcode.py`` ``_load``) and the JPEG header's
quantisation tables and sampling factors.  The device half is
``pixels.pixels``: J1, then J2 with the reference's rules for this route,
nearest chroma (``np.repeat`` by each component's factor) and no +0.5
before the truncation; a grey image repeats Y.
"""

from __future__ import annotations

import numpy as np

from .._device import resolve_device
from ..host.jpeg.parser import JpegError
from ..host.jpeg.transcode import _load
from . import pixels as PX


def host_planes(data: bytes) -> PX.JpegPlanes:
    """A round-1 container's host half (raises JpegError or BitstreamError
    on a file it cannot read)."""
    j = _load(data)
    coeffs = [c.coeffs for c in j.components]
    quant = np.stack([np.asarray(j.quant[c.tq], np.float32)
                      for c in j.components])
    return PX.JpegPlanes(
        coeffs=int16_coefficients(coeffs),
        grids=tuple((c.blocks_h, c.blocks_w) for c in j.components),
        quant=quant,
        factors=tuple((j.vmax // c.v, j.hmax // c.h) for c in j.components),
        height=j.height, width=j.width, triangle=False, rounded=False)


def int16_coefficients(coeffs) -> np.ndarray:
    """Components' (bh, bw, 64) integer coefficients -> one int16 array,
    back to back; a value outside int16 (no 8- or 12-bit JPEG has one)
    raises JpegError."""
    flat = np.concatenate([np.asarray(c).reshape(-1) for c in coeffs])
    if flat.size and (flat.min() < -32768 or flat.max() > 32767):
        raise JpegError("JPEG coefficient outside int16")
    return flat.astype(np.int16)


def decode_to_pixels(data: bytes, device="cuda") -> np.ndarray:
    """Render a round-1 container to (H, W, 3) uint8 RGB on `device`."""
    dev = resolve_device(device)
    return PX.pixels(host_planes(data), dev).cpu().numpy()
