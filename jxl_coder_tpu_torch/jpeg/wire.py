"""A chroma-subsampled recompressed JPEG (jbrd box + a do_ycbcr VarDCT
frame) rendered to pixels: ``decode_subsampled_to_pixels`` of
``jxl_coder_tpu/jpeg/wire.py:725-769``.

The host half is ``host_planes``: the frame's quantised coefficients read
on the host (``host/jpeg/wire.py`` ``read_jpeg_coefficients``, each
channel on its own block grid), de-scanned to zigzag order with the DC put
in, and its RAW quantisation tables in zigzag order.  The device half is
``pixels.pixels``: J1, then J2 with the reference's rules for this route,
the triangle (3a + b) / 4 upsampling per shifted axis and +0.5 before the
truncation.
"""

from __future__ import annotations

import numpy as np

from .._device import resolve_device
from ..host.bitstream import container as container_mod
from ..host.jpeg.parser import ZIGZAG
from ..host.jpeg.wire import (_frame_geometry, _scan_perm,
                              read_jpeg_coefficients)
from . import pixels as PX
from .transcode import int16_coefficients


def host_planes(data: bytes) -> PX.JpegPlanes:
    """A subsampled recompressed JPEG's host half, its components in JPEG
    order (Y, Cb, Cr) (raises JpegError or BitstreamError on a file it
    cannot read)."""
    cont = container_mod.extract_codestream(data)
    hdr, fh, dc_int, vals, qraw, _lf = read_jpeg_coefficients(cont.codestream)
    _xs_b, _ys_b, shifts = _frame_geometry(fh, hdr)
    inv = np.argsort(_scan_perm())          # zigzag index -> scan index
    coeffs, grids, quant, factors = [], [], [], []
    for c, mc in ((1, 0), (0, 1), (2, 2)):      # Y, Cb, Cr
        v = vals[c][:, :, inv]
        v[:, :, 0] = dc_int[mc]
        coeffs.append(v)
        grids.append(v.shape[:2])
        quant.append(qraw[c].T.reshape(-1)[ZIGZAG].astype(np.float32))
        hs, vs = (0, 0) if shifts is None else shifts[c]
        factors.append((1 << vs, 1 << hs))
    return PX.JpegPlanes(
        coeffs=int16_coefficients(coeffs), grids=tuple(grids),
        quant=np.stack(quant), factors=tuple(factors),
        height=hdr.size.ysize, width=hdr.size.xsize, triangle=True,
        rounded=True)


def decode_subsampled_to_pixels(data: bytes, device="cuda") -> np.ndarray:
    """Render a chroma-subsampled recompressed-JPEG JXL to (H, W, 3) uint8
    RGB on `device`."""
    dev = resolve_device(device)
    return PX.pixels(host_planes(data), dev).cpu().numpy()
