"""A recompressed JPEG's pixels on the device: kernels J1 and J2.

The JAX package renders a chroma-subsampled recompressed JPEG
(``jxl_coder_tpu/jpeg/wire.py:725-769``) and a round-1 container
(``jxl_coder_tpu/jpeg/transcode.py:248-282``) by dequantising each
component's coefficients in numpy, running ``idct2d`` (a jitted f32
einsum pair) on the device, then upsampling the chroma, converting BT.601
YCbCr to RGB and truncating to u8 in numpy.  Here the host hands over the
quantised coefficients (``JpegPlanes``) and the card does the rest, in two
launches of ``csrc/jpeg.cu``:

- ``jpeg_idct`` (J1): every component's int16 zigzag coefficients and its
  64 quantisation values -> its f32 plane after the IDCT and +128, in
  raster order; one launch for all components (the DCT basis and the
  zigzag order kept on the device, ``_tables``);
- ``ycbcr_to_rgb`` (J2): the planes at their own sizes -> (H, W, 3) u8:
  each chroma sample fetched by the route's rule (wire.py's triangle
  upsampling, or transcode.py's nearest), BT.601, the clip and the
  truncation (wire.py adds 0.5 first; transcode.py does not); a grey
  round-1 image repeats Y.

Each wrapper counts its launches in ``.launches``; on a CPU tensor it runs
its plain twin (``*_plain``), on a CUDA tensor it launches the kernel or
raises.  The twins do the kernels' operations in their order: J1's sums
are ``vardct/dct.py``'s ``idct2d`` (``ops/fp.py``'s ``matmul``, the order of
XLA's CPU dot, so its planes equal the JAX package's ``idct2d`` bit for
bit), J2's the reference's f32 operations one by one.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from .. import _build
from ..host.jpeg.parser import ZIGZAG
from ..vardct.dct import dct_matrix, idct2d

__all__ = ["JpegPlanes", "pixels", "upload", "jpeg_idct", "jpeg_idct_plain",
           "ycbcr_to_rgb", "ycbcr_to_rgb_plain"]

MAX_COMPONENTS = 4
# the reference's f32 constants (numpy rounds the Python floats to f32)
_KR, _KGB, _KGR, _KB = (float(np.float32(v))
                        for v in (1.402, 0.344136, 0.714136, 1.772))


class JpegPlanes(NamedTuple):
    """The host half of a recompressed JPEG's decode (routes 2 and 3):
    every component's quantised coefficients, int16 in zigzag order, back
    to back ((bh, bw, 64) each, with the DC in place); their block grids;
    their quantisation tables ((n, 64) f32, zigzag order); each
    component's upsampling factors (fy, fx); the output size; the route's
    rules: `triangle` upsampling (else nearest) and `rounded` (+0.5 before
    the truncation).  `before` is empty (the other host halves' LF and
    reference frames)."""
    coeffs: np.ndarray
    grids: Tuple[Tuple[int, int], ...]
    quant: np.ndarray
    factors: Tuple[Tuple[int, int], ...]
    height: int
    width: int
    triangle: bool
    rounded: bool
    before: tuple = ()


# --------------------------------------------------------------------------
# The kernels' bindings

@functools.lru_cache(maxsize=None)
def _kernels():
    lib = _build.load("jpeg")
    p, i = ctypes.c_void_p, ctypes.c_int
    return (_build.bind(lib, "jxl_jpeg_idct", [p, p, i, p, p, p, p]),
            _build.bind(lib, "jxl_ycbcr_to_rgb", [p, p, i, p, i, i, i, i]))


_TABLES = {}
_TABLES_LOCK = threading.Lock()


def _tables(dev: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """J1's constant tables on `dev`, made once per device: the 8x8 DCT-II
    basis (f32) and the zigzag order (int32)."""
    with _TABLES_LOCK:
        if dev not in _TABLES:
            _TABLES[dev] = (
                torch.from_numpy(dct_matrix(8).reshape(-1).copy()).to(dev),
                torch.from_numpy(np.asarray(ZIGZAG, np.int32)).to(dev))
        return _TABLES[dev]


def _offsets(grids) -> List[int]:
    offs = [0]
    for bh, bw in grids:
        offs.append(offs[-1] + bh * bw * 64)
    return offs


def _check_idct(coef: torch.Tensor, grids, quant: torch.Tensor) -> None:
    n = len(grids)
    if not 1 <= n <= MAX_COMPONENTS:
        raise ValueError(f"{n} components: expected 1..{MAX_COMPONENTS}")
    if coef.dtype != torch.int16 or coef.dim() != 1 or \
            coef.numel() != _offsets(grids)[-1]:
        raise ValueError(f"coef: expected the components' int16 "
                         f"coefficients, {_offsets(grids)[-1]} values, got "
                         f"{tuple(coef.shape)} {coef.dtype}")
    if quant.dtype != torch.float32 or tuple(quant.shape) != (n, 64) or \
            quant.device != coef.device:
        raise ValueError(f"quant: expected ({n}, 64) float32 on the "
                         f"coefficients' device")


# --------------------------------------------------------------------------
# J1: the block IDCT

def jpeg_idct_plain(coef: torch.Tensor, grids, quant: torch.Tensor
                    ) -> List[torch.Tensor]:
    """The twin of jpeg_idct."""
    offs = _offsets(grids)
    zz = _tables(coef.device)[1].long()
    out = []
    for c, (bh, bw) in enumerate(grids):
        deq = coef[offs[c]:offs[c + 1]].reshape(bh, bw, 64).to(
            torch.float32) * quant[c]
        blocks = torch.empty_like(deq)
        blocks[:, :, zz] = deq
        pix = idct2d(blocks.reshape(bh, bw, 8, 8))
        out.append(pix.permute(0, 2, 1, 3).reshape(bh * 8, bw * 8) + 128.0)
    return out


def jpeg_idct(coef: torch.Tensor, grids: Sequence[Tuple[int, int]],
              quant: torch.Tensor) -> List[torch.Tensor]:
    """Every component's quantised coefficients (int16, zigzag order, its
    (bh, bw, 64) blocks back to back in `coef`) and its quantisation table
    (a row of `quant`, (n, 64) f32 on the same device) -> its (bh * 8,
    bw * 8) f32 plane: dequantised, de-zigzagged, the 8x8 IDCT and +128,
    in raster order."""
    _check_idct(coef, grids, quant)
    if coef.device.type == "cpu":
        return jpeg_idct_plain(coef, grids, quant)
    offs = _offsets(grids)
    out = torch.empty(offs[-1], dtype=torch.float32, device=coef.device)
    if offs[-1]:
        # the components' offsets and grids go into the launch parameters
        comps = np.asarray([(offs[c], offs[c], bh, bw)
                            for c, (bh, bw) in enumerate(grids)], np.int64)
        basis, zigzag = _tables(coef.device)
        _build.launch(_kernels()[0], coef.device, coef.data_ptr(),
                      out.data_ptr(), len(grids), comps.ctypes.data,
                      quant.contiguous().data_ptr(), basis.data_ptr(),
                      zigzag.data_ptr())
        jpeg_idct.launches += 1
    return [out[offs[c]:offs[c + 1]].view(bh * 8, bw * 8)
            for c, (bh, bw) in enumerate(grids)]


jpeg_idct.launches = 0


# --------------------------------------------------------------------------
# J2: chroma upsampling and YCbCr -> RGB

def _upsampled_plain(p: torch.Tensor, fy: int, fx: int, triangle: bool,
                     h: int, w: int) -> torch.Tensor:
    """The plane at the output size: nearest (np.repeat), or the triangle
    (3a + b) / 4 per upsampled axis, the horizontal pass first, edges
    repeated; cropped to (h, w)."""
    if not triangle:
        iy = torch.arange(h, device=p.device) // fy
        ix = torch.arange(w, device=p.device) // fx
        return p[iy][:, ix]
    for dim, f in ((1, fx), (0, fy)):
        if f == 1:
            continue
        q = p.movedim(dim, 0)
        prev = torch.cat([q[:1], q[:-1]])
        nxt = torch.cat([q[1:], q[-1:]])
        up = torch.empty((2 * q.shape[0],) + tuple(q.shape[1:]),
                         dtype=q.dtype, device=q.device)
        up[0::2] = (3.0 * q + prev) * 0.25
        up[1::2] = (3.0 * q + nxt) * 0.25
        p = up.movedim(0, dim)
    return p[:h, :w]


def _codes_plain(v: torch.Tensor, rounded: bool) -> torch.Tensor:
    if rounded:
        v = v + 0.5
    return torch.clamp(v, 0.0, 255.0).to(torch.uint8)


def ycbcr_to_rgb_plain(planes: Sequence[torch.Tensor], factors, height: int,
                       width: int, triangle: bool, rounded: bool
                       ) -> torch.Tensor:
    """The twin of ycbcr_to_rgb."""
    up = [_upsampled_plain(p, fy, fx, triangle, height, width)
          for p, (fy, fx) in zip(planes, factors)]
    if len(up) == 1:
        return _codes_plain(up[0], rounded)[:, :, None].expand(
            height, width, 3).contiguous()
    y, cb, cr = up[0], up[1] - 128.0, up[2] - 128.0
    r = y + _KR * cr
    g = (y - _KGB * cb) - _KGR * cr
    b = y + _KB * cb
    return torch.stack([_codes_plain(v, rounded) for v in (r, g, b)], -1)


def _check_rgb(planes, factors, triangle: bool) -> None:
    if len(planes) not in (1, 3) or len(factors) != len(planes):
        raise ValueError(f"{len(planes)} planes, {len(factors)} factors: "
                         f"expected 1 (grey) or 3 (Y, Cb, Cr) of each")
    for p, (fy, fx) in zip(planes, factors):
        if p.dtype != torch.float32 or p.dim() != 2 or \
                p.device != planes[0].device:
            raise ValueError("planes: expected 2-D float32 planes on one "
                             "device")
        if fy < 1 or fx < 1 or (triangle and max(fy, fx) > 2):
            raise ValueError(f"factors ({fy}, {fx}): the triangle "
                             f"upsampling takes 1 or 2, nearest any >= 1")


def ycbcr_to_rgb(planes: Sequence[torch.Tensor],
                 factors: Sequence[Tuple[int, int]], height: int, width: int,
                 triangle: bool, rounded: bool) -> torch.Tensor:
    """One (grey) or three (Y, Cb, Cr) f32 planes at their own sizes, each
    upsampled (fy, fx) times -> (height, width, 3) uint8: triangle or
    nearest chroma, BT.601 (the reference's f32 constants and order),
    clipped to [0, 255] (after +0.5 when `rounded`) and truncated."""
    _check_rgb(planes, factors, triangle)
    dev = planes[0].device
    if dev.type == "cpu":
        return ycbcr_to_rgb_plain(planes, factors, height, width, triangle,
                                  rounded)
    planes = [p.contiguous() for p in planes]
    out = torch.empty((height, width, 3), dtype=torch.uint8, device=dev)
    if height and width:
        ptrs = (ctypes.c_void_p * len(planes))(*[p.data_ptr()
                                                 for p in planes])
        dims = np.asarray([(p.shape[0], p.shape[1], fy, fx)
                           for p, (fy, fx) in zip(planes, factors)], np.int32)
        _build.launch(_kernels()[1], dev, ctypes.cast(ptrs, ctypes.c_void_p),
                      dims.ctypes.data, len(planes), out.data_ptr(), height,
                      width, int(triangle), int(rounded))
        ycbcr_to_rgb.launches += 1
    return out


ycbcr_to_rgb.launches = 0


# --------------------------------------------------------------------------
# The device half

def upload(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A host array on `dev`: on a card staged in pinned memory and copied
    without blocking the host."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if dev.type == "cpu":
        return t
    return t.pin_memory().to(dev, non_blocking=True)


def pixels(host: JpegPlanes, dev: torch.device, put=None) -> torch.Tensor:
    """A JpegPlanes' (H, W, 3) uint8 pixels on `dev`: the coefficients
    uploaded (put: how a numpy array gets there; default ``upload``), J1,
    then J2 on the Y, Cb and Cr planes (or the grey one)."""
    put = put if put is not None else functools.partial(upload, dev=dev)
    planes = jpeg_idct(put(host.coeffs), host.grids, put(host.quant))
    keep = min(len(planes), 3)      # a fourth (CMYK's K) is not drawn
    return ycbcr_to_rgb(planes[:keep], host.factors[:keep], host.height,
                        host.width, host.triangle, host.rounded)
