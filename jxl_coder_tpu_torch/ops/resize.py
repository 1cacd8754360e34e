"""The sampled decode's rescale, on the device (``jxl_coder_tpu/ops/
resize.py:108-182``, ``resize_plane_stack`` inside ``rescale_image``).

``rescale_image`` takes (H, W, C) codes (uint8 / uint16) or float32 values
and returns them resized as a scale mode says (``host/ops/resize.py``
``plan``: FIT, FILL with its centre crop, RESIZE): codes / maxv, alpha
premultiplied when the image has unassociated alpha (C 2 or 4), a
vertical then a horizontal pass of ``resample_matrix``'s weights, alpha
unpremultiplied (``clip(alpha, 1e-6, 1)``), clip to [0, 1] and round
half to even to the input's type, at any channel count (alpha only at C
2 or 4, as the reference).  On a CUDA tensor that is kernel S3 of
``csrc/sample.cu``, one launch: each output reads only its row's band of
nonzero weights (``host/ops/resize.py`` ``band``; the folded edge taps
are summed into the band, as the matrix holds them), a block computes a
tile of the kept rows and columns with its vertical sums in shared
memory (``csrc/sample.cuh``), and nothing but the output is allocated.  Its plain twin, ``rescale_image_plain``, is
the reference's dense form: two float32 matrix products
(``resize_plane_stack_plain``, TF32 off), then the crop.  The two sum in
other orders, so their codes may differ by 1 where a value lies near a
rounding boundary.  The wrapper counts its launches in
``rescale_image.launches``; on a CPU tensor it runs the twin, on a CUDA
tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from ..host.ops import resize as HR
from . import fp

# dtype -> (the kernel's type code, maxv)
_DTYPES = {torch.uint8: (0, 255.0), torch.uint16: (1, 65535.0),
           torch.float32: (2, 1.0)}


@functools.lru_cache(maxsize=None)
def _kernel():
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    return _build.bind(_build.load("sample"), "jxl_resample",
                       [p, i, i, i, f, i, p, p, p, i, i, p, p, p, i, i, p,
                        p])


def _check(img: torch.Tensor) -> None:
    if img.dim() != 3 or img.dtype not in _DTYPES or img.shape[2] < 1:
        raise ValueError(f"img: expected (H, W, C) uint8, uint16 or "
                         f"float32, C >= 1, got {tuple(img.shape)} "
                         f"{img.dtype}")


def resize_plane_stack_plain(planes: torch.Tensor, out_h: int, out_w: int,
                             filter_id: int = 4) -> torch.Tensor:
    """(C, H, W) f32 -> (C, out_h, out_w): the two dense float32 matrix
    products of the reference (the library yardstick of S3)."""
    _c, h, w = planes.shape
    wy = torch.from_numpy(HR.resample_matrix(h, out_h, filter_id)).to(
        planes.device)
    wx = torch.from_numpy(HR.resample_matrix(w, out_w, filter_id)).to(
        planes.device)
    return torch.matmul(torch.matmul(wy, planes), wx.T)


def rescale_image_plain(img: torch.Tensor, target_w: int, target_h: int,
                        scale_mode: int = 1, filter_id: int = 4,
                        premultiplied: bool = False) -> torch.Tensor:
    """The twin of rescale_image."""
    h, w, c = img.shape
    dtype = img.dtype
    maxv = _DTYPES[dtype][1]
    f = fp.div(img.to(torch.float32), maxv)
    alpha = c in (2, 4) and not premultiplied
    if alpha:
        f = torch.cat([f[..., :-1] * f[..., -1:], f[..., -1:]], -1)
    pl = HR.plan(h, w, target_w, target_h, scale_mode)
    out = resize_plane_stack_plain(f.permute(2, 0, 1), pl.oh, pl.ow,
                                   filter_id).permute(1, 2, 0)
    out = out[pl.y0:pl.y0 + pl.ch, pl.x0:pl.x0 + pl.cw]
    if alpha:
        a = torch.clamp(out[..., -1:], 1e-6, 1.0)
        out = torch.cat([out[..., :-1] / a, out[..., -1:]], -1)
    out = torch.clamp(out, 0.0, 1.0)
    if maxv != 1.0:
        return torch.round(out * maxv).to(dtype)
    return out.contiguous()


def bands(h: int, w: int, pl: HR.Plan, filter_id: int, dev) -> tuple:
    """The kept rows' and columns' bands of a plan on `dev`: (first,
    length, weights) of the vertical pass, then of the horizontal."""
    return tuple(torch.from_numpy(a).to(dev)
                 for b in (HR.band(h, pl.oh, filter_id, pl.y0, pl.ch),
                           HR.band(w, pl.ow, filter_id, pl.x0, pl.cw))
                 for a in b)


def resample(img: torch.Tensor, pl: HR.Plan, bnd: tuple,
             premultiplied: bool = False) -> torch.Tensor:
    """S3 on a contiguous CUDA (H, W, C) image with its plan's bands
    already on the card (``bands``): one launch, nothing copied from the
    host (the entry point's scratch argument is null)."""
    h, w, c = img.shape
    code, maxv = _DTYPES[img.dtype]
    vf, vl, vw, hf, hl, hw = bnd
    out = torch.empty((pl.ch, pl.cw, c), dtype=img.dtype, device=img.device)
    if h and w:
        _build.launch(_kernel(), img.device, img.data_ptr(), code, w, c, maxv,
                      int(c in (2, 4) and not premultiplied), vf.data_ptr(),
                      vl.data_ptr(), vw.data_ptr(), vw.shape[1], pl.ch,
                      hf.data_ptr(), hl.data_ptr(), hw.data_ptr(),
                      hw.shape[1], pl.cw, None, out.data_ptr())
        rescale_image.launches += 1
    return out


def rescale_image(img: torch.Tensor, target_w: int, target_h: int,
                  scale_mode: int = 1, filter_id: int = 4,
                  premultiplied: bool = False) -> torch.Tensor:
    """(H, W, C) uint8 / uint16 / float32 -> resized per ScaleMode
    (1 FIT, 2 FILL, 3 RESIZE) with ResizeFilter `filter_id`, the same
    type; unassociated alpha (C 2 or 4, not `premultiplied`) is
    premultiplied for the filter and divided out after."""
    _check(img)
    if filter_id not in HR.KERNELS:
        raise ValueError(f"filter_id={filter_id}: expected 1..10")
    if target_w <= 0 or target_h <= 0:
        raise ValueError(f"target {target_w}x{target_h}: expected > 0")
    if img.device.type == "cpu":
        return rescale_image_plain(img, target_w, target_h, scale_mode,
                                   filter_id, premultiplied)
    img = img.contiguous()
    h, w, _c = img.shape
    pl = HR.plan(h, w, target_w, target_h, scale_mode)
    return resample(img, pl, bands(h, w, pl, filter_id, img.device),
                    premultiplied)


rescale_image.launches = 0
