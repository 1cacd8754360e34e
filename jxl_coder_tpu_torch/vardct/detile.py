"""Detile gathered 8x8 tiles into raster planes (kernel 7).

``detile(src, ny, nx, rows)`` computes
``out[c, 8*by + py, 8*bx + px] = src[rows[by*nx + bx], c*64 + 8*py + px]``
for ``src`` (N_src, 192) float32 and ``rows`` an optional int32 index of
ny*nx distinct rows (the identity when absent); ``out`` is
(3, 8*ny, 8*nx) float32.  On a CUDA tensor it launches ``jxl_detile`` of
``csrc/detile.cu``, which replaces the TPU kernel
``research/detile_probe.py`` ``v2`` (``_detile_dma_kernel``); on a CPU
tensor it runs ``detile_plain``, the probe's ``v0`` in torch.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from .. import _build


def detile_plain(src: torch.Tensor, ny: int, nx: int,
                 rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The probe's v0: gather the rows, then reshape and permute."""
    g = src[:ny * nx] if rows is None else src.index_select(0, rows.long())
    return g.reshape(ny, nx, 3, 8, 8).permute(2, 0, 3, 1, 4).reshape(
        3, 8 * ny, 8 * nx)


@functools.lru_cache(maxsize=None)
def _kernel():
    c = ctypes
    return _build.bind(_build.load("detile"), "jxl_detile",
                       [c.c_void_p, c.c_longlong, c.c_void_p, c.c_int,
                        c.c_int, c.c_void_p])


def detile(src: torch.Tensor, ny: int, nx: int,
           rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(N_src, 192) f32 tiles -> (3, 8*ny, 8*nx) f32 raster planes."""
    need = ny * nx
    if src.dtype != torch.float32 or src.dim() != 2 or src.shape[1] != 192:
        raise ValueError("src must be (N, 192) float32")
    if rows is None:
        if src.shape[0] < need:
            raise ValueError(f"src has {src.shape[0]} rows, the identity "
                             f"index needs {need}")
    elif rows.dtype != torch.int32 or rows.shape != (need,) or \
            rows.device != src.device:
        raise ValueError(f"rows must be ({need},) int32 on {src.device}")
    if src.device.type == "cpu":
        return detile_plain(src, ny, nx, rows)
    src = src.contiguous()
    if rows is not None:
        rows = rows.contiguous()
    out = torch.empty((3, 8 * ny, 8 * nx), dtype=torch.float32,
                      device=src.device)
    if src.data_ptr() % 16:
        raise ValueError("src must be 16-byte aligned")
    _build.launch(_kernel(), src.device, src.data_ptr(), src.shape[0],
                  None if rows is None else rows.data_ptr(), ny, nx,
                  out.data_ptr())
    detile.launches += 1
    return out


detile.launches = 0
