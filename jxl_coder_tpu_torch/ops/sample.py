"""The 8x box of a full decode's codes, on the device.

``decode_thumbnail`` of a Modular or upsampled frame decodes it whole,
then averages each 8 x 8 cell of the codes, edge-padded, and rounds half
to even (``jxl_coder_tpu/api.py:1062-1069,1101-1107``).  ``box_codes``
is kernel S2 of ``csrc/sample.cu``; ``box_codes_plain`` its twin.  The
sum of a cell is an integer, so both round it exactly and agree with the
reference's numpy to the code, at any channel count.  The wrapper
counts its launches in ``box_codes.launches``; on a CPU tensor it runs
the twin, on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build

BOX = 8
_DTYPES = {torch.uint8: 0, torch.uint16: 1}


@functools.lru_cache(maxsize=None)
def _kernel():
    p, i = ctypes.c_void_p, ctypes.c_int
    return _build.bind(_build.load("sample"), "jxl_box_codes",
                       [p, p, i, i, i, i])


def _check(codes: torch.Tensor) -> None:
    if codes.dim() != 3 or codes.dtype not in _DTYPES or \
            codes.shape[2] < 1:
        raise ValueError(f"codes: expected (H, W, C) uint8 or uint16, C "
                         f">= 1, got {tuple(codes.shape)} {codes.dtype}")


def round_half_even(s: torch.Tensor, shift: int) -> torch.Tensor:
    """rint(s / 2^shift) of non-negative integers, half to even."""
    q = s >> shift
    r = s & ((1 << shift) - 1)
    half = 1 << (shift - 1)
    return q + ((r > half) | ((r == half) & ((q & 1) == 1))).to(q.dtype)


def box_codes_plain(codes: torch.Tensor) -> torch.Tensor:
    """The twin of box_codes."""
    h, w, c = codes.shape
    ho, wo = -(-h // BOX), -(-w // BOX)
    iy = torch.clamp(torch.arange(ho * BOX, device=codes.device), max=h - 1)
    ix = torch.clamp(torch.arange(wo * BOX, device=codes.device), max=w - 1)
    pad = codes.to(torch.int64)[iy][:, ix]
    s = pad.reshape(ho, BOX, wo, BOX, c).sum(dim=(1, 3))
    return round_half_even(s, 6).to(codes.dtype)


def box_codes(codes: torch.Tensor) -> torch.Tensor:
    """(H, W, C) uint8 / uint16 codes -> (ceil(H / 8), ceil(W / 8), C) of
    the same type: each cell's edge-padded mean, rounded half to even."""
    _check(codes)
    if codes.device.type == "cpu":
        return box_codes_plain(codes)
    codes = codes.contiguous()
    h, w, c = codes.shape
    out = torch.empty((-(-h // BOX), -(-w // BOX), c), dtype=codes.dtype,
                      device=codes.device)
    if h and w:
        _build.launch(_kernel(), codes.device, codes.data_ptr(),
                      out.data_ptr(), _DTYPES[codes.dtype], h, w, c)
        box_codes.launches += 1
    return out


box_codes.launches = 0
