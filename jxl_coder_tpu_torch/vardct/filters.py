"""Restoration filters: gaborish and EPF passes 0-2 (kernel 2).

``filter_chain`` runs gaborish -> EPF0 (epf_iters 3) -> EPF1 -> EPF2
(epf_iters >= 2) on (3, H, W) XYB planes at the true image size.  On a
CUDA tensor each stage launches a kernel of ``csrc/filters.cu`` (which
replaces the TPU kernel ``jxl_coder_tpu/vardct/filters_pallas.py``
``fused_real_filters3``; see the source note there); on a CPU tensor
it runs the plain PyTorch twins below, which mirror the jnp chain
(``tpu_real.gaborish_device`` / ``epf_device``,
``tpu_full._epf2_device``) operation for operation.

The constants come from ``host/vardct/dec_real.py``.  Input
planes may be a cropped view (row stride larger than the width);
outputs are contiguous (3, H, W) float32.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import _build
from ..host.vardct.dec_real import (EPF1_INV_SCALE, EPF_CHANNEL_SCALE,
                                    EPF_SIGMA_GATE, EPF_SIGMA_PER,
                                    KINV_SIGMA)

BORDER_MUL = np.float32(2.0 / 3.0)
_PLUS4 = ((0, 1), (0, -1), (1, 0), (-1, 0))
_DIAMOND12 = _PLUS4 + ((1, 1), (1, -1), (-1, 1), (-1, -1),
                       (0, 2), (0, -2), (2, 0), (-2, 0))
_TAPS = ((0, 0), (0, 1), (0, -1), (1, 0), (-1, 0))


def sigma_map(sharp: torch.Tensor, qf: torch.Tensor,
              igs: float) -> torch.Tensor:
    """Per-block EPF sigma (tpu_full.py:780-785)."""
    return (EPF_SIGMA_PER * sharp.to(torch.float32) * igs
            / torch.clamp_min(qf.to(torch.float32), 1.0))


def epf_inv(sigma: torch.Tensor, slope_scale: float) -> torch.Tensor:
    """Per-block EPF slope: KINV * EPF1_INV_SCALE * slope / sigma where
    sigma >= EPF_SIGMA_GATE (negative), 0 elsewhere."""
    c = torch.full_like(sigma, float(np.float32(
        KINV_SIGMA * EPF1_INV_SCALE * slope_scale)))
    inv = c / torch.clamp_min(sigma, 1e-9)
    return torch.where(sigma >= EPF_SIGMA_GATE, inv,
                       torch.zeros_like(inv)).contiguous()


def _mirror_index(n: int, r: int, device) -> torch.Tensor:
    """Indices -r .. n+r-1 folded by libjxl Mirror() (numpy
    "symmetric")."""
    i = np.arange(-r, n + r)
    while ((i < 0) | (i >= n)).any():
        i = np.where(i < 0, -i - 1, np.where(i >= n, 2 * n - 1 - i, i))
    return torch.from_numpy(i).to(device)


def _gab_norm(w1: float, w2: float) -> float:
    w1, w2 = np.float32(w1), np.float32(w2)
    return float(np.float32(1.0 + 4.0 * (w1 + w2)))


def gaborish_plain(x: torch.Tensor, gabw) -> torch.Tensor:
    _, H, W = x.shape
    iy = _mirror_index(H, 1, x.device)
    ix = _mirror_index(W, 1, x.device)
    out = []
    for c in range(3):
        w1, w2 = float(np.float32(gabw[2 * c])), float(np.float32(gabw[2 * c + 1]))
        p = x[c][iy][:, ix]
        v = (p[1:-1, 1:-1]
             + w1 * (p[:-2, 1:-1] + p[2:, 1:-1] + p[1:-1, :-2] + p[1:-1, 2:])
             + w2 * (p[:-2, :-2] + p[:-2, 2:] + p[2:, :-2] + p[2:, 2:]))
        out.append(v / _gab_norm(gabw[2 * c], gabw[2 * c + 1]))
    return torch.stack(out)


def _border(H: int, W: int, device) -> torch.Tensor:
    by = torch.arange(H, device=device) % 8
    bx = torch.arange(W, device=device) % 8
    return (((by == 0) | (by == 7))[:, None]
            | ((bx == 0) | (bx == 7))[None, :])


def epf_plain(x: torch.Tensor, inv: torch.Tensor, epf_pass: int
              ) -> torch.Tensor:
    """One EPF pass on (3, H, W); inv: per-block slope from epf_inv."""
    _, H, W = x.shape
    dev = x.device
    inv_px = inv.repeat_interleave(8, 0).repeat_interleave(8, 1)[:H, :W]
    active = inv_px < 0
    border = _border(H, W, dev)
    cs = [float(np.float32(s)) for s in EPF_CHANNEL_SCALE]
    wsum = torch.ones((H, W), dtype=torch.float32, device=dev)
    acc = [x[c] for c in range(3)]
    if epf_pass == 2:
        # pointwise SAD on edge-replicated planes, 2/3 applied to the SAD
        iy = torch.arange(-1, H + 1, device=dev).clamp(0, H - 1)
        ix = torch.arange(-1, W + 1, device=dev).clamp(0, W - 1)
        pad = x[:, iy][:, :, ix]
        mul = torch.where(border, torch.full_like(inv_px, float(BORDER_MUL)),
                          torch.ones_like(inv_px))
        for dy, dx in _PLUS4:
            nb = pad[:, 1 + dy:1 + dy + H, 1 + dx:1 + dx + W]
            sad = torch.zeros((H, W), dtype=torch.float32, device=dev)
            for c in range(3):
                sad = sad + cs[c] * (x[c] - nb[c]).abs()
            w = torch.clamp_min(1.0 + sad * mul * inv_px, 0.0)
            wsum = wsum + w
            acc = [acc[c] + w * nb[c] for c in range(3)]
    else:
        offs = _DIAMOND12 if epf_pass == 0 else _PLUS4
        R = 3 if epf_pass == 0 else 2
        pad = x[:, _mirror_index(H, R, dev)][:, :, _mirror_index(W, R, dev)]

        def sl(c, dy, dx):
            return pad[c, R + dy:R + dy + H, R + dx:R + dx + W]

        invb = torch.where(border, inv_px * float(BORDER_MUL), inv_px)
        for dy, dx in offs:
            sad = torch.zeros((H, W), dtype=torch.float32, device=dev)
            for c in range(3):
                for ty, tx in _TAPS:
                    sad = sad + cs[c] * (sl(c, ty, tx)
                                         - sl(c, dy + ty, dx + tx)).abs()
            w = torch.clamp_min(1.0 + sad * invb, 0.0)
            wsum = wsum + w
            acc = [acc[c] + w * sl(c, dy, dx) for c in range(3)]
    return torch.stack([torch.where(active, acc[c] / wsum, x[c])
                        for c in range(3)])


def _plane_args(x: torch.Tensor):
    if x.dtype != torch.float32 or x.dim() != 3 or x.shape[0] != 3:
        raise ValueError("expected (3, H, W) float32 planes")
    if x.stride(2) != 1:
        x = x.contiguous()
    return x, x.stride(0), x.stride(1)


_c = ctypes


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("filters")
    return dict(
        gab=_build.bind(lib, "jxl_gaborish",
                        [_c.c_void_p, _c.c_longlong, _c.c_int, _c.c_void_p,
                         _c.c_int, _c.c_int] + [_c.c_float] * 9),
        epf=_build.bind(lib, "jxl_epf",
                        [_c.c_int, _c.c_void_p, _c.c_longlong, _c.c_int,
                         _c.c_void_p, _c.c_int, _c.c_int, _c.c_void_p,
                         _c.c_int] + [_c.c_float] * 4))


def gaborish(x: torch.Tensor, gabw) -> torch.Tensor:
    """3x3 gaborish with per-channel weights gabw = (x1, x2, y1, y2, b1,
    b2), Mirror borders."""
    if x.device.type == "cpu":
        return gaborish_plain(x, gabw)
    x, ps, rs = _plane_args(x)
    _, H, W = x.shape
    out = torch.empty((3, H, W), dtype=torch.float32, device=x.device)
    w = [float(np.float32(g)) for g in gabw]
    norms = [_gab_norm(gabw[2 * c], gabw[2 * c + 1]) for c in range(3)]
    _build.launch(_lib()["gab"], x.device, x.data_ptr(), ps, rs,
                  out.data_ptr(), H, W, *w, *norms)
    gaborish.launches += 1
    return out


def epf(x: torch.Tensor, inv: torch.Tensor, epf_pass: int) -> torch.Tensor:
    """EPF pass 0, 1 or 2 with per-block slope `inv` (epf_inv)."""
    if x.device.type == "cpu":
        return epf_plain(x, inv, epf_pass)
    x, ps, rs = _plane_args(x)
    _, H, W = x.shape
    if epf_pass not in (0, 1, 2):
        raise ValueError(f"EPF pass {epf_pass}: expected 0, 1 or 2")
    if inv.dtype != torch.float32 or inv.device != x.device or \
            inv.dim() != 2 or inv.shape[0] < (H + 7) // 8 or \
            inv.shape[1] < (W + 7) // 8:
        raise ValueError(f"inv must be float32 on {x.device}, at least "
                         f"{((H + 7) // 8, (W + 7) // 8)} blocks")
    inv = inv.contiguous()
    out = torch.empty((3, H, W), dtype=torch.float32, device=x.device)
    cs = [float(np.float32(s)) for s in EPF_CHANNEL_SCALE]
    _build.launch(_lib()["epf"], x.device, int(epf_pass), x.data_ptr(), ps,
                  rs, out.data_ptr(), H, W, inv.data_ptr(), inv.shape[1],
                  *cs, float(BORDER_MUL))
    epf.launches += 1
    return out


gaborish.launches = 0
epf.launches = 0


def filter_chain(x: torch.Tensor, sigma: torch.Tensor, gab: bool,
                 epf_iters: int, gabw, pass0_scale: float,
                 pass2_scale: float) -> torch.Tensor:
    """gaborish -> EPF0 (epf_iters 3) -> EPF1 -> EPF2 (epf_iters >= 2)
    on (3, H, W) planes; sigma: per-block EPF sigma (sigma_map).
    Returns the input unchanged when every filter is off."""
    if gab:
        x = gaborish(x, gabw)
    if epf_iters >= 1:
        if epf_iters >= 3:
            x = epf(x, epf_inv(sigma, pass0_scale), 0)
        x = epf(x, epf_inv(sigma, 1.0), 1)
        if epf_iters >= 2:
            x = epf(x, epf_inv(sigma, pass2_scale), 2)
    return x
