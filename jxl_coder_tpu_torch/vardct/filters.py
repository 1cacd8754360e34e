"""Restoration filters and the sRGB output, one tile pass (kernel 2).

``restore_and_output`` runs gaborish -> EPF0 (epf_iters 3) -> EPF1 ->
EPF2 (epf_iters >= 2) -> XYB -> sRGB8/16 on (3, H, W) XYB planes at
the true image size and returns interleaved (H, W, 3) codes (or, for
checks, the filtered f32 planes).  On a CUDA tensor it launches
``chain_kernel`` of ``csrc/filters.cu`` (which replaces the TPU kernel
``jxl_coder_tpu/vardct/filters_pallas.py`` ``fused_real_filters3``; see
the source note there): one launch at epf_iters <= 2, two at epf_iters
3 (``epf0_pass``, then the rest).  On a CPU tensor it runs the plain
PyTorch chain below (``filter_chain_plain`` and
``color.xyb_to_srgb_plain``), which mirrors the jnp chain
(``tpu_real.gaborish_device`` / ``epf_device``,
``tpu_full._epf2_device``) operation for operation.

A ``Window`` makes a launch write rows [r0, r0 + rows) of an image H
rows tall from a slab of its rows (a shard of the multi-device decode,
``parallel/groups.py``): borders fold at the image's rows 0 and H - 1
only, so the window's rows equal the same rows of the whole-image
launch; the twin runs the plain chain on the slab and crops.

The constants come from ``host/vardct/dec_real.py``.  Input planes may
be a cropped view (row stride larger than the width).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from .. import _build
from ..host.vardct.dec_real import (EPF1_INV_SCALE, EPF_CHANNEL_SCALE,
                                    EPF_SIGMA_GATE, EPF_SIGMA_PER,
                                    KINV_SIGMA)
from . import color

BORDER_MUL = np.float32(2.0 / 3.0)
# rows the chain reads past an output row: gaborish 1, EPF0 3, EPF1 2,
# EPF2 1 (7), rounded up to a block row
HALO = 8
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
    c = torch.full_like(sigma, float(slope_constant(slope_scale)))
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


def filter_chain_plain(x: torch.Tensor, sigma: torch.Tensor, gab: bool,
                       epf_iters: int, gabw, pass0_scale: float,
                       pass2_scale: float) -> torch.Tensor:
    """gaborish -> EPF0 (epf_iters 3) -> EPF1 -> EPF2 (epf_iters >= 2)
    on (3, H, W) planes; sigma: per-block EPF sigma (sigma_map).
    Returns the input unchanged when every filter is off."""
    if gab:
        x = gaborish_plain(x, gabw)
    if epf_iters >= 1:
        if epf_iters >= 3:
            x = epf_plain(x, epf_inv(sigma, pass0_scale), 0)
        x = epf_plain(x, epf_inv(sigma, 1.0), 1)
        if epf_iters >= 2:
            x = epf_plain(x, epf_inv(sigma, pass2_scale), 2)
    return x


OUT_KINDS = {"f32": 0, "u8": 1, "u16": 2}


class Window(NamedTuple):
    """A launch on a slab of an image's rows: the planes' row 0 is the
    image's row `lo` and the sigma map's row 0 its block row `sig_lo`
    (rows outside the image are never read); the launch writes the
    image's rows [r0, r0 + rows) of H.  The slab must hold HALO rows past
    each end of the window, or reach the image's edge."""
    H: int
    lo: int
    sig_lo: int
    r0: int
    rows: int


def _window_rows(x: torch.Tensor, win: Window) -> tuple:
    """The rows [lo, hi) of the slab a window reads, as a view of x, and
    lo, hi: HALO rows past the window, cut at the image's edges."""
    if not (0 <= win.r0 and win.rows >= 0 and win.r0 + win.rows <= win.H):
        raise ValueError(f"{win}: rows outside the image")
    lo = max(0, win.r0 - HALO)
    hi = min(win.H, win.r0 + win.rows + HALO)
    if win.lo > lo or win.lo + x.shape[1] < hi:
        raise ValueError(f"{win}: the slab of {x.shape[1]} rows does not "
                         f"hold the image's rows [{lo}, {hi})")
    return x[:, lo - win.lo:hi - win.lo], lo, hi


def _window_sigma(sigma, win: Window, lo: int, hi: int) -> None:
    if sigma is not None and (win.sig_lo > lo // 8 or win.sig_lo
                              + sigma.shape[0] <= (hi - 1) // 8):
        raise ValueError(f"{win}: the sigma map of {sigma.shape[0]} block "
                         f"rows does not cover the image's rows [{lo}, {hi})")


def epf0_pass_plain(x: torch.Tensor, sigma: torch.Tensor, gab: bool, gabw,
                    pass0_scale: float) -> torch.Tensor:
    if gab:
        x = gaborish_plain(x, gabw)
    return epf_plain(x, epf_inv(sigma, pass0_scale), 0)


def restore_and_output_plain(x: torch.Tensor, sigma, gab: bool,
                             epf_iters: int, gabw, pass0_scale: float,
                             pass2_scale: float, out: str = "u8",
                             window: Window = None) -> torch.Tensor:
    if window is not None:
        # the chain on the slab as an image of its own: its Mirror() at a
        # cut inside the image reaches 7 rows, short of the window; rows
        # copied above a slab that starts inside a block row keep the
        # block grid where the image has it
        x, lo, hi = _window_rows(x, window)
        _window_sigma(sigma if epf_iters else None, window, lo, hi)
        k = lo % 8
        x = torch.cat([x[:, :1].expand(-1, k, -1), x], 1)
        if epf_iters:
            sigma = sigma[(lo - k) // 8 - window.sig_lo:]
        res = restore_and_output_plain(x, sigma, gab, epf_iters, gabw,
                                       pass0_scale, pass2_scale, out)
        r = window.r0 - lo + k
        return res[:, r:r + window.rows] if out == "f32" else \
            res[r:r + window.rows]
    x = filter_chain_plain(x, sigma, gab, epf_iters, gabw, pass0_scale,
                           pass2_scale)
    return x if out == "f32" else color.xyb_to_srgb_plain(x, out == "u16")


def slope_constant(scale: float) -> np.float32:
    """c of a pass's slope c / sigma, rounded once to f32 as epf_inv
    rounds it."""
    return np.float32(KINV_SIGMA * EPF1_INV_SCALE * scale)


def kernel_consts(gabw, scale_a: float, scale_2: float) -> np.ndarray:
    """The 16 floats the kernel takes: gaborish w1[3], w2[3], 1 / norm[3],
    the channel scales, the border multiplier, the sigma gate and the
    slope constants of pass A (EPF0 or EPF1) and of EPF2."""
    w = [np.float32(g) for g in gabw]
    return np.asarray(
        w[0::2] + w[1::2]
        + [np.float32(1.0) / np.float32(_gab_norm(gabw[2 * c], gabw[2 * c + 1]))
           for c in range(3)]
        + list(EPF_CHANNEL_SCALE)
        + [BORDER_MUL, EPF_SIGMA_GATE, slope_constant(scale_a),
           slope_constant(scale_2)], np.float32)


@functools.lru_cache(maxsize=64)
def _launch_consts(gabw: tuple, scale_a: float, scale_2: float) -> np.ndarray:
    """kernel_consts, built once per frame configuration: building them
    costs more host time than the launch itself."""
    return kernel_consts(gabw, scale_a, scale_2)


_c = ctypes


@functools.lru_cache(maxsize=None)
def _kernel():
    return _build.bind(
        _build.load("filters"), "jxl_restore_window",
        [_c.c_void_p, _c.c_longlong] + [_c.c_int] * 7
        + [_c.c_void_p] + [_c.c_int] * 3 + [_c.c_void_p] + [_c.c_int] * 4
        + [_c.c_void_p] * 3)


def _launch(x: torch.Tensor, sigma, gab: bool, pass_a: int, epf2: bool,
            out: str, gabw, scale_a: float, scale_2: float,
            rows: tuple) -> torch.Tensor:
    """One chain_kernel launch on CUDA planes x: [gaborish] -> [pass A:
    EPF0 or EPF1] -> [EPF2] -> out; rows = (H, lo, sig_lo, r0, n): x
    holds the image's rows [lo, lo + x.shape[1]), the sigma map its block
    rows from sig_lo, and the output is its rows [r0, r0 + n)."""
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype != torch.float32 or x.dim() != 3 or x.shape[0] != 3:
        raise ValueError("expected (3, H, W) float32 planes")
    if out not in OUT_KINDS:
        raise ValueError(f"out must be one of {tuple(OUT_KINDS)}")
    if x.stride(2) != 1:
        x = x.contiguous()
    _, n_in, W = x.shape
    H, lo, sig_lo, r0, n = rows
    sig_ptr, sig_rows, sig_cols = None, 0, 0
    if pass_a >= 0:
        need = (lo + n_in + 7) // 8 - sig_lo
        if sigma is None or sigma.dtype != torch.float32 or \
                sigma.device != x.device or sigma.dim() != 2 or \
                sigma.shape[0] < need or sigma.shape[1] < (W + 7) // 8:
            raise ValueError(f"sigma must be float32 on {x.device}, at "
                             f"least {(need, (W + 7) // 8)} blocks")
        sigma = sigma.contiguous()
        sig_ptr, (sig_rows, sig_cols) = sigma.data_ptr(), sigma.shape
    if out == "f32":
        res = torch.empty((3, n, W), dtype=torch.float32, device=x.device)
    else:
        res = torch.empty((n, W, 3), device=x.device, dtype=torch.uint16
                          if out == "u16" else torch.uint8)
    consts = _launch_consts(tuple(gabw), scale_a, scale_2)
    # the constants are host arrays, copied into the launch parameters
    _build.launch(_kernel(), x.device, x.data_ptr(), x.stride(0),
                  x.stride(1), H, W, lo, lo + n_in, r0, n, sig_ptr, sig_lo,
                  sig_rows, sig_cols, res.data_ptr(), int(gab), int(pass_a),
                  int(epf2), OUT_KINDS[out], consts.ctypes.data,
                  color._CONSTS.ctypes.data, color._MUL.ctypes.data)
    return res


def epf0_pass(x: torch.Tensor, sigma: torch.Tensor, gab: bool, gabw,
              pass0_scale: float) -> torch.Tensor:
    """[gaborish ->] EPF pass 0 -> (3, H, W) float32: the first of the
    two launches at epf_iters 3."""
    if x.device.type == "cpu":
        return epf0_pass_plain(x, sigma, gab, gabw, pass0_scale)
    H = x.shape[1]
    res = _launch(x, sigma, gab, 0, False, "f32", gabw, pass0_scale, 1.0,
                  (H, 0, 0, 0, H))
    epf0_pass.launches += 1
    return res


def restore_and_output(x: torch.Tensor, sigma, gab: bool, epf_iters: int,
                       gabw, pass0_scale: float, pass2_scale: float,
                       out: str = "u8", window: Window = None
                       ) -> torch.Tensor:
    """(3, H, W) float32 XYB -> the filter chain -> (H, W, 3) uint8
    (out "u8") or uint16 ("u16") sRGB, or the filtered (3, H, W) float32
    planes ("f32").  sigma: the per-block EPF sigma map (sigma_map), None
    when epf_iters is 0; gabw: (x1, x2, y1, y2, b1, b2).  With a window,
    x and sigma are a slab of the image's rows and block rows and the
    result the window's rows; a caller's window also counts in
    ``window_launches``."""
    if epf_iters not in (0, 1, 2, 3):
        raise ValueError(f"epf_iters {epf_iters}: expected 0-3")
    if x.device.type == "cpu":
        return restore_and_output_plain(x, sigma, gab, epf_iters, gabw,
                                        pass0_scale, pass2_scale, out,
                                        window)
    win = window or Window(x.shape[1], 0, 0, 0, x.shape[1])
    x, lo, hi = _window_rows(x, win)
    _window_sigma(sigma if epf_iters else None, win, lo, hi)
    H, sig_lo, r0, n = win.H, win.sig_lo, win.r0, win.rows
    if epf_iters >= 3:
        # EPF0 over the rows EPF1 and EPF2 read (3 past the window)
        e0, e1 = max(0, r0 - 4), min(H, r0 + n + 4)
        x = _launch(x, sigma, gab, 0, False, "f32", gabw, pass0_scale, 1.0,
                    (H, lo, sig_lo, e0, e1 - e0))
        epf0_pass.launches += 1
        epf0_pass.window_launches += window is not None
        lo, gab = e0, False
    res = _launch(x, sigma, gab, 1 if epf_iters >= 1 else -1,
                  epf_iters >= 2, out, gabw, 1.0, pass2_scale,
                  (H, lo, sig_lo, r0, n))
    restore_and_output.launches += 1
    restore_and_output.window_launches += window is not None
    return res


epf0_pass.launches = epf0_pass.window_launches = 0
restore_and_output.launches = restore_and_output.window_launches = 0
