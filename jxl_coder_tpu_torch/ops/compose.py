"""Frame composition on the device: kernel A10 (``csrc/compose.cu``).

An animation frame that is cropped, or blended onto what came before,
is composed onto a canvas as ``jxl_coder_tpu.api._compose_frame``
(``api.py:821-961``) does it: the frame's window clipped to the canvas
(``window``, on the host), then each pixel of the window blended by the
frame header's blending (``blend_params``): the colour by
``blending_info``, each extra channel by its ``ec_blending_info``, in one
of REPLACE, ADD, BLEND, ALPHA_WEIGHTED_ADD and MUL, with clamp and
associated alpha.  ``compose`` updates the canvas in place with one
launch; its twin ``compose_plain`` repeats the reference's numpy
arithmetic in torch float64, channel plane by channel plane (dividing
by maxv with ``fp.div``: on CUDA, torch divides by a Python number as a
product by its reciprocal, a rounding off the reference's).  Both give
the reference's codes exactly, at any number of extra channels: one
launch up to ``MAX_EXTRA`` of them, else one per group of ``MAX_EXTRA``
(the colour with the first), after a copy of the window's canvas values
that each reads the background alpha from.  The wrapper counts its
launches in ``compose.launches``; on a CPU tensor it runs the twin, on a
CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import _build
from ..host.api import InvalidJXLError
from . import fp

MAX_EXTRA = 8           # compose.cuh's kMaxExtra: extra channels a launch
_DTYPES = {torch.uint8: (0, 255.0), torch.uint16: (1, 65535.0)}
REPLACE, ADD, BLEND, ALPHA_WEIGHTED_ADD, MUL = range(5)
_NEEDS_ALPHA = (BLEND, ALPHA_WEIGHTED_ADD)


@functools.lru_cache(maxsize=None)
def _kernel():
    p, i = ctypes.c_void_p, ctypes.c_int
    return _build.bind(_build.load("compose"), "jxl_compose",
                       [p, i, i, p, i, p, i, i, i, i, i, i, p,
                        ctypes.c_double, i])


class Window(NamedTuple):
    """The frame's pixels from (sx, sy) land on the canvas at (dx, dy);
    cw x ch of them."""
    sx: int
    sy: int
    dx: int
    dy: int
    cw: int
    ch: int


def window(canvas_hw, frame_hw, x0: int, y0: int) -> Optional[Window]:
    """The frame's crop offset clipped against the canvas
    (``api.py:830-838``); None when nothing of the frame lands on it."""
    sx, sy = max(0, -x0), max(0, -y0)
    dx, dy = max(0, x0), max(0, y0)
    cw = min(frame_hw[1] - sx, canvas_hw[1] - dx)
    ch = min(frame_hw[0] - sy, canvas_hw[0] - dy)
    if cw <= 0 or ch <= 0:
        return None
    return Window(sx, sy, dx, dy, cw, ch)


def blend_params(fh, m, nch: int) -> np.ndarray:
    """The frame header's blending for pixels of `nch` channels (m: the
    image metadata) as compose's int32 parameters: nch, ncolor, the
    extra channels' count, the colour's (mode, alpha channel, clamp), then
    each extra channel's (mode, alpha channel, clamp, alpha_associated).
    An unknown mode, or a mode that reads an alpha channel the image does
    not have, raises InvalidJXLError."""
    ecs = m.extra_channels
    n_ec = len(ecs)
    ncolor = 1 if nch - n_ec == 1 else 3
    if nch != ncolor + n_ec:
        raise InvalidJXLError(f"a frame of {nch} channels in an image with "
                              f"{n_ec} extra channels")

    def blend(bi, what: str):
        if bi.mode not in range(5):
            raise InvalidJXLError(f"{what} blend mode {bi.mode} not "
                                  f"supported")
        if bi.mode in _NEEDS_ALPHA and not 0 <= bi.alpha_channel < n_ec:
            raise InvalidJXLError(f"{what} blend mode {bi.mode} reads alpha "
                                  f"channel {bi.alpha_channel} of {n_ec}")
        return [bi.mode, bi.alpha_channel, int(bi.clamp)]

    out = [nch, ncolor, n_ec] + blend(fh.blending_info, "colour")
    for i, bi in enumerate(fh.ec_blending_info[:n_ec]):
        out += blend(bi, "extra-channel") + [int(ecs[i].alpha_associated)]
    return np.asarray(out, np.int32)


def _check(canvas: torch.Tensor, src: torch.Tensor, params: np.ndarray
           ) -> None:
    if canvas.dtype not in _DTYPES or src.dtype != canvas.dtype or \
            canvas.dim() != 3 or src.dim() != 3 or \
            canvas.shape[2] != src.shape[2] or \
            canvas.shape[2] != int(params[0]) or \
            src.device != canvas.device:
        raise ValueError(f"compose: canvas {tuple(canvas.shape)} "
                         f"{canvas.dtype} and frame {tuple(src.shape)} "
                         f"{src.dtype} on {src.device}: expected (H, W, "
                         f"{int(params[0])}) uint8 or uint16 on one device")


def compose_plain(canvas: torch.Tensor, src: torch.Tensor, win: Window,
                  params: np.ndarray) -> None:
    """The twin of compose: the reference's numpy composition in torch
    float64, in place on canvas."""
    _check(canvas, src, params)
    nch, ncolor, n_ec = (int(v) for v in params[:3])
    maxv = _DTYPES[canvas.dtype][1]
    sx, sy, dx, dy, cw, ch = win
    dst = canvas[dy:dy + ch, dx:dx + cw]
    s = src[sy:sy + ch, sx:sx + cw].to(torch.float64)
    d = dst.to(torch.float64)            # the canvas as the blend goes
    ba0 = fp.div(d[..., ncolor:], maxv)  # the background alpha before it

    def code(v):
        return torch.clamp(torch.round(v), 0.0, maxv)

    def fa_of(alpha, clamp):
        fa = fp.div(s[..., ncolor + alpha], maxv)
        return torch.clamp(fa, 0.0, 1.0) if clamp else fa

    def assoc(alpha):
        return bool(params[9 + 4 * alpha])

    mode, alpha, clamp = (int(v) for v in params[3:6])
    cs = slice(0, ncolor)
    if mode == REPLACE:
        d[..., cs] = s[..., cs]
    elif mode == ADD:
        d[..., cs] = code(s[..., cs] + d[..., cs])
    elif mode == BLEND:
        fa = fa_of(alpha, clamp)
        ba = ba0[..., alpha]
        na = fa + ba * (1.0 - fa)
        if assoc(alpha):
            out = s[..., cs] + d[..., cs] * (1.0 - fa)[..., None]
        else:
            safe = torch.where(na > 0, na, torch.ones_like(na))
            out = torch.where(
                na[..., None] > 0,
                (s[..., cs] * fa[..., None]
                 + d[..., cs] * (ba * (1.0 - fa))[..., None]) / safe[..., None],
                torch.zeros_like(s[..., cs]))
        d[..., ncolor + alpha] = code(na * maxv)
        d[..., cs] = code(out)
    elif mode == ALPHA_WEIGHTED_ADD:
        d[..., cs] = code(d[..., cs] + s[..., cs] * fa_of(alpha, clamp)[
            ..., None])
    else:
        sc = torch.clamp(s[..., cs], 0.0, maxv) if clamp else s[..., cs]
        d[..., cs] = code(fp.div(sc * d[..., cs], maxv))
    for i in range(n_ec):
        e = ncolor + i
        m, a, c = (int(v) for v in params[6 + 4 * i:9 + 4 * i])
        if mode == BLEND and alpha == i and m == BLEND:
            continue        # written by the colour's blend above
        if m == REPLACE:
            d[..., e] = s[..., e]
        elif m == ADD:
            d[..., e] = code(s[..., e] + d[..., e])
        elif m == BLEND:
            fa = fa_of(a, c)
            ba = ba0[..., a]
            if a == i:
                d[..., e] = code((fa + ba * (1.0 - fa)) * maxv)
            elif assoc(a):
                d[..., e] = code(s[..., e] + d[..., e] * (1.0 - fa))
            else:
                na = fa + ba * (1.0 - fa)
                safe = torch.where(na > 0, na, torch.ones_like(na))
                d[..., e] = code(torch.where(
                    na > 0, (s[..., e] * fa + d[..., e] * ba * (1.0 - fa))
                    / safe, torch.zeros_like(na)))
        elif m == ALPHA_WEIGHTED_ADD:
            d[..., e] = code(d[..., e] + s[..., e] * fa_of(a, c))
        else:
            se = torch.clamp(s[..., e], 0.0, maxv) if c else s[..., e]
            d[..., e] = code(fp.div(se * d[..., e], maxv))
    dst.copy_(d.to(torch.int32).to(canvas.dtype))


def compose(canvas: torch.Tensor, src: torch.Tensor, win: Window,
            params: np.ndarray) -> None:
    """Blend src's window onto canvas in place (canvas and src: (H, W,
    C) uint8 or uint16 on one device, the canvas contiguous; params from
    blend_params): one launch, or ceil(extra channels / MAX_EXTRA)."""
    _check(canvas, src, params)
    if canvas.device.type == "cpu":
        compose_plain(canvas, src, win, params)
        return
    if not canvas.is_contiguous():
        raise ValueError("compose: the canvas must be contiguous (it is "
                         "updated in place)")
    src = src.contiguous()
    params = np.ascontiguousarray(params, np.int32)
    code, maxv = _DTYPES[canvas.dtype]
    n_ec = int(params[2])
    bg = None
    if n_ec > MAX_EXTRA:
        bg = canvas[win.dy:win.dy + win.ch, win.dx:win.dx + win.cw].clone(
            memory_format=torch.contiguous_format)
    for g0 in range(0, max(n_ec, 1), MAX_EXTRA):
        _build.launch(_kernel(), canvas.device, canvas.data_ptr(), code,
                      canvas.shape[1], src.data_ptr(), src.shape[1],
                      None if bg is None else bg.data_ptr(), win.sx, win.sy,
                      win.dx, win.dy, win.cw, win.ch, params.ctypes.data,
                      maxv, g0)
        compose.launches += 1


compose.launches = 0
