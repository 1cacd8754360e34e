"""The VarDCT post stages on the device: the patch and spline overlay,
noise, upsampling and the output encoding, then a frame's extra channels.

``PostConfig.of`` is the counterpart of ``dec_real._device_post_config``
(``jxl_coder_tpu/vardct/dec_real.py:1063-1125``): the frame's overlay
(its patches and spline points with their tile lists,
``overlay.Overlay``), its noise lut, its upsampling factor and (n, n, 5, 5)
kernels, and its output spec, ``("srgb",)``, ``("gamma", g)`` or
``("enc", trc, gamut, intensity_target, luma)``.  ``PostStages`` is the
tail of ``fn_post`` (``jxl_coder_tpu/vardct/tpu_full.py:829-878``), in its
order: the overlay (``overlay.py``'s kernels A8 and A9), noise, then
upsampling, then the output encoding, on the filtered XYB planes at the
true image size (``PostStages.xyb``, the overlay and the noise, is an LF
or reference frame's output); ``extra_channels`` is the counterpart of
the host's
extra-channel stack (``dec_real.py:2006-2040``), on the device.

Four kernels of ``csrc/post.cu``, each with its plain PyTorch twin here
(the twins run on a CPU tensor, the kernels on a CUDA one, and a CUDA
tensor never takes a twin):
- ``add_noise`` (A5; ``tpu_full._conv_subbox_device`` ``:606``,
  ``_noise_strength_device`` ``:619`` and the combine at ``:841-855``):
  X/Y/B += k0 * (red -+ green), in place;
- ``upsample`` (A6; ``tpu_full._upsample_plane_device`` ``:632``): each
  output pixel the sum of its phase's 25 weights times its 5x5 mirrored
  source window, clamped to the window's [min, max];
- ``encode_output`` (A7; ``tpu_full._encode_output_device`` ``:676`` with
  ``_xyb_to_linear_device`` ``:649`` and ``_quantize_device`` ``:669``):
  XYB -> linear -> [3x3 gamut] -> sRGB, gamma, PQ, HLG with the inverse
  OOTF or a named TRC -> codes.  Its "srgb" case is kernel 2's output
  step, so its codes equal kernel 2's; its "ycbcr" case (a JPEG
  recompression frame, ``tpu_full.py:685-690``) is BT.601 of the (Cb, Y,
  Cr) planes, Y + 128 / 255, in f32;
- ``encode_output_down`` (S1; the ``down`` stage of ``fn_post``,
  ``tpu_full.py:862-876``, then A7): A7's arithmetic with each down x
  down cell of the planes averaged first (edge-padded), so a
  quarter-scale decode writes 1/16 of the codes.
Each wrapper counts its launches in ``.launches``.

The f32 twins keep the kernels' operation order (sums in order, one
rounding per operation, divisions by a tensor, ``ops/fp.py``), so the
noise and the upsampling agree with their kernels to the last bit or
nearly; the transfer functions' pow, log and exp are the libraries'
(CUDA's powf / logf / expf in the kernel, torch's in the twin).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import threading
from typing import List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .. import _build
from ..host.ops import color as HC
from ..host.ops.upsample import _kernels as upsample_kernels
from ..host.vardct.dec_real import _is_srgb_output, upsample_weights
from ..host.vardct.noise import NOISE_K0, noise_planes
from ..ops import fp
from . import color
from . import overlay as OV
from .filters import _mirror_index

__all__ = ["PostConfig", "PostStages", "output_spec", "noise_random",
           "add_noise", "add_noise_plain", "upsample", "upsample_plain",
           "kernels_for", "upsample_ints", "encode_output",
           "encode_output_plain", "encode_output_down",
           "encode_output_down_plain", "pool_plain", "extra_channels"]

_F = np.float32


@dataclasses.dataclass(frozen=True)
class PostConfig:
    """A frame's post stages (static: hashable tuples)."""
    h: int                      # the coded frame's true size
    w: int
    full_h: int                 # the output size (after upsampling)
    full_w: int
    bits: int                   # output bits per sample
    noise_lut: Optional[Tuple[float, ...]] = None    # 8 knots (f32)
    ups: int = 1                # 1, 2, 4 or 8
    up_weights: Optional[tuple] = None   # signalled weights (None: default)
    out: tuple = ("srgb",)
    ec: Tuple[Tuple[int, int], ...] = ()   # per extra channel: bits, factor
    down: int = 1               # the box average before the output encoding
    # the patches and splines (host arrays; not part of the comparison)
    overlay: Optional[OV.Overlay] = dataclasses.field(default=None,
                                                      compare=False)

    @property
    def colour_empty(self) -> bool:
        """No colour stage: kernel 2 writes the codes itself."""
        return self.overlay is None and self.noise_lut is None and \
            self.ups == 1 and self.out == ("srgb",) and self.down == 1

    @staticmethod
    def of(lf, fh, hdr, h: int, w: int) -> "PostConfig":
        """The frame's post stages (dec_real._device_post_config): the
        overlay's lists are built here, on the host."""
        m = hdr.metadata
        noise = (tuple(float(_F(v)) for v in lf.noise_lut)
                 if lf.noise_lut is not None else None)
        ups = int(fh.upsampling)
        ec = tuple((e.bit_depth.bits_per_sample,
                    (fh.ec_upsampling[i] if i < len(fh.ec_upsampling)
                     else 1) << e.dim_shift)
                   for i, e in enumerate(m.extra_channels))
        return PostConfig(h=h, w=w, full_h=fh.frame_height or hdr.ysize,
                          full_w=fh.frame_width or hdr.xsize,
                          bits=m.bit_depth.bits_per_sample, noise_lut=noise,
                          ups=ups, up_weights=upsample_weights(m, ups),
                          out=output_spec(m, fh), ec=ec,
                          overlay=OV.Overlay.of(lf, h, w))


def output_spec(m, fh=None) -> tuple:
    """The output encoding of image metadata m and frame header fh:
    ("ycbcr",) for a YCbCr frame (JPEG recompression), else ("srgb",),
    ("gamma", g) or ("enc", trc, gamut matrix or None, intensity_target,
    luma)."""
    if fh is not None and fh.do_ycbcr:
        return ("ycbcr",)
    ce = m.colour_encoding
    if ce is not None and ce.have_gamma:
        return ("gamma", float(ce.gamma / 1e7))
    if _is_srgb_output(ce):
        return ("srgb",)
    prim, wp = HC.primaries_xy(ce), HC.white_xy(ce)
    gm = None
    if prim != HC.PRIMARIES["srgb"] or wp != HC.ILLUMINANT_D65:
        gm = tuple((HC.gamut_xyz_to_rgb(prim, wp)
                    @ HC.gamut_rgb_to_xyz(HC.PRIMARIES["srgb"],
                                          HC.ILLUMINANT_D65))
                   .astype(np.float32).reshape(-1).tolist())
    luma = tuple(HC.gamut_rgb_to_xyz(prim, wp)[1]
                 .astype(np.float32).tolist())
    it = float(m.tone_mapping.intensity_target or 255.0)
    return ("enc", int(ce.transfer_function), gm, it, luma)


# --------------------------------------------------------------------------
# The noise random planes, cached on the device

_NOISE_RND = {}
_NOISE_LOCK = threading.Lock()


def noise_random(w: int, h: int, device) -> torch.Tensor:
    """(3, h, w) f32 random planes of a still's noise (host/vardct/noise.py
    noise_planes, a constant table per size: the visible frame index of a
    still is 1), built once and kept on `device` (up to four sizes), as
    dec_real._noise_rnd_device keeps them.  Threads that ask for a new
    size at once build it once.  On a CUDA device the upload runs on the
    first caller's stream; a caller on another stream waits for it there
    (and the planes' memory is kept for that stream's work)."""
    dev = torch.device(device)
    key = (w, h, str(dev))
    with _NOISE_LOCK:
        entry = _NOISE_RND.get(key)
        if entry is None:
            if len(_NOISE_RND) >= 4:
                _NOISE_RND.pop(next(iter(_NOISE_RND)))
            rnd = torch.from_numpy(noise_planes(w, h)).to(dev)
            uploaded = None
            if dev.type == "cuda":
                stream = torch.cuda.current_stream(dev)
                uploaded = (stream, stream.record_event())
            entry = _NOISE_RND[key] = (rnd, uploaded)
    rnd, uploaded = entry
    if uploaded is not None:
        stream, done = uploaded
        current = torch.cuda.current_stream(dev)
        if current != stream:
            current.wait_event(done)
            rnd.record_stream(current)
    return rnd


# --------------------------------------------------------------------------
# The kernels' bindings

_c = ctypes


@functools.lru_cache(maxsize=None)
def _kernels():
    lib = _build.load("post")
    p, i, ll = _c.c_void_p, _c.c_int, _c.c_longlong
    return (_build.bind(lib, "jxl_add_noise", [p, ll, p, p, i, i]),
            _build.bind(lib, "jxl_upsample", [p, ll, ll, p, p, i, i, i, i]),
            _build.bind(lib, "jxl_encode_output",
                        [p, ll, ll, p, i, i, i, i, i, i, p, p, p]))


def _check_planes(x: torch.Tensor, what: str, c: int = 3) -> None:
    if x.dtype != torch.float32 or x.dim() != 3 or \
            (c and x.shape[0] != c):
        raise ValueError(f"{what}: expected ({c or 'C'}, H, W) float32 "
                         f"planes, got {tuple(x.shape)} {x.dtype}")


# --------------------------------------------------------------------------
# A5: noise

def _conv_subbox(p: torch.Tensor) -> torch.Tensor:
    """centre - (5x5 mirrored box sum) / 25, the sum taken row by row."""
    h, w = p.shape
    pad = p[_mirror_index(h, 2, p.device)][:, _mirror_index(w, 2, p.device)]
    s = torch.zeros_like(p)
    for dy in range(5):
        for dx in range(5):
            s = s + pad[dy:dy + h, dx:dx + w]
    return p - fp.div(s, 25.0)


def _strength(lut: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The 8-knot piecewise-linear lut at v (scale 6, flat past knot 7)."""
    sc = torch.clamp_min(v * 6.0, 0.0)
    fl = torch.floor(sc)
    frac = sc - fl
    over = sc >= 7.0
    idx = torch.where(over, torch.full_like(fl, 6.0),
                      torch.clamp_max(fl, 6.0)).long()
    frac = torch.where(over, torch.ones_like(frac), frac)
    return lut[idx] * (1.0 - frac) + lut[torch.clamp_max(idx + 1, 7)] * frac


def add_noise_plain(xyb: torch.Tensor, rnd: torch.Tensor,
                    lut: torch.Tensor) -> torch.Tensor:
    """The twin of add_noise: the noise added to xyb in place."""
    X, Y, B = xyb[0], xyb[1], xyb[2]
    conv_r, conv_g, conv_cor = (_conv_subbox(rnd[c]) for c in range(3))
    sr = _strength(lut, (Y + X) * 0.5)
    sg = _strength(lut, (Y - X) * 0.5)
    # / 128 is a power of two: the product by its inverse is exact
    red = sr * (conv_cor + conv_r * (1.0 / 128.0))
    green = sg * (conv_cor + conv_g * (1.0 / 128.0))
    k0 = float(_F(NOISE_K0))
    xyb[0] = X + k0 * (red - green)
    xyb[1] = Y + k0 * (red + green)
    xyb[2] = B + k0 * (red + green)
    return xyb


def add_noise(xyb: torch.Tensor, rnd: torch.Tensor,
              lut: torch.Tensor) -> torch.Tensor:
    """The frame's noise added in place to (3, h, w) f32 XYB planes: rnd
    the (3, h, w) random planes (noise_random), lut the 8 knots (f32).
    Returns xyb."""
    _check_planes(xyb, "xyb")
    if rnd.shape != xyb.shape or rnd.dtype != torch.float32 or \
            lut.shape != (8,) or lut.dtype != torch.float32 or \
            rnd.device != xyb.device or lut.device != xyb.device:
        raise ValueError("rnd must be (3, h, w) float32 and lut (8,) "
                         "float32, on the planes' device")
    if xyb.device.type == "cpu":
        return add_noise_plain(xyb, rnd, lut)
    if not (xyb.is_contiguous() and rnd.is_contiguous()):
        raise ValueError("add_noise works in place on contiguous planes")
    _, h, w = xyb.shape
    if h and w:
        _build.launch(_kernels()[0], xyb.device, xyb.data_ptr(), h * w,
                      rnd.data_ptr(), lut.contiguous().data_ptr(), h, w)
        add_noise.launches += 1
    return xyb


add_noise.launches = 0


# --------------------------------------------------------------------------
# A6: upsampling

def upsample_plain(planes: torch.Tensor, ker: torch.Tensor) -> torch.Tensor:
    """The twin of upsample."""
    n = ker.shape[0]
    c, h, w = planes.shape
    iy, ix = (_mirror_index(h, 2, planes.device),
              _mirror_index(w, 2, planes.device))
    pad = planes[:, iy][:, :, ix]
    win = [pad[:, dy:dy + h, dx:dx + w] for dy in range(5) for dx in range(5)]
    lo, hi = win[0], win[0]
    for v in win[1:]:
        lo, hi = torch.minimum(lo, v), torch.maximum(hi, v)
    kf = ker.reshape(n, n, 25)
    out = torch.empty((c, h, n, w, n), dtype=torch.float32,
                      device=planes.device)
    for py in range(n):
        for px in range(n):
            acc = kf[py, px, 0] * win[0]
            for k in range(1, 25):
                acc = acc + kf[py, px, k] * win[k]
            out[:, :, py, :, px] = torch.minimum(torch.maximum(acc, lo), hi)
    return out.reshape(c, h * n, w * n)


def upsample(planes: torch.Tensor, ker: torch.Tensor) -> torch.Tensor:
    """(C, h, w) f32 planes -> (C, n * h, n * w), ker the (n, n, 5, 5) f32
    phase kernels (n in 2, 4, 8); one launch for every plane."""
    _check_planes(planes, "planes", 0)
    n = ker.shape[0]
    if n not in (2, 4, 8) or ker.shape != (n, n, 5, 5) or \
            ker.dtype != torch.float32 or ker.device != planes.device:
        raise ValueError("ker must be (n, n, 5, 5) float32, n in 2, 4, 8, "
                         "on the planes' device")
    if planes.device.type == "cpu":
        return upsample_plain(planes, ker)
    if planes.stride(2) != 1:
        planes = planes.contiguous()
    c, h, w = planes.shape
    out = torch.empty((c, h * n, w * n), dtype=torch.float32,
                      device=planes.device)
    if c and h and w:
        _build.launch(_kernels()[1], planes.device, planes.data_ptr(),
                      planes.stride(0), planes.stride(1),
                      ker.contiguous().data_ptr(), out.data_ptr(), c, h, w,
                      n)
        upsample.launches += 1
    return out


upsample.launches = 0


def kernels_for(n: int, weights=None, device="cpu") -> torch.Tensor:
    """The (n, n, 5, 5) f32 phase kernels of an n-times upsampler, from
    the signalled weights or the defaults (host/ops/upsample.py)."""
    return torch.from_numpy(np.asarray(upsample_kernels(n, weights),
                                       np.float32)).to(device)


def upsample_ints(planes: List[torch.Tensor], n: int,
                  weights=None) -> List[torch.Tensor]:
    """Integer planes of one size upsampled n times in one launch and
    rounded to the nearest (rint) -> int64 planes; n 1 returns them."""
    if n == 1 or not planes:
        return planes
    up = upsample(torch.stack([p.to(torch.float32) for p in planes]),
                  kernels_for(n, weights, planes[0].device))
    return list(torch.round(up).to(torch.int64))


# --------------------------------------------------------------------------
# A7: the output encoding

_PQ = tuple(float(_F(v)) for v in (HC._PQ_M1, HC._PQ_M2, HC._PQ_C1,
                                    HC._PQ_C2, HC._PQ_C3))
_HLG = tuple(float(_F(v)) for v in (HC._HLG_A, HC._HLG_B, HC._HLG_C))
# the spec's kind and the TRC cases of the kernel (csrc/post.cu)
KIND = {"srgb": 0, "gamma": 1, "enc": 2, "ycbcr": 3}
# BT.601 of dec_real.ycbcr_planes_to_rgb (f32), the Y plane stored centred
_YCBCR = tuple(float(_F(v)) for v in (128.0 / 255.0, 1.402, 0.344136,
                                      0.714136, 1.772))


def _pow(v: torch.Tensor, e: float) -> torch.Tensor:
    return torch.pow(v, float(_F(e)))


def _linear_to_trc(v: torch.Tensor, trc: int) -> torch.Tensor:
    """LINEAR_TO_TRC.get(trc, linear_to_srgb) on v >= 0, in f32."""
    if trc == 8:
        return v
    if trc == 1:
        return torch.where(v < _F(0.018), v * _F(4.5),
                           _F(1.099) * _pow(v, 0.45) - _F(0.099))
    if trc == 16:
        m1, m2, c1, c2, c3 = _PQ
        p = _pow(v, m1)
        return _pow((c1 + c2 * p) / (1.0 + c3 * p), m2)
    if trc == 17:
        return _pow(v, 1.0 / 2.6)
    if trc == 18:
        a, b, c = _HLG
        return torch.where(
            v <= _F(1.0 / 12), torch.sqrt(v * 3.0),
            a * torch.log(torch.clamp_min(12.0 * v - b, _F(1e-12))) + c)
    return torch.where(v <= _F(0.0031308), v * _F(12.92),
                       _F(1.055) * _pow(v, 1 / 2.4) - _F(0.055))


def pool_plain(xyb: torch.Tensor, down: int) -> torch.Tensor:
    """(C, H, W) f32 -> (C, ceil(H / down), ceil(W / down)): the mean of
    each down x down cell, the last row and column repeated past the
    edge, summed row by row as S1 sums."""
    c, h, w = xyb.shape
    ho, wo = -(-h // down), -(-w // down)
    iy = torch.clamp(torch.arange(ho * down, device=xyb.device), max=h - 1)
    ix = torch.clamp(torch.arange(wo * down, device=xyb.device), max=w - 1)
    pad = xyb[:, iy][:, :, ix]
    s = torch.zeros((c, ho, wo), dtype=torch.float32, device=xyb.device)
    for dy in range(down):
        for dx in range(down):
            s = s + pad[:, dy::down, dx::down]
    return fp.div(s, float(down * down))


def encode_output_plain(xyb: torch.Tensor, spec: tuple,
                        bits: int) -> torch.Tensor:
    """The twin of encode_output (its "srgb" case gives
    color.xyb_to_srgb_plain's codes at 8 and 16 bits)."""
    if spec[0] == "ycbcr":
        # the planes are (Cb, Y, Cr)
        off, kr, kgb, kgr, kb = _YCBCR
        cb, y, cr = xyb[0], xyb[1] + off, xyb[2]
        enc = [y + kr * cr, (y - kgb * cb) - kgr * cr, y + kb * cb]
        return _quantize_plain(enc, bits)
    lin = color.xyb_to_linear_plain(xyb)
    if spec[0] == "srgb":
        enc = [color.fast_linear_to_srgb(v) for v in lin]
    elif spec[0] == "gamma":
        enc = [_pow(torch.clamp_min(v, 0.0), spec[1]) for v in lin]
    else:
        _, trc, gm, it, luma = spec
        if gm is not None:
            g = np.asarray(gm, np.float32).reshape(3, 3)
            lin = [float(g[c, 0]) * lin[0] + float(g[c, 1]) * lin[1]
                   + float(g[c, 2]) * lin[2] for c in range(3)]
        if trc == 18:
            disp = [v * float(_F(255.0 / it)) for v in lin]
            gam = 1.2 * 1.111 ** np.log2(it / 1000.0)
            yd = (float(_F(luma[0])) * disp[0] + float(_F(luma[1])) * disp[1]
                  + float(_F(luma[2])) * disp[2])
            f = torch.where(yd > _F(1e-9),
                            _pow(yd.abs(), (1.0 - gam) / gam),
                            torch.zeros_like(yd))
            enc = []
            for v in disp:
                s = v * f
                enc.append(torch.sign(s) * _linear_to_trc(
                    torch.clamp_max(s.abs(), 1.0), 18))
        else:
            scale = float(_F(255.0 / 10000.0)) if trc == 16 else None
            enc = [torch.sign(v) * _linear_to_trc(
                v.abs() * scale if scale else v.abs(), trc) for v in lin]
    return _quantize_plain(enc, bits)


def _quantize_plain(enc, bits: int) -> torch.Tensor:
    """clip(floor(v * (2^bits - 1) + 0.5)) of each plane -> (H, W, 3)."""
    maxv = float((1 << bits) - 1)
    out = [torch.floor(e * maxv + 0.5).clamp(0.0, maxv) for e in enc]
    return torch.stack(out, -1).to(torch.uint8 if bits <= 8
                                   else torch.uint16)


def _output_params(spec: tuple) -> np.ndarray:
    """The kernel's float parameters (csrc/post.cu's P_* layout): gamma
    or the HLG inverse OOTF's exponent, 255 / intensity_target, the
    gamut matrix (identity when none), the luma weights, the HLG and PQ
    constants and the transfer functions' exponents, each the f32 value
    the twin uses."""
    prm = np.zeros(27, np.float32)
    if spec[0] == "gamma":
        prm[0] = spec[1]
    elif spec[0] == "enc":
        _, _trc, gm, it, luma = spec
        gam = 1.2 * 1.111 ** np.log2(it / 1000.0)
        prm[0] = (1.0 - gam) / gam
        prm[1] = 255.0 / it
        prm[2:11] = (np.eye(3, dtype=np.float32).reshape(-1) if gm is None
                     else np.asarray(gm, np.float32))
        prm[11:14] = luma
    prm[14:17] = _HLG
    prm[17:22] = _PQ
    prm[22:27] = (1 / 2.4, 0.45, 1.0 / 2.6, 1.0 / 12, 255.0 / 10000.0)
    return prm


def _launch_output(xyb: torch.Tensor, spec: tuple, bits: int,
                   down: int) -> torch.Tensor:
    if xyb.stride(2) != 1:
        xyb = xyb.contiguous()
    _, H, W = xyb.shape
    out = torch.empty((-(-H // down), -(-W // down), 3), device=xyb.device,
                      dtype=torch.uint8 if bits <= 8 else torch.uint16)
    if H and W:
        # the kernel stores a row's codes as whole words
        _build.check_aligned(out, "out")
        trc = spec[1] if spec[0] == "enc" else 0
        prm = _output_params(spec)
        # the constants are host arrays, copied into the launch parameters
        _build.launch(_kernels()[2], xyb.device, xyb.data_ptr(),
                      xyb.stride(0), xyb.stride(1), out.data_ptr(), H, W,
                      down, KIND[spec[0]], trc, bits, prm.ctypes.data,
                      color._CONSTS.ctypes.data, color._MUL.ctypes.data)
    return out


def _check_spec(xyb: torch.Tensor, spec: tuple) -> None:
    _check_planes(xyb, "xyb")
    if spec[0] not in KIND:
        raise ValueError(f"output spec {spec!r}")


def encode_output(xyb: torch.Tensor, spec: tuple, bits: int) -> torch.Tensor:
    """(3, H, W) f32 XYB planes (a cropped view is fine) -> (H, W, 3)
    codes in the output encoding `spec`, uint8 at `bits` <= 8, else
    uint16, clip(floor(v * (2^bits - 1) + 0.5))."""
    _check_spec(xyb, spec)
    if xyb.device.type == "cpu":
        return encode_output_plain(xyb, spec, bits)
    out = _launch_output(xyb, spec, bits, 1)
    if out.numel():
        encode_output.launches += 1
    return out


encode_output.launches = 0


def encode_output_down_plain(xyb: torch.Tensor, spec: tuple, bits: int,
                             down: int) -> torch.Tensor:
    """The twin of encode_output_down."""
    return encode_output_plain(pool_plain(xyb, down), spec, bits)


def encode_output_down(xyb: torch.Tensor, spec: tuple, bits: int,
                       down: int) -> torch.Tensor:
    """S1: (3, H, W) f32 XYB planes -> (ceil(H / down), ceil(W / down), 3)
    codes, each the output encoding of a down x down cell's mean (the
    last row and column repeated past the edge), as encode_output."""
    _check_spec(xyb, spec)
    if down < 2:
        raise ValueError(f"down={down}: expected >= 2 (encode_output "
                         f"encodes each pixel)")
    if xyb.device.type == "cpu":
        return encode_output_down_plain(xyb, spec, bits, down)
    out = _launch_output(xyb, spec, bits, down)
    if out.numel():
        encode_output_down.launches += 1
    return out


encode_output_down.launches = 0


# --------------------------------------------------------------------------
# The stages

class PostStages(nn.Module):
    """overlay -> noise -> upsampling -> [down pool] -> output encoding on
    the filtered (3, h, w) f32 XYB planes of one frame geometry ->
    (full_h, full_w, 3) codes, or (ceil(full_h / down), ceil(full_w /
    down), 3) with the pool."""

    def __init__(self, config: PostConfig):
        super().__init__()
        self.config = config

    def xyb(self, xyb: torch.Tensor, overlay=None, refs=None
            ) -> torch.Tensor:
        """The overlay (overlay.OverlayInputs, the config's lists on the
        planes' device; refs: slot -> the reference frames' planes) and the
        noise, in place on contiguous planes -> the XYB planes."""
        cfg = self.config
        dev = xyb.device
        if cfg.overlay is not None:
            xyb = OV.apply(xyb.contiguous(), overlay, refs)
        if cfg.noise_lut is not None:
            xyb = add_noise(xyb.contiguous(), noise_random(cfg.w, cfg.h, dev),
                            torch.tensor(cfg.noise_lut, dtype=torch.float32,
                                         device=dev))
        return xyb

    def forward(self, xyb: torch.Tensor, overlay=None,
                refs=None) -> torch.Tensor:
        cfg = self.config
        dev = xyb.device
        xyb = self.xyb(xyb, overlay, refs)
        if cfg.ups > 1:
            xyb = upsample(xyb, kernels_for(cfg.ups, cfg.up_weights, dev))
        d = cfg.down
        if d > 1:
            # the reference pools the planes as the stages leave them (an
            # upsampled frame's may pass the output size), then crops
            out = encode_output_down(xyb, cfg.out, cfg.bits, d)
            return out[:-(-cfg.full_h // d), :-(-cfg.full_w // d)]
        return encode_output(xyb[:, :cfg.full_h, :cfg.full_w], cfg.out,
                             cfg.bits)


def extra_channels(planes: List[torch.Tensor], config: PostConfig,
                   dtype: torch.dtype) -> List[torch.Tensor]:
    """The frame's extra-channel planes (int32, every transform undone) ->
    (full_h, full_w) planes of `dtype`: upsampled by their own factor
    (the default kernels, as dec_real.py:2016-2024), rounded, clipped to
    their bits and rescaled to the output depth."""
    out_max = 65535 if dtype == torch.uint16 else 255
    res = []
    for p, (ebits, up) in zip(planes, config.ec):
        p = upsample_ints([p], up)[0].to(torch.int64).clamp(
            0, (1 << ebits) - 1)
        if (1 << ebits) - 1 != out_max:
            p = torch.div(p * out_max, (1 << ebits) - 1,
                          rounding_mode="floor")
        res.append(p[:config.full_h, :config.full_w].to(dtype))
    return res
