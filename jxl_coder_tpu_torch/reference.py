"""The host codec the port is checked against.

The port's device decode is held to a float64 host decode; streams to
decode come from the host encoders (VarDCT, with alpha, colour
encodings, 16-bit input, noise and upsampled frames, and the Modular
frame writer ``encode_modular_frame``), and the per-strategy transform
tables of
seeded test families from the calibrated tables.  All of them
are the port's own copies of the JAX package's host layers (``host/``,
numpy and C++).  The oracles: ``decode_float64`` (a still),
``thumbnail_float64``, ``preview_float64`` and ``dc_upsampled_float64``
(a progressive preview and a truncated stream's two renders) and
``frames_float64`` (an animation's shown frames, composed by A10's twin)
and ``jpeg_pixels_float64`` (a recompressed JPEG's routes 2 and 3).
``api.decode`` never calls this module.
"""

from __future__ import annotations

import math

import numpy as np

from .api import _first_frame, _read_frames, _toc_count
from .host.api import ResizeFilter, apply_orientation
from .host.bitstream.container import extract_codestream
from .host.bitstream.frame_header import (Encoding, FrameType,
                                          read_frame_header, read_toc)
from .host.bitstream.headers import read_image_header
from .host.bitstream.reader import BitReader
from .host.codec import (decode_modular_frame, encode_modular_frame,
                         modular_planes_to_xyb)
from .host.modular.frame import undo_on_host
from .host.ops.resize import resample_matrix
from .host.jpeg.parser import ZIGZAG
from .host.vardct.dec_real import (_is_srgb_output, dc_from_frame,
                                   decode_vardct_frame, xyb_planes_to_encoding,
                                   xyb_planes_to_gamma, xyb_planes_to_srgb8,
                                   xyb_planes_to_srgb16, ycbcr_planes_to_rgb)
from .host.vardct.enc_real import encode_vardct_real as encode_vardct
from .host.vardct.strategies import STRATEGIES
from .host.vardct.synthesis import dequant_table, response_matrix
# bound here, so that a run that makes the module's twin raise on the
# card's path still composes the oracle's frames
from .ops.compose import blend_params, compose_plain, window
from .vardct.inputs import _PAD_SENTINEL as PAD_SENTINEL

__all__ = ["encode_vardct", "encode_modular_frame", "decode_float64",
           "thumbnail_float64", "preview_float64", "dc_upsampled_float64",
           "frames_float64", "jpeg_pixels_float64", "photon_noise_lut",
           "STRATEGIES", "dequant_table", "response_matrix", "PAD_SENTINEL"]


def photon_noise_lut(iso: float) -> list:
    """The 8-knot noise lut that jxl_coder_tpu.api.encode writes for
    photon_noise_iso (api.py:264-275): strength grows with the ISO and
    falls with the intensity.  Pass it as encode_vardct's noise_lut."""
    a = 0.12 * math.sqrt(iso / 3200.0)
    return [min(1.0, a * (1.0 - 0.8 * (k / 7.0))) for k in range(8)]


def _xyb_frame(cs, hdr, fh, toc, dc_frames) -> dict:
    """An LF or reference frame's {0: X, 1: Y, 2: B} planes on the host
    (jxl_coder_tpu/api.py:774-800)."""
    if fh.encoding == Encoding.MODULAR:
        raw, dc_quant = decode_modular_frame(cs, hdr, fh, toc)
        return modular_planes_to_xyb(undo_on_host(raw), dc_quant)
    return decode_vardct_frame(cs, hdr, fh, toc,
                               dc_frame=dc_frames.get(fh.lf_level + 1),
                               return_xyb=True)


def decode_float64(data: bytes) -> np.ndarray:
    """Pixels of a VarDCT still from the float64 host reconstruction
    (what ``jxl_coder_tpu.api.decode`` returns on its host path,
    ``api.py:505-548``), after the LF and reference-only frames before it,
    decoded on the host to their XYB planes."""
    cs, hdr, frames = _read_frames(data)
    dc_frames, refs = {}, {}
    for fh, toc in frames[:-1]:
        planes = _xyb_frame(cs, hdr, fh, toc, dc_frames)
        if fh.frame_type == FrameType.LF_FRAME:
            dc_frames[fh.lf_level] = planes
        else:
            refs[fh.save_as_reference] = [planes[0], planes[1], planes[2]]
    fh, toc = frames[-1]
    out = decode_vardct_frame(cs, hdr, fh, toc,
                              dc_frame=dc_frames.get(fh.lf_level + 1),
                              ref_frames=refs or None)
    return apply_orientation(out, hdr.metadata.orientation)


def thumbnail_float64(data: bytes) -> np.ndarray:
    """The 1/8-scale preview of a VarDCT still without upsampling, on the
    host in float64, as jxl_coder_tpu.api.decode_thumbnail computes it
    (``vardct/dec_real.py:1727-1747``): the frame's smoothed DC image (or
    its LF frame's planes, edge-replicated) through the host's output
    encodings, orientation applied.  A YCbCr frame (JPEG recompression)
    converts its DC by BT.601, as its full decode does; the JAX package
    reads its DC as XYB there (fault R13 of ROADMAP.md)."""
    out, hdr = _dc_image_float64(data)
    return apply_orientation(out, hdr.metadata.orientation)


def preview_float64(data: bytes, passes: int) -> np.ndarray:
    """The first frame of a VarDCT still from its first `passes` AC passes
    only, on the host in float64 (jxl_coder_tpu.api.decode_preview's
    ``decode_vardct_frame(..., max_passes=passes)``), orientation applied:
    the oracle of the progressive preview, and of a stream cut after its
    passes' last sections."""
    cs, hdr, fh, toc = _first_frame(data)
    out = decode_vardct_frame(cs, hdr, fh, toc, max_passes=passes)
    return apply_orientation(out, hdr.metadata.orientation)


def dc_upsampled_float64(data: bytes) -> np.ndarray:
    """A stream cut before its first whole AC pass, as
    jxl_coder_tpu.api._decode_partial renders it (``api.py:627-635``): the
    DC image's codes (thumbnail_float64's, before orientation) resized to
    the frame's size, RESIZE with Catmull-Rom, here as float64 products
    of resample_matrix's weights (the reference's are float32), clipped
    and rounded half to even; orientation applied."""
    dc, hdr = _dc_image_float64(data)
    _cs, _hdr, fh, _toc = _first_frame(data)
    h, w = fh.frame_height or hdr.ysize, fh.frame_width or hdr.xsize
    maxv = float(np.iinfo(dc.dtype).max)
    wy = resample_matrix(dc.shape[0], h, int(ResizeFilter.CATMULL_ROM))
    wx = resample_matrix(dc.shape[1], w, int(ResizeFilter.CATMULL_ROM))
    f = dc.astype(np.float64) / maxv
    t = np.tensordot(wy.astype(np.float64), f, axes=(1, 0))   # (h, w_in, c)
    out = np.tensordot(t, wx.astype(np.float64), axes=(1, 1))  # (h, c, w)
    out = np.rint(np.clip(out.transpose(0, 2, 1), 0.0, 1.0) * maxv)
    out = out.astype(dc.dtype)
    return apply_orientation(out, hdr.metadata.orientation)


def _dc_image_float64(data: bytes):
    """thumbnail_float64's codes before orientation, and the header."""
    from .vardct.parse import parse_frame
    cs, hdr, frames = _read_frames(data)
    dc_frames = {}
    for fh, toc in frames[:-1]:
        if fh.frame_type == FrameType.LF_FRAME:
            dc_frames[fh.lf_level] = _xyb_frame(cs, hdr, fh, toc, dc_frames)
    fh, toc = frames[-1]
    if fh.encoding == Encoding.MODULAR or fh.upsampling != 1:
        raise ValueError("thumbnail_float64: a VarDCT frame without "
                         "upsampling only")
    w, h = fh.coded_size(hdr)
    th, tw = -(-h // 8), -(-w // 8)
    dc = parse_frame(cs, hdr, fh, toc, dc_only=True)["dc_glob"]
    if dc is None:
        dc = dc_from_frame(dc_frames[fh.lf_level + 1], tw, th)
    X, Y, B = (dc[c][:th, :tw] for c in range(3))
    m = hdr.metadata
    bits, ce = m.bit_depth.bits_per_sample, m.colour_encoding
    if fh.do_ycbcr:
        out = ycbcr_planes_to_rgb(X, Y, B, bits)
    elif ce is not None and ce.have_gamma:
        out = xyb_planes_to_gamma(X, Y, B, ce.gamma / 1e7, bits)
    elif not _is_srgb_output(ce):
        out = xyb_planes_to_encoding(X, Y, B, ce, bits,
                                     m.tone_mapping.intensity_target)
    elif bits > 8:
        out = xyb_planes_to_srgb16(X, Y, B)
    else:
        out = xyb_planes_to_srgb8(X, Y, B)
    return out, hdr


def _frame_float64(cs, hdr, fh, toc, dc_frames, refs) -> np.ndarray:
    """One frame's codes on the host (jxl_coder_tpu/api.py:804-818): a
    VarDCT frame by the float64 decoder, a Modular frame (no XYB, no
    upsampling) by its channels clipped to the bit depth."""
    if fh.encoding != Encoding.MODULAR:
        return decode_vardct_frame(cs, hdr, fh, toc,
                                   dc_frame=dc_frames.get(fh.lf_level + 1),
                                   ref_frames=refs or None)
    m = hdr.metadata
    if m.xyb_encoded or fh.upsampling != 1:
        raise ValueError("frames_float64: a Modular frame without XYB or "
                         "upsampling only")
    raw, _dc_quant = decode_modular_frame(cs, hdr, fh, toc)
    bits = m.bit_depth.bits_per_sample
    planes = [np.clip(p, 0, (1 << bits) - 1) for p in undo_on_host(raw)]
    return np.stack(planes, -1).astype(np.uint8 if bits <= 8 else np.uint16)


def frames_float64(data: bytes):
    """The shown frames of an animation and their durations, as
    jxl_coder_tpu.api.decode_frames walks them (``api.py:964-1041``):
    each frame decoded on the host (_frame_float64), cropped or blended
    frames composed by A10's twin (``ops/compose.compose_plain``, the
    reference's numpy arithmetic in torch float64) on the CPU."""
    import torch
    cs = extract_codestream(data).codestream
    br = BitReader(cs)
    hdr = read_image_header(br)
    m = hdr.metadata
    frames, durations, slots, dc_frames, refs = [], [], {}, {}, {}
    while True:
        fh = read_frame_header(br, hdr)
        toc = read_toc(br, _toc_count(hdr, fh))
        if fh.frame_type == FrameType.LF_FRAME:
            dc_frames[fh.lf_level] = _xyb_frame(cs, hdr, fh, toc, dc_frames)
        elif (fh.frame_type == FrameType.REFERENCE_ONLY
              and fh.save_before_color_transform):
            p = _xyb_frame(cs, hdr, fh, toc, dc_frames)
            refs[fh.save_as_reference] = [p[0], p[1], p[2]]
        else:
            pix = _frame_float64(cs, hdr, fh, toc, dc_frames, refs)
            if fh.frame_type == FrameType.REFERENCE_ONLY:
                slots[fh.save_as_reference] = pix
            else:
                if (not fh.have_crop and pix.shape[0] >= hdr.ysize
                        and pix.shape[1] >= hdr.xsize
                        and fh.blending_info.mode == 0):
                    canvas = pix[:hdr.ysize, :hdr.xsize]
                else:
                    base = slots.get(fh.blending_info.source)
                    canvas = (np.zeros((hdr.ysize, hdr.xsize, pix.shape[2]),
                                       pix.dtype) if base is None
                              else base.copy())
                    win = window(canvas.shape[:2], pix.shape[:2], fh.x0,
                                 fh.y0)
                    if win is not None:
                        compose_plain(torch.from_numpy(canvas),
                                      torch.from_numpy(pix), win,
                                      blend_params(fh, m, pix.shape[2]))
                if not fh.is_last:
                    slots[fh.save_as_reference] = canvas
                if fh.frame_type in (0, 3) and (
                        fh.duration > 0 or m.animation is None
                        or fh.is_last):
                    frames.append(apply_orientation(canvas.copy(),
                                                    m.orientation))
                    durations.append(fh.duration)
        if fh.is_last:
            break
        br.pos = toc.end_offset * 8
    return frames, durations


def _upsampled_float64(p: np.ndarray, fy: int, fx: int, triangle: bool,
                       h: int, w: int) -> np.ndarray:
    """A plane at the output size by the route's rule (jpeg/wire.py's
    triangle (3a + b) / 4, the horizontal pass first, edges repeated; or
    jpeg/transcode.py's np.repeat), cropped."""
    if not triangle:
        return np.repeat(np.repeat(p, fy, axis=0), fx, axis=1)[:h, :w]
    for axis, f in ((1, fx), (0, fy)):
        if f == 2:
            q = np.moveaxis(p, axis, 0)
            prev = np.concatenate([q[:1], q[:-1]])
            nxt = np.concatenate([q[1:], q[-1:]])
            up = np.empty((2 * q.shape[0],) + q.shape[1:])
            up[0::2] = (3 * q + prev) / 4
            up[1::2] = (3 * q + nxt) / 4
            p = np.moveaxis(up, 0, axis)
    return p[:h, :w]


def jpeg_pixels_float64(data: bytes) -> np.ndarray:
    """A round-1 container's or a subsampled recompressed JPEG's pixels
    (routes 2 and 3 of ``api.decode``) in numpy float64: the coefficients
    as the host reads them, dequantised and de-zigzagged, the IDCT as an
    explicit sum over the 8x8 DCT basis, +128, the route's chroma
    upsampling, BT.601, then the route's codes (+0.5 before the
    truncation on the wire route, none on the round-1 route; a grey image
    repeats Y)."""
    from .api import _jpeg_host
    host = _jpeg_host(data)
    if host is None:
        raise ValueError("jpeg_pixels_float64: not a round-1 container or "
                         "a subsampled recompressed JPEG")
    k = np.arange(8)
    basis = np.cos(np.pi * k[:, None] * (2 * k[None, :] + 1) / 16) * 0.5
    basis[0] *= np.sqrt(0.5)          # basis[u, y]: orthonormal DCT-II
    planes, off = [], 0
    for c, (bh, bw) in enumerate(host.grids):
        n = bh * bw * 64
        zz = host.coeffs[off:off + n].reshape(bh, bw, 64).astype(np.float64)
        off += n
        nat = np.empty_like(zz)
        nat[:, :, ZIGZAG] = zz * host.quant[c].astype(np.float64)
        pix = np.einsum("abuv,uy,vx->abyx", nat.reshape(bh, bw, 8, 8), basis,
                        basis)
        plane = pix.transpose(0, 2, 1, 3).reshape(bh * 8, bw * 8) + 128.0
        planes.append(_upsampled_float64(plane, *host.factors[c],
                                         host.triangle, host.height,
                                         host.width))
    if len(planes) < 3:
        rgb = np.repeat(planes[0][:, :, None], 3, axis=2)
    else:
        y, cb, cr = planes[0], planes[1] - 128.0, planes[2] - 128.0
        rgb = np.stack([y + 1.402 * cr, y - 0.344136 * cb - 0.714136 * cr,
                        y + 1.772 * cb], -1)
    if host.rounded:
        rgb = rgb + 0.5
    return np.clip(rgb, 0, 255).astype(np.uint8)
