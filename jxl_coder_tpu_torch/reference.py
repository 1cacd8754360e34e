"""The host codec the port is checked against.

The port's device decode is held to a float64 host decode; streams to
decode come from the host encoders (VarDCT, with alpha, colour
encodings, 16-bit input, noise and upsampled frames, and the Modular
frame writer ``encode_modular_frame``), and the per-strategy transform
tables of
seeded test families from the calibrated tables.  All of them
are the port's own copies of the JAX package's host layers (``host/``,
numpy and C++).  ``api.decode`` never calls this module.
"""

from __future__ import annotations

import math

import numpy as np

from .api import _read_frames
from .host.api import apply_orientation
from .host.bitstream.frame_header import Encoding, FrameType
from .host.codec import (decode_modular_frame, encode_modular_frame,
                         modular_planes_to_xyb)
from .host.modular.frame import undo_on_host
from .host.vardct.dec_real import (_is_srgb_output, dc_from_frame,
                                   decode_vardct_frame, xyb_planes_to_encoding,
                                   xyb_planes_to_gamma, xyb_planes_to_srgb8,
                                   xyb_planes_to_srgb16)
from .host.vardct.enc_real import encode_vardct_real as encode_vardct
from .host.vardct.strategies import STRATEGIES
from .host.vardct.synthesis import dequant_table, response_matrix
from .vardct.inputs import _PAD_SENTINEL as PAD_SENTINEL

__all__ = ["encode_vardct", "encode_modular_frame", "decode_float64",
           "thumbnail_float64", "photon_noise_lut", "STRATEGIES", "dequant_table",
           "response_matrix", "PAD_SENTINEL"]


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
    encodings, orientation applied."""
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
    if ce is not None and ce.have_gamma:
        out = xyb_planes_to_gamma(X, Y, B, ce.gamma / 1e7, bits)
    elif not _is_srgb_output(ce):
        out = xyb_planes_to_encoding(X, Y, B, ce, bits,
                                     m.tone_mapping.intensity_target)
    elif bits > 8:
        out = xyb_planes_to_srgb16(X, Y, B)
    else:
        out = xyb_planes_to_srgb8(X, Y, B)
    return apply_orientation(out, m.orientation)
