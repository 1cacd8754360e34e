"""Public decode entry point of the PyTorch port.

``decode(data, device="cuda")`` decodes a VarDCT or a Modular still.
Its container, header and TOC walk is that of
``jxl_coder_tpu.api.decode`` (``api.py:505-542``) over the port's own
host layers (``host/``).

A VarDCT frame: ``prepare``, the host half, runs the host parse
(``vardct.parse``) and the family packing (``vardct.inputs.pack``),
carried onto the named device with the frame's post stages
(``vardct.post.PostConfig``) and its extra channels' planes; then the
frame reconstruction runs there (``vardct.frame.VarDCTFrame``): synthesis,
the filters, then noise, 2x/4x/8x upsampling and the output encoding
(sRGB, a gamma, PQ, HLG or another signalled transfer function, a
non-sRGB gamut), and the extra channels (alpha) after the colour.
``entropy="device"`` decodes the AC pass groups on the device too
(``entropy/device.py``), from the codestream's bytes; the default,
"host", decodes them with the host codec.  A group the device decode
finds corrupt raises InvalidJXLError.

A Modular frame (lossless, or XYB as ``cjxl -m -d`` writes it): its
channel planes decode on the host, as in the reference
(``host.codec.decode_modular_frame``); the inverse RCT, palette and
squeeze run on the device (``modular/device.py``), then the output step
with its upsampling (``modular/output.py``).  A delta palette raises
InvalidJXLError, as the host does.

What raises NotImplementedError: a VarDCT frame with patches, splines,
a DC (progressive LF) frame or YCbCr; ``entropy="device"`` on a VarDCT
frame with extra channels or on a Modular frame; an embedded ICC
profile; animations, reference-only and LF frames, and the JPEG routes.
Nothing falls back to the host decoder.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ._device import resolve_device
from .host.api import (BasicInfo, InvalidJXLError, _check_decode_size,
                       apply_orientation, basic_info)
from .host.bitstream import container as _container
from .host.bitstream.frame_header import (Encoding, read_frame_header,
                                          read_toc)
from .host.bitstream.headers import ImageHeader, read_image_header
from .host.bitstream.reader import BitReader, BitstreamError
from .host.codec import decode_modular_frame
from .host.jpeg import transcode as _jpeg_tc
from .modular import device as MDEV
from .modular import output as modular_output
from .vardct.frame import VarDCTFrame
from .vardct.inputs import FrameConfig, FrameInputs, from_prepared, pack
from .vardct.parse import check_entropy, parse_frame
from .vardct.post import PostConfig


def _read_frame(data: bytes):
    """Container + image header + the frame to decode -> (codestream,
    header, frame header, toc)."""
    if _jpeg_tc.is_constructed(data):
        raise NotImplementedError(
            "JPEG reconstruction container: decode it with "
            "jxl_coder_tpu.api.decode (the port has no JPEG route)")
    c = _container.extract_codestream(data)
    if c.jpeg_reconstruction_data is not None:
        raise NotImplementedError(
            "recompressed JPEG (jbrd): decode it with jxl_coder_tpu.api."
            "decode (the port has no JPEG route)")
    cs = c.codestream
    br = BitReader(cs)
    hdr = read_image_header(br)
    _check_decode_size(hdr)
    if hdr.metadata.animation is not None:
        raise NotImplementedError(
            "animation: decode it with jxl_coder_tpu.api.decode (the "
            "port has no animation route)")
    fh = read_frame_header(br, hdr)
    if fh.frame_type == 1:
        raise NotImplementedError(
            "LF (progressive DC) frame: not in the port's decode slice "
            "(ROADMAP queue 1: with reference-only frames, patches and "
            "splines)")
    if fh.frame_type == 2:
        raise NotImplementedError(
            "reference-only frame (patch source): not in the port's "
            "decode slice (ROADMAP queue 1: with patches and splines)")
    ng, ndc = fh.counts(hdr)
    n = 1 if (ng == 1 and fh.passes.num_passes == 1) else (
        2 + ndc + ng * fh.passes.num_passes)
    toc = read_toc(br, n)
    return cs, hdr, fh, toc


def _frame(data: bytes):
    """_read_frame, its BitstreamError as InvalidJXLError."""
    try:
        return _read_frame(data)
    except BitstreamError as e:
        raise InvalidJXLError(str(e)) from e


def _prepare_vardct(cs, hdr, fh, toc, dev, entropy: str):
    try:
        state = parse_frame(cs, hdr, fh, toc, entropy=entropy, device=dev)
        lf = state["lf"]
        ec = (MDEV.undo_frame(lf.mfd.planes(), dev) if lf.mfd is not None
              else None)
    except BitstreamError as e:
        raise InvalidJXLError(str(e)) from e
    post = PostConfig.of(lf, fh, hdr, state["h"], state["w"])
    return from_prepared(*pack(state), dev, post, ec)


def prepare(data: bytes, device="cuda", entropy: str = "host"
            ) -> Tuple[FrameConfig, FrameInputs, ImageHeader]:
    """The host half of a VarDCT decode: bytes -> (the frame's
    configuration, its inputs on `device`, the image header).  entropy:
    "host" or "device", where the AC pass groups are entropy-decoded.  A
    Modular frame raises NotImplementedError: decode it with ``decode``."""
    check_entropy(entropy)
    dev = resolve_device(device)
    cs, hdr, fh, toc = _frame(data)
    if fh.encoding == Encoding.MODULAR:
        raise NotImplementedError(
            "Modular frame: prepare is the VarDCT host half; decode it with "
            "jxl_coder_tpu_torch.api.decode")
    cfg, inputs = _prepare_vardct(cs, hdr, fh, toc, dev, entropy)
    return cfg, inputs, hdr


def _decode_modular(cs, hdr, fh, toc, dev, entropy: str) -> torch.Tensor:
    """A Modular frame -> (H, W, C) pixels on `dev`."""
    if entropy != "host":
        raise NotImplementedError(
            "entropy='device' on a Modular frame: the reference decodes "
            "Modular channels on the host (jxl_coder_tpu/modular/device.py:1-16"
            ", after the negative result of research/entropy_batch_probe.py)")
    if hdr.metadata.icc_profile is not None:
        raise NotImplementedError(
            "embedded ICC profile: the port has no ICC-to-sRGB transform "
            "(the reference's needs PIL's littlecms)")
    try:
        raw, dc_quant = decode_modular_frame(cs, hdr, fh, toc)
        planes = MDEV.undo_frame(raw, dev)
    except BitstreamError as e:
        raise InvalidJXLError(str(e)) from e
    return modular_output.modular_pixels(planes, hdr, fh, dc_quant)


def decode(data: bytes, device="cuda", entropy: str = "host"
           ) -> Tuple[np.ndarray, BasicInfo]:
    """Decode a still to (pixels, BasicInfo), as jxl_coder_tpu.api.decode
    returns them: a VarDCT frame (H, W, 3 + its extra channels), a
    Modular frame (H, W, C) with C in {1, 3, 4}; uint8 at 8 bits per
    sample or less, uint16 above.  The device half runs on `device`
    ("cuda" raises when no card is present); entropy="device" decodes a
    VarDCT frame's AC pass groups there too (on the CPU, with the
    kernel's plain twin)."""
    check_entropy(entropy)
    dev = resolve_device(device)
    cs, hdr, fh, toc = _frame(data)
    if fh.encoding == Encoding.MODULAR:
        pixels = _decode_modular(cs, hdr, fh, toc, dev, entropy)
    else:
        cfg, inputs = _prepare_vardct(cs, hdr, fh, toc, dev, entropy)
        pixels = VarDCTFrame(cfg)(inputs)
    return (apply_orientation(pixels.cpu().numpy(),
                              hdr.metadata.orientation),
            basic_info(data))
