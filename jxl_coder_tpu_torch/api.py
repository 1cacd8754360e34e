"""Public decode entry point of the PyTorch port.

``decode(data, device="cuda")`` decodes a VarDCT still.  Its host half,
``prepare``, is the container, header and TOC walk of
``jxl_coder_tpu.api.decode`` (``api.py:505-542``) over the port's
own host layers (``host/``), the host parse
(``vardct.parse``) and the family packing (``vardct.inputs.pack``),
carried onto the named device; then the frame reconstruction runs there
(``vardct.frame.VarDCTFrame``).  ``entropy="device"`` decodes the AC pass
groups on the device too (``entropy/device.py``), from the codestream's
bytes; the default, "host", decodes them with the host codec.  A group
the device decode finds corrupt raises InvalidJXLError.
Streams outside the slice raise NotImplementedError naming the route
they need; nothing falls back to the host decoder.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ._device import resolve_device
from .host.api import (BasicInfo, InvalidJXLError, _check_decode_size,
                       apply_orientation, basic_info)
from .host.bitstream import container as _container
from .host.bitstream.frame_header import (Encoding, read_frame_header,
                                          read_toc)
from .host.bitstream.headers import ImageHeader, read_image_header
from .host.bitstream.reader import BitReader, BitstreamError
from .host.jpeg import transcode as _jpeg_tc
from .vardct.frame import VarDCTFrame
from .vardct.inputs import FrameConfig, FrameInputs, from_prepared, pack
from .vardct.parse import check_entropy, parse_frame


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
            "LF (progressive DC) frame: not in the port's decode slice")
    if fh.frame_type == 2:
        raise NotImplementedError(
            "reference-only frame (patch source): not in the port's "
            "decode slice")
    if fh.encoding == Encoding.MODULAR:
        raise NotImplementedError(
            "Modular frame: decode it with jxl_coder_tpu.api.decode (the "
            "port has no Modular route)")
    ng, ndc = fh.counts(hdr)
    n = 1 if (ng == 1 and fh.passes.num_passes == 1) else (
        2 + ndc + ng * fh.passes.num_passes)
    toc = read_toc(br, n)
    return cs, hdr, fh, toc


def prepare(data: bytes, device="cuda", entropy: str = "host"
            ) -> Tuple[FrameConfig, FrameInputs, ImageHeader]:
    """The host half of decode: bytes -> (the frame's configuration, its
    inputs on `device`, the image header).  entropy: "host" or "device",
    where the AC pass groups are entropy-decoded."""
    check_entropy(entropy)
    dev = resolve_device(device)
    try:
        cs, hdr, fh, toc = _read_frame(data)
        state = parse_frame(cs, hdr, fh, toc, entropy=entropy, device=dev)
    except BitstreamError as e:
        raise InvalidJXLError(str(e)) from e
    cfg, inputs = from_prepared(*pack(state), dev)
    return cfg, inputs, hdr


def decode(data: bytes, device="cuda", entropy: str = "host"
           ) -> Tuple[np.ndarray, BasicInfo]:
    """Decode a VarDCT still to (pixels, BasicInfo); pixels are (H, W, 3)
    uint8, or uint16 above 8 bits per sample, as jxl_coder_tpu.api.decode
    returns them.  The device half runs on `device` ("cuda" raises when
    no card is present); entropy="device" decodes the AC pass groups
    there too (on the CPU, with the kernel's plain twin)."""
    cfg, inputs, hdr = prepare(data, device, entropy)
    pixels = VarDCTFrame(cfg)(inputs).cpu().numpy()
    return (apply_orientation(pixels, hdr.metadata.orientation),
            basic_info(data))
