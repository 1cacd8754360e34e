"""Public decode entry points of the PyTorch port.

``decode(data, device="cuda")`` decodes a VarDCT or a Modular still;
``decode_batch(datas, device="cuda")`` decodes many, the host half of
each on a worker pool while the card reconstructs earlier ones
(``batch.py``).  Each decode is ``host_half`` (bytes -> numpy arrays)
then ``device_half`` (those arrays -> pixels on the device).
Its container, header and TOC walk is that of
``jxl_coder_tpu.api.decode`` (``api.py:505-542``) over the port's own
host layers (``host/``).

A VarDCT frame: the host half runs the host parse (``vardct.parse``)
and the family packing (``vardct.inputs.pack``); the device half carries
them onto the named device (``prepare`` returns them there) with the
frame's post stages (``vardct.post.PostConfig``) and its extra channels'
planes, then runs the frame reconstruction (``vardct.frame.VarDCTFrame``):
synthesis, the filters, then noise, 2x/4x/8x upsampling and the output
encoding (sRGB, a gamma, PQ, HLG or another signalled transfer
function, a non-sRGB gamut), and the extra channels (alpha) after the
colour.
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

from typing import List, NamedTuple, Optional, Sequence, Tuple

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
from .host.modular.frame import ModularPlanes
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


class VarDCTHost(NamedTuple):
    """A VarDCT frame's host half: the image header, the family packing
    (``vardct.inputs.pack``: numpy arrays; on entropy="device" each
    family's coefficients are a tensor already on the device, made on the
    parsing thread's current stream), the post stages and the extra
    channels' raw planes (numpy, every transform still to undo)."""
    hdr: ImageHeader
    static: dict
    args: tuple
    post: PostConfig
    ec: Optional[ModularPlanes]


class ModularHost(NamedTuple):
    """A Modular frame's host half: its raw channel planes (numpy, every
    transform still to undo) and the LfGlobal DC dequant factors."""
    hdr: ImageHeader
    fh: object
    planes: ModularPlanes
    dc_quant: object


def _host_vardct(cs, hdr, fh, toc, dev, entropy: str) -> VarDCTHost:
    try:
        state = parse_frame(cs, hdr, fh, toc, entropy=entropy, device=dev)
    except BitstreamError as e:
        raise InvalidJXLError(str(e)) from e
    lf = state["lf"]
    post = PostConfig.of(lf, fh, hdr, state["h"], state["w"])
    static, args = pack(state)
    return VarDCTHost(hdr, static, args, post,
                      lf.mfd.planes() if lf.mfd is not None else None)


def _host_modular(cs, hdr, fh, toc, entropy: str) -> ModularHost:
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
    except BitstreamError as e:
        raise InvalidJXLError(str(e)) from e
    return ModularHost(hdr, fh, raw, dc_quant)


def host_half(data: bytes, dev: torch.device, entropy: str = "host"):
    """A still's host half: bytes -> VarDCTHost or ModularHost.  It reads
    the container, the headers and the TOC, then parses and packs a
    VarDCT frame (its AC pass groups on `dev` with entropy="device") or
    decodes a Modular frame's channels."""
    cs, hdr, fh, toc = _frame(data)
    if fh.encoding == Encoding.MODULAR:
        return _host_modular(cs, hdr, fh, toc, entropy)
    return _host_vardct(cs, hdr, fh, toc, dev, entropy)


def _vardct_inputs(host: VarDCTHost, dev, put=None
                   ) -> Tuple[FrameConfig, FrameInputs]:
    """The host half's arrays on `dev` (put: how a numpy array gets there,
    vardct.inputs.from_prepared), the extra channels undone there."""
    try:
        ec = (MDEV.undo_frame(host.ec, dev, put) if host.ec is not None
              else None)
    except BitstreamError as e:
        raise InvalidJXLError(str(e)) from e
    return from_prepared(host.static, host.args, dev, host.post, ec, put)


def device_half(host, dev: torch.device, put=None) -> torch.Tensor:
    """A host half's pixels, (H, W, C) on `dev`, before orientation: the
    frame's arrays uploaded (put: how a numpy array gets there; default a
    plain copy), then the VarDCT reconstruction or the Modular inverse
    transforms and output, on the current stream."""
    if isinstance(host, ModularHost):
        try:
            planes = MDEV.undo_frame(host.planes, dev, put)
        except BitstreamError as e:
            raise InvalidJXLError(str(e)) from e
        return modular_output.modular_pixels(planes, host.hdr, host.fh,
                                             host.dc_quant)
    cfg, inputs = _vardct_inputs(host, dev, put)
    return VarDCTFrame(cfg)(inputs)


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
    cfg, inputs = _vardct_inputs(
        _host_vardct(cs, hdr, fh, toc, dev, entropy), dev)
    return cfg, inputs, hdr


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
    host = host_half(data, dev, entropy)
    pixels = device_half(host, dev)
    return (apply_orientation(pixels.cpu().numpy(),
                              host.hdr.metadata.orientation),
            basic_info(data))


def decode_batch(datas: Sequence[bytes], device="cuda",
                 entropy: str = "host") -> List[np.ndarray]:
    """Decode several stills -> one pixel array per file, in input order,
    each equal to ``decode(data, device, entropy)[0]`` (what
    jxl_coder_tpu.api.decode_batch returns).  The files' host halves run
    on a worker pool while the card reconstructs and downloads earlier
    files (``batch.py``).  A file that ``decode`` raises on raises the
    same exception, its message headed by "datas[i]"; nothing falls back
    to another route."""
    from .batch import decode_batch as run
    return run(datas, device, entropy)
