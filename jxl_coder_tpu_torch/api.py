"""Public decode entry points of the PyTorch port.

``decode(data, device="cuda")`` decodes a VarDCT or a Modular still;
``decode_batch(datas, device="cuda")`` decodes many, the host half of
each on a worker pool while the card reconstructs earlier ones
(``batch.py``).  Each decode is ``host_half`` (bytes -> numpy arrays)
then ``device_half`` (those arrays -> pixels on the device).
Its container, header and frame walk is that of
``jxl_coder_tpu.api.decode`` (``api.py:505-548``) over the port's own
host layers (``host/``): LF frames (progressive DC, any lf_level) and
reference-only frames come first, each decoded to its XYB planes on the
device (``Before``: a Modular one's channels on the host, then its
transforms and the DC dequant scaling on the device; a VarDCT one through
synthesis, kernel 2's f32 output and its own overlay and noise); the
first regular frame is the one decoded.  Its DC comes from the LF frame
of the next level when it has a DC frame, and its patches read the
reference frames' planes.

A VarDCT frame: the host half runs the host parse (``vardct.parse``)
and the family packing (``vardct.inputs.pack``); the device half carries
them onto the named device (``prepare`` returns them there) with the
frame's post stages (``vardct.post.PostConfig``) and its extra channels'
planes, then runs the frame reconstruction (``vardct.frame.VarDCTFrame``):
synthesis, the filters, then the patch and spline overlay
(``vardct/overlay.py``), noise, 2x/4x/8x upsampling and the output
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

A frame whose DC frame or patch sources were not decoded before it raises
InvalidJXLError.  What raises NotImplementedError: a VarDCT frame with
YCbCr; ``entropy="device"`` on a VarDCT frame with extra channels or on a
Modular frame to decode; an embedded ICC profile; animations and the JPEG
routes.  Nothing falls back to the host decoder.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ._device import resolve_device
from .host.api import (BasicInfo, InvalidJXLError, _check_decode_size,
                       apply_orientation, basic_info)
from .host.bitstream import container as _container
from .host.bitstream.frame_header import (Encoding, FrameType,
                                          read_frame_header, read_toc)
from .host.bitstream.headers import ImageHeader, read_image_header
from .host.bitstream.reader import BitReader, BitstreamError
from .host.codec import decode_modular_frame
from .host.jpeg import transcode as _jpeg_tc
from .host.modular.frame import ModularPlanes
from .modular import device as MDEV
from .modular import output as modular_output
from .vardct.frame import VarDCTFrame
from .vardct.inputs import FrameConfig, FrameInputs, from_prepared, pack
from .vardct.parse import DC_FRAME, check_entropy, parse_frame
from .vardct.post import PostConfig


def _read_frames(data: bytes):
    """Container + image header + the frame walk -> (codestream, header,
    [(frame header, toc)]): the LF and reference-only frames in stream
    order, then the frame to decode (the first regular one), as the
    reference walks them (``jxl_coder_tpu/api.py:522-548``)."""
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
    frames = []
    while True:
        fh = read_frame_header(br, hdr)
        ng, ndc = fh.counts(hdr)
        n = 1 if (ng == 1 and fh.passes.num_passes == 1) else (
            2 + ndc + ng * fh.passes.num_passes)
        toc = read_toc(br, n)
        frames.append((fh, toc))
        if fh.frame_type not in (FrameType.LF_FRAME,
                                 FrameType.REFERENCE_ONLY):
            return cs, hdr, frames
        br.pos = toc.end_offset * 8


def _read_frame(data: bytes):
    """_read_frames' frame to decode -> (codestream, header, frame header,
    toc)."""
    cs, hdr, frames = _read_frames(data)
    return (cs, hdr) + frames[-1]


class VarDCTHost(NamedTuple):
    """A VarDCT frame's host half: the image header, the frame header, the
    family packing (``vardct.inputs.pack``: numpy arrays; on
    entropy="device" each family's coefficients are a tensor already on
    the device, made on the parsing thread's current stream), the post
    stages (with the overlay's lists), the extra channels' raw planes
    (numpy, every transform still to undo), and the host halves of the LF
    and reference frames before it (``Before``, in stream order)."""
    hdr: ImageHeader
    fh: object
    static: dict
    args: tuple
    post: PostConfig
    ec: Optional[ModularPlanes]
    before: tuple = ()


class ModularHost(NamedTuple):
    """A Modular frame's host half: its raw channel planes (numpy, every
    transform still to undo), the LfGlobal DC dequant factors, and the host
    halves of the LF and reference frames before it."""
    hdr: ImageHeader
    fh: object
    planes: ModularPlanes
    dc_quant: object
    before: tuple = ()


class Before(NamedTuple):
    """An LF frame (key: its lf_level) or a reference-only frame (key: its
    save_as_reference slot) and its host half, whose XYB planes the frames
    after it read: an LF frame's as their DC, a reference frame's as
    their patches' sources."""
    lf: bool
    key: int
    host: object


def _host_vardct(cs, hdr, fh, toc, dev, entropy: str) -> VarDCTHost:
    try:
        state = parse_frame(cs, hdr, fh, toc, entropy=entropy, device=dev)
    except BitstreamError as e:
        raise InvalidJXLError(str(e)) from e
    lf = state["lf"]
    post = PostConfig.of(lf, fh, hdr, state["h"], state["w"])
    static, args = pack(state)
    return VarDCTHost(hdr, fh, static, args, post,
                      lf.mfd.planes() if lf.mfd is not None else None)


def _host_modular(cs, hdr, fh, toc, entropy: str,
                  xyb: bool = False) -> ModularHost:
    """xyb: an LF or reference frame, whose output is its XYB planes (its
    channels decode on the host on either entropy route; no ICC applies)."""
    if entropy != "host" and not xyb:
        raise NotImplementedError(
            "entropy='device' on a Modular frame: the reference decodes "
            "Modular channels on the host (jxl_coder_tpu/modular/device.py:1-16"
            ", after the negative result of research/entropy_batch_probe.py)")
    if hdr.metadata.icc_profile is not None and not xyb:
        raise NotImplementedError(
            "embedded ICC profile: the port has no ICC-to-sRGB transform "
            "(the reference's needs PIL's littlecms)")
    try:
        raw, dc_quant = decode_modular_frame(cs, hdr, fh, toc)
    except BitstreamError as e:
        raise InvalidJXLError(str(e)) from e
    return ModularHost(hdr, fh, raw, dc_quant)


def _host_one(cs, hdr, fh, toc, dev, entropy: str, xyb: bool = False):
    if fh.encoding == Encoding.MODULAR:
        return _host_modular(cs, hdr, fh, toc, entropy, xyb)
    return _host_vardct(cs, hdr, fh, toc, dev, entropy)


def _check_before(host, lf_levels, ref_sizes) -> None:
    """A frame's DC frame and its patches' sources must be decoded before
    it (lf_levels: the LF frames' levels so far; ref_sizes: slot -> (h, w)
    of the reference frames so far; None for an LF or reference frame,
    which the reference decodes without reference frames)."""
    if isinstance(host, ModularHost):
        return
    fh = host.fh
    if fh.flags & DC_FRAME and fh.lf_level + 1 not in lf_levels:
        raise InvalidJXLError(
            "frame uses a DC frame but none was decoded before it")
    overlay = host.post.overlay
    if overlay is not None and overlay.patches is not None:
        if ref_sizes is None:
            raise InvalidJXLError(
                "frame uses patches but no reference frames were decoded")
        try:
            overlay.check_sources(ref_sizes)
        except BitstreamError as e:
            raise InvalidJXLError(str(e)) from e


def host_half(data: bytes, dev: torch.device, entropy: str = "host"):
    """A still's host half: bytes -> VarDCTHost or ModularHost.  It reads
    the container, the headers and the TOCs, then, frame by frame, parses
    and packs a VarDCT frame (its AC pass groups on `dev` with
    entropy="device") or decodes a Modular frame's channels: the LF and
    reference frames first, then the frame to decode."""
    try:
        cs, hdr, frames = _read_frames(data)
    except BitstreamError as e:
        raise InvalidJXLError(str(e)) from e
    before, lf_levels, ref_sizes = [], set(), {}
    for fh, toc in frames[:-1]:
        h = _host_one(cs, hdr, fh, toc, dev, entropy, xyb=True)
        _check_before(h, lf_levels, None)
        lf = fh.frame_type == FrameType.LF_FRAME
        key = fh.lf_level if lf else fh.save_as_reference
        if lf:
            lf_levels.add(key)
        else:
            w, ht = fh.coded_size(hdr)
            ref_sizes[key] = (ht, w)
        before.append(Before(lf, key, h))
    fh, toc = frames[-1]
    host = _host_one(cs, hdr, fh, toc, dev, entropy)
    _check_before(host, lf_levels, ref_sizes)
    return host._replace(before=tuple(before))


def _vardct_inputs(host: VarDCTHost, dev, put=None, dc_frames=None,
                   refs=None) -> Tuple[FrameConfig, FrameInputs]:
    """The host half's arrays on `dev` (put: how a numpy array gets there,
    vardct.inputs.from_prepared), the extra channels undone there; a frame
    with a DC frame takes its DC from dc_frames (lf_level -> the LF
    frames' XYB planes on `dev`), edge-replicated to its block grid, and
    its patches read refs (slot -> the reference frames' planes)."""
    try:
        ec = (MDEV.undo_frame(host.ec, dev, put) if host.ec is not None
              else None)
    except BitstreamError as e:
        raise InvalidJXLError(str(e)) from e
    cfg, inputs = from_prepared(host.static, host.args, dev, host.post, ec,
                                put)
    if host.fh.flags & DC_FRAME:
        inputs.dc = dc_from_frame(dc_frames[host.fh.lf_level + 1],
                                  cfg.H8 // 8, cfg.W8 // 8)
    inputs.refs = refs
    return cfg, inputs


def dc_from_frame(planes: torch.Tensor, ys_b: int, xs_b: int
                  ) -> torch.Tensor:
    """An LF frame's (3, h, w) XYB planes -> the (3, ys_b, xs_b) DC of the
    frame that uses them: the block grid may be one sample wider or taller
    than the LF frame, so the last row and column repeat
    (host/vardct/dec_real.py dc_from_frame)."""
    h, w = planes.shape[1:]
    iy = torch.clamp(torch.arange(ys_b, device=planes.device), max=h - 1)
    ix = torch.clamp(torch.arange(xs_b, device=planes.device), max=w - 1)
    return planes[:, iy][:, :, ix].contiguous()


def _xyb(host, dev, put, dc_frames) -> torch.Tensor:
    """An LF or reference frame's (3, h, w) f32 XYB planes on `dev`."""
    if isinstance(host, ModularHost):
        try:
            planes = MDEV.undo_frame(host.planes, dev, put)
        except BitstreamError as e:
            raise InvalidJXLError(str(e)) from e
        return modular_output.xyb_planes(planes, host.dc_quant)
    cfg, inputs = _vardct_inputs(host, dev, put, dc_frames)
    return VarDCTFrame(cfg).xyb(inputs)


def _device_before(host, dev, put=None):
    """The XYB planes of the LF and reference frames before the frame, on
    `dev`, in stream order -> (lf_level -> planes, slot -> planes)."""
    dc_frames, refs = {}, {}
    for b in host.before:
        planes = _xyb(b.host, dev, put, dc_frames)
        (dc_frames if b.lf else refs)[b.key] = planes
    return dc_frames, refs


def device_half(host, dev: torch.device, put=None) -> torch.Tensor:
    """A host half's pixels, (H, W, C) on `dev`, before orientation: the
    LF and reference frames before the frame reconstructed to their XYB
    planes, then the frame's arrays uploaded (put: how a numpy array gets
    there; default a plain copy), then the VarDCT reconstruction or the
    Modular inverse transforms and output, on the current stream.  A
    Modular frame reads no LF or reference frame (as the reference)."""
    dc_frames, refs = _device_before(host, dev, put)
    if isinstance(host, ModularHost):
        try:
            planes = MDEV.undo_frame(host.planes, dev, put)
        except BitstreamError as e:
            raise InvalidJXLError(str(e)) from e
        return modular_output.modular_pixels(planes, host.hdr, host.fh,
                                             host.dc_quant)
    cfg, inputs = _vardct_inputs(host, dev, put, dc_frames, refs)
    return VarDCTFrame(cfg)(inputs)


def prepare(data: bytes, device="cuda", entropy: str = "host"
            ) -> Tuple[FrameConfig, FrameInputs, ImageHeader]:
    """The host half of a VarDCT decode: bytes -> (the frame's
    configuration, its inputs on `device`, the image header); the LF and
    reference frames before the frame are decoded on `device` (its DC and
    its patches' sources are in the inputs).  entropy: "host" or "device",
    where the AC pass groups are entropy-decoded.  A Modular frame raises
    NotImplementedError: decode it with ``decode``."""
    check_entropy(entropy)
    dev = resolve_device(device)
    host = host_half(data, dev, entropy)
    if isinstance(host, ModularHost):
        raise NotImplementedError(
            "Modular frame: prepare is the VarDCT host half; decode it with "
            "jxl_coder_tpu_torch.api.decode")
    dc_frames, refs = _device_before(host, dev)
    cfg, inputs = _vardct_inputs(host, dev, None, dc_frames, refs)
    return cfg, inputs, host.hdr


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
