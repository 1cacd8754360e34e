"""Public encode and decode entry points of the PyTorch port.

``encode(pixels, lossless=..., device="cuda")`` writes a bare JXL
codestream as ``jxl_coder_tpu.api.encode`` does (``api.py:197-438``):
lossless Modular on the host (the effort ladder 1-10, the palette body,
an embedded ICC profile), lossy VarDCT with the encoder front on the
device (``vardct/enc_device.Front``: E1-E4 and the winners' gather,
``csrc/encode.cu``; a frame with a signalled ``colour`` converts on the
host; an ICC profile's pixels converted to sRGB on the device first,
``ops/icc_apply.py``); ``gif_to_jxl`` / ``apng_to_jxl`` go through
``animation.AnimatedEncoder`` (PIL reads the source).  ``is_jxl``,
``get_size`` and ``basic_info`` probe a stream on the host.
``decode(data, device="cuda")`` decodes a VarDCT or a Modular still (or
an animation's last frame, a recompressed JPEG, or what arrived of a
stream cut short); ``construct`` / ``reconstruct_jpeg`` recompress a JPEG
and give it back;
``decode_batch(datas, device="cuda")`` decodes many, the host half of
each on a worker pool while the card reconstructs earlier ones
(``batch.py``); ``decode_sampled(data, width, height, ...)`` decodes at a
target size and pixel format, ``decode_thumbnail`` at 1/8 and
``_decode_downsampled`` at 1/4 (the sampled decode, below).  Each decode
is ``host_half`` (bytes -> numpy arrays) then ``device_half`` (those
arrays -> pixels on the device).
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
InvalidJXLError, as the host does.  A Modular still with an embedded ICC
profile is converted to sRGB on the device before its orientation, as the
reference converts it with littlecms (``jxl_coder_tpu/api.py:563-568``):
``ops/icc_apply.py`` over ``csrc/icc.cu``, the profile read on the host
(``host/ops/icc.py``); a VarDCT still and an animation's frames keep
their pixels, as there (ROADMAP R22).

The sampled decode (``jxl_coder_tpu/api.py:1043-1214``), on the device
from the decode to one download at the end:
- ``decode_thumbnail``: a VarDCT frame without upsampling decodes its DC
  image only (``vardct.parse.parse_frame(dc_only=True)``: no HF global, no
  pass group; with a DC frame the LF frame's planes), then the output
  encoding (kernel 2's output step for sRGB, A7 otherwise): the colour at
  ceil(size / 8), patches, splines, noise and extra channels left out, as
  the reference does.  Any other frame decodes whole, then S2
  (``ops/sample.py``) averages its codes over 8 x 8 cells.
- ``_decode_downsampled(data, 4)``: an eligible still (one regular
  VarDCT frame that is the last, no animation, extra channels, ICC
  profile or orientation) decodes whole with the post stages' ``down``
  pool before the output encoding (S1, ``vardct/post.py``); any other
  returns None, decided from the headers.
- ``decode_sampled``: the reference's routing (a target within 1/8 of
  the size takes the thumbnail, within 1/4 the quarter route, else a full
  decode), then, on the card, the rescale (S3, ``ops/resize.py``), the
  HDR -> SDR tone map for an SDR format, grey to RGB, an opaque alpha and
  the packing (S4, ``ops/pack.py`` with ``ops/tone.py``), then one
  download.  Orientation applies to the device tensor before the rescale.

Animations, progressive and truncated streams
(``jxl_coder_tpu/api.py:512-521,573-678,804-1041``):
- ``decode`` of an animated stream returns its last composed frame
  (``animation.AnimatedImage``); ``decode_frames`` returns every shown
  frame, each cropped or blended frame composed on the device onto a copy
  of its blending source's slot (A10, ``ops/compose.py``: the five blend
  modes, clamp, associated alpha, each extra channel's own blending), the
  slots, LF planes and reference frames' XYB planes kept on the device,
  one download per shown frame; ``decode_thumbnail`` / ``decode_sampled``
  decode it whole (then S2 / S3); ``decode_batch`` decodes it on a worker.
- ``decode_preview(data, passes)`` decodes the first `passes` AC passes of
  a multi-pass VarDCT still (``parse_frame(max_passes=...)``); any other
  stream decodes whole.
- A stream cut short (``toc.end_offset`` past its bytes, LF global, LF
  groups and HF global whole) renders what arrived (``_decode_partial``):
  the AC passes that arrived whole, or the DC image resized to the frame
  on the device (S3, Catmull-Rom); anything else raises InvalidJXLError.

Recompressed JPEGs (``jxl_coder_tpu/api.py:441-504,1217-1248``), in the
reference's order: a round-1 private container (jbrd + jxcf boxes) and a
chroma-subsampled frame with a jbrd box read their coefficients on the
host (``jpeg/transcode.py``, ``jpeg/wire.py``), then two launches on the
device (``jpeg/pixels.py``: J1, the block IDCT; J2, the chroma upsampling
and YCbCr -> RGB, each route by the reference's rules), with the
BasicInfo the reference makes up and no orientation; a 4:4:4 or grey
frame is a VarDCT frame whose output step is A7's "ycbcr" case.
``construct`` and ``reconstruct_jpeg`` are host code.

A frame whose DC frame or patch sources were not decoded before it raises
InvalidJXLError.  What raises NotImplementedError: a chroma-subsampled
YCbCr frame without a jbrd box; ``entropy="device"`` on a VarDCT frame
with extra channels or on a Modular frame to decode; an ICC profile that
littlecms would apply by a lookup table (``A2B0``) or with black-point
compensation of a nonzero black, on a Modular still.  Nothing falls back
to the host decoder.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ._device import resolve_device
from .host.api import (BasicInfo, InvalidJXLError, PreferredColorConfig,
                       ResizeFilter, ScaleMode, _check_decode_size,
                       apply_orientation, basic_info, get_size, is_jxl,
                       parse_header)
from .host.bitstream import container as _container
from .host.bitstream.frame_header import (BlendMode, Encoding, FrameType,
                                          read_frame_header, read_toc)
from .host.bitstream.headers import ImageHeader, read_image_header
from .host.bitstream.reader import BitReader, BitstreamError
from .host.codec import decode_modular_frame
from .host.jpeg import transcode as _jpeg_tc
from .host.jpeg import wire as _jpeg_wire
from .host.jpeg.parser import JpegError
from .host.modular.frame import ModularPlanes
from .host.ops.color import is_hdr_encoding
from .host.vardct.dec_real import jpeg_shifts
from .jpeg import pixels as JPX
from .jpeg import transcode as JTC
from .jpeg import wire as JWIRE
from .modular import device as MDEV
from .modular import output as modular_output
from .ops import compose as COMPOSE
from .ops import icc_apply as ICC
from .ops import pack as PACK
from .ops import tone as TONE
from .ops.resize import rescale_image
from .ops.sample import box_codes
from .vardct.frame import VarDCTFrame
from .vardct.inputs import FrameConfig, FrameInputs, from_prepared, pack
from .vardct.parse import DC_FRAME, check_entropy, parse_frame
from .vardct.post import PostConfig, encode_output, output_spec


def _read_frames(data: bytes):
    """Container + image header + the frame walk -> (codestream, header,
    [(frame header, toc)]): the LF and reference-only frames in stream
    order, then the frame to decode (the first regular one), as the
    reference walks them (``jxl_coder_tpu/api.py:522-548``)."""
    cs = _container.extract_codestream(data).codestream
    br = BitReader(cs)
    hdr = read_image_header(br)
    _check_decode_size(hdr)
    frames = []
    while True:
        fh = read_frame_header(br, hdr)
        toc = read_toc(br, _toc_count(hdr, fh))
        frames.append((fh, toc))
        if fh.frame_type not in (FrameType.LF_FRAME,
                                 FrameType.REFERENCE_ONLY):
            return cs, hdr, frames
        br.pos = toc.end_offset * 8


def _toc_count(hdr, fh) -> int:
    """The frame's TOC entries: one for a single-group, single-pass frame,
    else LF global, the LF groups, HF global and the pass groups."""
    ng, ndc = fh.counts(hdr)
    if ng == 1 and fh.passes.num_passes == 1:
        return 1
    return 2 + ndc + ng * fh.passes.num_passes


def _first_frame(data: bytes):
    """Container + image header + the first frame's header and TOC ->
    (codestream, header, frame header, toc); raises BitstreamError."""
    cs = _container.extract_codestream(data).codestream
    br = BitReader(cs)
    hdr = read_image_header(br)
    _check_decode_size(hdr)
    fh = read_frame_header(br, hdr)
    return cs, hdr, fh, read_toc(br, _toc_count(hdr, fh))


def _animated(data: bytes) -> bool:
    """Whether the stream signals an animation, whose frames compose (a
    JPEG reconstruction container is not one)."""
    if _jpeg_tc.is_constructed(data):
        return False
    return parse_header(data).metadata.animation is not None


def _read_frame(data: bytes):
    """_read_frames' frame to decode -> (codestream, header, frame header,
    toc)."""
    cs, hdr, frames = _read_frames(data)
    return (cs, hdr) + frames[-1]


# ---- the JPEG routes (jxl_coder_tpu/api.py:441-504,1217-1248) ----------

def _subsampled_jpeg(data: bytes) -> bool:
    """The reference's _subsampled_jpeg_probe without its render: a
    recompressed JPEG (jbrd box) whose frame has chroma subsampling."""
    try:
        c = _container.extract_codestream(data)
        if c.jpeg_reconstruction_data is None:
            return False
        br = BitReader(c.codestream)
        hdr = read_image_header(br)
        return jpeg_shifts(read_frame_header(br, hdr)) is not None
    except BitstreamError:
        return False


def _jpeg_host(data: bytes) -> Optional[JPX.JpegPlanes]:
    """The host half of routes 2 and 3, in the reference's order: a
    round-1 container, then a subsampled recompressed JPEG; None for any
    other file (a 4:4:4 recompressed JPEG is a VarDCT frame, route 1)."""
    if _jpeg_tc.is_constructed(data):
        read = JTC.host_planes
    elif _subsampled_jpeg(data):
        read = JWIRE.host_planes
    else:
        return None
    try:
        return read(data)
    except (JpegError, BitstreamError) as e:
        raise InvalidJXLError(str(e)) from e


def jpeg_info(host: JPX.JpegPlanes) -> BasicInfo:
    """The BasicInfo that routes 2 and 3 make up, as the reference's
    (8 bits, no alpha, orientation 1: none is applied)."""
    return BasicInfo(xsize=host.width, ysize=host.height, bits_per_sample=8,
                     float_samples=False, alpha=False,
                     alpha_premultiplied=False, orientation=1,
                     have_animation=False, intensity_target=255.0,
                     uses_original_profile=True)


def construct(jpeg_data: bytes) -> bytes:
    """Lossless JPEG -> JXL (the reference's Convenience.construct): the
    standard wire format (a jbrd box and a do_ycbcr VarDCT frame), or the
    round-1 private container for a JPEG the wire format rejects; host
    code.  A JPEG neither takes raises InvalidJXLError."""
    try:
        try:
            return _jpeg_wire.construct(jpeg_data)
        except JpegError:
            return _jpeg_tc.construct(jpeg_data)
    except JpegError as e:
        raise InvalidJXLError(str(e)) from e


def reconstruct_jpeg(data: bytes) -> bytes:
    """JXL -> the byte-identical original JPEG (the reference's
    Convenience.reconstructJPEG), from a standard recompressed file or a
    round-1 container; host code.  Any other file raises
    InvalidJXLError."""
    try:
        if _jpeg_tc.is_constructed(data):
            return _jpeg_tc.reconstruct(data)
        return _jpeg_wire.reconstruct(data)
    except (JpegError, BitstreamError) as e:
        raise InvalidJXLError(str(e)) from e


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


def _host_vardct(cs, hdr, fh, toc, dev, entropy: str,
                 max_passes: int = None) -> VarDCTHost:
    try:
        state = parse_frame(cs, hdr, fh, toc, entropy=entropy, device=dev,
                            max_passes=max_passes)
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
    """A still's host half: bytes -> VarDCTHost, ModularHost or, for a
    round-1 container or a subsampled recompressed JPEG, JpegPlanes (its
    coefficients read on the host on either entropy route).  It reads
    the container, the headers and the TOCs, then, frame by frame, parses
    and packs a VarDCT frame (its AC pass groups on `dev` with
    entropy="device") or decodes a Modular frame's channels: the LF and
    reference frames first, then the frame to decode."""
    jpeg = _jpeg_host(data)
    if jpeg is not None:
        return jpeg
    try:
        cs, hdr, frames = _read_frames(data)
    except BitstreamError as e:
        raise InvalidJXLError(str(e)) from e
    if hdr.metadata.animation is not None:
        raise NotImplementedError(
            "host_half decodes a still: an animation's frames compose "
            "(decode, decode_frames or animation.AnimatedImage)")
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
    Modular frame reads no LF or reference frame (as the reference), and
    its embedded ICC profile converts its pixels to sRGB (``ops/
    icc_apply.py``); a JpegPlanes runs J1 and J2 (``jpeg/pixels.py``)."""
    if isinstance(host, JPX.JpegPlanes):
        return JPX.pixels(host, dev, put)
    dc_frames, refs = _device_before(host, dev, put)
    pixels = _frame_device(host, dev, dc_frames, refs, put)
    icc = host.hdr.metadata.icc_profile
    if isinstance(host, ModularHost) and icc is not None:
        pixels = ICC.icc_to_srgb(pixels, icc)
    return pixels


def _frame_device(host, dev, dc_frames: dict, refs: dict, put=None
                  ) -> torch.Tensor:
    """A frame's pixels from its host half, its DC from dc_frames (lf_level
    -> XYB planes on `dev`) and its patches from refs (slot -> XYB planes),
    at the frame's own size (frame_width x frame_height, its upsampling
    applied), on the current stream."""
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
    where the AC pass groups are entropy-decoded.  A Modular frame, or a
    JPEG whose coefficients the JPEG routes read (a subsampled one or the
    round-1 container), raises NotImplementedError: decode it with
    ``decode``."""
    check_entropy(entropy)
    dev = resolve_device(device)
    host = host_half(data, dev, entropy)
    if not isinstance(host, VarDCTHost):
        raise NotImplementedError(
            "Modular frame, or a subsampled or round-1 recompressed JPEG: "
            "prepare is the VarDCT host half; decode it with "
            "jxl_coder_tpu_torch.api.decode")
    dc_frames, refs = _device_before(host, dev)
    cfg, inputs = _vardct_inputs(host, dev, None, dc_frames, refs)
    return cfg, inputs, host.hdr


def decode(data: bytes, device="cuda", entropy: str = "host"
           ) -> Tuple[np.ndarray, BasicInfo]:
    """Decode a still to (pixels, BasicInfo), as jxl_coder_tpu.api.decode
    returns them: a VarDCT frame (H, W, 3 + its extra channels), a
    Modular frame (H, W, C), its 1 or 3 colour channels and its extra
    channels; uint8 at 8 bits per
    sample or less, uint16 above.  A Modular still's embedded ICC profile
    converts it to sRGB on `device` (a grey still then has 3 channels,
    ROADMAP R21).  The device half runs on `device`
    ("cuda" raises when no card is present); entropy="device" decodes a
    VarDCT frame's AC pass groups there too (on the CPU, with the
    kernel's plain twin).  An animation decodes to its last composed
    frame; a stream cut short renders what arrived (_decode_partial) or
    raises InvalidJXLError."""
    check_entropy(entropy)
    dev = resolve_device(device)
    if _animated(data):
        from .animation import AnimatedImage
        img = AnimatedImage(data, dev, entropy)
        last = img.get_frame(img.frames_count - 1)
        return (apply_orientation(last, img.image_header.metadata.orientation),
                basic_info(data))
    try:
        host = host_half(data, dev, entropy)
    except InvalidJXLError as e:
        return _partial_or_raise(data, dev, entropy, e)
    pixels = device_half(host, dev)
    if isinstance(host, JPX.JpegPlanes):
        return pixels.cpu().numpy(), jpeg_info(host)
    return (apply_orientation(pixels.cpu().numpy(),
                              host.hdr.metadata.orientation),
            basic_info(data))


def orientation_of(host) -> int:
    """The orientation that applies to a host half's pixels (none on the
    JPEG routes 2 and 3, as the reference)."""
    if isinstance(host, JPX.JpegPlanes):
        return 1
    return host.hdr.metadata.orientation


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


# ---- animation, progressive and truncated decode -------------------------
# (jxl_coder_tpu/api.py:573-678,804-1041)

def _frame_xyb(cs, hdr, fh, toc, dev, entropy: str, dc_frames: dict
               ) -> torch.Tensor:
    """An LF frame's or a reference frame's (3, h, w) XYB planes on `dev`
    (the reference's _decode_lf_frame / _decode_reference_frame), its DC
    from the LF frames decoded before it."""
    host = _host_one(cs, hdr, fh, toc, dev, entropy, xyb=True)
    _check_before(host, set(dc_frames), None)
    return _xyb(host, dev, None, dc_frames)


def _decode_one_frame(cs, hdr, fh, toc, dev, entropy: str,
                      dc_frames: dict, refs: dict) -> torch.Tensor:
    """One frame's codes, (h, w, C) on `dev` at the frame's own size, not
    oriented (``jxl_coder_tpu/api.py:804-818``): its host half, checked
    against the LF frames (lf_level -> planes) and the reference frames
    (slot -> planes) decoded before it, then its device half."""
    host = _host_one(cs, hdr, fh, toc, dev, entropy)
    _check_before(host, set(dc_frames),
                  {k: tuple(v.shape[1:]) for k, v in refs.items()}
                  if refs else None)
    return _frame_device(host, dev, dc_frames, refs)


def _canvas(base: Optional[torch.Tensor], pix: torch.Tensor, hdr
            ) -> torch.Tensor:
    """The canvas a cropped or blended frame composes onto: a copy of its
    blending source's slot, or zeros of the image's size."""
    if base is None:
        return torch.zeros((hdr.ysize, hdr.xsize, pix.shape[2]),
                           dtype=pix.dtype, device=pix.device)
    return base.clone(memory_format=torch.contiguous_format)


def _compose_frame(canvas: torch.Tensor, pix: torch.Tensor, fh, m) -> None:
    """Blend the frame's pixels onto the canvas in place
    (``jxl_coder_tpu/api.py:821-961``): its window clipped on the host,
    then one launch of A10 (``ops/compose.py``)."""
    win = COMPOSE.window(canvas.shape[:2], pix.shape[:2], fh.x0, fh.y0)
    if win is not None:
        COMPOSE.compose(canvas, pix, win,
                        COMPOSE.blend_params(fh, m, pix.shape[2]))


def _full_frame(fh, pix: torch.Tensor, hdr) -> bool:
    """The composition walk's test of a frame that replaces the whole
    canvas (``api.py:1013-1016``, ``animation.py:172-174``)."""
    return (not fh.have_crop and pix.shape[0] >= hdr.ysize
            and pix.shape[1] >= hdr.xsize
            and fh.blending_info.mode == BlendMode.REPLACE)


@dataclasses.dataclass
class _Slots:
    """The composition walk's state, on the device: the saved slots (slot
    -> (H, W, C) codes), the LF frames' planes (lf_level -> XYB) and the
    reference frames' XYB planes (slot -> planes)."""
    ref_slots: dict = dataclasses.field(default_factory=dict)
    dc: dict = dataclasses.field(default_factory=dict)
    ref_xyb: dict = dataclasses.field(default_factory=dict)


def _compose_step(cs, hdr, fh, toc, dev, entropy: str, st: _Slots
                  ) -> Optional[torch.Tensor]:
    """One frame of the composition walk, decode_frames' and the
    AnimatedImage cursor's (``api.py:990-1028``, ``animation.py:155-187``):
    an LF frame's planes go to st.dc and a patch source's to st.ref_xyb
    (-> None); a reference-only frame's codes go to its slot as they are
    (-> them); any other frame is composed onto its canvas, a copy of its
    blending source's slot (A10), which is saved to its slot unless the
    frame is the last (-> the canvas)."""
    if fh.frame_type == FrameType.LF_FRAME:
        st.dc[fh.lf_level] = _frame_xyb(cs, hdr, fh, toc, dev, entropy, st.dc)
        return None
    ref_only = fh.frame_type == FrameType.REFERENCE_ONLY
    if ref_only and fh.save_before_color_transform:
        st.ref_xyb[fh.save_as_reference] = _frame_xyb(cs, hdr, fh, toc, dev,
                                                      entropy, st.dc)
        return None
    pix = _decode_one_frame(cs, hdr, fh, toc, dev, entropy, st.dc,
                            st.ref_xyb)
    if ref_only:
        st.ref_slots[fh.save_as_reference] = pix
        return pix
    if _full_frame(fh, pix, hdr):
        canvas = pix[:hdr.ysize, :hdr.xsize]
    else:
        canvas = _canvas(st.ref_slots.get(fh.blending_info.source), pix, hdr)
        _compose_frame(canvas, pix, fh, hdr.metadata)
    if not fh.is_last:
        st.ref_slots[fh.save_as_reference] = canvas
    return canvas


def decode_frames(data: bytes, device="cuda", entropy: str = "host"):
    """Every shown frame of a (possibly animated) stream -> (frames,
    durations, BasicInfo), as jxl_coder_tpu.api.decode_frames returns
    them: (H, W, C) arrays in display order, oriented, each cropped or
    blended frame composed on the card over its blending source's slot
    (A10) and saved back to its save_as_reference slot; durations in
    animation ticks.  A frame is shown when it is regular (or
    skip-progressive) and has a duration, or is the last, or the stream
    has no animation.  The slots, LF planes and reference frames' XYB
    planes stay on `device`; each shown frame is downloaded once.  A
    subsampled recompressed JPEG is its one frame by the JPEG route (the
    reference reads it with one block grid and raises, ROADMAP R17)."""
    check_entropy(entropy)
    dev = resolve_device(device)
    if _subsampled_jpeg(data):
        pixels, info = decode(data, dev, entropy)
        return [pixels], [0], info
    try:
        cs = _container.extract_codestream(data).codestream
        br = BitReader(cs)
        hdr = read_image_header(br)
        _check_decode_size(hdr)
        m = hdr.metadata
        frames, durations, st = [], [], _Slots()
        while True:
            fh = read_frame_header(br, hdr)
            toc = read_toc(br, _toc_count(hdr, fh))
            canvas = _compose_step(cs, hdr, fh, toc, dev, entropy, st)
            if fh.frame_type in (FrameType.REGULAR,
                                 FrameType.SKIP_PROGRESSIVE) and (
                    fh.duration > 0 or m.animation is None or fh.is_last):
                frames.append(apply_orientation(canvas.cpu().numpy(),
                                                m.orientation))
                durations.append(fh.duration)
            if fh.is_last:
                break
            br.pos = toc.end_offset * 8
        return frames, durations, basic_info(data)
    except BitstreamError as e:
        raise InvalidJXLError(str(e)) from e


def _partial_or_raise(data: bytes, dev, entropy: str, err: Exception):
    """_decode_partial's render of a stream cut short, else err as
    InvalidJXLError."""
    part = _decode_partial(data, dev, entropy)
    if part is not None:
        return part
    if isinstance(err, InvalidJXLError):
        raise err
    raise InvalidJXLError(str(err)) from err


def _decode_partial(data: bytes, dev, entropy: str):
    """A byte-truncated still rendered from what arrived
    (``jxl_coder_tpu/api.py:573-641``) -> (pixels, BasicInfo), or None
    when the stream is not a clean prefix truncation of a regular VarDCT
    frame (the first frame, no animation, a multi-section TOC), or its LF
    global, LF groups or HF global did not arrive whole.  The AC passes
    that arrived whole decode with max_passes; with none, the DC image's
    codes (the thumbnail's host and device halves: no HF global, no pass
    group) are resized on the card to the frame's size (S3, RESIZE,
    Catmull-Rom).  A stream the headers or these sections reject returns
    None, so the caller raises its InvalidJXLError."""
    try:
        cs, hdr, fh, toc = _first_frame(data)
        if (hdr.metadata.animation is not None
                or fh.encoding != Encoding.VARDCT
                or fh.frame_type != FrameType.REGULAR
                or len(toc.entries) == 1 or toc.end_offset <= len(cs)):
            return None
        ng, ndc = fh.counts(hdr)

        def whole(idx: int) -> bool:
            s = toc.section(idx)
            return s.offset + s.size <= len(cs)

        if not all(whole(i) for i in range(2 + ndc)):
            return None
        complete = 0
        for p in range(fh.passes.num_passes):
            if not all(whole(2 + ndc + p * ng + gi) for gi in range(ng)):
                break
            complete = p + 1
        if complete:
            host = _host_vardct(cs, hdr, fh, toc, dev, entropy,
                                max_passes=complete)
            _check_before(host, set(), None)
            pixels = device_half(host, dev)
        else:
            dc = _dc_codes(_dc_host(data, dev, entropy, upsampled=True), dev)
            pixels = rescale_image(dc, fh.frame_width or hdr.xsize,
                                   fh.frame_height or hdr.ysize,
                                   int(ScaleMode.RESIZE),
                                   int(ResizeFilter.CATMULL_ROM))
    except (BitstreamError, InvalidJXLError):
        return None
    return (apply_orientation(pixels.cpu().numpy(),
                              hdr.metadata.orientation), basic_info(data))


def decode_preview(data: bytes, passes: int = 1, device="cuda",
                   entropy: str = "host") -> Tuple[np.ndarray, BasicInfo]:
    """A progressive preview -> (pixels, BasicInfo) at full size, as
    jxl_coder_tpu.api.decode_preview returns it: only the first `passes`
    AC passes of a multi-pass VarDCT still (the first frame, regular, a
    multi-section TOC) decode; any other stream decodes whole (decode).
    A stream cut short renders what arrived (_decode_partial)."""
    check_entropy(entropy)
    dev = resolve_device(device)
    try:
        cs, hdr, fh, toc = _first_frame(data)
    except BitstreamError as e:
        return _partial_or_raise(data, dev, entropy, e)
    if (hdr.metadata.animation is not None or fh.encoding != Encoding.VARDCT
            or fh.frame_type != FrameType.REGULAR
            or fh.passes.num_passes <= passes or len(toc.entries) == 1):
        return decode(data, dev, entropy)
    try:
        host = _host_vardct(cs, hdr, fh, toc, dev, entropy,
                            max_passes=passes)
        _check_before(host, set(), None)
    except InvalidJXLError as e:
        return _partial_or_raise(data, dev, entropy, e)
    pixels = device_half(host, dev)
    return (apply_orientation(pixels.cpu().numpy(),
                              hdr.metadata.orientation), basic_info(data))


# ---- the sampled decode (jxl_coder_tpu/api.py:1043-1214) ----------------

def orient(pixels: torch.Tensor, orientation: int) -> torch.Tensor:
    """apply_orientation of an (H, W, C) tensor (flips copy, transposes
    are views)."""
    if orientation not in range(1, 9):
        raise InvalidJXLError(f"bad orientation {orientation}")
    if orientation >= 5:
        pixels = pixels.transpose(0, 1)
    flips = {2: (1,), 3: (0, 1), 4: (0,), 6: (1,), 7: (0, 1),
             8: (0,)}.get(orientation)
    if not flips:
        return pixels
    if pixels.dtype == torch.uint16:
        # flip has no uint16 kernel on CUDA; the bits move as int16
        return pixels.view(torch.int16).flip(flips).view(torch.uint16)
    return pixels.flip(flips)


def _pixels(data: bytes, dev, entropy: str) -> torch.Tensor:
    """A full decode's oriented pixels, on `dev` (an animation's: its last
    composed frame)."""
    if _animated(data):
        from .animation import AnimatedImage
        img = AnimatedImage(data, dev, entropy)
        return orient(img.frame_tensor(img.frames_count - 1),
                      img.image_header.metadata.orientation)
    host = host_half(data, dev, entropy)
    return orient(device_half(host, dev), orientation_of(host))


class DCHost(NamedTuple):
    """A VarDCT frame's DC image, the thumbnail's host half: the (3, ys_b,
    xs_b) f32 XYB DC planes (smoothed; None when the frame takes its DC
    from an LF frame) and the host halves of the LF frames before it."""
    hdr: ImageHeader
    fh: object
    dc: Optional[np.ndarray]
    before: tuple


def _dc_host(data: bytes, dev, entropy: str,
             upsampled: bool = False) -> Optional[DCHost]:
    """The DC image of the frame to decode, or None for a Modular or (unless
    `upsampled`) an upsampled frame (decode_thumbnail decodes those
    whole)."""
    try:
        cs, hdr, frames = _read_frames(data)
        fh, toc = frames[-1]
        if fh.encoding == Encoding.MODULAR or (fh.upsampling != 1
                                               and not upsampled):
            return None
        before, levels = [], set()
        for bfh, btoc in frames[:-1]:
            if bfh.frame_type == FrameType.LF_FRAME:
                h = _host_one(cs, hdr, bfh, btoc, dev, entropy, xyb=True)
                _check_before(h, levels, None)
                levels.add(bfh.lf_level)
                before.append(Before(True, bfh.lf_level, h))
        if fh.flags & DC_FRAME and fh.lf_level + 1 not in levels:
            raise InvalidJXLError(
                "frame uses a DC frame but none was decoded before it")
        state = parse_frame(cs, hdr, fh, toc, dc_only=True)
    except BitstreamError as e:
        raise InvalidJXLError(str(e)) from e
    dc = state["dc_glob"]
    if dc is not None:
        dc = np.stack([dc[c] for c in range(3)]).astype(np.float32)
    return DCHost(hdr, fh, dc, tuple(before))


def _dc_device(host: DCHost, dev) -> torch.Tensor:
    """The DC image's codes in the output encoding, oriented, on `dev`."""
    return orient(_dc_codes(host, dev), host.hdr.metadata.orientation)


def _dc_codes(host: DCHost, dev) -> torch.Tensor:
    """The DC image's codes in the output encoding, on `dev`."""
    m = host.hdr.metadata
    spec = output_spec(m, host.fh)
    if host.dc is None:
        dc_frames, _ = _device_before(host, dev)
        w, h = host.fh.coded_size(host.hdr)
        xyb = dc_from_frame(dc_frames[host.fh.lf_level + 1], -(-h // 8),
                            -(-w // 8))
    else:
        xyb = torch.from_numpy(host.dc).to(dev)
    bits = m.bit_depth.bits_per_sample
    return (modular_output.srgb_codes(xyb, bits) if spec == ("srgb",)
            else encode_output(xyb, spec, bits))


def _thumbnail(data: bytes, dev, entropy: str) -> torch.Tensor:
    if _animated(data) or _subsampled_jpeg(data):
        # a subsampled recompressed JPEG: the DC-only route takes one block
        # grid; the reference raises there (ROADMAP R12) and decodes
        # Modular and upsampled frames whole
        return box_codes(_pixels(data, dev, entropy))
    host = _dc_host(data, dev, entropy)
    if host is not None:
        return _dc_device(host, dev)
    return box_codes(_pixels(data, dev, entropy))


def decode_thumbnail(data: bytes, device="cuda", entropy: str = "host"
                     ) -> Tuple[np.ndarray, BasicInfo]:
    """A 1/8-scale preview -> (pixels at ceil(size / 8), BasicInfo), as
    jxl_coder_tpu.api.decode_thumbnail returns it: a VarDCT frame's DC
    image in the output encoding, (h, w, 3) (no AC decode, no filter, no
    overlay, noise or extra channel); a Modular or upsampled frame decoded
    whole, then each 8 x 8 cell of its codes averaged (all channels)."""
    check_entropy(entropy)
    dev = resolve_device(device)
    info = basic_info(data)
    return _thumbnail(data, dev, entropy).cpu().numpy(), info


def _quarter_eligible(data: bytes) -> bool:
    """_decode_downsampled's test, from the headers
    (jxl_coder_tpu/api.py:1125-1142)."""
    m = parse_header(data).metadata
    if (m.animation is not None or m.extra_channels
            or m.icc_profile is not None or m.orientation != 1):
        return False
    try:
        _cs, _hdr, frames = _read_frames(data)
    except BitstreamError as e:
        raise InvalidJXLError(str(e)) from e
    fh = frames[0][0]
    return (len(frames) == 1 and fh.frame_type == FrameType.REGULAR
            and fh.encoding != Encoding.MODULAR and fh.is_last
            and not (fh.do_ycbcr and jpeg_shifts(fh) is not None))


def _downsampled(data: bytes, factor: int, dev,
                 entropy: str) -> Optional[torch.Tensor]:
    if not _quarter_eligible(data):
        return None
    host = host_half(data, dev, entropy)
    host = host._replace(post=dataclasses.replace(host.post, down=factor))
    return device_half(host, dev)


def _decode_downsampled(data: bytes, factor: int, device="cuda",
                        entropy: str = "host"
                        ) -> Optional[Tuple[np.ndarray, BasicInfo]]:
    """A 1/factor-scale decode -> (pixels at ceil(size / factor),
    BasicInfo), or None when the still is not eligible (animation,
    extra channels, an ICC profile, an orientation, a Modular frame, or
    more than one frame), decided from its headers: the whole VarDCT
    frame on the device, each factor x factor cell of its XYB planes
    averaged before the output encoding (S1).  A corrupt stream raises
    InvalidJXLError."""
    check_entropy(entropy)
    dev = resolve_device(device)
    if factor < 1:
        raise ValueError(f"factor={factor}: expected >= 1")
    pixels = _downsampled(data, factor, dev, entropy)
    if pixels is None:
        return None
    return pixels.cpu().numpy(), basic_info(data)


def decode_sampled(data: bytes, width: int, height: int,
                   preferred_color_config: int = PreferredColorConfig.DEFAULT,
                   scale_mode: int = ScaleMode.FIT,
                   resize_filter: int = ResizeFilter.MITCHELL,
                   device="cuda", entropy: str = "host"):
    """Decode at a target size and pixel format -> (array, BasicInfo), as
    jxl_coder_tpu.api.decode_sampled returns them: RGBA8888 uint8 (H, W,
    4), RGBA_F16 float16 (H, W, 4), RGB_565 uint16 (H, W), RGBA_1010102
    uint32 (H, W).  A target within ceil(size / 8) takes the thumbnail,
    within ceil(size / 4) the quarter-scale decode when eligible, else the
    full decode; then the rescale to the target (scale_mode, resize_filter;
    skipped at the decoded size), the HDR -> SDR tone map when the format
    is SDR (8888, 565, HARDWARE, or DEFAULT at 8 bits) and the stream is
    PQ, HLG or wide-gamut, grey to RGB, an opaque alpha and the packing,
    all on `device`, then one download."""
    check_entropy(entropy)
    dev = resolve_device(device)
    info = basic_info(data)
    if (0 < width <= -(-info.xsize // 8)
            and 0 < height <= -(-info.ysize // 8)):
        pixels = _thumbnail(data, dev, entropy)
    else:
        pixels = None
        if (0 < width <= -(-info.xsize // 4)
                and 0 < height <= -(-info.ysize // 4)):
            pixels = _downsampled(data, 4, dev, entropy)
        if pixels is None:
            pixels = _pixels(data, dev, entropy)
    if width > 0 and height > 0 and \
            (width, height) != (pixels.shape[1], pixels.shape[0]):
        pixels = rescale_image(pixels, width, height, scale_mode,
                               resize_filter, info.alpha_premultiplied)
    ce = parse_header(data).metadata.colour_encoding
    sdr_target = preferred_color_config in (
        PreferredColorConfig.RGBA_8888, PreferredColorConfig.RGB_565,
        PreferredColorConfig.HARDWARE) or (
        preferred_color_config == PreferredColorConfig.DEFAULT
        and info.bits_per_sample <= 8)
    tone = (TONE.params(ce, info.intensity_target)
            if sdr_target and pixels.shape[-1] >= 3 and is_hdr_encoding(ce)
            else None)
    out = PACK.reformat(pixels, preferred_color_config, info.bits_per_sample,
                        tone)
    return out.cpu().numpy(), info


# --------------------------------------------------------------------------
# Encode (jxl_coder_tpu/api.py:197-438, 1251-1262)

def encode(pixels, lossless: bool = True, bits_per_sample: int = None,
           effort: int = 7, quality: int = None,
           decoding_speed: int = 0, colour=None,
           intensity_target: float = None,
           icc: bytes = None, progressive: bool = False,
           photon_noise_iso: float = 0.0, noise=None,
           device="cuda") -> bytes:
    """Encode an image array to a bare JXL codestream, as
    jxl_coder_tpu.api.encode writes it.

    pixels: uint8 / uint16 / float array (H, W), (H, W, 1), (H, W, 3) or
    (H, W, 4).  Lossy: VarDCT (``host/vardct/enc_real``), RGBA split into
    colour + a lossless alpha extra channel, grey expanded to RGB, the
    distance from `quality` (90 by default), `photon_noise_iso` or a raw
    8-knot `noise` lut as kNoise; without `colour` the encoder front runs
    on `device` (``vardct/enc_device.Front``: kernels E1-E4 on a card, their
    twins on the CPU), with `colour` it converts on the host.  A few-colour
    8-bit sample at effort 3 and up also takes the lossless route and keeps
    the smaller stream (the reference swallows a failure of that route,
    fault R18 of ROADMAP.md; here it raises).  Lossless: Modular, the
    reference's effort ladder 1-10 (RCT search, learned MA trees, the
    palette body), all host code; `icc` is embedded.  A lossy `icc`
    converts the pixels to sRGB on `device` first (``ops/icc_apply.py``;
    float pixels through uint16, as the reference), then the encode goes
    on without it.  A CUDA `device` without a card raises."""
    from .host.vardct.quant import quality_to_distance
    from .host.vardct.enc_real import encode_vardct_real
    from .vardct.enc_device import Front

    dev = resolve_device(device)
    pixels = np.asarray(pixels)
    if pixels.ndim == 2:
        pixels = pixels[:, :, None]
    if icc is not None and not lossless:
        pixels = _icc_pixels(pixels, icc, dev)
        icc = None
    h, w, nch = pixels.shape
    if bits_per_sample is None:
        bits_per_sample = 16 if pixels.dtype == np.uint16 else 8
    if not lossless:
        if nch == 1:
            pixels = np.repeat(pixels, 3, axis=2)
            nch = 3
        alpha_plane = None
        if nch == 4:
            if pixels.dtype.kind == "f":
                # rescale the [0,1] float plane BEFORE the integer cast
                alpha_plane = np.clip(
                    np.rint(pixels[:, :, 3].astype(np.float64)
                            * ((1 << bits_per_sample) - 1)), 0,
                    (1 << bits_per_sample) - 1).astype(np.int64)
            else:
                alpha_plane = pixels[:, :, 3].astype(np.int64)
            pixels = pixels[:, :, :3]
            nch = 3
        q = quality if quality is not None else 90
        distance = quality_to_distance(int(q))
        noise_lut = noise
        if noise_lut is None and photon_noise_iso > 0:
            # the reference's photon-noise curve: strength grows with ISO
            # and falls with intensity
            a = 0.12 * math.sqrt(photon_noise_iso / 3200.0)
            noise_lut = [min(1.0, a * (1.0 - 0.8 * (k / 7.0)))
                         for k in range(8)]
        blob = encode_vardct_real(pixels, distance=distance,
                                  decoding_speed=decoding_speed,
                                  effort=effort, alpha=alpha_plane,
                                  colour=colour,
                                  bit_depth=bits_per_sample,
                                  intensity_target=intensity_target,
                                  progressive=progressive,
                                  noise_lut=noise_lut, front=Front(dev))
        # screen-content decision: a sample with few distinct colours
        # also runs the lossless encoder, and the smaller stream wins
        if (effort >= 3 and alpha_plane is None and colour is None
                and noise_lut is None and pixels.dtype == np.uint8):
            samp = pixels[::max(1, pixels.shape[0] // 64),
                          ::max(1, pixels.shape[1] // 64)]
            flat = samp.reshape(-1, samp.shape[2])
            packed = (flat[:, 0].astype(np.uint32) << 16) \
                | (flat[:, 1].astype(np.uint32) << 8) | flat[:, 2]
            if len(np.unique(packed)) <= 64:
                ll = _encode_lossless(pixels, 8, effort, None, None)
                if len(ll) < len(blob):
                    return ll
        return blob
    return _encode_lossless(pixels, bits_per_sample, effort, colour, icc)


def _icc_pixels(pixels: np.ndarray, icc: bytes, dev) -> np.ndarray:
    """A lossy encode's (H, W, C) pixels from the profile's space to sRGB
    on `dev` (jxl_coder_tpu/api.py:231-239): float pixels through uint16
    and back to float64 / 65535."""
    if pixels.dtype.kind == "f":
        pix16 = np.clip(np.rint(pixels * 65535.0), 0, 65535).astype(np.uint16)
        out = ICC.icc_to_srgb(torch.from_numpy(pix16).to(dev), icc)
        return out.cpu().numpy().astype(np.float64) / 65535.0
    return ICC.icc_to_srgb(torch.from_numpy(np.ascontiguousarray(pixels))
                           .to(dev), icc).cpu().numpy()


def _encode_lossless(pixels: np.ndarray, bits_per_sample: int, effort: int,
                     colour, icc) -> bytes:
    """encode's Modular route (jxl_coder_tpu/api.py:314-401), host code."""
    import copy
    from .host.api import InvalidImageSizeError
    from .host.bitstream.frame_header import BlendingInfo, FrameHeader
    from .host.bitstream.headers import (BitDepth, ColourEncoding,
                                         ColourSpace, ExtraChannelInfo,
                                         ExtraChannelType, ImageMetadata,
                                         SizeHeader)
    from .host.bitstream.writer import BitWriter
    from .host import codec as HC

    h, w, nch = pixels.shape
    m = ImageMetadata()
    m.xyb_encoded = False
    m.bit_depth = BitDepth(False, bits_per_sample, 0)
    ce = copy.copy(colour) if colour is not None else ColourEncoding()
    if nch == 1:
        ce.colour_space = ColourSpace.GREY
    if icc is not None:
        ce.want_icc = True
        m.icc_profile = icc
    m.colour_encoding = ce
    planes = [pixels[:, :, i].astype(np.int32) for i in range(nch)]
    if nch == 4:
        ec = ExtraChannelInfo(type=ExtraChannelType.ALPHA)
        ec.bit_depth = BitDepth(False, bits_per_sample, 0)
        m.extra_channels = [ec]
    elif nch not in (1, 3):
        raise InvalidImageSizeError(f"unsupported channel count {nch}")
    hdr = ImageHeader(size=SizeHeader(xsize=w, ysize=h), metadata=m)

    fh = FrameHeader()
    fh.encoding = Encoding.MODULAR
    fh.group_size_shift = 3  # 1024 group dim
    fh.x_qm_scale = 2
    fh.ec_upsampling = [1] * len(m.extra_channels)
    fh.ec_blending_info = [BlendingInfo() for _ in m.extra_channels]
    fh.restoration_filter.epf_iters = 0
    fh.restoration_filter.gab = False

    # effort (JxlEffort.kt 1-10): 1 no colour decorrelation, fixed
    # gradient predictor; 2 + RCT (YCoCg) when it wins; 3-6 + a learned
    # MA tree of 6/10/16/24 leaves; 7 + RCT on/off search; 8 + RCT subtypes
    # {6, 0}; 9 + all subtypes 0-6; 10 + 32 leaves
    eff = max(1, min(10, int(effort)))
    leaves = {3: 6, 4: 10, 5: 16, 6: 24, 7: 24, 8: 24, 9: 24, 10: 32}
    can_rct = nch >= 3

    def enc(ycocg, tree, rct_type=6):
        cand = BitWriter()
        HC.encode_modular_frame(cand, hdr, fh, planes, use_ycocg=ycocg,
                                tree=tree, rct_type=rct_type)
        return cand.to_bytes()

    def learn(ycocg, rct_type=6):
        return HC.learned_modular_tree(hdr, fh, planes, use_ycocg=ycocg,
                                       rct_type=rct_type,
                                       max_leaves=leaves[eff])

    bw = BitWriter()
    HC.write_image_header(bw, hdr)
    if not can_rct:
        body = enc(False, learn(False) if eff >= 3 else None)
    elif eff == 1:
        body = enc(False, None)
    elif eff == 2:
        body = min(enc(True, None), enc(False, None), key=len)
    elif eff <= 6:
        body = min(enc(True, learn(True)), enc(False, None), key=len)
    else:
        rct_types = {7: [6], 8: [6, 0],
                     9: [6, 0, 1, 2, 3, 4, 5],
                     10: [6, 0, 1, 2, 3, 4, 5]}[eff]
        body = None
        for rt in rct_types:
            b = enc(True, learn(True, rt), rt)
            if body is None or len(b) < len(body):
                body = b
        b = enc(False, learn(False))
        if len(b) < len(body):
            body = b
    # the palette transform: few-colour images collapse to one index
    # channel + the palette meta-channel; tried from effort 2, kept when
    # it wins
    if (eff >= 2 and nch == 3 and not m.extra_channels
            and pixels.dtype in (np.uint8, np.uint16)):
        pb = _try_palette_body(hdr, fh, planes, eff)
        if pb is not None and len(pb) < len(body):
            body = pb
    for byte in body:
        bw.u(byte, 8)
    bw.zero_pad_to_byte()
    return bw.to_bytes()


def _try_palette_body(hdr, fh, planes, eff: int):
    """Candidate Modular body using the palette transform, or None when
    the image has more than 256 distinct colours."""
    from .host import codec as HC
    from .host.bitstream.writer import BitWriter
    r, g, b3 = (p.astype(np.uint64) for p in planes[:3])
    packed = (r << 32) | (g << 16) | b3
    # cheap bail-out: a sparse sample with >256 colours decides early
    samp = packed[::max(1, packed.shape[0] // 64),
                  ::max(1, packed.shape[1] // 64)]
    if len(np.unique(samp)) > 256:
        return None
    uniq, inv = np.unique(packed, return_inverse=True)
    K = len(uniq)
    if K > 256:
        return None
    pal = np.stack([(uniq >> 32) & 0xFFFF, (uniq >> 16) & 0xFFFF,
                    uniq & 0xFFFF]).astype(np.int32)
    idx = inv.reshape(packed.shape).astype(np.int32)
    tree = None
    if eff >= 3:
        from .host.modular.image import Channel
        from .host.modular.learn import learn_tree
        pal_ch = Channel(K, 3, hshift=-1, vshift=-1)
        pal_ch.data = pal
        idx_ch = Channel(idx.shape[1], idx.shape[0])
        idx_ch.data = idx
        leaves = {3: 6, 4: 10, 5: 16, 6: 24}.get(min(eff, 6), 24)
        tree = learn_tree([pal_ch, idx_ch], max_leaves=leaves,
                          props_allowed=[0] + list(range(2, 15)))
    cand = BitWriter()
    HC.encode_modular_frame(cand, hdr, fh, planes, tree=tree,
                            palette=(pal, idx))
    return cand.to_bytes()


def gif_to_jxl(gif_data: bytes, lossless: bool = True, quality: int = 90,
               device="cuda") -> bytes:
    """GIF -> animated JXL (Convenience.gif2JXL, JxlCoder.kt:146-153);
    needs PIL."""
    from . import animation as _anim
    return _anim.gif_to_jxl(gif_data, lossless, quality, device)


def apng_to_jxl(png_data: bytes, lossless: bool = True, quality: int = 90,
                device="cuda") -> bytes:
    """APNG -> animated JXL (Convenience.apng2JXL, JxlCoder.kt:159-166);
    needs PIL."""
    from . import animation as _anim
    return _anim.apng_to_jxl(png_data, lossless, quality, device)
