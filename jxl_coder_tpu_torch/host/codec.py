"""The codec layer's host pieces that the port uses
(``jxl_coder_tpu/codec.py``): the image-header writer, the DC
quantisation reader, and the Modular frame's decode (its channel planes
on the host; the device layer, ``modular/device.py``, undoes its
transforms) and encode (``api.encode``'s lossless route, with
``learned_modular_tree`` for its effort ladder).  The port's own
VarDCT codec is ``jxl_coder_tpu_torch.codec``.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from .bitstream.reader import BitReader, BitstreamError
from .bitstream.writer import BitWriter
from .bitstream.headers import (
    ImageHeader, ImageMetadata, ColourEncoding, ExtraChannelInfo,
    ExtraChannelType)
from .bitstream.frame_header import (FrameHeader, write_frame_header,
                                     write_toc)
from .modular.image import Channel, ModularImage
from .modular.frame import ModularPlanes
from .modular.stream import (GroupHeader, decode_modular_stream,
                             encode_modular_stream)
from .modular.tree import Tree
from .modular import transform as T


# --------------------------------------------------------------------------
# Header writing

def write_size_header(bw: BitWriter, xsize: int, ysize: int) -> None:
    if xsize % 8 == 0 and ysize % 8 == 0 and xsize <= 256 and ysize <= 256:
        bw.bool(True)
        bw.u(ysize // 8 - 1, 5)
        bw.u(0, 3)  # ratio 0: explicit xsize
        bw.u(xsize // 8 - 1, 5)
    else:
        bw.bool(False)
        bw.u32(ysize, (9, 1), (13, 1), (18, 1), (30, 1))
        bw.u(0, 3)
        bw.u32(xsize, (9, 1), (13, 1), (18, 1), (30, 1))


def _write_ec_info(bw: BitWriter, ec: ExtraChannelInfo) -> None:
    default = (ec.type == ExtraChannelType.ALPHA
               and not ec.bit_depth.float_sample
               and ec.bit_depth.bits_per_sample == 8 and ec.dim_shift == 0
               and not ec.name and not ec.alpha_associated)
    bw.bool(default)
    if default:
        return
    bw.u32(ec.type, 0, 1, (4, 2), (6, 18))
    bw.bool(ec.bit_depth.float_sample)
    if ec.bit_depth.float_sample:
        bw.u32(ec.bit_depth.bits_per_sample, 32, 16, 24, (6, 1))
        bw.u(ec.bit_depth.exp_bits - 1, 4)
    else:
        bw.u32(ec.bit_depth.bits_per_sample, 8, 10, 12, (6, 1))
    bw.u32(ec.dim_shift, 0, 3, 4, (3, 1))
    name_bytes = ec.name.encode("utf-8")
    bw.u32(len(name_bytes), 0, (4, 0), (5, 16), (10, 48))
    for b in name_bytes:
        bw.u(b, 8)
    if ec.type == ExtraChannelType.ALPHA:
        bw.bool(ec.alpha_associated)
    elif ec.type == ExtraChannelType.SPOT_COLOR:
        for v in ec.spot_color:
            bw.f16(v)
    elif ec.type == ExtraChannelType.CFA:
        bw.u32(ec.cfa_channel, 1, (2, 0), (4, 3), (8, 19))


def _write_colour_encoding(bw: BitWriter, ce: ColourEncoding) -> None:
    if ce.is_srgb and not ce.want_icc:
        bw.bool(True)
        return
    bw.bool(False)
    bw.bool(ce.want_icc)
    _write_enum(bw, ce.colour_space)
    from .bitstream.headers import ColourSpace, WhitePoint, Primaries
    if not ce.want_icc and ce.colour_space != ColourSpace.XYB:
        _write_enum(bw, ce.white_point)
        if ce.white_point == WhitePoint.CUSTOM:
            ce.white.write(bw)
        if ce.colour_space != ColourSpace.GREY:
            _write_enum(bw, ce.primaries)
            if ce.primaries == Primaries.CUSTOM:
                ce.red.write(bw)
                ce.green.write(bw)
                ce.blue.write(bw)
    if not ce.want_icc:
        bw.bool(ce.have_gamma)
        if ce.have_gamma:
            bw.u(ce.gamma, 24)
        else:
            _write_enum(bw, ce.transfer_function)
        _write_enum(bw, ce.rendering_intent)


def _write_enum(bw: BitWriter, v: int) -> None:
    bw.u32(v, 0, 1, (4, 2), (6, 18))


def write_image_header(bw: BitWriter, hdr: ImageHeader) -> None:
    bw.u(0x0AFF, 16)
    write_size_header(bw, hdr.size.xsize, hdr.size.ysize)
    m = hdr.metadata
    # metadata body (without the transform-data tail)
    _write_metadata_body(bw, m)
    # default_m (CustomTransformData bundle): all_default
    bw.bool(True)
    if m.colour_encoding is not None and m.colour_encoding.want_icc:
        # compressed ICC profile immediately follows the metadata
        # (read_image_header mirror; the reference embeds via
        # JxlEncoderSetICCProfile, interop/JxlEncoding.cpp:125-137)
        from .bitstream.icc import write_icc_profile
        write_icc_profile(bw, m.icc_profile)
    bw.zero_pad_to_byte()


def _write_metadata_body(bw: BitWriter, m: ImageMetadata) -> None:
    default = (m.orientation == 1 and m.intrinsic_size is None
               and m.preview is None and m.animation is None
               and not m.bit_depth.float_sample
               and m.bit_depth.bits_per_sample == 8
               and m.modular_16bit_buffers and not m.extra_channels
               and m.xyb_encoded and m.colour_encoding.is_srgb
               and not m.colour_encoding.want_icc)
    bw.bool(default)
    if default:
        return
    extra_fields = (m.orientation != 1 or m.animation is not None
                    or m.preview is not None or m.intrinsic_size is not None)
    bw.bool(extra_fields)
    if extra_fields:
        bw.u(m.orientation - 1, 3)
        bw.bool(False)  # intrinsic
        bw.bool(False)  # preview
        bw.bool(m.animation is not None)
        if m.animation is not None:
            a = m.animation
            bw.u32(a.tps_numerator, 100, 1000, (10, 1), (30, 1))
            bw.u32(a.tps_denominator, 1, 1001, (8, 1), (10, 1))
            bw.u32(a.num_loops, 0, (3, 0), (16, 0), (32, 0))
            bw.bool(a.have_timecodes)
    bw.bool(m.bit_depth.float_sample)
    if m.bit_depth.float_sample:
        bw.u32(m.bit_depth.bits_per_sample, 32, 16, 24, (6, 1))
        bw.u(m.bit_depth.exp_bits - 1, 4)
    else:
        bw.u32(m.bit_depth.bits_per_sample, 8, 10, 12, (6, 1))
    bw.bool(m.modular_16bit_buffers)
    bw.u32(len(m.extra_channels), 0, 1, (4, 2), (12, 1))
    for ec in m.extra_channels:
        _write_ec_info(bw, ec)
    bw.bool(m.xyb_encoded)
    _write_colour_encoding(bw, m.colour_encoding)
    if extra_fields:
        tm = m.tone_mapping
        tm_default = (tm.intensity_target == 255.0 and tm.min_nits == 0
                      and not tm.relative_to_max_display
                      and tm.linear_below == 0)
        bw.bool(tm_default)
        if not tm_default:
            bw.f16(tm.intensity_target)
            bw.f16(tm.min_nits)
            bw.bool(tm.relative_to_max_display)
            bw.f16(tm.linear_below)
    bw.u64(0)

DEFAULT_DC_QUANT = (1.0 / 4096, 1.0 / 512, 1.0 / 256)


def read_dc_quant(br: BitReader):
    """DequantMatrices::DecodeDC: all_default bundle, else 3 F16 factors
    (divided by 128)."""
    if br.bool():
        return DEFAULT_DC_QUANT
    vals = []
    for _ in range(3):
        v = br.f16() / 128.0
        if v < 1e-8:
            raise BitstreamError("invalid dc_quant")
        vals.append(v)
    return tuple(vals)


# --------------------------------------------------------------------------
# Modular frame channel layout

def frame_channel_layout(hdr: ImageHeader, fh: FrameHeader) -> ModularImage:
    w, h = fh.coded_size(hdr)
    m = hdr.metadata
    if m.colour_encoding.colour_space == 1 and not m.xyb_encoded:  # grey
        ncolor = 1
    else:
        ncolor = 3
    return ModularImage.for_frame(w, h, ncolor, m.extra_channels)


# --------------------------------------------------------------------------
# Decode

def decode_modular_frame(cs: bytes, hdr: ImageHeader, fh: FrameHeader,
                         toc):
    """A Modular frame's channels, entropy-decoded on the host ->
    (ModularPlanes: the raw planes, the frame's stream header and the
    group streams' chains, every transform still to undo; the LfGlobal DC
    dequant factors)."""
    ng, ndc = fh.counts(hdr)
    n_entries = len(toc.entries)
    if n_entries == 1:
        image = frame_channel_layout(hdr, fh)
        sec = toc.section(0)
        br = BitReader(cs[sec.offset:sec.offset + sec.size])
        # LfGlobal: DC dequant factors (bundle; used by modular XYB mode)
        dc_quant = read_dc_quant(br)
        # GlobalModular: optional global tree + shared histograms
        global_tree = None
        global_code = None
        if br.bool():  # have_global_tree
            from .modular.tree import decode_tree
            from .entropy.coder import EntropyCode
            global_tree = decode_tree(br, 1 << 22)
            global_code = EntropyCode(br, global_tree.num_leaves)
        header = decode_modular_stream(br, image, stream_id=0,
                                       global_tree=global_tree,
                                       global_code=global_code)
        return ModularPlanes(image, header, []), dc_quant
    # multi-section layout: LfGlobal (dc-quant, global tree, global
    # modular stream) | LfGroup* (shift>=3 channel rects) | HfGlobal
    # (empty for modular frames) | PassGroup* (shift<3 channel rects)
    from .modular.frame import ModularFrameDecoder
    from .modular.tree import decode_tree
    from .entropy.coder import EntropyCode

    sec = toc.section(0)
    br = BitReader(cs[sec.offset:sec.offset + sec.size])
    dc_quant = read_dc_quant(br)
    gtree = gcode = None
    if br.bool():
        gtree = decode_tree(br, 1 << 22)
        gcode = EntropyCode(br, (len(gtree.nodes) + 1) // 2)
    w, h = fh.coded_size(hdr)
    mfd = ModularFrameDecoder.for_frame(hdr, fh, gtree, gcode, True, w, h)
    mfd.read_global(br)
    for gi in range(ndc):
        sec = toc.section(1 + gi)
        gbr = BitReader(cs[sec.offset:sec.offset + sec.size])
        mfd.read_lf_group(gbr, gi, ndc)
    for gi in range(ng):
        sec = toc.section(2 + ndc + gi)
        gbr = BitReader(cs[sec.offset:sec.offset + sec.size])
        mfd.read_group(gbr, gi, ndc, ng)
    return mfd.planes(), dc_quant


def modular_planes_to_xyb(planes, dc_quant):
    """(Y, X, B-Y) integer channels -> {0: X, 1: Y, 2: B} float32 planes
    (the representation LF and reference frames hand to the next frame;
    the original's _modular_planes_to_xyb_dc)."""
    cy = planes[0].astype(np.float32)
    cx = planes[1].astype(np.float32)
    cb = planes[2].astype(np.float32)
    return {0: cx * np.float32(dc_quant[0]),
            1: cy * np.float32(dc_quant[1]),
            2: (cy + cb) * np.float32(dc_quant[2])}


# --------------------------------------------------------------------------
# Encode

def learned_modular_tree(hdr: ImageHeader, fh, planes,
                         use_ycocg: bool, rct_type: int = 6,
                         max_leaves: int = 16) -> Tree:
    """Learn an MA tree on the (optionally RCT'd) frame channels — the
    encode-effort search depth knob (JxlEffort.kt 1-10 semantics)."""
    image = frame_channel_layout(hdr, fh)
    for chan, plane in zip(image.channels, planes):
        chan.data = plane.astype(np.int32)
    if use_ycocg and len(planes) >= 3:
        t = T.Transform(id=0, begin_c=0, rct_type=rct_type)
        T.rct_forward(image, t)
    from .modular.learn import learn_tree
    return learn_tree(image.channels, max_leaves=max_leaves,
                      props_allowed=[0] + list(range(2, 15)))


def encode_modular_frame(bw: BitWriter, hdr: ImageHeader, fh: FrameHeader,
                         planes: List[np.ndarray],
                         use_ycocg: bool = True,
                         tree: Optional[Tree] = None,
                         rct_type: int = 6,
                         palette=None) -> None:
    """Encode a full modular frame (header + TOC + sections) into bw.

    palette: optional (pal_data (nc, K) int32, idx (H, W) int32) — the
    frame's nc colour channels collapse to one index channel plus the
    palette meta-channel (Transform id 1, the decode-side mirror of
    modular/transform.palette_meta_apply); use_ycocg is ignored."""
    image = frame_channel_layout(hdr, fh)
    header = GroupHeader()
    if palette is not None:
        pal_data, idx = palette
        nc = len(image.channels)
        assert pal_data.shape[0] == nc
        first = image.channels[0]
        K = pal_data.shape[1]
        pal_ch = Channel(K, nc, hshift=-1, vshift=-1)
        pal_ch.data = np.ascontiguousarray(pal_data, np.int32)
        idx_ch = Channel(first.width, first.height, first.hshift,
                         first.vshift)
        idx_ch.data = np.ascontiguousarray(idx, np.int32)
        image.channels = [pal_ch, idx_ch]
        image.nb_meta_channels = 1
        header.transforms.append(T.Transform(
            id=1, begin_c=0, num_c=nc, nb_colours=K, nb_deltas=0,
            d_pred=0))
    else:
        for chan, plane in zip(image.channels, planes):
            assert plane.shape == (chan.height, chan.width), \
                (plane.shape, chan.height, chan.width)
            chan.data = plane.astype(np.int32)
        ncolor = 3 if len(planes) >= 3 else 1
        if use_ycocg and ncolor == 3:
            t = T.Transform(id=0, begin_c=0, rct_type=rct_type)
            header.transforms.append(t)
            T.rct_forward(image, t)
    if tree is None:
        tree = Tree.single_leaf(predictor=5)

    ng, ndc = fh.counts(hdr)
    gd = fh.group_dim()
    sections: List[bytes] = []
    if ng == 1:
        sw = BitWriter()
        sw.bool(True)   # LfGlobal: dc_quant all_default
        sw.bool(False)  # have_global_tree (GlobalModular prelude)
        encode_modular_stream(sw, image, header, tree, stream_id=0)
        sections.append(sw.to_bytes())
    else:
        # real multi-section layout: LfGlobal | LfGroup* (empty: no
        # shift>=3 channels from RCT-only transforms) | HfGlobal
        # (empty) | per-group ModularAC streams (stream id
        # 1 + 3*ndc + 17 + g), each with a local tree.
        sw = BitWriter()
        sw.bool(True)   # dc_quant all_default
        sw.bool(False)  # no frame-level global tree
        # global stream: decode-until-break rule — stop at the first
        # channel larger than group_dim
        stop = len(image.channels)
        for i, c in enumerate(image.channels):
            if i >= image.nb_meta_channels and (c.width > gd
                                                or c.height > gd):
                stop = i
                break
        encode_modular_stream(sw, image, header, tree, stream_id=0,
                              channel_range=(0, stop))
        sections.append(sw.to_bytes())
        for _ in range(ndc):
            sections.append(b"")  # LfGroups: no shift>=3 channels
        sections.append(b"")      # HfGlobal (empty for modular)
        w, hgt = fh.coded_size(hdr)
        gx = -(-w // gd)
        for gi in range(ng):
            x0 = (gi % gx) * gd
            y0 = (gi // gx) * gd
            subs = []
            for ci in range(stop, len(image.channels)):
                c = image.channels[ci]
                if min(c.hshift, c.vshift) >= 3:
                    continue
                cx0 = x0 >> max(0, c.hshift)
                cy0 = y0 >> max(0, c.vshift)
                cw = min(c.width - cx0, gd >> max(0, c.hshift))
                chh = min(c.height - cy0, gd >> max(0, c.vshift))
                if cw <= 0 or chh <= 0:
                    continue
                subs.append(Channel(cw, chh, data=c.data[
                    cy0:cy0 + chh, cx0:cx0 + cw].copy()))
            gw = BitWriter()
            sub_image = ModularImage(subs, 0)
            encode_modular_stream(gw, sub_image, GroupHeader(), tree,
                                  stream_id=1 + 3 * ndc + 17 + gi)
            sections.append(gw.to_bytes())

    write_frame_header(bw, fh, hdr)
    write_toc(bw, [len(s) for s in sections])
    for s in sections:
        for byte in s:
            bw.u(byte, 8)
