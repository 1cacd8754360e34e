"""The codec layer's host pieces that the port uses
(``jxl_coder_tpu/codec.py``): the image-header writer and the DC
quantisation reader.  The port's own codec is ``jxl_coder_tpu_torch.codec``.
"""

from __future__ import annotations

from .bitstream.reader import BitReader, BitstreamError
from .bitstream.writer import BitWriter
from .bitstream.headers import (
    ImageHeader, ImageMetadata, ColourEncoding, ExtraChannelInfo,
    ExtraChannelType)



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
