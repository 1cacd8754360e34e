"""JPEG XL codestream headers: SizeHeader, ImageMetadata, ColourEncoding.

Host-side parsing per ISO/IEC 18181-1 Annex structures.  This reproduces the
metadata surface the reference exposes through libjxl's JxlBasicInfo /
JxlColorEncoding (jxl-coder: jxlcoder/src/main/cpp/interop/
JxlDecoding.cpp:85-144: bit depth, alpha, premultiplied alpha, orientation,
intensity_target, preferred colour encoding vs ICC).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

from .reader import BitReader, BitstreamError, unpack_signed


# --------------------------------------------------------------------------
# Enums (integer values are normative wire values)

class ColourSpace:
    RGB = 0
    GREY = 1
    XYB = 2
    UNKNOWN = 3


class WhitePoint:
    D65 = 1
    CUSTOM = 2
    E = 10
    DCI = 11


class Primaries:
    SRGB = 1
    CUSTOM = 2
    BT2100 = 9
    P3 = 11


class TransferFunction:
    BT709 = 1
    UNKNOWN = 2
    LINEAR = 8
    SRGB = 13
    PQ = 16
    DCI = 17
    HLG = 18


class RenderingIntent:
    PERCEPTUAL = 0
    RELATIVE = 1
    SATURATION = 2
    ABSOLUTE = 3


class ExtraChannelType:
    ALPHA = 0
    DEPTH = 1
    SPOT_COLOR = 2
    SELECTION_MASK = 3
    BLACK = 4
    CFA = 5
    THERMAL = 6
    UNKNOWN = 15
    OPTIONAL = 16


class Orientation:
    IDENTITY = 1
    FLIP_HORIZONTAL = 2
    ROTATE_180 = 3
    FLIP_VERTICAL = 4
    TRANSPOSE = 5
    ROTATE_90_CW = 6
    ANTI_TRANSPOSE = 7
    ROTATE_90_CCW = 8


# --------------------------------------------------------------------------
# Dataclasses

@dataclasses.dataclass
class SizeHeader:
    xsize: int = 0
    ysize: int = 0

    @staticmethod
    def read(br: BitReader) -> "SizeHeader":
        small = br.bool()
        if small:
            ysize = (br.u(5) + 1) * 8
        else:
            ysize = br.u32((9, 1), (13, 1), (18, 1), (30, 1))
        ratio = br.u(3)
        if ratio == 0:
            if small:
                xsize = (br.u(5) + 1) * 8
            else:
                xsize = br.u32((9, 1), (13, 1), (18, 1), (30, 1))
        else:
            num, den = [(1, 1), (12, 10), (4, 3), (3, 2),
                        (16, 9), (5, 4), (2, 1)][ratio - 1]
            xsize = ysize * num // den
        return SizeHeader(xsize=xsize, ysize=ysize)


@dataclasses.dataclass
class PreviewHeader:
    xsize: int = 0
    ysize: int = 0

    @staticmethod
    def read(br: BitReader) -> "PreviewHeader":
        div8 = br.bool()
        if div8:
            ysize = br.u32(16, 32, (5, 1), (9, 33)) * 8
        else:
            ysize = br.u32((6, 1), (8, 65), (10, 321), (12, 1345))
        ratio = br.u(3)
        if ratio == 0:
            if div8:
                xsize = br.u32(16, 32, (5, 1), (9, 33)) * 8
            else:
                xsize = br.u32((6, 1), (8, 65), (10, 321), (12, 1345))
        else:
            num, den = [(1, 1), (12, 10), (4, 3), (3, 2),
                        (16, 9), (5, 4), (2, 1)][ratio - 1]
            xsize = ysize * num // den
        return PreviewHeader(xsize=xsize, ysize=ysize)


@dataclasses.dataclass
class AnimationHeader:
    tps_numerator: int = 100
    tps_denominator: int = 1
    num_loops: int = 0
    have_timecodes: bool = False

    @staticmethod
    def read(br: BitReader) -> "AnimationHeader":
        a = AnimationHeader()
        a.tps_numerator = br.u32(100, 1000, (10, 1), (30, 1))
        a.tps_denominator = br.u32(1, 1001, (8, 1), (10, 1))
        a.num_loops = br.u32(0, (3, 0), (16, 0), (32, 0))
        a.have_timecodes = br.bool()
        return a


@dataclasses.dataclass
class BitDepth:
    float_sample: bool = False
    bits_per_sample: int = 8
    exp_bits: int = 0

    @staticmethod
    def read(br: BitReader) -> "BitDepth":
        b = BitDepth()
        b.float_sample = br.bool()
        if b.float_sample:
            b.bits_per_sample = br.u32(32, 16, 24, (6, 1))
            b.exp_bits = br.u(4) + 1
        else:
            b.bits_per_sample = br.u32(8, 10, 12, (6, 1))
        return b


@dataclasses.dataclass
class CustomXY:
    x: int = 0  # units of 1e-6
    y: int = 0

    @staticmethod
    def read(br: BitReader) -> "CustomXY":
        c = CustomXY()
        c.x = unpack_signed(br.u32((19, 0), (19, 1 << 19),
                                   (20, 1 << 20), (21, 1 << 21)))
        c.y = unpack_signed(br.u32((19, 0), (19, 1 << 19),
                                   (20, 1 << 20), (21, 1 << 21)))
        return c

    def write(self, bw) -> None:
        from .reader import pack_signed
        bw.u32(pack_signed(self.x), (19, 0), (19, 1 << 19),
               (20, 1 << 20), (21, 1 << 21))
        bw.u32(pack_signed(self.y), (19, 0), (19, 1 << 19),
               (20, 1 << 20), (21, 1 << 21))

    @staticmethod
    def from_float(x: float, y: float) -> "CustomXY":
        return CustomXY(int(round(x * 1e6)), int(round(y * 1e6)))

    def as_float(self):
        return (self.x * 1e-6, self.y * 1e-6)


@dataclasses.dataclass
class ColourEncoding:
    want_icc: bool = False
    colour_space: int = ColourSpace.RGB
    white_point: int = WhitePoint.D65
    white: Optional[CustomXY] = None
    primaries: int = Primaries.SRGB
    red: Optional[CustomXY] = None
    green: Optional[CustomXY] = None
    blue: Optional[CustomXY] = None
    have_gamma: bool = False
    gamma: int = 0  # units of 1e-7
    transfer_function: int = TransferFunction.SRGB
    rendering_intent: int = RenderingIntent.RELATIVE

    @staticmethod
    def read(br: BitReader) -> "ColourEncoding":
        ce = ColourEncoding()
        if br.bool():  # all_default -> sRGB
            return ce
        ce.want_icc = br.bool()
        ce.colour_space = br.enum()
        if not ce.want_icc and ce.colour_space != ColourSpace.XYB:
            ce.white_point = br.enum()
            if ce.white_point == WhitePoint.CUSTOM:
                ce.white = CustomXY.read(br)
            if ce.colour_space not in (ColourSpace.GREY,):
                ce.primaries = br.enum()
                if ce.primaries == Primaries.CUSTOM:
                    ce.red = CustomXY.read(br)
                    ce.green = CustomXY.read(br)
                    ce.blue = CustomXY.read(br)
        if not ce.want_icc:
            ce.have_gamma = br.bool()
            if ce.have_gamma:
                ce.gamma = br.u(24)
            else:
                ce.transfer_function = br.enum()
            ce.rendering_intent = br.enum()
        return ce

    @property
    def is_srgb(self) -> bool:
        return (not self.want_icc and self.colour_space == ColourSpace.RGB
                and self.white_point == WhitePoint.D65
                and self.primaries == Primaries.SRGB and not self.have_gamma
                and self.transfer_function == TransferFunction.SRGB)


@dataclasses.dataclass
class ExtraChannelInfo:
    type: int = ExtraChannelType.ALPHA
    bit_depth: BitDepth = dataclasses.field(default_factory=BitDepth)
    dim_shift: int = 0
    name: str = ""
    alpha_associated: bool = False
    spot_color: Optional[tuple] = None
    cfa_channel: int = 1

    @staticmethod
    def read(br: BitReader) -> "ExtraChannelInfo":
        ec = ExtraChannelInfo()
        if br.bool():  # d_alpha (all-default: 8-bit unassociated alpha)
            return ec
        ec.type = br.enum()
        ec.bit_depth = BitDepth.read(br)
        ec.dim_shift = br.u32(0, 3, 4, (3, 1))
        name_len = br.u32(0, (4, 0), (5, 16), (10, 48))
        ec.name = bytes(br.u(8) for _ in range(name_len)).decode(
            "utf-8", "replace")
        if ec.type == ExtraChannelType.ALPHA:
            ec.alpha_associated = br.bool()
        elif ec.type == ExtraChannelType.SPOT_COLOR:
            ec.spot_color = tuple(br.f16() for _ in range(4))
        elif ec.type == ExtraChannelType.CFA:
            ec.cfa_channel = br.u32(1, (2, 0), (4, 3), (8, 19))
        return ec


@dataclasses.dataclass
class ToneMapping:
    intensity_target: float = 255.0
    min_nits: float = 0.0
    relative_to_max_display: bool = False
    linear_below: float = 0.0

    @staticmethod
    def read(br: BitReader) -> "ToneMapping":
        tm = ToneMapping()
        if br.bool():  # all_default
            return tm
        tm.intensity_target = br.f16()
        if tm.intensity_target <= 0:
            raise BitstreamError("intensity_target must be positive")
        tm.min_nits = br.f16()
        tm.relative_to_max_display = br.bool()
        tm.linear_below = br.f16()
        return tm


def read_extensions(br: BitReader) -> dict:
    """Extensions field: U64 bitmask + per-extension payload sizes (skipped)."""
    extensions = br.u64()
    payload_bits = {}
    if extensions:
        total = 0
        for i in range(64):
            if extensions & (1 << i):
                payload_bits[i] = br.u64()
                total += payload_bits[i]
        br.skip(total)
    return payload_bits


# Default XYB opsin inverse matrix (linear sRGB <- XYB-mixed LMS), the
# inverse of the forward opsin absorbance matrix.  Same constants libjxl
# exposes as kDefaultInverseOpsinAbsorbanceMatrix.
DEFAULT_INV_OPSIN = (
    11.031566901960783, -9.866943921568629, -0.16462299647058826,
    -3.254147380392157, 4.418770392156863, -0.16462299647058826,
    -3.6588512862745097, 2.7129230470588235, 1.9459282392156863,
)
DEFAULT_OPSIN_BIAS = (-0.0037930732552754493,) * 3
DEFAULT_QUANT_BIAS = (1.0 - 0.05465007330715401,
                      1.0 - 0.07005449891748593,
                      1.0 - 0.049935103337343655)
DEFAULT_QUANT_BIAS_NUMERATOR = 0.145


@dataclasses.dataclass
class OpsinInverseMatrix:
    inv_matrix: tuple = DEFAULT_INV_OPSIN
    opsin_biases: tuple = DEFAULT_OPSIN_BIAS
    quant_biases: tuple = DEFAULT_QUANT_BIAS
    quant_biases_numerator: float = DEFAULT_QUANT_BIAS_NUMERATOR

    @staticmethod
    def read(br: BitReader) -> "OpsinInverseMatrix":
        m = OpsinInverseMatrix()
        if br.bool():  # all_default
            return m
        m.inv_matrix = tuple(br.f16() for _ in range(9))
        m.opsin_biases = tuple(br.f16() for _ in range(3))
        m.quant_biases = tuple(br.f16() for _ in range(3))
        m.quant_biases_numerator = br.f16()
        return m


@dataclasses.dataclass
class CustomTransformData:
    opsin_inverse_matrix: OpsinInverseMatrix = dataclasses.field(
        default_factory=OpsinInverseMatrix)
    custom_weights_mask: int = 0
    up2_weights: Optional[tuple] = None
    up4_weights: Optional[tuple] = None
    up8_weights: Optional[tuple] = None

    @staticmethod
    def read(br: BitReader, xyb_encoded: bool) -> "CustomTransformData":
        """Bundle: a leading all_default bit (the universal case — every
        reference-encoder stream observed writes 1 here), else the opsin
        matrix (when xyb) + custom upsampling weight fields."""
        td = CustomTransformData()
        if br.bool():  # all_default
            return td
        if xyb_encoded:
            td.opsin_inverse_matrix = OpsinInverseMatrix.read(br)
        td.custom_weights_mask = br.u(3)
        if td.custom_weights_mask & 1:
            td.up2_weights = tuple(br.f16() for _ in range(15))
        if td.custom_weights_mask & 2:
            td.up4_weights = tuple(br.f16() for _ in range(55))
        if td.custom_weights_mask & 4:
            td.up8_weights = tuple(br.f16() for _ in range(210))
        return td


@dataclasses.dataclass
class ImageMetadata:
    orientation: int = Orientation.IDENTITY
    intrinsic_size: Optional[SizeHeader] = None
    preview: Optional[PreviewHeader] = None
    animation: Optional[AnimationHeader] = None
    bit_depth: BitDepth = dataclasses.field(default_factory=BitDepth)
    modular_16bit_buffers: bool = True
    extra_channels: List[ExtraChannelInfo] = dataclasses.field(
        default_factory=list)
    xyb_encoded: bool = True
    colour_encoding: ColourEncoding = dataclasses.field(
        default_factory=ColourEncoding)
    tone_mapping: ToneMapping = dataclasses.field(default_factory=ToneMapping)
    extensions: dict = dataclasses.field(default_factory=dict)
    transform_data: CustomTransformData = dataclasses.field(
        default_factory=CustomTransformData)
    icc_profile: Optional[bytes] = None  # decoded want_icc payload

    @staticmethod
    def read(br: BitReader) -> "ImageMetadata":
        m = ImageMetadata()
        all_default = br.bool()
        if not all_default:
            extra_fields = br.bool()
            if extra_fields:
                m.orientation = br.u(3) + 1
                if br.bool():
                    m.intrinsic_size = SizeHeader.read(br)
                if br.bool():
                    m.preview = PreviewHeader.read(br)
                if br.bool():
                    m.animation = AnimationHeader.read(br)
            m.bit_depth = BitDepth.read(br)
            m.modular_16bit_buffers = br.bool()
            num_ec = br.u32(0, 1, (4, 2), (12, 1))
            m.extra_channels = [ExtraChannelInfo.read(br)
                                for _ in range(num_ec)]
            m.xyb_encoded = br.bool()
            m.colour_encoding = ColourEncoding.read(br)
            if extra_fields:
                m.tone_mapping = ToneMapping.read(br)
            m.extensions = read_extensions(br)
        # default_m: custom transform data trails ImageMetadata
        # *unconditionally* (verified bit-level against reference corpus:
        # all_default files still carry opsin_ad + 3-bit weight mask).
        m.transform_data = CustomTransformData.read(br, m.xyb_encoded)
        return m

    @property
    def alpha_index(self) -> Optional[int]:
        for i, ec in enumerate(self.extra_channels):
            if ec.type == ExtraChannelType.ALPHA:
                return i
        return None

    @property
    def num_extra_channels(self) -> int:
        return len(self.extra_channels)


@dataclasses.dataclass
class ImageHeader:
    size: SizeHeader
    metadata: ImageMetadata

    @property
    def xsize(self):
        return self.size.xsize

    @property
    def ysize(self):
        return self.size.ysize

    @property
    def oriented_xsize(self):
        if self.metadata.orientation > 4:
            return self.size.ysize
        return self.size.xsize

    @property
    def oriented_ysize(self):
        if self.metadata.orientation > 4:
            return self.size.xsize
        return self.size.ysize


def read_image_header(br: BitReader) -> ImageHeader:
    if br.u(16) != 0x0AFF:
        raise BitstreamError("codestream does not start with FF 0A")
    size = SizeHeader.read(br)
    if size.xsize == 0 or size.ysize == 0:
        raise BitstreamError("zero image dimension")
    metadata = ImageMetadata.read(br)
    if metadata.colour_encoding.want_icc:
        # the compressed ICC profile immediately follows the metadata
        from .icc import read_icc_profile
        metadata.icc_profile = read_icc_profile(br)
    return ImageHeader(size=size, metadata=metadata)
