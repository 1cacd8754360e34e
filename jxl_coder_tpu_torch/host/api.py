"""The API layer's host pieces that the port uses
(``jxl_coder_tpu/api.py:24-116``): the option enums of the encode and of
the sampled decode, the decode-size ceiling, the typed errors,
the probes ``is_jxl`` / ``get_size`` / ``basic_info``, and
``apply_orientation``.  The port's encode and decode
entry points are in ``api.py``, its round-1 codec in ``codec``.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Tuple

from .bitstream.reader import BitReader, BitstreamError
from .bitstream import container as _container
from .bitstream.headers import read_image_header, ImageHeader


# ---- Option enums (values mirror JxlDefinitions.h:32-58) -----------------

class CompressionOption(enum.IntEnum):
    """JxlCompressionOption.kt:30-32"""
    LOSSLESS = 1
    LOSSY = 2


class Effort(enum.IntEnum):
    """JxlEffort.kt — 1 (fastest) .. 10 (slowest)."""
    LIGHTNING = 1
    THUNDER = 2
    FALCON = 3
    CHEETAH = 4
    HARE = 5
    WOMBAT = 6
    SQUIRREL = 7
    KITTEN = 8
    TORTOISE = 9
    GLACIER = 10


class DecodingSpeed(enum.IntEnum):
    """JxlDecodingSpeed.kt — 0 (slowest decode) .. 4 (fastest decode)."""
    SLOWEST = 0
    SLOW = 1
    MEDIUM = 2
    FAST = 3
    FASTEST = 4


class ChannelsConfiguration(enum.IntEnum):
    """JxlChannelsConfiguration.kt"""
    RGB = 1
    RGBA = 2
    MONOCHROME = 3


class EncodingPixelFormat(enum.IntEnum):
    """JxlEncodingDataPixelFormat.kt"""
    UNSIGNED_8 = 1
    BINARY_16 = 2


class PreferredColorConfig(enum.IntEnum):
    """PreferredColorConfig.kt"""
    DEFAULT = 1
    RGBA_8888 = 2
    RGBA_F16 = 3
    RGB_565 = 4
    RGBA_1010102 = 5
    HARDWARE = 6


class ScaleMode(enum.IntEnum):
    """ScaleMode.kt"""
    FIT = 1
    FILL = 2
    RESIZE = 3


class ResizeFilter(enum.IntEnum):
    """JxlResizeFilter.kt — 10 resampling kernels."""
    BILINEAR = 1
    NEAREST = 2
    CUBIC = 3
    MITCHELL = 4
    LANCZOS = 5
    CATMULL_ROM = 6
    HERMITE = 7
    BSPLINE = 8
    HANN = 9
    BICUBIC = 10


# ---- Exceptions (mirror the 6 Kotlin exception types) --------------------

class InvalidJXLError(ValueError):
    """InvalidJXLException.kt — not a JXL stream / corrupt stream."""


class CompressionError(RuntimeError):
    """JXLCoderCompressionException.kt"""


class InvalidColorSpaceError(ValueError):
    """InvalidColorSpaceException.kt"""


class InvalidCompressionOptionError(ValueError):
    """InvalidCompressionOptionException.kt"""


class InvalidImageSizeError(ValueError):
    """InvalidImageSizeException.kt — also enforces the reference's
    pixels*bytes < 2^31 ceiling (interop/JxlDecoding.cpp:103-109)."""


def _check_decode_size(hdr) -> None:
    """Total image-size ceiling, checked BEFORE any allocation: a
    forged header claiming e.g. 10^6 x 10^6 px must raise, not attempt
    the buffers.  Mirrors interop/JxlDecoding.cpp:103-109
    (w * h * 4 channels * bytes-per-sample < INT32_MAX)."""
    m = hdr.metadata
    w, h = hdr.size.xsize, hdr.size.ysize
    bps = 2 if (m.bit_depth.bits_per_sample > 8
                or m.bit_depth.float_sample) else 1
    if w * h * 4 * bps >= (1 << 31):
        raise InvalidImageSizeError(
            f"image too large to decode: {w}x{h} at {bps * 8}-bit "
            f"exceeds the 2^31-byte buffer ceiling")


def is_jxl(data: bytes) -> bool:
    """Magic sniff, both bare codestream and container
    (JxlCoder.kt:244-267)."""
    return _container.is_jxl(data)


def parse_header(data: bytes) -> ImageHeader:
    """Parse container + image header, raising InvalidJXLError on garbage."""
    try:
        c = _container.extract_codestream(data)
        br = BitReader(c.codestream)
        return read_image_header(br)
    except BitstreamError as e:
        raise InvalidJXLError(str(e)) from e


def get_size(data: bytes) -> Tuple[int, int]:
    """(width, height) after orientation, as the reference's getSize
    (JniDecoding.cpp:394-414) reports post-orientation dimensions."""
    hdr = parse_header(data)
    return hdr.oriented_xsize, hdr.oriented_ysize


@dataclasses.dataclass
class BasicInfo:
    """Mirror of JxlBasicInfo surface used by the reference
    (interop/JxlDecoding.cpp:85-111)."""
    xsize: int
    ysize: int
    bits_per_sample: int
    float_samples: bool
    alpha: bool
    alpha_premultiplied: bool
    orientation: int
    have_animation: bool
    intensity_target: float
    uses_original_profile: bool


def basic_info(data: bytes) -> BasicInfo:
    hdr = parse_header(data)
    m = hdr.metadata
    alpha_idx = m.alpha_index
    return BasicInfo(
        xsize=hdr.oriented_xsize,
        ysize=hdr.oriented_ysize,
        bits_per_sample=m.bit_depth.bits_per_sample,
        float_samples=m.bit_depth.float_sample,
        alpha=alpha_idx is not None,
        alpha_premultiplied=(alpha_idx is not None
                             and m.extra_channels[alpha_idx].alpha_associated),
        orientation=m.orientation,
        have_animation=m.animation is not None,
        intensity_target=m.tone_mapping.intensity_target,
        uses_original_profile=not m.xyb_encoded,
    )


def apply_orientation(pixels, orientation: int):
    """EXIF-style orientation 1..8 -> upright pixels (the reference
    resolves orientation before returning bitmaps,
    JniDecoding.cpp:95-100)."""
    import numpy as np
    if orientation == 1:
        return pixels
    if orientation == 2:
        return pixels[:, ::-1]
    if orientation == 3:
        return pixels[::-1, ::-1]
    if orientation == 4:
        return pixels[::-1]
    if orientation == 5:  # transpose
        return np.swapaxes(pixels, 0, 1)
    if orientation == 6:  # rotate 90 CW
        return np.swapaxes(pixels, 0, 1)[:, ::-1]
    if orientation == 7:  # anti-transpose
        return np.swapaxes(pixels, 0, 1)[::-1, ::-1]
    if orientation == 8:  # rotate 90 CCW
        return np.swapaxes(pixels, 0, 1)[::-1]
    raise InvalidJXLError(f"bad orientation {orientation}")
