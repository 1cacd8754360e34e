"""Typed configuration (``jxl_coder_tpu/config.py``): the reference has no
config files; its configuration is typed API arguments (the Kotlin enums)
mapped onto the frame settings.  ``EncodeConfig`` and ``DecodeConfig``
hold that surface in one place, with the exact quality -> distance curve
(``host/vardct/quant.quality_to_distance``); ``encode`` and
``decode_sampled`` are front doors over the port's ``api``, on the
`device` they name.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from .host.api import (ChannelsConfiguration, CompressionOption,
                       DecodingSpeed, Effort, EncodingPixelFormat,
                       PreferredColorConfig, ResizeFilter, ScaleMode)
from .host.vardct.quant import quality_to_distance


@dataclasses.dataclass
class EncodeConfig:
    """All encoder knobs, defaulting to the reference's defaults."""
    compression: CompressionOption = CompressionOption.LOSSY
    quality: int = 90
    effort: Effort = Effort.SQUIRREL
    decoding_speed: DecodingSpeed = DecodingSpeed.SLOWEST
    channels: ChannelsConfiguration = ChannelsConfiguration.RGB
    pixel_format: EncodingPixelFormat = EncodingPixelFormat.UNSIGNED_8

    @property
    def lossless(self) -> bool:
        return self.compression == CompressionOption.LOSSLESS

    @property
    def distance(self) -> float:
        return 0.0 if self.lossless else quality_to_distance(self.quality)

    def validate(self) -> None:
        if not 1 <= int(self.effort) <= 10:
            raise ValueError("effort must be 1..10")
        if not 0 <= self.quality <= 100:
            raise ValueError("quality must be 0..100")
        if not 0 <= int(self.decoding_speed) <= 4:
            raise ValueError("decoding_speed must be 0..4")


@dataclasses.dataclass
class DecodeConfig:
    """Decoder-side preferences (the decodeSampled surface)."""
    preferred_color_config: PreferredColorConfig = \
        PreferredColorConfig.DEFAULT
    scale_mode: ScaleMode = ScaleMode.FIT
    resize_filter: ResizeFilter = ResizeFilter.MITCHELL
    target_width: int = 0
    target_height: int = 0


def encode(pixels, config: Optional[EncodeConfig] = None, device="cuda",
           **overrides) -> bytes:
    """api.encode with a config object (fields overridden by keyword)."""
    from . import api
    cfg = config or EncodeConfig()
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    cfg.validate()
    return api.encode(pixels, lossless=cfg.lossless, quality=cfg.quality,
                      effort=int(cfg.effort),
                      decoding_speed=int(cfg.decoding_speed), device=device)


def decode_sampled(data: bytes, config: Optional[DecodeConfig] = None,
                   device="cuda"):
    """api.decode_sampled with a config object."""
    from . import api
    cfg = config or DecodeConfig()
    return api.decode_sampled(
        data, cfg.target_width, cfg.target_height,
        preferred_color_config=int(cfg.preferred_color_config),
        scale_mode=int(cfg.scale_mode),
        resize_filter=int(cfg.resize_filter), device=device)
