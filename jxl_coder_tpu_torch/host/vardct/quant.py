"""Quantization tables + quantizer for the VarDCT path.

Round-1 scope: 8x8 DCT with our own default dequant weights (documented
deviation until the spec default-weight tables are pinned — see
docs/CONFORMANCE.md).  Structure mirrors the spec: a global scale, a
per-block quant-field multiplier, per-channel 64-entry dequant matrices,
and separate LF (DC) quantization steps.
"""

from __future__ import annotations

import functools

import numpy as np

# XYB channel order used throughout the VarDCT path: 0=X, 1=Y, 2=B.

# Base quantization steps at Butteraugli distance 1.0 for DC (LF).
LF_STEPS = np.array([1.0 / 4096, 1.0 / 1024, 1.0 / 512], np.float32)


@functools.lru_cache(maxsize=None)
def default_dequant_matrix(block: int = 8) -> np.ndarray:
    """(3, block, block) dequant step sizes at distance 1.0.

    Radial-ramp model: low frequencies get fine steps, high frequencies
    coarse, with per-channel scaling reflecting XYB amplitude ranges
    (X is ~20x smaller than Y; B carries Y via CfL so its residual is
    also small).
    """
    i = np.arange(block)[:, None]
    j = np.arange(block)[None, :]
    d = np.sqrt(i * i + j * j) / np.sqrt(2 * (block - 1) ** 2)
    ramp = 1.0 + 6.0 * d * d  # 1 .. 7
    base = np.stack([
        ramp * (1.0 / 2048.0),   # X
        ramp * (1.0 / 512.0),    # Y
        ramp * (1.0 / 256.0),    # B residual
    ]).astype(np.float32)
    return base


def quality_to_distance(quality: int) -> float:
    """The reference's quality->Butteraugli-distance curve
    (interop/JxlEncoding.cpp:38-46; jxl_coder_tpu/vardct/quant.py:48-55)."""
    if quality == 0:
        return 1.0
    if quality >= 30:
        return max(0.0, min(15.0, 0.1 + (100 - quality) * 0.09))
    return max(0.0, min(25.0, 6.24 + 2.5 ** ((30.0 - quality) / 5.0) / 6.25))
