"""XYB <-> linear sRGB (``jxl_coder_tpu/vardct/xyb.py:20-60``).

Constants are built from ``host/bitstream/headers.py`` (the port's copy
of ``jxl_coder_tpu.bitstream.headers``) exactly as the JAX module builds
them.  The 3x3 mixes sum as XLA's CPU dot does
(``fp.contract3``) and the cube root is glibc's ``powf(x, 1/3)``, which
is what ``jnp.cbrt`` runs on the CPU (``fp.powf``): torch has no cbrt,
and ``torch.pow`` in float32 rounds differently.
"""

from __future__ import annotations

import numpy as np
import torch

from ..host.bitstream.headers import DEFAULT_INV_OPSIN, DEFAULT_OPSIN_BIAS
from ..ops.fp import contract3, powf

OPSIN_ABSORBANCE = np.linalg.inv(
    np.array(DEFAULT_INV_OPSIN, np.float64).reshape(3, 3)).astype(np.float32)
OPSIN_BIAS = np.float32(-DEFAULT_OPSIN_BIAS[0])
CBRT_BIAS = np.cbrt(OPSIN_BIAS)
INV_OPSIN = np.array(DEFAULT_INV_OPSIN, np.float32).reshape(3, 3)


def linear_rgb_to_xyb(rgb: torch.Tensor) -> torch.Tensor:
    """(3, H, W) linear sRGB -> (3, H, W) XYB."""
    mix = contract3(OPSIN_ABSORBANCE, rgb)
    mix = torch.clamp_min(mix + float(OPSIN_BIAS), 1e-12)
    gamma = powf(mix, 1 / 3) - float(CBRT_BIAS)
    l, m, s = gamma[0], gamma[1], gamma[2]
    return torch.stack([(l - m) * 0.5, (l + m) * 0.5, s])


def xyb_to_linear_rgb(xyb: torch.Tensor) -> torch.Tensor:
    """(3, H, W) XYB -> (3, H, W) linear sRGB (default opsin inverse)."""
    x, y, b = xyb[0], xyb[1], xyb[2]
    gamma = torch.stack([x + y, y - x, b]) + float(CBRT_BIAS)
    mixed = gamma * gamma * gamma - float(OPSIN_BIAS)
    return contract3(INV_OPSIN, mixed)
