"""sRGB transfer functions (``jxl_coder_tpu/ops/color.py:19-28``).

The rest of the JAX module (the other transfer functions, gamut, tone
mapping) is not ported yet.  Both functions take float32 tensors and
round their ``pow`` and division as ``jnp`` does on the CPU (``fp``),
so the round-1 encoder quantises the same integers as the JAX package.
"""

from __future__ import annotations

import torch

from .fp import div, powf


def srgb_to_linear(v: torch.Tensor) -> torch.Tensor:
    return torch.where(v <= 0.04045, div(v, 12.92),
                       powf(div(v + 0.055, 1.055), 2.4))


def linear_to_srgb(v: torch.Tensor) -> torch.Tensor:
    v = torch.clamp_min(v, 0.0)
    return torch.where(v <= 0.0031308, v * 12.92,
                       1.055 * powf(v, 1 / 2.4) - 0.055)
