"""A Modular frame's planes -> pixels, on the device the planes lie on.

The counterpart of ``jxl_coder_tpu/codec.py`` ``_finalize_modular_planes``
(``:204-269``) and of the stack in ``api.decode`` (``api.py:558-565``):
- not XYB: the colour channels (1 or 3) and the extra channels (alpha)
  cropped to the signalled size, clipped to [0, 2^bits - 1] and stacked
  as uint8, or uint16 above 8 bits;
- XYB (``cjxl -m -d``): (Y, X, B - Y) times the LfGlobal DC dequant
  factors, then XYB -> sRGB8/16 through kernel 2's output step,
  ``vardct/filters.py`` ``restore_and_output`` with gaborish and EPF off
  (one ``chain_kernel`` launch on a CUDA tensor, its plain twin
  ``color.xyb_to_srgb_plain`` on a CPU one; within 1 code on under 0.1%
  of pixels of the JAX package's host conversion,
  ``dec_real.xyb_planes_to_srgb8``).
The rest is plain PyTorch: the JAX package does this step on the host;
it is no Pallas kernel.  Frame upsampling and extra-channel upsampling
raise in
``check_supported``, which the caller runs before the channel decode
(``api.decode`` does): the port has no upsampler yet.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..vardct import filters

# gaborish weights for restore_and_output; unused with gaborish off
_NO_GABORISH = (0.0,) * 6


def check_supported(hdr, fh) -> None:
    """Raise NotImplementedError for a frame whose output needs an
    upsampler (frame upsampling, or an extra channel's ec_upsampling <<
    dim_shift above 1)."""
    todo = ("the port has no upsampler yet (ROADMAP.md queue 1 item 5, "
            "post stages)")
    if fh.upsampling > 1:
        raise NotImplementedError(f"Modular frame upsampling "
                                  f"{fh.upsampling}x: {todo}")
    for i, ec in enumerate(hdr.metadata.extra_channels):
        up = fh.ec_upsampling[i] if i < len(fh.ec_upsampling) else 1
        if up << ec.dim_shift > 1:
            raise NotImplementedError(
                f"extra channel {i} upsampled {up << ec.dim_shift}x: {todo}")


def modular_pixels(planes: List[torch.Tensor], hdr, fh,
                   dc_quant) -> torch.Tensor:
    """(H, W, C) pixels, C the colour channels plus the extra channels,
    uint8 at 8 bits or less per sample and uint16 above, for a frame that
    passed ``check_supported``."""
    m = hdr.metadata
    ncolor = 1 if (m.colour_encoding.colour_space == 1
                   and not m.xyb_encoded) else 3
    bits = m.bit_depth.bits_per_sample
    full_w = fh.frame_width or hdr.xsize
    full_h = fh.frame_height or hdr.ysize
    if len(planes) < ncolor:
        arrs = list(planes)
    else:
        if m.xyb_encoded:
            cy, cx, cb = (p.to(torch.float32) for p in planes[:3])
            xyb = torch.stack([cx * float(np.float32(dc_quant[0])),
                               cy * float(np.float32(dc_quant[1])),
                               (cy + cb) * float(np.float32(dc_quant[2]))])
            rgb = filters.restore_and_output(
                xyb[:, :full_h, :full_w], None, False, 0, _NO_GABORISH, 1.0,
                1.0, "u16" if bits > 8 else "u8")
            colour = [rgb[..., c].to(torch.int32) for c in range(3)]
        else:
            colour = [p[:full_h, :full_w] for p in planes[:ncolor]]
        ecs = [p[:full_h, :full_w]
               for p in planes[ncolor:ncolor + len(m.extra_channels)]]
        arrs = colour + ecs
    maxval = (1 << bits) - 1
    out = torch.stack([p.clamp(0, maxval) for p in arrs], -1)
    return out.to(torch.uint8 if bits <= 8 else torch.uint16)
