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
- upsampling: the coded frame is 1/upsampling of the signalled size;
  the planes scale back up through the upsampling kernel
  (``vardct/post.py`` ``upsample``, A6: one launch for the colour
  planes), in XYB space for an XYB frame, in channel space with ``rint``
  otherwise; each extra channel by its own ``ec_upsampling <<
  dim_shift``, with the default kernels, as the reference.
The rest is plain PyTorch: the JAX package does this step on the host;
it is no Pallas kernel.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..host.vardct.dec_real import upsample_weights
from ..vardct import filters, post

# gaborish weights for restore_and_output; unused with gaborish off
_NO_GABORISH = (0.0,) * 6


def xyb_planes(planes: List[torch.Tensor], dc_quant) -> torch.Tensor:
    """(Y, X, B - Y) integer channels times the LfGlobal DC dequant
    factors -> (3, h, w) f32 XYB planes (``codec.py:272-280``): an XYB
    frame's colour, and an LF or reference frame's output."""
    cy, cx, cb = (p.to(torch.float32) for p in planes[:3])
    return torch.stack([cx * float(np.float32(dc_quant[0])),
                        cy * float(np.float32(dc_quant[1])),
                        (cy + cb) * float(np.float32(dc_quant[2]))])


def srgb_codes(xyb: torch.Tensor, bits: int) -> torch.Tensor:
    """(3, H, W) f32 XYB planes -> (H, W, 3) sRGB codes, uint8 at `bits`
    <= 8, else uint16: kernel 2's output step with every filter off."""
    return filters.restore_and_output(xyb, None, False, 0, _NO_GABORISH,
                                      1.0, 1.0, "u16" if bits > 8 else "u8")


def modular_pixels(planes: List[torch.Tensor], hdr, fh,
                   dc_quant) -> torch.Tensor:
    """(H, W, C) pixels, C the colour channels plus the extra channels,
    uint8 at 8 bits or less per sample and uint16 above."""
    m = hdr.metadata
    ncolor = 1 if (m.colour_encoding.colour_space == 1
                   and not m.xyb_encoded) else 3
    bits = m.bit_depth.bits_per_sample
    full_w = fh.frame_width or hdr.xsize
    full_h = fh.frame_height or hdr.ysize
    up = fh.upsampling
    weights = upsample_weights(m, up) if up > 1 else None
    if len(planes) < ncolor:
        arrs = list(planes)
    else:
        if m.xyb_encoded:
            xyb = xyb_planes(planes, dc_quant)
            if up > 1:
                xyb = post.upsample(xyb, post.kernels_for(up, weights,
                                                          xyb.device))
            rgb = srgb_codes(xyb[:, :full_h, :full_w], bits)
            colour = [rgb[..., c].to(torch.int32) for c in range(3)]
        else:
            colour = [p[:full_h, :full_w]
                      for p in post.upsample_ints(planes[:ncolor], up,
                                                  weights)]
        ecs = []
        for i, ec in enumerate(m.extra_channels):
            if ncolor + i >= len(planes):
                break
            ec_up = (fh.ec_upsampling[i] if i < len(fh.ec_upsampling)
                     else 1) << ec.dim_shift
            p = post.upsample_ints([planes[ncolor + i]], ec_up)[0]
            ecs.append(p[:full_h, :full_w])
        arrs = colour + ecs
    maxval = (1 << bits) - 1
    out = torch.stack([p.clamp(0, maxval) for p in arrs], -1)
    return out.to(torch.uint8 if bits <= 8 else torch.uint16)
