"""Whole-frame VarDCT reconstruction on a torch device.

``VarDCTFrame`` is the counterpart of the ``fn`` / ``fn_post`` that
``jxl_coder_tpu.vardct.tpu_full._build_fn`` returns (and of
``reconstruct_state_device``): synthesis of every family straight into
the (3, H8, W8) XYB planes, the crop to the true image size, the EPF
sigma map, then the filter chain and the sRGB output at 8 or 16 bits as
one tile pass (``filters.restore_and_output``).  A frame with post
stages (the patch and spline overlay, noise, upsampling, another output
encoding) takes the filtered XYB planes from that pass instead ("f32"
out) and hands them to ``post.PostStages``; a frame's extra channels are
stacked after its colour (``post.extra_channels``).  An LF or reference
frame's output is its XYB planes (``VarDCTFrame.xyb``: kernel 2's "f32"
out, then its own overlay and noise; no upsampling, no output step).
"""

from __future__ import annotations

import torch
from torch import nn

from .filters import restore_and_output, sigma_map
from .inputs import FrameConfig, FrameInputs
from .post import PostStages, extra_channels
from .synth import synth_family


class VarDCTFrame(nn.Module):
    """One frame geometry; forward(inputs) -> (H, W, 3 + extra channels)
    uint8/uint16 on the device the inputs live on."""

    def __init__(self, config: FrameConfig):
        super().__init__()
        self.config = config
        post = config.post
        self.post = (PostStages(post) if post is not None
                     and not post.colour_empty else None)

    def forward(self, inputs: FrameInputs) -> torch.Tensor:
        rgb = self.colour(inputs)
        if not inputs.ec:
            return rgb
        return torch.cat([rgb] + [p[..., None] for p in extra_channels(
            inputs.ec, self.config.post, rgb.dtype)], -1)

    def colour(self, inputs: FrameInputs) -> torch.Tensor:
        """The colour channels: (H, W, 3) codes."""
        if self.post is None:
            return self.reconstruct(inputs, "u16" if self.config.bits > 8
                                    else "u8")
        return self.post(self.reconstruct(inputs, "f32"), inputs.overlay,
                         inputs.refs)

    def xyb(self, inputs: FrameInputs) -> torch.Tensor:
        """An LF or reference frame's output: the filtered (3, h, w) f32
        XYB planes after its overlay and noise."""
        xyb = self.reconstruct(inputs, "f32")
        post = self.config.post
        if post is None or (post.overlay is None and post.noise_lut is None):
            return xyb
        return PostStages(post).xyb(xyb, inputs.overlay, inputs.refs)

    def reconstruct(self, inputs: FrameInputs, out: str) -> torch.Tensor:
        """Synthesis, then kernel 2's pass: the filtered (3, h, w) f32
        XYB planes (out "f32") or the sRGB codes."""
        cfg = self.config
        dev = inputs.dc.device
        # every pixel of the block grid belongs to exactly one varblock;
        # zeros keep a malformed stream from exposing stale memory
        planes = torch.zeros((3, cfg.H8, cfg.W8), dtype=torch.float32,
                             device=dev)
        for fam in inputs.families:
            synth_family(planes, fam, inputs.dc, inputs.qm)
        # filters run at the true image size with Mirror() borders
        xyb = planes[:, :cfg.crop_h, :cfg.crop_w]
        if cfg.epf_iters >= 1:
            sigma = sigma_map(inputs.sharp, inputs.qf, inputs.igs)
        else:
            sigma = None
        return restore_and_output(xyb, sigma, cfg.gab, cfg.epf_iters,
                                  cfg.gabw, cfg.pass0_scale, cfg.pass2_scale,
                                  out)
