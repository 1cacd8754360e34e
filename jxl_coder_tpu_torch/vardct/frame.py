"""Whole-frame VarDCT reconstruction on a torch device.

``VarDCTFrame`` is the counterpart of the ``fn`` that
``jxl_coder_tpu.vardct.tpu_full._build_fn`` returns (and of
``reconstruct_state_device``): synthesis of every family straight into
the (3, H8, W8) XYB planes, the crop to the true image size, the EPF
sigma map, then the filter chain and the sRGB output at 8 or 16 bits as
one tile pass (``filters.restore_and_output``).
"""

from __future__ import annotations

import torch
from torch import nn

from .filters import restore_and_output, sigma_map
from .inputs import FrameConfig, FrameInputs
from .synth import synth_family


class VarDCTFrame(nn.Module):
    """One frame geometry; forward(inputs) -> (H, W, 3) uint8/uint16 on
    the device the inputs live on."""

    def __init__(self, config: FrameConfig):
        super().__init__()
        self.config = config

    def forward(self, inputs: FrameInputs) -> torch.Tensor:
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
                                  "u16" if cfg.bits > 8 else "u8")
