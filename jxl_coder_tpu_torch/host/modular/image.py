"""Modular-mode image containers (host-side, numpy int32 planes).

The Modular path is the lossless engine of JPEG XL (SURVEY.md §7.3,
BASELINE config[0]).  Channels are independent int planes with per-channel
downsampling shifts (from Squeeze); group streams cover sub-rectangles.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np


@dataclasses.dataclass
class Channel:
    width: int
    height: int
    hshift: int = 0
    vshift: int = 0
    data: Optional[np.ndarray] = None  # int32 (height, width)

    def alloc(self):
        if self.data is None:
            self.data = np.zeros((self.height, self.width), np.int32)
        return self


@dataclasses.dataclass
class ModularImage:
    channels: List[Channel]
    nb_meta_channels: int = 0

    @staticmethod
    def for_frame(width: int, height: int, nb_channels: int,
                  ec_info=()) -> "ModularImage":
        chans = [Channel(width, height) for _ in range(nb_channels)]
        for ec in ec_info:
            shift = getattr(ec, "dim_shift", 0)
            chans.append(Channel(-(-width // (1 << shift)),
                                 -(-height // (1 << shift))))
        return ModularImage(channels=chans)
