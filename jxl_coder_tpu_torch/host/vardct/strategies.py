"""AC (transform) strategy catalogue.

Geometry per raw strategy id (cf. ac_strategy.h LUTs), the order bucket
used for coefficient-order and block-context purposes
(kStrategyOrder), and the dequant-table kind shared between transposed
variants.  Scan-position semantics: a varblock covering cx*cy blocks
codes size = cx*cy*64 coefficient slots; slots [0, cx*cy) are the LLF
(derived from the DC image, never coded); slots [cx*cy, size) are coded
in scan order.  The scan->basis mapping and the dequant tables are
calibrated numerically against the reference decoder (see
research/strategy_calib.py) and stored in calib_real.npz.
"""

import dataclasses


@dataclasses.dataclass(frozen=True)
class Strategy:
    id: int
    name: str
    cx: int            # covered blocks horizontally
    cy: int            # covered blocks vertically
    order_bucket: int  # kStrategyOrder
    quant_kind: str    # shared dequant-table key

    @property
    def covered(self):
        return self.cx * self.cy

    @property
    def log2_covered(self):
        return (self.covered - 1).bit_length()

    @property
    def width(self):
        return self.cx * 8

    @property
    def height(self):
        return self.cy * 8

    @property
    def num_coeffs(self):
        return self.covered * 64


_DEFS = [
    # id, name, cx, cy, order bucket, quant kind
    (0, "DCT", 1, 1, 0, "DCT8"),
    (1, "IDENTITY", 1, 1, 1, "IDENTITY"),
    (2, "DCT2X2", 1, 1, 1, "DCT2X2"),
    (3, "DCT4X4", 1, 1, 1, "DCT4X4"),
    (4, "DCT16X16", 2, 2, 2, "DCT16"),
    (5, "DCT32X32", 4, 4, 3, "DCT32"),
    (6, "DCT16X8", 1, 2, 4, "DCT8X16"),
    (7, "DCT8X16", 2, 1, 4, "DCT8X16"),
    (8, "DCT32X8", 1, 4, 5, "DCT8X32"),
    (9, "DCT8X32", 4, 1, 5, "DCT8X32"),
    (10, "DCT32X16", 2, 4, 6, "DCT16X32"),
    (11, "DCT16X32", 4, 2, 6, "DCT16X32"),
    (12, "DCT4X8", 1, 1, 1, "DCT4X8"),
    (13, "DCT8X4", 1, 1, 1, "DCT4X8"),
    (14, "AFV0", 1, 1, 1, "AFV"),
    (15, "AFV1", 1, 1, 1, "AFV"),
    (16, "AFV2", 1, 1, 1, "AFV"),
    (17, "AFV3", 1, 1, 1, "AFV"),
    (18, "DCT64X64", 8, 8, 7, "DCT64"),
    (19, "DCT64X32", 4, 8, 8, "DCT32X64"),
    (20, "DCT32X64", 8, 4, 8, "DCT32X64"),
    (21, "DCT128X128", 16, 16, 9, "DCT128"),
    (22, "DCT128X64", 8, 16, 10, "DCT64X128"),
    (23, "DCT64X128", 16, 8, 10, "DCT64X128"),
    (24, "DCT256X256", 32, 32, 11, "DCT256"),
    (25, "DCT256X128", 16, 32, 12, "DCT128X256"),
    (26, "DCT128X256", 32, 16, 12, "DCT128X256"),
]

STRATEGIES = {d[0]: Strategy(*d) for d in _DEFS}

# covered_blocks LUT cross-check (ac_strategy.h): cx values
_CX = [1, 1, 1, 1, 2, 4, 1, 2, 1, 4, 2, 4, 1, 1, 1, 1, 1, 1,
       8, 4, 8, 16, 8, 16, 32, 16, 32]
_CY = [1, 1, 1, 1, 2, 4, 2, 1, 4, 1, 4, 2, 1, 1, 1, 1, 1, 1,
       8, 8, 4, 16, 16, 8, 32, 32, 16]
for _i, _s in STRATEGIES.items():
    assert _s.cx == _CX[_i] and _s.cy == _CY[_i], _i
