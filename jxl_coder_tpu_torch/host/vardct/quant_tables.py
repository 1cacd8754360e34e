"""Custom dequant matrices (HfGlobal DequantMatrices, quant_weights.*).

When HfGlobal's all_default bit is off, each of the 17 quant tables is
re-coded in one of 8 modes (library default, identity weights, DCT2,
DCT4, DCT4X8, AFV, distance-band DCT, or a RAW modular-coded table).
We keep the numerically calibrated default tables for kQuantModeLibrary
and compute the others from the coded parameters; conventions are
pinned with single-coefficient probe streams decoded by libjxl
(research notes), mirroring how the default tables were calibrated.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from ..bitstream.reader import BitReader, BitstreamError

NUM_QUANT_TABLES = 17
MODE_LIBRARY = 0
MODE_ID = 1
MODE_DCT2 = 2
MODE_DCT4 = 3
MODE_DCT4X8 = 4
MODE_AFV = 5
MODE_DCT = 6
MODE_RAW = 7

# strategy id -> quant table index (kAcStrategyToQuantTableMap)
STRATEGY_TO_TABLE = [0, 1, 2, 3, 4, 5, 6, 6, 7, 7, 8, 8, 9, 9,
                     10, 10, 10, 10, 11, 12, 12, 13, 14, 14, 15, 16, 16]

# per quant table: (xsize blocks, ysize blocks) of the canonical layout
TABLE_SIZE_X = [1, 1, 1, 1, 2, 4, 1, 1, 2, 1, 1, 8, 4, 16, 8, 32, 16]
TABLE_SIZE_Y = [1, 1, 1, 1, 2, 4, 2, 4, 4, 1, 1, 8, 8, 16, 16, 32, 32]

# canonical strategy id per table (the non-transposed variant)
TABLE_TO_STRATEGY = [0, 1, 2, 3, 4, 5, 6, 8, 10, 12, 14, 18, 20,
                     21, 23, 24, 26]


@dataclasses.dataclass
class DctParams:
    num_bands: int
    bands: np.ndarray  # (3, num_bands), band 0 already *64


def _read_dct_params(br: BitReader) -> DctParams:
    n = br.u(4) + 1
    bands = np.zeros((3, n))
    for c in range(3):
        for i in range(n):
            bands[c, i] = br.f16()
        if bands[c, 0] < 1e-8:
            raise BitstreamError("dct params: zero band")
        bands[c, 0] *= 64.0
    return DctParams(n, bands)


@dataclasses.dataclass
class QuantEncoding:
    mode: int
    dct_params: Optional[DctParams] = None
    dct_params2: Optional[DctParams] = None   # AFV 4x4
    weights: Optional[np.ndarray] = None      # ID (3,3)/DCT2 (3,6)/AFV (3,9)
    multipliers: Optional[np.ndarray] = None  # DCT4 (3,2) / DCT4X8 (3,)
    qraw: Optional[np.ndarray] = None         # (3, ysize, xsize) ints
    qraw_den: float = 1.0 / (8 * 255)


def read_quant_encoding(br: BitReader, idx: int, read_modular
                        ) -> QuantEncoding:
    """read_modular(idx, xsize, ysize) -> (3, ysize, xsize) int array
    for RAW tables (a modular sub-stream decode supplied by the
    caller)."""
    mode = br.u(3)
    required = TABLE_SIZE_X[idx] * TABLE_SIZE_Y[idx]
    enc = QuantEncoding(mode)
    if mode == MODE_LIBRARY:
        # predefined index: kCeilLog2NumPredefinedTables == 0 bits
        return enc
    if mode == MODE_ID:
        if required != 1:
            raise BitstreamError("ID quant mode on multi-block table")
        enc.weights = np.array([[br.f16() for _ in range(3)]
                                for _ in range(3)])
        return enc
    if mode == MODE_DCT2:
        if required != 1:
            raise BitstreamError("DCT2 quant mode on multi-block table")
        enc.weights = np.array([[br.f16() for _ in range(6)]
                                for _ in range(3)])
        return enc
    if mode == MODE_DCT4:
        if required != 1:
            raise BitstreamError("DCT4 quant mode on multi-block table")
        enc.dct_params = _read_dct_params(br)
        enc.multipliers = np.array([[br.f16() for _ in range(2)]
                                    for _ in range(3)])
        return enc
    if mode == MODE_DCT4X8:
        if required != 1:
            raise BitstreamError("DCT4X8 quant mode on multi-block table")
        enc.dct_params = _read_dct_params(br)
        enc.multipliers = np.array([br.f16() for _ in range(3)])
        return enc
    if mode == MODE_AFV:
        if required != 1:
            raise BitstreamError("AFV quant mode on multi-block table")
        enc.dct_params = _read_dct_params(br)
        enc.dct_params2 = _read_dct_params(br)
        enc.weights = np.array([[br.f16() for _ in range(9)]
                                for _ in range(3)])
        return enc
    if mode == MODE_DCT:
        enc.dct_params = _read_dct_params(br)
        return enc
    if mode == MODE_RAW:
        enc.qraw_den = br.f16()
        enc.qraw = read_modular(idx, TABLE_SIZE_X[idx] * 8,
                                TABLE_SIZE_Y[idx] * 8)
        return enc
    raise BitstreamError(f"bad quant mode {mode}")


def _mult(v: float) -> float:
    return 1.0 + v if v > 0 else 1.0 / (1.0 - v)


def _interpolate(pos: float, maxv: float, arr: np.ndarray) -> float:
    scaled = pos * (len(arr) - 1) / maxv
    idx = min(int(scaled), len(arr) - 2)
    frac = scaled - idx
    return arr[idx] * (arr[idx + 1] / arr[idx]) ** frac


def _dct_weights(rows: int, cols: int, bands_c: np.ndarray) -> np.ndarray:
    """GetQuantWeights: geometric band interpolation over the scaled
    frequency radius."""
    n = len(bands_c)
    bands = np.empty(n)
    bands[0] = bands_c[0]
    for i in range(1, n):
        bands[i] = bands[i - 1] * _mult(bands_c[i])
        if bands[i] < 1e-8:
            raise BitstreamError("negative interpolated band")
    out = np.empty((rows, cols))
    sqrt2 = np.sqrt(2.0) + 1e-6
    for y in range(rows):
        for x in range(cols):
            dx = x / (cols - 1) if cols > 1 else 0.0
            dy = y / (rows - 1) if rows > 1 else 0.0
            dist = np.sqrt(dx * dx + dy * dy)
            out[y, x] = _interpolate(dist, sqrt2, bands) if n > 1 \
                else bands[0]
    return out


def compute_table(enc: QuantEncoding, table_idx: int, c: int
                  ) -> Optional[np.ndarray]:
    """Dequant steps per basis index (ky*W + kx) for the canonical
    orientation of `table_idx`, at inv_qac=1 — the same layout as the
    calibrated defaults.  Returns None for kQuantModeLibrary."""
    if enc.mode == MODE_LIBRARY:
        return None
    rows = TABLE_SIZE_Y[table_idx] * 8
    cols = TABLE_SIZE_X[table_idx] * 8
    if enc.mode == MODE_DCT:
        w = _dct_weights(rows, cols, enc.dct_params.bands[c])
        return (1.0 / w).ravel()
    if enc.mode == MODE_RAW:
        q = enc.qraw[c].astype(np.float64)
        if np.any(q <= 0):
            raise BitstreamError("RAW quant table non-positive")
        # RAW tables (JPEG recompression) are stored transposed
        # relative to the canonical ky*W+kx order, and libjxl folds
        # 1/(1-quant_bias[c]) into them so AdjustQuantBias cancels
        # exactly at |coeff| == 1 — both pinned by single-coefficient
        # probe streams against libjxl 0.7 output.
        from .synthesis import QUANT_BIAS
        return (q.T * enc.qraw_den).ravel() * (
            _TABLE_SCALE_RAW / (1.0 - QUANT_BIAS[c]))
    if enc.mode == MODE_ID:
        w = np.full((8, 8), enc.weights[c][0])
        w[0, 1] = w[1, 0] = enc.weights[c][1]
        w[1, 1] = enc.weights[c][2]
        return (1.0 / w).ravel()
    if enc.mode == MODE_DCT2:
        ww = enc.weights[c]
        w = np.empty((8, 8))
        w[:1, :1] = 1.0
        w[0, 1] = w[1, 0] = ww[0]
        w[1, 1] = ww[1]
        w[:2, 2:4] = ww[2]
        w[2:4, :2] = ww[2]
        w[2:4, 2:4] = ww[3]
        w[:4, 4:] = ww[4]
        w[4:, :4] = ww[4]
        w[4:, 4:] = ww[5]
        return (1.0 / w).ravel()
    if enc.mode == MODE_DCT4:
        w4 = _dct_weights(4, 4, enc.dct_params.bands[c])
        w = np.empty((8, 8))
        for y in range(8):
            for x in range(8):
                w[y, x] = w4[y // 2, x // 2]
        w[0, 1] /= enc.multipliers[c][0]
        w[1, 0] /= enc.multipliers[c][0]
        w[1, 1] /= enc.multipliers[c][1]
        return (1.0 / w).ravel()
    if enc.mode == MODE_DCT4X8:
        w48 = _dct_weights(4, 8, enc.dct_params.bands[c])
        w = np.empty((8, 8))
        for y in range(8):
            for x in range(8):
                w[y, x] = w48[y // 2, x]
        w[1, 0] /= enc.multipliers[c]
        return (1.0 / w).ravel()
    raise BitstreamError(f"quant mode {enc.mode} table not implemented")


# Per-channel scale relating 1/weight to our calibrated step units,
# pinned by custom-table probe streams decoded with libjxl (stable to
# ~1e-4 across band shapes/counts): X, Y, B.
CHANNEL_SCALE = (0.9453602, 0.9300000, 0.9500412)
_TABLE_SCALE_RAW = 1.0


def dequant_table_for(encodings: List[QuantEncoding], strategy_id: int,
                      c: int, cache: dict) -> Optional[np.ndarray]:
    """Custom dequant steps for `strategy_id` (basis-index layout,
    transposed for the transposed strategy variants), or None when the
    table uses the library default."""
    table_idx = STRATEGY_TO_TABLE[strategy_id]
    enc = encodings[table_idx]
    if enc.mode == MODE_LIBRARY:
        return None
    key = (strategy_id, c)
    if key in cache:
        return cache[key]
    base = compute_table(enc, table_idx, c)
    rows = TABLE_SIZE_Y[table_idx] * 8
    cols = TABLE_SIZE_X[table_idx] * 8
    if TABLE_TO_STRATEGY[table_idx] != strategy_id:
        base = base.reshape(rows, cols).T.ravel()
    out = base * CHANNEL_SCALE[c]
    cache[key] = out
    return out
