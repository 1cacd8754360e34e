"""Resampling weights and output sizes, in numpy
(``jxl_coder_tpu/ops/resize.py:25-128``).

The port's copy of the JAX module's host part: the 10 filter kernels
(``KERNELS``, ids as ``ResizeFilter``), ``resample_matrix`` (the
(out, in) row-normalised weights, bit for bit the original's) and the
FIT / FILL sizes.  ``band`` and ``plan`` are the port's own: the
device's banded resample (``ops/resize.py``) reads only each output's
run of nonzero weights, and ``plan`` is the size and centre crop of
``rescale_image`` (``:131-166``) for a scale mode.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Tuple

import numpy as np


# ---- kernel functions (support radius, weight fn) ------------------------

def _box(x):
    return np.where(np.abs(x) <= 0.5, 1.0, 0.0)


def _triangle(x):
    x = np.abs(x)
    return np.maximum(0.0, 1.0 - x)


def _cubic_bc(x, b, c):
    x = np.abs(x)
    x2 = x * x
    x3 = x2 * x
    p1 = ((12 - 9 * b - 6 * c) * x3 + (-18 + 12 * b + 6 * c) * x2
          + (6 - 2 * b)) / 6.0
    p2 = ((-b - 6 * c) * x3 + (6 * b + 30 * c) * x2
          + (-12 * b - 48 * c) * x + (8 * b + 24 * c)) / 6.0
    return np.where(x < 1.0, p1, np.where(x < 2.0, p2, 0.0))


def _sinc(x):
    return np.sinc(x)


def _lanczos(x, a=3.0):
    ax = np.abs(x)
    return np.where(ax < a, _sinc(x) * _sinc(x / a), 0.0)


def _hermite(x):
    x = np.abs(x)
    return np.where(x < 1.0, (2 * x - 3) * x * x + 1, 0.0)


def _hann(x, a=3.0):
    ax = np.abs(x)
    return np.where(ax < a, _sinc(x) * (0.5 + 0.5 * np.cos(np.pi * x / a)),
                    0.0)


def _mitchell(x):
    return _cubic_bc(x, 1 / 3, 1 / 3)


def _catmull_rom(x):
    return _cubic_bc(x, 0.0, 0.5)


def _bspline(x):
    return _cubic_bc(x, 1.0, 0.0)


def _bicubic(x):
    return _cubic_bc(x, 0.0, 0.75)


# id -> (radius, fn); ids match ResizeFilter / JxlResizeFilter.kt
KERNELS = {
    1: (1.0, _triangle),        # BILINEAR
    2: (0.5, _box),             # NEAREST
    3: (2.0, _mitchell),        # CUBIC
    4: (2.0, _mitchell),        # MITCHELL
    5: (3.0, _lanczos),         # LANCZOS
    6: (2.0, _catmull_rom),     # CATMULL_ROM
    7: (1.0, _hermite),         # HERMITE
    8: (2.0, _bspline),         # BSPLINE
    9: (3.0, _hann),            # HANN
    10: (2.0, _bicubic),        # BICUBIC
}


@functools.lru_cache(maxsize=128)
def resample_matrix(in_size: int, out_size: int,
                    filter_id: int) -> np.ndarray:
    """(out_size, in_size) row-normalized resampling weights.  Taps past
    an edge fold onto the edge index, so one index can sum several
    weights; a row whose weights sum to 0 takes its nearest index."""
    radius, fn = KERNELS[filter_id]
    scale = in_size / out_size
    support = radius * max(1.0, scale)
    w = np.zeros((out_size, in_size), np.float32)
    for o in range(out_size):
        center = (o + 0.5) * scale - 0.5
        lo = int(math.floor(center - support))
        hi = int(math.ceil(center + support)) + 1
        idx = np.arange(lo, hi)
        x = (idx - center) / max(1.0, scale)
        vals = fn(x)
        idx_c = np.clip(idx, 0, in_size - 1)
        for i, v in zip(idx_c, vals):
            w[o, i] += v
        s = w[o].sum()
        if s != 0:
            w[o] /= s
        else:
            w[o, np.clip(int(round(center)), 0, in_size - 1)] = 1.0
    return w


class Band(NamedTuple):
    """The nonzero run of each row of a resample matrix: row o's weights
    are ``weights[o, :length[o]]`` at input indices ``first[o]`` on
    (zeros inside the run kept, rows padded with zeros to the longest)."""
    first: np.ndarray       # (out,) int32
    length: np.ndarray      # (out,) int32
    weights: np.ndarray     # (out, longest) float32


@functools.lru_cache(maxsize=128)
def band(in_size: int, out_size: int, filter_id: int, start: int = 0,
         count: int = None) -> Band:
    """The band of rows start .. start + count of resample_matrix."""
    w = resample_matrix(in_size, out_size, filter_id)
    w = w[start:start + (out_size - start if count is None else count)]
    nz = w != 0
    any_nz = nz.any(axis=1)
    first = np.where(any_nz, nz.argmax(axis=1), 0)
    last = np.where(any_nz, in_size - 1 - nz[:, ::-1].argmax(axis=1), -1)
    length = (last - first + 1).astype(np.int32)
    longest = max(int(length.max(initial=0)), 1)
    cols = np.minimum(first[:, None] + np.arange(longest), in_size - 1)
    weights = np.where(np.arange(longest) < length[:, None],
                       np.take_along_axis(w, cols, axis=1), 0.0)
    return Band(first.astype(np.int32), length,
                np.ascontiguousarray(weights, np.float32))


def _fit_size(w, h, tw, th) -> Tuple[int, int]:
    s = min(tw / w, th / h)
    return max(1, round(w * s)), max(1, round(h * s))


def _fill_size(w, h, tw, th) -> Tuple[int, int]:
    s = max(tw / w, th / h)
    return max(1, round(w * s)), max(1, round(h * s))


class Plan(NamedTuple):
    """The resampled size (oh, ow) and the window of it kept: rows
    y0 .. y0 + ch, columns x0 .. x0 + cw."""
    oh: int
    ow: int
    y0: int
    x0: int
    ch: int
    cw: int


def plan(h: int, w: int, target_w: int, target_h: int,
         scale_mode: int) -> Plan:
    """rescale_image's sizes: 1 FIT (aspect kept, inside the target), 2
    FILL (aspect kept, covering the target, centre-cropped to it), 3
    RESIZE (the target exactly)."""
    if scale_mode == 1:
        ow, oh = _fit_size(w, h, target_w, target_h)
    elif scale_mode == 2:
        ow, oh = _fill_size(w, h, target_w, target_h)
        x0, y0 = max(0, (ow - target_w) // 2), max(0, (oh - target_h) // 2)
        return Plan(oh, ow, y0, x0, min(target_h, oh - y0),
                    min(target_w, ow - x0))
    else:
        ow, oh = target_w, target_h
    return Plan(oh, ow, 0, 0, oh, ow)
