"""An embedded ICC profile read on the host, for its transform to sRGB
(numpy; no torch).

The reference converts a decoded Modular still, and a lossy encode's
input, from its embedded ICC profile to sRGB with littlecms 2.17
(``jxl_coder_tpu/ops/icc_apply.py:22-61``: perceptual intent with
black-point compensation, 8-bit samples).  ``plan`` builds what littlecms
builds for 8-bit RGB to 8-bit RGB: its pipeline from the profile to its
built-in sRGB profile (``host/ops/icc_lut.py``: the input tables or the
matrix and tone curves, the PCS conversion, black-point compensation,
sRGB's inverse), simplified as littlecms simplifies it, then one of its
two 8-bit programs:

- the matrix-shaper program (``OptimizeMatrixShaper``), where the
  pipeline is curves, a matrix and curves: an RGB matrix / TRC profile
  (``rXYZ`` / ``gXYZ`` / ``bXYZ``, ``rTRC`` / ``gTRC`` / ``bTRC`` of
  ``curv`` with 0, 1 or n entries or ``para`` of function types 0-4)
  whose black stays 0.  ``Transform``: each channel's 256-entry input
  shaper in 1.14 fixed point (the curve evaluated in float at i / 255;
  0x7fffffff from 131072 up, so the matrix sums, which wrap in int32 as
  littlecms's do, may leave int32), the 3x3 matrix to sRGB in 1.14 fixed
  point, and the output shaper ``SHAPER2``, shared by every profile: the
  8-bit sRGB code of each of the 16,385 fixed-point values in [0, 1].  A
  matrix within 1/65535 of the identity is dropped as littlecms drops it,
  and its curves joined through a 4096-point 16-bit table
  (``OptimizeByJoiningCurves``); the port then writes each channel's 256
  codes into the input shaper, pointing at the first ``SHAPER2`` entry of
  that code, with an identity matrix, so one per-pixel program serves
  both.
- the CLUT program, for everything else (``icc_lut.ClutTransform``): an
  ``A2B0`` / ``D2B0`` lookup table (what the perceptual intent reads
  before the matrix; an ``A2B1`` / ``A2B2`` alone leaves littlecms on the
  matrix, and the port too), and a matrix / TRC profile whose black is
  not 0, whose black-point compensation adds a stage.

The codes equal littlecms's on the whole 2^24 cube of 8-bit RGB for every
test profile (``port_fixtures.icc_test_profiles`` and
``lut_test_profiles``), with glibc's pow as littlecms uses it.  ``plan``
raises ``Rejected`` where littlecms builds no transform and the reference
returns the pixels unconverted: a profile too short, without the ``acsp``
signature, of the abstract, device-link or named-colour class, whose data
colour space is not RGB (LAB, XYZ, GRAY, CMYK) or whose PCS is neither
XYZ nor Lab, an RGB profile without a table and without a colorant or a
curve, with a curve it cannot read, or with a table it cannot read under
its tag (an ``mft1`` under ``D2B0``) or of other channels than RGB -> 3.

``srgb8_model`` is the float64 model of the matrix-shaper transform (the
curves, the matrix, a clamp to [0, 1], the sRGB curve by its formula,
rint): within 1 code of littlecms's fixed point on about 1% of values.
"""

from __future__ import annotations

import functools
import struct
from typing import NamedTuple

import numpy as np

# littlecms's built-in sRGB profile (cmsCreate_sRGBProfile): the Rec. 709
# primaries and D65 (6504 K) adapted to D50 by Bradford, as the doubles it
# keeps in memory (columns: red, green, blue; rows: X, Y, Z), and its tone
# curve (IEC 61966-2-1: para type 3)
SRGB_D50 = np.array([
    [0.43604125161605084, 0.3851129107981557, 0.14304583758579362],
    [0.22248454022947742, 0.7169050786084579, 0.060610381162065304],
    [0.013920187471375375, 0.09706723869712407, 0.713912573831501]])
SRGB_PARAMS = (2.4, 1 / 1.055, 0.055 / 1.055, 1 / 12.92, 0.04045)
MAX_ENCODEABLE_XYZ = 1.0 + 32767.0 / 32768.0
_MAGIC = 68719476736.0 * 1.5        # littlecms's _cmsQuickFloor constant


def srgb_encode(v: np.ndarray) -> np.ndarray:
    """Linear [0, 1] -> sRGB-encoded (IEC 61966-2-1)."""
    v = np.asarray(v, np.float64)
    return np.where(v <= 0.0031308, 12.92 * v,
                    1.055 * np.power(np.maximum(v, 0.0), 1 / 2.4) - 0.055)


def _saturate_word(d: np.ndarray) -> np.ndarray:
    """littlecms's _cmsQuickSaturateWord: d + 0.5 floored through its
    2^-16 fixed-point trick, clipped to [0, 65535]."""
    d = np.asarray(d, np.float64) + 0.5
    inner = np.clip(d, 0.0, 65535.0)
    floor = np.floor(((inner - 32767.0) + _MAGIC) - _MAGIC).astype(np.int64)
    return np.where(d <= 0, 0, np.where(d >= 65535.0, 65535, floor + 32767))


def _to8(w: np.ndarray) -> np.ndarray:
    """FROM_16_TO_8."""
    return ((np.asarray(w, np.int64) * 65281 + 8388608) >> 24) & 0xFF


def _lerp16(table: np.ndarray, v: np.ndarray) -> np.ndarray:
    """littlecms's LinLerp1D: a 16-bit table at 16-bit inputs, in its
    15.16 fixed point and uint32 wrap."""
    table = np.asarray(table, np.int64)
    v = np.asarray(v, np.int64)
    dom = len(table) - 1
    if dom == 0:
        return np.full(v.shape, table[0])
    val3 = dom * v
    val3 = val3 + (val3 + 0x7FFF) // 0xFFFF
    cell = np.minimum(val3 >> 16, dom - 1)
    rest = val3 & 0xFFFF
    y0, y1 = table[cell], table[cell + 1]
    dif = (((y1 - y0) & 0xFFFFFFFF) * rest + 0x8000) & 0xFFFFFFFF
    return np.where(v == 0xFFFF, table[dom], ((dif >> 16) + y0) & 0xFFFF)


def _parametric(t: int, p, r: np.ndarray) -> np.ndarray:
    """littlecms's DefaultEvalParametricFn of its type t (an ICC para
    function type + 1; -4 the inverse of the sRGB form) at float64 r."""
    with np.errstate(all="ignore"):
        if t == 1:
            if abs(p[0] - 1.0) < 1e-4:
                return r.copy()
            return np.where(r < 0, 0.0, np.power(np.maximum(r, 0.0), p[0]))
        if t in (2, 3):
            if abs(p[1]) < 1e-4:
                return np.zeros_like(r)
            disc = -p[2] / p[1]
            e = p[1] * r + p[2]
            pw = np.power(np.maximum(e, 0.0), p[0])
            if t == 2:
                return np.where((r >= disc) & (e > 0), pw, 0.0)
            disc = max(disc, 0.0)
            return np.where(r >= disc, np.where(e > 0, pw + p[3], 0.0),
                            p[3])
        if t in (4, 5):
            e = p[1] * r + p[2]
            pw = np.power(np.maximum(e, 0.0), p[0])
            if t == 4:
                return np.where(r >= p[4], np.where(e > 0, pw, 0.0),
                                r * p[3])
            return np.where(r >= p[4], np.where(e > 0, pw + p[5], p[5]),
                            r * p[3] + p[6])
        if t == 6:
            e = p[1] * r + p[2]
            if p[0] == 1.0:
                return e + p[3]
            return np.where(e < 0, p[3], np.power(np.maximum(e, 0.0), p[0])
                            + p[3])
        if t == 7:
            e = p[2] * np.power(r, p[0]) + p[3]
            return np.where(e <= 0, p[4], p[1] * np.log10(np.where(
                e > 0, e, 1.0)) + p[4])
        if t == 8:
            return p[0] * np.power(p[1], p[2] * r + p[3]) + p[4]
        if t == -4:
            e = p[1] * p[4] + p[2]
            disc = 0.0 if e < 0 else e ** p[0]
            return np.where(r >= disc, (np.power(np.maximum(r, 0.0),
                                                 1.0 / p[0]) - p[2]) / p[1],
                            r / p[3])
    raise ValueError(f"parametric curve type {t}")


class Curve(NamedTuple):
    """A tone curve as littlecms keeps it: parametric (its type and
    parameters) or a 16-bit table."""
    kind: int                   # littlecms's type; 0 for a 16-bit table
    params: tuple = ()
    table: np.ndarray = None

    def eval_float(self, v: np.ndarray) -> np.ndarray:
        """cmsEvalToneCurveFloat: float32 in, float32 out (a table through
        its 16-bit interpolation)."""
        r = np.asarray(v, np.float32).astype(np.float64)
        if self.kind == 0:
            w = _saturate_word(r * 65535.0)
            return (_lerp16(self.table, w) / 65535.0).astype(np.float32)
        return _parametric(self.kind, self.params, r).astype(np.float32)


SRGB_INVERSE = Curve(-4, SRGB_PARAMS)


def _output_shaper() -> np.ndarray:
    """littlecms's FillSecondShaper for 8-bit output: the sRGB code of
    each 1.14 fixed-point value in [0, 1]."""
    r = (np.arange(16385) / 16384.0).astype(np.float32)
    val = np.clip(SRGB_INVERSE.eval_float(r).astype(np.float64), 0.0, 1.0)
    return _to8(_saturate_word(val * 65535.0)).astype(np.uint8)


SHAPER2 = _output_shaper()
# the first SHAPER2 entry of each code (every code has one)
_FIRST = np.searchsorted(SHAPER2, np.arange(256)).astype(np.int64)
assert np.array_equal(SHAPER2[_FIRST], np.arange(256))

_NO_TRANSFORM_CLASSES = (b"abst", b"link", b"nmcl")
MAX_TAGS = 100      # littlecms's MAX_TABLE_TAG


class Rejected(ValueError):
    """littlecms builds no transform from this profile; the reference
    returns the pixels unconverted."""


class Transform(NamedTuple):
    """An RGB matrix / TRC profile's transform to 8-bit sRGB, in
    littlecms's fixed point, with the float64 model beside it."""
    shaper1: np.ndarray     # (3, 256) int64: code -> 1.14 fixed point
    matrix: np.ndarray      # (3, 3) int64, 1.14 fixed point, row-major
    tables: np.ndarray      # (3, 256) float64: code -> linear (the model)
    linear: np.ndarray      # (3, 3) float64: linear -> linear sRGB (model)

    def packed(self) -> np.ndarray:
        """The kernel's table, as bytes (uint8): the input shapers and the
        matrix as int32 (780 words, the last 3 zero), then SHAPER2 padded
        to a multiple of 4."""
        words = np.zeros(PACKED_WORDS, np.int32)
        words[:768] = self.shaper1.ravel()
        words[768:777] = self.matrix.ravel()
        s2 = np.zeros(PACKED_BYTES - 4 * PACKED_WORDS, np.uint8)
        s2[:SHAPER2.size] = SHAPER2
        return np.concatenate([words.view(np.uint8), s2])


PACKED_WORDS = 780
PACKED_BYTES = 4 * PACKED_WORDS + 16388


def _s15(b: bytes, n: int) -> np.ndarray:
    return np.frombuffer(b[:4 * n], ">i4").astype(np.float64) / 65536.0


def _tags(data: bytes) -> dict:
    """The tag table: signature -> its bytes, out-of-range entries skipped
    as littlecms skips them."""
    if len(data) < 132:
        raise Rejected(f"profile of {len(data)} bytes is shorter than its "
                       f"header")
    size = min(struct.unpack(">I", data[:4])[0], len(data))
    if data[36:40] != b"acsp":
        raise Rejected("not an ICC profile (no 'acsp' signature)")
    count = struct.unpack(">I", data[128:132])[0]
    if count > MAX_TAGS or 132 + 12 * count > size:
        raise Rejected(f"bad tag count {count}")
    tags = {}
    for k in range(count):
        sig, off, n = struct.unpack(">4sII", data[132 + 12 * k:144 + 12 * k])
        if off + n > size:
            continue
        tags[sig] = data[off:off + n]
    return tags


def _xyz(tags: dict, sig: bytes) -> np.ndarray:
    b = tags.get(sig)
    if b is None or len(b) < 20 or b[:4] != b"XYZ ":
        raise Rejected(f"no readable {sig.decode()} colorant")
    return _s15(b[8:20], 3)


def read_curve(tag: bytes) -> Curve:
    """A ``curv`` or ``para`` tag as littlecms reads it: curv with no entry
    a gamma of 1, with one a u8Fixed8 gamma (both parametric), with n a
    16-bit table; para of function types 0-4 (ICC.1:2010 10.18)."""
    kind = tag[:4]
    if kind == b"curv" and len(tag) >= 12:
        n = struct.unpack(">I", tag[8:12])[0]
        if len(tag) < 12 + 2 * n:
            raise Rejected("truncated curv tag")
        ent = np.frombuffer(tag[12:12 + 2 * n], ">u2").astype(np.int64)
        if n == 0:
            return Curve(1, (1.0,))
        if n == 1:
            return Curve(1, (ent[0] / 256.0,))
        return Curve(0, (), ent)
    if kind == b"para" and len(tag) >= 12:
        ftype = struct.unpack(">H", tag[8:10])[0]
        nparams = {0: 1, 1: 3, 2: 4, 3: 5, 4: 7}.get(ftype)
        if nparams is None or len(tag) < 12 + 4 * nparams:
            raise Rejected(f"unreadable para tag (function type {ftype})")
        return Curve(ftype + 1, tuple(_s15(tag[12:], nparams)))
    raise Rejected(f"unreadable tone curve of type {kind!r}")


def _curve64(c: Curve, x: np.ndarray) -> np.ndarray:
    """The model's curve: in float64 throughout (a table interpolated
    linearly)."""
    if c.kind == 0:
        t = c.table / 65535.0
        pos = x * (len(t) - 1)
        i = np.minimum(np.floor(pos).astype(np.int64), len(t) - 2)
        return t[i] + (t[i + 1] - t[i]) * (pos - i)
    return _parametric(c.kind, c.params, x)


def _inverse(a):
    """littlecms's _cmsMAT3inverse (cofactors over the determinant)."""
    c0 = a[1][1] * a[2][2] - a[1][2] * a[2][1]
    c1 = -a[1][0] * a[2][2] + a[1][2] * a[2][0]
    c2 = a[1][0] * a[2][1] - a[1][1] * a[2][0]
    det = a[0][0] * c0 + a[0][1] * c1 + a[0][2] * c2
    return [[c0 / det,
             (a[0][2] * a[2][1] - a[0][1] * a[2][2]) / det,
             (a[0][1] * a[1][2] - a[0][2] * a[1][1]) / det],
            [c1 / det,
             (a[0][0] * a[2][2] - a[0][2] * a[2][0]) / det,
             (a[0][2] * a[1][0] - a[0][0] * a[1][2]) / det],
            [c2 / det,
             (a[0][1] * a[2][0] - a[0][0] * a[2][1]) / det,
             (a[0][0] * a[1][1] - a[0][1] * a[1][0]) / det]]


def _product(a, b):
    """littlecms's _cmsMAT3per, a @ b summed left to right."""
    return [[a[i][0] * b[0][j] + a[i][1] * b[1][j] + a[i][2] * b[2][j]
             for j in range(3)] for i in range(3)]


def _joined_shaper(curve: Curve) -> np.ndarray:
    """An identity matrix's channel (OptimizeByJoiningCurves): the input
    and output curves through a 4096-point 16-bit table in float, its 256
    codes at 8 bits, each as the 1.14 index of its first SHAPER2 entry."""
    x = (np.arange(4096) / 4095.0).astype(np.float32)
    joined = _saturate_word(SRGB_INVERSE.eval_float(curve.eval_float(x))
                            .astype(np.float64) * 65535.0)
    codes = _to8(_lerp16(joined, np.arange(256) * 257))
    return _FIRST[codes]


def _first_shaper(curve) -> np.ndarray:
    """FillFirstShaper: the curve at each code's float32 i / 255 in 1.14
    fixed point, 0x7fffffff from 131072 up (and for NaN); a value past
    int32 below converts as x86 does, to INT32_MIN."""
    x32 = (np.arange(256) / 255.0).astype(np.float32)
    y = curve.eval_float(x32).astype(np.float64)
    with np.errstate(invalid="ignore"):
        v = np.floor(y * 16384.0 + 0.5)
        v = np.where((v >= 2.0 ** 31) | (v < -2.0 ** 31), -2.0 ** 31, v)
        return np.where(y < 131072.0, v, 2 ** 31 - 1).astype(np.int64)


def _matrix_shaper(stages: list):
    """OptimizeMatrixShaper's patterns on the simplified pipeline: curves,
    a matrix and curves, or curves, two matrices (the first without an
    offset) and curves; all curves (an identity matrix PreOptimize took
    out).  (input curves, matrix) or None.  The last matrix is always
    sRGB's, which has no offset, so no offset reaches the program."""
    from .icc_lut import Curves, Matrix
    kinds = [type(s) for s in stages]
    if kinds == [Curves, Curves]:
        return stages[0].curves, np.eye(3)
    if kinds == [Curves, Matrix, Curves] and stages[1].off is None:
        return stages[0].curves, stages[1].m
    if kinds == [Curves, Matrix, Matrix, Curves] and \
            stages[1].off is None and stages[2].off is None:
        return stages[0].curves, np.array(_product(stages[2].m.tolist(),
                                                   stages[1].m.tolist()))
    return None


@functools.lru_cache(maxsize=16)
def plan(icc: bytes):
    """The profile's transform to sRGB: a Transform (littlecms's 8-bit
    matrix-shaper program) or an icc_lut.ClutTransform (its 8-bit CLUT
    program); raises Rejected where the reference returns the pixels
    unconverted (module docstring)."""
    from . import icc_lut
    icc = bytes(icc)
    tags = _tags(icc)
    cls, space = icc[12:16], icc[16:20]
    if cls in _NO_TRANSFORM_CLASSES:
        raise Rejected(f"cannot build a transform from a {cls.decode()!r} "
                       f"class profile")
    if space != b"RGB ":
        raise Rejected(f"the profile's data colour space is {space!r}, not "
                       f"RGB")
    stages = icc_lut.pipeline(icc, tags)
    shaper = _matrix_shaper(stages)
    if shaper is None:
        return icc_lut.clut_transform(stages)
    curves, res = shaper
    x = np.arange(256, dtype=np.float64) / 255.0
    tables = np.stack([_curve64(c, x) if isinstance(c, Curve) else
                       c.eval_float(x.astype(np.float32)).astype(np.float64)
                       for c in curves])
    if np.all(np.abs(res - np.eye(3)) < 1.0 / 65535.0):
        shaper1 = np.stack([_joined_shaper(c) for c in curves])
        matrix = np.eye(3, dtype=np.int64) * 16384
    else:
        shaper1 = np.stack([_first_shaper(c) for c in curves])
        matrix = np.floor(res * 16384.0 + 0.5)
    return Transform(shaper1.astype(np.int64), matrix.astype(np.int64),
                     np.ascontiguousarray(tables), np.asarray(res))


def srgb8_model(rgb8: np.ndarray, tr: Transform) -> np.ndarray:
    """(..., 3) 8-bit codes -> (..., 3) uint8 sRGB codes by the float64
    formula: the curves, the matrix, a clamp to [0, 1], the sRGB curve,
    rint."""
    lin = np.stack([tr.tables[c][rgb8[..., c]] for c in range(3)], -1)
    v = np.clip(lin @ tr.linear.T, 0.0, 1.0)
    return np.rint(srgb_encode(v) * 255.0).astype(np.uint8)
