"""littlecms's route from an embedded ICC profile to 8-bit sRGB, as a
pipeline of stages evaluated in its float arithmetic (numpy; no torch).

The reference converts with littlecms 2.17 through Pillow
(``jxl_coder_tpu/ops/icc_apply.py:22-61``: RGB8 in and out, perceptual
intent, black-point compensation).  littlecms links the profile to its
built-in sRGB profile as a pipeline of stages (``cmscnvrt.c``
``DefaultICCintents``), simplifies it (``cmsopt.c`` ``PreOptimize``), and
then either runs its 8-bit matrix-shaper program (a pipeline of curves, a
matrix and curves: ``host/ops/icc.py`` builds it) or samples the whole
pipeline into a 16-bit CLUT of 33 points per axis that its 8-bit
evaluator (``PrelinEval8``) interpolates tetrahedrally: with
prelinearisation curves, the pipeline's own output along the grey ramp,
where ``OptimizeByComputingLinearization`` accepts that ramp (monotonic
and not degenerate: a matrix / TRC profile whose black-point
compensation broke the matrix program, typically), else the CLUT alone
(``OptimizeByResampling``: every lookup-table profile here).

This module builds that pipeline as littlecms does and samples it:

- the input side (``cmsio1.c`` ``_cmsReadInputLUT``): a ``D2B0`` tag of
  type ``mpet`` first (``cvst`` segmented curves, ``matf`` matrices with
  offsets, ``clut`` float CLUTs, then the float PCS normalisation), else an
  ``A2B0`` of type ``mft1`` (``lut8Type``), ``mft2`` (``lut16Type``; Lab
  PCS in its v2 encoding, so a v2 -> v4 matrix follows) or ``mAB ``
  (``lutAtoBType``: A curves, CLUT at 8- or 16-bit precision, M curves,
  matrix with offset, B curves), else the matrix and tone curves;
- the PCS conversion to the sRGB profile's XYZ (Lab -> XYZ where the
  profile's PCS is Lab) with black-point compensation between them
  (``ComputeBlackPointCompensation``: the profile's black from
  ``cmsDetectBlackPoint`` -- the darker colorant through the profile, or
  littlecms's perceptual black for a v4 table profile without colorants
  -- to sRGB's black, 0);
- the sRGB profile's inverse matrix and inverse tone curves.

Every stage runs in float32 with littlecms's own roundings (its doubles
where it computes in double), so each of the 35,937 nodes equals
littlecms's; the white node is then set to white where it is not
(``FixWhiteMisalignment``).  A tag littlecms cannot read under its
signature, a table whose channels do not run RGB -> 3 PCS channels, or a
PCS other than XYZ and Lab raises ``Rejected``: littlecms then builds no
transform and the reference passes the pixels through.
"""

from __future__ import annotations

import struct
from typing import NamedTuple

import numpy as np

from .icc import (MAX_ENCODEABLE_XYZ, SRGB_D50, SRGB_INVERSE, Curve,
                  Rejected, _inverse, _lerp16, _parametric, _product,
                  _saturate_word, _xyz, read_curve)

F32, F64 = np.float32, np.float64
GRID = 33                          # _cmsReasonableGridpointsByColorspace, RGB
D50 = (0.9642, 1.0, 0.8249)        # cmsD50_XYZ
PERCEPTUAL_BLACK = (0.00336, 0.0034731, 0.00287)
PLUS_INF = float(np.float32(1e22))  # littlecms's PLUS_INF / MINUS_INF
MAX_CHANNELS = 16                   # cmsMAXCHANNELS
_MATRIX_TAGS = (b"rXYZ", b"gXYZ", b"bXYZ", b"rTRC", b"gTRC", b"bTRC")


# ---- stages ---------------------------------------------------------------

class Curves(NamedTuple):
    """A set of tone curves, one per channel (EvaluateCurves)."""
    curves: tuple

    @property
    def nin(self):
        return len(self.curves)

    nout = nin


class Matrix(NamedTuple):
    """Out = m @ In + off in double, stored as float32 (EvaluateMatrix).
    `role` is littlecms's Implements: "matrix" for a plain matrix, else
    the conversion it stands for (PreOptimize removes such pairs)."""
    m: np.ndarray                 # (rows, cols) float64
    off: np.ndarray = None        # (rows,) float64
    role: str = "matrix"

    @property
    def nin(self):
        return self.m.shape[1]

    @property
    def nout(self):
        return self.m.shape[0]


class Clut(NamedTuple):
    """A CLUT of dims[i] points along input i (the last fastest), nout
    values a node: 16-bit (a float pipeline's EvaluateCLUTfloatIn16) or
    float32 (EvaluateCLUTfloat)."""
    dims: tuple
    table: np.ndarray             # int64 16-bit values, or float32
    nout: int
    role: str = "clut"

    @property
    def nin(self):
        return len(self.dims)


class Lab2XYZ(NamedTuple):
    """v4 Lab in [0, 1] -> XYZ / MAX_ENCODEABLE_XYZ (EvaluateLab2XYZ)."""
    role: str = "lab2xyz"
    nin: int = 3
    nout: int = 3


class XYZ2Lab(NamedTuple):
    """XYZ / MAX_ENCODEABLE_XYZ -> v4 Lab in [0, 1] (EvaluateXYZ2Lab)."""
    role: str = "xyz2lab"
    nin: int = 3
    nout: int = 3


def _v2v4(role: str, k: float) -> Matrix:
    return Matrix(np.eye(3) * k, None, role)


V2_TO_V4 = _v2v4("v2tov4", 65535.0 / 65280.0)   # _cmsStageAllocLabV2ToV4
V4_TO_V2 = _v2v4("v4tov2", 65280.0 / 65535.0)
XYZ_FROM_FLOAT = _v2v4("xyz2float", 32768.0 / 65535.0)
LAB_FROM_FLOAT = Matrix(np.diag([1 / 100.0, 1 / 255.0, 1 / 255.0]),
                        np.array([0.0, 128.0 / 255.0, 128.0 / 255.0]),
                        "lab2float")


# ---- the float evaluators --------------------------------------------------

def _fclamp(v: np.ndarray) -> np.ndarray:
    """littlecms's fclamp: below 1e-9 (or NaN) 0, above 1 one."""
    v = np.asarray(v, F32)
    return np.where((v < F32(1e-9)) | np.isnan(v), F32(0),
                    np.minimum(v, F32(1))).astype(F32)


def _lerp1_float(table: np.ndarray, v: np.ndarray) -> np.ndarray:
    """LinLerp1Dfloat: a float32 table at float32 v in [0, 1]."""
    dom = len(table) - 1
    val = _fclamp(v)
    x = (val * F32(dom)).astype(F32)
    c0 = np.floor(x).astype(np.int64)
    c1 = np.ceil(x).astype(np.int64)
    rest = (x - c0.astype(F32)).astype(F32)
    y0, y1 = table[np.minimum(c0, dom)], table[np.minimum(c1, dom)]
    out = (y0 + (y1 - y0) * rest).astype(F32)
    return np.where(val == F32(1), table[dom], out).astype(F32)


class SegmentedCurve(NamedTuple):
    """An mpet ``curf`` curve as littlecms keeps it: segments (x0, x1] of
    float32 breakpoints, each a formula (littlecms types 6-8) or sampled
    float32 points."""
    segments: tuple       # (x0, x1, kind, params, samples)

    def eval_float(self, v: np.ndarray) -> np.ndarray:
        """EvalSegmentedFn at float32 v, stored as float32."""
        r = np.asarray(v, F32).astype(F64)
        out = np.full(r.shape, -PLUS_INF)
        done = np.zeros(r.shape, bool)
        for x0, x1, kind, params, samples in reversed(self.segments):
            hit = ~done & (r > x0) & (r <= x1)
            if not hit.any():
                continue
            if kind == 0:
                r1 = ((r[hit] - x0).astype(F32) / (F32(x1) - F32(x0))) \
                    .astype(F32)
                val = _lerp1_float(samples, r1).astype(F64)
            else:
                val = _parametric(kind, params, r[hit])
            out[hit] = np.where(np.isposinf(val), PLUS_INF,
                                np.where(np.isneginf(val), -PLUS_INF, val))
            done |= hit
        return out.astype(F32)


def _tetra_int(table: np.ndarray, nout: int, base, steps, fracs
               ) -> np.ndarray:
    """littlecms's integer tetrahedral interpolation (TetrahedralInterp16,
    PrelinEval8): from each point's base node (an offset into the table),
    the offsets to the next node along each axis (0 at the last) and the
    16-bit fractions, (N, nout) 16-bit values in its fixed point and int32
    wrap.  The tetrahedron is PrelinEval8's, tested in its order; where
    TetrahedralInterp16 breaks a tie another way the products are the same
    integers, so the values are too."""
    t = np.asarray(table, np.int64)
    rx, ry, rz = fracs
    sx, sy, sz = steps
    t1 = (rx >= ry) & (ry >= rz)
    t2 = ~t1 & (rx >= rz) & (rz >= ry)
    t3 = ~t1 & ~t2 & (rz >= rx) & (rx >= ry)
    t4 = ~t1 & ~t2 & ~t3 & (ry >= rx) & (rx >= rz)
    t5 = ~t1 & ~t2 & ~t3 & ~t4 & (ry >= rz) & (rz >= rx)
    t6 = ~(t1 | t2 | t3 | t4 | t5)
    # the axis of each of the three steps from base to the far corner
    first = np.select([t1 | t2, t3 | t6], [0, 2], 1)
    last = np.select([t5 | t6, t1 | t4], [0, 2], 1)
    axes_s = np.stack([sx, sy, sz])
    axes_r = np.stack([rx, ry, rz])
    n = np.arange(len(rx))
    s1, s3 = axes_s[first, n], axes_s[last, n]
    r1, r3 = axes_r[first, n], axes_r[last, n]
    r2 = rx + ry + rz - r1 - r3
    a, e = base + s1, base + sx + sy + sz
    b = e - s3
    out = np.zeros((len(rx), nout), np.int64)
    for ch in range(nout):
        v0, va, vb, ve = t[base + ch], t[a + ch], t[b + ch], t[e + ch]
        rest = _wrap32((va - v0) * r1 + (vb - va) * r2 + (ve - vb) * r3
                       + 0x8001)
        out[:, ch] = (v0 + (_wrap32(rest + (rest >> 16)) >> 16)) & 0xFFFF
    return out


def _tetra16(table: np.ndarray, dims: tuple, nout: int,
             v: np.ndarray) -> np.ndarray:
    """TetrahedralInterp16: (N, 3) 16-bit inputs -> (N, nout) 16-bit."""
    v = np.asarray(v, np.int64)
    strides = (nout * dims[2] * dims[1], nout * dims[2], nout)
    base, steps, fracs = 0, [], []
    for k in range(3):
        f = v[:, k] * (dims[k] - 1)
        f = f + (f + 0x7FFF) // 0xFFFF
        base = base + strides[k] * (f >> 16)
        fracs.append(f & 0xFFFF)
        steps.append(np.where(v[:, k] == 0xFFFF, 0, strides[k]))
    return _tetra_int(table, nout, base, steps, fracs)


def _wrap32(x: np.ndarray) -> np.ndarray:
    """int64 values as int32 arithmetic leaves them (two's complement)."""
    return ((np.asarray(x, np.int64) + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def _tetra_float(table: np.ndarray, dims: tuple, nout: int,
                 x: np.ndarray) -> np.ndarray:
    """TetrahedralInterpFloat: (N, 3) float32 -> (N, nout) float32."""
    t = np.asarray(table, F32)
    opta0 = nout
    opta1 = opta0 * dims[2]
    opta2 = opta1 * dims[1]
    i0, i1, r = [], [], []
    for k, opta in zip(range(3), (opta2, opta1, opta0)):
        c = _fclamp(x[:, k])
        p = (c * F32(dims[k] - 1)).astype(F32)
        f = np.floor(p).astype(np.int64)
        r.append((p - f.astype(F32)).astype(F32))
        i0.append(opta * f)
        i1.append(opta * f + np.where(c >= F32(1), 0, opta))
    rx, ry, rz = r
    X0, Y0, Z0 = i0
    X1, Y1, Z1 = i1
    out = np.zeros((len(x), nout), F32)
    conds = [(rx >= ry) & (ry >= rz), (rx >= rz) & (rz >= ry),
             (rz >= rx) & (rx >= ry), (ry >= rx) & (rx >= rz),
             (ry >= rz) & (rz >= rx), (rz >= ry) & (ry >= rx)]
    first = np.select(conds, range(6), 6)
    for ch in range(nout):
        def d(a, b, c):
            return t[a + b + c + ch]
        c0 = d(X0, Y0, Z0)
        c1s = [d(X1, Y0, Z0) - c0, d(X1, Y0, Z0) - c0,
               d(X1, Y0, Z1) - d(X0, Y0, Z1), d(X1, Y1, Z0) - d(X0, Y1, Z0),
               d(X1, Y1, Z1) - d(X0, Y1, Z1), d(X1, Y1, Z1) - d(X0, Y1, Z1)]
        c2s = [d(X1, Y1, Z0) - d(X1, Y0, Z0), d(X1, Y1, Z1) - d(X1, Y0, Z1),
               d(X1, Y1, Z1) - d(X1, Y0, Z1), d(X0, Y1, Z0) - c0,
               d(X0, Y1, Z0) - c0, d(X0, Y1, Z1) - d(X0, Y0, Z1)]
        c3s = [d(X1, Y1, Z1) - d(X1, Y1, Z0), d(X1, Y0, Z1) - d(X1, Y0, Z0),
               d(X0, Y0, Z1) - c0, d(X1, Y1, Z1) - d(X1, Y1, Z0),
               d(X0, Y1, Z1) - d(X0, Y1, Z0), d(X0, Y0, Z1) - c0]
        zero = np.zeros_like(c0)
        c1 = np.choose(first, c1s + [zero]).astype(F32)
        c2 = np.choose(first, c2s + [zero]).astype(F32)
        c3 = np.choose(first, c3s + [zero]).astype(F32)
        out[:, ch] = ((c0 + c1 * rx).astype(F32) + c2 * ry).astype(F32) + \
            c3 * rz
    return out


def _f_lab(t: np.ndarray) -> np.ndarray:
    lim = (24.0 / 116.0) ** 3
    return np.where(t <= lim, (841.0 / 108.0) * t + (16.0 / 116.0),
                    np.power(np.maximum(t, 0.0), 1.0 / 3.0))


def _f_lab_inverse(t: np.ndarray) -> np.ndarray:
    return np.where(t <= 24.0 / 116.0, (108.0 / 841.0) * (t - 16.0 / 116.0),
                    t * t * t)


def lab_to_xyz(lab: np.ndarray) -> np.ndarray:
    """cmsLab2XYZ against D50: (N, 3) float64 Lab -> XYZ."""
    y = (lab[:, 0] + 16.0) / 116.0
    x = y + 0.002 * lab[:, 1]
    z = y - 0.005 * lab[:, 2]
    return np.stack([_f_lab_inverse(x) * D50[0], _f_lab_inverse(y) * D50[1],
                     _f_lab_inverse(z) * D50[2]], 1)


def eval_stage(s, x: np.ndarray) -> np.ndarray:
    """One stage at (N, nin) float32 -> (N, nout) float32."""
    if isinstance(s, Curves):
        return np.stack([c.eval_float(x[:, k]) for k, c in
                         enumerate(s.curves)], 1).astype(F32)
    if isinstance(s, Matrix):
        xd = x.astype(F64)
        cols = []
        for i in range(s.nout):
            acc = np.zeros(len(x))
            for j in range(s.nin):
                acc = acc + xd[:, j] * s.m[i, j]
            if s.off is not None:
                acc = acc + s.off[i]
            cols.append(acc)
        return np.stack(cols, 1).astype(F32)
    if isinstance(s, Clut):
        if s.table.dtype == F32:
            return _tetra_float(s.table, s.dims, s.nout, x)
        w = _saturate_word(x.astype(F64) * 65535.0)
        return (_tetra16(s.table, s.dims, s.nout, w).astype(F32)
                / F32(65535.0)).astype(F32)
    if isinstance(s, Lab2XYZ):
        xd = x.astype(F64)
        lab = np.stack([xd[:, 0] * 100.0, xd[:, 1] * 255.0 - 128.0,
                        xd[:, 2] * 255.0 - 128.0], 1)
        return (lab_to_xyz(lab) / MAX_ENCODEABLE_XYZ).astype(F32)
    if isinstance(s, XYZ2Lab):
        xyz = x.astype(F64) * MAX_ENCODEABLE_XYZ
        fx, fy, fz = (_f_lab(xyz[:, k] / D50[k]) for k in range(3))
        lab = np.stack([116.0 * fy - 16.0, 500.0 * (fx - fy),
                        200.0 * (fy - fz)], 1)
        return np.stack([lab[:, 0] / 100.0, (lab[:, 1] + 128.0) / 255.0,
                         (lab[:, 2] + 128.0) / 255.0], 1).astype(F32)
    raise TypeError(f"unknown stage {s!r}")


def eval_float(stages, x: np.ndarray) -> np.ndarray:
    """cmsPipelineEvalFloat: float32 (N, nin) through every stage."""
    x = np.asarray(x, F32)
    for s in stages:
        x = eval_stage(s, x)
    return x


# ---- reading the tags -------------------------------------------------------

class _Reader:
    """A tag's bytes read as littlecms's IO handler reads them: a read
    past the end fails, and so does littlecms's read."""

    def __init__(self, data: bytes, pos: int = 8):
        self.data, self.pos = data, pos

    def take(self, n: int) -> bytes:
        if n < 0 or self.pos + n > len(self.data):
            raise Rejected("truncated lookup-table tag")
        b = self.data[self.pos:self.pos + n]
        self.pos += n
        return b

    def u8(self) -> int:
        return self.take(1)[0]

    def u16(self) -> int:
        return struct.unpack(">H", self.take(2))[0]

    def u32(self) -> int:
        return struct.unpack(">I", self.take(4))[0]

    def u16s(self, n: int) -> np.ndarray:
        return np.frombuffer(self.take(2 * n), ">u2").astype(np.int64)

    def s15(self, n: int) -> np.ndarray:
        return np.frombuffer(self.take(4 * n), ">i4").astype(F64) / 65536.0

    def f32(self, n: int) -> np.ndarray:
        """_cmsReadFloat32Number: zero or normal, at most 1e20 in size."""
        v = np.frombuffer(self.take(4 * n), ">f4").astype(F32)
        ok = (v == 0) | (np.isfinite(v) & (np.abs(v) >= np.finfo(F32).tiny)
                         & (np.abs(v) <= 1e20))
        if not np.all(ok):
            raise Rejected("float in a lookup-table tag out of range")
        return v

    def seek(self, pos: int) -> "_Reader":
        if pos > len(self.data):
            raise Rejected("lookup-table offset past the tag")
        return _Reader(self.data, pos)


def _channels(nin: int, nout: int, limit: int = MAX_CHANNELS + 1) -> None:
    if not (0 < nin < limit and 0 < nout < limit):
        raise Rejected(f"lookup table of {nin} -> {nout} channels")


def _table_curves(rows) -> Curves:
    return Curves(tuple(Curve(0, (), np.asarray(t, np.int64)) for t in rows))


def _grid_size(dims) -> int:
    size = 1
    for d in dims:
        if d <= 1:
            raise Rejected(f"lookup-table CLUT of {d} grid points")
        size *= d
    return size


def read_lut8(tag: bytes) -> list:
    """lut8Type (Type_LUT8_Read): [matrix] in tables, CLUT, out tables."""
    r = _Reader(tag)
    nin, nout, points = r.u8(), r.u8(), r.u8()
    r.u8()
    if points == 1:
        raise Rejected("lut8 CLUT of one grid point")
    _channels(nin, nout, MAX_CHANNELS + 1)
    mat = r.s15(9).reshape(3, 3)
    stages = []
    if nin == 3 and not _is_identity(mat):
        stages.append(Matrix(mat))
    stages.append(_table_curves([_u8_table(r) for _ in range(nin)]))
    n = nout * points ** nin
    if n > 0:
        stages.append(Clut((points,) * nin, np.frombuffer(
            r.take(n), np.uint8).astype(np.int64) * 257, nout))
    stages.append(_table_curves([_u8_table(r) for _ in range(nout)]))
    return stages


def _u8_table(r: _Reader) -> np.ndarray:
    """A lut8 table: 256 bytes, each as FROM_8_TO_16."""
    return np.frombuffer(r.take(256), np.uint8).astype(np.int64) * 257


def read_lut16(tag: bytes) -> list:
    """lut16Type (Type_LUT16_Read): [matrix] in tables, CLUT, out tables
    (a table of 0 entries left out, as littlecms allows)."""
    r = _Reader(tag)
    nin, nout, points = r.u8(), r.u8(), r.u8()
    r.u8()
    _channels(nin, nout, MAX_CHANNELS + 1)
    mat = r.s15(9).reshape(3, 3)
    stages = []
    if nin == 3 and not _is_identity(mat):
        stages.append(Matrix(mat))
    n_in, n_out = r.u16(), r.u16()
    if n_in > 0x7FFF or n_out > 0x7FFF or points == 1:
        raise Rejected("lut16 of a bad size")

    def tables(nch, entries):
        if entries == 0:
            return
        if entries < 2:
            raise Rejected("lut16 table of one entry")
        stages.append(_table_curves([r.u16s(entries)
                                          for _ in range(nch)]))
    tables(nin, n_in)
    n = nout * points ** nin
    if n > 0:
        stages.append(Clut((points,) * nin, r.u16s(n), nout))
    tables(nout, n_out)
    return stages


def _is_identity(m: np.ndarray) -> bool:
    """_cmsMAT3isIdentity: each entry within 1/65535 of the identity's."""
    return bool(np.all(np.abs(m - np.eye(3)) < 1.0 / 65535.0))


def _embedded_curves(r: _Reader, n: int) -> Curves:
    """ReadSetOfCurves: n curv / para curves, each 4-byte aligned."""
    curves = []
    for _ in range(n):
        start = r.pos
        kind = r.data[start:start + 4]
        if kind == b"curv":
            count = struct.unpack(">I", r.data[start + 8:start + 12])[0] \
                if start + 12 <= len(r.data) else 0
            if count > 0x7FFF:
                raise Rejected("curv of too many entries")
            size = 12 + 2 * count
        elif kind == b"para":
            ftype = struct.unpack(">H", r.data[start + 8:start + 10])[0] \
                if start + 10 <= len(r.data) else 99
            size = 12 + 4 * {0: 1, 1: 3, 2: 4, 3: 5, 4: 7}.get(ftype, 0)
        else:
            raise Rejected(f"lutAtoB curve of type {kind!r}")
        curves.append(read_curve(r.take(size)))
        r.pos += -r.pos % 4        # _cmsReadAlignment
    return Curves(tuple(curves))


def read_lut_atob(tag: bytes) -> list:
    """lutAtoBType (Type_LUTA2B_Read): A curves, CLUT, M curves, matrix
    with offset, B curves, each where its offset is not 0."""
    r = _Reader(tag)
    nin, nout = r.u8(), r.u8()
    r.u16()
    off_b, off_mat, off_m, off_c, off_a = (r.u32() for _ in range(5))
    _channels(nin, nout, MAX_CHANNELS)
    stages = []
    if off_a:
        stages.append(_embedded_curves(r.seek(off_a), nin))
    if off_c:
        c = r.seek(off_c)
        grid = c.take(MAX_CHANNELS)
        if 1 in grid:
            raise Rejected("lutAtoB CLUT of one grid point")
        precision = c.u8()
        c.take(3)
        dims = tuple(grid[:nin])
        n = nout * _grid_size(dims)
        if precision == 1:
            table = np.frombuffer(c.take(n), np.uint8).astype(np.int64) * 257
        elif precision == 2:
            table = c.u16s(n)
        else:
            raise Rejected(f"lutAtoB CLUT of precision {precision}")
        stages.append(Clut(dims, table, nout))
    if off_m:
        stages.append(_embedded_curves(r.seek(off_m), nout))
    if off_mat:
        m = r.seek(off_mat)
        mat = m.s15(9).reshape(3, 3)
        stages.append(Matrix(mat, m.s15(3)))
    if off_b:
        stages.append(_embedded_curves(r.seek(off_b), nout))
    return stages


def _segmented_curve(r: _Reader) -> SegmentedCurve:
    """ReadSegmentedCurve: a ``curf`` of formula (``parf``) and sampled
    (``samf``) segments."""
    if r.take(4) != b"curf":
        raise Rejected("mpet curve that is not a segmented curve")
    r.take(4)
    n = r.u16()
    r.take(2)
    if n < 1:
        raise Rejected("segmented curve without a segment")
    breaks = [float(b) for b in r.f32(n - 1)]
    edges = [-PLUS_INF] + breaks + [PLUS_INF]
    segments = []
    for i in range(n):
        kind = r.take(4)
        r.take(4)
        if kind == b"parf":
            ftype = r.u16()
            r.take(2)
            if ftype > 2:
                raise Rejected(f"segment formula of type {ftype}")
            params = tuple(float(p) for p in r.f32((4, 5, 5)[ftype]))
            segments.append((edges[i], edges[i + 1], ftype + 6, params,
                             None))
        elif kind == b"samf":
            count = r.u32()
            pts = np.concatenate([np.zeros(1, F32), r.f32(count)])
            segments.append((edges[i], edges[i + 1], 0, (), pts))
        else:
            raise Rejected(f"unknown curve segment {kind!r}")
    return SegmentedCurve(tuple(_first_samples(segments)))


def _first_samples(segments: list) -> list:
    """A sampled segment's implicit first point: the segment before it at
    the breakpoint (0 for a first segment), as littlecms fills it."""
    out = []
    for i, (x0, x1, kind, params, pts) in enumerate(segments):
        if kind == 0 and i > 0:
            prev = SegmentedCurve(tuple(out))
            pts = pts.copy()
            pts[0] = prev.eval_float(np.array([x0], F32))[0]
        out.append((x0, x1, kind, params, pts))
    return out


def read_mpet(tag: bytes) -> list:
    """multiProcessElementType (Type_MPE_Read): cvst, matf and clut
    elements (bACS / eACS skipped)."""
    r = _Reader(tag)
    nin, nout = r.u16(), r.u16()
    _channels(nin, nout, MAX_CHANNELS)
    count = r.u32()
    positions = [(r.u32(), r.u32()) for _ in range(count)]
    stages, chans = [], nin
    for off, _size in positions:
        e = r.seek(off)
        sig = e.take(4)
        e.take(4)
        ein, eout = e.u16(), e.u16()
        if sig in (b"bACS", b"eACS"):
            continue
        if sig == b"cvst":
            if ein != eout:
                raise Rejected("cvst of unequal channels")
            curves = []
            table = [(e.u32(), e.u32()) for _ in range(ein)]
            for coff, _csize in table:
                curves.append(_segmented_curve(r.seek(off + coff)))
            stage = Curves(tuple(curves))
        elif sig == b"matf":
            if ein >= MAX_CHANNELS or eout >= MAX_CHANNELS:
                raise Rejected("matf of too many channels")
            m = e.f32(ein * eout).astype(F64).reshape(eout, ein)
            stage = Matrix(m, e.f32(eout).astype(F64))
        elif sig == b"clut":
            _channels(ein, eout, MAX_CHANNELS)
            grid = e.take(16)
            dims = tuple(grid[:min(ein, 15)])
            n = eout * _grid_size(dims)
            stage = Clut(dims, e.f32(n), eout)
        else:
            raise Rejected(f"unknown multi-process element {sig!r}")
        if stage.nin != chans:
            raise Rejected("multi-process elements of mismatched channels")
        stages.append(stage)
        chans = stage.nout
    if chans != nout or (not stages and nin != nout):
        raise Rejected("multi-process tag of mismatched channels")
    return stages


_A2B_READERS = {b"mft1": read_lut8, b"mft2": read_lut16,
                b"mAB ": read_lut_atob}


# ---- the pipeline -----------------------------------------------------------

def input_stages(icc: bytes, tags: dict, intent: int) -> list:
    """_cmsReadInputLUT for an RGB profile: the float tag, the 16-bit
    table (the perceptual one where the intent's is missing) or the
    matrix and curves; ends in the profile's PCS (XYZ or v4 Lab in
    littlecms's [0, 1] encodings)."""
    pcs = icc[20:24]
    float_tag = b"D2B%d" % intent
    if float_tag in tags:
        body = tags[float_tag]
        if body[:4] != b"mpet":
            raise Rejected(f"{float_tag.decode()} of type {body[:4]!r}, "
                           f"which littlecms does not read there")
        stages = read_mpet(body)
        return stages + [LAB_FROM_FLOAT if pcs == b"Lab " else
                         XYZ_FROM_FLOAT]
    sig = b"A2B%d" % intent
    if sig not in tags:
        sig = b"A2B0"
    if sig in tags:
        body = tags[sig]
        reader = _A2B_READERS.get(body[:4])
        if reader is None:
            raise Rejected(f"{sig.decode()} of type {body[:4]!r}, which "
                           f"littlecms does not read there")
        stages = reader(body)
        if body[:4] == b"mft2" and pcs == b"Lab ":
            stages.append(V2_TO_V4)
        return stages
    colorants = np.stack([_xyz(tags, s) for s in (b"rXYZ", b"gXYZ",
                                                   b"bXYZ")], 1)
    curves = []
    for s in (b"rTRC", b"gTRC", b"bTRC"):
        if s not in tags:
            raise Rejected(f"no {s.decode()} tone curve")
        curves.append(read_curve(tags[s]))
    stages = [Curves(tuple(curves)),
              Matrix(colorants * (1.0 / MAX_ENCODEABLE_XYZ))]
    if pcs == b"Lab ":
        stages.append(XYZ2Lab())
    return stages


def _check_chain(stages: list) -> None:
    """BlessLUT and the transform's channel check: 3 channels in and out,
    each stage fed what the one before gives."""
    chans = 3
    for s in stages:
        if s.nin != chans:
            raise Rejected(f"lookup table of {chans} channels where "
                           f"{s.nin} are read")
        chans = s.nout
    if chans != 3:
        raise Rejected(f"lookup table of {chans} output channels")


def _to_pcs(pcs: bytes, target: bytes) -> list:
    """AddConversion without black-point compensation."""
    if pcs == target:
        return []
    return [XYZ2Lab()] if target == b"Lab " else [Lab2XYZ()]


def black_point(icc: bytes, tags: dict) -> tuple:
    """cmsDetectBlackPoint for the perceptual intent, as XYZ."""
    v4 = struct.unpack(">I", icc[8:12])[0] >= 0x4000000
    shaper = all(t in tags for t in _MATRIX_TAGS)
    if v4:
        if not shaper:
            return PERCEPTUAL_BLACK
        intent = 1                      # relative colorimetric
    else:
        intent = 0
    if not (shaper or b"A2B%d" % intent in tags):
        return (0.0, 0.0, 0.0)
    try:
        stages = input_stages(icc, tags, intent)
        _check_chain(stages + _to_pcs(icc[20:24], b"Lab "))
    except Rejected:
        return (0.0, 0.0, 0.0)
    pcs = icc[20:24]
    # to littlecms's Lab identity profile (v2: its v4 -> v2 matrix, an
    # identity CLUT that PreOptimize removes, its v2 -> v4 matrix)
    link = stages + _to_pcs(pcs, b"Lab ") + [
        V4_TO_V2, Clut((2, 2, 2), np.zeros(24, np.int64), 3, "identity"),
        V2_TO_V4]
    lab = eval_float(preoptimize(link), np.zeros((1, 3), F32))
    L = float(F64(lab[0, 0]) * 100.0)
    if L > 50 or L < 0:
        L = 0.0
    xyz = lab_to_xyz(np.array([[L, 0.0, 0.0]]))[0]
    return tuple(float(v) for v in xyz)


def bpc_stage(black: tuple):
    """ComputeBlackPointCompensation from `black` to sRGB's black (0) in
    XYZ, its offset in littlecms's XYZ encoding; None where it is empty
    (IsEmptyLayer)."""
    if black == (0.0, 0.0, 0.0):
        return None
    t = [black[k] - D50[k] for k in range(3)]
    a = [(0.0 - D50[k]) / t[k] for k in range(3)]
    b = [-D50[k] * (0.0 - black[k]) / t[k] for k in range(3)]
    m = np.diag(a)
    off = np.array(b) / MAX_ENCODEABLE_XYZ
    diff = np.abs(m - np.eye(3)).sum() + np.abs(off).sum()
    return None if diff < 0.002 else Matrix(m, off)


def srgb_stages() -> list:
    """The built-in sRGB profile as output (BuildRGBOutputMatrixShaper)."""
    inv = np.array(_inverse(SRGB_D50.tolist())) * MAX_ENCODEABLE_XYZ
    return [Matrix(inv), Curves((SRGB_INVERSE,) * 3)]


def preoptimize(stages: list) -> list:
    """littlecms's PreOptimize: identities out, inverse conversion pairs
    out, adjacent plain 3x3 matrices without offsets multiplied."""
    stages = list(stages)
    pairs = {("xyz2lab", "lab2xyz"), ("lab2xyz", "xyz2lab"),
             ("v4tov2", "v2tov4"), ("v2tov4", "v4tov2"),
             ("lab2float", "float2lab"), ("xyz2float", "float2xyz")}
    changed = True
    while changed:
        changed = False
        kept = [s for s in stages if _role(s) != "identity"]
        changed |= len(kept) != len(stages)
        stages = kept
        i = 0
        while i + 1 < len(stages):
            if (_role(stages[i]), _role(stages[i + 1])) in pairs:
                del stages[i:i + 2]
                changed = True
            else:
                i += 1
        i = 0
        while i + 1 < len(stages):
            a, b = stages[i], stages[i + 1]
            if _role(a) == "matrix" and _role(b) == "matrix":
                if a.off is not None or b.off is not None or \
                        a.m.shape != (3, 3) or b.m.shape != (3, 3):
                    break
                res = np.array(_product(b.m.tolist(), a.m.tolist()))
                stages[i:i + 2] = [] if np.array_equal(res, np.eye(3)) \
                    else [Matrix(res)]
                changed = True
            else:
                i += 1
    return stages


def _role(s) -> str:
    return getattr(s, "role", "curves")


def pipeline(icc: bytes, tags: dict) -> list:
    """The profile linked to sRGB for the perceptual intent with
    black-point compensation, after PreOptimize (module docstring)."""
    pcs = icc[20:24]
    if pcs not in (b"XYZ ", b"Lab "):
        raise Rejected(f"the profile's PCS is {pcs!r}")
    link = input_stages(icc, tags, 0) + _to_pcs(pcs, b"XYZ ")
    bpc = bpc_stage(black_point(icc, tags))
    if bpc is not None:
        link.append(bpc)
    link += srgb_stages()
    _check_chain(link)
    return preoptimize(link)


# ---- the 8-bit CLUT program ------------------------------------------------

PRELIN_POINTS = 4096


def _degenerated(t: np.ndarray) -> bool:
    """IsDegenerated: a flat run of more than 1/20 at 0 or at 65535."""
    zeros, poles = int(np.sum(t == 0)), int(np.sum(t == 0xFFFF))
    if zeros == 1 and poles == 1:
        return False
    return zeros > len(t) // 20 or poles > len(t) // 20


def _monotonic(t: np.ndarray) -> bool:
    """cmsIsToneCurveMonotonic: no step of more than 2 against the
    curve's direction (walked from its far end, each step against the
    value before)."""
    t = np.asarray(t, np.int64)
    if t[0] > t[-1]:
        return not np.any(t[1:] - t[:-1] > 2)
    return not np.any(t[:-1] - t[1:] > 2)


def _slope_limited(t: np.ndarray) -> np.ndarray:
    """SlopeLimiting: the first and last 2% of the table made straight to
    the ends."""
    t = t.copy()
    n = len(t)
    at_begin = int(np.floor(n * 0.02 + 0.5))
    at_end = n - at_begin - 1
    begin, end = (0xFFFF, 0) if t[0] > t[-1] else (0, 0xFFFF)
    val = float(t[at_begin])
    slope = (val - begin) / at_begin
    beta = val - slope * at_begin
    i = np.arange(at_begin)
    t[:at_begin] = _saturate_word(i * slope + beta)
    val = float(t[at_end])
    slope = (end - val) / at_begin
    beta = val - slope * at_end
    i = np.arange(at_end, n)
    t[at_end:] = _saturate_word(i * slope + beta)
    return t


def _reversed(t: np.ndarray, n: int = PRELIN_POINTS) -> np.ndarray:
    """cmsReverseToneCurveEx of a tabulated curve: for each of n outputs
    the interval that holds it (GetInterval: from the top in an ascending
    table, from the bottom in a descending one), inverted linearly; a
    collapsed interval gives its upper (ascending) or lower end, and a
    value in no interval the last line found (0 before any)."""
    t = np.asarray(t, np.int64)
    dom = len(t) - 1
    lo = np.minimum(t[:-1], t[1:]).astype(F64)
    hi = np.maximum(t[:-1], t[1:]).astype(F64)
    y = np.arange(n) * 65535.0 / (n - 1)
    hit = (y[:, None] >= lo[None]) & (y[:, None] <= hi[None])
    found = hit.any(1)
    if t[0] < t[dom]:
        j = dom - 1 - np.argmax(hit[:, ::-1], 1)
    else:
        j = np.argmax(hit, 1)
    x1, x2 = t[j].astype(F64), t[j + 1].astype(F64)
    y1, y2 = (j * 65535.0) / dom, ((j + 1) * 65535.0) / dom
    collapsed = found & (x1 == x2)
    line = found & ~collapsed
    with np.errstate(divide="ignore", invalid="ignore"):
        a = np.where(line, (y2 - y1) / (x2 - x1), 0.0)
    b = np.where(line, y2 - a * x2, 0.0)
    # the line in force at each output: the last one set at or before it
    last = np.maximum.accumulate(np.where(line, np.arange(n), -1))
    a = np.where(last >= 0, a[np.maximum(last, 0)], 0.0)
    b = np.where(last >= 0, b[np.maximum(last, 0)], 0.0)
    end = y2 if not t[0] > t[-1] else y1
    return np.where(collapsed, _saturate_word(end), _saturate_word(a * y + b))


def linearization(stages: list):
    """OptimizeByComputingLinearization's prelinearisation: each channel's
    output along the grey ramp of 4096 points (float pipeline,
    _cmsQuickSaturateWord), slope-limited; None where littlecms declines,
    a curve not monotonic or degenerate.  (It declines too where the last
    stage's curves are degenerate; here they are sRGB's inverse, which is
    not.)"""
    v = (np.arange(PRELIN_POINTS) / (PRELIN_POINTS - 1)).astype(F32)
    out = eval_float(stages, np.repeat(v[:, None], 3, 1))
    trans = [_slope_limited(_saturate_word(out[:, k].astype(F64) * 65535.0))
             for k in range(3)]
    if not all(_monotonic(t) and not _degenerated(t) for t in trans):
        return None
    return trans


def _nodes_16() -> np.ndarray:
    q = _saturate_word(np.arange(GRID) * 65535.0 / (GRID - 1))
    return np.stack(np.meshgrid(q, q, q, indexing="ij"), -1).reshape(-1, 3)


def sample_clut(stages: list) -> np.ndarray:
    """cmsStageSampleCLut16bit with XFormSampler16: the pipeline at the
    33^3 nodes (the node's 16-bit value / 65535 in double, stored as
    float32; the outputs by _cmsQuickSaturateWord); (33^3 * 3,) int64,
    red the slowest axis."""
    x = (_nodes_16().astype(F64) / 65535.0).astype(F32)
    out = _saturate_word(eval_float(stages, x).astype(F64) * 65535.0)
    return out.reshape(-1).astype(np.int64)


def prelin8(trans=None) -> tuple:
    """PrelinOpt8alloc: for each channel and 8-bit code, the grid node
    (as an offset into the CLUT) and the 16-bit fraction towards the next,
    through the prelinearisation curves where there are any."""
    codes = np.arange(256, dtype=np.int64) * 257
    offs, fracs = [], []
    for k, stride in enumerate((3 * GRID * GRID, 3 * GRID, 3)):
        w = codes if trans is None else _lerp16(trans[k], codes)
        v = w * (GRID - 1)
        v = v + (v + 0x7FFF) // 0xFFFF
        offs.append(stride * (v >> 16))
        fracs.append(v & 0xFFFF)
    return np.stack(offs), np.stack(fracs)


def prelin_eval8(table: np.ndarray, offs: np.ndarray, fracs: np.ndarray,
                 rgb8: np.ndarray) -> np.ndarray:
    """PrelinEval8 on (N, 3) 8-bit codes -> (N, 3) 16-bit values."""
    codes = [np.asarray(rgb8, np.int64)[:, k] for k in range(3)]
    f = [fracs[k][codes[k]] for k in range(3)]
    steps = [np.where(f[k] == 0, 0, stride) for k, stride in
             enumerate((3 * GRID * GRID, 3 * GRID, 3))]
    base = offs[0][codes[0]] + offs[1][codes[1]] + offs[2][codes[2]]
    return _tetra_int(table, 3, base, steps, f)


def _fix_white(table: np.ndarray, offs, fracs, trans) -> None:
    """FixWhiteMisalignment: where white does not come out white (and no
    channel, in order, is more than 0xF000 off), the node white goes in at
    is set to white, if it lies on a node."""
    white = prelin_eval8(table, offs, fracs, np.full((1, 3), 255))[0]
    for w in white:
        if abs(int(w) - 0xFFFF) > 0xF000:
            return
        if w != 0xFFFF:
            break
    else:
        return
    at = [0xFFFF if trans is None else int(_lerp16(trans[k], 0xFFFF))
          for k in range(3)]
    pos = [a * (GRID - 1) / 65535.0 for a in at]
    if any(p != np.floor(p) for p in pos):
        return
    x, y, z = (int(p) for p in pos)
    i = 3 * GRID * GRID * x + 3 * GRID * y + 3 * z
    table[i:i + 3] = 0xFFFF


class ClutTransform(NamedTuple):
    """A profile's transform to 8-bit sRGB as littlecms's 8-bit CLUT
    program: per channel and 8-bit code a node offset and a 16-bit
    fraction (int32 words), then the 33^3 x 3 16-bit CLUT."""
    offs: np.ndarray        # (3, 256) int64: node offsets into the CLUT
    fracs: np.ndarray       # (3, 256) int64: 16-bit fractions
    table: np.ndarray       # (33^3 * 3,) int64, 16-bit values
    prelinearised: bool

    def packed(self) -> np.ndarray:
        """The kernel's table, as bytes (uint8): offsets and fractions as
        int32 (1,536 words), then the CLUT as uint16 (padded to 4 bytes)."""
        words = np.concatenate([self.offs.ravel(), self.fracs.ravel()]) \
            .astype(np.int32)
        clut = np.zeros(CLUT_HALFWORDS, np.uint16)
        clut[:self.table.size] = self.table
        return np.concatenate([words.view(np.uint8), clut.view(np.uint8)])


CLUT_WORDS = 6 * 256
CLUT_HALFWORDS = GRID ** 3 * 3 + 1
CLUT_BYTES = 4 * CLUT_WORDS + 2 * CLUT_HALFWORDS


def clut_transform(stages: list) -> ClutTransform:
    """OptimizeByComputingLinearization where littlecms takes it, else
    OptimizeByResampling; then the white fix."""
    trans = linearization(stages)
    if trans is not None:
        rev = Curves(tuple(Curve(0, (), _reversed(t)) for t in trans))
        table = sample_clut([rev] + list(stages))
    else:
        table = sample_clut(stages)
    offs, fracs = prelin8(trans)
    _fix_white(table, offs, fracs, trans)
    return ClutTransform(offs, fracs, table, trans is not None)
