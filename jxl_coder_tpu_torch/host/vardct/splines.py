"""Spline decoding + rendering (frame flag kSplines = 0x10).

Wire syntax (cf. reference jxl/decode.h event loop feeding dec_frame's
LfGlobal; splines sit between the patch dictionary and the noise
parameters): one entropy-coded stream with 6 contexts
  0 quantization adjustment   1 starting positions
  2 number of splines         3 control-point counts
  4 control-point deltas      5 DCT32 coefficients
Each spline stores its starting point (first spline absolute, later
ones delta-coded), then per spline: the number of additional control
points, delta-delta-coded integer control points, 3x32 colour DCT
coefficients (X, Y, B) and 32 sigma DCT coefficients.

The port's copy of ``jxl_coder_tpu/vardct/splines.py``, its
``_draw_spline`` split in two in the same float64 arithmetic and order:
``spline_points`` (the per-spline geometry: the points a spline draws,
each with its centre, |sigma|, intensity, colour and box) and
``draw_points`` (the blob loop; the device kernel draw_splines does the
same sums, vardct/overlay.py).  ``Splines.render`` runs both and stays
the oracle.

Rendering model (pinned numerically against libjxl 0.7 — see
research/splines_probe.py): control points are upsampled 16x with a
centripetal Catmull-Rom spline, the resulting polyline is resampled at
unit arc-length steps, and every sample point splats an erf-integrated
Gaussian blob whose colour and sigma are continuous DCT32 evaluations
at the fractional arc position.  All constants below are measured,
not copied.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from ..bitstream.reader import BitReader, BitstreamError, unpack_signed

CTX_QUANT_ADJ = 0
CTX_START = 1
CTX_NUM_SPLINES = 2
CTX_NUM_POINTS = 3
CTX_POINTS = 4
CTX_DCT = 5
NUM_SPLINE_CTXS = 6

# per-channel dequant weights (X, Y, B, sigma); calibrated via
# single-coefficient probes (research/splines_probe.py)
CHANNEL_WEIGHT = (0.0042, 0.075, 0.07, 0.3333)
DESIRED_RENDERING_DISTANCE = 1.0


def inv_adjusted_quant(adjustment: int) -> float:
    if adjustment >= 0:
        return 1.0 / (1.0 + 0.125 * adjustment)
    return 1.0 - 0.125 * adjustment


@dataclasses.dataclass
class QuantizedSpline:
    points: np.ndarray          # (N, 2) float64 (x, y) incl. start
    color_dct: np.ndarray       # (3, 32) int64
    sigma_dct: np.ndarray       # (32,) int64


@dataclasses.dataclass
class Splines:
    quantization_adjustment: int
    splines: List[QuantizedSpline]

    # ---------------------------------------------------------------- parse
    @staticmethod
    def read(br: BitReader, num_pixels: int) -> "Splines":
        from ..entropy.coder import EntropyCode, EntropyDecoder
        code = EntropyCode(br, NUM_SPLINE_CTXS)
        dec = EntropyDecoder(br, code=code)
        num_splines = dec.read(CTX_NUM_SPLINES) + 1
        max_control = 1 + (num_pixels >> 1)
        if num_splines > max_control:
            raise BitstreamError("too many splines")
        starts = []
        for i in range(num_splines):
            if i == 0:
                x = dec.read(CTX_START)
                y = dec.read(CTX_START)
            else:
                x = unpack_signed(dec.read(CTX_START)) + starts[-1][0]
                y = unpack_signed(dec.read(CTX_START)) + starts[-1][1]
            starts.append((x, y))
        qa = unpack_signed(dec.read(CTX_QUANT_ADJ))
        splines = []
        total_points = 0
        for i in range(num_splines):
            n_extra = dec.read(CTX_NUM_POINTS)
            total_points += n_extra + 1
            if total_points > max_control:
                raise BitstreamError("too many spline control points")
            pts = np.zeros((n_extra + 1, 2), np.int64)
            pts[0] = starts[i]
            cx, cy = starts[i]
            dx = dy = 0
            for j in range(n_extra):
                dx += unpack_signed(dec.read(CTX_POINTS))
                dy += unpack_signed(dec.read(CTX_POINTS))
                cx += dx
                cy += dy
                pts[j + 1] = (cx, cy)
            color = np.zeros((3, 32), np.int64)
            for c in range(3):
                for k in range(32):
                    color[c, k] = unpack_signed(dec.read(CTX_DCT))
            sigma = np.zeros(32, np.int64)
            for k in range(32):
                sigma[k] = unpack_signed(dec.read(CTX_DCT))
            splines.append(QuantizedSpline(
                points=pts.astype(np.float64), color_dct=color,
                sigma_dct=sigma))
        if not dec.check_final_state():
            raise BitstreamError("splines checksum failed")
        return Splines(quantization_adjustment=qa, splines=splines)

    # ---------------------------------------------------------------- write
    def write(self, bw) -> None:
        """Serialize (crafted-stream writer; mirrors read())."""
        from ..entropy.coder import TokenStream
        from ..bitstream.reader import pack_signed
        ts = TokenStream(NUM_SPLINE_CTXS)
        ts.add(CTX_NUM_SPLINES, len(self.splines) - 1)
        prev = None
        for qs in self.splines:
            x, y = int(qs.points[0, 0]), int(qs.points[0, 1])
            if prev is None:
                ts.add(CTX_START, x)
                ts.add(CTX_START, y)
            else:
                ts.add(CTX_START, pack_signed(x - prev[0]))
                ts.add(CTX_START, pack_signed(y - prev[1]))
            prev = (x, y)
        ts.add(CTX_QUANT_ADJ, pack_signed(self.quantization_adjustment))
        for qs in self.splines:
            n_extra = len(qs.points) - 1
            ts.add(CTX_NUM_POINTS, n_extra)
            px, py = int(qs.points[0, 0]), int(qs.points[0, 1])
            dx = dy = 0
            for j in range(n_extra):
                nx, ny = int(qs.points[j + 1, 0]), int(qs.points[j + 1, 1])
                ts.add(CTX_POINTS, pack_signed((nx - px) - dx))
                ts.add(CTX_POINTS, pack_signed((ny - py) - dy))
                dx, dy = nx - px, ny - py
                px, py = nx, ny
            for c in range(3):
                for k in range(32):
                    ts.add(CTX_DCT, pack_signed(int(qs.color_dct[c, k])))
            for k in range(32):
                ts.add(CTX_DCT, pack_signed(int(qs.sigma_dct[k])))
        ts.write(bw)

    # --------------------------------------------------------------- render
    def render(self, planes, base_cx: float = 0.0, base_cb: float = 1.0
               ) -> None:
        """Additively draw every spline onto [X, Y, B] float planes."""
        H, W = planes[1].shape
        pts, boxes = self.points(H, W, base_cx, base_cb)
        draw_points(planes, pts, boxes)

    def points(self, H: int, W: int, base_cx: float = 0.0,
               base_cb: float = 1.0):
        """The blobs that render draws on (H, W) planes, every spline's in
        order -> ((M, 7) float64 (cx, cy, |sigma|, intensity, colour X, Y,
        B), (M, 4) int64 (x0, x1, y0, y1) the inclusive box each covers)."""
        inv_quant = inv_adjusted_quant(self.quantization_adjustment)
        pts, boxes = [np.zeros((0, 7))], [np.zeros((0, 4), np.int64)]
        for qs in self.splines:
            color = np.zeros((3, 32), np.float64)
            for c in range(3):
                color[c] = qs.color_dct[c] * (CHANNEL_WEIGHT[c] * inv_quant)
            # X and B are stored decorrelated from Y
            color[0] += base_cx * color[1]
            color[2] += base_cb * color[1]
            sigma = qs.sigma_dct * (CHANNEL_WEIGHT[3] * inv_quant)
            p, b = spline_points(H, W, qs.points, color, sigma)
            pts.append(p)
            boxes.append(b)
        return np.concatenate(pts), np.concatenate(boxes)


# --------------------------------------------------------------------------
# Geometry


def centripetal_catmull_rom(points: np.ndarray) -> np.ndarray:
    """Upsample control points 16x with a centripetal (alpha = 0.5)
    Catmull-Rom spline; first/last points are mirrored for the end
    segments.  Returns (16*(N-1)+1, 2)."""
    n = len(points)
    if n == 1:
        return points.copy()
    ext = np.empty((n + 2, 2), np.float64)
    ext[1:-1] = points
    ext[0] = points[0] + (points[0] - points[1])
    ext[-1] = points[-1] + (points[-1] - points[-2])
    out = []
    for i in range(1, n):
        p = ext[i - 1:i + 3]
        t = np.zeros(4)
        for j in range(3):
            d = np.sqrt(np.hypot(p[j + 1, 0] - p[j, 0],
                                 p[j + 1, 1] - p[j, 1]))
            t[j + 1] = t[j] + max(d, 1e-10)
        ts = t[1] + (t[2] - t[1]) * (np.arange(16) / 16.0)
        a1 = ((t[1] - ts) / (t[1] - t[0]))[:, None] * p[0] \
            + ((ts - t[0]) / (t[1] - t[0]))[:, None] * p[1]
        a2 = ((t[2] - ts) / (t[2] - t[1]))[:, None] * p[1] \
            + ((ts - t[1]) / (t[2] - t[1]))[:, None] * p[2]
        a3 = ((t[3] - ts) / (t[3] - t[2]))[:, None] * p[2] \
            + ((ts - t[2]) / (t[3] - t[2]))[:, None] * p[3]
        b1 = ((t[2] - ts) / (t[2] - t[0]))[:, None] * a1 \
            + ((ts - t[0]) / (t[2] - t[0]))[:, None] * a2
        b2 = ((t[3] - ts) / (t[3] - t[1]))[:, None] * a2 \
            + ((ts - t[1]) / (t[3] - t[1]))[:, None] * a3
        c = ((t[2] - ts) / (t[2] - t[1]))[:, None] * b1 \
            + ((ts - t[1]) / (t[2] - t[1]))[:, None] * b2
        out.append(c)
    out.append(points[-1:])
    return np.concatenate(out, axis=0)


def equally_spaced_points(poly: np.ndarray, dist: float
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """Walk the polyline emitting points every `dist` units of arc
    length.  Returns (points (M, 2), step_multiplier (M,)): every
    point's blob intensity scales with its step (the final partial
    step scales the last blob down)."""
    pts = [poly[0].astype(np.float64).copy()]
    mults = [dist]
    current = poly[0].astype(np.float64).copy()
    next_i = 1
    n = len(poly)
    while next_i < n:
        prev = current
        acc = 0.0
        while True:
            if next_i >= n:
                # leftover: emit the final vertex with the partial arc
                pts.append(prev.copy())
                mults.append(acc)
                return (np.asarray(pts, np.float64),
                        np.asarray(mults, np.float64))
            seg = poly[next_i] - prev
            seg_len = float(np.hypot(seg[0], seg[1]))
            if acc + seg_len >= dist:
                current = prev + seg * ((dist - acc) / seg_len)
                pts.append(current.copy())
                mults.append(dist)
                break
            acc += seg_len
            prev = poly[next_i].astype(np.float64).copy()
            next_i += 1
    return np.asarray(pts, np.float64), np.asarray(mults, np.float64)


# window radius in sigmas: the fast-erf rational has fat tails, so the
# difference only drops below ~1e-6 beyond ~6.3 sigma
SIGMA_PAD = 6.3


def spline_points(H: int, W: int, ctrl: np.ndarray, color: np.ndarray,
                  sigma_dct: np.ndarray):
    """The geometry of one spline on (H, W) planes: the points it draws
    (Spline.points' rows), in order; the original's _draw_spline up to its
    blob loop, in its float64 arithmetic."""
    none = (np.zeros((0, 7)), np.zeros((0, 4), np.int64))
    poly = centripetal_catmull_rom(ctrl)
    pts, mults = equally_spaced_points(poly, DESIRED_RENDERING_DISTANCE)
    # coverage budget (the reference decoder rejects splines whose draw
    # cache would blow up); generous but bounded
    if len(pts) > 16 * (H * W) ** 0.5 + 4 * H * W:
        raise BitstreamError("too many pixels covered with splines")
    npts = len(pts)
    # total arc length per the reference walk: every point but the last
    # stands for one desired-distance step, the last for its leftover;
    # <= 0 (single point) draws nothing
    total = (npts - 2) * DESIRED_RENDERING_DISTANCE + float(mults[-1])
    if total <= 0.0:
        return none
    arc = np.arange(npts) * DESIRED_RENDERING_DISTANCE
    progress = np.minimum(arc / total, 1.0)
    t = 31.0 * progress
    k = np.arange(32)
    basis = _fast_cos(k[None, :] * (np.pi / 32.0) * (t[:, None] + 0.5))
    mult = np.where(k == 0, 1.0, np.sqrt(2.0))
    basis *= mult[None, :]
    colors = basis @ color.T          # (npts, 3)
    sigmas = basis @ sigma_dct        # (npts,)
    inten = mults / DESIRED_RENDERING_DISTANCE
    # the original's per-point loop, over all points at once: a point
    # with a non-finite or tiny sigma, or a box outside the frame, draws
    # nothing
    a = np.abs(sigmas)
    keep = np.isfinite(sigmas) & (a >= 1e-8)
    a, cx, cy = a[keep], pts[keep, 0], pts[keep, 1]
    rad = np.ceil(a * SIGMA_PAD + 2.0).astype(np.int64)
    x0 = np.maximum(0, np.floor(cx).astype(np.int64) - rad)
    x1 = np.minimum(W - 1, np.ceil(cx).astype(np.int64) + rad)
    y0 = np.maximum(0, np.floor(cy).astype(np.int64) - rad)
    y1 = np.minimum(H - 1, np.ceil(cy).astype(np.int64) + rad)
    drawn = (x0 <= x1) & (y0 <= y1)
    rows = np.column_stack([cx, cy, a, inten[keep], colors[keep]])[drawn]
    boxes = np.column_stack([x0, x1, y0, y1])[drawn]
    return np.ascontiguousarray(rows), np.ascontiguousarray(boxes)


def draw_points(planes, pts: np.ndarray, boxes: np.ndarray) -> None:
    """The blob loop of the original's _draw_spline over Splines.points'
    rows: each blob's erf-integrated Gaussian added onto its box."""
    for (cx, cy, s, inten, c0, c1, c2), (x0, x1, y0, y1) in zip(
            pts.tolist(), boxes.tolist()):
        xs = np.arange(x0, x1 + 1, dtype=np.float64)
        ys = np.arange(y0, y1 + 1, dtype=np.float64)
        inv = 1.0 / (s * np.sqrt(2.0))
        ex = _erf((xs + 0.5 - cx) * inv) - _erf((xs - 0.5 - cx) * inv)
        ey = _erf((ys + 0.5 - cy) * inv) - _erf((ys - 0.5 - cy) * inv)
        blob = (0.25 * s * inten) * np.outer(ey, ex)
        for c, col in enumerate((c0, c1, c2)):
            planes[c][y0:y1 + 1, x0:x1 + 1] += col * blob


def _erf(x: np.ndarray) -> np.ndarray:
    """Vectorized erf (Abramowitz–Stegun 7.1.26, |err| < 1.5e-7).
    Kernel fits show libjxl 0.7 draws with true erf (residual 5e-4 vs
    8e-4 for the newer fast rational erf)."""
    sign = np.sign(x)
    ax = np.abs(x)
    tt = 1.0 / (1.0 + 0.3275911 * ax)
    y = 1.0 - (((((1.061405429 * tt - 1.453152027) * tt)
                 + 1.421413741) * tt - 0.284496736) * tt
               + 0.254829592) * tt * np.exp(-ax * ax)
    return sign * y


def _fast_cos(x: np.ndarray) -> np.ndarray:
    """The reference decoder's fast cosine (range-reduce + order-4
    polynomial + two angle duplications, L1 ~7e-5; cf. reference
    algo/fast_math-inl.h FastCosf), used for the continuous DCT32."""
    pi = np.float64(np.float32(3.14159265358979323846))
    xm = x - np.floor(x * (0.5 / pi)) * (2.0 * pi)
    x_pi = np.minimum(xm, 2.0 * pi - xm)
    above = x_pi >= pi / 2.0
    x_ph = np.where(above, pi - x_pi, x_pi)
    xs = 0.25 * x_ph
    x2 = xs * xs
    x4 = x2 * x2
    pre = x4 * np.float32(0.06960438) \
        + (x2 * np.float32(-0.84087373) + np.float32(1.68179268))
    s1 = pre * pre - np.float32(1.414213562)
    s2 = s1 * s1 - 1.0
    return np.where(above, -s2, s2)
