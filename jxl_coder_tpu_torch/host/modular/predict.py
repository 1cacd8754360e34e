"""Modular predictors + properties (§H.4-H.5), host reference path.

14 predictors (Zero..Average4 + the self-correcting weighted predictor) and
the MA-tree property vector.  This is the bit-exactness-critical scalar
oracle; vectorized/native paths must match it exactly.

NOTE on conformance: the weighted-predictor fixed-point details and
properties >= 8 are implemented from the spec structure and flagged for
empirical pinning against reference bitstreams; our own encoder restricts
itself to predictors {0,1,2,3,5} and properties 0-7, which are settled.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from ..bitstream.reader import BitReader
from ..bitstream.writer import BitWriter

NUM_BASE_PROPS = 16


@dataclasses.dataclass
class WPParams:
    """Weighted-predictor header (§H.5; wp_header in GroupHeader)."""
    p1: int = 16
    p2: int = 10
    p3a: int = 7
    p3b: int = 7
    p3c: int = 7
    p3d: int = 0
    p3e: int = 0
    w0: int = 13
    w1: int = 12
    w2: int = 12
    w3: int = 12

    @staticmethod
    def read(br: BitReader) -> "WPParams":
        w = WPParams()
        if br.bool():  # all_default
            return w
        w.p1 = br.u(5)
        w.p2 = br.u(5)
        w.p3a = br.u(5)
        w.p3b = br.u(5)
        w.p3c = br.u(5)
        w.p3d = br.u(5)
        w.p3e = br.u(5)
        w.w0 = br.u(4)
        w.w1 = br.u(4)
        w.w2 = br.u(4)
        w.w3 = br.u(4)
        return w

    def write(self, bw: BitWriter) -> None:
        if self == WPParams():
            bw.bool(True)
            return
        bw.bool(False)
        for v in (self.p1, self.p2, self.p3a, self.p3b, self.p3c,
                  self.p3d, self.p3e):
            bw.u(v, 5)
        for v in (self.w0, self.w1, self.w2, self.w3):
            bw.u(v, 4)


def _floor_log2(v: int) -> int:
    return v.bit_length() - 1


_DIVLOOKUP = tuple((1 << 24) // (i + 1) for i in range(64))


class WPState:
    """Per-channel rolling state of the self-correcting (weighted)
    predictor.

    Bit-exact port of weighted::State (context_predict.h): two
    row-halves of error buffers swapped per row, approximate division
    via a 64-entry reciprocal table in both ErrorWeight and
    WeightedAverage, and the trick of accumulating each pixel's
    subpredictor error into the previous row's x+1 slot so that the
    next pixels in the same row see W/WW errors through their
    N/NW reads."""

    def __init__(self, params: WPParams, width: int):
        self.p = params
        self.width = width
        # prev holds row y-1 state (read side), cur is written this row.
        # +2 margin like the reference so x+1 writes never go OOB.
        self.pred_cur = [[0] * (width + 2) for _ in range(4)]
        self.pred_prev = [[0] * (width + 2) for _ in range(4)]
        self.err_cur = [0] * (width + 2)
        self.err_prev = [0] * (width + 2)
        self.pred = 0                    # last prediction (<<3 domain)
        self._subpred = [0, 0, 0, 0]
        self.prop = 0                    # property 15: signed max error

    def new_row(self):
        self.pred_cur, self.pred_prev = self.pred_prev, self.pred_cur
        self.err_cur, self.err_prev = self.err_prev, self.err_cur
        # no zeroing: cur slots are assigned before any read (reference
        # reuses the two row-halves without clearing)

    def predict(self, x: int, y: int, w: int,
                W: int, N: int, NW: int, NE: int, NN: int) -> int:
        """Returns the final (already descaled) prediction; also sets
        self.prop (property 15) and self.pred (internal <<3 value)."""
        p = self.p
        pos_ne = x + 1 if x < w - 1 else x
        pos_nw = x - 1 if x > 0 else x

        wts = [0, 0, 0, 0]
        for k, wk in enumerate((p.w0, p.w1, p.w2, p.w3)):
            pe = self.pred_prev[k]
            esum = pe[x] + pe[pos_ne] + pe[pos_nw]
            shift = _floor_log2(esum + 1) - 5
            if shift < 0:
                shift = 0
            wts[k] = 4 + ((wk * _DIVLOOKUP[esum >> shift]) >> shift)

        W3, N3, NW3, NE3, NN3 = W << 3, N << 3, NW << 3, NE << 3, NN << 3
        teW = self.err_cur[x - 1] if x > 0 else 0
        teN = self.err_prev[x]
        teNW = self.err_prev[pos_nw]
        teNE = self.err_prev[pos_ne]
        sumWN = teN + teW

        # property 15: strictly-larger magnitude wins, earliest on tie
        prop = teW
        if abs(teN) > abs(prop):
            prop = teN
        if abs(teNW) > abs(prop):
            prop = teNW
        if abs(teNE) > abs(prop):
            prop = teNE
        self.prop = prop

        sp = self._subpred
        sp[0] = W3 + NE3 - N3
        sp[1] = N3 - (((sumWN + teNE) * p.p1) >> 5)
        sp[2] = W3 - (((sumWN + teNW) * p.p2) >> 5)
        sp[3] = N3 - ((teNW * p.p3a + teN * p.p3b + teNE * p.p3c
                       + (NN3 - N3) * p.p3d + (NW3 - W3) * p.p3e) >> 5)

        # WeightedAverage with reciprocal-table division
        wsum = wts[0] + wts[1] + wts[2] + wts[3]
        logw = _floor_log2(wsum) - 4
        wsum = 0
        for k in range(4):
            wts[k] >>= logw
            wsum += wts[k]
        s = (wsum >> 1) - 1
        for k in range(4):
            s += sp[k] * wts[k]
        pred = (s * _DIVLOOKUP[wsum - 1]) >> 24

        # clamp unless teN, teW, teNW all share a sign
        if ((teN ^ teW) | (teN ^ teNW)) <= 0:
            lo = min(W3, NE3, N3)
            hi = max(W3, NE3, N3)
            pred = max(lo, min(hi, pred))
        self.pred = pred
        return (pred + 3) >> 3

    def update(self, x: int, value: int) -> None:
        v3 = value << 3
        self.err_cur[x] = self.pred - v3
        sp = self._subpred
        for k in range(4):
            e = (abs(sp[k] - v3) + 3) >> 3
            self.pred_cur[k][x] = e
            # W/WW error propagation: next pixels read this via pos_N/NW
            self.pred_prev[k][x + 1] += e


def neighbors(data: np.ndarray, x: int, y: int, w: int):
    """(W, N, NW, NE, NN, WW, NEE) with spec edge rules."""
    if x > 0:
        W = int(data[y, x - 1])
    elif y > 0:
        W = int(data[y - 1, x])
    else:
        W = 0
    N = int(data[y - 1, x]) if y > 0 else W
    NW = int(data[y - 1, x - 1]) if (x > 0 and y > 0) else W
    NE = int(data[y - 1, x + 1]) if (x + 1 < w and y > 0) else N
    NN = int(data[y - 2, x]) if y > 1 else N
    WW = int(data[y, x - 2]) if x > 1 else W
    NEE = int(data[y - 1, x + 2]) if (x + 2 < w and y > 0) else NE
    return W, N, NW, NE, NN, WW, NEE


def clamped_gradient(N: int, W: int, NW: int) -> int:
    m = min(N, W)
    M = max(N, W)
    grad = N + W - NW
    if NW > M:
        return m
    if NW < m:
        return M
    return grad


def _tdiv(a: int, b: int) -> int:
    """C-style integer division (truncates toward zero)."""
    q = abs(a) // b
    return -q if a < 0 else q


def predict(predictor: int, W, N, NW, NE, NN, WW, NEE,
            wp_pred: Optional[int] = None) -> int:
    if predictor == 0:
        return 0
    if predictor == 1:
        return W
    if predictor == 2:
        return N
    if predictor == 3:  # Average0
        return _tdiv(W + N, 2)
    if predictor == 4:  # Select: ties go to top (pa < pb picks left)
        p = W + N - NW
        return W if abs(p - W) < abs(p - N) else N
    if predictor == 5:
        return clamped_gradient(N, W, NW)
    if predictor == 6:  # Weighted: WPState.predict already descales
        if wp_pred is None:
            raise ValueError("weighted predictor needs WP state")
        return wp_pred
    if predictor == 7:
        return NE
    if predictor == 8:
        return NW
    if predictor == 9:
        return WW
    if predictor == 10:  # Average1
        return _tdiv(W + NW, 2)
    if predictor == 11:  # Average2
        return _tdiv(NW + N, 2)
    if predictor == 12:  # Average3
        return _tdiv(N + NE, 2)
    if predictor == 13:  # Average4
        return _tdiv(6 * N - 2 * NN + 7 * W + WW + NEE + 3 * NE + 8, 16)
    raise ValueError(f"bad predictor {predictor}")


def properties_for_pixel(chan_index: int, stream_id: int, x: int, y: int,
                         W, N, NW, NE, NN, WW,
                         wp_prop: int,
                         prev_channels: List[np.ndarray],
                         prev_grad: int) -> List[int]:
    """Exact property vector (context_predict.h Predict<kUseTree>):

    0 c, 1 stream, 2 y, 3 x, 4 |N|, 5 |W|, 6 N, 7 W,
    8 W - (previous pixel's p9; 0 at row start), 9 W+N-NW,
    10 W-NW, 11 NW-N, 12 N-NE, 13 N-NN, 14 W-WW, 15 WP error,
    then per eligible previous channel (closest first):
    |v|, v, |v - grad|, v - grad with grad = ClampedGradient of its
    own causal neighbourhood."""
    grad = W + N - NW
    props = [
        chan_index, stream_id, y, x,
        abs(N), abs(W), N, W,
        W - prev_grad,       # 8: running local gradient
        grad,                # 9: kGradientProp
        W - NW,              # 10
        NW - N,              # 11
        N - NE,              # 12
        N - NN,              # 13
        W - WW,              # 14
        wp_prop,             # 15: kWPProp
    ]
    for pc in prev_channels:
        v = int(pc[y, x])
        vleft = int(pc[y, x - 1]) if x else 0
        vtop = int(pc[y - 1, x]) if y else vleft
        vtopleft = int(pc[y - 1, x - 1]) if (x and y) else vleft
        vpred = clamped_gradient(vtop, vleft, vtopleft)
        props.append(abs(v))
        props.append(v)
        props.append(abs(v - vpred))
        props.append(v - vpred)
    return props
