"""Modular transforms: RCT, Palette, Squeeze (§H.6): their headers, the
channel-list meta steps a stream's decode applies before reading its
planes, the forward pixel transforms, which the fixture writers use to
build streams, and the inverse pixel transforms in int64 numpy.  The
decode's inverses run on the device
(``jxl_coder_tpu_torch/modular/device.py``); the numpy inverses here are
the int64 oracle the device kernels are held to, and the float64 host
decoder's (``host/vardct/dec_real.py``, a VarDCT frame's extra
channels).
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from ..bitstream.reader import BitReader, BitstreamError
from ..bitstream.writer import BitWriter
from .image import Channel, ModularImage

BEGIN_C_DIST = ((3, 0), (6, 8), (10, 72), (13, 1096))


@dataclasses.dataclass
class SqueezeParams:
    horizontal: bool
    in_place: bool
    begin_c: int
    num_c: int


@dataclasses.dataclass
class Transform:
    id: int  # 0 RCT, 1 Palette, 2 Squeeze
    begin_c: int = 0
    rct_type: int = 6
    num_c: int = 3
    nb_colours: int = 0
    nb_deltas: int = 0
    d_pred: int = 0
    squeezes: List[SqueezeParams] = dataclasses.field(default_factory=list)

    @staticmethod
    def read(br: BitReader) -> "Transform":
        t = Transform(id=br.u32(0, 1, 2, 3))
        if t.id == 0:  # RCT
            t.begin_c = br.u32(*BEGIN_C_DIST)
            t.rct_type = br.u32(6, (2, 0), (4, 2), (6, 10))
        elif t.id == 1:  # Palette
            t.begin_c = br.u32(*BEGIN_C_DIST)
            t.num_c = br.u32(1, 3, 4, (13, 1))
            t.nb_colours = br.u32((8, 0), (10, 256), (12, 1280), (16, 5376))
            t.nb_deltas = br.u32(0, (8, 1), (10, 257), (16, 1281))
            t.d_pred = br.u(4)
        elif t.id == 2:  # Squeeze
            num_sq = br.u32(0, (4, 1), (6, 9), (8, 41))
            for _ in range(num_sq):
                t.squeezes.append(SqueezeParams(
                    horizontal=br.bool(), in_place=br.bool(),
                    begin_c=br.u32(*BEGIN_C_DIST),
                    num_c=br.u32(1, 2, 3, (4, 4))))
        else:
            raise BitstreamError("invalid transform id")
        return t

    def write(self, bw: BitWriter) -> None:
        bw.u32(self.id, 0, 1, 2, 3)
        if self.id == 0:
            bw.u32(self.begin_c, *BEGIN_C_DIST)
            bw.u32(self.rct_type, 6, (2, 0), (4, 2), (6, 10))
        elif self.id == 1:
            bw.u32(self.begin_c, *BEGIN_C_DIST)
            bw.u32(self.num_c, 1, 3, 4, (13, 1))
            bw.u32(self.nb_colours, (8, 0), (10, 256), (12, 1280),
                   (16, 5376))
            bw.u32(self.nb_deltas, 0, (8, 1), (10, 257), (16, 1281))
            bw.u(self.d_pred, 4)
        elif self.id == 2:
            bw.u32(len(self.squeezes), 0, (4, 1), (6, 9), (8, 41))
            for s in self.squeezes:
                bw.bool(s.horizontal)
                bw.bool(s.in_place)
                bw.u32(s.begin_c, *BEGIN_C_DIST)
                bw.u32(s.num_c, 1, 2, 3, (4, 4))


# --------------------------------------------------------------------------
# RCT

def _rct_inverse_type(a, b, c, rct_type):
    """Inverse of the 7 RCT variants on int64 arrays (a,b,c = ch0,1,2)."""
    if rct_type == 0:
        return a, b, c
    if rct_type == 1:
        return a, b, c + a
    if rct_type == 2:
        return a, b + a, c
    if rct_type == 3:
        return a, b + a, c + a
    if rct_type == 4:
        return a, b + ((a + c) >> 1), c
    if rct_type == 5:
        # third += first happens BEFORE second uses it (rct.cc InvRCT)
        c2 = c + a
        return a, b + ((a + c2) >> 1), c2
    if rct_type == 6:  # YCoCg
        y, co, cg = a, b, c
        tmp = y - (cg >> 1)
        g = cg + tmp
        bb = tmp - (co >> 1)
        r = bb + co
        return r, g, bb
    raise BitstreamError("bad RCT type")


def _rct_forward_type(r, g, b, rct_type):
    """Exact inverses of _rct_inverse_type (all 7 subtypes)."""
    if rct_type == 0:
        return r, g, b
    if rct_type == 1:
        return r, g, b - r
    if rct_type == 2:
        return r, g - r, b
    if rct_type == 3:
        return r, g - r, b - r
    if rct_type == 4:
        return r, g - ((r + b) >> 1), b
    if rct_type == 5:
        return r, g - ((r + b) >> 1), b - r
    if rct_type == 6:
        co = r - b
        tmp = b + (co >> 1)
        cg = g - tmp
        y = tmp + (cg >> 1)
        return y, co, cg
    raise ValueError(f"bad forward RCT type {rct_type}")


_PERMUTATIONS = [
    (0, 1, 2), (1, 2, 0), (2, 0, 1), (0, 2, 1), (1, 0, 2), (2, 1, 0)]


def rct_inverse(image: ModularImage, t: Transform) -> None:
    b = t.begin_c
    if b < 0 or b + 3 > len(image.channels):
        from ..bitstream.reader import BitstreamError
        raise BitstreamError(
            f"RCT channel range [{b}, {b + 3}) outside the "
            f"{len(image.channels)}-channel image")
    perm = t.rct_type // 7
    typ = t.rct_type % 7
    c0 = image.channels[b].data.astype(np.int64)
    c1 = image.channels[b + 1].data.astype(np.int64)
    c2 = image.channels[b + 2].data.astype(np.int64)
    o0, o1, o2 = _rct_inverse_type(c0, c1, c2, typ)
    outs = [o0, o1, o2]
    p = _PERMUTATIONS[perm]
    # inverse permutation: stored channel i holds component p[i]
    result = [None, None, None]
    for i in range(3):
        result[p[i]] = outs[i]
    for i in range(3):
        image.channels[b + i].data = result[i].astype(np.int32)


def rct_forward(image: ModularImage, t: Transform) -> None:
    b = t.begin_c
    perm = t.rct_type // 7
    typ = t.rct_type % 7
    p = _PERMUTATIONS[perm]
    comps = [image.channels[b + i].data.astype(np.int64) for i in range(3)]
    # forward permutation: stored[i] = comp[p[i]]
    stored = [comps[p[i]] for i in range(3)]
    s0, s1, s2 = _rct_forward_type(stored[0], stored[1], stored[2], typ)
    for i, s in enumerate((s0, s1, s2)):
        image.channels[b + i].data = s.astype(np.int32)


# --------------------------------------------------------------------------
# Palette

def palette_meta_apply(image: ModularImage, t: Transform) -> None:
    """Adjust channel list before decoding (inverse-direction meta step)."""
    b, n = t.begin_c, t.num_c
    if n < 1 or b < 0 or b + n > len(image.channels):
        from ..bitstream.reader import BitstreamError
        raise BitstreamError(
            f"palette channel range [{b}, {b + n}) outside the "
            f"{len(image.channels)}-channel image")
    first = image.channels[b]
    # replaced by 1 index channel; palette meta-channel prepended
    pal = Channel(t.nb_colours + t.nb_deltas, n, hshift=-1, vshift=-1)
    idx = Channel(first.width, first.height, first.hshift, first.vshift)
    image.channels = ([pal] + image.channels[:b] + [idx]
                      + image.channels[b + n:])
    image.nb_meta_channels += 1


def palette_inverse(image: ModularImage, t: Transform) -> None:
    b, n = t.begin_c, t.num_c
    pal = image.channels[0].data  # (n, nb_colours+nb_deltas)
    idx_chan = image.channels[b + 1]
    idx = idx_chan.data
    if t.nb_deltas:
        raise BitstreamError("palette deltas not yet supported")
    outs = []
    nb = t.nb_colours
    for c in range(n):
        out = np.zeros_like(idx)
        within = (idx >= 0) & (idx < nb)
        out[within] = pal[c][np.clip(idx, 0, nb - 1)][within]
        # implicit palette for idx >= nb_colours (spec-defined synthetic
        # entries); out-of-range handled as grey ramp — TODO conformance
        over = idx >= nb
        if over.any():
            out[over] = (idx[over] - nb)
        neg = idx < 0
        if neg.any():
            out[neg] = 0
        outs.append(out)
    new_channels = image.channels[1:b + 1]
    for c in range(n):
        new_channels.append(Channel(idx_chan.width, idx_chan.height,
                                    idx_chan.hshift, idx_chan.vshift,
                                    outs[c].astype(np.int32)))
    new_channels.extend(image.channels[b + 2:])
    image.channels = new_channels
    image.nb_meta_channels -= 1


def palette_forward(image: ModularImage, t: Transform) -> None:
    """Exact-palette forward (encoder chooses nb_colours matching content)."""
    b, n = t.begin_c, t.num_c
    chans = [image.channels[b + c].data for c in range(n)]
    h, w = chans[0].shape
    stacked = np.stack(chans, axis=-1).reshape(-1, n)
    colors, inverse = np.unique(stacked, axis=0, return_inverse=True)
    if len(colors) != t.nb_colours:
        raise ValueError("nb_colours mismatch")
    pal = Channel(t.nb_colours, n, hshift=-1, vshift=-1,
                  data=colors.T.astype(np.int32).copy())
    idx = Channel(w, h, image.channels[b].hshift, image.channels[b].vshift,
                  inverse.reshape(h, w).astype(np.int32))
    image.channels = ([pal] + image.channels[:b] + [idx]
                      + image.channels[b + n:])
    image.nb_meta_channels += 1


# --------------------------------------------------------------------------
# Squeeze

def smooth_tendency(a: np.ndarray, b: np.ndarray, c: np.ndarray):
    """Vectorized SmoothTendency (int arrays)."""
    a = a.astype(np.int64)
    b = b.astype(np.int64)
    c = c.astype(np.int64)
    out = np.zeros_like(a)

    m1 = (a >= b) & (b >= c)
    x = (4 * a - 3 * c - b + 6) // 12
    x = np.where(x - (x & 1) > 2 * (a - b), 2 * (a - b) + 1, x)
    x = np.where(x + (x & 1) > 2 * (b - c), 2 * (b - c), x)
    out = np.where(m1, x, out)

    m2 = (a <= b) & (b <= c)
    num = 4 * a - 3 * c - b - 6
    # C-truncating division (operand is <= 0 in this branch)
    y = -((-num) // 12)
    y = np.where(y + (y & 1) < 2 * (a - b), 2 * (a - b) - 1, y)
    y = np.where(y - (y & 1) < 2 * (b - c), 2 * (b - c), y)
    out = np.where(m2, y, out)
    return out


def _unsqueeze_1d(avg: np.ndarray, res: np.ndarray, out_len: int):
    """Inverse squeeze along the last axis.  avg/res: (..., na)/(..., nr)."""
    na = avg.shape[-1]
    nr = res.shape[-1]
    avg = avg.astype(np.int64)
    res = res.astype(np.int64)
    out = np.zeros(avg.shape[:-1] + (out_len,), np.int64)
    left = None
    for k in range(na):
        a = avg[..., k]
        if k + 1 < na:
            next_avg = avg[..., k + 1]
        else:
            next_avg = a
        if k > 0:
            left = out[..., 2 * k - 1]
        else:
            left = a
        if k < nr:
            diff = res[..., k] + smooth_tendency(left, a, next_avg)
        else:
            # odd width: last output sample equals avg directly
            out[..., 2 * k] = a
            continue
        half = np.sign(diff) * (np.abs(diff) >> 1)  # trunc toward zero
        first = a + half
        out[..., 2 * k] = first
        if 2 * k + 1 < out_len:
            out[..., 2 * k + 1] = first - diff
    return out


def _squeeze_1d(data: np.ndarray):
    """Forward squeeze along last axis -> (avg, residual)."""
    n = data.shape[-1]
    data = data.astype(np.int64)
    nr = n // 2
    na = (n + 1) // 2
    v0 = data[..., 0:2 * nr:2]
    v1 = data[..., 1:2 * nr:2]
    diff = v0 - v1
    avg_pairs = (v0 + v1 + (v0 > v1)) >> 1
    if n % 2:
        avg = np.concatenate([avg_pairs, data[..., -1:]], axis=-1)
    else:
        avg = avg_pairs
    res = np.zeros(data.shape[:-1] + (nr,), np.int64)
    for k in range(nr):
        a = avg[..., k]
        next_avg = avg[..., k + 1] if k + 1 < na else a
        if k > 0:
            left = data[..., 2 * k - 1]
        else:
            left = a
        res[..., k] = diff[..., k] - smooth_tendency(left, a, next_avg)
    return avg, res


def default_squeeze_params(image: ModularImage) -> list:
    """Default squeeze sequence (squeeze.cc DefaultSqueezeParameters):
    optional first chroma squeeze when >=3 same-sized channels, one
    vertical halving first on tall/square images (h >= w), then
    alternating horizontal/vertical halvings while either dimension
    exceeds 8.  The vertical-first rule was pinned empirically with
    zero-bit probe streams (leaf offsets reveal libjxl's channel
    indices/order); getting it wrong transposes every squeezed channel
    on square images."""
    mc = image.nb_meta_channels
    nb = len(image.channels) - mc
    w = image.channels[mc].width
    h = image.channels[mc].height
    out = []
    if nb > 2 and image.channels[mc + 1].width == w \
            and image.channels[mc + 1].height == h:
        out.append(SqueezeParams(horizontal=True, in_place=False,
                                 begin_c=mc + 1, num_c=2))
        out.append(SqueezeParams(horizontal=False, in_place=False,
                                 begin_c=mc + 1, num_c=2))
    if h >= w and h > 8:
        out.append(SqueezeParams(horizontal=False, in_place=True,
                                 begin_c=mc, num_c=nb))
        h = (h + 1) // 2
    while w > 8 or h > 8:
        if w > 8:
            out.append(SqueezeParams(horizontal=True, in_place=True,
                                     begin_c=mc, num_c=nb))
            w = (w + 1) // 2
        if h > 8:
            out.append(SqueezeParams(horizontal=False, in_place=True,
                                     begin_c=mc, num_c=nb))
            h = (h + 1) // 2
    return out


def squeeze_meta_apply(image: ModularImage, t: Transform) -> None:
    """Restructure channel list for decoding (channels appear squeezed)."""
    if not t.squeezes:
        t.squeezes = default_squeeze_params(image)
    for s in t.squeezes:
        _apply_one_squeeze_meta(image, s)


def _apply_one_squeeze_meta(image: ModularImage, s: SqueezeParams) -> None:
    from ..bitstream.reader import BitstreamError
    if s.num_c < 1 or s.begin_c < 0 \
            or s.begin_c + s.num_c > len(image.channels):
        raise BitstreamError(
            f"squeeze channel range [{s.begin_c}, {s.begin_c + s.num_c})"
            f" outside the {len(image.channels)}-channel image")
    for i in range(s.num_c):
        c = s.begin_c + i
        ch = image.channels[c]
        if s.horizontal:
            na = (ch.width + 1) // 2
            nr = ch.width // 2
            avg = Channel(na, ch.height, ch.hshift + 1, ch.vshift)
            res = Channel(nr, ch.height, ch.hshift + 1, ch.vshift)
        else:
            na = (ch.height + 1) // 2
            nr = ch.height // 2
            avg = Channel(ch.width, na, ch.hshift, ch.vshift + 1)
            res = Channel(ch.width, nr, ch.hshift, ch.vshift + 1)
        image.channels[c] = avg
        if s.in_place:
            image.channels.insert(s.begin_c + s.num_c + i, res)
        else:
            image.channels.append(res)


def squeeze_inverse(image: ModularImage, t: Transform) -> None:
    for s in reversed(t.squeezes):
        # non-in-place residuals form a contiguous tail block; fix its
        # base BEFORE deleting (deletions above base don't move base+i)
        base = len(image.channels) - s.num_c
        for i in reversed(range(s.num_c)):
            c = s.begin_c + i
            if s.in_place:
                res_idx = s.begin_c + s.num_c + i
            else:
                res_idx = base + i
            avg = image.channels[c]
            res = image.channels[res_idx]
            if s.horizontal:
                out_len = avg.width + res.width
                out = _unsqueeze_1d(avg.data, res.data, out_len)
                ch = Channel(out_len, avg.height, avg.hshift - 1, avg.vshift,
                             out.astype(np.int32))
            else:
                out_len = avg.height + res.height
                out = _unsqueeze_1d(avg.data.T, res.data.T, out_len).T
                ch = Channel(avg.width, out_len, avg.hshift, avg.vshift - 1,
                             out.astype(np.int32))
            image.channels[c] = ch
            del image.channels[res_idx]


def squeeze_forward(image: ModularImage, t: Transform) -> None:
    if not t.squeezes:
        t.squeezes = default_squeeze_params(image)
    for s in t.squeezes:
        for i in range(s.num_c):
            c = s.begin_c + i
            ch = image.channels[c]
            if s.horizontal:
                avg_d, res_d = _squeeze_1d(ch.data)
                avg = Channel(avg_d.shape[-1], ch.height, ch.hshift + 1,
                              ch.vshift, avg_d.astype(np.int32))
                res = Channel(res_d.shape[-1], ch.height, ch.hshift + 1,
                              ch.vshift, res_d.astype(np.int32))
            else:
                avg_d, res_d = _squeeze_1d(ch.data.T)
                avg = Channel(ch.width, avg_d.shape[-1], ch.hshift,
                              ch.vshift + 1, avg_d.T.astype(np.int32).copy())
                res = Channel(ch.width, res_d.shape[-1], ch.hshift,
                              ch.vshift + 1, res_d.T.astype(np.int32).copy())
            image.channels[c] = avg
            if s.in_place:
                image.channels.insert(s.begin_c + s.num_c + i, res)
            else:
                image.channels.append(res)
