"""Modular transforms: RCT, Palette, Squeeze (§H.6): their headers and
the channel-list meta steps a stream's decode applies before reading its
planes.  The port decodes no Modular frame, so it keeps neither the
inverse nor the forward pixel transforms.
"""

from __future__ import annotations

import dataclasses
from typing import List

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

_PERMUTATIONS = [
    (0, 1, 2), (1, 2, 0), (2, 0, 1), (0, 2, 1), (1, 0, 2), (2, 1, 0)]


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


# --------------------------------------------------------------------------
# Squeeze

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

