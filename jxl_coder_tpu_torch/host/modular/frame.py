"""Frame-level modular decoding (``jxl_coder_tpu/modular/frame.py``).

A frame's modular image holds the colour channels (modular frames
only) followed by one channel per extra channel.  The GLOBAL stream
decodes the group header, meta-applies transforms, and decodes every
channel that fits within group_dim; larger channels are decoded
rectangle-by-rectangle by the per-group ModularAC streams
(stream id = 1 + 3*num_dc_groups + num_quant_tables + pass*ng + g).

The channel planes decode on the host into numpy, as in the original.
The transforms do not: a group stream's local chain (e.g. a per-group
RCT) is recorded with the rectangles it covers, and ``planes`` hands
over the raw planes, the frame's stream header and those chains
(``ModularPlanes``); the device layer (``modular/device.py``
``undo_frame``) uploads the planes once, undoes each recorded chain on
views of them, then the frame's own chain.  Deferring the group chains
gives the original's result, because a group stream predicts only from
its own raw channels and no later stream reads an earlier group's
pixels.  ``undo_on_host`` undoes them in int64 numpy instead, as the
original does: the float64 host decoder's route (a VarDCT frame's extra
channels).  This module is numpy only.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Tuple

import numpy as np

from ..bitstream.reader import BitReader, BitstreamError
from . import transform as T
from .image import Channel, ModularImage
from .stream import GroupHeader, decode_modular_stream

NUM_QUANT_TABLES = 17


@dataclasses.dataclass
class _GroupChain:
    """A group stream's local transforms, to undo at finalize: the
    parent rectangles (channel index, y0, x0, rows, columns) of its
    views, its decoded channels (the views themselves where the meta
    steps kept them) and its header."""
    rects: List[Tuple[int, int, int, int, int]]
    views: List[Channel]
    channels: List[Channel]
    header: GroupHeader


class ModularPlanes(NamedTuple):
    """A Modular image as the host decoded it: its raw channel planes
    (numpy, every transform still to undo), the frame's stream header
    and the group streams' recorded chains."""
    image: ModularImage
    header: GroupHeader
    chains: List[_GroupChain]


@dataclasses.dataclass
class ModularFrameDecoder:
    image: ModularImage
    header: Optional[GroupHeader] = None
    gtree: object = None
    gcode: object = None
    group_dim: int = 256
    stopped_at: int = 0
    frame_w: int = 0
    frame_h: int = 0
    chains: List[_GroupChain] = dataclasses.field(default_factory=list)

    @staticmethod
    def for_frame(hdr, fh, gtree, gcode, include_color: bool,
                  w: int, h: int, full_w: int = None,
                  full_h: int = None) -> "ModularFrameDecoder":
        """w/h: coded frame size (drives the modular group grid);
        full_w/full_h: pre-upsampling signalled size — extra-channel
        planes are sized DivCeil(full, ec_upsampling << dim_shift)."""
        m = hdr.metadata
        fw = full_w if full_w is not None else w
        fhh = full_h if full_h is not None else h
        chans: List[Channel] = []
        if include_color:
            n_color = 1 if (m.colour_encoding.colour_space == 1
                            and not m.xyb_encoded) else 3
            for _ in range(n_color):
                chans.append(Channel(w, h))
        for i, ec in enumerate(m.extra_channels):
            ds = ec.dim_shift
            up = fh.ec_upsampling[i] if i < len(fh.ec_upsampling) else 1
            cw = -(-fw // (up << ds)) if (up << ds) > 1 else fw
            ch = -(-fhh // (up << ds)) if (up << ds) > 1 else fhh
            chans.append(Channel(cw, ch, hshift=ds, vshift=ds))
        return ModularFrameDecoder(
            image=ModularImage(chans), gtree=gtree, gcode=gcode,
            group_dim=fh.group_dim(), frame_w=w, frame_h=h)

    def read_global(self, br: BitReader) -> None:
        if not self.image.channels:
            self.header = GroupHeader()
            return
        self.header = decode_modular_stream(
            br, self.image, stream_id=0, global_tree=self.gtree,
            global_code=self.gcode, max_chan_size=self.group_dim)
        self.stopped_at = getattr(self.header, "stopped_at",
                                  len(self.image.channels))
        # pre-allocate deferred channels: per-group streams decode into
        # disjoint rect views of them
        for ci in range(self.stopped_at, len(self.image.channels)):
            self.image.channels[ci].alloc()

    def _group_views(self, group_index: int, gd: int,
                     minshift: int, maxshift: int):
        """(parent rectangle, rect Channel) pairs of deferred channels in
        the given shift bucket for the group tile at group_index."""
        gx_n = -(-self.frame_w // gd)
        gx0 = (group_index % gx_n) * gd
        gy0 = (group_index // gx_n) * gd
        views = []
        for ci in range(self.stopped_at, len(self.image.channels)):
            ch = self.image.channels[ci]
            if ch.width == 0 or ch.height == 0:
                continue
            shift = min(ch.hshift, ch.vshift)
            if shift < minshift or shift >= maxshift:
                continue
            ch.alloc()
            x0, y0 = gx0 >> ch.hshift, gy0 >> ch.vshift
            rw = min(-(-gd >> ch.hshift), ch.width - x0)
            rh = min(-(-gd >> ch.vshift), ch.height - y0)
            if rw <= 0 or rh <= 0:
                continue
            v = Channel(rw, rh, hshift=ch.hshift, vshift=ch.vshift)
            v.data = ch.data[y0:y0 + rh, x0:x0 + rw]
            views.append(((ci, y0, x0, rh, rw), v))
        return views

    def _decode_group_streams(self, br, views, sid) -> GroupHeader:
        """Decode a group stream into rect views; record its LOCAL
        transforms (e.g. per-group RCT) for finalize."""
        sub = ModularImage([v for _, v in views], nb_meta_channels=0)
        header = decode_modular_stream(br, sub, stream_id=sid,
                                       global_tree=self.gtree,
                                       global_code=self.gcode)
        if header.transforms:
            self.chains.append(_GroupChain(
                [r for r, _ in views], [v for _, v in views],
                list(sub.channels), header))
        return header

    def read_lf_group(self, br: BitReader, group_index: int,
                      num_dc_groups: int) -> None:
        """ModularDC stream: deferred channels with shift >= 3,
        rect per LF group (8x the group dimension)."""
        views = self._group_views(group_index, self.group_dim * 8,
                                  3, 1 << 30)
        if not views:
            return
        sid = 1 + num_dc_groups + group_index
        self._decode_group_streams(br, views, sid)

    def read_group(self, br: BitReader, group_index: int,
                   num_dc_groups: int, num_groups: int,
                   pass_index: int = 0) -> None:
        """ModularAC stream: deferred channels with shift < 3."""
        views = self._group_views(group_index, self.group_dim, 0, 3)
        if not views:
            return
        sid = (1 + 3 * num_dc_groups + NUM_QUANT_TABLES
               + num_groups * pass_index + group_index)
        self._decode_group_streams(br, views, sid)

    def planes(self) -> ModularPlanes:
        """The raw planes, the frame's header and the group chains."""
        return ModularPlanes(self.image, self.header, self.chains)


def _undo_numpy(image: ModularImage, header: GroupHeader) -> None:
    for t in reversed(header.transforms):
        {0: T.rct_inverse, 1: T.palette_inverse,
         2: T.squeeze_inverse}.get(t.id, _bad_transform)(image, t)


def _bad_transform(_image, t) -> None:
    raise BitstreamError(f"invalid transform id {t.id}")


def undo_on_host(planes: ModularPlanes) -> List[np.ndarray]:
    """The int64 numpy inverse transforms: each group stream's chain on
    its rectangles of the frame's planes, then the frame's chain -> the
    channels' int32 planes (the original's finalize)."""
    parents = planes.image.channels
    for chain in planes.chains:
        sub = ModularImage(list(chain.channels), nb_meta_channels=0)
        _undo_numpy(sub, chain.header)
        if len(sub.channels) != len(chain.rects):
            raise BitstreamError(
                "group-local transform changed channel count")
        for (ci, y0, x0, rh, rw), ch in zip(chain.rects, sub.channels):
            parents[ci].data[y0:y0 + rh, x0:x0 + rw] = ch.data
    _undo_numpy(planes.image, planes.header)
    return [c.data for c in planes.image.channels]
