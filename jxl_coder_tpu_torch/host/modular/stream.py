"""Modular sub-bitstream decode/encode (§H.2-H.3).

A modular stream = GroupHeader (use_global_tree, wp params, transforms) +
optional local MA tree + entropy-coded channel planes.  Streams are
independent per group — the unit of TPU/host parallelism.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from ..bitstream.reader import BitReader, BitstreamError, unpack_signed, \
    pack_signed
from ..bitstream.writer import BitWriter
from ..entropy.coder import EntropyDecoder, TokenStream
from .image import Channel, ModularImage
from .predict import WPParams, WPState, neighbors, predict, \
    properties_for_pixel
from .tree import Tree, decode_tree, encode_tree
from . import transform as T


@dataclasses.dataclass
class GroupHeader:
    use_global_tree: bool = False
    wp_params: WPParams = dataclasses.field(default_factory=WPParams)
    transforms: List[T.Transform] = dataclasses.field(default_factory=list)

    @staticmethod
    def read(br: BitReader) -> "GroupHeader":
        g = GroupHeader()
        g.use_global_tree = br.bool()
        g.wp_params = WPParams.read(br)
        n = br.u32(0, 1, (4, 2), (8, 18))
        g.transforms = [T.Transform.read(br) for _ in range(n)]
        return g

    def write(self, bw: BitWriter) -> None:
        bw.bool(self.use_global_tree)
        self.wp_params.write(bw)
        bw.u32(len(self.transforms), 0, 1, (4, 2), (8, 18))
        for t in self.transforms:
            t.write(bw)


def apply_meta_transforms(image: ModularImage, header: GroupHeader) -> None:
    """Restructure the channel list as the decoder will see it."""
    for t in header.transforms:
        if t.id == 0:
            pass  # RCT keeps geometry
        elif t.id == 1:
            T.palette_meta_apply(image, t)
        elif t.id == 2:
            T.squeeze_meta_apply(image, t)


# --------------------------------------------------------------------------
# Channel plane decode

def decode_channel(dec: EntropyDecoder, tree: Tree, chan: Channel,
                   chan_index: int, stream_id: int,
                   prev_channels: List[np.ndarray],
                   wp_params: WPParams) -> None:
    w, h = chan.width, chan.height
    chan.alloc()
    if w == 0 or h == 0:
        return
    data = chan.data

    # fast path: single-leaf tree with simple predictor
    if len(tree.nodes) == 1:
        leaf = tree.nodes[0]
        if leaf.predictor in (0, 1, 2, 3, 5):
            _decode_single_leaf(dec, leaf, data, w, h)
            return

    need_wp = tree.uses_weighted()
    wp = WPState(wp_params, w) if need_wp else None
    max_prop = tree.max_property
    # eligible reference channels: same size AND same shifts, closest first
    eligible_prev = [p for (p, hs, vs) in prev_channels
                     if p.shape == (h, w)
                     and hs == chan.hshift and vs == chan.vshift]

    for y in range(h):
        if wp is not None and y > 0:
            wp.new_row()
        prev_grad = 0
        for x in range(w):
            W, N, NW, NE, NN, WW, NEE = neighbors(data, x, y, w)
            wp_pred = None
            wp_prop = 0
            if wp is not None:
                wp_pred = wp.predict(x, y, w, W, N, NW, NE, NN)
                wp_prop = wp.prop
            if max_prop >= 0:
                props = properties_for_pixel(
                    chan_index, stream_id, x, y, W, N, NW, NE, NN, WW,
                    wp_prop, eligible_prev, prev_grad)
                prev_grad = props[9]
                leaf = tree.lookup(props)
            else:
                leaf = tree.nodes[0]
            pred = predict(leaf.predictor, W, N, NW, NE, NN, WW, NEE,
                           wp_pred)
            val = pred + leaf.offset + leaf.multiplier * unpack_signed(
                dec.read(leaf.ctx))
            data[y, x] = val
            if wp is not None:
                wp.update(x, val)


def _decode_single_leaf(dec: EntropyDecoder, leaf, data, w, h) -> None:
    """Vectorizable path: context is constant so all residuals can be read
    up-front, then reconstruction is a (partly) vectorized scan."""
    n = w * h
    res = np.empty(n, np.int64)
    rd = dec.read
    ctx = leaf.ctx
    for i in range(n):
        res[i] = rd(ctx)
    res = _unpack_signed_np(res) * leaf.multiplier + leaf.offset
    res = res.reshape(h, w)
    p = leaf.predictor
    if p == 0:
        data[:, :] = res
    elif p == 1:  # W: prefix-sum along rows; x=0 takes N (prev row value)
        for y in range(h):
            base = data[y - 1, 0] if y > 0 else 0
            data[y] = np.cumsum(res[y]) + base
    elif p == 2:  # N: prefix-sum down columns; y=0 row: W chain
        row0 = np.cumsum(res[0])
        data[0] = row0
        data[1:] = res[1:]
        np.cumsum(data[:, :], axis=0, out=data[:, :])
    elif p == 3:  # (W+N)>>1 — sequential
        _scan_avg(data, res, w, h)
    elif p == 5:  # clamped gradient — sequential per pixel
        _scan_gradient(data, res, w, h)
    else:
        raise BitstreamError("unexpected predictor in fast path")


def _scan_avg(data, res, w, h):
    for y in range(h):
        for x in range(w):
            if x > 0:
                W = data[y, x - 1]
            elif y > 0:
                W = data[y - 1, x]
            else:
                W = 0
            N = data[y - 1, x] if y > 0 else W
            s_ = int(W) + int(N)
            q = abs(s_) >> 1
            data[y, x] = (-q if s_ < 0 else q) + res[y, x]


def _scan_gradient(data, res, w, h):
    from .predict import clamped_gradient
    for y in range(h):
        if y == 0:
            data[0] = np.cumsum(res[0])
            continue
        for x in range(w):
            W = int(data[y, x - 1]) if x > 0 else int(data[y - 1, x])
            N = int(data[y - 1, x])
            NW = int(data[y - 1, x - 1]) if x > 0 else W
            data[y, x] = clamped_gradient(N, W, NW) + res[y, x]


def _unpack_signed_np(u: np.ndarray) -> np.ndarray:
    return np.where(u & 1, -((u + 1) >> 1), u >> 1)


def _pack_signed_np(v: np.ndarray) -> np.ndarray:
    return np.where(v < 0, (-v << 1) - 1, v << 1)


# --------------------------------------------------------------------------
# Channel plane encode (mirror)

def encode_channel(ts: TokenStream, tree: Tree, chan: Channel,
                   chan_index: int, stream_id: int,
                   prev_channels: List[np.ndarray],
                   wp_params: WPParams) -> None:
    w, h = chan.width, chan.height
    if w == 0 or h == 0:
        return
    data = chan.data
    if len(tree.nodes) == 1 and tree.nodes[0].predictor in (0, 1, 2, 3, 5):
        _encode_single_leaf(ts, tree.nodes[0], data, w, h)
        return
    from .learn import encode_channel_tree, PREDICTORS, NUM_PROPS
    if (tree.max_property < NUM_PROPS and not tree.uses_weighted()
            and all((n.predictor in PREDICTORS and n.offset == 0
                     and n.multiplier == 1) for n in tree.nodes
                    if n.is_leaf)):
        # learned-tree fast path: static properties + simple predictors
        # are closed-form in the (known) channel data -> vectorized
        encode_channel_tree(ts, tree, chan, chan_index, stream_id)
        return
    need_wp = tree.uses_weighted()
    wp = WPState(wp_params, w) if need_wp else None
    max_prop = tree.max_property
    eligible_prev = [p for (p, hs, vs) in prev_channels
                     if p.shape == (h, w)
                     and hs == chan.hshift and vs == chan.vshift]
    from .. import native as native_mod
    toks = native_mod.encode_channel_tokens(
        tree, data, chan_index, stream_id, wp_params,
        eligible_prev, need_wp, max_prop)
    if toks is not None:
        ctxs, vals = toks
        ts.add_arrays(ctxs, vals)
        return
    for y in range(h):
        if wp is not None and y > 0:
            wp.new_row()
        prev_grad = 0
        for x in range(w):
            W, N, NW, NE, NN, WW, NEE = neighbors(data, x, y, w)
            wp_pred = None
            wp_prop = 0
            if wp is not None:
                wp_pred = wp.predict(x, y, w, W, N, NW, NE, NN)
                wp_prop = wp.prop
            if max_prop >= 0:
                props = properties_for_pixel(
                    chan_index, stream_id, x, y, W, N, NW, NE, NN, WW,
                    wp_prop, eligible_prev, prev_grad)
                prev_grad = props[9]
                leaf = tree.lookup(props)
            else:
                leaf = tree.nodes[0]
            pred = predict(leaf.predictor, W, N, NW, NE, NN, WW, NEE,
                           wp_pred)
            diff = int(data[y, x]) - pred - leaf.offset
            if diff % leaf.multiplier != 0:
                raise ValueError("value not representable with multiplier")
            ts.add(leaf.ctx, pack_signed(diff // leaf.multiplier))
            if wp is not None:
                wp.update(x, int(data[y, x]))


def _encode_single_leaf(ts: TokenStream, leaf, data, w, h) -> None:
    data64 = data.astype(np.int64)
    p = leaf.predictor
    pred = np.zeros((h, w), np.int64)
    if p == 0:
        pass
    elif p == 1:
        pred[:, 1:] = data64[:, :-1]
        pred[1:, 0] = data64[:-1, 0]
    elif p == 2:
        pred[1:, :] = data64[:-1, :]
        pred[0, 1:] = data64[0, :-1]
    elif p == 3:
        W = np.zeros((h, w), np.int64)
        W[:, 1:] = data64[:, :-1]
        W[1:, 0] = data64[:-1, 0]
        N = np.zeros((h, w), np.int64)
        N[1:] = data64[:-1]
        N[0] = W[0]
        s_ = W + N
        pred = np.sign(s_) * (np.abs(s_) >> 1)  # trunc toward zero
    elif p == 5:
        W = np.zeros((h, w), np.int64)
        W[:, 1:] = data64[:, :-1]
        W[1:, 0] = data64[:-1, 0]
        N = np.zeros((h, w), np.int64)
        N[1:] = data64[:-1]
        N[0] = W[0]
        NW = np.zeros((h, w), np.int64)
        NW[1:, 1:] = data64[:-1, :-1]
        NW[:, 0] = W[:, 0]
        NW[0, 1:] = W[0, 1:]
        m = np.minimum(N, W)
        M = np.maximum(N, W)
        grad = N + W - NW
        pred = np.where(NW > M, m, np.where(NW < m, M, grad))
    res = data64 - pred - leaf.offset
    if leaf.multiplier != 1:
        if np.any(res % leaf.multiplier):
            raise ValueError("residuals not divisible by multiplier")
        res //= leaf.multiplier
    tokens = _pack_signed_np(res.reshape(-1))
    ctx = leaf.ctx
    add = ts.add
    for t in tokens:
        add(ctx, int(t))


# --------------------------------------------------------------------------
# Stream-level decode/encode

def decode_modular_stream(br: BitReader, image: ModularImage,
                          stream_id: int = 0,
                          global_tree: Optional[Tree] = None,
                          global_code=None,
                          tree_size_limit: int = 1 << 22,
                          channel_range=None,
                          max_chan_size: Optional[int] = None) -> GroupHeader:
    """Decode header + (local tree) + channel planes for `image`.

    channel_range: optional (start, end) restricting which channels (after
    meta transforms) this stream carries (group streams).
    max_chan_size: stop (break) at the first non-meta channel wider/taller
    than this (the global-stream partial-decode rule); the index where
    decoding stopped is stored on the returned header as `.stopped_at`.
    """
    header = GroupHeader.read(br)
    apply_meta_transforms(image, header)
    if header.use_global_tree:
        if global_tree is None:
            raise BitstreamError("stream requires global tree")
        tree = global_tree
        dec = EntropyDecoder(br, code=global_code) if global_code is not None \
            else EntropyDecoder(br, tree.num_leaves)
    else:
        tree = decode_tree(br, tree_size_limit)
        dec = EntropyDecoder(br, tree.num_leaves)
    chans = image.channels
    start, end = channel_range or (0, len(chans))

    # native fast path: reference-exact C++ port of the channel decode
    # (prefix AND ANS entropy, exact weighted predictor, full property
    # vector including running gradient and 4-per-prev-channel props).
    # LZ77 with a distance multiplier stays in Python.
    native = None
    if not (dec.lz77.enabled and dec.dist_multiplier):
        from .. import native as native_mod
        native = native_mod.NativeEntropy(dec, br)
    decoded_planes: List[np.ndarray] = []
    header.stopped_at = end

    def _stop(ci, chan):
        return (max_chan_size is not None
                and ci >= image.nb_meta_channels
                and (chan.width > max_chan_size
                     or chan.height > max_chan_size))

    if native is not None:
        use_wp = tree.uses_weighted()
        max_prop = tree.max_property
        for ci in range(start, end):
            chan = chans[ci]
            if _stop(ci, chan):
                header.stopped_at = ci
                break
            chan.alloc()
            if chan.width == 0 or chan.height == 0:
                continue
            same_shape = [p for (p, hs, vs) in decoded_planes
                          if p.shape == (chan.height, chan.width)
                          and hs == chan.hshift and vs == chan.vshift]
            native.decode_channel(tree, chan.data, ci, stream_id,
                                  header.wp_params, same_shape, max_prop,
                                  use_wp)
            decoded_planes.insert(
                0, (chan.data, chan.hshift, chan.vshift))
        native.sync_back(dec, br)
        native.close()
        if not dec.check_final_state():
            raise BitstreamError("modular stream ANS checksum failed")
        return header

    for ci in range(start, end):
        chan = chans[ci]
        if _stop(ci, chan):
            header.stopped_at = ci
            break
        decode_channel(dec, tree, chan, ci, stream_id, decoded_planes,
                       header.wp_params)
        if chan.width and chan.height:
            decoded_planes.insert(
                0, (chan.data, chan.hshift, chan.vshift))
    if not dec.check_final_state():
        raise BitstreamError("modular stream ANS checksum failed")
    return header


def encode_modular_stream(bw: BitWriter, image: ModularImage,
                          header: GroupHeader, tree: Tree,
                          stream_id: int = 0,
                          channel_range=None, lz77: bool = False) -> None:
    """Encode header + local tree + channels (image must already be in
    transformed/compressed representation)."""
    header.write(bw)
    if not header.use_global_tree:
        encode_tree(bw, tree)
    ts = TokenStream(tree.num_leaves, lz77=lz77, use_ans=not lz77)
    chans = image.channels
    start, end = channel_range or (0, len(chans))
    planes: List[np.ndarray] = []
    for ci in range(start, end):
        chan = chans[ci]
        encode_channel(ts, tree, chan, ci, stream_id, planes,
                       header.wp_params)
        if chan.width and chan.height:
            planes.insert(0, (chan.data, chan.hshift, chan.vshift))
    ts.write(bw)
