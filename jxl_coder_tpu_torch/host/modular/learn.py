"""MA-tree learning + vectorized tree-based channel encoding.

The reference's codec (libjxl, shipped as a prebuilt .so — SURVEY.md
§2.5) learns per-stream meta-adaptive context trees at encode time
(enc_ma semantics): a greedy top-down split search over the §H.4
property vector, choosing the best (property, splitval, predictor)
triple by estimated token entropy.  This module is our encoder-side
equivalent, fully vectorized with numpy:

- every property plane and candidate-predictor residual plane is a
  closed-form function of the channel data (encoding has no sequential
  dependence, unlike decoding), so learning and encoding are batched
  array ops;
- split search buckets each property into quantiles and scores all
  thresholds with cumulative histogram entropies in one pass.

Predictors considered: 0 zero, 1 W, 2 N, 3 (W+N)/2, 5 clamped
gradient.  Properties considered: 0..14 (§H.4 static + neighbor
props; the WP property 15 needs the sequential WP state and is
excluded).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .tree import Node, Tree
from .image import Channel

PREDICTORS = (0, 1, 2, 3, 5)
NUM_PROPS = 15

# hybrid-uint (4, 4, 0): the modular token config our writer uses
_SPLIT_EXP, _MSB = 4, 4


def _neighbor_planes(D: np.ndarray):
    """W/N/NW/NE/NN/WW planes with the spec edge rules
    (predict.neighbors), vectorized."""
    h, w = D.shape
    Wp = np.zeros((h, w), np.int64)
    Wp[:, 1:] = D[:, :-1]
    if h > 1:
        Wp[1:, 0] = D[:-1, 0]
    N = np.zeros((h, w), np.int64)
    N[1:] = D[:-1]
    N[0] = Wp[0]
    NW = np.zeros((h, w), np.int64)
    NW[1:, 1:] = D[:-1, :-1]
    NW[:, 0] = Wp[:, 0]
    NW[0, :] = Wp[0, :]
    NE = np.zeros((h, w), np.int64)
    NE[1:, :-1] = D[:-1, 1:]
    NE[:, -1] = N[:, -1]
    NE[0, :] = N[0, :]
    NN = np.zeros((h, w), np.int64)
    NN[2:] = D[:-2]
    NN[:2] = N[:2]
    WW = np.zeros((h, w), np.int64)
    WW[:, 2:] = D[:, :-2]
    WW[:, :2] = Wp[:, :2]
    return Wp, N, NW, NE, NN, WW


def _clamped_gradient(N, Wp, NW):
    m = np.minimum(N, Wp)
    M = np.maximum(N, Wp)
    grad = N + Wp - NW
    return np.where(NW > M, m, np.where(NW < m, M, grad))


def predictor_planes(D: np.ndarray) -> Dict[int, np.ndarray]:
    Wp, N, NW, _, _, _ = _neighbor_planes(D)
    s = Wp + N
    avg = np.sign(s) * (np.abs(s) >> 1)
    return {0: np.zeros_like(Wp), 1: Wp, 2: N, 3: avg,
            5: _clamped_gradient(N, Wp, NW)}


def property_planes(D: np.ndarray, chan_index: int,
                    stream_id: int) -> np.ndarray:
    """(NUM_PROPS, h*w) int64 — §H.4 properties 0..14."""
    h, w = D.shape
    Wp, N, NW, NE, NN, WW = _neighbor_planes(D)
    grad9 = Wp + N - NW
    prev9 = np.zeros((h, w), np.int64)
    prev9[:, 1:] = grad9[:, :-1]
    yy, xx = np.mgrid[0:h, 0:w]
    props = np.stack([
        np.full((h, w), chan_index, np.int64),
        np.full((h, w), stream_id, np.int64),
        yy.astype(np.int64), xx.astype(np.int64),
        np.abs(N), np.abs(Wp), N, Wp,
        Wp - prev9, grad9,
        Wp - NW, NW - N, N - NE, N - NN, Wp - WW,
    ])
    return props.reshape(NUM_PROPS, h * w)


def _pack_signed_np(v: np.ndarray) -> np.ndarray:
    return np.where(v < 0, (-v << 1) - 1, v << 1).astype(np.uint64)


def _token_ids(vals: np.ndarray) -> np.ndarray:
    """Hybrid-uint(4,4,0) token id per packed value (raw-bit count is
    token-determined)."""
    u = vals.astype(np.uint64)
    small = u < 16
    big = np.maximum(u, 1)
    n = np.frexp(big.astype(np.float64))[1] - 1  # bit_length - 1 (safe <2^52)
    n = n.astype(np.int64)
    msb_payload = (u >> np.maximum(n - _MSB, 0).astype(np.uint64)) & 0xF
    tok = 16 + ((n - _SPLIT_EXP) << _MSB) + msb_payload.astype(np.int64)
    return np.where(small, u.astype(np.int64), tok)


def _raw_bits_of_token(T: int) -> np.ndarray:
    """Raw (extra) bit count per token id for config (4,4,0)."""
    t = np.arange(T)
    n = _SPLIT_EXP + ((t - 16) >> _MSB)
    return np.where(t < 16, 0, n - _MSB)


def _cost_bits(hist: np.ndarray, rb: np.ndarray) -> float:
    """Entropy-coded size estimate (bits) of a token multiset."""
    n = hist.sum()
    if n == 0:
        return 0.0
    nz = hist[hist > 0]
    ent = float(n) * np.log2(float(n)) - float(nz @ np.log2(nz))
    return ent + float(hist @ rb)


class _LearnData:
    """Flattened training arrays over all channels of one stream."""

    def __init__(self, props: np.ndarray, tokens: np.ndarray,
                 max_token: int, pred_ids: Sequence[int]):
        self.props = props      # (n_props, n)
        self.tokens = tokens    # (P, n) int32 token ids per predictor
        self.pred_ids = list(pred_ids)
        self.T = max_token + 1
        self.rb = _raw_bits_of_token(self.T).astype(np.float64)


def wp_planes(D: np.ndarray):
    """Sequential weighted-predictor pass over known data, in native
    C++: returns the WP prediction plane and the property-15 plane."""
    import ctypes
    from .predict import WPParams
    h, w = D.shape
    if h == 0 or w == 0:
        return np.zeros((h, w), np.int64), np.zeros((h, w), np.int64)
    from .. import native as native_mod
    lib = native_mod.get_lib()
    p = WPParams()
    wp_a = np.asarray([p.p1, p.p2, p.p3a, p.p3b, p.p3c, p.p3d,
                       p.p3e, p.w0, p.w1, p.w2, p.w3], np.int32)
    D64 = np.ascontiguousarray(D, np.int64)
    pred = np.empty((h, w), np.int64)
    prop = np.empty((h, w), np.int64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.wp_forward(
        D64.ctypes.data_as(i64p), w, h,
        wp_a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        pred.ctypes.data_as(i64p), prop.ctypes.data_as(i64p))
    return pred, prop


def _gather_data(channels: Sequence[Channel], stream_id: int,
                 max_samples: int,
                 use_wp: bool = False) -> Optional[_LearnData]:
    props_l, toks_l = [], []
    for ci, ch in enumerate(channels):
        if ch.width == 0 or ch.height == 0:
            continue
        D = ch.data.astype(np.int64)
        pr = property_planes(D, ci, stream_id)
        preds = predictor_planes(D)
        pred_ids = list(PREDICTORS)
        if use_wp:
            wp_pred, wp_prop = wp_planes(D)
            preds = dict(preds)
            preds[6] = wp_pred
            pred_ids = pred_ids + [6]
            pr = np.concatenate(
                [pr, wp_prop.reshape(1, -1)], axis=0)
        props_l.append(pr)
        toks_l.append(np.stack([
            _token_ids(_pack_signed_np((D - preds[p]).reshape(-1)))
            for p in pred_ids]))
    if not props_l:
        return None
    props = np.concatenate(props_l, axis=1)
    tokens = np.concatenate(toks_l, axis=1).astype(np.int32)
    n = props.shape[1]
    if n > max_samples:
        sel = np.random.default_rng(0).choice(n, max_samples,
                                              replace=False)
        props, tokens = props[:, sel], tokens[:, sel]
    return _LearnData(props, tokens, int(tokens.max()),
                      PREDICTORS + (6,) if use_wp else PREDICTORS)


def _split_costs(data, idx, bucket, B, T, P, _ent, toks=None):
    """costs[p][j] = ent(buckets<=j) + ent(buckets>j) per predictor, in
    native C++.  toks: optional pre-subset data.tokens[:, idx] (hoisted
    by the caller across the property loop — idx is per-node)."""
    import ctypes
    from .. import native as native_mod
    lib = native_mod.get_lib()
    if toks is None:
        toks = np.ascontiguousarray(data.tokens[:, idx], np.int32)
    buck = np.ascontiguousarray(bucket, np.int32)
    out = np.empty((P, B - 1), np.float64)
    dp = ctypes.POINTER(ctypes.c_double)
    lib.ma_split_costs(
        toks.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        P, toks.shape[1],
        buck.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        B, T, data.rb.ctypes.data_as(dp),
        out.ctypes.data_as(dp))
    return out


class _TmpNode:
    __slots__ = ("prop", "splitval", "left", "right", "predictor")

    def __init__(self, predictor=5, prop=-1, splitval=0,
                 left=None, right=None):
        self.prop, self.splitval = prop, splitval
        self.left, self.right = left, right
        self.predictor = predictor


def _best_split_native(data, toks_sub, props_sub, props_allowed,
                       n_buckets):
    """Whole-node split search in C++ (hostcodec.cpp
    ma_best_split_native): per allowed property, quantile thresholds +
    bucketize + split-cost scan + argmin in ONE call.  Returns
    (cost (K,), splitval (K,)) or None; the numpy loop in _learn_node
    stays the oracle (tests cross-check trees end to end)."""
    from .. import native as native_mod
    lib = native_mod.get_lib()
    import ctypes
    pa = np.asarray(list(props_allowed), np.int32)
    props_arr = props_sub[pa]
    if props_arr.size and (props_arr.max() > 2**31 - 1
                           or props_arr.min() < -2**31):
        return None
    props32 = np.ascontiguousarray(props_arr, np.int32)
    K = len(pa)
    P, n = toks_sub.shape
    out_cost = np.empty(K, np.float64)
    out_split = np.empty(K, np.int32)
    i32p = ctypes.POINTER(ctypes.c_int32)
    dp = ctypes.POINTER(ctypes.c_double)
    lib.ma_best_split_native(
        toks_sub.ctypes.data_as(i32p), P, n,
        props32.ctypes.data_as(i32p), pa.ctypes.data_as(i32p),
        K, n_buckets, data.T, data.rb.ctypes.data_as(dp),
        out_cost.ctypes.data_as(dp), out_split.ctypes.data_as(i32p))
    return out_cost, out_split


def _best_leaf(data: _LearnData, idx: np.ndarray) -> Tuple[int, float]:
    best_p, best_c = 0, np.inf
    for pi, p in enumerate(data.pred_ids):
        hist = np.bincount(data.tokens[pi, idx], minlength=data.T)
        c = _cost_bits(hist, data.rb)
        if c < best_c:
            best_p, best_c = p, c
    return best_p, best_c


def _learn_node(data: _LearnData, idx: np.ndarray, leaves_left: List[int],
                split_penalty: float, props_allowed: Sequence[int],
                n_buckets: int = 16):
    # n_buckets=16 halves the split-search cost vs 32 for a measured
    # +0.13% lossless / +-0 lossy rate on the photo probes
    pred, leaf_cost = _best_leaf(data, idx)
    node = _TmpNode(predictor=pred)
    if leaves_left[0] < 2 or len(idx) < 64:
        return node
    T = data.T

    def _ent(M):
        n = M.sum(1, dtype=np.float64)
        x = M.astype(np.float64)
        with np.errstate(divide="ignore", invalid="ignore"):
            xl = np.where(x > 0, x * np.log2(x), 0.0)
        nl = np.where(n > 0, n * np.log2(np.maximum(n, 1)), 0.0)
        return nl - xl.sum(1) + M @ data.rb

    best = (None, leaf_cost - split_penalty)
    toks_sub = np.ascontiguousarray(data.tokens[:, idx], np.int32)
    props_sub = data.props[:, idx]
    nat = _best_split_native(data, toks_sub, props_sub, props_allowed,
                             n_buckets)
    if nat is not None:
        cost_k, split_k = nat
        for ki, k in enumerate(props_allowed):
            if cost_k[ki] < best[1]:
                best = ((k, int(split_k[ki])), float(cost_k[ki]))
        if best[0] is None:
            return node
        k, splitval = best[0]
        node.prop, node.splitval = k, splitval
        node.predictor = -1
        leaves_left[0] -= 1
        lmask = data.props[k, idx] > splitval
        node.left = _learn_node(data, idx[lmask], leaves_left,
                                split_penalty, props_allowed, n_buckets)
        node.right = _learn_node(data, idx[~lmask], leaves_left,
                                 split_penalty, props_allowed,
                                 n_buckets)
        return node
    # one sort for ALL properties; sorted[round(q*(n-1))] is exactly
    # np.quantile(method="nearest") and avoids 16 partition calls/node
    sorted_props = np.sort(props_sub, axis=1)
    qidx = np.round(np.linspace(0.02, 0.98, n_buckets)
                    * (len(idx) - 1)).astype(np.intp)
    for k in props_allowed:
        pv = props_sub[k]
        sp = sorted_props[k]
        if sp[0] == sp[-1]:
            continue
        sv = np.unique(sp[qidx].astype(np.int64))
        # bucket b = #{j: sv[j] < v}; split j keeps LEFT = (v > sv[j])
        # = (b > j), so the cumulative histogram over buckets 0..j is
        # the RIGHT side
        bucket = np.searchsorted(sv, pv, side="left").astype(np.int64)
        B = len(sv) + 1
        P = len(data.pred_ids)
        costs = _split_costs(data, idx, bucket, B, T, P, _ent,
                             toks=toks_sub)
        pj = np.unravel_index(int(np.argmin(costs)), costs.shape)
        if costs[pj] < best[1]:
            best = ((k, int(sv[pj[1]])), float(costs[pj]))
    if best[0] is None:
        return node
    k, splitval = best[0]
    node.prop, node.splitval = k, splitval
    node.predictor = -1
    leaves_left[0] -= 1          # one pending leaf becomes two
    lmask = data.props[k, idx] > splitval
    node.left = _learn_node(data, idx[lmask], leaves_left, split_penalty,
                            props_allowed, n_buckets)
    node.right = _learn_node(data, idx[~lmask], leaves_left,
                             split_penalty, props_allowed, n_buckets)
    return node


def learn_tree(channels: Sequence[Channel], stream_id: int = 0,
               max_leaves: int = 12, max_samples: int = 1 << 16,
               split_penalty: float = 160.0,
               props_allowed: Optional[Sequence[int]] = None,
               use_wp: bool = False) -> Tree:
    """Greedy MA-tree for the given channels; falls back to a gradient
    single leaf when there is nothing to learn.  use_wp adds the
    weighted predictor and property 15 (sequential state: costs a
    Python pass at learn AND encode time — small channels only)."""
    data = _gather_data(channels, stream_id, max_samples, use_wp=use_wp)
    if data is None or data.props.shape[1] < 64:
        return Tree([Node(property=-1, predictor=5, ctx=0)])
    if props_allowed is None:
        props_allowed = list(range(NUM_PROPS))
    if use_wp and 15 not in props_allowed:
        props_allowed = list(props_allowed) + [15]
    root = _learn_node(data, np.arange(data.props.shape[1]),
                       [max_leaves], split_penalty, props_allowed)
    # BFS linearization matching decode_tree's indexing
    nodes: List[Node] = []
    queue = [root]
    leaf_ctx = 0
    while queue:
        t = queue.pop(0)
        if t.prop < 0:
            nodes.append(Node(property=-1, predictor=t.predictor,
                              ctx=leaf_ctx))
            leaf_ctx += 1
        else:
            left_pos = len(nodes) + len(queue) + 1
            nodes.append(Node(property=t.prop, splitval=t.splitval,
                              left=left_pos, right=left_pos + 1))
            queue.append(t.left)
            queue.append(t.right)
    return Tree(nodes)


def leaf_assignment(tree: Tree, D: np.ndarray, chan_index: int,
                    stream_id: int):
    """Vectorized tree evaluation: (ctx plane, predictor plane) for a
    channel, for trees over properties 0..14 and simple predictors."""
    h, w = D.shape
    props = property_planes(D.astype(np.int64), chan_index, stream_id)
    n = h * w
    nodes = tree.nodes
    prop_a = np.asarray([nd.property for nd in nodes])
    split_a = np.asarray([nd.splitval for nd in nodes])
    left_a = np.asarray([nd.left for nd in nodes])
    right_a = np.asarray([nd.right for nd in nodes])
    ctx_a = np.asarray([nd.ctx for nd in nodes])
    pred_a = np.asarray([nd.predictor for nd in nodes])
    node_of = np.zeros(n, np.int64)
    while True:
        cur_prop = prop_a[node_of]
        active = cur_prop >= 0
        if not active.any():
            break
        ai = np.nonzero(active)[0]
        ids = node_of[ai]
        vals = props[prop_a[ids], ai]
        node_of[ai] = np.where(vals > split_a[ids], left_a[ids],
                               right_a[ids])
    ctx = ctx_a[node_of].reshape(h, w)
    pred_id = pred_a[node_of].reshape(h, w)
    return ctx, pred_id


def encode_channel_tree(ts, tree: Tree, chan: Channel, chan_index: int,
                        stream_id: int) -> None:
    """Vectorized encode of one channel under a learned tree (simple
    predictors only, offset 0, multiplier 1)."""
    D = chan.data.astype(np.int64)
    ctx, pred_id = leaf_assignment(tree, D, chan_index, stream_id)
    preds = predictor_planes(D)
    pred = np.zeros_like(D)
    for p in PREDICTORS:
        m = pred_id == p
        if m.any():
            pred[m] = preds[p][m]
    toks = _pack_signed_np((D - pred).reshape(-1))
    cflat = ctx.reshape(-1)
    add = ts.add
    for c, t in zip(cflat.tolist(), toks.tolist()):
        add(int(c), int(t))
