"""Unified entropy stream layer (ISO/IEC 18181-1 §C): clustered histograms,
hybrid-uint tokens, LZ77, over rANS or prefix-code backends.

Mirrors what libjxl's dec_ans/enc_ans provide to every subsystem (modular
trees, coefficients, context maps, TOC permutations...).  The reference
exercises this through every decode call
(jxl-coder: jxlcoder/src/main/cpp/interop/JxlDecoding.cpp:74-175).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

from ..bitstream.reader import BitReader, BitstreamError
from ..bitstream.writer import BitWriter
from .prefix import PrefixCode, read_prefix_code, write_prefix_code, \
    build_code_lengths, ceil_log2
from . import ans as _ans
from .ans import AliasTable, AnsState, AnsEncoder, ANS_TAB_SIZE


# --------------------------------------------------------------------------
# Hybrid uint config

@dataclasses.dataclass(frozen=True)
class HybridUintConfig:
    split_exponent: int = 4
    msb_in_token: int = 4
    lsb_in_token: int = 0

    @property
    def split(self) -> int:
        return 1 << self.split_exponent

    @staticmethod
    def read(br: BitReader, log_alphabet_size: int) -> "HybridUintConfig":
        split_exponent = br.u(ceil_log2(log_alphabet_size + 1))
        if split_exponent == log_alphabet_size:
            return HybridUintConfig(split_exponent, 0, 0)
        msb = br.u(ceil_log2(split_exponent + 1))
        lsb = br.u(ceil_log2(split_exponent - msb + 1))
        return HybridUintConfig(split_exponent, msb, lsb)

    def write(self, bw: BitWriter, log_alphabet_size: int) -> None:
        bw.u(self.split_exponent, ceil_log2(log_alphabet_size + 1))
        if self.split_exponent == log_alphabet_size:
            return
        bw.u(self.msb_in_token, ceil_log2(self.split_exponent + 1))
        bw.u(self.lsb_in_token,
             ceil_log2(self.split_exponent - self.msb_in_token + 1))

    def read_value(self, token: int, br: BitReader) -> int:
        if token < self.split:
            return token
        msb, lsb = self.msb_in_token, self.lsb_in_token
        n = self.split_exponent - (msb + lsb) + ((token - self.split)
                                                 >> (msb + lsb))
        if n >= 32:
            raise BitstreamError("hybrid uint too large")
        low = token & ((1 << lsb) - 1)
        token >>= lsb
        msbits = (token & ((1 << msb) - 1)) | (1 << msb)
        return ((((msbits << n) | br.u(n)) << lsb) | low)

    def tokenize_vec(self, values):
        """Vectorized token ids for an int array (histogram passes)."""
        return _tokenize_values_vec(self, values)

    def tokenize(self, value: int):
        """value -> (token, extra_bits_value, extra_bits_count)."""
        if value < self.split:
            return value, 0, 0
        msb, lsb = self.msb_in_token, self.lsb_in_token
        n = value.bit_length() - 1  # position of leading 1
        # token layout: split + (((n - split_exponent + msb + lsb) << (msb+lsb))
        #   | msb payload | lsb payload)
        nbits = n - msb - lsb  # bits sent raw
        token = (self.split
                 + (((n - self.split_exponent) << (msb + lsb))
                    | (((value >> (n - msb)) & ((1 << msb) - 1)) << lsb)
                    | (value & ((1 << lsb) - 1))))
        extra = (value >> lsb) & ((1 << nbits) - 1)
        return token, extra, nbits


def _tokenize_values_vec(config, values):
    """Vectorized HybridUintConfig.tokenize token ids (no extras)."""
    import numpy as np
    v = np.asarray(values, np.int64)
    split = config.split
    msb, lsb = config.msb_in_token, config.lsb_in_token
    small = v < split
    # bit_length - 1 via frexp (exact for |v| < 2^53)
    n = np.frexp(np.maximum(v, 1).astype(np.float64))[1].astype(
        np.int64) - 1
    sh = np.maximum(n - msb, 0)
    tok = (split + (((n - config.split_exponent) << (msb + lsb))
                    | (((v >> sh) & ((1 << msb) - 1)) << lsb)
                    | (v & ((1 << lsb) - 1))))
    return np.where(small, v, tok)


# --------------------------------------------------------------------------
# LZ77 params + special distances

@dataclasses.dataclass
class Lz77Params:
    enabled: bool = False
    min_symbol: int = 224
    min_length: int = 3
    length_config: HybridUintConfig = HybridUintConfig(4, 0, 0)

    @staticmethod
    def read(br: BitReader) -> "Lz77Params":
        """No all_default bit: LZ77Params::VisitFields starts with a plain
        Bool(false, &enabled), so disabled is a single 0 bit.  The length
        config is not part of the bundle; it follows only when enabled
        (read by DecodeHistograms)."""
        p = Lz77Params()
        p.enabled = br.bool()
        if not p.enabled:
            return p
        p.min_symbol = br.u32(224, 512, 4096, (15, 8))
        p.min_length = br.u32(3, 4, (2, 5), (8, 9))
        p.length_config = HybridUintConfig.read(br, 8)
        return p

    def write(self, bw: BitWriter) -> None:
        bw.bool(self.enabled)
        if not self.enabled:
            return
        bw.u32(self.min_symbol, 224, 512, 4096, (15, 8))
        bw.u32(self.min_length, 3, 4, (2, 5), (8, 9))
        self.length_config.write(bw, 8)


# --------------------------------------------------------------------------
# Cluster map

def read_cluster_map(br: BitReader, num_contexts: int) -> List[int]:
    if num_contexts == 1:
        return [0]
    if br.bool():  # 1 => simple (polarity verified against libjxl)
        nbits = br.u(2)
        cmap = [br.u(nbits) for _ in range(num_contexts)]
    else:
        use_mtf = br.bool()
        nested = EntropyDecoder(br, 1)
        cmap = [nested.read(0) for _ in range(num_contexts)]
        if not nested.check_final_state():
            raise BitstreamError("cluster map ANS checksum failed")
        if use_mtf:
            mtf = list(range(256))
            for i, v in enumerate(cmap):
                if v >= 256:
                    raise BitstreamError("mtf index too large")
                val = mtf[v]
                cmap[i] = val
                mtf.pop(v)
                mtf.insert(0, val)
    num_clusters = max(cmap) + 1
    if sorted(set(cmap)) != list(range(num_clusters)):
        raise BitstreamError("cluster map not dense")
    return cmap


def _write_cluster_map_complex(bw: BitWriter, cmap: List[int]) -> None:
    # complex form: move-to-front transformed ids in a nested
    # single-context entropy stream (the inverse of read_cluster_map).
    # After MTF the map is dominated by runs of 0: distance-1 LZ77
    # (RLE) beats the 1-bit/symbol prefix floor by ~10x on big maps.
    bw.bool(False)
    bw.bool(True)   # use_mtf
    mtf = list(range(256))
    ids = []
    for v in cmap:
        j = mtf.index(v)
        ids.append(j)
        mtf.pop(j)
        mtf.insert(0, v)
    nested = TokenStream(1, lz77=True)
    for j in ids:
        nested.add(0, j)
    nested.write(bw)


def write_cluster_map(bw: BitWriter, cmap: List[int]) -> None:
    if len(cmap) == 1:
        return
    num_clusters = max(cmap) + 1
    simple_bits = None
    if num_clusters <= 8:
        nbits = max(v.bit_length() for v in cmap)
        simple_bits = 3 + nbits * len(cmap)
        if len(cmap) <= 64:
            # small map: simple form; never recurse (the complex
            # form's nested LZ77 stream writes a cluster map itself)
            bw.bool(True)
            bw.u(nbits, 2)
            for v in cmap:
                bw.u(v, nbits)
            return
    probe = BitWriter()
    _write_cluster_map_complex(probe, cmap)
    if simple_bits is not None and simple_bits <= probe.bit_pos:
        bw.bool(True)  # simple
        bw.u(nbits, 2)
        for v in cmap:
            bw.u(v, nbits)
        return
    bw.append_writer(probe)


def _hist_cost(h: dict) -> float:
    """Shannon cost (bits) of coding h with its own distribution."""
    import math
    total = sum(h.values())
    if total == 0:
        return 0.0
    return sum(-c * math.log2(c / total) for c in h.values() if c)


def cluster_histograms(hists: List[dict], max_clusters: int = 24):
    """Vectorized front door: dense-array clustering (same algorithm,
    costs and tie order as the dict implementation below; float
    summation order differs, so near-tie decisions may pick a
    different — equally valid — clustering).  Falls back to the dict
    path for huge alphabets."""
    import numpy as np
    maxsym = 0
    for h in hists:
        if h:
            m = max(h)
            if m > maxsym:
                maxsym = m
    if maxsym > 4096:
        return _cluster_histograms_dict(hists, max_clusters)
    n = len(hists)
    T = maxsym + 1
    H = np.zeros((n, T), np.float64)
    for i, h in enumerate(hists):
        for sym, c in h.items():
            H[i, sym] = c
    res = _cluster_histograms_native(H, max_clusters)
    if res is not None:
        return res
    totals = H.sum(1)

    def cost_rows(M):
        tot = M.sum(1)
        with np.errstate(divide="ignore", invalid="ignore"):
            xl = np.where(M > 0, M * np.log2(np.where(M > 0, M, 1.0)),
                          0.0).sum(1)
        tl = np.where(tot > 0,
                      tot * np.log2(np.where(tot > 0, tot, 1.0)), 0.0)
        return tl - xl

    selfc = cost_rows(H)
    order = np.argsort(-totals, kind="stable")
    S = np.zeros((max_clusters, T), np.float64)
    seed_cost = np.zeros(max_clusters)
    k = 0
    assign = [0] * n
    for i in order:
        i = int(i)
        if totals[i] == 0:
            continue
        if k:
            extra = cost_rows(S[:k] + H[i]) - seed_cost[:k] - selfc[i]
            best = int(np.argmin(extra))
            bestc = float(extra[best])
        else:
            best, bestc = -1, float("inf")
        if (best < 0 or bestc > 60.0) and k < max_clusters:
            S[k] = H[i]
            seed_cost[k] = selfc[i]
            assign[i] = k
            k += 1
        else:
            assign[i] = best
            S[best] += H[i]
            seed_cost[best] = float(cost_rows(S[best:best + 1])[0])
    if k == 0:
        return [0] * n, 1

    def hist_bits_row(row):
        nz = np.nonzero(row)[0]
        if not len(nz):
            return 0.0
        maxs = int(nz[-1])
        if maxs > 255:
            return 6.0 * len(nz) + 40.0
        counts = _ans.normalize_counts(
            row[:maxs + 1].astype(np.int64).tolist())
        return _ans.estimate_ans_distribution_bits(
            counts, num_tokens=int(row.sum()))

    groups = [S[ci].copy() for ci in range(k)]
    bits = [hist_bits_row(g) for g in groups]
    cost = [float(cost_rows(g[None])[0]) for g in groups]
    remap = list(range(k))
    alive = [True] * k
    pair_cache = {}

    def pair_delta(i, j):
        key = (i, j) if i < j else (j, i)
        e = pair_cache.get(key)
        if e is None:
            m = groups[i] + groups[j]
            delta = (float(cost_rows(m[None])[0]) - cost[i] - cost[j])                 - (bits[i] + bits[j] - hist_bits_row(m))
            e = (delta, m)
            pair_cache[key] = e
        return e

    while sum(alive) > 1:
        best = (0.0, None)
        live = [i for i in range(k) if alive[i]]
        for ai in range(len(live)):
            for bi in range(ai + 1, len(live)):
                i, j = live[ai], live[bi]
                delta, m = pair_delta(i, j)
                if delta < best[0]:
                    best = (delta, (i, j, m))
        if best[1] is None:
            break
        i, j, m = best[1]
        groups[i] = m
        bits[i] = hist_bits_row(m)
        cost[i] = float(cost_rows(m[None])[0])
        alive[j] = False
        pair_cache = {kk: v for kk, v in pair_cache.items()
                      if i not in kk and j not in kk}
        for t in range(len(remap)):
            if remap[t] == j:
                remap[t] = i
    dense = {}
    out = [0] * n
    for ci in range(n):
        g = remap[assign[ci]]
        if g not in dense:
            dense[g] = len(dense)
        out[ci] = dense[g]
    return out, len(dense)


def _cluster_histograms_native(H, max_clusters: int):
    """C++ clustering (native/hostcodec.cpp cluster_histograms_native):
    same algorithm, costs and tie order as the paths below.  Returns
    (cluster_map, num_clusters) or None when it finds no clusters."""
    import ctypes
    import numpy as np
    from .. import native as native_mod
    lib = native_mod.get_lib()
    n, T = H.shape
    Hi = np.ascontiguousarray(H, np.int64)
    out = np.empty(n, np.int32)
    nc = lib.cluster_histograms_native(
        Hi.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), n, T,
        max_clusters, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    if nc <= 0:
        return None
    return out.tolist(), int(nc)


def _cluster_histograms_dict(hists: List[dict], max_clusters: int = 24):
    """Greedy seeded clustering (FastClusterHistograms-style): pick the
    histograms that are most expensive to merge as seeds, assign the
    rest to the cheapest seed by cross-entropy increase."""
    import math
    n = len(hists)
    totals = [sum(h.values()) for h in hists]
    selfc = [_hist_cost(h) for h in hists]

    def merge_extra(i, seed_h, seed_total, seed_cost):
        """extra bits of coding hist i with (seed ∪ i) vs separately."""
        m = dict(seed_h)
        for s, c in hists[i].items():
            m[s] = m.get(s, 0) + c
        return _hist_cost(m) - seed_cost - selfc[i]

    order = sorted(range(n), key=lambda i: -totals[i])
    seeds = []
    seed_h = []
    seed_cost = []
    assign = [0] * n
    for i in order:
        if not totals[i]:
            continue
        best, bestc = -1, math.inf
        for si in range(len(seeds)):
            c = merge_extra(i, seed_h[si], 0, seed_cost[si])
            if c < bestc:
                best, bestc = si, c
        if (best < 0 or bestc > 60.0) and len(seeds) < max_clusters:
            seeds.append(i)
            seed_h.append(dict(hists[i]))
            seed_cost.append(selfc[i])
            assign[i] = len(seeds) - 1
        else:
            assign[i] = best
            for s, c in hists[i].items():
                seed_h[best][s] = seed_h[best].get(s, 0) + c
            seed_cost[best] = _hist_cost(seed_h[best])
    if not seeds:
        return [0] * n, 1
    # empty contexts join cluster 0
    for i in range(n):
        if not totals[i]:
            assign[i] = 0

    # agglomerative refinement: merge cluster pairs while the entropy
    # increase is smaller than the header bits saved (one histogram
    # serialization fewer) — adapts the cluster count to the image
    # instead of a fixed similarity threshold
    def hist_bits(h):
        if not h:
            return 0.0
        if max(h) > 255:
            # alphabet beyond the ANS distribution form (prefix-code
            # backend): header-size estimate is enough for merging
            return 6.0 * len(h) + 40.0
        counts = _ans.normalize_counts([h.get(s, 0)
                                        for s in range(max(h) + 1)])
        return _ans.estimate_ans_distribution_bits(
            counts, num_tokens=sum(h.values()))

    groups = [dict(h) for h in seed_h]
    bits = [hist_bits(h) for h in groups]
    cost = [_hist_cost(h) for h in groups]
    remap = list(range(len(groups)))
    alive = [True] * len(groups)
    pair_cache = {}   # (i,j) i<j -> (delta, merged); only the merged
    # cluster's pairs change between iterations

    def pair_delta(i, j):
        key = (i, j) if i < j else (j, i)
        e = pair_cache.get(key)
        if e is None:
            m = dict(groups[i])
            for s, c in groups[j].items():
                m[s] = m.get(s, 0) + c
            delta = (_hist_cost(m) - cost[i] - cost[j]) \
                - (bits[i] + bits[j] - hist_bits(m))
            e = (delta, m)
            pair_cache[key] = e
        return e

    while sum(alive) > 1:
        best = (0.0, None)
        live = [i for i in range(len(groups)) if alive[i]]
        for ai in range(len(live)):
            for bi in range(ai + 1, len(live)):
                i, j = live[ai], live[bi]
                delta, m = pair_delta(i, j)
                if delta < best[0]:
                    best = (delta, (i, j, m))
        if best[1] is None:
            break
        i, j, m = best[1]
        groups[i] = m
        bits[i] = hist_bits(m)
        cost[i] = _hist_cost(m)
        alive[j] = False
        pair_cache = {k: v for k, v in pair_cache.items()
                      if i not in k and j not in k}
        for k in range(len(remap)):
            if remap[k] == j:
                remap[k] = i
    # densify cluster ids
    dense = {}
    out = [0] * n
    for ci in range(n):
        g = remap[assign[ci]]
        if g not in dense:
            dense[g] = len(dense)
        out[ci] = dense[g]
    return out, len(dense)


# --------------------------------------------------------------------------
# Decoder

class EntropyCode:
    """Parsed entropy tables (lz77 params, cluster map, uint configs,
    prefix codes / ANS alias tables).  Shared between streams: the global
    modular histograms are parsed once and reused by every group stream,
    each with its own stream state (EntropyDecoder)."""

    def __init__(self, br: BitReader, num_contexts: int):
        self.num_contexts = num_contexts
        self.lz77 = Lz77Params.read(br)
        num_dists = num_contexts
        if self.lz77.enabled:
            num_dists += 1
            self.dist_ctx = num_contexts
        else:
            self.dist_ctx = None
        self.cluster_map = read_cluster_map(br, num_dists)
        num_clusters = max(self.cluster_map) + 1
        self.use_prefix = br.bool()
        if self.use_prefix:
            log_alpha = 15
        else:
            log_alpha = br.u(2) + 5
        self.log_alpha = log_alpha
        self.configs = [HybridUintConfig.read(br, log_alpha)
                        for _ in range(num_clusters)]
        self.prefix_codes: List[Optional[PrefixCode]] = []
        self.alias_tables: List[Optional[AliasTable]] = []
        if self.use_prefix:
            sizes = []
            for _ in range(num_clusters):
                if br.bool():
                    n = br.u(4)
                    sizes.append(1 + (1 << n) + br.u(n))
                else:
                    sizes.append(1)
            self.prefix_codes = [read_prefix_code(br, s) for s in sizes]
        else:
            dists = [_ans.read_ans_distribution(br, log_alpha)
                     for _ in range(num_clusters)]
            self.alias_tables = [AliasTable(d, log_alpha) for d in dists]


class EntropyDecoder:
    """Reads hybrid-uint values with contexts from a JXL entropy stream.

    Either parses its own EntropyCode from the stream (num_contexts given)
    or attaches fresh stream state to a shared, already-parsed code."""

    def __init__(self, br: BitReader, num_contexts: int = None,
                 dist_multiplier: int = 0, code: "EntropyCode" = None):
        self.br = br
        self.dist_multiplier = dist_multiplier
        if code is None:
            code = EntropyCode(br, num_contexts)
        self.code = code
        self.lz77 = code.lz77
        if self.lz77.enabled:
            self.dist_ctx = code.dist_ctx
            self.window: List[int] = []
        self.cluster_map = code.cluster_map
        self.use_prefix = code.use_prefix
        self.log_alpha = code.log_alpha
        self.configs = code.configs
        self.prefix_codes = code.prefix_codes
        self.alias_tables = code.alias_tables
        self.ans = None if code.use_prefix else AnsState(br)
        # lz77 run state
        self._copy_pos = 0
        self._copy_len = 0
        self.num_decoded = 0

    def _read_token(self, cluster: int) -> int:
        if self.use_prefix:
            return self.prefix_codes[cluster].read(self.br)
        return self.ans.read_symbol(self.alias_tables[cluster])

    def read(self, ctx: int) -> int:
        """Read one hybrid-uint value (LZ77-aware)."""
        if self.lz77.enabled:
            return self._read_lz77(ctx)
        cluster = self.cluster_map[ctx]
        token = self._read_token(cluster)
        return self.configs[cluster].read_value(token, self.br)

    def _record(self, v: int) -> int:
        if self.lz77.enabled:
            self.window.append(v)
        self.num_decoded += 1
        return v

    def _read_lz77(self, ctx: int) -> int:
        if self._copy_len > 0:
            self._copy_len -= 1
            v = self.window[self._copy_pos]
            self._copy_pos += 1
            return self._record(v)
        cluster = self.cluster_map[ctx]
        token = self._read_token(cluster)
        if token >= self.lz77.min_symbol:
            length = self.lz77.min_length + \
                self.lz77.length_config.read_value(
                    token - self.lz77.min_symbol, self.br)
            dcl = self.cluster_map[self.dist_ctx]
            dtok = self._read_token(dcl)
            dval = self.configs[dcl].read_value(dtok, self.br)
            distance = self._decode_distance(dval)
            distance = min(distance, self.num_decoded, 1 << 20)
            if distance == 0:
                raise BitstreamError("lz77 copy before any symbol")
            self._copy_pos = self.num_decoded - distance
            self._copy_len = length - 1
            v = self.window[self._copy_pos]
            self._copy_pos += 1
            return self._record(v)
        v = self.configs[cluster].read_value(token, self.br)
        return self._record(v)

    def _decode_distance(self, dval: int) -> int:
        if self.dist_multiplier == 0:
            return dval + 1
        if dval < 120:
            x, y = SPECIAL_DISTANCES[dval]
            return max(1, x + self.dist_multiplier * y)
        return dval - 119

    def check_final_state(self) -> bool:
        if self.ans is None:
            return True
        return self.ans.check_final_state()


# Special LZ77 distances (§C.3, kSpecialDistances): 120 (x, y) motion
# pairs from WebP lossless; distance = max(1, x + y * dist_multiplier).
SPECIAL_DISTANCES = [
    (0, 1), (1, 0), (1, 1), (-1, 1), (0, 2), (2, 0), (1, 2), (-1, 2),
    (2, 1), (-2, 1), (2, 2), (-2, 2), (0, 3), (3, 0), (1, 3), (-1, 3),
    (3, 1), (-3, 1), (2, 3), (-2, 3), (3, 2), (-3, 2), (0, 4), (4, 0),
    (1, 4), (-1, 4), (4, 1), (-4, 1), (3, 3), (-3, 3), (2, 4), (-2, 4),
    (4, 2), (-4, 2), (0, 5), (3, 4), (-3, 4), (4, 3), (-4, 3), (5, 0),
    (1, 5), (-1, 5), (5, 1), (-5, 1), (2, 5), (-2, 5), (5, 2), (-5, 2),
    (4, 4), (-4, 4), (3, 5), (-3, 5), (5, 3), (-5, 3), (0, 6), (6, 0),
    (1, 6), (-1, 6), (6, 1), (-6, 1), (2, 6), (-2, 6), (6, 2), (-6, 2),
    (4, 5), (-4, 5), (5, 4), (-5, 4), (3, 6), (-3, 6), (6, 3), (-6, 3),
    (0, 7), (7, 0), (1, 7), (-1, 7), (5, 5), (-5, 5), (7, 1), (-7, 1),
    (4, 6), (-4, 6), (6, 4), (-6, 4), (2, 7), (-2, 7), (7, 2), (-7, 2),
    (3, 7), (-3, 7), (7, 3), (-7, 3), (5, 6), (-5, 6), (6, 5), (-6, 5),
    (8, 0), (4, 7), (-4, 7), (7, 4), (-7, 4), (8, 1), (8, 2), (6, 6),
    (-6, 6), (8, 3), (5, 7), (-5, 7), (7, 5), (-7, 5), (8, 4), (6, 7),
    (-6, 7), (7, 6), (-7, 6), (8, 5), (7, 7), (-7, 7), (8, 6), (8, 7)]


# --------------------------------------------------------------------------
# Encoder

class TokenStream:
    """Collects (ctx, value) tokens, then serializes histograms + stream.

    Writes the prefix-code backend with per-context clustering (identity or
    greedy merge into <=8 clusters so the simple cluster-map form applies).
    """

    def __init__(self, num_contexts: int, lz77: bool = False,
                 use_ans: bool = False):
        self.num_contexts = num_contexts
        self.lz77 = lz77
        self.use_ans = use_ans
        self._pend: List[tuple] = []
        self._segs: List[tuple] = []    # (ctx int64[], value int64[])

    def add(self, ctx: int, value: int) -> None:
        if value < 0:
            raise ValueError("tokens are unsigned")
        self._pend.append((ctx, value))

    def add_arrays(self, ctx_arr, val_arr) -> None:
        """Append a whole (ctx, value) array segment without the
        per-token Python tuple round-trip (the native tokenizers emit
        arrays; converting to tuples and back was an encoder hotspot)."""
        import numpy as np
        self._flush_pend()
        self._segs.append((np.asarray(ctx_arr, np.int64).reshape(-1),
                           np.asarray(val_arr, np.int64).reshape(-1)))

    def extend_from(self, other: "TokenStream") -> None:
        other._flush_pend()
        self._flush_pend()
        self._segs.extend(other._segs)

    def _flush_pend(self) -> None:
        if self._pend:
            import numpy as np
            a = np.asarray(self._pend, np.int64).reshape(-1, 2)
            self._segs.append((a[:, 0], a[:, 1]))
            self._pend = []

    def arrays(self):
        """(ctx int64[], value int64[]) in stream order (cached)."""
        import numpy as np
        self._flush_pend()
        if not self._segs:
            z = np.zeros(0, np.int64)
            return z, z
        if len(self._segs) > 1:
            c = np.concatenate([s[0] for s in self._segs])
            v = np.concatenate([s[1] for s in self._segs])
            self._segs = [(c, v)]
        return self._segs[0]

    @property
    def tokens(self) -> List[tuple]:
        """Materialized token list (oracle / small-stream paths)."""
        c, v = self.arrays()
        return list(zip(c.tolist(), v.tolist()))

    def __len__(self) -> int:
        return len(self._pend) + sum(len(s[0]) for s in self._segs)

    def write(self, bw: BitWriter,
              config: HybridUintConfig = HybridUintConfig(4, 4, 0)) -> None:
        if self.lz77:
            self._write_lz77(bw, config)
            return
        shared = self.write_histograms(bw, config)
        self.write_symbols(bw, shared)

    def write_histograms(self, bw: BitWriter,
                         config: HybridUintConfig = HybridUintConfig(4, 4, 0)
                         ):
        """Serialize lz77-off + cluster map + configs + prefix codes for
        THIS stream's tokens; returns the shared coding state so other
        token streams (e.g. per-group sections sharing HfGlobal
        histograms) can emit just their symbols."""
        # lz77 disabled: a plain Bool field, 0 bit (no all_default)
        bw.bool(False)
        # vectorized tokenization for the histogram passes
        import numpy as np
        ctx_v, val_v = self.arrays()
        if len(ctx_v):
            tok_v = _tokenize_values_vec(config, val_v)
            ntok = int(tok_v.max()) + 1
        else:
            tok_v = ctx_v
            ntok = 1
        # cluster contexts by histogram similarity (greedy seeded
        # clustering); >8 clusters use the complex MTF cluster map
        cmap = [0] * self.num_contexts
        if self.num_contexts > 1:
            counts = np.bincount(ctx_v * ntok + tok_v,
                                 minlength=self.num_contexts * ntok
                                 ).reshape(self.num_contexts, ntok)
            res = _cluster_histograms_native(counts, 24) \
                if ntok <= 4097 else None
            if res is not None:
                cmap, _nc = res
            else:
                per_ctx = [{int(t): int(row[t])
                            for t in np.nonzero(row)[0]}
                           for row in counts]
                cmap, _nc = cluster_histograms(per_ctx)
        num_clusters = (max(cmap) + 1) if cmap else 1
        write_cluster_map(bw, cmap if self.num_contexts > 1 else [0])
        cmap_a = np.asarray(cmap if self.num_contexts > 1
                            else [0], np.int64)
        cl_v = cmap_a[ctx_v] if self.num_contexts > 1 \
            else np.zeros(len(tok_v), np.int64)
        ccounts = np.bincount(cl_v * ntok + tok_v,
                              minlength=num_clusters * ntok
                              ).reshape(num_clusters, ntok)
        per_cluster_hist = [
            {int(t): int(row[t]) for t in np.nonzero(row)[0]}
            for row in ccounts]
        if self.use_ans:
            from . import ans as _ans
            bw.bool(False)  # ANS backend
            log_alpha = 8
            bw.u(log_alpha - 5, 2)
            for _ in range(num_clusters):
                config.write(bw, log_alpha)
            tables = []
            for cl in range(num_clusters):
                h = per_cluster_hist[cl]
                alpha = (max(h) + 1) if h else 1
                if alpha > (1 << log_alpha):
                    raise ValueError("token exceeds ANS alphabet")
                hist = [h.get(s, 0) for s in range(alpha)]
                counts = _ans.normalize_counts(hist)
                # the complex form may quantize counts for a cheaper
                # header; the decoder reads the quantized values, so
                # the alias table must be built from the return value
                counts = _ans.write_ans_distribution(
                    bw, counts, num_tokens=sum(hist))
                tables.append(_ans.AliasTable(counts, log_alpha))
            return (cmap, config, tables)
        bw.bool(True)  # use_prefix_code
        log_alpha = 15
        for _ in range(num_clusters):
            config.write(bw, log_alpha)
        # all alphabet sizes first, then all codes (decoder order)
        alphas = []
        for cl in range(num_clusters):
            h = per_cluster_hist[cl]
            alpha = (max(h) + 1) if h else 1
            alphas.append(alpha)
            if alpha == 1:
                bw.bool(False)
            else:
                bw.bool(True)
                n = (alpha - 1).bit_length() - 1
                bw.u(n, 4)
                bw.u(alpha - 1 - (1 << n), n)
        codes = []
        for cl in range(num_clusters):
            alpha = alphas[cl]
            h = per_cluster_hist[cl]
            hist_list = [h.get(s, 0) for s in range(alpha)]
            lengths = build_code_lengths(hist_list, alpha)
            if alpha > 1:
                write_prefix_code(bw, lengths, alpha)
                codes.append(PrefixCode(lengths))
            else:
                codes.append(PrefixCode([1]))
        return (cmap, config, codes)

    def write_symbols(self, bw: BitWriter, shared) -> None:
        cmap, config, codes = shared
        if self.use_ans:
            self._write_symbols_ans(bw, shared)
            return
        for ctx, value in self.tokens:
            cl = cmap[ctx] if self.num_contexts > 1 else 0
            token, extra, nbits = config.tokenize(value)
            codes[cl].write(bw, token)
            if nbits:
                bw.u(extra, nbits)

    def _write_symbols_ans(self, bw: BitWriter, shared) -> None:
        """LIFO rANS emission: push all symbols, then interleave the
        decoder's refill words with the hybrid-uint extra bits."""
        cmap, config, tables = shared
        if self._write_symbols_ans_native(bw, shared):
            return
        enc = AnsEncoder()
        toks = []
        for ctx, value in self.tokens:
            cl = cmap[ctx] if self.num_contexts > 1 else 0
            token, extra, nbits = config.tokenize(value)
            toks.append((token, extra, nbits))
            enc.push(tables[cl], token)
        state, words = enc.encode()
        bw.u(state, 32)
        for i, (token, extra, nbits) in enumerate(toks):
            if words[i] is not None:
                bw.u(words[i], 16)
            if nbits:
                bw.u(extra, nbits)

    def _write_symbols_ans_native(self, bw: BitWriter, shared) -> bool:
        """C++ rANS stream writer (tokenize + reverse pass + emission);
        returns False for an empty stream."""
        import numpy as np
        from .. import native as native_mod
        lib = native_mod.get_lib()
        if not len(self):
            return False
        cmap, config, tables = shared
        from .ans import ANS_TAB_SIZE
        max_alpha = max(len(t.freq) for t in tables)
        ncl = len(tables)
        freq = np.zeros((ncl, max_alpha), np.int32)
        cum = np.zeros((ncl, max_alpha), np.int32)
        rev = np.zeros((ncl, ANS_TAB_SIZE), np.int32)
        for cl, t in enumerate(tables):
            pack = getattr(t, "_enc_pack", None)
            if pack is None:
                f = np.asarray(t.freq, np.int32)
                c_ = np.zeros(len(f), np.int32)
                c_[1:] = np.cumsum(f)[:-1]
                # vectorized reverse map: state idx -> (sym, off) via the
                # alias lookup, scattered to cum[sym]+off
                idx = np.arange(ANS_TAB_SIZE, dtype=np.int32)
                bucket = idx >> t.log_entry
                pos = idx & (t.entry_size - 1)
                cuts = np.asarray(t.cutoffs, np.int32)[bucket]
                in_right = pos >= cuts
                sym = np.where(in_right,
                               np.asarray(t.right, np.int32)[bucket],
                               bucket)
                off = np.where(
                    in_right,
                    np.asarray(t.offsets, np.int32)[bucket] + pos - cuts,
                    pos)
                r = np.zeros(ANS_TAB_SIZE, np.int32)
                r[c_[sym] + off] = idx
                pack = t._enc_pack = (f, c_, r)
            f, c_, r = pack
            freq[cl, :len(f)] = f
            cum[cl, :len(f)] = c_
            rev[cl] = r
        ctx_v, val_v = self.arrays()
        ctxs = np.ascontiguousarray(ctx_v, np.int32)
        vals = np.ascontiguousarray(val_v, np.int64)
        cmap_a = np.asarray(cmap, np.int32)
        n = len(vals)
        cap_bits = 32 + n * 64 + 64
        out = np.zeros((cap_bits + 7) // 8, np.uint8)
        import ctypes
        i32p = ctypes.POINTER(ctypes.c_int32)
        nbits = lib.ans_stream_encode(
            ctxs.ctypes.data_as(i32p),
            vals.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), n,
            cmap_a.ctypes.data_as(i32p), int(self.num_contexts),
            int(config.split_exponent), int(config.msb_in_token),
            int(config.lsb_in_token),
            freq.ctypes.data_as(i32p), cum.ctypes.data_as(i32p),
            rev.ctypes.data_as(i32p), int(max_alpha),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            int(cap_bits))
        if nbits < 0:
            return False
        bw.append_bits(out.tobytes(), int(nbits))
        return True

    def _write_lz77(self, bw: BitWriter, config: HybridUintConfig) -> None:
        """Serialize with distance-1 LZ77 runs (RLE of repeated values).

        Greedy: a literal v followed by >= min_length more copies of v
        becomes one copy token; the decoder's window serves the repeats.
        """
        toklist = self.tokens
        max_tok = 0
        for _, v in toklist:
            t, _, _ = config.tokenize(v)
            if t > max_tok:
                max_tok = t
        min_symbol = 224 if max_tok < 224 else 512 if max_tok < 512 else 4096
        if max_tok >= 4096:
            raise ValueError("literal token too large for lz77 min_symbol")
        params = Lz77Params(enabled=True, min_symbol=min_symbol,
                            min_length=3,
                            length_config=HybridUintConfig(4, 2, 0))
        params.write(bw)
        n_ctx = self.num_contexts
        dist_ctx = n_ctx
        # detect runs over the raw value sequence
        seq = toklist
        events = []  # ("lit", ctx, value) | ("copy", ctx, length)
        i = 0
        N = len(seq)
        while i < N:
            ctx, v = seq[i]
            events.append(("lit", ctx, v))
            i += 1
            if i < N and seq[i][1] == v:
                j = i
                while j < N and seq[j][1] == v:
                    j += 1
                run = j - i
                if run >= params.min_length:
                    events.append(("copy", seq[i][0], run))
                    i = j
        # cluster map: contexts + distance context
        used = sorted({e[1] for e in events})
        cmap = [0] * (n_ctx + 1)
        assign = {}
        nid = 0
        for c in used + [dist_ctx]:
            if c not in assign:
                assign[c] = min(nid, 7)
                nid += 1
        for c in range(n_ctx + 1):
            cmap[c] = assign.get(c, 0)
        dense = sorted(set(cmap))
        remap = {v: i for i, v in enumerate(dense)}
        cmap = [remap[v] for v in cmap]
        num_clusters = max(cmap) + 1
        write_cluster_map(bw, cmap)
        bw.bool(True)  # use_prefix_code
        for _ in range(num_clusters):
            config.write(bw, 15)
        # tokenize
        per_hist = [dict() for _ in range(num_clusters)]
        out_toks = []
        for e in events:
            if e[0] == "lit":
                cl = cmap[e[1]]
                token, extra, nbits = config.tokenize(e[2])
                if token >= params.min_symbol:
                    # value's token collides with copy tokens: escape by
                    # downgrading the run handling — encode value anyway;
                    # tokens >= min_symbol are copies, so remap value
                    # tokens into the literal range is impossible here.
                    raise ValueError(
                        "token >= lz77 min_symbol; raise min_symbol")
                out_toks.append((cl, token, extra, nbits, None))
            else:
                cl = cmap[e[1]]
                ltok, lextra, lnbits = params.length_config.tokenize(
                    e[2] - params.min_length)
                token = params.min_symbol + ltok
                dcl = cmap[dist_ctx]
                dtok, dextra, dnbits = config.tokenize(0)  # distance 1
                out_toks.append((cl, token, lextra, lnbits,
                                 (dcl, dtok, dextra, dnbits)))
                h = per_hist[dcl]
                h[dtok] = h.get(dtok, 0) + 1
            h = per_hist[cl if e[0] == "lit" else cl]
            t = out_toks[-1][1]
            h[t] = h.get(t, 0) + 1
        # alphabet sizes then codes
        alphas = []
        for cl in range(num_clusters):
            h = per_hist[cl]
            alpha = (max(h) + 1) if h else 1
            alphas.append(alpha)
            if alpha == 1:
                bw.bool(False)
            else:
                bw.bool(True)
                nb = (alpha - 1).bit_length() - 1
                bw.u(nb, 4)
                bw.u(alpha - 1 - (1 << nb), nb)
        codes = []
        for cl in range(num_clusters):
            h = per_hist[cl]
            alpha = alphas[cl]
            hist_list = [h.get(s, 0) for s in range(alpha)]
            lengths = build_code_lengths(hist_list, alpha)
            if alpha > 1:
                write_prefix_code(bw, lengths, alpha)
                codes.append(PrefixCode(lengths))
            else:
                codes.append(PrefixCode([1]))
        for cl, token, extra, nbits, dist in out_toks:
            codes[cl].write(bw, token)
            if nbits:
                bw.u(extra, nbits)
            if dist is not None:
                dcl, dtok, dextra, dnbits = dist
                codes[dcl].write(bw, dtok)
                if dnbits:
                    bw.u(dextra, dnbits)
