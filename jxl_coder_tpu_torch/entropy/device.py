"""Device AC entropy decode of a VarDCT frame's pass groups.

The port of ``jxl_coder_tpu/entropy/device.py``.  The host parses the
frame up to HfGlobal; then one launch decodes every AC pass group from
the codestream's bytes to quantised coefficients on the device,
bit-exact with the host decoder (``host/native/hostcodec.cpp``
``decode_ac_group_native``).  The coefficients are born in the
frame-global ``BlockArrays`` layout: each value lands at its natural
position inside its varblock's 3 x size slot, so ``vardct/inputs.py``
gathers the families from them on the device, and only the codestream
goes up.

Host side (numpy):
- ``pack_code``: one pass's ``EntropyCode`` -> the context -> cluster map
  (uint8), the alias entries as ``hostcodec.cpp``'s ``AliasEntry`` in two
  words (2 KB a cluster at most, where the reference's dense
  4096-entry lookup tables take 48 KB: small enough that the kernel
  stages a pass's entries in shared memory, ~48 KB at 4K, for the read
  on each token's chain) and the hybrid uint configs.  Prefix codes and
  LZ77 raise NotImplementedError: the device decode reads ANS only.
- ``build_anchors``: the varblocks of every group in decode order with
  their block contexts, from the frame-global block maps, vectorised
  over the frame (the reference's ``build_group_schedule`` loops over
  blocks in Python).
- ``group_streams``: where each (pass, group) stream's bits start and
  end in the codestream, and its histogram's context base.

``decode_pass_groups`` launches ``csrc/entropy.cu`` (one group per
thread block: a lane runs the token chain, a warp scatters its records)
on a CUDA device and runs ``decode_pass_groups_plain``, the
reference's lockstep step in torch (one token per group per step), on
the CPU.  ``check_groups`` reads back the small status vector and
raises for a group that failed; nothing falls back to the host decoder.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from .. import _build
from ..host.bitstream.reader import BitstreamError
from ..host.entropy.ans import ANS_SIGNATURE
from ..host.vardct.dec_real import (K_COEFF_FREQ_CTX, K_NUM_NZ_CTX,
                                    NONZERO_BUCKETS, NUM_ORDERS,
                                    ZERO_DENSITY_CTX_COUNT, _native_orders,
                                    _strategy_luts)

SIGNATURE_STATE = ANS_SIGNATURE << 16     # every stream's final rANS state
GROUP_BLOCKS = 32
MAX_BLOCK_CTXS = 16                       # entropy.cuh kMaxBlockCtxs
ANCHOR_INTS = 12                          # entropy.cuh kAnchorInts
PASS_INTS = 7                             # entropy.cu kPassInts
CTXS_PER_BLOCK_CTX = NONZERO_BUCKETS + ZERO_DENSITY_CTX_COUNT
# the kernel's status bits (entropy.cuh): the native decoder's codes and
# the port's overflow code
ERRORS = {2: "a hybrid uint of 32 bits or more",
          8: "more nonzeros than the block has coefficients",
          9: "a coefficient index past the block",
          16: "a read past the section's end",
          32: "a coefficient outside int32 after its pass's shift"}
_INT32 = (-(1 << 31), (1 << 31) - 1)


# --------------------------------------------------------------------------
# Host-side packing


def pack_code(code) -> dict:
    """One pass's EntropyCode -> dict(cluster_map (contexts,) uint8,
    alias (clusters << log_alpha, 2) uint32, configs (clusters,) uint32,
    log_alpha).  An alias entry is word 0 = cutoff | right << 8 |
    offset << 16 and word 1 = freq[bucket] | freq[right] << 16; a config
    is split_exponent | msb_in_token << 8 | lsb_in_token << 16."""
    if code.use_prefix:
        raise NotImplementedError(
            "AC pass groups coded with prefix codes: the device entropy "
            "decode reads ANS streams only (decode with entropy='host')")
    if code.lz77.enabled:
        raise NotImplementedError(
            "AC pass groups coded with LZ77: the device entropy decode has "
            "no LZ77 window (decode with entropy='host')")
    la = code.log_alpha
    nb = 1 << la
    tabs = code.alias_tables
    if len(tabs) > 256:
        raise BitstreamError(f"{len(tabs)} clusters: at most 256")
    if any(len(t.freq) != nb for t in tabs):
        raise BitstreamError("an ANS distribution wider than its alphabet")
    cut, right, off, freq = (np.asarray([getattr(t, f) for t in tabs],
                                        np.int64).reshape(len(tabs), nb)
                             for f in ("cutoffs", "right", "offsets", "freq"))
    freq_right = np.take_along_axis(freq, right, 1)
    alias = np.stack([cut | right << 8 | off << 16, freq | freq_right << 16],
                     -1).astype(np.uint32)
    cfg = np.asarray([(c.split_exponent, c.msb_in_token, c.lsb_in_token)
                      for c in code.configs], np.int64).reshape(-1, 3)
    if (cfg[:, 1] + cfg[:, 2] > cfg[:, 0]).any():
        raise BitstreamError("hybrid uint config with msb + lsb > split")
    return dict(cluster_map=np.asarray(code.cluster_map, np.uint8),
                alias=alias.reshape(-1, 2),
                configs=(cfg[:, 0] | cfg[:, 1] << 8
                         | cfg[:, 2] << 16).astype(np.uint32),
                log_alpha=la)


def lookup_tables(pack: dict):
    """The packed alias entries expanded to the reference's dense
    tables: (symbol, offset, frequency) for each of the 4096 rANS slots
    of each cluster, flat int64 (what jxl_coder_tpu's pack_code holds)."""
    la = pack["log_alpha"]
    le = 12 - la
    e = pack["alias"].astype(np.int64).reshape(-1, 1 << la, 2)
    idx = np.arange(1 << 12)
    bucket, pos = idx >> le, idx & ((1 << le) - 1)
    e0, e1 = e[:, bucket, 0], e[:, bucket, 1]
    cut = e0 & 0xFF
    low = pos < cut
    sym = np.where(low, bucket, (e0 >> 8) & 0xFF)
    off = np.where(low, pos, (e0 >> 16) + pos - cut)
    freq = np.where(low, e1 & 0xFFFF, e1 >> 16)
    return sym.reshape(-1), off.reshape(-1), freq.reshape(-1)


@dataclasses.dataclass
class Anchors:
    """The frame's varblocks in decode order: group by group, each in
    raster order.  `table` is (ANCHOR_INTS, N) int32, a row per field:
    bx, by (inside its group), covered, log2(covered), coefficients per
    channel, cx, cy, order bucket, block contexts of channels x, y, b, 0.
    The rest is BlockArrays' (frame coordinates; offs are the slots)."""
    table: np.ndarray
    group_start: np.ndarray    # (G + 1,) int32 first anchor of each group
    ids: np.ndarray
    bxs: np.ndarray
    bys: np.ndarray
    ncv: np.ndarray
    offs: np.ndarray           # (N + 1,) int64


def _group_major(a: np.ndarray, gy: int, gx: int) -> np.ndarray:
    """A (ys_b, xs_b) block map, padded with -1 to whole AC groups, flat
    group by group, each group in raster order (the decode's order)."""
    g = np.full((gy * GROUP_BLOCKS, gx * GROUP_BLOCKS), -1, np.int32)
    g[:a.shape[0], :a.shape[1]] = a
    return g.reshape(gy, GROUP_BLOCKS, gx, GROUP_BLOCKS).transpose(
        0, 2, 1, 3).reshape(-1)


@functools.lru_cache(maxsize=None)
def _strategy_table() -> np.ndarray:
    """(7, strategy ids) int32, a row per field: covered, log2(covered),
    coefficients per channel, cx, cy, order bucket, valid."""
    return np.stack(_strategy_luts()).astype(np.int32)


def build_anchors(acs_map: np.ndarray, qf_map: np.ndarray, dc, bcm
                  ) -> Anchors:
    """Frame-global (ys_b, xs_b) strategy map (-1 where covered), quant
    field and the three quantised DC channels (modular order, which the
    block context map's DC thresholds index) -> the anchors, as
    host/vardct/dec_real.py's _read_pass_group_native builds them for one
    group, for every group at once."""
    ys_b, xs_b = acs_map.shape
    gx, gy = -(-xs_b // GROUP_BLOCKS), -(-ys_b // GROUP_BLOCKS)
    acs = _group_major(acs_map, gy, gx)
    sel = np.flatnonzero(acs >= 0)        # (group, by, bx) of each anchor
    ids = acs[sel]
    lut = _strategy_table()
    if ids.max(initial=0) >= lut.shape[1] or not lut[6][ids].all():
        bad = ids[(ids >= lut.shape[1])
                  | ~lut[6][np.minimum(ids, lut.shape[1] - 1)].astype(bool)]
        raise BitstreamError("invalid AC strategy %d" % int(bad[0]))
    cols = np.empty((ANCHOR_INTS, len(ids)), np.int32)
    cols[0], cols[1] = sel & 31, (sel >> 5) & 31
    for f in range(6):
        cols[2 + f] = lut[f][ids]
    group = sel >> 10
    gyi, gxi = np.divmod(group, gx)
    # the decode keeps each group's nonzero map: a varblock stays inside
    gw = np.minimum(GROUP_BLOCKS, xs_b - GROUP_BLOCKS * np.arange(gx))
    gh = np.minimum(GROUP_BLOCKS, ys_b - GROUP_BLOCKS * np.arange(gy))
    if ((cols[0] + cols[5] > gw[gxi]) | (cols[1] + cols[6] > gh[gyi])).any():
        raise BitstreamError("a varblock crosses its AC group")
    group_start = np.searchsorted(group, np.arange(gx * gy + 1)).astype(
        np.int32)
    dc_idx = 0
    for c in range(3):
        th = np.asarray(bcm.dc_thresholds[c], np.int64)
        if th.size:
            v = _group_major(dc[c], gy, gx)[sel]
            dc_idx = dc_idx * (th.size + 1) + (v[None, :] > th[:, None]).sum(0)
    qft = np.asarray(bcm.qf_thresholds, np.int64)
    qf_idx = ((_group_major(qf_map, gy, gx)[sel][None, :] > qft[:, None]).sum(0)
              if qft.size else 0)
    nq = qft.size + 1
    ctx_map = np.asarray(bcm.ctx_map, np.int32)
    for c in range(3):
        cidx = (c ^ 1) if c < 2 else 2
        cols[8 + c] = ctx_map[((cidx * NUM_ORDERS + cols[7]) * nq + qf_idx)
                              * bcm.num_dc_ctxs + dc_idx]
    cols[11] = 0
    ncv = cols[4]
    offs = np.zeros(len(ids) + 1, np.int64)
    np.cumsum(3 * ncv, out=offs[1:])
    return Anchors(cols, group_start, ids,
                   (gxi * GROUP_BLOCKS + cols[0]).astype(np.int32),
                   (gyi * GROUP_BLOCKS + cols[1]).astype(np.int32),
                   ncv.copy(), offs)


def group_streams(cs: bytes, sections: np.ndarray, histo_bits: int,
                  num_histograms: int, num_ctxs: int) -> np.ndarray:
    """sections: (P, G, 2) int64 bit range [start, end) in `cs` of each
    (pass, group) stream, from its histogram index on -> (P, G, 3) int64:
    the bit after the histogram index (where the kernel reads the 32-bit
    initial rANS state), the end, and the histogram's context base."""
    out = np.empty(sections.shape[:2] + (3,), np.int64)
    for p, g in np.ndindex(*sections.shape[:2]):
        start, end = (int(v) for v in sections[p, g])
        if start + histo_bits > end:
            raise BitstreamError("AC group section shorter than its "
                                 "histogram index")
        if end - start >= 1 << 32:
            raise NotImplementedError("an AC group section of 512 MB or "
                                      "more: the kernel counts its bits "
                                      "in 32 bits")
        word = int.from_bytes(cs[start >> 3:(start >> 3) + 4], "little")
        histo = (word >> (start & 7)) & ((1 << histo_bits) - 1)
        if histo >= num_histograms:
            raise BitstreamError(f"AC group histogram {histo} of "
                                 f"{num_histograms}")
        out[p, g] = (start + histo_bits, end,
                     histo * num_ctxs * CTXS_PER_BLOCK_CTX)
    return out


class Tables(NamedTuple):
    """Everything the decode reads, on one device (int32 tensors hold
    uint32 bits)."""
    words: torch.Tensor        # (W,) int32: the codestream, LE words, padded
    anchors: torch.Tensor      # (ANCHOR_INTS, N) int32
    offs: torch.Tensor         # (N + 1,) int64
    group_start: torch.Tensor  # (G + 1,) int32
    streams: torch.Tensor      # (P, G, 3) int64 (group_streams)
    passes: torch.Tensor       # (P, PASS_INTS) int32: log_alpha, alias
    #   base (words), config base, cluster map base, shift, alias words,
    #   configs
    alias: torch.Tensor        # (A, 2) int32
    configs: torch.Tensor      # (C,) int32
    cmap: torch.Tensor         # (M,) uint8
    orders: torch.Tensor       # (O,) int32 every pass's orders, flat
    order_off: torch.Tensor    # (P, NUM_ORDERS, 3) int32, -1: identity
    ctx_tabs: torch.Tensor     # (128,) int16: K_NUM_NZ_CTX, K_COEFF_FREQ_CTX
    num_ctxs: int              # block contexts
    total: int                 # coefficients (offs[-1])
    stage_words: int           # the largest pass's alias words + configs


def frame_tables(cs: bytes, anchors: Anchors, streams: np.ndarray, hf,
                 pass_shift, num_ctxs: int, device) -> Tables:
    """Pack every pass's code and orders and carry the decode's inputs,
    the codestream included, onto `device`."""
    if num_ctxs > MAX_BLOCK_CTXS:
        raise BitstreamError(f"{num_ctxs} block contexts: at most "
                             f"{MAX_BLOCK_CTXS}")
    npasses = streams.shape[0]
    passes = np.zeros((npasses, PASS_INTS), np.int32)
    alias, configs, cmaps, orders = [], [], [], []
    order_off = np.full((npasses, NUM_ORDERS, 3), -1, np.int32)
    n_alias = n_cfg = n_cmap = n_ord = 0
    for p in range(npasses):
        pk = pack_code(hf.accodes[p])
        ords, bucket_off = _native_orders(hf, p)
        passes[p] = (pk["log_alpha"], 2 * n_alias, n_cfg, n_cmap,
                     pass_shift[p], pk["alias"].size, len(pk["configs"]))
        order_off[p] = np.where(bucket_off >= 0, bucket_off + n_ord, -1)
        alias.append(pk["alias"])
        configs.append(pk["configs"])
        cmaps.append(pk["cluster_map"])
        orders.append(ords)
        n_alias += len(pk["alias"])
        n_cfg += len(pk["configs"])
        n_cmap += len(pk["cluster_map"])
        n_ord += len(ords)
    # the codestream as little-endian words, two spare words past its end
    words = np.zeros(-(-len(cs) // 4) + 2, np.uint32)
    words.view(np.uint8)[:len(cs)] = np.frombuffer(cs, np.uint8)
    tabs = np.asarray(K_NUM_NZ_CTX + K_COEFF_FREQ_CTX, np.int16)

    def up(a, dtype=None):
        a = np.ascontiguousarray(a if dtype is None else a.view(dtype))
        return torch.from_numpy(a).to(device)

    return Tables(
        words=up(words, np.int32), anchors=up(anchors.table),
        offs=up(anchors.offs), group_start=up(anchors.group_start),
        streams=up(streams), passes=up(passes),
        alias=up(np.concatenate(alias), np.int32),
        configs=up(np.concatenate(configs), np.int32),
        cmap=up(np.concatenate(cmaps)),
        orders=up(np.concatenate(orders).astype(np.int32)),
        order_off=up(order_off), ctx_tabs=up(tabs),
        num_ctxs=int(num_ctxs), total=int(anchors.offs[-1]),
        stage_words=int((passes[:, 5] + passes[:, 6]).max()))


# --------------------------------------------------------------------------
# The decode


class Decoded(NamedTuple):
    """The decode's output, on the tables' device."""
    coeffs: torch.Tensor   # (total,) int32, BlockArrays.coeffs
    status: torch.Tensor   # (G,) int32 status bits (ERRORS), 0 when right
    states: torch.Tensor   # (P, G) int64 final rANS state of each stream
    tokens: torch.Tensor   # (G,) int64 tokens read


def _check(t: Tables) -> None:
    """What the kernel reads through raw pointers: contiguous tensors of
    the dtypes frame_tables gives, on one device."""
    want = dict(words=torch.int32, anchors=torch.int32, offs=torch.int64,
                group_start=torch.int32, streams=torch.int64,
                passes=torch.int32, alias=torch.int32, configs=torch.int32,
                cmap=torch.uint8, orders=torch.int32,
                order_off=torch.int32, ctx_tabs=torch.int16)
    dev = t.words.device
    for name, dtype in want.items():
        x = getattr(t, name)
        if x.dtype != dtype or not x.is_contiguous() or x.device != dev:
            raise ValueError(f"tables.{name}: {x.dtype} on {x.device}, "
                             f"expected contiguous {dtype} on {dev}")
    G, P = t.group_start.numel() - 1, t.passes.shape[0]
    if t.streams.shape != (P, G, 3) or t.anchors.shape[0] != ANCHOR_INTS \
            or t.offs.shape != (t.anchors.shape[1] + 1,) \
            or t.passes.shape != (P, PASS_INTS) \
            or t.order_off.shape != (P, NUM_ORDERS, 3) \
            or t.ctx_tabs.numel() != 128 or t.words.numel() < 2:
        raise ValueError("tables of inconsistent shapes")
    if t.num_ctxs > MAX_BLOCK_CTXS:
        raise ValueError(f"{t.num_ctxs} block contexts: the kernel stages "
                         f"at most {MAX_BLOCK_CTXS}")


@functools.lru_cache(maxsize=None)
def _kernel():
    c = ctypes
    return _build.bind(_build.load("entropy"), "jxl_entropy_groups",
                       [c.c_void_p, c.c_longlong] + [c.c_void_p] * 11
                       + [c.c_int] * 4 + [c.c_void_p] * 4)


def decode_pass_groups(t: Tables) -> Decoded:
    """Decode every (pass, group) stream of the tables: the kernel on a
    CUDA device, decode_pass_groups_plain on the CPU."""
    _check(t)
    dev = t.words.device
    if dev.type == "cpu":
        return decode_pass_groups_plain(t)
    G, P = t.group_start.numel() - 1, t.passes.shape[0]
    out = torch.zeros(max(t.total, 1), dtype=torch.int32, device=dev)
    status = torch.zeros(G, dtype=torch.int32, device=dev)
    states = torch.zeros((P, G), dtype=torch.int32, device=dev)
    tokens = torch.zeros(G, dtype=torch.int64, device=dev)
    _build.launch(_kernel(), dev, t.words.data_ptr(), t.words.numel(),
                  t.anchors.data_ptr(), t.offs.data_ptr(),
                  t.group_start.data_ptr(), t.streams.data_ptr(),
                  t.passes.data_ptr(), t.alias.data_ptr(),
                  t.configs.data_ptr(), t.cmap.data_ptr(),
                  t.orders.data_ptr(), t.order_off.data_ptr(),
                  t.ctx_tabs.data_ptr(), t.num_ctxs, P, G, t.stage_words,
                  out.data_ptr(),
                  status.data_ptr(), states.data_ptr(), tokens.data_ptr())
    decode_pass_groups.launches += 1
    return Decoded(out[:t.total], status, states.long() & 0xFFFFFFFF,
                   tokens)


decode_pass_groups.launches = 0


def _pass_luts(t: Tables, p: int, dev):
    """The reference's dense tables of pass p (its pack_code), flat by
    rANS slot (cluster << 12 | state & 0xFFF), with the slot's symbol
    already through its hybrid uint config: (offset, frequency, base,
    nbits, lsb, bad), so that a token's value is base | raw << lsb for
    `nbits` raw bits, and `bad` marks the native decoder's error 2."""
    pa = t.passes.cpu().numpy().astype(np.int64)
    la, abase, cbase, ncl = pa[p, 0], pa[p, 1] // 2, pa[p, 2], int(pa[p, 6])
    alias = t.alias.cpu().numpy().view(np.uint32)[abase:abase + (ncl << la)]
    sym, off, freq = lookup_tables(dict(alias=alias, log_alpha=la))
    cfg = t.configs.cpu().numpy().view(np.uint32)[cbase:cbase + ncl]
    cfg = np.repeat(cfg.astype(np.int64), 1 << 12)
    se, msb, lsb = cfg & 0xFF, (cfg >> 8) & 0xFF, cfg >> 16
    split = 1 << se
    big = sym >= split
    n = np.where(big, se - (msb + lsb) + ((sym - split) >> (msb + lsb)), 0)
    bad = n >= 32
    n = np.where(bad, 0, n)
    msbits = ((sym >> lsb) & ((1 << msb) - 1)) | (1 << msb)
    base = np.where(big, ((msbits << n) << lsb) | (sym & ((1 << lsb) - 1)),
                    sym)
    return tuple(torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in (
        off, freq, np.where(bad, 0, base), n, np.where(big, lsb, 0), bad))


def _rows(t: Tables, A: torch.Tensor, gs: torch.Tensor):
    """Per (anchor, channel slot) row r = 3 * anchor + slot, channels
    (y, x, b) as the decode reads them: the fields of the kernel's anchor
    and the nonzero counts its context reads.  The counts live in one
    flat vector: channel c of anchor a at c * N + a, and 3N holds the 32
    that the first block predicts.  The neighbours' indices (li, ti) are
    chosen so that (count[li] + count[ti] + 1) >> 1 is the kernel's
    prediction in every case (left only: li = ti; top only: ti = li)."""
    N = A.shape[0]
    group = torch.repeat_interleave(torch.arange(gs.numel() - 1),
                                    gs[1:] - gs[:-1])
    bx, by, cx, cy = A[:, 0], A[:, 1], A[:, 5], A[:, 6]
    # the anchor that covers each block of each group
    owner = torch.full((gs.numel() - 1, GROUP_BLOCKS, GROUP_BLOCKS), N,
                       dtype=torch.int64)
    for sx, sy in torch.unique(torch.stack([cx, cy], 1), dim=0).tolist():
        sel = torch.nonzero((cx == sx) & (cy == sy))[:, 0]
        for yy in range(sy):
            for xx in range(sx):
                owner[group[sel], by[sel] + yy, bx[sel] + xx] = sel
    left = owner[group, by, (bx - 1).clamp(min=0)]
    top = owner[group, (by - 1).clamp(min=0), bx]
    c = torch.tensor([1, 0, 2]).repeat(N)
    a = torch.arange(3 * N) // 3
    li = c * N + left[a]
    ti = c * N + top[a]
    bxa, bya = bx[a], by[a]
    li = torch.where(bxa == 0, ti, li)
    ti = torch.where(bya == 0, li, ti)
    first = (bxa == 0) & (bya == 0)
    li, ti = torch.where(first, 3 * N, li), torch.where(first, 3 * N, ti)
    cov, l2c, size = A[a, 2], A[a, 3], A[a, 4]
    offs = t.offs.cpu()
    return dict(li=li, ti=ti, own=c * N + a, cov=cov, l2c=l2c, size=size,
                maxnz=size - cov + 1, sz16=size >> 4,
                outb=offs[:-1][a] + c * size, bctx=A[a, 8 + c],
                bucket=A[a, 7], c=c, group=group[a])


def decode_pass_groups_plain(t: Tables) -> Decoded:
    """The kernel's plain twin: the reference's lockstep step
    (jxl_coder_tpu/entropy/device.py:254-352, over its dense tables) in
    torch, every group a lane that reads one token a step, pass after
    pass, adding value << shift at the natural position in the slots as
    the kernel does.  One step per token of the longest group: for small
    streams only."""
    i64 = torch.int64
    dev = t.words.device
    w = t.words.to(i64) & 0xFFFFFFFF
    win = w[:-1] | (w[1:] << 32)      # the 64 bits from each word on
    A = t.anchors.cpu().to(i64).T
    N = A.shape[0]
    gs = t.group_start.cpu().to(i64)
    G, P = gs.numel() - 1, t.passes.shape[0]
    R = _rows(t, A, gs)
    nctx = t.num_ctxs
    pred = np.arange(65)
    nzlut = torch.from_numpy(np.where(pred < 8, pred, 4 + pred // 2)
                             * nctx).to(dev)
    tabs = t.ctx_tabs.to(i64)
    knz2, kf2 = 2 * tabs[:64], 2 * tabs[64:]
    # coefficient orders, with the identity appended for the default
    ident = t.orders.numel()
    orders = torch.cat([t.orders.to(i64), torch.arange(
        int(R["size"].max()) if N else 1, device=dev)])
    cmap = t.cmap.to(i64)
    out = torch.zeros(t.total + 1, dtype=i64, device=dev)  # + a spare slot
    out_end = t.offs.cpu()[gs[1:]].to(dev)      # each group's slots' end
    status = torch.zeros(G, dtype=i64, device=dev)
    states = torch.zeros((P, G), dtype=i64, device=dev)
    tokens = torch.zeros(G, dtype=i64, device=dev)
    for p in range(P):
        la, _, _, mbase, shift, _, _ = t.passes[p].tolist()
        off_t, freq_t, base_t, nb_t, lsb_t, bad_t = _pass_luts(t, p, dev)
        start, end, ctx_base = t.streams[p].to(dev).unbind(1)
        gbase = mbase + ctx_base.cpu()[R["group"]]
        oo = t.order_off.cpu()[p].reshape(-1).to(i64)[R["bucket"] * 3 + R["c"]]
        rows = torch.stack([
            gbase + R["bctx"], gbase + nctx * NONZERO_BUCKETS
            + ZERO_DENSITY_CTX_COUNT * R["bctx"], R["li"], R["ti"], R["own"],
            R["cov"], R["l2c"], R["size"], R["maxnz"], R["sz16"], R["outb"],
            torch.where(oo >= 0, oo, ident)], 1).to(dev)
        cnt = torch.zeros(3 * N + 2, dtype=i64, device=dev)
        cnt[3 * N] = 32
        live = status == 0
        over = live & (start + 32 > end)
        state = torch.where(live & ~over,
                            (win[start >> 5] >> (start & 31)) & 0xFFFFFFFF, 0)
        pos = torch.where(live & ~over, start + 32, start)
        status |= torch.where(over, 16, 0)
        j, jend = 3 * gs[:-1].to(dev), 3 * gs[1:].to(dev)
        mode0 = torch.ones(G, dtype=torch.bool, device=dev)
        k, nzeros, prev = (torch.zeros(G, dtype=i64, device=dev)
                           for _ in range(3))
        active = live & ~over & (j < jend)
        while bool(active.any()):
            (nzb, zdb, li, ti, own, cov, l2c, size, maxnz, sz16, outb,
             oo_r) = rows[j.clamp(max=3 * N - 1)].unbind(1)
            # the context and its cluster's slot
            ctx = torch.where(
                mode0, nzb + nzlut[(cnt[li] + cnt[ti] + 1) >> 1],
                zdb + knz2[(nzeros + cov - 1) >> l2c]
                + kf2[(k >> l2c).clamp(max=63)] + prev)
            slot = (cmap[ctx] << 12) | (state & 0xFFF)
            # the rANS state and its 16-bit refill
            st2 = freq_t[slot] * (state >> 12) + off_t[slot]
            want = active & (st2 < (1 << 16))
            over1 = want & (pos + 16 > end)
            ok = want & ~over1
            v16 = (win[pos >> 5] >> (pos & 31)) & 0xFFFF
            state = torch.where(want, (st2 << 16) | torch.where(ok, v16, 0),
                                torch.where(active, st2, state))
            pos = pos + torch.where(ok, 16, 0)
            # the hybrid uint's raw bits
            bad2 = active & bad_t[slot]
            n = torch.where(active, nb_t[slot], 0)
            over2 = (n > 0) & (pos + n > end)
            ok = (n > 0) & ~over2
            raw = (win[pos >> 5] >> (pos & 31)) & ((1 << n) - 1)
            u = base_t[slot] | (torch.where(ok, raw, 0) << lsb_t[slot])
            pos = pos + torch.where(ok, n, 0)
            tokens += active.to(i64)
            code = torch.where(over1 | over2, 16, 0) | torch.where(bad2, 2, 0)
            status |= code
            go = active & (code == 0)
            # a nonzero count: checked, and its spread kept for the context
            isnz = go & mode0
            bad8 = isnz & (u >= maxnz)
            status |= torch.where(bad8, 8, 0)
            isnz, go = isnz & ~bad8, go & ~bad8
            cnt[torch.where(isnz, own, 3 * N + 1)] = (u + cov - 1) >> l2c
            # a coefficient, added at its natural position
            iscf = go & ~mode0
            v = (u >> 1) ^ -(u & 1)
            nzv = v != 0
            wr = iscf & nzv
            nat = orders[(oo_r + k).clamp(max=orders.numel() - 1)]
            out.index_put_((torch.where(wr, outb + nat, t.total),),
                           torch.where(wr, v, 0) << shift, accumulate=True)
            nzeros = torch.where(iscf, nzeros - nzv.to(i64),
                                 torch.where(isnz, u, nzeros))
            k = torch.where(iscf, k + 1, torch.where(isnz, cov, k))
            prev = torch.where(iscf, nzv, torch.where(isnz, u <= sz16,
                                                      prev.bool())).to(i64)
            mode0 = mode0 & ~isnz
            bad9 = go & ~mode0 & (nzeros > 0) & (k >= size)
            status |= torch.where(bad9, 9, 0)
            adv = go & ~bad9 & ~mode0 & (nzeros == 0)
            j = j + adv.to(i64)
            mode0 = mode0 | adv
            active = go & ~bad9 & (j < jend)
        states[p] = state
        # the kernel flags a sum that leaves int32 (and stops after the pass)
        bad = torch.nonzero((out[:t.total] < _INT32[0])
                            | (out[:t.total] > _INT32[1]))[:, 0]
        status[torch.searchsorted(out_end, bad, right=True)] |= 32
    return Decoded(out[:t.total].to(torch.int32), status.to(torch.int32),
                   states, tokens)


def _codes(status: int):
    """The codes a status holds (8 and 9 share a bit, and one ends the
    decode before the other can occur)."""
    return ([c for c in (2, 16, 32) if status & c]
            + ([9] if status & 1 else [8] if status & 8 else []))


def check_groups(d: Decoded) -> None:
    """Raise BitstreamError naming each group whose decode failed (a
    status bit, or a stream whose final rANS state is not the
    signature); reads back the small status vectors (the only sync)."""
    status = d.status.cpu().numpy()
    states = d.states.cpu().numpy()
    bad = np.nonzero((status != 0) | (states != SIGNATURE_STATE).any(0))[0]
    if bad.size:
        what = []
        for g in bad[:8].tolist():
            s = int(status[g])
            if s:
                what.append(f"group {g}: status {s} (" + ", ".join(
                    ERRORS[c] for c in _codes(s)) + ")")
            else:
                what.append(f"group {g}: final rANS states "
                            f"{[hex(int(x)) for x in states[:, g]]}")
        raise BitstreamError(f"device AC entropy decode failed on groups "
                             f"{bad.tolist()}: " + "; ".join(what))
