"""jbrd box (JPEG bitstream reconstruction data) reader/writer.

The port's copy of ``jxl_coder_tpu/jpeg/jbrd.py``.  The standard-wire
half of JPEG<->JXL transcoding: libjxl's `construct`
(the reference's interop/JxlConstruction.hpp:45-102)
stores the JPEG's non-coefficient structure — marker order, APP/COM
payloads, quant/Huffman table metadata, scan scripts, restart interval,
scan padding bits — in a `jbrd` container box so `reconstructJPEG`
(JxlReconstruction.hpp:44-88) can re-emit the byte-identical JPEG from
the VarDCT-coded coefficients.

Wire format pinned empirically against libjxl 0.7 output
(docs/JBRD_FORMAT.md, research/jbrd_probe.py): a JXL-Fields bundle
(bit-packed LSB-first, zero-padded to byte) followed by a Brotli stream
of the APP/COM marker payload bytes (and any tail data after EOI).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from ..bitstream.reader import BitReader, BitstreamError
from ..bitstream.writer import BitWriter
from ..utils import brotli_ffi
from .parser import JpegData, JpegError


from .parser import JpegError


class JbrdError(JpegError):
    pass


# app_marker_type values (libjxl AppMarkerType)
APP_UNKNOWN, APP_ICC, APP_EXIF, APP_XMP = 0, 1, 2, 3

# component-id schemes
COMP_GRAY, COMP_YCBCR, COMP_RGB, COMP_CUSTOM = 0, 1, 2, 3


@dataclasses.dataclass
class JbrdHuffCode:
    is_ac: int
    id: int
    is_last: bool
    counts: List[int]          # 17 entries, sentinel included
    values: List[int]          # len == sum(counts); final value == 256


@dataclasses.dataclass
class JbrdQuant:
    precision: int
    index: int
    is_last: bool


@dataclasses.dataclass
class JbrdScanComponent:
    comp_idx: int
    dc_tbl: int
    ac_tbl: int


@dataclasses.dataclass
class JbrdScan:
    components: List[JbrdScanComponent]
    Ss: int = 0
    Se: int = 63
    Ah: int = 0
    Al: int = 0
    reset_points: List[int] = dataclasses.field(default_factory=list)
    extra_zero_runs: List[Tuple[int, int]] = dataclasses.field(
        default_factory=list)  # (block_idx, num_runs)


@dataclasses.dataclass
class JbrdData:
    is_gray: bool = False
    marker_order: List[int] = dataclasses.field(default_factory=list)
    app_marker_types: List[int] = dataclasses.field(default_factory=list)
    app_data: List[bytes] = dataclasses.field(default_factory=list)
    # full segment length (marker byte + 2-byte length + body) per app
    # marker; for non-UNKNOWN types (ICC/Exif/XMP) the body is rebuilt
    # from the codestream boxes and app_data holds b""
    app_lens: List[int] = dataclasses.field(default_factory=list)
    com_data: List[bytes] = dataclasses.field(default_factory=list)
    quant: List[JbrdQuant] = dataclasses.field(default_factory=list)
    component_type: int = COMP_YCBCR
    component_ids: List[int] = dataclasses.field(default_factory=list)
    quant_idx: List[int] = dataclasses.field(default_factory=list)
    huffman: List[JbrdHuffCode] = dataclasses.field(default_factory=list)
    scans: List[JbrdScan] = dataclasses.field(default_factory=list)
    restart_interval: int = 0
    inter_marker_data: List[bytes] = dataclasses.field(
        default_factory=list)
    tail_data: bytes = b""
    padding_bits: List[int] = dataclasses.field(default_factory=list)

    @property
    def num_components(self) -> int:
        if self.component_type == COMP_GRAY:
            return 1
        if self.component_type in (COMP_YCBCR, COMP_RGB):
            return 3
        return len(self.component_ids)


_U32_APP_TYPE = ((0, 0), (0, 1), (1, 2), (2, 4))
_U32_COUNT4 = ((0, 1), (0, 2), (0, 3), (0, 4))
_U32_NUM_HUFF = ((0, 4), (3, 2), (4, 10), (6, 26))
_U32_HUFF_COUNT = ((0, 0), (0, 1), (3, 2), (8, 0))
_U32_HUFF_VALUE = ((2, 0), (2, 4), (4, 8), (8, 1))
_U32_NUM_RESET = ((0, 0), (2, 1), (4, 4), (16, 20))
_U32_BLOCK_IDX = ((0, 0), (3, 1), (5, 9), (28, 41))
_U32_NUM_EZR = ((0, 0), (2, 1), (4, 4), (16, 20))
_U32_TAIL_LEN = ((0, 0), (8, 1), (16, 257), (22, 65793))


def _u32_write(bw: BitWriter, value: int, dists) -> None:
    bw.u32(value, *dists)


def parse_jbrd(payload: bytes, trace=None) -> JbrdData:
    """Parse a jbrd box payload into JbrdData."""
    br = BitReader(payload)
    if trace is not None:
        class _TBR:
            def __init__(self, inner):
                self._br = inner

            def u(self, n):
                p = self._br.pos
                v = self._br.u(n)
                trace(f"u({n})@{p} = {v}")
                return v

            def u32(self, *d_):
                p = self._br.pos
                v = self._br.u32(*d_)
                trace(f"u32@{p} = {v}")
                return v

            @property
            def pos(self):
                return self._br.pos

            def zero_pad_to_byte(self):
                self._br.zero_pad_to_byte()
        br = _TBR(br)
    d = JbrdData()
    d.is_gray = bool(br.u(1))
    while True:
        m = br.u(6) + 0xC0
        d.marker_order.append(m)
        if m == 0xD9:
            break
        if len(d.marker_order) > 16384:
            raise JbrdError("marker order too long")
    napp = sum(1 for m in d.marker_order if 0xE0 <= m <= 0xEF)
    ncom = sum(1 for m in d.marker_order if m == 0xFE)
    nscan = sum(1 for m in d.marker_order if m == 0xDA)
    ninter = sum(1 for m in d.marker_order if m == 0xFF)
    app_lens = []
    for _ in range(napp):
        d.app_marker_types.append(br.u32(*_U32_APP_TYPE))
        app_lens.append(br.u(16))
    d.app_lens = [n + 1 for n in app_lens]
    com_lens = [br.u(16) for _ in range(ncom)]
    nq = br.u32(*_U32_COUNT4)
    for i in range(nq):
        prec = br.u(1)
        idx = br.u(2)
        is_last = bool(br.u(1))
        d.quant.append(JbrdQuant(prec, idx, is_last))
    d.component_type = br.u(2)
    if d.component_type == COMP_CUSTOM:
        ncomp = br.u32(*_U32_COUNT4)
        d.component_ids = [br.u(8) for _ in range(ncomp)]
    elif d.component_type == COMP_GRAY:
        d.component_ids = [1]
    elif d.component_type == COMP_RGB:
        d.component_ids = [ord("R"), ord("G"), ord("B")]
    else:
        d.component_ids = [1, 2, 3]
    d.quant_idx = [br.u(2) for _ in range(len(d.component_ids))]
    nhuff = br.u32(*_U32_NUM_HUFF)
    for _ in range(nhuff):
        is_ac = br.u(1)
        hid = br.u(2)
        is_last = bool(br.u(1))
        counts = [br.u32(*_U32_HUFF_COUNT) for _ in range(17)]
        nsym = sum(counts)
        if not 0 < nsym <= 257:
            raise JbrdError("bad huffman symbol count")
        values = [br.u32(*_U32_HUFF_VALUE) for _ in range(nsym)]
        d.huffman.append(JbrdHuffCode(is_ac, hid, is_last, counts,
                                      values))
    # Scan section, pinned by bit forensics on libjxl-0.7 streams
    # (round 3, research/jbrd_prog_probe.py; ours->libjxl AND
    # libjxl->ours progressive byte-exactness confirm it): EVERY scan
    # leads with its component count (U32 Val(1..4)); field order is
    # Ss, Se, Al, Ah (Al FIRST); per-component order is (comp_idx,
    # ac_tbl, dc_tbl); then a 2-bit field observed zero on every
    # canonical stream, then the single global restart interval after
    # scan 0's field when DRI is present.
    for si in range(nscan):
        sc = JbrdScan(components=[])
        ncomp = br.u32(*_U32_COUNT4)
        sc.Ss = br.u(6)
        sc.Se = br.u(6)
        sc.Al = br.u(4)
        sc.Ah = br.u(4)
        for _ in range(ncomp):
            ci = br.u(2)
            ac = br.u(2)
            dc = br.u(2)
            sc.components.append(JbrdScanComponent(ci, dc, ac))
        if br.u32(*_U32_NUM_RESET):
            raise JbrdError("inline scan metadata not supported")
        if not d.scans and 0xDD in d.marker_order:
            d.restart_interval = br.u(16)
        d.scans.append(sc)
    blob = None
    tail_from_blob = False
    save_pos = br.pos
    try:
        # pooled per-scan [num_reset_points u32][num_extra_zero_runs
        # u32] (entry layouts unpinned: nonzero counts raise), then
        # tail length + padding.  NO extensions field (ours->libjxl
        # progressive byte-exactness pins its absence).
        for sc in d.scans:
            if br.u32(*_U32_NUM_RESET) or br.u32(*_U32_NUM_EZR):
                raise JbrdError(
                    "reset-point / extra-zero-run entries not "
                    "supported")
        inter_lens = [br.u(16) for _ in range(ninter)]
        tail_len = br.u32(*_U32_TAIL_LEN)
        has_padding = bool(br.u(1))
        if has_padding:
            npad = br.u(24)
            d.padding_bits = [br.u(1) for _ in range(npad)]
        br.zero_pad_to_byte()
        blob = brotli_ffi.decompress(payload[br.pos // 8:])
    except Exception as first_err:
        # Progressive libjxl bundles carry a variable-length all-zero
        # region between the scan list and the brotli blob whose exact
        # field structure is unpinned.  The information it could carry
        # is recoverable/ignorable for canonical streams (tail length
        # falls out of the blob, padding is the all-ones default), so:
        # verify the gap is all zero, locate the blob by trial
        # decompression, and take the tail from the blob remainder.
        if ninter:
            raise
        inter_lens = []
        d.padding_bits = []
        min_blob = sum(n + 1 for i, n in enumerate(app_lens)
                       if d.app_marker_types[i] == APP_UNKNOWN) \
            + sum(n + 1 for n in com_lens)
        start_byte = -(-save_pos // 8)
        blob = None
        for k in range(start_byte, len(payload)):
            br2 = BitReader(payload)
            br2.pos = save_pos
            bits_ok = all(br2.u(1) == 0
                          for _ in range(k * 8 - save_pos))
            if not bits_ok:
                break
            try:
                cand = brotli_ffi.decompress(payload[k:])
            except Exception:
                continue
            if len(cand) >= min_blob:
                blob = cand
                break
        if blob is None:
            raise JbrdError(
                "unparseable jbrd trailing section") from first_err
        tail_len = None
        tail_from_blob = True
    pos = 0
    # payloads ride in marker_order traversal order
    app_i = com_i = inter_i = 0
    app_payloads = [b""] * napp
    com_payloads = [b""] * ncom
    inter_payloads = [b""] * ninter
    for m in d.marker_order:
        if 0xE0 <= m <= 0xEF:
            if d.app_marker_types[app_i] != APP_UNKNOWN:
                # ICC/Exif/XMP payloads are reconstructed from the
                # codestream / Exif / xml boxes, not stored here; the
                # bundle only records the segment length (kept in
                # d.app_lens, app_data stays b"").
                app_i += 1
                continue
            n = app_lens[app_i] + 1
            app_payloads[app_i] = blob[pos:pos + n]
            pos += n
            app_i += 1
        elif m == 0xFE:
            n = com_lens[com_i] + 1
            com_payloads[com_i] = blob[pos:pos + n]
            pos += n
            com_i += 1
        elif m == 0xFF:
            n = inter_lens[inter_i]
            inter_payloads[inter_i] = blob[pos:pos + n]
            pos += n
            inter_i += 1
    d.app_data = app_payloads
    d.com_data = com_payloads
    d.inter_marker_data = inter_payloads
    if tail_from_blob:
        # trailing-section fallback: whatever the marker payloads did
        # not consume is the after-EOI tail data
        d.tail_data = blob[pos:]
        return d
    d.tail_data = blob[pos:pos + tail_len]
    pos += tail_len
    if pos != len(blob):
        raise JbrdError("jbrd brotli payload size mismatch "
                        f"({pos} consumed of {len(blob)})")
    return d


def write_jbrd(d: JbrdData) -> bytes:
    """Serialize JbrdData to a jbrd box payload."""
    bw = BitWriter()
    bw.u(1 if d.is_gray else 0, 1)
    for m in d.marker_order:
        bw.u(m - 0xC0, 6)
    for i, m in enumerate([m for m in d.marker_order
                           if 0xE0 <= m <= 0xEF]):
        _u32_write(bw, d.app_marker_types[i], _U32_APP_TYPE)
        seglen = (d.app_lens[i] if i < len(d.app_lens) and d.app_lens[i]
                  else len(d.app_data[i]))
        bw.u(seglen - 1, 16)
    for i, _ in enumerate([m for m in d.marker_order if m == 0xFE]):
        bw.u(len(d.com_data[i]) - 1, 16)
    _u32_write(bw, len(d.quant), _U32_COUNT4)
    for q in d.quant:
        bw.u(q.precision, 1)
        bw.u(q.index, 2)
        bw.u(1 if q.is_last else 0, 1)
    bw.u(d.component_type, 2)
    if d.component_type == COMP_CUSTOM:
        _u32_write(bw, len(d.component_ids), _U32_COUNT4)
        for cid in d.component_ids:
            bw.u(cid, 8)
    for qi in d.quant_idx:
        bw.u(qi, 2)
    _u32_write(bw, len(d.huffman), _U32_NUM_HUFF)
    for h in d.huffman:
        bw.u(h.is_ac, 1)
        bw.u(h.id, 2)
        bw.u(1 if h.is_last else 0, 1)
        for c in h.counts:
            _u32_write(bw, c, _U32_HUFF_COUNT)
        for v in h.values:
            _u32_write(bw, v, _U32_HUFF_VALUE)
    # scan section (grammar pinned round 3; see parse_jbrd): per scan
    # [count][Ss][Se][Al][Ah][comps (idx, ac, dc)][resets][ri?][2x0]
    for si, sc in enumerate(d.scans):
        if not 1 <= len(sc.components) <= 4:
            raise JbrdError(
                f"scan {si}: {len(sc.components)} components not "
                "expressible in the jbrd bundle")
        _u32_write(bw, len(sc.components), _U32_COUNT4)
        bw.u(sc.Ss, 6)
        bw.u(sc.Se, 6)
        bw.u(sc.Al, 4)
        bw.u(sc.Ah, 4)
        for c in sc.components:
            bw.u(c.comp_idx, 2)
            bw.u(c.ac_tbl, 2)
            bw.u(c.dc_tbl, 2)
        if sc.reset_points or sc.extra_zero_runs:
            raise JbrdError(
                "reset-point / extra-zero-run entries not supported")
        bw.u(0, 2)                       # unknown per-scan field
        if si == 0 and 0xDD in d.marker_order:
            bw.u(d.restart_interval, 16)
    # pooled per-scan reset/extra-zero-run counts (both empty)
    for _sc in d.scans:
        _u32_write(bw, 0, _U32_NUM_RESET)
        _u32_write(bw, 0, _U32_NUM_EZR)
    for b in d.inter_marker_data:
        bw.u(len(b), 16)
    _u32_write(bw, len(d.tail_data), _U32_TAIL_LEN)
    if d.padding_bits:
        bw.u(1, 1)
        bw.u(len(d.padding_bits), 24)
        for bit in d.padding_bits:
            bw.u(bit, 1)
    else:
        bw.u(0, 1)
    # no extensions field (pinned by ours->libjxl progressive
    # byte-exactness: with one, libjxl rejects multi-scan bundles;
    # single-scan bundles coincided bit-for-bit either way)
    bw.zero_pad_to_byte()
    blob = bytearray()
    app_i = com_i = inter_i = 0
    for m in d.marker_order:
        if 0xE0 <= m <= 0xEF:
            blob += d.app_data[app_i]
            app_i += 1
        elif m == 0xFE:
            blob += d.com_data[com_i]
            com_i += 1
        elif m == 0xFF:
            blob += d.inter_marker_data[inter_i]
            inter_i += 1
    blob += d.tail_data
    return bw.to_bytes() + brotli_ffi.compress(bytes(blob))


def _add_sentinel(counts: List[int], values: List[int]
                  ) -> Tuple[List[int], List[int]]:
    """libjxl stores the DHT table with a sentinel symbol 256 appended at
    the deepest used code length (the all-ones code of an incomplete
    JPEG code)."""
    counts = list(counts) + [0] * (17 - len(counts))
    max_len = 0
    for ln in range(16, 0, -1):
        if counts[ln]:
            max_len = ln
            break
    if max_len == 0:
        raise JbrdError("empty huffman table")
    counts = list(counts)
    counts[max_len] += 1
    return counts, list(values) + [256]


def strip_sentinel(h: JbrdHuffCode) -> Tuple[List[int], List[int]]:
    """Inverse of _add_sentinel: JPEG DHT counts (16 entries) + values."""
    counts = list(h.counts)
    values = list(h.values)
    if not values or values[-1] != 256:
        raise JbrdError("huffman code lacks sentinel")
    max_len = 0
    for ln in range(16, -1, -1):
        if counts[ln]:
            max_len = ln
            break
    counts[max_len] -= 1
    return counts[1:17], values[:-1]


def jbrd_from_jpeg(j: JpegData) -> JbrdData:
    """Build the reconstruction bundle from a parsed JPEG."""
    d = JbrdData()
    ncomp = len(j.components)
    d.is_gray = ncomp == 1
    d.marker_order = list(j.marker_order)
    d.app_marker_types = [APP_UNKNOWN] * len(j.app_payloads)
    d.app_data = list(j.app_payloads)
    d.app_lens = [len(p) for p in j.app_payloads]
    d.com_data = list(j.com_payloads)
    d.quant = [JbrdQuant(p, i, last) for (p, i, last) in j.dqt_meta]
    ids = [c.id for c in j.components]
    if ncomp == 1 and ids == [1]:
        d.component_type = COMP_GRAY
    elif ncomp == 3 and ids == [1, 2, 3]:
        d.component_type = COMP_YCBCR
    elif ncomp == 3 and ids == [ord("R"), ord("G"), ord("B")]:
        d.component_type = COMP_RGB
    else:
        d.component_type = COMP_CUSTOM
    d.component_ids = ids
    d.quant_idx = [c.tq for c in j.components]
    for is_ac, hid, is_last, counts, values in j.dht_meta:
        cc, vv = _add_sentinel([0] + list(counts), values)
        d.huffman.append(JbrdHuffCode(is_ac, hid, is_last, cc, vv))
    comp_pos = {c.id: i for i, c in enumerate(j.components)}
    if getattr(j, "scans", None):
        for s in j.scans:
            d.scans.append(JbrdScan(
                components=[JbrdScanComponent(i, s.td[i], s.ta[i])
                            for i in s.comp_idx],
                Ss=s.Ss, Se=s.Se, Ah=s.Ah, Al=s.Al))
    else:
        d.scans = [JbrdScan(components=[
            JbrdScanComponent(comp_pos[cid], td, ta)
            for cid, td, ta in j.scan_components])]
    d.restart_interval = j.restart_interval
    d.tail_data = j.trailer_bytes[2:]  # bytes after EOI
    pads = list(j.padding_bits)
    d.padding_bits = pads if 0 in pads else []
    return d
