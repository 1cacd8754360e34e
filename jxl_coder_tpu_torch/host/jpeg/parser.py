"""Baseline JPEG parser: markers + Huffman scan decode to DCT coefficients.

Host-side front-end for lossless JPEG<->JXL transcoding, the capability
the reference exposes as construct/reconstructJPEG
(its interop/JxlConstruction.hpp:45-102 and JxlReconstruction.hpp:44-88
over libjxl's JPEG recompression).  The port's copy of
``jxl_coder_tpu/jpeg/parser.py``.

We parse the entropy-coded scan into quantized coefficient planes
(device-friendly layout) and keep every header byte verbatim so
writer.py can re-serialize the identical file.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63],
    np.int32)


class JpegError(ValueError):
    pass


@dataclasses.dataclass
class Component:
    id: int
    h: int  # horizontal sampling factor
    v: int
    tq: int  # quant table id
    td: int = 0  # DC huffman table (from SOS)
    ta: int = 0  # AC huffman table
    blocks_w: int = 0
    blocks_h: int = 0
    coeffs: Optional[np.ndarray] = None  # (blocks_h, blocks_w, 64) zigzag


@dataclasses.dataclass
class HuffTable:
    counts: List[int]
    symbols: List[int]

    def build_decode(self):
        """(code,length)->symbol dict + max length."""
        dec = {}
        code = 0
        k = 0
        for ln in range(1, 17):
            for _ in range(self.counts[ln - 1]):
                dec[(ln, code)] = self.symbols[k]
                code += 1
                k += 1
            code <<= 1
        return dec

    def build_encode(self):
        enc = {}
        code = 0
        k = 0
        for ln in range(1, 17):
            for _ in range(self.counts[ln - 1]):
                enc[self.symbols[k]] = (code, ln)
                code += 1
                k += 1
            code <<= 1
        return enc


@dataclasses.dataclass
class ScanInfo:
    """One SOS: component indices (into JpegData.components), spectral
    selection + successive approximation, the Huffman tables in effect,
    and the raw header bytes from the end of the previous scan through
    this SOS segment (for byte-exact re-serialization)."""
    comp_idx: List[int]
    Ss: int
    Se: int
    Ah: int
    Al: int
    td: Dict[int, int]                  # comp_idx -> DC table id
    ta: Dict[int, int]
    dc_tables: Dict[int, "HuffTable"]   # snapshot at scan time
    ac_tables: Dict[int, "HuffTable"]
    restart_interval: int = 0
    header_bytes: bytes = b""


@dataclasses.dataclass
class JpegData:
    width: int = 0
    height: int = 0
    precision: int = 8
    components: List[Component] = dataclasses.field(default_factory=list)
    quant: Dict[int, np.ndarray] = dataclasses.field(default_factory=dict)
    dc_tables: Dict[int, HuffTable] = dataclasses.field(default_factory=dict)
    ac_tables: Dict[int, HuffTable] = dataclasses.field(default_factory=dict)
    restart_interval: int = 0
    dri_count: int = 0          # jbrd stores ONE DRI; >1 is unrepresentable
    header_bytes: bytes = b""   # SOI .. end of SOS header (inclusive)
    trailer_bytes: bytes = b""  # EOI and anything after
    hmax: int = 1
    vmax: int = 1
    mcus_x: int = 0
    mcus_y: int = 0
    # jbrd-grade structure (jpeg/jbrd.py): everything needed to
    # regenerate the header bytes exactly
    marker_order: List[int] = dataclasses.field(default_factory=list)
    app_payloads: List[bytes] = dataclasses.field(default_factory=list)
    com_payloads: List[bytes] = dataclasses.field(default_factory=list)
    dqt_meta: List[Tuple[int, int, bool]] = dataclasses.field(
        default_factory=list)  # (precision, index, is_last) define order
    dht_meta: List[Tuple[int, int, bool, List[int], List[int]]] = \
        dataclasses.field(default_factory=list)
    # (is_ac, id, is_last, counts16, values) in definition order
    scan_components: List[Tuple[int, int, int]] = dataclasses.field(
        default_factory=list)  # (component_id, dc_tbl, ac_tbl)
    padding_bits: List[int] = dataclasses.field(default_factory=list)
    # scan alignment filler bits in file order (restarts + final)
    sof_marker: int = 0xC0
    progressive: bool = False
    scans: List["ScanInfo"] = dataclasses.field(default_factory=list)

    def comp_nonint_blocks(self, c: "Component") -> Tuple[int, int]:
        """Block dims for a NON-interleaved scan of component c (the
        component's true sample grid, NOT padded to MCU multiples)."""
        sw = -(-self.width * c.h // self.hmax)
        sh = -(-self.height * c.v // self.vmax)
        return -(-sw // 8), -(-sh // 8)


class _ScanReader:
    """MSB-first bit reader over entropy-coded data with 0xFF00 unstuffing
    and restart-marker handling."""

    def __init__(self, data: bytes, pos: int):
        self.data = data
        self.pos = pos
        self.bitbuf = 0
        self.nbits = 0

    def _next_byte(self) -> int:
        if self.pos >= len(self.data):
            raise JpegError("unexpected end of scan data")
        b = self.data[self.pos]
        self.pos += 1
        if b == 0xFF:
            nxt = self.data[self.pos] if self.pos < len(self.data) else None
            if nxt == 0x00:
                self.pos += 1
                return 0xFF
            # a marker: signal by raising; caller should have handled RST
            raise JpegError(f"marker 0xFF{nxt:02X} inside scan")
        return b

    def read_bit(self) -> int:
        if self.nbits == 0:
            self.bitbuf = self._next_byte()
            self.nbits = 8
        self.nbits -= 1
        return (self.bitbuf >> self.nbits) & 1

    def read_bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.read_bit()
        return v

    def drain_padding(self, out: list) -> None:
        """Append the unread bits of the current byte (the encoder's
        alignment filler, MSB-first file order) to `out`."""
        for i in range(self.nbits - 1, -1, -1):
            out.append((self.bitbuf >> i) & 1)
        self.nbits = 0

    def align_and_expect_rst(self, idx: int, pads: list) -> None:
        """Skip to byte boundary and consume RSTn marker."""
        self.drain_padding(pads)
        if self.pos + 1 >= len(self.data):
            raise JpegError("missing restart marker")
        if self.data[self.pos] != 0xFF or \
                (self.data[self.pos + 1] & 0xF8) != 0xD0:
            raise JpegError("expected restart marker")
        if (self.data[self.pos + 1] & 7) != (idx & 7):
            raise JpegError("restart marker out of sequence")
        self.pos += 2

    def read_symbol(self, dec) -> int:
        code = 0
        for ln in range(1, 17):
            code = (code << 1) | self.read_bit()
            s = dec.get((ln, code))
            if s is not None:
                return s
        raise JpegError("invalid huffman code in scan")


def _extend(v: int, size: int) -> int:
    if size == 0:
        return 0
    if v < (1 << (size - 1)):
        return v - (1 << size) + 1
    return v


def parse_jpeg(data: bytes) -> JpegData:
    if data[:2] != b"\xff\xd8":
        raise JpegError("not a JPEG (missing SOI)")
    j = JpegData()
    pos = 2
    sos_pos = None
    prev_scan_end = 0
    while pos < len(data):
        if data[pos] != 0xFF:
            raise JpegError(f"expected marker at {pos}")
        marker = data[pos + 1]
        if marker == 0xD8:
            pos += 2
            continue
        if marker == 0xD9:  # EOI
            if sos_pos is None:
                raise JpegError("EOI before scan")
            break
        seg_len = int.from_bytes(data[pos + 2:pos + 4], "big")
        seg = data[pos + 4:pos + 2 + seg_len]
        j.marker_order.append(marker)
        if marker == 0xDB:  # DQT
            p = 0
            while p < len(seg):
                pq, tq = seg[p] >> 4, seg[p] & 15
                p += 1
                n = 64 * (2 if pq else 1)
                if pq:
                    tbl = np.frombuffer(seg[p:p + 128], ">u2").astype(
                        np.int32)
                else:
                    tbl = np.frombuffer(seg[p:p + 64], np.uint8).astype(
                        np.int32)
                j.quant[tq] = tbl
                p += n
                j.dqt_meta.append((pq, tq, p >= len(seg)))
        elif marker in (0xC0, 0xC1, 0xC2):  # SOF0/1 baseline, SOF2 prog
            j.sof_marker = marker
            j.progressive = marker == 0xC2
            j.precision = seg[0]
            j.height = int.from_bytes(seg[1:3], "big")
            j.width = int.from_bytes(seg[3:5], "big")
            ncomp = seg[5]
            for i in range(ncomp):
                cid, hv, tq = seg[6 + 3 * i:9 + 3 * i]
                j.components.append(Component(cid, hv >> 4, hv & 15, tq))
        elif marker == 0xC4:  # DHT
            p = 0
            while p < len(seg):
                tc, th = seg[p] >> 4, seg[p] & 15
                counts = list(seg[p + 1:p + 17])
                nsym = sum(counts)
                syms = list(seg[p + 17:p + 17 + nsym])
                tbl = HuffTable(counts, syms)
                (j.ac_tables if tc else j.dc_tables)[th] = tbl
                p += 17 + nsym
                j.dht_meta.append((tc, th, p >= len(seg), counts, syms))
        elif marker == 0xDD:  # DRI
            j.restart_interval = int.from_bytes(seg[:2], "big")
            j.dri_count += 1
        elif 0xE0 <= marker <= 0xEF:  # APPn
            j.app_payloads.append(data[pos + 1:pos + 2 + seg_len])
        elif marker == 0xFE:  # COM
            j.com_payloads.append(data[pos + 1:pos + 2 + seg_len])
        elif marker == 0xDA:  # SOS
            if not j.components:
                raise JpegError("SOS before SOF")
            if sos_pos is None:
                # geometry on first scan
                j.hmax = max(c.h for c in j.components)
                j.vmax = max(c.v for c in j.components)
                j.mcus_x = -(-j.width // (8 * j.hmax))
                j.mcus_y = -(-j.height // (8 * j.vmax))
                for c in j.components:
                    c.blocks_w = j.mcus_x * c.h
                    c.blocks_h = j.mcus_y * c.v
                    c.coeffs = np.zeros((c.blocks_h, c.blocks_w, 64),
                                        np.int32)
            ns = seg[0]
            comp_idx = []
            td = {}
            ta = {}
            for i in range(ns):
                cid, tt = seg[1 + 2 * i], seg[2 + 2 * i]
                for ci, c in enumerate(j.components):
                    if c.id == cid:
                        c.td, c.ta = tt >> 4, tt & 15
                        comp_idx.append(ci)
                        td[ci] = tt >> 4
                        ta[ci] = tt & 15
                j.scan_components.append((cid, tt >> 4, tt & 15))
            Ss, Se = seg[1 + 2 * ns], seg[2 + 2 * ns]
            AhAl = seg[3 + 2 * ns]
            sc = ScanInfo(comp_idx=comp_idx, Ss=Ss, Se=Se,
                          Ah=AhAl >> 4, Al=AhAl & 15, td=td, ta=ta,
                          dc_tables=dict(j.dc_tables),
                          ac_tables=dict(j.ac_tables),
                          restart_interval=j.restart_interval)
            sos_end = pos + 2 + seg_len
            if sos_pos is None:
                j.header_bytes = data[:sos_end]
                sc.header_bytes = j.header_bytes
            else:
                sc.header_bytes = data[prev_scan_end:sos_end]
            sos_pos = sos_end
            j.scans.append(sc)
            rd = _ScanReader(data, sos_end)
            _decode_scan(j, rd, sc)
            rd.drain_padding(j.padding_bits)
            tpos = rd.pos
            while tpos < len(data) and not (
                    data[tpos] == 0xFF
                    and data[tpos + 1:tpos + 2] != b"\x00"):
                tpos += 1
            prev_scan_end = tpos
            pos = tpos
            continue
        pos += 2 + seg_len
    if sos_pos is None:
        raise JpegError("no SOS marker found")
    j.trailer_bytes = data[prev_scan_end:]
    j.marker_order.append(0xD9)
    return j


def _decode_scan(j: JpegData, rd: "_ScanReader", sc: ScanInfo) -> None:
    """Decode one entropy-coded scan into the component coefficient
    planes (baseline full scan, or one progressive DC/AC
    first/refinement pass)."""
    comps = [j.components[i] for i in sc.comp_idx]
    if not j.progressive:
        _decode_baseline_scan(j, rd, sc, comps)
        return
    if sc.Ss == 0:
        if sc.Se != 0:
            raise JpegError("progressive DC scan with Se != 0")
        if sc.Ah == 0:
            _decode_dc_first(j, rd, sc, comps)
        else:
            _decode_dc_refine(j, rd, sc, comps)
    else:
        if len(comps) != 1:
            raise JpegError("progressive AC scan must be single-component")
        if sc.Ah == 0:
            _decode_ac_first(j, rd, sc, comps[0])
        else:
            _decode_ac_refine(j, rd, sc, comps[0])


def _decode_baseline_scan(j, rd, sc, comps) -> None:
    dc_pred = {c.id: 0 for c in comps}
    dc_dec = {t: tbl.build_decode() for t, tbl in sc.dc_tables.items()}
    ac_dec = {t: tbl.build_decode() for t, tbl in sc.ac_tables.items()}
    ri = sc.restart_interval
    mcu_count = 0
    rst_idx = 0
    single = len(comps) == 1
    mcus_x, mcus_y = j.mcus_x, j.mcus_y
    if single and len(j.components) > 1:
        mcus_x, mcus_y = j.comp_nonint_blocks(comps[0])
    for my in range(mcus_y):
        for mx in range(mcus_x):
            if ri and mcu_count and mcu_count % ri == 0:
                rd.align_and_expect_rst(rst_idx, j.padding_bits)
                rst_idx = (rst_idx + 1) & 7
                for c in comps:
                    dc_pred[c.id] = 0
            for c in comps:
                ch = 1 if single else c.h
                cv = 1 if single else c.v
                for by in range(cv):
                    for bx in range(ch):
                        block = np.zeros(64, np.int32)
                        s = rd.read_symbol(dc_dec[c.td])
                        diff = _extend(rd.read_bits(s), s)
                        dc_pred[c.id] += diff
                        block[0] = dc_pred[c.id]
                        k = 1
                        while k < 64:
                            rs = rd.read_symbol(ac_dec[c.ta])
                            if rs == 0x00:  # EOB
                                break
                            if rs == 0xF0:  # ZRL
                                k += 16
                                continue
                            run, size = rs >> 4, rs & 15
                            k += run
                            if k > 63:
                                raise JpegError("AC index overflow")
                            block[k] = _extend(rd.read_bits(size), size)
                            k += 1
                        c.coeffs[my * (1 if single else c.v) + by,
                                 mx * (1 if single else c.h) + bx] = block
            mcu_count += 1


def _decode_dc_first(j, rd, sc, comps) -> None:
    dc_dec = {i: sc.dc_tables[sc.td[i]].build_decode()
              for i in sc.comp_idx}
    dc_pred = {i: 0 for i in sc.comp_idx}
    ri = sc.restart_interval
    rst_idx = 0
    unit = 0
    interleaved = len(comps) > 1

    def one_block(ci, c, by, bx):
        s = rd.read_symbol(dc_dec[ci])
        diff = _extend(rd.read_bits(s), s)
        dc_pred[ci] += diff
        c.coeffs[by, bx, 0] = dc_pred[ci] << sc.Al

    if interleaved:
        for my in range(j.mcus_y):
            for mx in range(j.mcus_x):
                if ri and unit and unit % ri == 0:
                    rd.align_and_expect_rst(rst_idx, j.padding_bits)
                    rst_idx = (rst_idx + 1) & 7
                    for i in sc.comp_idx:
                        dc_pred[i] = 0
                for ci, c in zip(sc.comp_idx, comps):
                    for by in range(c.v):
                        for bx in range(c.h):
                            one_block(ci, c, my * c.v + by,
                                      mx * c.h + bx)
                unit += 1
    else:
        ci, c = sc.comp_idx[0], comps[0]
        bw, bh = j.comp_nonint_blocks(c)
        for by in range(bh):
            for bx in range(bw):
                if ri and unit and unit % ri == 0:
                    rd.align_and_expect_rst(rst_idx, j.padding_bits)
                    rst_idx = (rst_idx + 1) & 7
                    dc_pred[ci] = 0
                one_block(ci, c, by, bx)
                unit += 1


def _decode_dc_refine(j, rd, sc, comps) -> None:
    p1 = 1 << sc.Al
    ri = sc.restart_interval
    rst_idx = 0
    unit = 0
    if len(comps) > 1:
        for my in range(j.mcus_y):
            for mx in range(j.mcus_x):
                if ri and unit and unit % ri == 0:
                    rd.align_and_expect_rst(rst_idx, j.padding_bits)
                    rst_idx = (rst_idx + 1) & 7
                for c in comps:
                    for by in range(c.v):
                        for bx in range(c.h):
                            if rd.read_bit():
                                c.coeffs[my * c.v + by,
                                         mx * c.h + bx, 0] |= p1
                unit += 1
    else:
        c = comps[0]
        bw, bh = j.comp_nonint_blocks(c)
        for by in range(bh):
            for bx in range(bw):
                if ri and unit and unit % ri == 0:
                    rd.align_and_expect_rst(rst_idx, j.padding_bits)
                    rst_idx = (rst_idx + 1) & 7
                if rd.read_bit():
                    c.coeffs[by, bx, 0] |= p1
                unit += 1


def _decode_ac_first(j, rd, sc, c) -> None:
    ci = sc.comp_idx[0]
    ac_dec = sc.ac_tables[sc.ta[ci]].build_decode()
    bw, bh = j.comp_nonint_blocks(c)
    ri = sc.restart_interval
    rst_idx = 0
    unit = 0
    eobrun = 0
    for by in range(bh):
        for bx in range(bw):
            if ri and unit and unit % ri == 0:
                rd.align_and_expect_rst(rst_idx, j.padding_bits)
                rst_idx = (rst_idx + 1) & 7
                eobrun = 0
            unit += 1
            if eobrun:
                eobrun -= 1
                continue
            block = c.coeffs[by, bx]
            k = sc.Ss
            while k <= sc.Se:
                rs = rd.read_symbol(ac_dec)
                r, s = rs >> 4, rs & 15
                if s == 0:
                    if r < 15:
                        eobrun = (1 << r) - 1
                        if r:
                            eobrun += rd.read_bits(r)
                        break
                    k += 16                   # ZRL
                    continue
                k += r
                if k > sc.Se:
                    raise JpegError("AC index overflow in scan")
                block[k] = _extend(rd.read_bits(s), s) << sc.Al
                k += 1


def _decode_ac_refine(j, rd, sc, c) -> None:
    """libjpeg decode_mcu_AC_refine semantics."""
    ci = sc.comp_idx[0]
    ac_dec = sc.ac_tables[sc.ta[ci]].build_decode()
    bw, bh = j.comp_nonint_blocks(c)
    p1 = 1 << sc.Al
    m1 = -1 << sc.Al
    ri = sc.restart_interval
    rst_idx = 0
    unit = 0
    eobrun = 0

    def correct(block, k):
        if rd.read_bit():
            v = int(block[k])
            if (v & p1) == 0:
                block[k] = v + (p1 if v >= 0 else m1)

    for by in range(bh):
        for bx in range(bw):
            if ri and unit and unit % ri == 0:
                rd.align_and_expect_rst(rst_idx, j.padding_bits)
                rst_idx = (rst_idx + 1) & 7
                eobrun = 0
            unit += 1
            block = c.coeffs[by, bx]
            k = sc.Ss
            if eobrun == 0:
                while k <= sc.Se:
                    rs = rd.read_symbol(ac_dec)
                    r, s = rs >> 4, rs & 15
                    val = 0
                    if s:
                        if s != 1:
                            raise JpegError(
                                "bad magnitude in AC refinement")
                        val = p1 if rd.read_bit() else m1
                    else:
                        if r != 15:
                            eobrun = 1 << r
                            if r:
                                eobrun += rd.read_bits(r)
                            break
                    # advance over the band: correction bits for
                    # nonzero history, count down r over zero history
                    while k <= sc.Se:
                        if block[k] != 0:
                            correct(block, k)
                        else:
                            if r == 0:
                                break
                            r -= 1
                        k += 1
                    if s and k <= sc.Se:
                        block[k] = val
                    k += 1
            if eobrun > 0:
                # EOB region: correction bits only, for the rest of
                # the band
                while k <= sc.Se:
                    if block[k] != 0:
                        correct(block, k)
                    k += 1
                eobrun -= 1
