"""Byte-exact JPEG re-serialization from parsed coefficients (the port's
copy of ``jxl_coder_tpu/jpeg/writer.py``).

The reconstruct half of JPEG<->JXL transcoding: given JpegData (original
header/trailer bytes + coefficient planes + tables), re-encodes the
entropy scans deterministically so output == original input bytes.
Baseline Huffman coding is bijective given the tables; progressive
scans follow libjpeg's canonical strategy (maximal EOB runs flushed at
0x7FFF / restart / scan end, correction bits buffered with the pending
EOB run) — the convention every mainstream encoder uses and the one
libjxl's JPEG reconstruction assumes.
"""

from __future__ import annotations

import numpy as np

from .parser import JpegData, JpegError, _extend


class _ScanWriter:
    def __init__(self, padding_bits=None, pad_iter=None):
        self.out = bytearray()
        self.bitbuf = 0
        self.nbits = 0
        # explicit alignment filler bits (jbrd padding section); None
        # means the standard all-ones fill.  pad_iter shares one
        # iterator across the scans of a multi-scan file.
        self.pad_iter = pad_iter if pad_iter is not None else (
            iter(padding_bits) if padding_bits else None)

    def write_bits(self, value: int, n: int) -> None:
        for i in range(n - 1, -1, -1):
            self.bitbuf = (self.bitbuf << 1) | ((value >> i) & 1)
            self.nbits += 1
            if self.nbits == 8:
                b = self.bitbuf & 0xFF
                self.out.append(b)
                if b == 0xFF:
                    self.out.append(0x00)  # stuffing
                self.bitbuf = 0
                self.nbits = 0

    def flush(self) -> None:
        """Pad the final partial byte (all-ones, or the recorded
        padding bits when the source JPEG used zero filler)."""
        if self.nbits:
            pad = 8 - self.nbits
            if self.pad_iter is not None:
                bits = 0
                for _ in range(pad):
                    bits = (bits << 1) | next(self.pad_iter, 1)
                self.write_bits(bits, pad)
            else:
                self.write_bits((1 << pad) - 1, pad)

    def write_marker(self, byte: int) -> None:
        self.flush()
        self.out.append(0xFF)
        self.out.append(byte)


def _category(v: int) -> int:
    return int(abs(v)).bit_length()


def _encode_value(v: int, size: int) -> int:
    if v < 0:
        return v + (1 << size) - 1
    return v


def encode_scan(j: JpegData, sc, pad_iter=None) -> bytes:
    """Entropy-encode one scan (baseline or progressive) per its
    ScanInfo; returns the stuffed scan bytes (restart markers
    included, final byte padded)."""
    sw = _ScanWriter(pad_iter=pad_iter)
    comps = [j.components[i] for i in sc.comp_idx]
    if not j.progressive:
        _encode_baseline_scan(j, sc, comps, sw)
    elif sc.Ss == 0 and sc.Ah == 0:
        _encode_dc_first(j, sc, comps, sw)
    elif sc.Ss == 0:
        _encode_dc_refine(j, sc, comps, sw)
    elif sc.Ah == 0:
        _encode_ac_first(j, sc, comps[0], sw)
    else:
        _encode_ac_refine(j, sc, comps[0], sw)
    sw.flush()
    return bytes(sw.out)


def _encode_baseline_scan(j, sc, comps, sw) -> None:
    dc_enc = {t: tbl.build_encode() for t, tbl in sc.dc_tables.items()}
    ac_enc = {t: tbl.build_encode() for t, tbl in sc.ac_tables.items()}
    dc_pred = {c.id: 0 for c in comps}
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
                sw.write_marker(0xD0 + (rst_idx & 7))
                rst_idx = (rst_idx + 1) & 7
                for c in comps:
                    dc_pred[c.id] = 0
            for c in comps:
                ch = 1 if single else c.h
                cv = 1 if single else c.v
                for by in range(cv):
                    for bx in range(ch):
                        block = c.coeffs[my * cv + by, mx * ch + bx]
                        denc = dc_enc[c.td]
                        diff = int(block[0]) - dc_pred[c.id]
                        dc_pred[c.id] = int(block[0])
                        size = _category(diff)
                        code, ln = denc[size]
                        sw.write_bits(code, ln)
                        if size:
                            sw.write_bits(_encode_value(diff, size),
                                          size)
                        aenc = ac_enc[c.ta]
                        nz = np.nonzero(block[1:])[0]
                        last_nz = (nz[-1] + 1) if len(nz) else 0
                        k = 1
                        run = 0
                        while k <= last_nz:
                            v = int(block[k])
                            if v == 0:
                                run += 1
                                k += 1
                                continue
                            while run >= 16:
                                code, ln = aenc[0xF0]
                                sw.write_bits(code, ln)
                                run -= 16
                            size = _category(v)
                            code, ln = aenc[(run << 4) | size]
                            sw.write_bits(code, ln)
                            sw.write_bits(_encode_value(v, size), size)
                            run = 0
                            k += 1
                        if last_nz < 63:
                            code, ln = aenc[0x00]
                            sw.write_bits(code, ln)
            mcu_count += 1


def _encode_dc_first(j, sc, comps, sw) -> None:
    dc_enc = {i: sc.dc_tables[sc.td[i]].build_encode()
              for i in sc.comp_idx}
    dc_pred = {i: 0 for i in sc.comp_idx}
    ri = sc.restart_interval
    rst_idx = 0
    unit = 0
    interleaved = len(comps) > 1

    def one(ci, c, by, bx):
        temp = int(c.coeffs[by, bx, 0]) >> sc.Al
        diff = temp - dc_pred[ci]
        dc_pred[ci] = temp
        size = _category(diff)
        code, ln = dc_enc[ci][size]
        sw.write_bits(code, ln)
        if size:
            sw.write_bits(_encode_value(diff, size), size)

    if interleaved:
        for my in range(j.mcus_y):
            for mx in range(j.mcus_x):
                if ri and unit and unit % ri == 0:
                    sw.write_marker(0xD0 + (rst_idx & 7))
                    rst_idx = (rst_idx + 1) & 7
                    for i in sc.comp_idx:
                        dc_pred[i] = 0
                for ci, c in zip(sc.comp_idx, comps):
                    for by in range(c.v):
                        for bx in range(c.h):
                            one(ci, c, my * c.v + by, mx * c.h + bx)
                unit += 1
    else:
        ci, c = sc.comp_idx[0], comps[0]
        bw, bh = j.comp_nonint_blocks(c)
        for by in range(bh):
            for bx in range(bw):
                if ri and unit and unit % ri == 0:
                    sw.write_marker(0xD0 + (rst_idx & 7))
                    rst_idx = (rst_idx + 1) & 7
                    dc_pred[ci] = 0
                one(ci, c, by, bx)
                unit += 1


def _encode_dc_refine(j, sc, comps, sw) -> None:
    ri = sc.restart_interval
    rst_idx = 0
    unit = 0
    if len(comps) > 1:
        for my in range(j.mcus_y):
            for mx in range(j.mcus_x):
                if ri and unit and unit % ri == 0:
                    sw.write_marker(0xD0 + (rst_idx & 7))
                    rst_idx = (rst_idx + 1) & 7
                for c in comps:
                    for by in range(c.v):
                        for bx in range(c.h):
                            v = int(c.coeffs[my * c.v + by,
                                             mx * c.h + bx, 0])
                            sw.write_bits((v >> sc.Al) & 1, 1)
                unit += 1
    else:
        c = comps[0]
        bw, bh = j.comp_nonint_blocks(c)
        for by in range(bh):
            for bx in range(bw):
                if ri and unit and unit % ri == 0:
                    sw.write_marker(0xD0 + (rst_idx & 7))
                    rst_idx = (rst_idx + 1) & 7
                v = int(c.coeffs[by, bx, 0])
                sw.write_bits((v >> sc.Al) & 1, 1)
                unit += 1


def _encode_ac_first(j, sc, c, sw) -> None:
    ci = sc.comp_idx[0]
    aenc = sc.ac_tables[sc.ta[ci]].build_encode()
    bw, bh = j.comp_nonint_blocks(c)
    ri = sc.restart_interval
    rst_idx = 0
    unit = 0
    eobrun = 0

    def emit_eobrun():
        nonlocal eobrun
        if eobrun > 0:
            nbits = eobrun.bit_length() - 1
            code, ln = aenc[nbits << 4]
            sw.write_bits(code, ln)
            if nbits:
                sw.write_bits(eobrun & ((1 << nbits) - 1), nbits)
            eobrun = 0

    for by in range(bh):
        for bx in range(bw):
            if ri and unit and unit % ri == 0:
                emit_eobrun()
                sw.write_marker(0xD0 + (rst_idx & 7))
                rst_idx = (rst_idx + 1) & 7
            unit += 1
            block = c.coeffs[by, bx]
            r = 0
            for k in range(sc.Ss, sc.Se + 1):
                temp = int(block[k])
                if temp == 0:
                    r += 1
                    continue
                if temp < 0:
                    t = (-temp) >> sc.Al
                    t2 = ~t
                else:
                    t = temp >> sc.Al
                    t2 = t
                if t == 0:                # vanishes at this precision
                    r += 1
                    continue
                emit_eobrun()
                while r > 15:
                    code, ln = aenc[0xF0]
                    sw.write_bits(code, ln)
                    r -= 16
                nbits = t.bit_length()
                code, ln = aenc[(r << 4) | nbits]
                sw.write_bits(code, ln)
                sw.write_bits(t2 & ((1 << nbits) - 1), nbits)
                r = 0
            if r > 0:
                eobrun += 1
                if eobrun == 0x7FFF:
                    emit_eobrun()
    emit_eobrun()


def _encode_ac_refine(j, sc, c, sw) -> None:
    """libjpeg encode_mcu_AC_refine: correction bits for nonzero
    history ride in a buffer flushed after the next emitted symbol."""
    ci = sc.comp_idx[0]
    aenc = sc.ac_tables[sc.ta[ci]].build_encode()
    bw, bh = j.comp_nonint_blocks(c)
    p_range = range(sc.Ss, sc.Se + 1)
    ri = sc.restart_interval
    rst_idx = 0
    unit = 0
    eobrun = 0
    bebuf = []                   # correction bits of the pending EOB run

    def emit_bits_list(bits):
        for b in bits:
            sw.write_bits(b, 1)

    def emit_eobrun():
        nonlocal eobrun
        if eobrun > 0:
            nbits = eobrun.bit_length() - 1
            code, ln = aenc[nbits << 4]
            sw.write_bits(code, ln)
            if nbits:
                sw.write_bits(eobrun & ((1 << nbits) - 1), nbits)
            eobrun = 0
            emit_bits_list(bebuf)
            bebuf.clear()

    for by in range(bh):
        for bx in range(bw):
            if ri and unit and unit % ri == 0:
                emit_eobrun()
                sw.write_marker(0xD0 + (rst_idx & 7))
                rst_idx = (rst_idx + 1) & 7
            unit += 1
            block = c.coeffs[by, bx]
            absval = {}
            EOB = sc.Ss - 1
            for k in p_range:
                v = int(block[k])
                t = (-v if v < 0 else v) >> sc.Al
                absval[k] = t
                if t == 1:
                    EOB = k
            r = 0
            brbuf = []
            for k in p_range:
                t = absval[k]
                if t == 0:
                    r += 1
                    continue
                while r > 15 and k <= EOB:
                    emit_eobrun()
                    code, ln = aenc[0xF0]
                    sw.write_bits(code, ln)
                    r -= 16
                    emit_bits_list(brbuf)
                    brbuf = []
                if t > 1:                  # already-nonzero history
                    brbuf.append(t & 1)
                    continue
                emit_eobrun()
                code, ln = aenc[(r << 4) | 1]
                sw.write_bits(code, ln)
                sw.write_bits(0 if int(block[k]) < 0 else 1, 1)
                emit_bits_list(brbuf)
                brbuf = []
                r = 0
            if r > 0 or brbuf:
                eobrun += 1
                bebuf.extend(brbuf)
                if eobrun == 0x7FFF or len(bebuf) > 937:
                    emit_eobrun()
    emit_eobrun()


def write_jpeg_multiscan(j: JpegData) -> bytes:
    """Re-serialize a multi-scan (progressive) JPEG from parsed scans:
    the recorded inter-scan header bytes + re-encoded entropy data."""
    pads = getattr(j, "padding_bits", None)
    pad_iter = iter(pads) if pads and 0 in pads else None
    out = bytearray()
    for sc in j.scans:
        out += sc.header_bytes
        out += encode_scan(j, sc, pad_iter=pad_iter)
    out += j.trailer_bytes
    return bytes(out)


def write_jpeg(j: JpegData) -> bytes:
    if j.progressive or len(j.scans) > 1:
        return write_jpeg_multiscan(j)
    dc_enc = {t: tbl.build_encode() for t, tbl in j.dc_tables.items()}
    ac_enc = {t: tbl.build_encode() for t, tbl in j.ac_tables.items()}
    pads = getattr(j, "padding_bits", None)
    sw = _ScanWriter(pads if pads and 0 in pads else None)
    dc_pred = {c.id: 0 for c in j.components}
    ri = j.restart_interval
    mcu_count = 0
    rst_idx = 0
    single = len(j.components) == 1
    for my in range(j.mcus_y):
        for mx in range(j.mcus_x):
            if ri and mcu_count and mcu_count % ri == 0:
                sw.write_marker(0xD0 + (rst_idx & 7))
                rst_idx = (rst_idx + 1) & 7
                for c in j.components:
                    dc_pred[c.id] = 0
            for c in j.components:
                ch = 1 if single else c.h
                cv = 1 if single else c.v
                for by in range(cv):
                    for bx in range(ch):
                        block = c.coeffs[my * c.v + by, mx * c.h + bx]
                        denc = dc_enc[c.td]
                        diff = int(block[0]) - dc_pred[c.id]
                        dc_pred[c.id] = int(block[0])
                        size = _category(diff)
                        code, ln = denc[size]
                        sw.write_bits(code, ln)
                        if size:
                            sw.write_bits(_encode_value(diff, size), size)
                        aenc = ac_enc[c.ta]
                        k = 1
                        run = 0
                        last_nz = 0
                        nz = np.nonzero(block[1:])[0]
                        last_nz = (nz[-1] + 1) if len(nz) else 0
                        while k <= last_nz:
                            v = int(block[k])
                            if v == 0:
                                run += 1
                                k += 1
                                continue
                            while run >= 16:
                                code, ln = aenc[0xF0]
                                sw.write_bits(code, ln)
                                run -= 16
                            size = _category(v)
                            code, ln = aenc[(run << 4) | size]
                            sw.write_bits(code, ln)
                            sw.write_bits(_encode_value(v, size), size)
                            run = 0
                            k += 1
                        if last_nz < 63:
                            code, ln = aenc[0x00]  # EOB
                            sw.write_bits(code, ln)
            mcu_count += 1
    sw.flush()
    return bytes(j.header_bytes) + bytes(sw.out) + bytes(j.trailer_bytes)
