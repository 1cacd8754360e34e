"""Brotli-style prefix codes (ISO/IEC 18181-1 §C.2.2, identical to RFC 7932
§3.4-3.5 Huffman code serialization).

This is one of the two symbol-coding backends of the JPEG XL entropy layer
(the other is rANS, ans.py).  The host reference path decodes these; group
streams are independent, which is what the TPU group-grid sharding exploits
(SURVEY.md §2.6).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from ..bitstream.reader import BitReader, BitstreamError
from ..bitstream.writer import BitWriter

MAX_LENGTH = 15

# Fixed prefix code for the code-length code (RFC 7932 §3.5), indexed by a
# 4-bit LSB-first peek: (nbits, symbol).
_CL_FIXED = [
    (2, 0), (2, 4), (2, 3), (3, 2), (2, 0), (2, 4), (2, 3), (4, 1),
    (2, 0), (2, 4), (2, 3), (3, 2), (2, 0), (2, 4), (2, 3), (4, 5),
]

_CL_ORDER = [1, 2, 3, 4, 0, 5, 17, 6, 16, 7, 8, 9, 10, 11, 12, 13, 14, 15]


def ceil_log2(x: int) -> int:
    """Bits needed to represent values 0..x-1; CeilLog2Nonzero(x)."""
    if x <= 1:
        return 0
    return (x - 1).bit_length()


class PrefixCode:
    """Canonical prefix decode/encode table."""

    def __init__(self, lengths: List[int]):
        self.lengths = lengths
        self.codes = _canonical_codes(lengths)
        # decode map: (length, code) -> symbol
        self._dec: Dict[Tuple[int, int], int] = {}
        for sym, (ln, code) in enumerate(zip(lengths, self.codes)):
            if ln > 0:
                self._dec[(ln, code)] = sym
        nz = [s for s, ln in enumerate(lengths) if ln > 0]
        self._single = nz[0] if len(nz) == 1 else None

    def read(self, br: BitReader) -> int:
        if self._single is not None:
            return self._single
        code = 0
        for ln in range(1, MAX_LENGTH + 1):
            code |= br.u(1) << (ln - 1)
            sym = self._dec.get((ln, code))
            if sym is not None:
                return sym
        raise BitstreamError("invalid prefix code word")

    def write(self, bw: BitWriter, symbol: int) -> None:
        ln = self.lengths[symbol]
        if self._single is not None:
            if symbol != self._single:
                raise ValueError("symbol not in single-symbol code")
            return
        if ln == 0:
            raise ValueError(f"symbol {symbol} has no code")
        bw.u(self.codes[symbol], ln)


def _canonical_codes(lengths: List[int]) -> List[int]:
    """Brotli canonical code assignment; codes stored bit-reversed so they
    can be written/read LSB-first."""
    max_len = max(lengths) if lengths else 0
    bl_count = [0] * (max_len + 1)
    for ln in lengths:
        if ln:
            bl_count[ln] += 1
    next_code = [0] * (max_len + 2)
    code = 0
    for ln in range(1, max_len + 1):
        code = (code + bl_count[ln - 1]) << 1
        next_code[ln] = code
    codes = [0] * len(lengths)
    for sym, ln in enumerate(lengths):
        if ln:
            c = next_code[ln]
            next_code[ln] += 1
            codes[sym] = _reverse_bits(c, ln)
    return codes


def _reverse_bits(v: int, n: int) -> int:
    r = 0
    for _ in range(n):
        r = (r << 1) | (v & 1)
        v >>= 1
    return r


# --------------------------------------------------------------------------
# Reading a serialized prefix code

def read_prefix_code(br: BitReader, alphabet_size: int) -> PrefixCode:
    if alphabet_size <= 0:
        raise BitstreamError("bad alphabet size")
    if alphabet_size == 1:
        return PrefixCode([1])  # degenerate: always symbol 0, no bits
    hskip = br.u(2)
    if hskip == 1:
        return _read_simple(br, alphabet_size)
    return _read_complex(br, alphabet_size, hskip)


def _read_simple(br: BitReader, alphabet_size: int) -> PrefixCode:
    nsym = br.u(2) + 1
    nbits = ceil_log2(alphabet_size)
    syms = [br.u(nbits) for _ in range(nsym)]
    if len(set(syms)) != nsym:
        raise BitstreamError("duplicate symbols in simple prefix code")
    for s in syms:
        if s >= alphabet_size:
            raise BitstreamError("symbol out of alphabet")
    lengths = [0] * alphabet_size
    if nsym == 1:
        lengths[syms[0]] = 1  # marker; decoded without reading bits
        pc = PrefixCode.__new__(PrefixCode)
        pc.lengths = lengths
        pc.codes = [0] * alphabet_size
        pc._dec = {}
        pc._single = syms[0]
        return pc
    if nsym == 2:
        syms.sort()
        lengths[syms[0]] = lengths[syms[1]] = 1
    elif nsym == 3:
        # the two length-2 symbols (positions 1,2) are sorted (RFC 7932 §3.4)
        if syms[1] > syms[2]:
            syms[1], syms[2] = syms[2], syms[1]
        lengths[syms[0]] = 1
        lengths[syms[1]] = lengths[syms[2]] = 2
    else:
        tree_select = br.u(1)
        if tree_select:
            # lengths {1,2,3,3}; the two length-3 symbols sorted
            if syms[2] > syms[3]:
                syms[2], syms[3] = syms[3], syms[2]
            lengths[syms[0]] = 1
            lengths[syms[1]] = 2
            lengths[syms[2]] = lengths[syms[3]] = 3
        else:
            syms.sort()
            for s in syms:
                lengths[s] = 2
    return PrefixCode(lengths)


def _read_complex(br: BitReader, alphabet_size: int, hskip: int) -> PrefixCode:
    # 1. code lengths of the code-length code
    cl_lengths = [0] * 18
    space = 32
    num_codes = 0
    for i in range(hskip, 18):
        peek = br.peek(4)
        nbits, sym = _CL_FIXED[peek]
        br.skip(nbits)
        cl_lengths[_CL_ORDER[i]] = sym
        if sym != 0:
            space -= 32 >> sym
            num_codes += 1
            if space <= 0:
                break
    if num_codes == 1:
        # single code-length symbol: that length applies... brotli treats
        # this as "all symbols have that length"? Actually a single
        # code-length code symbol means the code-length code has one symbol.
        pass
    cl_code = PrefixCode(cl_lengths)

    # 2. main code lengths
    lengths = [0] * alphabet_size
    space = 1 << MAX_LENGTH
    prev_nonzero = 8
    i = 0
    prev_repeat_sym = 0
    repeat = 0
    while i < alphabet_size and space > 0:
        sym = cl_code.read(br)
        if sym < 16:
            lengths[i] = sym
            i += 1
            if sym != 0:
                prev_nonzero = sym
                space -= (1 << MAX_LENGTH) >> sym
            prev_repeat_sym = 0
            repeat = 0
        elif sym == 16:
            extra = br.u(2)
            if prev_repeat_sym == 16:
                old = repeat
                repeat = 4 * (repeat - 2) + 3 + extra
                delta = repeat - old
            else:
                repeat = 3 + extra
                delta = repeat
            for _ in range(delta):
                if i >= alphabet_size:
                    raise BitstreamError("repeat overruns alphabet")
                lengths[i] = prev_nonzero
                space -= (1 << MAX_LENGTH) >> prev_nonzero
                i += 1
            prev_repeat_sym = 16
        else:  # 17: repeat zero
            extra = br.u(3)
            if prev_repeat_sym == 17:
                old = repeat
                repeat = 8 * (repeat - 2) + 3 + extra
                delta = repeat - old
            else:
                repeat = 3 + extra
                delta = repeat
            i += delta
            if i > alphabet_size:
                raise BitstreamError("zero-repeat overruns alphabet")
            prev_repeat_sym = 17
    if space < 0:
        raise BitstreamError("prefix code lengths oversubscribed")
    if space > 0:
        # under-full codes are only allowed for single-symbol codes
        nz = [s for s, ln in enumerate(lengths) if ln]
        if len(nz) != 1:
            raise BitstreamError("prefix code lengths undersubscribed")
    return PrefixCode(lengths)


# --------------------------------------------------------------------------
# Writing

def write_prefix_code(bw: BitWriter, lengths: List[int],
                      alphabet_size: int) -> None:
    """Serialize code lengths (complex form, or simple when few symbols)."""
    if alphabet_size == 1:
        return
    nz = [(s, ln) for s, ln in enumerate(lengths[:alphabet_size]) if ln > 0]
    nbits = ceil_log2(alphabet_size)
    if 1 <= len(nz) <= 4:
        syms = [s for s, _ in nz]
        sorted_lens = sorted(ln for _, ln in nz)
        simple_ok = (
            (len(nz) == 1) or
            (len(nz) == 2 and sorted_lens == [1, 1]) or
            (len(nz) == 3 and sorted_lens == [1, 2, 2]) or
            (len(nz) == 4 and sorted_lens in ([2, 2, 2, 2], [1, 2, 3, 3])))
        if simple_ok:
            bw.u(1, 2)  # hskip marker for simple code
            bw.u(len(nz) - 1, 2)
            if len(nz) == 3:
                # order: two 1/2-length handling matches reader sort
                syms_sorted = sorted(syms)
                order = ([s for s in syms_sorted if lengths[s] == 1]
                         + [s for s in syms_sorted if lengths[s] == 2])
                syms = order
            elif len(nz) == 4 and sorted_lens == [1, 2, 3, 3]:
                syms = sorted(syms, key=lambda s: (lengths[s], s))
            else:
                syms = sorted(syms)
            for s in syms:
                bw.u(s, nbits)
            if len(nz) == 4:
                bw.u(1 if sorted_lens == [1, 2, 3, 3] else 0, 1)
            return
    # complex form
    _write_complex(bw, lengths[:alphabet_size])


def _write_complex(bw: BitWriter, lengths: List[int]) -> None:
    # RLE-compress lengths into code-length symbols
    tokens = []  # (symbol, extra_bits_value, extra_bits_count)
    i = 0
    n = len(lengths)
    prev_nonzero = 8
    while i < n:
        ln = lengths[i]
        run = 1
        while i + run < n and lengths[i + run] == ln:
            run += 1
        if ln == 0:
            # 17-chunks accumulate when consecutive, so insert a literal 0
            # chain-breaker between chunks.
            r = run
            while r >= 3:
                take = min(r, 10)
                tokens.append((17, take - 3, 3))
                r -= take
                if r >= 3:
                    tokens.append((0, 0, 0))
                    r -= 1
            tokens.extend([(0, 0, 0)] * r)
            i += run
        else:
            # first occurrence written literally, runs via 16-chunks with
            # literal chain-breakers (16-chunks accumulate when consecutive)
            tokens.append((ln, 0, 0))
            prev_nonzero = ln
            r = run - 1
            while r >= 3:
                take = min(r, 6)
                tokens.append((16, take - 3, 2))
                r -= take
                if r >= 3:
                    tokens.append((ln, 0, 0))
                    r -= 1
            tokens.extend([(ln, 0, 0)] * r)
            i += run
    # histogram of code-length symbols
    hist = [0] * 18
    for sym, _, _ in tokens:
        hist[sym] += 1
    cl_lengths = build_code_lengths(hist, 18, max_length=5)
    cl_code = PrefixCode(cl_lengths)
    # choose hskip=0 always
    bw.u(0, 2)
    space = 32
    for i in range(18):
        sym = cl_lengths[_CL_ORDER[i]]
        # write with fixed code: find the (nbits, pattern) whose decode = sym
        _write_cl_fixed(bw, sym)
        if sym != 0:
            space -= 32 >> sym
            if space <= 0:
                break
    for sym, extra, nbits in tokens:
        cl_code.write(bw, sym)
        if nbits:
            bw.u(extra, nbits)


_CL_FIXED_ENC = {0: (0b00, 2), 4: (0b01, 2), 3: (0b10, 2),
                 2: (0b011, 3), 1: (0b0111, 4), 5: (0b1111, 4)}


def _write_cl_fixed(bw: BitWriter, sym: int) -> None:
    code, nbits = _CL_FIXED_ENC[sym]
    bw.u(code, nbits)


def build_code_lengths(hist: List[int], alphabet_size: int,
                       max_length: int = MAX_LENGTH) -> List[int]:
    """Length-limited Huffman code lengths (package-merge-lite via heapq +
    clamping rebalance)."""
    import heapq
    nz = [(h, s) for s, h in enumerate(hist[:alphabet_size]) if h > 0]
    lengths = [0] * alphabet_size
    if not nz:
        return lengths
    if len(nz) == 1:
        lengths[nz[0][1]] = 1
        return lengths
    # standard huffman
    heap = [(h, [s]) for h, s in nz]
    heapq.heapify(heap)
    depth = {s: 0 for _, s in nz}
    while len(heap) > 1:
        h1, s1 = heapq.heappop(heap)
        h2, s2 = heapq.heappop(heap)
        for s in s1 + s2:
            depth[s] += 1
        heapq.heappush(heap, (h1 + h2, s1 + s2))
    for s, d in depth.items():
        lengths[s] = min(d, max_length) if d > 0 else 1
    # fix Kraft if clamping broke it
    _fix_kraft(lengths, max_length)
    return lengths


def _fix_kraft(lengths: List[int], max_length: int) -> None:
    total = 1 << max_length
    used = sum((total >> ln) for ln in lengths if ln)
    # increase lengths (cheapest first) while oversubscribed
    while used > total:
        # find symbol with smallest count impact: longest length < max
        best = None
        for s, ln in enumerate(lengths):
            if 0 < ln < max_length:
                if best is None or ln > lengths[best]:
                    best = s
        if best is None:
            raise ValueError("cannot fix Kraft inequality")
        used -= (total >> lengths[best]) - (total >> (lengths[best] + 1))
        lengths[best] += 1
    # decrease lengths while undersubscribed (optional tightening)
    changed = True
    while used < total and changed:
        changed = False
        for s, ln in enumerate(lengths):
            if ln > 1:
                gain = (total >> (ln - 1)) - (total >> ln)
                if used + gain <= total:
                    lengths[s] -= 1
                    used += gain
                    changed = True
    if used != total:
        raise ValueError("kraft fixup failed")
