"""Compressed ICC profiles inside the codestream (want_icc).

JXL stores ICC profiles with a domain-specific predictor + the common
entropy coder (41 contexts keyed on the previous two bytes), NOT
brotli — brotli only appears in container `brob` boxes.  Structure
(icc_codec*.h; semantics pinned against libjxl with round-trip
probes on real profiles):

  U64 enc_size, then enc_size entropy-coded bytes forming
  [osize varint][csize varint][command stream][data stream].

The command stream rebuilds the profile: a 128-byte header is
predicted (size word, 'mntr RGB XYZ ', 'acsp', D50 illuminant, the
creator mirrors the CMM type) with residuals from the data stream; a
tag-table section with per-tag commands (known-tag table, TRC/XYZ
triples, default size 20, running offsets); then body commands:
Insert, Shuffle2/4, Predict (multi-byte linear predictor orders 0-2),
XYZ (12-byte payload), and TypeStart entries.
"""

from __future__ import annotations

from .reader import BitReader, BitstreamError

ICC_CONTEXTS = 41
HEADER_SIZE = 128

TAG_STRINGS = [b"cprt", b"wtpt", b"bkpt", b"rXYZ", b"gXYZ", b"bXYZ",
               b"kXYZ", b"rTRC", b"gTRC", b"bTRC", b"kTRC", b"chad",
               b"desc", b"chrm", b"dmnd", b"dmdd", b"lumi"]
TYPE_STRINGS = [b"XYZ ", b"desc", b"text", b"mluc", b"para", b"curv",
                b"sf32", b"gbd "]

CMD_TAG_UNKNOWN = 1
CMD_TAG_TRC = 2
CMD_TAG_XYZ = 3
CMD_TAG_STRING_FIRST = 4
CMD_INSERT = 1
CMD_SHUFFLE2 = 2
CMD_SHUFFLE4 = 3
CMD_PREDICT = 4
CMD_XYZ = 10
CMD_TYPE_START_FIRST = 16


def _icc_context(i: int, b1: int, b2: int) -> int:
    if i <= 128:
        return 0
    if (97 <= b1 <= 122) or (65 <= b1 <= 90):
        p1 = 0
    elif (48 <= b1 <= 57) or b1 in (46, 44):
        p1 = 1
    elif b1 <= 1:
        p1 = 2 + b1
    elif b1 < 16:
        p1 = 4
    elif 240 < b1 < 255:
        p1 = 5
    elif b1 == 255:
        p1 = 6
    else:
        p1 = 7
    if (97 <= b2 <= 122) or (65 <= b2 <= 90):
        p2 = 0
    elif (48 <= b2 <= 57) or b2 in (46, 44):
        p2 = 1
    elif b2 < 16:
        p2 = 2
    elif b2 > 240:
        p2 = 3
    else:
        p2 = 4
    return 1 + p2 * 8 + p1


def read_encoded_icc(br: BitReader) -> bytes:
    """Entropy-decode the raw (predicted) ICC byte stream."""
    from ..entropy.coder import EntropyDecoder
    enc_size = br.u64()
    if enc_size > (1 << 28):
        raise BitstreamError("encoded ICC too large")
    dec = EntropyDecoder(br, ICC_CONTEXTS)
    out = bytearray()
    b1 = b2 = 0
    for i in range(enc_size):
        v = dec.read(_icc_context(i, b1, b2))
        if v > 255:
            raise BitstreamError("ICC byte out of range")
        out.append(v)
        b2 = b1
        b1 = v
    if not dec.check_final_state():
        raise BitstreamError("ICC stream checksum failed")
    return bytes(out)


def _varint(b: bytes, pos: int):
    ret = 0
    for i in range(10):
        if pos + i >= len(b):
            raise BitstreamError("truncated ICC varint")
        ret |= (b[pos + i] & 127) << (7 * i)
        if b[pos + i] < 128:
            return ret, pos + i + 1
    raise BitstreamError("ICC varint too long")


def _be32(v: int) -> bytes:
    return bytes(((v >> 24) & 255, (v >> 16) & 255, (v >> 8) & 255, v & 255))


def _header_prediction(osize: int, out_so_far: bytearray, pos: int) -> int:
    """Predicted value of header byte `pos` (ICCInitialHeaderPrediction +
    ICCPredictHeader; pinned by residual extraction on real profiles)."""
    if pos < 4:
        return _be32(osize)[pos]
    if 8 <= pos < 12:
        return (4, 0, 0, 0)[pos - 8]
    if 12 <= pos < 24:
        return b"mntrRGB XYZ "[pos - 12]
    if 36 <= pos < 40:
        return b"acsp"[pos - 36]
    if 41 <= pos < 44:
        # platform tail predicted from the leading platform bytes
        prefix = bytes(out_so_far[40:pos])
        cands = [p for p in (b"APPL", b"MSFT", b"SGI ", b"SUNW")
                 if p[:pos - 40] == prefix]
        return cands[0][pos - 40] if len(cands) == 1 else 0
    if 68 <= pos < 80:
        return bytes((0, 0, 0xF6, 0xD6, 0, 1, 0, 0, 0, 0, 0xD3, 0x2D))[
            pos - 68]
    if 80 <= pos < 84:
        # creator mirrors the CMM type (bytes 4..8 of the profile)
        return out_so_far[pos - 76] if len(out_so_far) > pos - 76 else 0
    return 0


def _shuffle(data: bytes, width: int) -> bytes:
    """Inverse of the encoder's byte-plane grouping: input holds the
    bytes column-major over `width` planes; output interleaves them."""
    size = len(data)
    height = (size + width - 1) // width
    out = bytearray(size)
    s = 0
    j = 0
    for i in range(size):
        out[i] = data[j]
        j += height
        if j >= size:
            s += 1
            j = s
    return bytes(out)


def _predict(result: bytearray, start: int, i: int, stride: int,
             width: int, order: int) -> int:
    """LinearPredictICCValue: predict byte i (relative to start) from
    previous width-byte big-endian words at the given stride."""
    sub = i % width

    def word(off):
        p = start + i - off * stride - sub
        v = 0
        for k in range(width):
            v = (v << 8) | result[p + k]
        return v

    if order == 0:
        pred = word(1)
    elif order == 1:
        pred = 2 * word(1) - word(2)
    else:
        pred = 3 * word(1) - 3 * word(2) + word(3)
    shift = (width - 1 - sub) * 8
    return (pred >> shift) & 0xFF


def unpredict_icc(enc: bytes) -> bytes:
    """Rebuild the ICC profile from the decoded command/data stream."""
    osize, pos = _varint(enc, 0)
    if osize > (1 << 28):
        raise BitstreamError("ICC output too large")
    csize, pos = _varint(enc, pos)
    cpos = pos
    cend = pos + csize
    dpos = cend
    if cend > len(enc):
        raise BitstreamError("ICC command stream overruns")
    out = bytearray()

    # header
    nhdr = min(osize, HEADER_SIZE)
    if dpos + nhdr > len(enc):
        raise BitstreamError("ICC data stream overruns (header)")
    for i in range(nhdr):
        pred = _header_prediction(osize, out, i)
        out.append((enc[dpos] + pred) & 0xFF)
        dpos += 1

    # tag list
    if cpos < cend:
        numtags, cpos = _varint(enc, cpos)
        if numtags != 0:
            numtags -= 1
            out += _be32(numtags)
            prev_start = HEADER_SIZE + 4 + 12 * numtags
            prev_size = 0
            while True:
                if cpos >= cend:
                    raise BitstreamError("ICC tag list overruns")
                command = enc[cpos]
                cpos += 1
                tagcode = command & 63
                if tagcode == 0:
                    break
                if tagcode == CMD_TAG_UNKNOWN:
                    if dpos + 4 > len(enc):
                        raise BitstreamError("ICC tag overruns")
                    tag = bytes(enc[dpos:dpos + 4])
                    dpos += 4
                elif tagcode in (CMD_TAG_TRC, CMD_TAG_XYZ):
                    tag = None
                elif tagcode - CMD_TAG_STRING_FIRST < len(TAG_STRINGS):
                    tag = TAG_STRINGS[tagcode - CMD_TAG_STRING_FIRST]
                else:
                    raise BitstreamError(f"bad ICC tag command {tagcode}")
                if command & 64:
                    tagstart, cpos = _varint(enc, cpos)
                else:
                    tagstart = prev_start + prev_size
                if command & 128:
                    tagsize, cpos = _varint(enc, cpos)
                else:
                    tagsize = 20
                if tagcode == CMD_TAG_TRC:
                    for t in (b"rTRC", b"gTRC", b"bTRC"):
                        out += t + _be32(tagstart) + _be32(tagsize)
                elif tagcode == CMD_TAG_XYZ:
                    for k, t in enumerate((b"rXYZ", b"gXYZ", b"bXYZ")):
                        out += t + _be32(tagstart + 20 * k) + _be32(tagsize)
                else:
                    out += tag + _be32(tagstart) + _be32(tagsize)
                prev_start, prev_size = tagstart, tagsize

    # body commands
    while cpos < cend:
        command = enc[cpos]
        cpos += 1
        if command == CMD_INSERT:
            num, cpos = _varint(enc, cpos)
            if dpos + num > len(enc):
                raise BitstreamError("ICC insert overruns")
            out += enc[dpos:dpos + num]
            dpos += num
        elif command in (CMD_SHUFFLE2, CMD_SHUFFLE4):
            num, cpos = _varint(enc, cpos)
            if dpos + num > len(enc):
                raise BitstreamError("ICC shuffle overruns")
            width = 2 if command == CMD_SHUFFLE2 else 4
            out += _shuffle(enc[dpos:dpos + num], width)
            dpos += num
        elif command == CMD_PREDICT:
            if cpos >= cend:
                raise BitstreamError("ICC predict truncated")
            flags = enc[cpos]
            cpos += 1
            width = (flags & 3) + 1
            if width == 3:
                raise BitstreamError("bad ICC predict width")
            order = (flags >> 2) & 3
            if order == 3:
                raise BitstreamError("bad ICC predict order")
            if flags & 16:
                stride, cpos = _varint(enc, cpos)
            else:
                stride = width
            num, cpos = _varint(enc, cpos)
            if dpos + num > len(enc):
                raise BitstreamError("ICC predict overruns")
            data = enc[dpos:dpos + num]
            dpos += num
            if width > 1:  # multi-byte residuals are byte-plane grouped
                data = _shuffle(data, width)
            start = len(out)
            if stride * 4 >= start:
                raise BitstreamError("ICC predict start underruns")
            for i in range(num):
                pred = _predict(out, start, i, stride, width, order)
                out.append((data[i] + pred) & 0xFF)
        elif command == CMD_XYZ:
            if dpos + 12 > len(enc):
                raise BitstreamError("ICC XYZ overruns")
            out += b"XYZ \0\0\0\0" + bytes(enc[dpos:dpos + 12])
            dpos += 12
        elif command >= CMD_TYPE_START_FIRST:
            idx = command - CMD_TYPE_START_FIRST
            if idx >= len(TYPE_STRINGS):
                raise BitstreamError(f"bad ICC type command {command}")
            out += TYPE_STRINGS[idx] + b"\0\0\0\0"
        else:
            raise BitstreamError(f"bad ICC command {command}")
    if len(out) != osize:
        raise BitstreamError(
            f"ICC reconstruction size mismatch {len(out)} != {osize}")
    return bytes(out)


def read_icc_profile(br: BitReader) -> bytes:
    return unpredict_icc(read_encoded_icc(br))


# ---------------------------------------------------------------------------
# Encoding (want_icc write path — the reference embeds arbitrary ICC
# via JxlEncoderSetICCProfile, interop/JxlEncoding.cpp:125-137)

def _varint_enc(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 127
        v >>= 7
        if v:
            out.append(b | 128)
        else:
            out.append(b)
            return bytes(out)


def predict_icc_simple(profile: bytes) -> bytes:
    """Inverse of unpredict_icc in its minimal-command form: predicted
    header residuals + one Insert covering the body.  Spec-valid (any
    decoder runs the same command machine); compression rides on the
    entropy coder rather than the tag-level predictors libjxl's own
    encoder adds."""
    osize = len(profile)
    nhdr = min(osize, HEADER_SIZE)
    rebuilt = bytearray()
    hdr_resid = bytearray()
    for i in range(nhdr):
        pred = _header_prediction(osize, rebuilt, i)
        hdr_resid.append((profile[i] - pred) & 0xFF)
        rebuilt.append(profile[i])
    commands = bytearray(_varint_enc(0))        # no tag list
    data = bytes(hdr_resid)
    if osize > HEADER_SIZE:
        commands.append(CMD_INSERT)
        commands += _varint_enc(osize - HEADER_SIZE)
        data += profile[HEADER_SIZE:]
    return (_varint_enc(osize) + _varint_enc(len(commands))
            + bytes(commands) + data)


def write_icc_profile(bw, profile: bytes) -> None:
    """Entropy-code the predicted ICC stream into the codestream
    (mirrors read_icc_profile)."""
    from ..entropy.coder import TokenStream
    enc = predict_icc_simple(profile)
    bw.u64(len(enc))
    ts = TokenStream(ICC_CONTEXTS, use_ans=True)
    b1 = b2 = 0
    for i, v in enumerate(enc):
        ts.add(_icc_context(i, b1, b2), v)
        b2 = b1
        b1 = v
    ts.write(bw)
