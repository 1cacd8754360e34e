"""ISOBMFF container handling + signature sniffing.

Mirrors the reference's `isJXL` magic check and the container unwrapping
libjxl performs internally: a `.jxl` file is
either a bare codestream starting FF 0A or an ISOBMFF container whose
`jxlc` (complete) / `jxlp` (partial, 4-byte sequence prefix) boxes hold the
codestream.
"""

from __future__ import annotations

import dataclasses
import struct

from .reader import BitstreamError

MAGIC_BARE = b"\xff\x0a"
MAGIC_CONTAINER = b"\x00\x00\x00\x0cJXL \r\n\x87\n"


def is_jxl(data: bytes) -> bool:
    """Signature sniff for both bare codestream and ISOBMFF container."""
    if len(data) >= 2 and data[:2] == MAGIC_BARE:
        return True
    return len(data) >= 12 and data[:12] == MAGIC_CONTAINER


@dataclasses.dataclass
class Box:
    type: bytes
    payload: bytes
    offset: int


@dataclasses.dataclass
class Container:
    boxes: list
    codestream: bytes
    level: int = 5
    jpeg_reconstruction_data: bytes | None = None
    exif: bytes | None = None
    xml: list | None = None
    brotli_boxes: list | None = None  # (inner_type, compressed_payload)


def parse_boxes(data: bytes):
    """Iterate ISOBMFF boxes: (type, payload, offset)."""
    pos = 0
    n = len(data)
    while pos + 8 <= n:
        size = struct.unpack(">I", data[pos:pos + 4])[0]
        btype = data[pos + 4:pos + 8]
        hdr = 8
        if size == 1:
            if pos + 16 > n:
                raise BitstreamError("truncated extended box header")
            size = struct.unpack(">Q", data[pos + 8:pos + 16])[0]
            hdr = 16
        if size == 0:  # box extends to end of file
            payload = data[pos + hdr:]
            yield Box(btype, payload, pos)
            return
        if size < hdr or pos + size > n:
            raise BitstreamError(f"bad box size {size} for {btype!r} at {pos}")
        yield Box(btype, data[pos + hdr:pos + size], pos)
        pos += size


def extract_codestream(data: bytes) -> Container:
    """Return the raw codestream (and auxiliary boxes) from a .jxl file."""
    if data[:2] == MAGIC_BARE:
        return Container(boxes=[], codestream=data)
    if data[:12] != MAGIC_CONTAINER:
        raise BitstreamError("not a JPEG XL file (bad signature)")
    boxes = list(parse_boxes(data))
    if not boxes or boxes[0].type != b"JXL ":
        raise BitstreamError("container missing signature box")
    cs_parts = []
    out = Container(boxes=boxes, codestream=b"")
    partial = {}
    for box in boxes[1:]:
        t = box.type
        if t == b"ftyp":
            if box.payload[:4] != b"jxl ":
                raise BitstreamError("ftyp brand is not 'jxl '")
        elif t == b"jxll":
            out.level = box.payload[0]
        elif t == b"jxlc":
            cs_parts.append(box.payload)
        elif t == b"jxlp":
            seq = struct.unpack(">I", box.payload[:4])[0]
            partial[seq & 0x7FFFFFFF] = box.payload[4:]
        elif t == b"jbrd":
            out.jpeg_reconstruction_data = box.payload
        elif t == b"Exif":
            out.exif = box.payload
        elif t == b"xml ":
            out.xml = (out.xml or []) + [box.payload]
        elif t == b"brob":
            out.brotli_boxes = (out.brotli_boxes or []) + [
                (box.payload[:4], box.payload[4:])]
        # jumb / free / unknown boxes are skipped
    if partial:
        for k in sorted(partial):
            cs_parts.append(partial[k])
    out.codestream = b"".join(cs_parts)
    if not out.codestream:
        raise BitstreamError("container has no codestream (jxlc/jxlp) box")
    if out.codestream[:2] != MAGIC_BARE:
        raise BitstreamError("codestream box does not start with FF 0A")
    return out
