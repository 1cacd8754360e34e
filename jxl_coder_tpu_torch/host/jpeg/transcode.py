"""Lossless JPEG <-> JXL transcoding in the round-1 private container:
the host part of ``jxl_coder_tpu/jpeg/transcode.py`` (construct,
is_constructed, reconstruct and the loader), the port's copy.

Mirrors JxlCoder.Convenience.construct / reconstructJPEG
(JxlCoder.kt:173-184 over interop/JxlConstruction.hpp:45-102 and
JxlReconstruction.hpp:44-88): a JPEG is re-coded losslessly — the DCT
coefficients move into our entropy coding (smaller), the original header
and trailer bytes ride along verbatim, and reconstruction re-emits the
byte-identical JPEG.

Round-1 container layout (documented deviation, docs/CONFORMANCE.md):
boxes [JXL signature, ftyp, jbrd (header+trailer blobs), jxcf (modular-
coded coefficient planes)].  ``jpeg/transcode.py`` (the device layer)
renders such a file to pixels on the device from ``_load``'s
coefficients.
"""

from __future__ import annotations

import struct

import numpy as np

from ..bitstream.reader import BitReader
from ..bitstream.writer import BitWriter
from ..bitstream import container as container_mod
from ..modular.image import Channel, ModularImage
from ..modular.stream import (GroupHeader, decode_modular_stream,
                              encode_modular_stream)
from ..modular.tree import Tree, Node
from .parser import parse_jpeg, JpegData, JpegError
from .writer import write_jpeg


def _band_tree(ncomp: int) -> Tree:
    """Channel layout: [DC x ncomp][then 63 AC planes per component,
    frequency-major].  Tree: DC -> gradient leaf; AC split into frequency
    bands with separate contexts (zero predictor + RLE)."""
    # channels: 0..ncomp-1 DC; ncomp + c*63 + (k-1) for AC coefficient k
    nodes = []
    # split DC vs AC on channel index
    nodes.append(Node(property=0, splitval=ncomp - 1, left=1, right=2))
    # AC side: split into 4 bands by channel index within the AC range
    # band boundaries at zigzag positions ~4, 12, 32 (x ncomp)
    b1 = ncomp + 4 * ncomp - 1
    b2 = ncomp + 12 * ncomp - 1
    b3 = ncomp + 32 * ncomp - 1
    nodes.append(Node(property=0, splitval=b2, left=3, right=4))   # idx 1
    nodes.append(Node(property=-1, predictor=5, ctx=0))            # idx 2 DC
    nodes.append(Node(property=0, splitval=b3, left=5, right=6))   # idx 3
    nodes.append(Node(property=0, splitval=b1, left=7, right=8))   # idx 4
    nodes.append(Node(property=-1, predictor=0, ctx=1))  # idx 5: high band
    nodes.append(Node(property=-1, predictor=0, ctx=2))  # idx 6: mid band
    nodes.append(Node(property=-1, predictor=0, ctx=3))  # idx 7: low-mid
    nodes.append(Node(property=-1, predictor=0, ctx=4))  # idx 8: low band
    return Tree(nodes)


def construct(jpeg_data: bytes) -> bytes:
    """JPEG -> JXL container, losslessly re-coded.

    Coefficients are stored as frequency planes (one (bh, bw) plane per
    zigzag position per component): high-frequency planes are almost all
    zeros, which the LZ77/RLE path collapses, and each band gets its own
    entropy context.
    """
    j = parse_jpeg(jpeg_data)
    if j.dri_count > 1:
        # jbrd carries a single DRI value; files that redefine the
        # restart interval mid-stream are unrepresentable — the
        # reference (libjxl enc_jpeg_data_reader.cc "Duplicate DRI
        # marker") rejects them the same way
        raise JpegError("multiple DRI markers cannot be represented "
                        "losslessly (jbrd stores one restart interval)")
    ncomp = len(j.components)
    chans = []
    for c in j.components:
        chans.append(Channel(c.blocks_w, c.blocks_h,
                             data=c.coeffs[:, :, 0].astype(np.int32)))
    for k in range(1, 64):
        for c in j.components:
            chans.append(Channel(c.blocks_w, c.blocks_h,
                                 data=c.coeffs[:, :, k].astype(np.int32)))
    image = ModularImage(chans)
    tree = _band_tree(ncomp)
    bw = BitWriter()
    encode_modular_stream(bw, image, GroupHeader(), tree, lz77=True)
    bw.zero_pad_to_byte()
    coeff_blob = bw.to_bytes()

    jbrd = (struct.pack("<I", len(j.header_bytes)) + j.header_bytes
            + struct.pack("<I", len(j.trailer_bytes)) + j.trailer_bytes)

    out = bytearray()
    out += container_mod.MAGIC_CONTAINER
    ftyp = b"jxl \x00\x00\x00\x00jxl "
    out += struct.pack(">I", 8 + len(ftyp)) + b"ftyp" + ftyp
    out += struct.pack(">I", 8 + len(jbrd)) + b"jbrd" + jbrd
    out += struct.pack(">I", 8 + len(coeff_blob)) + b"jxcf" + coeff_blob
    return bytes(out)


def is_constructed(data: bytes) -> bool:
    """True only for the round-1 PRIVATE container (jxcf coefficient
    box); standard recompressed files (jbrd + jxlc codestream) decode
    through the normal path / jpeg.wire."""
    if data[:12] != container_mod.MAGIC_CONTAINER:
        return False
    try:
        for box in container_mod.parse_boxes(data):
            if box.type == b"jxcf":
                return True
            if box.type in (b"jxlc", b"jxlp"):
                return False
    except Exception:
        return False
    return False


def _load(data: bytes):
    jbrd = None
    coeff = None
    for box in container_mod.parse_boxes(data):
        if box.type == b"jbrd":
            jbrd = box.payload
        elif box.type == b"jxcf":
            coeff = box.payload
    if jbrd is None or coeff is None:
        raise JpegError("not a constructed JPEG-in-JXL file")
    hlen = struct.unpack("<I", jbrd[:4])[0]
    header = jbrd[4:4 + hlen]
    tlen = struct.unpack("<I", jbrd[4 + hlen:8 + hlen])[0]
    trailer = jbrd[8 + hlen:8 + hlen + tlen]
    # parse geometry/tables from the original header bytes (append a
    # dummy empty scan end so parse stops right after SOS)
    j = _parse_header_only(header)
    j.trailer_bytes = trailer
    ncomp = len(j.components)
    chans = [Channel(c.blocks_w, c.blocks_h) for c in j.components]
    for k in range(1, 64):
        for c in j.components:
            chans.append(Channel(c.blocks_w, c.blocks_h))
    img = ModularImage(chans)
    decode_modular_stream(BitReader(coeff), img)
    for i, c in enumerate(j.components):
        coeffs = np.zeros((c.blocks_h, c.blocks_w, 64), np.int32)
        coeffs[:, :, 0] = img.channels[i].data
        for k in range(1, 64):
            coeffs[:, :, k] = img.channels[ncomp + (k - 1) * ncomp + i].data
        c.coeffs = coeffs
    return j


def _parse_header_only(header: bytes) -> JpegData:
    """Parse a JPEG header blob (SOI..SOS) without scan data: the
    tables, the frame's geometry and the first scan's table choices."""
    from . import parser as P
    j = P.JpegData()
    data = header
    pos = 2
    while pos < len(data):
        marker = data[pos + 1]
        seg_len = int.from_bytes(data[pos + 2:pos + 4], "big")
        seg = data[pos + 4:pos + 2 + seg_len]
        if marker == 0xDB:
            p = 0
            while p < len(seg):
                pq, tq = seg[p] >> 4, seg[p] & 15
                p += 1
                if pq:
                    j.quant[tq] = np.frombuffer(seg[p:p + 128],
                                                ">u2").astype(np.int32)
                    p += 128
                else:
                    j.quant[tq] = np.frombuffer(seg[p:p + 64],
                                                np.uint8).astype(np.int32)
                    p += 64
        elif marker in (0xC0, 0xC1):
            j.precision = seg[0]
            j.height = int.from_bytes(seg[1:3], "big")
            j.width = int.from_bytes(seg[3:5], "big")
            for i in range(seg[5]):
                cid, hv, tq = seg[6 + 3 * i:9 + 3 * i]
                j.components.append(P.Component(cid, hv >> 4, hv & 15, tq))
        elif marker == 0xC4:
            p = 0
            while p < len(seg):
                tc, th = seg[p] >> 4, seg[p] & 15
                counts = list(seg[p + 1:p + 17])
                nsym = sum(counts)
                syms = list(seg[p + 17:p + 17 + nsym])
                (j.ac_tables if tc else j.dc_tables)[th] = \
                    P.HuffTable(counts, syms)
                p += 17 + nsym
        elif marker == 0xDD:
            j.restart_interval = int.from_bytes(seg[:2], "big")
        elif marker == 0xDA:
            ns = seg[0]
            for i in range(ns):
                cid, tt = seg[1 + 2 * i], seg[2 + 2 * i]
                for c in j.components:
                    if c.id == cid:
                        c.td, c.ta = tt >> 4, tt & 15
            break
        pos += 2 + seg_len
    j.header_bytes = header
    j.hmax = max(c.h for c in j.components)
    j.vmax = max(c.v for c in j.components)
    j.mcus_x = -(-j.width // (8 * j.hmax))
    j.mcus_y = -(-j.height // (8 * j.vmax))
    for c in j.components:
        c.blocks_w = j.mcus_x * c.h
        c.blocks_h = j.mcus_y * c.v
    return j


def reconstruct(data: bytes) -> bytes:
    """JXL (constructed) -> byte-identical original JPEG."""
    j = _load(data)
    return write_jpeg(j)
