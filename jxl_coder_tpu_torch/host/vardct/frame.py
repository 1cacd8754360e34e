"""VarDCT frame assembly: host bitstream <-> device arrays.

Host side parses/serializes sections (byte framing, entropy coding);
device side (pipeline.py) does all pixel math.  Groups are 256x256,
LF (DC) groups 2048x2048, mirroring the spec's section layout so the
group-grid sharding (SURVEY.md §2.6) applies.

Round-1 payload conventions (documented deviations, see
docs/CONFORMANCE.md): LfGlobal carries the distance as F16; AC token
histograms live per PassGroup (fully independent sections) instead of
HfGlobal; AC contexts are a simplified (channel, band) scheme.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from ..bitstream.reader import BitReader, BitstreamError, unpack_signed, \
    pack_signed
from ..bitstream.writer import BitWriter
from ..bitstream.headers import ImageHeader
from ..bitstream.frame_header import FrameHeader
from ..entropy.coder import EntropyDecoder, TokenStream
from ..modular.image import Channel, ModularImage
from ..modular.stream import (GroupHeader, decode_modular_stream,
                              encode_modular_stream)
from ..modular.tree import Tree

GROUP_DIM = 256
LF_GROUP_DIM = 2048


def zigzag_order(n: int = 8) -> np.ndarray:
    """Standard zigzag scan order as (n*n, 2) index pairs."""
    order = sorted(((i, j) for i in range(n) for j in range(n)),
                   key=lambda p: (p[0] + p[1],
                                  p[1] if (p[0] + p[1]) % 2 else p[0]))
    return np.array(order, np.int32)


_ZZ = zigzag_order(8)
# number of AC contexts in our simplified model:
# nonzero-count ctx: 3 (one per channel); coeff ctx: channel x 4 bands
NUM_AC_CONTEXTS = 3 + 3 * 4


def _coeff_ctx(channel: int, k: int) -> int:
    band = 0 if k < 4 else 1 if k < 12 else 2 if k < 32 else 3
    return 3 + channel * 4 + band


@dataclasses.dataclass
class VarDctFrameData:
    """Host-side decoded arrays, ready for the device pipeline."""
    ac: np.ndarray      # (3, nY, nX, 8, 8) int32
    dc: np.ndarray      # (3, nY, nX) int32
    qf: np.ndarray      # (nY, nX) int32
    cfl_x: np.ndarray   # (tY, tX) int32 (1/64 units)
    cfl_b: np.ndarray   # (tY, tX) int32
    distance: float


def grid_dims(w: int, h: int) -> Tuple[int, int]:
    return -(-w // 8), -(-h // 8)


# --------------------------------------------------------------------------
# Sections

def encode_lf_global(distance: float) -> bytes:
    bw = BitWriter()
    bw.f16(distance)
    bw.zero_pad_to_byte()
    return bw.to_bytes()


def decode_lf_global(data: bytes) -> float:
    return BitReader(data).f16()


def encode_lf_group(dc: np.ndarray, qf: np.ndarray, cfl_x: np.ndarray,
                    cfl_b: np.ndarray) -> bytes:
    """Modular-code the LF planes of one LF-group region."""
    chans = []
    for c in range(3):
        h, w = dc[c].shape
        chans.append(Channel(w, h, data=dc[c].astype(np.int32)))
    h, w = qf.shape
    chans.append(Channel(w, h, data=qf.astype(np.int32)))
    for arr in (cfl_x, cfl_b):
        hh, ww = arr.shape
        chans.append(Channel(ww, hh, data=arr.astype(np.int32)))
    bw = BitWriter()
    encode_modular_stream(bw, ModularImage(chans), GroupHeader(),
                          Tree.single_leaf(predictor=5))
    bw.zero_pad_to_byte()
    return bw.to_bytes()


def decode_lf_group(data: bytes, dc_shape, tile_shape) -> tuple:
    h, w = dc_shape
    th, tw = tile_shape
    chans = [Channel(w, h) for _ in range(3)] + [Channel(w, h)] + \
        [Channel(tw, th), Channel(tw, th)]
    img = ModularImage(chans)
    decode_modular_stream(BitReader(data), img)
    dc = np.stack([img.channels[c].data for c in range(3)])
    qf = img.channels[3].data
    cfl_x = img.channels[4].data
    cfl_b = img.channels[5].data
    return dc, qf, cfl_x, cfl_b


def encode_pass_group(ac: np.ndarray) -> bytes:
    """AC coefficients of one group: ac (3, gY, gX, 8, 8) int32."""
    ts = TokenStream(NUM_AC_CONTEXTS, lz77=True)
    _, gy, gx, _, _ = ac.shape
    zz = _ZZ
    for by in range(gy):
        for bx in range(gx):
            for c in (1, 0, 2):  # Y, X, B
                block = ac[c, by, bx]
                vals = block[zz[1:, 0], zz[1:, 1]]  # skip DC
                nz = np.nonzero(vals)[0]
                last = (nz[-1] + 1) if len(nz) else 0
                ts.add(c, int(last))
                for k in range(last):
                    ts.add(_coeff_ctx(c, k), pack_signed(int(vals[k])))
    bw = BitWriter()
    ts.write(bw)
    bw.zero_pad_to_byte()
    return bw.to_bytes()


def decode_pass_group(data: bytes, gy: int, gx: int) -> np.ndarray:
    ac = np.zeros((3, gy, gx, 8, 8), np.int32)
    dec = EntropyDecoder(BitReader(data), NUM_AC_CONTEXTS)
    zz = _ZZ
    for by in range(gy):
        for bx in range(gx):
            for c in (1, 0, 2):
                last = dec.read(c)
                if last > 63:
                    raise BitstreamError("AC nonzero count out of range")
                for k in range(last):
                    v = unpack_signed(dec.read(_coeff_ctx(c, k)))
                    ac[c, by, bx, zz[k + 1, 0], zz[k + 1, 1]] = v
    if not dec.check_final_state():
        raise BitstreamError("AC group checksum failed")
    return ac


# --------------------------------------------------------------------------
# Frame-level assemble / parse

def section_layout(hdr: ImageHeader, fh: FrameHeader):
    w, h = fh.coded_size(hdr)
    ng, ndc = fh.counts(hdr)
    return w, h, ng, ndc


def encode_vardct_frame(bw: BitWriter, hdr: ImageHeader, fh: FrameHeader,
                        data: VarDctFrameData) -> None:
    from ..bitstream.frame_header import write_frame_header, write_toc
    w, h, ng, ndc = section_layout(hdr, fh)
    ny, nx = data.qf.shape
    sections: List[bytes] = []
    single = (ng == 1 and fh.passes.num_passes == 1)

    lf_global = encode_lf_global(data.distance)
    lf_groups = []
    dgx = -(-nx // (LF_GROUP_DIM // 8))
    for gi in range(ndc):
        bx0 = (gi % dgx) * (LF_GROUP_DIM // 8)
        by0 = (gi // dgx) * (LF_GROUP_DIM // 8)
        bx1 = min(bx0 + LF_GROUP_DIM // 8, nx)
        by1 = min(by0 + LF_GROUP_DIM // 8, ny)
        tx0, ty0 = bx0 // 8, by0 // 8
        tx1, ty1 = -(-bx1 // 8), -(-by1 // 8)
        lf_groups.append(encode_lf_group(
            data.dc[:, by0:by1, bx0:bx1], data.qf[by0:by1, bx0:bx1],
            data.cfl_x[ty0:ty1, tx0:tx1], data.cfl_b[ty0:ty1, tx0:tx1]))
    pass_groups = []
    gx = -(-w // GROUP_DIM)
    for gi in range(ng):
        bx0 = (gi % gx) * (GROUP_DIM // 8)
        by0 = (gi // gx) * (GROUP_DIM // 8)
        bx1 = min(bx0 + GROUP_DIM // 8, nx)
        by1 = min(by0 + GROUP_DIM // 8, ny)
        pass_groups.append(encode_pass_group(
            data.ac[:, by0:by1, bx0:bx1]))

    if single:
        sections.append(lf_global + lf_groups[0] + b"" + pass_groups[0])
    else:
        sections.append(lf_global)
        sections.extend(lf_groups)
        sections.append(b"")  # HfGlobal (unused: per-group histograms)
        sections.extend(pass_groups)

    write_frame_header(bw, fh, hdr)
    write_toc(bw, [len(s) for s in sections])
    for s in sections:
        for byte in s:
            bw.u(byte, 8)


def is_legacy_vardct_payload(hdr: ImageHeader, fh: FrameHeader,
                             toc) -> bool:
    """Detect the round-1 private VarDCT payload (encode_vardct_frame
    above) from the TOC alone, without decoding: its LfGlobal section is
    the fixed 2-byte F16 distance and its HfGlobal section is empty
    (histograms ride per pass group) — a combination no real-format
    stream produces (a real LfGlobal/HfGlobal always carries quantizer +
    context data).  Single-entry payloads (tiny one-group frames) are
    ambiguous and report False; callers route those through the
    real-format parser, which is the product default."""
    _, _, ng, ndc = section_layout(hdr, fh)
    if len(toc.entries) != 2 + ndc + ng:
        return False
    return (toc.section(0).size == 2
            and toc.section(1 + ndc).size == 0)


def decode_vardct_frame(cs: bytes, hdr: ImageHeader, fh: FrameHeader,
                        toc) -> VarDctFrameData:
    w, h, ng, ndc = section_layout(hdr, fh)
    nx, ny = grid_dims(w, h)
    tx, ty = -(-nx // 8), -(-ny // 8)
    single = len(toc.entries) == 1

    def section_bytes(i):
        e = toc.section(i)
        return cs[e.offset:e.offset + e.size]

    if single:
        # sections are concatenated; LfGlobal is fixed-size here (2 bytes)
        blob = section_bytes(0)
        distance = decode_lf_global(blob[:2])
        # LF group: decode from the remainder; modular stream is
        # self-terminating, but we need its byte length — decode with a
        # reader over the tail and note the consumed bytes.
        br = BitReader(blob[2:])
        chans = [Channel(nx, ny) for _ in range(3)] + [Channel(nx, ny)] + \
            [Channel(tx, ty), Channel(tx, ty)]
        img = ModularImage(chans)
        decode_modular_stream(br, img)
        br.zero_pad_to_byte()
        consumed = br.pos // 8
        dc = np.stack([img.channels[c].data for c in range(3)])
        qf = img.channels[3].data
        cfl_x = img.channels[4].data
        cfl_b = img.channels[5].data
        ac = decode_pass_group(blob[2 + consumed:], ny, nx)
        return VarDctFrameData(ac=ac, dc=dc, qf=qf, cfl_x=cfl_x,
                               cfl_b=cfl_b, distance=distance)

    distance = decode_lf_global(section_bytes(0))
    dc = np.zeros((3, ny, nx), np.int32)
    qf = np.zeros((ny, nx), np.int32)
    cfl_x = np.zeros((ty, tx), np.int32)
    cfl_b = np.zeros((ty, tx), np.int32)
    dgx = -(-nx // (LF_GROUP_DIM // 8))
    for gi in range(ndc):
        bx0 = (gi % dgx) * (LF_GROUP_DIM // 8)
        by0 = (gi // dgx) * (LF_GROUP_DIM // 8)
        bx1 = min(bx0 + LF_GROUP_DIM // 8, nx)
        by1 = min(by0 + LF_GROUP_DIM // 8, ny)
        tx0, ty0 = bx0 // 8, by0 // 8
        tx1, ty1 = -(-bx1 // 8), -(-by1 // 8)
        d, q, cx, cb = decode_lf_group(
            section_bytes(1 + gi), (by1 - by0, bx1 - bx0),
            (ty1 - ty0, tx1 - tx0))
        dc[:, by0:by1, bx0:bx1] = d
        qf[by0:by1, bx0:bx1] = q
        cfl_x[ty0:ty1, tx0:tx1] = cx
        cfl_b[ty0:ty1, tx0:tx1] = cb
    ac = np.zeros((3, ny, nx, 8, 8), np.int32)
    gx = -(-w // GROUP_DIM)
    for gi in range(ng):
        bx0 = (gi % gx) * (GROUP_DIM // 8)
        by0 = (gi // gx) * (GROUP_DIM // 8)
        bx1 = min(bx0 + GROUP_DIM // 8, nx)
        by1 = min(by0 + GROUP_DIM // 8, ny)
        ac[:, by0:by1, bx0:bx1] = decode_pass_group(
            section_bytes(2 + ndc + gi), by1 - by0, bx1 - bx0)
    return VarDctFrameData(ac=ac, dc=dc, qf=qf, cfl_x=cfl_x, cfl_b=cfl_b,
                           distance=distance)
