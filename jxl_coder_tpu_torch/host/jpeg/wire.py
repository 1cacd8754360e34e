"""Standard-wire JPEG<->JXL transcoding (spec jbrd + VarDCT frame): the
host part of ``jxl_coder_tpu/jpeg/wire.py``, the port's copy.

construct() emits a standard JXL container any decoder can open:
signature/ftyp boxes, the jbrd reconstruction bundle (jpeg/jbrd.py) and
a jxlc codestream holding a do_ycbcr VarDCT frame that carries the
exact quantized JPEG coefficients (RAW quant tables = the JPEG DQT,
global scale 65536/qf 1 so dequant is table-driven, all-DCT8 strategy
grid, no CfL).  reconstruct() parses either our own or libjxl/cjxl
constructed files back to the byte-identical JPEG.
read_jpeg_coefficients() is also the host half of a chroma-subsampled
frame's decode; the device half (dequantisation, IDCT, upsampling and
YCbCr -> RGB) is the device layer's ``jpeg/wire.py``.

Semantics mirror the reference's construct/reconstructJPEG
(interop/JxlConstruction.hpp:45-102, JxlReconstruction.hpp:44-88); the
frame layout follows what libjxl's JxlEncoderAddJPEGFrame emits (pinned
by parsing its output with our own decoder, see research/jbrd_diff.py
and docs/JBRD_FORMAT.md).
"""

from __future__ import annotations

import struct
from typing import List, Optional

import numpy as np

from ..bitstream.reader import BitReader
from ..bitstream.writer import BitWriter
from ..bitstream import container as container_mod
from ..bitstream.headers import (ImageHeader, ImageMetadata, SizeHeader,
                                 BitDepth, ColourEncoding, ColourSpace,
                                 read_image_header)
from ..bitstream.frame_header import (FrameHeader, Encoding,
                                      read_frame_header, read_toc,
                                      write_frame_header, write_toc)
from ..codec import write_image_header
from ..entropy.coder import TokenStream
from ..modular.image import Channel
from .parser import (parse_jpeg, JpegData, JpegError, ZIGZAG, Component,
                     HuffTable, ScanInfo)
from .writer import encode_scan
from . import jbrd as JB

_ZZINV = np.argsort(ZIGZAG)          # natural position -> zigzag index


def _scan_perm():
    """P such that vals_scan[k] = coeffs_zigzag[P[k]] for DCT8.  The
    calibrated scan order (synthesis.scan_to_basis) already lives in the
    transposed basis the RAW quant tables use, so the JPEG coefficients
    map through the plain zigzag (pinned by the libjxl reconstruction
    oracle, research/jbrd_diff.py)."""
    from ..vardct import synthesis as S
    order = np.asarray(S.scan_to_basis(0))       # scan -> jxl basis
    return _ZZINV[order]


def _jxl_channel_map(ncomp: int) -> List[int]:
    """jxl channel c in (0,1,2)=(X,Y,B)=(Cb,Y,Cr) -> jpeg component
    index (or -1 for an all-zero plane)."""
    if ncomp == 1:
        return [-1, 0, -1]
    if ncomp == 3:
        return [1, 0, 2]
    raise JpegError(f"unsupported JPEG component count {ncomp}")


def _upsampling_values(j: JpegData) -> tuple:
    """FrameHeader.jpeg_upsampling per jxl channel from the JPEG's
    sampling factors: value 0=1x1, 1=2x2, 2=2x1, 3=1x2 upsampling."""
    VAL = {(1, 1): 0, (2, 2): 1, (2, 1): 2, (1, 2): 3}
    cmap = _jxl_channel_map(len(j.components))
    vals = []
    for c in range(3):
        ci = cmap[c]
        if ci < 0:
            vals.append(0)
            continue
        comp = j.components[ci]
        key = (comp.h, comp.v)
        if key not in VAL:
            raise JpegError(f"unsupported sampling factors {key}")
        vals.append(VAL[key])
    if len(j.components) == 1:
        return (0, 0, 0)
    return tuple(vals)


def _frame_geometry(fh, hdr):
    """(xs_b, ys_b, shifts): MCU-aligned full block grid + per-channel
    stored-grid shifts for a (possibly chroma-subsampled) jpeg frame."""
    from ..vardct import dec_real as D
    w, h = fh.coded_size(hdr)
    shifts = D.jpeg_shifts(fh)
    if shifts is None:
        return -(-w // 8), -(-h // 8), None
    hs_max = max(hs for hs, _ in shifts)
    vs_max = max(vs for _, vs in shifts)
    xs_b = -(-w // (8 << hs_max)) << hs_max
    ys_b = -(-h // (8 << vs_max)) << vs_max
    return xs_b, ys_b, shifts


# ---------------------------------------------------------------------------
# construct

def _write_jpeg_group_tokens(ts, coeffs, ax, ay, gw, gh, shifts):
    """AC tokens for one 256px group of a chroma-subsampled DCT8-only
    frame: raster over the full (luma) grid, subsampled channels
    anchored at bx % 2^hs == 0 / by % 2^vs == 0, channel order
    (1, 0, 2) — the mirror of dec_real.read_pass_group."""
    from ..vardct.enc_real import NUM_CTXS
    from ..vardct.dec_real import (DEFAULT_CTX_MAP, NONZERO_BUCKETS,
                                   ZERO_DENSITY_CTX_COUNT, nonzero_ctx,
                                   zero_density_ctx)
    from ..bitstream.reader import pack_signed
    nz_map = {c: np.zeros((gh >> shifts[c][1], gw >> shifts[c][0]),
                          np.int32) for c in range(3)}
    for by in range(gh):
        for bx in range(gw):
            for c in (1, 0, 2):
                hs, vs = shifts[c]
                if (bx & ((1 << hs) - 1)) or (by & ((1 << vs) - 1)):
                    continue
                cby, cbx = by >> vs, bx >> hs
                vals = coeffs[c][(ay >> vs) + cby, (ax >> hs) + cbx]
                nzm = nz_map[c]
                if cby == 0:
                    predicted = 32 if cbx == 0 else int(nzm[cby, cbx - 1])
                elif cbx == 0:
                    predicted = int(nzm[cby - 1, cbx])
                else:
                    predicted = (int(nzm[cby - 1, cbx])
                                 + int(nzm[cby, cbx - 1]) + 1) // 2
                bctx = DEFAULT_CTX_MAP[((c ^ 1) if c < 2 else 2) * 13]
                nz = int(np.count_nonzero(vals[1:]))
                nzm[cby, cbx] = nz
                ts.add(nonzero_ctx(predicted, bctx, NUM_CTXS), nz)
                ctx_off = NUM_CTXS * NONZERO_BUCKETS \
                    + ZERO_DENSITY_CTX_COUNT * bctx
                prev = 0 if nz > 4 else 1       # size >> 4 == 4
                nzeros = nz
                k = 1
                while nzeros > 0:
                    v = int(vals[k])
                    ctx = ctx_off + zero_density_ctx(nzeros, k, 1, 0,
                                                     prev)
                    ts.add(ctx, pack_signed(v))
                    prev = 1 if v else 0
                    nzeros -= prev
                    k += 1


def write_jpeg_codestream(j: JpegData, _ytox=None, _ytob=None) -> bytes:
    """JPEG coefficients -> bare JXL codestream (one VarDCT frame).

    _ytox/_ytob: 64px-tile cmap grids, research hook for pinning the
    integer-CfL semantics against libjxl (production writes zeros)."""
    from ..vardct.enc_real import (_modular_substream, _write_ac_tokens,
                                   NUM_CTXS)
    from ..vardct.selected import SelectedFlat
    from ..vardct.dec_real import (NONZERO_BUCKETS,
                                   ZERO_DENSITY_CTX_COUNT)
    if j.precision != 8:
        raise JpegError("construct: only 8-bit JPEGs supported")
    W, H = j.width, j.height
    ncomp = len(j.components)
    cmap = _jxl_channel_map(ncomp)
    perm = _scan_perm()
    ups = _upsampling_values(j)

    m = ImageMetadata()
    m.xyb_encoded = False
    m.bit_depth = BitDepth(False, 8, 0)
    ce = ColourEncoding()
    if ncomp == 1:
        ce.colour_space = ColourSpace.GREY
    m.colour_encoding = ce
    hdr = ImageHeader(size=SizeHeader(xsize=W, ysize=H), metadata=m)
    fh = FrameHeader(encoding=Encoding.VARDCT, flags=0x80,
                     do_ycbcr=True, jpeg_upsampling=ups)
    fh.restoration_filter.gab = False
    fh.restoration_filter.epf_iters = 0
    fh.is_last = True
    xs_b, ys_b, shifts = _frame_geometry(fh, hdr)

    def cdims(c):
        if shifts is None:
            return xs_b, ys_b
        return xs_b >> shifts[c][0], ys_b >> shifts[c][1]

    # per-jxl-channel scan-ordered coefficient array on its own grid
    coeffs = {}
    dc_chan = {}       # modular channel index (Y, X, B order) -> ints
    for c in range(3):
        cw_, ch_ = cdims(c)
        ci = cmap[c]
        if ci < 0:
            coeffs[c] = np.zeros((ch_, cw_, 64), np.int32)
            continue
        comp = j.components[ci]
        if comp.blocks_h < ch_ or comp.blocks_w < cw_:
            raise JpegError("JPEG block grid smaller than frame grid")
        cz = comp.coeffs[:ch_, :cw_]             # zigzag order
        coeffs[c] = np.ascontiguousarray(cz[:, :, perm])
    for mc, c in ((0, 1), (1, 0), (2, 2)):
        dc_chan[mc] = coeffs[c][:, :, 0].astype(np.int32)

    # dcq: (x, y, b) = jpeg DC quant / 2040 (grayscale: Y replicated)
    qtab = {c: j.quant[j.components[cmap[c]].tq] if cmap[c] >= 0
            else j.quant[j.components[0].tq] for c in range(3)}
    dcq = [qtab[c][0] / 2040.0 for c in range(3)]

    gd_b, lf_b = 32, 256
    gx, gy = -(-xs_b // gd_b), -(-ys_b // gd_b)
    ng = gx * gy
    gx_lf, gy_lf = -(-xs_b // lf_b), -(-ys_b // lf_b)
    ndc = gx_lf * gy_lf

    def lf_global_bits():
        w_ = BitWriter()
        w_.bool(False)                       # custom dc_quant
        for v in dcq:
            w_.f16(v * 128.0)
        w_.u32(65536, (11, 1), (11, 2049), (12, 4097), (16, 8193))
        w_.u32(1, 16, (5, 1), (8, 1), (16, 1))   # quant_dc = 1
        w_.bool(True)                        # default block ctx map
        w_.bool(False)                       # custom cfl block
        w_.u32(84, 84, 256, (8, 2), (16, 258))
        w_.f16(0.0)                          # base_x
        w_.f16(0.0)                          # base_b
        w_.u(128, 8)                         # ytox_dc
        w_.u(128, 8)                         # ytob_dc
        w_.bool(False)                       # no global tree
        return w_

    def lf_group_bits(gi):
        lx = (gi % gx_lf) * lf_b
        ly = (gi // gx_lf) * lf_b
        gw = min(lf_b, xs_b - lx)
        gh = min(lf_b, ys_b - ly)
        w_ = BitWriter()
        w_.u(0, 2)                           # extra_precision
        dc_chs = []
        for mc, c in ((0, 1), (1, 0), (2, 2)):
            hs, vs = (0, 0) if shifts is None else shifts[c]
            dc_chs.append(Channel(
                gw >> hs, gh >> vs, hshift=hs, vshift=vs,
                data=np.ascontiguousarray(
                    dc_chan[mc][ly >> vs:(ly + gh) >> vs,
                                lx >> hs:(lx + gw) >> hs], np.int32)))
        w_.append_writer(_modular_substream(dc_chs, learn=True,
                                            max_leaves=24))
        nb = gw * gh                         # all blocks are DCT8
        cb = (nb - 1).bit_length() if nb > 1 else 0
        w_.u(nb - 1, cb)
        blockinfo = np.zeros((2, nb), np.int32)   # strategy 0, qf-1 = 0
        cw, ch = -(-gw // 8), -(-gh // 8)
        tx0, ty0 = lx // 8, ly // 8
        tiles = []
        for src in (_ytox, _ytob):
            if src is None:
                tiles.append(np.zeros((ch, cw), np.int32))
            else:
                tiles.append(np.ascontiguousarray(
                    src[ty0:ty0 + ch, tx0:tx0 + cw], np.int32))
        w_.append_writer(_modular_substream([
            Channel(cw, ch, hshift=3, vshift=3, data=tiles[0]),
            Channel(cw, ch, hshift=3, vshift=3, data=tiles[1]),
            Channel(nb, 2, data=blockinfo),
            Channel(gw, gh, data=np.zeros((gh, gw), np.int32))],
            learn=True, max_leaves=24))
        return w_

    def hf_global_bits():
        from ..vardct import quant_tables as QTab
        w_ = BitWriter()
        w_.bool(False)                       # custom quant encodings
        for idx in range(QTab.NUM_QUANT_TABLES):
            if idx == 0:
                w_.u(7, 3)                   # MODE_RAW
                w_.f16(1.0 / 2040.0)
                w_.append_writer(_modular_substream([
                    Channel(8, 8, data=np.ascontiguousarray(
                        qtab[c][_ZZINV].reshape(8, 8).T.astype(
                            np.int32)))
                    for c in range(3)], learn=True, max_leaves=12))
            else:
                w_.u(0, 3)                   # MODE_LIBRARY
        if ng > 1:
            w_.u(0, (ng - 1).bit_length())   # num_histograms = 1
        w_.u32(0, 0x5F, 0x13, 0, (13, 0))    # no custom orders
        return w_

    def group_tokens(gi, ts):
        ax = (gi % gx) * gd_b
        ay = (gi // gx) * gd_b
        gw = min(gd_b, xs_b - ax)
        gh = min(gd_b, ys_b - ay)
        if shifts is None:
            _write_ac_tokens(ts, SelectedFlat.all_dct8(np.stack(
                [coeffs[c][ay:ay + gh, ax:ax + gw] for c in range(3)],
                axis=2)), gw, gh)
        else:
            _write_jpeg_group_tokens(ts, coeffs, ax, ay, gw, gh, shifts)

    nctx = NUM_CTXS * (NONZERO_BUCKETS + ZERO_DENSITY_CTX_COUNT)
    if ng == 1 and ndc == 1:
        sec = lf_global_bits()
        sec.append_writer(lf_group_bits(0))
        sec.append_writer(hf_global_bits())
        ts = TokenStream(nctx, use_ans=True)
        group_tokens(0, ts)
        ts.write(sec)
        sec.zero_pad_to_byte()
        payloads = [sec.to_bytes()]
    else:
        all_ts = [TokenStream(nctx, use_ans=True) for _ in range(ng)]
        for gi in range(ng):
            group_tokens(gi, all_ts[gi])
        joint = TokenStream(nctx, use_ans=True)
        for t in all_ts:
            joint.extend_from(t)
        hfb = hf_global_bits()
        shared = joint.write_histograms(hfb)
        sections = []
        for gi in range(ng):
            gw_ = BitWriter()
            all_ts[gi].write_symbols(gw_, shared)
            gw_.zero_pad_to_byte()
            sections.append(gw_.to_bytes())
        lfg = lf_global_bits()
        lfg.zero_pad_to_byte()
        payloads = [lfg.to_bytes()]
        for gi in range(ndc):
            b = lf_group_bits(gi)
            b.zero_pad_to_byte()
            payloads.append(b.to_bytes())
        hfb.zero_pad_to_byte()
        payloads.append(hfb.to_bytes())
        payloads.extend(sections)

    bw = BitWriter()
    write_image_header(bw, hdr)
    write_frame_header(bw, fh, hdr)
    write_toc(bw, [len(p) for p in payloads])
    return bw.to_bytes() + b"".join(payloads)


def construct(jpeg_data: bytes) -> bytes:
    """JPEG -> standard JXL container (jbrd + VarDCT codestream)."""
    j = parse_jpeg(jpeg_data)
    if j.dri_count > 1:
        # jbrd stores a single DRI; the reference rejects multi-DRI
        # files the same way (enc_jpeg_data_reader.cc "Duplicate DRI")
        raise JpegError("multiple DRI markers cannot be represented "
                        "losslessly (jbrd stores one restart interval)")
    jbrd_payload = JB.write_jbrd(JB.jbrd_from_jpeg(j))
    cs = write_jpeg_codestream(j)
    out = bytearray()
    out += container_mod.MAGIC_CONTAINER
    ftyp = b"jxl \x00\x00\x00\x00jxl "
    out += struct.pack(">I", 8 + len(ftyp)) + b"ftyp" + ftyp
    out += struct.pack(">I", 8 + len(jbrd_payload)) + b"jbrd" \
        + jbrd_payload
    out += struct.pack(">I", 8 + len(cs)) + b"jxlc" + cs
    return bytes(out)


# ---------------------------------------------------------------------------
# reconstruct

def read_jpeg_coefficients(cs: bytes):
    """Bare codestream of a JPEG-recompression frame -> (hdr, fh,
    dc_int {modular chan: ints on its grid}, vals {jxl chan:
    (ch, cw, 64) scan-order ints with CfL undone in the integer
    domain}, quant tables (3, 8, 8) transposed, LfGlobal)."""
    from ..vardct import dec_real as D
    br = BitReader(cs)
    hdr = read_image_header(br)
    fh = read_frame_header(br, hdr)
    if fh.encoding != Encoding.VARDCT or not fh.do_ycbcr:
        raise JpegError("not a JPEG-recompression VarDCT frame")
    w, h = fh.coded_size(hdr)
    xs_b, ys_b, shifts = _frame_geometry(fh, hdr)
    ng, ndc = fh.counts(hdr)
    npasses = fh.passes.num_passes
    if npasses != 1:
        raise JpegError("multi-pass JPEG frames not supported")
    toc = read_toc(br, 1 + (0 if ng == 1 and ndc == 1
                            else 1 + ndc + ng))
    br.zero_pad_to_byte()
    single = len(toc.entries) == 1
    if single:
        s0 = toc.section(0)
        _single = BitReader(cs[s0.offset:s0.offset + s0.size])

    def brs(idx):
        if single:
            return _single
        s = toc.section(idx)
        return BitReader(cs[s.offset:s.offset + s.size])

    lf = D.read_lf_global(brs(0), fh, hdr, w, h)
    if shifts is not None and (lf.bcm.dc_thresholds != [[], [], []]
                               or lf.bcm.qf_thresholds):
        raise JpegError("dc/qf block-context thresholds with chroma "
                        "subsampling are not supported")
    lf_b = 256
    gx_lf = -(-xs_b // lf_b)
    lgs = []
    for gi in range(ndc):
        lx = (gi % gx_lf) * lf_b
        ly = (gi // gx_lf) * lf_b
        gw = min(lf_b, xs_b - lx)
        gh = min(lf_b, ys_b - ly)
        lgs.append((lx, ly, D.read_lf_group(brs(1 + gi), lf, gw, gh,
                                            gi, ndc, shifts=shifts)))
    hf = D.read_hf_global(brs(1 + ndc), lf, ng, npasses, ndc)
    if lf.quant_encodings is None \
            or lf.quant_encodings[0].mode != 7:
        raise JpegError("frame lacks RAW quant tables")
    qraw = np.asarray(lf.quant_encodings[0].qraw)   # (3, 8, 8) transposed
    histo_bits = (hf.num_histograms - 1).bit_length() \
        if hf.num_histograms > 1 else 0

    def cdims(c):
        return D._chan_dims(xs_b, ys_b, shifts, c)

    gd_b = 32
    gx = -(-xs_b // gd_b)
    dc_int = {}
    for mc, c in ((0, 1), (1, 0), (2, 2)):
        cw_, ch_ = cdims(c)
        dc_int[mc] = np.zeros((ch_, cw_), np.int64)
    ytox = np.zeros((-(-ys_b // 8), -(-xs_b // 8)), np.int64)
    ytob = np.zeros_like(ytox)
    for lx, ly, lg in lgs:
        if not (lg.acs_map == 0).all():
            raise JpegError("JPEG frame contains non-DCT8 strategies")
        for mc, c in ((0, 1), (1, 0), (2, 2)):
            hs, vs = (0, 0) if shifts is None else shifts[c]
            d = lg.dc.channels[mc].data
            dc_int[mc][ly >> vs:(ly >> vs) + d.shape[0],
                       lx >> hs:(lx >> hs) + d.shape[1]] = d
        th_, tw_ = lg.ytox.shape
        ytox[ly // 8:ly // 8 + th_, lx // 8:lx // 8 + tw_] = lg.ytox
        ytob[ly // 8:ly // 8 + th_, lx // 8:lx // 8 + tw_] = lg.ytob

    vals = {}
    for c in range(3):
        cw_, ch_ = cdims(c)
        vals[c] = np.zeros((ch_, cw_, 64), np.int32)
    for gi in range(ng):
        ax = (gi % gx) * gd_b
        ay = (gi // gx) * gd_b
        gw = min(gd_b, xs_b - ax)
        gh = min(gd_b, ys_b - ay)
        lgi = (ay // lf_b) * gx_lf + (ax // lf_b)
        lx, ly, lg = lgs[lgi]
        sub = D._lf_group_view(lg, ax - lx, ay - ly, gw, gh)
        if shifts is None:
            dc_q = np.stack([sub.dc.channels[1].data,
                             sub.dc.channels[0].data,
                             sub.dc.channels[2].data])
        else:
            # dc thresholds are empty (checked above): the context index
            # is constant, the per-block dc values are never consulted
            dc_q = np.zeros((3, gh, gw), np.int64)
        histo = 0
        sidx = 2 + ndc + gi
        b = brs(sidx)
        if histo_bits:
            histo = b.u(histo_bits)
        blocks = D.read_pass_group(b, lf, hf, sub, gw, gh, 0, histo,
                                   dc_q, shifts=shifts)
        for vb in blocks:
            for c, v in vb.values.items():
                hs, vs = (0, 0) if shifts is None else shifts[c]
                vals[c][(ay + vb.by) >> vs, (ax + vb.bx) >> hs] = v

    lf.tile_ytox, lf.tile_ytob = ytox, ytob
    # integer-domain CfL undo (libjxl applies chroma-from-luma on the
    # quantized ints with a fixed-point scale; our own files write zero
    # cmap so this is a no-op for them, and libjxl disables CfL for
    # subsampled jpeg frames)
    if ytox.any() or ytob.any() or lf.cfl_ytox_dc or lf.cfl_ytob_dc:
        if shifts is not None:
            raise JpegError("chroma-from-luma on a subsampled JPEG "
                            "frame is not supported")
        vals3 = np.stack([vals[0], vals[1], vals[2]])
        vals3, _ = _undo_integer_cfl(vals3, dc_int, qraw, ytox, ytob,
                                     lf)
        vals = {c: vals3[c] for c in range(3)}
    return hdr, fh, dc_int, vals, qraw, lf


_CFL_PREC = 11  # kCFLFixedPointPrecision


def _undo_integer_cfl(vals, dc_int, qraw, ytox, ytob, lf):
    """Add the luma prediction back to the stored chroma residuals,
    exactly as libjxl's jpeg decode path does.  The integer fixed-point
    pipeline was pinned to ZERO mismatches over controlled probe
    streams + five libjxl-constructed images (research/jbrd_diff.py):

        qr    = (qt_y[pos] << 11) // qt_c[pos]    (plain JPEG layout)
        scale = trunc(tile * 2048 / 84)           (C division)
        F     = (qr * scale + 1024) >> 11
        pred  = (coeff_y * F + 1024) >> 11
    """
    if lf.cfl_ytox_dc or lf.cfl_ytob_dc:
        raise JpegError("nonzero DC chroma-from-luma in a JPEG frame "
                        "is not supported")
    basis = _scan_perm_basis()
    # plain-JPEG-position quant tables: the RAW planes are stored
    # transposed, and the basis index IS the JPEG natural position
    qt = {c: qraw[c].T.reshape(-1).astype(np.int64)[basis]
          for c in range(3)}
    ys_b, xs_b = vals.shape[1:3]
    ty = np.arange(ys_b) // 8
    tx = np.arange(xs_b) // 8
    half = np.int64(1) << (_CFL_PREC - 1)
    cf = float(lf.cfl_color_factor)
    y_vals = vals[1].astype(np.int64)
    for c, tiles in ((0, ytox), (2, ytob)):
        scale = np.trunc(tiles[ty][:, tx] * (1 << _CFL_PREC)
                         / cf).astype(np.int64)
        qr = (qt[1] << _CFL_PREC) // np.maximum(qt[c], 1)
        fac = (qr[None, None, :] * scale[:, :, None] + half) >> _CFL_PREC
        pred = (y_vals * fac + half) >> _CFL_PREC
        v = vals[c].astype(np.int64) + pred
        v[:, :, 0] = vals[c][:, :, 0]       # DC rides in the DC image
        vals[c] = v.astype(np.int32)
    return vals, dc_int


def _scan_perm_basis():
    """scan position -> basis index for DCT8 (transposed layout)."""
    from ..vardct import synthesis as S
    return np.asarray(S.scan_to_basis(0))


def jpeg_from_parts(jb: JB.JbrdData, hdr, fh, dc_int, vals, qraw,
                    exif: Optional[bytes] = None,
                    xml: Optional[List[bytes]] = None) -> bytes:
    """Reassemble the byte-exact JPEG from bundle + coefficients."""
    W, H = hdr.size.xsize, hdr.size.ysize
    xs_b, ys_b, shifts = _frame_geometry(fh, hdr)
    ncomp = jb.num_components
    cmap = _jxl_channel_map(ncomp)
    perm = _scan_perm()
    inv = np.argsort(perm)              # zigzag index -> scan index

    j = JpegData()
    j.width, j.height = W, H
    j.precision = 8
    j.restart_interval = jb.restart_interval
    hs_max = 0 if shifts is None else max(h for h, _ in shifts)
    vs_max = 0 if shifts is None else max(v for _, v in shifts)
    # quant tables from RAW codestream tables (transposed back),
    # indexed by the jbrd quant metadata: table q.index serves the
    # first component that references it; that component's jxl channel
    # picks the RAW plane
    chan_for_index = {}
    for i, qi in enumerate(jb.quant_idx):
        if qi not in chan_for_index and i in cmap:
            chan_for_index[qi] = cmap.index(i)
    for q in jb.quant:
        jc = chan_for_index.get(q.index, 1)
        nat = qraw[jc].T.reshape(-1)          # jpeg natural order
        j.quant[q.index] = nat[ZIGZAG].astype(np.int32)
    # components
    for i, cid in enumerate(jb.component_ids):
        jxl_c = cmap.index(i)
        hs, vs = (0, 0) if shifts is None else shifts[jxl_c]
        comp = Component(cid, (1 << hs_max) >> hs, (1 << vs_max) >> vs,
                         jb.quant_idx[i])
        comp.blocks_w, comp.blocks_h = xs_b >> hs, ys_b >> vs
        zz = np.ascontiguousarray(vals[jxl_c][:, :, inv])
        mc = {1: 0, 0: 1, 2: 2}[jxl_c]
        zz[:, :, 0] = dc_int[mc]
        comp.coeffs = zz
        j.components.append(comp)
    j.hmax, j.vmax = 1 << hs_max, 1 << vs_max
    j.mcus_x, j.mcus_y = xs_b >> hs_max, ys_b >> vs_max
    # huffman tables
    for h in jb.huffman:
        counts, values = JB.strip_sentinel(h)
        from .parser import HuffTable
        tbl = HuffTable(counts, values)
        (j.ac_tables if h.is_ac else j.dc_tables)[h.id] = tbl
    # non-canonical encodings (restart-point resyncs mid-scan, extra
    # zero runs) are not reproduced; emitting bytes anyway would break
    # the byte-identical contract silently
    for sc in jb.scans:
        if sc.reset_points or sc.extra_zero_runs:
            raise JpegError("scan reset points / extra zero runs not "
                            "supported yet")
    sc0 = jb.scans[0]
    for comp_sel in sc0.components:
        c = j.components[comp_sel.comp_idx]
        c.td, c.ta = comp_sel.dc_tbl, comp_sel.ac_tbl
    j.progressive = 0xC2 in jb.marker_order
    j.trailer_bytes = b"\xff\xd9" + jb.tail_data
    j.padding_bits = list(jb.padding_bits)
    # walk the marker order, regenerating header segments and
    # re-encoding each scan's entropy data in place (baseline and
    # progressive/multi-scan alike)
    return _regenerate_file(jb, j, exif, xml)


def _regenerate_file(jb: JB.JbrdData, j: JpegData,
                     exif: Optional[bytes],
                     xml: Optional[List[bytes]]) -> bytes:
    """Walk the jbrd marker order, regenerating every header segment
    and re-encoding each scan's entropy data in place (the Huffman
    tables and restart interval in effect at each scan are tracked as
    the DHT/DRI markers stream by)."""
    out = bytearray(b"\xff\xd8")
    app_i = com_i = dqt_i = dht_i = scan_i = 0
    xml = list(xml or [])
    dc_tabs = {}
    ac_tabs = {}
    ri_active = 0
    pads = jb.padding_bits
    pad_iter = iter(pads) if pads and 0 in pads else None
    for m in jb.marker_order:
        if m == 0xD9:
            break
        if 0xE0 <= m <= 0xEF:
            payload = jb.app_data[app_i]
            t = jb.app_marker_types[app_i]
            seglen = (jb.app_lens[app_i]
                      if app_i < len(jb.app_lens) and jb.app_lens[app_i]
                      else len(payload))
            if t == JB.APP_EXIF:
                if exif is None:
                    raise JpegError("jbrd needs an Exif box")
                body = b"Exif\x00\x00" + exif[4:]
                payload = bytes([m]) + struct.pack(">H", seglen - 1) \
                    + body[:seglen - 3]
            elif t == JB.APP_XMP:
                if not xml:
                    raise JpegError("jbrd needs an xml box")
                body = b"http://ns.adobe.com/xap/1.0/\x00" + xml.pop(0)
                payload = bytes([m]) + struct.pack(">H", seglen - 1) \
                    + body[:seglen - 3]
            elif t != JB.APP_UNKNOWN:
                raise JpegError("ICC app markers not supported yet")
            out += b"\xff" + payload
            app_i += 1
        elif m == 0xFE:
            out += b"\xff" + jb.com_data[com_i]
            com_i += 1
        elif m == 0xDB:
            seg = bytearray()
            while dqt_i < len(jb.quant):
                q = jb.quant[dqt_i]
                tbl = j.quant[q.index]
                seg.append((q.precision << 4) | q.index)
                if q.precision:
                    for v in tbl:
                        seg += struct.pack(">H", int(v))
                else:
                    seg += bytes(int(v) & 0xFF for v in tbl)
                dqt_i += 1
                if q.is_last:
                    break
            out += b"\xff\xdb" + struct.pack(">H", len(seg) + 2) + seg
        elif m in (0xC0, 0xC1, 0xC2):
            seg = bytearray([j.precision])
            seg += struct.pack(">H", j.height)
            seg += struct.pack(">H", j.width)
            seg.append(len(j.components))
            for c in j.components:
                seg += bytes([c.id, (c.h << 4) | c.v, c.tq])
            out += bytes([0xFF, m]) + struct.pack(">H", len(seg) + 2) \
                + seg
        elif m == 0xC4:
            seg = bytearray()
            while dht_i < len(jb.huffman):
                hcode = jb.huffman[dht_i]
                counts, values = JB.strip_sentinel(hcode)
                seg.append((int(hcode.is_ac) << 4) | hcode.id)
                seg += bytes(counts)
                seg += bytes(values)
                tbl = HuffTable(counts, values)
                (ac_tabs if hcode.is_ac else dc_tabs)[hcode.id] = tbl
                dht_i += 1
                if hcode.is_last:
                    break
            out += b"\xff\xc4" + struct.pack(">H", len(seg) + 2) + seg
        elif m == 0xDD:
            out += b"\xff\xdd\x00\x04" \
                + struct.pack(">H", jb.restart_interval)
            ri_active = jb.restart_interval
        elif m == 0xDA:
            sc = jb.scans[scan_i]
            seg = bytearray([len(sc.components)])
            for comp_sel in sc.components:
                c = j.components[comp_sel.comp_idx]
                seg += bytes([c.id,
                              (comp_sel.dc_tbl << 4) | comp_sel.ac_tbl])
            seg += bytes([sc.Ss, sc.Se, (sc.Ah << 4) | sc.Al])
            out += b"\xff\xda" + struct.pack(">H", len(seg) + 2) + seg
            scan_i += 1
            si = ScanInfo(
                comp_idx=[cs.comp_idx for cs in sc.components],
                Ss=sc.Ss, Se=sc.Se, Ah=sc.Ah, Al=sc.Al,
                td={cs.comp_idx: cs.dc_tbl for cs in sc.components},
                ta={cs.comp_idx: cs.ac_tbl for cs in sc.components},
                dc_tables=dict(dc_tabs), ac_tables=dict(ac_tabs),
                restart_interval=ri_active)
            # the legacy baseline path carries td/ta on the components
            for cs in sc.components:
                j.components[cs.comp_idx].td = cs.dc_tbl
                j.components[cs.comp_idx].ta = cs.ac_tbl
            out += encode_scan(j, si, pad_iter=pad_iter)
        else:
            raise JpegError(f"cannot regenerate marker {m:#x}")
    out += j.trailer_bytes
    return bytes(out)


def reconstruct(data: bytes) -> bytes:
    """Standard recompressed JXL (ours or libjxl's) -> original JPEG."""
    cont = container_mod.extract_codestream(data)
    if cont.jpeg_reconstruction_data is None:
        raise JpegError("no jbrd box: not a recompressed-JPEG file")
    jb = JB.parse_jbrd(cont.jpeg_reconstruction_data)
    hdr, fh, dc_int, vals, qraw, lf = \
        read_jpeg_coefficients(cont.codestream)
    return jpeg_from_parts(jb, hdr, fh, dc_int, vals, qraw,
                           exif=cont.exif, xml=cont.xml)
