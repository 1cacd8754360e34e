"""Real-format VarDCT frame decoding (wire-compatible with libjxl).

The port's copy of ``jxl_coder_tpu/vardct/dec_real.py``: the readers,
``BlockArrays``, the DC planes and their adaptive smoothing, and the
float64 host reconstruction (``decode_vardct_frame``), which the port
holds its device decode against, with its post stages: patches (from
the reference frames decoded before it), splines, noise, 2x/4x/8x
upsampling, the gamma, PQ, HLG or other signalled output encoding, and
the extra channels; a frame may take its DC from an LF frame
(``dc_frame``), and an LF or reference frame returns its XYB planes
(``return_xyb``); a YCbCr frame (JPEG recompression) outputs BT.601 RGB
(``ycbcr_planes_to_rgb``), and with chroma subsampling raises
NotImplementedError (``check_ycbcr``: such a frame decodes through the
JPEG route).  The JAX device routes are gone.  An
extra channel whose stream
fails to decode raises; the original substitutes an opaque plane
(fault R6 of ROADMAP.md).  The native host codec is required; nothing
falls back to pure Python.

Layer map (cf. reference dec_frame.cc / dec_group.cc call stacks):
  LfGlobal  : dc-dequant factors, quantizer, block context map,
              colour-correlation DC, global modular (tree+histograms)
  LfGroup   : extra_precision + quantized DC modular stream (Y, X, B),
              AC metadata modular stream (cfl tiles, acs+qf, sharpness)
  HfGlobal  : dequant matrices, num_histograms, per-pass coefficient
              orders + AC histograms
  PassGroup : per-block nonzero counts + coefficients over the
              zero-density context model

Dequant tables are pinned NUMERICALLY against libjxl (single-coefficient
probe streams decoded with float output; see research/vardct_write.py),
not copied: the stored table is the observed response of the reference
decoder.  DCT convention: DC equals the block mean; AC basis
cos(pi(2x+1)k/16) with amplitude sqrt(2); stored index k maps to basis
(ky=k%8, kx=k//8) (transposed storage).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..bitstream.reader import BitReader, BitstreamError, unpack_signed
from ..entropy.coder import read_cluster_map, EntropyCode, EntropyDecoder
from ..modular.tree import decode_tree
from ..modular.stream import decode_modular_stream
from ..modular.image import Channel, ModularImage

# ---------------------------------------------------------------------------
# Constants (block context model, §ac_context)

DEFAULT_CTX_MAP = [
    0, 1, 2, 2, 3, 3, 4, 5, 6, 6, 6, 6, 6,
    7, 8, 9, 9, 10, 11, 12, 13, 14, 14, 14, 14, 14,
    7, 8, 9, 9, 10, 11, 12, 13, 14, 14, 14, 14, 14]

ZIGZAG8 = [
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63]

K_COEFF_FREQ_CTX = [
    0xBAD, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14,
    15, 15, 16, 16, 17, 17, 18, 18, 19, 19, 20, 20, 21, 21, 22, 22,
    23, 23, 23, 23, 24, 24, 24, 24, 25, 25, 25, 25, 26, 26, 26, 26,
    27, 27, 27, 27, 28, 28, 28, 28, 29, 29, 29, 29, 30, 30, 30, 30]
K_NUM_NZ_CTX = [
    0xBAD, 0, 31, 62, 62, 93, 93, 93, 93, 123, 123, 123, 123,
    152, 152, 152, 152, 152, 152, 152, 152, 180, 180, 180, 180, 180,
    180, 180, 180, 180, 180, 180, 180, 206, 206, 206, 206, 206, 206,
    206, 206, 206, 206, 206, 206, 206, 206, 206, 206, 206, 206, 206,
    206, 206, 206, 206, 206, 206, 206, 206, 206, 206, 206, 206]
ZERO_DENSITY_CTX_COUNT = 458
NONZERO_BUCKETS = 37
NUM_ORDERS = 13


def zero_density_ctx(nzeros_left, k, covered, log2cov, prev):
    nzeros_left = (nzeros_left + covered - 1) >> log2cov
    k >>= log2cov
    return (K_NUM_NZ_CTX[nzeros_left] + K_COEFF_FREQ_CTX[k]) * 2 + prev


def nonzero_ctx(predicted, block_ctx, num_ctxs):
    if predicted >= 64:
        predicted = 64
    ctx = predicted if predicted < 8 else 4 + predicted // 2
    return ctx * num_ctxs + block_ctx


@dataclasses.dataclass
class BlockCtxMap:
    ctx_map: List[int]
    dc_thresholds: List[List[int]]
    qf_thresholds: List[int]

    @property
    def num_ctxs(self):
        return max(self.ctx_map) + 1

    @property
    def num_dc_ctxs(self):
        n = 1
        for t in self.dc_thresholds:
            n *= len(t) + 1
        return n

    def context(self, dc_idx, qf, ord_, c):
        qf_idx = sum(1 for t in self.qf_thresholds if qf > t)
        idx = (c ^ 1) if c < 2 else 2
        idx = idx * NUM_ORDERS + ord_
        idx = idx * (len(self.qf_thresholds) + 1) + qf_idx
        idx = idx * self.num_dc_ctxs + dc_idx
        return self.ctx_map[idx]

    @staticmethod
    def read(br: BitReader) -> "BlockCtxMap":
        if br.bool():
            return BlockCtxMap(list(DEFAULT_CTX_MAP), [[], [], []], [])
        dc_th = []
        num_dc = 1
        for _ in range(3):
            nt = br.u(4)
            dc_th.append([unpack_signed(
                br.u32((4, 0), (8, 16), (16, 272), (32, 65808)))
                for _ in range(nt)])
            num_dc *= nt + 1
        nq = br.u(4)
        qf_th = [br.u32((2, 0), (3, 4), (5, 12), (8, 44)) + 1
                 for _ in range(nq)]
        size = 3 * NUM_ORDERS * num_dc * (nq + 1)
        if size > 3 * 64:
            raise BitstreamError("block ctx map too large")
        cmap = read_cluster_map(br, size)
        return BlockCtxMap(cmap, dc_th, qf_th)


@dataclasses.dataclass
class LfGlobal:
    dcq: Tuple[float, float, float]
    global_scale: int
    quant_dc: int
    bcm: BlockCtxMap
    cfl_color_factor: int = 84
    cfl_base_x: float = 0.0
    cfl_base_b: float = 1.0
    cfl_ytox_dc: int = 0
    cfl_ytob_dc: int = 0
    gtree: Optional[object] = None
    gcode: Optional[EntropyCode] = None
    mfd: Optional[object] = None
    noise_lut: Optional[list] = None
    patches: Optional[object] = None    # patches.PatchDictionary
    splines: Optional[object] = None    # splines.Splines

    @property
    def inv_global_scale(self):
        return 65536.0 / self.global_scale


def read_lf_global(br: BitReader, fh, hdr=None, frame_w=None,
                   frame_h=None) -> LfGlobal:
    """LfGlobal; with `hdr` given and extra channels signalled, also their
    global Modular stream (lf.mfd, a ModularFrameDecoder whose group
    streams follow each pass group's AC tokens).  A failing extra-channel
    stream raises (the original substitutes opaque planes, R6)."""
    # allowed: kNoise (0x1), kPatches (0x2), kSplines (0x10),
    # kUseDcFrame (0x20), kSkipSmoothing (0x80)
    if fh.flags & ~0xB3:
        raise BitstreamError(
            "frame flags %#x not supported" % fh.flags)
    patches = None
    if fh.flags & 0x2:
        from .patches import PatchDictionary
        w_full = fh.frame_width or (hdr.xsize if hdr else 0)
        h_full = fh.frame_height or (hdr.ysize if hdr else 0)
        n_ec = len(hdr.metadata.extra_channels) if hdr else 0
        patches = PatchDictionary.read(br, w_full, h_full, n_ec)
    splines = None
    if fh.flags & 0x10:
        from .splines import Splines
        w_full = (fh.frame_width or (hdr.xsize if hdr else 0)) or 1
        h_full = (fh.frame_height or (hdr.ysize if hdr else 0)) or 1
        splines = Splines.read(br, w_full * h_full)
    noise_lut = None
    if fh.flags & 0x1:
        from .noise import read_noise_lut
        noise_lut = read_noise_lut(br)
    from ..codec import read_dc_quant
    dcq = read_dc_quant(br)
    gs = br.u32((11, 1), (11, 2049), (12, 4097), (16, 8193))
    qdc = br.u32(16, (5, 1), (8, 1), (16, 1))
    bcm = BlockCtxMap.read(br)
    lf = LfGlobal(dcq=dcq, global_scale=gs, quant_dc=qdc, bcm=bcm,
                  noise_lut=noise_lut, patches=patches, splines=splines)
    if not br.bool():
        lf.cfl_color_factor = br.u32(84, 256, (8, 2), (16, 258))
        lf.cfl_base_x = br.f16()
        lf.cfl_base_b = br.f16()
        lf.cfl_ytox_dc = br.u(8) - 128
        lf.cfl_ytob_dc = br.u(8) - 128
    if br.bool():
        lf.gtree = decode_tree(br, 1 << 22)
        lf.gcode = EntropyCode(br, (len(lf.gtree.nodes) + 1) // 2)
    # the global Modular stream: the extra channels (a VarDCT frame's
    # Modular image carries no colour channels)
    if hdr is not None and hdr.metadata.extra_channels:
        from ..modular.frame import ModularFrameDecoder
        lf.mfd = ModularFrameDecoder.for_frame(
            hdr, fh, lf.gtree, lf.gcode, False, frame_w, frame_h,
            fh.frame_width or hdr.xsize, fh.frame_height or hdr.ysize)
        lf.mfd.read_global(br)
    return lf


@dataclasses.dataclass
class LfGroup:
    extra_precision: int
    dc: ModularImage          # 3 channels (Y, X, B), quantized ints
    nb_blocks: int
    acm: ModularImage         # ytox, ytob, blockinfo, sharpness
    acs_map: np.ndarray = None    # (ys_b, xs_b) strategy id, -1=covered
    qf_map: np.ndarray = None     # (ys_b, xs_b) quant field
    sharp_map: np.ndarray = None  # (ys_b, xs_b)
    ytox: np.ndarray = None       # tile grids (ceil/8)
    ytob: np.ndarray = None


def jpeg_shifts(fh):
    """Per-channel (hshift, vshift) of the STORED block grids for a
    frame with chroma subsampling (fh.jpeg_upsampling), or None when
    all channels are full resolution.  Value semantics: 0=1x1, 1=2x2,
    2=2x1, 3=1x2 upsampling of that channel."""
    ups = tuple(fh.jpeg_upsampling)
    if not any(ups):
        return None
    HV = {0: (0, 0), 1: (1, 1), 2: (1, 0), 3: (0, 1)}
    hv = [HV[u] for u in ups]
    hmax = max(h for h, _ in hv)
    vmax = max(v for _, v in hv)
    return [(hmax - h, vmax - v) for h, v in hv]


def _chan_dims(xs_b, ys_b, shifts, c):
    if shifts is None:
        return xs_b, ys_b
    hs, vs = shifts[c]
    return xs_b >> hs, ys_b >> vs


def _lf_walk_native(acs_row, qf_row, count, xs_b, ys_b, cx_l, cy_l,
                    valid_l, acs_map, qf_map):
    """C++ varblock walk (hostcodec.cpp lf_walk_native): fills
    acs_map/qf_map in place; returns consumed entries or None to fall
    back (the Python loop below stays the error-message path)."""
    from .. import native as native_mod
    lib = native_mod.get_lib()
    import ctypes
    i32p = ctypes.POINTER(ctypes.c_int32)
    acs_a = np.ascontiguousarray(np.asarray(acs_row[:count]), np.int32)
    qf_a = np.ascontiguousarray(np.asarray(qf_row[:count]), np.int32)
    valid_u8 = np.ascontiguousarray(valid_l, np.uint8)
    cx32 = np.ascontiguousarray(cx_l, np.int32)
    cy32 = np.ascontiguousarray(cy_l, np.int32)
    rc = lib.lf_walk_native(
        acs_a.ctypes.data_as(i32p), qf_a.ctypes.data_as(i32p),
        int(count), xs_b, ys_b,
        cx32.ctypes.data_as(i32p), cy32.ctypes.data_as(i32p),
        valid_u8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        len(valid_u8),
        acs_map.ctypes.data_as(i32p), qf_map.ctypes.data_as(i32p))
    if rc == -1:
        raise BitstreamError("invalid AC strategy")
    if rc == -2:
        raise BitstreamError("AC strategy overflows group")
    if rc == -3:
        raise BitstreamError("too few AC metadata entries")
    if rc < 0:
        return None
    return int(rc)


def read_lf_group(br: BitReader, lf: LfGlobal, xs_b: int, ys_b: int,
                  group_index: int, num_dc_groups: int,
                  use_dc_frame: bool = False, shifts=None) -> LfGroup:
    def dc_channels():
        # modular DC channel order is (Y, X, B); subsampled channels
        # are stored on their own grids (jpeg chroma subsampling)
        out = []
        for mc, c in ((0, 1), (1, 0), (2, 2)):
            cw_, ch_ = _chan_dims(xs_b, ys_b, shifts, c)
            hs, vs = (0, 0) if shifts is None else shifts[c]
            out.append(Channel(cw_, ch_, hshift=hs, vshift=vs))
        return out
    if use_dc_frame:
        # flags & kUseDcFrame: DC comes from the preceding LF frame;
        # the DcGroup part (extra_precision + modular DC) is absent
        ep = 0
        dc_img = ModularImage([c.alloc() for c in dc_channels()])
    else:
        ep = br.u(2)
        dc_img = ModularImage(dc_channels())
        decode_modular_stream(br, dc_img, stream_id=1 + group_index,
                              global_tree=lf.gtree, global_code=lf.gcode)
    upper = xs_b * ys_b
    nbits = (upper - 1).bit_length() if upper > 1 else 0
    count = br.u(nbits) + 1
    cw = -(-xs_b // 8)
    ch = -(-ys_b // 8)
    acm = ModularImage([
        Channel(cw, ch, hshift=3, vshift=3),
        Channel(cw, ch, hshift=3, vshift=3),
        Channel(count, 2), Channel(xs_b, ys_b)])
    decode_modular_stream(
        br, acm, stream_id=1 + 2 * num_dc_groups + group_index,
        global_tree=lf.gtree, global_code=lf.gcode)
    lg = LfGroup(extra_precision=ep, dc=dc_img, nb_blocks=count,
                 acm=acm)
    # varblock walk: raster over the LF group, consuming one blockinfo
    # entry per uncovered anchor
    acs_row = acm.channels[2].data[0]
    qf_row = acm.channels[2].data[1]
    acs_map = np.full((ys_b, xs_b), -1, np.int32)
    from .strategies import STRATEGIES as _S_
    qf_map = np.zeros((ys_b, xs_b), np.int32)
    cov_l, l2_l, nc_l, cx_l, cy_l, ob_l, valid_l = _strategy_luts()
    sids = np.asarray(acs_row[:count], np.int64)
    if sids.size and (int(sids.max(initial=0)) >= len(valid_l)
                      or not valid_l[np.minimum(
                          sids, len(valid_l) - 1)].all()):
        raise BitstreamError("invalid AC strategy")
    if count == ys_b * xs_b and sids.size \
            and (cx_l[sids] == 1).all() and (cy_l[sids] == 1).all():
        # all single-block strategies: the walk is a plain raster fill
        acs_map[:] = sids.reshape(ys_b, xs_b)
        qf_map[:] = np.asarray(qf_row[:count]).reshape(ys_b, xs_b) + 1
        vi = count
    else:
        vi = _lf_walk_native(acs_row, qf_row, count, xs_b, ys_b,
                             cx_l, cy_l, valid_l, acs_map, qf_map)
        if vi is None:
            vi = 0
            for by in range(ys_b):
                for bx in range(xs_b):
                    if acs_map[by, bx] != -1:
                        continue
                    if vi >= count:
                        raise BitstreamError(
                            "too few AC metadata entries")
                    strategy = int(acs_row[vi])
                    st = _S_.get(strategy)
                    if st is None:
                        raise BitstreamError(
                            "invalid AC strategy %d" % strategy)
                    if bx + st.cx > xs_b or by + st.cy > ys_b:
                        raise BitstreamError(
                            "AC strategy overflows group")
                    acs_map[by:by + st.cy, bx:bx + st.cx] = -2
                    acs_map[by, bx] = strategy
                    qf_map[by:by + st.cy,
                           bx:bx + st.cx] = int(qf_row[vi]) + 1
                    vi += 1
    if vi != count:
        raise BitstreamError("unused AC metadata entries")
    lg.acs_map = acs_map
    lg.qf_map = qf_map
    lg.sharp_map = acm.channels[3].data
    lg.ytox = acm.channels[0].data
    lg.ytob = acm.channels[1].data
    return lg


@dataclasses.dataclass
class HfGlobal:
    num_histograms: int
    used_orders: int
    orders: Dict[Tuple[int, int], List[int]]
    accodes: List[EntropyCode]


def _perm_ctx(v):
    token = v.bit_length() if v else 0
    return min(token, 7)


def read_permutation(pdec, skip, size):
    end = pdec.read(_perm_ctx(size)) + skip
    if end > size:
        raise BitstreamError("invalid permutation size")
    lehmer = [0] * size
    last = 0
    for i in range(skip, end):
        lehmer[i] = pdec.read(_perm_ctx(last))
        last = lehmer[i]
        if lehmer[i] >= size - i:
            raise BitstreamError("invalid lehmer code")
    temp = list(range(size))
    return [temp.pop(l) for l in lehmer]


# canonical (covered, size) per order bucket: first strategy of the bucket
BUCKET_GEOM = {0: (1, 64), 1: (1, 64), 2: (4, 256), 3: (16, 1024),
               4: (2, 128), 5: (4, 256), 6: (8, 512), 7: (64, 4096),
               8: (32, 2048), 9: (256, 16384), 10: (128, 8192),
               11: (1024, 65536), 12: (512, 32768)}


def read_hf_global(br: BitReader, lf: LfGlobal, num_groups: int,
                   num_passes: int, num_dc_groups: int = 1) -> HfGlobal:
    lf.quant_encodings = None
    lf.quant_cache = {}
    if not br.bool():
        from . import quant_tables as QTab
        def read_modular(idx, xsize, ysize):
            img = ModularImage([Channel(xsize, ysize) for _ in range(3)])
            decode_modular_stream(
                br, img, stream_id=1 + 3 * num_dc_groups + idx,
                global_tree=lf.gtree, global_code=lf.gcode)
            return np.stack([ch.data for ch in img.channels])
        lf.quant_encodings = [
            QTab.read_quant_encoding(br, i, read_modular)
            for i in range(QTab.NUM_QUANT_TABLES)]
    nb = (num_groups - 1).bit_length() if num_groups > 1 else 0
    num_histograms = 1 + br.u(nb)
    orders: Dict[Tuple[int, int, int], List[int]] = {}
    accodes = []
    used_orders = 0
    for p in range(num_passes):
        used_orders = br.u32(0x5F, 0x13, 0, (13, 0))
        if used_orders:
            pcode = EntropyCode(br, 8)
            pdec = EntropyDecoder(br, code=pcode)
            for ord_ in range(NUM_ORDERS):
                if used_orders & (1 << ord_):
                    cov, size = BUCKET_GEOM[ord_]
                    for c in range(3):
                        # scan permutation relative to the natural scan
                        orders[(p, ord_, c)] = read_permutation(pdec, cov,
                                                                size)
            if not pdec.check_final_state():
                raise BitstreamError("permutation checksum failed")
        nctx = num_histograms * lf.bcm.num_ctxs \
            * (NONZERO_BUCKETS + ZERO_DENSITY_CTX_COUNT)
        accodes.append(EntropyCode(br, nctx))
    return HfGlobal(num_histograms=num_histograms,
                    used_orders=used_orders, orders=orders,
                    accodes=accodes)


def dc_context_idx(bcm: BlockCtxMap, dc_vals) -> int:
    """dc_idx from per-channel DC thresholds (c order x, y, b)."""
    idx = 0
    for c in (0, 1, 2):
        th = bcm.dc_thresholds[c]
        if th:
            sub = sum(1 for t in th if dc_vals[c] > t)
            idx = idx * (len(th) + 1) + sub
    return idx


@dataclasses.dataclass
class VarBlock:
    bx: int
    by: int
    strategy: int
    # per channel: scan-indexed coefficient ints, length covered*64
    values: Dict[int, np.ndarray] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class BlockArrays:
    """Flat varblock arrays (per group or frame-global): the native
    entropy decode's output layout kept intact, so the device path
    never builds per-block Python objects (the round-2 device path
    spent ~7s/4K-frame constructing 28.6k VarBlocks and re-looping
    over them in prepare_families).

    Layout: block i (raster order), channel c occupies
    coeffs[offs[i] + c*ncv[i] : offs[i] + (c+1)*ncv[i]] in the same
    order-applied coefficient indexing VarBlock.values uses."""
    ids: np.ndarray      # (N,) int32 strategy ids
    bxs: np.ndarray      # (N,) int32 block x (group or frame coords)
    bys: np.ndarray      # (N,) int32
    ncv: np.ndarray      # (N,) int32 coefficients per channel
    offs: np.ndarray     # (N+1,) int64 cumulative 3*ncv strides
    coeffs: np.ndarray   # flat int32/int64

    def __len__(self):
        return len(self.ids)

    def to_varblocks(self) -> List["VarBlock"]:
        out = []
        offs, nc, co = self.offs, self.ncv, self.coeffs
        for i in range(len(self.ids)):
            vb = VarBlock(bx=int(self.bxs[i]), by=int(self.bys[i]),
                          strategy=int(self.ids[i]))
            off = int(offs[i])
            size = int(nc[i])
            for c in range(3):
                vb.values[c] = co[off + c * size: off + (c + 1) * size]
            out.append(vb)
        return out

    @classmethod
    def from_varblocks(cls, blocks) -> "BlockArrays":
        from .strategies import STRATEGIES
        n = len(blocks)
        ids = np.fromiter((vb.strategy for vb in blocks), np.int32, n)
        bxs = np.fromiter((vb.bx for vb in blocks), np.int32, n)
        bys = np.fromiter((vb.by for vb in blocks), np.int32, n)
        ncv = np.asarray([STRATEGIES[int(s)].num_coeffs for s in ids],
                         np.int32).reshape(n)
        offs = np.zeros(n + 1, np.int64)
        np.cumsum(3 * ncv.astype(np.int64), out=offs[1:])
        dtype = np.int64 if any(
            np.asarray(v).dtype == np.int64
            for vb in blocks[:1] for v in vb.values.values()) else np.int32
        coeffs = np.zeros(max(int(offs[-1]), 1), dtype)
        for i, vb in enumerate(blocks):
            off = int(offs[i])
            size = int(ncv[i])
            for c in range(3):
                v = vb.values.get(c)
                if v is not None:
                    coeffs[off + c * size: off + (c + 1) * size] = v
        return cls(ids, bxs, bys, ncv, offs, coeffs)

    @classmethod
    def concat(cls, parts) -> "BlockArrays":
        """parts: [(ax, ay, BlockArrays)] with group-local coords;
        result uses frame coords."""
        if len(parts) == 1 and parts[0][0] == 0 and parts[0][1] == 0:
            return parts[0][2]
        ids = np.concatenate([p.ids for _, _, p in parts])
        bxs = np.concatenate([p.bxs + ax for ax, _, p in parts])
        bys = np.concatenate([p.bys + ay for _, ay, p in parts])
        ncv = np.concatenate([p.ncv for _, _, p in parts])
        sizes = np.asarray([int(p.offs[-1]) for _, _, p in parts],
                           np.int64)
        base = np.zeros(len(parts) + 1, np.int64)
        np.cumsum(sizes, out=base[1:])
        offs = np.concatenate(
            [p.offs[:-1] + base[i] for i, (_, _, p) in enumerate(parts)]
            + [base[-1:]])
        dtype = (np.int64 if any(p.coeffs.dtype == np.int64
                                 for _, _, p in parts) else np.int32)
        # the coefficient concat moves ~100+ MB at 4K (0.22 s single
        # threaded on the 2-core box): preallocate and copy parts in a
        # thread pool (np copies release the GIL)
        coeffs = np.empty(int(base[-1]), dtype)

        def _copy(i):
            _, _, p = parts[i]
            coeffs[int(base[i]):int(base[i + 1])] = \
                p.coeffs[:int(p.offs[-1])]

        import threading as _threading
        on_main = (_threading.current_thread()
                   is _threading.main_thread())
        if on_main and len(parts) > 4 and int(base[-1]) > (1 << 22):
            # threads only from the main thread: decode_batch already
            # runs whole parses on a worker pool, and nested pools
            # thrash the 2-core box (batched e2e 4.3 -> 2.6 MP/s)
            import concurrent.futures as _fut
            with _fut.ThreadPoolExecutor(
                    max_workers=min(4, os.cpu_count() or 2)) as ex:
                list(ex.map(_copy, range(len(parts))))
        else:
            for i in range(len(parts)):
                _copy(i)
        return cls(ids, bxs, bys, ncv, offs, coeffs)

    def accumulate_pass(self, other: "BlockArrays", shift: int) -> None:
        """coeffs += other.coeffs << shift (anchors are identical
        across passes of one group)."""
        if self.coeffs.shape != other.coeffs.shape:
            raise BitstreamError("pass anchor mismatch")
        if self.coeffs.dtype != np.int64:
            self.coeffs = self.coeffs.astype(np.int64)
        self.coeffs += other.coeffs.astype(np.int64) << shift


def read_pass_group(br: BitReader, lf: LfGlobal, hf: HfGlobal,
                    lg: LfGroup, xs_b: int, ys_b: int,
                    pass_index: int, histo_index: int,
                    dc_q: np.ndarray, shifts=None,
                    as_arrays: bool = False):
    """Decode AC coefficients for one 256px group: a list of varblocks
    with scan-indexed quantized values per channel, or (as_arrays=True)
    the flat BlockArrays layout the device path consumes directly.

    shifts: per-channel (hshift, vshift) for jpeg chroma subsampling —
    subsampled channels are read only at their anchor positions
    (bx % 2^hs == 0 and by % 2^vs == 0), in channel order (1, 0, 2),
    with nonzero prediction on the channel's own grid."""
    from .strategies import STRATEGIES
    dec = EntropyDecoder(br, code=hf.accodes[pass_index])
    if shifts is None and not (dec.lz77.enabled and dec.dist_multiplier):
        from .. import native as native_mod
        arrs = _read_pass_group_native(
            native_mod, dec, br, lf, hf, lg, xs_b, ys_b,
            pass_index, histo_index, dc_q)
        return arrs if as_arrays else arrs.to_varblocks()
    bcm = lf.bcm
    num_ctxs = bcm.num_ctxs
    ctx_base = histo_index * num_ctxs \
        * (NONZERO_BUCKETS + ZERO_DENSITY_CTX_COUNT)
    blocks: List[VarBlock] = []
    nz_map = {c: np.zeros(_chan_dims(xs_b, ys_b, shifts, c)[::-1],
                          np.int32) for c in range(3)}
    for by in range(ys_b):
        for bx in range(xs_b):
            acs = int(lg.acs_map[by, bx])
            if acs < 0:
                continue          # covered by an earlier anchor
            strat = STRATEGIES.get(acs)
            if strat is None:
                raise BitstreamError("invalid AC strategy %d" % acs)
            if shifts is not None and acs != 0:
                raise BitstreamError(
                    "subsampled frames must be DCT8-only")
            qf = int(lg.qf_map[by, bx])
            cov = strat.covered
            log2cov = strat.log2_covered
            size = strat.num_coeffs
            ord_b = strat.order_bucket
            vb = VarBlock(bx=bx, by=by, strategy=acs)
            dc_idx = dc_context_idx(
                bcm, (dc_q[1, by, bx], dc_q[0, by, bx], dc_q[2, by, bx]))
            for c in (1, 0, 2):
                if shifts is not None:
                    hs, vs = shifts[c]
                    if (bx & ((1 << hs) - 1)) or (by & ((1 << vs) - 1)):
                        continue
                order = hf.orders.get((pass_index, ord_b, c))
                if shifts is None:
                    cby, cbx = by, bx
                else:
                    cby, cbx = by >> shifts[c][1], bx >> shifts[c][0]
                nzm = nz_map[c]
                if cby == 0:
                    predicted = 32 if cbx == 0 else int(nzm[cby, cbx - 1])
                elif cbx == 0:
                    predicted = int(nzm[cby - 1, cbx])
                else:
                    predicted = (int(nzm[cby - 1, cbx])
                                 + int(nzm[cby, cbx - 1]) + 1) // 2
                bctx = bcm.context(dc_idx, qf, ord_b, c)
                nz = dec.read(ctx_base + nonzero_ctx(predicted, bctx,
                                                     num_ctxs))
                if nz >= size - cov + 1:
                    raise BitstreamError("too many nonzeros")
                spread = (nz + cov - 1) >> log2cov
                nzm[cby:cby + strat.cy, cbx:cbx + strat.cx] = spread
                vals = np.zeros(size, np.int32)
                ctx_off = ctx_base + num_ctxs * NONZERO_BUCKETS \
                    + ZERO_DENSITY_CTX_COUNT * bctx
                prev = 0 if nz > (size >> 4) else 1
                nzeros = nz
                k = cov
                while nzeros > 0:
                    if k >= size:
                        raise BitstreamError("coeff index overflow")
                    ctx = ctx_off + zero_density_ctx(nzeros, k, cov,
                                                     log2cov, prev)
                    v = unpack_signed(dec.read(ctx))
                    p = order[k] if order is not None else k
                    vals[p] = v
                    prev = 1 if v else 0
                    nzeros -= prev
                    k += 1
                vb.values[c] = vals
            blocks.append(vb)
    if not dec.check_final_state():
        raise BitstreamError("AC group checksum failed")
    return BlockArrays.from_varblocks(blocks) if as_arrays else blocks


_STRAT_LUTS = None


def _strategy_luts():
    """Per-strategy-id lookup arrays (covered, log2_covered, num_coeffs,
    cx, cy, order_bucket, valid) for vectorized anchor building."""
    global _STRAT_LUTS
    if _STRAT_LUTS is None:
        from .strategies import STRATEGIES
        m = max(STRATEGIES) + 1
        f = [np.zeros(m, np.int32) for _ in range(6)]
        valid = np.zeros(m, bool)
        for sid, s in STRATEGIES.items():
            f[0][sid], f[1][sid], f[2][sid] = (s.covered, s.log2_covered,
                                               s.num_coeffs)
            f[3][sid], f[4][sid], f[5][sid] = s.cx, s.cy, s.order_bucket
            valid[sid] = True
        _STRAT_LUTS = (*f, valid)
    return _STRAT_LUTS


def _native_orders(hf, pass_index):
    """Flattened custom coefficient orders + (order_bucket, c) -> offset
    table for one pass, cached on the HfGlobal (shared by all groups)."""
    cache = getattr(hf, "_native_orders_cache", None)
    if cache is None:
        cache = hf._native_orders_cache = {}
    ent = cache.get(pass_index)
    if ent is None:
        orders_flat: List[int] = []
        bucket_off = np.full((NUM_ORDERS, 3), -1, np.int32)
        for (pi, ob, c), perm in hf.orders.items():
            if pi != pass_index:
                continue
            bucket_off[ob, c] = len(orders_flat)
            orders_flat.extend(perm)
        orders_a = np.asarray(orders_flat if orders_flat else [0],
                              np.int32)
        ent = cache[pass_index] = (orders_a, bucket_off)
    return ent


def _read_pass_group_native(native_mod, dec, br, lf, hf, lg, xs_b, ys_b,
                            pass_index, histo_index, dc_q):
    import ctypes
    bcm = lf.bcm
    num_ctxs = bcm.num_ctxs
    ctx_base = histo_index * num_ctxs \
        * (NONZERO_BUCKETS + ZERO_DENSITY_CTX_COUNT)
    cov_l, l2_l, nc_l, cx_l, cy_l, ob_l, valid_l = _strategy_luts()
    acs_map = np.asarray(lg.acs_map)
    sel = acs_map >= 0
    bys, bxs = np.nonzero(sel)          # raster order (matches stream)
    ids = acs_map[sel]
    if ids.size and (int(ids.max()) >= len(valid_l)
                     or not valid_l[ids].all()):
        bad = ids[~valid_l[np.minimum(ids, len(valid_l) - 1)]
                  | (ids >= len(valid_l))]
        raise BitstreamError("invalid AC strategy %d" % int(bad[0]))
    qfv = np.asarray(lg.qf_map)[sel].astype(np.int64)
    # dc ctx index: thresholds over (x, y, b) DC values
    dc_idx = np.zeros(ids.shape, np.int64)
    for c, row in enumerate((1, 0, 2)):
        th = bcm.dc_thresholds[c]
        if th:
            sub = (np.asarray(dc_q[row])[sel][None, :]
                   > np.asarray(th)[:, None]).sum(0)
            dc_idx = dc_idx * (len(th) + 1) + sub
    qft = np.asarray(bcm.qf_thresholds)
    qf_idx = ((qfv[None, :] > qft[:, None]).sum(0)
              if qft.size else np.zeros(ids.shape, np.int64))
    nq = len(bcm.qf_thresholds) + 1
    cmap_arr = np.asarray(bcm.ctx_map)
    obv = ob_l[ids]
    ncv = nc_l[ids]
    n_anchors = len(ids)
    anchors_a = np.empty((max(n_anchors, 1), 11), np.int32)
    offs64 = np.zeros(n_anchors + 1, np.int64)
    np.cumsum(3 * ncv.astype(np.int64), out=offs64[1:])
    total = int(offs64[-1])
    if n_anchors:
        anchors_a[:, 0] = bxs
        anchors_a[:, 1] = bys
        anchors_a[:, 2] = cov_l[ids]
        anchors_a[:, 3] = l2_l[ids]
        anchors_a[:, 4] = ncv
        anchors_a[:, 5] = cx_l[ids]
        anchors_a[:, 6] = cy_l[ids]
        anchors_a[:, 7] = offs64[:-1]
        for c in range(3):
            cidx = (c ^ 1) if c < 2 else 2
            ii = (((cidx * NUM_ORDERS + obv.astype(np.int64)) * nq
                   + qf_idx) * bcm.num_dc_ctxs + dc_idx)
            anchors_a[:, 8 + c] = cmap_arr[ii]
    anchors_a = np.ascontiguousarray(anchors_a)
    orders_a, bucket_off = _native_orders(hf, pass_index)
    offs_a = (np.ascontiguousarray(bucket_off[obv].reshape(-1))
              if n_anchors else np.zeros(1, np.int32))
    out = np.zeros(max(total, 1), np.int32)
    ne = native_mod.NativeEntropy(dec, br)
    i32p = ctypes.POINTER(ctypes.c_int32)
    rc = ne.lib.decode_ac_group_native(
        ne.ctx, anchors_a.ctypes.data_as(i32p), n_anchors,
        offs_a.ctypes.data_as(i32p), orders_a.ctypes.data_as(i32p),
        xs_b, ys_b, num_ctxs, ctx_base,
        out.ctypes.data_as(i32p))
    ne.sync_back(dec, br)
    ne.close()
    if rc != 0:
        raise BitstreamError(f"native AC decode error {rc}")
    if not dec.check_final_state():
        raise BitstreamError("AC group checksum failed")
    return BlockArrays(ids.astype(np.int32, copy=False),
                       bxs.astype(np.int32, copy=False),
                       bys.astype(np.int32, copy=False),
                       ncv.astype(np.int32, copy=False), offs64, out)

# ---------------------------------------------------------------------------
# Reconstruction (numpy reference path; the TPU path mirrors this)

_BIAS = 0.0037930732552754493
_CBRT_BIAS = float(np.cbrt(_BIAS))
_OPSIN = np.array([[0.30, 0.622, 0.078],
                   [0.23, 0.692, 0.078],
                   [0.24342268924547819, 0.20476744424496821,
                    0.5518098665095536]])
_OPSIN_INV = np.linalg.inv(_OPSIN)

_POW25TO18 = np.array([0x0, 0xa, 0x19, 0x26, 0x32, 0x41, 0x4d, 0x5c,
                       0x68, 0x75, 0x83, 0x8f, 0xa0, 0xaa, 0xb9, 0xc6],
                      np.uint32)
_POW17TO10 = np.array([0x0, 0xb7, 0x4, 0xd, 0xcb, 0xe7, 0x41, 0x68,
                       0x51, 0xd1, 0xeb, 0xf2, 0x0, 0xb7, 0x4, 0xd],
                      np.uint32)


def _native_xyb_to_srgb(X, Y, B, bits):
    from .. import native as native_mod
    lib = native_mod.get_lib()
    import ctypes as c
    h, w = np.asarray(X).shape
    Xd = np.ascontiguousarray(X, np.float64)
    Yd = np.ascontiguousarray(Y, np.float64)
    Bd = np.ascontiguousarray(B, np.float64)
    inv = np.ascontiguousarray(_OPSIN_INV, np.float64)
    out = np.empty((h, w, 3), np.uint8 if bits <= 8 else np.uint16)
    dp = c.POINTER(c.c_double)
    lib.xyb_to_srgb(Xd.ctypes.data_as(dp), Yd.ctypes.data_as(dp),
                    Bd.ctypes.data_as(dp), h * w,
                    inv.ctypes.data_as(dp), _BIAS, _CBRT_BIAS, bits,
                    out.ctypes.data_as(c.c_void_p))
    return out


def _xyb_planes_to_linear32(X, Y, B):
    """XYB planes -> (H, W, 3) unclamped linear sRGB in float32 (the
    original's numpy steps)."""
    X = X.astype(np.float32)
    Y = Y.astype(np.float32)
    B = B.astype(np.float32)
    g_r = Y + X + np.float32(_CBRT_BIAS)
    g_g = Y - X + np.float32(_CBRT_BIAS)
    g_b = B + np.float32(_CBRT_BIAS)
    mixed = np.stack([g_r * g_r * g_r - np.float32(_BIAS),
                      g_g * g_g * g_g - np.float32(_BIAS),
                      g_b * g_b * g_b - np.float32(_BIAS)], axis=-1)
    return mixed @ _OPSIN_INV.T.astype(np.float32)


def linear_to_srgb_f32(v):
    """FastLinearToSRGB (float32 bit-exact): cubic approximation of the
    power curve on [0.25, 0.5) recombined with a 16-entry exponent
    table of 2**(5/12) powers."""
    v = np.ascontiguousarray(v, np.float32)
    vb = v.view(np.uint32)
    v025 = ((vb | np.uint32(0x3e800000))
            & np.uint32(0x3effffff)).view(np.float32)
    d1 = v025 * np.float32(0.059914046) + np.float32(-0.108894556)
    d2 = d1 * v025 + np.float32(0.107963754)
    pw = d2 * v025 + np.float32(0.018092343)
    exp = ((vb >> np.uint32(23)) - np.uint32(118)) & np.uint32(0xf)
    mul = ((_POW25TO18[exp] << np.uint32(18))
           | (_POW17TO10[exp] << np.uint32(10))
           | np.uint32(0x40000000)).view(np.float32)
    return np.where(v < np.float32(0.0031308),
                    v * np.float32(12.92),
                    pw * mul + np.float32(-0.055))


def xyb_planes_to_srgb(X, Y, B):
    """XYB -> sRGB-encoded float32 (unclipped, sign-preserving)."""
    return linear_to_srgb_f32(_xyb_planes_to_linear32(X, Y, B))


def _quantize(enc, bits):
    maxv = (1 << bits) - 1
    out = np.clip(np.floor(enc * maxv + 0.5), 0, maxv)
    return out.astype(np.uint8 if bits <= 8 else np.uint16)


def xyb_planes_to_gamma(X, Y, B, gamma, bits):
    """XYB -> linear RGB -> pure power TRC (ColourEncoding.have_gamma
    streams; gamma is the ENCODE exponent, e.g. 1/2.2)."""
    lin = _xyb_planes_to_linear32(X, Y, B)
    enc = np.power(np.maximum(lin, 0.0), np.float32(gamma))
    return _quantize(enc, bits)


def xyb_planes_to_encoding(X, Y, B, ce, bits, intensity_target):
    """XYB -> output in the stream's signalled colour encoding
    (non-sRGB TRC and/or primaries): unclamped linear sRGB -> gamut
    matrix to the signalled primaries -> signalled transfer function.
    The original computes from the gamut step on with jax.numpy in
    float32; this copy with numpy in float32 (``host/ops/color.py``).

    The original's notes (conventions pinned against libjxl 0.7 output):
      - linear 1.0 == 255 nits (kDefaultIntensityTarget), independent
        of the signalled intensity_target;
      - PQ encodes absolute nits / 10000, sign-mirrored for
        out-of-gamut negatives;
      - HLG: display-relative (peak = intensity_target) with the
        BT.2100 inverse OOTF, gamma = 1.2 * 1.111^log2(Lw/1000), OOTF
        luminance taken in the *target* primaries.
    Near black PQ is steep enough that +-1e-3 linear noise moves codes
    by tens; parity tests bound the mean and the 99.9th percentile.
    """
    from ..ops import color as C
    lin = _xyb_planes_to_linear32(X, Y, B)   # linear sRGB, 1 = SDR
    prim = C.primaries_xy(ce)
    wp = C.white_xy(ce)
    if prim != C.PRIMARIES["srgb"] or wp != C.ILLUMINANT_D65:
        m = (C.gamut_xyz_to_rgb(prim, wp)
             @ C.gamut_rgb_to_xyz(C.PRIMARIES["srgb"],
                                  C.ILLUMINANT_D65)).astype(np.float32)
        lin = lin @ m.T
    trc = ce.transfer_function
    it = float(intensity_target) if intensity_target else 255.0
    v = lin.astype(np.float32)
    sign = np.sign(v)
    if trc == 16:    # PQ
        enc = sign * C.linear_to_pq(np.abs(v) * np.float32(255.0 / 10000.0))
    elif trc == 18:  # HLG with inverse OOTF
        disp = v * np.float32(255.0 / it)
        gam = 1.2 * 1.111 ** np.log2(it / 1000.0)
        luma = C.gamut_rgb_to_xyz(prim, wp)[1].astype(np.float32)
        yd = np.einsum("...c,c->...", disp, luma)
        f = np.where(yd > np.float32(1e-9),
                     C.powf(np.abs(yd), (1.0 - gam) / gam), np.float32(0.0))
        scene = disp * f[..., None]
        enc = np.sign(scene) * C.linear_to_hlg(
            np.minimum(np.abs(scene), np.float32(1.0)))
    else:
        enc = sign * C.LINEAR_TO_TRC.get(trc, C.linear_to_srgb)(np.abs(v))
    return _quantize(np.asarray(enc, np.float32), bits)


def _is_srgb_output(ce) -> bool:
    """True when the signalled encoding is the default sRGB output the
    fast paths emit (sRGB TRC or unknown, sRGB primaries, D65)."""
    if ce is None:
        return True
    if ce.have_gamma:
        return False
    return (ce.transfer_function in (13, 2)
            and ce.primaries in (1,) and ce.white_point in (1,))


def xyb_planes_to_srgb8(X, Y, B):
    return _native_xyb_to_srgb(X, Y, B, 8)


def xyb_planes_to_srgb16(X, Y, B):
    return _native_xyb_to_srgb(X, Y, B, 16)


def ycbcr_planes_to_rgb(Cb, Y, Cr, bits):
    """JPEG-recompression frames: (Cb, Y, Cr) planes -> RGB.
    BT.601 full-range constants as libjxl's YcbcrToRgb; the Y plane is
    stored centred (the +128/255 offset lives here)."""
    yp = Y.astype(np.float32) + np.float32(128.0 / 255.0)
    Cb = Cb.astype(np.float32)
    Cr = Cr.astype(np.float32)
    r = yp + np.float32(1.402) * Cr
    g = yp - np.float32(0.344136) * Cb - np.float32(0.714136) * Cr
    b = yp + np.float32(1.772) * Cb
    maxv = (1 << bits) - 1
    out = np.stack([r, g, b], axis=-1)
    out = np.clip(np.floor(out * maxv + 0.5), 0, maxv)
    return out.astype(np.uint8 if bits <= 8 else np.uint16)


def compute_dc_planes(lf: LfGlobal, lg: LfGroup):
    """Dequantized, DC-CfL'ed DC planes for one LF group."""
    igs = lf.inv_global_scale
    cf = 1.0 / lf.cfl_color_factor
    dc_mul = [d * igs / lf.quant_dc / (1 << lg.extra_precision)
              for d in lf.dcq]          # (x, y, b)
    dcY = lg.dc.channels[0].data.astype(np.float64) * dc_mul[1]
    dcX = lg.dc.channels[1].data.astype(np.float64) * dc_mul[0] \
        + (lf.cfl_base_x + lf.cfl_ytox_dc * cf) * dcY
    dcB = lg.dc.channels[2].data.astype(np.float64) * dc_mul[2] \
        + (lf.cfl_base_b + lf.cfl_ytob_dc * cf) * dcY
    return {0: dcX, 1: dcY, 2: dcB}


DC_SMOOTH_W1 = 0.20345139757231578
DC_SMOOTH_W2 = 0.0334829185968739


def adaptive_dc_smoothing(dc_planes, dc_steps):
    """3x3 weighted smoothing of the DC image, gated per sample by the
    largest per-channel deviation in quant-step units:
    factor = clamp(3 - 4*gap, 0, 1), gap >= 0.5.  Image-border
    samples are left untouched.  (Pinned by flag-toggle probes.)"""
    w1, w2 = DC_SMOOTH_W1, DC_SMOOTH_W2
    w0 = 1.0 - 4.0 * (w1 + w2)
    sms = {}
    gap = None
    for c in range(3):
        p = dc_planes[c]
        pad = np.pad(p, 1, mode="edge")
        sm = (w0 * p
              + w1 * (pad[:-2, 1:-1] + pad[2:, 1:-1]
                      + pad[1:-1, :-2] + pad[1:-1, 2:])
              + w2 * (pad[:-2, :-2] + pad[:-2, 2:]
                      + pad[2:, :-2] + pad[2:, 2:]))
        sms[c] = sm
        g = np.abs(sm - p) / dc_steps[c]
        gap = g if gap is None else np.maximum(gap, g)
    gap = np.maximum(0.5, gap)
    # factor ramp pinned by flags=0 crafted DC probes: f = 3 - 4*gap,
    # i.e. full smoothing at gap 0.5, none from 0.75 up
    mix = np.clip(3.0 - 4.0 * gap, 0.0, 1.0)
    out = {}
    for c in range(3):
        p = dc_planes[c]
        f = p + (sms[c] - p) * mix
        f[0, :] = p[0, :]
        f[-1, :] = p[-1, :]
        f[:, 0] = p[:, 0]
        f[:, -1] = p[:, -1]
        out[c] = f
    return out


def reconstruct_group(lf: LfGlobal, lg: LfGroup,
                      blocks: List["VarBlock"], fh, dc_view=None
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Scan-indexed varblocks -> X, Y, B float planes for the group."""
    from .strategies import STRATEGIES
    from . import synthesis as S
    ys_b, xs_b = lg.qf_map.shape
    igs = lf.inv_global_scale
    # qm multipliers apply to the XYB X/B channels only; YCbCr frames
    # (JPEG recompression) dequantize without them (pinned vs libjxl)
    if fh.do_ycbcr:
        qm = [1.0, 1.0, 1.0]
    else:
        qm = [0.8 ** (fh.x_qm_scale - 2), 1.0,
              0.8 ** (fh.b_qm_scale - 2)]
    cf = 1.0 / lf.cfl_color_factor
    dc_planes = dc_view if dc_view is not None else \
        compute_dc_planes(lf, lg)

    def dq_table(strategy, c):
        if getattr(lf, "quant_encodings", None) is not None:
            from . import quant_tables as QTab
            t = QTab.dequant_table_for(lf.quant_encodings, strategy, c,
                                       lf.quant_cache)
            if t is not None:
                return t
        return S.dequant_table(strategy, c)

    H, W = ys_b * 8, xs_b * 8
    planes = {c: np.zeros((H, W), np.float32) for c in range(3)}

    # Batched reconstruction per strategy family: all varblocks of one
    # strategy are dequantized + synthesized with a single einsum chain
    # instead of a Python per-block loop (the DCT8 case — the
    # overwhelming majority — used to be the only batched path).
    by_strategy: Dict[int, list] = {}
    for vb in blocks:
        by_strategy.setdefault(vb.strategy, []).append(vb)

    for sid, group in by_strategy.items():
        strat = STRATEGIES[sid]
        n = len(group)
        bxs = np.asarray([vb.bx for vb in group])
        bys = np.asarray([vb.by for vb in group])
        inv_qac_v = igs / lg.qf_map[bys, bxs].astype(np.float64)
        ty, tx = bys // 8, bxs // 8
        xfv = lf.cfl_base_x + lg.ytox[ty, tx].astype(np.float64) * cf
        bfv = lf.cfl_base_b + lg.ytob[ty, tx].astype(np.float64) * cf
        bh, bw = strat.height, strat.width
        cov = strat.covered
        # AdjustQuantBias: decoder-side shrink of quantized AC values
        # (|q|==1 -> 1-bias[c], else q - 0.145/q)
        vals = {c: S.adjust_quant_bias(
                    np.stack([vb.values[c] for vb in group]), c)
                for c in range(3)}
        pix = {}
        if cov == 1 and sid != 0:
            # non-separable 8x8 transforms: measured response matrices
            acY = None
            for c in (1, 0, 2):
                resp = S.response_matrix(sid, c)
                if getattr(lf, "quant_encodings", None) is not None:
                    from . import quant_tables as QTab
                    try:
                        ct = QTab.dequant_table_for(
                            lf.quant_encodings, sid, c, lf.quant_cache)
                        dt = S.dequant_table(sid, c)
                        order_ = S.scan_to_basis(sid)
                    except (KeyError, BitstreamError):
                        # special transforms without calibrated default
                        # step tables: keep the default response (the
                        # custom-table delta is not representable here)
                        ct = None
                    if ct is not None:
                        ratio = np.ones(len(resp))
                        ratio[1:] = (ct[order_[1:]]
                                     / np.maximum(dt[order_[1:]], 1e-12))
                        resp = resp * ratio[:, None, None]
                if c == 1:
                    acY = np.tensordot(
                        vals[1][:, 1:], S.response_matrix(sid, 1)[1:],
                        axes=1) * inv_qac_v[:, None, None]
                p = np.tensordot(vals[c][:, 1:], resp[1:], axes=1) \
                    * (inv_qac_v * qm[c])[:, None, None]
                p += dc_planes[c][bys, bxs][:, None, None] * resp[0]
                if c != 1:
                    # AC CfL on the coded part only (DC excluded)
                    p += (xfv if c == 0 else bfv)[:, None, None] * acY
                pix[c] = p
        else:
            order = S.scan_to_basis(sid)
            idx = order[cov:]
            cy, cx = strat.cy, strat.cx
            # gather the covered DC blocks: (n, cy, cx)
            dcb_idx_y = bys[:, None, None] + np.arange(cy)[None, :, None]
            dcb_idx_x = bxs[:, None, None] + np.arange(cx)[None, None, :]
            rs = np.outer(S.resample_vec(cy), S.resample_vec(cx))
            Ah, Aw = S.cos_basis(bh), S.cos_basis(bw)
            anY, anX = S.ana_basis(cy), S.ana_basis(cx)
            acY_mat = None
            for c in (1, 0, 2):
                tab = dq_table(sid, c)
                cmat = np.zeros((n, bh * bw))
                cmat[:, idx] = vals[c][:, cov:] * tab[idx] \
                    * (inv_qac_v * qm[c])[:, None]
                cmat = cmat.reshape(n, bh, bw)
                if c == 1:
                    acY_mat = cmat.copy()
                else:
                    cmat += (xfv if c == 0 else bfv)[:, None, None] \
                        * acY_mat
                # LLF from the (cfl'ed) DC image; BLAS matmuls (numpy
                # einsum without optimize= runs a slow scalar kernel)
                dcb = dc_planes[c][dcb_idx_y, dcb_idx_x].astype(np.float64)
                llf = (anY @ dcb @ anX.T) * rs
                cmat[:, :cy, :cx] = llf
                pix[c] = Ah.T @ cmat @ Aw
        for i, vb in enumerate(group):
            for c in range(3):
                planes[c][vb.by * 8:vb.by * 8 + bh,
                          vb.bx * 8:vb.bx * 8 + bw] = pix[c][i]
    return planes[0], planes[1], planes[2]


def gaborish(plane: np.ndarray, w1: float, w2: float) -> np.ndarray:
    """3x3 smoothing [[w2,w1,w2],[w1,1,w1],[w2,w1,w2]] / norm with
    mirrored borders (kernel verified by impulse probe vs libjxl)."""
    norm = 1.0 + 4.0 * (w1 + w2)
    p = np.pad(plane, 1, mode="symmetric")
    out = (p[1:-1, 1:-1]
           + w1 * (p[:-2, 1:-1] + p[2:, 1:-1]
                   + p[1:-1, :-2] + p[1:-1, 2:])
           + w2 * (p[:-2, :-2] + p[:-2, 2:]
                   + p[2:, :-2] + p[2:, 2:]))
    return out / norm


KINV_SIGMA = -1.1715728752538099024
# Per-channel SAD scales, pinned with single-channel striped probes
# under custom flat dequant tables (research/epf_kernel_probe.py):
# the X/Y/B planes contribute 23.51 / 2.938 / 2.057 per unit diff.
# (An earlier fit said Y=5.0 — that was really Y+B: the probe streams
# carried B==Y through the default CfL base.)
EPF_CHANNEL_SCALE = (23.51, 2.938, 2.057)
# measured: sigma = EPF_SIGMA_PER * sharpness * (inv_global_scale / qf)
EPF_SIGMA_PER = 0.05921
# weight slope: w = relu(1 + sad * KINV * EPF1_INV_SCALE / sigma).
# Striped probes at sigma 3.3 match this relu to 4 digits; the pass-0
# and pass-2 slopes are this times pass0/pass2_sigma_scale.
EPF1_INV_SCALE = 2.530
# Block activity gate: EPF is skipped where sigma < this (all passes
# share one gate; bracketed to (0.2695, 0.2707] by stripe probes —
# exactly 0.3 * 0.9, i.e. our sigma unit is 0.9x libjxl's).
EPF_SIGMA_GATE = 0.2701


def _native_filter_chain(X, Y, B, rf, sigma):
    from .. import native as native_mod
    lib = native_mod.get_lib()
    if rf.gab and rf.gab_custom and rf.gab_weights is not None:
        wx1, wx2, wy1, wy2, wb1, wb2 = rf.gab_weights
    else:
        wx1 = wy1 = wb1 = 0.115169525
        wx2 = wy2 = wb2 = 0.061248592
    import ctypes as c
    H, W = Y.shape
    Xd = np.ascontiguousarray(X, np.float64)
    Yd = np.ascontiguousarray(Y, np.float64)
    Bd = np.ascontiguousarray(B, np.float64)
    dp = c.POINTER(c.c_double)
    if sigma is not None and rf.epf_iters >= 1:
        sg = np.ascontiguousarray(sigma, np.float64)
        sh, sw = sg.shape
        sgp = sg.ctypes.data_as(dp)
        epf = int(rf.epf_iters)
    else:
        sg = None
        sh = sw = 0
        sgp = None
        epf = 0
    lib.filter_chain(Xd.ctypes.data_as(dp), Yd.ctypes.data_as(dp),
                     Bd.ctypes.data_as(dp), H, W,
                     1 if rf.gab else 0, wx1, wx2, wy1, wy2, wb1, wb2,
                     epf, sgp, sh, sw,
                     float(rf.epf_pass0_sigma_scale),
                     float(rf.epf_pass2_sigma_scale))
    return Xd, Yd, Bd


def _apply_filters(X, Y, B, rf, sigma):
    """The gaborish + EPF chain in native C++ (hostcodec.cpp
    filter_chain)."""
    if not rf.gab and rf.epf_iters == 0:
        return X, Y, B
    return _native_filter_chain(X, Y, B, rf, sigma)


def dc_from_frame(dc_frame, xs_b: int, ys_b: int) -> dict:
    """The DC planes {0: X, 1: Y, 2: B} of a frame with kUseDcFrame from
    its LF frame's planes: the block grid may be one sample wider or
    taller than the LF frame (ceil rounding), so the edge is replicated."""
    dc_glob = {c: np.zeros((ys_b, xs_b)) for c in range(3)}
    for c in range(3):
        src = dc_frame[c]
        dc_glob[c][:src.shape[0], :src.shape[1]] = src[:ys_b, :xs_b]
        if src.shape[1] < xs_b:
            dc_glob[c][:, src.shape[1]:] = \
                dc_glob[c][:, src.shape[1] - 1:src.shape[1]]
        if src.shape[0] < ys_b:
            dc_glob[c][src.shape[0]:, :] = \
                dc_glob[c][src.shape[0] - 1:src.shape[0], :]
    return dc_glob


def check_ycbcr(fh) -> None:
    """A YCbCr frame with chroma subsampling decodes only through the
    JPEG route (a jbrd box: jpeg/wire.py, per-channel block grids); here
    it raises NotImplementedError."""
    if fh.do_ycbcr and jpeg_shifts(fh) is not None:
        raise NotImplementedError(
            "VarDCT frame with YCbCr chroma subsampling and no jbrd box: the "
            "port decodes subsampled YCbCr only as a recompressed JPEG "
            "(ROADMAP queue 1: a subsampled YCbCr frame without jbrd)")


def decode_vardct_frame(cs: bytes, hdr, fh, toc, dc_frame=None,
                        ref_frames=None,
                        return_xyb: bool = False,
                        max_passes: int = None) -> np.ndarray:
    """Real-format VarDCT still decode on the host, in float64 ->
    (H, W, 3 + extra channels) uint8, or uint16 above 8 bits per sample,
    in the signalled output encoding (sRGB by default).

    dc_frame: {0: X, 1: Y, 2: B} planes of the LF frame decoded before
    it, the frame's DC when fh.flags & kUseDcFrame (no DC smoothing then).
    ref_frames: {slot: [X, Y, B]} planes of the reference frames decoded
    before it, the sources of its patches.  return_xyb: the XYB planes
    {0: X, 1: Y, 2: B} at the coded size after the filters, patches,
    splines and noise, with no upsampling and no colour transform (an LF
    frame's output is the next frame's DC; a reference frame's, a patch
    source).

    Handles multi-pass (progressive AC) streams: per-group coefficient
    values accumulate as sum(v_pass << pass_shift).  max_passes: decode
    only the first max_passes AC passes (the progressive preview and the
    truncated-stream render); the coefficients keep their shifted scale.
    A single-section TOC ignores it.

    Section layout (multi-entry TOC): LfGlobal | LfGroup[0..ndc) |
    HfGlobal | PassGroup[pass][0..ng); single-entry TOC concatenates
    them in the same order without byte re-alignment.
    """
    w, h = fh.coded_size(hdr)
    xs_b, ys_b = -(-w // 8), -(-h // 8)
    ng, ndc = fh.counts(hdr)
    npasses = fh.passes.num_passes
    # per-pass coefficient shifts: shift[i] for all but the last pass
    pass_shift = list(fh.passes.shift) + [0]
    single = len(toc.entries) == 1
    if (max_passes is not None and 0 < max_passes < npasses
            and not single):
        npasses = max_passes
    use_dc_frame = bool(fh.flags & 0x20)
    if use_dc_frame and dc_frame is None:
        raise BitstreamError(
            "frame uses a DC frame but none was decoded before it")
    check_ycbcr(fh)
    if fh.upsampling not in (1, 2, 4, 8):
        raise BitstreamError(f"upsampling {fh.upsampling}")

    def section(idx):
        if single:
            return None
        s = toc.section(idx)
        return BitReader(cs[s.offset:s.offset + s.size])

    if single:
        s = toc.section(0)
        br = BitReader(cs[s.offset:s.offset + s.size])
        brs = lambda idx: br  # noqa: E731
    else:
        brs = section

    lf = read_lf_global(brs(0), fh, hdr, w, h)

    # LF groups: 2048x2048 px tiles (256x256 blocks)
    lf_gd_b = 256
    gx_lf = -(-xs_b // lf_gd_b)
    lgs = []
    for gi in range(ndc):
        lx = (gi % gx_lf) * lf_gd_b
        ly = (gi // gx_lf) * lf_gd_b
        gw = min(lf_gd_b, xs_b - lx)
        gh = min(lf_gd_b, ys_b - ly)
        lgs.append((lx, ly, read_lf_group(brs(1 + gi), lf, gw, gh,
                                          gi, ndc,
                                          use_dc_frame=use_dc_frame)))

    hf = read_hf_global(brs(1 + ndc), lf, ng, npasses, ndc)
    histo_bits = (hf.num_histograms - 1).bit_length() \
        if hf.num_histograms > 1 else 0

    # AC groups: 256x256 px (32x32 blocks)
    gd_b = 32
    gx = -(-xs_b // gd_b)
    # every pixel of the padded block grid is written by some group's
    # reconstruction, so skip the (expensive) zero fill
    X = np.empty((ys_b * 8, xs_b * 8))
    Y = np.empty_like(X)
    B = np.empty_like(X)
    qf_map = np.zeros((ys_b, xs_b), np.int64)
    sharp_map = np.zeros((ys_b, xs_b), np.int64)
    dc_glob = {c: np.zeros((ys_b, xs_b)) for c in range(3)}
    for lx, ly, lg in lgs:
        gh_, gw_ = lg.qf_map.shape
        qf_map[ly:ly + gh_, lx:lx + gw_] = lg.qf_map
        sharp_map[ly:ly + gh_, lx:lx + gw_] = lg.sharp_map
        if not use_dc_frame:
            dcp = compute_dc_planes(lf, lg)
            for c in range(3):
                dc_glob[c][ly:ly + gh_, lx:lx + gw_] = dcp[c]
    if use_dc_frame:
        dc_glob = dc_from_frame(dc_frame, xs_b, ys_b)
    elif not (fh.flags & 0x80):
        # smoothing gap steps use the NOMINAL dc step — extra_precision
        # does not shrink the gate (pinned by ep=0/1/2 crafted probes)
        igs0 = lf.inv_global_scale
        steps = [lf.dcq[c] * igs0 / lf.quant_dc
                 for c in range(3)]  # (x, y, b)
        dc_glob = adaptive_dc_smoothing(dc_glob,
                                        {0: steps[0], 1: steps[1],
                                         2: steps[2]})

    def _decode_group(gi):
        ax = (gi % gx) * gd_b
        ay = (gi // gx) * gd_b
        gw = min(gd_b, xs_b - ax)
        gh = min(gd_b, ys_b - ay)
        lgi = (ay // lf_gd_b) * gx_lf + (ax // lf_gd_b)
        lx, ly, lg = lgs[lgi]
        sub = _lf_group_view(lg, ax - lx, ay - ly, gw, gh)
        dc_q = np.stack([sub.dc.channels[1].data,
                         sub.dc.channels[0].data,
                         sub.dc.channels[2].data])
        blocks = None
        for p in range(npasses):
            br_g = brs(2 + ndc + p * ng + gi)
            histo_index = br_g.u(histo_bits) if histo_bits else 0
            blocks_p = read_pass_group(br_g, lf, hf, sub, gw, gh, p,
                                       histo_index, dc_q, as_arrays=True)
            if blocks is None:
                blocks = blocks_p
                if pass_shift[0]:
                    # coefficients stay far from 2^31
                    if blocks.coeffs.dtype != np.int64:
                        blocks.coeffs = blocks.coeffs.astype(np.int64)
                    blocks.coeffs <<= pass_shift[0]
            else:
                # anchors/offsets are identical across passes
                blocks.accumulate_pass(blocks_p, pass_shift[p])
            if lf.mfd is not None:
                # the extra channels' group stream follows the AC tokens
                lf.mfd.read_group(br_g, gi, ndc, ng, pass_index=p)
        dc_view = {c: dc_glob[c][ay:ay + gh, ax:ax + gw]
                   for c in range(3)}
        gX, gY, gB = reconstruct_group(lf, sub, blocks.to_varblocks(),
                                       fh, dc_view)
        X[ay * 8:(ay + gh) * 8, ax * 8:(ax + gw) * 8] = gX
        Y[ay * 8:(ay + gh) * 8, ax * 8:(ax + gw) * 8] = gY
        B[ay * 8:(ay + gh) * 8, ax * 8:(ax + gw) * 8] = gB

    if single or ng == 1:
        for gi in range(ng):
            _decode_group(gi)
    else:
        # groups are fully independent; the native entropy loops and
        # large numpy ops release the GIL, so a thread pool gives real
        # multi-core host decode
        import concurrent.futures as _fut
        workers = min(ng, os.cpu_count() or 4)
        with _fut.ThreadPoolExecutor(max_workers=workers) as ex:
            list(ex.map(_decode_group, range(ng)))

    rf = fh.restoration_filter
    lf_sigma = None
    if rf.epf_iters >= 1:
        lf_sigma = EPF_SIGMA_PER * sharp_map \
            * (lf.inv_global_scale / np.maximum(qf_map, 1))
    if (rf.gab or rf.epf_iters >= 1) and (X.shape[0] > h
                                          or X.shape[1] > w):
        # libjxl's render pipeline filters at the TRUE image size
        # with Mirror() borders; filtering the block-padded plane
        # (even with mirrored padding content) diverges when the
        # footprint crosses the padded edge (EPF0 reads 3 past the
        # border but the padding can be 1-2 samples wide).  Crop,
        # filter, and write back.
        Xc, Yc, Bc = (np.ascontiguousarray(p[:h, :w])
                      for p in (X, Y, B))
        Xc, Yc, Bc = _apply_filters(Xc, Yc, Bc, rf, lf_sigma)
        X[:h, :w], Y[:h, :w], B[:h, :w] = Xc, Yc, Bc
    else:
        X, Y, B = _apply_filters(X, Y, B, rf, lf_sigma)
    if lf.patches is not None:
        if ref_frames is None:
            raise BitstreamError(
                "frame uses patches but no reference frames were decoded")
        planes = [np.ascontiguousarray(p[:h, :w], np.float64)
                  for p in (X, Y, B)]
        lf.patches.apply(planes, ref_frames)
        for dstp, srcp in zip((X, Y, B), planes):
            dstp[:h, :w] = srcp
    if lf.splines is not None:
        cf = 1.0 / lf.cfl_color_factor
        planes = [np.ascontiguousarray(p[:h, :w], np.float64)
                  for p in (X, Y, B)]
        lf.splines.render(planes,
                          base_cx=lf.cfl_base_x + lf.cfl_ytox_dc * cf,
                          base_cb=lf.cfl_base_b + lf.cfl_ytob_dc * cf)
        for dstp, srcp in zip((X, Y, B), planes):
            dstp[:h, :w] = srcp
    if lf.noise_lut is not None:
        from .noise import add_noise
        Xc, Yc, Bc = (np.ascontiguousarray(p[:h, :w], np.float32)
                      for p in (X, Y, B))
        add_noise(Xc, Yc, Bc, lf.noise_lut)
        X = np.zeros_like(X); Y = np.zeros_like(Y); B = np.zeros_like(B)
        X[:h, :w], Y[:h, :w], B[:h, :w] = Xc, Yc, Bc
    if return_xyb:
        return {0: X[:h, :w], 1: Y[:h, :w], 2: B[:h, :w]}
    m = hdr.metadata
    # final frame size after upsampling (the coded frame is 1/upsampling
    # of the signalled size; the Upsampler stage scales XYB back up)
    full_w = fh.frame_width or hdr.xsize
    full_h = fh.frame_height or hdr.ysize
    if fh.upsampling > 1:
        from ..ops.upsample import upsample_plane
        weights = upsample_weights(m, fh.upsampling)
        X = upsample_plane(X[:h, :w], fh.upsampling, weights)
        Y = upsample_plane(Y[:h, :w], fh.upsampling, weights)
        B = upsample_plane(B[:h, :w], fh.upsampling, weights)
    bits = m.bit_depth.bits_per_sample
    ce = m.colour_encoding
    if fh.do_ycbcr:
        rgb = ycbcr_planes_to_rgb(X, Y, B, bits)[:full_h, :full_w]
    elif ce is not None and ce.have_gamma:
        # a pure power TRC (e.g. 1/2.2): encode the linear output with it
        rgb = xyb_planes_to_gamma(X, Y, B, ce.gamma / 1e7,
                                  bits)[:full_h, :full_w]
    elif not _is_srgb_output(ce):
        rgb = xyb_planes_to_encoding(
            X, Y, B, ce, bits,
            m.tone_mapping.intensity_target)[:full_h, :full_w]
    elif bits > 8:
        rgb = xyb_planes_to_srgb16(X, Y, B)[:full_h, :full_w]
    else:
        rgb = xyb_planes_to_srgb8(X, Y, B)[:full_h, :full_w]
    if not m.extra_channels:
        return rgb
    from ..modular.frame import undo_on_host
    from ..ops.upsample import upsample_plane
    ecs = undo_on_host(lf.mfd.planes())
    out_max = 65535 if rgb.dtype == np.uint16 else 255
    planes = []
    for i, ec in enumerate(m.extra_channels):
        ebits = ec.bit_depth.bits_per_sample
        ec_up = fh.ec_upsampling[i] if i < len(fh.ec_upsampling) else 1
        ec_up <<= ec.dim_shift
        p = ecs[i]
        if ec_up > 1:
            p = np.rint(upsample_plane(
                p.astype(np.float32), ec_up)).astype(np.int64)
        p = np.clip(p, 0, (1 << ebits) - 1)
        # rescale EC to the output depth
        if (1 << ebits) - 1 != out_max:
            p = p.astype(np.int64) * out_max // ((1 << ebits) - 1)
        planes.append(p[:full_h, :full_w].astype(rgb.dtype))
    return np.concatenate([rgb] + [p[..., None] for p in planes], axis=2)


def upsample_weights(metadata, n: int):
    """The signalled weights of an n-times upsampler (None: the
    defaults)."""
    uw = metadata.transform_data
    return {2: uw.up2_weights, 4: uw.up4_weights,
            8: uw.up8_weights}.get(n)


def _lf_group_view(lg: LfGroup, ox: int, oy: int, gw: int,
                   gh: int) -> LfGroup:
    """Slice one AC group's window out of its parent LF group (block
    maps, DC channels, and 64-px cfl tile grids; ox/oy are multiples
    of 8 blocks so tile grids slice cleanly)."""
    full_w = lg.dc.channels[0].width
    full_h = lg.dc.channels[0].height
    if ox == 0 and oy == 0 and gw == full_w and gh == full_h:
        return lg
    dc = ModularImage([
        Channel(gw >> c.hshift, gh >> c.vshift,
                hshift=c.hshift, vshift=c.vshift,
                data=c.data[oy >> c.vshift:(oy + gh) >> c.vshift,
                            ox >> c.hshift:(ox + gw) >> c.hshift])
        for c in lg.dc.channels])
    tx0, ty0 = ox // 8, oy // 8
    tx1 = -(-(ox + gw) // 8)
    ty1 = -(-(oy + gh) // 8)
    return LfGroup(
        extra_precision=lg.extra_precision, dc=dc,
        nb_blocks=0, acm=lg.acm,
        acs_map=lg.acs_map[oy:oy + gh, ox:ox + gw],
        qf_map=lg.qf_map[oy:oy + gh, ox:ox + gw],
        sharp_map=lg.sharp_map[oy:oy + gh, ox:ox + gw],
        ytox=lg.ytox[ty0:ty1, tx0:tx1],
        ytob=lg.ytob[ty0:ty1, tx0:tx1])
