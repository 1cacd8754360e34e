"""Seeded inputs for checking the PyTorch port (jxl_coder_tpu_torch):
images to encode, synthetic strategy families, and Modular streams
written with the port's own host copies.  Used by tests/test_torch_*.py
and chip_smoke.py; imports no JAX.
"""

from __future__ import annotations

import struct

import numpy as np

from jxl_coder_tpu_torch import animation as ANIM
from jxl_coder_tpu_torch import api
from jxl_coder_tpu_torch import reference as R
from jxl_coder_tpu_torch.host.bitstream.frame_header import (
    BlendingInfo, Encoding, FrameHeader, FrameType, write_frame_header,
    write_toc)
from jxl_coder_tpu_torch.host.bitstream.headers import (
    AnimationHeader, BitDepth, ColourEncoding, ColourSpace, ExtraChannelInfo,
    ExtraChannelType, ImageHeader, ImageMetadata, SizeHeader)
from jxl_coder_tpu_torch.host.bitstream.reader import BitReader
from jxl_coder_tpu_torch.host.bitstream.writer import BitWriter
from jxl_coder_tpu_torch.host.codec import (DEFAULT_DC_QUANT,
                                            frame_channel_layout,
                                            write_image_header)
from jxl_coder_tpu_torch.host.modular import transform as T
from jxl_coder_tpu_torch.host.modular.image import Channel, ModularImage
from jxl_coder_tpu_torch.host.modular.stream import (GroupHeader,
                                                     encode_modular_stream)
from jxl_coder_tpu_torch.host.modular.tree import Tree
from jxl_coder_tpu_torch.host.ops.icc import SRGB_D50
from jxl_coder_tpu_torch.host.vardct.enc_real import srgb8_to_xyb
from jxl_coder_tpu_torch.host.vardct.quant import quality_to_distance
from jxl_coder_tpu_torch.host.vardct.dec_real import (read_lf_global,
                                                      read_lf_group)
# an all-DCT8 stream -> the DCT8 path's arrays (moved into the package)
from jxl_coder_tpu_torch.vardct.dct8 import arguments as dct8_arguments  # noqa: F401


def bench_frame(h: int, w: int) -> np.ndarray:
    """bench._test_frame (bench.py:54-62) at any size, seed 42."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    rng = np.random.default_rng(42)
    img = np.stack([
        128 + 90 * np.sin(yy / 97) + 40 * np.cos(xx / 53),
        120 + 80 * np.sin((xx + yy) / 71) + 30 * np.sin(xx / 29),
        110 + 70 * np.cos(yy / 41) + 50 * np.sin(xx / 113)], -1)
    img += rng.normal(0, 6, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def smooth_frame(h: int, w: int, seed: int = 3,
                 dtype=np.uint8) -> np.ndarray:
    """Smooth colour waves plus noise, uint8 or uint16 (x257)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([128 + 100 * np.sin(xx / 37) * np.cos(yy / 23),
                    128 + 80 * np.cos(xx / 11 + yy / 53),
                    128 + 60 * np.sin((xx + yy) / 29)], -1)
    img = np.clip(img + rng.normal(0, 5, img.shape), 0, 255)
    if dtype == np.uint16:
        return (img * 257).astype(np.uint16)
    return img.astype(np.uint8)


def waves_frame(h: int, w: int) -> np.ndarray:
    """Noise-free colour waves with a band of one-pixel bars: many
    strategy families from few AC tokens (the device entropy decode's
    plain twin reads one token per group a step)."""
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([128 + 60 * np.sin(xx / 41) * np.cos(yy / 37),
                    120 + 50 * np.cos(xx / 29 + yy / 61),
                    110 + 40 * np.sin((xx + yy) / 47)], -1)
    img[h // 3:h // 3 + 8, ::16] = 20
    img[h // 3:h // 3 + 8, 1::16] = 20
    return np.clip(img, 0, 255).astype(np.uint8)


def sharp_frame(h: int, w: int, seed: int = 42) -> np.ndarray:
    """Dark strokes on a flat page over a ringing pattern: at d < 2 and
    effort 7 the encoder picks the special 1-block transforms
    (IDENTITY, DCT2X2, DCT4X4, DCT4X8) for the strokes."""
    rng = np.random.default_rng(seed)
    img = np.full((h, w, 3), 235, np.uint8)
    for _ in range(h * w // 400):
        y, x = rng.integers(0, h - 12), rng.integers(0, w - 12)
        hh, ww = rng.integers(1, 12), rng.integers(1, 3)
        if rng.random() < 0.5:
            hh, ww = ww, hh
        img[y:y + hh, x:x + ww] = rng.integers(0, 90, 3)
    yy, xx = np.mgrid[h // 2:h, 0:w]
    img[h // 2:] = np.clip(128 + 90 * np.sin(yy / 13.0) * np.cos(xx / 7.0),
                           0, 255).astype(np.uint8)[..., None]
    return img


# scale of the random coefficients per storage type, and the inv_qac
# that keeps the synthesized pixels O(1) (real streams: |q| < ~700)
_SYNTH_RANGE = {np.int8: (100, 0.1), np.int16: (2000, 0.005),
                np.int32: (60000, 1.5e-4)}


def synthetic_family(sid: int, dtype, rng: np.random.Generator,
                     fixes: bool = False, vmax: int = None):
    """A seeded family in the tpu_full.prepare_families layout: 6
    varblocks of strategy `sid` tiling a 2 x 3 varblock frame exactly,
    padded to 8 rows.  Returns (desc, fam, ys_b, xs_b).  With fixes
    (int8 only), an exception list carries values past int8; vmax
    overrides the coefficient range of the storage type."""
    st = R.STRATEGIES[sid]
    bh, bw, cov = st.height, st.width, st.covered
    special = cov == 1 and sid != 0
    n, n_pad, cols = 6, 8, 3
    ys_b, xs_b = (n // cols) * st.cy, cols * st.cx
    K = 64 if special else bh * bw
    vmax_t, iq = _SYNTH_RANGE[dtype]
    vmax = vmax_t if vmax is None else vmax
    vals = rng.integers(-vmax, vmax + 1, (n_pad, 3, K))
    vals[rng.random(vals.shape) < 0.6] = 0
    vals[:, :, :2] = rng.integers(-2, 3, (n_pad, 3, 2))   # |q| <= 1 path
    bys = np.full(n_pad, R.PAD_SENTINEL, np.int32)
    bxs = np.full(n_pad, R.PAD_SENTINEL, np.int32)
    bys[:n] = (np.arange(n) // cols) * st.cy
    bxs[:n] = (np.arange(n) % cols) * st.cx
    fam = dict(bys=bys, bxs=bxs,
               inv_qac=(iq * rng.uniform(0.5, 1.5, n_pad)).astype(np.float32),
               xf=rng.uniform(-0.1, 0.1, n_pad).astype(np.float32),
               bf=rng.uniform(0.8, 1.2, n_pad).astype(np.float32))
    if fixes:
        flat = vals.reshape(-1)
        idx = rng.choice(flat.size, 8, replace=False).astype(np.int32)
        big = rng.integers(200, 600, 8) * rng.choice([-1, 1], 8)
        flat[idx] = np.clip(big, -127, 127)
        fam["fix_idx"] = idx
        fam["fix_val"] = (big - flat[idx]).astype(np.int32)
    key = "vals" if special else "cmat"
    fam[key] = vals.astype(dtype)
    if special:
        fam["resp"] = np.stack([R.response_matrix(sid, c) for c in range(3)]
                               ).astype(np.float32)
        fam["resp_y_def"] = R.response_matrix(sid, 1).astype(np.float32)
    else:
        fam["tab"] = np.stack([R.dequant_table(sid, c)[:K] for c in range(3)]
                              ).astype(np.float32)
    return (sid, n_pad, bh, bw, cov, special), fam, ys_b, xs_b


# ---- Modular streams ----

def posterized_frame(h: int, w: int, levels: int = 6) -> np.ndarray:
    """bench_frame with each channel cut to `levels` values: at most
    levels^3 colours, so the palette body applies."""
    step = 255 // (levels - 1)
    return (bench_frame(h, w) // step * step).astype(np.uint8)


# the extra channels past alpha of the many-channel fixtures, in turn
EXTRA_TYPES = (ExtraChannelType.DEPTH, ExtraChannelType.THERMAL,
               ExtraChannelType.SELECTION_MASK, ExtraChannelType.OPTIONAL)


def extra_types(n: int) -> tuple:
    """n extra channels: alpha, then EXTRA_TYPES in turn."""
    return ((ExtraChannelType.ALPHA,)
            + tuple(EXTRA_TYPES[i % len(EXTRA_TYPES)]
                    for i in range(n - 1)))[:n]


def modular_headers(h: int, w: int, nch: int, bits: int = 8,
                    xyb: bool = False, group_shift: int = 3,
                    icc: bytes = None):
    """(ImageHeader, FrameHeader) of a Modular still as
    jxl_coder_tpu.api.encode writes them (lossless: api.py:306-327);
    channels past the colour (1 or 3) are extra channels (extra_types: a
    fourth is alpha), xyb an XYB-encoded frame, icc an embedded ICC
    profile."""
    m = ImageMetadata()
    m.xyb_encoded = xyb
    m.bit_depth = BitDepth(False, bits, 0)
    ce = ColourEncoding()
    if nch == 1:
        ce.colour_space = ColourSpace.GREY
    if icc is not None:
        ce.want_icc = True
        m.icc_profile = icc
    m.colour_encoding = ce
    for t in extra_types(max(0, nch - 3)):
        ec = ExtraChannelInfo(type=t)
        ec.bit_depth = BitDepth(False, bits, 0)
        m.extra_channels.append(ec)
    hdr = ImageHeader(size=SizeHeader(xsize=w, ysize=h), metadata=m)
    fh = FrameHeader()
    fh.encoding = Encoding.MODULAR
    fh.group_size_shift = group_shift
    fh.x_qm_scale = 2
    fh.ec_upsampling = [1] * len(m.extra_channels)
    fh.ec_blending_info = [BlendingInfo() for _ in m.extra_channels]
    fh.restoration_filter.epf_iters = 0
    fh.restoration_filter.gab = False
    return hdr, fh


def _still(hdr, body) -> bytes:
    """Image header, then body(bw) writes the frame."""
    bw = BitWriter()
    write_image_header(bw, hdr)
    body(bw)
    bw.zero_pad_to_byte()
    return bw.to_bytes()


def _planes(img: np.ndarray):
    img = img if img.ndim == 3 else img[:, :, None]
    return [img[:, :, i].astype(np.int32) for i in range(img.shape[2])]


def modular_still(img: np.ndarray, palette: bool = False,
                  group_shift: int = 3, icc: bytes = None) -> bytes:
    """What api.encode(..., effort=1/2) writes, with RCT 6 forced on three
    colour channels and a single-leaf predictor-5 tree
    (reference.encode_modular_frame); palette: the colours of np.unique
    of the pixels as the palette body (api._try_palette_body); icc: an
    embedded ICC profile (api.encode(..., icc=...))."""
    planes = _planes(img)
    bits = 16 if img.dtype == np.uint16 else 8
    hdr, fh = modular_headers(img.shape[0], img.shape[1], len(planes), bits,
                              group_shift=group_shift, icc=icc)
    pal = None
    if palette:
        packed = np.stack(planes[:3], -1).reshape(-1, 3)
        colours, inv = np.unique(packed, axis=0, return_inverse=True)
        pal = (np.ascontiguousarray(colours.T, np.int32),
               inv.reshape(img.shape[:2]).astype(np.int32))
    return _still(hdr, lambda bw: R.encode_modular_frame(
        bw, hdr, fh, planes, use_ycocg=True, palette=pal))


def upsampled_modular_still(img: np.ndarray, n: int) -> bytes:
    """A Modular frame coded at 1/n of img's size (every n-th pixel) and
    signalled at its full size with n-times upsampling, the extra channel
    (alpha) too (ec_upsampling n); RCT 6 as modular_still."""
    h, w = img.shape[:2]
    coded = img[::n, ::n]
    planes = _planes(coded)
    bits = 16 if img.dtype == np.uint16 else 8
    hdr, fh = modular_headers(h, w, len(planes), bits)
    fh.upsampling = n
    fh.ec_upsampling = [n] * len(fh.ec_upsampling)
    return _still(hdr, lambda bw: R.encode_modular_frame(
        bw, hdr, fh, planes, use_ycocg=True))


def _one_section(bw, hdr, fh, image, header) -> None:
    """A single-section frame: LfGlobal (default DC dequant, no global
    tree) and the global stream with `header`'s transforms."""
    sw = BitWriter()
    sw.bool(True)
    sw.bool(False)
    encode_modular_stream(sw, image, header, Tree.single_leaf(predictor=5),
                          stream_id=0)
    sec = sw.to_bytes()
    write_frame_header(bw, fh, hdr)
    write_toc(bw, [len(sec)])
    for byte in sec:
        bw.u(byte, 8)


def _squeezed(bw, hdr, fh, planes, rct: bool) -> None:
    """One section whose GroupHeader carries RCT 6 (when `rct`) and the
    default squeeze, built the way tests/test_modular.py builds one at
    the transform level."""
    image = frame_channel_layout(hdr, fh)
    for chan, plane in zip(image.channels, planes):
        chan.data = plane
    transforms = []
    if rct:
        transforms.append(T.Transform(id=0, begin_c=0, rct_type=6))
        T.rct_forward(image, transforms[-1])
    transforms.append(T.Transform(
        id=2, squeezes=T.default_squeeze_params(image)))
    T.squeeze_forward(image, transforms[-1])
    _one_section(bw, hdr, fh, image, GroupHeader(transforms=transforms))


def squeezed_still(img: np.ndarray) -> bytes:
    """A one-section RGB stream with RCT 6 and the default squeeze (at
    most 1024 x 1024: one group at group_size_shift 3)."""
    hdr, fh = modular_headers(img.shape[0], img.shape[1], 3)
    if fh.counts(hdr)[0] != 1:
        raise ValueError("a one-section stream holds one group")
    return _still(hdr, lambda bw: _squeezed(bw, hdr, fh, _planes(img), True))


def xyb_still(img: np.ndarray) -> bytes:
    """An XYB Modular stream, one section, squeezed (as cjxl -m -d
    writes lossy Modular): the channels (Y, X, B - Y) in units of the
    default DC dequant factors, whose product codec.py:234-239 undoes."""
    X, Y, B = srgb8_to_xyb(img)
    qx, qy, qb = DEFAULT_DC_QUANT
    cy = np.rint(Y / qy).astype(np.int32)
    planes = [cy, np.rint(X / qx).astype(np.int32),
              np.rint(B / qb).astype(np.int32) - cy]
    hdr, fh = modular_headers(img.shape[0], img.shape[1], 3, xyb=True)
    return _still(hdr, lambda bw: _squeezed(bw, hdr, fh, planes, False))


def group_rct_still(img: np.ndarray, group_shift: int = 0) -> bytes:
    """A multi-group RGB stream whose global stream has no transform and
    whose group streams each carry a local RCT in their GroupHeader:
    group g uses rct_type (6 + 5 g) mod 42, so the frame covers several
    of the 7 x 6 types."""
    planes = _planes(img)
    hdr, fh = modular_headers(img.shape[0], img.shape[1], 3,
                              group_shift=group_shift)
    ng, ndc = fh.counts(hdr)
    gd = fh.group_dim()
    if ng == 1:
        raise ValueError("a multi-group stream needs more than one group")
    tree = Tree.single_leaf(predictor=5)
    sections = []
    sw = BitWriter()
    sw.bool(True)
    sw.bool(False)
    encode_modular_stream(sw, ModularImage([]), GroupHeader(), tree,
                          stream_id=0)
    sections.append(sw.to_bytes())
    sections += [b""] * (ndc + 1)       # LF groups and HF global: empty
    gx = -(-img.shape[1] // gd)
    for gi in range(ng):
        y0, x0 = (gi // gx) * gd, (gi % gx) * gd
        sub = ModularImage([T.Channel(min(gd, p.shape[1] - x0),
                                      min(gd, p.shape[0] - y0),
                                      data=p[y0:y0 + gd, x0:x0 + gd].copy())
                            for p in planes])
        t = T.Transform(id=0, begin_c=0, rct_type=(6 + 5 * gi) % 42)
        T.rct_forward(sub, t)
        gw = BitWriter()
        encode_modular_stream(gw, sub, GroupHeader(transforms=[t]), tree,
                              stream_id=1 + 3 * ndc + 17 + gi)
        sections.append(gw.to_bytes())

    def body(bw):
        write_frame_header(bw, fh, hdr)
        write_toc(bw, [len(s) for s in sections])
        for s in sections:
            for byte in s:
                bw.u(byte, 8)

    return _still(hdr, body)


# ---- Patches, splines, reference-only and LF frames ----

def text_frame(h: int, w: int) -> np.ndarray:
    """Text on light panels over a smooth background, the pattern of
    tests/test_enc_patches.py's _text_image(flat=False) repeated on a
    256 x 192 cell across the frame (at 192x256 it is that image): two
    11x9 glyphs alternating on a 16 x 14 pitch, which the host encoder's
    effort-7 patch detector turns into a reference-only atlas frame and a
    patch dictionary."""
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.clip(np.stack([
        140 + 40 * np.sin(yy / 90), 150 + 30 * np.cos(xx / 120),
        130 + 20 * np.sin((xx + yy) / 150)], -1), 0, 255).astype(np.uint8)
    glyph = np.zeros((11, 9), bool)
    glyph[1:10, 2:4] = True
    glyph[1:3, 2:8] = True
    glyph[5:7, 2:7] = True
    g2 = np.zeros((11, 9), bool)
    g2[1:10, 4:6] = True
    g2[8:10, 2:8] = True
    for cy in range(0, h, 192):
        for cx in range(0, w, 256):
            img[cy + 20:min(cy + 120, h), cx + 16:min(cx + 240, w)] = 245
            for k, gy in enumerate(range(cy + 24, cy + 110, 16)):
                for gx in range(20, 230, 14):
                    if gy + 11 > h or cx + gx + 9 > w:
                        continue
                    reg = img[gy:gy + 11, cx + gx:cx + gx + 9]
                    reg[glyph if (gx // 14 + k) % 2 else g2] = 25
    return img


def _copy_bits(bw: BitWriter, data: bytes, start: int, end: int) -> None:
    """Bits [start, end) of data appended to bw, bit for bit."""
    br = BitReader(data)
    br.pos = start
    while br.pos < end:
        n = min(32, end - br.pos)
        bw.u(br.u(n), n)


def _sections(cs: bytes, toc) -> list:
    return [cs[s.offset:s.offset + s.size]
            for s in (toc.section(i) for i in range(len(toc.entries)))]


def _frame_bytes(bw: BitWriter, hdr, fh, sections) -> None:
    """A frame (header, TOC, the sections' bytes) written into bw."""
    write_frame_header(bw, fh, hdr)
    write_toc(bw, [len(s) for s in sections])
    for s in sections:
        bw.append_bits(s, len(s) * 8)


def _one_frame(data: bytes):
    cs, hdr, frames = api._read_frames(data)
    if len(frames) != 1:
        raise ValueError("a one-frame stream is expected")
    return (cs, hdr) + frames[0]


def seeded_splines(h: int, w: int, n: int, seed: int = 5):
    """n splines of 3-5 control points across an (h, w) frame, with
    seeded colour and sigma DCT coefficients (a few low frequencies)."""
    from jxl_coder_tpu_torch.host.vardct.splines import (QuantizedSpline,
                                                         Splines)
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        k = int(rng.integers(3, 6))
        start = rng.uniform((0, 0), (w, h))
        steps = rng.normal(0, min(h, w) / 12, (k - 1, 2))
        pts = np.rint(np.clip(np.cumsum(np.vstack([start, steps]), 0),
                              0, (w - 1, h - 1)))
        color = np.zeros((3, 32), np.int64)
        color[:, :4] = rng.integers(-40, 41, (3, 4))
        sigma = np.zeros(32, np.int64)
        sigma[0] = rng.integers(4, 12)
        sigma[1:3] = rng.integers(-2, 3, 2)
        out.append(QuantizedSpline(points=pts.astype(np.float64),
                                   color_dct=color, sigma_dct=sigma))
    return Splines(quantization_adjustment=int(rng.integers(-2, 3)),
                   splines=out)


def with_splines(data: bytes, splines) -> bytes:
    """A one-frame VarDCT stream with splines added: flag kSplines set,
    Splines.write's bits at the head of LfGlobal and the old section after
    them bit for bit (a frame of one section: the whole of it), the frame
    header and the TOC written again."""
    cs, hdr, fh, toc = _one_frame(data)
    if fh.flags & 0x12:
        raise ValueError("the frame already has patches or splines")
    secs = _sections(cs, toc)
    head = BitWriter()
    splines.write(head)
    _copy_bits(head, secs[0], 0, 8 * len(secs[0]))
    head.zero_pad_to_byte()
    fh.flags |= 0x10
    bw = BitWriter()
    write_image_header(bw, hdr)
    _frame_bytes(bw, hdr, fh, [head.to_bytes()] + secs[1:])
    return bw.to_bytes()


def with_lf_frame(data: bytes) -> bytes:
    """A one-frame VarDCT stream rewritten with its DC in an LF frame: a
    Modular LF frame (lf_level 1) of the frame's DC planes quantized under
    DEFAULT_DC_QUANT, with (Y, X, B-Y) channels as _encode_with_patches
    writes its atlas, then the VarDCT frame with kUseDcFrame, each LF
    group cut, bit for bit, to its AC-metadata stream (its extra
    precision and DC stream dropped)."""
    from jxl_coder_tpu_torch.host.bitstream.frame_header import (
        FrameType, RestorationFilter)
    from jxl_coder_tpu_torch.host.modular.stream import decode_modular_stream
    from jxl_coder_tpu_torch.host.vardct.dec_real import compute_dc_planes
    cs, hdr, fh, toc = _one_frame(data)
    if fh.flags & 0x20 or hdr.metadata.extra_channels:
        raise ValueError("a frame without a DC frame or extra channels is "
                         "expected")
    w, h = fh.coded_size(hdr)
    xs_b, ys_b = -(-w // 8), -(-h // 8)
    _ng, ndc = fh.counts(hdr)
    single = len(toc.entries) == 1
    secs = _sections(cs, toc)
    br0 = BitReader(secs[0])
    lf = read_lf_global(br0, fh, hdr, w, h)
    dc = np.zeros((3, ys_b, xs_b))
    cuts = []          # per LF group: (section, DC start bit, DC end bit)
    gx = -(-xs_b // 256)
    for gi in range(ndc):
        lx, ly = (gi % gx) * 256, (gi // gx) * 256
        gw, gh = min(256, xs_b - lx), min(256, ys_b - ly)
        br = br0 if single else BitReader(secs[1 + gi])
        start = br.pos
        probe = BitReader(br.data)
        probe.pos = start
        lg = read_lf_group(br, lf, gw, gh, gi, ndc)
        probe.u(2)
        decode_modular_stream(probe, ModularImage(
            [Channel(gw, gh) for _ in range(3)]), stream_id=1 + gi,
            global_tree=lf.gtree, global_code=lf.gcode)
        cuts.append((0 if single else 1 + gi, start, probe.pos))
        dcp = compute_dc_planes(lf, lg)
        for c in range(3):
            dc[c, ly:ly + gh, lx:lx + gw] = dcp[c]
    q0, q1, q2 = DEFAULT_DC_QUANT
    cy = np.rint(dc[1] / q1).astype(np.int32)
    cx = np.rint(dc[0] / q0).astype(np.int32)
    cb = (np.rint(dc[2] / q2) - cy).astype(np.int32)
    fh_lf = FrameHeader(frame_type=FrameType.LF_FRAME,
                        encoding=Encoding.MODULAR, lf_level=1, is_last=False,
                        restoration_filter=RestorationFilter(gab=False,
                                                             epf_iters=0))
    bw = BitWriter()
    write_image_header(bw, hdr)
    R.encode_modular_frame(bw, hdr, fh_lf, [cy, cx, cb], use_ycocg=False)
    new = list(secs)
    for idx, a, b in cuts:
        # a section of its own: from the DC's end on; one section for the
        # frame: LF global and what follows the DC stay around the cut
        cut = BitWriter()
        _copy_bits(cut, secs[idx], 0, a if single else 0)
        _copy_bits(cut, secs[idx], b, 8 * len(secs[idx]))
        cut.zero_pad_to_byte()
        new[idx] = cut.to_bytes()
    fh.flags |= 0x20
    _frame_bytes(bw, hdr, fh, new)
    return bw.to_bytes()


def patch_dictionary(patches, num_extra: int = 0) -> BitWriter:
    """The wire form of a patch dictionary (PatchDictionary.read's
    mirror): patches [(slot, (x0, y0, w, h), [(x, y), ...], mode, clamp)],
    each placement blended by `mode` in every channel set."""
    from jxl_coder_tpu_torch.host.bitstream.reader import pack_signed
    from jxl_coder_tpu_torch.host.entropy.coder import TokenStream
    from jxl_coder_tpu_torch.host.vardct import patches as P
    ts = TokenStream(P.NUM_PATCH_CONTEXTS, use_ans=True)
    ts.add(P.CTX_NUM_REF_PATCH, len(patches))
    for slot, (x0, y0, pw, ph), places, mode, clamp in patches:
        ts.add(P.CTX_REFERENCE_FRAME, slot)
        ts.add(P.CTX_PATCH_REFERENCE_POSITION, x0)
        ts.add(P.CTX_PATCH_REFERENCE_POSITION, y0)
        ts.add(P.CTX_PATCH_SIZE, pw - 1)
        ts.add(P.CTX_PATCH_SIZE, ph - 1)
        ts.add(P.CTX_PATCH_COUNT, len(places) - 1)
        for i, (x, y) in enumerate(places):
            if i == 0:
                ts.add(P.CTX_PATCH_POSITION, x)
                ts.add(P.CTX_PATCH_POSITION, y)
            else:
                ts.add(P.CTX_PATCH_OFFSET, pack_signed(x - places[i - 1][0]))
                ts.add(P.CTX_PATCH_OFFSET, pack_signed(y - places[i - 1][1]))
            for _j in range(num_extra + 1):
                ts.add(P.CTX_PATCH_BLEND_MODE, mode)
                if P._uses_alpha(mode) and num_extra > 1:
                    ts.add(P.CTX_PATCH_ALPHA_CHANNEL, 0)
                if P._uses_clamp(mode):
                    ts.add(P.CTX_PATCH_CLAMP, int(clamp))
    bw = BitWriter()
    ts.write(bw)
    return bw


def _image_header(h: int, w: int, alpha: bool = False) -> ImageHeader:
    m = ImageMetadata()
    m.bit_depth = BitDepth(False, 8, 0)
    if alpha:
        ec = ExtraChannelInfo(type=ExtraChannelType.ALPHA)
        ec.bit_depth = BitDepth(False, 8, 0)
        m.extra_channels = [ec]
    return ImageHeader(size=SizeHeader(xsize=w, ysize=h), metadata=m)


def vardct_reference_still(img: np.ndarray) -> bytes:
    """Two VarDCT frames by the host encoder: a reference-only frame
    (slot 2, saved before the colour transform) of img's top-left quarter,
    then img with patches from it in every blend the decode path tells
    apart: REPLACE, ADD, MUL with and without clamp, and BLEND_ABOVE and
    ALPHA_ADD_BELOW (REPLACE and ADD without extra-channel planes), some
    overlapping, one placement on the frame's last pixels."""
    from jxl_coder_tpu_torch.host.bitstream.frame_header import FrameType
    from jxl_coder_tpu_torch.host.vardct import patches as P
    h, w = img.shape[:2]
    rh, rw = h // 2, w // 2
    hdr = _image_header(h, w)
    bw = BitWriter()
    write_image_header(bw, hdr)
    R.encode_vardct(np.ascontiguousarray(img[:rh, :rw]), distance=1.0,
                    effort=5, fh=FrameHeader(
                        frame_type=FrameType.REFERENCE_ONLY, is_last=False,
                        save_as_reference=2, save_before_color_transform=True,
                        have_crop=True, frame_width=rw, frame_height=rh),
                    hdr=hdr, into_bw=bw)
    pd = patch_dictionary([
        (2, (0, 0, 20, 12), [(3, 5), (w - 20, h - 12)], P.BLEND_REPLACE,
         False),
        (2, (5, 4, 16, 16), [(10, 9), (40, 20)], P.BLEND_ADD, False),
        (2, (1, 2, 24, 9), [(12, 14)], P.BLEND_MUL, True),
        (2, (rw - 9, rh - 7, 9, 7), [(30, 30), (31, 31)], P.BLEND_MUL,
         False),
        (2, (2, 3, 11, 13), [(50, 2)], P.BLEND_BLEND_ABOVE, True),
        (2, (7, 1, 13, 6), [(20, 40)], P.BLEND_ALPHA_ADD_BELOW, False)])
    R.encode_vardct(img, distance=1.0, effort=5, fh=FrameHeader(is_last=True),
                    hdr=hdr, into_bw=bw, patch_dict_bw=pd)
    bw.zero_pad_to_byte()
    return bw.to_bytes()


def patched_alpha_still(img: np.ndarray, alpha: np.ndarray) -> bytes:
    """_encode_with_patches' two frames for an image with alpha, which
    its effort-7 gate declines: enc_patches.detect's Modular atlas frame
    (with an opaque alpha channel), then img and its lossless alpha with
    the dictionary, each placement's extra channel blended too (which the
    decode path ignores, as the reference's)."""
    from jxl_coder_tpu_torch.host.bitstream.frame_header import (
        FrameType, RestorationFilter)
    from jxl_coder_tpu_torch.host.vardct import enc_patches as EPAT
    h, w = img.shape[:2]
    plan = EPAT.detect(img)
    if plan is None:
        raise ValueError("the image has no repeated glyphs")
    hdr = _image_header(h, w, alpha=True)
    bw = BitWriter()
    write_image_header(bw, hdr)
    ah, aw = plan.atlas.shape[1:]
    fh_ref = FrameHeader(frame_type=FrameType.REFERENCE_ONLY,
                         encoding=Encoding.MODULAR, is_last=False,
                         save_as_reference=1,
                         save_before_color_transform=True, have_crop=True,
                         frame_width=aw, frame_height=ah,
                         restoration_filter=RestorationFilter(gab=False,
                                                              epf_iters=0))
    fh_ref.ec_blending_info = [BlendingInfo()]
    fh_ref.ec_upsampling = [1]
    Xa, Ya, Ba = plan.atlas
    q0, q1, q2 = DEFAULT_DC_QUANT
    cy = np.rint(Ya / q1).astype(np.int32)
    cx = np.rint(Xa / q0).astype(np.int32)
    cb = (np.rint(Ba / q2) - cy).astype(np.int32)
    R.encode_modular_frame(bw, hdr, fh_ref,
                           [cy, cx, cb, np.full((ah, aw), 255, np.int32)],
                           use_ycocg=False)
    R.encode_vardct(plan.filled, distance=1.0, effort=7,
                    fh=FrameHeader(is_last=True), hdr=hdr, into_bw=bw,
                    alpha=alpha, patch_dict_bw=EPAT.serialize_dictionary(
                        plan, num_extra=1))
    bw.zero_pad_to_byte()
    return bw.to_bytes()


# ---- animations (the package's animation.AnimatedEncoder) ------------------

def animation_header(h: int, w: int, nch: int, bits: int = 8,
                     lossless: bool = True, num_loops: int = 0,
                     extra=(ExtraChannelType.ALPHA,)) -> ImageHeader:
    """AnimatedEncoder.encode's image header for frames of (h, w, nch) at
    `bits` (animation.image_header), with the channels past three as extra
    channels of the types in `extra` (alpha for 4 channels) at the colour's
    depth."""
    hdr = ANIM.image_header(w, h, min(nch, 3), bits, lossless, num_loops)
    hdr.metadata.extra_channels = []
    for t in extra[:max(0, nch - 3)]:
        ec = ExtraChannelInfo(type=t)
        ec.bit_depth = BitDepth(False, bits, 0)
        hdr.metadata.extra_channels.append(ec)
    return hdr


def animation_frame(hdr: ImageHeader, pixels: np.ndarray, duration: int,
                    is_last: bool, lossless: bool = True,
                    quality: int = 90) -> bytes:
    """One frame as AnimatedEncoder.encode writes it, alone: a frame starts
    and ends on a byte, so the stream is the image header's bytes and its
    frames' bytes one after another (animated_stream).  A lossy frame is
    animation.encode_frame_into's on the float64 host front (front None),
    the JAX package's host route: epf_iters 1, 16-bit colour from its top
    8 bits, a fourth channel as a lossless alpha."""
    pixels = pixels if pixels.ndim == 3 else pixels[:, :, None]
    bw = BitWriter()
    fh = ANIM.frame_header(hdr, duration, is_last)
    if lossless:
        ANIM.encode_frame_into(bw, hdr, fh, pixels, True)
    else:
        fh.encoding = Encoding.VARDCT
        fh.restoration_filter.epf_iters = 1
        rgb = pixels[:, :, :3]
        if rgb.dtype == np.uint16:
            rgb = (rgb >> 8).astype(np.uint8)
        alpha = pixels[:, :, 3].astype(np.int64) \
            if pixels.shape[2] == 4 else None
        R.encode_vardct(rgb, distance=quality_to_distance(quality), fh=fh,
                        hdr=hdr, into_bw=bw, alpha=alpha)
    bw.zero_pad_to_byte()
    return bw.to_bytes()


def header_bytes(hdr: ImageHeader) -> bytes:
    bw = BitWriter()
    write_image_header(bw, hdr)
    bw.zero_pad_to_byte()
    return bw.to_bytes()


def animated_stream(frames, lossless: bool = True, quality: int = 90,
                    effort: int = 7, num_loops: int = 0,
                    durations=None) -> bytes:
    """What jxl_coder_tpu.animation.AnimatedEncoder(w, h, num_loops,
    lossless, quality, effort).encode() writes after add_frame(frame,
    duration) for each frame (durations in ms, 100 each by default):
    Modular frames at group_size_shift 3 when lossless, real-format VarDCT
    frames (epf_iters 1, the distance of `quality`; 16-bit colour coded
    from its top 8 bits) when lossy, a fourth channel as an alpha extra
    channel coded losslessly.  effort is unused, as there."""
    frames = [f if f.ndim == 3 else f[:, :, None] for f in frames]
    h, w, nch = frames[0].shape
    bits = 16 if frames[0].dtype == np.uint16 else 8
    hdr = animation_header(h, w, nch, bits, lossless, num_loops)
    durations = [100] * len(frames) if durations is None else durations
    return header_bytes(hdr) + b"".join(
        animation_frame(hdr, f, d, k == len(frames) - 1, lossless, quality)
        for k, (f, d) in enumerate(zip(frames, durations)))


# sprite_animation's frames after the background and the reference frame:
# (colour (mode, clamp), the alpha's (mode, alpha channel, clamp), the depth
# channel's, where the sprite lands, its blending source slot, the slot it
# is saved to, its duration in ms).  Modes: 0 REPLACE, 1 ADD, 2 BLEND,
# 3 ALPHA_WEIGHTED_ADD, 4 MUL; places: "left" (x0 < 0), "top right" (past
# the right edge, y0 < 0), "bottom" (past the bottom edge), "middle",
# "outside" (nothing lands), "full" (no crop: the whole canvas blended).
SPRITE_FRAMES = (
    ((2, False), (2, 0, False), (2, 0, False), "left", 1, 1, 100),
    ((2, True), (0, 0, False), (3, 0, False), "top right", 1, 1, 0),
    ((1, False), (1, 0, False), (4, 0, True), "middle", 2, 3, 100),
    ((4, False), (4, 0, False), (1, 0, False), "bottom", 1, 1, 100),
    ((4, True), (2, 0, True), (0, 0, False), "middle", 3, 1, 100),
    ((3, False), (3, 0, False), (2, 0, True), "top right", 1, 2, 100),
    ((3, True), (4, 0, True), (3, 0, True), "outside", 1, 1, 100),
    ((2, False), (2, 0, False), (4, 0, False), "bottom", 2, 1, 100),
    ((2, False), (2, 0, True), (2, 0, False), "full", 1, 0, 100),
)


def _sprite_place(place: str, h: int, w: int, sh: int, sw: int):
    return {"left": (-sw // 3, h // 4), "top right": (w - sw // 2, -sh // 3),
            "bottom": (w // 3, h - sh // 2), "middle": (w // 2 - sw // 3,
                                                         h // 3),
            "outside": (-sw - 3, h // 2)}[place]


def sprite_animation(h: int, w: int, sh: int, sw: int, seed: int = 0,
                     n_extra: int = 2) -> bytes:
    """A lossless 8-bit animation of RGB, alpha and a depth channel (with
    n_extra > 2, more extra channels of EXTRA_TYPES, the k-th past depth
    in depth's mode + k - 1, its clamp flipped every other one): a
    full-canvas background saved to slot 1, a reference-only frame (slot
    2, stored as pixels), then SPRITE_FRAMES: eight cropped sh x sw
    sprites, every blend mode of the colour with and without clamp, the
    extra channels' modes of jxl_coder_tpu's
    test_compose_frame_ec_blend_modes (a non-alpha channel blended,
    weighted-added and multiplied through the alpha), offsets before, past
    and outside the canvas, sources from three slots, a frame of zero
    duration; last, a whole-canvas frame blended over slot 1.  Seeded
    values, alpha with runs of 0 and 255."""
    rng = np.random.default_rng(seed)
    nch = 3 + n_extra
    hdr = animation_header(h, w, nch, extra=extra_types(n_extra))

    def image(ih: int, iw: int) -> np.ndarray:
        px = rng.integers(0, 256, (ih, iw, nch)).astype(np.uint8)
        y, x = np.mgrid[0:ih, 0:iw]
        px[..., 0] = ((x * 7 + y * 3) % 256).astype(np.uint8)
        a = px[..., 3]
        a[(x // 5 + y // 3) % 4 == 0] = 0
        a[(x // 4 + y // 5) % 5 == 1] = 255
        return px

    bw = BitWriter()
    write_image_header(bw, hdr)
    fh = ANIM.frame_header(hdr)
    fh.duration, fh.is_last, fh.save_as_reference = 100, False, 1
    ANIM.encode_frame_into(bw, hdr, fh, image(h, w), True)
    fh = ANIM.frame_header(hdr)
    fh.frame_type = FrameType.REFERENCE_ONLY
    fh.is_last, fh.save_as_reference = False, 2
    ANIM.encode_frame_into(bw, hdr, fh, image(h, w), True)
    for k, (colour, alpha, depth, place, src, slot, dur) in enumerate(
            SPRITE_FRAMES):
        fh = ANIM.frame_header(hdr)
        if place != "full":
            fh.have_crop = True
            fh.x0, fh.y0 = _sprite_place(place, h, w, sh, sw)
            fh.frame_width, fh.frame_height = sw, sh
        fh.blending_info = BlendingInfo(mode=colour[0], alpha_channel=0,
                                        clamp=colour[1], source=src)
        more = [((depth[0] + k) % 5, 0, depth[2] ^ (k % 2 == 1))
                for k in range(1, n_extra - 1)]
        fh.ec_blending_info = [BlendingInfo(mode=m, alpha_channel=a,
                                            clamp=c, source=src)
                               for m, a, c in [alpha, depth] + more]
        fh.duration = dur
        fh.is_last = k == len(SPRITE_FRAMES) - 1
        fh.save_as_reference = 0 if fh.is_last else slot
        ANIM.encode_frame_into(bw, hdr, fh, image(*((h, w) if place == "full"
                                                     else (sh, sw))), True)
    bw.zero_pad_to_byte()
    return bw.to_bytes()


def legacy_animation(frames, durations=None, distance: float = 1.0,
                     speed: int = 0) -> bytes:
    """Round-1 payload frames (host.vardct.frame.encode_vardct_frame, as
    jxl_coder_tpu_torch.codec.encode_vardct_still writes one, quantised on
    the CPU) under an animation header: 8-bit RGB, ticks of 1 ms."""
    from jxl_coder_tpu_torch.codec import quantize_still
    from jxl_coder_tpu_torch.host.vardct import frame as VF
    h, w, _ = frames[0].shape
    hdr = ImageHeader(size=SizeHeader(xsize=w, ysize=h),
                      metadata=ImageMetadata())
    hdr.metadata.animation = AnimationHeader(tps_numerator=1000,
                                             tps_denominator=1)
    durations = [100] * len(frames) if durations is None else durations
    bw = BitWriter()
    write_image_header(bw, hdr)
    for idx, (pixels, dur) in enumerate(zip(frames, durations)):
        fh = FrameHeader()
        fh.encoding = Encoding.VARDCT
        fh.x_qm_scale = 2
        fh.restoration_filter.epf_iters = 0 if speed >= 2 else 1
        fh.restoration_filter.gab = speed < 4
        fh.duration = int(dur)
        fh.is_last = idx == len(frames) - 1
        ac, dc, qf = (t.numpy() for t in quantize_still(pixels, distance,
                                                        "cpu"))
        ny, nx = qf.shape
        ty, tx = -(-ny // 8), -(-nx // 8)
        VF.encode_vardct_frame(bw, hdr, fh, VF.VarDctFrameData(
            ac=ac, dc=dc, qf=qf, cfl_x=np.zeros((ty, tx), np.int32),
            cfl_b=np.full((ty, tx), 64, np.int32), distance=float(distance)))
    bw.zero_pad_to_byte()
    return bw.to_bytes()


# ---- baseline JPEG files (the JPEG routes) -------------------------------
# The card's machine has no PIL: these write the JPEGs that the JPEG routes'
# checks recompress.  ITU-T T.81 Annex K's tables: the quantisation tables
# (natural order), scaled for a quality as libjpeg scales them, and the
# Huffman tables (code-length counts, then the symbols by code length).

_Q_LUMA = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
_Q_CHROMA = np.full(64, 99)
_Q_CHROMA[[0, 1, 2, 3, 8, 9, 10, 11, 16, 17, 18, 24, 25]] = [
    17, 18, 24, 47, 18, 21, 26, 66, 24, 26, 56, 47, 66]


def _ac_symbols(head) -> list:
    """Annex K's AC symbols: its first entries, then every other run/size
    symbol in ascending order."""
    every = {0x00, 0xF0} | {(r << 4) | s for r in range(16)
                            for s in range(1, 11)}
    rest = sorted(every - set(head))
    return list(head) + rest


_HUFF = {   # (class, id): (counts of code lengths 1..16, symbols)
    (0, 0): ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0],
             list(range(12))),
    (0, 1): ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0],
             list(range(12))),
    (1, 0): ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D],
             _ac_symbols([
                 0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31,
                 0x41, 0x06, 0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32,
                 0x81, 0x91, 0xA1, 0x08, 0x23, 0x42, 0xB1, 0xC1, 0x15, 0x52,
                 0xD1, 0xF0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0A,
                 0x16])),
    (1, 1): ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77],
             _ac_symbols([
                 0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06,
                 0x12, 0x41, 0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81,
                 0x08, 0x14, 0x42, 0x91, 0xA1, 0xB1, 0xC1, 0x09, 0x23, 0x33,
                 0x52, 0xF0, 0x15, 0x62, 0x72, 0xD1, 0x0A, 0x16, 0x24, 0x34,
                 0xE1, 0x25, 0xF1])),
}
# PIL's subsampling codes: (h, v) sampling factors of Y (chroma 1 x 1)
_SAMPLING = {0: (1, 1), 1: (2, 1), 2: (2, 2)}


def _quant_table(base: np.ndarray, quality: int) -> np.ndarray:
    """libjpeg's jpeg_quality_scaling and jpeg_add_quant_table (baseline:
    1..255), natural order."""
    q = min(max(int(quality), 1), 100)
    scale = 5000 // q if q < 50 else 200 - 2 * q
    return np.clip((base * scale + 50) // 100, 1, 255).astype(np.int32)


def _segment(marker: int, body: bytes) -> bytes:
    return bytes([0xFF, marker]) + (len(body) + 2).to_bytes(2, "big") + body


def _ycbcr(img: np.ndarray) -> np.ndarray:
    """JFIF's RGB -> YCbCr, rounded to 8 bits."""
    rgb = img.astype(np.float64)
    m = np.array([[0.299, 0.587, 0.114], [-0.168736, -0.331264, 0.5],
                  [0.5, -0.418688, -0.081312]])
    out = rgb @ m.T + np.array([0.0, 128.0, 128.0])
    return np.clip(np.floor(out + 0.5), 0, 255)


def baseline_jpeg(img: np.ndarray, quality: int = 90, subsampling: int = 0,
                  restart: int = 0, grey: bool = False) -> bytes:
    """A baseline JPEG of (H, W, 3) uint8 pixels (or of its first channel
    when `grey`), written with numpy: JFIF's YCbCr, the chroma averaged
    over each sampling cell (subsampling as PIL's: 0 4:4:4, 1 4:2:2, 2
    4:2:0), the forward DCT, the Annex K tables scaled for `quality`,
    `restart` MCUs between restart markers (0: none), and the scan by the
    port's host/jpeg/writer.py."""
    from jxl_coder_tpu_torch.host.jpeg import parser as JP
    from jxl_coder_tpu_torch.host.jpeg.writer import write_jpeg
    from jxl_coder_tpu_torch.vardct.dct import dct_matrix
    h, w = img.shape[:2]
    planes = (img[:, :, :1].astype(np.float64) if grey else _ycbcr(img))
    hmax, vmax = (1, 1) if grey else _SAMPLING[subsampling]
    mx, my = -(-w // (8 * hmax)), -(-h // (8 * vmax))
    iy = np.minimum(np.arange(my * 8 * vmax), h - 1)
    ix = np.minimum(np.arange(mx * 8 * hmax), w - 1)
    planes = planes[iy][:, ix]
    tables = [_quant_table(_Q_LUMA, quality)]
    if not grey:
        tables.append(_quant_table(_Q_CHROMA, quality))
    m = dct_matrix(8).astype(np.float64)
    zz = np.asarray(JP.ZIGZAG)
    j = JP.JpegData(width=w, height=h, precision=8, hmax=hmax, vmax=vmax,
                    mcus_x=mx, mcus_y=my, restart_interval=restart,
                    trailer_bytes=b"\xff\xd9")
    sof = bytearray([8]) + h.to_bytes(2, "big") + w.to_bytes(2, "big")
    sof.append(planes.shape[2])
    sos = bytearray([planes.shape[2]])
    for c in range(planes.shape[2]):
        fh, fv = (hmax, vmax) if c == 0 else (1, 1)
        t = 0 if c == 0 else 1
        p = planes[:, :, c]
        ry, rx = vmax // fv, hmax // fh
        if ry > 1 or rx > 1:
            p = p.reshape(p.shape[0] // ry, ry, p.shape[1] // rx, rx).mean(
                axis=(1, 3))
        bh, bw = p.shape[0] // 8, p.shape[1] // 8
        blocks = (p - 128.0).reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3)
        coef = m @ blocks @ m.T
        q = tables[t].reshape(8, 8)
        nat = np.round(coef / q).astype(np.int32).reshape(bh, bw, 64)
        comp = JP.Component(c + 1, fh, fv, t, td=t, ta=t, blocks_w=bw,
                            blocks_h=bh)
        comp.coeffs = np.ascontiguousarray(nat[:, :, zz])
        j.components.append(comp)
        sof += bytes([c + 1, (fh << 4) | fv, t])
        sos += bytes([c + 1, (t << 4) | t])
    sos += bytes([0, 63, 0])
    j.quant = {t: tab[zz] for t, tab in enumerate(tables)}
    dqt = b"".join(bytes([t]) + bytes(tab[zz].tolist())
                   for t, tab in enumerate(tables))
    dht = bytearray()
    for (cls, tid), (counts, syms) in _HUFF.items():
        if tid < len(tables):
            dht += bytes([(cls << 4) | tid]) + bytes(counts) + bytes(syms)
            (j.ac_tables if cls else j.dc_tables)[tid] = JP.HuffTable(
                list(counts), list(syms))
    head = (b"\xff\xd8" + _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01"
                                   b"\x00\x01\x00\x00")
            + _segment(0xDB, dqt) + _segment(0xC0, bytes(sof))
            + _segment(0xC4, bytes(dht)))
    if restart:
        head += _segment(0xDD, restart.to_bytes(2, "big"))
    j.header_bytes = head + _segment(0xDA, bytes(sos))
    return write_jpeg(j)


# ---- ICC profiles (ICC.1:2010 matrix / TRC), from published constants -----

# D50-adapted colorants (columns: red, green, blue; rows: X, Y, Z) as the
# published profiles carry them: Adobe RGB (1998) (Adobe's profile), Display
# P3 (Apple's), ProPhoto / ROMM RGB (ISO 22028-2), and littlecms's sRGB
ICC_COLORANTS = {
    "adobe": np.array([[0.60974, 0.20528, 0.14919],
                       [0.31111, 0.62567, 0.06322],
                       [0.01947, 0.06087, 0.74457]]),
    "p3": np.array([[0.515121, 0.291977, 0.157104],
                    [0.241196, 0.692245, 0.066574],
                    [-0.001053, 0.041885, 0.784073]]),
    "prophoto": np.array([[0.7977, 0.1352, 0.0313],
                          [0.2880, 0.7119, 0.0001],
                          [0.0, 0.0, 0.8249]]),
    "srgb": SRGB_D50,
}
# tone curves: ("curv", None) the identity, ("curv", gamma), ("curv", array
# of 16-bit entries), ("para", function type, params)
SRGB_PARA = ("para", 3, (2.4, 1 / 1.055, 0.055 / 1.055, 1 / 12.92, 0.04045))
ADOBE_CURV = ("curv", 563 / 256)
PROPHOTO_CURV = ("curv", 1.8)


def _s15(v: float) -> bytes:
    return struct.pack(">i", int(round(v * 65536)))


def _icc_curve(spec) -> bytes:
    if spec[0] == "curv":
        ent = spec[1]
        if ent is None:
            return b"curv\0\0\0\0" + struct.pack(">I", 0)
        if np.isscalar(ent):
            return b"curv\0\0\0\0" + struct.pack(">IH", 1,
                                                    int(round(ent * 256)))
        ent = np.asarray(ent)
        return b"curv\0\0\0\0" + struct.pack(">I", len(ent)) + \
            ent.astype(">u2").tobytes()
    _, ftype, params = spec
    return b"para\0\0\0\0" + struct.pack(">HH", ftype, 0) + \
        b"".join(_s15(p) for p in params)


def icc_profile(colorants="p3", curve=SRGB_PARA, version: int = 2,
                space: bytes = b"RGB ", cls: bytes = b"mntr",
                extra=(), pcs: bytes = b"XYZ ") -> bytes:
    """An ICC display profile: the header (D50 illuminant, `pcs`), desc (v2
    textDescription, v4 mluc), wtpt D50, the rXYZ / gXYZ / bXYZ colorants
    (a name of ICC_COLORANTS or a 3x3 array; None: none) and the three
    TRCs (one spec for all, a list of three, or None: none), then `extra`
    (signature, bytes) tags."""
    if version >= 4:
        desc = b"mluc\0\0\0\0" + struct.pack(">II", 1, 12) + b"enUS" + \
            struct.pack(">II", 8, 28) + "test".encode("utf-16-be")
    else:
        desc = b"desc\0\0\0\0" + struct.pack(">I", 5) + b"test\0" + \
            b"\0" * 79
    d50 = (0.9642, 1.0, 0.8249)
    tags = [(b"desc", desc),
            (b"wtpt", b"XYZ \0\0\0\0" + b"".join(_s15(v) for v in d50))]
    if colorants is not None:
        col = ICC_COLORANTS[colorants] if isinstance(colorants, str) \
            else np.asarray(colorants)
        for sig, xyz in zip((b"rXYZ", b"gXYZ", b"bXYZ"), col.T):
            tags.append((sig, b"XYZ \0\0\0\0" +
                         b"".join(_s15(v) for v in xyz)))
    if curve is not None:
        curves = curve if isinstance(curve, list) else [curve] * 3
        for sig, c in zip((b"rTRC", b"gTRC", b"bTRC"), curves):
            tags.append((sig, _icc_curve(c)))
    tags.extend(extra)
    start = 128 + 4 + 12 * len(tags)
    table, body = b"", b""
    for sig, data in tags:
        data += b"\0" * (-len(data) % 4)
        table += sig + struct.pack(">II", start + len(body), len(data))
        body += data
    hdr = struct.pack(">I4sI4s4s4s", start + len(body), b"lcms",
                      0x04300000 if version >= 4 else 0x02100000, cls,
                      space, pcs)
    hdr += struct.pack(">6H", 2024, 1, 1, 0, 0, 0) + b"acsp" + b"APPL" + \
        b"\0" * 20 + struct.pack(">I", 0) + b"".join(_s15(v) for v in d50)
    hdr += b"lcms" + b"\0" * 44
    return hdr + struct.pack(">I", len(tags)) + table + body


def icc_lut8() -> bytes:
    """A minimal identity lut8Type (mft1) tag, for an A2B0 / D2B0."""
    body = b"mft1\0\0\0\0" + bytes([3, 3, 2, 0])
    body += b"".join(_s15(v) for v in (1, 0, 0, 0, 1, 0, 0, 0, 1))
    body += bytes(range(256)) * 3
    body += bytes(v for i in range(2) for j in range(2) for k in range(2)
                  for v in (i * 255, j * 255, k * 255))
    return body + bytes(range(256)) * 3


def lut_profile() -> bytes:
    """A Display P3 matrix / TRC profile that also carries an A2B0 table,
    which littlecms's perceptual intent converts through."""
    return icc_profile("p3", SRGB_PARA, 2, extra=[(b"A2B0", icc_lut8())])


# ---- ICC lookup-table profiles (ICC.1:2010 10.8-10.14), seeded tables -----

def icc_mft1(in_tables, clut, out_tables, matrix=np.eye(3)) -> bytes:
    """A lut8Type (mft1) tag: 3 x 256 byte input tables, a CLUT of
    clut.shape[0] points per axis (shape (g, g, g, nout), bytes), nout x
    256 byte output tables, and the 3x3 matrix."""
    clut = np.asarray(clut)
    nout, g = clut.shape[-1], clut.shape[0]
    body = b"mft1\0\0\0\0" + bytes([3, nout, g, 0])
    body += b"".join(_s15(v) for v in np.asarray(matrix).ravel())
    body += np.asarray(in_tables, np.uint8).tobytes()
    body += clut.astype(np.uint8).tobytes()
    return body + np.asarray(out_tables, np.uint8).tobytes()


def icc_mft2(in_tables, clut, out_tables, matrix=np.eye(3)) -> bytes:
    """A lut16Type (mft2) tag: as icc_mft1 with 16-bit tables of any
    length (each list's rows the same length) and CLUT."""
    clut = np.asarray(clut)
    nout, g = clut.shape[-1], clut.shape[0]
    in_tables, out_tables = np.asarray(in_tables), np.asarray(out_tables)
    body = b"mft2\0\0\0\0" + bytes([3, nout, g, 0])
    body += b"".join(_s15(v) for v in np.asarray(matrix).ravel())
    body += struct.pack(">HH", in_tables.shape[1], out_tables.shape[1])
    body += in_tables.astype(">u2").tobytes()
    body += clut.astype(">u2").tobytes()
    return body + out_tables.astype(">u2").tobytes()


def _pad4(b: bytes) -> bytes:
    return b + b"\0" * (-len(b) % 4)


def icc_mab(a=None, clut=None, m=None, matrix=None, b=None,
            precision: int = 2) -> bytes:
    """A lutAtoBType (mAB ) tag of 3 inputs: a / m / b lists of curve specs
    (as icc_profile's TRCs), clut of shape (g0, g1, g2, nout) in [0, 1]
    (written at `precision` bytes), matrix (3x3, 3 offsets); None leaves
    an element out."""
    nout = 3 if clut is None else np.asarray(clut).shape[-1]
    parts, offsets = [], {}
    pos = 32

    def add(key, data):
        nonlocal pos
        offsets[key] = pos
        data = _pad4(data)
        parts.append(data)
        pos += len(data)
    if b is not None:
        add("b", b"".join(_pad4(_icc_curve(c)) for c in b))
    if matrix is not None:
        mat, off = matrix
        add("mat", b"".join(_s15(v) for v in np.asarray(mat).ravel())
            + b"".join(_s15(v) for v in off))
    if m is not None:
        add("m", b"".join(_pad4(_icc_curve(c)) for c in m))
    if clut is not None:
        c = np.asarray(clut, np.float64)
        grid = bytes(c.shape[:3]) + b"\0" * 13
        top = 255 if precision == 1 else 65535
        vals = np.clip(np.round(c * top), 0, top).astype(
            np.uint8 if precision == 1 else ">u2")
        add("clut", grid + bytes([precision, 0, 0, 0]) + vals.tobytes())
    if a is not None:
        add("a", b"".join(_pad4(_icc_curve(c)) for c in a))
    head = b"mAB \0\0\0\0" + bytes([3, nout]) + b"\0\0"
    head += b"".join(struct.pack(">I", offsets.get(k, 0))
                     for k in ("b", "mat", "m", "clut", "a"))
    return head + b"".join(parts)


def _f32s(vals) -> bytes:
    return np.asarray(vals, ">f4").tobytes()


def mpet_curve(segments) -> bytes:
    """A segmented curve (curf): segments as (breakpoint or None for the
    last, ("parf", type, params) or ("samf", points))."""
    body = b"curf\0\0\0\0" + struct.pack(">HH", len(segments), 0)
    body += _f32s([bp for bp, _ in segments[:-1]])
    for _, seg in segments:
        if seg[0] == "parf":
            body += b"parf\0\0\0\0" + struct.pack(">HH", seg[1], 0) + \
                _f32s(seg[2])
        else:
            body += b"samf\0\0\0\0" + struct.pack(">I", len(seg[1])) + \
                _f32s(seg[1])
    return body


def icc_mpet(elements, nin: int = 3, nout: int = 3) -> bytes:
    """A multiProcessElementType (mpet) tag: elements ("cvst", [curf
    bytes]), ("matf", 3x3, offsets), ("clut", (g, g, g, 3) floats)."""
    blobs = []
    for el in elements:
        if el[0] == "cvst":
            curves = el[1]
            n = len(curves)
            pos, table, data = 12 + 8 * n, b"", b""
            for c in curves:
                c = _pad4(c)
                table += struct.pack(">II", pos, len(c))
                data += c
                pos += len(c)
            blobs.append(b"cvst\0\0\0\0" + struct.pack(">HH", n, n) +
                         table + data)
        elif el[0] == "matf":
            mat = np.asarray(el[1])
            blobs.append(b"matf\0\0\0\0" + struct.pack(
                ">HH", mat.shape[1], mat.shape[0]) + _f32s(mat.ravel()) +
                _f32s(el[2]))
        else:
            c = np.asarray(el[1])
            blobs.append(b"clut\0\0\0\0" + struct.pack(
                ">HH", c.ndim - 1, c.shape[-1]) + bytes(c.shape[:-1]) +
                b"\0" * (16 - (c.ndim - 1)) + _f32s(c.ravel()))
    pos = 16 + 8 * len(blobs)
    head = b"mpet\0\0\0\0" + struct.pack(">HHI", nin, nout, len(blobs))
    table, data = b"", b""
    for bl in blobs:
        bl = _pad4(bl)
        table += struct.pack(">II", pos, len(bl))
        data += bl
        pos += len(bl)
    return head + table + data


def _lab_of(xyz: np.ndarray) -> np.ndarray:
    """D50-relative CIELAB."""
    t = xyz / np.array([0.9642, 1.0, 0.8249])
    f = np.where(t > (6 / 29) ** 3, np.cbrt(t), t / (3 * (6 / 29) ** 2)
                 + 4 / 29)
    return np.stack([116 * f[..., 1] - 16, 500 * (f[..., 0] - f[..., 1]),
                     200 * (f[..., 1] - f[..., 2])], -1)


def _grid_rgb(*dims) -> np.ndarray:
    axes = [np.linspace(0, 1, d) for d in dims]
    return np.stack(np.meshgrid(*axes, indexing="ij"), -1)


def _p3_xyz(rgb_linear: np.ndarray) -> np.ndarray:
    return rgb_linear @ ICC_COLORANTS["p3"].T


def lut_test_profiles() -> dict:
    """The profiles littlecms converts by its resampled CLUT, and the
    matrix / TRC ones it converts with black-point compensation or
    saturating sums: name -> profile bytes, every table seeded."""
    rng = np.random.default_rng(1806)
    x256 = np.arange(256) / 255.0
    # v2 mft1 on the Lab PCS: a 9-point grid of P3's Lab, jittered
    gam = rng.uniform(0.85, 1.2, 3)
    in8 = np.round(255 * x256[None] ** gam[:, None])
    lab = _lab_of(_p3_xyz(_grid_rgb(9, 9, 9) ** 2.2))
    lab8 = np.stack([lab[..., 0] * 255 / 100, lab[..., 1] + 128,
                     lab[..., 2] + 128], -1) + rng.integers(-2, 3,
                                                            lab.shape)
    out8 = np.round(255 * x256[None] ** rng.uniform(0.95, 1.05, 3)[:, None])
    mft1 = icc_mft1(in8, np.clip(np.round(lab8), 0, 255), out8)
    # v2 mft2 on the XYZ PCS, with its matrix
    x1024 = np.linspace(0, 1, 1024)
    in16 = np.round(65535 * x1024[None] ** rng.uniform(1.8, 2.4, 3)[:, None])
    xyz = _p3_xyz(_grid_rgb(17, 17, 17)) * 32768 * \
        (1 + rng.uniform(-0.01, 0.01, (17, 17, 17, 3)))
    out16 = np.round(65535 * np.linspace(0, 1, 64)[None] ** np.array(
        [[1.0], [0.98], [1.03]]))
    mix = np.array([[0.92, 0.05, 0.03], [0.04, 0.93, 0.03],
                    [0.02, 0.06, 0.92]])
    mft2 = icc_mft2(in16, np.clip(np.round(xyz), 0, 65535), out16, mix)
    # v4 mAB: A curves, a CLUT of 9 x 11 x 13 points, M curves, matrix +
    # offset, B curves; XYZ PCS at 16 bits, Lab PCS at 8 bits
    enc = 32768 / 65535
    a_curves = [SRGB_PARA, ("para", 0, (2.2,)), ADOBE_CURV]
    mab_clut = _p3_xyz(_grid_rgb(9, 11, 13)) * enc * \
        (1 + rng.uniform(-0.01, 0.01, (9, 11, 13, 3)))
    m_curves = [("para", 0, (1.1,)), ("curv", None), ("para", 0, (0.9,))]
    mat = (np.eye(3) + rng.uniform(-0.03, 0.03, (3, 3)),
           rng.uniform(0, 0.004, 3))
    b_curves = [("curv", None), ("para", 0, (1.05,)),
                ("curv", np.round(65535 * np.linspace(0, 1, 200) ** 0.97))]
    mab16 = icc_mab(a_curves, mab_clut, m_curves, mat, b_curves, 2)
    lab_clut = _lab_of(_p3_xyz(_grid_rgb(9, 11, 13)) * 1.0)
    lab_clut = np.stack([lab_clut[..., 0] / 100, (lab_clut[..., 1] + 128)
                         / 255, (lab_clut[..., 2] + 128) / 255], -1)
    mat8 = (np.eye(3) + rng.uniform(-0.01, 0.01, (3, 3)),
            np.array([0.002, 0.0, 0.0]))
    mab8 = icc_mab(a_curves, lab_clut, [("curv", None)] * 3, mat8,
                   [("curv", None)] * 3, 1)
    # v4 mpet D2B0: segmented curves (a line, sampled points, a line), a
    # matrix with offsets, a float CLUT of P3's XYZ
    pts = list(((np.linspace(0.04045, 1, 65)[1:] + 0.055) / 1.055) ** 2.4)
    curf = mpet_curve([(0.04045, ("parf", 0, (1.0, 1 / 12.92, 0.0, 0.0))),
                       (1.0, ("samf", pts)),
                       (None, ("parf", 0, (1.0, 1.0, 0.0, 0.0)))])
    gamma = mpet_curve([(None, ("parf", 0, (2.2, 1.0, 0.0, 0.0)))])
    mix_f = np.eye(3) + rng.uniform(-0.02, 0.02, (3, 3))
    fclut = _p3_xyz(_grid_rgb(7, 7, 7)) * (1 + rng.uniform(
        -0.005, 0.005, (7, 7, 7, 3)))
    mpet = icc_mpet([("cvst", [curf, gamma, curf]),
                     ("matf", mix_f, [0.0, 0.001, 0.0]),
                     ("clut", fclut)])
    black = ("para", 2, (2.4, 1 / 1.055, 0.055 / 1.055, 0.02))
    return {
        "mft1 lab v2": icc_profile("p3", SRGB_PARA, 2, pcs=b"Lab ",
                                   extra=[(b"A2B0", mft1)]),
        "mft2 xyz v2": icc_profile(None, None, 2, extra=[(b"A2B0", mft2)]),
        "mab16 xyz v4": icc_profile("p3", SRGB_PARA, 4,
                                    extra=[(b"A2B0", mab16)]),
        "mab8 lab v4": icc_profile(None, None, 4, pcs=b"Lab ",
                                   extra=[(b"A2B0", mab8)]),
        "mpet d2b0 v4": icc_profile(None, None, 4,
                                    extra=[(b"D2B0", mpet)]),
        "identity mft1": lut_profile(),
        "black v2": icc_profile("p3", black, 2),
        "black v4": icc_profile("adobe", ("para", 4, (2.2, 0.95, 0.05, 0.1,
                                                      0.03, 0.01, 0.01)), 4),
        "int32 reach": icc_profile("prophoto", ("para", 1, (2.4, 200.0,
                                                            0.0)), 2),
    }


def mft1_under_d2b0() -> bytes:
    """A lut8Type under D2B0, where littlecms reads only mpet: it builds no
    transform, and the reference passes the pixels through."""
    return icc_profile("p3", SRGB_PARA, 2, extra=[(b"D2B0", icc_lut8())])


def _srgb_decode(x: np.ndarray) -> np.ndarray:
    return np.where(x <= 0.04045, x / 12.92, ((x + 0.055) / 1.055) ** 2.4)


def icc_test_profiles() -> dict:
    """The matrix / TRC profiles the ICC step is held to littlecms on:
    name -> profile bytes (Adobe RGB, Display P3 v2 / v4, ProPhoto, curv
    tables and the identity, para types 0-4, mixed curves, and sRGB,
    whose matrix littlecms drops)."""
    x1024, x4096 = np.linspace(0, 1, 1024), np.linspace(0, 1, 4096)
    gamma_table = ("curv", np.round(65535 * x1024 ** 2.2).astype(np.int64))
    srgb_table = ("curv", np.round(65535 * _srgb_decode(x4096))
                  .astype(np.int64))
    para4 = ("para", 4, (2.2, 1 / 1.055, 0.055 / 1.055, 1 / 12.92, 0.04045,
                         0.0, 0.0))
    specs = {
        "adobe": ("adobe", ADOBE_CURV, 2),
        "p3 v2": ("p3", SRGB_PARA, 2),
        "p3 v4": ("p3", SRGB_PARA, 4),
        "prophoto": ("prophoto", PROPHOTO_CURV, 2),
        "curv table": ("adobe", gamma_table, 2),
        "curv identity": ("p3", ("curv", None), 4),
        "para 0": ("p3", ("para", 0, (2.2,)), 4),
        "para 1": ("prophoto", ("para", 1, (2.4, 1.1, -0.1)), 4),
        "para 2": ("adobe", ("para", 2, (2.4, 1.1, -0.1, 0.0)), 4),
        "para 3": ("adobe", SRGB_PARA, 4),
        "para 4": ("p3", para4, 4),
        "mixed curves": ("p3", [ADOBE_CURV, SRGB_PARA, gamma_table], 2),
        "srgb": ("srgb", SRGB_PARA, 4),
        "srgb table": ("srgb", srgb_table, 2),
    }
    return {k: icc_profile(*v) for k, v in specs.items()}


def with_icc(data: bytes, icc: bytes) -> bytes:
    """A still's stream with `icc` embedded in its image header (the
    frames as they are: the header ends on a byte)."""
    hdr = api.parse_header(data)
    n = len(header_bytes(hdr))
    if header_bytes(hdr) != data[:n]:
        raise ValueError("the stream's header does not re-serialise")
    hdr.metadata.colour_encoding.want_icc = True
    hdr.metadata.icc_profile = icc
    return header_bytes(hdr) + data[n:]
