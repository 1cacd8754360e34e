"""Host parse of one VarDCT frame into the device-path state.

The parse-only branch of ``jxl_coder_tpu.vardct.dec_real.
decode_vardct_frame`` (``dec_real.py:1630-1866``), built from the
readers of the port's copy ``host/vardct/dec_real.py`` (numpy and C++): LF
global, LF groups, DC planes with adaptive smoothing, HF global, and
the pass groups (multi-pass coefficients accumulated) concatenated into
one frame-global ``BlockArrays``.  It returns the same state dict, the
input of ``tpu_full.prepare_exec``.

The pass groups take one of two routes (``entropy``): "host" decodes
them with the host codec's C++ on a thread pool; "device" decodes them
all with one launch of the device entropy decode
(``entropy/device.py``, the counterpart of ``dec_real.py``'s
``_entropy_device_pass_groups``), whose coefficients stay on the device
as the ``BlockArrays``' int32 tensor.  A stream that route cannot read
raises; it never falls back to the host route.

A frame's extra channels are a Modular image (``lf.mfd``): its global
stream is read with LF global, each pass group's EC stream right after
the group's AC tokens (the host route only: with entropy="device" their
start is known only after the host has read the tokens, so such a frame
raises NotImplementedError, as the reference's device entropy route
declines it); ``state["lf"].mfd`` holds their raw planes.

``dc_only`` stops after the LF groups and the DC smoothing (the
``dc_only`` branch of ``dec_real.py:1727-1747``, the thumbnail's): no HF
global and no pass group is read, on either route, and the state has no
``blocks_glob``.

A frame with a DC frame (kUseDcFrame) reads its LF groups without their
DC (its quantized DC channels are zeros, which both routes' block
contexts read, as the host does) and leaves ``dc_glob`` None: its DC is
the LF frame's planes, on the device, with no smoothing.  Its patch
dictionary and splines come with LF global (``state["lf"]``).

Unlike the reference it never asks whether a JAX device is attached and
applies no frame-size floor.  A YCbCr frame (JPEG recompression) parses
as any other when its channels share one block grid; with chroma
subsampling it raises NotImplementedError (the JPEG route,
``jpeg/wire.py``, reads such a frame when a jbrd box comes with it).
"""

from __future__ import annotations

import concurrent.futures
import os

import numpy as np

from ..entropy import device as ENT
from ..host.bitstream.reader import BitReader, BitstreamError
from ..host.vardct.dec_real import (BlockArrays, _lf_group_view,
                                    adaptive_dc_smoothing,
                                    compute_dc_planes, read_hf_global,
                                    check_ycbcr, read_lf_global,
                                    read_lf_group, read_pass_group)

_LF_GROUP_BLOCKS = 256      # LF groups: 2048 px
_GROUP_BLOCKS = 32          # AC groups: 256 px

# frame-header flags (dec_real.read_lf_global)
DC_FRAME, _SKIP_SMOOTHING = 0x20, 0x80


def check_supported(hdr, fh, entropy: str = "host") -> None:
    """Raise NotImplementedError for a frame outside the port's slice."""
    check_ycbcr(fh)
    if entropy == "device" and hdr.metadata.extra_channels:
        raise NotImplementedError(
            "entropy='device' on a VarDCT frame with extra channels: each "
            "pass group's extra-channel stream follows its AC tokens, so "
            "its start is known only after the host has read them (the "
            "reference's device entropy route declines such frames too); "
            "decode it with entropy='host'")


ENTROPY_ROUTES = ("host", "device")


def check_entropy(entropy: str) -> None:
    if entropy not in ENTROPY_ROUTES:
        raise ValueError(f"entropy={entropy!r}: use one of {ENTROPY_ROUTES}")


def parse_frame(cs: bytes, hdr, fh, toc, entropy: str = "host",
                device=None, dc_only: bool = False,
                max_passes: int = None) -> dict:
    """Entropy-decode one VarDCT frame -> the state dict of
    decode_vardct_frame(parse_only=True).  With entropy="device" the AC
    pass groups decode on `device` (a torch.device) and the state's
    blocks_glob.coeffs is an int32 tensor there.  dc_only: the state up
    to the (smoothed) DC planes, no AC read (the route is then moot).
    max_passes: read only the first max_passes AC passes (the reference's
    ``dec_real.py:1637-1641``; the coefficients keep their shifted scale;
    a single-section TOC ignores it), so a stream cut after them parses."""
    check_entropy(entropy)
    check_supported(hdr, fh, "host" if dc_only else entropy)
    w, h = fh.coded_size(hdr)
    xs_b, ys_b = -(-w // 8), -(-h // 8)
    ng, ndc = fh.counts(hdr)
    npasses = fh.passes.num_passes
    pass_shift = list(fh.passes.shift) + [0]
    single = len(toc.entries) == 1
    if (max_passes is not None and 0 < max_passes < npasses
            and not single):
        npasses = max_passes

    if single:
        s = toc.section(0)
        br = BitReader(cs[s.offset:s.offset + s.size])

        def section(_idx):
            return br
    else:
        def section(idx):
            s = toc.section(idx)
            return BitReader(cs[s.offset:s.offset + s.size])

    lf = read_lf_global(section(0), fh, hdr, w, h)
    use_dc_frame = bool(fh.flags & DC_FRAME)

    gx_lf = -(-xs_b // _LF_GROUP_BLOCKS)
    lgs = []
    for gi in range(ndc):
        lx = (gi % gx_lf) * _LF_GROUP_BLOCKS
        ly = (gi // gx_lf) * _LF_GROUP_BLOCKS
        gw = min(_LF_GROUP_BLOCKS, xs_b - lx)
        gh = min(_LF_GROUP_BLOCKS, ys_b - ly)
        lgs.append((lx, ly, read_lf_group(section(1 + gi), lf, gw, gh,
                                          gi, ndc,
                                          use_dc_frame=use_dc_frame)))

    qf_map = np.zeros((ys_b, xs_b), np.int64)
    on_device = entropy == "device"
    if on_device:
        # the device route's anchors come from frame-global block maps
        acs_glob = np.zeros((ys_b, xs_b), np.int32)
        dcq_glob = [np.zeros((ys_b, xs_b), np.int64) for _ in range(3)]
    sharp_map = np.zeros((ys_b, xs_b), np.int64)
    ytox_glob = np.zeros((-(-ys_b // 8), -(-xs_b // 8)), np.float64)
    ytob_glob = np.zeros_like(ytox_glob)
    dc_glob = (None if use_dc_frame else
               {c: np.zeros((ys_b, xs_b)) for c in range(3)})
    for lx, ly, lg in lgs:
        gh_, gw_ = lg.qf_map.shape
        qf_map[ly:ly + gh_, lx:lx + gw_] = lg.qf_map
        if on_device:
            acs_glob[ly:ly + gh_, lx:lx + gw_] = lg.acs_map
            for c in range(3):
                dcq_glob[c][ly:ly + gh_, lx:lx + gw_] = \
                    lg.dc.channels[c].data
        sharp_map[ly:ly + gh_, lx:lx + gw_] = lg.sharp_map
        th_, tw_ = lg.ytox.shape
        ytox_glob[ly // 8:ly // 8 + th_, lx // 8:lx // 8 + tw_] = lg.ytox
        ytob_glob[ly // 8:ly // 8 + th_, lx // 8:lx // 8 + tw_] = lg.ytob
        if dc_glob is not None:
            dcp = compute_dc_planes(lf, lg)
            for c in range(3):
                dc_glob[c][ly:ly + gh_, lx:lx + gw_] = dcp[c]
    if dc_glob is not None and not fh.flags & _SKIP_SMOOTHING:
        # the smoothing gate uses the nominal DC step (dec_real.py:1719)
        igs0 = lf.inv_global_scale
        steps = [lf.dcq[c] * igs0 / lf.quant_dc for c in range(3)]
        dc_glob = adaptive_dc_smoothing(dc_glob, dict(enumerate(steps)))

    state = dict(
        lf=lf, fh=fh, qf_map=qf_map, sharp_map=sharp_map,
        ytox_glob=ytox_glob, ytob_glob=ytob_glob, dc_glob=dc_glob,
        bits=hdr.metadata.bit_depth.bits_per_sample, h=h, w=w)
    if dc_only:
        return state
    if not ng:
        raise BitstreamError("VarDCT frame without AC groups")
    hf = read_hf_global(section(1 + ndc), lf, ng, npasses, ndc)
    histo_bits = ((hf.num_histograms - 1).bit_length()
                  if hf.num_histograms > 1 else 0)
    if on_device:
        if single:
            s = toc.section(0)
            sections = [[(8 * s.offset + br.pos, 8 * (s.offset + s.size))]]
        else:
            sections = [[(8 * s.offset, 8 * (s.offset + s.size))
                         for s in (toc.section(2 + ndc + p * ng + gi)
                                   for gi in range(ng))]
                        for p in range(npasses)]
        sections = np.minimum(np.asarray(sections, np.int64), 8 * len(cs))
        state["blocks_glob"] = device_pass_groups(
            cs, sections, lf, hf, acs_glob, qf_map, dcq_glob, histo_bits,
            pass_shift[:npasses], device)
        return state

    gx = -(-xs_b // _GROUP_BLOCKS)

    def decode_group(gi):
        ax = (gi % gx) * _GROUP_BLOCKS
        ay = (gi // gx) * _GROUP_BLOCKS
        gw = min(_GROUP_BLOCKS, xs_b - ax)
        gh = min(_GROUP_BLOCKS, ys_b - ay)
        lx, ly, lg = lgs[(ay // _LF_GROUP_BLOCKS) * gx_lf
                         + ax // _LF_GROUP_BLOCKS]
        sub = _lf_group_view(lg, ax - lx, ay - ly, gw, gh)
        dc_q = np.stack([sub.dc.channels[1].data, sub.dc.channels[0].data,
                         sub.dc.channels[2].data])
        blocks = None
        for p in range(npasses):
            br_g = section(2 + ndc + p * ng + gi)
            histo_index = br_g.u(histo_bits) if histo_bits else 0
            blocks_p = read_pass_group(br_g, lf, hf, sub, gw, gh, p,
                                       histo_index, dc_q, as_arrays=True)
            if blocks is None:
                blocks = blocks_p
                if pass_shift[0]:
                    blocks.coeffs = blocks.coeffs.astype(np.int64)
                    blocks.coeffs <<= pass_shift[0]
            else:
                blocks.accumulate_pass(blocks_p, pass_shift[p])
            if lf.mfd is not None:
                # the extra channels' group stream follows the AC tokens
                lf.mfd.read_group(br_g, gi, ndc, ng, pass_index=p)
        return ax, ay, blocks

    if single or ng == 1:
        groups = [decode_group(gi) for gi in range(ng)]
    else:
        # groups are independent; the native entropy loops release the
        # GIL, so threads decode them on all cores
        with concurrent.futures.ThreadPoolExecutor(
                max_workers=min(ng, os.cpu_count() or 4)) as ex:
            groups = list(ex.map(decode_group, range(ng)))
    state["blocks_glob"] = BlockArrays.concat(groups)
    return state


def device_pass_groups(cs: bytes, sections: np.ndarray, lf, hf, acs_map,
                       qf_map, dcq, histo_bits: int, pass_shift,
                       device) -> BlockArrays:
    """Every AC pass group of the frame, decoded on `device` in one launch
    (sections: (passes, groups, 2) bit ranges in cs, each from its
    histogram index on) -> the frame's BlockArrays, whose coefficients
    are an int32 tensor on `device`.  Raises BitstreamError naming the
    groups whose decode failed."""
    num_ctxs = lf.bcm.num_ctxs
    anchors = ENT.build_anchors(acs_map, qf_map, dcq, lf.bcm)
    streams = ENT.group_streams(cs, sections, histo_bits, hf.num_histograms,
                                num_ctxs)
    tables = ENT.frame_tables(cs, anchors, streams, hf, pass_shift, num_ctxs,
                              device)
    decoded = ENT.decode_pass_groups(tables)
    ENT.check_groups(decoded)
    return BlockArrays(anchors.ids, anchors.bxs, anchors.bys, anchors.ncv,
                       anchors.offs, decoded.coeffs)
