"""Encoder-side patch extraction: repeated-glyph detection + atlas.

The port's copy of ``jxl_coder_tpu/vardct/enc_patches.py`` (scipy's
labeler only).

Text/UI content costs VarDCT dearly (sharp edges ring at every
repetition).  libjxl's encoder extracts repeated rectangular patches
into a hidden kReferenceOnly frame and blends them back via the patch
dictionary (the wrapper ships this behaviour inside its prebuilt
libjxl.so; our decode side is vardct/patches.py).  This module is the
encode half:

1. detect():  high-residual connected components vs a blurred
   background, exact-content deduplication — only patches whose pixels
   REPEAT at least twice qualify (the win comes from paying for a
   glyph once).  Photographic content yields nothing and encodes
   exactly as before.
2. the atlas: distinct patches shelf-packed into a small reference
   frame (2 px edge-replicated gutters so the lossy atlas encode does
   not bleed between patches).
3. serialize_dictionary(): the wire mirror of PatchDictionary.read
   (10-context entropy stream, delta-coded positions).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from .patches import (NUM_PATCH_CONTEXTS, CTX_NUM_REF_PATCH,
                      CTX_REFERENCE_FRAME, CTX_PATCH_SIZE,
                      CTX_PATCH_REFERENCE_POSITION, CTX_PATCH_POSITION,
                      CTX_PATCH_BLEND_MODE, CTX_PATCH_OFFSET,
                      CTX_PATCH_COUNT, BLEND_ADD)

MAX_PATCH = 40          # max glyph bbox side
MIN_AREA = 12           # min glyph bbox area
MIN_REPEATS = 2         # content must appear this often
MIN_COVERAGE = 0.004    # patched area fraction below which we skip
GUTTER = 2              # atlas gap between patches


def _box_blur(f: np.ndarray, r: int = 4) -> np.ndarray:
    """(H, W, C) float box blur with edge clamp via cumsum."""
    h, w = f.shape[:2]
    pad = np.pad(f, ((r + 1, r), (r + 1, r), (0, 0)), mode="edge")
    cs = pad.cumsum(0).cumsum(1)
    n = (2 * r + 1) ** 2
    return (cs[2 * r + 1:, 2 * r + 1:] - cs[:h, 2 * r + 1:]
            - cs[2 * r + 1:, :w] + cs[:h, :w]) / n


def _label(mask: np.ndarray) -> List[Tuple[int, int, int, int]]:
    """Connected components (8-conn) -> bounding boxes, by scipy's C
    labeler (the original's pure-Python fallback is not copied: scipy
    is on every machine the port runs on)."""
    from scipy import ndimage as _ndi
    lab, n = _ndi.label(mask, structure=np.ones((3, 3), np.int32))
    out = []
    for sl in _ndi.find_objects(lab):
        if sl is not None:
            out.append((sl[1].start, sl[0].start, sl[1].stop, sl[0].stop))
    return out


@dataclasses.dataclass
class PatchPlan:
    atlas: np.ndarray                 # (3, AH, AW) float32 XYB deltas
    rects: List[Tuple[int, int, int, int]]   # (x0, y0, w, h) in atlas
    placements: List[List[Tuple[int, int]]]  # per rect, frame (x, y)
    filled: np.ndarray                # frame with patch areas blurred out


def detect(pixels: np.ndarray) -> Optional[PatchPlan]:
    """Find repeated exact-content glyph patches.  Returns None unless
    enough repeated coverage exists (photographs pass through)."""
    if pixels.ndim != 3 or pixels.shape[2] != 3 \
            or pixels.dtype != np.uint8:
        return None
    h, w = pixels.shape[:2]
    if h < 64 or w < 64:
        return None
    f = pixels.astype(np.float32)
    # two-pass background estimate: the plain box blur smears ink into
    # its surroundings, marking halo pixels as active and merging
    # neighbouring glyphs into one giant component.  Re-estimate the
    # background as the blur over NON-ink pixels only.
    bg0 = _box_blur(f)
    m0 = np.abs(f - bg0).max(axis=2) > 14.0
    wm = (~m0).astype(np.float32)[..., None]
    # r=6 for the masked re-estimate: narrower windows go all-masked
    # between tightly-stacked glyph rows, falling back to the smeared
    # bg0 and merging vertical neighbours into one component (probe:
    # r=4 left 42 two-glyph stacks; r=6 separates all 126 glyphs)
    den = _box_blur(wm, 6)
    bg = np.where(den > 1e-3,
                  _box_blur(f * wm, 6) / np.maximum(den, 1e-3), bg0)
    act0 = (np.abs(f - bg).max(axis=2) > 18.0)
    if not act0.any():
        return None
    bg8_full = np.clip(np.rint(bg), 0, 255).astype(np.uint8)
    # dilate once (3x3) so glyph fragments merge into one component
    act = act0
    for _ in range(1):
        a = act.copy()
        a[1:] |= act[:-1]
        a[:-1] |= act[1:]
        b = a.copy()
        b[:, 1:] |= a[:, :-1]
        b[:, :-1] |= a[:, 1:]
        act = b
    comps = _label(act)
    groups: Dict[bytes, List[Tuple[int, int]]] = {}
    dims: Dict[bytes, Tuple[int, int]] = {}
    for (x0, y0, x1, y1) in comps:
        # tighten to the UNDILATED ink: the dilated bbox includes
        # position-dependent halo, which breaks exact-content matching
        sub = act0[y0:y1, x0:x1]
        rows = np.nonzero(sub.any(axis=1))[0]
        cols = np.nonzero(sub.any(axis=0))[0]
        if not len(rows):
            continue
        y1 = y0 + int(rows[-1]) + 1
        y0 = y0 + int(rows[0])
        x1 = x0 + int(cols[-1]) + 1
        x0 = x0 + int(cols[0])
        # one-pixel margin so antialiased edges travel with the glyph
        y0 = max(0, y0 - 1)
        x0 = max(0, x0 - 1)
        y1 = min(h, y1 + 1)
        x1 = min(w, x1 + 1)
        pw, ph = x1 - x0, y1 - y0
        if pw > MAX_PATCH or ph > MAX_PATCH or pw * ph < MIN_AREA:
            continue
        content = pixels[y0:y1, x0:x1]
        # tolerance matching: quantized keys group glyphs whose pixels
        # differ by <= 3 (antialiasing wobble, near-flat backgrounds);
        # the pasted representative is the GROUP MEAN, so the residual
        # stays within a d>=0.8 quantization step
        # DELTA-keyed grouping: quantized (content - background), so
        # the same glyph matches across slowly-varying backgrounds —
        # the blend is ADD of the shared delta (cjxl's patch streams
        # use the same structure; REPLACE of absolute content broke on
        # textured backgrounds: pasting the mean background over a
        # varying one cost ~10 dB on the text-on-photo probe)
        delta = (content.astype(np.int16)
                 - bg8_full[y0:y1, x0:x1].astype(np.int16))
        key = ((delta + 1024) >> 2).astype(np.int16).tobytes() \
            + bytes([pw & 0xFF, pw >> 8, ph & 0xFF])
        groups.setdefault(key, []).append((x0, y0))
        dims[key] = (pw, ph)
    keep = {k: v for k, v in groups.items() if len(v) >= MIN_REPEATS}
    coverage = sum(len(v) * dims[k][0] * dims[k][1]
                   for k, v in keep.items())
    if coverage < MIN_COVERAGE * h * w:
        return None

    # shelf-pack distinct patches (sorted by height) into the atlas
    items = sorted(keep.items(), key=lambda kv: -dims[kv[0]][1])
    aw = 256
    while aw < max(dims[k][0] for k, _ in items) + 2 * GUTTER:
        aw *= 2
    x = y = shelf_h = 0
    rects, placements, srcs = [], [], []
    for k, places in items:
        pw, ph = dims[k]
        if x + pw + GUTTER > aw:
            x = 0
            y += shelf_h + GUTTER
            shelf_h = 0
        px0, py0 = places[0]
        rects.append((x, y, pw, ph))
        placements.append(sorted(places, key=lambda p: (p[1], p[0])))
        srcs.append((px0, py0))
        x += pw + GUTTER
        shelf_h = max(shelf_h, ph)
    ah = y + shelf_h
    # modular atlas frame: no 8-block padding needed; the atlas holds
    # group-mean XYB DELTAS vs the background estimate (the ADD
    # blend's content) — the gutter stays zero, since adding zero is
    # a no-op.  Values are stored pre-quantized to the atlas frame's
    # DC quant so the main-frame residual below cancels EXACTLY what
    # the decoder will add.
    from ..codec import DEFAULT_DC_QUANT
    atlas_xyb = np.zeros((3, ah, aw), np.float32)
    from .enc_real import srgb8_to_xyb
    Xo, Yo, Bo = srgb8_to_xyb(pixels)
    Xb, Yb, Bb = srgb8_to_xyb(bg8_full)
    dX, dY, dB = Xo - Xb, Yo - Yb, Bo - Bb
    for (ax, ay, pw, ph), places in zip(rects, placements):
        acc = np.zeros((3, ph, pw), np.float64)
        for (sx, sy) in places:
            acc[0] += dX[sy:sy + ph, sx:sx + pw]
            acc[1] += dY[sy:sy + ph, sx:sx + pw]
            acc[2] += dB[sy:sy + ph, sx:sx + pw]
        rep = acc / len(places)
        for c in range(3):
            qq = DEFAULT_DC_QUANT[c]
            rep[c] = np.rint(rep[c] / qq) * qq
        atlas_xyb[:, ay:ay + ph, ax:ax + pw] = rep

    # main-frame input = original MINUS the pasted deltas (in XYB, the
    # space the blend runs in): the VarDCT main frame then CORRECTS
    # the per-occurrence residual instead of discarding it (coding the
    # smooth background estimate alone cost ~9 dB on text-on-photo —
    # cjxl's subtract-patches structure)
    fX, fY, fB = Xo.copy(), Yo.copy(), Bo.copy()
    for (ax, ay, pw, ph), places in zip(rects, placements):
        rep = atlas_xyb[:, ay:ay + ph, ax:ax + pw]
        for (px, py) in places:
            fX[py:py + ph, px:px + pw] -= rep[0]
            fY[py:py + ph, px:px + pw] -= rep[1]
            fB[py:py + ph, px:px + pw] -= rep[2]
    from .dec_real import xyb_planes_to_srgb
    filled = np.clip(np.asarray(xyb_planes_to_srgb(fX, fY, fB)),
                     0.0, 1.0).astype(np.float32)
    return PatchPlan(atlas=atlas_xyb, rects=rects,
                     placements=placements, filled=filled)


def serialize_dictionary(plan: PatchPlan, num_extra: int = 0,
                         ref_slot: int = 1):
    """Wire mirror of PatchDictionary.read: 10-context entropy stream,
    REPLACE blending, positions delta-coded within each rect group."""
    from ..entropy.coder import TokenStream
    from ..bitstream.reader import pack_signed
    from ..bitstream.writer import BitWriter
    ts = TokenStream(NUM_PATCH_CONTEXTS, use_ans=True)
    ts.add(CTX_NUM_REF_PATCH, len(plan.rects))
    for (ax, ay, pw, ph), places in zip(plan.rects, plan.placements):
        ts.add(CTX_REFERENCE_FRAME, ref_slot)
        ts.add(CTX_PATCH_REFERENCE_POSITION, ax)
        ts.add(CTX_PATCH_REFERENCE_POSITION, ay)
        ts.add(CTX_PATCH_SIZE, pw - 1)
        ts.add(CTX_PATCH_SIZE, ph - 1)
        ts.add(CTX_PATCH_COUNT, len(places) - 1)
        px = py = 0
        for i, (x, y) in enumerate(places):
            if i == 0:
                ts.add(CTX_PATCH_POSITION, x)
                ts.add(CTX_PATCH_POSITION, y)
            else:
                ts.add(CTX_PATCH_OFFSET, pack_signed(x - px))
                ts.add(CTX_PATCH_OFFSET, pack_signed(y - py))
            px, py = x, y
            for _j in range(num_extra + 1):
                ts.add(CTX_PATCH_BLEND_MODE, BLEND_ADD)
    bw = BitWriter()
    ts.write(bw)
    return bw
