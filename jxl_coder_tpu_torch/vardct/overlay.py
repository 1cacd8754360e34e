"""The patch and spline overlay of a VarDCT frame, on the device.

The counterpart of the ``overlay`` step of ``fn_post``
(``jxl_coder_tpu/vardct/tpu_full.py:835-840``), which multiplies and adds
dense (3, H, W) planes built on the host (``patches_to_affine``, then
``Splines.render`` cast to f32 into ``add``;
``jxl_coder_tpu/vardct/dec_real.py:1063-1088``).  Here the host lists,
per 64 x 16 tile, the patches and the spline points that meet it
(``Overlay.of``, in the host half), and two kernels of
``csrc/overlay.cu`` change only those tiles' pixels, in place, on the
filtered f32 XYB planes at the true image size:
- ``overlay_patches`` (A8): each patch's source, a rectangle of a
  reference frame's XYB planes already on the device, blended in
  dictionary order as ``patches_to_affine`` reads its mode (ADD and
  ALPHA_ADD add, MUL multiplies, REPLACE and BLEND replace: the decode
  path passes no extra-channel planes, ``dec_real.py:1942``); in
  sequence, where the JAX route composes mul / add first, so the two
  differ by about 1 ulp a blend;
- ``draw_splines`` (A9): the blobs of ``Splines.render`` summed per pixel
  in fp64, in the points' order, then the f32 of the sum added to the
  plane, as the JAX route adds the rendered overlay; A9 runs after A8,
  "patches then splines" as in the host decoder.
Each wrapper counts its launches in ``.launches``; on a CPU tensor it runs
its plain twin, on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .. import _build
from ..host.bitstream.reader import BitstreamError
from ..host.vardct import patches as P

TILE_W, TILE_H = 64, 16
SLOTS = 4
# the blends that add, multiply and replace (patches.py modes)
_ADD = (P.BLEND_ADD, P.BLEND_ALPHA_ADD_ABOVE, P.BLEND_ALPHA_ADD_BELOW)
_REPLACE = (P.BLEND_REPLACE, P.BLEND_BLEND_ABOVE, P.BLEND_BLEND_BELOW)


def tile_lists(x0, x1, y0, y1, h: int, w: int):
    """Per 64 x 16 tile of an (h, w) frame, the items whose inclusive box
    [x0, x1] x [y0, y1] meets it, in item order -> (tiles, offs, items)
    int32: the touched tiles' raster indices, ascending; tile i's items
    are items[offs[i]:offs[i + 1]]."""
    x0, x1, y0, y1 = (np.asarray(a, np.int64) for a in (x0, x1, y0, y1))
    tiles_x = -(-w // TILE_W)
    tx0, tx1 = x0 // TILE_W, x1 // TILE_W
    ty0, ty1 = y0 // TILE_H, y1 // TILE_H
    nx, ny = tx1 - tx0 + 1, ty1 - ty0 + 1
    per = nx * ny
    n = int(per.sum())
    item = np.repeat(np.arange(len(x0), dtype=np.int64), per)
    k = np.arange(n, dtype=np.int64) - np.repeat(np.cumsum(per) - per, per)
    tile = ((ty0[item] + k // nx[item]) * tiles_x + tx0[item]
            + k % nx[item])
    order = np.argsort(tile, kind="stable")
    tile, item = tile[order], item[order]
    tiles, starts = np.unique(tile, return_index=True)
    offs = np.append(starts, n)
    return (tiles.astype(np.int32), offs.astype(np.int32),
            item.astype(np.int32))


def longest_first(tiles, offs, items):
    """tile_lists' lists with the longest first (ties in tile order):
    A9's thread blocks take the tiles with the most points first, so that
    none of them starts last."""
    n = np.diff(offs)
    order = np.argsort(-n, kind="stable")
    new_offs = np.append(0, np.cumsum(n[order])).astype(np.int32)
    idx = np.repeat(offs[order], n[order]) + np.arange(
        int(new_offs[-1])) - np.repeat(new_offs[:-1], n[order])
    return tiles[order], new_offs, items[idx]


@dataclasses.dataclass(frozen=True)
class Overlay:
    """A frame's overlay, built by the host half (numpy): its patches as
    (P, 8) int32 rows (x, y, w, h, slot, x0, y0, mode | clamp << 8) in
    dictionary order (drawn: those whose mode is not NONE), and its spline
    points as Splines.points gives them, each with its tile lists (the
    points' longest first)."""
    patches: Optional[np.ndarray] = None
    drawn: Optional[np.ndarray] = None
    patch_tiles: Optional[tuple] = None
    points: Optional[np.ndarray] = None
    boxes: Optional[np.ndarray] = None
    point_tiles: Optional[tuple] = None

    @staticmethod
    def of(lf, h: int, w: int) -> Optional["Overlay"]:
        """The overlay of a frame with LfGlobal lf at the true size
        (h, w), or None when it has no patches and no splines."""
        if lf.patches is None and lf.splines is None:
            return None
        kw = {}
        if lf.patches is not None:
            pd = lf.patches
            rows = []
            for p in pd.patches:
                r = pd.rects[p.rect_idx]
                mode, _alpha, clamp = p.blendings[0]
                rows.append((p.x, p.y, r.xsize, r.ysize, r.ref, r.x0, r.y0,
                             mode | int(clamp) << 8))
            pt = np.asarray(rows, np.int32).reshape(-1, 8)
            kw["patches"] = pt
            drawn = kw["drawn"] = pt[(pt[:, 7] & 0xff) != P.BLEND_NONE]
            kw["patch_tiles"] = tile_lists(
                drawn[:, 0], drawn[:, 0] + drawn[:, 2] - 1, drawn[:, 1],
                drawn[:, 1] + drawn[:, 3] - 1, h, w)
        if lf.splines is not None:
            cf = 1.0 / lf.cfl_color_factor
            pts, boxes = lf.splines.points(
                h, w, base_cx=lf.cfl_base_x + lf.cfl_ytox_dc * cf,
                base_cb=lf.cfl_base_b + lf.cfl_ytob_dc * cf)
            kw["points"] = pts
            kw["boxes"] = boxes.astype(np.int32)
            kw["point_tiles"] = longest_first(*tile_lists(
                boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3], h, w))
        return Overlay(**kw)

    def check_sources(self, ref_sizes: Dict[int, Tuple[int, int]]) -> None:
        """Raise BitstreamError unless every patch's source lies inside a
        reference frame decoded before the frame (ref_sizes: slot ->
        (h, w) of its planes)."""
        if self.patches is None:
            return
        for x, y, pw, ph, slot, x0, y0, _mode in self.patches.tolist():
            size = ref_sizes.get(slot)
            if size is None:
                raise BitstreamError(
                    f"patch references missing frame slot {slot}")
            if x0 + pw > size[1] or y0 + ph > size[0]:
                raise BitstreamError(
                    f"patch source {pw}x{ph} at ({x0}, {y0}) outside the "
                    f"{size[1]}x{size[0]} reference frame of slot {slot}")

    def to(self, device, put=None) -> "OverlayInputs":
        """The lists on `device` (put(array) -> tensor, as in
        inputs.from_prepared)."""
        def t(a):
            a = np.ascontiguousarray(a)
            return put(a) if put is not None else \
                torch.from_numpy(a).to(device)
        ov = OverlayInputs()
        if self.patches is not None:
            ov.patches = t(self.drawn)
            ov.patch_tiles = tuple(t(a) for a in self.patch_tiles)
        if self.points is not None:
            ov.points = t(self.points)
            ov.boxes = t(self.boxes)
            ov.point_tiles = tuple(t(a) for a in self.point_tiles)
        return ov


@dataclasses.dataclass
class OverlayInputs:
    """An Overlay's lists on the device: the drawn patches (mode not
    NONE) and the spline points, each with its tile lists."""
    patches: Optional[torch.Tensor] = None
    patch_tiles: Optional[tuple] = None
    points: Optional[torch.Tensor] = None
    boxes: Optional[torch.Tensor] = None
    point_tiles: Optional[tuple] = None


def apply(xyb: torch.Tensor, ov: OverlayInputs,
          refs: Optional[Dict[int, torch.Tensor]]) -> torch.Tensor:
    """The overlay on (3, h, w) f32 XYB planes, in place: the patches
    (A8), then the splines (A9).  refs: slot -> (3, rh, rw) f32 planes of
    the reference frames.  Returns xyb."""
    if ov.patches is not None:
        if refs is None:
            raise BitstreamError(
                "frame uses patches but no reference frames were decoded")
        overlay_patches(xyb, refs, ov.patches, *ov.patch_tiles)
    if ov.points is not None:
        draw_splines(xyb, ov.points, ov.boxes, *ov.point_tiles)
    return xyb


# --------------------------------------------------------------------------
# The kernels' bindings

_c = ctypes


@functools.lru_cache(maxsize=None)
def _kernels():
    lib = _build.load("overlay")
    p, i, ll = _c.c_void_p, _c.c_int, _c.c_longlong
    return (_build.bind(lib, "jxl_overlay_patches",
                        [p, ll, i, i, p, p, p, p, p, p, i, i]),
            _build.bind(lib, "jxl_draw_splines",
                        [p, ll, i, i, p, p, p, p, p, i, i]))


def _check_planes(xyb: torch.Tensor) -> None:
    if xyb.dtype != torch.float32 or xyb.dim() != 3 or xyb.shape[0] != 3:
        raise ValueError(f"xyb: expected (3, H, W) float32 planes, got "
                         f"{tuple(xyb.shape)} {xyb.dtype}")


def _check_lists(xyb, named) -> None:
    for name, t, dtype in named:
        if t.dtype != dtype or t.device != xyb.device or \
                not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous {dtype} tensor "
                             f"on the planes' device")


# --------------------------------------------------------------------------
# A8: patches

def overlay_patches_plain(xyb: torch.Tensor, refs: Dict[int, torch.Tensor],
                          patches: torch.Tensor) -> torch.Tensor:
    """The twin of overlay_patches: the patches blended in order, one
    rectangle at a time (each pixel sees them in the kernel's order)."""
    for x, y, pw, ph, slot, x0, y0, mc in patches.tolist():
        mode, clamp = mc & 0xff, mc >> 8
        dst = xyb[:, y:y + ph, x:x + pw]
        src = refs[slot][:, y0:y0 + ph, x0:x0 + pw]
        if mode in _ADD:
            dst.add_(src)
        elif mode == P.BLEND_MUL:
            dst.mul_(src.clamp(0.0, 1.0) if clamp else src)
        elif mode in _REPLACE:
            dst.copy_(src)
    return xyb


def overlay_patches(xyb: torch.Tensor, refs: Dict[int, torch.Tensor],
                    patches: torch.Tensor, tiles: torch.Tensor,
                    offs: torch.Tensor, items: torch.Tensor
                    ) -> torch.Tensor:
    """The patches blended in place into contiguous (3, h, w) f32 XYB
    planes: refs slot -> (3, rh, rw) f32 reference planes, patches (P, 8)
    int32 rows (x, y, w, h, slot, x0, y0, mode | clamp << 8) whose
    sources lie inside their references (Overlay.check_sources), and
    their tile lists (tile_lists).  Returns xyb."""
    _check_planes(xyb)
    if patches.dim() != 2 or patches.shape[1] != 8:
        raise ValueError("patches: expected (P, 8) int32 rows")
    if xyb.device.type == "cpu":
        return overlay_patches_plain(xyb, refs, patches)
    if not xyb.is_contiguous():
        raise ValueError("overlay_patches works in place on contiguous "
                         "planes")
    _check_lists(xyb, (("patches", patches, torch.int32),
                       ("tiles", tiles, torch.int32),
                       ("offs", offs, torch.int32),
                       ("items", items, torch.int32)))
    ptrs = np.zeros(SLOTS, np.uint64)
    dims = np.zeros(2 * SLOTS, np.int32)
    for slot, r in refs.items():
        if r.dtype != torch.float32 or r.dim() != 3 or r.shape[0] != 3 or \
                r.device != xyb.device or not r.is_contiguous():
            raise ValueError(f"refs[{slot}]: expected contiguous (3, h, w) "
                             f"float32 planes on the planes' device")
        ptrs[slot] = r.data_ptr()
        dims[slot], dims[SLOTS + slot] = r.shape[1], r.shape[2]
    _, h, w = xyb.shape
    if tiles.numel():
        # the slot table is a host array, copied into the launch parameters
        _build.launch(_kernels()[0], xyb.device, xyb.data_ptr(), h * w, h, w,
                      ptrs.ctypes.data, dims.ctypes.data, patches.data_ptr(),
                      tiles.data_ptr(), offs.data_ptr(), items.data_ptr(),
                      tiles.numel(), -(-w // TILE_W))
        overlay_patches.launches += 1
    return xyb


overlay_patches.launches = 0


# --------------------------------------------------------------------------
# A9: splines

def _erf(x: torch.Tensor) -> torch.Tensor:
    """splines._erf in torch (Abramowitz-Stegun 7.1.26)."""
    ax = x.abs()
    tt = 1.0 / (1.0 + 0.3275911 * ax)
    y = 1.0 - (((((1.061405429 * tt - 1.453152027) * tt) + 1.421413741)
                * tt - 0.284496736) * tt + 0.254829592) * tt \
        * torch.exp(-ax * ax)
    return torch.sign(x) * y


def spline_sums_plain(points: torch.Tensor, boxes: torch.Tensor, h: int,
                      w: int, chunk: int = 4096
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fp64 sums draw_splines adds: ((3, h, w) float64, (h, w) bool,
    the pixels some blob covers), the points' blobs added in order
    (splines.draw_points onto zero planes).  Each point's erf differences
    and blob are computed for all points at once (elementwise, the same
    operations), `chunk` blobs at a time; the sums run point by point."""
    dev = points.device
    acc = torch.zeros((3, h, w), dtype=torch.float64, device=dev)
    touched = torch.zeros((h, w), dtype=torch.bool, device=dev)
    if not points.shape[0]:
        return acc, touched
    bx0, bx1, by0, by1 = boxes.to(torch.int64).unbind(1)
    cx, cy, s, inten = (points[:, k] for k in range(4))
    inv = (1.0 / (s * math.sqrt(2.0)))[:, None]

    def erf_diffs(lo, hi, c):
        i = lo[:, None].to(torch.float64) + torch.arange(
            int((hi - lo).max()) + 1, dtype=torch.float64, device=dev)
        return _erf((i + 0.5 - c[:, None]) * inv) - \
            _erf((i - 0.5 - c[:, None]) * inv)

    ex, ey = erf_diffs(bx0, bx1, cx), erf_diffs(by0, by1, cy)
    scale = 0.25 * s * inten
    cols = points[:, 4:7, None, None]
    box_list = boxes.tolist()
    for start in range(0, len(box_list), chunk):
        blobs = scale[start:start + chunk, None, None] * (
            ey[start:start + chunk, :, None] * ex[start:start + chunk, None])
        for j, (x0, x1, y0, y1) in enumerate(box_list[start:start + chunk]):
            acc[:, y0:y1 + 1, x0:x1 + 1] += cols[start + j] * \
                blobs[j, :y1 - y0 + 1, :x1 - x0 + 1]
            touched[y0:y1 + 1, x0:x1 + 1] = True
    return acc, touched


def draw_splines_plain(xyb: torch.Tensor, points: torch.Tensor,
                       boxes: torch.Tensor) -> torch.Tensor:
    """The twin of draw_splines."""
    _, h, w = xyb.shape
    acc, touched = spline_sums_plain(points, boxes, h, w)
    xyb.copy_(torch.where(touched, xyb + acc.to(torch.float32), xyb))
    return xyb


def draw_splines(xyb: torch.Tensor, points: torch.Tensor,
                 boxes: torch.Tensor, tiles: torch.Tensor,
                 offs: torch.Tensor, items: torch.Tensor) -> torch.Tensor:
    """The spline blobs added in place to contiguous (3, h, w) f32 XYB
    planes: points (M, 7) float64 and boxes (M, 4) int32 as
    Splines.points gives them for (h, w), and their tile lists.  Returns
    xyb."""
    _check_planes(xyb)
    if points.dim() != 2 or points.shape[1] != 7 or \
            boxes.shape != (points.shape[0], 4):
        raise ValueError("points: expected (M, 7) rows, boxes (M, 4)")
    if xyb.device.type == "cpu":
        return draw_splines_plain(xyb, points, boxes)
    if not xyb.is_contiguous():
        raise ValueError("draw_splines works in place on contiguous planes")
    _check_lists(xyb, (("points", points, torch.float64),
                       ("boxes", boxes, torch.int32),
                       ("tiles", tiles, torch.int32),
                       ("offs", offs, torch.int32),
                       ("items", items, torch.int32)))
    _build.check_aligned(boxes, "boxes")
    _, h, w = xyb.shape
    if tiles.numel():
        _build.launch(_kernels()[1], xyb.device, xyb.data_ptr(), h * w, h, w,
                      points.data_ptr(), boxes.data_ptr(), tiles.data_ptr(),
                      offs.data_ptr(), items.data_ptr(), tiles.numel(),
                      -(-w // TILE_W))
        draw_splines.launches += 1
    return xyb


draw_splines.launches = 0
