"""Fused restoration filters: TPU kernels 3-6 of
``jxl_coder_tpu/vardct/filters_pallas.py``, kernels 5 and 6 as
``csrc/fused_filters.cu``, kernels 3 and 4 as instantiations of kernel
2's tile pass in ``csrc/filters.cu``.

Entry points keep the JAX names and arguments (less ``tile``):

- ``fused_gab_epf(stacked)`` (#5) and ``fused_filters2(img_padded,
  inv_padded, to_srgb)`` (#6): the round-1 codec's gaborish + one
  plus-shaped EPF pass (+ sRGB8) on planes row-padded by ``PAD``, with
  a per-pixel inverse sigma map.  ``legacy_filters`` is the same tile
  pass on unpadded planes, the route of the round-1 pipeline
  (``pipeline.reconstruct_*``): gaborish and EPF each switchable, the
  inverse sigma made in the kernel from the per-block quant field, and
  f32, sRGB8 or sRGB16 out.  It counts toward #6 with u8 out, else #5.
  ``legacy_filters_batch`` is one launch of it over N frames of one size
  (a frame axis on the grid), the round-1 branch of
  ``animation.decode_frames_batch``; it counts its own launches.
- ``fused_real_filters(img_padded, inv_blocks, ...)`` (#3): the
  real-format gaborish + EPF1 (+ EPF2) (+ sRGB) chain with Mirror
  borders, and ``fused_real_gab_epf1(img_padded, inv_blocks, to_srgb)``
  (#4): gaborish + EPF1 with edge-replicated borders.  Both read the
  caller's pad rows as data.

On a CPU tensor each runs its ``*_plain`` twin; on a CUDA tensor it
launches its kernel and never the twin.  The kernels take any H x W;
the TPU's width and tile gates do not apply.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import _build
from ..host.vardct.dec_real import EPF_CHANNEL_SCALE as REAL_CS
from . import color, pipeline as P, xyb as X
from .filters import BORDER_MUL, _border, _mirror_index, kernel_consts

PAD = 4      # row padding of the JAX functions' padded planes
DEFAULT_GW1, DEFAULT_GW2 = 0.115169525, 0.061248592
OUTS = {"f32": torch.float32, "u8": torch.uint8, "u16": torch.uint16}
# legacy_kernel's EPF kinds: none, a per-pixel map, the per-block field
_EPF_NONE, _EPF_PIXEL, _EPF_BLOCK = 0, 1, 2

_c = ctypes


_P, _I = _c.c_void_p, _c.c_int


@functools.lru_cache(maxsize=None)
def _legacy_kernel():
    _L = _c.c_longlong
    return _build.bind(_build.load("fused_filters"), "jxl_legacy_filters",
                       [_P, _L, _I, _I, _I, _I, _P, _I, _I, _I, _P, _I, _I,
                        _I, _P, _P, _P, _P, _I, _I, _L, _L, _L])


@functools.lru_cache(maxsize=None)
def _padded_kernel():
    return _build.bind(_build.load("filters"), "jxl_restore_padded",
                       [_P, _c.c_longlong, _I, _I, _I, _I, _P, _I, _P, _I,
                        _I, _I, _P, _P, _P])


def inv_den(distance: float) -> np.float32:
    """float32(distance) * 4, the divisor of pipeline.inv_sigma_map (exact
    in float32): the kernel's inverse sigma is float32(qf) / inv_den."""
    return np.float32(distance) * np.float32(4.0)


# The sRGB codes of linear values v in [0, 1], as legacy_kernel reads them
# in place of the twin's arithmetic (pipeline.linear_to_codes: v * 12.92
# up to LINEAR_END, glibc's powf above it): tables built from the twin's
# own codes, by buckets of 2^16 float32 bit patterns (bucket = the top 16
# bits of v less CODE_LO, 0 for smaller v, whose codes are all 0).
# test_torch_fused_filters checks them on every float in [0, 1].
LINEAR_END = np.float32(0.0031308)
_HI = int(np.float32(1.0).view(np.uint32))
# a bucket's worth below the first value whose sRGB16 code is 1
CODE_LO = int(np.float32(0.25 / (12.92 * 65535)).view(np.uint32)) >> 16


def _bits_to_float(u: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.asarray(u).astype(np.uint32).view(np.float32))


def _twin_codes(bits: np.ndarray, scale: int) -> np.ndarray:
    return P.linear_to_codes(_bits_to_float(bits), scale).numpy().astype(
        np.int64)


def _buckets():
    """Each bucket's first bit pattern and its last one up to 1.0."""
    first = np.arange(CODE_LO, (_HI >> 16) + 1, dtype=np.int64) << 16
    return first, np.minimum(first + 0xffff, _HI)


@functools.lru_cache(maxsize=None)
def u8_code_table() -> np.ndarray:
    """The sRGB8 codes, per bucket: (the code at the bucket's first
    value, the least value, as float bits, with the next code; +inf bits
    where the code does not move).  The code is monotone in v and moves
    by at most one within a bucket (checked here), so code(v) = base +
    (v >= step)."""
    start, end = _buckets()
    base, last = _twin_codes(start, 255), _twin_codes(end, 255)
    if not ((last >= base) & (last <= base + 1)).all():
        raise AssertionError("an sRGB8 code bucket spans more than one step")
    a, b = start.copy(), end.copy()      # code(a) == base < code(b)
    for _ in range(16):
        mid = (a + b) // 2
        up = _twin_codes(mid, 255) > base
        a, b = np.where(up, a, mid), np.where(up, mid, b)
    step = np.where(last > base, b, 0x7f800000)
    return np.stack([base, step], 1).astype(np.int32)


@functools.lru_cache(maxsize=None)
def u16_code_tables() -> tuple[np.ndarray, np.ndarray]:
    """The sRGB16 codes.  poly, per bucket: (c0, c1, c2, 0) float32, a
    least-squares quadratic in d = v - v0 (v0 the bucket's first float)
    of the twin's unrounded code, 65535 * linear_to_srgb(v).  In float32,
    t = c0 + (c2 d + c1) d lies within 2^-7 of the twin's code before
    rounding, so where t is more than 0.5 - 1/64 from its nearest integer,
    that integer is the code (legacy_kernel's legacy_code).  thresholds
    (65537,) float32: the least v whose code is k or more (+inf past the
    last code), so nearer a half the code is floor(t) + (v >=
    thresholds[floor(t) + 1])."""
    first, end = _buckets()
    y, a, b = (float(np.float32(c)) for c in (1 / 2.4, 1.055, 0.055))
    v0, hi, nxt = (_bits_to_float(u).double().numpy()
                   for u in (first, end, first + 0x10000))
    nodes = 0.5 - 0.5 * np.cos(np.pi * (np.arange(16) + 0.5) / 16)
    x = v0[:, None] + (hi - v0)[:, None] * nodes            # Chebyshev
    w = (nxt - v0)[:, None]
    s = (x - v0[:, None]) / w
    end_lin = float(LINEAR_END)
    g = 65535.0 * np.where(x <= end_lin, 12.92 * x, a * x ** y - b)
    fit = np.linalg.pinv(np.stack([np.ones_like(s), s, s * s], -1)) @ g[
        ..., None]
    c = fit[..., 0] / np.concatenate([np.ones_like(w), w, w * w], 1)
    poly = np.concatenate([c, np.zeros_like(w)], 1).astype(np.float32)

    k = np.arange(1, _twin_codes(np.array([_HI]), 65535)[0] + 1)
    lo_b = np.full(k.shape, CODE_LO << 16)
    hi_b = np.full(k.shape, _HI)
    while (hi_b - lo_b > 1).any():       # code(lo_b) < k <= code(hi_b)
        mid = (lo_b + hi_b) // 2
        up = _twin_codes(mid, 65535) >= k
        lo_b, hi_b = np.where(up, lo_b, mid), np.where(up, mid, hi_b)
    thr = np.full(65537, np.inf, np.float32)
    thr[0] = 0.0
    thr[k] = _bits_to_float(hi_b).numpy()
    return poly, thr


@functools.lru_cache(maxsize=None)
def _code_tables(device: torch.device) -> tuple[torch.Tensor, ...]:
    return tuple(torch.from_numpy(t).to(device)
                 for t in (u8_code_table(),) + u16_code_tables())


@functools.lru_cache(maxsize=64)
def _legacy_consts(den: float) -> np.ndarray:
    return np.concatenate([
        P.gaborish_kernel().reshape(9), P.EPF_CHANNEL_SCALE,
        X.INV_OPSIN.reshape(9),
        [X.CBRT_BIAS, X.OPSIN_BIAS, den]]
    ).astype(np.float32)


def _real_taps(gw1: float, gw2: float) -> np.ndarray:
    """filters_pallas._chain_math's normalised 3x3 gaborish taps."""
    norm = 1.0 + 4.0 * (gw1 + gw2)
    return np.array([[gw2, gw1, gw2], [gw1, 1.0, gw1], [gw2, gw1, gw2]],
                    np.float32) / norm


def _rows(img: torch.Tensor, pad: int, name: str) -> int:
    if img.dtype != torch.float32 or img.dim() != 3 or img.shape[0] != 3:
        raise ValueError(f"{name}: expected (3, H + 2*{pad}, W) float32")
    if img.shape[1] <= 2 * pad or img.shape[2] == 0:
        raise ValueError(f"{name}: {tuple(img.shape)} holds no image rows")
    return img.shape[1] - 2 * pad


def _row0(t: torch.Tensor, pad: int) -> int:
    """Address of row `pad` (the image's row 0) of a plane tensor."""
    return t.data_ptr() + pad * t.stride(-2) * t.element_size()


def _padded_rows(t: torch.Tensor, pad: int, halo: int) -> torch.Tensor:
    """Rows -halo .. H+halo-1 of planes padded by `pad` rows, the rows
    past the padding clamped (edge replication)."""
    h = t.shape[-2] - 2 * pad
    idx = (torch.arange(-halo, h + halo, device=t.device) + pad).clamp(
        0, t.shape[-2] - 1)
    return t[..., idx, :]


# ---------------------------------------------------------------------------
# Kernels 5 and 6: the round-1 codec's filters

def _legacy_plain(img, inv, pad, gab, epf, out):
    """pipeline.apply_filters on the slab of filter_halo() rows around
    the image (+ pipeline.xyb_to_srgb8 / xyb_to_u16): the jnp chain the
    TPU kernels reproduce.  inv: the per-pixel map, padded as img is."""
    halo = P.filter_halo(int(epf), gab)
    slab = _padded_rows(img, pad, halo)
    inv_slab = _padded_rows(inv, pad, halo) if epf else None
    xyb = P.apply_filters(slab, inv_slab, int(epf), gab)
    if out == "u8":
        return P.xyb_to_srgb8(xyb)
    return P.xyb_to_u16(xyb) if out == "u16" else xyb


def _check_out(out: str) -> None:
    if out not in OUTS:
        raise ValueError(f"out must be one of {tuple(OUTS)}")


def _legacy_launch(img, pad, gab, epf, out, inv=None, qf_row=0,
                   den=np.float32(0.0)):
    """One legacy_kernel launch.  epf: _EPF_NONE, _EPF_PIXEL (inv the
    float map, padded as img is) or _EPF_BLOCK (inv the int32 quant
    field, den its divisor, qf_row its row offset)."""
    _check_out(out)
    H = _rows(img, pad, "legacy filters")
    W = img.shape[2]
    if img.stride(2) != 1:
        img = img.contiguous()
    inv_ptr, inv_stride, inv_rows = None, 0, 0
    if epf != _EPF_NONE:
        if epf == _EPF_PIXEL:
            dtype, need = torch.float32, (H + 2 * pad, W)
        else:
            dtype, need = torch.int32, (1, -(-W // 8))
        if inv is None or inv.dtype != dtype or inv.device != img.device \
                or inv.dim() != 2 or inv.shape[0] < need[0] \
                or inv.shape[1] < need[1]:
            raise ValueError(f"inv must be {dtype} on {img.device} with at "
                             f"least {need} rows and columns")
        if inv.stride(1) != 1:
            inv = inv.contiguous()
        inv_stride, inv_rows = inv.stride(0), inv.shape[0]
        inv_ptr = _row0(inv, pad) if epf == _EPF_PIXEL else inv.data_ptr()
    res = torch.empty((3, H, W), device=img.device, dtype=OUTS[out])
    tables = [t.data_ptr() for t in _code_tables(img.device)] \
        if out != "f32" else [None] * 3
    _build.launch(_legacy_kernel(), img.device, _row0(img, pad),
                  img.stride(0), img.stride(1), pad, H, W, inv_ptr,
                  inv_stride, inv_rows, qf_row, res.data_ptr(), int(gab), epf,
                  tuple(OUTS).index(out),
                  _legacy_consts(float(den)).ctypes.data, *tables, CODE_LO,
                  1, 0, 0, 0)
    return res


def fused_gab_epf_plain(stacked: torch.Tensor) -> torch.Tensor:
    return _legacy_plain(stacked[:3], stacked[3], PAD, True, True, "f32")


def fused_gab_epf(stacked: torch.Tensor) -> torch.Tensor:
    """stacked: (4, H + 2*PAD, W) float32 = [xyb(3); inv_sigma(1)], rows
    padded by PAD.  -> (3, H, W) gaborish + one EPF pass."""
    if stacked.device.type == "cpu":
        return fused_gab_epf_plain(stacked)
    out = _legacy_launch(stacked[:3], PAD, True, _EPF_PIXEL, "f32",
                         stacked[3])
    fused_gab_epf.launches += 1
    return out


def fused_filters2_plain(img_padded, inv_padded, to_srgb=False):
    return _legacy_plain(img_padded, inv_padded, PAD, True, True,
                         "u8" if to_srgb else "f32")


def fused_filters2(img_padded: torch.Tensor, inv_padded: torch.Tensor,
                   to_srgb: bool = False) -> torch.Tensor:
    """img_padded: (3, H + 2*PAD, W); inv_padded: (H + 2*PAD, W).  ->
    (3, H, W) float32, or uint8 sRGB with to_srgb."""
    if img_padded.device.type == "cpu":
        return fused_filters2_plain(img_padded, inv_padded, to_srgb)
    out = _legacy_launch(img_padded, PAD, True, _EPF_PIXEL,
                         "u8" if to_srgb else "f32", inv_padded)
    fused_filters2.launches += 1
    return out


def block_inv(qf: torch.Tensor, distance: float, H: int, W: int,
              qf_row: int = 0) -> torch.Tensor:
    """The (H, W) inverse sigma legacy_filters reads: pixel (y, x) takes
    pipeline.inv_sigma_map's value of block ((y + qf_row) >> 3, x >> 3),
    the block row clamped to the quant field."""
    rows = ((torch.arange(H, device=qf.device) + qf_row) >> 3).clamp(
        0, qf.shape[0] - 1)
    cols = torch.arange(W, device=qf.device) >> 3
    return P.inv_sigma_blocks(qf, distance)[rows][:, cols]


def legacy_filters_plain(img, qf, distance, gab, epf, out="u8", qf_row=0):
    inv = block_inv(qf, distance, *img.shape[1:], qf_row) if epf else None
    return _legacy_plain(img, inv, 0, gab, epf, out)


def legacy_filters(img: torch.Tensor, qf, distance: float, gab: bool,
                   epf: bool, out: str = "u8", qf_row: int = 0
                   ) -> torch.Tensor:
    """Kernels 5 / 6 on unpadded (3, H, W) planes (a cropped view is
    fine) with edge-replicated borders.  qf: the (nY, nX) int32 quant
    field (unused without epf): the EPF's inverse sigma is
    pipeline.inv_sigma_map's qf / (distance * 4), divided in the kernel
    per 8x8 block; qf_row: the field's pixel row of the planes' row 0
    (-halo for planes padded by halo rows; rows clamp to the field).  ->
    (3, H, W) float32 ("f32"), or uint8 / uint16 sRGB ("u8" / "u16")."""
    if img.device.type == "cpu":
        return legacy_filters_plain(img, qf, distance, gab, epf, out, qf_row)
    res = _legacy_launch(img, 0, gab, _EPF_BLOCK if epf else _EPF_NONE, out,
                         qf if epf else None, qf_row, inv_den(distance))
    if out == "u8":
        fused_filters2.launches += 1
    else:
        fused_gab_epf.launches += 1
    return res


def legacy_filters_batch_plain(imgs, qfs, distance, gab, epf):
    return torch.stack([legacy_filters_plain(img, qf, distance, gab, epf, "u8")
                        for img, qf in zip(imgs, qfs)])


def legacy_filters_batch(imgs: torch.Tensor, qfs: torch.Tensor,
                         distance: float, gab: bool, epf: bool
                         ) -> torch.Tensor:
    """legacy_filters(..., "u8") over N frames of one size in one launch
    (kernel 6 with a frame axis): imgs (N, 3, H, W) float32, qfs (N, nY,
    nX) int32, every frame filtered with the one distance.  -> (N, 3, H,
    W) uint8 sRGB codes, each frame equal to legacy_filters of it alone."""
    if imgs.dim() != 4 or qfs.dim() != 3 or imgs.shape[0] != qfs.shape[0]:
        raise ValueError(f"imgs (N, 3, H, W) and qfs (N, nY, nX): got "
                         f"{tuple(imgs.shape)} and {tuple(qfs.shape)}")
    if imgs.device.type == "cpu":
        return legacy_filters_batch_plain(imgs, qfs, distance, gab, epf)
    n, _, H, W = imgs.shape
    _rows(imgs[0], 0, "legacy filters")
    if n == 0:
        return torch.empty((0, 3, H, W), device=imgs.device,
                           dtype=torch.uint8)
    imgs = imgs.contiguous()
    inv_ptr, inv_stride, inv_rows, inv_frame = None, 0, 0, 0
    if epf:
        if (qfs.dtype != torch.int32 or qfs.device != imgs.device
                or qfs.shape[2] < -(-W // 8)):
            raise ValueError(f"qfs must be int32 on {imgs.device} with at "
                             f"least {-(-W // 8)} columns")
        qfs = qfs.contiguous()
        inv_ptr, inv_stride, inv_rows = (qfs.data_ptr(), qfs.shape[2],
                                         qfs.shape[1])
        inv_frame = qfs.stride(0) * qfs.element_size()
    res = torch.empty((n, 3, H, W), device=imgs.device, dtype=torch.uint8)
    tables = [t.data_ptr() for t in _code_tables(imgs.device)]
    _build.launch(_legacy_kernel(), imgs.device, imgs.data_ptr(),
                  imgs.stride(1), imgs.stride(2), 0, H, W, inv_ptr,
                  inv_stride, inv_rows, 0, res.data_ptr(), int(gab),
                  _EPF_BLOCK if epf else _EPF_NONE, tuple(OUTS).index("u8"),
                  _legacy_consts(float(inv_den(distance))).ctypes.data,
                  *tables, CODE_LO, n, imgs.stride(0), inv_frame,
                  res.stride(0))
    legacy_filters_batch.launches += 1
    return res


# ---------------------------------------------------------------------------
# Kernels 3 and 4: the real-format chain

def _real_plain(img, inv_blocks, mirror, epf2, k, pass2_scale, out_kind):
    """filters_pallas._chain_math / _kernel_real over the whole image:
    the same sums in the same order."""
    H, W = _rows(img, PAD, "real filters"), img.shape[2]
    dev = img.device
    xp = _padded_rows(img, PAD, 1)[:, :, torch.arange(
        -1, W + 1, device=dev).clamp(0, W - 1)]
    g = torch.zeros((3, H, W), dtype=torch.float32, device=dev)
    for dy in range(3):
        for dx in range(3):
            g = g + float(k[dy, dx]) * xp[:, dy:dy + H, dx:dx + W]
    if mirror:
        iy, ix = _mirror_index(H, 2, dev), _mirror_index(W, 2, dev)
    else:
        iy = torch.arange(-2, H + 2, device=dev).clamp(0, H - 1)
        ix = torch.arange(-2, W + 2, device=dev).clamp(0, W - 1)
    ge = g[:, iy][:, :, ix]                     # rows / cols -2 .. n+1
    cs = [float(np.float32(s)) for s in REAL_CS]
    Dh = torch.zeros((H + 4, W + 3), dtype=torch.float32, device=dev)
    Dv = torch.zeros((H + 3, W + 4), dtype=torch.float32, device=dev)
    for c in range(3):
        Dh = Dh + cs[c] * (ge[c, :, :-1] - ge[c, :, 1:]).abs()
        Dv = Dv + cs[c] * (ge[c, :-1, :] - ge[c, 1:, :]).abs()

    def cross_sum(D, oy, ox):
        acc = torch.zeros((H, W), dtype=torch.float32, device=dev)
        for ty, tx in ((0, 0), (0, 1), (0, -1), (1, 0), (-1, 0)):
            acc = acc + D[2 + oy + ty:2 + oy + ty + H,
                          2 + ox + tx:2 + ox + tx + W]
        return acc

    def at(t, dy, dx):
        return t[:, 1 + dy:1 + dy + H, 1 + dx:1 + dx + W]

    inv_px = inv_blocks.repeat_interleave(8, 0).repeat_interleave(8, 1)[
        :H, :W]
    act = inv_px < 0
    invb = torch.where(_border(H, W, dev), inv_px * float(BORDER_MUL),
                       inv_px)
    gc = ge[:, 1:-1, 1:-1]                      # rows / cols -1 .. n
    num = [at(gc, 0, 0)[c] for c in range(3)]
    den = torch.ones((H, W), dtype=torch.float32, device=dev)
    for (dy, dx), sad in (((0, 1), cross_sum(Dh, 0, 0)),
                          ((0, -1), cross_sum(Dh, 0, -1)),
                          ((1, 0), cross_sum(Dv, 0, 0)),
                          ((-1, 0), cross_sum(Dv, -1, 0))):
        w = torch.clamp_min(1.0 + sad * invb, 0.0)
        den = den + w
        num = [num[c] + w * at(gc, dy, dx)[c] for c in range(3)]
    inv_den = 1.0 / den
    out = torch.stack([torch.where(act, num[c] * inv_den, at(gc, 0, 0)[c])
                       for c in range(3)])
    if epf2:
        o1p = P._edge_pad(out, 1, 1)
        inv2 = invb * float(np.float32(pass2_scale))
        num = [out[c] for c in range(3)]
        den = torch.ones((H, W), dtype=torch.float32, device=dev)
        for dy, dx in ((0, 1), (0, -1), (1, 0), (-1, 0)):
            nb = at(o1p, dy, dx)
            sad = torch.zeros((H, W), dtype=torch.float32, device=dev)
            for c in range(3):
                sad = sad + cs[c] * (out[c] - nb[c]).abs()
            w = torch.clamp_min(1.0 + sad * inv2, 0.0)
            den = den + w
            num = [num[c] + w * nb[c] for c in range(3)]
        inv_den = 1.0 / den
        out = torch.stack([torch.where(act, num[c] * inv_den, out[c])
                           for c in range(3)])
    if out_kind == 0:
        return out
    return color.xyb_to_srgb_plain(out, out_kind == 2).permute(2, 0, 1)


@functools.lru_cache(maxsize=64)
def _padded_consts(gw1: float, gw2: float, pass2_scale: float) -> np.ndarray:
    """jxl_restore_padded's constants: kernel 2's gaborish weights (the
    pair in all three channels), channel scales and border multiplier,
    then pass2_scale."""
    head = kernel_consts((gw1, gw2) * 3, 1.0, 1.0)[:13]
    return np.append(head, np.float32(pass2_scale)).astype(np.float32)


def _padded_launch(img, inv_blocks, mirror, epf2, gw1, gw2, pass2_scale,
                   out_kind):
    """One launch of kernel 2's tile pass on row-padded planes (kernel 3
    with mirror, kernel 4 without): its codes come as (H, W, 3) and are
    returned as the twin's (3, H, W) view."""
    H, W = _rows(img, PAD, "real filters"), img.shape[2]
    if inv_blocks.dtype != torch.float32 or inv_blocks.device != img.device \
            or inv_blocks.dim() != 2 or inv_blocks.shape[0] < (H + 7) // 8 \
            or inv_blocks.shape[1] < (W + 7) // 8:
        raise ValueError(f"inv_blocks must be float32 on {img.device}, at "
                         f"least {((H + 7) // 8, (W + 7) // 8)} blocks")
    if img.device.type != "cuda":
        raise ValueError(f"unsupported device {img.device}")
    if img.stride(2) != 1:
        img = img.contiguous()
    if inv_blocks.stride(1) != 1:
        inv_blocks = inv_blocks.contiguous()
    dtype = (torch.float32, torch.uint8, torch.uint16)[out_kind]
    res = torch.empty((3, H, W) if out_kind == 0 else (H, W, 3),
                      device=img.device, dtype=dtype)
    _build.launch(_padded_kernel(), img.device, _row0(img, PAD),
                  img.stride(0), img.stride(1), PAD, H, W,
                  inv_blocks.data_ptr(), inv_blocks.stride(0), res.data_ptr(),
                  int(mirror), int(epf2), out_kind,
                  _padded_consts(gw1, gw2, pass2_scale).ctypes.data,
                  color._CONSTS.ctypes.data, color._MUL.ctypes.data)
    return res if out_kind == 0 else res.permute(2, 0, 1)


def _out_kind(to_srgb: bool, bits: int) -> int:
    return 0 if not to_srgb else (1 if bits <= 8 else 2)


def fused_real_filters_plain(img_padded, inv_blocks, epf_iters=2,
                             pass2_scale=6.5, gw1=DEFAULT_GW1,
                             gw2=DEFAULT_GW2, to_srgb=False, bits=8):
    return _real_plain(img_padded, inv_blocks, True, epf_iters >= 2,
                       _real_taps(gw1, gw2), pass2_scale,
                       _out_kind(to_srgb, bits))


def fused_real_filters(img_padded: torch.Tensor, inv_blocks: torch.Tensor,
                       epf_iters: int = 2, pass2_scale: float = 6.5,
                       gw1: float = DEFAULT_GW1, gw2: float = DEFAULT_GW2,
                       to_srgb: bool = False, bits: int = 8) -> torch.Tensor:
    """Real-format gaborish + EPF1 (+ EPF2 when epf_iters >= 2) with
    Mirror borders.  img_padded: (3, H + 2*PAD, W) XYB, rows padded by
    PAD; inv_blocks: per-8x8-block EPF1 slope (negative where active, 0
    where not).  -> (3, H, W) float32, or sRGB uint8 / uint16 (bits)."""
    if img_padded.device.type == "cpu":
        return fused_real_filters_plain(img_padded, inv_blocks, epf_iters,
                                        pass2_scale, gw1, gw2, to_srgb, bits)
    out = _padded_launch(img_padded, inv_blocks, True, epf_iters >= 2,
                         gw1, gw2, pass2_scale, _out_kind(to_srgb, bits))
    fused_real_filters.launches += 1
    return out


def fused_real_gab_epf1_plain(img_padded, inv_blocks, to_srgb=False):
    return _real_plain(img_padded, inv_blocks, False, False,
                       _real_taps(DEFAULT_GW1, DEFAULT_GW2), 1.0,
                       _out_kind(to_srgb, 8))


def fused_real_gab_epf1(img_padded: torch.Tensor, inv_blocks: torch.Tensor,
                        to_srgb: bool = False) -> torch.Tensor:
    """Real-format gaborish + EPF1 with edge-replicated borders (the
    gaborish rows and columns past the image take the edge's).  ->
    (3, H, W) float32, or uint8 sRGB with to_srgb."""
    if img_padded.device.type == "cpu":
        return fused_real_gab_epf1_plain(img_padded, inv_blocks, to_srgb)
    out = _padded_launch(img_padded, inv_blocks, False, False, DEFAULT_GW1,
                         DEFAULT_GW2, 1.0, _out_kind(to_srgb, 8))
    fused_real_gab_epf1.launches += 1
    return out


fused_gab_epf.launches = 0
fused_filters2.launches = 0
fused_real_filters.launches = 0
fused_real_gab_epf1.launches = 0
legacy_filters_batch.launches = 0
