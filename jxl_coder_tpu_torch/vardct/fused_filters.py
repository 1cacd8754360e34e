"""Fused restoration filters: TPU kernels 3-6 of
``jxl_coder_tpu/vardct/filters_pallas.py`` as ``csrc/fused_filters.cu``.

Entry points keep the JAX names and arguments (less ``tile``):

- ``fused_gab_epf(stacked)`` (#5) and ``fused_filters2(img_padded,
  inv_padded, to_srgb)`` (#6): the round-1 codec's gaborish + one
  plus-shaped EPF pass (+ sRGB8) on planes row-padded by ``PAD``.
  ``legacy_filters`` is the same kernel on unpadded planes, with
  gaborish, EPF and the sRGB8 output each switchable; the round-1
  pipeline (``pipeline.reconstruct_xyb`` / ``reconstruct_srgb8``) calls
  it and it counts toward #5 (float output) or #6 (sRGB8).
- ``fused_real_filters(img_padded, inv_blocks, ...)`` (#3): the
  real-format gaborish + EPF1 (+ EPF2) (+ sRGB) chain with Mirror
  borders, and ``fused_real_gab_epf1(img_padded, inv_blocks, to_srgb)``
  (#4): gaborish + EPF1 with edge-replicated borders.

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
from ..ops import fp
from . import color, pipeline as P, xyb as X
from .filters import BORDER_MUL, _border, _mirror_index

PAD = 4      # row padding of the JAX functions' padded planes
DEFAULT_GW1, DEFAULT_GW2 = 0.115169525, 0.061248592

_c = ctypes


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("fused_filters")
    head = [_c.c_void_p, _c.c_longlong, _c.c_int, _c.c_int, _c.c_int,
            _c.c_int, _c.c_void_p, _c.c_int, _c.c_void_p, _c.c_int,
            _c.c_int, _c.c_int]
    return dict(
        legacy=_build.bind(lib, "jxl_legacy_filters",
                           head + [_c.c_void_p] * 3),
        real=_build.bind(lib, "jxl_real_filters", head + [_c.c_void_p] * 3))


@functools.lru_cache(maxsize=None)
def _legacy_consts() -> np.ndarray:
    return np.concatenate([
        P.gaborish_kernel().reshape(9), P.EPF_CHANNEL_SCALE,
        X.INV_OPSIN.reshape(9),
        [X.CBRT_BIAS, X.OPSIN_BIAS, np.float32(1 / 2.4)]]).astype(np.float32)


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

def _legacy_plain(img, inv, pad, gab, epf, to_srgb):
    """pipeline.apply_filters on the slab of filter_halo() rows around
    the image (+ pipeline.xyb_to_srgb8): the jnp chain the TPU kernels
    reproduce."""
    halo = P.filter_halo(int(epf), gab)
    slab = _padded_rows(img, pad, halo)
    inv_slab = _padded_rows(inv, pad, halo) if epf else None
    xyb = P.apply_filters(slab, inv_slab, int(epf), gab)
    return P.xyb_to_srgb8(xyb) if to_srgb else xyb


def _legacy_launch(img, inv, pad, gab, epf, to_srgb):
    H = _rows(img, pad, "legacy filters")
    W = img.shape[2]
    if img.stride(2) != 1:
        img = img.contiguous()
    inv_ptr, inv_stride = None, 0
    if epf:
        if inv is None or inv.dtype != torch.float32 or \
                inv.device != img.device or inv.dim() != 2 or \
                inv.shape[0] < H + 2 * pad or inv.shape[1] < W:
            raise ValueError(f"inv must be float32 on {img.device} with at "
                             f"least {(H + 2 * pad, W)} pixels")
        if inv.stride(1) != 1:
            inv = inv.contiguous()
        inv_ptr, inv_stride = _row0(inv, pad), inv.stride(0)
    out = torch.empty((3, H, W), device=img.device,
                      dtype=torch.uint8 if to_srgb else torch.float32)
    _build.launch(_lib()["legacy"], img.device, _row0(img, pad),
                  img.stride(0), img.stride(1), pad, H, W, inv_ptr,
                  inv_stride, out.data_ptr(), int(gab), int(epf),
                  int(to_srgb), _legacy_consts().ctypes.data,
                  fp.POWF_F64.ctypes.data, fp.POWF_I64.ctypes.data)
    return out


def fused_gab_epf_plain(stacked: torch.Tensor) -> torch.Tensor:
    return _legacy_plain(stacked[:3], stacked[3], PAD, True, True, False)


def fused_gab_epf(stacked: torch.Tensor) -> torch.Tensor:
    """stacked: (4, H + 2*PAD, W) float32 = [xyb(3); inv_sigma(1)], rows
    padded by PAD.  -> (3, H, W) gaborish + one EPF pass."""
    if stacked.device.type == "cpu":
        return fused_gab_epf_plain(stacked)
    out = _legacy_launch(stacked[:3], stacked[3], PAD, True, True, False)
    fused_gab_epf.launches += 1
    return out


def fused_filters2_plain(img_padded, inv_padded, to_srgb=False):
    return _legacy_plain(img_padded, inv_padded, PAD, True, True, to_srgb)


def fused_filters2(img_padded: torch.Tensor, inv_padded: torch.Tensor,
                   to_srgb: bool = False) -> torch.Tensor:
    """img_padded: (3, H + 2*PAD, W); inv_padded: (H + 2*PAD, W).  ->
    (3, H, W) float32, or uint8 sRGB with to_srgb."""
    if img_padded.device.type == "cpu":
        return fused_filters2_plain(img_padded, inv_padded, to_srgb)
    out = _legacy_launch(img_padded, inv_padded, PAD, True, True, to_srgb)
    fused_filters2.launches += 1
    return out


def legacy_filters_plain(img, inv, gab, epf, to_srgb):
    return _legacy_plain(img, inv, 0, gab, epf, to_srgb)


def legacy_filters(img: torch.Tensor, inv, gab: bool, epf: bool,
                   to_srgb: bool) -> torch.Tensor:
    """Kernels 5 / 6 on unpadded (3, H, W) planes (a cropped view is
    fine) with edge-replicated borders; inv: (H, W) per-pixel inverse
    sigma (unused without epf).  -> (3, H, W) float32, or uint8 sRGB."""
    if img.device.type == "cpu":
        return legacy_filters_plain(img, inv, gab, epf, to_srgb)
    out = _legacy_launch(img, inv, 0, gab, epf, to_srgb)
    if to_srgb:
        fused_filters2.launches += 1
    else:
        fused_gab_epf.launches += 1
    return out


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


def _real_launch(img, inv_blocks, mirror, epf2, k, pass2_scale, out_kind):
    H, W = _rows(img, PAD, "real filters"), img.shape[2]
    if img.stride(2) != 1:
        img = img.contiguous()
    if inv_blocks.dtype != torch.float32 or inv_blocks.device != img.device \
            or inv_blocks.dim() != 2 or inv_blocks.shape[0] < (H + 7) // 8 \
            or inv_blocks.shape[1] < (W + 7) // 8:
        raise ValueError(f"inv_blocks must be float32 on {img.device}, at "
                         f"least {((H + 7) // 8, (W + 7) // 8)} blocks")
    inv_blocks = inv_blocks.contiguous()
    out = torch.empty((3, H, W), device=img.device, dtype=(
        torch.float32, torch.uint8, torch.uint16)[out_kind])
    consts = np.concatenate([k.reshape(9), np.float32(REAL_CS),
                             [BORDER_MUL, np.float32(pass2_scale)]]
                            ).astype(np.float32)
    _build.launch(_lib()["real"], img.device, _row0(img, PAD), img.stride(0),
                  img.stride(1), PAD, H, W, inv_blocks.data_ptr(),
                  inv_blocks.stride(0), out.data_ptr(), int(mirror),
                  int(epf2), out_kind, consts.ctypes.data,
                  color._CONSTS.ctypes.data, color._MUL.ctypes.data)
    return out


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
    out = _real_launch(img_padded, inv_blocks, True, epf_iters >= 2,
                       _real_taps(gw1, gw2), pass2_scale,
                       _out_kind(to_srgb, bits))
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
    out = _real_launch(img_padded, inv_blocks, False, False,
                       _real_taps(DEFAULT_GW1, DEFAULT_GW2), 1.0,
                       _out_kind(to_srgb, 8))
    fused_real_gab_epf1.launches += 1
    return out


fused_gab_epf.launches = 0
fused_filters2.launches = 0
fused_real_filters.launches = 0
fused_real_gab_epf1.launches = 0
