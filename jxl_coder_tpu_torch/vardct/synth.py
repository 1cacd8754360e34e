"""VarDCT synthesis, one strategy family at a time (kernel 1).

``synth_family`` writes a family's pixels into the (3, H8, W8) XYB
frame planes.  On a CUDA tensor it launches ``csrc/synth.cu`` (which
replaces the TPU kernel ``jxl_coder_tpu/vardct/synth_pallas.py``
``synth_family_pallas`` and the jnp ``tpu_full._synth_family``; see the
source note there for what bounds it): the DCT8 family its own kernel
(``synth_dct8``), every other family the general one.  Both read the
packed coefficients, the sorted int8 exception list and the DC image
themselves: no torch operation runs before a launch.  On a CPU tensor
it runs ``synth_family_plain``, the PyTorch twin with the same math,
which prepares in torch what the kernels do inside: the exception list
(``index_add_`` on the int32 view, as ``tpu_full._with_fixes``) and the
per-block LLF corner from the DC image (``llf_from_dc``, as
``tpu_full.py:462-482``).  There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import _build
from ..host.vardct import synthesis as S
from .inputs import _PAD_SENTINEL, Family

_QB = np.asarray([1.0 - b for b in S.QUANT_BIAS], np.float32)
_NUM = np.float32(S.QUANT_BIAS_NUM)
# shared memory a thread block may use on Hopper; the kernel stages
# 6*K floats per varblock, in a global scratch buffer beyond this
# (DCT128X128 and the DCT256 family)
_SMEM_BYTES = 227 * 1024
# the DCT8 kernel's basis, a host array copied into its launch parameters
_BASIS8 = np.ascontiguousarray(S.cos_basis(8), np.float32)


@functools.lru_cache(maxsize=None)
def _basis(n: int, device: torch.device) -> torch.Tensor:
    """A[k, x] (synthesis.cos_basis), built in float64 and cast once."""
    return torch.from_numpy(S.cos_basis(n).astype(np.float32)).to(device)


@functools.lru_cache(maxsize=None)
def _llf_mats(cy: int, cx: int, device: torch.device):
    anY = torch.from_numpy(S.ana_basis(cy).astype(np.float32)).to(device)
    anX = torch.from_numpy(S.ana_basis(cx).astype(np.float32)).to(device)
    rs = torch.from_numpy(np.outer(S.resample_vec(cy), S.resample_vec(cx))
                          .astype(np.float32)).to(device)
    return anY, anX, rs


def coefficients(fam: Family) -> torch.Tensor:
    """The family's integer coefficients with the int8 exception list
    added in (pad entries are (0, 0) and harmless)."""
    if fam.fix_idx is None:
        return fam.coef
    flat = fam.coef.reshape(-1).to(torch.int32)
    flat.index_add_(0, fam.fix_idx, fam.fix_val)
    return flat.view(fam.coef.shape)


def llf_from_dc(dc: torch.Tensor, fam: Family) -> torch.Tensor:
    """(n_pad, 3, cy*cx) lowest-frequency coefficients from the DC image
    windows each varblock covers (1 value, the DC itself, for 1-block
    transforms)."""
    cy, cx = fam.bh // 8, fam.bw // 8
    ys, xs = dc.shape[1], dc.shape[2]
    n = fam.bys.shape[0]
    gy = fam.bys.long().clamp(0, ys - 1)
    gx = fam.bxs.long().clamp(0, xs - 1)
    if cy == 1 and cx == 1:
        # ana_basis(1) and resample_vec(1) are exactly 1.0: the einsum
        # below would return the DC sample unchanged
        return dc[:, gy, gx].t().reshape(n, 3, 1).contiguous()
    dev = dc.device
    giy = (gy[:, None, None]
           + torch.arange(cy, device=dev)[None, :, None]).clamp(0, ys - 1)
    gix = (gx[:, None, None]
           + torch.arange(cx, device=dev)[None, None, :]).clamp(0, xs - 1)
    dcb = dc[:, giy, gix]                                # (3, n, cy, cx)
    anY, anX, rs = _llf_mats(cy, cx, dev)
    llf = torch.einsum("ky,cnyx,lx->cnkl", anY, dcb, anX) * rs
    return llf.permute(1, 0, 2, 3).reshape(n, 3, cy * cx).contiguous()


def _bias(v: torch.Tensor) -> torch.Tensor:
    """AdjustQuantBias on (n, 3, K) float values (tpu_full._bias_device)."""
    qb = torch.from_numpy(_QB).to(v.device)[None, :, None]
    safe = torch.where(v == 0.0, torch.ones_like(v), v)
    return torch.where(v.abs() > 1.0, v - float(_NUM) / safe, v * qb)


def _tabqm(fam: Family, qm: np.ndarray) -> torch.Tensor:
    """tab * qm per channel (scalar multiplies: no host-to-device copy)."""
    return torch.stack([fam.tab[c] * float(qm[c]) for c in range(3)])


def _scatter(planes, pix, fam: Family) -> None:
    """planes[:, by*8 + y, bx*8 + x] = pix for every non-padding row."""
    valid = fam.bys != _PAD_SENTINEL
    dev = planes.device
    rows = fam.bys[valid].long()[:, None] * 8 + torch.arange(fam.bh,
                                                             device=dev)
    cols = fam.bxs[valid].long()[:, None] * 8 + torch.arange(fam.bw,
                                                             device=dev)
    planes[:, rows[:, :, None], cols[:, None, :]] = \
        pix[valid].permute(1, 0, 2, 3)


def synth_family_plain(planes: torch.Tensor, fam: Family, dc: torch.Tensor,
                       qm: np.ndarray) -> None:
    """The plain PyTorch twin of the CUDA kernel."""
    coef = coefficients(fam)
    llf = llf_from_dc(dc, fam)
    n = coef.shape[0]
    iq = fam.inv_qac
    b = _bias(coef.to(torch.float32))
    if fam.special:
        resp = fam.resp.reshape(3, 64, 64)
        acY = (b[:, 1, 1:] @ fam.resp_y_def.reshape(64, 64)[1:]) \
            * iq[:, None]
        pix = []
        for c in range(3):
            p = (b[:, c, 1:] @ resp[c, 1:]) * (iq * float(qm[c]))[:, None]
            p = p + llf[:, c, 0][:, None] * resp[c, 0]
            if c != 1:
                p = p + (fam.xf if c == 0 else fam.bf)[:, None] * acY
            pix.append(p)
        pix = torch.stack(pix, 1).reshape(n, 3, 8, 8)
    else:
        bh, bw = fam.bh, fam.bw
        cy, cx = bh // 8, bw // 8
        d = b * _tabqm(fam, qm)[None] * iq[:, None, None]
        dY = d[:, 1]
        dX = d[:, 0] + fam.xf[:, None] * dY
        dB = d[:, 2] + fam.bf[:, None] * dY
        C = torch.stack([dX, dY, dB], 1).reshape(n, 3, bh, bw)
        C[:, :, :cy, :cx] = llf.reshape(n, 3, cy, cx)
        dev = planes.device
        # separable inverse transform: rows, then columns
        pix = _basis(bh, dev).t() @ (C @ _basis(bw, dev))
    _scatter(planes, pix, fam)


_c = ctypes
_ARGTYPES = ([_c.c_int, _c.c_int] + [_c.c_void_p] * 4 + [_c.c_int] * 2
             + [_c.c_void_p] * 5 + [_c.c_int] + [_c.c_void_p] * 9
             + [_c.c_int] * 5 + [_c.c_float] * 7)
_DCT8_ARGTYPES = ([_c.c_int] + [_c.c_void_p] * 4 + [_c.c_int] * 2
                  + [_c.c_void_p] * 7 + [_c.c_int, _c.c_void_p]
                  + [_c.c_int] * 3 + [_c.c_float] * 7)


@functools.lru_cache(maxsize=None)
def _kernel():
    return _build.bind(_build.load("synth"), "jxl_synth_family", _ARGTYPES)


@functools.lru_cache(maxsize=None)
def _dct8_kernel():
    return _build.bind(_build.load("synth"), "jxl_synth_dct8",
                       _DCT8_ARGTYPES)


def is_dct8(fam: Family) -> bool:
    return fam.sid == 0 and fam.bh == 8 and fam.bw == 8 and not fam.special


def _check_cuda_args(planes: torch.Tensor, fam: Family,
                     dc: torch.Tensor) -> None:
    """What the kernel reads through raw pointers: every tensor on the
    planes' device, with the dtypes and lengths family_from_dict gives."""
    if planes.dim() != 3 or planes.shape[0] != 3 or \
            planes.dtype != torch.float32 or not planes.is_contiguous():
        raise ValueError("planes must be contiguous float32 (3, H8, W8)")
    n = fam.coef.shape[0]
    want = [(fam.coef, (torch.int8, torch.int16, torch.int32)),
            (dc, (torch.float32,)),
            (fam.bys, (torch.int32,)), (fam.bxs, (torch.int32,)),
            (fam.inv_qac, (torch.float32,)), (fam.xf, (torch.float32,)),
            (fam.bf, (torch.float32,))]
    for t, dtypes in want:
        if t.device != planes.device:
            raise ValueError(f"family tensor on {t.device}, planes on "
                             f"{planes.device}")
        if t.dtype not in dtypes or not t.is_contiguous():
            raise ValueError(f"family tensor of dtype {t.dtype}, expected "
                             f"contiguous {dtypes}")
    if any(t.shape[0] != n for t in (fam.bys, fam.bxs, fam.inv_qac, fam.xf,
                                     fam.bf)):
        raise ValueError("family tensors disagree on the row count")
    K = 64 if fam.special else fam.bh * fam.bw
    if tuple(fam.coef.shape[1:]) != (3, K):
        raise ValueError(f"coefficients {tuple(fam.coef.shape)}, expected "
                         f"(n, 3, {K})")
    if dc.dim() != 3 or dc.shape[0] != 3:
        raise ValueError("dc must be a (3, ys, xs) image")
    mats = ([(fam.resp, 3 * 64 * 64), (fam.resp_y_def, 64 * 64)]
            if fam.special else [(fam.tab, 3 * K)])
    for t, size in mats:
        if t is None or t.dtype != torch.float32 or t.device != planes.device \
                or t.numel() != size or not t.is_contiguous():
            raise ValueError(f"the family's matrices must be contiguous "
                             f"float32, {size} values, on {planes.device}")


def _ptr(t) -> int:
    """A tensor's device address for a kernel argument (None: null)."""
    return None if t is None else t.data_ptr()


def n_fixes(fam: Family) -> int:
    """The entries of the family's int8 exception list (0 without one)."""
    return 0 if fam.fix_idx is None else int(fam.fix_idx.shape[0])


def _fixes(fam: Family, device):
    """The exception list the kernels read: int64 indices and int32
    values, sorted by index (None, None without one)."""
    if not n_fixes(fam):
        return None, None
    idx, val = fam.fix_idx, fam.fix_val
    if idx.dtype != torch.int64 or val.dtype != torch.int32 or \
            idx.device != device or val.device != device or \
            not idx.is_contiguous() or not val.is_contiguous() or \
            val.shape != idx.shape:
        raise ValueError("the exception list must be contiguous int64 "
                         f"indices and as many int32 values on {device}")
    return idx, val


def synth_family(planes: torch.Tensor, fam: Family, dc: torch.Tensor,
                 qm: np.ndarray) -> None:
    """Write one family's XYB pixels into planes (3, H8, W8) float32, in
    place: the CUDA kernel for a CUDA tensor (the DCT8 family's own,
    synth_dct8), the twin for a CPU one."""
    if planes.device.type == "cpu":
        synth_family_plain(planes, fam, dc, qm)
        return
    if planes.device.type != "cuda":
        raise ValueError(f"unsupported device {planes.device}")
    _check_cuda_args(planes, fam, dc)
    if is_dct8(fam):
        synth_dct8(planes, fam, dc, qm)
        return
    fix_idx, fix_val = _fixes(fam, planes.device)
    if fam.special:
        mat, mat_y = fam.resp, fam.resp_y_def
        anY = anX = rs = Ah = Aw = None
    else:
        mat, mat_y = fam.tab, None
        anY, anX, rs = _llf_mats(fam.bh // 8, fam.bw // 8, planes.device)
        Ah, Aw = _basis(fam.bh, planes.device), _basis(fam.bw, planes.device)
    n = fam.coef.shape[0]
    scratch = None
    if not fam.special and 6 * fam.bh * fam.bw * 4 > _SMEM_BYTES:
        scratch = torch.empty(n * 6 * fam.bh * fam.bw, dtype=torch.float32,
                              device=planes.device)
    _, ys, xs = dc.shape
    H8, W8 = planes.shape[1], planes.shape[2]
    _build.launch(
        _kernel(), planes.device,
        int(fam.special), fam.coef.element_size(), _ptr(fam.coef), _ptr(mat),
        _ptr(mat_y), _ptr(dc), ys, xs, _ptr(anY), _ptr(anX), _ptr(rs),
        _ptr(fix_idx), _ptr(fix_val), n_fixes(fam), _ptr(fam.inv_qac),
        _ptr(fam.xf), _ptr(fam.bf), _ptr(fam.bys), _ptr(fam.bxs), _ptr(Ah),
        _ptr(Aw), _ptr(planes), _ptr(scratch), n, fam.bh, fam.bw, H8, W8,
        float(_QB[0]), float(_QB[1]), float(_QB[2]), float(_NUM),
        float(qm[0]), float(qm[1]), float(qm[2]))
    synth_family.launches += 1


def synth_dct8(planes: torch.Tensor, fam: Family, dc: torch.Tensor,
               qm: np.ndarray) -> None:
    """The DCT8 family's launch, from synth_family on checked CUDA
    tensors: its own kernel (no widening, no LLF gather, no tab*qm
    launch)."""
    fix_idx, fix_val = _fixes(fam, planes.device)
    _, ys, xs = dc.shape
    H8, W8 = planes.shape[1], planes.shape[2]
    _build.launch(
        _dct8_kernel(), planes.device, fam.coef.element_size(),
        _ptr(fam.coef), _ptr(fam.tab), _BASIS8.ctypes.data, _ptr(dc),
        ys, xs, _ptr(fam.bys), _ptr(fam.bxs), _ptr(fam.inv_qac), _ptr(fam.xf),
        _ptr(fam.bf), _ptr(fix_idx), _ptr(fix_val), n_fixes(fam),
        _ptr(planes), fam.coef.shape[0], H8, W8, float(_QB[0]), float(_QB[1]),
        float(_QB[2]), float(_NUM), float(qm[0]), float(qm[1]),
        float(qm[2]))
    synth_dct8.launches += 1


synth_family.launches = 0
synth_dct8.launches = 0
