"""The VarDCT encoder front on the device: kernels E1-E4 and the winners'
gather, each with its plain PyTorch twin.

They replace the jitted front end of ``jxl_coder_tpu/vardct/enc_device.py``
(no Pallas kernel there; the round's rule for jitted device code is a
hand-written kernel with a plain twin), in ``csrc/encode.cu``:

- ``front_planes`` (E1, ``_front``'s first half, ``enc_device.py:111-119``
  with ``tpu_real.gaborish_device``): (ph, pw, 3) u8 / u16 / f32 sRGB ->
  (3, ph, pw) f32 XYB with B - Y, each plane sharpened by four Neumann
  steps ``err -= gab(err); out += err`` on a symmetric-padded plane;
- ``front_blocks`` (E2, ``:120-152``): the planes -> the 8x8 DCT analysis
  ``co`` (3, ys_b, xs_b, 8, 8) and the flat "small" buffer (the masking
  field from ``jnp.gradient`` of Y, its block mean and median, the CfL
  sums y2, xy, by per 64-px tile over AC coefficients, the DC slice);
- ``dct_costs`` (E3, ``_costs``' ``quant_cost`` and candidate loop,
  ``:174-279``): for DCT8 (from ``co``) or one aligned candidate shape
  (its region's DCT from the planes), the biased quantisation with the
  deadzone in scan order, CfL-subtracted X / B, distortion with the LLF
  term, the rate proxy -> int16 values (rows, 3, tail) and an f32 cost
  per varblock;
- ``special_costs`` (E4, ``:280-321``): one same-size special transform
  by its response matrices per 8x8 block, on eligible blocks (cost 1e30
  and zero values elsewhere; the reference computes the values there too,
  but no winner ever takes them);
- ``gather_rows`` (``_sel_gather_jit``, ``:424-436``): the winners' rows
  of every source, back to back, int16, in one launch whose grid covers
  the output exactly.

Each wrapper counts its launches in ``.launches``; on a CPU tensor it runs
its twin (``*_plain``), on a CUDA tensor it launches its kernel or raises.
The twins repeat the JAX math in its order in float32 (TF32 off,
``_device``); E1's twin and kernel round alike (glibc's powf,
``ops/fp.py``, and the 3x3 mix as ``fp.contract3``), so its planes are
equal to the bit; the sums of E2-E4 run in another order on the card.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import Sequence, Tuple

import numpy as np
import torch

from .. import _build
from ..host.vardct import synthesis as S
from ..host.vardct.enc_real import (_BIAS, _CBRT_BIAS, _OPSIN, MASK_COEF,
                                    MASK_COEF2, MASK_EXP, MASK_EXP2,
                                    MASK_MAX, _special_mats)
from ..host.vardct.strategies import STRATEGIES
from ..ops import fp

__all__ = ["front_planes", "front_planes_plain", "front_blocks",
           "front_blocks_plain", "dct_costs", "dct_costs_plain",
           "special_costs", "special_costs_plain", "gather_rows",
           "gather_rows_plain", "D_WEIGHTS"]

D_WEIGHTS = (8.0, 1.0, 0.35)
GAB_W1 = np.float32(0.115169525)
GAB_W2 = np.float32(0.061248592)
GAB_NORM = np.float32(1.0) + np.float32(4.0) * (GAB_W1 + GAB_W2)
MAX_SOURCES = 16           # the gather's sources: DCT8, 6 shapes, 5 specials

_PIX_CODES = {torch.uint8: 0, torch.int16: 1, torch.float32: 2}


# --------------------------------------------------------------------------
# The kernels' bindings and constant tables

@functools.lru_cache(maxsize=None)
def _kernels():
    lib = _build.load("encode")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    return {
        "front_planes": _build.bind(lib, "jxl_enc_front_planes",
                                    [p, i, p, i, i, i, p]),
        "front_blocks": _build.bind(lib, "jxl_enc_front_blocks",
                                    [p, p, p, i, i, p]),
        "dct_costs": _build.bind(lib, "jxl_enc_dct_costs",
                                 [p, p, p, p, p, p, p, i, i, i, i, f, f,
                                  f, p, i, i, p]),
        "special_costs": _build.bind(lib, "jxl_enc_special_costs",
                                     [p, p, p, p, p, p, p, i, i, f, f, f,
                                      p, p, p]),
        "gather_rows": _build.bind(lib, "jxl_enc_gather_rows", [p, i, p]),
    }


_TABLES = {}
_TABLES_LOCK = threading.Lock()


def _f32(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, np.float64).astype(np.float32))


@functools.lru_cache(maxsize=None)
def _host_tables(sid: int, cy: int, cx: int):
    """A shape's statics (``_costs``' cand_static): the analysis bases
    anaH (h, h), anaW (w, w), the scan tail's natural indices, the
    dequant tables in that order (3, tail), the covered positions, the
    LLF bases (cy, cy), (cx, cx) and the LLF resample (cy, cx)."""
    st = STRATEGIES[sid]
    cov = st.covered
    h, w = cy * 8, cx * 8
    order = np.asarray(S.scan_to_basis(sid), np.int64)
    tail = order[cov:]
    tabs = np.stack([np.asarray(S.dequant_table(sid, c), np.float32)
                     for c in range(3)])
    pos = np.asarray([(j // cx) * w + (j % cx) for j in range(cov)],
                     np.int32)
    return {
        "anaH": _f32(S.ana_basis(h)), "anaW": _f32(S.ana_basis(w)),
        "order": tail.astype(np.int32),
        "tab": np.ascontiguousarray(tabs[:, tail]),
        "pos": pos,
        "anY": _f32(S.ana_basis(cy)), "anX": _f32(S.ana_basis(cx)),
        "rs": _f32(np.outer(S.resample_vec(cy), S.resample_vec(cx))),
    }


@functools.lru_cache(maxsize=None)
def _special_host(sid: int):
    """(r0 (3, 64), R1 (3, 63, 64), A (3, 64, 63)) in float32."""
    r0, R1, A = _special_mats(sid)
    return _f32(r0), _f32(R1), _f32(A)


def _tables(dev: torch.device, key):
    """The constant tables of `key` ("ana8", ("shape", sid, cy, cx) or
    ("special", sid)) on `dev`, uploaded once per device."""
    with _TABLES_LOCK:
        if (dev, key) not in _TABLES:
            if key == "ana8":
                val = torch.from_numpy(_f32(S.ana_basis(8))).to(dev)
            elif key[0] == "shape":
                val = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                       for k, v in _host_tables(*key[1:]).items()}
            else:
                val = tuple(torch.from_numpy(v).to(dev)
                            for v in _special_host(key[1]))
            _TABLES[(dev, key)] = val
        return _TABLES[(dev, key)]


def _check(t: torch.Tensor, name: str, dtype, shape, dev) -> None:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or \
            t.device != dev or not t.is_contiguous():
        raise ValueError(f"{name}: expected contiguous {dtype} "
                         f"{tuple(shape)} on {dev}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


# --------------------------------------------------------------------------
# E1: sRGB -> XYB, B - Y, gaborish sharpening

def _unit(pix: torch.Tensor) -> torch.Tensor:
    """(ph, pw, 3) samples -> (3, ph, pw) f32 in [0, 1]: the IEEE division
    by 255 or 65535 (u16 arrives as its int16 view)."""
    p = pix.permute(2, 0, 1)
    if pix.dtype == torch.uint8:
        return fp.div(p.to(torch.float32), 255.0)
    if pix.dtype == torch.int16:
        return fp.div((p.to(torch.int32) & 0xFFFF).to(torch.float32),
                      65535.0)
    return p.to(torch.float32)


def _cbrt(x: torch.Tensor) -> torch.Tensor:
    """jnp.cbrt as glibc's powf(|x|, 1/3) with the sign; 0 stays 0."""
    a = fp.powf(torch.where(x == 0, torch.ones_like(x), x.abs()), 1 / 3)
    return torch.where(x == 0, x, torch.where(x < 0, -a, a))


def _gab(p: torch.Tensor) -> torch.Tensor:
    """tpu_real.gaborish_device on a plane padded by one symmetric sample
    (for one sample, numpy's "symmetric" repeats the edge)."""
    q = torch.nn.functional.pad(p[None, None], (1, 1, 1, 1),
                                mode="replicate")[0, 0]
    c = q[1:-1, 1:-1]
    s1 = ((q[:-2, 1:-1] + q[2:, 1:-1]) + q[1:-1, :-2]) + q[1:-1, 2:]
    s2 = ((q[:-2, :-2] + q[:-2, 2:]) + q[2:, :-2]) + q[2:, 2:]
    return fp.div((c + float(GAB_W1) * s1) + float(GAB_W2) * s2,
                  float(GAB_NORM))


def front_planes_plain(pix: torch.Tensor, gab_iters: int) -> torch.Tensor:
    """The twin of front_planes."""
    f = _unit(pix)
    lin = torch.where(f <= 0.04045, fp.div(f, 12.92),
                      fp.powf(fp.div(f + 0.055, 1.055), 2.4))
    mixed = fp.contract3(_OPSIN.astype(np.float32), lin)
    g = _cbrt(mixed + float(np.float32(_BIAS))) - \
        float(np.float32(_CBRT_BIAS))
    Y = (g[0] + g[1]) * 0.5
    planes = [(g[0] - g[1]) * 0.5, Y, g[2] - Y]
    out = []
    for p in planes:
        acc, err = p, p
        for _ in range(gab_iters):
            err = err - _gab(err)
            acc = acc + err
        out.append(acc)
    return torch.stack(out)


def front_planes(pix: torch.Tensor, gab_iters: int = 4) -> torch.Tensor:
    """(ph, pw, 3) sRGB samples (uint8, uint16 as its int16 view, or
    float32 in [0, 1]), ph and pw multiples of 8 -> the (3, ph, pw) f32
    planes X, Y, B - Y after `gab_iters` gaborish sharpening steps."""
    if pix.dtype not in _PIX_CODES or pix.dim() != 3 or pix.shape[2] != 3 \
            or pix.shape[0] % 8 or pix.shape[1] % 8 or pix.numel() == 0:
        raise ValueError(f"pix: expected (ph, pw, 3) u8 / int16 / f32 on "
                         f"the block grid, got {tuple(pix.shape)} "
                         f"{pix.dtype}")
    if not 0 <= gab_iters <= 4:
        raise ValueError(f"gab_iters {gab_iters}: expected 0..4")
    if pix.device.type == "cpu":
        return front_planes_plain(pix, gab_iters)
    pix = pix.contiguous()
    ph, pw = pix.shape[:2]
    out = torch.empty((3, ph, pw), dtype=torch.float32, device=pix.device)
    _build.launch(_kernels()["front_planes"], pix.device, pix.data_ptr(),
                  _PIX_CODES[pix.dtype], out.data_ptr(), ph, pw, gab_iters,
                  _front_consts(pix.device).data_ptr())
    front_planes.launches += 1
    return out


front_planes.launches = 0


def _front_consts(dev: torch.device) -> torch.Tensor:
    """E1's float constants (the opsin matrix, the biases, gaborish's
    weights) and glibc's powf tables, as the kernel reads them."""
    with _TABLES_LOCK:
        if (dev, "front") not in _TABLES:
            f = [*_OPSIN.astype(np.float32).reshape(-1),
                 np.float32(_BIAS), np.float32(_CBRT_BIAS), GAB_W1, GAB_W2,
                 GAB_NORM]
            _TABLES[(dev, "front")] = torch.tensor(
                np.asarray(f, np.float32)).to(dev)
        return _TABLES[(dev, "front")]


# --------------------------------------------------------------------------
# E2: block DCT, masking field, CfL sums, DC slice

def _gradient(a: torch.Tensor, dim: int) -> torch.Tensor:
    """jnp.gradient along `dim` at unit spacing: (a[i+1] - a[i-1]) * 0.5
    inside, one-sided differences at the ends."""
    a = a.movedim(dim, 0)
    g = torch.empty_like(a)
    g[1:-1] = (a[2:] - a[:-2]) * 0.5
    g[:1] = a[1:2] - a[:1]
    g[-1:] = a[-1:] - a[-2:-1]
    return g.movedim(0, dim)


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """float32 sqrt correctly rounded on every device, as the kernel's and
    XLA's (torch's CPU float32 sqrt is not: 0.66% of values 1 ulp off); the
    float64 root of a float32 rounds to the same float32."""
    return torch.sqrt(x.double()).float()


def _pow0(x: torch.Tensor, y: float) -> torch.Tensor:
    """powf for x >= 0 (0 ** y = 0)."""
    return torch.where(x > 0, fp.powf(torch.where(x > 0, x,
                                                  torch.ones_like(x)), y),
                       torch.zeros_like(x))


def _mask_of(mean_b: torch.Tensor, med_b: torch.Tensor) -> torch.Tensor:
    """The masking field from the blocks' activity mean and median."""
    blk = _sqrt(mean_b * torch.minimum(mean_b, 4.0 * med_b))
    return torch.clamp(1.0 + MASK_COEF * _pow0(blk, MASK_EXP)
                       + MASK_COEF2 * _pow0(blk, MASK_EXP2), 1.0, MASK_MAX)


def front_blocks_plain(planes: torch.Tensor):
    """The twin of front_blocks."""
    _, ph, pw = planes.shape
    ys_b, xs_b = ph // 8, pw // 8
    ty, tx = -(-ys_b // 8), -(-xs_b // 8)
    ana = _tables(planes.device, "ana8")
    Y = planes[1]
    gy, gx = _gradient(Y, 0), _gradient(Y, 1)
    act = _sqrt(gy * gy + gx * gx)
    act_b = act.reshape(ys_b, 8, xs_b, 8).permute(0, 2, 1, 3).reshape(
        ys_b, xs_b, 64)
    mean_b = torch.clamp_min(act_b.mean(-1), 0.0)
    srt = act_b.sort(-1).values
    mask = _mask_of(mean_b, srt[..., 31] * 0.5 + srt[..., 32] * 0.5)
    b8 = planes.reshape(3, ys_b, 8, xs_b, 8).permute(0, 1, 3, 2, 4)
    co = torch.matmul(torch.matmul(ana, b8), ana.t()).contiguous()
    cf = co.reshape(3, ys_b, xs_b, 64)
    cfp = torch.nn.functional.pad(cf, (0, 0, 0, (-xs_b) % 8,
                                       0, (-ys_b) % 8))
    cft = cfp.reshape(3, ty, 8, tx, 8, 64)
    yac = cft[1, ..., 1:]
    y2 = (yac * yac).sum(dim=(1, 3, 4))
    xy = (cft[0, ..., 1:] * yac).sum(dim=(1, 3, 4))
    by = (cft[2, ..., 1:] * yac).sum(dim=(1, 3, 4))
    small = torch.cat([mask.reshape(-1), y2.reshape(-1), xy.reshape(-1),
                       by.reshape(-1), co[:, :, :, 0, 0].reshape(-1)])
    return co, small


def front_blocks(planes: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(3, ph, pw) f32 planes -> (co (3, ys_b, xs_b, 8, 8) f32, the flat
    f32 buffer: mask (ys_b * xs_b), y2, xy, by (one per 64-px tile each),
    co's DC slice (3 * ys_b * xs_b))."""
    if planes.dtype != torch.float32 or planes.dim() != 3 or \
            planes.shape[0] != 3 or planes.shape[1] % 8 or \
            planes.shape[2] % 8 or not planes.is_contiguous():
        raise ValueError(f"planes: expected contiguous (3, ph, pw) f32 on "
                         f"the block grid, got {tuple(planes.shape)} "
                         f"{planes.dtype}")
    if planes.device.type == "cpu":
        return front_blocks_plain(planes)
    _, ph, pw = planes.shape
    ys_b, xs_b = ph // 8, pw // 8
    nt = (-(-ys_b // 8)) * (-(-xs_b // 8))
    co = torch.empty((3, ys_b, xs_b, 8, 8), dtype=torch.float32,
                     device=planes.device)
    small = torch.empty(ys_b * xs_b * 4 + 3 * nt, dtype=torch.float32,
                        device=planes.device)
    _build.launch(_kernels()["front_blocks"], planes.device,
                  planes.data_ptr(), co.data_ptr(), small.data_ptr(), ph,
                  pw, _tables(planes.device, "ana8").data_ptr())
    front_blocks.launches += 1
    return co, small


front_blocks.launches = 0


# --------------------------------------------------------------------------
# The quantiser and the rate proxy (enc_device.py:47-84)

def _adjust(q: torch.Tensor, c: int) -> torch.Tensor:
    qb = float(np.float32(1.0 - S.QUANT_BIAS[c]))
    safe = torch.where(q == 0.0, torch.ones_like(q), q)
    return torch.where(q.abs() > 1.0,
                       q - fp.div(float(np.float32(S.QUANT_BIAS_NUM)), safe),
                       q * qb)


def _quantize(ratio: torch.Tensor, c: int, dz: float) -> torch.Tensor:
    q0 = torch.round(ratio)
    best_q = q0
    best_e = (_adjust(q0, c) - ratio).abs()
    for dq in (-1.0, 1.0):
        q = q0 + dq
        e = (_adjust(q, c) - ratio).abs()
        take = e < best_e
        best_q = torch.where(take, q, best_q)
        best_e = torch.where(take, e, best_e)
    return torch.where(ratio.abs() < dz, torch.zeros_like(best_q), best_q)


def ties(ratios: torch.Tensor, deadzone: float, eps: float = 1e-5
         ) -> torch.Tensor:
    """Where the quantiser's decision on (..., 3, n) ratios (channels X, Y,
    B) changes when a ratio moves by eps relative: the values that a sum
    in another order may round the other way."""
    dz = float(np.float32(deadzone))
    out = torch.zeros_like(ratios, dtype=torch.bool)
    for c in range(3):
        r = ratios[..., c, :]
        out[..., c, :] = _quantize(r * (1 + eps), c, dz) != \
            _quantize(r * (1 - eps), c, dz)
    return out


def tie_faults(diff: torch.Tensor, ratios: torch.Tensor, deadzone: float,
               block_dep: bool = False) -> torch.Tensor:
    """Of the values that differ between two quantisations of the same
    (..., 3, n) ratios (diff, channels X, Y, B), those that no tie
    explains: a Y value must sit at a tie itself; an X / B value at a tie
    of its own or where Y at the same coefficient flipped at a tie (the
    X / B targets subtract the dequantised Y), or with block_dep anywhere
    in its block (E4 subtracts the whole reconstructed Y block)."""
    t = ties(ratios, deadzone)
    yflip = diff[..., 1:2, :] & t[..., 1:2, :]
    if block_dep:
        yflip = yflip.any(-1, keepdim=True)
    bad = diff & ~t
    bad[..., 0::2, :] &= ~yflip
    return bad


def _token_cost(vals: torch.Tensor) -> torch.Tensor:
    """Rate proxy (bits) per row of float integers (..., L)."""
    nz = vals != 0
    any_nz = nz.any(-1)
    L = vals.shape[-1]
    pos = torch.arange(1, L + 1, device=vals.device, dtype=torch.int64)
    last = torch.where(nz, pos, torch.zeros_like(pos)).amax(-1)
    bits = torch.where(nz, torch.log2(1.0 + vals.abs()),
                       torch.zeros_like(vals)).sum(-1)
    cnt = nz.sum(-1)
    return torch.where(any_nz, ((2.0 + 1.1 * last.to(torch.float32)) + bits)
                       + cnt.to(torch.float32),
                       torch.full_like(bits, 2.0))


def _weights(cov: int):
    """area * D_c in float32 (area = cov * 64)."""
    return [float(np.float32(cov * 64) * np.float32(d)) for d in D_WEIGHTS]


def _quant_consts(weights) -> np.ndarray:
    """The kernels' quantiser constants: 1 - QUANT_BIAS[c], QUANT_BIAS_NUM
    and the three distortion weights, f32."""
    return np.asarray([*(1.0 - np.asarray(S.QUANT_BIAS, np.float64)),
                       S.QUANT_BIAS_NUM, *weights], np.float64).astype(
        np.float32)


# --------------------------------------------------------------------------
# E3: DCT8 and the aligned candidate shapes

def _shape_of(sid: int, cy: int, cx: int, ys_b: int, xs_b: int):
    nyc, nxc = ys_b // cy, xs_b // cx
    if nyc == 0 or nxc == 0:
        raise ValueError(f"shape {cy}x{cx} blocks does not fit "
                         f"{ys_b}x{xs_b}")
    if sid == 0 and (cy, cx) != (1, 1):
        raise ValueError("DCT8 is one block")
    return nyc, nxc


def dct_costs_plain(src, qf, fx, fb, dq_dc, igs, lam, sid, cy, cx,
                    deadzone, cost_out, return_ratios: bool = False):
    """The twin of dct_costs; return_ratios: also the quantiser's ratios
    (nyc, nxc, 3, tail), to tell quantisation ties."""
    ys_b, xs_b = qf.shape
    nyc, nxc = _shape_of(sid, cy, cx, ys_b, xs_b)
    n = nyc * nxc
    t = _tables(qf.device, ("shape", sid, cy, cx))
    cov = STRATEGIES[sid].covered
    h, w = cy * 8, cx * 8
    if sid == 0:
        flat = src.reshape(3, n, 64).permute(1, 0, 2)
    else:
        reg = src[:, :nyc * h, :nxc * w].reshape(3, nyc, h, nxc, w).permute(
            1, 3, 0, 2, 4).reshape(n, 3, h, w)
        flat = torch.matmul(torch.matmul(t["anaH"], reg),
                            t["anaW"].t()).reshape(n, 3, h * w)
    qfm = qf[:nyc * cy, :nxc * cx].reshape(nyc, cy, nxc, cx).amin(
        dim=(1, 3)).reshape(-1).to(torch.float32)
    qfv = fp.div(qfm, float(np.float32(igs)))
    inv_qac = fp.div(1.0, qfv)[:, None]
    fxa = fx[:nyc * cy:cy, :nxc * cx:cx].reshape(-1)
    fba = fb[:nyc * cy:cy, :nxc * cx:cx].reshape(-1)
    dz = float(np.float32(deadzone))
    A = _weights(cov)
    idx = t["order"].long()
    fY = flat[:, 1][:, idx]
    stepY = t["tab"][1][None] * inv_qac
    ratios = [None, fp.div(fY, stepY), None]
    qy = _quantize(ratios[1], 1, dz)
    dqY = _adjust(qy, 1) * stepY
    dist = A[1] * ((dqY - fY) ** 2).sum(-1)
    vals = [None, qy, None]
    for c, f in ((0, fxa), (2, fba)):
        tgt = flat[:, c][:, idx]
        sub = tgt - f[:, None] * dqY
        step = t["tab"][c][None] * inv_qac
        ratios[c] = fp.div(sub, step)
        q = _quantize(ratios[c], c, dz)
        rec = _adjust(q, c) * step + f[:, None] * dqY
        dist = dist + A[c] * ((rec - tgt) ** 2).sum(-1)
        vals[c] = q
    dqb = dq_dc[:, :nyc * cy, :nxc * cx].reshape(3, nyc, cy, nxc, cx).permute(
        1, 3, 0, 2, 4).reshape(n, 3, cy, cx)
    if sid == 0:
        llf = dqb.reshape(n, 3, 1) * 1.0
    else:
        llf = (torch.matmul(torch.matmul(t["anY"], dqb), t["anX"].t())
               * t["rs"]).reshape(n, 3, cov)
    tl = flat[:, :, t["pos"].long()]
    d2 = ((llf - tl) ** 2).sum(-1)
    for c in range(3):
        dist = dist + A[c] * d2[:, c]
    v = torch.stack(vals, dim=1)
    rate = _token_cost(v).sum(-1)
    cost_out.copy_(rate + float(np.float32(lam)) * dist)
    out = v.to(torch.int16).reshape(nyc, nxc, 3, -1)
    if return_ratios:
        return out, torch.stack(ratios, dim=1).reshape(nyc, nxc, 3, -1)
    return out


def dct_costs(src: torch.Tensor, qf: torch.Tensor, fx: torch.Tensor,
              fb: torch.Tensor, dq_dc: torch.Tensor, igs: float, lam: float,
              sid: int, cy: int, cx: int, deadzone: float,
              cost_out: torch.Tensor) -> torch.Tensor:
    """One transform shape at every aligned position: `src` is E2's co
    (3, ys_b, xs_b, 8, 8) for DCT8 (sid 0) or the (3, ph, pw) planes for a
    cy x cx block candidate; qf (ys_b, xs_b) int32, fx / fb the per-block
    CfL factors and dq_dc (3, ys_b, xs_b) the dequantised DC means, f32.
    Returns the quantised scan tails (nyc, nxc, 3, num_coeffs - covered)
    int16 and writes each varblock's cost (rate + lam * distortion) into
    cost_out (nyc * nxc f32)."""
    dev = qf.device
    ys_b, xs_b = qf.shape
    nyc, nxc = _shape_of(sid, cy, cx, ys_b, xs_b)
    _check(qf, "qf", torch.int32, (ys_b, xs_b), dev)
    for name, t_ in (("fx", fx), ("fb", fb)):
        _check(t_, name, torch.float32, (ys_b, xs_b), dev)
    _check(dq_dc, "dq_dc", torch.float32, (3, ys_b, xs_b), dev)
    _check(src, "src", torch.float32,
           (3, ys_b, xs_b, 8, 8) if sid == 0 else (3, ys_b * 8, xs_b * 8),
           dev)
    _check(cost_out, "cost_out", torch.float32, (nyc * nxc,), dev)
    if dev.type == "cpu":
        return dct_costs_plain(src, qf, fx, fb, dq_dc, igs, lam, sid, cy,
                               cx, deadzone, cost_out)
    _build.check_aligned(src, "src")
    t = _tables(dev, ("shape", sid, cy, cx))
    tail = STRATEGIES[sid].num_coeffs - STRATEGIES[sid].covered
    vals = torch.empty((nyc, nxc, 3, tail), dtype=torch.int16, device=dev)
    qk = _quant_consts(_weights(STRATEGIES[sid].covered))
    tabs = np.asarray([t["anaH"].data_ptr(), t["anaW"].data_ptr(),
                       t["order"].data_ptr(), t["tab"].data_ptr(),
                       t["pos"].data_ptr(), t["anY"].data_ptr(),
                       t["anX"].data_ptr(), t["rs"].data_ptr()], np.uint64)
    _build.launch(_kernels()["dct_costs"], dev, src.data_ptr(),
                  qf.data_ptr(), fx.data_ptr(), fb.data_ptr(),
                  dq_dc.data_ptr(), tabs.ctypes.data, vals.data_ptr(),
                  ys_b, xs_b, cy, cx, float(np.float32(igs)),
                  float(np.float32(lam)), float(np.float32(deadzone)),
                  cost_out.data_ptr(), STRATEGIES[sid].covered, tail,
                  qk.ctypes.data)
    dct_costs.launches += 1
    return vals


dct_costs.launches = 0


# --------------------------------------------------------------------------
# E4: the same-size special transforms

def special_costs_plain(planes, qf, fx, fb, dq_dc, igs, lam, elig, sid,
                        deadzone, cost_out, return_ratios: bool = False):
    """The twin of special_costs; return_ratios: also the quantiser's
    ratios (ys_b, xs_b, 3, 63)."""
    ys_b, xs_b = qf.shape
    n = ys_b * xs_b
    r0, R1, A = _tables(qf.device, ("special", sid))
    blocks_pix = planes.reshape(3, ys_b, 8, xs_b, 8).permute(
        1, 3, 0, 2, 4).reshape(n, 3, 64)
    dcb = dq_dc.permute(1, 2, 0).reshape(n, 3)
    qff = fp.div(qf.reshape(-1).to(torch.float32), float(np.float32(igs)))
    inv_qac = fp.div(1.0, qff)[:, None]
    fxr, fbr = fx.reshape(-1), fb.reshape(-1)
    dz = float(np.float32(deadzone))
    W = [float(np.float32(d)) for d in D_WEIGHTS]
    t1 = blocks_pix[:, 1] - dcb[:, 1, None] * r0[1][None]
    gY = torch.matmul(t1, A[1])
    ratios = [None, fp.div(gY, inv_qac), None]
    qy = _quantize(ratios[1], 1, dz)
    dqY = _adjust(qy, 1) * inv_qac
    recY = torch.matmul(dqY, R1[1])
    dist = W[1] * ((recY - t1) ** 2).sum(-1)
    vals = [None, qy, None]
    for c, f in ((0, fxr), (2, fbr)):
        tc = blocks_pix[:, c] - dcb[:, c, None] * r0[c][None]
        sub = tc - f[:, None] * recY
        g = torch.matmul(sub, A[c])
        ratios[c] = fp.div(g, inv_qac)
        q = _quantize(ratios[c], c, dz)
        rec = torch.matmul(_adjust(q, c) * inv_qac, R1[c]) \
            + f[:, None] * recY
        dist = dist + W[c] * ((rec - tc) ** 2).sum(-1)
        vals[c] = q
    vs = torch.stack(vals, dim=1)
    rate = _token_cost(vs).sum(-1)
    e = elig.reshape(-1)
    cost_out.copy_(torch.where(e, rate + float(np.float32(lam)) * dist,
                               torch.full_like(rate, 1e30)))
    vs = torch.where(e[:, None, None], vs, torch.zeros_like(vs))
    out = vs.to(torch.int16).reshape(ys_b, xs_b, 3, 63)
    if return_ratios:
        return out, torch.stack(ratios, dim=1).reshape(ys_b, xs_b, 3, 63)
    return out


def special_costs(planes: torch.Tensor, qf: torch.Tensor, fx: torch.Tensor,
                  fb: torch.Tensor, dq_dc: torch.Tensor, igs: float,
                  lam: float, elig: torch.Tensor, sid: int, deadzone: float,
                  cost_out: torch.Tensor) -> torch.Tensor:
    """One special transform (sid of IDENTITY, DCT2X2, DCT4X4, DCT4X8,
    DCT8X4) on every 8x8 block: the planes' pixels minus the DC response,
    analysed by the least-squares inverse A and reconstructed by R1 to
    measure pixel-domain distortion.  elig (ys_b, xs_b) bool: blocks
    outside it get cost 1e30 and zero values.  Returns (ys_b, xs_b, 3, 63)
    int16 and writes the costs into cost_out (ys_b * xs_b f32)."""
    dev = qf.device
    ys_b, xs_b = qf.shape
    if sid == 0 or STRATEGIES[sid].covered != 1 or \
            STRATEGIES[sid].num_coeffs != 64:
        raise ValueError(f"sid {sid} is not a same-size special transform")
    _check(planes, "planes", torch.float32, (3, ys_b * 8, xs_b * 8), dev)
    _check(qf, "qf", torch.int32, (ys_b, xs_b), dev)
    for name, t_ in (("fx", fx), ("fb", fb)):
        _check(t_, name, torch.float32, (ys_b, xs_b), dev)
    _check(dq_dc, "dq_dc", torch.float32, (3, ys_b, xs_b), dev)
    _check(elig, "elig", torch.bool, (ys_b, xs_b), dev)
    _check(cost_out, "cost_out", torch.float32, (ys_b * xs_b,), dev)
    if dev.type == "cpu":
        return special_costs_plain(planes, qf, fx, fb, dq_dc, igs, lam,
                                   elig, sid, deadzone, cost_out)
    _build.check_aligned(planes, "planes")
    r0, R1, A = _tables(dev, ("special", sid))
    vals = torch.empty((ys_b, xs_b, 3, 63), dtype=torch.int16, device=dev)
    mats = np.asarray([r0.data_ptr(), R1.data_ptr(), A.data_ptr()],
                      np.uint64)
    qk = _quant_consts([float(np.float32(d)) for d in D_WEIGHTS])
    _build.launch(_kernels()["special_costs"], dev, planes.data_ptr(),
                  qf.data_ptr(), fx.data_ptr(), fb.data_ptr(),
                  dq_dc.data_ptr(), elig.data_ptr(), mats.ctypes.data,
                  ys_b, xs_b, float(np.float32(igs)),
                  float(np.float32(lam)), float(np.float32(deadzone)),
                  vals.data_ptr(), cost_out.data_ptr(), qk.ctypes.data)
    special_costs.launches += 1
    return vals


special_costs.launches = 0


# --------------------------------------------------------------------------
# The winners' gather

def gather_rows_plain(sources, idxs):
    """The twin of gather_rows."""
    parts = [s.reshape(-1, s.shape[2] * s.shape[3])[
        ix.long().clamp(0, s.shape[0] * s.shape[1] - 1)].reshape(-1)
        for s, ix in zip(sources, idxs)]
    if not parts:
        return torch.zeros(0, dtype=torch.int16)
    return torch.cat(parts)


def gather_rows(sources: Sequence[torch.Tensor],
                idxs: Sequence[torch.Tensor]) -> torch.Tensor:
    """sources[k] (ny, nx, 3, tail_k) int16, idxs[k] int32 row indices
    (row = y * nx + x; clipped into the source, jnp.take's mode="clip")
    on the same device -> every source's selected rows, in order, back to
    back (flat int16).  Raises ValueError for rows taken from a source
    without rows; on the card also for an output of 2^31 elements or more
    (the kernel's flat walk counts elements in 32 bits)."""
    if len(sources) != len(idxs) or len(sources) > MAX_SOURCES:
        raise ValueError(f"{len(sources)} sources, {len(idxs)} index "
                         f"lists: expected equal counts up to {MAX_SOURCES}")
    dev = sources[0].device if sources else torch.device("cpu")
    for s, ix in zip(sources, idxs):
        if s.dtype != torch.int16 or s.dim() != 4 or s.shape[2] != 3 or \
                not s.is_contiguous() or s.device != dev:
            raise ValueError("sources: expected contiguous (ny, nx, 3, "
                             "tail) int16 on one device")
        if ix.dtype != torch.int32 or ix.dim() != 1 or ix.device != dev:
            raise ValueError("idxs: expected 1-D int32 on the sources' "
                             "device")
        if ix.numel() and s.shape[0] * s.shape[1] == 0:
            raise ValueError("idxs: rows taken from a source without rows")
    if dev.type == "cpu":
        return gather_rows_plain(sources, idxs)
    lens = [int(ix.numel()) * 3 * int(s.shape[3])
            for s, ix in zip(sources, idxs)]
    if sum(lens) >= 1 << 31:
        raise ValueError(f"an output of {sum(lens)} elements: the kernel "
                         f"takes fewer than 2^31")
    out = torch.empty(sum(lens), dtype=torch.int16, device=dev)
    if sum(lens):
        # the kernel stores whole 16-byte vectors
        _build.check_aligned(out, "out")
        # per source: src, idx, rows, row length, rows in the source, out
        desc = np.zeros((len(sources), 6), np.int64)
        off = 0
        for k, (s, ix) in enumerate(zip(sources, idxs)):
            desc[k] = (s.data_ptr(), ix.data_ptr(), ix.numel(),
                       3 * s.shape[3], s.shape[0] * s.shape[1], off)
            off += lens[k]
        _build.launch(_kernels()["gather_rows"], dev, desc.ctypes.data,
                      len(sources), out.data_ptr())
        gather_rows.launches += 1
    return out


gather_rows.launches = 0
