"""Transform synthesis for VarDCT reconstruction.

Convention (pinned numerically against the reference decoder): a WxH
transform's basis is the separable cosine family
  psi[ky,kx](y,x) = a(ky) cos(pi (2y+1) ky / 2H) a(kx) cos(...)
with a(0)=1, a(k)=sqrt(2); the DC basis function is constant 1 (DC =
block mean).  The lowest cy*cx frequencies of a multi-block transform
are not coded; they are produced from the DC image by a scaled DCT on
the covered-block grid with per-frequency resampling factors
  rs_N(i) = 1 / (cos(i pi/(16N)) cos(i pi/(8N)) cos(i pi/(4N)))
(cf. dct_scales.h generator formula; validated by probe streams).

Calibrated data (scan->basis maps, dequant tables, small-transform
response matrices) lives in calib_real.npz next to this file.
"""

from __future__ import annotations

import functools
import os

import numpy as np


@functools.lru_cache(maxsize=None)
def cos_basis(n: int) -> np.ndarray:
    """A[k, x] = a(k) cos(pi (2x+1) k / (2n)); synthesis f = A.T @ c."""
    k = np.arange(n)[:, None]
    x = np.arange(n)[None, :]
    a = np.where(k == 0, 1.0, np.sqrt(2.0))
    return a * np.cos(np.pi * (2 * x + 1) * k / (2 * n))


@functools.lru_cache(maxsize=None)
def ana_basis(n: int) -> np.ndarray:
    """Forward (analysis) with DC = mean: M such that c = M @ f."""
    return np.linalg.inv(cos_basis(n).T)


@functools.lru_cache(maxsize=None)
def resample_vec(n: int) -> np.ndarray:
    """Upsampling scales rs_n(i), i < n (from n DC samples to 8n)."""
    i = np.arange(n)
    down = (np.cos(i * np.pi / (16 * n)) * np.cos(i * np.pi / (8 * n))
            * np.cos(i * np.pi / (4 * n)))
    return 1.0 / down


def llf_from_dc(dc_block: np.ndarray) -> np.ndarray:
    """DC values (cy, cx) -> lowest-frequency coefficients (cy, cx)."""
    cy, cx = dc_block.shape
    c = ana_basis(cy) @ dc_block @ ana_basis(cx).T
    return c * np.outer(resample_vec(cy), resample_vec(cx))


_CALIB = None

# The decoder shrinks quantized AC values toward zero before dequant
# (AdjustQuantBias: |q|==1 -> 1-bias[c], else q - 0.145/q; pinned with
# single-coefficient probes in research/, matching to 1e-5).  The
# calibration probes in research/strategy_calib.py used q=16, so every
# stored table/response absorbed the factor (16 - 0.145/16)/16; divide
# it back out at load so tables hold the TRUE per-unit step.
QUANT_BIAS = (0.05465007330715401,     # X
              0.07005449891748593,     # Y
              0.049935103337343655)    # B
QUANT_BIAS_NUM = 0.145
_CALIB_AMP_FACTOR = 1.0 - QUANT_BIAS_NUM / (16.0 * 16.0)


_BIAS_LUT_R = 4096
_BIAS_LUT = None


def _bias_luts():
    global _BIAS_LUT
    if _BIAS_LUT is None:
        q = np.arange(-_BIAS_LUT_R, _BIAS_LUT_R + 1, dtype=np.float64)
        safe = np.where(q == 0.0, 1.0, q)
        big = q - QUANT_BIAS_NUM / safe
        _BIAS_LUT = np.stack([
            np.where(np.abs(q) > 1.0, big, q * (1.0 - QUANT_BIAS[c]))
            for c in range(3)])
    return _BIAS_LUT


def adjust_quant_bias(vals: np.ndarray, c: int) -> np.ndarray:
    """AdjustQuantBias over an integer coefficient array (any shape)."""
    v = np.asarray(vals)
    if v.dtype.kind in "iu":
        vi = v if v.dtype == np.int64 else v.astype(np.int64)
        if not vi.size or abs(int(vi.max(initial=0))) <= _BIAS_LUT_R \
                and abs(int(vi.min(initial=0))) <= _BIAS_LUT_R:
            return _bias_luts()[c][vi + _BIAS_LUT_R]
    v = v.astype(np.float64)
    safe = np.where(v == 0.0, 1.0, v)
    return np.where(np.abs(v) > 1.0, v - QUANT_BIAS_NUM / safe,
                    v * (1.0 - QUANT_BIAS[c]))


def calib():
    global _CALIB
    if _CALIB is None:
        path = os.path.join(os.path.dirname(__file__), "calib_real.npz")
        raw = dict(np.load(path, allow_pickle=False))
        for k, a in raw.items():
            if k.startswith("table_"):
                raw[k] = a / _CALIB_AMP_FACTOR
            elif k.startswith("resp_"):
                # row 0 is the per-unit-float DC response: no bias there
                a = a.copy()
                a[:, 1:] = a[:, 1:] / _CALIB_AMP_FACTOR
                raw[k] = a
        _CALIB = raw
    return _CALIB


def scan_to_basis(strategy_id: int) -> np.ndarray:
    """scan position -> basis index ky*W+kx (length covered*64); the
    first `covered` entries are the LLF raster positions."""
    return calib()[f"order_{strategy_id}"]


def dequant_table(strategy_id: int, c: int) -> np.ndarray:
    """Dequant step per basis index at inv_qac=1 and qm=1 (per
    strategy id: transposed variants have transposed tables)."""
    return calib()[f"table_{strategy_id}"][c]


def response_matrix(strategy_id: int, c: int) -> np.ndarray:
    """For cov==1 special transforms: (64 scan, 8, 8) pixel response
    per unit quantized int at inv_qac=1, qm=1.  Row 0 is the response
    per unit *float* DC (from the DC image)."""
    return calib()[f"resp_{strategy_id}"][c]
