"""Frame upsampling (2x/4x/8x), the decode-side `Upsampler`: the port's copy of
``jxl_coder_tpu/ops/upsample.py`` (numpy), with its calibrated kernels
(``upsample_calib.npz``) beside it.

The original's notes:

Frame upsampling (2x/4x/8x) — the decode-side `Upsampler`.

JXL frames may be coded at a fraction of the signalled size
(`FrameHeader.upsampling`, per-extra-channel `ec_upsampling`); the
decoder scales them back up with 5x5 kernels derived from a symmetric
(5*N/2)^2 weight matrix (ImageMetadata CustomTransformData up2/4/8
weights, defaults below).  Each output sample is additionally clamped
to the [min, max] of its 5x5 source window (pinned empirically: the
clamp is what keeps ringing off hard edges).

Reference parity: libjxl's Upsampler as exercised through
JxlEncoderFrameSettingsSetOption(RESAMPLING) streams; the default up2
weights and the mirror-boundary/window-clamp behaviour were pinned
numerically against libjxl decode output (least-squares kernel
recovery + exact uint8 comparison).
"""

from __future__ import annotations

import numpy as np

# Default up2_weight (15 values = upper triangle of the symmetric 5x5
# phase-(0,0) kernel).  Other phases are mirrors.
DEFAULT_UP2 = (
    -0.01716200, -0.03452303, -0.04022174, -0.02921014, -0.00624645,
    0.14111091, 0.28896755, 0.00278718, -0.01610267, 0.56661550,
    0.03777607, -0.01986694, -0.03144731, -0.01185068, -0.00213539)

# up4/up8 default kernels are recovered numerically (least squares on
# libjxl decode output, research/upsample_calib.py) and stored as full
# (n, n, 5, 5) phase kernels in upsample_calib.npz next to this file;
# loaded lazily below.
DEFAULT_UP4 = None
DEFAULT_UP8 = None


def _kernels_from_weights(weights, n: int) -> np.ndarray:
    """(n, n, 5, 5) phase kernels from the triangular weight vector.

    The (5*n/2)^2 symmetric matrix is tiled into (n/2)^2 base 5x5
    kernels (block layout); phases in the other quadrants are
    mirrors."""
    half = n // 2
    m = 5 * half
    mat = np.zeros((m, m))
    t = 0
    for a in range(m):
        for b in range(a, m):
            mat[a, b] = mat[b, a] = weights[t]
            t += 1
    assert t == len(weights)
    ker = np.zeros((n, n, 5, 5))
    for py in range(half):
        for px in range(half):
            ker[py, px] = mat[5 * py:5 * py + 5, 5 * px:5 * px + 5]
    for py in range(n):
        for px in range(n):
            src_y = py if py < half else None
            k = ker[py if py < half else n - 1 - py,
                    px if px < half else n - 1 - px]
            if py >= half:
                k = k[::-1, :]
            if px >= half:
                k = k[:, ::-1]
            ker[py, px] = k
    # normalize each phase to sum 1 (libjxl Upsampler::Init)
    for py in range(n):
        for px in range(n):
            s = ker[py, px].sum()
            if s != 0:
                ker[py, px] = ker[py, px] / s
    return ker


_KERNEL_CACHE = {}


def _kernels(n: int, weights=None) -> np.ndarray:
    key = (n, weights)
    if key not in _KERNEL_CACHE:
        if weights is not None:
            _KERNEL_CACHE[key] = _kernels_from_weights(weights, n)
        elif n == 2:
            _KERNEL_CACHE[key] = _kernels_from_weights(DEFAULT_UP2, 2)
        else:
            import os
            path = os.path.join(os.path.dirname(__file__),
                                "upsample_calib.npz")
            data = np.load(path)
            _KERNEL_CACHE[key] = data[f"up{n}"]
    return _KERNEL_CACHE[key]


def upsample_plane(plane: np.ndarray, n: int, weights=None,
                   out_h: int = None, out_w: int = None) -> np.ndarray:
    """Upsample (H, W) float plane by n (2/4/8) with 5x5 phase kernels,
    mirrored borders and per-window min/max clamping."""
    if n == 1:
        return plane
    ker = _kernels(n, weights)
    h, w = plane.shape
    pad = np.pad(plane.astype(np.float32), 2, mode="symmetric")
    win = np.lib.stride_tricks.sliding_window_view(pad, (5, 5))
    # win: (H, W, 5, 5); kernels: (n, n, 5, 5)
    out = np.einsum("hwij,pqij->hpwq", win,
                    ker.astype(np.float32), optimize=True)
    lo = win.min(axis=(2, 3))
    hi = win.max(axis=(2, 3))
    out = np.clip(out, lo[:, None, :, None], hi[:, None, :, None])
    out = out.reshape(h * n, w * n)
    if out_h is not None:
        out = out[:out_h, :out_w]
    return out
