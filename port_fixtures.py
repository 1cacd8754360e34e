"""Seeded inputs for checking the PyTorch port (jxl_coder_tpu_torch):
images to encode and synthetic strategy families.  Used by
tests/test_torch_*.py and chip_smoke.py; imports no JAX.
"""

from __future__ import annotations

import numpy as np

from jxl_coder_tpu_torch import reference as R


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
