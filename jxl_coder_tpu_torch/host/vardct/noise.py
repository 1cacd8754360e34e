"""Noise synthesis (FrameHeader flag kNoise), decode side: the port's
copy of ``jxl_coder_tpu/vardct/noise.py``, numpy only.  ``noise_planes``
advances every group's generator at once (the original walks the groups
one after another); its planes are the original's bit for bit.

The original's notes:

Every constant below was pinned numerically against libjxl 0.7 output
(research notes; the probe method: decode a noise stream without the
noise stage, subtract from libjxl's float output in XYB, and solve the
linear system for the generator/convolution/mixing):

- RNG: Xorshift128Plus with 8 independent lanes, SplitMix64 seeding
  (lib/jxl/xorshift128plus-inl.h), seeded per 256x256 group with
  (visible_frame_index=1, nonvisible_frame_index=0, x0, y0) where
  x0/y0 are the group origin in pixels.
- Three planes (r, g, cor) are generated sequentially from one rng;
  each row consumes ceil((group_w + 2) / 16) batches of 16 floats
  (one u64 -> two u32 little-endian; float = ((u >> 9) | 0x3F800000)
  viewed as f32, minus 1.5 -> [-0.5, 0.5)).
- Only the first group_w columns are used; groups stitch into
  full-image planes, then a 5x5 subtract-box convolution
  (center - box_sum/25) runs over the full image with mirrored
  borders.
- Per-pixel strength: piecewise-linear 8-knot lut over intensity
  (scale 6, flat extrapolation), evaluated at (Y+X)/2 for red and
  (Y-X)/2 for green.
- Mixing: red = sr*(conv_cor + conv_r/128), green likewise with g;
  X += k0*(red - green), Y += k0*(red + green), B += k0*(red+green),
  k0 = -0.8730846 (fit residual at the decoder's float noise floor).
"""

from __future__ import annotations

import numpy as np

NOISE_K0 = -0.8730846
GROUP_DIM = 256
_M64 = np.uint64(0xFFFFFFFFFFFFFFFF)


def _splitmix64(z: np.ndarray) -> np.ndarray:
    with np.errstate(over="ignore"):
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


def _init_state(seed1: int, seed2: int, seed3: int, seed4: int):
    s0 = np.zeros(8, np.uint64)
    s1 = np.zeros(8, np.uint64)
    golden = 0x9E3779B97F4A7C15
    s0[0] = _splitmix64(np.uint64((((seed1 << 32) + seed2) + golden)
                                  & 0xFFFFFFFFFFFFFFFF))
    s1[0] = _splitmix64(np.uint64((((seed3 << 32) + seed4) + golden)
                                  & 0xFFFFFFFFFFFFFFFF))
    for i in range(1, 8):
        s0[i] = _splitmix64(s0[i - 1])
        s1[i] = _splitmix64(s1[i - 1])
    return s0, s1


def _floats(out: np.ndarray) -> np.ndarray:
    """(nbatches, 8) uint64 generator outputs -> (nbatches, 16) float32
    in [-0.5, 0.5)."""
    u32 = np.empty((out.shape[0], 16), np.uint32)
    u32[:, 0::2] = (out & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    u32[:, 1::2] = (out >> np.uint64(32)).astype(np.uint32)
    f = ((u32 >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32)
    return f - np.float32(1.5)


def noise_planes(width: int, height: int,
                 visible_frame_index: int = 1,
                 nonvisible_frame_index: int = 0) -> np.ndarray:
    """(3, H, W) stitched random planes for the frame."""
    groups = [(x0, y0, min(GROUP_DIM, width - x0), min(GROUP_DIM, height - y0))
              for y0 in range(0, height, GROUP_DIM)
              for x0 in range(0, width, GROUP_DIM)]
    planes = np.empty((3, height, width), np.float32)
    if not groups:
        return planes
    # every group's Xorshift128+ state, one row a group, stepped together
    init = [_init_state(visible_frame_index, nonvisible_frame_index, x0, y0)
            for x0, y0, _, _ in groups]
    s0 = np.stack([a for a, _ in init])
    s1 = np.stack([b for _, b in init])
    counts = [-(-(gw + 2) // 16) * gh * 3 for _, _, gw, gh in groups]
    out = np.empty((max(counts), len(groups), 8), np.uint64)
    with np.errstate(over="ignore"):
        for k in range(out.shape[0]):
            a, b = s0, s1
            out[k] = a + b
            s0 = b
            a = a ^ (a << np.uint64(23))
            s1 = a ^ b ^ (a >> np.uint64(18)) ^ (b >> np.uint64(5))
    for g, (x0, y0, gw, gh) in enumerate(groups):
        f = _floats(out[:counts[g], g])
        f = f.reshape(3, gh, -(-(gw + 2) // 16) * 16)
        planes[:, y0:y0 + gh, x0:x0 + gw] = f[:, :, :gw]
    return planes


def _conv_subbox(p: np.ndarray) -> np.ndarray:
    """center - 5x5 box sum / 25, mirrored borders."""
    pad = np.pad(p, 2, mode="symmetric")
    win = np.lib.stride_tricks.sliding_window_view(pad, (5, 5))
    return p - win.sum(axis=(2, 3), dtype=np.float32) / np.float32(25.0)


def _strength(lut: np.ndarray, v: np.ndarray) -> np.ndarray:
    """8-knot piecewise-linear lut over intensity (noise.h IndexAndFrac:
    scale = kNumNoisePoints-2 = 6, clamp below 0, flat beyond knot 7)."""
    sc = np.maximum(0.0, v * 6.0)
    idx = np.floor(sc).astype(np.int32)
    frac = sc - idx
    over = sc >= 7.0
    idx = np.where(over, 6, np.minimum(idx, 6))
    frac = np.where(over, 1.0, frac)
    lut = np.asarray(lut, np.float32)
    return lut[idx] * (1.0 - frac) + lut[np.minimum(idx + 1, 7)] * frac


def add_noise(X: np.ndarray, Y: np.ndarray, B: np.ndarray, lut,
              visible_frame_index: int = 1):
    """Apply synthesized noise in place on the XYB planes (full frame)."""
    h, w = Y.shape
    planes = noise_planes(w, h, visible_frame_index)
    conv_r = _conv_subbox(planes[0])
    conv_g = _conv_subbox(planes[1])
    conv_cor = _conv_subbox(planes[2])
    sr = _strength(lut, (Y + X) * 0.5)
    sg = _strength(lut, (Y - X) * 0.5)
    red = sr * (conv_cor + conv_r / np.float32(128.0))
    green = sg * (conv_cor + conv_g / np.float32(128.0))
    k0 = np.float32(NOISE_K0)
    X += k0 * (red - green)
    Y += k0 * (red + green)
    B += k0 * (red + green)
    return X, Y, B


def read_noise_lut(br) -> list:
    """NoiseParameters: 8 x 10-bit fixed-point lut values."""
    return [br.u(10) / 1024.0 for _ in range(8)]
