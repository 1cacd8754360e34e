"""8x8 DCT / IDCT of the round-1 VarDCT codec
(``jxl_coder_tpu/vardct/dct.py:25-69``).

The JAX package runs these as f32 ``einsum``s outside any Pallas kernel;
here they are elementwise PyTorch ops summed in XLA's CPU order
(``fp.matmul``), so the encoder's quantised integers match the JAX
package's; no TF32 path can touch them.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..ops.fp import matmul


@functools.lru_cache(maxsize=None)
def dct_matrix(n: int) -> np.ndarray:
    """Orthonormal DCT-II basis: M @ x performs the forward DCT."""
    k = np.arange(n)[:, None]
    i = np.arange(n)[None, :]
    m = np.cos(np.pi * k * (2 * i + 1) / (2 * n)) * np.sqrt(2.0 / n)
    m[0] *= np.sqrt(0.5)
    return m.astype(np.float32)


def _mat(m: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(m)).to(like.device)


def dct2d(blocks: torch.Tensor) -> torch.Tensor:
    """Forward 2D DCT over the last two dims: (..., H, W) -> (..., H, W)."""
    mh = dct_matrix(blocks.shape[-2])
    mw = dct_matrix(blocks.shape[-1])
    t = matmul(_mat(mh, blocks), blocks)
    return matmul(t, _mat(mw.T, blocks))


def idct2d(coeffs: torch.Tensor) -> torch.Tensor:
    """Inverse 2D DCT over the last two dims (transpose of dct2d)."""
    mh = dct_matrix(coeffs.shape[-2])
    mw = dct_matrix(coeffs.shape[-1])
    t = matmul(_mat(mh.T, coeffs), coeffs)
    return matmul(t, _mat(mw, coeffs))


def blockify(img: torch.Tensor, bs: int = 8) -> torch.Tensor:
    """(C, H, W) -> (C, H//bs, W//bs, bs, bs)."""
    c, h, w = img.shape
    return img.reshape(c, h // bs, bs, w // bs, bs).permute(0, 1, 3, 2, 4)


def unblockify(blocks: torch.Tensor) -> torch.Tensor:
    """(C, nY, nX, bs, bs) -> (C, nY*bs, nX*bs)."""
    c, ny, nx, bs, _ = blocks.shape
    return blocks.permute(0, 1, 3, 2, 4).reshape(c, ny * bs, nx * bs)
