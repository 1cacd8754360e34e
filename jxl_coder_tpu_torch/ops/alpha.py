"""Alpha association ops, on the device (``jxl_coder_tpu/ops/alpha.py``:
RGBAlpha.cpp:37-118 and ScanAlpha).

Kernels of S4's source (``csrc/pixel_ops.cu``): ``alpha_u8_kernel`` and
``alpha_f32_kernel`` premultiply or unpremultiply (..., 4) pixels, uint8
with the reference's integer rounding ((v * a + 127) / 255 and (v * 255 + a / 2)
/ a, 0 where a is 0) or float32 (v * a, and v / max(a, 1e-9) where a > 0,
else 0); ``scan_kernel`` is ``has_transparency``.  The JAX package has no
caller of them; they are API surface.  Each wrapper counts its launches
in ``.launches``; on a CPU tensor it runs its plain twin, on a CUDA tensor
it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build

PREMULTIPLY, UNPREMULTIPLY = 0, 1
_DTYPES = {torch.uint8: 0, torch.uint16: 1, torch.float32: 2}


@functools.lru_cache(maxsize=None)
def _kernels():
    lib = _build.load("pixel_ops")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    return (_build.bind(lib, "jxl_alpha", [p, p, i, ll, i]),
            _build.bind(lib, "jxl_scan_alpha", [p, i, ll, p]))


def associate_plain(rgba: torch.Tensor, op: int) -> torch.Tensor:
    """The twin of associate."""
    if rgba.dtype == torch.uint8:
        v = rgba.to(torch.int64)
        a = v[..., 3:4]
        if op == PREMULTIPLY:
            rgb = torch.div(v[..., :3] * a + 127, 255, rounding_mode="floor")
        else:
            safe = torch.clamp_min(a, 1)
            rgb = torch.clamp_max(torch.div(
                v[..., :3] * 255 + torch.div(safe, 2, rounding_mode="floor"),
                safe, rounding_mode="floor"), 255)
            rgb = torch.where(a == 0, torch.zeros_like(rgb), rgb)
        return torch.cat([rgb, a], -1).to(torch.uint8)
    a = rgba[..., 3:4]
    if op == PREMULTIPLY:
        rgb = rgba[..., :3] * a
    else:
        rgb = torch.where(a > 0, rgba[..., :3] / torch.clamp_min(a, 1e-9),
                          torch.zeros_like(rgba[..., :3]))
    return torch.cat([rgb, a], -1)


def associate(rgba: torch.Tensor, op: int) -> torch.Tensor:
    """(..., 4) uint8 or float32 pixels premultiplied (op PREMULTIPLY) or
    unpremultiplied (UNPREMULTIPLY) by their alpha."""
    if rgba.dtype not in (torch.uint8, torch.float32) or \
            rgba.dim() < 1 or rgba.shape[-1] != 4 or op not in (0, 1):
        raise ValueError(f"rgba: expected (..., 4) uint8 or float32, got "
                         f"{tuple(rgba.shape)} {rgba.dtype} (op {op})")
    if rgba.device.type == "cpu":
        return associate_plain(rgba, op)
    rgba = rgba.contiguous()
    out = torch.empty_like(rgba)
    n = rgba.numel() // 4
    if n:
        _build.launch(_kernels()[0], rgba.device, rgba.data_ptr(),
                      out.data_ptr(), _DTYPES[rgba.dtype], n, op)
        associate.launches += 1
    return out


associate.launches = 0


def premultiply_u8(rgba: torch.Tensor) -> torch.Tensor:
    """(..., 4) uint8 unassociated -> associated ((v * a + 127) / 255)."""
    _require(rgba, torch.uint8)
    return associate(rgba, PREMULTIPLY)


def unpremultiply_u8(rgba: torch.Tensor) -> torch.Tensor:
    """(..., 4) uint8 associated -> unassociated ((v * 255 + a/2) / a)."""
    _require(rgba, torch.uint8)
    return associate(rgba, UNPREMULTIPLY)


def premultiply_f(rgba: torch.Tensor) -> torch.Tensor:
    _require(rgba, torch.float32)
    return associate(rgba, PREMULTIPLY)


def unpremultiply_f(rgba: torch.Tensor) -> torch.Tensor:
    _require(rgba, torch.float32)
    return associate(rgba, UNPREMULTIPLY)


def _require(t: torch.Tensor, dtype: torch.dtype) -> None:
    if t.dtype != dtype:
        raise ValueError(f"expected {dtype}, got {t.dtype}")


def has_transparency_plain(alpha: torch.Tensor) -> bool:
    """The twin of has_transparency."""
    if alpha.dtype == torch.float32:
        return bool((alpha < 1.0).any())
    return bool((alpha.to(torch.int64)
                 != (255 if alpha.dtype == torch.uint8 else 65535)).any())


def has_transparency(alpha: torch.Tensor) -> bool:
    """ScanAlpha: does any pixel have non-opaque alpha (uint8 / uint16
    below the type's maximum, float32 below 1).  Waits for the card."""
    if alpha.dtype not in _DTYPES:
        raise ValueError(f"alpha: expected uint8, uint16 or float32, got "
                         f"{alpha.dtype}")
    if alpha.device.type == "cpu":
        return has_transparency_plain(alpha)
    alpha = alpha.contiguous()
    flag = torch.zeros(1, dtype=torch.int32, device=alpha.device)
    if alpha.numel():
        _build.launch(_kernels()[1], alpha.device, alpha.data_ptr(),
                      _DTYPES[alpha.dtype], alpha.numel(), flag.data_ptr())
        has_transparency.launches += 1
    return bool(flag.item())


has_transparency.launches = 0
