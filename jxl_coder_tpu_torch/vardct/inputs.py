"""The parsed frame carried onto a torch device.

``pack`` is the per-strategy family packing on the host (the JAX
package's ``tpu_full.prepare_exec``: numpy and its native packer, no
JAX); ``from_prepared`` turns its output into the port's tensors, so the
port and the reference consume identical inputs.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from jxl_coder_tpu.vardct.tpu_full import prepare_exec


@dataclasses.dataclass(frozen=True)
class FrameConfig:
    """The static part of one frame: geometry and filter settings
    (tpu_full._build_fn's static arguments)."""
    H8: int                     # block-grid height in pixels
    W8: int
    bits: int                   # output bits per sample
    gab: bool
    epf_iters: int
    gabw: Tuple[float, ...]     # (x1, x2, y1, y2, b1, b2)
    pass0_scale: float
    pass2_scale: float
    crop_h: int                 # true image size
    crop_w: int


@dataclasses.dataclass
class Family:
    """All varblocks of one strategy, padded to n_pad rows; padding rows
    carry bys == tpu_full._PAD_SENTINEL."""
    sid: int
    bh: int
    bw: int
    special: bool               # 1-block response-matrix transform
    coef: torch.Tensor          # (n_pad, 3, K) int8/int16/int32
    bys: torch.Tensor           # (n_pad,) int32 block row
    bxs: torch.Tensor           # (n_pad,) int32 block column
    inv_qac: torch.Tensor       # (n_pad,) f32
    xf: torch.Tensor            # (n_pad,) f32 CfL factor X
    bf: torch.Tensor            # (n_pad,) f32 CfL factor B
    tab: Optional[torch.Tensor] = None     # (3, K) f32 dequant steps
    resp: Optional[torch.Tensor] = None    # (3, 64, 8, 8) f32 special
    resp_y_def: Optional[torch.Tensor] = None  # (64, 8, 8) f32
    fix_idx: Optional[torch.Tensor] = None  # int8 exception list: flat
    fix_val: Optional[torch.Tensor] = None  # index (int64), true value


@dataclasses.dataclass
class FrameInputs:
    families: List[Family]
    dc: torch.Tensor            # (3, ys_b, xs_b) f32 smoothed XYB DC
    qf: torch.Tensor            # (ys_b, xs_b) int32 quant field
    sharp: torch.Tensor         # (ys_b, xs_b) int32 EPF sharpness
    igs: float                  # inverse global scale (an f32 value)
    qm: np.ndarray              # (3,) f32 X/Y/B dequant multipliers


def _t(a, device, dtype=None) -> torch.Tensor:
    """numpy -> contiguous tensor on `device`, cast to `dtype` if given
    (the CUDA kernels read these through raw pointers)."""
    a = np.ascontiguousarray(a if dtype is None else np.asarray(a, dtype))
    return torch.from_numpy(a).to(device)


def family_from_dict(fam: dict, desc: tuple, device) -> Family:
    """One tpu_full.prepare_families family (numpy dict + its descriptor
    (sid, n_pad, bh, bw, cov, special)) -> Family on `device`."""
    sid, _n_pad, bh, bw, _cov, special = desc
    f32 = np.float32
    f = Family(
        sid=int(sid), bh=int(bh), bw=int(bw), special=bool(special),
        coef=_t(fam["vals"] if special else fam["cmat"], device),
        bys=_t(fam["bys"], device, np.int32),
        bxs=_t(fam["bxs"], device, np.int32),
        inv_qac=_t(fam["inv_qac"], device, f32),
        xf=_t(fam["xf"], device, f32), bf=_t(fam["bf"], device, f32))
    if special:
        f.resp = _t(fam["resp"], device, f32)
        f.resp_y_def = _t(fam["resp_y_def"], device, f32)
    else:
        f.tab = _t(fam["tab"], device, f32)
    if "fix_idx" in fam:
        f.fix_idx = _t(fam["fix_idx"], device, np.int64)
        f.fix_val = _t(fam["fix_val"], device, np.int32)
    return f


def pack(state: dict) -> Tuple[dict, tuple]:
    """The parsed frame state (vardct.parse.parse_frame) -> (static,
    args), the family packing that from_prepared carries across."""
    static, args, _mask = prepare_exec(state)
    return static, args


def from_prepared(static: dict, args: tuple,
                  device: torch.device) -> Tuple[FrameConfig, FrameInputs]:
    """(static, args) from pack -> (FrameConfig,
    FrameInputs on `device`)."""
    fams, dc, qf, sharp, igs, qm, _perm_inv = args
    cfg = FrameConfig(
        H8=int(static["H8"]), W8=int(static["W8"]),
        bits=int(static["bits"]), gab=bool(static["gab"]),
        epf_iters=int(static["epf_iters"]),
        gabw=tuple(float(g) for g in static["gabw_t"]),
        pass0_scale=float(static["pass0_scale"]),
        pass2_scale=float(static["pass2_scale"]),
        crop_h=int(static["crop_h"]), crop_w=int(static["crop_w"]))
    families = [family_from_dict(fam, d, device)
                for fam, d in zip(fams, static["desc"])]
    inputs = FrameInputs(
        families=families, dc=_t(dc, device, np.float32),
        qf=_t(qf, device, np.int32), sharp=_t(sharp, device, np.int32),
        igs=float(np.float32(igs)), qm=np.asarray(qm, np.float32))
    return cfg, inputs
