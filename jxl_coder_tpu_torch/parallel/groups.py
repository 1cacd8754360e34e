"""The decode sharded over ranks by block rows or by frames
(``jxl_coder_tpu/parallel/groups.py``), with torch.distributed.

A ``Mesh`` is one axis of ranks, one device each, over the default
process group (``make_mesh``).  Groups of block rows decode apart once
the entropy decode is done; the filters' reach across a shard's edge is
exchanged as halo rows with the shards above and below
(``exchange_halo``: point-to-point sends, ``batch_isend_irecv``, in place
of the JAX package's ``ppermute``), and the rows come together on every
rank by ``all_gather`` (``gather``), as the JAX functions return the
global array.

- ``sharded_reconstruct_real``: an all-DCT8 frame (``vardct/dct8.py``'s
  arrays) by block rows: DC planes and smoothing with a 1-block-row
  exchange, the IDCT product and kernel 7 per shard, an 8-row exchange of
  the planes and 1 block row of the sigma map, then kernel 2 in a row
  window (``filters.Window``), whose rows equal the same rows of the
  whole-image launch: gaborish, EPF 0-2 and the sRGB8 output in one
  launch per shard (two at epf_iters 3).
- ``sharded_reconstruct``: the round-1 layout by block rows: the
  dequantisation and IDCT per shard, a ``filter_halo``-row exchange of
  the planes and 1 block row of the quant field, then kernel 5 on the
  padded slab (``pipeline.filter_padded``).
- ``sharded_frame_reconstruct``: the frame axis split over the ranks,
  each frame through the round-1 pipeline's filters (kernel 5, f32).

Every sharded function takes the whole inputs, as the JAX functions take
global arrays; each rank cuts out its own shard and returns the whole
output.  Over gloo (the ranks of one card, or CPU tensors) the halos
and the gather travel through pinned host buffers; over NCCL the card's
own tensors.  A backend that fails raises; nothing falls back.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from .._device import resolve_device
from ..vardct import dct8, filters
from ..vardct import pipeline as P


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One axis of ranks: the process group (None for one rank without
    one), this rank, the number of ranks, this rank's device and the
    axis name."""
    group: Optional[dist.ProcessGroup]
    rank: int
    size: int
    device: torch.device
    axis: str = "g"


def make_mesh(n_devices: Optional[int] = None, axis: str = "g",
              device=None) -> Mesh:
    """The mesh of the initialised default process group, one rank per
    device (one rank needs no group).  device: this rank's device; "cuda"
    (the default) means cuda:{LOCAL_RANK (else the rank) % the cards},
    "cpu" only when asked.  Raises for more than one rank without a process group,
    and for an n_devices other than the group's size."""
    if dist.is_available() and dist.is_initialized():
        group, size, rank = dist.group.WORLD, dist.get_world_size(), \
            dist.get_rank()
    else:
        group, size, rank = None, 1, 0
    n = size if n_devices is None else int(n_devices)
    if n != size:
        if group is None:
            raise RuntimeError(
                f"a mesh of {n} ranks needs an initialised process group "
                f"(torch.distributed.init_process_group)")
        raise ValueError(f"n_devices {n}: the process group has {size} ranks")
    dev = resolve_device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        local = int(os.environ.get("LOCAL_RANK", rank))
        dev = torch.device("cuda", local % torch.cuda.device_count())
    if dev.type == "cuda":
        # NCCL's point-to-point calls run on the current device
        torch.cuda.set_device(dev)
    return Mesh(group, rank, size, dev, axis)


def _staged(mesh: Mesh, t: torch.Tensor) -> bool:
    """Whether t travels through a host buffer: a CUDA tensor over gloo."""
    return t.is_cuda and dist.get_backend(mesh.group) == "gloo"


def _wire(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """t as the backend sends it: a pinned host copy over gloo."""
    if _staged(mesh, t):
        buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        return buf.copy_(t)
    return t.contiguous()


def _buffer(mesh: Mesh, like: torch.Tensor, shape) -> torch.Tensor:
    """A receive buffer for a tensor like `like`."""
    if _staged(mesh, like):
        return torch.empty(shape, dtype=like.dtype, pin_memory=True)
    return torch.empty(shape, dtype=like.dtype, device=like.device)


def exchange_halo(slab: torch.Tensor, halo: int, mesh: Mesh
                  ) -> torch.Tensor:
    """slab: this rank's (C, rows, W) shard.  -> (C, rows + 2 * halo, W):
    `halo` rows of the shard above on top and of the shard below
    underneath, edge replicas of the shard's own first / last row at the
    image's top and bottom (``groups.py:39-56``)."""
    C, rows, W = slab.shape
    if not 0 < halo <= rows:
        raise ValueError(f"halo {halo} of a shard {rows} rows tall")
    above = slab[:, :1].expand(C, halo, W)
    below = slab[:, -1:].expand(C, halo, W)
    if mesh.size > 1:
        ops, recv = [], {}
        for peer, rows_out in ((mesh.rank - 1, slab[:, :halo]),
                               (mesh.rank + 1, slab[:, -halo:])):
            if 0 <= peer < mesh.size:
                recv[peer] = _buffer(mesh, slab, (C, halo, W))
                ops += [dist.P2POp(dist.isend, _wire(mesh, rows_out), peer,
                                   mesh.group),
                        dist.P2POp(dist.irecv, recv[peer], peer, mesh.group)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        if mesh.rank - 1 in recv:
            above = recv[mesh.rank - 1].to(slab.device)
        if mesh.rank + 1 in recv:
            below = recv[mesh.rank + 1].to(slab.device)
    return torch.cat([above, slab, below], 1)


def fix_global_halo(padded: torch.Tensor, halo: int, mesh: Mesh
                    ) -> torch.Tensor:
    """The halo rows of the first / last shard replaced by edge replicas
    of the image's first / last row (``groups.py:118-129``): a slab
    whose halo rows a filter has changed gets back the single-device
    filters' edge padding at the image's borders."""
    padded = padded.clone()
    if mesh.rank == 0:
        padded[:, :halo] = padded[:, halo:halo + 1]
    if mesh.rank == mesh.size - 1:
        padded[:, -halo:] = padded[:, -halo - 1:-halo]
    return padded


def gather(local: torch.Tensor, mesh: Mesh, dim: int = 0) -> torch.Tensor:
    """Every rank's `local` (one shape on all of them) concatenated along
    `dim` in rank order, on every rank, on local's device."""
    if mesh.group is None:
        return local
    wire = _wire(mesh, local)
    parts = [_buffer(mesh, local, wire.shape) for _ in range(mesh.size)]
    dist.all_gather(parts, wire, group=mesh.group)
    return torch.cat(parts, dim).to(local.device)


def gather_frames(local: torch.Tensor, count: int, mesh: Mesh
                  ) -> torch.Tensor:
    """The first `count` frames of every rank's (k, ...) frames in rank
    order, each rank holding at most ceil(count / size) of them."""
    per = -(-count // mesh.size)
    if local.shape[0] < per:
        pad = local.new_zeros((per - local.shape[0],) + local.shape[1:])
        local = torch.cat([local, pad])
    return gather(local, mesh)[:count]


def shard_range(n: int, mesh: Mesh) -> tuple:
    """This rank's part [start, stop) of an axis n long, which the mesh
    size must divide."""
    if n % mesh.size:
        raise ValueError(f"an axis of {n} does not divide over "
                         f"{mesh.size} ranks (pad_to_shardable)")
    per = n // mesh.size
    return mesh.rank * per, (mesh.rank + 1) * per


def _rows(a, axis: int, start: int, stop: int, dtype, dev) -> torch.Tensor:
    """a[..., start:stop, ...] along `axis` (numpy or torch) on dev."""
    t = torch.as_tensor(a).narrow(axis, start, stop - start)
    return t.to(device=dev, dtype=dtype).contiguous()


def pad_to_shardable(ny: int, n_devices: int) -> int:
    """Block rows padded so each shard gets an equal slab."""
    per = -(-ny // n_devices)
    return per * n_devices


def pad_frame_arrays(ac, dc, qf, fx, fb, n_devices: int):
    """Pad the block-row axis to a multiple of n_devices (qf padded with
    8 to keep the inverse sigma finite) -> (ac, dc, qf, fx, fb, ny)."""
    ny = qf.shape[0]
    e = pad_to_shardable(ny, n_devices) - ny
    if e == 0:
        return ac, dc, qf, fx, fb, ny
    ac = np.pad(ac, ((0, 0), (0, e), (0, 0), (0, 0), (0, 0)))
    dc = np.pad(dc, ((0, 0), (0, e), (0, 0)))
    qf = np.pad(qf, ((0, e), (0, 0)), constant_values=8)
    fx = np.pad(fx, ((0, e), (0, 0)))
    fb = np.pad(fb, ((0, e), (0, 0)))
    return ac, dc, qf, fx, fb, ny


def sharded_reconstruct(mesh: Mesh, epf_iters: int = 1, gab: bool = True):
    """fn(ac (3, nY, nX, 8, 8), dc (3, nY, nX), qf, fx, fb (nY, nX),
    distance) -> (3, H, W) filtered XYB on every rank, the block rows
    split over the mesh (nY must divide; pad_frame_arrays)."""
    halo = P.filter_halo(epf_iters, gab)

    def fn(ac, dc, qf, fx, fb, distance):
        b0, b1 = shard_range(qf.shape[0], mesh)
        dev = mesh.device
        qf_s = _rows(qf, 0, b0, b1, torch.int32, dev)
        img = P.dequant_idct(_rows(ac, 1, b0, b1, torch.int32, dev),
                             _rows(dc, 1, b0, b1, torch.int32, dev), qf_s,
                             _rows(fx, 0, b0, b1, torch.float32, dev),
                             _rows(fb, 0, b0, b1, torch.float32, dev),
                             float(distance))
        if halo:
            # the quant field's block row above and below: the slab's
            # first row is the field's pixel row 8 - halo
            qf_slab = exchange_halo(qf_s[None], 1, mesh)[0]
            img = P.filter_padded(exchange_halo(img, halo, mesh), qf_slab,
                                  float(distance), epf_iters, gab, halo,
                                  8 - halo)
        return gather(img, mesh, 1)

    return fn


def sharded_reconstruct_real(mesh: Mesh, gab: bool = True, epf=True,
                             dc_smooth: bool = True):
    """fn(coeffs (3, ys, xs, 64), dc (3, ys, xs), qf, sharp, xf, bf (ys,
    xs), table (3, 64), igs, quant_dc, dcq (3,), qm_x, qm_b) -> (8*ys,
    8*xs, 3) uint8 sRGB on every rank, the block rows split over the mesh
    (ys must divide): dct8.reconstruct_dct8_frame's arguments and result.
    epf: the epf_iters count, 0-3 (True means 1).  Every rank's rows
    equal the same rows of the single-device reconstruct_dct8_frame, at
    epf_iters 3 too (the JAX function runs only EPF1 and EPF2 there,
    ROADMAP R23)."""
    epf_iters = int(epf)
    if epf_iters not in (0, 1, 2, 3):
        raise ValueError(f"epf_iters {epf_iters}: expected 0-3")

    def fn(coeffs, dc, qf, sharp, xf, bf, table, igs, quant_dc, dcq, qm_x,
           qm_b):
        ys, xs = qf.shape
        b0, b1 = shard_range(ys, mesh)
        dev = mesh.device
        qf_s = _rows(qf, 0, b0, b1, torch.int32, dev)
        steps = dct8.dc_steps(igs, quant_dc, dcq)
        dcp = dct8.dc_xyb_planes(_rows(dc, 1, b0, b1, torch.int32, dev),
                                 steps)
        if dc_smooth:
            # 3x3 on the DC grid: the block row above and below, the
            # columns edge-padded; the image's border rows and columns kept
            p = exchange_halo(dcp, 1, mesh)
            ix = torch.arange(-1, xs + 1, device=dev).clamp(0, xs - 1)
            dcp = dct8.smooth_dc_rows(dcp, p[:, :, ix], steps, b0, ys)
        planes = dct8.synth_from_dcp(
            _rows(coeffs, 1, b0, b1, torch.float32, dev), dcp, qf_s,
            _rows(xf, 0, b0, b1, torch.float32, dev),
            _rows(bf, 0, b0, b1, torch.float32, dev),
            torch.as_tensor(table, dtype=torch.float32, device=dev),
            igs, qm_x, qm_b)
        # 8 rows past the shard's edges (the chain reads at most 7) and
        # the sigma map's block row above and below
        slab = exchange_halo(planes, filters.HALO, mesh)
        sigma = None
        if epf_iters:
            sigma = exchange_halo(filters.sigma_map(
                _rows(sharp, 0, b0, b1, torch.int32, dev), qf_s,
                float(np.float32(igs)))[None], 1, mesh)[0]
        win = filters.Window(8 * ys, 8 * b0 - filters.HALO, b0 - 1, 8 * b0,
                             8 * (b1 - b0))
        out = filters.restore_and_output(
            slab, sigma, bool(gab), epf_iters, dct8._GABW,
            dct8._PASS0_SCALE, dct8._PASS2_SCALE, "u8", window=win)
        return gather(out, mesh)

    return fn


def sharded_frame_reconstruct(mesh: Mesh, epf_iters: int = 1,
                              gab: bool = True):
    """fn(ac (N, 3, nY, nX, 8, 8), dc (N, 3, nY, nX), qf, fx, fb (N, nY,
    nX), distance) -> (N, 3, H, W) filtered XYB on every rank, the frame
    axis split over the mesh (N must divide): each rank's frames through
    the round-1 pipeline's filters (kernel 5, f32)."""

    def fn(ac, dc, qf, fx, fb, distance):
        f0, f1 = shard_range(qf.shape[0], mesh)
        dev = mesh.device
        out = []
        for f in range(f0, f1):
            qf_f = _rows(qf, 0, f, f + 1, torch.int32, dev)[0]
            img = P.dequant_idct(_rows(ac, 0, f, f + 1, torch.int32, dev)[0],
                                 _rows(dc, 0, f, f + 1, torch.int32, dev)[0],
                                 qf_f,
                                 _rows(fx, 0, f, f + 1, torch.float32, dev)[0],
                                 _rows(fb, 0, f, f + 1, torch.float32, dev)[0],
                                 float(distance))
            out.append(P._filters(img, qf_f, float(distance), epf_iters,
                                  gab, "f32"))
        return gather(torch.stack(out), mesh)

    return fn
