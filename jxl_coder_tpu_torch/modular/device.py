"""The Modular inverse transforms on the device: RCT, palette and squeeze
over int32 channel planes.

``undo_frame(planes, device)`` takes a frame's raw planes as the host
decoded them (``host/modular/frame.py`` ``ModularPlanes``), uploads them
once, undoes each group stream's recorded chain on views of them, then
the frame's own chain.  ``undo_transforms(image, header)`` is the
counterpart of
``jxl_coder_tpu/modular/device.py`` ``undo_transforms_device`` (``:124``):
the same channel-list bookkeeping (a palette drops the meta channel and
fans its index plane out to ``num_c`` planes; a squeeze rewrites widths,
heights and shifts and deletes the residual channel), over channels whose
data are int32 tensors on one device (``upload`` puts them there).  It
returns nothing and falls back to nothing: a delta palette raises the
host's BitstreamError (fault R2 of ``ROADMAP.md``), and so does any
transform the host could not undo either.

Each transform is one kernel of ``csrc/modular.cu`` on a CUDA tensor
(``unsqueeze``, ``rct_inverse``, ``palette_inverse``, each counting its
launches in ``.launches``) and its plain twin on a CPU tensor; a squeeze
step's channels go to the unsqueeze kernel in one launch
(``unsqueeze_batch``, counted in ``unsqueeze.launches``).  They
are held to the int64 host oracle (``jxl_coder_tpu/modular/transform.py``),
not to the JAX device path, whose SmoothTendency wraps in int32 from
about 2^28 (fault R1).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import _build
from ..host.bitstream.reader import BitstreamError
from ..host.modular.frame import ModularPlanes
from ..host.modular.image import Channel, ModularImage
from ..host.modular.transform import _PERMUTATIONS

__all__ = ["upload", "undo_transforms", "undo_frame", "unsqueeze",
           "unsqueeze_batch", "unsqueeze_plain",
           "rct_inverse", "rct_inverse_plain", "palette_inverse",
           "palette_inverse_plain"]


@functools.lru_cache(maxsize=None)
def _kernels():
    c = ctypes
    lib = _build.load("modular")
    i64, p, i = c.c_longlong, c.c_void_p, c.c_int
    return (_build.bind(lib, "jxl_unsqueeze", [p, i64, p, i64, p, i, i, i, i]),
            _build.bind(lib, "jxl_rct_inverse",
                        [p, p, p, i64, i64, i64, p, i, i, i]),
            _build.bind(lib, "jxl_palette_inverse",
                        [p, i64, i, p, i64, p, i, i, i]),
            _build.bind(lib, "jxl_unsqueeze_batch", [p, i, i64]))


def _plane(t: torch.Tensor, what: str) -> torch.Tensor:
    """A 2-D int32 tensor whose rows are contiguous (a view of a wider
    plane is fine)."""
    if t.dtype != torch.int32 or t.dim() != 2:
        raise ValueError(f"{what} must be a 2-D int32 tensor")
    if t.shape[1] > 1 and t.stride(1) != 1:
        t = t.contiguous()
    return t


# --------------------------------------------------------------------------
# Squeeze

def _smooth_tendency(a, b, c):
    """transform.smooth_tendency on int64 tensors."""
    m1 = (a >= b) & (b >= c)
    x = torch.div(4 * a - 3 * c - b + 6, 12, rounding_mode="floor")
    x = torch.where(x - (x & 1) > 2 * (a - b), 2 * (a - b) + 1, x)
    x = torch.where(x + (x & 1) > 2 * (b - c), 2 * (b - c), x)
    out = torch.where(m1, x, torch.zeros_like(a))
    m2 = (a <= b) & (b <= c)
    num = 4 * a - 3 * c - b - 6
    y = -torch.div(-num, 12, rounding_mode="floor")
    y = torch.where(y + (y & 1) < 2 * (a - b), 2 * (a - b) - 1, y)
    y = torch.where(y - (y & 1) < 2 * (b - c), 2 * (b - c), y)
    return torch.where(m2, y, out)


def _check_squeeze(avg: torch.Tensor, res: torch.Tensor, horizontal: bool):
    """(lines, na, nr) of an inverse squeeze; a residual that does not
    belong to the average (another line count, or nr not in {na - 1, na})
    raises."""
    ax = 1 if horizontal else 0
    lines, na, nr = avg.shape[1 - ax], avg.shape[ax], res.shape[ax]
    if res.shape[1 - ax] != lines or nr not in (na - 1, na) or \
            avg.device != res.device:
        raise BitstreamError(
            f"squeeze residual {tuple(res.shape)} does not match its "
            f"average {tuple(avg.shape)} ({'horizontal' if horizontal else 'vertical'})")
    return lines, na, nr


def unsqueeze_plain(avg: torch.Tensor, res: torch.Tensor,
                    horizontal: bool) -> torch.Tensor:
    """transform._unsqueeze_1d along rows (horizontal) or columns, one
    step of the squeeze axis at a time over every line, in int64; the
    output cut to int32 as the host's astype(np.int32) cuts it."""
    _lines, na, nr = _check_squeeze(avg, res, horizontal)
    a_k = (avg if horizontal else avg.t()).long()       # (lines, na)
    r_k = (res if horizontal else res.t()).long()
    out = torch.zeros((a_k.shape[0], na + nr), dtype=torch.int64,
                      device=avg.device)
    for k in range(na):
        a = a_k[:, k]
        nxt = a_k[:, k + 1] if k + 1 < na else a
        left = out[:, 2 * k - 1] if k > 0 else a
        if k < nr:
            diff = r_k[:, k] + _smooth_tendency(left, a, nxt)
            first = a + torch.sign(diff) * (diff.abs() >> 1)
            out[:, 2 * k] = first
            out[:, 2 * k + 1] = first - diff
        else:
            out[:, 2 * k] = a                        # odd length
    out = out.to(torch.int32)
    return out if horizontal else out.t().contiguous()


def unsqueeze(avg: torch.Tensor, res: torch.Tensor,
              horizontal: bool) -> torch.Tensor:
    """The inverse squeeze of int32 planes: avg (H, na) and res (H, nr)
    -> (H, na + nr) when horizontal, else avg (na, W) and res (nr, W) ->
    (na + nr, W)."""
    avg, res = _plane(avg, "avg"), _plane(res, "res")
    lines, na, nr = _check_squeeze(avg, res, horizontal)
    if avg.device.type == "cpu":
        return unsqueeze_plain(avg, res, horizontal)
    shape = (lines, na + nr) if horizontal else (na + nr, lines)
    out = torch.empty(shape, dtype=torch.int32, device=avg.device)
    if lines == 0 or na == 0:
        return out
    _build.launch(_kernels()[0], avg.device, avg.data_ptr(), avg.stride(0),
                  res.data_ptr(), res.stride(0) if nr else 0,
                  out.data_ptr(), lines, na, nr, int(horizontal))
    unsqueeze.launches += 1
    return out


unsqueeze.launches = 0

# lines a block of the unsqueeze kernel (csrc/modular.cuh kLines)
_LINES = 32


def unsqueeze_batch(pairs) -> list:
    """Several channels' inverse squeezes, [(avg, res, horizontal)] -> the
    outputs ``unsqueeze`` gives each, in order; on the card one launch
    over all of them (a table of their planes on the card, each channel's
    lines in blocks of 32)."""
    checked = []
    for avg, res, horizontal in pairs:
        avg, res = _plane(avg, "avg"), _plane(res, "res")
        checked.append((avg, res, horizontal,
                        *_check_squeeze(avg, res, horizontal)))
    if not checked:
        return []
    dev = checked[0][0].device
    if any(c[0].device != dev for c in checked):
        raise ValueError("unsqueeze_batch: channels on more than one device")
    if dev.type == "cpu":
        return [unsqueeze_plain(a, r, hz) for a, r, hz, *_ in checked]
    outs, table, blocks = [], [], 0
    for avg, res, horizontal, lines, na, nr in checked:
        shape = (lines, na + nr) if horizontal else (na + nr, lines)
        out = torch.empty(shape, dtype=torch.int32, device=dev)
        outs.append(out)
        if lines and na:
            table.append((avg.data_ptr(), avg.stride(0), res.data_ptr(),
                          res.stride(0) if nr else 0, out.data_ptr(), lines,
                          na, nr, int(horizontal), blocks))
            blocks += -(-lines // _LINES)
    if table:
        t = torch.from_numpy(np.asarray(table, np.int64)).to(dev)
        _build.launch(_kernels()[3], dev, t.data_ptr(), len(table), blocks)
        unsqueeze.launches += 1
    return outs


# --------------------------------------------------------------------------
# RCT

def _rct_components(a, b, c, typ: int):
    """transform._rct_inverse_type on int64 tensors."""
    if typ == 0:
        return a, b, c
    if typ == 1:
        return a, b, c + a
    if typ == 2:
        return a, b + a, c
    if typ == 3:
        return a, b + a, c + a
    if typ == 4:
        return a, b + ((a + c) >> 1), c
    if typ == 5:
        c2 = c + a
        return a, b + ((a + c2) >> 1), c2
    tmp = a - (c >> 1)
    bb = tmp - (b >> 1)
    return bb + b, c + tmp, bb


def _check_rct(planes, rct_type: int):
    if not 0 <= rct_type < 7 * len(_PERMUTATIONS):
        raise BitstreamError(f"bad RCT type {rct_type}")
    if any(p.shape != planes[0].shape or p.device != planes[0].device
           for p in planes):
        raise BitstreamError("RCT channels differ in size")


def rct_inverse_plain(c0: torch.Tensor, c1: torch.Tensor, c2: torch.Tensor,
                      rct_type: int) -> torch.Tensor:
    """transform.rct_inverse on three planes -> (3, H, W) int32."""
    _check_rct((c0, c1, c2), rct_type)
    outs = _rct_components(c0.long(), c1.long(), c2.long(), rct_type % 7)
    p = _PERMUTATIONS[rct_type // 7]
    result = [None] * 3
    for i in range(3):
        result[p[i]] = outs[i]
    return torch.stack(result).to(torch.int32)


def rct_inverse(c0: torch.Tensor, c1: torch.Tensor, c2: torch.Tensor,
                rct_type: int) -> torch.Tensor:
    """The inverse RCT of three (H, W) int32 planes (any of the 42 types:
    7 transforms x 6 permutations) -> (3, H, W) int32."""
    c0, c1, c2 = (_plane(c, "RCT channel") for c in (c0, c1, c2))
    _check_rct((c0, c1, c2), rct_type)
    if c0.device.type == "cpu":
        return rct_inverse_plain(c0, c1, c2, rct_type)
    h, w = c0.shape
    out = torch.empty((3, h, w), dtype=torch.int32, device=c0.device)
    if h == 0 or w == 0:
        return out
    _build.launch(_kernels()[1], c0.device, c0.data_ptr(), c1.data_ptr(),
                  c2.data_ptr(), c0.stride(0), c1.stride(0), c2.stride(0),
                  out.data_ptr(), h, w, rct_type)
    rct_inverse.launches += 1
    return out


rct_inverse.launches = 0


# --------------------------------------------------------------------------
# Palette

def _check_palette(pal: torch.Tensor, idx: torch.Tensor, num_c: int,
                   nb_colours: int):
    if pal.shape[0] < num_c or pal.shape[1] < nb_colours or \
            pal.device != idx.device:
        raise BitstreamError(f"palette {tuple(pal.shape)} holds fewer than "
                             f"{num_c} x {nb_colours} entries")
    if nb_colours < 1 and idx.numel():
        # the host's gather from an empty palette raises
        raise BitstreamError("palette without colours")


def palette_inverse_plain(pal: torch.Tensor, idx: torch.Tensor, num_c: int,
                          nb_colours: int) -> torch.Tensor:
    """transform.palette_inverse without deltas -> (num_c, H, W) int32."""
    _check_palette(pal, idx, num_c, nb_colours)
    nb = nb_colours
    within = (idx >= 0) & (idx < nb)
    rest = torch.where(idx >= nb, idx - nb, torch.zeros_like(idx))
    at = idx.clamp(0, max(nb - 1, 0)).long()
    return torch.stack([torch.where(within, pal[c][at], rest)
                        for c in range(num_c)]).to(torch.int32)


def palette_inverse(pal: torch.Tensor, idx: torch.Tensor, num_c: int,
                    nb_colours: int) -> torch.Tensor:
    """The palette gather: the (num_c, >= nb_colours) palette at the
    (H, W) index plane -> (num_c, H, W) int32.  An index >= nb_colours
    gives index - nb_colours and a negative one 0, as the host's
    (fault R2)."""
    pal, idx = _plane(pal, "palette"), _plane(idx, "index plane")
    _check_palette(pal, idx, num_c, nb_colours)
    if idx.device.type == "cpu":
        return palette_inverse_plain(pal, idx, num_c, nb_colours)
    h, w = idx.shape
    out = torch.empty((num_c, h, w), dtype=torch.int32, device=idx.device)
    if h == 0 or w == 0 or num_c == 0:
        return out
    _build.launch(_kernels()[2], idx.device, pal.data_ptr(), pal.stride(0),
                  nb_colours, idx.data_ptr(), idx.stride(0), out.data_ptr(),
                  h, w, num_c)
    palette_inverse.launches += 1
    return out


palette_inverse.launches = 0


# --------------------------------------------------------------------------
# The chain

def upload(image: ModularImage, device, put=None) -> None:
    """Every channel's numpy plane (a view is fine) to an int32 tensor on
    `device`, by put(contiguous array) when given (as
    vardct.inputs.from_prepared), else by a plain copy; channels already
    there stay."""
    for ch in image.channels:
        if not isinstance(ch.data, torch.Tensor):
            ch.alloc()
            a = np.asarray(ch.data, np.int32)
            ch.data = (put(np.ascontiguousarray(a)) if put is not None
                       else torch.from_numpy(a).to(device))


def _undo_palette(chans, t) -> None:
    b, n = t.begin_c, t.num_c
    if t.nb_deltas:
        raise BitstreamError("palette deltas not yet supported")
    if b + 1 >= len(chans):
        raise BitstreamError(f"palette index channel {b + 1} outside the "
                             f"{len(chans)}-channel image")
    idx = chans[b + 1]
    out = palette_inverse(chans[0].data, idx.data, n, t.nb_colours)
    chans[:] = (chans[1:b + 1]
                + [Channel(idx.width, idx.height, idx.hshift, idx.vshift,
                           out[c]) for c in range(n)]
                + chans[b + 2:])


def _undo_squeeze(chans, t) -> None:
    """Each squeeze step, last first, as one unsqueeze_batch over its
    channels; the channel list changes in the host's order."""
    for s in reversed(t.squeezes):
        # non-in-place residuals form a contiguous tail block; fix its
        # base BEFORE deleting (deletions above base don't move base+i)
        base = len(chans) - s.num_c
        steps, n = [], len(chans)
        for i in reversed(range(s.num_c)):
            c = s.begin_c + i
            res_idx = s.begin_c + s.num_c + i if s.in_place else base + i
            if not 0 <= res_idx < n:
                raise BitstreamError(f"squeeze residual channel {res_idx} "
                                     f"outside the {n}-channel image")
            # the host undoes these one after another; one launch needs
            # each to read channels no earlier one wrote or moved
            if any(max(c, res_idx) >= r or c == c2 or res_idx == c2
                   for c2, r in steps):
                raise BitstreamError(f"squeeze channels {c} / {res_idx} "
                                     f"overlap an earlier channel's")
            steps.append((c, res_idx))
            n -= 1
        outs = unsqueeze_batch([(chans[c].data, chans[r].data, s.horizontal)
                                for c, r in steps])
        for (c, res_idx), out in zip(steps, outs):
            avg = chans[c]
            if s.horizontal:
                chans[c] = Channel(out.shape[1], avg.height, avg.hshift - 1,
                                   avg.vshift, out)
            else:
                chans[c] = Channel(avg.width, out.shape[0], avg.hshift,
                                   avg.vshift - 1, out)
            del chans[res_idx]


def undo_transforms(image: ModularImage, header) -> None:
    """Undo the stream's transforms, last first, on the device its
    channels' tensors lie on (``upload`` first)."""
    chans = image.channels
    for t in reversed(header.transforms):
        if t.id == 0:
            b = t.begin_c
            if b < 0 or b + 3 > len(chans):
                raise BitstreamError(
                    f"RCT channel range [{b}, {b + 3}) outside the "
                    f"{len(chans)}-channel image")
            out = rct_inverse(chans[b].data, chans[b + 1].data,
                              chans[b + 2].data, t.rct_type)
            for i in range(3):
                chans[b + i].data = out[i]
        elif t.id == 1:
            _undo_palette(chans, t)
            image.nb_meta_channels -= 1
        elif t.id == 2:
            _undo_squeeze(chans, t)
        else:
            raise BitstreamError(f"invalid transform id {t.id}")


def _undo_group(parents, chain, device, put=None) -> None:
    """A group stream's own chain, undone on views of the frame's planes
    (parents, on `device`), written back into them."""
    on_device = {id(v): parents[ci].data[y0:y0 + rh, x0:x0 + rw]
                 for v, (ci, y0, x0, rh, rw) in zip(chain.views,
                                                    chain.rects)}
    sub = ModularImage([Channel(c.width, c.height, c.hshift, c.vshift,
                                on_device.get(id(c), c.data))
                        for c in chain.channels], nb_meta_channels=0)
    upload(sub, device, put)
    undo_transforms(sub, chain.header)
    if len(sub.channels) != len(chain.rects):
        raise BitstreamError("group-local transform changed channel count")
    for (ci, y0, x0, rh, rw), ch in zip(chain.rects, sub.channels):
        if ch.data.shape != (rh, rw):
            raise BitstreamError("group-local transform changed a "
                                 "channel's size")
        parents[ci].data[y0:y0 + rh, x0:x0 + rw] = ch.data


def undo_frame(planes: ModularPlanes, device, put=None) -> list:
    """The frame's planes on `device` (put: as in upload), every transform
    undone there: each group's local chain on views of the uploaded
    planes, then the frame's chain -> the channels' int32 tensors."""
    upload(planes.image, device, put)
    for chain in planes.chains:
        _undo_group(planes.image.channels, chain, device, put)
    undo_transforms(planes.image, planes.header)
    return [c.data for c in planes.image.channels]
