"""The VarDCT encoder front on a named device (the port's
``jxl_coder_tpu/vardct/enc_device.py``).

``Front(device)`` holds the JAX module's six calls, which the host encoder
(``host/vardct/enc_real.encode_vardct_real(..., front=Front(dev))``)
takes by injection, so that the host layer imports no torch:

- ``run_front_dispatch`` / ``run_front_fetch``: the padded sRGB samples
  -> E1 (XYB, B - Y, gaborish) and E2 (block DCT, masking field, CfL sums,
  DC slice); the fetch is the one d2h copy of the flat "small" buffer;
  the planes and coefficients stay on the device;
- ``run_costs_dispatch`` / ``run_costs_fetch``: E3 for DCT8 and each
  candidate shape, E4 for each special transform, every cost into one
  flat buffer; the fetch copies the costs only, the values stay;
- ``fetch_selected_dispatch`` / ``fetch_selected_fetch``: the winners'
  rows gathered on the device, one d2h copy, scattered on the host into a
  ``SelectedFlat``.

Each dispatch launches its work and returns; on a card its d2h copy goes
into pinned memory (``non_blocking``) behind an event, so the host work the
encoder overlaps (the patch detector, the DC substreams, the AC-metadata
trees) runs meanwhile.  On the CPU the twins run at once.  The host halves
(the small buffer's split, the cost unpacking, the anchor walk and the
scatter) are numpy, in ``host/vardct/selected.py``.  Nothing falls back:
a failing kernel raises, and the encoder lets it.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from .._device import resolve_device
from ..host.vardct import selected as SEL
from . import enc_kernels as EK

__all__ = ["Front"]


class _Pending:
    """A d2h copy in flight: the host buffer and the event after it."""

    __slots__ = ("buf", "event")

    def __init__(self, t: torch.Tensor):
        if t.device.type == "cpu":
            self.buf, self.event = t, None
            return
        self.buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        self.buf.copy_(t, non_blocking=True)
        self.event = torch.cuda.Event()
        self.event.record(torch.cuda.current_stream(t.device))

    def numpy(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.buf.numpy()


class Front:
    """The encoder front's six calls on `device` ("cuda" by default; a
    CUDA request without a card raises)."""

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)

    def _on(self):
        """The device's context: launches go on its current stream."""
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    def _put(self, a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type == "cpu":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    # -- stage 1 ----------------------------------------------------------

    def run_front_dispatch(self, pad: np.ndarray, gab_iters: int = 4):
        """Launch E1 and E2 on the (ph, pw, 3) padded samples (uint8,
        uint16, or float sRGB in [0, 1]); pair with run_front_fetch."""
        ph, pw, _ = pad.shape
        if pad.dtype == np.uint16:
            pad = pad.view(np.int16)
        elif pad.dtype != np.uint8:
            pad = pad.astype(np.float32)
        with self._on():
            planes = EK.front_planes(self._put(pad), gab_iters)
            co, small = EK.front_blocks(planes)
            return planes, co, _Pending(small), ph // 8, pw // 8

    def run_front_fetch(self, pending):
        """(device planes, device co, mask, ytox, ytob, co_dc (float64))."""
        planes, co, small, ys_b, xs_b = pending
        mask, ytox, ytob, co_dc = SEL.front_from_small(small.numpy(), ys_b,
                                                       xs_b)
        return planes, co, mask, ytox, ytob, co_dc

    # -- stage 2 ----------------------------------------------------------

    def run_costs_dispatch(self, planes, co, qf_map, fx_blk, fb_blk, dq_dc,
                           igs, lam, cands, deadzone, specials=(),
                           special_eligible=None):
        """Launch E3 for DCT8 and every candidate shape that fits, E4 for
        every special transform; pair with run_costs_fetch."""
        ys_b, xs_b = qf_map.shape
        meta = SEL.cost_meta(ys_b, xs_b, cands, specials)
        n_shapes = len(meta) - len(specials)
        with self._on():
            qf = self._put(qf_map.astype(np.int32))
            fx = self._put(fx_blk.astype(np.float32))
            fb = self._put(fb_blk.astype(np.float32))
            dq = self._put(dq_dc.astype(np.float32))
            total = ys_b * xs_b + sum(m[3] * m[4] for m in meta)
            cost = torch.empty(total, dtype=torch.float32,
                               device=self.device)
            args = (qf, fx, fb, dq, igs, lam)
            vals_list = [EK.dct_costs(co, *args, 0, 1, 1, deadzone,
                                      cost[:ys_b * xs_b])]
            off = ys_b * xs_b
            elig = None
            if specials:
                if special_eligible is None:
                    special_eligible = np.ones((ys_b, xs_b), bool)
                elig = self._put(special_eligible.astype(np.bool_))
            for k, (sid, cy, cx, nyc, nxc, cov) in enumerate(meta):
                out = cost[off:off + nyc * nxc]
                off += nyc * nxc
                if k < n_shapes:
                    vals_list.append(EK.dct_costs(planes, *args, sid, cy, cx,
                                                  deadzone, out))
                else:
                    vals_list.append(EK.special_costs(planes, *args, elig,
                                                      sid, deadzone, out))
            return vals_list, _Pending(cost), meta, qf_map

    def run_costs_fetch(self, pending):
        """(cost8, {sid: (cost, min qf)}, the values on the device, meta)."""
        vals_list, cost, meta, qf_map = pending
        cost8, cost_data = SEL.costs_from_flat(cost.numpy(), meta, qf_map)
        return cost8, cost_data, vals_list, meta

    # -- the winners ------------------------------------------------------

    def fetch_selected_dispatch(self, vals_list, meta, acs_map):
        """Launch the winners' gather; pair with fetch_selected_fetch."""
        plan, anchors = SEL.gather_plan(meta, acs_map)
        srcs = [vals_list[k] for k, _ in plan]
        with self._on():
            ix_all = self._put(np.concatenate([ix for _, ix in plan]))
            idxs, off = [], 0
            for _, ix in plan:
                idxs.append(ix_all[off:off + len(ix)])
                off += len(ix)
            flat = EK.gather_rows(srcs, idxs)
            return (_Pending(flat), anchors,
                    [int(s.shape[3]) for s in srcs])

    def fetch_selected_fetch(self, pending) -> SEL.SelectedFlat:
        flat, anchors, tails = pending
        return SEL.selected_from_rows(flat.numpy(), anchors, tails)
