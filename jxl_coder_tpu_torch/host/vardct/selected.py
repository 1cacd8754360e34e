"""The host halves of the encoder front's fetches (numpy).

Copies of the host work of ``jxl_coder_tpu/vardct/enc_device.py``: the
tail of ``run_front_fetch`` (the flat "small" buffer split into the
masking field, the CfL sums rounded to ``ytox`` / ``ytob`` and the DC
slice, ``front_from_small``), the cost unpacking of ``run_costs_fetch``
(``costs_from_flat``), the anchor walk of ``fetch_selected_dispatch``
(``gather_plan``) and the scatter of ``fetch_selected_fetch`` into
anchor-major, raster order (``selected_from_rows``), with
``SelectedFlat``, the winners' values as one flat array.  The device
layer (``vardct/enc_device.py``) calls them around its launches; the host
encoder (``enc_real``) builds its own winners with them on the float64
route and consumes ``SelectedFlat`` on both.
"""

from __future__ import annotations

import numpy as np


class SelectedFlat:
    """Winner coefficient values as ONE flat int32 array (anchor-major,
    then channel-major, covered-prefix zeros included), with per-anchor
    (by, bx, sid) arrays in raster order.  The token writers consume it
    directly."""

    __slots__ = ("bys", "bxs", "sids", "sizes", "offs", "vals")

    def __init__(self, bys, bxs, sids, sizes, offs, vals):
        self.bys, self.bxs, self.sids = bys, bxs, sids
        self.sizes = sizes            # num_coeffs per anchor
        self.offs = offs              # int64 (n+1,) into vals, 3*size
        self.vals = vals              # int32 flat

    @classmethod
    def all_dct8(cls, vals: np.ndarray) -> "SelectedFlat":
        """A grid of DCT8 blocks, vals (gh, gw, 3, 64) in raster order."""
        gh, gw = vals.shape[:2]
        n = gh * gw
        bys, bxs = np.divmod(np.arange(n, dtype=np.int64), gw)
        return cls(bys, bxs, np.zeros(n, np.int32), np.full(n, 64, np.int64),
                   np.arange(n + 1, dtype=np.int64) * 192,
                   np.ascontiguousarray(vals, np.int32).reshape(-1))

    def transform(self, fn):
        """New SelectedFlat with fn applied to the value array."""
        return SelectedFlat(self.bys, self.bxs, self.sids, self.sizes,
                            self.offs, fn(self.vals))

    def window(self, ay: int, ax: int, gh: int, gw: int):
        """The anchors inside the block window [ay, ay + gh) x [ax, ax +
        gw), their coordinates relative to it (one AC group's values)."""
        m_ = ((self.bys >= ay) & (self.bys < ay + gh)
              & (self.bxs >= ax) & (self.bxs < ax + gw))
        sel = np.nonzero(m_)[0]
        sizes = self.sizes[sel]
        offs = np.zeros(len(sel) + 1, np.int64)
        np.cumsum(3 * sizes, out=offs[1:])
        lens = 3 * sizes
        total = int(lens.sum())
        if total:
            starts = self.offs[sel]
            idx = (np.arange(total, dtype=np.int64)
                   - np.repeat(lens.cumsum() - lens, lens)
                   + np.repeat(starts, lens))
            vals = self.vals[idx]
        else:
            vals = np.zeros(0, np.int32)
        return SelectedFlat(self.bys[sel] - ay, self.bxs[sel] - ax,
                            self.sids[sel], sizes, offs, vals)


def front_from_small(small: np.ndarray, ys_b: int, xs_b: int):
    """The front's flat f32 buffer (mask (nb), y2, xy, by (one per 64-px
    tile each), then the DC slice (3, ys_b, xs_b)) -> (mask (ys_b, xs_b),
    ytox, ytob (ty, tx) int32, co_dc (3, ys_b, xs_b) float64)."""
    ty, tx = -(-ys_b // 8), -(-xs_b // 8)
    nb, nt = ys_b * xs_b, ty * tx
    mask = small[:nb].reshape(ys_b, xs_b)
    y2 = small[nb:nb + nt].reshape(ty, tx)
    xyn = small[nb + nt:nb + 2 * nt].reshape(ty, tx)
    byn = small[nb + 2 * nt:nb + 3 * nt].reshape(ty, tx)
    co_dc = small[nb + 3 * nt:].reshape(3, ys_b, xs_b).astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        fx = np.where(y2 > 1e-9, xyn / y2, 0.0)
        fb = np.where(y2 > 1e-9, byn / y2, 0.0)
    ytox = np.clip(np.round(fx * 84.0), -128, 127).astype(np.int32)
    ytob = np.clip(np.round(fb * 84.0), -128, 127).astype(np.int32)
    return mask, ytox, ytob, co_dc


def cost_meta(ys_b: int, xs_b: int, cands, specials=()):
    """[(sid, cy, cx, nyc, nxc, cov)] of the candidate shapes that fit the
    frame, then the special transforms (one per 8x8 block)."""
    from .strategies import STRATEGIES
    meta = []
    for sid, cy, cx in cands:
        nyc, nxc = ys_b // cy, xs_b // cx
        if nyc == 0 or nxc == 0:
            continue
        meta.append((sid, cy, cx, nyc, nxc, STRATEGIES[sid].covered))
    meta += [(sid, 1, 1, ys_b, xs_b, 1) for sid in specials]
    return meta


def costs_from_flat(cflat: np.ndarray, meta, qf_map: np.ndarray):
    """The flat f32 cost buffer (DCT8's grid, then each shape's in meta's
    order) -> (cost8 (ys_b, xs_b) float64, {sid: (cost, min qf)})."""
    ys_b, xs_b = qf_map.shape
    cost8 = cflat[:ys_b * xs_b].astype(np.float64).reshape(ys_b, xs_b)
    cost_data = {}
    co_ = ys_b * xs_b
    for (sid, cy, cx, nyc, nxc, cov) in meta:
        cost = cflat[co_:co_ + nyc * nxc].astype(np.float64).reshape(
            nyc, nxc)
        co_ += nyc * nxc
        qfm = qf_map[:nyc * cy, :nxc * cx].reshape(
            nyc, cy, nxc, cx).min(axis=(1, 3)).astype(np.int32)
        cost_data[sid] = (cost, qfm)
    return cost8, cost_data


def gather_plan(meta, acs_map: np.ndarray):
    """The winners' rows to gather: [(source k (0 = DCT8, k = meta[k - 1]),
    row indices int32 into that source's (rows, 3, tail) grid)] and the
    anchors [(sid, cov, [(by, bx), ...])] in the same order."""
    ys_b, xs_b = acs_map.shape
    by_all, bx_all = np.nonzero(acs_map >= 0)
    sid_all = acs_map[by_all, bx_all]
    m8 = sid_all == 0
    plan = [(0, (by_all[m8] * xs_b + bx_all[m8]).astype(np.int32))]
    anchors = [(0, 1, list(zip(by_all[m8], bx_all[m8])))]
    for k, (sid, cy, cx, nyc, nxc, cov) in enumerate(meta):
        m = sid_all == sid
        if not m.any():
            continue
        plan.append((k + 1, ((by_all[m] // cy) * nxc
                             + bx_all[m] // cx).astype(np.int32)))
        anchors.append((sid, cov, list(zip(by_all[m], bx_all[m]))))
    return plan, anchors


def selected_from_rows(flat: np.ndarray, anchors, tails) -> SelectedFlat:
    """The gathered int16 rows (each source's winners back to back, (m,
    3, tail) each; `tails` the sources' tail lengths in the anchors'
    order) -> SelectedFlat in raster order."""
    bys_l, bxs_l, sids_l, sizes_l = [], [], [], []
    scat = []       # (rows (m, 3, tlen), cov, tlen, first_idx)
    off = 0
    first = 0
    for (sid, cov, pos), tlen in zip(anchors, tails):
        m = len(pos)
        rows = flat[off:off + m * 3 * tlen].reshape(m, 3, tlen)
        off += m * 3 * tlen
        if m:
            pa = np.asarray(pos, np.int64).reshape(m, 2)
            bys_l.append(pa[:, 0])
            bxs_l.append(pa[:, 1])
            sids_l.append(np.full(m, sid, np.int32))
            sizes_l.append(np.full(m, cov + tlen, np.int64))
            scat.append((rows, cov, tlen, first))
            first += m
    if not bys_l:
        z = np.zeros(0, np.int64)
        return SelectedFlat(z, z, z.astype(np.int32), z,
                            np.zeros(1, np.int64), np.zeros(0, np.int32))
    bys = np.concatenate(bys_l)
    bxs = np.concatenate(bxs_l)
    sids = np.concatenate(sids_l)
    sizes = np.concatenate(sizes_l)
    # raster order across sources
    order = np.argsort(bys * (bxs.max() + 1) + bxs, kind="stable")
    inv = np.empty_like(order)
    inv[order] = np.arange(len(order))
    bys, bxs, sids, sizes = bys[order], bxs[order], sids[order], \
        sizes[order]
    offs = np.zeros(len(bys) + 1, np.int64)
    np.cumsum(3 * sizes, out=offs[1:])
    vals = np.zeros(int(offs[-1]), np.int32)
    for rows, cov, tlen, first in scat:
        m = rows.shape[0]
        dst = offs[inv[first:first + m]]
        idx = (dst[:, None, None]
               + np.arange(3)[None, :, None] * (cov + tlen)
               + cov + np.arange(tlen)[None, None, :])
        vals[idx] = rows
    return SelectedFlat(bys, bxs, sids, sizes, offs, vals)
