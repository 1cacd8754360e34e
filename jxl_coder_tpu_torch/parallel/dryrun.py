"""The multi-device dry run (``__graft_entry__.dryrun_multichip`` of the
JAX package) over torch.distributed ranks.

    python -m jxl_coder_tpu_torch.parallel.dryrun N [cpu|cuda]

spawns N ranks (``multihost.run_ranks``: one process and one device
each, gloo, jax blocked) that run ``groups.sharded_reconstruct`` and
``groups.sharded_reconstruct_real`` on seeded arrays against the
single-device path, with the JAX entry's assertions; then, from N >= 2,
``multihost.multihost_dryrun(2)`` and ``multihost_encode_dryrun(2)``.
Ranks on one card share it over gloo (NCCL takes one rank per card).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from . import groups as G
from .multihost import run_ranks


def _round1_arrays(n: int, rng) -> tuple:
    """__graft_entry__.py:61-67's seeded round-1 arrays, one 64-pixel
    slab a rank."""
    ny, nx = 8 * n, 16
    ac = rng.integers(-20, 20, (3, ny, nx, 8, 8)).astype(np.int32)
    dc = rng.integers(-100, 100, (3, ny, nx)).astype(np.int32)
    qf = np.full((ny, nx), 8, np.int32)
    fx = np.zeros((ny, nx), np.float32)
    fb = np.ones((ny, nx), np.float32)
    return ac, dc, qf, fx, fb


def _real_arrays(n: int, rng) -> tuple:
    """__graft_entry__.py:91-103's seeded all-DCT8 arrays, two block rows
    a rank."""
    from ..host.vardct import synthesis as S
    ny, nx = 2 * n, 16
    co = rng.integers(-20, 20, (3, ny, nx, 64)).astype(np.float32)
    dc = rng.integers(-100, 100, (3, ny, nx)).astype(np.int32)
    qf = rng.integers(4, 30, (ny, nx)).astype(np.int32)
    sh = rng.integers(0, 8, (ny, nx)).astype(np.int32)
    xf = np.zeros((ny, nx), np.float32)
    bf = np.ones((ny, nx), np.float32)
    tb = np.stack([S.dequant_table(0, c) for c in range(3)]).astype(
        np.float32)
    one = np.float32(1.0)
    return (co, dc, qf, sh, xf, bf, tb, np.float32(65536.0 / 7340),
            np.float32(10.0),
            np.asarray([0.000244140625, 0.001953125, 0.00390625], np.float32),
            one, one)


def _dryrun_rank(mesh: G.Mesh) -> dict:
    """The JAX entry's checks on this rank (``__graft_entry__.py:
    66-123``): the round-1 sharded decode within 1e-4 of the
    single-device one, and the real-format one at epf_iters 2 within 1
    code on max(4, size / 10000) values of reconstruct_dct8_frame."""
    from ..vardct import dct8
    from ..vardct import pipeline as P
    n, dev = mesh.size, mesh.device
    rng = np.random.default_rng(1)
    ac, dc, qf, fx, fb = _round1_arrays(n, rng)
    out = G.sharded_reconstruct(mesh, 1, True)(ac, dc, qf, fx, fb, 1.0)
    assert tuple(out.shape) == (3, ac.shape[1] * 8, ac.shape[2] * 8), \
        out.shape
    t = [torch.from_numpy(a).to(dev) for a in (ac, dc, qf, fx, fb)]
    ref = P._filters(P.dequant_idct(*t, 1.0), t[2], 1.0, 1, True, "f32")
    err = float((out - ref).abs().max())
    assert err < 1e-4, f"sharded decode diverges from single-device: {err}"

    args = _real_arrays(n, rng)
    sout = G.sharded_reconstruct_real(mesh, True, 2, True)(*args)
    sref = dct8.reconstruct_dct8_frame(
        *dct8.to_device(*args, dev).values(), True, 2, False)
    d = (sout.to(torch.int32) - sref.to(torch.int32)).abs()
    nbad = int((d > 0).sum())
    assert int(d.max()) <= 1 and nbad <= max(4, sout.numel() // 10000), (
        f"real-format sharded path diverges: max={int(d.max())} "
        f"nbad={nbad}")
    return {"shape": tuple(out.shape), "err": err,
            "real_shape": tuple(sout.shape), "real_max": int(d.max()),
            "real_nbad": nbad}


def dryrun_multichip(n_devices: int, device: str = "cuda") -> None:
    """The JAX entry's dry run on n_devices ranks (gloo) of `device`, then
    the two multi-process dry runs at 2 processes."""
    from .multihost import multihost_dryrun, multihost_encode_dryrun
    r = run_ranks(n_devices, _dryrun_rank, device=device, timeout=600.0)[0]
    print(f"dryrun_multichip({n_devices}): OK, legacy shape={r['shape']} "
          f"(max err {r['err']:.2e}); real-format {r['real_shape']} "
          f"max|diff|={r['real_max']} ({r['real_nbad']} px)", flush=True)
    if n_devices >= 2:
        multihost_dryrun(2, device)
        multihost_encode_dryrun(2, device)


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 8,
                     sys.argv[2] if len(sys.argv) > 2 else "cuda")
