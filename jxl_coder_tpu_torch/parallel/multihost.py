"""The GOP decode and encode over processes
(``jxl_coder_tpu/parallel/multihost.py``), with torch.distributed.

Animation frames are independent once the host has parsed them, so a
group of pictures splits over ranks frame by frame.  ``sharded_gop_real``
takes F frames of one parsed still through ``api.device_half`` (the
synthesis kernels and kernel 2: the decode's own device half), each rank
its share.  ``multihost_dryrun`` runs it in 1 and then N processes
(``run_ranks``: one rank and one device each, jax blocked): every rank
holds its own frames to the single-device ``api.decode`` of the same
stream exactly (``worker_main``), and the report gives the frames per
second of each run and the scaling efficiency.
``multihost_encode_dryrun`` splits F frames over the processes, each
encoded by ``api.encode`` (lossy, quality 90, effort 5) on the rank's
device (``worker_encode_main``); the N-process SHA-256 digests must
equal the 1-process ones.

    python -m jxl_coder_tpu_torch.parallel.multihost N [cpu|cuda]

runs both dry runs at N processes.

The JAX package runs several devices per process; here every rank has
one device, so that argument is gone.  Ranks that share one card (as on
a one-card machine, over gloo) measure contention, not scaling.
"""

from __future__ import annotations

import hashlib
import multiprocessing
import os
import pickle
import queue
import socket
import sys
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from .. import api
from ..vardct import enc_kernels as EK
from ..vardct import filters, synth
from . import groups as G

FRAMES_PER_DEVICE = 4
FRAMES_PER_DEVICE_ENC = 1
# the kernels each run counts: the decode's device half, the encoder front
DECODE_KERNELS = {"synth_family": synth.synth_family,
                  "synth_dct8": synth.synth_dct8,
                  "restore_and_output": filters.restore_and_output,
                  "epf0_pass": filters.epf0_pass}
ENCODE_KERNELS = {"enc_front_planes": EK.front_planes,
                  "enc_front_blocks": EK.front_blocks,
                  "enc_dct_costs": EK.dct_costs,
                  "enc_special_costs": EK.special_costs,
                  "enc_gather_rows": EK.gather_rows}


def _counted(kernels: dict, fn):
    """fn() with the kernels' launch counts at 0 -> (its result, the
    counts of its launches)."""
    for k in kernels.values():
        k.launches = 0
    out = fn()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return out, {name: k.launches for name, k in kernels.items()}


def seeded_stream() -> bytes:
    """A deterministic 96 x 160 test frame, encoded by the host encoder
    at distance 1.0, effort 5 (the JAX worker's _real_frame_state)."""
    from ..host.vardct.enc_real import encode_vardct_real
    rng = np.random.default_rng(17)
    yy, xx = np.mgrid[0:96, 0:160]
    img = np.clip(np.stack([
        120 + 70 * np.sin(yy / 13.0) + rng.integers(0, 24, yy.shape),
        (xx * 0.9) % 200, (xx + yy) % 220], -1), 0, 255).astype(np.uint8)
    return encode_vardct_real(img, distance=1.0, effort=5)


def sharded_gop_real(mesh: G.Mesh, host, frames: int) -> torch.Tensor:
    """F = `frames` frames of one still's host half (``api.host_half``),
    this rank's share through ``api.device_half`` on its device -> its
    (F / size, H, W, C) pixels; the mesh size must divide F."""
    f0, f1 = G.shard_range(frames, mesh)
    return torch.stack([api.device_half(host, mesh.device)
                        for _ in range(f0, f1)])


def _barrier(mesh: G.Mesh) -> None:
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)
    if mesh.group is not None:
        dist.barrier(mesh.group)


def worker_main(mesh: G.Mesh, stream: str = None,
                frames_per_rank: int = FRAMES_PER_DEVICE,
                reps: int = 5) -> dict:
    """One rank of the GOP decode: its frames of a still (the file
    `stream`, else seeded_stream()) checked exactly against the
    single-device api.decode, then timed (best of `reps`, all ranks
    between barriers) -> {"rank", "frames", "fps", "launches"}: the
    frames of all ranks per second, and the kernels' launches in the
    first (counted) run."""
    data = Path(stream).read_bytes() if stream else seeded_stream()
    host = api.host_half(data, mesh.device)
    frames = frames_per_rank * mesh.size
    out, launches = _counted(
        DECODE_KERNELS, lambda: sharded_gop_real(mesh, host, frames))
    ref = api.decode(data, device=mesh.device)[0]
    got = out.cpu().numpy()
    bad = sum(not np.array_equal(f, ref) for f in got)
    if bad:
        raise AssertionError(f"rank {mesh.rank}: {bad} of its {len(got)} "
                             f"frames differ from api.decode")
    dt = float("inf")
    for _ in range(reps):
        _barrier(mesh)
        t0 = time.perf_counter()
        sharded_gop_real(mesh, host, frames)
        _barrier(mesh)
        dt = min(dt, time.perf_counter() - t0)
    return {"rank": mesh.rank, "frames": len(got), "fps": frames / dt,
            "launches": launches}


def enc_frames(n: int, h: int = 96, w: int = 160) -> list:
    """n deterministic distinct h x w frames (the same in every
    process)."""
    rng = np.random.default_rng(23)
    yy, xx = np.mgrid[0:h, 0:w]
    noise = rng.integers(0, 24, (h, w))
    return [np.clip(np.stack([
        120 + 70 * np.sin((yy + 7 * f) / 13.0) + noise,
        (xx * 0.9 + 11 * f) % 200,
        (xx + yy + 29 * f) % 220], -1), 0, 255).astype(np.uint8)
        for f in range(n)]


def worker_encode_main(mesh: G.Mesh, total_frames: int = 4,
                       height: int = 96, width: int = 160,
                       reps: int = 3) -> dict:
    """One rank of the GOP encode: frames f with f % size == rank of
    max(total_frames, size) frames, each by api.encode on the rank's
    device (best of `reps` passes) -> on every rank {"rank", "frames",
    "wall", "digests", "launches"}: all ranks' digests of the first
    total_frames frames and the slowest rank's wall time."""
    world, rank = mesh.size, mesh.rank
    n = max(total_frames, FRAMES_PER_DEVICE_ENC * world)
    frames = enc_frames(n, height, width)
    mine = [f for f in range(n) if f % world == rank]

    def encode(f):
        return api.encode(frames[f], lossless=False, quality=90, effort=5,
                          device=mesh.device)

    encode(mine[0])          # the kernels' first build and launch
    digests, wall, launches = {}, float("inf"), None
    for _ in range(reps):
        _barrier(mesh)
        t0 = time.perf_counter()
        blobs, counts = _counted(ENCODE_KERNELS,
                                 lambda: [encode(f) for f in mine])
        wall = min(wall, time.perf_counter() - t0)
        launches = launches or counts
        digests = {f: hashlib.sha256(b).hexdigest()
                   for f, b in zip(mine, blobs) if f < total_frames}
    parts = [(digests, wall)]
    if mesh.group is not None:
        parts = [None] * world
        dist.all_gather_object(parts, (digests, wall), group=mesh.group)
    return {"rank": rank, "frames": len(mine),
            "wall": max(w for _, w in parts),
            "digests": {f: d for p, _ in parts for f, d in p.items()},
            "launches": launches}


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, n: int, port: int, backend: str, device: str,
               job: str, results) -> None:
    sys.modules["jax"] = None            # the ranks run the port alone
    sys.modules["jxl_coder_tpu"] = None
    try:
        with open(job, "rb") as f:
            fn, args = pickle.load(f)
        if device == "cpu":
            # the ranks share the host's cores
            torch.set_num_threads(max(1, (os.cpu_count() or n) // n))
        if n > 1 or backend == "nccl":
            dist.init_process_group(
                backend, init_method=f"tcp://localhost:{port}",
                world_size=n, rank=rank)
        results.put((rank, True, fn(G.make_mesh(n, device=device), *args)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(n: int, fn, *args, backend: str = "gloo",
              device: str = "cuda", timeout: float = 120.0) -> list:
    """fn(mesh, *args) in each of n spawned ranks (a process group of
    `backend` over localhost, every rank on `device`, jax blocked) -> the
    results by rank.  fn must be importable by name in a fresh process;
    raises with every failing rank's traceback, or when the ranks
    outlast `timeout` seconds.  fn and args reach the ranks through a
    file, so large arguments do not hold up the ranks' starts one after
    another (a process's start waits until it has read what it was
    handed)."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    tmp = tempfile.TemporaryDirectory()
    job = os.path.join(tmp.name, "job.pickle")
    with open(job, "wb") as f:
        pickle.dump((fn, args), f, protocol=pickle.HIGHEST_PROTOCOL)
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, n, port, backend, device, job, results))
             for r in range(n)]
    for p in procs:
        p.start()
    got, deadline = {}, time.monotonic() + timeout
    try:
        while len(got) < n:
            try:
                rank, ok, value = results.get(timeout=1.0)
                got[rank] = (ok, value)
            except queue.Empty:
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{n} ranks of {fn.__name__} ran past "
                                       f"{timeout} s") from None
                lost = [r for r, p in enumerate(procs)
                        if p.exitcode is not None and r not in got]
                if lost:
                    raise RuntimeError(f"ranks {lost} of {fn.__name__} ended "
                                       f"without a result") from None
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
        tmp.cleanup()
    failed = [f"rank {r}:\n{v}" for r, (ok, v) in sorted(got.items())
              if not ok]
    if failed:
        raise RuntimeError(f"{fn.__name__} failed:\n" + "\n".join(failed))
    return [got[r][1] for r in range(n)]


def decode_report(r1: list, rn: list, device: str) -> dict:
    """The GOP decode's 1-process and N-process ranks' results ->
    {"fps_1proc", "fps_nproc", "num_processes", "efficiency",
    "launches"} (launches: each run's ranks' counts), printed."""
    n = len(rn)
    fps1, fpsn = r1[0]["fps"], rn[0]["fps"]
    result = {"fps_1proc": fps1, "fps_nproc": fpsn, "num_processes": n,
              "efficiency": fpsn / (n * fps1),
              "launches": [r["launches"] for r in r1 + rn]}
    print(f"multihost_dryrun: GOP decode OK, every rank's frames equal to "
          f"api.decode: {fps1:.2f} f/s @1proc vs {fpsn:.2f} f/s @{n}proc on "
          f"{device}: scaling efficiency {result['efficiency']:.2f}",
          flush=True)
    return result


def encode_report(r1: list, rn: list, device: str, check: int = 4) -> dict:
    """The GOP encode's 1-process and N-process ranks' results; the first
    `check` frames' digests must be equal (else it raises) ->
    {"fps_1proc", "fps_nproc", "num_processes", "efficiency",
    "byte_identical", "launches"}, printed."""
    n = len(rn)
    d1, dn = r1[0]["digests"], rn[0]["digests"]
    fps1 = sum(r["frames"] for r in r1) / r1[0]["wall"]
    fpsn = sum(r["frames"] for r in rn) / rn[0]["wall"]
    result = {"fps_1proc": fps1, "fps_nproc": fpsn, "num_processes": n,
              "efficiency": fpsn / (n * fps1),
              "byte_identical": d1 == dn and len(d1) == check,
              "launches": [r["launches"] for r in r1 + rn]}
    if not result["byte_identical"]:
        raise RuntimeError(f"GOP encode bitstreams diverge: {d1} vs {dn}")
    print(f"multihost_encode_dryrun: GOP encode OK, the {check} frames' "
          f"bitstreams byte-identical: {fps1:.2f} f/s @1proc vs {fpsn:.2f} "
          f"f/s @{n}proc on {device}: scaling efficiency "
          f"{result['efficiency']:.2f}", flush=True)
    return result


def multihost_dryrun(num_processes: int = 2, device: str = "cuda",
                     backend: str = "gloo", stream: str = None,
                     frames_per_rank: int = FRAMES_PER_DEVICE,
                     reps: int = 5, timeout: float = 900.0) -> dict:
    """The GOP decode in 1, then num_processes processes: every rank's
    frames exactly equal to api.decode's -> decode_report."""
    runs = [run_ranks(n, worker_main, stream, frames_per_rank, reps,
                      backend=backend, device=device, timeout=timeout)
            for n in (1, num_processes)]
    return decode_report(*runs, device)


def multihost_encode_dryrun(num_processes: int = 2, device: str = "cuda",
                            backend: str = "gloo", height: int = 96,
                            width: int = 160, reps: int = 3,
                            timeout: float = 900.0) -> dict:
    """The GOP encode of 4 frames in 1, then num_processes processes ->
    encode_report (raises unless the digests are equal)."""
    runs = [run_ranks(n, worker_encode_main, 4, height, width, reps,
                      backend=backend, device=device, timeout=timeout)
            for n in (1, num_processes)]
    return encode_report(*runs, device)


if __name__ == "__main__":
    sys.modules["jax"] = None            # the port alone
    sys.modules["jxl_coder_tpu"] = None
    # the package's module, so that the ranks unpickle its functions
    from jxl_coder_tpu_torch.parallel import multihost as M
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 2
    dev = sys.argv[2] if len(sys.argv) > 2 else "cuda"
    M.multihost_dryrun(n, dev)
    M.multihost_encode_dryrun(n, dev)
