"""Drive the PyTorch port's VarDCT still decode on one CUDA card.

    python3 chip_smoke.py

Phases (each raises on failure; the script then exits non-zero and
prints no result):
  1. the card and the library versions;
  2. build the CUDA kernels from jxl_coder_tpu_torch/csrc with nvcc;
  3. encode the 3840x2160 d1.0 e7 frame of bench.py, a 1920x1080 d4.0
     frame (epf_iters 3), a 517x771 frame of sharp strokes (the special
     1-block transforms, a ragged size) and a small 16-bit frame with
     the repo's own host encoder (jxl_coder_tpu_torch.reference), cached
     in the temp directory by content hash;
  4. each kernel against its plain PyTorch twin on the card, on both
     streams' real inputs, on a ragged crop, and (synthesis) on seeded
     families of every strategy id 0-26;
  5. the main path: jxl_coder_tpu_torch.api.decode(data, device="cuda")
     on every stream against the float64 host decoder, with every
     kernel's launch counter > 0;
  6. timings: the device half (wall time and device-busy time) and the
     whole decode at 4K, and each kernel's device time against its
     twin's at the main path's shapes.
The last two lines are the card's name and power limit and
{"ok": true, "device": {...}}; the line before them lists the kernels.
"""

from __future__ import annotations

import hashlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

sys.modules["jax"] = None    # the port runs without JAX; so does this script

import numpy as np
import torch

from jxl_coder_tpu_torch import _build, api, reference
from jxl_coder_tpu_torch.vardct import color, filters, inputs, synth
from jxl_coder_tpu_torch.vardct.frame import VarDCTFrame
from jxl_coder_tpu_torch.vardct.parse import parse_frame
from port_fixtures import bench_frame, sharp_frame, synthetic_family

SYNTH_TOL = 1e-4      # f32 sums in another order than the twin's matmuls
FILTER_TOL = 1e-5     # same op order; the kernels build without FMA
U16_TOL = 64
REPS = 10

KERNELS = {
    "synth_family": dict(fn=synth.synth_family, source="jxl_coder_tpu_torch/csrc/synth.cu",
                         replaces="jxl_coder_tpu/vardct/synth_pallas.py:129"),
    "gaborish": dict(fn=filters.gaborish, source="jxl_coder_tpu_torch/csrc/filters.cu",
                     replaces="jxl_coder_tpu/vardct/filters_pallas.py:751"),
    "epf": dict(fn=filters.epf, source="jxl_coder_tpu_torch/csrc/filters.cu",
                replaces="jxl_coder_tpu/vardct/filters_pallas.py:751"),
    "xyb_to_srgb": dict(fn=color.xyb_to_srgb, source="jxl_coder_tpu_torch/csrc/filters.cu",
                        replaces="jxl_coder_tpu/vardct/filters_pallas.py:751"),
}
ERR = {k: 0.0 for k in KERNELS}


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def stream(img: np.ndarray, distance: float, effort: int,
           bits16: bool = False) -> bytes:
    h, w, _ = img.shape
    key = hashlib.sha256(img.tobytes())
    key.update(f"{img.shape},{distance},{effort},{bits16}".encode())
    # the encoder's own source is part of the key
    with open(sys.modules[reference.encode_vardct.__module__].__file__,
              "rb") as f:
        key.update(f.read())
    path = os.path.join(tempfile.gettempdir(),
                        f"jxl_coder_tpu_torch_{key.hexdigest()[:16]}.jxl")
    if os.path.exists(path):
        with open(path, "rb") as f:
            return f.read()
    t0 = time.perf_counter()
    # 8-bit input signalled at 16 bits: the 16-bit input path of the
    # encoder needs JAX (ops.color), the 16-bit output path does not
    data = reference.encode_vardct(img, distance=distance, effort=effort,
                                   bit_depth=16 if bits16 else None)
    print(f"encoded {w}x{h} d{distance} e{effort}: {len(data)} bytes in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    with open(path + ".tmp", "wb") as f:
        f.write(data)
    os.replace(path + ".tmp", path)
    return data


def prepared(data: bytes, device):
    cfg, inp, _hdr = api.prepare(data, device)
    return cfg, inp


def cuda_ms(fn) -> float:
    """Median milliseconds of fn() over REPS warm runs, CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def note_err(name: str, err: float, tol: float, what: str) -> None:
    ERR[name] = max(ERR[name], float(err))
    print(f"parity {name:12s} {what}: max_abs_err {err:.3g} (tol {tol})",
          flush=True)
    if not err <= tol:
        raise AssertionError(f"{name} disagrees with its twin on {what}: "
                             f"{err} > {tol}")


def check_synth(cfg, inp, label: str) -> None:
    dev = inp.dc.device
    for fam in inp.families:
        a = torch.zeros((3, cfg.H8, cfg.W8), device=dev)
        b = torch.zeros_like(a)
        synth.synth_family(a, fam, inp.dc, inp.qm)
        synth.synth_family_plain(b, fam, inp.dc, inp.qm)
        note_err("synth_family", (a - b).abs().max().item(), SYNTH_TOL,
                 f"{label} sid {fam.sid} {str(fam.coef.dtype)[6:]}"
                 f"{' +fixes' if fam.fix_idx is not None else ''}")


def check_synth_all_strategies(dev) -> None:
    rng = np.random.default_rng(0)
    for sid in range(27):
        for dt in (np.int8, np.int16, np.int32):
            desc, fam, ys, xs = synthetic_family(
                sid, dt, rng, fixes=dt is np.int8)
            f = inputs.family_from_dict(fam, desc, dev)
            dc = torch.from_numpy(rng.uniform(-0.05, 0.7, (3, ys, xs))
                                  .astype(np.float32)).to(dev)
            qm = np.asarray([0.8, 1.0, 0.64], np.float32)
            a = torch.zeros((3, ys * 8, xs * 8), device=dev)
            b = torch.zeros_like(a)
            synth.synth_family(a, f, dc, qm)
            synth.synth_family_plain(b, f, dc, qm)
            ERR["synth_family"] = max(ERR["synth_family"],
                                      (a - b).abs().max().item())
    note_err("synth_family", ERR["synth_family"], SYNTH_TOL,
             "seeded families, strategies 0-26 x int8/16/32")


def check_filters(planes, sigma, cfg, label: str) -> None:
    """Every filter stage and both output depths, kernel vs twin, for
    epf_iters 1-3 on the given (3, H, W) view."""
    g_k = filters.gaborish(planes, cfg.gabw)
    g_p = filters.gaborish_plain(planes, cfg.gabw)
    note_err("gaborish", (g_k - g_p).abs().max().item(), FILTER_TOL, label)
    for iters in (1, 2, 3):
        x_k = filters.filter_chain(planes, sigma, True, iters, cfg.gabw,
                                   cfg.pass0_scale, cfg.pass2_scale)
        x_p = g_p
        if iters >= 3:
            x_p = filters.epf_plain(x_p, filters.epf_inv(sigma, cfg.pass0_scale), 0)
        x_p = filters.epf_plain(x_p, filters.epf_inv(sigma, 1.0), 1)
        if iters >= 2:
            x_p = filters.epf_plain(x_p, filters.epf_inv(sigma, cfg.pass2_scale), 2)
        note_err("epf", (x_k - x_p).abs().max().item(), FILTER_TOL,
                 f"{label} epf_iters {iters} f32")
        for bits16, tol in ((False, 1), (True, U16_TOL)):
            o_k = color.xyb_to_srgb(x_k, bits16).int()
            o_p = color.xyb_to_srgb_plain(x_p, bits16).int()
            d = (o_k - o_p).abs()
            frac = (d > 0).float().mean().item()
            note_err("xyb_to_srgb", d.max().item(), tol,
                     f"{label} epf_iters {iters} {'u16' if bits16 else 'u8'}"
                     f" (differing share {frac:.2g})")
            if not bits16 and frac >= 1e-3:
                raise AssertionError(f"u8 output differs on {frac:.3g} of "
                                     f"pixels ({label})")


def device_rows(fn, runs: int):
    """torch.profiler over `runs` warm calls of fn: [(device us, calls,
    kernel name)] for the device-side events, and the CUDA-event window
    in ms."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(runs):
            fn()
        e.record()
        e.synchronize()
    rows = [(ev.self_device_time_total, ev.count, ev.key)
            for ev in prof.key_averages()
            if str(ev.device_type).endswith("CUDA")
            and ev.self_device_time_total > 0]
    if not rows:
        raise RuntimeError("the profiler saw no device time")
    return rows, s.elapsed_time(e)


def device_ms(fn, runs: int = REPS) -> float:
    """Device milliseconds per call of fn: every kernel and copy it
    launches, without the host time between them."""
    rows, _ = device_rows(fn, runs)
    return sum(r[0] for r in rows) / 1e3 / runs


def profile_stage(frame, inp, runs: int = 5) -> float:
    """Device-busy ms per warm stage run (every kernel and copy, without
    the host time between them); prints the time by kernel."""
    rows, window = device_rows(lambda: frame(inp), runs)
    busy = sum(r[0] for r in rows) / 1e3 / runs
    print(f"profile 4k stage: device busy {busy:.3f} ms per run "
          f"(profiled window {window / runs:.3f} ms per run)", flush=True)
    for us, count, key in sorted(rows, reverse=True)[:8]:
        print(f"  {us / 1e3 / runs:8.3f} ms/run  {count // runs:4d} "
              f"calls/run  {key[:90]}", flush=True)
    return busy


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = smi()
    print(f"card: {card}", flush=True)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}",
          flush=True)

    # 2. build
    t0 = time.perf_counter()
    for name in ("synth", "filters"):
        _build.load(name)
    print(f"build: nvcc sm_90a, both kernels in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    # 3. streams
    streams = {"4k_d1.0_e7": (2160, 3840, stream(bench_frame(2160, 3840), 1.0, 7)),
               "fhd_d4.0_e7": (1080, 1920, stream(bench_frame(1080, 1920), 4.0, 7)),
               "sharp_d1.0_e7": (517, 771, stream(sharp_frame(517, 771), 1.0, 7)),
               # the 16-bit output path of the same decode
               "16bit_d1.0_e5": (480, 720, stream(bench_frame(480, 720), 1.0, 5, True))}

    # 4. kernel vs twin on the card
    check_synth_all_strategies(dev)
    for label, (h, w, data) in streams.items():
        cfg, inp = prepared(data, dev)
        print(f"stream {label}: {w}x{h} families "
              f"{[(f.sid, int(f.coef.shape[0]), str(f.coef.dtype)[6:]) for f in inp.families]} "
              f"gab {cfg.gab} epf_iters {cfg.epf_iters} bits {cfg.bits}",
              flush=True)
        if label.startswith("sharp") and not any(f.special
                                                 for f in inp.families):
            raise AssertionError("the sharp stream has no special family")
        check_synth(cfg, inp, label)
        planes = torch.zeros((3, cfg.H8, cfg.W8), device=dev)
        for fam in inp.families:
            synth.synth_family(planes, fam, inp.dc, inp.qm)
        sigma = filters.sigma_map(inp.sharp, inp.qf, inp.igs)
        check_filters(planes[:, :h, :w], sigma, cfg, label)
        if label.startswith("4k"):
            check_filters(planes[:, :2160, :3833], sigma, cfg,
                          "4k crop 2160x3833")
    torch.cuda.synchronize()

    # 5. the main path, counted
    for spec in KERNELS.values():
        spec["fn"].launches = 0
    outs = {label: api.decode(data, device="cuda")[0]
            for label, (_h, _w, data) in streams.items()}
    torch.cuda.synchronize()
    launches = {k: spec["fn"].launches for k, spec in KERNELS.items()}
    print(f"main path launches: {launches}", flush=True)
    for k, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {k} was not launched by the main path")
    for label, (h, w, data) in streams.items():
        t0 = time.perf_counter()
        ref = reference.decode_float64(data)
        th = time.perf_counter() - t0
        got = outs[label]
        if got.shape != (h, w, 3) or got.dtype != ref.dtype or \
                got.shape != ref.shape:
            raise AssertionError(f"{label}: {got.shape} {got.dtype} vs host "
                                 f"{ref.shape} {ref.dtype}")
        d = np.abs(got.astype(np.int64) - ref.astype(np.int64))
        frac = float((d > 0).mean())
        print(f"decode {label}: {got.dtype} vs float64 host decoder max "
              f"{d.max()} code, differing share {frac:.3g} (host decode "
              f"{th:.1f} s)", flush=True)
        if got.dtype == np.uint16:
            if d.max() > U16_TOL:
                raise AssertionError(f"{label}: decode outside {U16_TOL} codes")
        elif d.max() > 1 or frac >= 1e-3:
            raise AssertionError(f"{label}: decode outside 1 code / 0.1%")

    # 6. timings at 4K
    h, w, data = streams["4k_d1.0_e7"]
    mp = h * w / 1e6
    cfg, inp = prepared(data, dev)
    frame = VarDCTFrame(cfg)
    stage_ms = cuda_ms(lambda: frame(inp))
    busy_ms = profile_stage(frame, inp)
    # the wall time is bound by the host's ~30 launches per frame and
    # spreads with the host; the device-busy time is the card's own
    print(f"stage 4k device half (synth+filters+sRGB8, inputs resident): "
          f"device busy {busy_ms:.3f} ms = {mp / busy_ms * 1e3:.1f} MP/s; "
          f"wall {stage_ms:.3f} ms = {mp / stage_ms * 1e3:.1f} MP/s, card "
          f"busy {busy_ms / stage_ms:.1%} of it [{card}]", flush=True)
    t_parse, t_prep, t_h2d, t_dev, t_d2h, t_e2e = ([] for _ in range(6))
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = parse_frame(*api._read_frame(data))
        t1 = time.perf_counter()
        static, args = inputs.pack(st)
        t2 = time.perf_counter()
        c2, i2 = inputs.from_prepared(static, args, dev)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        px = VarDCTFrame(c2)(i2)
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        px.cpu().numpy()
        t5 = time.perf_counter()
        api.decode(data, device="cuda")
        t6 = time.perf_counter()
        for lst, v in ((t_parse, t1 - t0), (t_prep, t2 - t1),
                       (t_h2d, t3 - t2), (t_dev, t4 - t3), (t_d2h, t5 - t4),
                       (t_e2e, t6 - t5)):
            lst.append(v * 1e3)
    med = statistics.median
    print(f"layers 4k (host clock, median of 5 ms): parse {med(t_parse):.1f} "
          f"pack {med(t_prep):.1f} h2d {med(t_h2d):.1f} device "
          f"{med(t_dev):.1f} d2h {med(t_d2h):.1f} [{card}]", flush=True)
    print(f"end_to_end 4k decode bytes->pixels: {med(t_e2e):.1f} ms = "
          f"{mp / med(t_e2e) * 1e3:.2f} MP/s [{card}]", flush=True)

    planes = torch.zeros((3, cfg.H8, cfg.W8), device=dev)
    xyb = planes[:, :h, :w]
    sigma = filters.sigma_map(inp.sharp, inp.qf, inp.igs)
    inv1 = filters.epf_inv(sigma, 1.0)
    for fam in inp.families:
        synth.synth_family(planes, fam, inp.dc, inp.qm)
    gab = filters.gaborish(xyb, cfg.gabw)
    timings = {
        "synth_family": (
            lambda: [synth.synth_family(planes, f, inp.dc, inp.qm) for f in inp.families],
            lambda: [synth.synth_family_plain(planes, f, inp.dc, inp.qm) for f in inp.families]),
        "gaborish": (lambda: filters.gaborish(xyb, cfg.gabw),
                     lambda: filters.gaborish_plain(xyb, cfg.gabw)),
        "epf": (lambda: filters.epf(gab, inv1, 1),
                lambda: filters.epf_plain(gab, inv1, 1)),
        "xyb_to_srgb": (lambda: color.xyb_to_srgb(gab, False),
                        lambda: color.xyb_to_srgb_plain(gab, False)),
    }
    # device time per call (profiler): a wrapper's wall time is mostly
    # the host's launch work
    ms = {}
    for k, (kern, plain) in timings.items():
        ms[k] = (device_ms(kern), device_ms(plain))
        print(f"kernel {k} at 4k: device {ms[k][0]:.3f} ms, plain twin "
              f"{ms[k][1]:.3f} ms [{card}]", flush=True)
    fhd = prepared(streams["fhd_d4.0_e7"][2], dev)
    fsig = filters.sigma_map(fhd[1].sharp, fhd[1].qf, fhd[1].igs)
    fx = torch.rand((3, 1080, 1920), device=dev)
    for p, s in ((0, fhd[0].pass0_scale), (2, fhd[0].pass2_scale)):
        inv = filters.epf_inv(fsig, s)
        print(f"kernel epf pass {p} at fhd: device "
              f"{device_ms(lambda: filters.epf(fx, inv, p)):.3f} ms, plain twin "
              f"{device_ms(lambda: filters.epf_plain(fx, inv, p)):.3f} ms [{card}]",
              flush=True)

    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": spec["source"],
         "replaces": spec["replaces"], "launches": launches[k],
         "max_abs_err": ERR[k], "ms": ms[k][0], "plain_ms": ms[k][1]}
        for k, spec in KERNELS.items()]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
