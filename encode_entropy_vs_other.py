"""Time E1, E3, E4 and the winners' gather G (csrc/encode.cu
front_planes_kernel, dct_costs_kernel, special_costs_kernel, gather_kernel)
and the AC entropy decode A1 (csrc/entropy.cu groups_kernel) against other
trees' encode.cu and entropy.cu on one CUDA card, in turns, and count the
entropy kernel's SASS of every build.

    python3 encode_entropy_vs_other.py [--only e1|e3|e4|g|a1] [--sass DIR]
        [--stream FILE] OTHER_CSRC [OTHER_CSRC ...]

OTHER_CSRC is another tree's jxl_coder_tpu_torch/csrc: a parent commit's,

    mkdir -p build/parent
    git archive <commit> jxl_coder_tpu_torch/csrc | tar -x -C build/parent
    python3 encode_entropy_vs_other.py build/parent/jxl_coder_tpu_torch/csrc

or an edited copy of this tree's under build/ (a variant to time).  Each
build is named by its path.  It builds every other encode.cu and entropy.cu
with this tree's nvcc flags into build/, records the front_planes and
dct_costs calls of api.encode(the 4K bench frame, quality 90, effort 7),
the special_costs calls of the 4K text's encode with its patches (d1.0,
effort 7, as chip_smoke.py's phase 18: the patch detector first, on the
host) and the entropy
tables of chip_smoke.py's 4K d1.0 e7 stream (--stream: that stream from a
file; else cached in the temp directory by chip_smoke.py, else encoded
here), then, in the order others, this, this, others reversed:
- E1: the main path's front_planes call, and the same pixels at
  gab_iters 0 (the XYB alone), by replaying a CUDA graph of 50 calls;
  every build's planes held to the twin's (0 differences);
- E3: each of the seven shapes by replaying a CUDA graph of 50 calls, the
  seven summed, beside the fp32 torch.matmul pair of each shape's
  transforms (TF32 off); every build's values and costs held to the twin
  by chip_smoke.py's tie rule;
- E4: each of the five special transforms by replaying a CUDA graph of 50
  calls, the five summed, beside the twin's fp32 torch.matmul products on
  the eligible blocks (TF32 off); every build's values and costs held to
  the twin by the tie rule (block_dep: X and B subtract Y's whole block);
- G: the main path's gather_rows call (the 4K encode's winners) by
  replaying a CUDA graph of 50 calls, and one index_select per source on
  the same rows beside it (a PyTorch call that computes the same rows,
  not concatenated); every build's rows held to the twin's (0
  differences), and then on seeded sources (G_SEEDED: 1-16 sources, empty
  and one-row sources, indices past both ends, row lengths 3 to 3024);
  a build whose jxl_enc_gather_rows still takes max_rows (the C
  interface of the per-source grid this walk replaced) is handed it;
- A1: CUDA events around 10 launches (chip_smoke.py's method), both
  instantiations (tables staged in shared memory, and in global memory),
  with ns per token of the longest group; every build's output held to
  the first build's (coefficients, status, final states, tokens).
Then cuobjdump -sass of every entropy library into DIR (default
build/sass) and, per build, groups_kernel<true>'s instructions counted by
opcode.  The other builds must export jxl_enc_front_planes,
jxl_enc_dct_costs, jxl_enc_special_costs, jxl_enc_gather_rows and
jxl_entropy_groups with this tree's arguments (but G's max_rows); a build that lacks one is named, with the reason, and
left out of those turns.  Each line carries the card's name and power
limit; ptxas's report of every encode.cu build (stack and spills) is
printed first.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs
from jxl_coder_tpu_torch import _build, api
from jxl_coder_tpu_torch.entropy import device as ENT
from jxl_coder_tpu_torch.vardct import enc_kernels as EK


def label_of(src: Path) -> str:
    """A build's name: its path without the trailing package and csrc."""
    parts = [p for p in src.parts if p not in ("csrc", "jxl_coder_tpu_torch")]
    return "_".join(parts[-2:])


def build(src: Path, name: str, tag: str) -> ctypes.CDLL:
    """Another tree's csrc/<name>.cu; ptxas's report kept beside it."""
    so = _build.BUILD_DIR / f"lib{name}-{tag}.so"
    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(src),
                          "-o", str(so), str(src / f"{name}.cu")],
                         check=True, capture_output=True, text=True)
    so.with_suffix(".log").write_text(res.stdout + res.stderr)
    return ctypes.CDLL(str(so))


def turns(tags: list) -> list:
    others = [t for t in tags if t != "this"]
    return others + ["this", "this"] + others[::-1]


def e1_turns(call, kernels: dict, card: str) -> None:
    """The main path's front_planes call with each build, in turns, and
    the same pixels at gab_iters 0 (the XYB alone)."""
    pix, gab = call[1]
    want = {g: EK.front_planes_plain(pix, g) for g in (gab, 0)}
    orig = EK._kernels
    times = collections.defaultdict(list)
    try:
        for tag in turns(list(kernels)):
            fn = kernels[tag]
            EK._kernels = lambda fn=fn: {**orig(), "front_planes": fn}
            for g, ref in want.items():
                got = EK.front_planes(pix, g)
                torch.cuda.synchronize()
                if not torch.equal(got.view(torch.int32),
                                   ref.view(torch.int32)):
                    raise AssertionError(f"E1 {tag}: planes differ from the "
                                         f"twin at gab_iters {g}")
                t = cs.graph_ms(lambda: EK.front_planes(pix, g))
                times[(tag, g)].append(t)
                print(f"E1 {tag} at {pix.shape[1]}x{pix.shape[0]} "
                      f"{pix.dtype} gab_iters {g}: {t:.4f} ms, 0 values "
                      f"differ from the twin [{card}]", flush=True)
    finally:
        EK._kernels = orig
    for (tag, g), v in times.items():
        print(f"E1 at 4k gab_iters {g}, {tag}: " +
              " / ".join(f"{x:.4f}" for x in v) + f" ms [{card}]",
              flush=True)


def e3_turns(calls: list, kernels: dict, card: str) -> None:
    """The main path's seven dct_costs calls with each build, in turns."""
    orig = EK._kernels
    sums = collections.defaultdict(list)
    try:
        for tag in turns(list(kernels)):
            fn = kernels[tag]
            EK._kernels = lambda fn=fn: {**orig(), "dct_costs": fn}
            total = 0.0
            for _name, args, _out, _cost in calls:
                sid, cy, cx = args[7:10]
                cost = torch.empty_like(args[-1])
                a = args[:-1] + (cost,)
                out = EK.dct_costs(*a)
                ref_cost = torch.empty_like(cost)
                ref, ratios = EK.dct_costs_plain(*a[:-1], ref_cost,
                                                 return_ratios=True)
                cs.enc_check_quant("enc_dct_costs", out, cost, ref, ref_cost,
                                   ratios, f"{tag} 4k sid {sid} {cy}x{cx}")
                t = cs.graph_ms(lambda: EK.dct_costs(*a))
                total += t
                print(f"E3 {tag} sid {sid} {cy}x{cx} at 4k: {t:.4f} ms "
                      f"[{card}]", flush=True)
            sums[tag].append(total)
            print(f"E3 {tag} the seven shapes at 4k: {total:.4f} ms "
                  f"[{card}]", flush=True)
    finally:
        EK._kernels = orig
    planes = next(c[1][0] for c in calls if c[1][7] != 0)
    lib = 0.0
    for _name, args, out, _cost in calls:
        sid, cy, cx = args[7:10]
        if sid == 0:
            continue
        h, w = 8 * cy, 8 * cx
        st = EK._tables(planes.device, ("shape", sid, cy, cx))
        reg = planes[:, :out.shape[0] * h, :out.shape[1] * w].reshape(
            3, out.shape[0], h, out.shape[1], w).permute(1, 3, 0, 2, 4)
        t = cs.graph_ms(lambda: torch.matmul(torch.matmul(st["anaH"], reg),
                                             st["anaW"].t()))
        lib += t
        print(f"E3 yardstick sid {sid} {cy}x{cx}: the matmul pair {t:.4f} ms"
              f" [{card}]", flush=True)
    for tag, v in sums.items():
        print(f"E3 at 4k, {tag}: " + " / ".join(f"{x:.4f}" for x in v) +
              f" ms; the six matmul pairs {lib:.4f} ms [{card}]", flush=True)


def e4_turns(calls: list, kernels: dict, card: str) -> None:
    """The 4K text's five special_costs calls with each build, in turns."""
    orig = EK._kernels
    sums = collections.defaultdict(list)
    try:
        for tag in turns(list(kernels)):
            fn = kernels[tag]
            EK._kernels = lambda fn=fn: {**orig(), "special_costs": fn}
            total = 0.0
            for _name, args, _out, _cost in calls:
                sid = args[8]
                cost = torch.empty_like(args[-1])
                a = args[:-1] + (cost,)
                out = EK.special_costs(*a)
                ref_cost = torch.empty_like(cost)
                ref, ratios = EK.special_costs_plain(*a[:-1], ref_cost,
                                                     return_ratios=True)
                share, _rel = cs.enc_check_quant(
                    "enc_special_costs", out, cost, ref, ref_cost, ratios,
                    f"{tag} 4k text sid {sid}", elig=a[7], block_dep=True)
                t = cs.graph_ms(lambda: EK.special_costs(*a))
                total += t
                print(f"E4 {tag} sid {sid} on the 4k text "
                      f"({int(a[7].sum())} eligible blocks): {t:.4f} ms, "
                      f"{share:.3g} of values differ from the twin at ties "
                      f"[{card}]", flush=True)
            sums[tag].append(total)
            print(f"E4 {tag} the five transforms on the 4k text: "
                  f"{total:.4f} ms [{card}]", flush=True)
    finally:
        EK._kernels = orig
    lib = sum(cs.special_products_ms(c[1][:-1] + (torch.empty_like(
        c[1][-1]),)) for c in calls)
    for tag, v in sums.items():
        print(f"E4 on the 4k text, {tag}: " + " / ".join(
            f"{x:.4f}" for x in v) + f" ms; the twin's fp32 matmul products "
            f"on the eligible blocks {lib:.4f} ms [{card}]", flush=True)


# seeded gathers: (sources as (ny, nx, tail, rows taken), seed)
G_SEEDED = (([(5, 7, 63, 40)], 1), ([(1, 1, 63, 1)], 2),
            ([(4, 4, 1008, 9), (3, 3, 63, 0), (1, 1, 63, 3)], 3),
            ([(2, 3, 1, 17), (1, 2, 2, 11), (3, 1, 4, 13)], 4),
            ([(3, 4, 63, 50)] * 16, 5), ([(6, 5, 252, 25), (2, 2, 1008, 7),
                                          (9, 9, 63, 70)], 6))


def gather_fn(fn, old_abi: bool):
    """A build's gather as this tree's binding: an old build's entry also
    takes the longest source's rows."""
    if not old_abi:
        return fn

    def call(desc, n, out, stream):
        d = np.ctypeslib.as_array(ctypes.cast(desc, ctypes.POINTER(
            ctypes.c_longlong)), (n * 6,)).reshape(n, 6)
        return fn(desc, n, out, int(d[:, 2].max()), stream)
    call.__name__ = fn.__name__
    return call


def seeded_gather(spec, seed, dev):
    rng = np.random.default_rng(seed)
    srcs, idxs = [], []
    for ny, nx, tail, m in spec:
        srcs.append(torch.from_numpy(rng.integers(
            -32768, 32767, (ny, nx, 3, tail)).astype(np.int16)).to(dev))
        idxs.append(torch.from_numpy(rng.integers(
            -3, ny * nx + 3, m).astype(np.int32)).to(dev))
    return srcs, idxs


def g_turns(call, kernels: dict, card: str) -> None:
    """The main path's gather with each build, in turns, beside
    index_select; then every build on G_SEEDED."""
    srcs, idxs = call[1]
    dev = srcs[0].device
    want = EK.gather_rows_plain(srcs, idxs)
    orig = EK._kernels
    times = collections.defaultdict(list)
    rows = sum(int(i.numel()) for i in idxs)
    try:
        for tag in turns(list(kernels)):
            fn = kernels[tag]
            EK._kernels = lambda fn=fn: {**orig(), "gather_rows": fn}
            got = EK.gather_rows(srcs, idxs)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"G {tag}: rows differ from the twin")
            t = cs.graph_ms(lambda: EK.gather_rows(srcs, idxs))
            times[tag].append(t)
            print(f"G {tag} at 4k ({len(srcs)} sources, {rows} rows, "
                  f"{want.numel() * 2 / 1e6:.1f} MB): {t:.4f} ms, 0 values "
                  f"differ from the twin [{card}]", flush=True)
        flat = [s.reshape(-1, s.shape[2] * s.shape[3]) for s in srcs]
        lib = cs.graph_ms(lambda: [r.index_select(0, i)
                                   for r, i in zip(flat, idxs)])
        for tag in kernels:
            EK._kernels = lambda fn=kernels[tag]: {**orig(),
                                                   "gather_rows": fn}
            for spec, seed in G_SEEDED:
                s_, i_ = seeded_gather(spec, seed, dev)
                if not torch.equal(EK.gather_rows(s_, i_),
                                   EK.gather_rows_plain(s_, i_)):
                    raise AssertionError(f"G {tag}: seeded case {seed} "
                                         f"differs from the twin")
            print(f"G {tag}: {len(G_SEEDED)} seeded cases equal to the twin "
                  f"[{card}]", flush=True)
    finally:
        EK._kernels = orig
    for tag, v in times.items():
        print(f"G at 4k, {tag}: " + " / ".join(f"{x:.4f}" for x in v) +
              f" ms; index_select per source {lib:.4f} ms [{card}]",
              flush=True)


def a1_turns(tables, kernels: dict, card: str) -> None:
    """decode_pass_groups on the 4K tables with each build, in turns."""
    orig = ENT._kernel
    outs, times = {}, collections.defaultdict(list)
    try:
        for tag in turns(list(kernels)):
            ENT._kernel = lambda fn=kernels[tag]: fn
            for label, t in (("staged", tables),
                             ("global", tables._replace(
                                 stage_words=1 << 30))):
                dec = ENT.decode_pass_groups(t)
                torch.cuda.synchronize()
                got = tuple(x.cpu() for x in dec)
                ref = outs.setdefault(label, got)
                same = all(torch.equal(x, y) for x, y in zip(ref, got))
                s = torch.cuda.Event(enable_timing=True)
                e = torch.cuda.Event(enable_timing=True)
                s.record()
                for _ in range(cs.REPS):
                    ENT.decode_pass_groups(t)
                e.record()
                e.synchronize()
                ms = s.elapsed_time(e) / cs.REPS
                times[(tag, label)].append(ms)
                tok = int(got[3].max())
                print(f"A1 {tag} {label} at 4k: {ms:.3f} ms = "
                      f"{ms * 1e6 / tok:.1f} ns per token of the longest "
                      f"group ({tok} tokens); output "
                      f"{'equal' if same else 'DIFFERENT'} [{card}]",
                      flush=True)
    finally:
        ENT._kernel = orig
    for (tag, label), v in times.items():
        print(f"A1 at 4k, {tag} {label}: " +
              " / ".join(f"{x:.3f}" for x in v) + f" ms [{card}]", flush=True)


def sass_counts(so: Path, out: Path, tag: str) -> None:
    """cuobjdump -sass of a library into `out`; groups_kernel<true>'s
    instructions by opcode."""
    text = subprocess.run([str(Path(_build._nvcc()).parent / "cuobjdump"),
                           "-sass", str(so)], capture_output=True, text=True,
                          check=True).stdout
    out.write_text(text)
    body = re.split(r"\n\s*Function : ", text)
    fn = [b for b in body if b.startswith("_ZN") and "groups_kernelILb1E"
          in b.split("\n", 1)[0]]
    ops = collections.Counter(
        m.group(1).split(".")[0] for m in re.finditer(
            r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
            fn[0] if fn else ""))
    print(f"SASS {tag} groups_kernel<true>: {sum(ops.values())} "
          f"instructions; " + ", ".join(f"{k} {v}"
                                        for k, v in ops.most_common(24)),
          flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(
        description="E3 and A1 against other trees' sources, in turns")
    ap.add_argument("others", nargs="+", type=Path)
    ap.add_argument("--only", choices=("e1", "e3", "e4", "g", "a1"))
    ap.add_argument("--sass", type=Path, default=Path("build/sass"))
    ap.add_argument("--stream", type=Path)
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("encode_entropy_vs_other: torch sees no CUDA device",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = cs.smi()
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    names = [n for n, k in (("encode", ("e1", "e3", "e4", "g")),
                            ("entropy", ("a1",)))
             if opts.only is None or opts.only in k]
    srcs = {label_of(p.resolve()): p.resolve() for p in opts.others}
    with ThreadPoolExecutor(8) as ex:
        futs = {(tag, n): ex.submit(build, src, n, tag)
                for tag, src in srcs.items() for n in names}
        libs = {k: f.result() for k, f in futs.items()}
    if "encode" in names:
        this = EK._kernels()
        cs.ptxas_report("encode")
        for tag in srcs:
            cs.ptxas_report("encode", _build.BUILD_DIR /
                            f"libencode-{tag}.log", f"{tag} ")
        calls, text_calls = [], []
        if opts.only in (None, "e1", "e3", "g"):
            with cs.enc_recorded(calls):
                api.encode(cs.bench_frame(2160, 3840), lossless=False,
                           quality=90, effort=7, device="cuda")
        if opts.only in (None, "e4"):
            from jxl_coder_tpu_torch.host.vardct import enc_patches
            img = cs.text_frame(2160, 3840)
            plan = enc_patches.detect(img)
            with cs.enc_recorded(text_calls):
                cs.ENCR._encode_with_patches(img, plan, distance=1.0,
                                             effort=7,
                                             front=cs.ENCDEV.Front("cuda"))
        for kind, key, fn in (("e1", "front_planes", "jxl_enc_front_planes"),
                              ("e3", "dct_costs", "jxl_enc_dct_costs"),
                              ("e4", "special_costs",
                               "jxl_enc_special_costs"),
                              ("g", "gather_rows", "jxl_enc_gather_rows")):
            if opts.only not in (None, kind):
                continue
            builds = {}
            for tag in srcs:
                try:
                    argtypes = this[key].argtypes[:-1]
                    old = kind == "g" and "int max_rows" in (
                        srcs[tag] / "encode.cu").read_text()
                    if old:
                        argtypes = argtypes + [ctypes.c_int]
                    builds[tag] = gather_fn(_build.bind(
                        libs[(tag, "encode")], fn, argtypes), old)
                except AttributeError as e:
                    print(f"{kind.upper()}: cannot bind {tag}'s {fn}: {e}",
                          flush=True)
            builds["this"] = this[key]
            if kind == "e1":
                e1_turns(next(c for c in calls if c[0] == key), builds, card)
            elif kind == "e3":
                e3_turns([c for c in calls if c[0] == key], builds, card)
            elif kind == "g":
                g_turns(next(c for c in calls if c[0] == key), builds, card)
            else:
                e4_turns([c for c in text_calls if c[0] == key], builds,
                         card)
    if "entropy" in names:
        this = ENT._kernel()
        a1 = {tag: _build.bind(libs[(tag, "entropy")], "jxl_entropy_groups",
                               this.argtypes[:-1]) for tag in srcs}
        a1["this"] = this
        cs.ptxas_report("entropy")
        data = opts.stream.read_bytes() if opts.stream else cs.stream(
            cs.bench_frame(2160, 3840), 1.0, 7)
        tables, _dec = cs.entropy_run(data, dev)
        a1_turns(tables, a1, card)
        opts.sass.mkdir(parents=True, exist_ok=True)
        for tag in srcs:
            sass_counts(_build.BUILD_DIR / f"libentropy-{tag}.so",
                        opts.sass / f"entropy_{tag}.sass", tag)
        sass_counts(_build.library_path("entropy"),
                    opts.sass / "entropy_this.sass", "this")
    return 0


if __name__ == "__main__":
    sys.exit(main())
