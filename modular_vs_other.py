"""Time the unsqueeze kernel (csrc/modular.cu), the banded resample S3
(csrc/sample.cu), the composition A10 (csrc/compose.cu), the spline
overlay A9 (csrc/overlay.cu) and the output encoding A7 (csrc/post.cu,
with S1 and A7y) against other trees' on one CUDA card, in turns.

    python3 modular_vs_other.py OTHER_CSRC [OTHER_CSRC ...]
        [--only=a2|s3|a10|a9|a7] [--sass=DIR]

Each OTHER_CSRC is another tree's jxl_coder_tpu_torch/csrc, for a commit:

    mkdir -p build/parent
    git archive <commit> jxl_coder_tpu_torch/csrc | tar -x -C build/parent
    python3 modular_vs_other.py build/parent/jxl_coder_tpu_torch/csrc

It builds each other modular.cu, sample.cu, compose.cu and overlay.cu with
this tree's nvcc flags into build/ and times, by replaying a CUDA graph of 50 calls,
each build's in the order other(s), this, this, other(s) reversed:
- jxl_unsqueeze on chip_smoke.py's 4K planes (the first horizontal and
  the first vertical squeeze of a 3840x2160 plane);
- jxl_resample on chip_smoke.py's S3 cases: 4K RGB8 and RGBA8 -> 1920x1080
  Mitchell, 4K x6 u8 -> 1920x1080 Mitchell, the 8x Catmull-Rom upscale
  480x270 -> 3840x2160 (a cut-short render's DC image), 4K -> FIT 480x270
  Mitchell (a thumbnail's widest band);
- jxl_compose on the FHD x5 whole-canvas BLEND call of chip_smoke.py's
  phase 16 (RGB + alpha + depth, the sprite animation's last frame's
  blending), on a seeded canvas and frame (chip_smoke.compose_case), u8
  and u16, and the same window with every channel REPLACE (the staging
  and the stores alone);
- jxl_draw_splines on the 4K splines stream's inputs (chip_smoke.py's
  "4k_splines": 64 seeded splines on the 4K d1.0 e7 stream; the stream
  cached in the temp directory by chip_smoke.py, else encoded here), on
  the planes kernel 2 gives that frame, with the ptxas report of every
  build's splines_kernel; first, untimed, on seeded planes and splines at
  three more sizes (A9_SEEDED);
- jxl_encode_output on the main path's counted A7 launches of
  chip_smoke.py's phase 12 (its POST_STREAMS decoded by api.decode, each
  launch recorded with its planes: the 4K RGBA16 noise + PQ stream, the 4K
  frame from FHD, the three 720x480 streams, the 4x and 8x upsampled
  1284x964 frames; the streams cached in the temp directory by
  chip_smoke.py, else encoded here), then every POST_SPECS entry at 8 and
  16 bits and YCbCr (A7y) on the 4K PQ stream's planes, sRGB u8 on seeded
  5136x3856 and 10272x7712 planes, sRGB u8, BT.709 u8 and PQ u16 on
  seeded 960x540 and 1280x720 planes (where A7 takes a pixel a thread),
  and S1's 4K quarter call (sRGB u8, down 4, the 4K frame's planes);
  untimed first, on
  seeded planes of A7_SEEDED's sizes (a cropped view among them), every
  spec at 8 and 16 bits and the quarter pool.  Each A7 line gives every
  build's largest code difference from the plain twin; --sass=DIR writes
  cuobjdump -sass of each post.cu build there.
Every build's output is checked equal to this tree's first (0 codes or
values; A9's planes to the bit, against the first build's).  The other
builds must export jxl_unsqueeze, jxl_resample, jxl_compose,
jxl_draw_splines and jxl_encode_output with this tree's arguments (a
build without jxl_draw_splines is named and left out of A9's turns);
another tree's jxl_resample is handed its float32 scratch (rows x W x C),
this tree's gets null.  Each line carries the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs
from jxl_coder_tpu_torch import _build
from jxl_coder_tpu_torch.host.modular import transform as MT
from jxl_coder_tpu_torch.modular import device as MDEV
from jxl_coder_tpu_torch.ops import compose as COMPOSE
from jxl_coder_tpu_torch.ops import resize as RESIZE
from jxl_coder_tpu_torch import api
from jxl_coder_tpu_torch.vardct import overlay as OV
from jxl_coder_tpu_torch.vardct import post as POST

# label: (source (h, w, C), target (w, h), scale mode, filter)
S3_CASES = {
    "4K RGB8 -> 1920x1080 Mitchell": ((2160, 3840, 3), (1920, 1080), 1, 4),
    "4K RGBA8 -> 1920x1080 Mitchell": ((2160, 3840, 4), (1920, 1080), 1, 4),
    "4K x6 u8 -> 1920x1080 Mitchell": ((2160, 3840, 6), (1920, 1080), 1, 4),
    "480x270 RGB8 -> 3840x2160 Catmull-Rom": ((270, 480, 3), (3840, 2160), 3,
                                              6),
    "4K RGB8 -> FIT 480x270 Mitchell": ((2160, 3840, 3), (480, 270), 1, 4),
}


def s3_image(shape, dev) -> torch.Tensor:
    """chip_smoke's frames: the bench frame (RGB), with its red as alpha
    (RGBA), or seeded codes (6 channels)."""
    h, w, c = shape
    if c == 6:
        g = torch.Generator(device=dev).manual_seed(5)
        return torch.randint(0, 256, (h, w, c), generator=g, device=dev,
                             dtype=torch.int32).to(torch.uint8)
    img = torch.from_numpy(cs.bench_frame(h, w)).to(dev)
    return torch.cat([img, img[..., :1]], -1) if c == 4 else img


def resample_call(fn, img, pl, bnd, out, scratch):
    """One jxl_resample of a build: this tree's with scratch None."""
    h, w, c = img.shape
    code, maxv = RESIZE._DTYPES[img.dtype]
    vf, vl, vw, hf, hl, hw = bnd
    return lambda: _build.launch(
        fn, img.device, img.data_ptr(), code, w, c, maxv, int(c in (2, 4)),
        vf.data_ptr(), vl.data_ptr(), vw.data_ptr(), vw.shape[1], pl.ch,
        hf.data_ptr(), hl.data_ptr(), hw.data_ptr(), hw.shape[1], pl.cw,
        scratch, out.data_ptr())


def build(src: Path, name: str, n: int, fn: str, argtypes):
    """Another tree's csrc/<name>.cu, bound; ptxas's report kept beside
    the library."""
    so = _build.BUILD_DIR / f"lib{name}-other{n}.so"
    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(src),
                          "-o", str(so), str(src / f"{name}.cu")],
                         check=True, capture_output=True, text=True)
    so.with_suffix(".log").write_text(res.stdout + res.stderr)
    return _build.bind(ctypes.CDLL(str(so)), fn, argtypes)


def time_a2(others, this, dev, card) -> None:
    builds = [(tag, (fn,) + this[1:]) for tag, fn in others]
    order = builds + [("this", this)] * 2 + builds[::-1]
    plane = cs.bench_frame(2160, 3840)[..., 1].astype(np.int64) * 37 - 4000
    try:
        for horizontal in (True, False):
            x = plane if horizontal else plane.T
            avg, res = MT._squeeze_1d(x)
            if not horizontal:
                avg, res = avg.T, res.T
            a, r = (torch.from_numpy(np.ascontiguousarray(v, np.int32)).to(dev)
                    for v in (avg, res))
            MDEV._kernels = lambda: this
            want = MDEV.unsqueeze(a, r, horizontal)
            for tag, kernels in order:
                MDEV._kernels = lambda k=kernels: k
                if not torch.equal(MDEV.unsqueeze(a, r, horizontal), want):
                    raise AssertionError(f"{tag}: unsqueeze differs from "
                                         f"this tree's")
                ms = cs.graph_ms(lambda: MDEV.unsqueeze(a, r, horizontal))
                print(f"unsqueeze at 4k {'horizontal' if horizontal else 'vertical'}"
                      f", {tag} tree's modular.cu: graph {ms:.4f} ms "
                      f"[{card}]", flush=True)
    finally:
        MDEV._kernels = lambda: this


def time_s3(others, this, dev, card) -> None:
    order = others + [("this", this)] * 2 + others[::-1]
    for label, (shape, (tw, th), mode, fid) in S3_CASES.items():
        img = s3_image(shape, dev)
        h, w, c = img.shape
        pl = RESIZE.HR.plan(h, w, tw, th, mode)
        bnd = RESIZE.bands(h, w, pl, fid, dev)
        scratch = torch.empty((pl.ch, w, c), dtype=torch.float32, device=dev)
        want = RESIZE.resample(img, pl, bnd)
        for tag, fn in order:
            out = torch.empty_like(want)
            call = resample_call(fn, img, pl, bnd, out,
                                 None if tag == "this" else scratch.data_ptr())
            call()
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                d = (out.int() - want.int()).abs().max().item()
                raise AssertionError(f"{tag}: resample {label} differs from "
                                     f"this tree's by {d}")
            ms = cs.graph_ms(call)
            print(f"resample {label}, {tag} tree's sample.cu: graph "
                  f"{ms:.4f} ms, 0 codes differ [{card}]", flush=True)


# the sprite animation's whole-canvas frame (port_fixtures.SPRITE_FRAMES'
# last): RGB + alpha + depth, the colour, alpha (clamped) and depth all
# BLEND through alpha 0, no associated alpha (ops/compose.blend_params)
A10_PARAMS = {
    "BLEND": np.asarray([5, 3, 2, 2, 0, 0, 2, 0, 1, 0, 2, 0, 0, 0], np.int32),
    # every channel REPLACE: the staging and the stores without arithmetic
    "REPLACE": np.asarray([5, 3, 2, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
                          np.int32)}


def time_a10(others, this, dev, card) -> None:
    order = others + [("this", this)] * 2 + others[::-1]
    orig = COMPOSE._kernel
    try:
        for dtype in (torch.uint8, torch.uint16):
            for mode, params in A10_PARAMS.items():
                canvas, src, win = cs.compose_case(dtype, dev, params)
                COMPOSE._kernel = lambda: this
                want = canvas.clone()
                COMPOSE.compose(want, src, win, params)
                for tag, fn in order:
                    COMPOSE._kernel = lambda fn=fn: fn
                    got = canvas.clone()
                    COMPOSE.compose(got, src, win, params)
                    torch.cuda.synchronize()
                    if not torch.equal(got.to(torch.int32),
                                       want.to(torch.int32)):
                        raise AssertionError(f"{tag}: compose differs from "
                                             f"this tree's")
                    ms = cs.graph_ms(lambda: COMPOSE.compose(got, src, win,
                                                             params))
                    print(f"compose FHD x5 {str(dtype).split('.')[-1]} "
                          f"whole-canvas {mode}, {tag} tree's compose.cu: "
                          f"graph {ms:.4f} ms, 0 codes differ [{card}]",
                          flush=True)
    finally:
        COMPOSE._kernel = orig


# seeded spline sets beside the stream: (h, w, splines, seed), frames that
# are not a multiple of the 64 x 16 tile among them
A9_SEEDED = ((1080, 1920, 32, 7), (613, 997, 24, 8), (70, 150, 6, 5))


def a9_seeded_equal(builds, dev, card) -> None:
    """Each build's draw_splines on seeded planes and splines
    (port_fixtures.seeded_splines, Splines.points, tile_lists) equal to
    the first build's to the bit."""
    orig = OV._kernels
    try:
        for h, w, n, seed in A9_SEEDED:
            pts, boxes = cs.seeded_splines(h, w, n, seed).points(h, w)
            boxes = np.ascontiguousarray(boxes, np.int32)
            lists = [torch.from_numpy(a).to(dev) for a in OV.longest_first(
                *OV.tile_lists(boxes[:, 0], boxes[:, 1], boxes[:, 2],
                               boxes[:, 3], h, w))]
            pts_d = torch.from_numpy(np.ascontiguousarray(pts)).to(dev)
            boxes_d = torch.from_numpy(boxes).to(dev)
            g = torch.Generator(device=dev).manual_seed(seed)
            xyb = torch.randn((3, h, w), generator=g, device=dev)
            want = None
            for tag, fn in builds:
                OV._kernels = lambda fn=fn: (orig()[0], fn)
                got = OV.draw_splines(xyb.clone(), pts_d, boxes_d, *lists)
                torch.cuda.synchronize()
                want = got if want is None else want
                diff = int((got.view(torch.int32) !=
                            want.view(torch.int32)).sum())
                if diff:
                    raise AssertionError(f"{tag}: draw_splines on seeded "
                                         f"{w}x{h} differs in {diff} values")
            print(f"splines seeded {w}x{h} ({len(pts)} points, "
                  f"{lists[0].numel()} tiles): {len(builds)} builds, 0 "
                  f"values differ from the first build's [{card}]",
                  flush=True)
    finally:
        OV._kernels = orig


def time_a9(others, this, dev, card) -> None:
    """draw_splines on the 4K splines stream's planes with each build."""
    a9_seeded_equal(others + [("this", this)], dev, card)
    _cfg, inp, xyb = cs.overlay_inputs(cs.overlay_data("4k_splines"), dev)
    ov = inp.overlay
    order = others + [("this", this)] * 2 + others[::-1]
    orig = OV._kernels
    want = None
    try:
        for tag, fn in order:
            OV._kernels = lambda fn=fn: (orig()[0], fn)
            got = OV.draw_splines(xyb.clone(), ov.points, ov.boxes,
                                  *ov.point_tiles)
            torch.cuda.synchronize()
            want = got if want is None else want
            diff = int((got.view(torch.int32) != want.view(torch.int32))
                       .sum())
            if diff:
                raise AssertionError(f"{tag}: draw_splines differs from the "
                                     f"first build's in {diff} values")
            planes = xyb.clone()
            ms = cs.graph_ms(lambda: OV.draw_splines(planes, ov.points,
                                                     ov.boxes,
                                                     *ov.point_tiles))
            print(f"splines 4k ({ov.points.shape[0]} points, "
                  f"{ov.point_tiles[0].numel()} tiles), {tag} tree's "
                  f"overlay.cu: graph {ms:.4f} ms, 0 values differ from the "
                  f"first build's [{card}]", flush=True)
    finally:
        OV._kernels = orig


# seeded planes for A7's untimed check: (h, w, crop): ragged widths, and a
# view cropped out of wider planes (row stride past W, an odd base)
A7_SEEDED = ((1, 1, False), (3, 7, False), (17, 33, False), (70, 131, False),
             (64, 128, False), (48, 96, True))


def a7_calls(dev) -> list:
    """The main path's encode_output calls on phase 12's streams: (label,
    planes, spec, bits), recorded from api.decode(data, "cuda")."""
    calls, current = [], [None]
    with cs.a7_recorded(calls, current):
        for label, (make, opts) in cs.POST_STREAMS.items():
            if "modular" in opts:
                continue
            current[0] = label
            img = make()
            data = cs.cached(img, f"post {label} {sorted(opts.items())}",
                             cs.POST_WRITER,
                             lambda: cs.write_post(img, opts))
            api.decode(data, device="cuda")
    return calls


def a7_turns(builds, cases, card) -> None:
    """Each case ((label, fn(build) -> codes, fn() -> the twin's codes)) with
    every build, in turns: equal to the first build's, the largest
    difference from the twin, the time by CUDA graph."""
    order = builds + builds[-1:] + builds[:-1][::-1]
    orig = POST._kernels
    try:
        for label, call, twin in cases:
            ref = twin() if twin is not None else None
            want = None
            for tag, fn in order:
                POST._kernels = lambda fn=fn: orig()[:2] + (fn,)
                got = call()
                torch.cuda.synchronize()
                want = got if want is None else want
                if not torch.equal(got, want):
                    d = (got.int() - want.int()).abs().max().item()
                    raise AssertionError(f"{tag}: A7 {label} differs from "
                                         f"the first build's by {d}")
                dt = ("" if ref is None else
                      f", twin max {(got.int() - ref.int()).abs().max().item()}")
                ms = cs.graph_ms(call)
                print(f"A7 {label}, {tag} tree's post.cu: graph {ms:.4f} ms, "
                      f"0 codes differ from the first build's{dt} [{card}]",
                      flush=True)
    finally:
        POST._kernels = orig


def a7_seeded_equal(builds, dev, card) -> None:
    """Each build's codes on seeded planes (every spec at 8 and 16 bits,
    YCbCr, the quarter pool) equal to the first build's."""
    orig = POST._kernels
    rng = np.random.default_rng(23)
    specs = [cs.post_spec(k) for k in cs.POST_SPECS] + [("ycbcr",)]
    try:
        for h, w, crop in A7_SEEDED:
            big = cs.seeded_xyb(h + 3, w + 5, rng, 1.6).to(dev)
            x = big[:, 1:h + 1, 1:w + 1] if crop else big[:, :h, :w] \
                .contiguous()
            n = 0
            for spec in specs:
                for bits in (8, 16):
                    for down in (1, 4):
                        want = None
                        for tag, fn in builds:
                            POST._kernels = lambda fn=fn: orig()[:2] + (fn,)
                            got = (POST.encode_output(x, spec, bits)
                                   if down == 1 else
                                   POST.encode_output_down(x, spec, bits, 4))
                            want = got if want is None else want
                            if not torch.equal(got, want):
                                raise AssertionError(
                                    f"{tag}: A7 seeded {w}x{h} {spec[:2]} "
                                    f"{bits}-bit down {down} differs")
                        n += 1
            print(f"A7 seeded {w}x{h}{' (a cropped view)' if crop else ''}: "
                  f"{n} spec / depth / pool cases, {len(builds)} builds, 0 "
                  f"codes differ from the first build's [{card}]", flush=True)
    finally:
        POST._kernels = orig


def sass_of(so: Path, out: Path) -> None:
    """cuobjdump -sass of a library into `out`."""
    text = subprocess.run([str(Path(_build._nvcc()).parent / "cuobjdump"),
                           "-sass", str(so)], capture_output=True, text=True,
                          check=True).stdout
    out.write_text(text)


def time_a7(others, this, dev, card) -> None:
    builds = others + [("this", this)]
    a7_seeded_equal(builds, dev, card)
    calls = a7_calls(dev)
    cases = []
    for label, xyb, spec, bits in calls:
        cases.append((f"main path {label} {tuple(xyb.shape)} {spec[:2]} "
                      f"{bits}-bit",
                      lambda x=xyb, s=spec, b=bits: POST.encode_output(x, s, b),
                      lambda x=xyb, s=spec, b=bits:
                      POST.encode_output_plain(x, s, b)))
    pq = next(c for c in calls if c[0] == "4k_rgba16_noise_pq")[1]
    for key in cs.POST_SPECS:
        spec = cs.post_spec(key)
        for bits in (8, 16):
            cases.append((f"4k PQ planes {key} {bits}-bit",
                          lambda s=spec, b=bits: POST.encode_output(pq, s, b),
                          lambda s=spec, b=bits:
                          POST.encode_output_plain(pq, s, b)))
    cases.append(("4k PQ planes ycbcr 8-bit (A7y)",
                  lambda: POST.encode_output(pq, ("ycbcr",), 8),
                  lambda: POST.encode_output_plain(pq, ("ycbcr",), 8)))
    # large sRGB frames, seeded (an upsampled frame's output at 5136x3856
    # and 10272x7712; the main path's 4x and 8x streams are 1284x964)
    rng = np.random.default_rng(29)
    for h, w in ((3856, 5136), (7712, 10272)):
        big = cs.seeded_xyb(h, w, rng).to(dev)
        cases.append((f"seeded {w}x{h} srgb 8-bit",
                      lambda x=big: POST.encode_output(x, ("srgb",), 8),
                      lambda x=big: POST.encode_output_plain(x, ("srgb",),
                                                             8)))
    # seeded frames between the 720x480 and 1284x964 ones, where
    # pixels_a_thread changes side (one pixel a thread below 1.08 MP on
    # 132 SMs)
    for h, w in ((540, 960), (720, 1280)):
        mid = cs.seeded_xyb(h, w, rng).to(dev)
        for key, bits in (("srgb", 8), ("bt709", 8), ("pq_2100", 16)):
            spec = cs.post_spec(key)
            cases.append((f"seeded {w}x{h} {key} {bits}-bit",
                          lambda x=mid, s=spec, b=bits:
                          POST.encode_output(x, s, b),
                          lambda x=mid, s=spec, b=bits:
                          POST.encode_output_plain(x, s, b)))
    up2 = next(c for c in calls if c[0] == "4k_from_fhd_up2")[1]
    cases.append(("S1 4k quarter srgb 8-bit",
                  lambda: POST.encode_output_down(up2, ("srgb",), 8, 4),
                  lambda: POST.encode_output_down_plain(up2, ("srgb",), 8,
                                                        4)))
    a7_turns(builds, cases, card)


def main() -> int:
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    only = next((a.split("=", 1)[1] for a in sys.argv[1:]
                 if a.startswith("--only=")), None)
    sass = next((Path(a.split("=", 1)[1]) for a in sys.argv[1:]
                 if a.startswith("--sass=")), None)
    if not args:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("modular_vs_other: torch sees no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = cs.smi()
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    this_a2 = MDEV._kernels()
    this_s3 = RESIZE._kernel()
    this_a10 = COMPOSE._kernel()
    this_a9 = OV._kernels()[1]
    this_a7 = POST._kernels()[2]
    a2, s3, a10, a9, a7 = [], [], [], [], []
    for n, arg in enumerate(args):
        src = Path(arg).resolve()
        if only in (None, "a2"):
            a2.append((arg, build(src, "modular", n, "jxl_unsqueeze",
                                  this_a2[0].argtypes[:-1])))
        if only in (None, "s3"):
            s3.append((arg, build(src, "sample", n, "jxl_resample",
                                  this_s3.argtypes[:-1])))
        if only in (None, "a10"):
            a10.append((arg, build(src, "compose", n, "jxl_compose",
                                   this_a10.argtypes[:-1])))
        if only in (None, "a9"):
            try:
                a9.append((arg, build(src, "overlay", n, "jxl_draw_splines",
                                      this_a9.argtypes[:-1])))
            except AttributeError as e:
                print(f"A9: cannot bind {arg}'s jxl_draw_splines: {e}",
                      flush=True)
        if only in (None, "a7"):
            a7.append((arg, build(src, "post", n, "jxl_encode_output",
                                  this_a7.argtypes[:-1])))
    if only in (None, "a2"):
        time_a2(a2, this_a2, dev, card)
    if only in (None, "s3"):
        time_s3(s3, this_s3, dev, card)
    if only in (None, "a10"):
        cs.ptxas_report("compose")
        for n, arg in enumerate(args):
            cs.ptxas_report("compose", _build.BUILD_DIR /
                            f"libcompose-other{n}.log", f"{arg} ")
        time_a10(a10, this_a10, dev, card)
    if only in (None, "a9"):
        cs.ptxas_report("overlay", only="splines_kernel")
        for n, arg in enumerate(args):
            cs.ptxas_report("overlay", _build.BUILD_DIR /
                            f"liboverlay-other{n}.log", f"{arg} ",
                            only="splines_kernel")
        time_a9(a9, this_a9, dev, card)
    if only in (None, "a7"):
        cs.ptxas_report("post")
        for n, arg in enumerate(args):
            cs.ptxas_report("post", _build.BUILD_DIR /
                            f"libpost-other{n}.log", f"{arg} ")
        if sass is not None:
            sass.mkdir(parents=True, exist_ok=True)
            sass_of(_build.library_path("post"), sass / "post_this.sass")
            for n in range(len(args)):
                sass_of(_build.BUILD_DIR / f"libpost-other{n}.so",
                        sass / f"post_other{n}.sass")
        time_a7(a7, this_a7, dev, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
