"""Patches and splines in the PyTorch port (jxl_coder_tpu_torch) on the
CPU, against the JAX package on the same bytes.

- The host copies (host/vardct/patches.py, splines.py, enc_patches.py and
  the host encoder's patch path) against their originals: the patch
  dictionary and the splines read from the same LfGlobal, patches_to_affine,
  Splines.render, and the effort-7 encoder's bytes, equal exactly.
- The overlay kernels' plain twins (vardct/overlay.py): overlay_patches
  against X * mul + add of patches_to_affine (the JAX device route's
  overlay) within one f32 rounding a blend (the twin blends in sequence,
  the JAX route composes mul and add first); draw_splines' fp64 sums
  against Splines.render within 1e-12 (torch's exp against numpy's), its
  planes against X + f32(render) within one f32 ulp; the tile lists
  against a brute-force walk.
- api.decode(..., device="cpu") on both entropy routes, and decode_batch,
  on the JAX encoder's patched text streams and on spline streams, within
  the north star's contract (ROADMAP.md: at most 1 code, on under 0.1% of
  values) of jxl_coder_tpu.api.decode on both of its routes and of the
  port's float64 host decoder.
"""

import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from jxl_coder_tpu import api as ref_api
from jxl_coder_tpu.bitstream.reader import BitReader as JBitReader
from jxl_coder_tpu.vardct import dec_real as JDEC
from jxl_coder_tpu.vardct import patches as JP
from jxl_coder_tpu.vardct import splines as JS
from jxl_coder_tpu.vardct.enc_real import encode_vardct_real
from jxl_coder_tpu_torch import api, reference
from jxl_coder_tpu_torch.host.bitstream.reader import BitReader
from jxl_coder_tpu_torch.host.vardct import dec_real as PDEC
from jxl_coder_tpu_torch.host.vardct import patches as PP
from jxl_coder_tpu_torch.vardct import overlay as OV
import port_fixtures as F

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "research"))

SIZES = [(192, 256), (181, 243)]       # the test image's, and a ragged one


@pytest.fixture(scope="module")
def patched():
    """size -> the JAX encoder's effort-7 stream of F.text_frame (two
    frames: the Modular atlas, then the VarDCT frame with patches)."""
    return {hw: encode_vardct_real(F.text_frame(*hw), distance=1.0,
                                   effort=7) for hw in SIZES}


def _lf_global(data, pkg):
    """LfGlobal of the frame to decode, read by the port (pkg "port") or
    the JAX package."""
    cs, hdr, fh, toc = api._read_frame(data)
    s = toc.section(0)
    w, h = fh.coded_size(hdr)
    if pkg == "port":
        return PDEC.read_lf_global(BitReader(cs[s.offset:s.offset + s.size]),
                                   fh, hdr, w, h)
    from jxl_coder_tpu.bitstream.frame_header import (read_frame_header,
                                                      read_toc)
    from jxl_coder_tpu.bitstream.headers import read_image_header
    from jxl_coder_tpu.bitstream import container
    jcs = container.extract_codestream(data).codestream
    br = JBitReader(jcs)
    jhdr = read_image_header(br)
    while True:
        jfh = read_frame_header(br, jhdr)
        ng, ndc = jfh.counts(jhdr)
        n = 1 if (ng == 1 and jfh.passes.num_passes == 1) else (
            2 + ndc + ng * jfh.passes.num_passes)
        jtoc = read_toc(br, n)
        if jfh.frame_type not in (1, 2):
            break
        br.pos = jtoc.end_offset * 8
    s = jtoc.section(0)
    return JDEC.read_lf_global(JBitReader(jcs[s.offset:s.offset + s.size]),
                               jfh, jhdr, w, h)


def _contract(got, ref):
    """At most 1 code, on under 0.1% of values (8-bit colour); extra
    channels equal."""
    assert got.shape == ref.shape and got.dtype == ref.dtype
    d = np.abs(got[..., :3].astype(np.int64) - ref[..., :3].astype(np.int64))
    assert d.max() <= 1 and (d > 0).mean() < 1e-3, (d.max(), (d > 0).mean())
    assert np.array_equal(got[..., 3:], ref[..., 3:])


def _jax_decode(data, monkeypatch, route):
    monkeypatch.setenv("JXL_TPU_DEVICE", route)
    monkeypatch.setenv("JXL_TPU_DEVICE_STRICT", route)
    return ref_api.decode(data)[0]


def _check_decode(data, monkeypatch, routes=("host", "device")):
    host = reference.decode_float64(data)
    refs = [_jax_decode(data, monkeypatch, r) for r in ("1", "0")]
    for entropy in routes:
        got, _info = api.decode(data, device="cpu", entropy=entropy)
        for ref in [host] + refs:
            _contract(got, ref)
    return host


# ---- the host copies against their originals ----

@pytest.mark.parametrize("hw", SIZES)
def test_host_encoder_writes_the_jax_encoders_patched_bytes(patched, hw):
    img = F.text_frame(*hw)
    data = reference.encode_vardct(img, distance=1.0, effort=7)
    assert data == patched[hw]
    cs, hdr, frames = api._read_frames(data)
    assert [fh.frame_type for fh, _ in frames] == [2, 0]
    assert frames[1][0].flags & 0x2


def test_patch_dictionary_read_equals_the_original(patched):
    mine = _lf_global(patched[SIZES[0]], "port").patches
    ref = _lf_global(patched[SIZES[0]], "jax").patches
    assert len(mine.patches) >= 10
    assert [vars(r) for r in mine.rects] == [vars(r) for r in ref.rects]
    assert [vars(p) for p in mine.patches] == [vars(p) for p in ref.patches]


def _seeded_refs(rng, sizes):
    return {slot: [rng.normal(0.3, 0.4, (h, w)).astype(np.float32)
                   for _ in range(3)] for slot, (h, w) in sizes.items()}


def _seeded_dictionary(rng, h, w, refs, mode_list):
    """Port and JAX PatchDictionaries of the same seeded patches (every
    mode of mode_list, some overlapping)."""
    rects, patches, jrects, jpatches = [], [], [], []
    for i, (mode, clamp) in enumerate(mode_list):
        slot = sorted(refs)[i % len(refs)]
        rh, rw = refs[slot][0].shape
        pw, ph = int(rng.integers(1, min(rw, 20))), \
            int(rng.integers(1, min(rh, 20)))
        x0, y0 = int(rng.integers(0, rw - pw + 1)), \
            int(rng.integers(0, rh - ph + 1))
        rects.append(PP.RefRect(slot, x0, y0, pw, ph))
        jrects.append(JP.RefRect(slot, x0, y0, pw, ph))
        for _ in range(int(rng.integers(1, 4))):
            x, y = int(rng.integers(0, w - pw + 1)), \
                int(rng.integers(0, h - ph + 1))
            patches.append(PP.Patch(i, x, y, [(mode, 0, clamp)]))
            jpatches.append(JP.Patch(i, x, y, [(mode, 0, clamp)]))
    return (PP.PatchDictionary(rects, patches),
            JP.PatchDictionary(jrects, jpatches))


MODES = [(m, c) for m in range(PP.NUM_BLEND_MODES)
         for c in ((False, True) if PP._uses_clamp(m) else (False,))]


def test_patches_to_affine_equals_the_original():
    rng = np.random.default_rng(3)
    refs = _seeded_refs(rng, {0: (30, 40), 3: (25, 33)})
    pd, jpd = _seeded_dictionary(rng, 48, 64, refs, MODES * 2)
    for a, b in zip(PP.patches_to_affine(pd, 48, 64, refs),
                    JP.patches_to_affine(jpd, 48, 64, refs)):
        assert np.array_equal(a, b)
    planes = [rng.normal(0, 1, (48, 64)) for _ in range(3)]
    mine, theirs = [p.copy() for p in planes], [p.copy() for p in planes]
    pd.apply(mine, refs)
    jpd.apply(theirs, refs)
    assert all(np.array_equal(a, b) for a, b in zip(mine, theirs))


def _crafted_splines(W=64, H=64):
    """tests/test_device_post.py:124-146's stream: one spline over a flat
    frame, by research/vardct_write.craft_blocks; and its splines in the
    port's class."""
    import vardct_write
    ys_b, xs_b = H // 8, W // 8
    dc = np.zeros((3, ys_b, xs_b), np.int64)
    dc[0] = 80
    vbs = [(bx, by, 0, {c: np.zeros(64, np.int64) for c in range(3)}, 16)
           for by in range(ys_b) for bx in range(xs_b)]
    cd1 = np.zeros((3, 32), np.int64)
    cd1[1, 0] = 12
    cd1[0, 0] = 30
    sd1 = np.zeros(32, np.int64)
    sd1[0] = 8
    pts = np.array([[8.0, 10.0], [30.0, 44.0], [52.0, 18.0]])
    spl = JS.Splines(quantization_adjustment=2, splines=[
        JS.QuantizedSpline(points=pts, color_dct=cd1, sigma_dct=sd1)])
    return vardct_write.craft_blocks(dc, vbs, W=W, H=H, splines=spl)


def test_splines_read_write_render_equal_the_original():
    data = _crafted_splines()
    mine = _lf_global(data, "port").splines
    ref = _lf_global(data, "jax").splines
    assert mine.quantization_adjustment == ref.quantization_adjustment
    for a, b in zip(mine.splines, ref.splines):
        assert np.array_equal(a.points, b.points)
        assert np.array_equal(a.color_dct, b.color_dct)
        assert np.array_equal(a.sigma_dct, b.sigma_dct)
    seeded = F.seeded_splines(70, 90, 6)
    from jxl_coder_tpu_torch.host.bitstream.writer import BitWriter
    from jxl_coder_tpu.bitstream.writer import BitWriter as JBitWriter
    bw, jbw = BitWriter(), JBitWriter()
    seeded.write(bw)
    JS.Splines(seeded.quantization_adjustment, [
        JS.QuantizedSpline(s.points, s.color_dct, s.sigma_dct)
        for s in seeded.splines]).write(jbw)
    assert bw.to_bytes() == jbw.to_bytes()
    for spl, jspl, (h, w) in ((mine, ref, (64, 64)), (seeded, JS.Splines(
            seeded.quantization_adjustment, [JS.QuantizedSpline(
                s.points, s.color_dct, s.sigma_dct)
                for s in seeded.splines]), (70, 90))):
        a = [np.zeros((h, w)) for _ in range(3)]
        b = [np.zeros((h, w)) for _ in range(3)]
        spl.render(a, base_cx=0.1, base_cb=0.9)
        jspl.render(b, base_cx=0.1, base_cb=0.9)
        assert all(np.array_equal(x, y) for x, y in zip(a, b))
        assert max(np.abs(x).max() for x in a) > 0


# ---- the kernels' plain twins ----

def test_tile_lists_equal_a_brute_force_walk():
    rng = np.random.default_rng(9)
    h, w = 70, 150
    x0 = rng.integers(0, w, 40)
    y0 = rng.integers(0, h, 40)
    x1 = np.minimum(x0 + rng.integers(0, 90, 40), w - 1)
    y1 = np.minimum(y0 + rng.integers(0, 30, 40), h - 1)
    tiles, offs, items = OV.tile_lists(x0, x1, y0, y1, h, w)
    tiles_x = -(-w // OV.TILE_W)
    want = {}
    for i in range(40):
        for ty in range(-(-h // OV.TILE_H)):
            for tx in range(tiles_x):
                if (x0[i] < (tx + 1) * OV.TILE_W and x1[i] >= tx * OV.TILE_W
                        and y0[i] < (ty + 1) * OV.TILE_H
                        and y1[i] >= ty * OV.TILE_H):
                    want.setdefault(ty * tiles_x + tx, []).append(i)
    assert tiles.tolist() == sorted(want)
    assert [items[offs[k]:offs[k + 1]].tolist()
            for k in range(len(tiles))] == [want[t] for t in sorted(want)]
    empty = OV.tile_lists([], [], [], [], h, w)
    assert [a.tolist() for a in empty] == [[], [0], []]


@pytest.mark.parametrize("modes", [[m] * 3 for m in MODES] + [MODES * 2],
                         ids=[f"mode{m}-clamp{int(c)}" for m, c in MODES]
                         + ["all"])
def test_overlay_patches_twin_against_patches_to_affine(modes):
    """A8's twin (blends in sequence) against the JAX route's X * mul + add
    of patches_to_affine (mul and add composed first): each blend rounds
    once in f32, so they differ by at most one f32 ulp of the value's
    magnitude per blend a pixel takes."""
    rng = np.random.default_rng(len(modes) * 31 + modes[0][0])
    h, w = 48, 70
    refs = _seeded_refs(rng, {1: (30, 40), 2: (20, 25)})
    pd, jpd = _seeded_dictionary(rng, h, w, refs, modes)
    mul, add = JP.patches_to_affine(jpd, h, w, refs)
    xyb = rng.normal(0.2, 0.5, (3, h, w)).astype(np.float32)
    want = xyb * mul + add
    ov = OV.Overlay.of(SimpleNamespace(patches=pd, splines=None), h, w)
    ov.check_sources({s: r[0].shape for s, r in refs.items()})
    got = torch.from_numpy(xyb.copy())
    trefs = {s: torch.from_numpy(np.stack(r)) for s, r in refs.items()}
    dev = ov.to("cpu")
    OV.overlay_patches(got, trefs, dev.patches, *dev.patch_tiles)
    got = got.numpy()
    blends = np.zeros((h, w))
    for p in pd.patches:
        r = pd.rects[p.rect_idx]
        if p.blendings[0][0] != PP.BLEND_NONE:
            blends[p.y:p.y + r.ysize, p.x:p.x + r.xsize] += 1
    mag = np.maximum.reduce([np.abs(got), np.abs(want), np.abs(xyb)]) + \
        np.abs(add) + 1e-30
    tol = (blends + 1) * np.spacing(mag.astype(np.float32))
    assert np.all(np.abs(got - want) <= tol), np.abs(got - want).max()
    # untouched pixels stay as they were, bit for bit
    assert np.array_equal(got[:, blends == 0], xyb[:, blends == 0])
    # and the float64 host oracle agrees to f32 precision
    planes = [xyb[c].astype(np.float64) for c in range(3)]
    pd.apply(planes, refs)
    assert np.abs(np.stack(planes) - got).max() < 1e-5


def test_overlay_patches_raises_on_a_source_outside_its_reference():
    pd = PP.PatchDictionary([PP.RefRect(1, 5, 0, 10, 4)],
                            [PP.Patch(0, 0, 0, [(PP.BLEND_ADD, 0, False)])])
    ov = OV.Overlay.of(SimpleNamespace(patches=pd, splines=None), 20, 20)
    with pytest.raises(Exception, match="outside"):
        ov.check_sources({1: (8, 12)})
    with pytest.raises(Exception, match="missing frame slot 1"):
        ov.check_sources({0: (8, 40)})


@pytest.mark.parametrize("seed", [5, 6])
def test_draw_splines_twin_against_render(seed):
    h, w = 70, 90
    spl = F.seeded_splines(h, w, 6, seed)
    lf = SimpleNamespace(patches=None, splines=spl, cfl_color_factor=84,
                         cfl_base_x=0.0, cfl_base_b=1.0, cfl_ytox_dc=3,
                         cfl_ytob_dc=-2)
    ov = OV.Overlay.of(lf, h, w)
    cf = 1.0 / 84
    oracle = [np.zeros((h, w)) for _ in range(3)]
    spl.render(oracle, base_cx=3 * cf, base_cb=1.0 - 2 * cf)
    oracle = np.stack(oracle)
    dev = ov.to("cpu")
    sums, touched = OV.spline_sums_plain(dev.points, dev.boxes, h, w)
    assert touched.any()
    assert np.abs(sums.numpy() - oracle).max() <= 1e-12
    assert np.array_equal(oracle[:, ~touched.numpy()], 0 * oracle[
        :, ~touched.numpy()])
    rng = np.random.default_rng(seed)
    xyb = rng.normal(0.2, 0.5, (3, h, w)).astype(np.float32)
    got = OV.draw_splines(torch.from_numpy(xyb.copy()), dev.points,
                          dev.boxes, *dev.point_tiles).numpy()
    want = xyb + oracle.astype(np.float32)
    assert np.all(np.abs(got - want) <= np.spacing(np.abs(want)))



def test_longest_first_keeps_each_tiles_list():
    """longest_first reorders tile_lists' tiles by list length, longest
    first and ties in tile order, each tile keeping its items in order."""
    rng = np.random.default_rng(3)
    h, w = 150, 333
    x0 = rng.integers(0, w, 60)
    y0 = rng.integers(0, h, 60)
    x1 = np.minimum(x0 + rng.integers(0, 90, 60), w - 1)
    y1 = np.minimum(y0 + rng.integers(0, 40, 60), h - 1)
    tiles, offs, items = OV.tile_lists(x0, x1, y0, y1, h, w)
    lt, lo, li = OV.longest_first(tiles, offs, items)
    n = np.diff(lo)
    assert sorted(lt.tolist()) == tiles.tolist() and n[0] > n[-1]
    assert np.all(n[:-1] >= n[1:])
    for k, t in enumerate(lt):
        i = int(np.flatnonzero(tiles == t)[0])
        assert np.array_equal(li[lo[k]:lo[k + 1]], items[offs[i]:offs[i + 1]])
        if k and n[k] == n[k - 1]:
            assert lt[k - 1] < t
    assert lo.dtype == np.int32 and li.dtype == np.int32


# ---- csrc/overlay.cuh, A9's walk, built with g++ ----

_OVERLAY_RUN = r"""
#include <algorithm>
#include <vector>
#include "overlay.cuh"
using namespace jxl_ov;

// A9 (overlay.cu splines_kernel) tile after tile: warp 0's staging lane by
// lane (the prefix sum in lane order), then each chunk's phases for the
// block's threads one after another, as between the kernel's barriers
extern "C" void spl_chunked(float* xyb, long long plane, int H, int W,
                            const double* points, const int* boxes,
                            const int* tiles, const int* offs,
                            const int* items, int ntiles, int tiles_x) {
  const SplineArgs a{xyb, plane, H, W, points, boxes, tiles, offs, items,
                     tiles_x};
  std::vector<SplineShared> sv(1);
  SplineShared& s = sv[0];
  std::vector<PixelSums> ps(kThreads);
  for (int blk = 0; blk < ntiles; ++blk) {
    int tx0, ty0;
    tile_origin(a, blk, tx0, ty0);
    const int begin = offs[blk], end = offs[blk + 1];
    const int nch = (end - begin + kChunk - 1) / kChunk;
    for (PixelSums& q : ps) q = PixelSums{};
    auto stage = [&](int ch, int buf) {
      int off = 0;
      for (int k = 0; k < kChunk; ++k) {
        const int idx = begin + ch * kChunk + k;
        s.off[buf][k] = off;
        if (idx >= end) continue;
        PointLoad p;
        load_point(a, items[idx], p);
        Box cl;
        const int cnt = clip_point(p, tx0, ty0, cl);
        stage_point(p, cl, off, cnt, k, buf, s);
        off += cnt;
      }
      s.off[buf][kChunk] = off;
    };
    stage(0, 0);
    for (int ch = 0; ch < nch; ++ch) {
      const int buf = ch & 1;
      const int nk = std::min(kChunk, end - begin - ch * kChunk);
      for (int t = 0; t < kThreads; ++t) chunk_erfs(t, buf, s);
      for (int t = 0; t < kThreads; ++t) {
        int tx, ty;
        pixel_of(t, tx, ty);
        chunk_accumulate(tx, ty, tx0, ty0, buf, nk, s, ps[t]);
      }
      if (ch + 1 < nch) stage(ch + 1, buf ^ 1);
    }
    for (int t = 0; t < kThreads; ++t) {
      int tx, ty;
      pixel_of(t, tx, ty);
      write_pixels(tx, ty, tx0, ty0, a, ps[t]);
    }
  }
}

extern "C" void spl_by_points(float* xyb, long long plane, int H, int W,
                              const double* points, const int* boxes,
                              const int* tiles, const int* offs,
                              const int* items, int ntiles, int tiles_x) {
  const SplineArgs a{xyb, plane, H, W, points, boxes, tiles, offs, items,
                     tiles_x};
  for (int blk = 0; blk < ntiles; ++blk) tile_by_points(a, blk);
}
"""


@pytest.fixture(scope="module")
def overlay_host(tmp_path_factory):
    """csrc/overlay.cuh built for the host with g++ (no FMA contraction,
    as the kernel's -fmad=false)."""
    import ctypes
    import shutil
    import subprocess
    from jxl_coder_tpu_torch import _build
    gxx = shutil.which("g++")
    assert gxx, "g++ builds the port's host codec; it is needed here too"
    tmp = tmp_path_factory.mktemp("overlay")
    cpp, so = tmp / "run.cpp", tmp / "librun.so"
    cpp.write_text(_OVERLAY_RUN)
    subprocess.run([gxx, "-O2", "-std=c++17", "-Wall", "-Werror",
                    "-ffp-contract=off", "-shared", "-fPIC", "-I",
                    str(_build.CSRC), "-o", str(so), str(cpp)], check=True)
    lib = ctypes.CDLL(str(so))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for fn in (lib.spl_chunked, lib.spl_by_points):
        fn.argtypes = [p, ll, i, i] + [p] * 5 + [i, i]
    return lib


# frames that are not a multiple of the 64 x 16 tile, with tiles that list
# several chunks (32 points) of points and boxes that the tiles cut
@pytest.mark.parametrize("h,w,n,seed", [(70, 150, 6, 5), (45, 203, 8, 6),
                                        (96, 128, 12, 7)])
def test_kernel_spline_chunks_equal_the_point_walk(overlay_host, h, w, n,
                                                   seed):
    """A9's chunked walk (overlay.cuh: staging, each boundary erf once, the
    pixels' sums in list order) against the point-by-point walk of the
    kernel it replaced (each point's 64 + 16 erf differences of its tile),
    both built with g++: the planes equal to the bit; and within 1e-6 of
    draw_splines_plain (glibc's exp against torch's)."""
    spl = F.seeded_splines(h, w, n, seed)
    pts, boxes = spl.points(h, w)
    pts = np.ascontiguousarray(pts, np.float64)
    boxes = np.ascontiguousarray(boxes, np.int32)
    tiles, offs, items = OV.longest_first(*OV.tile_lists(
        boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3], h, w))
    assert np.diff(offs).max() > 2 * 32
    tx, ty = tiles % -(-w // OV.TILE_W), tiles // -(-w // OV.TILE_W)
    per = np.repeat(np.arange(len(tiles)), np.diff(offs))
    cut = ((boxes[items, 0] < tx[per] * OV.TILE_W) |
           (boxes[items, 3] >= (ty[per] + 1) * OV.TILE_H))
    assert cut.any() and not cut.all()
    rng = np.random.default_rng(seed)
    xyb = rng.normal(0.2, 0.5, (3, h, w)).astype(np.float32)
    got, walk = xyb.copy(), xyb.copy()
    lists = [pts, boxes, tiles, offs, items]
    for fn, out in ((overlay_host.spl_chunked, got),
                    (overlay_host.spl_by_points, walk)):
        fn(out.ctypes.data, h * w, h, w, *[a.ctypes.data for a in lists],
           len(tiles), -(-w // OV.TILE_W))
    assert np.array_equal(got.view(np.int32), walk.view(np.int32))
    assert (got != xyb).any()
    want = OV.draw_splines_plain(torch.from_numpy(xyb.copy()),
                                 torch.from_numpy(pts),
                                 torch.from_numpy(boxes)).numpy()
    assert np.abs(got - want).max() <= 1e-6

@pytest.mark.parametrize("h,w,n,seed", [(70, 150, 6, 5), (45, 203, 8, 6)])
def test_kernel_spline_chunks_skip_listed_points_that_miss_the_tile(
        overlay_host, h, w, n, seed):
    """Tile lists that name every point in every tile, most of them with a
    box that misses the tile: A9's chunked walk gives such a point no
    boundaries and no pixels, as the point-by-point walk skips it, so the
    planes equal the exact lists' to the bit."""
    spl = F.seeded_splines(h, w, n, seed)
    pts, boxes = spl.points(h, w)
    pts = np.ascontiguousarray(pts, np.float64)
    boxes = np.ascontiguousarray(boxes, np.int32)
    tiles, offs, items = OV.tile_lists(
        boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3], h, w)
    nt = -(-h // OV.TILE_H) * -(-w // OV.TILE_W)
    every = (np.arange(nt, dtype=np.int32),
             np.arange(0, nt + 1, dtype=np.int32) * len(pts),
             np.tile(np.arange(len(pts), dtype=np.int32), nt))
    assert len(every[2]) > 2 * len(items)
    xyb = np.random.default_rng(seed).normal(
        0.2, 0.5, (3, h, w)).astype(np.float32)
    outs = []
    for fn, lists in ((overlay_host.spl_chunked, every),
                      (overlay_host.spl_by_points, every),
                      (overlay_host.spl_chunked, (tiles, offs, items))):
        out = xyb.copy()
        args = [pts, boxes, *lists]
        fn(out.ctypes.data, h * w, h, w, *[a.ctypes.data for a in args],
           len(lists[0]), -(-w // OV.TILE_W))
        outs.append(out.view(np.int32))
    assert np.array_equal(outs[0], outs[1])
    assert np.array_equal(outs[0], outs[2])
    assert (outs[0] != xyb.view(np.int32)).any()


# ---- decodes ----

@pytest.mark.parametrize("hw", SIZES)
def test_patched_text_decodes_within_the_contract(patched, hw,
                                                  monkeypatch):
    data = patched[hw]
    # the device entropy route's plain twin takes one step per token: one
    # size is enough for it
    host = _check_decode(data, monkeypatch, ("host", "device")
                         if hw == SIZES[0] else ("host",))
    assert host.shape == hw + (3,)
    cfg, inputs, _hdr = api.prepare(data, "cpu")
    assert cfg.post is not None and cfg.post.overlay is not None
    assert inputs.refs is not None and set(inputs.refs) == {1}
    assert not cfg.post.colour_empty


def test_spline_streams_decode_within_the_contract(monkeypatch):
    # craft_blocks writes prefix codes, which the device entropy route
    # does not read (entropy/device.py)
    _check_decode(_crafted_splines(), monkeypatch, routes=("host",))
    base = reference.encode_vardct(F.bench_frame(72, 104), distance=1.0,
                                   effort=7)
    spliced = F.with_splines(base, F.seeded_splines(72, 104, 4))
    cfg, _inputs, _hdr = api.prepare(spliced, "cpu")
    assert len(cfg.post.overlay.points) > 100
    _check_decode(spliced, monkeypatch)
    # the splices leave the frame's own sections as they were
    plain = api.decode(base, device="cpu")[0]
    assert np.abs(api.decode(spliced, device="cpu")[0].astype(int)
                  - plain.astype(int)).max() > 0


def test_decode_batch_takes_patched_and_spline_streams(patched):
    spliced = F.with_splines(reference.encode_vardct(
        F.bench_frame(40, 72), distance=1.0, effort=7),
        F.seeded_splines(40, 72, 2))
    datas = [patched[SIZES[0]], spliced, patched[SIZES[1]],
             reference.encode_vardct(F.smooth_frame(40, 56), distance=1.0,
                                     effort=5), _crafted_splines()]
    for entropy in ("host", "device"):
        if entropy == "device":
            # the small ones (the device route's plain twin takes a step a
            # token), and no prefix codes (the host route only)
            datas = datas[1:2] + datas[3:4]
        outs = api.decode_batch(datas, device="cpu", entropy=entropy)
        for out, data in zip(outs, datas):
            assert np.array_equal(
                out, api.decode(data, device="cpu", entropy=entropy)[0])


def test_patches_without_their_reference_frame_raise(patched):
    """The main frame of a patched stream alone: its patches' source was
    never decoded."""
    cs, hdr, frames = api._read_frames(patched[SIZES[0]])
    fh, toc = frames[-1]
    from jxl_coder_tpu_torch.host.bitstream.writer import BitWriter
    from jxl_coder_tpu_torch.host.codec import write_image_header
    bw = BitWriter()
    write_image_header(bw, hdr)
    F._frame_bytes(bw, hdr, fh, F._sections(cs, toc))
    with pytest.raises(api.InvalidJXLError, match="missing frame slot 1"):
        api.decode(bw.to_bytes(), device="cpu")
