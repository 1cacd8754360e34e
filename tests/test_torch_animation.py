"""The animated decode of the PyTorch port on the CPU (the kernels' plain
twins) against the JAX package on the same bytes: ``decode_frames``,
``AnimatedImage`` (its index, durations, frames in random order, scaled
frames), ``api.decode`` / ``decode_thumbnail`` / ``decode_batch`` of an
animation, the playback surface, ``decode_frames_batch``, the frame
composition (A10's twin and ``csrc/compose.cuh`` built with g++, against
``jxl_coder_tpu.api._compose_frame``) and the fixture writers.

Tolerances: lossless frames and every composition are equal; lossy frames
within 1 code on under 0.1% of values (the port reconstructs in float32
where the JAX package's host decoder runs float64); a scaled frame within
1 code (S3's twin sums in another order than the JAX rescale).  The
round-1 batch is held to the same 1-code contract against the JAX
package's legacy branch and its per-frame decode, and is equal to the
port's per-frame round-1 decode at frame 0's distance.  On this file's 4
round-1 frames of 40x264 the port's batch differs from the JAX branch in
1 value of 126,720 and from the JAX per-frame decode in 2, by 1 code;
the JAX branch differs from its own per-frame decode in 1 (XLA fuses the
vmapped chain otherwise).
"""

import ctypes
import shutil
import subprocess
import threading
from types import SimpleNamespace as NS

import numpy as np
import pytest
import torch

from jxl_coder_tpu import animation as ref_anim
from jxl_coder_tpu import api as ref_api
from jxl_coder_tpu import codec as ref_codec
from jxl_coder_tpu_torch import _build, animation, api, codec
from jxl_coder_tpu_torch.ops import compose as C
import port_fixtures as F

H, W = 40, 48          # the small animations' canvas
SH, SW = 16, 20        # the sprites


def _rgba_frames(n: int, seed: int, nch: int = 4):
    """Seeded moving frames: a gradient that shifts, noise, alpha runs."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:H, 0:W]
    out = []
    for k in range(n):
        f = rng.integers(0, 256, (H, W, nch)).astype(np.uint8)
        f[..., 0] = ((x * 5 + y * 3 + 17 * k) % 256).astype(np.uint8)
        f[..., 1] = ((x - y * 2 + 40 * k) % 256).astype(np.uint8)
        if nch == 4:
            f[..., 3][(x + y + k) % 7 == 0] = 0
        out.append(f)
    return out


@pytest.fixture(scope="module")
def streams():
    return {
        "sprites": F.sprite_animation(H, W, SH, SW),
        "lossless_rgba": F.animated_stream(_rgba_frames(5, 1), True,
                                           num_loops=3,
                                           durations=[40, 0, 60, 30, 50]),
        "lossy_rgb": F.animated_stream(_rgba_frames(4, 2, 3), False, 90),
        "lossy_rgba": F.animated_stream(_rgba_frames(4, 3), False, 85),
    }


def _within_contract(got, ref):
    assert got.shape == ref.shape and got.dtype == ref.dtype
    d = np.abs(got.astype(np.int64) - ref.astype(np.int64))
    assert d.max() <= 1 and (d > 0).mean() < 1e-3, (d.max(), (d > 0).mean())


def _same(label, got, ref):
    if label.startswith("lossy"):
        _within_contract(got, ref)
    else:
        assert got.dtype == ref.dtype and np.array_equal(got, ref)


# ---- the fixture writers ---------------------------------------------------

@pytest.mark.parametrize("lossless", [True, False])
@pytest.mark.parametrize("nch", [3, 4])
def test_animated_stream_equals_the_jax_encoder(lossless, nch):
    frames = _rgba_frames(3, 7 + nch, nch)
    enc = ref_anim.AnimatedEncoder(W, H, num_loops=2, lossless=lossless,
                                   quality=80)
    for f, d in zip(frames, (30, 0, 70)):
        enc.add_frame(f, d)
    assert F.animated_stream(frames, lossless, 80, num_loops=2,
                             durations=[30, 0, 70]) == enc.encode()


@pytest.mark.parametrize("nch,dtype", [(1, np.uint8), (3, np.uint16),
                                       (4, np.uint16)])
def test_lossless_animations_of_other_layouts(nch, dtype):
    """Grey and 16-bit frames: the writer's bytes equal the JAX encoder's
    and decode_frames equals jxl_coder_tpu's."""
    rng = np.random.default_rng(nch)
    frames = [rng.integers(0, np.iinfo(dtype).max + 1, (24, 20, nch))
              .astype(dtype) for _ in range(3)]
    enc = ref_anim.AnimatedEncoder(20, 24, lossless=True)
    for f in frames:
        enc.add_frame(f, 50)
    data = enc.encode()
    assert F.animated_stream(frames, True, durations=[50] * 3) == data
    got, durations, _ = api.decode_frames(data, device="cpu")
    ref, ref_durations, _ = ref_api.decode_frames(data)
    assert durations == ref_durations
    assert all(a.dtype == b.dtype and np.array_equal(a, b)
               for a, b in zip(got, ref))


def _patched_animation():
    """An animation whose frames read patches: a reference-only VarDCT
    frame saved before the colour transform (slot 2), then two patched
    VarDCT frames with durations, the first saved to slot 1 and the
    second blended over it with a crop (the JAX package's
    _decode_reference_frame / _decode_one_frame(ref_frames=) route)."""
    from jxl_coder_tpu_torch import reference
    from jxl_coder_tpu_torch.host.bitstream.frame_header import (
        BlendingInfo, FrameHeader, FrameType)
    from jxl_coder_tpu_torch.host.bitstream.headers import AnimationHeader
    from jxl_coder_tpu_torch.host.bitstream.writer import BitWriter
    from jxl_coder_tpu_torch.host.codec import write_image_header
    from jxl_coder_tpu_torch.host.vardct import patches as P
    h, w = 48, 64
    img = F.bench_frame(h, w)
    hdr = F._image_header(h, w)
    hdr.metadata.animation = AnimationHeader(tps_numerator=1000,
                                             tps_denominator=1)
    bw = BitWriter()
    write_image_header(bw, hdr)
    reference.encode_vardct(
        np.ascontiguousarray(img[:24, :32]), distance=1.0, effort=5,
        fh=FrameHeader(frame_type=FrameType.REFERENCE_ONLY, is_last=False,
                       save_as_reference=2, save_before_color_transform=True,
                       have_crop=True, frame_width=32, frame_height=24),
        hdr=hdr, into_bw=bw)
    pd = [(2, (0, 0, 20, 12), [(3, 5), (40, 30)], P.BLEND_REPLACE, False),
          (2, (5, 4, 16, 16), [(10, 9)], P.BLEND_ADD, False)]
    reference.encode_vardct(np.roll(img, 5, 1), distance=1.0, effort=5,
                            fh=FrameHeader(is_last=False, duration=100,
                                           save_as_reference=1),
                            hdr=hdr, into_bw=bw,
                            patch_dict_bw=F.patch_dictionary(pd))
    reference.encode_vardct(
        np.ascontiguousarray(img[8:40, 16:56]), distance=1.0, effort=5,
        fh=FrameHeader(is_last=True, duration=100, have_crop=True, x0=16,
                       y0=8, frame_width=40, frame_height=32,
                       blending_info=BlendingInfo(mode=1, source=1)),
        hdr=hdr, into_bw=bw, patch_dict_bw=F.patch_dictionary(
            [(2, (0, 0, 20, 12), [(3, 5)], P.BLEND_REPLACE, False)]))
    bw.zero_pad_to_byte()
    return bw.to_bytes()


def test_patched_animation_equals_the_jax_package():
    data = _patched_animation()
    frames, durations, _ = api.decode_frames(data, device="cpu")
    ref, ref_durations, _ = ref_api.decode_frames(data)
    assert durations == ref_durations == [100, 100]
    for a, b in zip(frames, ref):
        _within_contract(a, b)
    got, want = animation.AnimatedImage(data, "cpu"), \
        ref_anim.AnimatedImage(data)
    _within_contract(got.get_frame(2), want.get_frame(2))
    assert np.array_equal(got.get_frame(2), frames[1])
    # get_frame decodes a full-canvas REPLACE frame alone, without the
    # reference frames its patches read: both packages raise (ROADMAP R11)
    with pytest.raises(ref_api.BitstreamError):
        want.get_frame(1)
    with pytest.raises(api.InvalidJXLError, match="patches"):
        got.get_frame(1)


def test_sprite_animation_covers_the_blend_modes(streams):
    """Every colour mode with and without clamp, offsets before, past and
    outside the canvas, and a reference-only frame, as the writer says."""
    img = ref_anim.AnimatedImage(streams["sprites"])
    hs = [e.header for e in img.frames]
    assert hs[1].frame_type == 2
    crops = [h for h in hs if h.have_crop]
    assert {(h.blending_info.mode, h.blending_info.clamp)
            for h in crops} >= {(m, c) for m in range(1, 5)
                                for c in (False, True)} - {(1, True)}
    assert any(h.x0 < 0 for h in crops) and any(h.y0 < 0 for h in crops)
    assert any(h.x0 + h.frame_width > W for h in crops)
    assert any(h.x0 + h.frame_width <= 0 for h in crops)
    assert any(h.duration == 0 for h in crops)


# ---- A10: the composition ------------------------------------------------

def _meta(n_ec, assoc):
    return NS(extra_channels=[NS(alpha_associated=assoc and i == 0)
                              for i in range(n_ec)])


def _blend(mode, alpha=0, clamp=False):
    return NS(mode=mode, alpha_channel=alpha, clamp=clamp)


OFFSETS = {"negative": (-4, -3), "overhanging": (10, 8),
           "outside": (-12, 20), "inside": (3, 2)}


def _compose_case(mode, clamp, assoc, offset, dtype, seed, ncolor=3):
    """A seeded canvas and frame of RGB (or grey) + alpha + depth, the
    colour in `mode`, the alpha channel in the same mode, the depth
    channel in another through the alpha; values at 0 and max included."""
    rng = np.random.default_rng(seed)
    maxv = np.iinfo(dtype).max
    nch = ncolor + 2
    canvas = rng.integers(0, maxv + 1, (14, 17, nch)).astype(dtype)
    pix = rng.integers(0, maxv + 1, (9, 11, nch)).astype(dtype)
    for a in (canvas, pix):
        a[::3, ::2, ncolor] = 0
        a[1::4, 1::3, ncolor] = maxv
        a[2::5, :, 0] = maxv
    x0, y0 = OFFSETS[offset]
    fh = NS(x0=x0, y0=y0, blending_info=_blend(mode, 0, clamp),
            ec_blending_info=[_blend(mode, 0, clamp),
                              _blend((mode + 2) % 5, 0, not clamp)])
    return canvas, pix, fh, _meta(2, assoc)


def _twin_compose(canvas, pix, fh, m):
    """The port's composition on CPU tensors (window + A10's twin)."""
    t = torch.from_numpy(canvas.copy())
    win = C.window(t.shape[:2], pix.shape[:2], fh.x0, fh.y0)
    if win is not None:
        C.compose(t, torch.from_numpy(pix), win,
                  C.blend_params(fh, m, pix.shape[2]))
    return t.numpy()


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("offset", ["negative", "overhanging", "outside"])
@pytest.mark.parametrize("assoc", [False, True])
@pytest.mark.parametrize("clamp", [False, True])
@pytest.mark.parametrize("mode", range(5))
def test_compose_twin_equals_the_reference(mode, clamp, assoc, offset,
                                           dtype):
    canvas, pix, fh, m = _compose_case(mode, clamp, assoc, offset, dtype,
                                       seed=mode * 31 + 7)
    ref = canvas.copy()
    ref_api._compose_frame(ref, pix, fh, m)
    assert np.array_equal(_twin_compose(canvas, pix, fh, m), ref)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("mode", range(5))
def test_compose_twin_grey_equals_the_reference(mode, dtype):
    """A grey image: one colour channel."""
    canvas, pix, fh, m = _compose_case(mode, False, False, "inside", dtype,
                                       seed=mode + 100, ncolor=1)
    ref = canvas.copy()
    ref_api._compose_frame(ref, pix, fh, m)
    assert np.array_equal(_twin_compose(canvas, pix, fh, m), ref)


def test_compose_rejects_what_the_reference_cannot_blend():
    canvas, pix, fh, m = _compose_case(0, False, False, "inside", np.uint8, 1)
    fh.blending_info = _blend(5)
    with pytest.raises(api.InvalidJXLError):
        C.blend_params(fh, m, pix.shape[2])
    fh.blending_info = _blend(2, alpha=2)
    with pytest.raises(api.InvalidJXLError):
        C.blend_params(fh, m, pix.shape[2])


_COMPOSE_RUN = r"""
#include <cstdlib>
#include <cstring>
#include <functional>
#include <vector>
#include "compose.cuh"
using namespace jxl_blend;
// compose.cu's launches and their blocks one after another on the host,
// each block's phases over its threads one after another: one launch per
// group of kMaxExtra extra channels, the window's canvas values copied
// first when there is more than one
// every block's phase k before any block's phase k + 1, the blocks last to
// first and each block's threads one after another: a block that wrote a
// byte outside its segment would put back a stale value over a
// neighbour's blended one
struct HostPhases {
  std::vector<std::function<void(int)>>* phases;
  template <typename F>
  void operator()(F phase) const {
    phases->push_back(phase);
  }
};
template <typename T, int NC, int NE>
static void walk(T* canvas, int canvas_w, const T* src, int src_w,
                 const T* bg, int sx, int sy, int dx, int dy, int cw, int ch,
                 const Params& p) {
  Walk<T, NC, NE> w;
  w.canvas = canvas; w.src = src; w.bg = bg;
  w.canvas_w = canvas_w; w.src_w = src_w;
  w.sx = sx; w.sy = sy; w.dx = dx; w.dy = dy; w.cw = cw; w.ch = ch;
  w.p = p;
  w.g = geo_of(cw, ch, p.nch * (int)sizeof(T), bg != nullptr,
               sizeof(T) == 1);
  const int nrb = (ch + w.g.rows - 1) / w.g.rows;
  std::vector<std::vector<double>> s(nrb * w.g.nseg);
  std::vector<std::vector<std::function<void(int)>>> blocks;
  for (int rb = nrb - 1; rb >= 0; --rb)
    for (int seg = w.g.nseg - 1; seg >= 0; --seg) {
      std::vector<double>& sm = s[rb * w.g.nseg + seg];
      sm.resize((shared_bytes(w.g) + 7) / 8);
      blocks.emplace_back();
      // the phases of the block, recorded (w and sm outlive them)
      w.run(seg, rb, (char*)sm.data(), HostPhases{&blocks.back()});
    }
  for (size_t ph = 0; ph < blocks[0].size(); ++ph)
    for (auto& b : blocks)
      for (int k = 0; k < kThreads; ++k) b[ph](k);
}
template <typename T, int NC>
static void by_extra(T* c, int cwd, const T* s, int swd, const T* bg, int sx,
                     int sy, int dx, int dy, int cw, int ch, const Params& p) {
  if (ne_of(p.ng) == 2)
    return walk<T, NC, 2>(c, cwd, s, swd, bg, sx, sy, dx, dy, cw, ch, p);
  return walk<T, NC, 8>(c, cwd, s, swd, bg, sx, sy, dx, dy, cw, ch, p);
}
// a copy of n bytes at an address of the given remainder mod 16, with 48
// guard bytes of 0xA5 on each side
struct Guarded {
  std::vector<char> buf;
  char* at;
  size_t n;
  Guarded(const void* data, size_t n_, int rem) : buf(n_ + 128, (char)0xA5), n(n_) {
    char* b = buf.data() + 48;
    at = b + (((rem - (int)((uintptr_t)b & 15)) % 16) + 16) % 16;
    memcpy(at, data, n);
  }
  bool intact() const {
    for (const char* q = buf.data(); q < buf.data() + buf.size(); ++q)
      if ((q < at || q >= at + n) && *q != (char)0xA5) return false;
    return true;
  }
};
template <typename T>
static int run(T* canvas, int H, int canvas_w, const T* src, int h,
               int src_w, int sx, int sy, int dx, int dy, int cw, int ch,
               const int* ip, double maxv, int coff, int soff) {
  const int nch = ip[0], n_ec = ip[2];
  Guarded cg(canvas, sizeof(T) * H * canvas_w * nch, coff);
  Guarded sg(src, sizeof(T) * h * src_w * nch, soff);
  T* c = (T*)cg.at;
  std::vector<T> bgv;
  if (n_ec > kMaxExtra)
    for (int y = 0; y < ch; ++y)
      for (int x = 0; x < cw * nch; ++x)
        bgv.push_back(c[(long long)(dy + y) * canvas_w * nch +
                        (long long)dx * nch + x]);
  Guarded bgg(bgv.data(), sizeof(T) * bgv.size(), coff ^ 6);
  for (int g0 = 0; g0 < (n_ec > 0 ? n_ec : 1); g0 += kMaxExtra) {
    Params p;
    if (!params_of(ip, maxv, g0, &p)) std::abort();
    const T* bg = bgv.empty() ? nullptr : (const T*)bgg.at;
    if (p.ncolor == 1)
      by_extra<T, 1>(c, canvas_w, (const T*)sg.at, src_w, bg, sx, sy, dx, dy,
                     cw, ch, p);
    else
      by_extra<T, 3>(c, canvas_w, (const T*)sg.at, src_w, bg, sx, sy, dx, dy,
                     cw, ch, p);
  }
  memcpy(canvas, c, cg.n);
  return cg.intact() && sg.intact() && bgg.intact() &&
         memcmp(sg.at, src, sg.n) == 0;
}
// unit's quotients of every 16-bit code by 65535
extern "C" void compose_units(double* out) {
  Params p{};
  p.maxv = 65535.0;
  p.rcp = 1.0 / 65535.0;
  for (int v = 0; v < 65536; ++v) out[v] = unit<uint16_t>((uint16_t)v, p, nullptr);
}
// 1 when the canvas was composed and no byte outside the canvas (nor any
// of the frame's) changed; coff, soff: the canvas's and the frame's first
// byte's address mod 16
extern "C" int compose_host(void* canvas, int dtype, int H, int canvas_w,
                            const void* src, int h, int src_w, int sx, int sy,
                            int dx, int dy, int cw, int ch, const int* ip,
                            double maxv, int coff, int soff) {
  if (dtype == 0)
    return run((uint8_t*)canvas, H, canvas_w, (const uint8_t*)src, h, src_w,
               sx, sy, dx, dy, cw, ch, ip, maxv, coff, soff);
  return run((uint16_t*)canvas, H, canvas_w, (const uint16_t*)src, h, src_w,
             sx, sy, dx, dy, cw, ch, ip, maxv, coff, soff);
}
"""


@pytest.fixture(scope="module")
def compose_host(tmp_path_factory):
    """csrc/compose.cuh's row walk built for the host with g++ (no FMA
    contraction, as the kernel's -fmad=false)."""
    gxx = shutil.which("g++")
    assert gxx, "g++ builds the port's host codec; it is needed here too"
    tmp = tmp_path_factory.mktemp("compose")
    cpp, so = tmp / "run.cpp", tmp / "librun.so"
    cpp.write_text(_COMPOSE_RUN)
    subprocess.run([gxx, "-O2", "-std=c++17", "-Wall", "-Werror",
                    "-ffp-contract=off", "-shared", "-fPIC", "-I",
                    str(_build.CSRC), "-o", str(so), str(cpp)], check=True)
    lib = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.compose_host.argtypes = [p, i, i, i, p, i, i, i, i, i, i, i, i, p,
                                 ctypes.c_double, i, i]
    lib.compose_units.argtypes = [p]
    return lib


def test_compose_unit_is_the_division_for_every_16_bit_code(compose_host):
    """compose.cuh's code / 65535 (a product by the reciprocal and one
    fused correction) is the IEEE quotient for all 65,536 codes, as the
    reference's float64 division."""
    out = np.empty(65536, np.float64)
    compose_host.compose_units(out.ctypes.data)
    ref = np.arange(65536, dtype=np.float64) / 65535.0
    assert np.array_equal(out.view(np.int64), ref.view(np.int64))


def _walk(lib, canvas, pix, fh, m, coff=0, soff=0):
    """The kernel's program on a copy of canvas, its first byte at an
    address of coff mod 16 and the frame's at soff; asserts that no byte
    outside the canvas's and the frame's buffers changed."""
    got = np.ascontiguousarray(canvas.copy())
    pix = np.ascontiguousarray(pix)
    win = C.window(got.shape[:2], pix.shape[:2], fh.x0, fh.y0)
    if win is not None:
        ip = C.blend_params(fh, m, pix.shape[2])
        assert lib.compose_host(
            got.ctypes.data, int(got.dtype == np.uint16), *got.shape[:2],
            pix.ctypes.data, *pix.shape[:2], *win, ip.ctypes.data,
            float(np.iinfo(got.dtype).max), coff, soff) == 1, \
            "a byte outside the canvas or of the frame changed"
    return got


@pytest.mark.parametrize("ncolor", [1, 3])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_compose_kernel_program_equals_the_reference(compose_host, dtype,
                                                     ncolor):
    """The kernel's row walk over the whole window (compose_pixel on every
    pixel), for every pair of the colour's and the alpha channel's modes,
    the depth channel's mode, clamp and associated alpha drawn per case;
    the canvas and the frame at drawn addresses mod 16 (u16: even)."""
    rng = np.random.default_rng(ncolor * 10 + np.dtype(dtype).itemsize)
    for mode in range(5):
        for amode in range(5):
            for offset in OFFSETS:
                canvas, pix, fh, m = _compose_case(
                    mode, bool(rng.integers(2)), bool(rng.integers(2)),
                    offset, dtype, int(rng.integers(1 << 30)), ncolor)
                fh.ec_blending_info[0] = _blend(amode, 0,
                                                bool(rng.integers(2)))
                fh.ec_blending_info[1] = _blend(int(rng.integers(5)), 0,
                                                bool(rng.integers(2)))
                ref = canvas.copy()
                ref_api._compose_frame(ref, pix, fh, m)
                step = np.dtype(dtype).itemsize
                got = _walk(compose_host, canvas, pix, fh, m,
                            int(rng.integers(16 // step)) * step,
                            int(rng.integers(16 // step)) * step)
                assert np.array_equal(got, ref), (mode, amode, offset)


# windows that take the walk's other paths: rows cut into segments (more
# than compose.cuh's kSegBytes a row), several blocks of window rows, one
# pixel; (canvas, frame, two crop offsets: the window inside the canvas,
# and at its origin)
WALK_SHAPES = {"segments": ((4, 2200), (3, 2100), ((17, 1), (-17, -1))),
               "row blocks": ((75, 23), (71, 21), ((1, 2), (-1, -2))),
               "one pixel": ((3, 5), (2, 2), ((2, 1), (-1, -1)))}


@pytest.mark.parametrize("shape", list(WALK_SHAPES))
@pytest.mark.parametrize("ncolor", [1, 3])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_compose_row_walk_keeps_the_bytes_outside_the_window(
        compose_host, dtype, ncolor, shape):
    """The row walk on windows cut into segments, over several blocks of
    rows and of one pixel, every colour mode, two crop offsets (the window
    inside the canvas, and at its origin), the canvas
    and the frame at drawn addresses mod 16: the codes equal the JAX
    package's, and every canvas byte outside the window keeps its value."""
    (hc, wc), (hf, wf), offsets = WALK_SHAPES[shape]
    rng = np.random.default_rng(ncolor + 7 * np.dtype(dtype).itemsize)
    maxv = np.iinfo(dtype).max
    step = np.dtype(dtype).itemsize
    for mode in range(5):
        for x0, y0 in offsets:
            nch = ncolor + 2
            canvas = rng.integers(0, maxv + 1, (hc, wc, nch)).astype(dtype)
            pix = rng.integers(0, maxv + 1, (hf, wf, nch)).astype(dtype)
            for a in (canvas, pix):
                a[::3, ::2, ncolor] = 0
                a[1::4, 1::3, ncolor] = maxv
            fh = NS(x0=x0, y0=y0,
                    blending_info=_blend(mode, 0, bool(rng.integers(2))),
                    ec_blending_info=[
                        _blend(int(rng.integers(5)), 0,
                               bool(rng.integers(2))),
                        _blend(int(rng.integers(5)), 0,
                               bool(rng.integers(2)))])
            m = _meta(2, bool(rng.integers(2)))
            ref = canvas.copy()
            ref_api._compose_frame(ref, pix, fh, m)
            got = _walk(compose_host, canvas, pix, fh, m,
                        int(rng.integers(16 // step)) * step,
                        int(rng.integers(16 // step)) * step)
            assert np.array_equal(got, ref), (mode, x0, y0)
            win = C.window(canvas.shape[:2], pix.shape[:2], fh.x0, fh.y0)
            outside = np.ones(canvas.shape[:2], bool)
            outside[win.dy:win.dy + win.ch, win.dx:win.dx + win.cw] = False
            assert np.array_equal(got[outside], canvas[outside])


def _many_case(n_ec, mode, dtype, seed, ncolor=3):
    """A seeded canvas and frame with n_ec extra channels: the colour in
    `mode` through an alpha channel past the first group of eight, every
    extra channel in a drawn mode through a drawn alpha channel (BLEND and
    ALPHA_WEIGHTED_ADD through alpha channels in every group), associated
    alpha on some of them."""
    rng = np.random.default_rng(seed)
    maxv = np.iinfo(dtype).max
    nch = ncolor + n_ec
    canvas = rng.integers(0, maxv + 1, (13, 19, nch)).astype(dtype)
    pix = rng.integers(0, maxv + 1, (9, 11, nch)).astype(dtype)
    alphas = [0, n_ec - 1, n_ec // 2]
    for a in (canvas, pix):
        for k, al in enumerate(alphas):
            a[k::3, ::2, ncolor + al] = 0
            a[1 + k::4, 1::3, ncolor + al] = maxv
    ec = [_blend(int(rng.integers(5)), alphas[int(rng.integers(3))],
                 bool(rng.integers(2))) for _ in range(n_ec)]
    for al in alphas:
        ec[al] = _blend(mode, al, bool(rng.integers(2)))
    fh = NS(x0=int(rng.integers(-4, 12)), y0=int(rng.integers(-3, 8)),
            blending_info=_blend(mode, alphas[1], bool(rng.integers(2))),
            ec_blending_info=ec)
    m = NS(extra_channels=[NS(alpha_associated=bool(i % 3 == 1))
                           for i in range(n_ec)])
    return canvas, pix, fh, m


@pytest.mark.parametrize("n_ec", [9, 10, 17])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_compose_many_extra_channels_equal_the_reference(compose_host,
                                                         dtype, n_ec):
    """Past compose.cuh's eight extra channels a launch: its groups (the
    host harness runs them as compose.cu launches them, after the window's
    copy) and A10's twin, against the JAX package, every colour mode."""
    for mode in range(5):
        for ncolor in (1, 3):
            canvas, pix, fh, m = _many_case(n_ec, mode, dtype,
                                            mode * 7 + n_ec + ncolor, ncolor)
            ref = canvas.copy()
            ref_api._compose_frame(ref, pix, fh, m)
            assert np.array_equal(_twin_compose(canvas, pix, fh, m), ref)
            got = _walk(compose_host, canvas, pix, fh, m, 2 * mode,
                        2 * ncolor)
            assert np.array_equal(got, ref), (mode, ncolor)


# ---- decode_frames, AnimatedImage, api.decode ------------------------------

@pytest.mark.parametrize("label", ["sprites", "lossless_rgba", "lossy_rgb",
                                   "lossy_rgba"])
def test_decode_frames_equals_the_jax_package(streams, label, monkeypatch):
    data = streams[label]
    calls = [0]
    plain = C.compose_plain

    def counted(*a, **k):
        calls[0] += 1
        return plain(*a, **k)
    monkeypatch.setattr(C, "compose_plain", counted)
    frames, durations, info = api.decode_frames(data, device="cpu")
    ref_frames, ref_durations, ref_info = ref_api.decode_frames(data)
    assert durations == ref_durations and vars(info) == vars(ref_info)
    assert len(frames) == len(ref_frames)
    for got, ref in zip(frames, ref_frames):
        _same(label, got, ref)
    img = ref_anim.AnimatedImage(data)
    hdr = img.image_header
    # A10 once per frame that is cropped or blended onto a canvas
    want = sum(1 for e in img.frames
               if e.header.frame_type in (0, 3)
               and (e.header.have_crop or e.header.blending_info.mode != 0)
               and C.window((hdr.ysize, hdr.xsize),
                            (e.header.frame_height or hdr.ysize,
                             e.header.frame_width or hdr.xsize),
                            e.header.x0, e.header.y0) is not None)
    assert calls[0] == want
    if label == "sprites":
        assert want >= 6


def test_decode_frames_device_entropy_route(streams):
    """entropy="device" (the kernel's twin here) gives the host route's
    frames."""
    data = streams["lossy_rgb"]
    host = api.decode_frames(data, device="cpu")[0]
    dev = api.decode_frames(data, device="cpu", entropy="device")[0]
    assert all(np.array_equal(a, b) for a, b in zip(host, dev))


def test_animated_image_index_equals_the_jax_package(streams):
    for data in streams.values():
        ref = ref_anim.AnimatedImage(data)
        got = animation.AnimatedImage(data, "cpu")
        assert (got.width, got.height, got.frames_count, got.loops_count) \
            == (ref.width, ref.height, ref.frames_count, ref.loops_count)
        assert [got.frame_duration_ms(i) for i in range(got.frames_count)] \
            == [ref.frame_duration_ms(i) for i in range(ref.frames_count)]
        assert got.total_duration_ms() == ref.total_duration_ms()
        assert [e.header_bit_start for e in got.frames] == \
            [e.header_bit_start for e in ref.frames]


@pytest.mark.parametrize("label", ["sprites", "lossless_rgba", "lossy_rgba"])
def test_get_frame_in_random_order(streams, label):
    data = streams[label]
    ref = ref_anim.AnimatedImage(data)
    got = animation.AnimatedImage(data, "cpu")
    n = got.frames_count
    order = [0, 3, 2, n - 1, 1, n - 1, 0] + list(
        np.random.default_rng(3).permutation(n))
    for i in order:
        _same(label, got.get_frame(int(i)), ref.get_frame(int(i)))


def test_get_frame_scaled(streams):
    data = streams["lossless_rgba"]
    ref = ref_anim.AnimatedImage(data)
    got = animation.AnimatedImage(data, "cpu")
    for i in (2, 4):
        a, b = got.get_frame(i, 24, 15), ref.get_frame(i, 24, 15)
        assert a.shape == b.shape and a.dtype == b.dtype
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1


@pytest.mark.parametrize("label", ["sprites", "lossless_rgba",
                                   "lossy_rgba"])
def test_decode_of_an_animation_is_its_last_frame(streams, label):
    data = streams[label]
    got, info = api.decode(data, device="cpu")
    ref, ref_info = ref_api.decode(data)
    assert vars(info) == vars(ref_info) and info.have_animation
    _same(label, got, ref)
    if got.shape[2] > 4:
        return      # S2 takes up to 4 channels (ROADMAP)
    thumb = api.decode_thumbnail(data, device="cpu")[0]
    ref_thumb = ref_api.decode_thumbnail(data)[0]
    _same(label, thumb, ref_thumb)


def test_decode_batch_with_an_animation(streams):
    still = F.modular_still(_rgba_frames(1, 9, 3)[0])
    datas = [streams["sprites"], still, streams["lossless_rgba"]]
    got = api.decode_batch(datas, device="cpu")
    for g, data in zip(got, datas):
        assert np.array_equal(g, api.decode(data, device="cpu")[0])


def test_get_frame_thread_safety(streams):
    """Two threads asking for frames in different orders get the frames
    a lone caller gets (the cursor is under the mutex), as
    tests/test_bitstream.py:175 holds the JAX package's."""
    data = streams["sprites"]
    img = animation.AnimatedImage(data, "cpu")
    n = img.frames_count
    expect = [img.get_frame(i) for i in range(n)]
    img2 = animation.AnimatedImage(data, "cpu")
    errs = []

    def worker(order):
        try:
            for i in order:
                if not np.array_equal(img2.get_frame(i), expect[i]):
                    errs.append(i)
        except Exception as e:  # pragma: no cover
            errs.append(repr(e))

    orders = (list(range(n))[::-1] * 2, [0, 3, 1, n - 1, 2, 4, 5] * 2)
    ts = [threading.Thread(target=worker, args=(o,)) for o in orders]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert not errs, errs


def test_animation_player_prefetch():
    """tests/test_ops_animation.py:247 on the port: the worker prefetches
    and the playhead loops."""
    frames = [np.full((32, 48, 3), 50 * i, np.uint8) for i in range(4)]
    img = animation.AnimatedImage(F.animated_stream(frames, True), "cpu")
    p = animation.AnimationPlayer(animation.AnimatedStore(img), preheat=2)
    try:
        for i in range(6):
            assert np.array_equal(p.current()[..., :3], frames[i % 4])
            assert p.current_duration_ms() == 100
            p.advance()
    finally:
        p.close()


def test_animated_store_fit_and_fill(streams):
    img = animation.AnimatedImage(streams["lossless_rgba"], "cpu")
    ref = ref_anim.AnimatedImage(streams["lossless_rgba"])
    for fill in (False, True):
        got = animation.AnimatedStore(img, 30, 30, fill)
        want = ref_anim.AnimatedStore(ref, 30, 30, fill)
        assert (got.width, got.height) == (want.width, want.height)
        a, b = got.get_frame(1), want.get_frame(1)
        assert a.shape == b.shape
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
    frames = [f for f, _ in animation.iter_frames(img)]
    assert [d for _, d in animation.iter_frames(img)] == \
        [ref.frame_duration_ms(i) for i in range(ref.frames_count)]
    assert all(np.array_equal(f, ref.get_frame(i))
               for i, f in enumerate(frames))


# ---- decode_frames_batch ---------------------------------------------------

@pytest.fixture(scope="module")
def legacy():
    """Round-1 frames wider than one group (a one-section frame is not
    told apart from a real-format one, and takes the get_frame branch)."""
    frames = [np.roll(F.bench_frame(40, 264), 9 * k, axis=1)
              for k in range(4)]
    return F.legacy_animation(frames)


def test_decode_frames_batch_round1_equals_the_jax_branch(legacy):
    got_img = animation.AnimatedImage(legacy, "cpu")
    ref_img = ref_anim.AnimatedImage(legacy)
    got = animation.decode_frames_batch(got_img)
    ref = ref_anim.decode_frames_batch(ref_img)
    _within_contract(got, ref)
    # each frame is the round-1 codec's own decode (the frames share one
    # distance, so R10 does not show)
    hdr = got_img.image_header
    for k, e in enumerate(got_img.frames):
        one = codec.decode_vardct_still(got_img.codestream, hdr, e.header,
                                        e.toc, device="cpu")
        assert np.array_equal(got[k], one)
        _within_contract(one, ref_codec.decode_vardct_still(
            ref_img.codestream, ref_img.image_header, e.header, e.toc))
    sub = animation.decode_frames_batch(got_img, [2, 0])
    assert np.array_equal(sub, got[[2, 0]])


def test_decode_frames_batch_real_format_is_get_frame(streams):
    img = animation.AnimatedImage(streams["lossy_rgba"], "cpu")
    got = animation.decode_frames_batch(img, [3, 1, 2])
    assert np.array_equal(got, np.stack([img.get_frame(i)
                                         for i in (3, 1, 2)]))
    # real-format frames leave the mesh unused, as the JAX package does
    assert np.array_equal(animation.decode_frames_batch(
        img, [3, 1, 2], mesh=object()), got)
    with pytest.raises(NotImplementedError):
        animation.decode_frames_batch(animation.AnimatedImage(
            streams["sprites"], "cpu"))


def test_batched_filters_equal_single_launches():
    """legacy_filters_batch's twin is each frame's legacy_filters."""
    from jxl_coder_tpu_torch.vardct import fused_filters as FF
    rng = np.random.default_rng(4)
    imgs = torch.from_numpy(rng.uniform(-0.05, 0.6, (3, 3, 20, 27))
                            .astype(np.float32))
    qfs = torch.from_numpy(rng.integers(1, 40, (3, 3, 4)).astype(np.int32))
    got = FF.legacy_filters_batch(imgs, qfs, 1.3, True, True)
    for k in range(3):
        assert torch.equal(got[k], FF.legacy_filters(imgs[k], qfs[k], 1.3,
                                                     True, True, "u8"))
