"""S3's tile program (``csrc/sample.cuh``) built with g++ and run block by
block, thread by thread, on the CPU: the host's own tile shape
(``plan_tiles``) or a forced one whose windows take several row and
column chunks.  Its output equals, bit for bit, the arithmetic of the
two-pass kernel it replaced (the same g++ build runs that in its order).
Its codes are held to the dense twin
(``ops/resize.py`` ``rescale_image_plain``) and to
``jxl_coder_tpu.ops.resize.rescale_image`` under the sampled parity rule:
the two sum in other orders, so a code may differ by 1 (with
unassociated alpha the colour is held as colour x alpha, within the
float32 difference of the sums times maxv, 1.02 codes); float32 output
within 1e-5.  The card runs the same program (``csrc/sample.cu``
``resample_kernel``), checked there by ``chip_smoke.py``.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from jxl_coder_tpu.ops import resize as JR
from jxl_coder_tpu_torch import _build
from jxl_coder_tpu_torch.host.ops import resize as HR
from jxl_coder_tpu_torch.ops import resize

_RUN = r"""
#include <vector>
#include "sample.cuh"
using namespace jxl_sample;
// sample.cu's resample_kernel with its blocks one after another and each
// phase's threads one after another
struct HostEach {
  template <typename F>
  void operator()(F phase) const {
    for (int k = 0; k < kThreads; ++k) phase(k);
  }
};
template <typename T, int C, bool ALPHA>
static void run(const void* in, int W, int c, float maxv, Band v, int rows,
                Band h, int cols, void* out, Tiles t) {
  Resample<T, C, ALPHA> R;
  R.in = static_cast<const T*>(in);
  R.out = static_cast<T*>(out);
  R.W = W; R.c = c; R.maxv = maxv; R.v = v; R.h = h;
  R.rows = rows; R.cols = cols; R.t = t;
  R.l = layout_of(t, c, sizeof(T), v.stride, h.stride);
  std::vector<char> s(R.l.total);
  const long long blocks = (long long)((rows + t.ty - 1) / t.ty) *
                           ((cols + t.tx - 1) / t.tx);
  for (long long b = 0; b < blocks; ++b) R.run((int)b, s.data(), HostEach{});
}
template <typename T>
static void dispatch(const void* in, int W, int C, float maxv, int alpha,
                     Band v, int rows, Band h, int cols, void* out, Tiles t) {
  switch (C) {
    case 1: return run<T, 1, false>(in, W, C, maxv, v, rows, h, cols, out, t);
    case 2:
      return alpha ? run<T, 2, true>(in, W, C, maxv, v, rows, h, cols, out, t)
                   : run<T, 2, false>(in, W, C, maxv, v, rows, h, cols, out, t);
    case 3: return run<T, 3, false>(in, W, C, maxv, v, rows, h, cols, out, t);
    case 4:
      return alpha ? run<T, 4, true>(in, W, C, maxv, v, rows, h, cols, out, t)
                   : run<T, 4, false>(in, W, C, maxv, v, rows, h, cols, out, t);
    default: return run<T, 0, false>(in, W, C, maxv, v, rows, h, cols, out, t);
  }
}
// jxl_resample's arguments (no scratch); tiles: in, the shape to force
// (ty 0: the host's plan_tiles), out, the shape run
extern "C" int resample_host(const void* in, int dtype, int W, int C,
                             float maxv, int alpha, const int* vf,
                             const int* vl, const float* vw, int vs, int rows,
                             const int* hf, const int* hl, const float* hw,
                             int hs, int cols, void* out, int* tiles) {
  const int size = dtype == 0 ? 1 : dtype == 1 ? 2 : 4;
  Tiles t{tiles[0], tiles[1], tiles[2]};
  if (t.ty == 0) t = plan_tiles(W, C, size, rows, cols, vs, hs);
  tiles[0] = t.ty; tiles[1] = t.tx; tiles[2] = t.cw;
  if (t.ty == 0) return 1;
  const Band v{vf, vl, vw, vs}, h{hf, hl, hw, hs};
  if (dtype == 0)
    dispatch<uint8_t>(in, W, C, maxv, alpha, v, rows, h, cols, out, t);
  else if (dtype == 1)
    dispatch<uint16_t>(in, W, C, maxv, alpha, v, rows, h, cols, out, t);
  else
    dispatch<float>(in, W, C, maxv, alpha, v, rows, h, cols, out, t);
  return 0;
}
// the two-pass kernel this program replaced (resample_v_kernel, then
// resample_h_kernel through a float32 (rows, W, C) array), its operations
// in its order, on codes of T
template <typename T>
static void two_pass(const T* in, int W, int C, float maxv, int alpha,
                     Band v, int rows, Band h, int cols, T* out) {
  std::vector<float> t((size_t)rows * W * C);
  for (int r = 0; r < rows; ++r)
    for (int x = 0; x < W; ++x)
      for (int c = 0; c < C; ++c) {
        float acc = 0.0f;
        for (int k = 0; k < v.len[r]; ++k) {
          const T* p = in + ((size_t)(v.first[r] + k) * W + x) * C;
          float u = (float)p[c] / maxv;
          if (alpha && c < C - 1) u = u * ((float)p[C - 1] / maxv);
          acc = fmaf(v.w[(size_t)r * v.stride + k], u, acc);
        }
        t[((size_t)r * W + x) * C + c] = acc;
      }
  std::vector<float> acc(C);
  for (int r = 0; r < rows; ++r)
    for (int p = 0; p < cols; ++p) {
      for (int c = 0; c < C; ++c) {
        acc[c] = 0.0f;
        for (int k = 0; k < h.len[p]; ++k)
          acc[c] = fmaf(h.w[(size_t)p * h.stride + k],
                        t[((size_t)r * W + h.first[p] + k) * C + c], acc[c]);
      }
      if (alpha) {
        const float a = fminf(fmaxf(acc[C - 1], 1e-6f), 1.0f);
        for (int c = 0; c < C - 1; ++c) acc[c] = acc[c] / a;
      }
      for (int c = 0; c < C; ++c)
        out[((size_t)r * cols + p) * C + c] =
            to_code<T>(fminf(fmaxf(acc[c], 0.0f), 1.0f), maxv);
    }
}
extern "C" void two_pass_host(const void* in, int dtype, int W, int C,
                              float maxv, int alpha, const int* vf,
                              const int* vl, const float* vw, int vs,
                              int rows, const int* hf, const int* hl,
                              const float* hw, int hs, int cols, void* out) {
  const Band v{vf, vl, vw, vs}, h{hf, hl, hw, hs};
  if (dtype == 0)
    two_pass((const uint8_t*)in, W, C, maxv, alpha, v, rows, h, cols,
             (uint8_t*)out);
  else if (dtype == 1)
    two_pass((const uint16_t*)in, W, C, maxv, alpha, v, rows, h, cols,
             (uint16_t*)out);
  else
    two_pass((const float*)in, W, C, maxv, alpha, v, rows, h, cols,
             (float*)out);
}
extern "C" void plan_host(int W, int C, int size, int rows, int cols, int vs,
                          int hs, int* tiles) {
  const Tiles t = plan_tiles(W, C, size, rows, cols, vs, hs);
  tiles[0] = t.ty; tiles[1] = t.tx; tiles[2] = t.cw;
}
"""


@pytest.fixture(scope="module")
def sample_host(tmp_path_factory):
    """csrc/sample.cuh's block program built for the host with g++."""
    gxx = shutil.which("g++")
    assert gxx, "g++ builds the port's host codec; it is needed here too"
    tmp = tmp_path_factory.mktemp("sample")
    cpp, so = tmp / "run.cpp", tmp / "librun.so"
    cpp.write_text(_RUN)
    subprocess.run([gxx, "-O2", "-std=c++17", "-Wall", "-Werror", "-shared",
                    "-fPIC", "-I", str(_build.CSRC), "-o", str(so),
                    str(cpp)], check=True)
    lib = ctypes.CDLL(str(so))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.resample_host.argtypes = [p, i, i, i, f, i, p, p, p, i, i, p, p, p,
                                  i, i, p, p]
    lib.plan_host.argtypes = [i, i, i, i, i, i, i, p]
    lib.two_pass_host.argtypes = [p, i, i, i, f, i, p, p, p, i, i, p, p, p,
                                  i, i, p]
    return lib


_CODES = {np.uint8: (0, 255.0), np.uint16: (1, 65535.0),
          np.float32: (2, 1.0)}


def _program(lib, img, tw, th, mode, fid, premultiplied=False, tiles=None,
             fn="resample_host"):
    """The block program on img -> (codes, the tile shape it ran); fn
    "two_pass_host": the two-pass kernel's arithmetic instead."""
    h, w, c = img.shape
    code, maxv = _CODES[img.dtype.type]
    pl = HR.plan(h, w, tw, th, mode)
    bv = HR.band(h, pl.oh, fid, pl.y0, pl.ch)
    bh = HR.band(w, pl.ow, fid, pl.x0, pl.cw)
    out = np.zeros((pl.ch, pl.cw, c), img.dtype)
    t = np.array(tiles or (0, 0, 0), np.int32)
    img = np.ascontiguousarray(img)
    args = (img.ctypes.data, code, w, c, maxv,
            int(c in (2, 4) and not premultiplied), bv.first.ctypes.data,
            bv.length.ctypes.data, bv.weights.ctypes.data,
            bv.weights.shape[1], pl.ch, bh.first.ctypes.data,
            bh.length.ctypes.data, bh.weights.ctypes.data,
            bh.weights.shape[1], pl.cw, out.ctypes.data)
    if fn == "two_pass_host":
        lib.two_pass_host(*args)
    else:
        assert lib.resample_host(*args, t.ctypes.data) == 0
    return out, tuple(int(v) for v in t)


def _image(rng, h, w, c, dtype):
    """Smooth gradients with noise, and a few values at both ends."""
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    f = np.stack([0.5 + 0.45 * np.sin(3 * xx + 2 * k + 5 * yy)
                  for k in range(c)], -1)
    f = np.clip(f + rng.normal(0, 0.03, f.shape), 0, 1)
    f.reshape(-1)[rng.integers(0, f.size, 8)] = 0.0
    f.reshape(-1)[rng.integers(0, f.size, 8)] = 1.0
    if dtype == np.float32:
        return f.astype(np.float32)
    top = 255 if dtype == np.uint8 else 65535
    return np.rint(f * top).astype(dtype)


def _within_rule(got, ref, alpha):
    assert got.shape == ref.shape and got.dtype == ref.dtype
    maxv = _CODES[got.dtype.type][1]
    d = np.abs(got.astype(np.float64) - ref.astype(np.float64))
    if alpha:
        a = ref[..., -1:].astype(np.float64) / maxv
        d = np.concatenate([d[..., :-1] * a, d[..., -1:]], -1)
    tol = 1e-5 if got.dtype == np.float32 else (1.02 if alpha else 1)
    assert d.max() <= tol, d.max()


# (h, w, C, dtype, target w, h, mode, filter, premultiplied, tiles forced)
CASES = (
    # every filter at every scale mode (FILL crops: y0 / x0 != 0)
    [(61, 83, 3, np.uint8, 37, 29, m, f, False, None)
     for f in range(1, 11) for m in (1, 2, 3)]
    # every type and channel count 1-6, alpha and premultiplied
    + [(45, 70, c, dt, 29, 31, 3, 4, pre, None)
       for dt in (np.uint8, np.uint16, np.float32)
       for c, pre in ((1, False), (2, False), (3, False), (4, False),
                      (4, True), (5, False), (6, False))]
    # the 8x Catmull-Rom upscale of a preview's DC image, ragged tiles
    + [(17, 23, 3, np.uint8, 184, 136, 3, 6, False, None),
       (17, 23, 4, np.uint16, 184, 136, 3, 6, False, None)]
    # ratios past 32, FIT to a sliver and FILL
    + [(150, 1300, 3, np.uint8, 16, 9, 1, 4, False, None),
       (300, 420, 4, np.uint8, 9, 7, 2, 5, False, None),
       (90, 1200, 6, np.uint16, 3, 2, 3, 9, False, None)]
    # ragged sizes at the tile edges (outputs of 17 x 65 and 33 x 129)
    + [(70, 260, 3, np.uint8, 65, 17, 3, 1, False, None),
       (66, 258, 2, np.float32, 129, 33, 3, 7, False, None)]
    # forced tiles: one column chunk, several, a width not a power of two,
    # one output a block; each with alpha and without
    + [(64, 96, c, dt, tw, th, 3, f, False, t)
       for c, dt in ((4, np.uint8), (3, np.uint16), (5, np.float32))
       for tw, th, f, t in ((40, 30, 4, (4, 8, 64)),
                            (23, 19, 5, (8, 16, 7)),
                            (11, 50, 10, (5, 3, 4)),
                            (96, 64, 2, (1, 1, 1)))]
)


@pytest.mark.parametrize(
    "h,w,c,dtype,tw,th,mode,fid,pre,tiles", CASES,
    ids=[f"{h}x{w}x{c}-{np.dtype(d).name}-{tw}x{th}-m{m}-f{f}"
         + ("-pre" if p else "") + (f"-t{'.'.join(map(str, t))}" if t else "")
         for h, w, c, d, tw, th, m, f, p, t in CASES])
def test_tile_program_equals_the_twin_within_a_code(sample_host, h, w, c,
                                                    dtype, tw, th, mode, fid,
                                                    pre, tiles):
    rng = np.random.default_rng(h * 131 + w * 7 + c)
    img = _image(rng, h, w, c, dtype)
    got, ran = _program(sample_host, img, tw, th, mode, fid, pre, tiles)
    # the two-pass kernel's operations in its order: equal to the bit
    parent, _ = _program(sample_host, img, tw, th, mode, fid, pre,
                         fn="two_pass_host")
    assert np.array_equal(got.view(np.uint8), parent.view(np.uint8))
    alpha = c in (2, 4) and not pre
    twin = resize.rescale_image_plain(torch.from_numpy(img), tw, th, mode,
                                      fid, pre).numpy()
    _within_rule(got, twin, alpha)
    ref = JR.rescale_image(img, tw, th, scale_mode=mode, filter_id=fid,
                           premultiplied=pre)
    _within_rule(got, np.asarray(ref), alpha)
    if tiles is None:
        # the host's shape: inside the block and the shared-memory budget
        assert 1 <= ran[0] <= 16 and 1 <= ran[1] <= 64 and ran[2] >= 1


def test_tile_shapes_of_the_card_s_plans(sample_host):
    """plan_tiles on the chip script's plans: one column chunk at 4K -> FHD
    (16 x 64 outputs a block) and at the 8x upscale (16 x 64), a plan for
    4K to 16 x 9."""
    def shape(h, w, c, tw, th, mode, fid):
        pl = HR.plan(h, w, tw, th, mode)
        bv = HR.band(h, pl.oh, fid, pl.y0, pl.ch)
        bh = HR.band(w, pl.ow, fid, pl.x0, pl.cw)
        t = np.zeros(3, np.int32)
        sample_host.plan_host(w, c, 1, pl.ch, pl.cw, bv.weights.shape[1],
                              bh.weights.shape[1], t.ctypes.data)
        return tuple(int(v) for v in t), pl, bh

    for args in ((2160, 3840, 3, 1920, 1080, 1, 4),
                 (270, 480, 3, 3840, 2160, 3, 6)):
        (ty, tx, cw), pl, bh = shape(*args)
        assert (ty, tx) == (16, 64)
        # the true window of every block fits in one chunk
        for p0 in range(0, pl.cw, tx):
            cols = slice(p0, p0 + tx)
            span = (bh.first[cols] + bh.length[cols]).max() - \
                bh.first[cols].min()
            assert span <= cw
    (ty, tx, cw), *_ = shape(2160, 3840, 3, 16, 9, 1, 4)
    assert ty >= 1 and tx >= 1 and cw >= 1
