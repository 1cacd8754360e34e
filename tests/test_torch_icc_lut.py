"""The ICC step's lookup-table route in the PyTorch port on the CPU
(``host/ops/icc_lut.py``, ``ops/icc_apply.py`` ``clut_transform_plain``
and ``csrc/icc.cuh``'s ``clut_pixel`` built with g++) against the JAX
package's ``jxl_coder_tpu.ops.icc_apply.icc_to_srgb`` (littlecms through
Pillow), and the decode and lossy encode that apply it against the JAX
package's.

The profiles are ``port_fixtures.lut_test_profiles``: an mft1 A2B0 on the
Lab PCS, an mft2 A2B0 with its matrix on the XYZ PCS, mAB A2B0s at 16- and
8-bit CLUT precision, an mpet D2B0, Display P3 with an identity mft1,
matrix / TRC profiles whose black is not 0 (v2 and v4), and one whose
fixed-point sums leave int32; every table seeded.

Tolerances: the port builds littlecms's own 8-bit programs from the same
float pipeline, so its codes equal the reference's (0 differences) on the
whole 2^24 cube of 8-bit RGB for every profile; the north star's 8-bit
contract (at most 1 code on at most 0.1% of values) is not needed.  The
g++ build of the kernel programs equals the twin on the cube.  Pass-through
cases equal the reference (the same pixels, with its warning).  Decodes
and lossy encodes equal the JAX package's (pixels, bytes).
"""

import ctypes
import logging
import shutil
import subprocess

import numpy as np
import pytest
import torch

from jxl_coder_tpu import api as ref_api
from jxl_coder_tpu.ops.icc_apply import icc_to_srgb as ref_icc
from jxl_coder_tpu_torch import _build, api
from jxl_coder_tpu_torch.host.ops import icc as HICC
from jxl_coder_tpu_torch.host.ops import icc_lut as HLUT
from jxl_coder_tpu_torch.ops import icc_apply as I
import port_fixtures as F

PROFILES = F.lut_test_profiles()
MAB = PROFILES["mab16 xyz v4"]


def _cube() -> np.ndarray:
    """The 2^24 8-bit RGB values as a 4096 x 4096 image."""
    x = np.arange(256, dtype=np.uint8)
    return np.stack(np.meshgrid(x, x, x, indexing="ij"), -1).reshape(
        4096, 4096, 3)


def _twin(px: np.ndarray, prof: bytes) -> np.ndarray:
    """The port's icc_to_srgb on the CPU, 256 rows at a time."""
    return np.concatenate([I.icc_to_srgb(torch.from_numpy(px[i:i + 256]),
                                         prof).numpy()
                           for i in range(0, len(px), 256)])


@pytest.mark.parametrize("name", sorted(PROFILES))
def test_twin_equals_littlecms_on_the_cube(name):
    """The twin on the whole 2^24 cube equals the reference: 0
    differences."""
    prof = PROFILES[name]
    cube = _cube()
    ref = ref_icc(cube, prof)
    got = _twin(cube, prof)
    assert got.dtype == np.uint8 and got.shape == cube.shape
    d = got != ref
    assert not d.any(), (int(d.sum()), np.argwhere(d)[:5])


def test_each_profile_takes_littlecms_program():
    """Which of littlecms's 8-bit programs each profile takes: the tables
    and the moving blacks resample into the CLUT (the blacks with
    prelinearisation curves along the grey ramp, the ramp of P3 with its
    flat foot too degenerate for them); the profile past int32 keeps the
    matrix-shaper, whose sums there leave int32."""
    kinds = {}
    for name, prof in PROFILES.items():
        tr = HICC.plan(prof)
        kinds[name] = "matrix" if isinstance(tr, HICC.Transform) else \
            "prelinearised" if tr.prelinearised else "clut"
    assert kinds == {
        "mft1 lab v2": "clut", "mft2 xyz v2": "clut",
        "mab16 xyz v4": "clut", "mab8 lab v4": "clut",
        "mpet d2b0 v4": "clut", "identity mft1": "clut",
        "black v2": "prelinearised", "black v4": "prelinearised",
        "int32 reach": "matrix"}
    flat = F.icc_profile("p3", ("para", 2, (2.4, 1.1, -0.1, 0.02)), 4)
    assert not HICC.plan(flat).prelinearised
    tr = HICC.plan(PROFILES["int32 reach"])
    assert tr.shaper1.max() == 2 ** 31 - 1
    reach = np.abs(tr.matrix).sum(1).max() * np.abs(tr.shaper1).max()
    assert reach >= 2 ** 31


def test_clut_sampling_follows_the_pipeline():
    """The CLUT's nodes are the pipeline at the nodes (sample_clut); the
    white node comes out white; the tables the kernel reads pack to
    ClutTransform's fields."""
    stages = HLUT.pipeline(MAB, HICC._tags(MAB))
    tr = HICC.plan(MAB)
    nodes = HLUT._nodes_16()
    idx = np.random.default_rng(3).choice(len(nodes), 200, replace=False)
    x = (nodes[idx] / 65535.0).astype(np.float32)
    want = HICC._saturate_word(HLUT.eval_float(stages, x).astype(np.float64)
                               * 65535.0)
    assert np.array_equal(tr.table.reshape(-1, 3)[idx][:-1], want[:-1])
    assert np.array_equal(tr.table[-3:], [65535] * 3)
    packed = tr.packed()
    assert packed.size == HLUT.CLUT_BYTES
    words = packed[:4 * HLUT.CLUT_WORDS].view(np.int32)
    assert np.array_equal(words[:768], tr.offs.ravel())
    assert np.array_equal(words[768:], tr.fracs.ravel())
    assert np.array_equal(packed[4 * HLUT.CLUT_WORDS:].view(np.uint16)[
        :tr.table.size], tr.table)


@pytest.mark.parametrize("nch", [1, 3, 4])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("name", ["mab16 xyz v4", "black v2",
                                  "int32 reach"])
def test_channels_and_depths_equal_the_reference(name, dtype, nch):
    """1 channel comes out as 3 (ROADMAP R21), 4 keep their alpha, 16-bit
    samples go through 8 bits and come back as (v << 8) | v (R20):
    shape, dtype and values as the reference's."""
    rng = np.random.default_rng(nch * 10 + np.dtype(dtype).itemsize)
    top = 256 if dtype == np.uint8 else 65536
    px = rng.integers(0, top, (29, 37, nch)).astype(dtype)
    prof = PROFILES[name]
    ref = ref_icc(px, prof)
    got = I.icc_to_srgb(torch.from_numpy(px), prof).numpy()
    assert got.shape == ref.shape and got.dtype == ref.dtype
    assert np.array_equal(got, ref)


def _mft(nin: int, nout: int, grid: int = 2) -> bytes:
    """A lut8 (mft1) of nin -> nout channels: identity tables, a zero
    CLUT."""
    body = b"mft1\0\0\0\0" + bytes([nin, nout, grid, 0])
    body += b"".join(F._s15(v) for v in np.eye(3).ravel())
    body += np.tile(np.arange(256, dtype=np.uint8), nin).tobytes()
    body += bytes(grid ** nin * nout)
    return body + np.tile(np.arange(256, dtype=np.uint8), nout).tobytes()


def _passthrough_cases():
    mab = F.icc_mab([("curv", None)] * 3, np.zeros((2, 2, 2, 3)), None,
                    None, [("curv", None)] * 3)
    grid1 = bytearray(mab)
    clut_at = int.from_bytes(mab[24:28], "big")
    grid1[clut_at + 1] = 1
    prec3 = bytearray(mab)
    prec3[clut_at + 16] = 3
    mpet = F.icc_mpet([("matf", np.eye(3), [0.0, 0.0, 0.0])])
    unknown = mpet.replace(b"matf", b"xmpl")
    return {
        "mft1 under D2B0": F.mft1_under_d2b0(),
        "curv under A2B0": F.icc_profile(
            "p3", F.SRGB_PARA, 2, extra=[(b"A2B0", b"curv\0\0\0\0\0\0\0\0")]),
        "A2B0 of 4 inputs": F.icc_profile(None, None, 2,
                                          extra=[(b"A2B0", _mft(4, 3))]),
        "A2B0 of 4 outputs": F.icc_profile(None, None, 2,
                                           extra=[(b"A2B0", _mft(3, 4))]),
        "mAB grid of one point": F.icc_profile(
            None, None, 4, extra=[(b"A2B0", bytes(grid1))]),
        "mAB precision 3": F.icc_profile(
            None, None, 4, extra=[(b"A2B0", bytes(prec3))]),
        "truncated mAB": F.icc_profile(
            None, None, 4, extra=[(b"A2B0", mab[:clut_at + 30])]),
        "mpet of an unknown element": F.icc_profile(
            None, None, 4, extra=[(b"D2B0", unknown)]),
        "CMYK PCS": F.icc_profile(None, None, 4, pcs=b"CMYK",
                                  extra=[(b"A2B0", mab)]),
    }


@pytest.mark.parametrize("case", sorted(_passthrough_cases()))
def test_passthrough_equals_the_reference(case, caplog):
    """Where littlecms cannot read a table under its tag or link it to
    sRGB, it builds no transform and the reference returns its input with
    a warning: so does the port (the same tensor)."""
    prof = _passthrough_cases()[case]
    px = np.random.default_rng(5).integers(0, 256, (9, 14, 3)).astype(
        np.uint8)
    ref = ref_icc(px, prof)
    t = torch.from_numpy(px)
    with caplog.at_level(logging.WARNING, logger="jxl_coder_tpu_torch.icc"):
        got = I.icc_to_srgb(t, prof)
    assert np.array_equal(ref, px)
    assert got is t
    assert any("returning pixels unconverted" in r.getMessage()
               for r in caplog.records)


_RUN = r"""
#include "icc.cuh"
using namespace jxl_icc;
// icc.cu's threads one after another on the host
template <typename T, int C>
static void run(const T* in, T* out, long long n, const unsigned char* tab,
                int clut) {
  const int32_t* words = (const int32_t*)tab;
  for (long long p = 0; p < n; ++p) {
    T* o = out + p * (C == 1 ? 3 : C);
    if (clut)
      clut_pixel<T, C>(in + p * C, o, words, words + 768,
                       (const uint16_t*)(tab + 4 * kClutWords));
    else
      icc_pixel<T, C>(in + p * C, o, words, words + kShaper1,
                      tab + 4 * kWords);
  }
}
template <typename T>
static void by_c(const void* in, void* out, int C, long long n,
                 const unsigned char* tab, int clut) {
  const T* i = (const T*)in;
  T* o = (T*)out;
  if (C == 1) run<T, 1>(i, o, n, tab, clut);
  if (C == 3) run<T, 3>(i, o, n, tab, clut);
  if (C == 4) run<T, 4>(i, o, n, tab, clut);
}
extern "C" void icc_host(const void* in, void* out, int dtype, int C,
                         long long n, const unsigned char* tab, int clut) {
  if (dtype == 0) by_c<uint8_t>(in, out, C, n, tab, clut);
  else by_c<uint16_t>(in, out, C, n, tab, clut);
}
"""


@pytest.fixture(scope="module")
def icc_host(tmp_path_factory):
    """csrc/icc.cuh's programs built for the host with g++."""
    gxx = shutil.which("g++")
    assert gxx, "g++ builds the port's host codec; it is needed here too"
    tmp = tmp_path_factory.mktemp("icc_lut")
    cpp, so = tmp / "run.cpp", tmp / "librun.so"
    cpp.write_text(_RUN)
    subprocess.run([gxx, "-O2", "-std=c++17", "-Wall", "-Werror",
                    "-ffp-contract=off", "-shared", "-fPIC", "-I",
                    str(_build.CSRC), "-o", str(so), str(cpp)], check=True)
    lib = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.icc_host.argtypes = [p, p, i, i, ctypes.c_longlong, p, i]
    return lib


def _run_host(lib, px: np.ndarray, tr) -> np.ndarray:
    px = np.ascontiguousarray(px)
    tab = tr.packed()
    out = np.zeros(px.shape[:2] + (3 if px.shape[2] == 1 else px.shape[2],),
                   px.dtype)
    lib.icc_host(px.ctypes.data, out.ctypes.data,
                 int(px.dtype == np.uint16), px.shape[2],
                 px.shape[0] * px.shape[1], tab.ctypes.data,
                 int(isinstance(tr, HLUT.ClutTransform)))
    return out


@pytest.mark.parametrize("name", sorted(PROFILES))
def test_kernel_program_equals_the_twin_on_the_cube(icc_host, name):
    """icc.cuh's per-pixel program (g++: clut_pixel for the CLUT profiles,
    icc_pixel for the one past int32) on the whole 2^24 cube equals the
    reference, which test_twin_equals_littlecms_on_the_cube holds the twin
    to: so it equals the twin."""
    prof = PROFILES[name]
    cube = _cube()
    got = _run_host(icc_host, cube, HICC.plan(prof))
    assert np.array_equal(got, ref_icc(cube, prof))


@pytest.mark.parametrize("nch", [1, 4])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_kernel_program_channels_and_depths(icc_host, dtype, nch):
    """clut_pixel on seeded grey and RGBA pixels, 8 and 16 bits, equals
    the reference."""
    rng = np.random.default_rng(nch + np.dtype(dtype).itemsize)
    top = 256 if dtype == np.uint8 else 65536
    px = rng.integers(0, top, (40, 53, nch)).astype(dtype)
    got = _run_host(icc_host, px, HICC.plan(MAB))
    assert np.array_equal(got, ref_icc(px, MAB))


# ---- the decode and the lossy encode ---------------------------------------

@pytest.mark.parametrize("nch,dtype", [(3, np.uint8), (1, np.uint8),
                                       (4, np.uint8), (3, np.uint16),
                                       (4, np.uint16)])
def test_modular_decode_with_a_table_profile(nch, dtype):
    """api.decode of a Modular still with the mAB profile: equal to the
    JAX package's (a grey still comes out as RGB, R21; 16 bits through 8,
    R20)."""
    img = F.bench_frame(30, 44)
    px = img[..., :nch] if nch <= 3 else np.concatenate(
        [img, 255 - img[..., :1]], -1)
    px = px.astype(dtype) * (257 if dtype == np.uint16 else 1)
    data = ref_api.encode(px, lossless=True, effort=2, icc=MAB)
    got, info = api.decode(data, device="cpu")
    ref, ref_info = ref_api.decode(data)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    assert np.array_equal(got, ref) and vars(info) == vars(ref_info)


@pytest.mark.parametrize("kind", ["u8", "u16", "grey", "rgba"])
def test_lossy_encode_with_a_table_profile(kind):
    """encode(icc=mAB, lossless=False): the pixels through the table, then
    the lossy encode without it; bytes equal to the JAX package's."""
    img = F.bench_frame(32, 40)
    px = {"u8": img, "u16": img.astype(np.uint16) * 257,
          "grey": img[..., 1],
          "rgba": np.concatenate([img, img[..., :1]], -1)}[kind]
    got = api.encode(px, lossless=False, quality=90, icc=MAB, device="cpu")
    assert got == ref_api.encode(px, lossless=False, quality=90, icc=MAB)


def test_d2b0_that_littlecms_cannot_read_decodes_unconverted():
    """A still whose profile carries an mft1 under D2B0 decodes to its
    pixels as coded, as the JAX package's does."""
    img = F.bench_frame(16, 24)
    data = ref_api.encode(img, lossless=True, effort=2,
                          icc=F.mft1_under_d2b0())
    got, _ = api.decode(data, device="cpu")
    assert np.array_equal(got, ref_api.decode(data)[0])
    assert np.array_equal(got, img)
