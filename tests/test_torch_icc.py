"""The ICC -> sRGB step of the PyTorch port on the CPU (the kernel's plain
twin, and ``csrc/icc.cuh`` built with g++) against the JAX package's
``jxl_coder_tpu.ops.icc_apply.icc_to_srgb`` (littlecms through Pillow),
and the decode and lossy encode that apply it against the JAX package's.

The profiles are written by ``port_fixtures.icc_profile`` from published
constants: Adobe RGB (1998) (curv gamma 563/256), Display P3 (para type 3,
v2 and v4), ProPhoto (curv 1.8), curv tables, para types 0-4, sRGB.

Tolerances: the port builds littlecms's own 8-bit fixed-point program, so
its codes equal the reference's (0 differences) on every profile here;
the float64 model beside it (``host/ops/icc.srgb8_model``) is held to
within 1 code on at most 3% of values.  The lookup-table profiles and
black-point compensation are tests/test_torch_icc_lut.py's.  The pass-through cases equal the
reference's in shape, dtype and values.  Decodes and lossy encodes equal
the JAX package's (pixels, bytes).
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

PROFILES = F.icc_test_profiles()


def _profile(name: str) -> bytes:
    return PROFILES[name]


def _cube(step: int) -> np.ndarray:
    x = np.arange(0, 256, step, dtype=np.uint8)
    return np.stack(np.meshgrid(x, x, x, indexing="ij"), -1).reshape(
        len(x) ** 2, len(x), 3)


@pytest.mark.parametrize("name", sorted(PROFILES))
def test_twin_equals_littlecms(name):
    """The twin on a 86^3 cube of 8-bit RGB equals the reference (0
    differences); the float64 model is within 1 code on <= 3%."""
    prof = _profile(name)
    cube = _cube(3)
    ref = ref_icc(cube, prof)
    got = I.icc_to_srgb(torch.from_numpy(cube), prof)
    assert got.dtype == torch.uint8 and tuple(got.shape) == cube.shape
    assert np.array_equal(got.numpy(), ref)
    model = HICC.srgb8_model(cube, HICC.plan(prof)).astype(np.int64)
    d = np.abs(model - ref)
    assert d.max() <= 1 and (d > 0).mean() <= 0.03, (d.max(), d.mean())


@pytest.mark.parametrize("nch", [1, 3, 4])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("name", ["adobe", "p3 v4", "curv table", "srgb"])
def test_channels_and_depths_equal_the_reference(name, dtype, nch):
    """1 channel comes out as 3, 4 keep their alpha, 16-bit samples go
    through 8 bits and come back as (v << 8) | v: shape, dtype and values
    as the reference's."""
    rng = np.random.default_rng(nch * 10 + np.dtype(dtype).itemsize)
    top = 256 if dtype == np.uint8 else 65536
    px = rng.integers(0, top, (23, 31, nch)).astype(dtype)
    prof = _profile(name)
    ref = ref_icc(px, prof)
    got = I.icc_to_srgb(torch.from_numpy(px), prof).numpy()
    assert got.shape == ref.shape and got.dtype == ref.dtype
    assert np.array_equal(got, ref)


def _lab_profile(kind: str) -> bytes:
    from PIL import ImageCms
    return ImageCms.ImageCmsProfile(ImageCms.createProfile(kind)).tobytes()


def _passthrough_cases():
    p3 = F.icc_profile("p3", F.SRGB_PARA, 4)
    grey = F.icc_profile(None, None, 2, space=b"GRAY", extra=[
        (b"kTRC", b"curv\0\0\0\0\0\0\0\x01\x02\x33")])
    return {
        "lab": (lambda: _lab_profile("LAB"), 3),
        "xyz": (lambda: _lab_profile("XYZ"), 3),
        "two channels": (lambda: p3, 2),
        "five channels": (lambda: p3, 5),
        "grey profile, grey pixels": (lambda: grey, 1),
        "grey profile, rgb pixels": (lambda: grey, 3),
        "abstract class": (lambda: p3[:12] + b"abst" + p3[16:], 3),
        "device link": (lambda: p3[:12] + b"link" + p3[16:], 3),
        "cmyk": (lambda: F.icc_profile("p3", F.SRGB_PARA, 2,
                                       space=b"CMYK"), 3),
        "no colorants": (lambda: F.icc_profile(None, F.SRGB_PARA, 2), 3),
        "no curves": (lambda: F.icc_profile("p3", None, 2), 3),
        "truncated": (lambda: p3[:200], 3),
        "garbage": (lambda: b"\0" * 300, 4),
    }


@pytest.mark.parametrize("case", sorted(_passthrough_cases()))
def test_passthrough_equals_the_reference(case, caplog):
    """Where littlecms builds no transform, the reference returns its
    input with a warning: so does the port (the same tensor)."""
    make, nch = _passthrough_cases()[case]
    prof = make()
    px = np.random.default_rng(nch).integers(0, 256, (9, 14, nch)).astype(
        np.uint8)
    ref = ref_icc(px, prof)
    t = torch.from_numpy(px)
    with caplog.at_level(logging.WARNING, logger="jxl_coder_tpu_torch.icc"):
        got = I.icc_to_srgb(t, prof)
    assert got is t
    assert ref.shape == px.shape and ref.dtype == px.dtype
    assert np.array_equal(got.numpy(), ref)
    assert any("returning pixels unconverted" in r.getMessage()
               for r in caplog.records)


@pytest.mark.parametrize("tag", [b"A2B0", b"D2B0"])
def test_lookup_table_profile_raises(tag, caplog):
    """A Display P3 profile with an identity lut8 (mft1) table: under A2B0
    littlecms converts through the table, and so does the port (equal to
    the reference on a 52^3 cube); under D2B0, where littlecms reads only
    mpet, it builds no transform, and the port passes the pixels through
    with the reference's warning.  (The name is the test's from when the
    port raised NotImplementedError on both.)"""
    prof = F.icc_profile("p3", F.SRGB_PARA, 2, extra=[(tag, F.icc_lut8())])
    cube = _cube(5)
    ref = ref_icc(cube, prof)
    t = torch.from_numpy(cube)
    with caplog.at_level(logging.WARNING, logger="jxl_coder_tpu_torch.icc"):
        got = I.icc_to_srgb(t, prof)
    assert np.array_equal(got.numpy(), ref)
    unconverted = any("returning pixels unconverted" in r.getMessage()
                      for r in caplog.records)
    if tag == b"D2B0":
        assert got is t and unconverted and np.array_equal(ref, cube)
    else:
        assert not unconverted and not np.array_equal(ref, cube)


def test_a2b1_alone_stays_on_the_matrix():
    """An A2B1 without A2B0: the perceptual intent leaves littlecms on the
    matrix and curves, and the port too (equal to the reference)."""
    prof = F.icc_profile("p3", F.SRGB_PARA, 2, extra=[(b"A2B1", F.icc_lut8())])
    cube = _cube(5)
    got = I.icc_to_srgb(torch.from_numpy(cube), prof).numpy()
    assert np.array_equal(got, ref_icc(cube, prof))


def test_nonzero_black_raises():
    """A Display P3 v4 profile whose curves' black is 0.02: littlecms's
    black-point compensation moves every value (its CLUT program), and
    the port equals the reference on an 86^3 cube.  (The name is the
    test's from when the port raised NotImplementedError there.)"""
    prof = F.icc_profile("p3", ("para", 2, (2.4, 1.1, -0.1, 0.02)), 4)
    cube = _cube(3)
    got = I.icc_to_srgb(torch.from_numpy(cube), prof).numpy()
    ref = ref_icc(cube, prof)
    assert np.array_equal(got, ref)
    assert isinstance(HICC.plan(prof), HLUT.ClutTransform)


_ICC_RUN = r"""
#include "icc.cuh"
using namespace jxl_icc;
// icc.cu's threads one after another on the host
template <typename T, int C>
static void run(const T* in, T* out, long long n, const unsigned char* tab) {
  const int32_t* words = (const int32_t*)tab;
  for (long long p = 0; p < n; ++p)
    icc_pixel<T, C>(in + p * C, out + p * (C == 1 ? 3 : C), words,
                    words + kShaper1, tab + 4 * kWords);
}
extern "C" void icc_host(const void* in, void* out, int dtype, int C,
                         long long n, const unsigned char* tab) {
  if (dtype == 0) {
    const uint8_t* i = (const uint8_t*)in;
    uint8_t* o = (uint8_t*)out;
    if (C == 1) run<uint8_t, 1>(i, o, n, tab);
    if (C == 3) run<uint8_t, 3>(i, o, n, tab);
    if (C == 4) run<uint8_t, 4>(i, o, n, tab);
  } else {
    const uint16_t* i = (const uint16_t*)in;
    uint16_t* o = (uint16_t*)out;
    if (C == 1) run<uint16_t, 1>(i, o, n, tab);
    if (C == 3) run<uint16_t, 3>(i, o, n, tab);
    if (C == 4) run<uint16_t, 4>(i, o, n, tab);
  }
}
"""


@pytest.fixture(scope="module")
def icc_host(tmp_path_factory):
    """csrc/icc.cuh's icc_pixel built for the host with g++."""
    gxx = shutil.which("g++")
    assert gxx, "g++ builds the port's host codec; it is needed here too"
    tmp = tmp_path_factory.mktemp("icc")
    cpp, so = tmp / "run.cpp", tmp / "librun.so"
    cpp.write_text(_ICC_RUN)
    subprocess.run([gxx, "-O2", "-std=c++17", "-Wall", "-Werror",
                    "-ffp-contract=off", "-shared", "-fPIC", "-I",
                    str(_build.CSRC), "-o", str(so), str(cpp)], check=True)
    lib = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.icc_host.argtypes = [p, p, i, i, ctypes.c_longlong, p]
    return lib


@pytest.mark.parametrize("nch", [1, 3, 4])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("name", ["p3 v4", "curv table", "srgb table"])
def test_kernel_program_equals_the_reference(icc_host, name, dtype, nch):
    """icc.cuh's per-pixel program (g++) on seeded pixels and the 8-bit
    cube equals the reference's codes."""
    prof = _profile(name)
    tab = HICC.plan(prof).packed()
    rng = np.random.default_rng(nch)
    top = 256 if dtype == np.uint8 else 65536
    px = rng.integers(0, top, (40, 53, nch)).astype(dtype)
    if nch == 3 and dtype == np.uint8:
        px = _cube(4)
    px = np.ascontiguousarray(px)
    out = np.zeros(px.shape[:2] + (3 if nch == 1 else nch,), dtype)
    icc_host.icc_host(px.ctypes.data, out.ctypes.data,
                      int(dtype == np.uint16), nch,
                      px.shape[0] * px.shape[1], tab.ctypes.data)
    assert np.array_equal(out, ref_icc(px, prof))


# ---- the decode and the lossy encode ---------------------------------------

def _still(nch: int, dtype, name: str = "p3 v4") -> bytes:
    img = F.bench_frame(30, 44)
    px = img[..., :nch] if nch <= 3 else np.concatenate(
        [img, 255 - img[..., :1]], -1)
    px = px.astype(dtype) * (257 if dtype == np.uint16 else 1)
    return ref_api.encode(px, lossless=True, effort=2, icc=_profile(name))


@pytest.mark.parametrize("nch,dtype", [(3, np.uint8), (1, np.uint8),
                                       (4, np.uint16), (4, np.uint8)])
def test_modular_icc_decode_equals_the_jax_package(nch, dtype):
    """api.decode / decode_thumbnail / decode_sampled / decode_batch of a
    Modular still with an embedded profile: equal to the JAX package's (a
    grey still comes out as RGB, ROADMAP R21)."""
    data = _still(nch, dtype)
    got, info = api.decode(data, device="cpu")
    ref, ref_info = ref_api.decode(data)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    assert np.array_equal(got, ref) and vars(info) == vars(ref_info)
    assert np.array_equal(api.decode_thumbnail(data, device="cpu")[0],
                          ref_api.decode_thumbnail(data)[0])
    for cfg in (2, 3):
        a = api.decode_sampled(data, 17, 12, cfg, device="cpu")[0]
        b = ref_api.decode_sampled(data, 17, 12, cfg)[0]
        assert a.shape == b.shape and a.dtype == b.dtype
        assert np.array_equal(a, b)
    batch = api.decode_batch([data, data], device="cpu")
    assert all(np.array_equal(b, ref) for b in batch)


def test_decode_runs_the_transform_once(monkeypatch):
    """The decode of an ICC still transforms once, through the wrapper of
    its program: the matrix profile's through transform, the lookup-table
    profile's through clut_transform (equal to the JAX package's)."""
    calls = []

    def counted(name):
        plain = getattr(I, name)

        def run(*a, **k):
            calls.append((name, a[0].shape))
            return plain(*a, **k)
        monkeypatch.setattr(I, name, run)
    counted("transform_plain")
    counted("clut_transform_plain")
    api.decode(_still(3, np.uint8), device="cpu")
    assert calls == [("transform_plain", (30, 44, 3))]
    calls.clear()
    lut = ref_api.encode(F.bench_frame(8, 8), lossless=True, effort=1,
                         icc=F.lut_profile())
    got, _ = api.decode(lut, device="cpu")
    assert calls == [("clut_transform_plain", (8, 8, 3))]
    assert np.array_equal(got, ref_api.decode(lut)[0])


@pytest.mark.parametrize("kind", ["u8", "u16", "float", "grey", "rgba"])
def test_lossy_encode_with_icc_equals_the_jax_package(kind):
    """encode(icc=, lossless=False): the pixels through the profile, then
    the lossy encode without it; bytes equal to the JAX package's."""
    img = F.bench_frame(32, 40)
    px = {"u8": img, "u16": img.astype(np.uint16) * 257,
          "float": img.astype(np.float32) / 255.0, "grey": img[..., 1],
          "rgba": np.concatenate([img, img[..., :1]], -1)}[kind]
    prof = _profile("adobe")
    got = api.encode(px, lossless=False, quality=90, icc=prof, device="cpu")
    ref = ref_api.encode(px, lossless=False, quality=90, icc=prof)
    assert got == ref


def test_with_icc_splices_the_header():
    """port_fixtures.with_icc (chip_smoke's 4K ICC still) writes the bytes
    modular_still writes with the profile."""
    img = F.bench_frame(24, 40)
    prof = _profile("p3 v4")
    assert F.with_icc(F.modular_still(img), prof) == \
        F.modular_still(img, icc=prof)


def test_lossless_keeps_the_profile():
    """A lossless encode embeds the profile (bytes equal to the JAX
    package's), and the decode converts it."""
    prof = _profile("prophoto")
    img = F.bench_frame(16, 24)
    got = api.encode(img, lossless=True, effort=2, icc=prof, device="cpu")
    assert got == ref_api.encode(img, lossless=True, effort=2, icc=prof)
    out, _ = api.decode(got, device="cpu")
    assert np.array_equal(out, ref_icc(img, prof))


def test_animation_frames_are_not_transformed():
    """The reference applies no ICC transform to animation frames (ROADMAP
    R22): decode_frames of an animation with a profile equals the JAX
    package's and the frames as coded."""
    frames = [F.bench_frame(16, 20), F.bench_frame(16, 20)[::-1].copy()]
    hdr = F.animation_header(16, 20, 3)
    hdr.metadata.icc_profile = _profile("p3 v4")
    hdr.metadata.colour_encoding.want_icc = True
    data = F.header_bytes(hdr) + b"".join(
        F.animation_frame(hdr, f, 100, k == 1) for k, f in enumerate(frames))
    got, _, _ = api.decode_frames(data, device="cpu")
    ref, _, _ = ref_api.decode_frames(data)
    assert all(np.array_equal(a, b) and np.array_equal(a, f)
               for a, b, f in zip(got, ref, frames))
