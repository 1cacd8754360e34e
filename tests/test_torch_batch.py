"""jxl_coder_tpu_torch.api.decode_batch on the CPU, and the caches that its
worker threads share.

decode_batch runs each file's host half on a worker pool and the device
half on the calling thread (on the CPU: the kernels' plain twins), so
every file's pixels must equal the port's own ``decode`` of the same
bytes exactly (0 codes), on both entropy routes, for the files each
route takes; against ``jxl_coder_tpu.api.decode_batch`` (its device
route on JAX's CPU backend, JXL_TPU_DEVICE=1, as tests/test_tpu_full.py
runs it) the tolerances are PERF.md §2's: 8-bit VarDCT within 1 code on
< 0.1% of values, Modular equal.  Streams come from the port's own host
encoder and fixture writers, 40x48 to 96x160.

The two caches that worker threads share (the kernels' build in
``_build`` and the noise planes in ``vardct/post.py``) are held to
"built once" with a slow fake that makes the race certain.
"""

import ctypes
import threading
import time

import numpy as np
import pytest
import torch

import port_fixtures as F
from jxl_coder_tpu import api as ref_api
from jxl_coder_tpu_torch import _build, api, batch, reference
from jxl_coder_tpu_torch.host.api import InvalidJXLError
from jxl_coder_tpu_torch.host.bitstream.frame_header import FrameHeader
from jxl_coder_tpu_torch.host.bitstream.headers import (
    AnimationHeader, BitDepth, ColourEncoding, ImageHeader, ImageMetadata,
    SizeHeader)
from jxl_coder_tpu_torch.vardct import post


def _header(h, w, bits=8, orientation=1):
    m = ImageMetadata()
    m.bit_depth = BitDepth(False, bits, 0)
    m.orientation = orientation
    return ImageHeader(size=SizeHeader(xsize=w, ysize=h), metadata=m)


def _vardct(h, w, bits=8, seed=3, **kw):
    img = F.smooth_frame(h, w, seed=seed)
    if bits == 16:
        img = img.astype(np.uint16) * 257 + 31
    return reference.encode_vardct(img, distance=1.0, effort=7, **kw)


def _pq(h, w):
    ce = ColourEncoding()
    ce.transfer_function, ce.primaries = 16, 9      # PQ, BT.2100
    return _vardct(h, w, 16, noise_lut=reference.photon_noise_lut(3200),
                   colour=ce, intensity_target=4000.0)


def _up2(h, w):
    """Coded at h/2 x w/2, signalled at h x w with 2x upsampling."""
    img = F.smooth_frame(h, w, seed=5)[::2, ::2]
    return reference.encode_vardct(np.ascontiguousarray(img), distance=1.0,
                                   effort=7, hdr=_header(h, w),
                                   fh=FrameHeader(upsampling=2))


def _oriented(h, w):
    """Orientation 6 (rotated 90 degrees clockwise)."""
    return reference.encode_vardct(F.smooth_frame(h, w, seed=7),
                                   distance=1.0, effort=7,
                                   hdr=_header(h, w, orientation=6))


def _rgba(h, w):
    alpha = (np.mgrid[0:h, 0:w][0] * 255 // (h - 1)).astype(np.int32)
    return _vardct(h, w, alpha=alpha)


def _animation(h, w):
    """A Modular frame behind an image header that signals an animation."""
    hdr, fh = F.modular_headers(h, w, 3)
    hdr.metadata.animation = AnimationHeader()
    planes = F._planes(F.bench_frame(h, w))
    return F._still(hdr, lambda bw: reference.encode_modular_frame(
        bw, hdr, fh, planes, use_ycocg=True))


# name -> (stream writer, the entropy routes that take it)
BOTH, HOST = ("host", "device"), ("host",)
STREAMS = {
    "vardct8": (lambda: _vardct(48, 64), BOTH),
    "vardct16": (lambda: _vardct(40, 48, 16), BOTH),
    "noise_pq16": (lambda: _pq(40, 48), BOTH),
    "up2": (lambda: _up2(48, 64), BOTH),
    "oriented": (lambda: _oriented(40, 56), BOTH),
    "rgba": (lambda: _rgba(56, 72), HOST),
    "modular_rct": (lambda: F.modular_still(F.bench_frame(72, 88)), HOST),
    "modular_palette": (lambda: F.modular_still(F.posterized_frame(64, 64),
                                                palette=True), HOST),
    "modular_squeezed": (lambda: F.squeezed_still(F.bench_frame(48, 80)),
                         HOST),
    "modular_xyb": (lambda: F.xyb_still(F.bench_frame(64, 72)), HOST),
}
_BYTES, _DECODED = {}, {}


def _data(name):
    if name not in _BYTES:
        _BYTES[name] = STREAMS[name][0]()
    return _BYTES[name]


def _decoded(name, entropy):
    """api.decode of a stream on the CPU (kept: the device route's twin
    takes seconds a frame)."""
    if (name, entropy) not in _DECODED:
        _DECODED[name, entropy] = api.decode(_data(name), device="cpu",
                                             entropy=entropy)[0]
    return _DECODED[name, entropy]


def _joined(fn):
    """fn(), checking that no thread it started outlives it."""
    before = set(threading.enumerate())
    try:
        return fn()
    finally:
        assert set(threading.enumerate()) <= before


@pytest.mark.parametrize("entropy", ["host", "device"])
def test_mixed_batch_equals_decode(entropy):
    names = [n for n, (_, routes) in STREAMS.items() if entropy in routes]
    outs = _joined(lambda: api.decode_batch([_data(n) for n in names],
                                            device="cpu", entropy=entropy))
    assert len(outs) == len(names)
    for name, out in zip(names, outs):
        ref = _decoded(name, entropy)
        assert out.shape == ref.shape and out.dtype == ref.dtype, name
        assert np.array_equal(out, ref), name
    kinds = {n: o for n, o in zip(names, outs)}
    assert kinds["vardct16"].dtype == np.uint16
    assert kinds["up2"].shape == (48, 64, 3)
    assert kinds["oriented"].shape == (56, 40, 3)
    if entropy == "host":
        assert kinds["rgba"].shape == (56, 72, 4)


def test_order_kept_with_repeated_bytes():
    """The same bytes 5 times among others: each output is its own file's."""
    names = ["vardct8", "modular_rct", "vardct8", "vardct8", "oriented",
             "vardct8", "modular_rct", "vardct8"]
    outs = _joined(lambda: api.decode_batch([_data(n) for n in names],
                                            device="cpu"))
    for name, out in zip(names, outs):
        assert np.array_equal(out, _decoded(name, "host")), name


def test_one_file_and_none():
    assert api.decode_batch([], device="cpu") == []
    (out,) = api.decode_batch([_data("modular_rct")], device="cpu")
    assert np.array_equal(out, _decoded("modular_rct", "host"))


@pytest.mark.parametrize("kind,index,exc", [
    ("truncated", 2, InvalidJXLError),
    ("animation", 1, InvalidJXLError),
    ("device route on a Modular frame", 1, NotImplementedError),
])
def test_a_file_outside_the_slice_raises_with_its_index(kind, index, exc):
    """The same type as decode raises, "datas[i]" at the head of its
    message; the workers are joined before it leaves.  An animation
    decodes on a worker (its frames compose): one cut short raises there."""
    animation = _animation(32, 40)
    bad = {"truncated": _data("vardct8")[:len(_data("vardct8")) // 2],
           "animation": animation[:len(animation) // 2],
           "device route on a Modular frame": _data("modular_rct")}[kind]
    entropy = "device" if kind.startswith("device") else "host"
    with pytest.raises(exc):
        api.decode(bad, device="cpu", entropy=entropy)
    datas = ([_data("vardct16"), bad] if entropy == "device" else
             [_data("vardct8"), _data("vardct16"), _data("up2"),
              _data("oriented")])
    datas[index] = bad
    with pytest.raises(exc, match=rf"^datas\[{index}\]: ") as err:
        _joined(lambda: api.decode_batch(datas, device="cpu",
                                         entropy=entropy))
    assert type(err.value) is exc


def test_bad_arguments_raise():
    with pytest.raises(ValueError, match="entropy"):
        api.decode_batch([_data("vardct8")] * 2, device="cpu",
                         entropy="gpu")
    with pytest.raises(ValueError, match="unsupported device"):
        api.decode_batch([_data("vardct8")] * 2, device="meta")


def test_against_the_jax_package(monkeypatch):
    """The same bytes through jxl_coder_tpu.api.decode_batch on its device
    route: 8-bit VarDCT within 1 code on < 0.1% of values, orientation
    applied alike, the Modular file equal.  One geometry, so that the
    JAX side compiles once."""
    monkeypatch.setenv("JXL_TPU_DEVICE", "1")
    datas = [_vardct(96, 160, seed=s) for s in (3, 11)] + [
        reference.encode_vardct(F.smooth_frame(96, 160, seed=13),
                                distance=1.0, effort=7,
                                hdr=_header(96, 160, orientation=3)),
        F.modular_still(F.bench_frame(96, 160))]
    got = api.decode_batch(datas, device="cpu")
    ref = ref_api.decode_batch(datas)
    for k, (g, r) in enumerate(zip(got, ref)):
        assert g.shape == r.shape and g.dtype == r.dtype, k
        d = np.abs(g.astype(np.int64) - r.astype(np.int64))
        if k == 3:
            assert d.max() == 0
        else:
            assert d.max() <= 1 and (d > 0).mean() < 1e-3, (k, d.max())


# ---- the caches that worker threads share ----

def test_threads_build_a_library_once(monkeypatch, tmp_path):
    """8 threads ask for the host codec on an empty build directory: the
    compiler runs once, and every thread loads the one library."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    calls = []
    counted = threading.Lock()

    def slow_compiler(cmd, **_kw):
        with counted:
            calls.append(cmd)
        time.sleep(0.2)
        out = cmd[cmd.index("-o") + 1]
        with open(out, "wb") as f:
            f.write(b"a library")
        return type("Done", (), {"returncode": 0, "stdout": "",
                                 "stderr": ""})()

    monkeypatch.setattr(_build.subprocess, "run", slow_compiler)
    monkeypatch.setattr(ctypes, "CDLL", lambda path: path)
    _build.load_host.cache_clear()
    start = threading.Barrier(8)
    got = []

    def ask():
        start.wait()
        got.append(_build.load_host("hostcodec"))

    threads = [threading.Thread(target=ask) for _ in range(8)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    finally:
        _build.load_host.cache_clear()
    assert not any(t.is_alive() for t in threads)
    assert len(calls) == 1
    assert len(got) == 8 and len(set(got)) == 1
    assert open(got[0], "rb").read() == b"a library"
    assert not list(tmp_path.glob("*.tmp*"))


def test_threads_build_the_noise_planes_once(monkeypatch):
    """4 threads ask for the noise planes of one new size: they are built
    once, and every thread gets the one tensor."""
    calls = []

    def slow_planes(w, h):
        calls.append((w, h))
        time.sleep(0.2)
        return np.zeros((3, h, w), np.float32)

    monkeypatch.setattr(post, "noise_planes", slow_planes)
    monkeypatch.setattr(post, "_NOISE_RND", {})
    start = threading.Barrier(4)
    got = []

    def ask():
        start.wait()
        got.append(post.noise_random(24, 16, "cpu"))

    threads = [threading.Thread(target=ask) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert calls == [(24, 16)]
    assert len(got) == 4 and all(g is got[0] for g in got)
    assert got[0].shape == (3, 16, 24)


@pytest.mark.parametrize("workers,in_flight", [(1, 1), (3, 2)])
def test_any_pipeline_setting_gives_the_same_pixels(workers, in_flight):
    """decode_batch takes no worker count (batch.WORKERS and IN_FLIGHT
    were measured); the pipeline at other settings gives the same pixels."""
    assert batch.WORKERS >= 1 and batch.IN_FLIGHT >= 1
    names = ["modular_squeezed", "vardct8", "rgba"]
    outs = _joined(lambda: batch.run([_data(n) for n in names],
                                     torch.device("cpu"), "host", workers,
                                     in_flight))
    for name, out in zip(names, outs):
        assert np.array_equal(out, _decoded(name, "host")), name
