"""The port's own host layers (jxl_coder_tpu_torch/host) vs the JAX
package's, which they copy: the parse state, the host encoder's bytes,
the native host codec the port builds, and the float64 host decode.
All of them are integer or float64 paths with the same code, so every
comparison is exact.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest

from jxl_coder_tpu import api as jax_api
from jxl_coder_tpu import native as jax_native
from jxl_coder_tpu.bitstream import container as jax_container
from jxl_coder_tpu.bitstream.frame_header import (read_frame_header as
                                                  jax_read_frame_header,
                                                  read_toc as jax_read_toc)
from jxl_coder_tpu.bitstream.headers import read_image_header as jax_rih
from jxl_coder_tpu.bitstream.reader import BitReader as JaxBitReader
from jxl_coder_tpu.vardct import dec_real as jax_dec
from jxl_coder_tpu.vardct.enc_real import encode_vardct_real as jax_encode
from jxl_coder_tpu_torch import _build, api, reference
from jxl_coder_tpu_torch.host import native as port_native
from jxl_coder_tpu_torch.host.bitstream.reader import BitReader
from jxl_coder_tpu_torch.host.vardct import dec_real as port_dec
from jxl_coder_tpu_torch.vardct.parse import parse_frame
from port_fixtures import bench_frame, sharp_frame, smooth_frame

# (image, distance, effort): all DCT8 at effort 2; a ragged two-group
# frame at effort 5; the special 1-block transforms at effort 7
STREAMS = {
    "e2": (lambda: smooth_frame(72, 104), 1.0, 2),
    "e5_ragged": (lambda: bench_frame(261, 333), 2.5, 5),
    "e7_sharp": (lambda: sharp_frame(137, 203), 1.0, 7),
}


def _stream(key):
    make, distance, effort = STREAMS[key]
    return reference.encode_vardct(make(), distance=distance, effort=effort)


def _jax_read_frame(data):
    """The JAX package's own container, header and TOC reads."""
    cs = jax_container.extract_codestream(data).codestream
    br = JaxBitReader(cs)
    hdr = jax_rih(br)
    fh = jax_read_frame_header(br, hdr)
    ng, ndc = fh.counts(hdr)
    n = 1 if (ng == 1 and fh.passes.num_passes == 1) else (
        2 + ndc + ng * fh.passes.num_passes)
    return cs, hdr, fh, jax_read_toc(br, n)


def _raster(ba):
    """A BlockArrays' blocks in raster order: (ids, bxs, bys, ncv, every
    block's coefficients concatenated)."""
    order = np.lexsort((ba.bxs, ba.bys))
    coeffs = np.concatenate([ba.coeffs[ba.offs[i]:ba.offs[i + 1]]
                             for i in order])
    return (ba.ids[order], ba.bxs[order], ba.bys[order], ba.ncv[order],
            coeffs)


@pytest.mark.parametrize("key", list(STREAMS))
def test_parse_state_equals_the_jax_parse_only_state(monkeypatch, key):
    data = _stream(key)
    # dec_real returns its parse-only state only with the device switch on
    monkeypatch.setenv("JXL_TPU_DEVICE", "1")
    ref = jax_dec.decode_vardct_frame(*_jax_read_frame(data),
                                      parse_only=True)
    got = parse_frame(*api._read_frame(data))
    assert isinstance(ref, dict) and set(got) == set(ref)
    for k in ("qf_map", "sharp_map", "ytox_glob", "ytob_glob"):
        assert got[k].dtype == ref[k].dtype
        assert np.array_equal(got[k], ref[k]), k
    for c in range(3):
        assert np.array_equal(got["dc_glob"][c], ref["dc_glob"][c])
    for k in ("bits", "h", "w"):
        assert got[k] == ref[k]
    # dec_real concatenates its AC groups in the order its threads finish
    a, b = _raster(got["blocks_glob"]), _raster(ref["blocks_glob"])
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    # the copies are other classes: compare their fields
    lf_a, lf_b = got["lf"], ref["lf"]
    for f in dataclasses.fields(lf_b):
        if f.name not in ("gtree", "gcode", "mfd"):
            x, y = getattr(lf_a, f.name), getattr(lf_b, f.name)
            if dataclasses.is_dataclass(y):
                x, y = dataclasses.astuple(x), dataclasses.astuple(y)
            assert x == y, f.name
    rf_a, rf_b = got["fh"].restoration_filter, ref["fh"].restoration_filter
    assert vars(rf_a) == vars(rf_b)


@pytest.mark.parametrize("kwargs", [
    dict(make=lambda: smooth_frame(72, 104), distance=1.0, effort=2),
    dict(make=lambda: sharp_frame(137, 203), distance=1.0, effort=7),
    dict(make=lambda: bench_frame(261, 333), distance=2.5, effort=5,
         progressive=True),
], ids=["e2", "e7_sharp", "e5_ragged_progressive"])
def test_encoder_copy_writes_the_jax_host_encoders_bytes(monkeypatch,
                                                         kwargs):
    kwargs = dict(kwargs)
    img = kwargs.pop("make")()
    monkeypatch.setenv("JXL_TPU_DEVICE", "0")     # its host branch
    assert reference.encode_vardct(img, **kwargs) == jax_encode(img,
                                                                **kwargs)


def test_port_built_host_codec_decodes_an_ac_group_as_the_jax_native_path():
    assert jax_native.get_lib() is not None
    # the port's library: built from its own copy into the build
    # directory, not the JAX package's
    lib = port_native.get_lib()
    assert Path(lib._name).parent == _build.BUILD_DIR
    assert Path(jax_native.get_lib()._name).parent != _build.BUILD_DIR

    data = _stream("e5_ragged")
    out = []
    for dec, (cs, hdr, fh, toc), Reader in (
            (port_dec, api._read_frame(data), BitReader),
            (jax_dec, _jax_read_frame(data), JaxBitReader)):
        def section(i):
            s = toc.section(i)
            return Reader(cs[s.offset:s.offset + s.size])
        w, h = fh.coded_size(hdr)
        ng, ndc = fh.counts(hdr)
        lf = dec.read_lf_global(section(0), fh, hdr, w, h)
        lg = dec.read_lf_group(section(1), lf, min(256, -(-w // 8)),
                               min(256, -(-h // 8)), 0, ndc)
        hf = dec.read_hf_global(section(1 + ndc), lf, ng, 1, ndc)
        sub = dec._lf_group_view(lg, 0, 0, 32, 32)
        dc_q = np.stack([sub.dc.channels[i].data for i in (1, 0, 2)])
        br = section(2 + ndc)
        histo = br.u((hf.num_histograms - 1).bit_length()) \
            if hf.num_histograms > 1 else 0
        out.append(dec.read_pass_group(br, lf, hf, sub, 32, 32, 0, histo,
                                       dc_q, as_arrays=True))
    for f in ("ids", "bxs", "bys", "ncv", "offs", "coeffs"):
        assert np.array_equal(getattr(out[0], f), getattr(out[1], f)), f


@pytest.mark.parametrize("bits16", [False, True])
def test_float64_reference_equals_the_jax_host_decode(monkeypatch, bits16):
    img = bench_frame(90, 150)
    data = reference.encode_vardct(img, distance=1.0, effort=5,
                                   bit_depth=16 if bits16 else None)
    monkeypatch.setenv("JXL_TPU_DEVICE", "0")
    ref, _ = jax_api.decode(data)
    got = reference.decode_float64(data)
    assert got.dtype == (np.uint16 if bits16 else np.uint8)
    assert got.dtype == ref.dtype and np.array_equal(got, ref)


def test_host_codec_build_failure_raises(monkeypatch, tmp_path):
    """A host codec that cannot be built raises; nothing falls back."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    broken = tmp_path / "src"
    broken.mkdir()
    (broken / "hostcodec.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(_build, "HOST_SRC", broken)
    _build.load_host.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            _build.load_host("hostcodec")
        monkeypatch.setenv("PATH", str(tmp_path))
        with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
            _build.load_host("hostcodec")
    finally:
        _build.load_host.cache_clear()
    assert not list((tmp_path / "build").glob("*.so"))
