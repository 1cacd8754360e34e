"""The progressive preview and the truncated-stream render of the PyTorch
port on the CPU (the kernels' plain twins) against the JAX package on the
same bytes, on both entropy routes: ``decode_preview`` of a two-pass
stream, a stream cut after pass 0's last section (the whole passes decode)
and after HF global (the DC image resized to the frame), a cut inside the
LF groups and a cut header (both raise InvalidJXLError), the same cuts in a
box container; as ``tests/test_device_post.py:172-212`` and
``tests/test_vardct.py:240`` hold the JAX package's.  The port's renders
are held to its float64 oracles too (``reference.preview_float64``,
``reference.dc_upsampled_float64``).

Tolerance: within 1 code on under 0.1% of values (the port reconstructs,
and resizes the DC image, in float32 where the JAX package's host decoder
runs float64).
"""

import struct

import numpy as np
import pytest

from jxl_coder_tpu import api as ref_api
from jxl_coder_tpu_torch import api, reference as R
import port_fixtures as F

H, W = 120, 272         # two groups wide: a multi-section TOC


def _within_contract(got, ref):
    assert got.shape == ref.shape and got.dtype == ref.dtype
    d = np.abs(got.astype(np.int64) - ref.astype(np.int64))
    assert d.max() <= 1 and (d > 0).mean() < 1e-3, (d.max(), (d > 0).mean())


def _container(cs: bytes, to_end: bool) -> bytes:
    """cs in a JPEG XL box container: signature, ftyp, then jxlc (its size
    0, "to the end of the file", when to_end)."""
    ftyp = b"jxl " + struct.pack(">I", 0) + b"jxl "
    return (b"\x00\x00\x00\x0cJXL \r\n\x87\n"
            + struct.pack(">I", 8 + len(ftyp)) + b"ftyp" + ftyp
            + struct.pack(">I", 0 if to_end else 8 + len(cs)) + b"jxlc" + cs)


@pytest.fixture(scope="module")
def progressive():
    """A two-pass stream and its cuts: after pass 0's last group, after
    HF global, inside the LF groups, inside the header."""
    data = R.encode_vardct(F.waves_frame(H, W), distance=1.0, effort=7,
                           progressive=True)
    cs, hdr, fh, toc = api._first_frame(data)
    assert fh.passes.num_passes == 2
    ng, ndc = fh.counts(hdr)
    assert ng > 1

    def end(i):
        return toc.section(i).offset + toc.section(i).size

    pass0 = max(end(2 + ndc + gi) for gi in range(ng))
    hf = max(end(i) for i in range(2 + ndc))
    return {"full": data, "pass0": data[:pass0], "hf": data[:hf],
            "lf": data[:end(1) - 3], "header": data[:20]}


@pytest.mark.parametrize("entropy", ["host", "device"])
def test_preview_equals_the_jax_package(progressive, entropy):
    data = progressive["full"]
    got, info = api.decode_preview(data, 1, device="cpu", entropy=entropy)
    ref, ref_info = ref_api.decode_preview(data, passes=1)
    assert vars(info) == vars(ref_info)
    _within_contract(got, ref)
    _within_contract(got, R.preview_float64(data, 1))
    full = api.decode(data, device="cpu", entropy=entropy)[0]
    assert not np.array_equal(got, full)      # pass 0 alone is coarser


def test_preview_of_a_stream_without_more_passes_is_decode(progressive):
    one = R.encode_vardct(F.waves_frame(64, 80), distance=1.0, effort=7)
    assert np.array_equal(api.decode_preview(one, device="cpu")[0],
                          api.decode(one, device="cpu")[0])
    full = progressive["full"]
    assert np.array_equal(api.decode_preview(full, 2, device="cpu")[0],
                          api.decode(full, device="cpu")[0])


@pytest.mark.parametrize("entropy", ["host", "device"])
def test_cut_after_pass0_renders_the_whole_pass(progressive, entropy):
    cut = progressive["pass0"]
    got, info = api.decode(cut, device="cpu", entropy=entropy)
    _within_contract(got, ref_api.decode(cut)[0])
    _within_contract(got, R.preview_float64(cut, 1))
    assert np.array_equal(got, api.decode_preview(
        progressive["full"], 1, device="cpu", entropy=entropy)[0])
    # the preview takes the same render (its decode raises first)
    prev = api.decode_preview(cut, 2, device="cpu", entropy=entropy)[0]
    assert np.array_equal(prev, got)


@pytest.mark.parametrize("entropy", ["host", "device"])
def test_cut_after_hf_global_renders_the_dc_image(progressive, entropy,
                                                  monkeypatch):
    """No AC pass arrived whole: the DC image resized.  decode tries the
    whole frame first, as the reference does; the render itself
    (_decode_partial) reads no pass group and synthesises nothing."""
    from jxl_coder_tpu_torch.vardct import parse, synth
    cut = progressive["hf"]
    got, _ = api.decode(cut, device="cpu", entropy=entropy)
    _within_contract(got, ref_api.decode(cut)[0])
    _within_contract(got, R.dc_upsampled_float64(cut))
    assert got.shape == (H, W, 3)

    def never(*_a, **_k):
        raise AssertionError("the DC render read a pass group or "
                             "synthesised")
    monkeypatch.setattr(parse, "read_pass_group", never)
    monkeypatch.setattr(synth, "synth_family", never)
    part, _ = api._decode_partial(cut, api.resolve_device("cpu"), entropy)
    assert np.array_equal(part, got)


@pytest.mark.parametrize("cut", ["lf", "header"])
def test_cut_before_the_dc_raises(progressive, cut):
    data = progressive[cut]
    with pytest.raises(ref_api.InvalidJXLError):
        ref_api.decode(data)
    for fn in (api.decode, api.decode_preview):
        with pytest.raises(api.InvalidJXLError):
            fn(data, device="cpu")


def test_cuts_inside_a_container(progressive):
    """A box container cut short: a jxlc box that runs to the end of the
    file renders as the bare codestream does; one whose size says more
    than arrived is not a clean prefix and raises, as in the JAX
    package."""
    full = progressive["full"]
    n = len(progressive["pass0"])
    head = len(_container(b"", True))
    cut = _container(full, True)[:head + n]
    got = api.decode(cut, device="cpu")[0]
    assert np.array_equal(got, api.decode(progressive["pass0"],
                                          device="cpu")[0])
    _within_contract(got, ref_api.decode(cut)[0])
    sized = _container(full, False)[:head + n]
    with pytest.raises(ref_api.InvalidJXLError):
        ref_api.decode(sized)
    with pytest.raises(api.InvalidJXLError):
        api.decode(sized, device="cpu")


def test_corrupt_pass_group_still_raises(progressive):
    """A whole stream with a damaged pass group is not a truncation: it
    raises, never renders a partial image."""
    data = bytearray(progressive["full"])
    cs, hdr, fh, toc = api._first_frame(bytes(data))
    ng, ndc = fh.counts(hdr)
    s = toc.section(2 + ndc + ng)           # pass 1, group 0
    data[s.offset:s.offset + s.size] = bytes(s.size)
    with pytest.raises(api.InvalidJXLError):
        api.decode(bytes(data), device="cpu")


@pytest.mark.parametrize("passes", [1, 2])
def test_host_decoder_max_passes_equals_the_jax_host_decoder(progressive,
                                                             passes):
    """host/vardct/dec_real.decode_vardct_frame(max_passes=) against its
    original on the same bytes: both float64 host decoders, equal codes
    (2 passes of 2: max_passes ignored)."""
    from jxl_coder_tpu.vardct.dec_real import decode_vardct_frame as ref_dec
    from jxl_coder_tpu.bitstream.reader import BitReader as JBR
    from jxl_coder_tpu.bitstream.headers import read_image_header as jrih
    from jxl_coder_tpu.bitstream.frame_header import (read_frame_header as jrfh,
                                                      read_toc as jrtoc)
    data = progressive["full"]
    br = JBR(data)
    hdr = jrih(br)
    fh = jrfh(br, hdr)
    ng, ndc = fh.counts(hdr)
    toc = jrtoc(br, 2 + ndc + ng * fh.passes.num_passes)
    ref = ref_dec(data, hdr, fh, toc, max_passes=passes)
    assert np.array_equal(R.preview_float64(data, passes), ref)
