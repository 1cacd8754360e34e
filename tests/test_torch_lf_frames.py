"""LF frames and reference-only frames in the PyTorch port
(jxl_coder_tpu_torch) on the CPU, against the JAX package on the same
bytes.

- The frame walk: LF frames (any lf_level) and reference-only frames
  decode first, to their XYB planes; the first regular frame is the one
  decoded, its DC from the LF frame of the next level, its patches from
  the reference frames (jxl_coder_tpu/api.py:522-548).
- The host copy of the DC-frame fill and of return_xyb against the
  original's decode_vardct_frame on the same bytes and the same DC planes;
  the device fill (api.dc_from_frame) against the host's.
- port_fixtures' writers (no JAX): with_lf_frame (a Modular LF frame of
  the stream's DC, then the VarDCT frame with kUseDcFrame),
  vardct_reference_still (a VarDCT reference-only frame that patches read
  in every blend mode) and patched_alpha_still (the atlas and a patched
  frame with alpha), each decoded by jxl_coder_tpu.api.decode within the
  north star's contract (ROADMAP.md: at most 1 code, on under 0.1% of
  values) of the port's float64 host decoder, and by the port's
  api.decode on both entropy routes and decode_batch within the same.
"""

import numpy as np
import pytest
import torch

from jxl_coder_tpu import api as ref_api
from jxl_coder_tpu.vardct import dec_real as JDEC
from jxl_coder_tpu_torch import api, reference
from jxl_coder_tpu_torch.host.vardct import dec_real as PDEC
import port_fixtures as F


def _contract(got, ref):
    assert got.shape == ref.shape and got.dtype == ref.dtype
    d = np.abs(got[..., :3].astype(np.int64) - ref[..., :3].astype(np.int64))
    assert d.max() <= 1 and (d > 0).mean() < 1e-3, (d.max(), (d > 0).mean())
    assert np.array_equal(got[..., 3:], ref[..., 3:])


def _check_decode(data, monkeypatch, routes=("host", "device")):
    host = reference.decode_float64(data)
    for route in ("1", "0"):
        monkeypatch.setenv("JXL_TPU_DEVICE", route)
        monkeypatch.setenv("JXL_TPU_DEVICE_STRICT", route)
        _contract(ref_api.decode(data)[0], host)
    for entropy in routes:
        _contract(api.decode(data, device="cpu", entropy=entropy)[0], host)
    return host


@pytest.fixture(scope="module")
def streams():
    """The writers' streams: an LF frame before a one-section frame and
    before a frame of six groups, a VarDCT reference frame, and a patched
    frame with alpha."""
    one = reference.encode_vardct(F.bench_frame(72, 104), distance=1.0,
                                  effort=7)
    six = reference.encode_vardct(F.bench_frame(300, 560), distance=1.0,
                                  effort=7)
    return {"lf_one_section": F.with_lf_frame(one),
            "lf_six_groups": F.with_lf_frame(six),
            "vardct_reference": F.vardct_reference_still(
                F.bench_frame(64, 96)),
            "patched_alpha": F.patched_alpha_still(
                F.text_frame(192, 256), np.full((192, 256), 200, np.uint8))}


def test_the_walk_reads_the_frames_in_stream_order(streams):
    kinds = {k: [(fh.frame_type, fh.encoding, fh.lf_level, fh.flags & 0x22)
                 for fh, _ in api._read_frames(v)[2]]
             for k, v in streams.items()}
    assert kinds == {"lf_one_section": [(1, 1, 1, 0), (0, 0, 0, 0x20)],
                     "lf_six_groups": [(1, 1, 1, 0), (0, 0, 0, 0x20)],
                     "vardct_reference": [(2, 0, 0, 0), (0, 0, 0, 0x2)],
                     "patched_alpha": [(2, 1, 0, 0), (0, 0, 0, 0x2)]}
    host = api.host_half(streams["lf_six_groups"], torch.device("cpu"))
    assert [(b.lf, b.key) for b in host.before] == [(True, 1)]
    assert host.args[1] is None          # the DC is the LF frame's
    host = api.host_half(streams["vardct_reference"], torch.device("cpu"))
    assert [(b.lf, b.key) for b in host.before] == [(False, 2)]


@pytest.mark.parametrize("label", ["lf_one_section", "lf_six_groups"])
def test_dc_frame_fill_and_return_xyb_equal_the_original(streams, label):
    """The main frame decoded to XYB on the host by both packages with the
    same DC planes (the JAX package's own LF-frame decode), and the DC
    fill on the device against the host's."""
    from jxl_coder_tpu.api import _decode_lf_frame
    from jxl_coder_tpu.bitstream import container
    from jxl_coder_tpu.bitstream.frame_header import (read_frame_header,
                                                      read_toc)
    from jxl_coder_tpu.bitstream.headers import read_image_header
    from jxl_coder_tpu.bitstream.reader import BitReader
    data = streams[label]
    jcs = container.extract_codestream(data).codestream
    br = BitReader(jcs)
    jhdr = read_image_header(br)
    frames = []
    for _ in range(2):
        fh = read_frame_header(br, jhdr)
        ng, ndc = fh.counts(jhdr)
        n = 1 if (ng == 1 and fh.passes.num_passes == 1) else (
            2 + ndc + ng * fh.passes.num_passes)
        toc = read_toc(br, n)
        frames.append((fh, toc))
        br.pos = toc.end_offset * 8
    dc = _decode_lf_frame(jcs, jhdr, *frames[0], {})
    ref = JDEC.decode_vardct_frame(jcs, jhdr, *frames[1], dc_frame=dc,
                                   return_xyb=True)
    cs, hdr, pframes = api._read_frames(data)
    mine = PDEC.decode_vardct_frame(cs, hdr, *pframes[1], dc_frame=dc,
                                    return_xyb=True)
    for c in range(3):
        assert np.array_equal(mine[c], ref[c])
    # one block row and column short: the edge repeats
    lh, lw = dc[0].shape
    short = {c: dc[c][:lh - 1, :lw - 1] for c in range(3)}
    host = PDEC.dc_from_frame(short, lw, lh)
    dev = api.dc_from_frame(torch.from_numpy(np.stack(
        [short[c] for c in range(3)])), lh, lw)
    assert np.array_equal(dev.numpy(), np.stack([host[c] for c in range(3)])
                          .astype(np.float32))
    assert np.array_equal(host[0][-1], host[0][-2])


@pytest.mark.parametrize("label", ["lf_one_section", "lf_six_groups",
                                   "vardct_reference"])
def test_writers_streams_decode_within_the_contract(streams, label,
                                                    monkeypatch):
    routes = ("host", "device") if label != "lf_six_groups" else ("host",)
    _check_decode(streams[label], monkeypatch, routes)


def test_the_lf_frame_carries_the_dc(streams):
    """Against the stream it was made from, the LF-frame stream's pixels
    differ only by the DC's requantization and the smoothing it skips."""
    one = reference.encode_vardct(F.bench_frame(72, 104), distance=1.0,
                                  effort=7)
    a = api.decode(one, device="cpu")[0].astype(int)
    b = api.decode(streams["lf_one_section"], device="cpu")[0].astype(int)
    assert np.abs(a - b).mean() < 2.0


def test_patched_frame_with_alpha(streams, monkeypatch):
    """The alpha channel decodes as the stream's (its blendings ignored, as
    the reference's decode path ignores them); entropy="device" raises on
    a frame with extra channels, as it does without patches."""
    host = _check_decode(streams["patched_alpha"], monkeypatch, ("host",))
    assert host.shape == (192, 256, 4) and (host[..., 3] == 200).all()
    with pytest.raises(NotImplementedError, match="extra channels"):
        api.decode(streams["patched_alpha"], device="cpu", entropy="device")


def test_decode_batch_takes_lf_and_reference_streams(streams):
    datas = [streams["lf_one_section"], streams["patched_alpha"],
             streams["vardct_reference"], streams["lf_six_groups"],
             F.modular_still(F.bench_frame(24, 32))]
    outs = api.decode_batch(datas, device="cpu")
    for out, data in zip(outs, datas):
        assert np.array_equal(out, api.decode(data, device="cpu")[0])


def test_a_frame_whose_dc_frame_is_missing_raises(streams):
    """The VarDCT frame of an LF-frame stream alone."""
    cs, hdr, frames = api._read_frames(streams["lf_one_section"])
    from jxl_coder_tpu_torch.host.bitstream.writer import BitWriter
    from jxl_coder_tpu_torch.host.codec import write_image_header
    bw = BitWriter()
    write_image_header(bw, hdr)
    F._frame_bytes(bw, hdr, frames[1][0], F._sections(cs, frames[1][1]))
    with pytest.raises(api.InvalidJXLError, match="DC frame"):
        api.decode(bw.to_bytes(), device="cpu")
    with pytest.raises(ref_api.InvalidJXLError):
        ref_api.decode(bw.to_bytes())
