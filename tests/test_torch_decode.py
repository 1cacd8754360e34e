"""The port's VarDCT still decode end to end on the CPU
(jxl_coder_tpu_torch.api.decode(data, device="cpu")) vs the JAX
package: the device reconstruction tpu_full.reconstruct_state_device on
JAX CPU, and the float64 host decoder (JXL_TPU_DEVICE=0).

Tolerance: 8-bit output within 1 code on < 0.1% of pixels (float32 vs
float64 rounding at the output quantizer); 16-bit within 64 codes.
"""

import numpy as np
import pytest

from jxl_coder_tpu import api as ref_api
from jxl_coder_tpu.vardct import dec_real
from jxl_coder_tpu.vardct import tpu_full as TF
from jxl_coder_tpu.vardct.enc_real import encode_vardct_real
from jxl_coder_tpu_torch import api
from jxl_coder_tpu_torch.vardct.parse import parse_frame
from port_fixtures import sharp_frame, smooth_frame


def _within(got, ref, bits):
    assert got.shape == ref.shape and got.dtype == ref.dtype
    d = np.abs(got.astype(int) - ref.astype(int))
    if bits > 8:
        assert d.max() <= 64
    else:
        assert d.max() <= 1 and (d > 0).mean() < 1e-3


@pytest.mark.parametrize("content,h,w,distance,effort", [
    ("smooth", 192, 256, 1.0, 7), ("smooth", 200, 333, 4.0, 5),
    ("smooth", 192, 256, 0.1, 3), ("smooth", 200, 333, 1.0, 3),
    ("smooth", 192, 256, 4.0, 7), ("smooth", 200, 333, 0.1, 5),
    ("sharp", 137, 203, 1.0, 7)])
def test_decode_vs_jax_device_and_host(monkeypatch, content, h, w, distance,
                                       effort):
    img = (smooth_frame if content == "smooth" else sharp_frame)(h, w)
    data = encode_vardct_real(img, distance=distance, effort=effort)
    got, info = api.decode(data, device="cpu")
    assert (info.xsize, info.ysize) == (w, h)

    monkeypatch.setenv("JXL_TPU_DEVICE", "0")
    host, _ = ref_api.decode(data)
    _within(got, host, 8)

    # the JAX device path: its own parse (which needs the device switch
    # below 1024 blocks), then the jitted reconstruction
    monkeypatch.setenv("JXL_TPU_DEVICE", "1")
    state = dec_real.decode_vardct_frame(*api._read_frame(data),
                                         parse_only=True)
    dev = TF.reconstruct_state_device(state)[:h, :w]
    _within(got, dev, 8)

    # and the port's parse hands prepare_exec the same state
    mine = parse_frame(*api._read_frame(data))
    for k in ("qf_map", "sharp_map", "ytox_glob", "ytob_glob"):
        assert np.array_equal(mine[k], state[k])
    for c in range(3):
        assert np.array_equal(mine["dc_glob"][c], state["dc_glob"][c])
    a, b = mine["blocks_glob"], state["blocks_glob"]
    order_a = np.lexsort((a.bxs, a.bys))
    order_b = np.lexsort((b.bxs, b.bys))
    for k in ("ids", "bxs", "bys", "ncv"):
        assert np.array_equal(getattr(a, k)[order_a],
                              getattr(b, k)[order_b])
    if content == "sharp":     # the special 1-block families ran
        assert set(np.unique(a.ids)) & {1, 2, 3, 12, 13}


def test_decode_16bit_vs_host(monkeypatch):
    data = encode_vardct_real(smooth_frame(96, 136, dtype=np.uint16),
                              distance=1.0, effort=5)
    got, info = api.decode(data, device="cpu")
    assert info.bits_per_sample == 16
    monkeypatch.setenv("JXL_TPU_DEVICE", "0")
    host, _ = ref_api.decode(data)
    _within(got, host, 16)


def test_decode_outside_the_slice_raises():
    img = smooth_frame(64, 64)
    # a Modular frame decodes (tests/test_torch_modular.py); the VarDCT
    # host half still refuses one
    with pytest.raises(NotImplementedError, match="Modular"):
        api.prepare(ref_api.encode(img, lossless=True), device="cpu")
    # a noisy frame decodes since the post stages (tests/test_torch_post*);
    # its extra channels on the device entropy route still raise
    noisy = encode_vardct_real(img, distance=1.0, effort=3,
                               noise_lut=[0.1] * 8,
                               alpha=np.full((64, 64), 255))
    assert api.decode(noisy, device="cpu")[0].shape == (64, 64, 4)
    with pytest.raises(NotImplementedError, match="extra channels"):
        api.decode(noisy, device="cpu", entropy="device")
