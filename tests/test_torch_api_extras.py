"""The PyTorch port's API leftovers on the CPU against the JAX package:
``api.is_jxl`` / ``get_size``, ``config`` (EncodeConfig, DecodeConfig and
their front doors), ``utils.trace`` (spans, the report, JSON logs, and a
``torch.profiler`` Chrome trace written on the CPU) and the Pillow plugin
(still and animated round trips, as ``tests/test_ops_animation.py``'s
tests of the JAX plugin).

Tolerances: everything here is exact (booleans, sizes, bytes, pixels,
span counts).  The plugin tests register the port's plugin under Pillow's
"JXL" format and restore Pillow's registry afterwards, so a JAX plugin
test in the same process keeps its own plugin.
"""

import contextlib
import io
import json
import logging
import os

import numpy as np
import pytest

from jxl_coder_tpu import api as ref_api
from jxl_coder_tpu import config as ref_config
from jxl_coder_tpu.utils import trace as ref_trace
from jxl_coder_tpu_torch import api, config
from jxl_coder_tpu_torch.utils import trace
import port_fixtures as F


@pytest.fixture(scope="module")
def streams():
    img = F.bench_frame(24, 40)
    return {
        "modular": F.modular_still(img),
        "vardct": ref_api.encode(img, lossless=False, quality=80),
        "grey": F.modular_still(img[..., 1]),
        "animation": F.animated_stream([img, img[::-1].copy()]),
        "jpeg": api.construct(F.baseline_jpeg(img)),
    }


def test_is_jxl_equals_the_jax_package(streams):
    cases = list(streams.values()) + [
        b"", b"\xff", b"\xff\x0a", b"\x0a\xff", b"\x00" * 12,
        b"\x00\x00\x00\x0cJXL \r\n\x87\n", b"\x00\x00\x00\x0cJXL \r\n\x87",
        b"\xff\xd8\xff\xe0", b"GIF89a"]
    for data in cases:
        assert api.is_jxl(data) == ref_api.is_jxl(data), data[:12]
    assert api.is_jxl(streams["modular"]) and not api.is_jxl(b"GIF89a")


def test_get_size_equals_the_jax_package(streams):
    for label, data in streams.items():
        assert api.get_size(data) == ref_api.get_size(data), label
    with pytest.raises(api.InvalidJXLError):
        api.get_size(b"not a jxl file")


@pytest.mark.parametrize("orientation", [1, 6, 8])
def test_get_size_is_oriented(orientation):
    img = F.bench_frame(10, 26)
    hdr, fh = F.modular_headers(10, 26, 3)
    hdr.metadata.orientation = orientation
    from jxl_coder_tpu_torch import reference as R
    data = F._still(hdr, lambda bw: R.encode_modular_frame(
        bw, hdr, fh, F._planes(img), use_ycocg=True))
    assert api.get_size(data) == ref_api.get_size(data)
    assert api.get_size(data) == ((26, 10) if orientation == 1
                                  else (10, 26))


def test_config_matches_the_jax_package():
    for cls, ref_cls in ((config.EncodeConfig, ref_config.EncodeConfig),
                         (config.DecodeConfig, ref_config.DecodeConfig)):
        ours, theirs = cls(), ref_cls()
        assert [f.name for f in config.dataclasses.fields(ours)] == \
            [f.name for f in ref_config.dataclasses.fields(theirs)]
        assert {k: int(v) for k, v in vars(ours).items()} == \
            {k: int(v) for k, v in vars(theirs).items()}
    for q in (0, 1, 37, 50, 75, 90, 99, 100):
        c = config.EncodeConfig(quality=q)
        assert c.distance == ref_config.EncodeConfig(quality=q).distance
        assert not c.lossless
    lossless = config.EncodeConfig(compression=config.CompressionOption
                                   .LOSSLESS)
    assert lossless.lossless and lossless.distance == 0.0
    for bad in (dict(effort=0), dict(effort=11), dict(quality=101),
                dict(quality=-1), dict(decoding_speed=5)):
        with pytest.raises(ValueError):
            config.EncodeConfig(**bad).validate()
        with pytest.raises(ValueError):
            ref_config.EncodeConfig(**bad).validate()


def test_config_front_doors_equal_the_jax_package(streams):
    img = F.bench_frame(24, 32)
    cfg = config.EncodeConfig(compression=config.CompressionOption.LOSSLESS,
                              effort=config.Effort.THUNDER)
    ref_cfg = ref_config.EncodeConfig(
        compression=ref_config.CompressionOption.LOSSLESS,
        effort=ref_config.Effort.THUNDER)
    assert config.encode(img, cfg, device="cpu") == \
        ref_config.encode(img, ref_cfg)
    assert config.encode(img, device="cpu", quality=70) == \
        ref_config.encode(img, quality=70)
    with pytest.raises(ValueError):
        config.encode(img, device="cpu", effort=0)
    dcfg = config.DecodeConfig(
        preferred_color_config=config.PreferredColorConfig.RGB_565,
        scale_mode=config.ScaleMode.FILL, target_width=13,
        target_height=9)
    ref_dcfg = ref_config.DecodeConfig(
        preferred_color_config=ref_config.PreferredColorConfig.RGB_565,
        scale_mode=ref_config.ScaleMode.FILL, target_width=13,
        target_height=9)
    got, info = config.decode_sampled(streams["modular"], dcfg, device="cpu")
    ref, ref_info = ref_config.decode_sampled(streams["modular"], ref_dcfg)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    assert np.array_equal(got, ref) and vars(info) == vars(ref_info)


def test_config_decodes_on_the_named_device(streams):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        config.decode_sampled(streams["modular"], device="cuda")


def _span_rows(mod):
    mod.reset()
    mod.enable(True)
    try:
        with mod.span("decode"):
            with mod.span("parse"):
                pass
            with mod.span("parse"):
                pass
        with mod.span("encode"):
            pass
    finally:
        mod.enable(False)
    rows = {ln.split()[0]: int(ln.split()[1])
            for ln in mod.report().splitlines()[1:]}
    header = mod.report().splitlines()[0]
    mod.reset()
    return rows, header


def test_trace_spans_equal_the_jax_package():
    ours, header = _span_rows(trace)
    theirs, ref_header = _span_rows(ref_trace)
    assert ours == theirs == {"decode": 1, "decode.parse": 2, "encode": 1}
    assert header == ref_header
    trace.reset()
    with trace.span("off"):         # disabled: nothing recorded
        pass
    assert trace.report().splitlines()[1:] == []


def test_trace_json_logs(capsys):
    saved = list(trace.log.handlers), trace.log.level
    try:
        trace.enable_json_logs(logging.INFO)
        trace.log.info("hello %d", 3)
        logging.getLogger("jxl_coder_tpu_torch.icc").warning("child")
    finally:
        trace.log.handlers[:] = saved[0]
        trace.log.setLevel(saved[1])
    lines = [json.loads(ln) for ln in capsys.readouterr().err.splitlines()]
    assert [(r["logger"], r["level"], r["msg"]) for r in lines] == [
        ("jxl_coder_tpu_torch", "INFO", "hello 3"),
        ("jxl_coder_tpu_torch.icc", "WARNING", "child")]
    assert trace.log.name == "jxl_coder_tpu_torch"


def test_device_trace_writes_a_chrome_trace(tmp_path, streams):
    """device_trace on the CPU: a decode inside it leaves one Chrome trace
    in logdir whose events name torch operations."""
    logdir = tmp_path / "trace"
    with trace.device_trace(str(logdir)) as prof:
        api.decode(streams["modular"], device="cpu")
    files = os.listdir(logdir)
    assert len(files) == 1 and files[0].endswith(".json")
    events = json.loads((logdir / files[0]).read_text())["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)
    assert prof.key_averages()


# ---- the Pillow plugin -----------------------------------------------------

@contextlib.contextmanager
def _pil_registry():
    """Pillow's plugin registry (and the JAX plugin's registration, if
    any) restored when the block ends; Pillow's own plugins are loaded
    first, so the restored registry keeps them."""
    from PIL import Image
    Image.init()
    saved = [(reg, reg.copy()) for reg in (
        Image.OPEN, Image.ID, Image.SAVE, Image.SAVE_ALL, Image.EXTENSION,
        Image.MIME)]
    try:
        yield
    finally:
        for reg, old in saved:
            reg.clear()
            (reg.extend if isinstance(reg, list) else reg.update)(old)


@pytest.fixture
def pil_port():
    """The port's plugin registered on the CPU."""
    from jxl_coder_tpu_torch.integrations import pil_plugin
    with _pil_registry():
        pil_plugin.register("cpu")
        yield pil_plugin


def test_pil_plugin_roundtrip(pil_port):
    from PIL import Image
    img = np.random.default_rng(5).integers(0, 255, (24, 32, 3)).astype(
        np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JXL")
    data = buf.getvalue()
    assert data == ref_api.encode(img, lossless=True)
    im = Image.open(io.BytesIO(data))
    assert im.format == "JXL" and im.size == (32, 24) and im.mode == "RGB"
    assert isinstance(im, pil_port.JxlImageFile)
    assert np.array_equal(np.asarray(im), img)


def test_pil_plugin_reads_alpha_grey_and_16_bit(pil_port):
    from PIL import Image
    img = F.bench_frame(12, 20)
    rgba = np.concatenate([img, 255 - img[..., :1]], -1)
    im = Image.open(io.BytesIO(F.modular_still(rgba)))
    assert im.mode == "RGBA" and np.array_equal(np.asarray(im), rgba)
    im = Image.open(io.BytesIO(F.modular_still(img[..., 0])))
    assert np.array_equal(np.asarray(im), np.repeat(img[..., :1], 3, -1))
    im = Image.open(io.BytesIO(F.modular_still(img.astype(np.uint16) * 257)))
    assert im.info["bits_per_sample"] == 16
    assert np.array_equal(np.asarray(im), img)


def test_pil_plugin_animated_roundtrip(pil_port):
    """save_all=True writes an animated JXL through AnimatedEncoder (bytes
    as the JAX plugin's AnimatedEncoder writes them); reopening exposes
    n_frames / seek / per-frame durations and the loop count."""
    from PIL import Image
    from jxl_coder_tpu.animation import AnimatedEncoder
    frames = [Image.fromarray(np.full((16, 20, 3), v, np.uint8))
              for v in (10, 120, 230)]
    buf = io.BytesIO()
    frames[0].save(buf, format="JXL", save_all=True,
                   append_images=frames[1:], duration=[40, 50, 60], loop=2)
    ref = AnimatedEncoder(20, 16, num_loops=2)
    for f, d in zip(frames, (40, 50, 60)):
        ref.add_frame(np.asarray(f), d)
    assert buf.getvalue() == ref.encode()
    im = Image.open(io.BytesIO(buf.getvalue()))
    assert im.format == "JXL"
    assert im.n_frames == 3 and im.is_animated
    assert im.info.get("loop") == 2
    durs, vals = [], []
    for i in range(im.n_frames):
        im.seek(i)
        durs.append(im.info["duration"])
        vals.append(np.asarray(im)[0, 0, 0])
    assert durs == [40, 50, 60]
    assert vals == [10, 120, 230]
    assert im.tell() == 2
    with pytest.raises(EOFError):
        im.seek(3)


def test_pil_plugin_keeps_its_device():
    """register(device) is what open / load / save use: a CUDA device
    without a card raises on load, not on import."""
    from PIL import Image
    from jxl_coder_tpu_torch.integrations import pil_plugin
    with _pil_registry():
        pil_plugin.register("cuda")
        im = Image.open(io.BytesIO(F.modular_still(F.bench_frame(8, 8))))
        assert im.size == (8, 8)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            im.load()
