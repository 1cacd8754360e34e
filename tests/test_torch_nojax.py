"""The port stands without JAX, and never runs a CUDA request on the CPU.

The machine with the card has no jax installed, so jxl_coder_tpu_torch
and the host layers it imports from jxl_coder_tpu must import and
decode with jax unavailable.
"""

import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "jxl_coder_tpu_torch"


def test_decode_in_a_process_without_jax(tmp_path):
    from jxl_coder_tpu.vardct.enc_real import encode_vardct_real
    rng = np.random.default_rng(7)
    yy, xx = np.mgrid[0:72, 0:104]
    img = np.clip(np.stack([120 + 60 * np.sin(yy / 9.0), 100 + xx,
                            (xx + yy) % 200], -1)
                  + rng.normal(0, 4, (72, 104, 3)), 0, 255).astype(np.uint8)
    stream = tmp_path / "frame.jxl"
    stream.write_bytes(encode_vardct_real(img, distance=2.5, effort=5))
    code = textwrap.dedent(f"""
        import sys
        sys.modules["jax"] = None        # any `import jax` now fails
        sys.path.insert(0, {str(REPO)!r})
        from jxl_coder_tpu_torch import api
        out, info = api.decode(open({str(stream)!r}, "rb").read(),
                               device="cpu")
        assert not any(m == "jax" or m.startswith("jax.")
                       for m, v in sys.modules.items() if v is not None)
        print(out.shape, out.dtype, info.xsize, info.ysize)
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env, cwd=tmp_path)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == ["(72,", "104,", "3)", "uint8", "104", "72"]


def test_legacy_codec_in_a_process_without_jax(tmp_path):
    """The round-1 codec (encode and decode) on the CPU with jax blocked;
    its host framing comes from jxl_coder_tpu.vardct.frame."""
    code = textwrap.dedent(f"""
        import sys
        sys.modules["jax"] = None        # any `import jax` now fails
        sys.path.insert(0, {str(REPO)!r})
        import numpy as np
        from jxl_coder_tpu_torch import api, codec
        from port_fixtures import smooth_frame
        img = smooth_frame(29, 43)
        data = codec.encode_vardct_still(img, 1.0, device="cpu")
        out = codec.decode_vardct_still(*api._read_frame(data), device="cpu")
        assert not any(m == "jax" or m.startswith("jax.")
                       for m, v in sys.modules.items() if v is not None)
        d = np.abs(out.astype(int) - img.astype(int))
        print(out.shape, out.dtype, int(d.max() < 40))
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env, cwd=tmp_path)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == ["(29,", "43,", "3)", "uint8", "1"]


def test_package_source_imports_no_jax():
    pat = re.compile(r"^\s*(import jax|from jax)", re.M)
    files = sorted(PKG.rglob("*.py"))
    assert files
    hits = [str(p) for p in files if pat.search(p.read_text())]
    assert hits == []


@pytest.mark.parametrize("name", ["chip_smoke.py", "port_fixtures.py"])
def test_card_script_reaches_the_jax_package_only_through_the_port(name):
    """chip_smoke.py and its fixtures import neither jax nor
    jxl_coder_tpu: the host codec they need comes through
    jxl_coder_tpu_torch (api.prepare, reference)."""
    pat = re.compile(r"^\s*(import|from)\s+(jax|jxl_coder_tpu)(?!_torch)\b",
                     re.M)
    assert pat.findall((REPO / name).read_text()) == []


def test_float64_reference_restores_the_device_switch(monkeypatch):
    from jxl_coder_tpu_torch import reference
    from port_fixtures import smooth_frame
    data = reference.encode_vardct(smooth_frame(24, 40), distance=1.0,
                                   effort=3)
    monkeypatch.setenv("JXL_TPU_DEVICE", "1")
    out = reference.decode_float64(data)
    assert out.shape == (24, 40, 3) and out.dtype == np.uint8
    assert os.environ["JXL_TPU_DEVICE"] == "1"


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    """A kernel that cannot be built raises; nothing falls back."""
    from jxl_coder_tpu_torch import _build
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    _build.load.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build.load("synth")
    finally:
        _build.load.cache_clear()


def test_cuda_without_a_card_raises(monkeypatch):
    from jxl_coder_tpu_torch import api, resolve_device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.decode(b"\xff\x0a", device="cuda")
    assert resolve_device("cpu") == torch.device("cpu")
