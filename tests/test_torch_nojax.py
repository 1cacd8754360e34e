"""The port stands without JAX and without the JAX package, and never
runs a CUDA request on the CPU.

The machine with the card has no jax installed, so jxl_coder_tpu_torch
(with its own copies of the host layers, host/) must import, encode and
decode with jax unavailable, and needs nothing of jxl_coder_tpu.
"""

import ast
import os
import re
import shutil
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


def test_decode_batch_in_a_process_without_jax(tmp_path):
    """api.decode_batch on the CPU with jax blocked, on a VarDCT and a
    Modular stream: each output equals decode's, and no jax is loaded."""
    from jxl_coder_tpu.vardct.enc_real import encode_vardct_real
    from port_fixtures import bench_frame, modular_still, smooth_frame
    streams = [tmp_path / "vardct.jxl", tmp_path / "modular.jxl"]
    streams[0].write_bytes(encode_vardct_real(smooth_frame(40, 56),
                                              distance=1.0, effort=5))
    streams[1].write_bytes(modular_still(bench_frame(24, 32)))
    code = textwrap.dedent(f"""
        import sys
        sys.modules["jax"] = None        # any `import jax` now fails
        sys.path.insert(0, {str(REPO)!r})
        import numpy as np
        from jxl_coder_tpu_torch import api
        datas = [open(p, "rb").read() for p in {[str(p) for p in streams]!r}]
        outs = api.decode_batch(datas, device="cpu")
        same = [np.array_equal(o, api.decode(d, device="cpu")[0])
                for o, d in zip(outs, datas)]
        assert not any(m == "jax" or m.startswith("jax.")
                       for m, v in sys.modules.items() if v is not None)
        print([o.shape for o in outs], same)
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env, cwd=tmp_path)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip() == "[(40, 56, 3), (24, 32, 3)] [True, True]"


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


# a "file:line" citation of a TPU kernel (chip_smoke's "replaces")
_CITATION = re.compile(r"(jxl_coder_tpu|research)/[\w/]+\.py:\d+")


def _reaches_the_jax_package(path: Path):
    """(line, what) for each place a port source imports jax or
    jxl_coder_tpu, or names a module or a file path inside
    jxl_coder_tpu/ in code (comments and docstrings may cite them, and
    so may a kernel's "file:line" citation)."""
    text = path.read_text()
    if path.suffix != ".py":
        # C++ / CUDA: no include or string path into the JAX package
        return [(i + 1, ln) for i, ln in enumerate(text.splitlines())
                if re.search(r'(#include|")[^"\n]*jxl_coder_tpu/', ln)]
    tree = ast.parse(text)
    docstrings = {id(n.body[0].value) for n in ast.walk(tree)
                  if isinstance(n, (ast.Module, ast.ClassDef,
                                    ast.FunctionDef, ast.AsyncFunctionDef))
                  and n.body and isinstance(n.body[0], ast.Expr)
                  and isinstance(n.body[0].value, ast.Constant)}
    # `sys.modules["jxl_coder_tpu"] = None` blocks the package: allowed
    blocked = {id(n.slice) for n in ast.walk(tree)
               if isinstance(n, ast.Subscript)
               and isinstance(n.ctx, ast.Store)
               and ast.unparse(n.value) == "sys.modules"}
    hits = []
    for n in ast.walk(tree):
        if isinstance(n, ast.Import):
            names = [a.name for a in n.names]
        elif isinstance(n, ast.ImportFrom):
            names = [n.module or ""] if not n.level else []
        elif (isinstance(n, ast.Constant) and isinstance(n.value, str)
              and id(n) not in docstrings and id(n) not in blocked):
            v = n.value
            if (v == "jxl_coder_tpu" or v.startswith("jxl_coder_tpu.")
                    or "jxl_coder_tpu/" in _CITATION.sub("", v)):
                hits.append((n.lineno, v))
            continue
        else:
            continue
        hits += [(n.lineno, m) for m in names
                 if re.match(r"(jax|jxl_coder_tpu)(\.|$)", m)]
    return sorted(hits)


PORT_SOURCES = sorted(
    str(p.relative_to(REPO)) for p in PKG.rglob("*")
    if p.suffix in (".py", ".cu", ".cuh", ".cpp")) + [
        "chip_smoke.py", "encode_entropy_vs_other.py",
        "filters_vs_parent.py", "modular_vs_other.py", "port_fixtures.py"]


@pytest.mark.parametrize("name", PORT_SOURCES)
def test_card_script_reaches_the_jax_package_only_through_the_port(name):
    """No source of the port, nor the card scripts or their fixtures, imports
    jax or jxl_coder_tpu or opens a path beneath jxl_coder_tpu/: the host
    codec they need is the port's own (host/, reference)."""
    assert _reaches_the_jax_package(REPO / name) == []


def test_the_scan_sees_imports_and_paths(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text(textwrap.dedent('''
        """Docstring citing jxl_coder_tpu/vardct/tpu_real.py is fine."""
        import jxl_coder_tpu.api
        from jxl_coder_tpu.vardct import dec_real
        import importlib
        m = importlib.import_module("jxl_coder_tpu.codec")
        p = os.path.join(ROOT, "jxl_coder_tpu", "vardct", "calib.npz")
        q = open("jxl_coder_tpu/native/hostcodec.cpp")
        ok = dict(replaces="jxl_coder_tpu/vardct/synth_pallas.py:129")
        sys.modules["jxl_coder_tpu"] = None
        from jxl_coder_tpu_torch import api
        import jax.numpy
    '''))
    assert [ln for ln, _ in _reaches_the_jax_package(bad)] == [
        3, 4, 6, 7, 8, 12]


def test_port_runs_in_a_directory_without_the_jax_package(tmp_path):
    """The port and its fixtures copied where no jxl_coder_tpu exists,
    jax blocked: the host encoder copy writes a real-format stream,
    api.decode reads it on the CPU, and the round-1 codec round-trips."""
    shutil.copytree(PKG, tmp_path / "jxl_coder_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "port_fixtures.py", tmp_path)
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None        # any `import jax` now fails
        sys.modules["jxl_coder_tpu"] = None
        import numpy as np
        from jxl_coder_tpu_torch import api, codec, reference
        from port_fixtures import smooth_frame
        img = smooth_frame(40, 56)
        data = reference.encode_vardct(img, distance=1.0, effort=5)
        out, info = api.decode(data, device="cpu")
        host = reference.decode_float64(data)
        d8 = int(np.abs(out.astype(int) - host.astype(int)).max())
        legacy = codec.decode_vardct_still(
            *api._read_frame(codec.encode_vardct_still(img, 1.0,
                                                       device="cpu")),
            device="cpu")
        dl = int(np.abs(legacy.astype(int) - img.astype(int)).max())
        assert not any(m.split(".")[0] in ("jax", "jxl_coder_tpu")
                       for m, v in sys.modules.items() if v is not None)
        print(out.shape, info.xsize, d8 <= 1, legacy.shape, dl < 40)
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env, cwd=tmp_path)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.split() == ["(40,", "56,", "3)", "56", "True",
                                  "(40,", "56,", "3)", "True"]
    # the host codec was built beside the copy, from the copy
    assert list((tmp_path / "build" / "jxl_coder_tpu_torch").glob(
        "libhostcodec-*.so"))


def test_encoders_without_the_jax_package(tmp_path):
    """The port copied where no jxl_coder_tpu exists, jax blocked: a lossy
    api.encode on the CPU route (the encoder front's twins), a lossless
    one and an AnimatedEncoder stream, each decoded by api.decode."""
    shutil.copytree(PKG, tmp_path / "jxl_coder_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "port_fixtures.py", tmp_path)
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None        # any `import jax` now fails
        sys.modules["jxl_coder_tpu"] = None
        import numpy as np
        from jxl_coder_tpu_torch import animation, api
        from port_fixtures import smooth_frame
        img = smooth_frame(40, 56)
        lossy = api.encode(img, lossless=False, quality=90, device="cpu")
        out, _ = api.decode(lossy, device="cpu")
        err = float(np.abs(out.astype(int) - img.astype(int)).mean())
        lossless = api.encode(img, lossless=True, effort=3, device="cpu")
        same = np.array_equal(api.decode(lossless, device="cpu")[0], img)
        enc = animation.AnimatedEncoder(56, 40, lossless=False,
                                        device="cpu")
        for k in range(2):
            enc.add_frame(np.roll(img, 4 * k, 1), 50)
        frames, _, _ = api.decode_frames(enc.encode(), device="cpu")
        assert not any(m.split(".")[0] in ("jax", "jxl_coder_tpu")
                       for m, v in sys.modules.items() if v is not None)
        print(out.shape, err < 4, same, len(frames))
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env, cwd=tmp_path)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.split() == ["(40,", "56,", "3)", "True", "True", "2"]


def test_patched_and_lf_streams_without_the_jax_package(tmp_path):
    """The same copy, jax and jxl_coder_tpu blocked: the host encoder's
    effort-7 patch path (host/vardct/enc_patches.py, the atlas frame, the
    dictionary) writes text as two frames, port_fixtures splices splines
    and an LF frame into a stream, and api.decode / decode_batch read all
    three on the CPU within one code of the float64 host decoder
    (host/vardct/patches.py, splines.py, the frame walk)."""
    shutil.copytree(PKG, tmp_path / "jxl_coder_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "port_fixtures.py", tmp_path)
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None        # any `import jax` now fails
        sys.modules["jxl_coder_tpu"] = None
        import numpy as np
        from jxl_coder_tpu_torch import api, reference
        import port_fixtures as F
        text = reference.encode_vardct(F.text_frame(192, 256), distance=1.0,
                                       effort=7)
        base = reference.encode_vardct(F.bench_frame(40, 64), distance=1.0,
                                       effort=7)
        datas = [text, F.with_splines(base, F.seeded_splines(40, 64, 2)),
                 F.with_lf_frame(base)]
        outs = api.decode_batch(datas, device="cpu")
        worst = []
        for out, data in zip(outs, datas):
            assert np.array_equal(out, api.decode(data, device="cpu")[0])
            host = reference.decode_float64(data)
            worst.append(int(np.abs(out.astype(int) - host.astype(int)).max()))
        assert not any(m.split(".")[0] in ("jax", "jxl_coder_tpu")
                       for m, v in sys.modules.items() if v is not None)
        print(len(api._read_frames(text)[2]), worst)
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env, cwd=tmp_path)
    assert res.returncode == 0, res.stderr[-3000:]
    frames, worst = res.stdout.split(maxsplit=1)
    assert frames == "2" and max(eval(worst)) <= 1, res.stdout


def test_sampled_decode_without_the_jax_package(tmp_path):
    """The same copy, jax and jxl_coder_tpu blocked: decode_thumbnail (the
    DC image), _decode_downsampled (the down pool) and decode_sampled (the
    rescale, the PQ tone map and the packers) on the CPU, the thumbnail
    equal to the float64 host thumbnail."""
    shutil.copytree(PKG, tmp_path / "jxl_coder_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "port_fixtures.py", tmp_path)
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None        # any `import jax` now fails
        sys.modules["jxl_coder_tpu"] = None
        import numpy as np
        from jxl_coder_tpu_torch import api, reference
        from jxl_coder_tpu_torch.host.bitstream.headers import ColourEncoding
        import port_fixtures as F
        data = reference.encode_vardct(F.smooth_frame(72, 100), distance=1.0,
                                       effort=5)
        ce = ColourEncoding()
        ce.transfer_function, ce.primaries = 16, 9
        pq = reference.encode_vardct(F.smooth_frame(72, 100, dtype=np.uint16),
                                     distance=1.0, effort=5, colour=ce,
                                     intensity_target=1000.0, bit_depth=16)
        thumb, _ = api.decode_thumbnail(data, device="cpu")
        same = np.array_equal(thumb, reference.thumbnail_float64(data))
        quarter, _ = api._decode_downsampled(data, 4, device="cpu")
        shapes = [api.decode_sampled(d, w, h, c, device="cpu")[0].shape
                  for d in (data, pq) for w, h, c in
                  ((13, 9, 2), (25, 18, 4), (60, 40, 5))]
        assert not any(m.split(".")[0] in ("jax", "jxl_coder_tpu")
                       for m, v in sys.modules.items() if v is not None)
        print(thumb.shape, same, quarter.shape, shapes)
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env, cwd=tmp_path)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip() == (
        "(9, 13, 3) True (18, 25, 3) [(9, 13, 4), (18, 25), (40, 56), "
        "(9, 13, 4), (18, 25), (40, 56)]"), res.stdout


def test_animation_and_truncation_without_the_jax_package(tmp_path):
    """The same copy, jax and jxl_coder_tpu blocked: port_fixtures writes a
    sprite animation, a lossy animation and a round-1 one; decode_frames,
    AnimatedImage.get_frame, api.decode and decode_frames_batch read them
    on the CPU (the sprites equal to the host frames composed by A10's
    twin); decode_preview and a stream cut after HF global match their
    float64 oracles."""
    shutil.copytree(PKG, tmp_path / "jxl_coder_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "port_fixtures.py", tmp_path)
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None        # any `import jax` now fails
        sys.modules["jxl_coder_tpu"] = None
        import numpy as np
        from jxl_coder_tpu_torch import animation, api, reference
        import port_fixtures as F
        sprites = F.sprite_animation(32, 40, 12, 14)
        frames, durations, _ = api.decode_frames(sprites, device="cpu")
        ref, ref_durations = reference.frames_float64(sprites)
        equal = durations == ref_durations and all(
            np.array_equal(a, b) for a, b in zip(frames, ref))
        img = animation.AnimatedImage(sprites, "cpu")
        last = api.decode(sprites, device="cpu")[0]
        random = all(np.array_equal(img.get_frame(i), frames[k]) for k, i in
                     ((3, 5), (0, 0), (len(frames) - 1, img.frames_count - 1)))
        lossy = F.animated_stream([F.bench_frame(24, 32)] * 2, False)
        batch = animation.decode_frames_batch(animation.AnimatedImage(
            lossy, "cpu"))
        legacy = F.legacy_animation([F.bench_frame(24, 264)] * 2)
        batch1 = animation.decode_frames_batch(animation.AnimatedImage(
            legacy, "cpu"))
        prog = reference.encode_vardct(F.waves_frame(40, 56), distance=1.0,
                                       effort=5, progressive=True)
        prev = api.decode_preview(prog, device="cpu")[0]
        d_prev = np.abs(prev.astype(int)
                        - reference.preview_float64(prog, 1)).max()
        cs, hdr, fh, toc = api._first_frame(prog)
        s = toc.section(1 + fh.counts(hdr)[1])
        cut = prog[:s.offset + s.size]
        dc = api.decode(cut, device="cpu")[0]
        d_dc = np.abs(dc.astype(int)
                      - reference.dc_upsampled_float64(cut)).max()
        assert not any(m.split(".")[0] in ("jax", "jxl_coder_tpu")
                       for m, v in sys.modules.items() if v is not None)
        print(equal, random, np.array_equal(last, frames[-1]), batch.shape,
              batch1.shape, d_prev <= 1, dc.shape, d_dc <= 1)
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env, cwd=tmp_path)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip() == (
        "True True True (2, 24, 32, 3) (2, 24, 264, 3) True (40, 56, 3) "
        "True"), res.stdout


def test_jpeg_routes_without_the_jax_package(tmp_path):
    """The same copy, jax and jxl_coder_tpu blocked: port_fixtures writes
    baseline JPEGs (4:2:0, 4:4:4, grey), the port's construct recompresses
    them (and the round-1 container's writer one), reconstruct_jpeg gives
    each back byte for byte, and api.decode reads the three routes on the
    CPU equal to their float64 oracles."""
    shutil.copytree(PKG, tmp_path / "jxl_coder_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "port_fixtures.py", tmp_path)
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None        # any `import jax` now fails
        sys.modules["jxl_coder_tpu"] = None
        import numpy as np
        from jxl_coder_tpu_torch import api, reference
        from jxl_coder_tpu_torch.host.jpeg import transcode
        import port_fixtures as F
        img = F.bench_frame(37, 51)
        jpegs = [F.baseline_jpeg(img, 90, 2), F.baseline_jpeg(img, 85, 0),
                 F.baseline_jpeg(img, 80, grey=True)]
        datas = [api.construct(j) for j in jpegs]
        datas.append(transcode.construct(jpegs[0]))
        back = [api.reconstruct_jpeg(d) for d in datas] == jpegs + jpegs[:1]
        same = []
        for k, data in enumerate(datas):
            out = api.decode(data, device="cpu")[0]
            ref = (reference.decode_float64(data) if k in (1, 2)
                   else reference.jpeg_pixels_float64(data))
            same.append(int(np.abs(out.astype(int) - ref).max()))
        assert not any(m.split(".")[0] in ("jax", "jxl_coder_tpu")
                       for m, v in sys.modules.items() if v is not None)
        print(back, max(same) <= 1, out.shape)
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env, cwd=tmp_path)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip() == "True True (37, 51, 3)", res.stdout


def test_icc_config_trace_and_plugin_without_the_jax_package(tmp_path):
    """The same copy, jax and jxl_coder_tpu blocked: the modules of the ICC
    step, config, utils.trace and the Pillow plugin import; is_jxl and
    get_size probe a stream; a Modular still with a Display P3 profile
    decodes on the CPU to the twin's codes; a lossy encode with
    the profile, config.encode, a span and a device trace, and a plugin
    round trip run."""
    shutil.copytree(PKG, tmp_path / "jxl_coder_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "port_fixtures.py", tmp_path)
    code = textwrap.dedent("""
        import io, os, sys
        sys.modules["jax"] = None        # any `import jax` now fails
        sys.modules["jxl_coder_tpu"] = None
        import numpy as np
        import torch
        from PIL import Image
        from jxl_coder_tpu_torch import api, config
        from jxl_coder_tpu_torch.host.ops import icc as HICC
        from jxl_coder_tpu_torch.integrations import pil_plugin
        from jxl_coder_tpu_torch.ops import icc_apply
        from jxl_coder_tpu_torch.utils import trace
        import port_fixtures as F
        img = F.bench_frame(20, 28)
        p3 = F.icc_profile("p3", F.SRGB_PARA, 4)
        data = F.modular_still(img, icc=p3)
        out, _ = api.decode(data, device="cpu")
        tab = icc_apply.tables_on(HICC.plan(p3), "cpu")
        same = np.array_equal(out, icc_apply.transform_plain(
            torch.from_numpy(img), tab).numpy())
        lossy = api.encode(img, lossless=False, icc=p3, device="cpu")
        cfg = config.encode(img, device="cpu", quality=80)
        trace.enable(True)
        with trace.span("decode"):
            api.decode(lossy, device="cpu")
        trace.enable(False)
        with trace.device_trace(os.path.join(os.getcwd(), "t")):
            api.decode(cfg, device="cpu")
        pil_plugin.register("cpu")
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, format="JXL")
        back = np.asarray(Image.open(io.BytesIO(buf.getvalue())))
        assert not any(m.split(".")[0] in ("jax", "jxl_coder_tpu")
                       for m, v in sys.modules.items() if v is not None)
        print(api.is_jxl(data), api.get_size(data), same,
              api.get_size(lossy), trace.report().splitlines()[1].split()[:2],
              len(os.listdir("t")), np.array_equal(back, img))
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env, cwd=tmp_path)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip() == (
        "True (28, 20) True (28, 20) ['decode', '1'] 1 True"), res.stdout


def test_lookup_table_icc_without_the_jax_package(tmp_path):
    """The same copy, jax and jxl_coder_tpu blocked: host/ops/icc_lut.py
    reads each lookup-table profile of port_fixtures into littlecms's CLUT
    program, and a Modular still with the mAB profile decodes on the CPU
    to the CLUT twin's codes; the mft1 under D2B0 passes through."""
    shutil.copytree(PKG, tmp_path / "jxl_coder_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "port_fixtures.py", tmp_path)
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None        # any `import jax` now fails
        sys.modules["jxl_coder_tpu"] = None
        import numpy as np
        import torch
        from jxl_coder_tpu_torch import api
        from jxl_coder_tpu_torch.host.ops import icc as HICC
        from jxl_coder_tpu_torch.host.ops import icc_lut as HLUT
        from jxl_coder_tpu_torch.ops import icc_apply
        import port_fixtures as F
        luts = F.lut_test_profiles()
        kinds = sorted({type(HICC.plan(p)).__name__ for p in luts.values()})
        img = F.bench_frame(20, 28)
        mab = luts["mab16 xyz v4"]
        out, _ = api.decode(F.modular_still(img, icc=mab), device="cpu")
        tab = icc_apply.tables_on(HICC.plan(mab), "cpu")
        same = np.array_equal(out, icc_apply.clut_transform_plain(
            torch.from_numpy(img), tab).numpy())
        kept, _ = api.decode(F.modular_still(img, icc=F.mft1_under_d2b0()),
                             device="cpu")
        assert not any(m.split(".")[0] in ("jax", "jxl_coder_tpu")
                       for m, v in sys.modules.items() if v is not None)
        print(kinds, same, np.array_equal(kept, img))
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env, cwd=tmp_path)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip() == "['ClutTransform', 'Transform'] True True", \
        res.stdout


def test_multi_device_dry_run_without_the_jax_package(tmp_path):
    """The port copied where no jxl_coder_tpu exists, jax blocked:
    parallel.dryrun spawns 2 gloo ranks on the CPU (the sharded round-1
    and real-format decodes against the single-device path), then the
    multihost GOP decode and encode run their workers in 1 and 2 spawned
    ranks (multihost.run_ranks, jax blocked there too)."""
    shutil.copytree(PKG, tmp_path / "jxl_coder_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None        # any `import jax` now fails
        sys.modules["jxl_coder_tpu"] = None
        from jxl_coder_tpu_torch.parallel import dryrun

        if __name__ == "__main__":
            dryrun.dryrun_multichip(2, "cpu")
            assert not any(m.split(".")[0] in ("jax", "jxl_coder_tpu")
                           for m, v in sys.modules.items() if v is not None)
            print("clean")
    """)
    (tmp_path / "run.py").write_text(code)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "run.py"], capture_output=True,
                         text=True, timeout=300, env=env, cwd=tmp_path)
    assert res.returncode == 0, (res.stdout + res.stderr)[-3000:]
    lines = res.stdout.splitlines()
    assert lines[0].startswith("dryrun_multichip(2): OK") and \
        "max|diff|=0" in lines[0], res.stdout
    assert lines[1].startswith("multihost_dryrun: GOP decode OK")
    assert lines[2].startswith("multihost_encode_dryrun: GOP encode OK")
    assert lines[-1] == "clean"


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


HOST = PKG / "host"
HOST_MODULES = sorted(
    ".".join(p.relative_to(REPO).with_suffix("").parts)
    for p in HOST.rglob("*.py") if p.name != "__init__.py")


def test_host_layer_imports_no_torch_and_no_device_layer(tmp_path):
    """L1: every module under host/ imports with torch blocked, and none
    of them names the device layers (modular, vardct, entropy) of the
    port: the host layer is numpy and C++."""
    assert HOST_MODULES
    code = textwrap.dedent(f"""
        import importlib, sys
        sys.modules["torch"] = None      # any `import torch` now fails
        sys.modules["jax"] = None
        sys.path.insert(0, {str(REPO)!r})
        for name in {HOST_MODULES!r}:
            importlib.import_module(name)
        loaded = sorted(m for m, v in sys.modules.items()
                        if v is not None and m.startswith(
                            ("jxl_coder_tpu_torch.modular",
                             "jxl_coder_tpu_torch.vardct",
                             "jxl_coder_tpu_torch.entropy")))
        print(len({HOST_MODULES!r}), loaded)
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env, cwd=tmp_path)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.split() == [str(len(HOST_MODULES)), "[]"]
    device = re.compile(r"(^|\.)(modular|vardct|entropy)(\.|$)")
    for path in HOST.rglob("*.py"):
        for n in ast.walk(ast.parse(path.read_text())):
            if isinstance(n, ast.ImportFrom) and n.level >= 2 and \
                    n.level == len(path.relative_to(PKG).parts):
                # a relative import that climbs out of host/
                assert not device.search(n.module or ""), (path, n.module)
            if isinstance(n, ast.ImportFrom) and not n.level:
                assert not (n.module or "").startswith((
                    "jxl_coder_tpu_torch.modular",
                    "jxl_coder_tpu_torch.vardct",
                    "jxl_coder_tpu_torch.entropy")), (path, n.module)
