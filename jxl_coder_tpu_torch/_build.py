"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled at first
use with nvcc for Hopper (sm_90a) into ``build/jxl_coder_tpu_torch/``
beside the package, keyed by a hash of its source, then loaded with
ctypes.  A build failure raises; nothing falls back.

Every C entry point takes the CUDA stream as its last argument and
returns ``cudaGetLastError()`` after its launch; ``launch`` turns a
nonzero code into an exception.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / \
    "jxl_coder_tpu_torch"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC",
              # no FMA contraction: elementwise math rounds op by op like
              # the plain PyTorch twins (dot products use explicit fmaf)
              "-fmad=false", "-Xptxas=-v"]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(set CUDA_HOME or put nvcc on PATH)")


def _sources(name: str):
    main = CSRC / f"{name}.cu"
    if not main.exists():
        raise FileNotFoundError(main)
    return [main] + sorted(CSRC.glob("*.cuh"))


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    for p in _sources(name):
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Compile (once per source hash) and load csrc/<name>.cu."""
    so = library_path(name)
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".tmp{os.getpid()}")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        res = subprocess.run(cmd, capture_output=True, text=True)
        # ptxas's register / shared-memory report, kept beside the library
        so.with_suffix(".log").write_text(res.stdout + res.stderr)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu "
                               f"(exit {res.returncode}):\n{res.stderr}")
        os.replace(tmp, so)
    return ctypes.CDLL(str(so))


def bind(lib: ctypes.CDLL, fn: str, argtypes) -> ctypes._CFuncPtr:
    """lib.fn with its argtypes; the stream pointer is appended last."""
    f = getattr(lib, fn)
    f.argtypes = list(argtypes) + [ctypes.c_void_p]
    f.restype = ctypes.c_int
    return f


def launch(fn: ctypes._CFuncPtr, device, *args) -> None:
    """Call a bound entry point on `device`'s current stream and raise if
    it returns a nonzero cudaError_t.  Temporaries the caller frees after
    the (asynchronous) launch are safe: PyTorch's allocator reuses their
    memory only for work queued later on the same stream."""
    import torch
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"CUDA launch of {fn.__name__} failed: cudaError {err}")
