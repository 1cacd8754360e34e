"""Build and load the port's native libraries.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled at first
use with nvcc for Hopper (sm_90a) into ``build/jxl_coder_tpu_torch/``
beside the package, keyed by a hash of its source, then loaded with
ctypes.  The host codec ``host/native/<name>.cpp`` is built the same way
with g++ (``load_host``).  A build failure raises; nothing falls back.
Threads that need one library at once build it once: the first builds
under that library's lock, the others wait and load its result; a second
process building the same library writes its own temporary file, and the
last ``os.replace`` wins with identical bytes.

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
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
HOST_SRC = Path(__file__).resolve().parent / "host" / "native"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / \
    "jxl_coder_tpu_torch"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC",
              # no FMA contraction: elementwise math rounds op by op like
              # the plain PyTorch twins (dot products use explicit fmaf)
              "-fmad=false", "-Xptxas=-v"]
# the JAX package's host build (jxl_coder_tpu/native/__init__.py)
HOST_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-ffp-contract=off",
              "-pthread"]


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


def _library_path(name: str, sources, flags) -> Path:
    h = hashlib.sha256()
    for p in sources:
        h.update(p.read_bytes())
    h.update(" ".join(flags).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def library_path(name: str) -> Path:
    return _library_path(name, _sources(name), NVCC_FLAGS)


# one lock per library path: a build runs once however many threads ask
_LOCKS = {}
_LOCKS_GUARD = threading.Lock()


def _lock(so: Path) -> threading.Lock:
    with _LOCKS_GUARD:
        return _LOCKS.setdefault(so, threading.Lock())


def _compile(so: Path, cmd_without_output, src: Path) -> None:
    """Run the compiler into a temporary file of this process and thread,
    keep its report beside the library, and raise if it fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".tmp{os.getpid()}-{threading.get_ident()}")
    res = subprocess.run([*cmd_without_output, "-o", str(tmp), str(src)],
                         capture_output=True, text=True)
    so.with_suffix(".log").write_text(res.stdout + res.stderr)
    if res.returncode != 0:
        raise RuntimeError(f"{Path(cmd_without_output[0]).name} failed for "
                           f"{src.name} (exit {res.returncode}):\n"
                           f"{res.stderr}")
    os.replace(tmp, so)


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Compile (once per source hash) and load csrc/<name>.cu."""
    so = library_path(name)
    with _lock(so):
        if not so.exists():
            # the log keeps ptxas's register / shared-memory report
            _compile(so, [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC)],
                     CSRC / f"{name}.cu")
    return ctypes.CDLL(str(so))


@functools.lru_cache(maxsize=None)
def load_host(name: str) -> ctypes.CDLL:
    """Compile (once per source hash) and load host/native/<name>.cpp."""
    src = HOST_SRC / f"{name}.cpp"
    so = _library_path(name, [src], HOST_FLAGS)
    with _lock(so):
        if not so.exists():
            gxx = shutil.which("g++")
            if gxx is None:
                raise RuntimeError("g++ not found: the host codec cannot be "
                                   "built")
            _compile(so, [gxx, *HOST_FLAGS], src)
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


def check_aligned(t, name: str) -> None:
    """Raise ValueError unless tensor t starts on a 16-byte boundary, as a
    kernel that reads it in 16-byte loads needs (a contiguous view into
    a larger tensor may start anywhere)."""
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: the kernel reads it in 16-byte loads; "
                         f"expected a 16-byte aligned tensor")
