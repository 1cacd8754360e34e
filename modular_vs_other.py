"""Time the unsqueeze kernel (csrc/modular.cu) against other trees'
modular.cu on one CUDA card, in turns.

    python3 modular_vs_other.py OTHER_CSRC [OTHER_CSRC ...]

Each OTHER_CSRC is another tree's jxl_coder_tpu_torch/csrc, for a commit:

    mkdir -p build/parent
    git archive <commit> jxl_coder_tpu_torch/csrc | tar -x -C build/parent
    python3 modular_vs_other.py build/parent/jxl_coder_tpu_torch/csrc

It builds each other modular.cu with this tree's nvcc flags into build/
and times jxl_unsqueeze on chip_smoke.py's 4K planes (the first
horizontal and the first vertical squeeze of a 3840x2160 plane) by
replaying a CUDA graph of 50 calls, each build's in the order other(s),
this, this, other(s) reversed.  Every build's output is checked equal to
this tree's first.  The other builds must export jxl_unsqueeze with this
tree's arguments.  Each line carries the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs
from jxl_coder_tpu_torch import _build
from jxl_coder_tpu_torch.host.modular import transform as MT
from jxl_coder_tpu_torch.modular import device as MDEV


def main() -> int:
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("modular_vs_other: torch sees no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = cs.smi()
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    this = MDEV._kernels()
    builds = []
    for n, arg in enumerate(sys.argv[1:]):
        src = Path(arg).resolve()
        so = _build.BUILD_DIR / f"libmodular-other{n}.so"
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(src),
                        "-o", str(so), str(src / "modular.cu")],
                       check=True, capture_output=True)
        fn = _build.bind(ctypes.CDLL(str(so)), "jxl_unsqueeze",
                         this[0].argtypes[:-1])
        builds.append((arg, (fn,) + this[1:]))
    order = builds + [("this", this)] * 2 + builds[::-1]

    plane = cs.bench_frame(2160, 3840)[..., 1].astype(np.int64) * 37 - 4000
    try:
        for horizontal in (True, False):
            x = plane if horizontal else plane.T
            avg, res = MT._squeeze_1d(x)
            if not horizontal:
                avg, res = avg.T, res.T
            a, r = (torch.from_numpy(np.ascontiguousarray(v, np.int32)).to(dev)
                    for v in (avg, res))
            MDEV._kernels = lambda: this
            want = MDEV.unsqueeze(a, r, horizontal)
            for tag, kernels in order:
                MDEV._kernels = lambda k=kernels: k
                if not torch.equal(MDEV.unsqueeze(a, r, horizontal), want):
                    raise AssertionError(f"{tag}: unsqueeze differs from "
                                         f"this tree's")
                ms = cs.graph_ms(lambda: MDEV.unsqueeze(a, r, horizontal))
                print(f"unsqueeze at 4k {'horizontal' if horizontal else 'vertical'}"
                      f", {tag} tree's modular.cu: graph {ms:.4f} ms "
                      f"[{card}]", flush=True)
    finally:
        MDEV._kernels = lambda: this
    return 0


if __name__ == "__main__":
    sys.exit(main())
