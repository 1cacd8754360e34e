"""Time kernel 2 (csrc/filters.cu) against another tree's filters.cu on one
CUDA card, in turns.

    python3 filters_vs_parent.py OTHER_CSRC

OTHER_CSRC is the other tree's jxl_coder_tpu_torch/csrc, for a commit:

    mkdir -p build/parent
    git archive <commit> jxl_coder_tpu_torch/csrc | tar -x -C build/parent
    python3 filters_vs_parent.py build/parent/jxl_coder_tpu_torch/csrc

It builds the other filters.cu with this tree's nvcc flags into build/,
decodes chip_smoke.py's 4K d1.0 e7 stream (cached in the temp directory
by chip_smoke.py, else encoded here) to the main path's planes, and times
kernel 2 there with the other build's jxl_restore_window and this tree's,
in the order other, this, this, other: by CUDA events around 50 calls (the
main-path method of chip_smoke.py), by replaying a CUDA graph of 50 calls,
and the 4K stage's device-busy time.  The other build must export
jxl_restore_window with this tree's arguments.  Each line carries the
card's name and power limit.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

import chip_smoke as cs
from jxl_coder_tpu_torch import _build
from jxl_coder_tpu_torch.vardct import filters
from jxl_coder_tpu_torch.vardct.frame import VarDCTFrame


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("filters_vs_parent: torch sees no CUDA device", file=sys.stderr)
        return 2
    other_src = Path(sys.argv[1]).resolve()
    dev = torch.device("cuda", 0)
    card = cs.smi()
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = _build.BUILD_DIR / "libfilters-other.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(other_src),
                    "-o", str(so), str(other_src / "filters.cu")],
                   check=True, capture_output=True)
    bound = filters._kernel()
    other = _build.bind(ctypes.CDLL(str(so)), "jxl_restore_window",
                        bound.argtypes[:-1])
    this = bound

    data = cs.stream(cs.bench_frame(2160, 3840), 1.0, 7)
    cfg, inp = cs.prepared(data, dev)
    planes, sigma = cs.synthesized(cfg, inp)
    args = (planes[:, :2160, :3840], sigma, cfg.gab, cfg.epf_iters, cfg.gabw,
            cfg.pass0_scale, cfg.pass2_scale, "u8")
    frame = VarDCTFrame(cfg)
    try:
        for tag, fn in (("other", other), ("this", this), ("this", this),
                        ("other", other)):
            filters._kernel = lambda fn=fn: fn
            ev = cs.device_ms(lambda: filters.restore_and_output(*args))
            gr = cs.graph_ms(lambda: filters.restore_and_output(*args))
            busy = cs.profile_stage(frame, inp)
            print(f"kernel 2 at 4k epf_iters {cfg.epf_iters} u8, {tag} tree's "
                  f"filters.cu: events {ev:.4f} ms, graph {gr:.4f} ms; stage "
                  f"device busy {busy:.3f} ms [{card}]", flush=True)
    finally:
        filters._kernel = lambda: this
    return 0


if __name__ == "__main__":
    sys.exit(main())
