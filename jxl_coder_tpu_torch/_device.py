"""Device resolution for the PyTorch port.

Every public entry point takes an explicit ``device``; nothing here
keeps a global default.  A CUDA request on a host without a card raises
instead of quietly running on the CPU.
"""

from __future__ import annotations

import torch

# The decode contract is <= 1 output code against the float64 host
# decoder.  TF32 keeps ~3 decimal digits in matmuls and convolutions,
# which breaks it, so the port pins full float32 everywhere.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device) -> torch.device:
    """The torch.device the caller named ("cpu", "cuda", "cuda:1", or a
    torch.device).  Raises RuntimeError for a CUDA device that is not
    present."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but torch sees no CUDA device")
        if dev.index is not None and dev.index >= torch.cuda.device_count():
            raise RuntimeError(
                f"device {device!r} requested but only "
                f"{torch.cuda.device_count()} CUDA device(s) are present")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: use cpu or cuda")
    return dev
