"""The host codec the port is checked against.

The port decodes on a device and has no encoder and no float64
reconstruction of its own.  Streams to decode, the float64 host decode
to hold its pixels against, and the per-strategy transform tables of
seeded test families come from the JAX package's host layers (numpy and
C++; none of them imports JAX).  ``api.decode`` never calls this module.
"""

from __future__ import annotations

import os

import numpy as np

from jxl_coder_tpu import api as _host_api
from jxl_coder_tpu.vardct.enc_real import encode_vardct_real as encode_vardct
from jxl_coder_tpu.vardct.strategies import STRATEGIES
from jxl_coder_tpu.vardct.synthesis import dequant_table, response_matrix
from jxl_coder_tpu.vardct.tpu_full import _PAD_SENTINEL as PAD_SENTINEL

__all__ = ["encode_vardct", "decode_float64", "STRATEGIES", "dequant_table",
           "response_matrix", "PAD_SENTINEL"]


def decode_float64(data: bytes) -> np.ndarray:
    """Pixels of jxl_coder_tpu.api.decode on its float64 host path
    (JXL_TPU_DEVICE=0 for the call; the variable is restored after)."""
    old = os.environ.get("JXL_TPU_DEVICE")
    os.environ["JXL_TPU_DEVICE"] = "0"
    try:
        return _host_api.decode(data)[0]
    finally:
        if old is None:
            del os.environ["JXL_TPU_DEVICE"]
        else:
            os.environ["JXL_TPU_DEVICE"] = old
