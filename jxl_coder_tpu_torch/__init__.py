"""PyTorch + CUDA port of jxl_coder_tpu's VarDCT still decode and of its
round-1 VarDCT codec.

The host layers (container, headers, entropy coding, family packing,
the round-1 framing) are imported from ``jxl_coder_tpu``; the device
work (synthesis, the gaborish/EPF filters, the XYB -> sRGB output, the
round-1 encoder front and reconstruction) runs in PyTorch and in
hand-written CUDA kernels for Hopper (``csrc/``), each with a plain
PyTorch twin that the CPU path and the tests use.  Entry points:
``jxl_coder_tpu_torch.api.decode(data, device="cuda")`` and
``jxl_coder_tpu_torch.codec.encode_vardct_still`` /
``decode_vardct_still``.
"""

from ._device import resolve_device

__all__ = ["resolve_device"]
