"""PyTorch + CUDA port of the jxl_coder_tpu VarDCT still decode.

The host layers (container, headers, entropy decode, family packing)
are imported from ``jxl_coder_tpu``; the device half (synthesis, the
gaborish/EPF filter chain and the XYB -> sRGB output) runs as
hand-written CUDA kernels for Hopper (``csrc/``), each with a plain
PyTorch twin that the CPU path and the tests use.  Entry point:
``jxl_coder_tpu_torch.api.decode(data, device="cuda")``.
"""

from ._device import resolve_device

__all__ = ["resolve_device"]
