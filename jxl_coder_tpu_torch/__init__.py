"""PyTorch + CUDA port of jxl_coder_tpu's VarDCT and Modular still
decode and encode, its animations, its JPEG recompression, its sampled
decode and pixel ops, its DCT8-only frame path and its round-1 VarDCT
codec.

The port needs nothing of ``jxl_coder_tpu``.  Its host layers
(container, headers, entropy coding, the native host codec, the host
encoder and float64 decoder, the round-1 framing) are its own copies
under ``host/``; the family packing is ``vardct/inputs.py``.  The
device work (synthesis, the gaborish/EPF filters, the XYB -> sRGB
output, the detile of 8x8 tiles, the round-1 encoder front and
reconstruction, the resampling, tone mapping and pixel packing) runs in
PyTorch and in hand-written CUDA kernels for Hopper (``csrc/``), each
with a plain PyTorch twin that the CPU path and the tests use.  Entry
points: ``jxl_coder_tpu_torch.api.decode(data, device="cuda")``,
``decode_batch``, ``decode_sampled``, ``decode_thumbnail``, the JPEG
recompression ``construct`` / ``reconstruct_jpeg`` (host code, exported
here too), the encoders ``api.encode`` (the lossy encoder front on the
device: ``vardct/enc_device.py`` over ``csrc/encode.cu``; lossless Modular
on the host) and ``animation.AnimatedEncoder`` (both exported here),
``jxl_coder_tpu_torch.vardct.dct8.DCT8Frame`` and
``jxl_coder_tpu_torch.codec.encode_vardct_still`` /
``decode_vardct_still``; the probes ``is_jxl`` / ``get_size`` (host code,
exported here too), ``config`` (typed settings over ``api``),
``utils.trace`` (spans, a ``torch.profiler`` trace, JSON logs) and
``integrations.pil_plugin`` (Pillow; the only module that imports PIL).
A Modular still's embedded ICC profile converts to sRGB on the device
(``ops/icc_apply.py``, ``csrc/icc.cu``).

The host layers import without torch; the device packages (and the
entry points) import ``_device``, which pins full float32.
"""

__all__ = ["resolve_device", "construct", "reconstruct_jpeg", "encode",
           "AnimatedEncoder", "is_jxl", "get_size"]


def __getattr__(name):
    if name == "resolve_device":
        from ._device import resolve_device
        return resolve_device
    if name in ("construct", "reconstruct_jpeg", "encode"):
        from . import api
        return getattr(api, name)
    if name in ("is_jxl", "get_size"):
        from .host import api as host_api
        return getattr(host_api, name)
    if name == "AnimatedEncoder":
        from .animation import AnimatedEncoder
        return AnimatedEncoder
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
