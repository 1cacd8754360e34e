"""The port's VarDCT device path: synthesis, the filters, the post
stages and the frame reconstruction."""

from .. import _device  # noqa: F401  (full float32, no TF32)
