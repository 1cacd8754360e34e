"""The round-1 encoder's float32 arithmetic (``fp``) and sRGB transfer
functions (``color``)."""

from .. import _device  # noqa: F401  (full float32, no TF32)
