"""The port's device entropy decode (``device``)."""

from .. import _device  # noqa: F401  (full float32, no TF32)
