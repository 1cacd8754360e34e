"""The port's Modular inverse transforms (``device``) and output
(``output``)."""

from .. import _device  # noqa: F401  (full float32, no TF32)
