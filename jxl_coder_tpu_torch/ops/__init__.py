"""The round-1 encoder's float32 arithmetic (``fp``) and sRGB transfer
functions (``color``); the sampled decode's pixel ops: the 8x box of
codes (``sample``), the resample (``resize``), the HDR -> SDR tone map
(``tone``), the packers (``pack``) and the alpha ops (``alpha``)."""

from .. import _device  # noqa: F401  (full float32, no TF32)
