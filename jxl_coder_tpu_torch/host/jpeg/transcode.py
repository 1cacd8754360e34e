"""``is_constructed`` of ``jxl_coder_tpu/jpeg/transcode.py``: the port
has no JPEG route and uses it only to refuse the round-1 private
transcoding container by name.
"""

from __future__ import annotations

from ..bitstream import container as container_mod


def is_constructed(data: bytes) -> bool:
    """True only for the round-1 PRIVATE container (jxcf coefficient
    box); standard recompressed files (jbrd + jxlc codestream) decode
    through the normal path / jpeg.wire."""
    if data[:12] != container_mod.MAGIC_CONTAINER:
        return False
    try:
        for box in container_mod.parse_boxes(data):
            if box.type == b"jxcf":
                return True
            if box.type in (b"jxlc", b"jxlp"):
                return False
    except Exception:
        return False
    return False
