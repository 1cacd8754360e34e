"""Minimal Brotli bindings over the system libbrotli shared libraries (the
port's copy of ``jxl_coder_tpu/utils/brotli_ffi.py``).

The JXL container compresses metadata boxes (`brob`) and the jbrd JPEG
reconstruction bundle's marker payloads with Brotli (the reference links
prebuilt libbrotli*.so into libjxl, SURVEY.md §2.5).  Host-side byte
work — nothing TPU about it — so a thin ctypes one-shot API suffices.
"""

from __future__ import annotations

import ctypes
from ctypes import (POINTER, byref, c_int, c_size_t, c_uint8, c_void_p,
                    create_string_buffer)

_dec = None
_enc = None


def _load_dec():
    global _dec
    if _dec is None:
        _dec = ctypes.CDLL("libbrotlidec.so.1")
        _dec.BrotliDecoderDecompress.restype = c_int
        _dec.BrotliDecoderDecompress.argtypes = [
            c_size_t, c_void_p, POINTER(c_size_t), c_void_p]
    return _dec


def _load_enc():
    global _enc
    if _enc is None:
        _enc = ctypes.CDLL("libbrotlienc.so.1")
        _enc.BrotliEncoderCompress.restype = c_int
        _enc.BrotliEncoderCompress.argtypes = [
            c_int, c_int, c_int, c_size_t, c_void_p,
            POINTER(c_size_t), c_void_p]
        _enc.BrotliEncoderMaxCompressedSize.restype = c_size_t
        _enc.BrotliEncoderMaxCompressedSize.argtypes = [c_size_t]
    return _enc


def decompress(data: bytes, max_output: int = 1 << 28) -> bytes:
    """One-shot Brotli decompress (BROTLI_DECODER_RESULT_SUCCESS only)."""
    lib = _load_dec()
    cap = max(4096, min(max_output, max(len(data) * 8, 1 << 16)))
    while True:
        out = create_string_buffer(cap)
        out_len = c_size_t(cap)
        src = create_string_buffer(data, len(data)) if data else None
        rc = lib.BrotliDecoderDecompress(len(data), src, byref(out_len),
                                         out)
        if rc == 1:  # BROTLI_DECODER_RESULT_SUCCESS
            return out.raw[:out_len.value]
        if cap >= max_output:
            raise ValueError("brotli decompress failed (rc=%d)" % rc)
        cap = min(cap * 4, max_output)


def compress(data: bytes, quality: int = 11, lgwin: int = 22) -> bytes:
    """One-shot Brotli compress."""
    lib = _load_enc()
    cap = int(lib.BrotliEncoderMaxCompressedSize(len(data))) or 64
    out = create_string_buffer(cap)
    out_len = c_size_t(cap)
    src = create_string_buffer(data, len(data)) if data else None
    rc = lib.BrotliEncoderCompress(quality, lgwin, 0, len(data), src,
                                   byref(out_len), out)
    if rc != 1:
        raise ValueError("brotli compress failed")
    return out.raw[:out_len.value]
