"""The round-1 VarDCT still codec (``jxl_coder_tpu/codec.py:465-548``),
and ``encode_vardct_frame_into`` (``codec.py:551-568``), one real-format
VarDCT frame into a caller's stream (the animated encoder's lossy frame).

``encode_vardct_still`` and ``decode_vardct_still`` keep the JAX
package's framing and entropy coding, in the port's copies
``host/vardct/frame.py`` and ``host/bitstream`` (numpy); the pixel math
runs on the named device (``vardct.pipeline``), the card unless the
caller passes ``device="cpu"``.  The encoder front rounds as the JAX
package does on the CPU, so on the CPU both write the same bytes.
"""

from __future__ import annotations

import numpy as np
import torch

from ._device import resolve_device
from .host.bitstream.frame_header import Encoding, FrameHeader
from .host.bitstream.headers import (BitDepth, ImageHeader, ImageMetadata,
                                     SizeHeader)
from .host.bitstream.writer import BitWriter
from .host.codec import write_image_header
from .host.vardct import frame as VF
from .ops.color import srgb_to_linear
from .vardct import pipeline as P
from .vardct.xyb import linear_rgb_to_xyb


def quantize_still(pixels: np.ndarray, distance: float, device="cuda"):
    """The encoder's device front: (H, W, 3) uint8/uint16 sRGB -> the
    quantised (AC (3, nY, nX, 8, 8), DC (3, nY, nX), qf (nY, nX)) int32
    tensors on `device`."""
    dev = resolve_device(device)
    h, w, _ = pixels.shape
    maxval = 255.0 if pixels.dtype == np.uint8 else 65535.0
    # pad to the block grid with edge replication
    ph = -(-h // 8) * 8
    pw = -(-w // 8) * 8
    arr = np.asarray(pixels, np.float32) / maxval
    arr = np.pad(arr, ((0, ph - h), (0, pw - w), (0, 0)), mode="edge")
    srgb = torch.from_numpy(np.ascontiguousarray(arr.transpose(2, 0, 1)))
    xyb = linear_rgb_to_xyb(srgb_to_linear(srgb.to(dev)))
    qf = torch.full((ph // 8, pw // 8), 8, dtype=torch.int32, device=dev)
    ac, dc = P.quantize_coeffs(xyb, qf, distance)
    return ac, dc, qf


def encode_vardct_still(pixels: np.ndarray, distance: float,
                        effort: int = 7, decoding_speed: int = 0,
                        device="cuda") -> bytes:
    """uint8/uint16 sRGB (H, W, 3) -> bare JXL codestream (VarDCT).
    effort is accepted for the JAX signature and, as there, unused."""
    h, w, nch = pixels.shape
    if nch != 3:
        raise ValueError("VarDCT path currently encodes RGB")
    dev = resolve_device(device)

    m = ImageMetadata()  # defaults: 8-bit sRGB xyb_encoded
    if pixels.dtype != np.uint8:
        m.bit_depth = BitDepth(False, 16, 0)
    hdr = ImageHeader(size=SizeHeader(xsize=w, ysize=h), metadata=m)
    fh = FrameHeader()
    fh.encoding = Encoding.VARDCT
    fh.x_qm_scale = 2
    # decoding speed 0-4: the faster tiers drop restoration filters
    if decoding_speed >= 4:
        fh.restoration_filter.epf_iters = 0
        fh.restoration_filter.gab = False
    elif decoding_speed >= 2:
        fh.restoration_filter.epf_iters = 0
    else:
        fh.restoration_filter.epf_iters = 1

    ac, dc, qf = quantize_still(pixels, distance, dev)
    ny, nx = qf.shape
    ty, tx = -(-ny // 8), -(-nx // 8)
    data = VF.VarDctFrameData(
        ac=ac.cpu().numpy(), dc=dc.cpu().numpy(), qf=qf.cpu().numpy(),
        cfl_x=np.zeros((ty, tx), np.int32),
        cfl_b=np.full((ty, tx), 64, np.int32),
        distance=float(distance))

    bw = BitWriter()
    write_image_header(bw, hdr)
    VF.encode_vardct_frame(bw, hdr, fh, data)
    bw.zero_pad_to_byte()
    return bw.to_bytes()


def read_vardct_still(cs: bytes, hdr: ImageHeader, fh, toc):
    """The host half of decode_vardct_still: section framing and entropy
    decoding -> host.vardct.frame.VarDctFrameData (numpy)."""
    return VF.decode_vardct_frame(cs, hdr, fh, toc)


def reconstruct_vardct_still(data, hdr: ImageHeader, fh,
                             device="cuda") -> np.ndarray:
    """The device half of decode_vardct_still: VarDctFrameData -> (H, W,
    3) uint8 sRGB, or uint16 above 8 bits per sample."""
    arrays = P.inputs_from_frame_data(data, resolve_device(device))
    epf = fh.restoration_filter.epf_iters or 0
    gab = fh.restoration_filter.gab
    if hdr.metadata.bit_depth.bits_per_sample <= 8:
        out = P.reconstruct_srgb8(*arrays, epf_iters=epf, gab=gab)
    else:
        out = P.reconstruct_u16(*arrays, epf_iters=epf, gab=gab)
    # crop the coded padding
    out = out[:, :hdr.ysize, :hdr.xsize]
    return out.permute(1, 2, 0).cpu().numpy()


def decode_vardct_still(cs: bytes, hdr: ImageHeader, fh, toc,
                        device="cuda") -> np.ndarray:
    """(codestream, header, frame header, toc) of a round-1 stream ->
    (H, W, 3) uint8 sRGB, or uint16 above 8 bits per sample."""
    resolve_device(device)          # an unusable device fails before the parse
    return reconstruct_vardct_still(read_vardct_still(cs, hdr, fh, toc),
                                    hdr, fh, device)


def encode_vardct_frame_into(bw: BitWriter, hdr: ImageHeader, fh,
                             pixels: np.ndarray, distance: float,
                             alpha=None, device="cuda") -> None:
    """Encode one real-format VarDCT frame (header + TOC + sections) into
    bw.  pixels: (H, W, 3) uint8/uint16 sRGB at the frame's size (uint16
    is coded from its top 8 bits, as the reference does); alpha: an
    optional (H, W) int plane at the extra channel's declared depth, coded
    losslessly.  The encoder front runs on `device`."""
    from .host.vardct.enc_real import encode_vardct_real
    from .vardct.enc_device import Front
    if pixels.dtype == np.uint16:
        pixels = (np.asarray(pixels) >> 8).astype(np.uint8)
    encode_vardct_real(pixels, distance=distance, fh=fh, hdr=hdr,
                       into_bw=bw, alpha=alpha,
                       front=Front(device))
