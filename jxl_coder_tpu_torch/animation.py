"""Animated JPEG XL on the device: random access, playback and a batch.

The counterpart of ``jxl_coder_tpu/animation.py``: ``AnimatedImage``,
``decode_frames_batch``, ``iter_frames``, ``FrameStore``,
``AnimatedStore`` and ``AnimationPlayer``, and the encoder side,
``AnimatedEncoder`` (lossless Modular or lossy VarDCT frames, the lossy
encoder front on the device) with ``gif_to_jxl`` / ``apng_to_jxl`` (PIL
decodes the source on the host).

``AnimatedImage(data, device="cuda", entropy="host")`` indexes the
frames by walking their headers and TOCs only (every frame: LF and
reference-only frames too).  ``get_frame(i)`` decodes a full-canvas
REPLACE frame from its own sections alone; any other frame composes from
a resumable cursor, as the reference's does, which keeps its state on the
device: the reference slots, the LF frames' planes, the reference frames'
XYB planes and the last canvas.  Each frame's host half (parse, or the
Modular channels) runs on the host, its reconstruction and composition
(A10, ``ops/compose.py``) on the device, and the frame handed to the
caller is one download.  Frame access holds a mutex, the cursor's device
work runs on a CUDA stream of the image's own, and every device
operation of a call is complete before the mutex is released: a player
thread and a caller, each on its own stream, may share the image.

``decode_frames_batch`` reconstructs round-1 payload frames (the round-1
codec's, ``codec.py``) as one batch: each frame's entropy decode on the
host, the dequantisation and inverse transform in plain torch, then the
filters and sRGB output of all the frames in one launch of kernel 6 with
a frame axis (``vardct/fused_filters.legacy_filters_batch``).  As the
reference it filters every frame with frame 0's distance, epf_iters and
gaborish (ROADMAP R10), and needs frames of one size; with a mesh the
frames split over its ranks (``parallel/groups.py``).  Real-format frames
decode with ``get_frame`` on a pool of threads.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

import numpy as np
import torch

from . import api
from ._device import resolve_device
from .host.api import InvalidJXLError
from .host.bitstream import container as _container
from .host.bitstream.frame_header import (BlendMode, Encoding, FrameHeader,
                                          FrameType, read_frame_header,
                                          read_toc)
from .host.bitstream.headers import AnimationHeader, read_image_header
from .host.bitstream.reader import BitReader, BitstreamError
from .host.vardct.frame import decode_lf_global, is_legacy_vardct_payload
from .ops.resize import rescale_image
from .vardct import fused_filters as FF
from .vardct import pipeline as P
from .vardct.parse import check_entropy


@dataclasses.dataclass
class FrameIndexEntry:
    header: FrameHeader
    toc: object
    header_bit_start: int


@dataclasses.dataclass
class _Cursor(api._Slots):
    """The compose cursor: the composition walk's state on the device
    (api._Slots), the next frame to compose, and the last canvas with its
    index."""
    next: int = 0
    last: Optional[torch.Tensor] = None
    last_idx: int = -1


def _to_host(pixels: torch.Tensor) -> np.ndarray:
    """A frame's one download."""
    return pixels.cpu().numpy()


class AnimatedImage:
    """Random-access animated decoder handle (``animation.py:45-204`` of
    the JAX package), its frames reconstructed and composed on
    `device`."""

    def __init__(self, data: bytes, device="cuda", entropy: str = "host"):
        check_entropy(entropy)
        self.device = resolve_device(device)
        self.entropy = entropy
        self._mutex = threading.Lock()
        self._cursor: Optional[_Cursor] = None
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        try:
            self.codestream = _container.extract_codestream(data).codestream
            br = BitReader(self.codestream)
            self.image_header = read_image_header(br)
            api._check_decode_size(self.image_header)
            # a still is a one-frame animation, as in the reference
            self.animation = (self.image_header.metadata.animation
                              or AnimationHeader())
            self.frames: List[FrameIndexEntry] = []
            pos = br.pos
            while True:
                fbr = BitReader(self.codestream, start_bit=pos)
                fh = read_frame_header(fbr, self.image_header)
                toc = read_toc(fbr, api._toc_count(self.image_header, fh))
                self.frames.append(FrameIndexEntry(fh, toc, pos))
                pos = toc.end_offset * 8
                if fh.is_last or len(self.frames) > 1 << 16:
                    break
        except BitstreamError as e:
            raise InvalidJXLError(str(e)) from e

    @property
    def width(self) -> int:
        return self.image_header.oriented_xsize

    @property
    def height(self) -> int:
        return self.image_header.oriented_ysize

    @property
    def frames_count(self) -> int:
        return len(self.frames)

    @property
    def loops_count(self) -> int:
        return self.animation.num_loops

    def frame_duration_ms(self, i: int) -> int:
        """Duration in ms: int(1000 * duration * tps_denominator /
        tps_numerator), the reference's formula."""
        a = self.animation
        d = self.frames[i].header.duration
        return int(1000 * d * a.tps_denominator / a.tps_numerator)

    def total_duration_ms(self) -> int:
        return sum(self.frame_duration_ms(i)
                   for i in range(self.frames_count))

    def frame_tensor(self, i: int) -> torch.Tensor:
        """Frame i's codes, (H, W, C) on the device, not oriented: a
        full-canvas REPLACE frame (no crop, regular or skip-progressive)
        decodes alone, any other composes from the cursor.  The tensor is
        the caller's own, and complete when this returns."""
        entry = self.frames[i]
        fh = entry.header
        hdr = self.image_header
        full = (fh.blending_info.mode == BlendMode.REPLACE
                and not fh.have_crop
                and fh.frame_type in (FrameType.REGULAR,
                                      FrameType.SKIP_PROGRESSIVE))
        with self._mutex:
            if self._stream is None:
                if full:
                    return self._decode_entry(entry)[:hdr.ysize, :hdr.xsize]
                return self._compose_to(i)
            # the cursor lives on the image's own stream, whichever thread
            # and stream call: its tensors are made, read and freed there
            caller = torch.cuda.current_stream(self.device)
            with torch.cuda.stream(self._stream):
                if full:
                    out = self._decode_entry(entry)[:hdr.ysize, :hdr.xsize]
                else:
                    out = self._compose_to(i)
            self._stream.synchronize()
        if caller != self._stream:
            # the caller frees it on its own stream's time
            out.record_stream(caller)
        return out

    def get_frame(self, i: int, scale_width: int = 0,
                  scale_height: int = 0) -> np.ndarray:
        """Frame i's pixels (H, W, C), as the reference's get_frame: with a
        scale, resized (FIT, Mitchell; S3 on the device) before the one
        download."""
        out = self.frame_tensor(i)
        if scale_width > 0 and scale_height > 0:
            out = rescale_image(out, scale_width, scale_height)
        return _to_host(out)

    def _compose_to(self, target: int) -> torch.Tensor:
        """Compose frames up to `target` from the cursor (restarted when
        the target lies behind it) -> a copy of its canvas."""
        st = self._cursor
        if st is not None and st.last_idx == target:
            return st.last.clone()
        if st is None or st.next > target:
            st = self._cursor = _Cursor()
        canvas = st.last
        for idx in range(st.next, target + 1):
            out = api._compose_step(self.codestream, self.image_header,
                                    self.frames[idx].header,
                                    self.frames[idx].toc, self.device,
                                    self.entropy, st)
            if out is not None:
                canvas = out
        st.next = target + 1
        st.last = canvas
        st.last_idx = target
        if canvas is None:
            raise InvalidJXLError(f"frame {target} is an LF or reference "
                                  f"frame with no canvas before it")
        return canvas.clone()

    def _decode_entry(self, entry: FrameIndexEntry) -> torch.Tensor:
        """A frame decoded from its own sections alone (no LF or reference
        frame before it)."""
        return api._decode_one_frame(self.codestream, self.image_header,
                                     entry.header, entry.toc, self.device,
                                     self.entropy, {}, {})


def decode_frames_batch(img: AnimatedImage, indices=None,
                        mesh=None) -> np.ndarray:
    """Several VarDCT frames -> (N, H, W, C) uint8 (``animation.py:
    355-427`` of the JAX package).  Round-1 payload frames (every one of
    them, by is_legacy_vardct_payload) reconstruct as one batch: the host
    reads each frame's data, plain torch dequantises and inverse-
    transforms it, and one launch of kernel 6 with a frame axis filters
    all of them into sRGB8, with frame 0's distance, epf_iters and
    gaborish for every frame (R10).  With a mesh
    (``parallel.groups.make_mesh``; img on the rank's device) the frames
    split over its ranks, each rank's share read and filtered there as
    one batch, and every rank returns all of them (``all_gather``).
    Other frames decode with get_frame on a pool of 8 threads, the mesh
    unused, as in the JAX package."""
    if indices is None:
        indices = list(range(img.frames_count))
    hdr = img.image_header
    for i in indices:
        if img.frames[i].header.encoding != Encoding.VARDCT:
            raise NotImplementedError("batch decode is for VarDCT frames")
    legacy = all(is_legacy_vardct_payload(hdr, img.frames[i].header,
                                          img.frames[i].toc)
                 for i in indices)
    if not legacy:
        with ThreadPoolExecutor(max_workers=min(8, len(indices))) as ex:
            return np.stack(list(ex.map(img.get_frame, indices)))
    if mesh is None:
        return _to_host(_legacy_batch(img, indices))
    from .parallel.groups import gather_frames
    per = -(-len(indices) // mesh.size)
    mine = indices[mesh.rank * per:(mesh.rank + 1) * per]
    local = _legacy_batch(img, mine, indices[0]) if mine else torch.zeros(
        (0, hdr.ysize, hdr.xsize, 3), dtype=torch.uint8, device=img.device)
    return _to_host(gather_frames(local, len(indices), mesh))


def _legacy_batch(img: AnimatedImage, indices, first=None) -> torch.Tensor:
    """The round-1 branch of decode_frames_batch -> (N, H, W, 3) uint8 on
    the device, filtered with the settings of frame `first` (default
    indices[0])."""
    from .codec import read_vardct_still
    hdr, dev = img.image_header, img.device
    first = indices[0] if first is None else first
    try:
        datas = [read_vardct_still(img.codestream, hdr, img.frames[i].header,
                                   img.frames[i].toc) for i in indices]
        # the distance is LfGlobal's first two bytes
        e = img.frames[first].toc.section(0)
        dist = decode_lf_global(img.codestream[e.offset:e.offset + 2])
    except BitstreamError as e:
        raise InvalidJXLError(str(e)) from e
    if len({d.qf.shape for d in datas}) != 1:
        raise ValueError("decode_frames_batch: round-1 frames of more than "
                         "one size")
    fh = img.frames[first].header
    epf = fh.restoration_filter.epf_iters or 0
    gab = fh.restoration_filter.gab
    planes, qfs = [], []
    for d in datas:
        ac, dc, qf, cfl_x, cfl_b, _ = P.inputs_from_frame_data(d, dev)
        ny, nx = qf.shape
        fx, fb = P.expand_cfl(cfl_x, cfl_b, ny, nx)
        planes.append(P.dequant_idct(ac, dc, qf, fx, fb, dist))
        qfs.append(qf)
    imgs, qf = torch.stack(planes), torch.stack(qfs)
    if epf <= 1:
        out = FF.legacy_filters_batch(imgs, qf, dist, gab, epf == 1)
    else:
        # EPF in several passes: the round-1 pipeline's own chain per frame
        # (the round-1 encoders write epf_iters 0 or 1)
        out = torch.stack([P._filters(im, q, dist, epf, gab, "u8")
                           for im, q in zip(imgs, qf)])
    return out[:, :, :hdr.ysize, :hdr.xsize].permute(0, 2, 3, 1)


def iter_frames(img: AnimatedImage):
    """Playback iterator: yields (pixels, duration_ms)."""
    for i in range(img.frames_count):
        yield img.get_frame(i), img.frame_duration_ms(i)


# ---- playback (``animation.py:438-584`` of the JAX package) --------------

class FrameStore:
    """Abstract frame source for playback: width / height, the frame
    count, each frame's pixels and duration."""

    @property
    def width(self) -> int:
        raise NotImplementedError

    @property
    def height(self) -> int:
        raise NotImplementedError

    @property
    def frames_count(self) -> int:
        raise NotImplementedError

    def get_frame(self, i: int) -> np.ndarray:
        raise NotImplementedError

    def frame_duration_ms(self, i: int) -> int:
        raise NotImplementedError


class AnimatedStore(FrameStore):
    """An AnimatedImage at a display size: FIT (or FILL) of the target
    keeping the aspect ratio; each frame resized on the device."""

    def __init__(self, image: AnimatedImage, target_width: int = 0,
                 target_height: int = 0, fill: bool = False):
        self._image = image
        self.device = image.device
        w, h = image.width, image.height
        if target_width > 0 and target_height > 0:
            sx = target_width / w
            sy = target_height / h
            f = max(sx, sy) if fill else min(sx, sy)
            self._w = max(1, int(round(w * f)))
            self._h = max(1, int(round(h * f)))
        else:
            self._w, self._h = w, h

    @property
    def width(self) -> int:
        return self._w

    @property
    def height(self) -> int:
        return self._h

    @property
    def frames_count(self) -> int:
        return self._image.frames_count

    def get_frame(self, i: int) -> np.ndarray:
        return self._image.get_frame(
            i, self._w if self._w != self._image.width else 0,
            self._h if self._h != self._image.height else 0)

    def frame_duration_ms(self, i: int) -> int:
        return self._image.frame_duration_ms(i)


class AnimationPlayer:
    """Decode-ahead playback: a worker thread prefetches `preheat` frames
    ahead of the playhead while current() / advance() serve decoded frames
    from a cache.  The worker does its device work on a CUDA stream of its
    own (for a store on a card) and synchronises it before a frame enters
    the cache."""

    def __init__(self, store: FrameStore, preheat: int = 6):
        self._store = store
        self._preheat = max(1, preheat)
        self._cache = {}
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._pos = 0
        self._want = 0
        self._stop = False
        dev = getattr(store, "device", None)
        self._stream = (torch.cuda.Stream(dev) if dev is not None
                        and dev.type == "cuda" else None)
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()
        self._request(0)

    def _decode(self, i: int) -> np.ndarray:
        if self._stream is None:
            return self._store.get_frame(i)
        with torch.cuda.stream(self._stream):
            frame = self._store.get_frame(i)
        self._stream.synchronize()
        return frame

    def _worker(self):
        while True:
            with self._cv:
                while not self._stop:
                    n = self._store.frames_count
                    missing = [k % n for k in range(self._want,
                                                    self._want
                                                    + self._preheat)
                               if (k % n) not in self._cache]
                    if missing:
                        target = missing[0]
                        break
                    self._cv.wait()
                if self._stop:
                    return
            frame = self._decode(target)
            with self._cv:
                self._cache[target] = frame
                # evict frames far behind the playhead
                n = self._store.frames_count
                keep = {k % n for k in range(self._pos - 1,
                                             self._pos + self._preheat + 1)}
                for k in list(self._cache):
                    if k not in keep:
                        del self._cache[k]
                self._cv.notify_all()

    def _request(self, pos: int):
        with self._cv:
            self._pos = pos
            self._want = pos
            self._cv.notify_all()

    def current(self, timeout: float = 30.0):
        """Pixels of the frame at the playhead (blocking until decoded)."""
        deadline = time.monotonic() + timeout
        i = self._pos % self._store.frames_count
        with self._cv:
            while i not in self._cache:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError("frame decode timed out")
                self._cv.wait(remaining)
            return self._cache[i]

    def current_duration_ms(self) -> int:
        return self._store.frame_duration_ms(
            self._pos % self._store.frames_count)

    def advance(self):
        self._request(self._pos + 1)

    def close(self):
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        self._thread.join(timeout=5)


# --------------------------------------------------------------------------
# The encoder (jxl_coder_tpu/animation.py:206-353)

def image_header(width: int, height: int, nch: int, bits: int = 8,
                 lossless: bool = True, num_loops: int = 0):
    """AnimatedEncoder's image header: ticks of 1 ms (tps 1000/1), grey for
    one channel on the lossless path, a fourth channel as an alpha extra
    channel at the colour's depth."""
    from .host.bitstream.headers import (BitDepth, ColourEncoding,
                                         ColourSpace, ExtraChannelInfo,
                                         ExtraChannelType, ImageHeader,
                                         ImageMetadata, SizeHeader)
    m = ImageMetadata()
    m.bit_depth = BitDepth(False, bits, 0)
    m.animation = AnimationHeader(tps_numerator=1000, tps_denominator=1,
                                  num_loops=num_loops)
    if lossless:
        m.xyb_encoded = False
        ce = ColourEncoding()
        if nch == 1:
            ce.colour_space = ColourSpace.GREY
        m.colour_encoding = ce
    if nch == 4:
        ec = ExtraChannelInfo(type=ExtraChannelType.ALPHA)
        ec.bit_depth = BitDepth(False, bits, 0)
        m.extra_channels = [ec]
    return ImageHeader(size=SizeHeader(xsize=width, ysize=height),
                       metadata=m)


def frame_header(hdr, duration: int = 0, is_last: bool = False
                 ) -> FrameHeader:
    """A frame header with the image's extra channels' defaults."""
    from .host.bitstream.frame_header import BlendingInfo
    n_ec = len(hdr.metadata.extra_channels)
    fh = FrameHeader()
    fh.duration = int(duration)
    fh.is_last = is_last
    fh.ec_upsampling = [1] * n_ec
    fh.ec_blending_info = [BlendingInfo() for _ in range(n_ec)]
    return fh


def encode_frame_into(bw, hdr, fh, pixels: np.ndarray, lossless: bool,
                      quality: int = 90, ec_distance: float = 0.0,
                      device="cuda") -> None:
    """One AnimatedEncoder frame into bw: lossless, Modular at groups of
    1024 (shift 3), no filters, RCT on three or more channels; lossy,
    real-format VarDCT with epf_iters 1 at the distance of `quality`
    (``codec.encode_vardct_frame_into``: the encoder front on `device`),
    a fourth channel as a lossless alpha
    pre-quantised with a step of ~2 * ec_distance at 8 bits when
    ec_distance > 0."""
    from . import codec
    from .host.codec import encode_modular_frame
    from .host.vardct.quant import quality_to_distance
    nch = pixels.shape[2]
    bits = hdr.metadata.bit_depth.bits_per_sample
    if lossless:
        fh.encoding = Encoding.MODULAR
        fh.group_size_shift = 3
        fh.restoration_filter.epf_iters = 0
        fh.restoration_filter.gab = False
        encode_modular_frame(bw, hdr, fh,
                             [pixels[:, :, i].astype(np.int32)
                              for i in range(nch)], use_ycocg=nch >= 3)
        return
    fh.encoding = Encoding.VARDCT
    fh.restoration_filter.epf_iters = 1
    alpha = None
    if nch == 4:
        alpha = pixels[:, :, 3].astype(np.int64)
        if ec_distance > 0:
            step = max(1, int(round(ec_distance * 2.0
                                    * ((1 << bits) - 1) / 255.0)))
            alpha = np.clip((alpha + step // 2) // step * step, 0,
                            (1 << bits) - 1)
    codec.encode_vardct_frame_into(bw, hdr, fh, pixels[:, :, :3],
                                   quality_to_distance(quality), alpha=alpha,
                                   device=device)


class AnimatedEncoder:
    """Streaming animated encoder: add_frame(pixels, ms) then encode()
    (``jxl_coder_tpu/animation.py:206-311``); a lossy frame's encoder front
    runs on `device`."""

    def __init__(self, width: int, height: int, num_loops: int = 0,
                 lossless: bool = True, quality: int = 90,
                 effort: int = 7, ec_distance: float = 0.0,
                 device="cuda"):
        """ec_distance: the alpha's distance on lossy frames (0 keeps it
        lossless; > 0 pre-quantises it, step ~ 2 * distance at 8 bits).
        effort is kept for the reference's signature and, as there,
        unused."""
        self.width = width
        self.height = height
        self.num_loops = num_loops
        self.lossless = lossless
        self.quality = quality
        self.effort = effort
        self.ec_distance = float(ec_distance)
        self.device = resolve_device(device)
        self._frames: List = []
        self._closed = False

    def add_frame(self, pixels: np.ndarray, duration_ms: int) -> None:
        if self._closed:
            raise RuntimeError("encoder already closed")
        pixels = np.asarray(pixels)
        if pixels.ndim == 2:
            pixels = pixels[:, :, None]
        if pixels.shape[:2] != (self.height, self.width):
            from .host.api import InvalidImageSizeError
            raise InvalidImageSizeError(
                f"frame size {pixels.shape[:2]} != "
                f"({self.height}, {self.width})")
        self._frames.append((pixels, int(duration_ms)))

    def encode(self) -> bytes:
        from .host.bitstream.writer import BitWriter
        from .host.codec import write_image_header
        if not self._frames:
            raise RuntimeError("no frames added")
        self._closed = True
        first = self._frames[0][0]
        hdr = image_header(self.width, self.height, first.shape[2],
                           16 if first.dtype == np.uint16 else 8,
                           self.lossless, self.num_loops)
        bw = BitWriter()
        write_image_header(bw, hdr)
        for idx, (pixels, dur) in enumerate(self._frames):
            fh = frame_header(hdr, dur, idx == len(self._frames) - 1)
            encode_frame_into(bw, hdr, fh, pixels, self.lossless,
                              self.quality, self.ec_distance, self.device)
        bw.zero_pad_to_byte()
        return bw.to_bytes()


def gif_to_jxl(gif_data: bytes, lossless: bool = True, quality: int = 90,
               device="cuda") -> bytes:
    """GIF -> animated JXL (gif2JXL, JXLConventions.cpp:99-171): PIL
    decodes the frames, composited to RGBA."""
    return _pil_animation_to_jxl(gif_data, lossless, quality, device)


def apng_to_jxl(png_data: bytes, lossless: bool = True, quality: int = 90,
                device="cuda") -> bytes:
    """APNG -> animated JXL (apng2JXL, JXLConventions.cpp:200-388): PIL
    handles the acTL / fcTL chunks and the dispose / blend compositing."""
    return _pil_animation_to_jxl(png_data, lossless, quality, device)


def _pil_animation_to_jxl(data: bytes, lossless: bool, quality: int,
                          device) -> bytes:
    import io
    try:
        from PIL import Image, ImageSequence
    except ImportError as e:
        raise ImportError("gif_to_jxl / apng_to_jxl need PIL (Pillow) to "
                          "decode the source animation") from e
    im = Image.open(io.BytesIO(data))
    frames = []
    durations = []
    for frame in ImageSequence.Iterator(im):
        frames.append(np.asarray(frame.convert("RGBA")))
        durations.append(int(frame.info.get("duration", 100)))
    if not frames:
        raise ValueError("no frames in animation")
    loops = im.info.get("loop", 0)
    h, w = frames[0].shape[:2]
    enc = AnimatedEncoder(w, h, num_loops=loops, lossless=lossless,
                          quality=quality, device=device)
    for f, d in zip(frames, durations):
        enc.add_frame(f, d)
    return enc.encode()
