"""Many stills decoded at once: the pipeline behind ``api.decode_batch``.

The counterpart of ``jxl_coder_tpu.api.decode_batch`` (``api.py:681-771``),
which parses files on a thread pool while the device reconstructs earlier
frames and their pixels come back.  Here:

- a worker pool runs each file's host half (``api.host_half``: the
  container, headers and TOCs, then a VarDCT frame's parse and family
  packing or a Modular frame's channel decode, its LF and reference
  frames' first, in the same worker), at most
  ``WORKERS + IN_FLIGHT`` files ahead of the card.  On entropy="device"
  the parse launches the entropy kernel and reads its status, so each
  worker thread runs under a CUDA stream of its own (a thread's current
  stream is its own, and the status read synchronises only that stream);
  a noisy frame's random planes are built there too (``post.noise_random``,
  once per size);
- the main thread takes the files in input order.  Per file, on one
  compute stream: it waits for the worker's stream, uploads the host
  half's arrays (each staged in the file's pinned buffer and copied with
  ``non_blocking`` on a copy stream that the compute stream waits for),
  and runs the device half (``api.device_half``, the same code as
  ``decode``: the LF and reference frames' device work first, then the
  frame's); then a second copy stream downloads the pixels into a
  pinned buffer, so that file i's download overlaps file i+1's upload and
  compute.  At most IN_FLIGHT files are on the card at once: before
  file i is uploaded, file i - IN_FLIGHT's download is waited for, copied
  out of its pinned buffer and oriented (``apply_orientation``), and its
  buffers go to file i.  Tensors that cross streams are kept for the
  stream that reads them (``Tensor.record_stream``), so that the caching
  allocator does not hand their memory out early.

An animation (whose frames compose) decodes whole on its worker, under
the worker's stream (``api.decode``), and its pixels take the host half's
place.  On the CPU the same workers and order run without streams or
pinned buffers.  Every file's pixels equal ``api.decode(data, device,
entropy)[0]``: the same host and device code runs on the same bytes.

A file that ``decode`` raises on ends the call with the same exception,
its message headed by ``datas[i]``: the files already decoded are
dropped, the workers finish the file they are on and are joined, and the
card's streams are drained before the exception leaves.  Nothing falls
back to another route.

WORKERS and IN_FLIGHT were chosen by measurement on an H100 with an
8-core host (the worker and in-flight sweeps that ``chip_smoke.py`` phase
13 ran before its depth was cut, recorded in ``PERF.md``); the caller does
not choose them.  A JPEG route's host half (``jpeg/pixels.JpegPlanes``)
pipelines as any other (the reference decodes such files one by one
after its batch, ROADMAP R7).
"""

from __future__ import annotations

import contextlib
import os
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import List, Sequence

import numpy as np
import torch

from . import api
from ._device import resolve_device
from .host.api import apply_orientation
from .vardct import post
from .vardct.parse import check_entropy

# host halves at once: all cores, up to the 8 measured (a host half that
# holds the GIL gains little past 2-4, the Modular channel decode's C++
# scales to 8); files on the card at once: 1, 2 and 3 were within the
# calls' spread, 2 overlaps a download with the next file's work
WORKERS = min(8, os.cpu_count() or 1)
IN_FLIGHT = 2
_ALIGN = 256        # bytes: each staged array starts on this boundary


def decode_batch(datas: Sequence[bytes], device="cuda",
                 entropy: str = "host") -> List[np.ndarray]:
    """api.decode_batch: one pixel array per file, in input order."""
    check_entropy(entropy)
    return run(list(datas), resolve_device(device), entropy, WORKERS,
               IN_FLIGHT)


@contextlib.contextmanager
def _naming(i: int):
    """An exception leaving the block gets "datas[i]: " before its
    message (the same exception object and type)."""
    try:
        yield
    except Exception as e:
        if len(e.args) == 1 and isinstance(e.args[0], str):
            e.args = (f"datas[{i}]: {e.args[0]}",)
        else:
            e.args = (f"datas[{i}]",) + e.args
        raise


def run(datas: List[bytes], dev: torch.device, entropy: str, workers: int,
        in_flight: int) -> List[np.ndarray]:
    """The pipeline with `workers` host halves at once and `in_flight`
    files on the card (decode_batch uses WORKERS and IN_FLIGHT)."""
    if len(datas) <= 1:
        out = []
        for i, data in enumerate(datas):
            with _naming(i):
                out.append(api.decode(data, dev, entropy)[0])
        return out
    card = _Card(dev, in_flight) if dev.type == "cuda" else None
    streams = threading.local()

    def host(i: int):
        """File i's host half on a worker; on the card, under the worker's
        own stream, with an event after its work there.  An animation
        (whose frames compose) decodes whole on the worker: its pixels,
        downloaded, take the host half's place."""
        if card is None:
            return _host_half(datas[i], dev, entropy), None
        if not hasattr(streams, "stream"):
            streams.stream = torch.cuda.Stream(dev)
        with torch.cuda.stream(streams.stream):
            h = _host_half(datas[i], dev, entropy)
            return h, streams.stream.record_event()

    results = [None] * len(datas)
    pool = ThreadPoolExecutor(max_workers=min(workers, len(datas)),
                              thread_name_prefix="jxl-batch")
    ahead = deque()
    try:
        for i in range(len(datas)):
            while len(ahead) < min(workers + in_flight, len(datas) - i):
                ahead.append(pool.submit(host, i + len(ahead)))
            if card is not None:
                # file i takes the buffers of file i - in_flight
                for j, pixels in card.done(keep=in_flight - 1):
                    results[j] = pixels
            with _naming(i):
                h, ready = ahead.popleft().result()
                if isinstance(h, np.ndarray):
                    results[i] = h
                    continue
                orientation = api.orientation_of(h)
                if card is None:
                    results[i] = apply_orientation(
                        api.device_half(h, dev).numpy(), orientation)
                else:
                    card.push(i, h, ready, orientation)
        if card is not None:
            for j, pixels in card.done(keep=0):
                results[j] = pixels
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
        if card is not None:
            card.drain()
    return results


def _host_half(data: bytes, dev: torch.device, entropy: str):
    """api.host_half, then a noisy frame's random planes (built once per
    size, here rather than on the main thread), the LF and reference
    frames' before it too; an animation's decoded pixels (api.decode)."""
    if api._animated(data):
        return api.decode(data, dev, entropy)[0]
    h = api.host_half(data, dev, entropy)
    for part in (h,) + tuple(b.host for b in h.before):
        if isinstance(part, api.VarDCTHost) and \
                part.post.noise_lut is not None:
            post.noise_random(part.post.w, part.post.h, dev)
    return h


def _tensors(obj):
    """The tensors inside a host half's tuples, lists and dicts."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensors(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _tensors(v)


class _Pinned:
    """A pinned host buffer reused file after file.  Arrays are carved out
    of it in turn (``take``); one that does not fit gets a pinned buffer
    of its own this time, and the next ``reset`` grows the buffer to the
    whole of the last file's need."""

    def __init__(self):
        self.buf = None
        self.used = 0

    def reset(self) -> None:
        if self.used > (0 if self.buf is None else self.buf.numel()):
            self.buf = torch.empty(self.used, dtype=torch.uint8,
                                   pin_memory=True)
        self.used = 0

    def take(self, shape, dtype: torch.dtype) -> torch.Tensor:
        n = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
        start = -(-self.used // _ALIGN) * _ALIGN
        self.used = start + n
        if self.buf is None or self.used > self.buf.numel():
            return torch.empty(shape, dtype=dtype, pin_memory=True)
        return self.buf[start:start + n].view(dtype).view(shape)


class _Card:
    """The card's side of the pipeline: an upload stream, the compute
    stream, a download stream, and per file in flight a pinned buffer
    each way."""

    def __init__(self, dev: torch.device, in_flight: int):
        self.dev = dev
        self.up = torch.cuda.Stream(dev)
        self.compute = torch.cuda.Stream(dev)
        self.down = torch.cuda.Stream(dev)
        self.slots = [(_Pinned(), _Pinned()) for _ in range(in_flight)]
        self.pending = deque()   # (index, pinned pixels, orientation, event)

    def push(self, i: int, host, ready, orientation: int) -> None:
        """File i: its arrays up, its device half, its pixels down.  The
        caller has finished file i - in_flight (``done``), whose buffers
        this file takes."""
        up, down = self.slots[i % len(self.slots)]
        up.reset()
        down.reset()
        compute = self.compute

        def put(a: np.ndarray) -> torch.Tensor:
            """A contiguous array -> its tensor on the card, staged in
            pinned memory and copied on the upload stream, which the
            current (compute) stream waits for."""
            dtype = torch.from_numpy(np.empty(0, a.dtype)).dtype
            staged = up.take(a.shape, dtype)
            np.copyto(staged.numpy(), a)
            with torch.cuda.stream(self.up):
                t = staged.to(self.dev, non_blocking=True)
                copied = self.up.record_event()
            current = torch.cuda.current_stream(self.dev)
            current.wait_event(copied)
            t.record_stream(current)
            return t

        with torch.cuda.stream(compute):
            compute.wait_event(ready)
            for t in _tensors(host):
                t.record_stream(compute)
            pixels = api.device_half(host, self.dev, put)
            computed = compute.record_event()
        host_px = down.take(pixels.shape, pixels.dtype)
        with torch.cuda.stream(self.down):
            self.down.wait_event(computed)
            host_px.copy_(pixels, non_blocking=True)
            pixels.record_stream(self.down)
            fetched = self.down.record_event()
        self.pending.append((i, host_px, orientation, fetched))

    def done(self, keep: int) -> list:
        """Wait for the downloads of all but the newest `keep` files in
        flight -> [(index, its pixels copied out and oriented)]."""
        out = []
        while len(self.pending) > keep:
            i, host_px, orientation, fetched = self.pending.popleft()
            with _naming(i):
                fetched.synchronize()
                out.append((i, apply_orientation(host_px.numpy().copy(),
                                                 orientation)))
        return out

    def drain(self) -> None:
        """Wait for everything queued on the pipeline's streams, so that no
        copy still reads or writes a pinned buffer when it is freed."""
        for stream in (self.up, self.compute, self.down):
            stream.synchronize()
        self.pending.clear()
