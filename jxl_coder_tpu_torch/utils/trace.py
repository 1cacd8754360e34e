"""Tracing, profiling and structured logging (``jxl_coder_tpu/utils/
trace.py``):

- ``span(name)``: nested stage timers on the host clock, collected into a
  process-wide registry; ``report()`` renders a summary and ``reset()``
  clears it.  Off by default (``enable()``), then a span costs one check.
- ``device_trace(logdir)``: a context manager around ``torch.profiler``
  (CPU activities, and CUDA where a card is present) that writes a Chrome
  trace into `logdir` (Perfetto or chrome://tracing open it).
- ``log``: the port's ``logging.Logger`` ("jxl_coder_tpu_torch");
  ``enable_json_logs()`` switches its handler to one JSON object per line.

A span times what the host waits for: work queued on the card counts
only where the spanned code synchronises (a download does).
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import threading
import time
from collections import defaultdict

log = logging.getLogger("jxl_coder_tpu_torch")

_enabled = False
_lock = threading.Lock()
_stats = defaultdict(lambda: [0, 0.0])  # name -> [calls, total_s]
_local = threading.local()


def enable(on: bool = True) -> None:
    global _enabled
    _enabled = on


def reset() -> None:
    with _lock:
        _stats.clear()


@contextlib.contextmanager
def span(name: str):
    """Time a stage.  Nested spans get dotted names (decode.entropy)."""
    if not _enabled:
        yield
        return
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    full = ".".join(stack + [name])
    stack.append(name)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        stack.pop()
        with _lock:
            s = _stats[full]
            s[0] += 1
            s[1] += dt


def report() -> str:
    with _lock:
        rows = sorted(_stats.items(), key=lambda kv: -kv[1][1])
        lines = [f"{'span':<40} {'calls':>8} {'total s':>10} {'avg ms':>9}"]
        for name, (calls, total) in rows:
            lines.append(f"{name:<40} {calls:>8} {total:>10.3f} "
                         f"{total / calls * 1e3:>9.2f}")
    return "\n".join(lines)


@contextlib.contextmanager
def device_trace(logdir: str):
    """Profile the enclosed region with torch.profiler (CPU, and CUDA when
    a card is present) and write its Chrome trace to
    `logdir`/trace-<pid>-<ns>.json; the profile is the context value."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        logdir, f"trace-{os.getpid()}-{time.time_ns()}.json"))


class _JsonFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        out = {
            "ts": self.formatTime(record),
            "level": record.levelname,
            "logger": record.name,
            "msg": record.getMessage(),
        }
        if record.exc_info:
            out["exc"] = self.formatException(record.exc_info)
        return json.dumps(out)


def enable_json_logs(level: int = logging.INFO) -> None:
    handler = logging.StreamHandler()
    handler.setFormatter(_JsonFormatter())
    log.handlers[:] = [handler]
    log.setLevel(level)
