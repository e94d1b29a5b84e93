"""Performance counters and profiling hooks (counterpart of the JAX
package's runtime/perf.py).

The reference's compile-time ``PERFORMANCE`` µs wall timers around
dispatch become :class:`PerfTimer`, which charges device time honestly: on
a CUDA device it synchronizes the stream it timed before it reads the
clock, since PyTorch returns before the card is done.  The reference's
unused OpenCL event profiler becomes :func:`device_trace`, a
``torch.profiler`` context that writes a Chrome trace of the host and the
card.

Counters are on by default; set ``PERFORMANCE_COUNTERS = False`` to turn
them off, and the getters then read 0, as the ``#ifdef``-disabled build of
the reference does.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

PERFORMANCE_COUNTERS: bool = True


class PerfTimer:
    """µs wall-clock timer; a context manager, read ``.us`` after.  With a
    CUDA ``device``, the exit waits for that device's current stream."""

    __slots__ = ("us", "_t0", "_stream")

    def __init__(self, device: torch.device | None = None):
        self.us = 0
        self._t0 = 0.0
        self._stream = (torch.cuda.current_stream(device)
                        if device is not None and device.type == "cuda"
                        else None)

    def __enter__(self):
        if PERFORMANCE_COUNTERS:
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if PERFORMANCE_COUNTERS:
            if self._stream is not None:
                self._stream.synchronize()
            self.us = int((time.perf_counter() - self._t0) * 1e6)
        return False


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Profile the enclosed region (host, and the card when there is one)
    and write ``trace.json`` (Chrome trace format) under ``log_dir``."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
