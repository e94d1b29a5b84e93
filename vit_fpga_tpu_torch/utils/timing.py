"""Device timing with CUDA events."""

from __future__ import annotations

from typing import Callable

import torch


def time_cuda(fn: Callable[[], object], iters: int = 20,
              warmup: int = 3) -> float:
    """Mean milliseconds per call of ``fn`` on the current CUDA stream:
    ``warmup`` untimed calls, then ``iters`` calls between two events."""
    if not torch.cuda.is_available():
        raise RuntimeError("time_cuda needs a CUDA device")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters
