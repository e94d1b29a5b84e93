"""Process-wide metrics registry that the serving runtime records into.

The port's own copy of ``Metrics`` from the JAX package's utils/log.py.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, Sequence


class Metrics:
    """Process-wide counters/gauges (thread-safe)."""

    _lock = threading.Lock()
    _counters: Dict[str, float] = {}
    _gauges: Dict[str, float] = {}
    _samples: Dict[str, deque] = {}
    _max_samples = 4096   # bounded reservoir per series (recent window)

    @classmethod
    def incr(cls, name: str, value: float = 1.0) -> None:
        with cls._lock:
            cls._counters[name] = cls._counters.get(name, 0.0) + value

    @classmethod
    def gauge(cls, name: str, value: float) -> None:
        with cls._lock:
            cls._gauges[name] = value

    @classmethod
    def observe(cls, name: str, value: float) -> None:
        """Record one sample into a bounded sliding window."""
        with cls._lock:
            if name not in cls._samples:
                cls._samples[name] = deque(maxlen=cls._max_samples)
            cls._samples[name].append(value)

    @classmethod
    def percentiles(cls, name: str,
                    pcts: Sequence[float] = (50.0, 99.0)) -> Dict[str, float]:
        """Percentiles over the recent sample window (empty dict if none)."""
        with cls._lock:
            xs = sorted(cls._samples.get(name, ()))
        if not xs:
            return {}
        out = {}
        for p in pcts:
            idx = min(len(xs) - 1, max(0, round(p / 100.0 * (len(xs) - 1))))
            out[f"p{p:g}"] = xs[idx]
        return out

    @classmethod
    def snapshot(cls) -> Dict[str, float]:
        with cls._lock:
            out = dict(cls._counters)
            out.update({f"gauge/{k}": v for k, v in cls._gauges.items()})
            sample_names = list(cls._samples)
        for name in sample_names:
            for k, v in cls.percentiles(name).items():
                out[f"{name}/{k}"] = v
        out["ts"] = time.time()
        return out

    @classmethod
    def reset(cls) -> None:
        with cls._lock:
            cls._counters.clear()
            cls._gauges.clear()
            cls._samples.clear()
