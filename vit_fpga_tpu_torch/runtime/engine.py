"""Process-wide execution engine: parameter residency (counterpart of the
JAX package's runtime/engine.py).

The reference keeps one global OpenCL session shared by every backend
instance, compiles its program on first use, and restages weights only
when the resident network's identity changes.  Here:

  * compile-on-first-use -> the CUDA kernels are built once per process by
    ``ops/_kernels.py``; the PyTorch ops around them need no build step;
  * the restage check    -> :class:`ParamStore`, a version-keyed device
    residency cache: staged once, restaged only when the owning backend
    bumps its version (training, a model swap);
  * ``cleanup()``        -> :meth:`Engine.cleanup` (drops the session;
    garbage collection replaces the reference's manual refcount).
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, Hashable, Optional, Tuple


class ParamStore:
    """Device-residency cache for parameters.

    Keys are ``(owner_key, version)``; a put with a newer version replaces
    the stale entry, the analogue of the reference's pointer-identity
    restage check.
    """

    def __init__(self):
        self._store: Dict[Hashable, Tuple[int, Any]] = {}
        self._lock = threading.Lock()

    def get(self, owner_key: Hashable, version: int,
            stage: Callable[[], Any]) -> Any:
        with self._lock:
            hit = self._store.get(owner_key)
            if hit is not None and hit[0] == version:
                return hit[1]
        staged = stage()  # host -> device copy outside the lock
        with self._lock:
            self._store[owner_key] = (version, staged)
        return staged

    def evict(self, owner_key: Hashable) -> None:
        with self._lock:
            self._store.pop(owner_key, None)

    def __len__(self) -> int:
        return len(self._store)


class Engine:
    """Singleton runtime session."""

    _instance: Optional["Engine"] = None
    _instance_lock = threading.Lock()

    def __init__(self):
        self.params = ParamStore()

    @classmethod
    def get(cls) -> "Engine":
        with cls._instance_lock:
            if cls._instance is None:
                cls._instance = Engine()
            return cls._instance

    @classmethod
    def cleanup(cls) -> None:
        """Drop the process-wide session (the reference's ``cleanup()``).
        A later backend re-creates it lazily."""
        with cls._instance_lock:
            cls._instance = None
