"""Bounded asynchronous streaming ring of image frames (counterpart of the
JAX package's runtime/pipeline.py).

The reference runs a 24-slot OpenCL event ring: each slot chains
write -> compute -> read events, so up to 24 frames are in flight while
the host only ever blocks on the *oldest* frame's read event
(``clWaitForEvents``).  On the card the ring is the same thing in CUDA
terms, on a side stream, with one pinned output buffer and one event a
frame:

  * submit   = on the side stream: copy the caller's frame to the card
    (``non_blocking``; CUDA stages a pageable source before the call
    returns, so the caller may reuse its frame at once), run the filter
    (K25), copy the result into a new pinned buffer (``non_blocking``),
    record the frame's event.  The host returns at once.
  * retrieve = pop the oldest entry and wait on its event only (the lone
    blocking point).  The pinned buffer is handed to the caller, not
    copied: PyTorch's caching host allocator takes it back when the caller
    drops it, and reuses it for a later frame.
  * overflow  -> frame DROPPED with a warning ("PILA LLENA");
  * underflow -> ``None`` with a warning ("PILA VACIA").

On a CPU device the filter runs at submit and the entry holds its result.
"""

from __future__ import annotations

import logging
from collections import deque
from typing import Callable, Deque, Generic, Optional, Tuple, TypeVar

import numpy as np
import torch

from ..utils.log import Metrics

log = logging.getLogger("vit_fpga_tpu_torch.pipeline")

M = TypeVar("M")


class StreamingRing(Generic[M]):
    """A depth-bounded FIFO of in-flight filtered frames + metadata.

    ``run`` maps an (H, W) uint8 tensor on ``device`` to the filtered
    (H, W) uint8 tensor on the same device.
    """

    def __init__(self, depth: int,
                 run: Callable[[torch.Tensor], torch.Tensor],
                 device: torch.device):
        if depth < 1:
            raise ValueError("ring depth must be >= 1")
        self.depth = depth
        self.device = torch.device(device)
        self._run = run
        # entries: ((result, its event or None on the CPU), meta)
        self._ring: Deque[Tuple[tuple, M]] = deque()
        self._stream: Optional[torch.cuda.Stream] = None
        self.dropped = 0       # frames rejected on overflow
        self.submitted = 0
        self.retrieved = 0

    def __len__(self) -> int:
        return len(self._ring)

    @property
    def free(self) -> int:
        """Free slots (the reference's ``g_free_batch``)."""
        return self.depth - len(self._ring)

    def try_submit(self, frame: np.ndarray, meta: M) -> bool:
        """Queue one (H, W) uint8 frame; returns False (frame dropped)
        when full.  On the card this returns before the frame is done."""
        if len(self._ring) >= self.depth:
            self.dropped += 1
            Metrics.incr("ring/dropped")
            log.warning("streaming ring full (depth=%d): dropping frame",
                        self.depth)
            print("vit_fpga_tpu: ring full, dropping frame")
            return False
        frame = np.require(frame, np.uint8, ["C", "W"])
        if frame.ndim != 2:
            raise ValueError(f"frame must be (H, W), got {frame.shape}")
        self._ring.append((self._launch(frame), meta))
        self.submitted += 1
        Metrics.incr("ring/submitted")
        return True

    def _launch(self, frame: np.ndarray):
        src = torch.from_numpy(frame)
        if self.device.type != "cuda":
            return self._run(src.to(self.device)), None
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        out = torch.empty(frame.shape, dtype=torch.uint8, pin_memory=True)
        done = torch.cuda.Event()
        with torch.cuda.stream(self._stream):
            out.copy_(self._run(src.to(self.device, non_blocking=True)),
                      non_blocking=True)
            done.record(self._stream)
        return out, done

    def try_retrieve(self) -> Optional[Tuple[np.ndarray, M]]:
        """Pop the oldest entry as (filtered frame, meta), or None when
        drained; waits for that frame alone."""
        if not self._ring:
            log.warning("streaming ring empty")
            print("vit_fpga_tpu: ring empty")
            return None
        self.retrieved += 1
        (out, done), meta = self._ring.popleft()
        if done is not None:
            done.synchronize()
        return out.numpy(), meta

    def drain(self) -> None:
        """Drop every entry; copies still in flight finish into buffers
        that the host allocator reuses only after them."""
        self._ring.clear()
