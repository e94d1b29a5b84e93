"""Image-serving pipeline: host decode -> batched device inference.

The port of the JAX package's runtime/serving.py, with the same API and
behaviours:

  * host thread pool: JPEG/PNG decode + resize to the model size
  * a batcher thread assembles fixed-size uint8 batches (padding partial
    flushes) in pinned host memory, copies each to the device without
    blocking and launches the forward (``make_forward(cfg, params)``);
    it records a CUDA event behind the launch and does not synchronise
  * a completer thread waits on each batch's event, copies the rows to
    the host and resolves the per-request futures

Back-pressure: at most ``max_inflight`` batches are dispatched but not
fetched; submits beyond the queue bound block the caller (lossless).
Requests may carry a priority lane and a queue-time deadline, and can be
cancelled before batching.  A partial batch flushes after ``flush_ms``
only while the device pipeline is idle (work-conserving), unless a held
request's own deadline or priority needs it sooner.
"""

from __future__ import annotations

import io
import itertools
import queue
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Optional

import numpy as np
import torch

from ..utils.log import Metrics
from ..utils.platform import resolve_device


class ServerClosed(RuntimeError):
    """Raised for requests submitted to (or stranded in) a closed server."""


def decode_jpeg(data: bytes, image_size: int) -> np.ndarray:
    """JPEG/PNG bytes -> (S, S, 3) uint8 (RGB, bilinear resize)."""
    from PIL import Image
    img = Image.open(io.BytesIO(data)).convert("RGB")
    if img.size != (image_size, image_size):
        img = img.resize((image_size, image_size), Image.BILINEAR)
    return np.asarray(img, dtype=np.uint8)


def _to_host(out) -> np.ndarray:
    if isinstance(out, torch.Tensor):
        out = out.detach().cpu()
        if out.dtype in (torch.bfloat16, torch.float16):
            out = out.float()
        return out.numpy()
    return np.asarray(out)


class ImageServer:
    """Batched async image-encoder server.

    ``forward_raw`` maps a uint8 (B, S, S, 3) tensor on ``device`` to a
    (B, ...) result (``models.vit.make_forward(cfg, params, raw=True)``,
    the int8 engine ``models.quantized.make_forward_int8``, or CLIP's
    ``models.clip.make_forward``, whose rows are embeddings, or DeiT's).
    ``device`` is CUDA unless the caller passes ``"cpu"``.
    """

    def __init__(self, forward_raw: Callable[[torch.Tensor], object],
                 image_size: int, batch_size: int = 256,
                 decode_workers: int = 8, max_inflight: int = 4,
                 flush_ms: float = 5.0, device=None):
        self._fwd = forward_raw
        self._device = resolve_device(device)
        self._size = image_size
        self._batch = batch_size
        self._flush_s = flush_ms / 1e3
        self._decode_pool = ThreadPoolExecutor(decode_workers,
                                               thread_name_prefix="decode")
        # priority queue entries: (lane, seq, img, fut, t0, deadline) —
        # lane 0 = high priority, 1 = normal; seq keeps FIFO within a lane
        self._pending: "queue.PriorityQueue" = queue.PriorityQueue(
            maxsize=4 * batch_size)
        self._seq = itertools.count()
        self._dispatched: "queue.Queue" = queue.Queue(maxsize=max_inflight)
        # dispatched-but-unmaterialized batches (device pipeline depth),
        # guarded by a Condition the work-conserving hold waits on
        self._inflight = 0
        self._idle_cv = threading.Condition()
        self._stop = threading.Event()
        self._closed = threading.Event()   # rejects new submits during drain
        self.served = 0
        self.batches = 0
        self._batcher = threading.Thread(target=self._batch_loop,
                                         daemon=True)
        self._completer = threading.Thread(target=self._complete_loop,
                                           daemon=True)
        self._batcher.start()
        self._completer.start()

    # -- public API -----------------------------------------------------------

    def submit(self, jpeg_bytes: bytes, priority: bool = False,
               timeout_ms: Optional[float] = None) -> Future:
        """Enqueue one encoded image; resolves to its result row (logits,
        or an embedding).

        ``priority=True`` requests jump the normal lane.  ``timeout_ms``
        bounds QUEUE time: a request picked up past its deadline fails
        with TimeoutError.  Futures can be cancelled before batching."""
        if self._closed.is_set():
            raise ServerClosed("submit() on closed ImageServer")
        fut: Future = Future()
        self._decode_pool.submit(self._decode_one, jpeg_bytes, fut,
                                 priority, timeout_ms)
        return fut

    def submit_raw(self, image_u8: np.ndarray, priority: bool = False,
                   timeout_ms: Optional[float] = None) -> Future:
        """Enqueue an already-decoded (S, S, 3) uint8 image."""
        if self._closed.is_set():
            raise ServerClosed("submit_raw() on closed ImageServer")
        fut: Future = Future()
        self._enqueue(image_u8, fut, priority, timeout_ms)
        return fut

    def _enqueue(self, img, fut, priority: bool,
                 timeout_ms: Optional[float]) -> None:
        now = time.monotonic()
        # timeout_ms=0 means fail-if-not-instant, NOT no-deadline
        deadline = (now + timeout_ms / 1e3 if timeout_ms is not None
                    else None)
        entry = (0 if priority else 1, next(self._seq), img, fut, now,
                 deadline)
        # bounded put that aborts on shutdown, so a producer blocked on a
        # full queue cannot strand its future
        while True:
            if self._stop.is_set():
                if not fut.done() and not fut.cancelled():
                    fut.set_exception(ServerClosed(
                        "server closed while request was queuing"))
                return
            try:
                self._pending.put(entry, timeout=0.05)
                with self._idle_cv:   # wake a batcher parked in the hold
                    self._idle_cv.notify_all()
                return
            except queue.Full:
                continue

    def close(self, drain: bool = True, timeout: float = 30.0) -> None:
        """Stop accepting work; by default drain in-flight requests so no
        future is stranded.  Anything still unprocessed at timeout (or
        with ``drain=False``) fails with :class:`ServerClosed`."""
        self._closed.set()
        self._decode_pool.shutdown(wait=drain)
        if drain:
            deadline = time.monotonic() + timeout
            while (not self._pending.empty()
                   and time.monotonic() < deadline):
                time.sleep(0.005)
        self._stop.set()
        self._batcher.join(timeout=10)
        self._completer.join(timeout=10)
        while True:   # fail anything the batcher never picked up
            try:
                _, _, _, fut, _, _ = self._pending.get_nowait()
            except queue.Empty:
                break
            if not fut.done() and not fut.cancelled():
                fut.set_exception(ServerClosed("server closed with request "
                                               "pending"))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # -- internals ------------------------------------------------------------

    def _decode_one(self, data: bytes, fut: Future, priority: bool,
                    timeout_ms: Optional[float]) -> None:
        try:
            img = decode_jpeg(data, self._size)
        except Exception as e:  # decode failure -> per-request error
            fut.set_exception(e)
            return
        self._enqueue(img, fut, priority, timeout_ms)

    def _device_batch(self, items) -> torch.Tensor:
        """The uint8 batch on the device; the host-to-device copy is
        enqueued from pinned memory and does not block."""
        cuda = self._device.type == "cuda"
        host = torch.zeros((self._batch, self._size, self._size, 3),
                           dtype=torch.uint8, pin_memory=cuda)
        view = host.numpy()
        for i, (img, *_rest) in enumerate(items):
            view[i] = img
        return host.to(self._device, non_blocking=True) if cuda else host

    def _batch_loop(self) -> None:
        while not self._stop.is_set():
            items = []   # held entries: (img, fut, t0, dl, lane)

            def take(entry):
                # drop cancelled / queue-expired requests at pickup
                lane, _, img, fut, t0, dl = entry
                if fut.cancelled():
                    return
                if dl is not None and time.monotonic() > dl:
                    if not fut.done():
                        fut.set_exception(TimeoutError(
                            "request expired in queue"))
                    return
                items.append((img, fut, t0, dl, lane))

            def prune_expired(now):
                # held requests keep their deadlines
                kept = []
                for it in items:
                    dl = it[3]
                    if dl is not None and now > dl:
                        if not it[1].done() and not it[1].cancelled():
                            it[1].set_exception(TimeoutError(
                                "request expired awaiting batch fill"))
                    else:
                        kept.append(it)
                items[:] = kept

            def hold_at_risk(now):
                # flush while the batch can still make its riders' own
                # deadlines, and never hold priority riders past flush_ms
                return any(lane == 0
                           or (dl is not None
                               and dl - now <= self._flush_s)
                           for _, _, _, dl, lane in items)

            try:
                take(self._pending.get(timeout=0.05))
            except queue.Empty:
                continue
            # ONE absolute deadline per batch, work-conserving: a partial
            # batch flushes at it only while the device pipeline is idle
            deadline = time.monotonic() + self._flush_s
            while len(items) < self._batch and not self._stop.is_set():
                now = time.monotonic()
                prune_expired(now)
                dls = [dl for _, _, _, dl, _ in items if dl is not None]
                eff = (min(deadline, min(dls) - self._flush_s) if dls
                       else deadline)
                remaining = eff - now
                if remaining <= 0:
                    if (self._device_idle() or not items
                            or hold_at_risk(now)):
                        break   # flush (or re-seed when all riders expired)
                    # device busy, riders safe: park until the completer
                    # signals an in-flight decrement or a submit arrives
                    risk = min((dl - self._flush_s - now
                                for _, _, _, dl, _ in items
                                if dl is not None), default=0.05)
                    try:
                        take(self._pending.get_nowait())
                        continue
                    except queue.Empty:
                        pass
                    with self._idle_cv:
                        if self._inflight > 0:
                            self._idle_cv.wait(
                                timeout=max(0.001, min(0.05, risk)))
                    continue
                try:
                    take(self._pending.get(timeout=remaining))
                except queue.Empty:
                    continue   # re-check deadline / device-idle state
            if not items:
                continue
            n = len(items)
            try:
                out = self._fwd(self._device_batch(items))  # async launch
                done_ev = None
                if self._device.type == "cuda":
                    done_ev = torch.cuda.Event()
                    done_ev.record()
            except Exception as e:  # fail the batch, keep serving
                for _, fut, *_rest in items:
                    if not fut.cancelled():
                        fut.set_exception(e)
                continue
            with self._idle_cv:
                self._inflight += 1
            self._dispatched.put(
                (out, done_ev, [(f, t0) for _, f, t0, _, _ in items], n))
            self.batches += 1

    def _device_idle(self) -> bool:
        with self._idle_cv:
            return self._inflight == 0

    def _complete_loop(self) -> None:
        # Exit only once the batcher can no longer dispatch: stop set AND
        # batcher thread finished AND queue drained.
        while (not self._stop.is_set() or self._batcher.is_alive()
               or not self._dispatched.empty()):
            try:
                out, done_ev, futs, n = self._dispatched.get(timeout=0.05)
            except queue.Empty:
                continue
            try:
                if done_ev is not None:
                    done_ev.synchronize()   # blocks until the device is done
                rows = _to_host(out)[:n]
            except Exception as e:  # async device failure surfaces here
                for fut, _ in futs:
                    if not fut.cancelled():
                        fut.set_exception(e)
                continue
            finally:   # device done (or dead) either way: no longer busy
                with self._idle_cv:
                    self._inflight -= 1
                    self._idle_cv.notify_all()
            done = time.monotonic()
            for i, (fut, t0) in enumerate(futs):
                if not fut.cancelled():
                    fut.set_result(rows[i])
                Metrics.observe("serving/latency_ms", (done - t0) * 1e3)
            self.served += n
            Metrics.incr("serving/images", n)
            Metrics.incr("serving/batches")

    def latency_percentiles(self, pcts=(50.0, 99.0)) -> dict:
        """Submit->result latency percentiles (ms) over the recent window."""
        return Metrics.percentiles("serving/latency_ms", pcts)
