"""Training data pipeline of the port (counterpart of the JAX package's
runtime/data.py): host batching on worker threads and device prefetch.

:class:`HostLoader` and :func:`synthetic_source` are the JAX package's,
numpy and threads: (image uint8 (S, S, 3), label) items become fixed-size
(images, labels) batches, the final partial batch padded with zero images
and the label ``-1`` (the training loss masks negative labels), and each
worker ends the stream with one ``None``.

:func:`device_prefetch` keeps the next ``prefetch`` batches on their way
to the device while the caller's step runs: on the card each batch is
copied from pinned host memory with ``non_blocking=True`` on a side
stream, an event recorded after it; the batch is handed over only once
the consuming stream waits on that event, and ``record_stream`` keeps the
caching allocator from reusing its memory before that stream is done with
it.  On the CPU it is a plain copy.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterable, Iterator, Optional

import numpy as np
import torch

from ..utils.platform import resolve_device


class HostLoader:
    """Pull items from ``source`` on worker threads, assemble fixed-size
    (images, labels) numpy batches.

    ``source`` yields (image_u8 (S,S,3), label int) pairs, e.g. decoded
    files or a synthetic generator.  Order across workers is not
    guaranteed (standard for shuffled training)."""

    def __init__(self, source: Callable[[], Iterable], batch_size: int,
                 workers: int = 4, queue_depth: int = 8):
        self._batch = batch_size
        self._q: "queue.Queue" = queue.Queue(maxsize=queue_depth)
        self._stop = threading.Event()
        self._threads = []
        self._iter_lock = threading.Lock()
        self._it = iter(source())
        for i in range(workers):
            t = threading.Thread(target=self._worker, daemon=True,
                                 name=f"loader-{i}")
            t.start()
            self._threads.append(t)

    def _next_items(self, n):
        out = []
        with self._iter_lock:
            for _ in range(n):
                try:
                    out.append(next(self._it))
                except StopIteration:
                    break
        return out

    def _worker(self) -> None:
        while not self._stop.is_set():
            items = self._next_items(self._batch)
            if not items:
                self._q.put(None)   # end-of-stream sentinel per worker
                return
            imgs = np.stack([np.asarray(im, np.uint8) for im, _ in items])
            labels = np.asarray([lb for _, lb in items], np.int32)
            if len(items) < self._batch:   # pad the final partial batch
                pad = self._batch - len(items)
                imgs = np.concatenate([imgs, np.zeros(
                    (pad,) + imgs.shape[1:], np.uint8)])
                labels = np.concatenate(
                    [labels, np.full((pad,), -1, np.int32)])
            self._q.put((imgs, labels))

    def __iter__(self) -> Iterator:
        ended = 0
        while ended < len(self._threads):
            item = self._q.get()
            if item is None:
                ended += 1
                continue
            yield item

    def close(self) -> None:
        self._stop.set()


def _host_tensor(a, pin: bool) -> torch.Tensor:
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a))
    return t.pin_memory() if pin and not t.is_pinned() else t


def device_prefetch(batches: Iterable, prefetch: int = 2, device=None,
                    sharding: Optional[Any] = None) -> Iterator:
    """Wrap an iterable of host batches (tuples of numpy arrays or CPU
    tensors) so the next ``prefetch`` batches are already on their way
    to ``device`` (CUDA unless ``"cpu"``) while the caller consumes the
    current one.  Yields tuples of tensors on the device.  ``sharding``
    (a mesh) is the multi-device port's and raises."""
    if sharding is not None:
        raise NotImplementedError("sharded prefetch comes with the "
                                  "multi-device port (ROADMAP.md, item 6)")
    dev = resolve_device(device)
    if dev.type == "cuda":
        side = torch.cuda.Stream(dev)

        def put(batch):
            host = [_host_tensor(a, pin=True) for a in batch]
            with torch.cuda.stream(side):
                out = tuple(h.to(dev, non_blocking=True) for h in host)
                ready = torch.cuda.Event()
                ready.record(side)
            return out, ready

        def take(item):
            out, ready = item
            consumer = torch.cuda.current_stream(dev)
            consumer.wait_event(ready)
            for t in out:
                t.record_stream(consumer)
            return out
    else:
        def put(batch):
            return tuple(_host_tensor(a, pin=False).to(dev, copy=True)
                         for a in batch)

        def take(item):
            return item

    it = iter(batches)
    buf = []
    for batch in it:
        buf.append(put(batch))
        if len(buf) >= prefetch:
            break
    for nxt in it:
        out = take(buf.pop(0))
        buf.append(put(nxt))
        yield out
    while buf:
        yield take(buf.pop(0))


def synthetic_source(n: int, image_size: int, num_classes: int,
                     seed: int = 0) -> Callable[[], Iterable]:
    """Deterministic synthetic (image, label) stream for tests and
    benches."""

    def gen():
        rng = np.random.default_rng(seed)
        for _ in range(n):
            yield (rng.integers(0, 256, (image_size, image_size, 3),
                                np.uint8),
                   int(rng.integers(0, num_classes)))

    return gen
