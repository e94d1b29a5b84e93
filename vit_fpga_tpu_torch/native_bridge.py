"""Bytes-in/bytes-out bridge for a native runtime (counterpart of the JAX
package's native_bridge.py, over :class:`NetCUDA`).

A C++ shim that embeds CPython drives the dense backend through this
module only: flat float32 / int32 / uint8 buffers in and out, so the
native side needs nothing beyond the stable CPython ABI.  Handles are
integers into a process-global registry of :class:`NetCUDA` instances.
The ViT entry points of the JAX bridge, and a C++ shim over this module,
are not ported yet.
"""

from __future__ import annotations

import threading
from typing import Dict, Tuple

import numpy as np

from .backends.cuda import NetCUDA
from .defines import ImageSet, NetSets, flatten_net, random_net, unflatten_net

_registry: Dict[int, NetCUDA] = {}
_next_id = 0
_lock = threading.Lock()


def create(n_ins: int, npl_bytes: bytes, params_bytes: bytes,
           bias_bytes: bytes, acts_bytes: bytes, random_init: int,
           seed: int, ring_depth: int, filter_name: str,
           device=None) -> int:
    """A new network; ``device`` is CUDA unless ``"cpu"``."""
    global _next_id
    n_p_l = np.frombuffer(npl_bytes, dtype=np.int32)
    acts = np.frombuffer(acts_bytes, dtype=np.int32)
    if random_init:
        data = random_net(n_ins, n_p_l.tolist(), seed=seed,
                          activations=acts.tolist())
    else:
        params = np.frombuffer(params_bytes, dtype=np.float32)
        bias = np.frombuffer(bias_bytes, dtype=np.float32)
        data = unflatten_net(n_ins, n_p_l.tolist(), params, bias,
                             activations=acts.tolist())
    net = NetCUDA(data, ring_depth=ring_depth, image_filter=filter_name,
                  device=device)
    with _lock:
        _next_id += 1
        handle = _next_id
        _registry[handle] = net
    return handle


def destroy(handle: int) -> None:
    with _lock:
        _registry.pop(handle, None)


def _net(handle: int) -> NetCUDA:
    net = _registry.get(handle)
    if net is None:
        raise KeyError(f"invalid native handle {handle}")
    return net


def n_outs(handle: int) -> int:
    return int(_net(handle)._n_p_l[-1])


def forward(handle: int, in_bytes: bytes) -> bytes:
    net = _net(handle)
    x = np.frombuffer(in_bytes, dtype=np.float32)
    out = net.launch_forward(x)
    return np.ascontiguousarray(out, dtype=np.float32).tobytes()


def get_net_data(handle: int) -> Tuple[bytes, bytes]:
    params, bias, _ = flatten_net(_net(handle).get_net_data())
    return params.tobytes(), bias.tobytes()


def init_gradient(handle: int, ins_bytes: bytes, outs_bytes: bytes,
                  n_sets: int, n_out: int) -> None:
    net = _net(handle)
    X = np.frombuffer(ins_bytes, dtype=np.float32).reshape(n_sets, -1)
    Y = np.frombuffer(outs_bytes, dtype=np.float32).reshape(n_sets, n_out)
    net.init_gradient(NetSets(X, Y))


def launch_gradient(handle: int, iterations: int, threshold: float,
                    multiplier: float) -> bytes:
    errs = _net(handle).launch_gradient(iterations, threshold, multiplier)
    return np.ascontiguousarray(errs, dtype=np.float32).tobytes()


def forward_perf(handle: int) -> int:
    return int(_net(handle).get_forward_performance())


def gradient_perf(handle: int) -> int:
    return int(_net(handle).get_gradient_performance())


def print_inner_vals(handle: int) -> None:
    _net(handle).print_inner_vals()


def filter_image(handle: int, pix_bytes: bytes, h: int, w: int,
                 x_pos: int, y_pos: int) -> int:
    """Submit a frame; returns 1 when the full ring dropped it."""
    net = _net(handle)
    before = net._ring.dropped
    img = np.frombuffer(pix_bytes, dtype=np.uint8)
    net.filter_image(ImageSet(img, original_x_pos=x_pos,
                              original_y_pos=y_pos, original_h=h,
                              original_w=w))
    return 1 if net._ring.dropped > before else 0


def get_filtered_image(handle: int) -> Tuple[int, bytes, int, int, int, int]:
    """(empty flag, pixels, h, w, x_pos, y_pos) of the oldest frame."""
    out = _net(handle).get_filtered_image()
    if out.empty:
        return 1, b"", 0, 0, 0, 0
    return (0, out.resized_image_data.tobytes(),
            int(out.original_h), int(out.original_w),
            int(out.original_x_pos), int(out.original_y_pos))
