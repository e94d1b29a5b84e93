"""NumPy reference backend, the parity oracle (the port's own copy of the
JAX package's backends/cpu.py, over the port's ``defines``,
``activations`` and ``ops/image_filter``; ``chip_smoke.py`` holds
``NetCUDA`` against it on the card's machine, which has no JAX).

A dependency-free, deterministic implementation of the exact semantics
the accelerated backends must match: the reference's weight layout,
forward math, perf counters and bounded streaming ring, with real training
and ``get_net_data`` export (both stubbed in the reference).
"""

from __future__ import annotations

import copy
import time
from collections import deque
from typing import Deque, List, Optional

import numpy as np

from .. import activations as act
from ..abstract import NetAbstract
from ..defines import (DATA_TYPE, RING_DEPTH, ImageSet, NetData, NetSets)
from ..ops.image_filter import FILTERS, filter_image_numpy


class NetCPU(NetAbstract):
    """Pure-NumPy dense-network backend."""

    def __init__(self, data: NetData, derivate: bool = False,
                 random: bool = False, seed: int = 0,
                 ring_depth: int = RING_DEPTH,
                 image_filter: str = "sharpen"):
        data.validate()
        if random:
            from ..defines import random_net
            data = random_net(data.n_ins, data.n_p_l, seed=seed,
                              activations=data.activations)
        # Own copies, like the reference constructor's flatten-copy.
        self._data = NetData(
            n_ins=data.n_ins, n_layers=data.n_layers,
            n_p_l=list(data.n_p_l),
            params=[np.array(w, dtype=DATA_TYPE) for w in data.params],
            bias=[np.array(b, dtype=DATA_TYPE) for b in data.bias],
            activations=list(data.activations))
        self._derivate = derivate
        self._sets: Optional[NetSets] = None
        self.forward_performance: int = 0
        self.gradient_performance: int = 0
        # Streaming ring state.
        self._ring_depth = ring_depth
        self._ring: Deque[ImageSet] = deque()
        self._filter = image_filter
        if image_filter not in FILTERS:
            raise ValueError(f"unknown image filter {image_filter!r}")

    # -- inference ----------------------------------------------------------

    def forward_batch(self, inputs: np.ndarray) -> np.ndarray:
        """Forward a batch ``(B, n_ins) -> (B, n_out)`` in float32.

        Per layer: ``y = act(x @ W.T + b)``, the reference's per-neuron dot
        products in its [layer][neuron][input] layout, vectorized.
        """
        x = np.asarray(inputs, dtype=DATA_TYPE)
        squeeze = x.ndim == 1
        if squeeze:
            x = x[None, :]
        if x.shape[1] != self._data.n_ins:
            raise ValueError(
                f"input dim {x.shape[1]} != n_ins {self._data.n_ins}")
        for l in range(self._data.n_layers):
            x = x @ self._data.params[l].T + self._data.bias[l]
            x = act.apply_numpy(self._data.activations[l], x)
            x = x.astype(DATA_TYPE)
        return x[0] if squeeze else x

    def launch_forward(self, inputs: np.ndarray) -> np.ndarray:
        t0 = time.perf_counter()
        out = self.forward_batch(np.asarray(inputs))
        self.forward_performance = int((time.perf_counter() - t0) * 1e6)
        return out

    # -- training -----------------------------------------------------------

    def init_gradient(self, sets: NetSets) -> None:
        self._sets = sets

    def launch_gradient(self, iterations: int, error_threshold: float,
                        multiplier: float) -> np.ndarray:
        if self._sets is None:
            raise RuntimeError("init_gradient must be called first")
        t0 = time.perf_counter()
        errs = np.zeros((iterations,), dtype=DATA_TYPE)
        X = self._sets.set_ins
        Y = self._sets.set_outs
        for it in range(iterations):
            loss, grads_w, grads_b = self._loss_and_grads(X, Y)
            errs[it] = loss
            for l in range(self._data.n_layers):
                self._data.params[l] -= (multiplier * grads_w[l]).astype(
                    DATA_TYPE)
                self._data.bias[l] -= (multiplier * grads_b[l]).astype(
                    DATA_TYPE)
            if loss < error_threshold:
                break
        self.gradient_performance = int((time.perf_counter() - t0) * 1e6)
        return errs

    def _loss_and_grads(self, X: np.ndarray, Y: np.ndarray):
        """Full-batch MSE loss + backprop gradients.

        Loss = mean over sets and outputs of (y - target)^2.
        """
        pre: List[np.ndarray] = []
        post: List[np.ndarray] = [X.astype(DATA_TYPE)]
        x = post[0]
        for l in range(self._data.n_layers):
            z = x @ self._data.params[l].T + self._data.bias[l]
            pre.append(z)
            x = act.apply_numpy(self._data.activations[l], z).astype(DATA_TYPE)
            post.append(x)
        diff = post[-1] - Y
        loss = float(np.mean(diff * diff))
        # d(loss)/d(out) for mean over B*n_out elements
        g = (2.0 / diff.size) * diff
        grads_w: List[np.ndarray] = [None] * self._data.n_layers  # type: ignore
        grads_b: List[np.ndarray] = [None] * self._data.n_layers  # type: ignore
        for l in reversed(range(self._data.n_layers)):
            g = g * act.derivative_numpy(self._data.activations[l], pre[l])
            grads_w[l] = g.T @ post[l]
            grads_b[l] = g.sum(axis=0)
            if l > 0:
                g = g @ self._data.params[l]
        return loss, grads_w, grads_b

    # -- export / debug / perf ----------------------------------------------

    def get_net_data(self) -> NetData:
        return copy.deepcopy(self._data)

    def print_inner_vals(self) -> None:
        for l in range(self._data.n_layers):
            w, b = self._data.params[l], self._data.bias[l]
            print(f"layer {l}: W{tuple(w.shape)} mean={w.mean():.6f} "
                  f"b{tuple(b.shape)} mean={b.mean():.6f} "
                  f"act={self._data.activations[l]}")

    def get_gradient_performance(self) -> int:
        return self.gradient_performance

    def get_forward_performance(self) -> int:
        return self.forward_performance

    # -- streaming image path ------------------------------------------------

    def filter_image(self, image: ImageSet) -> None:
        if len(self._ring) >= self._ring_depth:
            # The reference's "PILA LLENA": the frame is dropped.
            print("vit_fpga_tpu: ring full, dropping frame")
            return
        h, w = image.original_h, image.original_w
        img = image.resized_image_data.reshape(h, w)
        out = filter_image_numpy(img, self._filter)
        self._ring.append(ImageSet(out.reshape(-1),
                                   original_x_pos=image.original_x_pos,
                                   original_y_pos=image.original_y_pos,
                                   original_h=h, original_w=w))

    def get_filtered_image(self) -> ImageSet:
        if not self._ring:
            # The reference's "PILA VACIA": an empty image.
            print("vit_fpga_tpu: ring empty")
            return ImageSet.empty_image()
        return self._ring.popleft()
