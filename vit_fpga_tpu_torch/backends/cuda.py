"""NetCUDA, the dense-network backend on the card (counterpart of the JAX
package's backends/tpu.py ``NetTPU``; the reference's ``net_fpga``).

  * compile-on-first-use      -> the CUDA kernels are built once per
    process by ``ops/_kernels.py``
  * the restage check         -> version-keyed :class:`ParamStore`
    (staged once; restaged only after training)
  * µs ``PERFORMANCE`` timers -> :class:`PerfTimer`, which waits for the
    card before it reads the clock
  * the 24-slot image ring    -> :class:`StreamingRing` on a side stream,
    one pinned output buffer and one event a frame, through the K25 filter
  * training (stubbed in the reference) -> SGD with early stop, the
    semantics of the NumPy oracle, the stop flag kept on the card
  * the fixed-point datapath  -> ``compute_dtype="int8"``: one K13 int8
    GEMM per layer, bit for bit the numpy oracle

Weights live as ``(fan_in, fan_out)`` matrices (transposed from the
reference's [neuron][input] rows) so the forward is ``x @ W + b``: a
plain product per layer, as the JAX package leaves it to XLA.
"""

from __future__ import annotations

import itertools
from functools import partial
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..abstract import NetAbstract
from ..defines import DATA_TYPE, RING_DEPTH, ImageSet, NetData, NetSets
from ..models.mlp import forward_layers, to_net_data
from ..ops.image_filter import FILTERS, filter_image_device
from ..runtime.engine import Engine
from ..runtime.perf import PerfTimer
from ..runtime.pipeline import StreamingRing
from ..utils.platform import resolve_device, true_f32

_uid = itertools.count()
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "int8": torch.float32}


def _sgd_steps(params, X, Y, *, acts, compute_dtype, iterations: int,
               error_threshold: float, multiplier: float):
    """``iterations`` full-batch SGD steps on the MSE loss with early
    stop; returns (params, per-step losses) on the parameters' device.

    The oracle's semantics: the loss that triggers the stop is recorded,
    later slots stay 0, and the parameters freeze from then on.  The stop
    flag is a device tensor, so no step waits for the card.  The backward
    products run in true f32 too."""
    flat = [t.detach().clone() for pair in params for t in pair]
    done = torch.zeros((), dtype=torch.bool, device=X.device)
    errs = []
    for _ in range(iterations):
        leaves = [t.requires_grad_(True) for t in flat]
        with true_f32():
            out = forward_layers(list(zip(leaves[::2], leaves[1::2])), X,
                                 acts=acts, compute_dtype=compute_dtype)
            d = out - Y
            loss = torch.mean(d * d)
            grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            flat = [torch.where(done, p, p - multiplier * g)
                    for p, g in zip(leaves, grads)]
            errs.append(torch.where(done, torch.zeros_like(loss), loss))
            done = done | (loss < error_threshold)
    errs = (torch.stack(errs) if errs
            else torch.zeros((0,), device=X.device))
    return list(zip(flat[::2], flat[1::2])), errs


class NetCUDA(NetAbstract):
    """Dense-network backend on ``device`` (CUDA unless ``"cpu"``)."""

    def __init__(self, data: NetData, derivate: bool = False,
                 random: bool = False, seed: int = 0,
                 compute_dtype: str = "float32",
                 ring_depth: int = RING_DEPTH,
                 image_filter: str = "sharpen",
                 device=None):
        data.validate()
        if random:
            from ..defines import random_net
            data = random_net(data.n_ins, data.n_p_l, seed=seed,
                              activations=data.activations)
        if compute_dtype not in _DTYPES:
            raise ValueError(f"unknown compute_dtype {compute_dtype!r}")
        if image_filter not in FILTERS:
            raise ValueError(f"unknown image filter {image_filter!r}")
        self._device = resolve_device(device)
        self._n_ins = data.n_ins
        self._n_p_l = list(data.n_p_l)
        self._acts = tuple(int(a) for a in data.activations)
        # Host master copy, (fan_in, fan_out)-transposed for x @ W.
        self._host_params: List[Tuple[np.ndarray, np.ndarray]] = [
            (np.ascontiguousarray(w.T, dtype=DATA_TYPE),
             np.array(b, dtype=DATA_TYPE))
            for w, b in zip(data.params, data.bias)]
        self._compute_mode = compute_dtype
        self._dtype = _DTYPES[compute_dtype]
        self._qparams_dev = None  # int8 mode: quantized params on the card
        self._key = ("net_cuda", next(_uid))
        self._version = 0
        self._device_params = None   # set after training (device master)
        self._sets: Optional[NetSets] = None
        self.forward_performance = 0
        self.gradient_performance = 0
        self._ring: StreamingRing[ImageSet] = StreamingRing(
            ring_depth, partial(filter_image_device, name=image_filter),
            self._device)
        self._engine = Engine.get()

    # -- parameter residency ---------------------------------------------------

    def _params_on_device(self):
        if self._device_params is not None:
            return self._device_params
        return self._engine.params.get(
            self._key, self._version,
            lambda: [(torch.from_numpy(w).to(self._device),
                      torch.from_numpy(b).to(self._device))
                     for w, b in self._host_params])

    # -- inference ------------------------------------------------------------

    def forward_batch(self, inputs: np.ndarray) -> np.ndarray:
        x = np.asarray(inputs, dtype=np.float32)
        squeeze = x.ndim == 1
        if squeeze:
            x = x[None, :]
        if x.shape[1] != self._n_ins:
            raise ValueError(f"input dim {x.shape[1]} != n_ins {self._n_ins}")
        xt = torch.tensor(x, device=self._device)
        with torch.no_grad():
            if self._compute_mode == "int8":
                out = self._forward_int8(xt)
            else:
                out = forward_layers(self._params_on_device(), xt,
                                     acts=self._acts,
                                     compute_dtype=self._dtype)
        out = out.cpu().numpy()
        return out[0] if squeeze else out

    def _forward_int8(self, x: torch.Tensor) -> torch.Tensor:
        """Quantized datapath (the reference's fixed-point mode): weights
        quantized once per version, per-tensor activation scales at run
        time, exact int32 sums in K13."""
        from ..models import quantized
        if self._qparams_dev is None:
            qp = quantized.quantize_mlp(self.get_net_data())
            self._qparams_dev = (quantized.device_qparams(qp, self._device),
                                 qp["acts"])
        dev, acts = self._qparams_dev
        return quantized.mlp_forward_int8(dev, x, acts=acts)

    def launch_forward(self, inputs: np.ndarray) -> np.ndarray:
        with PerfTimer(self._device) as t:
            out = self.forward_batch(np.asarray(inputs))
        self.forward_performance = t.us
        return out

    # -- training -------------------------------------------------------------

    def init_gradient(self, sets: NetSets) -> None:
        self._sets = sets

    def launch_gradient(self, iterations: int, error_threshold: float,
                        multiplier: float) -> np.ndarray:
        if self._sets is None:
            raise RuntimeError("init_gradient must be called first")
        with PerfTimer(self._device) as t:
            params, errs = _sgd_steps(
                self._params_on_device(),
                torch.tensor(self._sets.set_ins, device=self._device),
                torch.tensor(self._sets.set_outs, device=self._device),
                acts=self._acts, compute_dtype=self._dtype,
                iterations=int(iterations),
                error_threshold=float(error_threshold),
                multiplier=float(multiplier))
            errs = errs.cpu().numpy().astype(DATA_TYPE)
        self.gradient_performance = t.us
        # The device copy becomes the master; the host copy is refreshed
        # lazily; the quantized snapshot is stale (requantized on the next
        # int8 forward).
        self._device_params = params
        self._version += 1
        self._qparams_dev = None
        self._engine.params.evict(self._key)
        return errs

    def _sync_host_params(self) -> None:
        if self._device_params is not None:
            self._host_params = [
                (w.cpu().numpy(), b.cpu().numpy())
                for w, b in self._device_params]

    # -- export / debug / perf -------------------------------------------------

    def get_net_data(self) -> NetData:
        self._sync_host_params()
        return to_net_data({"layers": [{"w": w, "b": b}
                                       for w, b in self._host_params]},
                           self._n_ins, self._acts)

    def print_inner_vals(self) -> None:
        self._sync_host_params()
        for l, (w, b) in enumerate(self._host_params):
            print(f"layer {l}: W{tuple(w.shape)} mean={w.mean():.6f} "
                  f"b{tuple(b.shape)} mean={b.mean():.6f} "
                  f"act={self._acts[l]}")

    def get_gradient_performance(self) -> int:
        return self.gradient_performance

    def get_forward_performance(self) -> int:
        return self.forward_performance

    # -- streaming image path ---------------------------------------------------

    def filter_image(self, image: ImageSet) -> None:
        h, w = image.original_h, image.original_w
        img = image.resized_image_data.reshape(h, w)
        meta = ImageSet(np.zeros((0,), np.uint8),
                        original_x_pos=image.original_x_pos,
                        original_y_pos=image.original_y_pos,
                        original_h=h, original_w=w)
        self._ring.try_submit(img, meta)

    def get_filtered_image(self) -> ImageSet:
        got = self._ring.try_retrieve()
        if got is None:
            return ImageSet.empty_image()
        result, meta = got
        meta.resized_image_data = result.reshape(-1)
        return meta
