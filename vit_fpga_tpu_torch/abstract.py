"""Backend-agnostic network interface (the port's own copy of the JAX
package's ``abstract.py``).

The reference's pure-virtual ``net::net_abstract``: the same nine-method
contract (inference, training, debug introspection, perf counters, and
the streaming image path) as a Python ABC.  Backends:
:class:`~vit_fpga_tpu_torch.backends.cpu.NetCPU` (the NumPy parity
oracle) and :class:`~vit_fpga_tpu_torch.backends.cuda.NetCUDA` (PyTorch
on the card, with the K25 image filter and the K13 int8 GEMM).
"""

from __future__ import annotations

import abc

import numpy as np

from .defines import ImageSet, NetData, NetSets


class NetAbstract(abc.ABC):
    """Mirror of ``net::net_abstract``."""

    @abc.abstractmethod
    def get_net_data(self) -> NetData:
        """Export the current weights as a :class:`NetData`.

        This must round-trip: ``Backend(get_net_data()).launch_forward(x)``
        is bit-identical to ``self.launch_forward(x)``.
        """

    @abc.abstractmethod
    def launch_forward(self, inputs: np.ndarray) -> np.ndarray:
        """Run one forward pass over ``inputs`` (shape ``(n_ins,)``) and
        return the output activations."""

    @abc.abstractmethod
    def init_gradient(self, sets: NetSets) -> None:
        """Stage a training set."""

    @abc.abstractmethod
    def launch_gradient(self, iterations: int, error_threshold: float,
                        multiplier: float) -> np.ndarray:
        """Run up to ``iterations`` gradient steps with learning rate
        ``multiplier``, early-stopping when the epoch loss drops below
        ``error_threshold``.  Returns the per-iteration losses, padded with
        zeros after an early stop so the length contract is kept."""

    @abc.abstractmethod
    def print_inner_vals(self) -> None:
        """Debug introspection."""

    @abc.abstractmethod
    def get_gradient_performance(self) -> int:
        """Wall-clock µs of the last gradient launch (0 when perf counters
        are disabled)."""

    @abc.abstractmethod
    def get_forward_performance(self) -> int:
        """Wall-clock µs of the last forward launch (0 when perf counters
        are disabled)."""

    @abc.abstractmethod
    def filter_image(self, image: ImageSet) -> None:
        """Submit one frame into the bounded streaming pipeline.  On a full
        ring the frame is DROPPED with a warning (the reference's
        'PILA LLENA')."""

    @abc.abstractmethod
    def get_filtered_image(self) -> ImageSet:
        """Retrieve the oldest completed frame (FIFO).  On an empty ring an
        empty :class:`ImageSet` is returned with a warning (the reference's
        'PILA VACIA')."""
