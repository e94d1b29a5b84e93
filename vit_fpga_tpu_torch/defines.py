"""Core data model of the dense network (the port's own copy of the JAX
package's ``defines.py``; numpy only, so both packages hand one network to
each other as numpy fields).

The reference's nested ``std::vector`` network description (``net_data``,
``net_sets`` and ``image_set``) becomes dataclasses of numpy arrays:

  * ``DATA_TYPE``  -> np.float32 host-side; the device datapath may run
    bf16 or int8, selected per backend.
  * ``MAX_RANGE`` / ``MIN_RANGE`` -> module constants.
  * ``net_data``   -> :class:`NetData`.
  * ``net_sets``   -> :class:`NetSets`.
  * ``image_set``  -> :class:`ImageSet`.

The reference flattens the nested description into contiguous
``params[n_params]`` / ``bias[n_neurons]`` / ``n_p_l[n_layers]`` arrays with
a row-major [layer][neuron][input] layout; that flat layout survives as an
interchange format in :func:`flatten_net` / :func:`unflatten_net`, so flat
checkpoints round-trip exactly.  The reference's own exporter is broken
(every layer's fan-in taken as ``n_ins``); the obviously intended
behaviour is implemented here instead.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np

# Host-side scalar type (reference: DATA_TYPE float, def/defines.h:10).
DATA_TYPE = np.float32

# Parameter init range (reference: def/defines.h:11-12).
MAX_RANGE: float = 1.0
MIN_RANGE: float = -1.0

# Streaming image geometry (reference: include/netFPGA.h:14-15).
IMAGE_HEIGHT: int = 1080
IMAGE_WIDTH: int = 1920

# Depth of the streaming in-flight ring (reference: BATCH_SIZE 24,
# src/netFPGA.cpp:12).
RING_DEPTH: int = 24

# Activation codes.  The reference hard-codes a single global code
# ``activations = 1 // RELU2`` (src/netFPGA.cpp:79); the device semantics
# live in the missing bitstream, so we define the family explicitly.
ACT_IDENTITY: int = 0
ACT_RELU2: int = 1  # the reference's default: rectified linear
ACT_GELU: int = 2
ACT_TANH: int = 3
ACT_SIGMOID: int = 4


@dataclasses.dataclass
class NetData:
    """Dense-network description (reference ``net_data``, defines.h:14-23).

    ``params[l]`` has shape ``(n_p_l[l], fan_in(l))`` — one row per neuron,
    matching the reference's [layer][neuron][input] nesting — and ``bias[l]``
    has shape ``(n_p_l[l],)``.  ``fan_in(0) == n_ins`` and
    ``fan_in(l) == n_p_l[l-1]`` (src/netFPGA.cpp:68-76).
    """

    n_ins: int
    n_layers: int
    n_p_l: List[int]
    params: List[np.ndarray]
    bias: List[np.ndarray]
    activations: List[int]

    @property
    def n_neurons(self) -> int:
        return int(sum(self.n_p_l))

    @property
    def n_params(self) -> int:
        return int(sum(w.size for w in self.params))

    def fan_in(self, layer: int) -> int:
        return self.n_ins if layer == 0 else self.n_p_l[layer - 1]

    def validate(self) -> "NetData":
        if self.n_layers != len(self.n_p_l):
            raise ValueError(
                f"n_layers={self.n_layers} != len(n_p_l)={len(self.n_p_l)}")
        if len(self.params) != self.n_layers or len(self.bias) != self.n_layers:
            raise ValueError("params/bias must have one entry per layer")
        if len(self.activations) != self.n_layers:
            raise ValueError("activations must have one code per layer")
        for l in range(self.n_layers):
            want = (self.n_p_l[l], self.fan_in(l))
            if tuple(self.params[l].shape) != want:
                raise ValueError(
                    f"layer {l}: params shape {self.params[l].shape} != {want}")
            if tuple(self.bias[l].shape) != (self.n_p_l[l],):
                raise ValueError(
                    f"layer {l}: bias shape {self.bias[l].shape} != "
                    f"({self.n_p_l[l]},)")
        return self


@dataclasses.dataclass
class NetSets:
    """Training-set container (reference ``net_sets``, defines.h:25-29)."""

    set_ins: np.ndarray   # (n_sets, n_ins)
    set_outs: np.ndarray  # (n_sets, n_outs)

    def __post_init__(self):
        self.set_ins = np.asarray(self.set_ins, dtype=DATA_TYPE)
        self.set_outs = np.asarray(self.set_outs, dtype=DATA_TYPE)
        if self.set_ins.ndim != 2 or self.set_outs.ndim != 2:
            raise ValueError("set_ins/set_outs must be rank-2 (n_sets, dim)")
        if self.set_ins.shape[0] != self.set_outs.shape[0]:
            raise ValueError("set_ins and set_outs must have equal n_sets")

    @property
    def n_sets(self) -> int:
        return int(self.set_ins.shape[0])


@dataclasses.dataclass
class ImageSet:
    """Streaming-image container (reference ``image_set``, defines.h:31-38).

    ``resized_image_data`` is a flat uint8 grayscale buffer of
    ``IMAGE_HEIGHT * IMAGE_WIDTH`` bytes (or any H*W passed to the pipeline);
    the ``original_*`` fields carry caller bookkeeping through the pipeline
    untouched, exactly as the reference does.
    """

    resized_image_data: np.ndarray
    original_x_pos: int = 0
    original_y_pos: int = 0
    original_h: int = IMAGE_HEIGHT
    original_w: int = IMAGE_WIDTH

    def __post_init__(self):
        self.resized_image_data = np.asarray(
            self.resized_image_data, dtype=np.uint8).reshape(-1)

    @property
    def empty(self) -> bool:
        return self.resized_image_data.size == 0

    @staticmethod
    def empty_image() -> "ImageSet":
        """The underflow sentinel (reference returns an empty image on
        'PILA VACIA', src/netFPGA.cpp:358-361)."""
        return ImageSet(np.zeros((0,), dtype=np.uint8),
                        original_h=0, original_w=0)


# ---------------------------------------------------------------------------
# Flat interchange layout (reference src/netFPGA.cpp:64-107).
# ---------------------------------------------------------------------------

def flatten_net(data: NetData):
    """Flatten to the reference's contiguous layout.

    Returns ``(params_flat, bias_flat, n_p_l)`` where ``params_flat`` is the
    row-major [layer][neuron][input] concatenation (src/netFPGA.cpp:94-106)
    and ``bias_flat`` is one bias per neuron in layer-major order.
    """
    data.validate()
    params_flat = np.concatenate(
        [np.asarray(w, dtype=DATA_TYPE).reshape(-1) for w in data.params])
    bias_flat = np.concatenate(
        [np.asarray(b, dtype=DATA_TYPE).reshape(-1) for b in data.bias])
    return params_flat, bias_flat, np.asarray(data.n_p_l, dtype=np.int32)


def unflatten_net(n_ins: int, n_p_l: Sequence[int], params_flat: np.ndarray,
                  bias_flat: np.ndarray,
                  activations: Sequence[int] | None = None) -> NetData:
    """Inverse of :func:`flatten_net` (the correct version of the reference's
    broken ``get_net_data``, src/netFPGA.cpp:206-237)."""
    n_p_l = [int(x) for x in n_p_l]
    n_layers = len(n_p_l)
    params: List[np.ndarray] = []
    bias: List[np.ndarray] = []
    p_off = 0
    b_off = 0
    fan_in = n_ins
    for l in range(n_layers):
        n_out = n_p_l[l]
        params.append(
            np.asarray(params_flat[p_off:p_off + n_out * fan_in],
                       dtype=DATA_TYPE).reshape(n_out, fan_in))
        bias.append(np.asarray(bias_flat[b_off:b_off + n_out],
                               dtype=DATA_TYPE))
        p_off += n_out * fan_in
        b_off += n_out
        fan_in = n_out
    if p_off != len(params_flat) or b_off != len(bias_flat):
        raise ValueError("flat arrays do not match the layer shapes")
    acts = list(activations) if activations is not None \
        else [ACT_RELU2] * n_layers
    return NetData(n_ins=n_ins, n_layers=n_layers, n_p_l=n_p_l,
                   params=params, bias=bias, activations=acts).validate()


def random_net(n_ins: int, n_p_l: Sequence[int], seed: int = 0,
               activations: Sequence[int] | None = None) -> NetData:
    """Uniform-random init in [MIN_RANGE, MAX_RANGE).

    The reference initializes with ``rand()%200 - 100 / 100`` i.e. centiles in
    [-1, 1) (src/netFPGA.cpp:82-88); we draw continuous uniforms over the same
    range from a seeded generator for reproducibility.
    """
    rng = np.random.default_rng(seed)
    n_p_l = [int(x) for x in n_p_l]
    params, bias = [], []
    fan_in = n_ins
    for n_out in n_p_l:
        params.append(rng.uniform(MIN_RANGE, MAX_RANGE,
                                  size=(n_out, fan_in)).astype(DATA_TYPE))
        bias.append(rng.uniform(MIN_RANGE, MAX_RANGE,
                                size=(n_out,)).astype(DATA_TYPE))
        fan_in = n_out
    acts = list(activations) if activations is not None \
        else [ACT_RELU2] * len(n_p_l)
    return NetData(n_ins=n_ins, n_layers=len(n_p_l), n_p_l=n_p_l,
                   params=params, bias=bias, activations=acts).validate()
