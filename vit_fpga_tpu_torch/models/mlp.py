"""Dense feed-forward model family on PyTorch (counterpart of the JAX
package's models/mlp.py): the reference-parity network that ``net_data``
describes (n_ins, layer widths, per-neuron weights and biases, activation
codes), as a functional model in plain torch.  The JAX package leaves
this forward to XLA; it has no Pallas kernel.  :func:`forward_layers` is
also the float forward of ``backends/cuda.NetCUDA``.

Params layout: ``{"layers": [{"w": (fan_in, fan_out), "b": (fan_out,)}]}``
(transposed from the reference's [neuron][input] rows for ``x @ W``), f32
tensors.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import activations as act
from ..defines import NetData, random_net
from ..utils.platform import resolve_device, true_f32

Params = Dict[str, Any]


def from_net_data(data: NetData, device=None
                  ) -> Tuple[Params, Tuple[int, ...]]:
    """NetData -> (params on ``device`` (CUDA unless ``"cpu"``), the
    activation codes)."""
    data.validate()
    dev = resolve_device(device)
    layers = [{"w": torch.from_numpy(np.ascontiguousarray(
                   np.asarray(w, np.float32).T)).to(dev),
               "b": torch.from_numpy(np.array(b, np.float32)).to(dev)}
              for w, b in zip(data.params, data.bias)]
    return {"layers": layers}, tuple(int(a) for a in data.activations)


def to_net_data(params: Params, n_ins: int,
                acts: Sequence[int]) -> NetData:
    """The inverse of :func:`from_net_data`: numpy f32 NetData, copied
    from the tree's leaves (tensors or numpy arrays)."""
    layers = params["layers"]

    def host(t):
        if isinstance(t, torch.Tensor):
            t = t.detach().float().cpu()
        return np.array(t, np.float32)

    return NetData(
        n_ins=n_ins, n_layers=len(layers),
        n_p_l=[int(l["b"].shape[0]) for l in layers],
        params=[np.ascontiguousarray(host(l["w"]).T) for l in layers],
        bias=[host(l["b"]) for l in layers],
        activations=list(acts)).validate()


def init_params(generator: torch.Generator, n_ins: int,
                n_p_l: Sequence[int], scale: float = 1.0,
                device=None) -> Params:
    """Uniform init in [-scale, scale) (reference-style), drawn on the CPU
    from ``generator`` layer by layer (weight, then bias) and moved to
    ``device``."""
    dev = resolve_device(device)
    layers: List[Dict[str, torch.Tensor]] = []
    fan_in = n_ins
    for width in n_p_l:
        w = torch.rand((fan_in, width), generator=generator) * 2 - 1
        b = torch.rand((width,), generator=generator) * 2 - 1
        layers.append({"w": (w * scale).to(dev), "b": (b * scale).to(dev)})
        fan_in = width
    return {"layers": layers}


def forward_layers(layers: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                   x: torch.Tensor, *, acts: Tuple[int, ...],
                   compute_dtype: torch.dtype = torch.float32
                   ) -> torch.Tensor:
    """Dense forward over the layer list [(W, b), ...] in
    ``compute_dtype``, (B, n_ins) -> (B, n_out) f32.  In f32 the products
    run in true f32 (TF32 off), as the JAX package forces
    ``Precision.HIGHEST``."""
    with true_f32():
        h = x.to(compute_dtype)
        for (w, b), code in zip(layers, acts):
            h = h @ w.to(compute_dtype) + b.to(compute_dtype)
            h = act.apply_torch(code, h)
        return h.float()


def forward(params: Params, x: torch.Tensor, *, acts: Tuple[int, ...],
            compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """:func:`forward_layers` over the params tree."""
    return forward_layers([(l["w"], l["b"]) for l in params["layers"]], x,
                          acts=acts, compute_dtype=compute_dtype)


def random_model(n_ins: int, n_p_l: Sequence[int], seed: int = 0,
                 activations: Optional[Sequence[int]] = None, device=None):
    """A reference-style random net (``defines.random_net``) as (params,
    acts)."""
    return from_net_data(random_net(n_ins, n_p_l, seed=seed,
                                    activations=activations), device=device)
