"""Parameter bridge: the JAX package's parameter tree, handed over as
nested dicts of numpy arrays, becomes the port's tree in the same layout
(NHWC images, patch kernel (P*P*3, D) in (py, px, c) order, blocks stacked
on depth, linear weights (in, out)), and back; and an optax AdamW state,
handed over the same way, becomes a torch AdamW state and back; and the JAX
package's dense ``NetData`` becomes the port's."""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from ..defines import NetData
from ..utils.platform import resolve_device


def params_from_numpy(tree: Mapping[str, Any], device=None,
                      dtype: torch.dtype = torch.float32) -> dict:
    """Nested dicts of array-likes -> nested dicts of tensors on
    ``device`` (CUDA unless ``"cpu"``): float leaves as ``dtype``, integer
    leaves (the int8 weights of a quantized tree) as ``torch.int8``.

    It walks any tree, so every model family crosses with it: the ViT tree,
    the CLIP vision tree (``ln_pre_*``, ``proj``, no ``head``), the CLIP
    text tree (``token_embed``, ``pos_embed`` (77, D), ``proj``) and the
    DeiT tree (``head_dist``, a (1, 2, D) ``cls_token``)."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, Mapping):
            return {k: conv(v) for k, v in node.items()}
        arr = np.asarray(node)
        if np.issubdtype(arr.dtype, np.integer):
            if arr.size and (arr.min() < -128 or arr.max() > 127):
                raise ValueError("integer leaf outside the int8 range")
            return torch.from_numpy(arr.astype(np.int8)).to(device=dev)
        arr = np.asarray(node, dtype=np.float32)
        return torch.from_numpy(arr.copy()).to(device=dev, dtype=dtype)

    return conv(tree)


def params_to_numpy(tree: Mapping[str, Any]) -> dict:
    """Nested dicts of tensors -> nested dicts of numpy arrays, f32 or,
    for integer leaves, int8 (the inverse of :func:`params_from_numpy`)."""
    def conv(v):
        if isinstance(v, Mapping):
            return params_to_numpy(v)
        v = v.detach()
        return (v.float() if v.is_floating_point() else v).cpu().numpy()

    return {k: conv(v) for k, v in tree.items()}


def adamw_state_from_optax(mu: Mapping[str, Any], nu: Mapping[str, Any],
                           count: int, params: Mapping[str, Any],
                           optimizer: torch.optim.Optimizer) -> None:
    """Carry an optax AdamW state into ``optimizer`` (a
    ``torch.optim.AdamW`` over the tensors of ``params``): the first and
    second moments ``mu`` and ``nu``, trees of arrays shaped as
    ``params``, and the step ``count``.  The two optimizers then take the
    same next step."""
    held = {id(p) for group in optimizer.param_groups for p in group["params"]}

    def walk(m, n, p):
        for k, leaf in p.items():
            if isinstance(leaf, Mapping):
                walk(m[k], n[k], leaf)
                continue
            if id(leaf) not in held:
                raise ValueError(f"parameter {k!r} is not in the optimizer")

            def like(a):
                return torch.from_numpy(np.array(a, dtype=np.float32)).to(
                    device=leaf.device, dtype=leaf.dtype)

            optimizer.state[leaf] = {
                "step": torch.tensor(float(count), dtype=torch.float32),
                "exp_avg": like(m[k]), "exp_avg_sq": like(n[k])}

    walk(mu, nu, params)


def adamw_state_to_optax(params: Mapping[str, Any],
                         optimizer: torch.optim.Optimizer) -> dict:
    """The inverse of :func:`adamw_state_from_optax`: ``optimizer``'s
    state over the tensors of ``params`` as optax's AdamW layout, ``{"mu":
    tree, "nu": tree, "count": int}`` of numpy f32 moments shaped as
    ``params`` (zeros and a count of 0 before the first step)."""
    held = {id(p) for group in optimizer.param_groups for p in group["params"]}
    steps = set()

    def walk(p, key):
        out = {}
        for k, leaf in p.items():
            if isinstance(leaf, Mapping):
                out[k] = walk(leaf, key)
                continue
            if id(leaf) not in held:
                raise ValueError(f"parameter {k!r} is not in the optimizer")
            st = optimizer.state.get(leaf)
            if st:
                steps.add(int(st["step"]))
                out[k] = st[key].detach().float().cpu().numpy()
            else:
                steps.add(0)
                out[k] = np.zeros(tuple(leaf.shape), np.float32)
        return out

    state = {"mu": walk(params, "exp_avg"), "nu": walk(params, "exp_avg_sq")}
    if len(steps) > 1:
        raise ValueError(f"the parameters have taken different step counts "
                         f"{sorted(steps)}")
    state["count"] = steps.pop() if steps else 0
    return state


def net_data_from_numpy(data) -> NetData:
    """The port's :class:`~vit_fpga_tpu_torch.defines.NetData` from any
    object with its fields (the JAX package's ``NetData``, say): the
    shapes, the per-layer f32 weights and biases (copied) and the
    activation codes."""
    return NetData(
        n_ins=int(data.n_ins), n_layers=int(data.n_layers),
        n_p_l=[int(v) for v in data.n_p_l],
        params=[np.array(w, dtype=np.float32) for w in data.params],
        bias=[np.array(b, dtype=np.float32) for b in data.bias],
        activations=[int(a) for a in data.activations]).validate()
