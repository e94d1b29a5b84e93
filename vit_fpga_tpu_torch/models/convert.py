"""Parameter bridge: the JAX package's parameter tree, handed over as
nested dicts of numpy arrays, becomes the port's tree in the same layout
(NHWC images, patch kernel (P*P*3, D) in (py, px, c) order, blocks stacked
on depth, linear weights (in, out)), and back; and an optax AdamW state,
handed over the same way, becomes a torch AdamW state."""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from ..utils.platform import resolve_device


def params_from_numpy(tree: Mapping[str, Any], device=None,
                      dtype: torch.dtype = torch.float32) -> dict:
    """Nested dicts of array-likes -> nested dicts of ``dtype`` tensors
    on ``device`` (CUDA unless ``"cpu"``)."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, Mapping):
            return {k: conv(v) for k, v in node.items()}
        arr = np.asarray(node, dtype=np.float32)
        return torch.from_numpy(arr.copy()).to(device=dev, dtype=dtype)

    return conv(tree)


def params_to_numpy(tree: Mapping[str, Any]) -> dict:
    """Nested dicts of tensors -> nested dicts of f32 numpy arrays (the
    inverse of :func:`params_from_numpy`)."""
    return {k: (params_to_numpy(v) if isinstance(v, Mapping)
                else v.detach().float().cpu().numpy())
            for k, v in tree.items()}


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
