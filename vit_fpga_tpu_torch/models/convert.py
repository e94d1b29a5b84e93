"""Parameter bridge: the JAX package's parameter tree, handed over as
nested dicts of numpy arrays, becomes the port's tree in the same layout
(NHWC images, patch kernel (P*P*3, D) in (py, px, c) order, blocks stacked
on depth, linear weights (in, out))."""

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
