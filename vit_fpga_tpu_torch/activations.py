"""Activation registry of the dense network: the numpy half of the JAX
package's ``activations.py`` (copied; the CPU oracle uses it) and a torch
half in place of its jnp one, with the same per-layer codes."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .defines import (ACT_GELU, ACT_IDENTITY, ACT_RELU2, ACT_SIGMOID,
                      ACT_TANH)


def apply_numpy(code: int, x: np.ndarray) -> np.ndarray:
    if code == ACT_IDENTITY:
        return x
    if code == ACT_RELU2:
        return np.maximum(x, 0.0)
    if code == ACT_GELU:
        # tanh approximation, matching jax.nn.gelu(approximate=True)
        c = np.sqrt(2.0 / np.pi).astype(x.dtype)
        return 0.5 * x * (1.0 + np.tanh(c * (x + 0.044715 * x ** 3)))
    if code == ACT_TANH:
        return np.tanh(x)
    if code == ACT_SIGMOID:
        return 1.0 / (1.0 + np.exp(-x))
    raise ValueError(f"unknown activation code {code}")


def apply_torch(code: int, x: torch.Tensor) -> torch.Tensor:
    """The JAX package's ``apply_jnp``: GELU in the tanh form of
    ``jax.nn.gelu(approximate=True)``."""
    if code == ACT_IDENTITY:
        return x
    if code == ACT_RELU2:
        return torch.clamp_min(x, 0.0)
    if code == ACT_GELU:
        return F.gelu(x, approximate="tanh")
    if code == ACT_TANH:
        return torch.tanh(x)
    if code == ACT_SIGMOID:
        return torch.sigmoid(x)
    raise ValueError(f"unknown activation code {code}")


def derivative_numpy(code: int, x: np.ndarray) -> np.ndarray:
    """d(act)/dx evaluated at pre-activation x — used by the CPU trainer."""
    if code == ACT_IDENTITY:
        return np.ones_like(x)
    if code == ACT_RELU2:
        return (x > 0.0).astype(x.dtype)
    if code == ACT_TANH:
        t = np.tanh(x)
        return 1.0 - t * t
    if code == ACT_SIGMOID:
        s = 1.0 / (1.0 + np.exp(-x))
        return s * (1.0 - s)
    if code == ACT_GELU:
        c = np.sqrt(2.0 / np.pi).astype(x.dtype)
        inner = c * (x + 0.044715 * x ** 3)
        t = np.tanh(inner)
        dinner = c * (1.0 + 3 * 0.044715 * x ** 2)
        return 0.5 * (1.0 + t) + 0.5 * x * (1.0 - t * t) * dinner
    raise ValueError(f"unknown activation code {code}")
