"""Shared shape and LayerNorm helpers."""

from __future__ import annotations

import torch

# Token rows are padded to a multiple of 8 for both bf16 and f32, the
# padded-residency layout of the JAX package (ViT-B's 197 tokens run on
# 200 rows).  Every site that pads token rows must agree on it.
SUBLANE = 8


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def pad_sublane(dtype: torch.dtype) -> int:
    """Row multiple the token tensor is padded to for this compute dtype."""
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"unsupported compute dtype {dtype}")
    return SUBLANE


def row_stats(x: torch.Tensor, eps: float) -> torch.Tensor:
    """One-pass f32 LayerNorm statistics of each row of ``x``:
    ``[..., 0] = mu``, ``[..., 1] = rsqrt(max(E[x^2] - mu^2, 0) + eps)``
    (the stats the chain's kernels emit and consume)."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf * xf).mean(-1, keepdim=True) - mu * mu).clamp_min(0.0)
    return torch.cat([mu, torch.rsqrt(var + eps)], dim=-1)


def ln_parts(x: torch.Tensor, eps: float):
    """Two-pass f32 LayerNorm of each row of ``x`` (the JAX kernels'
    ``jnp.var``): ``(xhat, rstd)`` with ``xhat = (x - mu) * rstd`` and
    ``rstd = rsqrt(mean((x - mu)^2) + eps)``.  K5, K23 and K24 use this
    form, K1 and K4 the one-pass :func:`row_stats`."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, unbiased=False, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    return (xf - mu) * rstd, rstd


def ln_backward(dxn: torch.Tensor, xhat: torch.Tensor, rstd: torch.Tensor,
                ln_scale: torch.Tensor):
    """LayerNorm backward from the f32 cotangent ``dxn`` of the normalised
    rows: ``(dx_ln, dscale, dbias)``, the arithmetic of the JAX backward
    kernels."""
    dxhat = dxn * ln_scale.float()
    m1 = dxhat.mean(-1, keepdim=True)
    m2 = (dxhat * xhat).mean(-1, keepdim=True)
    dx_ln = (dxhat - m1 - xhat * m2) * rstd
    rows = dxn.reshape(-1, dxn.shape[-1])
    return (dx_ln, (rows * xhat.reshape(rows.shape)).sum(0), rows.sum(0))


def kernel_operand(t: torch.Tensor, shape: tuple, dtype: torch.dtype,
                   device: torch.device, name: str) -> torch.Tensor:
    """A parameter as a kernel takes it: checked shape and device, cast
    to ``dtype`` (as the JAX wrappers' ``astype``), contiguous."""
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, want {shape}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, activations on {device}")
    return t.to(dtype).contiguous()


def check_activation(t: torch.Tensor, shape: tuple, dtype: torch.dtype,
                     name: str) -> None:
    """An activation a kernel reads in place: exact shape, dtype, layout."""
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
        raise ValueError(f"{name}: {tuple(t.shape)} {t.dtype}, "
                         f"want {shape} {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
