"""Exact multi-head attention on the packed (B, N, 3D) qkv tensor
(counterpart of the JAX package's ops/attention.mha_qkv_xla)."""

from __future__ import annotations

import torch

_NEG_INF = -1e30


def mha_qkv_xla(qkv: torch.Tensor, num_heads: int,
                n_valid: int | None = None) -> torch.Tensor:
    """Max-subtract softmax attention; keys at or past ``n_valid`` are
    masked.  Scores accumulate in f32, the probabilities and the output
    are rounded to the qkv dtype."""
    b, n, d3 = qkv.shape
    d = d3 // 3
    dh = d // num_heads
    q = qkv[..., :d].reshape(b, n, num_heads, dh).float()
    k = qkv[..., d:2 * d].reshape(b, n, num_heads, dh).float()
    v = qkv[..., 2 * d:].reshape(b, n, num_heads, dh).float()
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * (dh ** -0.5)
    if n_valid is not None and n_valid < n:
        mask = torch.arange(n, device=qkv.device) < n_valid
        scores = torch.where(mask[None, None, None, :], scores,
                             torch.full_like(scores, _NEG_INF))
    p = torch.softmax(scores, dim=-1).to(qkv.dtype).float()
    o = torch.einsum("bhqk,bkhd->bqhd", p, v).to(qkv.dtype)
    return o.reshape(b, n, d)
