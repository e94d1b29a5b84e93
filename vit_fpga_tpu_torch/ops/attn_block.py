"""Transformer attention half: LN -> QKV -> masked MHA -> out-proj ->
+residual.

``attn_block_stats`` is the stats-chain attention half.  On a CUDA tensor
it launches the hand-written Hopper kernel in ``csrc/attn_stats.cu``; on a
CPU tensor it runs the plain PyTorch version of the same arithmetic.

Source note (kernel K1):
  * replaces ``vit_fpga_tpu/ops/attn_block.py:_attn_stats_kernel`` with its
    ``_mha_loop`` (wrapper ``attn_block_stats_pallas``);
  * bound on the H100 by tensor-core operations: 8·R·D² flops for the
    projections plus 4·B·H·n_pad·n_valid·dh for scores and PV (about
    68 GFLOP, 69 us at 989 TFLOP/s, at ViT-B/16 batch 64) against about
    44 MB of compulsory traffic;
  * design: a bf16 wmma GEMM that applies the LayerNorm from the
    producer's (mu, rstd) to its A tiles in shared memory and adds the QKV
    bias in its epilogue; one attention block per (image, head) holding
    the head's keys and values, with each warp's 16-row query tile, f32
    scores and bf16 probabilities in shared memory; a second GEMM with
    bias and residual in its epilogue; a per-row reduction for the next
    stats.  qkv and the attention output round-trip through device memory
    (later work: fuse them away, wgmma).

The softmax is the JAX kernels' max-free form, ``exp(clip(s, -70, 80))``
with keys at or past ``n_valid`` masked, which equals the exact softmax of
:func:`vit_fpga_tpu_torch.ops.attention.mha_qkv_xla` while every logit
lies inside the clip window.
"""

from __future__ import annotations

import math

import torch

from . import _kernels
from .attention import mha_qkv_xla
from .common import check_activation, kernel_operand, row_stats

_NEG_INF = -1e30
# max-free softmax clip window (as the JAX kernels)
_EXP_LO, _EXP_HI = -70.0, 80.0


def _mha_maxfree(qkv: torch.Tensor, num_heads: int,
                 n_valid: int) -> torch.Tensor:
    """The JAX kernel's ``_mha_loop`` arithmetic on (B, N, 3D) qkv:
    f32 scores, ``exp(clip(s))`` with masked keys, bf16(e) @ v in f32,
    times 1 / sum(e), rounded to the qkv dtype."""
    b, n, d3 = qkv.shape
    d = d3 // 3
    dh = d // num_heads
    dt = qkv.dtype
    scale = 1.0 / math.sqrt(dh)

    def heads(t):
        return t.reshape(b, n, num_heads, dh).transpose(1, 2)

    q, k, v = heads(qkv[..., :d]), heads(qkv[..., d:2 * d]), \
        heads(qkv[..., 2 * d:])
    # the JAX kernel scales q in its own dtype when that is exact
    # (f32, or a power-of-two scale in bf16), else the f32 scores
    q_scaled = dt != torch.bfloat16 or math.frexp(scale)[0] == 0.5
    if q_scaled:
        q = q * scale
    s = q.float() @ k.float().transpose(-1, -2)
    if not q_scaled:
        s = s * scale
    s = s.clamp(_EXP_LO, _EXP_HI)
    if n_valid < n:
        keep = torch.arange(n, device=qkv.device) < n_valid
        s = torch.where(keep, s, torch.full_like(s, _NEG_INF))
    e = torch.exp(s)
    denom = e.sum(-1, keepdim=True)
    pv = (e.to(dt).float() @ v.float()) * (1.0 / denom)
    return pv.to(dt).transpose(1, 2).reshape(b, n, d)


def _attn_tail(x, xn, wqkv, bqkv, wo, bo, num_heads, n_valid, mha):
    dt = x.dtype
    qkv = (xn.float() @ wqkv.to(dt).float() + bqkv.float()).to(dt)
    ao = mha(qkv, num_heads, n_valid)
    y = ao.float() @ wo.to(dt).float() + bo.float()
    return x + y.to(dt)


def attn_block_xla(x, ln_scale, ln_bias, wqkv, bqkv, wo, bo,
                   num_heads: int, eps: float = 1e-6,
                   n_valid: int | None = None):
    """Reference attention half: two-pass LayerNorm and the exact
    max-subtract softmax (counterpart of the JAX ``attn_block_xla``)."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, unbiased=False, keepdim=True)
    xn = ((xf - mu) * torch.rsqrt(var + eps) * ln_scale.float()
          + ln_bias.float()).to(x.dtype)
    return _attn_tail(x, xn, wqkv, bqkv, wo, bo, num_heads, n_valid,
                      mha_qkv_xla)


def attn_block_stats_plain(x, stats, ln_scale, ln_bias, wqkv, bqkv, wo, bo,
                           num_heads: int, eps: float = 1e-6,
                           n_valid: int | None = None,
                           emit_stats: bool = True):
    """Plain PyTorch version of the K1 kernel (same arithmetic)."""
    n = x.shape[1]
    n_valid = n if n_valid is None else min(n_valid, n)
    xf = x.float()
    xn = ((xf - stats[..., 0:1]) * stats[..., 1:2] * ln_scale.float()
          + ln_bias.float()).to(x.dtype)
    out = _attn_tail(x, xn, wqkv, bqkv, wo, bo, num_heads, n_valid,
                     _mha_maxfree)
    return out, (row_stats(out, eps) if emit_stats else None)


def attn_block_stats(x, stats, ln_scale, ln_bias, wqkv, bqkv, wo, bo,
                     num_heads: int, eps: float = 1e-6,
                     n_valid: int | None = None, emit_stats: bool = True):
    """Stats-chain attention half: (x (B, n_pad, D), stats (B, n_pad, 2)
    f32) -> (out (B, n_pad, D), next stats (B, n_pad, 2) f32 or None).

    Query rows at or past ``n_valid`` are computed (garbage, as on the
    TPU); keys there are masked.  A CPU tensor runs
    :func:`attn_block_stats_plain`; a CUDA tensor launches the kernel
    (bf16 only) or raises."""
    if x.device.type == "cpu":
        return attn_block_stats_plain(x, stats, ln_scale, ln_bias, wqkv,
                                      bqkv, wo, bo, num_heads, eps=eps,
                                      n_valid=n_valid,
                                      emit_stats=emit_stats)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dim() != 3:
        raise ValueError(f"x must be (B, n_pad, D), got {tuple(x.shape)}")
    b, n, d = x.shape
    n_valid = n if n_valid is None else min(n_valid, n)
    if d % num_heads:
        raise ValueError(f"D={d} not divisible by {num_heads} heads")
    dh = d // num_heads
    if dh != 64 or not 1 <= n_valid <= 256:
        raise ValueError(f"kernel takes head dim 64 and 1..256 valid tokens "
                         f"(dh={dh}, n_valid={n_valid})")
    check_activation(x, (b, n, d), torch.bfloat16, "x")
    check_activation(stats, (b, n, 2), torch.float32, "stats")
    dev = x.device
    f32, bf = torch.float32, torch.bfloat16
    ls = kernel_operand(ln_scale, (d,), f32, dev, "ln_scale")
    lb = kernel_operand(ln_bias, (d,), f32, dev, "ln_bias")
    wqkv = kernel_operand(wqkv, (d, 3 * d), bf, dev, "wqkv")
    bqkv = kernel_operand(bqkv, (3 * d,), f32, dev, "bqkv")
    wo = kernel_operand(wo, (d, d), bf, dev, "wo")
    bo = kernel_operand(bo, (d,), f32, dev, "bo")
    out = torch.empty_like(x)
    st_out = (torch.empty((b, n, 2), dtype=f32, device=dev) if emit_stats
              else None)
    qkv = torch.empty((b * n, 3 * d), dtype=bf, device=dev)
    ao = torch.empty((b * n, d), dtype=bf, device=dev)
    with torch.cuda.device(dev):
        lib, stream = _kernels.launch_target()
        err = lib.vft_attn_block_stats(
            x.data_ptr(), stats.data_ptr(), ls.data_ptr(), lb.data_ptr(),
            wqkv.data_ptr(), bqkv.data_ptr(), wo.data_ptr(), bo.data_ptr(),
            out.data_ptr(), st_out.data_ptr() if emit_stats else None,
            qkv.data_ptr(), ao.data_ptr(), b, n, d, num_heads, n_valid,
            float(eps), 1.0 / math.sqrt(dh), stream)
    _kernels.check(err, "attn_block_stats")
    attn_block_stats.launches += 1
    return out, st_out


attn_block_stats.launches = 0
