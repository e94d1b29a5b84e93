"""Transformer MLP half: LN -> W1 -> act -> W2 -> +residual.

``fused_mlp_stats`` is the stats-chain MLP half.  On a CUDA tensor it
launches the hand-written Hopper kernel in ``csrc/mlp_stats.cu``; on a CPU
tensor it runs the plain PyTorch version of the same arithmetic.

Source note (kernel K2):
  * replaces ``vit_fpga_tpu/ops/fused_mlp.py:_mlp_stats_kernel`` (its
    wrapper ``fused_mlp_stats_pallas``);
  * bound on the H100 by tensor-core operations: 4·T·D·M flops (about
    121 GFLOP, 122 us at 989 TFLOP/s, at ViT-B/16 batch 64) against about
    49 MB of compulsory traffic;
  * design: two bf16 wmma GEMMs with f32 accumulation; the LayerNorm is
    applied from the producer's (mu, rstd) to the first GEMM's A tiles in
    shared memory, the activation runs in that GEMM's epilogue, bias and
    residual in the second's, and a per-row reduction emits the next
    stats.  The (T, M) hidden tensor round-trips through device memory
    (later work).

Semantics follow the JAX kernel: f32 LayerNorm from the stats, bf16
GEMMs with f32 accumulation, activation in f32, residual add in the
input dtype, one-pass f32 stats of the output.
"""

from __future__ import annotations

import math

import torch

from . import _kernels
from .common import check_activation, kernel_operand, row_stats

# Activation codes of csrc/common.cuh (enum Act).
_ACT_CODES = {"gelu": 1, "gelu_tanh": 2, "quick_gelu": 3, "relu": 4}


def _act(h: torch.Tensor, kind: str) -> torch.Tensor:
    """Activation on f32 ``h``."""
    if kind == "gelu":
        return 0.5 * h * (1.0 + torch.erf(h * (1.0 / math.sqrt(2.0))))
    if kind == "gelu_tanh":
        # tanh-GELU in the JAX kernel's fma form: u = h*(A + B*h^2),
        # 0.5h + 0.5h*tanh(u)
        h2 = h * h
        u = h * (0.7978845608028654 + 0.035677408136300125 * h2)
        hh = 0.5 * h
        return hh + hh * torch.tanh(u)
    if kind == "quick_gelu":
        return h * torch.sigmoid(1.702 * h)
    if kind == "relu":
        return torch.clamp_min(h, 0.0)
    raise ValueError(kind)


def _mlp_tail(x, xn, w1, b1, w2, b2, act):
    """x + bf16(act(xn @ W1 + b1) @ W2 + b2) with f32 accumulation."""
    dt = x.dtype
    h = xn.float() @ w1.to(dt).float() + b1.float()
    h = _act(h, act).to(dt)
    y = h.float() @ w2.to(dt).float() + b2.float()
    return x + y.to(dt)


def fused_mlp_xla(x, ln_scale, ln_bias, w1, b1, w2, b2, eps: float = 1e-6,
                  act: str = "gelu"):
    """Reference MLP half with the two-pass LayerNorm (counterpart of the
    JAX package's ``fused_mlp_xla``)."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, unbiased=False, keepdim=True)
    xn = ((xf - mu) * torch.rsqrt(var + eps) * ln_scale.float()
          + ln_bias.float()).to(x.dtype)
    return _mlp_tail(x, xn, w1, b1, w2, b2, act)


def fused_mlp_stats_plain(x, stats, ln_scale, ln_bias, w1, b1, w2, b2,
                          eps: float = 1e-6, act: str = "gelu",
                          emit_stats: bool = True):
    """Plain PyTorch version of the K2 kernel (same arithmetic)."""
    xf = x.float()
    xn = ((xf - stats[:, 0:1]) * stats[:, 1:2] * ln_scale.float()
          + ln_bias.float()).to(x.dtype)
    out = _mlp_tail(x, xn, w1, b1, w2, b2, act)
    return out, (row_stats(out, eps) if emit_stats else None)


def fused_mlp_stats(x, stats, ln_scale, ln_bias, w1, b1, w2, b2,
                    eps: float = 1e-6, act: str = "gelu",
                    emit_stats: bool = True):
    """Stats-chain MLP half: (x (T, D), stats (T, 2) f32) ->
    (out (T, D), next stats (T, 2) f32 or None).

    A CPU tensor runs :func:`fused_mlp_stats_plain`; a CUDA tensor
    launches the kernel (bf16 only) or raises."""
    if act not in _ACT_CODES:
        raise ValueError(f"unknown act {act!r}")
    if x.device.type == "cpu":
        return fused_mlp_stats_plain(x, stats, ln_scale, ln_bias, w1, b1, w2,
                                     b2, eps=eps, act=act,
                                     emit_stats=emit_stats)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dim() != 2:
        raise ValueError(f"x must be (T, D), got {tuple(x.shape)}")
    t, d = x.shape
    m = w1.shape[-1]
    if d % 32 or m % 32:
        raise ValueError(f"kernel needs D and M divisible by 32 (D={d}, "
                         f"M={m})")
    check_activation(x, (t, d), torch.bfloat16, "x")
    check_activation(stats, (t, 2), torch.float32, "stats")
    dev = x.device
    f32, bf = torch.float32, torch.bfloat16
    ls = kernel_operand(ln_scale, (d,), f32, dev, "ln_scale")
    lb = kernel_operand(ln_bias, (d,), f32, dev, "ln_bias")
    w1 = kernel_operand(w1, (d, m), bf, dev, "w1")
    b1 = kernel_operand(b1, (m,), f32, dev, "b1")
    w2 = kernel_operand(w2, (m, d), bf, dev, "w2")
    b2 = kernel_operand(b2, (d,), f32, dev, "b2")
    out = torch.empty_like(x)
    st_out = (torch.empty((t, 2), dtype=f32, device=dev) if emit_stats
              else None)
    hidden = torch.empty((t, m), dtype=bf, device=dev)
    with torch.cuda.device(dev):
        lib, stream = _kernels.launch_target()
        err = lib.vft_fused_mlp_stats(
            x.data_ptr(), stats.data_ptr(), ls.data_ptr(), lb.data_ptr(),
            w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
            out.data_ptr(), st_out.data_ptr() if emit_stats else None,
            hidden.data_ptr(), t, d, m, _ACT_CODES[act], float(eps), stream)
    _kernels.check(err, "fused_mlp_stats")
    fused_mlp_stats.launches += 1
    return out, st_out


fused_mlp_stats.launches = 0
