"""Fused row-wise int8 linear (counterpart of the JAX package's
ops/quant_fused.py): the dynamic int8 path's head, and the int8 pieces
the block halves share.

One Hopper kernel lives here, behind a wrapper that launches it on a CUDA
tensor and runs its plain PyTorch version (same arithmetic) on a CPU
tensor:

* K14 ``int8_linear_fused`` (``csrc/quant_linear.cu``): replaces
  ``vit_fpga_tpu/ops/quant_fused.py:_fused_kernel`` (wrapper
  ``int8_linear_fused``).  Optional two-pass LayerNorm, per-row absmax
  quantization of the activations, int8 x int8 GEMM accumulated exactly,
  dequantization by row scale x column scale, bias, activation.

Bound on the H100 at the ViT-B/16 head (T = 64 rows, K = 768, N = 1000):
0.1 G int8 operations against the 0.77 MB int8 weight read once, so it
is bound by bytes (about 0.3 us at 3.35 TB/s) and in practice by launch
latency; on the per-linear int8 route at ViT-B/16 @1024 (8208 rows at b2)
by its int8 operations.  Design: a row pass quantizes the activations
into device memory, then the int8 wgmma + TMA GEMM of
``csrc/qgemm_wgmma.cuh`` reads the weight transposed, (N, K)
k-contiguous, and dequantizes and applies the activation in its
epilogue (``QW_ACT``).

The weights are int8 per output column (:func:`quantize_weight_colwise`),
the activations int8 per row with scales computed at run time.  Every
rounding point of the TPU kernel is kept: ``x / s`` is a true division,
``rint`` rounds half to even, the clip stops at -127, the int32 sum is
exact and is scaled as ``acc * (sx * ws) + bias``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import _kernels
from .common import aligned16, check_activation, kernel_operand

QMAX = 127.0

# Activation codes of csrc/common.cuh (enum Act) and csrc/quant.cuh
# (ACT_GELU_TANH_JAX: the textbook tanh-GELU this kernel applies).
_ACT_CODES = {"none": 0, "gelu_tanh": 5, "quick_gelu": 3, "relu": 4}


def quantize_weight_colwise(w) -> tuple[np.ndarray, np.ndarray]:
    """(K, N) f32 -> (int8 (K, N), f32 scales (N,)), symmetric: the JAX
    package's function, bit for bit."""
    w = np.asarray(w, np.float32)
    absmax = np.maximum(np.abs(w).max(axis=0), 1e-12)
    scale = (absmax / QMAX).astype(np.float32)
    q = np.clip(np.rint(w / scale), -QMAX, QMAX).astype(np.int8)
    return q, scale


def _row_quant(xf: torch.Tensor):
    """f32 rows -> (int8 rows, f32 scales (..., 1)): symmetric absmax per
    row, ``clip(rint(x / s), -127, 127)`` (round half to even).  s =
    absmax / 127 divides by a tensor: PyTorch's CUDA kernels divide by a
    Python number through its reciprocal, an ulp away from the kernels'
    true division for some rows."""
    absmax = xf.abs().amax(-1, keepdim=True).clamp_min(1e-12)
    sx = absmax / torch.full_like(absmax, QMAX)
    xq = torch.clamp(torch.round(xf / sx), -QMAX, QMAX).to(torch.int8)
    return xq, sx


def _int_matmul(aq: torch.Tensor, bq: torch.Tensor) -> torch.Tensor:
    """Exact int8 x int8 product as f32, the ``acc.astype(f32)`` of an
    int32 accumulation: the products and sums are integers below 2^53, so
    a float64 matmul holds them exactly on any device (``torch.matmul``
    takes no int8 on CUDA), and the one rounding to f32 is the int32's."""
    return (aq.double() @ bq.double()).float()


def _gelu_tanh_textbook(h: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(approximate=True)``: h * 0.5 (1 + tanh(c (h +
    0.044715 h^3))), not the fma form of the int8 blocks."""
    c = math.sqrt(2.0 / math.pi)
    cdf = 0.5 * (1.0 + torch.tanh(c * (h + 0.044715 * (h * h * h))))
    return h * cdf


def int8_linear_fused_plain(x, wq, ws, bias, act: str = "none",
                            ln_scale=None, ln_bias=None, ln_eps: float = 0.0,
                            out_dtype: torch.dtype = torch.bfloat16):
    """Plain PyTorch version of the K14 kernel (the arithmetic of the
    TPU kernel's body)."""
    xf = x.float()
    if ln_eps > 0.0:
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, unbiased=False, keepdim=True)
        ls = (torch.ones_like(xf[0]) if ln_scale is None
              else ln_scale.float())
        lb = torch.zeros_like(xf[0]) if ln_bias is None else ln_bias.float()
        xf = (xf - mu) * torch.rsqrt(var + ln_eps) * ls + lb
    xq, sx = _row_quant(xf)
    out = _int_matmul(xq, wq) * (sx * ws.float()) + bias.float()
    if act == "gelu_tanh":
        out = _gelu_tanh_textbook(out)
    elif act == "quick_gelu":
        out = out * torch.sigmoid(1.702 * out)
    elif act == "relu":
        out = torch.clamp_min(out, 0.0)
    elif act != "none":
        raise ValueError(act)
    return out.to(out_dtype)


def kmajor(w: torch.Tensor) -> torch.Tensor:
    """A (..., K, N) weight as a view of (..., N, K) contiguous storage,
    the layout the int8 GEMMs read without a copy (one copy, made once)."""
    return w.transpose(-1, -2).contiguous().transpose(-1, -2)


def weight_kmajor(wq: torch.Tensor, shape: tuple, device: torch.device,
                  name: str) -> torch.Tensor:
    """The (..., K, N) int8 weight as the int8 GEMMs read it: (..., N, K)
    contiguous.  A :func:`kmajor` view, as the int8 forwards prepare once,
    passes without a copy."""
    if wq.dtype != torch.int8:
        raise ValueError(f"{name} must be int8, got {wq.dtype}")
    return kernel_operand(wq.transpose(-1, -2),
                          tuple(shape[:-2]) + (shape[-1], shape[-2]),
                          torch.int8, device, name)


def int8_linear_fused(x, wq, ws, bias, act: str = "none", ln_scale=None,
                      ln_bias=None, ln_eps: float = 0.0,
                      out_dtype: torch.dtype = torch.bfloat16):
    """x (T, K) bf16 or f32, wq (K, N) int8, ws and bias (N,) f32 ->
    act(dequant(rowquant([LN](x)) @ wq) + bias) as (T, N) ``out_dtype``
    (bf16 or f32).  ``ln_eps > 0`` runs the two-pass LayerNorm with
    ``ln_scale``/``ln_bias`` first.

    A CPU tensor runs :func:`int8_linear_fused_plain`; a CUDA tensor
    launches the K14 kernel (K a multiple of 16) or raises."""
    if act not in _ACT_CODES:
        raise ValueError(f"unknown act {act!r}")
    if x.device.type == "cpu":
        return int8_linear_fused_plain(x, wq, ws, bias, act=act,
                                       ln_scale=ln_scale, ln_bias=ln_bias,
                                       ln_eps=ln_eps, out_dtype=out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dim() != 2 or x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"x must be (T, K) bf16 or f32, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"unsupported out_dtype {out_dtype}")
    t, k = x.shape
    n = wq.shape[-1]
    if k % 16:
        raise ValueError(f"kernel needs K divisible by 16 (K={k})")
    check_activation(x, (t, k), x.dtype, "x")
    dev = x.device
    f32 = torch.float32
    wt = weight_kmajor(wq, (k, n), dev, "wq")
    ws = aligned16(kernel_operand(ws, (n,), f32, dev, "ws"))
    bias = aligned16(kernel_operand(bias, (n,), f32, dev, "bias"))
    ln = ln_eps > 0.0
    if ln:
        ls = kernel_operand(
            torch.ones((k,), device=dev) if ln_scale is None else ln_scale,
            (k,), f32, dev, "ln_scale")
        lb = kernel_operand(
            torch.zeros((k,), device=dev) if ln_bias is None else ln_bias,
            (k,), f32, dev, "ln_bias")
    out = torch.empty((t, n), dtype=out_dtype, device=dev)
    xq = torch.empty((t, k), dtype=torch.int8, device=dev)
    sx = torch.empty((t,), dtype=f32, device=dev)
    with torch.cuda.device(dev):
        lib, stream = _kernels.launch_target()
        err = lib.vft_int8_linear_fused(
            x.data_ptr(), ls.data_ptr() if ln else None,
            lb.data_ptr() if ln else None, wt.data_ptr(), ws.data_ptr(),
            bias.data_ptr(), out.data_ptr(), xq.data_ptr(), sx.data_ptr(),
            int(x.dtype == f32), 2 if ln else 0, int(out_dtype == f32), t, k,
            n, _ACT_CODES[act], float(ln_eps), stream)
    _kernels.check(err, "int8_linear_fused")
    int8_linear_fused.launches += 1
    return out


int8_linear_fused.launches = 0
