"""Per-tensor int8 datapath of the dense network (counterpart of the JAX
package's ops/quant.py), bit for bit with its numpy oracle.

Quantizer (shared): ``scale = max(absmax, 1e-12) / 127`` per tensor,
``q = clip(rint(x / scale), -127, 127)`` with rint rounding half to even,
zero-point 0.  Int8 linear: ``acc = xq @ wq`` summed exactly in int32, the
bias requantized into the accumulator's scale ``s_out = sx * sw`` as
``clip(rint(b / s_out))`` and added in int32, then ``acc * s_out`` in f32.

Why the card equals the oracle bit for bit: the int8 products and their
int32 sums are exact in any order; ``x / scale``, ``b / s_out``,
``sx * sw`` and ``acc * s_out`` are single IEEE f32 operations rounded to
nearest (PyTorch's division and multiplication are, and no step is fused
into an fma), the conversions int32 -> f32 round to nearest, and rint and
the clips are exact.  So every executor that keeps these rounding points
gets the same bits.

  * ``*_numpy``       -- the oracle (copied; NetCPU and the tests use it).
  * :func:`quantize_torch`, :func:`int8_linear` -- the same functions in
    PyTorch ops, on either device.
  * :func:`int8_gemm` -- the wrapper of K13 (``csrc/int8_gemm.cu``), which
    replaces ``vit_fpga_tpu/ops/quant.py:_int8_gemm_kernel`` (wrapper
    ``int8_gemm_pallas``): a CPU tensor runs :func:`int8_gemm_plain`, a
    CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from . import _kernels
from .common import round_up
from .quant_fused import weight_kmajor

QMAX = 127.0


# ---------------------------------------------------------------------------
# Quantizer: numpy oracle and torch, identical semantics
# ---------------------------------------------------------------------------

def quantize_numpy(x: np.ndarray, axis: Optional[int] = None
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Symmetric int8: returns (q, scale). axis=None -> per-tensor scale."""
    absmax = np.max(np.abs(x), axis=axis, keepdims=axis is not None)
    scale = np.maximum(absmax, 1e-12).astype(np.float32) / QMAX
    q = np.clip(np.rint(x / scale), -QMAX, QMAX).astype(np.int8)
    return q, np.float32(scale)


def quantize_torch(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor :func:`quantize_numpy` of an f32 tensor: (int8 q, f32
    0-dim scale), on ``x``'s device."""
    x = x.float()
    # the divisor is a tensor on x's device: CUDA turns a division by a
    # host scalar into a multiplication by its reciprocal, which is not
    # the oracle's rounding
    qmax = torch.full((), QMAX, dtype=torch.float32, device=x.device)
    scale = x.abs().max().clamp_min(1e-12) / qmax
    q = torch.clamp(torch.round(x / scale), -QMAX, QMAX).to(torch.int8)
    return q, scale


def dequantize(q, scale):
    return q.float() * scale


# ---------------------------------------------------------------------------
# Int8 linear: exact int32 accumulation, then f32 dequant (+bias)
# ---------------------------------------------------------------------------

def int8_linear_numpy(xq: np.ndarray, sx: np.ndarray, wq: np.ndarray,
                      sw: np.ndarray, bias: Optional[np.ndarray] = None
                      ) -> np.ndarray:
    """Oracle: (B, K) int8 @ (K, N) int8 -> f32.

    Fixed-point epilogue: the bias is requantized into the int32
    accumulator scale, added exactly in integer arithmetic, and the result
    is dequantized with one f32 multiply, the only rounded float op.
    """
    s_out = np.float32(np.float32(sx) * np.float32(sw))
    acc = xq.astype(np.int32) @ wq.astype(np.int32)
    if bias is not None:
        bq = np.rint(bias.astype(np.float32) / s_out).astype(np.int64)
        bq = np.clip(bq, -2**31, 2**31 - 1).astype(np.int32)
        acc = acc + bq
    return acc.astype(np.float32) * s_out


def int8_gemm_plain(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K13: the int8 products and their sums are
    integers below 2^53, so a float64 matmul holds them exactly on any
    device (``torch.matmul`` takes no int8 on CUDA)."""
    return (xq.double() @ wq.double()).to(torch.int32)


def _check_gemm(xq: torch.Tensor, wq: torch.Tensor) -> None:
    if xq.dim() != 2 or wq.dim() != 2 or xq.shape[1] != wq.shape[0]:
        raise ValueError(f"int8_gemm: shapes {tuple(xq.shape)} @ "
                         f"{tuple(wq.shape)}")
    if xq.dtype != torch.int8 or wq.dtype != torch.int8:
        raise ValueError(f"int8_gemm takes int8, got {xq.dtype}, "
                         f"{wq.dtype}")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous, with a 16-byte aligned start (the kernel's TMA)."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def int8_gemm(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 @ (K, N) int8 -> (M, N) int32, any M, K and N.

    A CPU tensor runs :func:`int8_gemm_plain`; a CUDA tensor launches K13
    or raises.  The kernel reads ``wq`` as (N, K) k-contiguous storage: a
    :func:`~vit_fpga_tpu_torch.ops.quant_fused.kmajor` view passes without
    a copy.  A K that is not a multiple of 16 (TMA's 16-byte row stride) is
    padded with zeros."""
    _check_gemm(xq, wq)
    if xq.device.type == "cpu":
        return int8_gemm_plain(xq, wq)
    if xq.device.type != "cuda":
        raise ValueError(f"unsupported device {xq.device}")
    m, k = xq.shape
    n = wq.shape[1]
    dev = xq.device
    out = torch.empty((m, n), dtype=torch.int32, device=dev)
    if m == 0 or n == 0:
        return out
    wt = weight_kmajor(wq, (k, n), dev, "wq")          # (N, K)
    kp = max(round_up(k, 16), 16)
    if kp != k:       # zero columns of A and rows of B add exact zeros
        xq = torch.nn.functional.pad(xq, (0, kp - k))
        wt = torch.nn.functional.pad(wt, (0, kp - k))
    xq, wt = _aligned(xq), _aligned(wt)
    with torch.cuda.device(dev):
        lib, stream = _kernels.launch_target()
        err = lib.vft_int8_gemm(xq.data_ptr(), wt.data_ptr(), out.data_ptr(),
                                m, kp, n, stream)
    _kernels.check(err, "int8_gemm")
    int8_gemm.launches += 1
    return out


int8_gemm.launches = 0


def int8_linear(xq: torch.Tensor, sx, wq: torch.Tensor, sw,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(..., K) int8 @ (K, N) int8 -> (..., N) f32 with the oracle's
    fixed-point epilogue (:func:`int8_linear_numpy`), on ``xq``'s device;
    the GEMM is :func:`int8_gemm` (K13 on the card)."""
    dev = xq.device
    sx = torch.as_tensor(sx, dtype=torch.float32, device=dev)
    sw = torch.as_tensor(sw, dtype=torch.float32, device=dev)
    s_out = sx * sw
    shape = xq.shape
    acc = int8_gemm(xq.reshape(-1, shape[-1]), wq)
    acc = acc.reshape(*shape[:-1], wq.shape[1])
    if bias is not None:
        bq = torch.round(bias.to(device=dev, dtype=torch.float32) / s_out)
        bq = bq.to(torch.int64).clamp(-2**31, 2**31 - 1).to(torch.int32)
        acc = acc + bq
    return acc.float() * s_out
