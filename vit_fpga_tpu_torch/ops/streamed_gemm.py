"""The streamed GEMM, K26 (counterpart of the JAX package's
ops/streamed_gemm.py).

``streamed_gemm(x, w)`` is ``(T, K) @ (K, N)`` in x's dtype (f32 or bf16),
every product summed in f32.  The TPU kernel streams the K-tiles of W from
HBM through two VMEM slots, the double-buffered weight stream of BASELINE
config 4; its Hopper kernel (``csrc/streamed_gemm.cu``, replaces
``vit_fpga_tpu/ops/streamed_gemm.py:_streamed_kernel``) streams the
64-deep K-tiles of x and W by TMA through a 4-stage shared-memory ring
into wgmma in bf16 (``csrc/gemm_wgmma.cuh``), and 16-deep ones through two
cp.async slots into FMA tiles in f32.  As in the JAX package, no model
path calls it: it is an op, held against its plain version.

  * :func:`streamed_gemm_plain` -- the JAX kernel's arithmetic: one f32
    product per ``bk``-deep K tile, accumulated in order.
  * :func:`streamed_gemm` -- the wrapper: a CPU tensor runs the plain
    version, a CUDA tensor launches K26 or raises.
"""

from __future__ import annotations

import torch

from . import _kernels
from .common import round_up

_DTYPES = (torch.float32, torch.bfloat16)


def _check(x, w, bk, bt, bn):
    """Shapes, dtypes and tiles as the JAX wrapper takes them: (t, k, n)."""
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"want (T, K) @ (K, N), got {tuple(x.shape)} @ "
                         f"{tuple(w.shape)}")
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise ValueError(f"x and w must both be f32 or both bf16, got "
                         f"{x.dtype} and {w.dtype}")
    for name, v in (("bk", bk), ("bt", bt), ("bn", bn)):
        if v is not None and (not isinstance(v, int) or v < 1):
            raise ValueError(f"{name} must be a positive int, got {v!r}")
    t, k = x.shape
    n = w.shape[1]
    if min(t, k, n) < 1:
        raise ValueError(f"empty product {tuple(x.shape)} @ {tuple(w.shape)}")
    return t, k, n


def streamed_gemm_plain(x: torch.Tensor, w: torch.Tensor, bk: int = 512,
                        bt: int | None = None,
                        bn: int | None = None) -> torch.Tensor:
    """Plain PyTorch version of K26: ``acc += x[:, kt] @ w[kt]`` in f32
    over the ``bk``-deep K tiles in order (the JAX kernel's zero-padded
    last tile adds exact zeros), then rounded to x's dtype.  ``bt`` and
    ``bn`` tile the output only, so no sum depends on them."""
    t, k, n = _check(x, w, bk, bt, bn)
    acc = torch.zeros((t, n), dtype=torch.float32, device=x.device)
    for k0 in range(0, k, bk):
        acc = acc + x[:, k0:k0 + bk].float() @ w[k0:k0 + bk].float()
    return acc.to(x.dtype)


def streamed_gemm(x: torch.Tensor, w: torch.Tensor, bk: int = 512,
                  bt: int | None = None,
                  bn: int | None = None) -> torch.Tensor:
    """(T, K) @ (K, N) -> (T, N) in x's dtype, summed in f32, with the JAX
    signature so that a caller ports.

    A CPU tensor runs :func:`streamed_gemm_plain`; a CUDA tensor launches
    K26 or raises.  ``bk``, ``bt`` and ``bn`` are validated as the JAX
    wrapper's tiles, but the kernel streams its own tiles (64-deep in
    bf16, 16-deep in f32), so on the card they change only the order of
    the f32 sums.  K and N are zero-padded to the kernel's 16-byte copies
    (TMA's row strides in bf16) where they are not multiples of 8 (bf16) or
    4 (f32), which is exact; an operand whose start is not 16-byte aligned
    raises."""
    t, k, n = _check(x, w, bk, bt, bn)
    if x.device.type == "cpu":
        return streamed_gemm_plain(x, w, bk, bt, bn)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if w.device != x.device:
        raise ValueError(f"w is on {w.device}, x on {x.device}")
    align = 8 if x.dtype == torch.bfloat16 else 4
    kp, np_ = round_up(k, align), round_up(n, align)
    x = x.contiguous()
    w = w.contiguous()
    if kp != k:
        x = torch.nn.functional.pad(x, (0, kp - k))
    if kp != k or np_ != n:
        w = torch.nn.functional.pad(w, (0, np_ - n, 0, kp - k))
    out = torch.empty((t, np_), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        lib, stream = _kernels.launch_target()
        err = lib.vft_streamed_gemm(x.data_ptr(), w.data_ptr(),
                                    out.data_ptr(), t, kp, np_,
                                    int(x.dtype == torch.bfloat16), stream)
    _kernels.check(err, "streamed_gemm")
    streamed_gemm.launches += 1
    return out if np_ == n else out[:, :n]


streamed_gemm.launches = 0
