"""Transformer MLP half: LN -> W1 -> act -> W2 -> +residual, and its
backward.

Five Hopper kernels live here, each behind a wrapper that launches it on
a CUDA tensor and runs its plain PyTorch version (same arithmetic) on a
CPU tensor:

* K2 ``fused_mlp_stats`` (``csrc/mlp_stats.cu``), the stats-chain half
  that serving runs: replaces ``vit_fpga_tpu/ops/fused_mlp.py:
  _mlp_stats_kernel``;
* K3 ``fused_mlp_chunked_stats`` (``csrc/mlp_chunk_stats.cu``), the
  stats-chain half of the big-weight geometries (the ViT-L family below
  32 768 token rows, ViT-B in f32): replaces ``_mlp_chunk_stats_kernel``
  (wrapper ``fused_mlp_chunked_stats_pallas``), K2 whose output is
  accumulated over column chunks of M and rounded to the input dtype at
  every chunk boundary, b2 added on the last chunk only;
* K5 ``fused_mlp_fwd`` (``csrc/mlp.cu``), the per-block half: replaces
  ``_mlp_kernel`` (wrapper ``fused_mlp_pallas``), K2 with two-pass LN
  statistics computed in the kernel and no stats output; its plain
  version is :func:`fused_mlp_xla`;
* K24 ``fused_mlp_bwd`` (``csrc/mlp_bwd.cu``), K5's backward: replaces
  ``_mlp_bwd_with_b1_kernel`` (wrapper ``fused_mlp_bwd_pallas``);
* K6 ``fused_mlp_chunked_fwd`` (``csrc/mlp_chunk.cu``), the per-block half
  of the big-weight geometries under ``mlp_impl="pallas"`` (ViT-L: 2
  chunks, ViT-H: 4): replaces ``_mlp_chunk_kernel`` over the chunk loop of
  ``fused_mlp_chunked_pallas``, K3 with two-pass LN statistics computed in
  the kernel and no stats output (a row pass, then K3's two launches on
  ``csrc/gemm_wgmma.cuh``).  ``fused_mlp_chunked``
  (``FusedMLPChunkedFunction``) is its differentiable form, whose backward
  is the VJP of :func:`fused_mlp_xla`, as the JAX ``custom_vjp``.

``fused_mlp`` is the differentiable half (``FusedMLPFunction``): K5
forward, K24 backward, saving only the inputs, as the JAX ``custom_vjp``.

Bounds on the H100 at ViT-B/16 batch 64 (T = 12 800 rows, D = 768,
M = 3072), all set by tensor-core operations at 989 TFLOP/s: K2 and K5
4·T·D·M flops (121 GFLOP, 122 us) against about 49 MB of compulsory
traffic; K24 10·T·D·M (302 GFLOP, 305 us) against under 100 MB.  K3 at
CLIP ViT-L/14 batch 64 (T = 16 896, D = 1024, M = 4096): 4·T·D·M
(283 GFLOP, 287 us), also bound by operations; K6 at ViT-L/16 batch 8
(T = 1 600): 26.8 GFLOP, 27 us.  (989 TFLOP/s is the
H100 SXM's dense bf16 peak at its 700 W limit.)
Designs: K2, K3, K5 and K6 on the wgmma + TMA GEMM of ``csrc/gemm_wgmma.cuh``
(a producer warpgroup streaming tiles into a shared-memory ring, two
consumer warpgroups, the LayerNorm applied to the landed A tiles, the
activation and residual in the epilogue; K5 first takes its two-pass
statistics in a row pass, K6 likewise before K3's launches; K3's and K6's
down-projection runs the epilogue at each chunk boundary inside the K
loop); K24 on the same GEMM in the backward's
layouts (the weight read K-major for the data gradients, the activation
read MN-major for the weight gradients, which split their token rows over
the card and add the f32 partials in a fixed order), act and act' from
their closed forms in the h GEMM's epilogue, every bias and LN gradient a
fixed-order column sum.  The (T, M) hidden tensors round-trip through
device memory (later work).

Semantics follow the JAX kernels: f32 LayerNorm, bf16 GEMMs with f32
accumulation, activation in f32, residual add in the input dtype.

K2 and K3 also run in f32 (the f32 forward's stats chain), as one launch
``vft_fused_mlp_stats_f32`` (``csrc/mlp_chunk_stats.cu``): true f32 fma on
the CUDA cores, no TF32 and no tensor-core instruction, both products on
``csrc/gemm_f32.cuh`` (the LN applied as x lands, bias and activation in
the up-projection's epilogue, the residual added at each of K3's chunk
boundaries), the next stats from the output's own f32 values.  Bound at
ViT-B/16 b64: 4·T·D·M = 242 GFLOP at 67 TFLOP/s, 3.6 ms.  K5, K6 and K24
take bf16 only and raise a ValueError on f32, naming themselves (their
f32 modes are not ported yet).
"""

from __future__ import annotations

import math

import torch

from ..utils.platform import tanh_plain
from . import _kernels
from .common import (check_activation, kernel_operand, ln_backward, ln_parts,
                     row_stats)

# Activation codes of csrc/common.cuh (enum Act).
_ACT_CODES = {"gelu": 1, "gelu_tanh": 2, "quick_gelu": 3, "relu": 4}


def _act(h: torch.Tensor, kind: str) -> torch.Tensor:
    """Activation on f32 ``h``."""
    if kind == "gelu":
        return 0.5 * h * (1.0 + torch.erf(h * (1.0 / math.sqrt(2.0))))
    if kind == "gelu_tanh":
        # tanh-GELU in the JAX kernel's fma form: u = h*(A + B*h^2),
        # 0.5h + 0.5h*tanh(u); tanh_plain keeps MKL VML off the CPU
        h2 = h * h
        u = h * (0.7978845608028654 + 0.035677408136300125 * h2)
        hh = 0.5 * h
        return hh + hh * tanh_plain(u)
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


def _launch_stats_half(entry, multiple, x, stats, ln_scale, ln_bias, w1, b1,
                       w2, b2, eps, act, emit_stats, n_chunks=1):
    """Checks and launches the stats-chain MLP half on CUDA tensors: (out,
    next stats or None).  bf16 runs ``entry`` of the library (K2
    ``vft_fused_mlp_stats``, D and M multiples of 8, or K3
    ``vft_fused_mlp_chunked_stats`` with its ``n_chunks``, of 32); f32
    runs ``vft_fused_mlp_stats_f32``, K2's (one chunk) and K3's f32 launch
    alike (true f32 fma on the CUDA cores)."""
    if x.dim() != 2:
        raise ValueError(f"x must be (T, D), got {tuple(x.shape)}")
    t, d = x.shape
    m = w1.shape[-1]
    if d % multiple or m % multiple:
        raise ValueError(f"{entry} needs D and M divisible by {multiple} "
                         f"(D={d}, M={m})")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{entry} takes bf16 or f32 on the card, got "
                         f"{x.dtype}")
    dt = x.dtype
    check_activation(x, (t, d), dt, "x")
    check_activation(stats, (t, 2), torch.float32, "stats")
    dev = x.device
    f32 = torch.float32
    ls = kernel_operand(ln_scale, (d,), f32, dev, "ln_scale")
    lb = kernel_operand(ln_bias, (d,), f32, dev, "ln_bias")
    w1 = kernel_operand(w1, (d, m), dt, dev, "w1")
    b1 = kernel_operand(b1, (m,), f32, dev, "b1")
    w2 = kernel_operand(w2, (m, d), dt, dev, "w2")
    b2 = kernel_operand(b2, (d,), f32, dev, "b2")
    out = torch.empty_like(x)
    st_out = (torch.empty((t, 2), dtype=f32, device=dev) if emit_stats
              else None)
    hidden = torch.empty((t, m), dtype=dt, device=dev)
    if dt == f32:
        entry, gate = "vft_fused_mlp_stats_f32", (n_chunks,)
    else:
        gate = (n_chunks,) if n_chunks > 1 else ()
    with torch.cuda.device(dev):
        lib, stream = _kernels.launch_target()
        err = getattr(lib, entry)(
            x.data_ptr(), stats.data_ptr(), ls.data_ptr(), lb.data_ptr(),
            w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
            out.data_ptr(), st_out.data_ptr() if emit_stats else None,
            hidden.data_ptr(), t, d, m, *gate, _ACT_CODES[act], float(eps),
            stream)
    _kernels.check(err, entry)
    return out, st_out


def fused_mlp_stats(x, stats, ln_scale, ln_bias, w1, b1, w2, b2,
                    eps: float = 1e-6, act: str = "gelu",
                    emit_stats: bool = True):
    """Stats-chain MLP half: (x (T, D), stats (T, 2) f32) ->
    (out (T, D), next stats (T, 2) f32 or None).

    A CPU tensor runs :func:`fused_mlp_stats_plain`; a CUDA tensor
    launches the kernel (bf16, or f32 on the CUDA cores; D and M multiples
    of 8; an f32 launch is also counted in ``launches_f32``) or raises."""
    if act not in _ACT_CODES:
        raise ValueError(f"unknown act {act!r}")
    if x.device.type == "cpu":
        return fused_mlp_stats_plain(x, stats, ln_scale, ln_bias, w1, b1, w2,
                                     b2, eps=eps, act=act,
                                     emit_stats=emit_stats)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    res = _launch_stats_half("vft_fused_mlp_stats", 8, x, stats, ln_scale,
                             ln_bias, w1, b1, w2, b2, eps, act, emit_stats)
    fused_mlp_stats.launches += 1
    fused_mlp_stats.launches_f32 += int(x.dtype == torch.float32)
    return res


fused_mlp_stats.launches = 0
fused_mlp_stats.launches_f32 = 0      # of those, in f32


# ---------------------------------------------------------------------------
# K3: the stats-chain MLP half over column chunks of M
# ---------------------------------------------------------------------------

# The JAX package's MLP plan arithmetic (``fused_mlp.py:413-432`` and the
# raised-plan row threshold of ``models/vit.py:_stats_chain_mlp_vmem``),
# copied: it decides which function the stats chain computes (K2, or K3
# with its bf16 rounding at every chunk boundary), so the port follows it
# to compute what the JAX package computes.
MLP_BIG_WEIGHT_LIMIT = 20 * 1024 * 1024
MLP_CHUNK_BUDGET = 11 * 1024 * 1024
MLP_BIG_ROWS = 32768


def mlp_fits_raised(d: int, m: int, itemsize: int) -> bool:
    """True when w1 + w2 exceed the default budget but fit the JAX
    package's raised plan (its unchunked kernel, K2's function)."""
    return 2 * d * m * itemsize <= MLP_BIG_WEIGHT_LIMIT


def mlp_weight_chunks(d: int, m: int, itemsize: int) -> int:
    """Smallest power-of-two chunk count whose per-chunk weights fit the
    JAX package's budget; 1 = unchunked, 0 = none up to 16."""
    n = 1
    while n <= 16:
        if 2 * d * (m // n) * itemsize <= MLP_CHUNK_BUDGET and m % n == 0:
            return n
        n *= 2
    return 0


def fused_mlp_chunked_stats_plain(x, stats, ln_scale, ln_bias, w1, b1, w2,
                                  b2, eps: float = 1e-6, act: str = "gelu",
                                  n_chunks: int = 2,
                                  emit_stats: bool = True):
    """Plain PyTorch version of the K3 kernel (the JAX
    ``fused_mlp_chunked_stats_pallas``): every chunk normalises the INPUT
    x from its stats, runs its M/n_chunks columns of W1 and rows of W2,
    and adds bf16(y) to the running output in x's dtype; b2 rides the
    last chunk only."""
    m = w1.shape[-1]
    if n_chunks < 1 or m % n_chunks:
        raise ValueError(f"M={m} does not split into {n_chunks} chunks")
    mc = m // n_chunks
    dt = x.dtype
    xn = ((x.float() - stats[:, 0:1]) * stats[:, 1:2] * ln_scale.float()
          + ln_bias.float()).to(dt).float()
    w1f, w2f, b1f = w1.to(dt).float(), w2.to(dt).float(), b1.float()
    acc = x
    for c in range(n_chunks):
        cols = slice(c * mc, (c + 1) * mc)
        h = _act(xn @ w1f[:, cols] + b1f[cols], act).to(dt)
        y = h.float() @ w2f[cols]
        if c == n_chunks - 1:
            y = y + b2.float()
        acc = acc + y.to(dt)            # the chunk boundary's rounding
    return acc, (row_stats(acc, eps) if emit_stats else None)


def fused_mlp_chunked_stats(x, stats, ln_scale, ln_bias, w1, b1, w2, b2,
                            eps: float = 1e-6, act: str = "gelu",
                            n_chunks: int = 2, emit_stats: bool = True):
    """Stats-chain MLP half over ``n_chunks`` column chunks of M (K3):
    (x (T, D), stats (T, 2) f32) -> (out (T, D), next stats (T, 2) f32 or
    None).

    A CPU tensor runs :func:`fused_mlp_chunked_stats_plain`; a CUDA tensor
    launches the kernel (bf16, or f32 on the CUDA cores; D and M multiples
    of 32, n_chunks 2 or 4, M a multiple of 32 * n_chunks; an f32 launch
    is also counted in ``launches_f32``) or raises."""
    if act not in _ACT_CODES:
        raise ValueError(f"unknown act {act!r}")
    if x.device.type == "cpu":
        return fused_mlp_chunked_stats_plain(
            x, stats, ln_scale, ln_bias, w1, b1, w2, b2, eps=eps, act=act,
            n_chunks=n_chunks, emit_stats=emit_stats)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    m = w1.shape[-1]
    if n_chunks not in (2, 4) or m % (32 * n_chunks):
        raise ValueError(f"kernel takes n_chunks 2 or 4 and M a multiple of "
                         f"32 * n_chunks (M={m}, n_chunks={n_chunks})")
    res = _launch_stats_half("vft_fused_mlp_chunked_stats", 32, x, stats,
                             ln_scale, ln_bias, w1, b1, w2, b2, eps, act,
                             emit_stats, n_chunks)
    fused_mlp_chunked_stats.launches += 1
    fused_mlp_chunked_stats.launches_f32 += int(x.dtype == torch.float32)
    return res


fused_mlp_chunked_stats.launches = 0
fused_mlp_chunked_stats.launches_f32 = 0   # of those, in f32


# ---------------------------------------------------------------------------
# K6: the per-block MLP half over column chunks of M
# ---------------------------------------------------------------------------

def fused_mlp_chunked_plain(x, ln_scale, ln_bias, w1, b1, w2, b2,
                            eps: float = 1e-6, act: str = "gelu",
                            n_chunks: int = 2):
    """Plain PyTorch version of the K6 kernel (the JAX
    ``fused_mlp_chunked_pallas`` over its ``_mlp_chunk_kernel``): every
    chunk takes the two-pass LayerNorm of the INPUT x, runs its
    M/n_chunks columns of W1 and rows of W2, and adds bf16(y) to the
    running output in x's dtype; b2 rides the last chunk only."""
    m = w1.shape[-1]
    if n_chunks < 1 or m % n_chunks:
        raise ValueError(f"M={m} does not split into {n_chunks} chunks")
    mc = m // n_chunks
    dt = x.dtype
    xhat, _ = ln_parts(x, eps)
    xn = (xhat * ln_scale.float() + ln_bias.float()).to(dt).float()
    w1f, w2f, b1f = w1.to(dt).float(), w2.to(dt).float(), b1.float()
    acc = x
    for c in range(n_chunks):
        cols = slice(c * mc, (c + 1) * mc)
        h = _act(xn @ w1f[:, cols] + b1f[cols], act).to(dt)
        y = h.float() @ w2f[cols]
        if c == n_chunks - 1:
            y = y + b2.float()
        acc = acc + y.to(dt)            # the chunk boundary's rounding
    return acc


def fused_mlp_chunked_fwd(x, ln_scale, ln_bias, w1, b1, w2, b2,
                          eps: float = 1e-6, act: str = "gelu",
                          n_chunks: int = 2):
    """Per-block MLP half over ``n_chunks`` column chunks of M (K6):
    x (T, D) -> x + MLP(LN(x)) with the running output rounded to x's
    dtype at every chunk boundary.  A CPU tensor runs
    :func:`fused_mlp_chunked_plain`; a CUDA tensor launches the kernel
    (bf16, D a multiple of 32, n_chunks 2 or 4, M a multiple of
    32 * n_chunks) or raises."""
    if act not in _ACT_CODES:
        raise ValueError(f"unknown act {act!r}")
    if x.device.type == "cpu":
        return fused_mlp_chunked_plain(x, ln_scale, ln_bias, w1, b1, w2, b2,
                                       eps=eps, act=act, n_chunks=n_chunks)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    t, d, m = _cuda_geometry(x, w1, kernel="K6 fused_mlp_chunked_fwd")
    if n_chunks not in (2, 4) or m % (32 * n_chunks):
        raise ValueError(f"kernel takes n_chunks 2 or 4 and M a multiple of "
                         f"32 * n_chunks (M={m}, n_chunks={n_chunks})")
    dev = x.device
    f32, bf = torch.float32, torch.bfloat16
    ls = kernel_operand(ln_scale, (d,), f32, dev, "ln_scale")
    lb = kernel_operand(ln_bias, (d,), f32, dev, "ln_bias")
    w1 = kernel_operand(w1, (d, m), bf, dev, "w1")
    b1 = kernel_operand(b1, (m,), f32, dev, "b1")
    w2 = kernel_operand(w2, (m, d), bf, dev, "w2")
    b2 = kernel_operand(b2, (d,), f32, dev, "b2")
    out = torch.empty_like(x)
    stats = torch.empty((t, 2), dtype=f32, device=dev)
    hidden = torch.empty((t, m), dtype=bf, device=dev)
    with torch.cuda.device(dev):
        lib, stream = _kernels.launch_target()
        err = lib.vft_fused_mlp_chunked(
            x.data_ptr(), ls.data_ptr(), lb.data_ptr(), w1.data_ptr(),
            b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), out.data_ptr(),
            stats.data_ptr(), hidden.data_ptr(), t, d, m, n_chunks,
            _ACT_CODES[act], float(eps), stream)
    _kernels.check(err, "fused_mlp_chunked")
    fused_mlp_chunked_fwd.launches += 1
    return out


fused_mlp_chunked_fwd.launches = 0


class FusedMLPChunkedFunction(torch.autograd.Function):
    """K6 forward, the VJP of :func:`fused_mlp_xla` backward (the JAX
    ``fused_mlp_chunked`` custom VJP: rematerialised, saving only the
    inputs); each gradient comes back in its primal's dtype."""

    @staticmethod
    def forward(ctx, x, ln_scale, ln_bias, w1, b1, w2, b2, eps, act,
                n_chunks):
        ctx.save_for_backward(x, ln_scale, ln_bias, w1, b1, w2, b2)
        ctx.hyper = (eps, act)
        return fused_mlp_chunked_fwd(x, ln_scale, ln_bias, w1, b1, w2, b2,
                                     eps=eps, act=act, n_chunks=n_chunks)

    @staticmethod
    def backward(ctx, g):
        prims = ctx.saved_tensors
        eps, act = ctx.hyper
        with torch.enable_grad():
            leaves = [p.detach().requires_grad_(True) for p in prims]
            out = fused_mlp_xla(*leaves, eps=eps, act=act)
            grads = torch.autograd.grad(out, leaves, g)
        return tuple(grads) + (None, None, None)


def fused_mlp_chunked(x, ln_scale, ln_bias, w1, b1, w2, b2, eps: float,
                      act: str, n_chunks: int):
    """Differentiable chunked MLP half (counterpart of the JAX
    ``fused_mlp_chunked``): K6 forward on the card, its plain version on
    the CPU, the XLA-reference VJP backward."""
    return FusedMLPChunkedFunction.apply(x, ln_scale, ln_bias, w1, b1, w2,
                                         b2, eps, act, n_chunks)


# ---------------------------------------------------------------------------
# K5 (per-block forward) and K24 (its backward)
# ---------------------------------------------------------------------------

def _cuda_geometry(x, w1, multiple=32, kernel="K5 / K6 / K24"):
    """Shape checks shared by the K5 / K6 / K24 launches: (t, d, m).  K5's
    wgmma GEMMs take D and M multiples of 8 (TMA's 16-byte strides); K6's
    gate (the TPU kernel's chunk tiling) and K24's launch multiples of
    32.  All three take bf16: their f32 modes are not ported yet, and an
    f32 tensor raises naming ``kernel``."""
    if x.dtype == torch.float32:
        raise ValueError(
            f"{kernel} takes bf16 on the card; its f32 mode is not ported "
            f"yet (ROADMAP.md, section 1 item 2c)")
    if x.dim() != 2:
        raise ValueError(f"x must be (T, D), got {tuple(x.shape)}")
    t, d = x.shape
    m = w1.shape[-1]
    if d % multiple or m % multiple:
        raise ValueError(f"kernel needs D and M divisible by {multiple} "
                         f"(D={d}, M={m})")
    check_activation(x, (t, d), torch.bfloat16, "x")
    return t, d, m


def fused_mlp_fwd(x, ln_scale, ln_bias, w1, b1, w2, b2, eps: float = 1e-6,
                  act: str = "gelu", residual: bool = True):
    """Per-block MLP half (K5): x (T, D) -> x + MLP(LN(x)).  A CPU tensor
    runs :func:`fused_mlp_xla`, the same arithmetic; a CUDA tensor
    launches the kernel (bf16, D and M multiples of 8) or raises."""
    if not residual:
        raise NotImplementedError(
            "residual=False (the tensor-parallel partial) comes with the "
            "multi-device port")
    if act not in _ACT_CODES:
        raise ValueError(f"unknown act {act!r}")
    if x.device.type == "cpu":
        return fused_mlp_xla(x, ln_scale, ln_bias, w1, b1, w2, b2, eps=eps,
                             act=act)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    t, d, m = _cuda_geometry(x, w1, 8, kernel="K5 fused_mlp_fwd")
    dev = x.device
    f32, bf = torch.float32, torch.bfloat16
    ls = kernel_operand(ln_scale, (d,), f32, dev, "ln_scale")
    lb = kernel_operand(ln_bias, (d,), f32, dev, "ln_bias")
    w1 = kernel_operand(w1, (d, m), bf, dev, "w1")
    b1 = kernel_operand(b1, (m,), f32, dev, "b1")
    w2 = kernel_operand(w2, (m, d), bf, dev, "w2")
    b2 = kernel_operand(b2, (d,), f32, dev, "b2")
    out = torch.empty_like(x)
    stats = torch.empty((t, 2), dtype=f32, device=dev)
    hidden = torch.empty((t, m), dtype=bf, device=dev)
    with torch.cuda.device(dev):
        lib, stream = _kernels.launch_target()
        err = lib.vft_fused_mlp(
            x.data_ptr(), ls.data_ptr(), lb.data_ptr(), w1.data_ptr(),
            b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), out.data_ptr(),
            stats.data_ptr(), hidden.data_ptr(), t, d, m, _ACT_CODES[act],
            float(eps), stream)
    _kernels.check(err, "fused_mlp_fwd")
    fused_mlp_fwd.launches += 1
    return out


fused_mlp_fwd.launches = 0


def _act_and_grad(h: torch.Tensor, kind: str):
    """act(h), act'(h) on f32 ``h`` in the closed forms of the JAX
    ``_act_and_grad``; ``"gelu"`` (erf, the f32 path) with its own
    derivative."""
    if kind == "gelu":
        cdf = 0.5 * (1.0 + torch.erf(h * (1.0 / math.sqrt(2.0))))
        return h * cdf, cdf + h * torch.exp(-0.5 * h * h) / math.sqrt(
            2.0 * math.pi)
    if kind == "gelu_tanh":
        c = 0.7978845608028654
        t = tanh_plain(c * (h + 0.044715 * h * h * h))
        return (0.5 * h * (1.0 + t),
                0.5 * (1.0 + t)
                + 0.5 * h * (1.0 - t * t) * c * (1.0 + 3 * 0.044715 * h * h))
    if kind == "quick_gelu":
        s = torch.sigmoid(1.702 * h)
        return h * s, s * (1.0 + 1.702 * h * (1.0 - s))
    if kind == "relu":
        return torch.clamp_min(h, 0.0), (h > 0).to(h.dtype)
    raise ValueError(kind)


def fused_mlp_bwd_plain(x, ln_scale, ln_bias, w1, b1, w2, g,
                        eps: float = 1e-6, act: str = "gelu_tanh"):
    """Plain PyTorch version of the K24 kernel, the arithmetic of the JAX
    ``_mlp_bwd_with_b1_kernel``: returns
    ``(dx, dls, dlb, dw1, db1, dw2, db2)``, dx in x's dtype, the rest
    f32."""
    dt = x.dtype
    xhat, rstd = ln_parts(x, eps)
    xn = (xhat * ln_scale.float() + ln_bias.float()).to(dt).float()
    w1f, w2f = w1.to(dt).float(), w2.to(dt).float()
    h = xn @ w1f + b1.float()
    a, dact = _act_and_grad(h, act)
    a = a.to(dt).float()
    gf = g.to(dt).float()
    dh = (gf @ w2f.T) * dact
    dhc = dh.to(dt).float()
    dxn = dhc @ w1f.T
    dx_ln, dls, dlb = ln_backward(dxn, xhat, rstd, ln_scale)
    return ((gf + dx_ln).to(dt), dls, dlb, xn.T @ dhc, dh.sum(0), a.T @ gf,
            gf.sum(0))


def fused_mlp_bwd(x, ln_scale, ln_bias, w1, b1, w2, g, eps: float = 1e-6,
                  act: str = "gelu_tanh"):
    """Backward of the MLP half (K24): the cotangent ``g`` (T, D) ->
    ``(dx, dls, dlb, dw1, db1, dw2, db2)``, dx in x's dtype, the weight,
    bias and LN gradients f32.  A CPU tensor runs
    :func:`fused_mlp_bwd_plain`; a CUDA tensor launches the kernel (bf16,
    T a multiple of 8, D <= 2048) or raises."""
    if act not in _ACT_CODES:
        raise ValueError(f"unknown act {act!r}")
    if x.device.type == "cpu":
        return fused_mlp_bwd_plain(x, ln_scale, ln_bias, w1, b1, w2, g,
                                   eps=eps, act=act)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    t, d, m = _cuda_geometry(x, w1, kernel="K24 fused_mlp_bwd")
    if t % 8 or d > 2048:
        raise ValueError(f"backward kernel takes T a multiple of 8 and "
                         f"D <= 2048 (T={t}, D={d})")
    check_activation(g, (t, d), torch.bfloat16, "g")
    dev = x.device
    f32, bf = torch.float32, torch.bfloat16
    ls = kernel_operand(ln_scale, (d,), f32, dev, "ln_scale")
    lb = kernel_operand(ln_bias, (d,), f32, dev, "ln_bias")
    w1 = kernel_operand(w1, (d, m), bf, dev, "w1")
    b1 = kernel_operand(b1, (m,), f32, dev, "b1")
    w2 = kernel_operand(w2, (m, d), bf, dev, "w2")
    dx = torch.empty_like(x)
    dln = torch.empty((2 * d,), dtype=f32, device=dev)
    dw1 = torch.empty((d, m), dtype=f32, device=dev)
    db1 = torch.empty((m,), dtype=f32, device=dev)
    dw2 = torch.empty((m, d), dtype=f32, device=dev)
    db2 = torch.empty((d,), dtype=f32, device=dev)
    with torch.cuda.device(dev):
        lib, stream = _kernels.launch_target()
        work = torch.empty((lib.vft_mlp_bwd_workspace(t, d, m),),
                           dtype=torch.uint8, device=dev)
        err = lib.vft_fused_mlp_bwd(
            x.data_ptr(), g.data_ptr(), ls.data_ptr(), lb.data_ptr(),
            w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), dx.data_ptr(),
            dln.data_ptr(), dw1.data_ptr(), db1.data_ptr(), dw2.data_ptr(),
            db2.data_ptr(), work.data_ptr(), t, d, m, _ACT_CODES[act],
            float(eps), stream)
    _kernels.check(err, "fused_mlp_bwd")
    fused_mlp_bwd.launches += 1
    return dx, dln[:d], dln[d:], dw1, db1, dw2, db2


fused_mlp_bwd.launches = 0


class FusedMLPFunction(torch.autograd.Function):
    """K5 forward, K24 backward.  Saves only the inputs and recomputes in
    the backward (the JAX ``custom_vjp``'s residuals); each gradient comes
    back in its primal's dtype."""

    @staticmethod
    def forward(ctx, x, ln_scale, ln_bias, w1, b1, w2, b2, eps, act):
        ctx.save_for_backward(x, ln_scale, ln_bias, w1, b1, w2, b2)
        ctx.hyper = (eps, act)
        return fused_mlp_fwd(x, ln_scale, ln_bias, w1, b1, w2, b2, eps=eps,
                             act=act)

    @staticmethod
    def backward(ctx, g):
        prims = ctx.saved_tensors
        x, ls, lb, w1, b1, w2, _ = prims
        eps, act = ctx.hyper
        grads = fused_mlp_bwd(x, ls, lb, w1, b1, w2,
                              g.to(x.dtype).contiguous(), eps=eps, act=act)
        return tuple(gr.to(p.dtype) for gr, p in zip(grads, prims)) + (
            None, None)


def fused_mlp(x, ln_scale, ln_bias, w1, b1, w2, b2, eps: float,
              act: str = "gelu"):
    """Differentiable MLP half (counterpart of the JAX ``fused_mlp``): K5
    forward, K24 backward on the card, their plain versions on the
    CPU."""
    return FusedMLPFunction.apply(x, ln_scale, ln_bias, w1, b1, w2, b2, eps,
                                  act)
