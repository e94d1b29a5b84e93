"""Multi-head attention over a whole sequence (counterpart of the JAX
package's ops/attention.py): the plain references, the fused kernels and
the dispatch the per-block encoder calls.

Two Hopper kernels live here, one CUDA entry point read by strides
(``csrc/mha.cu``: ``csrc/mha_wgmma.cuh`` in bf16, ``csrc/seq_attn.cuh``
in f32), each behind a wrapper that launches it on a CUDA tensor and
runs its plain PyTorch version (same arithmetic) on a CPU tensor:

* K7 ``mha_qkv_pallas``: replaces ``vit_fpga_tpu/ops/attention.py:
  _mha_qkv_kernel`` (wrapper ``mha_qkv_pallas``), exact softmax attention
  on the packed (B, N, 3D) qkv tensor, bf16 or f32;
* K8 ``mha_pallas``: replaces ``_mha_kernel`` (wrapper ``mha_pallas``),
  K7's function on (B, H, N, Dh).

Both mask keys at or past ``n_valid``, normalise before they round
(``p = dtype(e / sum e)``, then ``o = dtype(p v)``) and sum in f32.  The
bf16 kernel (``csrc/mha_wgmma.cuh``) streams 128-key tiles by TMA into an
mbarrier ring and runs both products on wgmma, 128 query rows a block, one
pass for each row's max and sum and one for the output (bound at ViT-B/16
@1024 px batch 1: 51.6 GFLOP, 52 us at 989 TFLOP/s); the f32 kernel (the
per-tensor int8 forward's attention) runs true f32 fma on the CUDA cores,
one pass over the keys with a running max and sum (the exact softmax's
function in f32), register-tiled like an SGEMM (at (64, 197, 2304): 7.6
GFLOP, 114 us at 67 TFLOP/s).  In bf16 the
operands' base addresses and strides must be multiples of 16 bytes (the
TMA maps'); the wrappers raise a ValueError naming K7 or K8 otherwise.

``mha_qkv`` dispatches as the JAX ``mha_qkv`` does on a TPU, on every
device: ``"auto"`` takes flash attention (K9, ``ops/flash_attention.py``)
from ``FLASH_SEQ_THRESHOLD`` tokens on and K7 below; an explicit impl is
honoured verbatim.  Its "pallas" and "flash" routes are differentiable
(``MhaQkvFunction``): the kernel forward, the VJP of
:func:`mha_qkv_xla` backward, as the JAX ``custom_vjp``\\ s.
"""

from __future__ import annotations

import torch

from .common import round_up
from .flash_attention import (LANE, check_operands, flash_attention,
                              launch_strided)

_NEG_INF = -1e30
# From this many tokens on, "auto" takes the blockwise flash kernel.
FLASH_SEQ_THRESHOLD = 1024


def mha_xla(q, k, v, n_valid: int | None = None) -> torch.Tensor:
    """Reference MHA on (B, H, N, Dh): softmax(q k^T / sqrt(Dh)) v, keys at
    or past ``n_valid`` masked; f32 scores, probabilities and output
    rounded to q's dtype."""
    dh = q.shape[-1]
    scores = (q.float() @ k.float().transpose(-1, -2)) * (dh ** -0.5)
    if n_valid is not None and n_valid < k.shape[2]:
        keep = torch.arange(k.shape[2], device=q.device) < n_valid
        scores = torch.where(keep, scores, torch.full_like(scores, _NEG_INF))
    p = torch.softmax(scores, dim=-1).to(q.dtype).float()
    return (p @ v.float()).to(q.dtype)


def _heads(qkv: torch.Tensor, num_heads: int):
    """(B, N, 3D) -> q, k, v as (B, H, N, Dh) views of the packed tensor."""
    b, n, d3 = qkv.shape
    d = d3 // 3
    dh = d // num_heads
    return tuple(qkv[..., i * d:(i + 1) * d].reshape(b, n, num_heads, dh)
                 .transpose(1, 2) for i in range(3))


def mha_qkv_xla(qkv: torch.Tensor, num_heads: int,
                n_valid: int | None = None) -> torch.Tensor:
    """Max-subtract softmax attention on the packed (B, N, 3D) tensor;
    keys at or past ``n_valid`` are masked.  Scores accumulate in f32, the
    probabilities and the output are rounded to the qkv dtype."""
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


def _exact_plain(q, k, v, n_valid: int) -> torch.Tensor:
    """The TPU kernels' exact softmax on (B, H, N, Dh): m = max s, e =
    exp(s - m), p = dtype(e / sum e), o = dtype(p v) in f32 sums."""
    dh = q.shape[-1]
    s = (q.float() @ k.float().transpose(-1, -2)) * (1.0 / dh ** 0.5)
    if n_valid < k.shape[2]:
        keep = torch.arange(k.shape[2], device=q.device) < n_valid
        s = torch.where(keep, s, torch.full_like(s, _NEG_INF))
    e = torch.exp(s - s.amax(-1, keepdim=True))
    p = (e / e.sum(-1, keepdim=True)).to(q.dtype)
    return (p.float() @ v.float()).to(q.dtype)


def mha_qkv_pallas_plain(qkv: torch.Tensor, num_heads: int,
                         n_valid: int | None = None) -> torch.Tensor:
    """Plain PyTorch version of K7 (the JAX ``_mha_qkv_kernel``'s
    arithmetic)."""
    b, n, d3 = qkv.shape
    n_valid = n if n_valid is None else min(n_valid, n)
    o = _exact_plain(*_heads(qkv, num_heads), n_valid)
    return o.transpose(1, 2).reshape(b, n, d3 // 3)


def mha_qkv_pallas(qkv: torch.Tensor, num_heads: int,
                   n_valid: int | None = None) -> torch.Tensor:
    """Fused attention on the packed (B, N, 3D) qkv tensor -> (B, N, D)
    (K7).  A CPU tensor runs :func:`mha_qkv_pallas_plain`; a CUDA tensor
    launches the kernel (bf16 or f32, head dim 64) or raises."""
    if qkv.dim() != 3 or qkv.shape[2] % 3:
        raise ValueError(f"qkv must be (B, N, 3D), got {tuple(qkv.shape)}")
    b, n, d3 = qkv.shape
    n_valid = n if n_valid is None else min(n_valid, n)
    if qkv.device.type == "cpu":
        return mha_qkv_pallas_plain(qkv, num_heads, n_valid)
    if qkv.device.type != "cuda":
        raise ValueError(f"unsupported device {qkv.device}")
    if d3 // 3 % num_heads or not qkv.is_contiguous() or n_valid < 1:
        raise ValueError(f"mha_qkv_pallas takes a contiguous (B, N, 3D) "
                         f"tensor with D divisible by {num_heads} heads and "
                         f"n_valid >= 1")
    q, k, v = _heads(qkv, num_heads)
    check_operands(q, k, v, (torch.bfloat16, torch.float32),
                   "K7 mha_qkv_pallas")
    out = torch.empty((b, n, d3 // 3), dtype=qkv.dtype, device=qkv.device)
    launch_strided("K7 mha_qkv_pallas", "vft_mha", q, k, v,
                   out.reshape(b, n, num_heads, -1).transpose(1, 2), n_valid,
                   int(qkv.dtype == torch.float32))
    mha_qkv_pallas.launches += 1
    return out


mha_qkv_pallas.launches = 0


def mha_pallas_plain(q, k, v, n_valid: int | None = None) -> torch.Tensor:
    """Plain PyTorch version of K8 (the JAX ``_mha_kernel``'s
    arithmetic)."""
    n = q.shape[2]
    return _exact_plain(q, k, v, n if n_valid is None else min(n_valid, n))


def mha_pallas(q, k, v, n_valid: int | None = None) -> torch.Tensor:
    """Fused attention over (B, H, N, Dh) -> (B, H, N, Dh) (K8).  A CPU
    tensor runs :func:`mha_pallas_plain`; a CUDA tensor launches the
    kernel (bf16 or f32, head dim 64) or raises."""
    n = q.shape[2]
    n_valid = n if n_valid is None else min(n_valid, n)
    if q.device.type == "cpu":
        return mha_pallas_plain(q, k, v, n_valid)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    check_operands(q, k, v, (torch.bfloat16, torch.float32),
                   "K8 mha_pallas")
    if n_valid < 1:
        raise ValueError("mha_pallas takes n_valid >= 1")
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    launch_strided("K8 mha_pallas", "vft_mha", q, k, v, out, n_valid,
                   int(q.dtype == torch.float32))
    mha_pallas.launches += 1
    return out


mha_pallas.launches = 0


def _mha_qkv_flash_impl(qkv: torch.Tensor, num_heads: int,
                        n_valid: int | None) -> torch.Tensor:
    """Packed qkv -> K9 -> packed output, with the JAX wrapper's blocks:
    bq = min(512, round_up(N, 128)), bk = 128.  The head split and merge
    are views (K9 reads by strides and writes (B, N, H, Dh))."""
    b, n, d3 = qkv.shape
    q, k, v = _heads(qkv, num_heads)
    o = flash_attention(q, k, v, n_valid=n_valid,
                        bq=min(512, round_up(n, LANE)), bk=LANE)
    return o.transpose(1, 2).reshape(b, n, d3 // 3)


class MhaQkvFunction(torch.autograd.Function):
    """K7 (``flash=False``) or K9 forward on the packed qkv tensor, the
    VJP of :func:`mha_qkv_xla` backward (the JAX ``_mha_qkv_diff`` and
    ``_mha_qkv_flash_diff``: rematerialised in the backward, saving only
    qkv)."""

    @staticmethod
    def forward(ctx, qkv, num_heads, n_valid, flash):
        ctx.save_for_backward(qkv)
        ctx.hyper = (num_heads, n_valid)
        if flash:
            return _mha_qkv_flash_impl(qkv, num_heads, n_valid)
        return mha_qkv_pallas(qkv, num_heads, n_valid)

    @staticmethod
    def backward(ctx, g):
        (qkv,) = ctx.saved_tensors
        num_heads, n_valid = ctx.hyper
        with torch.enable_grad():
            a = qkv.detach().requires_grad_(True)
            out = mha_qkv_xla(a, num_heads, n_valid)
            (grad,) = torch.autograd.grad(out, a, g)
        return grad, None, None, None


def mha_qkv(qkv: torch.Tensor, num_heads: int, n_valid: int | None = None,
            impl: str = "auto") -> torch.Tensor:
    """Packed-qkv attention dispatch (the per-block encoder's attention).
    ``"auto"`` resolves as the JAX ``mha_qkv`` does on a TPU: flash (K9)
    from ``FLASH_SEQ_THRESHOLD`` tokens on, else "pallas" (K7).  An
    explicit impl is honoured verbatim; "xla" runs :func:`mha_qkv_xla`."""
    if impl == "auto":
        impl = "flash" if qkv.shape[1] >= FLASH_SEQ_THRESHOLD else "pallas"
    if impl in ("flash", "pallas"):
        return MhaQkvFunction.apply(qkv, num_heads, n_valid, impl == "flash")
    if impl == "xla":
        return mha_qkv_xla(qkv, num_heads, n_valid)
    raise ValueError(f"unknown attention impl {impl!r}")


def mha(q, k, v, n_valid: int | None = None,
        impl: str = "auto") -> torch.Tensor:
    """(B, H, N, Dh) attention dispatch (the JAX ``mha``).  ``"auto"``
    resolves as on a TPU: flash (K9, blocks of 512) from 1024 tokens on,
    else "xla"; "pallas" runs K8."""
    if impl == "auto":
        impl = "flash" if q.shape[2] >= FLASH_SEQ_THRESHOLD else "xla"
    if impl == "flash":
        return flash_attention(q, k, v, n_valid=n_valid)
    if impl == "pallas":
        return mha_pallas(q, k, v, n_valid=n_valid)
    if impl == "xla":
        return mha_xla(q, k, v, n_valid=n_valid)
    raise ValueError(f"unknown attention impl {impl!r}")
