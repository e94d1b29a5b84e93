"""Blockwise (flash) attention with the online softmax, for long sequences
(counterpart of the JAX package's ops/flash_attention.py).

One Hopper kernel lives here, behind a wrapper that launches it on a CUDA
tensor and runs its plain PyTorch version (same arithmetic) on a CPU
tensor:

* K9 ``flash_attention`` (``csrc/flash_attn.cu``, the online mode of
  ``csrc/mha_wgmma.cuh``):
  replaces ``vit_fpga_tpu/ops/flash_attention.py:_flash_kernel`` (wrapper
  ``flash_attention``).  Per key block of ``bk`` keys: ``m_new = max(m,
  max s)``, ``alpha = exp(m - m_new)``, ``p = exp(s - m_new)``, ``l = l
  alpha + sum p``, ``acc = acc alpha + dtype(p) v``; ``o = dtype(acc /
  l)``.  The block boundaries are part of the function (p is rounded
  against the running max after each block), so ``bk`` is an argument, as
  in the JAX wrapper; ``bq`` tiles the queries and changes nothing.

Bound on the H100 at ViT-B/16 @1024 px batch 1 (12 heads, 4097 tokens,
head dim 64): 4 * 12 * 4097^2 * 64 = 51.6 GFLOP against 25 MB of
compulsory traffic, bound by tensor-core operations (52 us at 989
TFLOP/s).  Design: one block per 128 query rows of one (image, head), two
consumer warpgroups on wgmma (q k^T, then p v with p in registers) fed by a
producer thread's TMA ring of 128-key K / V tiles; at bk 128 one sweep with
the tile's softmax beside the previous tile's p v, at a longer bk each
block's max first.  The operands are read by strides through 4-D TMA maps,
so the packed qkv tensor needs no head-split copy.

In f32 (ViT-B/16 @896 and @1024 in f32, the per-tensor int8 forward at
1024 px) K9 is ``vft_flash_attention_f32``: ``csrc/seq_attn.cuh``'s online
mode, true f32 fma on the CUDA cores, one pass over 64-key tiles with a
running max and sum.  In f32 ``dtype(p)`` is the identity, so ``bk``
changes only the order of the rounding, and the kernel takes none.  Bound
at @1024 b1: 51.6 GFLOP at 67 TFLOP/s, 0.77 ms.
"""

from __future__ import annotations

import math

import torch

from . import _kernels
from .common import round_up

LANE = 128
_NEG_INF = -1e30
_KEY_TILE = 128           # the kernel's key tile: bk must be a multiple


def flash_attention_plain(q, k, v, n_valid: int | None = None, bq: int = 512,
                          bk: int = 512) -> torch.Tensor:
    """Plain PyTorch version of K9, the JAX ``flash_attention``'s
    arithmetic: a loop over key blocks only, vectorised over images, heads
    and queries.  Blocks wholly past ``n_valid`` are not visited: on the
    TPU they leave m, l and acc unchanged (alpha = 1, p = 0)."""
    b, h, n, dh = q.shape
    n_valid = n if n_valid is None else min(n_valid, n)
    scale = 1.0 / (dh ** 0.5)
    bk = min(bk, round_up(n, LANE))
    dt = q.dtype
    qf = q.float()
    m = torch.full((b, h, n, 1), _NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, h, n, dh), dtype=torch.float32, device=q.device)
    for k0 in range(0, n_valid, bk):
        kb = k[:, :, k0:k0 + bk].float()
        vb = v[:, :, k0:k0 + bk]
        s = (qf @ kb.transpose(-1, -2)) * scale
        keep = torch.arange(k0, k0 + kb.shape[2], device=q.device) < n_valid
        s = torch.where(keep, s, torch.full_like(s, _NEG_INF))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + p.to(dt).float() @ vb.float()
        m = m_new
    return (acc / l).to(dt)


def _strides(t: torch.Tensor, name: str, what: str):
    """(image, head, row) element strides of a (B, H, N, Dh) operand of the
    kernel ``what`` whose rows are contiguous and whose base address and
    strides are multiples of 16 bytes (8 elements), as the kernels read
    them (K7 / K8 in bf16 by TMA).  Raises ValueError naming ``what``."""
    if t.stride(3) != 1:
        raise ValueError(f"{what}: {name}'s head dim must be contiguous")
    if (t.data_ptr() % 16 or any(st % 8 for st in t.stride()[:3])):
        raise ValueError(f"{what}: {name} must start 16-byte aligned with "
                         f"strides of whole 16-byte units, got strides "
                         f"{tuple(t.stride())} of {t.dtype}")
    return t.stride(0), t.stride(1), t.stride(2)


def check_operands(q, k, v, dtypes, what: str):
    """Shape, dtype and device checks shared by the sequence attention
    launches (K7, K8, K9): (b, h, n, dh) with dh 64."""
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"{what}: q, k, v must be one (B, H, N, Dh) shape, "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if q.dtype not in dtypes or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{what}: kernel takes {dtypes}, got {q.dtype}")
    if q.shape[3] != 64:
        raise ValueError(f"{what}: kernel takes head dim 64, got "
                         f"{q.shape[3]}")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"{what}: q, k, v on different devices")
    return q.shape


def launch_strided(what: str, entry: str, q, k, v, out, n_valid: int,
                   *extra):
    """Launches ``entry`` (``vft_flash_attention``, its f32 twin or
    ``vft_mha``) on (B, H, N, 64) q, k, v and out views with their strides;
    ``extra`` is the entry's argument before the scale (bk, is_f32, or
    none).  ``what`` names the kernel in the errors."""
    b, h, n, dh = q.shape
    in_st = _strides(q, "q", what)
    if (_strides(k, "k", what) != in_st
            or _strides(v, "v", what) != in_st):
        raise ValueError(f"{what}: q, k and v must share their strides")
    out_st = _strides(out, "out", what)
    with torch.cuda.device(q.device):
        lib, stream = _kernels.launch_target()
        err = getattr(lib, entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            in_st[0], in_st[1], in_st[2], out_st[0], out_st[1], out_st[2],
            b, h, n, n_valid, *extra, 1.0 / math.sqrt(dh), stream)
    _kernels.check(err, entry)


def flash_attention(q, k, v, n_valid: int | None = None, bq: int = 512,
                    bk: int = 512) -> torch.Tensor:
    """(B, H, N, Dh) x3 -> (B, H, N, Dh), O(N) memory (the JAX
    ``flash_attention``; ``bk`` is clipped to ``round_up(N, 128)`` as
    there).  The result's storage is (B, N, H, Dh), so merging the heads of
    a packed-qkv caller is a view.  Operands may be strided views whose
    head dim is contiguous (the packed qkv tensor's column blocks).

    A CPU tensor runs :func:`flash_attention_plain`; a CUDA tensor
    launches K9 (bf16, or f32 on the CUDA cores; head dim 64, bk a multiple
    of 128; an f32 launch is also counted in ``launches_f32``) or
    raises."""
    b, h, n, dh = q.shape
    n_valid = n if n_valid is None else min(n_valid, n)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, n_valid, bq=bq, bk=bk)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    check_operands(q, k, v, (torch.bfloat16, torch.float32),
                   "K9 flash_attention")
    bk = min(bk, round_up(n, LANE))
    if bk % _KEY_TILE or not 1 <= n_valid:
        raise ValueError(f"flash_attention kernel takes bk a multiple of "
                         f"{_KEY_TILE} and n_valid >= 1 (bk={bk}, "
                         f"n_valid={n_valid})")
    out = torch.empty((b, n, h, dh), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    if q.dtype == torch.float32:
        launch_strided("K9 flash_attention", "vft_flash_attention_f32", q, k,
                       v, out, n_valid)
    else:
        launch_strided("K9 flash_attention", "vft_flash_attention", q, k, v,
                       out, n_valid, bk)
    flash_attention.launches += 1
    flash_attention.launches_f32 += int(q.dtype == torch.float32)
    return out


flash_attention.launches = 0
flash_attention.launches_f32 = 0      # of those, in f32
