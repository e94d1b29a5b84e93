"""Transformer attention half: LN -> QKV -> masked MHA -> out-proj ->
+residual, and its backward.

Three Hopper kernels live here, each behind a wrapper that launches it on
a CUDA tensor and runs its plain PyTorch version (same arithmetic) on a
CPU tensor:

* K1 ``attn_block_stats`` (``csrc/attn_stats.cu``), the stats-chain half
  that serving runs: replaces ``vit_fpga_tpu/ops/attn_block.py:
  _attn_stats_kernel`` (with its ``_mha_loop``), up to 1024 tokens: the
  wgmma + TMA GEMM of ``csrc/gemm_wgmma.cuh`` (LN prologue, bias and
  residual epilogues) and the max-free one-pass mode of
  ``csrc/mha_wgmma.cuh``'s attention, one kernel at every length;
* K4 ``attn_block_fwd`` (``csrc/attn_block.cu``), the per-block half:
  replaces ``_attn_block_kernel`` (wrapper ``attn_block_pallas``), K1 with
  one-pass LN statistics computed in the kernel and the exact
  (``safe_softmax``) or max-free softmax, up to 1024 tokens: K1's launch
  sequence (``csrc/attn_half.cuh``) after a row pass, the attention in
  ``csrc/mha_wgmma.cuh``'s max-free mode or its safe mode, which sweeps
  the keys twice (the row max first, then ``exp(s - max)`` rounded to bf16
  before the division by the row sum);
* K23 ``attn_block_bwd`` (``csrc/attn_bwd.cu``), K4's backward: replaces
  ``_attn_bwd_kernel`` (wrapper ``attn_block_bwd_pallas``), the per-head
  arithmetic of its non-pair branch, up to 256 tokens.

``attn_block`` is the differentiable half (``AttnBlockFunction``): K4
forward, K23 backward, saving only the inputs, as the JAX ``custom_vjp``.

``attn_plan`` is the JAX package's VMEM tier planner, copied: the port
reads it only to decide which function the JAX package computes (the
fused half, the chain, or the unfused half with flash attention).

Bounds on the H100 at ViT-B/16 batch 64 (R = 12 800 rows, D = 768), all
set by tensor-core operations at 989 TFLOP/s: K1 and K4 8·R·D² +
4·B·H·n_pad·n_valid·dh flops (68 GFLOP, 69 us) against about 44 MB of
compulsory traffic; K23 22·R·D² + 12·B·H·n_pad·n_valid·dh (189 GFLOP,
191 us) against under 100 MB.  Designs: K1 and K4 on wgmma + TMA (a
producer warpgroup streaming tiles into a shared-memory ring, two consumer
warpgroups; the LN applied to the landed A tiles, the scores and
probabilities in registers); K23 on bf16 wmma GEMMs (transposed layouts
for the gradients) and an attention block per (image, head) with scores
and probabilities in shared memory; the backward sums
every weight gradient over all rows in one transposed-A GEMM and every
bias and LN gradient with fixed-order column sums.  qkv, the attention
output and the backward's intermediates round-trip through device memory
(later work: fuse them away).

The max-free softmax, ``exp(clip(s, -70, 80))`` with keys at or past
``n_valid`` masked, equals the exact softmax of
:func:`vit_fpga_tpu_torch.ops.attention.mha_qkv_xla` while every logit
lies inside the clip window.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from . import _kernels
from .attention import mha_qkv_xla
from .common import (check_activation, kernel_operand, ln_backward, ln_parts,
                     round_up, row_stats)

_NEG_INF = -1e30
# K1 and K4 take up to LONG_MAX_TOKENS tokens (csrc/attn_half.cuh
# AH_MAX_TOKENS); their C entries report a launch with more than 256 valid
# keys (one kernel at every length; the launch checks count those apart).
# Where the JAX package keeps the chain
# (attn_plan below), it runs K1 up to 3137 tokens (ViT-B/16 @896 px); past
# 1024 the port's K1 raises on the card.  K4 takes the same tile and
# limit; its backward K23 holds a head's keys in one block, up to
# BWD_MAX_TOKENS.
LONG_MAX_TOKENS = 1024
BWD_MAX_TOKENS = 256
# max-free softmax clip window (as the JAX kernels)
_EXP_LO, _EXP_HI = -70.0, 80.0


# ---------------------------------------------------------------------------
# The JAX package's attention-half planner, copied as a routing function
# ---------------------------------------------------------------------------

_BIG_VMEM_BYTES = 100 * 1024 * 1024
_MULTI_VMEM_BYTES = 48 * 1024 * 1024


class AttnPlan(NamedTuple):
    imgs: int          # images per grid cell
    n_sc: int          # score slots (head-group size); 0 = does not fit
    reuse_q: bool      # attention out overwrites dead q slots (tight tier)
    vmem_limit: int    # vmem_limit_bytes override (0 = compiler default)


def attn_plan(n_heads: int, d: int, n_pad: int, kv_pad: int,
              itemsize: int, batch: int = 1,
              budget: int = 13 * 1024 * 1024,
              weight_itemsize: int | None = None,
              d_attn: int | None = None) -> AttnPlan:
    """The JAX ``attn_plan`` (``vit_fpga_tpu/ops/attn_block.py:86-154``),
    arithmetic for arithmetic.  It sizes the TPU kernel's VMEM tiers, and
    through them decides which function the JAX package computes: the
    fused attention half where ``n_sc >= 1`` (the stats chain only without
    ``reuse_q``), the unfused half (flash attention from 1024 tokens on)
    where ``n_sc == 0``.  The port reads it for that decision alone; it
    sets no tiling of the Hopper kernels."""
    da = d_attn if d_attn is not None else d
    weights = (3 * d * da + da * d) * (weight_itemsize or itemsize)

    def fixed(imgs):
        panel = imgs * kv_pad * 3 * da * itemsize
        tiles = 4 * imgs * n_pad * d * itemsize
        ao = imgs * n_pad * da * itemsize
        return weights + panel + tiles + ao

    slot = n_pad * kv_pad * 4
    if fixed(1) + n_heads * slot <= budget:
        for imgs in (4, 2):
            if batch % imgs == 0 and (fixed(imgs) + 6 * slot
                                      <= _MULTI_VMEM_BYTES * 0.8):
                return AttnPlan(imgs, min(n_heads, 6), False,
                                _MULTI_VMEM_BYTES)
    if fixed(1) + slot <= budget:
        n_sc = min(n_heads, (budget - fixed(1)) // slot)
        vmem = (_MULTI_VMEM_BYTES
                if fixed(1) + n_sc * slot > 11 * 1024 * 1024 else 0)
        return AttnPlan(1, n_sc, False, vmem)
    ao1 = n_pad * da * itemsize
    tight = budget + 1024 * 1024
    if fixed(1) - ao1 + slot <= tight:
        if (batch % 2 == 0
                and fixed(2) + 4 * slot <= _MULTI_VMEM_BYTES * 0.8):
            return AttnPlan(2, min(n_heads, 4), False, _MULTI_VMEM_BYTES)
        return AttnPlan(1, min(n_heads, 2,
                               (tight - (fixed(1) - ao1)) // slot), True, 0)
    big = int(_BIG_VMEM_BYTES * 0.8)
    if fixed(1) + slot <= big:
        return AttnPlan(1, min(n_heads, (big - fixed(1)) // slot), False,
                        _BIG_VMEM_BYTES)
    return AttnPlan(1, 0, True, 0)


def _mha_tpu(qkv: torch.Tensor, num_heads: int, n_valid: int,
             safe_softmax: bool = False, out_scale=None) -> torch.Tensor:
    """The JAX kernels' ``_mha_loop`` arithmetic on (B, N, 3D) qkv:
    f32 scores, masked keys, ``exp(s - max)`` (safe) or ``exp(clip(s))``,
    bf16(e) @ v in f32, times r = 1 / sum(e), rounded to the qkv dtype.
    ``out_scale`` (the static int8 kernels' 1/a_ao) rides the reciprocal:
    r = (1 / sum(e)) * out_scale, then pv * r."""
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
    if not safe_softmax:
        s = s.clamp(_EXP_LO, _EXP_HI)
    if n_valid < n:
        keep = torch.arange(n, device=qkv.device) < n_valid
        s = torch.where(keep, s, torch.full_like(s, _NEG_INF))
    if safe_softmax:
        s = s - s.amax(-1, keepdim=True)
    e = torch.exp(s)
    r = 1.0 / e.sum(-1, keepdim=True)
    if out_scale is not None:
        r = r * out_scale
    pv = (e.to(dt).float() @ v.float()) * r
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
    out = _attn_tail(x, xn, wqkv, bqkv, wo, bo, num_heads, n_valid, _mha_tpu)
    return out, (row_stats(out, eps) if emit_stats else None)


def attn_block_stats(x, stats, ln_scale, ln_bias, wqkv, bqkv, wo, bo,
                     num_heads: int, eps: float = 1e-6,
                     n_valid: int | None = None, emit_stats: bool = True):
    """Stats-chain attention half: (x (B, n_pad, D), stats (B, n_pad, 2)
    f32) -> (out (B, n_pad, D), next stats (B, n_pad, 2) f32 or None).

    Query rows at or past ``n_valid`` are computed (garbage, as on the
    TPU); keys there are masked.  A CPU tensor runs
    :func:`attn_block_stats_plain`; a CUDA tensor launches the kernel
    (bf16, head dim 64, 1 <= n_valid <= n_pad <= 1024) or raises."""
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
    if dh != 64 or not 1 <= n_valid <= n <= LONG_MAX_TOKENS:
        raise ValueError(f"kernel takes head dim 64 and 1 <= n_valid <= "
                         f"n_pad <= {LONG_MAX_TOKENS} (dh={dh}, "
                         f"n_valid={n_valid}, n_pad={n})")
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
    long_path = ctypes.c_int(0)
    with torch.cuda.device(dev):
        lib, stream = _kernels.launch_target()
        err = lib.vft_attn_block_stats(
            x.data_ptr(), stats.data_ptr(), ls.data_ptr(), lb.data_ptr(),
            wqkv.data_ptr(), bqkv.data_ptr(), wo.data_ptr(), bo.data_ptr(),
            out.data_ptr(), st_out.data_ptr() if emit_stats else None,
            qkv.data_ptr(), ao.data_ptr(), b, n, d, num_heads, n_valid,
            float(eps), 1.0 / math.sqrt(dh), stream, ctypes.byref(long_path))
    _kernels.check(err, "attn_block_stats")
    attn_block_stats.launches += 1
    attn_block_stats.launches_long += long_path.value
    return out, st_out


attn_block_stats.launches = 0
attn_block_stats.launches_long = 0    # of those, with more than 256 valid keys


# ---------------------------------------------------------------------------
# K4 (per-block forward) and K23 (its backward)
# ---------------------------------------------------------------------------

def _cuda_geometry(x, num_heads, n_valid, *, kernel):
    """Shape checks shared by the K4 / K23 launches: (b, n, d, n_valid).
    ``kernel`` names the launch, whose token limit applies: K4 up to
    LONG_MAX_TOKENS, K23 up to BWD_MAX_TOKENS."""
    if x.dim() != 3:
        raise ValueError(f"x must be (B, n_pad, D), got {tuple(x.shape)}")
    b, n, d = x.shape
    n_valid = n if n_valid is None else min(n_valid, n)
    if d % num_heads or d % 32:
        raise ValueError(f"kernel needs D divisible by 32 and by {num_heads} "
                         f"heads (D={d})")
    if d // num_heads != 64 or n_valid < 1:
        raise ValueError(f"kernel takes head dim 64 and at least one valid "
                         f"token (dh={d // num_heads}, n_valid={n_valid})")
    limit = LONG_MAX_TOKENS if kernel == "K4" else BWD_MAX_TOKENS
    if n > limit:
        # The JAX plan sends CLIP ViT-L/14 (257 tokens) and ViT-B/16 @384
        # at an odd batch to the fused half (q-slot reuse leaves the stats
        # chain): K4 serves them; training them needs K23 past 256 keys.
        what = ("the attention backward K23" if kernel == "K23"
                else "the per-block attention K4")
        raise ValueError(f"n_pad={n}: {what} takes at most {limit} tokens "
                         f"(ROADMAP.md, section 1)")
    check_activation(x, (b, n, d), torch.bfloat16, "x")
    return b, n, d, n_valid


def attn_block_fwd_plain(x, ln_scale, ln_bias, wqkv, bqkv, wo, bo,
                         num_heads: int, eps: float = 1e-6,
                         n_valid: int | None = None,
                         safe_softmax: bool = False):
    """Plain PyTorch version of the K4 kernel (same arithmetic): one-pass
    LN statistics, then K1's tail with the chosen softmax."""
    n = x.shape[1]
    n_valid = n if n_valid is None else min(n_valid, n)
    st = row_stats(x, eps)
    xn = ((x.float() - st[..., 0:1]) * st[..., 1:2] * ln_scale.float()
          + ln_bias.float()).to(x.dtype)
    return _attn_tail(x, xn, wqkv, bqkv, wo, bo, num_heads, n_valid,
                      lambda q, h, nv: _mha_tpu(q, h, nv, safe_softmax))


def attn_block_fwd(x, ln_scale, ln_bias, wqkv, bqkv, wo, bo, num_heads: int,
                   eps: float = 1e-6, n_valid: int | None = None,
                   safe_softmax: bool = False, residual: bool = True):
    """Per-block attention half (K4): x (B, N, D) -> x + OutProj(MHA(QKV(
    LN(x)))).  Query rows at or past ``n_valid`` are computed, keys there
    masked.  A CPU tensor runs :func:`attn_block_fwd_plain`; a CUDA tensor
    launches the kernel (bf16, head dim 64, n_pad <= 1024; a launch past
    256 valid keys is counted in ``launches_long`` too) or raises."""
    if not residual:
        raise NotImplementedError(
            "residual=False (the tensor-parallel partial) comes with the "
            "multi-device port")
    if x.device.type == "cpu":
        return attn_block_fwd_plain(x, ln_scale, ln_bias, wqkv, bqkv, wo, bo,
                                    num_heads, eps=eps, n_valid=n_valid,
                                    safe_softmax=safe_softmax)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    b, n, d, n_valid = _cuda_geometry(x, num_heads, n_valid, kernel="K4")
    dev = x.device
    f32, bf = torch.float32, torch.bfloat16
    ls = kernel_operand(ln_scale, (d,), f32, dev, "ln_scale")
    lb = kernel_operand(ln_bias, (d,), f32, dev, "ln_bias")
    wqkv = kernel_operand(wqkv, (d, 3 * d), bf, dev, "wqkv")
    bqkv = kernel_operand(bqkv, (3 * d,), f32, dev, "bqkv")
    wo = kernel_operand(wo, (d, d), bf, dev, "wo")
    bo = kernel_operand(bo, (d,), f32, dev, "bo")
    out = torch.empty_like(x)
    long_path = ctypes.c_int(0)
    stats = torch.empty((b * n, 2), dtype=f32, device=dev)
    qkv = torch.empty((b * n, 3 * d), dtype=bf, device=dev)
    ao = torch.empty((b * n, d), dtype=bf, device=dev)
    with torch.cuda.device(dev):
        lib, stream = _kernels.launch_target()
        err = lib.vft_attn_block_fwd(
            x.data_ptr(), ls.data_ptr(), lb.data_ptr(), wqkv.data_ptr(),
            bqkv.data_ptr(), wo.data_ptr(), bo.data_ptr(), out.data_ptr(),
            stats.data_ptr(), qkv.data_ptr(), ao.data_ptr(), b, n, d,
            num_heads, n_valid, int(safe_softmax), float(eps),
            1.0 / math.sqrt(d // num_heads), stream, ctypes.byref(long_path))
    _kernels.check(err, "attn_block_fwd")
    attn_block_fwd.launches += 1
    attn_block_fwd.launches_long += long_path.value
    return out


attn_block_fwd.launches = 0
attn_block_fwd.launches_long = 0      # of those, past 256 valid keys


def attn_block_bwd_plain(x, ln_scale, ln_bias, wqkv, bqkv, wo, g,
                         num_heads: int, eps: float = 1e-6,
                         n_valid: int | None = None):
    """Plain PyTorch version of the K23 kernel, the arithmetic of the JAX
    ``_attn_bwd_kernel`` (per-head branch): returns
    ``(dx, dls, dlb, dwqkv, dbqkv, dwo, dbo)``, dx in x's dtype and the
    rest f32.  Exact max-subtract softmax, whatever the forward ran."""
    dt = x.dtype
    b, n, d = x.shape
    dh = d // num_heads
    n_valid = n if n_valid is None else min(n_valid, n)
    scale = 1.0 / math.sqrt(dh)
    xhat, rstd = ln_parts(x, eps)
    xn = (xhat * ln_scale.float() + ln_bias.float()).to(dt)
    w_qkv = wqkv.to(dt).float()
    qkv = (xn.float() @ w_qkv + bqkv.float()).to(dt)
    gf = g.to(dt).float()
    gw = (gf @ wo.to(dt).float().T).to(dt)          # attention-out cotangent

    def heads(t):                        # (B, N, w) -> (B, H, N, dh)
        return t.reshape(b, n, num_heads, dh).transpose(1, 2).float()

    q, k, v = (heads(qkv[..., i * d:(i + 1) * d]) for i in range(3))
    gh = heads(gw)
    s = (q @ k.transpose(-1, -2)) * scale
    if n_valid < n:
        keep = torch.arange(n, device=x.device) < n_valid
        s = torch.where(keep, s, torch.full_like(s, _NEG_INF))
    e = torch.exp(s - s.amax(-1, keepdim=True))
    p = e / e.sum(-1, keepdim=True)
    pc = p.to(dt).float()
    ao = (pc @ v).to(dt)                             # rounded as the TPU bwd
    dv = (pc.transpose(-1, -2) @ gh).to(dt)
    dp = gh @ v.transpose(-1, -2)
    ds = (p * (dp - (dp * p).sum(-1, keepdim=True)) * scale).to(dt).float()
    dq = (ds @ k).to(dt)
    dk = (ds.transpose(-1, -2) @ q).to(dt)

    def merge(t):                        # (B, H, N, dh) -> (B*N, d)
        return t.transpose(1, 2).reshape(b * n, d).float()

    dqkv = torch.cat([merge(dq), merge(dk), merge(dv)], dim=-1)
    g2 = gf.reshape(b * n, d)
    dwo = merge(ao).T @ g2
    dwqkv = xn.reshape(b * n, d).float().T @ dqkv
    dxn = (dqkv @ w_qkv.T).reshape(b, n, d)
    dx_ln, dls, dlb = ln_backward(dxn, xhat, rstd, ln_scale)
    return ((gf + dx_ln).to(dt), dls, dlb, dwqkv, dqkv.sum(0), dwo, g2.sum(0))


def attn_block_bwd(x, ln_scale, ln_bias, wqkv, bqkv, wo, g, num_heads: int,
                   eps: float = 1e-6, n_valid: int | None = None):
    """Backward of the attention half (K23): the cotangent ``g`` of the
    output -> ``(dx, dls, dlb, dwqkv, dbqkv, dwo, dbo)``, dx in x's dtype,
    the weight, bias and LN gradients f32.  A CPU tensor runs
    :func:`attn_block_bwd_plain`; a CUDA tensor launches the kernel
    (bf16, head dim 64, n_valid <= n_pad <= 256, B * n_pad a multiple of
    8) or raises."""
    if x.device.type == "cpu":
        return attn_block_bwd_plain(x, ln_scale, ln_bias, wqkv, bqkv, wo, g,
                                    num_heads, eps=eps, n_valid=n_valid)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    b, n, d, n_valid = _cuda_geometry(x, num_heads, n_valid, kernel="K23")
    if (b * n) % 8:
        raise ValueError(f"the attention backward K23 takes B*n_pad a "
                         f"multiple of 8 (B={b}, n_pad={n})")
    check_activation(g, (b, n, d), torch.bfloat16, "g")
    dev = x.device
    f32, bf = torch.float32, torch.bfloat16
    ls = kernel_operand(ln_scale, (d,), f32, dev, "ln_scale")
    lb = kernel_operand(ln_bias, (d,), f32, dev, "ln_bias")
    wqkv = kernel_operand(wqkv, (d, 3 * d), bf, dev, "wqkv")
    bqkv = kernel_operand(bqkv, (3 * d,), f32, dev, "bqkv")
    wo = kernel_operand(wo, (d, d), bf, dev, "wo")
    dx = torch.empty_like(x)
    dln = torch.empty((2 * d,), dtype=f32, device=dev)
    dwqkv = torch.empty((d, 3 * d), dtype=f32, device=dev)
    dbqkv = torch.empty((3 * d,), dtype=f32, device=dev)
    dwo = torch.empty((d, d), dtype=f32, device=dev)
    dbo = torch.empty((d,), dtype=f32, device=dev)
    with torch.cuda.device(dev):
        lib, stream = _kernels.launch_target()
        work = torch.empty((lib.vft_attn_bwd_workspace(b, n, d),),
                           dtype=torch.uint8, device=dev)
        err = lib.vft_attn_block_bwd(
            x.data_ptr(), g.data_ptr(), ls.data_ptr(), lb.data_ptr(),
            wqkv.data_ptr(), bqkv.data_ptr(), wo.data_ptr(), dx.data_ptr(),
            dln.data_ptr(), dwqkv.data_ptr(), dbqkv.data_ptr(),
            dwo.data_ptr(), dbo.data_ptr(), work.data_ptr(), b, n, d,
            num_heads, n_valid, float(eps), 1.0 / math.sqrt(d // num_heads),
            stream)
    _kernels.check(err, "attn_block_bwd")
    attn_block_bwd.launches += 1
    return dx, dln[:d], dln[d:], dwqkv, dbqkv, dwo, dbo


attn_block_bwd.launches = 0


class AttnBlockFunction(torch.autograd.Function):
    """K4 forward, K23 backward.  Saves only the inputs and recomputes in
    the backward (the JAX ``custom_vjp``'s residuals); each gradient comes
    back in its primal's dtype."""

    @staticmethod
    def forward(ctx, x, ln_scale, ln_bias, wqkv, bqkv, wo, bo, num_heads,
                eps, n_valid, safe_softmax):
        ctx.save_for_backward(x, ln_scale, ln_bias, wqkv, bqkv, wo, bo)
        ctx.hyper = (num_heads, eps, n_valid)
        return attn_block_fwd(x, ln_scale, ln_bias, wqkv, bqkv, wo, bo,
                              num_heads, eps=eps, n_valid=n_valid,
                              safe_softmax=safe_softmax)

    @staticmethod
    def backward(ctx, g):
        prims = ctx.saved_tensors
        x, ls, lb, wqkv, bqkv, wo, _ = prims
        num_heads, eps, n_valid = ctx.hyper
        grads = attn_block_bwd(x, ls, lb, wqkv, bqkv, wo,
                               g.to(x.dtype).contiguous(), num_heads,
                               eps=eps, n_valid=n_valid)
        return tuple(gr.to(p.dtype) for gr, p in zip(grads, prims)) + (
            None, None, None, None)


def attn_block(x, ln_scale, ln_bias, wqkv, bqkv, wo, bo, num_heads: int,
               eps: float, n_valid: int | None = None,
               safe_softmax: bool = False):
    """Differentiable attention half (counterpart of the JAX
    ``attn_block``): K4 forward, K23 backward on the card, their plain
    versions on the CPU."""
    return AttnBlockFunction.apply(x, ln_scale, ln_bias, wqkv, bqkv, wo, bo,
                                   num_heads, eps, n_valid, safe_softmax)
