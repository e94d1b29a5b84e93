"""Transformer attention half: LN -> QKV -> masked MHA -> out-proj ->
+residual, and its backward.

Three Hopper kernels live here, each behind a wrapper that launches it on
a CUDA tensor and runs its plain PyTorch version (same arithmetic) on a
CPU tensor:

* K1 ``attn_block_stats`` (``csrc/attn_stats.cu``), the stats-chain half
  that serving runs: replaces ``vit_fpga_tpu/ops/attn_block.py:
  _attn_stats_kernel`` (with its ``_mha_loop``), wherever the JAX wrapper
  admits the geometry (:func:`attn_stats_fits`: up to ViT-B/16 @896 px's
  3137 tokens): the wgmma + TMA GEMM of ``csrc/gemm_wgmma.cuh`` (LN
  prologue, bias and residual epilogues) and the max-free one-pass mode of
  ``csrc/mha_wgmma.cuh``'s attention, one kernel at every length;
* K4 ``attn_block_fwd`` (``csrc/attn_block.cu``), the per-block half at
  head dim 64 or 80 (ViT-H/14; K1 takes 64):
  replaces ``_attn_block_kernel`` (wrapper ``attn_block_pallas``), K1 with
  one-pass LN statistics computed in the kernel and the exact
  (``safe_softmax``) or max-free softmax, wherever the JAX wrapper admits
  the geometry (:func:`attn_block_fits`): K1's launch
  sequence (``csrc/attn_half.cuh``) after a row pass, the attention in
  ``csrc/mha_wgmma.cuh``'s max-free mode or its safe mode, which sweeps
  the keys twice (the row max first, then ``exp(s - max)`` rounded to bf16
  before the division by the row sum);
* K23 ``attn_block_bwd`` (``csrc/attn_bwd.cu``), K4's backward: replaces
  ``_attn_bwd_kernel`` (wrapper ``attn_block_bwd_pallas``), the per-head
  arithmetic of its non-pair branch, at any length: its five products
  on ``csrc/gemm_wgmma.cuh``'s GEMM in the backward's layouts, and the
  attention backward on ``csrc/mha_wgmma.cuh``'s machinery, tiled over
  128 keys and 128 query rows (three sweeps over the keys per query tile
  for ao, dq and each row's softmax values, one sweep over the queries per
  key tile for dk and dv).

``attn_block`` is the differentiable half (``AttnBlockFunction``): K4
forward, saving only the inputs, as the JAX ``custom_vjp``; its backward
routes as the JAX ``_attn_block_bwd`` does, by the copied ``_bwd_fits``:
K23 where it holds, else the autograd gradient of :func:`attn_block_xla`
over a recompute (the JAX package's XLA VJP at those geometries).

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
probabilities in registers); K23 on the same GEMM (B read K-major for
the data gradients, A MN-major for the weight gradients) and the same
attention tiles; the backward sums every weight gradient over all rows in
split-K partials added in split order and every bias and LN gradient with
fixed-order column sums.  qkv, the attention
output and the backward's intermediates round-trip through device memory
(later work: fuse them away).

K1 and K4 also run in f32 (the f32 forward of ``make_forward``): true
f32 fma on the CUDA cores, no TF32 and no tensor-core instruction
(``csrc/attn_half_f32.cuh``: the LN + QKV GEMM and the out-projection on
``csrc/gemm_f32.cuh``, the attention ``csrc/seq_attn.cuh``'s max-free or
safe half mode, q scaled first as the JAX kernels do in f32).  Bound at
ViT-B/16 b64: 68 GFLOP at 67 TFLOP/s, 1.02 ms.  K23 takes bf16 only (f32
training is not ported yet) and raises a ValueError on f32, naming
itself.

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
# head dims K4 and K23 take on the card (csrc/mha_wgmma.cuh's MwDim; 80 is
# ViT-H/14's); K1 takes 64
_CARD_HEAD_DIMS = (64, 80)
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


def _plan_of(b: int, n: int, d: int, num_heads: int, itemsize: int):
    """The JAX wrappers' plan for x (b, n, d): tokens padded to 8, keys to
    128."""
    return attn_plan(num_heads, d, round_up(n, 8), round_up(n, 128),
                     itemsize, batch=b)


def attn_stats_fits(b: int, n: int, d: int, num_heads: int,
                    itemsize: int = 2) -> bool:
    """The JAX ``attn_block_stats_pallas`` gate: its plan has a score slot
    and no q-slot reuse (an ao-scratch tier).  K1 launches where it holds
    (ViT-B/16 up to 896 px, 3137 tokens), and raises elsewhere."""
    plan = _plan_of(b, n, d, num_heads, itemsize)
    return plan.n_sc >= 1 and not plan.reuse_q


def attn_block_fits(b: int, n: int, d: int, num_heads: int,
                    itemsize: int = 2) -> bool:
    """The JAX ``attn_block_pallas`` gate: its plan has a score slot.  K4
    launches where it holds, and raises elsewhere."""
    return _plan_of(b, n, d, num_heads, itemsize).n_sc >= 1


def _bwd_fits(n_heads: int, d: int, n_pad: int, kv_pad: int,
              itemsize: int) -> bool:
    """The JAX ``_bwd_fits`` (``vit_fpga_tpu/ops/attn_block.py:724-732``),
    arithmetic for arithmetic: whether the JAX ``_attn_block_bwd`` runs its
    Pallas backward (K23 here) or the XLA VJP of ``attn_block_xla``."""
    resident = (4 * d * d * itemsize          # wqkv + wo
                + 4 * d * d * 4               # dwqkv + dwo (f32)
                + 2 * kv_pad * 3 * d * itemsize   # qkv + dqkv panels
                + 6 * n_pad * d * itemsize)   # x/g/dx tiles + ao
    return resident + 2 * n_pad * kv_pad * 4 <= 64 * 1024 * 1024


def _card_dtype(x: torch.Tensor, kernel: str) -> torch.dtype:
    """The dtype a half's card launch runs in: bf16, or true f32 on the
    CUDA cores; anything else raises, naming ``kernel``."""
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{kernel} takes bf16 or f32 on the card, got "
                         f"{x.dtype}")
    return x.dtype


def _count(wrapper, dt: torch.dtype, long_path: int) -> None:
    """One launch of ``wrapper``: ``launches``, ``launches_long`` (past 256
    valid keys) and ``launches_f32`` (in f32)."""
    wrapper.launches += 1
    wrapper.launches_long += long_path
    wrapper.launches_f32 += int(dt == torch.float32)


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
    (bf16, or f32 on the CUDA cores; head dim 64, 1 <= n_valid <= n_pad,
    the geometry :func:`attn_stats_fits` admits at the dtype's itemsize)
    or raises.  Launches past 256 valid keys are also counted in
    ``launches_long``, f32 ones in ``launches_f32``."""
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
    if dh != 64 or not 1 <= n_valid <= n:
        raise ValueError(f"K1 takes head dim 64 and 1 <= n_valid <= n_pad "
                         f"(dh={dh}, n_valid={n_valid}, n_pad={n})")
    dt = _card_dtype(x, "K1 attn_block_stats")
    check_activation(x, (b, n, d), dt, "x")
    if not attn_stats_fits(b, n, d, num_heads, x.element_size()):
        plan = _plan_of(b, n, d, num_heads, x.element_size())
        raise ValueError(
            f"K1 takes the JAX attn_block_stats_pallas geometry: attn_plan "
            f"needs a score slot and no q-slot reuse (n_sc={plan.n_sc}, "
            f"reuse_q={plan.reuse_q} at B={b}, n_pad={n}, D={d}, "
            f"{num_heads} heads)")
    check_activation(stats, (b, n, 2), torch.float32, "stats")
    dev = x.device
    f32 = torch.float32
    ls = kernel_operand(ln_scale, (d,), f32, dev, "ln_scale")
    lb = kernel_operand(ln_bias, (d,), f32, dev, "ln_bias")
    wqkv = kernel_operand(wqkv, (d, 3 * d), dt, dev, "wqkv")
    bqkv = kernel_operand(bqkv, (3 * d,), f32, dev, "bqkv")
    wo = kernel_operand(wo, (d, d), dt, dev, "wo")
    bo = kernel_operand(bo, (d,), f32, dev, "bo")
    out = torch.empty_like(x)
    st_out = (torch.empty((b, n, 2), dtype=f32, device=dev) if emit_stats
              else None)
    qkv = torch.empty((b * n, 3 * d), dtype=dt, device=dev)
    ao = torch.empty((b * n, d), dtype=dt, device=dev)
    long_path = ctypes.c_int(0)
    entry = ("vft_attn_block_stats_f32" if dt == f32
             else "vft_attn_block_stats")
    with torch.cuda.device(dev):
        lib, stream = _kernels.launch_target()
        err = getattr(lib, entry)(
            x.data_ptr(), stats.data_ptr(), ls.data_ptr(), lb.data_ptr(),
            wqkv.data_ptr(), bqkv.data_ptr(), wo.data_ptr(), bo.data_ptr(),
            out.data_ptr(), st_out.data_ptr() if emit_stats else None,
            qkv.data_ptr(), ao.data_ptr(), b, n, d, num_heads, n_valid,
            float(eps), 1.0 / math.sqrt(dh), stream, ctypes.byref(long_path))
    _kernels.check(err, entry)
    _count(attn_block_stats, dt, long_path.value)
    return out, st_out


attn_block_stats.launches = 0
attn_block_stats.launches_long = 0    # of those, with more than 256 valid keys
attn_block_stats.launches_f32 = 0     # of those, in f32


# ---------------------------------------------------------------------------
# K4 (per-block forward) and K23 (its backward)
# ---------------------------------------------------------------------------

def _cuda_geometry(x, num_heads, n_valid, *, kernel):
    """Shape checks shared by the K4 / K23 launches: (b, n, d, n_valid).
    ``kernel`` names the launch in the error.  K4 takes the geometry
    :func:`attn_block_fits` admits (the JAX ``attn_block_pallas`` gate);
    K23 any length (the backward routes by :func:`_bwd_fits` before it)."""
    if x.dim() != 3:
        raise ValueError(f"x must be (B, n_pad, D), got {tuple(x.shape)}")
    b, n, d = x.shape
    n_valid = n if n_valid is None else min(n_valid, n)
    if d % num_heads or d % 32:
        raise ValueError(f"kernel needs D divisible by 32 and by {num_heads} "
                         f"heads (D={d})")
    if d // num_heads not in _CARD_HEAD_DIMS or n_valid < 1:
        raise ValueError(f"{kernel} takes head dim 64 or 80 and at least one "
                         f"valid token (dh={d // num_heads}, "
                         f"n_valid={n_valid})")
    if kernel == "K23" and x.dtype != torch.bfloat16:
        raise ValueError(
            f"K23 attn_block_bwd takes bf16 on the card; its f32 mode (f32 "
            f"training) is not ported yet (got {x.dtype})")
    check_activation(x, (b, n, d), _card_dtype(x, kernel), "x")
    if kernel == "K4" and not attn_block_fits(b, n, d, num_heads,
                                              x.element_size()):
        raise ValueError(
            f"K4 takes the JAX attn_block_pallas geometry: attn_plan needs "
            f"a score slot (n_sc=0 at B={b}, n_pad={n}, D={d}, {num_heads} "
            f"heads; the unfused half with flash attention runs there)")
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
    launches the kernel (bf16, or f32 on the CUDA cores; head dim 64 or
    80, the geometry :func:`attn_block_fits` admits at the dtype's
    itemsize; a launch past 256 valid keys is counted in ``launches_long``
    too, an f32 one in ``launches_f32``) or raises."""
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
    dt = x.dtype
    f32 = torch.float32
    ls = kernel_operand(ln_scale, (d,), f32, dev, "ln_scale")
    lb = kernel_operand(ln_bias, (d,), f32, dev, "ln_bias")
    wqkv = kernel_operand(wqkv, (d, 3 * d), dt, dev, "wqkv")
    bqkv = kernel_operand(bqkv, (3 * d,), f32, dev, "bqkv")
    wo = kernel_operand(wo, (d, d), dt, dev, "wo")
    bo = kernel_operand(bo, (d,), f32, dev, "bo")
    out = torch.empty_like(x)
    long_path = ctypes.c_int(0)
    stats = torch.empty((b * n, 2), dtype=f32, device=dev)
    qkv = torch.empty((b * n, 3 * d), dtype=dt, device=dev)
    ao = torch.empty((b * n, d), dtype=dt, device=dev)
    entry = "vft_attn_block_fwd_f32" if dt == f32 else "vft_attn_block_fwd"
    with torch.cuda.device(dev):
        lib, stream = _kernels.launch_target()
        err = getattr(lib, entry)(
            x.data_ptr(), ls.data_ptr(), lb.data_ptr(), wqkv.data_ptr(),
            bqkv.data_ptr(), wo.data_ptr(), bo.data_ptr(), out.data_ptr(),
            stats.data_ptr(), qkv.data_ptr(), ao.data_ptr(), b, n, d,
            num_heads, n_valid, int(safe_softmax), float(eps),
            1.0 / math.sqrt(d // num_heads), stream, ctypes.byref(long_path))
    _kernels.check(err, entry)
    _count(attn_block_fwd, dt, long_path.value)
    return out


attn_block_fwd.launches = 0
attn_block_fwd.launches_long = 0      # of those, past 256 valid keys
attn_block_fwd.launches_f32 = 0       # of those, in f32


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
    (bf16, head dim 64 or 80, any n_valid <= n_pad, B * n_pad a multiple
    of 8; a launch past 256 valid keys is counted in ``launches_long`` too)
    or raises.  :class:`AttnBlockFunction` calls it where :func:`_bwd_fits`
    holds."""
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
    long_path = ctypes.c_int(0)
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
            stream, ctypes.byref(long_path))
    _kernels.check(err, "attn_block_bwd")
    attn_block_bwd.launches += 1
    attn_block_bwd.launches_long += long_path.value
    return dx, dln[:d], dln[d:], dwqkv, dbqkv, dwo, dbo


attn_block_bwd.launches = 0
attn_block_bwd.launches_long = 0      # of those, past 256 valid keys


def attn_block_xla_vjp(prims, g, num_heads: int, eps: float,
                       n_valid: int | None):
    """The gradients of :func:`attn_block_xla` at the primals ``prims``
    (x, ln_scale, ln_bias, wqkv, bqkv, wo, bo) for the cotangent ``g``, by
    autograd over a recompute: the JAX ``_attn_block_bwd``'s ``jax.vjp``
    route, each gradient in its primal's dtype."""
    with torch.enable_grad():
        leaves = [p.detach().requires_grad_(True) for p in prims]
        out = attn_block_xla(*leaves, num_heads, eps=eps, n_valid=n_valid)
        return torch.autograd.grad(out, leaves, g)


class AttnBlockFunction(torch.autograd.Function):
    """K4 forward; the backward as the JAX ``_attn_block_bwd`` routes it:
    K23 (its plain version on the CPU) where :func:`_bwd_fits` holds, else
    :func:`attn_block_xla_vjp`.  Saves only the inputs and recomputes in
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
        g = g.to(x.dtype).contiguous()
        n, d = x.shape[1], x.shape[2]
        if not _bwd_fits(num_heads, d, round_up(n, 8), round_up(n, 128),
                         x.element_size()):
            return tuple(attn_block_xla_vjp(prims, g, num_heads, eps,
                                            n_valid)) + (None,) * 4
        grads = attn_block_bwd(x, ls, lb, wqkv, bqkv, wo, g, num_heads,
                               eps=eps, n_valid=n_valid)
        return tuple(gr.to(p.dtype) for gr, p in zip(grads, prims)) + (
            None, None, None, None)


def attn_block(x, ln_scale, ln_bias, wqkv, bqkv, wo, bo, num_heads: int,
               eps: float, n_valid: int | None = None,
               safe_softmax: bool = False):
    """Differentiable attention half (counterpart of the JAX
    ``attn_block``): K4 forward, and K23 backward where :func:`_bwd_fits`
    holds, on the card; their plain versions on the CPU; past
    :func:`_bwd_fits` the autograd gradient of :func:`attn_block_xla` on
    either device."""
    return AttnBlockFunction.apply(x, ln_scale, ln_bias, wqkv, bqkv, wo, bo,
                                   num_heads, eps, n_valid, safe_softmax)
