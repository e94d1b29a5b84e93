"""Int8 transformer-block halves (counterpart of the JAX package's
ops/quant_block.py): the int8 serving paths' encoders, dynamic (K15, K16;
the stats chain's K21a, K21b) and calibrated static-scale (K17, K18; the
int8-scores attention K22).

Seven Hopper kernels live here, each behind a wrapper that launches it on
a CUDA tensor and runs its plain PyTorch version (same arithmetic) on a
CPU tensor:

* K15 ``mlp_block_int8`` (``csrc/mlp_int8.cu``): replaces
  ``vit_fpga_tpu/ops/quant_block.py:_mlp_int8_kernel`` (wrapper
  ``mlp_block_int8``).  One-pass LN -> row quant -> int8 GEMM1 ->
  dequant + bias -> fma tanh-GELU (or quick_gelu, relu) in f32 -> row
  quant of the f32 h over its whole row -> int8 GEMM2 -> dequant + bias
  -> ``x + bf16(y)``.  Both GEMMs run on ``csrc/qgemm_wgmma.cuh``'s int8
  wgmma + TMA kernel (K13's) with dequantizing epilogues.
* K16 ``attn_block_int8`` (``csrc/attn_int8.cu``): replaces
  ``_attn_int8_kernel`` (wrapper ``attn_block_int8``).  One-pass LN ->
  row quant -> int8 QKV GEMM -> ``bf16(dequant + bias)`` -> the max-free
  masked attention of K1 (bf16 scores and PV, keys at or past ``n_valid``
  masked) -> row quant of f32(ao) over all heads -> int8 out-projection ->
  dequant + bias -> ``x + bf16(y)``.  Its GEMMs run on
  ``csrc/qgemm_wgmma.cuh`` (a bf16 qkv epilogue, K15's residual one), its
  attention on ``csrc/mha_wgmma.cuh``'s max-free sweep (K1's), which
  streams the keys: the gate (:func:`attn_int8_geometry`) is the JAX
  planner's, past 256 keys (K18's and K21b's are its forms; K22's,
  :func:`attn_int8_scores_geometry`, is the JAX int8-scores wrapper's).
* K17 ``mlp_block_int8_static`` (``csrc/mlp_int8_static.cu``): replaces
  ``_mlp_int8_static_kernel`` (wrapper ``mlp_block_int8_static``).  The
  calibrated scales are folded into the arguments
  (``models/quantized.quantize_vit_static``): the LN affine carries 1/a_x,
  so LN -> rint/saturate to int8 -> int8 GEMM1 -> ``acc * s1' + b1`` ->
  the activation times 1/a_h (``_apply_act_scaled``) -> rint/saturate ->
  int8 GEMM2 -> ``acc * s2' + b2`` -> ``x + bf16(y)``.  No row absmax and
  no division: GEMM1's epilogue emits int8 h.  K15's launches without its
  h pass, both GEMMs on ``csrc/qgemm_wgmma.cuh`` at a row scale of 1 (W1
  with its int8 epilogue).
* K18 ``attn_block_int8_static`` (``csrc/attn_int8_static.cu``): replaces
  ``_attn_int8_static_kernel`` (wrapper ``attn_block_int8_static``).
  Folded LN -> rint/saturate -> int8 QKV -> ``bf16(acc * s' + b)`` -> the
  max-free masked attention with 1/a_ao in the post-PV reciprocal, ao
  rounded to bf16 in the quant domain -> rint/saturate in the attention's
  epilogue -> int8 out-projection -> ``acc * so' + bo`` -> ``x + bf16(y)``.
  K16's launches without its ao row pass: the GEMMs on
  ``csrc/qgemm_wgmma.cuh`` at a row scale of 1, the attention
  ``csrc/mha_wgmma.cuh``'s max-free sweep with an int8 output; K16's gate.
* K21a ``mlp_block_int8_stats`` (``csrc/mlp_int8_stats.cu``): replaces
  ``_mlp_int8_stats_kernel`` (wrapper ``mlp_block_int8_stats``).  K15
  with ``xn = ((x - mu) * rstd) * ls + lb`` from the producer's (mu,
  rstd), no reduction, and the next half's stats of ``out``'s bf16 values
  (one-pass) emitted in the dtype they came in, f32 or bf16; K15's
  launches and scratch.
* K21b ``attn_block_int8_stats`` (``csrc/attn_int8_stats.cu``): replaces
  ``_attn_int8_stats_kernel`` (wrapper ``attn_block_int8_stats``).  K16's
  function with the same two changes; K16's launches and scratch.  Its
  gate (:func:`attn_int8_stats_geometry`) is K16's with the JAX wrapper's
  refusal of q-slot reuse.
* K22 ``attn_block_int8_static_scores`` (``csrc/attn_int8_scores.cu``):
  replaces ``_attn_int8s_static_kernel`` (wrapper
  ``attn_block_int8_static_scores``, loop ``_mha_loop_int8s``).  K18's
  LN -> rint -> int8 QKV, but the q | k | v panel is rounded to int8
  (``wqkv_qs`` / ``bqkv_qs`` carry 1/s_q | 1/s_k | 1/s_v), QK^T and PV run
  as int8 products: s = acc * (sc_qk / sqrt(dh)), the clip window, keys at
  or past ``n_valid`` masked, e = exp(s), r = 1 / sum(e),
  pq = clip(rint(e * (127 r)), 0, 127), ao = pv * pv_fold kept in f32
  (it is already in the quant domain, magnitudes up to 127: bf16 would
  move its rint), rint -> int8 out-projection -> ``x + bf16(y)``.  The
  GEMMs on ``csrc/qgemm_wgmma.cuh`` (the panel by its int8 epilogue), a
  pass that transposes v's third, and an int8 wgmma + TMA attention that
  sweeps the keys twice (the row sums, then pq and p v).  Its gate
  (:func:`attn_int8_scores_geometry`) is the JAX wrapper's: dh 64, an
  even head count and two score slots in the JAX plan.

Bounds on the H100 at ViT-B/16 batch 64 (T = 12 800 rows, D = 768,
M = 3072, 12 heads of 64, n_valid 197), set by tensor-core operations at
1979 int8 TOPS and 989 bf16 TFLOP/s: K15 and K17 4·T·D·M = 120.8 G int8
operations (61 us) against about 44 MB of compulsory traffic; K16 and K18
8·T·D² = 60.4 G int8 operations (31 us) plus 7.8 GFLOP of bf16 attention
(8 us) against about 42 MB.  Design: row passes and int8 GEMMs with
dequantizing epilogues, all on ``csrc/qgemm_wgmma.cuh`` (wgmma + TMA).
A dynamic row's scale spans blocks that run apart on Hopper (h's 3072
columns, ao's 12 heads), so K15's GEMM1 writes f32 h with per-tile row
maxima that a row pass reduces before it quantizes, and K16's ao
round-trips in bf16 before its row pass.  The static scale is known
before the launch, so K17's GEMM1, K22's QKV and the K18 and K22
attentions emit int8 directly.  K21a and K21b have K15's and K16's bounds; K22 does 60.4 G +
7.8 G int8 operations (34 us at 1979 TOPS).

Unlike the dynamic kernels, where ``|x / s| <= 127`` by construction, the
static kernels' saturation is live: activations beyond the calibrated
absmax clip at +-127 (``_rint_i8``).

The plain versions copy the Pallas bodies (one-pass LN, the fma GELU,
the max-free softmax, the static kernels' bf16 ao), not the JAX ``*_ref``
functions (two-pass LN, exact softmax, f32 ao).  Those are ported too, as
plain torch on either device (``attn_block_int8_static_ref``,
``attn_block_int8s_static_ref``, ``mlp_block_int8_static_ref``): the JAX
package runs them, compiled by XLA, for a static tree where its block
kernels do not fit (ViT-B/16 at 1024 px).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..utils.platform import tanh_plain
from . import _kernels
from .attention import mha_qkv_xla
from .attn_block import _EXP_HI, _EXP_LO, _mha_tpu, attn_plan
from .common import (check_activation, kernel_operand, pad_sublane,
                     round_up, row_stats)
from .fused_mlp import _act
from .quant_fused import QMAX, _int_matmul, _row_quant, weight_kmajor

# Activation codes of csrc/common.cuh (enum Act): the fma tanh-GELU form.
_ACT_CODES = {"gelu_tanh": 2, "quick_gelu": 3, "relu": 4}


# ---------------------------------------------------------------------------
# The JAX package's int8 planners, copied as routing functions: they decide
# whether the JAX package runs the int8 block kernels (K16 -> K15, K18 ->
# K17) or the per-linear route (models/quantized._int8_block_fits).  They
# set no tiling of the Hopper kernels.
# ---------------------------------------------------------------------------

MLP_INT8_BIG_VMEM = 40 * 1024 * 1024


def mlp_block_t(t: int, d: int, m: int, budget: int = 17 << 20) -> int:
    """The JAX ``mlp_block_t``: the TPU int8 MLP's row tile for t rows."""
    for bt in (640, 512):
        if 2 * d * m + bt * (5 * m + 5 * d) > budget:
            continue
        if round_up(t, bt) - t <= t // 50:
            return bt
    return 256


def mlp_plan_int8(t: int, d: int, m: int) -> tuple[int, int]:
    """The JAX ``mlp_plan_int8`` (``quant_block.py:135``): (block_t,
    vmem_limit), (0, 0) where nothing fits even under the raised plan."""
    if 2 * d * m <= 11 * 1024 * 1024:
        return mlp_block_t(t, d, m), 0
    budget = MLP_INT8_BIG_VMEM - (4 << 20)
    for bt in (512, 384, 256, 128):
        if 2 * d * m + bt * (5 * m + 5 * d) > budget:
            continue
        if round_up(t, bt) - t <= max(t // 50, bt):
            return bt, MLP_INT8_BIG_VMEM
    return 0, 0


def score_slots_int8(n_heads: int, d: int, n_pad: int, kv_pad: int,
                     budget: int = 13 * 1024 * 1024,
                     batch: int = 1) -> tuple[int, int, bool, int]:
    """The JAX ``score_slots_int8`` (``quant_block.py:213``): the bf16
    attention plan with int8 weights, as (imgs, n_sc, reuse_q,
    vmem_limit)."""
    plan = attn_plan(n_heads, d, n_pad, kv_pad, itemsize=2, batch=batch,
                     budget=budget, weight_itemsize=1)
    return plan.imgs, plan.n_sc, plan.reuse_q, plan.vmem_limit


def _ln_f32(x, ln_scale, ln_bias, eps):
    """The int8 blocks' f32 LayerNorm: one-pass variance max(E[x^2] -
    mu^2, 0), then ((x - mu) * rstd) * scale + bias."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf * xf).mean(-1, keepdim=True) - mu * mu).clamp_min(0.0)
    return ((xf - mu) * torch.rsqrt(var + eps) * ln_scale.float()
            + ln_bias.float())


def _apply_act(h, act: str):
    """The int8 blocks' activation on f32 ``h``: the fma-reassociated
    tanh-GELU, quick_gelu or relu (the forms of ``fused_mlp._act``)."""
    if act not in _ACT_CODES:
        raise ValueError(act)
    return _act(h, act)


def _dequant(aq, wq, sa, ws, bias):
    """acc * (sa * ws) + bias in f32, acc the exact int8 product."""
    return _int_matmul(aq, wq) * (sa * ws.float()) + bias.float()


# ---------------------------------------------------------------------------
# The device operands the int8 halves' C entry points take
# ---------------------------------------------------------------------------

def _on_card(x) -> bool:
    """True for a CUDA tensor, False for a CPU one (the plain version
    runs); raises on any other device."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return True


def _mlp_operands(x, ln_scale, ln_bias, w1q, w1s, b1, w2q, w2s, b2):
    """An MLP half's geometry on the card and its eight operands in the C
    order: (T, D) bf16 x, D and M multiples of 16; f32 LN scale and bias,
    k-major int8 W1, its f32 column scales and bias, likewise W2.
    Returns (t, d, m, operands)."""
    if x.dim() != 2:
        raise ValueError(f"x must be (T, D), got {tuple(x.shape)}")
    t, d = x.shape
    m = w1q.shape[-1]
    if d % 16 or m % 16:
        raise ValueError(f"kernel needs D and M divisible by 16 (D={d}, "
                         f"M={m})")
    check_activation(x, (t, d), torch.bfloat16, "x")
    dev, f32 = x.device, torch.float32
    return t, d, m, [
        kernel_operand(ln_scale, (d,), f32, dev, "ln_scale"),
        kernel_operand(ln_bias, (d,), f32, dev, "ln_bias"),
        weight_kmajor(w1q, (d, m), dev, "w1q"),
        kernel_operand(w1s, (m,), f32, dev, "w1s"),
        kernel_operand(b1, (m,), f32, dev, "b1"),
        weight_kmajor(w2q, (m, d), dev, "w2q"),
        kernel_operand(w2s, (d,), f32, dev, "w2s"),
        kernel_operand(b2, (d,), f32, dev, "b2")]


# gridDim.y of csrc/mha_wgmma.cuh's attention (MW_MAX_GRID_Y): one block
# row an (image, head).
MW_MAX_GRID_Y = 65535
# The head dims each int8 attention half takes on the card: the attention
# core's tiles take 64 and 80 (ViT-H/14); K21b, off the default path, stays
# at 64.
_CARD_HEAD_DIMS = {"K16": (64, 80), "K18": (64, 80), "K21b": (64,)}


def attn_int8_geometry(b: int, n: int, d: int, num_heads: int,
                       n_valid: int, kernel: str = "K16") -> bool:
    """The gate on the card of the int8 attention halves on
    ``csrc/mha_wgmma.cuh`` (K16, K18; K21b through
    :func:`attn_int8_stats_geometry`), ``kernel`` naming the half in the
    errors: head dim 64 or 80 (K21b 64: ``_CARD_HEAD_DIMS``), 1 <= n_valid
    <= n, batch x heads within the
    attention's grid (``MW_MAX_GRID_Y``), all of which the C entry points
    check too, and a token count at which the JAX ``attn_block_int8`` and
    ``attn_block_int8_static`` run their kernels: they pad the n rows to
    the bf16 sublane and the keys to 128 and raise where
    :func:`score_slots_int8` finds no score slot (the bound of
    ``models/quantized._int8_block_fits``: ViT-B/16 up to 896 px, 3137
    tokens, ViT-L/16 up to 768 px).  The Hopper kernels stream the keys and
    have no length bound of their own.  Raises ``ValueError`` outside;
    returns the plan's ``reuse_q``."""
    dims = _CARD_HEAD_DIMS[kernel]
    if (num_heads < 1 or d % num_heads or d // num_heads not in dims
            or not 1 <= n_valid <= n):
        raise ValueError(f"{kernel} takes head dim "
                         f"{' or '.join(map(str, dims))} and 1..n valid "
                         f"tokens (D={d}, {num_heads} heads, n={n}, "
                         f"n_valid={n_valid})")
    if b * num_heads > MW_MAX_GRID_Y:
        raise ValueError(f"{kernel}'s attention grid takes batch x heads <= "
                         f"{MW_MAX_GRID_Y} (batch {b}, {num_heads} heads)")
    _, n_sc, reuse_q, _ = score_slots_int8(
        num_heads, d, round_up(n, pad_sublane(torch.bfloat16)),
        round_up(n, 128), batch=b)
    if n_sc < 1:
        raise ValueError(f"{kernel} runs where the JAX int8 attention plan "
                         f"does: no score slot at D={d}, {num_heads} heads, "
                         f"{n} tokens")
    return reuse_q


def attn_int8_static_geometry(b: int, n: int, d: int, num_heads: int,
                              n_valid: int) -> None:
    """K18's gate on the card: :func:`attn_int8_geometry`, the JAX
    ``attn_block_int8_static``'s own condition (a score slot)."""
    attn_int8_geometry(b, n, d, num_heads, n_valid, kernel="K18")


def attn_int8_stats_geometry(b: int, n: int, d: int, num_heads: int,
                             n_valid: int) -> None:
    """K21b's gate on the card: :func:`attn_int8_geometry` and the JAX
    ``attn_block_int8_stats``'s second condition, an ao-scratch tier (no
    q-slot reuse in the int8 attention plan at this batch), stricter than
    K16's at some batches (ViT-L/16 @384 b3).  Raises ``ValueError``
    outside."""
    if attn_int8_geometry(b, n, d, num_heads, n_valid, kernel="K21b"):
        raise ValueError(f"K21b runs where the JAX int8 stats attention "
                         f"does: it needs an ao-scratch tier, not q-slot "
                         f"reuse (batch {b}, D={d}, {num_heads} heads, {n} "
                         f"tokens)")


def _attn_operands(x, num_heads, n_valid, ln_scale, ln_bias, wqkvq, wqkvs,
                   bqkv, woq, wos, bo, gate):
    """An attention half's geometry on the card, checked by ``gate(b, n, d,
    num_heads, n_valid)`` (:func:`attn_int8_geometry` and its K18 and K21b
    forms, or K22's :func:`attn_int8_scores_geometry`), and its eight operands
    in the C order: (B, n_pad, D) bf16 x; f32 LN scale and bias, k-major
    int8 W_qkv, its f32 column scales and bias, likewise W_o.  Returns (b,
    n, d, n_valid, operands)."""
    if x.dim() != 3:
        raise ValueError(f"x must be (B, n_pad, D), got {tuple(x.shape)}")
    b, n, d = x.shape
    n_valid = n if n_valid is None else min(n_valid, n)
    gate(b, n, d, num_heads, n_valid)
    check_activation(x, (b, n, d), torch.bfloat16, "x")
    dev, f32 = x.device, torch.float32
    return b, n, d, n_valid, [
        kernel_operand(ln_scale, (d,), f32, dev, "ln_scale"),
        kernel_operand(ln_bias, (d,), f32, dev, "ln_bias"),
        weight_kmajor(wqkvq, (d, 3 * d), dev, "wqkvq"),
        kernel_operand(wqkvs, (3 * d,), f32, dev, "wqkvs"),
        kernel_operand(bqkv, (3 * d,), f32, dev, "bqkv"),
        weight_kmajor(woq, (d, d), dev, "woq"),
        kernel_operand(wos, (d,), f32, dev, "wos"),
        kernel_operand(bo, (d,), f32, dev, "bo")]


def mlp_int8_parts(m: int) -> int:
    """The count of K15's per-tile row maxima of h for M columns: one a
    column tile of its int8 GEMM, 256 columns wide (128 where M fits in
    128; ``csrc/qgemm_wgmma.cuh`` ``qgemm_wgmma_col_tiles``)."""
    tile = 128 if m <= 128 else 256
    return -(-m // tile)


def _mlp_int8_scratch(t, d, m, dev):
    """K15's and K21a's scratch, in the C order: int8 xq (T, D), its f32
    row scales, int8 hq (T, M), its row scales, the f32 h (T, M) and h's
    per-tile row maxima (:func:`mlp_int8_parts`, T)."""
    f32 = torch.float32
    return [torch.empty((t, d), dtype=torch.int8, device=dev),
            torch.empty((t,), dtype=f32, device=dev),
            torch.empty((t, m), dtype=torch.int8, device=dev),
            torch.empty((t,), dtype=f32, device=dev),
            torch.empty((t, m), dtype=f32, device=dev),
            torch.empty((mlp_int8_parts(m), t), dtype=f32, device=dev)]


def _attn_scratch(rows, d, dev):
    """K16's and K21b's scratch, in the C order: int8 rows (xq, then aoq),
    their f32 row scales (sx, then sa), the bf16 qkv (rows, 3D) the QKV
    GEMM writes and the attention reads, and the bf16 attention output
    (rows, D) the row pass reads."""
    bf = torch.bfloat16
    return [torch.empty((rows, d), dtype=torch.int8, device=dev),
            torch.empty((rows,), dtype=torch.float32, device=dev),
            torch.empty((rows, 3 * d), dtype=bf, device=dev),
            torch.empty((rows, d), dtype=bf, device=dev)]


def _ptrs(tensors):
    return [t.data_ptr() for t in tensors]


# ---------------------------------------------------------------------------
# K15: MLP half
# ---------------------------------------------------------------------------

def _mlp_int8_tail(x, xn, w1q, w1s, b1, w2q, w2s, b2, act):
    """K15's arithmetic after the LayerNorm: x + bf16(y) from f32 xn."""
    xq, sx = _row_quant(xn)
    h = _apply_act(_dequant(xq, w1q, sx, w1s, b1), act)
    hq, sh = _row_quant(h)
    y = _dequant(hq, w2q, sh, w2s, b2)
    return x + y.to(x.dtype)


def mlp_block_int8_plain(x, ln_scale, ln_bias, w1q, w1s, b1, w2q, w2s, b2,
                         eps: float = 1e-6, act: str = "gelu_tanh"):
    """Plain PyTorch version of the K15 kernel (the TPU kernel's body)."""
    return _mlp_int8_tail(x, _ln_f32(x, ln_scale, ln_bias, eps), w1q, w1s,
                          b1, w2q, w2s, b2, act)


def mlp_block_int8(x, ln_scale, ln_bias, w1q, w1s, b1, w2q, w2s, b2,
                   eps: float = 1e-6, act: str = "gelu_tanh"):
    """x (T, D) bf16 -> x + MLP_int8(LN(x)); w1q (D, M) and w2q (M, D)
    int8, w*s (N,) f32 column scales, biases f32.

    A CPU tensor runs :func:`mlp_block_int8_plain`; a CUDA tensor
    launches the K15 kernel (bf16, D and M multiples of 16) or raises."""
    if act not in _ACT_CODES:
        raise ValueError(f"unknown act {act!r}")
    if not _on_card(x):
        return mlp_block_int8_plain(x, ln_scale, ln_bias, w1q, w1s, b1, w2q,
                                    w2s, b2, eps=eps, act=act)
    t, d, m, ops = _mlp_operands(x, ln_scale, ln_bias, w1q, w1s, b1, w2q,
                                 w2s, b2)
    out = torch.empty_like(x)
    scratch = _mlp_int8_scratch(t, d, m, x.device)
    with torch.cuda.device(x.device):
        lib, stream = _kernels.launch_target()
        err = lib.vft_mlp_block_int8(
            x.data_ptr(), *_ptrs(ops), out.data_ptr(), *_ptrs(scratch), t, d,
            m, mlp_int8_parts(m), _ACT_CODES[act], float(eps), stream)
    _kernels.check(err, "mlp_block_int8")
    mlp_block_int8.launches += 1
    return out


mlp_block_int8.launches = 0


# ---------------------------------------------------------------------------
# K16: attention half
# ---------------------------------------------------------------------------

def attn_block_int8_plain(x, ln_scale, ln_bias, wqkvq, wqkvs, bqkv, woq,
                          wos, bo, num_heads: int, eps: float = 1e-6,
                          n_valid: int | None = None):
    """Plain PyTorch version of the K16 kernel (the TPU kernel's body,
    with the max-free masked attention of ``_mha_loop``)."""
    return _attn_int8_tail(x, _ln_f32(x, ln_scale, ln_bias, eps), wqkvq,
                           wqkvs, bqkv, woq, wos, bo, num_heads, n_valid)


def _attn_int8_tail(x, xn, wqkvq, wqkvs, bqkv, woq, wos, bo, num_heads,
                    n_valid):
    """K16's arithmetic after the LayerNorm: x + bf16(y) from f32 xn."""
    n = x.shape[1]
    n_valid = n if n_valid is None else min(n_valid, n)
    xq, sx = _row_quant(xn)
    qkv = _dequant(xq, wqkvq, sx, wqkvs, bqkv).to(x.dtype)
    ao = _mha_tpu(qkv, num_heads, n_valid)
    aoq, sa = _row_quant(ao.float())
    y = _dequant(aoq, woq, sa, wos, bo)
    return x + y.to(x.dtype)


def attn_block_int8(x, ln_scale, ln_bias, wqkvq, wqkvs, bqkv, woq, wos, bo,
                    num_heads: int, eps: float = 1e-6,
                    n_valid: int | None = None):
    """x (B, N, D) bf16 -> x + OutProj_int8(MHA(QKV_int8(LN(x)))); wqkvq
    (D, 3D) and woq (D, D) int8 with f32 column scales, biases f32.
    Query rows at or past ``n_valid`` are computed (garbage, as on the
    TPU); keys there are masked.

    A CPU tensor runs :func:`attn_block_int8_plain`; a CUDA tensor
    launches the K16 kernel (bf16, the geometry :func:`attn_int8_geometry`
    admits) or raises."""
    if not _on_card(x):
        return attn_block_int8_plain(x, ln_scale, ln_bias, wqkvq, wqkvs,
                                     bqkv, woq, wos, bo, num_heads, eps=eps,
                                     n_valid=n_valid)
    b, n, d, n_valid, ops = _attn_operands(x, num_heads, n_valid, ln_scale,
                                           ln_bias, wqkvq, wqkvs, bqkv, woq,
                                           wos, bo, gate=attn_int8_geometry)
    out = torch.empty_like(x)
    scratch = _attn_scratch(b * n, d, x.device)
    with torch.cuda.device(x.device):
        lib, stream = _kernels.launch_target()
        err = lib.vft_attn_block_int8(
            x.data_ptr(), *_ptrs(ops), out.data_ptr(), *_ptrs(scratch), b, n,
            d, num_heads, n_valid, float(eps), 1.0 / math.sqrt(d // num_heads),
            stream)
    _kernels.check(err, "attn_block_int8")
    attn_block_int8.launches += 1
    return out


attn_block_int8.launches = 0


# ---------------------------------------------------------------------------
# Calibrated static scales: the arguments come pre-folded by
# models/quantized.quantize_vit_static (ln_scale/ln_bias carry 1/a_x, the
# column scales a_x, a_ao or a_h); the two scales that cannot fold ride
# the kernels' scalar slots: 1/a_ao (K18) and 1/a_h (K17).
# ---------------------------------------------------------------------------

def _rint_i8(x: torch.Tensor) -> torch.Tensor:
    """f32 already in the quant domain -> int8: round half to even, then
    saturate at +-127 (live: values past the calibrated absmax clip)."""
    return torch.clamp(torch.round(x), -QMAX, QMAX).to(torch.int8)


def _apply_act_scaled(h, act: str, s):
    """act(h) * s with the scale folded into the emission constants, in
    the JAX kernels' order: gelu_tanh's 0.5 * h becomes (0.5 * s) * h,
    quick_gelu (s * h) * sigmoid(1.702 h), relu max(s * h, 0)."""
    if act == "gelu_tanh":
        h2 = h * h
        u = h * (0.7978845608028654 + 0.035677408136300125 * h2)
        hh = (0.5 * s) * h
        return hh + hh * tanh_plain(u)
    if act == "quick_gelu":
        return (s * h) * torch.sigmoid(1.702 * h)
    if act == "relu":
        return torch.clamp_min(s * h, 0.0)
    raise ValueError(act)


def _scalar(v, name: str) -> float:
    """A per-launch scale as the kernels take it: a Python float (a
    one-element tensor is read here, which syncs a CUDA tensor; the
    int8 forward reads them once, in ``prepare_int8``)."""
    v = float(v)
    if not math.isfinite(v) or v <= 0.0:
        raise ValueError(f"{name} must be a positive finite scale, got {v}")
    return v


# ---------------------------------------------------------------------------
# K17: static MLP half
# ---------------------------------------------------------------------------

def mlp_block_int8_static_plain(x, inv_ah, ln_scale, ln_bias, w1q, w1s, b1,
                                w2q, w2s, b2, eps: float = 1e-6,
                                act: str = "gelu_tanh"):
    """Plain PyTorch version of the K17 kernel (the TPU kernel's body)."""
    xq = _rint_i8(_ln_f32(x, ln_scale, ln_bias, eps))
    h = _int_matmul(xq, w1q) * w1s.float() + b1.float()
    hq = _rint_i8(_apply_act_scaled(h, act, inv_ah))
    y = _int_matmul(hq, w2q) * w2s.float() + b2.float()
    return x + y.to(x.dtype)


def mlp_block_int8_static(x, inv_ah, ln_scale, ln_bias, w1q, w1s, b1, w2q,
                          w2s, b2, eps: float = 1e-6, act: str = "gelu_tanh"):
    """x (T, D) bf16 -> x + MLP_int8(LN(x)) with calibrated scales:
    ``ln_scale``/``ln_bias`` carry 1/a_x, ``w1s`` a_x, ``w2s`` a_h;
    ``inv_ah`` is 1/a_h (a float, or a one-element tensor); w1q (D, M) and
    w2q (M, D) int8, biases f32.

    A CPU tensor runs :func:`mlp_block_int8_static_plain`; a CUDA tensor
    launches the K17 kernel (bf16, D and M multiples of 16) or raises."""
    if act not in _ACT_CODES:
        raise ValueError(f"unknown act {act!r}")
    if not _on_card(x):
        return mlp_block_int8_static_plain(x, inv_ah, ln_scale, ln_bias, w1q,
                                           w1s, b1, w2q, w2s, b2, eps=eps,
                                           act=act)
    t, d, m, ops = _mlp_operands(x, ln_scale, ln_bias, w1q, w1s, b1, w2q,
                                 w2s, b2)
    inv = _scalar(inv_ah, "inv_ah")
    out = torch.empty_like(x)
    xq = torch.empty((t, d), dtype=torch.int8, device=x.device)
    hq = torch.empty((t, m), dtype=torch.int8, device=x.device)
    with torch.cuda.device(x.device):
        lib, stream = _kernels.launch_target()
        err = lib.vft_mlp_block_int8_static(
            x.data_ptr(), *_ptrs(ops), out.data_ptr(), xq.data_ptr(),
            hq.data_ptr(), t, d, m, _ACT_CODES[act], float(eps), inv, stream)
    _kernels.check(err, "mlp_block_int8_static")
    mlp_block_int8_static.launches += 1
    return out


mlp_block_int8_static.launches = 0


# ---------------------------------------------------------------------------
# K18: static attention half
# ---------------------------------------------------------------------------

def attn_block_int8_static_plain(x, inv_ao, ln_scale, ln_bias, wqkvq, wqkvs,
                                 bqkv, woq, wos, bo, num_heads: int,
                                 eps: float = 1e-6,
                                 n_valid: int | None = None):
    """Plain PyTorch version of the K18 kernel (the TPU kernel's body):
    ao = bf16(pv * ((1 / sum(e)) * inv_ao)) is rounded to bf16 already in
    the quant domain, then rint/saturate."""
    n = x.shape[1]
    n_valid = n if n_valid is None else min(n_valid, n)
    xq = _rint_i8(_ln_f32(x, ln_scale, ln_bias, eps))
    qkv = (_int_matmul(xq, wqkvq) * wqkvs.float()
           + bqkv.float()).to(x.dtype)
    ao = _mha_tpu(qkv, num_heads, n_valid, out_scale=inv_ao)
    y = _int_matmul(_rint_i8(ao.float()), woq) * wos.float() + bo.float()
    return x + y.to(x.dtype)


def attn_block_int8_static(x, inv_ao, ln_scale, ln_bias, wqkvq, wqkvs, bqkv,
                           woq, wos, bo, num_heads: int, eps: float = 1e-6,
                           n_valid: int | None = None):
    """x (B, N, D) bf16 -> x + OutProj_int8(MHA(QKV_int8(LN(x)))) with
    calibrated scales: ``ln_scale``/``ln_bias`` carry 1/a_x, ``wqkvs``
    a_x, ``wos`` a_ao; ``inv_ao`` is 1/a_ao (a float, or a one-element
    tensor).  Query rows at or past ``n_valid`` are computed (garbage, as
    on the TPU); keys there are masked.

    A CPU tensor runs :func:`attn_block_int8_static_plain`; a CUDA tensor
    launches the K18 kernel (bf16, the geometry
    :func:`attn_int8_static_geometry` admits) or raises."""
    if not _on_card(x):
        return attn_block_int8_static_plain(x, inv_ao, ln_scale, ln_bias,
                                            wqkvq, wqkvs, bqkv, woq, wos, bo,
                                            num_heads, eps=eps,
                                            n_valid=n_valid)
    b, n, d, n_valid, ops = _attn_operands(
        x, num_heads, n_valid, ln_scale, ln_bias, wqkvq, wqkvs, bqkv, woq,
        wos, bo, gate=attn_int8_static_geometry)
    inv = _scalar(inv_ao, "inv_ao")
    out = torch.empty_like(x)
    q8 = torch.empty((b * n, d), dtype=torch.int8, device=x.device)
    qkv = torch.empty((b * n, 3 * d), dtype=torch.bfloat16, device=x.device)
    with torch.cuda.device(x.device):
        lib, stream = _kernels.launch_target()
        err = lib.vft_attn_block_int8_static(
            x.data_ptr(), *_ptrs(ops), out.data_ptr(), q8.data_ptr(),
            qkv.data_ptr(), b, n, d, num_heads, n_valid, float(eps),
            1.0 / math.sqrt(d // num_heads), inv, stream)
    _kernels.check(err, "attn_block_int8_static")
    attn_block_int8_static.launches += 1
    return out


attn_block_int8_static.launches = 0


# ---------------------------------------------------------------------------
# The int8 stats chain: K21b (attention half) and K21a (MLP half) pass the
# LayerNorm (mu, rstd) between them, as the bf16 chain's K1 and K2 do.
# Stats are (rows, 2), [..., 0] mu and [..., 1] rstd, f32 or bf16; each
# half emits the dtype it was given.
# ---------------------------------------------------------------------------

def _ln_from_stats(x, stats, ln_scale, ln_bias):
    """xn = ((f32(x) - mu) * rstd) * scale + bias with (mu, rstd) read
    from the producer's stats: no reduction."""
    st = stats.float()
    return ((x.float() - st[..., 0:1]) * st[..., 1:2] * ln_scale.float()
            + ln_bias.float())


def _check_stats(stats, shape):
    if stats.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"stats must be f32 or bf16, got {stats.dtype}")
    check_activation(stats, shape, stats.dtype, "stats")


def mlp_block_int8_stats_plain(x, stats, ln_scale, ln_bias, w1q, w1s, b1,
                               w2q, w2s, b2, eps: float = 1e-6,
                               act: str = "gelu_tanh",
                               emit_stats: bool = True):
    """Plain PyTorch version of the K21a kernel (the TPU kernel's body):
    K15 on the incoming stats, then the one-pass stats of ``out``'s bf16
    values in the stats' dtype."""
    out = _mlp_int8_tail(x, _ln_from_stats(x, stats, ln_scale, ln_bias),
                         w1q, w1s, b1, w2q, w2s, b2, act)
    return out, (row_stats(out, eps).to(stats.dtype) if emit_stats
                 else None)


def mlp_block_int8_stats(x, stats, ln_scale, ln_bias, w1q, w1s, b1, w2q,
                         w2s, b2, eps: float = 1e-6, act: str = "gelu_tanh",
                         emit_stats: bool = True):
    """Stats-chain int8 MLP half: (x (T, D) bf16, stats (T, 2) f32 or
    bf16) -> (x + MLP_int8(LN(x)), next stats (T, 2) of the same dtype, or
    None without ``emit_stats``).  Weights as :func:`mlp_block_int8`.

    A CPU tensor runs :func:`mlp_block_int8_stats_plain`; a CUDA tensor
    launches the K21a kernel (bf16, D and M multiples of 16) or raises."""
    if act not in _ACT_CODES:
        raise ValueError(f"unknown act {act!r}")
    if not _on_card(x):
        return mlp_block_int8_stats_plain(
            x, stats, ln_scale, ln_bias, w1q, w1s, b1, w2q, w2s, b2, eps=eps,
            act=act, emit_stats=emit_stats)
    t, d, m, ops = _mlp_operands(x, ln_scale, ln_bias, w1q, w1s, b1, w2q,
                                 w2s, b2)
    _check_stats(stats, (t, 2))
    out = torch.empty_like(x)
    st_out = torch.empty_like(stats) if emit_stats else None
    scratch = _mlp_int8_scratch(t, d, m, x.device)
    with torch.cuda.device(x.device):
        lib, stream = _kernels.launch_target()
        err = lib.vft_mlp_block_int8_stats(
            x.data_ptr(), stats.data_ptr(), *_ptrs(ops), out.data_ptr(),
            st_out.data_ptr() if emit_stats else None, *_ptrs(scratch), t, d,
            m, mlp_int8_parts(m), _ACT_CODES[act],
            int(stats.dtype == torch.bfloat16), float(eps), stream)
    _kernels.check(err, "mlp_block_int8_stats")
    mlp_block_int8_stats.launches += 1
    return out, st_out


mlp_block_int8_stats.launches = 0


def attn_block_int8_stats_plain(x, stats, ln_scale, ln_bias, wqkvq, wqkvs,
                                bqkv, woq, wos, bo, num_heads: int,
                                eps: float = 1e-6,
                                n_valid: int | None = None,
                                emit_stats: bool = True):
    """Plain PyTorch version of the K21b kernel (the TPU kernel's body):
    K16 on the incoming stats, then the one-pass stats of ``out``'s bf16
    values in the stats' dtype."""
    out = _attn_int8_tail(x, _ln_from_stats(x, stats, ln_scale, ln_bias),
                          wqkvq, wqkvs, bqkv, woq, wos, bo, num_heads,
                          n_valid)
    return out, (row_stats(out, eps).to(stats.dtype) if emit_stats
                 else None)


def attn_block_int8_stats(x, stats, ln_scale, ln_bias, wqkvq, wqkvs, bqkv,
                          woq, wos, bo, num_heads: int, eps: float = 1e-6,
                          n_valid: int | None = None,
                          emit_stats: bool = True):
    """Stats-chain int8 attention half: (x (B, n_pad, D) bf16, stats
    (B, n_pad, 2) f32 or bf16) -> (x + OutProj_int8(MHA(QKV_int8(LN(x)))),
    next stats (B, n_pad, 2) of the same dtype, or None without
    ``emit_stats``).  Weights as :func:`attn_block_int8`; query rows at
    or past ``n_valid`` are computed (garbage, as on the TPU), keys there
    masked.

    A CPU tensor runs :func:`attn_block_int8_stats_plain`; a CUDA tensor
    launches the K21b kernel (bf16, the geometry
    :func:`attn_int8_stats_geometry` admits) or raises."""
    if not _on_card(x):
        return attn_block_int8_stats_plain(
            x, stats, ln_scale, ln_bias, wqkvq, wqkvs, bqkv, woq, wos, bo,
            num_heads, eps=eps, n_valid=n_valid, emit_stats=emit_stats)
    b, n, d, n_valid, ops = _attn_operands(
        x, num_heads, n_valid, ln_scale, ln_bias, wqkvq, wqkvs, bqkv, woq,
        wos, bo, gate=attn_int8_stats_geometry)
    _check_stats(stats, (b, n, 2))
    out = torch.empty_like(x)
    st_out = torch.empty_like(stats) if emit_stats else None
    scratch = _attn_scratch(b * n, d, x.device)
    with torch.cuda.device(x.device):
        lib, stream = _kernels.launch_target()
        err = lib.vft_attn_block_int8_stats(
            x.data_ptr(), stats.data_ptr(), *_ptrs(ops), out.data_ptr(),
            st_out.data_ptr() if emit_stats else None, *_ptrs(scratch), b, n,
            d, num_heads, n_valid, int(stats.dtype == torch.bfloat16),
            float(eps), 1.0 / math.sqrt(d // num_heads), stream)
    _kernels.check(err, "attn_block_int8_stats")
    attn_block_int8_stats.launches += 1
    return out, st_out


attn_block_int8_stats.launches = 0


# ---------------------------------------------------------------------------
# K22: static attention half with int8 scores
# ---------------------------------------------------------------------------

def _scores_geometry(d: int, num_heads: int) -> int:
    """The JAX gate of the int8-scores half: head dim 64 and an even head
    count (the TPU kernel's pair-packed geometry).  Returns dh."""
    if d % num_heads or d // num_heads != 64 or num_heads % 2:
        raise ValueError(f"K22 (the int8-scores path) requires dh=64, "
                         f"even heads "
                         f"(D={d}, {num_heads} heads)")
    return d // num_heads


def attn_int8_scores_geometry(b: int, n: int, d: int, num_heads: int,
                              n_valid: int) -> None:
    """K22's gate on the card, the JAX ``attn_block_int8_static_scores``'s
    conditions in its order: head dim 64 and an even head count
    (:func:`_scores_geometry`, the JAX message), then 1 <= n_valid <= n and
    batch x heads within the attention's grid (``MW_MAX_GRID_Y``), which
    the C entry point checks too, then two score slots in the JAX int8
    attention plan (:func:`score_slots_int8` on the n rows padded to the
    bf16 sublane and the keys to 128, ``n_sc >= 2``: the JAX wrapper raises
    below, where K16's gate raises only below 1; ViT-B/16 @896 and
    ViT-L/16 @384 at b1 to b3 have one).  The Hopper kernel streams the
    keys and has no length bound of its own.  Raises ``ValueError``
    outside."""
    _scores_geometry(d, num_heads)
    if not 1 <= n_valid <= n:
        raise ValueError(f"K22 takes 1..n valid tokens (n={n}, "
                         f"n_valid={n_valid})")
    if b * num_heads > MW_MAX_GRID_Y:
        raise ValueError(f"K22's attention grid takes batch x heads <= "
                         f"{MW_MAX_GRID_Y} (batch {b}, {num_heads} heads)")
    _, n_sc, _, _ = score_slots_int8(
        num_heads, d, round_up(n, pad_sublane(torch.bfloat16)),
        round_up(n, 128), batch=b)
    if n_sc < 2:
        raise ValueError(f"K22 runs where the JAX int8-scores attention "
                         f"does: {n_sc} score slot(s), it takes 2, at "
                         f"D={d}, {num_heads} heads, {n} tokens, batch {b}")


def _scores_dequant(sc_qk, dh: int) -> float:
    """sc_qk * (1 / sqrt(dh)) rounded to f32 once, as the JAX kernel's
    ``sc_qk * jnp.float32(scale)``."""
    return float(np.float32(float(sc_qk)) * np.float32(1.0 / math.sqrt(dh)))


def attn_block_int8_static_scores_plain(x, sc_qk, pv_fold, ln_scale,
                                        ln_bias, wqkvq, wqkv_qs, bqkv_qs,
                                        woq, wos, bo, num_heads: int,
                                        eps: float = 1e-6,
                                        n_valid: int | None = None):
    """Plain PyTorch version of the K22 kernel (the TPU kernel's body and
    ``_mha_loop_int8s``, not ``attn_block_int8s_static_ref``): one-pass
    LN, the int8 panel, int8 products, a true reciprocal of each head
    row's sum over the valid keys, the f32 ao."""
    b, n, d = x.shape
    dh = _scores_geometry(d, num_heads)
    n_valid = n if n_valid is None else min(n_valid, n)
    xq = _rint_i8(_ln_f32(x, ln_scale, ln_bias, eps))
    qkv = _rint_i8(_int_matmul(xq, wqkvq) * wqkv_qs.float()
                   + bqkv_qs.float())

    def heads(t):
        return t.reshape(b, n, num_heads, dh).transpose(1, 2)

    q, k, v = (heads(qkv[..., i * d:(i + 1) * d]) for i in range(3))
    s = _int_matmul(q, k.transpose(-1, -2)) * _scores_dequant(sc_qk, dh)
    e = torch.exp(s.clamp(_EXP_LO, _EXP_HI))
    e = torch.where(torch.arange(n, device=x.device) < n_valid, e,
                    torch.zeros_like(e))
    r = 1.0 / e.sum(-1, keepdim=True)
    pq = torch.clamp(torch.round(e * (127.0 * r)), 0.0, QMAX).to(torch.int8)
    ao = _int_matmul(pq, v) * float(np.float32(float(pv_fold)))
    ao = ao.transpose(1, 2).reshape(b, n, d)
    y = _int_matmul(_rint_i8(ao), woq) * wos.float() + bo.float()
    return x + y.to(x.dtype)


def attn_block_int8_static_scores(x, sc_qk, pv_fold, ln_scale, ln_bias,
                                  wqkvq, wqkv_qs, bqkv_qs, woq, wos, bo,
                                  num_heads: int, eps: float = 1e-6,
                                  n_valid: int | None = None):
    """x (B, N, D) bf16 -> x + OutProj_int8(MHA_int8(QKV_int8(LN(x))))
    with calibrated scales: ``ln_scale``/``ln_bias`` carry 1/a_x,
    ``wqkv_qs``/``bqkv_qs`` the quant-domain panel scales, ``wos`` a_ao;
    ``sc_qk`` = s_q s_k and ``pv_fold`` = s_v / 127 / s_ao are the
    per-layer scalar dequants (floats, or one-element tensors).  Query
    rows at or past ``n_valid`` are computed (garbage, as on the TPU);
    keys there are masked.  dh 64 and an even head count, else
    ``ValueError`` (the JAX gate).

    A CPU tensor runs :func:`attn_block_int8_static_scores_plain`; a CUDA
    tensor launches the K22 kernel (bf16, the geometry
    :func:`attn_int8_scores_geometry` admits) or raises."""
    if x.dim() != 3:
        raise ValueError(f"x must be (B, n_pad, D), got {tuple(x.shape)}")
    dh = _scores_geometry(x.shape[-1], num_heads)
    if not _on_card(x):
        return attn_block_int8_static_scores_plain(
            x, sc_qk, pv_fold, ln_scale, ln_bias, wqkvq, wqkv_qs, bqkv_qs,
            woq, wos, bo, num_heads, eps=eps, n_valid=n_valid)
    b, n, d, n_valid, ops = _attn_operands(
        x, num_heads, n_valid, ln_scale, ln_bias, wqkvq, wqkv_qs, bqkv_qs,
        woq, wos, bo, gate=attn_int8_scores_geometry)
    sdq = _scores_dequant(_scalar(sc_qk, "sc_qk"), dh)
    fold = _scalar(pv_fold, "pv_fold")
    out = torch.empty_like(x)
    q8 = torch.empty((b * n, d), dtype=torch.int8, device=x.device)
    qkv8 = torch.empty((b * n, 3 * d), dtype=torch.int8, device=x.device)
    # v's third transposed for the p v product, keys padded to 16 bytes
    vt = torch.empty((b, num_heads, dh, round_up(n_valid, 16)),
                     dtype=torch.int8, device=x.device)
    with torch.cuda.device(x.device):
        lib, stream = _kernels.launch_target()
        err = lib.vft_attn_block_int8_scores(
            x.data_ptr(), *_ptrs(ops), out.data_ptr(), q8.data_ptr(),
            qkv8.data_ptr(), vt.data_ptr(), b, n, d, num_heads, n_valid,
            float(eps), sdq, fold, stream)
    _kernels.check(err, "attn_block_int8_static_scores")
    attn_block_int8_static_scores.launches += 1
    return out


attn_block_int8_static_scores.launches = 0


# ---------------------------------------------------------------------------
# The static tree past the block kernels' geometry: the JAX ``*_ref``
# functions (jnp, which XLA compiles; no Pallas), where the JAX package's
# _int8_block_fits is False (ViT-B/16 at 1024 px).  Plain torch on either
# device, as the JAX package runs them on the TPU: two-pass f32 LN, rint
# to int8, exact int8 products (_int_matmul), mha_qkv_xla's attention.
# ---------------------------------------------------------------------------

def _ln_two_pass(x, ln_scale, ln_bias, eps):
    """The ``*_ref`` functions' f32 LayerNorm: jnp.var's two-pass
    variance, then ((x - mu) * rstd) * scale + bias."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, unbiased=False, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps) * ln_scale.float()
            + ln_bias.float())


def _f32_scalar(v) -> float:
    """A per-layer scale as the JAX ``jnp.float32(v)``: rounded to f32."""
    return float(np.float32(float(v)))


def mlp_block_int8_static_ref(x, inv_ah, ln_scale, ln_bias, w1q, w1s, b1,
                              w2q, w2s, b2, eps: float = 1e-6,
                              act: str = "gelu_tanh"):
    """The JAX ``mlp_block_int8_static_ref``: x (T, D) -> x + bf16(y) with
    the folded args of :func:`mlp_block_int8_static`."""
    xq = _rint_i8(_ln_two_pass(x, ln_scale, ln_bias, eps))
    h = _int_matmul(xq, w1q) * w1s.float() + b1.float()
    hq = _rint_i8(_apply_act_scaled(h, act, _f32_scalar(inv_ah)))
    y = _int_matmul(hq, w2q) * w2s.float() + b2.float()
    return x + y.to(x.dtype)


def attn_block_int8_static_ref(x, inv_ao, ln_scale, ln_bias, wqkvq, wqkvs,
                               bqkv, woq, wos, bo, num_heads: int,
                               eps: float = 1e-6,
                               n_valid: int | None = None):
    """The JAX ``attn_block_int8_static_ref``: the folded args of
    :func:`attn_block_int8_static`; the attention output quantized with
    the static scale, everything else f32 (the exact softmax of
    ``mha_qkv_xla``)."""
    b, n, d = x.shape
    xq = _rint_i8(_ln_two_pass(x, ln_scale, ln_bias, eps))
    qkv = (_int_matmul(xq.reshape(b * n, d), wqkvq) * wqkvs.float()
           + bqkv.float()).to(x.dtype).reshape(b, n, 3 * d)
    o = mha_qkv_xla(qkv, num_heads, n_valid=n_valid).float()
    oq = _rint_i8(o.reshape(b * n, d) * _f32_scalar(inv_ao))
    y = _int_matmul(oq, woq) * wos.float() + bo.float()
    return x + y.reshape(b, n, d).to(x.dtype)


def attn_block_int8s_static_ref(x, sc_qk, pv_fold, ln_scale, ln_bias,
                                wqkvq, wqkv_qs, bqkv_qs, woq, wos, bo,
                                num_heads: int, eps: float = 1e-6,
                                n_valid: int | None = None):
    """The JAX ``attn_block_int8s_static_ref``: the folded args of
    :func:`attn_block_int8_static_scores`; the int8 panel, the scalar
    score dequant, the probabilities normalised and then quantized at the
    fixed 127 scale, int8 products throughout."""
    b, n, d = x.shape
    dh = d // num_heads
    xq = _rint_i8(_ln_two_pass(x, ln_scale, ln_bias, eps))
    qkv = _rint_i8(_int_matmul(xq.reshape(b * n, d), wqkvq)
                   * wqkv_qs.float() + bqkv_qs.float()).reshape(b, n, 3 * d)

    def heads(t):
        return t.reshape(b, n, num_heads, dh).transpose(1, 2)

    q, k, v = (heads(qkv[..., i * d:(i + 1) * d]) for i in range(3))
    s = _int_matmul(q, k.transpose(-1, -2)) * _scores_dequant(sc_qk, dh)
    s = s.clamp(_EXP_LO, _EXP_HI)
    if n_valid is not None and n_valid < n:
        keep = torch.arange(n, device=x.device) < n_valid
        s = torch.where(keep, s, torch.full_like(s, -1e30))
    e = torch.exp(s)
    r = 1.0 / e.sum(-1, keepdim=True)
    pq = torch.clamp(torch.round(e * (127.0 * r)), 0.0, QMAX).to(torch.int8)
    ao = _int_matmul(pq, v) * _f32_scalar(pv_fold)
    aoq = _rint_i8(ao.transpose(1, 2).reshape(b * n, d))
    y = _int_matmul(aoq, woq) * wos.float() + bo.float()
    return x + y.reshape(b, n, d).to(x.dtype)
