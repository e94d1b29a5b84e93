"""Int8 transformer-block halves (counterpart of the JAX package's
ops/quant_block.py): the int8 serving paths' encoders, dynamic (K15, K16)
and calibrated static-scale (K17, K18).

Four Hopper kernels live here, each behind a wrapper that launches it on
a CUDA tensor and runs its plain PyTorch version (same arithmetic) on a
CPU tensor:

* K15 ``mlp_block_int8`` (``csrc/mlp_int8.cu``): replaces
  ``vit_fpga_tpu/ops/quant_block.py:_mlp_int8_kernel`` (wrapper
  ``mlp_block_int8``).  One-pass LN -> row quant -> int8 GEMM1 ->
  dequant + bias -> fma tanh-GELU (or quick_gelu, relu) in f32 -> row
  quant of the f32 h over its whole row -> int8 GEMM2 -> dequant + bias
  -> ``x + bf16(y)``.
* K16 ``attn_block_int8`` (``csrc/attn_int8.cu``): replaces
  ``_attn_int8_kernel`` (wrapper ``attn_block_int8``).  One-pass LN ->
  row quant -> int8 QKV GEMM -> ``bf16(dequant + bias)`` -> the max-free
  masked attention of K1 (bf16 scores and PV, keys at or past ``n_valid``
  masked) -> row quant of f32(ao) over all heads -> int8 out-projection ->
  dequant + bias -> ``x + bf16(y)``.
* K17 ``mlp_block_int8_static`` (``csrc/mlp_int8_static.cu``): replaces
  ``_mlp_int8_static_kernel`` (wrapper ``mlp_block_int8_static``).  The
  calibrated scales are folded into the arguments
  (``models/quantized.quantize_vit_static``): the LN affine carries 1/a_x,
  so LN -> rint/saturate to int8 -> int8 GEMM1 -> ``acc * s1' + b1`` ->
  the activation times 1/a_h (``_apply_act_scaled``) -> rint/saturate ->
  int8 GEMM2 -> ``acc * s2' + b2`` -> ``x + bf16(y)``.  No row absmax and
  no division: GEMM1's epilogue emits int8 h.
* K18 ``attn_block_int8_static`` (``csrc/attn_int8_static.cu``): replaces
  ``_attn_int8_static_kernel`` (wrapper ``attn_block_int8_static``).
  Folded LN -> rint/saturate -> int8 QKV -> ``bf16(acc * s' + b)`` -> the
  max-free masked attention with 1/a_ao in the post-PV reciprocal, ao
  rounded to bf16 in the quant domain -> rint/saturate in the attention
  tile's epilogue -> int8 out-projection -> ``acc * so' + bo`` ->
  ``x + bf16(y)``.

Bounds on the H100 at ViT-B/16 batch 64 (T = 12 800 rows, D = 768,
M = 3072, 12 heads of 64, n_valid 197), set by tensor-core operations at
1979 int8 TOPS and 989 bf16 TFLOP/s: K15 and K17 4·T·D·M = 120.8 G int8
operations (61 us) against about 44 MB of compulsory traffic; K16 and K18
8·T·D² = 60.4 G int8 operations (31 us) plus 7.8 GFLOP of bf16 attention
(8 us) against about 42 MB.  Design: row passes and the shared wmma int8
GEMM (``csrc/quant.cuh``) with dequantizing epilogues.  A dynamic row's
scale spans blocks that run apart on Hopper (h's 3072 columns, ao's 12
heads), so K15's GEMM1 writes f32 h with per-block row maxima that a row
pass reduces before it quantizes, and K16's ao round-trips in bf16 before
its row pass.  The static scale is known before the launch, so K17's
GEMM1 and K18's attention tile emit int8 directly (later work: keep the
activations on chip, wgmma).

Unlike the dynamic kernels, where ``|x / s| <= 127`` by construction, the
static kernels' saturation is live: activations beyond the calibrated
absmax clip at +-127 (``_rint_i8``).

The plain versions copy the Pallas bodies (one-pass LN, the fma GELU,
the max-free softmax, the static kernels' bf16 ao), not the JAX ``*_ref``
functions (two-pass LN, exact softmax, f32 ao).
"""

from __future__ import annotations

import math

import torch

from . import _kernels
from .attn_block import _mha_tpu, attn_plan
from .common import check_activation, kernel_operand, round_up
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
# K15: MLP half
# ---------------------------------------------------------------------------

def mlp_block_int8_plain(x, ln_scale, ln_bias, w1q, w1s, b1, w2q, w2s, b2,
                         eps: float = 1e-6, act: str = "gelu_tanh"):
    """Plain PyTorch version of the K15 kernel (the TPU kernel's body)."""
    xq, sx = _row_quant(_ln_f32(x, ln_scale, ln_bias, eps))
    h = _apply_act(_dequant(xq, w1q, sx, w1s, b1), act)
    hq, sh = _row_quant(h)
    y = _dequant(hq, w2q, sh, w2s, b2)
    return x + y.to(x.dtype)


def mlp_block_int8(x, ln_scale, ln_bias, w1q, w1s, b1, w2q, w2s, b2,
                   eps: float = 1e-6, act: str = "gelu_tanh"):
    """x (T, D) bf16 -> x + MLP_int8(LN(x)); w1q (D, M) and w2q (M, D)
    int8, w*s (N,) f32 column scales, biases f32.

    A CPU tensor runs :func:`mlp_block_int8_plain`; a CUDA tensor
    launches the K15 kernel (bf16, D and M multiples of 16) or raises."""
    if act not in _ACT_CODES:
        raise ValueError(f"unknown act {act!r}")
    if x.device.type == "cpu":
        return mlp_block_int8_plain(x, ln_scale, ln_bias, w1q, w1s, b1, w2q,
                                    w2s, b2, eps=eps, act=act)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dim() != 2:
        raise ValueError(f"x must be (T, D), got {tuple(x.shape)}")
    t, d = x.shape
    m = w1q.shape[-1]
    if d % 16 or m % 16:
        raise ValueError(f"kernel needs D and M divisible by 16 (D={d}, "
                         f"M={m})")
    check_activation(x, (t, d), torch.bfloat16, "x")
    dev = x.device
    f32 = torch.float32
    ls = kernel_operand(ln_scale, (d,), f32, dev, "ln_scale")
    lb = kernel_operand(ln_bias, (d,), f32, dev, "ln_bias")
    w1 = weight_kmajor(w1q, (d, m), dev, "w1q")
    s1 = kernel_operand(w1s, (m,), f32, dev, "w1s")
    b1 = kernel_operand(b1, (m,), f32, dev, "b1")
    w2 = weight_kmajor(w2q, (m, d), dev, "w2q")
    s2 = kernel_operand(w2s, (d,), f32, dev, "w2s")
    b2 = kernel_operand(b2, (d,), f32, dev, "b2")
    out = torch.empty_like(x)
    q8 = torch.empty((t * max(d, m),), dtype=torch.int8, device=dev)
    sc = torch.empty((t,), dtype=f32, device=dev)
    h = torch.empty((t, m), dtype=f32, device=dev)
    parts = torch.empty((-(-m // 128), t), dtype=f32, device=dev)
    with torch.cuda.device(dev):
        lib, stream = _kernels.launch_target()
        err = lib.vft_mlp_block_int8(
            x.data_ptr(), ls.data_ptr(), lb.data_ptr(), w1.data_ptr(),
            s1.data_ptr(), b1.data_ptr(), w2.data_ptr(), s2.data_ptr(),
            b2.data_ptr(), out.data_ptr(), q8.data_ptr(), sc.data_ptr(),
            h.data_ptr(), parts.data_ptr(), t, d, m, _ACT_CODES[act],
            float(eps), stream)
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
    n = x.shape[1]
    n_valid = n if n_valid is None else min(n_valid, n)
    xq, sx = _row_quant(_ln_f32(x, ln_scale, ln_bias, eps))
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
    launches the K16 kernel (bf16, head dim 64, n_valid <= 256) or
    raises."""
    if x.device.type == "cpu":
        return attn_block_int8_plain(x, ln_scale, ln_bias, wqkvq, wqkvs,
                                     bqkv, woq, wos, bo, num_heads, eps=eps,
                                     n_valid=n_valid)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dim() != 3:
        raise ValueError(f"x must be (B, n_pad, D), got {tuple(x.shape)}")
    b, n, d = x.shape
    n_valid = n if n_valid is None else min(n_valid, n)
    if d % num_heads or d // num_heads != 64 or not 1 <= n_valid <= 256:
        raise ValueError(f"kernel takes head dim 64 and 1..256 valid tokens "
                         f"(D={d}, {num_heads} heads, n_valid={n_valid})")
    check_activation(x, (b, n, d), torch.bfloat16, "x")
    dev = x.device
    f32, bf = torch.float32, torch.bfloat16
    ls = kernel_operand(ln_scale, (d,), f32, dev, "ln_scale")
    lb = kernel_operand(ln_bias, (d,), f32, dev, "ln_bias")
    wqkv = weight_kmajor(wqkvq, (d, 3 * d), dev, "wqkvq")
    sqkv = kernel_operand(wqkvs, (3 * d,), f32, dev, "wqkvs")
    bqkv = kernel_operand(bqkv, (3 * d,), f32, dev, "bqkv")
    wo = weight_kmajor(woq, (d, d), dev, "woq")
    so = kernel_operand(wos, (d,), f32, dev, "wos")
    bo = kernel_operand(bo, (d,), f32, dev, "bo")
    rows = b * n
    out = torch.empty_like(x)
    q8 = torch.empty((rows, d), dtype=torch.int8, device=dev)
    sc = torch.empty((rows,), dtype=f32, device=dev)
    qkv = torch.empty((rows, 3 * d), dtype=bf, device=dev)
    ao = torch.empty((rows, d), dtype=bf, device=dev)
    with torch.cuda.device(dev):
        lib, stream = _kernels.launch_target()
        err = lib.vft_attn_block_int8(
            x.data_ptr(), ls.data_ptr(), lb.data_ptr(), wqkv.data_ptr(),
            sqkv.data_ptr(), bqkv.data_ptr(), wo.data_ptr(), so.data_ptr(),
            bo.data_ptr(), out.data_ptr(), q8.data_ptr(), sc.data_ptr(),
            qkv.data_ptr(), ao.data_ptr(), b, n, d, num_heads, n_valid,
            float(eps), 1.0 / math.sqrt(d // num_heads), stream)
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
        return hh + hh * torch.tanh(u)
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
    if x.device.type == "cpu":
        return mlp_block_int8_static_plain(x, inv_ah, ln_scale, ln_bias, w1q,
                                           w1s, b1, w2q, w2s, b2, eps=eps,
                                           act=act)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dim() != 2:
        raise ValueError(f"x must be (T, D), got {tuple(x.shape)}")
    t, d = x.shape
    m = w1q.shape[-1]
    if d % 16 or m % 16:
        raise ValueError(f"kernel needs D and M divisible by 16 (D={d}, "
                         f"M={m})")
    check_activation(x, (t, d), torch.bfloat16, "x")
    inv = _scalar(inv_ah, "inv_ah")
    dev = x.device
    f32 = torch.float32
    ls = kernel_operand(ln_scale, (d,), f32, dev, "ln_scale")
    lb = kernel_operand(ln_bias, (d,), f32, dev, "ln_bias")
    w1 = weight_kmajor(w1q, (d, m), dev, "w1q")
    s1 = kernel_operand(w1s, (m,), f32, dev, "w1s")
    b1 = kernel_operand(b1, (m,), f32, dev, "b1")
    w2 = weight_kmajor(w2q, (m, d), dev, "w2q")
    s2 = kernel_operand(w2s, (d,), f32, dev, "w2s")
    b2 = kernel_operand(b2, (d,), f32, dev, "b2")
    out = torch.empty_like(x)
    xq = torch.empty((t, d), dtype=torch.int8, device=dev)
    hq = torch.empty((t, m), dtype=torch.int8, device=dev)
    with torch.cuda.device(dev):
        lib, stream = _kernels.launch_target()
        err = lib.vft_mlp_block_int8_static(
            x.data_ptr(), ls.data_ptr(), lb.data_ptr(), w1.data_ptr(),
            s1.data_ptr(), b1.data_ptr(), w2.data_ptr(), s2.data_ptr(),
            b2.data_ptr(), out.data_ptr(), xq.data_ptr(), hq.data_ptr(), t,
            d, m, _ACT_CODES[act], float(eps), inv, stream)
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
    launches the K18 kernel (bf16, head dim 64, n_valid <= 256) or
    raises."""
    if x.device.type == "cpu":
        return attn_block_int8_static_plain(x, inv_ao, ln_scale, ln_bias,
                                            wqkvq, wqkvs, bqkv, woq, wos, bo,
                                            num_heads, eps=eps,
                                            n_valid=n_valid)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dim() != 3:
        raise ValueError(f"x must be (B, n_pad, D), got {tuple(x.shape)}")
    b, n, d = x.shape
    n_valid = n if n_valid is None else min(n_valid, n)
    if d % num_heads or d // num_heads != 64 or not 1 <= n_valid <= 256:
        raise ValueError(f"kernel takes head dim 64 and 1..256 valid tokens "
                         f"(D={d}, {num_heads} heads, n_valid={n_valid})")
    check_activation(x, (b, n, d), torch.bfloat16, "x")
    inv = _scalar(inv_ao, "inv_ao")
    dev = x.device
    f32 = torch.float32
    ls = kernel_operand(ln_scale, (d,), f32, dev, "ln_scale")
    lb = kernel_operand(ln_bias, (d,), f32, dev, "ln_bias")
    wqkv = weight_kmajor(wqkvq, (d, 3 * d), dev, "wqkvq")
    sqkv = kernel_operand(wqkvs, (3 * d,), f32, dev, "wqkvs")
    bqkv = kernel_operand(bqkv, (3 * d,), f32, dev, "bqkv")
    wo = weight_kmajor(woq, (d, d), dev, "woq")
    so = kernel_operand(wos, (d,), f32, dev, "wos")
    bo = kernel_operand(bo, (d,), f32, dev, "bo")
    rows = b * n
    out = torch.empty_like(x)
    q8 = torch.empty((rows, d), dtype=torch.int8, device=dev)
    qkv = torch.empty((rows, 3 * d), dtype=torch.bfloat16, device=dev)
    with torch.cuda.device(dev):
        lib, stream = _kernels.launch_target()
        err = lib.vft_attn_block_int8_static(
            x.data_ptr(), ls.data_ptr(), lb.data_ptr(), wqkv.data_ptr(),
            sqkv.data_ptr(), bqkv.data_ptr(), wo.data_ptr(), so.data_ptr(),
            bo.data_ptr(), out.data_ptr(), q8.data_ptr(), qkv.data_ptr(), b,
            n, d, num_heads, n_valid, float(eps),
            1.0 / math.sqrt(d // num_heads), inv, stream)
    _kernels.check(err, "attn_block_int8_static")
    attn_block_int8_static.launches += 1
    return out


attn_block_int8_static.launches = 0
