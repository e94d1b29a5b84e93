"""Whole-encoder single-launch kernels for batch-1 latency serving
(counterpart of the JAX package's ops/vit_stack.py).

Three Hopper kernels live here, each behind a wrapper that launches it on
a CUDA tensor and runs its plain PyTorch version (same arithmetic) on a
CPU tensor:

* K11 ``vit_layers`` (``csrc/vit_stack.cu``): replaces
  ``vit_fpga_tpu/ops/vit_stack.py:_stack_kernel`` (wrapper
  ``vit_layers_pallas``).  Every layer of the bf16 encoder, each the
  per-block halves with in-kernel one-pass LN statistics: LN1 -> QKV ->
  max-free masked attention -> out-proj + residual -> LN2 -> W1 + act ->
  W2 + residual; K12's layers without its patch embed and head.
* K19a ``vit_layers_int8`` (``csrc/vit_stack_int8.cu``): replaces
  ``_stack_int8_kernel`` (wrapper ``vit_layers_int8_pallas``), whose layer
  is exactly K16 then K15: int8 weights with per-column scales, per-row
  activation scales computed in the kernel.
* K19b ``vit_layers_int8_static`` (``csrc/vit_stack_int8_static.cu``):
  replaces ``_stack_int8_static_kernel`` (wrapper
  ``vit_layers_int8_static_pallas``), whose layer is exactly K18 then K17:
  the calibrated scales folded into the arguments
  (``models/quantized.quantize_vit_static``) and the per-layer 1/a_ao and
  1/a_h read from (depth,) tables by the layer the loop is on.  No row
  absmax: the attention and W1 items emit int8 aoq and hq directly, which
  the out-projection and W2 read by TMA; 7 stages and barriers a layer.

Two more run the whole model, image in and logits out:

* K12 ``vit_full`` (``csrc/vit_full.cu``): replaces
  ``_stack_full_kernel`` (wrapper ``vit_full_pallas``): the patch-embed
  GEMM (patches gathered from the NHWC image, the CLS row first, the CLS
  token, position table and patch bias folded into one f32 ``posb``
  table), K11's layers, the one-pass final LayerNorm of each image's CLS
  row cast to the head's dtype, and the head with f32 sums.
* K20 ``vit_full_int8`` (``csrc/vit_full_int8.cu``): replaces
  ``_stack_full_int8_kernel`` (wrapper ``vit_full_int8_pallas``): the
  same around K19a's layers, the embed and the head on int8 GEMMs of
  row-quantized inputs.

On the card each is ONE cooperative launch: a persistent grid walks the
layers and separates the stages with grid-wide barriers.  All five run
one layer loop, ``csrc/stack_wgmma.cuh``, in its dynamic int8 (K19a,
K20), static int8 (K19b) and bf16 (K11, K12) variants: a producer and two
consumer warpgroups a block, wgmma items of 128 x 64 fed by TMA (int8, or
bf16 with the weight through the transpose bit), the attention on
``mha_wgmma.cuh``'s max-free sweep, 7 barriers a layer.  Bounds on the
H100 at ViT-B/16 batch 1 (197 tokens): K11 reads 169.9 MB of bf16
weights (50.7 us at 3.35 TB/s) for 34.9 GFLOP (35.3 us at 989 TFLOP/s);
K19a 84.9 MB of int8 weights and 0.33 MB of scales (25.4 us) for 33.5 G
int8 operations (16.9 us): both bound by bytes, and K19b as K19a.  At
batch 4 K11's 139.6 GFLOP (141 us) makes it bound by operations.  K12
adds the patch weight, the padded head and posb (173.3 MB in all, 51.7
us), K20 their int8 forms (87.3 MB, 26.1 us).  The VMEM planner of the
JAX package (``stack_plan`` / ``stack_fits``) is a TPU artefact;
:func:`stack_supported` states what the CUDA kernels take instead.
"""

from __future__ import annotations

import math

import torch

from . import _kernels
from .attn_block import attn_block_fwd_plain
from .common import check_activation, kernel_operand, pad_sublane, round_up, \
    row_stats
from .fused_mlp import fused_mlp_stats_plain
from .quant_block import (attn_block_int8_plain,
                          attn_block_int8_static_plain,
                          mlp_block_int8_plain, mlp_block_int8_static_plain)
from .quant_block import _ln_f32
from .quant_fused import _int_matmul, _row_quant, weight_kmajor

# Activation codes of csrc/common.cuh (enum Act).
_ACT_CODES = {"gelu_tanh": 2, "quick_gelu": 3}
MAX_BATCH = 4          # latency mode, as the JAX gates
MAX_VALID = 256        # keys per (image, head) in the attention items
HEAD_DIM = 64
MAX_D = 2048           # a row pass gives each thread 8 of a row's columns
MAX_M = 4096           # ... and 16 of h's (K19a)
MAX_P3 = 4096          # K12 / K20: the patch gate (csrc/full.cuh FULL_MAX_P3)
# The kernels' optional stage clock (csrc/stack.cuh StageClock): per block
# and stage kind, ns of work and ns waiting in the grid barrier after it.
TRACE_BLOCKS, TRACE_KINDS = 1024, 16
# K11, K19a, K19b, K20 and K12 (csrc/stack_wgmma.cuh, enum LqStage): 7
# stages a layer; each name begins with its kind's comment in the enum.
# K19a and K20 quantize ao and h in the prologue of the GEMM that reads
# them.
K11_STAGES = ("LN1 rows (first layer)", "QKV items, bf16", "attention items",
              "out-proj split-K items, bf16 (f32 partials)",
              "residual + LN2 rows", "W1 + act items, bf16",
              "W2 split-K items, bf16 (f32 partials)",
              "residual + next LN1 rows")
K19A_STAGES = ("LN1 rows, int8 quant (first layer)", "QKV items, int8",
               "attention items",
               "out-proj split-K items, int8 (ao quant prologue)",
               "residual + LN2 rows, int8 quant",
               "W1 + act items, int8, row max",
               "W2 split-K items, int8 (h quant prologue)",
               "residual + next LN1 rows, int8 quant")
K19B_STAGES = ("LN1 rows, int8 rint (first layer)", "QKV items, int8",
               "attention items, int8 aoq",
               "out-proj split-K items, int8 (aoq by TMA)",
               "residual + LN2 rows, int8 rint",
               "W1 + act items, int8 scaled rint",
               "W2 split-K items, int8 (hq by TMA)",
               "residual + next LN1 rows, int8 rint")
# K20 and K12: the layers' kinds, then the patch, embed and head stages.
K20_STAGES = ("LN1 rows, int8 quant (after the embed)",) + K19A_STAGES[1:7] + (
    "residual + next LN1 rows, int8 quant (final LN after the last layer)",
    "patch rows, int8 quant", "embed items, int8", "head items, int8")
K12_STAGES = ("LN1 rows (after the embed)", "QKV items, bf16",
              "attention items", "out-proj split-K items, bf16 (f32 partials)",
              "residual + LN2 rows", "W1 + act items, bf16",
              "W2 split-K items, bf16 (f32 partials)",
              "residual + next LN1 rows (final LN after the last layer)",
              "patch rows", "embed items, bf16", "head items")


def stack_supported(num_heads: int, d: int, mlp_dim: int, n_valid: int,
                    batch: int) -> bool:
    """Whether the CUDA stack kernels take this geometry: head dim 64
    (D up to 2048), M a multiple of 64 up to 4096, 1 <= n_valid <= 256 and
    1 <= batch <= 4.  The CPU plain versions take any geometry."""
    return (num_heads > 0 and d == num_heads * HEAD_DIM and d <= MAX_D
            and 0 < mlp_dim <= MAX_M and mlp_dim % 64 == 0
            and 1 <= n_valid <= MAX_VALID and 1 <= batch <= MAX_BATCH)


def _check_act(act: str) -> None:
    if act not in _ACT_CODES:
        raise ValueError(f"unknown act {act!r}; the stack kernels take "
                         f"{sorted(_ACT_CODES)}")


def _check_dynamic(qblocks) -> None:
    if "inv_ao" in qblocks:
        raise ValueError(
            "a calibrated static-scale int8 tree (inv_ao) runs through "
            "vit_layers_int8_static (K19b); vit_layers_int8 quantizes "
            "dynamically and would be silently wrong on it")


def _check_static(qblocks) -> None:
    if "inv_ao" not in qblocks or "inv_ah" not in qblocks:
        raise ValueError("vit_layers_int8_static takes a quantize_vit_static "
                         "tree (inv_ao, inv_ah); a quantize_vit_fast tree "
                         "runs through vit_layers_int8")


def _padded(x: torch.Tensor, n_valid):
    """(x padded to a multiple of 8 rows, n, n_valid clipped to n)."""
    n = x.shape[1]
    n_valid = n if n_valid is None else min(n_valid, n)
    n_pad = round_up(n, pad_sublane(x.dtype))
    if n_pad != n:
        x = torch.nn.functional.pad(x, (0, 0, 0, n_pad - n))
    return x, n, n_valid


def _layer(blocks, i):
    return {k: v[i] for k, v in blocks.items()}


# ---------------------------------------------------------------------------
# K11: bf16 layers
# ---------------------------------------------------------------------------

def vit_layers_plain(x, blocks, num_heads: int, eps: float = 1e-6,
                     act: str = "gelu_tanh", n_valid: int | None = None):
    """Plain PyTorch version of the K11 kernel: per layer K4's plain
    forward (one-pass LN, max-free softmax) then the MLP half with one-pass
    LN statistics, weights cast to x's dtype (the JAX wrapper's
    ``astype``)."""
    _check_act(act)
    x, n, n_valid = _padded(x, n_valid)
    b, n_pad, d = x.shape
    for i in range(blocks["wqkv"].shape[0]):
        blk = _layer(blocks, i)
        x = attn_block_fwd_plain(x, blk["ln1_scale"], blk["ln1_bias"],
                                 blk["wqkv"], blk["bqkv"], blk["wo"],
                                 blk["bo"], num_heads, eps=eps,
                                 n_valid=n_valid)
        x2 = x.reshape(b * n_pad, d)
        x2, _ = fused_mlp_stats_plain(x2, row_stats(x2, eps),
                                      blk["ln2_scale"], blk["ln2_bias"],
                                      blk["w1"], blk["b1"], blk["w2"],
                                      blk["b2"], eps=eps, act=act,
                                      emit_stats=False)
        x = x2.reshape(b, n_pad, d)
    return x[:, :n]


def new_trace(device) -> torch.Tensor:
    """A zeroed stage-clock buffer for the ``trace`` argument of the
    kernels' wrappers."""
    return torch.zeros((TRACE_BLOCKS, TRACE_KINDS, 2), dtype=torch.int64,
                       device=device)


def trace_report(trace: torch.Tensor, stages, launches: int = 1) -> dict:
    """Per stage kind, in us per launch: ``wall`` (work plus barrier, the
    same for every block), ``busy_mean`` and ``busy_max`` (the work of a
    block; the max is the stage's critical path) and ``barrier`` (the
    least wait of any block: the last block to arrive waits only for the
    barrier itself).  ``barrier_share`` is the sum of ``barrier`` over the
    sum of ``wall``."""
    t = trace.cpu().double() / 1e3 / launches
    used = t.abs().sum(dim=(1, 2)) > 0
    t = t[used]
    out = {"blocks": int(used.sum())}
    walls = barriers = 0.0
    for k, name in enumerate(stages):
        busy, wait = t[:, k, 0], t[:, k, 1]
        row = dict(wall=float((busy + wait).mean()),
                   busy_mean=float(busy.mean()), busy_max=float(busy.max()),
                   barrier=float(wait.min()))
        out[name] = row
        walls += row["wall"]
        barriers += row["barrier"]
    out["total_wall"] = walls
    out["barrier_share"] = barriers / walls if walls else None
    return out


def _trace_ptr(trace, dev):
    if trace is None:
        return None
    check_activation(trace, (TRACE_BLOCKS, TRACE_KINDS, 2), torch.int64,
                     "trace")
    if trace.device != dev:
        raise ValueError(f"trace is on {trace.device}, x on {dev}")
    return trace.data_ptr()


def _cuda_geometry(x, num_heads, n_valid, mlp_dim):
    if x.dim() != 3:
        raise ValueError(f"x must be (B, N, D), got {tuple(x.shape)}")
    b, n, d = x.shape
    n_valid = n if n_valid is None else min(n_valid, n)
    if not stack_supported(num_heads, d, mlp_dim, n_valid, b):
        raise ValueError(
            f"the stack kernels (K11, K19a, K19b) take head dim {HEAD_DIM}, "
            f"D <= {MAX_D}, M a "
            f"multiple of 64 up to {MAX_M}, 1..{MAX_VALID} valid tokens and "
            f"batch 1..{MAX_BATCH} (B={b}, D={d}, {num_heads} heads, M={mlp_dim}, "
            f"n_valid={n_valid})")
    if x.dtype != torch.bfloat16:
        raise ValueError(f"the stack kernels take bfloat16 x, got {x.dtype}")


def _vectors(blocks, names, depth, dev):
    return [kernel_operand(blocks[k], (depth, blocks[k].shape[-1]),
                           torch.float32, dev, k) for k in names]


def vit_layers(x, blocks, num_heads: int, eps: float = 1e-6,
               act: str = "gelu_tanh", n_valid: int | None = None,
               trace: torch.Tensor | None = None):
    """x (B, N, D) embedded tokens -> pre-final-LN tokens (B, N, D);
    ``blocks`` the stacked per-layer dict of models/vit.py.  Rows at or past
    ``n_valid`` are computed (garbage) and their keys masked.

    A CPU tensor runs :func:`vit_layers_plain`; a CUDA tensor launches the
    K11 kernel (bf16, :func:`stack_supported`) once for all layers, or
    raises.  ``trace`` (:func:`new_trace`, CUDA only) adds the kernel's
    stage clock to it (:func:`trace_report` with ``K11_STAGES``)."""
    _check_act(act)
    if x.device.type == "cpu":
        return vit_layers_plain(x, blocks, num_heads, eps=eps, act=act,
                                n_valid=n_valid)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    depth, d, m = blocks["w1"].shape
    _cuda_geometry(x, num_heads, n_valid, m)
    x, n, n_valid = _padded(x, n_valid)
    b, n_pad, _ = x.shape
    x = x.contiguous()
    check_activation(x, (b, n_pad, d), torch.bfloat16, "x")
    dev, bf = x.device, torch.bfloat16
    ls1, lb1, bqkv, bo, ls2, lb2, b1, b2 = _vectors(
        blocks, ("ln1_scale", "ln1_bias", "bqkv", "bo", "ln2_scale",
                 "ln2_bias", "b1", "b2"), depth, dev)
    wqkv = kernel_operand(blocks["wqkv"], (depth, d, 3 * d), bf, dev, "wqkv")
    wo = kernel_operand(blocks["wo"], (depth, d, d), bf, dev, "wo")
    w1 = kernel_operand(blocks["w1"], (depth, d, m), bf, dev, "w1")
    w2 = kernel_operand(blocks["w2"], (depth, m, d), bf, dev, "w2")
    out = torch.empty_like(x)
    with torch.cuda.device(dev):
        lib, stream = _kernels.launch_target()
        work = torch.empty((lib.vft_vit_stack_workspace(b * n_pad, d, m),),
                           dtype=torch.uint8, device=dev)
        err = lib.vft_vit_layers(
            x.data_ptr(), out.data_ptr(), work.data_ptr(), ls1.data_ptr(),
            lb1.data_ptr(), wqkv.data_ptr(), bqkv.data_ptr(), wo.data_ptr(),
            bo.data_ptr(), ls2.data_ptr(), lb2.data_ptr(), w1.data_ptr(),
            b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), b, n_pad, d, m,
            depth, num_heads, n_valid, _ACT_CODES[act], float(eps),
            1.0 / math.sqrt(d // num_heads), _trace_ptr(trace, dev), stream)
    _kernels.check(err, "vit_layers")
    vit_layers.launches += 1
    return out[:, :n]


vit_layers.launches = 0


# ---------------------------------------------------------------------------
# K19a: dynamic int8 layers
# ---------------------------------------------------------------------------

def vit_layers_int8_plain(x, qblocks, num_heads: int, eps: float = 1e-6,
                          act: str = "gelu_tanh",
                          n_valid: int | None = None):
    """Plain PyTorch version of the K19a kernel: per layer the plain K16
    then the plain K15 (the JAX ``_layer_math_int8``)."""
    _check_act(act)
    _check_dynamic(qblocks)
    x, n, n_valid = _padded(x, n_valid)
    b, n_pad, d = x.shape
    for i in range(qblocks["wqkv_q"].shape[0]):
        blk = _layer(qblocks, i)
        x = attn_block_int8_plain(
            x, blk["ln1_scale"], blk["ln1_bias"], blk["wqkv_q"],
            blk["wqkv_s"], blk["bqkv"], blk["wo_q"], blk["wo_s"], blk["bo"],
            num_heads, eps=eps, n_valid=n_valid)
        x = mlp_block_int8_plain(
            x.reshape(b * n_pad, d), blk["ln2_scale"], blk["ln2_bias"],
            blk["w1_q"], blk["w1_s"], blk["b1"], blk["w2_q"], blk["w2_s"],
            blk["b2"], eps=eps, act=act).reshape(b, n_pad, d)
    return x[:, :n]


def vit_layers_int8(x, qblocks, num_heads: int, eps: float = 1e-6,
                    act: str = "gelu_tanh", n_valid: int | None = None,
                    trace: torch.Tensor | None = None):
    """x (B, N, D) bf16 -> pre-final-LN tokens through the dynamic int8
    encoder; ``qblocks`` the ``quantize_vit_fast`` blocks dict (int8 ``*_q``
    weights (L, K, N), best as ``quant_fused.kmajor`` views, with f32 column
    scales ``*_s``).  A static tree
    (``inv_ao``) raises naming ``vit_layers_int8_static``.

    A CPU tensor runs :func:`vit_layers_int8_plain`; a CUDA tensor launches
    the K19a kernel once for all layers, or raises.  ``trace`` as for
    :func:`vit_layers` (stages ``K19A_STAGES``)."""
    _check_act(act)
    _check_dynamic(qblocks)
    if x.device.type == "cpu":
        return vit_layers_int8_plain(x, qblocks, num_heads, eps=eps, act=act,
                                     n_valid=n_valid)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    depth, d, m = qblocks["w1_q"].shape
    _cuda_geometry(x, num_heads, n_valid, m)
    x, n, n_valid = _padded(x, n_valid)
    b, n_pad, _ = x.shape
    x = x.contiguous()
    dev = x.device
    (ls1, lb1, sqkv, bqkv, so, bo, ls2, lb2, s1, b1, s2, b2) = _vectors(
        qblocks, ("ln1_scale", "ln1_bias", "wqkv_s", "bqkv", "wo_s", "bo",
                  "ln2_scale", "ln2_bias", "w1_s", "b1", "w2_s", "b2"),
        depth, dev)
    wqkv = weight_kmajor(qblocks["wqkv_q"], (depth, d, 3 * d), dev,
                         "wqkv_q")
    wo = weight_kmajor(qblocks["wo_q"], (depth, d, d), dev, "wo_q")
    w1 = weight_kmajor(qblocks["w1_q"], (depth, d, m), dev, "w1_q")
    w2 = weight_kmajor(qblocks["w2_q"], (depth, m, d), dev, "w2_q")
    out = torch.empty_like(x)
    with torch.cuda.device(dev):
        lib, stream = _kernels.launch_target()
        work = torch.empty(
            (lib.vft_vit_stack_int8_workspace(b * n_pad, d, m),),
            dtype=torch.uint8, device=dev)
        err = lib.vft_vit_layers_int8(
            x.data_ptr(), out.data_ptr(), work.data_ptr(), ls1.data_ptr(),
            lb1.data_ptr(), wqkv.data_ptr(), sqkv.data_ptr(),
            bqkv.data_ptr(), wo.data_ptr(), so.data_ptr(), bo.data_ptr(),
            ls2.data_ptr(), lb2.data_ptr(), w1.data_ptr(), s1.data_ptr(),
            b1.data_ptr(), w2.data_ptr(), s2.data_ptr(), b2.data_ptr(), b,
            n_pad, d, m, depth, num_heads, n_valid, _ACT_CODES[act],
            float(eps), 1.0 / math.sqrt(d // num_heads),
            _trace_ptr(trace, dev), stream)
    _kernels.check(err, "vit_layers_int8")
    vit_layers_int8.launches += 1
    return out[:, :n]


vit_layers_int8.launches = 0


# ---------------------------------------------------------------------------
# K19b: calibrated static-scale int8 layers
# ---------------------------------------------------------------------------

def vit_layers_int8_static_plain(x, qblocks, num_heads: int,
                                 eps: float = 1e-6, act: str = "gelu_tanh",
                                 n_valid: int | None = None):
    """Plain PyTorch version of the K19b kernel: per layer the plain K18
    then the plain K17 with that layer's 1/a_ao and 1/a_h (the JAX
    ``_layer_math_int8_static``)."""
    _check_act(act)
    _check_static(qblocks)
    x, n, n_valid = _padded(x, n_valid)
    b, n_pad, d = x.shape
    for i in range(qblocks["wqkv_q"].shape[0]):
        blk = _layer(qblocks, i)
        x = attn_block_int8_static_plain(
            x, blk["inv_ao"], blk["ln1_scale"], blk["ln1_bias"],
            blk["wqkv_q"], blk["wqkv_s"], blk["bqkv"], blk["wo_q"],
            blk["wo_s"], blk["bo"], num_heads, eps=eps, n_valid=n_valid)
        x = mlp_block_int8_static_plain(
            x.reshape(b * n_pad, d), blk["inv_ah"], blk["ln2_scale"],
            blk["ln2_bias"], blk["w1_q"], blk["w1_s"], blk["b1"],
            blk["w2_q"], blk["w2_s"], blk["b2"], eps=eps,
            act=act).reshape(b, n_pad, d)
    return x[:, :n]


def vit_layers_int8_static(x, qblocks, num_heads: int, eps: float = 1e-6,
                           act: str = "gelu_tanh",
                           n_valid: int | None = None,
                           trace: torch.Tensor | None = None):
    """x (B, N, D) bf16 -> pre-final-LN tokens through the calibrated
    static-scale int8 encoder; ``qblocks`` the ``quantize_vit_static``
    blocks dict (folded scales, int8 ``*_q`` weights (L, K, N), best as
    ``quant_fused.kmajor`` views, and the (L, 1) tables ``inv_ao`` and
    ``inv_ah``, which the kernel reads on the card: no host sync).

    A CPU tensor runs :func:`vit_layers_int8_static_plain`; a CUDA tensor
    launches the K19b kernel once for all layers, or raises.  ``trace`` as
    for :func:`vit_layers` (stages ``K19B_STAGES``)."""
    _check_act(act)
    _check_static(qblocks)
    if x.device.type == "cpu":
        return vit_layers_int8_static_plain(x, qblocks, num_heads, eps=eps,
                                            act=act, n_valid=n_valid)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    depth, d, m = qblocks["w1_q"].shape
    _cuda_geometry(x, num_heads, n_valid, m)
    x, n, n_valid = _padded(x, n_valid)
    b, n_pad, _ = x.shape
    x = x.contiguous()
    dev = x.device
    (ls1, lb1, sqkv, bqkv, so, bo, ls2, lb2, s1, b1, s2, b2, inv_ao,
     inv_ah) = _vectors(
        qblocks, ("ln1_scale", "ln1_bias", "wqkv_s", "bqkv", "wo_s", "bo",
                  "ln2_scale", "ln2_bias", "w1_s", "b1", "w2_s", "b2",
                  "inv_ao", "inv_ah"), depth, dev)
    wqkv = weight_kmajor(qblocks["wqkv_q"], (depth, d, 3 * d), dev,
                         "wqkv_q")
    wo = weight_kmajor(qblocks["wo_q"], (depth, d, d), dev, "wo_q")
    w1 = weight_kmajor(qblocks["w1_q"], (depth, d, m), dev, "w1_q")
    w2 = weight_kmajor(qblocks["w2_q"], (depth, m, d), dev, "w2_q")
    out = torch.empty_like(x)
    with torch.cuda.device(dev):
        lib, stream = _kernels.launch_target()
        work = torch.empty(
            (lib.vft_vit_stack_int8_static_workspace(b * n_pad, d, m),),
            dtype=torch.uint8, device=dev)
        err = lib.vft_vit_layers_int8_static(
            x.data_ptr(), out.data_ptr(), work.data_ptr(), ls1.data_ptr(),
            lb1.data_ptr(), wqkv.data_ptr(), sqkv.data_ptr(),
            bqkv.data_ptr(), wo.data_ptr(), so.data_ptr(), bo.data_ptr(),
            ls2.data_ptr(), lb2.data_ptr(), w1.data_ptr(), s1.data_ptr(),
            b1.data_ptr(), w2.data_ptr(), s2.data_ptr(), b2.data_ptr(),
            inv_ao.data_ptr(), inv_ah.data_ptr(), b, n_pad, d, m, depth,
            num_heads, n_valid, _ACT_CODES[act], float(eps),
            1.0 / math.sqrt(d // num_heads), _trace_ptr(trace, dev), stream)
    _kernels.check(err, "vit_layers_int8_static")
    vit_layers_int8_static.launches += 1
    return out[:, :n]


vit_layers_int8_static.launches = 0


# ---------------------------------------------------------------------------
# K12 and K20: the whole model in one launch
# ---------------------------------------------------------------------------

def full_supported(num_heads: int, d: int, mlp_dim: int, n_tokens: int,
                   batch: int, patch: int) -> bool:
    """Whether the CUDA whole-model kernels take this geometry: what
    :func:`stack_supported` asks of the layers (``n_tokens`` valid rows) and
    a patch of ``3 * patch**2`` values, a multiple of 16 up to ``MAX_P3``.
    The CPU plain versions take any geometry."""
    p3 = 3 * patch * patch
    return (stack_supported(num_heads, d, mlp_dim, n_tokens, batch)
            and p3 % 16 == 0 and p3 <= MAX_P3)


def _n_tokens(images: torch.Tensor, patch: int) -> int:
    if images.dim() != 4 or images.shape[-1] != 3:
        raise ValueError(f"images must be (B, H, W, 3), got "
                         f"{tuple(images.shape)}")
    _, h, w, _ = images.shape
    if h % patch or w % patch:
        raise ValueError(f"image {h}x{w} is not a whole grid of "
                         f"{patch}-pixel patches")
    return 1 + (h // patch) * (w // patch)


def patch_rows(images: torch.Tensor, patch: int, n_pad: int,
               dtype: torch.dtype) -> torch.Tensor:
    """(B, H, W, 3) -> (B, n_pad, 3 patch^2) in ``dtype``: one zero row
    for the CLS token, the row-major patch grid with pixels in (py, px, c)
    order, zero tail rows (the JAX forwards' padded ``patchify``)."""
    n = _n_tokens(images, patch)
    b, h, w, c = images.shape
    x = images.to(dtype).reshape(b, h // patch, patch, w // patch, patch, c)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, n - 1, patch * patch * c)
    return torch.nn.functional.pad(x, (0, 0, 1, n_pad - n))


def vit_full_plain(images, wp, posb, blocks, lf_scale, lf_bias, wh, bh,
                   num_heads: int, patch: int, eps: float = 1e-6,
                   act: str = "gelu_tanh"):
    """Plain PyTorch version of the K12 kernel (the JAX
    ``_stack_full_kernel``): tok = (pp Wp + posb) in f32, cast to wp's
    dtype; :func:`vit_layers_plain`; the one-pass f32 LayerNorm of each
    CLS row, cast to wh's dtype; logits = xn Wh + bh in f32.  Returns (B,
    cls_pad) f32."""
    _check_act(act)
    n_pad = posb.shape[0]
    n = _n_tokens(images, patch)
    dt = wp.dtype
    pp = patch_rows(images, patch, n_pad, dt)
    tok = (pp.float() @ wp.float() + posb.float()).to(dt)
    tok = vit_layers_plain(tok, blocks, num_heads, eps=eps, act=act,
                           n_valid=n)
    xn = _ln_f32(tok[:, 0], lf_scale, lf_bias, eps).to(wh.dtype)
    return xn.float() @ wh.float() + bh.float()


def vit_full_int8_plain(images, wpq, wps, posb, qblocks, lf_scale, lf_bias,
                        whq, whs, bh, num_heads: int, patch: int,
                        eps: float = 1e-6, act: str = "gelu_tanh"):
    """Plain PyTorch version of the K20 kernel (the JAX
    ``_stack_full_int8_kernel``): each bf16 patch row quantized
    (``_row_quant``), tok = bf16(float(pq wpq) * (sp * wps) + posb);
    :func:`vit_layers_int8_plain`; the one-pass f32 LayerNorm of each CLS
    row, quantized from f32; logits = float(rq whq) * (rs * whs) + bh.
    Returns (B, cls_pad) f32."""
    _check_act(act)
    _check_dynamic(qblocks)
    n_pad = posb.shape[0]
    n = _n_tokens(images, patch)
    pq, sp = _row_quant(patch_rows(images, patch, n_pad,
                                   torch.bfloat16).float())
    tok = (_int_matmul(pq, wpq) * (sp * wps.float())
           + posb.float()).to(torch.bfloat16)
    tok = vit_layers_int8_plain(tok, qblocks, num_heads, eps=eps, act=act,
                                n_valid=n)
    rq, rs = _row_quant(_ln_f32(tok[:, 0], lf_scale, lf_bias, eps))
    return _int_matmul(rq, whq) * (rs * whs.float()) + bh.float()


def _full_geometry(images, num_heads, posb, mlp_dim, patch):
    """Checks a CUDA call of K12 / K20 meets before it launches: (n_tokens,
    n_pad, D, p3), or raises."""
    n = _n_tokens(images, patch)
    b = images.shape[0]
    n_pad, d = posb.shape
    if not full_supported(num_heads, d, mlp_dim, n, b, patch):
        raise ValueError(
            f"the whole-model kernels (K12, K20) take what the stack "
            f"kernels take "
            f"(head dim {HEAD_DIM}, D <= {MAX_D}, M a multiple of 64 up to "
            f"{MAX_M}, 1..{MAX_VALID} tokens, batch 1..{MAX_BATCH}) and "
            f"3 patch^2 a multiple of 16 up to {MAX_P3} (B={b}, D={d}, "
            f"{num_heads} heads, M={mlp_dim}, {n} tokens, patch {patch})")
    if n_pad < n:
        raise ValueError(f"posb has {n_pad} rows for {n} tokens")
    return n, n_pad, d, 3 * patch * patch


def _image_operand(images):
    """The image as K12 / K20 read it: f32 or bf16 (other dtypes cast to
    bf16, as the JAX forwards' ``astype``), contiguous."""
    if images.dtype not in (torch.float32, torch.bfloat16):
        images = images.to(torch.bfloat16)
    return images.contiguous()


def vit_full(images, wp, posb, blocks, lf_scale, lf_bias, wh, bh,
             num_heads: int, patch: int, eps: float = 1e-6,
             act: str = "gelu_tanh", trace: torch.Tensor | None = None):
    """(B, H, W, 3) images -> (B, cls_pad) f32 logits through the whole
    bf16 model: ``wp`` the (3 patch^2, D) patch weight, ``posb`` the
    (n_pad, D) f32 fold (CLS row first, zero tail rows), ``blocks`` the
    stacked per-layer dict, ``wh`` / ``bh`` the head padded to cls_pad
    columns (``models/vit.prep_full_latency``).

    A CPU tensor runs :func:`vit_full_plain`; a CUDA tensor launches the
    K12 kernel (bf16, :func:`full_supported`) once, or raises.  ``trace``
    (:func:`new_trace`) adds the kernel's stage clock to it
    (``K12_STAGES``)."""
    _check_act(act)
    if images.device.type == "cpu":
        return vit_full_plain(images, wp, posb, blocks, lf_scale, lf_bias,
                              wh, bh, num_heads, patch, eps=eps, act=act)
    if images.device.type != "cuda":
        raise ValueError(f"unsupported device {images.device}")
    depth, _, m = blocks["w1"].shape
    n, n_pad, d, p3 = _full_geometry(images, num_heads, posb, m, patch)
    if wp.dtype != torch.bfloat16:
        raise ValueError(f"K12 takes a bfloat16 model, got wp {wp.dtype}")
    images = _image_operand(images)
    b, h, w, _ = images.shape
    dev, bf, f32 = images.device, torch.bfloat16, torch.float32
    cls_pad = wh.shape[-1]
    wp = kernel_operand(wp, (p3, d), bf, dev, "wp")
    posb = kernel_operand(posb, (n_pad, d), f32, dev, "posb")
    ls1, lb1, bqkv, bo, ls2, lb2, b1, b2 = _vectors(
        blocks, ("ln1_scale", "ln1_bias", "bqkv", "bo", "ln2_scale",
                 "ln2_bias", "b1", "b2"), depth, dev)
    wqkv = kernel_operand(blocks["wqkv"], (depth, d, 3 * d), bf, dev, "wqkv")
    wo = kernel_operand(blocks["wo"], (depth, d, d), bf, dev, "wo")
    w1 = kernel_operand(blocks["w1"], (depth, d, m), bf, dev, "w1")
    w2 = kernel_operand(blocks["w2"], (depth, m, d), bf, dev, "w2")
    lfs = kernel_operand(lf_scale, (d,), f32, dev, "lf_scale")
    lfb = kernel_operand(lf_bias, (d,), f32, dev, "lf_bias")
    wh = kernel_operand(wh, (d, cls_pad), bf, dev, "wh")
    bh = kernel_operand(bh, (cls_pad,), f32, dev, "bh")
    logits = torch.empty((b, cls_pad), dtype=f32, device=dev)
    with torch.cuda.device(dev):
        lib, stream = _kernels.launch_target()
        work = torch.empty(
            (lib.vft_vit_full_workspace(b * n_pad, d, m, p3),),
            dtype=torch.uint8, device=dev)
        err = lib.vft_vit_full(
            images.data_ptr(), logits.data_ptr(), work.data_ptr(),
            wp.data_ptr(), posb.data_ptr(), ls1.data_ptr(), lb1.data_ptr(),
            wqkv.data_ptr(), bqkv.data_ptr(), wo.data_ptr(), bo.data_ptr(),
            ls2.data_ptr(), lb2.data_ptr(), w1.data_ptr(), b1.data_ptr(),
            w2.data_ptr(), b2.data_ptr(), lfs.data_ptr(), lfb.data_ptr(),
            wh.data_ptr(), bh.data_ptr(), int(images.dtype == f32), h, w,
            patch, b, n_pad, d, m, depth, num_heads, n, cls_pad,
            _ACT_CODES[act], float(eps), 1.0 / math.sqrt(d // num_heads),
            _trace_ptr(trace, dev), stream)
    _kernels.check(err, "vit_full")
    vit_full.launches += 1
    return logits


vit_full.launches = 0


def vit_full_int8(images, wpq, wps, posb, qblocks, lf_scale, lf_bias, whq,
                  whs, bh, num_heads: int, patch: int, eps: float = 1e-6,
                  act: str = "gelu_tanh", trace: torch.Tensor | None = None):
    """(B, H, W, 3) images -> (B, cls_pad) f32 logits through the whole
    dynamic int8 model: ``wpq`` / ``wps`` the int8 patch weight (best as a
    ``quant_fused.kmajor`` view) and its column scales, ``posb`` as for
    :func:`vit_full`, ``qblocks`` the ``quantize_vit_fast`` blocks,
    ``whq`` (D, cls_pad) int8 row-major, ``whs`` (padded with 1.0) and
    ``bh`` the padded head (``models/quantized.prep_full_int8_latency``).
    A static tree (``inv_ao``) raises.

    A CPU tensor runs :func:`vit_full_int8_plain`; a CUDA tensor launches
    the K20 kernel once, or raises.  ``trace`` as for :func:`vit_full`
    (``K20_STAGES``)."""
    _check_act(act)
    _check_dynamic(qblocks)
    if images.device.type == "cpu":
        return vit_full_int8_plain(images, wpq, wps, posb, qblocks, lf_scale,
                                   lf_bias, whq, whs, bh, num_heads, patch,
                                   eps=eps, act=act)
    if images.device.type != "cuda":
        raise ValueError(f"unsupported device {images.device}")
    depth, _, m = qblocks["w1_q"].shape
    n, n_pad, d, p3 = _full_geometry(images, num_heads, posb, m, patch)
    images = _image_operand(images)
    b, h, w, _ = images.shape
    dev, f32 = images.device, torch.float32
    cls_pad = whq.shape[-1]
    wpq = weight_kmajor(wpq, (p3, d), dev, "wpq")
    wps = kernel_operand(wps, (d,), f32, dev, "wps")
    posb = kernel_operand(posb, (n_pad, d), f32, dev, "posb")
    (ls1, lb1, sqkv, bqkv, so, bo, ls2, lb2, s1, b1, s2, b2) = _vectors(
        qblocks, ("ln1_scale", "ln1_bias", "wqkv_s", "bqkv", "wo_s", "bo",
                  "ln2_scale", "ln2_bias", "w1_s", "b1", "w2_s", "b2"),
        depth, dev)
    wqkv = weight_kmajor(qblocks["wqkv_q"], (depth, d, 3 * d), dev,
                         "wqkv_q")
    wo = weight_kmajor(qblocks["wo_q"], (depth, d, d), dev, "wo_q")
    w1 = weight_kmajor(qblocks["w1_q"], (depth, d, m), dev, "w1_q")
    w2 = weight_kmajor(qblocks["w2_q"], (depth, m, d), dev, "w2_q")
    lfs = kernel_operand(lf_scale, (d,), f32, dev, "lf_scale")
    lfb = kernel_operand(lf_bias, (d,), f32, dev, "lf_bias")
    if whq.dtype != torch.int8:
        raise ValueError(f"whq must be int8, got {whq.dtype}")
    whq = kernel_operand(whq, (d, cls_pad), torch.int8, dev, "whq")
    whs = kernel_operand(whs, (cls_pad,), f32, dev, "whs")
    bh = kernel_operand(bh, (cls_pad,), f32, dev, "bh")
    logits = torch.empty((b, cls_pad), dtype=f32, device=dev)
    with torch.cuda.device(dev):
        lib, stream = _kernels.launch_target()
        work = torch.empty(
            (lib.vft_vit_full_int8_workspace(b * n_pad, d, m, p3),),
            dtype=torch.uint8, device=dev)
        err = lib.vft_vit_full_int8(
            images.data_ptr(), logits.data_ptr(), work.data_ptr(),
            wpq.data_ptr(), wps.data_ptr(), posb.data_ptr(), ls1.data_ptr(),
            lb1.data_ptr(), wqkv.data_ptr(), sqkv.data_ptr(),
            bqkv.data_ptr(), wo.data_ptr(), so.data_ptr(), bo.data_ptr(),
            ls2.data_ptr(), lb2.data_ptr(), w1.data_ptr(), s1.data_ptr(),
            b1.data_ptr(), w2.data_ptr(), s2.data_ptr(), b2.data_ptr(),
            lfs.data_ptr(), lfb.data_ptr(), whq.data_ptr(), whs.data_ptr(),
            bh.data_ptr(), int(images.dtype == f32), h, w, patch, b, n_pad,
            d, m, depth, num_heads, n, cls_pad, _ACT_CODES[act], float(eps),
            1.0 / math.sqrt(d // num_heads), _trace_ptr(trace, dev), stream)
    _kernels.check(err, "vit_full_int8")
    vit_full_int8.launches += 1
    return logits


vit_full_int8.launches = 0
