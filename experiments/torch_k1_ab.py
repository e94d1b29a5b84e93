"""K1's, K2's, K5's, K3's, K26's, K4's, K24's, K23's, K6's, K13's, K9's,
K19a's, K20's, K19b's, K12's, K11's, K15's, K16's, K21a's, K18's, K21b's,
K17's, K22's, K14's or K10's time at a shape, from the package tree
found under ROOT, so that two versions of the port are compared in one
call on one card.

Run on a machine with a Hopper card, from the repository root:

    python3 experiments/torch_k1_ab.py [ROOT]
        [--kernel k1|k2|k5|k3|k26|k4|k24|k23|k6|k13|k9|k19a|k20|k19b|k12|
                  k11|k15|k16|k21a|k18|k21b|k17|k22|k14|k10]
        [--shape B N_PAD N_VALID D HEADS]
        [--mlp-shape T D M] [--one-consumer] [--qgemm VARIANT] [--a-region]
        [--k15 VARIANT] [--k16 VARIANT] [--k14 VARIANT]

ROOT (default: this repository) holds the ``vit_fpga_tpu_torch`` package to
time, e.g. a ``git archive`` of another commit unpacked under ``_chip/``; its
kernels build into its own ``_build/``.  ``--kernel k1`` (the default) times
``attn_block_stats`` at ``--shape``, by default ViT-B/16 at batch 64: (64,
200, 768), 197 valid tokens, 12 heads; ``--kernel k2`` times
``fused_mlp_stats`` (gelu_tanh) at ``--mlp-shape``, by default ViT-B/16's
(12 800, 768) x 3072; ``--kernel k5`` times ``fused_mlp_fwd`` (gelu_tanh)
at ViT-B/16 b64's (12 800, 768) x 3072, ViT-B/16 @1024 b1's (4104, 768) x
3072 and CLIP ViT-L/14 b1's (264, 1024) x 4096, each beside its library
call (LN + addmm + tanh-GELU + addmm), with K1 and K2 at their defaults
as controls, then the ViT-B/16 @1024 b1 forward and the b64 SGD step;
``--kernel k3`` times ``fused_mlp_chunked_stats`` (2 chunks, gelu_tanh) at
CLIP ViT-L/14 b64's (16 896, 1024) x 4096, ViT-L/16 b64's (12 800, 1024) x
4096, CLIP ViT-L/14 b2's (528, 1024) x 4096 and ViT-L/16 @384 b16's (9 344,
1024) x 4096, the first beside its library call (LN + two chunks of addmm +
tanh-GELU + addmm) and its device time alone, with K1, K2 and K5 at their
defaults as controls, then the CLIP ViT-L/14 b64 forward from uint8;
``--kernel k26`` times ``streamed_gemm`` in bf16 at ViT-L/16 @384 b1's MLP
up-projection, (584, 1024) x (1024, 4096), beside ``torch.matmul``, each
per call (CUDA events around 20 calls) and device alone (torch.profiler's
kernel time over 200 back-to-back calls, ``device_alone_ms``), and device
alone at K 64, 256 and 2048 (1, 4 and 32 of the GEMM's 64-deep K steps);
``--kernel k4`` times ``attn_block_fwd`` in both softmax modes at ViT-B/16
b64's (64, 200, 768) with 197 valid keys and 12 heads, and at b1 with 264
and 584 rows (257 and 577 valid, 16 heads), each shape beside its library
call (LN + addmm + SDPA with the key mask + addmm), the b64 launches step
by step (``device_steps``: torch.profiler's device time of each kernel),
K1, K2, K5, K3 (CLIP ViT-L/14 b64) and K7 bf16 ((1, 4104, 2304)) as
controls, then the ViT-L/16 @224 b64 ``safe_softmax`` forward; ``--kernel
k24`` times ``fused_mlp_bwd`` at ViT-B/16 b64's (12 800, 768) x 3072 for
each activation, beside the autograd backward of LN + addmm + tanh-GELU +
addmm (which saves the forward's activations), step by step, with K1, K2
and K5 as controls, then the b64 SGD step; ``--kernel k23`` times
``attn_block_bwd`` at ViT-B/16 b64's (64, 200, 768) with 197 valid keys
and at ViT-B/16 @384 b8's (8, 584, 768) with 577 (a tree whose K23 refuses
a shape skips it), each beside the autograd backward of LN + addmm + SDPA
with the key mask + addmm, the b64 launches step by step, with K1, K2, K5
and K24 as controls, then the b64 SGD step and the ViT-B/16 @384 b4 SGD
step (where the tree trains it); ``--kernel k6`` times
``fused_mlp_chunked_fwd`` (gelu_tanh) at ViT-L/16 b8's (1600, 1024) x 4096
in 2 chunks and ViT-H/14 b8's (2112, 1280) x 5120 in 4, each beside its
library call (LN + each chunk's addmm + tanh-GELU + addmm) and device
alone, step by step, with K1, K2, K5 and K3 as controls; ``--kernel k13``
times ``int8_gemm`` at the dense net's (10 000, 784) x 256 and (10 000,
256) x 10, ViT-B's (12 800, 768) x 3072 and the per-tensor int8 forward's
(12 608, 768) x 2304 and (12 608, 3072) x 768, per call and device alone,
each beside ``torch._int_mm`` on the shape padded to what it takes, then
the per-tensor int8 ViT-B/16 b64 forward (``make_vit_forward_int8``, 50
K13 + 12 K7 f32) and the dense net's int8 forward at batch 10 000 on the
card (2 K13); ``--kernel k9`` times ``flash_attention`` on ViT-B/16 @1024's
packed (B, 4104, 2304) qkv with 4097 valid keys at bk 128, b1 and b4, and
at (1, 12, 4104, 64) with bk 512, per call and device alone, each beside
SDPA with the key mask, with K7 bf16 at (1, 4104, 2304) and K4 at (64,
200, 768) as controls, then the ViT-B/16 @1024 b1 forward in bf16 (12 K9
+ 12 K5) and in dynamic int8 (12 K9 + 49 K14); ``--kernel k19a`` times
``vit_layers_int8`` (ViT-B/16 width, depth 12, 197 valid tokens on 200
rows) at b1 and b4, per call and device alone, beside the 12 layers as
PyTorch calls (``chip_smoke._stack_library``), with ``vit_layers_int8_
static`` (K19b) as the unchanged control; ``--kernel k20`` times
``vit_full_int8`` on (B, 224, 224, 3) images the same way beside
``chip_smoke._full_library``, with ``vit_full`` (K12) as the control;
``--kernel k19b`` times ``vit_layers_int8_static`` the same way as k19a,
beside ``chip_smoke._stack_library`` with per-tensor static scales, and
``--kernel k12`` times ``vit_full`` beside ``chip_smoke._full_library`` in
bf16, each with K11 (``vit_layers``), K19a and K20 as the controls;
``--kernel k11`` times ``vit_layers`` the same way beside
``chip_smoke._stack_library`` in bf16, with K12 and K19b as the controls.
All five take their seeded inputs from the tree's own ``chip_smoke.py``.
``--kernel k14`` times ``int8_linear_fused`` at the ViT-B/16 head, (64,
768) x 1000, and at ViT-B/16 @1024 b2's per-linear shapes, (8208, 768) x
2304 with the LN, x 768, x 3072 with gelu_tanh and (8208, 3072) x 768,
each per call, device alone and step by step, the head and W1 beside
their library calls (the row quantization in torch ops, ``torch._int_mm``,
the dequantization and activation), then the dynamic int8 ViT-B/16 @1024
b1 and b2 forwards (the per-linear route, 49 K14 + 12 K9 a batch);
``--kernel k10`` times
``patch_embed_pallas`` at ViT-B/16 b64 and CLIP ViT-L/14 b64, bf16 and f32
out, per call, device alone and step by step, beside the library call
(``torch.matmul`` of the patchified f32 image, TF32 off, + bias);
``--kernel k15`` times ``mlp_block_int8`` (gelu_tanh) at ``--mlp-shape``,
by default ViT-B/16 b64's (12 800, 768) x 3072, per call, device alone and
step by step, first checked against its plain version in the int8 band,
beside its library call (F.layer_norm, the row quantization in torch ops,
torch._int_mm, tanh-GELU), with K16 at b64 as the control.
``--kernel k16`` times ``attn_block_int8`` at ViT-B/16 b64's (64, 200,
768) with 197 valid keys per call, device alone and step by step, and at
ViT-B/16 @384 b16's (16, 584, 768) with 577 per call and device alone (a
tree whose K16 refuses it skips it), on chip_smoke.py's timing inputs,
each first checked against its plain version in the int8 band (one row in
a hundred may be requantized, as in the int8 chain's checks) and beside
its library call (F.layer_norm, the
row quantization in torch ops, torch._int_mm, SDPA with the key mask),
with K15 at b64 as the control, then the dynamic int8 ViT-B/16 b64
forward and the @384 b16 one (where the tree serves it) from uint8;
``--kernel k21a`` times ``mlp_block_int8_stats`` (gelu_tanh, f32 stats
that are not x's own, emitting stats) at ``--mlp-shape`` the same way as
``--kernel k15``, beside its library call (the LN from the stats, K15's
torch ops, the next stats in torch ops), with K15 and K16 at b64 as the
controls, then the b64 forward with the int8 stats chain switched on and
the dynamic one.
``--kernel k18`` times ``attn_block_int8_static`` and ``--kernel k21b``
``attn_block_int8_stats`` (f32 stats of x, emitting stats) as ``--kernel
k16`` times K16: at (64, 200, 768) with 197 valid keys per call, device
alone and step by step, and at (16, 584, 768) with 577 per call and device
alone (a tree whose kernel refuses it skips it), on chip_smoke.py's timing
inputs (K18 calibrated on its own input, as ``_static_attn_args``), each
first checked against its plain version in the int8 band and beside its
library call (the torch ops of ``chip_smoke._static_library`` for K18; the
LN from the stats, the row quantization in torch ops, torch._int_mm, SDPA
with the key mask and the next stats in torch ops for K21b), with K16 and
K15 at b64 as the controls, then the forwards through them from uint8:
the static int8 ViT-B/16 b64 and @384 b16 (K18), or the dynamic one and
the int8 stats chain at both (K21b), where the tree serves them.
``--kernel k17`` times ``mlp_block_int8_static`` (gelu_tanh) at ViT-B/16
b64's (12 800, 768) x 3072 and ``--kernel k22``
``attn_block_int8_static_scores`` at (64, 200, 768) with 197 valid keys
and at (16, 584, 768) with 577 (a tree whose kernel refuses it skips it),
on chip_smoke.py's timing inputs (calibrated on their own input, as
``_static_mlp_args`` and ``_scores_args``), each first checked against
its plain version in the static int8 band (K22 with FLIP_ROWS'
allowance), per call, device alone and step by step, beside its library
call (chip_smoke's ``_static_library``; for K22 the rint in torch ops,
torch._int_mm and SDPA on the int8 panel), with K18 and K15 at b64 as
the controls, then the static int8 ViT-B/16 b64 and @384 b16 forwards
from uint8 and, with k22, the int8-scores ones (``_INT8_SCORES`` on),
where the tree serves them.
Prints five CUDA-event estimates of 20 launches each (``emit_stats`` on,
seeded inputs at chip_smoke.py's scales; 5 calls of a forward or step)
beside the card's name and power limit, and one JSON line.
``--one-consumer`` times a copy of ROOT's package (made under ROOT's
git-ignored ``_chip/k1_one_consumer/``) whose attention kernel
(``csrc/mha_wgmma.cuh``) takes 64 query rows a block on one consumer
warpgroup instead of 128 on two: Q's TMA box shrinks to 64 rows, K's and
V's stay 128, and the ring (4 stages, 137 KB) keeps one block an SM.
``--qgemm VARIANT`` times a copy of ROOT's package (under ROOT's
``_chip/qgemm_VARIANT/``) whose int8 GEMM (``csrc/qgemm_wgmma.cuh``, K13)
has another tile width, ring depth or staging of its int32 tiles (4
stages and 2 staged 8 KB pieces a consumer warpgroup as built):
``tile128`` / ``tile256`` 128- / 256-wide tiles at every N, ``s2_b8`` 2
stages and the whole tile staged (8 pieces at 256 columns, 4 at 128),
``s3_b4`` 3 stages and 4 pieces at 256 columns, ``s4_regs`` no staging
(every output stored from the registers, as those TMA cannot take).
``--a-region`` times a copy of ROOT's package (under ROOT's
``_chip/a_region/``) whose single-launch layer loop lays out the dynamic
variant's 64 KB quantised-A region for the static and bf16 variants too
(K19b, K12), so that they keep as little L1 as K19a and K20.
``--k15 VARIANT`` times ``--kernel k15`` from a copy (under ROOT's
``_chip/k15_VARIANT/``) whose K15 epilogues (``csrc/qgemm_wgmma.cuh``)
leave out part of their work, to weigh it (its output is then wrong and
not checked): ``noact`` without the activation of W1's h; ``rolled_k``
with the per-row pass's four steps of four columns rolled (one copy of
the arithmetic, the loads of each step after the one before);
``w2_tile256`` with W2 on 256-wide tiles, as W1, instead of 128.
``--k16 VARIANT`` times ``--kernel k16`` from a copy (under ROOT's
``_chip/k16_VARIANT/``) whose int8 GEMM takes other tile widths:
``qkv_tile128`` K16's QKV (the bf16 epilogue) on 128-wide tiles instead
of 256; ``out_tile256`` K16's out-projection (the residual epilogue at K
768) on 256-wide tiles instead of 128, K15's W2 (K 3072) unchanged;
``qkv_noepi`` K16's QKV without its epilogue's per-row pass (the int32
pieces staged and the output pieces stored, nothing computed: its output
is then wrong and not checked), to weigh the epilogue.
``--k14 tile256`` times ``--kernel k14`` from a copy whose K14 GEMM takes
256-wide tiles where N > 128 (K13's widths) in place of 128 at every N.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

# (file under csrc/, text, replacement) of the one-consumer copy.
ONE_CONSUMER = (
    ("mha_wgmma.cuh", "constexpr int MW_CONSUMERS = 2;",
     "constexpr int MW_CONSUMERS = 1;"),
    # the two-consumer block's launch bound (at most 168 registers a
    # thread), so that the producer's setmaxnreg.dec to 24 frees more than
    # the consumer's .inc to 240 takes
    ("mha_wgmma.cuh", "__launch_bounds__(MW_THREADS, 1)",
     "__launch_bounds__(384, 1)"),
    ("mha_wgmma.cuh",
     'static_assert(MW_KT == MW_BQ, "one box shape serves Q, K and V");', ""),
    ("mha_wgmma.cuh", "int in_r, int rows, int heads, int batch) {",
     "int in_r, int rows, int heads, int batch, int box_rows = MW_KT) {"),
    ("mha_wgmma.cuh", "(cuuint32_t)MW_DH, (cuuint32_t)MW_KT, 1, 1}",
     "(cuuint32_t)MW_DH, (cuuint32_t)box_rows, 1, 1}"),
    ("attn_half.cuh", "3 * d, n_pad, heads, batch)",
     "3 * d, n_pad, heads, batch, MW_BQ)"),
    ("mha.cu", "in_r, n, heads, batch)", "in_r, n, heads, batch, MW_BQ)"),
)


# (file under csrc/, text, replacement) of each --qgemm variant.
_QW = "qgemm_wgmma.cuh"
_TILE_N = "{ return N <= 128 ? 128 : 256; }"
QGEMM_VARIANTS = {
    "tile128": ((_QW, _TILE_N, "{ return 128; }"),),
    "tile256": ((_QW, _TILE_N, "{ return 256; }"),),
    "s2_b8": ((_QW, "QW_STAGES_256 = 4;", "QW_STAGES_256 = 2;"),
              (_QW, "QW_EPI_BUFS_256 = 2;", "QW_EPI_BUFS_256 = 8;"),
              (_QW, "QW_EPI_BUFS_128 = 2;", "QW_EPI_BUFS_128 = 4;")),
    "s3_b4": ((_QW, "QW_STAGES_256 = 4;", "QW_STAGES_256 = 3;"),
              (_QW, "QW_EPI_BUFS_256 = 2;", "QW_EPI_BUFS_256 = 4;")),
    "s4_regs": ((_QW, "QW_EPI_BUFS_256 = 2;", "QW_EPI_BUFS_256 = 1;"),
                (_QW, "QW_EPI_BUFS_128 = 2;", "QW_EPI_BUFS_128 = 1;"),
                (_QW, "const bool tma_store = N % 4 == 0;",
                 "const bool tma_store = false;")),
}


# (file under csrc/, text, replacement) of each --k15 variant.
K15_VARIANTS = {
    "noact": ((_QW, "f[e] = act_rn(f[e], p.act);", ""),),
    "rolled_k": ((_QW, "#pragma unroll\n      for (int k = 0; k < 4; ++k) {",
                  "#pragma unroll 1\n      for (int k = 0; k < 4; ++k) {"),),
    "w2_tile256": ((_QW, "EPI == QW_RESID ? 128 : qgemm_wgmma_tile_n(p.N);",
                    "qgemm_wgmma_tile_n(p.N);"),),
}
# (file under csrc/, text, replacement) of each --k16 variant.
K16_VARIANTS = {
    "qkv_tile128": ((_QW, "EPI == QW_RESID ? 128 : qgemm_wgmma_tile_n(p.N);",
                     "EPI == QW_H ? qgemm_wgmma_tile_n(p.N) : 128;"),),
    "out_tile256": ((_QW, "EPI == QW_RESID ? 128 : qgemm_wgmma_tile_n(p.N);",
                     "EPI == QW_RESID && p.K > 1024 ? 128 : "
                     "qgemm_wgmma_tile_n(p.N);"),),
    "qkv_noepi": ((_QW, "    if (rin && cb < p.N) {",
                   "    if (EPI != QW_BF16 && rin && cb < p.N) {"),),
}


# (file under csrc/, text, replacement) of each --k14 variant: K14's GEMM
# on K13's tile widths (256 where N > 128) in place of 128 at every N.
K14_VARIANTS = {
    "tile256": ((_QW, "EPI == QW_RESID || EPI == QW_ACT ? 128",
                 "EPI == QW_RESID ? 128"),),
}


def patched_copy(root: Path, name: str, edits) -> Path:
    """ROOT's package (and its chip_smoke.py, whose inputs some kernels
    take) copied under ROOT's ``_chip/name/`` with ``edits`` (file under
    csrc/, text, replacement) made, each text found once."""
    copy = root / "_chip" / name
    # over an earlier copy, whose _build/ a later run reuses
    shutil.copytree(root / "vit_fpga_tpu_torch", copy / "vit_fpga_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"),
                    dirs_exist_ok=True)
    shutil.copy2(root / "chip_smoke.py", copy / "chip_smoke.py")
    for file, old, new in edits:
        src = copy / "vit_fpga_tpu_torch" / "csrc" / file
        text = src.read_text()
        if text.count(old) != 1:
            raise RuntimeError(f"{file}: {old!r} not found once")
        src.write_text(text.replace(old, new))
    return copy


# The single-launch layer loop (csrc/stack_wgmma.cuh) with the shared A
# region the dynamic int8 variant quantises into laid out for every
# variant: K19b and K12 then take 216 KB of shared memory, not 150 KB
# (64 KB less L1).
A_REGION = (
    ("stack_wgmma.cuh", "(v == LQ_DYN ? LQ_A_BYTES : 0)", "LQ_A_BYTES"),
    ("stack_wgmma.cuh", "(V == LQ_DYN ? LQ_A_BYTES : 0)", "LQ_A_BYTES"),
)


def one_consumer_copy(root: Path) -> Path:
    return patched_copy(root, "k1_one_consumer", ONE_CONSUMER)


def time_k5_paths(g):
    """The paths that run K5, five estimates each: the bf16 ViT-B/16 @1024
    b1 forward from uint8 on the card (12 K9 + 12 K5) and the b64 SGD step
    (:func:`time_sgd_step`)."""
    import torch
    from vit_fpga_tpu_torch.models import vit
    from vit_fpga_tpu_torch.utils.timing import time_cuda
    cfg = vit.config("vit_b16", image_size=1024, dtype="bfloat16")
    fwd = vit.make_forward(cfg, vit.init_params(cfg, g, device="cuda"))
    img = torch.randint(0, 256, (1, 1024, 1024, 3), generator=g,
                        dtype=torch.uint8).cuda()
    out = {"ViT-B/16 @1024 b1 forward (uint8 in)":
           [time_cuda(lambda: fwd(img), iters=5, warmup=2) for _ in range(5)]}
    out.update(time_sgd_step(g))
    return out


def time_sgd_step(g):
    """The bf16 b64 SGD(1e-4) step at 224 px (12 K4 + 12 K5 forward, 12
    K24 + 12 K23 backward), seeded random weights, five estimates of 5
    steps."""
    import torch
    from vit_fpga_tpu_torch.models import vit
    from vit_fpga_tpu_torch.train import trainer as tr
    from vit_fpga_tpu_torch.utils.timing import time_cuda
    out = {}
    cfg = vit.config("vit_b16", dtype="bfloat16")
    params, opt = tr.init_train_state(
        cfg, tr.sgd(1e-4), params=vit.init_params(cfg, g, device="cuda"))
    images = vit.preprocess(torch.randint(0, 256, (64, 224, 224, 3),
                                          generator=g, dtype=torch.uint8),
                            cfg).float().cuda()
    labels = torch.zeros((64,), dtype=torch.int64, device="cuda")
    step = tr.make_vit_train_step(cfg)
    out["b64 SGD step"] = [
        time_cuda(lambda: step(params, opt, images, labels), iters=5,
                  warmup=2) for _ in range(5)]
    return out


def time_sgd_step_384(g, batch=4):
    """The bf16 SGD(1e-4) step of ViT-B/16 @384 at ``batch`` (577 tokens:
    K4 and K23 past 256 keys), five estimates of 3 steps; nothing where
    the tree's K23 refuses the length."""
    import torch
    from vit_fpga_tpu_torch.models import vit
    from vit_fpga_tpu_torch.train import trainer as tr
    from vit_fpga_tpu_torch.utils.timing import time_cuda
    cfg = vit.config("vit_b16", image_size=384, dtype="bfloat16")
    params, opt = tr.init_train_state(
        cfg, tr.sgd(1e-4), params=vit.init_params(cfg, g, device="cuda"))
    images = vit.preprocess(torch.randint(0, 256, (batch, 384, 384, 3),
                                          generator=g, dtype=torch.uint8),
                            cfg).float().cuda()
    labels = torch.zeros((batch,), dtype=torch.int64, device="cuda")
    step = tr.make_vit_train_step(cfg)
    try:
        step(params, opt, images, labels)
    except ValueError as e:
        print(f"ViT-B/16 @384 b{batch} SGD step: not trained here ({e})")
        return {}
    return {f"ViT-B/16 @384 b{batch} SGD step": [
        time_cuda(lambda: step(params, opt, images, labels), iters=3,
                  warmup=1) for _ in range(5)]}


def device_alone_ms(fn, iters=200):
    """Device ms per call of ``fn``: torch.profiler's CUDA kernel time over
    ``iters`` back-to-back calls, each kernel's mean times its launches a
    call (a record the profiler dropped does not count), so the host work
    of the wrapper is out."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = sum(e.device_time_total / e.count * round(e.count / iters)
                for e in prof.key_averages()
                if e.device_time_total > 0 and e.count >= iters // 2)
    if total <= 0:
        raise RuntimeError("torch.profiler saw no device time")
    return total / 1e3


def device_steps(fn, iters=20):
    """Device ms per call of each kernel ``fn`` launches (torch.profiler
    over ``iters`` back-to-back calls, as :func:`device_alone_ms`), keyed
    by the kernel's name: the steps of a launch sequence, each alone."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return {e.key[:90]: e.device_time_total / iters / 1e3
            for e in prof.key_averages()
            if e.device_time_total > 0 and e.count >= iters // 2}


def time_k13_paths(g):
    """The paths that run K13, five estimates each: the per-tensor int8
    ViT-B/16 b64 forward from uint8 (quantize_vit of seeded f32 weights:
    50 K13 + 12 K7 in f32) and the dense net's int8 forward (784 -> [256,
    10], 2 K13) on a (10 000, 784) f32 batch already on the card."""
    import numpy as np
    import torch
    from vit_fpga_tpu_torch.backends.cuda import NetCUDA
    from vit_fpga_tpu_torch.defines import ACT_IDENTITY, ACT_RELU2, random_net
    from vit_fpga_tpu_torch.models import quantized, vit
    from vit_fpga_tpu_torch.utils.timing import time_cuda
    cfg = vit.config("vit_b16", dtype="float32")
    fwd = quantized.make_vit_forward_int8(cfg, quantized.quantize_vit(
        vit.init_params(cfg, g, device="cuda")))
    img = torch.randint(0, 256, (64, 224, 224, 3), generator=g,
                        dtype=torch.uint8).cuda()
    out = {"per-tensor int8 ViT-B/16 b64 forward (uint8 in)":
           [time_cuda(lambda: fwd(img), iters=5, warmup=2)
            for _ in range(5)]}
    net = NetCUDA(random_net(784, [256, 10], seed=0,
                             activations=[ACT_RELU2, ACT_IDENTITY]),
                  compute_dtype="int8")
    x = np.random.default_rng(64).integers(0, 256, (10000, 784)) / 255.0
    net.forward_batch(x[:8].astype(np.float32))  # quantizes the weights once
    xt = torch.tensor(x, dtype=torch.float32, device="cuda")
    with torch.no_grad():
        out["dense int8 forward b10000 (input on the card)"] = [
            time_cuda(lambda: net._forward_int8(xt), iters=20, warmup=5)
            for _ in range(5)]
    return out


def time_k9_paths(g):
    """The paths that run K9, five estimates each: the ViT-B/16 @1024 b1
    forward from uint8, bf16 (12 K9 + 12 K5) and dynamic int8
    (quantize_vit_fast: 12 K9 + 49 K14), seeded random weights."""
    import torch
    from vit_fpga_tpu_torch.models import quantized, vit
    from vit_fpga_tpu_torch.utils.timing import time_cuda
    cfg = vit.config("vit_b16", image_size=1024, dtype="bfloat16")
    params = vit.init_params(cfg, g, device="cuda")
    img = torch.randint(0, 256, (1, 1024, 1024, 3), generator=g,
                        dtype=torch.uint8).cuda()
    fwd = vit.make_forward(cfg, params)
    fq = quantized.make_forward_int8(cfg, quantized.quantize_vit_fast(params))
    return {"ViT-B/16 @1024 b1 bf16 forward (uint8 in)":
            [time_cuda(lambda: fwd(img), iters=5, warmup=2)
             for _ in range(5)],
            "ViT-B/16 @1024 b1 dynamic int8 forward (uint8 in)":
            [time_cuda(lambda: fq(img), iters=5, warmup=2)
             for _ in range(5)]}


def time_k14_paths(g):
    """The path that runs K14 most, five estimates each: the dynamic int8
    ViT-B/16 @1024 b1 and b2 (the serve's batch) forwards from uint8
    (quantize_vit_fast of seeded weights: the per-linear route, 49 K14 +
    12 K9 a batch)."""
    import torch
    from vit_fpga_tpu_torch.models import quantized, vit
    from vit_fpga_tpu_torch.utils.timing import time_cuda
    cfg = vit.config("vit_b16", image_size=1024, dtype="bfloat16")
    fq = quantized.make_forward_int8(
        cfg, quantized.quantize_vit_fast(vit.init_params(cfg, g,
                                                         device="cuda")))
    img = torch.randint(0, 256, (2, 1024, 1024, 3), generator=g,
                        dtype=torch.uint8).cuda()
    return {f"ViT-B/16 @1024 b{b} dynamic int8 forward (uint8 in)":
            [time_cuda(lambda: fq(img[:b]), iters=5, warmup=2)
             for _ in range(5)] for b in (1, 2)}


def time_int8_forwards(g, kernel):
    """The int8 ViT-B/16 forwards from uint8 on seeded random weights,
    five estimates of 5 calls each: at b64 the dynamic one (quantize_vit_
    fast: 12 K16 + 12 K15 + K14), with ``kernel`` k18 the static one
    instead (quantize_vit_static: 12 K18 + 12 K17 + K14), as with k17
    and k22; with k16, k18, k21b, k17 and k22 also at @384 b16 where the
    tree serves it; with k21a and k21b also with the int8 stats chain on
    (12 K21b + 12 K21a + K14), with k22 the static tree with the
    int8-scores attention on (12 K22 + 12 K17 + K14)."""
    import torch
    from vit_fpga_tpu_torch.models import quantized, vit
    from vit_fpga_tpu_torch.utils.timing import time_cuda
    out = {}
    for image, batch in ((224, 64), (384, 16)):
        if image == 384 and kernel not in ("k16", "k18", "k21b", "k17",
                                           "k22"):
            continue
        cfg = vit.config("vit_b16", image_size=image, dtype="bfloat16")
        params = vit.init_params(cfg, g, device="cuda")
        static = kernel in ("k18", "k17", "k22")
        fq = quantized.make_forward_int8(
            cfg, quantized.quantize_vit_static(params, cfg) if static
            else quantized.quantize_vit_fast(params))
        img = torch.randint(0, 256, (batch, image, image, 3), generator=g,
                            dtype=torch.uint8).cuda()
        tree = "static" if static else "dynamic"
        label = f"ViT-B/16 @{image} b{batch} {tree} int8 forward (uint8 in)"
        try:
            fq(img)
            out[label] = [time_cuda(lambda: fq(img), iters=5, warmup=2)
                          for _ in range(5)]
        except ValueError as e:
            print(f"{label}: not served by this tree ({e})")
        switch = {"k21a": "_INT8_STATS_CHAIN", "k21b": "_INT8_STATS_CHAIN",
                  "k22": "_INT8_SCORES"}.get(kernel)
        if switch is not None:
            what = ("int8 stats chain" if switch == "_INT8_STATS_CHAIN"
                    else "int8-scores")
            label = f"ViT-B/16 @{image} b{batch} {what} forward (uint8 in)"
            setattr(quantized, switch, True)
            try:
                fq(img)
                out[label] = [time_cuda(lambda: fq(img), iters=5, warmup=2)
                              for _ in range(5)]
            except ValueError as e:
                print(f"{label}: not served by this tree ({e})")
            finally:
                setattr(quantized, switch, False)
    return out


def time_safe_forward(g):
    """The bf16 ViT-L/16 @224 b64 forward with ``safe_softmax`` (the
    per-block path: 24 K4 in the safe mode and the MLP half the JAX plan
    picks), seeded random weights, five estimates of 5 calls."""
    import torch
    from vit_fpga_tpu_torch.models import vit
    from vit_fpga_tpu_torch.utils.timing import time_cuda
    cfg = vit.config("vit_l16", dtype="bfloat16", safe_softmax=True)
    fwd = vit.make_forward(cfg, vit.init_params(cfg, g, device="cuda"))
    img = torch.randint(0, 256, (64, 224, 224, 3), generator=g,
                        dtype=torch.uint8).cuda()
    return {"ViT-L/16 @224 b64 safe_softmax forward (uint8 in)":
            [time_cuda(lambda: fwd(img), iters=5, warmup=2)
             for _ in range(5)]}


def time_clip_forward(g):
    """The bf16 CLIP ViT-L/14 @224 b64 forward from uint8 (24 K1 + 24 K3),
    seeded random weights, five estimates of 5 calls."""
    import torch
    from vit_fpga_tpu_torch.models import clip
    from vit_fpga_tpu_torch.utils.timing import time_cuda
    cfg = clip.clip_vision_config("vit_l14", dtype="bfloat16")
    fwd = clip.make_forward(cfg, clip.init_params(cfg, 768, g,
                                                  device="cuda"))
    img = torch.randint(0, 256, (64, cfg.image_size, cfg.image_size, 3),
                        generator=g, dtype=torch.uint8).cuda()
    return {"CLIP ViT-L/14 b64 forward (uint8 in)":
            [time_cuda(lambda: fwd(img), iters=5, warmup=2)
             for _ in range(5)]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("root", nargs="?",
                    default=str(Path(__file__).resolve().parent.parent))
    ap.add_argument("--kernel",
                    choices=("k1", "k2", "k5", "k3", "k26", "k4", "k24",
                             "k23", "k6", "k13", "k9", "k19a", "k20",
                             "k19b", "k12", "k11", "k15", "k16", "k21a",
                             "k18", "k21b", "k17", "k22", "k14", "k10"),
                    default="k1")
    ap.add_argument("--shape", type=int, nargs=5,
                    default=[64, 200, 197, 768, 12],
                    metavar=("B", "N_PAD", "N_VALID", "D", "HEADS"))
    ap.add_argument("--mlp-shape", type=int, nargs=3,
                    default=[12800, 768, 3072], metavar=("T", "D", "M"))
    ap.add_argument("--one-consumer", action="store_true")
    ap.add_argument("--qgemm", choices=sorted(QGEMM_VARIANTS))
    ap.add_argument("--a-region", action="store_true")
    ap.add_argument("--k15", choices=sorted(K15_VARIANTS))
    ap.add_argument("--k16", choices=sorted(K16_VARIANTS))
    ap.add_argument("--k14", choices=sorted(K14_VARIANTS))
    args = ap.parse_args()
    root = Path(args.root).resolve()
    if args.one_consumer:
        root = one_consumer_copy(root)
    if args.qgemm:
        root = patched_copy(root, f"qgemm_{args.qgemm}",
                            QGEMM_VARIANTS[args.qgemm])
    if args.a_region:
        root = patched_copy(root, "a_region", A_REGION)
    if args.k15:
        root = patched_copy(root, f"k15_{args.k15}", K15_VARIANTS[args.k15])
    if args.k16:
        root = patched_copy(root, f"k16_{args.k16}", K16_VARIANTS[args.k16])
    if args.k14:
        root = patched_copy(root, f"k14_{args.k14}", K14_VARIANTS[args.k14])
    sys.path.insert(0, str(root))
    import torch
    from vit_fpga_tpu_torch.ops import attn_block as ab
    from vit_fpga_tpu_torch.ops import fused_mlp as fm
    from vit_fpga_tpu_torch.ops.common import row_stats
    from vit_fpga_tpu_torch.utils.timing import time_cuda
    if not torch.cuda.is_available():
        print("torch_k1_ab: no CUDA device", file=sys.stderr)
        return 1
    if Path(ab.__file__).resolve().parents[2] != root:
        raise RuntimeError(f"imported {ab.__file__}, not the tree at {root}")
    g = torch.Generator()
    g.manual_seed(3)

    def randn(*shape, std=1.0, mean=0.0):
        return (torch.randn(shape, generator=g) * std + mean).cuda()

    def k1_run(b, n_pad, n_valid, d, heads):
        x = randn(b, n_pad, d).to(torch.bfloat16)
        st = row_stats(x, 1e-6)
        p = (randn(d, std=0.1, mean=1.0), randn(d, std=0.1),
             randn(d, 3 * d, std=0.06).to(torch.bfloat16),
             randn(3 * d, std=0.02),
             randn(d, d, std=0.02).to(torch.bfloat16), randn(d, std=0.02))
        return lambda: ab.attn_block_stats(x, st, *p, heads, eps=1e-6,
                                           n_valid=n_valid, emit_stats=True)

    def mlp_inputs(t, d, m):
        x = randn(t, d).to(torch.bfloat16)
        p = (randn(d, std=0.1, mean=1.0), randn(d, std=0.1),
             randn(d, m, std=d ** -0.5).to(torch.bfloat16),
             randn(m, std=0.02),
             randn(m, d, std=m ** -0.5).to(torch.bfloat16),
             randn(d, std=0.02))
        return x, p

    def k2_run(t, d, m):
        x, p = mlp_inputs(t, d, m)
        st = row_stats(x, 1e-6)
        return lambda: fm.fused_mlp_stats(x, st, *p, eps=1e-6,
                                          act="gelu_tanh", emit_stats=True)

    import torch.nn.functional as F
    device, steps = {}, {}

    def k4_run(b, n_pad, n_valid, d, heads, safe):
        x = randn(b, n_pad, d).to(torch.bfloat16)
        p = (randn(d, std=0.1, mean=1.0), randn(d, std=0.1),
             randn(d, 3 * d, std=0.06).to(torch.bfloat16),
             randn(3 * d, std=0.02),
             randn(d, d, std=0.02).to(torch.bfloat16), randn(d, std=0.02))

        def lib(x=x, p=p, b=b, n_pad=n_pad, d=d, heads=heads):
            # LN + addmm + SDPA with the key mask + addmm + residual, bf16
            ls, lb, wqkv, bqkv, wo, bo = (t.to(torch.bfloat16) for t in p)
            rows, keep = b * n_pad, (torch.arange(n_pad, device="cuda")
                                     < n_valid)[None, None, None]
            h = F.layer_norm(x, (d,), ls, lb, 1e-6).reshape(rows, d)
            qkv = torch.addmm(bqkv, h, wqkv).view(b, n_pad, 3, heads, 64)
            q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
            ao = F.scaled_dot_product_attention(q, k, v, attn_mask=keep)
            ao = ao.transpose(1, 2).reshape(rows, d)
            return torch.addmm(bo, ao, wo).view_as(x) + x

        return (lambda: ab.attn_block_fwd(x, *p, heads, eps=1e-6,
                                          n_valid=n_valid,
                                          safe_softmax=safe)), lib

    def k24_run(t, d, m, act):
        x, p = mlp_inputs(t, d, m)
        gy = randn(t, d).to(torch.bfloat16)
        ls, lb, w1, b1, w2, _ = p
        leaves = [x.detach().requires_grad_(True)] + [
            q.to(torch.bfloat16).detach().requires_grad_(True)
            for q in p]
        with torch.enable_grad():
            xl, lsl, lbl, w1l, b1l, w2l, b2l = leaves
            h = F.layer_norm(xl, (d,), lsl, lbl, 1e-6)
            h = F.gelu(torch.addmm(b1l, h, w1l), approximate="tanh")
            out = torch.addmm(b2l, h, w2l) + xl
        return ((lambda: fm.fused_mlp_bwd(x, ls, lb, w1, b1, w2, gy,
                                          eps=1e-6, act=act)),
                (lambda: torch.autograd.grad(out, leaves, gy,
                                             retain_graph=True)))

    def k23_run(b, n_pad, n_valid, d, heads):
        x = randn(b, n_pad, d).to(torch.bfloat16)
        gy = randn(b, n_pad, d).to(torch.bfloat16)
        p = (randn(d, std=0.1, mean=1.0), randn(d, std=0.1),
             randn(d, 3 * d, std=0.06).to(torch.bfloat16),
             randn(3 * d, std=0.02),
             randn(d, d, std=0.02).to(torch.bfloat16), randn(d, std=0.02))
        rows, keep = b * n_pad, (torch.arange(n_pad, device="cuda")
                                 < n_valid)[None, None, None]
        leaves = [x.detach().requires_grad_(True)] + [
            q.to(torch.bfloat16).detach().requires_grad_(True) for q in p]
        with torch.enable_grad():
            # LN + addmm + SDPA with the key mask + addmm + residual, bf16
            xl, ls, lb, wqkv, bqkv, wo, bo = leaves
            h = F.layer_norm(xl, (d,), ls, lb, 1e-6).reshape(rows, d)
            qkv = torch.addmm(bqkv, h, wqkv).view(b, n_pad, 3, heads, 64)
            q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
            ao = F.scaled_dot_product_attention(q, k, v, attn_mask=keep)
            ao = ao.transpose(1, 2).reshape(rows, d)
            out = torch.addmm(bo, ao, wo).view_as(xl) + xl
        return ((lambda: ab.attn_block_bwd(x, *p[:5], gy, heads, eps=1e-6,
                                           n_valid=n_valid)),
                (lambda: torch.autograd.grad(out, leaves, gy,
                                             retain_graph=True)))

    if args.kernel == "k1":
        shape = args.shape
        runs = {f"K1 {tuple(shape)}": k1_run(*shape)}
    elif args.kernel == "k23":
        shape = [[64, 200, 197, 768, 12], [8, 584, 577, 768, 12]]
        runs = {}
        for b, n_pad, n_valid, d, heads in shape:
            kern, lib = k23_run(b, n_pad, n_valid, d, heads)
            label = f"K23 ({b}, {n_pad}, {d}) n_valid {n_valid}"
            try:
                kern()
            except ValueError as e:
                print(f"{label}: not taken by this tree ({e})")
            else:
                runs[label] = kern
                if b == 64:
                    steps[label] = kern
            runs[f"library autograd ({b}, {n_pad}, {d}) n_valid "
                 f"{n_valid}"] = lib
        runs[f"K1 control {tuple(args.shape)}"] = k1_run(*args.shape)
        runs[f"K2 control {tuple(args.mlp_shape)}"] = k2_run(*args.mlp_shape)
        x, p = mlp_inputs(*args.mlp_shape)
        runs[f"K5 control {tuple(args.mlp_shape)}"] = (
            lambda x=x, p=p: fm.fused_mlp_fwd(x, *p, eps=1e-6,
                                              act="gelu_tanh"))
        runs[f"K24 control {tuple(args.mlp_shape)}"] = k24_run(
            *args.mlp_shape, "gelu_tanh")[0]
    elif args.kernel == "k6":
        shape = [[1600, 1024, 4096, 2], [2112, 1280, 5120, 4]]
        runs = {}
        for t, d, m, nc in shape:
            x, p = mlp_inputs(t, d, m)
            label = f"K6 ({t}, {d}) x {m} in {nc} chunks"
            runs[label] = (lambda x=x, p=p, nc=nc: fm.fused_mlp_chunked_fwd(
                x, *p, eps=1e-6, act="gelu_tanh", n_chunks=nc))
            ls, lb, w1, b1, w2, b2 = p
            lib_p = (ls.to(torch.bfloat16), lb.to(torch.bfloat16), w1,
                     b1.to(torch.bfloat16), w2, b2.to(torch.bfloat16))

            def lib(x=x, d=d, nc=nc, mc=m // nc, p=lib_p):
                ls, lb, w1, b1, w2, b2 = p
                xn = F.layer_norm(x, (d,), ls, lb, 1e-6)
                acc = x
                for c in range(nc):
                    cols = slice(c * mc, (c + 1) * mc)
                    h = F.gelu(torch.addmm(b1[cols], xn, w1[:, cols]),
                               approximate="tanh")
                    y = h @ w2[cols]
                    acc = acc + (y + b2 if c == nc - 1 else y)
                return acc

            runs[f"library ({t}, {d}) x {m} in {nc} chunks"] = lib
            device[f"{label} device alone"] = runs[label]
            device[f"library ({t}, {d}) x {m} in {nc} chunks device "
                   f"alone"] = lib
            steps[label] = runs[label]
        runs[f"K1 control {tuple(args.shape)}"] = k1_run(*args.shape)
        runs[f"K2 control {tuple(args.mlp_shape)}"] = k2_run(*args.mlp_shape)
        x, p = mlp_inputs(*args.mlp_shape)
        runs[f"K5 control {tuple(args.mlp_shape)}"] = (
            lambda x=x, p=p: fm.fused_mlp_fwd(x, *p, eps=1e-6,
                                              act="gelu_tanh"))
        x, p = mlp_inputs(16896, 1024, 4096)
        st = row_stats(x, 1e-6)
        runs["K3 control (16896, 1024) x 4096"] = (
            lambda x=x, st=st, p=p: fm.fused_mlp_chunked_stats(
                x, st, *p, eps=1e-6, act="gelu_tanh", n_chunks=2,
                emit_stats=True))
    elif args.kernel == "k3":
        shape = [[16896, 1024, 4096], [12800, 1024, 4096],
                 [528, 1024, 4096], [9344, 1024, 4096]]
        runs = {}
        for i, (t, d, m) in enumerate(shape):
            x, p = mlp_inputs(t, d, m)
            st = row_stats(x, 1e-6)
            label = f"K3 ({t}, {d}) x {m}"
            runs[label] = (lambda x=x, st=st, p=p: fm.fused_mlp_chunked_stats(
                x, st, *p, eps=1e-6, act="gelu_tanh", n_chunks=2,
                emit_stats=True))
            if i:
                continue
            ls, lb, w1, b1, w2, b2 = p
            lib_p = (ls.to(torch.bfloat16), lb.to(torch.bfloat16), w1,
                     b1.to(torch.bfloat16), w2, b2.to(torch.bfloat16))

            def lib(x=x, d=d, mc=m // 2, p=lib_p):
                ls, lb, w1, b1, w2, b2 = p
                xn = F.layer_norm(x, (d,), ls, lb, 1e-6)
                acc = x
                for c in range(2):
                    cols = slice(c * mc, (c + 1) * mc)
                    h = F.gelu(torch.addmm(b1[cols], xn, w1[:, cols]),
                               approximate="tanh")
                    y = h @ w2[cols]
                    acc = acc + (y + b2 if c else y)
                return acc

            runs[f"library ({t}, {d}) x {m}"] = lib
            device[f"{label} device alone"] = runs[label]
            device[f"library ({t}, {d}) x {m} device alone"] = lib
        runs[f"K1 control {tuple(args.shape)}"] = k1_run(*args.shape)
        runs[f"K2 control {tuple(args.mlp_shape)}"] = k2_run(*args.mlp_shape)
        x, p = mlp_inputs(*args.mlp_shape)
        runs[f"K5 control {tuple(args.mlp_shape)}"] = (
            lambda x=x, p=p: fm.fused_mlp_fwd(x, *p, eps=1e-6,
                                              act="gelu_tanh"))
    elif args.kernel == "k26":
        from vit_fpga_tpu_torch.ops import streamed_gemm as sg
        shape = [584, 1024, 4096]
        xs = randn(584, 1024).to(torch.bfloat16)
        ws = randn(1024, 4096).to(torch.bfloat16)
        runs = {"K26 bf16 (584, 1024) x (1024, 4096) per call":
                lambda: sg.streamed_gemm(xs, ws),
                "torch.matmul bf16 (584, 1024) x (1024, 4096) per call":
                lambda: torch.matmul(xs, ws)}
        device = {label.replace("per call", "device alone"): fn
                  for label, fn in runs.items()}
        # where the time goes: device alone against K (the K steps' share
        # is the slope, the fill, the epilogue and the launch the rest)
        for k in (64, 256, 2048):
            xk = randn(584, k).to(torch.bfloat16)
            wk = randn(k, 4096).to(torch.bfloat16)
            device[f"K26 bf16 (584, {k}) x ({k}, 4096) device alone"] = (
                lambda xk=xk, wk=wk: sg.streamed_gemm(xk, wk))
            device[f"torch.matmul bf16 (584, {k}) x ({k}, 4096) device "
                   f"alone"] = lambda xk=xk, wk=wk: torch.matmul(xk, wk)
    elif args.kernel == "k4":
        shape = [[64, 200, 197, 768, 12], [1, 264, 257, 1024, 16],
                 [1, 584, 577, 1024, 16]]
        runs = {}
        for b, n_pad, n_valid, d, heads in shape:
            for safe in (True, False):
                kern, lib = k4_run(b, n_pad, n_valid, d, heads, safe)
                label = f"K4 ({b}, {n_pad}, {d}) n_valid {n_valid} safe={safe}"
                runs[label] = kern
                if b == 64:
                    steps[label] = kern
            runs[f"library ({b}, {n_pad}, {d}) n_valid {n_valid}"] = lib
        runs[f"K1 control {tuple(args.shape)}"] = k1_run(*args.shape)
        runs[f"K2 control {tuple(args.mlp_shape)}"] = k2_run(*args.mlp_shape)
        x, p = mlp_inputs(*args.mlp_shape)
        runs[f"K5 control {tuple(args.mlp_shape)}"] = (
            lambda x=x, p=p: fm.fused_mlp_fwd(x, *p, eps=1e-6,
                                              act="gelu_tanh"))
        x, p = mlp_inputs(16896, 1024, 4096)
        st = row_stats(x, 1e-6)
        runs["K3 control (16896, 1024) x 4096"] = (
            lambda x=x, st=st, p=p: fm.fused_mlp_chunked_stats(
                x, st, *p, eps=1e-6, act="gelu_tanh", n_chunks=2,
                emit_stats=True))
        from vit_fpga_tpu_torch.ops import attention as at
        q7 = randn(1, 4104, 2304).to(torch.bfloat16)
        runs["K7 bf16 control (1, 4104, 2304) n_valid 4097"] = (
            lambda: at.mha_qkv_pallas(q7, 12, 4097))
    elif args.kernel == "k24":
        shape = [12800, 768, 3072]
        runs = {}
        for act in ("gelu_tanh", "quick_gelu", "relu"):
            kern, lib = k24_run(*shape, act)
            runs[f"K24 {tuple(shape)} {act}"] = kern
            if act == "gelu_tanh":
                runs[f"library autograd {tuple(shape)} gelu_tanh"] = lib
                steps[f"K24 {tuple(shape)} {act}"] = kern
        runs[f"K1 control {tuple(args.shape)}"] = k1_run(*args.shape)
        runs[f"K2 control {tuple(args.mlp_shape)}"] = k2_run(*args.mlp_shape)
        x, p = mlp_inputs(*args.mlp_shape)
        runs[f"K5 control {tuple(args.mlp_shape)}"] = (
            lambda x=x, p=p: fm.fused_mlp_fwd(x, *p, eps=1e-6,
                                              act="gelu_tanh"))
    elif args.kernel == "k13":
        from vit_fpga_tpu_torch.ops import quant
        from vit_fpga_tpu_torch.ops.common import round_up
        from vit_fpga_tpu_torch.ops.quant_fused import kmajor
        shape = [[10000, 784, 256], [10000, 256, 10], [12800, 768, 3072],
                 [12608, 768, 2304], [12608, 3072, 768]]
        runs = {}

        def int8(*s):
            return torch.randint(-127, 128, s, generator=g,
                                 dtype=torch.int8).cuda()

        for m, k, n in shape:
            a, b = int8(m, k), kmajor(int8(k, n))
            kp, np_ = round_up(k, 8), round_up(n, 8)
            ap = torch.zeros((max(m, 17), kp), dtype=torch.int8,
                             device="cuda")
            ap[:m, :k] = a
            bp = torch.zeros((kp, np_), dtype=torch.int8, device="cuda")
            bp[:k, :n] = b
            bp = kmajor(bp)
            label = f"({m}, {k}) x {n}"
            kern = (lambda a=a, b=b: quant.int8_gemm(a, b))
            lib = (lambda ap=ap, bp=bp: torch._int_mm(ap, bp))
            runs[f"K13 {label} per call"] = kern
            runs[f"torch._int_mm {label} padded per call"] = lib
            device[f"K13 {label} device alone"] = kern
            device[f"torch._int_mm {label} padded device alone"] = lib
    elif args.kernel == "k9":
        from vit_fpga_tpu_torch.ops import attention as at
        from vit_fpga_tpu_torch.ops import flash_attention as fa
        shape = [[1, 4104, 2304], [4, 4104, 2304], [1, 12, 4104, 64]]
        runs = {}
        keep = (torch.arange(4104, device="cuda") < 4097)[None, None, None]
        for b in (1, 4):
            qkv = randn(b, 4104, 2304, std=2.0).to(torch.bfloat16)
            q, k, v = (t.contiguous() for t in at._heads(qkv, 12))

            def kern(qkv=qkv):  # as the per-block path runs K9
                o = fa.flash_attention(*at._heads(qkv, 12), 4097, bq=512,
                                       bk=128)
                return o.transpose(1, 2).reshape(qkv.shape[0], 4104, 768)

            lib = (lambda q=q, k=k, v=v: F.scaled_dot_product_attention(
                q, k, v, attn_mask=keep))
            label = f"({b}, 4104, 2304) n_valid 4097"
            runs[f"K9 {label} bk 128 per call"] = kern
            runs[f"SDPA {label} key mask per call"] = lib
            device[f"K9 {label} bk 128 device alone"] = kern
            device[f"SDPA {label} key mask device alone"] = lib
            if b == 1:
                runs[f"K7 bf16 control {label}"] = (
                    lambda qkv=qkv: at.mha_qkv_pallas(qkv, 12, 4097))
        q, k, v = (randn(1, 12, 4104, 64, std=2.0).to(torch.bfloat16)
                   for _ in range(3))
        kern = (lambda: fa.flash_attention(q, k, v, 4097))
        runs["K9 (1, 12, 4104, 64) n_valid 4097 bk 512 per call"] = kern
        device["K9 (1, 12, 4104, 64) n_valid 4097 bk 512 device alone"] = kern
        runs["K4 control (64, 200, 768) n_valid 197"] = k4_run(
            64, 200, 197, 768, 12, False)[0]
    elif args.kernel in ("k19a", "k20"):
        sys.path.insert(0, str(root))
        import chip_smoke as cs
        from vit_fpga_tpu_torch.ops import vit_stack as vs
        shape = [[1, 200, 197, 768, 12], [4, 200, 197, 768, 12]]
        runs = {}
        eps = cs.EPS
        if args.kernel == "k19a":
            _, q12, s12 = cs._stack_trees(12, seed=110)
        else:
            bf12, i812 = cs._full_args(12, seed=140)
        for b in (1, 4):
            label = f"b{b} depth 12"
            if args.kernel == "k19a":
                x = cs._stack_x(b, seed=111)
                kern = (lambda x=x: vs.vit_layers_int8(x, q12, 12, eps=eps,
                                                       n_valid=197))
                lib = cs._stack_library(x, q12, 12, 197, True)
                runs[f"K19b control {label}"] = (
                    lambda x=x: vs.vit_layers_int8_static(
                        x, s12, 12, eps=eps, n_valid=197))
                name = "K19a"
            else:
                img = cs._full_images(b, seed=141)
                kern = (lambda img=img: vs.vit_full_int8(img, *i812, 12, 16,
                                                         eps=eps))
                lib = cs._full_library(img, i812, 12, True)
                runs[f"K12 control {label}"] = (
                    lambda img=img: vs.vit_full(img, *bf12, 12, 16,
                                                eps=eps))
                name = "K20"
            runs[f"{name} {label} per call"] = kern
            runs[f"library {label} per call"] = lib
            device[f"{name} {label} device alone"] = kern
            device[f"library {label} device alone"] = lib
    elif args.kernel in ("k19b", "k12", "k11"):
        sys.path.insert(0, str(root))
        import chip_smoke as cs
        from vit_fpga_tpu_torch.ops import vit_stack as vs
        shape = [[1, 200, 197, 768, 12], [4, 200, 197, 768, 12]]
        runs = {}
        eps = cs.EPS
        bf12, q12, s12 = cs._stack_trees(12, seed=110)
        a12, i812 = cs._full_args(12, seed=140)
        for b in (1, 4):
            label = f"b{b} depth 12"
            x = cs._stack_x(b, seed=111)
            img = cs._full_images(b, seed=141)
            calls = {
                "K19b": lambda x=x: vs.vit_layers_int8_static(
                    x, s12, 12, eps=eps, n_valid=197),
                "K12": lambda img=img: vs.vit_full(img, *a12, 12, 16,
                                                   eps=eps),
                "K11": lambda x=x: vs.vit_layers(x, bf12, 12, eps=eps,
                                                 n_valid=197),
                "K19a": lambda x=x: vs.vit_layers_int8(x, q12, 12, eps=eps,
                                                       n_valid=197),
                "K20": lambda img=img: vs.vit_full_int8(img, *i812, 12, 16,
                                                        eps=eps)}
            if args.kernel == "k19b":
                name = "K19b"
                lib = cs._stack_library(x, s12, 12, 197, True, static=True)
            elif args.kernel == "k12":
                name = "K12"
                lib = cs._full_library(img, a12, 12, False)
            else:
                name = "K11"
                lib = cs._stack_library(x, bf12, 12, 197, False)
            runs[f"{name} {label} per call"] = calls[name]
            runs[f"library {label} per call"] = lib
            device[f"{name} {label} device alone"] = calls[name]
            device[f"library {label} device alone"] = lib
            controls = ("K12", "K19b") if name == "K11" else (
                "K11", "K19a", "K20")
            for other in controls:
                runs[f"{other} control {label}"] = calls[other]
    elif args.kernel == "k15":
        sys.path.insert(0, str(root))
        import chip_smoke as cs
        from vit_fpga_tpu_torch.ops import quant_block as qb
        from vit_fpga_tpu_torch.ops import quant_fused as qf
        shape = list(args.mlp_shape)
        t, d, m = shape
        runs = {}
        x2, _, p = cs._mlp_inputs(t, d, m, 91)
        q = cs._int8_weights(p, ("w1", "w2"))
        rq = qf._row_quant

        def mm(aq, wq, sa, ws, b):  # (K, N) wq column-major, as _int_mm takes
            return torch._int_mm(aq, wq).float() * (sa * ws) + b

        def lib():
            h = F.layer_norm(x2.float(), (d,), q["ln_scale"], q["ln_bias"],
                             cs.EPS)
            xq, sx = rq(h)
            h = F.gelu(mm(xq, q["w1_q"], sx, q["w1_s"], q["b1"]),
                       approximate="tanh")
            hq, sh = rq(h)
            return x2 + mm(hq, q["w2_q"], sh, q["w2_s"],
                           q["b2"]).to(torch.bfloat16)

        def run():
            return cs._k15(qb.mlp_block_int8, x2, q, "gelu_tanh")

        name = f"K15 ({t}, {d}) x {m}"
        if args.k15 != "noact":
            cs._int8_parity(name, run(),
                            cs._k15(qb.mlp_block_int8_plain, x2, q,
                                    "gelu_tanh"),
                            cs._k15_step(x2, q, "gelu_tanh"), x2)
        runs[f"{name} per call"] = run
        device[f"{name} device alone"] = run
        steps[name] = run
        runs["library per call"] = lib
        device["library device alone"] = lib
        xa, _, pa = cs._attn_inputs(64, 200, 768, 90)
        qa = cs._int8_weights(pa, ("wqkv", "wo"))
        runs["K16 control (64, 200, 768)"] = (
            lambda: cs._k16(qb.attn_block_int8, xa, qa, 12, 197))
    elif args.kernel in ("k18", "k21b"):
        sys.path.insert(0, str(root))
        import chip_smoke as cs
        from vit_fpga_tpu_torch.ops import quant_block as qb
        from vit_fpga_tpu_torch.ops import quant_fused as qf
        rq = qf._row_quant

        def mm(aq, wq, sa, ws, b):  # (K, N) wq column-major, as _int_mm takes
            return torch._int_mm(aq, wq).float() * (sa * ws) + b

        def k21b_lib(xa, sta, qa, n_valid, heads=12):
            b, n_pad, d = xa.shape
            rows = b * n_pad
            keep = (torch.arange(n_pad, device="cuda")
                    < n_valid)[None, None, None]

            def lib():
                h = ((xa.float() - sta[..., :1]) * sta[..., 1:]
                     * qa["ln_scale"] + qa["ln_bias"])
                xq, sx = rq(h.reshape(rows, d))
                qkv = mm(xq, qa["wqkv_q"], sx, qa["wqkv_s"],
                         qa["bqkv"]).to(torch.bfloat16)
                qkv = qkv.view(b, n_pad, 3, heads, d // heads)
                q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
                ao = F.scaled_dot_product_attention(q, k, v, attn_mask=keep)
                aq, sa = rq(ao.transpose(1, 2).reshape(rows, d).float())
                out = xa.reshape(rows, d) + mm(
                    aq, qa["wo_q"], sa, qa["wo_s"],
                    qa["bo"]).to(torch.bfloat16)
                return out, row_stats(out, cs.EPS)
            return lib

        runs = {}
        shape = []
        name = "K18" if args.kernel == "k18" else "K21b"
        # chip_smoke.py's timing inputs (K18 seed 140 at b64, K21b 170; 274
        # past 256 keys)
        for b, n_pad, n_valid, seed in (
                (64, 200, 197, 140 if args.kernel == "k18" else 170),
                (16, 584, 577, 274)):
            xa, sta, pa = cs._attn_inputs(b, n_pad, 768, seed)
            qa = cs._int8_weights(pa, ("wqkv", "wo"))
            label = f"{name} ({b}, {n_pad}, 768) n_valid {n_valid}"
            shape.append([b, n_pad, n_valid, 768, 12])
            valid = (slice(None), slice(0, n_valid))
            if args.kernel == "k18":
                a, _, _ = cs._static_attn_args(xa, qa, 12, n_valid)

                def run(xa=xa, a=a, n_valid=n_valid):
                    return cs._k18(qb.attn_block_int8_static, xa, a, 12,
                                   n_valid)

                def check(got, xa=xa, a=a, n_valid=n_valid, b=b,
                          n_pad=n_pad, label=label, valid=valid):
                    # the int8 band, one row in FLIP_ROWS allowed one
                    # rounding event of its own (a flipped xq moves the
                    # row's attention, so its whole aoq row), as for K16
                    step = (127.0 * a["wo_s"]).expand(b, n_pad, 768)
                    cs._int8_parity(
                        label, got, cs._k18(qb.attn_block_int8_static_plain,
                                            xa, a, 12, n_valid), step, xa,
                        rows=valid, mag_x=True,
                        row_bound=cs._requant_bound(step, a["wo_q"]))
                lib = cs._static_library(xa, a, "attn", 12, n_valid)
            else:
                def run(xa=xa, sta=sta, qa=qa, n_valid=n_valid):
                    return cs._k21b(qb.attn_block_int8_stats, xa, sta, qa, 12,
                                    n_valid, True)

                def check(got, xa=xa, sta=sta, qa=qa, n_valid=n_valid,
                          label=label, valid=valid):
                    step = cs._k21b_step(xa, sta, qa, 12, n_valid)
                    cs._int8_parity(
                        label, got[0],
                        cs._k21b(qb.attn_block_int8_stats_plain, xa, sta, qa,
                                 12, n_valid, True)[0], step, xa,
                        rows=valid, mag_x=True,
                        row_bound=cs._requant_bound(step, qa["wo_q"]))
                lib = k21b_lib(xa, sta, qa, n_valid)
            try:
                got = run()
            except ValueError as e:
                print(f"{label}: not taken by this tree ({e})")
                got = None
            if got is not None:
                check(got)
                runs[f"{label} per call"] = run
                device[f"{label} device alone"] = run
                if b == 64:
                    steps[label] = run
            runs[f"library ({b}, {n_pad}) per call"] = lib
            device[f"library ({b}, {n_pad}) device alone"] = lib
        xc, _, pc = cs._attn_inputs(64, 200, 768, 90)
        qc = cs._int8_weights(pc, ("wqkv", "wo"))
        runs["K16 control (64, 200, 768)"] = (
            lambda: cs._k16(qb.attn_block_int8, xc, qc, 12, 197))
        xm, _, pm = cs._mlp_inputs(12800, 768, 3072, 93)
        qm = cs._int8_weights(pm, ("w1", "w2"))
        runs["K15 control (12800, 768) x 3072"] = (
            lambda: cs._k15(qb.mlp_block_int8, xm, qm, "gelu_tanh"))
    elif args.kernel in ("k17", "k22"):
        sys.path.insert(0, str(root))
        import chip_smoke as cs
        from vit_fpga_tpu_torch.ops import quant_block as qb

        def k22_lib(xa, a, n_valid, heads=12):
            b, n_pad, d = xa.shape
            rows, dh, bf = b * n_pad, d // heads, torch.bfloat16
            keep = (torch.arange(n_pad, device="cuda")
                    < n_valid)[None, None, None]
            sdq = qb._scores_dequant(a["sc_qk"], dh)

            def lib():
                h = F.layer_norm(xa.float(), (d,), a["ln_scale"],
                                 a["ln_bias"], cs.EPS).reshape(rows, d)
                panel = qb._rint_i8(torch._int_mm(qb._rint_i8(h),
                                                  a["wqkv_q"]).float()
                                    * a["wqkv_qs"] + a["bqkv_qs"])
                qkv = panel.to(bf).view(b, n_pad, 3, heads, dh)
                q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
                ao = F.scaled_dot_product_attention(q, k, v, attn_mask=keep,
                                                    scale=sdq)
                ao = (ao.transpose(1, 2).reshape(rows, d).float()
                      * (a["pv_fold"] * 127.0))
                y = (torch._int_mm(qb._rint_i8(ao), a["wo_q"]).float()
                     * a["wo_s"] + a["bo"])
                return xa.reshape(rows, d) + y.to(bf)
            return lib

        runs = {}
        shape = []
        if args.kernel == "k17":
            # chip_smoke.py's timing inputs (phase_static_timing, seed 141)
            x2, _, pm = cs._mlp_inputs(12800, 768, 3072, 141)
            am, _, _ = cs._static_mlp_args(
                x2, cs._int8_weights(pm, ("w1", "w2")), "gelu_tanh")
            shape.append([12800, 768, 3072])
            label = "K17 (12800, 768) x 3072"

            def run():
                return cs._k17(qb.mlp_block_int8_static, x2, am, "gelu_tanh")
            cs._int8_parity(label, run(), cs._k17(
                qb.mlp_block_int8_static_plain, x2, am, "gelu_tanh"),
                (127.0 * am["w2_s"]).expand(12800, 768), x2, mag_x=True)
            runs[f"{label} per call"] = run
            device[f"{label} device alone"] = run
            steps[label] = run
            lib = cs._static_library(x2, am, "mlp")
            runs["library per call"] = lib
            device["library device alone"] = lib
        else:
            # chip_smoke.py's timing inputs (phase_chain_timing seed 170;
            # 286 past 256 keys)
            for b, n_pad, n_valid, seed in ((64, 200, 197, 170),
                                            (16, 584, 577, 286)):
                xa, _, pa = cs._attn_inputs(b, n_pad, 768, seed)
                a, _ = cs._scores_args(
                    xa, cs._int8_weights(pa, ("wqkv", "wo")), 12, n_valid)
                label = f"K22 ({b}, {n_pad}, 768) n_valid {n_valid}"
                shape.append([b, n_pad, n_valid, 768, 12])

                def run(xa=xa, a=a, n_valid=n_valid):
                    return cs._k22(qb.attn_block_int8_static_scores, xa, a,
                                   12, n_valid)
                try:
                    got = run()
                except ValueError as e:
                    print(f"{label}: not taken by this tree ({e})")
                    got = None
                if got is not None:
                    cs._k22_parity(label, xa, a, 12, n_valid,
                                   (slice(None), slice(0, n_valid)), got=got)
                    runs[f"{label} per call"] = run
                    device[f"{label} device alone"] = run
                    steps[label] = run
                lib = k22_lib(xa, a, n_valid)
                runs[f"library ({b}, {n_pad}) per call"] = lib
                device[f"library ({b}, {n_pad}) device alone"] = lib
        xc, _, pc = cs._attn_inputs(64, 200, 768, 140)
        ac, _, _ = cs._static_attn_args(
            xc, cs._int8_weights(pc, ("wqkv", "wo")), 12, 197)
        runs["K18 control (64, 200, 768)"] = (
            lambda: cs._k18(qb.attn_block_int8_static, xc, ac, 12, 197))
        xm, _, pm = cs._mlp_inputs(12800, 768, 3072, 93)
        qm = cs._int8_weights(pm, ("w1", "w2"))
        runs["K15 control (12800, 768) x 3072"] = (
            lambda: cs._k15(qb.mlp_block_int8, xm, qm, "gelu_tanh"))
    elif args.kernel == "k14":
        sys.path.insert(0, str(root))
        import chip_smoke as cs
        from vit_fpga_tpu_torch.ops import quant_fused as qf
        runs, shape = {}, []
        for i, (label, t, k, n, kw) in enumerate((
                ("head", 64, 768, 1000, {}),
                ("QKV + LN", 8208, 768, 2304, dict(ln_eps=1e-6)),
                ("out-projection", 8208, 768, 768, {}),
                ("W1 + gelu_tanh", 8208, 768, 3072, dict(act="gelu_tanh")),
                ("W2", 8208, 3072, 768, {}))):
            x, q = cs._k14_inputs(t, k, n, 400 + i)
            if "ln_eps" in kw:
                kw = dict(kw, ln_scale=q["ls"], ln_bias=q["lb"])
            name = f"K14 {label} ({t}, {k}) x {n}"
            shape.append([t, k, n])

            def run(x=x, q=q, kw=kw):
                return cs._k14(qf.int8_linear_fused, x, q, **kw)
            cs._int8_parity(name, run(), cs._k14(qf.int8_linear_fused_plain,
                                                 x, q, **kw),
                            cs._k14_step(x, q, **kw))
            runs[f"{name} per call"] = run
            device[f"{name} device alone"] = run
            steps[name] = run
            if label in ("head", "W1 + gelu_tanh"):
                def lib(x=x, q=q, act=kw.get("act")):
                    xq, sx = qf._row_quant(x.float())
                    f = (torch._int_mm(xq, q["w_q"]).float() * (sx * q["w_s"])
                         + q["b"])
                    if act == "gelu_tanh":
                        f = F.gelu(f, approximate="tanh")
                    return f.to(torch.bfloat16)
                runs[f"library {label} per call"] = lib
                device[f"library {label} device alone"] = lib
    elif args.kernel == "k10":
        sys.path.insert(0, str(root))
        import chip_smoke as cs
        from vit_fpga_tpu_torch.models import vit
        from vit_fpga_tpu_torch.ops import patch_embed as pe
        torch.backends.cuda.matmul.allow_tf32 = False
        runs, shape = {}, []
        for i, (label, p, d, scales) in enumerate((
                ("ViT-B/16 b64", 16, 768, cs.IMAGENET_SCALES),
                ("CLIP ViT-L/14 b64", 14, 1024, "clip"))):
            images, kf, bf = cs._k10_inputs(64, 224, 224, p, d, 410 + i,
                                            scales)
            shape.append([64, 224, 224, p, d])
            for dt in (torch.bfloat16, torch.float32):
                name = f"K10 {label} {str(dt)[6:]}"

                def run(images=images, kf=kf, bf=bf, p=p, dt=dt):
                    return pe.patch_embed_pallas(images, kf, bf, p,
                                                 out_dtype=dt)
                got = run()
                want = pe.patch_embed_plain(images, kf, bf, p, out_dtype=dt)
                cs._sum_band(name, got, want, p * p * 3,
                             cs._k10_mag(images, kf, bf, p).reshape(
                                 got.shape), dt == torch.bfloat16)
                runs[f"{name} per call"] = run
                device[f"{name} device alone"] = run
                steps[name] = run

                def lib(images=images, kf=kf, bf=bf, p=p, dt=dt):
                    return (vit.patchify(images.float(), p) @ kf + bf).to(dt)
                runs[f"library {label} {str(dt)[6:]} per call"] = lib
                device[f"library {label} {str(dt)[6:]} device alone"] = lib
    elif args.kernel in ("k16", "k21a"):
        sys.path.insert(0, str(root))
        import chip_smoke as cs
        from vit_fpga_tpu_torch.ops import quant_block as qb
        from vit_fpga_tpu_torch.ops import quant_fused as qf
        rq = qf._row_quant

        def mm(aq, wq, sa, ws, b):  # (K, N) wq column-major, as _int_mm takes
            return torch._int_mm(aq, wq).float() * (sa * ws) + b

        def k16_lib(xa, qa, n_valid, heads=12):
            b, n_pad, d = xa.shape
            rows = b * n_pad
            keep = (torch.arange(n_pad, device="cuda")
                    < n_valid)[None, None, None]

            def lib():
                h = F.layer_norm(xa.float(), (d,), qa["ln_scale"],
                                 qa["ln_bias"], cs.EPS)
                xq, sx = rq(h.reshape(rows, d))
                qkv = mm(xq, qa["wqkv_q"], sx, qa["wqkv_s"],
                         qa["bqkv"]).to(torch.bfloat16)
                qkv = qkv.view(b, n_pad, 3, heads, d // heads)
                q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
                ao = F.scaled_dot_product_attention(q, k, v, attn_mask=keep)
                aq, sa = rq(ao.transpose(1, 2).reshape(rows, d).float())
                y = mm(aq, qa["wo_q"], sa, qa["wo_s"], qa["bo"])
                return xa.reshape(rows, d) + y.to(torch.bfloat16)
            return lib

        runs = {}
        shape = []
        if args.kernel == "k16":
            # chip_smoke.py's timing inputs (seed 90 at b64, 263 past 256
            # keys)
            for b, n_pad, n_valid, seed in ((64, 200, 197, 90),
                                            (16, 584, 577, 263)):
                xa, _, pa = cs._attn_inputs(b, n_pad, 768, seed)
                qa = cs._int8_weights(pa, ("wqkv", "wo"))
                label = f"K16 ({b}, {n_pad}, 768) n_valid {n_valid}"
                shape.append([b, n_pad, n_valid, 768, 12])

                def run(xa=xa, qa=qa, n_valid=n_valid):
                    return cs._k16(qb.attn_block_int8, xa, qa, 12, n_valid)
                try:
                    got = run()
                except ValueError as e:
                    print(f"{label}: not taken by this tree ({e})")
                    got = None
                if got is not None and args.k16 != "qkv_noepi":
                    # the int8 band, one row in FLIP_ROWS requantized (ao's
                    # absmax an ulp apart) as in the int8 chain's checks
                    step = cs._k16_step(xa, qa, 12, n_valid)
                    cs._int8_parity(label, got,
                                    cs._k16(qb.attn_block_int8_plain, xa, qa,
                                            12, n_valid), step, xa,
                                    row_bound=cs._requant_bound(step,
                                                                qa["wo_q"]))
                if got is not None:
                    runs[f"{label} per call"] = run
                    device[f"{label} device alone"] = run
                    if b == 64:
                        steps[label] = run
                lib = k16_lib(xa, qa, n_valid)
                runs[f"library ({b}, {n_pad}) per call"] = lib
                device[f"library ({b}, {n_pad}) device alone"] = lib
        else:
            t, d, m = args.mlp_shape
            shape = [t, d, m]
            x2, st2, p = cs._mlp_inputs(t, d, m, 91)
            q = cs._int8_weights(p, ("w1", "w2"))
            fs = cs._foreign(st2)

            def run():
                return cs._k21a(qb.mlp_block_int8_stats, x2, fs, q,
                                "gelu_tanh", True)

            def lib():
                h = ((x2.float() - fs[:, :1]) * fs[:, 1:] * q["ln_scale"]
                     + q["ln_bias"])
                xq, sx = rq(h)
                h = F.gelu(mm(xq, q["w1_q"], sx, q["w1_s"], q["b1"]),
                           approximate="tanh")
                hq, sh = rq(h)
                out = x2 + mm(hq, q["w2_q"], sh, q["w2_s"],
                              q["b2"]).to(torch.bfloat16)
                return out, row_stats(out, cs.EPS)

            label = f"K21a ({t}, {d}) x {m}"
            got, _ = run()
            want, _ = cs._k21a(qb.mlp_block_int8_stats_plain, x2, fs, q,
                               "gelu_tanh", True)
            step = cs._k21a_step(x2, fs, q, "gelu_tanh")
            cs._int8_parity(label, got, want, step, x2, mag_x=True,
                            row_bound=cs._requant_bound(step, q["w2_q"]))
            runs[f"{label} per call"] = run
            device[f"{label} device alone"] = run
            steps[label] = run
            runs["library per call"] = lib
            device["library device alone"] = lib
            xa, _, pa = cs._attn_inputs(64, 200, 768, 90)
            qa = cs._int8_weights(pa, ("wqkv", "wo"))
            runs["K16 control (64, 200, 768)"] = (
                lambda: cs._k16(qb.attn_block_int8, xa, qa, 12, 197))
        xm, _, pm = cs._mlp_inputs(12800, 768, 3072, 93)
        qm = cs._int8_weights(pm, ("w1", "w2"))
        runs["K15 control (12800, 768) x 3072"] = (
            lambda: cs._k15(qb.mlp_block_int8, xm, qm, "gelu_tanh"))
    elif args.kernel == "k2":
        shape = args.mlp_shape
        runs = {f"K2 {tuple(shape)}": k2_run(*shape)}
    else:
        shape = [[12800, 768, 3072], [4104, 768, 3072], [264, 1024, 4096]]
        runs = {}
        for t, d, m in shape:
            x, p = mlp_inputs(t, d, m)
            ls, lb, w1, b1, w2, b2 = p
            lib_p = (ls.to(torch.bfloat16), lb.to(torch.bfloat16), w1,
                     b1.to(torch.bfloat16), w2, b2.to(torch.bfloat16))

            def lib(x=x, d=d, p=lib_p):
                ls, lb, w1, b1, w2, b2 = p
                h = F.layer_norm(x, (d,), ls, lb, 1e-6)
                h = F.gelu(torch.addmm(b1, h, w1), approximate="tanh")
                return torch.addmm(b2, h, w2) + x

            runs[f"K5 ({t}, {d}) x {m}"] = (
                lambda x=x, p=p: fm.fused_mlp_fwd(x, *p, eps=1e-6,
                                                  act="gelu_tanh"))
            runs[f"library ({t}, {d}) x {m}"] = lib
        runs[f"K1 control {tuple(args.shape)}"] = k1_run(*args.shape)
        runs[f"K2 control {tuple(args.mlp_shape)}"] = k2_run(*args.mlp_shape)

    ms = {label: [time_cuda(fn, iters=20, warmup=5) for _ in range(5)]
          for label, fn in runs.items()}
    ms.update({label: [device_alone_ms(fn, 200 if args.kernel in ("k26",
                                                                  "k13")
                                       else 20) for _ in range(3)]
               for label, fn in device.items()})
    for label, fn in steps.items():  # each step alone, three estimates
        for i in range(3):
            for name, t in device_steps(fn).items():
                ms.setdefault(f"{label} step {name}", []).append(t)
    if args.kernel == "k5":
        ms.update(time_k5_paths(g))
    if args.kernel == "k3":
        ms.update(time_clip_forward(g))
    if args.kernel == "k4":
        ms.update(time_safe_forward(g))
    if args.kernel == "k13":
        ms.update(time_k13_paths(g))
    if args.kernel == "k9":
        ms.update(time_k9_paths(g))
    if args.kernel == "k14":
        ms.update(time_k14_paths(g))
    if args.kernel in ("k16", "k21a", "k18", "k21b", "k17", "k22"):
        ms.update(time_int8_forwards(g, args.kernel))
    if args.kernel in ("k24", "k23"):
        ms.update(time_sgd_step(g))
    if args.kernel == "k23":
        ms.update(time_sgd_step_384(g))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         stdout=subprocess.PIPE, text=True).stdout.strip()
    for label, ts in ms.items():
        print(f"{label} from {root}: " + " / ".join(f"{t:.4f}" for t in ts)
              + f" ms on {smi}")
    print(json.dumps({"root": str(root), "kernel": args.kernel,
                      "shape": shape, "ms": ms, "device": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
