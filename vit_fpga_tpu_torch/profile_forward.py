"""Where the time goes on the card: the served ViT forward (bf16, dynamic
or calibrated static int8, throughput or batch-1 latency), or one
training step.

    python -m vit_fpga_tpu_torch.profile_forward [--model vit_b16]
        [--image 224] [--batch 64] [--steps 3]
        [--train | --int8 [--static] | --per-tensor] [--latency | --full]

``--model`` takes the ViT variants, ``clip_<variant>`` (the CLIP vision
tower, projection 768: ``clip_vit_l14``, ``clip_vit_b16``) and
``deit_<variant>`` (``deit_b16``), with ``bench.py``'s prefix rules;
``--image`` is the square input size (224, 384, 1024: ViT-B/16 at 1024 px
runs the per-block path, flash attention K9 and K5, or with ``--int8``
the per-linear int8 route, K14 and K9; give ``--batch 1`` or ``4``).
CLIP and DeiT profile
the bf16 served forward only.  Without a mode flag it runs the family's
``make_forward(cfg, params, raw=True)`` (bf16,
random weights from seed 0) on a seeded uint8 batch already on the card;
with ``--int8`` ``make_forward_int8`` on ``quantize_vit_fast`` of the same
weights, with ``--int8 --static`` on ``quantize_vit_static`` of them
(calibrated on the synthetic probe batch, on the card); with ``--train``
one SGD(1e-4) step of ``make_vit_train_step`` (bench.py's train shape) on
a seeded normalized batch; with ``--per-tensor`` the per-tensor int8
forward (``make_vit_forward_int8`` on ``quantize_vit`` of f32 weights: K13
linears, K7 attention in f32).  ``--latency`` (batch 1 unless ``--batch`` says
otherwise, 4 at most) runs the single-launch forwards instead:
``make_forward_latency`` (K11), or with ``--int8``
``make_forward_int8_latency`` (K19a, or K19b with ``--static``, + the K14
head).  ``--full`` (batch 1 unless ``--batch`` says otherwise, 4 at most)
runs the whole model in one launch instead: ``make_forward_latency(...,
full=True)`` (``forward_latency_logits``, K12), or with ``--int8``
``make_forward_int8_latency(..., full=True)``
(``vit_forward_int8_latency_logits``, K20).  It prints:

  * the time per batch or step (CUDA events), images per second and, for
    a step, TFLOP/s counted as 3 x the forward (bench.py's count); in
    latency and full modes the p50 and max of five loop estimates of 32
    calls each, as bench.py reports its latency extras, and the torch
    launches per request (each call is one request of ``--batch`` images:
    every kernel and copy the profiler saw, over the runs);
  * device time per launch site over ``--steps`` profiled runs
    (torch.profiler), grouped into the stages of the kernels;
  * the device's idle share: 1 - (union of kernel intervals) / (first
    kernel start to last kernel end) over the profiled window;
  * peak device memory.

The last line is one JSON object with the same numbers.
"""

from __future__ import annotations

import argparse
import json
import sys
from collections import defaultdict

import numpy as np
import torch

UNEXPECTED = "unexpected:"

# launch-site name fragment (spaces and "(int)" casts removed) -> stage
# label.  csrc/*.cu name each site's kernels by translation unit:
# vit_stack:: K11, vit_stack_int8:: K19a, vit_stack_int8_static:: K19b,
# vit_full:: K12, vit_full_int8:: K20,
# attn_half:: K1, mlp_half:: K2, attn_block:: K4, mlp:: K5, attn_bwd:: K23,
# mlp_bwd:: K24, quant_linear:: K14, mlp_int8:: K15, attn_int8:: K16,
# mlp_int8_static:: K17, attn_int8_static:: K18, mlp_chunk:: K3 (K1 and K2
# run gemm_wgmma.cuh's gw_kernel and K1's attention mha_wgmma_kernel<1>
# (max-free) at every length, K4 row_stats_kernel, gw_kernel and
# mha_wgmma_kernel<2> (safe) or <1>, K5 ln_rows_kernel and gw_kernel, K3
# gw_kernel (its W2 step the chunked variant) and row_stats_kernel, K24
# ln_rows_kernel, gf_kernel (da, h and the activation backward on one
# tile), gw_kernel in its backward layouts (<..., LAYOUT, EPI>: 1, 1 B
# K-major to f32; 2, 1 A MN-major to f32 split-K partials),
# gw_split_sum_kernel, colsum and ln_bwd_kernel:
# any other attn_half::, mlp_half::, attn_block::, mlp::, mlp_chunk:: or
# mlp_bwd:: record, such as the wmma gemm_bf16_kernel or attn_kernel /
# attn_long_kernel they ran before, is reported as unexpected),
# mlp_chunk_blk:: K6, mha:: K7 / K8, flash_attn:: K9, int8_gemm:: K13.  The
# int8 GEMM's template
# argument is its epilogue (0 plain, 1 residual, 2 f32 with row maxima, 3
# int8 with the static scale), quant_rows_kernel's second one its
# LayerNorm (0 none, 1 one-pass, 2 two-pass).  The first fragment found
# wins.
STAGES = (
    ("vit_full_int8::", "K20 int8 whole model, one launch"),
    ("vit_full::", "K12 bf16 whole model, one launch"),
    ("vit_stack_int8_static::", "K19b static int8 encoder, one launch"),
    ("vit_stack_int8::", "K19a int8 encoder, one launch"),
    ("vit_stack::", "K11 bf16 encoder, one launch"),
    ("quant_linear::quant_rows_kernel", "K14 (a) [LN] + row quant"),
    ("quant_linear::qgemm_kernel", "K14 (b) int8 GEMM + dequant + act"),
    ("quant_linear::", "K14 other"),
    ("mlp_int8::quant_rows_kernel", "K15 (a) LN + row quant"),
    ("mlp_int8::qgemm_kernel<2>", "K15 (b) int8 W1 GEMM + act + row max"),
    ("mlp_int8::quant_amax_kernel", "K15 (c) h row quant"),
    ("mlp_int8::qgemm_kernel<1>", "K15 (d) int8 W2 GEMM + residual"),
    ("mlp_int8::", "K15 other"),
    ("attn_int8::quant_rows_kernel<__nv_bfloat16,1",
     "K16 (a) LN + row quant"),
    ("attn_int8::qgemm_kernel<0>", "K16 (b) int8 QKV GEMM"),
    ("attn_int8::attn_kernel", "K16 (c) attention"),
    ("attn_int8::quant_rows_kernel<__nv_bfloat16,0", "K16 (d) ao row quant"),
    ("attn_int8::qgemm_kernel<1>", "K16 (e) int8 out-proj + residual"),
    ("attn_int8::", "K16 other"),
    ("mlp_int8_static::quant_rows_kernel", "K17 (a) LN + rint rows"),
    ("mlp_int8_static::qgemm_kernel<3>",
     "K17 (b) int8 W1 GEMM + scaled act + rint"),
    ("mlp_int8_static::qgemm_kernel<1>", "K17 (c) int8 W2 GEMM + residual"),
    ("mlp_int8_static::", "K17 other"),
    ("attn_int8_static::quant_rows_kernel", "K18 (a) LN + rint rows"),
    ("attn_int8_static::qgemm_kernel<0>", "K18 (b) int8 QKV GEMM"),
    ("attn_int8_static::attn_kernel", "K18 (c) attention, int8 ao"),
    ("attn_int8_static::qgemm_kernel<1>",
     "K18 (d) int8 out-proj + residual"),
    ("attn_int8_static::", "K18 other"),
    ("attn_half::gw_kernel<true", "K1 (a) LN + QKV GEMM"),
    ("attn_half::mha_wgmma_kernel<1>", "K1 (b) attention, max-free"),
    ("attn_half::gw_kernel<false", "K1 (c) out-proj + residual"),
    ("attn_half::row_stats_kernel", "K1 (d) next stats"),
    ("mlp_half::gw_kernel<true", "K2 (a) LN + W1 GEMM + act"),
    ("mlp_half::gw_kernel<false", "K2 (b) W2 GEMM + residual"),
    ("mlp_half::row_stats_kernel", "K2 (c) next stats"),
    ("attn_half::", UNEXPECTED + " K1 kernel"),
    ("mlp_half::", UNEXPECTED + " K2 kernel"),
    ("mlp_chunk::gw_kernel<true", "K3 (a) LN + W1 GEMM + act"),
    ("mlp_chunk::gw_kernel<false,true", "K3 (b) chunked W2 GEMM + residual"),
    ("mlp_chunk::row_stats_kernel", "K3 (c) next stats"),
    ("mlp_chunk::", UNEXPECTED + " K3 kernel"),
    ("flash_attn::seq_attn_kernel", "K9 flash attention"),
    ("mha::seq_attn_f32_kernel", "K7 / K8 attention, f32"),
    ("mha::mha_wgmma_kernel", "K7 / K8 attention, bf16"),
    ("mlp_chunk_blk::ln_rows_kernel", "K6 (a) LN stats"),
    ("mlp_chunk_blk::gemm_bf16_kernel<true", "K6 (b) LN + W1 GEMM + act"),
    ("mlp_chunk_blk::chunk_down_kernel", "K6 (c) chunked W2 GEMM + residual"),
    ("int8_gemm::", "K13 int8 GEMM"),
    ("attn_block::row_stats_kernel", "K4 (a) LN stats"),
    ("attn_block::gw_kernel<true", "K4 (b) LN + QKV GEMM"),
    ("attn_block::mha_wgmma_kernel<2>", "K4 (c) attention, safe"),
    ("attn_block::mha_wgmma_kernel<1>", "K4 (c) attention, max-free"),
    ("attn_block::gw_kernel<false", "K4 (d) out-proj + residual"),
    ("attn_block::", UNEXPECTED + " K4 kernel"),
    ("mlp::ln_rows_kernel", "K5 (a) LN stats"),
    ("mlp::gw_kernel<true", "K5 (b) LN + W1 GEMM + act"),
    ("mlp::gw_kernel<false", "K5 (c) W2 GEMM + residual"),
    ("mlp::", UNEXPECTED + " K5 kernel"),
    ("attn_bwd::ln_rows_kernel", "K23 (a) LN + xn"),
    ("attn_bwd::gemm_bf16_kernel<false,false,false>", "K23 (b) QKV recompute"),
    ("attn_bwd::gemm_bf16_kernel<false,false,true>",
     "K23 (c, h) gw = g Wo^T, dxn = dqkv Wqkv^T"),
    ("attn_bwd::attn_bwd_kernel", "K23 (d) attention backward"),
    ("attn_bwd::gemm_bf16_kernel<false,true,false>",
     "K23 (e, f) dWo, dWqkv"),
    ("attn_bwd::colsum", "K23 (g) bias and LN column sums"),
    ("attn_bwd::ln_bwd_kernel", "K23 (i) LN backward"),
    ("mlp_bwd::ln_rows_kernel", "K24 (a) LN + xn"),
    ("mlp_bwd::gf_kernel", "K24 (b, c) da = g W2^T, h recompute, act "
     "backward"),
    ("mlp_bwd::gw_kernel<false,false,1,1>", "K24 (e) dxn = dh W1^T"),
    ("mlp_bwd::gw_kernel<false,false,2,1>", "K24 (f, g) dW1, dW2 partials"),
    ("mlp_bwd::gw_split_sum_kernel", "K24 (f, g) split-K sums"),
    ("mlp_bwd::colsum", "K24 (d, h) bias and LN column sums"),
    ("mlp_bwd::ln_bwd_kernel", "K24 (i) LN backward"),
    ("mlp_bwd::", UNEXPECTED + " K24 kernel"),
)


TORCH_OPS = "torch ops (preprocess, embed, stats, head, loss, optimizer)"


def _stage(name: str) -> str:
    flat = name.replace(" ", "").replace("(int)", "")
    for frag, label in STAGES:
        if frag in flat:
            return label
    return TORCH_OPS


def _device_events(prof):
    """(name, start_us, end_us) of every kernel and copy the profiler saw
    on the device (not the ranges that annotations such as the
    optimizer's step mark on the device timeline)."""
    out = []
    for e in prof.events():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and not e.is_user_annotation):
            out.append((e.name, e.time_range.start, e.time_range.end))
    return out


def _busy_us(intervals) -> float:
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def _model(name: str, image: int):
    """(family module, config) for ``--model`` / ``--image``, with
    bench.py's prefix rules: ``clip_<variant>`` is the CLIP vision tower
    of that ViT variant, ``deit_*`` a DeiT variant, else a ViT variant."""
    from .models import clip, deit, vit
    if name.startswith("clip_"):
        return clip, clip.clip_vision_config(name.removeprefix("clip_"),
                                             image_size=image,
                                             dtype="bfloat16")
    if name.startswith("deit_"):
        return deit, deit.config(name, image_size=image, dtype="bfloat16")
    return vit, vit.config(name, image_size=image, dtype="bfloat16")


def _serve_run(family, cfg, batch):
    """One served forward: the family's make_forward on a seeded uint8
    batch."""
    gen = torch.Generator()
    gen.manual_seed(0)
    fwd = family.make_forward(cfg, family.init_params(cfg, generator=gen,
                                                      device="cuda"),
                              raw=True)
    images = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (batch, cfg.image_size, cfg.image_size, 3),
        np.uint8)).cuda()
    return lambda: fwd(images)


def _int8_tree(cfg, params, static):
    from .models import quantized
    return (quantized.quantize_vit_static(params, cfg) if static
            else quantized.quantize_vit_fast(params))


def _serve_int8_run(cfg, batch, static):
    """One served int8 forward: make_forward_int8 on quantize_vit_fast (or
    quantize_vit_static) of the seed-0 weights, a seeded uint8 batch."""
    from .models import quantized, vit
    gen = torch.Generator()
    gen.manual_seed(0)
    qparams = _int8_tree(cfg, vit.init_params(cfg, gen, device="cuda"),
                         static)
    fwd = quantized.make_forward_int8(cfg, qparams, raw=True)
    images = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (batch, cfg.image_size, cfg.image_size, 3),
        np.uint8)).cuda()
    return lambda: fwd(images)


def _per_tensor_run(cfg, batch):
    """One per-tensor int8 forward: make_vit_forward_int8 on quantize_vit
    of the seed-0 f32 weights, on a seeded uint8 batch."""
    import dataclasses

    from .models import quantized, vit
    cfg = dataclasses.replace(cfg, dtype="float32")
    gen = torch.Generator()
    gen.manual_seed(0)
    fwd = quantized.make_vit_forward_int8(cfg, quantized.quantize_vit(
        vit.init_params(cfg, gen, device="cuda")))
    images = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (batch, cfg.image_size, cfg.image_size, 3),
        np.uint8)).cuda()
    return lambda: fwd(images)


def _latency_run(cfg, batch, int8, static, full=False):
    """One batch-1 latency forward: make_forward_latency, or
    make_forward_int8_latency on quantize_vit_fast (or quantize_vit_static)
    of the seed-0 weights, on a seeded uint8 batch; with ``full`` their
    single-launch whole-model forms (K12, K20)."""
    from .models import quantized, vit
    gen = torch.Generator()
    gen.manual_seed(0)
    params = vit.init_params(cfg, gen, device="cuda")
    fwd = (quantized.make_forward_int8_latency(
        cfg, _int8_tree(cfg, params, static), full=full) if int8
        else vit.make_forward_latency(cfg, params, full=full))
    images = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (batch, cfg.image_size, cfg.image_size, 3),
        np.uint8)).cuda()
    return lambda: fwd(images)


def _stack_stages(cfg, batch, int8, static, launches=10):
    """The single-launch encoder's own stage clock (csrc/stack.cuh) over
    ``launches`` launches on seeded tokens of the forward's shape, with the
    weights as the latency forward prepares them: us per launch of each
    stage, its critical path and its barrier, and the barrier share."""
    from .models import quantized, vit
    from .ops import vit_stack as vs
    gen = torch.Generator()
    gen.manual_seed(0)
    params = vit.init_params(cfg, gen, device="cuda")
    n_pad = -(-cfg.seq_len // 8) * 8
    x = (torch.randn((batch, n_pad, cfg.hidden_dim), generator=gen)
         .to(torch.bfloat16).cuda())
    if int8:
        blocks = quantized.prep_int8_latency(
            _int8_tree(cfg, params, static), cfg)["blocks"]
        fn, stages = ((vs.vit_layers_int8_static, vs.K19B_STAGES) if static
                      else (vs.vit_layers_int8, vs.K19A_STAGES))
    else:
        blocks = vit.prep_latency(params, cfg)["blocks"]
        fn, stages = vs.vit_layers, vs.K11_STAGES
    fn(x, blocks, cfg.num_heads, eps=cfg.ln_eps, n_valid=cfg.seq_len)
    trace = vs.new_trace(x.device)
    for _ in range(launches):
        fn(x, blocks, cfg.num_heads, eps=cfg.ln_eps, n_valid=cfg.seq_len,
           trace=trace)
    torch.cuda.synchronize()
    return vs.trace_report(trace, stages, launches)


def _full_stages(cfg, batch, int8, launches=10):
    """K12's (or K20's) stage clock over ``launches`` launches on a seeded
    normalized bf16 image batch, the weights as the full forwards fold
    them."""
    from .models import quantized, vit
    from .ops import vit_stack as vs
    gen = torch.Generator()
    gen.manual_seed(0)
    params = vit.init_params(cfg, gen, device="cuda")
    images = (torch.randn((batch, cfg.image_size, cfg.image_size, 3),
                          generator=gen).to(torch.bfloat16).cuda())
    kw = dict(eps=cfg.ln_eps, act="gelu_tanh")
    if int8:
        f = quantized.prep_full_int8_latency(_int8_tree(cfg, params, False),
                                             cfg)
        args = (f["wpq"], f["wps"], f["posb"], f["blocks"], f["lfs"],
                f["lfb"], f["whq"], f["whs"], f["bh"])
        fn, stages = vs.vit_full_int8, vs.K20_STAGES
    else:
        f = vit.prep_full_latency(params, cfg)
        args = (f["wp"], f["posb"], f["blocks"], f["lfs"], f["lfb"], f["wh"],
                f["bh"])
        fn, stages = vs.vit_full, vs.K12_STAGES
    fn(images, *args, cfg.num_heads, cfg.patch_size, **kw)
    trace = vs.new_trace(images.device)
    for _ in range(launches):
        fn(images, *args, cfg.num_heads, cfg.patch_size, trace=trace, **kw)
    torch.cuda.synchronize()
    return vs.trace_report(trace, stages, launches)


def _train_run(cfg, batch):
    """One SGD(1e-4) training step on a seeded normalized batch."""
    from .models import vit
    from .train import trainer as tr
    gen = torch.Generator()
    gen.manual_seed(0)
    params, opt = tr.init_train_state(
        cfg, tr.sgd(1e-4), params=vit.init_params(cfg, gen, device="cuda"))
    images = vit.preprocess(torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (batch, cfg.image_size, cfg.image_size, 3),
        np.uint8)).cuda(), cfg)
    labels = torch.zeros((batch,), dtype=torch.int64, device="cuda")
    step = tr.make_vit_train_step(cfg)
    return lambda: step(params, opt, images, labels)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="vit_b16",
                    help="a ViT variant, clip_<variant> or deit_<variant>")
    ap.add_argument("--image", type=int, default=224,
                    help="square input size in pixels")
    ap.add_argument("--batch", type=int, default=None,
                    help="64, or 1 with --latency")
    ap.add_argument("--steps", type=int, default=3)
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--train", action="store_true",
                      help="profile one SGD training step instead of the "
                           "served forward")
    mode.add_argument("--int8", action="store_true",
                      help="profile the served dynamic int8 forward")
    mode.add_argument("--per-tensor", action="store_true",
                      help="profile the per-tensor int8 forward (K13, K7 "
                           "in f32)")
    ap.add_argument("--static", action="store_true",
                    help="with --int8: the calibrated static-scale tree")
    single = ap.add_mutually_exclusive_group()
    single.add_argument("--latency", action="store_true",
                        help="profile the single-launch batch-1 encoder's "
                             "forward")
    single.add_argument("--full", action="store_true",
                        help="profile the batch-1 forward whose embed, "
                             "layers and head run in one launch")
    args = ap.parse_args(argv)
    if (args.latency or args.full) and (args.train or args.per_tensor):
        ap.error("--latency and --full profile a forward, not a training "
                 "step")
    if args.full and args.static:
        ap.error("--full runs the dynamic int8 tree (K20), not the static "
                 "one")
    if args.static and not args.int8:
        ap.error("--static selects the int8 tree: give --int8 too")
    if args.batch is None:
        args.batch = 1 if args.latency or args.full else 64

    from .models import vit
    from .utils.platform import require_hopper
    from .utils.timing import time_cuda

    family, cfg = _model(args.model, args.image)
    if family is not vit and (args.train or args.int8 or args.latency
                              or args.full or args.per_tensor):
        ap.error("CLIP and DeiT profile the bf16 served forward only")
    kind = require_hopper()
    mode = ("train" if args.train else "serve-int8" if args.int8
            else "per-tensor-int8" if args.per_tensor else "serve")
    if args.latency or args.full:
        mode = ("full" if args.full else "latency") + (
            "-int8" if args.int8 else "")
        run = _latency_run(cfg, args.batch, args.int8, args.static,
                           full=args.full)
    elif args.int8:
        run = _serve_int8_run(cfg, args.batch, args.static)
    elif args.train:
        run = _train_run(cfg, args.batch)
    elif args.per_tensor:
        run = _per_tensor_run(cfg, args.batch)
    else:
        run = _serve_run(family, cfg, args.batch)
    if args.static:
        mode += "-static"

    run()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms = time_cuda(run, iters=5 if args.train else 10, warmup=2)
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    loops = None
    if args.latency or args.full:   # bench.py's five loop estimates
        loops = sorted(time_cuda(run, iters=32, warmup=2) for _ in range(5))

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(args.steps):
            run()
        torch.cuda.synchronize()
    events = _device_events(prof)

    per_stage = defaultdict(lambda: [0.0, 0])
    torch_ops = defaultdict(float)   # the plain torch kernels, by name
    for name, s, e in events:
        label = _stage(name)
        st = per_stage[label]
        st[0] += (e - s) / 1e3 / args.steps
        st[1] += 1
        if label == TORCH_OPS:
            torch_ops[name[:90]] += (e - s) / 1e3 / args.steps
    result = {
        "device": kind, "model": args.model, "image": args.image,
        "batch": args.batch,
        "mode": mode,
        "step_ms": step_ms, "img_per_s": args.batch / step_ms * 1e3,
        "peak_mem_mb": peak_mb,
        "stages_ms_per_step": {k: v[0] for k, v in per_stage.items()},
        "launches_per_step": {k: v[1] // args.steps
                              for k, v in per_stage.items()},
        "top_torch_ops_ms": dict(sorted(torch_ops.items(),
                                        key=lambda kv: -kv[1])[:8]),
        "unexpected": sorted(k for k in per_stage
                             if k.startswith(UNEXPECTED)),
    }
    if args.latency:
        result["encoder_stages_us"] = _stack_stages(cfg, args.batch,
                                                    args.int8, args.static)
    if args.full:
        result["encoder_stages_us"] = _full_stages(cfg, args.batch,
                                                   args.int8)
    if args.latency or args.full:
        result["torch_launches_per_request"] = len(events) / args.steps
    if loops is not None:
        result["p50_ms"] = loops[len(loops) // 2]
        result["max_ms"] = loops[-1]
        result["loop_estimates_ms"] = loops
    if args.train:
        result["tflops"] = (3 * vit.flops_per_image(cfg) * args.batch
                            / (step_ms * 1e-3) / 1e12)
    if events:
        span = max(e for _, _, e in events) - min(s for _, s, _ in events)
        busy = _busy_us([(s, e) for _, s, e in events])
        result["idle_share"] = 1.0 - busy / span if span > 0 else None
    else:
        result["idle_share"] = None   # the profiler saw no device work

    what = "train step" if args.train else "batch"
    dtype = ("int8" if args.int8 else "per-tensor int8" if args.per_tensor
             else "bf16")
    print(f"{args.model} @{args.image} {dtype} "
          f"b{args.batch} "
          f"{mode} on {kind}: {step_ms:.4f} ms per "
          f"{what}, {result['img_per_s']:.1f} img/s, peak {peak_mb:.0f} MiB"
          + (f", {result['tflops']:.1f} TFLOP/s" if args.train else "")
          + (f", p50 {result['p50_ms']:.4f} ms, max {result['max_ms']:.4f} "
             f"ms over 5 loops of 32" if loops is not None else ""))
    for label, (ms, n) in sorted(per_stage.items(), key=lambda kv: -kv[1][0]):
        print(f"  {ms:9.4f} ms/step  {n // args.steps:4d} launches  {label}")
    print(f"  device idle share: {result['idle_share']}")
    if result["unexpected"]:
        print(f"  UNEXPECTED kernels on the path: {result['unexpected']}")
    if args.latency or args.full:
        print(f"  torch launches per request: "
              f"{result['torch_launches_per_request']:.2f}")
        rep = result["encoder_stages_us"]
        print(f"  encoder stage clock ({rep['blocks']} blocks, us per launch; "
              f"wall = work + barrier; barrier = least wait of any block):")
        for name, row in rep.items():
            if isinstance(row, dict):
                print(f"    {row['wall']:9.2f} wall  {row['busy_mean']:9.2f} "
                      f"mean work  {row['busy_max']:9.2f} max work  "
                      f"{row['barrier']:8.2f} barrier  {name}")
        print(f"    total {rep['total_wall']:.2f} us, barrier share "
              f"{rep['barrier_share']:.3f}")
    for name, ms in result["top_torch_ops_ms"].items():
        print(f"  torch op {ms:9.4f} ms/step  {name}")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
