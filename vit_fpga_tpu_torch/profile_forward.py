"""Where the time goes on the card: the served ViT forward, or one
training step.

    python -m vit_fpga_tpu_torch.profile_forward [--model vit_b16]
        [--batch 64] [--steps 3] [--train]

Without ``--train`` it runs ``make_forward(cfg, params, raw=True)`` (bf16,
random weights from seed 0) on a seeded uint8 batch already on the card;
with ``--train`` one SGD(1e-4) step of ``make_vit_train_step`` (bench.py's
train shape) on a seeded normalized batch.  It prints:

  * the time per batch or step (CUDA events), images per second and, for
    a step, TFLOP/s counted as 3 x the forward (bench.py's count);
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

# launch-site name fragment (spaces removed) -> stage label.  csrc/*.cu
# name each site's kernels by translation unit: attn_half:: K1,
# mlp_half:: K2, attn_block:: K4, mlp:: K5, attn_bwd:: K23, mlp_bwd:: K24.
# The first fragment found in a kernel's name wins.
STAGES = (
    ("attn_half::gemm_bf16_kernel<true", "K1 (a) LN + QKV GEMM"),
    ("attn_half::attn_kernel", "K1 (b) attention"),
    ("attn_half::gemm_bf16_kernel<false", "K1 (c) out-proj + residual"),
    ("attn_half::row_stats_kernel", "K1 (d) next stats"),
    ("mlp_half::gemm_bf16_kernel<true", "K2 (a) LN + W1 GEMM + act"),
    ("mlp_half::gemm_bf16_kernel<false", "K2 (b) W2 GEMM + residual"),
    ("mlp_half::row_stats_kernel", "K2 (c) next stats"),
    ("attn_block::row_stats_kernel", "K4 (a) LN stats"),
    ("attn_block::gemm_bf16_kernel<true", "K4 (b) LN + QKV GEMM"),
    ("attn_block::attn_kernel", "K4 (c) attention"),
    ("attn_block::gemm_bf16_kernel<false", "K4 (d) out-proj + residual"),
    ("mlp::ln_rows_kernel", "K5 (a) LN stats"),
    ("mlp::gemm_bf16_kernel<true", "K5 (b) LN + W1 GEMM + act"),
    ("mlp::gemm_bf16_kernel<false", "K5 (c) W2 GEMM + residual"),
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
    ("mlp_bwd::gemm_bf16_kernel<false,false,true>",
     "K24 (b, e) da = g W2^T, dxn = dh W1^T"),
    ("mlp_bwd::gemm_bf16_kernel<false,false,false>",
     "K24 (c) h recompute + act backward"),
    ("mlp_bwd::gemm_bf16_kernel<false,true,false>", "K24 (f, g) dW1, dW2"),
    ("mlp_bwd::colsum", "K24 (d, h) bias and LN column sums"),
    ("mlp_bwd::ln_bwd_kernel", "K24 (i) LN backward"),
)


TORCH_OPS = "torch ops (preprocess, embed, stats, head, loss, optimizer)"


def _stage(name: str) -> str:
    flat = name.replace(" ", "")
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


def _serve_run(cfg, batch):
    """One served forward: make_forward on a seeded uint8 batch."""
    from .models import vit
    gen = torch.Generator()
    gen.manual_seed(0)
    fwd = vit.make_forward(cfg, vit.init_params(cfg, gen, device="cuda"),
                           raw=True)
    images = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (batch, cfg.image_size, cfg.image_size, 3),
        np.uint8)).cuda()
    return lambda: fwd(images)


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
    ap.add_argument("--model", default="vit_b16")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--train", action="store_true",
                    help="profile one SGD training step instead of the "
                         "served forward")
    args = ap.parse_args(argv)

    from .models import vit
    from .utils.platform import require_hopper
    from .utils.timing import time_cuda

    kind = require_hopper()
    cfg = vit.config(args.model, dtype="bfloat16")
    run = (_train_run if args.train else _serve_run)(cfg, args.batch)

    run()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms = time_cuda(run, iters=5 if args.train else 10, warmup=2)
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20

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
        "device": kind, "model": args.model, "batch": args.batch,
        "mode": "train" if args.train else "serve",
        "step_ms": step_ms, "img_per_s": args.batch / step_ms * 1e3,
        "peak_mem_mb": peak_mb,
        "stages_ms_per_step": {k: v[0] for k, v in per_stage.items()},
        "launches_per_step": {k: v[1] // args.steps
                              for k, v in per_stage.items()},
        "top_torch_ops_ms": dict(sorted(torch_ops.items(),
                                        key=lambda kv: -kv[1])[:8]),
    }
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
    print(f"{args.model} bf16 b{args.batch} on {kind}: {step_ms:.3f} ms per "
          f"{what}, {result['img_per_s']:.1f} img/s, peak {peak_mb:.0f} MiB"
          + (f", {result['tflops']:.1f} TFLOP/s" if args.train else ""))
    for label, (ms, n) in sorted(per_stage.items(), key=lambda kv: -kv[1][0]):
        print(f"  {ms:9.4f} ms/step  {n // args.steps:4d} launches  {label}")
    print(f"  device idle share: {result['idle_share']}")
    for name, ms in result["top_torch_ops_ms"].items():
        print(f"  torch op {ms:9.4f} ms/step  {name}")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
