"""Where the time goes in the served ViT forward on the card.

    python -m vit_fpga_tpu_torch.profile_forward [--model vit_b16]
        [--batch 64] [--steps 3]

Runs ``make_forward(cfg, params, raw=True)`` (bf16, random weights from
seed 0) on a seeded uint8 batch already on the card, and prints:

  * the forward's time per batch (CUDA events) and images per second;
  * device time per launch site over ``--steps`` profiled forwards
    (torch.profiler), grouped into the stages of kernels K1 and K2;
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

# launch-site name fragment -> stage label (csrc/*.cu name each site's
# kernels by translation unit: attn_half:: for K1, mlp_half:: for K2)
STAGES = (
    ("attn_half::gemm_bf16_kernel<true>", "K1 (a) LN + QKV GEMM"),
    ("attn_half::attn_kernel", "K1 (b) attention"),
    ("attn_half::gemm_bf16_kernel<false>", "K1 (c) out-proj + residual"),
    ("attn_half::row_stats_kernel", "K1 (d) next stats"),
    ("mlp_half::gemm_bf16_kernel<true>", "K2 (a) LN + W1 GEMM + act"),
    ("mlp_half::gemm_bf16_kernel<false>", "K2 (b) W2 GEMM + residual"),
    ("mlp_half::row_stats_kernel", "K2 (c) next stats"),
)


def _stage(name: str) -> str:
    for frag, label in STAGES:
        if frag in name:
            return label
    return "torch ops (preprocess, embed, first stats, head)"


def _device_events(prof):
    """(name, start_us, end_us) of every kernel the profiler saw."""
    out = []
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="vit_b16")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args(argv)

    from .models import vit
    from .utils.platform import require_hopper
    from .utils.timing import time_cuda

    kind = require_hopper()
    cfg = vit.config(args.model, dtype="bfloat16")
    gen = torch.Generator()
    gen.manual_seed(0)
    params = vit.init_params(cfg, gen, device="cuda")
    fwd = vit.make_forward(cfg, params, raw=True)
    images = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (args.batch, cfg.image_size, cfg.image_size, 3),
        np.uint8)).cuda()

    torch.cuda.reset_peak_memory_stats()
    step_ms = time_cuda(lambda: fwd(images), iters=10, warmup=2)
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(args.steps):
            fwd(images)
        torch.cuda.synchronize()
    events = _device_events(prof)

    per_stage = defaultdict(lambda: [0.0, 0])
    for name, s, e in events:
        st = per_stage[_stage(name)]
        st[0] += (e - s) / 1e3 / args.steps
        st[1] += 1
    result = {
        "device": kind, "model": args.model, "batch": args.batch,
        "step_ms": step_ms, "img_per_s": args.batch / step_ms * 1e3,
        "peak_mem_mb": peak_mb,
        "stages_ms_per_step": {k: v[0] for k, v in per_stage.items()},
        "launches_per_step": {k: v[1] // args.steps
                              for k, v in per_stage.items()},
    }
    if events:
        span = max(e for _, _, e in events) - min(s for _, s, _ in events)
        busy = _busy_us([(s, e) for _, s, e in events])
        result["idle_share"] = 1.0 - busy / span if span > 0 else None
    else:
        result["idle_share"] = None   # the profiler saw no device work

    print(f"{args.model} bf16 b{args.batch} on {kind}: {step_ms:.3f} ms per "
          f"batch, {result['img_per_s']:.1f} img/s, peak {peak_mb:.0f} MiB")
    for label, (ms, n) in sorted(per_stage.items(), key=lambda kv: -kv[1][0]):
        print(f"  {ms:9.4f} ms/step  {n // args.steps:4d} launches  {label}")
    print(f"  device idle share: {result['idle_share']}")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
