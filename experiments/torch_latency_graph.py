"""The batch-1 latency forwards in a CUDA graph against the single-launch
whole-model forwards, on the card.

For ViT-B/16 (random weights from seed 0, bf16 and the dynamic int8 tree
of the same weights) it times, per request of ``--batch`` seeded images
already preprocessed on the card (``raw=False``: preprocess builds its
mean and std tensors from the host, which a capture refuses):

  * ``separate``: ``make_forward_latency`` (the torch embed, K11, the
    final LayerNorm and the head as torch ops) or
    ``make_forward_int8_latency`` (the same around K19a, the K14 head);
  * ``separate graph``: that same callable captured once in a CUDA graph
    on a static input and replayed;
  * ``single``: ``make_forward_latency(..., full=True)`` (K12) or
    ``make_forward_int8_latency(..., full=True)`` (K20);
  * ``single graph``: that callable captured and replayed.

Each is timed in turns (separate, graph, single, single graph, then the
reverse), each turn the p50 and max of ``--loops`` loop estimates of
``--iters`` calls between CUDA events.  A graph's logits are checked
against its eager callable's.  Measurement only: nothing in the package
uses a graph.

    python3 experiments/torch_latency_graph.py [--batch 1] [--loops 5]
        [--iters 32]

The last line is one JSON object with the card, its power limit and every
reading.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from vit_fpga_tpu_torch.models import quantized, vit  # noqa: E402
from vit_fpga_tpu_torch.utils.timing import time_cuda  # noqa: E402


def _smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, stdout=subprocess.PIPE,
        text=True, timeout=60).stdout.strip().splitlines()[0]


def _graphed(fn, static):
    """(replay, output) of ``fn(static)`` captured in a CUDA graph, after
    warm-up calls on a side stream as torch.cuda.graphs asks."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn(static)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn(static)
    return graph.replay, out


def _loops(fn, loops, iters):
    est = sorted(time_cuda(fn, iters=iters, warmup=2) for _ in range(loops))
    return est[len(est) // 2], est[-1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--loops", type=int, default=5)
    ap.add_argument("--iters", type=int, default=32)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_latency_graph: no CUDA device", file=sys.stderr)
        return 1
    smi = _smi()
    print(smi)
    cfg = vit.config("vit_b16", dtype="bfloat16")
    gen = torch.Generator()
    gen.manual_seed(0)
    params = vit.init_params(cfg, gen, device="cuda")
    qparams = quantized.quantize_vit_fast(params)
    raw = np.random.default_rng(0).integers(
        0, 256, (args.batch, cfg.image_size, cfg.image_size, 3), np.uint8)
    image = vit.preprocess(torch.from_numpy(raw).cuda(), cfg)
    eager = {
        "bf16 separate": vit.make_forward_latency(cfg, params, raw=False),
        "bf16 single": vit.make_forward_latency(cfg, params, raw=False,
                                                full=True),
        "int8 separate": quantized.make_forward_int8_latency(
            cfg, qparams, raw=False),
        "int8 single": quantized.make_forward_int8_latency(
            cfg, qparams, raw=False, full=True),
    }
    runs, errors = {}, {}
    for name, fn in eager.items():
        runs[name] = lambda fn=fn: fn(image)
        try:
            replay, out = _graphed(fn, image)
        except RuntimeError as e:   # the capture refused a launch
            errors[f"{name} graph"] = str(e).splitlines()[0]
            print(f"{name}: capture failed: {errors[f'{name} graph']}")
            continue
        replay()
        torch.cuda.synchronize()
        same = torch.equal(out, fn(image))
        print(f"{name} graph: logits equal to the eager call's: {same}")
        if not same:
            errors[f"{name} graph"] = "logits differ from the eager call's"
            continue
        runs[f"{name} graph"] = replay
    readings = {name: [] for name in runs}
    for dt in ("bf16", "int8"):
        order = [f"{dt} separate", f"{dt} separate graph", f"{dt} single",
                 f"{dt} single graph"]
        for name in order + order[::-1]:
            if name in runs:
                readings[name].append(_loops(runs[name], args.loops,
                                             args.iters))
    for name, rs in readings.items():
        print(f"{name} b{args.batch}: p50 / max ms per request "
              + ", ".join(f"{p:.4f} / {m:.4f}" for p, m in rs))
    print(smi)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "smi": smi,
                      "batch": args.batch, "loops": args.loops,
                      "iters": args.iters, "p50_max_ms": readings,
                      "errors": errors}))
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())
