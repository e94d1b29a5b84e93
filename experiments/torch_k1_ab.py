"""K1's time at a shape, from the package tree found under ROOT, so that two
versions of the port are compared in one call on one card.

Run on a machine with a Hopper card, from the repository root:

    python3 experiments/torch_k1_ab.py [ROOT] [--shape B N_PAD N_VALID D HEADS]

ROOT (default: this repository) holds the ``vit_fpga_tpu_torch`` package to
time, e.g. a ``git archive`` of another commit unpacked under ``_chip/``; its
kernels build into its own ``_build/``.  The default shape is ViT-B/16 at
batch 64: (64, 200, 768), 197 valid tokens, 12 heads.  Prints five CUDA-event
estimates of 20 launches each (``attn_block_stats`` with ``emit_stats``,
seeded inputs at chip_smoke.py's scales) beside the card's name and power
limit, and one JSON line.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("root", nargs="?",
                    default=str(Path(__file__).resolve().parent.parent))
    ap.add_argument("--shape", type=int, nargs=5,
                    default=[64, 200, 197, 768, 12],
                    metavar=("B", "N_PAD", "N_VALID", "D", "HEADS"))
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch
    from vit_fpga_tpu_torch.ops import attn_block as ab
    from vit_fpga_tpu_torch.ops.common import row_stats
    from vit_fpga_tpu_torch.utils.timing import time_cuda
    if not torch.cuda.is_available():
        print("torch_k1_ab: no CUDA device", file=sys.stderr)
        return 1
    if Path(ab.__file__).resolve().parents[2] != root:
        raise RuntimeError(f"imported {ab.__file__}, not the tree at {root}")
    b, n_pad, n_valid, d, heads = args.shape
    g = torch.Generator()
    g.manual_seed(3)

    def randn(*shape, std=1.0, mean=0.0):
        return (torch.randn(shape, generator=g) * std + mean).cuda()

    x = randn(b, n_pad, d).to(torch.bfloat16)
    st = row_stats(x, 1e-6)
    p = (randn(d, std=0.1, mean=1.0), randn(d, std=0.1),
         randn(d, 3 * d, std=0.06).to(torch.bfloat16), randn(3 * d, std=0.02),
         randn(d, d, std=0.02).to(torch.bfloat16), randn(d, std=0.02))

    def run():
        return ab.attn_block_stats(x, st, *p, heads, eps=1e-6,
                                   n_valid=n_valid, emit_stats=True)

    ms = [time_cuda(run, iters=20, warmup=5) for _ in range(5)]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         stdout=subprocess.PIPE, text=True).stdout.strip()
    print(f"K1 {tuple(args.shape)} from {root}: "
          + " / ".join(f"{t:.4f}" for t in ms) + f" ms on {smi}")
    print(json.dumps({"root": str(root), "shape": args.shape, "ms": ms,
                      "device": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
