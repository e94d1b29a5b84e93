"""K1's or K2's time at a shape, from the package tree found under ROOT, so
that two versions of the port are compared in one call on one card.

Run on a machine with a Hopper card, from the repository root:

    python3 experiments/torch_k1_ab.py [ROOT] [--kernel k1|k2]
        [--shape B N_PAD N_VALID D HEADS] [--mlp-shape T D M] [--one-consumer]

ROOT (default: this repository) holds the ``vit_fpga_tpu_torch`` package to
time, e.g. a ``git archive`` of another commit unpacked under ``_chip/``; its
kernels build into its own ``_build/``.  ``--kernel k1`` (the default) times
``attn_block_stats`` at ``--shape``, by default ViT-B/16 at batch 64: (64,
200, 768), 197 valid tokens, 12 heads; ``--kernel k2`` times
``fused_mlp_stats`` (gelu_tanh) at ``--mlp-shape``, by default ViT-B/16's
(12 800, 768) x 3072.  Prints five CUDA-event estimates of 20 launches each
(``emit_stats`` on, seeded inputs at chip_smoke.py's scales) beside the
card's name and power limit, and one JSON line.  ``--one-consumer`` times a
copy of ROOT's package (made under ROOT's git-ignored
``_chip/k1_one_consumer/``) whose attention kernel (``csrc/mha_wgmma.cuh``)
takes 64 query rows a block on one consumer warpgroup instead of 128 on
two: Q's TMA box shrinks to 64 rows, K's and V's stay 128, and the ring
(4 stages, 137 KB) keeps one block an SM.
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
    ("attn_stats.cu", "3 * d, n_pad, heads, batch)",
     "3 * d, n_pad, heads, batch, MW_BQ)"),
    ("mha.cu", "in_r, n, heads, batch)", "in_r, n, heads, batch, MW_BQ)"),
)


def one_consumer_copy(root: Path) -> Path:
    copy = root / "_chip" / "k1_one_consumer"
    # over an earlier copy, whose _build/ a later run reuses
    shutil.copytree(root / "vit_fpga_tpu_torch", copy / "vit_fpga_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"),
                    dirs_exist_ok=True)
    for name, old, new in ONE_CONSUMER:
        src = copy / "vit_fpga_tpu_torch" / "csrc" / name
        text = src.read_text()
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: {old!r} not found once")
        src.write_text(text.replace(old, new))
    return copy


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("root", nargs="?",
                    default=str(Path(__file__).resolve().parent.parent))
    ap.add_argument("--kernel", choices=("k1", "k2"), default="k1")
    ap.add_argument("--shape", type=int, nargs=5,
                    default=[64, 200, 197, 768, 12],
                    metavar=("B", "N_PAD", "N_VALID", "D", "HEADS"))
    ap.add_argument("--mlp-shape", type=int, nargs=3,
                    default=[12800, 768, 3072], metavar=("T", "D", "M"))
    ap.add_argument("--one-consumer", action="store_true")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    if args.one_consumer:
        root = one_consumer_copy(root)
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

    if args.kernel == "k1":
        shape = args.shape
        b, n_pad, n_valid, d, heads = shape
        x = randn(b, n_pad, d).to(torch.bfloat16)
        st = row_stats(x, 1e-6)
        p = (randn(d, std=0.1, mean=1.0), randn(d, std=0.1),
             randn(d, 3 * d, std=0.06).to(torch.bfloat16),
             randn(3 * d, std=0.02),
             randn(d, d, std=0.02).to(torch.bfloat16), randn(d, std=0.02))

        def run():
            return ab.attn_block_stats(x, st, *p, heads, eps=1e-6,
                                       n_valid=n_valid, emit_stats=True)
    else:
        shape = args.mlp_shape
        t, d, m = shape
        x = randn(t, d).to(torch.bfloat16)
        st = row_stats(x, 1e-6)
        p = (randn(d, std=0.1, mean=1.0), randn(d, std=0.1),
             randn(d, m, std=d ** -0.5).to(torch.bfloat16),
             randn(m, std=0.02),
             randn(m, d, std=m ** -0.5).to(torch.bfloat16),
             randn(d, std=0.02))

        def run():
            return fm.fused_mlp_stats(x, st, *p, eps=1e-6, act="gelu_tanh",
                                      emit_stats=True)

    ms = [time_cuda(run, iters=20, warmup=5) for _ in range(5)]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         stdout=subprocess.PIPE, text=True).stdout.strip()
    print(f"{args.kernel.upper()} {tuple(shape)} from {root}: "
          + " / ".join(f"{t:.4f}" for t in ms) + f" ms on {smi}")
    print(json.dumps({"root": str(root), "kernel": args.kernel,
                      "shape": shape, "ms": ms, "device": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
