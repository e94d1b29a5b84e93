"""K7 / K8 (the whole-sequence exact-softmax attention) and K9 times, and the
``attn_impl="pallas"`` ViT-B/16 @1024 px forward (12 K7 a request), from the
package tree found under ROOT, so that two versions of the port are compared
in one call on one card.

Run on a machine with a Hopper card, from the repository root:

    python3 experiments/torch_k7_ab.py [ROOT] [--f32]

ROOT (default: this repository) holds the ``vit_fpga_tpu_torch`` package to
time, e.g. a ``git archive`` of another commit unpacked under ``_chip/``; its
kernels build into its own ``_build/``.  Shapes: K7 bf16 on ViT-B/16 @1024
px's packed (1, 4104, 2304) qkv with 4097 valid keys, K8 bf16 on (1, 12,
4104, 64) with 4097 valid, K7 bf16 at 224 px's (64, 197, 2304), K9 as the
1024 px path runs it (bk 128), each beside ``scaled_dot_product_attention``
with the key mask on contiguous (B, H, N, 64) operands; then the bf16
ViT-B/16 @1024 b1 forward with ``attn_impl="pallas"`` from uint8 on the
card (seeded random weights).  With ``--f32``: K7 in f32 at the
per-tensor int8 forward's (64, 197, 2304) beside SDPA in f32 on contiguous
(64, 12, 197, 64) operands, and that forward (``make_vit_forward_int8`` on
a ``quantize_vit`` tree of f32 ViT-B/16 @224) at b64 from uint8 on the
card.  Prints five CUDA-event estimates of each (20 launches, or 5
forwards) beside the card's name and power limit, and one JSON line.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
from pathlib import Path


def time_bf16(g):
    """K7 / K8 bf16, SDPA, K9 and the ``attn_impl="pallas"`` forward:
    {label: five ms estimates}."""
    import torch
    import torch.nn.functional as F
    from vit_fpga_tpu_torch.models import vit
    from vit_fpga_tpu_torch.ops import attention as at
    from vit_fpga_tpu_torch.ops import flash_attention as fa
    from vit_fpga_tpu_torch.utils.timing import time_cuda

    def packed(b, n):
        return torch.randn((b, n, 2304), generator=g).to(torch.bfloat16).cuda()

    def heads(qkv):
        return [t.contiguous() for t in at._heads(qkv, 12)]

    n, nv = 4104, 4097
    q1024 = packed(1, n)
    qs1024 = heads(q1024)
    q224 = packed(64, 197)
    qs224 = heads(q224)
    keep = (torch.arange(n, device="cuda") < nv)[None, None, None]

    def k9():
        o = fa.flash_attention(*at._heads(q1024, 12), nv, bq=512, bk=128)
        return o.transpose(1, 2).reshape(1, n, 768)

    runs = {
        "K7 bf16 (1, 4104, 2304) n_valid 4097":
            lambda: at.mha_qkv_pallas(q1024, 12, nv),
        "K8 bf16 (1, 12, 4104, 64) n_valid 4097":
            lambda: at.mha_pallas(*qs1024, nv),
        "SDPA (1, 12, 4104, 64) key mask":
            lambda: F.scaled_dot_product_attention(*qs1024, attn_mask=keep),
        "K7 bf16 (64, 197, 2304)": lambda: at.mha_qkv_pallas(q224, 12),
        "SDPA (64, 12, 197, 64)":
            lambda: F.scaled_dot_product_attention(*qs224),
        "K9 (1, 4104, 2304) bk 128": k9,
    }
    ms = {label: [time_cuda(fn, iters=20, warmup=5) for _ in range(5)]
          for label, fn in runs.items()}

    cfg = dataclasses.replace(
        vit.config("vit_b16", image_size=1024, dtype="bfloat16"),
        attn_impl="pallas")
    fwd = vit.make_forward(cfg, vit.init_params(cfg, g, device="cuda"))
    img = torch.randint(0, 256, (1, 1024, 1024, 3), generator=g,
                        dtype=torch.uint8).cuda()
    label = "ViT-B/16 @1024 b1 attn_impl='pallas' forward (uint8 in)"
    ms[label] = [time_cuda(lambda: fwd(img), iters=5, warmup=2)
                 for _ in range(5)]
    return ms


def time_f32(g):
    """K7 f32 and SDPA f32 at (64, 197, 2304), the per-tensor int8 b64
    forward: {label: five ms estimates}."""
    import torch
    import torch.nn.functional as F
    from vit_fpga_tpu_torch.models import quantized, vit
    from vit_fpga_tpu_torch.ops import attention as at
    from vit_fpga_tpu_torch.utils.timing import time_cuda
    qkv = torch.randn((64, 197, 2304), generator=g).cuda()
    heads = [t.contiguous() for t in at._heads(qkv, 12)]
    runs = {
        "K7 f32 (64, 197, 2304)": lambda: at.mha_qkv_pallas(qkv, 12),
        "SDPA f32 (64, 12, 197, 64)":
            lambda: F.scaled_dot_product_attention(*heads),
    }
    ms = {label: [time_cuda(fn, iters=20, warmup=5) for _ in range(5)]
          for label, fn in runs.items()}
    cfg = vit.config("vit_b16", dtype="float32")
    fwd = quantized.make_vit_forward_int8(
        cfg, quantized.quantize_vit(vit.init_params(cfg, g, device="cuda")))
    img = torch.randint(0, 256, (64, 224, 224, 3), generator=g,
                        dtype=torch.uint8).cuda()
    label = "per-tensor int8 ViT-B/16 @224 b64 forward (uint8 in)"
    ms[label] = [time_cuda(lambda: fwd(img), iters=5, warmup=2)
                 for _ in range(5)]
    return ms


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("root", nargs="?",
                    default=str(Path(__file__).resolve().parent.parent))
    ap.add_argument("--f32", action="store_true")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch
    from vit_fpga_tpu_torch.ops import attention as at
    if not torch.cuda.is_available():
        print("torch_k7_ab: no CUDA device", file=sys.stderr)
        return 1
    if Path(at.__file__).resolve().parents[2] != root:
        raise RuntimeError(f"imported {at.__file__}, not the tree at {root}")
    g = torch.Generator()
    g.manual_seed(7)

    ms = (time_f32 if args.f32 else time_bf16)(g)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         stdout=subprocess.PIPE, text=True).stdout.strip()
    for label, ts in ms.items():
        print(f"{label} from {root}: " + " / ".join(f"{t:.4f}" for t in ts)
              + f" ms on {smi}")
    print(json.dumps({"root": str(root), "ms": ms, "device": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
