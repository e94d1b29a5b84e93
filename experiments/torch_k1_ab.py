"""K1's, K2's, K5's, K3's, K26's, K4's or K24's time at a shape, from the
package tree found under ROOT, so that two versions of the port are compared
in one call on one card.

Run on a machine with a Hopper card, from the repository root:

    python3 experiments/torch_k1_ab.py [ROOT]
        [--kernel k1|k2|k5|k3|k26|k4|k24] [--shape B N_PAD N_VALID D HEADS]
        [--mlp-shape T D M] [--one-consumer]

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
and K5 as controls, then the b64 SGD step.
Prints five CUDA-event estimates of 20 launches each (``emit_stats`` on,
seeded inputs at chip_smoke.py's scales; 5 calls of a forward or step)
beside the card's name and power limit, and one JSON line.
``--one-consumer`` times a copy of ROOT's package (made under ROOT's
git-ignored ``_chip/k1_one_consumer/``) whose attention kernel
(``csrc/mha_wgmma.cuh``) takes 64 query rows a block on one consumer
warpgroup instead of 128 on two: Q's TMA box shrinks to 64 rows, K's and
V's stay 128, and the ring (4 stages, 137 KB) keeps one block an SM.
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
                    choices=("k1", "k2", "k5", "k3", "k26", "k4", "k24"),
                    default="k1")
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

    if args.kernel == "k1":
        shape = args.shape
        runs = {f"K1 {tuple(shape)}": k1_run(*shape)}
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
    ms.update({label: [device_alone_ms(fn, 200 if args.kernel == "k26"
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
    if args.kernel == "k24":
        ms.update(time_sgd_step(g))
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
