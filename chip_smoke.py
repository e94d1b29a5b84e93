#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``vit_fpga_tpu_torch``).

Run from the repository root on a machine with one Hopper card:

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0):
  1. device   the card's name and power limit (nvidia-smi), Hopper check
  2. build    nvcc builds the kernels from vit_fpga_tpu_torch/csrc and
              prints ptxas's register and spill report
  3. parity   each kernel against its plain PyTorch version on the card
              at small shapes: elementwise, as a branch (out - x), the
              emitted stats, a case whose padding keys would swamp the
              output if unmasked, and the plain version run in f32
  4. path     each kernel at the serving shapes (ViT-B/16, batch 64):
              the same parity checks, then the kernel's time, the plain
              version's, a library yardstick's and the bound
  5. slice    ImageServer over make_forward(vit_b16, bf16) answers 160
              uint8 requests (2 full batches of 64 + 1 partial flush);
              logits of images from every batch are checked against
              the CPU forward, and every kernel must have run 12 times
              per served batch
Then one JSON line per the kernels, and the device line last.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

H100_BF16_FLOPS = 989e12      # dense tensor-core peak, H100 SXM data sheet
H100_HBM_BYTES_PER_S = 3.35e12

EPS = 1e-6
# bf16 kernel vs plain version, same inputs and rounding points: only
# the f32 accumulation order differs, which flips an occasional bf16 ulp
# (2^-8 relative) that later products spread: |a-b| <= 2^-6 (1 + |b|).
BF16_TOL = 2.0 ** -6
# The branch y = out - x, kernel vs plain, as ||dy|| / ||y||.  The residual
# hides y from the elementwise check; the ulp flips above move y by a few
# 1e-3 in norm, while a wrong mask or softmax moves all of it (11 unmasked
# zero keys among 197 shift the attention branch by about 5%).
BRANCH_TOL = 1e-2
# Emitted stats vs the plain stats of the kernel's own output: the same
# f32 sums of 768 terms in another order, |error| <= 768 * 2^-24 = 4.6e-5
# of the sum of magnitudes.
STATS_RTOL, STATS_ATOL = 1e-4, 5e-5
# bf16 kernel vs the plain version in f32: the bf16 rounding band.
F32_BAND = 0.05
# logits of the bf16 forward on the card vs on the CPU, relative to the
# largest logit: 12 layers of ulp flips.
LOGITS_BAND = 0.05


def _gen(seed: int) -> torch.Generator:
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def _randn(gen, *shape, std=1.0, mean=0.0, device="cuda"):
    return (torch.randn(shape, generator=gen) * std + mean).to(device)


def _smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, stdout=subprocess.PIPE, text=True, timeout=60)
    return res.stdout.strip().splitlines()[0]


def _compare(name, got, want, rtol, atol):
    """max abs / max relative error; raise if |a-b| > atol + rtol|b|."""
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    bad = int((diff > atol + rtol * w.abs()).sum())
    max_abs = float(diff.max())
    max_rel = max_abs / max(float(w.abs().max()), 1e-30)
    print(f"  {name}: max_abs={max_abs:.3e} max_rel={max_rel:.3e} "
          f"(tol |a-b| <= {atol:g} + {rtol:g}|b|, violations={bad})")
    if bad or not torch.isfinite(g).all():
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version")
    return max_abs


# ---------------------------------------------------------------------------
# Kernel inputs at a given shape (seeded, on the card)
# ---------------------------------------------------------------------------

def _attn_inputs(batch, n_pad, d, seed):
    from vit_fpga_tpu_torch.ops.common import row_stats
    g = _gen(seed)
    x = _randn(g, batch, n_pad, d).to(torch.bfloat16)
    p = dict(ln_scale=_randn(g, d, std=0.1, mean=1.0),
             ln_bias=_randn(g, d, std=0.1),
             wqkv=_randn(g, d, 3 * d, std=0.06),
             bqkv=_randn(g, 3 * d, std=0.02),
             wo=_randn(g, d, d, std=0.02),
             bo=_randn(g, d, std=0.02))
    return x, row_stats(x, EPS), p


def _mlp_inputs(rows, d, m, seed):
    from vit_fpga_tpu_torch.ops.common import row_stats
    g = _gen(seed)
    x = _randn(g, rows, d).to(torch.bfloat16)
    p = dict(ln_scale=_randn(g, d, std=0.1, mean=1.0),
             ln_bias=_randn(g, d, std=0.1),
             w1=_randn(g, d, m, std=d ** -0.5),
             b1=_randn(g, m, std=0.02),
             w2=_randn(g, m, d, std=m ** -0.5),
             b2=_randn(g, d, std=0.02))
    return x, row_stats(x, EPS), p


def _bf16_weights(p, names):
    return {k: (v.to(torch.bfloat16) if k in names else v)
            for k, v in p.items()}


def _attn_call(fn, x, st, p, heads, n_valid, emit):
    return fn(x, st, p["ln_scale"], p["ln_bias"], p["wqkv"], p["bqkv"],
              p["wo"], p["bo"], heads, eps=EPS, n_valid=n_valid,
              emit_stats=emit)


def _mlp_call(fn, x, st, p, emit):
    return fn(x, st, p["ln_scale"], p["ln_bias"], p["w1"], p["b1"], p["w2"],
              p["b2"], eps=EPS, act="gelu_tanh", emit_stats=emit)


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def _branch(name, got, want, x):
    """Norm-wise relative error of the branch ``out - x``, kernel vs
    plain; raise if above BRANCH_TOL."""
    xf = x.float()
    g, w = got.float() - xf, want.float() - xf
    rel = float((g - w).norm() / w.norm())
    print(f"  {name}: |d branch| / |branch| = {rel:.3e} (tol {BRANCH_TOL:g})")
    if not rel <= BRANCH_TOL:
        raise AssertionError(f"{name}: kernel's branch disagrees with its "
                             f"plain version")


def _parity(label, call, kernel, plain, x, rows=(...,)):
    """Kernel vs plain version on the same inputs, for both values of
    ``emit_stats``: the output (on ``rows``) elementwise and as a branch,
    and the emitted stats against the plain stats of the kernel's own
    output.  Returns the largest max-abs error of the output."""
    from vit_fpga_tpu_torch.ops.common import row_stats
    worst = 0.0
    for emit in (True, False):
        got, got_st = call(kernel, emit)
        want, _ = call(plain, emit)
        torch.cuda.synchronize()
        g, w, xr = got[rows], want[rows], x[rows]
        worst = max(worst, _compare(f"{label} out emit_stats={emit}", g, w,
                                    BF16_TOL, BF16_TOL))
        _branch(f"{label} branch emit_stats={emit}", g, w, xr)
        if emit:
            _compare(f"{label} stats vs stats of its out", got_st,
                     row_stats(got, EPS), STATS_RTOL, STATS_ATOL)
        elif got_st is not None:
            raise AssertionError(f"{label}: emit_stats=False returned stats")
    return worst


def phase_parity():
    """Kernels against their plain versions at small shapes: b8 covers a
    partial 128-row GEMM tile, the first two K1 cases the key mask, and
    the f32 plain version the bf16 band."""
    from vit_fpga_tpu_torch.ops import attn_block as ab
    from vit_fpga_tpu_torch.ops import fused_mlp as fm
    heads, n_valid = 12, 197
    x, st, p = _attn_inputs(8, 200, 768, seed=1)
    pb = _bf16_weights(p, ("wqkv", "wo"))
    print("parity K1 attn_block_stats (8, 200, 768), 12 heads, n_valid=197")
    # Loud padding: the padding rows' LayerNorm blown up ~30x, so their
    # keys reach the clip (exp(80)) against valid queries and any padding
    # key the kernel fails to mask swamps every valid row.  Padding query
    # rows are garbage by contract and stay out of the output checks.
    loud = st.clone()
    loud[:, n_valid:, 0] = 0.0
    loud[:, n_valid:, 1] = 30.0
    # Flat scores (q and k 10x smaller): every key weighs about the same,
    # so a key wrongly counted in the denominator moves the branch by
    # about 1/197.
    flat = dict(pb, wqkv=pb["wqkv"] * 0.1)
    for label, s, w, rows in (
            ("K1 loud padding", loud, pb, (slice(None), slice(0, n_valid))),
            ("K1 flat scores", st, flat, (...,)),
            ("K1", st, pb, (...,))):
        _parity(label, lambda fn, emit, s=s, w=w: _attn_call(
                    fn, x, s, w, heads, n_valid, emit),
                ab.attn_block_stats, ab.attn_block_stats_plain, x, rows)
    got, _ = _attn_call(ab.attn_block_stats, x, st, pb, heads, n_valid, True)
    want32, _ = _attn_call(ab.attn_block_stats_plain, x.float(), st, p,
                           heads, n_valid, True)
    _compare("K1 valid rows vs plain f32", got[:, :n_valid],
             want32[:, :n_valid], F32_BAND, F32_BAND)

    x, st, p = _mlp_inputs(1600, 768, 3072, seed=2)
    pb = _bf16_weights(p, ("w1", "w2"))
    print("parity K2 fused_mlp_stats (1600, 768) x 3072, gelu_tanh")
    _parity("K2", lambda fn, emit: _mlp_call(fn, x, st, pb, emit),
            fm.fused_mlp_stats, fm.fused_mlp_stats_plain, x)
    got, _ = _mlp_call(fm.fused_mlp_stats, x, st, pb, True)
    want32, _ = _mlp_call(fm.fused_mlp_stats_plain, x.float(), st, p, True)
    _compare("K2 rows vs plain f32", got, want32, F32_BAND, F32_BAND)


def _bound(flops, nbytes):
    t_ops = flops / H100_BF16_FLOPS * 1e3
    t_mem = nbytes / H100_HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_mem else (t_mem, "bytes")


def phase_path_shapes(batch=64, n_pad=200, n_valid=197, d=768, heads=12,
                      m=3072):
    """Each kernel at the serving shapes (ViT-B/16, batch 64): parity
    against its plain version on the same inputs, then times.  Returns
    {name: dict of max_abs_err and times}."""
    import torch.nn.functional as F
    from vit_fpga_tpu_torch.ops import attn_block as ab
    from vit_fpga_tpu_torch.ops import fused_mlp as fm
    from vit_fpga_tpu_torch.utils.timing import time_cuda
    out = {}
    rows, dh = batch * n_pad, d // heads

    x, st, p = _attn_inputs(batch, n_pad, d, seed=3)
    pb = _bf16_weights(p, ("wqkv", "wo"))
    print(f"parity K1 attn_block_stats ({batch}, {n_pad}, {d}) at the path's "
          f"shape")
    err = _parity(f"K1 b{batch}", lambda fn, emit: _attn_call(
        fn, x, st, pb, heads, n_valid, emit), ab.attn_block_stats,
        ab.attn_block_stats_plain, x)
    ms = time_cuda(lambda: _attn_call(ab.attn_block_stats, x, st, pb, heads,
                                      n_valid, True))
    plain_ms = time_cuda(lambda: _attn_call(ab.attn_block_stats_plain, x,
                                            st, pb, heads, n_valid, True),
                         iters=5, warmup=1)
    xn = torch.randn((rows, d), device="cuda").to(torch.bfloat16)
    x2 = x.reshape(rows, d)
    bq, bo = p["bqkv"].to(torch.bfloat16), p["bo"].to(torch.bfloat16)
    keep = (torch.arange(n_pad, device="cuda") < n_valid)[None, None, None]

    def library():
        qkv = torch.addmm(bq, xn, pb["wqkv"]).view(batch, n_pad, 3, heads,
                                                     dh)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        ao = F.scaled_dot_product_attention(q, k, v, attn_mask=keep)
        ao = ao.transpose(1, 2).reshape(rows, d)
        return torch.addmm(bo, ao, pb["wo"]) + x2

    lib_ms = time_cuda(library)
    flops = (2 * rows * d * 4 * d
             + 4 * batch * heads * n_pad * n_valid * dh)
    nbytes = (2 * rows * d * 2 + 2 * rows * 2 * 4
              + 4 * d * d * 2 + 6 * d * 4)
    bound_ms, bound_by = _bound(flops, nbytes)
    out["attn_block_stats"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                   library_ms=lib_ms, bound_ms=bound_ms,
                                   bound_by=bound_by)

    x, st, p = _mlp_inputs(rows, d, m, seed=4)
    pb = _bf16_weights(p, ("w1", "w2"))
    print(f"parity K2 fused_mlp_stats ({rows}, {d}) x {m} at the path's "
          f"shape")
    err = _parity(f"K2 b{batch}", lambda fn, emit: _mlp_call(fn, x, st, pb, emit),
                  fm.fused_mlp_stats, fm.fused_mlp_stats_plain, x)
    ms = time_cuda(lambda: _mlp_call(fm.fused_mlp_stats, x, st, pb, True))
    plain_ms = time_cuda(lambda: _mlp_call(fm.fused_mlp_stats_plain, x, st,
                                           pb, True), iters=5, warmup=1)
    xn = torch.randn((rows, d), device="cuda").to(torch.bfloat16)
    b1, b2 = p["b1"].to(torch.bfloat16), p["b2"].to(torch.bfloat16)

    def library():
        h = F.gelu(torch.addmm(b1, xn, pb["w1"]), approximate="tanh")
        return torch.addmm(b2, h, pb["w2"]) + x

    lib_ms = time_cuda(library)
    flops = 4 * rows * d * m
    nbytes = (2 * rows * d * 2 + 2 * rows * 2 * 4 + 2 * d * m * 2
              + (m + 3 * d) * 4)
    bound_ms, bound_by = _bound(flops, nbytes)
    out["fused_mlp_stats"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                  library_ms=lib_ms, bound_ms=bound_ms,
                                  bound_by=bound_by)
    for name, t in out.items():
        print(f"timing {name} b{batch}: kernel {t['ms']:.4f} ms, plain "
              f"{t['plain_ms']:.4f} ms, library {t['library_ms']:.4f} ms, "
              f"bound {t['bound_ms']:.4f} ms ({t['bound_by']})")
    return out


def phase_slice(n_images=160, batch=64):
    from vit_fpga_tpu_torch.models import vit
    from vit_fpga_tpu_torch.ops import attn_block as ab
    from vit_fpga_tpu_torch.ops import fused_mlp as fm
    from vit_fpga_tpu_torch.runtime.serving import ImageServer
    from vit_fpga_tpu_torch.utils.log import Metrics

    cfg = vit.config("vit_b16", dtype="bfloat16")
    params = vit.init_params(cfg, _gen(0), device="cuda")
    fwd = vit.make_forward(cfg, params, raw=True)
    images = np.random.default_rng(0).integers(
        0, 256, (n_images, cfg.image_size, cfg.image_size, 3), np.uint8)
    fwd(images[:batch])                 # first launch: library loads, cuBLAS
    torch.cuda.synchronize()
    Metrics.reset()
    ab.attn_block_stats.launches = 0
    fm.fused_mlp_stats.launches = 0
    t0 = time.perf_counter()
    with ImageServer(fwd, image_size=cfg.image_size,
                     batch_size=batch) as server:
        futs = [server.submit_raw(img) for img in images]
        results = [f.result(timeout=600) for f in futs]
        wall = time.perf_counter() - t0
        pct = server.latency_percentiles()
    launches = {"attn_block_stats": ab.attn_block_stats.launches,
                "fused_mlp_stats": fm.fused_mlp_stats.launches}
    print(f"slice: {len(results)}/{n_images} answered in {server.batches} "
          f"batches, {wall:.3f} s, {n_images / wall:.1f} img/s, "
          f"p50 {pct['p50']:.2f} ms, p99 {pct['p99']:.2f} ms")
    print(f"slice launches: {launches}")
    if len(results) != n_images or server.served != n_images:
        raise AssertionError("not every request was answered")
    for r in results:
        if r.shape != (cfg.num_classes,) or not np.isfinite(r).all():
            raise AssertionError(f"bad logits row: shape {r.shape}")
    for name, n in launches.items():
        if n != cfg.depth * server.batches:
            raise AssertionError(f"{name} launched {n} times for "
                                 f"{server.batches} batches")

    cpu_params = {k: ({kk: vv.cpu() for kk, vv in v.items()}
                      if isinstance(v, dict) else v.cpu())
                  for k, v in params.items()}
    cpu_fwd = vit.make_forward(cfg, cpu_params, raw=True, device="cpu")
    # first and last of each batch, the partial one included
    idx = [0, batch - 1, batch, 2 * batch - 1, 2 * batch, n_images - 1]
    ref = cpu_fwd(images[idx]).numpy()
    got = np.stack([results[i] for i in idx])
    rel = float(np.abs(got - ref).max() / np.abs(ref).max())
    print(f"slice logits of images {idx} vs CPU plain forward: "
          f"max_rel={rel:.3e} (band {LOGITS_BAND})")
    if not rel <= LOGITS_BAND:
        raise AssertionError("card logits disagree with the CPU forward")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    from vit_fpga_tpu_torch.ops import _kernels
    from vit_fpga_tpu_torch.utils.platform import require_hopper

    smi = _smi_line()
    print(smi)
    kind = require_hopper()
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    _kernels.load()
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"(nvcc {_kernels.build_seconds})")
    print(_kernels.build_log)

    phase_parity()
    timing = phase_path_shapes()
    launches = phase_slice()

    sources = {
        "attn_block_stats": ("vit_fpga_tpu_torch/csrc/attn_stats.cu",
                             "vit_fpga_tpu/ops/attn_block.py:550"),
        "fused_mlp_stats": ("vit_fpga_tpu_torch/csrc/mlp_stats.cu",
                            "vit_fpga_tpu/ops/fused_mlp.py:225"),
    }
    kernels = []
    for name, (src, replaces) in sources.items():
        t = timing[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
