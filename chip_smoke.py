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
  5. train kernels  K4, K5, K23 and K24 against their plain versions at
              b8 and at the training path's b64 shapes: K4 in both softmax
              modes, K5 and K24 with each activation, all seven outputs
              of each backward; a loud-padding case (huge padding rows,
              zero cotangent there) must leave every weight gradient
              unchanged; then each kernel's time, its plain version's,
              a library yardstick's and the bound at b64
  6. slice    ImageServer over make_forward(vit_b16, bf16) answers 160
              uint8 requests (2 full batches of 64 + 1 partial flush);
              logits of images from every batch are checked against
              the CPU forward, and K1 and K2 must have run 12 times per
              served batch
  7. safe     make_forward(vit_b16, bf16, safe_softmax) at b8 (the
              per-block K4 / K5 path) against the CPU forward
  8. train    one SGD step of vit_b16 bf16 at batch 4 on the card against
              the CPU plain path (loss, every gradient, every updated
              parameter); 10 Trainer (AdamW) steps on one fixed batch of
              64 (finite losses, the last below the first; 12 launches
              each of K4, K5, K23 and K24 per step and none of K1, K2);
              the b64 SGD step's time, TFLOP/s and peak memory
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
# f32 weight, bias and LN gradients, kernel vs plain, in relative norm:
# sums over up to 12 800 rows in another order, of products that carry
# the bf16 ulp flips above.
GRAD_RTOL = 1e-2
# Weight gradients with loud padding rows vs quiet ones: padding keys are
# masked and padding rows get a zero cotangent, so every term they add is
# an exact zero; "unchanged" at f32 resolution.
LOUD_RTOL = 1e-6
# One training step of the bf16 model, card vs CPU, relative to each
# quantity's norm: the ulp flips of LOGITS_BAND through a forward and a
# backward twice as long.
STEP_LOSS_BAND = 1e-2
STEP_BAND = 0.1
TRAIN_LR = 3e-4          # the Trainer's (and the JAX Trainer's) default


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


def _compare(name, got, want, rtol, atol, mag=None):
    """max abs / max relative error; raise if |a-b| > atol + rtol * mag,
    where mag is |b| unless given."""
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    ref = w.abs() if mag is None else mag
    bad = int((diff > atol + rtol * ref).sum())
    max_abs = float(diff.max())
    max_rel = max_abs / max(float(w.abs().max()), 1e-30)
    what = "|b|" if mag is None else "(|b| + |g|)"
    print(f"  {name}: max_abs={max_abs:.3e} max_rel={max_rel:.3e} "
          f"(tol |a-b| <= {atol:g} + {rtol:g}{what}, violations={bad})")
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


def _relnorm(name, got, want, tol):
    """||a - b|| / ||b||; raise if above ``tol`` or not finite."""
    g, w = got.float(), want.float()
    rel = float((g - w).norm() / w.norm().clamp_min(1e-30))
    print(f"  {name}: |a-b|/|b| = {rel:.3e} (tol {tol:g})")
    if not rel <= tol or not torch.isfinite(g).all():
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version")
    return rel


ATTN_GRADS = ("dx", "dls", "dlb", "dwqkv", "dbqkv", "dwo", "dbo")
MLP_GRADS = ("dx", "dls", "dlb", "dw1", "db1", "dw2", "db2")
MLP_ACTS = ("gelu_tanh", "quick_gelu", "relu")


def _grads_parity(label, names, got, want, g, step_act=False):
    """dx elementwise and its branch dx - g in relative norm, the f32
    gradients in relative norm; returns dx's max-abs error.

    dx = bf16(g + dx_ln) adds the LayerNorm backward to the cotangent g,
    so an error of dx_ln scales with the terms, not with their sum: where
    they cancel, |dx| is small and the elementwise band is taken relative
    to |b| + |g|.  With ``step_act`` (relu) dx is held in relative norm
    only: relu' is a step, and where h lies within f32 rounding of 0 the
    kernel and the plain version (summing in another order) take
    different sides, which moves a whole row of dx by da_j * W1[:, j] (a
    handful of rows at b8, each far outside the elementwise band)."""
    torch.cuda.synchronize()
    gf = g.float()
    if step_act:
        _relnorm(f"{label} dx", got[0], want[0], GRAD_RTOL)
        err = float((got[0].float() - want[0].float()).abs().max())
    else:
        err = _compare(f"{label} dx", got[0], want[0], BF16_TOL, BF16_TOL,
                       mag=want[0].float().abs() + gf.abs())
    _relnorm(f"{label} dx branch (dx - g)", got[0].float() - gf,
             want[0].float() - gf, GRAD_RTOL)
    for n, a, b in zip(names[1:], got[1:], want[1:]):
        _relnorm(f"{label} {n}", a, b, GRAD_RTOL)
    return err


def _train_inputs(batch, n_pad, n_valid, d, m, seed, loud=False):
    """Inputs of both halves at one shape: x (batch, n_pad, d) bf16 and a
    cotangent g (zero on the padding rows when ``loud``, whose x rows
    then carry a huge spike)."""
    x, _, pa = _attn_inputs(batch, n_pad, d, seed)
    _, _, pm = _mlp_inputs(8, d, m, seed + 1)
    g = _randn(_gen(seed + 2), batch, n_pad, d).to(torch.bfloat16)
    if loud:
        x = x.clone()
        x[:, n_valid:, 3] = 3e3
        g[:, n_valid:] = 0.0
    return x, g, pa, pm


def _k4(fn, x, pa, heads, n_valid, safe):
    return fn(x, pa["ln_scale"], pa["ln_bias"], pa["wqkv"], pa["bqkv"],
              pa["wo"], pa["bo"], heads, eps=EPS, n_valid=n_valid,
              safe_softmax=safe)


def _k23(fn, x, g, pa, heads, n_valid):
    return fn(x, pa["ln_scale"], pa["ln_bias"], pa["wqkv"], pa["bqkv"],
              pa["wo"], g, heads, eps=EPS, n_valid=n_valid)


def _k5(fn, x2, pm, act):
    return fn(x2, pm["ln_scale"], pm["ln_bias"], pm["w1"], pm["b1"],
              pm["w2"], pm["b2"], eps=EPS, act=act)


def _k24(fn, x2, g2, pm, act):
    return fn(x2, pm["ln_scale"], pm["ln_bias"], pm["w1"], pm["b1"],
              pm["w2"], g2, eps=EPS, act=act)


def phase_train_kernels(batch, n_pad=200, n_valid=197, d=768, heads=12,
                        m=3072, loud=False):
    """K4, K5, K23 and K24 against their plain versions at one shape.
    Returns {kernel name: largest max-abs error of its bf16 output}."""
    from vit_fpga_tpu_torch.ops import attn_block as ab
    from vit_fpga_tpu_torch.ops import fused_mlp as fm
    x, g, pa, pm = _train_inputs(batch, n_pad, n_valid, d, m, seed=5 + batch)
    rows = batch * n_pad
    x2, g2 = x.reshape(rows, d), g.reshape(rows, d)
    worst = {"attn_block_fwd": 0.0, "attn_block_bwd": 0.0,
             "fused_mlp_fwd": 0.0, "fused_mlp_bwd": 0.0}
    print(f"parity K4 / K23 attn_block ({batch}, {n_pad}, {d}), {heads} "
          f"heads, n_valid={n_valid}")
    for safe in (True, False):
        got = _k4(ab.attn_block_fwd, x, pa, heads, n_valid, safe)
        want = _k4(ab.attn_block_fwd_plain, x, pa, heads, n_valid, safe)
        torch.cuda.synchronize()
        label = f"K4 b{batch} safe_softmax={safe}"
        worst["attn_block_fwd"] = max(worst["attn_block_fwd"], _compare(
            f"{label} out", got, want, BF16_TOL, BF16_TOL))
        _branch(f"{label} branch", got, want, x)
    worst["attn_block_bwd"] = _grads_parity(
        f"K23 b{batch}", ATTN_GRADS,
        _k23(ab.attn_block_bwd, x, g, pa, heads, n_valid),
        _k23(ab.attn_block_bwd_plain, x, g, pa, heads, n_valid), g)
    print(f"parity K5 / K24 fused_mlp ({rows}, {d}) x {m}")
    for act in MLP_ACTS:
        got = _k5(fm.fused_mlp_fwd, x2, pm, act)
        want = _k5(fm.fused_mlp_xla, x2, pm, act)
        torch.cuda.synchronize()
        label = f"K5 b{batch} {act}"
        worst["fused_mlp_fwd"] = max(worst["fused_mlp_fwd"], _compare(
            f"{label} out", got, want, BF16_TOL, BF16_TOL))
        _branch(f"{label} branch", got, want, x2)
        worst["fused_mlp_bwd"] = max(worst["fused_mlp_bwd"], _grads_parity(
            f"K24 b{batch} {act}", MLP_GRADS,
            _k24(fm.fused_mlp_bwd, x2, g2, pm, act),
            _k24(fm.fused_mlp_bwd_plain, x2, g2, pm, act), g2,
            step_act=act == "relu"))
    return worst


def phase_loud_padding(batch=8, n_pad=200, n_valid=197, d=768, heads=12,
                       m=3072):
    """Huge spikes in x's rows at or past n_valid and a zero cotangent
    there: K23 and K24 against their plain versions on those inputs, and
    every weight, bias and LN gradient (and dx on the valid rows) against
    the kernel's own on quiet padding rows."""
    from vit_fpga_tpu_torch.ops import attn_block as ab
    from vit_fpga_tpu_torch.ops import fused_mlp as fm
    runs = []
    for loud in (False, True):
        x, g, pa, pm = _train_inputs(batch, n_pad, n_valid, d, m, seed=40,
                                     loud=loud)
        if not loud:       # quiet: the same cotangent, zero on padding rows
            g[:, n_valid:] = 0.0
        rows = batch * n_pad
        runs.append((x, g, pa, pm, rows))
    print(f"loud padding: spikes of 3e3 in rows {n_valid}..{n_pad - 1}, "
          f"zero cotangent there, b{batch}")
    (xq, gq, pa, pm, rows), (xl, gl, _, _, _) = runs
    quiet = _k23(ab.attn_block_bwd, xq, gq, pa, heads, n_valid)
    loud = _k23(ab.attn_block_bwd, xl, gl, pa, heads, n_valid)
    _grads_parity("K23 loud padding", ATTN_GRADS, loud,
                  _k23(ab.attn_block_bwd_plain, xl, gl, pa, heads, n_valid),
                  gl)
    for n, a, b in zip(ATTN_GRADS[1:], loud[1:], quiet[1:]):
        _relnorm(f"K23 loud vs quiet {n}", a, b, LOUD_RTOL)
    _relnorm("K23 loud vs quiet dx (valid rows)", loud[0][:, :n_valid],
             quiet[0][:, :n_valid], LOUD_RTOL)
    for act in MLP_ACTS:
        q2 = _k24(fm.fused_mlp_bwd, xq.reshape(rows, d), gq.reshape(rows, d),
                  pm, act)
        l2 = _k24(fm.fused_mlp_bwd, xl.reshape(rows, d), gl.reshape(rows, d),
                  pm, act)
        _grads_parity(f"K24 loud padding {act}", MLP_GRADS, l2, _k24(
            fm.fused_mlp_bwd_plain, xl.reshape(rows, d), gl.reshape(rows, d),
            pm, act), gl.reshape(rows, d), step_act=act == "relu")
        for n, a, b in zip(MLP_GRADS[1:], l2[1:], q2[1:]):
            _relnorm(f"K24 {act} loud vs quiet {n}", a, b, LOUD_RTOL)


def phase_train_timing(batch=64, n_pad=200, n_valid=197, d=768, heads=12,
                       m=3072):
    """Times at the training path's b64 shapes: each kernel, its plain
    version, a library yardstick (LN + addmm + SDPA + addmm, LN + addmm +
    tanh-GELU + addmm, and the autograd backward of each) and the bound.
    Returns {name: dict of times}."""
    import torch.nn.functional as F
    from vit_fpga_tpu_torch.ops import attn_block as ab
    from vit_fpga_tpu_torch.ops import fused_mlp as fm
    from vit_fpga_tpu_torch.utils.timing import time_cuda
    x, g, pa, pm = _train_inputs(batch, n_pad, n_valid, d, m, seed=60)
    rows, dh, act = batch * n_pad, d // heads, "gelu_tanh"
    x2, g2 = x.reshape(rows, d), g.reshape(rows, d)
    bf = torch.bfloat16
    keep = (torch.arange(n_pad, device="cuda") < n_valid)[None, None, None]

    def leaves(p, names):
        return [p[k].to(bf).detach().requires_grad_(True) for k in names]

    a_leaves = [x.detach().requires_grad_(True)] + leaves(
        pa, ("ln_scale", "ln_bias", "wqkv", "bqkv", "wo", "bo"))
    m_leaves = [x2.detach().requires_grad_(True)] + leaves(
        pm, ("ln_scale", "ln_bias", "w1", "b1", "w2", "b2"))

    def lib_attn(xx, ls, lb, wqkv, bqkv, wo, bo):
        h = F.layer_norm(xx, (d,), ls, lb, EPS).reshape(rows, d)
        qkv = torch.addmm(bqkv, h, wqkv).view(batch, n_pad, 3, heads, dh)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        ao = F.scaled_dot_product_attention(q, k, v, attn_mask=keep)
        ao = ao.transpose(1, 2).reshape(rows, d)
        return (torch.addmm(bo, ao, wo) + xx.reshape(rows, d)).view_as(xx)

    def lib_mlp(xx, ls, lb, w1, b1, w2, b2):
        h = F.layer_norm(xx, (d,), ls, lb, EPS)
        h = F.gelu(torch.addmm(b1, h, w1), approximate="tanh")
        return torch.addmm(b2, h, w2) + xx

    with torch.enable_grad():
        a_out = lib_attn(*a_leaves)
        m_out = lib_mlp(*m_leaves)
    attn_proj = 8 * rows * d * d
    score = 4 * batch * heads * n_pad * n_valid * dh
    act_bytes = rows * d * 2                 # one (rows, d) bf16 tensor
    cases = {
        "attn_block_fwd": (
            lambda: _k4(ab.attn_block_fwd, x, pa, heads, n_valid, True),
            lambda: _k4(ab.attn_block_fwd_plain, x, pa, heads, n_valid, True),
            lambda: lib_attn(*a_leaves),
            attn_proj + score, 2 * act_bytes + 4 * d * d * 2 + 7 * d * 4),
        "fused_mlp_fwd": (
            lambda: _k5(fm.fused_mlp_fwd, x2, pm, act),
            lambda: _k5(fm.fused_mlp_xla, x2, pm, act),
            lambda: lib_mlp(*m_leaves),
            4 * rows * d * m, 2 * act_bytes + 2 * d * m * 2 + (m + 3 * d) * 4),
        "attn_block_bwd": (
            lambda: _k23(ab.attn_block_bwd, x, g, pa, heads, n_valid),
            lambda: _k23(ab.attn_block_bwd_plain, x, g, pa, heads, n_valid),
            lambda: torch.autograd.grad(a_out, a_leaves, g,
                                        retain_graph=True),
            22 * rows * d * d + 3 * score,
            3 * act_bytes + 4 * d * d * (2 + 4) + (5 + 6) * d * 4),
        "fused_mlp_bwd": (
            lambda: _k24(fm.fused_mlp_bwd, x2, g2, pm, act),
            lambda: _k24(fm.fused_mlp_bwd_plain, x2, g2, pm, act),
            lambda: torch.autograd.grad(m_out, m_leaves, g2,
                                        retain_graph=True),
            10 * rows * d * m,
            3 * act_bytes + 2 * d * m * (2 + 4) + (2 * m + 4 * d) * 4),
    }
    out = {}
    for name, (kern, plain, lib, flops, nbytes) in cases.items():
        ms = time_cuda(kern)
        plain_ms = time_cuda(plain, iters=5, warmup=1)
        lib_ms = time_cuda(lib)
        bound_ms, bound_by = _bound(flops, nbytes)
        out[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=bound_ms, bound_by=bound_by)
        print(f"timing {name} b{batch}: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, library {lib_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}, {flops / 1e9:.1f} GFLOP, "
              f"{nbytes / 1e6:.1f} MB)")
    return out


def _tree_to(tree, device):
    """A copy of a parameter tree on ``device``."""
    return {k: (_tree_to(v, device) if isinstance(v, dict)
                else v.detach().to(device, copy=True))
            for k, v in tree.items()}


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

    cpu_fwd = vit.make_forward(cfg, _tree_to(params, "cpu"), raw=True,
                               device="cpu")
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


def phase_safe_forward(batch=8):
    """make_forward(safe_softmax) on the card (K4 / K5 per block) against
    the CPU forward."""
    import dataclasses
    from vit_fpga_tpu_torch.models import vit
    cfg = dataclasses.replace(vit.config("vit_b16", dtype="bfloat16"),
                              safe_softmax=True)
    params = vit.init_params(cfg, _gen(1), device="cpu")
    images = np.random.default_rng(1).integers(
        0, 256, (batch, cfg.image_size, cfg.image_size, 3), np.uint8)
    got = vit.make_forward(cfg, _tree_to(params, "cuda"))(images)
    got = got.cpu().numpy()
    want = vit.make_forward(cfg, params, device="cpu")(images).numpy()
    rel = float(np.abs(got - want).max() / np.abs(want).max())
    print(f"safe_softmax forward b{batch} vs CPU: max_rel={rel:.3e} "
          f"(band {LOGITS_BAND})")
    if not rel <= LOGITS_BAND or not np.isfinite(got).all():
        raise AssertionError("safe_softmax logits disagree with the CPU")


def _train_batch(cfg, batch, seed):
    from vit_fpga_tpu_torch.models import vit
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (batch, cfg.image_size, cfg.image_size, 3),
                          np.uint8)
    labels = rng.integers(0, cfg.num_classes, batch)
    return (vit.preprocess(torch.from_numpy(images), cfg).float(),
            torch.from_numpy(labels))


def phase_train_step_vs_cpu(batch=4, lr=0.1):
    """One SGD step of vit_b16 bf16 at ``batch`` on the card and on the
    CPU plain path from the same weights and data: the loss, every
    gradient and every updated parameter."""
    from vit_fpga_tpu_torch.models import vit
    from vit_fpga_tpu_torch.train import trainer as tr
    cfg = vit.config("vit_b16", dtype="bfloat16")
    base = vit.init_params(cfg, _gen(2), device="cpu")
    images, labels = _train_batch(cfg, batch, seed=2)
    step = tr.make_vit_train_step(cfg)
    res = {}
    for dev in ("cuda", "cpu"):
        params, opt = tr.init_train_state(cfg, tr.sgd(lr),
                                          params=_tree_to(base, dev))
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, images.to(dev), labels.to(dev))
        loss = float(m["loss"])
        leaves = tr.param_leaves(params)
        res[dev] = (loss, [p.grad.detach().float().cpu() for p in leaves],
                    [p.detach().float().cpu() for p in leaves])
        print(f"train step b{batch} on {dev}: loss {loss:.6f} "
              f"({time.perf_counter() - t0:.1f} s)")
    (lc, gc, pc), (lh, gh, ph) = res["cuda"], res["cpu"]
    rel = abs(lc - lh) / abs(lh)
    print(f"  loss card vs CPU: rel {rel:.3e} (band {STEP_LOSS_BAND})")
    if not rel <= STEP_LOSS_BAND:
        raise AssertionError("card loss disagrees with the CPU step")
    names = _leaf_names(base)
    worst = 0.0
    for n, a, b in zip(names, gc, gh):
        worst = max(worst, _relnorm(f"grad {n}", a, b, STEP_BAND))
    for n, a, b in zip(names, pc, ph):
        _relnorm(f"param after step {n}", a, b, STEP_BAND)
    print(f"  worst gradient error {worst:.3e}")


def _leaf_names(tree, prefix=""):
    out = []
    for k in sorted(tree):
        v = tree[k]
        out.extend(_leaf_names(v, f"{prefix}{k}.") if isinstance(v, dict)
                   else [prefix + k])
    return out


TRAIN_KERNELS = ("attn_block_fwd", "fused_mlp_fwd", "attn_block_bwd",
                 "fused_mlp_bwd")


def _counters():
    from vit_fpga_tpu_torch.ops import attn_block as ab
    from vit_fpga_tpu_torch.ops import fused_mlp as fm
    return {"attn_block_stats": ab.attn_block_stats,
            "fused_mlp_stats": fm.fused_mlp_stats,
            "attn_block_fwd": ab.attn_block_fwd,
            "fused_mlp_fwd": fm.fused_mlp_fwd,
            "attn_block_bwd": ab.attn_block_bwd,
            "fused_mlp_bwd": fm.fused_mlp_bwd}


def phase_train_fit(batch=64, steps=10):
    """The training path: Trainer (AdamW, lr TRAIN_LR) for ``steps`` steps
    on one fixed batch.  Every loss finite, the last below the first; 12
    launches of each training kernel per step and none of K1 / K2.
    Returns the launch counts of the run."""
    from vit_fpga_tpu_torch.models import vit
    from vit_fpga_tpu_torch.train import trainer as tr
    cfg = vit.config("vit_b16", dtype="bfloat16")
    trainer = tr.Trainer(cfg, learning_rate=TRAIN_LR,
                         params=vit.init_params(cfg, _gen(3), device="cuda"))
    images, labels = _train_batch(cfg, batch, seed=3)
    images, labels = images.cuda(), labels.cuda()
    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    hist = trainer.fit([(images, labels)] * steps)
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    losses = [h["loss"] for h in hist]
    print(f"train fit: {steps} AdamW steps (lr {TRAIN_LR}) on one batch of "
          f"{batch}, {wall:.2f} s; losses "
          + " ".join(f"{v:.4f}" for v in losses))
    print(f"train launches: {launches}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError("training loss did not fall over the steps")
    for name, n in launches.items():
        want = cfg.depth * steps if name in TRAIN_KERNELS else 0
        if n != want:
            raise AssertionError(f"{name} launched {n} times in {steps} "
                                 f"steps, want {want}")
    return launches


def phase_train_step_time(batch=64, lr=1e-4, iters=5):
    """ms per SGD step at bench.py's train shape (b64, sgd(1e-4)), CUDA
    events after warm-up; TFLOP/s with bench.py's 3 x forward count; the
    step's peak device memory."""
    from vit_fpga_tpu_torch.models import vit
    from vit_fpga_tpu_torch.train import trainer as tr
    from vit_fpga_tpu_torch.utils.timing import time_cuda
    cfg = vit.config("vit_b16", dtype="bfloat16")
    params, opt = tr.init_train_state(
        cfg, tr.sgd(lr), params=vit.init_params(cfg, _gen(4), device="cuda"))
    images, _ = _train_batch(cfg, batch, seed=4)
    images = images.cuda()
    labels = torch.zeros((batch,), dtype=torch.int64, device="cuda")
    step = tr.make_vit_train_step(cfg)
    step(params, opt, images, labels)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = time_cuda(lambda: step(params, opt, images, labels), iters=iters,
                   warmup=2)
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    tflops = 3 * vit.flops_per_image(cfg) * batch / (ms * 1e-3) / 1e12
    print(f"train step b{batch} sgd({lr}): {ms:.3f} ms/step, "
          f"{tflops:.1f} TFLOP/s (3 x forward), peak {peak:.0f} MiB")
    return dict(ms=ms, tflops=tflops, peak_mib=peak)


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
    errors = {}
    for batch in (8, 64):
        for name, err in phase_train_kernels(batch).items():
            errors[name] = max(errors.get(name, 0.0), err)
    phase_loud_padding()
    train_timing = phase_train_timing()
    for name, t in train_timing.items():
        timing[name] = dict(t, max_abs_err=errors[name])
    launches = phase_slice()
    phase_safe_forward()
    phase_train_step_vs_cpu()
    launches.update({k: v for k, v in phase_train_fit().items()
                     if k in TRAIN_KERNELS})
    phase_train_step_time()

    sources = {
        "attn_block_stats": ("vit_fpga_tpu_torch/csrc/attn_stats.cu",
                             "vit_fpga_tpu/ops/attn_block.py:550"),
        "fused_mlp_stats": ("vit_fpga_tpu_torch/csrc/mlp_stats.cu",
                            "vit_fpga_tpu/ops/fused_mlp.py:225"),
        "attn_block_fwd": ("vit_fpga_tpu_torch/csrc/attn_block.cu",
                           "vit_fpga_tpu/ops/attn_block.py:371"),
        "fused_mlp_fwd": ("vit_fpga_tpu_torch/csrc/mlp.cu",
                          "vit_fpga_tpu/ops/fused_mlp.py:52"),
        "attn_block_bwd": ("vit_fpga_tpu_torch/csrc/attn_bwd.cu",
                           "vit_fpga_tpu/ops/attn_block.py:734"),
        "fused_mlp_bwd": ("vit_fpga_tpu_torch/csrc/mlp_bwd.cu",
                          "vit_fpga_tpu/ops/fused_mlp.py:578"),
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
