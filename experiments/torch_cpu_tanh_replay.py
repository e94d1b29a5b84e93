"""Replays, in fresh processes, the port's f32 plain MLP forward at the
inputs of ``tests/test_torch_fused_mlp_train.py::
test_fused_mlp_fwd_plain_matches_pallas[f32-gelu_tanh]`` and holds each
stage against float64 of its own f32 input, to find the op behind that
test's rare failure.  CPU only; imports torch and numpy (no JAX).

    python3 experiments/torch_cpu_tanh_replay.py [--procs 6] [--rounds 40]
        [--tanh torch|plain]

Each round starts ``--procs`` processes at once (the load of a parallel
test run); each process computes, on its first call of every op,
LN -> xn @ W1 + b1 -> the fma-form tanh-GELU -> @ W2 + b2 -> + x, with the
activation's ops one by one (``--tanh torch``: ``torch.tanh``; ``plain``:
the port's ``utils.platform.tanh_plain``), and prints one line: "ok", or
"FAIL" with each stage's max |d| and rows off, and each activation op
recomputed a second time.  The parent process then prints the count of
each.
``--vml`` instead prints the max |d| of MKL VML's vmsTanh (reached in
libtorch_cpu through ctypes) on the same data in its three accuracy modes
beside torch.tanh's.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
B, N, D, M = 2, 40, 64, 128        # the test's T = 80 rows, D 64, M 128
A, BB = 0.7978845608028654, 0.035677408136300125


def inputs(np, seed=0):
    """The test's ``_inputs(seed)`` (numpy, same draws)."""
    rng = np.random.default_rng(seed)

    def f(*shape, sc=0.1):
        return (rng.normal(size=shape) * sc).astype(np.float32)

    x = f(B, N, D, sc=0.5)
    f(B, N, D, sc=1.0)             # the test's cotangent, drawn in order
    return dict(x=x.reshape(B * N, D), ls=1.0 + f(D), lb=f(D),
                w1=f(D, M, sc=D ** -0.5), b1=f(M), w2=f(M, D, sc=M ** -0.5),
                b2=f(D))


def replay(tanh_kind: str) -> None:
    import numpy as np
    import torch
    sys.path.insert(0, str(ROOT))
    from vit_fpga_tpu_torch.utils.platform import tanh_plain
    tanh = torch.tanh if tanh_kind == "torch" else tanh_plain
    p = inputs(np)
    f = {k: torch.from_numpy(v) for k, v in p.items()}
    x = f["x"]
    mu = x.mean(-1, keepdim=True)
    var = x.var(-1, unbiased=False, keepdim=True)
    xn = (x - mu) * torch.rsqrt(var + 1e-6) * f["ls"] + f["lb"]
    h1 = xn @ f["w1"]
    hb = h1 + f["b1"]
    h2 = hb * hb
    u = hb * (A + BB * h2)
    hh = 0.5 * hb
    t = tanh(u)
    a = hh + hh * t
    y = a @ f["w2"]
    out = x + (y + f["b2"])
    g = {k: v.astype(np.float64) for k, v in p.items()}
    x64 = g["x"]
    m64 = x64.mean(-1, keepdims=True)
    v64 = ((x64 - m64) ** 2).mean(-1, keepdims=True)
    d64 = lambda v: v.double().numpy()
    stages = (
        ("xn", xn, (x64 - m64) / np.sqrt(v64 + 1e-6) * g["ls"] + g["lb"]),
        ("xn@W1", h1, d64(xn) @ g["w1"]),
        ("tanh", t, np.tanh(d64(u))),
        ("act", a, 0.5 * d64(hb) * (1.0 + np.tanh(d64(hb) * (
            A + BB * d64(hb) ** 2)))),
        ("a@W2", y, d64(a) @ g["w2"]),
        ("out", out, None))   # the whole function in float64
    hid = d64(xn) @ g["w1"] + g["b1"]
    exact_out = x64 + (0.5 * hid * (1.0 + np.tanh(hid * (A + BB * hid ** 2)))
                       @ g["w2"] + g["b2"])
    lines, bad = [], False
    for name, got, want in stages:
        want = exact_out if want is None else want
        d = np.abs(d64(got) - want)
        rows = sorted(set(np.nonzero(d > 1e-5 * (1 + np.abs(want)))[0]))
        bad |= bool(rows)
        lines.append(f"{name} {d.max():.3e} rows {[int(r) for r in rows][:4]}"
                     f"{'..' if len(rows) > 4 else ''} ({len(rows)})")
    again = np.abs(d64(t) - d64(tanh(u))).max()
    print(("FAIL " if bad else "ok ") + " | ".join(lines)
          + f" | the same tanh again: max |d| to the first {again:.3e}",
          flush=True)


def vml() -> None:
    import numpy as np
    import torch
    lib = ctypes.CDLL(str(Path(torch.__file__).parent / "lib"
                          / "libtorch_cpu.so"))
    u = torch.from_numpy((np.random.default_rng(0).normal(size=(B * N, M))
                          * 0.8).astype(np.float32))
    want = np.tanh(u.double().numpy())
    print(f"torch.tanh: max |d| {np.abs(torch.tanh(u).double().numpy() - want).max():.3e}")
    for name, mode in (("HA", 2), ("LA", 1), ("EP", 3)):
        out = torch.empty_like(u)
        lib.vmsTanh(ctypes.c_longlong(u.numel()), ctypes.c_void_p(u.data_ptr()),
                    ctypes.c_void_p(out.data_ptr()), ctypes.c_ulonglong(mode))
        print(f"vmsTanh VML_{name}: max |d| "
              f"{np.abs(out.double().numpy() - want).max():.3e}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--procs", type=int, default=6)
    ap.add_argument("--rounds", type=int, default=40)
    ap.add_argument("--tanh", choices=("torch", "plain"), default="torch")
    ap.add_argument("--vml", action="store_true")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.vml:
        vml()
        return 0
    if args.child:
        replay(args.tanh)
        return 0
    counts = {"ok": 0, "FAIL": 0}
    cmd = [sys.executable, __file__, "--child", "--tanh", args.tanh]
    for _ in range(args.rounds):
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True,
                                  env=dict(os.environ))
                 for _ in range(args.procs)]
        for proc in procs:
            line = proc.communicate()[0].strip()
            counts[line.split(" ", 1)[0]] = counts.get(
                line.split(" ", 1)[0], 0) + 1
            if not line.startswith("ok"):
                print(line, flush=True)
    print(f"tanh={args.tanh}: {counts['ok']} ok, {counts['FAIL']} FAIL in "
          f"{args.rounds} rounds of {args.procs} fresh processes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
