"""The true-f32 GEMM of the f32 halves (``gemm_f32_kernel`` of
``csrc/gemm_f32.cuh``, which K26 in f32 launches bare), with its tile
forced either way and, optionally, the same entry point built from
another checkout (the parent commit, say), each timed in turns beside
``torch.matmul`` in f32 with TF32 off.

Run on a machine with a Hopper card, from the repository root:

    python3 experiments/torch_f32_gemm_variants.py [ROOT] [--only NAME ...]
        [--parent OTHER_ROOT] [--shapes vit|k26]

ROOT (default: this repository) holds the ``vit_fpga_tpu_torch`` package.
Each variant is a copy of ROOT's ``csrc/`` under ROOT's git-ignored
``_chip/f32_gemm_variants/<name>/`` with the text edits of ``VARIANTS``
below; its ``streamed_gemm.cu`` alone is compiled (with the package's nvcc
flags, all variants at once) into a library of its own, and
``vft_streamed_gemm`` is launched in f32 through ctypes (no prologue, a
plain store).  Variants:

* ``kernel``: the kernel as it stands (the tile chosen by the grid's fill:
  128 x 128 where those tiles give every SM a block, else 64 x 64);
* ``tile128`` / ``tile64``: the 128- (64-) wide tile at every shape;
* ``parent`` (with ``--parent``): OTHER_ROOT's ``csrc/`` as it is, for
  the same entry point as that checkout built it.

Shapes (M, K, N), ``vit``: K1's QKV (12800, 768, 2304), its
out-projection (12800, 768, 768), K3's W1 (12800, 768, 3072) and W2
(12800, 3072, 768), the f32 ViT-B/16 b64 forward's; ``k26``:
``chip_smoke.py``'s two f32 K26 cases, (64, 300, 128) and (256, 1024,
512).  Each line prints, per shape, the five CUDA-event estimates of 20
launches, in turns over the variants and then in reverse, TFLOP/s and the
max-abs difference from ``torch.matmul`` (whose time is printed beside),
then the card's name and power limit and one JSON line.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

H = "gemm_f32.cuh"
CHOICE = "const bool wide = wide_tiles >= sms;"
VARIANTS = {
    "kernel": [],
    "tile128": [(H, CHOICE, "const bool wide = wide_tiles > 0;")],
    "tile64": [(H, CHOICE, "const bool wide = wide_tiles < 0;")],
    "parent": [],
}
SHAPES = {
    "vit": {"K1 QKV": (12800, 768, 2304), "out-proj": (12800, 768, 768),
            "K3 W1": (12800, 768, 3072), "K3 W2": (12800, 3072, 768)},
    "k26": {"JAX test f32": (64, 300, 128), "f32": (256, 1024, 512)},
}


def build(root: Path, names, parent: Path | None = None):
    """Edited csrc copies, their streamed_gemm.cu compiled at once: {name:
    (library or None, nvcc's output)}; ``parent`` copies ``parent``'s
    csrc.  An edit that does not apply leaves the variant out."""
    from vit_fpga_tpu_torch.ops._kernels import NVCC_FLAGS, _nvcc
    out_root = root / "_chip" / "f32_gemm_variants"
    procs, built = {}, {}
    for name in names:
        d = out_root / name
        shutil.rmtree(d, ignore_errors=True)
        src_root = parent if name == "parent" else root
        shutil.copytree(src_root / "vit_fpga_tpu_torch" / "csrc", d / "csrc")
        skip = None
        for file, old, new in VARIANTS[name]:
            src = d / "csrc" / file
            text = src.read_text()
            if text.count(old) != 1:
                skip = f"{old!r} not found once in {file}"
                break
            src.write_text(text.replace(old, new))
        if skip:
            built[name] = (None, skip)
            continue
        cmd = [_nvcc(), *NVCC_FLAGS, "-shared", "-I", str(d / "csrc"),
               str(d / "csrc" / "streamed_gemm.cu"), "-o",
               str(d / "libgemm.so")]
        procs[name] = (d / "libgemm.so", subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        built[name] = (lib if proc.returncode == 0 else None, log)
    return built


def registers(log: str) -> str:
    """ptxas's registers and spills of every f32 GEMM instantiation."""
    lines, out = log.splitlines(), []
    for i, ln in enumerate(lines):
        if "Compiling entry function" in ln and "gemm_f32" in ln:
            out.append(ln.split("'")[1] + ": " + " ".join(
                x.split(":", 1)[-1].strip() for x in lines[i + 1:i + 5]
                if "Used" in x or "spill" in x))
    return "; ".join(out) or "no ptxas report"


def _estimates(run, n=5, iters=20):
    import torch
    ms = []
    for _ in range(n):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        for _ in range(3):
            run()
        a.record()
        for _ in range(iters):
            run()
        b.record()
        torch.cuda.synchronize()
        ms.append(a.elapsed_time(b) / iters)
    return ms


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("root", nargs="?",
                    default=str(Path(__file__).resolve().parent.parent))
    ap.add_argument("--only", nargs="+", choices=sorted(VARIANTS),
                    default=[v for v in VARIANTS if v != "parent"])
    ap.add_argument("--parent", help="another checkout's root: adds the "
                    "'parent' variant")
    ap.add_argument("--shapes", choices=sorted(SHAPES), default="vit")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    parent = Path(args.parent).resolve() if args.parent else None
    names = [n for n in args.only if n != "parent"]
    if parent is not None:
        names.append("parent")
    sys.path.insert(0, str(root))
    import torch
    if not torch.cuda.is_available():
        print("torch_f32_gemm_variants: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    built = build(root, names, parent)
    print(f"built {len(built)} variants in {time.perf_counter() - t0:.1f} s")
    P, I = ctypes.c_void_p, ctypes.c_int
    libs, ptxas = {}, {}
    for name, (lib_path, log) in built.items():
        if lib_path is None:
            print(f"{name}: not built: {log[-2000:]}")
            continue
        lib = ctypes.CDLL(str(lib_path))
        lib.vft_streamed_gemm_init.restype = I
        lib.vft_streamed_gemm.argtypes = [P] * 3 + [I] * 4 + [P]
        lib.vft_streamed_gemm.restype = I
        if lib.vft_streamed_gemm_init() != 0:
            raise RuntimeError(f"{name}: init failed")
        libs[name] = lib
        ptxas[name] = registers(log)
        print(f"{name}: {ptxas[name]}")
    g = torch.Generator()
    g.manual_seed(7)
    results = {name: {} for name in libs}
    results["torch.matmul"] = {}
    for label, (m, k, n) in SHAPES[args.shapes].items():
        x = torch.randn((m, k), generator=g).cuda()
        w = (torch.randn((k, n), generator=g) * k ** -0.5).cuda()
        want = x @ w
        out = torch.empty((m, n), device="cuda")
        stream = torch.cuda.current_stream().cuda_stream
        flops = 2 * m * k * n

        def runner(lib):
            def run():
                err = lib.vft_streamed_gemm(x.data_ptr(), w.data_ptr(),
                                            out.data_ptr(), m, k, n, 0,
                                            stream)
                if err:
                    raise RuntimeError(f"vft_streamed_gemm returned {err}")
            return run

        order = list(libs) + ["torch.matmul"]
        times = {name: [] for name in order}
        for name in order + order[::-1]:
            run = (runner(libs[name]) if name in libs
                   else (lambda: torch.matmul(x, w, out=out)))
            times[name] += _estimates(run)
        for name in order:
            if name in libs:
                runner(libs[name])()
            else:
                torch.matmul(x, w, out=out)
            torch.cuda.synchronize()
            diff = float((out - want).abs().max())
            best = min(times[name])
            results[name][label] = dict(ms=times[name], max_abs_diff=diff,
                                        tflops=flops / best / 1e9)
            print(f"{label} ({m}, {k}) x {n} {name}: "
                  + " / ".join(f"{t:.4f}" for t in times[name])
                  + f" ms, best {flops / best / 1e9:.1f} TFLOP/s, max "
                  f"|diff| {diff:.2e}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         stdout=subprocess.PIPE, text=True).stdout.strip()
    print(smi)
    print(json.dumps({"root": str(root), "parent": str(parent),
                      "shapes": args.shapes, "variants": results,
                      "ptxas": ptxas, "device": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
