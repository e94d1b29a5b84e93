"""K7's f32 kernel (``seq_attn_f32_kernel`` of ``csrc/seq_attn.cuh``) and
edited copies of it, each timed at the per-tensor int8 forward's packed
(64, 197, 2304) f32 qkv, to see where its time goes.

Run on a machine with a Hopper card, from the repository root:

    python3 experiments/torch_f32_attn_variants.py [ROOT] [--only NAME ...]

ROOT (default: this repository) holds the ``vit_fpga_tpu_torch`` package.
Each variant is a copy of ROOT's ``csrc/`` under ROOT's git-ignored
``_chip/f32_variants/<name>/`` with the text edits of ``VARIANTS`` below;
its ``mha.cu`` alone is compiled (with the package's nvcc flags, all
variants at once) into a library of its own and ``vft_mha`` is launched
through ctypes on the packed tensor's head views, as ``mha_qkv_pallas``
launches it.  Variants:

* ``kernel``: the kernel as it stands;
* ``no_qk``: no q k^T for full key tiles (the scores of a full tile are
  set, not computed);
* ``no_pv``: no e v;
* ``no_qk_pv``: neither: the softmax, the tile copies, the barriers, the
  first touch of q, k, v and the stores of o;
* ``no_qk_pv_softmax``: as ``no_qk_pv`` without the shuffles and
  exponentials of the softmax;
* ``no_qk_pv_copies``: as ``no_qk_pv`` without the copies of tiles past the
  first;
* ``copies_only``: neither products, softmax nor later copies;
* ``registers_only``: the products on operands read once a tile (every q,
  k, e and v read from shared memory hoisted out of its loop: the fma
  stream alone);
* ``fast_exp``: ``__expf`` for ``expf``;
* ``kt32``: 32-key tiles (an 8 x 4 score micro-tile), two blocks an SM;
* ``two_warps``: 64 query rows a block (3 blocks an SM).

The variants that drop work compute a wrong output on purpose; each line
prints the max-abs difference from the plain version beside the five
CUDA-event estimates of 20 launches, then the card's name and power limit
and one JSON line.
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

F = "seq_attn.cuh"
NO_QK = [(F, "sf_scores_upto<SF_KJ>((nk + 7) >> 3, s, qw, ks);",
          "if (nk < SF_KT) sf_scores_upto<SF_KJ>((nk + 7) >> 3, s, qw, ks); "
          "else for (int i = 0; i < 8; ++i) for (int j = 0; j < SF_KJ; ++j) "
          "s[i][j] = 0.01f * (i + j + kg);")]
NO_PV = [(F, "const int kend = (nk + 3) & ~3;", "const int kend = 0;")]
NO_QK_ALL = [(F, "sf_scores_upto<SF_KJ>((nk + 7) >> 3, s, qw, ks);",
              "for (int i = 0; i < 8; ++i) for (int j = 0; j < SF_KJ; ++j) "
              "s[i][j] = 0.01f * (i + j + kg);")]
NO_SOFTMAX = [
    (F, "for (int o = 1; o < 8; o <<= 1) mt = fmaxf(mt, "
        "__shfl_xor_sync(0xffffffffu, mt, o));", ""),
    (F, "const float alpha = expf(m[i] - mn);", "const float alpha = 0.5f;"),
    (F, "const float e = expf(s[i][j] - mn);", "const float e = s[i][j] - mn;")]
NO_COPIES = [
    (F, "if (t + 1 < ntiles) load(Ks, SF_KLD, kp, t + 1);",
     "if (false) load(Ks, SF_KLD, kp, t + 1);"),
    (F, "if (t + 1 < ntiles) load(Vs, SF_VLD, vp, t + 1);",
     "if (false) load(Vs, SF_VLD, vp, t + 1);")]
REGISTERS = [
    (F, "q[i] = *reinterpret_cast<const float4*>(qw + 4 * i * SF_KLD + d);",
     "q[i] = *reinterpret_cast<const float4*>(qw + 4 * i * SF_KLD);"),
    (F, "const float4 k = *reinterpret_cast<const float4*>(ks + 8 * j * SF_KLD + d);",
     "const float4 k = *reinterpret_cast<const float4*>(ks + 8 * j * SF_KLD);"),
    (F, "e[i] = *reinterpret_cast<const float4*>(pw + 4 * i * SF_PLD + j);",
     "e[i] = *reinterpret_cast<const float4*>(pw + 4 * i * SF_PLD);"),
    (F, "Vs + (j + u) * SF_VLD + 4 * kg);", "Vs + u * SF_VLD + 4 * kg);"),
    (F, "Vs + (j + u) * SF_VLD + 32 + 4 * kg);", "Vs + u * SF_VLD + 32 + 4 * kg);")]
VARIANTS = {
    "kernel": [],
    "no_qk": NO_QK,
    "no_pv": NO_PV,
    "no_qk_pv": NO_QK_ALL + NO_PV,
    "no_qk_pv_softmax": NO_QK_ALL + NO_PV + NO_SOFTMAX,
    "no_qk_pv_copies": NO_QK_ALL + NO_PV + NO_COPIES,
    "copies_only": NO_QK_ALL + NO_PV + NO_SOFTMAX + NO_COPIES,
    "registers_only": REGISTERS,
    "fast_exp": [(F, "const float alpha = expf(m[i] - mn);",
                  "const float alpha = __expf(m[i] - mn);"),
                 (F, "const float e = expf(", "const float e = __expf(")],
    "kt32": [(F, "constexpr int SF_KT = 64; ", "constexpr int SF_KT = 32; ")],
    "two_warps": [(F, "constexpr int SF_WARPS = 4;", "constexpr int SF_WARPS = 2;"),
                  (F, "constexpr int SF_MIN_BLOCKS = 2; ",
                   "constexpr int SF_MIN_BLOCKS = 3; ")],
}


def build(root: Path, names):
    """Edited csrc copies, their mha.cu compiled at once: {name: (library
    or None, nvcc's output)}."""
    from vit_fpga_tpu_torch.ops._kernels import NVCC_FLAGS, _nvcc
    out_root = root / "_chip" / "f32_variants"
    procs = {}
    for name in names:
        d = out_root / name
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(root / "vit_fpga_tpu_torch" / "csrc", d / "csrc")
        for file, old, new in VARIANTS[name]:
            src = d / "csrc" / file
            text = src.read_text()
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: {old!r} not found once in {file}")
            src.write_text(text.replace(old, new))
        cmd = [_nvcc(), *NVCC_FLAGS, "-shared", "-I", str(d / "csrc"),
               str(d / "csrc" / "mha.cu"), "-o", str(d / "libmha.so")]
        procs[name] = (d / "libmha.so", subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        built[name] = (lib if proc.returncode == 0 else None, log)
    return built


def registers(log: str) -> str:
    lines = log.splitlines()
    for i, ln in enumerate(lines):
        if "Compiling entry function" in ln and "seq_attn_f32" in ln:
            return " ".join(x.split(":", 1)[-1].strip() for x in lines[i + 1:i + 4]
                            if "Used" in x or "spill" in x)
    return "no ptxas report"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("root", nargs="?",
                    default=str(Path(__file__).resolve().parent.parent))
    ap.add_argument("--only", nargs="+", choices=sorted(VARIANTS),
                    default=list(VARIANTS))
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch
    from vit_fpga_tpu_torch.ops import attention as at
    if not torch.cuda.is_available():
        print("torch_f32_attn_variants: no CUDA device", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    built = build(root, args.only)
    print(f"built {len(built)} variants in {time.perf_counter() - t0:.1f} s")

    g = torch.Generator()
    g.manual_seed(5)
    qkv = torch.randn((64, 197, 2304), generator=g).cuda()
    want = at.mha_qkv_pallas_plain(qkv, 12)
    q, k, v = at._heads(qkv, 12)
    out = torch.empty((64, 197, 768), device="cuda")
    o = out.view(64, 197, 12, 64).transpose(1, 2)
    P, L, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    results = {}
    for name, (lib_path, log) in built.items():
        if lib_path is None:
            print(f"{name}: nvcc failed\n{log[-2000:]}")
            continue
        lib = ctypes.CDLL(str(lib_path))
        lib.vft_mha_init.restype = I
        lib.vft_mha.argtypes = [P] * 4 + [L, L, I, L, L, I] + [I] * 5 + [
            ctypes.c_float, P]
        lib.vft_mha.restype = I
        if lib.vft_mha_init() != 0:
            raise RuntimeError(f"{name}: vft_mha_init failed")
        stream = torch.cuda.current_stream().cuda_stream

        def run():
            err = lib.vft_mha(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                              o.data_ptr(), *q.stride()[:3], *o.stride()[:3],
                              64, 12, 197, 197, 1, 0.125, stream)
            if err:
                raise RuntimeError(f"{name}: vft_mha returned {err}")

        run()
        torch.cuda.synchronize()
        diff = float((out - want).abs().max())
        ms = []
        for _ in range(5):
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            for _ in range(5):
                run()
            a.record()
            for _ in range(20):
                run()
            b.record()
            torch.cuda.synchronize()
            ms.append(a.elapsed_time(b) / 20)
        results[name] = dict(ms=ms, max_abs_diff=diff, ptxas=registers(log))
        print(f"{name}: " + " / ".join(f"{t:.4f}" for t in ms)
              + f" ms, max |diff| {diff:.2e}; {results[name]['ptxas']}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         stdout=subprocess.PIPE, text=True).stdout.strip()
    print(smi)
    print(json.dumps({"root": str(root), "variants": results, "device": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
