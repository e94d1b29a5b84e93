"""The GEMM steps of K1 and K2 one at a time, on seeded inputs, with the SM
clock each step runs at.

Run on a machine with a Hopper card, from the repository root:

    python3 experiments/torch_gemm_steps.py [ROOT] [--no-epilogue]

ROOT (default: this repository) holds the ``vit_fpga_tpu_torch`` package to
time.  The package ships no entry point for one GEMM alone, so the script
copies it under ROOT's git-ignored ``_chip/`` (``gemm_steps/``, or
``gemm_no_epilogue/``) and appends one, ``vft_gemm_step``, to the copy's
``csrc/mlp_stats.cu``: ``launch_gemm_wgmma`` of ``csrc/gemm_wgmma.cuh`` as
the halves call it.  ``--no-epilogue`` also drops the copy's epilogue, so
that its GEMM writes nothing: the main loop alone (TMA ring, LN prologue,
wgmma).

For each step of ViT-B/16 and CLIP ViT-L/14 at batch 64 (K2's LN + W1 +
act and W2 + residual, K1's LN + QKV and out-projection + residual; W1
with each activation) it prints the CUDA-event time of 20 launches, the
TFLOP/s, and the SM clock and power draw that ``nvidia-smi`` reads, one
query after another, while the step is launched for two seconds (the
clock's least and median, the power's median; the last read, which may
end after the launches, is dropped), with the bf16
tensor-core rate at the median (132 SMs x 4096 flop a clock: 989 TFLOP/s
is the data sheet's 1830 MHz); then the card's name, power limit and
maximum SM clock, and one JSON line.
"""

from __future__ import annotations

import argparse
import json
import shutil
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

# The epilogue call of gemm_wgmma.cuh's consumers, which --no-epilogue drops.
EPILOGUE = "      switch (p.act) {"

# The entry point appended to the copy's mlp_stats.cu.
ENTRY = r'''
extern "C" int vft_gemm_step(const void* a, const void* stats, const void* ls,
                             const void* lb, const void* b, const void* bias,
                             const void* residual, void* c, int m, int n, int k,
                             int act, void* stream) {
  if (tma_encoder() == nullptr) return cudaErrorInitializationError;
  GwArgs p{};
  p.stats = static_cast<const float*>(stats);
  p.ln_scale = static_cast<const float*>(ls);
  p.ln_bias = static_cast<const float*>(lb);
  p.bias = static_cast<const float*>(bias);
  p.residual = static_cast<const bf16*>(residual);
  p.C = static_cast<bf16*>(c);
  p.M = m;
  p.N = n;
  p.K = k;
  p.act = act;
  return launch_gemm_wgmma(static_cast<const bf16*>(a), static_cast<const bf16*>(b),
                           stats != nullptr, p, reinterpret_cast<cudaStream_t>(stream));
}
'''

# (label, M, N, K, LN prologue, act code, residual); act codes as
# ops/fused_mlp.py _ACT_CODES (0 none, 1 gelu, 2 gelu_tanh, 3 quick_gelu)
STEPS = (
    ("ViT-B K2 W1 gelu", 12800, 3072, 768, True, 1, False),
    ("ViT-B K2 W1 gelu_tanh", 12800, 3072, 768, True, 2, False),
    ("ViT-B K2 W1 no act", 12800, 3072, 768, True, 0, False),
    ("ViT-B K2 W2", 12800, 768, 3072, False, 0, True),
    ("ViT-B K1 QKV", 12800, 2304, 768, True, 0, False),
    ("ViT-B K1 out-proj", 12800, 768, 768, False, 0, True),
    ("CLIP-L K2 W1 quick_gelu", 16896, 4096, 1024, True, 3, False),
    ("CLIP-L K2 W2", 16896, 1024, 4096, False, 0, True),
    ("CLIP-L K1 QKV", 16896, 3072, 1024, True, 0, False),
    ("CLIP-L K1 out-proj", 16896, 1024, 1024, False, 0, True),
)
FLOP_PER_CLOCK = 132 * 4096  # bf16 dense, H100 SXM


def _num(text: str) -> float:
    try:
        return float(text)
    except ValueError:  # "[N/A]"
        return float("nan")


def _smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                           "--format=csv,noheader,nounits"], check=True,
                          stdout=subprocess.PIPE, text=True).stdout.strip()


def _copy(root: Path, no_epilogue: bool) -> Path:
    copy = root / "_chip" / ("gemm_no_epilogue" if no_epilogue else "gemm_steps")
    # over an earlier copy, whose _build/ a later run reuses
    shutil.copytree(root / "vit_fpga_tpu_torch", copy / "vit_fpga_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"),
                    dirs_exist_ok=True)
    csrc = copy / "vit_fpga_tpu_torch" / "csrc"
    with open(csrc / "mlp_stats.cu", "a") as f:
        f.write(ENTRY)
    if no_epilogue:
        src = csrc / "gemm_wgmma.cuh"
        text = src.read_text()
        i = text.index(EPILOGUE)
        j = text.index("      }\n", i) + len("      }\n")
        src.write_text(text[:i] + "      (void)row0;\n" + text[j:])
    return copy


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("root", nargs="?",
                    default=str(Path(__file__).resolve().parent.parent))
    ap.add_argument("--no-epilogue", action="store_true")
    args = ap.parse_args()
    root = _copy(Path(args.root).resolve(), args.no_epilogue)
    sys.path.insert(0, str(root))
    import ctypes

    import torch
    from vit_fpga_tpu_torch.ops import _kernels
    from vit_fpga_tpu_torch.ops.common import row_stats
    from vit_fpga_tpu_torch.utils.timing import time_cuda
    if not torch.cuda.is_available():
        print("torch_gemm_steps: no CUDA device", file=sys.stderr)
        return 1
    lib, stream = _kernels.launch_target()
    step = lib.vft_gemm_step
    step.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    step.restype = ctypes.c_int
    g = torch.Generator()
    g.manual_seed(20)

    def randn(*shape, std=1.0, mean=0.0):
        return (torch.randn(shape, generator=g) * std + mean).cuda()

    rows = []
    for label, m, n, k, ln, act, residual in STEPS:
        a = randn(m, k).to(torch.bfloat16)
        st = row_stats(a, 1e-6)
        ls, lb = randn(k, std=0.1, mean=1.0), randn(k, std=0.1)
        w = randn(k, n, std=k ** -0.5).to(torch.bfloat16)
        bias = randn(n, std=0.02)
        res = randn(m, n).to(torch.bfloat16) if residual else None
        c = torch.empty(m, n, dtype=torch.bfloat16, device="cuda")

        def run():
            err = step(a.data_ptr(), st.data_ptr() if ln else None,
                       ls.data_ptr() if ln else None,
                       lb.data_ptr() if ln else None, w.data_ptr(),
                       bias.data_ptr(), None if res is None else res.data_ptr(),
                       c.data_ptr(), m, n, k, act, stream)
            _kernels.check(err, "vft_gemm_step")

        ms = time_cuda(run, iters=20, warmup=3)

        # The clock under this step: nvidia-smi queried on a side thread
        # while this one launches the step for two seconds.
        reads: list[list[float]] = []
        stop = threading.Event()

        def sample():
            while not stop.is_set():
                reads.append([_num(v) for v in
                              _smi("clocks.sm,power.draw").split(",")])
        for _ in range(20):
            run()
        sampler = threading.Thread(target=sample)
        sampler.start()
        t_end = time.perf_counter() + 2.0
        while time.perf_counter() < t_end:
            for _ in range(20):
                run()
            torch.cuda.synchronize()
        stop.set()
        sampler.join()
        reads = reads[:-1] or reads or [[float("nan")] * 2]
        mhz = [r[0] for r in reads]
        mid = statistics.median(mhz)
        watts = statistics.median(r[1] for r in reads)
        row = {"step": label, "shape": [m, n, k], "ms": ms,
               "tflops": 2 * m * n * k / ms / 1e9, "sm_mhz": mhz,
               "power_w_median": watts,
               "peak_tflops_at_median": FLOP_PER_CLOCK * mid / 1e6}
        rows.append(row)
        print(f"{label} ({m}, {k}) x {n}: {ms:.4f} ms "
              f"({row['tflops']:.0f} TFLOP/s); SM clock {min(mhz):.0f} / "
              f"{mid:.0f} MHz, {watts:.0f} W over {len(mhz)} reads (peak "
              f"{row['peak_tflops_at_median']:.0f})", flush=True)
    card = _smi("name,power.limit,clocks.max.sm")
    print(card)
    print(json.dumps({"device": card, "no_epilogue": args.no_epilogue,
                      "steps": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
