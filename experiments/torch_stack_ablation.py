"""Ablations of the port's single-launch bf16 encoder (K11,
`vit_fpga_tpu_torch/csrc/vit_stack.cu`) on the card.

    python3 experiments/torch_stack_ablation.py [variant ...]
    python3 experiments/torch_stack_ablation.py --clock

Each variant is a copy of the package under the git-ignored `_chip/exp/`
with one or more textual edits to its CUDA sources; each copy builds
`vit_stack.cu` alone and prints, at b1 and b4 (ViT-B/16 width, depth 12,
seeded weights), the kernel's time (CUDA events) and its stage clock
(`ops/vit_stack.trace_report`: per stage wall, slowest block's work and
barrier, us per launch).  A variant whose edit does not match the
sources (written against an earlier version of the kernel) is reported
as skipped.  The variants break the kernel's results on purpose: they
time, they do not check.  `--clock` samples the card's SM clock and
power (`nvidia-smi`) while the unmodified kernel runs back to back.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORK = os.path.join(ROOT, "_chip", "exp")

# A grid barrier that polls its generation word with a short sleep, in
# place of cooperative groups' acquire-load spin.
_SOFT_BARRIER = """__device__ unsigned int st_bar_count;
__device__ unsigned int st_bar_gen;

__device__ __forceinline__ void grid_barrier() {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned int* gen = &st_bar_gen;
    const unsigned int my_gen = *gen;
    __threadfence();
    if (atomicAdd(&st_bar_count, 1u) == gridDim.x - 1) {
      atomicExch(&st_bar_count, 0u);
      __threadfence();
      atomicAdd(&st_bar_gen, 1u);
    } else {
      while (*gen == my_gen) __nanosleep(32);
    }
    __threadfence();
  }
  __syncthreads();
}

struct StageClock {"""

_ROW_LOOPS = ("    for (int r = blockIdx.x; r < rows; r += gridDim.x)\n"
              "      row_pass(p.tok, p.tok, w.part, {}")
VARIANTS = {
    "base": [],
    # written against the v1-v2 kernels (wmma tiles, warp-per-row passes)
    "one_block_per_sm": [("stack.cuh", "dev_blocks[dev] = occ * sms;",
                          "dev_blocks[dev] = sms;")],
    "no_attention": [("vit_stack.cu", "attn_stage(w.qkv",
                      "if (0) attn_stage(w.qkv")],
    "no_mma": [("stack.cuh", "wmma::mma_sync(acc[j], af, bfr, acc[j]);",
                "")],
    "no_prefetch": [("stack.cuh",
                     'asm volatile("prefetch.global.L2 [%0];" ::"l"'
                     '(c + i * 128));', "(void)c;")],
    "empty_row_stages": [
        ("vit_stack.cu", _ROW_LOOPS.format("so"),
         _ROW_LOOPS.format("so").replace("r < rows", "r < 0")),
        ("vit_stack.cu", _ROW_LOOPS.format("s2"),
         _ROW_LOOPS.format("s2").replace("r < rows", "r < 0"))],
    "no_tile_loads": [("stack.cuh",
                       "    if (next < nk) load(next % ST_STAGES, next);\n",
                       ""),
                      ("stack.cuh", "    if (s < nk) load(s, s);\n", "")],
    "soft_barrier": [("stack.cuh", "struct StageClock {", _SOFT_BARRIER),
                     ("stack.cuh", "    work_done(kind);\n    grid.sync();",
                      "    work_done(kind);\n    grid_barrier();")],
    "noinline_rows_attn": [
        ("vit_stack.cu", "__device__ void row_pass(",
         "__device__ __noinline__ void row_pass("),
        ("stack.cuh", "__device__ void attn_item(",
         "__device__ __noinline__ void attn_item(")],
    "launch_bounds_1": [("vit_stack.cu",
                         "__launch_bounds__(SK_THREADS, 2) stack_kernel",
                         "__launch_bounds__(SK_THREADS, 1) stack_kernel")],
}

CHILD = r'''
import json, sys, torch
sys.path.insert(0, sys.argv[1])
from vit_fpga_tpu_torch.ops import _kernels
_kernels.SOURCES = ("vit_stack.cu",)
_kernels._SIGNATURES = {k: v for k, v in _kernels._SIGNATURES.items()
                        if (k.startswith("vft_vit_stack") and "int8" not in k)
                        or k == "vft_vit_layers"}
_kernels._INITS = ("vft_vit_stack_init",)
from vit_fpga_tpu_torch.ops import vit_stack as vs
from vit_fpga_tpu_torch.utils.timing import time_cuda
g = torch.Generator(); g.manual_seed(0)
d, m, L = 768, 3072, 12
def r(*s, std=0.02, mean=0.0):
    return (torch.randn(s, generator=g) * std + mean).cuda()
bl = dict(ln1_scale=r(L, d, std=0.1, mean=1.0), ln1_bias=r(L, d),
          wqkv=r(L, d, 3 * d).bfloat16(), bqkv=r(L, 3 * d),
          wo=r(L, d, d).bfloat16(), bo=r(L, d),
          ln2_scale=r(L, d, std=0.1, mean=1.0), ln2_bias=r(L, d),
          w1=r(L, d, m).bfloat16(), b1=r(L, m), w2=r(L, m, d).bfloat16(),
          b2=r(L, d))
out = {}
for b in (1, 4):
    x = torch.randn((b, 200, d), generator=g).bfloat16().cuda()
    ms = time_cuda(lambda: vs.vit_layers(x, bl, 12, n_valid=197), iters=50,
                   warmup=5)
    tr = vs.new_trace(x.device)
    for _ in range(5):
        vs.vit_layers(x, bl, 12, n_valid=197, trace=tr)
    torch.cuda.synchronize()
    rep = vs.trace_report(tr, vs.K11_STAGES, 5)
    out[b] = dict(ms=ms, blocks=rep["blocks"], stages={
        k: (round(v["wall"], 1), round(v["busy_max"], 1),
            round(v["barrier"], 1))
        for k, v in rep.items() if isinstance(v, dict)})
print(json.dumps(out))
'''

CLOCK = r'''
import subprocess, sys, time, torch
sys.path.insert(0, sys.argv[1])
from vit_fpga_tpu_torch.ops import vit_stack as vs
g = torch.Generator(); g.manual_seed(0)
d, m, L = 768, 3072, 12
def r(*s, std=0.02, mean=0.0):
    return (torch.randn(s, generator=g) * std + mean).cuda()
bl = dict(ln1_scale=r(L, d, std=0.1, mean=1.0), ln1_bias=r(L, d),
          wqkv=r(L, d, 3 * d).bfloat16(), bqkv=r(L, 3 * d),
          wo=r(L, d, d).bfloat16(), bo=r(L, d),
          ln2_scale=r(L, d, std=0.1, mean=1.0), ln2_bias=r(L, d),
          w1=r(L, d, m).bfloat16(), b1=r(L, m), w2=r(L, m, d).bfloat16(),
          b2=r(L, d))
x = torch.randn((1, 200, d), generator=g).bfloat16().cuda()
vs.vit_layers(x, bl, 12, n_valid=197)
torch.cuda.synchronize()
mon = subprocess.Popen(
    ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,clocks.mem,"
     "power.draw,temperature.gpu,clocks_throttle_reasons.active",
     "--format=csv,noheader", "-lms", "200"],
    stdout=subprocess.PIPE, text=True)
t0, n = time.time(), 0
while time.time() - t0 < 4:
    for _ in range(50):
        vs.vit_layers(x, bl, 12, n_valid=197)
    torch.cuda.synchronize()
    n += 50
dt = time.time() - t0
mon.terminate()
print(f"{n} launches, {dt / n * 1e3:.4f} ms each (host clock)")
print(mon.communicate()[0])
'''


def _copy(name, edits):
    """The package with ``edits`` applied, or None if one does not
    match the sources."""
    dst = os.path.join(WORK, name)
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, "vit_fpga_tpu_torch"),
                    os.path.join(dst, "vit_fpga_tpu_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    for fname, old, new in edits:
        path = os.path.join(dst, "vit_fpga_tpu_torch", "csrc", fname)
        with open(path) as f:
            src = f.read()
        if old not in src:
            return None
        with open(path, "w") as f:
            f.write(src.replace(old, new))
    return dst


def main(argv) -> int:
    if "--clock" in argv:
        return subprocess.run([sys.executable, "-c", CLOCK, ROOT]).returncode
    names = argv or list(VARIANTS)
    for name in names:
        dst = _copy(name, VARIANTS[name])
        if dst is None:
            print(f"== {name}: skipped (its edit does not match this tree)")
            continue
        res = subprocess.run([sys.executable, "-c", CHILD, dst],
                             capture_output=True, text=True)
        print(f"== {name} rc={res.returncode}")
        print(res.stdout.strip())
        if res.returncode:
            print(res.stderr[-2000:])
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
