"""K25 (the 3x3 frame filter, ``csrc/image_filter.cu``) variants side by
side on one card: each built alone from its source into a small shared
library, held bit for bit against ``filter_image_numpy``, its SASS
summarised, and timed in turns.

Run on a machine with a Hopper card, from the repository root:

    python3 experiments/torch_k25_ab.py [--parent FILE] [--rows 2 4 8]
        [--extra LABEL=FILE ...] [--calls 20] [--estimates 3]

Variants: ``rowsR`` for each R of ``--rows``, this tree's
``csrc/image_filter.cu`` with its strip height (``ROWS``) set to R;
``parent``, the source at ``--parent`` (e.g. the parent commit's file
unpacked under the git-ignored ``_chip/``); and each ``--extra`` source.
Every source must export ``vft_image_filter`` with the port's C
signature.  Each is built with the port's nvcc flags (``ops/_kernels.py``)
into ``_chip/k25/<label>/``; ``cuobjdump -sass`` of each goes to
``chiprun_out/k25_sass_<label>.txt`` with a count of its loads, stores,
shared-memory traffic, shuffles and multiply-highs (a divide by a
constant) printed.  Parity: all
four filters at 1080 x 1920, 2160 x 3840, 1081 x 1920, 1080 x 1921, 33 x
45, 17 x 16, 1 x 4096, 4096 x 1, 1 x 1 and 1080 x 1920 at storage offset
1, bit for bit against the numpy oracle.  Timing: the sharpen filter at
1080 x 1920 and 2160 x 3840, each variant device alone (torch.profiler's
kernel time over ``--calls`` back-to-back launches into one output,
``--estimates`` estimates) and per call (CUDA events over 50 launches
through ctypes), in turns: the variants in order, then in reverse.  A
variant whose C entry refuses a frame (cudaErrorInvalidValue, as the TMA
variant does where W % 16 != 0) skips it in the parity.  Prints each
figure beside the card's name and power limit and one JSON line.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

ROWS_TEXT = "constexpr int ROWS = 2;"
PARITY_SHAPES = ((1080, 1920), (2160, 3840), (1081, 1920), (1080, 1921),
                 (33, 45), (17, 16), (1, 4096), (4096, 1), (1, 1))
TIMED_SHAPES = ((1080, 1920), (2160, 3840))
# SASS opcodes counted in each variant (regex on the opcode field)
SASS_COUNTS = {
    "LDG 16 B": r"LDG\.E\.128", "LDG 1 B": r"LDG\.E\.U8",
    "STG 16 B": r"STG\.E\.(EF\.)?128", "STG 1 B": r"STG\.E\.(EF\.)?U8",
    "LDS": r"\bLDS", "STS": r"\bSTS", "BAR": r"\bBAR\b", "SHFL": r"SHFL",
    "I2F": r"\bI2F", "F2I": r"\bF2I", "IMAD.HI": r"IMAD\.HI",
    "FFMA": r"\bFFMA\b",
}


def build(label: str, src: Path, edits) -> Path:
    """``src`` with ``edits`` (text, replacement) made, built alone into a
    shared library under ``_chip/k25/<label>/``."""
    from vit_fpga_tpu_torch.ops import _kernels
    out = ROOT / "_chip" / "k25" / label
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    text = src.read_text()
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"{src}: {old!r} not found once")
        text = text.replace(old, new)
    cu = out / "image_filter.cu"
    cu.write_text(text)
    lib = out / "libk25.so"
    cmd = [_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-I", str(_kernels.CSRC),
           "-shared", "-o", str(lib), str(cu)]
    res = subprocess.run(cmd, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for {label}:\n{res.stdout}")
    for line in res.stdout.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  {label} ptxas: {line.strip()}")
    return lib


def sass_summary(label: str, lib: Path) -> dict:
    """Opcode counts of ``lib``'s SASS (whole file); the listing goes to
    chiprun_out/."""
    from vit_fpga_tpu_torch.ops import _kernels
    tool = Path(_kernels._nvcc()).with_name("cuobjdump")
    if not tool.exists():
        print(f"  {label}: no cuobjdump beside nvcc; SASS not read")
        return {}
    res = subprocess.run([str(tool), "-sass", str(lib)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
    dump = ROOT / "chiprun_out" / f"k25_sass_{label}.txt"
    dump.parent.mkdir(exist_ok=True)
    dump.write_text(res.stdout)
    ops = [m.group(1) for m in re.finditer(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
                                           res.stdout)]
    counts = {name: sum(1 for op in ops if re.match(pat, op))
              for name, pat in SASS_COUNTS.items()}
    counts["instructions"] = len(ops)
    print(f"  {label} SASS ({dump.name}): "
          + ", ".join(f"{k} {v}" for k, v in counts.items()))
    return counts


class Refused(Exception):
    """A variant's C entry refused a frame (cudaErrorInvalidValue)."""


class Variant:
    def __init__(self, label: str, lib: Path):
        self.label = label
        self.fn = ctypes.CDLL(str(lib)).vft_image_filter
        self.fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                            ctypes.POINTER(ctypes.c_float), ctypes.c_int,
                            ctypes.c_int, ctypes.c_void_p]
        self.fn.restype = ctypes.c_int

    def __call__(self, img, out, name):
        import torch
        from vit_fpga_tpu_torch.ops.image_filter import FILTERS
        taps = (ctypes.c_float * 9)(*FILTERS[name].reshape(-1).tolist())
        h, w = img.shape
        err = self.fn(img.data_ptr(), out.data_ptr(), taps, h, w,
                      torch.cuda.current_stream().cuda_stream)
        if err == 1:
            raise Refused
        if err:
            raise RuntimeError(f"{self.label}: CUDA error {err}")
        return out


def parity(v: Variant) -> None:
    import numpy as np
    import torch
    from vit_fpga_tpu_torch.ops.image_filter import FILTERS, filter_image_numpy
    rng = np.random.default_rng(25)
    cases = [(h, w, 0) for h, w in PARITY_SHAPES] + [(1080, 1920, 1)]
    refused = 0
    for h, w, offset in cases:
        img = rng.integers(0, 256, (h, w), np.uint8)
        buf = torch.empty(h * w + offset, dtype=torch.uint8, device="cuda")
        dev = buf[offset:].view(h, w)
        dev.copy_(torch.from_numpy(img))
        for name in sorted(FILTERS):
            out = torch.empty((h, w), dtype=torch.uint8, device="cuda")
            try:
                got = v(dev, out, name).cpu().numpy()
            except Refused:
                refused += 1
                continue
            if not np.array_equal(got, filter_image_numpy(img, name)):
                bad = int((got != filter_image_numpy(img, name)).sum())
                raise AssertionError(f"{v.label} {name} at {h}x{w} offset "
                                     f"{offset}: {bad} pixels differ")
    print(f"  {v.label}: all four filters bit for bit with "
          f"filter_image_numpy at {len(cases)} frames ({refused} frame and "
          f"filter pairs refused)")


def device_ms(fn, calls: int) -> float:
    """Mean device ms of the filter kernel's launches over ``calls``
    back-to-back calls of ``fn`` (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.key_averages() if "filter_kernel" in e.key]
    count = sum(e.count for e in evs)
    if count < calls // 2:
        raise RuntimeError(f"the profiler saw {count} of {calls} launches")
    return sum(e.device_time_total for e in evs) / count / 1e3


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path)
    ap.add_argument("--rows", type=int, nargs="*", default=[2, 4, 8])
    ap.add_argument("--extra", nargs="*", default=[],
                    metavar="LABEL=FILE")
    ap.add_argument("--calls", type=int, default=20)
    ap.add_argument("--estimates", type=int, default=3)
    args = ap.parse_args()
    import numpy as np
    import torch
    from vit_fpga_tpu_torch.utils.timing import time_cuda
    if not torch.cuda.is_available():
        print("torch_k25_ab: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         stdout=subprocess.PIPE, text=True).stdout.strip()
    print(smi)
    src = ROOT / "vit_fpga_tpu_torch" / "csrc" / "image_filter.cu"
    plan = []
    if args.parent:
        plan.append(("parent", args.parent, ()))
    plan += [(f"rows{r}", src, ((ROWS_TEXT, f"constexpr int ROWS = {r};"),))
             for r in args.rows]
    for item in args.extra:
        label, path = item.split("=", 1)
        plan.append((label, Path(path), ()))
    variants, sass = [], {}
    for label, path, edits in plan:
        lib = build(label, path, edits)
        sass[label] = sass_summary(label, lib)
        variants.append(Variant(label, lib))
    for v in variants:
        parity(v)
    ms = {}
    rng = np.random.default_rng(26)
    for h, w in TIMED_SHAPES:
        img = torch.from_numpy(rng.integers(0, 256, (h, w), np.uint8)).cuda()
        out = torch.empty_like(img)
        for v in variants + variants[::-1]:
            def run(v=v):
                return v(img, out, "sharpen")
            dev = [device_ms(run, args.calls) for _ in range(args.estimates)]
            call = time_cuda(run, iters=50)
            ms.setdefault(f"{v.label} {h}x{w} device alone", []).extend(dev)
            ms.setdefault(f"{v.label} {h}x{w} per call", []).append(call)
            gbs = 2 * h * w / min(dev) / 1e6
            print(f"{v.label} {h}x{w} sharpen: device alone "
                  + " / ".join(f"{t:.4f}" for t in dev)
                  + f" ms ({gbs:.0f} GB/s at the best), per call {call:.4f} "
                  f"ms on {smi}")
    print(json.dumps({"device": smi, "ms": ms, "sass": sass}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
