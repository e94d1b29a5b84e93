"""Where the streaming ring's time goes on the card, at the reference's
geometry (1080 x 1920 uint8 frames, depth 24), and the device time of the
dense backend's two kernels (K25, K13) against their time per call.

Run on a machine with a Hopper card, from the repository root:

    python3 experiments/torch_ring_breakdown.py

Prints, per frame: the host time of ``StreamingRing.try_submit`` and
``try_retrieve`` (the ring of ``NetCUDA``, full depth and depth 1, each
frame taken back and dropped), the host copies the first ring design
made (2 MB into a pinned buffer, 2 MB out of it), and the device time of
the three stages on the side stream (H2D copy, K25, D2H copy, CUDA
events), and frames/s of the ring's steps done inline against the first
ring design's (pinned slot buffers, copies in and out) and an H2D copy
from the pageable frame with the copy out kept; then each
kernel's device time (torch.profiler) beside its time
per call back to back (CUDA events, which include the wrapper's host
time when that is longer).
"""

from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from vit_fpga_tpu_torch.backends.cuda import NetCUDA  # noqa: E402
from vit_fpga_tpu_torch.defines import random_net  # noqa: E402
from vit_fpga_tpu_torch.ops import image_filter as imf  # noqa: E402
from vit_fpga_tpu_torch.ops import quant  # noqa: E402
from vit_fpga_tpu_torch.ops.quant_fused import kmajor  # noqa: E402
from vit_fpga_tpu_torch.utils.timing import time_cuda  # noqa: E402

H, W, DEPTH, N = 1080, 1920, 24, 96


def ring_split(frames, depth):
    """Mean host ms per frame of try_submit and try_retrieve, and frames/s,
    over N frames in bursts of ``depth`` (after one warm-up burst)."""
    ring = NetCUDA(random_net(4, [2]), ring_depth=depth,
                   image_filter="sharpen")._ring
    for rep in range(2):
        sub = ret = 0.0
        t0 = time.perf_counter()
        for b in range(0, N if rep else depth, depth):
            for i in range(b, b + depth):
                t = time.perf_counter()
                ring.try_submit(frames[i % len(frames)], i)
                sub += time.perf_counter() - t
            for i in range(b, b + depth):
                t = time.perf_counter()
                _, meta = ring.try_retrieve()
                ret += time.perf_counter() - t
                assert meta == i
        wall = time.perf_counter() - t0
    return sub / N * 1e3, ret / N * 1e3, N / wall


def variants(frames, depth):
    """frames/s of three shapes of the ring's steps, done inline on a side
    stream with one event a frame: the first ring design (the frame copied
    into a pinned slot buffer, the result copied out of a pinned slot
    buffer), the H2D copy straight from the pageable frame with the copy
    out kept, and StreamingRing's own (pageable H2D, a new pinned output
    buffer handed to the caller)."""
    side = torch.cuda.Stream()
    slots = [(torch.empty((H, W), dtype=torch.uint8, pin_memory=True),
              torch.empty((H, W), dtype=torch.uint8, pin_memory=True))
             for _ in range(depth)]
    out = {}
    for name in ("pinned slots", "pageable H2D", "as StreamingRing"):
        for rep in range(2):
            t0 = time.perf_counter()
            for b in range(0, N if rep else depth, depth):
                pending = []
                for i in range(b, b + depth):
                    host_in, host_out = slots[i % depth]
                    frame = frames[i % len(frames)]
                    if name == "pinned slots":
                        host_in.numpy()[...] = frame
                        src = host_in
                    else:
                        src = torch.from_numpy(frame)
                    if name == "as StreamingRing":
                        host_out = torch.empty((H, W), dtype=torch.uint8,
                                               pin_memory=True)
                    done = torch.cuda.Event()
                    with torch.cuda.stream(side):
                        host_out.copy_(imf.filter_image_device(
                            src.to("cuda", non_blocking=True), "sharpen"),
                            non_blocking=True)
                        done.record(side)
                    pending.append((host_out, done))
                for host_out, done in pending:
                    done.synchronize()
                    if name == "as StreamingRing":
                        host_out.numpy()
                    else:
                        host_out.numpy().copy()
            out[name] = N / (time.perf_counter() - t0)
    return out


def device_stages(frame):
    """Device ms of the H2D copy, K25 and the D2H copy of one frame on a
    side stream (the third of three repetitions)."""
    side = torch.cuda.Stream()
    host_in = torch.from_numpy(frame).pin_memory()
    host_out = torch.empty_like(host_in).pin_memory()
    dev_in = torch.empty(frame.shape, dtype=torch.uint8, device="cuda")
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    with torch.cuda.stream(side):
        for _ in range(3):
            ev[0].record(side)
            dev_in.copy_(host_in, non_blocking=True)
            ev[1].record(side)
            out = imf.filter_image_device(dev_in, "sharpen")
            ev[2].record(side)
            host_out.copy_(out, non_blocking=True)
            ev[3].record(side)
    torch.cuda.synchronize()
    return [ev[i].elapsed_time(ev[i + 1]) for i in range(3)]


def host_copies(frames):
    """Host ms of one 2 MB copy into a pinned buffer and one out of it into
    a new array (what the first ring design's submit and retrieve copied)."""
    pinned = torch.empty(frames[0].shape, dtype=torch.uint8, pin_memory=True)
    dst = pinned.numpy()
    t = time.perf_counter()
    for i in range(48):
        dst[...] = frames[i % len(frames)]
    into = (time.perf_counter() - t) / 48 * 1e3
    t = time.perf_counter()
    for _ in range(48):
        dst.copy()
    return into, (time.perf_counter() - t) / 48 * 1e3


def device_ms(fn, kernel, iters=20):
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.key_averages() if kernel in e.key]
    return sum(e.device_time_total for e in evs) / iters / 1e3


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    rng = np.random.default_rng(0)
    frames = [rng.integers(0, 256, (H, W), np.uint8) for _ in range(DEPTH)]
    for depth in (DEPTH, 1, DEPTH, 1):
        sub, ret, fps = ring_split(frames, depth)
        print(f"ring depth {depth:2d}: try_submit {sub:.3f} ms, try_retrieve "
              f"{ret:.3f} ms per frame (host), {fps:.1f} frames/s")
    for depth in (DEPTH, 1):
        fps = variants(frames, depth)
        print(f"depth {depth:2d} frames/s: " + ", ".join(
            f"{k} {v:.1f}" for k, v in fps.items()))
    into, out = host_copies(frames)
    print(f"host copies of 2 MB: into a pinned buffer {into:.3f} ms, out of "
          f"it into a new array {out:.3f} ms")
    h2d, k25, d2h = device_stages(frames[0])
    print(f"device per frame: H2D {h2d:.4f} ms, K25 {k25:.4f} ms, D2H "
          f"{d2h:.4f} ms")
    img = torch.from_numpy(frames[0]).cuda()
    g = torch.Generator()
    g.manual_seed(0)
    cases = {"K25 1080x1920": (lambda: imf.filter_image_device(img, "sharpen"),
                               "filter_kernel")}
    for m, k, n in ((10000, 784, 256), (10000, 256, 10), (12800, 768, 3072)):
        a = torch.randint(-127, 128, (m, k), generator=g,
                          dtype=torch.int8).cuda()
        b = kmajor(torch.randint(-127, 128, (k, n), generator=g,
                                 dtype=torch.int8).cuda())
        cases[f"K13 ({m}, {k}) x {n}"] = (
            lambda a=a, b=b: quant.int8_gemm(a, b), "qgemm_wgmma_kernel")
    for name, (fn, kernel) in cases.items():
        print(f"{name}: device {device_ms(fn, kernel):.4f} ms, per call back "
              f"to back {time_cuda(fn, iters=50):.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
