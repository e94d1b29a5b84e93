"""Where ``runtime/data.device_prefetch``'s time goes on the card: per
batch of ViT-B/16 uint8 images (b16 and b64), the host cost of pinning a
numpy batch, of a pageable ``.to("cuda")`` copy, of iterating
``device_prefetch`` alone, and of ``device_prefetch`` beside a fake step
of 20 ms on the device (``torch.cuda._sleep``) against the same steps on
batches already on the card.  Run on the card:

    python3 experiments/torch_prefetch_cost.py
"""

import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from vit_fpga_tpu_torch.runtime.data import device_prefetch  # noqa: E402


def _ms(fn, n):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


def _sleep_cycles(ms):
    """Clock cycles of ``torch.cuda._sleep`` for about ``ms`` ms."""
    cycles = 10_000_000
    t = _ms(lambda: torch.cuda._sleep(cycles), 1)
    return int(cycles * ms / t)


def main():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    rng = np.random.default_rng(0)
    cyc = _sleep_cycles(20.0)
    for batch in (16, 64):
        n = 16
        host = [(rng.integers(0, 256, (batch, 224, 224, 3), np.uint8),
                 rng.integers(0, 1000, batch).astype(np.int32))
                for _ in range(n)]
        mib = host[0][0].nbytes / 2 ** 20
        list(device_prefetch(host[:2], device="cuda"))      # warm
        pin = _ms(lambda: [torch.from_numpy(i).pin_memory()
                           for i, _ in host], n)
        page = _ms(lambda: [torch.from_numpy(i).to("cuda")
                            for i, _ in host], n)
        alone = _ms(lambda: [b for b in device_prefetch(host,
                                                        device="cuda")], n)
        on_card = [(torch.from_numpy(i).cuda(), torch.from_numpy(lb).cuda())
                   for i, lb in host]

        def steps(batches):
            for imgs, _ in batches:
                torch.cuda._sleep(cyc)
                imgs.float().sum()

        fed = _ms(lambda: steps(device_prefetch(host, device="cuda")), n)
        ref = _ms(lambda: steps(on_card), n)
        print(f"b{batch} ({mib:.1f} MiB a batch): pin {pin:.3f} ms, pageable "
              f".to('cuda') {page:.3f} ms, device_prefetch alone {alone:.3f}"
              f" ms a batch; a 20 ms step fed by device_prefetch "
              f"{fed:.3f} ms vs on the card {ref:.3f} ms [{smi}]")


if __name__ == "__main__":
    main()
