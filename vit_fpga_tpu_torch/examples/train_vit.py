"""End-to-end ViT training example on synthetic classification data (the
port's counterpart of the JAX package's examples/train_vit.py).

Usage:
    python -m vit_fpga_tpu_torch.examples.train_vit [variant=vit_ti16]
        [image=64] [batch=32] [steps=50] [classes=10] [device=cuda]
        [ckpt=vit_train_ckpt.npz]

Runs on the card unless given ``device=cpu``: AdamW through ``Trainer``,
remat, then a ``save_train_state`` / ``load_train_state`` round trip of
``{"params", "opt_state", "step"}``.  ``dp`` / ``tp`` above 1 raise, as
``Trainer(mesh=...)`` does: sharded training comes with the multi-device
port.
"""

from __future__ import annotations

import os
import sys

import numpy as np


def main(argv) -> int:
    from vit_fpga_tpu_torch.models import vit
    from vit_fpga_tpu_torch.train.trainer import Trainer
    from vit_fpga_tpu_torch.utils.checkpoint import (load_train_state,
                                                     save_train_state)
    from vit_fpga_tpu_torch.utils.options import Options
    opts = Options(argv)
    variant = opts.get("variant", str, "vit_ti16")
    image = opts.get("image", int, 64)
    batch = opts.get("batch", int, 32)
    steps = opts.get("steps", int, 50)
    classes = opts.get("classes", int, 10)
    device = opts.get("device", str, "cuda")
    if opts.get("dp", int, 1) * opts.get("tp", int, 1) > 1:
        raise NotImplementedError("sharded training comes with the "
                                  "multi-device port (ROADMAP.md, item 6)")

    cfg = vit.config(variant, image_size=image, num_classes=classes,
                     dtype="bfloat16", remat=True)
    trainer = Trainer(cfg, learning_rate=1e-3, device=device)

    # Synthetic separable data: class = argmax over fixed random probes.
    rng = np.random.default_rng(0)
    probes = rng.normal(size=(classes, image, image, 3)).astype(np.float32)

    def make_batch(step):
        r = np.random.default_rng(step)
        x = r.normal(size=(batch, image, image, 3)).astype(np.float32)
        y = np.einsum("bhwc,khwc->bk", x, probes).argmax(-1).astype(
            np.int32)
        return x, y

    hist = trainer.fit((make_batch(i) for i in range(steps)),
                       log_every=max(1, steps // 10))
    first, last = hist[0], hist[-1]
    print(f"loss {first['loss']:.4f} -> {last['loss']:.4f}; "
          f"acc {first['accuracy']:.3f} -> {last['accuracy']:.3f}")

    # checkpoint round trip
    state = trainer.state(step=steps)
    path = os.path.abspath(opts.get("ckpt", str, "vit_train_ckpt.npz"))
    save_train_state(path, state)
    restored = load_train_state(path, like=state)
    print(f"checkpoint saved+restored at step {restored['step']} ({path})")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
