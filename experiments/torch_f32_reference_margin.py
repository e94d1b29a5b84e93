"""Margin of the f32 MLP-half parity test on this host's CPU.

Prints, for ``tests/test_torch_fused_mlp_train.py``'s f32 forward case
(each activation), the largest |port - JAX| and its share of the test's
limit ``1e-5 + 1e-5 * |want|``, with the JAX reference (``fused_mlp_pallas``
in interpret mode) run at JAX's default matmul precision and under
``jax.default_matmul_precision`` "float32" and "bfloat16".  A share near 1
means the host's XLA:CPU runs the reference's f32 dots at reduced
precision.

    JAX_PLATFORMS=cpu python experiments/torch_f32_reference_margin.py
"""

from __future__ import annotations

import contextlib
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import test_torch_fused_mlp_train as t  # noqa: E402
from vit_fpga_tpu.ops.fused_mlp import fused_mlp_pallas  # noqa: E402
from vit_fpga_tpu_torch.ops import fused_mlp as tfm  # noqa: E402


def margin(act: str, precision):
    p = t._as(t._inputs(0), jnp.float32)
    ctx = (jax.default_matmul_precision(precision) if precision
           else contextlib.nullcontext())
    with ctx:
        want = fused_mlp_pallas(jnp.asarray(p["x"]),
                                *[jnp.asarray(p[k]) for k in t._ARGS],
                                act=act, block_t=16, interpret=True)
    got = tfm.fused_mlp_fwd(t._torch(p["x"], torch.float32),
                            *[torch.from_numpy(p[k]) for k in t._ARGS],
                            act=act)
    g, w = t._f32(got), t._f32(want)
    d = np.abs(g - w)
    return float(d.max()), float((d / (1e-5 + 1e-5 * np.abs(w))).max())


def main() -> int:
    for act in t.ACTS:
        for precision in (None, "float32", "bfloat16"):
            dmax, share = margin(act, precision)
            print(f"{act:10s} precision={precision or 'default':8s} "
                  f"max|d| {dmax:.3e}  share of limit {share:.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
