"""Command-line apps of the port (counterpart of the JAX package's cli.py).

Usage: ``python -m vit_fpga_tpu_torch.cli <command> [key=value ...]``

Commands:
  demo    -- end-to-end tour of NetCUDA: dense forward, training, the
             streaming ring
  parity  -- NetCUDA against the NumPy oracle NetCPU (f32, bf16, int8)

Both run on the card unless given ``device=cpu``.  The JAX CLI's bench,
serve, export and calibrate are not ported yet (ROADMAP item 9): they exit
with code 2 and say so.
"""

from __future__ import annotations

import sys

import numpy as np

from .utils.options import Options

_NOT_PORTED = ("bench", "serve", "export", "calibrate")


def _demo_net(n_ins: int):
    from .defines import ACT_IDENTITY, ACT_RELU2, random_net
    return random_net(n_ins, [128, 32, 10], seed=0,
                      activations=[ACT_RELU2, ACT_RELU2, ACT_IDENTITY])


def cmd_demo(opts: Options) -> int:
    from .backends.cuda import NetCUDA
    from .defines import ImageSet, NetSets
    n_ins = opts.get("n_ins", int, 64)
    net = NetCUDA(_demo_net(n_ins), device=opts.get("device", str, "cuda"))
    x = np.random.default_rng(0).normal(size=(n_ins,)).astype(np.float32)
    out = net.launch_forward(x)
    print(f"forward: {out.shape} in {net.get_forward_performance()} us")
    rng = np.random.default_rng(1)
    X = rng.normal(size=(128, n_ins)).astype(np.float32)
    Y = rng.normal(size=(128, 10)).astype(np.float32)
    net.init_gradient(NetSets(X, Y))
    errs = net.launch_gradient(50, 1e-6, 0.01)
    nz = errs[errs > 0]
    print(f"train: loss {nz[0]:.4f} -> {nz[-1]:.4f} "
          f"in {net.get_gradient_performance()} us")
    img = rng.integers(0, 256, (256, 512), np.uint8)
    for i in range(4):
        net.filter_image(ImageSet(img, original_h=256, original_w=512,
                                  original_x_pos=i))
    got = [net.get_filtered_image() for _ in range(4)]
    print(f"pipeline: {sum(not g.empty for g in got)}/4 frames, "
          f"FIFO={[g.original_x_pos for g in got]}")
    return 0


def cmd_parity(opts: Options) -> int:
    from .backends.cpu import NetCPU
    from .backends.cuda import NetCUDA
    from .models import quantized
    device = opts.get("device", str, "cuda")
    data = _demo_net(opts.get("n_ins", int, 64))
    x = np.random.default_rng(0).normal(
        size=(8, data.n_ins)).astype(np.float32)
    oracle = NetCPU(data).forward_batch(x)

    def rel(a, b):
        return np.abs(a - b).max() / (np.abs(b).max() + 1e-12)

    f32 = NetCUDA(data, device=device).forward_batch(x)
    print(f"f32 device vs oracle: max rel err {rel(f32, oracle):.2e}")
    bf16 = NetCUDA(data, compute_dtype="bfloat16",
                   device=device).forward_batch(x)
    print(f"bf16 device vs oracle: max rel err {rel(bf16, oracle):.2e}")
    ref = quantized.mlp_forward_int8_numpy(quantized.quantize_mlp(data), x)
    out = NetCUDA(data, compute_dtype="int8", device=device).forward_batch(x)
    print(f"int8 device vs int8 oracle: bit-exact={np.array_equal(out, ref)}")
    print(f"int8 oracle vs f32 oracle: max rel err {rel(ref, oracle):.2e} "
          f"(quantization noise)")
    return 0


COMMANDS = {"demo": cmd_demo, "parity": cmd_parity}


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] in _NOT_PORTED:
        print(f"vit_fpga_tpu_torch.cli: {argv[0]!r} is not ported yet "
              f"(ROADMAP item 9); the JAX package's cli has it",
              file=sys.stderr)
        return 2
    if not argv or argv[0] not in COMMANDS:
        print(__doc__)
        return 2
    return COMMANDS[argv[0]](Options(argv[1:]))


if __name__ == "__main__":
    sys.exit(main())
