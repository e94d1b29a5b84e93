"""Command-line apps of the port (counterpart of the JAX package's cli.py).

Usage: ``python -m vit_fpga_tpu_torch.cli <command> [key=value ...]``

Commands:
  demo      -- end-to-end tour of NetCUDA: dense forward, training, the
               streaming ring
  parity    -- NetCUDA against the NumPy oracle NetCPU (f32, bf16, int8)
  serve     -- throughput of the image-serving pipeline: ViT or clip_*,
               dtype=bfloat16|int8 (quant=dynamic|static), optional
               ckpt=<npz> with the softmax window calibrated at load;
               model= image= batch= images=
  calibrate -- softmax clip-window check of a checkpoint (ckpt=<npz>, or
               a fresh init): model= image= dtype=

All run on the card unless given ``device=cpu``.  The JAX CLI's bench
(ROADMAP item 1) and export (ROADMAP item 7) are not ported yet: they exit
with code 2 and say so.
"""

from __future__ import annotations

import importlib.util
import sys

import numpy as np

from .utils.options import Options

_NOT_PORTED = {"bench": "ROADMAP item 1", "export": "ROADMAP item 7"}


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


def _vision_config(opts: Options, model: str, dtype: str):
    """The ViT (or CLIP vision) config of ``model``."""
    from .models import clip as clip_mod
    from .models import vit
    over = {"image_size": opts.get("image", int, 224), "dtype": dtype}
    if model.startswith("clip_"):
        return clip_mod.clip_vision_config(model.removeprefix("clip_"),
                                           **over)
    return vit.config(model, **over)


def _params(opts: Options, cfg, is_clip: bool, device):
    """``ckpt=``'s params (``utils/checkpoint.load_params``) on
    ``device``, or a fresh init (seed 0)."""
    from .models import clip as clip_mod
    from .models import vit
    from .models.convert import params_from_numpy
    from .utils.checkpoint import load_params
    ckpt = opts.get("ckpt", str, "")
    if ckpt:
        return params_from_numpy(load_params(ckpt), device=device)
    init = clip_mod.init_params if is_clip else vit.init_params
    return init(cfg, device=device)


def _serving_forward(cfg, params, dtype: str, quant: str, is_clip: bool,
                     device):
    """The raw-uint8 forward ``cli serve`` runs: ``make_forward`` of the
    family in bf16, or ``make_forward_int8`` on the dynamic or static
    int8 tree."""
    from .models import clip as clip_mod
    from .models import quantized
    from .models import vit
    if dtype == "int8":
        if quant == "static":
            tree = (quantized.quantize_clip_vision_static if is_clip
                    else quantized.quantize_vit_static)(params, cfg)
        else:
            tree = (quantized.quantize_clip_vision_fast if is_clip
                    else quantized.quantize_vit_fast)(params)
        return quantized.make_forward_int8(cfg, tree, raw=True,
                                           device=device, clip=is_clip)
    family = clip_mod if is_clip else vit
    return family.make_forward(cfg, params, raw=True, device=device)


def _jpegs(size: int, n: int = 8):
    """``n`` random JPEGs of ``size`` px, or None without PIL."""
    if importlib.util.find_spec("PIL") is None:
        return None
    import io
    from PIL import Image
    rng = np.random.default_rng(0)
    out = []
    for _ in range(n):
        buf = io.BytesIO()
        Image.fromarray(rng.integers(0, 256, (size, size, 3),
                                     np.uint8)).save(buf, format="JPEG")
        out.append(buf.getvalue())
    return out


def cmd_serve(opts: Options) -> int:
    """Serve ``images=`` requests through ``runtime/serving.ImageServer``
    and print the throughput.  JPEG requests need PIL; without it the same
    model serves raw uint8 images (``submit_raw``) and says so."""
    import time
    from .runtime.serving import ImageServer
    from .utils.checkpoint import autocalibrated
    from .utils.platform import resolve_device
    model = opts.get("model", str, "vit_b16")
    batch = opts.get("batch", int, 64)
    n = opts.get("images", int, 256)
    dtype = opts.get("dtype", str, "bfloat16")   # bfloat16 | int8
    quant = opts.get("quant", str, "dynamic")    # dynamic | static
    if dtype not in ("bfloat16", "int8"):
        raise SystemExit("serve supports dtype=bfloat16|int8")
    if quant not in ("dynamic", "static"):
        raise SystemExit("serve supports quant=dynamic|static")
    dev = resolve_device(opts.get("device", str, "cuda"))
    is_clip = model.startswith("clip_")
    # int8 engines keep bf16 activations: the config stays bf16
    cfg = _vision_config(opts, model, "bfloat16")
    size = cfg.image_size
    params = _params(opts, cfg, is_clip, dev)
    ckpt = opts.get("ckpt", str, "")
    if ckpt:
        # trust boundary: never serve an unmeasured checkpoint on the
        # max-free softmax
        cfg = autocalibrated(params, cfg, source=f"ckpt {ckpt}")
    fwd = _serving_forward(cfg, params, dtype, quant, is_clip, dev)
    fwd(np.zeros((batch, size, size, 3), np.uint8))   # warm-up outside
    jpegs = _jpegs(size)
    if jpegs is None:
        print("serve: PIL is not installed, so the JPEG leg did not run; "
              "serving raw uint8 images through ImageServer.submit_raw")
        raw = np.random.default_rng(0).integers(0, 256, (8, size, size, 3),
                                                np.uint8)
    with ImageServer(fwd, image_size=size, batch_size=batch,
                     device=dev) as server:
        t0 = time.perf_counter()
        futs = [server.submit(jpegs[i % 8]) if jpegs is not None
                else server.submit_raw(raw[i % 8]) for i in range(n)]
        rows = [f.result(timeout=600) for f in futs]
        dt = time.perf_counter() - t0
    if not all(np.isfinite(r).all() for r in rows):
        raise SystemExit("serve: a result row is not finite")
    print(f"served {n} images in {dt:.2f}s ({n / dt:.1f} img/s), "
          f"{server.batches} batches, model={model}, dtype={dtype}"
          + (f", quant={quant}" if dtype == "int8" else "")
          + f", {'jpeg' if jpegs is not None else 'raw'} requests")
    return 0


def cmd_calibrate(opts: Options) -> int:
    """Measure a checkpoint's attention-score range and report whether
    the max-free softmax is safe for it (``utils/calibrate``).  ``ckpt=``
    loads a ``save_params`` .npz; without it a fresh init is probed."""
    from .utils import calibrate
    from .utils.platform import resolve_device
    dev = resolve_device(opts.get("device", str, "cuda"))
    model = opts.get("model", str, "vit_b16")
    cfg = _vision_config(opts, model, opts.get("dtype", str, "bfloat16"))
    params = _params(opts, cfg, model.startswith("clip_"), dev)
    res = calibrate.choose_softmax_mode(params, cfg)
    print(f"score range: [{res.score_min:.1f}, {res.score_max:.1f}]  "
          f"per-layer max: {np.round(res.per_layer_max, 1).tolist()}")
    print(f"softmax mode: {res.mode}"
          + ("  (set ViTConfig.safe_softmax=True)" if res.safe else ""))
    return 0


COMMANDS = {"demo": cmd_demo, "parity": cmd_parity, "serve": cmd_serve,
            "calibrate": cmd_calibrate}


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] in _NOT_PORTED:
        print(f"vit_fpga_tpu_torch.cli: {argv[0]!r} is not ported yet "
              f"({_NOT_PORTED[argv[0]]}); the JAX package's cli has it",
              file=sys.stderr)
        return 2
    if not argv or argv[0] not in COMMANDS:
        print(__doc__)
        return 2
    return COMMANDS[argv[0]](Options(argv[1:]))


if __name__ == "__main__":
    sys.exit(main())
