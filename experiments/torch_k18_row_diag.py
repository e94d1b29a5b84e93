"""Where a row of K18 (``attn_block_int8_static``) that leaves the int8 band
comes from: one launch of the kernel at a shape and seed of chip_smoke.py's
inputs, its own scratch read back afterwards (the bf16 qkv its QKV GEMM
wrote, the int8 aoq its attention wrote), stage by stage against the plain
version's.

Run on a machine with a Hopper card, from the repository root:

    python3 experiments/torch_k18_row_diag.py [--seed 274]
        [--shape B N_PAD N_VALID]

(default: ViT-B/16 @384 b16's (16, 584) with 577 valid keys, the timing
inputs of chip_smoke.py's phase 22; K18 calibrated on its own input, as
``chip_smoke._static_attn_args``).  Prints the rows whose qkv moves past one
bf16 ulp from the plain version's (an int8 xq that rounded the other way
in the LayerNorm moves q, k and v of its token together), the rows past
the int8 band, and for each of them how many aoq elements differ between
the kernel, the plain attention on the kernel's own qkv, and the plain
version; then the out-projection of the kernel's aoq in plain arithmetic
against the kernel's out.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=274)
    ap.add_argument("--shape", type=int, nargs=3, default=[16, 584, 577],
                    metavar=("B", "N_PAD", "N_VALID"))
    args = ap.parse_args()
    import torch

    import chip_smoke as cs
    from vit_fpga_tpu_torch.ops import _kernels
    from vit_fpga_tpu_torch.ops import quant_block as qb
    from vit_fpga_tpu_torch.ops.attn_block import _mha_tpu
    from vit_fpga_tpu_torch.ops.quant_fused import _int_matmul
    if not torch.cuda.is_available():
        print("torch_k18_row_diag: no CUDA device", file=sys.stderr)
        return 1
    b, n_pad, n_valid = args.shape
    d, heads = 768, 12
    rows = b * n_pad
    x, _, p = cs._attn_inputs(b, n_pad, d, args.seed)
    a, _, _ = cs._static_attn_args(x, cs._int8_weights(p, ("wqkv", "wo")),
                                   heads, n_valid)
    _, _, _, _, ops = qb._attn_operands(
        x, heads, n_valid, a["ln_scale"], a["ln_bias"], a["wqkv_q"],
        a["wqkv_s"], a["bqkv"], a["wo_q"], a["wo_s"], a["bo"],
        gate=qb.attn_int8_static_geometry)
    out = torch.empty_like(x)
    q8 = torch.empty((rows, d), dtype=torch.int8, device="cuda")
    qkv = torch.empty((rows, 3 * d), dtype=torch.bfloat16, device="cuda")
    with torch.cuda.device(x.device):
        lib, stream = _kernels.launch_target()
        err = lib.vft_attn_block_int8_static(
            x.data_ptr(), *[t.data_ptr() for t in ops], out.data_ptr(),
            q8.data_ptr(), qkv.data_ptr(), b, n_pad, d, heads, n_valid,
            float(cs.EPS), (d // heads) ** -0.5, float(a["inv"]), stream)
    _kernels.check(err, "attn_block_int8_static")
    torch.cuda.synchronize()

    xq = qb._rint_i8(qb._ln_f32(x, a["ln_scale"], a["ln_bias"], cs.EPS))
    qkv_plain = (_int_matmul(xq, a["wqkv_q"]) * a["wqkv_s"].float()
                 + a["bqkv"].float()).to(x.dtype).reshape(rows, 3 * d)
    dq = (qkv.float() - qkv_plain.float()).abs()
    ulp = 2.0 ** -7 * qkv_plain.float().abs()
    moved = (dq > ulp).any(-1).nonzero().flatten().tolist()
    print(f"qkv rows past one bf16 ulp of the plain version's: "
          f"{len(moved)} of {rows}: {moved}")

    def aoq_of(qkv_rows):
        ao = _mha_tpu(qkv_rows.reshape(b, n_pad, 3 * d), heads, n_valid,
                      out_scale=a["inv"])
        return qb._rint_i8(ao.float()).reshape(rows, d)
    aoq_on_kernel_qkv, aoq_plain = aoq_of(qkv), aoq_of(qkv_plain)
    want = qb.attn_block_int8_static_plain(
        x, a["inv"], a["ln_scale"], a["ln_bias"], a["wqkv_q"], a["wqkv_s"],
        a["bqkv"], a["wo_q"], a["wo_s"], a["bo"], heads, eps=cs.EPS,
        n_valid=n_valid)
    step = 127.0 * a["wo_s"]
    band = (cs.BF16_TOL * (1 + want.float().abs() + x.float().abs())
            + cs.INT8_STEPS * step)
    past = ((out.float() - want.float()).abs() > band)[:, :n_valid]
    index = torch.arange(rows, device="cuda").reshape(b, n_pad)[:, :n_valid]
    past_rows = index[past.any(-1)].tolist()
    print(f"rows past the int8 band: {past_rows}")
    for r in past_rows:
        print(f"row {r}: qkv max |kernel - plain| (q, k, v) "
              f"{dq[r].reshape(3, d).amax(1).tolist()}; aoq elements that "
              f"differ: kernel vs plain attention on the kernel's qkv "
              f"{int((q8[r] != aoq_on_kernel_qkv[r]).sum())}, kernel vs "
              f"plain {int((q8[r] != aoq_plain[r]).sum())}")
    y = _int_matmul(q8, a["wo_q"]) * a["wo_s"].float() + a["bo"].float()
    out_plain_proj = x.reshape(rows, d) + y.to(x.dtype)
    gap = (out_plain_proj.float() - out.reshape(rows, d).float()).abs()
    print("kernel out vs the plain out-projection of the kernel's aoq: "
          f"max_abs {float(gap.max()):.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
