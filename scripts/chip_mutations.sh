#!/bin/bash
# Mutation check of chip_smoke.py's latency gate: each copy breaks one
# kernel and must exit non-zero.  Run from the repository root on the card.
set -u
run_copy() {  # name file old new
  local dst=_chip/mut_$1
  rm -rf "$dst"; mkdir -p "$dst"
  cp -r vit_fpga_tpu_torch chip_smoke.py "$dst"/
  rm -rf "$dst/vit_fpga_tpu_torch/_build"
  python3 - "$dst/vit_fpga_tpu_torch/csrc/$2" "$3" "$4" <<'PY'
import sys
p, a, b = sys.argv[1:]
s = open(p).read()
assert a in s, a
open(p, "w").write(s.replace(a, b))
PY
  (cd "$dst" && timeout 600 python3 chip_smoke.py > ../../chiprun_out/mut_$1.log 2>&1)
  local rc=$?
  echo "mutation $1: exit $rc"
  grep -E "violations=[1-9]|Error|must be" chiprun_out/mut_$1.log | head -4
}
run_copy k11_no_key_mask stack.cuh \
  "attn_item(qkv, ao, bh / heads, bh % heads, qc * ST_QCHUNK, n_pad, n_valid, kvp, d, scale, smem);" \
  "attn_item(qkv, ao, bh / heads, bh % heads, qc * ST_QCHUNK, n_pad, n_pad, (n_pad + 15) / 16 * 16, d, scale, smem);"
run_copy k19a_h_one_tile_absmax vit_stack_int8.cu \
  "h_quant_row(w.h, w.amax, p.amax_parts, w.q, w.sx, r, rows, m);" \
  "h_quant_row(w.h, w.amax, 1, w.q, w.sx, r, rows, m);"
mkdir -p _chip/alone && cp chip_smoke.py _chip/alone/ && (cd _chip/alone && python3 chip_smoke.py > ../../chiprun_out/alone.log 2>&1; echo "chip_smoke.py alone: exit $?"; tail -1 ../../chiprun_out/alone.log)
