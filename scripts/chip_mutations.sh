#!/bin/bash
# Mutation check of chip_smoke.py's gates: each copy breaks one kernel and
# must exit non-zero.  Run from the repository root on the card:
#   bash scripts/chip_mutations.sh [NAME ...]
# With names, only those copies run (and not the lone chip_smoke.py).
set -u
ONLY="$*"
mkdir -p chiprun_out
run_copy() {  # name file old new [old new ...]
  if [ -n "$ONLY" ] && [[ " $ONLY " != *" $1 "* ]]; then return; fi
  local dst=_chip/mut_$1
  rm -rf "$dst"; mkdir -p "$dst"
  cp -r vit_fpga_tpu_torch chip_smoke.py "$dst"/
  rm -rf "$dst/vit_fpga_tpu_torch/_build"
  python3 - "$dst/vit_fpga_tpu_torch/csrc/$2" "${@:3}" <<'PY'
import sys
p, edits = sys.argv[1], sys.argv[2:]
s = open(p).read()
for a, b in zip(edits[::2], edits[1::2]):
    assert a in s, a
    s = s.replace(a, b)
open(p, "w").write(s)
PY
  (cd "$dst" && timeout 600 python3 chip_smoke.py > ../../chiprun_out/mut_$1.log 2>&1)
  local rc=$?
  echo "mutation $1: exit $rc"
  grep -E "violations=[1-9]|Error|must be" chiprun_out/mut_$1.log | head -4
}
run_copy k11_no_key_mask stack.cuh \
  "attn_item<Q8>(qkv, ao, aoq, out_scale, bh / heads, bh % heads, qc * ST_QCHUNK, n_pad, n_valid," \
  "attn_item<Q8>(qkv, ao, aoq, out_scale, bh / heads, bh % heads, qc * ST_QCHUNK, n_pad, n_pad,"
run_copy k19a_h_one_tile_absmax stack_i8.cuh \
  "h_quant_row(w.h, w.amax, p.amax_parts, w.q, w.sx, r, rows, m);" \
  "h_quant_row(w.h, w.amax, 1, w.q, w.sx, r, rows, m);"
# K17 without the saturation before the int8 cast of h: past +-127 it wraps
run_copy k17_no_clamp quant.cuh \
  "q.c[t] = rint_sat(qact_scaled(f[t], p.act, p.qscale));" \
  "q.c[t] = static_cast<signed char>(static_cast<int>(rintf(qact_scaled(f[t], p.act, p.qscale))));"
# K19b reading layer 0's inv_ao / inv_ah for every layer
run_copy k19b_layer0_scales vit_stack_int8_static.cu \
  "__ldg(p.inv_ao + l);" "__ldg(p.inv_ao);" "__ldg(p.inv_ah + l);" "__ldg(p.inv_ah);"
# K25 rounding half away from zero: the blur puts many pixels on a half
run_copy k25_roundf image_filter.cu \
  "static_cast<int>(rintf(acc))" "static_cast<int>(roundf(acc))"
# K13 without its last partial K step (the shared int8 GEMM's K loop; only
# K13 has a ragged K: 784 = 12 x 64 + 16 in the dense net, 1 padded to 16)
run_copy k13_no_partial_k_tile quant.cuh \
  "const int nk = (p.K + QG_BK - 1) / QG_BK;" "const int nk = p.K / QG_BK;"
# K3 adding b2 on every chunk instead of the last one only (the chunk
# boundary's epilogue in the wgmma GEMM's K loop, which only K3 runs)
run_copy k3_b2_every_chunk gemm_wgmma.cuh \
  "q.bias = nullptr;  // b2 rides the last chunk only" "q.bias = p.bias;"
# K4's safe mode skipping the last partial key tile (key 576 of 577, keys
# 128..196 of 197): the tile count rounded down where the launch is safe
run_copy k4_long_no_partial_tile mha_wgmma.cuh \
  "const int ntiles = (p.n_valid + MW_KT - 1) / MW_KT;" \
  "const int ntiles = (MODE == MW_SAFE && p.n_valid > MW_KT ? p.n_valid - 1 : p.n_valid + MW_KT - 1) / MW_KT;"
# K12 without the embed's posb on each image's CLS row (the CLS token and
# its position embedding dropped)
run_copy k12_no_cls_posb vit_full.cu \
  "for (int t = 0; t < 16; ++t) f[t] = __fadd_rn(f[t], pb[t]);" \
  "for (int t = 0; t < 16; ++t) f[t] = r % p.n_pad == 0 ? f[t] : __fadd_rn(f[t], pb[t]);"
# K20 with the head's row quantization skipped: the CLS rows' final
# LayerNorm and rowquant are not run, so the head reads stale int8 rows
run_copy k20_head_no_rowquant stack_i8.cuh \
  "last ? (fin ? lfs : nullptr)" "last ? nullptr"
# K9 without the alpha rescale of acc and l when a key block raises the
# running max
run_copy k9_no_alpha_rescale seq_attn.cuh \
  "const float alpha = expf(m[rr] - mn);" "const float alpha = 1.0f;"
# K7 and K8 in bf16 with the n_valid mask one key late (the key at n_valid,
# zero-filled by TMA, joins the softmax: 1/18 of the output at 17 keys)
run_copy k7_k8_mask_one_late mha_wgmma.cuh \
  "return key0 + 8 * (x >> 2) + (x & 1) >= n_valid ? -INFINITY : s[x];" \
  "return key0 + 8 * (x >> 2) + (x & 1) >= n_valid + 1 ? -INFINITY : s[x];"
# K7 and K8 in f32 with the same mask one key late (the one-pass kernel's
# score mask: the key at n_valid, zero-filled, joins the softmax with e =
# exp(-m); 1 of 200 keys valid doubles the row sum)
run_copy k7_k8_f32_mask_one_late seq_attn.cuh \
  "s[i][j] = kg + 8 * j < nk ? s[i][j] * p.scale : -INFINITY;" \
  "s[i][j] = kg + 8 * j < nk + 1 ? s[i][j] * p.scale : -INFINITY;"
# K5's LN prologue reading rstd as 1: a kernel added to the copy overwrites
# the rstd column of the two-pass stats before the up-projection (phase
# 18's K5 case scales x by 2, so rstd is about 0.5 there)
run_copy k5_ln_rstd_one mlp.cu \
  "extern \"C\" {
" \
  "__global__ void rstd_one(float* st, int t) {
  const int r = blockIdx.x * 256 + threadIdx.x;
  if (r < t) st[2 * r + 1] = 1.0f;
}

extern \"C\" {
" \
  "  GwArgs up{};
" \
  "  rstd_one<<<(t + 255) / 256, 256, 0, st>>>(static_cast<float*>(stats), t);
  GwArgs up{};
"
# The bf16 K7 / K8 ring without the V tiles of pass 2: the producer loads
# and expects K alone, so p v reads whatever the V slots held before
run_copy k7_k8_ring_no_v_load mha_wgmma.cuh \
  "mbar_expect_tx(full(s), pv ? 2 * MW_TILE_BYTES : MW_TILE_BYTES);" \
  "mbar_expect_tx(full(s), MW_TILE_BYTES);" \
  "if (pv) tma_load_4d(ks + MW_TILE_BYTES, &tv, full(s), 0, key0, h, b);" \
  ""
# K6 with its chunk loop collapsed to one chunk: no bf16 rounding of the
# running output between chunks, i.e. K5's function
run_copy k6_one_chunk mlp_chunk.cu \
  "  down.n_chunks = n_chunks;" "  down.n_chunks = 1;"
# K21a normalising x with its own one-pass LN statistics instead of the
# producer's (the parity cases feed stats that are not x's own)
run_copy k21a_own_stats mlp_int8_stats.cu \
  "launch_quant_rows<bf16, LN_STATS, false, ST>(" \
  "launch_quant_rows<bf16, LN_ONE_PASS, false, ST>("
# K21b emitting the stats of the f32 sum x + bf16(y) instead of out's bf16
# values: the out-projection runs once more into an f32 scratch (the qkv
# buffer) and a one-pass stats kernel added to the copy reads that
run_copy k21b_f32_sum_stats attn_int8_stats.cu \
  "namespace {
" \
  "namespace {

template <typename ST>
__global__ void f32_stats_kernel(const float* x, ST* st, int rows, int d, float eps) {
  const int row = (blockIdx.x * 256 + threadIdx.x) >> 5, lane = threadIdx.x & 31;
  if (row >= rows) return;
  float s = 0.0f, ss = 0.0f;
  for (int c = lane; c < d; c += 32) {
    const float v = x[(size_t)row * d + c];
    s += v;
    ss += v * v;
  }
  s = warp_sum(s);
  ss = warp_sum(ss);
  if (lane == 0) {
    const float mu = s / d;
    put_stat(st + 2 * (size_t)row, mu);
    put_stat(st + 2 * (size_t)row + 1, 1.0f / sqrtf(fmaxf(ss / d - mu * mu, 0.0f) + eps));
  }
}

template <typename ST>
cudaError_t launch_f32_stats(const float* x, ST* st, int rows, int d, float eps,
                             cudaStream_t stream) {
  f32_stats_kernel<ST><<<(rows + 7) / 8, 256, 0, stream>>>(x, st, rows, d, eps);
  return cudaGetLastError();
}
" \
  "  if ((err = launch_qgemm<EPI_RESID>(o, st)) != cudaSuccess) return err;
" \
  "  if ((err = launch_qgemm<EPI_RESID>(o, st)) != cudaSuccess) return err;
  o.C = qkv;
  o.c_f32 = 1;
  if ((err = launch_qgemm<EPI_RESID>(o, st)) != cudaSuccess) return err;
" \
  "launch_row_stats(static_cast<const bf16*>(out)," \
  "launch_f32_stats(static_cast<const float*>(qkv),"
# K22 quantising p without the 1/sum(e) factor
run_copy k22_no_rsum attn_int8_scores.cu \
  "const float p127 = __fmul_rn(127.0f, __fdiv_rn(1.0f, sum));" \
  "const float p127 = 127.0f;"
# K10 reading each pixel's channels in the wrong order (BGR for RGB)
run_copy k10_bgr patch_embed.cu \
  "const size_t koff = (size_t)py * w3 + (kin ? k % p3 : 0);" \
  "const size_t koff = (size_t)py * w3 + (kin ? k % p3 - (k % p3) % 3 + 2 - (k % p3) % 3 : 0);"
# K26 in bf16 dropping the last 64-deep K step of the wgmma GEMM (1024 =
# 16 x 64 at ViT-L/16 @384, the whole last step; 520 = 8 x 64 + 8): the
# GEMM's producer and consumers both stop one step early where the launch
# has neither bias nor residual, which only K26 launches
run_copy k26_no_last_k_tile gemm_wgmma.cuh \
  "const int nk = (p.K + GW_BK - 1) / GW_BK;" \
  "const int nk = (p.K + GW_BK - 1) / GW_BK - (p.bias == nullptr && p.residual == nullptr);"
# K26 in f32 dropping the last K tile (K 300 = 18 x 16 + 12)
run_copy k26_f32_no_last_k_tile streamed_gemm.cu \
  "const int nk = (K + HF_K - 1) / HF_K;" "const int nk = (K - 1) / HF_K;"
# K4's safe mode taking each row's max over the last key tile only (its
# pass 1): exp(s - max) overflows on wide scores
run_copy k4_long_safe_one_tile_max mha_wgmma.cuh \
  "      r.m2[rr] = mn;
      continue;" \
  "      r.m2[rr] = quad_max(tmax[rr]) * sl2;
      continue;"
# K4's safe mode normalising before it rounds, p = bf16(e / sum e): K7's
# exact mode in its place (caught by phase_train_edges' flat tokens)
run_copy k4_safe_normalise_first attn_half.cuh \
  "launch_mha_wgmma<MODE>(tq, tk, tv, a, batch, st)" \
  "launch_mha_wgmma<MODE == MW_SAFE ? MW_EXACT : MODE>(tq, tk, tv, a, batch, st)" \
  "  return mha_wgmma_enable<MODE>();" \
  "  if ((err = mha_wgmma_enable<MW_EXACT>()) != cudaSuccess) return err;
  return mha_wgmma_enable<MODE>();"
# K24's weight gradients without their last split-K partial (the split sum
# of dW1 and dW2 stops one split early)
run_copy k24_split_k_drop_last_part gemm_wgmma.cuh \
  "for (int s = 1; s < splits; ++s) {" "for (int s = 1; s < splits - 1; ++s) {"
# K24's activation-backward epilogue (gf_kernel) with act'(h) taken as 1:
# dh = da
run_copy k24_dact_as_one gemm_wgmma.cuh \
  "const float dh0 = da[x] * d0, dh1 = da[x + 1] * d1;" \
  "const float dh0 = da[x], dh1 = da[x + 1];"
# K1 and K2's wgmma GEMM with rstd forced to 1 in its LN prologue (phase
# 18's K2 case scales x by 2, so rstd is about 0.5 there)
run_copy k1_k2_ln_rstd_one gemm_wgmma.cuh \
  "rs[i] = st.y;" "rs[i] = 1.0f;"
# K1's max-free attention without the last key tile's mask: the keys past
# n_valid, zero-filled by TMA, each add e = 1 to the row sum
run_copy k1_no_last_tile_mask mha_wgmma.cuh \
  "return key0 + 8 * (x >> 2) + (x & 1) >= n_valid ? 0.0f : e;" "return e;"
# K1 and K2's wgmma GEMM without its last K step (64 of K 768; the K tail
# of 8 at K 776)
run_copy k1_k2_gemm_skip_k_step gemm_wgmma.cuh \
  "const int nk = (p.K + GW_BK - 1) / GW_BK;" "const int nk = (p.K + GW_BK - 1) / GW_BK - 1;"
[ -n "$ONLY" ] && exit 0
mkdir -p _chip/alone && cp chip_smoke.py _chip/alone/ && (cd _chip/alone && python3 chip_smoke.py > ../../chiprun_out/alone.log 2>&1; echo "chip_smoke.py alone: exit $?"; tail -1 ../../chiprun_out/alone.log)
