#!/bin/bash
# Mutation check of chip_smoke.py's gates: each copy breaks one kernel and
# must exit non-zero.  Run from the repository root on the card:
#   bash scripts/chip_mutations.sh [NAME ...]
# With names, only those copies run (and not the lone chip_smoke.py).
set -u
ONLY="$*"
mkdir -p chiprun_out
run_copy() {  # name file old new [old new ...]
  # file: under vit_fpga_tpu_torch/csrc, or under vit_fpga_tpu_torch where
  # it names a directory (models/vit.py)
  if [ -n "$ONLY" ] && [[ " $ONLY " != *" $1 "* ]]; then return; fi
  local dst=_chip/mut_$1
  local target="$dst/vit_fpga_tpu_torch/csrc/$2"
  [[ "$2" == */* ]] && target="$dst/vit_fpga_tpu_torch/$2"
  rm -rf "$dst"; mkdir -p "$dst"
  cp -r vit_fpga_tpu_torch chip_smoke.py "$dst"/
  rm -rf "$dst/vit_fpga_tpu_torch/_build"
  python3 - "$target" "${@:3}" <<'PY'
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
# K11 with the attention's key mask at n_pad for n_valid (the bf16 variant
# of the layer loop without a patch embed: K11 alone): the keys past
# n_valid, zero-filled by TMA, each add e = 1 to the row sum
run_copy k11_no_key_mask stack_wgmma.cuh \
  "ntiles, r.it, p.n_valid, p.scale, no_max," \
  "ntiles, r.it, V == LQ_BF16 && p.p3 == 0 ? p.n_pad : p.n_valid, p.scale, no_max,"
# K15 quantizing h with the first W1 column tile's absmax alone (the row
# pass reads one of the tiles' row maxima)
run_copy k15_h_one_tile_absmax mlp_int8.cu \
  "up.parts, nparts, hq8," "up.parts, 1, hq8,"
# K15's W2 epilogue without the residual: out = bf16(y)
run_copy k15_no_residual qgemm_wgmma.cuh \
  "pack_bf16x2(x01.x + bf16_round(f[0]), x01.y + bf16_round(f[1]))" \
  "pack_bf16x2(bf16_round(f[0]), bf16_round(f[1]))" \
  "pack_bf16x2(x23.x + bf16_round(f[2]), x23.y + bf16_round(f[3]))" \
  "pack_bf16x2(bf16_round(f[2]), bf16_round(f[3]))"
# K19a quantizing h with one 64-column W1 tile's absmax (W2's A block
# and the row stage after it read the first part of each row's maxima)
run_copy k19a_h_one_tile_absmax stack_wgmma.cuh \
  "a = LqQuantA{w.h, w.amax_h, lq_h_parts(p.m), rows, p.m, true, &p.maps.h};" \
  "a = LqQuantA{w.h, w.amax_h, 1, rows, p.m, true, &p.maps.h};"
# K19a's out-projection quantizing its A block of ao with the first
# head's absmax alone (the row stage after it dequantizes with all heads')
run_copy k19a_ao_one_head_absmax stack_wgmma.cuh \
  "a = LqQuantA{w.ao, w.amax_ao, p.heads, rows, p.d, false, &p.maps.ao};" \
  "a = LqQuantA{w.ao, w.amax_ao, 1, rows, p.d, false, &p.maps.ao};"
# K17 without the saturation before the int8 cast of h: past +-127 it
# wraps (qgemm_wgmma.cuh's QW_Q8 store where an activation runs, K17's W1;
# K22's QKV panel, act none, keeps its clamp)
run_copy k17_no_clamp qgemm_wgmma.cuh \
  "q4 |= (uint32_t)(unsigned char)rint_sat(qact_scaled(f[e], p.act, p.qscale)) << (8 * e);" \
  "q4 |= (uint32_t)(unsigned char)(p.act == ACT_NONE ? (int)rint_sat(qact_scaled(f[e], p.act, p.qscale)) : static_cast<int>(rintf(qact_scaled(f[e], p.act, p.qscale)))) << (8 * e);"
# K19b reading layer 0's inv_ao / inv_ah for every layer (the static
# variant of the layer loop, stack_wgmma.cuh)
run_copy k19b_layer0_scales stack_wgmma.cuh \
  "__ldg(p.inv_ao + l)" "__ldg(p.inv_ao)" "__ldg(p.inv_ah + l)" "__ldg(p.inv_ah)"
# K19b's attention epilogue without the +-127 clamp of the int8 aoq: past
# the calibrated absmax it wraps
run_copy k19b_no_ao_clamp stack_wgmma.cuh \
  "const int q0i = static_cast<int>(fminf(fmaxf(rintf(f0), -127.0f), 127.0f));" \
  "const int q0i = static_cast<int>(rintf(f0));" \
  "const int q1i = static_cast<int>(fminf(fmaxf(rintf(f1), -127.0f), 127.0f));" \
  "const int q1i = static_cast<int>(rintf(f1));"
# K25 rounding half away from zero: the blur puts many pixels on a half
run_copy k25_roundf image_filter.cu \
  "__float_as_uint(__fadd_rn(fminf(fmaxf(acc, 0.0f), 255.0f), 12582912.0f))" \
  "__float_as_uint(roundf(fminf(fmaxf(acc, 0.0f), 255.0f)) + 12582912.0f)"
# K25 taking the byte left of a warp's 32 chunks as zero (lane 0's load
# from memory): every 512th column of a 1080p frame reads a zero neighbour
run_copy k25_no_left_halo image_filter.cu \
  "left[r] = lane == 0 && row_in && x > 0 ? __ldg(row + x - 1) : 0u;" \
  "left[r] = 0u;"
# K25 taking 16-byte chunks at any width: rows of 45 or 1921 bytes are not
# 16-byte aligned, and the columns past the last whole chunk are lost
run_copy k25_vec_any_width image_filter.cu \
  "return w % 16 == 0 && base % 16 == 0 ? 16 : 1;" \
  "return base % 16 == 0 ? 16 : 1;"
# K25 with its strip count rounded down: the last row of a frame of odd
# height (1081, 17, 33) is never written, a one-row frame launches no block
run_copy k25_last_strip image_filter.cu \
  "const int strips = (h + ROWS - 1) / ROWS;" "const int strips = h / ROWS;"
# K13 without its last partial K step (the int8 wgmma GEMM's K-step count
# rounded down: 784 = 6 x 128 + 16 in the dense net loses its last 16, K 16
# (1 padded) all of it)
run_copy k13_no_partial_k_tile qgemm_wgmma.cuh \
  "const int nk = (p.K + QW_BK - 1) / QW_BK;" "const int nk = p.K / QW_BK;"
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
# its position embedding dropped; the bf16 variant's embed epilogue)
run_copy k12_no_cls_posb stack_wgmma.cuh \
  "const float2 bi = *reinterpret_cast<const float2*>(bp0 + 8 * j + cof);" \
  "const float2 bi = V == LQ_BF16 && embed && r0 % e.n_pad == 0 ? make_float2(0.0f, 0.0f) : *reinterpret_cast<const float2*>(bp0 + 8 * j + cof);" \
  "const float2 bi = *reinterpret_cast<const float2*>(bp1 + 8 * j + cof);" \
  "const float2 bi = V == LQ_BF16 && embed && r1 % e.n_pad == 0 ? make_float2(0.0f, 0.0f) : *reinterpret_cast<const float2*>(bp1 + 8 * j + cof);"
# K12's out-projection row stage summing only the first of its split-K
# partials (the bf16 variant's (d) rows)
run_copy k12_one_wo_partial stack_wgmma.cuh \
  "LqRows a{p.tok, w.part, lq_layer_gemm<V>(p, l, gi).split," \
  "LqRows a{p.tok, w.part, V == LQ_BF16 && gi == 1 ? 1 : lq_layer_gemm<V>(p, l, gi).split,"
# K20 with the head's row quantization skipped: the CLS rows' final
# LayerNorm and rowquant are not run, so the head reads stale int8 rows
# (the dynamic variant only: K12's final LN stays)
run_copy k20_head_no_rowquant stack_wgmma.cuh \
  "g ? (last ? p.lfs : p.ls1 + ln)" "g ? (last ? (V == LQ_DYN ? nullptr : p.lfs) : p.ls1 + ln)"
# K9 without the alpha rescale of acc and l when a key block raises the
# running max (the online mode of the wgmma attention, both at bk 128 and
# at the longer blocks)
run_copy k9_no_alpha_rescale mha_wgmma.cuh \
  "alpha[rr] = ex2(m2[rr] - mn[rr]);" "alpha[rr] = 1.0f;"
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
  "mbar_expect_tx(full(s), pv ? 2 * Dim::TILE : Dim::TILE);" \
  "mbar_expect_tx(full(s), Dim::TILE);" \
  "if (pv) mw_load<DH>(ks + Dim::TILE, &m.v, &m.v1, full(s), key0, h, b);" \
  ""
# K6 with its chunk loop collapsed to one chunk (the chunked GEMM's chunk
# as long as its K): no bf16 rounding of the running output between
# chunks, i.e. K5's function
run_copy k6_one_chunk mlp_chunk.cu \
  "  down.chunk_k = m / n_chunks;" "  down.chunk_k = m;"
# K23's key-tile kernel without the key mask: the keys past n_valid,
# zero-filled by TMA (s = 0), get p = exp(-max) / l and so dk and dv rows
run_copy k23_last_key_tile_unmasked attn_bwd.cu \
  "const bool kv = valid[y & 1];" "const bool kv = true;"
# K23's rs = sum dP p over bf16(p) instead of the f32 p
run_copy k23_rs_from_bf16_p attn_bwd.cu \
  "rs[rr] += p * dp[x];" "rs[rr] += bf16_round(p) * dp[x];"
# K23's key-tile kernel dropping the last query tile from dk
run_copy k23_dk_no_last_query_tile attn_bwd.cu \
  "rs_issue<DH, QW / 16>(dkacc, pd, qh);  // dk += dS^T q" \
  "if (j + 1 < nqt) rs_issue<DH, QW / 16>(dkacc, pd, qh);  // dk += dS^T q"
# K21a normalising x with its own one-pass LN statistics instead of the
# producer's (the parity cases feed stats that are not x's own): the row
# pass before its W1 on the int8 wgmma GEMM
run_copy k21a_own_stats mlp_int8_stats.cu \
  "launch_quant_rows<bf16, LN_STATS, false, ST>(" \
  "launch_quant_rows<bf16, LN_ONE_PASS, false, ST>("
# K16 quantizing ao with the first head's absmax alone: a row pass added to
# the copy takes each row's absmax over its first 64 columns and quantizes
# the whole row with it (the other heads' values clip at +-127)
run_copy k16_ao_one_head_absmax attn_int8.cu \
  "extern \"C\" {
" \
  "namespace {
__global__ void one_head_quant_kernel(const bf16* ao, signed char* q, float* s, int rows, int d) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= rows) return;
  const bf16* a = ao + (size_t)row * d;
  float amax = 0.0f;
  for (int c = 0; c < MW_DH; ++c) amax = fmaxf(amax, fabsf(__bfloat162float(a[c])));
  const float sc = __fdiv_rn(fmaxf(amax, 1e-12f), 127.0f);
  for (int c = 0; c < d; ++c) q[(size_t)row * d + c] = quant1(__bfloat162float(a[c]), sc);
  s[row] = sc;
}
}  // namespace

extern \"C\" {
" \
  "  if ((err = launch_quant_rows<bf16, LN_NONE>(aob, nullptr, nullptr, q, sc, rows, d, 0.0f, st)) !=" \
  "  one_head_quant_kernel<<<(rows + 255) / 256, 256, 0, st>>>(aob, q, sc, rows, d);
  if ((err = cudaGetLastError()) !="
# K16's attention with its key mask and its K / V extent at n_pad instead of
# n_valid past 256 keys: the padding rows' keys join every query row (phase
# 21's 577 valid keys of 584)
run_copy k16_key_mask_at_n_pad attn_int8.cu \
  "launch_mha_packed<MW_MAXFREE>(qkvb, aob, batch, n_pad, d, heads, n_valid," \
  "launch_mha_packed<MW_MAXFREE>(qkvb, aob, batch, n_pad, d, heads, n_valid > 256 ? n_pad : n_valid,"
# K21b emitting the stats of the f32 sum x + bf16(y) instead of out's bf16
# values: a plain out-projection added to the copy writes that sum into an
# f32 scratch (the qkv buffer) after the wgmma one, and a one-pass stats
# kernel added to the copy reads it
run_copy k21b_f32_sum_stats attn_int8_stats.cu \
  "namespace {
" \
  "namespace {

__global__ void f32_sum_kernel(const signed char* aq, const float* sa, const signed char* wo,
                               const float* so, const float* bo, const bf16* x, float* y,
                               int rows, int d) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)rows * d) return;
  const int r = (int)(i / d), c = (int)(i % d);
  int acc = 0;
  for (int k = 0; k < d; ++k) acc += (int)aq[(size_t)r * d + k] * (int)wo[(size_t)c * d + k];
  const float f = __fadd_rn(__fmul_rn((float)acc, __fmul_rn(sa[r], so[c])), bo[c]);
  y[i] = __bfloat162float(x[i]) + bf16_round(f);
}

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
  "  if ((err = launch_qgemm_epi<QW_RESID>(q, static_cast<const signed char*>(wo), out, o, st)) !=
      cudaSuccess)
    return err;
" \
  "  if ((err = launch_qgemm_epi<QW_RESID>(q, static_cast<const signed char*>(wo), out, o, st)) !=
      cudaSuccess)
    return err;
  f32_sum_kernel<<<(unsigned)(((size_t)rows * d + 255) / 256), 256, 0, st>>>(
      q, sc, static_cast<const signed char*>(wo), o.sb, o.bias, o.residual,
      static_cast<float*>(qkv), rows, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
" \
  "launch_row_stats(static_cast<const bf16*>(out)," \
  "launch_f32_stats(static_cast<const float*>(qkv),"
# K21b normalising x with its own one-pass LN statistics instead of the
# producer's (the parity cases feed stats that are not x's own): the row
# pass before its QKV on the int8 wgmma GEMM
run_copy k21b_own_ln_stats attn_int8_stats.cu \
  "launch_quant_rows<bf16, LN_STATS, false, ST>(" \
  "launch_quant_rows<bf16, LN_ONE_PASS, false, ST>("
# K18's int8 attention output without its static scale: aoq = rint(bf16(o
# / sum e)), the reciprocal alone (mha_wgmma.cuh's Q8 store)
run_copy k18_out_scale_dropped mha_wgmma.cuh \
  "const float rv = __fmul_rn(ol[rr], p.out_scale);" "const float rv = ol[rr];"
# K22 quantising p without the 1/sum(e) factor (the int8 attention's p127)
run_copy k22_no_rsum attn_int8_scores.cu \
  "p127[rr] = __fmul_rn(127.0f, __fdiv_rn(1.0f, quad_sum(l[rr])));" \
  "p127[rr] = 127.0f;"
# K22's row sums keeping the keys past n_valid (the first sweep's last
# tile unmasked: each zero-filled key adds e = 1 to sum(e))
run_copy k22_keys_unmasked attn_int8_scores.cu \
  "s8_fold<true>(s, l, i * S8_KT + 2 * t4, n_valid, sdq);" \
  "s8_fold<false>(s, l, 0, 0, sdq);"
# K10's patchify reading each pixel's channels in the wrong order (BGR for
# RGB), every patch size through the byte-wise gather
run_copy k10_bgr patch_embed.cu \
  "f[t] = q < g.k ? (float)__ldg(base + (size_t)(q / p3) * w3 + q % p3) : 0.0f;" \
  "f[t] = q < g.k ? (float)__ldg(base + (size_t)(q / p3) * w3 + q % p3 - q % 3 + 2 - q % 3) : 0.0f;" \
  "if ((patch * 3) % 8 == 0 && " "if (false && "
# K10's split without its lo piece (a two-piece split: hi + mid, 16 of the
# 24 bits); phase 17's band may not see it, the one-lit-pixel case
# (phase_k10_exact) must
run_copy k10_no_lo_piece patch_embed.cu \
  "pc[0][e] = lo, pc[1][e] = mid, pc[2][e] = hi;" \
  "pc[0][e] = 0.0f, pc[1][e] = mid, pc[2][e] = hi;"
# K14's epilogue with K15's fma-form tanh-GELU for the textbook one
run_copy k14_fma_gelu qgemm_wgmma.cuh \
  "for (int e = 0; e < 4; ++e) f[e] = qact(f[e], p.act);" \
  "for (int e = 0; e < 4; ++e) f[e] = p.act == ACT_GELU_TANH_JAX ? act_rn(f[e], ACT_GELU_TANH) : qact(f[e], p.act);"
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
  "launch_mha_packed<MODE, false, DH>(qkv, ao," \
  "launch_mha_packed<MODE == MW_SAFE && DH == 64 ? MW_EXACT : MODE, false, DH>(qkv, ao," \
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
# mha_wgmma.cuh's attention sweeping 8 key tiles at most (1024 keys): K1,
# K4, K16, K18, K21b and K7 / K8 past 1024 tokens lose their last keys
run_copy mha_sweep_8_key_tiles mha_wgmma.cuh \
  "const int ntiles = (p.n_valid + MW_KT - 1) / MW_KT;" \
  "const int ntiles = min(8, (p.n_valid + MW_KT - 1) / MW_KT);"
# K23's (e) sweeping 8 query tiles at most (1024 query rows): dk and dv
# past 1024 tokens lose the query rows after them
run_copy k23_kv_sweep_8_query_tiles attn_bwd.cu \
  "for (int j = 0; j < nqt; ++j) {" "for (int j = 0; j < min(nqt, 8); ++j) {"
# The stats chain's backward (vit.StatsChainFunction) returning no gradient
# for the tokens: the embed, CLS and position table get none (caught right
# after the build by phase 26's chain gradient)
run_copy chain_vjp_no_dx models/vit.py \
  "return (dx, None, None, None, None, *dblocks)" \
  "return (None, None, None, None, None, *dblocks)"
# device_prefetch handing a batch over without waiting on its copy's event
# (caught right after the build by phase 26's prefetch check)
run_copy prefetch_no_wait runtime/data.py \
  "consumer.wait_event(ready)" "pass"
# The attention core reading 64 columns of an 80-column head: q k^T without
# the second box's k16 step (columns 64..79), at every head-dim-80 launch
# of K4, K16 and K18 (caught right after the build by phase 27)
run_copy dh80_qk_first_64_columns mha_wgmma.cuh \
  "  if constexpr (DH == 80) wgmma_m64n128k16_ss(s, qd.d1, kd.d1, 1);
" ""
# K4 launched with the softmax scale of head dim 64, 1 / sqrt(64), at any
# head dim (caught right after the build by phase 27 at head dim 80)
run_copy dh80_scale_of_64 ops/attn_block.py \
  "            1.0 / math.sqrt(d // num_heads), stream, ctypes.byref(long_path))" \
  "            1.0 / math.sqrt(64), stream, ctypes.byref(long_path))"
[ -n "$ONLY" ] && exit 0
mkdir -p _chip/alone && cp chip_smoke.py _chip/alone/ && (cd _chip/alone && python3 chip_smoke.py > ../../chiprun_out/alone.log 2>&1; echo "chip_smoke.py alone: exit $?"; tail -1 ../../chiprun_out/alone.log)
