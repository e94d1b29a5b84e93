// Attention tile of the int8 attention halves on mma.sync (attn_int8.cu
// K16, attn_int8_static.cu K18, attn_int8_stats.cu K21b); include after
// common.cuh.  K1 and K4 (attn_half.cuh) run the bf16 halves' attention in
// mha_wgmma.cuh instead.
//
//   attn_kernel<Q8>    per (image, head), one 16-row query tile per warp:
//                      s = (q k^T) * scale in f32, keys at or past n_valid
//                      masked to 0; e = exp(clip(s, -70, 80)) (the
//                      max-free softmax); ao = bf16((bf16(e) @ v) * (1 /
//                      sum(e))).  With Q8 (the static int8 kernels) the
//                      reciprocal carries the static scale, r = (1 /
//                      sum(e)) * out_scale, and the tile emits int8
//                      aoq = clip(rint(bf16(o * r)), -127, 127): ao is
//                      rounded to bf16 in the quant domain, as the TPU
//                      kernel's bf16 scratch rounds it.

#pragma once

namespace VFT_NS {

constexpr int ATT_WARPS = 8;
constexpr int ATT_THREADS = ATT_WARPS * 32;
constexpr int ATT_MAX_KV = 256;  // keys per (image, head): 8 per lane in the softmax
constexpr int ATT_DH = 64;       // head dim (ViT-B/16, ViT-L/16)

// Shared memory of one attention block: the head's keys and values for the
// whole image, then per warp a 16-row query tile, its f32 scores (the bf16
// probabilities overwrite them row by row, then the f32 PV output) and the
// 16 reciprocal denominators.
struct AttnSmem {
  int ldq, lds;
  size_t k_off, v_off, w_off, w_bytes, s_rel, r_rel, bytes;
};

__host__ __device__ inline AttnSmem attn_smem(int kvp) {
  AttnSmem m;
  m.ldq = ATT_DH + 8;                          // bf16 elements
  m.lds = (kvp > ATT_DH ? kvp : ATT_DH) + 4;   // f32 elements
  m.k_off = 0;
  m.v_off = round128((size_t)kvp * m.ldq * 2);
  m.w_off = m.v_off + round128((size_t)kvp * m.ldq * 2);
  m.s_rel = round128((size_t)16 * m.ldq * 2);
  m.r_rel = m.s_rel + round128((size_t)16 * m.lds * 4);
  m.w_bytes = m.r_rel + round128(16 * 4);
  m.bytes = m.w_off + ATT_WARPS * m.w_bytes;
  return m;
}

// qkv: (B * n_pad, 3D) bf16, q | k | v column blocks, head h at h*ATT_DH.
// ao:  (B * n_pad, D) bf16, or with Q8 aoq (B * n_pad, D) int8.  One block
// per (head, image); warp w takes the 16-row query tiles w, w + 8, ...
template <bool Q8>
__global__ void __launch_bounds__(ATT_THREADS)
    attn_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ ao,
                signed char* __restrict__ aoq, float out_scale, int n_pad, int n_valid,
                int kvp, int d, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int CPR = ATT_DH / 8;  // 16-byte chunks per head row
  constexpr int NF = ATT_DH / 16;  // fragments across the head dimension
  const AttnSmem L = attn_smem(kvp);
  bf16* Ks = reinterpret_cast<bf16*>(smem + L.k_off);
  bf16* Vs = reinterpret_cast<bf16*>(smem + L.v_off);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  unsigned char* wbase = smem + L.w_off + warp * L.w_bytes;
  bf16* Qs = reinterpret_cast<bf16*>(wbase);
  float* S = reinterpret_cast<float*>(wbase + L.s_rel);
  bf16* P = reinterpret_cast<bf16*>(S);  // row r's probabilities over its scores
  float* rinv = reinterpret_cast<float*>(wbase + L.r_rel);
  const int ldp = 2 * L.lds;             // bf16 elements per P row

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const size_t ld3 = 3 * (size_t)d;
  const bf16* base = qkv + (size_t)b * n_pad * ld3 + h * ATT_DH;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  // Keys and values past n_valid are masked, so they are zero-filled here.
  for (int c = tid; c < kvp * CPR; c += ATT_THREADS) {
    const int r = c / CPR, cc = c % CPR;
    uint4 kv = zero, vv = zero;
    if (r < n_valid) {
      const bf16* row = base + (size_t)r * ld3 + cc * 8;
      kv = *reinterpret_cast<const uint4*>(row + d);
      vv = *reinterpret_cast<const uint4*>(row + 2 * d);
    }
    *reinterpret_cast<uint4*>(Ks + r * L.ldq + cc * 8) = kv;
    *reinterpret_cast<uint4*>(Vs + r * L.ldq + cc * 8) = vv;
  }
  __syncthreads();

  const int nqt = (n_pad + 15) / 16;
  for (int qt = warp; qt < nqt; qt += ATT_WARPS) {
    const int q0 = qt * 16;
    for (int c = lane; c < 16 * CPR; c += 32) {
      const int r = c / CPR, cc = c % CPR;
      uint4 v = zero;
      if (q0 + r < n_pad)
        v = *reinterpret_cast<const uint4*>(base + (size_t)(q0 + r) * ld3 + cc * 8);
      *reinterpret_cast<uint4*>(Qs + r * L.ldq + cc * 8) = v;
    }
    __syncwarp();
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> qa[NF];
#pragma unroll
    for (int kk = 0; kk < NF; ++kk) wmma::load_matrix_sync(qa[kk], Qs + kk * 16, L.ldq);

    // scores s = q k^T (f32)
    for (int j = 0; j < kvp / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.0f);
#pragma unroll
      for (int kk = 0; kk < NF; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kb;
        wmma::load_matrix_sync(kb, Ks + (j * 16) * L.ldq + kk * 16, L.ldq);
        wmma::mma_sync(acc, qa[kk], kb, acc);
      }
      wmma::store_matrix_sync(S + j * 16, acc, L.lds, wmma::mem_row_major);
    }
    __syncwarp();

    // Softmax numerators e; masked keys give 0.  A row's scores are all
    // read into registers before its bf16 probabilities are written over
    // them.
    for (int r = 0; r < 16; ++r) {
      const float* srow = S + r * L.lds;
      float e[ATT_MAX_KV / 32];
      float sum = 0.0f;
#pragma unroll
      for (int i = 0; i < ATT_MAX_KV / 32; ++i) {  // max-free: exp(clip(s, -70, 80))
        const int c = lane + 32 * i;
        float v = 0.0f;
        if (c < n_valid) v = expf(fminf(fmaxf(srow[c] * scale, -70.0f), 80.0f));
        e[i] = v;
        sum += v;
      }
      sum = warp_sum(sum);
      __syncwarp();
      bf16* prow = P + r * ldp;
#pragma unroll
      for (int i = 0; i < ATT_MAX_KV / 32; ++i) {
        const int c = lane + 32 * i;
        if (c < kvp) prow[c] = __float2bfloat16(e[i]);
      }
      if (lane == 0) rinv[r] = 1.0f / sum;
    }
    __syncwarp();

    // o = bf16(e) @ v (f32), kept in registers until P is consumed
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> oacc[NF];
#pragma unroll
    for (int j = 0; j < NF; ++j) wmma::fill_fragment(oacc[j], 0.0f);
    for (int kk = 0; kk < kvp / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pa;
      wmma::load_matrix_sync(pa, P + kk * 16, ldp);
#pragma unroll
      for (int j = 0; j < NF; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vb;
        wmma::load_matrix_sync(vb, Vs + (kk * 16) * L.ldq + j * 16, L.ldq);
        wmma::mma_sync(oacc[j], pa, vb, oacc[j]);
      }
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < NF; ++j)
      wmma::store_matrix_sync(S + j * 16, oacc[j], L.lds, wmma::mem_row_major);
    __syncwarp();

    // ao = bf16(o * (1 / sum(e))), or aoq = rint_sat(bf16(o * r))
    for (int c = lane; c < 16 * CPR; c += 32) {
      const int r = c / CPR, cc = c % CPR;
      const int q = q0 + r;
      if (q >= n_pad) continue;
      const float rv = Q8 ? __fmul_rn(rinv[r], out_scale) : rinv[r];
      const float* src = S + r * L.lds + cc * 8;
      const size_t off = ((size_t)b * n_pad + q) * d + h * ATT_DH + cc * 8;
      float f[8];
#pragma unroll
      for (int t = 0; t < 8; ++t) f[t] = __fmul_rn(src[t], rv);
      if (Q8) {
#pragma unroll
        for (int t = 0; t < 8; ++t) f[t] = bf16_round(f[t]);
        store_rint8(aoq + off, f);
      } else {
        *reinterpret_cast<uint4*>(ao + off) = pack8(f);
      }
    }
    __syncwarp();  // the next tile reuses Qs, S and rinv
  }
}

// Opts the attention block at ATT_MAX_KV keys (221 KB of shared memory)
// in, on the current device.
template <bool Q8 = false>
inline cudaError_t attn_enable() {
  return cudaFuncSetAttribute(attn_kernel<Q8>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)attn_smem(ATT_MAX_KV).bytes);
}

// With Q8, ao is unused and aoq (int8) takes the output.
template <bool Q8 = false>
inline cudaError_t launch_attn(const bf16* qkv, bf16* ao, int batch, int n_pad, int n_valid,
                               int kvp, int d, int heads, float scale, cudaStream_t stream,
                               signed char* aoq = nullptr, float out_scale = 1.0f) {
  attn_kernel<Q8><<<dim3(heads, batch), ATT_THREADS, attn_smem(kvp).bytes, stream>>>(
      qkv, ao, aoq, out_scale, n_pad, n_valid, kvp, d, scale);
  return cudaGetLastError();
}

}  // namespace VFT_NS
