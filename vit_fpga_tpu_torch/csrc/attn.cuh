// Attention tile of the forward attention halves on mma.sync (attn_block.cu
// K4, attn_int8.cu K16, attn_int8_static.cu K18, attn_int8_stats.cu K21b);
// include after common.cuh.  K1 (attn_stats.cu) runs the same max-free
// function in the one-pass mode of mha_wgmma.cuh instead.
//
//   attn_kernel<SAFE, Q8>  per (image, head), one 16-row query tile per
//                      warp: s = (q k^T) * scale in f32, keys at or past
//                      n_valid masked to 0; e = exp(clip(s, -70, 80))
//                      (max-free) or, with SAFE, e = exp(s - max over the
//                      unmasked keys); ao = bf16((bf16(e) @ v) * (1 /
//                      sum(e))).  With Q8 (the static int8 kernels) the
//                      reciprocal carries the static scale, r = (1 /
//                      sum(e)) * out_scale, and the tile emits int8
//                      aoq = clip(rint(bf16(o * r)), -127, 127): ao is
//                      rounded to bf16 in the quant domain, as the TPU
//                      kernel's bf16 scratch rounds it.
//   attn_long_kernel<SAFE>  attn_kernel's function for more than ATT_MAX_KV
//                      keys (K4 in both modes, up to
//                      ATT_MAX_LONG tokens): one block per (head, image,
//                      group of ATT_WARPS query tiles); the head's keys and
//                      values stream through shared memory in ATT_KT-key
//                      tiles, double-buffered with cp.async, while each warp
//                      keeps its 16 x 64 f32 PV accumulator in registers and
//                      its 16 row sums in shared memory.  exp(clip(s, -70,
//                      80)) needs no running max, so each key's e is
//                      independent of the others and tiling changes only the
//                      order of the f32 sums: ao = bf16((bf16(e) @ v) * (1 /
//                      sum(e))), keys at or past n_valid contributing 0.
//                      SAFE makes two sweeps over the key tiles: the first
//                      (keys only) takes each row's max of the scaled f32
//                      scores over the unmasked keys, which no order
//                      changes; the second recomputes the scores with the
//                      same MMA sequence, bit for bit, and takes e = exp(s -
//                      max).  So e is rounded to bf16 against the row's
//                      true max, as the reference does, and not against a
//                      running max (a flash-style rescale rounds e against a
//                      partial max: another function).

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
template <bool SAFE, bool Q8>
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
      if (SAFE) {  // exact: exp(s - max over the unmasked keys)
        float mx = -INFINITY;
#pragma unroll
        for (int i = 0; i < ATT_MAX_KV / 32; ++i) {
          const int c = lane + 32 * i;
          e[i] = c < n_valid ? srow[c] * scale : -INFINITY;
          mx = fmaxf(mx, e[i]);
        }
        mx = warp_max(mx);
#pragma unroll
        for (int i = 0; i < ATT_MAX_KV / 32; ++i) {
          const int c = lane + 32 * i;
          e[i] = c < n_valid ? expf(e[i] - mx) : 0.0f;
          sum += e[i];
        }
      } else {  // max-free: exp(clip(s, -70, 80))
#pragma unroll
        for (int i = 0; i < ATT_MAX_KV / 32; ++i) {
          const int c = lane + 32 * i;
          float v = 0.0f;
          if (c < n_valid) v = expf(fminf(fmaxf(srow[c] * scale, -70.0f), 80.0f));
          e[i] = v;
          sum += v;
        }
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
template <bool SAFE, bool Q8 = false>
inline cudaError_t attn_enable() {
  return cudaFuncSetAttribute(attn_kernel<SAFE, Q8>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)attn_smem(ATT_MAX_KV).bytes);
}

// With Q8, ao is unused and aoq (int8) takes the output.
template <bool SAFE, bool Q8 = false>
inline cudaError_t launch_attn(const bf16* qkv, bf16* ao, int batch, int n_pad, int n_valid,
                               int kvp, int d, int heads, float scale, cudaStream_t stream,
                               signed char* aoq = nullptr, float out_scale = 1.0f) {
  attn_kernel<SAFE, Q8><<<dim3(heads, batch), ATT_THREADS, attn_smem(kvp).bytes, stream>>>(
      qkv, ao, aoq, out_scale, n_pad, n_valid, kvp, d, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Key-tiled attention past ATT_MAX_KV keys
// ---------------------------------------------------------------------------

constexpr int ATT_KT = 64;           // keys per streamed K/V tile: 2 per lane in the softmax
constexpr int ATT_MAX_LONG = 1024;   // tokens (n_pad) the key-tiled path takes

// Shared memory of one key-tiled block: two stages of a K tile and a V tile,
// then per warp its 16-row query tile, its f32 scores of one key tile (the
// bf16 probabilities overwrite them row by row, and at the end the f32 PV
// output), its 16 running row sums and (SAFE) its 16 row maxima.
struct AttnLongSmem {
  int ldq, lds;
  size_t tile_bytes, w_off, w_bytes, s_rel, r_rel, bytes;
};

__host__ __device__ inline AttnLongSmem attn_long_smem() {
  AttnLongSmem m;
  m.ldq = ATT_DH + 8;                                   // bf16 elements
  m.lds = (ATT_KT > ATT_DH ? ATT_KT : ATT_DH) + 4;      // f32 elements
  m.tile_bytes = round128((size_t)ATT_KT * m.ldq * 2);
  m.w_off = 4 * m.tile_bytes;                           // 2 stages x (K, V)
  m.s_rel = round128((size_t)16 * m.ldq * 2);
  m.r_rel = m.s_rel + round128((size_t)16 * m.lds * 4);
  m.w_bytes = m.r_rel + round128(2 * 16 * 4);           // row sums, row maxima
  m.bytes = m.w_off + ATT_WARPS * m.w_bytes;
  return m;
}

// qkv: (B * n_pad, 3D) bf16, q | k | v column blocks, head h at h*ATT_DH;
// ao: (B * n_pad, D) bf16.  Block (h, b, g): warp w takes the 16-row query
// tile g * ATT_WARPS + w (idle past n_pad, but it still helps load the
// tiles).  A template, so that the units that include this header compile
// only the variants they launch.
template <bool SAFE, int KT>
__global__ void __launch_bounds__(ATT_THREADS)
    attn_long_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ ao, int n_pad, int n_valid,
                     int d, float scale) {
  static_assert(KT % 32 == 0 && KT <= ATT_KT, "KT keys: whole per-lane columns, within the smem plan");
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int CPR = ATT_DH / 8;  // 16-byte chunks per head row
  constexpr int NF = ATT_DH / 16;  // fragments across the head dimension
  const AttnLongSmem L = attn_long_smem();
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  unsigned char* wbase = smem + L.w_off + warp * L.w_bytes;
  bf16* Qs = reinterpret_cast<bf16*>(wbase);
  float* S = reinterpret_cast<float*>(wbase + L.s_rel);
  bf16* P = reinterpret_cast<bf16*>(S);  // row r's probabilities over its scores
  float* rsum = reinterpret_cast<float*>(wbase + L.r_rel);
  float* rmax = rsum + 16;               // SAFE: max of the scaled scores
  const int ldp = 2 * L.lds;             // bf16 elements per P row

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (blockIdx.z * ATT_WARPS + warp) * 16;
  const bool active = q0 < n_pad;
  const size_t ld3 = 3 * (size_t)d;
  const bf16* base = qkv + (size_t)b * n_pad * ld3 + h * ATT_DH;

  auto k_tile = [&](int buf) { return reinterpret_cast<bf16*>(smem + 2 * buf * L.tile_bytes); };
  auto v_tile = [&](int buf) {
    return reinterpret_cast<bf16*>(smem + (2 * buf + 1) * L.tile_bytes);
  };
  // Keys and values past n_valid are masked, so they are zero-filled.  The
  // max sweep reads no values.
  auto load_tile = [&](int t, int buf, bool values) {
    bf16* Ks = k_tile(buf);
    bf16* Vs = v_tile(buf);
    for (int c = tid; c < KT * CPR; c += ATT_THREADS) {
      const int r = c / CPR, cc = c % CPR;
      const int key = t * KT + r;
      const bool ok = key < n_valid;
      const bf16* row = base + (size_t)(ok ? key : 0) * ld3 + cc * 8;
      cp_async16(Ks + r * L.ldq + cc * 8, row + d, ok);
      if (values) cp_async16(Vs + r * L.ldq + cc * 8, row + 2 * d, ok);
    }
  };

  const int ntiles = (n_valid + KT - 1) / KT;
  // Step i streams key tile i % ntiles; with SAFE steps 0 .. ntiles - 1 are
  // the max sweep and the rest the e sweep.
  const int nsteps = SAFE ? 2 * ntiles : ntiles;
  auto max_step = [&](int i) { return SAFE && i < ntiles; };
  load_tile(0, 0, !max_step(0));
  cp_async_commit();

  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> qa[NF];
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> oacc[NF];
#pragma unroll
  for (int j = 0; j < NF; ++j) wmma::fill_fragment(oacc[j], 0.0f);
  if (active) {
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    for (int c = lane; c < 16 * CPR; c += 32) {
      const int r = c / CPR, cc = c % CPR;
      uint4 v = zero;
      if (q0 + r < n_pad)
        v = *reinterpret_cast<const uint4*>(base + (size_t)(q0 + r) * ld3 + cc * 8);
      *reinterpret_cast<uint4*>(Qs + r * L.ldq + cc * 8) = v;
    }
    if (lane < 16) {
      rsum[lane] = 0.0f;
      rmax[lane] = -INFINITY;
    }
    __syncwarp();
#pragma unroll
    for (int kk = 0; kk < NF; ++kk) wmma::load_matrix_sync(qa[kk], Qs + kk * 16, L.ldq);
  }

  for (int i = 0; i < nsteps; ++i) {
    const int t = i < ntiles ? i : i - ntiles;
    if (i + 1 < nsteps) load_tile((i + 1) % ntiles, (i + 1) & 1, !max_step(i + 1));
    cp_async_commit();  // one group per step, empty or not, keeps the count
    cp_async_wait<1>();  // this thread's copies of step i landed
    __syncthreads();     // everyone's have
    if (active) {
      const bf16* Ks = k_tile(i & 1);
      const bf16* Vs = v_tile(i & 1);
      // scores of this key tile, s = q k^T (f32): the same fragments in the
      // same order in both sweeps, so the same bits
#pragma unroll
      for (int j = 0; j < KT / 16; ++j) {
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
      if (max_step(i)) {
        // row max of s * scale over the unmasked keys of this tile
        for (int r = 0; r < 16; ++r) {
          const float* srow = S + r * L.lds;
          float mx = -INFINITY;
#pragma unroll
          for (int c8 = 0; c8 < KT / 32; ++c8) {
            const int c = lane + 32 * c8;
            if (t * KT + c < n_valid) mx = fmaxf(mx, srow[c] * scale);
          }
          mx = warp_max(mx);
          if (lane == 0) rmax[r] = fmaxf(rmax[r], mx);
        }
        __syncwarp();  // the next tile's scores overwrite S
      } else {
        // e = exp(s - max) (SAFE) or exp(clip(s, -70, 80)) for keys before
        // n_valid, else 0; a row's scores are all read into registers
        // before its bf16 probabilities are written over them
        for (int r = 0; r < 16; ++r) {
          const float* srow = S + r * L.lds;
          const float mx = SAFE ? rmax[r] : 0.0f;
          float e[KT / 32];
          float part = 0.0f;
#pragma unroll
          for (int c8 = 0; c8 < KT / 32; ++c8) {
            const int c = lane + 32 * c8;
            float v = 0.0f;
            if (t * KT + c < n_valid)
              v = SAFE ? expf(srow[c] * scale - mx)
                       : expf(fminf(fmaxf(srow[c] * scale, -70.0f), 80.0f));
            e[c8] = v;
            part += v;
          }
          part = warp_sum(part);
          __syncwarp();
          bf16* prow = P + r * ldp;
#pragma unroll
          for (int c8 = 0; c8 < KT / 32; ++c8) prow[lane + 32 * c8] = __float2bfloat16(e[c8]);
          if (lane == 0) rsum[r] += part;
        }
        __syncwarp();
        // o += bf16(e) @ v (f32), kept in registers across the key tiles
#pragma unroll
        for (int kk = 0; kk < KT / 16; ++kk) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pa;
          wmma::load_matrix_sync(pa, P + kk * 16, ldp);
#pragma unroll
          for (int j = 0; j < NF; ++j) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vb;
            wmma::load_matrix_sync(vb, Vs + (kk * 16) * L.ldq + j * 16, L.ldq);
            wmma::mma_sync(oacc[j], pa, vb, oacc[j]);
          }
        }
        __syncwarp();  // the next tile's scores overwrite S
      }
    }
    __syncthreads();  // step i's buffer is free for the copies of step i + 2
  }
  cp_async_wait<0>();
  if (!active) return;

#pragma unroll
  for (int j = 0; j < NF; ++j)
    wmma::store_matrix_sync(S + j * 16, oacc[j], L.lds, wmma::mem_row_major);
  __syncwarp();
  // ao = bf16(o * (1 / sum(e)))
  for (int c = lane; c < 16 * CPR; c += 32) {
    const int r = c / CPR, cc = c % CPR;
    const int q = q0 + r;
    if (q >= n_pad) continue;
    const float rv = 1.0f / rsum[r];
    const float* src = S + r * L.lds + cc * 8;
    float f[8];
#pragma unroll
    for (int t = 0; t < 8; ++t) f[t] = __fmul_rn(src[t], rv);
    *reinterpret_cast<uint4*>(ao + ((size_t)b * n_pad + q) * d + h * ATT_DH + cc * 8) = pack8(f);
  }
}

// Opts the key-tiled block (91 KB of shared memory) in, on the current device.
template <bool SAFE = false, int KT = ATT_KT>
inline cudaError_t attn_long_enable() {
  return cudaFuncSetAttribute(attn_long_kernel<SAFE, KT>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)attn_long_smem().bytes);
}

template <bool SAFE = false, int KT = ATT_KT>
inline cudaError_t launch_attn_long(const bf16* qkv, bf16* ao, int batch, int n_pad, int n_valid,
                                    int d, int heads, float scale, cudaStream_t stream) {
  if (n_pad > ATT_MAX_LONG || n_valid < 1 || n_valid > n_pad) return cudaErrorInvalidValue;
  const int groups = ((n_pad + 15) / 16 + ATT_WARPS - 1) / ATT_WARPS;
  attn_long_kernel<SAFE, KT><<<dim3(heads, batch, groups), ATT_THREADS, attn_long_smem().bytes,
                               stream>>>(qkv, ao, n_pad, n_valid, d, scale);
  return cudaGetLastError();
}

}  // namespace VFT_NS
