// The chunked down-projection of K6's MLP half over column chunks of M
// (mlp_chunk.cu; K3 runs the chunked variant of gemm_wgmma.cuh's GEMM);
// include after common.cuh.
//
//   chunk_down_kernel  per 128 x 128 output tile, for c = 0 .. n_chunks-1:
//                        y   = h[:, c*mc:(c+1)*mc] @ W2[c*mc:(c+1)*mc, :]
//                              in f32, + b2 on the last chunk only
//                        acc = bf16(acc + bf16(y)), acc starting at x
//                      The running acc stays in registers across the
//                      chunks and is rounded to bf16 at each chunk
//                      boundary, where the TPU's round trip through HBM
//                      rounds it; only the last chunk writes it out.

#pragma once

namespace VFT_NS {

struct ChunkDownArgs {
  const bf16* h;    // (T, M) bf16
  const bf16* w2;   // (M, D) bf16
  const float* b2;  // (D,) f32
  const bf16* x;    // (T, D) bf16, the residual the running output starts at
  bf16* out;        // (T, D) bf16
  int T, D, M, n_chunks;
};

// Per-warp f32 staging of one fragment for the chunk-boundary epilogue,
// beside the operand ring (which keeps prefetching the next chunk).
constexpr int CD_STAGE_FLOATS = (GEMM_THREADS / 32) * 16 * GEMM_C_LD;

inline size_t chunk_down_smem_bytes() {
  return gemm_ring_bytes<false, false>() + CD_STAGE_FLOATS * sizeof(float);
}

// The GEMM of common.cuh (128 x 128 x 32 tiles, 8 warps of 64 x 32, a
// GEMM_STAGES-deep cp.async ring) with A = h row-major and B = W2 (K, N)
// row-major, whose K loop runs over the n_chunks chunks of M in order.
// M % (32 * n_chunks) == 0, so a chunk is a whole number of k-steps.
__global__ void __launch_bounds__(GEMM_THREADS, 2) chunk_down_kernel(ChunkDownArgs p) {
  constexpr int A_ELEMS = tile_elems(false, GEMM_BM);
  constexpr int B_ELEMS = tile_elems(true, GEMM_BN);
  constexpr int A_LD = tile_ld(false, GEMM_BM);
  constexpr int B_LD = tile_ld(true, GEMM_BN);
  extern __shared__ __align__(128) unsigned char cd_smem[];
  bf16* As = reinterpret_cast<bf16*>(cd_smem);
  bf16* Bs = As + GEMM_STAGES * A_ELEMS;
  float* stage = reinterpret_cast<float*>(cd_smem + gemm_ring_bytes<false, false>());

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wm = warp >> 2;  // 0..1
  const int wn = warp & 3;   // 0..3
  const int m0 = blockIdx.y * GEMM_BM;
  const int n0 = blockIdx.x * GEMM_BN;

  ChunkPlan pa, pb;
  plan_chunks<false>(pa, p.h, tid, GEMM_BM, m0, p.T, p.M);
  plan_chunks<true>(pb, p.w2, tid, GEMM_BN, n0, p.D, p.M);

  auto load_stage = [&](int s, int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const bool va = pa.ok[i] && k0 + pa.koff[i] < p.M;
      cp_async16(As + s * A_ELEMS + pa.soff[i], va ? pa.src[i] + k0 * pa.kstep[i] : p.h, va);
      const bool vb = pb.ok[i] && k0 + pb.koff[i] < p.M;
      cp_async16(Bs + s * B_ELEMS + pb.soff[i], vb ? pb.src[i] + k0 * pb.kstep[i] : p.w2, vb);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  // The running output, in the epilogue's ownership: lane L holds row L/2,
  // columns 8*(L%2) .. +8 of each of the warp's 4 x 2 fragments, as 8 bf16.
  uint4 run[4][2];
  float* cs = stage + warp * 16 * GEMM_C_LD;
  const int er = lane >> 1;
  const int ec = (lane & 1) * 8;

  const int nk = p.M / GEMM_BK;
  const int k_per_chunk = nk / p.n_chunks;
#pragma unroll
  for (int s = 0; s < GEMM_STAGES - 1; ++s) {
    if (s < nk) load_stage(s, s * GEMM_BK);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % GEMM_STAGES;
    cp_async_wait<GEMM_STAGES - 2>();
    __syncthreads();
    const int next = kt + GEMM_STAGES - 1;
    if (next < nk) load_stage(next % GEMM_STAGES, next * GEMM_BK);
    cp_async_commit();
    const bf16* as = As + s * A_ELEMS;
    const bf16* bs = Bs + s * B_ELEMS;
#pragma unroll
    for (int kk = 0; kk < GEMM_BK / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(af[i], as + (wm * 64 + i * 16) * A_LD + kk * 16, A_LD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(bfr[j], bs + kk * 16 * B_LD + wn * 32 + j * 16, B_LD);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], af[i], bfr[j], acc[i][j]);
    }
    if ((kt + 1) % k_per_chunk != 0) continue;

    // Chunk boundary: acc = bf16(acc + bf16(y [+ b2 on the last chunk])).
    const int c = kt / k_per_chunk;
    const bool first = c == 0;
    const bool last = c == p.n_chunks - 1;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::store_matrix_sync(cs, acc[i][j], GEMM_C_LD, wmma::mem_row_major);
        __syncwarp();
        const int gr = m0 + wm * 64 + i * 16 + er;
        const int gc = n0 + wn * 32 + j * 16 + ec;
        if (gr < p.T && gc < p.D) {
          const size_t off = (size_t)gr * p.D + gc;
          float y[8], prev[8];
          load8f(cs + er * GEMM_C_LD + ec, y);
          if (last) {
            float bi[8];
            load8f(p.b2 + gc, bi);
#pragma unroll
            for (int t = 0; t < 8; ++t) y[t] += bi[t];
          }
          unpack8(first ? *reinterpret_cast<const uint4*>(p.x + off) : run[i][j], prev);
#pragma unroll
          for (int t = 0; t < 8; ++t) y[t] = prev[t] + bf16_round(y[t]);
          run[i][j] = pack8(y);  // the chunk boundary's rounding of the running output
          if (last) *reinterpret_cast<uint4*>(p.out + off) = run[i][j];
        }
        __syncwarp();
        wmma::fill_fragment(acc[i][j], 0.0f);
      }
    }
  }
  cp_async_wait<0>();
}

inline cudaError_t launch_chunk_down(const ChunkDownArgs& p, cudaStream_t stream) {
  if (p.n_chunks < 1 || p.D % 8 || p.M % (GEMM_BK * p.n_chunks)) return cudaErrorInvalidValue;
  const dim3 grid((p.D + GEMM_BN - 1) / GEMM_BN, (p.T + GEMM_BM - 1) / GEMM_BM);
  chunk_down_kernel<<<grid, GEMM_THREADS, chunk_down_smem_bytes(), stream>>>(p);
  return cudaGetLastError();
}

}  // namespace VFT_NS
