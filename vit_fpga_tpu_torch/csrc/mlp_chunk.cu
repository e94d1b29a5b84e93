// Per-block MLP half over column chunks of M on Hopper (sm_90a), the MLP
// that _block runs under mlp_impl="pallas" where the weights take chunks
// (ViT-L: 2, ViT-H: 4).
//
// Replaces vit_fpga_tpu/ops/fused_mlp.py:_mlp_chunk_kernel over the whole
// chunk loop of fused_mlp_chunked_pallas (n_chunks launches of it on the
// TPU, one per column chunk of M, the running output round-tripping through
// HBM in the input dtype).  Here it is one call of a short sequence of
// launches on one stream, counted as one ported kernel, as K5:
//
//   (a) ln_rows          two-pass (mu, rstd) of x (the TPU kernel's jnp.var;
//                        every chunk recomputes the same LN of the same x)
//   (b) gemm_bf16<LN>    h = bf16(act(LN(x; mu, rstd, ls, lb) @ W1 + b1))
//                        over all M columns: the chunks' hidden tiles are
//                        the column slices of this one h
//   (c) chunk_down_kernel (chunk.cuh) out = the running output over the
//                        chunks, acc = bf16(acc + bf16(h_c @ W2_c [+ b2 on
//                        the last chunk])), acc starting at x
//
// It is K3 (mlp_chunk_stats.cu) with two-pass statistics computed here in
// place of the chain's one-pass stats input, and no stats output.  In bf16
// it is not K5's function: K5 adds one f32 sum over all of M to x once.
//
// What bounds it on the H100: at ViT-L/16 batch 8 (1 600 token rows,
// D = 1024, M = 4096) the call does 4 * T * D * M = 26.8 GFLOP, so it is
// bound by tensor-core operations (27 us at 989 TFLOP/s, 700 W) against
// about 23 MB of compulsory traffic.  The normalised activations never
// reach device memory (LN is applied to the A tiles in shared memory); the
// (T, M) bf16 hidden tensor round-trips through device memory, and the
// GEMMs run on wmma fragments (wgmma and TMA are later work).

#define VFT_NS mlp_chunk_blk
#include "common.cuh"
#include "norm.cuh"
#include "chunk.cuh"

using namespace VFT_NS;

extern "C" {

// Opts this unit's kernels in to the shared memory they use, on the
// current device.  Called once per device before the first launch.
// Returns a cudaError_t.
int vft_mlp_chunk_blk_init() {
  cudaError_t err = gemm_enable<true, false, false>();
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(chunk_down_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)chunk_down_smem_bytes());
}

// x, out: (T, D) bf16; ls, lb, b2: (D,) f32; w1: (D, M) bf16; b1: (M,) f32;
// w2: (M, D) bf16.  Scratch: stats (T, 2) f32, h (T, M) bf16.  n_chunks is
// 2 or 4; D % 32 == 0 and M % (32 * n_chunks) == 0.  act is one of the Act
// codes in common.cuh.  Everything is enqueued on `stream`, which belongs
// to the current device.  Returns a cudaError_t.
int vft_fused_mlp_chunked(const void* x, const void* ls, const void* lb, const void* w1,
                          const void* b1, const void* w2, const void* b2, void* out, void* stats,
                          void* h, int t, int d, int m, int n_chunks, int act, float eps,
                          void* stream) {
  if ((n_chunks != 2 && n_chunks != 4) || d % 32 || m % (32 * n_chunks))
    return cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t err;
  if ((err = launch_ln_rows(static_cast<const bf16*>(x), nullptr, nullptr,
                            static_cast<float*>(stats), nullptr, t, d, eps, st)) != cudaSuccess)
    return err;

  GemmArgs up{};
  up.A = static_cast<const bf16*>(x);
  up.stats = static_cast<const float*>(stats);
  up.ln_scale = static_cast<const float*>(ls);
  up.ln_bias = static_cast<const float*>(lb);
  up.B = static_cast<const bf16*>(w1);
  up.bias = static_cast<const float*>(b1);
  up.residual = nullptr;
  up.C = static_cast<bf16*>(h);
  up.M = t;
  up.N = m;
  up.K = d;
  up.act = act;
  if ((err = launch_gemm_t<true, false, false>(up, st)) != cudaSuccess) return err;

  ChunkDownArgs down{};
  down.h = static_cast<const bf16*>(h);
  down.w2 = static_cast<const bf16*>(w2);
  down.b2 = static_cast<const float*>(b2);
  down.x = static_cast<const bf16*>(x);
  down.out = static_cast<bf16*>(out);
  down.T = t;
  down.D = d;
  down.M = m;
  down.n_chunks = n_chunks;
  if ((err = launch_chunk_down(down, st)) != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // extern "C"
