// Stats-chain attention half on Hopper (sm_90a).
//
// Replaces vit_fpga_tpu/ops/attn_block.py:_attn_stats_kernel (with its
// _mha_loop), one Pallas kernel on the TPU.  Here it is a short sequence of
// launches on one stream, counted as one ported kernel:
//
//   (a) gw_kernel<LN>      qkv = bf16(LN(x; mu, rstd, ls, lb) @ Wqkv + bqkv)
//   (b) mha_wgmma_kernel<MW_MAXFREE>  per (128 query rows, image x head), the
//                          max-free softmax in one pass over 128-key tiles:
//                          s = q k^T in f32, e = exp(clip(s * scale, -70,
//                          80)) with keys at or past n_valid masked to 0,
//                          ao = bf16((bf16(e) @ v) * (1 / sum(e))), for
//                          every length the gate takes (up to 1024 tokens)
//   (c) gw_kernel          out = x + bf16(ao @ Wo + bo)
//   (d) row_stats          next (mu, rstd) of out, only when asked for
//
// (a)-(c) are attn_half.cuh's sequence, shared with K4 (attn_block.cu):
// (a) and (c) gemm_wgmma.cuh's GEMM, (b) mha_wgmma.cuh's kernel (K7 / K8's
// ring, one pass instead of two); both are wgmma + TMA with a producer
// warpgroup and two consumer warpgroups (hopper.cuh).  (b) reads the
// packed qkv scratch through 4-D tensor maps, {64, rows, heads, batch}:
// Q's row extent n_pad, K's and V's n_valid.
//
// What bounds it on the H100: at ViT-B/16 batch 64 the launch does 8 R D^2
// + 4 B H n_pad n_valid dh = 68 GFLOP against about 44 MB of compulsory
// traffic, so it is bound by tensor-core operations (69 us at 989 TFLOP/s,
// 700 W); at CLIP ViT-L/14 batch 64 (264 rows, 257 valid, D 1024, 16
// heads) 159 GFLOP (161 us).  The normalised activations never reach device
// memory (LN is applied to the landed A tiles in shared memory); the qkv
// and attention-output tensors (59 + 20 MB at ViT-B b64) still round-trip
// through device memory, and a 128-query block pads 200 rows to 256 (28%
// more attention work, 4% of the launch's).  64-row blocks on one consumer
// warpgroup (experiments/torch_k1_ab.py --one-consumer) pad as much at 200
// and 584 rows and less at 264 (320 rows for 384), and were slower at all
// three: one such block an SM (137 KB of ring) keeps half the rows in
// flight.

#define VFT_NS attn_half
#include "common.cuh"
#include "hopper.cuh"
#include "gemm_wgmma.cuh"
#include "mha_wgmma.cuh"
#include "attn_half.cuh"

using namespace VFT_NS;

extern "C" {

const char* vft_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

// Finds the driver's tensor-map encoder and opts this unit's kernels in to
// the shared memory they use, on the current device.  Called once per
// device before the first launch.  Returns a cudaError_t.
int vft_attn_init() { return attn_half_enable<MW_MAXFREE>(); }

// x, out: (B * n_pad, D) bf16; stats, stats_out: (B * n_pad, 2) f32;
// ls, lb, bo: (D,) f32; wqkv: (D, 3D) bf16; bqkv: (3D,) f32; wo: (D, D) bf16;
// qkv (B * n_pad, 3D) and ao (B * n_pad, D) are bf16 scratch; every
// pointer 16-byte aligned.  Head dim 64, 1 <= n_valid <= n_pad <= 1024.
// stats_out may be null (no next stats).  *long_path is set to 1 when more
// than 256 keys are valid (the same kernel; the launch checks count those
// launches apart) and 0 otherwise.  Everything is enqueued on `stream`,
// which belongs to the current device.  Returns a cudaError_t.
int vft_attn_block_stats(const void* x, const void* stats, const void* ls, const void* lb,
                         const void* wqkv, const void* bqkv, const void* wo, const void* bo,
                         void* out, void* stats_out, void* qkv, void* ao, int batch, int n_pad,
                         int d, int heads, int n_valid, float eps, float scale, void* stream,
                         int* long_path) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t err = launch_attn_half<MW_MAXFREE>(
      static_cast<const bf16*>(x), static_cast<const float*>(stats),
      static_cast<const float*>(ls), static_cast<const float*>(lb),
      static_cast<const bf16*>(wqkv), static_cast<const float*>(bqkv),
      static_cast<const bf16*>(wo), static_cast<const float*>(bo), static_cast<bf16*>(out),
      static_cast<bf16*>(qkv), static_cast<bf16*>(ao), batch, n_pad, d, heads, n_valid, scale, st,
      long_path);
  if (err != cudaSuccess) return err;
  if (stats_out != nullptr &&
      (err = launch_row_stats(static_cast<const bf16*>(out), static_cast<float*>(stats_out),
                              batch * n_pad, d, eps, st)) != cudaSuccess)
    return err;
  return cudaGetLastError();
}

}  // extern "C"
