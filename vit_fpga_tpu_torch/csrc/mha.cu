// Whole-sequence exact-softmax attention on Hopper (sm_90a): K7 on the
// packed (B, N, 3D) qkv tensor and K8 on (B, H, N, Dh), one kernel read by
// strides.  K7 is what mha_qkv runs under attn_impl="pallas" (and "auto"
// below 1024 tokens) where the attention half does not fit, and in f32 at
// every layer of the per-tensor int8 ViT forward (vit_forward_int8).
//
// Replaces vit_fpga_tpu/ops/attention.py:_mha_qkv_kernel (wrapper
// mha_qkv_pallas) and :_mha_kernel (wrapper mha_pallas): on the TPU the
// whole (N, N) score matrix of a head sits in VMEM; here the keys stream
// through shared memory in tiles.  In bf16, one pass for each row's max and
// sum, one for p = dtype(e / sum e) (normalised before it is rounded) and
// o = dtype(p v); in f32, where rounding p to the dtype changes nothing,
// one pass with a running max and sum.
//
// bf16: mha_wgmma_kernel<MW_EXACT> (mha_wgmma.cuh, on hopper.cuh's pieces).
// One thread of a producer warpgroup streams 128-key K tiles (pass 1) and
// K / V tile pairs (pass 2) by TMA into a 4-stage ring of shared memory,
// each stage a full and an empty mbarrier; two consumer warpgroups of 64
// query rows each run both products on wgmma (q k^T with A and B in
// shared memory, p v with p in registers), the next tile's q k^T (pass 1)
// or the previous tile's p v (pass 2) running while the exponentials are
// taken, and the softmax in the log2 domain on ex2.approx with one
// reciprocal of each row sum.  The tensor maps are encoded per call by
// cuTensorMapEncodeTiled, which is reached through cudaGetDriverEntryPoint
// so that nothing links libcuda (hopper.cuh).
// Why 128 query rows a block: one block fills an SM (145 KB of shared
// memory; 240 registers a consumer thread), and at ViT-B/16 @1024 px b1 the
// 33 x 12 = 396 blocks are exactly 3 waves on 132 SMs (192 rows would be 2
// waves of 264, but 3 consumer warpgroups leave 160 registers a thread for
// the two score tiles of pass 1); at 224 px (197 tokens) 128 rows waste 59
// of 256 rows a head where 192 would waste 187 of 384.
// f32: seq_attn_f32_kernel (seq_attn.cuh), true f32 fma on the CUDA cores
// (the per-tensor int8 forward's attention is f32 end to end): one pass
// over the keys with a running max and sum, which in f32 is the exact
// softmax's function up to rounding; 128 query rows a block, 32 a warp,
// each lane an 8 x 8 register micro-tile of the scores and of the output
// fed by float4 reads of shared memory, 64-key K and V tiles copied by
// cp.async into one slot each in alternation (the next K during this
// tile's e v, the next V during the next q k^T; two blocks an SM), the last
// tile cut to its 16-key groups before n_valid.
//
// What bounds it on the H100: in bf16 at ViT-B/16 @1024 px batch 1 a launch
// does 4 * 12 * 4097^2 * 64 = 51.6 GFLOP of the function's work (52 us at
// 989 TFLOP/s, 700 W); the two passes compute q k^T twice, so 77.4 GFLOP
// are issued (78 us), and 2 * 12 * 4097^2 = 403 M exponentials at the
// special-function units' 16 a clock per SM (~97 us at 1.98 GHz), which
// overlap the products only in part: ~0.10 ms for this design.  What holds
// it back now: per SM the exponentials, the f32 work around them and the
// products of each tile still add up more than they overlap (PERF.md), and
// every block reads K twice and V once from L2 (1.57 MB at 4097 keys).  In
// f32 at the per-tensor int8 forward's (64, 197, 2304) 4 * 64 * 12 * 197^2 *
// 64 = 7.6 GFLOP, bound by the f32 rate outside the tensor cores (114 us at
// 67 TFLOP/s) against 155 MB of traffic (46 us); the kernel computes 224 of
// 256 padded rows and 208 keys, 9.2 GFLOP (137 us).

#define VFT_NS mha
#include "common.cuh"
#include "seq_attn.cuh"
#include "hopper.cuh"
#include "mha_wgmma.cuh"

using namespace VFT_NS;

extern "C" {

// Opts the kernels in to their shared memory on the current device and
// finds the driver's cuTensorMapEncodeTiled.  Called once per device before
// the first launch.  Returns a cudaError_t.
int vft_mha_init() {
  cudaError_t err = tma_init();
  if (err != cudaSuccess) return err;
  if ((err = mha_wgmma_enable<MW_EXACT>()) != cudaSuccess) return err;
  return seq_attn_f32_enable<64, SF_ONLINE>();
}

// q, k, v: bf16 (f32 when is_f32), element (b, h, r, c) at b * in_b +
// h * in_h + r * in_r + c (c < 64; base addresses and strides multiples of
// 16 bytes, as TMA reads them); o likewise with the out_* strides.  Keys at
// or past n_valid are masked.  Enqueued on `stream`, which belongs to the
// current device.  Returns a cudaError_t.
int vft_mha(const void* q, const void* k, const void* v, void* o, long long in_b, long long in_h,
            int in_r, long long out_b, long long out_h, int out_r, int batch, int heads, int n,
            int n_valid, int is_f32, float scale, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (is_f32) {
    SeqAttnArgs p{q, k, v, o, in_b, in_h, in_r, out_b, out_h, out_r, heads, n, n_valid, scale};
    return launch_seq_attn_f32<64, SF_ONLINE>(p, batch, st);
  }
  if (tma_encoder() == nullptr) return cudaErrorInitializationError;
  if (n < 1 || n_valid < 1 || n_valid > n || batch < 1 || heads < 1) return cudaErrorInvalidValue;
  MwMaps m;
  if (!mw_encode(&m.q, q, in_b, in_h, in_r, n, heads, batch) ||
      !mw_encode(&m.k, k, in_b, in_h, in_r, n_valid, heads, batch) ||
      !mw_encode(&m.v, v, in_b, in_h, in_r, n_valid, heads, batch))
    return cudaErrorInvalidValue;
  MhaTmaArgs p{o, out_b, out_h, out_r, heads, n, n_valid, scale * 1.4426950408889634f, scale};
  return launch_mha_wgmma<MW_EXACT>(m, p, batch, st);
}

}  // extern "C"
