// Whole-sequence exact-softmax attention on Hopper (sm_90a): K7 on the
// packed (B, N, 3D) qkv tensor and K8 on (B, H, N, Dh), one kernel read by
// strides.  K7 is what mha_qkv runs under attn_impl="pallas" (and "auto"
// below 1024 tokens) where the attention half does not fit, and in f32 at
// every layer of the per-tensor int8 ViT forward (vit_forward_int8).
//
// Replaces vit_fpga_tpu/ops/attention.py:_mha_qkv_kernel (wrapper
// mha_qkv_pallas) and :_mha_kernel (wrapper mha_pallas): on the TPU the
// whole (N, N) score matrix of a head sits in VMEM; here the keys stream
// through shared memory in tiles, one pass for each row's max and sum, one
// for p = dtype(exp(s - max) / sum) (normalised before it is rounded) and
// o = dtype(p v).  bf16: seq_attn_kernel<false> on mma.sync; f32:
// seq_attn_f32_kernel, true f32 fma on the CUDA cores (the per-tensor int8
// forward's attention is f32 end to end).  Both in seq_attn.cuh.
//
// What bounds it on the H100: in bf16 at ViT-B/16 @1024 px batch 1 a launch
// does 4 * 12 * 4097^2 * 64 = 51.6 GFLOP (52 us at 989 TFLOP/s, 700 W; the
// kernel computes q k^T twice, 77 GFLOP); in f32 at the per-tensor int8
// forward's (64, 197, 2304) 4 * 64 * 12 * 197^2 * 64 = 7.6 GFLOP, bound by
// the f32 rate outside the tensor cores (114 us at 67 TFLOP/s) against
// 39 MB of traffic.

#define VFT_NS mha
#include "common.cuh"
#include "seq_attn.cuh"

using namespace VFT_NS;

extern "C" {

// Opts the kernels in to their shared memory on the current device.
// Called once per device before the first launch.  Returns a cudaError_t.
int vft_mha_init() {
  cudaError_t err = seq_attn_enable<false>();
  if (err != cudaSuccess) return err;
  return seq_attn_f32_enable();
}

// q, k, v: bf16 (f32 when is_f32), element (b, h, r, c) at b * in_b +
// h * in_h + r * in_r + c (c < 64, bf16 rows 16-byte aligned); o likewise
// with the out_* strides.  Keys at or past n_valid are masked.  Enqueued on
// `stream`, which belongs to the current device.  Returns a cudaError_t.
int vft_mha(const void* q, const void* k, const void* v, void* o, long long in_b, long long in_h,
            int in_r, long long out_b, long long out_h, int out_r, int batch, int heads, int n,
            int n_valid, int is_f32, float scale, void* stream) {
  SeqAttnArgs p{q, k, v, o, in_b, in_h, in_r, out_b, out_h, out_r, heads, n, n_valid, 0, scale};
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  return is_f32 ? launch_seq_attn_f32(p, batch, st) : launch_seq_attn<false>(p, batch, st);
}

}  // extern "C"
