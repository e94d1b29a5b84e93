// Blockwise (flash) attention on Hopper (sm_90a): the attention that
// _block runs where the attention half does not fit and the sequence has
// 1024 tokens or more (ViT-B/16 and ViT-S/16 at 1024 px, 4097 tokens), in
// bf16 and in the dynamic int8 forward's per-linear route.
//
// Replaces vit_fpga_tpu/ops/flash_attention.py:_flash_kernel (wrapper
// flash_attention, reached through attention.py:_mha_qkv_flash_impl):
// mha_wgmma_kernel<MW_ONLINE> (mha_wgmma.cuh), one launch.  The packed
// (B, N, 3D) qkv tensor and the (B, H, N, Dh) layout are both read by
// strides, through 4-D TMA maps; the output is written as (B, N, H, Dh), so
// the packed path's merge of the heads is a view.  The key block bk is part
// of the function (p is rounded to bf16 against the running max after each
// block) and is an argument, as in the JAX wrapper; the query tiling is
// not, and is the kernel's own (128 rows a block).
//
// What bounds it on the H100: at ViT-B/16 @1024 px batch 1 (12 heads, 4097
// tokens, head dim 64) one launch does 4 * 12 * 4097^2 * 64 = 51.6 GFLOP
// against 25 MB of compulsory traffic, so it is bound by tensor-core
// operations (52 us at 989 TFLOP/s, 700 W), beside 12 * 4097^2 = 201 M
// exponentials (~48 us at the special-function units' 16 a clock per SM).
// At the per-block path's bk = 128 the online mode issues only those two
// products per key tile (the exact mode of K7 issues three) and one
// exponential per score, the softmax of one tile running beside the
// previous tile's p v; at bk 512 each block's q k^T runs twice (its max
// first), as the function's block max needs.
//
// In f32 (vft_flash_attention_f32, ViT-B/16 @896 and @1024 f32 and the
// per-tensor int8 forward at 1024 px): seq_attn.cuh's SF_ONLINE mode, true
// f32 fma on the CUDA cores, one pass over 64-key tiles with a running max
// and sum.  Bound there: 51.6 GFLOP at 67 TFLOP/s, 0.77 ms at @1024 b1.

#define VFT_NS flash_attn
#include "common.cuh"
#include "hopper.cuh"
#include "mha_wgmma.cuh"
#include "seq_attn.cuh"

using namespace VFT_NS;

extern "C" {

// Finds the driver's cuTensorMapEncodeTiled and opts the kernel in to its
// shared memory on the current device.  Called once per device before the
// first launch.  Returns a cudaError_t.
int vft_flash_init() {
  cudaError_t err = tma_init();
  if (err != cudaSuccess) return err;
  if ((err = mha_wgmma_enable<MW_ONLINE>()) != cudaSuccess) return err;
  return seq_attn_f32_enable<64, SF_ONLINE>();
}

// q, k, v: bf16, element (b, h, r, c) at b * in_b + h * in_h + r * in_r + c
// (c < 64; base addresses and strides multiples of 16 bytes, as TMA reads
// them); o likewise with the out_* strides.  Keys at or past n_valid are
// masked; bk (a multiple of 128) is the key block.  Enqueued on `stream`,
// which belongs to the current device.  Returns a cudaError_t.
int vft_flash_attention(const void* q, const void* k, const void* v, void* o, long long in_b,
                        long long in_h, int in_r, long long out_b, long long out_h, int out_r,
                        int batch, int heads, int n, int n_valid, int bk, float scale,
                        void* stream) {
  if (tma_encoder() == nullptr) return cudaErrorInitializationError;
  if (n < 1 || n_valid < 1 || n_valid > n || batch < 1 || heads < 1) return cudaErrorInvalidValue;
  MwMaps m;
  if (!mw_encode(&m.q, q, in_b, in_h, in_r, n, heads, batch) ||
      !mw_encode(&m.k, k, in_b, in_h, in_r, n_valid, heads, batch) ||
      !mw_encode(&m.v, v, in_b, in_h, in_r, n_valid, heads, batch))
    return cudaErrorInvalidValue;
  const MhaTmaArgs p{o, out_b, out_h, out_r, heads, n, n_valid, scale * 1.4426950408889634f,
                     scale, bk};
  return launch_mha_wgmma<MW_ONLINE>(m, p, batch, reinterpret_cast<cudaStream_t>(stream));
}

// The f32 mode: q, k, v and o f32 with the same strides (multiples of 4
// elements, base addresses 16-byte aligned); seq_attn.cuh's SF_ONLINE mode,
// true f32 fma on the CUDA cores.  In f32 the key blocks change only the
// order of the rounding (p is not rounded), so the kernel takes no bk: its
// own 64-key tiles carry the running max.  Returns a cudaError_t.
int vft_flash_attention_f32(const void* q, const void* k, const void* v, void* o,
                            long long in_b, long long in_h, int in_r, long long out_b,
                            long long out_h, int out_r, int batch, int heads, int n, int n_valid,
                            float scale, void* stream) {
  const SeqAttnArgs p{q, k, v, o, in_b, in_h, in_r, out_b, out_h, out_r, heads, n, n_valid, scale};
  return launch_seq_attn_f32<64, SF_ONLINE>(p, batch, reinterpret_cast<cudaStream_t>(stream));
}

}  // extern "C"
