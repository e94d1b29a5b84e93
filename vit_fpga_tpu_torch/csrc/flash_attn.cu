// Blockwise (flash) attention on Hopper (sm_90a): the attention that
// _block runs where the attention half does not fit and the sequence has
// 1024 tokens or more (ViT-B/16 and ViT-S/16 at 1024 px, 4097 tokens), in
// bf16 and in the dynamic int8 forward's per-linear route.
//
// Replaces vit_fpga_tpu/ops/flash_attention.py:_flash_kernel (wrapper
// flash_attention, reached through attention.py:_mha_qkv_flash_impl):
// seq_attn_kernel (seq_attn.cuh), one launch.  The packed (B, N, 3D)
// qkv tensor and the (B, H, N, Dh) layout are both read by strides; the
// output is written as (B, N, H, Dh), so the packed path's merge of the
// heads is a view.  The key block bk is part of the function (p is rounded
// to bf16 against the running max after each block) and is an argument, as
// in the JAX wrapper; the query tiling is not, and is the kernel's own.
//
// What bounds it on the H100: at ViT-B/16 @1024 px batch 1 (12 heads, 4097
// tokens, head dim 64) one launch does 4 * 12 * 4097^2 * 64 = 51.6 GFLOP
// against 25 MB of compulsory traffic, so it is bound by tensor-core
// operations (52 us at 989 TFLOP/s, 700 W).  The scores and probabilities
// never leave registers; the keys and values stream through shared memory
// in 128-key cp.async tiles on mma.sync (wgmma and TMA are later work).

#define VFT_NS flash_attn
#include "common.cuh"
#include "seq_attn.cuh"

using namespace VFT_NS;

extern "C" {

// Opts the kernel in to its shared memory on the current device.  Called
// once per device before the first launch.  Returns a cudaError_t.
int vft_flash_init() { return seq_attn_enable(); }

// q, k, v: bf16, element (b, h, r, c) at b * in_b + h * in_h + r * in_r + c
// (c < 64, every row 16-byte aligned); o likewise with the out_* strides.
// Keys at or past n_valid are masked; bk (a multiple of 128) is the key
// block.  Enqueued on `stream`, which belongs to the current device.
// Returns a cudaError_t.
int vft_flash_attention(const void* q, const void* k, const void* v, void* o, long long in_b,
                        long long in_h, int in_r, long long out_b, long long out_h, int out_r,
                        int batch, int heads, int n, int n_valid, int bk, float scale,
                        void* stream) {
  SeqAttnArgs p{q, k, v, o, in_b, in_h, in_r, out_b, out_h, out_r, heads, n, n_valid, bk, scale};
  return launch_seq_attn(p, batch, reinterpret_cast<cudaStream_t>(stream));
}

}  // extern "C"
