// Device pieces of the single-launch whole-model forwards (vit_full.cu K12,
// vit_full_int8.cu K20); include after stack.cuh.
//
//   Patches      the NHWC image and its patch grid: token row t of image b
//                is zero for t = 0 (the CLS row, whose embedding is all in
//                posb) and t >= n_tok (the padding rows), else patch t - 1
//                of the row-major grid, pixels in (py, px, c) order: the
//                JAX package's patchify with one zero prefix row and zero
//                tail rows, read straight from the image.
//   patch_chunk  8 consecutive columns of such a row as f32 values of
//                bf16(image) (the JAX forwards' images.astype(bfloat16)).
//
// The heads split the (padded) classes into HEAD_COLS-column items over
// the whole grid: at batch 1 the head is 1.5 MB of bf16 weights (0.8 MB
// int8) for 1-4 rows, a weight stream like every other stage.

#pragma once

namespace VFT_NS {

constexpr int FULL_MAX_BATCH = 4;
constexpr int HEAD_COLS = 8;     // one 16-byte bf16 (8-byte int8) weight load
constexpr int FULL_MAX_P3 = 2 * 8 * SK_THREADS;  // the gate of the first, block-a-row gather

struct Patches {
  const void* img;  // (B, H, W, 3) f32 or bf16
  int img_f32;
  int h, w, patch, gw, n_tok, p3;
};

__device__ __forceinline__ void patch_chunk(const Patches& g, int b, int t, int c, float* f) {
  if (t < 1 || t >= g.n_tok) {
#pragma unroll
    for (int e = 0; e < 8; ++e) f[e] = 0.0f;
    return;
  }
  const int pi = t - 1, py = pi / g.gw, px = pi % g.gw;
  const int rowlen = 3 * g.patch;  // one pixel row of a patch, (px, c)
  const size_t base = ((size_t)b * g.h + (size_t)py * g.patch) * g.w + (size_t)px * g.patch;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int k = c + e, i = k / rowlen, r = k - i * rowlen;
    const size_t idx = (base + (size_t)i * g.w) * 3 + r;
    f[e] = g.img_f32 ? bf16_round(__ldg(static_cast<const float*>(g.img) + idx))
                     : __bfloat162float(static_cast<const bf16*>(g.img)[idx]);
  }
}

// The image geometry checks of both entry points: 16 | p3 (whole mma
// fragments of the embed GEMM) up to FULL_MAX_P3, a whole patch grid, and
// one CLS row before the patches.
inline bool patches_ok(int img_h, int img_w, int patch, int n_tok) {
  if (patch < 1 || img_h % patch || img_w % patch) return false;
  const int p3 = 3 * patch * patch;
  return p3 % 16 == 0 && p3 <= FULL_MAX_P3 && n_tok == 1 + (img_h / patch) * (img_w / patch);
}

inline Patches make_patches(const void* img, int img_f32, int img_h, int img_w, int patch,
                            int n_tok) {
  return Patches{img, img_f32, img_h, img_w, patch, img_w / patch, n_tok, 3 * patch * patch};
}

}  // namespace VFT_NS
