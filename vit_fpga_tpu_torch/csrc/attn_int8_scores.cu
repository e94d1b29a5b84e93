// Calibrated static-scale int8 attention half with int8 scores on Hopper
// (sm_90a), the static int8 serving path's attention under the int8-scores
// switch.
//
// Replaces vit_fpga_tpu/ops/quant_block.py:_attn_int8s_static_kernel (wrapper
// attn_block_int8_static_scores, attention loop _mha_loop_int8s in
// vit_fpga_tpu/ops/attn_block.py), one Pallas kernel on the TPU.  The
// calibrated scales arrive folded (models/quantized._fold_static_scales):
// ls, lb carry 1/a_x; sqkv and bqkv the quant-domain panel scales (a_x /
// s_q | s_k | s_v per third); so carries a_ao; sdq = s_q s_k / sqrt(dh)
// dequantizes the scores and pv_fold = s_v / 127 / s_ao lands the attention
// output in the out-projection's quant domain.  Four launches on one
// stream, counted as one ported kernel:
//
//   (a) quant_rows<LN_ONE_PASS, STATIC>  xq = clip(rint(LN(x)), -127, 127)
//   (b) qgemm<EPI_Q8>   qkv8 = clip(rint(float(xq wqkvq) * sqkv + bqkv)): the
//                       q | k | v panel in int8 (act none, scale 1.0)
//   (c) attn_s8_kernel  per (head, image), one 16-row query tile per warp:
//                       s = float(q k^T) * sdq (mma.sync m16n8k32 s8 x s8 ->
//                       s32, K = dh = 64), e = exp(clip(s, -70, 80)) with
//                       keys at or past n_valid at 0, r = 1 / sum(e) (a true
//                       division), pq = clip(rint(e * (127 * r)), 0, 127) as
//                       int8, pv = pq v (the same mma, K = the keys padded to
//                       32; pq >= 0 against signed v), aoq = clip(rint(
//                       float(pv) * pv_fold)) from the f32 ao, never bf16
//   (d) qgemm<EPI_RESID> out = x + bf16(float(aoq woq) * so + bo)
//
// What bounds it on the H100: at ViT-B/16 batch 64 (R = 12 800 rows,
// D = 768, 12 heads of 64, n_valid 197) 8·R·D² = 60.4 G int8 operations
// plus 4·B·H·n_pad·n_valid·dh = 7.8 G int8 operations of attention (34 us
// at 1979 TOPS) against about 42 MB of compulsory traffic (13 us): bound by
// tensor-core operations.  Design: a simple tile.  The block stages the
// head's keys [key][dh] and values transposed [dh][key] in shared memory
// (zero past n_valid), so both products read their B fragments as 32-bit
// words; the scores and the int8 probabilities share one f32 row buffer
// per warp; the scale, clip, mask, exp, row sum and p-quant run between
// the two products.  The TPU's head pairing is a layout of its 128-lane
// tiles and has no counterpart here.  qkv8 and aoq round-trip through
// device memory (later work: keep them on chip, wgmma).

#define VFT_NS attn_int8_scores
#include "common.cuh"
#include "quant.cuh"

namespace VFT_NS {

constexpr int S8_WARPS = 8;
constexpr int S8_THREADS = S8_WARPS * 32;
constexpr int S8_DH = 64;
constexpr int S8_MAX_KV = 256;    // keys per (image, head): 8 per lane in the softmax

// Shared memory: K [kv32][ldk] and V^T [dh][ldv] int8, then per warp a
// [16][lds] f32 score buffer whose rows the int8 probabilities overwrite
// (row r of pq at the start of row r of the scores).
struct S8Smem {
  int ldk, ldv, lds;
  size_t v_off, w_off, w_bytes, bytes;
};

__host__ __device__ inline S8Smem s8_smem(int kv32) {
  S8Smem m;
  m.ldk = S8_DH + 16;       // bytes; 20 words: the 8 fragment rows hit distinct banks
  m.ldv = kv32 + 16;        // bytes
  m.lds = kv32 + 4;         // f32 elements
  m.v_off = round128((size_t)kv32 * m.ldk);
  m.w_off = m.v_off + round128((size_t)S8_DH * m.ldv);
  m.w_bytes = round128((size_t)16 * m.lds * 4);
  m.bytes = m.w_off + S8_WARPS * m.w_bytes;
  return m;
}

__device__ __forceinline__ unsigned ld_s32(const signed char* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

// qkv8: (B * n_pad, 3D) int8, q | k | v column blocks, head h at h * 64.
// aoq: (B * n_pad, D) int8.  One block per (head, image); warp w takes the
// 16-row query tiles w, w + 8, ...
__global__ void __launch_bounds__(S8_THREADS)
    attn_s8_kernel(const signed char* __restrict__ qkv8, signed char* __restrict__ aoq,
                   int n_pad, int n_valid, int kv32, int d, float sdq, float pv_fold) {
  extern __shared__ __align__(128) unsigned char smem[];
  const S8Smem L = s8_smem(kv32);
  signed char* Ks = reinterpret_cast<signed char*>(smem);
  signed char* Vt = reinterpret_cast<signed char*>(smem + L.v_off);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;   // fragment row group
  const int tg = lane & 3;   // thread in group
  float* S = reinterpret_cast<float*>(smem + L.w_off + warp * L.w_bytes);
  const int ldp = 4 * L.lds;  // bytes per row of pq (a score row's bytes)

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const size_t ld3 = 3 * (size_t)d;
  const signed char* base = qkv8 + (size_t)b * n_pad * ld3 + h * S8_DH;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  // K rows as they are, V transposed; keys past n_valid zero-filled.
  for (int c = tid; c < kv32 * 4; c += S8_THREADS) {
    const int r = c % kv32, cc = c / kv32;
    uint4 kv = zero, vv = zero;
    if (r < n_valid) {
      const signed char* row = base + (size_t)r * ld3 + cc * 16;
      kv = *reinterpret_cast<const uint4*>(row + d);
      vv = *reinterpret_cast<const uint4*>(row + 2 * d);
    }
    *reinterpret_cast<uint4*>(Ks + r * L.ldk + cc * 16) = kv;
    const signed char* vb = reinterpret_cast<const signed char*>(&vv);
#pragma unroll
    for (int t = 0; t < 16; ++t) Vt[(cc * 16 + t) * L.ldv + r] = vb[t];
  }
  __syncthreads();

  const int nqt = (n_pad + 15) / 16;
  for (int qt = warp; qt < nqt; qt += S8_WARPS) {
    const int q0 = qt * 16;
    // q's A fragments (16 x 64 int8, 2 k-steps of 32), straight from memory
    unsigned qa[2][4];
    const bool ok0 = q0 + g < n_pad, ok1 = q0 + g + 8 < n_pad;
    const signed char* r0 = base + (size_t)(q0 + g) * ld3 + tg * 4;
    const signed char* r1 = r0 + 8 * ld3;
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      qa[kk][0] = ok0 ? __ldg(reinterpret_cast<const unsigned*>(r0 + kk * 32)) : 0u;
      qa[kk][1] = ok1 ? __ldg(reinterpret_cast<const unsigned*>(r1 + kk * 32)) : 0u;
      qa[kk][2] = ok0 ? __ldg(reinterpret_cast<const unsigned*>(r0 + kk * 32 + 16)) : 0u;
      qa[kk][3] = ok1 ? __ldg(reinterpret_cast<const unsigned*>(r1 + kk * 32 + 16)) : 0u;
    }

    // s = float(q k^T) * sdq, 8 keys at a time
    for (int j = 0; j < kv32 / 8; ++j) {
      int acc[4] = {0, 0, 0, 0};
      const signed char* kb = Ks + (j * 8 + g) * L.ldk + tg * 4;
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
        mma_s8(acc, qa[kk], ld_s32(kb + kk * 32), ld_s32(kb + kk * 32 + 16));
      const int c = j * 8 + tg * 2;
      S[g * L.lds + c] = __fmul_rn((float)acc[0], sdq);
      S[g * L.lds + c + 1] = __fmul_rn((float)acc[1], sdq);
      S[(g + 8) * L.lds + c] = __fmul_rn((float)acc[2], sdq);
      S[(g + 8) * L.lds + c + 1] = __fmul_rn((float)acc[3], sdq);
    }
    __syncwarp();

    // e, r = 1 / sum(e) over the valid keys, pq; a row's scores are all in
    // registers before its int8 probabilities are written over them.
    for (int r = 0; r < 16; ++r) {
      const float* srow = S + r * L.lds;
      float e[S8_MAX_KV / 32];
      float sum = 0.0f;
#pragma unroll
      for (int i = 0; i < S8_MAX_KV / 32; ++i) {
        const int c = lane + 32 * i;
        float v = 0.0f;
        if (c < n_valid) v = expf(fminf(fmaxf(srow[c], -70.0f), 80.0f));
        e[i] = v;
        sum += v;
      }
      sum = warp_sum(sum);
      const float p127 = __fmul_rn(127.0f, __fdiv_rn(1.0f, sum));
      __syncwarp();
      signed char* prow = reinterpret_cast<signed char*>(S) + r * ldp;
#pragma unroll
      for (int i = 0; i < S8_MAX_KV / 32; ++i) {
        const int c = lane + 32 * i;
        if (c < kv32)
          prow[c] = static_cast<signed char>(
              static_cast<int>(fminf(fmaxf(rintf(__fmul_rn(e[i], p127)), 0.0f), 127.0f)));
      }
    }
    __syncwarp();

    // pv = pq v (s32), dh in 8 tiles of 8 columns
    int o[S8_DH / 8][4];
#pragma unroll
    for (int j = 0; j < S8_DH / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0;
    const signed char* P = reinterpret_cast<const signed char*>(S);
    for (int kk = 0; kk < kv32 / 32; ++kk) {
      unsigned pa[4];
      const signed char* pr = P + g * ldp + kk * 32 + tg * 4;
      pa[0] = ld_s32(pr);
      pa[1] = ld_s32(pr + 8 * ldp);
      pa[2] = ld_s32(pr + 16);
      pa[3] = ld_s32(pr + 8 * ldp + 16);
#pragma unroll
      for (int j = 0; j < S8_DH / 8; ++j) {
        const signed char* vb = Vt + (j * 8 + g) * L.ldv + kk * 32 + tg * 4;
        mma_s8(o[j], pa, ld_s32(vb), ld_s32(vb + 16));
      }
    }

    // aoq = clip(rint(float(pv) * pv_fold)), two neighbouring columns a lane
#pragma unroll
    for (int j = 0; j < S8_DH / 8; ++j) {
      const int col = h * S8_DH + j * 8 + tg * 2;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int q = q0 + g + 8 * half;
        if (q >= n_pad) continue;
        const unsigned char lo = static_cast<unsigned char>(
            rint_sat(__fmul_rn((float)o[j][2 * half], pv_fold)));
        const unsigned char hi = static_cast<unsigned char>(
            rint_sat(__fmul_rn((float)o[j][2 * half + 1], pv_fold)));
        *reinterpret_cast<unsigned short*>(aoq + ((size_t)b * n_pad + q) * d + col) =
            static_cast<unsigned short>(lo | (hi << 8));
      }
    }
    __syncwarp();  // the next tile reuses S
  }
}

}  // namespace VFT_NS

using namespace VFT_NS;

extern "C" {

// Opts this unit's kernels in to the shared memory they may use, on the
// current device.  Called once per device before the first launch.
// Returns a cudaError_t.
int vft_attn_int8_scores_init() {
  cudaError_t err = qgemm_enable<EPI_Q8>();
  if (err != cudaSuccess) return err;
  if ((err = qgemm_enable<EPI_RESID>()) != cudaSuccess) return err;
  return cudaFuncSetAttribute(attn_s8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)s8_smem(S8_MAX_KV).bytes);
}

// x, out: (B * n_pad, D) bf16; ls, lb, so, bo: (D,) f32; wqkv: (3D, D) int8
// (the (D, 3D) weight transposed); sqkv, bqkv: (3D,) f32, the quant-domain
// panel scales; wo: (D, D) int8 (transposed).  Scratch: q8 (B * n_pad, D)
// int8 (xq, then aoq), qkv8 (B * n_pad, 3D) int8.  Head dim 64,
// 1 <= n_valid <= min(n_pad, 256); sdq = sc_qk / sqrt(dh) and pv_fold the
// per-layer scalar dequants.  Everything is enqueued on `stream`, which
// belongs to the current device.  Returns a cudaError_t.
int vft_attn_block_int8_scores(const void* x, const void* ls, const void* lb, const void* wqkv,
                               const void* sqkv, const void* bqkv, const void* wo, const void* so,
                               const void* bo, void* out, void* q8, void* qkv8, int batch,
                               int n_pad, int d, int heads, int n_valid, float eps, float sdq,
                               float pv_fold, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int rows = batch * n_pad;
  const int kv32 = (n_valid + 31) / 32 * 32;
  if (d != heads * S8_DH || n_valid < 1 || n_valid > n_pad || kv32 > S8_MAX_KV)
    return cudaErrorInvalidValue;
  signed char* q = static_cast<signed char*>(q8);
  signed char* panel = static_cast<signed char*>(qkv8);
  cudaError_t err;
  if ((err = launch_quant_rows<bf16, LN_ONE_PASS, true>(
           static_cast<const bf16*>(x), static_cast<const float*>(ls),
           static_cast<const float*>(lb), q, nullptr, rows, d, eps, st)) != cudaSuccess)
    return err;

  QGemmArgs g{};
  g.A = q;
  g.B = static_cast<const signed char*>(wqkv);
  g.sb = static_cast<const float*>(sqkv);
  g.bias = static_cast<const float*>(bqkv);
  g.C = panel;
  g.M = rows;
  g.N = 3 * d;
  g.K = d;
  g.act = ACT_NONE;
  g.qscale = 1.0f;
  if ((err = launch_qgemm<EPI_Q8>(g, st)) != cudaSuccess) return err;

  attn_s8_kernel<<<dim3(heads, batch), S8_THREADS, s8_smem(kv32).bytes, st>>>(
      panel, q, n_pad, n_valid, kv32, d, sdq, pv_fold);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  QGemmArgs o{};
  o.A = q;
  o.B = static_cast<const signed char*>(wo);
  o.sb = static_cast<const float*>(so);
  o.bias = static_cast<const float*>(bo);
  o.residual = static_cast<const bf16*>(x);
  o.C = out;
  o.M = rows;
  o.N = d;
  o.K = d;
  if ((err = launch_qgemm<EPI_RESID>(o, st)) != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // extern "C"
