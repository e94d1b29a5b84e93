#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``vit_fpga_tpu_torch``).

Run from the repository root on a machine with one Hopper card:

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0):
  1. device   the card's name and power limit (nvidia-smi), Hopper check
  2. build    nvcc builds the kernels from vit_fpga_tpu_torch/csrc and
              prints ptxas's register and spill report
  3. parity   each kernel against its plain PyTorch version on the card
              at small shapes: elementwise, as a branch (out - x), the
              emitted stats, a case whose padding keys would swamp the
              output if unmasked, and the plain version run in f32
  4. path     each kernel at the serving shapes (ViT-B/16, batch 64):
              the same parity checks, then the kernel's time, the plain
              version's, a library yardstick's and the bound
  5. train kernels  K4, K5, K23 and K24 against their plain versions at
              b8 and at the training path's b64 shapes: K4 in both softmax
              modes, K5 and K24 with each activation, all seven outputs
              of each backward; a loud-padding case (huge padding rows,
              zero cotangent there) must leave every weight gradient
              unchanged; then each kernel's time, its plain version's,
              a library yardstick's and the bound at b64
  6. slice    ImageServer over make_forward(vit_b16, bf16) answers 160
              uint8 requests (2 full batches of 64 + 1 partial flush);
              logits of images from every batch are checked against
              the CPU forward, and K1 and K2 must have run 12 times per
              served batch
  7. safe     make_forward(vit_b16, bf16, safe_softmax) at b8 (the
              per-block K4 / K5 path) against the CPU forward
  8. train    one SGD step of vit_b16 bf16 at batch 4 on the card against
              the CPU plain path (loss, every gradient, every updated
              parameter); 10 Trainer (AdamW) steps on one fixed batch of
              64 (finite losses, the last below the first; 12 launches
              each of K4, K5, K23 and K24 per step and none of K1, K2);
              one SGD step of ViT-B/16 @384 (577 tokens) at batch 4 on the
              card against the CPU step the same way, 12 launches each of
              K4, K5, K23 and K24, K4's and K23's all counted past 256
              keys, and its ms per step; K23 timed at that shape; the b64
              SGD step's time, TFLOP/s and peak memory
  9. int8     the dynamic int8 kernels K14, K15 and K16 against their
              plain versions at b8 (every K14 mode, each K15 activation,
              and K16 with 59 loud padding rows that must leave the valid
              rows bit for bit as quiet ones do; this runs right after
              the build) and at the path's b64 shapes, with each kernel's
              time, its plain version's, a library yardstick's (LN +
              torch._int_mm + the quant and dequant torch ops) and the
              bound; ImageServer over make_forward_int8(vit_b16) answers
              160 uint8 requests, 12 launches each of K16 and K15 and one
              of K14 per batch and none of any bf16 kernel, logits within
              a band of the CPU plain int8 forward, top-1 agreement with
              the card's bf16 forward stated (the int8 and bf16 forwards'
              ms per b64 batch are timed in turns with the static one,
              phase 11)
 10. latency  the single-launch encoders K11 (vit_layers) and K19a
              (vit_layers_int8) against their plain versions at full
              ViT-B/16 width, b1 and b4, all rows: one layer elementwise,
              12 layers in norm, and 3 loud padding rows that must leave
              the valid rows bit for bit (this runs right after the
              build); their times at depth 12, b1 and b4, beside the plain
              version, a library yardstick (the 12 layers as PyTorch calls)
              and the bound; the latency forwards against the throughput
              forwards at b1, timed in turns; 64 requests, one at a time,
              through ImageServer(batch_size=1) over make_forward_latency
              (1 K11 launch per request) and make_forward_int8_latency (1
              K19a + 1 K14 per request), nothing else launched, p50/p99,
              logits against the CPU forward
 11. static int8  the calibrated static-scale path: quantize_vit_static's
              probe on the card against the same probe on the CPU; K17
              (mlp_block_int8_static) and K18 (attn_block_int8_static)
              against their plain versions at b8 (each K17 activation, K18
              with loud padding rows that must leave the valid rows bit for
              bit; right after the build) and at the b64 path shapes, each
              with a saturating case whose clipped share is printed and
              must be > 0, then their times beside the plain version, a
              library yardstick and the bound; K19b (vit_layers_int8_static)
              with the latency kernels at b1 and b4 (one layer elementwise,
              12 layers in norm, loud padding bit for bit) and its depth-12
              times; 160 requests through ImageServer over make_forward_int8
              on the static tree (12 K18 + 12 K17 + 1 K14 launches per
              batch, nothing else), logits against the CPU plain forward,
              top-1 against the card's bf16 and dynamic int8 forwards
              stated; the static, dynamic and bf16 forwards timed in turns
              at b64; 64 one-at-a-time requests through
              ImageServer(batch_size=1) over make_forward_int8_latency on
              the static tree (1 K19b + 1 K14 per request), and the static
              and dynamic latency forwards timed in turns at b1
 12. dense    the NetAbstract backend: K25 (filter_image_device) with each
              filter and K13 (int8_gemm) against their plain versions bit
              for bit (K25 also against filter_image_numpy) at 1080 x 1920,
              33 x 45, 1 x 1, 2160 x 3840, 1081 x 1920 (a ragged last
              strip), 1080 x 1921, 17 x 16, 1 x 4096, 4096 x 1 and a 1080 x
              1920 frame at storage offset 1, each with the chunk it took
              (16 bytes or 1), and at (10000, 784) x 256, (10000, 256) x 10,
              (12800, 768) x 3072, 1 x 1 x 1, and (since K13 runs on int8
              wgmma + TMA) at its tiles' edges (M 1 and 129, N 1, 3, 10 and
              1002 that no TMA store takes, N 8 and 128 on 128-wide tiles
              stored by TMA, K 1, 33 and 784), the per-tensor forward's
              (12608, 768) x 2304 and (12608, 3072) x 768, and all -128
              operands at K 3072, right after the build; their
              times beside the plain version, torch._int_mm / F.conv2d
              yardsticks and the bound (K25 at 1080p and 4K, the F.conv2d
              yardstick per call and device alone); NetCUDA 784 -> [256, 10] at batch
              10 000 against NetCPU (f32, bf16 in bands; int8 bit for bit
              the numpy oracle with 2 K13 launches per forward), 50 SGD
              steps against NetCPU's, get_net_data round trip, int8
              requantized after training; the 24-deep ring at 1080 x 1920:
              96 frames in bursts of 24 in FIFO order with metadata, each
              bit for bit the oracle, the 25th submit dropped, the empty
              sentinel, one K25 launch per frame, frames/s full ring
              against depth 1
 13. large    the large ViTs: K3 (fused_mlp_chunked_stats) against its
              plain version at (200, 128) x 512 and (9344, 1024) x 4096,
              2 and 4 chunks, and where a chunk ends inside the wgmma
              GEMM's 64-deep K step ((200, 128) x 192 in 2, (200, 128) x
              128 and (264, 1024) x 1152 in 4), each activation, both
              emit_stats, its
              distance from K2's plain version printed and required > 0;
              K1 past 256 keys (its key-tiled path) at (4, 264, 1024) with
              257 valid tokens, (2, 584, 1024) with 577 and (1, 1024, 768)
              with 1024, loud padding bit for bit, a peaked-scores case in
              norm (all this right after the build, with the gates: K3 with
              3 chunks and K1 at 1032 tokens raise); K3 and K1 times at
              CLIP-L/14 b64 and ViT-L/16 (b64, @384 b16), K3's per call
              and device alone; ImageServer over
              clip.make_forward(CLIP ViT-L/14 @224, depth 24) answers 160
              requests with 24 K1 (key-tiled) + 24 K3 per batch and nothing
              else, embeddings against the card's plain forward (all) and
              the CPU forward (2); CLIP-L/14 b128 (24 K2, no K3) and
              ViT-L/16 @384 b16 (24 key-tiled K1 + 24 K3) against the card's
              plain forward, DeiT-B/16 b64 and CLIP-B/16 forward_latency b1
              (1 K11) against the CPU; CLIP-L/14 b64, ViT-L/16 b64 and
              ViT-L/16 @384 b16 forwards timed in turns
 14. full     the whole model in one launch: K12 (vit_full) and K20
              (vit_full_int8) against their plain versions at ViT-B/16
              width (224 px, 197 tokens, 1000 classes), b1 and b4: one
              layer (K12 elementwise, K20 within its logits band beside
              the floor of two right implementations), 12 layers in norm
              and of the largest logit, ViT-B/32's 3072-value patches at
              depth 2, and the gates (batch 5, a 588-value patch, an f32
              model raise; right after the build); their depth-12 times at
              b1 and b4 beside the plain version, a library yardstick
              (F.conv2d, the stacks' PyTorch layers, the head) and the
              bound, and each kernel's stage clock; the separate-launch
              latency forwards against the single-launch ones, b1 and b4,
              in turns, p50 / max of five 32-call loops and device launches
              per request; 64 one-at-a-time requests through
              ImageServer(batch_size=1) over make_forward_latency(full=True)
              and make_forward_int8_latency(full=True), exactly one K12 (or
              K20) launch a request and nothing else of the port, logits
              against the CPU forward; the entry points raise at batch 5
 15. per-block  the path past the fused attention half: K9
              (flash_attention), K7 (mha_qkv_pallas), K8 (mha_pallas) and
              K6 (fused_mlp_chunked) against their plain versions (this
              runs first, right after the build): K9 and K7 on ViT-B/16
              @1024's packed (1, 4104, 2304) qkv with 4097 valid keys, K9
              also at bk 512 and 1100 tokens and (since K9 is the online
              mode of mha_wgmma.cuh) with keys that grow along the sequence,
              so that the running max rises in later key blocks, at bk 128,
              384 and 512, 512 / 513 and 1024 / 1025 valid, K7 in f32 at
              the per-tensor path's (64, 197, 2304), K8 in bf16 and f32,
              loud padding keys that must leave the valid rows bit for
              bit, the bf16 K7 / K8 (wgmma + TMA) at one partial tile
              (17, 64 tokens), at a key tile's edge (127-129 valid of
              200), at 224 px and (3, 12, 300, 64), also in norm, and
              into views of a loud buffer whose other rows and heads must
              not change, the f32 K7 / K8
              (one pass, register-tiled) at 1, 63, 64, 65, 197 valid of
              200, 577 of 584 and (1, 2, 1100, 64), K6 (K3's two wgmma
              launches after a row pass) at ViT-L's and ViT-H's MLP shapes
              in 2 and 4 chunks and at (1000, 1024) x 4096 against its
              plain version and away from K5's function, the gates; their times beside the
              plain version, scaled_dot_product_attention (K6: LN + addmm +
              GELU) and the bound; then ImageServer(image_size=1024,
              batch_size=2) over make_forward(vit_b16 @1024) answers 6 uint8
              requests with 12 K9 + 12 K5 per batch and nothing else (logits
              against the card's plain forward and the CPU's), the same
              requests through make_forward_int8 (49 K14 + 12 K9 per batch),
              the per-tensor int8 forward at 224 px b64 (12 K7 in f32 + 50
              K13, against the CPU), attn_impl="pallas" at 1024 px (12 K7),
              mlp_impl="pallas" on ViT-L/16 with safe_softmax (24 K4 + 24
              K6), attention.mha "pallas" / "flash" (1 K8, 1 K9); the bf16
              and int8 1024 px forwards at b1 and b4 timed in turns
 16. int8 chain  the reference's two gated int8 paths, whose module
              switches stay off by default: K21b (attn_block_int8_stats),
              K21a (mlp_block_int8_stats) and K22
              (attn_block_int8_static_scores) against their plain versions
              at b8 (this runs first, right after the build) and at the b64
              path shapes: K21b and K21a on stats that are not x's own, f32
              (both emit_stats) and bf16, the emitted stats against those of
              the kernel's own output, K21a with every activation at b8; K22
              quiet and saturating (clipped shares printed, > 0); K21b and
              K22 with 59 loud padding rows that must leave the valid rows
              bit for bit; their times beside the plain version, a library
              yardstick and the bound; then with _INT8_STATS_CHAIN on
              ImageServer over make_forward_int8(vit_b16) on the dynamic
              tree answers 160 uint8 requests with 12 K21b + 12 K21a + 1 K14
              per batch and nothing else, and with _INT8_SCORES on the same
              requests on the static tree with 12 K22 + 12 K17 + 1 K14
              (logits against the CPU forward with the switch on, top-1
              against the switch-off forward printed); the switch-on and
              switch-off b64 forwards timed in turns
 17. odd batches past 256 keys, K10, K26  K4 (attn_block_fwd) past 256
              keys against its plain version at the odd-batch serves'
              shapes (CLIP ViT-L/14 b1 (1, 264, 1024) with 257 valid keys,
              ViT-B/16 @384 (1, 584, 768) and ViT-L/16 @384 (1, 584, 1024)
              with 577), in both softmax modes, counted past 256 keys,
              loud padding rows that must leave the valid rows bit for
              bit, and in the exact mode scores past exp's f32 range; K10
              (patch_embed_pallas) at ViT-B/16 and CLIP ViT-L/14 b64 and
              the JAX test's shape, K26 (streamed_gemm) at the JAX tests'
              shapes, ViT-L/16 @384's MLP up-projection and the wgmma
              tiles' edges (200, 520) x (520, 328) in bf16, each against
              its plain version in the f32 sum-order band; K4's gate (1032
              tokens raise); all this runs first,
              right after the build; their times beside the plain
              version, a library call and the bound (K26 and its library
              call also device alone; K10 also beside the
              main path's embed_tokens_dotg); then ImageServer(batch_size=
              1) over clip.make_forward(CLIP ViT-L/14) and
              vit.make_forward(ViT-B/16 @384) answers 3 uint8 requests
              each with exactly 24 K4 (or 12 K4 + 12 K5) launches a
              request, all past 256 keys, and make_forward(ViT-L/16
              @384, safe_softmax) at b1 launches 24 K4 in the exact mode; their
              ms per request beside b2 through the chain, then every
              output against the CPU forward
 18. wgmma K1 / K2 / K5  right after the build, ptxas's report must hold
              no wgmma serialisation note (C7513-C7515) and a report of
              each wgmma kernel (the GEMM, the attention, K23's two); then
              K2 and K5
              on gemm_wgmma.cuh against their plain versions at (1000,
              776) x 3104 (row, K and N tails of the tiles), K2 at ViT-L's
              (1600, 1024) x 4096, K5 at (264, 1024) x 4096 and (4104,
              768) x 3072, each activation, and K1 (its GEMMs and the
              max-free one-pass attention of mha_wgmma.cuh) at (5, 200,
              704) with 11 heads and 1, 127, 128, 129 and 200 valid keys;
              this runs first, before every other phase's parity
 19. wgmma K4 / K24  right after phase 17's parity: K4 (K1's sequence
              after a row pass; the safe softmax a third mode of
              mha_wgmma.cuh) in the safe mode on scores past the max-free
              clip at 197 of 200 keys, and on flat tokens, whose output at
              255 valid keys must equal the one at 128 bit for bit (a
              probability rounded after normalising moves it); K24 (its
              five products on gemm_wgmma.cuh's backward layouts) at 8 x
              197 rows with each activation, all seven gradients, and
              twice on the same inputs, bit for bit (split-K partials
              added in a fixed order)
 20. wgmma K23  right after phase 17's parity: K23 (its five products on
              gemm_wgmma.cuh; its attention backward two wgmma + TMA kernels,
              one per 128 query rows for ao, dq and the rows' softmax
              values, one per 128 keys for dk and dv) against its plain
              version, all seven gradients, past 256 keys (CLIP ViT-L/14's
              (2, 264, 1024) with 16 heads and 257 valid, ViT-B/16 @384's
              (2, 584, 768) with 577, (1, 1024, 768) with 1024) and at the
              tiles' edges (127, 128, 129 valid of 200; 17 tokens), each
              counted past 256 keys where it has more valid keys and run
              twice bit for bit; loud padding rows at 584 tokens that must
              leave every weight, bias and LN gradient unchanged; the gate
              (1032 tokens raise)
 21. int8 past 256 keys  right after phase 9's K16 checks: K16 (its
              QKV and out-projection on qgemm_wgmma.cuh, a bf16
              qkv epilogue and the residual one, its attention
              mha_wgmma.cuh's max-free sweep, which streams the keys)
              against its plain version past 256 keys at (4, 584, 768)
              with 577 valid keys and (2, 1032, 768) with 1025, all rows
              in the int8 band; 7 loud padding rows at 577 valid that must
              leave the valid rows bit for bit; the gate (ViT-B/16 @1024's
              4097 tokens, past the JAX int8 plan, and head dim 96 raise);
              phase 16's K21a (on K15's launches) also at T 1601
              and (600, 400) x 1552 with the absmax in the partial last
              column tile; at the end K16's time at (16, 584, 768) beside
              its plain version, SDPA's yardstick and the bound, then
              ImageServer over make_forward_int8(ViT-B/16 @384) on the
              dynamic tree answers 6 uint8 requests at batch 4 with 12 K16
              + 12 K15 + 1 K14 launches a batch and nothing else, logits
              against the CPU plain forward in the int8 band; the int8 and
              bf16 @384 b16 forwards timed in turns
 22. static / chain past 256 keys  right after phase 21's parity: K18
              and K21b (on K16's launches) at phase 21's shapes, quiet and
              saturating, on foreign stats, loud padding bit for bit, the
              gates; at the end their times at (16, 584, 768), the static
              tree and the chain served at ViT-B/16 @384
 23. K17 / K22 on qgemm_wgmma.cuh  right after phase 16's parity: K17
              (both GEMMs on qgemm_wgmma.cuh, W1 with its int8 epilogue
              QW_Q8) at its tiles' edges ((1000, 784) x 3104, T 1601) with
              each activation and saturating; K22 (the QKV panel by QW_Q8,
              a V^T pass, an int8 wgmma + TMA attention in two sweeps over
              the keys, the out-projection) past 256 keys at (4, 584, 768)
              with 577 valid and (2, 1032, 768) with 1025, quiet and
              saturating, FLIP_ROWS' allowance; loud padding at 577 bit
              for bit; the gate (ViT-B/16 @896's 3137 tokens, head dim 80,
              11 heads raise); ptxas's report must show no spill in any
              qgemm_wgmma_kernel or K22 attention instantiation; at the end
              K22's time at (16, 584, 768) beside its plain version, its
              library call and the bound, then ImageServer over
              make_forward_int8(ViT-B/16 @384) on the static tree with
              _INT8_SCORES on answers 6 uint8 requests at batch 4 with 12
              K22 + 12 K17 + 1 K14 launches a batch and nothing else,
              logits against the CPU plain forward in the int8 band
 26. lifecycle  right after the build: device_prefetch's batches each
              whole the moment they arrive (3 pinned 256 MB batches), and
              the default-config gradient at ViT-B/16 b8 (the stats chain
              and its VJP) against the CPU's, 12 K1 + 12 K2 and no K23 /
              K24; at the end an HF ViT-B/16 checkpoint (1000 classes)
              through import_hf_vit and make_forward b64 against the CPU
              (equal top-1) and reloaded from .npz bit for bit; Trainer b16
              fed by HostLoader + device_prefetch, saved after step 2 and
              resumed, losses and params bit for bit; CLIP ViT-L/14 int8
              b64 dynamic / static and CLIP ViT-B/16 int8 latency b1 / b4
              against the CPU; CLIP training (2 SGD steps, the full text
              tower) against the CPU; cli serve / calibrate; their times
 27. ViT-H/14  right after the build: K4, K23, K16 and K18 at head dim 80
              (mha_wgmma.cuh's two boxes a row) against their plain
              versions at ViT-H/14's shapes, each beside the same kernel at
              20 heads of 64 on the same inputs: K4 (64 / 1, 264, 1280)
              both modes, loud padding, wide scores; K23 (8, 264, 1280);
              K16 and K18 (64, 264, 1280) quiet and saturating, loud
              padding at b4; K4 and K23 at (1, 40, 160) and (2, 136, 160);
              K15 and K17 at (16 896, 1280) x 5120; head dim 96 raises at
              the four, 80 at K1; at the end ImageServer over make_forward
              (ViT-H/14 @224, depth 32) answers 128 uint8 requests at b64,
              32 K4 a batch and nothing else; make_forward_int8 on the
              dynamic and static trees at depth 32 (32 K16 + 32 K15 + 1
              K14, 32 K18 + 32 K17 + 1 K14); each forward at depth 4 b64
              against the CPU on 4 rows; the four kernels' times at dh 80
              and 64; the three b64 forwards in turns; Trainer (AdamW) 3
              steps at b8, depth 32 (32 K4 + 32 K23 a step), and one SGD
              step at depth 2 b4 against the CPU
 28. f32      after phase 27: K1, K2 / K3, K4 and K9 in their true-f32
              modes (FMA on the CUDA cores) against their plain versions
              with TF32 off, each element within K26's f32 sum band carried
              through the stages (outside it, within that band of the same
              arithmetic in f64): K1 at ViT-B/16 b64, hot logits (scores
              past 80, where the max-free and exact softmaxes part),
              @640's 1601 tokens and ViT-S/16 b64 with its stats; K3 at
              (12 800, 768) x 3072 in 2 chunks and each activation in 4;
              K2 at ViT-S/16 b64 and each activation; K4 at b1 / b3 both
              modes, b64 safe, hot logits, ViT-L/16 and ViT-H/14 (head dim
              80); K9 at ViT-B/16 @1024 and @896; loud padding bit for
              bit; the gates (K1 at @768 and K4 at @896 raise, K5, K6,
              K23, K24 and K9 at head dim 80 raise naming themselves);
              then ImageServer over make_forward(vit_b16, float32) answers
              160 uint8 requests with 12 K1 + 12 K3 in f32 a batch and no
              bf16 launch, logits against the CPU f32 forward in
              F32_LOGITS_BAND; ViT-B/16 b1 (12 K4), @1024 b1 depth 2 (2
              K9), the per-tensor int8 forward @1024 b1 depth 2 (2 K9 + 10
              K13), ViT-H/14 depth 2 b2 (2 K4 at head dim 80) and ViT-S/16
              depth 2 b64 (2 K1 + 2 K2), each against the CPU; the f32
              kernels' times beside the bf16 kernel at the same shape
              (device alone, in turns), the plain version, the f32
              library call and the bound at 67 TFLOP/s; the b64 forward in
              f32 and bf16 in turns
Then one JSON line per the kernels, and the device line last.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

H100_BF16_FLOPS = 989e12      # dense tensor-core peak, H100 SXM data sheet
H100_INT8_OPS = 1979e12       # dense int8 tensor-core peak, same sheet
H100_HBM_BYTES_PER_S = 3.35e12
H100_F32_FLOPS = 67e12        # f32 outside the tensor cores, same sheet

EPS = 1e-6
# bf16 kernel vs plain version, same inputs and rounding points: only
# the f32 accumulation order differs, which flips an occasional bf16 ulp
# (2^-8 relative) that later products spread: |a-b| <= 2^-6 (1 + |b|).
BF16_TOL = 2.0 ** -6
# The branch y = out - x, kernel vs plain, as ||dy|| / ||y||.  The residual
# hides y from the elementwise check; the ulp flips above move y by a few
# 1e-3 in norm, while a wrong mask or softmax moves all of it (11 unmasked
# zero keys among 197 shift the attention branch by about 5%).
BRANCH_TOL = 1e-2
# Emitted stats vs the plain stats of the kernel's own output: the same
# f32 sums of 768 terms in another order, |error| <= 768 * 2^-24 = 4.6e-5
# of the sum of magnitudes.
STATS_RTOL, STATS_ATOL = 1e-4, 5e-5
# bf16 kernel vs the plain version in f32: the bf16 rounding band.
F32_BAND = 0.05
# logits of the bf16 forward on the card vs on the CPU, relative to the
# largest logit: 12 layers of ulp flips.
LOGITS_BAND = 0.05
# f32 weight, bias and LN gradients, kernel vs plain, in relative norm:
# sums over up to 12 800 rows in another order, of products that carry
# the bf16 ulp flips above.
GRAD_RTOL = 1e-2
# Weight gradients with loud padding rows vs quiet ones: padding keys are
# masked and padding rows get a zero cotangent, so every term they add is
# an exact zero; "unchanged" at f32 resolution.
LOUD_RTOL = 1e-6
# One training step of the bf16 model, card vs CPU, relative to each
# quantity's norm: the ulp flips of LOGITS_BAND through a forward and a
# backward twice as long.
STEP_LOSS_BAND = 1e-2
STEP_BAND = 0.1
TRAIN_LR = 3e-4          # the Trainer's (and the JAX Trainer's) default
# Int8 kernel vs plain version: both quantize the same rows, sum the int8
# products exactly and dequantize in the same order; only the order of the
# f32 LN sums (and tanh's and exp's last ulp) differs.  That moves a row's
# scale by an ulp, which flips a bf16 rounding now and then (BF16_TOL, as
# for the bf16 kernels), and on rare elements moves an activation's rint
# by one step: the output then moves by one quantization step of the last
# GEMM, s_r * 127 * ws_n (the row scale of its int8 input times the
# column's largest weight).  Band: BF16_TOL (1 + |b|) + INT8_STEPS steps.
# The static kernels (K17, K18, K19b) quantize at a fixed scale, so a flip
# moves bf16(y) by its own ulp whatever the row's magnitude; where x and y
# cancel that exceeds 2^-6 |b| (K18 at b64: 3.125e-2 at |b| < 1 once in
# 9.8M elements), so their elementwise term is BF16_TOL (1 + |b| + |x|).
INT8_STEPS = 2
# The int8 forward on the card vs the CPU plain int8 forward from the same
# weights, relative to the largest logit.  A rint flip moves an element by
# a whole quantization step, and the attention carries flips from every
# token into the CLS row, layer after layer: two right implementations
# that differ only in the order of f32 sums end some 3-5% apart at 12
# layers.  The slice prints that floor (the plain versions on the card vs
# on the CPU) beside the kernels' gap; the band is twice the largest such
# gap read.  A wrong kernel moves every layer by far more (the mutation
# copies: elementwise errors of 0.5 in one half).
INT8_LOGITS_BAND = 0.1
# The single-launch encoders (K11, K19a) against their plain versions: one
# layer is held elementwise in the bands above; all 12 layers in relative
# norm, since a flipped ulp (or rint) of one layer moves the next layer's
# row scales and the attention spreads it over every row of the image.  A
# wrong stage moves every layer by far more: the key mask removed or h
# quantized with one tile's absmax moves a single layer's branch by tens
# of percent (PR 1-3's mutation copies).
STACK_BF16_NORM = 2e-2
STACK_INT8_NORM = 5e-2
# The static scales' probe on the card against the same probe on the CPU
# (bf16 activations, f32 sums in another order): a bf16 ulp flip moves an
# absmax by up to 2^-8 relative and later layers carry it; 2e-2 relative,
# the CPU tests' band against the JAX probe.
CALIB_BAND = 2e-2
# The saturating cases calibrate every static scale on half the range the
# data reaches, so the top of each quantized tensor clips at +-127.
SHRINK = 2.0


def _gen(seed: int) -> torch.Generator:
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def _randn(gen, *shape, std=1.0, mean=0.0, device="cuda"):
    return (torch.randn(shape, generator=gen) * std + mean).to(device)


def _smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, stdout=subprocess.PIPE, text=True, timeout=60)
    return res.stdout.strip().splitlines()[0]


def _compare(name, got, want, rtol, atol, mag=None):
    """max abs / max relative error; raise if |a-b| > atol + rtol * mag,
    where mag is |b| unless given."""
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    ref = w.abs() if mag is None else mag
    bad = int((diff > atol + rtol * ref).sum())
    max_abs = float(diff.max())
    max_rel = max_abs / max(float(w.abs().max()), 1e-30)
    what = "|b|" if mag is None else "(|b| + |g|)"
    print(f"  {name}: max_abs={max_abs:.3e} max_rel={max_rel:.3e} "
          f"(tol |a-b| <= {atol:g} + {rtol:g}{what}, violations={bad})")
    if bad or not torch.isfinite(g).all():
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version")
    return max_abs


# ---------------------------------------------------------------------------
# Kernel inputs at a given shape (seeded, on the card)
# ---------------------------------------------------------------------------

def _attn_inputs(batch, n_pad, d, seed, dtype=torch.bfloat16):
    from vit_fpga_tpu_torch.ops.common import row_stats
    g = _gen(seed)
    x = _randn(g, batch, n_pad, d).to(dtype)
    p = dict(ln_scale=_randn(g, d, std=0.1, mean=1.0),
             ln_bias=_randn(g, d, std=0.1),
             wqkv=_randn(g, d, 3 * d, std=0.06),
             bqkv=_randn(g, 3 * d, std=0.02),
             wo=_randn(g, d, d, std=0.02),
             bo=_randn(g, d, std=0.02))
    return x, row_stats(x, EPS), p


def _mlp_inputs(rows, d, m, seed, dtype=torch.bfloat16):
    from vit_fpga_tpu_torch.ops.common import row_stats
    g = _gen(seed)
    x = _randn(g, rows, d).to(dtype)
    p = dict(ln_scale=_randn(g, d, std=0.1, mean=1.0),
             ln_bias=_randn(g, d, std=0.1),
             w1=_randn(g, d, m, std=d ** -0.5),
             b1=_randn(g, m, std=0.02),
             w2=_randn(g, m, d, std=m ** -0.5),
             b2=_randn(g, d, std=0.02))
    return x, row_stats(x, EPS), p


def _bf16_weights(p, names):
    return {k: (v.to(torch.bfloat16) if k in names else v)
            for k, v in p.items()}


def _attn_call(fn, x, st, p, heads, n_valid, emit):
    return fn(x, st, p["ln_scale"], p["ln_bias"], p["wqkv"], p["bqkv"],
              p["wo"], p["bo"], heads, eps=EPS, n_valid=n_valid,
              emit_stats=emit)


def _mlp_call(fn, x, st, p, emit):
    return fn(x, st, p["ln_scale"], p["ln_bias"], p["w1"], p["b1"], p["w2"],
              p["b2"], eps=EPS, act="gelu_tanh", emit_stats=emit)


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def _branch(name, got, want, x):
    """Norm-wise relative error of the branch ``out - x``, kernel vs
    plain; raise if above BRANCH_TOL."""
    xf = x.float()
    g, w = got.float() - xf, want.float() - xf
    rel = float((g - w).norm() / w.norm())
    print(f"  {name}: |d branch| / |branch| = {rel:.3e} (tol {BRANCH_TOL:g})")
    if not rel <= BRANCH_TOL:
        raise AssertionError(f"{name}: kernel's branch disagrees with its "
                             f"plain version")


def _parity(label, call, kernel, plain, x, rows=(...,)):
    """Kernel vs plain version on the same inputs, for both values of
    ``emit_stats``: the output (on ``rows``) elementwise and as a branch,
    and the emitted stats against the plain stats of the kernel's own
    output.  Returns the largest max-abs error of the output."""
    from vit_fpga_tpu_torch.ops.common import row_stats
    worst = 0.0
    for emit in (True, False):
        got, got_st = call(kernel, emit)
        want, _ = call(plain, emit)
        torch.cuda.synchronize()
        g, w, xr = got[rows], want[rows], x[rows]
        worst = max(worst, _compare(f"{label} out emit_stats={emit}", g, w,
                                    BF16_TOL, BF16_TOL))
        _branch(f"{label} branch emit_stats={emit}", g, w, xr)
        if emit:
            _compare(f"{label} stats vs stats of its out", got_st,
                     row_stats(got, EPS), STATS_RTOL, STATS_ATOL)
        elif got_st is not None:
            raise AssertionError(f"{label}: emit_stats=False returned stats")
    return worst


def phase_parity():
    """Kernels against their plain versions at small shapes: b8 covers a
    partial 128-row GEMM tile, the first two K1 cases the key mask, and
    the f32 plain version the bf16 band."""
    from vit_fpga_tpu_torch.ops import attn_block as ab
    from vit_fpga_tpu_torch.ops import fused_mlp as fm
    heads, n_valid = 12, 197
    x, st, p = _attn_inputs(8, 200, 768, seed=1)
    pb = _bf16_weights(p, ("wqkv", "wo"))
    print("parity K1 attn_block_stats (8, 200, 768), 12 heads, n_valid=197")
    # Loud padding: the padding rows' LayerNorm blown up ~30x, so their
    # keys reach the clip (exp(80)) against valid queries and any padding
    # key the kernel fails to mask swamps every valid row.  Padding query
    # rows are garbage by contract and stay out of the output checks.
    loud = st.clone()
    loud[:, n_valid:, 0] = 0.0
    loud[:, n_valid:, 1] = 30.0
    # Flat scores (q and k 10x smaller): every key weighs about the same,
    # so a key wrongly counted in the denominator moves the branch by
    # about 1/197.
    flat = dict(pb, wqkv=pb["wqkv"] * 0.1)
    for label, s, w, rows in (
            ("K1 loud padding", loud, pb, (slice(None), slice(0, n_valid))),
            ("K1 flat scores", st, flat, (...,)),
            ("K1", st, pb, (...,))):
        _parity(label, lambda fn, emit, s=s, w=w: _attn_call(
                    fn, x, s, w, heads, n_valid, emit),
                ab.attn_block_stats, ab.attn_block_stats_plain, x, rows)
    got, _ = _attn_call(ab.attn_block_stats, x, st, pb, heads, n_valid, True)
    want32, _ = _attn_call(ab.attn_block_stats_plain, x.float(), st, p,
                           heads, n_valid, True)
    _compare("K1 valid rows vs plain f32", got[:, :n_valid],
             want32[:, :n_valid], F32_BAND, F32_BAND)

    x, st, p = _mlp_inputs(1600, 768, 3072, seed=2)
    pb = _bf16_weights(p, ("w1", "w2"))
    print("parity K2 fused_mlp_stats (1600, 768) x 3072, gelu_tanh")
    _parity("K2", lambda fn, emit: _mlp_call(fn, x, st, pb, emit),
            fm.fused_mlp_stats, fm.fused_mlp_stats_plain, x)
    got, _ = _mlp_call(fm.fused_mlp_stats, x, st, pb, True)
    want32, _ = _mlp_call(fm.fused_mlp_stats_plain, x.float(), st, p, True)
    _compare("K2 rows vs plain f32", got, want32, F32_BAND, F32_BAND)


def _bound(flops, nbytes):
    t_ops = flops / H100_BF16_FLOPS * 1e3
    t_mem = nbytes / H100_HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_mem else (t_mem, "bytes")


def phase_path_shapes(batch=64, n_pad=200, n_valid=197, d=768, heads=12,
                      m=3072):
    """Each kernel at the serving shapes (ViT-B/16, batch 64): parity
    against its plain version on the same inputs, then times.  Returns
    {name: dict of max_abs_err and times}."""
    import torch.nn.functional as F
    from vit_fpga_tpu_torch.ops import attn_block as ab
    from vit_fpga_tpu_torch.ops import fused_mlp as fm
    from vit_fpga_tpu_torch.utils.timing import time_cuda
    out = {}
    rows, dh = batch * n_pad, d // heads

    x, st, p = _attn_inputs(batch, n_pad, d, seed=3)
    pb = _bf16_weights(p, ("wqkv", "wo"))
    print(f"parity K1 attn_block_stats ({batch}, {n_pad}, {d}) at the path's "
          f"shape")
    err = _parity(f"K1 b{batch}", lambda fn, emit: _attn_call(
        fn, x, st, pb, heads, n_valid, emit), ab.attn_block_stats,
        ab.attn_block_stats_plain, x)
    ms = time_cuda(lambda: _attn_call(ab.attn_block_stats, x, st, pb, heads,
                                      n_valid, True))
    plain_ms = time_cuda(lambda: _attn_call(ab.attn_block_stats_plain, x,
                                            st, pb, heads, n_valid, True),
                         iters=5, warmup=1)
    xn = torch.randn((rows, d), device="cuda").to(torch.bfloat16)
    x2 = x.reshape(rows, d)
    bq, bo = p["bqkv"].to(torch.bfloat16), p["bo"].to(torch.bfloat16)
    keep = (torch.arange(n_pad, device="cuda") < n_valid)[None, None, None]

    def library():
        qkv = torch.addmm(bq, xn, pb["wqkv"]).view(batch, n_pad, 3, heads,
                                                     dh)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        ao = F.scaled_dot_product_attention(q, k, v, attn_mask=keep)
        ao = ao.transpose(1, 2).reshape(rows, d)
        return torch.addmm(bo, ao, pb["wo"]) + x2

    lib_ms = time_cuda(library)
    flops = (2 * rows * d * 4 * d
             + 4 * batch * heads * n_pad * n_valid * dh)
    nbytes = (2 * rows * d * 2 + 2 * rows * 2 * 4
              + 4 * d * d * 2 + 6 * d * 4)
    bound_ms, bound_by = _bound(flops, nbytes)
    out["attn_block_stats"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                   library_ms=lib_ms, bound_ms=bound_ms,
                                   bound_by=bound_by)

    x, st, p = _mlp_inputs(rows, d, m, seed=4)
    pb = _bf16_weights(p, ("w1", "w2"))
    print(f"parity K2 fused_mlp_stats ({rows}, {d}) x {m} at the path's "
          f"shape")
    err = _parity(f"K2 b{batch}", lambda fn, emit: _mlp_call(fn, x, st, pb, emit),
                  fm.fused_mlp_stats, fm.fused_mlp_stats_plain, x)
    ms = time_cuda(lambda: _mlp_call(fm.fused_mlp_stats, x, st, pb, True))
    plain_ms = time_cuda(lambda: _mlp_call(fm.fused_mlp_stats_plain, x, st,
                                           pb, True), iters=5, warmup=1)
    xn = torch.randn((rows, d), device="cuda").to(torch.bfloat16)
    b1, b2 = p["b1"].to(torch.bfloat16), p["b2"].to(torch.bfloat16)

    def library():
        h = F.gelu(torch.addmm(b1, xn, pb["w1"]), approximate="tanh")
        return torch.addmm(b2, h, pb["w2"]) + x

    lib_ms = time_cuda(library)
    flops = 4 * rows * d * m
    nbytes = (2 * rows * d * 2 + 2 * rows * 2 * 4 + 2 * d * m * 2
              + (m + 3 * d) * 4)
    bound_ms, bound_by = _bound(flops, nbytes)
    out["fused_mlp_stats"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                  library_ms=lib_ms, bound_ms=bound_ms,
                                  bound_by=bound_by)
    for name, t in out.items():
        print(f"timing {name} b{batch}: kernel {t['ms']:.4f} ms, plain "
              f"{t['plain_ms']:.4f} ms, library {t['library_ms']:.4f} ms, "
              f"bound {t['bound_ms']:.4f} ms ({t['bound_by']})")
    return out


def _relnorm(name, got, want, tol):
    """||a - b|| / ||b||; raise if above ``tol`` or not finite."""
    g, w = got.float(), want.float()
    rel = float((g - w).norm() / w.norm().clamp_min(1e-30))
    print(f"  {name}: |a-b|/|b| = {rel:.3e} (tol {tol:g})")
    if not rel <= tol or not torch.isfinite(g).all():
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version")
    return rel


ATTN_GRADS = ("dx", "dls", "dlb", "dwqkv", "dbqkv", "dwo", "dbo")
MLP_GRADS = ("dx", "dls", "dlb", "dw1", "db1", "dw2", "db2")
MLP_ACTS = ("gelu_tanh", "quick_gelu", "relu")


def _grads_parity(label, names, got, want, g, step_act=False, referee=None):
    """dx elementwise and its branch dx - g in relative norm, the f32
    gradients in relative norm; returns dx's max-abs error.

    dx = bf16(g + dx_ln) adds the LayerNorm backward to the cotangent g,
    so an error of dx_ln scales with the terms, not with their sum: where
    they cancel, |dx| is small and the elementwise band is taken relative
    to |b| + |g|.  With ``step_act`` (relu) dx is held in relative norm
    only: relu' is a step, and where h lies within f32 rounding of 0 the
    kernel and the plain version (summing in another order) take
    different sides, which moves a whole row of dx by da_j * W1[:, j] (a
    handful of rows at b8, each far outside the elementwise band).

    ``referee`` (K23's phase 20) returns dx from the plain version's
    arithmetic with every sum in f64: an element of dx outside the band
    of the plain version must then lie inside the same band of that
    version.  The plain version's f32 sums round a bf16 intermediate
    (an element of dq, dk or dv in the tens, whose ulp is 2^-4) the
    other way now and then, and dxn = dqkv Wqkv^T carries such a flip
    into a whole row; the f64 sums settle which rounding the function
    gives."""
    torch.cuda.synchronize()
    gf = g.float()
    if step_act:
        _relnorm(f"{label} dx", got[0], want[0], GRAD_RTOL)
        err = float((got[0].float() - want[0].float()).abs().max())
    elif referee is not None:
        a, b = got[0].float(), want[0].float()
        out = (a - b).abs() > BF16_TOL * (1 + b.abs() + gf.abs())
        err = float((a - b).abs().max())
        print(f"  {label} dx: max_abs={err:.3e}, {int(out.sum())} of "
              f"{out.numel()} elements outside |a-b| <= {BF16_TOL:g} (1 + "
              f"|b| + |g|)")
        if out.any():
            ref = referee().float()
            band = BF16_TOL * (1 + ref.abs() + gf.abs())
            still = int((out & ((a - ref).abs() > band)).sum())
            own = int(((b - ref).abs() > band).sum())
            print(f"  {label} dx against the plain arithmetic summed in "
                  f"f64: {still} of those outside its band (must be 0; the "
                  f"plain version's own f32 sums: {own} elements)")
            if still:
                raise AssertionError(f"{label} dx: kernel disagrees with its "
                                     f"plain version")
    else:
        err = _compare(f"{label} dx", got[0], want[0], BF16_TOL, BF16_TOL,
                       mag=want[0].float().abs() + gf.abs())
    _relnorm(f"{label} dx branch (dx - g)", got[0].float() - gf,
             want[0].float() - gf, GRAD_RTOL)
    for n, a, b in zip(names[1:], got[1:], want[1:]):
        _relnorm(f"{label} {n}", a, b, GRAD_RTOL)
    return err


def _train_inputs(batch, n_pad, n_valid, d, m, seed, loud=False):
    """Inputs of both halves at one shape: x (batch, n_pad, d) bf16 and a
    cotangent g (zero on the padding rows when ``loud``, whose x rows
    then carry a huge spike)."""
    x, _, pa = _attn_inputs(batch, n_pad, d, seed)
    _, _, pm = _mlp_inputs(8, d, m, seed + 1)
    g = _randn(_gen(seed + 2), batch, n_pad, d).to(torch.bfloat16)
    if loud:
        x = x.clone()
        x[:, n_valid:, 3] = 3e3
        g[:, n_valid:] = 0.0
    return x, g, pa, pm


def _k4(fn, x, pa, heads, n_valid, safe):
    return fn(x, pa["ln_scale"], pa["ln_bias"], pa["wqkv"], pa["bqkv"],
              pa["wo"], pa["bo"], heads, eps=EPS, n_valid=n_valid,
              safe_softmax=safe)


def _k23(fn, x, g, pa, heads, n_valid):
    return fn(x, pa["ln_scale"], pa["ln_bias"], pa["wqkv"], pa["bqkv"],
              pa["wo"], g, heads, eps=EPS, n_valid=n_valid)


def _k5(fn, x2, pm, act):
    return fn(x2, pm["ln_scale"], pm["ln_bias"], pm["w1"], pm["b1"],
              pm["w2"], pm["b2"], eps=EPS, act=act)


def _k24(fn, x2, g2, pm, act):
    return fn(x2, pm["ln_scale"], pm["ln_bias"], pm["w1"], pm["b1"],
              pm["w2"], g2, eps=EPS, act=act)


def phase_train_kernels(batch, n_pad=200, n_valid=197, d=768, heads=12,
                        m=3072, loud=False):
    """K4, K5, K23 and K24 against their plain versions at one shape.
    Returns {kernel name: largest max-abs error of its bf16 output}."""
    from vit_fpga_tpu_torch.ops import attn_block as ab
    from vit_fpga_tpu_torch.ops import fused_mlp as fm
    x, g, pa, pm = _train_inputs(batch, n_pad, n_valid, d, m, seed=5 + batch)
    rows = batch * n_pad
    x2, g2 = x.reshape(rows, d), g.reshape(rows, d)
    worst = {"attn_block_fwd": 0.0, "attn_block_bwd": 0.0,
             "fused_mlp_fwd": 0.0, "fused_mlp_bwd": 0.0}
    print(f"parity K4 / K23 attn_block ({batch}, {n_pad}, {d}), {heads} "
          f"heads, n_valid={n_valid}")
    for safe in (True, False):
        got = _k4(ab.attn_block_fwd, x, pa, heads, n_valid, safe)
        want = _k4(ab.attn_block_fwd_plain, x, pa, heads, n_valid, safe)
        torch.cuda.synchronize()
        label = f"K4 b{batch} safe_softmax={safe}"
        worst["attn_block_fwd"] = max(worst["attn_block_fwd"], _compare(
            f"{label} out", got, want, BF16_TOL, BF16_TOL))
        _branch(f"{label} branch", got, want, x)
    worst["attn_block_bwd"] = _grads_parity(
        f"K23 b{batch}", ATTN_GRADS,
        _k23(ab.attn_block_bwd, x, g, pa, heads, n_valid),
        _k23(ab.attn_block_bwd_plain, x, g, pa, heads, n_valid), g)
    print(f"parity K5 / K24 fused_mlp ({rows}, {d}) x {m}")
    for act in MLP_ACTS:
        got = _k5(fm.fused_mlp_fwd, x2, pm, act)
        want = _k5(fm.fused_mlp_xla, x2, pm, act)
        torch.cuda.synchronize()
        label = f"K5 b{batch} {act}"
        worst["fused_mlp_fwd"] = max(worst["fused_mlp_fwd"], _compare(
            f"{label} out", got, want, BF16_TOL, BF16_TOL))
        _branch(f"{label} branch", got, want, x2)
        worst["fused_mlp_bwd"] = max(worst["fused_mlp_bwd"], _grads_parity(
            f"K24 b{batch} {act}", MLP_GRADS,
            _k24(fm.fused_mlp_bwd, x2, g2, pm, act),
            _k24(fm.fused_mlp_bwd_plain, x2, g2, pm, act), g2,
            step_act=act == "relu"))
    return worst


def phase_loud_padding(batch=8, n_pad=200, n_valid=197, d=768, heads=12,
                       m=3072):
    """Huge spikes in x's rows at or past n_valid and a zero cotangent
    there: K23 and K24 against their plain versions on those inputs, and
    every weight, bias and LN gradient (and dx on the valid rows) against
    the kernel's own on quiet padding rows."""
    from vit_fpga_tpu_torch.ops import attn_block as ab
    from vit_fpga_tpu_torch.ops import fused_mlp as fm
    runs = []
    for loud in (False, True):
        x, g, pa, pm = _train_inputs(batch, n_pad, n_valid, d, m, seed=40,
                                     loud=loud)
        if not loud:       # quiet: the same cotangent, zero on padding rows
            g[:, n_valid:] = 0.0
        rows = batch * n_pad
        runs.append((x, g, pa, pm, rows))
    print(f"loud padding: spikes of 3e3 in rows {n_valid}..{n_pad - 1}, "
          f"zero cotangent there, b{batch}")
    (xq, gq, pa, pm, rows), (xl, gl, _, _, _) = runs
    quiet = _k23(ab.attn_block_bwd, xq, gq, pa, heads, n_valid)
    loud = _k23(ab.attn_block_bwd, xl, gl, pa, heads, n_valid)
    _grads_parity("K23 loud padding", ATTN_GRADS, loud,
                  _k23(ab.attn_block_bwd_plain, xl, gl, pa, heads, n_valid),
                  gl)
    for n, a, b in zip(ATTN_GRADS[1:], loud[1:], quiet[1:]):
        _relnorm(f"K23 loud vs quiet {n}", a, b, LOUD_RTOL)
    _relnorm("K23 loud vs quiet dx (valid rows)", loud[0][:, :n_valid],
             quiet[0][:, :n_valid], LOUD_RTOL)
    for act in MLP_ACTS:
        q2 = _k24(fm.fused_mlp_bwd, xq.reshape(rows, d), gq.reshape(rows, d),
                  pm, act)
        l2 = _k24(fm.fused_mlp_bwd, xl.reshape(rows, d), gl.reshape(rows, d),
                  pm, act)
        _grads_parity(f"K24 loud padding {act}", MLP_GRADS, l2, _k24(
            fm.fused_mlp_bwd_plain, xl.reshape(rows, d), gl.reshape(rows, d),
            pm, act), gl.reshape(rows, d), step_act=act == "relu")
        for n, a, b in zip(MLP_GRADS[1:], l2[1:], q2[1:]):
            _relnorm(f"K24 {act} loud vs quiet {n}", a, b, LOUD_RTOL)


# K4's safe mode with every token of an image alike: each of n keys then
# has e = 1, and ao = bf16((n v) / n) = v whatever n is (v is a bf16 value
# and sum e is n within f32 rounding), so the output at 255 valid keys
# must equal the one at 128 bit for bit.  (Not the max-free mode: there e
# = exp(s scale) is not a bf16 value, and sum e's f32 rounding moves ao's
# bf16 rounding with n.)  255 is the key count below
# 257 whose bf16(1 / n) is furthest from 1 / n (255 bf16(1/255) = 1.0039):
# probabilities rounded after normalising (K7's p = bf16(e / sum e), not
# K4's function) move nearly every element of ao by one bf16 step there,
# and by none at 128 = 2^7.
K4_FLAT_KEYS = (128, 255)


def phase_train_edges(batch=8, n_pad=200, n_valid=197, d=768, heads=12,
                      m=3072):
    """K4 and K24 where the redesigned kernels have edges: K4's safe mode on
    wide scores at 197 of 200 keys (past the max-free clip at 80; held in
    norm and finite, as phase 17's cases past 256 keys) and on flat tokens
    at K4_FLAT_KEYS (bit for bit), K24 at 8 x 197 rows (not a
    multiple of the 128-row tiles or the 64-row column-sum blocks; every
    activation, all seven gradients) and twice on the same inputs (bit for
    bit: every sum in a fixed order).  Returns {kernel name: largest
    max-abs error}."""
    from vit_fpga_tpu_torch.ops import attn_block as ab
    from vit_fpga_tpu_torch.ops import fused_mlp as fm
    x, _, pa = _attn_inputs(batch, n_pad, d, seed=70)
    wide = dict(pa, wqkv=pa["wqkv"].clone())
    wide["wqkv"][:, :2 * d] *= K4_WIDE
    qkv = (x.float() - x.float().mean(-1, keepdim=True)) @ wide["wqkv"][:, :2 * d]
    s = qkv[0, :, :64] @ qkv[0, :n_valid, d:d + 64].T / 8.0
    name = f"K4 ({batch}, {n_pad}, {d}) n_valid={n_valid} safe_softmax=True"
    got = _k4(ab.attn_block_fwd, x, wide, heads, n_valid, True)
    want = _k4(ab.attn_block_fwd_plain, x, wide, heads, n_valid, True)
    torch.cuda.synchronize()
    k4 = float((got.float() - want.float()).abs().max())
    print(f"parity {name} wide scores (q, k x{K4_WIDE:g}; head 0's scores "
          f"reach about {float(s.abs().max()):.0f}): max_abs={k4:.3e} "
          f"(stated)")
    if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        raise AssertionError(f"{name} wide scores: not finite")
    _branch(f"{name} wide scores branch", got, want, x)

    flat_pad = max(K4_FLAT_KEYS)
    flat = _attn_inputs(batch, 1, d, seed=71)[0].expand(
        batch, flat_pad, d).contiguous()
    outs = [_k4(ab.attn_block_fwd, flat, pa, heads, n, True)
            for n in K4_FLAT_KEYS]
    want = _k4(ab.attn_block_fwd_plain, flat, pa, heads, K4_FLAT_KEYS[-1],
               True)
    torch.cuda.synchronize()
    label = f"K4 flat tokens ({batch}, {flat_pad}, {d}) safe_softmax=True"
    k4 = max(k4, _compare(f"{label} out at {K4_FLAT_KEYS[-1]} keys",
                          outs[-1], want, BF16_TOL, BF16_TOL))
    moved = int((outs[0] != outs[1]).sum())
    print(f"  {label}: {moved} elements differ between {K4_FLAT_KEYS[0]} "
          f"and {K4_FLAT_KEYS[1]} valid keys (must be 0)")
    if moved:
        raise AssertionError(f"{label}: the output depends on the key "
                             f"count")

    rows = batch * n_valid
    x2, g2, _, pm = _train_inputs(1, rows, rows, d, m, seed=72)
    x2, g2 = x2.reshape(rows, d), g2.reshape(rows, d)
    print(f"parity K24 fused_mlp_bwd ({rows}, {d}) x {m}")
    k24 = 0.0
    for act in MLP_ACTS:
        got = _k24(fm.fused_mlp_bwd, x2, g2, pm, act)
        k24 = max(k24, _grads_parity(
            f"K24 ({rows}, {d}) {act}", MLP_GRADS, got,
            _k24(fm.fused_mlp_bwd_plain, x2, g2, pm, act), g2,
            step_act=act == "relu"))
        again = _k24(fm.fused_mlp_bwd, x2, g2, pm, act)
        torch.cuda.synchronize()
        moved = [n for n, a, b in zip(MLP_GRADS, got, again)
                 if not torch.equal(a, b)]
        print(f"  K24 ({rows}, {d}) {act} twice on the same inputs: "
              f"outputs that differ {moved} (must be none)")
        if moved:
            raise AssertionError(f"K24 {act}: {moved} differ from run to "
                                 f"run")
    return {"attn_block_fwd": k4, "fused_mlp_bwd": k24}


def phase_train_timing(batch=64, n_pad=200, n_valid=197, d=768, heads=12,
                       m=3072):
    """Times at the training path's b64 shapes: each kernel, its plain
    version, a library yardstick (LN + addmm + SDPA + addmm, LN + addmm +
    tanh-GELU + addmm, and the autograd backward of each) and the bound.
    Returns {name: dict of times}."""
    import torch.nn.functional as F
    from vit_fpga_tpu_torch.ops import attn_block as ab
    from vit_fpga_tpu_torch.ops import fused_mlp as fm
    from vit_fpga_tpu_torch.utils.timing import time_cuda
    x, g, pa, pm = _train_inputs(batch, n_pad, n_valid, d, m, seed=60)
    rows, dh, act = batch * n_pad, d // heads, "gelu_tanh"
    x2, g2 = x.reshape(rows, d), g.reshape(rows, d)
    bf = torch.bfloat16
    keep = (torch.arange(n_pad, device="cuda") < n_valid)[None, None, None]

    def leaves(p, names):
        return [p[k].to(bf).detach().requires_grad_(True) for k in names]

    a_leaves = [x.detach().requires_grad_(True)] + leaves(
        pa, ("ln_scale", "ln_bias", "wqkv", "bqkv", "wo", "bo"))
    m_leaves = [x2.detach().requires_grad_(True)] + leaves(
        pm, ("ln_scale", "ln_bias", "w1", "b1", "w2", "b2"))

    def lib_attn(xx, ls, lb, wqkv, bqkv, wo, bo):
        h = F.layer_norm(xx, (d,), ls, lb, EPS).reshape(rows, d)
        qkv = torch.addmm(bqkv, h, wqkv).view(batch, n_pad, 3, heads, dh)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        ao = F.scaled_dot_product_attention(q, k, v, attn_mask=keep)
        ao = ao.transpose(1, 2).reshape(rows, d)
        return (torch.addmm(bo, ao, wo) + xx.reshape(rows, d)).view_as(xx)

    def lib_mlp(xx, ls, lb, w1, b1, w2, b2):
        h = F.layer_norm(xx, (d,), ls, lb, EPS)
        h = F.gelu(torch.addmm(b1, h, w1), approximate="tanh")
        return torch.addmm(b2, h, w2) + xx

    with torch.enable_grad():
        a_out = lib_attn(*a_leaves)
        m_out = lib_mlp(*m_leaves)
    attn_proj = 8 * rows * d * d
    score = 4 * batch * heads * n_pad * n_valid * dh
    act_bytes = rows * d * 2                 # one (rows, d) bf16 tensor
    cases = {
        "attn_block_fwd": (
            lambda: _k4(ab.attn_block_fwd, x, pa, heads, n_valid, True),
            lambda: _k4(ab.attn_block_fwd_plain, x, pa, heads, n_valid, True),
            lambda: lib_attn(*a_leaves),
            attn_proj + score, 2 * act_bytes + 4 * d * d * 2 + 7 * d * 4),
        "fused_mlp_fwd": (
            lambda: _k5(fm.fused_mlp_fwd, x2, pm, act),
            lambda: _k5(fm.fused_mlp_xla, x2, pm, act),
            lambda: lib_mlp(*m_leaves),
            4 * rows * d * m, 2 * act_bytes + 2 * d * m * 2 + (m + 3 * d) * 4),
        "attn_block_bwd": (
            lambda: _k23(ab.attn_block_bwd, x, g, pa, heads, n_valid),
            lambda: _k23(ab.attn_block_bwd_plain, x, g, pa, heads, n_valid),
            lambda: torch.autograd.grad(a_out, a_leaves, g,
                                        retain_graph=True),
            22 * rows * d * d + 3 * score,
            3 * act_bytes + 4 * d * d * (2 + 4) + (5 + 6) * d * 4),
        "fused_mlp_bwd": (
            lambda: _k24(fm.fused_mlp_bwd, x2, g2, pm, act),
            lambda: _k24(fm.fused_mlp_bwd_plain, x2, g2, pm, act),
            lambda: torch.autograd.grad(m_out, m_leaves, g2,
                                        retain_graph=True),
            10 * rows * d * m,
            3 * act_bytes + 2 * d * m * (2 + 4) + (2 * m + 4 * d) * 4),
    }
    out = {}
    for name, (kern, plain, lib, flops, nbytes) in cases.items():
        ms = time_cuda(kern)
        plain_ms = time_cuda(plain, iters=5, warmup=1)
        lib_ms = time_cuda(lib)
        bound_ms, bound_by = _bound(flops, nbytes)
        out[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=bound_ms, bound_by=bound_by)
        print(f"timing {name} b{batch}: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, library {lib_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}, {flops / 1e9:.1f} GFLOP, "
              f"{nbytes / 1e6:.1f} MB)")
    return out


def _tree_to(tree, device):
    """A copy of a parameter tree on ``device``."""
    return {k: (_tree_to(v, device) if isinstance(v, dict)
                else v.detach().to(device, copy=True))
            for k, v in tree.items()}


def phase_slice(n_images=160, batch=64):
    from vit_fpga_tpu_torch.models import vit
    from vit_fpga_tpu_torch.ops import attn_block as ab
    from vit_fpga_tpu_torch.ops import fused_mlp as fm
    from vit_fpga_tpu_torch.runtime.serving import ImageServer
    from vit_fpga_tpu_torch.utils.log import Metrics

    cfg = vit.config("vit_b16", dtype="bfloat16")
    params = vit.init_params(cfg, _gen(0), device="cuda")
    fwd = vit.make_forward(cfg, params, raw=True)
    images = np.random.default_rng(0).integers(
        0, 256, (n_images, cfg.image_size, cfg.image_size, 3), np.uint8)
    fwd(images[:batch])                 # first launch: library loads, cuBLAS
    torch.cuda.synchronize()
    Metrics.reset()
    ab.attn_block_stats.launches = 0
    fm.fused_mlp_stats.launches = 0
    t0 = time.perf_counter()
    with ImageServer(fwd, image_size=cfg.image_size,
                     batch_size=batch) as server:
        futs = [server.submit_raw(img) for img in images]
        results = [f.result(timeout=600) for f in futs]
        wall = time.perf_counter() - t0
        pct = server.latency_percentiles()
    launches = {"attn_block_stats": ab.attn_block_stats.launches,
                "fused_mlp_stats": fm.fused_mlp_stats.launches}
    print(f"slice: {len(results)}/{n_images} answered in {server.batches} "
          f"batches, {wall:.3f} s, {n_images / wall:.1f} img/s, "
          f"p50 {pct['p50']:.2f} ms, p99 {pct['p99']:.2f} ms")
    print(f"slice launches: {launches}")
    if len(results) != n_images or server.served != n_images:
        raise AssertionError("not every request was answered")
    for r in results:
        if r.shape != (cfg.num_classes,) or not np.isfinite(r).all():
            raise AssertionError(f"bad logits row: shape {r.shape}")
    for name, n in launches.items():
        if n != cfg.depth * server.batches:
            raise AssertionError(f"{name} launched {n} times for "
                                 f"{server.batches} batches")

    cpu_fwd = vit.make_forward(cfg, _tree_to(params, "cpu"), raw=True,
                               device="cpu")
    # first and last of each batch, the partial one included
    idx = [0, batch - 1, batch, 2 * batch - 1, 2 * batch, n_images - 1]
    ref = cpu_fwd(images[idx]).numpy()
    got = np.stack([results[i] for i in idx])
    rel = float(np.abs(got - ref).max() / np.abs(ref).max())
    print(f"slice logits of images {idx} vs CPU plain forward: "
          f"max_rel={rel:.3e} (band {LOGITS_BAND})")
    if not rel <= LOGITS_BAND:
        raise AssertionError("card logits disagree with the CPU forward")
    return launches


def phase_safe_forward(batch=8):
    """make_forward(safe_softmax) on the card (K4 / K5 per block) against
    the CPU forward."""
    import dataclasses
    from vit_fpga_tpu_torch.models import vit
    cfg = dataclasses.replace(vit.config("vit_b16", dtype="bfloat16"),
                              safe_softmax=True)
    params = vit.init_params(cfg, _gen(1), device="cpu")
    images = np.random.default_rng(1).integers(
        0, 256, (batch, cfg.image_size, cfg.image_size, 3), np.uint8)
    got = vit.make_forward(cfg, _tree_to(params, "cuda"))(images)
    got = got.cpu().numpy()
    want = vit.make_forward(cfg, params, device="cpu")(images).numpy()
    rel = float(np.abs(got - want).max() / np.abs(want).max())
    print(f"safe_softmax forward b{batch} vs CPU: max_rel={rel:.3e} "
          f"(band {LOGITS_BAND})")
    if not rel <= LOGITS_BAND or not np.isfinite(got).all():
        raise AssertionError("safe_softmax logits disagree with the CPU")


def _train_batch(cfg, batch, seed):
    from vit_fpga_tpu_torch.models import vit
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (batch, cfg.image_size, cfg.image_size, 3),
                          np.uint8)
    labels = rng.integers(0, cfg.num_classes, batch)
    return (vit.preprocess(torch.from_numpy(images), cfg).float(),
            torch.from_numpy(labels))


def phase_train_step_vs_cpu(batch=4, lr=0.1):
    """One SGD step of vit_b16 bf16 at ``batch`` on the card and on the
    CPU plain path from the same weights and data: the loss, every
    gradient and every updated parameter."""
    from vit_fpga_tpu_torch.models import vit
    _step_vs_cpu(vit.config("vit_b16", dtype="bfloat16"), batch, lr, seed=2)


def _step_vs_cpu(cfg, batch, lr, seed):
    """One SGD step of ``cfg`` at ``batch`` on the card and on the CPU
    plain path from the same weights and data: the loss, every gradient
    and every updated parameter.  Returns (the card's launches of each
    counted kernel in its step, K4's and K23's launches past 256 keys, the
    step function, the card's parameters, optimizer state, images and
    labels)."""
    from vit_fpga_tpu_torch.models import vit
    from vit_fpga_tpu_torch.ops import attn_block as ab
    from vit_fpga_tpu_torch.train import trainer as tr
    base = vit.init_params(cfg, _gen(seed), device="cpu")
    images, labels = _train_batch(cfg, batch, seed=seed)
    step = tr.make_vit_train_step(cfg)
    counters = _counters()
    res = {}
    for dev in ("cuda", "cpu"):
        params, opt = tr.init_train_state(cfg, tr.sgd(lr),
                                          params=_tree_to(base, dev))
        if dev == "cuda":
            card = (step, params, opt, images.cuda(), labels.cuda())
            for fn in counters.values():
                fn.launches = 0
            ab.attn_block_fwd.launches_long = 0
            ab.attn_block_bwd.launches_long = 0
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, images.to(dev), labels.to(dev))
        loss = float(m["loss"])
        if dev == "cuda":
            launches = {k: fn.launches for k, fn in counters.items()}
            long = (ab.attn_block_fwd.launches_long,
                    ab.attn_block_bwd.launches_long)
        leaves = tr.param_leaves(params)
        res[dev] = (loss, [p.grad.detach().float().cpu() for p in leaves],
                    [p.detach().float().cpu() for p in leaves])
        print(f"train step {cfg.image_size} px b{batch} on {dev}: loss "
              f"{loss:.6f} ({time.perf_counter() - t0:.1f} s)")
    (lc, gc, pc), (lh, gh, ph) = res["cuda"], res["cpu"]
    rel = abs(lc - lh) / abs(lh)
    print(f"  loss card vs CPU: rel {rel:.3e} (band {STEP_LOSS_BAND})")
    if not rel <= STEP_LOSS_BAND:
        raise AssertionError("card loss disagrees with the CPU step")
    names = _leaf_names(base)
    worst = 0.0
    for n, a, b in zip(names, gc, gh):
        worst = max(worst, _relnorm(f"grad {n}", a, b, STEP_BAND))
    for n, a, b in zip(names, pc, ph):
        _relnorm(f"param after step {n}", a, b, STEP_BAND)
    print(f"  worst gradient error {worst:.3e}")
    return (launches, long) + card


def phase_train_step_384(batch=4, lr=0.1, iters=3):
    """ViT-B/16 @384 (577 tokens on 584 rows), the training path past 256
    keys: one SGD step at ``batch`` on the card against the CPU plain step
    from the same weights and data (as phase 8's step at 224 px), exactly
    12 launches each of K4, K5, K24 and K23 in the card's step, those of K4
    and K23 all counted past 256 keys; then the card's ms per step.
    Returns (K23's launches past 256 keys, ms per step)."""
    from vit_fpga_tpu_torch.models import vit
    from vit_fpga_tpu_torch.utils.timing import time_cuda
    cfg = vit.config("vit_b16", image_size=384, dtype="bfloat16")
    launches, (k4_long, k23_long), step, params, opt, images, labels = \
        _step_vs_cpu(cfg, batch, lr, seed=5)
    print(f"  train step 384 px b{batch} launches: {launches}; past 256 "
          f"keys: K4 {k4_long}, K23 {k23_long}")
    for name, n in launches.items():
        want = cfg.depth if name in TRAIN_KERNELS else 0
        if n != want:
            raise AssertionError(f"384 px step: {name} launched {n} times, "
                                 f"want {want}")
    if k4_long != cfg.depth or k23_long != cfg.depth:
        raise AssertionError(f"384 px step: K4 / K23 launches past 256 keys "
                             f"{k4_long} / {k23_long}, want {cfg.depth}")
    ms = time_cuda(lambda: step(params, opt, images, labels), iters=iters,
                   warmup=1)
    print(f"train step 384 px b{batch} sgd({lr}) on the card: {ms:.3f} "
          f"ms/step")
    return k23_long, ms


def _leaf_names(tree, prefix=""):
    out = []
    for k in sorted(tree):
        v = tree[k]
        out.extend(_leaf_names(v, f"{prefix}{k}.") if isinstance(v, dict)
                   else [prefix + k])
    return out


TRAIN_KERNELS = ("attn_block_fwd", "fused_mlp_fwd", "attn_block_bwd",
                 "fused_mlp_bwd")


def _counters():
    from vit_fpga_tpu_torch.ops import attention as at
    from vit_fpga_tpu_torch.ops import attn_block as ab
    from vit_fpga_tpu_torch.ops import flash_attention as fa
    from vit_fpga_tpu_torch.ops import fused_mlp as fm
    from vit_fpga_tpu_torch.ops import image_filter as imf
    from vit_fpga_tpu_torch.ops import patch_embed as pe
    from vit_fpga_tpu_torch.ops import quant
    from vit_fpga_tpu_torch.ops import quant_block as qb
    from vit_fpga_tpu_torch.ops import quant_fused as qf
    from vit_fpga_tpu_torch.ops import streamed_gemm as sg
    from vit_fpga_tpu_torch.ops import vit_stack as vs
    return {"filter_image_device": imf.filter_image_device,
            "int8_gemm": quant.int8_gemm,
            "vit_layers": vs.vit_layers,
            "vit_layers_int8": vs.vit_layers_int8,
            "attn_block_stats": ab.attn_block_stats,
            "fused_mlp_stats": fm.fused_mlp_stats,
            "attn_block_fwd": ab.attn_block_fwd,
            "fused_mlp_fwd": fm.fused_mlp_fwd,
            "attn_block_bwd": ab.attn_block_bwd,
            "fused_mlp_bwd": fm.fused_mlp_bwd,
            "int8_linear_fused": qf.int8_linear_fused,
            "mlp_block_int8": qb.mlp_block_int8,
            "attn_block_int8": qb.attn_block_int8,
            "mlp_block_int8_static": qb.mlp_block_int8_static,
            "attn_block_int8_static": qb.attn_block_int8_static,
            "vit_layers_int8_static": vs.vit_layers_int8_static,
            "fused_mlp_chunked_stats": fm.fused_mlp_chunked_stats,
            "vit_full": vs.vit_full,
            "vit_full_int8": vs.vit_full_int8,
            "flash_attention": fa.flash_attention,
            "mha_qkv_pallas": at.mha_qkv_pallas,
            "mha_pallas": at.mha_pallas,
            "fused_mlp_chunked": fm.fused_mlp_chunked_fwd,
            "mlp_block_int8_stats": qb.mlp_block_int8_stats,
            "attn_block_int8_stats": qb.attn_block_int8_stats,
            "attn_block_int8_static_scores":
                qb.attn_block_int8_static_scores,
            "patch_embed_pallas": pe.patch_embed_pallas,
            "streamed_gemm": sg.streamed_gemm}


def phase_train_fit(batch=64, steps=10):
    """The training path: Trainer (AdamW, lr TRAIN_LR) for ``steps`` steps
    on one fixed batch.  Every loss finite, the last below the first; 12
    launches of each training kernel per step and none of K1 / K2.
    Returns the launch counts of the run."""
    from vit_fpga_tpu_torch.models import vit
    from vit_fpga_tpu_torch.train import trainer as tr
    cfg = vit.config("vit_b16", dtype="bfloat16")
    trainer = tr.Trainer(cfg, learning_rate=TRAIN_LR,
                         params=vit.init_params(cfg, _gen(3), device="cuda"))
    images, labels = _train_batch(cfg, batch, seed=3)
    images, labels = images.cuda(), labels.cuda()
    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    hist = trainer.fit([(images, labels)] * steps)
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    losses = [h["loss"] for h in hist]
    print(f"train fit: {steps} AdamW steps (lr {TRAIN_LR}) on one batch of "
          f"{batch}, {wall:.2f} s; losses "
          + " ".join(f"{v:.4f}" for v in losses))
    print(f"train launches: {launches}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError("training loss did not fall over the steps")
    for name, n in launches.items():
        want = cfg.depth * steps if name in TRAIN_KERNELS else 0
        if n != want:
            raise AssertionError(f"{name} launched {n} times in {steps} "
                                 f"steps, want {want}")
    return launches


def phase_train_step_time(batch=64, lr=1e-4, iters=5):
    """ms per SGD step at bench.py's train shape (b64, sgd(1e-4)), CUDA
    events after warm-up; TFLOP/s with bench.py's 3 x forward count; the
    step's peak device memory."""
    from vit_fpga_tpu_torch.models import vit
    from vit_fpga_tpu_torch.train import trainer as tr
    from vit_fpga_tpu_torch.utils.timing import time_cuda
    cfg = vit.config("vit_b16", dtype="bfloat16")
    params, opt = tr.init_train_state(
        cfg, tr.sgd(lr), params=vit.init_params(cfg, _gen(4), device="cuda"))
    images, _ = _train_batch(cfg, batch, seed=4)
    images = images.cuda()
    labels = torch.zeros((batch,), dtype=torch.int64, device="cuda")
    step = tr.make_vit_train_step(cfg)
    step(params, opt, images, labels)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = time_cuda(lambda: step(params, opt, images, labels), iters=iters,
                   warmup=2)
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    tflops = 3 * vit.flops_per_image(cfg) * batch / (ms * 1e-3) / 1e12
    print(f"train step b{batch} sgd({lr}): {ms:.3f} ms/step, "
          f"{tflops:.1f} TFLOP/s (3 x forward), peak {peak:.0f} MiB")
    return dict(ms=ms, tflops=tflops, peak_mib=peak)


# ---------------------------------------------------------------------------
# The dynamic int8 path: K14, K15, K16
# ---------------------------------------------------------------------------

def _int8_weights(p, names):
    """``p`` with each (K, N) weight in ``names`` replaced by its
    quantize_weight_colwise pair: ``<name>_q`` int8 as a (K, N) view of
    (N, K) storage (the layout the int8 forward prepares), ``<name>_s``."""
    from vit_fpga_tpu_torch.ops.quant_fused import (kmajor,
                                                    quantize_weight_colwise)
    out = {k: v for k, v in p.items() if k not in names}
    for k in names:
        wq, ws = quantize_weight_colwise(p[k].cpu().numpy())
        out[k + "_q"] = kmajor(torch.from_numpy(wq).cuda())
        out[k + "_s"] = torch.from_numpy(ws).cuda()
    return out


def _k16(fn, x, q, heads, n_valid):
    return fn(x, q["ln_scale"], q["ln_bias"], q["wqkv_q"], q["wqkv_s"],
              q["bqkv"], q["wo_q"], q["wo_s"], q["bo"], heads, eps=EPS,
              n_valid=n_valid)


def _k15(fn, x2, q, act):
    return fn(x2, q["ln_scale"], q["ln_bias"], q["w1_q"], q["w1_s"], q["b1"],
              q["w2_q"], q["w2_s"], q["b2"], eps=EPS, act=act)


def _k14(fn, x, q, **kw):
    return fn(x, q["w_q"], q["w_s"], q["b"], **kw)


def _k16_step(x, q, heads, n_valid):
    """One quantization step of K16's output: the plain version's
    out-projection input scale sa_r times 127 times wos_n."""
    from vit_fpga_tpu_torch.ops import quant_block as qb
    from vit_fpga_tpu_torch.ops.attn_block import _mha_tpu
    from vit_fpga_tpu_torch.ops.quant_fused import QMAX, _row_quant
    xq, sx = _row_quant(qb._ln_f32(x, q["ln_scale"], q["ln_bias"], EPS))
    qkv = qb._dequant(xq, q["wqkv_q"], sx, q["wqkv_s"], q["bqkv"]).to(x.dtype)
    _, sa = _row_quant(_mha_tpu(qkv, heads, n_valid).float())
    return sa * QMAX * q["wo_s"]


def _k15_step(x2, q, act):
    """One quantization step of K15's output: sh_r * 127 * w2s_n."""
    from vit_fpga_tpu_torch.ops import quant_block as qb
    from vit_fpga_tpu_torch.ops.quant_fused import QMAX, _row_quant
    xq, sx = _row_quant(qb._ln_f32(x2, q["ln_scale"], q["ln_bias"], EPS))
    h = qb._apply_act(qb._dequant(xq, q["w1_q"], sx, q["w1_s"], q["b1"]), act)
    _, sh = _row_quant(h)
    return sh * QMAX * q["w2_s"]


def _k14_step(x, q, ln_eps=0.0, **_):
    """One quantization step of K14's output: sx_r * 127 * ws_n, sx the
    scale of the (LayerNormed) input row."""
    from vit_fpga_tpu_torch.ops.quant_fused import QMAX, _row_quant
    xf = x.float()
    if ln_eps > 0:
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, unbiased=False, keepdim=True)
        xf = (xf - mu) * torch.rsqrt(var + ln_eps) * q["ls"] + q["lb"]
    _, sx = _row_quant(xf)
    return sx * QMAX * q["w_s"]


def _print_worst(label, g, w, diff, tol, step):
    """The worst element past its band and its row: where it sits, the
    kernel's and the plain values, and how much of the row moved."""
    d = g.shape[-1]
    ratio = (diff / tol).reshape(-1)
    i = int(ratio.argmax())
    r, c = divmod(i, d)
    drow = diff.reshape(-1, d)[r]
    srow = step.expand_as(diff).reshape(-1, d)[r]
    print(f"  {label} worst: row {r} col {c} kernel "
          f"{float(g.reshape(-1)[i]):.6g} plain {float(w.reshape(-1)[i]):.6g} "
          f"tol {float(tol.reshape(-1)[i]):.3e}; its row: "
          f"{int((drow > 0).sum())} of {d} elements differ, "
          f"{int((drow > tol.reshape(-1, d)[r]).sum())} past the band, "
          f"largest {float((drow / srow).max()):.2f} steps")


def _int8_parity(label, got, want, step, x=None, rows=(...,), mag_x=False,
                 row_bound=None):
    """Kernel vs plain version elementwise within BF16_TOL (1 + |b|) +
    INT8_STEPS * step, then the branch ``out - x`` (or, without a
    residual, the output) in relative norm within BRANCH_TOL.  With
    ``mag_x`` the elementwise term is BF16_TOL (1 + |b| + |x|): out = x +
    bf16(y) carries one ulp of bf16(y), which exceeds 2^-6 |b| where x and
    y cancel (the backward's dx band takes |g| so).  With ``row_bound``
    (shaped like ``step``) up to one row in FLIP_ROWS may leave that band,
    each by no more than ``row_bound`` (one rounding event of its own:
    FLIP_ROWS below).  Returns the max-abs error."""
    torch.cuda.synchronize()
    g, w, st = got[rows].float(), want[rows].float(), step[rows]
    diff = (g - w).abs()
    mag = w.abs() + (x[rows].float().abs() if mag_x else 0.0)
    tol = BF16_TOL * (1.0 + mag) + INT8_STEPS * st
    what = "|b| + |x|" if mag_x else "|b|"
    rows_note = ""
    if row_bound is not None:
        off = (diff > tol).reshape(-1, diff.shape[-1]).any(-1)
        allowed = max(1, off.numel() // FLIP_ROWS)
        bound = row_bound[rows]
        bad = int((diff > tol + bound).sum())
        bad += max(0, int(off.sum()) - allowed)
        rows_note = (f"; rows past the band {int(off.sum())} of "
                     f"{off.numel()}, allowed {allowed}, each within "
                     f"{float(bound.max()):.3e} more")
    else:
        bad = int((diff > tol).sum())
    max_abs = float(diff.max())
    print(f"  {label}: max_abs={max_abs:.3e} (tol {BF16_TOL:g} (1 + {what}) "
          f"+ {INT8_STEPS} steps, largest step {float(st.max()):.3e}"
          f"{rows_note}, violations={bad})")
    if bad or (row_bound is not None and int(off.sum())):
        _print_worst(label, g, w, diff, tol, st)
    if bad or not torch.isfinite(g).all():
        raise AssertionError(f"{label}: kernel disagrees with its plain "
                             f"version")
    if x is not None:
        _branch(f"{label} branch", g, w, x[rows])
    else:
        _relnorm(f"{label} norm", g, w, BRANCH_TOL)
    return max_abs


def _k14_inputs(t, d, classes, seed):
    g = _gen(seed)
    x = _randn(g, t, d).to(torch.bfloat16)
    q = _int8_weights(dict(w=_randn(g, d, classes, std=0.02),
                           b=_randn(g, classes, std=0.02),
                           ls=_randn(g, d, std=0.1, mean=1.0),
                           lb=_randn(g, d, std=0.1)), ("w",))
    return x, q


# K14's other modes at b8: (label, rows, input dtype, keyword arguments)
K14_MODES = (
    ("LN + gelu_tanh", 8, torch.bfloat16, dict(act="gelu_tanh", ln_eps=EPS)),
    ("f32 out + quick_gelu", 8, torch.bfloat16,
     dict(act="quick_gelu", out_dtype=torch.float32)),
    ("f32 in + LN + relu", 8, torch.float32, dict(act="relu", ln_eps=EPS)),
    ("ragged T=200 + LN", 200, torch.bfloat16, dict(ln_eps=EPS)),
)


def phase_int8_kernels(batch, n_pad=200, n_valid=197, d=768, heads=12,
                       m=3072, classes=1000):
    """K16, K15 and K14 against their plain versions at the path's shapes
    for ``batch`` (K15 with every activation and K14 in every mode at
    b8).  Returns {kernel name: largest max-abs error}."""
    from vit_fpga_tpu_torch.ops import quant_block as qb
    from vit_fpga_tpu_torch.ops import quant_fused as qf
    worst = {}
    x, _, p = _attn_inputs(batch, n_pad, d, seed=70 + batch)
    q = _int8_weights(p, ("wqkv", "wo"))
    print(f"parity K16 attn_block_int8 ({batch}, {n_pad}, {d}), {heads} "
          f"heads, n_valid={n_valid}")
    worst["attn_block_int8"] = _int8_parity(
        f"K16 b{batch}", _k16(qb.attn_block_int8, x, q, heads, n_valid),
        _k16(qb.attn_block_int8_plain, x, q, heads, n_valid),
        _k16_step(x, q, heads, n_valid), x)

    rows = batch * n_pad
    x2, _, p = _mlp_inputs(rows, d, m, seed=71 + batch)
    q = _int8_weights(p, ("w1", "w2"))
    print(f"parity K15 mlp_block_int8 ({rows}, {d}) x {m}")
    worst["mlp_block_int8"] = 0.0
    for act in MLP_ACTS if batch <= 8 else ("gelu_tanh",):
        worst["mlp_block_int8"] = max(worst["mlp_block_int8"], _int8_parity(
            f"K15 b{batch} {act}", _k15(qb.mlp_block_int8, x2, q, act),
            _k15(qb.mlp_block_int8_plain, x2, q, act), _k15_step(x2, q, act),
            x2))

    x, q = _k14_inputs(batch, d, classes, seed=72 + batch)
    print(f"parity K14 int8_linear_fused ({batch}, {d}) x {classes}")
    worst["int8_linear_fused"] = _int8_parity(
        f"K14 b{batch} head", _k14(qf.int8_linear_fused, x, q),
        _k14(qf.int8_linear_fused_plain, x, q), _k14_step(x, q))
    for label, t, dt, kw in K14_MODES if batch <= 8 else ():
        xm, qm = _k14_inputs(t, d, classes, seed=73)
        xm = xm.to(dt)
        if "ln_eps" in kw:
            kw = dict(kw, ln_scale=qm["ls"], ln_bias=qm["lb"])
        got = _k14(qf.int8_linear_fused, xm, qm, **kw)
        if got.dtype != kw.get("out_dtype", torch.bfloat16):
            raise AssertionError(f"K14 {label}: output dtype {got.dtype}")
        worst["int8_linear_fused"] = max(
            worst["int8_linear_fused"], _int8_parity(
                f"K14 {label}", got,
                _k14(qf.int8_linear_fused_plain, xm, qm, **kw),
                _k14_step(xm, qm, **kw)))
    return worst


def phase_int8_loud(batch=8, n_pad=256, n_valid=197, d=768, heads=12):
    """K16 with its padding rows (59 at the default shape) of huge spikes:
    the valid rows must equal, bit for bit, the kernel's own on quiet
    padding rows (their keys are masked), and match the plain version on
    the loud input."""
    from vit_fpga_tpu_torch.ops import quant_block as qb
    x, _, p = _attn_inputs(batch, n_pad, d, seed=80)
    q = _int8_weights(p, ("wqkv", "wo"))
    loud = x.clone()
    loud[:, n_valid:] = 0.0
    loud[:, n_valid:, 3] = 3e3
    loud[:, n_valid:, 100] = -1e3
    print(f"K16 loud padding ({batch}, {n_pad}, {d}): spikes in rows "
          f"{n_valid}..{n_pad - 1}")
    valid = (slice(None), slice(0, n_valid))
    quiet_out = _k16(qb.attn_block_int8, x, q, heads, n_valid)
    loud_out = _k16(qb.attn_block_int8, loud, q, heads, n_valid)
    err = _int8_parity("K16 loud padding", loud_out,
                       _k16(qb.attn_block_int8_plain, loud, q, heads,
                            n_valid), _k16_step(loud, q, heads, n_valid),
                       loud, rows=valid)
    moved = float((loud_out[valid].float() - quiet_out[valid].float())
                  .abs().max())
    print(f"  K16 valid rows, loud vs quiet padding: max_abs={moved:.3e} "
          f"(must be 0)")
    if moved != 0.0:
        raise AssertionError("K16: padding rows moved the valid rows")
    return err


def _k15_case(label, t, d, m, seed, act="gelu_tanh", edit=None):
    """K15 against its plain version on seeded (t, d) x m inputs, ``edit``
    applied to (x, f32 parameters) first, in the int8 band.  Returns the
    max-abs error."""
    from vit_fpga_tpu_torch.ops import quant_block as qb
    x2, _, p = _mlp_inputs(t, d, m, seed)
    if edit is not None:
        edit(x2, p)
    q = _int8_weights(p, ("w1", "w2"))
    return _int8_parity(f"K15 {label}", _k15(qb.mlp_block_int8, x2, q, act),
                        _k15(qb.mlp_block_int8_plain, x2, q, act),
                        _k15_step(x2, q, act), x2)


def _k15_last_tile(x2, p):
    """Every row's absmax of h in W1's last column tile alone: one huge
    bias on the last column (act(40) = 40 for each activation)."""
    p["b1"][-1] = 40.0


def _k15_zero_row(x2, p):
    """Row 3 all zero through the LayerNorm and W1 (zero LN bias and b1):
    its h is all zero, its scale the 1e-12 floor, its hq zero."""
    x2[3] = 0.0
    p["ln_bias"].zero_()
    p["b1"].zero_()


def _k15_edges():
    """K15 (both GEMMs on qgemm_wgmma.cuh's int8 wgmma + TMA kernel, h's
    row scale from the W1 tiles' row maxima) at the edges of its design,
    in the int8 band: T 197 and 1 601 (ragged 128-row tiles), ViT-L/16's
    (1600, 1024) x 4096, (600, 400) x 1552 (D and M multiples of 16, not
    of 64: a partial column tile feeds the maxima), the absmax of every
    row in the last (partial) column tile, an all-zero row, each
    activation; then 20 back-to-back launches bit for bit.  Returns the
    max-abs error."""
    from vit_fpga_tpu_torch.ops import quant_block as qb
    print("K15 edges: ragged rows and columns, ViT-L width, the last "
          "tile's absmax, a zero row, activations")
    worst = 0.0
    for label, t, d, m, seed, act, edit in (
            ("T 197", 197, 768, 3072, 200, "gelu_tanh", None),
            ("T 1601", 1601, 768, 3072, 201, "gelu_tanh", None),
            ("ViT-L/16 (1600, 1024) x 4096", 1600, 1024, 4096, 202,
             "gelu_tanh", None),
            ("(600, 400) x 1552", 600, 400, 1552, 203, "gelu_tanh", None),
            ("(600, 400) x 1552, absmax in the last column tile", 600, 400,
             1552, 204, "gelu_tanh", _k15_last_tile),
            ("T 197, absmax in the last column tile, relu", 197, 768, 3072,
             205, "relu", _k15_last_tile),
            ("T 197, an all-zero row", 197, 768, 3072, 206, "gelu_tanh",
             _k15_zero_row),
            ("T 197 quick_gelu", 197, 768, 3072, 207, "quick_gelu", None),
            ("T 197 relu", 197, 768, 3072, 208, "relu", None)):
        worst = max(worst, _k15_case(label, t, d, m, seed, act, edit))
    x2, _, p = _mlp_inputs(1600, 768, 3072, 210)
    q = _int8_weights(p, ("w1", "w2"))
    _repeat_identical("K15 (1600, 768) x 3072",
                      lambda: _k15(qb.mlp_block_int8, x2, q, "gelu_tanh"))
    return worst


def _bound_int8(int8_ops, bf16_flops, nbytes):
    """The least time: int8 operations at the int8 peak plus bf16 ones at
    the bf16 peak, or the bytes at the memory rate, whichever is larger."""
    t_ops = (int8_ops / H100_INT8_OPS + bf16_flops / H100_BF16_FLOPS) * 1e3
    t_mem = nbytes / H100_HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_mem else (t_mem, "bytes")


def _library_ms(fn, label):
    """A yardstick's time, or None (printed) where PyTorch refuses it."""
    from vit_fpga_tpu_torch.utils.timing import time_cuda
    try:
        return time_cuda(fn)
    except RuntimeError as e:
        print(f"  library yardstick for {label} not run: {e}")
        return None


def _k16_library(xa, qa, heads, n_valid):
    """K16's library yardstick on (B, n_pad, D) ``xa``: F.layer_norm, the
    row quantization in torch ops, torch._int_mm, the dequantization, SDPA
    with the key mask, the out-projection the same way."""
    import torch.nn.functional as F
    from vit_fpga_tpu_torch.ops import quant_fused as qf
    batch, n_pad, d = xa.shape
    rows, dh, bf, rq = batch * n_pad, d // heads, torch.bfloat16, qf._row_quant
    keep = (torch.arange(n_pad, device="cuda") < n_valid)[None, None, None]

    def mm(aq, wq, sa, ws, b):     # (K, N) wq column-major, as _int_mm takes
        return torch._int_mm(aq, wq).float() * (sa * ws) + b

    def run():
        h = F.layer_norm(xa.float(), (d,), qa["ln_scale"], qa["ln_bias"], EPS)
        xq, sx = rq(h.reshape(rows, d))
        qkv = mm(xq, qa["wqkv_q"], sx, qa["wqkv_s"], qa["bqkv"]).to(bf)
        qkv = qkv.view(batch, n_pad, 3, heads, dh)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        ao = F.scaled_dot_product_attention(q, k, v, attn_mask=keep)
        aq, sa = rq(ao.transpose(1, 2).reshape(rows, d).float())
        y = mm(aq, qa["wo_q"], sa, qa["wo_s"], qa["bo"])
        return xa.reshape(rows, d) + y.to(bf)
    return run


def _k16_work(batch, n_pad, n_valid, d, heads):
    """K16's (int8 operations, bf16 attention FLOPs, compulsory bytes): x
    in and out, the int8 weights, the f32 vectors."""
    rows = batch * n_pad
    return (8 * rows * d * d,
            4 * batch * heads * n_pad * n_valid * (d // heads),
            2 * rows * d * 2 + 4 * d * d + (2 * d + 6 * d + 2 * d) * 4)


# The int8 halves whose device-alone times (torch.profiler, the wrapper's
# host time out) are printed beside the per-call ones: K16, K21a, K18,
# K21b, K17 and K22, the attention halves also past 256 keys.
DEVICE_ALONE = ("attn_block_int8", "mlp_block_int8_stats",
                "attn_block_int8_long", "attn_block_int8_static",
                "attn_block_int8_stats", "attn_block_int8_static_long",
                "attn_block_int8_stats_long", "mlp_block_int8_static",
                "attn_block_int8_static_scores",
                "attn_block_int8_static_scores_long", "int8_linear_fused")


def _device_alone_pair(name, kern, lib, lib_ran):
    """The kernel's and its library yardstick's (where it ran) device-alone
    ms for a DEVICE_ALONE kernel, printed; {} for the others."""
    if name not in DEVICE_ALONE:
        return {}
    dev = _device_alone_ms(kern, iters=20)
    lib_dev = _device_alone_ms(lib, iters=20) if lib_ran else None
    print(f"  {name} device alone: kernel {dev:.4f} ms, library "
          f"{lib_dev} ms")
    return dict(device_ms=dev, library_device_ms=lib_dev)


def phase_int8_timing(batch=64, n_pad=200, n_valid=197, d=768, heads=12,
                      m=3072, classes=1000):
    """Times at the int8 path's b64 shapes: each kernel, its plain
    version, a library yardstick (F.layer_norm, the row quantization in
    torch ops, torch._int_mm, the dequantization; SDPA for K16) and the
    bound.  Returns {name: dict of times}."""
    import torch.nn.functional as F
    from vit_fpga_tpu_torch.ops import quant_block as qb
    from vit_fpga_tpu_torch.ops import quant_fused as qf
    from vit_fpga_tpu_torch.utils.timing import time_cuda
    rows, bf = batch * n_pad, torch.bfloat16
    rq = qf._row_quant
    xa, _, pa = _attn_inputs(batch, n_pad, d, seed=90)
    qa = _int8_weights(pa, ("wqkv", "wo"))
    x2, _, pm = _mlp_inputs(rows, d, m, seed=91)
    qm = _int8_weights(pm, ("w1", "w2"))
    xh, qh = _k14_inputs(batch, d, classes, seed=92)

    def mm(aq, wq, sa, ws, b):     # (K, N) wq column-major, as _int_mm takes
        return torch._int_mm(aq, wq).float() * (sa * ws) + b

    def lib_mlp():
        h = F.layer_norm(x2.float(), (d,), qm["ln_scale"], qm["ln_bias"], EPS)
        xq, sx = rq(h)
        h = F.gelu(mm(xq, qm["w1_q"], sx, qm["w1_s"], qm["b1"]),
                   approximate="tanh")
        hq, sh = rq(h)
        return x2 + mm(hq, qm["w2_q"], sh, qm["w2_s"], qm["b2"]).to(bf)

    def lib_head():
        xq, sx = rq(xh.float())
        return mm(xq, qh["w_q"], sx, qh["w_s"], qh["b"]).to(bf)

    vec = 4                                  # bytes of one f32 vector entry
    cases = {
        "attn_block_int8": (
            lambda: _k16(qb.attn_block_int8, xa, qa, heads, n_valid),
            lambda: _k16(qb.attn_block_int8_plain, xa, qa, heads, n_valid),
            _k16_library(xa, qa, heads, n_valid),
            *_k16_work(batch, n_pad, n_valid, d, heads)),
        "mlp_block_int8": (
            lambda: _k15(qb.mlp_block_int8, x2, qm, "gelu_tanh"),
            lambda: _k15(qb.mlp_block_int8_plain, x2, qm, "gelu_tanh"),
            lib_mlp, 4 * rows * d * m, 0,
            2 * rows * d * 2 + 2 * d * m + (4 * d + 2 * m) * vec),
        "int8_linear_fused": (
            lambda: _k14(qf.int8_linear_fused, xh, qh),
            lambda: _k14(qf.int8_linear_fused_plain, xh, qh),
            lib_head, 2 * batch * d * classes, 0,
            batch * d * 2 + d * classes + 2 * classes * vec
            + batch * classes * 2),
    }
    out = {}
    for name, (kern, plain, lib, ops8, flops, nbytes) in cases.items():
        ms = time_cuda(kern)
        plain_ms = time_cuda(plain, iters=5, warmup=1)
        lib_ms = _library_ms(lib, name)
        bound_ms, bound_by = _bound_int8(ops8, flops, nbytes)
        out[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=bound_ms, bound_by=bound_by)
        print(f"timing {name} b{batch}: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, library {lib_ms} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}, {ops8 / 1e9:.2f} G int8 ops "
              f"+ {flops / 1e9:.2f} GFLOP bf16, {nbytes / 1e6:.2f} MB)")
        out[name].update(_device_alone_pair(name, kern, lib,
                                            lib_ms is not None))
    return out


INT8_KERNELS = ("attn_block_int8", "mlp_block_int8", "int8_linear_fused")


@contextlib.contextmanager
def _switch_on(name):
    """models.quantized.<name> (a gated path's module switch) set True,
    restored in a finally."""
    from vit_fpga_tpu_torch.models import quantized
    before = getattr(quantized, name)
    setattr(quantized, name, True)
    try:
        yield
    finally:
        setattr(quantized, name, before)


def _switched(fn, name):
    """``fn`` with the module switch ``name`` on around each call (None:
    ``fn`` itself).  The serving thread's calls do not overlap."""
    if name is None:
        return fn

    def run(*args):
        with _switch_on(name):
            return fn(*args)
    return run


# phase_int8_slice's modes: (label, static tree, the encoder halves, the
# module switch held on around every forward of the tree)
INT8_SLICE_MODES = {
    "dynamic": ("int8", False, ("attn_block_int8", "mlp_block_int8"), None),
    "static": ("int8 static", True, ("attn_block_int8_static",
                                     "mlp_block_int8_static"), None),
    "chain": ("int8 chain", False, ("attn_block_int8_stats",
                                    "mlp_block_int8_stats"),
              "_INT8_STATS_CHAIN"),
    "scores": ("int8 scores", True, ("attn_block_int8_static_scores",
                                     "mlp_block_int8_static"),
               "_INT8_SCORES"),
}


def phase_int8_slice(n_images=160, batch=64, mode="dynamic", others=None,
                     image_size=224):
    """ImageServer over make_forward_int8(vit_b16 @``image_size``) answers
    ``n_images`` uint8 requests in ``mode`` (INT8_SLICE_MODES): on the
    quantize_vit_fast tree (K16, K15, K14), on the quantize_vit_static
    tree (K18, K17, K14), or with a module switch on: the int8 stats chain
    on the dynamic tree (K21b, K21a, K14), the int8-scores attention on
    the static tree (K22, K17, K14).  Top-1 is set beside the card's bf16
    forward, each of ``others`` ({name: forward}) and, for a switched
    mode, the same tree's forward with the switch off.  Returns (launch
    counts, the int8 forward, the card's bf16 forward of the same weights,
    the config, the tree's forward without the switch)."""
    from unittest import mock

    from vit_fpga_tpu_torch.models import quantized, vit
    from vit_fpga_tpu_torch.ops import quant_block as qb
    from vit_fpga_tpu_torch.ops import quant_fused as qf
    from vit_fpga_tpu_torch.runtime.serving import ImageServer
    from vit_fpga_tpu_torch.utils.log import Metrics
    label, static, halves, switch = INT8_SLICE_MODES[mode]
    if image_size != 224:
        label = f"{label} @{image_size}"
    cfg = vit.config("vit_b16", image_size=image_size, dtype="bfloat16")
    params = vit.init_params(cfg, _gen(5), device="cuda")
    qparams = (quantized.quantize_vit_static(params, cfg) if static
               else quantized.quantize_vit_fast(params))
    fwd_off = quantized.make_forward_int8(cfg, qparams, raw=True)
    fwd = _switched(fwd_off, switch)
    images = np.random.default_rng(5).integers(
        0, 256, (n_images, cfg.image_size, cfg.image_size, 3), np.uint8)
    fwd(images[:batch])                 # first launch: library loads
    torch.cuda.synchronize()
    Metrics.reset()
    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    with ImageServer(fwd, image_size=cfg.image_size,
                     batch_size=batch) as server:
        futs = [server.submit_raw(img) for img in images]
        results = [f.result(timeout=600) for f in futs]
        wall = time.perf_counter() - t0
        pct = server.latency_percentiles()
    launches = {k: fn.launches for k, fn in counters.items()}
    print(f"{label} slice: {len(results)}/{n_images} answered in "
          f"{server.batches} batches, {wall:.3f} s, {n_images / wall:.1f} "
          f"img/s, p50 {pct['p50']:.2f} ms, p99 {pct['p99']:.2f} ms")
    print(f"{label} slice launches: {launches}")
    if len(results) != n_images or server.served != n_images:
        raise AssertionError(f"not every {label} request was answered")
    for r in results:
        if r.shape != (cfg.num_classes,) or not np.isfinite(r).all():
            raise AssertionError(f"bad {label} logits row: shape {r.shape}")
    want = {halves[0]: cfg.depth * server.batches,
            halves[1]: cfg.depth * server.batches,
            "int8_linear_fused": server.batches}
    for name, n in launches.items():
        if n != want.get(name, 0):
            raise AssertionError(f"{name} launched {n} times for "
                                 f"{server.batches} {label} batches, want "
                                 f"{want.get(name, 0)}")

    cpu_fwd = _switched(quantized.make_forward_int8(
        cfg, _tree_to(qparams, "cpu"), device="cpu"), switch)
    idx = sorted({i for i in (0, batch - 1, batch, 2 * batch - 1, 2 * batch,
                              n_images - 1) if i < n_images})
    ref = cpu_fwd(images[idx]).numpy()
    got = np.stack([results[i] for i in idx])
    # the floor: the same plain versions run on the card
    plains = {k: getattr(qb, k + "_plain") for k in halves}
    with mock.patch.multiple(quantized, **plains,
                             int8_linear_fused=qf.int8_linear_fused_plain):
        floor = _switched(quantized.make_forward_int8(cfg, qparams),
                          switch)(images[idx])
    floor = float(np.abs(floor.cpu().numpy() - ref).max() / np.abs(ref).max())
    rel = float(np.abs(got - ref).max() / np.abs(ref).max())
    print(f"{label} slice logits of images {idx} vs CPU plain forward: "
          f"max_rel={rel:.3e} (band {INT8_LOGITS_BAND}; plain versions on "
          f"the card vs the CPU: {floor:.3e}), top-1 agree "
          f"{int((got.argmax(1) == ref.argmax(1)).sum())}/{len(idx)}")
    if not rel <= INT8_LOGITS_BAND:
        raise AssertionError(f"card {label} logits disagree with the CPU")
    bf_fwd = vit.make_forward(cfg, params, raw=True)
    others = dict({"bf16": bf_fwd}, **(others or {}))
    if switch is not None:
        others[f"{label} switch off"] = fwd_off
    for name, other in others.items():
        o = np.concatenate([other(images[i:i + batch]).cpu().numpy()
                            for i in range(0, n_images, batch)])
        agree = int((o.argmax(1) == np.stack(results).argmax(1)).sum())
        rel_o = float(np.abs(np.stack(results) - o).max() / np.abs(o).max())
        print(f"{label} vs the card's {name} forward (same weights): top-1 "
              f"agree {agree}/{n_images}, max_rel {rel_o:.3e} (stated, not "
              f"gated)")
    return launches, fwd, bf_fwd, cfg, fwd_off


def phase_int8_forward_time(fwds, cfg, batch=64):
    """ms per b64 batch of each forward in ``fwds`` ({name: forward}) on
    one seeded uint8 batch on the card, timed in turns (the names in
    order, then in reverse)."""
    from vit_fpga_tpu_torch.utils.timing import time_cuda
    images = torch.from_numpy(np.random.default_rng(6).integers(
        0, 256, (batch, cfg.image_size, cfg.image_size, 3),
        np.uint8)).cuda()
    runs = {name: [] for name in fwds}
    for name in list(fwds) + list(fwds)[::-1]:
        fn = fwds[name]
        runs[name].append(time_cuda(lambda: fn(images), iters=10, warmup=2))
    for name, ms in runs.items():
        mean = sum(ms) / len(ms)
        print(f"forward {name} b{batch}: "
              + " / ".join(f"{t:.3f}" for t in ms)
              + f" ms per batch, {batch / mean * 1e3:.1f} img/s")
    return runs


# ---------------------------------------------------------------------------
# The calibrated static-scale int8 path: K17, K18 (and K19b below)
# ---------------------------------------------------------------------------

STATIC_BLOCK_KERNELS = ("attn_block_int8_static", "mlp_block_int8_static")


def _f32(v: float) -> float:
    """A scale as the kernels take it (a C float) and the plain versions
    see it: rounded to f32 once, here."""
    return float(np.float32(v))


def _clipped(v, s):
    """The share of ``v / s`` that saturates: |v / s| > 127.5 rounds past
    127."""
    return float(((v / s).abs() > 127.5).float().mean())


def _static_attn_args(x, q, heads, n_valid, shrink=1.0):
    """K18's arguments from a dynamic int8 dict ``q`` (``_int8_weights``):
    per-tensor scales a_x (the f32 LN of x) and a_ao (the attention output
    of the dequantized QKV) over the valid rows, each divided by
    ``shrink``, folded as quantize_vit_static folds them.  Returns (args,
    clipped share of the int8 input, of the int8 attention output)."""
    from vit_fpga_tpu_torch.ops import quant_block as qb
    from vit_fpga_tpu_torch.ops.attn_block import _mha_tpu
    xn = qb._ln_f32(x, q["ln_scale"], q["ln_bias"], EPS)
    s_x = _f32(float(xn[:, :n_valid].abs().max()) / 127.0 / shrink)
    qkv = (xn @ (q["wqkv_q"].float() * q["wqkv_s"]) + q["bqkv"]).to(x.dtype)
    ao = _mha_tpu(qkv, heads, n_valid).float()[:, :n_valid]
    s_ao = _f32(float(ao.abs().max()) / 127.0 / shrink)
    a = dict(q, ln_scale=q["ln_scale"] / s_x, ln_bias=q["ln_bias"] / s_x,
             wqkv_s=q["wqkv_s"] * s_x, wo_s=q["wo_s"] * s_ao,
             inv=_f32(1.0 / s_ao))
    return a, _clipped(xn[:, :n_valid], s_x), _clipped(ao, s_ao)


def _static_mlp_args(x2, q, act, shrink=1.0):
    """K17's arguments from a dynamic int8 dict: a_x (the f32 LN of x2)
    and a_h (the activation of the dequantized W1 product), each divided
    by ``shrink``.  Returns (args, clipped share of x's int8, of h's)."""
    from vit_fpga_tpu_torch.ops import quant_block as qb
    xn = qb._ln_f32(x2, q["ln_scale"], q["ln_bias"], EPS)
    s_x = _f32(float(xn.abs().max()) / 127.0 / shrink)
    h = qb._apply_act(xn @ (q["w1_q"].float() * q["w1_s"]) + q["b1"], act)
    s_h = _f32(float(h.abs().max()) / 127.0 / shrink)
    a = dict(q, ln_scale=q["ln_scale"] / s_x, ln_bias=q["ln_bias"] / s_x,
             w1_s=q["w1_s"] * s_x, w2_s=q["w2_s"] * s_h,
             inv=_f32(1.0 / s_h))
    return a, _clipped(xn, s_x), _clipped(h, s_h)


def _k18(fn, x, a, heads, n_valid):
    return fn(x, a["inv"], a["ln_scale"], a["ln_bias"], a["wqkv_q"],
              a["wqkv_s"], a["bqkv"], a["wo_q"], a["wo_s"], a["bo"], heads,
              eps=EPS, n_valid=n_valid)


def _k17(fn, x2, a, act):
    return fn(x2, a["inv"], a["ln_scale"], a["ln_bias"], a["w1_q"],
              a["w1_s"], a["b1"], a["w2_q"], a["w2_s"], a["b2"], eps=EPS,
              act=act)


def phase_static_kernels(batch, n_pad=200, n_valid=197, d=768, heads=12,
                         m=3072):
    """K18 and K17 against their plain versions at the path's shapes for
    ``batch``, each calibrated on its own input (quiet) and on half its
    range (saturating: the clipped share is printed and must be > 0); at
    b8 K17 with every activation and K18 with 59 loud padding rows.  The
    band is the int8 one, its elementwise term taken relative to |b| +
    |x| (``_int8_parity``'s ``mag_x``); a step is 127 times the last
    GEMM's folded column scale (the static row scale is 1).  Returns {kernel name:
    largest max-abs error}."""
    from vit_fpga_tpu_torch.ops import quant_block as qb
    worst = {name: 0.0 for name in STATIC_BLOCK_KERNELS}
    x, _, p = _attn_inputs(batch, n_pad, d, seed=120 + batch)
    q = _int8_weights(p, ("wqkv", "wo"))
    valid = (slice(None), slice(0, n_valid))
    for label, shrink in (("quiet", 1.0), ("saturating", SHRINK)):
        a, cx, cao = _static_attn_args(x, q, heads, n_valid, shrink)
        print(f"parity K18 attn_block_int8_static ({batch}, {n_pad}, {d}) "
              f"{label}: clipped share xq {cx:.3e}, aoq {cao:.3e}")
        if shrink > 1.0 and not min(cx, cao) > 0.0:
            raise AssertionError("K18 saturating case: nothing clipped")
        worst["attn_block_int8_static"] = max(
            worst["attn_block_int8_static"], _int8_parity(
                f"K18 b{batch} {label}",
                _k18(qb.attn_block_int8_static, x, a, heads, n_valid),
                _k18(qb.attn_block_int8_static_plain, x, a, heads, n_valid),
                (127.0 * a["wo_s"]).expand(batch, n_pad, d), x, rows=valid,
                mag_x=True))
    if batch <= 8:
        xl, _, pl = _attn_inputs(batch, 256, d, seed=130)
        a, _, _ = _static_attn_args(xl, _int8_weights(pl, ("wqkv", "wo")),
                                    heads, n_valid)
        loud = xl.clone()
        loud[:, n_valid:] = 0.0
        loud[:, n_valid:, 3] = 3e3
        loud[:, n_valid:, 100] = -1e3
        quiet_out = _k18(qb.attn_block_int8_static, xl, a, heads, n_valid)
        loud_out = _k18(qb.attn_block_int8_static, loud, a, heads, n_valid)
        worst["attn_block_int8_static"] = max(
            worst["attn_block_int8_static"], _int8_parity(
                "K18 loud padding", loud_out,
                _k18(qb.attn_block_int8_static_plain, loud, a, heads,
                     n_valid), (127.0 * a["wo_s"]).expand(batch, 256, d),
                loud, rows=valid, mag_x=True))
        moved = float((loud_out[valid].float() - quiet_out[valid].float())
                      .abs().max())
        print(f"  K18 valid rows, loud vs quiet padding rows {n_valid}..255: "
              f"max_abs={moved:.3e} (must be 0)")
        if moved != 0.0:
            raise AssertionError("K18: padding rows moved the valid rows")

    rows = batch * n_pad
    x2, _, p = _mlp_inputs(rows, d, m, seed=121 + batch)
    q = _int8_weights(p, ("w1", "w2"))
    cases = [(act, "quiet", 1.0) for act in
             (MLP_ACTS if batch <= 8 else ("gelu_tanh",))]
    for act, label, shrink in cases + [("gelu_tanh", "saturating", SHRINK)]:
        a, cx, ch = _static_mlp_args(x2, q, act, shrink)
        print(f"parity K17 mlp_block_int8_static ({rows}, {d}) x {m} {act} "
              f"{label}: clipped share xq {cx:.3e}, hq {ch:.3e}")
        if shrink > 1.0 and not min(cx, ch) > 0.0:
            raise AssertionError("K17 saturating case: nothing clipped")
        worst["mlp_block_int8_static"] = max(
            worst["mlp_block_int8_static"], _int8_parity(
                f"K17 b{batch} {act} {label}",
                _k17(qb.mlp_block_int8_static, x2, a, act),
                _k17(qb.mlp_block_int8_static_plain, x2, a, act),
                (127.0 * a["w2_s"]).expand(rows, d), x2, mag_x=True))
    return worst


def phase_static_calibration():
    """quantize_vit_static's probe (the synthetic batch, bf16) of the
    seeded vit_b16 on the card against the same probe on the CPU, per key
    and layer within CALIB_BAND; the scales are printed."""
    from vit_fpga_tpu_torch.models import vit
    from vit_fpga_tpu_torch.utils import calibrate
    cfg = vit.config("vit_b16", dtype="bfloat16")
    params = vit.init_params(cfg, _gen(5), device="cuda")
    t0 = time.perf_counter()
    card = calibrate.static_activation_scales(params, cfg)
    t_card = time.perf_counter() - t0
    host = calibrate.static_activation_scales(_tree_to(params, "cpu"), cfg)
    print(f"static calibration of vit_b16 (synthetic batch of 4, bf16 "
          f"probe): {t_card:.2f} s on the card")
    worst = 0.0
    for k in calibrate.STAT_KEYS:
        rel = float(np.abs(card[k] / host[k] - 1.0).max())
        worst = max(worst, rel)
        print(f"  {k}: " + " ".join(f"{v:.4g}" for v in card[k])
              + f" (card vs CPU: max rel {rel:.2e})")
    if not worst <= CALIB_BAND:
        raise AssertionError(f"static scales on the card disagree with the "
                             f"CPU probe ({worst:.2e} > {CALIB_BAND})")


def _static_library(x, a, kind, heads=None, n_valid=None):
    """K18 (``kind`` "attn") or K17 (tanh-GELU) as PyTorch calls the port
    never makes: F.layer_norm with the folded affine, rint/clip,
    torch._int_mm, the dequantization and (K18) SDPA with the key mask,
    the static scale on its output."""
    import torch.nn.functional as F
    d = x.shape[-1]
    rows = x.numel() // d
    bf = torch.bfloat16

    def q8(v, s=1.0):
        return torch.clamp(torch.round(v * s), -127, 127).to(torch.int8)

    def mm(aq, w, ws, b):
        return torch._int_mm(aq, w).float() * ws + b

    if kind == "attn":
        b, n_pad, _ = x.shape
        dh = d // heads
        keep = (torch.arange(n_pad, device="cuda") < n_valid)[None, None,
                                                              None]

        def run():
            h = F.layer_norm(x.float(), (d,), a["ln_scale"], a["ln_bias"],
                             EPS).reshape(rows, d)
            qkv = mm(q8(h), a["wqkv_q"], a["wqkv_s"], a["bqkv"]).to(bf)
            qkv = qkv.view(b, n_pad, 3, heads, dh)
            qh, kh, vh = (qkv[:, :, i].transpose(1, 2) for i in range(3))
            ao = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=keep)
            ao = ao.transpose(1, 2).reshape(rows, d).float()
            y = mm(q8(ao, a["inv"]), a["wo_q"], a["wo_s"], a["bo"])
            return x.reshape(rows, d) + y.to(bf)
        return run

    def run():
        h = F.layer_norm(x.float(), (d,), a["ln_scale"], a["ln_bias"], EPS)
        h = F.gelu(mm(q8(h), a["w1_q"], a["w1_s"], a["b1"]),
                   approximate="tanh")
        return x + mm(q8(h, a["inv"]), a["w2_q"], a["w2_s"], a["b2"]).to(bf)
    return run


def phase_static_timing(batch=64, n_pad=200, n_valid=197, d=768, heads=12,
                        m=3072):
    """K18 and K17 at the b64 path shapes: the kernel's time, its plain
    version's, the library yardstick's and the bound (the operations and
    bytes of K16 and K15).  Returns {name: dict of times}."""
    from vit_fpga_tpu_torch.ops import quant_block as qb
    from vit_fpga_tpu_torch.utils.timing import time_cuda
    rows, vec = batch * n_pad, 4
    xa, _, pa = _attn_inputs(batch, n_pad, d, seed=140)
    aa, _, _ = _static_attn_args(xa, _int8_weights(pa, ("wqkv", "wo")),
                                 heads, n_valid)
    x2, _, pm = _mlp_inputs(rows, d, m, seed=141)
    am, _, _ = _static_mlp_args(x2, _int8_weights(pm, ("w1", "w2")),
                                "gelu_tanh")
    cases = {
        "attn_block_int8_static": (
            lambda: _k18(qb.attn_block_int8_static, xa, aa, heads, n_valid),
            lambda: _k18(qb.attn_block_int8_static_plain, xa, aa, heads,
                         n_valid),
            _static_library(xa, aa, "attn", heads, n_valid),
            *_k16_work(batch, n_pad, n_valid, d, heads)),
        "mlp_block_int8_static": (
            lambda: _k17(qb.mlp_block_int8_static, x2, am, "gelu_tanh"),
            lambda: _k17(qb.mlp_block_int8_static_plain, x2, am,
                         "gelu_tanh"),
            _static_library(x2, am, "mlp"),
            4 * rows * d * m, 0,
            2 * rows * d * 2 + 2 * d * m + (4 * d + 2 * m) * vec),
    }
    out = {}
    for name, (kern, plain, lib, ops8, flops, nbytes) in cases.items():
        ms = time_cuda(kern)
        plain_ms = time_cuda(plain, iters=5, warmup=1)
        lib_ms = _library_ms(lib, name)
        bound_ms, bound_by = _bound_int8(ops8, flops, nbytes)
        out[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=bound_ms, bound_by=bound_by)
        print(f"timing {name} b{batch}: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, library {lib_ms} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}, {ops8 / 1e9:.2f} G int8 ops "
              f"+ {flops / 1e9:.2f} GFLOP bf16, {nbytes / 1e6:.2f} MB)")
        out[name].update(_device_alone_pair(name, kern, lib,
                                            lib_ms is not None))
    return out


def run_static_phases(errors, timing, launches, fwd_int8, fwd_bf16, cfg):
    """The static int8 b64 phases after the dynamic int8 ones (K17 and K18
    at b8 ran right after the build; K19b runs with the latency
    kernels), ending with the bf16, dynamic and static int8 forwards
    timed in turns at b64."""
    phase_static_calibration()
    for name, err in phase_static_kernels(64).items():
        errors[name] = max(errors[name], err)
    for name, t in phase_static_timing().items():
        timing[name] = dict(t, max_abs_err=errors[name])
    static_launches, fwd_static, _, _, _ = phase_int8_slice(
        mode="static", others={"dynamic int8": fwd_int8})
    launches.update({k: v for k, v in static_launches.items()
                     if k in STATIC_BLOCK_KERNELS})
    phase_int8_forward_time({"bf16": fwd_bf16, "int8": fwd_int8,
                             "int8 static": fwd_static}, cfg)


# ---------------------------------------------------------------------------
# The batch-1 latency path: K11, K19a and K19b, the whole encoder in one
# launch
# ---------------------------------------------------------------------------

LATENCY_KERNELS = ("vit_layers", "vit_layers_int8", "vit_layers_int8_static")


def _stack_blocks(depth, d=768, m=3072, seed=100):
    """Seeded ViT-B-width blocks for the stack kernels, f32 on the card:
    weights of init scale, LN parameters and biases with signal."""
    g = _gen(seed)
    return dict(
        ln1_scale=_randn(g, depth, d, std=0.1, mean=1.0),
        ln1_bias=_randn(g, depth, d, std=0.1),
        wqkv=_randn(g, depth, d, 3 * d, std=0.04),
        bqkv=_randn(g, depth, 3 * d, std=0.02),
        wo=_randn(g, depth, d, d, std=0.02), bo=_randn(g, depth, d, std=0.02),
        ln2_scale=_randn(g, depth, d, std=0.1, mean=1.0),
        ln2_bias=_randn(g, depth, d, std=0.1),
        w1=_randn(g, depth, d, m, std=0.02), b1=_randn(g, depth, m, std=0.02),
        w2=_randn(g, depth, m, d, std=0.02), b2=_randn(g, depth, d, std=0.02))


def _stack_trees(depth, seed=100, static=True, d=768, m=3072,
                 act="gelu_tanh", shrink=1.0):
    """(bf16 tree, int8 tree, static int8 tree or None without ``static``)
    of the same seeded blocks,
    laid out as the latency forwards prepare them (bf16 weights; int8
    weights as (L, K, N) views of (L, N, K) storage with f32 column
    scales).  The static tree folds scales from the port's probe
    (calibrate.layer_absmax_stats, through ``act``) on seeded tokens, each
    layer's times 0.7, 1 or 1.4 in turn: the layers' scales differ (a
    kernel that reads another layer's scale moves a branch by up to a
    factor of 2) and a third of the layers saturate; all divided by
    ``shrink``, where more of every layer saturates."""
    from vit_fpga_tpu_torch.models import quantized
    from vit_fpga_tpu_torch.ops.quant_fused import (QMAX, kmajor,
                                                    quantize_weight_colwise)
    from vit_fpga_tpu_torch.utils import calibrate
    p = _stack_blocks(depth, d=d, m=m, seed=seed)
    mats = ("wqkv", "wo", "w1", "w2")
    bf = {k: (v.to(torch.bfloat16) if k in mats else v) for k, v in p.items()}
    q8 = {k: v for k, v in p.items() if k not in mats}
    for k in mats:
        pairs = [quantize_weight_colwise(w.cpu().numpy()) for w in p[k]]
        q8[k + "_q"] = kmajor(torch.from_numpy(
            np.stack([a for a, _ in pairs])).cuda())
        q8[k + "_s"] = torch.from_numpy(np.stack([s for _, s in pairs])).cuda()
    if not static:
        return bf, q8, None
    sc = calibrate.layer_absmax_stats(p, _stack_x(4, d=d, seed=seed + 2),
                                      d // 64, EPS, act, torch.bfloat16)
    turns = np.asarray([0.7, 1.0, 1.4], np.float32)[np.arange(depth) % 3]
    turns = turns / np.float32(shrink)
    s8 = quantized._fold_static_scales(
        {"blocks": q8}, {k: v * turns for k, v in sc.items()}, QMAX)["blocks"]
    return bf, q8, s8


def _stack_x(batch, n_pad=200, d=768, seed=101):
    return _randn(_gen(seed), batch, n_pad, d).to(torch.bfloat16)


def phase_stack_kernels(batches=(1, 4), n_valid=197, heads=12):
    """K11, K19a and K19b against their plain versions on the card at full
    ViT-B/16 width, all rows: one layer elementwise (the bf16 band; the
    int8 step band with the steps of both its GEMMs), all 12 layers in
    relative norm (the ulp flips of one layer compound through the
    attention of the next);
    then a loud-padding case at depth 12 whose valid rows must not move.
    Runs right after the build.  Returns {kernel name: max-abs error}."""
    from vit_fpga_tpu_torch.ops import vit_stack as vs
    worst = {name: 0.0 for name in LATENCY_KERNELS}
    bf12, q12, s12 = _stack_trees(12)
    for batch in batches:
        x = _stack_x(batch)
        print(f"parity K11 vit_layers / K19a vit_layers_int8 / K19b "
              f"vit_layers_int8_static ({batch}, 200, 768), 12 heads, "
              f"n_valid={n_valid}")
        bf1 = {k: v[:1] for k, v in bf12.items()}
        q1 = {k: v[:1] for k, v in q12.items()}
        got = vs.vit_layers(x, bf1, heads, eps=EPS, n_valid=n_valid)
        want = vs.vit_layers_plain(x, bf1, heads, eps=EPS, n_valid=n_valid)
        torch.cuda.synchronize()
        worst["vit_layers"] = max(worst["vit_layers"], _compare(
            f"K11 b{batch} depth 1", got, want, BF16_TOL, BF16_TOL))
        _branch(f"K11 b{batch} depth 1 branch", got, want, x)
        got = vs.vit_layers_int8(x, q1, heads, eps=EPS, n_valid=n_valid)
        want = vs.vit_layers_int8_plain(x, q1, heads, eps=EPS,
                                        n_valid=n_valid)
        step = _stack_int8_step(x, q1, heads, n_valid)
        worst["vit_layers_int8"] = max(worst["vit_layers_int8"], _int8_parity(
            f"K19a b{batch} depth 1", got, want, step, x))
        s1 = {k: v[:1] for k, v in s12.items()}
        got = vs.vit_layers_int8_static(x, s1, heads, eps=EPS,
                                        n_valid=n_valid)
        want = vs.vit_layers_int8_static_plain(x, s1, heads, eps=EPS,
                                               n_valid=n_valid)
        # one step of each GEMM whose output the layer carries: 127 times
        # the folded column scale of the out-projection and of W2
        step = (127.0 * (s1["wo_s"][0] + s1["w2_s"][0])).expand_as(x)
        worst["vit_layers_int8_static"] = max(
            worst["vit_layers_int8_static"], _int8_parity(
                f"K19b b{batch} depth 1", got, want, step, x, mag_x=True))
        for name, kern, plain, tree, tol in (
                ("vit_layers", vs.vit_layers, vs.vit_layers_plain, bf12,
                 STACK_BF16_NORM),
                ("vit_layers_int8", vs.vit_layers_int8,
                 vs.vit_layers_int8_plain, q12, STACK_INT8_NORM),
                ("vit_layers_int8_static", vs.vit_layers_int8_static,
                 vs.vit_layers_int8_static_plain, s12, STACK_INT8_NORM)):
            got = kern(x, tree, heads, eps=EPS, n_valid=n_valid)
            want = plain(x, tree, heads, eps=EPS, n_valid=n_valid)
            torch.cuda.synchronize()
            _relnorm(f"{name} b{batch} depth 12, all rows", got, want, tol)
            worst[name] = max(worst[name], float(
                (got.float() - want.float()).abs().max()))
    # loud padding: rows 197..199 of one huge spike each; their keys are
    # masked and every other stage is row-wise
    x = _stack_x(2)
    loud = x.clone()
    loud[:, n_valid:] = 0.0
    loud[:, n_valid:, 3] = 3e3
    loud[:, n_valid:, 100] = -1e3
    for name, kern, tree in (("K11", vs.vit_layers, bf12),
                             ("K19a", vs.vit_layers_int8, q12),
                             ("K19b", vs.vit_layers_int8_static, s12)):
        quiet = kern(x, tree, heads, eps=EPS, n_valid=n_valid)
        noisy = kern(loud, tree, heads, eps=EPS, n_valid=n_valid)
        torch.cuda.synchronize()
        moved = float((noisy[:, :n_valid].float()
                       - quiet[:, :n_valid].float()).abs().max())
        print(f"  {name} depth 12 loud padding rows {n_valid}..199: valid "
              f"rows moved by max_abs={moved:.3e} (must be 0)")
        if moved != 0.0 or not torch.isfinite(noisy[:, :n_valid]).all():
            raise AssertionError(f"{name}: padding rows moved the valid rows")
    worst["vit_layers_int8"] = max(worst["vit_layers_int8"], _k19a_edges())
    worst["vit_layers_int8_static"] = max(worst["vit_layers_int8_static"],
                                          _k19b_edges())
    worst["vit_layers"] = max(worst["vit_layers"], _k11_edges())
    return worst


def _repeat_identical(label, call, n=20):
    """``n`` back-to-back launches of ``call`` must match the first bit
    for bit: the kernel's sums run in a fixed order, so a missing proxy
    fence or a ring slot out of step shows here first."""
    first = call()
    outs = [call() for _ in range(n - 1)]
    torch.cuda.synchronize()
    same = sum(bool(torch.equal(o, first)) for o in outs)
    print(f"  {label}: {same + 1} of {n} back-to-back launches bit-identical "
          f"(must be {n})")
    if same != n - 1 or not torch.isfinite(first.float()).all():
        raise AssertionError(f"{label}: repeated launches disagree")


def _k19a_edges(heads=12):
    """K19a (int8 wgmma items of 128 rows, split-K, the attention on
    mha_wgmma.cuh's max-free sweep) at the edges of its design: b2 and b3
    (400 and 600 rows), 1 / 127 / 128 / 129 / 197 / 256 valid keys at
    n_pad 256 (one or two key tiles, the last masked), quick_gelu and
    ViT-L/16's width (D 1024, M 4096, 16 heads), each at one layer in the
    int8 step band and deeper in norm; then 20 back-to-back b1 depth-12
    launches bit for bit.  Returns the max-abs error."""
    from vit_fpga_tpu_torch.ops import vit_stack as vs
    worst = 0.0
    _, q12, _ = _stack_trees(12, seed=150, static=False)
    q1 = {k: v[:1] for k, v in q12.items()}

    def case(label, x, q1, qn, depth, heads, n_valid, act="gelu_tanh"):
        got = vs.vit_layers_int8(x, q1, heads, eps=EPS, act=act,
                                 n_valid=n_valid)
        want = vs.vit_layers_int8_plain(x, q1, heads, eps=EPS, act=act,
                                        n_valid=n_valid)
        step = _stack_int8_step(x, q1, heads, n_valid, act)
        err = _int8_parity(f"K19a {label} depth 1", got, want, step, x)
        got = vs.vit_layers_int8(x, qn, heads, eps=EPS, act=act,
                                 n_valid=n_valid)
        want = vs.vit_layers_int8_plain(x, qn, heads, eps=EPS, act=act,
                                        n_valid=n_valid)
        torch.cuda.synchronize()
        _relnorm(f"K19a {label} depth {depth}, all rows", got, want,
                 STACK_INT8_NORM)
        return max(err, float((got.float() - want.float()).abs().max()))

    print("K19a edges: batches, key tiles, quick_gelu, ViT-L/16 width")
    for batch in (2, 3):
        worst = max(worst, case(f"b{batch} (rows {batch * 200})",
                                _stack_x(batch, seed=151 + batch), q1, q12,
                                12, heads, 197))
    for nv in (1, 127, 128, 129, 197, 256):
        worst = max(worst, case(f"b1 n_pad 256 n_valid {nv}",
                                _stack_x(1, n_pad=256, seed=160 + nv), q1,
                                q12, 12, heads, nv))
    worst = max(worst, case("b1 quick_gelu", _stack_x(1, seed=170), q1, q12,
                            12, heads, 197, act="quick_gelu"))
    _, ql, _ = _stack_trees(2, seed=180, static=False, d=1024, m=4096)
    worst = max(worst, case("ViT-L/16 width b1 (D 1024, M 4096, 16 heads)",
                            _stack_x(1, d=1024, seed=181),
                            {k: v[:1] for k, v in ql.items()}, ql, 2, 16,
                            197))
    x = _stack_x(1, seed=190)
    _repeat_identical("K19a b1 depth 12", lambda: vs.vit_layers_int8(
        x, q12, heads, eps=EPS, n_valid=197))
    return worst


def _k19b_clipped(x, s1, heads, n_valid, act="gelu_tanh"):
    """The shares of layer 0's aoq and hq that saturate (|.| > 127.5 in the
    quant domain) over the valid rows, by the plain version's steps."""
    from vit_fpga_tpu_torch.ops import quant_block as qb
    from vit_fpga_tpu_torch.ops.attn_block import _mha_tpu
    from vit_fpga_tpu_torch.ops.quant_fused import _int_matmul
    blk = {k: v[0] for k, v in s1.items()}
    xq = qb._rint_i8(qb._ln_f32(x, blk["ln1_scale"], blk["ln1_bias"], EPS))
    qkv = (_int_matmul(xq, blk["wqkv_q"]) * blk["wqkv_s"]
           + blk["bqkv"]).to(x.dtype)
    ao = _mha_tpu(qkv, heads, n_valid, out_scale=blk["inv_ao"]).float()
    x1 = qb.attn_block_int8_static_plain(
        x, blk["inv_ao"], blk["ln1_scale"], blk["ln1_bias"], blk["wqkv_q"],
        blk["wqkv_s"], blk["bqkv"], blk["wo_q"], blk["wo_s"], blk["bo"],
        heads, eps=EPS, n_valid=n_valid)
    xq2 = qb._rint_i8(qb._ln_f32(x1, blk["ln2_scale"], blk["ln2_bias"], EPS))
    h = qb._apply_act_scaled(_int_matmul(xq2, blk["w1_q"]) * blk["w1_s"]
                             + blk["b1"], act, blk["inv_ah"])
    return (_clipped(ao[:, :n_valid], 1.0),
            _clipped(h[:, :n_valid], 1.0))


def _k19b_edges(heads=12):
    """K19b (the static variant of the wgmma layer loop: int8 items of 128
    rows, split-K with aoq and hq by TMA, the attention's int8 epilogue)
    at the edges of its design: b2 and b3 (400 and 600 rows), 1 / 127 /
    128 / 129 / 197 / 256 valid keys at n_pad 256, quick_gelu on its own
    calibration and ViT-L/16's width (D 1024, M 4096, 16 heads), each at
    one layer in the static int8 band and deeper in norm; a saturating
    case on scales calibrated to half the range, whose clipped shares of
    aoq and hq are printed and must be > 0; then 20 back-to-back b1
    depth-12 launches bit for bit.  Returns the max-abs error."""
    from vit_fpga_tpu_torch.ops import vit_stack as vs
    worst = 0.0
    _, _, s12 = _stack_trees(12, seed=150)

    def case(label, x, s1, sn, depth, heads, n_valid, act="gelu_tanh"):
        got = vs.vit_layers_int8_static(x, s1, heads, eps=EPS, act=act,
                                        n_valid=n_valid)
        want = vs.vit_layers_int8_static_plain(x, s1, heads, eps=EPS,
                                               act=act, n_valid=n_valid)
        step = (127.0 * (s1["wo_s"][0] + s1["w2_s"][0])).expand_as(x)
        err = _int8_parity(f"K19b {label} depth 1", got, want, step, x,
                           mag_x=True)
        got = vs.vit_layers_int8_static(x, sn, heads, eps=EPS, act=act,
                                        n_valid=n_valid)
        want = vs.vit_layers_int8_static_plain(x, sn, heads, eps=EPS,
                                               act=act, n_valid=n_valid)
        torch.cuda.synchronize()
        _relnorm(f"K19b {label} depth {depth}, all rows", got, want,
                 STACK_INT8_NORM)
        return max(err, float((got.float() - want.float()).abs().max()))

    def first(tree):
        return {k: v[:1] for k, v in tree.items()}

    print("K19b edges: batches, key tiles, quick_gelu, ViT-L/16 width, "
          "saturation")
    for batch in (2, 3):
        worst = max(worst, case(f"b{batch} (rows {batch * 200})",
                                _stack_x(batch, seed=151 + batch),
                                first(s12), s12, 12, heads, 197))
    for nv in (1, 127, 128, 129, 197, 256):
        worst = max(worst, case(f"b1 n_pad 256 n_valid {nv}",
                                _stack_x(1, n_pad=256, seed=160 + nv),
                                first(s12), s12, 12, heads, nv))
    _, _, sq = _stack_trees(12, seed=170, act="quick_gelu")
    worst = max(worst, case("b1 quick_gelu", _stack_x(1, seed=171),
                            first(sq), sq, 12, heads, 197, act="quick_gelu"))
    _, _, sl = _stack_trees(2, seed=180, d=1024, m=4096)
    worst = max(worst, case("ViT-L/16 width b1 (D 1024, M 4096, 16 heads)",
                            _stack_x(1, d=1024, seed=181), first(sl), sl, 2,
                            16, 197))
    _, _, ss = _stack_trees(2, seed=185, shrink=SHRINK)
    x = _stack_x(1, seed=186)
    cao, ch = _k19b_clipped(x, first(ss), heads, 197)
    print(f"  K19b saturating (scales / {SHRINK:g}): clipped share of layer "
          f"0's aoq {cao:.3e}, hq {ch:.3e} (each must be > 0)")
    if not min(cao, ch) > 0.0:
        raise AssertionError("K19b saturating case: nothing clipped")
    worst = max(worst, case(f"b1 saturating (scales / {SHRINK:g})", x,
                            first(ss), ss, 2, heads, 197))
    x = _stack_x(1, seed=190)
    _repeat_identical("K19b b1 depth 12", lambda: vs.vit_layers_int8_static(
        x, s12, heads, eps=EPS, n_valid=197))
    return worst


def _bf16_stack(depth, seed, d=768, m=3072):
    """The bf16 tree of ``_stack_trees`` alone (no int8 weights made)."""
    p = _stack_blocks(depth, d=d, m=m, seed=seed)
    return {k: (v.to(torch.bfloat16) if k in ("wqkv", "wo", "w1", "w2")
                else v) for k, v in p.items()}


def _k11_edges(heads=12):
    """K11 (the bf16 variant of the wgmma layer loop, K12's layers without
    its patch embed and head) at the edges of its design: 1 / 17 / 197 /
    256 valid keys at n_pad 256 (one or two key tiles, the last masked),
    b4 at n_pad 256 (1024 rows, eight 128-row items), quick_gelu and
    ViT-L/16's width (D 1024, M 4096, 16 heads), each at one layer in the
    bf16 band and deeper in norm; then 20 back-to-back b1 depth-12
    launches bit for bit.  Returns the max-abs error."""
    from vit_fpga_tpu_torch.ops import vit_stack as vs
    worst = 0.0
    bf12 = _bf16_stack(12, seed=150)

    def first(tree):
        return {k: v[:1] for k, v in tree.items()}

    def case(label, x, b1, bn, depth, heads, n_valid, act="gelu_tanh"):
        got = vs.vit_layers(x, b1, heads, eps=EPS, act=act, n_valid=n_valid)
        want = vs.vit_layers_plain(x, b1, heads, eps=EPS, act=act,
                                   n_valid=n_valid)
        torch.cuda.synchronize()
        err = _compare(f"K11 {label} depth 1", got, want, BF16_TOL, BF16_TOL)
        _branch(f"K11 {label} depth 1 branch", got, want, x)
        got = vs.vit_layers(x, bn, heads, eps=EPS, act=act, n_valid=n_valid)
        want = vs.vit_layers_plain(x, bn, heads, eps=EPS, act=act,
                                   n_valid=n_valid)
        torch.cuda.synchronize()
        _relnorm(f"K11 {label} depth {depth}, all rows", got, want,
                 STACK_BF16_NORM)
        return max(err, float((got.float() - want.float()).abs().max()))

    print("K11 edges: key tiles, b4, quick_gelu, ViT-L/16 width")
    for nv in (1, 17, 197, 256):
        worst = max(worst, case(f"b1 n_pad 256 n_valid {nv}",
                                _stack_x(1, n_pad=256, seed=160 + nv),
                                first(bf12), bf12, 12, heads, nv))
    worst = max(worst, case("b4 n_pad 256 n_valid 256",
                            _stack_x(4, n_pad=256, seed=165), first(bf12),
                            bf12, 12, heads, 256))
    worst = max(worst, case("b1 quick_gelu", _stack_x(1, seed=170),
                            first(bf12), bf12, 12, heads, 197,
                            act="quick_gelu"))
    bl = _bf16_stack(2, seed=180, d=1024, m=4096)
    worst = max(worst, case("ViT-L/16 width b1 (D 1024, M 4096, 16 heads)",
                            _stack_x(1, d=1024, seed=181), first(bl), bl, 2,
                            16, 197))
    x = _stack_x(1, seed=190)
    _repeat_identical("K11 b1 depth 12", lambda: vs.vit_layers(
        x, bf12, heads, eps=EPS, n_valid=197))
    return worst


def _stack_int8_step(x, q1, heads, n_valid, act="gelu_tanh"):
    """One quantization step of a one-layer K19a output, elementwise: its
    K16's (out-projection) plus its K15's (W2).  The layer's output carries
    both: K16's output is K15's residual."""
    from vit_fpga_tpu_torch.ops import quant_block as qb
    blk = {k: v[0] for k, v in q1.items()}
    qa = dict(ln_scale=blk["ln1_scale"], ln_bias=blk["ln1_bias"],
              wqkv_q=blk["wqkv_q"], wqkv_s=blk["wqkv_s"], bqkv=blk["bqkv"],
              wo_s=blk["wo_s"])
    x1 = qb.attn_block_int8_plain(
        x, blk["ln1_scale"], blk["ln1_bias"], blk["wqkv_q"], blk["wqkv_s"],
        blk["bqkv"], blk["wo_q"], blk["wo_s"], blk["bo"], heads, eps=EPS,
        n_valid=n_valid)
    b, n, d = x1.shape
    qm = dict(ln_scale=blk["ln2_scale"], ln_bias=blk["ln2_bias"],
              w1_q=blk["w1_q"], w1_s=blk["w1_s"], b1=blk["b1"],
              w2_s=blk["w2_s"])
    return (_k16_step(x, qa, heads, n_valid)
            + _k15_step(x1.reshape(b * n, d), qm, act).reshape(b, n, d))


def _stack_library(x, tree, heads, n_valid, int8, static=False):
    """The 12 layers as PyTorch calls the port never makes: F.layer_norm,
    matmuls (torch._int_mm with the quantization and dequantization in
    torch ops for int8; per-tensor static scales with ``static``), SDPA
    with the key mask, tanh-GELU."""
    import torch.nn.functional as F
    from vit_fpga_tpu_torch.ops.quant_fused import _row_quant as rq
    b, n_pad, d = x.shape
    rows, dh, bf = b * n_pad, d // heads, torch.bfloat16
    keep = (torch.arange(n_pad, device="cuda") < n_valid)[None, None, None]
    depth = tree["bqkv"].shape[0]
    if not int8:
        lay = [{k: (v[i].to(bf)) for k, v in tree.items()}
               for i in range(depth)]

        def lin(h, blk, w, bias):
            return torch.addmm(blk[bias], h.reshape(rows, -1), blk[w])
    else:
        lay = [{k: v[i] for k, v in tree.items()} for i in range(depth)]
        # the static tree's input scale of each linear: 1 after the folded
        # LayerNorms, 1/a_ao and 1/a_h for the attention output and h
        inv = {"wqkv": "one", "wo": "inv_ao", "w1": "one", "w2": "inv_ah"}
        one = torch.ones((1,), device="cuda")

        def lin(h, blk, w, bias):
            h = h.reshape(rows, -1).float()
            if static:
                hq = torch.clamp(torch.round(
                    h * blk.get(inv[w], one)), -127, 127).to(torch.int8)
                sh = 1.0
            else:
                hq, sh = rq(h)
            return (torch._int_mm(hq, blk[w + "_q"]).float()
                    * (sh * blk[w + "_s"]) + blk[bias]).to(bf)

    def run():
        h0 = x
        for blk in lay:
            ln = (blk["ln1_scale"], blk["ln1_bias"], blk["ln2_scale"],
                  blk["ln2_bias"])
            h = F.layer_norm(h0, (d,), ln[0].to(h0.dtype), ln[1].to(h0.dtype),
                             EPS)
            qkv = lin(h, blk, "wqkv", "bqkv").view(b, n_pad, 3, heads, dh)
            q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
            ao = F.scaled_dot_product_attention(q, k, v, attn_mask=keep)
            h0 = h0 + lin(ao.transpose(1, 2), blk, "wo", "bo").view_as(h0)
            h = F.layer_norm(h0, (d,), ln[2].to(h0.dtype), ln[3].to(h0.dtype),
                             EPS)
            h = F.gelu(lin(h, blk, "w1", "b1"), approximate="tanh")
            h0 = h0 + lin(h, blk, "w2", "b2").view_as(h0)
        return h0
    return run


def phase_stack_timing(batches=(1, 4), n_valid=197, heads=12, d=768,
                       m=3072):
    """K11 and K19a at depth 12 at each batch: the kernel's time, its
    plain version's, the library yardstick's and the bound.  Returns
    {batch: {name: dict of times}}."""
    from vit_fpga_tpu_torch.ops import vit_stack as vs
    from vit_fpga_tpu_torch.utils.timing import time_cuda
    bf12, q12, s12 = _stack_trees(12, seed=110)
    depth, out = 12, {}
    wmat = 4 * d * d + 2 * d * m                 # weights per layer
    vecs = 3 * d + d + m + d + 4 * d             # biases and LN per layer
    for batch in batches:
        x = _stack_x(batch, seed=111)
        tok = batch * n_valid                   # the rows this input needs
        gemm = 2 * tok * wmat * depth
        attn = 4 * batch * heads * n_valid * n_valid * (d // heads) * depth
        act_bytes = 2 * batch * 200 * d * 2     # x in, tokens out
        cases = {
            "vit_layers": (vs.vit_layers, vs.vit_layers_plain, bf12, False,
                           _bound(gemm + attn, depth * (wmat * 2 + vecs * 4)
                                  + act_bytes)),
            "vit_layers_int8": (
                vs.vit_layers_int8, vs.vit_layers_int8_plain, q12, True,
                _bound_int8(gemm, attn, depth * (wmat + (vecs + 3 * d + m)
                                                 * 4) + act_bytes)),
            "vit_layers_int8_static": (
                vs.vit_layers_int8_static, vs.vit_layers_int8_static_plain,
                s12, True,
                _bound_int8(gemm, attn, depth * (wmat + (vecs + 3 * d + m
                                                         + 2) * 4)
                            + act_bytes)),
        }
        out[batch] = {}
        for name, (kern, plain, tree, int8, (bound_ms, bound_by)) in \
                cases.items():
            ms = time_cuda(lambda: kern(x, tree, heads, eps=EPS,
                                        n_valid=n_valid), iters=50, warmup=5)
            plain_ms = time_cuda(lambda: plain(x, tree, heads, eps=EPS,
                                               n_valid=n_valid),
                                 iters=3, warmup=1)
            lib_ms = _library_ms(_stack_library(
                x, tree, heads, n_valid, int8,
                static=name == "vit_layers_int8_static"), name)
            out[batch][name] = dict(ms=ms, plain_ms=plain_ms,
                                    library_ms=lib_ms, bound_ms=bound_ms,
                                    bound_by=bound_by)
            print(f"timing {name} b{batch} depth 12: kernel {ms:.4f} ms, "
                  f"plain {plain_ms:.4f} ms, library {lib_ms} ms, bound "
                  f"{bound_ms:.4f} ms ({bound_by})")
    return out


def phase_latency_forward_time(iters=50):
    """ms per b1 request of the single-launch forwards against the port's
    throughput forwards at b1 (24 or 25 kernel launches), timed in turns
    (throughput, latency, latency, throughput) on one seeded image; then
    the dynamic and static int8 latency forwards in turns."""
    from vit_fpga_tpu_torch.models import quantized, vit
    from vit_fpga_tpu_torch.utils.timing import time_cuda
    cfg = vit.config("vit_b16", dtype="bfloat16")
    params = vit.init_params(cfg, _gen(7), device="cuda")
    qparams = quantized.quantize_vit_fast(params)
    image = torch.from_numpy(np.random.default_rng(7).integers(
        0, 256, (1, cfg.image_size, cfg.image_size, 3), np.uint8)).cuda()
    fwds = {"bf16 throughput": vit.make_forward(cfg, params),
            "bf16 latency": vit.make_forward_latency(cfg, params),
            "int8 throughput": quantized.make_forward_int8(cfg, qparams),
            "int8 latency": quantized.make_forward_int8_latency(cfg, qparams),
            "int8 static latency": quantized.make_forward_int8_latency(
                cfg, quantized.quantize_vit_static(params, cfg))}
    runs = {name: [] for name in fwds}
    turns = [f"{dt} {kind}" for dt in ("bf16", "int8")
             for kind in ("throughput", "latency", "latency", "throughput")]
    turns += ["int8 latency", "int8 static latency", "int8 static latency",
              "int8 latency"]
    for name in turns:
        runs[name].append(time_cuda(lambda: fwds[name](image), iters=iters,
                                    warmup=5))
    for name, ms in runs.items():
        print(f"forward {name} b1: " + " / ".join(f"{t:.4f}" for t in ms)
              + " ms per request")
    return runs


def phase_latency_serve(n_requests=64, n_check=3):
    """ImageServer(batch_size=1) over each latency forward answers
    ``n_requests`` uint8 requests, one at a time (submit, then wait):
    exact launch counts per request, p50/p99 on the host clock, and the
    logits of ``n_check`` images against the CPU forward of the same
    weights.  Returns {kernel name: launches}."""
    from unittest import mock

    from vit_fpga_tpu_torch.models import quantized, vit
    from vit_fpga_tpu_torch.ops import quant_fused as qf
    from vit_fpga_tpu_torch.ops import vit_stack as vs
    from vit_fpga_tpu_torch.runtime.serving import ImageServer
    from vit_fpga_tpu_torch.utils.log import Metrics
    cfg = vit.config("vit_b16", dtype="bfloat16")
    params = vit.init_params(cfg, _gen(8), device="cuda")
    trees = {"int8": quantized.quantize_vit_fast(params),
             "int8 static": quantized.quantize_vit_static(params, cfg)}
    images = np.random.default_rng(8).integers(
        0, 256, (n_requests, cfg.image_size, cfg.image_size, 3), np.uint8)
    paths = {
        "bf16": (vit.make_forward_latency(cfg, params),
                 lambda: vit.make_forward_latency(
                     cfg, _tree_to(params, "cpu"), device="cpu"),
                 {"vit_layers": 1}, LOGITS_BAND),
    }
    for label, layers in (("int8", "vit_layers_int8"),
                          ("int8 static", "vit_layers_int8_static")):
        paths[label] = (
            quantized.make_forward_int8_latency(cfg, trees[label]),
            lambda t=trees[label]: quantized.make_forward_int8_latency(
                cfg, _tree_to(t, "cpu"), device="cpu"),
            {layers: 1, "int8_linear_fused": 1}, INT8_LOGITS_BAND)
    counters = _counters()
    launches = {}
    idx = list(range(n_check))
    for label, (fwd, cpu_maker, per_req, band) in paths.items():
        fwd(images[:1])                      # first launch: library loads
        torch.cuda.synchronize()
        Metrics.reset()
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        with ImageServer(fwd, image_size=cfg.image_size,
                         batch_size=1) as server:
            results = [server.submit_raw(img).result(timeout=600)
                       for img in images]
            wall = time.perf_counter() - t0
            pct = server.latency_percentiles()
        got_launches = {k: fn.launches for k, fn in counters.items()}
        print(f"latency slice {label}: {len(results)}/{n_requests} answered "
              f"in {server.batches} batches, {wall:.3f} s, p50 "
              f"{pct['p50']:.3f} ms, p99 {pct['p99']:.3f} ms (submit to "
              f"logits, one request in flight)")
        print(f"latency slice {label} launches: {got_launches}")
        if len(results) != n_requests or server.served != n_requests:
            raise AssertionError(f"{label}: not every request was answered")
        for r in results:
            if r.shape != (cfg.num_classes,) or not np.isfinite(r).all():
                raise AssertionError(f"{label}: bad logits row {r.shape}")
        for name, n in got_launches.items():
            want = per_req.get(name, 0) * n_requests
            if n != want:
                raise AssertionError(f"{label}: {name} launched {n} times "
                                     f"for {n_requests} requests, want {want}")
        launches.update({k: v for k, v in got_launches.items()
                         if k in LATENCY_KERNELS and k in per_req})
        ref = cpu_maker()(images[idx]).numpy()
        got = np.stack([results[i] for i in idx])
        rel = float(np.abs(got - ref).max() / np.abs(ref).max())
        note = ""
        if label in trees:                  # the floor: plain on the card
            layers = next(k for k in per_req if k in LATENCY_KERNELS)
            with mock.patch.multiple(
                    quantized, **{layers: getattr(vs, layers + "_plain")},
                    int8_linear_fused=qf.int8_linear_fused_plain):
                floor = quantized.make_forward_int8_latency(
                    cfg, trees[label])(images[idx]).cpu().numpy()
            floor = float(np.abs(floor - ref).max() / np.abs(ref).max())
            note = f"; plain versions on the card vs the CPU: {floor:.3e}"
        print(f"latency slice {label} logits of images {idx} vs the CPU "
              f"forward: max_rel={rel:.3e} (band {band}{note}), top-1 agree "
              f"{int((got.argmax(1) == ref.argmax(1)).sum())}/{len(idx)}")
        if not rel <= band:
            raise AssertionError(f"{label}: card logits disagree with the "
                                 f"CPU latency forward")
    return launches


def run_latency_phases(errors, timing, launches):
    """The batch-1 latency phases after the earlier slices' ones."""
    stack_timing = phase_stack_timing()
    for name in LATENCY_KERNELS:
        timing[name] = dict(stack_timing[1][name], max_abs_err=errors[name])
    phase_latency_forward_time()
    launches.update(phase_latency_serve())


# ---------------------------------------------------------------------------
# 12. The dense NetAbstract backend: K25 (image filter), K13 (int8 GEMM),
#     NetCUDA and its 24-deep streaming ring
# ---------------------------------------------------------------------------

# The dense network's shapes: the repo's MNIST-sized net 784 -> [256, 10]
# at batch 10 000 (two K13 launches per int8 forward), then ViT-B's MLP
# GEMM; the 1080p frame of the reference's image ring; ragged edges.
K13_SHAPES = ((10000, 784, 256), (10000, 256, 10), (12800, 768, 3072),
              (1, 1, 1))
# K13's wgmma tiles' edges (M past a 128-row tile; N 1, 3, 10 and 1002,
# whose int32 rows no TMA store takes, the last on 256-wide tiles; N 8 and
# 128 on 128-wide tiles stored by TMA; K 1 padded to 16, 33, and 784 with
# its partial 128-deep step) and the per-tensor int8 forward's two widest
# GEMMs.  Then all -128 operands at K 3072, where the int32 sums are
# largest.
K13_EDGES = ((1, 784, 256), (129, 784, 256), (129, 33, 1), (129, 1, 3),
             (300, 784, 10), (257, 200, 1002), (129, 784, 8),
             (300, 784, 128), (12608, 768, 2304), (12608, 3072, 768))
K13_MINUS_128 = ((200, 3072, 8), (64, 3072, 300))
# K25: the ring's 1080p frame first (timed), 4K, a ragged last strip of
# rows, widths off the 16-byte chunk, the thinnest frames.
K25_SHAPES = ((1080, 1920), (33, 45), (1, 1), (2160, 3840), (1081, 1920),
              (1080, 1921), (17, 16), (1, 4096), (4096, 1))
K25_TIMED = ((1080, 1920), (2160, 3840))
DENSE_BATCH = 10000
# NetCUDA against the NumPy oracle NetCPU at batch 10 000, relative to the
# largest output: f32 runs the same products with the sums in another
# order (TF32 off; 6e-7 measured for the port's plain path on a CPU);
# bf16 rounds the inputs, the weights and the hidden layer to 8 bits
# (7e-3 measured on a CPU).  Training: 50 SGD steps of both from the same
# weights; a 1e-7 relative nudge of the weights moves the trained ones by
# 3e-7 in relative norm (CPU rehearsal), so 1e-4.
DENSE_F32_BAND = 1e-5
DENSE_BF16_BAND = 2e-2
DENSE_TRAIN_BAND = 1e-4
DENSE_KERNELS = ("filter_image_device", "int8_gemm")


def _int8_rand(gen, *shape):
    return torch.randint(-127, 128, shape, generator=gen,
                         dtype=torch.int8).cuda()


def _frame(rng, h, w):
    return rng.integers(0, 256, (h, w), np.uint8)


def _k25_frames(rng):
    """(label, numpy frame, the frame on the card) at each K25_SHAPES shape,
    then the 1080p frame viewed at storage offset 1: contiguous, but not
    16-byte aligned."""
    for h, w in K25_SHAPES:
        img = _frame(rng, h, w)
        yield f"{h}x{w}", img, torch.from_numpy(img).cuda()
    h, w = K25_SHAPES[0]
    img = _frame(rng, h, w)
    buf = torch.empty(h * w + 1, dtype=torch.uint8, device="cuda")
    dev = buf[1:].view(h, w)
    dev.copy_(torch.from_numpy(img))
    yield f"{h}x{w} at storage offset 1", img, dev


def phase_dense_kernels():
    """K25 and K13 against their plain versions on the card, bit for bit:
    K25 with each filter at each K25_SHAPES shape and at a 1080p frame at
    storage offset 1, also against the port's numpy oracle
    filter_image_numpy, with the chunk each took (16 bytes where W % 16 ==
    0 and both frames are 16-byte aligned, else 1; both must be taken);
    K13 at the dense net's two layers, ViT-B's MLP GEMM and 1 x 1 x 1.
    Returns {name: max abs err}."""
    from vit_fpga_tpu_torch.ops import image_filter as imf
    from vit_fpga_tpu_torch.ops import quant
    rng = np.random.default_rng(60)
    chunks = set()
    for label, img, dev in _k25_frames(rng):
        for name in sorted(imf.FILTERS):
            got = imf.filter_image_device(dev, name)
            plain = imf.filter_image_plain(dev, name)
            torch.cuda.synchronize()
            g = got.cpu().numpy()
            if not (np.array_equal(g, plain.cpu().numpy())
                    and np.array_equal(g, imf.filter_image_numpy(img, name))):
                raise AssertionError(f"K25 {name} at {label} differs from "
                                     f"its plain version or the oracle")
        chunk = imf.filter_chunk_bytes(dev, got)
        chunks.add(chunk)
        print(f"parity K25 filter_image_device {label}: all four filters bit "
              f"for bit with the plain version and filter_image_numpy "
              f"({chunk}-byte chunks)")
    if chunks != {1, 16}:
        raise AssertionError(f"K25 took only {sorted(chunks)}-byte chunks")
    gen = _gen(61)
    cases = ([(m, k, n, None) for m, k, n in K13_SHAPES + K13_EDGES]
             + [(m, k, n, -128) for m, k, n in K13_MINUS_128])
    for m, k, n, fill in cases:
        if fill is None:
            a, b = _int8_rand(gen, m, k), _int8_rand(gen, k, n)
        else:
            a = torch.full((m, k), fill, dtype=torch.int8, device="cuda")
            b = torch.full((k, n), fill, dtype=torch.int8, device="cuda")
        got = quant.int8_gemm(a, b)
        want = quant.int8_gemm_plain(a, b)
        torch.cuda.synchronize()
        what = (f"K13 ({m}, {k}) x ({k}, {n})"
                + ("" if fill is None else f" all {fill}"))
        if got.dtype != torch.int32 or not torch.equal(got, want):
            bad = int((got != want).sum())
            raise AssertionError(f"{what}: {bad} elements differ from the "
                                 f"plain version")
        print(f"parity {what}: bit for bit with the plain version (|acc| "
              f"max {int(want.abs().max())})")
    return {"filter_image_device": 0.0, "int8_gemm": 0.0}


PROFILER_TRIES = 3


def _events_alone_ms(fn, iters, why):
    """The fallback of the two profiler timings below: mean ms per call of
    ``iters`` back-to-back calls of ``fn`` between two CUDA events, which
    hold the wrapper's host time too where it exceeds the device's.  Says
    so on a line of its own, with ``why`` the profiler could not be
    read."""
    from vit_fpga_tpu_torch.utils.timing import time_cuda
    ms = time_cuda(fn, iters=iters)
    print(f"  torch.profiler: {why} in {PROFILER_TRIES} tries; timed with "
          f"CUDA events over {iters} back-to-back calls instead "
          f"({ms:.4f} ms, host time included where it is the longer)")
    return ms


def _profiled(fn, iters):
    """torch.profiler's key averages of the CUDA activity over ``iters``
    back-to-back calls of ``fn``, after one untimed call."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return prof.key_averages()


def _device_ms(fn, kernel, wrapper, iters=20):
    """Mean device time in ms of the launches of ``kernel`` (a substring of
    the CUDA kernel's name) per call of ``fn``, from torch.profiler's CUDA
    activity: the kernel alone, without the host time of its wrapper,
    which exceeds it for K25 and the small K13 launches.  ``wrapper``'s
    launch counter must rise by exactly one a call.  The profiler's
    activity buffer may drop a record now and then, so the mean is taken
    over the launches it saw, which must be at least half and at most
    all of them; a profiler that sees fewer in every one of
    ``PROFILER_TRIES`` tries gives way to ``_events_alone_ms``."""
    for _ in range(PROFILER_TRIES):
        before = wrapper.launches
        averages = _profiled(fn, iters)
        if wrapper.launches - before != iters + 1:
            raise AssertionError(f"{wrapper.__name__} launched "
                                 f"{wrapper.launches - before} times in "
                                 f"{iters + 1} calls")
        evs = [e for e in averages if kernel in e.key]
        count = sum(e.count for e in evs)
        if count > iters:
            raise AssertionError(f"profiler saw {count} launches of "
                                 f"{kernel!r} in {iters} calls")
        if count >= iters // 2:
            if count < iters:
                print(f"  the profiler saw {count} of the {iters} launches "
                      f"of {kernel!r}; the mean is over those")
            return sum(e.device_time_total for e in evs) / count / 1e3
        print(f"  the profiler saw {count} of the {iters} launches of "
              f"{kernel!r}")
    return _events_alone_ms(fn, iters, f"fewer than half the launches of "
                            f"{kernel!r} seen")


def phase_dense_timing():
    """Times of K13 at its three path shapes and K25 at K25_TIMED (1080p,
    4K): the kernel's device time (``_device_ms``) and its time per call
    back to back (CUDA events; the wrapper's host time shows there), the
    plain version, a library yardstick (torch._int_mm on shapes padded to
    what it takes; F.conv2d in f32 with TF32 off, then round and clip, per
    call and device alone) and the bound.  Returns {name: times} at the
    main path's shapes (K13: the dense net's first layer; K25: 1080p)."""
    import torch.nn.functional as F
    from vit_fpga_tpu_torch.ops import image_filter as imf
    from vit_fpga_tpu_torch.ops import quant
    from vit_fpga_tpu_torch.ops.common import round_up
    from vit_fpga_tpu_torch.ops.quant_fused import kmajor
    from vit_fpga_tpu_torch.utils.timing import time_cuda
    out = {}
    gen = _gen(62)
    for m, k, n in K13_SHAPES[:3]:
        a, b = _int8_rand(gen, m, k), kmajor(_int8_rand(gen, k, n))
        mp, kp, np_ = max(m, 17), round_up(k, 8), round_up(n, 8)
        ap = torch.zeros((mp, kp), dtype=torch.int8, device="cuda")
        ap[:m, :k] = a
        bp = torch.zeros((kp, np_), dtype=torch.int8, device="cuda")
        bp[:k, :n] = b
        bp = kmajor(bp)
        ms = _device_ms(lambda: quant.int8_gemm(a, b), "qgemm_wgmma_kernel",
                        quant.int8_gemm)
        call_ms = time_cuda(lambda: quant.int8_gemm(a, b))
        plain_ms = time_cuda(lambda: quant.int8_gemm_plain(a, b), iters=5,
                             warmup=1)
        lib_ms = _library_ms(lambda: torch._int_mm(ap, bp),
                             f"int8_gemm {m}x{k}x{n}")
        ops, nbytes = 2 * m * k * n, m * k + k * n + 4 * m * n
        bound_ms, bound_by = _bound_int8(ops, 0, nbytes)
        print(f"timing int8_gemm ({m}, {k}) x ({k}, {n}): kernel {ms:.4f} "
              f"ms on the card ({call_ms:.4f} ms per call), plain {plain_ms:.4f} ms, library {lib_ms} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}, {ops / 1e9:.2f} G int8 ops, "
              f"{nbytes / 1e6:.2f} MB); {ops / ms / 1e9:.1f} TOPS")
        out.setdefault("int8_gemm", dict(ms=ms, plain_ms=plain_ms,
                                         library_ms=lib_ms, bound_ms=bound_ms,
                                         bound_by=bound_by))
    rng = np.random.default_rng(63)
    for h, w in K25_TIMED:
        img = torch.from_numpy(_frame(rng, h, w)).cuda()
        taps = torch.from_numpy(imf.FILTERS["sharpen"])[None, None].cuda()

        def library(img=img, taps=taps):
            with torch.backends.cudnn.flags(allow_tf32=False):
                acc = F.conv2d(img.float()[None, None], taps, padding=1)
            return torch.clamp(torch.round(acc[0, 0]), 0, 255).to(torch.uint8)

        def kern(img=img):
            return imf.filter_image_device(img, "sharpen")

        if not torch.equal(library(), kern()):
            raise AssertionError("the K25 yardstick computes another function")
        ms = _device_ms(kern, "filter_kernel", imf.filter_image_device)
        call_ms = time_cuda(kern, iters=50)
        plain_ms = time_cuda(lambda img=img: imf.filter_image_plain(img,
                                                                    "sharpen"))
        lib_ms = _library_ms(library, f"filter_image_device {h}x{w}")
        lib_dev = (_device_alone_ms(library, iters=20) if lib_ms is not None
                   else None)
        nbytes, flops = 2 * h * w, 2 * 9 * h * w  # 9 f32 multiply-adds a pixel
        t_ops = flops / H100_F32_FLOPS * 1e3
        t_mem = nbytes / H100_HBM_BYTES_PER_S * 1e3
        bound_ms, bound_by = ((t_ops, "operations") if t_ops >= t_mem
                              else (t_mem, "bytes"))
        print(f"timing filter_image_device {h}x{w} sharpen: kernel {ms:.4f} "
              f"ms on the card ({call_ms:.4f} ms per call), plain "
              f"{plain_ms:.4f} ms, library {lib_ms} ms per call, {lib_dev} ms "
              f"device alone, bound {bound_ms:.4f} ms ({bound_by}, "
              f"{nbytes / 1e6:.2f} MB); {nbytes / ms / 1e6:.1f} GB/s")
        out.setdefault("filter_image_device", dict(
            ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
            bound_by=bound_by))
    return out


def _dense_net():
    from vit_fpga_tpu_torch.defines import ACT_IDENTITY, ACT_RELU2, random_net
    return random_net(784, [256, 10], seed=0,
                      activations=[ACT_RELU2, ACT_IDENTITY])


def _zero_counters():
    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    counters["attn_block_stats"].launches_long = 0
    counters["attn_block_fwd"].launches_long = 0
    return counters


def _check_launches(label, counters, want):
    launches = {k: fn.launches for k, fn in counters.items()}
    for name, n in launches.items():
        if n != want.get(name, 0):
            raise AssertionError(f"{label}: {name} launched {n} times, want "
                                 f"{want.get(name, 0)}")
    return launches


def _rel_to_max(label, got, want, band):
    rel = float(np.abs(got - want).max() / np.abs(want).max())
    print(f"  {label}: max |a-b| / max |b| = {rel:.3e} (band {band:g})")
    if not (np.isfinite(got).all() and rel <= band):
        raise AssertionError(f"{label}: the card disagrees with the CPU")


def phase_dense_backend(batch=DENSE_BATCH, n_sets=128):
    """NetCUDA on the card, 784 -> [256, 10] (relu, identity) at batch
    10 000 of pixel-like inputs: f32 and bf16 against NetCPU within their
    bands; int8 bit for bit against mlp_forward_int8_numpy with exactly 2
    K13 launches per forward; 50 SGD steps (lr 0.01) on 128 one-hot sets:
    the loss falls and the weights stay within DENSE_TRAIN_BAND of NetCPU
    trained the same way; get_net_data round-trips bit for bit; int8
    requantizes after training.  Returns the K13 launches of the int8
    forwards."""
    from vit_fpga_tpu_torch.backends.cpu import NetCPU
    from vit_fpga_tpu_torch.backends.cuda import NetCUDA
    from vit_fpga_tpu_torch.defines import NetSets
    from vit_fpga_tpu_torch.models import quantized
    data = _dense_net()
    rng = np.random.default_rng(64)
    x = (rng.integers(0, 256, (batch, 784)) / 255.0).astype(np.float32)
    ref = NetCPU(data).forward_batch(x)
    print(f"dense backend: NetCUDA 784 -> [256, 10] at batch {batch}")
    for mode, band in (("float32", DENSE_F32_BAND),
                       ("bfloat16", DENSE_BF16_BAND)):
        net = NetCUDA(data, compute_dtype=mode)
        net.forward_batch(x[:8])         # first GEMM of its type: cuBLAS loads
        got = net.launch_forward(x)
        _rel_to_max(f"{mode} forward vs NetCPU", got, ref, band)
        print(f"  {mode} forward: {net.get_forward_performance()} us "
              f"(host clock, input and output copies included)")

    oracle = quantized.mlp_forward_int8_numpy(quantized.quantize_mlp(data), x)
    net8 = NetCUDA(data, compute_dtype="int8")
    net8.forward_batch(x[:8])            # quantizes the weights once
    counters = _zero_counters()
    got = net8.launch_forward(x)
    k13 = _check_launches("int8 forward", counters, {"int8_gemm": 2})
    if not np.array_equal(got, oracle):
        raise AssertionError(f"int8 forward: {int((got != oracle).sum())} "
                             f"outputs differ from mlp_forward_int8_numpy")
    us = net8.get_forward_performance()
    print(f"  int8 forward: bit for bit mlp_forward_int8_numpy, 2 K13 "
          f"launches, {us} us")
    if not us > 0:
        raise AssertionError("get_forward_performance() read 0")

    X = (rng.integers(0, 256, (n_sets, 784)) / 255.0).astype(np.float32)
    Y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, n_sets)]
    cpu, net = NetCPU(data), NetCUDA(data)
    for n in (cpu, net, net8):
        n.init_gradient(NetSets(X, Y))
    e_cpu = cpu.launch_gradient(50, 1e-6, 0.01)
    errs = net.launch_gradient(50, 1e-6, 0.01)
    print(f"  training: 50 SGD steps on {n_sets} sets, loss {errs[0]:.4f} "
          f"-> {errs[-1]:.4f} (NetCPU {e_cpu[0]:.4f} -> {e_cpu[-1]:.4f}), "
          f"{net.get_gradient_performance()} us")
    if not (np.isfinite(errs).all() and errs[-1] < errs[0]):
        raise AssertionError("training did not lower the loss")
    for l, (a, b) in enumerate(zip(net.get_net_data().params,
                                   cpu.get_net_data().params)):
        rel = float(np.linalg.norm(a - b) / np.linalg.norm(b))
        print(f"  trained W{l} vs NetCPU: relative norm {rel:.3e} "
              f"(band {DENSE_TRAIN_BAND:g})")
        if not rel <= DENSE_TRAIN_BAND:
            raise AssertionError("trained weights disagree with NetCPU")
    clone = NetCUDA(net.get_net_data())
    if not np.array_equal(clone.forward_batch(x), net.forward_batch(x)):
        raise AssertionError("get_net_data does not round-trip")
    print("  get_net_data round-trips bit for bit")

    net8.launch_gradient(50, 1e-6, 0.01)
    counters = _zero_counters()
    got = net8.forward_batch(x)
    launches = _check_launches("int8 forward after training", counters,
                               {"int8_gemm": 2})
    want = quantized.mlp_forward_int8_numpy(
        quantized.quantize_mlp(net8.get_net_data()), x)
    if not np.array_equal(got, want):
        raise AssertionError("int8 forward after training is not the "
                             "requantized oracle")
    print("  int8 after training: requantized, bit for bit the oracle, 2 K13 "
          "launches")
    return {"int8_gemm": k13["int8_gemm"] + launches["int8_gemm"]}


def _ring_fps(net, frames, n):
    """frames/s of ``n`` frames through ``net``'s ring in bursts of its
    depth, each frame taken back and dropped (the host keeps none)."""
    from vit_fpga_tpu_torch.defines import ImageSet
    depth = net._ring.depth
    h, w = frames[0].shape
    t0 = time.perf_counter()
    for b in range(0, n, depth):
        for i in range(b, b + depth):
            net.filter_image(ImageSet(frames[i % len(frames)], original_h=h,
                                      original_w=w, original_x_pos=i))
        for i in range(b, b + depth):
            if net.get_filtered_image().original_x_pos != i:
                raise AssertionError("the ring lost a frame")
    return n / (time.perf_counter() - t0)


def phase_dense_ring(depth=24, bursts=4, h=1080, w=1920):
    """The streaming ring at the reference's geometry: 1080 x 1920 frames,
    depth 24.  ``bursts`` bursts of ``depth`` frames go in and come back
    in FIFO order with their metadata, each bit for bit
    filter_image_numpy; a submit to the full ring drops; a drained ring
    returns the empty sentinel; one K25 launch per frame and nothing else.
    Then frames/s through the full ring against one frame at a time
    (depth 1), in turns.  Returns the K25 launches."""
    import contextlib
    import io

    from vit_fpga_tpu_torch.backends.cuda import NetCUDA
    from vit_fpga_tpu_torch.defines import ImageSet
    from vit_fpga_tpu_torch.ops.image_filter import filter_image_numpy
    rng = np.random.default_rng(65)
    frames = [_frame(rng, h, w) for _ in range(depth)]
    want = [filter_image_numpy(f, "sharpen") for f in frames]

    def submit(net, i, j):
        net.filter_image(ImageSet(frames[j], original_h=h, original_w=w,
                                  original_x_pos=i, original_y_pos=j))

    net = NetCUDA(_dense_net(), ring_depth=depth, image_filter="sharpen")
    for j in range(depth):               # first pass: pinned buffers
        submit(net, j, j)
    for _ in range(depth):
        net.get_filtered_image()
    counters = _zero_counters()
    got, n = [], bursts * depth
    for b in range(bursts):
        for j in range(depth):
            submit(net, b * depth + j, j)
        if b == 0:
            before = net._ring.dropped
            with contextlib.redirect_stdout(io.StringIO()) as log:
                submit(net, -1, 0)
            if (net._ring.dropped - before != 1
                    or "ring full" not in log.getvalue()):
                raise AssertionError("a submit to the full ring did not "
                                     "drop")
        got.extend(net.get_filtered_image() for _ in range(depth))
    launches = _check_launches("ring", counters,
                               {"filter_image_device": n})
    for i, g in enumerate(got):
        if (g.empty or g.original_x_pos != i
                or g.original_y_pos != i % depth
                or (g.original_h, g.original_w) != (h, w)):
            raise AssertionError(f"ring frame {i}: FIFO order or metadata "
                                 f"broken ({g.original_x_pos}, "
                                 f"{g.original_y_pos})")
        if not np.array_equal(g.resized_image_data.reshape(h, w),
                              want[i % depth]):
            raise AssertionError(f"ring frame {i} differs from "
                                 f"filter_image_numpy")
    with contextlib.redirect_stdout(io.StringIO()) as log:
        empty = net.get_filtered_image()
    if not (empty.empty and "ring empty" in log.getvalue()):
        raise AssertionError("a drained ring did not return the empty "
                             "sentinel")
    print(f"ring {h}x{w} depth {depth}: {n} frames in {bursts} bursts, FIFO "
          f"and metadata kept, each bit for bit filter_image_numpy, a submit "
          f"to the full ring dropped, drained ring empty, "
          f"{launches['filter_image_device']} K25 launches")
    one = NetCUDA(_dense_net(), ring_depth=1, image_filter="sharpen")
    # one warm-up run each: `got` still holds the pinned buffers of the
    # frames above, so the full ring's first run would allocate new ones
    _ring_fps(net, frames, depth)
    _ring_fps(one, frames, 1)
    fps = {"ring": [], "one": []}
    for name in ("ring", "one", "one", "ring"):
        fps[name].append(_ring_fps(net if name == "ring" else one, frames, n))
    print(f"ring throughput, {n} frames a run, in turns: "
          f"{' / '.join(f'{v:.1f}' for v in fps['ring'])} frames/s through "
          f"the full ring (depth {depth}) against "
          f"{' / '.join(f'{v:.1f}' for v in fps['one'])} one at a time "
          f"(depth 1)")
    return {"filter_image_device": launches["filter_image_device"]}


def run_dense_phases(errors, timing, launches):
    """The dense backend's phases after the earlier slices' ones (K25 and
    K13 parity ran right after the build)."""
    for name, t in phase_dense_timing().items():
        timing[name] = dict(t, max_abs_err=errors[name])
    launches.update(phase_dense_backend())
    launches.update(phase_dense_ring())


# ---------------------------------------------------------------------------
# Phase 13: the large ViTs (CLIP ViT-L/14, ViT-L/16 at 224 and 384, DeiT)
# ---------------------------------------------------------------------------

MLP_ACTS_K3 = ("gelu_tanh", "quick_gelu", "relu")
# CLIP ViT-L/14 @224, the slice's configuration: 257 tokens on 264 rows,
# D 1024, 16 heads, M 4096.
CLIP_L = dict(n_pad=264, n_valid=257, d=1024, heads=16, m=4096)
# Served embeddings, kernels vs the plain versions on the card, in relative
# norm over all rows: 24 layers of the bf16 ulp flips of STACK_BF16_NORM.
EMBED_NORM = 2e-2


def _k3_call(fn, x, st, p, act, n_chunks, emit):
    return fn(x, st, p["ln_scale"], p["ln_bias"], p["w1"], p["b1"], p["w2"],
              p["b2"], eps=EPS, act=act, n_chunks=n_chunks, emit_stats=emit)


def _k3_parity(rows, d, m, seed, chunks=(2, 4)):
    """K3 against its plain version at (rows, d) x m, each chunk count of
    ``chunks`` and activation, both values of emit_stats; and its distance
    from K2's plain version, which must not be 0 (K3 rounds the running
    output at every chunk boundary and adds b2 once).  Returns the largest
    max-abs error."""
    from vit_fpga_tpu_torch.ops import fused_mlp as fm
    x, st, p = _mlp_inputs(rows, d, m, seed)
    pb = _bf16_weights(p, ("w1", "w2"))
    worst = 0.0
    for n_chunks in chunks:
        for act in MLP_ACTS_K3:
            label = f"K3 ({rows}, {d}) x {m} n_chunks={n_chunks} {act}"
            worst = max(worst, _parity(
                label, lambda fn, emit, a=act, n=n_chunks: _k3_call(
                    fn, x, st, pb, a, n, emit),
                fm.fused_mlp_chunked_stats,
                fm.fused_mlp_chunked_stats_plain, x))
            got, _ = _k3_call(fm.fused_mlp_chunked_stats, x, st, pb, act,
                              n_chunks, False)
            k2, _ = fm.fused_mlp_stats_plain(
                x, st, pb["ln_scale"], pb["ln_bias"], pb["w1"], pb["b1"],
                pb["w2"], pb["b2"], eps=EPS, act=act, emit_stats=False)
            diff = (got.float() - k2.float()).abs()
            share = float((diff > 0).float().mean())
            print(f"  {label}: |K3 - K2 plain| max {float(diff.max()):.3e}, "
                  f"{share:.3%} of elements differ (must be > 0)")
            if not share > 0:
                raise AssertionError(f"{label}: K3 computed K2's function")
    return worst


def _k1_long_parity(batch, n_pad, n_valid, d, heads, seed, extra=()):
    """K1 against its plain version at a length past 256 keys, both values
    of emit_stats, elementwise and as a branch; ``extra`` adds the loud
    padding case (valid rows bit for bit as with quiet padding) and the
    peaked-scores case.  Returns the largest max-abs error."""
    from vit_fpga_tpu_torch.ops import attn_block as ab
    x, st, p = _attn_inputs(batch, n_pad, d, seed)
    pb = _bf16_weights(p, ("wqkv", "wo"))
    label = f"K1 ({batch}, {n_pad}, {d}) n_valid={n_valid}"
    print(f"parity {label}, {heads} heads")
    worst = _parity(label, lambda fn, emit: _attn_call(
        fn, x, st, pb, heads, n_valid, emit), ab.attn_block_stats,
        ab.attn_block_stats_plain, x)
    if "peaked" in extra:
        # q and k 2x larger: scores 4x wider, so most rows lean on a few
        # keys, and a key the kernel drops (a tile skipped) moves the rows
        # it leads by most of their branch.  Held as a branch in relative
        # norm only: so peaked a softmax turns a score's f32 rounding into
        # a few bf16 ulps of the branch on rare elements (one of 1.08M
        # read 3.125e-2 at |out| + |x| < 1), above the elementwise band.
        peaked = dict(pb, wqkv=pb["wqkv"].clone())
        peaked["wqkv"][:, :2 * d] *= 2
        got, _ = _attn_call(ab.attn_block_stats, x, st, peaked, heads,
                            n_valid, False)
        want, _ = _attn_call(ab.attn_block_stats_plain, x, st, peaked, heads,
                             n_valid, False)
        torch.cuda.synchronize()
        print(f"  {label} peaked scores out: max_abs="
              f"{float((got.float() - want.float()).abs().max()):.3e} "
              f"(stated)")
        _branch(f"{label} peaked scores branch", got, want, x)
    if "loud" in extra and n_valid < n_pad:
        loud = st.clone()
        loud[:, n_valid:, 0] = 0.0
        loud[:, n_valid:, 1] = 30.0
        quiet, _ = _attn_call(ab.attn_block_stats, x, st, pb, heads, n_valid,
                              True)
        noisy, _ = _attn_call(ab.attn_block_stats, x, loud, pb, heads,
                              n_valid, True)
        torch.cuda.synchronize()
        moved = float((noisy[:, :n_valid].float()
                       - quiet[:, :n_valid].float()).abs().max())
        print(f"  {label} loud padding rows {n_valid}..{n_pad - 1}: valid "
              f"rows moved by max_abs={moved:.3e} (must be 0)")
        if moved != 0.0 or not torch.isfinite(noisy[:, :n_valid]).all():
            raise AssertionError(f"{label}: padding rows moved the valid rows")
    return worst


def _expect_raise(label, fn, exc=ValueError, match=None):
    """``fn()`` must raise ``exc`` (whose text holds ``match`` if given)."""
    try:
        fn()
    except exc as e:
        print(f"  {label} raises: {e}")
        if match is not None and match not in str(e):
            raise AssertionError(f"{label} raised, but not with "
                                 f"{match!r}") from e
        return
    raise AssertionError(f"{label} ran outside the kernel's gate")


def _device_alone_ms(fn, iters=50):
    """Device milliseconds per call of ``fn`` from torch.profiler's CUDA
    activity over ``iters`` back-to-back calls: each kernel's mean time
    times its launches a call, summed, so the wrapper's host time is out.
    A kernel launched less than once a call on average (a record the
    profiler dropped aside) does not count.  A profiler that sees no such
    kernel in any of ``PROFILER_TRIES`` tries (its activity buffer drops
    records on some hosts) gives way to ``_events_alone_ms``."""
    for _ in range(PROFILER_TRIES):
        averages = _profiled(fn, iters)
        total = 0.0
        for e in averages:
            if e.device_time_total <= 0 or e.count < iters // 2:
                continue
            total += e.device_time_total / e.count * round(e.count / iters)
        if total > 0:
            return total / 1e3
        seen = [(e.key[:60], e.count) for e in averages
                if e.device_time_total > 0]
        print(f"  the profiler saw no kernel launched at least once in two "
              f"of {iters} calls; device records (name, count): {seen}")
    return _events_alone_ms(fn, iters, "no device time")


def phase_large_kernels():
    """K3 (fused_mlp_chunked_stats) and K1 past 256 keys against their
    plain versions on the card, right after the build: K3 at (200, 128) x
    512 and (9344, 1024) x 4096 with 2 and 4 chunks, and where a chunk ends
    inside the GEMM's 64-deep K step: (200, 128) x 192 with 2 chunks (96
    columns a chunk), (200, 128) x 128 with 4 (32: two boundaries in one
    step) and CLIP-L/14 b1's (264, 1024) x 1152 with 4 (288); K1 at
    CLIP-L/14's (4, 264, 1024) with 257
    valid tokens, ViT-L/16 @384's (2, 584, 1024) with 577, (1, 1024,
    768) with 1024 and (1, 1032, 128) with 1032 (the JAX plan's two score
    slots; a gate check before K1 took the JAX gate), a loud-padding case
    past 256 keys and a peaked-scores case; then the gate: K3 with 3
    chunks raises.  Returns {kernel name: max-abs error}."""
    from vit_fpga_tpu_torch.ops import fused_mlp as fm
    print("parity K3 fused_mlp_chunked_stats")
    k3 = max(_k3_parity(200, 128, 512, seed=130),
             _k3_parity(9344, 1024, 4096, seed=131),
             _k3_parity(200, 128, 192, seed=137, chunks=(2,)),
             _k3_parity(200, 128, 128, seed=138, chunks=(4,)),
             _k3_parity(264, 1024, 1152, seed=139, chunks=(4,)))
    k1 = max(_k1_long_parity(4, 264, 257, 1024, 16, seed=132,
                             extra=("loud", "peaked")),
             _k1_long_parity(2, 584, 577, 1024, 16, seed=133,
                             extra=("loud",)),
             _k1_long_parity(1, 1024, 1024, 768, 12, seed=134),
             _k1_long_parity(1, 1032, 1032, 128, 2, seed=136))
    x, st, p = _mlp_inputs(64, 128, 384, seed=135)
    _expect_raise("K3 n_chunks=3", lambda: _k3_call(
        fm.fused_mlp_chunked_stats, x, st, p, "gelu_tanh", 3, True))
    return {"fused_mlp_chunked_stats": k3, "attn_block_stats_long": k1}


def _time_k3(rows, d, m, seed, label):
    """K3 (2 chunks) at (rows, d) x m: kernel, plain version, the library
    yardstick (LN + 2 chunks of addmm + quick-GELU + addmm, bf16) and the
    bound."""
    import torch.nn.functional as F
    from vit_fpga_tpu_torch.ops import fused_mlp as fm
    from vit_fpga_tpu_torch.utils.timing import time_cuda
    x, st, p = _mlp_inputs(rows, d, m, seed)
    pb = _bf16_weights(p, ("w1", "w2"))
    act = "quick_gelu"
    ms = time_cuda(lambda: _k3_call(fm.fused_mlp_chunked_stats, x, st, pb,
                                    act, 2, True))
    plain_ms = time_cuda(lambda: _k3_call(fm.fused_mlp_chunked_stats_plain,
                                          x, st, pb, act, 2, True),
                         iters=3, warmup=1)
    ls, lb = p["ln_scale"].to(torch.bfloat16), p["ln_bias"].to(torch.bfloat16)
    b1, b2 = p["b1"].to(torch.bfloat16), p["b2"].to(torch.bfloat16)
    mc = m // 2

    def library():
        xn = F.layer_norm(x, (d,), ls, lb, EPS)
        acc = x
        for c in range(2):
            h = torch.addmm(b1[c * mc:(c + 1) * mc], xn,
                            pb["w1"][:, c * mc:(c + 1) * mc])
            h = h * torch.sigmoid(1.702 * h)
            y = h @ pb["w2"][c * mc:(c + 1) * mc]
            acc = acc + (y + b2 if c == 1 else y)
        return acc

    lib_ms = time_cuda(library)
    dev_ms = _device_alone_ms(lambda: _k3_call(
        fm.fused_mlp_chunked_stats, x, st, pb, act, 2, True), iters=20)
    lib_dev_ms = _device_alone_ms(library, iters=20)
    flops = 4 * rows * d * m
    nbytes = (2 * rows * d * 2 + 2 * rows * 2 * 4 + 2 * d * m * 2
              + (m + 3 * d) * 4)
    bound_ms, bound_by = _bound(flops, nbytes)
    t = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
             bound_by=bound_by)
    print(f"timing K3 {label} ({rows}, {d}) x {m}, 2 chunks: kernel "
          f"{ms:.4f} ms per call ({flops / ms / 1e9:.1f} TFLOP/s), "
          f"{dev_ms:.4f} ms device alone; plain {plain_ms:.4f} ms, library "
          f"{lib_ms:.4f} ms per call, {lib_dev_ms:.4f} ms device alone; "
          f"bound {bound_ms:.4f} ms ({bound_by})")
    return t


def _attn_library(x, p, heads, n_valid):
    """The attention half's library yardstick on x (B, n_pad, D) and
    weights ``p`` in x's dtype (bf16, or f32 with TF32 off by the caller):
    LN + addmm + scaled_dot_product_attention with the key mask + addmm +
    residual."""
    import torch.nn.functional as F
    batch, n_pad, d = x.shape
    rows, dh, bf = batch * n_pad, d // heads, x.dtype
    ls, lb = p["ln_scale"].to(bf), p["ln_bias"].to(bf)
    bq, bo = p["bqkv"].to(bf), p["bo"].to(bf)
    keep = (torch.arange(n_pad, device="cuda") < n_valid)[None, None, None]
    x2 = x.reshape(rows, d)

    def library():
        xn = F.layer_norm(x2, (d,), ls, lb, EPS)
        qkv = torch.addmm(bq, xn, p["wqkv"]).view(batch, n_pad, 3, heads, dh)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        ao = F.scaled_dot_product_attention(q, k, v, attn_mask=keep)
        ao = ao.transpose(1, 2).reshape(rows, d)
        return torch.addmm(bo, ao, p["wo"]) + x2

    return library


def _alone_pair(label, kern, lib):
    """Device ms per call of the kernel call ``kern`` and its library
    yardstick ``lib`` (``_device_alone_ms``), printed; returns both."""
    dev_ms = _device_alone_ms(kern, iters=20)
    lib_dev_ms = _device_alone_ms(lib, iters=20)
    print(f"  {label}: kernel {dev_ms:.4f} ms device alone, library "
          f"{lib_dev_ms:.4f} ms device alone")
    return dict(device_ms=dev_ms, library_device_ms=lib_dev_ms)


def _time_k1(batch, n_pad, n_valid, d, heads, seed, label, alone=False):
    """K1 at (batch, n_pad, d): kernel, plain version, the library
    yardstick (LN + addmm + scaled_dot_product_attention + addmm, bf16)
    and the bound; with ``alone`` also each call's device time alone."""
    from vit_fpga_tpu_torch.ops import attn_block as ab
    from vit_fpga_tpu_torch.utils.timing import time_cuda
    x, st, p = _attn_inputs(batch, n_pad, d, seed)
    pb = _bf16_weights(p, ("wqkv", "wo"))
    rows, dh = batch * n_pad, d // heads
    ms = time_cuda(lambda: _attn_call(ab.attn_block_stats, x, st, pb, heads,
                                      n_valid, True))
    plain_ms = time_cuda(lambda: _attn_call(ab.attn_block_stats_plain, x, st,
                                            pb, heads, n_valid, True),
                         iters=3, warmup=1)
    lib_ms = time_cuda(_attn_library(x, pb, heads, n_valid))
    flops = (2 * rows * d * 4 * d
             + 4 * batch * heads * n_pad * n_valid * dh)
    nbytes = (2 * rows * d * 2 + 2 * rows * 2 * 4
              + 4 * d * d * 2 + 6 * d * 4)
    bound_ms, bound_by = _bound(flops, nbytes)
    t = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
             bound_by=bound_by)
    print(f"timing K1 {label} ({batch}, {n_pad}, {d}) n_valid={n_valid}: "
          f"kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), plain "
          f"{plain_ms:.4f} ms, library {lib_ms:.4f} ms, bound {bound_ms:.4f} "
          f"ms ({bound_by})")
    if alone:
        t.update(_alone_pair(f"K1 {label}", lambda: _attn_call(
            ab.attn_block_stats, x, st, pb, heads, n_valid, True),
            _attn_library(x, pb, heads, n_valid)))
    return t


def phase_large_timing():
    """K3 at CLIP-L/14 b64 (16 896 rows) and ViT-L/16 b64 (12 800); K1 at
    CLIP-L/14 b64 (64, 264, 1024) and ViT-L/16 @384 b16 (16, 584, 1024).
    The JSON line carries the CLIP-L/14 ones."""
    c = CLIP_L
    k3 = _time_k3(64 * c["n_pad"], c["d"], c["m"], 140, "CLIP-L/14 b64")
    _time_k3(64 * 200, 1024, 4096, 141, "ViT-L/16 b64")
    k1 = _time_k1(64, c["n_pad"], c["n_valid"], c["d"], c["heads"], 142,
                  "CLIP-L/14 b64")
    _time_k1(16, 584, 577, 1024, 16, 143, "ViT-L/16 @384 b16")
    return {"fused_mlp_chunked_stats": k3, "attn_block_stats_long": k1}


def _plain_chain():
    """The chain's kernels swapped for their plain versions (the card's
    plain-version forward)."""
    from unittest import mock

    from vit_fpga_tpu_torch.models import vit
    from vit_fpga_tpu_torch.ops import attn_block as ab
    from vit_fpga_tpu_torch.ops import fused_mlp as fm
    return mock.patch.multiple(
        vit, attn_block_stats=ab.attn_block_stats_plain,
        fused_mlp_stats=fm.fused_mlp_stats_plain,
        fused_mlp_chunked_stats=fm.fused_mlp_chunked_stats_plain)


def _check_only(label, counters, want, long=0):
    """Every counter at its wanted count, 0 unless named (as
    _check_launches), and ``long`` of the K1 launches on the key-tiled
    path."""
    got_long = counters["attn_block_stats"].launches_long
    print(f"  {label} launches: "
          f"{ {k: fn.launches for k, fn in counters.items() if fn.launches} }"
          f", {got_long} of K1's on the key-tiled path")
    _check_launches(label, counters, want)
    if got_long != long:
        raise AssertionError(f"{label}: {got_long} K1 launches took the "
                             f"key-tiled path, want {long}")


def phase_large_slice(n_images=160, batch=64):
    """ImageServer over clip.make_forward(CLIP ViT-L/14 @224, bf16,
    projection 768, depth 24) answers 160 uint8 requests (2 batches of 64
    and a flush of 32): every embedding against the card's plain-version
    forward, 2 against the CPU forward; each batch launches 24 K1 (all on
    the key-tiled path) and 24 K3 and nothing else.  Returns the launch
    counts, the forward and the images."""
    from vit_fpga_tpu_torch.models import clip
    from vit_fpga_tpu_torch.runtime.serving import ImageServer
    from vit_fpga_tpu_torch.utils.log import Metrics
    cfg = clip.clip_vision_config("vit_l14", dtype="bfloat16")
    params = clip.init_params(cfg, 768, _gen(150), device="cuda")
    fwd = clip.make_forward(cfg, params)
    images = np.random.default_rng(150).integers(
        0, 256, (n_images, cfg.image_size, cfg.image_size, 3), np.uint8)
    fwd(images[:batch])
    torch.cuda.synchronize()
    Metrics.reset()
    counters = _zero_counters()
    t0 = time.perf_counter()
    with ImageServer(fwd, image_size=cfg.image_size,
                     batch_size=batch) as server:
        futs = [server.submit_raw(img) for img in images]
        results = [f.result(timeout=600) for f in futs]
        wall = time.perf_counter() - t0
        pct = server.latency_percentiles()
    print(f"CLIP-L/14 slice: {len(results)}/{n_images} answered in "
          f"{server.batches} batches, {wall:.3f} s, {n_images / wall:.1f} "
          f"img/s, p50 {pct['p50']:.2f} ms, p99 {pct['p99']:.2f} ms")
    launches = {k: fn.launches for k, fn in counters.items()}
    launches["attn_block_stats_long"] = counters[
        "attn_block_stats"].launches_long
    per = cfg.depth * server.batches
    _check_only("CLIP-L/14 slice", counters,
                {"attn_block_stats": per, "fused_mlp_chunked_stats": per},
                long=per)
    if len(results) != n_images or server.served != n_images:
        raise AssertionError("not every CLIP request was answered")
    got = np.stack(results)
    if got.shape != (n_images, 768) or not np.isfinite(got).all():
        raise AssertionError(f"bad embeddings: shape {got.shape}")
    with _plain_chain():
        plain = torch.cat([fwd(images[i:i + batch]).cpu()
                           for i in range(0, n_images, batch)])
    _relnorm("CLIP-L/14 served embeddings vs the card's plain forward",
             torch.from_numpy(got), plain, EMBED_NORM)
    idx = [0, n_images - 1]
    cpu = clip.make_forward(cfg, _tree_to(params, "cpu"), device="cpu")
    _relnorm(f"CLIP-L/14 embeddings of images {idx} vs the CPU forward",
             torch.from_numpy(got[idx]), cpu(images[idx]), EMBED_NORM)
    return launches, fwd, images


def phase_large_forwards(clip_fwd, images):
    """CLIP-L/14 at b128 (33 792 rows: the JAX plan's K2, no K3) and
    ViT-L/16 @384 b16 (24 K1 over 584 keys, 24 K3) against the card's
    plain-version forwards; DeiT-B/16 b64 against the CPU for 2 images;
    CLIP-B/16's forward_latency at b1 (one K11) against the CPU.  Returns
    the ViT-L/16 forwards (224 and 384) and their images for the timing."""
    from vit_fpga_tpu_torch.models import clip, deit, vit
    counters = _zero_counters()
    b128 = images[:128]
    got = clip_fwd(b128)
    _check_only("CLIP-L/14 b128", counters,
                {"attn_block_stats": 24, "fused_mlp_stats": 24}, long=24)
    with _plain_chain():
        want = clip_fwd(b128)
    _relnorm("CLIP-L/14 b128 vs the card's plain forward", got, want,
             EMBED_NORM)

    cfg384 = vit.config("vit_l16", image_size=384, dtype="bfloat16")
    p384 = vit.init_params(cfg384, _gen(151), device="cuda")
    fwd384 = vit.make_forward(cfg384, p384)
    img384 = np.random.default_rng(151).integers(0, 256, (16, 384, 384, 3),
                                                 np.uint8)
    counters = _zero_counters()
    got = fwd384(img384)
    _check_only("ViT-L/16 @384 b16", counters,
                {"attn_block_stats": 24, "fused_mlp_chunked_stats": 24},
                long=24)
    with _plain_chain():
        want = fwd384(img384)
    _relnorm("ViT-L/16 @384 b16 logits vs the card's plain forward", got,
             want, EMBED_NORM)

    dcfg = deit.config("deit_b16", dtype="bfloat16")
    dparams = deit.init_params(dcfg, _gen(152), device="cuda")
    dimg = np.random.default_rng(152).integers(0, 256, (64, 224, 224, 3),
                                               np.uint8)
    counters = _zero_counters()
    got = deit.make_forward(dcfg, dparams)(dimg).cpu().numpy()
    _check_only("DeiT-B/16 b64", counters,
                {"attn_block_stats": 12, "fused_mlp_stats": 12})
    want = deit.make_forward(dcfg, _tree_to(dparams, "cpu"),
                             device="cpu")(dimg[[0, 63]]).numpy()
    _rel_to_max("DeiT-B/16 logits of images [0, 63] vs the CPU forward",
                got[[0, 63]], want, LOGITS_BAND)

    bcfg = clip.clip_vision_config("vit_b16", dtype="bfloat16")
    bparams = clip.init_params(bcfg, 512, _gen(153), device="cpu")
    bimg = vit.preprocess(torch.from_numpy(np.random.default_rng(153).integers(
        0, 256, (1, 224, 224, 3), np.uint8)), bcfg)
    prepped = vit._prepare_params(_tree_to(bparams, "cuda"), bcfg)
    counters = _zero_counters()
    with torch.inference_mode():
        got = clip.forward_latency(prepped, bimg.cuda(), bcfg).cpu()
        want = clip.forward_latency(bparams, bimg, bcfg)
    _check_only("CLIP-B/16 forward_latency b1", counters, {"vit_layers": 1})
    _relnorm("CLIP-B/16 forward_latency b1 vs the CPU", got, want,
             EMBED_NORM)

    cfg224 = vit.config("vit_l16", dtype="bfloat16")
    fwd224 = vit.make_forward(cfg224, vit.init_params(cfg224, _gen(154),
                                                      device="cuda"))
    return fwd224, fwd384, img384


def phase_large_time(clip_fwd, clip_images, fwd224, fwd384, img384):
    """ms per batch and img/s of CLIP-L/14 b64, ViT-L/16 b64 and ViT-L/16
    @384 b16, in turns (each twice, the order reversed the second time)."""
    from vit_fpga_tpu_torch.utils.timing import time_cuda
    runs = {
        "CLIP-L/14 @224 b64": (clip_fwd, torch.from_numpy(
            clip_images[:64]).cuda()),
        "ViT-L/16 @224 b64": (fwd224, torch.from_numpy(
            clip_images[64:128]).cuda()),
        "ViT-L/16 @384 b16": (fwd384, torch.from_numpy(img384).cuda()),
    }
    times = {name: [] for name in runs}
    for name in list(runs) + list(runs)[::-1]:
        fwd, img = runs[name]
        times[name].append(time_cuda(lambda: fwd(img), iters=5, warmup=2))
    for name, ms in times.items():
        b = runs[name][1].shape[0]
        print(f"forward {name}: " + " / ".join(f"{t:.3f}" for t in ms)
              + " ms per batch, " + " / ".join(f"{b / t * 1e3:.1f}"
                                               for t in ms) + " img/s")
    return times


def run_large_phases(errors, timing, launches):
    """The large ViTs' phases after the earlier slices' ones (K3 and K1
    long parity ran right after the build)."""
    for name, t in phase_large_timing().items():
        timing[name] = dict(t, max_abs_err=errors[name])
    slice_launches, clip_fwd, images = phase_large_slice()
    launches["fused_mlp_chunked_stats"] = slice_launches[
        "fused_mlp_chunked_stats"]
    launches["attn_block_stats_long"] = slice_launches["attn_block_stats_long"]
    fwds = phase_large_forwards(clip_fwd, images)
    phase_large_time(clip_fwd, images, *fwds)
    print(_smi_line())


# ---------------------------------------------------------------------------
# 14. The whole model in one launch: K12 (vit_full) and K20 (vit_full_int8)
# ---------------------------------------------------------------------------

FULL_KERNELS = ("vit_full", "vit_full_int8")
# K12 logits against its plain version, max |a-b| over the largest logit:
# the stacks' bf16 ulp flips carried through the final LayerNorm and the
# head's sums of 768 terms (read on the H100 at depth 12: 1.2-1.4e-2, the
# same as the plain head on K11's tokens against the plain version's).
FULL_LOGITS_TOL = 2e-2
# K20's: the head quantizes the CLS row with a scale taken from its
# largest element, so one flipped bf16 ulp of the tokens can move that
# scale and with it every logit.  Two right implementations (the plain
# head on K19a's tokens, the plain version) were read 1.5-3.3e-2 apart on
# the H100; the band is twice the largest such gap read.  The floor is
# printed beside each reading.
FULL_INT8_LOGITS_TOL = 8e-2


def _full_args(depth, patch=16, image=224, classes=1000, seed=120, d=768,
               m=3072, n_pad=None):
    """(K12 arguments, K20 arguments) after the images at ViT-B width:
    the blocks of _stack_trees and a seeded patch weight, posb table
    (zero tail rows), final LayerNorm and head, laid out as the port's
    folds lay them out (the head padded to a multiple of 128 columns: zero
    weights and biases, int8 scales 1.0; the int8 patch weight k-major)."""
    from vit_fpga_tpu_torch.ops.quant_fused import (kmajor,
                                                    quantize_weight_colwise)
    bf, q8, _ = _stack_trees(depth, seed=seed, static=False, d=d, m=m)
    g = _gen(seed + 1)
    p3 = 3 * patch * patch
    n = 1 + (image // patch) ** 2
    n_pad = -(-n // 8) * 8 if n_pad is None else n_pad
    cls_pad = -(-classes // 128) * 128
    wp = _randn(g, p3, d, std=0.03)
    posb = _randn(g, n_pad, d, std=0.02)
    posb[n:] = 0.0
    lfs, lfb = _randn(g, d, std=0.1, mean=1.0), _randn(g, d, std=0.1)
    wh = torch.zeros((d, cls_pad), device="cuda")
    wh[:, :classes] = _randn(g, d, classes, std=0.03)
    bh = torch.zeros((cls_pad,), device="cuda")
    bh[:classes] = _randn(g, classes, std=0.02)
    wpq, wps = quantize_weight_colwise(wp.cpu().numpy())
    whq, whs = quantize_weight_colwise(wh[:, :classes].cpu().numpy())
    whq_p = torch.zeros((d, cls_pad), dtype=torch.int8, device="cuda")
    whq_p[:, :classes] = torch.from_numpy(whq).cuda()
    whs_p = torch.ones((cls_pad,), device="cuda")
    whs_p[:classes] = torch.from_numpy(whs).cuda()
    bf16 = torch.bfloat16
    return ((wp.to(bf16), posb, bf, lfs, lfb, wh.to(bf16), bh),
            (kmajor(torch.from_numpy(wpq).cuda()),
             torch.from_numpy(wps).cuda(), posb, q8, lfs, lfb, whq_p, whs_p,
             bh))


def _full_depth(args, depth, blocks_at):
    """The arguments with the first ``depth`` layers of the blocks."""
    out = list(args)
    out[blocks_at] = {k: v[:depth] for k, v in args[blocks_at].items()}
    return tuple(out)


def _full_images(batch, image=224, seed=121):
    """Seeded normalized images, f32 on the card (K12 / K20 round them to
    bf16 as they gather the patches)."""
    return _randn(_gen(seed + batch), batch, image, image, 3)


def _full_int8_floor(images, args, heads, patch=16):
    """The plain head on K19a's tokens and on the plain layers' tokens, from
    the same plain embed: max |a-b| over the largest logit, the gap of two
    right implementations that K20's band is set against."""
    from vit_fpga_tpu_torch.ops import vit_stack as vs
    from vit_fpga_tpu_torch.ops.quant_block import _ln_f32
    from vit_fpga_tpu_torch.ops.quant_fused import _int_matmul, _row_quant
    wpq, wps, posb, q8, lfs, lfb, whq, whs, bh = args
    n = 1 + (images.shape[1] // patch) ** 2
    pq, sp = _row_quant(vs.patch_rows(images, patch, posb.shape[0],
                                      torch.bfloat16).float())
    tok = (_int_matmul(pq, wpq) * (sp * wps) + posb).to(torch.bfloat16)

    def head(t):
        rq, rs = _row_quant(_ln_f32(t[:, 0], lfs, lfb, EPS))
        return _int_matmul(rq, whq) * (rs * whs) + bh
    a = head(vs.vit_layers_int8(tok, q8, heads, eps=EPS, n_valid=n))
    b = head(vs.vit_layers_int8_plain(tok, q8, heads, eps=EPS, n_valid=n))
    return float((a - b).abs().max() / b.abs().max())


def _full_logits(label, got, want, tol=FULL_LOGITS_TOL, floor=None):
    """max |a-b| over the largest logit within ``tol``; returns max |a-b|."""
    torch.cuda.synchronize()
    g, w = got.float(), want.float()
    rel = float((g - w).abs().max() / w.abs().max())
    note = "" if floor is None else f"; floor {floor:.3e}"
    print(f"  {label}: max |a-b| / max |b| = {rel:.3e} (tol {tol:g}{note})")
    if not rel <= tol or not torch.isfinite(g).all():
        raise AssertionError(f"{label}: kernel disagrees with its plain "
                             f"version")
    return float((g - w).abs().max())


def phase_full_kernels(batches=(1, 4), heads=12):
    """K12 and K20 against their plain versions on the card at ViT-B/16
    width (224 px, patch 16, 197 tokens, 1000 classes), b1 and b4: K12 at
    one layer elementwise in the bf16 band, K20 at one layer within
    FULL_INT8_LOGITS_TOL of the largest logit (its floor printed); both at
    all 12 layers in relative norm (2e-2 bf16, 5e-2 int8) and within their
    logits bands; ViT-B/32's 3072-value patches (50 tokens) at depth 2, so
    that the embed's K loop runs 48 steps; then the gates: batch 5, a
    588-value patch and an f32 model raise.  Runs right after the build.
    Returns {kernel name: max-abs error}."""
    from vit_fpga_tpu_torch.ops import vit_stack as vs
    worst = {name: 0.0 for name in FULL_KERNELS}
    bf12, i812 = _full_args(12)
    for batch in batches:
        img = _full_images(batch)
        print(f"parity K12 vit_full / K20 vit_full_int8 ({batch}, 224, 224, "
              f"3) images, patch 16, 12 heads, 1000 classes")
        a, q = _full_depth(bf12, 1, 2), _full_depth(i812, 1, 3)
        got = vs.vit_full(img, *a, heads, 16, eps=EPS)
        want = vs.vit_full_plain(img, *a, heads, 16, eps=EPS)
        torch.cuda.synchronize()
        worst["vit_full"] = max(worst["vit_full"], _compare(
            f"K12 b{batch} depth 1 logits", got, want, BF16_TOL, BF16_TOL))
        got = vs.vit_full_int8(img, *q, heads, 16, eps=EPS)
        want = vs.vit_full_int8_plain(img, *q, heads, 16, eps=EPS)
        _relnorm(f"K20 b{batch} depth 1 logits", got, want, STACK_INT8_NORM)
        worst["vit_full_int8"] = max(worst["vit_full_int8"], _full_logits(
            f"K20 b{batch} depth 1 logits", got, want, FULL_INT8_LOGITS_TOL,
            _full_int8_floor(img, q, heads)))
        for name, kern, plain, args, tol, band in (
                ("vit_full", vs.vit_full, vs.vit_full_plain, bf12,
                 STACK_BF16_NORM, FULL_LOGITS_TOL),
                ("vit_full_int8", vs.vit_full_int8, vs.vit_full_int8_plain,
                 i812, STACK_INT8_NORM, FULL_INT8_LOGITS_TOL)):
            got = kern(img, *args, heads, 16, eps=EPS)
            want = plain(img, *args, heads, 16, eps=EPS)
            torch.cuda.synchronize()
            _relnorm(f"{name} b{batch} depth 12 logits", got, want, tol)
            floor = (_full_int8_floor(img, args, heads)
                     if name == "vit_full_int8" else None)
            worst[name] = max(worst[name], _full_logits(
                f"{name} b{batch} depth 12 logits", got, want, band, floor))
    # ViT-B/32: p3 = 3072, 50 tokens (56 rows), depth 2; bf16 images
    bf2, i82 = _full_args(2, patch=32, seed=130)
    for batch in batches:
        img = _full_images(batch, seed=131).to(torch.bfloat16)
        for name, kern, plain, args, band in (
                ("vit_full", vs.vit_full, vs.vit_full_plain, bf2,
                 FULL_LOGITS_TOL),
                ("vit_full_int8", vs.vit_full_int8, vs.vit_full_int8_plain,
                 i82, FULL_INT8_LOGITS_TOL)):
            got = kern(img, *args, heads, 32, eps=EPS)
            want = plain(img, *args, heads, 32, eps=EPS)
            worst[name] = max(worst[name], _full_logits(
                f"{name} b{batch} ViT-B/32 patches (p3 3072, 50 tokens) "
                f"depth 2 logits", got, want, band))
    img = _full_images(1)
    a1, q1 = _full_depth(bf12, 1, 2), _full_depth(i812, 1, 3)
    _expect_raise("K12 at batch 5", lambda: vs.vit_full(
        _full_images(5), *a1, heads, 16, eps=EPS))
    _expect_raise("K20 at batch 5", lambda: vs.vit_full_int8(
        _full_images(5), *q1, heads, 16, eps=EPS))
    _expect_raise("K12 with 14-pixel patches (p3 588)", lambda: vs.vit_full(
        _full_images(1, image=28), torch.zeros((588, 768), device="cuda",
                                               dtype=torch.bfloat16),
        *a1[1:], heads, 14, eps=EPS))
    _expect_raise("K12 with an f32 model", lambda: vs.vit_full(
        img, a1[0].float(), *a1[1:], heads, 16, eps=EPS))
    worst["vit_full_int8"] = max(worst["vit_full_int8"], _k20_edges(i812))
    worst["vit_full"] = max(worst["vit_full"], _k12_edges(bf12))
    return worst


# K12's edge images (grid rows, grid columns) of 16-pixel patches: 2 / 127 /
# 128 / 129 / 197 / 256 tokens (one patch, 9 x 14, 1 x 127, 8 x 16, 14 x
# 14, 15 x 17; a whole-model input has at least the CLS row and a patch).
K12_EDGE_GRIDS = ((1, 1), (9, 14), (1, 127), (8, 16), (14, 14), (15, 17))


def _k12_edges(bf12, heads=12):
    """K12 (the bf16 variant of the wgmma layer loop: 64-column bf16 items
    with the weights through the transpose bit, f32 split-K partials) at
    the edges of its design: b2 and b3 at depth 1 (the bf16 band) and 12
    (norm and the logits band), 2 / 127 / 128 / 129 / 197 / 256 tokens on
    a 256-row position table (rectangular images), quick_gelu and
    ViT-L/16's width at depth 2; then 20 back-to-back b1 depth-12 launches
    bit for bit.  Returns the max-abs error."""
    from vit_fpga_tpu_torch.ops import vit_stack as vs
    worst = 0.0

    def case(label, img, args, heads, act="gelu_tanh"):
        got = vs.vit_full(img, *args, heads, 16, eps=EPS, act=act)
        want = vs.vit_full_plain(img, *args, heads, 16, eps=EPS, act=act)
        torch.cuda.synchronize()
        _relnorm(f"K12 {label} logits", got, want, STACK_BF16_NORM)
        return _full_logits(f"K12 {label} logits", got, want)

    print("K12 edges: batches, token counts on a 256-row position table, "
          "quick_gelu, ViT-L/16 width")
    a1 = _full_depth(bf12, 1, 2)
    for batch in (2, 3):
        img = _full_images(batch, seed=300)
        got = vs.vit_full(img, *a1, heads, 16, eps=EPS)
        want = vs.vit_full_plain(img, *a1, heads, 16, eps=EPS)
        torch.cuda.synchronize()
        worst = max(worst, _compare(f"K12 b{batch} depth 1 logits", got,
                                    want, BF16_TOL, BF16_TOL))
        worst = max(worst, case(f"b{batch} depth 12", img, bf12, heads))
    g = _gen(310)
    d = bf12[0].shape[1]
    for gh, gw in K12_EDGE_GRIDS:
        n = 1 + gh * gw
        posb = _randn(g, 256, d, std=0.02)
        posb[n:] = 0.0
        img = _randn(_gen(311 + n), 1, 16 * gh, 16 * gw, 3)
        args = (bf12[0], posb) + bf12[2:]
        worst = max(worst, case(f"b1 {n} tokens ({16 * gh} x {16 * gw} "
                                f"image) n_pad 256 depth 12", img, args,
                                heads))
    worst = max(worst, case("b1 quick_gelu depth 12",
                            _full_images(1, seed=312), bf12, heads,
                            act="quick_gelu"))
    bfl, _ = _full_args(2, seed=320, d=1024, m=4096)
    worst = max(worst, case("ViT-L/16 width b1 (D 1024, M 4096, 16 heads) "
                            "depth 2", _full_images(1, seed=321), bfl, 16))
    img = _full_images(1, seed=330)
    _repeat_identical("K12 b1 depth 12", lambda: vs.vit_full(
        img, *bf12, heads, 16, eps=EPS))
    return worst


def _k20_edges(i812, heads=12):
    """K20 at the edges of K19a's new design (``_k19a_edges``): b2 and b3,
    the position table padded to 256 rows (two query items, 59 padding
    rows), quick_gelu and ViT-L/16's width at depth 2, each within its
    logits band and in norm; then 20 back-to-back b1 depth-12 launches
    bit for bit.  Returns the max-abs error."""
    from vit_fpga_tpu_torch.ops import vit_stack as vs
    worst = 0.0

    def case(label, img, args, heads, act="gelu_tanh", floor=True):
        got = vs.vit_full_int8(img, *args, heads, 16, eps=EPS, act=act)
        want = vs.vit_full_int8_plain(img, *args, heads, 16, eps=EPS,
                                      act=act)
        torch.cuda.synchronize()
        _relnorm(f"K20 {label} logits", got, want, STACK_INT8_NORM)
        return _full_logits(f"K20 {label} logits", got, want,
                            FULL_INT8_LOGITS_TOL,
                            _full_int8_floor(img, args, heads)
                            if floor and act == "gelu_tanh" else None)

    print("K20 edges: batches, a 256-row position table, quick_gelu, "
          "ViT-L/16 width")
    for batch in (2, 3):
        img = _full_images(batch, seed=200)
        worst = max(worst, case(f"b{batch} depth 1", img,
                                _full_depth(i812, 1, 3), heads))
        worst = max(worst, case(f"b{batch} depth 12", img, i812, heads))
    _, i8p = _full_args(12, seed=210, n_pad=256)
    worst = max(worst, case("b2 n_pad 256 depth 12", _full_images(2, seed=211),
                            i8p, heads))
    worst = max(worst, case("b1 quick_gelu depth 12", _full_images(1, seed=212),
                            i812, heads, act="quick_gelu"))
    _, i8l = _full_args(2, seed=220, d=1024, m=4096)
    worst = max(worst, case("ViT-L/16 width b1 (D 1024, M 4096, 16 heads) "
                            "depth 2", _full_images(1, seed=221), i8l, 16))
    img = _full_images(1, seed=230)
    _repeat_identical("K20 b1 depth 12", lambda: vs.vit_full_int8(
        img, *i812, heads, 16, eps=EPS))
    return worst


def _full_library(images, args, heads, int8, patch=16):
    """The whole model as PyTorch calls the port never makes: F.conv2d for
    the patch embed, _stack_library's layers, F.layer_norm and a matmul
    head (torch._int_mm with torch-op quantization for int8)."""
    import torch.nn.functional as F
    from vit_fpga_tpu_torch.ops.quant_fused import _row_quant as rq
    bf = torch.bfloat16
    b = images.shape[0]
    x_nchw = images.permute(0, 3, 1, 2).to(bf).contiguous()
    if int8:
        wpq, wps, posb, tree, lfs, lfb, whq, whs, bh = args
        wp = (wpq.float() * wps).to(bf)
    else:
        wp, posb, tree, lfs, lfb, wh, bh = args
    d = wp.shape[-1]
    kern = wp.reshape(patch, patch, 3, d).permute(3, 2, 0, 1).contiguous()
    n_pad = posb.shape[0]
    n = 1 + (images.shape[1] // patch) ** 2
    buf = torch.zeros((b, n_pad, d), dtype=bf, device="cuda")
    layers = _stack_library(buf, tree, heads, n, int8)
    posb_b = posb.to(bf)

    def run():
        e = F.conv2d(x_nchw, kern, stride=patch).flatten(2).transpose(1, 2)
        buf[:, 1:n] = e + posb_b[1:n]
        buf[:, 0] = posb_b[0]
        cls = F.layer_norm(layers()[:, 0].float(), (d,), lfs, lfb, EPS)
        if int8:
            q, s = rq(cls)
            if b < 17:   # torch._int_mm wants more than 16 rows
                q = F.pad(q, (0, 0, 0, 17 - b))
            return torch._int_mm(q, whq)[:b].float() * (s * whs) + bh
        return torch.addmm(bh, cls.to(bf).float(), wh.float())
    return run


def phase_full_timing(batches=(1, 4), heads=12, d=768, m=3072):
    """K12 and K20 at depth 12 at each batch: the kernel's time, its plain
    version's, the library yardstick's and the bound; then each kernel's
    stage clock at b1.  Returns {batch: {name: dict of times}}."""
    from vit_fpga_tpu_torch.ops import vit_stack as vs
    from vit_fpga_tpu_torch.utils.timing import time_cuda
    bf12, i812 = _full_args(12, seed=140)
    depth, n, n_pad, p3, cls_pad = 12, 197, 200, 768, 1024
    wmat = 4 * d * d + 2 * d * m
    vecs = 3 * d + d + m + d + 4 * d
    out = {}
    for batch in batches:
        img = _full_images(batch, seed=141)
        tok = batch * n
        gemm = 2 * tok * wmat * depth
        attn = 4 * batch * heads * n * n * (d // heads) * depth
        edge = 2 * batch * (n - 1) * p3 * d + 2 * batch * d * cls_pad
        io = img.numel() * 4 + batch * cls_pad * 4 + n_pad * d * 4 + 2 * d * 4
        cases = {
            "vit_full": (vs.vit_full, vs.vit_full_plain, bf12, False,
                         _bound(gemm + attn + edge,
                                depth * (wmat * 2 + vecs * 4) + io
                                + (p3 * d + d * cls_pad) * 2 + cls_pad * 4)),
            "vit_full_int8": (
                vs.vit_full_int8, vs.vit_full_int8_plain, i812, True,
                _bound_int8(gemm + edge, attn,
                            depth * (wmat + (vecs + 3 * d + m) * 4) + io
                            + p3 * d + d * 4 + d * cls_pad
                            + 2 * cls_pad * 4)),
        }
        out[batch] = {}
        for name, (kern, plain, args, int8, (bound_ms, bound_by)) in \
                cases.items():
            ms = time_cuda(lambda: kern(img, *args, heads, 16, eps=EPS),
                           iters=50, warmup=5)
            plain_ms = time_cuda(lambda: plain(img, *args, heads, 16,
                                               eps=EPS), iters=3, warmup=1)
            lib_ms = _library_ms(_full_library(img, args, heads, int8), name)
            out[batch][name] = dict(ms=ms, plain_ms=plain_ms,
                                    library_ms=lib_ms, bound_ms=bound_ms,
                                    bound_by=bound_by)
            print(f"timing {name} b{batch} depth 12: kernel {ms:.4f} ms, "
                  f"plain {plain_ms:.4f} ms, library {lib_ms} ms, bound "
                  f"{bound_ms:.4f} ms ({bound_by})")
    img = _full_images(1, seed=141)
    for name, kern, args, stages in (
            ("K12", vs.vit_full, bf12, vs.K12_STAGES),
            ("K20", vs.vit_full_int8, i812, vs.K20_STAGES)):
        trace = vs.new_trace(img.device)
        for _ in range(10):
            kern(img, *args, heads, 16, eps=EPS, trace=trace)
        torch.cuda.synchronize()
        rep = vs.trace_report(trace, stages, 10)
        print(f"stage clock {name} b1 depth 12 ({rep['blocks']} blocks, us "
              f"per launch: wall, mean work, max work, barrier):")
        for stage in stages:
            row = rep[stage]
            print(f"  {row['wall']:8.2f} {row['busy_mean']:8.2f} "
                  f"{row['busy_max']:8.2f} {row['barrier']:8.2f}  {stage}")
        print(f"  total {rep['total_wall']:.2f} us, barrier share "
              f"{rep['barrier_share']:.3f}")
    return out


def _launches(fn, calls=3):
    """(kernel names, copies) the profiler sees on the card over ``calls``
    calls of fn, after one untimed call."""
    from vit_fpga_tpu_torch.profile_forward import _device_events
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    names = [name for name, _, _ in _device_events(prof)]
    kernels = [n for n in names if not n.startswith(("Memcpy", "Memset"))]
    return kernels, len(names) - len(kernels)


def phase_full_forward_time(loops=5, iters=32):
    """ms per b1 and b4 request of the separate-launch latency forwards
    (K11 or K19a with the torch embed and head) against the single-launch
    ones (K12, K20), each on seeded uint8 images through its
    make_forward_*(raw=True): in turns (separate, single, single,
    separate), each turn the p50 and max of ``loops`` loops of ``iters``
    calls; then torch launches per request (kernels and copies the
    profiler sees): a single-launch request may launch no kernel but
    preprocess's kinds and its own."""
    from vit_fpga_tpu_torch.models import quantized, vit
    from vit_fpga_tpu_torch.utils.timing import time_cuda
    cfg = vit.config("vit_b16", dtype="bfloat16")
    params = vit.init_params(cfg, _gen(9), device="cuda")
    qparams = quantized.quantize_vit_fast(params)
    fwds = {"bf16 separate": vit.make_forward_latency(cfg, params),
            "bf16 single": vit.make_forward_latency(cfg, params, full=True),
            "int8 separate": quantized.make_forward_int8_latency(
                cfg, qparams),
            "int8 single": quantized.make_forward_int8_latency(
                cfg, qparams, full=True)}
    out = {}
    for batch in (1, 4):
        image = torch.from_numpy(np.random.default_rng(9).integers(
            0, 256, (batch, cfg.image_size, cfg.image_size, 3),
            np.uint8)).cuda()
        runs = {name: [] for name in fwds}
        for dt in ("bf16", "int8"):
            for kind in ("separate", "single", "single", "separate"):
                name = f"{dt} {kind}"
                est = sorted(time_cuda(lambda: fwds[name](image),
                                       iters=iters, warmup=2)
                             for _ in range(loops))
                runs[name].append((est[len(est) // 2], est[-1]))
        calls = 3
        # preprocess's kernels, the union of PROFILER_TRIES reads: a read
        # can drop records, and a kernel it dropped would count as foreign
        pre = set()
        for _ in range(PROFILER_TRIES):
            pre |= set(_launches(lambda: vit.preprocess(image, cfg), calls)[0])
        for name, fwd in fwds.items():
            kernels, copies = _launches(lambda: fwd(image), calls)
            for _ in range(PROFILER_TRIES - 1):
                # a profiler that dropped every record of K12 / K20 is
                # read again, never taken for a forward without them
                if not name.endswith("single") or set(kernels) - pre:
                    break
                print(f"  {name}: the profiler saw none of K12's / K20's "
                      f"launches; reading it again")
                kernels, copies = _launches(lambda: fwd(image), calls)
            n = len(kernels) + copies
            out[(batch, name)] = dict(turns=runs[name], launches=n / calls)
            print(f"forward {name} b{batch}: p50 / max ms per request "
                  + ", ".join(f"{p:.4f} / {mx:.4f}" for p, mx in runs[name])
                  + f"; {len(kernels) / calls:.1f} kernels and "
                  f"{copies / calls:.1f} copies per request")
            # by name, not by count: some hosts' profiler misses a kernel
            # now and then.  The separate path's embed, LN and head add
            # GEMM and reduction kernels that preprocess never runs.
            extra = {k for k in kernels if k not in pre}
            for _ in range(PROFILER_TRIES if name.endswith("single") else 0):
                # preprocess's reads may all have dropped a kernel's
                # records: read it again before taking one for foreign
                if all("vit_full" in k for k in extra):
                    break
                pre |= set(_launches(lambda: vit.preprocess(image, cfg),
                                     calls)[0])
                extra = {k for k in kernels if k not in pre}
            if name.endswith("single") and (
                    not extra or any("vit_full" not in k for k in extra)):
                raise AssertionError(
                    f"{name}: kernels beyond preprocess's and K12's / K20's "
                    f"(or none of theirs): {sorted(extra)}")
        # the two forms agree on the same request
        for dt in ("bf16", "int8"):
            a = fwds[f"{dt} separate"](image).float().cpu().numpy()
            b = fwds[f"{dt} single"](image).float().cpu().numpy()
            rel = float(np.abs(a - b).max() / np.abs(a).max())
            print(f"  {dt} b{batch}: single vs separate logits max |a-b| / "
                  f"max |a| = {rel:.3e}, top-1 agree "
                  f"{int((a.argmax(1) == b.argmax(1)).sum())}/{batch}")
    return out


def phase_full_serve(n_requests=64, n_check=3):
    """ImageServer(batch_size=1) over make_forward_latency(full=True) and
    make_forward_int8_latency(full=True) answers ``n_requests`` uint8
    requests, one at a time: exactly one K12 (or K20) launch per request
    and no other kernel of the port (no K11, K19a, K14, separate embed or
    head), p50/p99 on the host clock, and the logits of ``n_check`` images
    against the CPU forward of the same weights.  Returns {kernel name:
    launches}."""
    from vit_fpga_tpu_torch.models import quantized, vit
    from vit_fpga_tpu_torch.runtime.serving import ImageServer
    from vit_fpga_tpu_torch.utils.log import Metrics
    cfg = vit.config("vit_b16", dtype="bfloat16")
    params = vit.init_params(cfg, _gen(10), device="cuda")
    qparams = quantized.quantize_vit_fast(params)
    images = np.random.default_rng(10).integers(
        0, 256, (n_requests, cfg.image_size, cfg.image_size, 3), np.uint8)
    paths = {
        "bf16": (vit.make_forward_latency(cfg, params, full=True),
                 lambda: vit.make_forward_latency(
                     cfg, _tree_to(params, "cpu"), device="cpu", full=True),
                 "vit_full", LOGITS_BAND),
        "int8": (quantized.make_forward_int8_latency(cfg, qparams, full=True),
                 lambda: quantized.make_forward_int8_latency(
                     cfg, _tree_to(qparams, "cpu"), device="cpu", full=True),
                 "vit_full_int8", INT8_LOGITS_BAND),
    }
    five = torch.zeros((5, cfg.image_size, cfg.image_size, 3), device="cuda")
    _expect_raise("forward_latency_logits at batch 5 on the card",
                  lambda: vit.forward_latency_logits(params, five, cfg),
                  NotImplementedError)
    _expect_raise("vit_forward_int8_latency_logits at batch 5 on the card",
                  lambda: quantized.vit_forward_int8_latency_logits(
                      qparams, five, cfg), NotImplementedError)
    launches = {}
    idx = list(range(n_check))
    for label, (fwd, cpu_maker, kernel, band) in paths.items():
        fwd(images[:1])
        torch.cuda.synchronize()
        Metrics.reset()
        counters = _zero_counters()
        t0 = time.perf_counter()
        with ImageServer(fwd, image_size=cfg.image_size,
                         batch_size=1) as server:
            results = [server.submit_raw(img).result(timeout=600)
                       for img in images]
            wall = time.perf_counter() - t0
            pct = server.latency_percentiles()
        got = _check_launches(f"full slice {label}", counters,
                              {kernel: n_requests})
        print(f"full slice {label}: {len(results)}/{n_requests} answered in "
              f"{wall:.3f} s, p50 {pct['p50']:.3f} ms, p99 {pct['p99']:.3f} "
              f"ms (submit to logits, one request in flight); launches "
              f"{ {k: v for k, v in got.items() if v} }")
        if len(results) != n_requests or server.served != n_requests:
            raise AssertionError(f"{label}: not every request was answered")
        for r in results:
            if r.shape != (cfg.num_classes,) or not np.isfinite(r).all():
                raise AssertionError(f"{label}: bad logits row {r.shape}")
        launches[kernel] = got[kernel]
        ref = cpu_maker()(images[idx]).numpy()
        _rel_to_max(f"full slice {label} logits of images {idx} vs the CPU "
                    f"forward", np.stack([results[i] for i in idx]), ref,
                    band)
    return launches


def run_full_phases(errors, timing, launches):
    """The whole-model single-launch phases after the earlier slices' ones
    (K12 and K20 parity ran right after the build)."""
    full_timing = phase_full_timing()
    for name in FULL_KERNELS:
        timing[name] = dict(full_timing[1][name], max_abs_err=errors[name])
    phase_full_forward_time()
    launches.update(phase_full_serve())
    print(_smi_line())


# ---------------------------------------------------------------------------
# Phase 15: the per-block path (ViT-B/16 at 1024 px, per-tensor int8, knobs)
# ---------------------------------------------------------------------------

PER_BLOCK_KERNELS = ("flash_attention", "mha_qkv_pallas", "mha_pallas",
                     "fused_mlp_chunked")
# ViT-B/16 at 1024 px: 4097 tokens on 4104 rows, 12 heads of 64.
B1024 = dict(n=4104, n_valid=4097, d=768, heads=12)
# f32 K7 / K8 against their plain versions: the same f32 products summed in
# another order (64-term dots, up to 197-term sums), |error| ~1e-6 on
# outputs of order 1; a key wrongly kept or dropped moves a row by ~1/197.
F32_ATTN_TOL = 1e-5
# Per-tensor int8 forward on the card vs the CPU: one activation scale per
# tensor, so a rint flipped by an f32 rounding moves a whole step (1/127 of
# the tensor's absmax); the JAX forward against itself on inputs moved by
# 1e-7 reads 0.9% at depth 2 (tests/test_torch_per_block.py).  The phase
# prints the floor (plain versions on the card vs the CPU) beside the gap.
PER_TENSOR_BAND = INT8_LOGITS_BAND


def _seq_qkv(batch, n, d, seed, dtype=torch.bfloat16, std=1.0):
    return _randn(_gen(seed), batch, n, 3 * d, std=std).to(dtype)


# (b, h, n, n_valid, bk) of K9's late-max cases: n_valid at the end of a
# 128-key tile and one past it, at the per-block path's bk 128, the flash
# impl's 512 (1025 keys: a last block of one tile) and 384 (blocks of three
# tiles).
K9_LATE_MAX = ((1, 4, 640, 512, 128), (1, 4, 640, 513, 128),
               (1, 4, 1152, 1024, 512), (2, 2, 1152, 1025, 512),
               (1, 2, 1152, 1025, 384))


def _k9(qkv, heads, n_valid, fn, bk=128):
    """K9 (or its plain version, ``fn``) on packed qkv as the per-block
    path runs it: bq 512, bk 128, the head split and merge as views."""
    from vit_fpga_tpu_torch.ops import attention as at
    b, n, d3 = qkv.shape
    o = fn(*at._heads(qkv, heads), n_valid, bq=512, bk=bk)
    return o.transpose(1, 2).reshape(b, n, d3 // 3)


def _unmoved(label, fn, qkv, n_valid):
    """Padding keys set to 1e4: the valid rows must not move at all."""
    loud = qkv.clone()
    loud[:, n_valid:] = 1e4
    quiet, noisy = fn(qkv), fn(loud)
    torch.cuda.synchronize()
    moved = float((noisy[:, :n_valid].float()
                   - quiet[:, :n_valid].float()).abs().max())
    print(f"  {label} loud padding keys {n_valid}..{qkv.shape[1] - 1}: "
          f"valid rows moved by max_abs={moved:.3e} (must be 0)")
    if moved != 0.0 or not torch.isfinite(noisy[:, :n_valid]).all():
        raise AssertionError(f"{label}: padding keys moved the valid rows")


def _unmoved_heads(label, fn, q, k, v, n_valid):
    """(B, H, N, Dh) layout: padding keys and values set to 1e4 must not
    move any output row at all."""
    loud_k, loud_v = k.clone(), v.clone()
    loud_k[:, :, n_valid:] = 1e4
    loud_v[:, :, n_valid:] = 1e4
    quiet, noisy = fn(q, k, v, n_valid), fn(q, loud_k, loud_v, n_valid)
    torch.cuda.synchronize()
    moved = float((noisy.float() - quiet.float()).abs().max())
    print(f"  {label} loud padding keys {n_valid}..{k.shape[2] - 1}: output "
          f"moved by max_abs={moved:.3e} (must be 0)")
    if moved != 0.0 or not torch.isfinite(noisy).all():
        raise AssertionError(f"{label}: padding keys moved the output")


def _seq_case(label, kernel, plain, *args):
    """One bf16 K7 / K8 case: the kernel against its plain version
    elementwise at BF16_TOL and in norm at BRANCH_TOL (the ulp flips move
    the output by ~1e-3 in norm; a key wrongly kept among 17 by ~1/18)."""
    got, want = kernel(*args), plain(*args)
    err = _compare(label, got, want, BF16_TOL, BF16_TOL)
    _relnorm(f"{label} in norm", got, want, BRANCH_TOL)
    return err


def _out_view_case(label, q, k, v, n_valid, packed):
    """The bf16 K7 / K8 kernel writing into a view of a larger buffer filled
    with a loud value: packed, (B, N, H, 64) columns of a (B, N + 8,
    (H + 1) 64) buffer; else (B, H, N, 64) of (B, H + 1, N + 8, 64).  The
    view is held to the plain version, every element outside it (later
    rows, another head's columns) must come back bit for bit."""
    from vit_fpga_tpu_torch.ops import attention as at
    from vit_fpga_tpu_torch.ops.flash_attention import launch_strided
    b, h, n, dh = q.shape
    loud = 4096.0
    if packed:
        shape = (b, n + 8, (h + 1) * dh)

        def view(t):
            return t[:, :n, :h * dh].view(b, n, h, dh).transpose(1, 2)
    else:
        shape = (b, h + 1, n + 8, dh)

        def view(t):
            return t[:, :h, :n]
    buf = torch.full(shape, loud, dtype=q.dtype, device=q.device)
    inside = torch.zeros(shape, dtype=torch.bool, device=q.device)
    view(inside).fill_(True)
    launch_strided(label, "vft_mha", q, k, v, view(buf), n_valid, 0)
    torch.cuda.synchronize()
    err = _compare(label, view(buf), at.mha_pallas_plain(q, k, v, n_valid),
                   BF16_TOL, BF16_TOL)
    moved = int((buf[~inside] != loud).sum())
    print(f"  {label}: {moved} of {int((~inside).sum())} elements outside "
          f"the view changed (must be 0)")
    if moved:
        raise AssertionError(f"{label}: wrote outside its out view")
    return err


def _chunk_terms(x, p, act, n_chunks):
    """sum_c |y_c| per output element (f32, the plain activation): the
    magnitudes K6's running output passes through between chunk
    boundaries, where a flipped bf16 ulp lands."""
    from vit_fpga_tpu_torch.ops import fused_mlp as fm
    from vit_fpga_tpu_torch.ops.common import ln_parts
    xhat, _ = ln_parts(x, EPS)
    h = fm._act((xhat * p["ln_scale"] + p["ln_bias"]) @ p["w1"] + p["b1"],
                act)
    mc = h.shape[1] // n_chunks
    return sum((h[:, c * mc:(c + 1) * mc] @ p["w2"][c * mc:(c + 1) * mc])
               .abs() for c in range(n_chunks))


def _k6_call(fn, x, p, act, n_chunks):
    return fn(x, p["ln_scale"], p["ln_bias"], p["w1"], p["b1"], p["w2"],
              p["b2"], eps=EPS, act=act, n_chunks=n_chunks)


def phase_per_block_kernels():
    """K9, K7, K8 and K6 against their plain versions on the card, right
    after the build: K9 on ViT-B/16 @1024's packed (1, 4104, 2304) qkv
    (4097 valid, bk 128) and at (1, 2, 300) / (2, 2, 1100) with bk 128 and
    512; K7 bf16 on the same qkv and f32 at the per-tensor path's (64, 197,
    2304) and (4, 200, 2304) with 197 valid; K8 at (2, 12, 300, 64) with
    257 valid, bf16 and f32; K8 and K9 (bk 512) at attention.mha's (1, 12,
    4104, 64) with 4097 valid; K7 / K8 bf16 at the wgmma kernel's edges
    (17 and 64 tokens, 127 / 128 / 129 valid of 200, K7 at (64, 197, 2304)
    and (64, 200, 2304) with 197 valid, K8 at (3, 12, 300, 64) with 257),
    also in norm, and writing into out views of a loud buffer whose other
    elements must come back bit for bit; K7 / K8 f32 at the one-pass
    kernel's edges (1, 63, 64, 65 and 197 valid of 200, 577 of 584, K8 at
    (1, 2, 1100, 64) with 1100 and 1000 valid); loud padding keys that must
    leave the valid rows bit for bit (K9 both bk, K7 both types, K8); K6 at
    ViT-L's (1600, 1024) x
    4096 in 2 chunks and ViT-H's (2112, 1280) x 5120 in 4, each activation,
    with its distance from K5's function (at least half the plain versions'
    share of differing elements); then the gates.
    Returns {kernel name: max-abs error}."""
    from vit_fpga_tpu_torch.ops import attention as at
    from vit_fpga_tpu_torch.ops import flash_attention as fa
    from vit_fpga_tpu_torch.ops import fused_mlp as fm
    c = B1024
    qkv = _seq_qkv(1, c["n"], c["d"], seed=160, std=2.0)
    print(f"parity K9 flash_attention (12, {c['n']}, 64) n_valid "
          f"{c['n_valid']}, bq 512, bk 128")
    k9 = _compare("K9 ViT-B/16 @1024", _k9(qkv, 12, c["n_valid"],
                                           fa.flash_attention),
                  _k9(qkv, 12, c["n_valid"], fa.flash_attention_plain),
                  BF16_TOL, BF16_TOL)
    _unmoved("K9", lambda t: _k9(t, 12, c["n_valid"], fa.flash_attention),
             qkv, c["n_valid"])
    for b, h, n, nv, bk in ((1, 2, 300, 257, 128), (1, 2, 300, 257, 512),
                            (2, 2, 1100, 1100, 128), (1, 2, 1100, 1000, 512)):
        g = _gen(161 + n + bk)
        q, k, v = (_randn(g, b, h, n, 64).to(torch.bfloat16)
                   for _ in range(3))
        k9 = max(k9, _compare(
            f"K9 ({b}, {h}, {n}, 64) n_valid={nv} bk={bk}",
            fa.flash_attention(q, k, v, nv, bk=bk),
            fa.flash_attention_plain(q, k, v, nv, bk=bk), BF16_TOL,
            BF16_TOL))
    print("parity K9 with a late max: keys scaled by 0.2 .. 3 along the "
          "sequence, so that the running max rises in later key blocks")
    for b, h, n, nv, bk in K9_LATE_MAX:
        g = _gen(186 + nv + bk)
        q, k, v = (_randn(g, b, h, n, 64) for _ in range(3))
        k = k * torch.linspace(0.2, 3.0, n, device="cuda")[None, None, :,
                                                             None]
        q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
        late = (q.float() @ k[:, :, :nv].float().transpose(-1, -2)
                ).argmax(-1) >= bk
        k9 = max(k9, _compare(
            f"K9 late max ({b}, {h}, {n}, 64) n_valid={nv} bk={bk} "
            f"({float(late.float().mean()):.0%} of rows peak past the first "
            f"block)",
            fa.flash_attention(q, k, v, nv, bk=bk),
            fa.flash_attention_plain(q, k, v, nv, bk=bk), BF16_TOL,
            BF16_TOL))

    print("parity K7 mha_qkv_pallas, bf16 at 4104 rows and f32 at the "
          "per-tensor path's (64, 197, 2304)")
    k7 = _compare("K7 bf16 ViT-B/16 @1024",
                  at.mha_qkv_pallas(qkv, 12, c["n_valid"]),
                  at.mha_qkv_pallas_plain(qkv, 12, c["n_valid"]),
                  BF16_TOL, BF16_TOL)
    _unmoved("K7 bf16", lambda t: at.mha_qkv_pallas(t, 12, c["n_valid"]),
             qkv, c["n_valid"])
    qf = _seq_qkv(64, 197, 768, seed=165, dtype=torch.float32)
    k7 = max(k7, _compare("K7 f32 (64, 197, 2304)", at.mha_qkv_pallas(qf, 12),
                          at.mha_qkv_pallas_plain(qf, 12), F32_ATTN_TOL,
                          F32_ATTN_TOL))
    qf = _seq_qkv(4, 200, 768, seed=166, dtype=torch.float32)
    k7 = max(k7, _compare("K7 f32 (4, 200, 2304) n_valid=197",
                          at.mha_qkv_pallas(qf, 12, 197),
                          at.mha_qkv_pallas_plain(qf, 12, 197), F32_ATTN_TOL,
                          F32_ATTN_TOL))
    _unmoved("K7 f32", lambda t: at.mha_qkv_pallas(t, 12, 197), qf, 197)

    print("parity K8 mha_pallas (2, 12, 300, 64) n_valid 257, bf16 and f32, "
          "and bf16 at attention.mha's (1, 12, 4104, 64) n_valid 4097")
    k8 = 0.0
    g = _gen(167)
    q, k, v = (_randn(g, 2, 12, 300, 64) for _ in range(3))
    for dt, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, F32_ATTN_TOL)):
        qd, kd, vd = q.to(dt), k.to(dt), v.to(dt)
        k8 = max(k8, _compare(f"K8 {dt}", at.mha_pallas(qd, kd, vd, 257),
                              at.mha_pallas_plain(qd, kd, vd, 257), tol,
                              tol))
        _unmoved_heads(f"K8 {dt}", at.mha_pallas, qd, kd, vd, 257)
    # The shape attention.mha gives K8 (impl "pallas") and K9 (impl
    # "flash", the default bk 512) on the main path.
    g = _gen(185)
    q, k, v = (_randn(g, 1, 12, c["n"], 64, std=2.0).to(torch.bfloat16)
               for _ in range(3))
    nv = c["n_valid"]
    k8 = max(k8, _compare(f"K8 bf16 (1, 12, {c['n']}, 64) n_valid={nv}",
                          at.mha_pallas(q, k, v, nv),
                          at.mha_pallas_plain(q, k, v, nv), BF16_TOL,
                          BF16_TOL))
    _unmoved_heads("K8 bf16 @1024", at.mha_pallas, q, k, v, nv)
    k9 = max(k9, _compare(f"K9 (1, 12, {c['n']}, 64) n_valid={nv} bk=512",
                          fa.flash_attention(q, k, v, nv),
                          fa.flash_attention_plain(q, k, v, nv), BF16_TOL,
                          BF16_TOL))
    _unmoved_heads("K9 bk=512 @1024", fa.flash_attention, q, k, v, nv)

    print("parity K7 / K8 bf16 at the wgmma kernel's edges: one partial "
          "tile (n 17, 64), the key tile's edge (n_valid 127, 128, 129 of "
          "200), K7 at the 224-px path's (64, 197, 2304), K8 at (3, 12, 300, "
          "64) with 257 valid, out views into a loud buffer")
    for n, nv in ((17, 17), (64, 64), (200, 127), (200, 128), (200, 129)):
        qkv = _seq_qkv(2, n, 128, seed=190 + nv)
        k7 = max(k7, _seq_case(f"K7 bf16 (2, {n}, 384) n_valid={nv}",
                               at.mha_qkv_pallas, at.mha_qkv_pallas_plain,
                               qkv, 2, nv))
        _unmoved(f"K7 bf16 (2, {n}, 384)",
                 lambda t: at.mha_qkv_pallas(t, 2, nv), qkv, nv)
        q, k, v = (t.contiguous() for t in at._heads(qkv, 2))
        k8 = max(k8, _seq_case(f"K8 bf16 (2, 2, {n}, 64) n_valid={nv}",
                               at.mha_pallas, at.mha_pallas_plain, q, k, v,
                               nv))
        _unmoved_heads(f"K8 bf16 (2, 2, {n}, 64)", at.mha_pallas, q, k, v, nv)
    qkv = _seq_qkv(64, 197, 768, seed=195)
    k7 = max(k7, _seq_case("K7 bf16 (64, 197, 2304)", at.mha_qkv_pallas,
                           at.mha_qkv_pallas_plain, qkv, 12, 197))
    qkv = _seq_qkv(64, 200, 768, seed=196)
    k7 = max(k7, _seq_case("K7 bf16 (64, 200, 2304) n_valid=197",
                           at.mha_qkv_pallas, at.mha_qkv_pallas_plain, qkv,
                           12, 197))
    _unmoved("K7 bf16 (64, 200, 2304)",
             lambda t: at.mha_qkv_pallas(t, 12, 197), qkv, 197)
    g = _gen(197)
    q, k, v = (_randn(g, 3, 12, 300, 64, std=2.0).to(torch.bfloat16)
               for _ in range(3))
    k8 = max(k8, _seq_case("K8 bf16 (3, 12, 300, 64) n_valid=257",
                           at.mha_pallas, at.mha_pallas_plain, q, k, v, 257))
    _unmoved_heads("K8 bf16 (3, 12, 300, 64)", at.mha_pallas, q, k, v, 257)
    k8 = max(k8, _out_view_case("K8 bf16 out view (3, 12, 300, 64) "
                                "n_valid=257", q, k, v, 257, packed=False))
    q, k, v = at._heads(_seq_qkv(3, 200, 768, seed=198), 12)
    k7 = max(k7, _out_view_case("K7 bf16 out view (3, 200, 2304) "
                                "n_valid=129", q, k, v, 129, packed=True))

    print("parity K7 / K8 f32 at the one-pass kernel's edges: n_valid 1, "
          "63, 64, 65 and 197 of 200 and 577 of 584 (64-key tiles cut to "
          "their 16-key groups, 32-row warps past n), K8 at (1, 2, 1100, 64)")
    for n, nv in ((200, 1), (200, 63), (200, 64), (200, 65), (200, 197),
                  (584, 577)):
        qkv = _seq_qkv(2, n, 128, seed=200 + nv, dtype=torch.float32)
        k7 = max(k7, _compare(f"K7 f32 (2, {n}, 384) n_valid={nv}",
                              at.mha_qkv_pallas(qkv, 2, nv),
                              at.mha_qkv_pallas_plain(qkv, 2, nv),
                              F32_ATTN_TOL, F32_ATTN_TOL))
        _unmoved(f"K7 f32 (2, {n}, 384)",
                 lambda t: at.mha_qkv_pallas(t, 2, nv), qkv, nv)
        q, k, v = (t.contiguous() for t in at._heads(qkv, 2))
        k8 = max(k8, _compare(f"K8 f32 (2, 2, {n}, 64) n_valid={nv}",
                              at.mha_pallas(q, k, v, nv),
                              at.mha_pallas_plain(q, k, v, nv),
                              F32_ATTN_TOL, F32_ATTN_TOL))
    g = _gen(210)
    q, k, v = (_randn(g, 1, 2, 1100, 64) for _ in range(3))
    for nv in (1100, 1000):
        k8 = max(k8, _compare(f"K8 f32 (1, 2, 1100, 64) n_valid={nv}",
                              at.mha_pallas(q, k, v, nv),
                              at.mha_pallas_plain(q, k, v, nv),
                              F32_ATTN_TOL, F32_ATTN_TOL))
    _unmoved_heads("K8 f32 (1, 2, 1100, 64)", at.mha_pallas, q, k, v, 1000)

    print("parity K6 fused_mlp_chunked: ViT-L (1600, 1024) x 4096 in 2 "
          "chunks, ViT-H (2112, 1280) x 5120 in 4, (1000, 1024) x 4096 in 2 "
          "(a partial 128-row tile)")
    k6 = 0.0
    for rows, d, m, nc, seed in ((1600, 1024, 4096, 2, 168),
                                 (2112, 1280, 5120, 4, 169),
                                 (1000, 1024, 4096, 2, 171)):
        x, _, p = _mlp_inputs(rows, d, m, seed)
        pb = _bf16_weights(p, ("w1", "w2"))
        for act in MLP_ACTS_K3:
            label = f"K6 ({rows}, {d}) x {m} n_chunks={nc} {act}"
            got = _k6_call(fm.fused_mlp_chunked_fwd, x, pb, act, nc)
            want = _k6_call(fm.fused_mlp_chunked_plain, x, pb, act, nc)
            mag = (want.float().abs() + x.float().abs()
                   + _chunk_terms(x.float(), p, act, nc))
            k6 = max(k6, _compare(label, got, want, BF16_TOL, BF16_TOL,
                                  mag=mag))
            _branch(f"{label} branch", got, want, x)
            # K6 is not K5: it rounds the running output at every chunk
            # boundary.  The two plain versions differ on a share of the
            # elements; the kernel must differ from K5's function on at
            # least half that share (f32 order alone moves well under 1%).
            k5 = fm.fused_mlp_xla(x, pb["ln_scale"], pb["ln_bias"], pb["w1"],
                                  pb["b1"], pb["w2"], pb["b2"], eps=EPS,
                                  act=act)
            share = float(((got.float() - k5.float()).abs() > 0)
                          .float().mean())
            plain_share = float(((want.float() - k5.float()).abs() > 0)
                                .float().mean())
            print(f"  {label}: {share:.3%} of elements differ from K5's "
                  f"function (the plain versions: {plain_share:.3%}; must "
                  f"be at least half that)")
            if not share >= 0.5 * plain_share:
                raise AssertionError(f"{label}: K6 computed K5's function")

    q32 = torch.zeros(1, 1, 256, 64, device="cuda")
    qb = q32.to(torch.bfloat16)
    _expect_raise("K9 f16", lambda: fa.flash_attention(*(q32.half(),) * 3))
    _expect_raise("K9 bk=192", lambda: fa.flash_attention(qb, qb, qb, bk=192))
    q80 = torch.zeros(1, 1, 256, 80, dtype=torch.bfloat16, device="cuda")
    _expect_raise("K9 head dim 80", lambda: fa.flash_attention(q80, q80, q80))
    _expect_raise("K7 head dim 80", lambda: at.mha_qkv_pallas(
        torch.zeros(1, 64, 480, dtype=torch.bfloat16, device="cuda"), 2))
    _expect_raise("K8 f16", lambda: at.mha_pallas(*(q32.half(),) * 3))
    q68 = torch.zeros(1, 1, 64, 68, dtype=torch.bfloat16,
                      device="cuda")[..., :64]
    _expect_raise("K8 bf16 rows 136 bytes apart",
                  lambda: at.mha_pallas(q68, q68, q68))
    x, _, p = _mlp_inputs(64, 128, 384, seed=170)
    _expect_raise("K6 n_chunks=3", lambda: _k6_call(
        fm.fused_mlp_chunked_fwd, x, p, "gelu_tanh", 3))
    return {"flash_attention": k9, "mha_qkv_pallas": k7, "mha_pallas": k8,
            "fused_mlp_chunked": k6}


def _bound_f32(flops, nbytes):
    t_ops = flops / H100_F32_FLOPS * 1e3
    t_mem = nbytes / H100_HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_mem else (t_mem, "bytes")


def _seq_timing(label, kernel, plain, library, flops, nbytes, bound=_bound):
    """A sequence attention kernel's time beside its plain version's, the
    library yardstick's (``scaled_dot_product_attention``) and the bound."""
    from vit_fpga_tpu_torch.utils.timing import time_cuda
    ms = time_cuda(kernel, iters=10)
    plain_ms = time_cuda(plain, iters=2, warmup=1)
    lib_ms = _library_ms(library, label)
    bound_ms, bound_by = bound(flops, nbytes)
    print(f"timing {label}: kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} "
          f"TFLOP/s), plain {plain_ms:.4f} ms, library "
          f"{lib_ms if lib_ms is None else f'{lib_ms:.4f}'} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by})")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=bound_ms, bound_by=bound_by)


def phase_per_block_timing():
    """K9 at ViT-B/16 @1024 b1 (the JSON line) and b4; K7 in f32 at the
    per-tensor path's (64, 197, 2304) (the JSON line) and in bf16 at
    4104 rows and at (64, 197, 2304); K8 at (1, 12, 4104, 64); K6 at ViT-L
    b8's (1600, 1024) x
    4096 in 2 chunks.  Yardsticks: scaled_dot_product_attention (f32 with
    TF32 off), for K6 LN + two chunks of addmm + tanh-GELU + addmm."""
    import torch.nn.functional as F
    from vit_fpga_tpu_torch.ops import attention as at
    from vit_fpga_tpu_torch.ops import flash_attention as fa
    from vit_fpga_tpu_torch.ops import fused_mlp as fm
    from vit_fpga_tpu_torch.utils.platform import true_f32
    from vit_fpga_tpu_torch.utils.timing import time_cuda
    c = B1024
    n, nv, heads = c["n"], c["n_valid"], c["heads"]
    keep = (torch.arange(n, device="cuda") < nv)[None, None, None]
    out = {}
    for batch in (1, 4):
        qkv = _seq_qkv(batch, n, c["d"], seed=171 + batch)
        q, k, v = (t.contiguous() for t in at._heads(qkv, heads))
        flops = 4 * batch * heads * n * nv * 64
        nbytes = 4 * batch * n * c["d"] * 2
        t = _seq_timing(
            f"K9 ViT-B/16 @1024 b{batch} (packed qkv, bk 128)",
            lambda: _k9(qkv, heads, nv, fa.flash_attention),
            lambda: _k9(qkv, heads, nv, fa.flash_attention_plain),
            lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=keep),
            flops, nbytes)
        if batch == 1:
            out["flash_attention"] = t
            _seq_timing(
                "K7 bf16 ViT-B/16 @1024 b1 (attn_impl='pallas')",
                lambda: at.mha_qkv_pallas(qkv, heads, nv),
                lambda: at.mha_qkv_pallas_plain(qkv, heads, nv),
                lambda: F.scaled_dot_product_attention(q, k, v,
                                                       attn_mask=keep),
                flops, nbytes)
            out["mha_pallas"] = _seq_timing(
                "K8 bf16 (1, 12, 4104, 64)",
                lambda: at.mha_pallas(q, k, v, nv),
                lambda: at.mha_pallas_plain(q, k, v, nv),
                lambda: F.scaled_dot_product_attention(q, k, v,
                                                       attn_mask=keep),
                flops, nbytes)
    qb = _seq_qkv(64, 197, 768, seed=177)
    qs = [t.contiguous() for t in at._heads(qb, heads)]
    _seq_timing("K7 bf16 (64, 197, 2304)",
                lambda: at.mha_qkv_pallas(qb, heads),
                lambda: at.mha_qkv_pallas_plain(qb, heads),
                lambda: F.scaled_dot_product_attention(*qs),
                4 * 64 * heads * 197 * 197 * 64, 64 * 197 * 4 * 768 * 2)
    qf = _seq_qkv(64, 197, 768, seed=175, dtype=torch.float32)
    qs = [t.contiguous() for t in at._heads(qf, heads)]
    with true_f32():
        out["mha_qkv_pallas"] = _seq_timing(
            "K7 f32 per-tensor int8 path (64, 197, 2304)",
            lambda: at.mha_qkv_pallas(qf, heads),
            lambda: at.mha_qkv_pallas_plain(qf, heads),
            lambda: F.scaled_dot_product_attention(*qs),
            4 * 64 * heads * 197 * 197 * 64, 64 * 197 * 4 * 768 * 4,
            bound=_bound_f32)

    rows, d, m = 1600, 1024, 4096
    x, _, p = _mlp_inputs(rows, d, m, 176)
    pb = _bf16_weights(p, ("w1", "w2"))
    ls, lb = p["ln_scale"].to(torch.bfloat16), p["ln_bias"].to(torch.bfloat16)
    b1, b2 = p["b1"].to(torch.bfloat16), p["b2"].to(torch.bfloat16)
    mc = m // 2

    def library():
        xn = F.layer_norm(x, (d,), ls, lb, EPS)
        acc = x
        for ch in range(2):
            h = F.gelu(torch.addmm(b1[ch * mc:(ch + 1) * mc], xn,
                                   pb["w1"][:, ch * mc:(ch + 1) * mc]),
                       approximate="tanh")
            y = h @ pb["w2"][ch * mc:(ch + 1) * mc]
            acc = acc + (y + b2 if ch == 1 else y)
        return acc

    ms = time_cuda(lambda: _k6_call(fm.fused_mlp_chunked_fwd, x, pb,
                                    "gelu_tanh", 2))
    plain_ms = time_cuda(lambda: _k6_call(fm.fused_mlp_chunked_plain, x, pb,
                                          "gelu_tanh", 2), iters=3, warmup=1)
    lib_ms = time_cuda(library)
    flops = 4 * rows * d * m
    bound_ms, bound_by = _bound(flops, 2 * rows * d * 2 + 2 * d * m * 2
                                + (m + 3 * d) * 4)
    print(f"timing K6 ViT-L b8 ({rows}, {d}) x {m}, 2 chunks: kernel "
          f"{ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), plain "
          f"{plain_ms:.4f} ms, library {lib_ms:.4f} ms, bound {bound_ms:.4f} "
          f"ms ({bound_by})")
    out["fused_mlp_chunked"] = dict(ms=ms, plain_ms=plain_ms,
                                    library_ms=lib_ms, bound_ms=bound_ms,
                                    bound_by=bound_by)
    return out


def _plain_per_block():
    """The per-block path's kernels swapped for their plain versions (the
    card's plain-version forwards)."""
    from unittest import mock

    from vit_fpga_tpu_torch.models import quantized
    from vit_fpga_tpu_torch.ops import attention as at
    from vit_fpga_tpu_torch.ops import attn_block as ab
    from vit_fpga_tpu_torch.ops import flash_attention as fa
    from vit_fpga_tpu_torch.ops import fused_mlp as fm
    from vit_fpga_tpu_torch.ops import quant
    from vit_fpga_tpu_torch.ops import quant_fused as qf
    stack = contextlib.ExitStack()
    stack.enter_context(mock.patch.multiple(
        at, flash_attention=fa.flash_attention_plain,
        mha_qkv_pallas=at.mha_qkv_pallas_plain))
    stack.enter_context(mock.patch.multiple(
        fm, fused_mlp_fwd=fm.fused_mlp_xla,
        fused_mlp_chunked_fwd=fm.fused_mlp_chunked_plain))
    stack.enter_context(mock.patch.object(ab, "attn_block_fwd",
                                          ab.attn_block_fwd_plain))
    stack.enter_context(mock.patch.object(
        quantized, "int8_linear_fused", qf.int8_linear_fused_plain))
    stack.enter_context(mock.patch.object(quant, "int8_gemm",
                                          quant.int8_gemm_plain))
    return stack


def _serve(label, fwd, images, batch):
    """ImageServer over ``fwd`` answers ``images``; (logits, batches)."""
    from vit_fpga_tpu_torch.runtime.serving import ImageServer
    t0 = time.perf_counter()
    with ImageServer(fwd, image_size=images.shape[1],
                     batch_size=batch) as server:
        futs = [server.submit_raw(img) for img in images]
        results = [f.result(timeout=600) for f in futs]
        wall = time.perf_counter() - t0
    print(f"{label}: {len(results)}/{len(images)} answered in "
          f"{server.batches} batches of {batch}, {wall:.3f} s")
    got = np.stack(results)
    if (server.served != len(images) or got.shape[0] != len(images)
            or not np.isfinite(got).all()):
        raise AssertionError(f"{label}: not every request was answered")
    return got, server.batches


def phase_per_block_serve(n_images=6, batch=2):
    """The main paths, each run with the counts set to 0 just before it:
    ImageServer(image_size=1024, batch_size=2) over make_forward(vit_b16
    @1024, bf16) answers 6 uint8 requests, 12 K9 + 12 K5 per batch and
    nothing else, logits against the card's plain-version forward (all) and
    the CPU forward (one image); the same requests through
    make_forward_int8 (49 K14 + 12 K9 per batch, no K15 / K16), one image
    against the CPU plain int8 forward; the per-tensor int8 forward at 224
    px b64 (12 K7 in f32 + 50 K13), against the CPU; attn_impl="pallas"
    at 1024 px b1 (12 K7 + 12 K5); mlp_impl="pallas" on ViT-L/16 @224 with
    safe_softmax, b8 (24 K4 + 24 K6); attention.mha with impl "pallas"
    and "flash" (1 K8, 1 K9).  Returns (launch counts, the 1024 px
    forwards, their images)."""
    from vit_fpga_tpu_torch.models import quantized, vit
    from vit_fpga_tpu_torch.ops import attention as at
    launches = {k: 0 for k in PER_BLOCK_KERNELS}

    def count(label, counters, want):
        got = _check_launches(label, counters, want)
        print(f"  {label} launches: { {k: v for k, v in got.items() if v} }")
        for k in PER_BLOCK_KERNELS:
            launches[k] += got[k]

    cfg = vit.config("vit_b16", image_size=1024, dtype="bfloat16")
    params = vit.init_params(cfg, _gen(180), device="cuda")
    images = np.random.default_rng(180).integers(0, 256,
                                                 (n_images, 1024, 1024, 3),
                                                 np.uint8)
    fwd = vit.make_forward(cfg, params)
    fwd(images[:batch])
    torch.cuda.synchronize()
    counters = _zero_counters()
    got, nb = _serve("bf16 ViT-B/16 @1024", fwd, images, batch)
    count("bf16 @1024", counters, {"flash_attention": 12 * nb,
                                   "fused_mlp_fwd": 12 * nb})
    with _plain_per_block():
        plain = torch.cat([fwd(images[i:i + batch]).cpu()
                           for i in range(0, n_images, batch)]).numpy()
    _rel_to_max("bf16 @1024 served logits vs the card's plain forward", got,
                plain, LOGITS_BAND)
    cpu = vit.make_forward(cfg, _tree_to(params, "cpu"), device="cpu")
    _rel_to_max("bf16 @1024 logits of image 0 vs the CPU forward", got[:1],
                cpu(images[:1]).numpy(), LOGITS_BAND)

    qparams = quantized.quantize_vit_fast(params)
    fq = quantized.make_forward_int8(cfg, qparams)
    fq(images[:batch])
    torch.cuda.synchronize()
    counters = _zero_counters()
    gotq, nb = _serve("int8 ViT-B/16 @1024", fq, images, batch)
    count("int8 @1024", counters, {"flash_attention": 12 * nb,
                                   "int8_linear_fused": 49 * nb})
    launches["int8_linear_fused"] = 49 * nb
    cpu_q = quantized.make_forward_int8(cfg, _tree_to(qparams, "cpu"),
                                        device="cpu")
    _rel_to_max("int8 @1024 logits of image 0 vs the CPU plain forward",
                gotq[:1], cpu_q(images[:1]).numpy(), INT8_LOGITS_BAND)

    cfg224 = vit.config("vit_b16", dtype="float32")
    p224 = vit.init_params(cfg224, _gen(181), device="cuda")
    qt = quantized.quantize_vit(p224)
    fpt = quantized.make_vit_forward_int8(cfg224, qt)
    img224 = np.random.default_rng(181).integers(0, 256, (64, 224, 224, 3),
                                                 np.uint8)
    fpt(img224)
    torch.cuda.synchronize()
    counters = _zero_counters()
    gotp = fpt(img224).cpu().numpy()
    count("per-tensor int8 @224 b64", counters, {"mha_qkv_pallas": 12,
                                                 "int8_gemm": 50})
    from vit_fpga_tpu_torch.utils.timing import time_cuda
    print(f"  per-tensor int8 @224 b64 forward (uint8 in): "
          f"{time_cuda(lambda: fpt(img224), iters=3, warmup=1):.3f} ms per "
          f"batch")
    cpu_p = quantized.make_vit_forward_int8(cfg224, _tree_to(qt, "cpu"),
                                            device="cpu")(img224).numpy()
    with _plain_per_block():
        floor = fpt(img224).cpu().numpy()
    floor = float(np.abs(floor - cpu_p).max() / np.abs(cpu_p).max())
    print(f"  per-tensor int8 b64: top-1 agree "
          f"{int((gotp.argmax(1) == cpu_p.argmax(1)).sum())}/{len(gotp)} "
          f"with the "
          f"CPU; plain versions on the card vs the CPU {floor:.3e}")
    _rel_to_max("per-tensor int8 b64 logits vs the CPU forward", gotp,
                cpu_p, PER_TENSOR_BAND)

    pallas = vit.make_forward(dataclasses.replace(cfg, attn_impl="pallas"),
                              params)
    counters = _zero_counters()
    gotk7 = pallas(images[:1]).cpu().numpy()
    count("attn_impl='pallas' @1024 b1", counters,
          {"mha_qkv_pallas": 12, "fused_mlp_fwd": 12})
    _rel_to_max("attn_impl='pallas' @1024 logits vs the flash forward's",
                gotk7, got[:1], LOGITS_BAND)

    lcfg = vit.config("vit_l16", dtype="bfloat16", safe_softmax=True,
                      mlp_impl="pallas")
    lfwd = vit.make_forward(lcfg, vit.init_params(lcfg, _gen(182),
                                                  device="cuda"))
    limg = np.random.default_rng(182).integers(0, 256, (8, 224, 224, 3),
                                               np.uint8)
    counters = _zero_counters()
    gotl = lfwd(limg)
    count("ViT-L/16 mlp_impl='pallas' safe_softmax b8", counters,
          {"attn_block_fwd": 24, "fused_mlp_chunked": 24})
    with _plain_per_block():
        plainl = lfwd(limg)
    # 24 layers of K4's and K6's ulp flips: held, as the served forwards'
    # logits are, to the largest logit (the relative norm is printed; on
    # an H100 at 700 W it read 1.77e-2, the 24-layer chains' 1.2-1.6e-2)
    print(f"  ViT-L/16 mlp_impl='pallas' logits: |a-b|/|b| = "
          f"{float((gotl - plainl).norm() / plainl.norm()):.3e} (stated)")
    _rel_to_max("ViT-L/16 mlp_impl='pallas' logits vs the card's plain "
                "forward", gotl.cpu().numpy(), plainl.cpu().numpy(),
                LOGITS_BAND)

    g = _gen(183)
    q, k, v = (_randn(g, 1, 12, 4104, 64).to(torch.bfloat16)
               for _ in range(3))
    counters = _zero_counters()
    o8 = at.mha(q, k, v, n_valid=4097, impl="pallas")
    o9 = at.mha(q, k, v, n_valid=4097, impl="flash")
    count("attention.mha pallas + flash", counters,
          {"mha_pallas": 1, "flash_attention": 1})
    _relnorm("attention.mha flash (bk 512) vs pallas", o9, o8, EMBED_NORM)
    return launches, fwd, fq, images


def phase_per_block_time(fwd, fq, images):
    """ms per batch of the bf16 and dynamic int8 forwards at 1024 px, b1,
    b2 (the serves' batch) and b4, from uint8 images already on the card
    (CUDA events), in turns (each twice, the order reversed the second
    time)."""
    from vit_fpga_tpu_torch.utils.timing import time_cuda
    runs = [(f"{name} @1024 b{b}", f, b) for b in (1, 2, 4)
            for name, f in (("bf16", fwd), ("int8", fq))]
    times = {label: [] for label, _, _ in runs}
    for label, f, b in runs + runs[::-1]:
        img = torch.from_numpy(images[:b]).cuda()
        times[label].append(time_cuda(lambda: f(img), iters=3, warmup=1))
    for label, ms in times.items():
        print(f"forward {label} (uint8 in): "
              + " / ".join(f"{t:.3f}" for t in ms) + " ms per batch")
    return times


def run_per_block_phases(errors, timing, launches):
    """The per-block phases after the earlier slices' ones (K9, K7, K8 and
    K6 parity ran right after the build)."""
    for name, t in phase_per_block_timing().items():
        timing[name] = dict(t, max_abs_err=errors[name])
    served, fwd, fq, images = phase_per_block_serve()
    launches[K14_PER_LINEAR] = served.pop("int8_linear_fused")
    launches.update(served)
    phase_per_block_time(fwd, fq, images)
    print(_smi_line())


# ---------------------------------------------------------------------------
# Phase 16: the gated int8 paths, the int8 stats chain (K21b, K21a) and the
# int8-scores attention (K22)
# ---------------------------------------------------------------------------

CHAIN_KERNELS = ("attn_block_int8_stats", "mlp_block_int8_stats")
SCORES_KERNEL = "attn_block_int8_static_scores"
# Rows that leave the int8 band by one rounding event of their own, each
# bounded by that event.  Such events come at about one row in 1000 (at
# b64 on an H100: K22 11 rows of 12 608, K21b 1), so up to one row in
# FLIP_ROWS may:
# - dynamic (K21a, K21b): the f32 sums' order moves the int8 input row's
#   absmax by an ulp (K21b at b64: ao's, a bf16 ulp), so the whole row is
#   requantized at another scale; 523 of its 768 outputs moved, one by
#   9.3 steps.  Bound: one step on every int8 input of the row,
#   step * sum_k |w_q[k, n]| / 127.
# - K22: pq = rint(e * 127 / sum(e)) meets a step boundary now and then
#   (exp's last ulp, the row sum's order), and one key's probability
#   moves by 1/127.  That moves the head's 64 ao values by v / (127 s_ao)
#   each, several int8 steps of aoq where the calibrated a_v exceeds
#   a_ao.  Bound: the band + max_h wos_n sum_j (max_key |v_q[key, j]|
#   pv_fold + 1) |woq[j, n]| over the head's 64 dims j.
# A wrong kernel moves every row (the mutation copies).
FLIP_ROWS = 100


def _foreign(st):
    """Stats that are not x's own: mu moved by 5% plus 0.02, rstd by 3%
    (a kernel that reduced x itself would disagree by far more than the
    int8 band)."""
    out = st.clone()
    out[..., 0] = st[..., 0] * 1.05 + 0.02
    out[..., 1] = st[..., 1] * 1.03
    return out


def _k21a(fn, x2, st, q, act, emit):
    return fn(x2, st, q["ln_scale"], q["ln_bias"], q["w1_q"], q["w1_s"],
              q["b1"], q["w2_q"], q["w2_s"], q["b2"], eps=EPS, act=act,
              emit_stats=emit)


def _k21b(fn, x, st, q, heads, n_valid, emit):
    return fn(x, st, q["ln_scale"], q["ln_bias"], q["wqkv_q"], q["wqkv_s"],
              q["bqkv"], q["wo_q"], q["wo_s"], q["bo"], heads, eps=EPS,
              n_valid=n_valid, emit_stats=emit)


def _k21a_step(x2, st, q, act):
    """One quantization step of K21a's output: sh_r * 127 * w2s_n."""
    from vit_fpga_tpu_torch.ops import quant_block as qb
    from vit_fpga_tpu_torch.ops.quant_fused import QMAX, _row_quant
    xq, sx = _row_quant(qb._ln_from_stats(x2, st, q["ln_scale"],
                                          q["ln_bias"]))
    h = qb._apply_act(qb._dequant(xq, q["w1_q"], sx, q["w1_s"], q["b1"]), act)
    return _row_quant(h)[1] * QMAX * q["w2_s"]


def _k21b_step(x, st, q, heads, n_valid):
    """One quantization step of K21b's output: sa_r * 127 * wos_n."""
    from vit_fpga_tpu_torch.ops import quant_block as qb
    from vit_fpga_tpu_torch.ops.attn_block import _mha_tpu
    from vit_fpga_tpu_torch.ops.quant_fused import QMAX, _row_quant
    xq, sx = _row_quant(qb._ln_from_stats(x, st, q["ln_scale"],
                                          q["ln_bias"]))
    qkv = qb._dequant(xq, q["wqkv_q"], sx, q["wqkv_s"], q["bqkv"]).to(x.dtype)
    _, sa = _row_quant(_mha_tpu(qkv, heads, n_valid).float())
    return sa * QMAX * q["wo_s"]


def _stats_parity(label, got, got_st, dtype):
    """The emitted stats against the plain stats of the kernel's own bf16
    output: f32 sums in another order (STATS_RTOL, STATS_ATOL), for bf16
    stats then one bf16 rounding (2^-7 relative)."""
    from vit_fpga_tpu_torch.ops.common import row_stats
    if got_st is None or got_st.dtype != dtype:
        raise AssertionError(f"{label}: stats missing or not {dtype}")
    want = row_stats(got, EPS).to(dtype)
    rtol = STATS_RTOL if dtype == torch.float32 else 2.0 ** -7
    _compare(f"{label} stats vs stats of its out", got_st, want, rtol,
             STATS_ATOL)


def _k21b_library(xa, sta, qa, heads, n_valid):
    """K21b's library yardstick on (B, n_pad, D) ``xa`` and its f32 stats:
    the LN from the stats, the row quantization in torch ops,
    torch._int_mm, the dequantization, SDPA with the key mask, the
    out-projection the same way, the next stats in torch ops."""
    import torch.nn.functional as F
    from vit_fpga_tpu_torch.ops import quant_fused as qf
    from vit_fpga_tpu_torch.ops.common import row_stats
    batch, n_pad, d = xa.shape
    rows, dh, bf, rq = batch * n_pad, d // heads, torch.bfloat16, qf._row_quant
    keep = (torch.arange(n_pad, device="cuda") < n_valid)[None, None, None]

    def mm(aq, wq, sa, ws, b):     # (K, N) wq column-major, as _int_mm takes
        return torch._int_mm(aq, wq).float() * (sa * ws) + b

    def run():
        h = (xa.float() - sta[..., :1]) * sta[..., 1:] * qa["ln_scale"] \
            + qa["ln_bias"]
        xq, sx = rq(h.reshape(rows, d))
        qkv = mm(xq, qa["wqkv_q"], sx, qa["wqkv_s"], qa["bqkv"]).to(bf)
        qkv = qkv.view(batch, n_pad, 3, heads, dh)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        ao = F.scaled_dot_product_attention(q, k, v, attn_mask=keep)
        aq, sa = rq(ao.transpose(1, 2).reshape(rows, d).float())
        out = xa.reshape(rows, d) + mm(aq, qa["wo_q"], sa, qa["wo_s"],
                                       qa["bo"]).to(bf)
        return out, row_stats(out, EPS)
    return run


def _k21b_work(batch, n_pad, n_valid, d, heads):
    """K21b's (int8 operations, bf16 attention FLOPs, compulsory bytes):
    K16's, and its f32 stats in and out."""
    ops8, flops, nbytes = _k16_work(batch, n_pad, n_valid, d, heads)
    return ops8, flops, nbytes + 2 * batch * n_pad * 2 * 4


def _requant_bound(step, wq):
    """A requantized row's move: one step on each of its K int8 inputs,
    step * sum_k |wq[k, n]| / 127 (``wq`` the last GEMM's (K, N) weight)."""
    return step * (wq.float().abs().sum(0) / 127.0)


def _chain_case(label, kernel, plain, step, x, wq, rows=(...,)):
    """Kernel vs plain version for both ``emit_stats`` and each stats
    dtype in ``kernel``/``plain`` (callables of (emit, dtype)), in the int8
    band with its |x| term (``_int8_parity``'s ``mag_x``: the foreign
    stats' larger branches meet x in its tails, where an ulp of bf16(y)
    exceeds 2^-6 |b|; K21b at b64: 3.125e-2 at |b| < 1, one element in
    9.8M) and FLIP_ROWS' allowance for a requantized row (``wq``, the
    last GEMM's int8 weight); returns the largest max-abs error."""
    worst = 0.0
    for dtype, emits in ((torch.float32, (True, False)),
                         (torch.bfloat16, (True,))):
        for emit in emits:
            what = f"{label} {str(dtype)[6:]} stats emit={emit}"
            got, got_st = kernel(emit, dtype)
            want, want_st = plain(emit, dtype)
            worst = max(worst, _int8_parity(what, got, want, step, x,
                                            rows=rows, mag_x=True,
                                            row_bound=_requant_bound(step,
                                                                     wq)))
            if emit:
                _stats_parity(what, got, got_st, dtype)
            elif got_st is not None or want_st is not None:
                raise AssertionError(f"{what}: returned stats")
    return worst


def _scores_args(x, q, heads, n_valid, shrink=1.0):
    """K22's arguments from a dynamic int8 dict ``q``: per-tensor a_x (the
    f32 LN of x), a_q, a_k, a_v (the dequantized QKV's thirds) and a_ao (the
    attention output) over the valid rows, each divided by ``shrink``,
    folded as _fold_static_scales folds them.  Returns (args, clipped
    shares of xq, the int8 panel, aoq)."""
    from vit_fpga_tpu_torch.ops import quant_block as qb
    from vit_fpga_tpu_torch.ops.attn_block import _mha_tpu
    d = x.shape[-1]
    xn = qb._ln_f32(x, q["ln_scale"], q["ln_bias"], EPS)
    s_x = _f32(float(xn[:, :n_valid].abs().max()) / 127.0 / shrink)
    qkv = xn @ (q["wqkv_q"].float() * q["wqkv_s"]) + q["bqkv"]
    s3 = [_f32(float(qkv[:, :n_valid, i * d:(i + 1) * d].abs().max())
               / 127.0 / shrink) for i in range(3)]
    ao = _mha_tpu(qkv.to(x.dtype), heads, n_valid).float()[:, :n_valid]
    s_ao = _f32(float(ao.abs().max()) / 127.0 / shrink)
    thirds = torch.cat([torch.full((d,), v, device=x.device) for v in s3])
    a = dict(q, ln_scale=q["ln_scale"] / s_x, ln_bias=q["ln_bias"] / s_x,
             wqkv_qs=q["wqkv_s"] * s_x / thirds, bqkv_qs=q["bqkv"] / thirds,
             wo_s=q["wo_s"] * s_ao, sc_qk=_f32(s3[0] * s3[1]),
             pv_fold=_f32(s3[2] / 127.0 / s_ao))
    return a, (_clipped(xn[:, :n_valid], s_x),
               _clipped(qkv[:, :n_valid], thirds), _clipped(ao, s_ao))


def _k22(fn, x, a, heads, n_valid):
    return fn(x, a["sc_qk"], a["pv_fold"], a["ln_scale"], a["ln_bias"],
              a["wqkv_q"], a["wqkv_qs"], a["bqkv_qs"], a["wo_q"], a["wo_s"],
              a["bo"], heads, eps=EPS, n_valid=n_valid)


def _k22_flip(x, a, heads, n_valid):
    """(B, 1, D): the largest move of one output column that one pq step
    in one head can cause (FLIP_ROWS), from the plain version's int8 v
    panel."""
    from vit_fpga_tpu_torch.ops import quant_block as qb
    b, _, d = x.shape
    xq = qb._rint_i8(qb._ln_f32(x, a["ln_scale"], a["ln_bias"], EPS))
    v = qb._rint_i8(qb._int_matmul(xq, a["wqkv_q"][:, 2 * d:])
                    * a["wqkv_qs"][2 * d:] + a["bqkv_qs"][2 * d:])
    vmax = v[:, :n_valid].float().abs().amax(1).reshape(b, heads, d // heads)
    w = a["wo_q"].float().abs().reshape(heads, d // heads, d)
    move = torch.einsum("bhj,hjn->bhn", vmax * a["pv_fold"] + 1.0, w)
    return (move.amax(1) * a["wo_s"])[:, None, :]


def _k22_library(xa, a, heads, n_valid):
    """K22's library yardstick on (B, n_pad, D) ``xa``: F.layer_norm, the
    rint in torch ops, torch._int_mm for the panel, SDPA with the key mask
    on the bf16 panel at sdq, the out-projection the same way."""
    import torch.nn.functional as F
    from vit_fpga_tpu_torch.ops import quant_block as qb
    batch, n_pad, d = xa.shape
    rows, dh, bf = batch * n_pad, d // heads, torch.bfloat16
    keep = (torch.arange(n_pad, device="cuda") < n_valid)[None, None, None]
    sdq = qb._scores_dequant(a["sc_qk"], dh)
    v_to_ao = a["pv_fold"] * 127.0

    def run():
        h = F.layer_norm(xa.float(), (d,), a["ln_scale"], a["ln_bias"],
                         EPS).reshape(rows, d)
        panel = qb._rint_i8(torch._int_mm(qb._rint_i8(h), a["wqkv_q"])
                            .float() * a["wqkv_qs"] + a["bqkv_qs"])
        qkv = panel.to(bf).view(batch, n_pad, 3, heads, dh)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        ao = F.scaled_dot_product_attention(q, k, v, attn_mask=keep,
                                            scale=sdq)
        ao = ao.transpose(1, 2).reshape(rows, d).float() * v_to_ao
        y = torch._int_mm(qb._rint_i8(ao), a["wo_q"]).float() \
            * a["wo_s"] + a["bo"]
        return xa.reshape(rows, d) + y.to(bf)
    return run


def _k22_work(batch, n_pad, n_valid, d, heads):
    """K22's (int8 operations, bf16 FLOPs, compulsory bytes): the QKV and
    out-projection products and the int8 attention, x in and out, the
    int8 weights, the f32 vectors."""
    rows = batch * n_pad
    return (8 * rows * d * d + 4 * batch * heads * n_pad * n_valid
            * (d // heads), 0,
            2 * rows * d * 2 + 4 * d * d + (2 * d + 6 * d + 2 * d) * 4)


def _k22_parity(label, x, a, heads, n_valid, rows, got=None):
    """K22 (``got``, or a fresh launch) vs its plain version: the static
    int8 band (|x|, 2 steps of 127 wos), one row in FLIP_ROWS allowed one
    pq flip more (``_k22_flip``), then the branch in norm."""
    from vit_fpga_tpu_torch.ops import quant_block as qb
    if got is None:
        got = _k22(qb.attn_block_int8_static_scores, x, a, heads, n_valid)
    return _int8_parity(
        label, got, _k22(qb.attn_block_int8_static_scores_plain, x, a, heads,
                         n_valid), (127.0 * a["wo_s"]).expand_as(x), x,
        rows=rows, mag_x=True, row_bound=_k22_flip(x, a, heads, n_valid))


def phase_chain_kernels(batch, n_pad=200, n_valid=197, d=768, heads=12,
                        m=3072):
    """K21b, K21a and K22 against their plain versions at the path's
    shapes for ``batch``: K21b and K21a on stats that are not x's own, f32
    (both emit_stats) and bf16, the emitted stats against the stats of the
    kernel's own output, K21a with every activation at b8; K22 calibrated
    on its input (quiet) and on half its range (saturating: the clipped
    shares are printed and must be > 0); at b8 K21b and K22 with 59 loud
    padding rows that must leave the valid rows (and K21b's stats there)
    bit for bit.  Returns {kernel name: largest max-abs error}."""
    from vit_fpga_tpu_torch.ops import quant_block as qb
    from vit_fpga_tpu_torch.ops.common import row_stats
    worst = {}
    valid = (slice(None), slice(0, n_valid))
    x, st, p = _attn_inputs(batch, n_pad, d, seed=150 + batch)
    q = _int8_weights(p, ("wqkv", "wo"))
    fs = _foreign(st)
    print(f"parity K21b attn_block_int8_stats ({batch}, {n_pad}, {d}), "
          f"{heads} heads, n_valid={n_valid}, foreign stats")
    worst["attn_block_int8_stats"] = _chain_case(
        f"K21b b{batch}",
        lambda e, dt: _k21b(qb.attn_block_int8_stats, x, fs.to(dt), q,
                            heads, n_valid, e),
        lambda e, dt: _k21b(qb.attn_block_int8_stats_plain, x, fs.to(dt), q,
                            heads, n_valid, e),
        _k21b_step(x, fs, q, heads, n_valid), x, q["wo_q"], rows=valid)

    rows = batch * n_pad
    x2, st2, p = _mlp_inputs(rows, d, m, seed=151 + batch)
    qm = _int8_weights(p, ("w1", "w2"))
    fs2 = _foreign(st2)
    worst["mlp_block_int8_stats"] = 0.0
    for act in MLP_ACTS if batch <= 8 else ("gelu_tanh",):
        print(f"parity K21a mlp_block_int8_stats ({rows}, {d}) x {m} {act}, "
              f"foreign stats")
        worst["mlp_block_int8_stats"] = max(
            worst["mlp_block_int8_stats"], _chain_case(
                f"K21a b{batch} {act}",
                lambda e, dt: _k21a(qb.mlp_block_int8_stats, x2, fs2.to(dt),
                                    qm, act, e),
                lambda e, dt: _k21a(qb.mlp_block_int8_stats_plain, x2,
                                    fs2.to(dt), qm, act, e),
                _k21a_step(x2, fs2, qm, act), x2, qm["w2_q"]))

    worst[SCORES_KERNEL] = 0.0
    for label, shrink in (("quiet", 1.0), ("saturating", SHRINK)):
        a, clipped = _scores_args(x, q, heads, n_valid, shrink)
        print(f"parity K22 attn_block_int8_static_scores ({batch}, {n_pad}, "
              f"{d}) {label}: clipped share xq {clipped[0]:.3e}, qkv8 "
              f"{clipped[1]:.3e}, aoq {clipped[2]:.3e}")
        if shrink > 1.0 and not min(clipped) > 0.0:
            raise AssertionError("K22 saturating case: nothing clipped")
        worst[SCORES_KERNEL] = max(worst[SCORES_KERNEL], _k22_parity(
            f"K22 b{batch} {label}", x, a, heads, n_valid, valid))
    if batch > 8:
        return worst

    xl, _, pl = _attn_inputs(batch, 256, d, seed=160)
    ql = _int8_weights(pl, ("wqkv", "wo"))
    loud = xl.clone()
    loud[:, n_valid:] = 0.0
    loud[:, n_valid:, 3] = 3e3
    loud[:, n_valid:, 100] = -1e3
    st_q, st_l = row_stats(xl, EPS), row_stats(loud, EPS)
    print(f"K21b / K22 loud padding ({batch}, 256, {d}): spikes in rows "
          f"{n_valid}..255")
    quiet, sq = _k21b(qb.attn_block_int8_stats, xl, st_q, ql, heads, n_valid,
                      True)
    noisy, sn = _k21b(qb.attn_block_int8_stats, loud, st_l, ql, heads,
                      n_valid, True)
    worst["attn_block_int8_stats"] = max(
        worst["attn_block_int8_stats"], _int8_parity(
            "K21b loud padding", noisy,
            _k21b(qb.attn_block_int8_stats_plain, loud, st_l, ql, heads,
                  n_valid, True)[0],
            _k21b_step(loud, st_l, ql, heads, n_valid), loud, rows=valid,
            mag_x=True, row_bound=_requant_bound(
                _k21b_step(loud, st_l, ql, heads, n_valid), ql["wo_q"])))
    a, _ = _scores_args(xl, ql, heads, n_valid)
    quiet22 = _k22(qb.attn_block_int8_static_scores, xl, a, heads, n_valid)
    noisy22 = _k22(qb.attn_block_int8_static_scores, loud, a, heads, n_valid)
    worst[SCORES_KERNEL] = max(worst[SCORES_KERNEL], _k22_parity(
        "K22 loud padding", loud, a, heads, n_valid, valid, got=noisy22))
    for what, g, w in (("K21b out", noisy, quiet), ("K21b stats", sn, sq),
                       ("K22 out", noisy22, quiet22)):
        moved = float((g[valid].float() - w[valid].float()).abs().max())
        print(f"  {what} valid rows, loud vs quiet padding: "
              f"max_abs={moved:.3e} (must be 0)")
        if moved != 0.0:
            raise AssertionError(f"{what}: padding rows moved the valid rows")
    return worst


def _k21a_edges():
    """K21a (K15's launches from the producer's stats) at the edges of
    K15's design, on foreign stats, f32 (both emit_stats) and bf16, in the
    int8 band: T 1601 (ragged 128-row tiles) and (600, 400) x 1552 (a
    partial last column tile of W1) with every row's absmax of h in that
    tile.  Returns the max-abs error."""
    from vit_fpga_tpu_torch.ops import quant_block as qb
    print("K21a edges: ragged rows, a partial column tile holding the "
          "absmax")
    worst = 0.0
    for label, t, d, m, seed, edit in (
            ("T 1601", 1601, 768, 3072, 213, None),
            ("(600, 400) x 1552, absmax in the last column tile", 600, 400,
             1552, 214, _k15_last_tile)):
        x2, st2, p = _mlp_inputs(t, d, m, seed)
        if edit is not None:
            edit(x2, p)
        q = _int8_weights(p, ("w1", "w2"))
        fs = _foreign(st2)
        worst = max(worst, _chain_case(
            f"K21a {label}",
            lambda e, dt: _k21a(qb.mlp_block_int8_stats, x2, fs.to(dt), q,
                                "gelu_tanh", e),
            lambda e, dt: _k21a(qb.mlp_block_int8_stats_plain, x2, fs.to(dt),
                                q, "gelu_tanh", e),
            _k21a_step(x2, fs, q, "gelu_tanh"), x2, q["w2_q"]))
    return worst


def phase_chain_timing(batch=64, n_pad=200, n_valid=197, d=768, heads=12,
                       m=3072):
    """K21b, K21a and K22 at the b64 path shapes: the kernel's time, its
    plain version's, a library yardstick's (LN from the stats or
    F.layer_norm, the torch quant and dequant ops, torch._int_mm, SDPA
    for the attention halves, the next stats in torch ops) and the bound.
    Returns {name: dict of times}."""
    import torch.nn.functional as F
    from vit_fpga_tpu_torch.ops import quant_block as qb
    from vit_fpga_tpu_torch.ops import quant_fused as qf
    from vit_fpga_tpu_torch.ops.common import row_stats
    from vit_fpga_tpu_torch.utils.timing import time_cuda
    rows, bf, vec = batch * n_pad, torch.bfloat16, 4
    rq = qf._row_quant
    xa, sta, pa = _attn_inputs(batch, n_pad, d, seed=170)
    qa = _int8_weights(pa, ("wqkv", "wo"))
    x2, st2, pm = _mlp_inputs(rows, d, m, seed=171)
    qm = _int8_weights(pm, ("w1", "w2"))
    a22, _ = _scores_args(xa, qa, heads, n_valid)

    def mm(aq, wq, sa, ws, b):     # (K, N) wq column-major, as _int_mm takes
        return torch._int_mm(aq, wq).float() * (sa * ws) + b

    def lib_k21a():
        h = (x2.float() - st2[:, :1]) * st2[:, 1:] * qm["ln_scale"] \
            + qm["ln_bias"]
        xq, sx = rq(h)
        h = F.gelu(mm(xq, qm["w1_q"], sx, qm["w1_s"], qm["b1"]),
                   approximate="tanh")
        hq, sh = rq(h)
        out = x2 + mm(hq, qm["w2_q"], sh, qm["w2_s"], qm["b2"]).to(bf)
        return out, row_stats(out, EPS)

    stats_bytes = 2 * rows * 2 * 4          # the stats in and out, f32
    cases = {
        "attn_block_int8_stats": (
            lambda: _k21b(qb.attn_block_int8_stats, xa, sta, qa, heads,
                          n_valid, True),
            lambda: _k21b(qb.attn_block_int8_stats_plain, xa, sta, qa,
                          heads, n_valid, True),
            _k21b_library(xa, sta, qa, heads, n_valid),
            *_k21b_work(batch, n_pad, n_valid, d, heads)),
        "mlp_block_int8_stats": (
            lambda: _k21a(qb.mlp_block_int8_stats, x2, st2, qm, "gelu_tanh",
                          True),
            lambda: _k21a(qb.mlp_block_int8_stats_plain, x2, st2, qm,
                          "gelu_tanh", True),
            lib_k21a, 4 * rows * d * m, 0,
            2 * rows * d * 2 + stats_bytes + 2 * d * m
            + (4 * d + 2 * m) * vec),
        SCORES_KERNEL: (
            lambda: _k22(qb.attn_block_int8_static_scores, xa, a22, heads,
                         n_valid),
            lambda: _k22(qb.attn_block_int8_static_scores_plain, xa, a22,
                         heads, n_valid),
            _k22_library(xa, a22, heads, n_valid),
            *_k22_work(batch, n_pad, n_valid, d, heads)),
    }
    out = {}
    for name, (kern, plain, lib, ops8, flops, nbytes) in cases.items():
        ms = time_cuda(kern)
        plain_ms = time_cuda(plain, iters=5, warmup=1)
        lib_ms = _library_ms(lib, name)
        bound_ms, bound_by = _bound_int8(ops8, flops, nbytes)
        out[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=bound_ms, bound_by=bound_by)
        print(f"timing {name} b{batch}: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, library {lib_ms} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}, {ops8 / 1e9:.2f} G int8 ops "
              f"+ {flops / 1e9:.2f} GFLOP bf16, {nbytes / 1e6:.2f} MB)")
        out[name].update(_device_alone_pair(name, kern, lib,
                                            lib_ms is not None))
    return out


def run_chain_phases(errors, timing, launches):
    """Phase 16 after the earlier slices' phases (its b8 parity ran right
    after the build): b64 parity and times, 160 requests through each
    gated path with its switch on (the int8 stats chain on the dynamic
    tree: 12 K21b + 12 K21a + 1 K14 per batch; the int8-scores attention
    on the static tree: 12 K22 + 12 K17 + 1 K14), and the switch-on and
    switch-off b64 forwards timed in turns."""
    for name, err in phase_chain_kernels(64).items():
        errors[name] = max(errors[name], err)
    for name, t in phase_chain_timing().items():
        timing[name] = dict(t, max_abs_err=errors[name])
    chain_launches, fwd_chain, _, cfg, fwd_int8 = phase_int8_slice(
        mode="chain")
    launches.update({k: v for k, v in chain_launches.items()
                     if k in CHAIN_KERNELS})
    scores_launches, fwd_scores, _, _, fwd_static = phase_int8_slice(
        mode="scores")
    launches[SCORES_KERNEL] = scores_launches[SCORES_KERNEL]
    phase_int8_forward_time({"int8": fwd_int8, "int8 chain": fwd_chain,
                             "int8 static": fwd_static,
                             "int8 scores": fwd_scores}, cfg)
    print(_smi_line())


# ---------------------------------------------------------------------------
# Phase 17: the odd-batch serves past 256 keys (K4 in both softmax modes), and the last two TPU kernels, K10 (the uint8 patch embed)
# and K26 (the streamed GEMM)
# ---------------------------------------------------------------------------

OP_KERNELS = ("patch_embed_pallas", "streamed_gemm")
# K10 and K26 in f32 against their plain versions: the same f32 products
# summed in another order.  Each order's error of a K-term sum stays within
# about sqrt(K) 2^-24 sum_k |terms| (random rounding's bound).  With folded
# embed weights the bias cancels the mean pixel's term, so the partial sums
# run far above |out|, and 1e-5 (1 + |want|) alone is too tight there (a
# CPU rehearsal of two f32 orders at ViT-B/16's folded weights read 9.7e-6
# of it at 2000 rows).  Band: 1e-5 (1 + |want|) + 2 sqrt(K) 2^-24 sum
# |terms|.  A bf16 output is one of those f32 sums rounded once: one bf16
# ulp of the larger of the two (<= 2^-7 of it) on top.  A wrong kernel (a
# term dropped or misplaced, a channel swapped) moves an element by a whole
# term, ~1e-1.
F32_SUM_ATOL = 1e-5
# K4 past 256 keys with q and k 4x larger: scores 16x wider, up to ~200,
# past exp's f32 range, which only the exact softmax's max takes.  Held as
# a branch in relative norm (BRANCH_TOL), as K1's peaked case: so peaked a
# softmax turns a score's f32 rounding into a bf16 ulp of e now and then.
# A max taken over part of the keys overflows exp there.
K4_WIDE = 4.0
# K4 past 256 keys at the odd-batch serves' shapes: (label, batch, n_pad,
# n_valid, d, heads, softmax modes (safe?))
K4_LONG_CASES = (
    ("CLIP ViT-L/14 b1", 1, 264, 257, 1024, 16, (False,)),
    ("ViT-B/16 @384 b1", 1, 584, 577, 768, 12, (False,)),
    ("ViT-L/16 @384 b1", 1, 584, 577, 1024, 16, (True, False)),
)
# K10 cases: (label, batch, H, W, patch, D, out dtype, fold scales or None
# for the JAX test's unfolded weights)
IMAGENET_SCALES = ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225))
K10_CASES = (
    ("ViT-B/16 b64", 64, 224, 224, 16, 768, torch.bfloat16, IMAGENET_SCALES),
    ("CLIP ViT-L/14 b64", 64, 224, 224, 14, 1024, torch.bfloat16,
     "clip"),
    ("CLIP ViT-L/14 b64 f32", 64, 224, 224, 14, 1024, torch.float32,
     "clip"),
    ("JAX test", 2, 32, 64, 8, 128, torch.float32, None),
)
# K26 cases: (label, T, K, N, dtype, bk, bt, bn)
K26_CASES = (
    ("JAX test f32", 64, 300, 128, torch.float32, 128, None, None),
    ("f32", 256, 1024, 512, torch.float32, 256, None, None),
    ("ViT-L/16 @384 b1 MLP up", 584, 1024, 4096, torch.bfloat16, 512, 584,
     1024),
    # the wgmma GEMM's edges: a partial 128-row tile (T 200), a K tail of
    # 8 past a 64-deep step (K 520), N 72 past a 256-wide tile (N 328)
    ("bf16 tile edges", 200, 520, 328, torch.bfloat16, 128, None, None),
)


def _sum_band(name, got, want, k, mag, bf16):
    """got vs want within the f32 sum-order band (bf16: plus one bf16 ulp
    of the larger); ``mag`` is sum_k |terms| per element.  Prints the
    largest |a-b| / (1 + |b|) beside it.  Returns the max-abs error."""
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    band = F32_SUM_ATOL * (1 + w.abs()) + 2 * k ** 0.5 * 2.0 ** -24 * mag
    if bf16:
        band = band + 2.0 ** -7 * torch.maximum(g.abs(), w.abs())
    bad = int((diff > band).sum())
    max_abs = float(diff.max())
    ulp = " + 2^-7 max(|a|,|b|)" if bf16 else ""
    print(f"  {name}: max_abs={max_abs:.3e} max |a-b|/(1+|b|)="
          f"{float((diff / (1 + w.abs())).max()):.3e} (band 1e-5 (1+|b|) + "
          f"2 sqrt({k}) 2^-24 sum|terms|{ulp}, violations={bad})")
    if bad or not torch.isfinite(g).all():
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version")
    return max_abs


def _k10_inputs(batch, h, w, patch, d, seed, scales):
    """uint8 images on the card and a folded f32 (P*P*3, D) kernel and
    bias: ViT-style weights (N(0, 1/K), bias N(0, 0.02^2)) folded with the
    (mean, std) ``scales`` ("clip": CLIP's), or with None the JAX test's
    kernel N(0, 0.01^2) and bias N(0, 1)."""
    from vit_fpga_tpu_torch.models.vit import CLIP_MEAN, CLIP_STD
    from vit_fpga_tpu_torch.ops import patch_embed as pe
    rng = np.random.default_rng(seed)
    k = patch * patch * 3
    images = torch.from_numpy(rng.integers(0, 256, (batch, h, w, 3),
                                           np.uint8)).cuda()
    if scales is None:
        kf = (rng.normal(size=(k, d)) * 0.01).astype(np.float32)
        bf = rng.normal(size=(d,)).astype(np.float32)
    else:
        if scales == "clip":
            scales = (CLIP_MEAN, CLIP_STD)
        kernel = (rng.normal(size=(k, d)) * k ** -0.5).astype(np.float32)
        bias = (rng.normal(size=(d,)) * 0.02).astype(np.float32)
        kf, bf = pe.fold_preprocess(kernel, bias, *scales, patch)
    return images, torch.from_numpy(kf).cuda(), torch.from_numpy(bf).cuda()


def _k10_mag(images, kf, bf, patch):
    """sum_k |pixel_k kernel_kn| + |bias_n| per output element."""
    from vit_fpga_tpu_torch.models.vit import patchify
    return patchify(images.float(), patch) @ kf.abs() + bf.abs()


def _k26_inputs(t, k, n, dtype, seed):
    g = _gen(seed)
    return (_randn(g, t, k).to(dtype), _randn(g, k, n).to(dtype))


def _check_long(label, got, want):
    """K4's launches past 256 keys (``attn_block_fwd.launches_long``) at their
    wanted count."""
    if got != want:
        raise AssertionError(f"{label}: {got} K4 launches counted past 256 "
                             f"keys, want {want}")


def _k4_long_parity(label, batch, n_pad, n_valid, d, heads, modes, seed):
    """K4 past 256 keys against its plain version in each softmax mode:
    every row elementwise (BF16_TOL) and as a branch, the launch counted
    past 256 keys (launches_long), loud padding rows (a 3e3 spike in each) that
    must leave the valid rows bit for bit, and in the exact mode the wide
    scores case.  Returns the largest max-abs error."""
    from vit_fpga_tpu_torch.ops import attn_block as ab
    x, _, pa = _attn_inputs(batch, n_pad, d, seed)
    loud = x.clone()
    loud[:, n_valid:, 3] = 3e3
    worst = 0.0
    for safe in modes:
        name = f"K4 {label} ({batch}, {n_pad}, {d}) n_valid={n_valid} " \
               f"safe_softmax={safe}"
        print(f"parity {name}, {heads} heads")
        before = ab.attn_block_fwd.launches_long
        got = _k4(ab.attn_block_fwd, x, pa, heads, n_valid, safe)
        want = _k4(ab.attn_block_fwd_plain, x, pa, heads, n_valid, safe)
        torch.cuda.synchronize()
        _check_long(name, ab.attn_block_fwd.launches_long, before + 1)
        worst = max(worst, _compare(f"{name} out", got, want, BF16_TOL,
                                    BF16_TOL))
        _branch(f"{name} branch", got, want, x)
        noisy = _k4(ab.attn_block_fwd, loud, pa, heads, n_valid, safe)
        torch.cuda.synchronize()
        moved = float((noisy[:, :n_valid].float()
                       - got[:, :n_valid].float()).abs().max())
        print(f"  {name} loud padding rows {n_valid}..{n_pad - 1}: valid "
              f"rows moved by max_abs={moved:.3e} (must be 0)")
        if moved != 0.0 or not torch.isfinite(noisy[:, :n_valid]).all():
            raise AssertionError(f"{name}: padding rows moved the valid rows")
        if safe:
            wide = dict(pa, wqkv=pa["wqkv"].clone())
            wide["wqkv"][:, :2 * d] *= K4_WIDE
            qkv = ((x.float() - x.float().mean(-1, keepdim=True))
                   @ wide["wqkv"][:, :2 * d])
            s = qkv[0, :, :64] @ qkv[0, :n_valid, d:d + 64].T / 8.0
            got = _k4(ab.attn_block_fwd, x, wide, heads, n_valid, True)
            want = _k4(ab.attn_block_fwd_plain, x, wide, heads, n_valid,
                       True)
            torch.cuda.synchronize()
            print(f"  {name} wide scores (q, k x{K4_WIDE:g}; head 0's "
                  f"scores reach about {float(s.abs().max()):.0f}): "
                  f"max_abs={float((got.float() - want.float()).abs().max()):.3e}"
                  f" (stated)")
            if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
                raise AssertionError(f"{name} wide scores: not finite")
            _branch(f"{name} wide scores branch", got, want, x)
    return worst


def phase_odd_kernels():
    """Right after the build: K4 past 256 keys at the odd-batch serves'
    shapes in both softmax modes, K10 and K26 at their shapes, each against
    its plain version; K4 at (1, 1032, 128) with 1032 valid in both modes
    (a gate check before K4 took the JAX gate; phase 25 checks the new
    gate).  K10's and K26's launches here are their count in the JSON
    line: no serving path launches them.  Returns ({kernel: max-abs
    error}, {kernel: launches})."""
    from vit_fpga_tpu_torch.ops import patch_embed as pe
    from vit_fpga_tpu_torch.ops import streamed_gemm as sg
    torch.backends.cuda.matmul.allow_tf32 = False
    k4 = max(_k4_long_parity(*case, seed=190 + i)
             for i, case in enumerate(K4_LONG_CASES + (
                 ("1032 tokens", 1, 1032, 1032, 128, 2, (True, False)),)))

    pe.patch_embed_pallas.launches = 0
    sg.streamed_gemm.launches = 0
    k10 = 0.0
    for i, (label, b, h, w, p, d, dt, scales) in enumerate(K10_CASES):
        images, kf, bf = _k10_inputs(b, h, w, p, d, 200 + i, scales)
        got = pe.patch_embed_pallas(images, kf, bf, p, out_dtype=dt)
        want = pe.patch_embed_plain(images, kf, bf, p, out_dtype=dt)
        torch.cuda.synchronize()
        k10 = max(k10, _sum_band(
            f"K10 {label} {tuple(images.shape)} P{p} D{d} {dt}", got, want,
            p * p * 3, _k10_mag(images, kf, bf, p).reshape(got.shape),
            dt == torch.bfloat16))
    k26 = 0.0
    for i, (label, t, k, n, dt, bk, bt, bn) in enumerate(K26_CASES):
        xs, ws = _k26_inputs(t, k, n, dt, 210 + i)
        got = sg.streamed_gemm(xs, ws, bk=bk, bt=bt, bn=bn)
        want = sg.streamed_gemm_plain(xs, ws, bk=bk, bt=bt, bn=bn)
        torch.cuda.synchronize()
        k26 = max(k26, _sum_band(
            f"K26 {label} ({t}, {k}) x ({k}, {n}) {dt} bk={bk}", got, want,
            k, xs.float().abs() @ ws.float().abs(), dt == torch.bfloat16))
    launches = {"patch_embed_pallas": pe.patch_embed_pallas.launches,
                "streamed_gemm": sg.streamed_gemm.launches}
    print(f"  K10 / K26 launches in this phase: {launches}")
    return ({"attn_block_fwd_long": k4, "patch_embed_pallas": k10,
             "streamed_gemm": k26}, launches)


def _time_k4_long(label, batch, n_pad, n_valid, d, heads, safe, seed,
                  alone=False):
    """K4 past 256 keys: kernel, plain version, the library yardstick (LN
    + addmm + masked scaled_dot_product_attention + addmm, bf16) and the
    bound (the function's operations: one QK^T, whatever the exact mode's
    second sweep costs the kernel); with ``alone`` also each call's device
    time alone."""
    from vit_fpga_tpu_torch.ops import attn_block as ab
    from vit_fpga_tpu_torch.utils.timing import time_cuda
    x, _, pa = _attn_inputs(batch, n_pad, d, seed)
    pa = _bf16_weights(pa, ("wqkv", "wo"))
    rows, dh = batch * n_pad, d // heads
    ms = time_cuda(lambda: _k4(ab.attn_block_fwd, x, pa, heads, n_valid,
                               safe))
    plain_ms = time_cuda(lambda: _k4(ab.attn_block_fwd_plain, x, pa, heads,
                                     n_valid, safe), iters=3, warmup=1)
    lib_ms = time_cuda(_attn_library(x, pa, heads, n_valid))
    flops = 2 * rows * d * 4 * d + 4 * batch * heads * n_pad * n_valid * dh
    nbytes = 2 * rows * d * 2 + 4 * d * d * 2 + 6 * d * 4
    bound_ms, bound_by = _bound(flops, nbytes)
    print(f"timing K4 {label} ({batch}, {n_pad}, {d}) n_valid={n_valid} "
          f"safe_softmax={safe}: kernel {ms:.4f} ms, plain {plain_ms:.4f} "
          f"ms, library {lib_ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"({bound_by})")
    t = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
             bound_ms=bound_ms, bound_by=bound_by)
    if alone:
        t.update(_alone_pair(
            f"K4 {label} safe_softmax={safe}",
            lambda: _k4(ab.attn_block_fwd, x, pa, heads, n_valid, safe),
            _attn_library(x, pa, heads, n_valid)))
    return t


def phase_odd_timing():
    """K4 past 256 keys at the serves' shapes (the JSON line carries CLIP
    ViT-L/14 b1's), K10 at ViT-B/16 b64 bf16 beside the main path's own
    embed (preprocess + embed_tokens_dotg) and CLIP ViT-L/14's, K26 at the
    ViT-L/16 @384 b1 MLP up-projection in bf16 (in the JSON line) and in
    f32: each kernel beside its plain version, the library call (K10:
    torch.matmul of the patchified f32 image, TF32 off, + bias; K26:
    torch.matmul) and the bound."""
    from vit_fpga_tpu_torch.models import vit
    from vit_fpga_tpu_torch.ops import patch_embed as pe
    from vit_fpga_tpu_torch.ops import streamed_gemm as sg
    from vit_fpga_tpu_torch.utils.timing import time_cuda
    out = {}
    for i, (label, b, n_pad, n_valid, d, heads, modes) in enumerate(
            K4_LONG_CASES):
        for safe in modes:
            t = _time_k4_long(label, b, n_pad, n_valid, d, heads, safe,
                              220 + i)
            out.setdefault("attn_block_fwd_long", t)

    torch.backends.cuda.matmul.allow_tf32 = False
    for i, (label, b, h, w, p, d, dt, scales) in enumerate(K10_CASES[:3]):
        images, kf, bf = _k10_inputs(b, h, w, p, d, 230 + i, scales)
        ms = time_cuda(lambda: pe.patch_embed_pallas(images, kf, bf, p,
                                                     out_dtype=dt))
        plain_ms = time_cuda(lambda: pe.patch_embed_plain(
            images, kf, bf, p, out_dtype=dt), iters=5, warmup=1)
        lib_ms = time_cuda(lambda: (vit.patchify(images.float(), p) @ kf
                                    + bf).to(dt))
        rows, k = b * (h // p) * (w // p), p * p * 3
        flops = 2 * rows * k * d
        nbytes = images.numel() + 4 * (k * d + d) + rows * d * dt.itemsize
        # the bound of K10's work, three bf16 products a weight on the
        # tensor cores; beside it the f32 bound of the CUDA cores
        bound_ms, bound_by = _bound(3 * flops, nbytes)
        f32_ms, _ = _bound_f32(flops, nbytes)
        dev_ms = _device_alone_ms(
            lambda: pe.patch_embed_pallas(images, kf, bf, p, out_dtype=dt),
            iters=20)
        lib_dev = _device_alone_ms(lambda: (vit.patchify(images.float(), p)
                                            @ kf + bf).to(dt), iters=20)
        print(f"timing K10 {label} P{p} D{d} {dt}: kernel {ms:.4f} ms per "
              f"call (the wrapper reads the split's count back), "
              f"{dev_ms:.4f} ms device alone ({flops / dev_ms / 1e9:.1f} "
              f"TFLOP/s of f32 products), plain {plain_ms:.4f} ms, library "
              f"{lib_ms:.4f} ms per call, {lib_dev:.4f} ms device alone, "
              f"bound {bound_ms:.4f} ms ({bound_by}, 3 x {flops / 1e9:.1f} "
              f"GFLOP bf16 at 989 TFLOP/s; f32 at 67 TFLOP/s: {f32_ms:.4f} "
              f"ms)")
        out.setdefault("patch_embed_pallas", dict(
            ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
            bound_by=bound_by, device_ms=dev_ms))
        if i == 0:
            cfg = vit.config("vit_b16", image_size=h, dtype="bfloat16")
            kb = kf.to(torch.bfloat16)
            posb = torch.zeros((vit._n_pad(cfg), d), device="cuda")
            pre = vit.preprocess(images, cfg)
            emb = time_cuda(lambda: pe.embed_tokens_dotg(pre, kb, posb, p, 1))
            both = time_cuda(lambda: pe.embed_tokens_dotg(
                vit.preprocess(images, cfg), kb, posb, p, 1))
            print(f"  the main path's embed at the same shape: "
                  f"embed_tokens_dotg {emb:.4f} ms, preprocess + "
                  f"embed_tokens_dotg from uint8 {both:.4f} ms")

    # the JSON line's K26 case first (ViT-L/16 @384's bf16 MLP up), then f32
    for i, (label, t, k, n, dt, bk, bt, bn) in enumerate(K26_CASES[2::-1]):
        xs, ws = _k26_inputs(t, k, n, dt, 240 + i)
        ms = time_cuda(lambda: sg.streamed_gemm(xs, ws, bk=bk, bt=bt, bn=bn))
        plain_ms = time_cuda(lambda: sg.streamed_gemm_plain(
            xs, ws, bk=bk, bt=bt, bn=bn), iters=5, warmup=1)
        lib_ms = time_cuda(lambda: torch.matmul(xs, ws))
        # the device alone over 200 back-to-back calls: per call, the
        # wrapper's host work (two tensor maps encoded for bf16) rivals
        # the kernel at this size
        dev_ms = _device_alone_ms(lambda: sg.streamed_gemm(
            xs, ws, bk=bk, bt=bt, bn=bn), iters=200)
        lib_dev_ms = _device_alone_ms(lambda: torch.matmul(xs, ws),
                                      iters=200)
        flops = 2 * t * k * n
        nbytes = (t * k + k * n + t * n) * dt.itemsize
        bound_ms, bound_by = (_bound if dt == torch.bfloat16
                              else _bound_f32)(flops, nbytes)
        print(f"timing K26 {label} ({t}, {k}) x ({k}, {n}) {dt}: kernel "
              f"{ms:.4f} ms per call ({flops / ms / 1e9:.1f} TFLOP/s), "
              f"{dev_ms:.4f} ms device alone; plain {plain_ms:.4f} ms, "
              f"library {lib_ms:.4f} ms per call, {lib_dev_ms:.4f} ms device "
              f"alone; bound {bound_ms:.4f} ms ({bound_by})")
        out.setdefault("streamed_gemm", dict(
            ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
            bound_by=bound_by))
    return out


def _odd_serve(label, fwd, images, want):
    """ImageServer(batch_size=1) over ``fwd`` answers ``images`` with the
    counts set to 0 just before it: exactly ``want`` launches a request
    (all K4 ones past 256 keys) and nothing else.  Returns the outputs and
    K4's launches past 256 keys."""
    from vit_fpga_tpu_torch.ops import attn_block as ab
    fwd(images[:1])
    torch.cuda.synchronize()
    counters = _zero_counters()
    got, nb = _serve(label, fwd, images, 1)
    if nb != len(images):
        raise AssertionError(f"{label}: {nb} batches for {len(images)} "
                             f"requests at batch_size 1")
    per = {k: v * nb for k, v in want.items()}
    launches = _check_launches(label, counters, per)
    long = ab.attn_block_fwd.launches_long
    print(f"  {label} launches: { {k: v for k, v in launches.items() if v} }"
          f", {long} of K4's past 256 keys")
    _check_long(label, long, per["attn_block_fwd"])
    return got, long


def _per_request_ms(label, runs):
    """ms per request of each (name, forward, uint8 images on the card),
    in turns (each twice, the order reversed the second time).  Run
    before any CPU forward of the phase, whose worker threads would share
    the host that launches the card's work."""
    from vit_fpga_tpu_torch.utils.timing import time_cuda
    times = {name: [] for name, _, _ in runs}
    for name, fwd, img in runs + runs[::-1]:
        times[name].append(time_cuda(lambda: fwd(img), iters=3, warmup=1)
                           / img.shape[0])
    print(f"  {label} ms per request: " + ", ".join(
        f"{name} " + " / ".join(f"{t:.3f}" for t in ms)
        for name, ms in times.items()))
    return times


def phase_odd_batch_serve(n_requests=3):
    """The odd-batch main paths, each run with the counts set to 0 just
    before it: ImageServer(batch_size=1) over clip.make_forward(CLIP
    ViT-L/14 @224, depth 24) answers 3 uint8 requests with 24 K4 launches
    a request (past 256 keys, max-free) and nothing else of the port, and over
    vit.make_forward(ViT-B/16 @384) with 12 K4 + 12 K5;
    make_forward(ViT-L/16 @384, safe_softmax) at b1 launches 24 K4
    (past 256 keys, exact).  Each one's ms per request beside the same model
    at b2 through the chain (24 K1 + 24 K3 / 12 K1 + 12 K2), the safe
    forward beside the max-free one (the chain at b1); then every output
    against the CPU forward.  Returns K4's launches past 256 keys."""
    from vit_fpga_tpu_torch.models import clip, vit
    from vit_fpga_tpu_torch.ops import attn_block as ab
    rng = np.random.default_rng(250)
    long = 0
    checks = []        # (label, card outputs, CPU forward, images)

    ccfg = clip.clip_vision_config("vit_l14", dtype="bfloat16")
    cparams = clip.init_params(ccfg, 768, _gen(250), device="cuda")
    cfwd = clip.make_forward(ccfg, cparams)
    cimg = rng.integers(0, 256, (n_requests, 224, 224, 3), np.uint8)
    label = "CLIP ViT-L/14 @224 ImageServer(batch_size=1)"
    got, n = _odd_serve(label, cfwd, cimg, {"attn_block_fwd": 24})
    long += n
    checks.append((label, got, clip.make_forward(
        ccfg, _tree_to(cparams, "cpu"), device="cpu"), cimg))
    counters = _zero_counters()
    cfwd(cimg[:2])
    _check_only("CLIP ViT-L/14 @224 b2", counters,
                {"attn_block_stats": 24, "fused_mlp_chunked_stats": 24},
                long=24)
    dev = torch.from_numpy(cimg).cuda()
    _per_request_ms("CLIP ViT-L/14 @224", [("b1 (K4)", cfwd, dev[:1]),
                                           ("b2 (chain)", cfwd, dev[:2])])

    bcfg = vit.config("vit_b16", image_size=384, dtype="bfloat16")
    bparams = vit.init_params(bcfg, _gen(251), device="cuda")
    bfwd = vit.make_forward(bcfg, bparams)
    bimg = rng.integers(0, 256, (n_requests, 384, 384, 3), np.uint8)
    label = "ViT-B/16 @384 ImageServer(batch_size=1)"
    got, n = _odd_serve(label, bfwd, bimg,
                        {"attn_block_fwd": 12, "fused_mlp_fwd": 12})
    long += n
    checks.append((label, got, vit.make_forward(
        bcfg, _tree_to(bparams, "cpu"), device="cpu"), bimg))
    counters = _zero_counters()
    bfwd(bimg[:2])
    _check_only("ViT-B/16 @384 b2", counters,
                {"attn_block_stats": 12, "fused_mlp_stats": 12}, long=12)
    dev = torch.from_numpy(bimg).cuda()
    _per_request_ms("ViT-B/16 @384", [("b1 (K4 + K5)", bfwd, dev[:1]),
                                      ("b2 (chain)", bfwd, dev[:2])])

    scfg = vit.config("vit_l16", image_size=384, dtype="bfloat16",
                      safe_softmax=True)
    sparams = vit.init_params(scfg, _gen(252), device="cuda")
    sfwd = vit.make_forward(scfg, sparams)
    simg = rng.integers(0, 256, (1, 384, 384, 3), np.uint8)
    sfwd(simg)
    torch.cuda.synchronize()
    counters = _zero_counters()
    got = sfwd(simg).cpu().numpy()
    label = "ViT-L/16 @384 safe_softmax b1"
    _check_launches(label, counters, {"attn_block_fwd": 24})
    _check_long(label, ab.attn_block_fwd.launches_long, 24)
    long += 24
    print(f"  {label} launches: {ab.attn_block_fwd.launches} K4, "
          f"{ab.attn_block_fwd.launches_long} of them past 256 keys")
    checks.append((label, got, vit.make_forward(
        scfg, _tree_to(sparams, "cpu"), device="cpu"), simg))
    ffwd = vit.make_forward(dataclasses.replace(scfg, safe_softmax=False),
                            sparams)
    counters = _zero_counters()
    ffwd(simg)
    _check_only("ViT-L/16 @384 max-free b1", counters,
                {"attn_block_stats": 24, "fused_mlp_chunked_stats": 24},
                long=24)
    dev = torch.from_numpy(simg).cuda()
    _per_request_ms("ViT-L/16 @384 b1", [("safe_softmax (K4)", sfwd, dev),
                                         ("max-free (chain)", ffwd, dev)])

    for label, got, cpu, images in checks:
        _rel_to_max(f"{label} outputs vs the CPU forward", got,
                    cpu(images).numpy(), LOGITS_BAND)
    return long


def run_odd_phases(errors, timing, launches):
    """Phase 17 after the earlier slices' phases (its parity ran right
    after the build): the times of K4 past 256 keys, K10 and K26, then the
    odd-batch serves, whose K4 launches past 256 keys are the JSON line's."""
    for name, t in phase_odd_timing().items():
        timing[name] = dict(t, max_abs_err=errors[name])
    launches["attn_block_fwd_long"] = phase_odd_batch_serve()
    print(_smi_line())


# ---------------------------------------------------------------------------
# Phase 18: K1 and K2 on wgmma + TMA (gemm_wgmma.cuh, mha_wgmma.cuh)
# ---------------------------------------------------------------------------

MLP_ACTS_ALL = ("gelu", "gelu_tanh", "quick_gelu", "relu")
# ptxas's notes that it serialised every wgmma of a kernel (a register a
# group in flight owns written before the group retires).
WGMMA_SERIAL = ("C7513", "C7514", "C7515")


# Kernels whose every instantiation must compile without a spill: the int8
# GEMM (each epilogue of every unit, K14's QW_ACT too), K22's attention and
# K10's bf16 GEMM (gw_kernel in patch_embed.cu).
NO_SPILL = ("qgemm_wgmma_kernel", "attn_s8_wgmma_kernel",
            "11patch_embed9gw_kernel")


def _spills(lines, kernel):
    """(entry line, ptxas's spill line) of each instantiation of
    ``kernel`` in the build log whose spill stores or loads are not 0."""
    out = []
    for i, ln in enumerate(lines):
        if "Compiling entry function" not in ln or kernel not in ln:
            continue
        spill = next((x for x in lines[i + 1:i + 6] if "spill" in x), "")
        if "0 bytes spill stores, 0 bytes spill loads" not in spill:
            out.append((ln.strip(), spill.strip()))
    return out


def check_wgmma_serialisation(build_log: str) -> None:
    """Raise if ptxas reported serialising the wgmma of any kernel, if a
    NO_SPILL kernel spills (or its report shows no spill line), or if the
    log holds no ptxas report of the wgmma kernels to read."""
    lines = build_log.splitlines()
    for kernel in ("gw_kernel", "mha_wgmma_kernel", "bwd_q_kernel",
                   "bwd_kv_kernel", "qgemm_wgmma_kernel", "stack_int8_kernel",
                   "full_int8_kernel", "stack_int8_static_kernel",
                   "8vit_full11full_kernel", "9vit_stack12stack_kernel",
                   "attn_s8_wgmma_kernel", "11patch_embed9gw_kernel",
                   "12quant_linear18qgemm_wgmma_kernel"):
        if not any("Compiling entry function" in ln and kernel in ln
                   for ln in lines):
            raise AssertionError(f"the build log holds no ptxas report of "
                                 f"{kernel}")
    for kernel in NO_SPILL:
        bad = _spills(lines, kernel)
        print(f"{kernel} instantiations that spill: {len(bad)} (must be 0)")
        for entry, spill in bad[:8]:
            print(f"  {entry}: {spill or 'no spill line'}")
        if bad:
            raise AssertionError(f"ptxas spilled in {kernel}")
    hits = [ln for ln in lines if any(code in ln for code in WGMMA_SERIAL)]
    print(f"wgmma serialisation notes in the build log: {len(hits)} "
          f"(must be 0)")
    for ln in hits[:8]:
        print(f"  {ln}")
    if hits:
        raise AssertionError("ptxas serialised the wgmma of a kernel")


def _k2_act_call(fn, x, st, p, act, emit):
    return fn(x, st, p["ln_scale"], p["ln_bias"], p["w1"], p["b1"], p["w2"],
              p["b2"], eps=EPS, act=act, emit_stats=emit)


def phase_wgmma_kernels():
    """K2, K5 and K1 against their plain versions where the wgmma + TMA
    tiles have edges, right after the build: K2 and K5 at (1000, 776) x
    3104 (a partial 128-row tile, a K tail of 8 past 64-wide steps, N past
    256-wide tiles; x scaled by 2, so rstd is about 0.5 and an LN prologue
    that drops it moves the whole branch), K2 at ViT-L's (1600, 1024) x
    4096, K5 at CLIP ViT-L/14 b1's (264, 1024) x 4096 and ViT-B/16 @1024
    b1's (4104, 768) x 3072, each activation code; K1 at (5, 200, 704)
    with 11 heads (N 2112 and 704, tails of a 256-wide tile) with 1, 127,
    128, 129 and 200 of 200 keys valid (one key, either side of a 128-key
    tile's edge, none masked).  Returns {kernel name: max-abs error}."""
    from vit_fpga_tpu_torch.ops import attn_block as ab
    from vit_fpga_tpu_torch.ops import fused_mlp as fm
    from vit_fpga_tpu_torch.ops.common import row_stats
    k2 = 0.0
    for rows, d, m, seed, scale in ((1000, 776, 3104, 180, 2.0),
                                    (1600, 1024, 4096, 181, 1.0)):
        x, _, p = _mlp_inputs(rows, d, m, seed)
        x = (x.float() * scale).to(torch.bfloat16)
        st = row_stats(x, EPS)
        pb = _bf16_weights(p, ("w1", "w2"))
        for act in MLP_ACTS_ALL:
            k2 = max(k2, _parity(
                f"K2 ({rows}, {d}) x {m} {act}",
                lambda fn, emit, a=act: _k2_act_call(fn, x, st, pb, a, emit),
                fm.fused_mlp_stats, fm.fused_mlp_stats_plain, x))
    k5 = 0.0
    for rows, d, m, seed, scale in ((1000, 776, 3104, 180, 2.0),
                                    (264, 1024, 4096, 183, 1.0),
                                    (4104, 768, 3072, 184, 1.0)):
        x, _, p = _mlp_inputs(rows, d, m, seed)
        x = (x.float() * scale).to(torch.bfloat16)
        pb = _bf16_weights(p, ("w1", "w2"))
        for act in MLP_ACTS_ALL:
            label = f"K5 ({rows}, {d}) x {m} {act}"
            got = _k5(fm.fused_mlp_fwd, x, pb, act)
            want = _k5(fm.fused_mlp_xla, x, pb, act)
            torch.cuda.synchronize()
            k5 = max(k5, _compare(f"{label} out", got, want, BF16_TOL,
                                  BF16_TOL))
            _branch(f"{label} branch", got, want, x)
    x, st, p = _attn_inputs(5, 200, 704, seed=182)
    pb = _bf16_weights(p, ("wqkv", "wo"))
    k1 = 0.0
    for n_valid in (1, 127, 128, 129, 200):
        k1 = max(k1, _parity(
            f"K1 (5, 200, 704) 11 heads n_valid={n_valid}",
            lambda fn, emit, nv=n_valid: _attn_call(fn, x, st, pb, 11, nv,
                                                    emit),
            ab.attn_block_stats, ab.attn_block_stats_plain, x,
            (slice(None), slice(0, n_valid))))
    return {"fused_mlp_stats": k2, "fused_mlp_fwd": k5,
            "attn_block_stats": k1}


# ---------------------------------------------------------------------------
# Phase 20: K23 on wgmma + TMA, past 256 keys
# ---------------------------------------------------------------------------

# K23 past 256 keys and at the 128-row tiles' edges: (label, batch, n_pad,
# n_valid, d, heads)
K23_CASES = (
    ("CLIP ViT-L/14", 2, 264, 257, 1024, 16),
    ("ViT-B/16 @384", 2, 584, 577, 768, 12),
    ("1024 tokens", 1, 1024, 1024, 768, 12),
    ("127 of 200 keys", 4, 200, 127, 768, 12),
    ("128 of 200 keys", 4, 200, 128, 768, 12),
    ("129 of 200 keys", 4, 200, 129, 768, 12),
    ("17 tokens", 8, 17, 17, 768, 12),
    # 1032 tokens, where a gate check stood before K23 took any length (at
    # 768 wide: at 128 the LN branch of dx is 1% of g, under dx's bf16
    # rounding, and the plain version alone reads 0.56% off f64 there)
    ("1032 tokens", 1, 1032, 1032, 768, 12),
)


def _k23_plain_f64(x, g, pa, heads, n_valid):
    """dx of the plain version's arithmetic (attn_block_bwd_plain: the
    same bf16 rounding points) with every sum and product in f64: the
    referee of phase 20's elementwise dx check."""
    import math
    from vit_fpga_tpu_torch.ops.common import ln_backward
    dt = x.dtype
    b, n, d = x.shape
    dh = d // heads
    scale = 1.0 / math.sqrt(dh)
    xf = x.double()
    mu = xf.mean(-1, keepdim=True)
    rstd = torch.rsqrt(xf.var(-1, unbiased=False, keepdim=True) + EPS)
    xhat = (xf - mu) * rstd
    xn = (xhat * pa["ln_scale"].double() + pa["ln_bias"].double()).to(dt)
    w = pa["wqkv"].to(dt).double()
    qkv = (xn.double() @ w + pa["bqkv"].double()).to(dt)
    gd = g.double()
    gw = (gd @ pa["wo"].to(dt).double().T).to(dt)

    def heads_of(t):
        return t.reshape(b, n, heads, dh).transpose(1, 2).double()

    q, k, v = (heads_of(qkv[..., i * d:(i + 1) * d]) for i in range(3))
    gh = heads_of(gw)
    s = (q @ k.transpose(-1, -2)) * scale
    keep = torch.arange(n, device=x.device) < n_valid
    s = torch.where(keep, s, torch.full_like(s, -1e30))
    e = torch.exp(s - s.amax(-1, keepdim=True))
    p = e / e.sum(-1, keepdim=True)
    pc = p.to(dt).double()
    dp = gh @ v.transpose(-1, -2)
    ds = (p * (dp - (dp * p).sum(-1, keepdim=True)) * scale).to(dt).double()
    dqkv = torch.cat([
        t.to(dt).double().transpose(1, 2).reshape(b * n, d)
        for t in (ds @ k, ds.transpose(-1, -2) @ q, pc.transpose(-1, -2) @ gh)],
        dim=-1)
    dxn = (dqkv @ w.T).reshape(b, n, d)
    dx_ln, _, _ = ln_backward(dxn, xhat, rstd, pa["ln_scale"].double())
    return (gd + dx_ln).to(dt)


def _k23_case(label, batch, n_pad, n_valid, d, heads, seed, widen=False):
    """K23 against its plain version at one shape, all seven gradients
    (an element of dx outside the band must lie inside the band of the
    plain arithmetic with f64 sums), the launch counted past 256 keys
    where it has more valid keys, and run twice on the same inputs, bit
    for bit; ``widen``: the weights of ``_widened``.  Returns the max-abs
    error of dx."""
    from vit_fpga_tpu_torch.ops import attn_block as ab
    x, g, pa, _ = _train_inputs(batch, n_pad, n_valid, d, 64, seed=seed)
    if widen:
        pa = _widened(pa, d)
    name = f"K23 {label} ({batch}, {n_pad}, {d}) n_valid={n_valid}"
    print(f"parity {name}, {heads} heads")
    before = ab.attn_block_bwd.launches_long
    got = _k23(ab.attn_block_bwd, x, g, pa, heads, n_valid)
    err = _grads_parity(name, ATTN_GRADS, got, _k23(
        ab.attn_block_bwd_plain, x, g, pa, heads, n_valid), g,
        referee=lambda: _k23_plain_f64(x, g, pa, heads, n_valid))
    counted = ab.attn_block_bwd.launches_long - before
    if counted != int(n_valid > 256):
        raise AssertionError(f"{name}: {counted} launches counted past "
                             f"256 keys, want {int(n_valid > 256)}")
    again = _k23(ab.attn_block_bwd, x, g, pa, heads, n_valid)
    torch.cuda.synchronize()
    moved = [n for n, a, b in zip(ATTN_GRADS, got, again)
             if not torch.equal(a, b)]
    print(f"  {name} twice on the same inputs: outputs that differ "
          f"{moved} (must be none)")
    if moved:
        raise AssertionError(f"{name}: {moved} differ from run to run")
    return err


def phase_k23_kernels():
    """Right after phase 17's parity: K23 (its five products on
    gemm_wgmma.cuh, its attention backward two wgmma + TMA kernels tiled
    over 128 keys and 128 query rows) against its plain version, all seven
    gradients, past 256 keys (CLIP ViT-L/14's (2, 264, 1024) with 16 heads
    and 257 valid, ViT-B/16 @384's (2, 584, 768) with 577, (1, 1024, 768)
    with all 1024) and at the tiles' edges (127, 128 and 129 valid of 200,
    17 tokens); each launch counted past 256 keys where it has more valid
    keys, and run twice on the same inputs, bit for bit (every sum in a
    fixed order); loud padding rows at 584 tokens (a 3e3 spike in each,
    zero cotangent there) that must leave every weight, bias and LN
    gradient and the valid rows' dx unchanged; (1, 1032, 768) with 1032
    valid (a gate check before K23 took any length).  Returns {kernel
    name: largest max-abs error of dx}."""
    from vit_fpga_tpu_torch.ops import attn_block as ab
    worst = {"attn_block_bwd": 0.0, "attn_block_bwd_long": 0.0}
    for i, (label, batch, n_pad, n_valid, d, heads) in enumerate(K23_CASES):
        err = _k23_case(label, batch, n_pad, n_valid, d, heads, 220 + i)
        key = "attn_block_bwd_long" if n_valid > 256 else "attn_block_bwd"
        worst[key] = max(worst[key], err)

    batch, n_pad, n_valid, d, heads = 2, 584, 577, 768, 12
    runs = []
    for loud in (False, True):
        x, g, pa, _ = _train_inputs(batch, n_pad, n_valid, d, 64, seed=230,
                                    loud=loud)
        g[:, n_valid:] = 0.0
        runs.append((x, g, _k23(ab.attn_block_bwd, x, g, pa, heads,
                                n_valid)))
    (_, _, quiet), (xl, gl, loud) = runs
    name = f"K23 ViT-B/16 @384 loud padding ({batch}, {n_pad}, {d})"
    print(f"parity {name}: spikes of 3e3 in rows {n_valid}..{n_pad - 1}, "
          f"zero cotangent there")
    worst["attn_block_bwd_long"] = max(
        worst["attn_block_bwd_long"],
        _grads_parity(name, ATTN_GRADS, loud, _k23(
            ab.attn_block_bwd_plain, xl, gl, pa, heads, n_valid), gl,
            referee=lambda: _k23_plain_f64(xl, gl, pa, heads, n_valid)))
    for n, a, b in zip(ATTN_GRADS[1:], loud[1:], quiet[1:]):
        _relnorm(f"{name} loud vs quiet {n}", a, b, LOUD_RTOL)
    _relnorm(f"{name} loud vs quiet dx (valid rows)", loud[0][:, :n_valid],
             quiet[0][:, :n_valid], LOUD_RTOL)
    return worst


def phase_k23_timing(batch=4, n_pad=584, n_valid=577, d=768, heads=12,
                     seed=240, alone=False):
    """K23 past 256 keys at the 384 px training step's shape (or the one
    given): the kernel, its plain version, the library yardstick (the
    autograd backward of LN + addmm + masked scaled_dot_product_attention
    + addmm, bf16) and the bound; with ``alone`` also each call's device
    time alone.  Returns a dict of times."""
    import torch.nn.functional as F
    from vit_fpga_tpu_torch.ops import attn_block as ab
    from vit_fpga_tpu_torch.utils.timing import time_cuda
    x, g, pa, _ = _train_inputs(batch, n_pad, n_valid, d, 64, seed=seed)
    rows, dh = batch * n_pad, d // heads
    keep = (torch.arange(n_pad, device="cuda") < n_valid)[None, None, None]
    leaves = [x.detach().requires_grad_(True)] + [
        pa[k].to(torch.bfloat16).detach().requires_grad_(True)
        for k in ("ln_scale", "ln_bias", "wqkv", "bqkv", "wo", "bo")]

    def lib_attn(xx, ls, lb, wqkv, bqkv, wo, bo):
        h = F.layer_norm(xx, (d,), ls, lb, EPS).reshape(rows, d)
        qkv = torch.addmm(bqkv, h, wqkv).view(batch, n_pad, 3, heads, dh)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        ao = F.scaled_dot_product_attention(q, k, v, attn_mask=keep)
        ao = ao.transpose(1, 2).reshape(rows, d)
        return (torch.addmm(bo, ao, wo) + xx.reshape(rows, d)).view_as(xx)

    with torch.enable_grad():
        out = lib_attn(*leaves)
    ms = time_cuda(lambda: _k23(ab.attn_block_bwd, x, g, pa, heads, n_valid))
    plain_ms = time_cuda(lambda: _k23(ab.attn_block_bwd_plain, x, g, pa,
                                      heads, n_valid), iters=5, warmup=1)
    lib_ms = time_cuda(lambda: torch.autograd.grad(out, leaves, g,
                                                   retain_graph=True))
    score = 4 * batch * heads * n_pad * n_valid * dh
    flops = 22 * rows * d * d + 3 * score
    nbytes = 3 * rows * d * 2 + 4 * d * d * (2 + 4) + 11 * d * 4
    bound_ms, bound_by = _bound(flops, nbytes)
    print(f"timing K23 ({batch}, {n_pad}, {d}) n_valid={n_valid}: kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, library {lib_ms:.4f} ms, "
          f"bound {bound_ms:.4f} ms ({bound_by}, {flops / 1e9:.1f} GFLOP)")
    t = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
             bound_ms=bound_ms, bound_by=bound_by)
    if alone:
        t.update(_alone_pair(
            f"K23 ({batch}, {n_pad}, {d})",
            lambda: _k23(ab.attn_block_bwd, x, g, pa, heads, n_valid),
            lambda: torch.autograd.grad(out, leaves, g, retain_graph=True)))
    return t


# ---------------------------------------------------------------------------
# Phase 21: K16 past 256 keys (its attention mha_wgmma.cuh's max-free
# sweep, its GEMMs qgemm_wgmma.cuh's), the dynamic int8 ViT-B/16 @384
# served
# ---------------------------------------------------------------------------

# (batch, n_pad, n_valid) of K16 past 256 keys: ViT-B/16 @384's 577 tokens
# and @512's 1025 (both inside the JAX int8 plan)
K16_LONG_CASES = ((4, 584, 577), (2, 1032, 1025))
K16_LONG_TIMED = (16, 584, 577)


def phase_k16_long_kernels(d=768, heads=12):
    """K16 past 256 keys against its plain version on the card, right after
    the build: K16_LONG_CASES in the int8 band, all rows; 7 loud padding
    rows at 577 valid keys of 584 that must leave the valid rows bit for
    bit; the gate: ViT-B/16 @1024's 4097 tokens (past the JAX int8 plan)
    and head dim 96 (K16 takes 64 and 80) raise.  Returns the largest
    max-abs error."""
    from vit_fpga_tpu_torch.ops import quant_block as qb
    worst = 0.0
    for i, (b, n_pad, n_valid) in enumerate(K16_LONG_CASES):
        x, _, p = _attn_inputs(b, n_pad, d, seed=260 + i)
        q = _int8_weights(p, ("wqkv", "wo"))
        print(f"parity K16 past 256 keys ({b}, {n_pad}, {d}), {heads} heads, "
              f"n_valid={n_valid}")
        worst = max(worst, _int8_parity(
            f"K16 ({b}, {n_pad}) {n_valid} valid",
            _k16(qb.attn_block_int8, x, q, heads, n_valid),
            _k16(qb.attn_block_int8_plain, x, q, heads, n_valid),
            _k16_step(x, q, heads, n_valid), x))
    worst = max(worst, phase_int8_loud(batch=4, n_pad=584, n_valid=577))
    x, _, p = _attn_inputs(1, 200, d, seed=262)
    q = _int8_weights(p, ("wqkv", "wo"))
    _expect_raise("K16 at ViT-B/16 @1024 (1, 4104, 768), 4097 valid",
                  lambda: _k16(qb.attn_block_int8,
                               torch.zeros((1, 4104, d), dtype=torch.bfloat16,
                                           device="cuda"), q, heads, 4097))
    _expect_raise("K16 at head dim 96",
                  lambda: _k16(qb.attn_block_int8,
                               x[..., :576].contiguous(), q, 6, 197))
    return worst


def phase_k16_long_timing(d=768, heads=12):
    """K16 at K16_LONG_TIMED (ViT-B/16 @384 b16): the kernel's time, its
    plain version's, the library yardstick's (SDPA with the key mask) and
    the bound.  Returns a dict of times."""
    from vit_fpga_tpu_torch.ops import quant_block as qb
    from vit_fpga_tpu_torch.utils.timing import time_cuda
    b, n_pad, n_valid = K16_LONG_TIMED
    x, _, p = _attn_inputs(b, n_pad, d, seed=263)
    q = _int8_weights(p, ("wqkv", "wo"))
    ops8, flops, nbytes = _k16_work(b, n_pad, n_valid, d, heads)
    def kern():
        return _k16(qb.attn_block_int8, x, q, heads, n_valid)

    lib = _k16_library(x, q, heads, n_valid)
    ms = time_cuda(kern)
    plain_ms = time_cuda(
        lambda: _k16(qb.attn_block_int8_plain, x, q, heads, n_valid),
        iters=5, warmup=1)
    lib_ms = _library_ms(lib, "attn_block_int8_long")
    bound_ms, bound_by = _bound_int8(ops8, flops, nbytes)
    print(f"timing attn_block_int8_long ({b}, {n_pad}, {d}) {n_valid} valid: "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library {lib_ms} "
          f"ms, bound {bound_ms:.4f} ms ({bound_by}, {ops8 / 1e9:.2f} G int8 "
          f"ops + {flops / 1e9:.2f} GFLOP bf16, {nbytes / 1e6:.2f} MB)")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=bound_ms, bound_by=bound_by,
                **_device_alone_pair("attn_block_int8_long", kern, lib,
                                     lib_ms is not None))


def run_k16_long_phases(errors, timing, launches):
    """Phase 21 after the earlier slices' phases (its parity ran right
    after the build): K16's time past 256 keys, then ImageServer over
    make_forward_int8(ViT-B/16 @384) on the dynamic tree answers 6 uint8
    requests at batch 4 with 12 K16 + 12 K15 + 1 K14 launches a batch
    (every K16 one past 256 keys) and nothing else, logits against the
    CPU plain forward in the int8 band; the int8 and bf16 @384 b16
    forwards timed in turns.  K16's launches there are the JSON line's
    past-256-key row."""
    timing["attn_block_int8_long"] = dict(
        phase_k16_long_timing(), max_abs_err=errors["attn_block_int8_long"])
    served, fwd, bf_fwd, cfg, _ = phase_int8_slice(n_images=6, batch=4,
                                                   image_size=384)
    launches["attn_block_int8_long"] = served["attn_block_int8"]
    phase_int8_forward_time({"int8 @384": fwd, "bf16 @384": bf_fwd}, cfg,
                            batch=K16_LONG_TIMED[0])
    print(_smi_line())


# ---------------------------------------------------------------------------
# Phase 22: K18 and K21b on K16's wgmma + TMA sequence past 256 keys, and
# the static tree and the int8 chain served at ViT-B/16 @384
# ---------------------------------------------------------------------------

LONG_HALVES = ("attn_block_int8_static_long", "attn_block_int8_stats_long")


def _k18_k21b_loud(batch=4, n_pad=584, n_valid=577, d=768, heads=12):
    """K18 and K21b with their padding rows (7 at 577 valid keys of 584) of
    huge spikes: the valid rows (and K21b's stats there) must equal, bit
    for bit, the kernels' own on quiet padding rows (their keys are
    masked), and match the plain versions on the loud input.  Returns
    (K18's, K21b's max-abs error)."""
    from vit_fpga_tpu_torch.ops import quant_block as qb
    from vit_fpga_tpu_torch.ops.common import row_stats
    x, _, p = _attn_inputs(batch, n_pad, d, seed=272)
    q = _int8_weights(p, ("wqkv", "wo"))
    a, _, _ = _static_attn_args(x, q, heads, n_valid)
    loud = x.clone()
    loud[:, n_valid:] = 0.0
    loud[:, n_valid:, 3] = 3e3
    loud[:, n_valid:, 100] = -1e3
    st_q, st_l = row_stats(x, EPS), row_stats(loud, EPS)
    valid = (slice(None), slice(0, n_valid))
    print(f"K18 / K21b loud padding ({batch}, {n_pad}, {d}): spikes in rows "
          f"{n_valid}..{n_pad - 1}")
    quiet18 = _k18(qb.attn_block_int8_static, x, a, heads, n_valid)
    noisy18 = _k18(qb.attn_block_int8_static, loud, a, heads, n_valid)
    err18 = _int8_parity(
        "K18 loud padding", noisy18,
        _k18(qb.attn_block_int8_static_plain, loud, a, heads, n_valid),
        (127.0 * a["wo_s"]).expand(batch, n_pad, d), loud, rows=valid,
        mag_x=True)
    quiet, sq = _k21b(qb.attn_block_int8_stats, x, st_q, q, heads, n_valid,
                      True)
    noisy, sn = _k21b(qb.attn_block_int8_stats, loud, st_l, q, heads,
                      n_valid, True)
    step = _k21b_step(loud, st_l, q, heads, n_valid)
    err21 = _int8_parity(
        "K21b loud padding", noisy,
        _k21b(qb.attn_block_int8_stats_plain, loud, st_l, q, heads, n_valid,
              True)[0], step, loud, rows=valid, mag_x=True,
        row_bound=_requant_bound(step, q["wo_q"]))
    for what, g, w in (("K18 out", noisy18, quiet18), ("K21b out", noisy,
                                                       quiet),
                       ("K21b stats", sn, sq)):
        moved = float((g[valid].float() - w[valid].float()).abs().max())
        print(f"  {what} valid rows, loud vs quiet padding: "
              f"max_abs={moved:.3e} (must be 0)")
        if moved != 0.0:
            raise AssertionError(f"{what}: padding rows moved the valid rows")
    return err18, err21


def phase_k18_k21b_long_kernels(d=768, heads=12):
    """K18 and K21b past 256 keys against their plain versions on the card,
    right after the build: at K16_LONG_CASES K18 calibrated on its input
    (quiet) and on half its range (saturating: the clipped shares must be
    > 0), K21b on stats that are not x's own, f32 (both emit_stats) and
    bf16, each in its int8 band; loud padding at 577 valid keys of 584 bit
    for bit (``_k18_k21b_loud``); the gates: ViT-B/16 @1024's 4097 tokens
    (past the JAX int8 plan), K18 at head dim 96 and K21b at head dim 80
    raise.  Returns {row name: largest max-abs error}."""
    from vit_fpga_tpu_torch.ops import quant_block as qb
    worst = dict.fromkeys(LONG_HALVES, 0.0)
    for i, (b, n_pad, n_valid) in enumerate(K16_LONG_CASES):
        x, st, p = _attn_inputs(b, n_pad, d, seed=270 + i)
        q = _int8_weights(p, ("wqkv", "wo"))
        valid = (slice(None), slice(0, n_valid))
        for label, shrink in (("quiet", 1.0), ("saturating", SHRINK)):
            a, cx, cao = _static_attn_args(x, q, heads, n_valid, shrink)
            print(f"parity K18 past 256 keys ({b}, {n_pad}, {d}), n_valid="
                  f"{n_valid} {label}: clipped share xq {cx:.3e}, aoq "
                  f"{cao:.3e}")
            if shrink > 1.0 and not min(cx, cao) > 0.0:
                raise AssertionError("K18 saturating case: nothing clipped")
            worst[LONG_HALVES[0]] = max(worst[LONG_HALVES[0]], _int8_parity(
                f"K18 ({b}, {n_pad}) {n_valid} valid {label}",
                _k18(qb.attn_block_int8_static, x, a, heads, n_valid),
                _k18(qb.attn_block_int8_static_plain, x, a, heads, n_valid),
                (127.0 * a["wo_s"]).expand(b, n_pad, d), x, rows=valid,
                mag_x=True))
        fs = _foreign(st)
        print(f"parity K21b past 256 keys ({b}, {n_pad}, {d}), n_valid="
              f"{n_valid}, foreign stats")
        worst[LONG_HALVES[1]] = max(worst[LONG_HALVES[1]], _chain_case(
            f"K21b ({b}, {n_pad}) {n_valid} valid",
            lambda e, dt: _k21b(qb.attn_block_int8_stats, x, fs.to(dt), q,
                                heads, n_valid, e),
            lambda e, dt: _k21b(qb.attn_block_int8_stats_plain, x,
                                fs.to(dt), q, heads, n_valid, e),
            _k21b_step(x, fs, q, heads, n_valid), x, q["wo_q"], rows=valid))
    for name, err in zip(LONG_HALVES, _k18_k21b_loud(d=d, heads=heads)):
        worst[name] = max(worst[name], err)
    x, st, p = _attn_inputs(1, 200, d, seed=273)
    q = _int8_weights(p, ("wqkv", "wo"))
    a, _, _ = _static_attn_args(x, q, heads, 197)
    big = torch.zeros((1, 4104, d), dtype=torch.bfloat16, device="cuda")
    big_st = torch.zeros((1, 4104, 2), device="cuda")
    _expect_raise("K18 at ViT-B/16 @1024 (1, 4104, 768), 4097 valid",
                  lambda: _k18(qb.attn_block_int8_static, big, a, heads,
                               4097))
    _expect_raise("K21b at ViT-B/16 @1024 (1, 4104, 768), 4097 valid",
                  lambda: _k21b(qb.attn_block_int8_stats, big, big_st, q,
                                heads, 4097, True))
    _expect_raise("K18 at head dim 96",
                  lambda: _k18(qb.attn_block_int8_static,
                               x[..., :576].contiguous(), a, 6, 197))
    _expect_raise("K21b at head dim 80",
                  lambda: _k21b(qb.attn_block_int8_stats,
                                x[..., :720].contiguous(), st, q, 9, 197,
                                True))
    return worst


def phase_k18_k21b_long_timing(d=768, heads=12):
    """K18 and K21b at K16_LONG_TIMED (ViT-B/16 @384 b16): each kernel's
    time, its plain version's, its library yardstick's (SDPA with the key
    mask), the bound and the device-alone pair.  Returns {row name: dict
    of times}."""
    from vit_fpga_tpu_torch.ops import quant_block as qb
    from vit_fpga_tpu_torch.utils.timing import time_cuda
    b, n_pad, n_valid = K16_LONG_TIMED
    x, st, p = _attn_inputs(b, n_pad, d, seed=274)
    q = _int8_weights(p, ("wqkv", "wo"))
    a, _, _ = _static_attn_args(x, q, heads, n_valid)
    cases = {
        LONG_HALVES[0]: (
            lambda: _k18(qb.attn_block_int8_static, x, a, heads, n_valid),
            lambda: _k18(qb.attn_block_int8_static_plain, x, a, heads,
                         n_valid),
            _static_library(x, a, "attn", heads, n_valid),
            *_k16_work(b, n_pad, n_valid, d, heads)),
        LONG_HALVES[1]: (
            lambda: _k21b(qb.attn_block_int8_stats, x, st, q, heads, n_valid,
                          True),
            lambda: _k21b(qb.attn_block_int8_stats_plain, x, st, q, heads,
                          n_valid, True),
            _k21b_library(x, st, q, heads, n_valid),
            *_k21b_work(b, n_pad, n_valid, d, heads)),
    }
    out = {}
    for name, (kern, plain, lib, ops8, flops, nbytes) in cases.items():
        ms = time_cuda(kern)
        plain_ms = time_cuda(plain, iters=5, warmup=1)
        lib_ms = _library_ms(lib, name)
        bound_ms, bound_by = _bound_int8(ops8, flops, nbytes)
        out[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=bound_ms, bound_by=bound_by)
        print(f"timing {name} ({b}, {n_pad}, {d}) {n_valid} valid: kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, library {lib_ms} ms, "
              f"bound {bound_ms:.4f} ms ({bound_by}, {ops8 / 1e9:.2f} G int8 "
              f"ops + {flops / 1e9:.2f} GFLOP bf16, {nbytes / 1e6:.2f} MB)")
        out[name].update(_device_alone_pair(name, kern, lib,
                                            lib_ms is not None))
    return out


def run_k18_k21b_long_phases(errors, timing, launches):
    """Phase 22 after the earlier slices' phases (its parity ran right
    after the build): K18's and K21b's times past 256 keys, then
    ImageServer over make_forward_int8(ViT-B/16 @384) answers 6 uint8
    requests at batch 4 on the static tree (12 K18 + 12 K17 + 1 K14 a
    batch) and 6 with the int8 stats chain on (12 K21b + 12 K21a + 1 K14)
    and nothing else, logits against the CPU plain forward in the int8
    band; the static, chain and dynamic int8 @384 b16 forwards timed in
    turns.  Their K18 and K21b launches are the JSON line's past-256-key
    rows."""
    for name, t in phase_k18_k21b_long_timing().items():
        timing[name] = dict(t, max_abs_err=errors[name])
    served, fwd_static, _, cfg, _ = phase_int8_slice(
        n_images=6, batch=4, mode="static", image_size=384)
    launches[LONG_HALVES[0]] = served["attn_block_int8_static"]
    served, fwd_chain, _, _, fwd_int8 = phase_int8_slice(
        n_images=6, batch=4, mode="chain", image_size=384)
    launches[LONG_HALVES[1]] = served["attn_block_int8_stats"]
    phase_int8_forward_time({"int8 @384": fwd_int8,
                             "int8 static @384": fwd_static,
                             "int8 chain @384": fwd_chain}, cfg,
                            batch=K16_LONG_TIMED[0])
    print(_smi_line())


# ---------------------------------------------------------------------------
# Phase 23: K17 on qgemm_wgmma.cuh's int8 epilogue (QW_Q8) and K22 on it and
# a wgmma + TMA int8 attention, past 256 keys; the int8-scores path served
# at ViT-B/16 @384
# ---------------------------------------------------------------------------

SCORES_LONG = "attn_block_int8_static_scores_long"
# (label, T, D, M) of K17 at its GEMMs' tile edges: a partial last tile of
# 128 rows, of 256 W1 columns (3104 = 12 x 256 + 32) and of 128 W2 columns
# (784 = 6 x 128 + 16), K past the last 128-byte step (784 for W1, 3104 for
# W2); ragged rows at ViT-B/16's widths.  D and M are multiples of 16, as
# the int8 GEMM's TMA rows need (K2's and K5's edge D 776 is refused)
K17_EDGES = (("(1000, 784) x 3104", 1000, 784, 3104),
             ("T 1601", 1601, 768, 3072))


def _k17_edges():
    """K17 against its plain version at K17_EDGES with each activation
    calibrated on its input (quiet), and with gelu_tanh on half the range
    (saturating: the clipped shares must be > 0, QW_Q8 must saturate, not
    wrap), in the static int8 band.  Returns the max-abs error."""
    from vit_fpga_tpu_torch.ops import quant_block as qb
    worst = 0.0
    for i, (label, t, d, m) in enumerate(K17_EDGES):
        x2, _, p = _mlp_inputs(t, d, m, seed=280 + i)
        q = _int8_weights(p, ("w1", "w2"))
        for act, how, shrink in [(a, "quiet", 1.0) for a in MLP_ACTS] + [
                ("gelu_tanh", "saturating", SHRINK)]:
            a, cx, ch = _static_mlp_args(x2, q, act, shrink)
            print(f"parity K17 {label} {act} {how}: clipped share xq "
                  f"{cx:.3e}, hq {ch:.3e}")
            if shrink > 1.0 and not min(cx, ch) > 0.0:
                raise AssertionError("K17 saturating case: nothing clipped")
            worst = max(worst, _int8_parity(
                f"K17 {label} {act} {how}",
                _k17(qb.mlp_block_int8_static, x2, a, act),
                _k17(qb.mlp_block_int8_static_plain, x2, a, act),
                (127.0 * a["w2_s"]).expand(t, d), x2, mag_x=True))
    _expect_raise("K17 at D 776 (not a multiple of 16)",
                  lambda: _k17(qb.mlp_block_int8_static,
                               torch.zeros((8, 776), dtype=torch.bfloat16,
                                           device="cuda"), a, "gelu_tanh"))
    return worst


def _k22_loud(batch=4, n_pad=584, n_valid=577, d=768, heads=12):
    """K22 with its padding rows (7 at 577 valid keys of 584) of huge
    spikes: the valid rows must equal, bit for bit, the kernel's own on
    quiet padding rows (their keys are masked) and match the plain version
    on the loud input.  Returns the max-abs error."""
    from vit_fpga_tpu_torch.ops import quant_block as qb
    x, _, p = _attn_inputs(batch, n_pad, d, seed=285)
    a, _ = _scores_args(x, _int8_weights(p, ("wqkv", "wo")), heads, n_valid)
    loud = x.clone()
    loud[:, n_valid:] = 0.0
    loud[:, n_valid:, 3] = 3e3
    loud[:, n_valid:, 100] = -1e3
    valid = (slice(None), slice(0, n_valid))
    print(f"K22 loud padding ({batch}, {n_pad}, {d}): spikes in rows "
          f"{n_valid}..{n_pad - 1}")
    quiet = _k22(qb.attn_block_int8_static_scores, x, a, heads, n_valid)
    noisy = _k22(qb.attn_block_int8_static_scores, loud, a, heads, n_valid)
    err = _k22_parity("K22 loud padding", loud, a, heads, n_valid, valid,
                      got=noisy)
    moved = float((noisy[valid].float() - quiet[valid].float()).abs().max())
    print(f"  K22 out valid rows, loud vs quiet padding: max_abs="
          f"{moved:.3e} (must be 0)")
    if moved != 0.0:
        raise AssertionError("K22 out: padding rows moved the valid rows")
    return err


def phase_k17_k22_kernels(d=768, heads=12):
    """K17 and K22 against their plain versions on the card, right after
    phase 16's parity: K17 at its tiles' edges (``_k17_edges``); K22 past
    256 keys at K16_LONG_CASES (ViT-B/16 @384's 577 tokens and @512's
    1025) calibrated on its input (quiet) and on half its range
    (saturating: the clipped shares must be > 0), in the static int8 band
    with FLIP_ROWS' allowance; loud padding at 577 valid keys of 584 bit
    for bit (``_k22_loud``); the gate: ViT-B/16 @896's 3137 tokens (one
    score slot in the JAX plan), head dim 80 and an odd head count raise.
    Returns {row name: largest max-abs error}."""
    from vit_fpga_tpu_torch.ops import quant_block as qb
    worst = {"mlp_block_int8_static": _k17_edges(), SCORES_LONG: 0.0}
    for i, (b, n_pad, n_valid) in enumerate(K16_LONG_CASES):
        x, _, p = _attn_inputs(b, n_pad, d, seed=282 + i)
        q = _int8_weights(p, ("wqkv", "wo"))
        valid = (slice(None), slice(0, n_valid))
        for label, shrink in (("quiet", 1.0), ("saturating", SHRINK)):
            a, clipped = _scores_args(x, q, heads, n_valid, shrink)
            print(f"parity K22 past 256 keys ({b}, {n_pad}, {d}), n_valid="
                  f"{n_valid} {label}: clipped share xq {clipped[0]:.3e}, "
                  f"qkv8 {clipped[1]:.3e}, aoq {clipped[2]:.3e}")
            if shrink > 1.0 and not min(clipped) > 0.0:
                raise AssertionError("K22 saturating case: nothing clipped")
            worst[SCORES_LONG] = max(worst[SCORES_LONG], _k22_parity(
                f"K22 ({b}, {n_pad}) {n_valid} valid {label}", x, a, heads,
                n_valid, valid))
    worst[SCORES_LONG] = max(worst[SCORES_LONG], _k22_loud(d=d, heads=heads))
    x, _, p = _attn_inputs(1, 200, d, seed=284)
    a, _ = _scores_args(x, _int8_weights(p, ("wqkv", "wo")), heads, 197)
    _expect_raise("K22 at ViT-B/16 @896 (1, 3144, 768), 3137 valid",
                  lambda: _k22(qb.attn_block_int8_static_scores,
                               torch.zeros((1, 3144, d), dtype=torch.bfloat16,
                                           device="cuda"), a, heads, 3137))
    _expect_raise("K22 at head dim 80",
                  lambda: _k22(qb.attn_block_int8_static_scores,
                               x[..., :720].contiguous(), a, 9, 197))
    _expect_raise("K22 at 11 heads (odd)",
                  lambda: _k22(qb.attn_block_int8_static_scores,
                               x[..., :704].contiguous(), a, 11, 197))
    return worst


def phase_k22_long_timing(d=768, heads=12):
    """K22 at K16_LONG_TIMED (ViT-B/16 @384 b16, 577 valid keys of 584):
    the kernel's time, its plain version's, its library yardstick's (SDPA
    with the key mask on the int8 panel), the bound and the device-alone
    pair.  Returns a dict of times."""
    from vit_fpga_tpu_torch.ops import quant_block as qb
    from vit_fpga_tpu_torch.utils.timing import time_cuda
    b, n_pad, n_valid = K16_LONG_TIMED
    x, _, p = _attn_inputs(b, n_pad, d, seed=286)
    a, _ = _scores_args(x, _int8_weights(p, ("wqkv", "wo")), heads, n_valid)
    ops8, flops, nbytes = _k22_work(b, n_pad, n_valid, d, heads)

    def kern():
        return _k22(qb.attn_block_int8_static_scores, x, a, heads, n_valid)

    lib = _k22_library(x, a, heads, n_valid)
    ms = time_cuda(kern)
    plain_ms = time_cuda(
        lambda: _k22(qb.attn_block_int8_static_scores_plain, x, a, heads,
                     n_valid), iters=5, warmup=1)
    lib_ms = _library_ms(lib, SCORES_LONG)
    bound_ms, bound_by = _bound_int8(ops8, flops, nbytes)
    print(f"timing {SCORES_LONG} ({b}, {n_pad}, {d}) {n_valid} valid: "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library {lib_ms} "
          f"ms, bound {bound_ms:.4f} ms ({bound_by}, {ops8 / 1e9:.2f} G int8 "
          f"ops, {nbytes / 1e6:.2f} MB)")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=bound_ms, bound_by=bound_by,
                **_device_alone_pair(SCORES_LONG, kern, lib,
                                     lib_ms is not None))


def run_k17_k22_phases(errors, timing, launches):
    """Phase 23 after the earlier slices' phases (its parity ran right
    after phase 16's): K22's time past 256 keys, then ImageServer over
    make_forward_int8(ViT-B/16 @384) on the static tree with
    ``_INT8_SCORES`` on answers 6 uint8 requests at batch 4 with 12 K22 +
    12 K17 + 1 K14 launches a batch (every K22 one past 256 keys) and
    nothing else, logits against the CPU plain forward in the int8 band.
    Its K22 launches are the JSON line's past-256-key row."""
    timing[SCORES_LONG] = dict(phase_k22_long_timing(),
                               max_abs_err=errors[SCORES_LONG])
    served, _, _, _, _ = phase_int8_slice(n_images=6, batch=4, mode="scores",
                                          image_size=384)
    launches[SCORES_LONG] = served[SCORES_KERNEL]
    print(_smi_line())


# ---------------------------------------------------------------------------
# Phase 24: K14 on qgemm_wgmma.cuh at the per-linear route's shapes, and K10
# on the tensor cores through the exact three-piece bf16 split
# ---------------------------------------------------------------------------

K14_PER_LINEAR = "int8_linear_fused_per_linear"
# K14 where the main path runs it: ViT-B/16 @1024 b2's per-linear route
# (make_forward_int8, 8208 = 2 x 4104 rows, 49 launches a batch), the
# heads, and the output row strides TMA cannot take (N % 4 != 0 in f32,
# N % 8 != 0 in bf16: the register stores).  (label, rows, K, N, input
# dtype, keyword arguments)
K14_PATH_CASES = (
    ("@1024 b2 QKV + LN", 8208, 768, 2304, torch.bfloat16,
     dict(ln_eps=EPS)),
    ("@1024 b2 out-projection", 8208, 768, 768, torch.bfloat16, {}),
    ("@1024 b2 W1 + gelu_tanh", 8208, 768, 3072, torch.bfloat16,
     dict(act="gelu_tanh")),
    ("@1024 b2 W2", 8208, 3072, 768, torch.bfloat16, {}),
    ("head b64 bf16", 64, 768, 1000, torch.bfloat16, {}),
    ("head b64 f32", 64, 768, 1000, torch.bfloat16,
     dict(out_dtype=torch.float32)),
    ("N 1001 f32 + relu (register stores)", 200, 768, 1001, torch.bfloat16,
     dict(act="relu", out_dtype=torch.float32)),
    ("N 1004 bf16, f32 in + quick_gelu (register stores)", 200, 768, 1004,
     torch.float32, dict(act="quick_gelu")),
)
# The timed K14 shapes: the head, the per-linear W1 (the JSON line's
# per-linear row) and W2.
K14_TIMED = ("head b64 bf16", "@1024 b2 W1 + gelu_tanh", "@1024 b2 W2")


def _k14_case(label, seed):
    """One K14_PATH_CASES case's inputs: (x, q, keyword arguments)."""
    _, t, k, n, dt, kw = next(c for c in K14_PATH_CASES if c[0] == label)
    x, q = _k14_inputs(t, k, n, seed)
    if "ln_eps" in kw:
        kw = dict(kw, ln_scale=q["ls"], ln_bias=q["lb"])
    return x.to(dt), q, kw


def _true_div_scale(xf):
    """The row scale s = absmax / 127 as a true division of two tensors
    (PyTorch divides a CUDA tensor by a Python number through its
    reciprocal, which can sit an ulp away)."""
    from vit_fpga_tpu_torch.ops import quant_fused as qf
    amax = xf.abs().amax(-1, keepdim=True).clamp_min(1e-12)
    return amax / torch.full_like(amax, qf.QMAX)


def _k14_ieee(x, q, kw):
    """K14's arithmetic with its row scale s = absmax / 127 a true
    division, as the kernel's (``_true_div_scale``); no LayerNorm."""
    from vit_fpga_tpu_torch.ops import quant_fused as qf
    xf = x.float()
    sx = _true_div_scale(xf)
    xq = torch.clamp(torch.round(xf / sx), -qf.QMAX, qf.QMAX).to(torch.int8)
    f = qf._int_matmul(xq, q["w_q"]) * (sx * q["w_s"]) + q["b"]
    act = kw.get("act", "none")
    if act == "gelu_tanh":
        f = qf._gelu_tanh_textbook(f)
    elif act == "relu":
        f = torch.clamp_min(f, 0.0)
    elif act != "none":
        raise ValueError(act)
    return f.to(kw.get("out_dtype", torch.bfloat16))


def phase_row_quant_scale():
    """The plain row quantization's scale on the card (``_row_quant``, which
    every int8 plain version shares) against ``_true_div_scale``, bit for
    bit, with its int8 rows, on 4096 seeded rows of 768 whose absmax is
    spread over many binades; counts the rows where a multiply by
    1 / 127 would have moved s (there must be some)."""
    from vit_fpga_tpu_torch.ops import quant_fused as qf
    rng = np.random.default_rng(64)
    x = (rng.standard_normal((4096, 768))
         * np.exp2(rng.uniform(-20, 20, (4096, 1)))).astype(np.float32)
    xf = torch.from_numpy(x).cuda()
    xq, sx = qf._row_quant(xf)
    want = _true_div_scale(xf)
    amax = xf.abs().amax(-1, keepdim=True).clamp_min(1e-12)
    reciprocal = int((amax * (1.0 / qf.QMAX) != want).sum())
    moved = int((sx != want).sum())
    wq = torch.clamp(torch.round(xf / want), -qf.QMAX, qf.QMAX).to(torch.int8)
    print(f"  plain row quantization on the card: {moved} of {sx.numel()} "
          f"row scales away from absmax / 127 as a true division (must be "
          f"0; a multiply by 1 / 127 moves {reciprocal}), "
          f"{int((xq != wq).sum())} int8 values away (must be 0)")
    if moved or reciprocal == 0 or not torch.equal(xq, wq):
        raise AssertionError("the plain row quantization does not divide "
                             "as the kernels do")


def phase_k14_kernels():
    """K14 against its plain version at K14_PATH_CASES in the unchanged
    int8 band, each with the count of elements that are not bit for bit
    (printed); and where there is no LayerNorm (whose f32 sums run in
    another order) and no quick_gelu (expf against torch.sigmoid), bit
    for bit against its arithmetic with the row scale's true division
    (``_k14_ieee``): the int8 band cannot tell the textbook tanh-GELU
    from K15's fma form, this can.  Returns the largest max-abs error."""
    from vit_fpga_tpu_torch.ops import quant_fused as qf
    phase_row_quant_scale()
    worst = 0.0
    for i, (label, t, k, n, _, _) in enumerate(K14_PATH_CASES):
        x, q, kw = _k14_case(label, 300 + i)
        got = _k14(qf.int8_linear_fused, x, q, **kw)
        want = _k14(qf.int8_linear_fused_plain, x, q, **kw)
        if got.dtype != kw.get("out_dtype", torch.bfloat16) \
                or tuple(got.shape) != (t, n):
            raise AssertionError(f"K14 {label}: {got.dtype} "
                                 f"{tuple(got.shape)}")
        name = f"K14 {label} ({t}, {k}) x {n}"
        print(f"parity {name}")
        worst = max(worst, _int8_parity(name, got, want,
                                        _k14_step(x, q, **kw)))
        print(f"  {name}: {int((got != want).sum())} of {got.numel()} "
              f"elements not bit for bit")
        if "ln_eps" not in kw and kw.get("act") != "quick_gelu":
            moved = int((got != _k14_ieee(x, q, kw)).sum())
            print(f"  {name} vs its arithmetic with s = absmax / 127 a true "
                  f"division: {moved} elements not bit for bit (must be 0)")
            if moved:
                raise AssertionError(f"{name}: not K14's arithmetic")
    return worst


def _k14_library(x, q, kw):
    """K14's library yardstick: F.layer_norm (with the LN), the row
    quantization in torch ops, torch._int_mm, the dequantization and the
    activation in torch ops."""
    import torch.nn.functional as F
    from vit_fpga_tpu_torch.ops import quant_fused as qf
    k, act = x.shape[1], kw.get("act", "none")
    dt = kw.get("out_dtype", torch.bfloat16)

    def run():
        xf = x.float()
        if "ln_eps" in kw:
            xf = F.layer_norm(xf, (k,), q["ls"], q["lb"], kw["ln_eps"])
        xq, sx = qf._row_quant(xf)
        f = torch._int_mm(xq, q["w_q"]).float() * (sx * q["w_s"]) + q["b"]
        if act == "gelu_tanh":
            f = F.gelu(f, approximate="tanh")
        elif act == "quick_gelu":
            f = f * torch.sigmoid(1.702 * f)
        elif act == "relu":
            f = torch.relu(f)
        return f.to(dt)
    return run


def phase_k14_timing():
    """K14 at K14_TIMED: per call, device alone (torch.profiler, the
    wrapper's host time out), the plain version, the library yardstick
    per call and device alone, and the bound (int8 operations or bytes).
    Returns {label: dict of times}."""
    from vit_fpga_tpu_torch.ops import quant_fused as qf
    from vit_fpga_tpu_torch.utils.timing import time_cuda
    out = {}
    for i, label in enumerate(K14_TIMED):
        x, q, kw = _k14_case(label, 310 + i)
        t, k = x.shape
        n = q["w_q"].shape[1]
        eb = 4 if kw.get("out_dtype") == torch.float32 else 2

        def kern():
            return _k14(qf.int8_linear_fused, x, q, **kw)
        lib = _k14_library(x, q, kw)
        ms = time_cuda(kern)
        dev_ms = _device_alone_ms(kern, iters=20)
        plain_ms = time_cuda(lambda: _k14(qf.int8_linear_fused_plain, x, q,
                                          **kw), iters=5, warmup=1)
        lib_ms = _library_ms(lib, f"K14 {label}")
        lib_dev = (_device_alone_ms(lib, iters=20) if lib_ms is not None
                   else None)
        ops8 = 2 * t * k * n
        nbytes = t * k * x.element_size() + k * n + 8 * n + t * n * eb
        bound_ms, bound_by = _bound_int8(ops8, 0, nbytes)
        print(f"timing K14 {label} ({t}, {k}) x {n}: kernel {ms:.4f} ms "
              f"per call, {dev_ms:.4f} ms device alone "
              f"({ops8 / dev_ms / 1e9:.1f} TOPS); plain {plain_ms:.4f} ms, "
              f"library {lib_ms} ms per call, {lib_dev} ms device alone; "
              f"bound {bound_ms:.4f} ms ({bound_by}, {ops8 / 1e9:.2f} G int8 "
              f"ops, {nbytes / 1e6:.2f} MB)")
        out[label] = dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                          library_ms=lib_ms, library_device_ms=lib_dev,
                          bound_ms=bound_ms, bound_by=bound_by)
    return out


def _lit_images(batch, h, w, patch, seed):
    """uint8 images on the card that are 0 but for one pixel channel of
    each patch, lit to a power of two (1 .. 128), at a seeded place."""
    rng = np.random.default_rng(seed)
    gh, gw, k = h // patch, w // patch, patch * patch * 3
    img = np.zeros((batch, h, w, 3), np.uint8)
    q = rng.integers(0, k, (batch, gh, gw))
    val = (2 ** rng.integers(0, 8, (batch, gh, gw))).astype(np.uint8)
    b, gy, gx = np.indices((batch, gh, gw))
    img[b, gy * patch + q // (3 * patch), gx * patch + q // 3 % patch,
        q % 3] = val
    return torch.from_numpy(img).cuda()


def phase_k10_exact():
    """K10 on one lit pixel a patch, at each K10_CASES shape: every output
    is pixel * w + bias with pixel a power of two, so the three pieces'
    f32 sum, 2^e (lo + mid + hi) = 2^e w, is exact in any order and K10
    equals its plain version bit for bit (a split without one of its
    pieces does not); a weight that three normal bf16 pieces cannot hold
    (an f32 subnormal) and D % 8 != 0 raise."""
    from vit_fpga_tpu_torch.ops import patch_embed as pe
    torch.backends.cuda.matmul.allow_tf32 = False
    for i, (label, b, h, w, p, d, dt, scales) in enumerate(K10_CASES):
        _, kf, bf = _k10_inputs(b, h, w, p, d, 320 + i, scales)
        images = _lit_images(b, h, w, p, 320 + i)
        got = pe.patch_embed_pallas(images, kf, bf, p, out_dtype=dt)
        want = pe.patch_embed_plain(images, kf, bf, p, out_dtype=dt)
        torch.cuda.synchronize()
        moved = int((got != want).sum())
        print(f"  K10 {label} one lit pixel a patch: {moved} of "
              f"{got.numel()} elements not bit for bit (must be 0)")
        if moved or not torch.isfinite(got).all():
            raise AssertionError(f"K10 {label}: the split GEMM is not exact")
    images, kf, bf = _k10_inputs(1, 32, 32, 8, 64, 330, None)
    tiny = kf.clone()
    tiny[5, 7] = 1e-40
    _expect_raise("K10 with an f32 subnormal weight",
                  lambda: pe.patch_embed_pallas(images, tiny, bf, 8))
    _expect_raise("K10 at D 60",
                  lambda: pe.patch_embed_pallas(images, kf[:, :60].contiguous(),
                                                bf[:60].contiguous(), 8))


def run_k14_k10_phases(errors, timing, launches):
    """Phase 24 after the earlier slices' phases (its parity ran right
    after phase 23's): K14's times at the head, the per-linear W1 (the
    JSON line's per-linear row, its launches the per-block serve's) and
    W2."""
    timing[K14_PER_LINEAR] = dict(phase_k14_timing()["@1024 b2 W1 + gelu_tanh"],
                                  max_abs_err=errors[K14_PER_LINEAR])
    print(_smi_line())


# ---------------------------------------------------------------------------
# Phase 25: the bf16 attention halves past 1024 tokens: K1 and K4 at the
# JAX wrappers' gates (up to ViT-B/16 @896's 3137 tokens), K23 where the
# JAX _bwd_fits keeps the Pallas backward and the autograd route past it;
# the static int8 tree's *_ref blocks and non-S x S input
# ---------------------------------------------------------------------------

# (label, batch, n_pad, n_valid, d, heads, extra) of K1 past 1024 tokens
K1_PAST_1024 = (
    ("ViT-B/16 @512 b2", 2, 1032, 1025, 768, 12, ("loud",)),
    ("ViT-B/16 @896 b1", 1, 3144, 3137, 768, 12, ("loud",)),
)
# (label, batch, n_pad, n_valid, d, heads) of K23 past 1024 tokens: inside
# _bwd_fits at @512 and @640, and one direct call past it (@768)
K23_PAST_1024 = (
    ("ViT-B/16 @512 b2", 2, 1032, 1025, 768, 12),
    ("ViT-B/16 @640 b2", 2, 1608, 1601, 768, 12),
    ("ViT-B/16 @768 b1, called directly", 1, 2312, 2305, 768, 12),
)
PAST_1024_ROWS = ("attn_block_stats_1032", "attn_block_stats_3144",
                  "attn_block_fwd_3144", "attn_block_bwd_1032",
                  "attn_block_bwd_1608")


def phase_past_1024_kernels():
    """Right after phase 20's K23 parity: K1 past 1024 tokens at ViT-B/16
    @512 b2's (2, 1032, 768) and @896 b1's (1, 3144, 768) against its
    plain version, both values of emit_stats, loud padding bit for bit,
    each launch counted past 256 keys; K4 at (1, 3144, 768) in both
    softmax modes (loud padding, the exact mode's wide scores); K23 at
    K23_PAST_1024's shapes; then the new gates: K1 and K4 at ViT-B/16
    @1024's (1, 4104, 768) (the JAX plan has no score slot), K1 at CLIP
    ViT-L/14 b1's (1, 264, 1024) (q-slot reuse) and at (1, 1608, 128) (the
    q-reuse tier) raise.  Returns {JSON row: max-abs error}."""
    from vit_fpga_tpu_torch.ops import attn_block as ab
    torch.backends.cuda.matmul.allow_tf32 = False
    errors = {}
    for i, (label, b, n_pad, n_valid, d, heads, extra) in enumerate(
            K1_PAST_1024):
        before = ab.attn_block_stats.launches_long
        errors[f"attn_block_stats_{n_pad}"] = _k1_long_parity(
            b, n_pad, n_valid, d, heads, seed=400 + i, extra=extra)
        counted = ab.attn_block_stats.launches_long - before
        print(f"  K1 {label}: {counted} launches counted past 256 keys")
        if counted < 2:
            raise AssertionError(f"K1 {label}: {counted} launches counted "
                                 f"past 256 keys")
    errors["attn_block_fwd_3144"] = _k4_long_parity(
        "ViT-B/16 @896 b1", 1, 3144, 3137, 768, 12, (True, False), seed=410)
    for i, (label, b, n_pad, n_valid, d, heads) in enumerate(K23_PAST_1024):
        err = _k23_case(label, b, n_pad, n_valid, d, heads, seed=420 + i)
        errors[f"attn_block_bwd_{n_pad}"] = err
        fits = ab._bwd_fits(heads, d, n_pad, -(-n_pad // 128) * 128, 2)
        print(f"  K23 {label}: the JAX _bwd_fits is {fits} at this shape")
    for label, b, n, d, heads in (
            ("K1 at ViT-B/16 @1024 (4104 tokens)", 1, 4104, 768, 12),
            ("K1 at CLIP ViT-L/14 b1 (q-slot reuse)", 1, 264, 1024, 16),
            ("K1 at (1, 1608, 128) (the q-reuse tier)", 1, 1608, 128, 2)):
        x, st, p = _attn_inputs(b, n, d, seed=430)
        _expect_raise(label, lambda: _attn_call(
            ab.attn_block_stats, x, st, _bf16_weights(p, ("wqkv", "wo")),
            heads, n - 7, True))
    x, _, pa = _attn_inputs(1, 4104, 768, seed=431)
    _expect_raise("K4 at ViT-B/16 @1024 (4104 tokens)", lambda: _k4(
        ab.attn_block_fwd, x, pa, 12, 4097, False))
    return errors


def _forward_vs_cpu(label, cfg, params, images, want_launches, long_name,
                    long):
    """``vit.make_forward(cfg)`` on the card with the counts set to 0 just
    before it: exactly ``want_launches`` and ``long`` of ``long_name``'s
    launches past 256 keys; the logits against the CPU forward of the same
    weights within LOGITS_BAND of the largest, top-1 equal.  Returns the
    card's forward and its launches."""
    from vit_fpga_tpu_torch.models import vit
    fwd = vit.make_forward(cfg, params)
    counters = _zero_counters()
    got = fwd(images).float().cpu().numpy()
    torch.cuda.synchronize()
    launches = _check_launches(label, counters, want_launches)
    got_long = counters[long_name].launches_long
    print(f"  {label} launches: { {k: v for k, v in launches.items() if v} }"
          f", {got_long} of {long_name}'s past 256 keys")
    if got_long != long:
        raise AssertionError(f"{label}: {got_long} {long_name} launches past "
                             f"256 keys, want {long}")
    want = vit.make_forward(cfg, _tree_to(params, "cpu"), device="cpu")(
        images).float().numpy()
    _rel_to_max(f"{label} logits vs the CPU forward", got, want, LOGITS_BAND)
    if not np.array_equal(got.argmax(1), want.argmax(1)):
        raise AssertionError(f"{label}: top-1 differs from the CPU forward")
    return fwd, launches


def _chain_want(cfg, batch):
    """The stats chain's launches of a forward at ``batch``: depth K1 and
    depth of the MLP half the chain's plan takes (K2 or K3)."""
    from vit_fpga_tpu_torch.models import vit
    plan = vit._stats_chain_mlp_plan(cfg, batch * vit._n_pad(cfg))
    mlp = "fused_mlp_stats" if plan == "k2" else "fused_mlp_chunked_stats"
    return {"attn_block_stats": cfg.depth, mlp: cfg.depth}


def phase_past_1024_serve(depth=6):
    """The bf16 main path past 1024 tokens, each run with the counts set to
    0 just before it: make_forward at ViT-B/16 @512 b4 and @896 b1 (the
    stats chain: ``depth`` K1, all past 256 keys, and ``depth`` K2), and
    ``safe_softmax`` at @896 b1, depth 2 (K4 and K5), each against the CPU
    forward; preprocess of a (2, 256, 320, 3) uint8 batch (resized to 224)
    against the CPU.  Returns ({JSON row: launches}, {image size:
    config}) for the timing."""
    import dataclasses

    from vit_fpga_tpu_torch.models import vit
    launches, cfgs = {}, {}
    for image, batch, row in ((512, 4, "attn_block_stats_1032"),
                              (896, 1, "attn_block_stats_3144")):
        cfg = vit.config("vit_b16", image_size=image, dtype="bfloat16",
                         depth=depth)
        params = vit.init_params(cfg, _gen(440 + image), device="cuda")
        images = np.random.default_rng(image).integers(
            0, 256, (batch, image, image, 3), np.uint8)
        label = f"ViT-B/16 @{image} b{batch} depth {depth}"
        _, got = _forward_vs_cpu(label, cfg, params, images,
                                 _chain_want(cfg, batch),
                                 "attn_block_stats", depth)
        launches[row] = got["attn_block_stats"]
        cfgs[image] = cfg
    cfg = vit.config("vit_b16", image_size=896, dtype="bfloat16", depth=2,
                     safe_softmax=True)
    params = vit.init_params(cfg, _gen(450), device="cuda")
    images = np.random.default_rng(450).integers(0, 256, (1, 896, 896, 3),
                                                 np.uint8)
    _, got = _forward_vs_cpu("ViT-B/16 @896 b1 safe_softmax depth 2", cfg,
                             params, images, {"attn_block_fwd": 2,
                                              "fused_mlp_fwd": 2},
                             "attn_block_fwd", 2)
    launches["attn_block_fwd_3144"] = got["attn_block_fwd"]

    pcfg = dataclasses.replace(vit.config("vit_b16", dtype="bfloat16"),
                               dtype="float32")
    raw = np.random.default_rng(451).integers(0, 256, (2, 256, 320, 3),
                                              np.uint8)
    got = vit.preprocess(torch.from_numpy(raw).cuda(), pcfg).cpu()
    want = vit.preprocess(torch.from_numpy(raw), pcfg)
    if got.shape != (2, 224, 224, 3):
        raise AssertionError(f"preprocess 256 x 320: shape {got.shape}")
    _compare("preprocess (2, 256, 320, 3) -> 224 f32, card vs CPU", got,
             want, 1e-5, 1e-5)
    got = vit.preprocess(torch.from_numpy(raw).cuda(),
                         vit.config("vit_b16", dtype="bfloat16")).cpu()
    if got.dtype != torch.bfloat16 or not torch.isfinite(got.float()).all():
        raise AssertionError("preprocess 256 x 320 bf16: not finite bf16")
    return launches, cfgs


def phase_past_1024_train(lr=0.1):
    """Training past 1024 tokens, one SGD step each on the card against
    the CPU plain step from the same weights and data: ViT-B/16 @512 b2
    depth 2 and @640 b2 depth 12, where the JAX _bwd_fits keeps the Pallas
    backward (K23 at every layer, counted past 256 keys), and @768 b1
    depth 6 past it (K4 forward, the autograd backward of attn_block_xla:
    0 K23).  Returns {JSON row: K23 launches}."""
    from vit_fpga_tpu_torch.models import vit
    out = {}
    for image, batch, depth, k23 in ((512, 2, 2, True), (640, 2, 12, True),
                                     (768, 1, 6, False)):
        cfg = vit.config("vit_b16", image_size=image, dtype="bfloat16",
                         depth=depth)
        launches, (k4_long, k23_long), *_ = _step_vs_cpu(cfg, batch, lr,
                                                         seed=460 + image)
        print(f"  train step {image} px b{batch} depth {depth} launches: "
              f"{launches}; past 256 keys: K4 {k4_long}, K23 {k23_long}")
        want = {k: depth for k in TRAIN_KERNELS}
        if not k23:
            want["attn_block_bwd"] = 0
        for name, n in launches.items():
            if n != want.get(name, 0):
                raise AssertionError(f"{image} px step: {name} launched {n} "
                                     f"times, want {want.get(name, 0)}")
        if k4_long != depth or k23_long != (depth if k23 else 0):
            raise AssertionError(f"{image} px step: K4 / K23 launches past "
                                 f"256 keys {k4_long} / {k23_long}")
        out[image] = launches["attn_block_bwd"]
    return {"attn_block_bwd_1032": out[512], "attn_block_bwd_1608": out[640]}


def phase_static_ref_1024(depth=2):
    """The calibrated static tree at ViT-B/16 @1024 b1, depth ``depth``,
    where the int8 block kernels do not fit: the JAX ``*_ref`` blocks,
    plain torch on the card (0 K18 / K17, 1 K14 for the head), against the
    CPU forward of the same tree within INT8_LOGITS_BAND, top-1 equal."""
    from vit_fpga_tpu_torch.models import quantized, vit
    cfg = vit.config("vit_b16", image_size=1024, dtype="bfloat16",
                     depth=depth)
    params = vit.init_params(cfg, _gen(470), device="cuda")
    qparams = quantized.quantize_vit_static(params, cfg)
    images = np.random.default_rng(470).integers(0, 256, (1, 1024, 1024, 3),
                                                 np.uint8)
    counters = _zero_counters()
    got = quantized.make_forward_int8(cfg, qparams)(images).float().cpu()
    torch.cuda.synchronize()
    _check_launches("static tree @1024 b1", counters,
                    {"int8_linear_fused": 1})
    want = quantized.make_forward_int8(cfg, _tree_to(qparams, "cpu"),
                                       device="cpu")(images).float()
    _rel_to_max(f"static tree @1024 b1 depth {depth} (the *_ref blocks) "
                f"logits vs the CPU forward", got.numpy(), want.numpy(),
                INT8_LOGITS_BAND)
    if not torch.equal(got.argmax(1), want.argmax(1)):
        raise AssertionError("static tree @1024: top-1 differs from the CPU")


def phase_past_1024_timing():
    """K1 at (16, 1032, 768) and (4, 3144, 768), K4 at (1, 3144, 768) in
    both softmax modes, K23 at (2, 1032, 768) and (2, 1608, 768): each per
    call and device alone beside its plain version, its library yardstick
    and the bound.  Returns {JSON row: times}."""
    out = {}
    out["attn_block_stats_1032"] = _time_k1(16, 1032, 1025, 768, 12, 480,
                                            "ViT-B/16 @512 b16", alone=True)
    out["attn_block_stats_3144"] = _time_k1(4, 3144, 3137, 768, 12, 481,
                                            "ViT-B/16 @896 b4", alone=True)
    for safe in (True, False):
        t = _time_k4_long("ViT-B/16 @896 b1", 1, 3144, 3137, 768, 12, safe,
                          482, alone=True)
        out.setdefault("attn_block_fwd_3144", t)
    out["attn_block_bwd_1032"] = phase_k23_timing(2, 1032, 1025, seed=483,
                                                  alone=True)
    out["attn_block_bwd_1608"] = phase_k23_timing(2, 1608, 1601, seed=484,
                                                  alone=True)
    return out


def phase_past_1024_forward_time(cfgs):
    """The bf16 ViT-B/16 @512 b16 and @896 b4 forwards at full depth: ms
    per batch and img/s, in turns (each twice, the order reversed)."""
    import dataclasses

    from vit_fpga_tpu_torch.models import vit
    from vit_fpga_tpu_torch.utils.timing import time_cuda
    runs = {}
    for image, batch in ((512, 16), (896, 4)):
        cfg = dataclasses.replace(cfgs[image], depth=12)
        fwd = vit.make_forward(cfg, vit.init_params(cfg, _gen(490 + image),
                                                    device="cuda"))
        img = torch.from_numpy(np.random.default_rng(image).integers(
            0, 256, (batch, image, image, 3), np.uint8)).cuda()
        runs[f"ViT-B/16 @{image} b{batch}"] = (fwd, img)
    times = {name: [] for name in runs}
    for name in list(runs) + list(runs)[::-1]:
        fwd, img = runs[name]
        times[name].append(time_cuda(lambda: fwd(img), iters=5, warmup=2))
    for name, ms in times.items():
        b = runs[name][1].shape[0]
        print(f"forward {name} bf16: " + " / ".join(f"{t:.3f}" for t in ms)
              + " ms per batch, " + " / ".join(f"{b / t * 1e3:.1f}"
                                               for t in ms) + " img/s")
    return times


def run_past_1024_phases(errors, timing, launches):
    """Phase 25 after the earlier slices' phases (its parity ran right
    after phase 20's): the served and trained paths past 1024 tokens, the
    static tree at 1024 px, the times; the JSON rows PAST_1024_ROWS."""
    serve_launches, cfgs = phase_past_1024_serve()
    launches.update(serve_launches)
    launches.update(phase_past_1024_train())
    phase_static_ref_1024()
    for name, t in phase_past_1024_timing().items():
        timing[name] = dict(t, max_abs_err=errors[name])
    phase_past_1024_forward_time(cfgs)
    print(_smi_line())


# ---------------------------------------------------------------------------
# Phase 26: the model lifecycle -- an HF checkpoint imported and served, the
# stats chain's gradient, training fed by the data pipeline and resumed from
# a saved state, CLIP's int8 towers and contrastive training, cli serve /
# calibrate
# ---------------------------------------------------------------------------

class _HFStandIn:
    """What ``utils/checkpoint.import_hf_vit`` reads of a transformers
    ``ViTForImageClassification``: its ``config`` and ``state_dict()``
    (the card's machine has no transformers)."""

    def __init__(self, sd, **config):
        import types
        self.config = types.SimpleNamespace(**config)
        self._sd = sd

    def state_dict(self):
        return {k: torch.from_numpy(v) for k, v in self._sd.items()}


def _hf_vit(seed, image=224, patch=16, hidden=768, depth=12, heads=12,
            mlp=3072, classes=1000):
    """A seeded ViT-B/16 checkpoint under ``ViTForImageClassification``'s
    key names (numpy f32): weights 0.02 normal, LN scales 1 + 0.1 normal."""
    rng = np.random.default_rng(seed)

    def w(*shape, std=0.02, mean=0.0):
        return (rng.standard_normal(shape, dtype=np.float32) * std
                + np.float32(mean))

    n = (image // patch) ** 2 + 1
    sd = {"vit.embeddings.cls_token": w(1, 1, hidden),
          "vit.embeddings.position_embeddings": w(1, n, hidden),
          "vit.embeddings.patch_embeddings.projection.weight":
              w(hidden, 3, patch, patch),
          "vit.embeddings.patch_embeddings.projection.bias": w(hidden)}
    for i in range(depth):
        p = f"vit.encoder.layer.{i}."
        for name, (o, k) in (("attention.attention.query", (hidden, hidden)),
                             ("attention.attention.key", (hidden, hidden)),
                             ("attention.attention.value", (hidden, hidden)),
                             ("attention.output.dense", (hidden, hidden)),
                             ("intermediate.dense", (mlp, hidden)),
                             ("output.dense", (hidden, mlp))):
            sd[p + name + ".weight"] = w(o, k)
            sd[p + name + ".bias"] = w(o)
        for ln in ("layernorm_before", "layernorm_after"):
            sd[p + ln + ".weight"] = w(hidden, std=0.1, mean=1.0)
            sd[p + ln + ".bias"] = w(hidden, std=0.1)
    sd["vit.layernorm.weight"] = w(hidden, std=0.1, mean=1.0)
    sd["vit.layernorm.bias"] = w(hidden, std=0.1)
    sd["classifier.weight"] = w(classes, hidden)
    sd["classifier.bias"] = w(classes)
    return _HFStandIn(sd, image_size=image, patch_size=patch,
                      hidden_size=hidden, num_hidden_layers=depth,
                      num_attention_heads=heads, intermediate_size=mlp,
                      layer_norm_eps=1e-12, hidden_act="gelu")


def _top1(label, got, want):
    """Top-1 against the CPU: equal on every row whose two largest CPU
    logits lie further apart than twice the largest |card - CPU| (no
    rounding within that error can flip them).  A row closer than that
    is a near tie of the seeded weights: its pick is printed with its
    margin and is not required to agree."""
    err = float(np.abs(got - want).max())
    top2 = np.sort(want, axis=1)[:, -2:]
    margin = top2[:, 1] - top2[:, 0]
    clear = margin > 2 * err
    same = got.argmax(1) == want.argmax(1)
    print(f"  {label} top-1: equal on {int(same.sum())}/{len(same)} rows "
          f"({int(clear.sum())} with a margin above 2 x {err:.3e})")
    for r in np.flatnonzero(~same):
        print(f"    row {r}: card {int(got[r].argmax())}, CPU "
              f"{int(want[r].argmax())}, CPU margin {margin[r]:.3e}")
    if not same[clear].all():
        raise AssertionError(f"{label}: top-1 disagrees with the CPU")


def _spread_rows(batch, n):
    """``n`` row indices spread over a batch, its first and last row
    among them: a fault in a later tile or image shows."""
    return np.unique(np.linspace(0, batch - 1, n).round().astype(int))


def phase_hf_import(batch=64, n_check=8, dev="cuda", geometry=None):
    """An HF ViT-B/16 checkpoint (1000 classes) through ``import_hf_vit``
    (the config from its geometry, the softmax window calibrated on the
    card) and ``make_forward`` at b64: 12 K1 + 12 K2 launches, the logits
    of ``n_check`` images spread over the batch against the CPU forward in
    LOGITS_BAND with equal top-1 where no rounding can flip it; a ``save_params`` -> ``load_params`` round trip
    serves the same logits bit for bit."""
    import os
    import tempfile
    from vit_fpga_tpu_torch.models import vit
    from vit_fpga_tpu_torch.models.convert import params_from_numpy
    from vit_fpga_tpu_torch.utils import checkpoint as ck
    t0 = time.perf_counter()
    params_np, cfg = ck.import_hf_vit(_hf_vit(30, **(geometry or {})),
                                      device=dev)
    print(f"hf import: ViT {cfg.hidden_dim} x {cfg.depth}, "
          f"{cfg.num_classes} classes, act {cfg.hidden_act}, eps "
          f"{cfg.ln_eps:g}, safe_softmax {cfg.safe_softmax} "
          f"({time.perf_counter() - t0:.1f} s with the calibration probe)")
    if cfg.safe_softmax or cfg.hidden_act != "gelu":
        raise AssertionError("the seeded checkpoint must import cold, gelu")
    images = np.random.default_rng(30).integers(
        0, 256, (batch, cfg.image_size, cfg.image_size, 3), np.uint8)
    fwd = vit.make_forward(cfg, params_from_numpy(params_np, device=dev),
                           device=dev)
    fwd(images)
    counters = _zero_counters()
    got = fwd(images).cpu().numpy()
    _check_launches("hf import b64", counters,
                    {"attn_block_stats": cfg.depth,
                     "fused_mlp_stats": cfg.depth})
    if not np.isfinite(got).all():
        raise AssertionError("hf import: a logit is not finite")
    rows = _spread_rows(batch, n_check)
    want = vit.make_forward(cfg, params_from_numpy(params_np, device="cpu"),
                            device="cpu")(images[rows]).numpy()
    _rel_to_max(f"hf import b{batch}, rows {rows.tolist()} vs CPU",
                got[rows], want, LOGITS_BAND)
    _top1("hf import", got[rows], want)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "vit_b16.npz")
        ck.save_params(path, params_np)
        again = vit.make_forward(
            cfg, params_from_numpy(ck.load_params(path), device=dev),
            device=dev)(images).cpu().numpy()
    print(f"  save_params -> load_params -> serve: logits bit for bit "
          f"{np.array_equal(again, got)}")
    if not np.array_equal(again, got):
        raise AssertionError("the reloaded checkpoint serves other logits")


def _grads_vs(label, got, want, names, band):
    worst, at = 0.0, ""
    for n, a, b in zip(names, got, want):
        rel = float((a - b).norm() / b.norm().clamp_min(1e-30))
        if not rel <= band or not torch.isfinite(a).all():
            raise AssertionError(f"{label}: gradient {n} off by {rel:.3e} "
                                 f"(band {band})")
        if rel > worst:
            worst, at = rel, n
    print(f"  {label}: {len(names)} gradients within {band} in relative "
          f"norm, the worst {worst:.3e} ({at})")


def phase_chain_grad(batch=8, dev="cuda", cfg=None):
    """The gradient of the default-config forward (the stats chain, its
    VJP: ``vit.StatsChainFunction``) at ViT-B/16 b8, on the card and on
    the CPU from the same weights and data: the loss in STEP_LOSS_BAND,
    every gradient in STEP_BAND; the card's run launches 12 K1 + 12 K2
    and no K23 / K24 (nor K4 / K5)."""
    from vit_fpga_tpu_torch.models import vit
    from vit_fpga_tpu_torch.train import trainer as tr
    cfg = cfg or vit.config("vit_b16", dtype="bfloat16")
    if not vit._stats_chain_supported(cfg, batch):
        raise AssertionError("the default config must take the chain")
    base = vit.init_params(cfg, _gen(31), device="cpu")
    images, labels = _train_batch(cfg, batch, seed=31)
    res = {}
    for d in (dev, "cpu"):
        params = _tree_to(base, d)
        leaves = tr.param_leaves(params)
        for leaf in leaves:
            leaf.requires_grad_(True)
        counters = _zero_counters()
        t0 = time.perf_counter()
        loss, _ = tr.vit_loss(params, images.to(d), labels.to(d), cfg)
        loss.backward()
        if d == dev:
            _check_launches("chain gradient", counters,
                            {"attn_block_stats": cfg.depth,
                             "fused_mlp_stats": cfg.depth})
        res[d] = (float(loss.detach()),
                  [p.grad.float().cpu() for p in leaves])
        print(f"chain gradient b{batch} on {d}: loss {res[d][0]:.6f} "
              f"({time.perf_counter() - t0:.1f} s)")
    (lc, gc), (lh, gh) = res[dev], res["cpu"]
    rel = abs(lc - lh) / abs(lh)
    print(f"  loss card vs CPU: rel {rel:.3e} (band {STEP_LOSS_BAND})")
    if not rel <= STEP_LOSS_BAND:
        raise AssertionError("the chain's loss disagrees with the CPU")
    _grads_vs("chain gradient card vs CPU", gc, gh, _leaf_names(base),
              STEP_BAND)


def phase_prefetch_race(n=64 << 20, batches=3, dev="cuda"):
    """``device_prefetch`` hands a batch over only after its copy: 256 MB
    pinned batches (a copy of some 10 ms) are each checked on the
    consuming stream the moment they arrive, so a batch yielded before its
    event is waited on shows up unfilled."""
    from vit_fpga_tpu_torch.runtime.data import device_prefetch
    host = [(torch.full((n,), i + 1, dtype=torch.int32).pin_memory(),)
            for i in range(batches)]
    t0 = time.perf_counter()
    for i, (t,) in enumerate(device_prefetch(host, prefetch=1, device=dev)):
        ok = bool((t == i + 1).all())
        if not ok:
            raise AssertionError(f"device_prefetch: batch {i} was handed "
                                 f"over before its copy finished")
    print(f"prefetch: {batches} batches of {n * 4 >> 20} MiB each whole "
          f"on arrival ({time.perf_counter() - t0:.2f} s)")


def _normalized(batches, cfg):
    """(images, labels) batches with their uint8 images normalized on the
    device they lie on (``vit.preprocess``), as a Trainer's caller does."""
    from vit_fpga_tpu_torch.models import vit
    return ((vit.preprocess(i, cfg), lb) for i, lb in batches)


def _pipeline_batches(cfg, batch, steps, seed, workers=2):
    from vit_fpga_tpu_torch.runtime.data import HostLoader, synthetic_source
    loader = HostLoader(synthetic_source(batch * steps, cfg.image_size,
                                         cfg.num_classes, seed=seed),
                        batch_size=batch, workers=workers)
    return list(loader)


def phase_train_resume(batch=16, steps=4, dev="cuda", cfg=None):
    """Trainer (AdamW) at ViT-B/16 b16 fed by HostLoader + device_prefetch
    for ``steps`` steps (12 K4 + 12 K5 + 12 K23 + 12 K24 a step); then a
    second run saves after step 2 (``Trainer.state`` ->
    ``save_train_state``), restores into a new Trainer
    (``load_train_state`` -> ``Trainer(params=, opt_state=)``) and takes
    the rest: its losses and final parameters bit for bit those of the
    straight run (K4, K5, K23 and K24 sum in a fixed order: no atomics)."""
    import os
    import tempfile
    from vit_fpga_tpu_torch.models import vit
    from vit_fpga_tpu_torch.runtime.data import device_prefetch
    from vit_fpga_tpu_torch.train import trainer as tr
    from vit_fpga_tpu_torch.utils import checkpoint as ck
    cfg = cfg or vit.config("vit_b16", dtype="bfloat16")
    host = _pipeline_batches(cfg, batch, steps, seed=32)
    half = steps // 2

    def fresh():
        return tr.Trainer(cfg, learning_rate=TRAIN_LR, device=dev,
                          params=vit.init_params(cfg, _gen(32), device=dev))

    counters = _zero_counters()
    straight = fresh()
    want = [h["loss"] for h in straight.fit(_normalized(
        device_prefetch(host, prefetch=2, device=dev), cfg))]
    _check_launches(f"train {steps} steps fed by the pipeline", counters,
                    {k: cfg.depth * steps for k in TRAIN_KERNELS})
    first = fresh()
    got = [h["loss"] for h in first.fit(_normalized(
        device_prefetch(host[:half], prefetch=2, device=dev), cfg))]
    state = first.state()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "state.npz")
        ck.save_train_state(path, state)
        restored = ck.load_train_state(path, like=state)
    second = tr.Trainer(cfg, learning_rate=TRAIN_LR, device=dev,
                        params=restored["params"],
                        opt_state=restored["opt_state"])
    got += [h["loss"] for h in second.fit(_normalized(
        device_prefetch(host[half:], prefetch=2, device=dev), cfg))]
    same_params = all(torch.equal(a, b) for a, b in zip(
        tr.param_leaves(second.canonical_params()),
        tr.param_leaves(straight.canonical_params())))
    print(f"train b{batch} through HostLoader + device_prefetch: losses "
          + " ".join(f"{v:.6f}" for v in want))
    print(f"  saved at step {restored['step']} and resumed: losses "
          + " ".join(f"{v:.6f}" for v in got)
          + f"; bit for bit {got == want}, params bit for bit {same_params}")
    if got != want or not same_params or not all(np.isfinite(want)):
        raise AssertionError("the resumed Trainer did not continue exactly")
    if dev != "cuda":
        return
    on_card = [(torch.from_numpy(i).to(dev), torch.from_numpy(lb).to(dev))
               for i, lb in host]
    for name in ("pipeline", "on card"):
        trainer = fresh()
        trainer.fit(_normalized(on_card[:1], cfg))    # warm-up step
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.fit(_normalized(
            device_prefetch(host, prefetch=2, device=dev)
            if name == "pipeline" else on_card, cfg))
        torch.cuda.synchronize()
        print(f"  Trainer.fit b{batch} {name}: "
              f"{(time.perf_counter() - t0) / steps * 1e3:.2f} ms/step over "
              f"{steps} steps")


def phase_clip_int8(batch=64, n_check=4, dev="cuda", cfg=None, cfg_b=None):
    """CLIP ViT-L/14 @224 int8 at b64 (257 tokens on 264 rows,
    quick-GELU): the dynamic tree (24 K16 + 24 K15 a batch) and the static
    tree calibrated on the card (24 K18 + 24 K17), ``n_check`` rows of
    each, spread over the batch (the last M tile and image among them),
    against the CPU plain forward in INT8_LOGITS_BAND; CLIP ViT-B/16
    through ``clip_forward_int8_latency`` at b1 and b4, one K19a (dynamic)
    or K19b (static) launch a call, against the CPU.  Returns the forwards
    and inputs the timing phase reads."""
    from vit_fpga_tpu_torch.models import clip
    from vit_fpga_tpu_torch.models import quantized as q
    cfg = cfg or clip.clip_vision_config("vit_l14", dtype="bfloat16")
    params = clip.init_params(cfg, generator=_gen(33), device=dev)
    rng = np.random.default_rng(33)
    images = rng.integers(0, 256, (batch, cfg.image_size, cfg.image_size, 3),
                          np.uint8)
    kernels = {"dynamic": ("attn_block_int8", "mlp_block_int8"),
               "static": ("attn_block_int8_static", "mlp_block_int8_static")}
    trees = {"dynamic": q.quantize_clip_vision_fast(params),
             "static": q.quantize_clip_vision_static(params, cfg)}
    out = {"l14": {}, "b16": {}, "images": images}
    rows = _spread_rows(batch, n_check)
    for mode, tree in trees.items():
        fwd = q.make_forward_int8(cfg, tree, clip=True, device=dev)
        fwd(images)
        counters = _zero_counters()
        got = fwd(images).cpu().numpy()
        _check_launches(f"CLIP ViT-L/14 int8 {mode} b{batch}", counters,
                        {k: cfg.depth for k in kernels[mode]})
        if not np.isfinite(got).all():
            raise AssertionError(f"CLIP ViT-L/14 int8 {mode}: an embedding "
                                 "is not finite")
        want = q.make_forward_int8(cfg, _tree_to(tree, "cpu"), clip=True,
                                   device="cpu")(images[rows]).numpy()
        _rel_to_max(f"CLIP ViT-L/14 int8 {mode} b{batch}, rows "
                    f"{rows.tolist()} vs CPU", got[rows], want,
                    INT8_LOGITS_BAND)
        out["l14"][mode] = fwd
    cfg_b = cfg_b or clip.clip_vision_config("vit_b16", dtype="bfloat16")
    pb = clip.init_params(cfg_b, generator=_gen(34), device=dev)
    for mode, tree in (("dynamic", q.quantize_clip_vision_fast(pb)),
                       ("static", q.quantize_clip_vision_static(pb, cfg_b))):
        kern = "vit_layers_int8" if mode == "dynamic" else \
            "vit_layers_int8_static"
        fwd = q.make_clip_forward_int8_latency(cfg_b, tree, device=dev)
        cpu = q.make_clip_forward_int8_latency(cfg_b, _tree_to(tree, "cpu"),
                                               device="cpu")
        for b in (1, 4):
            imgs = rng.integers(0, 256, (b, cfg_b.image_size,
                                         cfg_b.image_size, 3), np.uint8)
            fwd(imgs)
            counters = _zero_counters()
            got = fwd(imgs).cpu().numpy()
            _check_launches(f"CLIP ViT-B/16 int8 latency {mode} b{b}",
                            counters, {kern: 1})
            _rel_to_max(f"CLIP ViT-B/16 int8 latency {mode} b{b} vs CPU",
                        got, cpu(imgs).numpy(), INT8_LOGITS_BAND)
            out["b16"][(mode, b)] = (fwd, imgs)
    return out


def _clip_text_ids(batch, ctx, vocab, rng):
    ids = rng.integers(1, vocab - 1, (batch, ctx))
    ends = rng.integers(ctx // 4, ctx, batch)
    ids[np.arange(batch), ends] = vocab - 1          # EOT, the largest id
    ids[np.arange(ctx)[None, :] > ends[:, None]] = 0
    return torch.from_numpy(ids)


def phase_clip_train(batch=16, steps=2, lr=1e-2, dev="cuda", vcfg=None,
                     tcfg=None):
    """``make_clip_train_step``: CLIP ViT-B/16 vision (default config: the
    stats chain and its VJP) with the full text tower (width 512, 8 heads,
    12 layers, context 77) at b16, ``steps`` SGD steps on the card and on
    the CPU from the same weights and data: each step's loss in
    STEP_LOSS_BAND, the first step's gradients in STEP_BAND; 12 K1 + 12 K2
    launches a step on the card and no K23 / K24."""
    from vit_fpga_tpu_torch.models import clip, vit
    from vit_fpga_tpu_torch.train import trainer as tr
    vcfg = vcfg or clip.clip_vision_config("vit_b16", dtype="bfloat16")
    tcfg = tcfg or clip.CLIPTextConfig()
    base = {"vision": clip.init_params(vcfg, generator=_gen(35),
                                       device="cpu"),
            "text": clip.init_text_params(tcfg, _gen(36), device="cpu"),
            "logit_scale": torch.tensor(np.log(1 / 0.07),
                                        dtype=torch.float32)}
    rng = np.random.default_rng(35)
    images = vit.preprocess(torch.from_numpy(rng.integers(
        0, 256, (batch, vcfg.image_size, vcfg.image_size, 3), np.uint8)),
        vcfg).float()
    ids = _clip_text_ids(batch, tcfg.max_positions, tcfg.vocab_size, rng)
    res = {}
    for d in (dev, "cpu"):
        params = _tree_to(base, d)
        step = clip.make_clip_train_step(vcfg, tcfg, tr.sgd(lr))
        opt, losses = None, []
        counters = _zero_counters()
        t0 = time.perf_counter()
        for s in range(steps):
            params, opt, loss = step(params, opt, images.to(d), ids.to(d))
            losses.append(float(loss))
            if s == 0:
                grads = [p.grad.float().cpu()
                         for p in tr.param_leaves(params)]
        if d == dev:
            _check_launches(f"CLIP train {steps} steps", counters,
                            {"attn_block_stats": vcfg.depth * steps,
                             "fused_mlp_stats": vcfg.depth * steps})
        res[d] = (losses, grads)
        print(f"CLIP train b{batch} sgd({lr}) on {d}: losses "
              + " ".join(f"{v:.6f}" for v in losses)
              + f" ({time.perf_counter() - t0:.1f} s)")
    for s, (a, b) in enumerate(zip(res[dev][0], res["cpu"][0])):
        rel = abs(a - b) / abs(b)
        print(f"  step {s} loss card vs CPU: rel {rel:.3e} "
              f"(band {STEP_LOSS_BAND})")
        if not rel <= STEP_LOSS_BAND:
            raise AssertionError("CLIP training disagrees with the CPU")
    _grads_vs("CLIP step-0 gradients card vs CPU", res[dev][1], res["cpu"][1],
              _leaf_names(base), STEP_BAND)


def phase_cli(dev="cuda"):
    """``cli.main(["serve", "model=vit_b16", "batch=64", "images=128"])``
    and ``cli.main(["calibrate"])`` on the card, exit code 0 each; serve
    launches 12 K1 + 12 K2 a batch (its warm-up batch included) and
    nothing else, calibrate no kernel (its probe is plain torch).  Returns
    serve's images per second."""
    import io
    import re
    from vit_fpga_tpu_torch import cli
    extra = [] if dev == "cuda" else ["device=cpu", "image=32",
                                      "model=vit_ti16"]
    out = {}
    for argv in (["serve", "model=vit_b16", "batch=64", "images=128"],
                 ["calibrate"]):
        buf = io.StringIO()
        counters = _zero_counters()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv + extra)
        text = buf.getvalue()
        print(f"cli {' '.join(argv)}: exit {rc}")
        print("  " + text.strip().replace("\n", "\n  "))
        if rc != 0:
            raise AssertionError(f"cli {argv[0]} exited {rc}")
        if argv[0] == "serve":
            m = re.search(r"\(([0-9.]+) img/s\), (\d+) batches", text)
            batches = int(m.group(2)) + 1          # and the warm-up batch
            _check_launches("cli serve", counters,
                            {"attn_block_stats": 12 * batches,
                             "fused_mlp_stats": 12 * batches})
            out["img_s"] = float(m.group(1))
            out["jpeg"] = "jpeg requests" in text
        else:
            _check_launches("cli calibrate", counters, {})
    return out


def _step_ms(step, iters=5):
    from vit_fpga_tpu_torch.utils.timing import time_cuda
    step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = time_cuda(step, iters=iters, warmup=1)
    return ms, torch.cuda.max_memory_allocated() / 2 ** 20


def phase_lifecycle_timing(clip_out, cli_out, batch=16, fit_batch=64,
                           fit_steps=6):
    """The times of the new paths, the card's own (device alone from
    torch.profiler where a forward is timed): CLIP ViT-L/14 int8 b64
    (dynamic, static), CLIP ViT-B/16 int8 latency b1 / b4, the
    default-config SGD step (the chain and its VJP) against the
    safe_softmax per-block step (K4 / K5, K23 / K24) at ViT-B/16 b16 with
    their peak memory, ``Trainer.fit`` fed by the pipeline against batches
    already on the card at b64, and ``cli serve``'s images per second."""
    from vit_fpga_tpu_torch.models import vit
    from vit_fpga_tpu_torch.runtime.data import device_prefetch
    from vit_fpga_tpu_torch.train import trainer as tr
    smi = _smi_line()
    images = torch.from_numpy(clip_out["images"]).cuda()
    for mode, fwd in clip_out["l14"].items():
        ms = _device_alone_ms(lambda: fwd(images), iters=10)
        print(f"time CLIP ViT-L/14 int8 {mode} b{images.shape[0]}: {ms:.3f} "
              f"ms device alone, {images.shape[0] / ms * 1e3:.0f} img/s "
              f"[{smi}]")
    for (mode, b), (fwd, imgs) in clip_out["b16"].items():
        dev_imgs = torch.from_numpy(imgs).cuda()
        ms = _device_alone_ms(lambda: fwd(dev_imgs), iters=50)
        print(f"time CLIP ViT-B/16 int8 latency {mode} b{b}: {ms:.4f} ms "
              f"device alone [{smi}]")

    cfg = vit.config("vit_b16", dtype="bfloat16")
    images, labels = _train_batch(cfg, batch, seed=37)
    images, labels = images.cuda(), labels.cuda()
    for name, safe in (("default config (chain + VJP)", False),
                       ("safe_softmax (K4/K5, K23/K24)", True)):
        c = dataclasses.replace(cfg, safe_softmax=safe)
        params, opt = tr.init_train_state(
            c, tr.sgd(1e-4), params=vit.init_params(c, _gen(37),
                                                    device="cuda"))

        def step():
            opt.zero_grad(set_to_none=True)
            loss, _ = tr.vit_loss(params, images, labels, c)
            loss.backward()
            opt.step()

        ms, peak = _step_ms(step)
        print(f"time SGD step b{batch} {name}: {ms:.3f} ms/step, peak "
              f"{peak:.0f} MiB [{smi}]")

    host = _pipeline_batches(cfg, fit_batch, fit_steps + 1, seed=38,
                             workers=4)
    on_card = [(torch.from_numpy(i).cuda(), torch.from_numpy(lb).cuda())
               for i, lb in host]
    for name in ("pipeline", "on card", "pipeline", "on card"):
        trainer = tr.Trainer(cfg, learning_rate=TRAIN_LR, device="cuda",
                             params=vit.init_params(cfg, _gen(38),
                                                    device="cuda"))
        trainer.fit(_normalized(on_card[:1], cfg))    # warm-up step
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if name == "pipeline":
            from vit_fpga_tpu_torch.runtime.data import (HostLoader,
                                                         synthetic_source)
            src = HostLoader(synthetic_source(
                fit_batch * fit_steps, cfg.image_size, cfg.num_classes,
                seed=38), batch_size=fit_batch, workers=4)
            trainer.fit(_normalized(
                device_prefetch(src, prefetch=2, device="cuda"), cfg))
        else:
            trainer.fit(_normalized(on_card[1:], cfg))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / fit_steps * 1e3
        print(f"time Trainer.fit b{fit_batch} {name}: {ms:.2f} ms/step over "
              f"{fit_steps} steps [{smi}]")
    print(f"time cli serve vit_b16 b64: {cli_out['img_s']:.1f} img/s "
          f"({'jpeg' if cli_out['jpeg'] else 'raw'} requests, 128) [{smi}]")
    from vit_fpga_tpu_torch import cli
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["serve", "model=vit_b16", "batch=64", "images=2048"])
    if rc != 0:
        raise AssertionError(f"cli serve exited {rc}")
    print(f"time cli serve vit_b16 b64, 2048 requests: "
          f"{buf.getvalue().strip().splitlines()[-1]} [{smi}]")


def run_lifecycle_phases():
    """Phase 26 after the earlier slices' phases (the chain gradient and
    the prefetch check ran right after the build): the HF import, train and
    resume, the CLIP int8 towers, CLIP training, the cli, the times."""
    phase_hf_import()
    phase_train_resume()
    clip_out = phase_clip_int8()
    phase_clip_train()
    cli_out = phase_cli()
    phase_lifecycle_timing(clip_out, cli_out)
    print(_smi_line())


# ---------------------------------------------------------------------------
# Phase 27: ViT-H/14 on the card -- head dim 80 in the bf16 and int8
# attention halves (K4, K23, K16, K18), each held beside the same kernel at
# head dim 64 on the same inputs; the model served in bf16 and int8 and
# trained
# ---------------------------------------------------------------------------

# ViT-H/14 @224: 257 tokens on 264 rows, D 1280, M 5120, 16 heads of 80
VIT_H = dict(n_pad=264, n_valid=257, d=1280, m=5120)
# head counts at D 1280 on the same inputs: 16 of 80 (ViT-H/14) and 20 of
# 64, so that a fault of the 80-wide tiles alone shows beside a pass
VIT_H_HEADS = (16, 20)
# (label, batch, n_pad, n_valid, d, heads) at head dim 80: one key tile,
# and a last key tile of one key
DH80_SMALL = (("one key tile", 1, 40, 33, 160, 2),
              ("129 keys", 2, 136, 129, 160, 2))
DH80_ROWS = ("attn_block_fwd_dh80", "attn_block_bwd_dh80",
             "attn_block_int8_dh80", "attn_block_int8_static_dh80")


def _dh(d, heads):
    return f"dh {d // heads}"


def _widened(pa, d):
    """``_attn_inputs``' weights at a width other than 768 scaled by
    sqrt(768 / d), so that q, k, v, the branch and the gradients stand
    against x and g as at D 768, where the bands were set: at D 160
    unscaled BRANCH_TOL reads a bf16 ulp flip of out as 1e-2 itself; at D
    1280 unscaled |dx| reaches 20 and the f64 referee of K23's dx finds the
    plain version itself outside its band on 104-140 of 2.7M elements, and
    11-28 whole rows of 16 896 leave the int8 halves' band, at head dim 64
    exactly as at 80 on the same inputs; scaled, none at either."""
    s = (768 / d) ** 0.5
    return dict(pa, wqkv=pa["wqkv"] * s, wo=pa["wo"] * s)


def _int8_vit_h_loud(kernel, x, q, heads, n_valid):
    """K16 or K18 (``kernel``) with its padding rows of huge spikes (7 at
    ViT-H/14's 257 valid of 264): the valid rows must equal the kernel's
    own on quiet padding rows bit for bit and match the plain version on
    the loud input in the int8 band (K16 with a requantized row's
    allowance, as in phase 16).  Returns the max-abs error."""
    from vit_fpga_tpu_torch.ops import quant_block as qb
    b, n_pad, d = x.shape
    loud = x.clone()
    loud[:, n_valid:] = 0.0
    loud[:, n_valid:, 3] = 3e3
    loud[:, n_valid:, 100] = -1e3
    valid = (slice(None), slice(0, n_valid))
    if kernel == "K16":
        def call(fn, xx):
            return _k16(fn, xx, q, heads, n_valid)
        fns = (qb.attn_block_int8, qb.attn_block_int8_plain)
        step = _k16_step(loud, q, heads, n_valid)
        kw = dict(row_bound=_requant_bound(step, q["wo_q"]))
    else:
        a, _, _ = _static_attn_args(x, q, heads, n_valid)

        def call(fn, xx):
            return _k18(fn, xx, a, heads, n_valid)
        fns = (qb.attn_block_int8_static, qb.attn_block_int8_static_plain)
        step = (127.0 * a["wo_s"]).expand(b, n_pad, d)
        kw = dict(mag_x=True)
    quiet_out, loud_out = call(fns[0], x), call(fns[0], loud)
    label = f"{kernel} loud padding ({b}, {n_pad}, {d}) {_dh(d, heads)}"
    err = _int8_parity(label, loud_out, call(fns[1], loud), step, loud,
                       rows=valid, **kw)
    moved = float((loud_out[valid].float() - quiet_out[valid].float())
                  .abs().max())
    print(f"  {label} valid rows, loud vs quiet padding: max_abs="
          f"{moved:.3e} (must be 0)")
    if moved != 0.0:
        raise AssertionError(f"{kernel}: padding rows moved the valid rows")
    return err


def phase_vit_h14_kernels():
    """Right after the build: K4, K23, K16 and K18 at head dim 80 against
    their plain versions on the card, at ViT-H/14's shapes each beside the
    same kernel at 20 heads of 64 on the same inputs: K4 at (64, 264,
    1280) and (1, 264, 1280) with 257 valid, both softmax modes (loud
    padding bit for bit, the wide scores); K23 at (8, 264, 1280), all
    seven gradients, twice bit for bit; K16 and K18 (quiet and saturating)
    at (64, 264, 1280), with 7 loud padding rows at b4; K4 and K23 also at
    DH80_SMALL; K15 and K17 at ViT-H/14 b64's (16 896, 1280) x 5120, their
    first run at that width; the gates: head dim 96 raises at K4, K23, K16
    and K18, head dim 80 at K1.  Returns {JSON row: largest max-abs error
    of its dh-80 runs}."""
    from vit_fpga_tpu_torch.ops import attn_block as ab
    from vit_fpga_tpu_torch.ops import quant_block as qb
    torch.backends.cuda.matmul.allow_tf32 = False
    n_pad, n_valid, d, m = (VIT_H[k] for k in ("n_pad", "n_valid", "d", "m"))
    worst = dict.fromkeys(DH80_ROWS, 0.0)

    def keep(row, dh, err):
        if dh == 80:
            worst[row] = max(worst[row], err)

    for i, b in enumerate((64, 1)):
        for heads in VIT_H_HEADS:
            keep("attn_block_fwd_dh80", d // heads, _k4_long_parity(
                f"ViT-H/14 @224 b{b} {_dh(d, heads)}", b, n_pad, n_valid, d,
                heads, (True, False), seed=500 + i))
    for j, (label, b, n, nv, dd, heads) in enumerate(DH80_SMALL):
        x, _, pa = _attn_inputs(b, n, dd, seed=505 + j)
        pa = _widened(pa, dd)
        for safe in (True, False):
            name = (f"K4 {label} ({b}, {n}, {dd}) {_dh(dd, heads)} "
                    f"n_valid={nv} safe_softmax={safe}")
            got = _k4(ab.attn_block_fwd, x, pa, heads, nv, safe)
            want = _k4(ab.attn_block_fwd_plain, x, pa, heads, nv, safe)
            torch.cuda.synchronize()
            keep("attn_block_fwd_dh80", 80, _compare(
                f"{name} out", got, want, BF16_TOL, BF16_TOL))
            _branch(f"{name} branch", got, want, x)

    for heads in VIT_H_HEADS:
        keep("attn_block_bwd_dh80", d // heads, _k23_case(
            f"ViT-H/14 @224 b8 {_dh(d, heads)}", 8, n_pad, n_valid, d,
            heads, seed=510, widen=True))
    for j, (label, b, n, nv, dd, heads) in enumerate(DH80_SMALL):
        keep("attn_block_bwd_dh80", 80, _k23_case(
            f"{label} {_dh(dd, heads)}", b, n, nv, dd, heads, seed=511 + j,
            widen=True))

    x, _, p = _attn_inputs(64, n_pad, d, seed=520)
    q = _int8_weights(_widened(p, d), ("wqkv", "wo"))
    valid = (slice(None), slice(0, n_valid))
    for heads in VIT_H_HEADS:
        name = f"K16 ViT-H/14 @224 b64 {_dh(d, heads)}"
        print(f"parity {name} (64, {n_pad}, {d}), {heads} heads, "
              f"n_valid={n_valid}")
        step = _k16_step(x, q, heads, n_valid)
        keep("attn_block_int8_dh80", d // heads, _int8_parity(
            name, _k16(qb.attn_block_int8, x, q, heads, n_valid),
            _k16(qb.attn_block_int8_plain, x, q, heads, n_valid), step, x,
            row_bound=_requant_bound(step, q["wo_q"])))
        for label, shrink in (("quiet", 1.0), ("saturating", SHRINK)):
            a, cx, cao = _static_attn_args(x, q, heads, n_valid, shrink)
            name = f"K18 ViT-H/14 @224 b64 {_dh(d, heads)} {label}"
            print(f"parity {name}: clipped share xq {cx:.3e}, aoq {cao:.3e}")
            if shrink > 1.0 and not min(cx, cao) > 0.0:
                raise AssertionError(f"{name}: nothing clipped")
            keep("attn_block_int8_static_dh80", d // heads, _int8_parity(
                name, _k18(qb.attn_block_int8_static, x, a, heads, n_valid),
                _k18(qb.attn_block_int8_static_plain, x, a, heads, n_valid),
                (127.0 * a["wo_s"]).expand(64, n_pad, d), x, rows=valid,
                mag_x=True))
    for kernel, row in (("K16", "attn_block_int8_dh80"),
                        ("K18", "attn_block_int8_static_dh80")):
        keep(row, 80, _int8_vit_h_loud(kernel, x[:4].contiguous(), q, 16,
                                       n_valid))

    t = 64 * n_pad
    _k15_case(f"ViT-H/14 @224 b64 ({t}, {d}) x {m}", t, d, m, seed=530)
    x2, _, p = _mlp_inputs(t, d, m, seed=531)
    q = _int8_weights(p, ("w1", "w2"))
    for label, shrink in (("quiet", 1.0), ("saturating", SHRINK)):
        a, cx, ch = _static_mlp_args(x2, q, "gelu_tanh", shrink)
        name = f"K17 ViT-H/14 @224 b64 ({t}, {d}) x {m} {label}"
        print(f"parity {name}: clipped share xq {cx:.3e}, hq {ch:.3e}")
        if shrink > 1.0 and not min(cx, ch) > 0.0:
            raise AssertionError(f"{name}: nothing clipped")
        _int8_parity(name, _k17(qb.mlp_block_int8_static, x2, a,
                                "gelu_tanh"),
                     _k17(qb.mlp_block_int8_static_plain, x2, a, "gelu_tanh"),
                     (127.0 * a["w2_s"]).expand(t, d), x2, mag_x=True)
    del x2, q, a

    x96, _, p96 = _attn_inputs(1, 200, 1152, seed=540)   # 12 heads of 96
    q96 = _int8_weights(p96, ("wqkv", "wo"))
    a96, _, _ = _static_attn_args(x96, q96, 12, 197)
    for label, call in (
            ("K4", lambda: _k4(ab.attn_block_fwd, x96, p96, 12, 197, False)),
            ("K23", lambda: _k23(ab.attn_block_bwd, x96, x96, p96, 12, 197)),
            ("K16", lambda: _k16(qb.attn_block_int8, x96, q96, 12, 197)),
            ("K18", lambda: _k18(qb.attn_block_int8_static, x96, a96, 12,
                                 197))):
        _expect_raise(f"{label} at head dim 96", call,
                      match=f"{label} takes head dim 64 or 80")
    xh, sth, ph = _attn_inputs(1, n_pad, d, seed=541)
    _expect_raise("K1 at head dim 80 (ViT-H/14 b1)", lambda: _attn_call(
        ab.attn_block_stats, xh, sth, _bf16_weights(ph, ("wqkv", "wo")), 16,
        n_valid, True), match="K1 takes head dim 64")
    return worst


def _vit_h_want(cfg, batch, int8=None):
    """The counted launches of one ViT-H/14 forward at ``batch``: bf16
    depth K4 (the stats chain's plan is None: 4 MLP chunks) and the MLP
    _mlp_route gives (the plain torch MLP, nothing counted); int8
    ("dynamic" or "static") depth of each int8 half and one K14 (the
    head)."""
    from vit_fpga_tpu_torch.models import vit
    rows = batch * vit._n_pad(cfg)
    if int8 is not None:
        attn, mlp = INT8_SLICE_MODES[int8][2]
        return {attn: cfg.depth, mlp: cfg.depth, "int8_linear_fused": 1}
    if vit._stats_chain_mlp_plan(cfg, rows) is not None:
        raise AssertionError("ViT-H/14 took the stats chain")
    want = {"attn_block_fwd": cfg.depth}
    impl, n_chunks = vit._mlp_route(cfg, rows)
    print(f"  ViT-H/14 b{batch}: the MLP route {impl}, {n_chunks} chunks")
    if impl == "pallas":
        want["fused_mlp_fwd" if n_chunks == 1 else "fused_mlp_chunked"] = \
            cfg.depth
    return want


def _counted(label, fwd, images, want):
    """``fwd(images)`` with the counts set to 0 just before it: exactly
    ``want``; K4's launches (if any) all past 256 keys.  Returns (logits
    on the host, the launches)."""
    counters = _zero_counters()
    got = fwd(images).float().cpu().numpy()
    torch.cuda.synchronize()
    launches = _check_launches(label, counters, want)
    long = counters["attn_block_fwd"].launches_long
    print(f"  {label} launches: { {k: v for k, v in launches.items() if v} }"
          f", K4 past 256 keys {long}")
    if long != want.get("attn_block_fwd", 0):
        raise AssertionError(f"{label}: {long} K4 launches past 256 keys")
    if got.shape != (len(images), 1000) or not np.isfinite(got).all():
        raise AssertionError(f"{label}: logits not finite of shape "
                             f"({len(images)}, 1000)")
    return got, launches


def phase_vit_h14_serve(n_requests=128, batch=64, depth_cpu=4, n_check=4):
    """ViT-H/14 @224 on the card.  Full depth (32): ImageServer over
    make_forward (bf16) answers ``n_requests`` uint8 requests at b64, per
    batch exactly 32 K4 (each past 256 keys) and nothing else counted;
    make_forward_int8 on the dynamic tree (quantize_vit_fast) and on the
    static one (quantize_vit_static) one b64 batch each, 32 K16 + 32 K15
    + 1 K14 and 32 K18 + 32 K17 + 1 K14.  Depth ``depth_cpu`` (full width,
    its own weights): each forward at b64 on the card against the CPU
    forward of ``n_check`` of its images (bf16 in LOGITS_BAND, int8 in
    INT8_LOGITS_BAND, top-1 stated).  Returns ({JSON row: launches},
    {name: (forward, images)} at full depth for the timing, the
    full-depth parameters)."""
    from vit_fpga_tpu_torch.models import quantized, vit
    from vit_fpga_tpu_torch.runtime.serving import ImageServer
    cfg = vit.config("vit_h14", dtype="bfloat16")
    rng = np.random.default_rng(550)
    images = rng.integers(0, 256, (n_requests, cfg.image_size,
                                   cfg.image_size, 3), np.uint8)
    t0 = time.perf_counter()
    params = vit.init_params(cfg, _gen(550), device="cuda")
    print(f"ViT-H/14 @224 depth {cfg.depth}: parameters made in "
          f"{time.perf_counter() - t0:.1f} s")
    fwd = vit.make_forward(cfg, params, raw=True)
    fwd(images[:batch])
    torch.cuda.synchronize()
    want = _vit_h_want(cfg, batch)
    counters = _zero_counters()
    t0 = time.perf_counter()
    with ImageServer(fwd, image_size=cfg.image_size,
                     batch_size=batch) as server:
        results = [f.result(timeout=600) for f in
                   [server.submit_raw(img) for img in images]]
        wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    print(f"ViT-H/14 bf16 serve: {len(results)}/{n_requests} answered in "
          f"{server.batches} batches, {wall:.3f} s, "
          f"{n_requests / wall:.1f} img/s; launches "
          f"{ {k: v for k, v in launches.items() if v} }")
    if len(results) != n_requests or server.served != n_requests:
        raise AssertionError("ViT-H/14: not every request was answered")
    for r in results:
        if r.shape != (cfg.num_classes,) or not np.isfinite(r).all():
            raise AssertionError(f"ViT-H/14: bad logits row {r.shape}")
    for name, n in launches.items():
        if n != want.get(name, 0) * server.batches:
            raise AssertionError(f"ViT-H/14 serve: {name} launched {n} "
                                 f"times in {server.batches} batches")
    if counters["attn_block_fwd"].launches_long != launches["attn_block_fwd"]:
        raise AssertionError("ViT-H/14 serve: K4 launches not all past 256 "
                             "keys")
    rows = {"attn_block_fwd_dh80": launches["attn_block_fwd"]}
    fwds = {"bf16": (fwd, images[:batch])}
    for mode, row in (("dynamic", "attn_block_int8_dh80"),
                      ("static", "attn_block_int8_static_dh80")):
        t0 = time.perf_counter()
        qp = (quantized.quantize_vit_static(params, cfg) if mode == "static"
              else quantized.quantize_vit_fast(params))
        f8 = quantized.make_forward_int8(cfg, qp, raw=True)
        print(f"ViT-H/14 int8 {mode} tree made in "
              f"{time.perf_counter() - t0:.1f} s")
        f8(images[:batch])
        _, got = _counted(f"ViT-H/14 int8 {mode} b{batch}", f8,
                          images[:batch], _vit_h_want(cfg, batch, mode))
        rows[row] = got[INT8_SLICE_MODES[mode][2][0]]
        fwds[mode] = (f8, images[:batch])

    cfg4 = vit.config("vit_h14", dtype="bfloat16", depth=depth_cpu)
    p4 = vit.init_params(cfg4, _gen(551), device="cuda")
    idx = np.linspace(0, batch - 1, n_check).astype(int)
    for mode in ("bf16", "dynamic", "static"):
        label = f"ViT-H/14 {mode} depth {depth_cpu} b{batch}"
        if mode == "bf16":
            tree, make = p4, vit.make_forward
            want, band = _vit_h_want(cfg4, batch), LOGITS_BAND
        else:
            tree = (quantized.quantize_vit_static(p4, cfg4)
                    if mode == "static" else quantized.quantize_vit_fast(p4))
            make = quantized.make_forward_int8
            want, band = _vit_h_want(cfg4, batch, mode), INT8_LOGITS_BAND
        got, _ = _counted(label, make(cfg4, tree), images[:batch], want)
        t0 = time.perf_counter()
        ref = make(cfg4, _tree_to(tree, "cpu"), device="cpu")(
            images[idx]).float().numpy()
        print(f"  {label}: the CPU forward of images {list(idx)} in "
              f"{time.perf_counter() - t0:.1f} s")
        _rel_to_max(f"{label} logits of images {list(idx)} vs the CPU "
                    f"forward", got[idx], ref, band)
        agree = int((got[idx].argmax(1) == ref.argmax(1)).sum())
        print(f"  {label}: top-1 agrees with the CPU on {agree}/{n_check} "
              f"(stated)")
    return rows, fwds, params


def phase_vit_h14_train(params, batch=8, steps=3, depth_cpu=2, lr=0.1):
    """ViT-H/14 @224 trained on the card: Trainer (AdamW, lr TRAIN_LR)
    takes ``steps`` steps at full width and depth (``params``) on one batch
    of ``batch``, each step 32 K4 (all past 256 keys) and 32 K23 and
    nothing else counted (the MLP the plain torch one), every loss finite;
    then one SGD step at depth ``depth_cpu`` b4 on the card against the
    CPU plain step (the loss, every gradient and updated parameter).
    Returns K23's launches in the Trainer's run."""
    from vit_fpga_tpu_torch.models import vit
    from vit_fpga_tpu_torch.train import trainer as tr
    cfg = vit.config("vit_h14", dtype="bfloat16")
    trainer = tr.Trainer(cfg, learning_rate=TRAIN_LR, params=params)
    images, labels = _train_batch(cfg, batch, seed=560)
    images, labels = images.cuda(), labels.cuda()
    counters = _zero_counters()
    counters["attn_block_bwd"].launches_long = 0
    t0 = time.perf_counter()
    hist = trainer.fit([(images, labels)] * steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    losses = [h["loss"] for h in hist]
    print(f"ViT-H/14 Trainer: {steps} AdamW steps at b{batch}, {wall:.2f} s; "
          f"losses " + " ".join(f"{v:.4f}" for v in losses) + "; launches "
          f"{ {k: v for k, v in launches.items() if v} }")
    if not all(np.isfinite(losses)):
        raise AssertionError("ViT-H/14 training loss not finite")
    for name, n in launches.items():
        want = cfg.depth * steps if name in ("attn_block_fwd",
                                             "attn_block_bwd") else 0
        if n != want:
            raise AssertionError(f"ViT-H/14 Trainer: {name} launched {n} "
                                 f"times in {steps} steps, want {want}")
    long = (counters["attn_block_fwd"].launches_long,
            counters["attn_block_bwd"].launches_long)
    if long != (cfg.depth * steps,) * 2:
        raise AssertionError(f"ViT-H/14 Trainer: K4 / K23 launches past 256 "
                             f"keys {long}")
    cfg2 = vit.config("vit_h14", dtype="bfloat16", depth=depth_cpu)
    got, _, *_ = _step_vs_cpu(cfg2, 4, lr, seed=561)
    print(f"  ViT-H/14 depth {depth_cpu} SGD step launches: "
          f"{ {k: v for k, v in got.items() if v} }")
    for name, n in got.items():
        want = depth_cpu if name in ("attn_block_fwd", "attn_block_bwd") else 0
        if n != want:
            raise AssertionError(f"ViT-H/14 step: {name} launched {n} times, "
                                 f"want {want}")
    return launches["attn_block_bwd"]


def _time_int8_half(name, kind, batch, n_pad, n_valid, d, heads, seed):
    """K16 (``kind`` "dynamic") or K18 ("static") at one shape: the
    kernel's time, its plain version's, its library yardstick's (SDPA with
    the key mask) and the bound, device alone too.  Returns a dict of
    times."""
    from vit_fpga_tpu_torch.ops import quant_block as qb
    from vit_fpga_tpu_torch.utils.timing import time_cuda
    x, _, p = _attn_inputs(batch, n_pad, d, seed=seed)
    q = _int8_weights(p, ("wqkv", "wo"))
    if kind == "dynamic":
        def kern():
            return _k16(qb.attn_block_int8, x, q, heads, n_valid)

        def plain():
            return _k16(qb.attn_block_int8_plain, x, q, heads, n_valid)
        lib = _k16_library(x, q, heads, n_valid)
    else:
        a, _, _ = _static_attn_args(x, q, heads, n_valid)

        def kern():
            return _k18(qb.attn_block_int8_static, x, a, heads, n_valid)

        def plain():
            return _k18(qb.attn_block_int8_static_plain, x, a, heads, n_valid)
        lib = _static_library(x, a, "attn", heads, n_valid)
    ops8, flops, nbytes = _k16_work(batch, n_pad, n_valid, d, heads)
    ms = time_cuda(kern)
    plain_ms = time_cuda(plain, iters=5, warmup=1)
    lib_ms = _library_ms(lib, name)
    bound_ms, bound_by = _bound_int8(ops8, flops, nbytes)
    print(f"timing {name} ({batch}, {n_pad}, {d}) {_dh(d, heads)} {n_valid} "
          f"valid: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
          f"{lib_ms} ms, bound {bound_ms:.4f} ms ({bound_by}, "
          f"{ops8 / 1e9:.2f} G int8 ops + {flops / 1e9:.2f} GFLOP bf16, "
          f"{nbytes / 1e6:.2f} MB)")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=bound_ms, bound_by=bound_by,
                **_device_alone_pair(name, kern, lib, lib_ms is not None))


def phase_vit_h14_timing():
    """K4 (both softmax modes) and K16 / K18 at ViT-H/14 b64's (64, 264,
    1280), K23 at the Trainer's (8, 264, 1280): each at 16 heads of 80
    (the JSON rows DH80_ROWS; K4's row its max-free mode, the one serving
    and training run) and, on the same shapes, at 20 heads of 64 beside
    it, per call and device alone against the plain version, the library
    yardstick and the bound.  Returns {JSON row: times}."""
    n_pad, n_valid, d = (VIT_H[k] for k in ("n_pad", "n_valid", "d"))
    out = {}
    for heads in VIT_H_HEADS:
        label = f"ViT-H/14 @224 b64 {_dh(d, heads)}"
        for safe in (True, False):
            t = _time_k4_long(label, 64, n_pad, n_valid, d, heads, safe, 570,
                              alone=True)
            if heads == 16 and not safe:
                out["attn_block_fwd_dh80"] = t
        t = phase_k23_timing(8, n_pad, n_valid, d, heads, seed=571,
                             alone=True)
        if heads == 16:
            out["attn_block_bwd_dh80"] = t
        for kind, row in (("dynamic", "attn_block_int8_dh80"),
                          ("static", "attn_block_int8_static_dh80")):
            t = _time_int8_half(f"{row} ({label})", kind, 64, n_pad, n_valid,
                                d, heads, seed=572)
            if heads == 16:
                out[row] = t
    return out


def phase_vit_h14_forward_time(fwds, iters=5):
    """The ViT-H/14 @224 b64 forwards at full depth, bf16, dynamic and
    static int8: ms per batch and img/s, in turns (each twice, the order
    reversed)."""
    from vit_fpga_tpu_torch.utils.timing import time_cuda
    smi = _smi_line()
    runs = {k: (f, torch.from_numpy(img).cuda()) for k, (f, img) in
            fwds.items()}
    times = {name: [] for name in runs}
    for name in list(runs) + list(runs)[::-1]:
        f, img = runs[name]
        times[name].append(time_cuda(lambda: f(img), iters=iters, warmup=1))
    for name, ms in times.items():
        b = runs[name][1].shape[0]
        print(f"forward ViT-H/14 @224 b{b} {name}: "
              + " / ".join(f"{t:.3f}" for t in ms) + " ms per batch, "
              + " / ".join(f"{b / t * 1e3:.1f}" for t in ms)
              + f" img/s [{smi}]")
    return times


def run_vit_h14_phases(errors, timing, launches):
    """Phase 27 after the earlier slices' phases (its parity ran right
    after the build): ViT-H/14 served in bf16 and int8 and trained, the
    times of K4, K23, K16 and K18 at head dim 80, the forwards' times; the
    JSON rows DH80_ROWS."""
    rows, fwds, params = phase_vit_h14_serve()
    launches.update(rows)
    for name, t in phase_vit_h14_timing().items():
        timing[name] = dict(t, max_abs_err=errors[name])
    phase_vit_h14_forward_time(fwds)
    del fwds
    launches["attn_block_bwd_dh80"] = phase_vit_h14_train(params)
    print(_smi_line())


# ---------------------------------------------------------------------------
# Phase 28: f32 serving (K1, K2 / K3, K4 and K9 in true f32 on the CUDA cores)
# ---------------------------------------------------------------------------

U32 = 2.0 ** -24
# Scores of the hot-logit cases: q and k columns of Wqkv scaled up so that
# most scores lie past the max-free clip window [-70, 80], where the
# max-free softmax and the exact one part.
HOT = 6.0
# The f32 forwards on the card against the port's CPU f32 forward, relative
# to the largest logit: the same function, every rounding point the same
# in f32 (the kernels round nothing to a narrower type), only the order of
# the sums differs; that moves the logits by about 1e-6 of the largest,
# and a wrong mask, softmax or chunk boundary by whole percents.  1e-4
# leaves some 50 times the measured 1.4-1.9e-6, and lies below where TF32
# leaking into the route's torch ops (the embed, the head, K4's plain MLP:
# operands rounded to 10 bits) would move them.
F32_LOGITS_BAND = 1e-4
# The JSON rows of this phase: (name, source, TPU kernel).
F32_ROWS = {
    "attn_block_stats_f32": ("vit_fpga_tpu_torch/csrc/attn_stats.cu",
                             "vit_fpga_tpu/ops/attn_block.py:550"),
    "fused_mlp_chunked_stats_f32": (
        "vit_fpga_tpu_torch/csrc/mlp_chunk_stats.cu",
        "vit_fpga_tpu/ops/fused_mlp.py:305"),
    "fused_mlp_stats_f32": ("vit_fpga_tpu_torch/csrc/mlp_chunk_stats.cu",
                            "vit_fpga_tpu/ops/fused_mlp.py:225"),
    "attn_block_fwd_f32": ("vit_fpga_tpu_torch/csrc/attn_block.cu",
                           "vit_fpga_tpu/ops/attn_block.py:371"),
    "attn_block_fwd_f32_dh80": ("vit_fpga_tpu_torch/csrc/attn_block.cu",
                                "vit_fpga_tpu/ops/attn_block.py:371"),
    "flash_attention_f32": ("vit_fpga_tpu_torch/csrc/flash_attn.cu",
                            "vit_fpga_tpu/ops/flash_attention.py:29"),
}


def _serr(k, mag):
    """The f32 sum band of K26: 2 sqrt(k) 2^-24 sum|terms|."""
    return 2.0 * k ** 0.5 * U32 * mag


def _carry(err, w):
    """An input error ``err`` carried through the product with ``w`` (the
    last axis of err against the first of w), as independent roundings
    add: sqrt(err^2 @ w^2).  K26's band is itself of that kind (2 sqrt(k)
    ulps of the magnitude, where k ulps would be the worst case); carried
    through the next sum by |err| @ |w| instead, three products in a row
    would widen the band by the square roots of their depths, some 10^4
    at ViT-B/16, and hide a wrong kernel."""
    return torch.sqrt((err * err) @ (w * w))


def _f32_attn_inputs(batch, n_pad, d, seed, hot=False):
    """``_attn_inputs`` in f32 (``_widened`` off D 768); ``hot`` scales
    the q and k columns of Wqkv by HOT."""
    x, st, p = _attn_inputs(batch, n_pad, d, seed, torch.float32)
    if d != 768:
        p = _widened(p, d)
    if hot:
        p["wqkv"] = p["wqkv"].clone()
        p["wqkv"][:, :2 * d] *= HOT
    return x, st, p


def _ln_f64(x, st, p):
    """The LayerNorm from (mu, rstd) in f64, with its error magnitude:
    ``st`` given (K1, K2 / K3: the kernel reads the same stats) or None
    (K4: one-pass stats of x taken in the kernel, their f32 sums' error
    carried into xn)."""
    xd = x.double()
    ls, lb = p["ln_scale"].double(), p["ln_bias"].double()
    d = x.shape[-1]
    if st is None:
        mu = xd.mean(-1, keepdim=True)
        msq = (xd * xd).mean(-1, keepdim=True)
        rstd = torch.rsqrt((msq - mu * mu).clamp_min(0.0) + EPS)
    else:
        mu, rstd = st[..., 0:1].double(), st[..., 1:2].double()
    xc = xd - mu
    xn = xc * rstd * ls + lb
    err = 4 * U32 * ((xc.abs() + mu.abs()) * rstd * ls.abs() + lb.abs())
    if st is None:
        e_mu = _serr(d, xd.abs().mean(-1, keepdim=True))
        e_var = _serr(d, msq) + 2 * mu.abs() * e_mu
        e_rstd = 0.5 * rstd ** 3 * e_var + U32 * rstd
        err = err + (rstd * e_mu + xc.abs() * e_rstd) * ls.abs()
    return xd, xn, err


def _softmax_f64(s, e_s, n_valid, mode):
    """e and its error from scores ``s`` and their error ``e_s`` (f64,
    (..., N, N)), keys at or past n_valid masked: "maxfree" exp(clip(s,
    -70, 80)) (no error where the clip holds s), "safe" exp(s - max)."""
    keep = torch.arange(s.shape[-1], device=s.device) < n_valid
    if mode == "maxfree":
        e = torch.exp(s.clamp(-70.0, 80.0))
        inside = ((s > -70.0) & (s < 80.0)).double()
        e_e = e * e_s * inside + U32 * e
    else:
        sm = s.masked_fill(~keep, -float("inf"))
        m, i = sm.max(-1, keepdim=True)
        e = torch.exp(sm - m)
        e_e = e * (e_s + e_s.gather(-1, i)) + U32 * e
    keep = keep.double()
    return e * keep, e_e * keep


def _attend_f64(e, e_e, v, e_v, n_valid):
    """(e v) / sum e and its error (f64)."""
    l = e.sum(-1, keepdim=True)
    e_l = (e_e * e_e).sum(-1, keepdim=True).sqrt() + _serr(n_valid, l)
    pv = e @ v
    e_pv = (torch.sqrt(_carry(e_e, v) ** 2 + _carry(e, e_v) ** 2)
            + _serr(n_valid, e @ v.abs()))
    o = pv / l
    return o, e_pv / l + pv.abs() * e_l / (l * l) + 2 * U32 * o.abs()


def _attn_half_f64(x, st, p, heads, n_valid, safe):
    """The f32 attention half's arithmetic (the plain version's: LN, QKV,
    q scaled, the max-free or exact softmax, e v times 1 / sum e, the
    out-projection and residual) in f64: (out, band), where band is the
    f32 sum band of K26 carried through every stage to out, first order.
    ``st`` None: the stats taken from x (K4)."""
    b, n, d = x.shape
    dh = d // heads
    scale = 1.0 / dh ** 0.5
    xd, xn, e_xn = _ln_f64(x, st, p)
    wq, wo = p["wqkv"].double(), p["wo"].double()
    bq, bo = p["bqkv"].double(), p["bo"].double()
    qkv = xn @ wq + bq
    e_qkv = _serr(d + 1, xn.abs() @ wq.abs() + bq.abs()) + _carry(e_xn, wq)

    def split(t):
        return t.reshape(b, n, 3, heads, dh).permute(2, 0, 3, 1, 4)

    q, k, v = split(qkv)
    eq, ek, ev = split(e_qkv)
    q, eq = q * scale, eq * scale + U32 * (q * scale).abs()
    s = q @ k.transpose(-1, -2)
    e_s = (_serr(dh, q.abs() @ k.abs().transpose(-1, -2))
           + torch.sqrt(_carry(eq, k.transpose(-1, -2)) ** 2
                        + _carry(ek, q.transpose(-1, -2)).transpose(-1, -2)
                        ** 2))
    e, e_e = _softmax_f64(s, e_s, n_valid, "safe" if safe else "maxfree")
    ao, e_ao = _attend_f64(e, e_e, v, ev, n_valid)
    ao = ao.transpose(1, 2).reshape(b, n, d)
    e_ao = e_ao.transpose(1, 2).reshape(b, n, d)
    out = xd + (ao @ wo + bo)
    band = (_serr(d + 2, xd.abs() + ao.abs() @ wo.abs() + bo.abs())
            + _carry(e_ao, wo))
    return out, band


def _mlp_half_f64(x, st, p, act):
    """The f32 MLP half's arithmetic in f64 (chunk boundaries change only
    the order of the sum): (out, band) as :func:`_attn_half_f64`'s; the
    activation's error is its input's times 1.2 (every activation's slope
    stays below it) plus 16 ulps of its input."""
    from vit_fpga_tpu_torch.ops import fused_mlp as fm
    d, m = p["w1"].shape
    xd, xn, e_xn = _ln_f64(x, st, p)
    w1, w2 = p["w1"].double(), p["w2"].double()
    b1, b2 = p["b1"].double(), p["b2"].double()
    hp = xn @ w1 + b1
    e_hp = _serr(d + 1, xn.abs() @ w1.abs() + b1.abs()) + _carry(e_xn, w1)
    h = fm._act(hp, act)
    e_h = 1.2 * e_hp + 16 * U32 * hp.abs()
    out = xd + (h @ w2 + b2)
    band = (_serr(m + 2, xd.abs() + h.abs() @ w2.abs() + b2.abs())
            + _carry(e_h, w2))
    return out, band


def _flash_f64(qkv, heads, n_valid):
    """K9's function on packed qkv in f64 (the exact softmax, the scale
    after the products): (o (B, N, D), band)."""
    from vit_fpga_tpu_torch.ops import attention as at
    b, n, d3 = qkv.shape
    q, k, v = (t.double() for t in at._heads(qkv, heads))
    dh = q.shape[-1]
    scale = 1.0 / dh ** 0.5
    s = (q @ k.transpose(-1, -2)) * scale
    e_s = (_serr(dh, q.abs() @ k.abs().transpose(-1, -2)) * scale
           + U32 * s.abs())
    e, e_e = _softmax_f64(s, e_s, n_valid, "safe")
    o, e_o = _attend_f64(e, e_e, v, torch.zeros_like(v), n_valid)
    return (o.transpose(1, 2).reshape(b, n, d3 // 3),
            e_o.transpose(1, 2).reshape(b, n, d3 // 3))


def _f32_gate(label, got, want, ref):
    """An f32 kernel against its plain version on the card: |a - b| <=
    F32_SUM_ATOL (1 + |b|) + band, ``ref`` = (the arithmetic in f64, the
    band: K26's sum band carried through the stages).  An element outside
    it must lie inside the same bound around the f64 value (the referee);
    the plain version's own count there is printed.  Returns max |a-b|."""
    torch.cuda.synchronize()
    r64, band = ref
    g, w = got.double(), want.double()
    diff = (g - w).abs()
    tol = F32_SUM_ATOL * (1 + w.abs()) + band
    out = diff > tol
    max_abs = float(diff.max())
    print(f"  {label}: max_abs={max_abs:.3e}, max |a-b| / bound "
          f"{float((diff / tol).max()):.3e}, {int(out.sum())} of "
          f"{out.numel()} outside 1e-5 (1+|b|) + the carried f32 sum band")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{label}: non-finite output")
    if out.any():
        tol_r = F32_SUM_ATOL * (1 + r64.abs()) + band
        still = int((out & ((g - r64).abs() > tol_r)).sum())
        own = int(((w - r64).abs() > tol_r).sum())
        print(f"  {label}: against the f64 arithmetic {still} of those "
              f"outside it (must be 0; the plain version's own: {own})")
        if still:
            raise AssertionError(f"{label}: kernel disagrees with its plain "
                                 f"version")
    return max_abs


def _f32_stats(label, got_out, got_st, want_st):
    """The emitted stats: those of the kernel's own f32 output (the same
    one-pass function, sums in another order) and the plain version's."""
    from vit_fpga_tpu_torch.ops.common import row_stats
    own = row_stats(got_out, EPS)
    _compare(f"{label} stats vs its own output's", got_st, own, STATS_RTOL,
             STATS_ATOL)
    _compare(f"{label} stats vs the plain version's", got_st, want_st,
             STATS_RTOL, STATS_ATOL)


def _f32_k1_case(label, batch, n_pad, n_valid, d, heads, seed, hot=False):
    """K1 f32 against its plain version and the f64 arithmetic: out and
    the emitted stats; the hot case must have scores past the clip and
    must part from the exact softmax."""
    from vit_fpga_tpu_torch.ops import attn_block as ab
    from vit_fpga_tpu_torch.utils.platform import true_f32
    x, st, p = _f32_attn_inputs(batch, n_pad, d, seed, hot)
    name = f"K1 f32 {label} ({batch}, {n_pad}, {d}) {heads} heads " \
           f"n_valid={n_valid}"
    before = ab.attn_block_stats.launches_f32
    got, got_st = _attn_call(ab.attn_block_stats, x, st, p, heads, n_valid,
                             True)
    if ab.attn_block_stats.launches_f32 != before + 1:
        raise AssertionError(f"{name}: no f32 launch counted")
    with true_f32():
        want, want_st = _attn_call(ab.attn_block_stats_plain, x, st, p,
                                   heads, n_valid, True)
        ref = _attn_half_f64(x, st, p, heads, n_valid, False)
    err = _f32_gate(name, got, want, ref)
    _f32_stats(name, got, got_st, want_st)
    if hot:
        _f32_hot(name, got, x, st, p, heads, n_valid, ref)
    return err


def _f32_hot(name, got, x, st, p, heads, n_valid, ref):
    """The hot-logit case discriminates: some scores lie past 80 and the
    kernel stands far nearer the max-free arithmetic than the exact
    softmax's."""
    with torch.no_grad():
        _, band = ref
        exact, _ = _attn_half_f64(x, st, p, heads, n_valid, True)
        d = x.shape[-1]
        xn = _ln_f64(x, st, p)[1]
        qk = (xn @ p["wqkv"].double()[:, :2 * d]).reshape(
            *x.shape[:2], 2, heads, d // heads)
        s = (qk[:, :, 0].transpose(1, 2) * (heads / d) ** 0.5) @ \
            qk[:, :, 1].permute(0, 2, 3, 1)
        past = float((s[..., :n_valid] > 80.0).double().mean())
        apart = float((exact - ref[0]).abs().max())
        off = float((got.double() - exact).abs().max())
    print(f"  {name}: {past:.2%} of the valid scores past 80; the exact "
          f"softmax's out lies {apart:.3e} from the max-free one, the "
          f"kernel {off:.3e} from the exact one")
    if not past > 0 or not off > 100 * float(band.max()):
        raise AssertionError(f"{name}: the hot case does not separate the "
                             f"two softmaxes")


def _f32_k4_case(label, batch, n_pad, n_valid, d, heads, seed, safe,
                 hot=False):
    from vit_fpga_tpu_torch.ops import attn_block as ab
    from vit_fpga_tpu_torch.utils.platform import true_f32
    x, st, p = _f32_attn_inputs(batch, n_pad, d, seed, hot)
    mode = "safe" if safe else "max-free"
    name = (f"K4 f32 {mode} {label} ({batch}, {n_pad}, {d}) {heads} heads "
            f"n_valid={n_valid}")
    before = (ab.attn_block_fwd.launches_f32, ab.attn_block_fwd.launches_long)
    got = _k4(ab.attn_block_fwd, x, p, heads, n_valid, safe)
    after = (ab.attn_block_fwd.launches_f32, ab.attn_block_fwd.launches_long)
    if after != (before[0] + 1, before[1] + int(n_valid > 256)):
        raise AssertionError(f"{name}: counted {after} after {before}")
    with true_f32():
        want = _k4(ab.attn_block_fwd_plain, x, p, heads, n_valid, safe)
        ref = _attn_half_f64(x, None, p, heads, n_valid, safe)
    err = _f32_gate(name, got, want, ref)
    if hot and not safe:
        _f32_hot(name, got, x, None, p, heads, n_valid, ref)
    return err


def _f32_loud(name, call, x, n_valid):
    """Padding rows of x times 1e4: the valid rows must come back bit for
    bit (their keys are masked, every row is its own)."""
    loud = x.clone()
    loud[:, n_valid:] *= 1e4
    quiet, noisy = call(x), call(loud)
    torch.cuda.synchronize()
    moved = float((noisy[:, :n_valid] - quiet[:, :n_valid]).abs().max())
    print(f"  {name} loud padding rows: valid rows moved by {moved:.3e} "
          f"(must be 0)")
    if moved != 0.0 or not torch.isfinite(noisy[:, :n_valid]).all():
        raise AssertionError(f"{name}: padding rows moved the valid rows")


def _f32_mlp_case(label, rows, d, m, seed, act, n_chunks):
    """K3 (n_chunks > 1) or K2 in f32 against the plain version and the
    f64 arithmetic, with the emitted stats."""
    from vit_fpga_tpu_torch.ops import fused_mlp as fm
    from vit_fpga_tpu_torch.utils.platform import true_f32
    x, st, p = _mlp_inputs(rows, d, m, seed, torch.float32)
    kern = "K3" if n_chunks > 1 else "K2"
    name = f"{kern} f32 {label} ({rows}, {d}) x {m} {act}" + (
        f" n_chunks={n_chunks}" if n_chunks > 1 else "")
    if n_chunks > 1:
        fn = fm.fused_mlp_chunked_stats
        plain = fm.fused_mlp_chunked_stats_plain
        kw = dict(n_chunks=n_chunks)
    else:
        fn, plain, kw = fm.fused_mlp_stats, fm.fused_mlp_stats_plain, {}
    before = fn.launches_f32
    got, got_st = fn(x, st, p["ln_scale"], p["ln_bias"], p["w1"], p["b1"],
                     p["w2"], p["b2"], eps=EPS, act=act, **kw)
    if fn.launches_f32 != before + 1:
        raise AssertionError(f"{name}: no f32 launch counted")
    with true_f32():
        want, want_st = plain(x, st, p["ln_scale"], p["ln_bias"], p["w1"],
                              p["b1"], p["w2"], p["b2"], eps=EPS, act=act,
                              **kw)
        ref = _mlp_half_f64(x, st, p, act)
    err = _f32_gate(name, got, want, ref)
    _f32_stats(name, got, got_st, want_st)
    return err


def _f32_k9_case(label, n, n_valid, seed):
    """K9 f32 on ViT-B/16's packed qkv (1, n, 2304), 12 heads, against
    its plain version (bk 128) and the f64 arithmetic; loud padding keys
    must leave the valid rows bit for bit."""
    from vit_fpga_tpu_torch.ops import flash_attention as fa
    from vit_fpga_tpu_torch.utils.platform import true_f32
    qkv = _seq_qkv(1, n, 768, seed, dtype=torch.float32, std=1.0)
    name = f"K9 f32 {label} (1, {n}, 2304) n_valid={n_valid}"
    before = fa.flash_attention.launches_f32
    got = _k9(qkv, 12, n_valid, fa.flash_attention)
    if fa.flash_attention.launches_f32 != before + 1:
        raise AssertionError(f"{name}: no f32 launch counted")
    with true_f32():
        want = _k9(qkv, 12, n_valid, fa.flash_attention_plain)
        ref = _flash_f64(qkv, 12, n_valid)
    err = _f32_gate(name, got, want, ref)
    if n_valid < n:
        _unmoved(name, lambda t: _k9(t, 12, n_valid, fa.flash_attention),
                 qkv, n_valid)
    return err


def phase_f32_kernels():
    """K1, K2 / K3, K4 and K9 in f32 against their plain versions on the
    card (TF32 off) at the f32 serves' shapes, each element within K26's
    f32 sum band carried through the stages or, outside it, within that
    band of the same arithmetic in f64: K1 at ViT-B/16 b64, b8 hot logits
    (scores past 80), @640's 1601 tokens and ViT-S/16 b64, its emitted
    stats; K3 at ViT-B/16 b64 (2 chunks, erf-GELU) and each activation in
    4 chunks; K2 at ViT-S/16 b64 and each activation; K4 at b1 / b3 both
    modes, b64 safe, hot logits both modes, ViT-L/16 and ViT-H/14 (head
    dim 80) both modes; K9 at ViT-B/16 @1024 and @896 b1; loud padding
    bit for bit; the f32 gates.  Returns {JSON row: max-abs error}."""
    from vit_fpga_tpu_torch.ops import attn_block as ab
    from vit_fpga_tpu_torch.ops import flash_attention as fa
    from vit_fpga_tpu_torch.ops import fused_mlp as fm
    print("phase 28: the f32 kernels against their plain versions")
    errs = dict.fromkeys(F32_ROWS, 0.0)

    def put(row, err):
        errs[row] = max(errs[row], err)

    put("attn_block_stats_f32", _f32_k1_case("ViT-B/16 b64", 64, 200, 197,
                                             768, 12, 600))
    put("attn_block_stats_f32", _f32_k1_case("hot logits", 8, 200, 197, 768,
                                             12, 601, hot=True))
    put("attn_block_stats_f32", _f32_k1_case("@640", 2, 1608, 1601, 768, 12,
                                             602))
    put("attn_block_stats_f32", _f32_k1_case("ViT-S/16 b64", 64, 200, 197,
                                             384, 6, 603))
    x, st, p = _f32_attn_inputs(8, 200, 768, 604)
    _f32_loud("K1 f32 (8, 200, 768)", lambda t: _attn_call(
        ab.attn_block_stats, t, st, p, 12, 197, False)[0], x, 197)

    put("fused_mlp_chunked_stats_f32", _f32_mlp_case(
        "ViT-B/16 b64", 12800, 768, 3072, 610, "gelu", 2))
    for act in MLP_ACTS_ALL:
        put("fused_mlp_chunked_stats_f32", _f32_mlp_case(
            "4 chunks", 1000, 256, 1024, 611, act, 4))
        put("fused_mlp_stats_f32", _f32_mlp_case("", 1000, 256, 1024, 612,
                                                 act, 1))
    put("fused_mlp_stats_f32", _f32_mlp_case("ViT-S/16 b64", 12800, 384,
                                             1536, 613, "gelu", 1))

    for batch in (1, 3):
        for safe in (False, True):
            put("attn_block_fwd_f32", _f32_k4_case(
                "ViT-B/16", batch, 200, 197, 768, 12, 620 + batch, safe))
    put("attn_block_fwd_f32", _f32_k4_case("ViT-B/16 b64", 64, 200, 197,
                                           768, 12, 624, True))
    for safe in (False, True):
        put("attn_block_fwd_f32", _f32_k4_case(
            "hot logits", 4, 200, 197, 768, 12, 625, safe, hot=True))
        put("attn_block_fwd_f32", _f32_k4_case(
            "ViT-L/16", 2, 200, 197, 1024, 16, 626, safe))
        put("attn_block_fwd_f32_dh80", _f32_k4_case(
            "ViT-H/14", 2, 264, 257, 1280, 16, 627, safe))
    put("attn_block_fwd_f32_dh80", _f32_k4_case(
        "ViT-H/14 hot logits", 2, 264, 257, 1280, 16, 628, False, hot=True))
    x, _, p = _f32_attn_inputs(4, 200, 768, 629)
    for safe in (False, True):
        _f32_loud(f"K4 f32 safe={safe} (4, 200, 768)",
                  lambda t, s=safe: _k4(ab.attn_block_fwd, t, p, 12, 197, s),
                  x, 197)

    put("flash_attention_f32", _f32_k9_case("ViT-B/16 @1024", 4104, 4097,
                                            630))
    put("flash_attention_f32", _f32_k9_case("ViT-B/16 @896", 3144, 3137,
                                            631))

    # the f32 gates: the JAX plans at itemsize 4, and the f32 modes not
    # ported yet, each raising with its kernel's name
    xl, stl, pl = _f32_attn_inputs(1, 2312, 768, 632)
    _expect_raise("K1 f32 at ViT-B/16 @768 (2312 rows)", lambda: _attn_call(
        ab.attn_block_stats, xl, stl, pl, 12, 2305, False))
    xl, _, pl = _f32_attn_inputs(1, 3144, 768, 633)
    _expect_raise("K4 f32 at ViT-B/16 @896 (3144 rows)", lambda: _k4(
        ab.attn_block_fwd, xl, pl, 12, 3137, False))
    q80 = torch.zeros(1, 1, 256, 80, device="cuda")
    _expect_raise("K9 f32 head dim 80", lambda: fa.flash_attention(
        q80, q80, q80), match="K9")
    x2, st2, pm = _mlp_inputs(64, 256, 1024, 634, torch.float32)
    _expect_raise("K5 f32", lambda: _k5(fm.fused_mlp_fwd, x2, pm, "relu"),
                  match="K5")
    _expect_raise("K6 f32", lambda: _k6_call(fm.fused_mlp_chunked_fwd, x2,
                                             pm, "relu", 2),
                  match="K6")
    _expect_raise("K24 f32", lambda: _k24(fm.fused_mlp_bwd, x2, x2, pm,
                                          "relu"), match="K24")
    xa, _, pa = _f32_attn_inputs(1, 200, 768, 635)
    _expect_raise("K23 f32", lambda: _k23(ab.attn_block_bwd, xa, xa, pa, 12,
                                          197), match="K23")
    return errs


def _f32_cpu_check(label, cfg, params, images, got, band=F32_LOGITS_BAND,
                   make=None):
    """The CPU forward of ``images`` (the port's f32 plain path) against
    the card's logits ``got``: within ``band`` of the largest logit."""
    from vit_fpga_tpu_torch.models import vit
    make = make or vit.make_forward
    t0 = time.perf_counter()
    ref = make(cfg, _tree_to(params, "cpu"), device="cpu")(images)
    ref = ref.float().numpy()
    print(f"  {label}: the CPU forward of {len(images)} images in "
          f"{time.perf_counter() - t0:.1f} s")
    _rel_to_max(f"{label} logits vs the CPU f32 forward", got, ref, band)
    agree = int((got.argmax(1) == ref.argmax(1)).sum())
    print(f"  {label}: top-1 agrees with the CPU on {agree}/{len(images)} "
          f"(stated)")


def _f32_counted(label, fwd, images, want, long=0):
    """``fwd(images)`` with the counts set to 0 just before it: exactly
    ``want``, every launch of K1, K2, K3, K4 and K9 in f32 (no bf16 kernel
    launched), K1's / K4's past 256 keys ``long``.  Returns (logits on the
    host, launches)."""
    counters = _zero_counters()
    f32_names = ("attn_block_stats", "fused_mlp_stats",
                 "fused_mlp_chunked_stats", "attn_block_fwd",
                 "flash_attention")
    for k in f32_names:
        counters[k].launches_f32 = 0
    got = fwd(images).float().cpu().numpy()
    torch.cuda.synchronize()
    launches = _check_launches(label, counters, want)
    for k in f32_names:
        if counters[k].launches_f32 != launches[k]:
            raise AssertionError(f"{label}: {k} launched {launches[k]} "
                                 f"times, {counters[k].launches_f32} in f32")
    got_long = (counters["attn_block_stats"].launches_long
                + counters["attn_block_fwd"].launches_long)
    print(f"  {label} launches (all f32): "
          f"{ {k: v for k, v in launches.items() if v} }, past 256 keys "
          f"{got_long}")
    if got_long != long:
        raise AssertionError(f"{label}: {got_long} launches past 256 keys, "
                             f"want {long}")
    if not np.isfinite(got).all() or got.shape[0] != len(images):
        raise AssertionError(f"{label}: logits not finite")
    return got, launches


def phase_f32_serve(n_requests=160, batch=64, n_check=4):
    """The f32 serves through the normal entry points, each with exact
    launch counts and no bf16 kernel launch: ImageServer over
    make_forward(vit_b16, float32) answers ``n_requests`` uint8 requests
    (2 full batches of 64 and a partial flush), 12 K1 + 12 K3 in f32 a
    batch, logits of ``n_check`` images against the CPU f32 forward at
    full depth; ViT-B/16 b1 (12 K4 f32, the plain MLP) at full depth;
    ViT-B/16 @1024 b1 and the per-tensor int8 forward @1024 b1 at depth 2
    (2 K9 f32; + 10 K13); ViT-H/14 at depth 2 b2 (2 K4 f32 at head dim 80,
    past 256 keys); ViT-S/16 b64 at depth 2 (2 K1 + 2 K2 f32).  Returns
    ({JSON row: launches}, the b64 forward and its images)."""
    from vit_fpga_tpu_torch.models import quantized, vit
    from vit_fpga_tpu_torch.runtime.serving import ImageServer
    rows = dict.fromkeys(F32_ROWS, 0)
    rng = np.random.default_rng(640)
    cfg = vit.config("vit_b16", dtype="float32")
    images = rng.integers(0, 256, (n_requests, 224, 224, 3), np.uint8)
    params = vit.init_params(cfg, _gen(640), device="cuda")
    fwd = vit.make_forward(cfg, params)
    fwd(images[:batch])
    torch.cuda.synchronize()
    want = {"attn_block_stats": 12, "fused_mlp_chunked_stats": 12}
    got, _ = _f32_counted(f"ViT-B/16 f32 b{batch}", fwd, images[:batch],
                          want)
    idx = np.linspace(0, batch - 1, n_check).astype(int)
    _f32_cpu_check(f"ViT-B/16 f32 b{batch} (depth 12)", cfg, params,
                   images[idx], got[idx])
    counters = _zero_counters()
    for k in ("attn_block_stats", "fused_mlp_chunked_stats"):
        counters[k].launches_f32 = 0
    t0 = time.perf_counter()
    with ImageServer(fwd, image_size=224, batch_size=batch) as server:
        results = [f.result(timeout=600) for f in
                   [server.submit_raw(img) for img in images]]
    wall = time.perf_counter() - t0
    launches = _check_launches("ViT-B/16 f32 serve", counters,
                               {k: 12 * server.batches for k in want})
    print(f"ViT-B/16 f32 serve: {len(results)}/{n_requests} answered in "
          f"{server.batches} batches, {wall:.3f} s; launches "
          f"{ {k: v for k, v in launches.items() if v} }")
    if (len(results) != n_requests or server.served != n_requests
            or any(counters[k].launches_f32 != launches[k] for k in want)):
        raise AssertionError("ViT-B/16 f32 serve: requests unanswered or a "
                             "bf16 launch")
    for r in results:
        if r.shape != (1000,) or not np.isfinite(r).all():
            raise AssertionError(f"ViT-B/16 f32 serve: bad row {r.shape}")
    np.testing.assert_allclose(np.stack(results[:batch]), got, rtol=0,
                               atol=F32_LOGITS_BAND * np.abs(got).max())
    rows["attn_block_stats_f32"] += launches["attn_block_stats"]
    rows["fused_mlp_chunked_stats_f32"] += launches["fused_mlp_chunked_stats"]

    got1, l1 = _f32_counted("ViT-B/16 f32 b1", fwd, images[:1],
                            {"attn_block_fwd": 12})
    _f32_cpu_check("ViT-B/16 f32 b1 (depth 12)", cfg, params, images[:1],
                   got1)
    rows["attn_block_fwd_f32"] += l1["attn_block_fwd"]
    del fwd, params

    c1024 = vit.config("vit_b16", image_size=1024, dtype="float32", depth=2)
    p1024 = vit.init_params(c1024, _gen(641), device="cuda")
    img1024 = rng.integers(0, 256, (1, 1024, 1024, 3), np.uint8)
    f1024 = vit.make_forward(c1024, p1024)
    f1024(img1024)
    got, l9 = _f32_counted("ViT-B/16 @1024 f32 b1 depth 2", f1024, img1024,
                           {"flash_attention": 2})
    _f32_cpu_check("ViT-B/16 @1024 f32 b1 (depth 2)", c1024, p1024, img1024,
                   got)
    rows["flash_attention_f32"] += l9["flash_attention"]
    qt = quantized.quantize_vit(p1024)
    fq = quantized.make_vit_forward_int8(c1024, qt)
    fq(img1024)
    got, l9 = _f32_counted("per-tensor int8 @1024 b1 depth 2", fq, img1024,
                           {"flash_attention": 2, "int8_gemm": 10})
    _f32_cpu_check("per-tensor int8 @1024 b1 (depth 2)", c1024, qt, img1024,
                   got, PER_TENSOR_BAND, quantized.make_vit_forward_int8)
    rows["flash_attention_f32"] += l9["flash_attention"]
    del f1024, fq, p1024, qt

    ch = vit.config("vit_h14", dtype="float32", depth=2)
    ph = vit.init_params(ch, _gen(642), device="cuda")
    imgh = rng.integers(0, 256, (2, 224, 224, 3), np.uint8)
    fh = vit.make_forward(ch, ph)
    fh(imgh)
    got, lh = _f32_counted("ViT-H/14 f32 b2 depth 2", fh, imgh,
                           {"attn_block_fwd": 2}, long=2)
    _f32_cpu_check("ViT-H/14 f32 b2 (depth 2)", ch, ph, imgh, got)
    rows["attn_block_fwd_f32_dh80"] += lh["attn_block_fwd"]
    del fh, ph

    cs = vit.config("vit_s16", dtype="float32", depth=2)
    ps = vit.init_params(cs, _gen(643), device="cuda")
    fs = vit.make_forward(cs, ps)
    fs(images[:batch])
    got, ls_ = _f32_counted(f"ViT-S/16 f32 b{batch} depth 2", fs,
                            images[:batch],
                            {"attn_block_stats": 2, "fused_mlp_stats": 2})
    _f32_cpu_check(f"ViT-S/16 f32 b{batch} (depth 2)", cs, ps, images[idx],
                   got[idx])
    rows["attn_block_stats_f32"] += ls_["attn_block_stats"]
    rows["fused_mlp_stats_f32"] += ls_["fused_mlp_stats"]
    return rows, images[:batch]


def _f32_mlp_library(x, p):
    """LN + addmm + erf-GELU + addmm + residual in f32."""
    import torch.nn.functional as F
    d = x.shape[1]

    def library():
        xn = F.layer_norm(x, (d,), p["ln_scale"], p["ln_bias"], EPS)
        h = F.gelu(torch.addmm(p["b1"], xn, p["w1"]))
        return torch.addmm(p["b2"], h, p["w2"]) + x

    return library


def _f32_timed(row, label, kern, bf16_kern, plain, library, flops, nbytes):
    """One f32 kernel's time: CUDA events per call, device alone in turns
    with the bf16 kernel at the same shape (f32, bf16, bf16, f32), the
    plain version, the library yardstick device alone, the bound at 67
    TFLOP/s."""
    from vit_fpga_tpu_torch.utils.timing import time_cuda
    ms = time_cuda(kern, iters=10)
    alone = {"f32": [], "bf16": []}
    for which in ("f32", "bf16", "bf16", "f32"):
        alone[which].append(_device_alone_ms(
            kern if which == "f32" else bf16_kern, iters=10))
    plain_ms = time_cuda(plain, iters=2, warmup=1)
    lib_ms = _library_ms(library, label)
    lib_alone = (None if lib_ms is None
                 else _device_alone_ms(library, iters=10))
    bound_ms, bound_by = _bound_f32(flops, nbytes)
    print(f"timing {row} {label}: kernel {ms:.4f} ms a call "
          f"({flops / ms / 1e9:.1f} TFLOP/s), device alone f32 "
          + " / ".join(f"{t:.4f}" for t in alone["f32"]) + ", bf16 "
          + " / ".join(f"{t:.4f}" for t in alone["bf16"])
          + f"; plain {plain_ms:.4f} ms, library {lib_ms} ms a call "
          f"({lib_alone} device alone), bound {bound_ms:.4f} ms "
          f"({bound_by}) [{_smi_line()}]")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=bound_ms, bound_by=bound_by,
                device_ms=min(alone["f32"]), bf16_device_ms=min(alone["bf16"]),
                library_device_ms=lib_alone)


def _attn_work(batch, n_pad, n_valid, d, heads, item):
    rows, dh = batch * n_pad, d // heads
    flops = 2 * rows * d * 4 * d + 4 * batch * heads * n_pad * n_valid * dh
    nbytes = (2 * rows * d * item + 2 * rows * 2 * 4 + 4 * d * d * item
              + 6 * d * 4)
    return flops, nbytes


def phase_f32_timing():
    """Each f32 kernel at its serving shape beside the bf16 kernel at the
    same shape (device alone, in turns), its plain version, its library
    yardstick in f32 with TF32 off, and the bound at 67 TFLOP/s: K1 at
    ViT-B/16 b64, K3 at (12 800, 768) x 3072 in 2 chunks, K2 at ViT-S/16
    b64's (12 800, 384) x 1536, K4 at ViT-B/16 b64 (max-free) and at
    ViT-H/14 b64 (head dim 80), K9 at ViT-B/16 @1024 b1.  Returns {JSON
    row: timing}."""
    import torch.nn.functional as F

    from vit_fpga_tpu_torch.ops import attention as at
    from vit_fpga_tpu_torch.ops import attn_block as ab
    from vit_fpga_tpu_torch.ops import flash_attention as fa
    from vit_fpga_tpu_torch.ops import fused_mlp as fm
    from vit_fpga_tpu_torch.utils.platform import true_f32
    out = {}
    with true_f32():
        x, st, p = _f32_attn_inputs(64, 200, 768, 650)
        xb, pb = x.bfloat16(), _bf16_weights(p, ("wqkv", "wo"))
        out["attn_block_stats_f32"] = _f32_timed(
            "attn_block_stats_f32", "(64, 200, 768)",
            lambda: _attn_call(ab.attn_block_stats, x, st, p, 12, 197, True),
            lambda: _attn_call(ab.attn_block_stats, xb, st, pb, 12, 197,
                               True),
            lambda: _attn_call(ab.attn_block_stats_plain, x, st, p, 12, 197,
                               True),
            _attn_library(x, p, 12, 197),
            *_attn_work(64, 200, 197, 768, 12, 4))
        out["attn_block_fwd_f32"] = _f32_timed(
            "attn_block_fwd_f32", "(64, 200, 768) max-free",
            lambda: _k4(ab.attn_block_fwd, x, p, 12, 197, False),
            lambda: _k4(ab.attn_block_fwd, xb, pb, 12, 197, False),
            lambda: _k4(ab.attn_block_fwd_plain, x, p, 12, 197, False),
            _attn_library(x, p, 12, 197),
            *_attn_work(64, 200, 197, 768, 12, 4))
        del x, xb
        x, _, p = _f32_attn_inputs(64, 264, 1280, 651)
        xb, pb = x.bfloat16(), _bf16_weights(p, ("wqkv", "wo"))
        out["attn_block_fwd_f32_dh80"] = _f32_timed(
            "attn_block_fwd_f32_dh80", "ViT-H/14 (64, 264, 1280) max-free",
            lambda: _k4(ab.attn_block_fwd, x, p, 16, 257, False),
            lambda: _k4(ab.attn_block_fwd, xb, pb, 16, 257, False),
            lambda: _k4(ab.attn_block_fwd_plain, x, p, 16, 257, False),
            _attn_library(x, p, 16, 257),
            *_attn_work(64, 264, 257, 1280, 16, 4))
        del x, xb
        for row, d, m, n_chunks, seed in (
                ("fused_mlp_chunked_stats_f32", 768, 3072, 2, 652),
                ("fused_mlp_stats_f32", 384, 1536, 1, 653)):
            x, st, p = _mlp_inputs(12800, d, m, seed, torch.float32)
            xb, pb = x.bfloat16(), _bf16_weights(p, ("w1", "w2"))
            fn = (fm.fused_mlp_chunked_stats if n_chunks > 1
                  else fm.fused_mlp_stats)
            plain = (fm.fused_mlp_chunked_stats_plain if n_chunks > 1
                     else fm.fused_mlp_stats_plain)
            kw = dict(n_chunks=n_chunks) if n_chunks > 1 else {}

            def call(f, xx, pp, kw=kw):
                return f(xx, st, pp["ln_scale"], pp["ln_bias"], pp["w1"],
                         pp["b1"], pp["w2"], pp["b2"], eps=EPS, act="gelu",
                         **kw)

            out[row] = _f32_timed(
                row, f"(12800, {d}) x {m}",
                lambda f=fn: call(f, x, p), lambda f=fn: call(f, xb, pb),
                lambda f=plain: call(f, x, p), _f32_mlp_library(x, p),
                4 * 12800 * d * m,
                2 * 12800 * d * 4 + 12800 * 4 * 4 + 2 * d * m * 4)
            del x, xb
        qkv = _seq_qkv(1, 4104, 768, 654, dtype=torch.float32)
        qb = qkv.bfloat16()
        q, k, v = at._heads(qkv, 12)
        keep = (torch.arange(4104, device="cuda") < 4097)[None, None, None]
        out["flash_attention_f32"] = _f32_timed(
            "flash_attention_f32", "ViT-B/16 @1024 (1, 4104, 2304)",
            lambda: _k9(qkv, 12, 4097, fa.flash_attention),
            lambda: _k9(qb, 12, 4097, fa.flash_attention),
            lambda: _k9(qkv, 12, 4097, fa.flash_attention_plain),
            lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=keep),
            4 * 12 * 4104 * 4097 * 64, 4 * 4104 * 768 * 4)
    return out


def phase_f32_forward_time(fwd32, images, iters=5):
    """The ViT-B/16 b64 forward in f32 and in bf16 (same weights cast by
    make_forward), in turns: ms per batch and img/s."""
    from vit_fpga_tpu_torch.models import vit
    from vit_fpga_tpu_torch.utils.timing import time_cuda
    cfg = vit.config("vit_b16", dtype="bfloat16")
    fwd16 = vit.make_forward(cfg, vit.init_params(cfg, _gen(640),
                                                  device="cuda"))
    img = torch.from_numpy(images).cuda()
    runs = {"f32": fwd32, "bf16": fwd16}
    times = {k: [] for k in runs}
    for name in ("f32", "bf16", "bf16", "f32"):
        times[name].append(time_cuda(lambda: runs[name](img), iters=iters,
                                     warmup=1))
    smi = _smi_line()
    for name, ms in times.items():
        print(f"forward ViT-B/16 @224 b{len(images)} {name}: "
              + " / ".join(f"{t:.3f}" for t in ms) + " ms per batch, "
              + " / ".join(f"{len(images) / t * 1e3:.1f}" for t in ms)
              + f" img/s [{smi}]")
    return times


def run_f32_phases(errors, timing, launches):
    """Phase 28 after the earlier slices' phases: the f32 kernels against
    their plain versions, the f32 serves with exact launch counts, the
    times, the b64 forward in f32 and bf16; the JSON rows F32_ROWS."""
    from vit_fpga_tpu_torch.models import vit
    errs = phase_f32_kernels()
    rows, images = phase_f32_serve()
    launches.update(rows)
    for name, t in phase_f32_timing().items():
        timing[name] = dict(t, max_abs_err=errs[name])
    errors.update(errs)
    cfg = vit.config("vit_b16", dtype="float32")
    fwd = vit.make_forward(cfg, vit.init_params(cfg, _gen(640),
                                                device="cuda"))
    phase_f32_forward_time(fwd, images)
    print(_smi_line())


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    from vit_fpga_tpu_torch.ops import _kernels
    from vit_fpga_tpu_torch.utils.platform import require_hopper

    smi = _smi_line()
    print(smi)
    kind = require_hopper()
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    _kernels.load()
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"(nvcc {_kernels.build_seconds})")
    print(_kernels.build_log)
    check_wgmma_serialisation(_kernels.build_log)

    errors_h = phase_vit_h14_kernels()
    phase_prefetch_race()
    phase_chain_grad()
    wgmma_errors = phase_wgmma_kernels()
    errors, op_launches = phase_odd_kernels()
    errors.update(phase_k23_kernels())
    errors.update(phase_past_1024_kernels())
    errors.update(errors_h)
    errors.update(phase_train_edges())
    errors["fused_mlp_fwd"] = wgmma_errors.pop("fused_mlp_fwd")
    errors.update(phase_chain_kernels(8))
    k17_k22_errors = phase_k17_k22_kernels()
    k14_per_linear_err = phase_k14_kernels()
    phase_k10_exact()
    errors["mlp_block_int8_stats"] = max(errors["mlp_block_int8_stats"],
                                         _k21a_edges())
    errors.update(phase_per_block_kernels())
    errors.update(phase_large_kernels())
    errors.update(phase_stack_kernels())
    errors.update(phase_full_kernels())
    errors.update(phase_dense_kernels())
    for name, err in phase_int8_kernels(8).items():
        errors[name] = err
    errors["attn_block_int8"] = max(errors["attn_block_int8"],
                                    phase_int8_loud())
    errors["attn_block_int8_long"] = phase_k16_long_kernels()
    errors.update(phase_k18_k21b_long_kernels())
    errors["mlp_block_int8"] = max(errors["mlp_block_int8"], _k15_edges())
    errors.update(phase_static_kernels(8))
    errors["mlp_block_int8_static"] = max(
        errors["mlp_block_int8_static"],
        k17_k22_errors.pop("mlp_block_int8_static"))
    errors.update(k17_k22_errors)
    errors[K14_PER_LINEAR] = k14_per_linear_err
    phase_parity()
    timing = phase_path_shapes()
    for name, err in wgmma_errors.items():
        timing[name]["max_abs_err"] = max(timing[name]["max_abs_err"], err)
    for batch in (8, 64):
        for name, err in phase_train_kernels(batch).items():
            errors[name] = max(errors.get(name, 0.0), err)
    phase_loud_padding()
    train_timing = phase_train_timing()
    for name, t in train_timing.items():
        timing[name] = dict(t, max_abs_err=errors[name])
    launches = phase_slice()
    launches.update(op_launches)
    phase_safe_forward()
    phase_train_step_vs_cpu()
    launches["attn_block_bwd_long"], _ = phase_train_step_384()
    timing["attn_block_bwd_long"] = dict(
        phase_k23_timing(), max_abs_err=errors["attn_block_bwd_long"])
    launches.update({k: v for k, v in phase_train_fit().items()
                     if k in TRAIN_KERNELS})
    phase_train_step_time()
    for name, err in phase_int8_kernels(64).items():
        errors[name] = max(errors[name], err)
    for name, t in phase_int8_timing().items():
        timing[name] = dict(t, max_abs_err=errors[name])
    int8_launches, fwd_int8, fwd_bf16, cfg, _ = phase_int8_slice()
    launches.update({k: v for k, v in int8_launches.items()
                     if k in INT8_KERNELS})
    run_static_phases(errors, timing, launches, fwd_int8, fwd_bf16, cfg)
    run_latency_phases(errors, timing, launches)
    run_dense_phases(errors, timing, launches)
    run_large_phases(errors, timing, launches)
    run_full_phases(errors, timing, launches)
    run_per_block_phases(errors, timing, launches)
    run_chain_phases(errors, timing, launches)
    run_odd_phases(errors, timing, launches)
    run_k16_long_phases(errors, timing, launches)
    run_k18_k21b_long_phases(errors, timing, launches)
    run_k17_k22_phases(errors, timing, launches)
    run_k14_k10_phases(errors, timing, launches)
    run_past_1024_phases(errors, timing, launches)
    run_vit_h14_phases(errors, timing, launches)
    run_f32_phases(errors, timing, launches)
    run_lifecycle_phases()

    sources = {
        "attn_block_stats": ("vit_fpga_tpu_torch/csrc/attn_stats.cu",
                             "vit_fpga_tpu/ops/attn_block.py:550"),
        "fused_mlp_stats": ("vit_fpga_tpu_torch/csrc/mlp_stats.cu",
                            "vit_fpga_tpu/ops/fused_mlp.py:225"),
        "attn_block_fwd": ("vit_fpga_tpu_torch/csrc/attn_block.cu",
                           "vit_fpga_tpu/ops/attn_block.py:371"),
        "fused_mlp_fwd": ("vit_fpga_tpu_torch/csrc/mlp.cu",
                          "vit_fpga_tpu/ops/fused_mlp.py:52"),
        "attn_block_bwd": ("vit_fpga_tpu_torch/csrc/attn_bwd.cu",
                           "vit_fpga_tpu/ops/attn_block.py:734"),
        "fused_mlp_bwd": ("vit_fpga_tpu_torch/csrc/mlp_bwd.cu",
                          "vit_fpga_tpu/ops/fused_mlp.py:578"),
        "int8_linear_fused": ("vit_fpga_tpu_torch/csrc/quant_linear.cu",
                              "vit_fpga_tpu/ops/quant_fused.py:46"),
        K14_PER_LINEAR: ("vit_fpga_tpu_torch/csrc/quant_linear.cu",
                         "vit_fpga_tpu/ops/quant_fused.py:46"),
        "mlp_block_int8": ("vit_fpga_tpu_torch/csrc/mlp_int8.cu",
                           "vit_fpga_tpu/ops/quant_block.py:86"),
        "attn_block_int8": ("vit_fpga_tpu_torch/csrc/attn_int8.cu",
                            "vit_fpga_tpu/ops/quant_block.py:226"),
        "attn_block_int8_long": ("vit_fpga_tpu_torch/csrc/attn_int8.cu",
                                 "vit_fpga_tpu/ops/quant_block.py:226"),
        "vit_layers": ("vit_fpga_tpu_torch/csrc/vit_stack.cu",
                       "vit_fpga_tpu/ops/vit_stack.py:93"),
        "vit_layers_int8": ("vit_fpga_tpu_torch/csrc/vit_stack_int8.cu",
                            "vit_fpga_tpu/ops/vit_stack.py:287"),
        "mlp_block_int8_static": ("vit_fpga_tpu_torch/csrc/mlp_int8_static.cu",
                                  "vit_fpga_tpu/ops/quant_block.py:640"),
        "attn_block_int8_static": (
            "vit_fpga_tpu_torch/csrc/attn_int8_static.cu",
            "vit_fpga_tpu/ops/quant_block.py:729"),
        "vit_layers_int8_static": (
            "vit_fpga_tpu_torch/csrc/vit_stack_int8_static.cu",
            "vit_fpga_tpu/ops/vit_stack.py:372"),
        "filter_image_device": ("vit_fpga_tpu_torch/csrc/image_filter.cu",
                                "vit_fpga_tpu/ops/image_filter.py:71"),
        "int8_gemm": ("vit_fpga_tpu_torch/csrc/int8_gemm.cu",
                      "vit_fpga_tpu/ops/quant.py:105"),
        "fused_mlp_chunked_stats": ("vit_fpga_tpu_torch/csrc/mlp_chunk_stats.cu",
                                    "vit_fpga_tpu/ops/fused_mlp.py:305"),
        "attn_block_stats_long": ("vit_fpga_tpu_torch/csrc/mha_wgmma.cuh",
                                  "vit_fpga_tpu/ops/attn_block.py:550"),
        "vit_full": ("vit_fpga_tpu_torch/csrc/vit_full.cu",
                     "vit_fpga_tpu/ops/vit_stack.py:566"),
        "vit_full_int8": ("vit_fpga_tpu_torch/csrc/vit_full_int8.cu",
                          "vit_fpga_tpu/ops/vit_stack.py:604"),
        "flash_attention": ("vit_fpga_tpu_torch/csrc/flash_attn.cu",
                            "vit_fpga_tpu/ops/flash_attention.py:29"),
        "mha_qkv_pallas": ("vit_fpga_tpu_torch/csrc/mha.cu",
                           "vit_fpga_tpu/ops/attention.py:121"),
        "mha_pallas": ("vit_fpga_tpu_torch/csrc/mha.cu",
                       "vit_fpga_tpu/ops/attention.py:53"),
        "fused_mlp_chunked": ("vit_fpga_tpu_torch/csrc/mlp_chunk.cu",
                              "vit_fpga_tpu/ops/fused_mlp.py:133"),
        "mlp_block_int8_stats": ("vit_fpga_tpu_torch/csrc/mlp_int8_stats.cu",
                                 "vit_fpga_tpu/ops/quant_block.py:369"),
        "attn_block_int8_stats": (
            "vit_fpga_tpu_torch/csrc/attn_int8_stats.cu",
            "vit_fpga_tpu/ops/quant_block.py:457"),
        "attn_block_int8_static_scores": (
            "vit_fpga_tpu_torch/csrc/attn_int8_scores.cu",
            "vit_fpga_tpu/ops/quant_block.py:850"),
        SCORES_LONG: ("vit_fpga_tpu_torch/csrc/attn_int8_scores.cu",
                      "vit_fpga_tpu/ops/quant_block.py:850"),
        "attn_block_int8_static_long": (
            "vit_fpga_tpu_torch/csrc/attn_int8_static.cu",
            "vit_fpga_tpu/ops/quant_block.py:729"),
        "attn_block_int8_stats_long": (
            "vit_fpga_tpu_torch/csrc/attn_int8_stats.cu",
            "vit_fpga_tpu/ops/quant_block.py:457"),
        "attn_block_fwd_long": ("vit_fpga_tpu_torch/csrc/mha_wgmma.cuh",
                                "vit_fpga_tpu/ops/attn_block.py:371"),
        "attn_block_bwd_long": ("vit_fpga_tpu_torch/csrc/attn_bwd.cu",
                                "vit_fpga_tpu/ops/attn_block.py:734"),
        "patch_embed_pallas": ("vit_fpga_tpu_torch/csrc/patch_embed.cu",
                               "vit_fpga_tpu/ops/patch_embed.py:147"),
        "streamed_gemm": ("vit_fpga_tpu_torch/csrc/streamed_gemm.cu",
                          "vit_fpga_tpu/ops/streamed_gemm.py:32"),
        "attn_block_stats_1032": ("vit_fpga_tpu_torch/csrc/attn_stats.cu",
                                  "vit_fpga_tpu/ops/attn_block.py:550"),
        "attn_block_stats_3144": ("vit_fpga_tpu_torch/csrc/attn_stats.cu",
                                  "vit_fpga_tpu/ops/attn_block.py:550"),
        "attn_block_fwd_3144": ("vit_fpga_tpu_torch/csrc/attn_block.cu",
                                "vit_fpga_tpu/ops/attn_block.py:371"),
        "attn_block_bwd_1032": ("vit_fpga_tpu_torch/csrc/attn_bwd.cu",
                                "vit_fpga_tpu/ops/attn_block.py:734"),
        "attn_block_bwd_1608": ("vit_fpga_tpu_torch/csrc/attn_bwd.cu",
                                "vit_fpga_tpu/ops/attn_block.py:734"),
        "attn_block_fwd_dh80": ("vit_fpga_tpu_torch/csrc/attn_block.cu",
                                "vit_fpga_tpu/ops/attn_block.py:371"),
        "attn_block_bwd_dh80": ("vit_fpga_tpu_torch/csrc/attn_bwd.cu",
                                "vit_fpga_tpu/ops/attn_block.py:734"),
        "attn_block_int8_dh80": ("vit_fpga_tpu_torch/csrc/attn_int8.cu",
                                 "vit_fpga_tpu/ops/quant_block.py:226"),
        "attn_block_int8_static_dh80": (
            "vit_fpga_tpu_torch/csrc/attn_int8_static.cu",
            "vit_fpga_tpu/ops/quant_block.py:729"),
    }
    sources.update(F32_ROWS)
    kernels = []
    for name, (src, replaces) in sources.items():
        t = timing[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
