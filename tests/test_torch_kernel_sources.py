"""The kernel build lists every CUDA source and header of the port, so that
an edited or new file changes the build hash and rebuilds the library."""

import re

import pytest

from vit_fpga_tpu_torch.ops import _kernels


def test_build_lists_every_source_and_header():
    on_disk = {p.name for p in _kernels.CSRC.iterdir()
               if p.suffix in (".cu", ".cuh")}
    listed = set(_kernels.SOURCES) | set(_kernels.HEADERS)
    assert listed == on_disk
    assert all(n.endswith(".cu") for n in _kernels.SOURCES)
    assert all(n.endswith(".cuh") for n in _kernels.HEADERS)


def test_every_included_header_is_listed():
    included = set()
    for p in _kernels.CSRC.iterdir():
        if p.suffix in (".cu", ".cuh"):
            included |= set(re.findall(r'#include "([^"]+)"', p.read_text()))
    assert included <= set(_kernels.HEADERS)


@pytest.mark.parametrize("name", ["mlp_chunk_stats.cu", "streamed_gemm.cu"])
def test_k3_and_k26_launch_the_wgmma_gemm(name):
    """K3 and K26 (bf16) run gemm_wgmma.cuh's wgmma + TMA GEMM."""
    text = (_kernels.CSRC / name).read_text()
    assert '#include "gemm_wgmma.cuh"' in text
    assert "launch_gemm_wgmma(" in text


def test_k3_no_longer_launches_the_wmma_chunk_kernel():
    """K3's down-projection is the GEMM's chunked variant (chunk_k), not
    a wmma chunk kernel; K6 runs the same two launches."""
    k3 = (_kernels.CSRC / "mlp_chunk_stats.cu").read_text()
    assert '#include "chunk.cuh"' not in k3
    assert "launch_chunk_down(" not in k3 and "launch_gemm_t<" not in k3
    assert "down.chunk_k = m / n_chunks;" in k3
    k6 = (_kernels.CSRC / "mlp_chunk.cu").read_text()
    assert "launch_chunk_down(" not in k6
    assert "down.chunk_k = m / n_chunks;" in k6


@pytest.mark.parametrize("name", ["attn_block.cu", "mlp_bwd.cu"])
def test_k4_and_k24_include_the_wgmma_gemm(name):
    """K4 and K24 run gemm_wgmma.cuh's wgmma + TMA GEMM (K4 through
    attn_half.cuh, the launch sequence it shares with K1)."""
    text = (_kernels.CSRC / name).read_text()
    assert '#include "gemm_wgmma.cuh"' in text
    assert "wmma" not in text.split("#define VFT_NS")[1]


@pytest.mark.parametrize("name", ["attn_bwd.cu", "mlp_chunk.cu"])
def test_k23_and_k6_include_the_wgmma_gemm(name):
    """K23 and K6 run gemm_wgmma.cuh's wgmma + TMA GEMM and no wmma."""
    text = (_kernels.CSRC / name).read_text()
    assert '#include "gemm_wgmma.cuh"' in text
    assert "wmma" not in text.split("#define VFT_NS")[1]


def test_the_wmma_bf16_gemm_and_the_chunk_header_are_gone():
    """Nothing of the port keeps the wmma bf16 GEMM (gemm_bf16_kernel) or
    chunk.cuh: K23 and K6, its last users, run gemm_wgmma.cuh."""
    assert not (_kernels.CSRC / "chunk.cuh").exists()
    assert "chunk.cuh" not in _kernels.HEADERS
    for p in _kernels.CSRC.iterdir():
        text = p.read_text()
        for gone in (r"gemm_bf16_kernel", r"launch_gemm_t\b", r"chunk\.cuh",
                     r"\bGemmArgs\b", r"\bgemm_enable\b"):
            assert not re.search(gone, text), (p.name, gone)


def test_k23_runs_its_products_and_attention_on_wgmma():
    """K23's five products are gemm_wgmma.cuh launches (qkv in the
    forward's layout, gw and dxn with B K-major, dWo and dWqkv with A
    MN-major and split-K partials summed in order) and its attention
    backward is two wgmma + TMA kernels over mha_wgmma.cuh's tiles."""
    k23 = (_kernels.CSRC / "attn_bwd.cu").read_text()
    assert '#include "mha_wgmma.cuh"' in k23
    assert k23.count("launch_gemm_wgmma(") == 1
    assert k23.count("launch_gemm_wgmma<GW_AK_BK, GW_EPI_BF16>(") == 1
    assert k23.count("launch_gemm_wgmma<GW_AK_BK, GW_EPI_F32>(") == 1
    assert k23.count("launch_gemm_wgmma<GW_AM_BN, GW_EPI_F32>(") == 2
    assert k23.count("launch_split_sum(") == 2
    for kernel in ("bwd_q_kernel<DH><<<", "bwd_kv_kernel<DH><<<"):
        assert k23.count(kernel) == 1
    assert not re.search(r"\battn_bwd_kernel\b|\bAttnBwdSmem\b", k23)
    # no token cap: the backward routes by the JAX _bwd_fits before it
    assert "AB_MAX_TOKENS" not in k23 and "n_pad > " not in k23


@pytest.mark.parametrize("name", ["attn_bwd.cu", "mlp_chunk.cu",
                                  "mha_wgmma.cuh", "hopper.cuh"])
def test_k23_and_k6_sums_use_no_atomics(name):
    """K23's attention backward adds dq, dk and dv in registers and its
    weight gradients through split_sum, in a fixed order: no atomic in
    its units or in the headers they bring."""
    text = (_kernels.CSRC / name).read_text()
    assert not re.search(r"\batomic[A-Z]\w*\s*\(|\batom\.|\bred\.", text)


def test_k4_no_longer_launches_the_wmma_gemm_or_the_key_tiled_tile():
    """K4 is row_stats followed by K1's sequence (attn_half.cuh), whose
    attention is mha_wgmma.cuh's kernel at every length."""
    k4 = (_kernels.CSRC / "attn_block.cu").read_text()
    assert "launch_gemm(" not in k4 and "launch_attn_long" not in k4
    assert "launch_attn<" not in k4 and "launch_attn(" not in k4
    assert '#include "attn_half.cuh"' in k4
    assert "launch_attn_half<MW_SAFE>" in k4
    assert "launch_attn_half<MW_MAXFREE>" in k4
    k1 = (_kernels.CSRC / "attn_stats.cu").read_text()
    assert "launch_attn_half<MW_MAXFREE>" in k1


def test_k24_runs_every_product_on_the_wgmma_gemm():
    """K24's five products are gemm_wgmma.cuh launches (no wmma
    launch_gemm_t): da and h together in gf_kernel, dxn with B K-major,
    dW1 and dW2 with A MN-major."""
    k24 = (_kernels.CSRC / "mlp_bwd.cu").read_text()
    assert "launch_gemm_t" not in k24
    assert k24.count("launch_act_bwd_fused(") == 1
    assert k24.count("launch_gemm_wgmma<") == 3
    for variant in ("<GW_AK_BK, GW_EPI_F32>", "<GW_AM_BN, GW_EPI_F32>"):
        assert f"launch_gemm_wgmma{variant}" in k24


def test_the_key_tiled_attention_tile_is_gone():
    """attn.cuh, which held the key-tiled tile until K4 moved and then the
    whole-head tile of the int8 halves, is gone with its last users (K18,
    K21b): no file names it or its pieces, and the build does not list
    it."""
    assert not (_kernels.CSRC / "attn.cuh").exists()
    assert "attn.cuh" not in _kernels.HEADERS
    for p in _kernels.CSRC.iterdir():
        text = p.read_text()
        assert '#include "attn.cuh"' not in text, p.name
        for gone in (r"\battn_long_kernel\b", r"\blaunch_attn_long\b",
                     r"\bATT_MAX_KV\b", r"\battn_enable\b",
                     r"\blaunch_attn\b"):
            assert not re.search(gone, text), (p.name, gone)
    common = (_kernels.CSRC / "common.cuh").read_text()
    assert "inline cudaError_t launch_gemm(" not in common


def test_no_sum_of_the_port_uses_atomics():
    """K24's sums run in a fixed order: no atomic in the GEMM or in its
    launch sequence; nor in the layer loop of K19a, K20, K19b and K12,
    whose split-K partials (int32, or K12's f32) are added in slice order
    by the row stage that follows."""
    for name in ("gemm_wgmma.cuh", "mlp_bwd.cu", "norm.cuh",
                 "stack_wgmma.cuh", "vit_stack_int8_static.cu",
                 "vit_full.cu"):
        text = (_kernels.CSRC / name).read_text()
        assert not re.search(r"\batomic[A-Z]\w*\s*\(|\batom\.|\bred\.", text), name


def test_k13_runs_on_the_int8_wgmma_gemm():
    """K13 is qgemm_wgmma.cuh's int8 wgmma + TMA GEMM: no wmma, and not
    quant.cuh's wmma GEMM."""
    k13 = (_kernels.CSRC / "int8_gemm.cu").read_text()
    assert '#include "qgemm_wgmma.cuh"' in k13
    assert '#include "quant.cuh"' not in k13
    assert "wmma" not in k13.split("#define VFT_NS")[1]
    assert "launch_qgemm_wgmma(" in k13
    gemm = (_kernels.CSRC / "qgemm_wgmma.cuh").read_text()
    assert "wmma" not in gemm
    for piece in ("wgmma_m64n256k32_s8(", "wgmma_m64n128k32_s8(",
                  "tma_load_2d(", "tma_store_2d(", "tma_encode_s8(",
                  "tma_encode_s32("):
        assert piece in gemm, piece


def test_k9_launches_the_online_mode_of_the_wgmma_attention():
    """K9 in bf16 is mha_wgmma.cuh's kernel in its online mode, not an
    mma.sync kernel of seq_attn.cuh; seq_attn.cuh's f32 kernel is K9's f32
    entry alone (vft_flash_attention_f32)."""
    k9 = (_kernels.CSRC / "flash_attn.cu").read_text()
    assert '#include "mha_wgmma.cuh"' in k9
    bf16 = _body(k9, "vft_flash_attention")
    assert "seq_attn" not in bf16
    assert "launch_mha_wgmma<MW_ONLINE>(" in bf16
    assert "launch_seq_attn_f32<64, SF_ONLINE>(" in _body(
        k9, "vft_flash_attention_f32")
    assert "mha_wgmma_enable<MW_ONLINE>()" in k9
    assert "MW_ONLINE" in (_kernels.CSRC / "mha_wgmma.cuh").read_text()


def test_the_mma_sync_k9_kernel_and_the_raw_int32_epilogue_are_gone():
    """Nothing under csrc/ keeps seq_attn.cuh's bf16 kernel (seq_attn_f32_
    kernel stays: K7 / K8 in f32) or quant.cuh's EPI_I32 epilogue."""
    for p in _kernels.CSRC.iterdir():
        text = p.read_text()
        for gone in (r"\bseq_attn_kernel\b", r"\blaunch_seq_attn\b",
                     r"\bseq_attn_enable\b", r"EPI_I32", r"\bSQ_\w+"):
            assert not re.search(gone, text), (p.name, gone)
    assert "seq_attn_f32_kernel" in (_kernels.CSRC / "seq_attn.cuh").read_text()


@pytest.mark.parametrize("name", ["vit_stack_int8.cu", "vit_full_int8.cu"])
def test_k19a_and_k20_run_on_the_int8_wgmma_layer_loop(name):
    """K19a and K20 run stack_wgmma.cuh's layer loop: int8 wgmma fed by
    TMA (qgemm_wgmma.cuh's issue), the attention on mha_wgmma.cuh's
    max-free sweep, a layer's grid barriers after the 7 stage kinds QKV,
    attention, out-projection, LN2 rows, W1, W2 and LN1 rows; no mma.sync
    tile, wmma fragment or stage of the 9-stage loop."""
    text = (_kernels.CSRC / name).read_text()
    for header in ("stack_wgmma.cuh", "hopper.cuh", "qgemm_wgmma.cuh",
                   "mha_wgmma.cuh"):
        assert f'#include "{header}"' in text, header
    assert "stack_i8.cuh" not in text
    assert "lq_layers_consumer(" in text and "lq_layers_producer(" in text
    assert "__launch_bounds__(LQ_THREADS, 1)" in text
    layer = (_kernels.CSRC / "stack_wgmma.cuh").read_text()
    body = text.split("#define VFT_NS")[1]
    for src in (body, layer):
        for gone in (r"\btile_i8\b", r"\bsplit_stage_i8\b", r"\bqkv_stage\b",
                     r"\battn_stage\b", r"\bencoder_layers_i8\b",
                     r"\battn_item\b", r"\brow_pass_i8\b", r"\bmma_s8\b",
                     r"\bwmma\b", r"\bblock_max\b"):
            assert not re.search(gone, src), gone
    for piece in ("qw_issue<LQ_BN>(", "mf_sweep<MW_MAXFREE>(", "tma_load_2d(",
                  "tma_load_4d(", "fence_proxy_async_global()",
                  "fence_proxy_async()"):
        assert piece in layer, piece
    loop = layer[layer.index("int lq_gemm_kind("):layer.index("// Host: the tensor")]
    # a layer's 7 kinds, and before layer 0 the first LN1 rows (K20: after
    # its embed); no kind of a row stage that only takes an absmax
    assert set(re.findall(r"\bLQ_T_\w+", loop)) == {
        "LQ_T_QKV", "LQ_T_ATTN", "LQ_T_OPROJ", "LQ_T_RES_LN2", "LQ_T_W1",
        "LQ_T_W2", "LQ_T_RES_LN1", "LQ_T_LN1", "LQ_T_EMBED"}
    assert not (_kernels.CSRC / "stack_i8.cuh").exists()


def test_k19a_k20_stage_names_match_the_clock_kinds():
    """ops/vit_stack's K19A_STAGES and K20_STAGES name the stage kinds of
    stack_wgmma.cuh's enum in its order: the comment beside each kind
    begins the name of its row (K19a: the layer kinds, K20: all)."""
    from vit_fpga_tpu_torch.ops import vit_stack as vs
    layer = (_kernels.CSRC / "stack_wgmma.cuh").read_text()
    enum = layer[layer.index("enum LqStage {"):]
    enum = enum[:enum.index("};")]
    kinds = re.findall(r"(LQ_T_\w+)(?: = 0)?,?\s*// ([^\n]+)", enum)
    names = [k for k, _ in kinds]
    assert names[0] == "LQ_T_LN1" and names[-1] == "LQ_T_HEAD"
    assert len(names) == len(set(names)) == len(vs.K20_STAGES)
    assert names.index("LQ_T_RES_LN1") + 1 == len(vs.K19A_STAGES)
    for i, (_, what) in enumerate(kinds):
        what = what.strip()
        assert vs.K20_STAGES[i].startswith(what), (i, what)
        if i < len(vs.K19A_STAGES):
            assert vs.K19A_STAGES[i].startswith(what), (i, what)


@pytest.mark.parametrize("name", ["vit_stack_int8_static.cu", "vit_full.cu"])
def test_k19b_and_k12_run_on_the_wgmma_layer_loop(name):
    """K19b (static int8) and K12 (bf16) run stack_wgmma.cuh's layer loop,
    the one K19a and K20 run, in their own variant of it: TMA-fed wgmma
    items, the attention on mha_wgmma.cuh's max-free sweep, 7 grid
    barriers a layer; none of stack.cuh's mma.sync tiles, wmma attention
    items or row passes, and not K11's stack_bf16.cuh."""
    text = (_kernels.CSRC / name).read_text()
    for header in ("stack_wgmma.cuh", "hopper.cuh", "mha_wgmma.cuh"):
        assert f'#include "{header}"' in text, header
    assert "lq_layers_consumer(" in text and "lq_layers_producer(" in text
    assert "__launch_bounds__(LQ_THREADS, 1)" in text
    variant = "LQ_STATIC" if name == "vit_stack_int8_static.cu" else "LQ_BF16"
    assert f"lq_ring<{variant}>(smem)" in text
    assert f"lq_encode_layers<{variant}>(" in text
    body = text.split("#define VFT_NS")[1]
    for gone in (r"\btile_i8\b", r"\btile_bf16\b", r"\bsplit_stage_i8\b",
                 r"\bqkv_stage\b", r"\battn_item\b", r"\battn_stage\b",
                 r"\brow_pass_i8\b", r"\brow_pass\b", r"\bmma_s8\b",
                 r"stack_bf16\.cuh", r"\bencoder_layers\b", r"\bwmma\b"):
        assert not re.search(gone, body), (name, gone)


def test_the_layer_loop_has_a_bf16_item_and_a_static_epilogue():
    """stack_wgmma.cuh's one GEMM site issues gemm_wgmma.cuh's gw_issue on
    a 64-column bf16 item (B through the transpose bit) or qgemm_wgmma.cuh's
    qw_issue, takes its K-step count from the variant, and reads the static
    and bf16 variants' out-projection and W2 operands by TMA; the static
    attention's int8 epilogue and W1's keep their +-127 clamps."""
    layer = (_kernels.CSRC / "stack_wgmma.cuh").read_text()
    assert "gw_issue<0, GW_BK / 16, GW_AK_BN, LQ_BN>(" in layer
    assert "qw_issue<LQ_BN>(" in layer
    assert layer.count("lq_kstep<V>()") >= 2
    assert "tma_a ? &p.maps.ao : nullptr" in layer
    assert "tma_a ? &p.maps.h : nullptr" in layer
    assert layer.count("fminf(fmaxf(rintf(f0), -127.0f), 127.0f)") == 1
    assert "lq_pack2(rint_sat(z[4 * j]), rint_sat(z[4 * j + 1]))" in layer
    gemm = (_kernels.CSRC / "gemm_wgmma.cuh").read_text()
    assert "int BN = GW_BN>" in gemm
    assert "wgmma_m64n64k16_ss<1>(" in gemm
    hopper = (_kernels.CSRC / "hopper.cuh").read_text()
    assert '"n"(TRANS_B));' in hopper.split("wgmma_m64n64k16_ss(")[1]


def test_k11_keeps_its_mma_sync_layer_and_stack_cuh_loses_its_int8_tiles():
    """K11 no longer keeps its mma.sync layer: it runs stack_wgmma.cuh's
    layer loop in its bf16 variant, as K12 does; stack_bf16.cuh is gone
    from disk and from the build, and stack.cuh keeps none of the mma.sync
    tiles, wmma attention items or int8 tiles, only the stage clock, the
    cooperative launch and the scalar helpers."""
    k11 = (_kernels.CSRC / "vit_stack.cu").read_text()
    for header in ("stack_wgmma.cuh", "hopper.cuh", "mha_wgmma.cuh",
                   "stack.cuh"):
        assert f'#include "{header}"' in k11, header
    assert "lq_ring<LQ_BF16>(smem)" in k11
    assert "lq_encode_layers<LQ_BF16>(" in k11
    assert "__launch_bounds__(LQ_THREADS, 1)" in k11
    assert "stack_bf16.cuh" not in k11
    assert not (_kernels.CSRC / "stack_bf16.cuh").exists()
    assert "stack_bf16.cuh" not in _kernels.HEADERS
    stack = (_kernels.CSRC / "stack.cuh").read_text()
    for kept in ("struct StageClock", "coop_launch(", "ST_DH", "ST_MAX_KV"):
        assert kept in stack, kept
    for gone in (r"\btile_bf16\b", r"\battn_item\b", r"\battn_stage\b",
                 r"\bst_attn_smem\b", r"\bstack_smem_bytes\b",
                 r"\bprefetch_l2\b", r"\bST_BK\b", r"\bST_QCHUNK\b",
                 r"\bmma_sync\b", r"\bwmma\b", r"\btile_i8\b",
                 r"\bqkv_stage\b", r"\bsplit_stage_i8\b", r"\brow_pass_i8\b",
                 r"\bQ8\b", r"\bQT_\w+"):
        assert not re.search(gone, stack), gone
    for p in _kernels.CSRC.iterdir():
        text = p.read_text()
        assert "stack_i8_wgmma" not in text, p.name
        assert not re.search(r"\b(tile_bf16|attn_item|attn_stage)\b", text), \
            p.name


def test_k15_runs_both_gemms_on_the_int8_wgmma_gemm():
    """K15's W1 and W2 run on qgemm_wgmma.cuh's int8 wgmma + TMA kernel
    with its dequantizing epilogues, not quant.cuh's wmma GEMM; the
    epilogue holds one copy of the activation, in a loop over the staged
    pieces that stays rolled."""
    k15 = (_kernels.CSRC / "mlp_int8.cu").read_text()
    assert '#include "qgemm_wgmma.cuh"' in k15
    assert "launch_qgemm<" not in k15
    for epi in ("QW_H", "QW_RESID"):
        assert f"launch_qgemm_epi<{epi}>(" in k15, epi
    assert "launch_quant_amax(" in k15
    gemm = (_kernels.CSRC / "qgemm_wgmma.cuh").read_text()
    body = gemm[gemm.index("void qw_epilogue("):]
    body = body[:body.index("\n}\n")]
    assert body.count("act_rn(") == 1
    assert "#pragma unroll 1" in body and "pack_bf16x2(" in body


@pytest.mark.parametrize("kernel", ["K19B", "K12", "K11"])
def test_k19b_k12_stage_names_match_the_clock_kinds(kernel):
    """K19B_STAGES and K11_STAGES (the layer kinds) and K12_STAGES (all,
    with the patch, embed and head stages) name the stage kinds of
    stack_wgmma.cuh's enum in its order, as K19A_STAGES and K20_STAGES
    do."""
    from vit_fpga_tpu_torch.ops import vit_stack as vs
    layer = (_kernels.CSRC / "stack_wgmma.cuh").read_text()
    enum = layer[layer.index("enum LqStage {"):]
    enum = enum[:enum.index("};")]
    kinds = [w.strip() for _, w in
             re.findall(r"(LQ_T_\w+)(?: = 0)?,?\s*// ([^\n]+)", enum)]
    stages = getattr(vs, f"{kernel}_STAGES")
    want = len(kinds) if kernel == "K12" else len(vs.K19A_STAGES)
    assert len(stages) == len(set(stages)) == want
    for i, name in enumerate(stages):
        assert name.startswith(kinds[i]), (i, name, kinds[i])


def test_k16_runs_on_the_int8_wgmma_gemm_and_the_wgmma_attention():
    """K16's QKV and out-projection run on qgemm_wgmma.cuh (a bf16 qkv
    epilogue and the residual one), its attention on mha_wgmma.cuh's
    max-free sweep over the packed qkv; it keeps no attn.cuh tile, no
    wmma and no 256-key bound."""
    k16 = (_kernels.CSRC / "attn_int8.cu").read_text()
    body = k16.split("#define VFT_NS")[1]
    for inc in ("qgemm_wgmma.cuh", "mha_wgmma.cuh"):
        assert f'#include "{inc}"' in k16, inc
    assert '#include "attn.cuh"' not in k16
    assert "wmma" not in body
    assert "launch_mha_packed<MW_MAXFREE>(" in k16
    assert "mha_wgmma_enable<MW_MAXFREE>()" in k16
    for epi in ("QW_BF16", "QW_RESID"):
        assert f"launch_qgemm_epi<{epi}>(" in k16, epi
    assert "launch_qgemm<" not in k16 and "launch_attn(" not in k16
    assert "ATT_MAX_KV" not in k16 and "256" not in body
    mha = (_kernels.CSRC / "mha_wgmma.cuh").read_text()
    assert "constexpr int MW_MAX_GRID_Y = 65535;" in mha
    from vit_fpga_tpu_torch.ops import quant_block as qb
    assert qb.MW_MAX_GRID_Y == 65535


def test_k16_bf16_epilogue_shares_the_residual_epilogue_code_site():
    """QW_BF16 is QW_RESID without the add: one branch of qw_epilogue,
    in the same IEEE order, not a copy of the loop."""
    gemm = (_kernels.CSRC / "qgemm_wgmma.cuh").read_text()
    body = gemm[gemm.index("void qw_epilogue("):]
    body = body[:body.index("\n}\n")]
    assert body.count("__fadd_rn(__fmul_rn((float)a[e], "
                      "__fmul_rn(sr, scv[e])), biv[e])") == 1
    assert "if constexpr (EPI == QW_RESID)" in body
    assert gemm.count("void qw_epilogue(") == 1


def test_k21a_runs_both_gemms_on_the_int8_wgmma_gemm():
    """K21a is K15's launch sequence from the producer's stats: W1 and W2
    on qgemm_wgmma.cuh's dequantizing epilogues, the row pass over the
    tiles' maxima, then the stats of out."""
    k21a = (_kernels.CSRC / "mlp_int8_stats.cu").read_text()
    assert '#include "qgemm_wgmma.cuh"' in k21a
    assert "wmma" not in k21a.split("#define VFT_NS")[1]
    assert "launch_qgemm<" not in k21a
    for epi in ("QW_H", "QW_RESID"):
        assert f"launch_qgemm_epi<{epi}>(" in k21a, epi
    assert "launch_quant_rows<bf16, LN_STATS, false, ST>(" in k21a
    assert "launch_quant_amax(" in k21a and "launch_row_stats(" in k21a
    assert "nparts != qgemm_wgmma_col_tiles(m)" in k21a
    assert "tma_init()" in k21a


def test_the_wmma_gemm_has_no_amax_epilogue():
    """Nothing launches quant.cuh's wmma GEMM with per-block row maxima
    any more (K15 and K21a take QW_H's), so it and its column-block
    count are gone."""
    for p in _kernels.CSRC.iterdir():
        text = p.read_text()
        for gone in (r"\bEPI_AMAX\b", r"\bqgemm_col_blocks\b"):
            assert not re.search(gone, text), (p.name, gone)
    quant = (_kernels.CSRC / "quant.cuh").read_text()
    assert "p.amax" not in quant and "float* amax;" not in quant


@pytest.mark.parametrize("name", ["attn_int8_static.cu",
                                  "attn_int8_stats.cu"])
def test_k18_and_k21b_run_on_k16s_wgmma_sequence(name):
    """K18 and K21b run K16's units: QKV and out-projection on
    qgemm_wgmma.cuh (the bf16 qkv epilogue and the residual one), the
    attention on mha_wgmma.cuh's max-free sweep over the packed qkv
    (K18 with its int8 output); no wmma GEMM, no attn.cuh tile and no
    256-key bound."""
    text = (_kernels.CSRC / name).read_text()
    body = text.split("#define VFT_NS")[1]
    for inc in ("hopper.cuh", "qgemm_wgmma.cuh", "mha_wgmma.cuh"):
        assert f'#include "{inc}"' in text, inc
    assert '#include "attn.cuh"' not in text and "wmma" not in body
    for epi in ("QW_BF16", "QW_RESID"):
        assert f"launch_qgemm_epi<{epi}>(" in text, epi
        assert f"qgemm_epi_enable<{epi}>()" in text, epi
    assert "launch_qgemm<" not in text and "qgemm_enable<" not in text
    assert "ATT_MAX_KV" not in text and "256" not in body
    assert "tma_init()" in text and "MW_MAX_GRID_Y" in text
    if name == "attn_int8_static.cu":
        assert "launch_mha_packed<MW_MAXFREE, true>(" in text
        assert "mha_wgmma_enable<MW_MAXFREE, true>()" in text
        assert "g.sa" not in text and "o.sa" not in text  # row scale 1
        assert "LN_NONE" not in text  # no ao row pass
    else:
        assert "launch_mha_packed<MW_MAXFREE>(" in text
        assert "mha_wgmma_enable<MW_MAXFREE>()" in text
        assert "launch_quant_rows<bf16, LN_STATS, false, ST>(" in text
        assert "launch_quant_rows<bf16, LN_NONE>(" in text
        assert "launch_row_stats(" in text


def test_qw_epilogue_takes_a_null_row_scale():
    """qgemm_wgmma.cuh's dequantizing epilogues read a null sa as a row
    scale of 1.0 (1.0f * sb == sb exactly, so K18's static GEMMs keep the
    IEEE order of their plain versions), the launch no longer refuses one,
    and its contract says so."""
    gemm = (_kernels.CSRC / "qgemm_wgmma.cuh").read_text()
    body = gemm[gemm.index("void qw_epilogue("):]
    body = body[:body.index("\n}\n")]
    assert ("const float sr = !rin ? 0.0f : p.sa != nullptr ? "
            "__ldg(p.sa + row) : 1.0f;") in body
    launch = gemm[gemm.index("inline cudaError_t launch_qgemm_epi("):]
    assert "p.sa == nullptr" not in launch
    assert "sa (null: a row scale of 1.0)" in " ".join(
        ln.lstrip("/ ") for ln in gemm.splitlines())


def test_the_int8_attention_store_is_the_static_layer_loops():
    """mha_wgmma.cuh's int8 output (K18) is an instantiation of the one
    kernel (a Q8 template flag beside the mode, the bf16 modes' store
    unchanged) and rounds as stack_wgmma.cuh's LQ_STATIC attention
    epilogue (K19b): r = (1 / l) * out_scale, then bf16(o * r), rint, the
    clip at +-127."""
    mha = (_kernels.CSRC / "mha_wgmma.cuh").read_text()
    assert "template <int MODE, bool Q8 = false, int DH = 64>" in mha
    assert mha.count("mha_wgmma_kernel(") == 1
    assert "const float rv = __fmul_rn(ol[rr], p.out_scale);" in mha
    stack = (_kernels.CSRC / "stack_wgmma.cuh").read_text()
    assert "const float rv = __fmul_rn(inv, ao_scale);" in stack
    for line in (
            "const float f0 = bf16_round(__fmul_rn(o[4 * c + 2 * rr], rv));",
            "const int q0i = static_cast<int>(fminf(fmaxf(rintf(f0), "
            "-127.0f), 127.0f));"):
        assert line in mha and line in stack, line
    assert ("__floats2bfloat162_rn(o[4 * c + 2 * rr] * ol[rr], "
            "o[4 * c + 2 * rr + 1] * ol[rr])") in mha


@pytest.mark.parametrize("source,entry", [
    ("attn_int8.cu", "vft_attn_block_int8"),
    ("mlp_int8_stats.cu", "vft_mlp_block_int8_stats"),
    ("attn_int8_static.cu", "vft_attn_block_int8_static"),
    ("attn_int8_stats.cu", "vft_attn_block_int8_stats"),
    ("mlp_int8_static.cu", "vft_mlp_block_int8_static"),
    ("attn_int8_scores.cu", "vft_attn_block_int8_scores"),
    ("quant_linear.cu", "vft_int8_linear_fused"),
    ("quant_linear.cu", "vft_quant_linear_init"),
    ("patch_embed.cu", "vft_patch_embed"),
    ("patch_embed.cu", "vft_patch_embed_init")])
def test_int8_entry_points_match_their_ctypes_signatures(source, entry):
    """The ctypes argument lists of K16's, K21a's, K18's, K21b's, K17's,
    K22's and K14's C entry points (and K10's) follow the C definitions:
    pointers, ints and floats in the same order; an init takes none."""
    src = (_kernels.CSRC / source).read_text()
    params = src[src.index(f"int {entry}("):]
    params = params[params.index("(") + 1:params.index(")")]
    kinds = []
    for p in params.split(",") if params.strip() else ():
        p = p.strip()
        kinds.append("P" if "*" in p else "F" if p.startswith("float")
                     else "I")
    argtypes, _ = _kernels._SIGNATURES[entry]
    names = {_kernels._P: "P", _kernels._I: "I", _kernels._F: "F"}
    assert [names[a] for a in argtypes] == kinds


@pytest.mark.parametrize("name,stage", [
    ("void attn_int8::quant_rows_kernel<__nv_bfloat16, 1, false, float>"
     "(__nv_bfloat16 const*, float const*)", "K16 (a)"),
    ("void attn_int8::qgemm_wgmma_kernel<256, 4>(CUtensorMap, CUtensorMap)",
     "K16 (b)"),
    ("void attn_int8::mha_wgmma_kernel<1>(CUtensorMap, MhaTmaArgs)",
     "K16 (c)"),
    ("void attn_int8::quant_rows_kernel<__nv_bfloat16, 0, false, float>"
     "(__nv_bfloat16 const*)", "K16 (d)"),
    ("void attn_int8::qgemm_wgmma_kernel<128, 3>(CUtensorMap)", "K16 (e)"),
    ("void attn_int8::qgemm_kernel<0>(attn_int8::QGemmArgs)",
     "unexpected: K16"),
    ("void mlp_int8_stats::quant_rows_kernel<__nv_bfloat16, 3, false, "
     "float>(__nv_bfloat16 const*)", "K21a (a)"),
    ("void mlp_int8_stats::qgemm_wgmma_kernel<256, 2>(CUtensorMap)",
     "K21a (b)"),
    ("void mlp_int8_stats::quant_amax_kernel(float const*, int)", "K21a (c)"),
    ("void mlp_int8_stats::qgemm_wgmma_kernel<128, 3>(CUtensorMap)",
     "K21a (d)"),
    ("void mlp_int8_stats::row_stats_kernel<float>(__nv_bfloat16 const*)",
     "K21a (e)"),
    ("void mlp_int8_stats::qgemm_kernel<2>(mlp_int8_stats::QGemmArgs)",
     "unexpected: K21a"),
    ("void attn_int8_stats::quant_rows_kernel<__nv_bfloat16, 0, false, "
     "float>(__nv_bfloat16 const*)", "K21b (d)"),
    ("void mlp_int8::qgemm_wgmma_kernel<128, 3>(CUtensorMap)", "K15 (d)"),
    ("void attn_int8::mha_wgmma_kernel<1, false>(CUtensorMap, MhaTmaArgs)",
     "K16 (c)"),
    ("void attn_int8_stats::quant_rows_kernel<__nv_bfloat16, 3, false, "
     "__nv_bfloat16>(__nv_bfloat16 const*)", "K21b (a)"),
    ("void attn_int8_stats::qgemm_wgmma_kernel<256, 4>(CUtensorMap)",
     "K21b (b)"),
    ("void attn_int8_stats::mha_wgmma_kernel<1, false>(CUtensorMap, "
     "MhaTmaArgs)", "K21b (c)"),
    ("void attn_int8_stats::qgemm_wgmma_kernel<128, 3>(CUtensorMap)",
     "K21b (e)"),
    ("void attn_int8_stats::row_stats_kernel<float>(__nv_bfloat16 const*)",
     "K21b (f)"),
    ("void attn_int8_stats::qgemm_kernel<0>(attn_int8_stats::QGemmArgs)",
     "unexpected: K21b"),
    ("void attn_int8_stats::attn_kernel(__nv_bfloat16 const*)",
     "unexpected: K21b"),
    ("void attn_int8_static::quant_rows_kernel<__nv_bfloat16, 1, true, "
     "float>(__nv_bfloat16 const*)", "K18 (a)"),
    ("void attn_int8_static::qgemm_wgmma_kernel<256, 4>(CUtensorMap)",
     "K18 (b)"),
    ("void attn_int8_static::mha_wgmma_kernel<1, true>(CUtensorMap, "
     "MhaTmaArgs)", "K18 (c)"),
    ("void attn_int8_static::qgemm_wgmma_kernel<128, 3>(CUtensorMap)",
     "K18 (d)"),
    ("void attn_int8_static::qgemm_kernel<1>(attn_int8_static::QGemmArgs)",
     "unexpected: K18"),
    ("void mlp_int8_static::quant_rows_kernel<__nv_bfloat16, 1, true, "
     "float>(__nv_bfloat16 const*)", "K17 (a)"),
    ("void mlp_int8_static::qgemm_wgmma_kernel<256, 5>(CUtensorMap)",
     "K17 (b)"),
    ("void mlp_int8_static::qgemm_wgmma_kernel<128, 3>(CUtensorMap)",
     "K17 (c)"),
    ("void mlp_int8_static::qgemm_kernel<3>(mlp_int8_static::QGemmArgs)",
     "unexpected: K17"),
    ("void attn_int8_scores::quant_rows_kernel<__nv_bfloat16, 1, true, "
     "float>(__nv_bfloat16 const*)", "K22 (a)"),
    ("void attn_int8_scores::qgemm_wgmma_kernel<256, 5>(CUtensorMap)",
     "K22 (b)"),
    ("void attn_int8_scores::vt_kernel(signed char const*, signed char*)",
     "K22 (c)"),
    ("void attn_int8_scores::attn_s8_wgmma_kernel(CUtensorMap, "
     "attn_int8_scores::S8Args)", "K22 (d)"),
    ("void attn_int8_scores::qgemm_wgmma_kernel<128, 3>(CUtensorMap)",
     "K22 (e)"),
    ("void attn_int8_scores::attn_s8_kernel(signed char const*, int)",
     "unexpected: K22"),
    ("void attn_int8_scores::qgemm_kernel<3>(attn_int8_scores::QGemmArgs)",
     "unexpected: K22"),
    ("void attn_half::mha_wgmma_kernel<1, false>(CUtensorMap, MhaTmaArgs)",
     "K1 (b)"),
    ("void quant_linear::quant_rows_kernel<__nv_bfloat16, 2, false, float>"
     "(__nv_bfloat16 const*)", "K14 (a)"),
    ("void quant_linear::qgemm_wgmma_kernel<128, 6>(CUtensorMap)",
     "K14 (b)"),
    ("void quant_linear::qgemm_wgmma_kernel<256, 6>(CUtensorMap)",
     "unexpected: K14"),
    ("void quant_linear::qgemm_kernel<0>(quant_linear::QGemmArgs)",
     "unexpected: K14"),
    ("void attn_block::mha_wgmma_kernel<2, false>(CUtensorMap, MhaTmaArgs)",
     "K4 (c) attention, safe")])
def test_profile_names_the_int8_halves_launches(name, stage):
    """profile_forward's table gives K16's, K21a's, K21b's, K18's, K17's
    and K22's wgmma launches, row passes and K22's V^T pass their steps
    (the attention's name carries its int8 flag beside the mode), and
    calls anything else of theirs (the wmma GEMM and attention tiles they
    ran before) unexpected."""
    from vit_fpga_tpu_torch import profile_forward as pf
    assert pf._stage(name).startswith(stage)


@pytest.mark.parametrize("name", ["mlp_int8_static.cu", "attn_int8_scores.cu"])
def test_k17_and_k22_run_their_gemms_on_the_int8_wgmma_gemm(name):
    """K17's W1 and W2 and K22's QKV and out-projection run on
    qgemm_wgmma.cuh with its int8 epilogue (QW_Q8: K17's hq, K22's int8
    panel) and the residual one, at a row scale of 1 (no sa), not on
    quant.cuh's wmma GEMM."""
    text = (_kernels.CSRC / name).read_text()
    body = text.split("#define VFT_NS")[1]
    for inc in ("hopper.cuh", "qgemm_wgmma.cuh"):
        assert f'#include "{inc}"' in text, inc
    assert "wmma" not in body
    for epi in ("QW_Q8", "QW_RESID"):
        assert text.count(f"launch_qgemm_epi<{epi}>(") == 1, epi
        assert f"qgemm_epi_enable<{epi}>()" in text, epi
    assert "launch_qgemm<" not in text and "qgemm_enable<" not in text
    assert "QGemmArgs" not in text and ".sa = " not in text
    assert "tma_init()" in text
    assert ("if (tma_encoder() == nullptr) return "
            "cudaErrorInitializationError;") in text


def test_k22_attention_is_a_wgmma_tma_kernel_past_256_keys():
    """K22's attention is an int8 wgmma + TMA kernel that streams the keys
    twice (the row sums, then pq and p v) through a ring: q k^T on
    64-byte-swizzled tiles, p v on the V^T pass's tiles; expf and a true
    division, not ex2.approx; no mma.sync, no whole-head tile and no
    256-key bound."""
    k22 = (_kernels.CSRC / "attn_int8_scores.cu").read_text()
    body = k22.split("#define VFT_NS")[1]
    for gone in (r"\bmma_s8\(", r"\bS8_MAX_KV\b", r"\battn_s8_kernel\b",
                 r"\bS8Smem\b", r"\bex2\(", r"\b256\b"):
        assert not re.search(gone, body), gone
    for piece in ("wgmma_m64n128k32_s8(", "wgmma_m64n64k32_s8(",
                  "sw64_desc(", "CU_TENSOR_MAP_SWIZZLE_64B",
                  "CU_TENSOR_MAP_SWIZZLE_128B", "tma_load_4d(",
                  "fence_proxy_async();", "vt_kernel<<<",
                  "attn_s8_wgmma_kernel<<<", "expf(",
                  "__fmul_rn(127.0f, __fdiv_rn(1.0f, quad_sum(l[rr])))",
                  "constexpr int S8_MAX_GRID_Y = 65535;"):
        assert piece in k22, piece
    hopper = (_kernels.CSRC / "hopper.cuh").read_text()
    assert "uint64_t sw64_desc(uint32_t saddr)" in hopper
    assert "(2ull << 62)" in hopper  # layout SWIZZLE_64B


def test_k14_launches_the_int8_wgmma_gemm_with_its_act_epilogue():
    """K14's GEMM is a qgemm_wgmma.cuh launch with the QW_ACT epilogue
    (its shared memory opted in by its init), after quant.cuh's row pass;
    not the wmma GEMM."""
    k14 = (_kernels.CSRC / "quant_linear.cu").read_text()
    for inc in ("common.cuh", "quant.cuh", "hopper.cuh", "qgemm_wgmma.cuh"):
        assert f'#include "{inc}"' in k14, inc
    assert k14.count("launch_qgemm_epi<QW_ACT>(") == 1
    assert "qgemm_epi_enable<QW_ACT>()" in k14 and "tma_init()" in k14
    assert "launch_quant_rows<" in k14
    for gone in ("launch_qgemm<", "qgemm_enable<", "QGemmArgs", "EPI_PLAIN"):
        assert gone not in k14, gone


def test_no_source_names_nvcuda_wmma():
    """The port's last wmma GEMM went with K14's move: no source under
    csrc/ names nvcuda, a wmma:: fragment or mma.h."""
    for p in _kernels.CSRC.iterdir():
        text = p.read_text()
        for gone in (r"\bnvcuda\b", r"\bwmma::", r"<mma\.h>",
                     r"namespace wmma\b"):
            assert not re.search(gone, text), (p.name, gone)


def test_quant_cuh_keeps_its_row_passes_alone():
    """quant.cuh holds the int8 row passes and nothing of the wmma GEMM
    (its kernel, opt-in, QG_ constants, arguments and EPI_PLAIN); K14's
    textbook tanh-GELU (qact) moved to common.cuh beside the static
    activation (qact_scaled) and rint_sat."""
    quant = (_kernels.CSRC / "quant.cuh").read_text()
    for kept in ("quant_rows_kernel(", "launch_quant_rows(",
                 "quant_amax_kernel(", "launch_quant_amax("):
        assert kept in quant, kept
    for p in _kernels.CSRC.iterdir():
        text = p.read_text()
        for gone in (r"\bqgemm_kernel\b", r"\bqgemm_enable\b",
                     r"\blaunch_qgemm\b", r"\bQG_\w+", r"\bQGemmArgs\b",
                     r"\bEPI_PLAIN\b", r"\bEPI_Q8\b", r"\bEPI_RESID\b",
                     r"\bmma_s8\b"):
            assert not re.search(gone, text), (p.name, gone)
    common = (_kernels.CSRC / "common.cuh").read_text()
    assert "float qact(float h, int act)" in common
    assert "constexpr int ACT_GELU_TANH_JAX = 5;" in common
    assert "float qact_scaled(float h, int act, float s)" in common
    assert "signed char rint_sat(float v)" in common


def test_qw_act_takes_any_n_by_tma_or_from_the_registers():
    """QW_ACT is qw_epilogue's K14 output: act(f) through qact (the
    textbook tanh-GELU, not K15's act_rn), bf16 or f32 chosen at run time,
    the sb / bias columns past a ragged N not read, and a row stride that
    is no multiple of 16 bytes stored from the registers; 128-wide tiles
    at every N."""
    gemm = (_kernels.CSRC / "qgemm_wgmma.cuh").read_text()
    assert "QW_ACT = 6" in gemm and "int y_f32, y_regs;" in gemm
    body = gemm[gemm.index("void qw_epilogue("):]
    body = body[:body.index("\n}\n")]
    assert "f[e] = qact(f[e], p.act);" in body
    assert "if (A && c >= p.N) return;" in body
    assert "c + e < p.N ? __ldg(p.sb + c + e) : 0.0f" in body
    launch = gemm[gemm.index("inline cudaError_t launch_qgemm_epi("):]
    assert "q.y_regs = EPI == QW_ACT && (p.N * eb) % 16 != 0;" in launch
    assert ("const int bn = EPI == QW_RESID || EPI == QW_ACT ? 128 : "
            "qgemm_wgmma_tile_n(p.N);") in launch


def test_k10_runs_the_bf16_wgmma_gemm_over_three_pieces():
    """K10 splits the f32 weights into three bf16 planes, patchifies the
    images into bf16 rows and runs gemm_wgmma.cuh's GEMM over the planes,
    A read three times over (a_period); no f32 FMA tile."""
    k10 = (_kernels.CSRC / "patch_embed.cu").read_text()
    for inc in ("common.cuh", "hopper.cuh", "gemm_wgmma.cuh"):
        assert f'#include "{inc}"' in k10, inc
    for piece in ("split_kernel<<<", "patchify_kernel<true><<<",
                  "patchify_kernel<false><<<", "p.a_period = kq;",
                  "launch_gemm_wgmma(am, pl, false, p, st)",
                  "launch_gemm_wgmma<GW_AK_BN, GW_EPI_F32>(am, pl, false, p, st)",
                  "bad += !(lo == r2)", "atomicAdd(inexact, bad)"):
        assert piece in k10, piece
    assert "fmaf(" not in k10 and "As[BK]" not in k10
    gemm = (_kernels.CSRC / "gemm_wgmma.cuh").read_text()
    assert "kt * GW_BK % p.a_period" in gemm


def test_qw_q8_is_a_saturating_int8_epilogue_stored_by_tma():
    """QW_Q8 is a third output kind of qw_epilogue (128 int8 columns a
    piece) in the order of the wmma GEMM's former int8 epilogue:
    rint_sat(qact_scaled(f, act, qscale)) on the one dequantized f, stored
    through an int8 map."""
    gemm = (_kernels.CSRC / "qgemm_wgmma.cuh").read_text()
    body = gemm[gemm.index("void qw_epilogue("):]
    body = body[:body.index("\n}\n")]
    assert "constexpr int EB = H ? 4 : EPI == QW_Q8 ? 1 : 2;" in body
    assert "rint_sat(qact_scaled(f[e], p.act, p.qscale))" in body
    assert "float qscale;" in gemm and "QW_Q8 = 5" in gemm
    launch = gemm[gemm.index("inline cudaError_t launch_qgemm_epi("):]
    assert "EPI == QW_Q8 ? tma_encode_s8(&tc, out, 2, dims, strides, box)" \
        in launch


def test_k25_moves_16_bytes_a_thread_and_no_longer_stages_bytes():
    """K25 loads each row of its strip as one 16-byte read-only load and
    stores each output row with one 16-byte streaming store (uint4), takes
    the bytes beside its chunk from its neighbour lanes, and no longer
    stages the frame byte by byte through shared memory with a divide by
    the halo width."""
    src = (_kernels.CSRC / "image_filter.cu").read_text()
    assert "__ldg(reinterpret_cast<const uint4*>(p))" in src
    assert "__stcs(reinterpret_cast<uint4*>(p)" in src
    assert "__shfl_up_sync(" in src and "__shfl_down_sync(" in src
    for gone in ("__shared__", "HALO_W", "__syncthreads", "roundf("):
        assert gone not in src, gone
    assert not re.search(r"[/%] *HALO", src)


@pytest.mark.parametrize("entry", ["vft_image_filter",
                                   "vft_image_filter_chunk"])
def test_k25_entry_points_match_their_ctypes_signatures(entry):
    """vft_image_filter keeps its C signature (in, out, taps, h, w,
    stream) and the ctypes argument list of ops/_kernels.py; so does the
    chunk query beside it."""
    import ctypes
    src = (_kernels.CSRC / "image_filter.cu").read_text()
    params = src[src.index(f"int {entry}("):]
    params = params[params.index("(") + 1:params.index(")")]
    kinds = ["P" if "*" in p else "F" if p.strip().startswith("float")
             else "I" for p in params.split(",")]
    argtypes, restype = _kernels._SIGNATURES[entry]
    names = {_kernels._P: "P", _kernels._I: "I", _kernels._F: "F",
             ctypes.POINTER(_kernels._F): "P"}
    assert [names[a] for a in argtypes] == kinds
    assert restype is ctypes.c_int
    if entry == "vft_image_filter":
        assert params.split() == ["const", "void*", "in,", "void*", "out,",
                                  "const", "float*", "taps,", "int", "h,",
                                  "int", "w,", "void*", "stream"]


def test_no_token_cap_in_the_attention_halves():
    """K1, K4 and K23 take the JAX gates (ops/attn_block.attn_stats_fits,
    attn_block_fits, _bwd_fits), not a fixed token count: no source or
    module of the port names the old 1024-token caps."""
    root = _kernels.CSRC.parent
    for p in list(_kernels.CSRC.iterdir()) + list(root.rglob("*.py")):
        text = p.read_text()
        for cap in ("LONG_MAX_TOKENS", "AH_MAX_TOKENS", "AB_MAX_TOKENS"):
            assert cap not in text, (p.name, cap)


def test_the_attention_core_takes_head_dim_80_where_vit_h14_runs():
    """mha_wgmma.cuh's head dim is a template parameter (64, or 80 as a
    64-column box 128-byte swizzled and a 16-column one 32-byte swizzled,
    whose p v step is m64n16k16), instantiated at 80 only for the kernels
    on ViT-H/14's path: K4's two softmax modes, K16, K18 (its int8 store)
    and K23's two attention-backward kernels; K1, K7 / K8, K9 and K21b
    keep head dim 64 (no template argument 80 in their sources)."""
    mha = (_kernels.CSRC / "mha_wgmma.cuh").read_text()
    hop = (_kernels.CSRC / "hopper.cuh").read_text()
    assert "static_assert(DH == 64 || DH == 80" in mha
    assert "CU_TENSOR_MAP_SWIZZLE_32B" in mha and "sw32_desc(" in mha
    assert "m64n16k16.f32.bf16.bf16" in hop and "(3ull << 62)" in hop
    for src, insts in (
            ("attn_block.cu", ("mha_wgmma_enable<MW_MAXFREE, false, 80>",
                               "mha_wgmma_enable<MW_SAFE, false, 80>",
                               "launch_attn_half<MW_SAFE, 80>",
                               "launch_attn_half<MW_MAXFREE, 80>")),
            ("attn_int8.cu", ("mha_wgmma_enable<MW_MAXFREE, false, 80>",
                              "launch_mha_packed<MW_MAXFREE, false, 80>")),
            ("attn_int8_static.cu", ("mha_wgmma_enable<MW_MAXFREE, true, 80>",
                                     "launch_mha_packed<MW_MAXFREE, true, 80>")),
            ("attn_bwd.cu", ("bwd_enable<80>", "launch_attn_bwd_core<80>"))):
        text = (_kernels.CSRC / src).read_text()
        for inst in insts:
            assert inst in text, (src, inst)
    for src in ("attn_stats.cu", "mha.cu", "flash_attn.cu",
                "attn_int8_stats.cu"):
        text = (_kernels.CSRC / src).read_text()
        assert not re.search(r"[<,]\s*80\s*>", text), src


def _strip_comments(text):
    text = re.sub(r"/\*.*?\*/", "", text, flags=re.S)
    return re.sub(r"//[^\n]*", "", text)


def _body(text, entry):
    """The brace-matched body of the C function ``int entry(...)``."""
    start = text.index("{", text.index(f"int {entry}("))
    depth = 0
    for i in range(start, len(text)):
        depth += {"{": 1, "}": -1}.get(text[i], 0)
        if depth == 0:
            return text[start:i + 1]
    raise AssertionError(f"{entry}: unbalanced braces")


F32_ENTRIES = (("attn_stats.cu", "vft_attn_block_stats_f32"),
               ("mlp_chunk_stats.cu", "vft_fused_mlp_stats_f32"),
               ("attn_block.cu", "vft_attn_block_fwd_f32"),
               ("flash_attn.cu", "vft_flash_attention_f32"))
F32_HEADERS = ("gemm_f32.cuh", "seq_attn.cuh", "attn_half_f32.cuh")
# a TF32 path, any tensor-core product (mma.sync, wmma, wgmma) or a bf16
# staging type
NOT_TRUE_F32 = re.compile(r"tf32|mma|bf16|bfloat16|half2|__half\b|fp16",
                          re.I)


@pytest.mark.parametrize("source,entry", F32_ENTRIES)
def test_f32_entry_points_run_true_f32_on_the_cuda_cores(source, entry):
    """The f32 modes of K1, K2 / K3, K4 and K9 launch only the f32 pieces
    (gemm_f32.cuh's GEMM, seq_attn.cuh's attention, attn_half_f32.cuh's
    sequence, the f32 row stats), and neither their bodies nor those
    headers (comments aside) name a TF32 path, a tensor-core product or a
    bf16 staging type, so no quiet TF32 or bf16 route can creep in."""
    body = _strip_comments(_body((_kernels.CSRC / source).read_text(),
                                 entry))
    assert not NOT_TRUE_F32.search(body), NOT_TRUE_F32.search(body)
    launched = set(re.findall(r"\b(launch_\w+)\s*[<(]", body))
    assert launched, entry
    assert launched <= {"launch_gemm_f32", "launch_seq_attn_f32",
                        "launch_attn_half_f32", "launch_row_stats_f32"}, \
        launched
    assert "const float*" in body or "SeqAttnArgs" in body
    for name in F32_HEADERS:
        code = _strip_comments((_kernels.CSRC / name).read_text())
        assert not NOT_TRUE_F32.search(code), (name,
                                               NOT_TRUE_F32.search(code))
        assert "#include" not in code, name
        assert "fmaf(" in code or name == "attn_half_f32.cuh", name


@pytest.mark.parametrize("source,entry", F32_ENTRIES)
def test_f32_entry_points_match_their_ctypes_signatures(source, entry):
    """The ctypes argument lists of the f32 entry points follow the C
    definitions: pointers, ints, long longs and floats in order."""
    src = (_kernels.CSRC / source).read_text()
    params = src[src.index(f"int {entry}("):]
    params = params[params.index("(") + 1:params.index(")")]
    kinds = []
    for p in params.split(","):
        p = p.strip()
        kinds.append("P" if "*" in p else "F" if p.startswith("float")
                     else "L" if p.startswith("long long") else "I")
    argtypes, _ = _kernels._SIGNATURES[entry]
    names = {_kernels._P: "P", _kernels._I: "I", _kernels._F: "F",
             _kernels._L: "L"}
    got = ["P" if a not in names else names[a] for a in argtypes]
    assert got == kinds


@pytest.mark.parametrize("name,stage", [
    ("void attn_half::gemm_f32_kernel<1, 1, 8>(attn_half::FgArgs)",
     "K1 f32 (a)"),
    ("void attn_half::seq_attn_f32_kernel<64, 1>(attn_half::SeqAttnArgs)",
     "K1 f32 (b)"),
    ("void attn_half::gemm_f32_kernel<0, 3, 8>(attn_half::FgArgs)",
     "K1 f32 (c)"),
    ("void attn_half::row_stats_f32_kernel(float const*, float*, int, int, "
     "float)", "K1 f32 (d)"),
    ("void mlp_chunk::gemm_f32_kernel<1, 2, 8>(mlp_chunk::FgArgs)",
     "K2 / K3 f32 (a)"),
    ("void mlp_chunk::gemm_f32_kernel<0, 3, 8>(mlp_chunk::FgArgs)",
     "K2 / K3 f32 (b)"),
    ("void attn_block::row_stats_f32_kernel(float const*)", "K4 f32 (a)"),
    ("void attn_block::gemm_f32_kernel<1, 1, 4>(attn_block::FgArgs)",
     "K4 f32 (b)"),
    ("void attn_block::seq_attn_f32_kernel<80, 0>(attn_block::SeqAttnArgs)",
     "K4 f32 (c) attention, safe"),
    ("void attn_block::seq_attn_f32_kernel<64, 1>(attn_block::SeqAttnArgs)",
     "K4 f32 (c) attention, max-free"),
    ("void attn_block::gemm_f32_kernel<0, 3, 4>(attn_block::FgArgs)",
     "K4 f32 (d)"),
    ("void flash_attn::seq_attn_f32_kernel<64, 0>(flash_attn::SeqAttnArgs)",
     "K9 flash attention, f32"),
    ("void mha::seq_attn_f32_kernel<64, 0>(mha::SeqAttnArgs)",
     "K7 / K8 attention, f32")])
def test_profile_names_the_f32_launches(name, stage):
    """profile_forward's table gives each f32 launch of K1, K2 / K3, K4
    and K9 its step; none falls into the torch ops."""
    from vit_fpga_tpu_torch import profile_forward as pf
    assert pf._stage(name).startswith(stage)
