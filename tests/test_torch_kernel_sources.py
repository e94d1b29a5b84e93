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
    chunk.cuh's wmma chunk_down_kernel, which K6 alone keeps."""
    k3 = (_kernels.CSRC / "mlp_chunk_stats.cu").read_text()
    assert '#include "chunk.cuh"' not in k3
    assert "launch_chunk_down(" not in k3 and "launch_gemm_t<" not in k3
    assert "down.chunk_k = m / n_chunks;" in k3
    k6 = (_kernels.CSRC / "mlp_chunk.cu").read_text()
    assert "launch_chunk_down(" in k6


@pytest.mark.parametrize("name", ["attn_block.cu", "mlp_bwd.cu"])
def test_k4_and_k24_include_the_wgmma_gemm(name):
    """K4 and K24 run gemm_wgmma.cuh's wgmma + TMA GEMM (K4 through
    attn_half.cuh, the launch sequence it shares with K1)."""
    text = (_kernels.CSRC / name).read_text()
    assert '#include "gemm_wgmma.cuh"' in text
    assert "wmma" not in text.split("#define VFT_NS")[1]


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
    """attn.cuh keeps the whole-head tile of the int8 halves only."""
    text = (_kernels.CSRC / "attn.cuh").read_text()
    assert "attn_long_kernel" not in text
    assert "launch_attn_long" not in text
    common = (_kernels.CSRC / "common.cuh").read_text()
    assert "inline cudaError_t launch_gemm(" not in common


def test_no_sum_of_the_port_uses_atomics():
    """K24's sums run in a fixed order: no atomic in the GEMM or in its
    launch sequence."""
    for name in ("gemm_wgmma.cuh", "mlp_bwd.cu", "norm.cuh"):
        text = (_kernels.CSRC / name).read_text()
        assert not re.search(r"\batomic[A-Z]\w*\s*\(|\batom\.|\bred\.", text), name
