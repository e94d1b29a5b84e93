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
