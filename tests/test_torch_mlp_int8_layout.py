"""K15's host-side layout on the CPU: the count of h's per-tile row maxima,
its scratch and the C entry point's argument list, which the kernel checks
on the card (a wrong count raises there)."""

import re

import pytest
import torch

from vit_fpga_tpu_torch.ops import _kernels
from vit_fpga_tpu_torch.ops import quant_block as qb


@pytest.mark.parametrize("m,parts", [(16, 1), (128, 1), (144, 1), (256, 1),
                                     (400, 2), (1552, 7), (3072, 12),
                                     (4096, 16)])
def test_mlp_int8_parts_counts_the_w1_column_tiles(m, parts):
    """One part a column tile of the int8 GEMM: 128 columns where M fits in
    128, else 256; a ragged M (1552 = 6 x 256 + 16) has a partial last
    tile of its own."""
    assert qb.mlp_int8_parts(m) == parts


def test_mlp_int8_parts_follows_the_gemm_tile_rule():
    gemm = (_kernels.CSRC / "qgemm_wgmma.cuh").read_text()
    assert ("inline int qgemm_wgmma_tile_n(int N) "
            "{ return N <= 128 ? 128 : 256; }") in gemm
    assert "nparts != qgemm_wgmma_col_tiles(m)" in (
        _kernels.CSRC / "mlp_int8.cu").read_text()


@pytest.mark.parametrize("t,d,m", [(197, 400, 1552), (12800, 768, 3072)])
def test_mlp_int8_scratch(t, d, m):
    """xq (T, D) and hq (T, M) int8 with their f32 row scales, the f32 h
    and the row maxima (parts, T), in the C order."""
    xq, sx, hq, sh, h, parts = qb._mlp_int8_scratch(t, d, m, "meta")
    assert (xq.shape, xq.dtype) == ((t, d), torch.int8)
    assert (hq.shape, hq.dtype) == ((t, m), torch.int8)
    assert sx.shape == sh.shape == (t,)
    assert sx.dtype == sh.dtype == torch.float32
    assert (h.shape, h.dtype) == ((t, m), torch.float32)
    assert (parts.shape, parts.dtype) == ((qb.mlp_int8_parts(m), t),
                                          torch.float32)


def test_mlp_int8_entry_point_matches_its_ctypes_signature():
    """The ctypes argument list of vft_mlp_block_int8 follows the C
    definition: pointers, ints and the float in the same order."""
    src = (_kernels.CSRC / "mlp_int8.cu").read_text()
    params = src[src.index("int vft_mlp_block_int8("):]
    params = params[params.index("(") + 1:params.index(")")]
    kinds = []
    for p in params.split(","):
        p = p.strip()
        kinds.append("P" if "*" in p else "F" if p.startswith("float")
                     else "I")
    argtypes, restype = _kernels._SIGNATURES["vft_mlp_block_int8"]
    names = {_kernels._P: "P", _kernels._I: "I", _kernels._F: "F"}
    assert [names[a] for a in argtypes] == kinds
    assert re.search(r"\bint nparts\b", params)
