"""The kernel build lists every CUDA source and header of the port, so that
an edited or new file changes the build hash and rebuilds the library."""

import re

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
