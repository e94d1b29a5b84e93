"""Build and load the port's CUDA kernels.

The sources under ``vit_fpga_tpu_torch/csrc/`` have a plain C interface.
At first use they are compiled with ``nvcc`` for ``sm_90a`` (one process
per ``.cu`` file, all started together), linked into one shared library
and loaded with ``ctypes``.  The library lands in
``vit_fpga_tpu_torch/_build/<hash of sources and flags>/``, so an edited
source rebuilds and an unchanged one loads what is there.  Nothing is
built when the module is imported.  ``launch_target`` readies the library
on a device (shared-memory opt-ins, once per device) and gives the stream
to launch on.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
SOURCES = ("attn_stats.cu", "mlp_stats.cu", "attn_block.cu", "mlp.cu",
           "attn_bwd.cu", "mlp_bwd.cu", "quant_linear.cu", "mlp_int8.cu",
           "attn_int8.cu", "vit_stack.cu", "vit_stack_int8.cu",
           "mlp_int8_static.cu", "attn_int8_static.cu",
           "vit_stack_int8_static.cu", "image_filter.cu", "int8_gemm.cu",
           "mlp_chunk_stats.cu", "vit_full.cu", "vit_full_int8.cu",
           "mlp_chunk.cu", "mha.cu", "flash_attn.cu", "mlp_int8_stats.cu",
           "attn_int8_stats.cu", "attn_int8_scores.cu", "patch_embed.cu",
           "streamed_gemm.cu")
HEADERS = ("common.cuh", "attn.cuh", "norm.cuh", "quant.cuh", "stack.cuh",
           "stack_bf16.cuh", "stack_i8.cuh", "full.cuh", "chunk.cuh",
           "seq_attn.cuh", "mha_wgmma.cuh", "hopper.cuh", "gemm_wgmma.cuh",
           "attn_half.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIB_NAME = "libvit_kernels.so"
LOG_NAME = "build.log"

_lock = threading.RLock()
_lib: ctypes.CDLL | None = None
_ready: set[int] = set()             # devices whose init entry points ran
build_seconds: float | None = None   # wall time of the build this process ran
build_log: str = ""                  # nvcc's output: ptxas registers, spills

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
_SIGNATURES = {
    "vft_attn_init": ([], ctypes.c_int),
    "vft_attn_block_stats": (
        [_P] * 12 + [_I] * 5 + [_F, _F, _P, ctypes.POINTER(_I)],
        ctypes.c_int),
    "vft_mlp_init": ([], ctypes.c_int),
    "vft_fused_mlp_stats": (
        [_P] * 11 + [_I] * 4 + [_F, _P], ctypes.c_int),
    "vft_mlp_chunk_init": ([], ctypes.c_int),
    "vft_fused_mlp_chunked_stats": (
        [_P] * 11 + [_I] * 5 + [_F, _P], ctypes.c_int),
    "vft_attn_block_init": ([], ctypes.c_int),
    "vft_attn_block_fwd": ([_P] * 11 + [_I] * 6 + [_F, _F, _P, ctypes.POINTER(_I)],
                           ctypes.c_int),
    "vft_fused_mlp_init": ([], ctypes.c_int),
    "vft_fused_mlp": ([_P] * 10 + [_I] * 4 + [_F, _P], ctypes.c_int),
    "vft_attn_bwd_init": ([], ctypes.c_int),
    "vft_attn_bwd_workspace": ([_I] * 3, ctypes.c_size_t),
    "vft_attn_block_bwd": ([_P] * 14 + [_I] * 5 + [_F, _F, _P], ctypes.c_int),
    "vft_mlp_bwd_init": ([], ctypes.c_int),
    "vft_mlp_bwd_workspace": ([_I] * 3, ctypes.c_size_t),
    "vft_fused_mlp_bwd": ([_P] * 14 + [_I] * 4 + [_F, _P], ctypes.c_int),
    "vft_quant_linear_init": ([], ctypes.c_int),
    "vft_int8_linear_fused": ([_P] * 9 + [_I] * 7 + [_F, _P], ctypes.c_int),
    "vft_mlp_int8_init": ([], ctypes.c_int),
    "vft_mlp_block_int8": ([_P] * 14 + [_I] * 4 + [_F, _P], ctypes.c_int),
    "vft_attn_int8_init": ([], ctypes.c_int),
    "vft_attn_block_int8": ([_P] * 14 + [_I] * 5 + [_F, _F, _P],
                            ctypes.c_int),
    "vft_vit_stack_init": ([], ctypes.c_int),
    "vft_vit_stack_workspace": ([_I] * 3, ctypes.c_size_t),
    "vft_vit_layers": ([_P] * 15 + [_I] * 8 + [_F, _F, _P, _P],
                       ctypes.c_int),
    "vft_vit_stack_int8_init": ([], ctypes.c_int),
    "vft_vit_stack_int8_workspace": ([_I] * 3, ctypes.c_size_t),
    "vft_vit_layers_int8": ([_P] * 19 + [_I] * 8 + [_F, _F, _P, _P],
                            ctypes.c_int),
    "vft_mlp_int8_static_init": ([], ctypes.c_int),
    "vft_mlp_block_int8_static": ([_P] * 12 + [_I] * 4 + [_F, _F, _P],
                                  ctypes.c_int),
    "vft_attn_int8_static_init": ([], ctypes.c_int),
    "vft_attn_block_int8_static": ([_P] * 12 + [_I] * 5 + [_F] * 3 + [_P],
                                   ctypes.c_int),
    "vft_vit_stack_int8_static_init": ([], ctypes.c_int),
    "vft_vit_stack_int8_static_workspace": ([_I] * 3, ctypes.c_size_t),
    "vft_vit_layers_int8_static": ([_P] * 21 + [_I] * 8 + [_F, _F, _P, _P],
                                   ctypes.c_int),
    "vft_image_filter": ([_P, _P, ctypes.POINTER(_F), _I, _I, _P],
                         ctypes.c_int),
    "vft_int8_gemm_init": ([], ctypes.c_int),
    "vft_int8_gemm": ([_P] * 3 + [_I] * 3 + [_P], ctypes.c_int),
    "vft_vit_full_init": ([], ctypes.c_int),
    "vft_vit_full_workspace": ([_I] * 4, ctypes.c_size_t),
    "vft_vit_full": ([_P] * 21 + [_I] * 13 + [_F, _F, _P, _P], ctypes.c_int),
    "vft_vit_full_int8_init": ([], ctypes.c_int),
    "vft_vit_full_int8_workspace": ([_I] * 4, ctypes.c_size_t),
    "vft_vit_full_int8": ([_P] * 27 + [_I] * 13 + [_F, _F, _P, _P],
                          ctypes.c_int),
    "vft_mlp_chunk_blk_init": ([], ctypes.c_int),
    "vft_fused_mlp_chunked": ([_P] * 10 + [_I] * 5 + [_F, _P], ctypes.c_int),
    "vft_mha_init": ([], ctypes.c_int),
    "vft_mha": ([_P] * 4 + [_L, _L, _I, _L, _L] + [_I] * 6 + [_F, _P],
                ctypes.c_int),
    "vft_flash_init": ([], ctypes.c_int),
    "vft_flash_attention": ([_P] * 4 + [_L, _L, _I, _L, _L] + [_I] * 6
                            + [_F, _P], ctypes.c_int),
    "vft_mlp_int8_stats_init": ([], ctypes.c_int),
    "vft_mlp_block_int8_stats": ([_P] * 16 + [_I] * 5 + [_F, _P],
                                 ctypes.c_int),
    "vft_attn_int8_stats_init": ([], ctypes.c_int),
    "vft_attn_block_int8_stats": ([_P] * 16 + [_I] * 6 + [_F, _F, _P],
                                  ctypes.c_int),
    "vft_attn_int8_scores_init": ([], ctypes.c_int),
    "vft_attn_block_int8_scores": ([_P] * 12 + [_I] * 5 + [_F] * 3 + [_P],
                                   ctypes.c_int),
    "vft_patch_embed": ([_P] * 4 + [_I] * 6 + [_P], ctypes.c_int),
    "vft_streamed_gemm_init": ([], ctypes.c_int),
    "vft_streamed_gemm": ([_P] * 3 + [_I] * 4 + [_P], ctypes.c_int),
    "vft_error_string": ([_I], ctypes.c_char_p),
}
# Each source's init entry point, run once per device before its launches.
_INITS = ("vft_attn_init", "vft_mlp_init", "vft_attn_block_init",
          "vft_fused_mlp_init", "vft_attn_bwd_init", "vft_mlp_bwd_init",
          "vft_quant_linear_init", "vft_mlp_int8_init", "vft_attn_int8_init",
          "vft_vit_stack_init", "vft_vit_stack_int8_init",
          "vft_mlp_int8_static_init", "vft_attn_int8_static_init",
          "vft_vit_stack_int8_static_init", "vft_int8_gemm_init",
          "vft_mlp_chunk_init", "vft_vit_full_init", "vft_vit_full_int8_init",
          "vft_mlp_chunk_blk_init", "vft_mha_init", "vft_flash_init",
          "vft_mlp_int8_stats_init", "vft_attn_int8_stats_init",
          "vft_attn_int8_scores_init", "vft_streamed_gemm_init")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def _key() -> str:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the sources (if this hash has no library yet) and return
    the library's path; nvcc's output is kept in ``build_log`` and beside
    the library (``LOG_NAME``), which a later process reads back."""
    global build_seconds, build_log
    out_dir = BUILD_ROOT / _key()
    lib = out_dir / LIB_NAME
    if lib.exists():
        saved = out_dir / LOG_NAME
        build_log = saved.read_text() if saved.exists() else ""
        return lib
    nvcc = _nvcc()
    t0 = time.perf_counter()
    out_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        procs = []
        for src in SOURCES:
            obj = Path(tmp) / (Path(src).stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c",
                   str(CSRC / src), "-o", str(obj)]
            procs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failed = [], []
        for cmd, _, proc in procs:
            out, _ = proc.communicate()
            logs.append(out)
            if proc.returncode != 0:
                failed.append(f"{' '.join(cmd)}\n{out}")
        build_log = "\n".join(logs)
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        (Path(tmp) / LOG_NAME).write_text(build_log)
        tmp_lib = Path(tmp) / LIB_NAME
        link = [nvcc, "-shared", *NVCC_FLAGS[:2], "-o", str(tmp_lib),
                *[str(obj) for _, obj, _ in procs]]
        res = subprocess.run(link, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"link failed: {' '.join(link)}\n{res.stdout}")
        os.replace(Path(tmp) / LOG_NAME, out_dir / LOG_NAME)
        os.replace(tmp_lib, lib)
    build_seconds = time.perf_counter() - t0
    return lib


def load() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, (argtypes, restype) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _lib = lib
        return _lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        name = load().vft_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({name})")


def launch_target() -> tuple[ctypes.CDLL, int]:
    """The library, ready on the current CUDA device, and that device's
    current stream handle.  The caller makes the tensors' device current
    (``torch.cuda.device``) around this and the launch."""
    import torch
    lib = load()
    index = torch.cuda.current_device()
    if index not in _ready:
        with _lock:
            if index not in _ready:
                for name in _INITS:
                    check(getattr(lib, name)(), name)
                _ready.add(index)
    return lib, torch.cuda.current_stream().cuda_stream
