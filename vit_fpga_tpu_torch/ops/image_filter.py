"""Streaming 3x3 image filter, the reference's ``image_process`` (the
counterpart of the JAX package's ops/image_filter.py).

Semantics, shared by every implementation: 3x3 convolution of an (H, W)
uint8 frame, zero padding at the borders, float32 accumulate, round half
to even, clip to [0, 255], back to uint8.

  * :func:`filter_image_numpy` -- the host oracle (copied).
  * :func:`filter_image_plain` -- the plain PyTorch version: the nine taps
    as shifted f32 adds over a zero-padded frame, in the oracle's order.
  * :func:`filter_image_device` -- the wrapper: a CPU tensor runs the plain
    version, a CUDA tensor launches K25 or raises.

K25 (``csrc/image_filter.cu``) replaces
``vit_fpga_tpu/ops/image_filter.py:_filter_kernel`` (wrapper
``filter_image_pallas``).  Every product and partial sum of the four
filters is a small integer or a multiple of 1/16, so the f32 sums are
exact in any order and the kernel equals the oracle bit for bit.  The
JAX package's VMEM gate (``fits_vmem``) and its XLA fallback are TPU
matters: a frame of any H x W goes to the kernel.  Each of its threads
takes a chunk of 16 columns (one 16-byte load a row) where W is a
multiple of 16 and both frames are 16-byte aligned, and of one column
otherwise (:func:`filter_chunk_bytes`): one kernel, two widths of chunk.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _kernels

# 3x3 filter taps, name -> kernel. float32, row-major [dy][dx].
FILTERS = {
    "sharpen": np.array([[0, -1, 0], [-1, 5, -1], [0, -1, 0]],
                        dtype=np.float32),
    "blur": np.array([[1, 2, 1], [2, 4, 2], [1, 2, 1]],
                     dtype=np.float32) / 16.0,
    "edge": np.array([[0, 1, 0], [1, -4, 1], [0, 1, 0]], dtype=np.float32),
    "identity": np.array([[0, 0, 0], [0, 1, 0], [0, 0, 0]], dtype=np.float32),
}


def filter_image_numpy(img: np.ndarray, name: str) -> np.ndarray:
    """Oracle implementation. ``img`` is (H, W) uint8; returns (H, W) uint8."""
    k = FILTERS[name]
    h, w = img.shape
    p = np.zeros((h + 2, w + 2), dtype=np.float32)
    p[1:-1, 1:-1] = img.astype(np.float32)
    acc = np.zeros((h, w), dtype=np.float32)
    for dy in range(3):
        for dx in range(3):
            if k[dy, dx] != 0.0:
                acc += k[dy, dx] * p[dy:dy + h, dx:dx + w]
    return np.clip(np.rint(acc), 0, 255).astype(np.uint8)


def _check_frame(img: torch.Tensor, name: str) -> None:
    if name not in FILTERS:
        raise ValueError(f"unknown image filter {name!r}")
    if img.dim() != 2 or img.dtype != torch.uint8:
        raise ValueError(f"frame must be (H, W) uint8, got "
                         f"{tuple(img.shape)} {img.dtype}")


def filter_image_plain(img: torch.Tensor, name: str) -> torch.Tensor:
    """Plain PyTorch version of K25, on ``img``'s device."""
    _check_frame(img, name)
    k = torch.from_numpy(FILTERS[name])
    h, w = img.shape
    p = torch.zeros((h + 2, w + 2), dtype=torch.float32, device=img.device)
    p[1:h + 1, 1:w + 1] = img.float()
    acc = torch.zeros((h, w), dtype=torch.float32, device=img.device)
    for dy in range(3):
        for dx in range(3):
            if k[dy, dx] != 0.0:
                acc += k[dy, dx].to(img.device) * p[dy:dy + h, dx:dx + w]
    return torch.clamp(torch.round(acc), 0, 255).to(torch.uint8)


def filter_image_device(img: torch.Tensor, name: str) -> torch.Tensor:
    """(H, W) uint8 -> (H, W) uint8 filtered frame on ``img``'s device.

    A CPU tensor runs :func:`filter_image_plain`; a CUDA tensor launches
    the K25 kernel or raises."""
    if img.device.type == "cpu":
        return filter_image_plain(img, name)
    if img.device.type != "cuda":
        raise ValueError(f"unsupported device {img.device}")
    _check_frame(img, name)
    img = img.contiguous()
    h, w = img.shape
    out = torch.empty((h, w), dtype=torch.uint8, device=img.device)
    if h == 0 or w == 0:
        return out
    taps = (ctypes.c_float * 9)(*FILTERS[name].reshape(-1).tolist())
    with torch.cuda.device(img.device):
        lib, stream = _kernels.launch_target()
        err = lib.vft_image_filter(img.data_ptr(), out.data_ptr(), taps, h,
                                   w, stream)
    _kernels.check(err, "image_filter")
    filter_image_device.launches += 1
    return out


filter_image_device.launches = 0


def filter_chunk_bytes(img: torch.Tensor, out: torch.Tensor) -> int:
    """The columns a K25 thread takes for the CUDA frames ``img`` -> ``out``
    (the kernel's own rule): 16 where the width is a multiple of 16 and
    both frames are 16-byte aligned, else 1.  Launches nothing."""
    if img.device.type != "cuda" or out.device.type != "cuda":
        raise ValueError("K25's chunk is a question about CUDA frames")
    return _kernels.load().vft_image_filter_chunk(img.data_ptr(),
                                                  out.data_ptr(),
                                                  img.shape[1])
