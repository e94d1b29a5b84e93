"""Device selection for the port: CUDA unless the caller asks for the CPU.

Entry points take ``device=None`` and resolve it here.  With no GPU and
no explicit CPU request they raise; they never drop to the CPU quietly.
"""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means ``"cuda"``; a CUDA request without a usable card
    raises instead of falling back."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def require_hopper(device=None) -> str:
    """Raise unless the card is Hopper (compute capability 9.0), which
    the sm_90a kernels need; returns the card's name."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("the Hopper kernels need a CUDA device")
    cap = torch.cuda.get_device_capability(dev)
    if cap != (9, 0):
        raise RuntimeError(
            f"kernels are built for sm_90a (Hopper); "
            f"{torch.cuda.get_device_name(dev)} has capability {cap}")
    return torch.cuda.get_device_name(dev)


@contextlib.contextmanager
def true_f32():
    """f32 matmuls and convolutions in true f32 for the enclosed region:
    TF32 off for both (the JAX package's ``Precision.HIGHEST``)."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def tanh_plain(u: torch.Tensor) -> torch.Tensor:
    """tanh for the plain versions: ``torch.tanh`` on the card; on the
    CPU ``2 sigmoid(2u) - 1`` (ATen's vectorised sigmoid, within about
    1e-7 of tanh), because ``torch.tanh``'s CPU kernel hands f32 tensors
    to MKL VML's vmsTanh in 2048-element pieces over the OpenMP threads,
    and on rare first calls in a fresh process the pieces of the worker
    threads came back up to 5.2e-5 off (VML's enhanced-performance
    accuracy reads 6.6e-5 on the same data; a second call was exact):
    ``experiments/torch_cpu_tanh_replay.py``."""
    if u.device.type != "cpu":
        return torch.tanh(u)
    return 2.0 * torch.sigmoid(2.0 * u) - 1.0
