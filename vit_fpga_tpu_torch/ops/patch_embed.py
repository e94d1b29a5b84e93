"""Patch embedding: the transpose-free embed of the serving path, and the
uint8 patch-embed kernel K10 (counterparts of the JAX package's
ops/patch_embed.py).

* :func:`embed_tokens_dotg` -- the main path's embed.  The JAX package
  leaves this stage to XLA: one GEMM whose contraction runs over the (py)
  and (px, c) axes of a contiguous (B, gh, P, gw, P*3) view of the image,
  with bias, position table and prefix rows folded into a (n_pad, D) f32
  ``posb`` table.  Here it is one ``torch.einsum`` in f32.
* :func:`fold_preprocess` -- folds (u/255 - mean)/std into the embed's
  kernel and bias (numpy, the JAX function's arithmetic bit for bit), so
  raw uint8 pixels -> tokens is one GEMM.
* :func:`patch_embed_xla` -- patchify + GEMM on the folded weights.
* :func:`patch_embed_pallas` -- the wrapper of K10 (``csrc/patch_embed.cu``,
  replaces ``vit_fpga_tpu/ops/patch_embed.py:_pe_kernel``): a CPU tensor
  runs :func:`patch_embed_plain`, a CUDA tensor launches the kernel or
  raises.  Like the JAX package, no serving path calls it.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from . import _kernels


def fold_preprocess(kernel: np.ndarray, bias: np.ndarray,
                    mean: Tuple[float, ...], std: Tuple[float, ...],
                    patch: int) -> Tuple[np.ndarray, np.ndarray]:
    """Fold (u/255 - mean)/std into (kernel, bias).

    ``kernel`` is (P*P*3, D) with pixel order (py, px, c) -- the layout of
    models/vit.py.  Returns (kernel', bias') operating directly on raw
    uint8 pixel values (f32, computed in f64 as the JAX function does)."""
    kernel = np.asarray(kernel, np.float64)
    bias = np.asarray(bias, np.float64)
    p3 = kernel.shape[0]
    if p3 != patch * patch * 3:
        raise ValueError(f"kernel has {p3} rows, want {patch * patch * 3}")
    c_of = np.tile(np.arange(3), patch * patch)
    stdv = np.asarray(std, np.float64)[c_of]          # (P*P*3,)
    meanv = np.asarray(mean, np.float64)[c_of]
    kernel_f = kernel / (255.0 * stdv)[:, None]
    bias_f = bias - (meanv / stdv) @ kernel
    return kernel_f.astype(np.float32), bias_f.astype(np.float32)


def patch_embed_xla(images_u8: torch.Tensor, kernel_f: torch.Tensor,
                    bias_f: torch.Tensor, patch: int,
                    out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Raw uint8 (B, H, W, 3) -> tokens (B, N, D) with folded weights:
    patchify in f32, then one f32 GEMM and the bias."""
    from ..models.vit import patchify
    x = patchify(images_u8.float(), patch)
    return (x @ kernel_f.float() + bias_f.float()).to(out_dtype)


def embed_tokens_dotg(images: torch.Tensor, kernel: torch.Tensor,
                      posb: torch.Tensor, patch: int, n_prefix: int,
                      prefix_last: bool = False,
                      out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """(B, H, W, 3) images -> (B, n_pad, D) tokens.

    ``kernel`` is the (P*P*3, D) patch-embed weight in compute dtype,
    pixel order (py, px, c).  ``posb`` is the (n_pad, D) f32 fold of
    bias + pos-embed (+ prefix token rows, + zero tail rows); its row
    order must match ``prefix_last``:

      prefix_last=False: [prefix rows | patch rows | tail]
      prefix_last=True:  [patch rows | prefix rows | tail]
    """
    b, h, w, _ = images.shape
    gh, gw = h // patch, w // patch
    npch = gh * gw
    n_pad, d = posb.shape
    dt = out_dtype or kernel.dtype
    x5 = images.reshape(b, gh, patch, gw, patch * 3).float()
    k3 = kernel.reshape(patch, patch * 3, d).float()
    # f32 accumulation of compute-dtype operands, as preferred_element_type
    y = torch.einsum("bypxq,pqd->byxd", x5, k3)
    posb = posb.float()
    lo = 0 if prefix_last else n_prefix      # posb row where patches start
    pb4 = posb[lo:lo + npch].reshape(1, gh, gw, d)
    body = (y + pb4).to(dt).reshape(b, npch, d)

    def bcast(rows):                          # constant rows, broadcast on B
        return rows.to(dt)[None].expand((b,) + tuple(rows.shape))

    parts = [body] if prefix_last else [bcast(posb[:n_prefix]), body]
    if lo + npch < n_pad:                     # prefix-last rest / tail rows
        parts.append(bcast(posb[lo + npch:]))
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)


# ---------------------------------------------------------------------------
# K10: the uint8 patch-embed kernel
# ---------------------------------------------------------------------------

_OUT_DTYPES = (torch.bfloat16, torch.float32)


def _pe_geometry(images_u8, kernel_f, bias_f, patch, out_dtype):
    """Checks shared by K10 and its plain version: (b, h, w, d)."""
    if images_u8.dim() != 4 or images_u8.shape[-1] != 3 \
            or images_u8.dtype != torch.uint8:
        raise ValueError(f"images must be (B, H, W, 3) uint8, got "
                         f"{tuple(images_u8.shape)} {images_u8.dtype}")
    b, h, w, _ = images_u8.shape
    if patch < 1 or h % patch or w % patch:
        raise ValueError(f"H={h} and W={w} must be multiples of the patch "
                         f"{patch}")
    if kernel_f.dim() != 2 or kernel_f.shape[0] != patch * patch * 3:
        raise ValueError(f"kernel_f must be ({patch * patch * 3}, D), got "
                         f"{tuple(kernel_f.shape)}")
    d = kernel_f.shape[1]
    if tuple(bias_f.shape) != (d,):
        raise ValueError(f"bias_f must be ({d},), got {tuple(bias_f.shape)}")
    if out_dtype not in _OUT_DTYPES:
        raise ValueError(f"out_dtype must be bf16 or f32, got {out_dtype}")
    return b, h, w, d


def patch_embed_plain(images_u8: torch.Tensor, kernel_f: torch.Tensor,
                      bias_f: torch.Tensor, patch: int,
                      out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Plain PyTorch version of K10, the JAX ``_pe_kernel``'s arithmetic:
    for each pixel row py of the patches, the (px, c) runs of the image,
    (B, gh, gw, P*3) in f32, times the (P*3, D) slice of the kernel,
    summed over py in f32; then the bias, rounded once to ``out_dtype``."""
    b, h, w, d = _pe_geometry(images_u8, kernel_f, bias_f, patch, out_dtype)
    gh, gw, p3 = h // patch, w // patch, patch * 3
    rows = images_u8.reshape(b, gh, patch, gw, p3).float()
    k3 = kernel_f.float().reshape(patch, p3, d)
    acc = torch.zeros((b, gh, gw, d), dtype=torch.float32,
                      device=images_u8.device)
    for py in range(patch):
        acc = acc + rows[:, :, py] @ k3[py]
    out = acc + bias_f.float()
    return out.to(out_dtype).reshape(b, gh * gw, d)


def patch_embed_pallas(images_u8: torch.Tensor, kernel_f: torch.Tensor,
                       bias_f: torch.Tensor, patch: int,
                       out_dtype: torch.dtype = torch.bfloat16
                       ) -> torch.Tensor:
    """uint8 (B, H, W, 3) images + folded f32 (P*P*3, D) kernel and (D,)
    bias -> (B, (H/P)*(W/P), D) tokens in ``out_dtype`` (bf16 or f32),
    every sum in f32.  The JAX name is kept so that a caller ports.  A CPU
    tensor runs :func:`patch_embed_plain`; a CUDA tensor launches K10 or
    raises."""
    if images_u8.device.type == "cpu":
        return patch_embed_plain(images_u8, kernel_f, bias_f, patch,
                                 out_dtype)
    if images_u8.device.type != "cuda":
        raise ValueError(f"unsupported device {images_u8.device}")
    b, h, w, d = _pe_geometry(images_u8, kernel_f, bias_f, patch, out_dtype)
    dev = images_u8.device
    for t, name in ((kernel_f, "kernel_f"), (bias_f, "bias_f")):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, images on {dev}")
    img = images_u8.contiguous()
    kf = kernel_f.to(torch.float32).contiguous()
    bf = bias_f.to(torch.float32).contiguous()
    out = torch.empty((b, (h // patch) * (w // patch), d), dtype=out_dtype,
                      device=dev)
    with torch.cuda.device(dev):
        lib, stream = _kernels.launch_target()
        err = lib.vft_patch_embed(img.data_ptr(), kf.data_ptr(),
                                  bf.data_ptr(), out.data_ptr(), b, h, w,
                                  patch, d, int(out_dtype == torch.bfloat16),
                                  stream)
    _kernels.check(err, "patch_embed")
    patch_embed_pallas.launches += 1
    return out


patch_embed_pallas.launches = 0
