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
  raises.  Like the JAX package, no serving path calls it.  On the card
  the f32 products run on the tensor cores in bf16, exactly: each weight
  is split into three bf16 pieces (:func:`split_pieces`), the images are
  patchified into bf16 rows (:func:`patchify_padded`) and one bf16 GEMM
  sums pixel x piece over the three planes in f32
  (:func:`patch_embed_split_plain` is that arithmetic in plain PyTorch).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from . import _kernels
from .common import aligned16


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
# bf16's least normal magnitude (f32's): a smaller piece is a subnormal
_BF16_TINY = 2.0 ** -126


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


def split_pieces(kernel_f: torch.Tensor):
    """The f32 weights as three bf16 pieces, K10's split: ``hi = bf16(w)``,
    ``mid = bf16(w - hi)``, ``lo = bf16(w - hi - mid)``, each subtraction
    exact in f32, so that ``hi + mid + lo == w`` wherever 24 significant
    bits fit in three pieces of 8.  Returns ``(lo, mid, hi, exact)``,
    ``exact`` False where a weight is not their exact sum or a nonzero
    piece is below bf16's least normal magnitude (the kernel refuses
    such weights; the tensor cores may flush subnormals)."""
    w = kernel_f.float()
    hi = w.to(torch.bfloat16)
    r1 = w - hi.float()
    mid = r1.to(torch.bfloat16)
    r2 = r1 - mid.float()
    lo = r2.to(torch.bfloat16)
    exact = lo.float() == r2
    for piece in (hi, mid, lo):
        f = piece.float().abs()
        exact &= (f == 0) | (f >= _BF16_TINY)
    return lo, mid, hi, exact


def patchify_padded(images_u8: torch.Tensor, patch: int) -> torch.Tensor:
    """K10's patchify pass: uint8 (B, H, W, 3) -> (B * gh * gw, Kp) bf16
    rows in (py, px, c) order, K = P * P * 3 padded with zero columns to
    Kp, a multiple of 8 (the 16-byte row stride TMA reads).  Pixels are
    exact in bf16 (0..255 take 8 significant bits)."""
    b, h, w, _ = images_u8.shape
    gh, gw, k = h // patch, w // patch, patch * patch * 3
    kp = -(-k // 8) * 8
    rows = (images_u8.reshape(b, gh, patch, gw, patch * 3)
            .permute(0, 1, 3, 2, 4).reshape(b * gh * gw, k))
    a = torch.zeros((b * gh * gw, kp), dtype=torch.bfloat16,
                    device=images_u8.device)
    a[:, :k] = rows.to(torch.bfloat16)
    return a


def patch_embed_split_plain(images_u8: torch.Tensor, kernel_f: torch.Tensor,
                            bias_f: torch.Tensor, patch: int,
                            out_dtype: torch.dtype = torch.bfloat16
                            ) -> torch.Tensor:
    """K10's arithmetic on the card in plain PyTorch: the patchified bf16
    rows times each bf16 piece of the split weights, every product exact
    in f32, summed in f32 with the small pieces first; then the bias,
    rounded once to ``out_dtype``.  Raises where the split is not exact."""
    b, h, w, d = _pe_geometry(images_u8, kernel_f, bias_f, patch, out_dtype)
    lo, mid, hi, exact = split_pieces(kernel_f)
    if not bool(exact.all()):
        raise ValueError(f"{int((~exact).sum())} weights are not the exact "
                         f"sum of three normal bf16 pieces")
    k = patch * patch * 3
    a = patchify_padded(images_u8, patch)[:, :k].float()
    acc = a @ lo.float()
    acc = acc + a @ mid.float()
    acc = acc + a @ hi.float()
    out = acc + bias_f.float()
    return out.to(out_dtype).reshape(b, (h // patch) * (w // patch), d)


def patch_embed_pallas(images_u8: torch.Tensor, kernel_f: torch.Tensor,
                       bias_f: torch.Tensor, patch: int,
                       out_dtype: torch.dtype = torch.bfloat16
                       ) -> torch.Tensor:
    """uint8 (B, H, W, 3) images + folded f32 (P*P*3, D) kernel and (D,)
    bias -> (B, (H/P)*(W/P), D) tokens in ``out_dtype`` (bf16 or f32),
    every sum in f32.  The JAX name is kept so that a caller ports.  A CPU
    tensor runs :func:`patch_embed_plain`; a CUDA tensor launches K10 (D a
    multiple of 8) or raises, also where a weight is not the exact sum of
    its three bf16 pieces (:func:`split_pieces`), which it learns by
    reading one count back from the card after the launch."""
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
    if d % 8:
        raise ValueError(f"K10 needs D divisible by 8 (TMA's 16-byte rows), "
                         f"got D={d}")
    img = images_u8.contiguous()
    kf = aligned16(kernel_f.to(torch.float32).contiguous())
    bf = aligned16(bias_f.to(torch.float32).contiguous())
    rows, k = b * (h // patch) * (w // patch), patch * patch * 3
    kp = -(-k // 8) * 8
    kq = -(-kp // 64) * 64                    # a plane: the GEMM's 64-deep steps
    out = torch.empty((b, (h // patch) * (w // patch), d), dtype=out_dtype,
                      device=dev)
    planes = torch.empty((3 * kq, d), dtype=torch.bfloat16, device=dev)
    a = torch.empty((rows, kp), dtype=torch.bfloat16, device=dev)
    inexact = torch.empty((1,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        lib, stream = _kernels.launch_target()
        err = lib.vft_patch_embed(img.data_ptr(), kf.data_ptr(),
                                  bf.data_ptr(), out.data_ptr(),
                                  planes.data_ptr(), a.data_ptr(),
                                  inexact.data_ptr(), b, h, w, patch, d,
                                  int(out_dtype == torch.bfloat16), stream)
    _kernels.check(err, "patch_embed")
    patch_embed_pallas.launches += 1
    bad = int(inexact.item())
    if bad:
        raise ValueError(f"patch_embed: {bad} weights of kernel_f are not "
                         f"the exact sum of three normal bf16 pieces")
    return out


patch_embed_pallas.launches = 0
