"""Transpose-free patch embedding (counterpart of the JAX package's
ops/patch_embed.embed_tokens_dotg).

The JAX package leaves this stage to XLA: one GEMM whose contraction runs
over the (py) and (px, c) axes of a contiguous (B, gh, P, gw, P*3) view of
the image, with bias, position table and prefix rows folded into a
(n_pad, D) f32 ``posb`` table.  Here it is one ``torch.einsum`` in f32.
"""

from __future__ import annotations

import torch


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
