"""Dynamic int8 ViT serving (counterpart of the fast int8 path of the JAX
package's models/quantized.py).

``quantize_vit_fast`` turns the f32 parameter tree into the JAX package's
int8 tree: per-output-column int8 weights (``*_q``, ``wq``) with f32
scales (``*_s``, ``ws``), everything else as it was.  The forward is

  preprocess -> dotg embed on the dequantized patch weight bf16(wq * ws),
  bias folded into the f32 position table
  -> depth x _qblock_fast = [attn_block_int8 (K16) -> mlp_block_int8 (K15)]
  -> LayerNorm of the CLS row -> int8_linear_fused head (K14), bf16 -> f32

in bf16 whatever ``cfg.dtype`` says.  It runs the Hopper kernels on a
CUDA device and their plain versions on the CPU.  The per-linear int8
route that the JAX package takes where its block kernels do not fit, the
calibrated static-scale trees (K17, K18) and the CLIP towers are not
ported yet: a static tree raises.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import numpy as np
import torch

from ..ops.common import pad_sublane, round_up
from ..ops.patch_embed import embed_tokens_dotg
from ..ops.quant_block import attn_block_int8, mlp_block_int8
from ..ops.quant_fused import int8_linear_fused, quantize_weight_colwise
from ..utils.platform import resolve_device
from . import vit as vit_mod

Params = Dict[str, Any]

_VIT_QUANT_KEYS = ("wqkv", "wo", "w1", "w2")
_PREPARED = "_int8_prepared"     # marks a tree make_forward_int8 prepared


def quantize_vit_fast(params: Params) -> Params:
    """Per-output-column int8 weights for the int8 kernels: the JAX
    ``quantize_vit_fast`` on the port's f32 tree (same bits, on the
    tree's device)."""
    dev = params["pos_embed"].device

    def q(w):
        wq, ws = quantize_weight_colwise(w.detach().float().cpu().numpy())
        return torch.from_numpy(wq).to(dev), torch.from_numpy(ws).to(dev)

    blocks = params["blocks"]
    out: Params = {k: params[k] for k in ("cls_token", "pos_embed",
                                          "ln_f_scale", "ln_f_bias")}
    pe_q, pe_s = q(params["patch_embed"]["kernel"])
    out["patch_embed"] = {"wq": pe_q, "ws": pe_s,
                          "b": params["patch_embed"]["bias"]}
    qb = {k: blocks[k] for k in ("ln1_scale", "ln1_bias", "ln2_scale",
                                 "ln2_bias", "bqkv", "bo", "b1", "b2")}
    for k in _VIT_QUANT_KEYS:
        qs = [q(w) for w in blocks[k].unbind(0)]
        qb[k + "_q"] = torch.stack([a for a, _ in qs])
        qb[k + "_s"] = torch.stack([s for _, s in qs])
    out["blocks"] = qb
    if "head" in params:
        h_q, h_s = q(params["head"]["kernel"])
        out["head"] = {"wq": h_q, "ws": h_s, "b": params["head"]["bias"]}
    return out


def _check_tree(qparams: Params, cfg: vit_mod.ViTConfig) -> None:
    if "inv_ao" in qparams["blocks"]:
        raise NotImplementedError(
            "calibrated static-scale int8 trees (kernels K17, K18) are not "
            "ported yet; quantize with quantize_vit_fast")
    if cfg.remat:
        raise NotImplementedError("the int8 forward serves; remat is a "
                                  "training option")


def _kmajor(w: torch.Tensor) -> torch.Tensor:
    """A (K, N) view of (N, K) contiguous storage, the layout the int8
    GEMM reads without a copy."""
    return w.t().contiguous().t()


def prepare_int8(qparams: Params, cfg: vit_mod.ViTConfig) -> Params:
    """One-time preparation of a ``quantize_vit_fast`` tree for the
    forward: the dequantized bf16 embed weight, the folded (n_pad, D) f32
    position table, and per-layer weights laid out for the int8 GEMMs."""
    if _PREPARED in qparams:
        return qparams
    _check_tree(qparams, cfg)
    n, d = cfg.seq_len, cfg.hidden_dim
    npre = cfg.num_prefix_tokens
    n_pad = round_up(n, pad_sublane(torch.bfloat16))
    pe = qparams["patch_embed"]
    pos = qparams["pos_embed"][0].float()
    pre = qparams["cls_token"][0].float()
    posb = torch.cat([
        pre + pos[:npre],
        pos[npre:] + pe["b"].float(),
        torch.zeros((n_pad - n, d), dtype=torch.float32, device=pos.device),
    ], dim=0)
    wp = (pe["wq"].float() * pe["ws"].float()).to(torch.bfloat16)
    per_key = {k: v.unbind(0) for k, v in qparams["blocks"].items()}
    layers = [{k: (_kmajor(v[i]) if k.endswith("_q") else v[i])
               for k, v in per_key.items()} for i in range(cfg.depth)]
    prepped = dict(qparams, _embed=(wp, posb), _layers=layers)
    prepped[_PREPARED] = True
    if "head" in qparams:
        prepped["head"] = dict(qparams["head"],
                               wq=_kmajor(qparams["head"]["wq"]))
    return prepped


def _qblock_fast(x: torch.Tensor, blk: Params, cfg: vit_mod.ViTConfig,
                 n_valid: int) -> torch.Tensor:
    """One int8 block on padded (B, n_pad, D) bf16 tokens: K16 -> K15."""
    b, n_pad, d = x.shape
    act = "quick_gelu" if cfg.hidden_act == "quick_gelu" else "gelu_tanh"
    x = attn_block_int8(x, blk["ln1_scale"], blk["ln1_bias"], blk["wqkv_q"],
                        blk["wqkv_s"], blk["bqkv"], blk["wo_q"], blk["wo_s"],
                        blk["bo"], cfg.num_heads, eps=cfg.ln_eps,
                        n_valid=n_valid)
    y = mlp_block_int8(x.reshape(b * n_pad, d), blk["ln2_scale"],
                       blk["ln2_bias"], blk["w1_q"], blk["w1_s"], blk["b1"],
                       blk["w2_q"], blk["w2_s"], blk["b2"], eps=cfg.ln_eps,
                       act=act)
    return y.reshape(b, n_pad, d)


def vit_forward_int8_fast(qparams: Params, images: torch.Tensor,
                          cfg: vit_mod.ViTConfig) -> torch.Tensor:
    """Normalized images (B, S, S, 3) -> f32 logits through the int8
    engine (f32 CLS features for a headless tree).  ``qparams`` is a
    ``quantize_vit_fast`` tree, or one :func:`prepare_int8` prepared."""
    prep = prepare_int8(qparams, cfg)
    wp, posb = prep["_embed"]
    x = embed_tokens_dotg(images.to(torch.bfloat16), wp, posb,
                          cfg.patch_size, cfg.num_prefix_tokens)
    for blk in prep["_layers"]:
        x = _qblock_fast(x, blk, cfg, cfg.seq_len)
    # LayerNorm is per token: only the CLS row feeds the head
    cls_t = vit_mod._layernorm(x[:, :1], prep["ln_f_scale"],
                               prep["ln_f_bias"], cfg.ln_eps)
    if "head" not in prep:
        return cls_t[:, 0].float()
    hd = prep["head"]
    return int8_linear_fused(cls_t.reshape(x.shape[0], -1), hd["wq"],
                             hd["ws"], hd["b"]).float()


def vit_forward_int8_raw(qparams: Params, images_u8: torch.Tensor,
                         cfg: vit_mod.ViTConfig) -> torch.Tensor:
    """Raw uint8 images -> logits through the int8 engine."""
    return vit_forward_int8_fast(qparams, vit_mod.preprocess(images_u8, cfg),
                                 cfg)


def make_forward_int8(cfg: vit_mod.ViTConfig, qparams: Params,
                      raw: bool = True,
                      device=None) -> Callable[[Any], torch.Tensor]:
    """Counterpart of the JAX ``jit_forward_int8(cfg, raw)`` partially
    applied with the tree: returns ``fn(images) -> logits`` that runs under
    ``torch.inference_mode`` on ``device`` (CUDA unless ``"cpu"``).  The
    tree must already live there; numpy input is copied there."""
    dev = resolve_device(device)
    for leaf in (qparams["pos_embed"], qparams["blocks"]["wqkv_q"]):
        if leaf.device.type != dev.type:
            raise ValueError(f"params are on {leaf.device}, forward on {dev}")
    prepped = prepare_int8(qparams, cfg)
    fn = vit_forward_int8_raw if raw else vit_forward_int8_fast

    def run(images) -> torch.Tensor:
        if isinstance(images, np.ndarray):
            images = torch.from_numpy(images)
        with torch.inference_mode():
            return fn(prepped, images.to(dev), cfg)

    return run
