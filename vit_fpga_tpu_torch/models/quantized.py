"""Dynamic int8 ViT serving (counterpart of the fast int8 path of the JAX
package's models/quantized.py).

``quantize_vit_fast`` turns the f32 parameter tree into the JAX package's
int8 tree: per-output-column int8 weights (``*_q``, ``wq``) with f32
scales (``*_s``, ``ws``), everything else as it was.  The forward is

  preprocess -> dotg embed on the dequantized patch weight bf16(wq * ws),
  bias folded into the f32 position table
  -> depth x _qblock_fast = [attn_block_int8 (K16) -> mlp_block_int8 (K15)]
  -> LayerNorm of the CLS row -> int8_linear_fused head (K14), bf16 -> f32

in bf16 whatever ``cfg.dtype`` says.  The batch-1 latency forward
(``make_forward_int8_latency``) runs the embed with the CLS row last, the
whole encoder in one launch (K19a, ``ops/vit_stack.vit_layers_int8``) and
the same head.  It runs the Hopper kernels on a CUDA device and their
plain versions on the CPU.  The per-linear int8
route that the JAX package takes where its block kernels do not fit, the
calibrated static-scale trees (K17, K18, K19b) and the CLIP towers are
not ported yet: a static tree raises.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import numpy as np
import torch

from ..ops.common import pad_sublane, round_up
from ..ops.patch_embed import embed_tokens_dotg
from ..ops.quant_block import attn_block_int8, mlp_block_int8
from ..ops.quant_fused import (int8_linear_fused, kmajor,
                               quantize_weight_colwise)
from ..ops.vit_stack import stack_supported, vit_layers_int8
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
    layers = [{k: (kmajor(v[i]) if k.endswith("_q") else v[i])
               for k, v in per_key.items()} for i in range(cfg.depth)]
    prepped = dict(qparams, _embed=(wp, posb), _layers=layers)
    prepped[_PREPARED] = True
    if "head" in qparams:
        prepped["head"] = dict(qparams["head"],
                               wq=kmajor(qparams["head"]["wq"]))
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


# ---------------------------------------------------------------------------
# Batch-1 int8 latency forward: the whole encoder in one launch (K19a)
# ---------------------------------------------------------------------------

def int8_latency_supported(cfg: vit_mod.ViTConfig, batch: int) -> bool:
    """Gate of :func:`vit_forward_int8_latency` on the card (the JAX
    ``int8_latency_supported`` with :func:`stack_supported` in place of the
    TPU's VMEM planner): CLS pooling, batch <= 4 and a geometry K19a
    takes."""
    return (cfg.pool == "cls" and batch <= 4
            and stack_supported(cfg.num_heads, cfg.hidden_dim, cfg.mlp_dim,
                                cfg.seq_len, batch))


def prep_int8_latency(qparams: Params, cfg: vit_mod.ViTConfig) -> Params:
    """One-time fold for :func:`vit_forward_int8_latency`: the dequantized
    bf16 patch weight, the CLS-last posb table, the stacked int8 weights
    laid out k-major for K19a (``kmajor``) and the head's weight
    for K14, so no call copies a weight.  A static tree raises naming
    K19b."""
    if "posb_cl" in qparams:
        return qparams
    if "inv_ao" in qparams["blocks"]:
        raise NotImplementedError(
            "calibrated static-scale int8 trees (kernel K19b) are not ported "
            "yet; quantize with quantize_vit_fast")
    n_pad = round_up(cfg.seq_len, pad_sublane(torch.bfloat16))
    pe = qparams["patch_embed"]
    posb = vit_mod._cls_last_posb(qparams["pos_embed"][0].float(),
                                  pe["b"].float(),
                                  qparams["cls_token"][0].float(),
                                  cfg.num_prefix_tokens, n_pad)
    blocks = {k: (kmajor(v) if k.endswith("_q") else v)
              for k, v in qparams["blocks"].items()}
    out = {
        "wp_cl": (pe["wq"].float() * pe["ws"].float()).to(torch.bfloat16),
        "posb_cl": posb,
        "blocks": blocks,
        "lfs": qparams["ln_f_scale"],
        "lfb": qparams["ln_f_bias"],
    }
    if "head" in qparams:
        out["head"] = dict(qparams["head"], wq=kmajor(qparams["head"]["wq"]))
    return out


def vit_forward_int8_latency(qparams: Params, images: torch.Tensor,
                             cfg: vit_mod.ViTConfig) -> torch.Tensor:
    """Small-batch int8 forward: the dotg embed with the prefix rows LAST
    on bf16(wq * ws), the whole encoder in one launch (K19a,
    ``ops/vit_stack.vit_layers_int8``), the LayerNorm of the CLS row and
    the K14 head (f32 CLS features for a headless tree).  ``qparams`` may
    be the plain ``quantize_vit_fast`` tree or the
    :func:`prep_int8_latency` fold.  On the card it raises outside
    :func:`int8_latency_supported`."""
    if cfg.pool != "cls":
        raise ValueError("vit_forward_int8_latency pools the CLS row "
                         "(pool='cls')")
    if (images.device.type == "cuda"
            and not int8_latency_supported(cfg, images.shape[0])):
        raise NotImplementedError(
            f"vit_forward_int8_latency on the card takes batch <= 4 and a "
            f"geometry K19a takes (int8_latency_supported); got batch "
            f"{images.shape[0]}")
    n, npre = cfg.seq_len, cfg.num_prefix_tokens
    npch = n - npre
    act = "quick_gelu" if cfg.hidden_act == "quick_gelu" else "gelu_tanh"
    prep = prep_int8_latency(qparams, cfg)
    x = embed_tokens_dotg(images.to(torch.bfloat16), prep["wp_cl"],
                          prep["posb_cl"], cfg.patch_size, npre,
                          prefix_last=True)
    toks = vit_layers_int8(x, prep["blocks"], cfg.num_heads, eps=cfg.ln_eps,
                           act=act, n_valid=n)
    cls_t = vit_mod._layernorm(toks[:, npch:npch + 1], prep["lfs"],
                               prep["lfb"], cfg.ln_eps)
    if "head" not in prep:
        return cls_t[:, 0].float()
    hd = prep["head"]
    return int8_linear_fused(cls_t.reshape(x.shape[0], -1), hd["wq"],
                             hd["ws"], hd["b"]).float()


def make_forward_int8_latency(cfg: vit_mod.ViTConfig, qparams: Params,
                              raw: bool = True,
                              device=None) -> Callable[[Any], torch.Tensor]:
    """The latency counterpart of :func:`make_forward_int8`:
    :func:`prep_int8_latency` runs once here, and ``fn(images) -> logits``
    runs preprocess (when ``raw``) and :func:`vit_forward_int8_latency`
    under ``torch.inference_mode`` on ``device`` (CUDA unless ``"cpu"``)."""
    dev = resolve_device(device)
    for leaf in (qparams["pos_embed"], qparams["blocks"]["wqkv_q"]):
        if leaf.device.type != dev.type:
            raise ValueError(f"params are on {leaf.device}, forward on {dev}")
    if cfg.remat:
        raise NotImplementedError("the int8 forward serves; remat is a "
                                  "training option")
    prepped = prep_int8_latency(qparams, cfg)

    def run(images) -> torch.Tensor:
        if isinstance(images, np.ndarray):
            images = torch.from_numpy(images)
        with torch.inference_mode():
            images = images.to(dev)
            if raw:
                images = vit_mod.preprocess(images, cfg)
            return vit_forward_int8_latency(prepped, images, cfg)

    return run
