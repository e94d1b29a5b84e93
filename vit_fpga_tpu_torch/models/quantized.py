"""Int8 forwards (counterpart of the JAX package's models/quantized.py):
the dense network's bit-exact int8 family, and int8 ViT serving, dynamic
and calibrated static-scale.

The dense family (``quantize_mlp``, ``mlp_forward_int8_numpy``,
``mlp_forward_int8``, ``device_qparams``) quantizes each layer's weight
per tensor on the host and each layer's input per tensor at run time,
then runs ``ops/quant.int8_linear`` (the K13 GEMM on the card); the card
and the numpy oracle agree bit for bit (``ops/quant.py`` says why).

The ViT family follows.

``quantize_vit_fast`` turns the f32 parameter tree into the JAX package's
int8 tree: per-output-column int8 weights (``*_q``, ``wq``) with f32
scales (``*_s``, ``ws``), everything else as it was.
``quantize_vit_static`` calibrates per-layer activation scales on a probe
batch (``utils/calibrate.static_activation_scales``) and folds them into
that tree (``_fold_static_scales``): the static tree, marked by
``blocks["inv_ao"]``.  The forward is

  preprocess -> dotg embed on the dequantized patch weight bf16(wq * ws),
  bias folded into the f32 position table
  -> depth x _qblock_fast = [attn_block_int8 (K16) -> mlp_block_int8 (K15)],
     or on a static tree [attn_block_int8_static (K18) ->
     mlp_block_int8_static (K17)]
  -> LayerNorm of the CLS row -> int8_linear_fused head (K14), bf16 -> f32

in bf16 whatever ``cfg.dtype`` says.  Two further paths of the JAX
package's forward sit behind module switches that it keeps off after TPU
measurements, and so does the port: ``_INT8_STATS_CHAIN`` runs a dynamic
tree's encoder as the int8 stats chain, depth x [attn_block_int8_stats
(K21b) -> mlp_block_int8_stats (K21a)] with the LayerNorm (mu, rstd)
passed between the halves (``_encoder_int8_stats_chain``), where
``_int8_stats_chain_supported``; ``_INT8_SCORES`` runs a static tree's
attention with int8 scores, attn_block_int8_static_scores (K22) ->
mlp_block_int8_static (K17), where ``_int8_scores_ok``.  A static tree
under the chain raises: the JAX chain would run it as a dynamic tree,
each layer's branches scaled by the folded a_ao and a_h.

The batch-1 latency forward
(``make_forward_int8_latency``) runs the embed with the CLS row last, the
whole encoder in one launch (K19a ``ops/vit_stack.vit_layers_int8``, or
K19b ``vit_layers_int8_static`` on a static tree) and the same head;
``vit_forward_int8_latency_logits`` (``make_forward_int8_latency(...,
full=True)``) runs the whole dynamic int8 model, image in and logits out,
in one launch (K20 ``ops/vit_stack.vit_full_int8``).  It runs the Hopper
kernels on a CUDA device and their plain versions on the
CPU.  Where the JAX int8 planners do not fit the block kernels
(``_int8_block_fits``: ViT-B/16 at 1024 px) a dynamic tree takes the
per-linear route, four K14 launches around ``mha_qkv`` (K9 from 1024
tokens); a static tree there runs the JAX ``*_ref`` blocks, plain torch
(``ops/quant_block.attn_block_int8_static_ref``,
``attn_block_int8s_static_ref``, ``mlp_block_int8_static_ref``).  The
CLIP vision tower's int8 forwards (``quantize_clip_vision_fast`` /
``_static``, ``clip_forward_int8_fast``, ``clip_forward_int8_latency``,
``make_forward_int8(..., clip=True)``) are these with CLIP's parts: the
embed without tail rows, ``ln_pre``, padding after it, the final LN of
the CLS row and the f32 projection.

The per-tensor family (``quantize_vit``, ``vit_forward_int8``,
``make_vit_forward_int8``) is the JAX package's bit-exact datapath:
per-tensor int8 weights (one scale per layer) and activations quantized
per tensor at run time, f32 everywhere else, every linear a K13 GEMM
(``ops/quant.int8_linear``) and the attention ``mha_qkv`` on f32 qkv (K7 in
f32 below 1024 tokens).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import activations as act
from ..defines import NetData
from ..ops import quant
from ..ops.common import pad_sublane, round_up, row_stats
from ..ops.patch_embed import embed_tokens_dotg
from ..ops.attention import mha_qkv
from ..ops.quant_block import (attn_block_int8, attn_block_int8_static,
                               attn_block_int8_static_ref,
                               attn_block_int8_static_scores,
                               attn_block_int8_stats,
                               attn_block_int8s_static_ref, mlp_block_int8,
                               mlp_block_int8_static,
                               mlp_block_int8_static_ref,
                               mlp_block_int8_stats, mlp_plan_int8,
                               score_slots_int8)
from ..ops.quant_fused import (int8_linear_fused, kmajor,
                               QMAX, quantize_weight_colwise)
from ..ops.vit_stack import (full_supported, stack_supported, vit_full_int8,
                             vit_layers_int8, vit_layers_int8_static)
from ..utils.platform import resolve_device
from . import vit as vit_mod

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# Dense (MLP) family: bit-exact parity contract
# ---------------------------------------------------------------------------

def quantize_mlp(data: NetData) -> Params:
    """Quantize reference-layout weights to int8 per tensor (host-side,
    shared verbatim by the oracle and the device path)."""
    data.validate()
    layers: List[Dict[str, Any]] = []
    for w, b in zip(data.params, data.bias):
        wq, sw = quant.quantize_numpy(np.ascontiguousarray(w.T))
        layers.append({"wq": wq, "sw": sw,
                       "b": np.asarray(b, np.float32)})
    return {"layers": layers, "acts": tuple(int(a) for a in
                                            data.activations)}


def mlp_forward_int8_numpy(qparams: Params, x: np.ndarray) -> np.ndarray:
    """Oracle int8 forward: dynamic per-tensor activation quantization."""
    h = np.asarray(x, np.float32)
    for layer, code in zip(qparams["layers"], qparams["acts"]):
        hq, sx = quant.quantize_numpy(h)
        h = quant.int8_linear_numpy(hq, sx, layer["wq"], layer["sw"],
                                    layer["b"])
        h = act.apply_numpy(code, h).astype(np.float32)
    return h


def mlp_forward_int8(qparams_dev: Params, x: torch.Tensor,
                     acts: Tuple[int, ...]) -> torch.Tensor:
    """Device int8 forward, the oracle's semantics on ``x``'s device: one
    K13 launch per layer on the card."""
    h = x.float()
    for layer, code in zip(qparams_dev["layers"], acts):
        hq, sx = quant.quantize_torch(h)
        h = quant.int8_linear(hq, sx, layer["wq"], layer["sw"], layer["b"])
        h = act.apply_torch(int(code), h).float()
    return h


def device_qparams(qparams: Params, device=None) -> Params:
    """Host quantized params -> tensors on ``device`` (CUDA unless
    ``"cpu"``): each int8 weight as a k-major view (the layout K13 reads
    without a copy), its f32 scale as a 0-dim tensor.  The activation
    codes stay out: they are the forward's ``acts``."""
    dev = resolve_device(device)
    return {"layers": [
        {"wq": kmajor(torch.from_numpy(l["wq"]).to(dev)),
         "sw": torch.tensor(l["sw"], dtype=torch.float32, device=dev),
         "b": torch.from_numpy(np.asarray(l["b"], np.float32)).to(dev)}
        for l in qparams["layers"]]}

_VIT_QUANT_KEYS = ("wqkv", "wo", "w1", "w2")
_PREPARED = "_int8_prepared"     # marks a tree make_forward_int8 prepared


# ---------------------------------------------------------------------------
# Per-tensor int8 ViT: the bit-exact datapath over K13, attention in f32
# ---------------------------------------------------------------------------

def _q_linear(kernel: torch.Tensor, bias: torch.Tensor) -> Params:
    wq, sw = quant.quantize_numpy(kernel.detach().float().cpu().numpy())
    dev = kernel.device
    return {"wq": torch.from_numpy(wq).to(dev),
            "sw": torch.tensor(sw, dtype=torch.float32, device=dev),
            "b": bias.detach().float()}


def quantize_vit(params: Params) -> Params:
    """Per-tensor int8 for every big linear (the JAX ``quantize_vit``):
    the patch embed and the head one scale each, the stacked block weights
    one scale per layer (``*_q`` (depth, K, N) int8, ``*_s`` (depth,)
    f32), quantized in numpy as the JAX package does (same bits), on the
    tree's device."""
    dev = params["pos_embed"].device
    blocks = params["blocks"]
    out: Params = {k: params[k] for k in ("cls_token", "pos_embed",
                                          "ln_f_scale", "ln_f_bias")}
    out["patch_embed"] = _q_linear(params["patch_embed"]["kernel"],
                                   params["patch_embed"]["bias"])
    qb = {k: blocks[k] for k in ("ln1_scale", "ln1_bias", "ln2_scale",
                                 "ln2_bias", "bqkv", "bo", "b1", "b2")}
    for k in _VIT_QUANT_KEYS:
        w = blocks[k].detach().float().cpu().numpy()
        qs = [quant.quantize_numpy(w[i]) for i in range(w.shape[0])]
        qb[k + "_q"] = torch.from_numpy(np.stack([q for q, _ in qs])).to(dev)
        qb[k + "_s"] = torch.from_numpy(
            np.stack([sc for _, sc in qs]).astype(np.float32)).to(dev)
    out["blocks"] = qb
    if "head" in params:
        out["head"] = _q_linear(params["head"]["kernel"],
                                params["head"]["bias"])
    return out


def _qlin(x: torch.Tensor, lin: Params) -> torch.Tensor:
    """Per-tensor quantization of ``x`` and ``quant.int8_linear`` (K13 on
    the card): f32 out."""
    xq, sx = quant.quantize_torch(x)
    return quant.int8_linear(xq, sx, lin["wq"], lin["sw"], lin["b"])


def _qblock(x: torch.Tensor, blk: Params,
            cfg: vit_mod.ViTConfig) -> torch.Tensor:
    """One per-tensor int8 block in f32 (the JAX ``_qblock``): LN -> QKV
    -> ``mha_qkv`` on f32 qkv (K7 below 1024 tokens under "auto") ->
    out-proj -> LN -> W1 -> the activation -> W2, each linear a
    :func:`_qlin`."""
    h = vit_mod._layernorm(x, blk["ln1_scale"], blk["ln1_bias"], cfg.ln_eps)
    qkv = _qlin(h, {"wq": blk["wqkv_q"], "sw": blk["wqkv_s"],
                    "b": blk["bqkv"]})
    o = mha_qkv(qkv.float(), cfg.num_heads, impl=cfg.attn_impl)
    x = x + _qlin(o, {"wq": blk["wo_q"], "sw": blk["wo_s"], "b": blk["bo"]})
    h = vit_mod._layernorm(x, blk["ln2_scale"], blk["ln2_bias"], cfg.ln_eps)
    h = _qlin(h, {"wq": blk["w1_q"], "sw": blk["w1_s"], "b": blk["b1"]})
    h = vit_mod._hidden_act_xla(h, cfg.hidden_act)
    return x + _qlin(h, {"wq": blk["w2_q"], "sw": blk["w2_s"],
                         "b": blk["b2"]})


def vit_forward_int8(qparams: Params, images: torch.Tensor,
                     cfg: vit_mod.ViTConfig) -> torch.Tensor:
    """Per-tensor int8 ViT forward (the JAX ``vit_forward_int8``):
    normalized images -> f32 logits (f32 CLS features for a headless
    tree).  f32 activations throughout: patchify -> K13 embed, the prefix
    row and position table, depth x :func:`_qblock`, the final LN of the
    CLS row (LayerNorm is per token), the K13 head.  ``qparams`` is a
    :func:`quantize_vit` tree (or one :func:`make_vit_forward_int8`
    prepared)."""
    x = vit_mod.patchify(images.float(), cfg.patch_size)
    x = _qlin(x, qparams["patch_embed"])
    cls = qparams["cls_token"].float().expand(x.shape[0], -1, -1)
    x = torch.cat([cls, x], dim=1) + qparams["pos_embed"].float()
    layers = qparams.get("_layers") or [
        {k: v[i] for k, v in qparams["blocks"].items()}
        for i in range(cfg.depth)]
    for blk in layers:
        x = _qblock(x, blk, cfg)
    pooled = vit_mod._layernorm(x[:, :1], qparams["ln_f_scale"],
                                qparams["ln_f_bias"], cfg.ln_eps)[:, 0]
    if "head" not in qparams:
        return pooled.float()
    return _qlin(pooled, qparams["head"])


def make_vit_forward_int8(cfg: vit_mod.ViTConfig, qparams: Params,
                          raw: bool = True,
                          device=None) -> Callable[[Any], torch.Tensor]:
    """Counterpart of the JAX ``jit_vit_forward_int8(cfg)`` applied to a
    :func:`quantize_vit` tree: returns ``fn(images) -> logits`` that runs
    preprocess (when ``raw``) and :func:`vit_forward_int8` under
    ``torch.inference_mode`` on ``device`` (CUDA unless ``"cpu"``).  The
    int8 weights are laid out once here as K13 reads them (k-major
    views); the tree must already live there."""
    dev = resolve_device(device)
    for leaf in (qparams["pos_embed"], qparams["blocks"]["wqkv_q"]):
        if leaf.device.type != dev.type:
            raise ValueError(f"params are on {leaf.device}, forward on {dev}")
    per_key = {k: v.unbind(0) for k, v in qparams["blocks"].items()}
    prepped = dict(qparams, _layers=[
        {k: (kmajor(v[i]) if k.endswith("_q") else v[i])
         for k, v in per_key.items()} for i in range(cfg.depth)])
    for name in ("patch_embed", "head"):
        if name in qparams:
            prepped[name] = dict(qparams[name], wq=kmajor(qparams[name]["wq"]))

    def run(images) -> torch.Tensor:
        if isinstance(images, np.ndarray):
            images = torch.from_numpy(images)
        with torch.inference_mode():
            images = images.to(dev)
            if raw:
                images = vit_mod.preprocess(images, cfg)
            return vit_forward_int8(prepped, images, cfg)

    return run


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


# ---------------------------------------------------------------------------
# Calibrated static scales
# ---------------------------------------------------------------------------

def quantize_vit_static(params: Params, cfg: vit_mod.ViTConfig,
                        images: Optional[torch.Tensor] = None,
                        margin: float = 1.0) -> Params:
    """:func:`quantize_vit_fast` tree with calibrated static activation
    scales folded in (the JAX ``quantize_vit_static``).  ``images``: an
    optional real calibration batch (normalized inputs); the synthetic
    probe batch by default.  The probe runs on the tree's device.
    Saturation beyond the calibrated absmax is the graceful-degradation
    contract."""
    from ..utils.calibrate import static_activation_scales
    sc = static_activation_scales(params, cfg, images, margin)
    return _fold_static_scales(quantize_vit_fast(params), sc, QMAX)


def _fold_static_scales(out: Params, sc: Dict[str, np.ndarray],
                        qmax: float) -> Params:
    """Fold activation quant scales into the fast tree's arguments, in
    numpy f32 (the JAX package's bits on any device): the LN affine
    absorbs 1/s_x, the column scales s_x, s_ao and s_h; the two inverses
    that cannot fold become the (depth, 1) tables ``inv_ao`` and
    ``inv_ah``.  With q/k/v scales in ``sc`` the int8-scores keys (K22)
    are derived too."""
    blk = dict(out["blocks"])
    dev = blk["ln1_scale"].device
    sx1 = (sc["a_x1"] / qmax).astype(np.float32)        # (depth,)
    s_ao = (sc["a_ao"] / qmax).astype(np.float32)
    sx2 = (sc["a_x2"] / qmax).astype(np.float32)
    s_h = (sc["a_h"] / qmax).astype(np.float32)

    def f32(k):
        return blk[k].detach().float().cpu().numpy()

    def put(k, v):
        blk[k] = torch.from_numpy(np.ascontiguousarray(v, np.float32)).to(dev)

    put("ln1_scale", f32("ln1_scale") / sx1[:, None])
    put("ln1_bias", f32("ln1_bias") / sx1[:, None])
    put("wqkv_s", f32("wqkv_s") * sx1[:, None])
    put("wo_s", f32("wo_s") * s_ao[:, None])
    put("ln2_scale", f32("ln2_scale") / sx2[:, None])
    put("ln2_bias", f32("ln2_bias") / sx2[:, None])
    put("w1_s", f32("w1_s") * sx2[:, None])
    put("w2_s", f32("w2_s") * s_h[:, None])
    put("inv_ao", (1.0 / s_ao)[:, None])
    put("inv_ah", (1.0 / s_h)[:, None])
    if all(k in sc for k in ("a_q", "a_k", "a_v")):
        s_q, s_k, s_v = ((sc[k] / qmax).astype(np.float32)
                         for k in ("a_q", "a_k", "a_v"))
        dm = blk["wqkv_s"].shape[-1] // 3
        s_thirds = np.concatenate(
            [np.tile(v[:, None], (1, dm)) for v in (s_q, s_k, s_v)], axis=1)
        put("wqkv_qs", f32("wqkv_s") / s_thirds)
        put("bqkv_qs", f32("bqkv") / s_thirds)
        put("sc_qk", (s_q * s_k)[:, None])
        put("pv_fold", (s_v / qmax / s_ao)[:, None])
    return dict(out, blocks=blk)


# The int8-scores attention (K22): off, as in the JAX package, where it
# measured a loss on the TPU.
_INT8_SCORES = False


def _int8_scores_ok(blk, cfg: vit_mod.ViTConfig) -> bool:
    """Whether the JAX package takes its int8-scores attention (K22):
    the tree carries the q/k/v panel scales and the geometry is dh 64
    with an even head count.  False while ``_INT8_SCORES`` is."""
    return (_INT8_SCORES and "sc_qk" in blk
            and cfg.hidden_dim // cfg.num_heads == 64
            and cfg.num_heads % 2 == 0)


def _check_tree(qparams: Params, cfg: vit_mod.ViTConfig) -> None:
    if cfg.remat:
        raise NotImplementedError("the int8 forward serves; remat is a "
                                  "training option")


def prepare_int8(qparams: Params, cfg: vit_mod.ViTConfig) -> Params:
    """One-time preparation of a ``quantize_vit_fast`` or
    ``quantize_vit_static`` tree for the forward: the dequantized bf16
    embed weight, the folded (n_pad, D) f32 position table, and per-layer
    weights laid out for the int8 GEMMs.  A static tree's ``inv_ao`` and
    ``inv_ah`` (and ``sc_qk``, ``pv_fold``) are read here, once, as Python
    floats: the kernels take them by value, so no call syncs on them."""
    if _PREPARED in qparams:
        return qparams
    _check_tree(qparams, cfg)
    pe = qparams["patch_embed"]
    posb = vit_mod._cls_first_posb(
        qparams["pos_embed"][0].float(), pe["b"].float(),
        qparams["cls_token"][0].float(), cfg.num_prefix_tokens,
        round_up(cfg.seq_len, pad_sublane(torch.bfloat16)))
    wp = (pe["wq"].float() * pe["ws"].float()).to(torch.bfloat16)
    per_key = {k: v.unbind(0) for k, v in qparams["blocks"].items()}
    layers = [{k: (kmajor(v[i]) if k.endswith("_q") else v[i])
               for k, v in per_key.items()} for i in range(cfg.depth)]
    for k in ("inv_ao", "inv_ah", "sc_qk", "pv_fold"):
        if k in qparams["blocks"]:
            for lay, v in zip(layers, qparams["blocks"][k].reshape(-1)
                              .tolist()):
                lay[k] = v
    prepped = dict(qparams, _embed=(wp, posb), _layers=layers)
    prepped[_PREPARED] = True
    if "head" in qparams:
        prepped["head"] = dict(qparams["head"],
                               wq=kmajor(qparams["head"]["wq"]))
    return prepped


def _int8_block_fits(cfg: vit_mod.ViTConfig) -> bool:
    """Whether the JAX package runs the int8 block kernels (K16 -> K15, or
    K18 -> K17) at this geometry (the JAX ``_int8_block_fits``): the int8
    attention plan has a score slot and the int8 MLP plan a row tile.
    ViT-B/16 at 1024 px does not: its blocks take the per-linear route."""
    n_pad = round_up(cfg.seq_len, pad_sublane(torch.bfloat16))
    kv_pad = round_up(cfg.seq_len, 128)
    _, n_sc, _, _ = score_slots_int8(cfg.num_heads, cfg.hidden_dim, n_pad,
                                     kv_pad)
    bt, _ = mlp_plan_int8(n_pad, cfg.hidden_dim, cfg.mlp_dim)
    return n_sc >= 1 and bt > 0


# The int8 stats chain (K21b, K21a): off, as in the JAX package, where it
# measured a loss on the TPU.
_INT8_STATS_CHAIN = False


def _int8_stats_chain_supported(cfg: vit_mod.ViTConfig, batch: int) -> bool:
    """The JAX ``_int8_stats_chain_supported`` as on a TPU (the
    convention of ``vit._stats_chain_supported``): the switch, both int8
    block kernels (:func:`_int8_block_fits`), and an int8 attention plan
    with a score slot and no q-slot reuse at this batch."""
    if not _INT8_STATS_CHAIN or not _int8_block_fits(cfg):
        return False
    _, n_sc, reuse_q, _ = score_slots_int8(
        cfg.num_heads, cfg.hidden_dim,
        round_up(cfg.seq_len, pad_sublane(torch.bfloat16)),
        round_up(cfg.seq_len, 128), batch=batch)
    return n_sc >= 1 and not reuse_q


def _encoder_int8_stats_chain(x: torch.Tensor, layers: List[Params],
                              cfg: vit_mod.ViTConfig,
                              n_valid: int) -> torch.Tensor:
    """The int8 encoder with the LayerNorm (mu, rstd) passed between the
    halves (the JAX ``_encoder_int8_stats_chain``): the first stats are a
    one-pass f32 reduction of the embedded tokens, then per layer K21b and
    K21a; the last MLP half emits none."""
    if "inv_ao" in layers[0]:
        raise NotImplementedError(
            "the int8 stats chain takes a dynamic tree: the JAX chain runs "
            "a static tree's folded scales as dynamic ones, each branch "
            "scaled by a_ao or a_h (ROADMAP.md, section 3)")
    b, n_pad, d = x.shape
    act = "quick_gelu" if cfg.hidden_act == "quick_gelu" else "gelu_tanh"
    st = row_stats(x, cfg.ln_eps)
    for i, blk in enumerate(layers):
        x, st = attn_block_int8_stats(
            x, st, blk["ln1_scale"], blk["ln1_bias"], blk["wqkv_q"],
            blk["wqkv_s"], blk["bqkv"], blk["wo_q"], blk["wo_s"], blk["bo"],
            cfg.num_heads, eps=cfg.ln_eps, n_valid=n_valid, emit_stats=True)
        last = i == len(layers) - 1
        t, st2 = mlp_block_int8_stats(
            x.reshape(b * n_pad, d), st.reshape(b * n_pad, 2),
            blk["ln2_scale"], blk["ln2_bias"], blk["w1_q"], blk["w1_s"],
            blk["b1"], blk["w2_q"], blk["w2_s"], blk["b2"], eps=cfg.ln_eps,
            act=act, emit_stats=not last)
        x = t.reshape(b, n_pad, d)
        if not last:
            st = st2.reshape(b, n_pad, 2)
    return x


def _fused_lin(x: torch.Tensor, wq, ws, b, act: str = "none",
               ln=None, eps: float = 0.0) -> torch.Tensor:
    """A (B, N, K) bf16 activation through K14 (``int8_linear_fused``),
    with the two-pass LayerNorm ``ln`` = (scale, bias) first when given:
    (B, N, N_out) bf16 (the JAX ``_fused_lin``)."""
    bsz, n, _ = x.shape
    ls, lb = ln if ln is not None else (None, None)
    out = int8_linear_fused(x.reshape(bsz * n, -1), wq, ws, b, act=act,
                            ln_scale=ls, ln_bias=lb,
                            ln_eps=eps if ln is not None else 0.0)
    return out.reshape(bsz, n, -1)


def _qblock_static(x: torch.Tensor, blk: Params, cfg: vit_mod.ViTConfig,
                   n_valid: int) -> torch.Tensor:
    """One calibrated static-scale block on padded (B, n_pad, D) bf16
    tokens: K18 -> K17, or K22 -> K17 where :func:`_int8_scores_ok`.
    Where :func:`_int8_block_fits` is False (ViT-B/16 at 1024 px), the JAX
    package's ``*_ref`` functions, plain torch on either device."""
    b, n_pad, d = x.shape
    act = "quick_gelu" if cfg.hidden_act == "quick_gelu" else "gelu_tanh"
    if not _int8_block_fits(cfg):
        return _qblock_static_ref(x, blk, cfg, n_valid, act)
    if _int8_scores_ok(blk, cfg):
        x = attn_block_int8_static_scores(
            x, blk["sc_qk"], blk["pv_fold"], blk["ln1_scale"],
            blk["ln1_bias"], blk["wqkv_q"], blk["wqkv_qs"], blk["bqkv_qs"],
            blk["wo_q"], blk["wo_s"], blk["bo"], cfg.num_heads,
            eps=cfg.ln_eps, n_valid=n_valid)
    else:
        x = attn_block_int8_static(
            x, blk["inv_ao"], blk["ln1_scale"], blk["ln1_bias"],
            blk["wqkv_q"], blk["wqkv_s"], blk["bqkv"], blk["wo_q"],
            blk["wo_s"], blk["bo"], cfg.num_heads, eps=cfg.ln_eps,
            n_valid=n_valid)
    y = mlp_block_int8_static(
        x.reshape(b * n_pad, d), blk["inv_ah"], blk["ln2_scale"],
        blk["ln2_bias"], blk["w1_q"], blk["w1_s"], blk["b1"], blk["w2_q"],
        blk["w2_s"], blk["b2"], eps=cfg.ln_eps, act=act)
    return y.reshape(b, n_pad, d)


def _qblock_static_ref(x: torch.Tensor, blk: Params,
                       cfg: vit_mod.ViTConfig, n_valid: int,
                       act: str) -> torch.Tensor:
    """The JAX ``_qblock_static``'s ``*_ref`` branch: the int8-scores
    attention reference where :func:`_int8_scores_ok`, else the static one,
    then the static MLP reference."""
    b, n_pad, d = x.shape
    if _int8_scores_ok(blk, cfg):
        x = attn_block_int8s_static_ref(
            x, blk["sc_qk"], blk["pv_fold"], blk["ln1_scale"],
            blk["ln1_bias"], blk["wqkv_q"], blk["wqkv_qs"], blk["bqkv_qs"],
            blk["wo_q"], blk["wo_s"], blk["bo"], cfg.num_heads,
            eps=cfg.ln_eps, n_valid=n_valid)
    else:
        x = attn_block_int8_static_ref(
            x, blk["inv_ao"], blk["ln1_scale"], blk["ln1_bias"],
            blk["wqkv_q"], blk["wqkv_s"], blk["bqkv"], blk["wo_q"],
            blk["wo_s"], blk["bo"], cfg.num_heads, eps=cfg.ln_eps,
            n_valid=n_valid)
    y = mlp_block_int8_static_ref(
        x.reshape(b * n_pad, d), blk["inv_ah"], blk["ln2_scale"],
        blk["ln2_bias"], blk["w1_q"], blk["w1_s"], blk["b1"], blk["w2_q"],
        blk["w2_s"], blk["b2"], eps=cfg.ln_eps, act=act)
    return y.reshape(b, n_pad, d)


def _qblock_fast(x: torch.Tensor, blk: Params, cfg: vit_mod.ViTConfig,
                 n_valid: int) -> torch.Tensor:
    """One int8 block on padded (B, n_pad, D) bf16 tokens: K16 -> K15, or
    K18 -> K17 on a static tree; where :func:`_int8_block_fits` is False
    (ViT-B/16 at 1024 px), the JAX package's per-linear route: four K14
    launches around ``mha_qkv`` (K9 from 1024 tokens under "auto")."""
    if "inv_ao" in blk:
        return _qblock_static(x, blk, cfg, n_valid)
    b, n_pad, d = x.shape
    act = "quick_gelu" if cfg.hidden_act == "quick_gelu" else "gelu_tanh"
    if not _int8_block_fits(cfg):
        qkv = _fused_lin(x, blk["wqkv_q"], blk["wqkv_s"], blk["bqkv"],
                         ln=(blk["ln1_scale"], blk["ln1_bias"]),
                         eps=cfg.ln_eps)
        o = mha_qkv(qkv, cfg.num_heads, n_valid=n_valid, impl=cfg.attn_impl)
        x = x + _fused_lin(o, blk["wo_q"], blk["wo_s"], blk["bo"])
        h = _fused_lin(x, blk["w1_q"], blk["w1_s"], blk["b1"], act=act,
                       ln=(blk["ln2_scale"], blk["ln2_bias"]), eps=cfg.ln_eps)
        return x + _fused_lin(h, blk["w2_q"], blk["w2_s"], blk["b2"])
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
    ``quantize_vit_fast`` or ``quantize_vit_static`` tree, or one
    :func:`prepare_int8` prepared.  The encoder is the int8 stats chain
    where :func:`_int8_stats_chain_supported`, else depth x
    :func:`_qblock_fast`."""
    prep = prepare_int8(qparams, cfg)
    wp, posb = prep["_embed"]
    x = embed_tokens_dotg(images.to(torch.bfloat16), wp, posb,
                          cfg.patch_size, cfg.num_prefix_tokens)
    if _int8_stats_chain_supported(cfg, x.shape[0]):
        x = _encoder_int8_stats_chain(x, prep["_layers"], cfg, cfg.seq_len)
    else:
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
                      raw: bool = True, device=None,
                      clip: bool = False) -> Callable[[Any], torch.Tensor]:
    """Counterpart of the JAX ``jit_forward_int8(cfg, raw, clip)``
    partially applied with the tree: returns ``fn(images) -> logits`` (or
    CLIP embeddings with ``clip``, a ``quantize_clip_vision_*`` tree)
    that runs under ``torch.inference_mode`` on ``device`` (CUDA unless
    ``"cpu"``).  The tree must already live there; numpy input is copied
    there."""
    dev = resolve_device(device)
    for leaf in (qparams["pos_embed"], qparams["blocks"]["wqkv_q"]):
        if leaf.device.type != dev.type:
            raise ValueError(f"params are on {leaf.device}, forward on {dev}")
    prepped = prepare_int8(qparams, cfg)
    if clip:
        fn = clip_forward_int8_raw if raw else clip_forward_int8_fast
    else:
        fn = vit_forward_int8_raw if raw else vit_forward_int8_fast

    def run(images) -> torch.Tensor:
        if isinstance(images, np.ndarray):
            images = torch.from_numpy(images)
        with torch.inference_mode():
            return fn(prepped, images.to(dev), cfg)

    return run


# ---------------------------------------------------------------------------
# CLIP vision tower int8: the ViT int8 blocks with CLIP's parts (the embed
# without tail rows, ln_pre, padding after it, the final LN of the CLS row
# and the f32 projection)
# ---------------------------------------------------------------------------

def quantize_clip_vision_fast(params: Params) -> Params:
    """Per-output-column int8 weights for a CLIP vision tower
    (models/clip.py layout: the ViT tree, ``ln_pre_*`` and ``proj``,
    which stay f32)."""
    out = quantize_vit_fast(params)
    for k in ("ln_pre_scale", "ln_pre_bias", "proj"):
        out[k] = params[k]
    return out


def quantize_clip_vision_static(params: Params, cfg: vit_mod.ViTConfig,
                                images: Optional[torch.Tensor] = None,
                                margin: float = 1.0) -> Params:
    """:func:`quantize_clip_vision_fast` with calibrated static activation
    scales folded in (the probe applies ``ln_pre``, as the JAX one)."""
    from ..utils.calibrate import static_activation_scales
    sc = static_activation_scales(params, cfg, images, margin)
    return _fold_static_scales(quantize_clip_vision_fast(params), sc, QMAX)


def _clip_embed(qparams: Params, images: torch.Tensor,
                cfg: vit_mod.ViTConfig) -> torch.Tensor:
    """The CLIP int8 embed: the dotg embed on bf16(wq * ws) with the
    posb table's n rows (no tail rows), ``ln_pre``, then zero padding to
    n_pad rows."""
    n = cfg.seq_len
    if _PREPARED in qparams:
        wp, posb = qparams["_embed"]
    else:
        pe = qparams["patch_embed"]
        wp = (pe["wq"].float() * pe["ws"].float()).to(torch.bfloat16)
        posb = vit_mod._cls_first_posb(
            qparams["pos_embed"][0].float(), pe["b"].float(),
            qparams["cls_token"][0].float(), 1, n)
    x = embed_tokens_dotg(images.to(torch.bfloat16), wp, posb[:n],
                          cfg.patch_size, 1)
    x = vit_mod._layernorm(x, qparams["ln_pre_scale"],
                           qparams["ln_pre_bias"], cfg.ln_eps)
    n_pad = round_up(n, pad_sublane(torch.bfloat16))
    return torch.nn.functional.pad(x, (0, 0, 0, n_pad - n))


def _clip_project(qparams: Params, x: torch.Tensor,
                  cfg: vit_mod.ViTConfig) -> torch.Tensor:
    pooled = vit_mod._layernorm(x[:, :1], qparams["ln_f_scale"],
                                qparams["ln_f_bias"], cfg.ln_eps)[:, 0]
    return pooled.float() @ qparams["proj"]


def clip_forward_int8_fast(qparams: Params, images: torch.Tensor,
                           cfg: vit_mod.ViTConfig) -> torch.Tensor:
    """The int8 CLIP image encoder: normalized images -> f32 embeddings.
    The encoder is the int8 stats chain where
    :func:`_int8_stats_chain_supported`, else depth x
    :func:`_qblock_fast` (K16 -> K15, or K18 -> K17 on a static tree).
    ``qparams`` is a ``quantize_clip_vision_*`` tree or one
    :func:`prepare_int8` prepared."""
    prep = prepare_int8(qparams, cfg)
    x = _clip_embed(prep, images, cfg)
    n = cfg.seq_len
    if _int8_stats_chain_supported(cfg, x.shape[0]):
        x = _encoder_int8_stats_chain(x, prep["_layers"], cfg, n)
    else:
        for blk in prep["_layers"]:
            x = _qblock_fast(x, blk, cfg, n)
    return _clip_project(prep, x, cfg)


def clip_forward_int8_raw(qparams: Params, images_u8: torch.Tensor,
                          cfg: vit_mod.ViTConfig) -> torch.Tensor:
    """Raw uint8 images -> CLIP embeddings through the int8 engine."""
    return clip_forward_int8_fast(qparams,
                                  vit_mod.preprocess(images_u8, cfg), cfg)


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
    laid out k-major for K19a or K19b (``kmajor``) and the head's weight
    for K14, so no call copies a weight.  A static tree keeps its
    ``inv_ao`` / ``inv_ah`` tables on the device, where K19b reads them."""
    if "posb_cl" in qparams:
        return qparams
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
    on bf16(wq * ws), the whole encoder in one launch (K19a
    ``ops/vit_stack.vit_layers_int8``, or K19b ``vit_layers_int8_static``
    on a static tree), the LayerNorm of the CLS row and the K14 head (f32
    CLS features for a headless tree).  ``qparams`` may be the plain
    ``quantize_vit_fast`` or ``quantize_vit_static`` tree or the
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
    layers = (vit_layers_int8_static if "inv_ao" in prep["blocks"]
              else vit_layers_int8)
    toks = layers(x, prep["blocks"], cfg.num_heads, eps=cfg.ln_eps, act=act,
                  n_valid=n)
    cls_t = vit_mod._layernorm(toks[:, npch:npch + 1], prep["lfs"],
                               prep["lfb"], cfg.ln_eps)
    if "head" not in prep:
        return cls_t[:, 0].float()
    hd = prep["head"]
    return int8_linear_fused(cls_t.reshape(x.shape[0], -1), hd["wq"],
                             hd["ws"], hd["b"]).float()


# ---------------------------------------------------------------------------
# Batch-1 int8 single-launch forward: embed, layers, final LN, head (K20)
# ---------------------------------------------------------------------------

def full_int8_latency_supported(qparams: Params, cfg: vit_mod.ViTConfig,
                                batch: int, card: bool = True) -> bool:
    """Gate of :func:`vit_forward_int8_latency_logits`.  Off the card
    (``card=False``) the JAX ``full_int8_latency_supported`` without its
    TPU VMEM planner: CLS pooling, one prefix token, batch <= 4 and a head
    (or the fold's), on a dynamic tree (a static tree's folded scales
    would be read as dynamic ones).  On the card also what K20 takes
    (``ops/vit_stack.full_supported``)."""
    ok = (cfg.pool == "cls" and cfg.num_prefix_tokens == 1 and batch <= 4
          and ("head" in qparams or "whq" in qparams)
          and cfg.num_classes >= 1
          and "inv_ao" not in qparams["blocks"])
    if not card:
        return ok
    return ok and full_supported(cfg.num_heads, cfg.hidden_dim, cfg.mlp_dim,
                                 cfg.seq_len, batch, cfg.patch_size)


def prep_full_int8_latency(qparams: Params,
                           cfg: vit_mod.ViTConfig) -> Params:
    """One-time fold for :func:`vit_forward_int8_latency_logits` (the JAX
    ``prep_full_int8_latency``): the posb table (CLS first), the int8
    patch weight as a k-major view and its scales, the blocks' int8
    weights as k-major views, and the int8 head padded to a multiple of
    128 classes (zero weights and biases, scales 1.0)."""
    if "posb" in qparams:
        return qparams
    n_pad = round_up(cfg.seq_len, pad_sublane(torch.bfloat16))
    pe = qparams["patch_embed"]
    posb = vit_mod._cls_first_posb(qparams["pos_embed"][0].float(),
                                   pe["b"].float(),
                                   qparams["cls_token"][0].float(),
                                   cfg.num_prefix_tokens, n_pad)
    ncls = cfg.num_classes
    extra = round_up(ncls, 128) - ncls
    hd = qparams["head"]
    pad = torch.nn.functional.pad
    return {
        "wpq": kmajor(pe["wq"]),
        "wps": pe["ws"],
        "posb": posb,
        "blocks": {k: (kmajor(v) if k.endswith("_q") else v)
                   for k, v in qparams["blocks"].items()},
        "lfs": qparams["ln_f_scale"],
        "lfb": qparams["ln_f_bias"],
        "whq": pad(hd["wq"], (0, extra)).contiguous(),
        "whs": pad(hd["ws"].float(), (0, extra), value=1.0),
        "bh": pad(hd["b"].float(), (0, extra)),
    }


def vit_forward_int8_latency_logits(qparams: Params, images: torch.Tensor,
                                    cfg: vit_mod.ViTConfig) -> torch.Tensor:
    """The whole dynamic int8 forward in one launch (K20,
    ``ops/vit_stack.vit_full_int8``): row-quantized patch embed, K19a's
    layers, the final one-pass LayerNorm of the CLS row quantized from
    f32, and the int8 head.  Returns (B, num_classes) f32.  ``qparams`` may
    be the ``quantize_vit_fast`` tree or the :func:`prep_full_int8_latency`
    fold.  It raises outside :func:`full_int8_latency_supported` (the
    card's gate on a CUDA tensor); there is no fallback to
    :func:`vit_forward_int8_latency`."""
    on_card = images.device.type == "cuda"
    if not full_int8_latency_supported(qparams, cfg, images.shape[0],
                                       card=on_card):
        raise NotImplementedError(
            f"vit_forward_int8_latency_logits takes a dynamic int8 tree with "
            f"a head, CLS pooling, one prefix token and batch <= 4, and on "
            f"the card a geometry K20 takes (full_int8_latency_supported); "
            f"got batch {images.shape[0]}")
    act = "quick_gelu" if cfg.hidden_act == "quick_gelu" else "gelu_tanh"
    prep = prep_full_int8_latency(qparams, cfg)
    out = vit_full_int8(images, prep["wpq"], prep["wps"], prep["posb"],
                        prep["blocks"], prep["lfs"], prep["lfb"], prep["whq"],
                        prep["whs"], prep["bh"], cfg.num_heads,
                        cfg.patch_size, eps=cfg.ln_eps, act=act)
    return out[:, :cfg.num_classes]


def make_forward_int8_latency(cfg: vit_mod.ViTConfig, qparams: Params,
                              raw: bool = True, device=None,
                              full: bool = False
                              ) -> Callable[[Any], torch.Tensor]:
    """The latency counterpart of :func:`make_forward_int8`:
    :func:`prep_int8_latency` runs once here, and ``fn(images) -> logits``
    runs preprocess (when ``raw``) and :func:`vit_forward_int8_latency`
    under ``torch.inference_mode`` on ``device`` (CUDA unless ``"cpu"``).
    With ``full`` it folds :func:`prep_full_int8_latency` and runs
    :func:`vit_forward_int8_latency_logits`."""
    dev = resolve_device(device)
    for leaf in (qparams["pos_embed"], qparams["blocks"]["wqkv_q"]):
        if leaf.device.type != dev.type:
            raise ValueError(f"params are on {leaf.device}, forward on {dev}")
    if cfg.remat:
        raise NotImplementedError("the int8 forward serves; remat is a "
                                  "training option")
    prepped = (prep_full_int8_latency if full
               else prep_int8_latency)(qparams, cfg)
    fwd = vit_forward_int8_latency_logits if full else vit_forward_int8_latency

    def run(images) -> torch.Tensor:
        if isinstance(images, np.ndarray):
            images = torch.from_numpy(images)
        with torch.inference_mode():
            images = images.to(dev)
            if raw:
                images = vit_mod.preprocess(images, cfg)
            return fwd(prepped, images, cfg)

    return run


def clip_int8_latency_supported(cfg: vit_mod.ViTConfig, batch: int) -> bool:
    """Gate of :func:`clip_forward_int8_latency`: the ViT one,
    :func:`int8_latency_supported` (CLIP ViT-L/14 at 224 px, 257 tokens,
    is past it)."""
    return int8_latency_supported(cfg, batch)


def prep_clip_int8_latency(qparams: Params,
                           cfg: vit_mod.ViTConfig) -> Params:
    """One-time fold for :func:`clip_forward_int8_latency`: the embed's
    bf16 weight and posb table (:func:`prepare_int8`'s) and the stacked
    int8 weights as k-major views for K19a / K19b."""
    if "_stack" in qparams:
        return qparams
    prep = prepare_int8(qparams, cfg)
    return dict(prep, _stack={k: (kmajor(v) if k.endswith("_q") else v)
                              for k, v in qparams["blocks"].items()})


def clip_forward_int8_latency(qparams: Params, images: torch.Tensor,
                              cfg: vit_mod.ViTConfig) -> torch.Tensor:
    """Small-batch int8 CLIP image encoder: the embed and ``ln_pre``
    (:func:`_clip_embed`, CLS first, padded), the whole encoder in one
    launch (K19a ``ops/vit_stack.vit_layers_int8``, or K19b
    ``vit_layers_int8_static`` on a static tree), the final LN of the CLS
    row and the f32 projection.  On the card it raises outside
    :func:`clip_int8_latency_supported`; there is no fallback."""
    if (images.device.type == "cuda"
            and not clip_int8_latency_supported(cfg, images.shape[0])):
        raise NotImplementedError(
            f"clip_forward_int8_latency on the card takes batch <= 4 and a "
            f"geometry K19a takes (clip_int8_latency_supported); got batch "
            f"{images.shape[0]} at {cfg.seq_len} tokens")
    prep = prep_clip_int8_latency(qparams, cfg)
    x = _clip_embed(prep, images, cfg)
    act = "quick_gelu" if cfg.hidden_act == "quick_gelu" else "gelu_tanh"
    layers = (vit_layers_int8_static if "inv_ao" in prep["_stack"]
              else vit_layers_int8)
    toks = layers(x, prep["_stack"], cfg.num_heads, eps=cfg.ln_eps, act=act,
                  n_valid=cfg.seq_len)
    return _clip_project(prep, toks, cfg)


def make_clip_forward_int8_latency(cfg: vit_mod.ViTConfig, qparams: Params,
                                   raw: bool = True, device=None
                                   ) -> Callable[[Any], torch.Tensor]:
    """``fn(images) -> embeddings`` through
    :func:`clip_forward_int8_latency` under ``torch.inference_mode`` on
    ``device`` (CUDA unless ``"cpu"``), the fold made once here."""
    dev = resolve_device(device)
    prepped = prep_clip_int8_latency(qparams, cfg)

    def run(images) -> torch.Tensor:
        if isinstance(images, np.ndarray):
            images = torch.from_numpy(images)
        with torch.inference_mode():
            images = images.to(dev)
            if raw:
                images = vit_mod.preprocess(images, cfg)
            return clip_forward_int8_latency(prepped, images, cfg)

    return run
