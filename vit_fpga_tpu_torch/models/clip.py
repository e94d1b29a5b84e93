"""CLIP on PyTorch (counterpart of the JAX package's models/clip.py): the
vision tower served through the same encoder as the ViT, and the text
tower.

The vision tower is a ViT with CLIP's deltas: no patch bias in published
checkpoints, a LayerNorm before the encoder (``ln_pre``) and one on the
pooled CLS row (``ln_f``), quick-GELU, eps 1e-5, CLIP's mean and std, and
a bias-free projection (``proj``) into the shared embedding space in
place of a classifier.  Its encoder is :func:`models.vit._encoder`: the
stats chain (K1 with K2, or with K3 where the JAX MLP plan chunks the
weights, as at ViT-L/14 below 32 768 token rows) or the per-block
kernels.  At 224 px ViT-L/14 has 257 tokens, so K1's launches count as
past 256 keys.  The batch-1 forward (:func:`forward_latency`) runs the encoder in
one launch (K11).

The text tower has no Pallas kernel in the JAX package (causal einsum
attention over at most 77 tokens): here it is plain PyTorch, f32.
Contrastive training and the HuggingFace importers are not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch

from . import vit as vit_mod
from ..ops.patch_embed import embed_tokens_dotg
from ..ops.vit_stack import stack_supported, vit_layers
from ..utils.platform import resolve_device, true_f32

Params = Dict[str, Any]


def clip_vision_config(variant: str = "vit_l14", image_size: int = 224,
                       **overrides) -> vit_mod.ViTConfig:
    """A ViTConfig with CLIP's semantics (quick-GELU, eps 1e-5, CLIP mean
    and std, no classifier)."""
    defaults = dict(hidden_act="quick_gelu", ln_eps=1e-5,
                    mean=vit_mod.CLIP_MEAN, std=vit_mod.CLIP_STD,
                    num_classes=0)
    defaults.update(overrides)
    return vit_mod.config(variant, image_size=image_size, **defaults)


@dataclasses.dataclass(frozen=True)
class CLIPHead:
    """Projection geometry (embed dim of the shared space)."""
    projection_dim: int = 768


def init_params(cfg: vit_mod.ViTConfig, projection_dim: int = 768,
                generator: Optional[torch.Generator] = None,
                device=None) -> Params:
    """The ViT tree without ``head``, plus ``ln_pre_*`` and ``proj``
    (D, projection_dim), in the JAX layout, f32, drawn from ``generator``
    (seed 0 when None) on the CPU and moved to ``device``."""
    dev = resolve_device(device)
    gen = vit_mod.seeded_generator(generator)
    base = vit_mod.init_params(dataclasses.replace(cfg, num_classes=1), gen,
                               device=dev)
    del base["head"]
    d = cfg.hidden_dim
    base["ln_pre_scale"] = torch.ones((d,), dtype=torch.float32, device=dev)
    base["ln_pre_bias"] = torch.zeros((d,), dtype=torch.float32, device=dev)
    base["proj"] = vit_mod.trunc_normal(gen, dev, d, projection_dim)
    return base


def _embed(params: Params, images: torch.Tensor,
           cfg: vit_mod.ViTConfig) -> torch.Tensor:
    """Images -> (B, N, D) tokens, CLS first, through the dotg embed.  No
    tail rows: the token axis is padded after ``ln_pre`` (padding before
    it would turn the zero rows into bias rows)."""
    dt = cfg.compute_dtype
    pos = params["pos_embed"][0].float()
    bias = params["patch_embed"]["bias"].float()
    pre = params["cls_token"][0].float()
    posb = torch.cat([pre + pos[:1], pos[1:] + bias], dim=0)
    return embed_tokens_dotg(images.to(dt),
                             params["patch_embed"]["kernel"].to(dt), posb,
                             cfg.patch_size, 1)


def _project(params: Params, toks: torch.Tensor,
             cfg: vit_mod.ViTConfig) -> torch.Tensor:
    """LayerNorm of the CLS row, then the f32 projection."""
    pooled = vit_mod._layernorm(toks[:, 0], params["ln_f_scale"],
                                params["ln_f_bias"], cfg.ln_eps)
    return pooled.float() @ params["proj"]


def forward(params: Params, images: torch.Tensor,
            cfg: vit_mod.ViTConfig) -> torch.Tensor:
    """Normalized images (B, S, S, 3) -> image embeddings
    (B, projection_dim), f32 and unnormalized."""
    with vit_mod._precision_ctx(cfg):
        n = cfg.seq_len
        x = _embed(params, images, cfg)
        x = vit_mod._layernorm(x, params["ln_pre_scale"],
                               params["ln_pre_bias"], cfg.ln_eps)
        # padded residency: the token axis is padded once, with zero rows
        x = torch.nn.functional.pad(x, (0, 0, 0, vit_mod._n_pad(cfg) - n))
        x = vit_mod._encoder(params["blocks"], x, cfg, n)
        return _project(params, x, cfg)


def forward_raw(params: Params, images_u8: torch.Tensor,
                cfg: vit_mod.ViTConfig) -> torch.Tensor:
    """Raw uint8 (B, S, S, 3) -> embeddings."""
    return forward(params, vit_mod.preprocess(images_u8, cfg), cfg)


def make_forward(cfg: vit_mod.ViTConfig, params: Params, raw: bool = True,
                 device=None) -> Callable[[Any], torch.Tensor]:
    """Counterpart of the JAX ``jit_forward(cfg, raw)`` with the params
    applied: ``fn(images) -> (B, projection_dim)`` embeddings under
    ``torch.inference_mode`` on ``device`` (CUDA unless ``"cpu"``), for
    ``runtime.serving.ImageServer``."""
    return vit_mod.serving_fn(cfg, params, forward_raw if raw else forward,
                              device)


def embed_normalized(params: Params, images: torch.Tensor,
                     cfg: vit_mod.ViTConfig) -> torch.Tensor:
    """L2-normalized embeddings (cosine-ready)."""
    e = forward(params, images, cfg)
    return e / torch.linalg.norm(e, dim=-1, keepdim=True)


# ---------------------------------------------------------------------------
# Batch-1 latency forward: the encoder in one launch (K11)
# ---------------------------------------------------------------------------

def latency_forward_supported(cfg: vit_mod.ViTConfig, batch: int) -> bool:
    """Gate of :func:`forward_latency` on the card (the JAX
    ``latency_forward_supported`` with K11's :func:`stack_supported` in
    place of the TPU's VMEM planner): bf16, batch <= 4 and a geometry K11
    takes."""
    return (cfg.dtype == "bfloat16" and batch <= 4
            and stack_supported(cfg.num_heads, cfg.hidden_dim, cfg.mlp_dim,
                                cfg.seq_len, batch))


def forward_latency(params: Params, images: torch.Tensor,
                    cfg: vit_mod.ViTConfig) -> torch.Tensor:
    """Small-batch CLIP image encoder: the embed and ``ln_pre``, the whole
    encoder in one launch (K11, ``ops/vit_stack.vit_layers``, CLS first),
    ``ln_f`` on the CLS row and the projection.  On the card it raises
    outside :func:`latency_forward_supported`; there is no fallback."""
    if (images.device.type == "cuda"
            and not latency_forward_supported(cfg, images.shape[0])):
        raise NotImplementedError(
            f"CLIP forward_latency on the card takes bf16, batch <= 4 and a "
            f"geometry K11 takes (latency_forward_supported); got batch "
            f"{images.shape[0]}")
    with vit_mod._precision_ctx(cfg):
        x = _embed(params, images, cfg)
        x = vit_mod._layernorm(x, params["ln_pre_scale"],
                               params["ln_pre_bias"], cfg.ln_eps)
        act = "quick_gelu" if cfg.hidden_act == "quick_gelu" else "gelu_tanh"
        toks = vit_layers(x, params["blocks"], cfg.num_heads, eps=cfg.ln_eps,
                          act=act)
        return _project(params, toks, cfg)


# ---------------------------------------------------------------------------
# Text tower (plain PyTorch, f32)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_dim: int = 512
    depth: int = 12
    num_heads: int = 8
    mlp_dim: int = 2048
    max_positions: int = 77
    ln_eps: float = 1e-5
    projection_dim: int = 768


def init_text_params(cfg: CLIPTextConfig,
                     generator: Optional[torch.Generator] = None,
                     device=None) -> Params:
    """The JAX ``init_text_params`` tree (truncated-normal std 0.02 for
    the embeddings, weights and projection; LN ones / zeros; zero
    biases), f32, drawn from ``generator`` (seed 0 when None)."""
    dev = resolve_device(device)
    gen = vit_mod.seeded_generator(generator)
    d, l, m = cfg.hidden_dim, cfg.depth, cfg.mlp_dim

    def tn(*shape):
        return vit_mod.trunc_normal(gen, dev, *shape)

    def full(value, *shape):
        return torch.full(shape, value, dtype=torch.float32, device=dev)

    return {
        "token_embed": tn(cfg.vocab_size, d),
        "pos_embed": tn(cfg.max_positions, d),
        "blocks": {
            "ln1_scale": full(1.0, l, d), "ln1_bias": full(0.0, l, d),
            "wqkv": tn(l, d, 3 * d), "bqkv": full(0.0, l, 3 * d),
            "wo": tn(l, d, d), "bo": full(0.0, l, d),
            "ln2_scale": full(1.0, l, d), "ln2_bias": full(0.0, l, d),
            "w1": tn(l, d, m), "b1": full(0.0, l, m),
            "w2": tn(l, m, d), "b2": full(0.0, l, d),
        },
        "ln_f_scale": full(1.0, d), "ln_f_bias": full(0.0, d),
        "proj": tn(d, cfg.projection_dim),
    }


def _causal_text_block(x: torch.Tensor, blk: Params,
                       cfg: CLIPTextConfig) -> torch.Tensor:
    """One pre-LN block with causal softmax attention and quick-GELU."""
    b, n, d = x.shape
    h = vit_mod._layernorm(x, blk["ln1_scale"], blk["ln1_bias"], cfg.ln_eps)
    qkv = h @ blk["wqkv"] + blk["bqkv"]
    dh = d // cfg.num_heads

    def heads(t):
        return t.reshape(b, n, cfg.num_heads, dh).transpose(1, 2)

    q, k, v = heads(qkv[..., :d]), heads(qkv[..., d:2 * d]), \
        heads(qkv[..., 2 * d:])
    scores = (q.float() @ k.float().transpose(-1, -2)) * (dh ** -0.5)
    causal = torch.ones((n, n), dtype=torch.bool, device=x.device).tril()
    scores = torch.where(causal, scores, torch.full_like(scores, -1e30))
    p = torch.softmax(scores, dim=-1).to(x.dtype)
    o = (p @ v).transpose(1, 2).reshape(b, n, d)
    x = x + (o @ blk["wo"] + blk["bo"])
    h = vit_mod._layernorm(x, blk["ln2_scale"], blk["ln2_bias"], cfg.ln_eps)
    h = h @ blk["w1"] + blk["b1"]
    h = h * torch.sigmoid(1.702 * h)          # quick-GELU
    return x + (h @ blk["w2"] + blk["b2"])


def text_forward(params: Params, input_ids: torch.Tensor,
                 cfg: CLIPTextConfig) -> torch.Tensor:
    """Token ids (B, N) -> text embeddings (B, projection_dim), pooled at
    the EOT token, which CLIP finds as the argmax id of each sequence
    (the first one on a tie, as ``jnp.argmax``)."""
    with true_f32():
        b, n = input_ids.shape
        ids = input_ids.long()
        x = params["token_embed"][ids] + params["pos_embed"][:n]
        layers = {k: v.unbind(0) for k, v in params["blocks"].items()}
        for i in range(cfg.depth):
            x = _causal_text_block(x, {k: v[i] for k, v in layers.items()},
                                   cfg)
        x = vit_mod._layernorm(x, params["ln_f_scale"], params["ln_f_bias"],
                               cfg.ln_eps)
        eot = torch.argmax(ids, dim=-1)
        pooled = x[torch.arange(b, device=x.device), eot]
        return pooled.float() @ params["proj"]
