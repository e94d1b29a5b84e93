"""Vision Transformer on PyTorch (counterpart of the JAX package's
models/vit.py): the serving forward through the stats-chain encoder, and
the per-block encoder that training and ``safe_softmax`` configs take.

Parameters keep the JAX layout (``init_params``): NHWC images, the patch
kernel as (P*P*3, D) in (py, px, c) order, per-block arrays stacked on a
leading depth axis, linear weights as (in, out).  The forward is

  preprocess -> _fused_embed (one f32-accumulated GEMM, padded rows)
  -> encoder: depth x [attn_block_stats -> fused_mlp_stats] (the chain;
     fused_mlp_chunked_stats, K3, in place of fused_mlp_stats where the JAX
     package's MLP plan chunks the weights: the ViT-L family below 32 768
     token rows, ViT-B in f32),
     or depth x _block, the per-block encoder, wherever the JAX package
     leaves the chain (``_stats_chain_supported``: ``safe_softmax``,
     ``remat``, an explicit attention or MLP impl, or an attention plan
     with no score slot or with q-slot reuse, e.g. ViT-B/16 at 1024 px):
     the fused half [attn_block: K4 fwd, K23 bwd] where ``attn_plan`` fits
     it, else LN -> QKV GEMM -> ``ops/attention.mha_qkv`` (flash attention
     K9 from 1024 tokens, else K7) -> out-proj; then fused_mlp (K5 fwd, K24
     bwd), fused_mlp_chunked (K6) or the plain torch MLP, by the JAX rules
  -> LayerNorm of the prefix row -> f32 head

and runs the Hopper kernels on a CUDA device, their plain versions on
the CPU.  Every routing decision is the JAX package's as on a TPU, from
copies of its planners (``attn_plan``, ``mlp_weight_chunks``), on every
device: the card takes the TPU's place.  The batch-1 latency forward (``forward_latency``,
``make_forward_latency``) places the prefix rows after the patch rows and
runs the whole encoder in one launch (K11, ``ops/vit_stack.vit_layers``);
``forward_latency_logits`` (``make_forward_latency(..., full=True)``) runs
the whole model, image in and logits out, in one launch (K12,
``ops/vit_stack.vit_full``).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.utils.checkpoint

from ..ops.attention import mha_qkv
from ..ops.attn_block import (attn_block, attn_block_stats, attn_block_xla,
                              attn_plan)
from ..ops.common import pad_sublane, round_up, row_stats
from ..ops.fused_mlp import (MLP_BIG_ROWS, fused_mlp, fused_mlp_chunked,
                              fused_mlp_chunked_stats, fused_mlp_stats,
                              fused_mlp_xla, mlp_fits_raised,
                              mlp_weight_chunks)
from ..ops.patch_embed import embed_tokens_dotg
from ..ops.vit_stack import full_supported, stack_supported, vit_full, \
    vit_layers
from ..utils.platform import resolve_device, tanh_plain, true_f32

Params = Dict[str, Any]

IMAGENET_MEAN = (0.5, 0.5, 0.5)
IMAGENET_STD = (0.5, 0.5, 0.5)
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    hidden_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_dim: int = 3072
    num_classes: int = 1000
    ln_eps: float = 1e-6
    dtype: str = "bfloat16"          # compute dtype; params stay f32
    # Attention of the per-block encoder: auto | pallas | flash | xla.
    # "auto" resolves as the JAX package resolves it on a TPU (on every
    # device): the fused half (K4) where attn_plan fits it, else the
    # unfused half with mha_qkv's own "auto" (K9 from 1024 tokens, else
    # K7).  An explicit impl is passed to mha_qkv verbatim and leaves the
    # stats chain (see _block, _stats_chain_supported).
    attn_impl: str = "auto"
    pool: str = "cls"                # cls | gap
    num_prefix_tokens: int = 1
    hidden_act: str = "gelu"         # gelu (erf) | gelu_tanh | quick_gelu
    # MLP of the per-block encoder: auto | pallas | xla ("auto": K5 where
    # the JAX plan keeps the weights unchunked, else the plain torch MLP;
    # "pallas": K5, or K6 where the weights take chunks).
    mlp_impl: str = "auto"
    # Exact max-subtract softmax instead of the max-free exp(clip(s)) fast
    # path; routes the encoder to the per-block kernels (K4, K5).
    safe_softmax: bool = False
    remat: bool = False              # checkpoint each block (training)
    mean: Tuple[float, ...] = IMAGENET_MEAN
    std: Tuple[float, ...] = IMAGENET_STD

    @property
    def n_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def seq_len(self) -> int:
        return self.n_patches + self.num_prefix_tokens

    @property
    def head_dim(self) -> int:
        return self.hidden_dim // self.num_heads

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32


VARIANTS: Dict[str, Dict[str, int]] = {
    "vit_ti16": dict(patch_size=16, hidden_dim=192, depth=12, num_heads=3,
                     mlp_dim=768),
    "vit_s16": dict(patch_size=16, hidden_dim=384, depth=12, num_heads=6,
                    mlp_dim=1536),
    "vit_b16": dict(patch_size=16, hidden_dim=768, depth=12, num_heads=12,
                    mlp_dim=3072),
    "vit_b32": dict(patch_size=32, hidden_dim=768, depth=12, num_heads=12,
                    mlp_dim=3072),
    "vit_l16": dict(patch_size=16, hidden_dim=1024, depth=24, num_heads=16,
                    mlp_dim=4096),
    "vit_l14": dict(patch_size=14, hidden_dim=1024, depth=24, num_heads=16,
                    mlp_dim=4096),
    "vit_h14": dict(patch_size=14, hidden_dim=1280, depth=32, num_heads=16,
                    mlp_dim=5120),
}


def flops_per_image(cfg: ViTConfig) -> float:
    """Analytic forward FLOPs (2 x MACs) per image, patch embed and head
    included: the count of the JAX package's ``bench.py``
    (``vit_flops_per_image``), on the unpadded sequence."""
    n, d, m, l = cfg.seq_len, cfg.hidden_dim, cfg.mlp_dim, cfg.depth
    p3 = cfg.patch_size * cfg.patch_size * 3
    per_layer = (2 * n * d * 3 * d + 4 * n * n * d + 2 * n * d * d
                 + 4 * n * d * m)
    return (2 * cfg.n_patches * p3 * d + l * per_layer
            + 2 * d * cfg.num_classes)


def config(variant: str, image_size: int = 224, **overrides) -> ViTConfig:
    if variant not in VARIANTS:
        raise ValueError(
            f"unknown variant {variant!r}; have {sorted(VARIANTS)}")
    return ViTConfig(image_size=image_size, **{**VARIANTS[variant],
                                               **overrides})


# ---------------------------------------------------------------------------
# Initialization
# ---------------------------------------------------------------------------

def seeded_generator(generator: Optional[torch.Generator] = None
                     ) -> torch.Generator:
    """``generator``, or a CPU generator seeded with 0 when None."""
    if generator is None:
        generator = torch.Generator()
        generator.manual_seed(0)
    return generator


def trunc_normal(generator: torch.Generator, device, *shape) -> torch.Tensor:
    """Truncated normal, std 0.02 cut at 2 std, f32, drawn on the CPU from
    ``generator`` and moved to ``device``."""
    t = torch.empty(shape, dtype=torch.float32)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (t * 0.02).to(device)


def init_params(cfg: ViTConfig, generator: Optional[torch.Generator] = None,
                device=None) -> Params:
    """Truncated-normal (std 0.02, cut at 2 std) init in the JAX tree and
    layout, f32.  Values are drawn on the CPU from ``generator`` (a CPU
    generator; seed 0 when None), so a seed gives the same weights on
    every device, then moved to ``device``."""
    dev = resolve_device(device)
    generator = seeded_generator(generator)
    d, l, m = cfg.hidden_dim, cfg.depth, cfg.mlp_dim
    p3 = cfg.patch_size * cfg.patch_size * 3

    def tn(*shape):
        return trunc_normal(generator, dev, *shape)

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=dev)

    def ones(*shape):
        return torch.ones(shape, dtype=torch.float32, device=dev)

    return {
        "patch_embed": {"kernel": tn(p3, d), "bias": zeros(d)},
        "cls_token": zeros(1, cfg.num_prefix_tokens, d),
        "pos_embed": tn(1, cfg.seq_len, d),
        "blocks": {
            "ln1_scale": ones(l, d),
            "ln1_bias": zeros(l, d),
            "wqkv": tn(l, d, 3 * d),
            "bqkv": zeros(l, 3 * d),
            "wo": tn(l, d, d),
            "bo": zeros(l, d),
            "ln2_scale": ones(l, d),
            "ln2_bias": zeros(l, d),
            "w1": tn(l, d, m),
            "b1": zeros(l, m),
            "w2": tn(l, m, d),
            "b2": zeros(l, d),
        },
        "ln_f_scale": ones(d),
        "ln_f_bias": zeros(d),
        "head": {"kernel": tn(d, cfg.num_classes),
                 "bias": zeros(cfg.num_classes)},
    }


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _layernorm(x, scale, bias, eps):
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, unbiased=False, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale + bias).to(x.dtype)


def patchify(images: torch.Tensor, patch: int) -> torch.Tensor:
    """(B, H, W, 3) -> (B, N, patch*patch*3), row-major patch grid, pixel
    order (py, px, c)."""
    b, h, w, c = images.shape
    gh, gw = h // patch, w // patch
    x = images.reshape(b, gh, patch, gw, patch, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, gh * gw, patch * patch * c)


def preprocess(images_u8: torch.Tensor, cfg: ViTConfig) -> torch.Tensor:
    """uint8 (B, S, S, 3) -> normalized compute-dtype (B, S, S, 3).

    Only S x S input is taken; the JAX package's bilinear resize of other
    sizes is not ported yet."""
    s = cfg.image_size
    if tuple(images_u8.shape[1:]) != (s, s, 3):
        raise ValueError(f"preprocess takes (B, {s}, {s}, 3) images, got "
                         f"{tuple(images_u8.shape)}")
    x = images_u8.float() / 255.0
    mean = torch.tensor(cfg.mean, dtype=torch.float32, device=x.device)
    std = torch.tensor(cfg.std, dtype=torch.float32, device=x.device)
    return ((x - mean) / std).to(cfg.compute_dtype)


def _hidden_act_xla(h: torch.Tensor, name: str) -> torch.Tensor:
    """The JAX ``_hidden_act`` of the unfused MLP on ``h``: "gelu" is
    tanh-GELU (``jax.nn.gelu(approximate=True)``) in bf16 and erf-GELU in
    f32; evaluated in f32 and rounded to h's dtype once."""
    hf = h.float()
    if name == "gelu" and h.dtype != torch.bfloat16:
        out = 0.5 * hf * (1.0 + torch.erf(hf * (1.0 / np.sqrt(2.0))))
    elif name in ("gelu", "gelu_tanh"):
        c = float(np.sqrt(2.0 / np.pi))
        out = 0.5 * hf * (1.0 + tanh_plain(c * (hf + 0.044715 * hf ** 3)))
    elif name == "quick_gelu":
        out = hf * torch.sigmoid(1.702 * hf)
    else:
        raise ValueError(f"unknown hidden_act {name!r}")
    return out.to(h.dtype)


def _hidden_act(cfg: ViTConfig) -> str:
    """The MLP activation the JAX CPU path evaluates: "gelu" runs as
    tanh-GELU in bf16 (the two differ below bf16 resolution) and as erf
    in f32."""
    if cfg.hidden_act == "gelu" and cfg.compute_dtype == torch.bfloat16:
        return "gelu_tanh"
    if cfg.hidden_act not in ("gelu", "gelu_tanh", "quick_gelu"):
        raise ValueError(f"unknown hidden_act {cfg.hidden_act!r}")
    return cfg.hidden_act


@contextlib.contextmanager
def _precision_ctx(cfg: ViTConfig):
    """f32 mode runs true-f32 matmuls: TF32 off for matmul and cuDNN."""
    if cfg.dtype != "float32":
        yield
        return
    with true_f32():
        yield


def _cls_first_posb(pos, bias, pre, npre: int, n_pad: int) -> torch.Tensor:
    """The (n_pad, D) f32 posb table with the prefix rows first, then the
    patch rows, then zero rows."""
    n, d = pos.shape
    return torch.cat([
        pre + pos[:npre],
        pos[npre:] + bias,
        torch.zeros((n_pad - n, d), dtype=torch.float32, device=pos.device),
    ], dim=0)


def _fused_embed(params: Params, images: torch.Tensor, cfg: ViTConfig,
                 n_pad: int) -> torch.Tensor:
    """Images -> PADDED (B, n_pad, D) tokens, prefix rows first; bias,
    position table and prefix rows ride a folded (n_pad, D) f32 table."""
    dt = cfg.compute_dtype
    posb = _cls_first_posb(params["pos_embed"][0].float(),
                           params["patch_embed"]["bias"].float(),
                           params["cls_token"][0].float(),
                           cfg.num_prefix_tokens, n_pad)
    return embed_tokens_dotg(images.to(dt),
                             params["patch_embed"]["kernel"].to(dt),
                             posb, cfg.patch_size, cfg.num_prefix_tokens)


def _stats_chain_mlp_plan(cfg: ViTConfig, rows: int):
    """The chain's MLP half for ``rows`` token rows (the JAX
    ``_stats_chain_mlp_vmem`` without its VMEM byte counts): ``"k2"`` for
    the unchunked half (the JAX default and raised plans compute the same
    function), an int ``n`` for K3 with n chunks, ``None`` where the chain
    does not apply (ViT-H: 4 chunks; ViT-L in f32)."""
    itemsize = 2 if cfg.dtype == "bfloat16" else 4
    d, m = cfg.hidden_dim, cfg.mlp_dim
    n_chunks = mlp_weight_chunks(d, m, itemsize)
    if n_chunks == 1:
        return "k2"
    if (n_chunks > 1 and itemsize == 2 and rows >= MLP_BIG_ROWS
            and mlp_fits_raised(d, m, itemsize)):
        return "k2"
    if n_chunks == 2:
        return n_chunks
    return None


def _n_pad(cfg: ViTConfig) -> int:
    return round_up(cfg.seq_len, pad_sublane(cfg.compute_dtype))


def _itemsize(cfg: ViTConfig) -> int:
    return 2 if cfg.dtype == "bfloat16" else 4


def _attn_plan(cfg: ViTConfig, batch: int = 1):
    """The JAX package's attention plan for this geometry (token rows
    padded to 8, keys to 128)."""
    return attn_plan(cfg.num_heads, cfg.hidden_dim, _n_pad(cfg),
                     round_up(cfg.seq_len, 128), _itemsize(cfg), batch=batch)


def _attn_block_fits(cfg: ViTConfig) -> bool:
    """Whether the JAX package runs the fused attention half (K4) under
    "pallas" (the JAX ``_attn_block_fits``): its plan has a score slot."""
    return _attn_plan(cfg).n_sc >= 1


def _stats_chain_supported(cfg: ViTConfig, batch: int) -> bool:
    """The JAX ``_stats_chain_supported`` as on a TPU: no exact softmax,
    no remat, attention and MLP impls "auto" or "pallas", an attention plan
    with a score slot and no q-slot reuse at this batch, and an MLP plan
    (:func:`_stats_chain_mlp_plan`).  So ViT-B/16 leaves the chain at
    1024 px (no slot: the per-block path with flash attention), and CLIP
    ViT-L/14 at an odd batch (q-slot reuse: the per-block kernels)."""
    if (cfg.safe_softmax or cfg.remat
            or cfg.attn_impl not in ("auto", "pallas")
            or cfg.mlp_impl not in ("auto", "pallas")):
        return False
    plan = _attn_plan(cfg, batch)
    if plan.n_sc < 1 or plan.reuse_q:
        return False
    return _stats_chain_mlp_plan(cfg, batch * _n_pad(cfg)) is not None


def _mlp_route(cfg: ViTConfig, rows: int):
    """The JAX ``_block``'s MLP decision as on a TPU, for ``rows`` token
    rows: ``("pallas", 1)`` for K5, ``("pallas", n)`` for K6 with n
    chunks, ``("xla", 0)`` for the plain torch MLP."""
    itemsize = _itemsize(cfg)
    d, m = cfg.hidden_dim, cfg.mlp_dim
    impl = cfg.mlp_impl
    n_chunks = 1
    if impl == "auto":
        n_chunks = mlp_weight_chunks(d, m, itemsize)
        if (n_chunks > 1 and itemsize == 2 and rows >= MLP_BIG_ROWS
                and mlp_fits_raised(d, m, itemsize)):
            n_chunks = 1
        impl = "pallas" if n_chunks == 1 else "xla"
    elif impl == "pallas":
        n_chunks = mlp_weight_chunks(d, m, itemsize)
        if n_chunks == 0:      # nothing fits even chunked
            impl = "xla"
    elif impl != "xla":
        raise ValueError(f"unknown mlp_impl {impl!r}")
    if impl == "pallas" and _hidden_act(cfg) == "gelu":
        impl = "xla"           # erf-GELU (f32) goes to the plain MLP
    return (impl, n_chunks) if impl == "pallas" else ("xla", 0)


def _attn_route(cfg: ViTConfig) -> str:
    """The JAX ``_block``'s attention decision as on a TPU: "block" for
    the fused half (K4), else "unfused" (LN, QKV GEMM, ``mha_qkv`` with
    ``cfg.attn_impl``, out-proj)."""
    if cfg.attn_impl not in ("auto", "pallas", "flash", "xla"):
        raise ValueError(f"unknown attn_impl {cfg.attn_impl!r}")
    if cfg.attn_impl in ("auto", "pallas") and _attn_block_fits(cfg):
        return "block"
    return "unfused"


def _block(x: torch.Tensor, blk: Params, cfg: ViTConfig,
           n_valid: int) -> torch.Tensor:
    """One pre-LN transformer block on padded (B, n_pad, D) tokens,
    differentiable: the JAX ``_block`` branch for branch, as on a TPU.

    Attention: the fused half (K4 forward, K23 backward) where
    :func:`_attn_route` says "block"; else LN -> ``h @ wqkv + bqkv`` in
    the compute dtype -> ``mha_qkv(impl=cfg.attn_impl)`` (K9 from 1024
    tokens under "auto", K7 below or under "pallas") -> ``o @ wo + bo`` +
    residual.  MLP (:func:`_mlp_route`): K5 (K24 backward), K6 with its
    chunks, or the plain torch MLP.  The fused halves take the weights as
    the JAX package does: the attention half the f32 ``wqkv``/``wo`` (cast
    inside the kernel wrapper, so their gradients stay f32), the MLP half
    ``w1``/``w2`` already cast to the compute dtype."""
    b, n_pad, d = x.shape
    dt = cfg.compute_dtype
    if _attn_route(cfg) == "block":
        x = attn_block(x, blk["ln1_scale"], blk["ln1_bias"], blk["wqkv"],
                       blk["bqkv"], blk["wo"], blk["bo"], cfg.num_heads,
                       cfg.ln_eps, n_valid, cfg.safe_softmax)
    else:
        h = _layernorm(x, blk["ln1_scale"], blk["ln1_bias"], cfg.ln_eps)
        qkv = h @ blk["wqkv"].to(dt) + blk["bqkv"].to(dt)
        o = mha_qkv(qkv, cfg.num_heads, n_valid=n_valid,
                    impl=cfg.attn_impl)
        x = x + (o @ blk["wo"].to(dt) + blk["bo"].to(dt))
    impl, n_chunks = _mlp_route(cfg, b * n_pad)
    if impl == "pallas":
        args = (x.reshape(b * n_pad, d), blk["ln2_scale"], blk["ln2_bias"],
                blk["w1"].to(dt), blk["b1"], blk["w2"].to(dt), blk["b2"],
                cfg.ln_eps, _hidden_act(cfg))
        y = (fused_mlp_chunked(*args, n_chunks) if n_chunks > 1
             else fused_mlp(*args))
        return y.reshape(b, n_pad, d)
    h = _layernorm(x, blk["ln2_scale"], blk["ln2_bias"], cfg.ln_eps)
    h = _hidden_act_xla(h @ blk["w1"].to(dt) + blk["b1"].to(dt),
                        cfg.hidden_act)
    return x + (h @ blk["w2"].to(dt) + blk["b2"].to(dt))


def _encoder_blocks(blocks: Params, x: torch.Tensor, cfg: ViTConfig,
                    n_valid: int) -> torch.Tensor:
    """depth x :func:`_block`, each checkpointed when ``cfg.remat``.

    The layers' weights come from one ``unbind`` of each stacked
    parameter: its backward stacks the per-layer gradients once, where
    indexing ``v[i]`` would add a full-size zero-filled gradient per
    layer."""
    layers = {k: v.unbind(0) for k, v in blocks.items()}
    for i in range(cfg.depth):
        blk = {k: v[i] for k, v in layers.items()}
        if cfg.remat:
            x = torch.utils.checkpoint.checkpoint(
                _block, x, blk, cfg, n_valid, use_reentrant=False)
        else:
            x = _block(x, blk, cfg, n_valid)
    return x


def _encoder_stats_chain(blocks: Params, x: torch.Tensor, cfg: ViTConfig,
                         n_valid: int, plan=None) -> torch.Tensor:
    """The serving encoder: each half consumes the previous half's
    LayerNorm (mu, rstd) and emits the next half's.  ``plan`` is
    :func:`_stats_chain_mlp_plan`'s (computed here when None): the MLP
    half is K2 for ``"k2"``, K3 with ``plan`` chunks for an int.  Its
    kernels have no backward, so it refuses to run where a gradient is
    wanted."""
    if torch.is_grad_enabled() and any(v.requires_grad
                                       for v in blocks.values()):
        raise NotImplementedError(
            "the stats chain has no backward; set safe_softmax or remat "
            "to train through the per-block kernels")
    b, n_pad, d = x.shape
    if plan is None:
        plan = _stats_chain_mlp_plan(cfg, b * n_pad)
    if plan is None:
        raise ValueError("no stats-chain MLP plan for this geometry "
                         "(_stats_chain_supported is False)")
    chunk = {} if plan == "k2" else {"n_chunks": plan}
    mlp = fused_mlp_stats if plan == "k2" else fused_mlp_chunked_stats
    act = _hidden_act(cfg)
    st = row_stats(x, cfg.ln_eps)           # first LN1 stats, plain torch
    for i in range(cfg.depth):
        x, st = attn_block_stats(
            x, st, blocks["ln1_scale"][i], blocks["ln1_bias"][i],
            blocks["wqkv"][i], blocks["bqkv"][i], blocks["wo"][i],
            blocks["bo"][i], cfg.num_heads, eps=cfg.ln_eps,
            n_valid=n_valid, emit_stats=True)
        last = i == cfg.depth - 1
        t, st2 = mlp(
            x.reshape(b * n_pad, d), st.reshape(b * n_pad, 2),
            blocks["ln2_scale"][i], blocks["ln2_bias"][i], blocks["w1"][i],
            blocks["b1"][i], blocks["w2"][i], blocks["b2"][i],
            eps=cfg.ln_eps, act=act, emit_stats=not last, **chunk)
        x = t.reshape(b, n_pad, d)
        if not last:
            st = st2.reshape(b, n_pad, 2)
    return x


def _encoder_chain_xla(blocks: Params, x: torch.Tensor, cfg: ViTConfig,
                       n_valid: int) -> torch.Tensor:
    """Reference of the chained encoder: two-pass LayerNorm in each half
    and the exact softmax."""
    b, n_pad, d = x.shape
    act = _hidden_act(cfg)
    for i in range(cfg.depth):
        x = attn_block_xla(x, blocks["ln1_scale"][i], blocks["ln1_bias"][i],
                           blocks["wqkv"][i], blocks["bqkv"][i],
                           blocks["wo"][i], blocks["bo"][i], cfg.num_heads,
                           cfg.ln_eps, n_valid)
        t = fused_mlp_xla(x.reshape(b * n_pad, d), blocks["ln2_scale"][i],
                          blocks["ln2_bias"][i], blocks["w1"][i],
                          blocks["b1"][i], blocks["w2"][i], blocks["b2"][i],
                          eps=cfg.ln_eps, act=act)
        x = t.reshape(b, n_pad, d)
    return x


def _encoder(blocks: Params, x: torch.Tensor, cfg: ViTConfig,
             n_valid: int) -> torch.Tensor:
    """Padded (B, n_pad, D) tokens through the encoder: the stats chain
    where :func:`_stats_chain_supported`, else the per-block kernels (the
    dispatch of the JAX ``_forward_features``)."""
    if _stats_chain_supported(cfg, x.shape[0]):
        return _encoder_stats_chain(blocks, x, cfg, n_valid)
    return _encoder_blocks(blocks, x, cfg, n_valid)


def _patchify_embed(params: Params, images: torch.Tensor, cfg: ViTConfig,
                    n_pad: int) -> torch.Tensor:
    """The JAX ``_forward_features``' embed for attention impls other than
    "auto" / "pallas": patchify, GEMM and bias, the prefix rows, the
    position table, in the compute dtype, padded to ``n_pad`` rows."""
    dt = cfg.compute_dtype
    x = patchify(images.to(dt), cfg.patch_size)
    x = x @ params["patch_embed"]["kernel"].to(dt)
    x = x + params["patch_embed"]["bias"].to(dt)
    cls = params["cls_token"].to(dt).expand(x.shape[0], -1, -1)
    x = torch.cat([cls, x], dim=1) + params["pos_embed"].to(dt)
    return torch.nn.functional.pad(x, (0, 0, 0, n_pad - cfg.seq_len))


def _forward_features(params: Params, images: torch.Tensor,
                      cfg: ViTConfig) -> torch.Tensor:
    """Normalized images -> PRE-final-LN tokens (B, N, D).  Tokens stay
    padded to n_pad rows through the encoder ("padded residency").  The
    embed is the dotg one under attention impls "auto" / "pallas", else
    the patchify one (as the JAX ``_forward_features``)."""
    n = cfg.seq_len
    embed = (_fused_embed if cfg.attn_impl in ("auto", "pallas")
             else _patchify_embed)
    x = embed(params, images, cfg, _n_pad(cfg))
    return _encoder(params["blocks"], x, cfg, n)[:, :n]


def forward_features(params: Params, images: torch.Tensor,
                     cfg: ViTConfig) -> torch.Tensor:
    """Normalized images (B, S, S, 3) -> final-LN token features
    (B, N, D)."""
    with _precision_ctx(cfg):
        x = _forward_features(params, images, cfg)
        return _layernorm(x, params["ln_f_scale"], params["ln_f_bias"],
                          cfg.ln_eps)


def forward(params: Params, images: torch.Tensor,
            cfg: ViTConfig) -> torch.Tensor:
    """Normalized images (B, S, S, 3) -> f32 class logits (B, classes)."""
    with _precision_ctx(cfg):
        toks = _forward_features(params, images, cfg)
        if cfg.pool == "cls":
            # LayerNorm is per token: normalize only the CLS row
            pooled = _layernorm(toks[:, :1], params["ln_f_scale"],
                                params["ln_f_bias"], cfg.ln_eps)[:, 0]
        elif cfg.pool == "gap":
            feats = _layernorm(toks, params["ln_f_scale"],
                               params["ln_f_bias"], cfg.ln_eps)
            pooled = feats[:, cfg.num_prefix_tokens:].float().mean(dim=1)
        else:
            raise ValueError(f"unknown pool {cfg.pool!r}")
        return (pooled.float() @ params["head"]["kernel"]
                + params["head"]["bias"])


def forward_raw(params: Params, images_u8: torch.Tensor,
                cfg: ViTConfig) -> torch.Tensor:
    """Raw uint8 images in -> logits out."""
    return forward(params, preprocess(images_u8, cfg), cfg)


def _prepare_params(params: Params, cfg: ViTConfig) -> Params:
    """One-time cast of the blocks' weight matrices to the compute dtype,
    so no forward re-casts them (biases and LN params stay f32)."""
    dt = cfg.compute_dtype
    blocks = dict(params["blocks"])
    for name in ("wqkv", "wo", "w1", "w2"):
        blocks[name] = blocks[name].to(dt).contiguous()
    return {**params, "blocks": blocks}


def serving_fn(cfg: ViTConfig, params: Params, fn: Callable, device=None
               ) -> Callable[[Any], torch.Tensor]:
    """``images -> fn(prepared params, images, cfg)`` under
    ``torch.inference_mode`` on ``device`` (CUDA unless ``"cpu"``), the
    weight matrices cast once (:func:`_prepare_params`): the body of every
    model family's ``make_forward``.  The params must already live there;
    numpy input is copied there."""
    dev = resolve_device(device)
    if dev.type == "cuda" and cfg.compute_dtype != torch.bfloat16:
        raise NotImplementedError(
            "the Hopper kernels take bfloat16; f32 on the card is not ported "
            "yet (run f32 with device='cpu')")
    for leaf in (params["pos_embed"], params["blocks"]["wqkv"]):
        if leaf.device.type != dev.type:
            raise ValueError(f"params are on {leaf.device}, forward on {dev}")
    prepped = _prepare_params(params, cfg)

    def run(images) -> torch.Tensor:
        if isinstance(images, np.ndarray):
            images = torch.from_numpy(images)
        with torch.inference_mode():
            return fn(prepped, images.to(dev), cfg)

    return run


def make_forward(cfg: ViTConfig, params: Params, raw: bool = True,
                 device=None) -> Callable[[Any], torch.Tensor]:
    """Counterpart of the JAX ``jit_forward(cfg, raw)`` partially applied
    with the params: returns ``fn(images) -> logits`` that runs under
    ``torch.inference_mode`` on ``device`` (CUDA unless ``"cpu"``).  The
    params must already live there; numpy input is copied there."""
    return serving_fn(cfg, params, forward_raw if raw else forward, device)


# ---------------------------------------------------------------------------
# Batch-1 latency forward: the whole encoder in one launch (K11)
# ---------------------------------------------------------------------------

def latency_forward_supported(cfg: ViTConfig, batch: int) -> bool:
    """Gate of :func:`forward_latency` on the card (the JAX
    ``latency_forward_supported`` with :func:`stack_supported` in place of
    the TPU's VMEM planner): bf16, CLS pooling, batch <= 4, the max-free
    softmax, and a geometry the K11 kernel takes."""
    return (cfg.dtype == "bfloat16" and cfg.pool == "cls" and batch <= 4
            and not cfg.safe_softmax
            and stack_supported(cfg.num_heads, cfg.hidden_dim, cfg.mlp_dim,
                                cfg.seq_len, batch))


def _cls_last_posb(pos, bias, pre, npre: int, n_pad: int) -> torch.Tensor:
    """The (n_pad, D) f32 posb table with the patch rows first and the
    prefix rows after them (``embed_tokens_dotg(prefix_last=True)``)."""
    n, d = pos.shape
    return torch.cat([
        pos[npre:] + bias,                     # patch rows 0..npch-1
        pre + pos[:npre],                      # prefix rows (CLS first)
        torch.zeros((n_pad - n, d), dtype=torch.float32, device=pos.device),
    ], dim=0)


def prep_latency(params: Params, cfg: ViTConfig) -> Params:
    """One-time fold for :func:`forward_latency`'s CLS-last embed: the
    compute-dtype patch kernel, the posb table with patch rows first, and
    the blocks' weight matrices cast to the compute dtype once, so no call
    re-casts them."""
    n_pad = _n_pad(cfg)
    posb = _cls_last_posb(params["pos_embed"][0].float(),
                          params["patch_embed"]["bias"].float(),
                          params["cls_token"][0].float(),
                          cfg.num_prefix_tokens, n_pad)
    return {
        "wp_cl": params["patch_embed"]["kernel"].to(cfg.compute_dtype),
        "posb_cl": posb,
        "blocks": _prepare_params(params, cfg)["blocks"],
        "lfs": params["ln_f_scale"],
        "lfb": params["ln_f_bias"],
        "wh": params["head"]["kernel"],
        "bh": params["head"]["bias"],
    }


def _latency_act(hidden_act: str) -> str:
    """The stack kernels' activation: "gelu" runs as tanh-GELU (the JAX
    ``forward_latency`` does so in f32 too)."""
    return "gelu_tanh" if hidden_act == "gelu" else hidden_act


def forward_latency(params: Params, images: torch.Tensor,
                    cfg: ViTConfig) -> torch.Tensor:
    """Small-batch forward for latency serving: the dotg embed with the
    prefix rows LAST, the whole encoder in one launch (K11,
    ``ops/vit_stack.vit_layers``), the LayerNorm of the CLS row (at row
    ``npch``) and the f32 head.  ``params`` may be the plain tree or the
    :func:`prep_latency` fold.  On the card it raises outside
    :func:`latency_forward_supported`; there is no fallback to
    :func:`forward`."""
    if cfg.pool != "cls":
        raise ValueError("forward_latency pools the CLS row (pool='cls')")
    if (images.device.type == "cuda"
            and not latency_forward_supported(cfg, images.shape[0])):
        raise NotImplementedError(
            f"forward_latency on the card takes bf16, batch <= 4, the "
            f"max-free softmax and a geometry K11 takes "
            f"(latency_forward_supported); got batch {images.shape[0]}")
    with _precision_ctx(cfg):
        dt = cfg.compute_dtype
        n, npre = cfg.seq_len, cfg.num_prefix_tokens
        npch = n - npre
        prep = params if "posb_cl" in params else prep_latency(params, cfg)
        x = embed_tokens_dotg(images.to(dt), prep["wp_cl"], prep["posb_cl"],
                              cfg.patch_size, npre, prefix_last=True)
        toks = vit_layers(x, prep["blocks"], cfg.num_heads, eps=cfg.ln_eps,
                          act=_latency_act(cfg.hidden_act), n_valid=n)
        pooled = _layernorm(toks[:, npch:npch + 1], prep["lfs"], prep["lfb"],
                            cfg.ln_eps)[:, 0]
        return pooled.float() @ prep["wh"] + prep["bh"]


# ---------------------------------------------------------------------------
# Batch-1 single-launch forward: embed, layers, final LN and head (K12)
# ---------------------------------------------------------------------------

def full_latency_supported(cfg: ViTConfig, batch: int,
                           card: bool = True) -> bool:
    """Gate of :func:`forward_latency_logits`.  Off the card (``card=False``)
    the JAX ``full_latency_supported`` without its TPU VMEM planner: one
    prefix token, a head, and an activation the stack takes; like it, the
    gate reads neither ``pool`` nor the batch (a GAP-pooled config gets
    CLS-pooled logits).  On the card also bf16 and what K12 takes
    (:func:`full_supported`: batch <= 4, head dim 64, <= 256 tokens, K11's
    D and M, 3 patch^2 a multiple of 16)."""
    ok = (cfg.num_prefix_tokens == 1 and cfg.num_classes >= 1
          and cfg.hidden_act in ("gelu", "gelu_tanh", "quick_gelu"))
    if not card:
        return ok
    return (ok and cfg.dtype == "bfloat16"
            and full_supported(cfg.num_heads, cfg.hidden_dim, cfg.mlp_dim,
                               cfg.seq_len, batch, cfg.patch_size))


def prep_full_latency(params: Params, cfg: ViTConfig) -> Params:
    """One-time fold for :func:`forward_latency_logits` (the JAX
    ``prep_full_latency``): the posb table (CLS first), the compute-dtype
    patch kernel and blocks, and the head in the compute dtype padded to a
    multiple of 128 classes (zero columns, zero biases)."""
    dt = cfg.compute_dtype
    ncls = cfg.num_classes
    cls_pad = round_up(ncls, 128)
    posb = _cls_first_posb(params["pos_embed"][0].float(),
                           params["patch_embed"]["bias"].float(),
                           params["cls_token"][0].float(),
                           cfg.num_prefix_tokens, _n_pad(cfg))
    pad = torch.nn.functional.pad
    return {
        "wp": params["patch_embed"]["kernel"].to(dt).contiguous(),
        "posb": posb,
        "blocks": _prepare_params(params, cfg)["blocks"],
        "lfs": params["ln_f_scale"],
        "lfb": params["ln_f_bias"],
        "wh": pad(params["head"]["kernel"].to(dt), (0, cls_pad - ncls)),
        "bh": pad(params["head"]["bias"].float(), (0, cls_pad - ncls)),
    }


def forward_latency_logits(params: Params, images: torch.Tensor,
                           cfg: ViTConfig) -> torch.Tensor:
    """The whole forward in one launch (K12, ``ops/vit_stack.vit_full``):
    the patch embed from the image, every layer, the final one-pass
    LayerNorm of the CLS row cast to the compute dtype, and the head with
    f32 sums.  Returns (B, num_classes) f32.  ``params`` may be the plain
    tree or the :func:`prep_full_latency` fold.  It raises outside
    :func:`full_latency_supported` (the card's gate on a CUDA tensor);
    there is no fallback to :func:`forward_latency`."""
    on_card = images.device.type == "cuda"
    if not full_latency_supported(cfg, images.shape[0], card=on_card):
        raise NotImplementedError(
            f"forward_latency_logits takes one prefix token, a head and a "
            f"gelu / gelu_tanh / quick_gelu MLP, and on the card bf16 and a "
            f"geometry K12 takes (full_latency_supported); got batch "
            f"{images.shape[0]}")
    with _precision_ctx(cfg):
        prep = params if "posb" in params else prep_full_latency(params, cfg)
        out = vit_full(images, prep["wp"], prep["posb"], prep["blocks"],
                       prep["lfs"], prep["lfb"], prep["wh"], prep["bh"],
                       cfg.num_heads, cfg.patch_size, eps=cfg.ln_eps,
                       act=_latency_act(cfg.hidden_act))
        return out[:, :cfg.num_classes]


def make_forward_latency(cfg: ViTConfig, params: Params, raw: bool = True,
                         device=None,
                         full: bool = False) -> Callable[[Any], torch.Tensor]:
    """The latency counterpart of :func:`make_forward` (what the JAX
    ``bench.py`` latency mode builds): :func:`prep_latency` runs once here,
    and ``fn(images) -> logits`` runs preprocess (when ``raw``) and
    :func:`forward_latency` under ``torch.inference_mode`` on ``device``
    (CUDA unless ``"cpu"``).  With ``full`` it folds
    :func:`prep_full_latency` and runs :func:`forward_latency_logits`."""
    dev = resolve_device(device)
    if dev.type == "cuda" and cfg.compute_dtype != torch.bfloat16:
        raise NotImplementedError(
            "the Hopper kernels take bfloat16; f32 on the card is not ported "
            "yet (run f32 with device='cpu')")
    for leaf in (params["pos_embed"], params["blocks"]["wqkv"]):
        if leaf.device.type != dev.type:
            raise ValueError(f"params are on {leaf.device}, forward on {dev}")
    prepped = (prep_full_latency if full else prep_latency)(params, cfg)
    fwd = forward_latency_logits if full else forward_latency

    def run(images) -> torch.Tensor:
        if isinstance(images, np.ndarray):
            images = torch.from_numpy(images)
        with torch.inference_mode():
            images = images.to(dev)
            if raw:
                images = preprocess(images, cfg)
            return fwd(prepped, images, cfg)

    return run
