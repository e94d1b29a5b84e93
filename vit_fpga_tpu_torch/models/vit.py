"""Vision Transformer on PyTorch (counterpart of the JAX package's
models/vit.py): the serving forward through the stats-chain encoder, and
the per-block encoder that training and ``safe_softmax`` configs take.

Parameters keep the JAX layout (``init_params``): NHWC images, the patch
kernel as (P*P*3, D) in (py, px, c) order, per-block arrays stacked on a
leading depth axis, linear weights as (in, out).  The forward is

  preprocess -> _fused_embed (one f32-accumulated GEMM, padded rows)
  -> encoder: depth x [attn_block_stats -> fused_mlp_stats] (the chain),
     or depth x _block = [attn_block -> fused_mlp] when ``safe_softmax``
     or ``remat`` is set (differentiable: K4/K5 forward, K23/K24 backward)
  -> LayerNorm of the prefix row -> f32 head

and runs the Hopper kernels on a CUDA device, their plain versions on
the CPU.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.utils.checkpoint

from ..ops.attn_block import attn_block, attn_block_stats, attn_block_xla
from ..ops.common import pad_sublane, round_up, row_stats
from ..ops.fused_mlp import fused_mlp, fused_mlp_stats, fused_mlp_xla
from ..ops.patch_embed import embed_tokens_dotg
from ..utils.platform import resolve_device

Params = Dict[str, Any]

IMAGENET_MEAN = (0.5, 0.5, 0.5)
IMAGENET_STD = (0.5, 0.5, 0.5)


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
    pool: str = "cls"                # cls | gap
    num_prefix_tokens: int = 1
    hidden_act: str = "gelu"         # gelu (erf) | gelu_tanh | quick_gelu
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

def init_params(cfg: ViTConfig, generator: Optional[torch.Generator] = None,
                device=None) -> Params:
    """Truncated-normal (std 0.02, cut at 2 std) init in the JAX tree and
    layout, f32.  Values are drawn on the CPU from ``generator`` (a CPU
    generator; seed 0 when None), so a seed gives the same weights on
    every device, then moved to ``device``."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator()
        generator.manual_seed(0)
    d, l, m = cfg.hidden_dim, cfg.depth, cfg.mlp_dim
    p3 = cfg.patch_size * cfg.patch_size * 3

    def tn(*shape):
        t = torch.empty(shape, dtype=torch.float32)
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0,
                                    generator=generator)
        return (t * 0.02).to(dev)

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
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _fused_embed(params: Params, images: torch.Tensor, cfg: ViTConfig,
                 n_pad: int) -> torch.Tensor:
    """Images -> PADDED (B, n_pad, D) tokens, prefix rows first; bias,
    position table and prefix rows ride a folded (n_pad, D) f32 table."""
    dt = cfg.compute_dtype
    n, d = cfg.seq_len, cfg.hidden_dim
    npre = cfg.num_prefix_tokens
    pos = params["pos_embed"][0].float()
    bias = params["patch_embed"]["bias"].float()
    pre = params["cls_token"][0].float()
    posb = torch.cat([
        pre + pos[:npre],
        pos[npre:] + bias,
        torch.zeros((n_pad - n, d), dtype=torch.float32, device=pos.device),
    ], dim=0)
    return embed_tokens_dotg(images.to(dt),
                             params["patch_embed"]["kernel"].to(dt),
                             posb, cfg.patch_size, npre)


def _stats_chain_supported(cfg: ViTConfig) -> bool:
    """The chain serves unless the config asks for the exact softmax or
    for remat (the JAX ``_stats_chain_supported``, without its TPU
    planner checks)."""
    return not (cfg.safe_softmax or cfg.remat)


def _block(x: torch.Tensor, blk: Params, cfg: ViTConfig,
           n_valid: int) -> torch.Tensor:
    """One pre-LN transformer block on padded (B, n_pad, D) tokens,
    differentiable (counterpart of the JAX ``_block``'s fused path).

    The weight handling is the JAX package's: the attention half takes
    the f32 ``wqkv``/``wo`` (cast to the compute dtype inside the kernel
    wrapper, so their gradients stay f32), the MLP half takes ``w1``/``w2``
    already cast to the compute dtype (so their gradients are rounded to
    it)."""
    b, n_pad, d = x.shape
    dt = cfg.compute_dtype
    x = attn_block(x, blk["ln1_scale"], blk["ln1_bias"], blk["wqkv"],
                   blk["bqkv"], blk["wo"], blk["bo"], cfg.num_heads,
                   cfg.ln_eps, n_valid, cfg.safe_softmax)
    y = fused_mlp(x.reshape(b * n_pad, d), blk["ln2_scale"],
                  blk["ln2_bias"], blk["w1"].to(dt), blk["b1"],
                  blk["w2"].to(dt), blk["b2"], cfg.ln_eps, _hidden_act(cfg))
    return y.reshape(b, n_pad, d)


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
                         n_valid: int) -> torch.Tensor:
    """The serving encoder: each half consumes the previous half's
    LayerNorm (mu, rstd) and emits the next half's.  Its kernels have no
    backward, so it refuses to run where a gradient is wanted."""
    if torch.is_grad_enabled() and any(v.requires_grad
                                       for v in blocks.values()):
        raise NotImplementedError(
            "the stats chain has no backward; set safe_softmax or remat "
            "to train through the per-block kernels")
    b, n_pad, d = x.shape
    act = _hidden_act(cfg)
    st = row_stats(x, cfg.ln_eps)           # first LN1 stats, plain torch
    for i in range(cfg.depth):
        x, st = attn_block_stats(
            x, st, blocks["ln1_scale"][i], blocks["ln1_bias"][i],
            blocks["wqkv"][i], blocks["bqkv"][i], blocks["wo"][i],
            blocks["bo"][i], cfg.num_heads, eps=cfg.ln_eps,
            n_valid=n_valid, emit_stats=True)
        last = i == cfg.depth - 1
        t, st2 = fused_mlp_stats(
            x.reshape(b * n_pad, d), st.reshape(b * n_pad, 2),
            blocks["ln2_scale"][i], blocks["ln2_bias"][i], blocks["w1"][i],
            blocks["b1"][i], blocks["w2"][i], blocks["b2"][i],
            eps=cfg.ln_eps, act=act, emit_stats=not last)
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


def _forward_features(params: Params, images: torch.Tensor,
                      cfg: ViTConfig) -> torch.Tensor:
    """Normalized images -> PRE-final-LN tokens (B, N, D).  Tokens stay
    padded to n_pad rows through the encoder ("padded residency")."""
    n = cfg.seq_len
    n_pad = round_up(n, pad_sublane(cfg.compute_dtype))
    x = _fused_embed(params, images, cfg, n_pad)
    encoder = (_encoder_stats_chain if _stats_chain_supported(cfg)
               else _encoder_blocks)
    x = encoder(params["blocks"], x, cfg, n)
    return x[:, :n]


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


def make_forward(cfg: ViTConfig, params: Params, raw: bool = True,
                 device=None) -> Callable[[Any], torch.Tensor]:
    """Counterpart of the JAX ``jit_forward(cfg, raw)`` partially applied
    with the params: returns ``fn(images) -> logits`` that runs under
    ``torch.inference_mode`` on ``device`` (CUDA unless ``"cpu"``).  The
    params must already live there; numpy input is copied there."""
    dev = resolve_device(device)
    if dev.type == "cuda" and cfg.compute_dtype != torch.bfloat16:
        raise NotImplementedError(
            "the Hopper kernels take bfloat16; f32 on the card is not ported "
            "yet (run f32 with device='cpu')")
    for leaf in (params["pos_embed"], params["blocks"]["wqkv"]):
        if leaf.device.type != dev.type:
            raise ValueError(f"params are on {leaf.device}, forward on {dev}")
    prepped = _prepare_params(params, cfg)
    fn = forward_raw if raw else forward

    def run(images) -> torch.Tensor:
        if isinstance(images, np.ndarray):
            images = torch.from_numpy(images)
        with torch.inference_mode():
            return fn(prepped, images.to(dev), cfg)

    return run
