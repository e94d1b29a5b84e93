"""DeiT on PyTorch (counterpart of the JAX package's models/deit.py): a
ViT whose sequence carries two prefix tokens (CLS and distillation) and
whose classifier is the mean of two linear heads, one per prefix token.

The encoder is :mod:`models.vit`'s with ``num_prefix_tokens=2``: the
prefix rows ride the folded posb table of the dotg embed, and the kernels
run unchanged (DeiT-B/16 at 224 px: 198 tokens on 200 rows, K1 with K2).
The HuggingFace importer (:func:`from_hf_deit_state_dict`,
:func:`from_hf_deit_model`) is the JAX package's.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Optional

import numpy as np
import torch

from . import vit
from ..utils.platform import resolve_device

Params = Dict[str, Any]

# DeiT/16 variants at 224 px (original paper sizes).
VARIANTS = {
    "deit_ti16": dict(patch_size=16, hidden_dim=192, depth=12,
                      num_heads=3, mlp_dim=768),
    "deit_s16": dict(patch_size=16, hidden_dim=384, depth=12,
                     num_heads=6, mlp_dim=1536),
    "deit_b16": dict(patch_size=16, hidden_dim=768, depth=12,
                     num_heads=12, mlp_dim=3072),
}


def config(variant: str, image_size: int = 224,
           **overrides) -> vit.ViTConfig:
    if variant not in VARIANTS:
        raise ValueError(
            f"unknown variant {variant!r}; have {sorted(VARIANTS)}")
    base = dict(VARIANTS[variant], num_prefix_tokens=2,
                # DeiT checkpoints use torchvision-style ImageNet stats
                mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225))
    base.update(overrides)
    return vit.ViTConfig(image_size=image_size, **base)


def init_params(cfg: vit.ViTConfig,
                generator: Optional[torch.Generator] = None,
                device=None) -> Params:
    """The ViT tree (``cls_token`` holds both prefix embeddings) plus the
    distillation head ``head_dist``, drawn from ``generator`` (seed 0
    when None) on the CPU and moved to ``device``."""
    if cfg.num_prefix_tokens != 2:
        raise ValueError("DeiT needs CLS + distill tokens "
                         "(num_prefix_tokens=2)")
    dev = resolve_device(device)
    gen = vit.seeded_generator(generator)
    params = vit.init_params(cfg, gen, device=dev)
    params["head_dist"] = {
        "kernel": vit.trunc_normal(gen, dev, cfg.hidden_dim, cfg.num_classes),
        "bias": torch.zeros((cfg.num_classes,), dtype=torch.float32,
                            device=dev),
    }
    return params


def forward(params: Params, images: torch.Tensor,
            cfg: vit.ViTConfig) -> torch.Tensor:
    """Normalized images -> f32 logits: the mean of the CLS head and the
    distillation head, or the CLS head alone without ``head_dist``."""
    with vit._precision_ctx(cfg):
        toks = vit._forward_features(params, images, cfg)
        # final LN over just the two prefix rows
        prf = vit._layernorm(toks[:, :2], params["ln_f_scale"],
                             params["ln_f_bias"], cfg.ln_eps).float()
        logits_cls = (prf[:, 0] @ params["head"]["kernel"]
                      + params["head"]["bias"])
        if "head_dist" not in params:   # single-head DeiT checkpoint
            return logits_cls
        logits_dist = (prf[:, 1] @ params["head_dist"]["kernel"]
                       + params["head_dist"]["bias"])
        return (logits_cls + logits_dist) * 0.5


def forward_raw(params: Params, images_u8: torch.Tensor,
                cfg: vit.ViTConfig) -> torch.Tensor:
    return forward(params, vit.preprocess(images_u8, cfg), cfg)


def make_forward(cfg: vit.ViTConfig, params: Params, raw: bool = True,
                 device=None) -> Callable[[Any], torch.Tensor]:
    """``fn(images) -> logits`` under ``torch.inference_mode`` on
    ``device`` (CUDA unless ``"cpu"``), as ``vit.make_forward``."""
    return vit.serving_fn(cfg, params, forward_raw if raw else forward,
                          device)


def from_hf_deit_state_dict(sd: Mapping[str, Any], depth: int) -> Params:
    """A HF ``DeiTForImageClassificationWithTeacher`` (dual heads),
    ``DeiTForImageClassification`` (one CLS head) or bare ``DeiTModel``
    state dict in the stacked layout, numpy f32: the JAX importer's tree,
    array for array."""
    from ..utils.checkpoint import _to_numpy, from_hf_vit_state_dict
    g = lambda name: np.asarray(_to_numpy(sd[name]),  # noqa: E731
                                dtype=np.float32)
    sd = dict(sd)
    prefix = "deit." if any(k.startswith("deit.") for k in sd) else ""
    # the ViT importer reads the layers DeiT shares under "vit."
    base = {k.replace("deit.", "vit.", 1) if prefix else "vit." + k: v
            for k, v in sd.items()}
    params = from_hf_vit_state_dict(base, depth=depth)
    cls = g(f"{prefix}embeddings.cls_token")
    dist = g(f"{prefix}embeddings.distillation_token")
    params["cls_token"] = np.concatenate([cls, dist], axis=1)  # (1, 2, D)
    if "cls_classifier.weight" in sd:      # WithTeacher: dual heads
        params["head"] = {"kernel": g("cls_classifier.weight").T,
                          "bias": g("cls_classifier.bias")}
        params["head_dist"] = {
            "kernel": g("distillation_classifier.weight").T,
            "bias": g("distillation_classifier.bias")}
    # DeiTForImageClassification keeps its single CLS head ('classifier.*',
    # already imported); forward() then uses the CLS row only.
    return params


def from_hf_deit_model(model) -> Params:
    """Params of a live HF DeiT module (``config`` and ``state_dict()``
    only)."""
    from ..utils.checkpoint import hf_state_dict
    return from_hf_deit_state_dict(hf_state_dict(model),
                                   depth=model.config.num_hidden_layers)
