"""Checkpoints of the port (counterpart of the JAX package's
utils/checkpoint.py): params and training state on disk, and the
HuggingFace ViT import.

  * :func:`save_params` / :func:`load_params`: any tree of arrays or
    tensors as one flat-key ``.npz`` (keys joined by ``"::"``), written
    to a temporary file and moved into place.  The JAX package writes and
    reads the same format, so a file either package writes, the other
    reads (f32, int8 and int32 leaves).  ``load_params`` returns numpy;
    ``models/convert.params_from_numpy`` puts the tree on a device.
  * :func:`save_train_state` / :func:`load_train_state`: the JAX
    example's ``{"params", "opt_state", "step"}`` tree in the same
    format (the JAX package uses orbax, which the port does not import),
    ``opt_state`` the AdamW moments in optax's layout ``{"mu", "nu",
    "count"}`` (``models/convert.adamw_state_to_optax``).  No pickle.
  * :func:`from_hf_vit_state_dict` / :func:`from_hf_vit_model`: a
    HuggingFace ``ViTForImageClassification`` or ``ViTModel`` state dict
    in the port's stacked layout (linear weights (in, out), the conv
    patch weight (D, 3, P, P) as the (P*P*3, D) GEMM kernel in (py, px,
    c) order, q | k | v concatenated into ``wqkv``); the JAX importer's
    numpy tree, array for array.  A live module is read through its
    ``config`` and ``state_dict()`` alone.
  * :func:`autocalibrated` / :func:`import_hf_vit`: the trust boundary
    of an import, ``safe_softmax`` measured for the checkpoint
    (``utils/calibrate.choose_softmax_mode``), loud when it routes to the
    exact softmax.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Any, Dict, Mapping

import numpy as np
import torch

Params = Dict[str, Any]
_SEP = "::"

_log = logging.getLogger("vit_fpga_tpu_torch.checkpoint")


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _flatten(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}{_SEP}"))
    else:
        out[prefix[:-len(_SEP)]] = _to_numpy(tree)
    return out


def _unflatten(flat: Mapping[str, np.ndarray]) -> Params:
    tree: Params = {}
    for key, val in flat.items():
        parts = key.split(_SEP)
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return tree


def _write(path: str, flat: Mapping[str, np.ndarray]) -> None:
    tmp = path + ".tmp"
    np.savez(tmp, **flat)
    # numpy appends .npz to names without the suffix
    if not tmp.endswith(".npz"):
        tmp += ".npz"
    os.replace(tmp, path)


def _read(path: str) -> Params:
    with np.load(path, allow_pickle=False) as z:
        return _unflatten({k: z[k] for k in z.files})


def save_params(path: str, params: Any) -> None:
    """Write a tree of arrays or tensors to one ``.npz`` file."""
    _write(path, _flatten(params))


def load_params(path: str) -> Params:
    """The tree :func:`save_params` (or the JAX package's) wrote, as
    numpy arrays."""
    return _read(path)


# ---------------------------------------------------------------------------
# Training state
# ---------------------------------------------------------------------------

def save_train_state(path: str, state: Mapping[str, Any]) -> None:
    """Write a training state ``{"params", "opt_state", "step"}`` (any
    tree of arrays, tensors and ints) atomically to one ``.npz``."""
    _write(path, _flatten(state))


def _like(value: np.ndarray, like):
    if isinstance(like, Mapping):
        if not isinstance(value, Mapping) or set(value) != set(like):
            raise ValueError("the checkpoint's tree does not match `like`")
        return {k: _like(value[k], like[k]) for k in like}
    if isinstance(like, torch.Tensor):
        return torch.from_numpy(np.array(value)).to(like.device, like.dtype)
    if isinstance(like, (bool, int, float)):
        return type(like)(value)
    return np.asarray(value, dtype=np.asarray(like).dtype)


def load_train_state(path: str, like: Any = None) -> Any:
    """Restore a state :func:`save_train_state` wrote: numpy leaves (0-d
    arrays for scalars), or with ``like`` (a tree of the same keys) each
    leaf as its counterpart's type: a tensor on its device in its dtype,
    a Python scalar, or a numpy array of its dtype."""
    state = _read(path)
    return state if like is None else _like(state, like)


# ---------------------------------------------------------------------------
# HuggingFace ViT import
# ---------------------------------------------------------------------------

def from_hf_vit_state_dict(sd: Mapping[str, Any], depth: int,
                           prefix: str = "vit.") -> Params:
    """A HF ViT state dict (numpy arrays or tensors) in the stacked
    layout.  ``ViTForImageClassification`` and bare ``ViTModel`` both
    convert; the ``head`` entry exists only where a classifier does."""
    g = lambda name: np.asarray(_to_numpy(sd[name]),  # noqa: E731
                                dtype=np.float32)

    conv_w = g(f"{prefix}embeddings.patch_embeddings.projection.weight")
    d_model = conv_w.shape[0]
    patch_kernel = conv_w.transpose(2, 3, 1, 0).reshape(-1, d_model)

    def stack(fmt: str, transform=None):
        mats = []
        for i in range(depth):
            m = g(fmt.format(i=i))
            mats.append(transform(m) if transform else m)
        return np.stack(mats)

    t = np.transpose
    lyr = f"{prefix}encoder.layer.{{i}}."
    wq = stack(lyr + "attention.attention.query.weight", t)
    wk = stack(lyr + "attention.attention.key.weight", t)
    wv = stack(lyr + "attention.attention.value.weight", t)
    bq = stack(lyr + "attention.attention.query.bias")
    bk = stack(lyr + "attention.attention.key.bias")
    bv = stack(lyr + "attention.attention.value.bias")

    params: Params = {
        "patch_embed": {
            "kernel": patch_kernel,
            "bias": g(f"{prefix}embeddings.patch_embeddings.projection.bias"),
        },
        "cls_token": g(f"{prefix}embeddings.cls_token"),
        "pos_embed": g(f"{prefix}embeddings.position_embeddings"),
        "blocks": {
            "ln1_scale": stack(lyr + "layernorm_before.weight"),
            "ln1_bias": stack(lyr + "layernorm_before.bias"),
            "wqkv": np.concatenate([wq, wk, wv], axis=2),
            "bqkv": np.concatenate([bq, bk, bv], axis=1),
            "wo": stack(lyr + "attention.output.dense.weight", t),
            "bo": stack(lyr + "attention.output.dense.bias"),
            "ln2_scale": stack(lyr + "layernorm_after.weight"),
            "ln2_bias": stack(lyr + "layernorm_after.bias"),
            "w1": stack(lyr + "intermediate.dense.weight", t),
            "b1": stack(lyr + "intermediate.dense.bias"),
            "w2": stack(lyr + "output.dense.weight", t),
            "b2": stack(lyr + "output.dense.bias"),
        },
        "ln_f_scale": g(f"{prefix}layernorm.weight"),
        "ln_f_bias": g(f"{prefix}layernorm.bias"),
    }
    if "classifier.weight" in sd:
        params["head"] = {"kernel": g("classifier.weight").T,
                          "bias": g("classifier.bias")}
    return params


def hf_state_dict(model) -> Dict[str, np.ndarray]:
    """A live torch module's state dict as numpy arrays."""
    return {k: v.detach().cpu().numpy()
            for k, v in model.state_dict().items()}


def from_hf_vit_model(model) -> Params:
    """Params of a live HF ViT module (``model.config`` and
    ``model.state_dict()`` only).  :func:`import_hf_vit` also builds the
    config and calibrates the softmax window."""
    return from_hf_vit_state_dict(hf_state_dict(model),
                                  depth=model.config.num_hidden_layers)


# ---------------------------------------------------------------------------
# Trust-boundary calibration
# ---------------------------------------------------------------------------

def autocalibrated(params: Any, cfg, source: str = "checkpoint",
                   device=None):
    """``cfg`` with ``safe_softmax`` measured for this checkpoint
    (``utils/calibrate.choose_softmax_mode``), so a hot-logit checkpoint
    never saturates the max-free softmax's clip window [-70, 80].  Loud:
    routing to the exact softmax is logged as a WARNING.  A numpy tree is
    probed on ``device`` (CUDA unless ``"cpu"``); a tensor tree where it
    lives."""
    from ..models.convert import params_from_numpy
    from . import calibrate
    if not isinstance(params["pos_embed"], torch.Tensor):
        params = params_from_numpy(params, device=device)
    res = calibrate.choose_softmax_mode(params, cfg)
    if res.safe and not cfg.safe_softmax:
        _log.warning(
            "%s has hot attention logits (score range [%.1f, %.1f] vs "
            "clip window [-70, 80]): routing to the exact max-subtract "
            "softmax kernels (cfg.safe_softmax=True)", source,
            res.score_min, res.score_max)
    return dataclasses.replace(cfg, safe_softmax=res.safe)


def import_hf_vit(model, image_size: int = 0, dtype: str = "bfloat16",
                  calibrate: bool = True, device=None, **overrides):
    """The HF ViT import: ``(params, cfg)``, numpy params and the config
    built from the checkpoint's own geometry, the softmax window
    calibrated on ``device`` (:func:`autocalibrated`).  ``model`` is a
    live ``ViTForImageClassification`` or ``ViTModel``."""
    from ..models.vit import ViTConfig
    hf = model.config
    params = from_hf_vit_model(model)
    n_classes = (params["head"]["bias"].shape[0]
                 if "head" in params else 0)
    cfg = ViTConfig(
        image_size=image_size or hf.image_size,
        patch_size=hf.patch_size,
        hidden_dim=hf.hidden_size,
        depth=hf.num_hidden_layers,
        num_heads=hf.num_attention_heads,
        mlp_dim=hf.intermediate_size,
        num_classes=n_classes,
        ln_eps=hf.layer_norm_eps,
        hidden_act={"gelu": "gelu", "gelu_new": "gelu_tanh"}.get(
            hf.hidden_act, hf.hidden_act),
        dtype=dtype,
        **overrides,
    )
    if calibrate:
        cfg = autocalibrated(params, cfg, source="HF ViT import",
                             device=device)
    return params, cfg

