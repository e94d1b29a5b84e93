"""ViT classification training (counterpart of the JAX package's
train/trainer.py), single device.

  * :func:`make_vit_train_step`: cross-entropy, backward, optimizer step.
    The forward runs the per-block encoder (``safe_softmax`` is forced, as
    in the JAX step), so each layer launches K4 and K5 forward and K24 and
    K23 backward on the card; the embed, final LayerNorm, head and loss
    are plain PyTorch under autograd, as the JAX package leaves them to
    XLA.
  * :class:`Trainer`: a minimal loop around it with AdamW, the
    ``optax.adamw`` rule (decay on every parameter).

bf16 compute with f32 params and f32 optimizer state.  optax's
``GradientTransformation`` becomes a factory (:func:`sgd`, :func:`adamw`)
that builds a ``torch.optim`` optimizer over the parameter leaves; the
step updates the params in place and hands the optimizer back as the
state.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..models import vit
from ..utils.platform import resolve_device

Params = Dict[str, Any]
OptimizerFactory = Callable[[List[torch.Tensor]], torch.optim.Optimizer]


def param_leaves(params: Params) -> List[torch.Tensor]:
    """The parameter tensors in a fixed order (sorted keys, depth first);
    the optimizer's parameter order."""
    out = []
    for k in sorted(params):
        v = params[k]
        out.extend(param_leaves(v) if isinstance(v, dict) else [v])
    return out


def sgd(learning_rate: float) -> OptimizerFactory:
    """Plain SGD (``optax.sgd``)."""
    return lambda leaves: torch.optim.SGD(leaves, lr=learning_rate)


def adamw(learning_rate: float,
          weight_decay: float = 1e-4) -> OptimizerFactory:
    """AdamW with ``optax.adamw``'s defaults (betas 0.9 / 0.999, eps 1e-8,
    decay 1e-4; torch's own default decay is 0.01) and rule:
    bias-corrected moments and decoupled decay of every parameter."""
    return lambda leaves: torch.optim.AdamW(
        leaves, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8,
        weight_decay=weight_decay)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean NLL over VALID labels: every negative label (the data
    pipeline's padding sentinel) contributes zero loss.  This is not
    ``F.cross_entropy``'s ``ignore_index``, which masks one value only."""
    logp = F.log_softmax(logits.float(), dim=-1)
    valid = labels >= 0
    nll = -logp.gather(-1, labels.clamp_min(0)[:, None])[:, 0]
    n = valid.sum().clamp_min(1)
    return torch.where(valid, nll, torch.zeros_like(nll)).sum() / n


def vit_loss(params: Params, images: torch.Tensor, labels: torch.Tensor,
             cfg: vit.ViTConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """(loss, accuracy) of the normalized images against labels."""
    logits = vit.forward(params, images, cfg)
    loss = cross_entropy(logits, labels)
    valid = labels >= 0
    correct = valid & (logits.argmax(-1) == labels)
    acc = correct.sum() / valid.sum().clamp_min(1)
    return loss, acc


def make_vit_train_step(cfg: vit.ViTConfig, mesh=None) -> Callable:
    """Build ``step(params, optimizer, images, labels) -> (params,
    optimizer, metrics)``.  ``params`` are the leaves the optimizer
    holds; they are updated in place.  The exact max-subtract softmax is
    forced, as in the JAX step: forward and gradient must describe the
    same function."""
    if mesh is not None:
        raise NotImplementedError("sharded training comes with the "
                                  "multi-device port")
    cfg = dataclasses.replace(cfg, safe_softmax=True)

    def step(params: Params, optimizer: torch.optim.Optimizer,
             images: torch.Tensor, labels: torch.Tensor):
        optimizer.zero_grad(set_to_none=True)
        loss, acc = vit_loss(params, images, labels, cfg)
        loss.backward()
        optimizer.step()
        return params, optimizer, {"loss": loss.detach(),
                                   "accuracy": acc.detach()}

    return step


def init_train_state(cfg: vit.ViTConfig, optimizer: OptimizerFactory,
                     seed: int = 0, device=None,
                     params: Optional[Params] = None):
    """(params, optimizer): params from ``vit.init_params`` with ``seed``
    unless given, marked as requiring gradients, and the optimizer built
    over their leaves."""
    if params is None:
        gen = torch.Generator()
        gen.manual_seed(seed)
        params = vit.init_params(cfg, gen, device=device)
    for leaf in param_leaves(params):
        leaf.requires_grad_(True)
    return params, optimizer(param_leaves(params))


def _on(a, device) -> torch.Tensor:
    """An array-like (numpy or tensor) as a tensor on ``device``."""
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a))
    return t.to(device)


class Trainer:
    """Minimal training loop for ViT classification on one device, with
    AdamW (``optax.adamw(learning_rate, weight_decay=weight_decay)``)."""

    def __init__(self, cfg: vit.ViTConfig, learning_rate: float = 3e-4,
                 weight_decay: float = 0.05, mesh=None, seed: int = 0,
                 params: Optional[Params] = None, device=None):
        if mesh is not None:
            raise NotImplementedError("sharded training comes with the "
                                      "multi-device port")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params, self.optimizer = init_train_state(
            cfg, adamw(learning_rate, weight_decay=weight_decay), seed=seed,
            device=self.device, params=params)
        self._step = make_vit_train_step(cfg)
        self.history = []

    def fit(self, batches: Iterable[Tuple[Any, Any]], log_every: int = 0):
        for i, (images, labels) in enumerate(batches):
            images = _on(images, self.device)
            labels = _on(labels, self.device).long()
            self.params, self.optimizer, metrics = self._step(
                self.params, self.optimizer, images, labels)
            self.history.append({k: float(v) for k, v in metrics.items()})
            if log_every and i % log_every == 0:
                m = self.history[-1]
                print(f"step {i}: loss {m['loss']:.4f} "
                      f"acc {m['accuracy']:.3f}")
        return self.history
