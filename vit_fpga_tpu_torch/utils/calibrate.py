"""Calibration of a checkpoint (the port's copy of the JAX package's
utils/calibrate.py).

Two measurements on a calibration batch, each in plain PyTorch ops with
the JAX probe's rounding points (the unfused embed: patchify, ``@ kernel``
and ``+ bias`` in the compute dtype, the CLS row, ``+ pos``; the two-pass
LayerNorm; bf16 qkv; the exact softmax of ``ops/attention.mha_qkv_xla``;
true f32 matmuls in f32 mode):

* the attention-score range, which routes a hot checkpoint to the exact
  max-subtract softmax (``calibrated_config``);
* per-layer absmax of the quantized activations, the static scales that
  ``models/quantized.quantize_vit_static`` folds into the kernels'
  arguments (``static_activation_scales``).

Usage (after importing a checkpoint, before serving it):

    cfg = calibrate.calibrated_config(params, cfg)          # synthetic batch
    cfg = calibrate.calibrated_config(params, cfg, images)  # real batch

The probe runs on the device the parameters live on.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..ops.attention import mha_qkv_xla

_log = logging.getLogger("vit_fpga_tpu_torch.calibrate")

# the max-free softmax window of ops/attn_block.py; the margin guards the
# calibration batch's coverage (real inputs can run hotter than the probe)
_EXP_LO, _EXP_HI = -70.0, 80.0
DEFAULT_MARGIN = 2.0

STAT_KEYS = ("a_x1", "a_q", "a_k", "a_v", "a_ao", "a_x2", "a_h")


class CalibrationResult(NamedTuple):
    score_max: float         # max score over layers/heads/valid positions
    score_min: float
    per_layer_max: np.ndarray
    safe: bool               # True -> route to max-subtract softmax

    @property
    def mode(self) -> str:
        return "safe" if self.safe else "maxfree"


def _probe_act(cfg) -> str:
    if cfg.hidden_act == "gelu" and cfg.compute_dtype == torch.bfloat16:
        return "gelu_tanh"
    return cfg.hidden_act


def _embed(params, images: torch.Tensor, cfg) -> torch.Tensor:
    """The probe's unfused embed in the compute dtype (B, N, D)."""
    from ..models import vit
    dt = cfg.compute_dtype
    dev = params["pos_embed"].device
    x = vit.patchify(images.to(dev, dt), cfg.patch_size)
    x = (x.float() @ params["patch_embed"]["kernel"].to(dt).float()).to(dt)
    x = x + params["patch_embed"]["bias"].to(dt)
    b, d = x.shape[0], cfg.hidden_dim
    cls = params["cls_token"].to(dt).expand(b, cfg.num_prefix_tokens, d)
    x = torch.cat([cls, x], dim=1)
    x = x + params["pos_embed"].to(dt)
    if "ln_pre_scale" in params:      # CLIP layout: ln_pre before the blocks
        x = _ln(x, params["ln_pre_scale"], params["ln_pre_bias"],
                cfg.ln_eps).to(dt)
    return x


def _ln(x, s, b, eps):
    """Two-pass f32 LayerNorm (``jnp.var``), f32 out."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, unbiased=False, keepdim=True)
    return (xf - mu) * torch.rsqrt(var + eps) * s.float() + b.float()


def _dot(a, w, dt):
    """``jnp.dot(a.astype(dt), w.astype(dt), preferred_element_type=f32)``."""
    return a.to(dt).float() @ w.to(dt).float()


def attn_score_stats(params: Dict[str, Any], images: torch.Tensor, cfg
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-layer (max, min) attention scores over the batch, exact
    reference math.  ``images`` are normalized model inputs (B, S, S, 3)."""
    from ..models import vit
    from ..ops.attn_block import attn_block_xla
    from ..ops.fused_mlp import fused_mlp_xla

    dt = cfg.compute_dtype
    d, nh = cfg.hidden_dim, cfg.num_heads
    dh = d // nh
    scale = 1.0 / (dh ** 0.5)
    act = _probe_act(cfg)
    with torch.no_grad(), vit._precision_ctx(cfg):
        x = _embed(params, images, cfg)
        b, n = x.shape[:2]
        maxs, mins = [], []
        for i in range(cfg.depth):
            blk = {k: v[i] for k, v in params["blocks"].items()}
            xn = _ln(x, blk["ln1_scale"], blk["ln1_bias"], cfg.ln_eps).to(dt)
            qkv = _dot(xn, blk["wqkv"], dt) + blk["bqkv"].float()
            q = qkv[..., :d].reshape(b, n, nh, dh)
            k = qkv[..., d:2 * d].reshape(b, n, nh, dh)
            s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
            maxs.append(s.max())
            mins.append(s.min())
            # advance x with the exact reference block
            x = attn_block_xla(x, blk["ln1_scale"], blk["ln1_bias"],
                               blk["wqkv"], blk["bqkv"], blk["wo"],
                               blk["bo"], nh, cfg.ln_eps)
            t = fused_mlp_xla(x.reshape(b * n, d), blk["ln2_scale"],
                              blk["ln2_bias"], blk["w1"], blk["b1"],
                              blk["w2"], blk["b2"], eps=cfg.ln_eps, act=act)
            x = t.reshape(b, n, d)
        return (torch.stack(maxs).cpu().numpy(),
                torch.stack(mins).cpu().numpy())


def _synthetic_batch(cfg, batch: int = 4, seed: int = 0) -> torch.Tensor:
    """Deterministic probe batch in the normalized-input domain, at
    several amplitudes so score growth with input energy is sampled (the
    JAX package's numbers, bit for bit; on the CPU)."""
    rng = np.random.default_rng(seed)
    s = cfg.image_size
    x = rng.normal(size=(batch, s, s, 3)).astype(np.float32)
    scales = np.asarray([0.5, 1.0, 1.5, 2.0][:batch],
                        np.float32).reshape(-1, 1, 1, 1)
    return torch.from_numpy(x * scales)


def choose_softmax_mode(params: Dict[str, Any], cfg,
                        images: Optional[torch.Tensor] = None,
                        margin: float = DEFAULT_MARGIN
                        ) -> CalibrationResult:
    """Measure the checkpoint's attention-score range and decide between
    the max-free fast path and the exact max-subtract path."""
    if images is None:
        images = _synthetic_batch(cfg)
    maxs, mins = attn_score_stats(params, images, cfg)
    smax, smin = float(maxs.max()), float(mins.min())
    safe = not (smax * margin <= _EXP_HI and smin * margin >= _EXP_LO)
    res = CalibrationResult(smax, smin, maxs, safe)
    _log.info(
        "softmax calibration: score range [%.1f, %.1f] (margin %.1fx, "
        "window [%.0f, %.0f]) -> %s path", smin, smax, margin,
        _EXP_LO, _EXP_HI, res.mode)
    return res


def calibrated_config(params: Dict[str, Any], cfg,
                      images: Optional[torch.Tensor] = None,
                      margin: float = DEFAULT_MARGIN):
    """Return ``cfg`` with ``safe_softmax`` set from a calibration run."""
    res = choose_softmax_mode(params, cfg, images, margin)
    return dataclasses.replace(cfg, safe_softmax=res.safe)


# ---------------------------------------------------------------------------
# Static-scale int8 calibration: per-tensor-per-layer activation absmax for
# the calibrated fixed-point datapath (models/quantized.quantize_vit_static
# folds these into the kernel arguments).
# ---------------------------------------------------------------------------

def _act_f(h, act: str):
    from ..ops.quant_fused import _gelu_tanh_textbook
    if act in ("gelu", "gelu_tanh"):
        return _gelu_tanh_textbook(h)       # jax.nn.gelu(approximate=True)
    if act == "quick_gelu":
        return h * torch.sigmoid(1.702 * h)
    if act == "relu":
        return torch.clamp_min(h, 0.0)
    raise ValueError(act)


def layer_absmax_stats(blocks: Dict[str, torch.Tensor], x: torch.Tensor,
                       num_heads: int, eps: float, act: str,
                       dt: torch.dtype) -> Dict[str, np.ndarray]:
    """The per-layer half of :func:`activation_absmax_stats`: the stacked
    f32 ``blocks`` run on embedded tokens ``x`` (B, N, D) in ``dt``; per
    key a (depth,) f32 array of absmax values."""
    d = x.shape[-1]
    stats = {k: [] for k in STAT_KEYS}

    def absmax(key, t):
        stats[key].append(t.abs().max())

    with torch.no_grad():
        for i in range(blocks["wqkv"].shape[0]):
            blk = {k: v[i] for k, v in blocks.items()}
            xn1 = _ln(x, blk["ln1_scale"], blk["ln1_bias"], eps)
            absmax("a_x1", xn1)
            qkv = (_dot(xn1, blk["wqkv"], dt) + blk["bqkv"].float()).to(dt)
            qf = qkv.float()
            absmax("a_q", qf[..., :d])
            absmax("a_k", qf[..., d:2 * d])
            absmax("a_v", qf[..., 2 * d:])
            o = mha_qkv_xla(qkv, num_heads).float()
            absmax("a_ao", o)
            x = x + (_dot(o, blk["wo"], dt) + blk["bo"].float()).to(dt)
            xn2 = _ln(x, blk["ln2_scale"], blk["ln2_bias"], eps)
            absmax("a_x2", xn2)
            h = _act_f(_dot(xn2, blk["w1"], dt) + blk["b1"].float(), act)
            absmax("a_h", h)
            x = x + (_dot(h, blk["w2"], dt) + blk["b2"].float()).to(dt)
        return {k: torch.stack(v).float().cpu().numpy()
                for k, v in stats.items()}


def activation_absmax_stats(params: Dict[str, Any], images: torch.Tensor,
                            cfg) -> Dict[str, np.ndarray]:
    """Per-layer absmax of the quantized activations over the calibration
    batch, exact reference math:

      a_x1  post-LN1 tokens  (QKV projection input)
      a_q   query activations (int8 score GEMM input)
      a_k   key activations   (int8 score GEMM input)
      a_v   value activations (int8 PV GEMM input)
      a_ao  attention output (out-projection input)
      a_x2  post-LN2 tokens  (MLP up-projection input)
      a_h   post-activation MLP hidden (down-projection input)

    ``images`` are normalized model inputs (B, S, S, 3); for CLIP-layout
    params the ln_pre stage is applied first."""
    from ..models import vit
    with torch.no_grad(), vit._precision_ctx(cfg):
        x = _embed(params, images, cfg)
        return layer_absmax_stats(params["blocks"], x, cfg.num_heads,
                                  cfg.ln_eps, _probe_act(cfg),
                                  cfg.compute_dtype)


def static_activation_scales(params: Dict[str, Any], cfg,
                             images: Optional[torch.Tensor] = None,
                             margin: float = 1.0
                             ) -> Dict[str, np.ndarray]:
    """Calibrated per-layer activation quant scales a = absmax * margin
    (each quantized tensor maps [-a, a] onto [-127, 127]; values beyond
    a saturate).  ``margin > 1`` trades resolution for headroom."""
    if images is None:
        images = _synthetic_batch(cfg)
    stats = activation_absmax_stats(params, images, cfg)
    return {k: np.maximum(v * margin, 1e-12) for k, v in stats.items()}
