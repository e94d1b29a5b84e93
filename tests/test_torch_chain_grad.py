"""The stats chain's backward (models/vit.StatsChainFunction) against the
JAX package's custom VJP: ``jax.vjp`` of its ``_encoder_chain_xla`` on
the same numpy-seeded blocks, tokens and cotangent.

The port's forward runs the chain's kernels (their plain versions on the
CPU: one-pass LayerNorm stats, the max-free softmax); the backward is
autograd of the port's ``_encoder_chain_xla``.  The activations agree
between the packages for bf16 "gelu" (tanh-GELU in both) and for f32
"gelu_tanh" and "quick_gelu"; f32 "gelu" is the known divergence (erf in
the port, tanh in the JAX chain).  Tolerances, in relative norm per
gradient: f32 rounding (2e-4) in f32; in bf16 both recompute the same
function with the same bf16 rounding points, and only the f32 sums'
order differs, which flips an occasional bf16 ulp (2e-2)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_fpga_tpu.models import vit as jvit
from vit_fpga_tpu.train import trainer as jtrain
from vit_fpga_tpu_torch.models import vit as tvit
from vit_fpga_tpu_torch.models.convert import params_from_numpy
from vit_fpga_tpu_torch.train import trainer as ttrain

TINY = dict(image_size=32, patch_size=8, hidden_dim=64, depth=2,
            num_heads=2, mlp_dim=128, num_classes=8)
N_PAD, N_VALID, B = 24, 17, 2
TOL = {"float32": 2e-4, "bfloat16": 2e-2}


def _blocks(seed, depth=2, d=64, m=128):
    rng = np.random.default_rng(seed)

    def w(*shape, std=0.1):
        return (rng.normal(size=shape) * std).astype(np.float32)

    return {"ln1_scale": 1.0 + w(depth, d), "ln1_bias": w(depth, d),
            "wqkv": w(depth, d, 3 * d), "bqkv": w(depth, 3 * d),
            "wo": w(depth, d, d), "bo": w(depth, d),
            "ln2_scale": 1.0 + w(depth, d), "ln2_bias": w(depth, d),
            "w1": w(depth, d, m), "b1": w(depth, m),
            "w2": w(depth, m, d), "b2": w(depth, d)}


def _relnorm(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


@pytest.mark.parametrize("dtype,act", [("bfloat16", "gelu"),
                                       ("float32", "gelu_tanh"),
                                       ("float32", "quick_gelu")])
def test_chain_vjp_matches_jax(dtype, act):
    kw = dict(TINY, dtype=dtype, hidden_act=act)
    jcfg, tcfg = jvit.ViTConfig(**kw), tvit.ViTConfig(**kw)
    assert tvit._stats_chain_supported(tcfg, B)
    blocks = _blocks(1)
    rng = np.random.default_rng(2)
    x = (rng.normal(size=(B, N_PAD, 64)) * 0.5).astype(np.float32)
    g = rng.normal(size=(B, N_PAD, 64)).astype(np.float32)
    g[:, N_VALID:] = 0.0          # the padding rows carry no cotangent
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jx = jnp.asarray(x).astype(jdt)
    jb, jdx = jax.jit(lambda bl, xx, gg: jax.vjp(
        lambda b_, x_: jvit._encoder_chain_xla(b_, x_, jcfg, N_VALID),
        bl, xx)[1](gg))(jax.tree_util.tree_map(jnp.asarray, blocks), jx,
                        jnp.asarray(g).astype(jdt))

    tb = params_from_numpy(blocks, device="cpu")
    for v in tb.values():
        v.requires_grad_(True)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        tcfg.compute_dtype).requires_grad_(True)
    out = tvit._encoder_stats_chain(tb, tx, tcfg, N_VALID)
    assert out.grad_fn is not None
    assert type(out.grad_fn).__name__ == "StatsChainFunctionBackward"
    out.backward(torch.from_numpy(g).to(out.dtype))
    tol = TOL[dtype]
    assert tx.grad.dtype == tcfg.compute_dtype
    err = _relnorm(tx.grad.float().numpy()[:, :N_VALID],
                   np.asarray(jdx.astype(jnp.float32))[:, :N_VALID])
    assert err <= tol, ("dx", err)
    for k, v in tb.items():
        assert v.grad is not None and v.grad.shape == v.shape, k
        err = _relnorm(v.grad.numpy(), np.asarray(jb[k], np.float32))
        assert err <= tol, (k, err)


def test_no_grad_output_unchanged():
    """The chain's output is the same tensor, bit for bit, with and
    without a gradient wanted, and equal to the kernels' run itself."""
    tcfg = tvit.ViTConfig(**dict(TINY, dtype="bfloat16"))
    tb = params_from_numpy(_blocks(3), device="cpu")
    x = torch.from_numpy((np.random.default_rng(4).normal(
        size=(B, N_PAD, 64)) * 0.5).astype(np.float32)).to(torch.bfloat16)
    with torch.no_grad():
        quiet = tvit._encoder_stats_chain(tb, x, tcfg, N_VALID)
    with torch.inference_mode():
        served = tvit._encoder_stats_chain(tb, x, tcfg, N_VALID)
    for v in tb.values():
        v.requires_grad_(True)
    loud = tvit._encoder_stats_chain(tb, x.clone().requires_grad_(True),
                                     tcfg, N_VALID)
    direct = tvit._stats_chain_run({k: v.detach() for k, v in tb.items()},
                                   x, tcfg, N_VALID)
    for t in (served, loud.detach(), direct):
        assert torch.equal(t, quiet)


def test_safe_softmax_keeps_the_per_block_route(monkeypatch):
    """A safe_softmax config trains through the per-block encoder: the
    chain's kernels never run, and every parameter gets its gradient."""
    cfg = tvit.ViTConfig(**dict(TINY, dtype="float32", safe_softmax=True))
    assert not tvit._stats_chain_supported(cfg, B)

    def refuse(*a, **k):
        raise AssertionError("the stats chain ran under safe_softmax")

    monkeypatch.setattr(tvit, "_stats_chain_run", refuse)
    params, _ = ttrain.init_train_state(cfg, ttrain.sgd(0.1), device="cpu")
    images = torch.from_numpy(np.random.default_rng(5).normal(
        size=(B, 32, 32, 3)).astype(np.float32))
    loss, _ = ttrain.vit_loss(params, images, torch.tensor([1, 2]), cfg)
    loss.backward()
    assert all(p.grad is not None for p in ttrain.param_leaves(params))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_default_config_loss_gradient_matches_jax(dtype):
    """The whole model's default-config gradient (chain forward, the
    chain's VJP, the embed and head by autograd) against
    ``jax.value_and_grad`` of the JAX ``vit_loss`` with the same config.
    The JAX CPU forward takes its per-block XLA path, the same function."""
    kw = dict(TINY, dtype=dtype, hidden_act="gelu_tanh")
    jcfg, tcfg = jvit.ViTConfig(**kw), tvit.ViTConfig(**kw)
    rng = np.random.default_rng(6)
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.02 * rng.normal(size=p.shape).astype(
            np.float32), jvit.init_params(jax.random.key(6), jcfg))
    images = rng.normal(size=(B, 32, 32, 3)).astype(np.float32)
    labels = np.array([1, 5], np.int32)
    (jloss, _), jg = jax.jit(jax.value_and_grad(
        lambda p: jtrain.vit_loss(p, jnp.asarray(images),
                                  jnp.asarray(labels), jcfg),
        has_aux=True))(params)
    tp, _ = ttrain.init_train_state(tcfg, ttrain.sgd(0.1),
                                    params=params_from_numpy(params,
                                                             device="cpu"))
    loss, _ = ttrain.vit_loss(tp, torch.from_numpy(images),
                              torch.from_numpy(labels).long(), tcfg)
    loss.backward()
    tol = {"float32": 2e-4, "bfloat16": 5e-2}[dtype]
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=tol)
    jflat = {jax.tree_util.keystr(p): np.asarray(v)
             for p, v in jax.tree_util.tree_leaves_with_path(jg)}

    def walk(tree, prefix=""):
        for k, v in tree.items():
            key = f"{prefix}['{k}']"
            if isinstance(v, dict):
                yield from walk(v, key)
            else:
                yield key, v

    seen = 0
    for key, leaf in walk(tp):
        err = _relnorm(leaf.grad.numpy(), jflat[key])
        assert err <= tol, (key, err)
        seen += 1
    assert seen == len(jflat)


def test_recompute_is_the_exact_softmax_function():
    """Past the max-free window the forward and the recompute differ, as
    in the JAX package: hot scores make the chain's forward (clip at 80)
    and ``_encoder_chain_xla`` disagree, which is why the Trainer forces
    safe_softmax."""
    tcfg = tvit.ViTConfig(**dict(TINY, dtype="float32",
                                 hidden_act="gelu_tanh"))
    blocks = _blocks(7)
    blocks["wqkv"] = blocks["wqkv"] * 60.0
    tb = params_from_numpy(blocks, device="cpu")
    x = torch.from_numpy((np.random.default_rng(8).normal(
        size=(B, N_PAD, 64))).astype(np.float32))
    fast = tvit._stats_chain_run(tb, x, tcfg, N_VALID)
    exact = tvit._encoder_chain_xla(tb, x, tcfg, N_VALID)
    assert not torch.allclose(fast[:, :N_VALID], exact[:, :N_VALID],
                              rtol=1e-3, atol=1e-3)
    cold = dataclasses.replace(tcfg)
    tb = params_from_numpy(_blocks(7), device="cpu")
    np.testing.assert_allclose(
        tvit._stats_chain_run(tb, x, cold, N_VALID)[:, :N_VALID].numpy(),
        tvit._encoder_chain_xla(tb, x, cold, N_VALID)[:, :N_VALID].numpy(),
        rtol=1e-4, atol=1e-4)
