"""The port's training step (train/trainer.py, plain K4/K5/K23/K24 on the
CPU) against the JAX package's make_vit_train_step on the CPU, with the
same parameters, images and labels handed over as numpy arrays.

The JAX step on the CPU takes the XLA path of its ``_block`` (two-pass
LayerNorm, biases added in the compute dtype) and autodiff; the port runs
the TPU kernels' arithmetic.  In f32 the two differ by f32 rounding only
(tolerance 2e-4 relative over 3 steps); in bf16 by where each rounds to
bf16 (band 5e-2)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vit_fpga_tpu.models import vit as jvit
from vit_fpga_tpu.train import trainer as jtrain
from vit_fpga_tpu_torch.models import vit as tvit
from vit_fpga_tpu_torch.models.convert import (adamw_state_from_optax,
                                               params_from_numpy,
                                               params_to_numpy)
from vit_fpga_tpu_torch.train import trainer as ttrain

TINY = dict(image_size=32, patch_size=8, hidden_dim=64, depth=2,
            num_heads=2, mlp_dim=128, num_classes=8)
B = 4
# (loss / accuracy, params) tolerance per compute dtype: f32 rounding
# against the bf16 rounding band
TOL = {"float32": 2e-4, "bfloat16": 5e-2}
LR = 1e-3   # AdamW learning rate of the comparisons


def _np_params(jcfg, seed):
    """vit.init_params perturbed by 0.02 * normal noise, so the zero-init
    biases, LN params and CLS token carry signal."""
    rng = np.random.default_rng(seed)
    params = jvit.init_params(jax.random.key(seed), jcfg)
    return jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.02 * rng.normal(size=p.shape).astype(
            np.float32), params)


def _data(seed, n=B, classes=8, s=32):
    rng = np.random.default_rng(seed)
    images = rng.normal(size=(n, s, s, 3)).astype(np.float32)
    labels = rng.integers(0, classes, n).astype(np.int32)
    return images, labels


def _flat(tree):
    leaves = jax.tree_util.tree_leaves_with_path(tree)
    return {jax.tree_util.keystr(k): np.asarray(v, np.float32)
            for k, v in leaves}


KEY_BIAS = "['blocks']['bqkv']"


def _assert_params_close(got_np, want, tol, adam_steps=0, lr=0.0):
    """Every leaf within ``tol`` in relative norm.  The key third of
    ``bqkv`` has a true gradient of 0 (softmax ignores a shift shared by
    all keys), so under Adam each of its updates is lr times the sign of
    rounding noise: it is held to |a - b| <= 2 lr per Adam step instead."""
    g, w = _flat(got_np), _flat(want)
    assert g.keys() == w.keys()
    d = TINY["hidden_dim"]
    for k in w:
        gk, wk = g[k], w[k]
        if k == KEY_BIAS and adam_steps:
            bk = slice(d, 2 * d)
            assert np.abs(gk[:, bk] - wk[:, bk]).max() <= 2 * lr * adam_steps
            gk = np.concatenate([gk[:, :d], gk[:, 2 * d:]], axis=1)
            wk = np.concatenate([wk[:, :d], wk[:, 2 * d:]], axis=1)
        err = np.linalg.norm(gk - wk) / max(np.linalg.norm(wk), 1e-12)
        assert err <= tol, (k, err)


def _run_jax(jcfg, opt, np_params, batches):
    step = jtrain.make_vit_train_step(jcfg, opt, donate=False)
    params = jax.tree_util.tree_map(jnp.asarray, np_params)
    state = opt.init(params)
    hist = []
    for images, labels in batches:
        params, state, m = step(params, state, jnp.asarray(images),
                                jnp.asarray(labels))
        hist.append((float(m["loss"]), float(m["accuracy"])))
    return params, state, hist


def _run_port(tcfg, opt, np_params, batches):
    params, optimizer = ttrain.init_train_state(
        tcfg, opt, params=params_from_numpy(np_params, device="cpu"))
    step = ttrain.make_vit_train_step(tcfg)
    hist = []
    for images, labels in batches:
        params, optimizer, m = step(params, optimizer,
                                    torch.from_numpy(images),
                                    torch.from_numpy(labels).long())
        hist.append((float(m["loss"]), float(m["accuracy"])))
    return params, optimizer, hist


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("opt_name", ["sgd", "adamw"])
def test_train_step_matches_jax(dtype, opt_name):
    """3 steps on 3 batches: loss and accuracy of each, params after."""
    kw = dict(TINY, dtype=dtype)
    jcfg, tcfg = jvit.ViTConfig(**kw), tvit.ViTConfig(**kw)
    np_params = _np_params(jcfg, 0)
    batches = [_data(10 + i) for i in range(3)]
    adam_steps = 0 if opt_name == "sgd" else len(batches)
    if opt_name == "sgd":
        jopt, topt = optax.sgd(0.1), ttrain.sgd(0.1)
    else:
        jopt, topt = (optax.adamw(LR, weight_decay=0.05),
                      ttrain.adamw(LR, weight_decay=0.05))
    jparams, _, jhist = _run_jax(jcfg, jopt, np_params, batches)
    tparams, _, thist = _run_port(tcfg, topt, np_params, batches)
    tol = TOL[dtype]
    for (jl, ja), (tl, ta) in zip(jhist, thist):
        assert abs(tl - jl) <= tol * max(abs(jl), 1.0), (thist, jhist)
        assert ta == pytest.approx(ja, abs=1.0 / B + 1e-6)
    _assert_params_close(params_to_numpy(tparams), jparams, tol, adam_steps,
                         LR)


def test_negative_labels_contribute_no_loss():
    logits = torch.tensor([[2.0, 0.5, -1.0], [0.1, 0.2, 0.3],
                           [1.0, 1.0, 1.0]])
    labels = torch.tensor([0, -1, -7])
    want = float(torch.nn.functional.cross_entropy(logits[:1], labels[:1]))
    assert float(ttrain.cross_entropy(logits, labels)) == pytest.approx(
        want, rel=1e-6)
    jl = float(jtrain.cross_entropy(jnp.asarray(logits.numpy()),
                                    jnp.asarray(labels.numpy())))
    assert jl == pytest.approx(want, rel=1e-6)
    # all labels negative: zero loss, not a division by zero
    assert float(ttrain.cross_entropy(logits, -torch.ones(3).long())) == 0.0
    # a negative-label row changes nothing in the full step's loss
    kw = dict(TINY, dtype="float32")
    tcfg = tvit.ViTConfig(**kw)
    np_params = _np_params(jvit.ViTConfig(**kw), 1)
    images, labels = _data(3)
    params = params_from_numpy(np_params, device="cpu")
    full, _ = ttrain.vit_loss(params, torch.from_numpy(images),
                              torch.from_numpy(labels).long(), tcfg)
    masked = torch.from_numpy(labels).long().clone()
    masked[-1] = -1
    with_pad, acc = ttrain.vit_loss(params, torch.from_numpy(images),
                                    masked, tcfg)
    part, _ = ttrain.vit_loss(params, torch.from_numpy(images[:-1]),
                              torch.from_numpy(labels[:-1]).long(), tcfg)
    assert float(with_pad) == pytest.approx(float(part), rel=1e-5)
    assert float(with_pad) != pytest.approx(float(full), rel=1e-5)
    assert 0.0 <= float(acc) <= 1.0


def test_trainer_fit_history_matches_jax():
    """Trainer (AdamW lr 3e-4, decay 0.05 on every parameter) over 3
    batches, from the JAX Trainer's own initial params, f32."""
    cfg_kw = dict(TINY, dtype="float32")
    jt = jtrain.Trainer(jvit.ViTConfig(**cfg_kw), seed=0)
    np_params = jax.tree_util.tree_map(np.asarray, jt.params)
    tt = ttrain.Trainer(tvit.ViTConfig(**cfg_kw),
                        params=params_from_numpy(np_params, device="cpu"),
                        device="cpu")
    batches = [_data(20 + i) for i in range(3)]
    jh = jt.fit(batches)
    th = tt.fit(batches)
    assert len(th) == 3 and set(th[0]) == {"loss", "accuracy"}
    for a, b in zip(th, jh):
        assert a["loss"] == pytest.approx(b["loss"], rel=2e-4)
        assert a["accuracy"] == pytest.approx(b["accuracy"], abs=1e-6)
    _assert_params_close(params_to_numpy(tt.params), jt.params, 2e-4, 3,
                         3e-4)
    with pytest.raises(NotImplementedError):
        ttrain.Trainer(tvit.ViTConfig(**cfg_kw), mesh=object(),
                       device="cpu")


def test_adamw_resume_from_optax_state():
    """2 JAX AdamW steps, then params and (mu, nu, count) carried across:
    step 3 agrees in both, f32."""
    kw = dict(TINY, dtype="float32")
    jcfg, tcfg = jvit.ViTConfig(**kw), tvit.ViTConfig(**kw)
    np_params = _np_params(jcfg, 2)
    batches = [_data(30 + i) for i in range(3)]
    jopt = optax.adamw(LR, weight_decay=0.05)
    jparams, jstate, _ = _run_jax(jcfg, jopt, np_params, batches[:2])
    adam = jstate[0]
    assert int(adam.count) == 2
    params, optimizer = ttrain.init_train_state(
        tcfg, ttrain.adamw(LR, weight_decay=0.05),
        params=params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                 device="cpu"))
    adamw_state_from_optax(jax.tree_util.tree_map(np.asarray, adam.mu),
                           jax.tree_util.tree_map(np.asarray, adam.nu),
                           int(adam.count), params, optimizer)
    step = ttrain.make_vit_train_step(tcfg)
    images, labels = batches[2]
    params, optimizer, m = step(params, optimizer, torch.from_numpy(images),
                                torch.from_numpy(labels).long())
    jstep = jtrain.make_vit_train_step(jcfg, jopt, donate=False)
    jparams, _, jm = jstep(jparams, jstate, jnp.asarray(images),
                           jnp.asarray(labels))
    assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=2e-4)
    _assert_params_close(params_to_numpy(params), jparams, 2e-4, 3, LR)


def test_params_numpy_round_trip():
    np_params = _np_params(jvit.ViTConfig(**TINY), 3)
    back = params_to_numpy(params_from_numpy(np_params, device="cpu"))
    for k, v in _flat(np_params).items():
        np.testing.assert_array_equal(_flat(back)[k], v)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_safe_softmax_forward_matches_jax(dtype):
    """make_forward with safe_softmax (the per-block K4/K5 path) against
    the JAX forward with safe_softmax on the CPU."""
    kw = dict(TINY, dtype=dtype, safe_softmax=True)
    jcfg, tcfg = jvit.ViTConfig(**kw), tvit.ViTConfig(**kw)
    np_params = _np_params(jcfg, 4)
    images = np.random.default_rng(5).integers(0, 256, (3, 32, 32, 3),
                                               np.uint8)
    want = np.asarray(jvit.forward_raw(
        jax.tree_util.tree_map(jnp.asarray, np_params),
        jnp.asarray(images), jcfg))
    fwd = tvit.make_forward(tcfg, params_from_numpy(np_params, device="cpu"),
                            device="cpu")
    got = fwd(images).numpy()
    band = 1e-4 if dtype == "float32" else 5e-2
    assert np.abs(got - want).max() <= band * np.abs(want).max()


def test_remat_gives_the_same_gradients():
    """cfg.remat checkpoints each block: the same loss and gradients."""
    kw = dict(TINY, dtype="float32", safe_softmax=True)
    np_params = _np_params(jvit.ViTConfig(**kw), 6)
    images, labels = _data(7)
    grads = []
    for remat in (False, True):
        cfg = tvit.ViTConfig(**kw, remat=remat)
        params, _ = ttrain.init_train_state(
            cfg, ttrain.sgd(0.0), params=params_from_numpy(np_params,
                                                           device="cpu"))
        loss, _ = ttrain.vit_loss(params, torch.from_numpy(images),
                                  torch.from_numpy(labels).long(), cfg)
        loss.backward()
        grads.append([p.grad.clone() for p in ttrain.param_leaves(params)])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_stats_chain_refuses_gradients():
    """The chain no longer refuses a gradient: the default config's loss
    differentiates through its VJP (models/vit.StatsChainFunction), and in
    f32 the gradient agrees with the safe_softmax per-block route's
    (plain K4 / K23, K5 / K24), the same function inside the max-free
    window, to f32 rounding (2e-4 in relative norm)."""
    kw = dict(TINY, dtype="float32")
    grads = {}
    for safe in (False, True):
        cfg = tvit.ViTConfig(**kw, safe_softmax=safe)
        assert tvit._stats_chain_supported(cfg, B) is not safe
        params, _ = ttrain.init_train_state(
            cfg, ttrain.sgd(0.1),
            params=params_from_numpy(_np_params(jvit.ViTConfig(**kw), 8),
                                     device="cpu"))
        images, labels = _data(9)
        loss, _ = ttrain.vit_loss(params, torch.from_numpy(images),
                                  torch.from_numpy(labels).long(), cfg)
        loss.backward()
        grads[safe] = [p.grad.numpy() for p in ttrain.param_leaves(params)]
    for a, b in zip(grads[False], grads[True]):
        assert np.linalg.norm(a - b) <= 2e-4 * max(np.linalg.norm(b), 1e-12)
