"""CLIP's contrastive training in the port (models/clip.contrastive_loss,
make_clip_train_step) against the JAX package's, on the CPU.

The vision tower keeps the default config (no safe_softmax), as the JAX
step does, so the port's step differentiates the stats chain through its
VJP (models/vit.StatsChainFunction); the text tower is plain torch.  The
JAX reference is ``jax.value_and_grad`` of the JAX step's loss (the
vision forward, ``text_forward``, ``contrastive_loss``) on the same
numpy-seeded params.  f32 with quick-GELU: the two agree to f32 rounding
(loss 1e-5, each gradient 2e-4 in relative norm)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_fpga_tpu.models import clip as jclip
from vit_fpga_tpu_torch.models import clip as tclip
from vit_fpga_tpu_torch.models import vit as tvit
from vit_fpga_tpu_torch.models.convert import params_from_numpy
from vit_fpga_tpu_torch.train import trainer as ttrain

B = 4
VIS = dict(image_size=32, patch_size=8, hidden_dim=64, depth=2, num_heads=4,
           mlp_dim=128, dtype="float32", hidden_act="quick_gelu",
           ln_eps=1e-5, num_classes=0)
TXT = dict(vocab_size=99, hidden_dim=32, depth=1, num_heads=4, mlp_dim=64,
           max_positions=16, projection_dim=24)


def _relnorm(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _setup(seed=0):
    from vit_fpga_tpu.models import vit as jvit
    jv = jvit.ViTConfig(**VIS, mean=jvit.CLIP_MEAN, std=jvit.CLIP_STD)
    jt = jclip.CLIPTextConfig(**TXT)
    tv = tvit.ViTConfig(**VIS, mean=tvit.CLIP_MEAN, std=tvit.CLIP_STD)
    tt = tclip.CLIPTextConfig(**TXT)
    rng = np.random.default_rng(seed)

    def noisy(p):
        return np.asarray(p) + 0.02 * rng.normal(size=np.shape(p)).astype(
            np.float32)

    params = {
        "vision": jax.tree_util.tree_map(noisy, jclip.init_params(
            jax.random.key(seed), jv, projection_dim=24)),
        "text": jax.tree_util.tree_map(noisy, jclip.init_text_params(
            jax.random.key(seed + 1), jt)),
        "logit_scale": np.float32(np.log(1 / 0.07)),
    }
    images = rng.normal(size=(B, 32, 32, 3)).astype(np.float32)
    ids = rng.integers(1, 90, (B, 9)).astype(np.int32)
    ids[np.arange(B), rng.integers(2, 9, B)] = 98       # EOT, the max id
    return jv, jt, tv, tt, params, images, ids


def _jax_loss(jv, jt):
    def loss_fn(p, images, ids):
        ie = jclip.forward(p["vision"], images, jv)
        te = jclip.text_forward(p["text"], ids, jt)
        return jclip.contrastive_loss(ie, te, p["logit_scale"])
    return loss_fn


def test_contrastive_loss_matches_jax():
    rng = np.random.default_rng(1)
    ie = rng.normal(size=(6, 24)).astype(np.float32)
    te = rng.normal(size=(6, 24)).astype(np.float32)
    scale = np.float32(2.3)
    want = float(jclip.contrastive_loss(jnp.asarray(ie), jnp.asarray(te),
                                        jnp.asarray(scale)))
    got = tclip.contrastive_loss(torch.from_numpy(ie), torch.from_numpy(te),
                                 torch.tensor(scale))
    assert float(got) == pytest.approx(want, rel=1e-6)
    # aligned pairs at a high temperature: the loss goes to zero
    low = tclip.contrastive_loss(torch.eye(4), torch.eye(4),
                                 torch.tensor(5.0))
    assert float(low) < 1e-3


def test_clip_step_loss_and_gradients_match_jax():
    jv, jt, tv, tt, params, images, ids = _setup()
    loss_fn = _jax_loss(jv, jt)
    jloss, jg = jax.jit(jax.value_and_grad(loss_fn))(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(images),
        jnp.asarray(ids))
    tp = params_from_numpy(params, device="cpu")
    assert tvit._stats_chain_supported(tv, B)
    step = tclip.make_clip_train_step(tv, tt, ttrain.sgd(0.0))
    tp, opt, loss = step(tp, None, torch.from_numpy(images),
                         torch.from_numpy(ids))
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    jflat = {jax.tree_util.keystr(p): np.asarray(v)
             for p, v in jax.tree_util.tree_leaves_with_path(jg)}

    def walk(tree, prefix=""):
        for k, v in tree.items():
            key = f"{prefix}['{k}']"
            if isinstance(v, dict):
                yield from walk(v, key)
            else:
                yield key, v

    leaves = dict(walk(tp))
    assert leaves.keys() == jflat.keys()
    for key, leaf in leaves.items():
        err = _relnorm(leaf.grad.numpy(), jflat[key])
        assert err <= 2e-4, (key, err)


def test_clip_steps_follow_jax_sgd():
    """Two SGD steps (lr 0.05): the port's losses follow the JAX step's
    (optax.sgd), and the vision encoder's grad_fn is the chain's VJP."""
    import optax
    jv, jt, tv, tt, params, images, ids = _setup(2)
    jstep = jclip.make_clip_train_step(jv, jt, optax.sgd(0.05))
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jo = optax.sgd(0.05).init(jp)
    tp = params_from_numpy(params, device="cpu")
    step = tclip.make_clip_train_step(tv, tt, ttrain.sgd(0.05))
    opt = None
    for _ in range(2):
        jp, jo, jl = jstep(jp, jo, jnp.asarray(images), jnp.asarray(ids))
        tp, opt, tl = step(tp, opt, torch.from_numpy(images),
                           torch.from_numpy(ids))
        assert float(tl) == pytest.approx(float(jl), rel=1e-4)
    emb = tclip.forward(tp["vision"], torch.from_numpy(images), tv)
    seen, todo = set(), [emb.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is not None and fn not in seen:
            seen.add(fn)
            todo.extend(f for f, _ in fn.next_functions)
    assert "StatsChainFunctionBackward" in {type(f).__name__ for f in seen}
