"""The port's ViT forward (models/vit.py, plain versions on the CPU)
against the JAX package's forward on the CPU, with the same parameters
handed over through params_from_numpy."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_fpga_tpu.models import vit as jvit
from vit_fpga_tpu.ops.patch_embed import embed_tokens_dotg as jax_embed
from vit_fpga_tpu_torch.models import vit as tvit
from vit_fpga_tpu_torch.models.convert import params_from_numpy
from vit_fpga_tpu_torch.ops.patch_embed import embed_tokens_dotg

TINY = dict(image_size=32, patch_size=8, hidden_dim=64, depth=2,
            num_heads=2, mlp_dim=128, num_classes=8)


def _perturbed_params(jcfg, seed):
    """vit.init_params perturbed by 0.02 * normal noise, so the zero-init
    biases, LN params and CLS token carry signal (test_stats_chain.py)."""
    rng = np.random.default_rng(seed)
    params = jvit.init_params(jax.random.key(0), jcfg)
    return jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.02 * rng.normal(size=p.shape).astype(
            np.float32), params)


def _pair(seed, jax_only=None, **kw):
    jcfg = jvit.ViTConfig(**kw, **(jax_only or {}))
    tcfg = tvit.ViTConfig(**kw)
    np_params = _perturbed_params(jcfg, seed)
    jparams = jax.tree_util.tree_map(jnp.asarray, np_params)
    return jcfg, tcfg, jparams, params_from_numpy(np_params, device="cpu")


def _images(seed, b, s):
    return np.random.default_rng(seed).integers(0, 256, (b, s, s, 3),
                                                np.uint8)


def test_patchify_and_embed_match_jax():
    """Exact layout (patchify) and the dotg embed GEMM in f32 (~1e-5)."""
    rng = np.random.default_rng(0)
    b, s, p, d, npre = 2, 32, 8, 64, 1
    img = rng.normal(size=(b, s, s, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        tvit.patchify(torch.from_numpy(img), p).numpy(),
        np.asarray(jvit.patchify(jnp.asarray(img), p)))
    kernel = (rng.normal(size=(p * p * 3, d)) * 0.05).astype(np.float32)
    n = (s // p) ** 2 + npre
    posb = rng.normal(size=(n + 3, d)).astype(np.float32)   # 3 tail rows
    posb[n:] = 0.0
    for prefix_last in (False, True):
        want = jax_embed(jnp.asarray(img), jnp.asarray(kernel),
                         jnp.asarray(posb), p, npre,
                         prefix_last=prefix_last)
        got = embed_tokens_dotg(torch.from_numpy(img),
                                torch.from_numpy(kernel),
                                torch.from_numpy(posb), p, npre,
                                prefix_last=prefix_last)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)


def test_preprocess_matches_jax_and_rejects_other_sizes():
    jcfg, tcfg, _, _ = _pair(0, dtype="float32", **TINY)
    img = _images(1, 2, 32)
    np.testing.assert_allclose(
        tvit.preprocess(torch.from_numpy(img), tcfg).numpy(),
        np.asarray(jvit.preprocess(jnp.asarray(img), jcfg)),
        rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError):
        tvit.preprocess(torch.from_numpy(_images(1, 2, 40)), tcfg)


def test_encoder_chain_matches_jax_chain_reference():
    """The port's stats chain (plain K1/K2) and its XLA-style reference
    against vit._encoder_chain_xla, f32 gelu_tanh: one-pass vs two-pass
    variance and max-free vs exact softmax differ by f32 rounding only."""
    jcfg, tcfg, jparams, tparams = _pair(
        1, dict(attn_impl="xla", mlp_impl="xla"), dtype="float32",
        hidden_act="gelu_tanh", **TINY)
    x = (np.random.default_rng(2).normal(size=(2, 24, 64)) * 0.5).astype(
        np.float32)
    want = np.asarray(jvit._encoder_chain_xla(jparams["blocks"],
                                              jnp.asarray(x), jcfg, 17))
    for fn in (tvit._encoder_stats_chain, tvit._encoder_chain_xla):
        got = fn(tparams["blocks"], torch.from_numpy(x), tcfg, 17).numpy()
        np.testing.assert_allclose(got[:, :17], want[:, :17], rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("dtype,act,raw,tol", [
    # f32: the JAX CPU forward takes the per-block XLA path; the port the
    # stats chain.  Same function up to f32 rounding.
    ("float32", "gelu_tanh", False, 1e-4),
    ("float32", "gelu_tanh", True, 1e-4),
    ("float32", "gelu", True, 1e-4),
    # bf16 "gelu" runs as tanh-GELU on both sides; rounding to bf16 at
    # slightly different points (one-pass stats, max-free softmax) gives
    # a few bf16 ulps (2^-8 relative) on logits of order 1.
    ("bfloat16", "gelu", True, 3e-2),
])
def test_forward_matches_jax(dtype, act, raw, tol):
    jcfg, tcfg, jparams, tparams = _pair(3, dtype=dtype, hidden_act=act,
                                         **TINY)
    img = _images(4, 3, 32)
    if raw:
        want = jvit.forward_raw(jparams, jnp.asarray(img), jcfg)
        got = tvit.make_forward(tcfg, tparams, raw=True, device="cpu")(img)
    else:
        x = np.array(jvit.preprocess(jnp.asarray(img), jcfg))
        want = jvit.forward(jparams, jnp.asarray(x), jcfg)
        got = tvit.make_forward(tcfg, tparams, raw=False,
                                device="cpu")(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (3, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                               atol=tol)


def test_vit_b16_bf16_full_width_matches_jax():
    """vit_b16 at full width (D=768, 12 heads, M=3072, 197 tokens padded to
    200), depth cut to 2, batch 2, bf16: within the bf16 band."""
    kw = dict(tvit.VARIANTS["vit_b16"], depth=2)
    jcfg, tcfg, jparams, tparams = _pair(5, dtype="bfloat16", **kw)
    img = _images(6, 2, 224)
    want = np.asarray(jvit.forward_raw(jparams, jnp.asarray(img), jcfg))
    got = tvit.make_forward(tcfg, tparams, raw=True, device="cpu")(img)
    assert got.shape == (2, 1000)
    err = np.abs(got.numpy() - want).max() / np.abs(want).max()
    assert err < 3e-2, err


def test_safe_softmax_not_ported_yet():
    """safe_softmax used to raise (its kernel K4 was not ported); it now
    routes make_forward to the per-block encoder (plain K4/K5 on the CPU),
    which matches the JAX forward with safe_softmax in f32."""
    jcfg, tcfg, jparams, tparams = _pair(7, dtype="float32",
                                         safe_softmax=True, **TINY)
    img = _images(8, 2, 32)
    want = np.asarray(jvit.forward_raw(jparams, jnp.asarray(img), jcfg))
    got = tvit.make_forward(tcfg, tparams, device="cpu")(img).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_init_params_layout_matches_jax_and_is_seeded():
    cfg = tvit.ViTConfig(**TINY)
    jp = jvit.init_params(jax.random.key(0), jvit.ViTConfig(**TINY))
    g1, g2 = torch.Generator(), torch.Generator()
    g1.manual_seed(3)
    g2.manual_seed(3)
    a = tvit.init_params(cfg, g1, device="cpu")
    b = tvit.init_params(cfg, g2, device="cpu")
    shapes = jax.tree_util.tree_map(lambda x: tuple(x.shape), jp)
    assert jax.tree_util.tree_map(lambda x: tuple(x.shape), a) == shapes
    torch.testing.assert_close(a["blocks"]["w1"], b["blocks"]["w1"],
                               rtol=0, atol=0)
    w = a["blocks"]["wqkv"]
    assert float(w.abs().max()) <= 0.04 + 1e-7 and 0.01 < float(w.std())
