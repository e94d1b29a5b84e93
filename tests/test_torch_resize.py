"""The port's resize (models/vit.resize: the algorithm of jax.image's
separable scale-and-translate, antialiased) through its two users against
the JAX package: ``preprocess`` on input other than S x S ("bilinear") and
``interpolate_pos_embed`` ("cubic"), on the same seeded numpy inputs.

Tolerances.  Against a float64 evaluation of the JAX algorithm (its
``compute_weight_mat`` op by op, the contraction in f64) the port is
within 1e-5 relative.  The JAX ``preprocess`` itself computes the weights
inside one XLA fusion on the CPU, whose f32 sample positions differ from
the op-by-op ones by up to an ulp of the largest coordinate (a 320 -> 224
weight moved by 7e-6, resizing an identity); so the f32 band against it is
two ulps of the largest input coordinate over the smallest std, and in
bf16 that band plus one bf16 ulp of the larger value (each side rounds its
f32 value once)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src.image import scale as jax_scale

from vit_fpga_tpu.models import vit as jvit
from vit_fpga_tpu_torch.models import vit as tvit

CASES = [(2, 256, 320), (2, 160, 160)]
SIZE = 224


def _images(seed, b, h, w):
    return np.random.default_rng(seed).integers(0, 256, (b, h, w, 3),
                                                np.uint8)


def _cfgs(dtype):
    kw = dict(image_size=SIZE, patch_size=16, hidden_dim=64, depth=1,
              num_heads=1, mlp_dim=128, dtype=dtype)
    return jvit.ViTConfig(**kw), tvit.ViTConfig(**kw)


def _f64_preprocess(img, cfg):
    """The JAX algorithm in float64: compute_weight_mat's weights (eager,
    op by op), contracted in f64, then the normalisation."""
    x = img.astype(np.float64) / 255.0
    for dim in (1, 2):
        m = x.shape[dim]
        if m != SIZE:
            w = np.asarray(jax_scale.compute_weight_mat(
                m, SIZE, SIZE / m, 0.0, jax_scale._fill_triangle_kernel,
                True), np.float64)
            x = np.moveaxis(np.tensordot(x, w, axes=([dim], [0])), -1, dim)
    return (x - np.asarray(cfg.mean)) / np.asarray(cfg.std)


@pytest.mark.parametrize("b,h,w", CASES, ids=["256x320", "160x160"])
def test_preprocess_resizes_as_the_jax_algorithm(b, h, w):
    jcfg, tcfg = _cfgs("float32")
    img = _images(h, b, h, w)
    got = tvit.preprocess(torch.from_numpy(img), tcfg)
    assert got.shape == (b, SIZE, SIZE, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _f64_preprocess(img, tcfg),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,w", CASES, ids=["256x320", "160x160"])
def test_preprocess_matches_jax(b, h, w, dtype):
    jcfg, tcfg = _cfgs(dtype)
    img = _images(h + 1, b, h, w)
    got = tvit.preprocess(torch.from_numpy(img), tcfg).float().numpy()
    want = np.asarray(jvit.preprocess(jnp.asarray(img), jcfg).astype(
        jnp.float32))
    assert got.shape == want.shape == (b, SIZE, SIZE, 3)
    diff = np.abs(got - want)
    band = 2 * max(h, w) * 2.0 ** -24 / min(tcfg.std)
    if dtype == "bfloat16":
        # each side is its f32 value rounded once to bf16
        big = np.maximum(np.maximum(np.abs(got), np.abs(want)), 2.0 ** -120)
        band = band + 2.0 ** (np.floor(np.log2(big)) - 7)
    assert np.all(diff <= band), float((diff - band).max())


def test_preprocess_keeps_s_by_s_input_and_refuses_other_channels():
    jcfg, tcfg = _cfgs("float32")
    img = _images(3, 2, SIZE, SIZE)
    np.testing.assert_allclose(
        tvit.preprocess(torch.from_numpy(img), tcfg).numpy(),
        np.asarray(jvit.preprocess(jnp.asarray(img), jcfg)), rtol=1e-6,
        atol=1e-6)
    with pytest.raises(ValueError):
        tvit.preprocess(torch.zeros((2, 40, 40, 4), dtype=torch.uint8), tcfg)


def _pos_params(seed, grid, d=64, npre=1):
    rng = np.random.default_rng(seed)
    return dict(pos_embed=rng.normal(size=(1, grid * grid + npre, d)).astype(
        np.float32), cls_token=np.zeros((1, npre, d), np.float32))


@pytest.mark.parametrize("old,new", [(224, 384), (384, 224)],
                         ids=["14to24", "24to14"])
def test_interpolate_pos_embed_matches_jax(old, new):
    """The position grid resized "cubic" (14 -> 24 and 24 -> 14 patches a
    side at patch 16), the prefix row carried over bit for bit."""
    p = _pos_params(old, old // 16)
    want = jvit.interpolate_pos_embed(
        {k: jnp.asarray(v) for k, v in p.items()}, old, new, 16)
    got = tvit.interpolate_pos_embed(
        {k: torch.from_numpy(v) for k, v in p.items()}, old, new, 16)
    w = np.asarray(want["pos_embed"])
    g = got["pos_embed"].numpy()
    assert g.shape == w.shape == (1, (new // 16) ** 2 + 1, 64)
    np.testing.assert_array_equal(g[:, :1], p["pos_embed"][:, :1])
    np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5 * np.abs(w).max())
    same = {k: torch.from_numpy(v) for k, v in p.items()}
    assert tvit.interpolate_pos_embed(same, old, old, 16) is same


def test_raw_forward_takes_other_sizes():
    """A raw entry point resizes: make_forward on 40 x 48 input equals the
    forward of its preprocess, and the logits are finite."""
    _, tcfg = _cfgs("float32")
    tcfg = tvit.ViTConfig(**{**tcfg.__dict__, "image_size": 32,
                             "patch_size": 8, "num_classes": 8})
    params = tvit.init_params(tcfg, device="cpu")
    img = _images(5, 2, 40, 48)
    got = tvit.make_forward(tcfg, params, device="cpu")(img)
    want = tvit.make_forward(tcfg, params, raw=False, device="cpu")(
        tvit.preprocess(torch.from_numpy(img), tcfg))
    assert got.shape == (2, 8) and torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=0, atol=0)
