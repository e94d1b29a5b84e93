"""The port's DeiT (models/deit.py, plain versions on the CPU) against the
JAX package's DeiT on the CPU: configuration, parameter tree and the
forward with and without the distillation head, on the same parameters
handed over through params_from_numpy."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_fpga_tpu.models import deit as jdeit
from vit_fpga_tpu.models import vit as jvit
from vit_fpga_tpu_torch.models import deit as tdeit
from vit_fpga_tpu_torch.models.convert import params_from_numpy

# image 32, patch 16 -> 4 patches + 2 prefix tokens on 8 rows; D 128, 2
# heads of 64, depth 2, 10 classes
SMALL = dict(image_size=32, hidden_dim=128, num_heads=2, depth=2,
             mlp_dim=256, num_classes=10)


def _pair(seed, dtype):
    jcfg = dataclasses.replace(jdeit.config("deit_b16", dtype=dtype), **SMALL)
    tcfg = dataclasses.replace(tdeit.config("deit_b16", dtype=dtype), **SMALL)
    rng = np.random.default_rng(seed)
    np_params = jax.tree_util.tree_map(
        lambda p: np.asarray(p, np.float32)
        + 0.02 * rng.normal(size=np.shape(p)).astype(np.float32),
        jdeit.init_params(jax.random.key(0), jcfg))
    return (jcfg, tcfg, jax.tree_util.tree_map(jnp.asarray, np_params),
            params_from_numpy(np_params, device="cpu"))


def _images(seed, b, s=32):
    return np.random.default_rng(seed).integers(0, 256, (b, s, s, 3),
                                                np.uint8)


def _shapes(tree):
    return jax.tree_util.tree_map(lambda x: tuple(np.shape(x)), tree)


@pytest.mark.parametrize("variant", sorted(jdeit.VARIANTS))
def test_deit_config_matches_jax(variant):
    j, t = jdeit.config(variant), tdeit.config(variant)
    assert tdeit.VARIANTS == jdeit.VARIANTS
    names = {f.name for f in dataclasses.fields(type(t))}
    assert {k: v for k, v in dataclasses.asdict(j).items()
            if k in names} == dataclasses.asdict(t)
    assert t.num_prefix_tokens == 2 and t.seq_len == 198
    assert t.mean == (0.485, 0.456, 0.406) and t.std == (0.229, 0.224, 0.225)
    with pytest.raises(ValueError):
        tdeit.config("deit_x99")


def test_deit_init_params_tree_matches_jax_and_is_seeded():
    jcfg, tcfg, _, _ = _pair(0, "float32")
    jp = jdeit.init_params(jax.random.key(0), jcfg)
    g1, g2 = torch.Generator(), torch.Generator()
    g1.manual_seed(5)
    g2.manual_seed(5)
    a = tdeit.init_params(tcfg, g1, device="cpu")
    b = tdeit.init_params(tcfg, g2, device="cpu")
    assert _shapes(a) == _shapes(jp)
    assert a["cls_token"].shape == (1, 2, 128)
    torch.testing.assert_close(a["head_dist"]["kernel"],
                               b["head_dist"]["kernel"], rtol=0, atol=0)
    with pytest.raises(ValueError):
        tdeit.init_params(dataclasses.replace(tcfg, num_prefix_tokens=1),
                          device="cpu")


@pytest.mark.parametrize("head_dist", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_deit_forward_matches_jax(dtype, head_dist):
    """The mean of the CLS and distillation heads, or the CLS head alone
    without ``head_dist``.  f32 1e-4 (per-block XLA path against the
    port's stats chain); bf16 2e-2 in relative norm."""
    jcfg, tcfg, jparams, tparams = _pair(1, dtype)
    if not head_dist:
        jparams = {k: v for k, v in jparams.items() if k != "head_dist"}
        tparams = {k: v for k, v in tparams.items() if k != "head_dist"}
    img = _images(2, 3)
    x = np.array(jvit.preprocess(jnp.asarray(img), jcfg).astype(jnp.float32))
    want = np.asarray(jdeit.forward(jparams, jnp.asarray(x).astype(
        jcfg.compute_dtype), jcfg), np.float32)
    got = tdeit.make_forward(tcfg, tparams, raw=False, device="cpu")(
        torch.from_numpy(x).to(tcfg.compute_dtype))
    assert got.dtype == torch.float32 and got.shape == (3, 10)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    else:
        rel = np.linalg.norm(got.numpy() - want) / np.linalg.norm(want)
        assert rel < 2e-2, rel


def test_deit_forward_raw_matches_jax():
    jcfg, tcfg, jparams, tparams = _pair(3, "float32")
    img = _images(4, 2)
    want = np.asarray(jdeit.forward_raw(jparams, jnp.asarray(img), jcfg))
    got = tdeit.make_forward(tcfg, tparams, device="cpu")(img)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_deit_entry_points_need_a_card_or_cpu():
    """No quiet fallback: without a GPU the entry points raise unless
    device='cpu'."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, tcfg, _, tparams = _pair(5, "bfloat16")
    with pytest.raises(RuntimeError):
        tdeit.make_forward(tcfg, tparams)
    with pytest.raises(RuntimeError):
        tdeit.init_params(tcfg)
