"""The port's uint8 patch embedding (fold_preprocess, patch_embed_xla and the
plain PyTorch version of the Hopper kernel K10) against the JAX package:
fold_preprocess bit for bit, patch_embed_pallas in interpret mode and
patch_embed_xla, on the same seeded numpy inputs.

Tolerances: f32 runs the same f32 products in another summation order, at
the JAX test's own rtol = atol = 1e-4; a bf16 output is the same f32 sum
rounded once, so it may sit one bf16 ulp away where the two f32 sums
straddle a rounding boundary."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_fpga_tpu.models import vit as jvit
from vit_fpga_tpu.ops.patch_embed import fold_preprocess as jax_fold
from vit_fpga_tpu.ops.patch_embed import patch_embed_pallas as jax_pe
from vit_fpga_tpu.ops.patch_embed import patch_embed_xla as jax_pe_xla
from vit_fpga_tpu_torch.models import vit as tvit
from vit_fpga_tpu_torch.ops import patch_embed as tpe

# (images shape, patch, D): the JAX test's geometry, and CLIP's P 14, whose
# (px, c) runs are 42 bytes
GEOMS = [((2, 32, 64, 3), 8, 128), ((2, 28, 56, 3), 14, 128)]
DTYPES = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)]


def _inputs(seed, shape, patch, d):
    """The JAX test's scales: kernel N(0, 0.01), bias N(0, 1)."""
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 256, shape, np.uint8)
    kf = rng.normal(size=(patch * patch * 3, d)).astype(np.float32) * 0.01
    bf = rng.normal(size=(d,)).astype(np.float32)
    return raw, kf, bf


def _within_one_bf16_ulp(got, want):
    g, w = np.asarray(got, np.float64), np.asarray(want, np.float64)
    mag = np.maximum(np.abs(g), np.abs(w))
    ulp = np.where(mag > 0, 2.0 ** (np.floor(np.log2(np.where(mag > 0, mag,
                                                             1.0))) - 7), 0)
    assert (np.abs(g - w) <= ulp).all(), float(np.abs(g - w).max())


@pytest.mark.parametrize("patch", [8, 14, 16])
def test_fold_preprocess_bit_for_bit(patch):
    rng = np.random.default_rng(patch)
    kernel = rng.normal(size=(patch * patch * 3, 96)).astype(np.float32)
    bias = rng.normal(size=(96,)).astype(np.float32)
    mean, std = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
    for want, got in zip(jax_fold(kernel, bias, mean, std, patch),
                         tpe.fold_preprocess(kernel, bias, mean, std, patch)):
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("geom", GEOMS, ids=["p8", "p14"])
@pytest.mark.parametrize("dts", DTYPES, ids=["f32", "bf16"])
def test_patch_embed_plain_matches_pallas(geom, dts):
    shape, patch, d = geom
    jdt, tdt = dts
    raw, kf, bf = _inputs(1, shape, patch, d)
    want = jax_pe(jnp.asarray(raw), jnp.asarray(kf), jnp.asarray(bf), patch,
                  out_dtype=jdt, interpret=True)
    got = tpe.patch_embed_pallas(torch.from_numpy(raw), torch.from_numpy(kf),
                                 torch.from_numpy(bf), patch, out_dtype=tdt)
    assert got.dtype == tdt and tuple(got.shape) == tuple(want.shape)
    g = got.float().numpy()
    w = np.asarray(want.astype(jnp.float32))
    if tdt == torch.float32:
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)
    else:
        _within_one_bf16_ulp(g, w)


@pytest.mark.parametrize("geom", GEOMS, ids=["p8", "p14"])
def test_patch_embed_xla_matches_jax_and_plain(geom):
    """patch_embed_xla (patchify + one GEMM) against the JAX one and
    against the plain version of K10 (per-py GEMMs): f32, 1e-4."""
    shape, patch, d = geom
    raw, kf, bf = _inputs(2, shape, patch, d)
    want = np.asarray(jax_pe_xla(jnp.asarray(raw), jnp.asarray(kf),
                                 jnp.asarray(bf), patch,
                                 out_dtype=jnp.float32))
    args = (torch.from_numpy(raw), torch.from_numpy(kf), torch.from_numpy(bf),
            patch)
    got = tpe.patch_embed_xla(*args, out_dtype=torch.float32).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    plain = tpe.patch_embed_plain(*args, out_dtype=torch.float32).numpy()
    np.testing.assert_allclose(plain, got, rtol=1e-4, atol=1e-4)


def test_folded_embed_equals_explicit_pipeline():
    """The JAX test's check on the port: fold_preprocess + K10's plain
    version on raw pixels == preprocess -> patchify -> GEMM + bias."""
    cfg = tvit.config("vit_b16", image_size=32, dtype="float32")
    jcfg = jvit.config("vit_b16", image_size=32, dtype="float32")
    assert (cfg.mean, cfg.std) == (jcfg.mean, jcfg.std)
    rng = np.random.default_rng(3)
    p = cfg.patch_size
    kernel = (rng.normal(size=(p * p * 3, 64)) * 0.02).astype(np.float32)
    bias = rng.normal(size=(64,)).astype(np.float32)
    kf, bf = tpe.fold_preprocess(kernel, bias, cfg.mean, cfg.std, p)
    raw = torch.from_numpy(rng.integers(0, 256, (2, 32, 32, 3), np.uint8))
    x = tvit.preprocess(raw, cfg)
    explicit = tvit.patchify(x, p) @ torch.from_numpy(kernel) \
        + torch.from_numpy(bias)
    folded = tpe.patch_embed_pallas(raw, torch.from_numpy(kf),
                                    torch.from_numpy(bf), p,
                                    out_dtype=torch.float32)
    np.testing.assert_allclose(folded.numpy(), explicit.numpy(), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("case", ["channels", "ragged", "kernel", "bias",
                                  "dtype", "out_dtype", "meta"])
def test_patch_embed_rejects_what_the_kernel_does_not_take(case):
    """The checks shared by K10 and its plain version, and the devices the
    wrapper takes (a meta tensor raises: no fallback)."""
    raw = torch.zeros((1, 32, 32, 3), dtype=torch.uint8)
    kf, bf = torch.zeros((192, 16)), torch.zeros(16)
    out_dtype = torch.bfloat16
    if case == "channels":
        raw = torch.zeros((1, 32, 32, 4), dtype=torch.uint8)
    elif case == "ragged":
        raw = torch.zeros((1, 36, 32, 3), dtype=torch.uint8)
    elif case == "kernel":
        kf = torch.zeros((191, 16))
    elif case == "bias":
        bf = torch.zeros(15)
    elif case == "dtype":
        raw = raw.float()
    elif case == "out_dtype":
        out_dtype = torch.float16
    elif case == "meta":
        raw = raw.to("meta")
    with pytest.raises(ValueError):
        tpe.patch_embed_pallas(raw, kf, bf, 8, out_dtype=out_dtype)
