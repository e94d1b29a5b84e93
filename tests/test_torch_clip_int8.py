"""CLIP's int8 vision towers in the port (models/quantized:
quantize_clip_vision_fast / _static, clip_forward_int8_fast,
clip_forward_int8_latency, make_forward_int8(clip=True)) against the JAX
package's, on the CPU.

The JAX towers run as the TPU runs them: ``jax.default_backend`` reads
"tpu" and the int8 block kernels (K16 -> K15, K18 -> K17) and the
single-launch stacks (K19a, K19b) run in interpret mode; the port runs
their plain versions.  Bands: the block route against the interpreted
kernels, 2^-6 of the largest embedding (an occasional bf16 ulp flip that
later layers carry, as tests/test_torch_int8.py); the latency route, the
0.06 of tests/test_torch_latency.py; against the JAX CPU forward (its
per-linear route and reference blocks), 5%.  The static trees fold the
JAX calibration's scales on both sides, so the trees are equal bit for
bit; the port's own calibration over CLIP's layout (``ln_pre`` before the
blocks) is held against the JAX one in the probe's bands."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vit_fpga_tpu.ops.quant_block as jqb
import vit_fpga_tpu.ops.vit_stack as jvs
from vit_fpga_tpu.models import clip as jclip
from vit_fpga_tpu.models import quantized as jq
from vit_fpga_tpu.models import vit as jvit
from vit_fpga_tpu.utils import calibrate as jcal
from vit_fpga_tpu_torch.models import clip as tclip
from vit_fpga_tpu_torch.models import quantized as tq
from vit_fpga_tpu_torch.models import vit as tvit
from vit_fpga_tpu_torch.models.convert import (params_from_numpy,
                                               params_to_numpy)
from vit_fpga_tpu_torch.ops import quant_block as tqb
from vit_fpga_tpu_torch.runtime.serving import ImageServer
from vit_fpga_tpu_torch.utils import calibrate as tcal

TINY = dict(image_size=32, patch_size=8, hidden_dim=64, depth=2,
            num_heads=4, mlp_dim=128, num_classes=0, hidden_act="quick_gelu",
            ln_eps=1e-5)
TIGHT = 2.0 ** -6
LATENCY_BAND = 0.06
LOOSE = 0.05
# The calibration probe, as tests/test_torch_int8_static.py: f32, a few
# ulps of each absmax; bf16, an ulp flip of an activation moves an absmax
# by up to 2^-8 and later layers carry it.
CALIB_F32 = 1e-5
CALIB_BF16 = 2e-2


def _cfgs(**kw):
    cfg_kw = {**TINY, **kw}
    return (jvit.ViTConfig(**cfg_kw, mean=jvit.CLIP_MEAN, std=jvit.CLIP_STD),
            tvit.ViTConfig(**cfg_kw, mean=tvit.CLIP_MEAN, std=tvit.CLIP_STD))


def _np_params(jcfg, seed):
    """CLIP params with 0.02 noise on every leaf, in numpy."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.02 * rng.normal(size=p.shape).astype(
            np.float32),
        jclip.init_params(jax.random.key(seed), jcfg, projection_dim=24))


def _trees(seed, static, **kw):
    """(jcfg, tcfg, the JAX int8 tree, the port's): a static JAX tree is
    ``quantize_clip_vision_static`` on the JAX calibration, and the port's
    folds those same scales into its own fast tree."""
    jcfg, tcfg = _cfgs(**kw)
    np_params = _np_params(jcfg, seed)
    tp = params_from_numpy(np_params, device="cpu")
    jp = jax.tree_util.tree_map(jnp.asarray, np_params)
    if not static:
        return jcfg, tcfg, jq.quantize_clip_vision_fast(jp), \
            tq.quantize_clip_vision_fast(tp)
    sc = {k: np.asarray(v)
          for k, v in jcal.static_activation_scales(jp, jcfg).items()}
    tqp = tq._fold_static_scales(tq.quantize_clip_vision_fast(tp), sc,
                                 tq.QMAX)
    return jcfg, tcfg, jq.quantize_clip_vision_static(jp, jcfg), tqp


def _tpu_jax(monkeypatch):
    """The JAX towers as on a TPU, their Pallas kernels interpreted."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    for name in ("attn_block_int8", "mlp_block_int8",
                 "attn_block_int8_static", "mlp_block_int8_static"):
        monkeypatch.setattr(jqb, name, functools.partial(
            getattr(jqb, name), interpret=True))
    for name in ("vit_layers_int8_pallas", "vit_layers_int8_static_pallas"):
        monkeypatch.setattr(jvs, name, functools.partial(
            getattr(jvs, name), interpret=True))


def _jit(fn, cfg):
    return jax.jit(functools.partial(fn, cfg=cfg))


def _images(seed, b=3, s=32):
    return np.random.default_rng(seed).integers(0, 256, (b, s, s, 3),
                                                np.uint8)


def _flat(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _flat(tree[k], f"{prefix}{k}.")
        else:
            yield prefix + k, tree[k]


def _close(got, want, band):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= band * np.abs(want).max(), \
        np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("static", [False, True])
def test_clip_int8_trees_equal_jax(static):
    _, _, jqp, tqp = _trees(0, static)
    mine = dict(_flat(params_to_numpy(tqp)))
    theirs = dict(_flat(jax.tree_util.tree_map(np.asarray, jqp)))
    assert mine.keys() == theirs.keys()
    for k, v in theirs.items():
        np.testing.assert_array_equal(mine[k], np.asarray(v, mine[k].dtype),
                                      err_msg=k)
    assert {"ln_pre_scale", "ln_pre_bias", "proj"} <= set(tqp)
    assert ("inv_ao" in tqp["blocks"]) == static


@pytest.mark.parametrize("dtype,tol", [("float32", CALIB_F32),
                                       ("bfloat16", CALIB_BF16)])
def test_clip_activation_absmax_stats_match_jax(dtype, tol):
    """The probe over CLIP's layout: ``ln_pre`` after the embed, then the
    blocks; every per-layer absmax within the probe's band of JAX's."""
    jcfg, tcfg = _cfgs(dtype=dtype)
    np_params = _np_params(jcfg, 11)
    want = jcal.activation_absmax_stats(
        jax.tree_util.tree_map(jnp.asarray, np_params),
        jcal._synthetic_batch(jcfg), jcfg)
    got = tcal.activation_absmax_stats(
        params_from_numpy(np_params, device="cpu"),
        tcal._synthetic_batch(tcfg), tcfg)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == np.float32 and got[k].shape == (2,)
        np.testing.assert_allclose(got[k], want[k], rtol=tol, err_msg=k)


@pytest.mark.parametrize("dtype,tol", [("float32", CALIB_F32),
                                       ("bfloat16", CALIB_BF16)])
def test_quantize_clip_vision_static_calibrates_as_jax(dtype, tol):
    """The port's own calibration and fold against
    ``quantize_clip_vision_static``: the int8 weights bit for bit, every
    folded float within the probe's band of JAX's, the f32 ``ln_pre`` and
    ``proj`` equal."""
    jcfg, tcfg = _cfgs(dtype=dtype)
    np_params = _np_params(jcfg, 12)
    want = dict(_flat(jax.tree_util.tree_map(
        np.asarray, jq.quantize_clip_vision_static(
            jax.tree_util.tree_map(jnp.asarray, np_params), jcfg))))
    got = dict(_flat(tq.quantize_clip_vision_static(
        params_from_numpy(np_params, device="cpu"), tcfg)))
    assert got.keys() == want.keys()
    assert "blocks.inv_ao" in got
    for name, leaf in got.items():
        if leaf.dtype == torch.int8 or name.startswith(("ln_pre", "proj")):
            np.testing.assert_array_equal(
                leaf.numpy(), np.asarray(want[name], leaf.numpy().dtype),
                err_msg=name)
        else:
            np.testing.assert_allclose(leaf.float().numpy(),
                                       np.asarray(want[name], np.float32),
                                       rtol=tol, err_msg=name)


@pytest.mark.parametrize("static", [False, True])
def test_clip_int8_forward_matches_jax_kernels(monkeypatch, static):
    _tpu_jax(monkeypatch)
    jcfg, tcfg, jqp, tqp = _trees(1, static)
    img = _images(2)
    want = np.asarray(_jit(jq.clip_forward_int8_raw, jcfg)(
        jqp, jnp.asarray(img)))
    got = tq.make_forward_int8(tcfg, tqp, device="cpu", clip=True)(img)
    assert got.dtype == torch.float32 and got.shape == (3, 24)
    _close(got.numpy(), want, TIGHT)
    # not prepared, normalized input: the same function
    x = tvit.preprocess(torch.from_numpy(img), tcfg)
    assert torch.equal(tq.clip_forward_int8_fast(tqp, x, tcfg), got)


@pytest.mark.parametrize("static", [False, True])
def test_clip_int8_at_257_tokens_matches_jax_kernels(monkeypatch, static):
    """CLIP ViT-L/14's token count at 224 px, 257 tokens on 264 rows,
    narrow (2 heads of 64, depth 1): every attention half is K16 (K18 on
    the static tree) at n_pad 264 with 257 valid, inside the gate the card
    applies; quick-GELU through K15 (K17)."""
    _tpu_jax(monkeypatch)
    kw = dict(image_size=224, patch_size=14, hidden_dim=128, num_heads=2,
              mlp_dim=256, depth=1)
    jcfg, tcfg, jqp, tqp = _trees(3, static, **kw)
    assert tcfg.seq_len == 257 and tq._int8_block_fits(tcfg)
    name = "attn_block_int8_static" if static else "attn_block_int8"
    geometry = (tqb.attn_int8_static_geometry if static
                else tqb.attn_int8_geometry)
    real, shapes = getattr(tq, name), []

    def spy(x, *args, n_valid=None, **kwargs):
        shapes.append((tuple(x.shape), n_valid))
        geometry(*x.shape, args[-1], n_valid)
        return real(x, *args, n_valid=n_valid, **kwargs)

    monkeypatch.setattr(tq, name, spy)
    img = _images(4, b=2, s=224)
    want = np.asarray(_jit(jq.clip_forward_int8_raw, jcfg)(
        jqp, jnp.asarray(img)))
    got = tq.make_forward_int8(tcfg, tqp, device="cpu", clip=True)(img)
    assert shapes == [((2, 264, 128), 257)]
    _close(got.numpy(), want, TIGHT)


@pytest.mark.parametrize("static", [False, True])
def test_clip_int8_holds_to_the_jax_cpu_forward(static):
    jcfg, tcfg, jqp, tqp = _trees(5, static)
    img = _images(6, b=4)
    want = np.asarray(_jit(jq.clip_forward_int8_raw, jcfg)(
        jqp, jnp.asarray(img)))
    got = tq.make_forward_int8(tcfg, tqp, device="cpu", clip=True)(img)
    _close(got.numpy(), want, LOOSE)


@pytest.mark.parametrize("static", [False, True])
def test_clip_int8_latency_matches_jax(monkeypatch, static):
    _tpu_jax(monkeypatch)
    jcfg, tcfg, jqp, tqp = _trees(7, static)
    img = _images(8, b=3)
    want = np.asarray(_jit(jq.clip_forward_int8_latency, jcfg)(
        jqp, jvit.preprocess(jnp.asarray(img), jcfg)), np.float32)
    xt = tvit.preprocess(torch.from_numpy(img), tcfg)
    got = tq.clip_forward_int8_latency(tqp, xt, tcfg)
    assert got.dtype == torch.float32 and got.shape == (3, 24)
    _close(got.numpy(), want, LATENCY_BAND)
    fold = tq.prep_clip_int8_latency(tqp, tcfg)
    assert fold["_stack"]["wqkv_q"].stride()[-2] == 1   # k-major view
    assert torch.equal(tq.clip_forward_int8_latency(fold, xt, tcfg), got)
    # the plain stack is the blocks in one call: the block route agrees
    np.testing.assert_allclose(
        tq.clip_forward_int8_fast(tqp, xt, tcfg).numpy(), got.numpy(),
        rtol=0, atol=TIGHT * float(got.abs().max()))
    served = tq.make_clip_forward_int8_latency(tcfg, tqp, device="cpu")(img)
    assert torch.equal(served, got)


def test_clip_int8_latency_gate():
    """The latency gate is the ViT one, K19a's: CLIP ViT-B/16 at 224 px
    (197 tokens) at b1 and b4 passes, b5 does not, and CLIP ViT-L/14 (257
    tokens) is past K19a's 256 tokens.  (The JAX gate's VMEM planner
    admits ViT-L/14 at b1.)"""
    b16 = tclip.clip_vision_config("vit_b16")
    l14 = tclip.clip_vision_config("vit_l14")
    assert tq.clip_int8_latency_supported(b16, 1)
    assert tq.clip_int8_latency_supported(b16, 4)
    assert not tq.clip_int8_latency_supported(b16, 5)
    assert not tq.clip_int8_latency_supported(l14, 1)
    assert jq.clip_int8_latency_supported(jclip.clip_vision_config("vit_b16"),
                                          4)


def test_image_server_serves_the_clip_int8_tower():
    jcfg, tcfg, jqp, tqp = _trees(9, False)
    fwd = tq.make_forward_int8(tcfg, tqp, device="cpu", clip=True)
    img = _images(10, b=5)
    want = fwd(img).numpy()
    with ImageServer(fwd, image_size=32, batch_size=2,
                     device="cpu") as server:
        rows = [f.result(timeout=60) for f in
                [server.submit_raw(im) for im in img]]
    np.testing.assert_allclose(np.stack(rows), want, rtol=0,
                               atol=TIGHT * np.abs(want).max())
    assert server.batches == 3
