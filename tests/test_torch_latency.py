"""The port's batch-1 latency serving path (models/vit.forward_latency and
models/quantized.vit_forward_int8_latency, the plain K11 / K19a on the
CPU) against the JAX package's latency forwards with their stack kernels
in interpret mode, the gates against the JAX gates, and serving through
ImageServer(batch_size=1)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vit_fpga_tpu.ops.quant_fused as jqf
import vit_fpga_tpu.ops.vit_stack as jvs
from vit_fpga_tpu.models import quantized as jq
from vit_fpga_tpu.models import vit as jvit
from vit_fpga_tpu_torch.models import quantized as tq
from vit_fpga_tpu_torch.models import vit as tvit
from vit_fpga_tpu_torch.models.convert import params_from_numpy
from vit_fpga_tpu_torch.ops import vit_stack as tvs
from vit_fpga_tpu_torch.runtime.serving import ImageServer

TINY = dict(image_size=32, patch_size=8, hidden_dim=64, depth=2,
            num_heads=4, mlp_dim=128, num_classes=10)
# dh 64 (the card's head dim): 2 heads of 64
TINY64 = dict(TINY, hidden_dim=128, num_heads=2, mlp_dim=256)
# the bands of tests/test_cls_last.py: the latency forwards against the
# JAX latency forwards, relative to the largest logit
BF16_BAND = 0.05
INT8_BAND = 0.06
FOLD_TOL = 1e-5


def _np_params(jcfg, seed):
    """vit.init_params perturbed by 0.02 * normal noise, so the zero-init
    biases, LN params and CLS token carry signal."""
    rng = np.random.default_rng(seed)
    params = jvit.init_params(jax.random.key(0), jcfg)
    return jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.02 * rng.normal(size=p.shape).astype(
            np.float32), params)


def _pair(seed, geometry=TINY, **kw):
    cfg_kw = {**geometry, **kw}
    jcfg = jvit.ViTConfig(**cfg_kw)
    tcfg = tvit.ViTConfig(**cfg_kw)
    np_params = _np_params(jcfg, seed)
    return (jcfg, tcfg, jax.tree_util.tree_map(jnp.asarray, np_params),
            params_from_numpy(np_params, device="cpu"))


def _images(seed, b=2, s=32):
    return np.random.default_rng(seed).integers(0, 256, (b, s, s, 3),
                                                np.uint8)


def _interp(monkeypatch, module, name):
    monkeypatch.setattr(module, name, functools.partial(
        getattr(module, name), interpret=True))


def _max_rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("geometry", [TINY, TINY64])
@pytest.mark.parametrize("hidden_act", ["gelu", "quick_gelu"])
def test_forward_latency_matches_jax(monkeypatch, geometry, hidden_act):
    _interp(monkeypatch, jvs, "vit_layers_pallas")
    jcfg, tcfg, jp, tp = _pair(1, geometry, hidden_act=hidden_act)
    img = _images(2)
    x = jvit.preprocess(jnp.asarray(img), jcfg)
    want = np.asarray(jvit.forward_latency(jp, x, jcfg), np.float32)
    xt = tvit.preprocess(torch.from_numpy(img), tcfg)
    got = tvit.forward_latency(tp, xt, tcfg)
    assert got.dtype == torch.float32 and got.shape == (2, 10)
    assert _max_rel(got.numpy(), want) < BF16_BAND
    fold = tvit.prep_latency(tp, tcfg)
    np.testing.assert_allclose(tvit.forward_latency(fold, xt, tcfg).numpy(),
                               got.numpy(), rtol=FOLD_TOL, atol=FOLD_TOL)


def test_forward_latency_f32_matches_jax(monkeypatch):
    _interp(monkeypatch, jvs, "vit_layers_pallas")
    jcfg, tcfg, jp, tp = _pair(3, dtype="float32")
    img = _images(4)
    want = np.asarray(jvit.forward_latency(
        jp, jvit.preprocess(jnp.asarray(img), jcfg), jcfg))
    got = tvit.forward_latency(
        tp, tvit.preprocess(torch.from_numpy(img), tcfg), tcfg).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-3,
                               atol=1e-3 * np.abs(want).max())


def test_forward_latency_agrees_with_the_throughput_forward():
    """The CLS-last token order is invisible in the logits: the latency
    forward and make_forward's chain give the same classes."""
    _, tcfg, _, tp = _pair(5)
    img = _images(6, b=3)
    lat = tvit.make_forward_latency(tcfg, tp, device="cpu")(img).numpy()
    thr = tvit.make_forward(tcfg, tp, device="cpu")(img).numpy()
    assert _max_rel(lat, thr) < BF16_BAND
    np.testing.assert_array_equal(lat.argmax(1), thr.argmax(1))


def _int8_pair(seed, geometry=TINY, **kw):
    jcfg, tcfg, jp, tp = _pair(seed, geometry, **kw)
    return jcfg, tcfg, jq.quantize_vit_fast(jp), tq.quantize_vit_fast(tp)


@pytest.mark.parametrize("geometry", [TINY, TINY64])
@pytest.mark.parametrize("hidden_act", ["gelu", "quick_gelu"])
def test_int8_latency_matches_jax(monkeypatch, geometry, hidden_act):
    _interp(monkeypatch, jvs, "vit_layers_int8_pallas")
    _interp(monkeypatch, jqf, "int8_linear_fused")
    jcfg, tcfg, jqp, tqp = _int8_pair(7, geometry, hidden_act=hidden_act)
    img = _images(8, b=3)
    want = np.asarray(jq.vit_forward_int8_latency(
        jqp, jvit.preprocess(jnp.asarray(img), jcfg), jcfg), np.float32)
    xt = tvit.preprocess(torch.from_numpy(img), tcfg)
    got = tq.vit_forward_int8_latency(tqp, xt, tcfg)
    assert got.dtype == torch.float32 and got.shape == (3, 10)
    assert _max_rel(got.numpy(), want) < INT8_BAND
    np.testing.assert_array_equal(got.numpy().argmax(1), want.argmax(1))
    fold = tq.prep_int8_latency(tqp, tcfg)
    np.testing.assert_allclose(
        tq.vit_forward_int8_latency(fold, xt, tcfg).numpy(), got.numpy(),
        rtol=FOLD_TOL, atol=FOLD_TOL)


def test_int8_latency_headless_returns_cls_features(monkeypatch):
    _interp(monkeypatch, jvs, "vit_layers_int8_pallas")
    jcfg, tcfg, jqp, tqp = _int8_pair(9)
    jqp = {k: v for k, v in jqp.items() if k != "head"}
    tqp = {k: v for k, v in tqp.items() if k != "head"}
    img = _images(10)
    want = np.asarray(jq.vit_forward_int8_latency(
        jqp, jvit.preprocess(jnp.asarray(img), jcfg), jcfg), np.float32)
    got = tq.make_forward_int8_latency(tcfg, tqp, device="cpu")(img)
    assert got.shape == (2, 64)
    assert _max_rel(got.numpy(), want) < INT8_BAND


def test_prep_int8_latency_lays_weights_out_once():
    _, tcfg, _, tqp = _int8_pair(11)
    prep = tq.prep_int8_latency(tqp, tcfg)
    for k in ("wqkv_q", "wo_q", "w1_q", "w2_q"):
        w = prep["blocks"][k]
        assert torch.equal(w, tqp["blocks"][k])
        assert w.transpose(1, 2).is_contiguous(), k
    assert prep["head"]["wq"].t().is_contiguous()
    assert tq.prep_int8_latency(prep, tcfg) is prep


@pytest.mark.parametrize("batch", [1, 4, 5])
@pytest.mark.parametrize("safe", [False, True])
def test_gates_agree_with_jax(batch, safe):
    kw = dict(safe_softmax=safe)
    jcfg = jvit.ViTConfig(**{**jvit.VARIANTS["vit_b16"], **kw})
    tcfg = tvit.config("vit_b16", **kw)
    assert (tvit.latency_forward_supported(tcfg, batch)
            == jvit.latency_forward_supported(jcfg, batch))
    assert (tq.int8_latency_supported(tcfg, batch)
            == jq.int8_latency_supported(jcfg, batch))
    assert tvit.latency_forward_supported(tcfg, batch) == (
        batch <= 4 and not safe)


def test_static_tree_raises_naming_k19b(monkeypatch):
    """The latency forward serves a static tree (K19b's plain version)
    within the int8 band of the JAX latency forward on it; the dynamic
    stack refuses the tree, naming the static one."""
    _interp(monkeypatch, jvs, "vit_layers_int8_static_pallas")
    _interp(monkeypatch, jqf, "int8_linear_fused")
    jcfg, tcfg, jp, _ = _pair(12)
    static = jq.quantize_vit_static(
        jp, jcfg, images=jnp.asarray(np.random.default_rng(13).normal(
            size=(2, 32, 32, 3)), jnp.float32))
    handed = params_from_numpy(jax.tree_util.tree_map(np.asarray, static),
                               device="cpu")
    img = _images(14, b=2)
    want = np.asarray(jq.vit_forward_int8_latency(
        static, jvit.preprocess(jnp.asarray(img), jcfg), jcfg), np.float32)
    got = tq.make_forward_int8_latency(tcfg, handed, device="cpu")(img)
    assert got.shape == (2, 10)
    assert _max_rel(got.numpy(), want) < INT8_BAND
    with pytest.raises(ValueError, match="vit_layers_int8_static"):
        tvs.vit_layers_int8(torch.zeros(1, 17, 64, dtype=torch.bfloat16),
                            handed["blocks"], 4)


@pytest.mark.parametrize("int8", [False, True])
def test_image_server_batch_1_serves_the_latency_forward(int8):
    if int8:
        _, tcfg, _, tree = _int8_pair(14)
        fwd = tq.make_forward_int8_latency(tcfg, tree, device="cpu")
    else:
        _, tcfg, _, tree = _pair(14)
        fwd = tvit.make_forward_latency(tcfg, tree, device="cpu")
    rng = np.random.default_rng(15)
    imgs = [rng.integers(0, 256, (32, 32, 3), np.uint8) for _ in range(5)]
    with ImageServer(fwd, image_size=32, batch_size=1,
                     device="cpu") as server:
        results = [server.submit_raw(im).result(timeout=60) for im in imgs]
        assert server.served == 5 and server.batches == 5
    direct = fwd(np.stack(imgs)).numpy()
    for got, want in zip(results, direct):
        assert got.shape == (10,)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_latency_makers_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, tcfg, _, tp = _pair(16)
    with pytest.raises(RuntimeError):
        tvit.make_forward_latency(tcfg, tp)
    with pytest.raises(RuntimeError):
        tq.make_forward_int8_latency(tcfg, tq.quantize_vit_fast(tp))


def test_forward_latency_pools_cls_only():
    _, tcfg, _, tp = _pair(17)
    gap = dataclasses.replace(tcfg, pool="gap")
    x = tvit.preprocess(torch.from_numpy(_images(18)), tcfg)
    with pytest.raises(ValueError, match="cls"):
        tvit.forward_latency(tp, x, gap)
    with pytest.raises(ValueError, match="cls"):
        tq.vit_forward_int8_latency(tq.quantize_vit_fast(tp), x, gap)
