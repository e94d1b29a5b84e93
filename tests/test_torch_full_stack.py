"""The port's single-launch whole-model forwards (models/vit.
forward_latency_logits over K12 and models/quantized.
vit_forward_int8_latency_logits over K20, their plain versions on the CPU)
against the JAX package's forwards with vit_full_pallas and
vit_full_int8_pallas in interpret mode, on the same numpy-seeded weights
and images; the folds bit for bit against the JAX folds; the gates against
the JAX gates; and vit_full_plain against a composition of the K11 path's
pieces.

Two geometries: the JAX test's own (tests/test_full_stack.py: image 16,
patch 8, D 32, 4 heads, M 64, depth 2, 5 classes) and one inside the card's
gate (image 32, patch 16, D 128, 2 heads of 64, M 256, depth 2, 10
classes) at batch 1 and 4.  Tolerances: f32 elementwise 1e-4 (1 + |want|)
(the same arithmetic, f32 sums in another order); bf16 2e-2 in relative
norm (the stacks' band: bf16 ulp flips of the sums' order carried through
two layers); int8 5e-2 of the largest logit and the same top-1 (a rint
flip moves a whole quantization step, as tests/test_full_stack.py)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_fpga_tpu.models import quantized as jq
from vit_fpga_tpu.models import vit as jvit
from vit_fpga_tpu_torch.models import quantized as tq
from vit_fpga_tpu_torch.models import vit as tvit
from vit_fpga_tpu_torch.models.convert import params_from_numpy
from vit_fpga_tpu_torch.ops import vit_stack as tvs
from vit_fpga_tpu_torch.ops.quant_block import _ln_f32
from vit_fpga_tpu_torch.runtime.serving import ImageServer

JAX_GEOM = dict(image_size=16, patch_size=8, hidden_dim=32, depth=2,
                num_heads=4, mlp_dim=64, num_classes=5)
CARD_GEOM = dict(image_size=32, patch_size=16, hidden_dim=128, depth=2,
                 num_heads=2, mlp_dim=256, num_classes=10)
# (geometry, batch): the JAX test's geometry at its batch 2, the card's at 1
# and 4
CASES = [(JAX_GEOM, 2), (CARD_GEOM, 1), (CARD_GEOM, 4)]
CASE_IDS = ["jax-geometry-b2", "card-geometry-b1", "card-geometry-b4"]
F32_TOL = 1e-4
BF16_NORM = 2e-2
INT8_BAND = 5e-2


def _np_params(jcfg, seed):
    """vit.init_params perturbed by 0.02 * normal noise, so the zero-init
    head, biases, LN parameters and CLS token carry signal."""
    rng = np.random.default_rng(seed)
    params = jvit.init_params(jax.random.key(seed), jcfg)
    return jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.02 * rng.normal(size=p.shape).astype(
            np.float32), params)


def _pair(seed, geometry, **kw):
    cfg_kw = {**geometry, "hidden_act": "gelu_tanh", **kw}
    jcfg = jvit.ViTConfig(**cfg_kw)
    tcfg = tvit.ViTConfig(**cfg_kw)
    np_params = _np_params(jcfg, seed)
    return (jcfg, tcfg, jax.tree_util.tree_map(jnp.asarray, np_params),
            params_from_numpy(np_params, device="cpu"))


def _images(seed, batch, size):
    return np.random.default_rng(seed).normal(
        size=(batch, size, size, 3)).astype(np.float32)


def _rel_norm(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("geometry,batch", CASES, ids=CASE_IDS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_latency_logits_matches_jax(geometry, batch, dtype):
    jcfg, tcfg, jp, tp = _pair(1, geometry, dtype=dtype)
    img = _images(2, batch, geometry["image_size"])
    want = np.asarray(jvit.forward_latency_logits(
        jp, jnp.asarray(img), jcfg, interpret=True), np.float32)
    got = tvit.forward_latency_logits(tp, torch.from_numpy(img), tcfg)
    assert got.dtype == torch.float32
    assert got.shape == (batch, geometry["num_classes"]) == want.shape
    got = got.numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)
    else:
        assert _rel_norm(got, want) < BF16_NORM
    fold = tvit.prep_full_latency(tp, tcfg)
    np.testing.assert_array_equal(
        tvit.forward_latency_logits(fold, torch.from_numpy(img),
                                    tcfg).numpy(), got)


def test_forward_latency_logits_quick_gelu_matches_jax():
    jcfg, tcfg, jp, tp = _pair(3, CARD_GEOM, hidden_act="quick_gelu",
                               dtype="bfloat16")
    img = _images(4, 1, 32)
    want = np.asarray(jvit.forward_latency_logits(
        jp, jnp.asarray(img), jcfg, interpret=True), np.float32)
    got = tvit.forward_latency_logits(tp, torch.from_numpy(img), tcfg)
    assert _rel_norm(got.numpy(), want) < BF16_NORM


def _int8_pair(seed, geometry, **kw):
    jcfg, tcfg, jp, tp = _pair(seed, geometry, dtype="bfloat16", **kw)
    return jcfg, tcfg, jq.quantize_vit_fast(jp), tq.quantize_vit_fast(tp)


@pytest.mark.parametrize("geometry,batch", CASES, ids=CASE_IDS)
def test_int8_latency_logits_matches_jax(geometry, batch):
    jcfg, tcfg, jqp, tqp = _int8_pair(5, geometry)
    img = _images(6, batch, geometry["image_size"])
    want = np.asarray(jq.vit_forward_int8_latency_logits(
        jqp, jnp.asarray(img), jcfg, interpret=True), np.float32)
    got = tq.vit_forward_int8_latency_logits(tqp, torch.from_numpy(img),
                                             tcfg)
    assert got.dtype == torch.float32 and got.shape == want.shape
    got = got.numpy()
    assert np.abs(got - want).max() / np.abs(want).max() < INT8_BAND
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))
    fold = tq.prep_full_int8_latency(tqp, tcfg)
    np.testing.assert_array_equal(tq.vit_forward_int8_latency_logits(
        fold, torch.from_numpy(img), tcfg).numpy(), got)


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(jnp.asarray(t).astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prep_full_latency_equals_the_jax_fold(dtype):
    jcfg, tcfg, jp, tp = _pair(7, CARD_GEOM, dtype=dtype)
    want = jvit.prep_full_latency(jp, jcfg)
    got = tvit.prep_full_latency(tp, tcfg)
    for k in ("posb", "wp", "wh", "bh"):
        assert got[k].dtype == {"posb": torch.float32, "bh": torch.float32
                                }.get(k, tcfg.compute_dtype), k
        assert tuple(got[k].shape) == want[k].shape, k
        np.testing.assert_array_equal(_np(got[k]), _np(want[k]), err_msg=k)
    assert got["wh"].shape[-1] == 128


def test_prep_full_int8_latency_equals_the_jax_fold():
    jcfg, tcfg, jqp, tqp = _int8_pair(8, CARD_GEOM)
    want = jq.prep_full_int8_latency(jqp, jcfg)
    got = tq.prep_full_int8_latency(tqp, tcfg)
    for k in ("posb", "wpq", "wps", "whq", "whs", "bh"):
        assert tuple(got[k].shape) == want[k].shape, k
        np.testing.assert_array_equal(_np(got[k]), _np(want[k]), err_msg=k)
    assert got["whq"].dtype == got["wpq"].dtype == torch.int8
    assert got["whq"].is_contiguous()               # K20's head reads rows
    assert got["wpq"].t().is_contiguous()           # K20's embed: k-major
    assert float(got["whs"][-1]) == 1.0
    assert tq.prep_full_int8_latency(got, tcfg) is got


_GATE_CFGS = [
    {},
    dict(num_classes=0),
    dict(num_prefix_tokens=2),
    dict(hidden_act="relu"),
    dict(hidden_act="quick_gelu"),
    dict(hidden_act="gelu"),
    dict(pool="gap"),
    dict(dtype="bfloat16"),
]


@pytest.mark.parametrize("batch", [1, 4, 5])
@pytest.mark.parametrize("kw", _GATE_CFGS,
                         ids=lambda kw: ",".join(f"{k}={v}" for k, v in
                                                 kw.items()) or "plain")
def test_gates_agree_with_jax_off_the_card(kw, batch):
    """The CPU gates are the JAX gates on configs whose VMEM plan the JAX
    gate admits (its one TPU-only check): the bf16 gate reads neither pool
    nor batch (a GAP config gets CLS-pooled logits, ROADMAP §3)."""
    cfg_kw = {**JAX_GEOM, **kw}
    jcfg, tcfg = jvit.ViTConfig(**cfg_kw), tvit.ViTConfig(**cfg_kw)
    assert (tvit.full_latency_supported(tcfg, batch, card=False)
            == jvit.full_latency_supported(jcfg, batch))
    heads = {} if kw.get("num_classes") == 0 else {"head": {}}
    blocks = {"blocks": {}}
    assert (tq.full_int8_latency_supported({**heads, **blocks}, tcfg, batch,
                                           card=False)
            == jq.full_int8_latency_supported(heads, jcfg, batch))


@pytest.mark.parametrize("variant,batch,kw,want", [
    ("vit_b16", 1, {}, True),
    ("vit_b16", 4, {}, True),
    ("vit_b16", 5, {}, False),                       # batch past 4
    ("vit_b16", 1, dict(dtype="float32"), False),    # f32 runs on the CPU
    ("vit_b32", 1, {}, True),                        # p3 3072, 50 tokens
    ("vit_l16", 1, {}, True),                        # D 1024, M 4096
    ("vit_b16", 1, dict(image_size=384), False),     # 577 tokens past 256
    ("vit_b16", 1, dict(patch_size=14, image_size=112), False),  # p3 588
])
def test_card_gates(variant, batch, kw, want):
    cfg = tvit.config(variant, **{"dtype": "bfloat16", **kw})
    assert tvit.full_latency_supported(cfg, batch) == want
    if cfg.dtype == "bfloat16":
        assert tq.full_int8_latency_supported(
            {"head": {}, "blocks": {}}, cfg, batch) == want


def test_int8_gate_refuses_static_trees_and_headless_ones():
    _, tcfg, _, tqp = _int8_pair(9, CARD_GEOM)
    assert tq.full_int8_latency_supported(tqp, tcfg, 1)
    static = dict(tqp, blocks=dict(tqp["blocks"], inv_ao=None))
    headless = {k: v for k, v in tqp.items() if k != "head"}
    img = torch.zeros((1, 32, 32, 3))
    for tree in (static, headless):
        assert not tq.full_int8_latency_supported(tree, tcfg, 1, card=False)
        with pytest.raises(NotImplementedError):
            tq.vit_forward_int8_latency_logits(tree, img, tcfg)


def test_vit_full_plain_is_the_k11_path_with_its_head_points():
    """vit_full_plain is the K11 path's pieces in CLS-first order (embed,
    vit_layers_plain) with the JAX K12 kernel's two head points: the
    one-pass LayerNorm and xn cast to the head's dtype.  With the K11
    path's head points instead (the two-pass LayerNorm of
    models/vit._layernorm, the f32 head) the logits move, by less than the
    bf16 band."""
    _, tcfg, _, tp = _pair(10, CARD_GEOM, dtype="bfloat16")
    f = tvit.prep_full_latency(tp, tcfg)
    img = torch.from_numpy(_images(11, 2, 32))
    got = tvs.vit_full_plain(img, f["wp"], f["posb"], f["blocks"], f["lfs"],
                             f["lfb"], f["wh"], f["bh"], 2, 16)
    bf = torch.bfloat16
    pp = tvs.patch_rows(img, 16, f["posb"].shape[0], bf)
    tok = (pp.float() @ f["wp"].float() + f["posb"]).to(bf)
    tok = tvs.vit_layers_plain(tok, f["blocks"], 2, n_valid=tcfg.seq_len)
    one_pass = _ln_f32(tok[:, 0], f["lfs"], f["lfb"], 1e-6)
    want = one_pass.to(bf).float() @ f["wh"].float() + f["bh"]
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    k11_head = (tvit._layernorm(tok[:, 0], f["lfs"], f["lfb"], 1e-6).float()
                @ tp["head"]["kernel"] + tp["head"]["bias"])
    moved = _rel_norm(k11_head.numpy(), got[:, :10].numpy())
    assert 0.0 < moved < BF16_NORM


def test_patch_rows_is_the_padded_patchify():
    img = torch.from_numpy(_images(12, 2, 32))
    pp = tvs.patch_rows(img, 16, 8, torch.float32)
    assert pp.shape == (2, 8, 768)
    assert not pp[:, 0].any() and not pp[:, 5:].any()
    torch.testing.assert_close(pp[:, 1:5], tvit.patchify(img, 16),
                               rtol=0, atol=0)


def test_entry_points_raise_outside_their_gates():
    _, tcfg, _, tp = _pair(13, CARD_GEOM, dtype="bfloat16")
    img = torch.zeros((1, 32, 32, 3))
    for bad in (dataclasses.replace(tcfg, hidden_act="relu"),
                dataclasses.replace(tcfg, num_classes=0)):
        with pytest.raises(NotImplementedError):
            tvit.forward_latency_logits(tp, img, bad)
    with pytest.raises(NotImplementedError):
        tq.vit_forward_int8_latency_logits(
            tq.quantize_vit_fast(tp), torch.zeros((5, 32, 32, 3)), tcfg)


def test_wrappers_check_what_the_kernels_take():
    """The checks a CUDA call of K12 / K20 meets before it launches
    (device independent, so meta tensors reach them): they raise, no
    fallback."""
    posb = torch.empty((200, 768), device="meta")
    ok = torch.empty((4, 224, 224, 3), device="meta")
    assert tvs._full_geometry(ok, 12, posb, 3072, 16) == (197, 200, 768, 768)
    for images, heads, rows, patch in (
            (torch.empty((5, 224, 224, 3), device="meta"), 12, 200, 16),
            (ok, 6, 200, 16),                                 # head dim 128
            (torch.empty((1, 224, 224, 3), device="meta"), 12, 200, 14),
            (ok, 12, 192, 16),                                # posb short
            (torch.empty((1, 220, 224, 3), device="meta"), 12, 200, 16)):
        with pytest.raises(ValueError):
            tvs._full_geometry(images, heads,
                               torch.empty((rows, 768), device="meta"),
                               3072, patch)
    with pytest.raises(ValueError):
        tvs.vit_full(ok, None, posb, {}, None, None, None, None, 12, 16)
    with pytest.raises(ValueError, match="vit_layers_int8_static"):
        tvs.vit_full_int8(ok, None, None, posb, {"inv_ao": None}, None, None,
                          None, None, None, 12, 16)


@pytest.mark.parametrize("int8", [False, True])
def test_image_server_serves_the_single_launch_forward(int8):
    if int8:
        _, tcfg, _, tree = _int8_pair(14, CARD_GEOM)
        fwd = tq.make_forward_int8_latency(tcfg, tree, device="cpu",
                                           full=True)
        direct = tq.vit_forward_int8_latency_logits
    else:
        _, tcfg, _, tree = _pair(14, CARD_GEOM, dtype="bfloat16")
        fwd = tvit.make_forward_latency(tcfg, tree, device="cpu", full=True)
        direct = tvit.forward_latency_logits
    rng = np.random.default_rng(15)
    imgs = [rng.integers(0, 256, (32, 32, 3), np.uint8) for _ in range(3)]
    with ImageServer(fwd, image_size=32, batch_size=1,
                     device="cpu") as server:
        results = [server.submit_raw(im).result(timeout=60) for im in imgs]
        assert server.served == 3 and server.batches == 3
    want = direct(tree, tvit.preprocess(torch.from_numpy(np.stack(imgs)),
                                        tcfg), tcfg).numpy()
    for got, w in zip(results, want):
        assert got.shape == (10,)
        np.testing.assert_allclose(got, w, rtol=1e-6, atol=1e-6)
