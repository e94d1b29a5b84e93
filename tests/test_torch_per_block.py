"""The port's per-block encoder dispatch against the JAX package's: the
routing table (chain, fused attention half, MLP route, int8 block fit)
against the JAX planners over every variant and size, the ViT-B/16 1024 px
forwards (4097 tokens: flash attention) in bf16 and dynamic int8 against
the JAX CPU forwards, the explicit attention and MLP impls against JAX
forwards whose Pallas kernels run in interpret mode, and the per-tensor
int8 ViT forward against the JAX one."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_fpga_tpu.models import quantized as jq
from vit_fpga_tpu.models import vit as jvit
from vit_fpga_tpu.ops import attention as jatt
from vit_fpga_tpu.ops import flash_attention as jfa
from vit_fpga_tpu.ops import fused_mlp as jfm
from vit_fpga_tpu_torch.models import quantized as tq
from vit_fpga_tpu_torch.models import vit as tvit
from vit_fpga_tpu_torch.models.convert import params_from_numpy
from vit_fpga_tpu_torch.ops import attention as tatt
from vit_fpga_tpu_torch.ops import attn_block as tab
from vit_fpga_tpu_torch.ops import quant as tquant
from vit_fpga_tpu_torch.ops import quant_fused as tqf
from vit_fpga_tpu_torch.runtime.serving import ImageServer

SIZES = (224, 384, 512, 768, 896, 1024)
BATCHES = (1, 2, 64)
# bf16 logits against the JAX CPU forward, relative to the largest logit:
# a few bf16 ulps per layer (test_torch_vit.py's full-width band).  The
# port runs the TPU's route (flash attention with p rounded against the
# running max, K5's fused MLP), the JAX CPU forward the XLA one (exact
# softmax, unfused MLP); both round to bf16 at the same points otherwise.
BF16_BAND = 3e-2
F32_BAND = 1e-4
# int8 against the JAX CPU forward (test_torch_int8.py's LOOSE band): the
# same per-linear route on both sides, the attention flash on the port's
# and exact on the JAX CPU's; a flipped rint moves a whole int8 step.
INT8_BAND = 0.05


def _perturbed(jcfg, seed):
    """vit.init_params perturbed by 0.02 * normal noise, so the zero-init
    biases, LN params and CLS token carry signal."""
    rng = np.random.default_rng(seed)
    params = jvit.init_params(jax.random.key(0), jcfg)
    return jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.02 * rng.normal(size=p.shape).astype(
            np.float32), params)


def _pair(seed, **kw):
    jcfg, tcfg = jvit.ViTConfig(**kw), tvit.ViTConfig(**kw)
    np_params = _perturbed(jcfg, seed)
    return (jcfg, tcfg, jax.tree_util.tree_map(jnp.asarray, np_params),
            params_from_numpy(np_params, device="cpu"))


def _images(seed, b, s):
    return np.random.default_rng(seed).integers(0, 256, (b, s, s, 3),
                                                np.uint8)


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


# ---------------------------------------------------------------------------
# The routing table
# ---------------------------------------------------------------------------

def _jax_mlp_route(jcfg, rows):
    """The JAX ``_block``'s MLP decision on a TPU (models/vit.py:278-321),
    from its own planners."""
    itemsize = 2 if jcfg.dtype == "bfloat16" else 4
    d, m = jcfg.hidden_dim, jcfg.mlp_dim
    impl, n_chunks = jcfg.mlp_impl, 1
    if impl == "auto":
        n_chunks = jfm.mlp_weight_chunks(d, m, itemsize)
        if (n_chunks > 1 and itemsize == 2 and rows >= 32768
                and jfm.mlp_fits_raised(d, m, itemsize)):
            n_chunks = 1
        impl = "pallas" if n_chunks == 1 else "xla"
    elif impl == "pallas":
        n_chunks = jfm.mlp_weight_chunks(d, m, itemsize)
        if n_chunks == 0:
            impl = "xla"
    act = jcfg.hidden_act
    if act == "gelu" and itemsize == 2:
        act = "gelu_tanh"
    if impl == "pallas" and act == "gelu":
        impl = "xla"
    return (impl, n_chunks) if impl == "pallas" else ("xla", 0)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("variant", sorted(tvit.VARIANTS))
def test_routing_table_matches_jax(variant, dtype, monkeypatch):
    """For every size in SIZES and batch in BATCHES: the stats chain, the
    fused attention half, the MLP route (K5, K6 with n chunks, or the
    plain MLP, under "auto" and "pallas") and the int8 block fit are the
    JAX planners' decisions, the JAX ones evaluated as on a TPU."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    for size in SIZES:
        jcfg = jvit.config(variant, image_size=size, dtype=dtype)
        tcfg = tvit.config(variant, image_size=size, dtype=dtype)
        where = f"{variant}@{size} {dtype}"
        assert tvit._attn_block_fits(tcfg) == jvit._attn_block_fits(jcfg), \
            where
        assert (tvit._attn_route(tcfg) == "block") == \
            jvit._attn_block_fits(jcfg), where
        assert tq._int8_block_fits(tcfg) == jq._int8_block_fits(jcfg), where
        for batch in BATCHES:
            assert (tvit._stats_chain_supported(tcfg, batch)
                    == jvit._stats_chain_supported(jcfg, batch)), \
                (where, batch)
            rows = batch * tvit._n_pad(tcfg)
            for impl in ("auto", "pallas"):
                assert (tvit._mlp_route(dataclasses.replace(
                    tcfg, mlp_impl=impl), rows) == _jax_mlp_route(
                    dataclasses.replace(jcfg, mlp_impl=impl), rows)), \
                    (where, batch, impl)


def test_routing_at_1024_px_and_the_explicit_impls():
    """ViT-B/16 at 1024 px leaves the chain and the fused half (flash
    attention, K5); its int8 blocks take the per-linear route.  Explicit
    attention impls leave the chain; CLIP ViT-L/14 at an odd batch leaves
    it too (q-slot reuse on the TPU), at an even one it stays."""
    b1024 = tvit.config("vit_b16", image_size=1024)
    assert not tvit._stats_chain_supported(b1024, 2)
    assert tvit._attn_route(b1024) == "unfused"
    assert tvit._mlp_route(b1024, 2 * 4104) == ("pallas", 1)
    assert not tq._int8_block_fits(b1024)
    b224 = tvit.config("vit_b16")
    assert tvit._stats_chain_supported(b224, 64)
    for impl in ("flash", "xla"):
        cfg = dataclasses.replace(b224, attn_impl=impl)
        assert not tvit._stats_chain_supported(cfg, 64)
        assert tvit._attn_route(cfg) == "unfused"
    assert not tvit._stats_chain_supported(
        dataclasses.replace(b224, mlp_impl="xla"), 64)
    l14 = tvit.config("vit_l14")
    assert not tvit._stats_chain_supported(l14, 63)
    assert tvit._stats_chain_supported(l14, 64)
    assert tvit._mlp_route(dataclasses.replace(
        tvit.config("vit_l16"), mlp_impl="pallas"), 8 * 200) == ("pallas", 2)
    assert tvit._mlp_route(dataclasses.replace(
        tvit.config("vit_h14"), mlp_impl="pallas"), 8 * 264) == ("pallas", 4)
    with pytest.raises(ValueError):
        tvit._attn_route(dataclasses.replace(b224, attn_impl="bogus"))


@pytest.mark.parametrize("variant,size,n_valid", [("vit_l14", 224, 257),
                                                   ("vit_b16", 384, 577)])
def test_odd_batch_size_takes_the_fused_half_past_256_keys(
        variant, size, n_valid, monkeypatch):
    """ImageServer pads to the caller's batch_size, so batch_size 1 runs
    the forward at batch 1: there the JAX plan reuses q slots, and CLIP
    ViT-L/14 and ViT-B/16 @384 leave the stats chain for the fused
    attention half (K4) past 256 keys.  The route, and the card's gates:
    K4 and its backward K23 (both tiled over the keys) take these
    lengths, up to 1024 tokens.  At batch_size 2 the chain stays."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    cfg = tvit.config(variant, image_size=size, dtype="bfloat16")
    jcfg = jvit.config(variant, image_size=size, dtype="bfloat16")
    assert cfg.seq_len == n_valid > 256
    assert not tvit._stats_chain_supported(cfg, 1)
    assert not jvit._stats_chain_supported(jcfg, 1)
    assert tvit._stats_chain_supported(cfg, 2)
    assert tvit._attn_route(cfg) == "block"

    cfg1 = dataclasses.replace(cfg, depth=1)
    params = tvit.init_params(cfg1, torch.Generator().manual_seed(0),
                              device="cpu")
    fused = _spy(monkeypatch, tvit, "attn_block")
    chain = _spy(monkeypatch, tvit, "attn_block_stats")
    fwd = tvit.make_forward(cfg1, params, device="cpu")
    with ImageServer(fwd, image_size=size, batch_size=1,
                     device="cpu") as server:
        out = server.submit_raw(_images(60, 1, size)[0]).result(timeout=120)
    assert np.isfinite(out).all()
    assert [s[0] for s in fused] == [1] and not chain
    x = torch.zeros(1, tvit._n_pad(cfg), cfg.hidden_dim, dtype=torch.bfloat16)
    for kernel in ("K4", "K23"):
        assert tab._cuda_geometry(x, cfg.num_heads, n_valid,
                                  kernel=kernel) == (
            1, tvit._n_pad(cfg), cfg.hidden_dim, n_valid)


# ---------------------------------------------------------------------------
# ViT-B/16 at 1024 px: 4097 tokens through flash attention
# ---------------------------------------------------------------------------

def _spy(monkeypatch, module, name):
    calls = []
    fn = getattr(module, name)

    def wrapped(*a, **k):
        calls.append(a[0].shape)
        return fn(*a, **k)

    monkeypatch.setattr(module, name, wrapped)
    return calls


def test_vit_b16_1024_bf16_matches_jax(monkeypatch):
    """ViT-B/16 at full width, 1024 px (4097 tokens on 4104 rows), depth
    1, b1, bf16: LN -> QKV -> flash attention (bq 512, bk 128) -> out-proj
    -> K5, against the JAX CPU forward, in the bf16 band, top-1 equal."""
    kw = dict(tvit.VARIANTS["vit_b16"], depth=1)
    jcfg, tcfg, jp, tp = _pair(21, image_size=1024, **kw)
    img = _images(22, 1, 1024)
    flash = _spy(monkeypatch, tatt, "flash_attention")
    want = np.asarray(jax.jit(lambda p, i: jvit.forward_raw(p, i, jcfg))(
        jp, jnp.asarray(img)))
    got = tvit.make_forward(tcfg, tp, device="cpu")(img).numpy()
    assert got.shape == (1, 1000)
    assert [tuple(s) for s in flash] == [(1, 12, 4104, 64)]
    assert _rel(got, want) < BF16_BAND
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))


def test_vit_b16_1024_int8_matches_jax(monkeypatch):
    """The dynamic int8 forward at 1024 px, depth 1, b1: the per-linear
    route (4 K14 per layer + the K14 head, flash attention) against the
    JAX CPU forward (its per-linear route), in the int8 band, top-1
    equal."""
    kw = dict(tvit.VARIANTS["vit_b16"], depth=1)
    jcfg, tcfg, jp, tp = _pair(23, image_size=1024, **kw)
    img = _images(24, 1, 1024)
    jqp, tqp = jq.quantize_vit_fast(jp), tq.quantize_vit_fast(tp)
    lin = _spy(monkeypatch, tq, "int8_linear_fused")
    flash = _spy(monkeypatch, tatt, "flash_attention")
    want = np.asarray(jq.vit_forward_int8_raw(jqp, jnp.asarray(img), jcfg))
    got = tq.make_forward_int8(tcfg, tqp, device="cpu")(img).numpy()
    assert len(lin) == 5 and len(flash) == 1
    assert _rel(got, want) < INT8_BAND
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))


@pytest.mark.parametrize("scores", [False, True],
                         ids=["static", "int8_scores"])
def test_static_tree_past_the_block_kernels_matches_jax(monkeypatch, scores):
    """A calibrated static tree at 1024 px, depth 1, b1, where the int8
    block kernels do not fit: the JAX ``*_ref`` blocks (the int8-scores
    attention's with the switch on), each run once, against the JAX CPU
    forward (its ``*_ref`` route) in the int8 band, top-1 equal.  The JAX
    tree (calibrated on one image) is handed to the port leaf for leaf."""
    kw = dict(tvit.VARIANTS["vit_b16"], depth=1)
    jcfg, tcfg, jp, _ = _pair(25, image_size=1024, **kw)
    assert not tq._int8_block_fits(tcfg)
    probe = jvit.preprocess(jnp.asarray(_images(26, 1, 1024)), jcfg)
    jqp = jq.quantize_vit_static(jp, jcfg, images=probe)
    tqp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jqp),
                            device="cpu")
    monkeypatch.setattr(jq, "_INT8_SCORES", scores)
    monkeypatch.setattr(tq, "_INT8_SCORES", scores)
    attn = ("attn_block_int8s_static_ref" if scores
            else "attn_block_int8_static_ref")
    calls = {name: _spy(monkeypatch, tq, name)
             for name in (attn, "mlp_block_int8_static_ref")}
    img = _images(27, 1, 1024)
    want = np.asarray(jq.vit_forward_int8_raw(jqp, jnp.asarray(img), jcfg))
    got = tq.make_forward_int8(tcfg, tqp, device="cpu")(img).numpy()
    assert {k: len(v) for k, v in calls.items()} == {
        attn: 1, "mlp_block_int8_static_ref": 1}
    assert _rel(got, want) < INT8_BAND
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))


# ---------------------------------------------------------------------------
# Explicit impls at small widths, depth 2
# ---------------------------------------------------------------------------

SMALL = dict(image_size=192, patch_size=8, hidden_dim=128, depth=2,
             num_heads=2, mlp_dim=256, num_classes=10, hidden_act="gelu_tanh")


def _interpret_jax(monkeypatch):
    """The JAX package's Pallas kernels that an explicit impl reaches, in
    interpret mode (on the CPU they run nowhere else)."""
    for mod, name in ((jatt, "mha_qkv_pallas"), (jfa, "flash_attention"),
                      (jfm, "fused_mlp_pallas"),
                      (jfm, "fused_mlp_chunked_pallas")):
        monkeypatch.setattr(mod, name, functools.partial(
            getattr(mod, name), interpret=True))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("route", ["flash+k5", "k7+k6", "xla+xla"])
def test_explicit_impls_match_jax(route, dtype, monkeypatch):
    """577 tokens, 2 heads of 64, depth 2: attn_impl="flash" with K5;
    attn_impl="pallas" where the fused half does not fit (forced on both
    sides) with K6 in 2 chunks (forced on both sides); and "xla" for both.
    The patchify embed runs on both sides (impls other than auto /
    pallas); f32 within 1e-4, bf16 within the bf16 band."""
    _interpret_jax(monkeypatch)
    attn, mlp = {"flash+k5": ("flash", "pallas"),
                 "k7+k6": ("pallas", "pallas"),
                 "xla+xla": ("xla", "xla")}[route]
    if route == "k7+k6":
        for mod in (jvit, tvit):
            monkeypatch.setattr(mod, "_attn_block_fits", lambda cfg: False)
        monkeypatch.setattr(jfm, "mlp_weight_chunks", lambda *a, **k: 2)
        monkeypatch.setattr(tvit, "mlp_weight_chunks", lambda *a, **k: 2)
    jcfg, tcfg, jp, tp = _pair(31, dtype=dtype, attn_impl=attn,
                               mlp_impl=mlp, **SMALL)
    img = _images(32, 2, 192)
    want = np.asarray(jvit.forward_raw(jp, jnp.asarray(img), jcfg))
    got = tvit.make_forward(tcfg, tp, device="cpu")(img).numpy()
    assert _rel(got, want) < (BF16_BAND if dtype == "bfloat16"
                              else F32_BAND)


# ---------------------------------------------------------------------------
# The per-tensor int8 ViT forward
# ---------------------------------------------------------------------------

def test_quantize_vit_matches_jax():
    """The per-tensor tree: the same int8 weights and scales, bit for
    bit."""
    kw = dict(image_size=32, patch_size=8, hidden_dim=128, depth=2,
              num_heads=2, mlp_dim=256, num_classes=10)
    _, _, jp, tp = _pair(41, **kw)
    jt, tt = jq.quantize_vit(jp), tq.quantize_vit(tp)
    for k in ("wqkv", "wo", "w1", "w2"):
        np.testing.assert_array_equal(tt["blocks"][k + "_q"].numpy(),
                                      np.asarray(jt["blocks"][k + "_q"]))
        np.testing.assert_array_equal(tt["blocks"][k + "_s"].numpy(),
                                      np.asarray(jt["blocks"][k + "_s"]))
    for k in ("patch_embed", "head"):
        np.testing.assert_array_equal(tt[k]["wq"].numpy(),
                                      np.asarray(jt[k]["wq"]))
        assert float(tt[k]["sw"]) == float(jt[k]["sw"])


def test_vit_forward_int8_matches_jax():
    """``vit_forward_int8`` at ViT-B/16 width, 224 px, depth 2, b2 (f32,
    K13 linears, K7 in f32 on 197 tokens) against the JAX
    ``vit_forward_int8`` on the CPU (XLA int8 linears, the XLA softmax):
    the integer sums are exact on both sides, so only f32 roundings that
    flip a rint separate them.  At depth 1 the two agree to 1e-7; from
    depth 2 on a flipped rint moves a whole per-tensor step (1/127 of the
    tensor's absmax): the JAX forward against itself on inputs moved by
    1e-7 reads 0.9% of the largest logit, the port 1.9%.  Band: the int8
    band (5%), top-1 equal."""
    kw = dict(tvit.VARIANTS["vit_b16"], depth=2)
    jcfg, tcfg, jp, tp = _pair(43, dtype="float32", **kw)
    img = _images(44, 2, 224)
    x = np.array(jvit.preprocess(jnp.asarray(img), jcfg))
    want = np.asarray(jq.jit_vit_forward_int8(jcfg)(jq.quantize_vit(jp),
                                                     jnp.asarray(x)))
    fwd = tq.make_vit_forward_int8(tcfg, tq.quantize_vit(tp), raw=False,
                                   device="cpu")
    got = fwd(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 1000)
    assert _rel(got, want) < INT8_BAND
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))


def test_vit_forward_int8_routes_and_serves(monkeypatch):
    """50 K13 GEMMs per batch at depth 12 would be 1 + 4 depth + 1: here
    depth 2 gives 10 ``int8_linear`` calls and 2 f32 K7 calls; the forward
    serves through ImageServer, and a headless tree returns f32 CLS
    features."""
    kw = dict(image_size=32, patch_size=8, hidden_dim=128, depth=2,
              num_heads=2, mlp_dim=256, num_classes=10)
    _, tcfg, _, tp = _pair(45, dtype="float32", **kw)
    qp = tq.quantize_vit(tp)
    lin = _spy(monkeypatch, tquant, "int8_linear")
    k7 = _spy(monkeypatch, tatt, "mha_qkv_pallas")
    fwd = tq.make_vit_forward_int8(tcfg, qp, device="cpu")
    imgs = [_images(46 + i, 1, 32)[0] for i in range(5)]
    direct = fwd(np.stack(imgs[:4])).numpy()
    assert len(lin) == 10 and len(k7) == 2
    assert all(s[-1] == 384 and tuple(s[:2]) == (4, 17) for s in k7)
    with ImageServer(fwd, image_size=32, batch_size=4,
                     device="cpu") as server:
        futs = [server.submit_raw(im) for im in imgs]
        results = [f.result(timeout=60) for f in futs]
    for got, want in zip(results[:4], direct):
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    headless = {k: v for k, v in qp.items() if k != "head"}
    feats = tq.make_vit_forward_int8(tcfg, headless, device="cpu")(
        np.stack(imgs[:2]))
    assert feats.dtype == torch.float32 and feats.shape == (2, 128)
    assert tqf.int8_linear_fused.launches == 0
