"""The port's dynamic int8 serving path (models/quantized.py, plain K14 /
K15 / K16 on the CPU) against the JAX package: the parameter bridge, the
int8 tree, the forward against a JAX composition of the Pallas kernels in
interpret mode (tight) and against the JAX CPU forward (loose), and
serving through ImageServer."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_fpga_tpu.models import quantized as jq
from vit_fpga_tpu.models import vit as jvit
from vit_fpga_tpu.ops import quant_block as jqb
from vit_fpga_tpu.ops.patch_embed import embed_tokens_dotg as jax_embed
from vit_fpga_tpu.ops.quant_fused import int8_linear_fused as jax_linear
from vit_fpga_tpu_torch.models import quantized as tq
from vit_fpga_tpu_torch.models import vit as tvit
from vit_fpga_tpu_torch.models.convert import (params_from_numpy,
                                               params_to_numpy)
from vit_fpga_tpu_torch.ops import quant_block as tqb
from vit_fpga_tpu_torch.runtime.serving import ImageServer

TINY = dict(image_size=32, patch_size=8, hidden_dim=64, depth=2,
            num_heads=4, mlp_dim=128, num_classes=10)
N_PAD = 24          # 17 tokens on rows padded to a multiple of 8
# The tight check: the same kernel bodies on both sides, in f32.  Only
# the order of f32 sums differs (LN statistics, the bf16 PV product), so
# now and then a bf16 rounding of the attention output lands one ulp
# apart, and the layers after it carry that on: the bf16 logits then
# differ by an ulp or two of the largest logit (2 seen).  Allow 4 ulps:
# 2^-6 of the largest logit.
TIGHT = 2.0 ** -6
# The loose check against the JAX CPU forward, which takes the per-linear
# route: two-pass LN inside each linear, the exact softmax, and h rounded
# to bf16 before its row quantization.  Each of those moves some int8
# steps per layer; 5% of the largest logit covers two layers of it (the
# observed gap is 1.3%), and top-1 must agree.
LOOSE = 0.05


def _np_params(jcfg, seed):
    """vit.init_params perturbed by 0.02 * normal noise, so the zero-init
    biases, LN params and CLS token carry signal."""
    rng = np.random.default_rng(seed)
    params = jvit.init_params(jax.random.key(0), jcfg)
    return jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.02 * rng.normal(size=p.shape).astype(
            np.float32), params)


def _pair(seed, **kw):
    cfg_kw = {**TINY, **kw}
    jcfg = jvit.ViTConfig(**cfg_kw)
    tcfg = tvit.ViTConfig(**cfg_kw)
    np_params = _np_params(jcfg, seed)
    jqp = jq.quantize_vit_fast(jax.tree_util.tree_map(jnp.asarray, np_params))
    tqp = tq.quantize_vit_fast(params_from_numpy(np_params, device="cpu"))
    return jcfg, tcfg, jqp, tqp


def _images(seed, b=3, s=32):
    return np.random.default_rng(seed).integers(0, 256, (b, s, s, 3),
                                                np.uint8)


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], f"{prefix}{k}.")
        else:
            yield prefix + k, tree[k]


def test_bridge_keeps_int8_leaves():
    tree = {"wq": np.array([[-127, 5], [127, 0]], np.int8),
            "ws": np.array([0.5, 2.0], np.float32),
            "nested": {"b": np.arange(3, dtype=np.float64)}}
    out = params_from_numpy(tree, device="cpu", dtype=torch.bfloat16)
    assert out["wq"].dtype == torch.int8
    assert out["wq"].tolist() == [[-127, 5], [127, 0]]
    assert out["ws"].dtype == torch.bfloat16
    assert out["nested"]["b"].dtype == torch.bfloat16
    back = params_to_numpy(out)
    assert back["wq"].dtype == np.int8 and back["ws"].dtype == np.float32
    np.testing.assert_array_equal(back["wq"], tree["wq"])
    with pytest.raises(ValueError):
        params_from_numpy({"w": np.array([300], np.int32)}, device="cpu")


def test_quantize_vit_fast_equals_the_jax_tree():
    _, _, jqp, tqp = _pair(0)
    handed = params_from_numpy(jax.tree_util.tree_map(np.asarray, jqp),
                               device="cpu")
    mine, theirs = dict(_leaves(tqp)), dict(_leaves(handed))
    assert mine.keys() == theirs.keys()
    for name, leaf in mine.items():
        assert leaf.dtype == theirs[name].dtype, name
        assert torch.equal(leaf, theirs[name]), name
    assert mine["blocks.w1_q"].dtype == torch.int8
    assert mine["blocks.w1_q"].shape == (2, 64, 128)


def _jax_composition(jqp, images, jcfg, n_pad=N_PAD):
    """The TPU branch of the JAX ``vit_forward_int8_fast`` written out:
    the dotg embed on bf16(wq * ws) onto ``n_pad`` rows, then per layer
    attn_block_int8 -> mlp_block_int8 in interpret mode, the CLS LayerNorm
    and the fused int8 head in interpret mode."""
    n, d = jcfg.seq_len, jcfg.hidden_dim
    act = "quick_gelu" if jcfg.hidden_act == "quick_gelu" else "gelu_tanh"
    x = jvit.preprocess(jnp.asarray(images), jcfg).astype(jnp.bfloat16)
    pe = jqp["patch_embed"]
    pos, pre = jqp["pos_embed"][0], jqp["cls_token"][0]
    posb = jnp.concatenate([pre + pos[:1], pos[1:] + pe["b"],
                            jnp.zeros((n_pad - n, d))], axis=0)
    wp = (pe["wq"].astype(jnp.float32) * pe["ws"]).astype(jnp.bfloat16)
    x = jax_embed(x, wp, posb, jcfg.patch_size, 1)
    b = x.shape[0]
    for i in range(jcfg.depth):
        blk = jax.tree_util.tree_map(lambda a: a[i], jqp["blocks"])
        x = jqb.attn_block_int8(
            x, blk["ln1_scale"], blk["ln1_bias"], blk["wqkv_q"],
            blk["wqkv_s"], blk["bqkv"], blk["wo_q"], blk["wo_s"], blk["bo"],
            jcfg.num_heads, eps=jcfg.ln_eps, n_valid=n, interpret=True)
        x = jqb.mlp_block_int8(
            x.reshape(b * n_pad, d), blk["ln2_scale"], blk["ln2_bias"],
            blk["w1_q"], blk["w1_s"], blk["b1"], blk["w2_q"], blk["w2_s"],
            blk["b2"], eps=jcfg.ln_eps, act=act, block_t=32,
            interpret=True).reshape(b, n_pad, d)
    cls = jvit._layernorm(x[:, :1], jqp["ln_f_scale"], jqp["ln_f_bias"],
                          jcfg.ln_eps)
    hd = jqp["head"]
    out = jax_linear(cls.reshape(b, d), hd["wq"], hd["ws"], hd["b"],
                     interpret=True)
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("hidden_act", ["gelu", "quick_gelu"])
def test_int8_forward_matches_jax_kernel_composition(hidden_act):
    jcfg, tcfg, jqp, tqp = _pair(1, hidden_act=hidden_act)
    img = _images(2)
    want = _jax_composition(jqp, img, jcfg)
    got = tq.make_forward_int8(tcfg, tqp, device="cpu")(img)
    assert got.dtype == torch.float32 and got.shape == (3, 10)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=TIGHT * np.abs(want).max())


def test_int8_forward_past_256_tokens_matches_jax_kernel_composition(
        monkeypatch):
    """A 384-px-like geometry: 577 tokens (24 x 24 patches and the CLS
    row, ViT-B/16 @384's count) on 584 rows, head dim 64, two narrow
    layers.  The JAX planner keeps the int8 block kernels there, and so
    does the port: every attention half is K16 (attn_block_int8), inside
    the gate the card applies, and the logits hold to the JAX composition
    of the Pallas kernels as tightly as at 17 tokens."""
    kw = dict(image_size=192, hidden_dim=128, num_heads=2, mlp_dim=256)
    jcfg, tcfg, jqp, tqp = _pair(14, **kw)
    assert tcfg.seq_len == 577 and jq._int8_block_fits(jcfg)
    assert tq._int8_block_fits(tcfg)
    shapes = []

    def k16(x, *args, n_valid=None, **kwargs):
        shapes.append((tuple(x.shape), n_valid))
        tqb.attn_int8_geometry(*x.shape, args[-1], n_valid)
        return tqb.attn_block_int8(x, *args, n_valid=n_valid, **kwargs)

    monkeypatch.setattr(tq, "attn_block_int8", k16)
    img = _images(15, b=2, s=192)
    want = _jax_composition(jqp, img, jcfg, n_pad=584)
    got = tq.make_forward_int8(tcfg, tqp, device="cpu")(img)
    assert shapes == [((2, 584, 128), 577)] * 2
    assert got.shape == (2, 10) and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=TIGHT * np.abs(want).max())


def test_int8_forward_holds_to_the_jax_cpu_forward():
    jcfg, tcfg, jqp, tqp = _pair(3)
    img = _images(4, b=4)
    want = np.asarray(jq.vit_forward_int8_raw(jqp, jnp.asarray(img), jcfg))
    got = tq.make_forward_int8(tcfg, tqp, device="cpu")(img).numpy()
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= LOOSE * scale
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))


def test_int8_forward_computes_in_bf16_whatever_cfg_dtype():
    _, tcfg, _, tqp = _pair(5)
    img = _images(6, b=2)
    f32 = dataclasses.replace(tcfg, dtype="float32")
    a = tq.make_forward_int8(tcfg, tqp, device="cpu")(img)
    b = tq.make_forward_int8(f32, tqp, device="cpu")(img)
    assert torch.equal(a, b)


def test_int8_forward_headless_returns_cls_features():
    jcfg, tcfg, jqp, tqp = _pair(7)
    jqp = {k: v for k, v in jqp.items() if k != "head"}
    tqp = {k: v for k, v in tqp.items() if k != "head"}
    img = _images(8, b=2)
    want = np.asarray(jq.vit_forward_int8_raw(jqp, jnp.asarray(img), jcfg))
    got = tq.make_forward_int8(tcfg, tqp, device="cpu")(img)
    assert got.dtype == torch.float32 and got.shape == (2, 64)
    assert np.abs(got.numpy() - want).max() <= LOOSE * np.abs(want).max()


def test_image_server_serves_the_int8_forward():
    _, tcfg, _, tqp = _pair(9)
    fwd = tq.make_forward_int8(tcfg, tqp, device="cpu")
    rng = np.random.default_rng(10)
    imgs = [rng.integers(0, 256, (32, 32, 3), np.uint8) for _ in range(7)]
    with ImageServer(fwd, image_size=32, batch_size=4,
                     device="cpu") as server:
        futs = [server.submit_raw(im) for im in imgs]
        results = [f.result(timeout=60) for f in futs]
        assert server.served == 7
    direct = fwd(np.stack(imgs)).numpy()
    for got, want in zip(results, direct):
        assert got.shape == (10,)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_static_tree_and_remat_raise():
    """A JAX quantize_vit_static tree (calibrated on a real batch) serves
    through the static kernels' plain versions and holds to the JAX CPU
    forward on it; remat still raises, on either tree."""
    jcfg, tcfg, _, tqp = _pair(11)
    static = jq.quantize_vit_static(
        jax.tree_util.tree_map(jnp.asarray, _np_params(jcfg, 11)), jcfg,
        images=jnp.asarray(np.random.default_rng(12).normal(
            size=(2, 32, 32, 3)), jnp.float32))
    handed = params_from_numpy(jax.tree_util.tree_map(np.asarray, static),
                               device="cpu")
    img = _images(12, b=4)
    want = np.asarray(jq.vit_forward_int8_raw(static, jnp.asarray(img), jcfg))
    got = tq.make_forward_int8(tcfg, handed, device="cpu")(img).numpy()
    assert np.abs(got - want).max() <= LOOSE * np.abs(want).max()
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))
    for tree in (tqp, handed):
        with pytest.raises(NotImplementedError):
            tq.make_forward_int8(dataclasses.replace(tcfg, remat=True), tree,
                                 device="cpu")


def test_make_forward_int8_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, tcfg, _, tqp = _pair(13)
    with pytest.raises(RuntimeError):
        tq.make_forward_int8(tcfg, tqp)
