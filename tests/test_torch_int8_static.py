"""The port's calibrated static-scale int8 serving path (utils/calibrate.py,
models/quantized.quantize_vit_static, the plain K17 / K18 / K19b on the
CPU) against the JAX package: the calibration probe, the fold of the
scales into the tree, each kernel's plain version against the Pallas
kernel in interpret mode (quiet and saturating), the throughput and
latency forwards, the accuracy gates of tests/test_int8_static.py on the
port's own calibration, and serving through ImageServer."""

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
from vit_fpga_tpu.ops import quant_block as jqb
from vit_fpga_tpu.ops.patch_embed import embed_tokens_dotg as jax_embed
from vit_fpga_tpu.ops.quant_fused import quantize_weight_colwise
from vit_fpga_tpu.utils import calibrate as jcal
from vit_fpga_tpu_torch.models import quantized as tq
from vit_fpga_tpu_torch.models import vit as tvit
from vit_fpga_tpu_torch.models.convert import params_from_numpy
from vit_fpga_tpu_torch.ops import quant_block as tqb
from vit_fpga_tpu_torch.ops import vit_stack as tvs
from vit_fpga_tpu_torch.ops.attn_block import _mha_tpu
from vit_fpga_tpu_torch.ops.quant_fused import QMAX, _int_matmul
from vit_fpga_tpu_torch.runtime.serving import ImageServer
from vit_fpga_tpu_torch.utils import calibrate as tcal

TINY = dict(image_size=32, patch_size=8, hidden_dim=64, depth=2,
            num_heads=4, mlp_dim=128, num_classes=10)
N_PAD = 24          # 17 tokens on rows padded to a multiple of 8
# The probe: the same ops and rounding points on both sides, the sums in
# another order.  f32: a few ulps of each absmax.  bf16: an ulp flip of a
# bf16 activation moves an absmax by up to 2^-8 and later layers carry it.
CALIB_F32 = 1e-5
CALIB_BF16 = 2e-2
# Kernel bodies op for op in f32; only the order of f32 sums differs (LN
# statistics, the bf16 PV product), which flips an occasional bf16 ulp or,
# on rare elements, an int8 rint: |a - b| <= 2^-6 (1 + |b|) + 2 steps, a
# step the last GEMM's one-int change 127 * (its folded column scale).
BF16_TOL = 2.0 ** -6
INT8_STEPS = 2
# The stack in relative norm: a flipped rint moves the next layer and the
# attention spreads it over every row (as for K19a).  Against the
# interpreted vit_layers_int8_static_pallas the gap is larger than the
# block kernels': XLA keeps the residual x + bf16(y) in f32 excess
# precision for the LN2 that follows it inside the jitted stack (the
# Pallas kernel and the port round it to bf16 first), which moves every
# row by a few int8 steps a layer (1-2% of the logits seen).
INT8_DEPTH_BAND = 0.03
# Clipped share a saturating case must reach, so the clamp is exercised.
MIN_CLIPPED = 1e-3
# The forward against a JAX composition of the interpret-mode kernels:
# the same kernel bodies, sums in another order; a few bf16 ulps of the
# largest logit.
TIGHT = 2.0 ** -5
# The forward against the JAX CPU forward (the *_ref route: two-pass LN,
# the exact softmax, f32 ao): 5% of the largest logit, equal top-1.
LOOSE = 0.05
# The latency forward against the JAX latency forward (tests/
# test_torch_latency.py's int8 band).
INT8_BAND = 0.06


def _np_params(jcfg, seed):
    """vit.init_params perturbed by 0.02 * normal noise, so the zero-init
    biases, LN params and CLS token carry signal."""
    rng = np.random.default_rng(seed)
    params = jvit.init_params(jax.random.key(0), jcfg)
    return jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.02 * rng.normal(size=p.shape).astype(
            np.float32), params)


def _cfgs(**kw):
    cfg_kw = {**TINY, **kw}
    return jvit.ViTConfig(**cfg_kw), tvit.ViTConfig(**cfg_kw)


def _pair(seed, **kw):
    """(jax cfg, port cfg, JAX f32 tree, port f32 tree)."""
    jcfg, tcfg = _cfgs(**kw)
    p = _np_params(jcfg, seed)
    return (jcfg, tcfg, jax.tree_util.tree_map(jnp.asarray, p),
            params_from_numpy(p, device="cpu"))


def _static_pair(seed, **kw):
    """The JAX quantize_vit_static tree (synthetic probe) and the same
    tree handed to the port, leaf for leaf."""
    jcfg, tcfg, jp, _ = _pair(seed, **kw)
    jqp = jq.quantize_vit_static(jp, jcfg)
    return jcfg, tcfg, jqp, params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jqp), device="cpu")


def _images(seed, b=3, s=32):
    return np.random.default_rng(seed).integers(0, 256, (b, s, s, 3),
                                                np.uint8)


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], f"{prefix}{k}.")
        else:
            yield prefix + k, tree[k]


def _bf16_pair(x):
    xj = jnp.asarray(x, jnp.bfloat16)
    return xj, torch.from_numpy(np.array(xj.astype(jnp.float32))).to(
        torch.bfloat16)


def _f32(v):
    return float(np.float32(v))


def _clipped(pre):
    """Share of the pre-rint int8 inputs (a sequence of tensors) that
    saturate: |v| > 127.5 rounds past 127."""
    hits = sum(int((v.abs() > 127.5).sum()) for v in pre)
    return hits / sum(v.numel() for v in pre)


def _within_steps(got, want, step):
    """Port output (torch) against a JAX or numpy reference in the int8
    band."""
    g = got.float().numpy()
    w = np.asarray(want).astype(np.float32)
    return bool(np.all(np.abs(g - w) <= BF16_TOL * (1.0 + np.abs(w))
                       + INT8_STEPS * step))


# ---------------------------------------------------------------------------
# Calibration and fold
# ---------------------------------------------------------------------------

def test_synthetic_batch_is_the_jax_batch():
    jcfg, tcfg = _cfgs()
    for kw in ({}, dict(batch=2, seed=3)):
        np.testing.assert_array_equal(
            tcal._synthetic_batch(tcfg, **kw).numpy(),
            np.asarray(jcal._synthetic_batch(jcfg, **kw)))


@pytest.mark.parametrize("dtype,tol", [("float32", CALIB_F32),
                                       ("bfloat16", CALIB_BF16)])
def test_activation_absmax_stats_match_jax(dtype, tol):
    jcfg, tcfg, jp, tp = _pair(0, dtype=dtype)
    want = jcal.activation_absmax_stats(jp, jcal._synthetic_batch(jcfg),
                                        jcfg)
    got = tcal.activation_absmax_stats(tp, tcal._synthetic_batch(tcfg), tcfg)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == np.float32 and got[k].shape == (2,)
        np.testing.assert_allclose(got[k], want[k], rtol=tol, err_msg=k)


@pytest.mark.parametrize("hot", [False, True])
def test_choose_softmax_mode_matches_jax(hot):
    """The score range and the mode; a checkpoint with 40x hotter q and k
    leaves the max-free window and routes to the exact softmax."""
    jcfg, tcfg, jp, tp = _pair(1, dtype="float32")
    if hot:
        jp = dict(jp, blocks=dict(jp["blocks"],
                                  wqkv=jp["blocks"]["wqkv"] * 40.0))
        tp = dict(tp, blocks=dict(tp["blocks"],
                                  wqkv=tp["blocks"]["wqkv"] * 40.0))
    want = jcal.choose_softmax_mode(jp, jcfg)
    got = tcal.choose_softmax_mode(tp, tcfg)
    assert got.mode == want.mode == ("safe" if hot else "maxfree")
    np.testing.assert_allclose([got.score_max, got.score_min],
                               [want.score_max, want.score_min], rtol=1e-5)
    np.testing.assert_allclose(got.per_layer_max, want.per_layer_max,
                               rtol=1e-5)
    assert tcal.calibrated_config(tp, tcfg).safe_softmax is hot


def test_fold_is_the_jax_tree_bit_for_bit():
    """Handed JAX's scales, the port's fold of its own quantize_vit_fast
    tree gives JAX's quantize_vit_static tree on every leaf, the
    int8-scores keys (K22) included."""
    jcfg, tcfg, jp, tp = _pair(2)
    sc = jcal.static_activation_scales(jp, jcfg)
    want = jq._fold_static_scales(jq.quantize_vit_fast(jp), sc, 127.0)
    got = tq._fold_static_scales(tq.quantize_vit_fast(tp), sc, QMAX)
    mine = dict(_leaves(got))
    theirs = dict(_leaves(jax.tree_util.tree_map(np.asarray, want)))
    assert mine.keys() == theirs.keys()
    assert {"blocks.inv_ao", "blocks.inv_ah", "blocks.wqkv_qs",
            "blocks.bqkv_qs", "blocks.sc_qk", "blocks.pv_fold"} <= mine.keys()
    for name, leaf in mine.items():
        np.testing.assert_array_equal(leaf.numpy(), theirs[name],
                                      err_msg=name)
        assert leaf.numpy().dtype == theirs[name].dtype, name


def test_quantize_vit_static_calibrates_as_jax():
    """The port's own calibration and fold: the int8 weights bit for bit,
    every folded float within the f32 probe band of JAX's."""
    jcfg, tcfg, jp, tp = _pair(3, dtype="float32")
    want = dict(_leaves(jax.tree_util.tree_map(
        np.asarray, jq.quantize_vit_static(jp, jcfg))))
    got = dict(_leaves(tq.quantize_vit_static(tp, tcfg)))
    assert got.keys() == want.keys()
    for name, leaf in got.items():
        if leaf.dtype == torch.int8:
            np.testing.assert_array_equal(leaf.numpy(), want[name])
        else:
            np.testing.assert_allclose(leaf.numpy(), want[name],
                                       rtol=CALIB_F32, err_msg=name)


# ---------------------------------------------------------------------------
# K17 and K18 plain versions against the interpret-mode Pallas kernels
# ---------------------------------------------------------------------------

def _mk(rng, shape, scale=0.1):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _hot(x, rng):
    """x with 2% of its elements 8x louder: past the quiet calibration."""
    return np.where(rng.random(x.shape) < 0.02, 8.0 * x, x).astype(
        np.float32)


def _mlp_case(act, hot, seed=0, t=40, d=64, m=128):
    """Inputs and folded arguments of K17, the scales calibrated on quiet
    inputs; ``hot`` feeds louder ones.  Returns (x, args, step, pre-rint
    int8 inputs)."""
    rng = np.random.default_rng(seed)
    x = _mk(rng, (t, d), 1.0)
    ls, lb = _mk(rng, (d,)) + 1.0, _mk(rng, (d,))
    w1q, w1s = quantize_weight_colwise(_mk(rng, (d, m)))
    w2q, w2s = quantize_weight_colwise(_mk(rng, (m, d)))
    b1, b2 = _mk(rng, (m,), 0.5), _mk(rng, (d,), 0.5)
    t_ = torch.from_numpy
    xn = tqb._ln_f32(t_(x), t_(ls), t_(lb), 1e-6)
    s_x = _f32(float(xn.abs().max()) / QMAX)
    h = tqb._apply_act(xn @ (t_(w1q).float() * t_(w1s)) + t_(b1), act)
    s_h = _f32(float(h.abs().max()) / QMAX)
    args = (np.float32(1.0 / s_h), ls / np.float32(s_x),
            lb / np.float32(s_x), w1q, w1s * np.float32(s_x), b1, w2q,
            w2s * np.float32(s_h), b2)
    if hot:
        x = _hot(x, rng)
    # the int8 inputs before rint, through the plain version's pieces
    xin = tqb._ln_f32(t_(x), t_(args[1]), t_(args[2]), 1e-6)
    hin = tqb._apply_act_scaled(
        _int_matmul(tqb._rint_i8(xin), t_(w1q)) * t_(args[4]) + t_(b1), act,
        float(args[0]))
    return x, args, 127.0 * args[7], (xin, hin)


@pytest.mark.parametrize("hot", [False, True])
@pytest.mark.parametrize("act", ["gelu_tanh", "quick_gelu", "relu"])
def test_mlp_block_int8_static_matches_pallas(act, hot):
    x, args, step, pre = _mlp_case(act, hot)
    assert (_clipped(pre) > MIN_CLIPPED) if hot else _clipped(pre) == 0.0
    xj, xt = _bf16_pair(x)
    want = jqb.mlp_block_int8_static(xj, *map(jnp.asarray, args), act=act,
                                     block_t=32, interpret=True)
    got = tqb.mlp_block_int8_static(xt, float(args[0]),
                                    *map(torch.from_numpy, args[1:]), act=act)
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    assert _within_steps(got, want, step)


def _attn_case(hot, seed=1, b=2, n=13, d=64, heads=4, n_valid=13):
    """Inputs and folded arguments of K18 (dh 16), the scales calibrated on
    quiet inputs; ``hot`` feeds louder ones.  Returns (x, args, step,
    pre-rint int8 inputs over the valid rows)."""
    rng = np.random.default_rng(seed)
    x = _mk(rng, (b, n, d), 1.0)
    ls, lb = _mk(rng, (d,)) + 1.0, _mk(rng, (d,))
    wqkvq, wqkvs = quantize_weight_colwise(_mk(rng, (d, 3 * d)))
    woq, wos = quantize_weight_colwise(_mk(rng, (d, d)))
    bqkv, bo = _mk(rng, (3 * d,), 0.2), _mk(rng, (d,), 0.2)
    t_ = torch.from_numpy
    xn = tqb._ln_f32(t_(x), t_(ls), t_(lb), 1e-6)
    s_x = _f32(float(xn[:, :n_valid].abs().max()) / QMAX)
    qkv = (xn @ (t_(wqkvq).float() * t_(wqkvs)) + t_(bqkv)).to(torch.bfloat16)
    ao = _mha_tpu(qkv, heads, n_valid).float()[:, :n_valid]
    s_ao = _f32(float(ao.abs().max()) / QMAX)
    args = (np.float32(1.0 / s_ao), ls / np.float32(s_x),
            lb / np.float32(s_x), wqkvq, wqkvs * np.float32(s_x), bqkv, woq,
            wos * np.float32(s_ao), bo)
    if hot:
        x = _hot(x, rng)
    xin = tqb._ln_f32(t_(x), t_(args[1]), t_(args[2]), 1e-6)
    qkv = (_int_matmul(tqb._rint_i8(xin), t_(wqkvq)) * t_(args[4])
           + t_(bqkv)).to(torch.bfloat16)
    aoin = _mha_tpu(qkv, heads, n_valid, out_scale=float(args[0])).float()
    return (x, args, 127.0 * args[7],
            (xin[:, :n_valid], aoin[:, :n_valid]))


# (tokens, valid tokens): 13 rows, and past 256 keys, where K18's attention
# streams its key tiles on the card (the JAX kernel pads the keys to 384)
@pytest.mark.parametrize("hot", [False, True])
@pytest.mark.parametrize("n,n_valid", [
    pytest.param(13, 13, id="13"), pytest.param(13, 9, id="9"),
    pytest.param(264, 261, id="264-261"), pytest.param(264, 1, id="264-1")])
def test_attn_block_int8_static_matches_pallas(n, n_valid, hot):
    heads = 4
    x, args, step, pre = _attn_case(hot, n=n, n_valid=n_valid)
    if hot:
        assert _clipped(pre) > MIN_CLIPPED
    xj, xt = _bf16_pair(x)
    want = jqb.attn_block_int8_static(xj, *map(jnp.asarray, args), heads,
                                      n_valid=n_valid, interpret=True)
    got = tqb.attn_block_int8_static(xt, float(args[0]),
                                     *map(torch.from_numpy, args[1:]), heads,
                                     n_valid=n_valid)
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    # rows at or past n_valid are garbage by contract on both sides
    assert _within_steps(got[:, :n_valid], want[:, :n_valid], step)


# ---------------------------------------------------------------------------
# The JAX *_ref blocks, which the static tree runs where the block kernels
# do not fit (ViT-B/16 at 1024 px): plain torch against the JAX functions
# on the same folded arguments, in the int8 band of the kernels above
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hot", [False, True])
@pytest.mark.parametrize("act", ["gelu_tanh", "quick_gelu", "relu"])
def test_mlp_block_int8_static_ref_matches_jax(act, hot):
    x, args, step, _ = _mlp_case(act, hot)
    xj, xt = _bf16_pair(x)
    want = jqb.mlp_block_int8_static_ref(xj, *map(jnp.asarray, args),
                                         act=act)
    got = tqb.mlp_block_int8_static_ref(xt, float(args[0]),
                                        *map(torch.from_numpy, args[1:]),
                                        act=act)
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    assert _within_steps(got, want, step)


@pytest.mark.parametrize("hot", [False, True])
@pytest.mark.parametrize("n,n_valid", [
    pytest.param(13, 9, id="9"), pytest.param(264, 261, id="264-261")])
def test_attn_block_int8_static_ref_matches_jax(n, n_valid, hot):
    heads = 4
    x, args, step, _ = _attn_case(hot, n=n, n_valid=n_valid)
    xj, xt = _bf16_pair(x)
    want = jqb.attn_block_int8_static_ref(xj, *map(jnp.asarray, args),
                                          heads, n_valid=n_valid)
    got = tqb.attn_block_int8_static_ref(xt, float(args[0]),
                                         *map(torch.from_numpy, args[1:]),
                                         heads, n_valid=n_valid)
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    assert _within_steps(got[:, :n_valid], want[:, :n_valid], step)


# ---------------------------------------------------------------------------
# K19b plain version
# ---------------------------------------------------------------------------

def _static_blocks(seed, b, n, depth, d, m, heads):
    """A stacked static tree (numpy and torch): seeded f32 blocks,
    quantize_vit_fast's int8 weights, scales calibrated by the port's
    probe on seeded tokens, each layer's times 0.5, 1 or 2 in turn (the
    0.5 layers saturate)."""
    rng = np.random.default_rng(seed)

    def mk(*shape, scale=0.1, mean=0.0):
        return (mean + rng.normal(size=shape) * scale).astype(np.float32)

    blocks = {"ln1_scale": mk(depth, d, mean=1.0), "ln1_bias": mk(depth, d),
              "wqkv": mk(depth, d, 3 * d), "bqkv": mk(depth, 3 * d),
              "wo": mk(depth, d, d), "bo": mk(depth, d),
              "ln2_scale": mk(depth, d, mean=1.0), "ln2_bias": mk(depth, d),
              "w1": mk(depth, d, m), "b1": mk(depth, m),
              "w2": mk(depth, m, d), "b2": mk(depth, d)}
    fb = {k: torch.from_numpy(v) for k, v in blocks.items()}
    x = mk(b, n, d, scale=1.0)
    sc = tcal.layer_absmax_stats(fb, _bf16_pair(x)[1], heads, 1e-6,
                                 "gelu_tanh", torch.bfloat16)
    turns = np.asarray([0.5, 1.0, 2.0], np.float32)[np.arange(depth) % 3]
    q = {k: v for k, v in fb.items() if k not in ("wqkv", "wo", "w1", "w2")}
    for k in ("wqkv", "wo", "w1", "w2"):
        pairs = [quantize_weight_colwise(w) for w in blocks[k]]
        q[k + "_q"] = torch.from_numpy(np.stack([a for a, _ in pairs]))
        q[k + "_s"] = torch.from_numpy(np.stack([s for _, s in pairs]))
    tree = tq._fold_static_scales(
        {"blocks": q}, {k: v * turns for k, v in sc.items()}, QMAX)["blocks"]
    return x, tree


# (batch, tokens, n_valid, heads, head dim, mlp, depth)
STACK_CASES = [
    (2, 17, None, 4, 16, 128, 3),
    (1, 24, None, 2, 64, 256, 2),
    (2, 20, 13, 4, 16, 128, 2),
]


def _block_composition(xj, tree, heads, act, n_valid):
    """The JAX ``_layer_math_int8_static`` as the Pallas block kernels it
    is written out of: per layer attn_block_int8_static (K18) then
    mlp_block_int8_static (K17), in interpret mode, on rows padded to a
    multiple of 8."""
    b, n, d = xj.shape
    n_pad = -(-n // 8) * 8
    x = jnp.pad(xj, ((0, 0), (0, n_pad - n), (0, 0)))
    for i in range(tree["wqkv_q"].shape[0]):
        blk = {k: jnp.asarray(v[i].numpy()) for k, v in tree.items()}
        x = jqb.attn_block_int8_static(
            x, blk["inv_ao"], blk["ln1_scale"], blk["ln1_bias"],
            blk["wqkv_q"], blk["wqkv_s"], blk["bqkv"], blk["wo_q"],
            blk["wo_s"], blk["bo"], heads, eps=1e-6, n_valid=n_valid or n,
            interpret=True)
        x = jqb.mlp_block_int8_static(
            x.reshape(b * n_pad, d), blk["inv_ah"], blk["ln2_scale"],
            blk["ln2_bias"], blk["w1_q"], blk["w1_s"], blk["b1"],
            blk["w2_q"], blk["w2_s"], blk["b2"], eps=1e-6, act=act,
            block_t=8, interpret=True).reshape(b, n_pad, d)
    return np.asarray(x[:, :n].astype(jnp.float32))


@pytest.mark.parametrize("act", ["gelu_tanh", "quick_gelu"])
@pytest.mark.parametrize("case", STACK_CASES)
def test_vit_layers_int8_static_plain_matches_pallas(case, act):
    """One layer within the step band of the Pallas K18 then K17 that
    ``_layer_math_int8_static`` is written out of, and within
    INT8_DEPTH_BAND of vit_layers_int8_static_pallas; all layers within
    INT8_DEPTH_BAND of both, and bit for bit the port's own K18 then K17
    wrappers on the padded rows."""
    b, n, n_valid, heads, dh, m, depth = case
    d = heads * dh
    x, tree = _static_blocks(5, b, n, depth, d, m, heads)
    xj, xt = _bf16_pair(x)
    rows = n if n_valid is None else n_valid
    first = {k: v[:1] for k, v in tree.items()}
    got1 = tvs.vit_layers_int8_static(xt, first, heads, eps=1e-6, act=act,
                                      n_valid=n_valid)
    step = (127.0 * (first["wo_s"][0] + first["w2_s"][0])).numpy()
    assert _within_steps(got1[:, :rows], _block_composition(
        xj, first, heads, act, n_valid)[:, :rows], step)

    got = tvs.vit_layers_int8_static(xt, tree, heads, eps=1e-6, act=act,
                                     n_valid=n_valid)
    assert got.dtype == torch.bfloat16 and got.shape == (b, n, d)
    for g, t in ((got1, first), (got, tree)):
        g = g.float().numpy()[:, :rows]
        stack = np.asarray(jvs.vit_layers_int8_static_pallas(
            xj, {k: jnp.asarray(v.numpy()) for k, v in t.items()}, heads,
            eps=1e-6, act=act, n_valid=n_valid, interpret=True).astype(
                jnp.float32))[:, :rows]
        for want in (stack, _block_composition(xj, t, heads, act,
                                               n_valid)[:, :rows]):
            assert np.linalg.norm(g - want) <= INT8_DEPTH_BAND * \
                np.linalg.norm(want)

    n_pad = -(-n // 8) * 8
    comp = torch.nn.functional.pad(xt, (0, 0, 0, n_pad - n))
    for i in range(depth):
        blk = {k: v[i] for k, v in tree.items()}
        comp = tqb.attn_block_int8_static(
            comp, blk["inv_ao"], blk["ln1_scale"], blk["ln1_bias"],
            blk["wqkv_q"], blk["wqkv_s"], blk["bqkv"], blk["wo_q"],
            blk["wo_s"], blk["bo"], heads, eps=1e-6, n_valid=rows)
        comp = tqb.mlp_block_int8_static(
            comp.reshape(b * n_pad, d), blk["inv_ah"], blk["ln2_scale"],
            blk["ln2_bias"], blk["w1_q"], blk["w1_s"], blk["b1"],
            blk["w2_q"], blk["w2_s"], blk["b2"], eps=1e-6,
            act=act).reshape(b, n_pad, d)
    assert torch.equal(got, comp[:, :n])


def test_static_stack_loud_padding_leaves_valid_rows_bit_for_bit():
    b, n, n_valid, heads, d, m = 2, 24, 17, 2, 128, 128
    x, tree = _static_blocks(7, b, n, 2, d, m, heads)
    xt = _bf16_pair(x)[1]
    loud = xt.clone()
    loud[:, n_valid:] = 0.0
    loud[:, n_valid:, 3] = 3e3
    loud[:, n_valid:, 50] = -1e3
    quiet_out = tvs.vit_layers_int8_static(xt, tree, heads, n_valid=n_valid)
    loud_out = tvs.vit_layers_int8_static(loud, tree, heads, n_valid=n_valid)
    assert torch.equal(loud_out[:, :n_valid], quiet_out[:, :n_valid])
    unmasked = tvs.vit_layers_int8_static(loud, tree, heads, n_valid=None)
    assert not torch.equal(unmasked[:, :n_valid], quiet_out[:, :n_valid])


def test_static_wrappers_run_plain_on_cpu_and_check_their_trees():
    b, n, heads, d, m = 1, 8, 2, 128, 128
    x, tree = _static_blocks(9, b, n, 1, d, m, heads)
    xt = _bf16_pair(x)[1]
    before = (tqb.mlp_block_int8_static.launches,
              tqb.attn_block_int8_static.launches,
              tvs.vit_layers_int8_static.launches)
    tvs.vit_layers_int8_static(xt, tree, heads)
    blk = {k: v[0] for k, v in tree.items()}
    tqb.attn_block_int8_static(
        xt, blk["inv_ao"], blk["ln1_scale"], blk["ln1_bias"], blk["wqkv_q"],
        blk["wqkv_s"], blk["bqkv"], blk["wo_q"], blk["wo_s"], blk["bo"],
        heads)
    tqb.mlp_block_int8_static(
        xt[0], blk["inv_ah"], blk["ln2_scale"], blk["ln2_bias"], blk["w1_q"],
        blk["w1_s"], blk["b1"], blk["w2_q"], blk["w2_s"], blk["b2"])
    assert (tqb.mlp_block_int8_static.launches,
            tqb.attn_block_int8_static.launches,
            tvs.vit_layers_int8_static.launches) == before
    with pytest.raises(ValueError, match="act"):
        tqb.mlp_block_int8_static(
            xt[0], blk["inv_ah"], blk["ln2_scale"], blk["ln2_bias"],
            blk["w1_q"], blk["w1_s"], blk["b1"], blk["w2_q"], blk["w2_s"],
            blk["b2"], act="gelu")
    dynamic = {k: v for k, v in tree.items()
               if k not in ("inv_ao", "inv_ah")}
    with pytest.raises(ValueError, match="vit_layers_int8\\b"):
        tvs.vit_layers_int8_static(xt, dynamic, heads)
    with pytest.raises(ValueError, match="vit_layers_int8_static"):
        tvs.vit_layers_int8(xt, tree, heads)


# ---------------------------------------------------------------------------
# The forwards
# ---------------------------------------------------------------------------

def _jax_composition(jqp, images, jcfg, n_pad=N_PAD):
    """The TPU branch of the JAX ``vit_forward_int8_fast`` on a static
    tree written out: the dotg embed on bf16(wq * ws) onto ``n_pad`` rows,
    then per layer attn_block_int8_static -> mlp_block_int8_static in
    interpret mode, the CLS LayerNorm and the fused int8 head in interpret
    mode."""
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
        x = jqb.attn_block_int8_static(
            x, blk["inv_ao"], blk["ln1_scale"], blk["ln1_bias"],
            blk["wqkv_q"], blk["wqkv_s"], blk["bqkv"], blk["wo_q"],
            blk["wo_s"], blk["bo"], jcfg.num_heads, eps=jcfg.ln_eps,
            n_valid=n, interpret=True)
        x = jqb.mlp_block_int8_static(
            x.reshape(b * n_pad, d), blk["inv_ah"], blk["ln2_scale"],
            blk["ln2_bias"], blk["w1_q"], blk["w1_s"], blk["b1"],
            blk["w2_q"], blk["w2_s"], blk["b2"], eps=jcfg.ln_eps, act=act,
            block_t=32, interpret=True).reshape(b, n_pad, d)
    cls = jvit._layernorm(x[:, :1], jqp["ln_f_scale"], jqp["ln_f_bias"],
                          jcfg.ln_eps)
    hd = jqp["head"]
    out = jqf.int8_linear_fused(cls.reshape(b, d), hd["wq"], hd["ws"],
                                hd["b"], interpret=True)
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("hidden_act", ["gelu", "quick_gelu"])
def test_static_forward_matches_jax_kernel_composition(hidden_act):
    jcfg, tcfg, jqp, tqp = _static_pair(1, hidden_act=hidden_act)
    img = _images(2)
    want = _jax_composition(jqp, img, jcfg)
    got = tq.make_forward_int8(tcfg, tqp, device="cpu")(img)
    assert got.dtype == torch.float32 and got.shape == (3, 10)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=TIGHT * np.abs(want).max())


def test_static_forward_past_256_tokens_matches_jax_kernel_composition(
        monkeypatch):
    """A 384-px-like geometry: 577 tokens (24 x 24 patches and the CLS
    row, ViT-B/16 @384's count) on 584 rows, head dim 64, two narrow
    layers, a static tree.  The JAX planner keeps the static block kernels
    there, and so does the port: every attention half is K18
    (attn_block_int8_static), inside the gate the card applies, and the
    logits hold to the JAX composition of the Pallas kernels as tightly as
    at 17 tokens."""
    kw = dict(image_size=192, hidden_dim=128, num_heads=2, mlp_dim=256)
    jcfg, tcfg, jqp, tqp = _static_pair(16, **kw)
    assert tcfg.seq_len == 577 and jq._int8_block_fits(jcfg)
    assert tq._int8_block_fits(tcfg)
    shapes = []

    def k18(x, *args, n_valid=None, **kwargs):
        shapes.append((tuple(x.shape), n_valid))
        tqb.attn_int8_static_geometry(*x.shape, args[-1], n_valid)
        return tqb.attn_block_int8_static(x, *args, n_valid=n_valid,
                                          **kwargs)

    monkeypatch.setattr(tq, "attn_block_int8_static", k18)
    img = _images(17, b=2, s=192)
    want = _jax_composition(jqp, img, jcfg, n_pad=584)
    got = tq.make_forward_int8(tcfg, tqp, device="cpu")(img)
    assert shapes == [((2, 584, 128), 577)] * 2
    assert got.shape == (2, 10) and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=TIGHT * np.abs(want).max())


def test_static_forward_holds_to_the_jax_cpu_forward():
    jcfg, tcfg, jqp, tqp = _static_pair(3)
    img = _images(4, b=4)
    want = np.asarray(jq.vit_forward_int8_raw(jqp, jnp.asarray(img), jcfg))
    got = tq.make_forward_int8(tcfg, tqp, device="cpu")(img).numpy()
    assert np.abs(got - want).max() <= LOOSE * np.abs(want).max()
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))


def _interp(monkeypatch, module, name):
    monkeypatch.setattr(module, name, functools.partial(
        getattr(module, name), interpret=True))


@pytest.mark.parametrize("hidden_act", ["gelu", "quick_gelu"])
def test_static_latency_matches_jax(monkeypatch, hidden_act):
    _interp(monkeypatch, jvs, "vit_layers_int8_static_pallas")
    _interp(monkeypatch, jqf, "int8_linear_fused")
    jcfg, tcfg, jqp, tqp = _static_pair(7, hidden_act=hidden_act)
    img = _images(8, b=3)
    want = np.asarray(jq.vit_forward_int8_latency(
        jqp, jvit.preprocess(jnp.asarray(img), jcfg), jcfg), np.float32)
    xt = tvit.preprocess(torch.from_numpy(img), tcfg)
    got = tq.vit_forward_int8_latency(tqp, xt, tcfg)
    assert got.dtype == torch.float32 and got.shape == (3, 10)
    assert float(np.abs(got.numpy() - want).max()
                 / np.abs(want).max()) < INT8_BAND
    np.testing.assert_array_equal(got.numpy().argmax(1), want.argmax(1))
    fold = tq.prep_int8_latency(tqp, tcfg)
    assert fold["blocks"]["inv_ao"].shape == (2, 1)
    assert torch.equal(tq.vit_forward_int8_latency(fold, xt, tcfg), got)
    # the CLS-last order and the single-launch layers are invisible: the
    # plain K19b is K18 then K17, so the throughput forward agrees exactly
    assert torch.equal(tq.vit_forward_int8_fast(tqp, xt, tcfg), got)


def test_prepare_int8_reads_the_static_scalars_once():
    _, tcfg, jqp, tqp = _static_pair(7)
    prep = tq.prepare_int8(tqp, tcfg)
    for i, lay in enumerate(prep["_layers"]):
        for k in ("inv_ao", "inv_ah"):
            assert isinstance(lay[k], float)
            assert lay[k] == float(np.asarray(jqp["blocks"][k])[i, 0])


def test_int8_scores_stay_off_and_forced_on_match_jax(monkeypatch):
    """K22's gate is off as in the JAX package; forced on in both, the
    port's int8-scores forward holds to the JAX CPU forward (LOOSE, equal
    top-1; tests/test_torch_int8_chain.py holds it to the interpreted
    kernels)."""
    jcfg, tcfg, jqp, tqp = _static_pair(8, hidden_dim=128, num_heads=2,
                                        mlp_dim=256)
    blk = {k: v[0] for k, v in tqp["blocks"].items()}
    assert "sc_qk" in blk and not tq._int8_scores_ok(blk, tcfg)
    monkeypatch.setattr(tq, "_INT8_SCORES", True)
    monkeypatch.setattr(jq, "_INT8_SCORES", True)
    assert tq._int8_scores_ok(blk, tcfg)
    img = _images(9, b=3)
    want = np.asarray(jq.vit_forward_int8_raw(jqp, jnp.asarray(img), jcfg))
    got = tq.make_forward_int8(tcfg, tqp, device="cpu")(img).numpy()
    assert np.abs(got - want).max() <= LOOSE * np.abs(want).max()
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))


# ---------------------------------------------------------------------------
# The accuracy gates of tests/test_int8_static.py on the port's own
# calibration and forward (vit_ti16 at 64 px, f32 config)
# ---------------------------------------------------------------------------

def _cos(a, b):
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-30))


def _ti16(seed):
    cfg = tvit.config("vit_ti16", image_size=64, num_classes=100,
                      dtype="float32")
    gen = torch.Generator()
    gen.manual_seed(seed)
    return cfg, tvit.init_params(cfg, gen, device="cpu")


def _normal(seed, b, scale=1.0):
    return torch.from_numpy((np.random.default_rng(seed).normal(
        size=(b, 64, 64, 3)) * scale).astype(np.float32))


def test_static_vit_cosine_vs_f32():
    cfg, params = _ti16(0)
    images = _normal(7, 4)
    qp = tq.quantize_vit_static(params, cfg)
    logits_q = tq.vit_forward_int8_fast(qp, images, cfg)
    logits_f = tvit.forward(params, images, cfg)
    assert _cos(logits_q, logits_f) >= 0.999


def test_static_tracks_dynamic_quality():
    cfg, params = _ti16(1)
    images = _normal(8, 4)
    logits_f = tvit.forward(params, images, cfg)
    cos_s = _cos(tq.vit_forward_int8_fast(
        tq.quantize_vit_static(params, cfg), images, cfg), logits_f)
    cos_d = _cos(tq.vit_forward_int8_fast(
        tq.quantize_vit_fast(params), images, cfg), logits_f)
    assert cos_s >= cos_d - 5e-4, (cos_s, cos_d)


def test_static_saturation_graceful():
    """Inputs 4x beyond the calibration batch saturate, not explode."""
    cfg, params = _ti16(2)
    qp = tq.quantize_vit_static(params, cfg, images=_normal(9, 2))
    hot = _normal(10, 2, scale=4.0)
    out = tq.vit_forward_int8_fast(qp, hot, cfg)
    assert bool(torch.isfinite(out).all())
    assert _cos(out, tvit.forward(params, hot, cfg)) >= 0.98


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("latency", [False, True])
def test_image_server_serves_the_static_tree(latency):
    _, tcfg, _, tqp = _static_pair(11)
    make = tq.make_forward_int8_latency if latency else tq.make_forward_int8
    fwd = make(tcfg, tqp, device="cpu")
    batch = 1 if latency else 4
    rng = np.random.default_rng(12)
    imgs = [rng.integers(0, 256, (32, 32, 3), np.uint8) for _ in range(5)]
    with ImageServer(fwd, image_size=32, batch_size=batch,
                     device="cpu") as server:
        results = [f.result(timeout=60)
                   for f in [server.submit_raw(im) for im in imgs]]
        assert server.served == 5
        if latency:
            assert server.batches == 5
    direct = fwd(np.stack(imgs)).numpy()
    for got, want in zip(results, direct):
        assert got.shape == (10,)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_static_makers_refuse_remat_and_default_to_cuda():
    _, tcfg, _, tqp = _static_pair(13)
    remat = dataclasses.replace(tcfg, remat=True)
    for make in (tq.make_forward_int8, tq.make_forward_int8_latency):
        with pytest.raises(NotImplementedError, match="remat"):
            make(remat, tqp, device="cpu")
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError):
                make(tcfg, tqp)
