"""The port's int8 block halves (ops/quant_block.py, the plain versions of
K15 and K16) against the JAX package's Pallas kernels in interpret mode,
on the same numpy inputs at the shapes of tests/test_quant_block.py (K16
also past 256 keys), and the gates on the card of the int8 attention
halves on the wgmma attention (K16, K18, K21b) against the JAX planner's
and the JAX wrappers' own."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_fpga_tpu.models import quantized as jq
from vit_fpga_tpu.models import vit as jvit
from vit_fpga_tpu.ops import quant_block as jqb
from vit_fpga_tpu.ops.attn_block import STATS_LANES
from vit_fpga_tpu.ops.quant_fused import quantize_weight_colwise
from vit_fpga_tpu_torch.ops import quant_block as tqb
from vit_fpga_tpu_torch.ops.common import SUBLANE, round_up

# The plain versions repeat the Pallas bodies op for op in f32 (one-pass
# LN, row quantization, exact int32 sums, the same dequantization and
# activation forms, bf16 qkv and attention output, x + bf16(y)).  Only
# the order of f32 sums differs (the LN statistics, the bf16 PV product),
# which can flip a bf16 rounding of qkv or ao by one ulp; these inputs
# give bit-exact outputs.  The band allows one bf16 ulp of the output
# (at most 2^-7 relative).
BF16_ULP = 2.0 ** -7


def _mk(rng, shape, scale=0.1):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _bf16_pair(x):
    xj = jnp.asarray(x, jnp.bfloat16)
    return xj, torch.from_numpy(np.array(xj.astype(jnp.float32))).to(
        torch.bfloat16)


def _close(got, want):
    got = got.float().numpy()
    want = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got, want, rtol=BF16_ULP, atol=BF16_ULP)


def _mlp_case(seed=0, t=40, d=64, m=128):
    rng = np.random.default_rng(seed)
    x = _mk(rng, (t, d), 1.0)
    ls = _mk(rng, (d,)) + 1.0
    lb = _mk(rng, (d,))
    w1q, w1s = quantize_weight_colwise(_mk(rng, (d, m)))
    w2q, w2s = quantize_weight_colwise(_mk(rng, (m, d)))
    return x, (ls, lb, w1q, w1s, _mk(rng, (m,), 0.5), w2q, w2s,
               _mk(rng, (d,), 0.5))


@pytest.mark.parametrize("act", ["gelu_tanh", "quick_gelu", "relu"])
def test_mlp_block_int8_matches_pallas(act):
    x, args = _mlp_case()
    xj, xt = _bf16_pair(x)
    want = jqb.mlp_block_int8(xj, *map(jnp.asarray, args), act=act,
                              block_t=32, interpret=True)
    got = tqb.mlp_block_int8(xt, *map(torch.from_numpy, args), act=act)
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    _close(got, want)


def test_mlp_block_int8_quantizes_h_over_its_whole_row():
    """h's scale is its whole row's absmax: scaling one column of W1 up
    (so that column dominates every row of h) coarsens the quantization
    of every other column, and the plain version follows the JAX kernel
    there too."""
    x, args = _mlp_case(seed=5)
    ls, lb, w1q, w1s, b1, w2q, w2s, b2 = args
    w1s = w1s.copy()
    w1s[3] *= 40.0
    args = (ls, lb, w1q, w1s, b1, w2q, w2s, b2)
    xj, xt = _bf16_pair(x)
    want = jqb.mlp_block_int8(xj, *map(jnp.asarray, args), block_t=32,
                              interpret=True)
    _close(tqb.mlp_block_int8(xt, *map(torch.from_numpy, args)), want)


def _attn_case(seed=1, b=2, n=13, d=32):
    rng = np.random.default_rng(seed)
    x = _mk(rng, (b, n, d), 1.0)
    ls = _mk(rng, (d,)) + 1.0
    lb = _mk(rng, (d,))
    wqkvq, wqkvs = quantize_weight_colwise(_mk(rng, (d, 3 * d)))
    woq, wos = quantize_weight_colwise(_mk(rng, (d, d)))
    return x, (ls, lb, wqkvq, wqkvs, _mk(rng, (3 * d,), 0.2), woq, wos,
               _mk(rng, (d,), 0.2))


# (tokens, valid tokens): 13 rows, and past 256 keys, where K16's attention
# streams its key tiles on the card (the JAX kernel pads the keys to 384)
@pytest.mark.parametrize("n,n_valid", [
    pytest.param(13, 13, id="13"), pytest.param(13, 9, id="9"),
    pytest.param(13, 1, id="1"), pytest.param(264, 261, id="264-261"),
    pytest.param(264, 1, id="264-1")])
def test_attn_block_int8_matches_pallas(n, n_valid):
    heads = 4
    x, args = _attn_case(n=n)
    xj, xt = _bf16_pair(x)
    want = jqb.attn_block_int8(xj, *map(jnp.asarray, args), heads,
                               n_valid=n_valid, interpret=True)
    got = tqb.attn_block_int8(xt, *map(torch.from_numpy, args), heads,
                              n_valid=n_valid)
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    # rows at or past n_valid are garbage by contract on both sides
    _close(got[:, :n_valid], want[:, :n_valid])


def test_attn_block_int8_loud_padding_leaves_valid_rows_unchanged():
    """Padding rows of huge, spiky values: their keys are masked, so the
    valid rows equal the quiet run's exactly, and still match the JAX
    kernel."""
    heads, n_valid = 4, 9
    x, args = _attn_case(seed=2)
    loud = x.copy()
    loud[:, n_valid:] = 0.0
    loud[:, n_valid:, 5] = 3e3
    loud[:, n_valid:, 17] = -1e3
    targs = tuple(map(torch.from_numpy, args))
    quiet_out = tqb.attn_block_int8(_bf16_pair(x)[1], *targs, heads,
                                    n_valid=n_valid)
    lj, lt = _bf16_pair(loud)
    loud_out = tqb.attn_block_int8(lt, *targs, heads, n_valid=n_valid)
    assert torch.equal(loud_out[:, :n_valid], quiet_out[:, :n_valid])
    want = jqb.attn_block_int8(lj, *map(jnp.asarray, args), heads,
                               n_valid=n_valid, interpret=True)
    _close(loud_out[:, :n_valid], want[:, :n_valid])
    # without the mask the padding keys would move the valid rows
    unmasked = tqb.attn_block_int8(lt, *targs, heads, n_valid=None)
    assert not torch.equal(unmasked[:, :n_valid], quiet_out[:, :n_valid])


def test_int8_halves_cpu_run_plain_and_check_args():
    x, args = _mlp_case(t=8)
    before = tqb.mlp_block_int8.launches
    tqb.mlp_block_int8(_bf16_pair(x)[1], *map(torch.from_numpy, args))
    assert tqb.mlp_block_int8.launches == before
    with pytest.raises(ValueError):
        tqb.mlp_block_int8(_bf16_pair(x)[1], *map(torch.from_numpy, args),
                           act="gelu")
    xa, aargs = _attn_case()
    before = tqb.attn_block_int8.launches
    tqb.attn_block_int8(_bf16_pair(xa)[1], *map(torch.from_numpy, aargs), 4)
    assert tqb.attn_block_int8.launches == before


# (model, image size): where the JAX int8 planner runs the block kernels
# (ViT-B/16 up to 896 px, 3137 tokens; ViT-L/16 up to 768 px) and just past
# it, where the JAX forward takes the per-linear route instead
K16_GEOMETRIES = (("vit_b16", 224), ("vit_b16", 384), ("vit_b16", 896),
                  ("vit_b16", 1024), ("vit_l16", 768), ("vit_l16", 896))


@pytest.mark.parametrize("variant,image", K16_GEOMETRIES)
def test_k16_gate_admits_what_the_jax_planner_runs(variant, image):
    """K16's gate on the card (attn_int8_geometry) admits a model's tokens
    exactly where the JAX _int8_block_fits sends its blocks to the int8
    kernels, at the rows the port's forward pads them to, b1 and b64."""
    jcfg = jvit.config(variant, image_size=image)
    n_pad = round_up(jcfg.seq_len, SUBLANE)
    for batch in (1, 64):
        args = (batch, n_pad, jcfg.hidden_dim, jcfg.num_heads, jcfg.seq_len)
        if jq._int8_block_fits(jcfg):
            tqb.attn_int8_geometry(*args)
        else:
            with pytest.raises(ValueError, match="score slot"):
                tqb.attn_int8_geometry(*args)


@pytest.mark.parametrize("b,n,d,heads,n_valid,why", [
    (4, 584, 1152, 12, 577, "head dim 64 or 80"),  # dh 96
    (4, 200, 768, 12, 0, "head dim 64"),       # no valid key
    (4, 200, 768, 12, 201, "head dim 64"),     # more valid keys than rows
    (5462, 200, 768, 12, 197, "grid"),         # batch x heads past 65535
])
def test_k16_gate_rejects_what_the_kernel_does_not_take(b, n, d, heads,
                                                        n_valid, why):
    with pytest.raises(ValueError, match=why):
        tqb.attn_int8_geometry(b, n, d, heads, n_valid)


# ViT-H/14 (D 1280, 16 heads of 80) at 224 and 336 px, where the JAX
# planner runs the int8 block kernels
VIT_H14_IMAGES = (224, 336)


@pytest.mark.parametrize("kernel", ["K16", "K18"])
@pytest.mark.parametrize("image", VIT_H14_IMAGES)
def test_k16_k18_gates_admit_vit_h14(kernel, image):
    """K16's and K18's gates take head dim 80: ViT-H/14's tokens at the
    rows the port pads them to, b1 and b64, where the JAX planner sends
    its blocks to the int8 kernels and (K18) the JAX wrapper itself runs
    (its own checks, traced abstractly)."""
    jcfg = jvit.config("vit_h14", image_size=image)
    d, heads, n = jcfg.hidden_dim, jcfg.num_heads, jcfg.seq_len
    assert d // heads == 80 and jq._int8_block_fits(jcfg)
    n_pad = round_up(n, SUBLANE)
    gate = (tqb.attn_int8_geometry if kernel == "K16"
            else tqb.attn_int8_static_geometry)
    for batch in (1, 64):
        if kernel == "K18":
            assert _jax_wrapper_runs("K18", batch, n_pad, n, d, heads)
        gate(batch, n_pad, d, heads, n)


@pytest.mark.parametrize("image", VIT_H14_IMAGES)
def test_k21b_gate_refuses_vit_h14(image):
    """K21b (the int8 stats chain, off by default) stays at head dim 64:
    its gate refuses ViT-H/14 by name."""
    jcfg = jvit.config("vit_h14", image_size=image)
    n_pad = round_up(jcfg.seq_len, SUBLANE)
    with pytest.raises(ValueError, match="K21b takes head dim 64 and"):
        tqb.attn_int8_stats_geometry(1, n_pad, jcfg.hidden_dim,
                                     jcfg.num_heads, jcfg.seq_len)


# K18 and K21b take K16's gate (K21b with the JAX wrapper's refusal of
# q-slot reuse), each named in its errors
K18_K21B_GATES = {"K18": tqb.attn_int8_static_geometry,
                  "K21b": tqb.attn_int8_stats_geometry}


def _jax_wrapper_runs(kernel, batch, n_pad, n_valid, d, heads):
    """Whether the JAX wrapper of ``kernel`` (attn_block_int8_static,
    attn_block_int8_static_scores or attn_block_int8_stats) takes (batch, n_pad, d) tokens: traced
    abstractly (jax.eval_shape), so only its own checks run."""
    f32, i8, bf = jnp.float32, jnp.int8, jnp.bfloat16

    def spec(*shape, dt=f32):
        return jax.ShapeDtypeStruct(shape, dt)
    weights = (spec(d), spec(d), spec(d, 3 * d, dt=i8), spec(3 * d),
               spec(3 * d), spec(d, d, dt=i8), spec(d), spec(d))
    x = spec(batch, n_pad, d, dt=bf)
    if kernel == "K18":
        fn, args = jqb.attn_block_int8_static, (x, spec(1, 1), *weights)
    elif kernel == "K22":
        fn = jqb.attn_block_int8_static_scores
        args = (x, spec(1, 1), spec(1, 1), *weights)
    else:
        fn = jqb.attn_block_int8_stats
        args = (x, spec(batch, n_pad, STATS_LANES), *weights)
    try:
        jax.eval_shape(functools.partial(fn, num_heads=heads,
                                         n_valid=n_valid, interpret=True),
                       *args)
    except ValueError:
        return False
    return True


@pytest.mark.parametrize("kernel", sorted(K18_K21B_GATES))
@pytest.mark.parametrize("variant,image", K16_GEOMETRIES)
def test_k18_k21b_gates_admit_what_the_jax_kernels_run(kernel, variant,
                                                       image):
    """K18's and K21b's gates on the card admit a model's tokens exactly
    where the JAX planner sends its blocks to the int8 kernels
    (_int8_block_fits; K21b also no q-slot reuse at the batch) and where
    the JAX wrapper itself runs (its own raise, traced abstractly), at the
    rows the port's forward pads them to, b1, b3 and b64."""
    gate = K18_K21B_GATES[kernel]
    jcfg = jvit.config(variant, image_size=image)
    d, heads, n = jcfg.hidden_dim, jcfg.num_heads, jcfg.seq_len
    n_pad = round_up(n, SUBLANE)
    for batch in (1, 3, 64):
        _, n_sc, reuse_q, _ = jqb.score_slots_int8(
            heads, d, n_pad, round_up(n_pad, 128), batch=batch)
        planned = jq._int8_block_fits(jcfg) and not (
            kernel == "K21b" and reuse_q)
        runs = _jax_wrapper_runs(kernel, batch, n_pad, n, d, heads)
        assert runs == planned == (n_sc >= 1 and not (
            kernel == "K21b" and reuse_q)), (batch, runs, planned)
        if runs:
            gate(batch, n_pad, d, heads, n)
        else:
            with pytest.raises(ValueError, match=kernel):
                gate(batch, n_pad, d, heads, n)


def test_k21b_gate_rejects_the_q_slot_reuse_the_jax_wrapper_rejects():
    """ViT-L/16 @384 at b1 and b3: the JAX int8 plan reuses the q slot,
    so the JAX attn_block_int8_stats raises (K16 and K18 run there); so
    does K21b's gate, naming the reuse."""
    jcfg = jvit.config("vit_l16", image_size=384)
    d, heads, n = jcfg.hidden_dim, jcfg.num_heads, jcfg.seq_len
    n_pad = round_up(n, SUBLANE)
    for batch in (1, 3):
        assert jqb.score_slots_int8(heads, d, n_pad, round_up(n_pad, 128),
                                    batch=batch)[2]
        assert not _jax_wrapper_runs("K21b", batch, n_pad, n, d, heads)
        assert _jax_wrapper_runs("K18", batch, n_pad, n, d, heads)
        tqb.attn_int8_geometry(batch, n_pad, d, heads, n)
        tqb.attn_int8_static_geometry(batch, n_pad, d, heads, n)
        with pytest.raises(ValueError, match="q-slot reuse"):
            tqb.attn_int8_stats_geometry(batch, n_pad, d, heads, n)


@pytest.mark.parametrize("kernel", sorted(K18_K21B_GATES))
@pytest.mark.parametrize("b,n,d,heads,n_valid,why", [
    (4, 584, 1152, 12, 577, "head dim 64"),    # dh 96
    (4, 200, 768, 12, 0, "head dim 64"),       # no valid key
    (4, 200, 768, 12, 201, "head dim 64"),     # more valid keys than rows
    (5462, 200, 768, 12, 197, "grid"),         # batch x heads past 65535
])
def test_k18_k21b_gates_reject_what_the_kernels_do_not_take(
        kernel, b, n, d, heads, n_valid, why):
    with pytest.raises(ValueError, match=f"{kernel}.*{why}"):
        K18_K21B_GATES[kernel](b, n, d, heads, n_valid)


# (model, image size) around the JAX int8-scores wrapper's own bound, two
# score slots: ViT-B/16 @224, @384 (2 slots) and @512 run it, @896 (one
# slot) raises; ViT-L/16 @384 raises at b1 to b3 and runs from b4
K22_GEOMETRIES = (("vit_b16", 224), ("vit_b16", 384), ("vit_b16", 512),
                  ("vit_b16", 896), ("vit_l16", 384))


@pytest.mark.parametrize("variant,image", K22_GEOMETRIES)
def test_k22_gate_admits_what_the_jax_wrapper_runs(variant, image):
    """K22's gate on the card (attn_int8_scores_geometry) admits a model's
    tokens exactly where the JAX attn_block_int8_static_scores runs (its
    own raise, traced abstractly: n_sc >= 2 in the JAX int8 plan), at the
    rows the port's forward pads them to, b1, b3, b4 and b64; ViT-B/16
    @896 and ViT-L/16 @384 b1 refuse."""
    jcfg = jvit.config(variant, image_size=image)
    d, heads, n = jcfg.hidden_dim, jcfg.num_heads, jcfg.seq_len
    n_pad = round_up(n, SUBLANE)
    for batch in (1, 3, 4, 64):
        runs = _jax_wrapper_runs("K22", batch, n_pad, n, d, heads)
        if (variant, image) == ("vit_b16", 896) or (
                (variant, image) == ("vit_l16", 384) and batch < 4):
            assert not runs, batch
        if runs:
            tqb.attn_int8_scores_geometry(batch, n_pad, d, heads, n)
        else:
            with pytest.raises(ValueError, match="K22 runs where the JAX"):
                tqb.attn_int8_scores_geometry(batch, n_pad, d, heads, n)


@pytest.mark.parametrize("b,n,d,heads,n_valid,why", [
    (4, 584, 960, 12, 577, "dh=64, even heads"),  # dh 80 (ViT-H/14)
    (4, 200, 704, 11, 197, "dh=64, even heads"),  # an odd head count
    (4, 200, 768, 12, 0, "K22 takes 1..n valid"),    # no valid key
    (4, 200, 768, 12, 201, "K22 takes 1..n valid"),  # more keys than rows
    (5462, 200, 768, 12, 197, "K22's attention grid"),  # batch x heads
])
def test_k22_gate_rejects_what_the_kernel_does_not_take(b, n, d, heads,
                                                        n_valid, why):
    with pytest.raises(ValueError, match=why):
        tqb.attn_int8_scores_geometry(b, n, d, heads, n_valid)
