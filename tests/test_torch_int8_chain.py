"""The port's two gated int8 paths against the JAX package on the CPU: the
int8 stats chain (plain K21a ``mlp_block_int8_stats`` and K21b
``attn_block_int8_stats``, ``_INT8_STATS_CHAIN``) and the int8-scores
attention (plain K22 ``attn_block_int8_static_scores``,
``_INT8_SCORES``): each plain version against the Pallas kernel in
interpret mode, the switched-on forwards against a JAX composition of
those kernels and against the JAX CPU forward, and the gates."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vit_fpga_tpu.ops.quant_block as jqb
from vit_fpga_tpu.models import quantized as jq
from vit_fpga_tpu.models import vit as jvit
from vit_fpga_tpu.ops.attn_block import STATS_LANES
from vit_fpga_tpu.ops.patch_embed import embed_tokens_dotg as jax_embed
from vit_fpga_tpu.ops.quant_fused import int8_linear_fused as jax_linear
from vit_fpga_tpu.ops.quant_fused import quantize_weight_colwise
from vit_fpga_tpu_torch.models import quantized as tq
from vit_fpga_tpu_torch.models import vit as tvit
from vit_fpga_tpu_torch.models.convert import params_from_numpy
from vit_fpga_tpu_torch.ops import quant_block as tqb
from vit_fpga_tpu_torch.ops.common import row_stats

# The plain versions repeat the Pallas bodies op for op in f32; only the
# order of f32 sums differs (the LN and output statistics, the bf16 PV
# product), which can flip a bf16 rounding by one ulp: one bf16 ulp of
# the output (2^-7 relative), the band of tests/test_torch_quant_block.py.
BF16_ULP = 2.0 ** -7
# Emitted stats are the one-pass stats of the half's own bf16 output,
# exactly.  Against the stats of the JAX kernel's bf16 output they carry
# the outputs' band: an output element one bf16 ulp apart moves its row's
# mu and E[x^2] by less than that ulp.
# The interpreted JAX kernel's own emitted stats: XLA on the CPU keeps
# out = x + bf16(y) in f32 for the reduction that follows it (excess
# precision), so they are the stats of the unrounded sum, which the TPU
# kernel and the port do not compute.  Out's bf16 roundings (|out| < 4
# here, half an ulp <= 2^-7) bound the gap.
STATS_EXCESS = 2.0 ** -7
# K22 against the interpreted Pallas kernel and attn_block_int8s_static_ref:
# the JAX test's own band (tests/test_int8_static.py): every integer step
# agrees, the residual is f32 epilogue rounding order.
SCORES_ATOL = 1e-5
# The forwards against a JAX composition of the interpreted kernels: the
# same bodies, sums in another order; a few bf16 ulps of the largest logit.
TIGHT = 2.0 ** -5
# The forwards against the JAX CPU forward with the switch on (off a TPU
# it runs the *_ref route: two-pass LN, exact softmax): 5% of the largest
# logit, equal top-1.
LOOSE = 0.05
TINY = dict(image_size=32, patch_size=8, hidden_dim=128, depth=2,
            num_heads=2, mlp_dim=256, num_classes=10)
N_PAD = 24          # 17 tokens on rows padded to a multiple of 8


def _mk(rng, shape, scale=0.1):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _bf16_pair(x):
    xj = jnp.asarray(x, jnp.bfloat16)
    return xj, torch.from_numpy(np.array(xj.astype(jnp.float32))).to(
        torch.bfloat16)


def _close(got, want, tol=BF16_ULP):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)


def _check_stats(got, got_st, want, want_st, dtype):
    """The port's emitted stats: those of its own bf16 output exactly,
    against the stats of the JAX kernel's bf16 output in the outputs'
    band, and against the JAX kernel's own (the unrounded sum's) within
    STATS_EXCESS."""
    assert got_st.dtype == dtype
    assert torch.equal(got_st, row_stats(got, 1e-6).to(dtype))
    out = torch.from_numpy(np.array(want.astype(jnp.float32)))
    own = row_stats(out.to(torch.bfloat16), 1e-6).to(dtype)
    np.testing.assert_allclose(got_st.float().numpy(), own.float().numpy(),
                               rtol=BF16_ULP, atol=BF16_ULP)
    _close(got_st, want_st[..., :2], STATS_EXCESS)


def _foreign_stats(x, dtype):
    """(mu, rstd) that are not x's own: mu moved by 5% of the row's scale
    plus 0.02, rstd by 3%, so a kernel that reduced x itself would
    disagree.  Returns (the JAX (rows, STATS_LANES) tile, the port's
    (rows, 2) tensor), both rounded to ``dtype``."""
    st = row_stats(torch.from_numpy(x.reshape(-1, x.shape[-1])), 1e-6)
    st[:, 0] = st[:, 0] * 1.05 + 0.02
    st[:, 1] = st[:, 1] * 1.03
    st = st.to(dtype)
    tile = np.zeros((st.shape[0], STATS_LANES), np.float32)
    tile[:, :2] = st.float().numpy()
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    return jnp.asarray(tile, jdt), st


# ---------------------------------------------------------------------------
# K21a: the MLP half
# ---------------------------------------------------------------------------

def _mlp_case(seed=0, t=40, d=128, m=256):
    rng = np.random.default_rng(seed)
    x = _mk(rng, (t, d), 1.0)
    w1q, w1s = quantize_weight_colwise(_mk(rng, (d, m)))
    w2q, w2s = quantize_weight_colwise(_mk(rng, (m, d)))
    return x, (_mk(rng, (d,)) + 1.0, _mk(rng, (d,)), w1q, w1s,
               _mk(rng, (m,), 0.5), w2q, w2s, _mk(rng, (d,), 0.5))


@pytest.mark.parametrize("emit", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", ["gelu_tanh", "quick_gelu", "relu"])
def test_mlp_block_int8_stats_matches_pallas(act, dtype, emit):
    """40 rows (the JAX kernel pads them to 64, its padding stats 1.0),
    stats that are not x's own, f32 or bf16, with and without the next
    stats."""
    x, args = _mlp_case()
    xj, xt = _bf16_pair(x)
    stj, stt = _foreign_stats(np.asarray(xt.float()), dtype)
    want, want_st = jqb.mlp_block_int8_stats(
        xj, stj, *map(jnp.asarray, args), act=act, block_t=32,
        emit_stats=emit, interpret=True)
    got, got_st = tqb.mlp_block_int8_stats(
        xt, stt, *map(torch.from_numpy, args), act=act, emit_stats=emit)
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    _close(got, want)
    if not emit:
        assert got_st is None and want_st is None
        return
    assert got_st.shape == (x.shape[0], 2)
    _check_stats(got, got_st, want, want_st, dtype)


def test_mlp_block_int8_stats_reads_its_stats():
    """On foreign stats K21a is not K15: the stats it is given, not x's
    own, normalise x; on x's own stats it is K15 up to the LN sums'
    order."""
    x, args = _mlp_case(seed=4)
    xt = _bf16_pair(x)[1]
    targs = tuple(map(torch.from_numpy, args))
    k15 = tqb.mlp_block_int8(xt, *targs)
    foreign, _ = tqb.mlp_block_int8_stats(
        xt, _foreign_stats(x, torch.float32)[1], *targs, emit_stats=False)
    own, _ = tqb.mlp_block_int8_stats(xt, row_stats(xt, 1e-6), *targs,
                                      emit_stats=False)
    assert (foreign.float() - k15.float()).abs().max() > 0.05
    np.testing.assert_allclose(own.float().numpy(), k15.float().numpy(),
                               rtol=BF16_ULP, atol=BF16_ULP)


def test_stats_come_from_the_bf16_output():
    """The emitted stats are those of out's bf16 values, not of the f32
    sum x + y: they equal row_stats(out) exactly."""
    x, args = _mlp_case(seed=6)
    xt = _bf16_pair(x)[1]
    out, st = tqb.mlp_block_int8_stats(xt, row_stats(xt, 1e-6),
                                       *map(torch.from_numpy, args))
    assert torch.equal(st, row_stats(out, 1e-6))


# ---------------------------------------------------------------------------
# K21b: the attention half
# ---------------------------------------------------------------------------

def _attn_case(seed=1, b=2, n=24, d=128):
    rng = np.random.default_rng(seed)
    x = _mk(rng, (b, n, d), 1.0)
    wqkvq, wqkvs = quantize_weight_colwise(_mk(rng, (d, 3 * d)))
    woq, wos = quantize_weight_colwise(_mk(rng, (d, d)))
    return x, (_mk(rng, (d,)) + 1.0, _mk(rng, (d,)), wqkvq, wqkvs,
               _mk(rng, (3 * d,), 0.2), woq, wos, _mk(rng, (d,), 0.2))


# (rows, valid tokens): 24 padded rows, and past 256 keys, where K21b's
# attention streams its key tiles on the card (the JAX kernel pads the keys
# to 384)
@pytest.mark.parametrize("emit", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,n_valid", [
    pytest.param(24, 24, id="24"), pytest.param(24, 17, id="17"),
    pytest.param(264, 261, id="264-261"), pytest.param(264, 1, id="264-1")])
def test_attn_block_int8_stats_matches_pallas(n, n_valid, dtype, emit):
    """2 heads of 64 on 24 (or 264) padded rows, some of them valid; stats
    that are not x's own, f32 or bf16."""
    heads = 2
    x, args = _attn_case(n=n)
    xj, xt = _bf16_pair(x)
    stj, stt = _foreign_stats(np.asarray(xt.float()), dtype)
    b, n, _ = x.shape
    want, want_st = jqb.attn_block_int8_stats(
        xj, stj.reshape(b, n, STATS_LANES), *map(jnp.asarray, args), heads,
        n_valid=n_valid, emit_stats=emit, interpret=True)
    got, got_st = tqb.attn_block_int8_stats(
        xt, stt.reshape(b, n, 2), *map(torch.from_numpy, args), heads,
        n_valid=n_valid, emit_stats=emit)
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    # rows at or past n_valid are garbage by contract on both sides
    _close(got[:, :n_valid], want[:, :n_valid])
    if not emit:
        assert got_st is None and want_st is None
        return
    assert got_st.shape == (b, n, 2)
    _check_stats(got[:, :n_valid], got_st[:, :n_valid], want[:, :n_valid],
                 want_st[:, :n_valid], dtype)


def test_attn_block_int8_stats_loud_padding():
    """Padding rows of huge values and stats: their keys are masked, so
    the valid rows and their stats equal the quiet run's exactly."""
    heads, n_valid = 2, 17
    x, args = _attn_case(seed=2)
    loud = x.copy()
    loud[:, n_valid:] = 0.0
    loud[:, n_valid:, 5] = 3e3
    loud[:, n_valid:, 17] = -1e3
    targs = tuple(map(torch.from_numpy, args))
    xq, xl = _bf16_pair(x)[1], _bf16_pair(loud)[1]
    st_q, st_l = row_stats(xq, 1e-6), row_stats(xl, 1e-6)
    assert torch.equal(st_q[:, :n_valid], st_l[:, :n_valid])
    quiet, sq = tqb.attn_block_int8_stats(xq, st_q, *targs, heads,
                                          n_valid=n_valid)
    noisy, sn = tqb.attn_block_int8_stats(xl, st_l, *targs, heads,
                                          n_valid=n_valid)
    assert torch.equal(noisy[:, :n_valid], quiet[:, :n_valid])
    assert torch.equal(sn[:, :n_valid], sq[:, :n_valid])


def test_stats_halves_check_their_stats():
    x, args = _mlp_case(t=8)
    xt = _bf16_pair(x)[1]
    targs = tuple(map(torch.from_numpy, args))
    before = tqb.mlp_block_int8_stats.launches
    tqb.mlp_block_int8_stats(xt, row_stats(xt, 1e-6), *targs)
    assert tqb.mlp_block_int8_stats.launches == before
    with pytest.raises(ValueError, match="act"):
        tqb.mlp_block_int8_stats(xt, row_stats(xt, 1e-6), *targs,
                                 act="gelu")
    xa, aargs = _attn_case()
    before = tqb.attn_block_int8_stats.launches
    xat = _bf16_pair(xa)[1]
    tqb.attn_block_int8_stats(xat, row_stats(xat, 1e-6),
                              *map(torch.from_numpy, aargs), 2)
    assert tqb.attn_block_int8_stats.launches == before


# ---------------------------------------------------------------------------
# K22: the int8-scores attention half
# ---------------------------------------------------------------------------

def _scores_case(seed=3, b=2, n=13, heads=2):
    """tests/test_int8_static.py's test_attn_block_int8_scores_matches_ref
    inputs: (x, the argument tuple after x, up to num_heads)."""
    rng = np.random.default_rng(seed)
    d = heads * 64
    x = _mk(rng, (b, n, d), 1.0)
    s_x, s_ao, s_q, s_k, s_v = 0.028, 0.012, 0.05, 0.04, 0.03
    ls = (_mk(rng, (d,), 0.1) + 1.0) / s_x
    lb = _mk(rng, (d,), 0.1) / s_x
    wqkvq, wqkvs = quantize_weight_colwise(_mk(rng, (d, 3 * d)))
    woq, wos = quantize_weight_colwise(_mk(rng, (d, d)))
    bqkv = _mk(rng, (3 * d,), 0.2)
    thirds = np.concatenate([np.full((d,), v, np.float32)
                             for v in (s_q, s_k, s_v)])
    args = (np.float32(s_q * s_k), np.float32(s_v / 127.0 / s_ao), ls, lb,
            wqkvq, (wqkvs * s_x / thirds).astype(np.float32),
            (bqkv / thirds).astype(np.float32), woq,
            (wos * s_ao).astype(np.float32), _mk(rng, (d,), 0.2))
    return x, args


def _scores_jax(x, args, heads, n_valid, fn):
    xj = _bf16_pair(x)[0]
    return fn(xj, *map(jnp.asarray, args), heads, n_valid=n_valid)


def _scores_port(x, args, heads, n_valid):
    xt = _bf16_pair(x)[1]
    targs = [float(a) if np.ndim(a) == 0 else torch.from_numpy(a)
             for a in args]
    return tqb.attn_block_int8_static_scores(xt, *targs, heads,
                                             n_valid=n_valid)


@pytest.mark.parametrize("n,n_valid", [
    pytest.param(13, 13, id="13"), pytest.param(13, 9, id="9"),
    # past 256 keys, where the Hopper kernel once stopped: every key but
    # the last 128-key tile's 3 padding rows, and a single valid key
    pytest.param(264, 261, id="264-261"), pytest.param(264, 1, id="264-1")])
def test_attn_block_int8_static_scores_matches_pallas_and_ref(n, n_valid):
    heads = 2
    x, args = _scores_case(n=n)
    got = _scores_port(x, args, heads, n_valid)
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    kernel = _scores_jax(x, args, heads, n_valid, functools.partial(
        jqb.attn_block_int8_static_scores, interpret=True))
    ref = _scores_jax(x, args, heads, n_valid,
                      jqb.attn_block_int8s_static_ref)
    for want in (kernel, ref):
        np.testing.assert_allclose(
            got[:, :n_valid].float().numpy(),
            np.asarray(want[:, :n_valid].astype(jnp.float32)), rtol=0,
            atol=SCORES_ATOL)


def test_attn_block_int8_static_scores_saturates_and_masks():
    """q/k/v scales shrunk 4x: the int8 panel clips at +-127 and the plain
    version still follows the JAX reference; loud padding rows leave the
    valid rows bit for bit."""
    heads, n_valid = 2, 9
    x, args = _scores_case(seed=5)
    sc_qk, pv_fold, ls, lb, wq, wqs, bqs, woq, wos, bo = args
    hot = (np.float32(sc_qk / 16), np.float32(pv_fold / 4), ls, lb, wq,
           wqs * 4, bqs * 4, woq, wos, bo)
    xt = _bf16_pair(x)[1]
    xq = tqb._rint_i8(tqb._ln_f32(xt, torch.from_numpy(ls),
                                  torch.from_numpy(lb), 1e-6))
    pre = (tqb._int_matmul(xq, torch.from_numpy(wq)) * torch.from_numpy(
        wqs * 4) + torch.from_numpy(bqs * 4))
    assert float((pre.abs() > 127.5).float().mean()) > 1e-3
    got = _scores_port(x, hot, heads, n_valid)
    want = _scores_jax(x, hot, heads, n_valid,
                       jqb.attn_block_int8s_static_ref)
    np.testing.assert_allclose(
        got[:, :n_valid].float().numpy(),
        np.asarray(want[:, :n_valid].astype(jnp.float32)), rtol=0,
        atol=SCORES_ATOL)
    loud = x.copy()
    loud[:, n_valid:] = 0.0
    loud[:, n_valid:, 3] = 3e3
    noisy = _scores_port(loud, args, heads, n_valid)
    quiet = _scores_port(x, args, heads, n_valid)
    assert torch.equal(noisy[:, :n_valid], quiet[:, :n_valid])


@pytest.mark.parametrize("n,n_valid", [
    pytest.param(13, 9, id="9"), pytest.param(264, 261, id="264-261")])
def test_attn_block_int8s_static_ref_matches_jax(n, n_valid):
    """The port's attn_block_int8s_static_ref (the static tree's int8-scores
    attention past the block kernels' geometry) against the JAX one: every
    integer step agrees (SCORES_ATOL)."""
    heads = 2
    x, args = _scores_case(n=n)
    xt = _bf16_pair(x)[1]
    targs = [float(a) if np.ndim(a) == 0 else torch.from_numpy(a)
             for a in args]
    got = tqb.attn_block_int8s_static_ref(xt, *targs, heads, n_valid=n_valid)
    want = _scores_jax(x, args, heads, n_valid,
                       jqb.attn_block_int8s_static_ref)
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    np.testing.assert_allclose(
        got[:, :n_valid].float().numpy(),
        np.asarray(want[:, :n_valid].astype(jnp.float32)), rtol=0,
        atol=SCORES_ATOL)


def test_int8_scores_gate_refuses_other_geometries():
    """The JAX gate: dh 64 and an even head count, else ValueError."""
    x, args = _scores_case()
    for heads in (4, 1):
        xx = x if heads == 4 else x[..., :64]
        with pytest.raises(ValueError, match="dh=64, even heads"):
            _scores_port(xx, args, heads, 13)
    before = tqb.attn_block_int8_static_scores.launches
    _scores_port(x, args, 2, 13)
    assert tqb.attn_block_int8_static_scores.launches == before


# ---------------------------------------------------------------------------
# The forwards with the switches on
# ---------------------------------------------------------------------------

def _np_params(jcfg, seed):
    rng = np.random.default_rng(seed)
    params = jvit.init_params(jax.random.key(0), jcfg)
    return jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.02 * rng.normal(size=p.shape).astype(
            np.float32), params)


def _trees(seed, static, **kw):
    """(JAX cfg, port cfg, JAX int8 tree, the same tree in the port)."""
    cfg_kw = {**TINY, **kw}
    jcfg, tcfg = jvit.ViTConfig(**cfg_kw), tvit.ViTConfig(**cfg_kw)
    jp = jax.tree_util.tree_map(jnp.asarray, _np_params(jcfg, seed))
    jqp = (jq.quantize_vit_static(jp, jcfg) if static
           else jq.quantize_vit_fast(jp))
    return jcfg, tcfg, jqp, params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jqp), device="cpu")


def _images(seed, b=3, s=32):
    return np.random.default_rng(seed).integers(0, 256, (b, s, s, 3),
                                                np.uint8)


def _interp(monkeypatch, name, **kw):
    monkeypatch.setattr(jqb, name, functools.partial(
        getattr(jqb, name), interpret=True, **kw))


def _jax_composition(jqp, images, jcfg, encoder, n_pad=N_PAD):
    """The TPU branch of the JAX ``vit_forward_int8_fast`` written out:
    the dotg embed on bf16(wq * ws) onto ``n_pad`` rows, ``encoder(x)``,
    the CLS LayerNorm and the fused int8 head in interpret mode."""
    n, d = jcfg.seq_len, jcfg.hidden_dim
    x = jvit.preprocess(jnp.asarray(images), jcfg).astype(jnp.bfloat16)
    pe = jqp["patch_embed"]
    pos, pre = jqp["pos_embed"][0], jqp["cls_token"][0]
    posb = jnp.concatenate([pre + pos[:1], pos[1:] + pe["b"],
                            jnp.zeros((n_pad - n, d))], axis=0)
    wp = (pe["wq"].astype(jnp.float32) * pe["ws"]).astype(jnp.bfloat16)
    x = encoder(jax_embed(x, wp, posb, jcfg.patch_size, 1))
    cls = jvit._layernorm(x[:, :1], jqp["ln_f_scale"], jqp["ln_f_bias"],
                          jcfg.ln_eps)
    hd = jqp["head"]
    out = jax_linear(cls.reshape(x.shape[0], d), hd["wq"], hd["ws"],
                     hd["b"], interpret=True)
    return np.asarray(out.astype(jnp.float32))


def _chain_encoder(jqp, jcfg):
    return lambda x: jq._encoder_int8_stats_chain(x, jqp["blocks"], jcfg,
                                                  jcfg.seq_len)


def _scores_encoder(jqp, jcfg):
    def run(x):
        b, n_pad, d = x.shape
        act = ("quick_gelu" if jcfg.hidden_act == "quick_gelu"
               else "gelu_tanh")
        for i in range(jcfg.depth):
            blk = jax.tree_util.tree_map(lambda a: a[i], jqp["blocks"])
            x = jqb.attn_block_int8_static_scores(
                x, blk["sc_qk"], blk["pv_fold"], blk["ln1_scale"],
                blk["ln1_bias"], blk["wqkv_q"], blk["wqkv_qs"],
                blk["bqkv_qs"], blk["wo_q"], blk["wo_s"], blk["bo"],
                jcfg.num_heads, eps=jcfg.ln_eps, n_valid=jcfg.seq_len,
                interpret=True)
            x = jqb.mlp_block_int8_static(
                x.reshape(b * n_pad, d), blk["inv_ah"], blk["ln2_scale"],
                blk["ln2_bias"], blk["w1_q"], blk["w1_s"], blk["b1"],
                blk["w2_q"], blk["w2_s"], blk["b2"], eps=jcfg.ln_eps,
                act=act, block_t=32, interpret=True).reshape(b, n_pad, d)
        return x
    return run


@pytest.mark.parametrize("hidden_act", ["gelu", "quick_gelu"])
def test_chain_forward_matches_jax_kernel_composition(monkeypatch,
                                                      hidden_act):
    monkeypatch.setattr(tq, "_INT8_STATS_CHAIN", True)
    _interp(monkeypatch, "attn_block_int8_stats")
    _interp(monkeypatch, "mlp_block_int8_stats", block_t=24)
    jcfg, tcfg, jqp, tqp = _trees(1, False, hidden_act=hidden_act)
    img = _images(2)
    want = _jax_composition(jqp, img, jcfg, _chain_encoder(jqp, jcfg))
    prep = tq.prepare_int8(tqp, tcfg)
    calls = []
    real = tq._encoder_int8_stats_chain
    monkeypatch.setattr(tq, "_encoder_int8_stats_chain",
                        lambda *a: calls.append(1) or real(*a))
    got = tq.make_forward_int8(tcfg, prep, device="cpu")(img)
    assert calls and got.dtype == torch.float32 and got.shape == (3, 10)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=TIGHT * np.abs(want).max())


def test_chain_forward_past_256_tokens_matches_jax_kernel_composition(
        monkeypatch):
    """A 384-px-like geometry: 577 tokens (24 x 24 patches and the CLS
    row, ViT-B/16 @384's count) on 584 rows, head dim 64, two narrow
    layers, the int8 stats chain switched on.  The JAX gate keeps the
    chain there, and so does the port: every attention half is K21b
    (attn_block_int8_stats), inside the gate the card applies, and the
    logits hold to the JAX composition of the Pallas kernels as tightly as
    at 17 tokens."""
    monkeypatch.setattr(tq, "_INT8_STATS_CHAIN", True)
    _interp(monkeypatch, "attn_block_int8_stats")
    _interp(monkeypatch, "mlp_block_int8_stats", block_t=584)
    jcfg, tcfg, jqp, tqp = _trees(14, False, image_size=192)
    assert tcfg.seq_len == 577 and tq._int8_stats_chain_supported(tcfg, 2)
    shapes = []

    def k21b(x, st, *args, n_valid=None, **kwargs):
        shapes.append((tuple(x.shape), n_valid))
        tqb.attn_int8_stats_geometry(*x.shape, args[-1], n_valid)
        return tqb.attn_block_int8_stats(x, st, *args, n_valid=n_valid,
                                         **kwargs)

    monkeypatch.setattr(tq, "attn_block_int8_stats", k21b)
    img = _images(15, b=2, s=192)
    want = _jax_composition(jqp, img, jcfg, _chain_encoder(jqp, jcfg),
                            n_pad=584)
    got = tq.make_forward_int8(tcfg, tqp, device="cpu")(img)
    assert shapes == [((2, 584, 128), 577)] * 2
    assert got.shape == (2, 10) and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=TIGHT * np.abs(want).max())


def test_chain_forward_holds_to_the_jax_cpu_forward(monkeypatch):
    monkeypatch.setattr(tq, "_INT8_STATS_CHAIN", True)
    monkeypatch.setattr(jq, "_INT8_STATS_CHAIN", True)
    jcfg, tcfg, jqp, tqp = _trees(3, False, image_size=64)
    img = _images(4, b=4, s=64)
    want = np.asarray(jq.vit_forward_int8_raw(jqp, jnp.asarray(img), jcfg))
    got = tq.make_forward_int8(tcfg, tqp, device="cpu")(img).numpy()
    assert np.abs(got - want).max() <= LOOSE * np.abs(want).max()
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))


def test_int8_scores_forward_matches_jax_kernel_composition(monkeypatch):
    monkeypatch.setattr(tq, "_INT8_SCORES", True)
    jcfg, tcfg, jqp, tqp = _trees(5, True)
    img = _images(6)
    want = _jax_composition(jqp, img, jcfg, _scores_encoder(jqp, jcfg))
    calls = []
    real = tq.attn_block_int8_static_scores
    monkeypatch.setattr(tq, "attn_block_int8_static_scores",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    got = tq.make_forward_int8(tcfg, tqp, device="cpu")(img)
    assert len(calls) == jcfg.depth and got.shape == (3, 10)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=TIGHT * np.abs(want).max())


def test_int8_scores_forward_past_256_tokens_matches_jax_kernel_composition(
        monkeypatch):
    """A 384-px-like geometry: 577 tokens (24 x 24 patches and the CLS
    row, ViT-B/16 @384's count) on 584 rows, head dim 64, two narrow
    layers, a static tree with the int8-scores switch on.  The JAX wrapper
    runs its kernel there (two score slots), and so does the port: every
    attention half is K22 (attn_block_int8_static_scores), inside the gate
    the card applies, and the logits hold to the JAX composition of the
    Pallas kernels as tightly as at 17 tokens."""
    monkeypatch.setattr(tq, "_INT8_SCORES", True)
    jcfg, tcfg, jqp, tqp = _trees(16, True, image_size=192)
    assert tcfg.seq_len == 577
    shapes = []

    def k22(x, *args, n_valid=None, **kwargs):
        shapes.append((tuple(x.shape), n_valid))
        tqb.attn_int8_scores_geometry(*x.shape, args[-1], n_valid)
        return tqb.attn_block_int8_static_scores(x, *args, n_valid=n_valid,
                                                 **kwargs)

    monkeypatch.setattr(tq, "attn_block_int8_static_scores", k22)
    img = _images(17, b=2, s=192)
    want = _jax_composition(jqp, img, jcfg, _scores_encoder(jqp, jcfg),
                            n_pad=584)
    got = tq.make_forward_int8(tcfg, tqp, device="cpu")(img)
    assert shapes == [((2, 584, 128), 577)] * 2
    assert got.shape == (2, 10) and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=TIGHT * np.abs(want).max())


def test_int8_scores_forward_holds_to_the_jax_cpu_forward(monkeypatch):
    monkeypatch.setattr(tq, "_INT8_SCORES", True)
    monkeypatch.setattr(jq, "_INT8_SCORES", True)
    jcfg, tcfg, jqp, tqp = _trees(7, True, image_size=64)
    img = _images(8, b=4, s=64)
    want = np.asarray(jq.vit_forward_int8_raw(jqp, jnp.asarray(img), jcfg))
    got = tq.make_forward_int8(tcfg, tqp, device="cpu")(img).numpy()
    assert np.abs(got - want).max() <= LOOSE * np.abs(want).max()
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))


# ---------------------------------------------------------------------------
# The gates
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant,image,batch,on", [
    ("vit_b16", 224, 64, True), ("vit_b16", 224, 1, True),
    ("vit_b16", 224, 3, True), ("vit_l16", 384, 2, True),
    ("vit_l16", 384, 3, False),       # q-slot reuse
    ("vit_b16", 1024, 4, False),      # no int8 block plan
])
def test_chain_gate_is_the_jax_gate_on_a_tpu(monkeypatch, variant, image,
                                             batch, on):
    """Off by default; switched on, the JAX gate as a TPU computes it
    (``jax.default_backend`` patched to "tpu")."""
    tcfg = tvit.config(variant, image_size=image)
    jcfg = jvit.config(variant, image_size=image)
    assert tq._INT8_STATS_CHAIN is False and jq._INT8_STATS_CHAIN is False
    assert not tq._int8_stats_chain_supported(tcfg, batch)
    monkeypatch.setattr(tq, "_INT8_STATS_CHAIN", True)
    monkeypatch.setattr(jq, "_INT8_STATS_CHAIN", True)
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    assert tq._int8_stats_chain_supported(tcfg, batch) is on
    assert jq._int8_stats_chain_supported(jcfg, batch) is on


def test_switches_off_keep_the_earlier_paths(monkeypatch):
    """With both switches off (the default) the forwards never reach the
    chain or K22."""
    def boom(*a, **k):
        raise AssertionError("reached a switched-off path")
    monkeypatch.setattr(tq, "_encoder_int8_stats_chain", boom)
    monkeypatch.setattr(tq, "attn_block_int8_static_scores", boom)
    for static in (False, True):
        _, tcfg, _, tqp = _trees(9, static)
        out = tq.make_forward_int8(tcfg, tqp, device="cpu")(_images(9, b=2))
        assert out.shape == (2, 10)


def test_static_tree_under_the_chain_raises(monkeypatch):
    """The reference behaviour the port refuses: the JAX chain runs a
    static tree as a dynamic one, so each layer's attention branch comes
    out scaled by s_ao and its MLP branch by s_h (the folded wo_s, w2_s),
    exactly the chain over the dynamic tree with those scales, and far
    from the static forward.  The port raises instead."""
    _interp(monkeypatch, "attn_block_int8_stats")
    _interp(monkeypatch, "mlp_block_int8_stats", block_t=24)
    jcfg, tcfg, jstat, tstat = _trees(11, True)
    jdyn = _trees(11, False)[2]
    x = jnp.asarray(np.random.default_rng(12).normal(
        size=(2, N_PAD, jcfg.hidden_dim)), jnp.bfloat16)
    sb, db = jstat["blocks"], jdyn["blocks"]
    scaled = dict(db, wo_s=db["wo_s"] * (1.0 / sb["inv_ao"]),
                  w2_s=db["w2_s"] * (1.0 / sb["inv_ah"]))
    np.testing.assert_allclose(sb["wo_s"], scaled["wo_s"], rtol=1e-6)
    chain_static = jq._encoder_int8_stats_chain(x, sb, jcfg, 17)
    chain_scaled = jq._encoder_int8_stats_chain(x, scaled, jcfg, 17)
    xs = x
    for i in range(jcfg.depth):
        xs = jq._qblock_static(xs, jax.tree_util.tree_map(
            lambda a: a[i], sb), jcfg, n_valid=17)

    def f(a):
        return np.asarray(a[:, :17], np.float32)
    assert np.abs(f(chain_static) - f(chain_scaled)).max() <= 2.0 ** -6
    assert (np.abs(f(chain_static) - f(xs)).max()
            > 0.5 * np.abs(f(xs) - f(x)).max())
    monkeypatch.setattr(tq, "_INT8_STATS_CHAIN", True)
    with pytest.raises(NotImplementedError, match="dynamic tree"):
        tq.make_forward_int8(tcfg, tstat, device="cpu")(_images(13))
