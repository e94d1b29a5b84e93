"""The port's stats-chain attention half (plain PyTorch version of the
Hopper kernel K1) past 256 keys, where the kernel streams the keys in
tiles, against the JAX Pallas kernel in interpret mode: CLIP ViT-L/14's
257 tokens on 264 rows and ViT-L/16 @384's 577 on 584, at a narrow width
(D 128, 2 heads of 64), and past 1024 tokens (1025 on 1032 rows, 2305 on
2312 at D 256).  And the per-block half (K4) past 256 keys, in both
softmax modes, against the JAX attn_block_pallas, also at ViT-B/16
@896's 3137 tokens.  The K1 / K4 gates and the backward's ``_bwd_fits``
against the JAX predicates."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_fpga_tpu.ops import attn_block as jab
from vit_fpga_tpu.ops.attn_block import (STATS_LANES, attn_block_pallas,
                                         attn_block_stats_pallas)
from vit_fpga_tpu_torch.ops import attn_block as tab

D, NH = 128, 2
_PARAMS = ("ls", "lb", "wqkv", "bqkv", "wo", "bo")
# bf16 kernel band: 2 bf16 ulps of |want| plus 2^-8.
BF16_RTOL, BF16_ATOL = 2 ** -7, 2 ** -8


def _stats_of(x2d, eps=1e-6):
    xf = np.asarray(x2d, np.float32)
    mu = xf.mean(-1, keepdims=True)
    var = np.maximum((xf * xf).mean(-1, keepdims=True) - mu * mu, 0.0)
    st = np.zeros((xf.shape[0], STATS_LANES), np.float32)
    st[:, 0:1] = mu
    st[:, 1:2] = 1.0 / np.sqrt(var + eps)
    return st


def _inputs(seed, n_pad, d=D):
    """The scales of tests/test_torch_attn_block.py: the branch y stays
    smaller than x, so out = x + bf16(y) does not cancel (where it does, a
    flipped last bit of bf16(y) is more than 2 ulps of |out|).  Wider than
    D 128 the weights shrink by sqrt(128 / d), so y keeps its size."""
    rng = np.random.default_rng(seed)
    w = 0.1 * (D / d) ** 0.5

    def f(*shape, sc=0.1):
        return (rng.normal(size=shape) * sc).astype(np.float32)

    return dict(x=f(1, n_pad, d, sc=0.5), ls=1.0 + f(d), lb=f(d),
                wqkv=f(d, 3 * d, sc=w), bqkv=f(3 * d), wo=f(d, d, sc=w),
                bo=f(d))


def _run_both(p, dj, dt, n_valid, emit_stats, heads=NH):
    x_j = jnp.asarray(p["x"]).astype(dj)
    b, n, d = p["x"].shape
    xf = np.array(x_j.astype(jnp.float32))
    st = _stats_of(xf.reshape(-1, d)).reshape(b, n, STATS_LANES)
    want, want_st = attn_block_stats_pallas(
        x_j, jnp.asarray(st), *[jnp.asarray(p[k]) for k in _PARAMS], heads,
        n_valid=n_valid, emit_stats=emit_stats, interpret=True)
    got, got_st = tab.attn_block_stats(
        torch.from_numpy(xf).to(dt), torch.from_numpy(st[..., :2].copy()),
        *[torch.from_numpy(p[k]) for k in _PARAMS], heads, n_valid=n_valid,
        emit_stats=emit_stats)
    return want, want_st, got, got_st


@pytest.mark.parametrize("emit_stats", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_pad,n_valid", [(264, 257), (584, 577)])
def test_long_attn_plain_matches_pallas(n_pad, n_valid, dtype, emit_stats):
    """f32: same arithmetic, summation order only (1e-5).  bf16: qkv, the
    probabilities and the attention output are rounded at the same points;
    accumulation order flips an occasional ulp."""
    dj, dt = ((jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16"
              else (jnp.float32, torch.float32))
    want, want_st, got, got_st = _run_both(_inputs(n_pad, n_pad), dj, dt,
                                           n_valid, emit_stats)
    v = slice(0, n_valid)    # rows past n_valid are garbage on both sides
    g = got.float().numpy()[:, v]
    w = np.asarray(want.astype(jnp.float32))[:, v]
    if dtype == "float32":
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_allclose(g, w, rtol=BF16_RTOL, atol=BF16_ATOL)
    if emit_stats:
        tol = 1e-4 if dtype == "float32" else 1e-2
        np.testing.assert_allclose(got_st.numpy()[:, v],
                                   np.asarray(want_st)[:, v, :2], rtol=tol,
                                   atol=tol)
    else:
        assert got_st is None and want_st is None


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_long_attn_loud_padding_leaves_valid_rows(dtype):
    """Rows at or past n_valid blown up 1e4x: their keys are masked, so the
    valid rows come out bit for bit as with quiet padding, and still match
    the JAX kernel."""
    n_pad, n_valid = 584, 577
    dt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    p = _inputs(7, n_pad)
    loud = dict(p, x=p["x"].copy())
    loud["x"][:, n_valid:] *= 1e4

    def port(q):
        x = torch.from_numpy(q["x"]).to(dt)
        st = torch.from_numpy(_stats_of(x.float().numpy().reshape(-1, D))
                              [:, :2].reshape(1, n_pad, 2).copy())
        out, st_out = tab.attn_block_stats(
            x, st, *[torch.from_numpy(q[k]) for k in _PARAMS], NH,
            n_valid=n_valid)
        return out[:, :n_valid], st_out[:, :n_valid]

    (qo, qs), (lo, ls) = port(p), port(loud)
    assert torch.equal(qo, lo) and torch.equal(qs, ls)
    dj = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    want, _, _, _ = _run_both(loud, dj, dt, n_valid, True)
    w = np.asarray(want.astype(jnp.float32))[:, :n_valid]
    tol = (1e-5, 1e-5) if dtype == "float32" else (BF16_RTOL, BF16_ATOL)
    np.testing.assert_allclose(lo.float().numpy(), w, rtol=tol[0],
                               atol=tol[1])


@pytest.mark.parametrize("emit_stats", [True, False])
@pytest.mark.parametrize("n_pad,n_valid,d", [(1032, 1025, 128),
                                             (2312, 2305, 256)])
def test_k1_past_1024_tokens_plain_matches_pallas(n_pad, n_valid, d,
                                                  emit_stats):
    """K1 where the JAX planner keeps the chain past 1024 tokens (ViT-B/16
    @512's 1025 tokens, @768's 2305), at widths its plan admits (2 and 4
    heads of 64), in bf16: the rounding points of the kernel, within 2
    bf16 ulps of |want| plus 2^-8."""
    heads = d // 64
    assert tab.attn_stats_fits(1, n_pad, d, heads)
    want, want_st, got, got_st = _run_both(
        _inputs(n_pad, n_pad, d), jnp.bfloat16, torch.bfloat16, n_valid,
        emit_stats, heads)
    v = slice(0, n_valid)
    np.testing.assert_allclose(got.float().numpy()[:, v],
                               np.asarray(want.astype(jnp.float32))[:, v],
                               rtol=BF16_RTOL, atol=BF16_ATOL)
    if emit_stats:
        np.testing.assert_allclose(got_st.numpy()[:, v],
                                   np.asarray(want_st)[:, v, :2], rtol=1e-2,
                                   atol=1e-2)


def test_long_attn_rejects_unsupported_device():
    """Only CPU and CUDA tensors are taken: a meta tensor raises.  The
    CUDA gate (head dim 64, 1 <= n_valid <= n_pad, attn_stats_fits) is
    checked on the card by chip_smoke.py."""
    p = _inputs(8, 264)
    with pytest.raises(ValueError):
        tab.attn_block_stats(
            torch.empty((1, 264, D), device="meta"),
            torch.empty((1, 264, 2), device="meta"),
            *[torch.from_numpy(p[k]) for k in _PARAMS], NH, n_valid=257)


@pytest.mark.parametrize("safe", [True, False], ids=["safe", "maxfree"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k4_long_plain_matches_pallas(safe, dtype):
    """K4's plain version at 300 valid keys on 304 rows (past the 256 keys
    of its whole-head tile: on the card the key-tiled tile, which in the
    exact mode takes the row max in a first sweep) against the JAX
    attn_block_pallas in interpret mode.  f32: summation order only
    (1e-5); bf16: both round qkv, e and the attention output at the same
    points (2 bf16 ulps of |want| plus 2^-8)."""
    n_pad, n_valid = 304, 300
    dj, dt = ((jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16"
              else (jnp.float32, torch.float32))
    p = _inputs(11, n_pad)
    x_j = jnp.asarray(p["x"]).astype(dj)
    want = attn_block_pallas(x_j, *[jnp.asarray(p[k]) for k in _PARAMS], NH,
                             n_valid=n_valid, safe_softmax=safe,
                             interpret=True)
    got = tab.attn_block_fwd(
        torch.from_numpy(np.array(x_j.astype(jnp.float32))).to(dt),
        *[torch.from_numpy(p[k]) for k in _PARAMS], NH, n_valid=n_valid,
        safe_softmax=safe)
    g = got.float().numpy()[:, :n_valid]
    w = np.asarray(want.astype(jnp.float32))[:, :n_valid]
    if dtype == "float32":
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_allclose(g, w, rtol=BF16_RTOL, atol=BF16_ATOL)


@pytest.mark.parametrize("safe", [True, False], ids=["safe", "maxfree"])
def test_k4_at_3137_tokens_plain_matches_pallas(safe):
    """K4 at ViT-B/16 @896's 3137 tokens on 3144 rows (25 key tiles on the
    card; the JAX plan's one score slot at D 128, 2 heads) against the JAX
    attn_block_pallas in interpret mode, bf16, in both softmax modes."""
    n_pad, n_valid = 3144, 3137
    assert tab.attn_block_fits(1, n_pad, D, NH)
    p = _inputs(13, n_pad)
    x_j = jnp.asarray(p["x"]).astype(jnp.bfloat16)
    want = attn_block_pallas(x_j, *[jnp.asarray(p[k]) for k in _PARAMS], NH,
                             n_valid=n_valid, safe_softmax=safe,
                             interpret=True)
    got = tab.attn_block_fwd(
        torch.from_numpy(np.array(x_j.astype(jnp.float32))).to(
            torch.bfloat16),
        *[torch.from_numpy(p[k]) for k in _PARAMS], NH, n_valid=n_valid,
        safe_softmax=safe)
    np.testing.assert_allclose(
        got.float().numpy()[:, :n_valid],
        np.asarray(want.astype(jnp.float32))[:, :n_valid], rtol=BF16_RTOL,
        atol=BF16_ATOL)


# The geometries of the bf16 attention halves from ViT-B/16 @448 to @1024,
# ViT-L/16 and CLIP ViT-L/14 past 1024 tokens, CLIP ViT-L/14 @224 at odd
# and even batches, and the narrow test widths: (batch, tokens, D, heads)
GATE_CASES = [
    (1, 785, 768, 12), (1, 1025, 768, 12), (64, 1025, 768, 12),
    (1, 1297, 768, 12), (2, 1601, 768, 12), (1, 2305, 768, 12),
    (4, 3137, 768, 12), (1, 4097, 768, 12), (1, 1025, 1024, 16),
    (1, 1297, 1024, 16), (1, 2305, 1024, 16), (3, 1025, 1024, 16),
    (1, 257, 1024, 16), (2, 257, 1024, 16), (1, 1025, 128, 2),
    (1, 1601, 128, 2), (1, 2305, 256, 4), (1, 3137, 128, 2),
]


@pytest.mark.parametrize("b,n,d,heads", GATE_CASES)
def test_gates_are_the_jax_predicates(b, n, d, heads):
    """K1's gate (the JAX attn_block_stats_pallas: a score slot and no
    q-slot reuse), K4's (attn_block_pallas: a score slot) and the
    backward's _bwd_fits, at bf16's itemsize, are the JAX package's, and
    K4's shape check raises exactly where its gate fails (meta tensors
    reach it)."""
    n_pad, kv_pad = -(-n // 8) * 8, -(-n // 128) * 128
    plan = jab.attn_plan(heads, d, n_pad, kv_pad, 2, batch=b)
    assert tab.attn_stats_fits(b, n_pad, d, heads) == (
        plan.n_sc >= 1 and not plan.reuse_q)
    assert tab.attn_block_fits(b, n_pad, d, heads) == (plan.n_sc >= 1)
    assert tab._bwd_fits(heads, d, n_pad, kv_pad, 2) == jab._bwd_fits(
        heads, d, n_pad, kv_pad, 2)
    x = torch.empty((b, n_pad, d), dtype=torch.bfloat16, device="meta")
    if plan.n_sc >= 1:
        assert tab._cuda_geometry(x, heads, n, kernel="K4") == (
            b, n_pad, d, n)
    else:
        with pytest.raises(ValueError, match="score slot"):
            tab._cuda_geometry(x, heads, n, kernel="K4")
    assert tab._cuda_geometry(x, heads, n, kernel="K23") == (b, n_pad, d, n)


def test_k4_long_safe_softmax_takes_wide_scores():
    """Scores far outside the max-free clip window (q and k 20x larger,
    scores past exp's f32 range): the exact mode's plain version stays
    finite and matches the JAX kernel in relative norm of the branch.  The
    400x wider scores turn a score's f32 rounding (1e-7 of scores of order
    100) into 1e-5 of its e, so the band is 1e-4 rather than the 1e-5 of
    quiet scores.  chip_smoke.py holds the key-tiled safe tile to this
    case."""
    n_pad, n_valid = 304, 300
    p = _inputs(12, n_pad)
    p = dict(p, wqkv=p["wqkv"].copy())
    p["wqkv"][:, :2 * D] *= 20.0
    xn = p["x"][0] - p["x"][0].mean(-1, keepdims=True)
    xn = xn / np.sqrt((xn * xn).mean(-1, keepdims=True) + 1e-6)
    qkv = (xn * p["ls"] + p["lb"]) @ p["wqkv"] + p["bqkv"]
    scores = qkv[:, :64] @ qkv[:n_valid, D:D + 64].T / 8.0
    assert scores.max() > 100.0        # exp(s) alone overflows f32
    want = attn_block_pallas(jnp.asarray(p["x"]),
                             *[jnp.asarray(p[k]) for k in _PARAMS], NH,
                             n_valid=n_valid, safe_softmax=True,
                             interpret=True)
    got = tab.attn_block_fwd(torch.from_numpy(p["x"]),
                             *[torch.from_numpy(p[k]) for k in _PARAMS], NH,
                             n_valid=n_valid, safe_softmax=True)
    g = got.numpy()[:, :n_valid]
    w = np.asarray(want)[:, :n_valid]
    assert np.isfinite(g).all()
    x = p["x"][:, :n_valid]
    assert np.linalg.norm(g - w) <= 1e-4 * np.linalg.norm(w - x)
