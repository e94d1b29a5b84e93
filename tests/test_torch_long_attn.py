"""The port's stats-chain attention half (plain PyTorch version of the
Hopper kernel K1) past 256 keys, where the kernel streams the keys in
tiles, against the JAX Pallas kernel in interpret mode: CLIP ViT-L/14's
257 tokens on 264 rows and ViT-L/16 @384's 577 on 584, at a narrow width
(D 128, 2 heads of 64).  And the per-block half (K4) past 256 keys, in
both softmax modes, against the JAX attn_block_pallas."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

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


def _inputs(seed, n_pad):
    """The scales of tests/test_torch_attn_block.py: the branch y stays
    smaller than x, so out = x + bf16(y) does not cancel (where it does, a
    flipped last bit of bf16(y) is more than 2 ulps of |out|)."""
    rng = np.random.default_rng(seed)

    def f(*shape, sc=0.1):
        return (rng.normal(size=shape) * sc).astype(np.float32)

    return dict(x=f(1, n_pad, D, sc=0.5), ls=1.0 + f(D), lb=f(D),
                wqkv=f(D, 3 * D), bqkv=f(3 * D), wo=f(D, D), bo=f(D))


def _run_both(p, dj, dt, n_valid, emit_stats):
    x_j = jnp.asarray(p["x"]).astype(dj)
    b, n, _ = p["x"].shape
    xf = np.array(x_j.astype(jnp.float32))
    st = _stats_of(xf.reshape(-1, D)).reshape(b, n, STATS_LANES)
    want, want_st = attn_block_stats_pallas(
        x_j, jnp.asarray(st), *[jnp.asarray(p[k]) for k in _PARAMS], NH,
        n_valid=n_valid, emit_stats=emit_stats, interpret=True)
    got, got_st = tab.attn_block_stats(
        torch.from_numpy(xf).to(dt), torch.from_numpy(st[..., :2].copy()),
        *[torch.from_numpy(p[k]) for k in _PARAMS], NH, n_valid=n_valid,
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


def test_long_attn_rejects_unsupported_device():
    """Only CPU and CUDA tensors are taken: a meta tensor raises.  The
    CUDA gate (head dim 64, 1 <= n_valid <= n_pad <= 1024) is checked on
    the card by chip_smoke.py."""
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
