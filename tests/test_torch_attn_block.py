"""The port's stats-chain attention half (plain PyTorch version of the
Hopper kernel K1) against the JAX Pallas kernel in interpret mode, on the
same seeded numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_fpga_tpu.ops.attn_block import (STATS_LANES, attn_block_stats_pallas,
                                         attn_block_xla as jax_attn_block_xla)
from vit_fpga_tpu_torch.ops import attn_block as tab

B, N, D, NH, N_VALID = 2, 32, 64, 2, 28


def _stats_of(x2d, eps=1e-6):
    xf = np.asarray(x2d, np.float32)
    mu = xf.mean(-1, keepdims=True)
    var = np.maximum((xf * xf).mean(-1, keepdims=True) - mu * mu, 0.0)
    st = np.zeros((xf.shape[0], STATS_LANES), np.float32)
    st[:, 0:1] = mu
    st[:, 1:2] = 1.0 / np.sqrt(var + eps)
    return st


def _inputs(seed):
    rng = np.random.default_rng(seed)

    def f(*shape, sc=0.1):
        return (rng.normal(size=shape) * sc).astype(np.float32)

    x = f(B, N, D, sc=0.5)
    return dict(x=x, ls=1.0 + f(D), lb=f(D), wqkv=f(D, 3 * D), bqkv=f(3 * D),
                wo=f(D, D), bo=f(D))


def _run_both(p, dt_jax, dt_torch, emit_stats):
    x_j = jnp.asarray(p["x"]).astype(dt_jax)
    st = _stats_of(np.asarray(x_j.astype(jnp.float32)).reshape(-1, D))
    st = st.reshape(B, N, STATS_LANES)
    args = [p[k] for k in ("ls", "lb", "wqkv", "bqkv", "wo", "bo")]
    want, want_st = attn_block_stats_pallas(
        x_j, jnp.asarray(st), *[jnp.asarray(a) for a in args], NH,
        n_valid=N_VALID, emit_stats=emit_stats, interpret=True)
    x_t = torch.from_numpy(np.array(x_j.astype(jnp.float32))).to(dt_torch)
    got, got_st = tab.attn_block_stats(
        x_t, torch.from_numpy(st[..., :2].copy()),
        *[torch.from_numpy(a) for a in args], NH, n_valid=N_VALID,
        emit_stats=emit_stats)
    return want, want_st, got, got_st


def _f32(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t, np.float32)


@pytest.mark.parametrize("emit_stats", [True, False])
def test_attn_block_stats_f32_matches_pallas(emit_stats):
    """f32: same arithmetic, only summation order differs -> ~1e-5."""
    want, want_st, got, got_st = _run_both(_inputs(0), jnp.float32,
                                           torch.float32, emit_stats)
    v = slice(0, N_VALID)   # rows past n_valid are garbage on both sides
    np.testing.assert_allclose(_f32(got)[:, v], _f32(want)[:, v],
                               rtol=1e-5, atol=1e-5)
    if emit_stats:
        np.testing.assert_allclose(_f32(got_st)[:, v],
                                   _f32(want_st)[:, v, :2],
                                   rtol=1e-4, atol=1e-5)
    else:
        assert got_st is None and want_st is None


@pytest.mark.parametrize("emit_stats", [True, False])
def test_attn_block_stats_bf16_matches_pallas(emit_stats):
    """bf16: both round qkv, probabilities and the attention output to
    bf16 at the same points; accumulation order flips an occasional bf16
    ulp (2^-8 relative), which the out-projection spreads.  Band: 2 ulp of
    the output scale."""
    want, want_st, got, got_st = _run_both(_inputs(1), jnp.bfloat16,
                                           torch.bfloat16, emit_stats)
    v = slice(0, N_VALID)
    g, w = _f32(got)[:, v], _f32(want)[:, v]
    np.testing.assert_allclose(g, w, rtol=2 ** -7, atol=2 ** -7)
    if emit_stats:
        np.testing.assert_allclose(_f32(got_st)[:, v],
                                   _f32(want_st)[:, v, :2],
                                   rtol=1e-2, atol=1e-2)


def test_attn_block_xla_matches_jax():
    """The exact-softmax reference, f32."""
    p = _inputs(2)
    args = [p[k] for k in ("ls", "lb", "wqkv", "bqkv", "wo", "bo")]
    want = jax_attn_block_xla(jnp.asarray(p["x"]),
                              *[jnp.asarray(a) for a in args], NH,
                              n_valid=N_VALID)
    got = tab.attn_block_xla(torch.from_numpy(p["x"]),
                             *[torch.from_numpy(a) for a in args], NH,
                             n_valid=N_VALID)
    np.testing.assert_allclose(got.numpy()[:, :N_VALID],
                               np.asarray(want)[:, :N_VALID],
                               rtol=1e-5, atol=1e-5)


def test_maxfree_equals_exact_softmax_inside_clip_window():
    """Inside [-70, 80] the kernel's max-free softmax is the exact one."""
    p = _inputs(3)
    x = torch.from_numpy(p["x"])
    st = torch.from_numpy(_stats_of(p["x"].reshape(-1, D))[:, :2].copy())
    args = [torch.from_numpy(p[k]) for k in
            ("ls", "lb", "wqkv", "bqkv", "wo", "bo")]
    got, _ = tab.attn_block_stats(x, st.reshape(B, N, 2), *args, NH,
                                  n_valid=N_VALID)
    want = tab.attn_block_xla(x, *args, NH, n_valid=N_VALID)
    np.testing.assert_allclose(got.numpy()[:, :N_VALID],
                               want.numpy()[:, :N_VALID],
                               rtol=1e-5, atol=1e-5)


def test_kernel_wrapper_rejects_non_cpu_non_cuda_devices():
    p = _inputs(4)
    x = torch.from_numpy(p["x"]).to("meta")
    with pytest.raises(ValueError):
        tab.attn_block_stats(x, torch.empty((B, N, 2), device="meta"),
                             *[torch.from_numpy(p[k]) for k in
                               ("ls", "lb", "wqkv", "bqkv", "wo", "bo")],
                             NH, n_valid=N_VALID)


# The card's kernel tiles queries and keys by 128 (two 64-row consumer
# warpgroups, 128-key tiles): these cases put n_valid on either side of a
# key tile's edge, with padding rows up to n_pad 136 past a 128-row block.
EDGE_B, EDGE_N, EDGE_D, EDGE_NH = 2, 136, 128, 2


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("n_valid", [127, 128, 129])
def test_attn_block_stats_at_tile_edges_matches_pallas(n_valid, dtype):
    """Plain K1 against the Pallas kernel at the key-tile edges, in the
    existing cases' bands (f32 1e-5, bf16 2 ulp of the output scale)."""
    dt_jax, dt_torch, tol = ((jnp.float32, torch.float32, 1e-5)
                             if dtype == "f32" else
                             (jnp.bfloat16, torch.bfloat16, 2 ** -7))
    rng = np.random.default_rng(10 + n_valid)

    def f(*shape, sc=0.1):
        return (rng.normal(size=shape) * sc).astype(np.float32)

    d = EDGE_D
    x_j = jnp.asarray(f(EDGE_B, EDGE_N, d, sc=0.5)).astype(dt_jax)
    args = [1.0 + f(d), f(d), f(d, 3 * d), f(3 * d), f(d, d), f(d)]
    st = _stats_of(np.asarray(x_j.astype(jnp.float32)).reshape(-1, d))
    st = st.reshape(EDGE_B, EDGE_N, STATS_LANES)
    want, want_st = attn_block_stats_pallas(
        x_j, jnp.asarray(st), *[jnp.asarray(a) for a in args], EDGE_NH,
        n_valid=n_valid, emit_stats=True, interpret=True)
    x_t = torch.from_numpy(np.array(x_j.astype(jnp.float32))).to(dt_torch)
    got, got_st = tab.attn_block_stats_plain(
        x_t, torch.from_numpy(st[..., :2].copy()),
        *[torch.from_numpy(a) for a in args], EDGE_NH, n_valid=n_valid)
    v = slice(0, n_valid)
    np.testing.assert_allclose(_f32(got)[:, v], _f32(want)[:, v],
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(_f32(got_st)[:, v], _f32(want_st)[:, v, :2],
                               rtol=1e-4 if dtype == "f32" else 1e-2,
                               atol=1e-5 if dtype == "f32" else 1e-2)
