"""The port's stats-chain MLP half (plain PyTorch version of the Hopper
kernel K2) against the JAX Pallas kernel in interpret mode, and its
activations against jax.nn, on the same seeded numpy inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_fpga_tpu.ops.fused_mlp import (STATS_LANES, fused_mlp_stats_pallas,
                                        fused_mlp_xla as jax_fused_mlp_xla)
from vit_fpga_tpu_torch.ops import fused_mlp as tfm

T, D, M = 64, 64, 128


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

    return dict(x=f(T, D, sc=0.5), ls=1.0 + f(D), lb=f(D), w1=f(D, M),
                b1=f(M), w2=f(M, D), b2=f(D))


_PARAMS = ("ls", "lb", "w1", "b1", "w2", "b2")


def _run_both(p, dt_jax, dt_torch, emit_stats, act="gelu_tanh"):
    x_j = jnp.asarray(p["x"]).astype(dt_jax)
    xf = np.array(x_j.astype(jnp.float32))
    st = _stats_of(xf)
    want, want_st = fused_mlp_stats_pallas(
        x_j, jnp.asarray(st), *[jnp.asarray(p[k]) for k in _PARAMS],
        act=act, emit_stats=emit_stats, interpret=True)
    got, got_st = tfm.fused_mlp_stats(
        torch.from_numpy(xf).to(dt_torch), torch.from_numpy(st[:, :2].copy()),
        *[torch.from_numpy(p[k]) for k in _PARAMS], act=act,
        emit_stats=emit_stats)
    return want, want_st, got, got_st


@pytest.mark.parametrize("emit_stats", [True, False])
def test_fused_mlp_stats_f32_matches_pallas(emit_stats):
    """f32: same arithmetic, summation order only -> ~1e-5."""
    want, want_st, got, got_st = _run_both(_inputs(0), jnp.float32,
                                           torch.float32, emit_stats)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    if emit_stats:
        np.testing.assert_allclose(got_st.numpy(), np.asarray(want_st)[:, :2],
                                   rtol=1e-4, atol=1e-5)
    else:
        assert got_st is None and want_st is None


@pytest.mark.parametrize("emit_stats", [True, False])
def test_fused_mlp_stats_bf16_matches_pallas(emit_stats):
    """bf16: the hidden activation and the output are rounded to bf16 at
    the same points; accumulation order flips an occasional bf16 ulp
    (2^-8 relative).  Band: 2 ulp of the output scale."""
    want, want_st, got, got_st = _run_both(_inputs(1), jnp.bfloat16,
                                           torch.bfloat16, emit_stats)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=2 ** -7, atol=2 ** -7)
    if emit_stats:
        np.testing.assert_allclose(got_st.numpy(), np.asarray(want_st)[:, :2],
                                   rtol=1e-2, atol=1e-2)


def test_fused_mlp_xla_matches_jax():
    """The two-pass-LN reference, f32, erf GELU."""
    p = _inputs(2)
    want = jax_fused_mlp_xla(jnp.asarray(p["x"]),
                             *[jnp.asarray(p[k]) for k in _PARAMS],
                             act="gelu")
    got = tfm.fused_mlp_xla(torch.from_numpy(p["x"]),
                            *[torch.from_numpy(p[k]) for k in _PARAMS],
                            act="gelu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("kind,ref", [
    ("gelu", lambda h: jax.nn.gelu(h, approximate=False)),
    ("gelu_tanh", lambda h: jax.nn.gelu(h, approximate=True)),
    ("quick_gelu", lambda h: h * jax.nn.sigmoid(1.702 * h)),
    ("relu", lambda h: jnp.maximum(h, 0.0)),
])
def test_act_matches_jax_nn(kind, ref):
    """f32 activations over [-8, 8]: the fma-form tanh-GELU is a
    reassociation of jax.nn.gelu(approximate=True) -> ~1e-6."""
    h = np.linspace(-8.0, 8.0, 4097, dtype=np.float32)
    got = tfm._act(torch.from_numpy(h), kind).numpy()
    np.testing.assert_allclose(got, np.asarray(ref(jnp.asarray(h))),
                               rtol=1e-5, atol=2e-6)


def test_unknown_act_rejected():
    p = _inputs(3)
    with pytest.raises(ValueError):
        tfm.fused_mlp_stats(torch.from_numpy(p["x"]),
                            torch.zeros((T, 2)),
                            *[torch.from_numpy(p[k]) for k in _PARAMS],
                            act="swish")


# The card's GEMM tiles rows by 128 and K by 64: T 136 leaves a partial row
# tile, D 72 a K tail of 8 past one 64-wide step (the LN prologue's zero
# fill), M 200 one past three steps in the down-projection.
EDGE_T, EDGE_D, EDGE_M = 136, 72, 200


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("act", ["gelu", "gelu_tanh", "quick_gelu", "relu"])
def test_fused_mlp_stats_at_tile_edges_matches_pallas(act, dtype):
    """Plain K2 against the Pallas kernel at the GEMM's tile edges, every
    activation code, in the existing cases' bands (f32 1e-5, bf16 2 ulp
    of the output scale)."""
    dt_jax, dt_torch, tol = ((jnp.float32, torch.float32, 1e-5)
                             if dtype == "f32" else
                             (jnp.bfloat16, torch.bfloat16, 2 ** -7))
    rng = np.random.default_rng(20 + len(act))

    def f(*shape, sc=0.1):
        return (rng.normal(size=shape) * sc).astype(np.float32)

    d, m = EDGE_D, EDGE_M
    p = dict(ls=1.0 + f(d), lb=f(d), w1=f(d, m), b1=f(m), w2=f(m, d),
             b2=f(d))
    x_j = jnp.asarray(f(EDGE_T, d, sc=0.5)).astype(dt_jax)
    xf = np.array(x_j.astype(jnp.float32))
    st = _stats_of(xf)
    want, want_st = fused_mlp_stats_pallas(
        x_j, jnp.asarray(st), *[jnp.asarray(p[k]) for k in _PARAMS],
        act=act, emit_stats=True, interpret=True)
    got, got_st = tfm.fused_mlp_stats_plain(
        torch.from_numpy(xf).to(dt_torch), torch.from_numpy(st[:, :2].copy()),
        *[torch.from_numpy(p[k]) for k in _PARAMS], act=act)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(got_st.numpy(), np.asarray(want_st)[:, :2],
                               rtol=1e-4 if dtype == "f32" else 1e-2,
                               atol=1e-5 if dtype == "f32" else 1e-2)
