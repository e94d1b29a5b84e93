"""The port's per-block MLP half over column chunks of M (plain PyTorch
version of the Hopper kernel K6) against the JAX Pallas kernel
``fused_mlp_chunked_pallas`` in interpret mode, and the gradient of its
differentiable wrapper against autograd through the reference MLP."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_fpga_tpu.ops.fused_mlp import fused_mlp_chunked_pallas
from vit_fpga_tpu_torch.ops import fused_mlp as tfm

# 72 rows: not a multiple of the JAX kernel's 256-row block, so its
# padding rows are exercised and sliced away.
T, D, M = 72, 64, 256
_PARAMS = ("ls", "lb", "w1", "b1", "w2", "b2")
# f32: the same arithmetic, summation order only.  bf16: the chunk-boundary
# roundings are at the same points and the f32 sum order flips an
# occasional ulp of a chunk's bf16(y) or of the running output, whose
# magnitude is up to |x| + sum_c |y_c| (the chunks' terms can cancel):
# 2^-7 (|want| + |x| + sum_c |y_c|) + 2^-8.
F32_TOL = 1e-5
BF16_RTOL, BF16_ATOL = 2 ** -7, 2 ** -8


def _inputs(seed):
    rng = np.random.default_rng(seed)

    def f(*shape, sc=0.1):
        return (rng.normal(size=shape) * sc).astype(np.float32)

    return dict(x=f(T, D, sc=1.0), ls=1.0 + f(D), lb=f(D), w1=f(D, M, sc=0.2),
                b1=f(M), w2=f(M, D, sc=0.2), b2=f(D, sc=0.3))


def _run(p, dtype, act, n_chunks):
    dj = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    x_j = jnp.asarray(p["x"]).astype(dj)
    want = fused_mlp_chunked_pallas(
        x_j, *[jnp.asarray(p[k]) for k in _PARAMS], act=act,
        n_chunks=n_chunks, interpret=True)
    dt = getattr(torch, dtype)
    got = tfm.fused_mlp_chunked_fwd(
        torch.from_numpy(np.array(x_j.astype(jnp.float32))).to(dt),
        *[torch.from_numpy(p[k]) for k in _PARAMS], act=act,
        n_chunks=n_chunks)
    return got, want


def _chunk_terms(p, act, n_chunks):
    """sum_c |y_c| of each output element, in f32 from the plain
    activation: the magnitudes the running output passes through."""
    x = torch.from_numpy(p["x"])
    xhat = (x - x.mean(-1, keepdim=True)) * torch.rsqrt(
        x.var(-1, unbiased=False, keepdim=True) + 1e-6)
    xn = xhat * torch.from_numpy(p["ls"]) + torch.from_numpy(p["lb"])
    h = tfm._act(xn @ torch.from_numpy(p["w1"]) + torch.from_numpy(p["b1"]),
                 act)
    mc = M // n_chunks
    w2 = torch.from_numpy(p["w2"])
    return sum((h[:, c * mc:(c + 1) * mc] @ w2[c * mc:(c + 1) * mc]).abs()
               for c in range(n_chunks)).numpy()


@pytest.mark.parametrize("act", ["gelu_tanh", "quick_gelu", "relu", "gelu"])
@pytest.mark.parametrize("n_chunks", [2, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp_chunked_plain_matches_pallas(dtype, n_chunks, act):
    p = _inputs(n_chunks)
    got, want = _run(p, dtype, act, n_chunks)
    g = got.float().numpy()
    w = np.asarray(want.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(g, w, rtol=F32_TOL, atol=F32_TOL)
    else:
        mag = np.abs(w) + np.abs(p["x"]) + _chunk_terms(p, act, n_chunks)
        np.testing.assert_array_less(np.abs(g - w),
                                     BF16_RTOL * mag + BF16_ATOL)


def test_k6_is_not_k5_in_bf16():
    """The running output is rounded to bf16 at each chunk boundary, so
    K6 differs from K5's single f32 sum over all of M; in f32 they agree
    to rounding."""
    p = _inputs(9)
    args = [torch.from_numpy(p[k]) for k in _PARAMS]
    xb = torch.from_numpy(p["x"]).to(torch.bfloat16)
    k6 = tfm.fused_mlp_chunked_fwd(xb, *args, act="gelu_tanh", n_chunks=4)
    k5 = tfm.fused_mlp_fwd(xb, *args, act="gelu_tanh")
    assert (k6.float() - k5.float()).abs().max() > 0
    xf = torch.from_numpy(p["x"])
    np.testing.assert_allclose(
        tfm.fused_mlp_chunked_fwd(xf, *args, act="gelu_tanh",
                                  n_chunks=4).numpy(),
        tfm.fused_mlp_fwd(xf, *args, act="gelu_tanh").numpy(),
        rtol=1e-5, atol=1e-5)


def test_mlp_chunked_gradient_is_the_reference_vjp():
    """The backward of ``fused_mlp_chunked`` is the VJP of
    ``fused_mlp_xla`` (the JAX ``_fused_mlp_chunked_bwd``), for every
    primal."""
    p = _inputs(4)
    rng = np.random.default_rng(8)
    g = torch.from_numpy(rng.normal(size=(T, D)).astype(np.float32))

    def leaves():
        return [torch.from_numpy(p[k]).clone().requires_grad_(True)
                for k in ("x",) + _PARAMS]

    a = leaves()
    (tfm.fused_mlp_chunked(*a, 1e-6, "gelu_tanh", 2) * g).sum().backward()
    b = leaves()
    (tfm.fused_mlp_xla(*b, eps=1e-6, act="gelu_tanh") * g).sum().backward()
    for ga, gb in zip(a, b):
        torch.testing.assert_close(ga.grad, gb.grad, rtol=0, atol=0)
