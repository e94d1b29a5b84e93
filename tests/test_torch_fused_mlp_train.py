"""The port's per-block MLP half and its backward (plain versions of the
Hopper kernels K5 and K24, and the autograd function over them) against
the JAX package: fused_mlp_pallas and fused_mlp_bwd_pallas in interpret
mode, and jax.vjp of fused_mlp_xla, on the same seeded numpy inputs, for
each activation the kernels take.

Tolerances as in test_torch_attn_block_train.py: f32 1e-5 (outputs) and
1e-4 (summed gradients) relative; bf16 outputs and dx elementwise within
2^-6 (1 + |b|), the f32 gradients within 1e-2 in relative norm."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_fpga_tpu.ops.fused_mlp import (fused_mlp_bwd_pallas,
                                        fused_mlp_pallas,
                                        fused_mlp_xla as jax_mlp_xla)
from vit_fpga_tpu_torch.ops import fused_mlp as tfm

B, N, D, M, N_VALID = 2, 40, 64, 128, 33      # T = B * N token rows
ACTS = ("gelu_tanh", "quick_gelu", "relu")
GRADS = ("dx", "dls", "dlb", "dw1", "db1", "dw2", "db2")
BF16_TOL = 2.0 ** -6
GRAD_RTOL = {"float32": 1e-4, "bfloat16": 1e-2}
DTYPES = [(jnp.float32, torch.float32, "float32"),
          (jnp.bfloat16, torch.bfloat16, "bfloat16")]


def _inputs(seed, loud=False):
    rng = np.random.default_rng(seed)

    def f(*shape, sc=0.1):
        return (rng.normal(size=shape) * sc).astype(np.float32)

    x = f(B, N, D, sc=0.5)
    g = f(B, N, D, sc=1.0)
    g[:, N_VALID:] = 0.0       # padding rows get no cotangent
    if loud:                   # one huge spike per padding row
        x[:, N_VALID:, 5] = 3e3
    return dict(x=x.reshape(B * N, D), g=g.reshape(B * N, D),
                ls=1.0 + f(D), lb=f(D), w1=f(D, M, sc=D ** -0.5),
                b1=f(M), w2=f(M, D, sc=M ** -0.5), b2=f(D))


_ARGS = ("ls", "lb", "w1", "b1", "w2", "b2")
_BWD_ARGS = ("ls", "lb", "w1", "b1", "w2")


def _as(p, jdt):
    out = dict(p)
    for k in ("x", "g"):
        out[k] = np.asarray(jnp.asarray(p[k]).astype(jdt).astype(
            jnp.float32))
    return out


def _torch(a, dt):
    return torch.from_numpy(np.asarray(a, np.float32).copy()).to(dt)


def _f32(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t, np.float32)


def _rel(a, b):
    a, b = _f32(a), _f32(b)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _check_grads(got, want, name):
    for n, a, b in zip(GRADS, got, want):
        if n == "dx" and name == "bfloat16":
            np.testing.assert_allclose(_f32(a), _f32(b), rtol=BF16_TOL,
                                       atol=BF16_TOL, err_msg=n)
        else:
            assert _rel(a, b) <= GRAD_RTOL[name], (n, _rel(a, b))


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("dts", DTYPES, ids=["f32", "bf16"])
def test_fused_mlp_fwd_plain_matches_pallas(act, dts):
    jdt, tdt, name = dts
    p = _as(_inputs(0), jdt)
    want = fused_mlp_pallas(jnp.asarray(p["x"]).astype(jdt),
                            *[jnp.asarray(p[k]) for k in _ARGS], act=act,
                            block_t=16, interpret=True)
    got = tfm.fused_mlp_fwd(_torch(p["x"], tdt),
                            *[torch.from_numpy(p[k]) for k in _ARGS],
                            act=act)
    tol = 1e-5 if name == "float32" else BF16_TOL
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("dts", DTYPES, ids=["f32", "bf16"])
def test_fused_mlp_bwd_plain_matches_pallas(act, dts):
    """All seven outputs against the TPU backward kernel in interpret
    mode."""
    jdt, tdt, name = dts
    p = _as(_inputs(1), jdt)
    want = fused_mlp_bwd_pallas(
        jnp.asarray(p["x"]).astype(jdt), *[jnp.asarray(p[k])
                                           for k in _BWD_ARGS],
        jnp.asarray(p["g"]).astype(jdt), act=act, block_t=16,
        interpret=True)
    got = tfm.fused_mlp_bwd(_torch(p["x"], tdt),
                            *[torch.from_numpy(p[k]) for k in _BWD_ARGS],
                            _torch(p["g"], tdt), act=act)
    _check_grads(got, want, name)


@pytest.mark.parametrize("act", ACTS + ("gelu",))
def test_fused_mlp_bwd_plain_matches_jax_vjp(act):
    """f32: the same gradients as autodiff of the reference (the CPU
    path of the JAX custom_vjp; for erf-GELU, the closed-form
    derivative)."""
    p = _inputs(2)
    prims = [jnp.asarray(p[k]) for k in ("x",) + _ARGS]
    _, vjp = jax.vjp(lambda *a: jax_mlp_xla(*a, eps=1e-6, act=act), *prims)
    want = vjp(jnp.asarray(p["g"]))
    got = tfm.fused_mlp_bwd(torch.from_numpy(p["x"]),
                            *[torch.from_numpy(p[k]) for k in _BWD_ARGS],
                            torch.from_numpy(p["g"]), act=act)
    _check_grads(got, want, "float32")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_autograd_through_fused_mlp_equals_plain_backward(dtype):
    p = _inputs(3)
    leaves = [_torch(p["x"], dtype)] + [torch.from_numpy(p[k])
                                        for k in _ARGS]
    leaves[3] = leaves[3].to(dtype)     # w1 in the compute dtype, as _block
    leaves[5] = leaves[5].to(dtype)     # w2
    leaves = [t.requires_grad_(True) for t in leaves]
    g = _torch(p["g"], dtype)
    out = tfm.fused_mlp(*leaves, 1e-6, "gelu_tanh")
    got = torch.autograd.grad(out, leaves, g)
    want = tfm.fused_mlp_bwd_plain(*[t.detach() for t in leaves[:6]], g,
                                   act="gelu_tanh")
    for i, (a, w) in enumerate(zip(got, want)):
        assert a.dtype == leaves[i].dtype, GRADS[i]
        torch.testing.assert_close(a, w.to(a.dtype), rtol=0, atol=0)
    torch.testing.assert_close(
        out.detach(), tfm.fused_mlp_xla(*[t.detach() for t in leaves],
                                        act="gelu_tanh"), rtol=0, atol=0)


@pytest.mark.parametrize("act", ACTS)
def test_loud_padding_leaves_weight_grads_unchanged(act):
    """Huge spikes in the padding rows of x, zero g there: every weight,
    bias and LN gradient is exactly the one of quiet padding rows."""
    outs = []
    for loud in (False, True):
        p = _inputs(4, loud=loud)
        outs.append(tfm.fused_mlp_bwd(
            _torch(p["x"], torch.bfloat16),
            *[torch.from_numpy(p[k]) for k in _BWD_ARGS],
            _torch(p["g"], torch.bfloat16), act=act))
    for n_, a, b in zip(GRADS[1:], outs[0][1:], outs[1][1:]):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=n_)
    assert torch.isfinite(outs[1][0]).all()


def test_wrappers_refuse_what_the_kernels_do_not_take():
    p = _inputs(5)
    x = torch.from_numpy(p["x"])
    args = [torch.from_numpy(p[k]) for k in _ARGS]
    with pytest.raises(NotImplementedError):   # the tp partial
        tfm.fused_mlp_fwd(x, *args, act="relu", residual=False)
    with pytest.raises(ValueError):
        tfm.fused_mlp_fwd(x, *args, act="swish")
    meta = x.to("meta")
    with pytest.raises(ValueError):
        tfm.fused_mlp_fwd(meta, *args, act="relu")
    with pytest.raises(ValueError):
        tfm.fused_mlp_bwd(meta, *args[:5], meta, act="relu")


@pytest.mark.parametrize("t,d,m,dtype", [
    (80, 80, 128, torch.bfloat16),     # D not a multiple of 32
    (80, 64, 100, torch.bfloat16),     # M not a multiple of 32
    (80, 64, 128, torch.float32),      # f32 activations
])
def test_cuda_shape_checks_refuse_what_the_kernels_do_not_take(t, d, m,
                                                               dtype):
    """The checks a CUDA tensor meets before K5 / K24 launch (device
    independent, so meta tensors reach them): they raise, no fallback."""
    x = torch.empty((t, d), dtype=dtype, device="meta")
    with pytest.raises(ValueError):
        tfm._cuda_geometry(x, torch.empty((d, m), device="meta"))
    ok = torch.empty((t, 64), dtype=torch.bfloat16, device="meta")
    assert tfm._cuda_geometry(ok, torch.empty((64, 128))) == (t, 64, 128)
