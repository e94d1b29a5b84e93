"""The port's per-block attention half and its backward (plain versions of
the Hopper kernels K4 and K23, and the autograd function over them)
against the JAX package: attn_block_pallas and attn_block_bwd_pallas in
interpret mode, and jax.vjp of attn_block_xla, on the same seeded numpy
inputs.

Tolerances: f32 runs the same arithmetic in another summation order
(1e-5 relative, 1e-4 for the summed gradients); bf16 rounds at the same
points, so an accumulation-order ulp flip (2^-8) now and then is all that
differs: outputs and dx elementwise within 2^-6 (1 + |b|), the f32
weight, bias and LN gradients within 1e-2 in relative norm."""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_fpga_tpu.ops.attn_block import (attn_block_bwd_pallas,
                                         attn_block_pallas,
                                         attn_block_xla as jax_attn_xla)
from vit_fpga_tpu_torch.ops import attn_block as tab

# (B, N, D, heads, n_valid): the small case, and one at head dim 64
SMALL = (2, 40, 64, 4, 33)
DH64 = (2, 24, 128, 2, 19)
GRADS = ("dx", "dls", "dlb", "dwqkv", "dbqkv", "dwo", "dbo")
BF16_TOL = 2.0 ** -6
GRAD_RTOL = {"float32": 1e-4, "bfloat16": 1e-2}


def _inputs(seed, geom, loud=False):
    b, n, d, _, nv = geom
    rng = np.random.default_rng(seed)

    def f(*shape, sc=0.1):
        return (rng.normal(size=shape) * sc).astype(np.float32)

    x = f(b, n, d, sc=0.5)
    g = f(b, n, d, sc=1.0)
    g[:, nv:] = 0.0            # padding rows get no cotangent, as in the model
    if loud:                   # one huge spike per padding row
        x[:, nv:, 3] = 3e3
    return dict(x=x, ls=1.0 + f(d), lb=f(d), wqkv=f(d, 3 * d),
                bqkv=f(3 * d), wo=f(d, d), bo=f(d), g=g)


_ARGS = ("ls", "lb", "wqkv", "bqkv", "wo", "bo")
_BWD_ARGS = ("ls", "lb", "wqkv", "bqkv", "wo")


def _as(p, dt_np):
    """x and g in the compute dtype (bf16 goes through jnp to round the
    same way on both sides), the rest f32."""
    out = dict(p)
    for k in ("x", "g"):
        out[k] = np.asarray(jnp.asarray(p[k]).astype(dt_np).astype(
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


DTYPES = [(jnp.float32, torch.float32, "float32"),
          (jnp.bfloat16, torch.bfloat16, "bfloat16")]


def _reference_precision(name):
    """The JAX reference's f32 dots at full f32 (as test_int8_static.py
    and the JAX package's own _precision_ctx pin them): XLA's DEFAULT
    precision may take a reduced-precision dot algorithm on some CPU
    builds, which the f32 tolerances here do not allow.  bf16 runs as it
    is."""
    if name == "float32":
        return jax.default_matmul_precision("float32")
    return contextlib.nullcontext()


@pytest.mark.parametrize("geom", [SMALL, DH64], ids=["small", "dh64"])
@pytest.mark.parametrize("dts", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("safe", [True, False])
def test_attn_block_fwd_plain_matches_pallas(geom, dts, safe):
    jdt, tdt, name = dts
    nh, nv = geom[3], geom[4]
    p = _as(_inputs(0, geom), jdt)
    with _reference_precision(name):
        want = attn_block_pallas(jnp.asarray(p["x"]).astype(jdt),
                                 *[jnp.asarray(p[k]) for k in _ARGS], nh,
                                 n_valid=nv, safe_softmax=safe,
                                 interpret=True)
    got = tab.attn_block_fwd(_torch(p["x"], tdt),
                             *[torch.from_numpy(p[k]) for k in _ARGS], nh,
                             n_valid=nv, safe_softmax=safe)
    g, w = _f32(got)[:, :nv], _f32(want)[:, :nv]   # padding rows: garbage
    if name == "float32":
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_allclose(g, w, rtol=BF16_TOL, atol=BF16_TOL)


# (n_pad, n_valid) at or under 256 keys: the card's safe mode in one and
# in two 128-key tiles.
WIDE = [(200, 197), (136, 129)]


@pytest.mark.parametrize("n_pad,n_valid", WIDE,
                         ids=[f"{n}of{p}" for p, n in WIDE])
def test_attn_block_fwd_safe_softmax_takes_wide_scores(n_pad, n_valid):
    """K4's safe mode on scores far past the max-free clip at 80 (q and k
    20x larger), at or under 256 keys: the plain version stays finite and
    matches attn_block_pallas(safe_softmax=True) in interpret mode in
    relative norm of the branch (1e-4: a score's f32 rounding, 1e-7 of
    scores of order 100, is 1e-5 of its e), and the max-free function
    differs there."""
    d, nh = 128, 2
    p = _inputs(13, (1, n_pad, d, nh, n_valid))
    p = dict(p, wqkv=p["wqkv"].copy())
    p["wqkv"][:, :2 * d] *= 20.0
    xn = p["x"][0] - p["x"][0].mean(-1, keepdims=True)
    xn = xn / np.sqrt((xn * xn).mean(-1, keepdims=True) + 1e-6)
    qkv = (xn * p["ls"] + p["lb"]) @ p["wqkv"] + p["bqkv"]
    scores = qkv[:, :64] @ qkv[:n_valid, d:d + 64].T / 8.0
    assert scores.max() > 100.0        # past the clip, and exp's f32 range
    with _reference_precision("float32"):
        want = attn_block_pallas(jnp.asarray(p["x"]),
                                 *[jnp.asarray(p[k]) for k in _ARGS], nh,
                                 n_valid=n_valid, safe_softmax=True,
                                 interpret=True)
    args = (torch.from_numpy(p["x"]),
            *[torch.from_numpy(p[k]) for k in _ARGS], nh)
    got = tab.attn_block_fwd(*args, n_valid=n_valid, safe_softmax=True)
    maxfree = tab.attn_block_fwd(*args, n_valid=n_valid, safe_softmax=False)
    g, w = _f32(got)[:, :n_valid], _f32(want)[:, :n_valid]
    x = p["x"][:, :n_valid]
    assert np.isfinite(g).all()
    assert np.linalg.norm(g - w) <= 1e-4 * np.linalg.norm(w - x)
    mf = _f32(maxfree)[:, :n_valid]
    assert np.linalg.norm(mf - w) > 1e-2 * np.linalg.norm(w - x)


def _check_grads(got, want, name):
    for n, a, b in zip(GRADS, got, want):
        if n == "dx" and name == "bfloat16":
            np.testing.assert_allclose(_f32(a), _f32(b), rtol=BF16_TOL,
                                       atol=BF16_TOL, err_msg=n)
        else:
            assert _rel(a, b) <= GRAD_RTOL[name], (n, _rel(a, b))


@pytest.mark.parametrize("geom", [SMALL, DH64], ids=["small", "dh64"])
@pytest.mark.parametrize("dts", DTYPES, ids=["f32", "bf16"])
def test_attn_block_bwd_plain_matches_pallas(geom, dts):
    """All seven outputs against the TPU backward kernel (per-head
    branch) in interpret mode."""
    jdt, tdt, name = dts
    nh, nv = geom[3], geom[4]
    p = _as(_inputs(1, geom), jdt)
    with _reference_precision(name):
        want = attn_block_bwd_pallas(
            jnp.asarray(p["x"]).astype(jdt), *[jnp.asarray(p[k])
                                               for k in _BWD_ARGS],
            jnp.asarray(p["g"]).astype(jdt), nh, n_valid=nv, pairs=False,
            interpret=True)
    got = tab.attn_block_bwd(_torch(p["x"], tdt),
                             *[torch.from_numpy(p[k]) for k in _BWD_ARGS],
                             _torch(p["g"], tdt), nh, n_valid=nv)
    _check_grads(got, want, name)


@pytest.mark.parametrize("geom", [SMALL, DH64], ids=["small", "dh64"])
def test_attn_block_bwd_plain_matches_jax_vjp(geom):
    """f32: the same gradients as autodiff of the exact-softmax
    reference (the CPU path of the JAX custom_vjp)."""
    nh, nv = geom[3], geom[4]
    p = _inputs(2, geom)
    prims = [jnp.asarray(p[k]) for k in ("x",) + _ARGS]
    with _reference_precision("float32"):
        _, vjp = jax.vjp(lambda *a: jax_attn_xla(*a, num_heads=nh, eps=1e-6,
                                                 n_valid=nv), *prims)
        want = vjp(jnp.asarray(p["g"]))
    got = tab.attn_block_bwd(torch.from_numpy(p["x"]),
                             *[torch.from_numpy(p[k]) for k in _BWD_ARGS],
                             torch.from_numpy(p["g"]), nh, n_valid=nv)
    # the vjp returns (dx, dls, dlb, dwqkv, dbqkv, dwo, dbo) in argument order
    _check_grads(got, want, "float32")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_autograd_through_attn_block_equals_plain_backward(dtype):
    b, n, d, nh, nv = SMALL
    p = _inputs(3, SMALL)
    leaves = [_torch(p["x"], dtype)] + [torch.from_numpy(p[k])
                                        for k in _ARGS]
    leaves = [t.requires_grad_(True) for t in leaves]
    g = _torch(p["g"], dtype)
    out = tab.attn_block(*leaves, nh, 1e-6, nv, True)
    got = torch.autograd.grad(out, leaves, g)
    want = tab.attn_block_bwd_plain(*[t.detach() for t in leaves[:6]], g,
                                    nh, n_valid=nv)
    for n_, a, w in zip(GRADS, got, want):
        assert a.dtype == leaves[GRADS.index(n_)].dtype
        torch.testing.assert_close(a, w.to(a.dtype), rtol=0, atol=0)
    fwd = tab.attn_block_fwd_plain(*[t.detach() for t in leaves], nh,
                                   n_valid=nv, safe_softmax=True)
    torch.testing.assert_close(out.detach(), fwd, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_loud_padding_leaves_weight_grads_unchanged(dtype):
    """Huge spikes in x's rows at or past n_valid, zero g there: keys
    there are masked and their rows get no cotangent, so every weight,
    bias and LN gradient is exactly the one of quiet padding rows."""
    nh, nv = SMALL[3], SMALL[4]
    quiet, loud = _inputs(4, SMALL), _inputs(4, SMALL, loud=True)
    outs = []
    for p in (quiet, loud):
        outs.append(tab.attn_block_bwd(
            _torch(p["x"], dtype), *[torch.from_numpy(p[k])
                                     for k in _BWD_ARGS],
            _torch(p["g"], dtype), nh, n_valid=nv))
    for n_, a, b in zip(GRADS[1:], outs[0][1:], outs[1][1:]):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=n_)
    torch.testing.assert_close(outs[0][0][:, :nv], outs[1][0][:, :nv],
                               rtol=0, atol=0)
    assert torch.isfinite(outs[1][0]).all()


def test_wrappers_refuse_what_the_kernels_do_not_take():
    p = _inputs(5, SMALL)
    x = torch.from_numpy(p["x"])
    args = [torch.from_numpy(p[k]) for k in _ARGS]
    with pytest.raises(NotImplementedError):   # the tp partial
        tab.attn_block_fwd(x, *args, 4, residual=False)
    meta = x.to("meta")
    with pytest.raises(ValueError):
        tab.attn_block_fwd(meta, *args, 4)
    with pytest.raises(ValueError):
        tab.attn_block_bwd(meta, *args[:5], meta, 4)


@pytest.mark.parametrize("shape,heads,n_valid,dtype", [
    ((2, 40, 64), 2, 33, torch.bfloat16),      # head dim 32
    ((2, 300, 128), 2, 300, torch.bfloat16),   # n_valid past 256
    ((2, 40, 80), 1, 33, torch.bfloat16),      # D not a multiple of 32
    ((2, 40, 128), 2, 33, torch.float32),      # f32 activations
])
def test_cuda_shape_checks_refuse_what_the_kernels_do_not_take(
        shape, heads, n_valid, dtype):
    """The checks a CUDA tensor meets before K4 / K23 launch (device
    independent, so meta tensors reach them): they raise, no fallback.
    K23's gate stops at 256 tokens; K4's takes the key-tiled lengths up to
    1024 (its n_valid-past-256 case passes there) and stops past them."""
    x = torch.empty(shape, dtype=dtype, device="meta")
    with pytest.raises(ValueError):
        tab._cuda_geometry(x, heads, n_valid, kernel="K23")
    if n_valid > 256:
        assert tab._cuda_geometry(x, heads, n_valid, kernel="K4") == (
            *shape, n_valid)
        with pytest.raises(ValueError, match="K4 takes at most 1024"):
            tab._cuda_geometry(
                torch.empty((1, 1032, 128), dtype=dtype, device="meta"),
                heads, 1032, kernel="K4")
    else:
        with pytest.raises(ValueError):
            tab._cuda_geometry(x, heads, n_valid, kernel="K4")
    for kernel in ("K4", "K23"):
        b, n, d, nv = tab._cuda_geometry(
            torch.empty((2, 40, 128), dtype=torch.bfloat16, device="meta"),
            2, 33, kernel=kernel)
        assert (b, n, d, nv) == (2, 40, 128, 33)
