"""The port's per-block MLP half and its backward (plain versions of the
Hopper kernels K5 and K24, and the autograd function over them) against
the JAX package: fused_mlp_pallas and fused_mlp_bwd_pallas in interpret
mode, and jax.vjp of fused_mlp_xla, on the same seeded numpy inputs, for
each activation the kernels take.

Tolerances as in test_torch_attn_block_train.py: f32 1e-5 (outputs) and
1e-4 (summed gradients) relative; bf16 outputs and dx elementwise within
2^-6 (1 + |b|), the f32 gradients within 1e-2 in relative norm.

The f32 forward has a third leg: the same function evaluated in float64
numpy (``_mlp_f64``), against which both the port and the JAX kernel are
held, so that a failure names its side; a failure of the port's side also
prints each stage of the port's plain forward held to float64 of its own
f32 input (``_port_stages``) and the process's thread and matmul
settings, so that it names the op."""

import contextlib

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


def _reference_precision(name):
    """The JAX reference's f32 dots at full f32 (as test_int8_static.py
    and the JAX package's own _precision_ctx pin them): XLA's DEFAULT
    precision may take a reduced-precision dot algorithm on some CPU
    builds, which the f32 tolerances here do not allow.  bf16 runs as it
    is."""
    if name == "float32":
        return jax.default_matmul_precision("float32")
    return contextlib.nullcontext()


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


def _act_f64(h, act):
    """The activations of fused_mlp.py's ``_act`` in float64, the tanh-GELU
    in its fma form."""
    if act == "gelu_tanh":
        u = h * (0.7978845608028654 + 0.035677408136300125 * (h * h))
        return 0.5 * h + 0.5 * h * np.tanh(u)
    if act == "quick_gelu":
        return h / (1.0 + np.exp(-1.702 * h))
    if act == "relu":
        return np.maximum(h, 0.0)
    raise ValueError(act)


def _mlp_f64(p, act, eps=1e-6):
    """The Pallas body's function (``_mlp_kernel``: two-pass LN -> W1 + b1
    -> act -> W2 + b2 -> residual) in float64 on the f32 inputs: exact to
    far below the f32 tolerance.  Returns (out, hidden)."""
    f = {k: np.asarray(v, np.float64) for k, v in p.items()}
    x = f["x"]
    mu = x.mean(-1, keepdims=True)
    var = ((x - mu) ** 2).mean(-1, keepdims=True)
    xn = (x - mu) / np.sqrt(var + eps) * f["ls"] + f["lb"]
    h = _act_f64(xn @ f["w1"] + f["b1"], act)
    return x + (h @ f["w2"] + f["b2"]), h


def _off(got, exact, tol):
    """Where ``got`` misses ``exact`` by more than tol (1 + |exact|): the
    max |d|, the rows off, and per worst row the hidden units whose W2 row
    is most aligned with the error (a misrounded hidden unit j moves the
    row by a multiple of W2[j])."""
    d = np.asarray(got, np.float64) - exact
    bad = np.abs(d) > tol * (1.0 + np.abs(exact))
    rows = sorted(set(np.nonzero(bad)[0].tolist()))
    return float(np.abs(d).max()), int(bad.sum()), rows, d


def _hidden_suspects(d_row, w2, top=3):
    w = np.asarray(w2, np.float64)
    score = np.abs(w @ d_row) / np.linalg.norm(w, axis=1)
    return np.argsort(-score)[:top].tolist()


def _port_stages(p, act, eps=1e-6):
    """The port's plain f32 forward (``fused_mlp_xla``'s arithmetic) stage
    by stage, each held to float64 of its own f32 input: one line per
    stage with its max |d| and the rows past 1e-5 (1 + |exact|)."""
    f = {k: torch.from_numpy(np.asarray(v, np.float32).copy())
         for k, v in p.items()}
    x = f["x"]
    mu = x.mean(-1, keepdim=True)
    var = x.var(-1, unbiased=False, keepdim=True)
    xn = (x - mu) * torch.rsqrt(var + eps) * f["ls"] + f["lb"]
    h = xn @ f["w1"] + f["b1"]
    a = tfm._act(h, act)
    y = a @ f["w2"] + f["b2"]
    x64 = np.asarray(p["x"], np.float64)
    m64 = x64.mean(-1, keepdims=True)
    v64 = ((x64 - m64) ** 2).mean(-1, keepdims=True)
    d64 = lambda t: t.double().numpy()
    lines = []
    for name, got, want in (
            ("xn", xn, (x64 - m64) / np.sqrt(v64 + eps) * p["ls"] + p["lb"]),
            ("xn @ W1 + b1", h, d64(xn) @ p["w1"].astype(np.float64)
             + p["b1"]),
            (f"act {act}", a, _act_f64(d64(h), act)),
            ("act @ W2 + b2", y, d64(a) @ p["w2"].astype(np.float64)
             + p["b2"])):
        d = np.abs(d64(got) - want)
        rows = sorted(set(np.nonzero(d > 1e-5 * (1 + np.abs(want)))[0]))
        lines.append(f"  port stage {name}: max|d| {d.max():.3e}, rows "
                     f"{[int(r) for r in rows][:16]}")
    return "\n".join(lines)


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
    with _reference_precision(name):
        want = fused_mlp_pallas(jnp.asarray(p["x"]).astype(jdt),
                                *[jnp.asarray(p[k]) for k in _ARGS], act=act,
                                block_t=16, interpret=True)
    got = tfm.fused_mlp_fwd(_torch(p["x"], tdt),
                            *[torch.from_numpy(p[k]) for k in _ARGS],
                            act=act)
    tol = 1e-5 if name == "float32" else BF16_TOL
    if name == "float32":
        exact, _ = _mlp_f64(p, act)
        for side, out in (("port", _f32(got)), ("JAX", _f32(want))):
            dmax, n_off, rows, d = _off(out, exact, tol)
            worst = int(np.abs(d).max(1).argmax())
            print(f"{side} vs float64 [{act}]: max|d| {dmax:.3e}, {n_off} "
                  f"of {d.size} off, rows {rows[:16]}, hidden units most "
                  f"aligned with row {worst}'s error "
                  f"{_hidden_suspects(d[worst], p['w2'])}")
        try:
            np.testing.assert_allclose(_f32(got), exact, rtol=tol, atol=tol,
                                       err_msg="the port vs float64")
        except AssertionError:
            # the stages evaluated again now: if they all hold, the op
            # that failed erred on its first call only
            print(_port_stages(p, act))
            print(torch.__config__.parallel_info())
            print(f"torch threads {torch.get_num_threads()}, f32 matmul "
                  f"precision {torch.get_float32_matmul_precision()}, "
                  f"mkldnn {torch.backends.mkldnn.is_available()}")
            raise
        np.testing.assert_allclose(_f32(want), exact, rtol=tol, atol=tol,
                                   err_msg="the JAX kernel vs float64")
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


def test_tanh_plain_matches_float64():
    """The plain versions' tanh (``utils.platform.tanh_plain``, 2 sigmoid(2u)
    - 1 on the CPU, off MKL VML) within 2^-22 of tanh in float64 over the
    activation's range, and odd and saturating where tanh is."""
    from vit_fpga_tpu_torch.utils.platform import tanh_plain
    rng = np.random.default_rng(7)
    u = np.concatenate([rng.normal(size=20000) * 3.0,
                        np.linspace(-20.0, 20.0, 40001),
                        [0.0, 1e-30, -1e-8, 1e-3]]).astype(np.float32)
    got = tanh_plain(torch.from_numpy(u)).double().numpy()
    assert np.abs(got - np.tanh(u.astype(np.float64))).max() <= 2.0 ** -22
    assert got[np.abs(u) >= 10].tolist() == np.sign(
        u[np.abs(u) >= 10]).tolist()


# (T, D, M) where K5's wgmma + TMA tiles (128 rows, 64-wide K steps,
# 256-wide N) have edges on the card, at small widths: a partial row tile
# only; a K tail of 8 past one 64-wide step and N 8 past a 256-wide tile; a
# K tail of 8 past two steps and N 64 past one tile, over two row tiles.
K5_EDGES = [(72, 64, 128), (136, 72, 264), (200, 136, 320)]


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("t,d,m", K5_EDGES,
                         ids=[f"{t}x{d}x{m}" for t, d, m in K5_EDGES])
def test_fused_mlp_fwd_plain_matches_pallas_at_the_tile_edges(t, d, m, act):
    """K5's plain version (the function the card kernel is held to) vs
    ``fused_mlp_pallas(interpret=True)`` in bf16 at the card tiles' edges,
    x of scale 2 so that rstd is far from 1."""
    rng = np.random.default_rng(t + d + m)

    def f(*shape, sc=0.1):
        return (rng.normal(size=shape) * sc).astype(np.float32)

    x = np.asarray(jnp.asarray(f(t, d, sc=2.0)).astype(jnp.bfloat16)
                   .astype(jnp.float32))
    p = dict(ls=1.0 + f(d), lb=f(d), w1=f(d, m, sc=d ** -0.5), b1=f(m),
             w2=f(m, d, sc=m ** -0.5), b2=f(d))
    want = fused_mlp_pallas(jnp.asarray(x).astype(jnp.bfloat16),
                            *[jnp.asarray(p[k]) for k in _ARGS], act=act,
                            block_t=16, interpret=True)
    got = tfm.fused_mlp_fwd(_torch(x, torch.bfloat16),
                            *[torch.from_numpy(p[k]) for k in _ARGS],
                            act=act)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=BF16_TOL,
                               atol=BF16_TOL)


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("dts", DTYPES, ids=["f32", "bf16"])
def test_fused_mlp_bwd_plain_matches_pallas(act, dts):
    """All seven outputs against the TPU backward kernel in interpret
    mode."""
    jdt, tdt, name = dts
    p = _as(_inputs(1), jdt)
    with _reference_precision(name):
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
    with _reference_precision("float32"):
        _, vjp = jax.vjp(lambda *a: jax_mlp_xla(*a, eps=1e-6, act=act),
                         *prims)
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


@pytest.mark.parametrize("d,m,ok", [
    (776, 3104, True),                 # chip_smoke.py's K5 edge case
    (64, 128, True),
    (780, 3104, False),                # D not a multiple of 8
    (776, 3100, False),                # M not a multiple of 8
])
def test_k5_shape_check_takes_multiples_of_8(d, m, ok):
    """K5's wgmma GEMMs read D and M in TMA's 16-byte strides: its launch
    check takes multiples of 8, where K6's and K24's wmma GEMMs want 32."""
    x = torch.empty((40, d), dtype=torch.bfloat16, device="meta")
    w1 = torch.empty((d, m), device="meta")
    if ok:
        assert tfm._cuda_geometry(x, w1, 8) == (40, d, m)
    else:
        with pytest.raises(ValueError, match="divisible by 8"):
            tfm._cuda_geometry(x, w1, 8)
    if d % 32 or m % 32:
        with pytest.raises(ValueError, match="divisible by 32"):
            tfm._cuda_geometry(x, w1)


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
