"""ViT-H/14 (D 1280, 16 heads of 80, M 5120) in the port against the JAX
package on the CPU.

Kernel level, at head dim 80 and a narrow width (D 160, 2 heads of 80):
the plain versions of K4 (both softmax modes), K23, K16 and K18 against
the JAX Pallas kernels in interpret mode, at 33 valid tokens of 40 and at
257 of 264 (ViT-H/14 @224's count, past 256 keys, where the card streams
two key tiles and a third of one key).  Slice level, at full width and
depth 2: the JAX ``init_params`` tree carried across by
``params_from_numpy`` unchanged, the port's CPU forward against the JAX CPU
forward, and one SGD step against the JAX train step (``jax.grad``).  The
card's gates take head dim 80 for K4, K23, K16 and K18 and refuse it for
K21b.

Tolerances: f32 runs the same arithmetic in another summation order (1e-5
elementwise for the halves, 1e-4 relative for the summed gradients and the
logits); bf16 rounds at the same points, so an accumulation-order ulp flip
is all that differs (outputs and dx within 2^-6 (1 + |b|), the f32 weight
gradients within 1e-2 in relative norm); the int8 halves within the band
of tests/test_torch_int8_static.py: 2^-6 (1 + |b|) plus two quantization
steps of the last GEMM."""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vit_fpga_tpu.models import quantized as jq
from vit_fpga_tpu.models import vit as jvit
from vit_fpga_tpu.ops import quant_block as jqb
from vit_fpga_tpu.ops.attn_block import (attn_block_bwd_pallas,
                                         attn_block_pallas)
from vit_fpga_tpu.ops.quant_fused import quantize_weight_colwise
from vit_fpga_tpu.train import trainer as jtrain
from vit_fpga_tpu_torch.models import vit as tvit
from vit_fpga_tpu_torch.models.convert import (params_from_numpy,
                                               params_to_numpy)
from vit_fpga_tpu_torch.ops import attn_block as tab
from vit_fpga_tpu_torch.ops import quant_block as tqb
from vit_fpga_tpu_torch.ops.attn_block import _mha_tpu
from vit_fpga_tpu_torch.ops.common import SUBLANE, round_up
from vit_fpga_tpu_torch.ops.quant_fused import QMAX
from vit_fpga_tpu_torch.train import trainer as ttrain

# (B, n_pad, D, heads, n_valid) at head dim 80: one key tile, and ViT-H/14
# @224's 257 valid keys on 264 rows
GEOMS = [(2, 40, 160, 2, 33), (1, 264, 160, 2, 257)]
GEOM_IDS = ["40", "264"]
DTYPES = [(jnp.float32, torch.float32, "float32"),
          (jnp.bfloat16, torch.bfloat16, "bfloat16")]
BF16_TOL = 2.0 ** -6
GRAD_RTOL = {"float32": 1e-4, "bfloat16": 1e-2}
INT8_STEPS = 2
_ARGS = ("ls", "lb", "wqkv", "bqkv", "wo", "bo")
_BWD_ARGS = ("ls", "lb", "wqkv", "bqkv", "wo")
GRADS = ("dx", "dls", "dlb", "dwqkv", "dbqkv", "dwo", "dbo")


def _f32(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(jnp.asarray(t).astype(jnp.float32))


def _rel(a, b):
    a, b = _f32(a), _f32(b)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _precision(name):
    """The JAX reference's f32 dots at full f32 (as the JAX package's own
    tests pin them); bf16 runs as it is."""
    if name == "float32":
        return jax.default_matmul_precision("float32")
    return contextlib.nullcontext()


def _inputs(seed, geom):
    """x, the cotangent g (zero on the padding rows, as in the model) and
    the f32 parameters; the weights shrink by sqrt(128 / D) so the branch
    keeps the size it has at D 128."""
    b, n, d, _, nv = geom
    rng = np.random.default_rng(seed)
    w = 0.1 * (128 / d) ** 0.5

    def f(*shape, sc=0.1):
        return (rng.normal(size=shape) * sc).astype(np.float32)

    g = f(b, n, d, sc=1.0)
    g[:, nv:] = 0.0
    return dict(x=f(b, n, d, sc=0.5), ls=1.0 + f(d), lb=f(d),
                wqkv=f(d, 3 * d, sc=w), bqkv=f(3 * d), wo=f(d, d, sc=w),
                bo=f(d), g=g)


def _rounded(p, jdt):
    """x and g rounded to the compute dtype (through jnp on both sides)."""
    out = dict(p)
    for k in ("x", "g"):
        out[k] = np.asarray(jnp.asarray(p[k]).astype(jdt).astype(
            jnp.float32))
    return out


def _torch(a, dt):
    return torch.from_numpy(np.asarray(a, np.float32).copy()).to(dt)


# ---------------------------------------------------------------------------
# K4 and K23 at head dim 80
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("geom", GEOMS, ids=GEOM_IDS)
@pytest.mark.parametrize("dts", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("safe", [True, False], ids=["safe", "maxfree"])
def test_k4_dh80_plain_matches_pallas(geom, dts, safe):
    """K4's plain version against attn_block_pallas in interpret mode on
    the valid rows (the padding rows are garbage by contract on both
    sides): f32 within 1e-5, bf16 within 2^-6 (1 + |b|)."""
    jdt, tdt, name = dts
    nh, nv = geom[3], geom[4]
    p = _rounded(_inputs(0, geom), jdt)
    with _precision(name):
        want = attn_block_pallas(jnp.asarray(p["x"]).astype(jdt),
                                 *[jnp.asarray(p[k]) for k in _ARGS], nh,
                                 n_valid=nv, safe_softmax=safe,
                                 interpret=True)
    got = tab.attn_block_fwd(_torch(p["x"], tdt),
                             *[torch.from_numpy(p[k]) for k in _ARGS], nh,
                             n_valid=nv, safe_softmax=safe)
    g, w = _f32(got)[:, :nv], _f32(want)[:, :nv]
    tol = 1e-5 if name == "float32" else BF16_TOL
    np.testing.assert_allclose(g, w, rtol=tol, atol=tol)


@pytest.mark.parametrize("geom", GEOMS, ids=GEOM_IDS)
@pytest.mark.parametrize("dts", DTYPES, ids=["f32", "bf16"])
def test_k23_dh80_plain_matches_pallas(geom, dts):
    """All seven outputs of K23's plain version against the TPU backward
    kernel (per-head branch) in interpret mode: dx elementwise in bf16,
    every other gradient (and dx in f32) in relative norm."""
    jdt, tdt, name = dts
    nh, nv = geom[3], geom[4]
    p = _rounded(_inputs(1, geom), jdt)
    with _precision(name):
        want = attn_block_bwd_pallas(
            jnp.asarray(p["x"]).astype(jdt),
            *[jnp.asarray(p[k]) for k in _BWD_ARGS],
            jnp.asarray(p["g"]).astype(jdt), nh, n_valid=nv, pairs=False,
            interpret=True)
    got = tab.attn_block_bwd(_torch(p["x"], tdt),
                             *[torch.from_numpy(p[k]) for k in _BWD_ARGS],
                             _torch(p["g"], tdt), nh, n_valid=nv)
    for n, a, b in zip(GRADS, got, want):
        if n == "dx" and name == "bfloat16":
            np.testing.assert_allclose(_f32(a), _f32(b), rtol=BF16_TOL,
                                       atol=BF16_TOL, err_msg=n)
        else:
            assert _rel(a, b) <= GRAD_RTOL[name], (n, _rel(a, b))


# ---------------------------------------------------------------------------
# K16 and K18 at head dim 80
# ---------------------------------------------------------------------------

def _int8_case(seed, geom, static, hot=False):
    """bf16 x and the int8 half's arguments from seeded numpy weights:
    dynamic (K16) or with static scales calibrated on the quiet input
    (K18, folded as quantize_vit_static folds them; ``hot`` then feeds 2%
    of x's elements 8x louder, past the calibration).  Returns (x, args,
    one quantization step of the last GEMM or None)."""
    b, n, d, heads, nv = geom
    rng = np.random.default_rng(seed)

    def f(*shape, sc=0.1):
        return (rng.normal(size=shape) * sc).astype(np.float32)

    x = f(b, n, d, sc=1.0)
    ls, lb = 1.0 + f(d), f(d)
    wqkvq, wqkvs = quantize_weight_colwise(f(d, 3 * d))
    woq, wos = quantize_weight_colwise(f(d, d))
    bqkv, bo = f(3 * d, sc=0.2), f(d, sc=0.2)
    if not static:
        return x, (ls, lb, wqkvq, wqkvs, bqkv, woq, wos, bo), None
    t_ = torch.from_numpy
    xn = tqb._ln_f32(t_(x), t_(ls), t_(lb), 1e-6)
    s_x = np.float32(float(xn[:, :nv].abs().max()) / QMAX)
    qkv = (xn @ (t_(wqkvq).float() * t_(wqkvs)) + t_(bqkv)).to(
        torch.bfloat16)
    s_ao = np.float32(float(_mha_tpu(qkv, heads, nv).float()[:, :nv]
                            .abs().max()) / QMAX)
    args = (np.float32(1.0 / s_ao), ls / s_x, lb / s_x, wqkvq, wqkvs * s_x,
            bqkv, woq, wos * s_ao, bo)
    if hot:
        x = np.where(rng.random(x.shape) < 0.02, 8.0 * x, x).astype(
            np.float32)
    return x, args, 127.0 * args[7]


def _bf16_pair(x):
    xj = jnp.asarray(x, jnp.bfloat16)
    return xj, torch.from_numpy(np.array(xj.astype(jnp.float32))).to(
        torch.bfloat16)


def _within_steps(got, want, step):
    g, w = _f32(got), _f32(want)
    return bool(np.all(np.abs(g - w) <= BF16_TOL * (1.0 + np.abs(w))
                       + INT8_STEPS * step))


@pytest.mark.parametrize("geom", GEOMS, ids=GEOM_IDS)
def test_k16_dh80_plain_matches_pallas(geom):
    """K16's plain version against attn_block_int8 in interpret mode on
    the valid rows, within one bf16 ulp of the output (the bodies run op
    for op in f32; only the order of f32 sums differs)."""
    heads, nv = geom[3], geom[4]
    x, args, _ = _int8_case(2, geom, static=False)
    xj, xt = _bf16_pair(x)
    want = jqb.attn_block_int8(xj, *map(jnp.asarray, args), heads,
                               n_valid=nv, interpret=True)
    got = tqb.attn_block_int8(xt, *map(torch.from_numpy, args), heads,
                              n_valid=nv)
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    np.testing.assert_allclose(_f32(got)[:, :nv], _f32(want)[:, :nv],
                               rtol=2.0 ** -7, atol=2.0 ** -7)


@pytest.mark.parametrize("hot", [False, True], ids=["quiet", "hot"])
@pytest.mark.parametrize("geom", GEOMS, ids=GEOM_IDS)
def test_k18_dh80_plain_matches_pallas(geom, hot):
    """K18's plain version against attn_block_int8_static in interpret
    mode on the valid rows, quiet and past its calibration, within
    2^-6 (1 + |b|) plus two steps of the out-projection."""
    heads, nv = geom[3], geom[4]
    x, args, step = _int8_case(3, geom, static=True, hot=hot)
    xj, xt = _bf16_pair(x)
    want = jqb.attn_block_int8_static(xj, *map(jnp.asarray, args), heads,
                                      n_valid=nv, interpret=True)
    got = tqb.attn_block_int8_static(xt, float(args[0]),
                                     *map(torch.from_numpy, args[1:]), heads,
                                     n_valid=nv)
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    assert _within_steps(got[:, :nv], want[:, :nv], step)


# ---------------------------------------------------------------------------
# The gates on the card
# ---------------------------------------------------------------------------

VIT_H = (264, 1280, 16, 257)    # ViT-H/14 @224: n_pad, D, heads, n_valid


@pytest.mark.parametrize("batch", [1, 8, 64])
def test_card_gates_take_vit_h14(batch):
    """K4 and K23 (_cuda_geometry), K16 and K18 take ViT-H/14's geometry
    on the card, where the JAX planner runs the fused halves (its
    attn_block_pallas plan has a score slot, _int8_block_fits holds);
    K21b refuses head dim 80 by name (K1's refusal is held on the card:
    its gate follows the device check)."""
    n_pad, d, heads, nv = VIT_H
    jcfg = jvit.config("vit_h14")
    assert tab.attn_block_fits(batch, n_pad, d, heads)
    assert jq._int8_block_fits(jcfg)
    assert n_pad == round_up(jcfg.seq_len, SUBLANE) and nv == jcfg.seq_len
    x = torch.empty((batch, n_pad, d), dtype=torch.bfloat16)
    for kernel in ("K4", "K23"):
        assert tab._cuda_geometry(x, heads, nv, kernel=kernel) == (
            batch, n_pad, d, nv)
    tqb.attn_int8_geometry(batch, n_pad, d, heads, nv)
    tqb.attn_int8_static_geometry(batch, n_pad, d, heads, nv)
    with pytest.raises(ValueError, match="K21b takes head dim 64 and"):
        tqb.attn_int8_stats_geometry(batch, n_pad, d, heads, nv)


@pytest.mark.parametrize("dh", [32, 96, 128])
def test_card_gates_refuse_other_head_dims(dh):
    """A head dim other than 64 or 80 raises at every gate, by name."""
    heads = 4
    d = heads * dh
    x = torch.empty((1, 200, d), dtype=torch.bfloat16)
    for kernel in ("K4", "K23"):
        with pytest.raises(ValueError, match=f"{kernel} takes head dim 64 "
                                             f"or 80"):
            tab._cuda_geometry(x, heads, 197, kernel=kernel)
    for kernel, gate in (("K16", tqb.attn_int8_geometry),
                         ("K18", tqb.attn_int8_static_geometry)):
        with pytest.raises(ValueError, match=f"{kernel} takes head dim 64 "
                                             f"or 80"):
            gate(1, 200, d, heads, 197)


# ---------------------------------------------------------------------------
# The slice: ViT-H/14 at full width, depth 2
# ---------------------------------------------------------------------------

def _h14_cfgs(depth=2, **kw):
    """The JAX and the port's vit_h14 configs at ``depth`` (full width)."""
    cfg_kw = dict(jvit.VARIANTS["vit_h14"], depth=depth, **kw)
    return jvit.ViTConfig(image_size=224, **cfg_kw), tvit.config(
        "vit_h14", **dict(cfg_kw, depth=depth))


def _h14_params(jcfg, seed):
    """The JAX init_params tree perturbed by 0.02 * normal noise (so the
    zero-init biases, LN parameters and CLS token carry signal), as
    numpy."""
    rng = np.random.default_rng(seed)
    params = jvit.init_params(jax.random.key(seed), jcfg)
    return jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.02 * rng.normal(size=p.shape).astype(
            np.float32), params)


@pytest.fixture(scope="module")
def h14():
    jcfg, _ = _h14_cfgs()
    return _h14_params(jcfg, 0)


def test_h14_params_carry_across_unchanged(h14):
    """params_from_numpy takes the JAX vit_h14 tree (full width) leaf for
    leaf: the same keys and shapes, every value bit for bit, f32."""
    _, tcfg = _h14_cfgs()
    port = params_from_numpy(h14, device="cpu")
    back = params_to_numpy(port)
    flat_j = jax.tree_util.tree_leaves_with_path(h14)
    flat_t = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_j) == len(flat_t)
    for path, leaf in flat_j:
        got = np.asarray(flat_t[path])
        assert got.dtype == np.float32 and got.shape == leaf.shape, path
        assert np.array_equal(got, leaf), path
    assert port["blocks"]["wqkv"].shape == (2, 1280, 3840)
    assert tcfg.hidden_dim // tcfg.num_heads == 80


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_h14_forward_matches_jax(h14, dtype):
    """The port's CPU forward (the routing as on a TPU: K4's plain version
    and the plain torch MLP) against the JAX CPU forward of the same tree
    on two uint8 images: within 1e-4 (f32) or 5e-2 (bf16) of the largest
    logit, the same top-1."""
    jcfg, tcfg = _h14_cfgs(dtype=dtype)
    images = np.random.default_rng(1).integers(0, 256, (2, 224, 224, 3),
                                               np.uint8)
    want = np.asarray(jvit.forward_raw(
        jax.tree_util.tree_map(jnp.asarray, h14), jnp.asarray(images), jcfg))
    got = tvit.make_forward(tcfg, params_from_numpy(h14, device="cpu"),
                            device="cpu")(images).float().numpy()
    band = 1e-4 if dtype == "float32" else 5e-2
    assert np.abs(got - want).max() <= band * np.abs(want).max()
    assert np.array_equal(got.argmax(1), want.argmax(1))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_h14_sgd_step_matches_jax(h14, dtype):
    """One SGD step at b2: the loss and every updated parameter in
    relative norm of the JAX train step's (jax.grad through the XLA path),
    within 2e-4 (f32) or 5e-2 (bf16).  The port's backward routes as the
    JAX one by the copied _bwd_fits: K23's plain version in bf16, the
    autograd gradient of attn_block_xla in f32 (its panels pass 64 MB)."""
    jcfg, tcfg = _h14_cfgs(dtype=dtype)
    n_pad, d, heads = VIT_H[0], VIT_H[1], VIT_H[2]
    itemsize = 4 if dtype == "float32" else 2
    assert tab._bwd_fits(heads, d, n_pad, round_up(n_pad, 128),
                         itemsize) == (dtype == "bfloat16")
    tol = 2e-4 if dtype == "float32" else 5e-2
    rng = np.random.default_rng(2)
    images = rng.normal(size=(2, 224, 224, 3)).astype(np.float32)
    labels = rng.integers(0, jcfg.num_classes, 2).astype(np.int32)
    step = jtrain.make_vit_train_step(jcfg, optax.sgd(0.1), donate=False)
    jp = jax.tree_util.tree_map(jnp.asarray, h14)
    jp, _, jm = step(jp, optax.sgd(0.1).init(jp), jnp.asarray(images),
                     jnp.asarray(labels))
    params, opt = ttrain.init_train_state(
        tcfg, ttrain.sgd(0.1), params=params_from_numpy(h14, device="cpu"))
    params, _, tm = ttrain.make_vit_train_step(tcfg)(
        params, opt, torch.from_numpy(images),
        torch.from_numpy(labels).long())
    jl, tl = float(jm["loss"]), float(tm["loss"])
    assert abs(tl - jl) <= tol * max(abs(jl), 1.0), (tl, jl)
    got = dict(jax.tree_util.tree_leaves_with_path(params_to_numpy(params)))
    for path, want in jax.tree_util.tree_leaves_with_path(jp):
        want = np.asarray(want, np.float32)
        err = np.linalg.norm(got[path] - want) / max(np.linalg.norm(want),
                                                     1e-12)
        assert err <= tol, (jax.tree_util.keystr(path), err)
