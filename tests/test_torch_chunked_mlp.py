"""The port's chunked stats-chain MLP half (plain PyTorch version of the
Hopper kernel K3) against the JAX Pallas kernel in interpret mode, the
port's chain MLP plan against the JAX planner, and the port's stats chain
with K3 against a JAX composition of the Pallas kernels, on the same
seeded numpy inputs."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_fpga_tpu.models import clip as jclip
from vit_fpga_tpu.models import vit as jvit
from vit_fpga_tpu.ops.attn_block import STATS_LANES, attn_block_stats_pallas
from vit_fpga_tpu.ops.fused_mlp import fused_mlp_chunked_stats_pallas
from vit_fpga_tpu_torch.models import vit as tvit
from vit_fpga_tpu_torch.models.convert import params_from_numpy
from vit_fpga_tpu_torch.ops import fused_mlp as tfm

# 72 rows: not a multiple of the JAX kernel's 256-row block, so its
# padding rows (x = 0, stats = 1) are exercised and sliced away.
T, D, M = 72, 64, 256
_PARAMS = ("ls", "lb", "w1", "b1", "w2", "b2")
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


def _inputs(seed):
    rng = np.random.default_rng(seed)

    def f(*shape, sc=0.1):
        return (rng.normal(size=shape) * sc).astype(np.float32)

    return dict(x=f(T, D, sc=1.0), ls=1.0 + f(D), lb=f(D), w1=f(D, M, sc=0.2),
                b1=f(M), w2=f(M, D, sc=0.2), b2=f(D, sc=0.3))


def _jax_k3(p, dt, act, n_chunks, emit_stats):
    x_j = jnp.asarray(p["x"]).astype(dt)
    xf = np.array(x_j.astype(jnp.float32))
    st = _stats_of(xf)
    out, out_st = fused_mlp_chunked_stats_pallas(
        x_j, jnp.asarray(st), *[jnp.asarray(p[k]) for k in _PARAMS],
        act=act, n_chunks=n_chunks, emit_stats=emit_stats, interpret=True)
    return xf, st, out, out_st


def _torch_args(p, xf, st, dt):
    return (torch.from_numpy(xf).to(dt), torch.from_numpy(st[:, :2].copy()),
            *[torch.from_numpy(p[k]) for k in _PARAMS])


@pytest.mark.parametrize("emit_stats", [True, False])
@pytest.mark.parametrize("act", ["gelu_tanh", "quick_gelu", "relu"])
@pytest.mark.parametrize("n_chunks", [2, 4])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_chunked_stats_plain_matches_pallas(dtype, n_chunks, act,
                                            emit_stats):
    """f32: same arithmetic, summation order only (1e-5).  bf16: h, every
    chunk's bf16(y) and the running output are rounded at the same points
    on both sides; accumulation order flips an occasional ulp."""
    p = _inputs(10 + n_chunks)
    dj, dt = ((jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16"
              else (jnp.float32, torch.float32))
    xf, st, want, want_st = _jax_k3(p, dj, act, n_chunks, emit_stats)
    got, got_st = tfm.fused_mlp_chunked_stats(
        *_torch_args(p, xf, st, dt), act=act, n_chunks=n_chunks,
        emit_stats=emit_stats)
    assert got.dtype == dt and got.shape == (T, D)
    w = np.asarray(want.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), w, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_allclose(got.float().numpy(), w, rtol=BF16_RTOL,
                                   atol=BF16_ATOL)
    if emit_stats:
        # the emitted stats of the port's own output, as the JAX kernel's
        # of its own
        np.testing.assert_allclose(got_st.numpy(),
                                   _stats_of(got.float().numpy())[:, :2],
                                   rtol=1e-4, atol=1e-5)
        tol = 1e-4 if dtype == "float32" else 1e-2
        np.testing.assert_allclose(got_st.numpy(), np.asarray(want_st)[:, :2],
                                   rtol=tol, atol=tol)
    else:
        assert got_st is None and want_st is None


# (T, M, n_chunks) whose chunks end inside the card GEMM's 64-deep K step:
# 96 columns a chunk (the boundary 32 columns into the second step), and
# 32 (two boundaries in each step); 200 rows, a partial 128-row tile.
MID_STEP = [(200, 192, 2), (200, 128, 4)]


def _act_f64(h, act):
    if act == "gelu_tanh":
        return 0.5 * h * (1.0 + np.tanh(h * (0.7978845608028654
                                             + 0.035677408136300125 * h * h)))
    if act == "quick_gelu":
        return h / (1.0 + np.exp(-1.702 * h))
    return np.maximum(h, 0.0)


@pytest.mark.parametrize("act", ["gelu_tanh", "quick_gelu", "relu"])
@pytest.mark.parametrize("t,m,n_chunks", MID_STEP,
                         ids=[f"{t}x{m}_c{n}" for t, m, n in MID_STEP])
def test_chunked_stats_plain_matches_pallas_mid_step(t, m, n_chunks, act):
    """K3's plain version (the function the card kernel is held to) vs
    ``fused_mlp_chunked_stats_pallas(interpret=True)`` in bf16 where a
    chunk is not a multiple of 64 columns, with emitted stats."""
    rng = np.random.default_rng(t + m + n_chunks)

    def f(*shape, sc=0.1):
        return (rng.normal(size=shape) * sc).astype(np.float32)

    p = dict(x=f(t, D, sc=1.0), ls=1.0 + f(D), lb=f(D), w1=f(D, m, sc=0.2),
             b1=f(m), w2=f(m, D, sc=0.2), b2=f(D, sc=0.3))
    xf, st, want, want_st = _jax_k3(p, jnp.bfloat16, act, n_chunks, True)
    got, got_st = tfm.fused_mlp_chunked_stats(
        *_torch_args(p, xf, st, torch.bfloat16), act=act, n_chunks=n_chunks,
        emit_stats=True)
    assert got.shape == (t, D)
    # Both sides round each chunk's y and the running output to bf16; a sum
    # order that moves one of those roundings moves the output by an ulp of
    # that intermediate, which may be larger than the output: the band is
    # 2 bf16 ulps of |x| + sum_c |y_c| (y_c in float64), plus 2^-8.
    xn = ((xf - st[:, 0:1]) * st[:, 1:2] * p["ls"] + p["lb"]).astype(
        np.float64)
    mc = m // n_chunks
    mag = np.abs(xf).astype(np.float64)
    for c in range(n_chunks):
        cols = slice(c * mc, (c + 1) * mc)
        mag += np.abs(_act_f64(xn @ p["w1"][:, cols] + p["b1"][cols], act)
                      @ p["w2"][cols])
    diff = np.abs(got.float().numpy() - np.asarray(want.astype(jnp.float32)))
    assert (diff <= BF16_RTOL * mag + BF16_ATOL).all(), float(diff.max())
    np.testing.assert_allclose(got_st.numpy(), np.asarray(want_st)[:, :2],
                               rtol=1e-2, atol=1e-2)


def test_chunked_is_not_k2_in_bf16():
    """In bf16 K3 rounds the running output at every chunk boundary and
    adds b2 on the last chunk only, so it is another function than K2: the
    port's K3 differs from its K2 on the same inputs and matches the JAX
    K3 closer than the two differ."""
    p = _inputs(20)
    xf, st, want, _ = _jax_k3(p, jnp.bfloat16, "gelu_tanh", 2, False)
    args = _torch_args(p, xf, st, torch.bfloat16)
    k3, _ = tfm.fused_mlp_chunked_stats(*args, act="gelu_tanh", n_chunks=2,
                                        emit_stats=False)
    k2, _ = tfm.fused_mlp_stats(*args, act="gelu_tanh", emit_stats=False)
    w = np.asarray(want.astype(jnp.float32))
    d_k2 = np.abs(k3.float().numpy() - k2.float().numpy())
    d_jax = np.abs(k3.float().numpy() - w)
    assert (d_k2 > 0).sum() > 0.05 * d_k2.size, (d_k2 > 0).mean()
    assert (d_jax > 0).sum() < (d_k2 > 0).sum() / 4, (
        (d_jax > 0).mean(), (d_k2 > 0).mean())


def test_chunked_rejects_bad_chunks_and_devices():
    p = _inputs(21)
    xf = p["x"]
    st = _stats_of(xf)
    with pytest.raises(ValueError):
        tfm.fused_mlp_chunked_stats(*_torch_args(p, xf, st, torch.float32),
                                    n_chunks=3)
    with pytest.raises(ValueError):
        tfm.fused_mlp_chunked_stats(
            torch.empty((T, D), device="meta"),
            torch.empty((T, 2), device="meta"),
            *[torch.from_numpy(p[k]) for k in _PARAMS], n_chunks=2)


_PLAN_CFGS = {
    "vit_b16": lambda dt: jvit.config("vit_b16", dtype=dt),
    "vit_l16": lambda dt: jvit.config("vit_l16", dtype=dt),
    "vit_l14": lambda dt: jvit.config("vit_l14", dtype=dt),
    "vit_h14": lambda dt: jvit.config("vit_h14", dtype=dt),
    "clip_vit_l14": lambda dt: jclip.clip_vision_config("vit_l14", dtype=dt),
}


def _torch_cfg(jcfg):
    names = {f.name for f in dataclasses.fields(tvit.ViTConfig)}
    return tvit.ViTConfig(**{k: v for k, v in
                             dataclasses.asdict(jcfg).items() if k in names})


@pytest.mark.parametrize("rows", [9344, 12800, 16896, 32768, 33792])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("model", sorted(_PLAN_CFGS))
def test_mlp_plan_matches_jax_planner(model, dtype, rows):
    """The port's plan is the JAX ``_stats_chain_mlp_vmem`` mapped: 0 or
    MLP_BIG_VMEM -> "k2", -n -> n (K3 with n chunks), None -> None."""
    jcfg = _PLAN_CFGS[model](dtype)
    want = jvit._stats_chain_mlp_vmem(jcfg, rows)
    mapped = None if want is None else "k2" if want >= 0 else -want
    assert tvit._stats_chain_mlp_plan(_torch_cfg(jcfg), rows) == mapped


def test_chain_gate_follows_the_plan():
    """ViT-H (4 chunks) and ViT-L in f32 leave the chain for the per-block
    encoder; ViT-L at b64 takes K3, at b128 K2; ViT-B in f32 takes K3."""
    cfg = tvit.config("vit_h14")
    assert not tvit._stats_chain_supported(cfg, 64)
    assert not tvit._stats_chain_supported(tvit.config("vit_l16",
                                                       dtype="float32"), 64)
    l16 = tvit.config("vit_l16")
    assert tvit._stats_chain_supported(l16, 64)
    assert tvit._stats_chain_mlp_plan(l16, 64 * 200) == 2
    assert tvit._stats_chain_mlp_plan(l16, 164 * 200) == "k2"
    assert tvit._stats_chain_mlp_plan(tvit.config("vit_b16",
                                                  dtype="float32"),
                                      64 * 200) == 2
    assert not tvit._stats_chain_supported(
        dataclasses.replace(l16, safe_softmax=True), 64)


def _chain_blocks(seed, depth, d, m):
    rng = np.random.default_rng(seed)

    def f(*shape, sc=0.1):
        return (rng.normal(size=shape) * sc).astype(np.float32)

    return {"ln1_scale": 1.0 + f(depth, d), "ln1_bias": f(depth, d),
            "wqkv": f(depth, d, 3 * d), "bqkv": f(depth, 3 * d),
            "wo": f(depth, d, d), "bo": f(depth, d),
            "ln2_scale": 1.0 + f(depth, d), "ln2_bias": f(depth, d),
            "w1": f(depth, d, m), "b1": f(depth, m),
            "w2": f(depth, m, d, sc=0.05), "b2": f(depth, d)}


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_chain_with_k3_matches_pallas_composition(dtype):
    """The port's _encoder_stats_chain with plan 2 (plain K1 + plain K3)
    against the same chain composed of attn_block_stats_pallas and
    fused_mlp_chunked_stats_pallas in interpret mode: depth 2, D 64, M 256,
    2 heads, 24 rows of which 19 valid.  f32 1e-4; bf16 2e-2 in relative
    norm over the valid rows."""
    depth, b, n_pad, n_valid, d, m, heads = 2, 2, 24, 19, 64, 256, 2
    eps = 1e-6
    blocks = _chain_blocks(30, depth, d, m)
    x = (np.random.default_rng(31).normal(size=(b, n_pad, d))
         ).astype(np.float32)
    dj, dt = ((jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16"
              else (jnp.float32, torch.float32))
    xj = jnp.asarray(x).astype(dj)
    st = jnp.asarray(_stats_of(np.asarray(xj.astype(jnp.float32))
                               .reshape(-1, d), eps)
                     .reshape(b, n_pad, STATS_LANES))
    jb = {k: jnp.asarray(v) for k, v in blocks.items()}
    for i in range(depth):
        last = i == depth - 1
        xj, st = attn_block_stats_pallas(
            xj, st, jb["ln1_scale"][i], jb["ln1_bias"][i], jb["wqkv"][i],
            jb["bqkv"][i], jb["wo"][i], jb["bo"][i], heads, eps=eps,
            n_valid=n_valid, emit_stats=True, interpret=True)
        t, st2 = fused_mlp_chunked_stats_pallas(
            xj.reshape(b * n_pad, d), st.reshape(b * n_pad, STATS_LANES),
            jb["ln2_scale"][i], jb["ln2_bias"][i], jb["w1"][i], jb["b1"][i],
            jb["w2"][i], jb["b2"][i], eps=eps, act="gelu_tanh", n_chunks=2,
            emit_stats=not last, interpret=True)
        xj = t.reshape(b, n_pad, d)
        if not last:
            st = st2.reshape(b, n_pad, STATS_LANES)
    want = np.asarray(xj.astype(jnp.float32))[:, :n_valid]

    cfg = tvit.ViTConfig(hidden_dim=d, depth=depth, num_heads=heads,
                         mlp_dim=m, ln_eps=eps, dtype=dtype,
                         hidden_act="gelu_tanh")
    tb = params_from_numpy(blocks, device="cpu")
    xt = torch.from_numpy(np.array(jnp.asarray(x).astype(dj)
                                   .astype(jnp.float32))).to(dt)
    with torch.inference_mode():
        got = tvit._encoder_stats_chain(tb, xt, cfg, n_valid, plan=2)
    got = got.float().numpy()[:, :n_valid]
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    else:
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel < 2e-2, rel
