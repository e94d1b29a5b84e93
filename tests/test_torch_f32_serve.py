"""f32 serving: the plain f32 versions of K1, K2 / K3, K4 and K9 (the
functions their true-f32 card kernels are held to) against the JAX Pallas
kernels in interpret mode in f32, the port's f32 route decisions against
the JAX planners at itemsize 4 over the model catalog, and tiny f32 ViTs
through ``make_forward(device="cpu")`` on each f32 route against the JAX
f32 forward on the CPU, on the same seeded numpy inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_fpga_tpu.models import clip as jclip
from vit_fpga_tpu.models import deit as jdeit
from vit_fpga_tpu.models import quantized as jq
from vit_fpga_tpu.models import vit as jvit
from vit_fpga_tpu.ops import attention as jatt
from vit_fpga_tpu.ops import flash_attention as jfa
from vit_fpga_tpu.ops import fused_mlp as jfm
from vit_fpga_tpu.ops.attn_block import (STATS_LANES, attn_block_pallas,
                                         attn_block_stats_pallas)
from vit_fpga_tpu_torch.models import clip as tclip
from vit_fpga_tpu_torch.models import deit as tdeit
from vit_fpga_tpu_torch.models import quantized as tq
from vit_fpga_tpu_torch.models import vit as tvit
from vit_fpga_tpu_torch.models.convert import params_from_numpy
from vit_fpga_tpu_torch.ops import attention as tatt
from vit_fpga_tpu_torch.ops import attn_block as tab
from vit_fpga_tpu_torch.ops import flash_attention as tfa
from vit_fpga_tpu_torch.ops import fused_mlp as tfm

_ATTN = ("ls", "lb", "wqkv", "bqkv", "wo", "bo")
_MLP = ("ls", "lb", "w1", "b1", "w2", "b2")
# Plain f32 version vs the JAX kernel in interpret mode: the same f32
# arithmetic (the same clip, one-pass stats, erf), only the order of the
# sums differs, which moves an element by a few f32 ulps of the terms it
# sums: 1e-5 relative and absolute.
F32_TOL = 1e-5
# The hot-logit halves: scores of |s| up to ~600 carry an f32 rounding of
# up to |s| 2^-24 sqrt(dh) (~3e-4 at dh 64) into e = exp(s - max) of the
# exact softmax, and into the output with it (read: up to 1.8e-4 in the
# safe mode; the max-free clip holds most such scores fixed, 1.2e-5).
# 5e-4 relative and absolute; a wrong clip, mask or softmax moves the
# output by 1e-1 or more.
HOT_TOL = 5e-4
# q and k columns of Wqkv scaled by HOT: most scores lie past the max-free
# window [-70, 80], where the max-free and exact softmaxes part.
HOT = 10.0
# Tiny f32 forwards against the JAX CPU forward: 5% of the largest logit
# and equal top-1, as the bf16 slices hold them; in f32 they also agree to
# 1e-4 of the largest logit (tests/test_torch_per_block.py's f32 band).
LOGITS_BAND = 0.05
F32_BAND = 1e-4
INT8_BAND = 0.05


def _stats_of(x2d, eps=1e-6):
    xf = np.asarray(x2d, np.float32)
    mu = xf.mean(-1, keepdims=True)
    var = np.maximum((xf * xf).mean(-1, keepdims=True) - mu * mu, 0.0)
    st = np.zeros((xf.shape[0], STATS_LANES), np.float32)
    st[:, 0:1] = mu
    st[:, 1:2] = 1.0 / np.sqrt(var + eps)
    return st


def _f(rng, *shape, sc=0.1):
    return (rng.normal(size=shape) * sc).astype(np.float32)


def _attn_inputs(seed, b, n_pad, d, hot=False):
    rng = np.random.default_rng(seed)
    w = 0.1 * (128 / d) ** 0.5
    p = dict(x=_f(rng, b, n_pad, d, sc=0.5), ls=1.0 + _f(rng, d),
             lb=_f(rng, d), wqkv=_f(rng, d, 3 * d, sc=w),
             bqkv=_f(rng, 3 * d), wo=_f(rng, d, d, sc=w), bo=_f(rng, d))
    if hot:
        p["wqkv"][:, :2 * d] *= HOT
    return p


def _max_score(p, heads):
    """The largest |score| of the half's attention (f64, plain LN)."""
    x = p["x"].astype(np.float64)
    d = x.shape[-1]
    mu = x.mean(-1, keepdims=True)
    xn = (x - mu) / np.sqrt(x.var(-1, keepdims=True) + 1e-6) * p["ls"] \
        + p["lb"]
    qkv = xn @ p["wqkv"] + p["bqkv"]
    b, n, _ = x.shape
    q = qkv[..., :d].reshape(b, n, heads, -1).transpose(0, 2, 1, 3)
    k = qkv[..., d:2 * d].reshape(b, n, heads, -1).transpose(0, 2, 1, 3)
    s = q @ k.transpose(0, 1, 3, 2) / np.sqrt(d // heads)
    return float(np.abs(s).max())


# ---------------------------------------------------------------------------
# K1: the chain's attention half in f32
# ---------------------------------------------------------------------------

K1_CASES = [  # (b, n_pad, n_valid, d, heads, hot)
    (2, 72, 65, 128, 2, False),     # n_valid < n_pad, a partial key tile
    (1, 200, 197, 128, 2, False),   # ViT-B/16's 197 tokens on 200 rows
    (2, 72, 72, 128, 2, True),      # scores past the clip window
    (1, 136, 129, 256, 4, True),
]


@pytest.mark.parametrize("b,n_pad,n_valid,d,heads,hot", K1_CASES)
def test_k1_f32_plain_matches_pallas(b, n_pad, n_valid, d, heads, hot):
    """``attn_block_stats_plain`` in f32 against ``attn_block_stats_pallas(
    interpret=True)`` in f32, rows before n_valid (those past it are
    computed on both sides and differ only where their own stats do): the
    output within F32_TOL (HOT_TOL on hot logits, whose max-free clip holds
    most scores fixed), and the emitted stats: the port's are the one-pass
    stats of its own f32 output, the JAX kernel's come from its unrounded
    sum; in f32 that rounding is the identity, so the two agree to f32
    rounding (checked, 1e-5)."""
    p = _attn_inputs(10 * n_pad + int(hot), b, n_pad, d, hot)
    if hot:
        assert _max_score(p, heads) > 80.0
    st = _stats_of(p["x"].reshape(-1, d)).reshape(b, n_pad, STATS_LANES)
    want, want_st = attn_block_stats_pallas(
        jnp.asarray(p["x"]), jnp.asarray(st),
        *[jnp.asarray(p[k]) for k in _ATTN], heads, n_valid=n_valid,
        emit_stats=True, interpret=True)
    got, got_st = tab.attn_block_stats(
        torch.from_numpy(p["x"]), torch.from_numpy(st[..., :2].copy()),
        *[torch.from_numpy(p[k]) for k in _ATTN], heads, n_valid=n_valid,
        emit_stats=True)
    assert got.dtype == torch.float32
    v = slice(0, n_valid)
    tol = HOT_TOL if hot else F32_TOL
    np.testing.assert_allclose(got.numpy()[:, v], np.asarray(want)[:, v],
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(got_st.numpy()[:, v],
                               np.asarray(want_st)[:, v, :2], rtol=1e-5,
                               atol=1e-5)


def test_k1_f32_max_free_is_not_the_exact_softmax_on_hot_logits():
    """On hot logits the max-free half (K1's, the JAX kernel's) and the
    exact-softmax reference part by far more than the f32 band: the case
    above holds the clip, not a softmax that happens to agree."""
    b, n_pad, d, heads = 2, 72, 128, 2
    p = _attn_inputs(721, b, n_pad, d, hot=True)
    x = torch.from_numpy(p["x"])
    args = [torch.from_numpy(p[k]) for k in _ATTN]
    st = torch.from_numpy(_stats_of(p["x"].reshape(-1, d))[:, :2].copy()
                          ).reshape(b, n_pad, 2)
    got, _ = tab.attn_block_stats(x, st, *args, heads, emit_stats=False)
    exact = tab.attn_block_xla(x, *args, heads)
    assert float((got - exact).abs().max()) > 1e3 * HOT_TOL


# ---------------------------------------------------------------------------
# K2 / K3: the chain's MLP half in f32
# ---------------------------------------------------------------------------

def _mlp_inputs(seed, t=72, d=64, m=256):
    rng = np.random.default_rng(seed)
    return dict(x=_f(rng, t, d, sc=1.0), ls=1.0 + _f(rng, d), lb=_f(rng, d),
                w1=_f(rng, d, m, sc=0.2), b1=_f(rng, m), w2=_f(rng, m, d,
                                                             sc=0.2),
                b2=_f(rng, d, sc=0.3))


@pytest.mark.parametrize("act", ["gelu", "gelu_tanh", "quick_gelu", "relu"])
@pytest.mark.parametrize("n_chunks", [1, 2, 4])
def test_k2_k3_f32_plain_matches_pallas(n_chunks, act):
    """K2's (one chunk) and K3's (2 and 4 chunks) plain f32 versions
    against ``fused_mlp_stats_pallas`` / ``fused_mlp_chunked_stats_pallas``
    (interpret=True) in f32, erf-GELU ("gelu", the port's f32 chain
    activation) included: output within F32_TOL, the emitted stats within
    1e-5 of the JAX kernel's (its unrounded sum)."""
    p = _mlp_inputs(30 + n_chunks)
    st = _stats_of(p["x"])
    jargs = [jnp.asarray(p["x"]), jnp.asarray(st)] + [
        jnp.asarray(p[k]) for k in _MLP]
    targs = [torch.from_numpy(p["x"]), torch.from_numpy(st[:, :2].copy())] \
        + [torch.from_numpy(p[k]) for k in _MLP]
    if n_chunks == 1:
        want, want_st = jfm.fused_mlp_stats_pallas(*jargs, act=act,
                                                   interpret=True)
        got, got_st = tfm.fused_mlp_stats(*targs, act=act)
    else:
        want, want_st = jfm.fused_mlp_chunked_stats_pallas(
            *jargs, act=act, n_chunks=n_chunks, interpret=True)
        got, got_st = tfm.fused_mlp_chunked_stats(*targs, act=act,
                                                  n_chunks=n_chunks)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_TOL,
                               atol=F32_TOL)
    np.testing.assert_allclose(got_st.numpy(), np.asarray(want_st)[:, :2],
                               rtol=1e-5, atol=1e-5)


def test_k3_f32_chunks_change_only_the_order_of_the_sum():
    """In f32 K3's chunk boundaries round nothing: its plain version and
    K2's differ by f32 rounding alone (where in bf16 they differ by
    whole ulps), so one f32 launch can serve both routes."""
    p = _mlp_inputs(40)
    targs = [torch.from_numpy(p["x"]),
             torch.from_numpy(_stats_of(p["x"])[:, :2].copy())] + [
        torch.from_numpy(p[k]) for k in _MLP]
    k2, _ = tfm.fused_mlp_stats(*targs, act="gelu")
    k3, _ = tfm.fused_mlp_chunked_stats(*targs, act="gelu", n_chunks=4)
    np.testing.assert_allclose(k3.numpy(), k2.numpy(), rtol=F32_TOL,
                               atol=F32_TOL)


# ---------------------------------------------------------------------------
# K4: the per-block attention half in f32 (head dim 64 and 80)
# ---------------------------------------------------------------------------

K4_CASES = [  # (b, n_pad, n_valid, d, heads, hot)
    (2, 72, 65, 128, 2, False),
    (1, 200, 197, 128, 2, False),
    (2, 40, 33, 160, 2, False),    # head dim 80 (ViT-H/14's)
    (1, 136, 129, 160, 2, False),  # head dim 80 past a 128-key tile
    (2, 72, 72, 128, 2, True),
    (1, 72, 65, 160, 2, True),
]


@pytest.mark.parametrize("safe", [False, True], ids=["max_free", "safe"])
@pytest.mark.parametrize("b,n_pad,n_valid,d,heads,hot", K4_CASES)
def test_k4_f32_plain_matches_pallas(b, n_pad, n_valid, d, heads, hot,
                                     safe):
    """``attn_block_fwd_plain`` in f32 against ``attn_block_pallas(
    interpret=True)`` in f32, in both softmax modes, head dim 64 and 80,
    rows before n_valid: within F32_TOL (HOT_TOL on hot logits)."""
    p = _attn_inputs(20 * n_pad + d + int(hot), b, n_pad, d, hot)
    if hot:
        assert _max_score(p, heads) > 80.0
    want = attn_block_pallas(jnp.asarray(p["x"]),
                             *[jnp.asarray(p[k]) for k in _ATTN], heads,
                             n_valid=n_valid, safe_softmax=safe,
                             interpret=True)
    got = tab.attn_block_fwd(torch.from_numpy(p["x"]),
                             *[torch.from_numpy(p[k]) for k in _ATTN],
                             heads, n_valid=n_valid, safe_softmax=safe)
    v = slice(0, n_valid)
    tol = HOT_TOL if hot else F32_TOL
    np.testing.assert_allclose(got.numpy()[:, v], np.asarray(want)[:, v],
                               rtol=tol, atol=tol)


def test_k4_f32_hot_logits_part_the_two_softmaxes():
    """On hot logits K4's max-free and safe modes part by far more than
    their band, so the cases above hold each mode's own function."""
    p = _attn_inputs(731, 1, 72, 160, hot=True)
    args = [torch.from_numpy(p["x"])] + [torch.from_numpy(p[k])
                                          for k in _ATTN]
    free = tab.attn_block_fwd(*args, 2, safe_softmax=False)
    safe = tab.attn_block_fwd(*args, 2, safe_softmax=True)
    assert float((free - safe).abs().max()) > 1e3 * HOT_TOL


# ---------------------------------------------------------------------------
# K9: flash attention in f32
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,n_valid,bk", [(300, 290, 128), (1100, 1090, 512),
                                          (640, 513, 128)])
def test_k9_f32_plain_matches_pallas(n, n_valid, bk):
    """``flash_attention_plain`` in f32 against the JAX ``flash_attention(
    interpret=True)`` in f32, keys past n_valid masked, the key block bk
    of the per-block path (128) and the default (512), rows before
    n_valid: within F32_TOL.  Keys that grow along the sequence move the
    running max in later blocks."""
    rng = np.random.default_rng(n + n_valid)
    q, k, v = (rng.normal(size=(1, 2, n, 64)).astype(np.float32)
               for _ in range(3))
    k += np.linspace(0.0, 3.0, n, dtype=np.float32)[None, None, :, None]
    want = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), n_valid=n_valid, bk=bk,
                               interpret=True)
    got = tfa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), n_valid=n_valid, bk=bk)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy()[:, :, :n_valid],
                               np.asarray(want)[:, :, :n_valid],
                               rtol=F32_TOL, atol=F32_TOL)


# ---------------------------------------------------------------------------
# The f32 routes against the JAX planners at itemsize 4
# ---------------------------------------------------------------------------

CATALOG = {
    "vit_b16": (lambda s: jvit.config("vit_b16", image_size=s,
                                      dtype="float32"),
                lambda s: tvit.config("vit_b16", image_size=s,
                                      dtype="float32")),
    "vit_s16": (lambda s: jvit.config("vit_s16", image_size=s,
                                      dtype="float32"),
                lambda s: tvit.config("vit_s16", image_size=s,
                                      dtype="float32")),
    "vit_l16": (lambda s: jvit.config("vit_l16", image_size=s,
                                      dtype="float32"),
                lambda s: tvit.config("vit_l16", image_size=s,
                                      dtype="float32")),
    "vit_h14": (lambda s: jvit.config("vit_h14", image_size=s,
                                      dtype="float32"),
                lambda s: tvit.config("vit_h14", image_size=s,
                                      dtype="float32")),
    "deit_s16": (lambda s: jdeit.config("deit_s16", image_size=s,
                                        dtype="float32"),
                 lambda s: tdeit.config("deit_s16", image_size=s,
                                        dtype="float32")),
    "clip_vit_l14": (lambda s: jclip.clip_vision_config(
        "vit_l14", image_size=s, dtype="float32"),
        lambda s: tclip.clip_vision_config("vit_l14", image_size=s,
                                           dtype="float32")),
}
ROUTE_SIZES = {"vit_b16": (224, 384, 640, 896, 1024)}
ROUTE_BATCHES = (1, 2, 3, 4, 64)


def _jax_route(jcfg, batch):
    """The JAX package's f32 decision for one batch, from its planners as
    on a TPU: ("chain", "k2" | n chunks) or ("block" | "unfused" with its
    attention impl, the MLP route)."""
    rows = batch * (-(-jcfg.seq_len // 8) * 8)    # tokens padded to 8
    if jvit._stats_chain_supported(jcfg, batch):
        vmem = jvit._stats_chain_mlp_vmem(jcfg, rows)
        return ("chain", "k2" if vmem >= 0 else -vmem)
    if jvit._attn_block_fits(jcfg):
        attn = "block"
    else:
        attn = ("unfused-flash" if jcfg.seq_len
                >= jatt.FLASH_SEQ_THRESHOLD else "unfused-pallas")
    n_chunks = jfm.mlp_weight_chunks(jcfg.hidden_dim, jcfg.mlp_dim, 4)
    if n_chunks == 1 and jcfg.hidden_act != "gelu":
        mlp = ("pallas", 1)
    else:
        mlp = ("xla", 0)     # 2+ chunks, or erf-GELU in f32
    return (attn, mlp)


def _port_route(tcfg, batch):
    rows = batch * tvit._n_pad(tcfg)
    if tvit._stats_chain_supported(tcfg, batch):
        return ("chain", tvit._stats_chain_mlp_plan(tcfg, rows))
    attn = tvit._attn_route(tcfg)
    if attn == "unfused":
        attn += ("-flash" if tcfg.seq_len >= tatt.FLASH_SEQ_THRESHOLD
                 else "-pallas")
    return (attn, tvit._mlp_route(tcfg, rows))


@pytest.mark.parametrize("model", sorted(CATALOG))
def test_f32_routes_match_the_jax_planners(model, monkeypatch):
    """For each catalog model in f32 (and ViT-B/16 at 384-1024 px) and
    batches 1-4 and 64: the stats chain with its MLP plan (K2, or K3 with
    n chunks), the fused attention half (K4), or the unfused half with
    flash attention (K9) from 1024 tokens, and the MLP route, as the JAX
    planners decide them at itemsize 4, evaluated as on a TPU."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    jmake, tmake = CATALOG[model]
    for size in ROUTE_SIZES.get(model, (224,)):
        jcfg, tcfg = jmake(size), tmake(size)
        assert jcfg.seq_len == tcfg.seq_len
        for batch in ROUTE_BATCHES:
            assert _port_route(tcfg, batch) == _jax_route(jcfg, batch), \
                (model, size, batch)


def test_f32_route_table():
    """The f32 routes a TPU takes, which the card now serves: ViT-B/16 at
    even batches the chain with K3 in 2 chunks (to 640 px), at odd batches
    K4 and the plain MLP; ViT-S/16 and DeiT-S/16 the chain with K2; ViT-L,
    ViT-H/14 and CLIP ViT-L/14 K4 and the plain MLP; ViT-B/16 at 896 and
    1024 px the unfused half with K9; no f32 route reaches K5 or K6 under
    the defaults."""
    b16 = tvit.config("vit_b16", dtype="float32")
    assert _port_route(b16, 64) == _port_route(b16, 2) == ("chain", 2)
    assert _port_route(tvit.config("vit_b16", image_size=640,
                                   dtype="float32"), 16) == ("chain", 2)
    for b in (1, 3):
        assert _port_route(b16, b) == ("block", ("xla", 0))
    for cfg in (tvit.config("vit_s16", dtype="float32"),
                tdeit.config("deit_s16", dtype="float32")):
        assert _port_route(cfg, 64) == ("chain", "k2")
    for cfg in (tvit.config("vit_l16", dtype="float32"),
                tvit.config("vit_h14", dtype="float32"),
                tclip.clip_vision_config("vit_l14", dtype="float32")):
        for b in (1, 64):
            assert _port_route(cfg, b) == ("block", ("xla", 0))
    assert tvit.config("vit_h14").hidden_dim // 16 == 80
    for size in (896, 1024):
        cfg = tvit.config("vit_b16", image_size=size, dtype="float32")
        assert _port_route(cfg, 1) == ("unfused-flash", ("xla", 0))


# ---------------------------------------------------------------------------
# Tiny f32 ViTs through make_forward(device="cpu"), each route
# ---------------------------------------------------------------------------

TINY = dict(image_size=32, patch_size=16, hidden_dim=128, depth=2,
            num_heads=2, num_classes=10, dtype="float32")
# (route, config overrides on both sides, the JAX side's own, the plain
# versions the port's route runs, and how many times)
ROUTES = {
    "chain_k3": (dict(mlp_dim=12288), {},
                 {"attn_block_stats_plain": 2,
                  "fused_mlp_chunked_stats_plain": 2}),
    "chain_k2": (dict(mlp_dim=512), {},
                 {"attn_block_stats_plain": 2, "fused_mlp_stats_plain": 2}),
    "k4_max_free": (dict(mlp_dim=512, mlp_impl="xla"), {},
                    {"attn_block_fwd_plain": 2}),
    "k4_safe": (dict(mlp_dim=512, safe_softmax=True), {},
                {"attn_block_fwd_plain": 2}),
    "k9": (dict(mlp_dim=512, attn_impl="flash"), dict(attn_impl="xla"),
           {"flash_attention_plain": 2}),
}
_PLAINS = ((tab, "attn_block_stats_plain"), (tab, "attn_block_fwd_plain"),
           (tfm, "fused_mlp_stats_plain"),
           (tfm, "fused_mlp_chunked_stats_plain"),
           (tfa, "flash_attention_plain"))


def _perturbed(jcfg, seed):
    rng = np.random.default_rng(seed)
    params = jvit.init_params(jax.random.key(0), jcfg)
    return jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.02 * rng.normal(size=p.shape).astype(
            np.float32), params)


def _count_plains(monkeypatch):
    calls = {}
    for mod, name in _PLAINS:
        fn = getattr(mod, name)

        def wrapped(*a, _fn=fn, _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **k)

        monkeypatch.setattr(mod, name, wrapped)
    return calls


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_tiny_f32_vit_matches_jax_on_each_route(route, monkeypatch):
    """A tiny f32 ViT (D 128, 2 heads of 64, depth 2) through
    ``make_forward(device="cpu")`` on each f32 route: the chain with K3 in
    2 chunks (M 12288: the JAX plan chunks the f32 weights) or K2, K4 in
    either softmax mode with the plain MLP, the unfused half with K9;
    each route's plain versions run as counted, and the logits match the
    JAX f32 forward on the CPU within 5% (and 1e-4) of the largest logit,
    top-1 equal."""
    both, jax_only, want_calls = ROUTES[route]
    jcfg = jvit.ViTConfig(**TINY, **{**both, **jax_only})
    tcfg = tvit.ViTConfig(**TINY, **both)
    if route == "chain_k3":
        assert tvit._stats_chain_mlp_plan(tcfg, 2 * tvit._n_pad(tcfg)) == 2
    np_params = _perturbed(jcfg, 51)
    jp = jax.tree_util.tree_map(jnp.asarray, np_params)
    tp = params_from_numpy(np_params, device="cpu")
    img = np.random.default_rng(52).integers(0, 256, (2, 32, 32, 3),
                                             np.uint8)
    want = np.asarray(jvit.forward_raw(jp, jnp.asarray(img), jcfg))
    calls = _count_plains(monkeypatch)
    got = tvit.make_forward(tcfg, tp, device="cpu")(img).numpy()
    assert calls == want_calls
    rel = float(np.abs(got - want).max() / np.abs(want).max())
    assert rel < LOGITS_BAND and rel < F32_BAND, rel
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))


def test_per_tensor_int8_at_1024_tokens_matches_jax(monkeypatch):
    """The per-tensor int8 forward (f32 activations) at 1025 tokens (64 px,
    patch 2), D 64, one head, depth 1: ``mha_qkv`` "auto" takes flash
    attention (K9's f32 mode on the card) from 1024 tokens on, K7 not at
    all; against the JAX ``vit_forward_int8`` on the CPU in the int8 band,
    top-1 equal."""
    kw = dict(image_size=64, patch_size=2, hidden_dim=64, depth=1,
              num_heads=1, mlp_dim=128, num_classes=10, dtype="float32")
    jcfg, tcfg = jvit.ViTConfig(**kw), tvit.ViTConfig(**kw)
    assert tcfg.seq_len == 1025
    np_params = _perturbed(jcfg, 61)
    jp = jax.tree_util.tree_map(jnp.asarray, np_params)
    tp = params_from_numpy(np_params, device="cpu")
    img = np.random.default_rng(62).integers(0, 256, (2, 64, 64, 3),
                                             np.uint8)
    x = np.array(jvit.preprocess(jnp.asarray(img), jcfg))
    want = np.asarray(jq.jit_vit_forward_int8(jcfg)(jq.quantize_vit(jp),
                                                     jnp.asarray(x)))
    calls = _count_plains(monkeypatch)
    k7 = []
    orig = tatt.mha_qkv_pallas
    monkeypatch.setattr(tatt, "mha_qkv_pallas",
                        lambda *a, **k: k7.append(1) or orig(*a, **k))
    fwd = tq.make_vit_forward_int8(tcfg, tq.quantize_vit(tp), raw=False,
                                   device="cpu")
    got = fwd(torch.from_numpy(x)).numpy()
    assert calls == {"flash_attention_plain": 1} and not k7
    rel = float(np.abs(got - want).max() / np.abs(want).max())
    assert rel < INT8_BAND, rel
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))


def test_f32_refusals_name_their_kernels():
    """The f32 modes not ported yet raise on the card, each naming its
    kernel (K5, K6, K24 in the MLP wrappers, K23 in the attention
    backward, K12 at the one-launch forward), while K4 admits f32; the
    gates read before any launch, so a meta tensor standing for a CUDA one
    is enough here."""
    t = torch.empty((64, 128), device="meta")
    w1 = torch.empty((128, 512), device="meta")
    for fn, name in ((tfm.fused_mlp_fwd, "K5"),
                     (tfm.fused_mlp_chunked_fwd, "K6"),
                     (tfm.fused_mlp_bwd, "K24")):
        with pytest.raises(ValueError, match=name):
            tfm._cuda_geometry(t, w1, kernel=f"{name} {fn.__name__}")
    x = torch.empty((1, 200, 128), device="meta")
    with pytest.raises(ValueError, match="K23"):
        tab._cuda_geometry(x, 2, 197, kernel="K23")
    assert tab._cuda_geometry(x, 2, 197, kernel="K4") == (1, 200, 128, 197)
    cfg = tvit.config("vit_b16", dtype="float32")
    img = torch.empty((1, 224, 224, 3), device="meta")
    with pytest.raises(NotImplementedError, match="K12"):
        tvit.forward_latency_logits({}, _CudaLike(img), cfg)


class _CudaLike:
    """An image batch whose device reads as CUDA: the K12 gate runs before
    anything touches the data."""

    def __init__(self, t):
        self.shape = t.shape
        self.device = torch.device("cuda")
