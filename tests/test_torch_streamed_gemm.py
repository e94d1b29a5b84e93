"""The port's streamed GEMM (plain PyTorch version of the Hopper kernel
K26) against the JAX package's streamed_gemm in interpret mode, on the
same seeded numpy inputs.

Tolerances: f32 runs the same bk-deep tile products accumulated in the
same order, so only the order inside one tile's dot differs: rtol = atol =
1e-5 on outputs of order sqrt(K).  A bf16 output is the same f32 sum
rounded once, so it may sit one bf16 ulp away where the two f32 sums
straddle a rounding boundary."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_fpga_tpu.ops.streamed_gemm import streamed_gemm as jax_streamed
from vit_fpga_tpu_torch.ops import streamed_gemm as tsg

# (T, K, N, bk, bt, bn): the JAX test's (64, 300) x (300, 128) at bk 128
# (a K tail of 44), the default tiles, and a tiled output grid with ragged
# T and N edges.
GEOMS = [(64, 300, 128, 128, None, None), (40, 256, 96, 512, None, None),
         (72, 200, 96, 64, 32, 64)]
DTYPES = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)]


def _within_one_bf16_ulp(got, want):
    g, w = np.asarray(got, np.float64), np.asarray(want, np.float64)
    mag = np.maximum(np.abs(g), np.abs(w))
    ulp = np.where(mag > 0, 2.0 ** (np.floor(np.log2(np.where(mag > 0, mag,
                                                             1.0))) - 7), 0)
    assert (np.abs(g - w) <= ulp).all(), float(np.abs(g - w).max())


def _inputs(seed, t, k, n, jdt):
    """x and w rounded to the compute dtype through jnp on both sides."""
    rng = np.random.default_rng(seed)
    x = jnp.asarray(rng.normal(size=(t, k)), jnp.float32).astype(jdt)
    w = jnp.asarray(rng.normal(size=(k, n)), jnp.float32).astype(jdt)
    return x, w


@pytest.mark.parametrize("geom", GEOMS, ids=["k300", "default", "tiled"])
@pytest.mark.parametrize("dts", DTYPES, ids=["f32", "bf16"])
def test_streamed_gemm_plain_matches_pallas(geom, dts):
    t, k, n, bk, bt, bn = geom
    jdt, tdt = dts
    x, w = _inputs(4, t, k, n, jdt)
    want = jax_streamed(x, w, bk=bk, bt=bt, bn=bn, interpret=True)
    xt = torch.from_numpy(np.array(x.astype(jnp.float32))).to(tdt)
    wt = torch.from_numpy(np.array(w.astype(jnp.float32))).to(tdt)
    got = tsg.streamed_gemm(xt, wt, bk=bk, bt=bt, bn=bn)
    assert got.dtype == tdt and tuple(got.shape) == (t, n)
    g, wv = got.float().numpy(), np.asarray(want.astype(jnp.float32))
    if tdt == torch.float32:
        np.testing.assert_allclose(g, wv, rtol=1e-5, atol=1e-5)
    else:
        _within_one_bf16_ulp(g, wv)


@pytest.mark.parametrize("bk", [128, 512])
def test_streamed_gemm_plain_matches_pallas_bf16_tile_edges(bk):
    """bf16 at the card GEMM's tile edges: T 200 (a partial 128-row tile,
    not a multiple of 128), K 520 (8 past a 64-deep step), N 328 (72 past
    a 256-wide tile).  Band: one bf16 ulp of the larger output plus the
    two f32 sums' order band, 2 sqrt(K) 2^-24 sum |x w| (at K 520 a sum
    that cancels to near zero moves by more than its own ulp), as
    chip_smoke.py holds the card kernel."""
    x, w = _inputs(6, 200, 520, 328, jnp.bfloat16)
    want = jax_streamed(x, w, bk=bk, interpret=True)
    xf = np.array(x.astype(jnp.float32))
    wf = np.array(w.astype(jnp.float32))
    got = tsg.streamed_gemm(torch.from_numpy(xf).to(torch.bfloat16),
                            torch.from_numpy(wf).to(torch.bfloat16), bk=bk)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (200, 328)
    g = got.float().numpy().astype(np.float64)
    wv = np.asarray(want.astype(jnp.float32), np.float64)
    mag = np.maximum(np.abs(g), np.abs(wv))
    ulp = 2.0 ** (np.floor(np.log2(np.where(mag > 0, mag, 1.0))) - 7)
    terms = np.abs(xf).astype(np.float64) @ np.abs(wf).astype(np.float64)
    band = ulp + 2 * np.sqrt(520) * 2.0 ** -24 * terms
    assert (np.abs(g - wv) <= band).all(), float(np.abs(g - wv).max())


@pytest.mark.parametrize("bk", [16, 128, 512])
def test_streamed_gemm_plain_matches_float64(bk):
    """The plain version against the exact product: the tile depth moves
    only the f32 sums' order, |error| <= K * 2^-24 * sum |x w| at most."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(48, 300)).astype(np.float32)
    w = rng.normal(size=(300, 80)).astype(np.float32)
    got = tsg.streamed_gemm_plain(torch.from_numpy(x), torch.from_numpy(w),
                                  bk=bk).numpy()
    exact = x.astype(np.float64) @ w.astype(np.float64)
    bound = 300 * 2.0 ** -24 * (np.abs(x).astype(np.float64)
                                @ np.abs(w).astype(np.float64))
    assert (np.abs(got - exact) <= bound).all()


@pytest.mark.parametrize("case", ["mismatch", "dtype", "inner", "bk", "bt",
                                  "meta"])
def test_streamed_gemm_rejects_what_the_kernel_does_not_take(case):
    x, w = torch.zeros((8, 16)), torch.zeros((16, 8))
    kw = {}
    if case == "mismatch":
        w = w.to(torch.bfloat16)
    elif case == "dtype":
        x, w = x.half(), w.half()
    elif case == "inner":
        w = torch.zeros((15, 8))
    elif case == "bk":
        kw = dict(bk=0)
    elif case == "bt":
        kw = dict(bt=2.5)
    elif case == "meta":
        x, w = x.to("meta"), w.to("meta")
    with pytest.raises(ValueError):
        tsg.streamed_gemm(x, w, **kw)
