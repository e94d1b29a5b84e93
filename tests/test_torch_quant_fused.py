"""The port's fused row-wise int8 linear (ops/quant_fused.py, the plain
version of K14) against the JAX package's Pallas kernel in interpret mode,
and its weight quantizer against the JAX one, on the same numpy inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_fpga_tpu.ops import quant_fused as jqf
from vit_fpga_tpu_torch.ops import quant_fused as tqf


def _mk(rng, shape, scale=0.1):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def assert_int8_close(got, want, rounding, step, what=""):
    """The plain version repeats the kernel body op for op in f32; XLA and
    PyTorch may still differ by an f32 ulp (a fused multiply-add in the
    dequantization, the order of the LayerNorm sums).  So every element
    must lie within ``rounding`` (the output type's rounding of such an
    ulp), except where such an ulp moved one activation's ``rint`` by one
    step: there the output may move by one quantization step, ``step``
    (the row's scale times the column's largest weight), and that may
    happen at most once in a thousand elements."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    diff = np.abs(got - want)
    assert np.isfinite(got).all(), what
    assert (diff <= rounding + step).all(), (what, float(diff.max()))
    assert (diff > rounding).mean() <= 1e-3, (what, int((diff > rounding)
                                                       .sum()))


def _step(xf, ws):
    """One quantization step of each output element: sx_r * 127 * ws_n."""
    sx = np.maximum(np.abs(xf).max(-1, keepdims=True), 1e-12) / 127.0
    return sx * 127.0 * ws[None, :]


@pytest.mark.parametrize("shape", [(64, 24), (32, 10), (7, 1000)])
def test_quantize_weight_colwise_same_bits(shape):
    rng = np.random.default_rng(sum(shape))
    w = _mk(rng, shape)
    w[:, 0] = 0.0                       # the 1e-12 absmax floor
    w[1, 1] = 0.5 * (w[2, 1] + w[1, 1])
    wq, ws = tqf.quantize_weight_colwise(w)
    jq, js = jqf.quantize_weight_colwise(w)
    assert wq.dtype == np.int8 and ws.dtype == np.float32
    np.testing.assert_array_equal(wq, jq)
    np.testing.assert_array_equal(ws, js)
    assert np.abs(wq.astype(np.int32)).max() <= 127


def _linear_case(seed, t=40, k=64, n=10):
    """T = 40 rows against block_t 16 on the JAX side (a ragged tile), N
    = 10 columns (a head's ragged N)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(t, k)).astype(np.float32)
    wq, ws = jqf.quantize_weight_colwise(_mk(rng, (k, n)))
    b = _mk(rng, (n,), 0.5)
    ls = _mk(rng, (k,)) + 1.0
    lb = _mk(rng, (k,))
    return x, wq, ws, b, ls, lb


def _run_both(x_np, x_dtype, wq, ws, b, ls, lb, act, ln_eps, out_dtype):
    jdt = {torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32}
    xj = jnp.asarray(x_np, jdt[x_dtype])
    want = jqf.int8_linear_fused(
        xj, jnp.asarray(wq), jnp.asarray(ws), jnp.asarray(b), act=act,
        ln_scale=jnp.asarray(ls), ln_bias=jnp.asarray(lb), ln_eps=ln_eps,
        block_t=16, out_dtype=jdt[out_dtype], interpret=True)
    xt = torch.from_numpy(np.asarray(xj.astype(jnp.float32))).to(x_dtype)
    got = tqf.int8_linear_fused(
        xt, torch.from_numpy(wq), torch.from_numpy(ws), torch.from_numpy(b),
        act=act, ln_scale=torch.from_numpy(ls), ln_bias=torch.from_numpy(lb),
        ln_eps=ln_eps, out_dtype=out_dtype)
    assert got.dtype == out_dtype and got.shape == tuple(want.shape)
    # the activations as quantized (after the LN), for the step band
    xf = xt.float()
    if ln_eps > 0:
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, unbiased=False, keepdim=True)
        xf = (xf - mu) * torch.rsqrt(var + ln_eps) * torch.from_numpy(ls) \
            + torch.from_numpy(lb)
    return got.float().numpy(), np.asarray(want.astype(jnp.float32)), \
        xf.numpy()


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("ln_eps", [0.0, 1e-6])
@pytest.mark.parametrize("act", ["none", "gelu_tanh", "quick_gelu", "relu"])
def test_int8_linear_fused_matches_pallas(act, ln_eps, out_dtype):
    x, wq, ws, b, ls, lb = _linear_case(1)
    got, want, xf = _run_both(x, torch.bfloat16, wq, ws, b, ls, lb, act,
                              ln_eps, out_dtype)
    # rounding: one bf16 ulp (2^-8 relative) of the output, or four f32
    # ulps of the output's largest magnitude for f32 output
    rounding = (2.0 ** -8 * np.abs(want) if out_dtype == torch.bfloat16
                else 2.0 ** -21 * np.abs(want).max())
    assert_int8_close(got, want, rounding, _step(xf, ws), act)


@pytest.mark.parametrize("ln_eps", [0.0, 1e-6])
def test_int8_linear_fused_f32_input_matches_pallas(ln_eps):
    x, wq, ws, b, ls, lb = _linear_case(2, t=33)
    got, want, xf = _run_both(x, torch.float32, wq, ws, b, ls, lb,
                              "gelu_tanh", ln_eps, torch.float32)
    assert_int8_close(got, want, 2.0 ** -21 * np.abs(want).max(),
                      _step(xf, ws), "f32 input")


def test_int8_linear_fused_textbook_gelu_is_not_the_fma_form():
    """K14's tanh-GELU is jax.nn.gelu's textbook form; the int8 blocks
    take the fma form.  Both agree to f32 rounding, and the port keeps
    each where its TPU kernel has it."""
    h = torch.linspace(-6, 6, 2001)
    from vit_fpga_tpu_torch.ops.quant_block import _apply_act
    textbook = tqf._gelu_tanh_textbook(h)
    np.testing.assert_allclose(
        textbook.numpy(),
        np.asarray(jax.nn.gelu(jnp.asarray(h.numpy()), approximate=True)),
        rtol=2e-6, atol=2e-6)
    np.testing.assert_allclose(textbook.numpy(),
                               _apply_act(h, "gelu_tanh").numpy(),
                               rtol=1e-5, atol=1e-5)


def test_int8_linear_fused_cpu_runs_plain_and_checks_act():
    x, wq, ws, b, _, _ = _linear_case(3, t=4)
    before = tqf.int8_linear_fused.launches
    out = tqf.int8_linear_fused(torch.from_numpy(x), torch.from_numpy(wq),
                                torch.from_numpy(ws), torch.from_numpy(b))
    assert out.dtype == torch.bfloat16 and out.shape == (4, 10)
    assert tqf.int8_linear_fused.launches == before   # no kernel on the CPU
    with pytest.raises(ValueError):
        tqf.int8_linear_fused(torch.from_numpy(x), torch.from_numpy(wq),
                              torch.from_numpy(ws), torch.from_numpy(b),
                              act="gelu")


def test_row_quant_rounds_half_to_even_and_never_reaches_minus_128():
    xf = torch.tensor([[127.0, -127.0, 0.5, 1.5, 2.5, -0.5, -1.5, 3.0]])
    xq, sx = tqf._row_quant(xf)
    assert float(sx) == 1.0
    assert xq.tolist() == [[127, -127, 0, 2, 2, 0, -2, 3]]
    xq, _ = tqf._row_quant(torch.zeros((2, 8)))           # 1e-12 floor
    assert int(xq.abs().max()) == 0


def test_row_quant_divides_as_numpy_on_rows_where_the_reciprocal_differs():
    """_row_quant's s = absmax / 127 and its int8 rows equal numpy's true
    division bit for bit, on seeded rows chosen so that some absmax * (1 /
    127) is an ulp away from absmax / 127 (the kernels divide truly)."""
    rng = np.random.default_rng(26)
    x = (rng.standard_normal((512, 64))
         * np.exp2(rng.uniform(-20, 20, (512, 1)))).astype(np.float32)
    absmax = np.maximum(np.abs(x).max(-1, keepdims=True), np.float32(1e-12))
    s = (absmax / np.float32(127.0)).astype(np.float32)
    assert (absmax * np.float32(1.0 / 127.0) != s).any()
    want = np.clip(np.rint(x / s), -127, 127).astype(np.int8)
    xq, sx = tqf._row_quant(torch.from_numpy(x))
    assert sx.dtype == torch.float32
    np.testing.assert_array_equal(sx.numpy(), s)
    np.testing.assert_array_equal(xq.numpy(), want)
