"""The port's per-tensor int8 datapath of the dense network (ops/quant.py
and the dense family of models/quantized.py) against the JAX package's,
bit for bit: the plain version of the Hopper kernel K13 against
int8_gemm_pallas in interpret mode, the quantizer and the int8 linear
against their numpy oracles, and the int8 forward against JAX's
mlp_forward_int8 and the numpy oracle.  Every comparison here is exact:
int8 products summed in int32 are exact, and the float steps are single
IEEE f32 operations in the same order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_fpga_tpu.defines import (ACT_GELU, ACT_IDENTITY, ACT_RELU2,
                                  ACT_SIGMOID, ACT_TANH, random_net)
from vit_fpga_tpu.models import quantized as jq
from vit_fpga_tpu.ops import quant as jquant
from vit_fpga_tpu_torch.models import quantized as tq
from vit_fpga_tpu_torch.models.convert import net_data_from_numpy
from vit_fpga_tpu_torch.ops import quant as tquant


def _int8(rng, *shape):
    return rng.integers(-127, 128, shape).astype(np.int8)


# (m, k, n, fill): the JAX tests' shapes (their ids as they were), then the
# edges of K13's wgmma kernel: M past a 128-row tile (1, 129), N that no TMA
# store takes (1, 3, 10: rows of 4, 12 and 40 bytes), K of 1 (padded to 16),
# 33 and 784 (a partial 128-deep K step), and all -128 operands at K 3072,
# where the int32 sums are largest (128 * 128 * 3072 = 50 331 648).
INT8_GEMM_CASES = [
    pytest.param(24, 784, 10, None, id="24-784-10"),
    pytest.param(1, 784, 256, None, id="1-784-256"),
    pytest.param(17, 256, 10, None, id="17-256-10"),
    pytest.param(1, 1, 1, None, id="1-1-1"),
    pytest.param(5, 33, 7, None, id="5-33-7"),
    pytest.param(129, 784, 256, None, id="129-784-256"),
    pytest.param(129, 33, 1, None, id="129-33-1"),
    pytest.param(129, 1, 3, None, id="129-1-3"),
    pytest.param(3, 784, 10, None, id="3-784-10"),
    pytest.param(9, 3072, 12, -128, id="9-3072-12-all-minus-128"),
]


@pytest.mark.parametrize("m,k,n,fill", INT8_GEMM_CASES)
def test_plain_int8_gemm_equals_pallas_interpret(m, k, n, fill):
    rng = np.random.default_rng(m * 1000 + k + n)
    if fill is None:
        a, b = _int8(rng, m, k), _int8(rng, k, n)
    else:
        a = np.full((m, k), fill, np.int8)
        b = np.full((k, n), fill, np.int8)
    want = np.asarray(jquant.int8_gemm_pallas(jnp.asarray(a), jnp.asarray(b),
                                              interpret=True))
    got = tquant.int8_gemm(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, a.astype(np.int32) @ b.astype(np.int32))


def test_int8_gemm_reads_a_kmajor_weight_view():
    from vit_fpga_tpu_torch.ops.quant_fused import kmajor
    rng = np.random.default_rng(3)
    a, b = _int8(rng, 9, 48), _int8(rng, 48, 20)
    w = kmajor(torch.from_numpy(b))
    assert not w.is_contiguous()
    np.testing.assert_array_equal(
        tquant.int8_gemm(torch.from_numpy(a), w).numpy(),
        a.astype(np.int32) @ b.astype(np.int32))


@pytest.mark.parametrize("case", ["normal", "zeros", "tiny", "halves"])
def test_quantize_torch_equals_quantize_numpy(case):
    rng = np.random.default_rng(5)
    x = {"normal": rng.normal(size=(33, 70)) * 3.0,
         "zeros": np.zeros((4, 9)),
         "tiny": rng.normal(size=(6, 6)) * 1e-14,
         "halves": (np.arange(-254, 255) / 2.0)[None]}[case].astype(np.float32)
    wq, ws = jquant.quantize_numpy(x)
    gq, gs = tquant.quantize_torch(torch.from_numpy(x))
    assert gq.dtype == torch.int8 and gs.dtype == torch.float32
    np.testing.assert_array_equal(gq.numpy(), wq)
    assert np.float32(gs.item()) == ws
    np.testing.assert_array_equal(tquant.quantize_numpy(x)[0], wq)


@pytest.mark.parametrize("with_bias", [True, False])
def test_int8_linear_equals_numpy_oracle(with_bias):
    rng = np.random.default_rng(7)
    x = rng.normal(size=(12, 784)).astype(np.float32)
    w = rng.normal(size=(784, 10)).astype(np.float32) * 0.05
    b = rng.normal(size=(10,)).astype(np.float32) if with_bias else None
    xq, sx = jquant.quantize_numpy(x)
    wq, sw = jquant.quantize_numpy(w)
    want = jquant.int8_linear_numpy(xq, sx, wq, sw, b)
    got = tquant.int8_linear(torch.from_numpy(xq), torch.tensor(sx),
                             torch.from_numpy(wq), torch.tensor(sw),
                             None if b is None else torch.from_numpy(b))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tquant.int8_linear_numpy(xq, sx, wq, sw, b), want)


def test_int8_linear_saturates_a_huge_bias_as_the_oracle():
    """b / s_out past the int32 range clips at +-(2^31 - 1) / -2^31."""
    xq = np.ones((2, 16), np.int8)
    wq = np.ones((16, 3), np.int8)
    sx, sw = np.float32(1e-6), np.float32(1e-6)
    b = np.array([1e3, -1e3, 0.25], np.float32)
    want = jquant.int8_linear_numpy(xq, sx, wq, sw, b)
    got = tquant.int8_linear(torch.from_numpy(xq), torch.tensor(sx),
                             torch.from_numpy(wq), torch.tensor(sw),
                             torch.from_numpy(b))
    np.testing.assert_array_equal(got.numpy(), want)


ACT_SETS = {"relu-identity": [ACT_RELU2, ACT_RELU2, ACT_IDENTITY],
            "tanh-sigmoid": [ACT_TANH, ACT_SIGMOID, ACT_IDENTITY],
            "gelu": [ACT_GELU, ACT_RELU2, ACT_IDENTITY]}


@pytest.mark.parametrize("acts", sorted(ACT_SETS))
def test_mlp_forward_int8_equals_jax_and_oracle(acts):
    data = random_net(24, [48, 16, 4], seed=0, activations=ACT_SETS[acts])
    x = np.random.default_rng(1).normal(size=(8, 24)).astype(np.float32)
    qp_j = jq.quantize_mlp(data)
    want = jq.mlp_forward_int8_numpy(qp_j, x)
    jax_out = np.asarray(jq.mlp_forward_int8(jq.device_qparams(qp_j),
                                             jnp.asarray(x), qp_j["acts"]))
    qp = tq.quantize_mlp(net_data_from_numpy(data))
    for a, b in zip(qp["layers"], qp_j["layers"]):
        np.testing.assert_array_equal(a["wq"], b["wq"])
        assert a["sw"] == b["sw"]
    got = tq.mlp_forward_int8(tq.device_qparams(qp, "cpu"),
                              torch.from_numpy(x), qp["acts"]).numpy()
    np.testing.assert_array_equal(tq.mlp_forward_int8_numpy(qp, x), want)
    if acts == "relu-identity":     # exact float ops end to end
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, jax_out)
    else:
        # tanh, sigmoid and GELU are libm calls that differ in the last
        # ulp between numpy, XLA and PyTorch; a flipped ulp can move the
        # next layer's rint by one quantization step: 2 steps of the
        # layer (s_out * 127 * 2) as the band
        np.testing.assert_allclose(got, want, rtol=0, atol=0.05)


def test_device_qparams_keeps_the_weights_kmajor():
    data = net_data_from_numpy(random_net(20, [12, 3], seed=2))
    dev = tq.device_qparams(tq.quantize_mlp(data), "cpu")
    for layer, w in zip(dev["layers"], data.params):
        assert layer["wq"].shape == w.T.shape
        assert layer["wq"].transpose(0, 1).is_contiguous()
        assert layer["sw"].dim() == 0


def test_int8_gemm_refuses_what_it_does_not_take():
    a = torch.zeros((4, 16), dtype=torch.int8)
    with pytest.raises(ValueError):
        tquant.int8_gemm(a, torch.zeros((8, 4), dtype=torch.int8))
    with pytest.raises(ValueError):
        tquant.int8_gemm(a.float(), torch.zeros((16, 4)))
    with pytest.raises(ValueError):
        tquant.int8_gemm(a.to("meta"), torch.zeros((16, 4), dtype=torch.int8,
                                                   device="meta"))
