"""The port's dense model family (models/mlp.py, plain torch) against the
JAX package's models/mlp.py on the CPU: the NetData round trip, the
params tree, the forward per activation in f32 (1e-5) and bf16 (the bf16
band, 2e-2 of the largest output), and the seeded init."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_fpga_tpu.models import mlp as jmlp
from vit_fpga_tpu_torch.defines import (ACT_GELU, ACT_IDENTITY, ACT_RELU2,
                                        ACT_SIGMOID, ACT_TANH, random_net)
from vit_fpga_tpu_torch.models import mlp as tmlp
from vit_fpga_tpu_torch.models.convert import net_data_from_numpy

ACTS = [ACT_RELU2, ACT_GELU, ACT_TANH, ACT_SIGMOID, ACT_IDENTITY]


def test_net_data_round_trip_and_tree_match_jax():
    data = random_net(12, [9, 7, 3], seed=1)
    tp, tacts = tmlp.from_net_data(data, device="cpu")
    jp, jacts = jmlp.from_net_data(data)
    assert tacts == jacts
    for tl, jl in zip(tp["layers"], jp["layers"]):
        for k in ("w", "b"):
            assert tl[k].dtype == torch.float32
            np.testing.assert_array_equal(tl[k].numpy(), np.asarray(jl[k]))
    back = tmlp.to_net_data(tp, 12, tacts)
    for a, b in zip(back.params, data.params):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(back.bias, data.bias):
        np.testing.assert_array_equal(a, b)
    assert back.activations == list(data.activations)
    assert net_data_from_numpy(jmlp.to_net_data(jp, 12, jacts)).n_p_l == \
        back.n_p_l


@pytest.mark.parametrize("code", ACTS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_jax(code, dtype):
    params, acts = tmlp.random_model(16, [32, 24, 5], seed=3,
                                     activations=[code, code, ACT_IDENTITY],
                                     device="cpu")
    jp, jacts = jmlp.random_model(16, [32, 24, 5], seed=3,
                                  activations=[code, code, ACT_IDENTITY])
    assert acts == jacts
    x = np.random.default_rng(4).normal(size=(6, 16)).astype(np.float32)
    tdt, jdt = ((torch.float32, jnp.float32) if dtype == "float32"
                else (torch.bfloat16, jnp.bfloat16))
    got = tmlp.forward(params, torch.from_numpy(x), acts=acts,
                       compute_dtype=tdt)
    want = np.asarray(jmlp.forward(jp, jnp.asarray(x), acts=jacts,
                                   compute_dtype=jdt))
    assert got.dtype == torch.float32 and got.shape == (6, 5)
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1.0))


def test_init_params_from_a_generator():
    gen = torch.Generator()
    gen.manual_seed(5)
    p = tmlp.init_params(gen, 10, [8, 4], scale=0.5, device="cpu")
    assert [tuple(l["w"].shape) for l in p["layers"]] == [(10, 8), (8, 4)]
    assert [tuple(l["b"].shape) for l in p["layers"]] == [(8,), (4,)]
    for layer in p["layers"]:
        for v in layer.values():
            assert v.dtype == torch.float32
            assert float(v.abs().max()) <= 0.5 and float(v.std()) > 0.05
    gen.manual_seed(5)
    again = tmlp.init_params(gen, 10, [8, 4], scale=0.5, device="cpu")
    for a, b in zip(p["layers"], again["layers"]):
        assert torch.equal(a["w"], b["w"]) and torch.equal(a["b"], b["b"])
    # same shapes and range as the JAX init
    jp = jmlp.init_params(jax.random.key(5), 10, [8, 4], scale=0.5)
    assert [tuple(np.shape(l["w"])) for l in jp["layers"]] == [(10, 8),
                                                               (8, 4)]


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        tmlp.random_model(4, [2])
