"""The port's dense NetAbstract backend, NetCUDA on the CPU
(device="cpu": plain PyTorch for every op, the plain K25 filter and the
plain K13 GEMM), against the JAX package's NetTPU and the NumPy oracle
NetCPU, on the same networks (carried over with
convert.net_data_from_numpy).  The cases mirror tests/test_tpu_backend.py,
tests/test_tpu_int8_mode.py and tests/test_pipeline.py, and add the
ring's counters, ParamStore residency, the native bridge and the CLI.

Tolerances: f32 forwards rtol 1e-4 / atol 1e-5 (f32 sums in another
order); training rtol 2e-3 / atol 1e-5 on the losses, 2e-3 / 1e-4 on the
trained forward (25 steps carry those sums' rounding); bf16 forwards
against each other within 2^-6 relative of the largest output (a few bf16
ulps over two layers); the int8 datapath and the filter bit for bit."""

import warnings

import numpy as np
import pytest
import torch

from vit_fpga_tpu import native_bridge as jbridge
from vit_fpga_tpu.backends.cpu import NetCPU as JaxNetCPU
from vit_fpga_tpu.backends.tpu import NetTPU
from vit_fpga_tpu.defines import ImageSet as JaxImageSet
from vit_fpga_tpu.defines import NetSets as JaxNetSets
from vit_fpga_tpu.defines import flatten_net, random_net
from vit_fpga_tpu.ops.image_filter import filter_image_numpy
from vit_fpga_tpu_torch import cli, native_bridge
from vit_fpga_tpu_torch.backends.cpu import NetCPU
from vit_fpga_tpu_torch.backends.cuda import NetCUDA
from vit_fpga_tpu_torch.defines import (ACT_GELU, ACT_IDENTITY, ACT_RELU2,
                                        ImageSet, NetSets)
from vit_fpga_tpu_torch.models import quantized
from vit_fpga_tpu_torch.models.convert import net_data_from_numpy
from vit_fpga_tpu_torch.runtime import perf
from vit_fpga_tpu_torch.runtime.engine import Engine, ParamStore

CPU = "cpu"


def _nets(*args, **kw):
    """(JAX NetData, the port's NetData) of one random network."""
    jdata = random_net(*args, **kw)
    return jdata, net_data_from_numpy(jdata)


def _sets(rng, n, n_in, n_out):
    return (rng.normal(size=(n, n_in)).astype(np.float32),
            rng.normal(size=(n, n_out)).astype(np.float32))


def test_forward_f32_matches_nettpu_and_oracle():
    jdata, data = _nets(64, [128, 32, 10], seed=11)
    x = np.random.default_rng(0).normal(size=(8, 64)).astype(np.float32)
    got = NetCUDA(data, device=CPU).forward_batch(x)
    assert got.dtype == np.float32 and got.shape == (8, 10)
    np.testing.assert_allclose(got, NetTPU(jdata).forward_batch(x),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got, NetCPU(data).forward_batch(x),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(NetCPU(data).forward_batch(x),
                                  JaxNetCPU(jdata).forward_batch(x))


def test_forward_bf16_matches_nettpu_bf16():
    jdata, data = _nets(32, [64, 8], seed=4,
                        activations=[ACT_GELU, ACT_IDENTITY])
    x = np.random.default_rng(5).normal(size=(4, 32)).astype(np.float32)
    got = NetCUDA(data, compute_dtype="bfloat16", device=CPU).forward_batch(x)
    want = NetTPU(jdata, compute_dtype="bfloat16").forward_batch(x)
    assert got.dtype == np.float32
    band = 2.0 ** -6 * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=band)
    f32 = NetCUDA(data, device=CPU).forward_batch(x)
    np.testing.assert_allclose(got, f32, rtol=0.1, atol=0.5)


def test_int8_forward_is_the_oracle_bit_for_bit():
    jdata, data = _nets(24, [48, 16, 4], seed=0,
                        activations=[ACT_RELU2, ACT_RELU2, ACT_IDENTITY])
    x = np.random.default_rng(1).normal(size=(8, 24)).astype(np.float32)
    out = NetCUDA(data, compute_dtype="int8", device=CPU).forward_batch(x)
    ref = quantized.mlp_forward_int8_numpy(quantized.quantize_mlp(data), x)
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(
        out, NetTPU(jdata, compute_dtype="int8").forward_batch(x))


def test_rejects_unknown_dtype_and_filter():
    _, data = _nets(4, [2], seed=0)
    with pytest.raises(ValueError):
        NetCUDA(data, compute_dtype="fp8", device=CPU)
    with pytest.raises(ValueError):
        NetCUDA(data, image_filter="emboss", device=CPU)


def test_training_matches_nettpu_and_oracle():
    jdata, data = _nets(6, [12, 3], seed=7,
                        activations=[ACT_RELU2, ACT_IDENTITY])
    rng = np.random.default_rng(1)
    X, Y = _sets(rng, 64, 6, 3)
    cuda, cpu, tpu = NetCUDA(data, device=CPU), NetCPU(data), NetTPU(jdata)
    cuda.init_gradient(NetSets(X, Y))
    cpu.init_gradient(NetSets(X, Y))
    tpu.init_gradient(JaxNetSets(X, Y))
    e_cuda = cuda.launch_gradient(25, 1e-9, 0.02)
    e_cpu = cpu.launch_gradient(25, 1e-9, 0.02)
    e_tpu = tpu.launch_gradient(25, 1e-9, 0.02)
    assert e_cuda.dtype == np.float32 and e_cuda.shape == (25,)
    assert e_cuda[-1] < e_cuda[0]
    np.testing.assert_allclose(e_cuda, e_cpu, rtol=2e-3, atol=1e-5)
    np.testing.assert_allclose(e_cuda, e_tpu, rtol=2e-3, atol=1e-5)
    x = rng.normal(size=(4, 6)).astype(np.float32)
    np.testing.assert_allclose(cuda.forward_batch(x), cpu.forward_batch(x),
                               rtol=2e-3, atol=1e-4)
    for a, b in zip(cuda.get_net_data().params, cpu.get_net_data().params):
        np.testing.assert_allclose(a, b, rtol=2e-3, atol=1e-4)
    assert cuda.get_gradient_performance() > 0


def test_launch_gradient_needs_a_training_set():
    _, data = _nets(3, [2], seed=0)
    with pytest.raises(RuntimeError):
        NetCUDA(data, device=CPU).launch_gradient(2, 0.0, 0.1)


def test_training_early_stop_pads_zeros_and_freezes():
    _, data = _nets(3, [4, 1], seed=5, activations=[ACT_RELU2, ACT_IDENTITY])
    rng = np.random.default_rng(2)
    X = rng.normal(size=(16, 3)).astype(np.float32)
    Y = NetCPU(data).forward_batch(X)    # zero-loss target: stop at once
    net = NetCUDA(data, device=CPU)
    net.init_gradient(NetSets(X, Y))
    errs = net.launch_gradient(10, error_threshold=1e-3, multiplier=0.01)
    assert errs.shape == (10,)
    assert errs[0] < 1e-3 and np.all(errs[1:] == 0.0)
    # the triggering step still updates (zero gradient here); later ones
    # are frozen: the weights are the initial ones
    for a, b in zip(net.get_net_data().params, data.params):
        np.testing.assert_array_equal(a, b)


def test_get_net_data_round_trips_and_int8_requantizes_after_training():
    _, data = _nets(8, [16, 2], seed=4, activations=[ACT_RELU2, ACT_IDENTITY])
    net = NetCUDA(data, compute_dtype="int8", device=CPU)
    x = np.ones((4, 8), np.float32)
    before = net.forward_batch(x)
    rng = np.random.default_rng(5)
    net.init_gradient(NetSets(*_sets(rng, 32, 8, 2)))
    net.launch_gradient(10, 1e-9, 0.05)
    after = net.forward_batch(x)
    assert not np.allclose(before, after), "int8 must see trained weights"
    trained = net.get_net_data()
    ref = quantized.mlp_forward_int8_numpy(quantized.quantize_mlp(trained), x)
    np.testing.assert_array_equal(after, ref)
    clone = NetCUDA(trained, compute_dtype="int8", device=CPU)
    np.testing.assert_array_equal(clone.forward_batch(x), after)
    # f32: the trained device copy and its export give the same bits
    net32 = NetCUDA(data, device=CPU)
    net32.init_gradient(NetSets(*_sets(np.random.default_rng(5), 32, 8, 2)))
    net32.launch_gradient(10, 1e-9, 0.05)
    exported = net32.get_net_data()
    assert exported.n_p_l == [16, 2]
    np.testing.assert_array_equal(
        NetCUDA(exported, device=CPU).forward_batch(x),
        net32.forward_batch(x))


def test_perf_counters_and_disabled_counters_read_zero(monkeypatch):
    _, data = _nets(16, [8], seed=1)
    net = NetCUDA(data, device=CPU)
    out = net.launch_forward(np.ones(16, np.float32))
    assert out.shape == (8,)
    assert net.get_forward_performance() > 0
    monkeypatch.setattr(perf, "PERFORMANCE_COUNTERS", False)
    net2 = NetCUDA(data, device=CPU)
    net2.launch_forward(np.ones(16, np.float32))
    net2.init_gradient(NetSets(np.ones((4, 16), np.float32),
                               np.zeros((4, 8), np.float32)))
    net2.launch_gradient(2, 0.0, 0.01)
    assert net2.get_forward_performance() == 0
    assert net2.get_gradient_performance() == 0


def test_device_trace_writes_a_chrome_trace(tmp_path):
    _, data = _nets(16, [8], seed=1)
    net = NetCUDA(data, device=CPU)
    with perf.device_trace(str(tmp_path / "trace")):
        net.forward_batch(np.ones((2, 16), np.float32))
    text = (tmp_path / "trace" / "trace.json").read_text()
    assert "traceEvents" in text and "aten::" in text


def test_param_store_restages_only_on_a_version_bump():
    store, calls = ParamStore(), []

    def stage():
        calls.append(1)
        return len(calls)

    assert store.get("k", 0, stage) == 1
    assert store.get("k", 0, stage) == 1          # resident: no restage
    assert store.get("k", 1, stage) == 2          # newer version: restage
    assert len(calls) == 2 and len(store) == 1
    store.evict("k")
    assert len(store) == 0

    _, data = _nets(4, [4, 2], seed=3, activations=[ACT_RELU2, ACT_IDENTITY])
    net = NetCUDA(data, device=CPU)
    first = net._params_on_device()
    assert net._params_on_device() is first
    net.init_gradient(NetSets(*_sets(np.random.default_rng(0), 8, 4, 2)))
    net.launch_gradient(3, 1e-9, 0.05)
    assert net._version == 1 and net._params_on_device() is not first


def test_cleanup_drops_the_session_and_its_resident_params():
    _, data = _nets(12, [6, 3], seed=2)
    net = NetCUDA(data, device=CPU)
    x = np.zeros((1, 12), np.float32)
    want = net.forward_batch(x)
    eng = Engine.get()
    assert eng is net._engine and len(eng.params) >= 1
    Engine.cleanup()
    fresh = Engine.get()
    assert fresh is not eng and len(fresh.params) == 0
    # a new backend stages into the new session and computes the same
    np.testing.assert_array_equal(NetCUDA(data, device=CPU).forward_batch(x),
                                  want)
    assert len(fresh.params) == 1


# -- the streaming ring -------------------------------------------------------

def _ring_net(depth=4, name="identity"):
    _, data = _nets(4, [2], seed=0)
    return NetCUDA(data, ring_depth=depth, image_filter=name, device=CPU)


def test_ring_overflow_drops(capsys):
    net = _ring_net(depth=2)
    img = np.zeros((8, 8), np.uint8)
    for i in range(3):
        net.filter_image(ImageSet(img, original_h=8, original_w=8,
                                  original_x_pos=i))
    assert "ring full" in capsys.readouterr().out
    assert net._ring.dropped == 1 and net._ring.submitted == 2
    assert net._ring.free == 0


def test_ring_underflow_returns_empty(capsys):
    net = _ring_net()
    out = net.get_filtered_image()
    assert out.empty and out.original_h == 0
    assert "ring empty" in capsys.readouterr().out


@pytest.mark.parametrize("name", ["sharpen", "blur", "edge", "identity"])
def test_fifo_order_metadata_and_filter(name):
    net = _ring_net(depth=8, name=name)
    rng = np.random.default_rng(0)
    frames = [rng.integers(0, 256, (33, 45), np.uint8) for _ in range(5)]
    for i, f in enumerate(frames):
        net.filter_image(ImageSet(f, original_h=33, original_w=45,
                                  original_x_pos=i, original_y_pos=10 * i))
    assert len(net._ring) == 5 and net._ring.free == 3
    for i, f in enumerate(frames):
        got = net.get_filtered_image()
        assert got.original_x_pos == i and got.original_y_pos == 10 * i
        assert (got.original_h, got.original_w) == (33, 45)
        np.testing.assert_array_equal(
            got.resized_image_data.reshape(33, 45),
            filter_image_numpy(f, name))
    assert net._ring.retrieved == 5 and len(net._ring) == 0


def test_ring_counters_and_drain(capsys):
    net = _ring_net(depth=2)
    ring = net._ring
    assert ring.free == 2
    img = np.arange(16, dtype=np.uint8).reshape(4, 4)
    assert ring.try_submit(img, "a") and ring.try_submit(img, "b")
    assert not ring.try_submit(img, "c")
    assert ring.dropped == 1 and ring.submitted == 2
    got = ring.try_retrieve()
    assert got[1] == "a"
    np.testing.assert_array_equal(got[0], img)
    ring.drain()
    assert len(ring) == 0 and ring.try_retrieve() is None
    assert ring.retrieved == 1 and ring.free == 2
    with pytest.raises(ValueError):
        ring.try_submit(np.zeros((2, 2, 2), np.uint8), "d")
    capsys.readouterr()


def test_ring_takes_a_read_only_frame_and_keeps_returned_frames():
    ring = _ring_net(depth=2, name="edge")._ring
    rng = np.random.default_rng(3)
    frames = [rng.integers(0, 256, (6, 7), np.uint8) for _ in range(3)]
    with warnings.catch_warnings():
        warnings.simplefilter("error")      # no non-writable-array warning
        assert ring.try_submit(np.frombuffer(frames[0].tobytes(), np.uint8)
                               .reshape(6, 7), 0)
    first, _ = ring.try_retrieve()
    for i in (1, 2):                         # later frames reuse nothing of it
        assert ring.try_submit(frames[i], i)
    np.testing.assert_array_equal(first, filter_image_numpy(frames[0], "edge"))
    for i in (1, 2):
        got, meta = ring.try_retrieve()
        assert meta == i
        np.testing.assert_array_equal(got, filter_image_numpy(frames[i],
                                                              "edge"))


def test_ring_matches_the_jax_backend_and_the_oracle():
    jdata, data = _nets(4, [2], seed=0)
    rng = np.random.default_rng(9)
    port = NetCUDA(data, ring_depth=3, image_filter="blur", device=CPU)
    ref = NetCPU(data, ring_depth=3, image_filter="blur")
    tpu = NetTPU(jdata, ring_depth=3, image_filter="blur",
                 use_pallas_filter=False)
    for i in range(4):                    # the 4th is dropped by all three
        f = rng.integers(0, 256, (17, 23), np.uint8)
        port.filter_image(ImageSet(f, original_h=17, original_w=23,
                                   original_x_pos=i))
        ref.filter_image(ImageSet(f, original_h=17, original_w=23,
                                  original_x_pos=i))
        tpu.filter_image(JaxImageSet(f, original_h=17, original_w=23,
                                     original_x_pos=i))
    for _ in range(4):
        a, b, c = (port.get_filtered_image(), ref.get_filtered_image(),
                   tpu.get_filtered_image())
        assert a.empty == b.empty == c.empty
        assert a.original_x_pos == b.original_x_pos == c.original_x_pos
        np.testing.assert_array_equal(a.resized_image_data,
                                      b.resized_image_data)
        np.testing.assert_array_equal(a.resized_image_data,
                                      c.resized_image_data)


# -- native bridge, CLI, device default ---------------------------------------

def test_native_bridge_matches_the_jax_bridge():
    n_ins, npl = 10, np.array([6, 3], np.int32)
    acts = np.array([ACT_RELU2, ACT_IDENTITY], np.int32)
    jdata = random_net(n_ins, npl.tolist(), seed=3,
                       activations=acts.tolist())
    params, bias, _ = flatten_net(jdata)
    args = (n_ins, npl.tobytes(), params.tobytes(), bias.tobytes(),
            acts.tobytes(), 0, 0, 2, "edge")
    h, jh = native_bridge.create(*args, device=CPU), jbridge.create(*args)
    try:
        assert native_bridge.n_outs(h) == jbridge.n_outs(jh) == 3
        x = np.random.default_rng(4).normal(size=(n_ins,)).astype(np.float32)
        got = np.frombuffer(native_bridge.forward(h, x.tobytes()), np.float32)
        want = np.frombuffer(jbridge.forward(jh, x.tobytes()), np.float32)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
        p, b = native_bridge.get_net_data(h)
        assert p == params.tobytes() and b == bias.tobytes()
        img = np.random.default_rng(5).integers(0, 256, (9, 14), np.uint8)
        for x_pos in range(3):
            assert native_bridge.filter_image(h, img.tobytes(), 9, 14,
                                              x_pos, 7) == (x_pos == 2)
            assert jbridge.filter_image(jh, img.tobytes(), 9, 14,
                                        x_pos, 7) == (x_pos == 2)
        for _ in range(3):
            assert (native_bridge.get_filtered_image(h)
                    == jbridge.get_filtered_image(jh))
        X = np.ones((4, n_ins), np.float32)
        Y = np.zeros((4, 3), np.float32)
        native_bridge.init_gradient(h, X.tobytes(), Y.tobytes(), 4, 3)
        errs = np.frombuffer(native_bridge.launch_gradient(h, 3, 0.0, 0.01),
                             np.float32)
        assert errs.shape == (3,) and errs[0] > 0
        assert native_bridge.forward_perf(h) > 0
        assert native_bridge.gradient_perf(h) > 0
    finally:
        native_bridge.destroy(h)
        jbridge.destroy(jh)
    with pytest.raises(KeyError):
        native_bridge.forward(h, b"")


def test_cli_demo_and_parity_on_the_cpu(capsys):
    assert cli.main(["demo", "device=cpu", "n_ins=16"]) == 0
    out = capsys.readouterr().out
    assert "pipeline: 4/4 frames, FIFO=[0, 1, 2, 3]" in out
    assert cli.main(["parity", "device=cpu", "n_ins=16"]) == 0
    out = capsys.readouterr().out
    assert "int8 device vs int8 oracle: bit-exact=True" in out
    rel = float(out.split("f32 device vs oracle: max rel err ")[1].split()[0])
    assert rel < 1e-5
    assert cli.main(["export"]) == 2
    assert "ROADMAP item 7" in capsys.readouterr().err
    assert cli.main([]) == 2


def test_cuda_default_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, data = _nets(4, [2], seed=0)
    with pytest.raises(RuntimeError):
        NetCUDA(data)
    with pytest.raises(RuntimeError):
        cli.main(["parity"])
