"""The port's ImageServer on the CPU, held to the behaviours that
tests/test_serving.py pins for the JAX server: end to end against a direct
call, partial flush, close draining, submit-after-close, the priority
lane, timeout and cancel, and the work-conserving flush."""

import threading
import time

import numpy as np
import pytest
import torch

from vit_fpga_tpu_torch.models import vit
from vit_fpga_tpu_torch.runtime.serving import ImageServer, ServerClosed
from vit_fpga_tpu_torch.utils.log import Metrics


def _tiny_forward():
    cfg = vit.ViTConfig(image_size=32, patch_size=8, hidden_dim=64,
                        depth=2, num_heads=4, mlp_dim=128, num_classes=8,
                        dtype="float32")
    gen = torch.Generator()
    gen.manual_seed(0)
    params = vit.init_params(cfg, gen, device="cpu")
    return cfg, vit.make_forward(cfg, params, raw=True, device="cpu")


def _server(fwd, **kw):
    return ImageServer(fwd, device="cpu", **kw)


def test_server_defaults_to_cuda_and_refuses_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        ImageServer(lambda b: b, image_size=8)


def test_serving_end_to_end_matches_direct():
    _, fwd = _tiny_forward()
    rng = np.random.default_rng(0)
    imgs = [rng.integers(0, 256, (32, 32, 3), np.uint8) for _ in range(10)]
    with _server(fwd, image_size=32, batch_size=4,
                 decode_workers=2) as server:
        futs = [server.submit_raw(im) for im in imgs]
        results = [f.result(timeout=60) for f in futs]
    direct = fwd(np.stack(imgs)).numpy()
    for got, want in zip(results, direct):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert len(results) == 10


def test_serving_jpeg_submit_matches_direct():
    Image = pytest.importorskip("PIL.Image")
    import io
    _, fwd = _tiny_forward()
    img = np.random.default_rng(9).integers(0, 256, (32, 32, 3), np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")   # lossless
    with _server(fwd, image_size=32, batch_size=2) as server:
        got = server.submit(buf.getvalue()).result(timeout=60)
        bad = server.submit(b"not an image")
        with pytest.raises(Exception):
            bad.result(timeout=30)
    np.testing.assert_allclose(got, fwd(img[None]).numpy()[0], rtol=1e-5,
                               atol=1e-5)


def test_serving_partial_batch_flush_and_counters():
    _, fwd = _tiny_forward()
    rng = np.random.default_rng(1)
    with _server(fwd, image_size=32, batch_size=256,
                 flush_ms=10.0) as server:
        fut = server.submit_raw(rng.integers(0, 256, (32, 32, 3), np.uint8))
        out = fut.result(timeout=60)
        assert out.shape == (8,)
        assert server.served == 1 and server.batches == 1


def test_serving_device_failure_isolated():
    calls = {"n": 0}

    def flaky(batch):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("device exploded")
        return torch.zeros((batch.shape[0], 4))

    with _server(flaky, image_size=8, batch_size=1) as server:
        bad = server.submit_raw(np.zeros((8, 8, 3), np.uint8))
        with pytest.raises(RuntimeError):
            bad.result(timeout=30)
        good = server.submit_raw(np.zeros((8, 8, 3), np.uint8))
        assert good.result(timeout=30).shape == (4,)


def test_serving_close_drains_pending():
    _, fwd = _tiny_forward()
    rng = np.random.default_rng(3)
    server = _server(fwd, image_size=32, batch_size=4, flush_ms=50.0)
    futs = [server.submit_raw(rng.integers(0, 256, (32, 32, 3), np.uint8))
            for _ in range(6)]
    server.close()
    for f in futs:
        assert f.done()
        assert f.result(timeout=1).shape == (8,)


def test_serving_submit_after_close_rejected():
    _, fwd = _tiny_forward()
    server = _server(fwd, image_size=32, batch_size=4)
    server.close()
    with pytest.raises(ServerClosed):
        server.submit_raw(np.zeros((32, 32, 3), np.uint8))
    with pytest.raises(ServerClosed):
        server.submit(b"bytes")


def test_serving_latency_percentiles_exported():
    _, fwd = _tiny_forward()
    Metrics.reset()
    with _server(fwd, image_size=32, batch_size=2) as server:
        futs = [server.submit_raw(np.zeros((32, 32, 3), np.uint8))
                for _ in range(4)]
        for f in futs:
            f.result(timeout=60)
        pct = server.latency_percentiles()
    assert "p50" in pct and "p99" in pct and pct["p50"] > 0
    assert any(k.startswith("serving/latency_ms/") for k in Metrics.snapshot())


def test_serving_priority_lane_jumps_queue():
    order = []
    gate = threading.Event()

    def slow_fwd(batch):
        gate.wait(timeout=10)   # hold the first batch until all submitted
        order.append(int(batch[0, 0, 0, 0]))
        return torch.zeros((batch.shape[0], 4))

    with _server(slow_fwd, image_size=8, batch_size=1, flush_ms=1.0) as srv:
        futs = [srv.submit_raw(np.full((8, 8, 3), i, np.uint8))
                for i in (1, 2, 3)]
        hi = srv.submit_raw(np.full((8, 8, 3), 9, np.uint8), priority=True)
        gate.set()
        for f in futs + [hi]:
            f.result(timeout=30)
    assert order.index(9) <= 1, order


def test_serving_queue_timeout_and_cancel():
    gate = threading.Event()

    def gated_fwd(batch):
        gate.wait(timeout=10)
        return torch.zeros((batch.shape[0], 4))

    with _server(gated_fwd, image_size=8, batch_size=1, flush_ms=1.0) as srv:
        blocker = srv.submit_raw(np.zeros((8, 8, 3), np.uint8))
        expired = srv.submit_raw(np.zeros((8, 8, 3), np.uint8),
                                 timeout_ms=1.0)
        cancelled = srv.submit_raw(np.zeros((8, 8, 3), np.uint8))
        assert cancelled.cancel()
        time.sleep(0.05)        # let the deadline lapse while gated
        gate.set()
        assert blocker.result(timeout=30).shape == (4,)
        with pytest.raises(TimeoutError):
            expired.result(timeout=30)
        assert cancelled.cancelled()


def test_serving_work_conserving_flush():
    """A partial batch flushes at flush_ms only while the device pipeline
    is idle; while a batch is in flight it keeps filling."""
    release = threading.Event()
    calls = []

    class Lazy:
        """Unmaterialized device result: in flight until release."""

        def __array__(self, dtype=None, copy=None):
            assert release.wait(10.0), "test device never released"
            return np.zeros((4, 8), np.float32)

    def fwd(batch):
        calls.append(np.asarray(batch).copy())
        return Lazy() if len(calls) == 1 else np.zeros((4, 8), np.float32)

    img = np.full((8, 8, 3), 7, np.uint8)
    server = _server(fwd, image_size=8, batch_size=4, flush_ms=5.0,
                     decode_workers=2)
    try:
        f1 = server.submit_raw(img)
        deadline = time.monotonic() + 5.0
        while len(calls) < 1 and time.monotonic() < deadline:
            time.sleep(0.005)
        assert len(calls) == 1
        f2 = [server.submit_raw(img) for _ in range(3)]
        time.sleep(0.15)   # 30x flush_ms
        assert len(calls) == 1, "partial batch flushed while device busy"
        release.set()
        deadline = time.monotonic() + 5.0
        while len(calls) < 2 and time.monotonic() < deadline:
            time.sleep(0.005)
        assert len(calls) == 2
        filled = int((calls[1] == 7).all(axis=(1, 2, 3)).sum())
        assert filled == 3, f"expected 3 filled rows, got {filled}"
        f1.result(timeout=10)
        for f in f2:
            f.result(timeout=10)
    finally:
        release.set()
        server.close()


def test_serving_rider_deadline_shortens_idle_fill():
    """With the device idle and a long flush window, a rider's shorter
    deadline pulls the flush forward so it is served, not expired."""
    def fwd(batch):
        return np.zeros((4, 8), np.float32)

    img = np.full((8, 8, 3), 7, np.uint8)
    with _server(fwd, image_size=8, batch_size=4, flush_ms=2000.0,
                 decode_workers=2) as server:
        t0 = time.monotonic()
        out = server.submit_raw(img, timeout_ms=300.0).result(timeout=10)
        assert out.shape == (8,)
        assert time.monotonic() - t0 < 1.5, "rider waited the long flush"
