"""The port's training data pipeline (runtime/data.py) against the JAX
package's: the same batches from the same source, ``device_prefetch`` on
the CPU (a plain copy), ``sharding=`` refused, and the loader feeding the
port's Trainer and training step.  The card's path (pinned memory, a side
stream, an event per batch) runs in chip_smoke.py."""

import numpy as np
import pytest
import torch

from vit_fpga_tpu.runtime import data as jdata
from vit_fpga_tpu_torch.models import vit as tvit
from vit_fpga_tpu_torch.runtime.data import (HostLoader, device_prefetch,
                                             synthetic_source)
from vit_fpga_tpu_torch.train import trainer as ttrain


def _sorted(batches):
    """Batches in a worker-order-free form: the (label, image bytes) of
    every row."""
    rows = []
    for imgs, labels in batches:
        rows.extend((int(lb), bytes(np.asarray(im).tobytes()))
                    for im, lb in zip(imgs, labels))
    return sorted(rows)


def test_host_loader_batches_everything():
    src = synthetic_source(37, 8, 10, seed=1)
    loader = HostLoader(src, batch_size=8, workers=3)
    batches = list(loader)
    total = sum(int((lb >= 0).sum()) for _, lb in batches)
    assert total == 37 and len(batches) == 5
    for imgs, labels in batches:
        assert imgs.shape == (8, 8, 8, 3) and imgs.dtype == np.uint8
        assert labels.shape == (8,) and labels.dtype == np.int32
    pad = [lb for _, lb in batches if (lb < 0).any()]
    assert len(pad) == 1 and (pad[0] == -1).sum() == 3
    loader.close()


def test_source_and_loader_match_jax():
    """The same items (seeded) and, up to worker order, the same batches
    as the JAX loader."""
    for (a, la), (b, lb) in zip(synthetic_source(9, 8, 5, seed=4)(),
                                jdata.synthetic_source(9, 8, 5, seed=4)()):
        np.testing.assert_array_equal(a, b)
        assert la == lb
    got = list(HostLoader(synthetic_source(21, 8, 5, seed=4), 4, workers=2))
    want = list(jdata.HostLoader(jdata.synthetic_source(21, 8, 5, seed=4), 4,
                                 workers=2))
    assert _sorted(got) == _sorted(want)


def test_device_prefetch_roundtrip():
    src = synthetic_source(20, 8, 4, seed=2)
    host = list(HostLoader(src, batch_size=4, workers=2))
    dev = list(device_prefetch(iter(host), prefetch=2, device="cpu"))
    assert len(dev) == len(host)
    for (hi, hl), (di, dl) in zip(host, dev):
        assert isinstance(di, torch.Tensor) and di.device.type == "cpu"
        np.testing.assert_array_equal(di.numpy(), hi)
        np.testing.assert_array_equal(dl.numpy(), hl)
        di[0, 0, 0, 0] ^= 1          # a copy: the host batch stays as it was
        assert di.numpy()[0, 0, 0, 0] != hi[0, 0, 0, 0]


@pytest.mark.parametrize("prefetch", [1, 3, 8])
def test_device_prefetch_keeps_order_at_any_depth(prefetch):
    host = [(np.full((2, 3), i, np.int32), np.array([i])) for i in range(5)]
    got = [int(b[1][0]) for b in device_prefetch(host, prefetch=prefetch,
                                                 device="cpu")]
    assert got == list(range(5))
    assert list(device_prefetch([], prefetch=prefetch, device="cpu")) == []


def test_device_prefetch_sharding_raises():
    with pytest.raises(NotImplementedError, match="multi-device"):
        next(device_prefetch([(np.zeros(2), np.zeros(2))], sharding=object(),
                             device="cpu"))


def test_device_prefetch_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        next(device_prefetch([(np.zeros(2), np.zeros(2))]))


TINY = tvit.ViTConfig(image_size=8, patch_size=4, hidden_dim=32, depth=1,
                      num_heads=4, mlp_dim=64, num_classes=4,
                      dtype="float32", attn_impl="xla")


def test_loader_feeds_training_loop():
    """The JAX test's loop: the step on images / 255, labels clipped."""
    params, opt = ttrain.init_train_state(TINY, ttrain.sgd(1e-3),
                                          device="cpu")
    step = ttrain.make_vit_train_step(TINY)
    loader = HostLoader(synthetic_source(24, 8, 4), batch_size=8)
    n = 0
    for imgs, labels in device_prefetch(loader, prefetch=2, device="cpu"):
        x = imgs.float() / 255.0
        params, opt, m = step(params, opt, x, labels.long().clamp_min(0))
        assert np.isfinite(float(m["loss"]))
        n += 1
    assert n == 3


def test_loader_feeds_trainer():
    """Trainer.fit on the pipeline's uint8 batches, normalized by the
    caller as they come out of device_prefetch (the padded rows' label -1
    masked), equals fit on the same batches normalized beforehand, and the
    padded batch's loss counts its valid rows only."""
    batches = list(HostLoader(synthetic_source(20, 8, 4, seed=5),
                              batch_size=8, workers=1))
    assert (batches[-1][1] == -1).sum() == 4
    a = ttrain.Trainer(TINY, device="cpu")
    ha = a.fit((tvit.preprocess(i, TINY), lb) for i, lb in
               device_prefetch(batches, prefetch=2, device="cpu"))
    b = ttrain.Trainer(TINY, device="cpu")
    hb = b.fit((tvit.preprocess(torch.from_numpy(i), TINY),
                torch.from_numpy(lb)) for i, lb in batches)
    assert len(ha) == 3 and ha == hb
    assert all(np.isfinite(h["loss"]) for h in ha)
    # the padded batch: the same loss as its 4 valid rows alone
    imgs, labels = batches[-1]
    params = {k: v for k, v in b.params.items()}
    with torch.no_grad():
        full, _ = ttrain.vit_loss(params, tvit.preprocess(
            torch.from_numpy(imgs), TINY), torch.from_numpy(labels).long(),
            TINY)
        valid, _ = ttrain.vit_loss(params, tvit.preprocess(
            torch.from_numpy(imgs[:4]), TINY),
            torch.from_numpy(labels[:4]).long(), TINY)
    assert float(full) == pytest.approx(float(valid), rel=1e-6)
