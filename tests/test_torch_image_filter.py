"""The port's streaming 3x3 image filter (the plain version of the Hopper
kernel K25) against the JAX package's filter_image_numpy and
filter_image_xla, bit for bit: every product and partial sum of the four
filters is exact in f32, so any order of the taps gives the same bits."""

import numpy as np
import pytest
import torch

from vit_fpga_tpu.ops.image_filter import FILTERS as JAX_FILTERS
from vit_fpga_tpu.ops.image_filter import (filter_image_numpy,
                                           filter_image_xla)
from vit_fpga_tpu_torch.ops import image_filter as tif

NAMES = sorted(JAX_FILTERS)


def _frame(h, w, seed):
    return np.random.default_rng(seed).integers(0, 256, (h, w), np.uint8)


def test_filters_are_the_jax_packages():
    assert sorted(tif.FILTERS) == NAMES
    for name in NAMES:
        np.testing.assert_array_equal(tif.FILTERS[name], JAX_FILTERS[name])


# Widths about K25's 16-byte chunk and 1921, one-row and one-column frames,
# and 1081 rows (a ragged last strip of rows on the card).
SHAPES = [(8, 8), (33, 45), (1080, 1920), (9, 15), (9, 16), (9, 17),
          (12, 1921), (1, 4096), (4096, 1), (1081, 1920)]


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("shape", SHAPES,
                         ids=[f"{h}x{w}" for h, w in SHAPES])
def test_plain_filter_equals_the_jax_filters(name, shape):
    img = _frame(*shape, seed=shape[0] + len(name))
    got = tif.filter_image_device(torch.from_numpy(img), name)
    assert got.dtype == torch.uint8 and tuple(got.shape) == shape
    got = got.numpy()
    np.testing.assert_array_equal(got, filter_image_numpy(img, name))
    np.testing.assert_array_equal(got, np.asarray(filter_image_xla(img,
                                                                   name)))
    np.testing.assert_array_equal(tif.filter_image_numpy(img, name), got)


def test_blur_rounds_half_to_even():
    """A frame whose blurred pixels sit on halves: rint, not round."""
    img = np.zeros((3, 3), np.uint8)
    img[1, 1] = 8                      # 8 * 4/16 = 2.0; neighbours 1.0, 0.5
    img[0, 0] = 40                     # (40 * 4 + 8 * 1) / 16 = 10.5 -> 10
    got = tif.filter_image_device(torch.from_numpy(img), "blur").numpy()
    np.testing.assert_array_equal(got, filter_image_numpy(img, "blur"))
    assert got[0, 0] == 10 and got[2, 2] == 0      # 0.5 -> 0


def test_wrapper_refuses_what_it_does_not_take():
    img = torch.zeros((4, 4), dtype=torch.uint8)
    with pytest.raises(ValueError):
        tif.filter_image_device(img, "emboss")
    with pytest.raises(ValueError):
        tif.filter_image_device(img.float(), "blur")
    with pytest.raises(ValueError):
        tif.filter_image_device(img[None], "blur")
    with pytest.raises(ValueError):
        tif.filter_image_device(img.to("meta"), "blur")
    assert tif.filter_image_device.launches == 0


@pytest.mark.parametrize("name", NAMES)
def test_plain_filter_takes_a_frame_at_an_odd_storage_offset(name):
    """A contiguous frame viewed one byte into its storage (not 16-byte
    aligned, as K25's byte-chunk route takes it on the card)."""
    img = _frame(40, 48, seed=7)
    buf = torch.zeros(40 * 48 + 1, dtype=torch.uint8)
    view = buf[1:].view(40, 48)
    view.copy_(torch.from_numpy(img))
    assert view.storage_offset() == 1 and view.is_contiguous()
    got = tif.filter_image_device(view, name).numpy()
    np.testing.assert_array_equal(got, filter_image_numpy(img, name))
