"""The port's ``cli serve`` and ``cli calibrate`` with ``device=cpu`` on
tiny models (the plain versions of the kernels): ViT and CLIP, bf16 and
int8 (dynamic and static), a checkpoint written by ``save_params`` (hot,
so the import routes it to the exact softmax, loudly), the raw-image leg
without PIL, and the commands still to come exiting 2 with their ROADMAP
items."""

import importlib.util
import logging

import pytest
import torch

from vit_fpga_tpu_torch import cli
from vit_fpga_tpu_torch.models import vit as tvit
from vit_fpga_tpu_torch.utils.checkpoint import save_params

# Full depth at 32 px: 5 tokens a row.
TINY = ["image=32", "batch=4", "images=10", "device=cpu"]


@pytest.mark.parametrize("extra", [
    ["model=vit_ti16"],
    ["model=vit_ti16", "dtype=int8"],
    ["model=vit_ti16", "dtype=int8", "quant=static"],
    ["model=clip_vit_b16"],
    ["model=clip_vit_b16", "dtype=int8", "quant=static"],
])
def test_serve_on_the_cpu(capsys, extra):
    assert cli.main(["serve"] + TINY + extra) == 0
    out = capsys.readouterr().out
    assert "served 10 images" in out and "3 batches" in out
    assert "jpeg requests" in out


def test_serve_without_pil_serves_raw_images(capsys, monkeypatch):
    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name == "PIL"
                        else real(name, *a))
    assert cli.main(["serve", "model=vit_ti16"] + TINY) == 0
    out = capsys.readouterr().out
    assert "the JPEG leg did not run" in out
    assert "served 10 images" in out and "raw requests" in out


def _hot_ckpt(path):
    cfg = tvit.config("vit_ti16", image_size=32)
    params = tvit.init_params(cfg, device="cpu")
    params["blocks"]["wqkv"] = params["blocks"]["wqkv"] * 60.0
    save_params(path, params)


def test_serve_and_calibrate_a_checkpoint(tmp_path, capsys, caplog):
    path = str(tmp_path / "hot.npz")
    _hot_ckpt(path)
    with caplog.at_level(logging.WARNING):
        assert cli.main(["serve", "model=vit_ti16", f"ckpt={path}"]
                        + TINY) == 0
    assert any("hot attention logits" in r.message for r in caplog.records)
    assert "served 10 images" in capsys.readouterr().out
    assert cli.main(["calibrate", "model=vit_ti16", "image=32",
                     f"ckpt={path}", "device=cpu"]) == 0
    out = capsys.readouterr().out
    assert "softmax mode: safe" in out


def test_calibrate_a_fresh_init(capsys):
    assert cli.main(["calibrate", "model=vit_ti16", "image=32",
                     "device=cpu"]) == 0
    out = capsys.readouterr().out
    assert "score range: [" in out and "softmax mode: maxfree" in out
    per_layer = out.split("per-layer max: ")[1].splitlines()[0]
    assert len(eval(per_layer)) == 12


def test_bench_and_export_name_their_roadmap_items(capsys):
    assert cli.main(["bench"]) == 2
    assert "ROADMAP item 1" in capsys.readouterr().err
    assert cli.main(["export"]) == 2
    assert "ROADMAP item 7" in capsys.readouterr().err


def test_serve_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        cli.main(["serve", "model=vit_ti16", "image=32"])
    with pytest.raises(SystemExit):
        cli.main(["serve", "dtype=float16", "device=cpu"])
