"""The port's checkpoints (utils/checkpoint.py) and HuggingFace importers
(ViT, DeiT, CLIP vision and text) against the JAX package's.

* ``.npz`` params cross both ways between the packages (f32, int8 and
  int32 leaves), bit for bit.
* The importers return the JAX importers' numpy trees, array for array
  (the same dtype, shape and bits), on seeded tiny ``transformers``
  models built here.
* The port's f32 CPU forward of an imported ViT agrees with HF's logits
  to f32 rounding (2e-4 of the largest logit).
* A resumed ``Trainer`` continues identically: the loss to rtol 1e-6 (the
  JAX test's), the params bit for bit on the CPU."""

import logging

import jax
import numpy as np
import pytest
import torch

from vit_fpga_tpu.models import clip as jclip
from vit_fpga_tpu.models import deit as jdeit
from vit_fpga_tpu.models import vit as jvit
from vit_fpga_tpu.utils import checkpoint as jck
from vit_fpga_tpu_torch.models import clip as tclip
from vit_fpga_tpu_torch.models import deit as tdeit
from vit_fpga_tpu_torch.models import vit as tvit
from vit_fpga_tpu_torch.models.convert import params_from_numpy
from vit_fpga_tpu_torch.train import trainer as ttrain
from vit_fpga_tpu_torch.utils import checkpoint as tck

transformers = pytest.importorskip("transformers")

TINY_HF = dict(image_size=32, patch_size=8, hidden_size=64,
               num_hidden_layers=2, num_attention_heads=4,
               intermediate_size=128)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _same_tree(got, want):
    g, w = _flat(got), _flat(want)
    assert g.keys() == w.keys()
    for k in w:
        a, b = np.asarray(g[k]), np.asarray(w[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)


def _mixed_tree():
    rng = np.random.default_rng(0)
    return {"blocks": {"w": rng.normal(size=(2, 3, 4)).astype(np.float32),
                       "wq": rng.integers(-127, 128, (2, 4, 4), np.int8)},
            "count": np.int32(7),
            "idx": rng.integers(0, 1 << 20, (5,), np.int32),
            "ln": rng.normal(size=(4,)).astype(np.float32)}


def test_npz_round_trip_both_ways(tmp_path):
    tree = _mixed_tree()
    for save, load in ((tck.save_params, jck.load_params),
                       (jck.save_params, tck.load_params),
                       (tck.save_params, tck.load_params)):
        path = str(tmp_path / "p.npz")
        save(path, tree)
        _same_tree(load(path), tree)
    # tensors go out as numpy; the file leaves no temporary behind
    path = str(tmp_path / "t.npz")
    tck.save_params(path, params_from_numpy({"blocks": tree["blocks"]},
                                            device="cpu"))
    got = jck.load_params(path)
    np.testing.assert_array_equal(got["blocks"]["wq"], tree["blocks"]["wq"])
    np.testing.assert_array_equal(got["blocks"]["w"], tree["blocks"]["w"])
    assert sorted(p.name for p in tmp_path.iterdir()) == ["p.npz", "t.npz"]


def test_vit_params_cross_and_serve(tmp_path):
    """A JAX-written ViT checkpoint serves on the port's CPU forward with
    the JAX forward's logits (f32, 1e-4)."""
    kw = dict(image_size=32, patch_size=8, hidden_dim=64, depth=2,
              num_heads=4, mlp_dim=128, num_classes=6, dtype="float32")
    params = jax.tree_util.tree_map(
        np.asarray, jvit.init_params(jax.random.key(3), jvit.ViTConfig(**kw)))
    path = str(tmp_path / "vit.npz")
    jck.save_params(path, params)
    tp = params_from_numpy(tck.load_params(path), device="cpu")
    x = np.random.default_rng(4).normal(size=(2, 32, 32, 3)).astype(
        np.float32)
    want = np.asarray(jvit.jit_forward(jvit.ViTConfig(**kw))(params, x))
    got = tvit.make_forward(tvit.ViTConfig(**kw), tp, raw=False,
                            device="cpu")(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def _hf_vit(num_labels=6, hot=False, act="gelu"):
    hf_cfg = transformers.ViTConfig(**TINY_HF, num_labels=num_labels,
                                    hidden_act=act)
    torch.manual_seed(0)
    model = transformers.ViTForImageClassification(hf_cfg).eval()
    if hot:
        # inflate q and k so the scores leave the [-70, 80] window
        with torch.no_grad():
            for blk in model.vit.encoder.layer:
                blk.attention.attention.query.weight *= 40.0
                blk.attention.attention.key.weight *= 40.0
    return model


@pytest.mark.parametrize("num_labels", [6, 0])
def test_hf_vit_importer_equals_jax(num_labels):
    model = _hf_vit(num_labels)
    got = tck.from_hf_vit_model(model)
    _same_tree(got, jck.from_hf_vit_model(model))
    assert ("head" in got) == (num_labels > 0)
    sd = tck.hf_state_dict(model)
    _same_tree(tck.from_hf_vit_state_dict(sd, depth=2),
               jck.from_hf_vit_state_dict(sd, depth=2))


def test_imported_vit_forward_matches_hf_logits():
    model = _hf_vit(6)
    params, cfg = tck.import_hf_vit(model, dtype="float32", device="cpu")
    assert not cfg.safe_softmax and cfg.hidden_act == "gelu"
    assert cfg.ln_eps == model.config.layer_norm_eps
    x = np.random.default_rng(5).normal(size=(3, 32, 32, 3)).astype(
        np.float32)
    with torch.no_grad():
        want = model(pixel_values=torch.from_numpy(
            x.transpose(0, 3, 1, 2).copy())).logits.numpy()
    got = tvit.make_forward(cfg, params_from_numpy(params, device="cpu"),
                            raw=False, device="cpu")(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=2e-4 * np.abs(want).max())


def test_import_hf_vit_hot_and_cold():
    _, hot = tck.import_hf_vit(_hf_vit(hot=True), dtype="float32",
                               device="cpu")
    assert hot.safe_softmax
    assert (hot.hidden_dim, hot.depth, hot.num_heads, hot.mlp_dim,
            hot.num_classes) == (64, 2, 4, 128, 6)
    _, cold = tck.import_hf_vit(_hf_vit(act="gelu_new"), dtype="float32",
                                device="cpu")
    assert not cold.safe_softmax and cold.hidden_act == "gelu_tanh"
    _, jcold = jck.import_hf_vit(_hf_vit(act="gelu_new"), dtype="float32")
    assert jcold.safe_softmax == cold.safe_softmax


def test_autocalibrated_is_idempotent_and_loud(caplog):
    kw = dict(image_size=32, patch_size=8, hidden_dim=64, depth=2,
              num_heads=4, mlp_dim=128, num_classes=6, dtype="float32")
    cfg = tvit.ViTConfig(**kw)
    params = tvit.init_params(cfg, device="cpu")
    params["blocks"]["wqkv"] = params["blocks"]["wqkv"] * 40.0
    with caplog.at_level(logging.WARNING):
        out = tck.autocalibrated(params, cfg, source="unit-test ckpt")
    assert out.safe_softmax
    assert any("hot attention logits" in r.message for r in caplog.records)
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        again = tck.autocalibrated(params, out, source="unit-test ckpt")
    assert again.safe_softmax
    assert not any("hot attention" in r.message for r in caplog.records)
    # a numpy tree is probed where the caller says
    np_params = {k: (v if not isinstance(v, torch.Tensor) else v.numpy())
                 for k, v in params.items() if k != "blocks"}
    np_params["blocks"] = {k: v.numpy() for k, v in params["blocks"].items()}
    np_params["patch_embed"] = {k: v.numpy() for k, v in
                                params["patch_embed"].items()}
    np_params["head"] = {k: v.numpy() for k, v in params["head"].items()}
    assert tck.autocalibrated(np_params, cfg, device="cpu").safe_softmax


@pytest.mark.parametrize("teacher", [True, False])
def test_hf_deit_importer_equals_jax(teacher):
    hf_cfg = transformers.DeiTConfig(**TINY_HF, num_labels=5)
    torch.manual_seed(0)
    cls = (transformers.DeiTForImageClassificationWithTeacher if teacher
           else transformers.DeiTForImageClassification)
    model = cls(hf_cfg).eval()
    got = tdeit.from_hf_deit_model(model)
    _same_tree(got, jdeit.from_hf_deit_model(model))
    assert ("head_dist" in got) == teacher
    assert got["cls_token"].shape == (1, 2, 64)
    cfg = tdeit.config("deit_ti16", image_size=32, patch_size=8,
                       hidden_dim=64, depth=2, num_heads=4, mlp_dim=128,
                       num_classes=5, dtype="float32",
                       ln_eps=hf_cfg.layer_norm_eps)
    x = np.random.default_rng(6).normal(size=(2, 32, 32, 3)).astype(
        np.float32)
    with torch.no_grad():
        want = model(pixel_values=torch.from_numpy(
            x.transpose(0, 3, 1, 2).copy())).logits.numpy()
    out = tdeit.make_forward(cfg, params_from_numpy(got, device="cpu"),
                             raw=False, device="cpu")(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), want, rtol=0,
                               atol=2e-4 * np.abs(want).max())


def test_hf_clip_importers_equal_jax():
    vis = transformers.CLIPVisionConfig(**TINY_HF, projection_dim=32)
    txt = transformers.CLIPTextConfig(
        vocab_size=99, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=64,
        max_position_embeddings=16, projection_dim=32, eos_token_id=98,
        bos_token_id=97)
    torch.manual_seed(0)
    model = transformers.CLIPModel(transformers.CLIPConfig(
        vision_config=vis.to_dict(), text_config=txt.to_dict(),
        projection_dim=32)).eval()
    got = tclip.from_hf_clip_model(model)
    _same_tree(got, jclip.from_hf_clip_model(model))
    assert got["proj"].shape == (64, 32)
    sd = tck.hf_state_dict(model)
    _same_tree(tclip.from_hf_clip_text_state_dict(sd, depth=2),
               jclip.from_hf_clip_text_state_dict(sd, depth=2))
    # a bare vision tower: no projection, the identity
    torch.manual_seed(1)
    bare = transformers.CLIPVisionModel(vis).eval()
    got = tclip.from_hf_clip_model(bare)
    _same_tree(got, jclip.from_hf_clip_model(bare))
    np.testing.assert_array_equal(got["proj"], np.eye(64, dtype=np.float32))
    # the imported vision tower's embeddings against HF's (f32)
    cfg = tclip.clip_vision_config(
        "vit_b16", image_size=32, patch_size=8, hidden_dim=64, depth=2,
        num_heads=4, mlp_dim=128, dtype="float32")
    tree = tclip.from_hf_clip_model(model)
    x = np.random.default_rng(7).normal(size=(2, 32, 32, 3)).astype(
        np.float32)
    with torch.no_grad():
        want = model.get_image_features(pixel_values=torch.from_numpy(
            x.transpose(0, 3, 1, 2).copy())).numpy()
    out = tclip.make_forward(cfg, params_from_numpy(tree, device="cpu"),
                             raw=False, device="cpu")(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), want, rtol=0,
                               atol=2e-4 * np.abs(want).max())


def _resume_cfg():
    return tvit.ViTConfig(image_size=32, patch_size=8, hidden_dim=64,
                          depth=2, num_heads=4, mlp_dim=128, num_classes=6,
                          dtype="float32")


def _batches(n, seed=10):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(4, 32, 32, 3)).astype(np.float32),
             rng.integers(0, 6, 4).astype(np.int32)) for _ in range(n)]


def test_resumed_trainer_continues_identically(tmp_path):
    """4 AdamW steps straight through against 2 steps, a save, a restore
    into a new Trainer and 2 more: the losses to rtol 1e-6 (in fact
    equal), the params bit for bit."""
    cfg = _resume_cfg()
    batches = _batches(4)
    straight = ttrain.Trainer(cfg, learning_rate=1e-3, device="cpu")
    want = straight.fit(batches)

    first = ttrain.Trainer(cfg, learning_rate=1e-3, device="cpu")
    first.fit(batches[:2])
    path = str(tmp_path / "state.npz")
    state = first.state()
    assert state["step"] == 2 and state["opt_state"]["count"] == 2
    tck.save_train_state(path, state)
    raw = tck.load_train_state(path)
    assert int(raw["step"]) == 2
    assert set(raw["opt_state"]) == {"mu", "nu", "count"}
    restored = tck.load_train_state(path, like=state)
    assert isinstance(restored["step"], int)
    second = ttrain.Trainer(cfg, learning_rate=1e-3, device="cpu",
                            params=restored["params"],
                            opt_state=restored["opt_state"])
    got = second.fit(batches[2:])
    for a, b in zip(got, want[2:]):
        assert a["loss"] == pytest.approx(b["loss"], rel=1e-6)
    for a, b in zip(ttrain.param_leaves(second.canonical_params()),
                    ttrain.param_leaves(straight.canonical_params())):
        assert torch.equal(a, b)
    assert second.state()["opt_state"]["count"] == 4


def test_train_state_layout_is_optax():
    """The saved ``opt_state`` is optax's AdamW layout: ``mu`` and ``nu``
    shaped as the params, f32, and a count; fed back through
    ``adamw_state_from_optax`` it rebuilds the optimizer's moments
    exactly.  Before any step it is zeros with a count of 0."""
    from vit_fpga_tpu_torch.models.convert import adamw_state_from_optax
    cfg = _resume_cfg()
    trainer = ttrain.Trainer(cfg, device="cpu")
    fresh = trainer.state()["opt_state"]
    assert fresh["count"] == 0
    assert not any(np.any(v) for v in _flat(fresh["mu"]).values())
    trainer.fit(_batches(1))
    st = trainer.state()["opt_state"]
    shapes = {k: tuple(v.shape) for k, v in _flat(trainer.params).items()}
    for part in ("mu", "nu"):
        flat = _flat(st[part])
        assert {k: v.shape for k, v in flat.items()} == shapes
        assert all(v.dtype == np.float32 for v in flat.values())
    params, opt = ttrain.init_train_state(
        cfg, ttrain.adamw(3e-4), params=tvit.init_params(cfg, device="cpu"))
    adamw_state_from_optax(st["mu"], st["nu"], st["count"], params, opt)
    for a, b in zip(ttrain.param_leaves(params),
                    ttrain.param_leaves(trainer.params)):
        sa, sb = opt.state[a], trainer.optimizer.state[b]
        assert torch.equal(sa["exp_avg"], sb["exp_avg"])
        assert torch.equal(sa["exp_avg_sq"], sb["exp_avg_sq"])
        assert float(sa["step"]) == float(sb["step"]) == 1.0
