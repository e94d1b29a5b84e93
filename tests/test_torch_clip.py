"""The port's CLIP (models/clip.py, plain versions on the CPU) against the
JAX package's CLIP on the CPU: configuration, parameter tree, the vision
forward (raw and normalized input, L2-normalized embeddings), the text
tower and the batch-1 latency forward, on the same parameters handed over
through params_from_numpy."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_fpga_tpu.models import clip as jclip
from vit_fpga_tpu.models import vit as jvit
from vit_fpga_tpu_torch.models import clip as tclip
from vit_fpga_tpu_torch.models import vit as tvit
from vit_fpga_tpu_torch.models.convert import params_from_numpy
from vit_fpga_tpu_torch.runtime.serving import ImageServer

# image 32, patch 8 (17 tokens on 24 rows), D 128, 2 heads of 64, depth 2
SMALL = dict(image_size=32, patch_size=8, hidden_dim=128, num_heads=2,
             depth=2, mlp_dim=256)
PROJ = 24


def _perturb(tree, seed):
    """Every leaf + 0.02 * normal noise, so the zero-init biases, LN
    parameters and class token carry signal."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: np.asarray(p, np.float32)
        + 0.02 * rng.normal(size=np.shape(p)).astype(np.float32), tree)


def _vision_pair(seed, dtype):
    """CLIP configs of both packages at SMALL (the JAX ``config`` takes no
    override of a variant's own fields, so both are replaced)."""
    jcfg = dataclasses.replace(jclip.clip_vision_config("vit_b16",
                                                        dtype=dtype), **SMALL)
    tcfg = dataclasses.replace(tclip.clip_vision_config("vit_b16",
                                                        dtype=dtype), **SMALL)
    np_params = _perturb(jclip.init_params(jax.random.key(0), jcfg,
                                           projection_dim=PROJ), seed)
    jparams = jax.tree_util.tree_map(jnp.asarray, np_params)
    return jcfg, tcfg, jparams, params_from_numpy(np_params, device="cpu")


def _images(seed, b, s=32):
    return np.random.default_rng(seed).integers(0, 256, (b, s, s, 3),
                                                np.uint8)


def _shapes(tree):
    return jax.tree_util.tree_map(lambda x: tuple(np.shape(x)), tree)


def test_clip_vision_config_matches_jax():
    """ViT-L/14 at 224 px: 257 tokens, D 1024, quick-GELU, eps 1e-5,
    CLIP's mean and std, no classifier."""
    j = jclip.clip_vision_config("vit_l14")
    t = tclip.clip_vision_config("vit_l14")
    assert t.seq_len == j.seq_len == 257
    assert t.hidden_dim == 1024 and t.head_dim == 64
    names = {f.name for f in dataclasses.fields(tvit.ViTConfig)}
    jd = dataclasses.asdict(j)
    assert {k: v for k, v in jd.items() if k in names} == \
        dataclasses.asdict(t)
    assert t.hidden_act == "quick_gelu" and t.ln_eps == 1e-5
    assert t.mean == tvit.CLIP_MEAN == jvit.CLIP_MEAN
    assert t.std == tvit.CLIP_STD == jvit.CLIP_STD
    assert tclip.CLIPHead().projection_dim == jclip.CLIPHead().projection_dim


def test_clip_init_params_tree_matches_jax_and_is_seeded():
    jcfg, tcfg, _, _ = _vision_pair(0, "float32")
    jp = jclip.init_params(jax.random.key(0), jcfg, projection_dim=PROJ)
    g1, g2 = torch.Generator(), torch.Generator()
    g1.manual_seed(4)
    g2.manual_seed(4)
    a = tclip.init_params(tcfg, PROJ, g1, device="cpu")
    b = tclip.init_params(tcfg, PROJ, g2, device="cpu")
    assert _shapes(a) == _shapes(jp)
    assert "head" not in a and a["proj"].shape == (128, PROJ)
    torch.testing.assert_close(a["proj"], b["proj"], rtol=0, atol=0)
    # ViT-L/14's tree at full size, by shape only
    full = jax.eval_shape(lambda k: jclip.init_params(
        k, jclip.clip_vision_config("vit_l14")), jax.random.key(0))
    assert _shapes(full)["blocks"]["w1"] == (24, 1024, 4096)
    assert _shapes(full)["pos_embed"] == (1, 257, 1024)


@pytest.mark.parametrize("dtype,raw", [("float32", False),
                                       ("float32", True),
                                       ("bfloat16", False),
                                       ("bfloat16", True)])
def test_clip_forward_matches_jax(dtype, raw):
    """f32: the JAX CPU forward runs the per-block XLA path, the port the
    stats chain: the same function up to f32 rounding (1e-4).  bf16:
    rounding at other points, 2e-2 in relative norm."""
    jcfg, tcfg, jparams, tparams = _vision_pair(1, dtype)
    img = _images(2, 3)
    if raw:
        want = jclip.forward_raw(jparams, jnp.asarray(img), jcfg)
        got = tclip.make_forward(tcfg, tparams, raw=True, device="cpu")(img)
    else:
        x = np.array(jvit.preprocess(jnp.asarray(img), jcfg)
                     .astype(jnp.float32))
        want = jclip.forward(jparams, jnp.asarray(x).astype(
            jcfg.compute_dtype), jcfg)
        got = tclip.make_forward(tcfg, tparams, raw=False, device="cpu")(
            torch.from_numpy(x).to(tcfg.compute_dtype))
    want = np.asarray(want, np.float32)
    assert got.dtype == torch.float32 and got.shape == (3, PROJ)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    else:
        rel = np.linalg.norm(got.numpy() - want) / np.linalg.norm(want)
        assert rel < 2e-2, rel


def test_clip_embed_normalized_matches_jax():
    jcfg, tcfg, jparams, tparams = _vision_pair(3, "float32")
    x = np.array(jvit.preprocess(jnp.asarray(_images(4, 2)), jcfg))
    want = np.asarray(jclip.embed_normalized(jparams, jnp.asarray(x), jcfg))
    got = tclip.embed_normalized(tparams, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(got.numpy(), axis=-1), 1.0,
                               rtol=1e-6)


def test_clip_embed_has_no_tail_rows():
    """As the JAX ``_embed``: the embed gives the 17 tokens only; the token
    axis is padded (to 24 rows) after ln_pre."""
    _, tcfg, _, tparams = _vision_pair(5, "float32")
    x = tvit.preprocess(torch.from_numpy(_images(6, 1)), tcfg)
    toks = tclip._embed(tparams, x, tcfg)
    assert toks.shape == (1, tcfg.seq_len, 128)     # no tail rows


def _text_pair(seed):
    jt = jclip.CLIPTextConfig(vocab_size=99, hidden_dim=64, depth=2,
                              num_heads=2, mlp_dim=128, max_positions=16,
                              projection_dim=PROJ)
    tt = tclip.CLIPTextConfig(**dataclasses.asdict(jt))
    np_params = _perturb(jclip.init_text_params(jax.random.key(1), jt), seed)
    return (jt, tt, jax.tree_util.tree_map(jnp.asarray, np_params),
            params_from_numpy(np_params, device="cpu"))


def test_clip_text_config_and_tree_match_jax():
    assert dataclasses.asdict(tclip.CLIPTextConfig()) == \
        dataclasses.asdict(jclip.CLIPTextConfig())
    jt, tt, _, _ = _text_pair(0)
    jp = jclip.init_text_params(jax.random.key(1), jt)
    assert _shapes(tclip.init_text_params(tt, device="cpu")) == _shapes(jp)


def test_clip_text_forward_matches_jax_with_eot_pooling():
    """Pooled at the EOT token, the argmax id of each sequence (placed at
    different positions; a tie resolves to the first), f32."""
    jt, tt, jparams, tparams = _text_pair(7)
    rng = np.random.default_rng(8)
    ids = rng.integers(1, 90, size=(4, 10)).astype(np.int32)
    for row, pos in enumerate((9, 3, 0, 6)):
        ids[row, pos] = 98                   # EOT: the largest id
    ids[3, 8] = 98                           # a tie: row 3 pools at 6
    want = np.asarray(jclip.text_forward(jparams, jnp.asarray(ids), jt))
    got = tclip.text_forward(tparams, torch.from_numpy(ids), tt)
    assert got.shape == (4, PROJ)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


def test_clip_forward_latency_matches_jax(monkeypatch):
    """The single-launch encoder path (plain K11 here) against the JAX
    one with vit_layers_pallas in interpret mode, f32 (as
    tests/test_clip.py runs it)."""
    import vit_fpga_tpu.ops.vit_stack as vs
    orig = vs.vit_layers_pallas
    monkeypatch.setattr(
        vs, "vit_layers_pallas",
        lambda *a, **k: orig(*a, **{**k, "interpret": True}))
    jcfg, tcfg, jparams, tparams = _vision_pair(9, "float32")
    x = np.array(jvit.preprocess(jnp.asarray(_images(10, 2)), jcfg))
    want = np.asarray(jclip.forward_latency(jparams, jnp.asarray(x), jcfg))
    got = tclip.forward_latency(tparams, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    # and the throughput forward computes the same embeddings
    np.testing.assert_allclose(
        got.numpy(), tclip.forward(tparams, torch.from_numpy(x),
                                   tcfg).numpy(), rtol=1e-4, atol=1e-4)


def test_clip_latency_gate():
    cfg = tclip.clip_vision_config("vit_b16", dtype="bfloat16")
    assert tclip.latency_forward_supported(cfg, 1)
    assert not tclip.latency_forward_supported(cfg, 5)
    assert not tclip.latency_forward_supported(
        dataclasses.replace(cfg, dtype="float32"), 1)
    assert not tclip.latency_forward_supported(
        tclip.clip_vision_config("vit_l14", dtype="bfloat16"), 1)  # 257


def test_clip_image_server_rows_are_embeddings():
    """ImageServer over clip.make_forward answers (projection_dim,) rows,
    equal to the forward on the same images."""
    _, tcfg, _, tparams = _vision_pair(11, "float32")
    fwd = tclip.make_forward(tcfg, tparams, device="cpu")
    imgs = _images(12, 5)
    with ImageServer(fwd, image_size=32, batch_size=2,
                     device="cpu") as server:
        rows = [f.result(timeout=60)
                for f in [server.submit_raw(i) for i in imgs]]
    assert all(r.shape == (PROJ,) for r in rows)
    np.testing.assert_allclose(np.stack(rows), fwd(imgs).numpy(),
                               rtol=1e-5, atol=1e-6)


def test_clip_entry_points_need_a_card_or_cpu():
    """No quiet fallback: without a GPU the entry points raise unless
    device='cpu'."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, tcfg, _, tparams = _vision_pair(13, "bfloat16")
    with pytest.raises(RuntimeError):
        tclip.make_forward(tcfg, tparams)
    with pytest.raises(RuntimeError):
        tclip.init_params(tcfg)
    with pytest.raises(RuntimeError):
        tclip.init_text_params(tclip.CLIPTextConfig(depth=1))
