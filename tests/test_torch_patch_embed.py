"""The port's uint8 patch embedding (fold_preprocess, patch_embed_xla and the
plain PyTorch version of the Hopper kernel K10) against the JAX package:
fold_preprocess bit for bit, patch_embed_pallas in interpret mode and
patch_embed_xla, on the same seeded numpy inputs.

Tolerances: f32 runs the same f32 products in another summation order, at
the JAX test's own rtol = atol = 1e-4; a bf16 output is the same f32 sum
rounded once, so it may sit one bf16 ulp away where the two f32 sums
straddle a rounding boundary."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_fpga_tpu.models import vit as jvit
from vit_fpga_tpu.ops.patch_embed import fold_preprocess as jax_fold
from vit_fpga_tpu.ops.patch_embed import patch_embed_pallas as jax_pe
from vit_fpga_tpu.ops.patch_embed import patch_embed_xla as jax_pe_xla
from vit_fpga_tpu_torch.models import vit as tvit
from vit_fpga_tpu_torch.ops import patch_embed as tpe

# (images shape, patch, D): the JAX test's geometry, and CLIP's P 14, whose
# (px, c) runs are 42 bytes
GEOMS = [((2, 32, 64, 3), 8, 128), ((2, 28, 56, 3), 14, 128)]
DTYPES = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)]


def _inputs(seed, shape, patch, d):
    """The JAX test's scales: kernel N(0, 0.01), bias N(0, 1)."""
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 256, shape, np.uint8)
    kf = rng.normal(size=(patch * patch * 3, d)).astype(np.float32) * 0.01
    bf = rng.normal(size=(d,)).astype(np.float32)
    return raw, kf, bf


def _within_one_bf16_ulp(got, want):
    g, w = np.asarray(got, np.float64), np.asarray(want, np.float64)
    mag = np.maximum(np.abs(g), np.abs(w))
    ulp = np.where(mag > 0, 2.0 ** (np.floor(np.log2(np.where(mag > 0, mag,
                                                             1.0))) - 7), 0)
    assert (np.abs(g - w) <= ulp).all(), float(np.abs(g - w).max())


@pytest.mark.parametrize("patch", [8, 14, 16])
def test_fold_preprocess_bit_for_bit(patch):
    rng = np.random.default_rng(patch)
    kernel = rng.normal(size=(patch * patch * 3, 96)).astype(np.float32)
    bias = rng.normal(size=(96,)).astype(np.float32)
    mean, std = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
    for want, got in zip(jax_fold(kernel, bias, mean, std, patch),
                         tpe.fold_preprocess(kernel, bias, mean, std, patch)):
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("geom", GEOMS, ids=["p8", "p14"])
@pytest.mark.parametrize("dts", DTYPES, ids=["f32", "bf16"])
def test_patch_embed_plain_matches_pallas(geom, dts):
    shape, patch, d = geom
    jdt, tdt = dts
    raw, kf, bf = _inputs(1, shape, patch, d)
    want = jax_pe(jnp.asarray(raw), jnp.asarray(kf), jnp.asarray(bf), patch,
                  out_dtype=jdt, interpret=True)
    got = tpe.patch_embed_pallas(torch.from_numpy(raw), torch.from_numpy(kf),
                                 torch.from_numpy(bf), patch, out_dtype=tdt)
    assert got.dtype == tdt and tuple(got.shape) == tuple(want.shape)
    g = got.float().numpy()
    w = np.asarray(want.astype(jnp.float32))
    if tdt == torch.float32:
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)
    else:
        _within_one_bf16_ulp(g, w)


@pytest.mark.parametrize("geom", GEOMS, ids=["p8", "p14"])
def test_patch_embed_xla_matches_jax_and_plain(geom):
    """patch_embed_xla (patchify + one GEMM) against the JAX one and
    against the plain version of K10 (per-py GEMMs): f32, 1e-4."""
    shape, patch, d = geom
    raw, kf, bf = _inputs(2, shape, patch, d)
    want = np.asarray(jax_pe_xla(jnp.asarray(raw), jnp.asarray(kf),
                                 jnp.asarray(bf), patch,
                                 out_dtype=jnp.float32))
    args = (torch.from_numpy(raw), torch.from_numpy(kf), torch.from_numpy(bf),
            patch)
    got = tpe.patch_embed_xla(*args, out_dtype=torch.float32).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    plain = tpe.patch_embed_plain(*args, out_dtype=torch.float32).numpy()
    np.testing.assert_allclose(plain, got, rtol=1e-4, atol=1e-4)


def test_folded_embed_equals_explicit_pipeline():
    """The JAX test's check on the port: fold_preprocess + K10's plain
    version on raw pixels == preprocess -> patchify -> GEMM + bias."""
    cfg = tvit.config("vit_b16", image_size=32, dtype="float32")
    jcfg = jvit.config("vit_b16", image_size=32, dtype="float32")
    assert (cfg.mean, cfg.std) == (jcfg.mean, jcfg.std)
    rng = np.random.default_rng(3)
    p = cfg.patch_size
    kernel = (rng.normal(size=(p * p * 3, 64)) * 0.02).astype(np.float32)
    bias = rng.normal(size=(64,)).astype(np.float32)
    kf, bf = tpe.fold_preprocess(kernel, bias, cfg.mean, cfg.std, p)
    raw = torch.from_numpy(rng.integers(0, 256, (2, 32, 32, 3), np.uint8))
    x = tvit.preprocess(raw, cfg)
    explicit = tvit.patchify(x, p) @ torch.from_numpy(kernel) \
        + torch.from_numpy(bias)
    folded = tpe.patch_embed_pallas(raw, torch.from_numpy(kf),
                                    torch.from_numpy(bf), p,
                                    out_dtype=torch.float32)
    np.testing.assert_allclose(folded.numpy(), explicit.numpy(), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("case", ["channels", "ragged", "kernel", "bias",
                                  "dtype", "out_dtype", "meta"])
def test_patch_embed_rejects_what_the_kernel_does_not_take(case):
    """The checks shared by K10 and its plain version, and the devices the
    wrapper takes (a meta tensor raises: no fallback)."""
    raw = torch.zeros((1, 32, 32, 3), dtype=torch.uint8)
    kf, bf = torch.zeros((192, 16)), torch.zeros(16)
    out_dtype = torch.bfloat16
    if case == "channels":
        raw = torch.zeros((1, 32, 32, 4), dtype=torch.uint8)
    elif case == "ragged":
        raw = torch.zeros((1, 36, 32, 3), dtype=torch.uint8)
    elif case == "kernel":
        kf = torch.zeros((191, 16))
    elif case == "bias":
        bf = torch.zeros(15)
    elif case == "dtype":
        raw = raw.float()
    elif case == "out_dtype":
        out_dtype = torch.float16
    elif case == "meta":
        raw = raw.to("meta")
    with pytest.raises(ValueError):
        tpe.patch_embed_pallas(raw, kf, bf, 8, out_dtype=out_dtype)


# ---------------------------------------------------------------------------
# K10's arithmetic on the card: the three-piece bf16 split of the f32
# weights, the padded bf16 patchify and the split GEMM, in plain PyTorch.
# ---------------------------------------------------------------------------

IMAGENET = ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225))
# (patch, D, (mean, std)): ViT-B/16's fold and CLIP ViT-L/14's
FOLDS = [(16, 768, IMAGENET), (14, 1024, (tvit.CLIP_MEAN, tvit.CLIP_STD))]


def _folded(patch, d, scales, seed):
    """ViT-style weights, N(0, 1/K) kernel and N(0, 0.02^2) bias, folded
    with ``scales`` as fold_preprocess folds them."""
    rng = np.random.default_rng(seed)
    k = patch * patch * 3
    kernel = (rng.normal(size=(k, d)) * k ** -0.5).astype(np.float32)
    bias = (rng.normal(size=(d,)) * 0.02).astype(np.float32)
    return tpe.fold_preprocess(kernel, bias, *scales, patch)


def _pieces_sum(w):
    lo, mid, hi, exact = tpe.split_pieces(torch.from_numpy(w))
    total = (hi.double() + mid.double()) + lo.double()
    return total.numpy(), exact.numpy(), (lo, mid, hi)


@pytest.mark.parametrize("fold", FOLDS, ids=["vit_b16", "clip_l14"])
def test_split_is_exact_on_folded_weights(fold):
    """Every folded weight of ViT-B/16 and CLIP ViT-L/14 is the exact sum
    (in f64, bit for bit) of its three bf16 pieces, each a normal bf16 or
    zero, hi the weight rounded to bf16 and each piece within half an ulp
    of the remainder above it."""
    patch, d, scales = fold
    kf, _ = _folded(patch, d, scales, seed=patch)
    total, exact, (lo, mid, hi) = _pieces_sum(kf)
    assert exact.all()
    np.testing.assert_array_equal(total, kf.astype(np.float64))
    np.testing.assert_array_equal(hi.float().numpy(),
                                  torch.from_numpy(kf).to(torch.bfloat16)
                                  .float().numpy())
    assert (lo.float().abs() <= mid.float().abs() * 2.0 ** -7).all()
    assert (mid.float().abs() <= hi.float().abs() * 2.0 ** -7).all()


def test_split_of_zeros_and_tiny_values():
    """Zeros split into three zeros; tiny normal weights (2^-100 and
    below, while every piece stays a normal bf16) split exactly; where a
    piece would be a bf16 subnormal (weights near 2^-116 with low bits
    set, f32 subnormals) the split says so (exact False), as the kernel
    refuses them; NaN and infinity are not exact either."""
    rng = np.random.default_rng(5)
    zeros = np.zeros((4, 8), np.float32)
    total, exact, _ = _pieces_sum(zeros)
    assert exact.all() and (total == 0).all()
    normal = (rng.uniform(1, 2, (64,)) * 2.0 ** -100).astype(np.float32)
    normal *= rng.choice([-1, 1], 64).astype(np.float32)
    total, exact, _ = _pieces_sum(normal)
    assert exact.all()
    np.testing.assert_array_equal(total, normal.astype(np.float64))
    # 1 + 2^-23 has its lowest bit 23 places down: at 2^-116 that piece is
    # 2^-139, past bf16's normals (and its subnormals' 2^-133 grid)
    low_bits = np.float32(2.0 ** -116) * np.float32(1 + 2.0 ** -23)
    subnormal = np.float32(1e-40)
    power = np.float32(2.0 ** -120)  # one bit: a normal hi, no low pieces
    odd = np.array([low_bits, subnormal, power, np.inf, np.nan], np.float32)
    _, exact, _ = _pieces_sum(odd)
    assert exact.tolist() == [False, False, True, False, False]


def test_pixels_are_exact_in_bf16():
    """Every uint8 pixel value is exact in bf16 (8 significant bits)."""
    px = torch.arange(256, dtype=torch.uint8)
    assert torch.equal(px.to(torch.bfloat16).float(), px.float())


@pytest.mark.parametrize("geom", GEOMS + [((2, 48, 32, 3), 16, 64)],
                         ids=["p8", "p14", "p16"])
def test_patchify_padded_matches_jax_patchify(geom):
    """K10's patchify pass: the JAX patchify's (py, px, c) rows in bf16,
    K padded with zero columns to a multiple of 8 (P 14: 588 -> 592)."""
    shape, patch, _ = geom
    raw = np.random.default_rng(7).integers(0, 256, shape, np.uint8)
    want = np.asarray(jvit.patchify(jnp.asarray(raw), patch))
    want = want.reshape(-1, want.shape[-1])
    got = tpe.patchify_padded(torch.from_numpy(raw), patch)
    k = patch * patch * 3
    assert got.dtype == torch.bfloat16
    assert tuple(got.shape) == (want.shape[0], -(-k // 8) * 8)
    np.testing.assert_array_equal(got[:, :k].float().numpy(),
                                  want.astype(np.float32))
    assert (got[:, k:] == 0).all()


def _sum_band(got, want, raw, kf, bf, patch, bf16):
    """chip_smoke.py's phase 17 band for K10: 1e-5 (1 + |want|) + 2
    sqrt(K) 2^-24 sum |terms| (+ one bf16 ulp of the larger)."""
    g = np.asarray(got, np.float64).reshape(-1, kf.shape[1])
    w = np.asarray(want, np.float64).reshape(g.shape)
    k = patch * patch * 3
    x = np.asarray(jvit.patchify(jnp.asarray(raw), patch),
                   np.float64).reshape(-1, k)
    mag = x @ np.abs(kf.astype(np.float64)) + np.abs(bf)
    band = 1e-5 * (1 + np.abs(w)) + 2 * k ** 0.5 * 2.0 ** -24 * mag
    if bf16:
        band = band + 2.0 ** -7 * np.maximum(np.abs(g), np.abs(w))
    assert (np.abs(g - w) <= band).all(), float(np.abs(g - w).max())


@pytest.mark.parametrize("geom", GEOMS, ids=["p8", "p14"])
@pytest.mark.parametrize("dts", DTYPES, ids=["f32", "bf16"])
def test_split_gemm_matches_pallas_in_phase17s_band(geom, dts):
    """The split GEMM's arithmetic (patch_embed_split_plain) against the
    JAX patch_embed_pallas in interpret mode, on the JAX test's inputs and
    on folded ViT weights, within phase 17's band."""
    shape, patch, d = geom
    jdt, tdt = dts
    raw, kf, bf = _inputs(11, shape, patch, d)
    folded = _folded(patch, d, IMAGENET, seed=12)
    for k_w, b_w in ((kf, bf), folded):
        want = jax_pe(jnp.asarray(raw), jnp.asarray(k_w), jnp.asarray(b_w),
                      patch, out_dtype=jdt, interpret=True)
        got = tpe.patch_embed_split_plain(
            torch.from_numpy(raw), torch.from_numpy(k_w),
            torch.from_numpy(b_w), patch, out_dtype=tdt)
        assert got.dtype == tdt and tuple(got.shape) == tuple(want.shape)
        _sum_band(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                  raw, k_w, b_w, patch, tdt == torch.bfloat16)


def test_split_gemm_is_exact_on_one_lit_pixel():
    """One pixel of 128 lit in each patch (the rest 0): every product but
    one is 0, so the split GEMM's f32 sum is 128 (lo + mid + hi) = 128 w
    exactly and equals the per-py plain version bit for bit; a split
    without its lo piece would not (chip_smoke.py holds K10 so)."""
    patch, d = 14, 64
    kf, bf = _folded(patch, d, IMAGENET, seed=13)
    k = patch * patch * 3
    raw = np.zeros((2, 28, 42, 3), np.uint8)
    for i, (b, gy, gx) in enumerate(np.ndindex(2, 2, 3)):
        q = (37 * i + 5) % k
        py, px, c = q // (3 * patch), q // 3 % patch, q % 3
        raw[b, gy * patch + py, gx * patch + px, c] = 128
    args = (torch.from_numpy(raw), torch.from_numpy(kf),
            torch.from_numpy(bf), patch)
    for dt in (torch.float32, torch.bfloat16):
        got = tpe.patch_embed_split_plain(*args, out_dtype=dt)
        assert torch.equal(got, tpe.patch_embed_plain(*args, out_dtype=dt))
    lo, mid, hi, _ = tpe.split_pieces(args[1])
    a = tpe.patchify_padded(args[0], patch)[:, :k].float()
    two = (a @ mid.float() + a @ hi.float()) + args[2]
    assert not torch.equal(two, tpe.patch_embed_plain(
        *args, out_dtype=torch.float32).reshape(two.shape))


def test_split_gemm_refuses_weights_it_cannot_split():
    """A weight with a subnormal piece makes the split GEMM raise, as K10
    raises on the card: no silent rounding."""
    raw, kf, bf = _inputs(14, (1, 16, 16, 3), 8, 16)
    kf[3, 5] = 1e-40
    with pytest.raises(ValueError, match="exact"):
        tpe.patch_embed_split_plain(torch.from_numpy(raw),
                                    torch.from_numpy(kf),
                                    torch.from_numpy(bf), 8)
