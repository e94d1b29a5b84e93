"""The port's sequence attention (plain PyTorch versions of the Hopper
kernels K9 flash attention, K7 on packed qkv and K8 on (B, H, N, Dh))
against the JAX Pallas kernels in interpret mode, at the shapes of the JAX
package's own tests; the dispatch (``mha_qkv``, ``mha``) and the gradients
of the differentiable wrappers."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_fpga_tpu.ops import attention as jatt
from vit_fpga_tpu.ops.flash_attention import flash_attention as jflash
from vit_fpga_tpu_torch.ops import attention as tatt
from vit_fpga_tpu_torch.ops import flash_attention as tflash

# f32: the JAX package's own flash tolerance (tests/test_flash_attention.py),
# summation order only.  bf16: the rounding points are the same (p against
# the running max, the output); the order of the f32 sums flips an
# occasional bf16 ulp: |a - b| <= 2^-6 (1 + |b|).
F32_TOL = 2e-4
BF16_TOL = 2.0 ** -6


def _qkv(seed, shape, dtype, scale=1.0):
    rng = np.random.default_rng(seed)
    arrs = [(rng.normal(size=shape) * scale).astype(np.float32)
            for _ in range(3)]
    dj = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    js = [jnp.asarray(a).astype(dj) for a in arrs]
    ts = [torch.from_numpy(np.array(j.astype(jnp.float32)))
          .to(getattr(torch, dtype)) for j in js]
    return js, ts


def _close(got, want, dtype):
    g = got.float().numpy()
    w = np.asarray(jnp.asarray(want).astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(g, w, rtol=F32_TOL, atol=F32_TOL)
    else:
        np.testing.assert_array_less(np.abs(g - w),
                                     BF16_TOL * (1.0 + np.abs(w)) + 1e-30)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bq,bk", [(128, 128), (512, 128)])
@pytest.mark.parametrize("n,n_valid", [(256, None), (300, None),
                                       (1100, None), (300, 200)])
def test_flash_plain_matches_pallas(n, n_valid, bq, bk, dtype):
    """K9's plain version vs ``flash_attention(interpret=True)``: (1, 2, n,
    64), one key block (256) up to nine (1100 with bk 128), and a masked
    case whose last key blocks are wholly or partly past n_valid."""
    js, ts = _qkv(n, (1, 2, n, 64), dtype)
    want = jflash(*js, n_valid=n_valid, bq=bq, bk=bk, interpret=True)
    got = tflash.flash_attention(*ts, n_valid=n_valid, bq=bq, bk=bk)
    _close(got, want, dtype)


def _late_max_qkv(seed, n, dtype):
    """(1, 2, n, 64) q, k, v whose keys grow along the sequence (k row j
    scaled by 0.2 .. 3), so that each row's running max rises in later key
    blocks and alpha = exp(m - m_new) rescales what the earlier blocks
    summed."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(1, 2, n, 64)).astype(np.float32)
               for _ in range(3))
    k = k * np.linspace(0.2, 3.0, n, dtype=np.float32)[None, None, :, None]
    dj = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    js = [jnp.asarray(a).astype(dj) for a in (q, k, v)]
    ts = [torch.from_numpy(np.array(j.astype(jnp.float32)))
          .to(getattr(torch, dtype)) for j in js]
    return js, ts


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bk", [128, 512])
@pytest.mark.parametrize("edge", [0, 1])
def test_flash_plain_matches_pallas_when_the_max_rises_late(edge, bk, dtype):
    """K9's plain version vs ``flash_attention(interpret=True)`` where the
    row max rises in a later key block (alpha matters), with n_valid at the
    end of a 128-key tile (edge 0: 512 keys at bk 128, 1024 at bk 512) and
    one past it (edge 1: a last key block of one valid key)."""
    n_valid = max(4 * 128, 2 * bk) + edge
    n = n_valid - edge + 128
    js, ts = _late_max_qkv(n_valid + bk, n, dtype)
    want = jflash(*js, n_valid=n_valid, bq=128, bk=bk, interpret=True)
    got = tflash.flash_attention(*ts, n_valid=n_valid, bq=128, bk=bk)
    _close(got, want, dtype)
    # the inputs do what they are for: most rows' max over the valid keys
    # lies past the first key block
    s = ts[0].float() @ ts[1].float()[..., :n_valid, :].transpose(-1, -2)
    assert (s.argmax(-1) >= bk).float().mean() > 0.5


def test_flash_block_size_is_part_of_the_function():
    """In bf16, p is rounded against the running max after each key block,
    so bk 128 and bk 512 give different outputs (each matching JAX at its
    own bk, above); in f32 they agree to rounding."""
    _, ts = _qkv(7, (1, 2, 1024, 64), "bfloat16", scale=2.0)
    a = tflash.flash_attention(*ts, bk=128).float()
    b = tflash.flash_attention(*ts, bk=512).float()
    assert (a - b).abs().max() > 0
    _, tf = _qkv(7, (1, 2, 1024, 64), "float32", scale=2.0)
    np.testing.assert_allclose(tflash.flash_attention(*tf, bk=128).numpy(),
                               tflash.flash_attention(*tf, bk=512).numpy(),
                               rtol=1e-5, atol=1e-5)


# (n, n_valid, batch) of the K7 / K8 parity tests: the JAX tests' shapes,
# then the card kernel's edges (one partial 128-key tile at 17 and 64
# tokens; n_valid at, one before and one past a key tile's end), one at
# batch 3.  The ids of the first three are the ones they had without batch.
SEQ_CASES = [
    pytest.param(200, None, 2, id="200-None"),
    pytest.param(200, 197, 2, id="200-197"),
    pytest.param(300, 257, 2, id="300-257"),
    pytest.param(17, None, 2, id="17-None"),
    pytest.param(64, None, 2, id="64-None"),
    pytest.param(200, 127, 2, id="200-127"),
    pytest.param(200, 128, 2, id="200-128"),
    pytest.param(200, 129, 3, id="200-129-b3"),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,n_valid,batch", SEQ_CASES)
def test_mha_qkv_pallas_plain_matches_pallas(n, n_valid, batch, dtype):
    """K7's plain version vs ``mha_qkv_pallas(interpret=True)`` on packed
    (batch, n, 3 * 128) qkv, 2 heads of 64, with and without n_valid < n."""
    rng = np.random.default_rng(n)
    dj = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    qkv_j = jnp.asarray(rng.normal(size=(batch, n, 384)).astype(np.float32)
                        ).astype(dj)
    qkv_t = torch.from_numpy(np.array(qkv_j.astype(jnp.float32))).to(
        getattr(torch, dtype))
    want = jatt.mha_qkv_pallas(qkv_j, 2, n_valid=n_valid, interpret=True)
    got = tatt.mha_qkv_pallas(qkv_t, 2, n_valid=n_valid)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,n_valid,batch", [
    pytest.param(197, None, 2, id="197-None"),
    pytest.param(300, 257, 2, id="300-257"),
    *SEQ_CASES[3:]])
def test_mha_pallas_plain_matches_pallas(n, n_valid, batch, dtype):
    """K8's plain version vs ``mha_pallas(interpret=True)`` on (batch, 2, n,
    64): N padded to 128 on the TPU, which changes nothing."""
    js, ts = _qkv(n + 1, (batch, 2, n, 64), dtype)
    want = jatt.mha_pallas(*js, n_valid=n_valid, interpret=True)
    got = tatt.mha_pallas(*ts, n_valid=n_valid)
    _close(got, want, dtype)


# (n, n_valid) where the f32 card kernel's one pass has edges, at 2 heads of
# 64: one valid key; n_valid one before, and one past, a 64-key tile's end
# (the last tile cut to its 16-key groups); a partial 64-row block whose
# last 16-row warp holds 6 of its rows, with and without padding keys.
F32_EDGES = [(200, 1), (200, 63), (200, 65), (70, None), (70, 65)]


@pytest.mark.parametrize("kernel", ["K7", "K8"])
@pytest.mark.parametrize("n,n_valid", F32_EDGES,
                         ids=[f"{n}-{nv}" for n, nv in F32_EDGES])
def test_f32_plain_matches_pallas_at_the_one_pass_edges(kernel, n, n_valid):
    """The plain f32 K7 / K8 (what the card's one-pass kernel is held to)
    vs ``mha_qkv_pallas`` / ``mha_pallas(interpret=True)``."""
    if kernel == "K7":
        rng = np.random.default_rng(n + (n_valid or 0))
        qkv = rng.normal(size=(2, n, 384)).astype(np.float32)
        want = jatt.mha_qkv_pallas(jnp.asarray(qkv), 2, n_valid=n_valid,
                                   interpret=True)
        got = tatt.mha_qkv_pallas(torch.from_numpy(qkv), 2, n_valid=n_valid)
    else:
        js, ts = _qkv(n + 2 * (n_valid or 0), (2, 2, n, 64), "float32")
        want = jatt.mha_pallas(*js, n_valid=n_valid, interpret=True)
        got = tatt.mha_pallas(*ts, n_valid=n_valid)
    _close(got, want, "float32")


def test_tma_stride_gate_names_the_kernel():
    """The bf16 K7 / K8 kernel reads its operands by TMA, whose base
    addresses and strides are whole 16-byte units: the launch gate refuses
    a view whose rows are 136 bytes apart, naming the kernel, and takes
    the packed qkv tensor's column blocks (rows 768 bytes apart)."""
    q68 = torch.zeros(1, 1, 64, 68, dtype=torch.bfloat16)[..., :64]
    with pytest.raises(ValueError, match="K8 mha_pallas: q must start "
                       "16-byte aligned"):
        tflash._strides(q68, "q", "K8 mha_pallas")
    qkv = torch.zeros(2, 10, 384, dtype=torch.bfloat16)
    assert (tflash._strides(tatt._heads(qkv, 2)[1], "k", "K7")
            == (3840, 64, 384))


def test_k7_and_k8_are_one_function():
    """K7 on packed qkv equals K8 on its head split, bit for bit."""
    rng = np.random.default_rng(3)
    qkv = torch.from_numpy(rng.normal(size=(2, 72, 384)).astype(
        np.float32)).to(torch.bfloat16)
    q, k, v = tatt._heads(qkv, 2)
    a = tatt.mha_qkv_pallas(qkv, 2, n_valid=70)
    b = tatt.mha_pallas(q, k, v, n_valid=70).transpose(1, 2).reshape(2, 72,
                                                                     128)
    assert torch.equal(a, b)


@pytest.mark.parametrize("impl", ["auto", "flash", "pallas", "xla"])
@pytest.mark.parametrize("n", [200, 1100])
def test_mha_qkv_dispatch_matches_jax(impl, n):
    """``mha_qkv`` with each impl against the JAX dispatch run as on a TPU:
    "auto" is flash (bq 512, bk 128) from 1024 tokens on, else the
    whole-sequence kernel; the JAX side runs the named kernel in interpret
    mode (f32, 1 head of 64)."""
    rng = np.random.default_rng(n)
    qkv = rng.normal(size=(1, n, 192)).astype(np.float32)
    want_impl = impl if impl != "auto" else ("flash" if n >= 1024
                                             else "pallas")
    qj = jnp.asarray(qkv)
    if want_impl == "flash":
        q, k, v = (qj[..., i * 64:(i + 1) * 64].reshape(1, n, 1, 64)
                   .transpose(0, 2, 1, 3) for i in range(3))
        want = jflash(q, k, v, n_valid=n - 3, bq=512, bk=128,
                      interpret=True).transpose(0, 2, 1, 3).reshape(1, n, 64)
    elif want_impl == "pallas":
        want = jatt.mha_qkv_pallas(qj, 1, n_valid=n - 3, interpret=True)
    else:
        want = jatt.mha_qkv_xla(qj, 1, n_valid=n - 3)
    got = tatt.mha_qkv(torch.from_numpy(qkv), 1, n_valid=n - 3, impl=impl)
    _close(got, want, "float32")


@pytest.mark.parametrize("impl", ["flash", "pallas", "xla"])
def test_mha_dispatch_matches_jax(impl):
    """``mha`` on (B, H, N, Dh) with an explicit impl vs the JAX ``mha``'s
    named route (flash with its default blocks of 512, K8 in interpret
    mode, or the reference)."""
    js, ts = _qkv(11, (1, 2, 640, 64), "float32")
    if impl == "flash":
        want = jflash(*js, n_valid=600, interpret=True)
    elif impl == "pallas":
        want = jatt.mha_pallas(*js, n_valid=600, interpret=True)
    else:
        want = jatt.mha_xla(*js, n_valid=600)
    _close(tatt.mha(*ts, n_valid=600, impl=impl), want, "float32")


@pytest.mark.parametrize("flash", [False, True])
def test_mha_qkv_gradient_is_the_reference_vjp(flash):
    """The differentiable wrapper's gradient equals autograd through
    ``mha_qkv_xla`` (the JAX custom VJPs recompute the XLA reference)."""
    rng = np.random.default_rng(5)
    qkv = torch.from_numpy(rng.normal(size=(2, 40, 384)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(2, 40, 128)).astype(np.float32))
    a = qkv.clone().requires_grad_(True)
    (tatt.mha_qkv(a, 2, n_valid=37, impl="flash" if flash else "pallas")
     * g).sum().backward()
    b = qkv.clone().requires_grad_(True)
    (tatt.mha_qkv_xla(b, 2, n_valid=37) * g).sum().backward()
    torch.testing.assert_close(a.grad, b.grad, rtol=0, atol=0)


def test_kernel_gates_on_a_cpu_tensor_run_the_plain_version():
    """A CPU tensor never reaches the kernel library: the wrappers' launch
    counts stay put."""
    before = (tflash.flash_attention.launches,
              tatt.mha_qkv_pallas.launches, tatt.mha_pallas.launches)
    _, ts = _qkv(2, (1, 1, 64, 64), "bfloat16")
    tflash.flash_attention(*ts, bk=128)
    tatt.mha_pallas(*ts)
    tatt.mha_qkv_pallas(torch.zeros(1, 64, 192, dtype=torch.bfloat16), 1)
    assert before == (tflash.flash_attention.launches,
                      tatt.mha_qkv_pallas.launches, tatt.mha_pallas.launches)
