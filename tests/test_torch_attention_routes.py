"""The masked attention at the shape classes of its few-keys and short bf16
routes, against the JAX package's kernel.

``csrc/attention.cu`` gives a head of at most 8 keys under more query rows
to ``masked_attention_few_keys`` and bf16 heads with both sides under 16 to
``masked_attention_short_bf16``.  On the CPU the port's
:func:`masked_attention` takes its plain version; here it is held, on
inputs made with numpy from a seed, against ``masked_flash_attention``
(Pallas, interpreted) and the XLA path of the JAX package at each class:
one and five keys under many query rows (the decoders' cross-attention),
SPRITES' 8 x 8 axial heads on bf16 inputs (rounded to bf16 in numpy and fed
to JAX in fp32, which the Pallas kernel widens to exactly), and batch
elements whose keys are all masked.  Tolerance: that of the reference's
Pallas attention test (``tests/test_pallas.py``), rtol 2e-4, atol 2e-5.
The kernels themselves are held against the plain version on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``; the route
``chip_smoke.attention_variant`` expects at each model shape is pinned
here too.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from multimodal_vae_comparison_tpu.models.nets import dot_product_attention, key_padding_bias
from multimodal_vae_comparison_tpu.ops.pallas import attention as jattn
from multimodal_vae_comparison_tpu_torch.ops.kernels import attention as tattn
from multimodal_vae_comparison_tpu_torch.ops.kernels import telemetry
from test_torch_slice import one_torch_thread  # noqa: F401 (autouse)

ATTN_TOL = dict(rtol=2e-4, atol=2e-5)   # as tests/test_pallas.py


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(jattn, "_INTERPRET", True)


def _inputs(seed, b, h, tq, tk, dh, masked, bf16=False):
    """q, k, v (fp32, or bf16-rounded values) and a (B, Tk) mask with a
    random share of keys masked and batch element 0 masked whole."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(b, h, t, dh)).astype(np.float32) for t in (tq, tk, tk))
    if bf16:
        q, k, v = (torch.from_numpy(x).bfloat16().float().numpy() for x in (q, k, v))
    mask = None
    if masked:
        mask = rng.random((b, tk)) > 0.4
        mask[0] = False
    return q, k, v, mask


def _jax(q, k, v, mask):
    """The JAX package's Pallas kernel (interpreted) and its XLA path."""
    jmask = None if mask is None else jnp.asarray(mask)
    pallas = jattn.masked_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                          jmask, kv_block=128)
    xla = dot_product_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                key_padding_bias(jmask))
    return np.asarray(pallas), np.asarray(xla)


def _port(q, k, v, mask, dtype=torch.float32):
    telemetry.reset()
    got = tattn.masked_attention(*(torch.from_numpy(x).to(dtype) for x in (q, k, v)),
                                 None if mask is None else torch.from_numpy(mask))
    assert telemetry.summary() == {"attention:plain": 1} and got.dtype == torch.float32
    return got.numpy()


@pytest.mark.parametrize("b,h,tq,tk,dh", [
    (3, 2, 45, 1, 8),      # the flagship text decoder: one latent key
    (2, 2, 60, 1, 16),     # VILANRO's action decoder, Dh 16
    (3, 2, 4, 1, 16),      # VILANRO's language decoder: 4 query rows
    (2, 4, 30, 5, 32),     # Dec_TransformerCond: z and 4 instruction words
    (2, 4, 8, 1, 64),      # Dec_TransformerIMG, Dh 64
    (2, 2, 9, 8, 12)],     # 8 keys, the few-keys kernel's most; Dh % 8 != 0
    ids=["flagship-decoder", "vilanro-action", "vilanro-language", "cond", "img-dec",
         "eight-keys"])
@pytest.mark.parametrize("masked", [True, False], ids=["masked", "unmasked"])
def test_few_keys_shapes_match_pallas_interpret(b, h, tq, tk, dh, masked):
    q, k, v, mask = _inputs(60, b, h, tq, tk, dh, masked)
    got = _port(q, k, v, mask)
    pallas, xla = _jax(q, k, v, mask)
    np.testing.assert_allclose(got, pallas, **ATTN_TOL)
    np.testing.assert_allclose(got, xla, **ATTN_TOL)


@pytest.mark.parametrize("b,tq,tk,dh", [
    (6, 8, 8, 32),     # SPRITES' T axis: 8 frames, 2 heads of 32
    (4, 7, 5, 16),     # a pass of 4 rows left partial
    (3, 15, 15, 8),    # both sides at 15, Dh 8
    (3, 12, 9, 64)],   # Dh 64, 9 keys: 16 lanes a row
    ids=["sprites-t", "partial-pass", "fifteen", "dh64"])
@pytest.mark.parametrize("masked", [True, False], ids=["masked", "unmasked"])
def test_short_bf16_shapes_match_pallas_interpret(b, tq, tk, dh, masked):
    q, k, v, mask = _inputs(61, b, 2, tq, tk, dh, masked, bf16=True)
    got = _port(q, k, v, mask, torch.bfloat16)
    pallas, xla = _jax(q, k, v, mask)
    np.testing.assert_allclose(got, pallas, **ATTN_TOL)
    np.testing.assert_allclose(got, xla, **ATTN_TOL)


@pytest.mark.parametrize("tq,tk,dtype", [(45, 1, torch.float32), (100, 5, torch.float32),
                                         (8, 8, torch.bfloat16), (9, 3, torch.bfloat16)],
                         ids=["one-key", "five-keys", "bf16-8x8", "bf16-three-keys"])
def test_fully_masked_elements_are_the_uniform_average(tq, tk, dtype):
    """Batch elements whose keys are all masked (0 and 2 of 3) give the
    uniform average of V, as the Pallas kernel (-1e30 bias) and the XLA
    path (-1e9) both give; at one key that is v itself."""
    q, k, v, mask = _inputs(62, 3, 2, tq, tk, 16, True, bf16=dtype == torch.bfloat16)
    mask[2] = False
    mask[1, 0] = True
    got = _port(q, k, v, mask, dtype)
    pallas, xla = _jax(q, k, v, mask)
    np.testing.assert_allclose(got, pallas, **ATTN_TOL)
    np.testing.assert_allclose(got, xla, **ATTN_TOL)
    for e in (0, 2):
        uniform = np.broadcast_to(v[e].mean(axis=1, keepdims=True), got[e].shape)
        np.testing.assert_allclose(got[e], uniform, **ATTN_TOL)
    if tk == 1:
        np.testing.assert_array_equal(got, np.broadcast_to(v, got.shape))


@pytest.mark.parametrize("shape,dtype,variant", [
    ((448, 4, 100, 5, 32), torch.float32, "few_keys"),    # Dec_TransformerCond lattice
    ((64, 4, 100, 1, 32), torch.float32, "few_keys"),
    ((640, 2, 246, 1, 8), torch.float32, "few_keys"),     # CUB's DReG text decoder
    ((448, 2, 4, 1, 16), torch.float32, "few_keys"),      # VILANRO's language decoder
    ((112, 4, 8, 1, 64), torch.float32, "few_keys"),      # Dec_TransformerIMG
    ((128, 2, 45, 1, 8), torch.float32, "few_keys"),      # the flagship text decoder
    ((128, 2, 45, 45, 32), torch.float32, "resident"),    # the flagship text encoder
    ((61440, 2, 8, 8, 32), torch.float32, "resident"),    # SPRITES' fp32 T axis
    ((16, 4, 8, 8, 64), torch.float32, "resident"),       # Enc_TransformerIMG
    ((64, 2, 4, 4, 32), torch.float32, "resident"),       # VILANRO's language encoder
    ((61440, 2, 8, 8, 32), torch.bfloat16, "short_bf16"),  # SPRITES' bf16 T axis
    ((4096, 2, 16, 16, 32), torch.bfloat16, "tc_bf16"),   # and its H axis
    ((640, 2, 246, 1, 8), torch.bfloat16, "tc_bf16"),     # CUB's decoder in bf16
    ((2, 3, 9, 11, 6), torch.bfloat16, "resident"),       # Dh 6: widened
    ((3, 2, 20, 3, 12), torch.bfloat16, "few_keys")],     # Dh 12, 3 keys: widened
    ids=lambda x: str(x).replace(" ", "").replace("torch.", "") if not isinstance(x, str)
    else x)
def test_chip_smoke_expects_the_launchers_route(shape, dtype, variant):
    """``chip_smoke.attention_variant``, which its checks hold each
    launch's telemetry to, names the route csrc/attention.cu takes at the
    model paths' shapes (aligned inputs, heads the resident kernel holds)."""
    assert chip_smoke.attention_variant(shape, dtype) == variant
    assert variant in tattn.VARIANTS
