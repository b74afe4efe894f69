"""The port's kernel modules against the JAX package's kernels.

Each plain PyTorch version (what a CPU tensor takes) is held against the
Pallas kernel in interpret mode and against the JAX package's plain jnp
functions, on inputs made with numpy from a seed.  The CUDA kernels
themselves are held against the plain versions by
``tests/test_torch_cuda.py`` (marked ``cuda``) and by ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_vae_comparison_tpu.models.nets import (
    dot_product_attention, key_padding_bias)
from multimodal_vae_comparison_tpu.ops import fusion as jfusion
from multimodal_vae_comparison_tpu.ops.pallas import attention as jattn
from multimodal_vae_comparison_tpu.ops.pallas import poe_kernel as jpoe
from multimodal_vae_comparison_tpu_torch.ops import fusion as tfusion
from multimodal_vae_comparison_tpu_torch.ops.kernels import attention as tattn
from multimodal_vae_comparison_tpu_torch.ops.kernels import poe_kernel as tpoe
from multimodal_vae_comparison_tpu_torch.ops.kernels import telemetry

ATTN_TOL = dict(rtol=2e-4, atol=2e-5)   # as tests/test_pallas.py
POE_TOL = dict(rtol=1e-5, atol=1e-6)    # elementwise fp32, one sum over E


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(jpoe, "_INTERPRET", True)
    monkeypatch.setattr(jattn, "_INTERPRET", True)


def _experts(seed, shape):
    rng = np.random.default_rng(seed)
    mus = rng.normal(size=shape).astype(np.float32)
    scales = rng.uniform(0.3, 2.0, shape).astype(np.float32)
    return mus, scales


@pytest.mark.parametrize("shape", [(1, 8, 16), (2, 8, 16), (3, 8, 16),
                                   (2, 4, 3, 24), (3, 7, 5)])
@pytest.mark.parametrize("prior", [1.0, 0.0])
def test_poe_plain_matches_pallas_interpret(shape, prior):
    mus, scales = _experts(0, shape)
    want = jpoe.poe_fused(jnp.asarray(mus), jnp.asarray(scales), prior)
    want_jnp = jfusion.poe_precision_fusion(jnp.asarray(mus), jnp.asarray(scales), prior)
    got = tpoe.poe_fused(torch.from_numpy(mus), torch.from_numpy(scales), prior)
    for g, w, wj in zip(got, want, want_jnp):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **POE_TOL)
        np.testing.assert_allclose(g.numpy(), np.asarray(wj), **POE_TOL)


@pytest.mark.parametrize("include_prior", [True, False])
def test_product_of_experts_matches_jax(include_prior):
    mus, scales = _experts(1, (2, 5, 16))
    want = jfusion.product_of_experts(jnp.asarray(mus), jnp.asarray(scales),
                                      include_prior=include_prior)
    got = tfusion.product_of_experts(torch.from_numpy(mus), torch.from_numpy(scales),
                                     include_prior=include_prior)
    got_plain = tfusion.poe_precision_fusion(torch.from_numpy(mus), torch.from_numpy(scales),
                                             1.0 if include_prior else 0.0)
    for g, gp, w in zip(got, got_plain, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **POE_TOL)
        np.testing.assert_array_equal(g.numpy(), gp.numpy())


def test_subset_lattice_matches_jax():
    for m in (1, 2, 3, 4):
        assert tfusion.subset_lattice(m) == jfusion.subset_lattice(m)
    assert tfusion.subset_lattice(3, [(2, 0)]) == jfusion.subset_lattice(3, [(2, 0)])


def _qkv(seed, b, h, tq, tk, dh):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, h, tq, dh)).astype(np.float32)
    k = rng.normal(size=(b, h, tk, dh)).astype(np.float32)
    v = rng.normal(size=(b, h, tk, dh)).astype(np.float32)
    return q, k, v, rng


@pytest.mark.parametrize("b,h,tq,tk,dh,block", [
    (2, 2, 8, 8, 4, 8),
    (2, 2, 45, 45, 32, 128),   # encoder self-attention
    (2, 2, 45, 1, 8, 128),     # decoder cross-attention (Tk = 1, Dh = 8)
    (2, 2, 4, 130, 16, 128),   # Tk over one kv block
    (1, 2, 6, 30, 8, 8),
])
@pytest.mark.parametrize("masked", [True, False])
def test_attention_plain_matches_pallas_interpret(b, h, tq, tk, dh, block, masked):
    q, k, v, rng = _qkv(3, b, h, tq, tk, dh)
    mask = None
    if masked:
        mask = rng.random((b, tk)) > 0.3
        mask[:, 0] = True
    jmask = None if mask is None else jnp.asarray(mask)
    want = jattn.masked_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                        jmask, kv_block=block)
    want_xla = dot_product_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                     key_padding_bias(jmask))
    got = tattn.masked_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v),
                                 None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATTN_TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_xla), **ATTN_TOL)


@pytest.mark.parametrize("tk,block", [(10, 8), (130, 128)])
def test_attention_fully_masked_row_is_uniform(tk, block):
    """A row whose keys are all masked: the uniform average of V, as both
    the Pallas kernel (-1e30 bias) and the XLA path (-1e9 bias) give."""
    q, k, v, rng = _qkv(4, 2, 2, 5, tk, 8)
    mask = rng.random((2, tk)) > 0.5
    mask[0] = False
    mask[1, 0] = True
    got = tattn.masked_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), torch.from_numpy(mask)).numpy()
    want = jattn.masked_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                        jnp.asarray(mask), kv_block=block)
    want_xla = dot_product_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                     key_padding_bias(jnp.asarray(mask)))
    np.testing.assert_allclose(got, np.asarray(want), **ATTN_TOL)
    np.testing.assert_allclose(got, np.asarray(want_xla), **ATTN_TOL)
    uniform = np.broadcast_to(v[0].mean(axis=1, keepdims=True), got[0].shape)
    np.testing.assert_allclose(got[0], uniform, **ATTN_TOL)


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    telemetry.reset()
    q, k, v, _ = _qkv(5, 1, 2, 3, 4, 8)
    tattn.masked_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    mus, scales = _experts(5, (2, 3, 4))
    tpoe.poe_fused(torch.from_numpy(mus), torch.from_numpy(scales))
    assert telemetry.summary() == {"attention:plain": 1, "poe:plain": 1}
    assert telemetry.launches() == {}
    telemetry.reset()
    assert telemetry.summary() == {} and telemetry.launches() == {}


def test_wrappers_refuse_devices_other_than_cuda_and_cpu():
    q = torch.empty(1, 1, 2, 4, device="meta")
    with pytest.raises(ValueError):
        tattn.masked_attention(q, q, q)
    with pytest.raises(ValueError):
        tpoe.poe_fused(torch.empty(2, 3, device="meta"), torch.empty(2, 3, device="meta"))


def test_plain_versions_have_gradients_on_cpu():
    """CPU tensors that require grad go through the plain version (autograd
    works); only the CUDA kernels lack a backward in this slice."""
    q, k, v, _ = _qkv(6, 1, 2, 3, 4, 8)
    qt = torch.from_numpy(q).requires_grad_()
    tattn.masked_attention(qt, torch.from_numpy(k), torch.from_numpy(v)).sum().backward()
    assert qt.grad is not None and torch.isfinite(qt.grad).all()
