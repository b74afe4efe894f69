"""The port's network modules against their flax counterparts.

Weights are drawn with numpy from a seed in the flax layout (shapes from
``jax.eval_shape`` of the flax init), carried into the PyTorch module by
``bridge.load_flax_params``, and both modules see the same numpy inputs.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from multimodal_vae_comparison_tpu.models import decoders as jdec
from multimodal_vae_comparison_tpu.models import encoders as jenc
from multimodal_vae_comparison_tpu.models import nets as jnets
from multimodal_vae_comparison_tpu_torch.bridge import load_flax_params
from multimodal_vae_comparison_tpu_torch.models import decoders as tdec
from multimodal_vae_comparison_tpu_torch.models import encoders as tenc
from multimodal_vae_comparison_tpu_torch.models import nets as tnets
from test_torch_slice import one_torch_thread  # noqa: F401 (autouse)

TOL = dict(rtol=1e-4, atol=1e-5)


def flax_params(module, *args, seed=0):
    """numpy weights for ``module`` in flax's layout, drawn from ``seed``:
    kernels ~ N(0, 1/fan_in), biases ~ N(0, 0.1^2), LayerNorm scales ~ 1."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args))
    rng = np.random.default_rng(seed)

    def draw(path, s):
        leaf = path[-1].key
        if leaf == "kernel":
            fan_in = s.shape[0] if len(s.shape) == 3 else math.prod(s.shape[:-1])
            return rng.normal(0, 1 / math.sqrt(fan_in), s.shape).astype(np.float32)
        if leaf == "scale":
            return (1 + 0.1 * rng.normal(size=s.shape)).astype(np.float32)
        return (0.1 * rng.normal(size=s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def bridged(torch_module, params):
    load_flax_params(torch_module, params)
    return torch_module.eval()


def close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def _mask(rng, b, t):
    m = np.arange(t)[None, :] < rng.integers(1, t + 1, (b, 1))
    return m


@pytest.mark.parametrize("length,dim", [(12, 64), (45, 16), (7, 5)])
def test_positional_encoding(length, dim):
    close(tnets.positional_encoding(length, dim), jnets.positional_encoding(length, dim))


def test_gelu_is_flax_tanh_approximation():
    x = np.linspace(-6, 6, 101).astype(np.float32)
    close(tnets.gelu(torch.from_numpy(x)), fnn.gelu(jnp.asarray(x)))
    assert not np.allclose(torch.nn.functional.gelu(torch.from_numpy(x)).numpy(),
                           np.asarray(fnn.gelu(jnp.asarray(x))), rtol=0, atol=1e-5)


def test_layernorm_eps_is_flax_default():
    """flax LayerNorm eps is 1e-6 (torch's default 1e-5); low-variance rows
    tell the two apart."""
    x = (1e-3 * np.random.default_rng(0).normal(size=(4, 16))).astype(np.float32)
    ln = fnn.LayerNorm()
    params = flax_params(ln, jnp.asarray(x))
    got = bridged(torch.nn.LayerNorm(16, eps=tnets.LN_EPS), params)(torch.from_numpy(x))
    close(got, ln.apply(params, jnp.asarray(x)))
    layer = tnets.TransformerEncoderLayer(16, 2, 32)
    assert layer.LayerNorm_0.eps == layer.LayerNorm_1.eps == 1e-6


@pytest.mark.parametrize("tq,tk,d,heads,masked", [
    (6, 9, 16, 2, True), (45, 1, 16, 2, False), (5, 5, 64, 2, True), (4, 7, 12, 3, False)])
def test_multi_head_attention(tq, tk, d, heads, masked):
    rng = np.random.default_rng(1)
    q_in = rng.normal(size=(3, tq, d)).astype(np.float32)
    kv_in = rng.normal(size=(3, tk, d)).astype(np.float32)
    mask = _mask(rng, 3, tk) if masked else None
    jm = jnets.MultiHeadAttention(heads)
    bias = jnets.key_padding_bias(None if mask is None else jnp.asarray(mask))
    params = flax_params(jm, jnp.asarray(q_in), jnp.asarray(kv_in), bias)
    want = jm.apply(params, jnp.asarray(q_in), jnp.asarray(kv_in), bias)
    tm = bridged(tnets.MultiHeadAttention(d, heads), params)
    got = tm(torch.from_numpy(q_in), torch.from_numpy(kv_in),
             None if mask is None else torch.from_numpy(mask))
    close(got, want)


@pytest.mark.parametrize("layers", [1, 2])
@pytest.mark.parametrize("masked", [True, False])
def test_transformer_encoder(layers, masked):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(3, 10, 32)).astype(np.float32)
    mask = _mask(rng, 3, 10) if masked else None
    jmask = None if mask is None else jnp.asarray(mask)
    jm = jnets.TransformerEncoder(layers, 2, 48)
    params = flax_params(jm, jnp.asarray(x), jmask)
    want = jm.apply(params, jnp.asarray(x), jmask)
    tm = bridged(tnets.TransformerEncoder(layers, 32, 2, 48), params)
    close(tm(torch.from_numpy(x), None if mask is None else torch.from_numpy(mask)), want)


def test_transformer_encoder_layer():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 7, 16)).astype(np.float32)
    mask = _mask(rng, 2, 7)
    jm = jnets.TransformerEncoderLayer(2, 24)
    params = flax_params(jm, jnp.asarray(x), jnp.asarray(mask))
    want = jm.apply(params, jnp.asarray(x), jnp.asarray(mask))
    tm = bridged(tnets.TransformerEncoderLayer(16, 2, 24), params)
    close(tm(torch.from_numpy(x), torch.from_numpy(mask)), want)


@pytest.mark.parametrize("cin,cout,hw", [(5, 3, 4), (32, 32, 8)])
def test_conv_transpose_2d_torch(cin, cout, hw):
    """flax ConvTranspose(k4, s2, SAME) == torch ConvTranspose2d(k4, s2, p1)
    with the kernel flipped in space (bridge)."""
    x = np.random.default_rng(4).normal(size=(2, hw, hw, cin)).astype(np.float32)
    jm = jnets.ConvTranspose2dTorch(cout)
    params = flax_params(jm, jnp.asarray(x))
    want = jm.apply(params, jnp.asarray(x))
    got = bridged(tnets.ConvTranspose2dTorch(cin, cout), params)(torch.from_numpy(x))
    assert got.shape == (2, 2 * hw, 2 * hw, cout)
    close(got, want)


@pytest.mark.parametrize("data_dim", [(32, 32, 3), (64, 64, 3)])
def test_enc_cnn2(data_dim):
    """Pins the NHWC flatten before Dense_0 and the softmax+ETA head."""
    x = np.random.default_rng(5).random((2,) + data_dim).astype(np.float32)
    jm = jenc.Enc_CNN2(latent_dim=8, data_dim=data_dim)
    params = flax_params(jm, jnp.asarray(x))
    want = jm.apply(params, jnp.asarray(x))
    got = bridged(tenc.Enc_CNN2(8, data_dim), params)(torch.from_numpy(x))
    for g, w in zip(got, want):
        close(g, w)


@pytest.mark.parametrize("masked", [True, False])
def test_enc_txt_transformer(masked):
    rng = np.random.default_rng(6)
    x = np.eye(27, dtype=np.float32)[rng.integers(0, 27, (3, 12))]
    mask = _mask(rng, 3, 12) if masked else None
    jmask = None if mask is None else jnp.asarray(mask)
    jm = jenc.Enc_TxtTransformer(latent_dim=8, data_dim=(12, 27))
    params = flax_params(jm, jnp.asarray(x), jmask)
    want = jm.apply(params, jnp.asarray(x), jmask)
    tm = bridged(tenc.Enc_TxtTransformer(8, (12, 27)), params)
    got = tm(torch.from_numpy(x), None if mask is None else torch.from_numpy(mask))
    for g, w in zip(got, want):
        close(g, w)


@pytest.mark.parametrize("data_dim", [(32, 32, 3), (64, 64, 3)])
def test_dec_cnn(data_dim):
    """Pins the (B, 4, 4, C) NHWC seed, the transposed convs and the
    logit-space clip; mean, scale and logits all come out NHWC."""
    z = (3 * np.random.default_rng(7).normal(size=(2, 8))).astype(np.float32)
    jm = jdec.Dec_CNN(latent_dim=8, data_dim=data_dim)
    params = flax_params(jm, jnp.asarray(z))
    want = jm.apply(params, jnp.asarray(z))
    got = bridged(tdec.Dec_CNN(8, data_dim), params)(torch.from_numpy(z))
    assert got[0].shape == (2,) + data_dim
    for g, w in zip(got, want):
        close(g, w)


@pytest.mark.parametrize("latents,masked", [(8, True), (8, False), (7, True), (16, False)])
def test_dec_txt_transformer(latents, masked):
    """latents 16 at 2 heads: d_model 16, cross-attention Dh 8 and Tk 1;
    latents 7: d_model rounds up to 8 through Dense_0."""
    rng = np.random.default_rng(8)
    z = rng.normal(size=(3, latents)).astype(np.float32)
    mask = _mask(rng, 3, 12) if masked else None
    jmask = None if mask is None else jnp.asarray(mask)
    jm = jdec.Dec_TxtTransformer(latent_dim=latents, data_dim=(12, 27))
    params = flax_params(jm, jnp.asarray(z), jmask)
    want = jm.apply(params, jnp.asarray(z), jmask)
    tm = bridged(tdec.Dec_TxtTransformer(latents, (12, 27)), params)
    got = tm(torch.from_numpy(z), None if mask is None else torch.from_numpy(mask))
    for g, w in zip(got, want):
        close(g, w)
    if masked:
        assert not got[0].detach().numpy()[~mask].any()


def test_registries():
    assert tenc.get_encoder("CNN2") is tenc.Enc_CNN2
    assert tdec.get_decoder("TxtTransformer") is tdec.Dec_TxtTransformer
    assert tenc.get_encoder("VIT") is tenc.Enc_VIT
    with pytest.raises(KeyError):
        tenc.get_encoder("ViT")
    with pytest.raises(KeyError):
        tdec.get_decoder("nope")
