"""The VideoGPT slice of the port against the JAX package, on the CPU.

The strided block-sparse attention op (layouts, forward, gradients) against
the JAX function run through the Pallas interpreter, the sampling op's
bits -> normal map against JAX's, each new net on bridged weights, and the
whole VideoGPTSparse MOE/DReG model for loss, metrics and every gradient on
JAX's own noise, with ``remat`` on and off.  Inputs come from numpy seeds.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_vae_comparison_tpu.models import decoders as jdec
from multimodal_vae_comparison_tpu.models import encoders as jenc
from multimodal_vae_comparison_tpu.models import get_mixing as jget_mixing
from multimodal_vae_comparison_tpu.models import nets as jnets
from multimodal_vae_comparison_tpu.models.base import ModalitySpec as JSpec
from multimodal_vae_comparison_tpu.ops.pallas import sample_kernel as jsample
from multimodal_vae_comparison_tpu.ops.pallas import sparse_attention as jsparse
from multimodal_vae_comparison_tpu_torch.bridge import load_flax_params
from multimodal_vae_comparison_tpu_torch.models import decoders as tdec
from multimodal_vae_comparison_tpu_torch.models import encoders as tenc
from multimodal_vae_comparison_tpu_torch.models import nets as tnets
from multimodal_vae_comparison_tpu_torch.models.base import ModalitySpec
from multimodal_vae_comparison_tpu_torch.ops.kernels import sample_kernel as tsample
from multimodal_vae_comparison_tpu_torch.ops.kernels import sparse_attention as tsparse
from multimodal_vae_comparison_tpu_torch.ops.kernels import telemetry
from multimodal_vae_comparison_tpu_torch.training.optim import make_optimizer
from multimodal_vae_comparison_tpu_torch.training.trainer import build_model, make_train_step
from test_torch_modules import bridged, close, flax_params
from test_torch_slice import draw_params, one_torch_thread  # noqa: F401 (one_torch_thread: autouse)
from test_torch_train import _Recorder

FWD_TOL = dict(rtol=2e-4, atol=2e-5)   # as tests/test_pallas.py, forward
BWD_TOL = dict(rtol=2e-3, atol=2e-4)   # as tests/test_pallas.py, sparse backward
# per-leaf gradient tolerance of the whole model, as a fraction of the leaf's
# max |g|.  ELBO: fp32 sums in another order through ~40 layers (seen: 4e-5).
# The DReG bound exponentiates log-weights of ~-8.5e3 (a bce sum over a
# clip), whose fp32 ulp is 1e-3: the JAX package's own gradients, jitted with
# remat against unjitted without, differ by up to 4.6e-3 of a leaf's max |g|
# on this model (the GroupNorm leaves of the encoder), and the port lands
# within 5.6e-3 of the jitted ones
MODEL_GRAD_REL = {"elbo": 1e-4, "dreg": 1e-2}
LOSS_TOL = dict(rtol=1e-6, atol=1e-3)  # batch sums of ~1e4 in fp32


# -- the sparse attention op ----------------------------------------------------


@pytest.mark.parametrize("t,block,stride", [(64, 8, 2), (128, 16, 4), (96, 8, 3)])
def test_block_sparse_layouts_match_jax(t, block, stride):
    for port, ref in ((tsparse.block_sparse_layout, jsparse.block_sparse_layout),
                      (tsparse.block_sparse_layout_T, jsparse.block_sparse_layout_T)):
        for got, want in zip(port(t, block, stride), ref(t, block, stride)):
            assert got.dtype == np.int32
            np.testing.assert_array_equal(got, np.asarray(want))
    with pytest.raises(ValueError):
        tsparse.block_sparse_layout(t + 1, block, stride)


def _qkv(seed, shape):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(4)]


@pytest.mark.parametrize("shape,block,stride", [((2, 2, 64, 8), 8, 2),
                                                ((2, 1, 96, 8), 8, 3)])
def test_sparse_attention_forward_and_grads_match_jax(monkeypatch, shape, block, stride):
    """The port's op (plain version on the CPU, dense recompute backward)
    against the JAX op with its Pallas kernels interpreted."""
    monkeypatch.setattr(jsparse, "_INTERPRET", True)
    q, k, v, ct = _qkv(0, shape)

    def f(q_, k_, v_):
        return jsparse.strided_block_sparse_attention(
            q_, k_, v_, block=block, block_stride=stride)

    want, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v)))
    want_grads = vjp(jnp.asarray(ct))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    telemetry.reset()
    got = tsparse.strided_block_sparse_attention(tq, tk, tv, block=block,
                                                 block_stride=stride)
    got.backward(torch.from_numpy(ct))
    assert telemetry.summary() == {"sparse_attention:plain": 1,
                                   "sparse_attention_bwd:plain": 1}
    assert telemetry.launches() == {}
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **FWD_TOL)
    for g, w in zip((tq.grad, tk.grad, tv.grad), want_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **BWD_TOL)


@pytest.mark.parametrize("shape,block,stride", [((1, 2, 64, 16), 8, 2),
                                                ((2, 1, 48, 4), 16, 1),
                                                ((1, 1, 16, 8), 16, 4)])
def test_sparse_attention_reference_matches_jax_reference(shape, block, stride):
    q, k, v, _ = _qkv(1, shape)
    want = jsparse._reference_block_sparse(*(jnp.asarray(x) for x in (q, k, v)),
                                           block, stride)
    got = tsparse.sparse_attention_reference(*(torch.from_numpy(x) for x in (q, k, v)),
                                             block, stride)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)


def test_sparse_attention_rejects_bad_shapes():
    q = torch.zeros(1, 1, 12, 4)
    with pytest.raises(ValueError, match="multiple of block"):
        tsparse.strided_block_sparse_attention(q, q, q, block=8)
    with pytest.raises(ValueError):
        tsparse.strided_block_sparse_attention(q, q[:, :, :8], q, block=4)
    # what the CUDA launch refuses is checked before any pointer is taken
    ok = torch.zeros(1, 1, 16, 4)
    for bad, kwargs in ((ok.double(), {}), (ok.transpose(2, 3), dict(block=4)),
                        (torch.zeros(1, 1, 16, 65), {}), (ok, dict(block=256)),
                        (ok, dict(block_stride=0))):
        args = dict(block=8, block_stride=2)
        args.update(kwargs)
        with pytest.raises((TypeError, ValueError)):
            tsparse._check(bad, bad, bad, **args)


# -- the sampling op --------------------------------------------------------------


def test_boxmuller_from_bits_matches_jax():
    """The same uint32 bits, the sign bit set in half of them, through both
    maps; the signed view of the same bits gives the same normals."""
    rng = np.random.default_rng(0)
    signed = rng.integers(-2**31, 2**31, size=(64, 128), dtype=np.int64).astype(np.int32)
    assert (signed < 0).mean() > 0.3
    bits_b = rng.integers(0, 2**32, size=(64, 128), dtype=np.uint64).astype(np.uint32)
    want = np.asarray(jsample._boxmuller_from_bits(jnp.asarray(signed.view(np.uint32)),
                                                   jnp.asarray(bits_b)))
    b64 = torch.from_numpy(bits_b.astype(np.int64))
    for a in (torch.from_numpy(signed), torch.from_numpy(signed.view(np.uint32).astype(np.int64))):
        got = tsample.boxmuller_from_bits(a, b64).numpy()
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_philox_known_answers():
    """The Random123 known-answer vectors of Philox4x32-10."""
    pi = ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344), (0xa4093822, 0x299f31d0))
    for (ctr, key), want in (
            (((0,) * 4, (0, 0)), (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
            (((0xffffffff,) * 4, (0xffffffff,) * 2),
             (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
            (pi, (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1))):
        assert tsample.philox4x32_10(ctr, key) == want
        as_tensor = tuple(torch.tensor([c], dtype=torch.int64) for c in ctr)
        assert tuple(int(x) for x in tsample.philox4x32_10(as_tensor, key)) == want


def test_sample_normal_fused_moments_seeds_and_backward():
    mu = torch.full((1024, 128), 2.0, requires_grad=True)
    scale = torch.full((1024, 128), 0.5, requires_grad=True)
    telemetry.reset()
    z = tsample.sample_normal_fused(mu, scale, 7)
    assert telemetry.summary() == {"sample:plain": 1} and telemetry.launches() == {}
    assert z.shape == mu.shape and torch.isfinite(z).all()
    assert abs(z.mean().item() - 2.0) < 0.01 and abs(z.std().item() - 0.5) < 0.01
    upstream = torch.from_numpy(np.random.default_rng(1).normal(
        size=z.shape).astype(np.float32))
    z.backward(upstream)
    eps = (z.detach() - 2.0) / 0.5
    torch.testing.assert_close(mu.grad, upstream)
    torch.testing.assert_close(scale.grad, upstream * eps, rtol=1e-4, atol=1e-5)
    again = tsample.sample_normal_fused(mu.detach(), scale.detach(), 7)
    other = tsample.sample_normal_fused(mu.detach(), scale.detach(), 8)
    high = tsample.sample_normal_fused(mu.detach(), scale.detach(), 7 + (1 << 32))
    assert torch.equal(again, z.detach())
    assert not torch.equal(other, z.detach()) and not torch.equal(high, z.detach())
    with pytest.raises(ValueError, match="seed"):
        tsample.sample_normal_fused(mu.detach(), scale.detach(), -1)


# -- the nets -----------------------------------------------------------------------


def _volume(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("kernel,strides,shape", [
    (4, (1, 2, 2), (2, 3, 8, 8, 3)),     # the encoder's down-sampling conv
    (4, (1, 2, 2), (1, 2, 7, 5, 3)),     # odd extents under stride 2
    (3, (1, 1, 1), (2, 3, 4, 4, 8)),     # the residual blocks' convs
    (1, (1, 1, 1), (2, 3, 4, 4, 8)),
])
def test_same_pad_conv3d(kernel, strides, shape):
    """flax SAME padding of kernel 4 is (1, 2) on a stride-1 axis."""
    x = _volume(0, shape)
    jm = jnets.SamePadConv3d(6, kernel=kernel, strides=strides)
    params = flax_params(jm, jnp.asarray(x))
    want = jm.apply(params, jnp.asarray(x))
    tm = bridged(tnets.SamePadConv3d(shape[-1], 6, kernel=kernel, strides=strides), params)
    got = tm(torch.from_numpy(x))
    assert got.shape == want.shape
    close(got, want)


@pytest.mark.parametrize("kernel,strides", [(4, (1, 2, 2)), (4, (2, 2, 2)), (3, (1, 1, 1))])
def test_same_pad_conv_transpose3d(kernel, strides):
    """flax ConvTranspose SAME: size * stride out, the kernel not flipped,
    and for kernel 4 at stride 1 one slice more cut at the end than the start."""
    x = _volume(1, (2, 3, 4, 4, 5))
    jm = jnets.SamePadConvTranspose3d(6, kernel=kernel, strides=strides)
    params = flax_params(jm, jnp.asarray(x))
    want = jm.apply(params, jnp.asarray(x))
    tm = bridged(tnets.SamePadConvTranspose3d(5, 6, kernel=kernel, strides=strides), params)
    got = tm(torch.from_numpy(x))
    assert got.shape == want.shape == (2, 3 * strides[0], 4 * strides[1], 4 * strides[2], 6)
    close(got, want)


@pytest.mark.parametrize("channels,groups", [(64, 8), (12, 4), (3, 1)])
def test_group_norm(channels, groups):
    """gcd(8, C) groups, eps 1e-6 (low-variance input tells it from 1e-5),
    channels last."""
    x = 1e-3 * _volume(2, (2, 3, 4, 4, channels))

    class Wrap(jnets.nn.Module):
        @jnets.nn.compact
        def __call__(self, x):
            return jnets.group_norm(x)

    params = flax_params(Wrap(), jnp.asarray(x))
    want = Wrap().apply(params, jnp.asarray(x))
    tm = tnets.GroupNorm(channels)
    assert tm.num_groups == groups and tm.eps == 1e-6
    load_flax_params(tm, params["params"]["GroupNorm_0"])
    close(tm(torch.from_numpy(x)), want)


def test_strided_sparse_self_attention_pads_to_a_block_multiple():
    """T = 21 with block 8: padded to 24 inside, 21 rows out."""
    x = _volume(3, (2, 21, 16))
    jm = jnets.StridedSparseSelfAttention(num_heads=2, block=8, block_stride=2)
    params = flax_params(jm, jnp.asarray(x))
    want = jm.apply(params, jnp.asarray(x))
    tm = bridged(tnets.StridedSparseSelfAttention(16, 2, block=8, block_stride=2), params)
    got = tm(torch.from_numpy(x))
    assert got.shape == (2, 21, 16)
    close(got, want)


def test_axial_attention():
    x = _volume(4, (2, 3, 4, 5, 16))
    jm = jnets.AxialAttention(num_heads=2)
    params = flax_params(jm, jnp.asarray(x))
    want = jm.apply(params, jnp.asarray(x))
    close(bridged(tnets.AxialAttention(16, 2), params)(torch.from_numpy(x)), want)


@pytest.mark.parametrize("name,kwargs", [
    ("AttentionResidualBlock", {}),
    ("SparseAttentionResidualBlock", dict(block=16, block_stride=2)),
])
def test_attention_residual_blocks(name, kwargs):
    """(2, 3, 4, 4, 16): 48 tokens, three sparse blocks of 16, T slowest."""
    x = _volume(5, (2, 3, 4, 4, 16))
    jm = getattr(jnets, name)(16, **kwargs)
    params = flax_params(jm, jnp.asarray(x))
    want = jm.apply(params, jnp.asarray(x))
    close(bridged(getattr(tnets, name)(16, **kwargs), params)(torch.from_numpy(x)), want)


def test_enc_dec_fnn():
    x = np.random.default_rng(6).random((3, 4, 6)).astype(np.float32)
    je = jenc.Enc_FNN(latent_dim=8, data_dim=(4, 6))
    params = flax_params(je, jnp.asarray(x))
    got = bridged(tenc.Enc_FNN(8, (4, 6)), params)(torch.from_numpy(x))
    for g, w in zip(got, je.apply(params, jnp.asarray(x))):
        close(g, w)
    z = (3 * np.random.default_rng(7).normal(size=(3, 8))).astype(np.float32)
    jd = jdec.Dec_FNN(latent_dim=8, data_dim=(4, 6))
    params = flax_params(jd, jnp.asarray(z))
    got = bridged(tdec.Dec_FNN(8, (4, 6)), params)(torch.from_numpy(z))
    assert len(got) == 3 and got[0].shape == (3, 4, 6)
    for g, w in zip(got, jd.apply(params, jnp.asarray(z))):
        close(g, w)


@pytest.mark.parametrize("name", ["VideoGPT", "VideoGPTSparse"])
def test_enc_videogpt(name):
    """(2, 16, 16, 3) clips, two layers, hidden 16: 2 * 4 * 4 = 32 tokens."""
    x = np.random.default_rng(8).random((2, 2, 16, 16, 3)).astype(np.float32)
    kwargs = dict(n_res_layers=2, hidden=16)
    jm = getattr(jenc, f"Enc_{name}")(latent_dim=8, data_dim=(2, 16, 16, 3), **kwargs)
    params = flax_params(jm, jnp.asarray(x))
    want = jm.apply(params, jnp.asarray(x))
    tm = bridged(getattr(tenc, f"Enc_{name}")(8, (2, 16, 16, 3), **kwargs), params)
    for g, w in zip(tm(torch.from_numpy(x)), want):
        close(g, w)


@pytest.mark.parametrize("name", ["VideoGPT", "VideoGPTSparse"])
def test_dec_videogpt(name):
    """Returns probabilities and no logits: the bce probability path."""
    z = np.random.default_rng(9).normal(size=(2, 8)).astype(np.float32)
    kwargs = dict(n_res_layers=2, hidden=16)
    jm = getattr(jdec, f"Dec_{name}")(latent_dim=8, data_dim=(2, 16, 16, 3), **kwargs)
    params = flax_params(jm, jnp.asarray(z))
    want = jm.apply(params, jnp.asarray(z))
    tm = bridged(getattr(tdec, f"Dec_{name}")(8, (2, 16, 16, 3), **kwargs), params)
    got = tm(torch.from_numpy(z))
    assert len(got) == len(want) == 2 and got[0].shape == (2, 2, 16, 16, 3)
    for g, w in zip(got, want):
        close(g, w)


def test_registries_hold_the_video_nets():
    for name in ("FNN", "VideoGPT", "VideoGPTSparse"):
        assert tenc.get_encoder(name).__name__ == f"Enc_{name}"
        assert tdec.get_decoder(name).__name__ == f"Dec_{name}"


# -- the whole model ----------------------------------------------------------------

CLIP = (2, 32, 32, 3)   # 2 * 8 * 8 = 128 tokens = one sparse block
N_LATENTS, K, BATCH = 8, 2, 2


def _spec_kwargs():
    return (dict(name="mod_1", encoder="VideoGPTSparse", decoder="VideoGPTSparse",
                 feature_dims=CLIP, mod_type="frames", recon_loss="bce"),
            dict(name="mod_2", encoder="FNN", decoder="FNN", feature_dims=(9,),
                 mod_type="actions", recon_loss="bce"))


def _numpy_batch(seed):
    rng = np.random.default_rng(seed)
    return {"mod_1": {"data": rng.random((BATCH,) + CLIP).astype(np.float32), "masks": None},
            "mod_2": {"data": rng.random((BATCH, 9)).astype(np.float32), "masks": None}}


def _torch_batch(batch):
    return {n: {"data": torch.from_numpy(m["data"]), "masks": None}
            for n, m in batch.items()}


def _port_model(params, obj="dreg", remat=False):
    model = build_model(tuple(ModalitySpec(**k) for k in _spec_kwargs()), "moe",
                        N_LATENTS, obj=obj, K=K, device="cpu", remat=remat)
    load_flax_params(model, params)
    return model


@functools.lru_cache(maxsize=None)
def _jax_video_model(obj):
    """The JAX VideoGPTSparse MOE model (remat on, as its bench builds it) on
    numpy-drawn weights: loss, metrics, gradients and its own draws."""
    monkeypatch = pytest.MonkeyPatch()
    try:
        rec = _Recorder(monkeypatch)
        jmodel = jget_mixing("moe")(specs=tuple(JSpec(**k) for k in _spec_kwargs()),
                                    n_latents=N_LATENTS, obj=obj, K=K, remat=True)
        batch = _numpy_batch(1)
        jb = jax.tree_util.tree_map(jnp.asarray, batch)
        shapes = jax.eval_shape(lambda: jmodel.init(
            {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)}, jb,
            method=jmodel.objective))
        params = draw_params(shapes, 0)

        def loss_fn(p):
            rec.draws.clear()
            loss, metrics = jmodel.apply(p, jb, rngs={"sample": jax.random.PRNGKey(5)},
                                         method=jmodel.objective)
            return loss, (metrics, list(rec.draws))

        (loss, (metrics, draws)), grads = jax.jit(
            jax.value_and_grad(loss_fn, has_aux=True))(params)
    finally:
        monkeypatch.undo()
    eps = {f"mod_{i + 1}": torch.from_numpy(np.array(d)) for i, d in enumerate(draws)}
    to_numpy = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
    return dict(params=params, batch=batch, eps=eps, loss=float(loss),
                metrics=to_numpy(metrics), grads=to_numpy(grads))


@pytest.fixture(scope="module")
def jax_video_model():
    return _jax_video_model("dreg")


def test_bridge_consumes_every_leaf_of_the_video_model(jax_video_model):
    params = jax_video_model["params"]
    model = _port_model(params)
    n_leaves = len(jax.tree_util.tree_leaves(params))
    assert n_leaves == len(list(model.parameters()))
    assert sum(x.size for x in jax.tree_util.tree_leaves(params)) \
        == sum(p.numel() for p in model.parameters())
    # a conv kernel and a transposed-conv kernel, spot-checked against the rules
    k = np.asarray(params["params"]["enc_mod_1"]["SamePadConv3d_0"]["Conv_0"]["kernel"])
    np.testing.assert_array_equal(
        model.enc_mod_1.SamePadConv3d_0.Conv_0.weight.detach().numpy(),
        k.transpose(4, 3, 0, 1, 2))
    k = np.asarray(params["params"]["dec_mod_1"]["SamePadConvTranspose3d_1"]
                   ["ConvTranspose_0"]["kernel"])
    np.testing.assert_array_equal(
        model.dec_mod_1.SamePadConvTranspose3d_1.ConvTranspose_0.weight.detach().numpy(),
        k[::-1, ::-1, ::-1].transpose(3, 4, 0, 1, 2))


# sparse forward dispatches per objective: the encoder's four blocks and the
# decoder's four, under DReG the decoder's four once more in its
# gradient-free first pass; remat reruns in the backward those that ran
# with gradients on
@pytest.mark.parametrize("obj,remat,forwards", [("elbo", False, 8), ("dreg", False, 12),
                                                ("dreg", True, 20)])
def test_video_model_loss_metrics_and_grads_match_jax(obj, remat, forwards):
    ref = _jax_video_model(obj)
    model = _port_model(ref["params"], obj, remat=remat)
    telemetry.reset()
    loss, metrics = model.objective(_torch_batch(ref["batch"]), eps=ref["eps"])
    loss.backward()
    sparse = {k: n for k, n in telemetry.summary().items() if k.startswith("sparse")}
    assert sparse == {"sparse_attention:plain": forwards, "sparse_attention_bwd:plain": 8}
    np.testing.assert_allclose(loss.item(), ref["loss"], **LOSS_TOL)
    assert sorted(metrics) == sorted(ref["metrics"])
    for name in metrics:
        np.testing.assert_allclose(metrics[name].item(), float(ref["metrics"][name]),
                                   **LOSS_TOL)
    want = _port_model(ref["grads"], obj)
    for (name, p), g in zip(model.named_parameters(), want.parameters()):
        got = torch.zeros_like(p) if p.grad is None else p.grad
        err = (got - g).abs().max().item()
        limit = MODEL_GRAD_REL[obj] * g.abs().max().item() + 1e-6
        assert err <= limit, f"{name}: max abs error {err:.3e} > {limit:.3e}"


def test_video_model_trains_through_the_entry_points(jax_video_model):
    """build_model -> make_optimizer -> make_train_step with remat: a few
    adam steps on one batch lower the loss."""
    model = build_model(tuple(ModalitySpec(**k) for k in _spec_kwargs()), "moe",
                        N_LATENTS, obj="dreg", K=K, device="cpu", remat=True)
    assert model.remat
    step = make_train_step(model, make_optimizer("adam", 1e-3, model.parameters()))
    batch = _torch_batch(jax_video_model["batch"])
    losses = [step(batch, eps=jax_video_model["eps"])["loss"].item() for _ in range(4)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


def test_video_model_in_float64_is_a_finer_reference_of_the_same_function():
    """``model.double()`` keeps float64 from the nets through the loss (no
    cast back to fp32 inside), so it can referee fp32 runs."""
    model = build_model(tuple(ModalitySpec(**k) for k in _spec_kwargs()), "moe",
                        N_LATENTS, obj="dreg", K=K, device="cpu")
    batch = _torch_batch(_numpy_batch(2))
    rng = np.random.default_rng(3)
    eps = {n: torch.from_numpy(rng.standard_normal((K, BATCH, N_LATENTS)).astype(np.float32))
           for n in ("mod_1", "mod_2")}
    loss32, _ = model.objective(batch, eps=eps)
    loss32.backward()
    g32 = model.dec_mod_1.upsample_lin.weight.grad.clone()
    model = model.double()
    model.zero_grad()
    loss64, metrics = model.objective(
        {n: {"data": m["data"].double(), "masks": None} for n, m in batch.items()},
        eps={n: e.double() for n, e in eps.items()})
    loss64.backward()
    assert loss64.dtype == torch.float64
    assert all(v.dtype == torch.float64 for k, v in metrics.items()
               if k.startswith("reconstruction_loss"))
    np.testing.assert_allclose(loss32.item(), loss64.item(), rtol=1e-6)
    g64 = model.dec_mod_1.upsample_lin.weight.grad
    assert g64.dtype == torch.float64
    assert (g32 - g64).abs().max().item() <= MODEL_GRAD_REL["dreg"] * g64.abs().max().item()
