"""The pieces of the JAX package that no config reaches, in the port against
the JAX package, on the CPU: the Bernoulli family, ``kl_divergence``'s
Monte-Carlo branch, ``sample_posterior``'s ``K``, the nets ``GroupNormMod``,
``MLP``, ``MultiTransformer``, ``ResidualBlock1dConv`` and
``ResidualFeatureCompressor``, ``eval/cca.py`` (the port's own CCA, held to
sklearn's, which the JAX module calls) and ``eval/text_embeddings.py``.
Each takes the same inputs, weights (through ``bridge.load_flax_params``)
and draws in both packages.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn.cross_decomposition import CCA as SklearnCCA

from multimodal_vae_comparison_tpu.eval import cca as jcca
from multimodal_vae_comparison_tpu.eval import text_embeddings as jtext
from multimodal_vae_comparison_tpu.models import distributions as jdist
from multimodal_vae_comparison_tpu.models import get_mixing as jget_mixing
from multimodal_vae_comparison_tpu.models import nets as jnets
from multimodal_vae_comparison_tpu.models.base import ModalitySpec as JSpec
from multimodal_vae_comparison_tpu_torch.bridge import load_flax_params
from multimodal_vae_comparison_tpu_torch.eval import cca
from multimodal_vae_comparison_tpu_torch.eval import text_embeddings
from multimodal_vae_comparison_tpu_torch.models import distributions as tdist
from multimodal_vae_comparison_tpu_torch.models import get_mixing, nets
from multimodal_vae_comparison_tpu_torch.models.base import ModalitySpec
from test_torch_slice import one_torch_thread  # noqa: F401 (autouse)

TOL = dict(rtol=1e-5, atol=1e-6)            # elementwise fp32 terms
OUT_TOL = dict(rtol=1e-4, atol=1e-5)        # a net's output, fp32 sums in another order
GRAD_REL, GRAD_ATOL = 1e-4, 1e-5            # per leaf, of its max |g|


def _normal_pair(seed, shape):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape).astype(np.float32),
            rng.uniform(0.2, 2.0, shape).astype(np.float32))


# -- distributions -------------------------------------------------------------


def test_bernoulli_log_prob_and_get_dist_match_jax():
    rng = np.random.default_rng(0)
    probs = rng.uniform(0, 1, (5, 7)).astype(np.float32)
    probs[0, :2] = (0.0, 1.0)     # clipped to [ETA, 1 - ETA] in both
    x = (rng.uniform(size=(5, 7)) > 0.5).astype(np.float32)
    got = tdist.get_dist("Bernoulli")(torch.from_numpy(probs))
    want = jdist.get_dist("bernoulli")(jnp.asarray(probs))
    np.testing.assert_allclose(got.log_prob(torch.from_numpy(x)).numpy(),
                               np.asarray(want.log_prob(jnp.asarray(x))), **TOL)
    assert torch.equal(got.mean, torch.from_numpy(probs))
    assert sorted(tdist.DIST_MAP) == sorted(jdist.DIST_MAP)


@pytest.mark.parametrize("fam1,fam2", [("laplace", "normal"), ("normal", "laplace")])
def test_monte_carlo_kl_between_families_matches_jax(fam1, fam2):
    """The reference's estimate over 100 draws of the first distribution,
    the port fed the same draws (the standard normal, or the Laplace's
    uniform, that JAX draws from its key)."""
    loc, scale = _normal_pair(1, (3, 4))
    loc2, scale2 = _normal_pair(2, (3, 4))
    j1 = jdist.get_dist(fam1)(jnp.asarray(loc), jnp.asarray(scale))
    j2 = jdist.get_dist(fam2)(jnp.asarray(loc2), jnp.asarray(scale2))
    key = jax.random.PRNGKey(3)
    want = np.asarray(jdist.kl_divergence(j1, j2, key=key))
    if fam1 == "laplace":
        eps = jax.random.uniform(key, (100, 3, 4), minval=-0.5 + 1e-7, maxval=0.5 - 1e-7)
    else:
        eps = jax.random.normal(key, (100, 3, 4))
    t1 = tdist.get_dist(fam1)(torch.from_numpy(loc), torch.from_numpy(scale))
    t2 = tdist.get_dist(fam2)(torch.from_numpy(loc2), torch.from_numpy(scale2))
    got = tdist.kl_divergence(t1, t2, eps=torch.from_numpy(np.asarray(eps)))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # from a generator: the mean over n_mc of the generator's draws
    drawn = tdist.kl_divergence(t1, t2, generator=torch.Generator().manual_seed(0), n_mc=7)
    z = t1.rsample((7,), generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(drawn, (t1.log_prob(z) - t2.log_prob(z)).mean(0))


def test_sample_posterior_takes_k_draws_as_jax():
    specs = (JSpec(name="mod_1", encoder="FNN", decoder="FNN", feature_dims=(6,)),)
    jmodel = jget_mixing("poe")(specs=specs + (JSpec(name="mod_2", encoder="FNN",
                                                     decoder="FNN", feature_dims=(4,)),),
                                n_latents=5, K=2)
    model = get_mixing("poe")(tuple(ModalitySpec(name=s.name, encoder="FNN", decoder="FNN",
                                                 feature_dims=d)
                                    for s, d in zip(jmodel.specs, ((6,), (4,)))),
                              5, K=2, device="cpu")
    mu, scale = _normal_pair(4, (3, 5))
    key = jax.random.PRNGKey(9)
    for K in (None, 4):
        jq, jz = jmodel.sample_posterior(jmodel.specs[0], (jnp.asarray(mu), jnp.asarray(scale)),
                                         key, K=K)
        eps = jax.random.normal(key, (K or 2, 3, 5))
        q, z = model.sample_posterior(model.specs[0], (torch.from_numpy(mu),
                                                       torch.from_numpy(scale)),
                                      eps=torch.from_numpy(np.asarray(eps)), K=K)
        assert tuple(z.shape) == (K or 2, 3, 5)
        np.testing.assert_allclose(z.numpy(), np.asarray(jz), **TOL)
        np.testing.assert_allclose(q.loc.numpy(), np.asarray(jq.loc))
    with pytest.raises(ValueError, match="expected"):
        model.sample_posterior(model.specs[0], (torch.from_numpy(mu), torch.from_numpy(scale)),
                               eps=torch.zeros(2, 3, 5), K=3)


# -- the nets ----------------------------------------------------------------------


def _mask(rng, b, t):
    return np.arange(t)[None, :] < rng.integers(1, t + 1, (b, 1))


# (name, JAX module, port module, input shape, takes a mask)
NETS = {
    "GroupNormMod": (lambda: jnets.GroupNormMod(), lambda: nets.GroupNormMod(12),
                     (2, 5, 12), False),
    "MLP": (lambda: jnets.MLP(features=(16, 8, 3)), lambda: nets.MLP(6, (16, 8, 3)),
            (4, 6), False),
    "MLP-activate-final": (lambda: jnets.MLP(features=(16, 3), activate_final=True),
                           lambda: nets.MLP(6, (16, 3), activate_final=True), (4, 6), False),
    "MultiTransformer": (lambda: jnets.MultiTransformer(latent_dim=16, ff_size=32),
                         lambda: nets.MultiTransformer(6, 16, ff_size=32), (3, 4, 6), True),
    "MultiTransformer-decoder": (
        lambda: jnets.MultiTransformer(latent_dim=16, ff_size=32, use_decoder=True,
                                       zero_masking=True, output_mean=False),
        lambda: nets.MultiTransformer(6, 16, ff_size=32, use_decoder=True, zero_masking=True,
                                      output_mean=False), (3, 4, 6), False),
    "MultiTransformer-tokens": (
        lambda: jnets.MultiTransformer(latent_dim=16, ff_size=32, use_ml_layers=False,
                                       pos_encoding=False),
        lambda: nets.MultiTransformer(6, 16, ff_size=32, use_ml_layers=False,
                                      pos_encoding=False), (3, 4, 6), True),
    "ResidualBlock1dConv": (
        lambda: jnets.ResidualBlock1dConv(channels_out=16, kernel=3, strides=2),
        lambda: nets.ResidualBlock1dConv(8, 16, kernel=3, strides=2), (2, 9, 8), False),
    "ResidualBlock1dConv-same": (lambda: jnets.ResidualBlock1dConv(channels_out=8, kernel=3),
                                 lambda: nets.ResidualBlock1dConv(8, 8, kernel=3),
                                 (2, 7, 8), False),
    "ResidualFeatureCompressor": (
        lambda: jnets.ResidualFeatureCompressor(out_style=8, out_content=16),
        lambda: nets.ResidualFeatureCompressor(16, 8, 16), (2, 5, 16), False),
}


@pytest.mark.parametrize("name", sorted(NETS))
def test_net_outputs_and_every_gradient_match_jax(name):
    """Output and the input and weight gradients of a random cotangent, the
    port's weights bridged from the JAX module's init."""
    make_j, make_t, shape, masked = NETS[name]
    rng = np.random.default_rng(0)
    x = rng.normal(size=shape).astype(np.float32)
    if name == "MultiTransformer-decoder":
        x[0, 2:] = 0.0               # padded modality tokens: zero_masking masks them
    mask = _mask(rng, shape[0], shape[1]) if masked else None
    jm = make_j()
    args = (jnp.asarray(x),) + ((jnp.asarray(mask),) if masked else ())
    params = jax.jit(jm.init)(jax.random.PRNGKey(1), *args)
    model = make_t()
    load_flax_params(model, jax.tree_util.tree_map(np.asarray, params))

    def jfn(p, xx):
        return jm.apply(p, xx, *args[1:])

    shapes = jax.eval_shape(jfn, params, args[0])
    single = not isinstance(shapes, tuple)
    cots = tuple(rng.normal(size=o.shape).astype(np.float32)
                 for o in ((shapes,) if single else shapes))

    @jax.jit
    def out_and_vjp(p, xx, c):
        out, vjp = jax.vjp(jfn, p, xx)
        return out, vjp(c[0] if single else c)

    jout, (jgp, jgx) = out_and_vjp(params, args[0], cots)
    jouts = (jout,) if single else jout

    xt = torch.from_numpy(x).requires_grad_()
    out = model(xt, torch.from_numpy(mask)) if masked else model(xt)
    outs = out if isinstance(out, tuple) else (out,)
    for o, jo in zip(outs, jouts):
        np.testing.assert_allclose(o.detach().numpy(), np.asarray(jo), **OUT_TOL)
    torch.autograd.backward(outs, tuple(torch.from_numpy(c) for c in cots))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), **OUT_TOL)
    want = make_t()
    load_flax_params(want, jax.tree_util.tree_map(np.asarray, jgp))
    for (pname, p), g in zip(model.named_parameters(), want.parameters()):
        err = (p.grad - g).abs().max().item()
        limit = GRAD_REL * g.abs().max().item() + GRAD_ATOL
        assert err <= limit, f"{pname}: max abs error {err:.3e} > {limit:.3e}"


def test_every_jax_net_has_its_port():
    """Every module class of the JAX nets module has a port of the same name
    in the port's nets (the ported CUDA attention aside, whose module is
    ``MultiHeadAttention`` in both)."""
    import flax.linen as fnn
    jax_nets = {n for n, c in vars(jnets).items()
                if isinstance(c, type) and issubclass(c, fnn.Module)
                and c.__module__ == jnets.__name__}
    missing = sorted(n for n in jax_nets if not hasattr(nets, n))
    assert not missing, missing


# -- eval ------------------------------------------------------------------------------


@pytest.mark.parametrize("n,p,q,k", [(64, 8, 8, 4), (100, 5, 7, 3), (40, 6, 6, 6)])
def test_cca_is_sklearns(n, p, q, k):
    """The port's CCA against sklearn's (which the JAX module calls) on the
    same float32 latents: fit and transform to the bit (the same algorithm
    and the same LAPACK calls through scipy)."""
    rng = np.random.default_rng(n)
    a = rng.normal(size=(n, p)).astype(np.float32)
    b = np.concatenate([a[:, :min(p, q)], rng.normal(size=(n, max(q - p, 0)))], 1)
    b = (b[:, :q] + 0.5 * rng.normal(size=(n, q))).astype(np.float32)
    want = SklearnCCA(n_components=k, max_iter=1000).fit_transform(a, b)
    got = cca.CCA(n_components=k, max_iter=1000).fit_transform(a, b)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-12, atol=1e-12)


def _fake_exp(latents, tensor):
    """An eval handle whose forward gives each modality's posterior mean."""
    names = tuple(latents)

    def forward(batch, present):
        mods = {n: types.SimpleNamespace(
            encoder_dist=types.SimpleNamespace(loc=tensor(latents[n])), joint_dist=None)
            for n in names}
        return types.SimpleNamespace(mods=mods)

    return types.SimpleNamespace(
        mod_names=names, datamod=types.SimpleNamespace(n_val=len(latents[names[0]])),
        get_test_samples=lambda n: ({m: None for m in names}, None), forward=forward)


def test_latent_cca_correlation_matches_jax():
    rng = np.random.default_rng(5)
    shared = rng.normal(size=(80, 3))
    latents = {f"mod_{i}": np.concatenate([shared, rng.normal(size=(80, 5))], 1)
               .astype(np.float32) + 0.3 * rng.normal(size=(80, 8)).astype(np.float32)
               for i in (1, 2, 3)}
    want = jcca.latent_cca_correlation(_fake_exp(latents, jnp.asarray), n=80)
    got = cca.latent_cca_correlation(_fake_exp(latents, torch.from_numpy), n=80)
    assert sorted(got) == sorted(want) == ["cca_mod_1_mod_2", "cca_mod_1_mod_3",
                                           "cca_mod_2_mod_3"]
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12)
        assert 0.5 < got[k] <= 1.0


def test_text_embeddings_match_jax():
    rng = np.random.default_rng(2)
    words = ["big", "small", "red", "green", "blue", "square", "heart", "ellipse", "at",
             "top", "bottom", "left", "right"]
    gt = [" ".join(rng.choice(words, 6)) for _ in range(40)]
    recon = [" ".join(rng.choice(words, 6)) for _ in range(40)]
    for kw in (dict(dim=16), dict(dim=64, window=2, min_occur=2)):
        j = jtext.SIFEmbeddings(**kw).fit(gt)
        t = text_embeddings.SIFEmbeddings(**kw).fit(gt)
        assert t.vocab == j.vocab
        np.testing.assert_array_equal(t.embed(recon), j.embed(recon))
        assert t.similarity(gt[0], recon[0]) == j.similarity(gt[0], recon[0])
    assert (text_embeddings.text_embedding_analysis(gt, recon, dim=16)
            == jtext.text_embedding_analysis(gt, recon, dim=16))
