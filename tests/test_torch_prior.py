"""The mixture-of-Gaussians prior of the port (``prior_components > 1``)
against the JAX package, on the CPU.

``MixtureNormal`` (its joint ``log_prob``, its sampler on JAX's replayed
component index and eps, ``log_prob_joint``), ``kl_divergence``'s raise
for the mixed pair, the ``pz_mog_*`` parameters through the bridge, ``sample_pz``'s mixture draw,
and the objective with every gradient of each mixing class under the
mixture prior, at the narrow widths of ``tests/test_mixture_prior.py`` with
C = 4.  The port is fed JAX's own draws (the JAX ``Normal.rsample``
patched to keep them) and, for DReG, JAX's importance weights.

Tolerances: elementwise terms within rtol/atol 1e-5; loss and metrics as
the training slice's; every gradient within 1e-4 of its leaf's max |g| +
1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_vae_comparison_tpu.models import distributions as jdist
from multimodal_vae_comparison_tpu.models import get_mixing as jget_mixing
from multimodal_vae_comparison_tpu.models.base import ModalitySpec as JSpec
from multimodal_vae_comparison_tpu_torch.bridge import load_flax_params
from multimodal_vae_comparison_tpu_torch.models import distributions as tdist
from multimodal_vae_comparison_tpu_torch.models import get_mixing, objectives
from multimodal_vae_comparison_tpu_torch.models.base import ModalitySpec
from multimodal_vae_comparison_tpu_torch.training.trainer import build_model
from test_torch_slice import draw_params, one_torch_thread  # noqa: F401 (one_torch_thread: autouse)
from test_torch_zoo import _Recorder, _jit

TOL = dict(rtol=1e-5, atol=1e-5)
LOSS_TOL = dict(rtol=1e-6, atol=1e-3)
GRAD_REL, GRAD_ATOL = 1e-4, 1e-5
C, D, B = 4, 6, 6


def _spec_kwargs(private=None):
    return (dict(name="mod_1", encoder="FNN", decoder="FNN", feature_dims=(8, 8, 3),
                 mod_type="image", recon_loss="bce", private_latents=private),
            dict(name="mod_2", encoder="TxtTransformer", decoder="TxtTransformer",
                 feature_dims=(5, 9), mod_type="text", recon_loss="category_ce",
                 has_masks=True, private_latents=private))


def _numpy_batch(seed):
    rng = np.random.default_rng(seed)
    txt = np.eye(9, dtype=np.float32)[rng.integers(0, 9, (B, 5))]
    return {"mod_1": {"data": rng.random((B, 8, 8, 3)).astype(np.float32), "masks": None},
            "mod_2": {"data": txt,
                      "masks": np.arange(5)[None, :] < rng.integers(1, 6, (B, 1))}}


def _mixture(seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(C, D)).astype(np.float32),
            rng.uniform(0.3, 2.0, (C, D)).astype(np.float32),
            rng.normal(size=C).astype(np.float32))


def _pair(arrays):
    return (jdist.MixtureNormal(*map(jnp.asarray, arrays)),
            tdist.MixtureNormal(*map(torch.from_numpy, arrays)))


# -- MixtureNormal ----------------------------------------------------------------


def test_mixture_log_prob_mean_and_log_prob_joint_match_jax():
    """The joint density over the last axis at (3, 5, D) points, the
    weighted mean, and log_prob_joint: a mixture's density as it is, a
    Normal's summed over D."""
    jm, tm = _pair(_mixture(0))
    x = np.random.default_rng(1).normal(size=(3, 5, D)).astype(np.float32)
    got = tm.log_prob(torch.from_numpy(x))
    assert got.shape == (3, 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(jm.log_prob(jnp.asarray(x))), **TOL)
    np.testing.assert_allclose(tm.mean.numpy(), np.asarray(jm.mean), **TOL)
    np.testing.assert_allclose(tdist.log_prob_joint(tm, torch.from_numpy(x)).numpy(),
                               np.asarray(jdist.log_prob_joint(jm, jnp.asarray(x))), **TOL)
    loc, scale, _ = _mixture(2)
    jn, tn = jdist.Normal(jnp.asarray(loc), jnp.asarray(scale)), tdist.Normal(
        torch.from_numpy(loc), torch.from_numpy(scale))
    np.testing.assert_allclose(tdist.log_prob_joint(tn, torch.from_numpy(x[0, :4])).numpy(),
                               np.asarray(jdist.log_prob_joint(jn, jnp.asarray(x[0, :4]))),
                               **TOL)


@pytest.mark.parametrize("temperature", [1.0, 0.3])
def test_mixture_sample_on_jax_draws_matches_jax(temperature):
    """JAX's ``sample`` splits its key into the component draw
    (``jax.random.categorical``) and eps (``jax.random.normal``); the port
    given those two draws returns JAX's samples."""
    jm, tm = _pair(_mixture(3))
    key = jax.random.PRNGKey(4)
    want = np.asarray(jm.sample(key, 64, temperature))
    k1, k2 = jax.random.split(key)
    idx = np.asarray(jax.random.categorical(k1, jm.logits, shape=(64,)))
    eps = np.asarray(jax.random.normal(k2, (64, D)))
    got = tm.sample(64, temperature, idx=torch.from_numpy(idx.copy()),
                    eps=torch.from_numpy(eps.copy()))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    with pytest.raises(ValueError, match="eps"):
        tm.sample(64, eps=torch.zeros(63, D))


def test_mixture_sample_from_a_generator_covers_the_weights():
    """Drawn from a generator: reproducible, each component taken at about
    its weight, and temperature shrinking the spread, not the modes."""
    m = tdist.MixtureNormal(torch.tensor([[-5.0], [5.0]]), torch.full((2, 1), 0.1),
                            torch.tensor([0.0, np.log(3.0)]))
    a = m.sample(4000, generator=torch.Generator().manual_seed(0))
    b = m.sample(4000, generator=torch.Generator().manual_seed(0))
    assert a.shape == (4000, 1) and torch.equal(a, b)
    assert 0.72 < (a > 0).float().mean().item() < 0.78
    cold = m.sample(512, 0.01, generator=torch.Generator().manual_seed(1))
    assert torch.minimum((cold - 5).abs(), (cold + 5).abs()).max().item() < 0.05


def test_kl_divergence_to_the_mixture_raises():
    """The mixture prior's KL is kld_to_prior's Monte-Carlo mean over the
    drawn latents; kl_divergence has no closed form for the mixed pair, and
    its Monte-Carlo branch needs a generator or samples, as the reference's
    needs a PRNG key."""
    qn = tdist.Normal(torch.zeros(3, D), torch.ones(3, D))
    mix = tdist.MixtureNormal(torch.zeros(C, D), torch.ones(C, D), torch.zeros(C))
    with pytest.raises(ValueError, match="Normal and MixtureNormal"):
        tdist.kl_divergence(qn, mix)


# -- the model's prior --------------------------------------------------------------


def _jax_pair(mixing, obj="elbo", K=2, private=None, components=C):
    """(JAX model, numpy flax params, port model on the CPU, same weights)."""
    jmodel = jget_mixing(mixing)(specs=tuple(JSpec(**k) for k in _spec_kwargs(private)),
                                 n_latents=D, obj=obj, K=K, prior_components=components)
    jb = jax.tree_util.tree_map(jnp.asarray, _numpy_batch(0))
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)}, jb,
        method=jmodel.objective))
    params = draw_params(shapes, 0)
    if components > 1:   # component means spread as flax draws them
        params["params"]["pz_mog_loc"] = np.random.default_rng(9).normal(
            size=(components, D)).astype(np.float32)
    return jmodel, params, _port(mixing, obj, K, private, params, components)


def _port(mixing, obj="elbo", K=2, private=None, params=None, components=C):
    model = get_mixing(mixing)(tuple(ModalitySpec(**k) for k in _spec_kwargs(private)), D,
                               K=K, obj=obj, device="cpu", prior_components=components)
    if params is not None:
        load_flax_params(model, params)
    return model


def test_parameters_are_drawn_from_the_seed_as_flax_draws_them():
    """pz_mog_loc ~ N(0, 1), pz_mog_rawscale and pz_mog_logits zeros,
    drawn from the model's seed; the prior's scales start at softplus(0.5413)
    + 1e-4 ~ 1 and its weights are equal."""
    a, b = (build_model(tuple(ModalitySpec(**k) for k in _spec_kwargs()), "moe", D,
                        device="cpu", seed=3, prior_components=50) for _ in range(2))
    assert a.pz_mog_loc.shape == (50, D) and a.pz_mog_logits.shape == (50,)
    assert torch.equal(a.pz_mog_loc, b.pz_mog_loc)
    assert 0.8 < a.pz_mog_loc.std().item() < 1.2
    assert not a.pz_mog_rawscale.any() and not a.pz_mog_logits.any()
    pz = a.pz()
    assert isinstance(pz, tdist.MixtureNormal)
    torch.testing.assert_close(pz.scales, torch.full((50, D), 1.0001), rtol=0, atol=1e-4)
    assert not hasattr(_port("moe", components=1), "pz_mog_loc")
    with pytest.raises(ValueError, match="the drawn latents"):
        a.kld_to_prior(tdist.Normal(torch.zeros(2, D), torch.ones(2, D)))
    with pytest.raises(ValueError, match="prior_components"):
        _port("moe", components=0)


def test_bridge_carries_the_mixture_parameters():
    """The three pz_mog_* leaves land on the port's parameters of the same
    names; a missing or misshapen one raises."""
    _, params, model = _jax_pair("poe")
    for name in ("pz_mog_loc", "pz_mog_rawscale", "pz_mog_logits"):
        np.testing.assert_array_equal(getattr(model, name).detach().numpy(),
                                      params["params"][name])
    missing = {"params": {k: v for k, v in params["params"].items() if k != "pz_mog_logits"}}
    with pytest.raises(KeyError, match="pz_mog_logits"):
        load_flax_params(_port("poe"), missing)
    bad = {"params": dict(params["params"], pz_mog_loc=np.zeros((C + 1, D), np.float32))}
    with pytest.raises(ValueError, match="pz_mog_loc"):
        load_flax_params(_port("poe"), bad)


@pytest.mark.parametrize("components", [1, C])
def test_sample_pz_matches_jax(components):
    """Joint generation's prior draw: the mixture's on JAX's replayed index
    and eps, the learned-scale Gaussian's on JAX's eps; (1, num, D)."""
    jmodel, params, model = _jax_pair("poe", components=components)
    key = jax.random.PRNGKey(11)
    want = np.asarray(jmodel.apply(params, key, 7, 0.7,
                                   method=lambda m, k, n, t: m.sample_pz(k, n, t)))
    if components > 1:
        k1, k2 = jax.random.split(key)
        logits = jnp.asarray(params["params"]["pz_mog_logits"])
        idx = torch.from_numpy(np.array(jax.random.categorical(k1, logits, shape=(7,))))
        eps = torch.from_numpy(np.array(jax.random.normal(k2, (7, D))))
    else:
        idx, eps = None, torch.from_numpy(np.array(jax.random.normal(key, (1, 7, D))))
    with torch.no_grad():
        got = model.sample_pz(7, 0.7, eps=eps, idx=idx)
    assert got.shape == (1, 7, D)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    drawn = model.sample_pz(7, generator=torch.Generator().manual_seed(0))
    assert drawn.shape == (1, 7, D) and torch.isfinite(drawn).all()


def _record_softmax(monkeypatch):
    """Keep the DReG importance weights the JAX objective computes."""
    kept, softmax = [], jax.nn.softmax

    def recording(x, axis=-1, **kwargs):
        out = softmax(x, axis=axis, **kwargs)
        if axis == 1 and jnp.ndim(x) == 3:
            kept.append(out)
        return out

    monkeypatch.setattr(jax.nn, "softmax", recording)
    return kept


def _port_eps(mixing, draws):
    eps = [torch.from_numpy(np.array(d)) for d in draws]
    return dict(zip(("mod_1", "mod_2"), eps)) if mixing == "moe" else eps


@pytest.mark.parametrize("mixing,obj,private", [
    ("moe", "elbo", None), ("moe", "dreg", None), ("poe", "elbo", None),
    ("mopoe", "elbo", None), ("dmvae", "elbo", 3)],
    ids=["moe-elbo", "moe-dreg", "poe-elbo", "mopoe-elbo", "dmvae-elbo"])
def test_objective_and_every_gradient_match_jax(monkeypatch, mixing, obj, private):
    """Loss, metrics and every gradient, the pz_mog_* leaves among them,
    under the mixture prior at C 4: the KL to the prior is the Monte-Carlo
    mean over the drawn latents (MOE over each modality's draw, POE over
    each subset's, MoPOE over the joint's and a draw of each subset
    posterior, DMVAE over each modality's shared draw and a draw of the
    joint).  The port gets JAX's draws and, for DReG, its weights."""
    rec = _Recorder(monkeypatch)
    weights = _record_softmax(monkeypatch)
    K = 3 if obj == "dreg" else 2
    jmodel, params, model = _jax_pair(mixing, obj, K, private)
    batch = _numpy_batch(1)
    jb = jax.tree_util.tree_map(jnp.asarray, batch)

    def loss_fn(p):
        rec.draws.clear()
        weights.clear()
        loss, metrics = jmodel.apply(p, jb, rngs={"sample": jax.random.PRNGKey(5)},
                                     method=jmodel.objective)
        return loss, (metrics, list(rec.draws), list(weights))

    (jloss, (jmetrics, draws, jw)), jgrads = _jit(
        jax.value_and_grad(loss_fn, has_aux=True))(params)
    if obj == "dreg":
        monkeypatch.setattr(objectives, "dreg_grad_weights",
                            lambda lw, dim=0: torch.from_numpy(np.array(jw[0])))
    tb = {n: {"data": torch.from_numpy(m["data"]),
              "masks": None if m["masks"] is None else torch.from_numpy(m["masks"])}
          for n, m in batch.items()}
    loss, metrics = model.objective(tb, eps=_port_eps(mixing, draws))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), **LOSS_TOL)
    assert sorted(metrics) == sorted(jmetrics)
    for k in metrics:
        np.testing.assert_allclose(metrics[k].item(), float(jmetrics[k]), **LOSS_TOL,
                                   err_msg=k)
    want = _port(mixing, obj, K, private, jax.tree_util.tree_map(np.asarray, jgrads))
    for (name, p), g in zip(model.named_parameters(), want.parameters()):
        got = torch.zeros_like(p) if p.grad is None else p.grad
        err = (got - g).abs().max().item()
        limit = GRAD_REL * g.abs().max().item() + GRAD_ATOL
        assert err <= limit, f"{name}: max abs error {err:.3e} > {limit:.3e}"
    for name in ("pz_mog_loc", "pz_mog_rawscale", "pz_mog_logits"):
        assert getattr(model, name).grad.abs().sum() > 0, f"{name} gets no gradient"


@pytest.mark.parametrize("mixing", ["mopoe", "dmvae"])
def test_objective_draws_its_extra_samples_from_the_generator(mixing):
    """Without eps the extra Monte-Carlo draws come from the generator
    (the same seed gives the same loss); an eps list of the wrong length
    raises, naming the count the mixture prior makes."""
    model = _port(mixing, private=3 if mixing == "dmvae" else None)
    tb = {n: {"data": torch.from_numpy(m["data"]),
              "masks": None if m["masks"] is None else torch.from_numpy(m["masks"])}
          for n, m in _numpy_batch(2).items()}
    a, _ = model.objective(tb, generator=torch.Generator().manual_seed(3))
    b, _ = model.objective(tb, generator=torch.Generator().manual_seed(3))
    assert a.item() == b.item() and torch.isfinite(a)
    n = 4 if mixing == "mopoe" else len(model.eps_shapes(model.mod_names, B)) + 2
    with pytest.raises(ValueError, match=str(n)):
        model.objective(tb, eps=[torch.zeros(2, B, D)])
