"""The training slice of the port against the JAX package, on the CPU.

Distributions, reconstruction losses, estimators, optimizers, the POE and
MOE objectives and the train step, each on the same inputs in both
packages.  Models share weights through ``bridge.load_flax_params``; the
port is fed JAX's own noise, recorded by patching the JAX ``Normal.rsample``
to keep its standard-normal draw and returning the draws from the jitted
function as outputs.  Gradients are compared leaf by leaf after bridging
the JAX gradient tree into a second port instance.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from multimodal_vae_comparison_tpu.models import distributions as jdist
from multimodal_vae_comparison_tpu.models import get_mixing as jget_mixing
from multimodal_vae_comparison_tpu.models import objectives as jobj
from multimodal_vae_comparison_tpu.models.base import ModalitySpec as JSpec
from multimodal_vae_comparison_tpu.models.base import build_specs as jbuild_specs
from multimodal_vae_comparison_tpu.training.optim import make_optimizer as jmake_optimizer
from multimodal_vae_comparison_tpu.training.trainer import TrainState
from multimodal_vae_comparison_tpu.training.trainer import make_train_step as jmake_train_step
from multimodal_vae_comparison_tpu_torch.bridge import load_flax_params
from multimodal_vae_comparison_tpu_torch.models import distributions as tdist
from multimodal_vae_comparison_tpu_torch.models import get_mixing
from multimodal_vae_comparison_tpu_torch.models import objectives as tobj
from multimodal_vae_comparison_tpu_torch.models.base import ModalitySpec, build_specs
from multimodal_vae_comparison_tpu_torch.ops.kernels import telemetry
from multimodal_vae_comparison_tpu_torch.training.optim import RULES, make_optimizer
from multimodal_vae_comparison_tpu_torch.training.trainer import (
    build_model, make_eval_step, make_train_step)
from test_torch_slice import (  # noqa: F401 (one_torch_thread: autouse)
    FLAGSHIP, NARROW, draw_params, numpy_batch, one_torch_thread, spec_kwargs)

TOL = dict(rtol=1e-5, atol=1e-5)        # elementwise fp32 terms
LOSS_TOL = dict(rtol=1e-6, atol=1e-3)   # batch sums of ~1e4 in fp32
# per-leaf gradient tolerance, as a fraction of the leaf's max |g|: fp32
# sums taken in another order through a dozen layers
GRAD_REL = {"elbo": 1e-4, "elbo_iw": 1e-4,
            # the K-weighted bounds exponentiate log-weights of ~-6.5e3,
            # whose fp32 ulp is 5e-4: the JAX package's own jitted and
            # unjitted gradients differ by up to 7.5e-4 max|g| here
            "iwae": 2e-3, "dreg": 2e-3}


# -- distributions and losses ------------------------------------------------


def _normal_pair(seed, shape):
    rng = np.random.default_rng(seed)
    loc = rng.normal(size=shape).astype(np.float32)
    scale = rng.uniform(0.2, 2.0, shape).astype(np.float32)
    return loc, scale


def test_normal_log_prob_kl_and_variance_match_jax():
    loc, scale = _normal_pair(0, (3, 5))
    loc2, scale2 = _normal_pair(1, (1, 5))
    x = np.random.default_rng(2).normal(size=(2, 3, 5)).astype(np.float32)
    j, j2 = jdist.Normal(jnp.asarray(loc), jnp.asarray(scale)), \
        jdist.Normal(jnp.asarray(loc2), jnp.asarray(scale2))
    t, t2 = tdist.Normal(torch.from_numpy(loc), torch.from_numpy(scale)), \
        tdist.Normal(torch.from_numpy(loc2), torch.from_numpy(scale2))
    np.testing.assert_allclose(t.log_prob(torch.from_numpy(x)).numpy(),
                               np.asarray(j.log_prob(jnp.asarray(x))), **TOL)
    np.testing.assert_allclose(t.variance.numpy(), np.asarray(j.variance), **TOL)
    np.testing.assert_allclose(t.kl(t2).numpy(), np.asarray(j.kl(j2)), **TOL)
    np.testing.assert_allclose(tdist.kl_divergence(t, t2).numpy(),
                               np.asarray(jdist.kl_divergence(j, j2)), **TOL)
    np.testing.assert_allclose(tdist.log_prob_joint(t, torch.from_numpy(x)).numpy(),
                               np.asarray(jdist.log_prob_joint(j, jnp.asarray(x))), **TOL)


def test_kl_divergence_of_mixed_families_and_unported_dists_raise():
    """A KL between families (the Monte-Carlo branch) without a generator or
    samples raises, as the reference's does without a PRNG key (the branch
    itself is held against JAX in test_torch_rest.py); an unknown family
    raises; Laplace and Bernoulli are ported (test_torch_mnistsvhn.py and
    test_torch_rest.py hold them)."""
    with pytest.raises(ValueError, match="generator"):
        tdist.kl_divergence(tdist.Normal(torch.zeros(1), torch.ones(1)), object())
    with pytest.raises(ValueError, match="Monte-Carlo"):
        tdist.kl_divergence(tdist.Laplace(torch.zeros(1), torch.ones(1)),
                            tdist.Normal(torch.zeros(1), torch.ones(1)))
    with pytest.raises(KeyError, match="laplace"):
        tdist.get_dist("poisson")
    assert tdist.get_dist("Gaussian") is tdist.Normal
    assert tdist.get_dist("laplace") is tdist.Laplace
    assert tdist.get_dist("Bernoulli") is tdist.Bernoulli


@pytest.mark.parametrize("dim,keepdim", [(0, False), (1, True), (-1, False)])
def test_log_mean_exp_matches_jax(dim, keepdim):
    x = np.random.default_rng(3).normal(size=(4, 3, 5)).astype(np.float32) * 30
    np.testing.assert_allclose(
        tdist.log_mean_exp(torch.from_numpy(x), dim=dim, keepdim=keepdim).numpy(),
        np.asarray(jdist.log_mean_exp(jnp.asarray(x), axis=dim, keepdims=keepdim)), **TOL)


def _decoder_dists(seed, lead, feat, logits):
    """(torch Normal, jax Normal) over (lead..., B=3, feat...) means."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=lead + (3,) + feat).astype(np.float32) * 4
    mean = 1 / (1 + np.exp(-x)) if logits else x
    t = tdist.Normal(torch.from_numpy(mean), torch.tensor(0.75),
                     loc_logits=torch.from_numpy(x) if logits else None)
    j = jdist.Normal(jnp.asarray(mean), jnp.asarray(0.75),
                     loc_logits=jnp.asarray(x) if logits else None)
    return t, j


@pytest.mark.parametrize("ltype,logits,feat,masked", [
    ("bce", True, (4, 4, 3), False),
    ("bce", False, (4, 4, 3), False),
    ("category_ce", False, (6, 27), True),
    ("category_ce", False, (6, 27), False),
    ("l1", False, (6, 5), True),
    ("mse", False, (6, 5), True),
])
@pytest.mark.parametrize("lead", [(), (2,)])
def test_recon_losses_match_jax(ltype, logits, feat, masked, lead):
    rng = np.random.default_rng(4)
    tdst, jdst = _decoder_dists(5, lead, feat, logits)
    if ltype == "category_ce":
        target = np.eye(feat[-1], dtype=np.float32)[rng.integers(0, feat[-1], (3, feat[0]))]
    else:
        target = rng.random((3,) + feat).astype(np.float32)
    mask = None
    if masked:
        mask = np.arange(feat[0])[None, :] < np.array([[1], [4], [feat[0]]])
    bnd = len(lead) + 1
    got = tobj.recon_log_prob(ltype, tdst, torch.from_numpy(target),
                              None if mask is None else torch.from_numpy(mask), bnd)
    want = jobj.recon_log_prob(ltype, jdst, jnp.asarray(target),
                               None if mask is None else jnp.asarray(mask), bnd)
    assert got.shape == lead + (3,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-4)


def test_recon_log_prob_names_the_ported_losses():
    """An unknown loss raises KeyError naming the table, which holds the
    JAX package's losses, ``feature_loss`` among them."""
    t, _ = _decoder_dists(0, (), (3,), False)
    with pytest.raises(KeyError, match="feature_loss.*optimal_sigma"):
        tobj.recon_log_prob("no_such_loss", t, torch.zeros(3, 3))
    assert sorted(tobj.RECON_LOSSES) == sorted(jobj.RECON_LOSSES)


def test_scale_grad_and_estimators_match_jax():
    rng = np.random.default_rng(6)
    lw = rng.normal(size=(4, 3)).astype(np.float32) * 5
    w = rng.random((4, 3)).astype(np.float32)
    lpx, kld = rng.normal(size=(2, 3)).astype(np.float32), rng.random((2, 3)).astype(np.float32)
    cases = ((lw, tobj.iwae, jobj.iwae), (lw, tobj.dreg, jobj.dreg),
             (lpx, lambda x: tobj.elbo(x, torch.from_numpy(kld), 0.5).square(),
              lambda x: jobj.elbo(x, jnp.asarray(kld), 0.5) ** 2))
    for x, tfn, jfn in cases:
        xt = torch.from_numpy(x).requires_grad_()
        val = tfn(xt)
        val.backward()
        jval, jgrad = jax.value_and_grad(jfn)(jnp.asarray(x))
        np.testing.assert_allclose(val.item(), float(jval), rtol=1e-6)
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgrad), rtol=1e-5, atol=1e-7)
    xt = torch.from_numpy(lw).requires_grad_()
    out = tobj.scale_grad(xt, torch.from_numpy(w))
    torch.testing.assert_close(out, xt)
    (out * 3.0).sum().backward()
    jgrad = jax.grad(lambda x: (jobj.scale_grad(x, jnp.asarray(w)) * 3.0).sum())(jnp.asarray(lw))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgrad), rtol=1e-6)


def test_build_specs_matches_jax_with_auto_llik_scaling():
    mods = [types.SimpleNamespace(
        name="mod_1", encoder="CNN2", decoder="CNN", feature_dims=[32, 32, 3],
        mod_type="image", recon_loss="bce", prior="normal", llik_scaling="auto",
        private_latents=None),
        types.SimpleNamespace(
        name="mod_2", encoder="TxtTransformer", decoder="TxtTransformer",
        feature_dims=[12, 27], mod_type="text", recon_loss="category_ce",
        prior="normal", llik_scaling="auto", private_latents=None, cond_on="image")]
    cfg = types.SimpleNamespace(mods=mods)
    got = [dataclasses.asdict(s) for s in build_specs(cfg)]
    want = [dataclasses.asdict(s) for s in jbuild_specs(cfg)]
    assert got == want
    assert got[0]["llik_scaling"] == pytest.approx(12 * 27 / (32 * 32 * 3))
    assert got[1]["cond_on"] == "mod_1" and got[1]["has_masks"]


# -- optimizers ---------------------------------------------------------------


@pytest.mark.parametrize("name", RULES)
def test_optimizers_follow_optax_on_a_large_then_small_gradient(name):
    """Gradients 1 then 0.01 x 4, lr 1e-3: the sequence on which
    torch.optim.Adam(amsgrad=True) and optax.amsgrad part ways."""
    grads = [1.0, 0.01, 0.01, 0.01, 0.01]
    init = np.array([0.5, -0.25, 0.0], np.float32)
    tx = jmake_optimizer(name, 1e-3)
    jp = jnp.asarray(init)
    state = tx.init(jp)
    p = torch.nn.Parameter(torch.from_numpy(init.copy()))
    opt = make_optimizer(name, 1e-3, [p])
    for g in grads:
        updates, state = tx.update(jnp.full(3, g, jnp.float32), state, jp)
        jp = optax.apply_updates(jp, updates)
        p.grad = torch.full((3,), g)
        opt.step()
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp), rtol=0, atol=1e-7)
    if name == "adam":   # the trap: torch's amsgrad lands elsewhere
        q = torch.nn.Parameter(torch.from_numpy(init.copy()))
        topt = torch.optim.Adam([q], lr=1e-3, amsgrad=True)
        for g in grads:
            q.grad = torch.full((3,), g)
            topt.step()
        assert (q - p).abs().max().item() > 5e-4


@pytest.mark.parametrize("name", RULES)
def test_optimizers_step_a_leaf_without_gradient_as_optax_does(name):
    """A parameter with no ``.grad`` on one step takes optax's zero-gradient
    update there: the moments decay and the weight keeps moving."""
    grads = [1.0, 0.5, None, 0.01]
    init = np.array([0.5, -0.25, 0.0], np.float32)
    tx = jmake_optimizer(name, 1e-3)
    jp = jnp.asarray(init)
    state = tx.init(jp)
    p = torch.nn.Parameter(torch.from_numpy(init.copy()))
    opt = make_optimizer(name, 1e-3, [p])
    for g in grads:
        updates, state = tx.update(jnp.full(3, g or 0.0, jnp.float32), state, jp)
        jp = optax.apply_updates(jp, updates)
        opt.zero_grad(set_to_none=True)
        if g is not None:
            p.grad = torch.full((3,), g)
        opt.step()
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp), rtol=0, atol=1e-7)


def test_unknown_optimizer_raises():
    with pytest.raises(KeyError):
        make_optimizer("lion", 1e-3, [torch.nn.Parameter(torch.zeros(1))])


# -- objectives against the JAX package -------------------------------------------


class _Recorder:
    """Patch the JAX Normal.rsample to keep each standard-normal draw."""

    def __init__(self, monkeypatch):
        self.draws = []

        def rsample(dist, key, sample_shape=()):
            shape = tuple(sample_shape) + jnp.shape(dist.loc)
            eps = jax.random.normal(key, shape, dtype=jnp.result_type(dist.loc))
            self.draws.append(eps)
            return dist.loc + eps * dist.scale

        monkeypatch.setattr(jdist.Normal, "rsample", rsample)


def _jax_model(cfg, mixing, obj, K):
    jmodel = jget_mixing(mixing)(specs=tuple(JSpec(**k) for k in spec_kwargs(cfg)),
                                 n_latents=cfg["latents"], obj=obj, K=K)
    jb = jax.tree_util.tree_map(jnp.asarray, numpy_batch(cfg, 0))
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)}, jb,
        method=jmodel.objective))
    return jmodel, draw_params(shapes, 0)


def _port_model(cfg, mixing, obj, K, params=None):
    model = get_mixing(mixing)(tuple(ModalitySpec(**k) for k in spec_kwargs(cfg)),
                               cfg["latents"], K=K, obj=obj, device="cpu")
    if params is not None:
        load_flax_params(model, params)
    return model


def _torch_batch(batch):
    return {n: {"data": torch.from_numpy(m["data"]),
                "masks": None if m["masks"] is None else torch.from_numpy(m["masks"])}
            for n, m in batch.items()}


def _port_eps(mixing, specs, draws):
    """JAX's draws in the port's form: a list per subset (POE), a dict per
    modality in spec order (MOE)."""
    eps = [torch.from_numpy(np.array(d)) for d in draws]
    return eps if mixing == "poe" else {s.name: e for s, e in zip(specs, eps)}


def _assert_grads_match(model, jgrads, cfg, mixing, obj, K, rel):
    want = _port_model(cfg, mixing, obj, K, jax.tree_util.tree_map(np.asarray, jgrads))
    for (name, p), g in zip(model.named_parameters(), want.parameters()):
        got = torch.zeros_like(p) if p.grad is None else p.grad
        err = (got - g).abs().max().item()
        limit = rel * g.abs().max().item() + 1e-6
        assert err <= limit, f"{name}: max abs error {err:.3e} > {limit:.3e}"


@pytest.mark.parametrize("cfg,mixing,obj,K", [
    (NARROW, "poe", "elbo", 1),
    (NARROW, "moe", "elbo", 1),
    (NARROW, "moe", "elbo_iw", 2),
    (NARROW, "moe", "iwae", 2),
    (NARROW, "moe", "dreg", 2),
    (FLAGSHIP, "poe", "elbo", 1),
], ids=["poe-elbo", "moe-elbo", "moe-elbo_iw", "moe-iwae", "moe-dreg",
        "poe-elbo-flagship"])
def test_objective_loss_metrics_and_grads_match_jax(monkeypatch, cfg, mixing, obj, K):
    rec = _Recorder(monkeypatch)
    jmodel, params = _jax_model(cfg, mixing, obj, K)
    batch = numpy_batch(cfg, 1)
    jb = jax.tree_util.tree_map(jnp.asarray, batch)

    def loss_fn(p):
        rec.draws.clear()
        loss, metrics = jmodel.apply(p, jb, rngs={"sample": jax.random.PRNGKey(5)},
                                     method=jmodel.objective)
        return loss, (metrics, list(rec.draws))

    (jloss, (jmetrics, draws)), jgrads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(params)
    model = _port_model(cfg, mixing, obj, K, params)
    telemetry.reset()
    loss, metrics = model.objective(_torch_batch(batch),
                                    eps=_port_eps(mixing, model.specs, draws))
    loss.backward()
    # the KL kernel's plain version runs on exactly the MOE ELBO objectives
    assert ("kl:plain" in telemetry.summary()) == (mixing == "moe" and "elbo" in obj)
    np.testing.assert_allclose(loss.item(), float(jloss), **LOSS_TOL)
    assert sorted(metrics) == sorted(jmetrics)
    for k in metrics:
        np.testing.assert_allclose(metrics[k].item(), float(jmetrics[k]), **LOSS_TOL)
    _assert_grads_match(model, jgrads, cfg, mixing, obj, K, GRAD_REL[obj])


def test_poe_objective_generator_draws_and_eps_checks():
    model = _port_model(NARROW, "poe", "elbo", 2)
    tb = _torch_batch(numpy_batch(NARROW, 2))
    a, _ = model.objective(tb, generator=torch.Generator().manual_seed(3))
    b, _ = model.objective(tb, generator=torch.Generator().manual_seed(3))
    assert a.item() == b.item() and torch.isfinite(a)
    with pytest.raises(ValueError, match="3 subsets"):
        model.objective(tb, eps=[torch.zeros(2, 3, 8)])


def test_poe_per_subset_decode_equals_the_lattice_batched_decode(monkeypatch):
    """A decoder whose conditioning input differs by subset decodes each
    subset on its own; with a decoder that ignores the input, both branches
    give the same loss."""
    specs = [ModalitySpec(**k) for k in spec_kwargs(NARROW)]
    model = _port_model(NARROW, "poe", "elbo", 1)
    tb = _torch_batch(numpy_batch(NARROW, 3))
    eps = [torch.from_numpy(np.random.default_rng(s).normal(size=(1, 3, 8)).astype(np.float32))
           for s in range(3)]
    want, _ = model.objective(tb, eps=eps)
    model.specs = (specs[0], dataclasses.replace(specs[1], cond_on="mod_1"))
    dec = model.dec_mod_2
    calls = []

    def forward(z, mask=None, cond=None, cond_mask=None):
        calls.append(cond is not None)
        return type(dec).forward(dec, z, mask)

    monkeypatch.setattr(dec, "forward", forward)
    got, _ = model.objective(tb, eps=eps)
    assert calls == [True, False, True]  # subsets {1}, {2} (no mod_1), {1, 2}
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-3)


def test_moe_forward_imputes_missing_modalities_from_the_first_present():
    model = _port_model(NARROW, "moe", "elbo", 1)
    tb = _torch_batch(numpy_batch(NARROW, 4))
    tb["mod_2"] = {"data": None, "masks": tb["mod_2"]["masks"]}
    eps = {"mod_1": torch.zeros(1, 3, 8)}
    with torch.no_grad():
        out = model.forward(tb, ("mod_1",), eps=eps)
    torch.testing.assert_close(out.mods["mod_2"].latents, out.mods["mod_1"].latents)
    assert out.mods["mod_2"].encoder_dist is None
    assert out.mods["mod_1"].cross_decoder_dist == {}
    assert out.mods["mod_2"].decoder_dist.mean.shape == (1, 3, NARROW["seq"], 27)


def test_unported_model_options_raise():
    specs = tuple(ModalitySpec(**k) for k in spec_kwargs(NARROW))
    # the mixture prior is ported: it builds (tests/test_torch_prior.py holds it)
    model = get_mixing("moe")(specs, 8, device="cpu", prior_components=4)
    assert model.pz_mog_loc.shape == (4, 8) and type(model.pz()).__name__ == "MixtureNormal"
    # one modality builds the unimodal VAE (tests/test_torch_unimodal.py
    # holds it against JAX), and a step of it trains
    uni = build_model(specs[:1], "moe", 8, device="cpu")
    assert type(uni).__name__ == "UnimodalVAE" and uni.mod_names == ("mod_1",)
    one = {"mod_1": _torch_batch(numpy_batch(NARROW, 0))["mod_1"]}
    before = [p.detach().clone() for p in uni.parameters()]
    metrics = make_train_step(uni, make_optimizer("adam", 1e-3, uni.parameters()))(
        one, generator=torch.Generator().manual_seed(0))
    assert torch.isfinite(metrics["loss"]) and "reconstruction_loss_mod_1" in metrics
    assert any(not torch.equal(a, b) for a, b in zip(before, uni.parameters()))
    # an objective name MOE does not list runs its K-weighted IWAE bound,
    # as the JAX package routes it (tests/test_torch_unimodal.py holds it
    # against JAX)
    batch = _torch_batch(numpy_batch(NARROW, 0))
    losses = [_port_model(NARROW, "moe", obj, 2).objective(
        batch, generator=torch.Generator().manual_seed(0))[0] for obj in ("vib", "iwae")]
    assert torch.equal(*losses)


# -- the train step -----------------------------------------------------------


def _narrow_eps(mixing, K, B, seed):
    rng = np.random.default_rng(seed)
    draws = [rng.standard_normal((K, B, NARROW["latents"])).astype(np.float32)
             for _ in range(3 if mixing == "poe" else 2)]
    specs = [ModalitySpec(**k) for k in spec_kwargs(NARROW)]
    return _port_eps(mixing, specs, draws)


@pytest.mark.parametrize("mixing", ["poe", "moe"])
def test_grad_accum_applies_the_mean_of_the_strided_chunk_grads(mixing):
    cfg = dict(NARROW, batch=4)
    tb = _torch_batch(numpy_batch(cfg, 5))
    eps = _narrow_eps(mixing, 1, 4, 6)
    lr = 1e-2
    model = build_model(tuple(ModalitySpec(**k) for k in spec_kwargs(cfg)), mixing, 8,
                        device="cpu")
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    # by hand: the mean of the chunks' gradients, chunk g = rows g::2
    grads, losses = {}, []
    for g in range(2):
        sub = {n: {k: None if v is None else v[g::2] for k, v in m.items()}
               for n, m in tb.items()}
        sub_eps = ([e[:, g::2] for e in eps] if isinstance(eps, list)
                   else {k: e[:, g::2] for k, e in eps.items()})
        model.zero_grad()
        loss, _ = model.objective(sub, eps=sub_eps)
        loss.backward()
        losses.append(loss.item())
        for n, p in model.named_parameters():
            if p.grad is not None:
                grads[n] = grads.get(n, 0) + p.grad / 2
    step = make_train_step(model, make_optimizer("sgd", lr, model.parameters()), grad_accum=2)
    metrics = step(tb, eps=eps)
    np.testing.assert_allclose(metrics["loss"].item(), np.mean(losses), rtol=1e-6)
    for n, p in model.named_parameters():
        want = start[n] - lr * grads.get(n, torch.zeros_like(p))
        torch.testing.assert_close(p.detach(), want, rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="divisible"):
        make_train_step(model, make_optimizer("sgd", lr, model.parameters()),
                        grad_accum=3)(tb, eps=eps)


def test_train_step_matches_the_jax_step_from_a_bridged_state(monkeypatch):
    """Two JAX train steps with optax.amsgrad; the port takes the second
    from the first's bridged weights and optimizer state, on JAX's draws."""
    rec = _Recorder(monkeypatch)
    jmodel, params = _jax_model(NARROW, "poe", "elbo", 1)
    tx = jmake_optimizer("adam", 1e-3)
    jstep = jmake_train_step(jmodel, tx, jit=False)

    def run(state, batch, rng):
        rec.draws.clear()
        new_state, metrics = jstep(state, batch, rng)
        return new_state, metrics, list(rec.draws)

    batch = numpy_batch(NARROW, 7)
    jb = jax.tree_util.tree_map(jnp.asarray, batch)
    state = TrainState(params=params, opt_state=tx.init(params),
                       step=jnp.zeros((), jnp.int32))
    run = jax.jit(run)
    state1, _, _ = run(state, jb, jax.random.PRNGKey(0))
    state2, jmetrics, draws = run(state1, jb, jax.random.PRNGKey(0))

    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    model = _port_model(NARROW, "poe", "elbo", 1, np_tree(state1.params))
    opt = make_optimizer("adam", 1e-3, model.parameters())
    amsgrad = state1.opt_state[0]
    moments = {k: dict(_port_model(NARROW, "poe", "elbo", 1,
                                   np_tree(getattr(amsgrad, k))).named_parameters())
               for k in ("mu", "nu", "nu_max")}
    for name, p in model.named_parameters():
        opt.state[p] = {"count": int(amsgrad.count),
                        **{k: moments[k][name].detach().clone() for k in moments}}
    metrics = make_train_step(model, opt)(_torch_batch(batch),
                                          eps=_port_eps("poe", model.specs, draws))
    np.testing.assert_allclose(metrics["loss"].item(), float(jmetrics["loss"]), **LOSS_TOL)
    want = _port_model(NARROW, "poe", "elbo", 1, np_tree(state2.params))
    before = dict(_port_model(NARROW, "poe", "elbo", 1, np_tree(state1.params))
                  .named_parameters())
    for (name, p), w in zip(model.named_parameters(), want.parameters()):
        if name.endswith("key.bias"):
            # softmax is shift-invariant per row, so the key bias has a zero
            # gradient in exact arithmetic: both packages' amsgrad steps on
            # it normalize rounding noise and agree only in their bound
            assert (p - before[name]).abs().max().item() <= 2e-3
            continue
        # a step moves a weight by about lr = 1e-3: hold it to 0.2 % of that
        torch.testing.assert_close(p.detach(), w.detach(), rtol=0, atol=2e-6,
                                   msg=lambda m: f"{name}: {m}")


def test_eval_step_takes_no_gradient_and_reports_loss():
    model = _port_model(NARROW, "moe", "elbo", 1)
    out = make_eval_step(model)(_torch_batch(numpy_batch(NARROW, 8)),
                                generator=torch.Generator().manual_seed(0))
    assert set(out) == {"loss", "kld", "reconstruction_loss_mod_1",
                        "reconstruction_loss_mod_2"}
    assert not out["loss"].requires_grad and torch.isfinite(out["loss"])
    assert all(p.grad is None for p in model.parameters())
