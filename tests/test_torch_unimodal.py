"""The unimodal VAE, its gumbel-softmax path and latent-growth surgery in the
port against the JAX package, on the CPU.

``OneHotCategorical`` (log_prob, kl, and rsample on injected Gumbel noise);
``UnimodalVAE``'s loss, metrics and every gradient for ``elbo``, ``iwae``,
``elbo_iw`` (IWAE, as JAX routes every name it does not list), ``dreg``
(on JAX's importance weights), ``elbo`` under the mixture prior and the
gumbel path (``obj: elbo_gumbel``, and ``prior: gumbel`` on masked text),
from bridged weights and JAX's own draws (its samplers patched to keep
them); MOE's routing of a name outside its list (``iwae_k``) to the
K-weighted bound, against JAX's; ``build_model`` of one modality spec;
``grow_latents``: the same leaves grow as JAX's on a model of every
decoder of the registry, the old entries are kept, and with JAX's padded
values bridged in the grown loss is JAX's.

Tolerances: the distribution within rtol/atol 1e-6; loss and metrics within
rtol 1e-6 + atol 1e-3 (batch sums in fp32); every gradient within 1e-4 of
its leaf's max |g| + 1e-5, and 2e-3 for the K-weighted bounds
(tests/test_torch_train.py's limits).
"""
import types
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_vae_comparison_tpu.models import distributions as jdist
from multimodal_vae_comparison_tpu.models import get_mixing as jget_mixing
from multimodal_vae_comparison_tpu.models.base import ModalitySpec as JSpec
from multimodal_vae_comparison_tpu.models.decoders import DECODERS as JDECODERS
from multimodal_vae_comparison_tpu.models.mmvae import UnimodalVAE as JUnimodalVAE
from multimodal_vae_comparison_tpu.training.surgery import grow_latents as jgrow_latents
from multimodal_vae_comparison_tpu_torch.bridge import load_flax_params
from multimodal_vae_comparison_tpu_torch.models import distributions as tdist
from multimodal_vae_comparison_tpu_torch.models import get_mixing
from multimodal_vae_comparison_tpu_torch.models import objectives
from multimodal_vae_comparison_tpu_torch.models.base import ModalitySpec
from multimodal_vae_comparison_tpu_torch.models.mmvae import UnimodalVAE
from multimodal_vae_comparison_tpu_torch.ops.kernels import telemetry
from multimodal_vae_comparison_tpu_torch.training.surgery import grow_latents, grow_state
from multimodal_vae_comparison_tpu_torch.training.trainer import build_model
from test_torch_slice import draw_params, one_torch_thread  # noqa: F401 (one_torch_thread: autouse)

DIST_TOL = dict(rtol=1e-6, atol=1e-6)
LOSS_TOL = dict(rtol=1e-6, atol=1e-3)
GRAD_REL = {"elbo": 1e-4, "elbo_gumbel": 1e-4, "iwae": 2e-3, "elbo_iw": 2e-3, "dreg": 2e-3}
GRAD_ATOL = 1e-5
B = 5
FAST_COMPILE = {"xla_llvm_disable_expensive_passes": True}

IMAGE = dict(name="mod_1", encoder="FNN", decoder="FNN", feature_dims=(8, 8, 3),
             mod_type="image", recon_loss="bce")
TEXT = dict(name="mod_1", encoder="TxtTransformer", decoder="TxtTransformer",
            feature_dims=(5, 9), mod_type="text", recon_loss="category_ce",
            prior="gumbel", has_masks=True)
ONEHOT = dict(name="mod_1", encoder="FNN", decoder="FNN", feature_dims=(6, 4),
              recon_loss="bce", prior="normal")

# id: (spec kwargs, n_latents, obj, K, prior components)
CASES = {
    "elbo": (IMAGE, 6, "elbo", 2, 1),
    "iwae": (IMAGE, 6, "iwae", 3, 1),
    # a name the unimodal VAE does not list: IWAE, as JAX routes it
    "elbo_iw": (IMAGE, 6, "elbo_iw", 3, 1),
    "dreg": (IMAGE, 6, "dreg", 3, 1),
    "elbo-mixture-prior": (IMAGE, 6, "elbo", 2, 4),
    "elbo_gumbel": (ONEHOT, 12, "elbo_gumbel", 2, 1),
    "prior-gumbel-text": (TEXT, 18, "elbo", 2, 1),
}
# what the plain versions of the kernels launch in one objective and its
# backward: the ELBO's KL through the KL kernel (M = 1), the text nets'
# attention (encoder, decoder)
LAUNCHES = {"elbo": {"kl:plain": 1, "kl_bwd:plain": 1},
            "prior-gumbel-text": {"attention:plain": 2}}


# -- OneHotCategorical -----------------------------------------------------------------


def test_one_hot_categorical_matches_jax():
    """probs, log_prob of one-hots, kl, and rsample given JAX's Gumbel
    noise (its ``jax.random.gumbel`` draw for the key) at temperatures 1
    and 0.5; the names ``categorical`` and ``gumbel`` resolve to it."""
    rng = np.random.default_rng(0)
    logits, other = (rng.normal(size=(4, 3, 7)).astype(np.float32) for _ in range(2))
    x = np.eye(7, dtype=np.float32)[rng.integers(0, 7, (4, 3))]
    jq, jp = jdist.OneHotCategorical(jnp.asarray(logits)), jdist.OneHotCategorical(
        jnp.asarray(other))
    tq, tp = tdist.OneHotCategorical(torch.from_numpy(logits)), tdist.OneHotCategorical(
        torch.from_numpy(other))
    np.testing.assert_allclose(tq.mean.numpy(), np.asarray(jq.mean), **DIST_TOL)
    np.testing.assert_allclose(tq.log_prob(torch.from_numpy(x)).numpy(),
                               np.asarray(jq.log_prob(jnp.asarray(x))), **DIST_TOL)
    np.testing.assert_allclose(tq.kl(tp).numpy(), np.asarray(jq.kl(jp)), **DIST_TOL)
    key = jax.random.PRNGKey(3)
    g = np.array(jax.random.gumbel(key, (2, 4, 3, 7)))
    for temperature in (1.0, 0.5):
        want = np.asarray(jq.rsample(key, (2,), temperature))
        got = tq.rsample((2,), eps=torch.from_numpy(g), temperature=temperature)
        np.testing.assert_allclose(got.numpy(), want, **DIST_TOL)
    for name in ("categorical", "gumbel", "Gumbel"):
        assert tdist.get_dist(name) is tdist.OneHotCategorical
    with pytest.raises(ValueError, match="eps"):
        tq.rsample((2,), eps=torch.zeros(1, 4, 3, 7))


def test_one_hot_categorical_draws_from_the_generator():
    """Without eps the Gumbel noise comes from the generator: the same seed
    gives the same relaxed one-hots, each on the simplex, and a logit far
    above the rest wins nearly every draw."""
    q = tdist.OneHotCategorical(torch.tensor([[8.0, 0.0, 0.0]]).expand(4000, 3))
    a = q.rsample((2,), generator=torch.Generator().manual_seed(0))
    b = q.rsample((2,), generator=torch.Generator().manual_seed(0))
    assert a.shape == (2, 4000, 3) and torch.equal(a, b)
    torch.testing.assert_close(a.sum(-1), torch.ones(2, 4000))
    assert (a.argmax(-1) == 0).float().mean().item() > 0.99


# -- UnimodalVAE against JAX -----------------------------------------------------------


def _numpy_batch(spec, seed):
    rng = np.random.default_rng(seed)
    dims = spec["feature_dims"]
    if spec["mod_type"] == "text" if "mod_type" in spec else False:
        data = np.eye(dims[1], dtype=np.float32)[rng.integers(0, dims[1], (B, dims[0]))]
        lengths = np.concatenate([[dims[0], 1], rng.integers(1, dims[0] + 1, B - 2)])
        return {"mod_1": {"data": data,
                          "masks": np.arange(dims[0])[None, :] < lengths[:, None]}}
    if len(dims) == 2:   # one-hot rows over the last axis
        data = np.eye(dims[1], dtype=np.float32)[rng.integers(0, dims[1], (B, dims[0]))]
    else:
        data = rng.random((B,) + dims).astype(np.float32)
    return {"mod_1": {"data": data, "masks": None}}


class _Draws:
    """Patch JAX's Normal and OneHotCategorical samplers to keep their
    standard-normal and Gumbel noise, and keep the DReG weights (a softmax
    over K of a (K, B) array)."""

    def __init__(self, monkeypatch):
        self.noise, self.weights = [], []
        softmax = jax.nn.softmax

        def normal(dist, key, sample_shape=()):
            eps = jax.random.normal(key, tuple(sample_shape) + jnp.shape(dist.loc),
                                    dtype=jnp.result_type(dist.loc))
            self.noise.append(eps)
            return dist.loc + eps * dist.scale

        def gumbel(dist, key, sample_shape=(), temperature=1.0):
            g = jax.random.gumbel(key, tuple(sample_shape) + jnp.shape(dist.logits),
                                  dtype=jnp.result_type(dist.logits))
            self.noise.append(g)
            return jax.nn.softmax((dist.logits + g) / temperature, axis=-1)

        def recording(x, axis=-1, **kwargs):
            out = softmax(x, axis=axis, **kwargs)
            if axis == 0 and jnp.ndim(x) == 2:
                self.weights.append(out)
            return out

        monkeypatch.setattr(jdist.Normal, "rsample", normal)
        monkeypatch.setattr(jdist.OneHotCategorical, "rsample", gumbel)
        monkeypatch.setattr(jax.nn, "softmax", recording)


def _jax_model(spec, latents, obj, K, components):
    return JUnimodalVAE(specs=(JSpec(**spec),), n_latents=latents, obj=obj, K=K,
                        prior_components=components)


def _port_model(spec, latents, obj, K, components, params=None):
    model = UnimodalVAE((ModalitySpec(**spec),), latents, K=K, obj=obj, device="cpu",
                        prior_components=components)
    if params is not None:
        load_flax_params(model, params)
    return model


def _jax_params(jmodel, batch, seed):
    jb = jax.tree_util.tree_map(jnp.asarray, batch)
    params = draw_params(jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)}, jb,
        method=jmodel.objective)), seed)
    if jmodel.prior_components > 1:   # component means spread as flax draws them
        params["params"]["pz_mog_loc"] = np.random.default_rng(seed + 1).normal(
            size=params["params"]["pz_mog_loc"].shape).astype(np.float32)
    return params


def _lower(case, draws):
    """(port-side inputs, lowered JAX value_and_grad, its args) of a case:
    loss, metrics, the noise and the DReG weights of one objective."""
    spec, latents, obj, K, components = CASES[case]
    jmodel = _jax_model(spec, latents, obj, K, components)
    batch = _numpy_batch(spec, 1)
    params = _jax_params(jmodel, batch, 10)
    jb = jax.tree_util.tree_map(jnp.asarray, batch)

    def loss_fn(p):
        draws.noise.clear()
        draws.weights.clear()
        loss, metrics = jmodel.apply(p, jb, rngs={"sample": jax.random.PRNGKey(5)},
                                     method=jmodel.objective)
        return loss, (metrics, list(draws.noise), list(draws.weights))

    side = types.SimpleNamespace(batch=batch, params=params)
    return side, jax.jit(jax.value_and_grad(loss_fn, has_aux=True)).lower(params)


@pytest.fixture(scope="module")
def jax_side():
    """{case: (port-side inputs, JAX's (loss, (metrics, noise, weights)),
    grads) as numpy}, each compiled in a pool of threads as soon as it is
    traced (XLA compiles without the GIL)."""
    mp = pytest.MonkeyPatch()
    draws = _Draws(mp)
    try:
        def run(fn, args):
            return jax.tree_util.tree_map(np.array, fn.compile(FAST_COMPILE)(*args))

        with ThreadPoolExecutor(max_workers=4) as pool:
            pending = {}
            for case in CASES:
                side, fn = _lower(case, draws)
                pending[case] = (side, pool.submit(run, fn, (side.params,)))
            return {k: (side, fut.result()) for k, (side, fut) in pending.items()}
    finally:
        mp.undo()


def _torch_batch(batch):
    return {n: {"data": torch.from_numpy(m["data"]),
                "masks": None if m["masks"] is None else torch.from_numpy(m["masks"])}
            for n, m in batch.items()}


@pytest.mark.parametrize("case", list(CASES))
def test_objective_and_every_gradient_match_jax(jax_side, monkeypatch, case):
    """Loss, metrics and every gradient from bridged weights on JAX's draws
    (and for DReG its importance weights, which the port also takes for
    the loss's own softmax); the kernels' plain versions launched as the
    objective's kernels would be."""
    spec, latents, obj, K, components = CASES[case]
    side, ((jloss, (jmetrics, noise, weights)), jgrads) = jax_side[case]
    model = _port_model(spec, latents, obj, K, components, side.params)
    if obj == "dreg":
        assert len(weights) == 2
        np.testing.assert_array_equal(weights[0], weights[1])
        own = []

        def replay(lw, dim=0):
            own.append(torch.softmax(lw.detach(), dim=dim))
            return torch.from_numpy(weights[0])

        monkeypatch.setattr(objectives, "dreg_grad_weights", replay)
    assert len(noise) == 1
    telemetry.reset()
    loss, metrics = model.objective(_torch_batch(side.batch), eps=torch.from_numpy(noise[0]))
    loss.backward()
    assert telemetry.summary() == LAUNCHES.get(case, {})
    if obj == "dreg":
        np.testing.assert_allclose(own[0].numpy(), weights[0], atol=1e-5)
    np.testing.assert_allclose(loss.item(), float(jloss), **LOSS_TOL)
    assert sorted(metrics) == sorted(jmetrics)
    for k, v in metrics.items():
        np.testing.assert_allclose(v.item(), float(jmetrics[k]), **LOSS_TOL, err_msg=k)
    want = _port_model(spec, latents, obj, K, components, jgrads)
    rel = GRAD_REL["elbo_gumbel" if "gumbel" in case else obj]
    for (name, p), g in zip(model.named_parameters(), want.parameters()):
        got = torch.zeros_like(p) if p.grad is None else p.grad
        err = (got - g).abs().max().item()
        limit = rel * g.abs().max().item() + GRAD_ATOL
        assert err <= limit, f"{name}: max abs error {err:.3e} > {limit:.3e}"


def test_one_modality_builds_the_unimodal_vae_whatever_the_mixing():
    """build_model of one spec is a UnimodalVAE with the given fields, for
    every mixing name; its forward draws from the generator (the same seed,
    the same latents), and an objective name it does not list runs the
    IWAE bound, as the JAX package's does."""
    specs = (ModalitySpec(**IMAGE),)
    for mixing in ("poe", "moe", "mopoe", "dmvae", "poe2"):
        model = build_model(specs, mixing, 6, obj="iwae", K=3, beta=2.0, device="cpu",
                            remat=True, prior_components=2)
        assert type(model) is UnimodalVAE
        assert (model.obj, model.K, model.beta, model.remat, model.prior_components) == (
            "iwae", 3, 2.0, True, 2)
    batch = _torch_batch(_numpy_batch(IMAGE, 0))
    a = model.forward(batch, ("mod_1",), generator=torch.Generator().manual_seed(0))
    b = model.forward(batch, generator=torch.Generator().manual_seed(0))
    assert a.mods["mod_1"].latents.shape == (3, B, 6)
    torch.testing.assert_close(a.mods["mod_1"].latents, b.mods["mod_1"].latents)
    assert a.mods["mod_1"].decoder_dist.mean.shape == (3, B, 8, 8, 3)
    eps = torch.randn((3, B, 6), generator=torch.Generator().manual_seed(1))
    iwae, _ = model.objective(batch, eps=eps)
    for name in ("elbo_iw", "no_such_objective"):
        model.obj = name
        loss, _ = model.objective(batch, eps=eps)
        assert torch.equal(loss, iwae), name


MOE_SPECS = (dict(IMAGE), dict(name="mod_2", encoder="FNN", decoder="FNN",
                                feature_dims=(10,), recon_loss="mse"))


def test_moe_routes_an_unlisted_objective_name_to_the_k_weighted_bound(monkeypatch):
    """JAX's MOE sends every name but ``elbo`` and ``elbo_iw`` to its
    K-weighted path (IWAE unless ``dreg``); so does the port's: under
    ``iwae_k`` at K 3, loss, metrics and every gradient equal JAX's on its
    draws, and the loss equals the port's own ``iwae`` on them."""
    draws = _Draws(monkeypatch)
    jmodel = jget_mixing("moe")(specs=tuple(JSpec(**k) for k in MOE_SPECS), n_latents=6,
                                obj="iwae_k", K=3)
    rng = np.random.default_rng(2)
    batch = {"mod_1": {"data": rng.random((B, 8, 8, 3)).astype(np.float32), "masks": None},
             "mod_2": {"data": rng.normal(size=(B, 10)).astype(np.float32), "masks": None}}
    jb = jax.tree_util.tree_map(jnp.asarray, batch)
    params = draw_params(jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)}, jb,
        method=jmodel.objective)), 12)

    def loss_fn(p):
        draws.noise.clear()
        loss, metrics = jmodel.apply(p, jb, rngs={"sample": jax.random.PRNGKey(5)},
                                     method=jmodel.objective)
        return loss, (metrics, list(draws.noise))

    (jloss, (jmetrics, noise)), jgrads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(params)

    def port(p, obj):
        model = get_mixing("moe")(tuple(ModalitySpec(**k) for k in MOE_SPECS), 6, K=3,
                                  obj=obj, device="cpu")
        load_flax_params(model, jax.tree_util.tree_map(np.asarray, p))
        return model

    eps = {f"mod_{i + 1}": torch.from_numpy(np.array(e)) for i, e in enumerate(noise)}
    model = port(params, "iwae_k")
    loss, metrics = model.objective(_torch_batch(batch), eps=eps)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), **LOSS_TOL)
    assert sorted(metrics) == sorted(jmetrics)
    for k, v in metrics.items():
        np.testing.assert_allclose(v.item(), float(jmetrics[k]), **LOSS_TOL, err_msg=k)
    for (name, p), g in zip(model.named_parameters(), port(jgrads, "iwae").parameters()):
        got = torch.zeros_like(p) if p.grad is None else p.grad
        err = (got - g).abs().max().item()
        limit = GRAD_REL["iwae"] * g.abs().max().item() + GRAD_ATOL
        assert err <= limit, f"{name}: max abs error {err:.3e} > {limit:.3e}"
    with torch.no_grad():
        iwae, _ = port(params, "iwae").objective(_torch_batch(batch), eps=eps)
    assert torch.equal(iwae, loss.detach())


# -- grow_latents --------------------------------------------------------------------------

# every decoder of the registry with data it decodes, beside an FNN encoder
GROW_DIMS = {"CNN": (32, 32, 3), "SVHN": (32, 32, 3), "SVHN2": (32, 32, 3),
             "MNIST": (28, 28, 1), "MNIST2": (28, 28, 1), "PolyMNIST": (28, 28, 3),
             "RESCNN": (64, 64, 3), "FNN": (10,), "Transformer": (6, 4, 1),
             "TransformerCond": (6, 4), "TxtTransformer": (6, 27), "ConvTxt": (16, 27),
             "TransformerIMG": (2, 64, 64, 3), "VideoGPT": (2, 16, 16, 3),
             "VideoGPTSparse": (2, 32, 32, 3)}
SEQUENCES = {"Transformer", "TransformerCond", "TxtTransformer", "TransformerIMG"}


def _grow_spec(decoder):
    return dict(name="mod_1", encoder="FNN", decoder=decoder,
                feature_dims=GROW_DIMS[decoder], recon_loss="mse",
                has_masks=decoder in SEQUENCES)


def _grow_batch(spec):
    dims = spec["feature_dims"]
    masks = np.ones((2, dims[0]), bool) if spec["has_masks"] else None
    return {"mod_1": {"data": np.zeros((2,) + dims, np.float32), "masks": masks}}


def _leaf_shapes(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaf_shapes(v, prefix + (k,)))
        else:
            out["/".join(prefix + (k,))] = np.shape(v)
    return out


def test_every_decoder_of_the_registry_grows_the_leaf_jax_grows():
    """For a model of each decoder (8 latents, grown to 11) the leaves that
    grow are JAX's (the decoder's input Dense JAX picks by sorted path, the
    encoder heads, the prior).  Where JAX's grown tree fits JAX's grown
    model, it loads into the port's grown model through the bridge; where
    it does not, the port's grow_latents raises: SVHN2 takes z through a
    transposed conv, and Transformer and TxtTransformer at 8 latents (a
    multiple of their 2 heads) take z as their memory with no Dense, which
    the model at 11 has."""
    assert set(GROW_DIMS) == set(JDECODERS)
    misfits = []
    for decoder in sorted(GROW_DIMS):
        spec = _grow_spec(decoder)
        jmodel = _jax_model(spec, 8, "elbo", 1, 1)
        batch = _grow_batch(spec)
        params = _jax_params(jmodel, batch, 3)
        jnew, jgrown = jgrow_latents(params, jmodel, 11)
        jgrown = jax.tree_util.tree_map(np.asarray, jgrown)
        before, after = _leaf_shapes(params["params"]), _leaf_shapes(jgrown["params"])
        jax_grew = {k for k in before if before[k] != after[k]}
        model = _port_model(spec, 8, "elbo", 1, 1)
        old = {k: tuple(v.shape) for k, v in model.state_dict().items()}
        state = grow_state(model, 11)
        port_grew = {k for k in old if tuple(state[k].shape) != old[k]}
        as_flax = {k.rsplit(".", 1)[0].replace(".", "/") for k in port_grew}
        assert as_flax == {k.rsplit("/", 1)[0] for k in jax_grew}, decoder
        assert "pz_logvar" in port_grew and "enc_mod_1.mu_layer.weight" in port_grew
        fits = _leaf_shapes(jax.eval_shape(lambda: jnew.init(
            {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)},
            jax.tree_util.tree_map(jnp.asarray, batch), method=jnew.objective))["params"]
        ) == after
        if fits:
            new_model, _ = grow_latents(model, 11)
            load_flax_params(new_model, jgrown)
        else:
            misfits.append(decoder)
            with pytest.raises(ValueError, match="does not fit"):
                grow_latents(model, 11)
    assert misfits == ["SVHN2", "Transformer", "TxtTransformer"]


def test_grow_latents_keeps_the_old_entries_and_every_field():
    """The grown model holds the old weights in the old rows and columns,
    pads of 1e-3 N(0, 1) from the seed, and every constructor field (remat,
    K, obj, beta, the mixture prior); the same seed gives the same pads;
    growing by 0 keeps the weights; shrinking raises."""
    model = _port_model(IMAGE, 6, "dreg", 3, 4)
    model.remat, model.beta = True, 0.5
    old = {k: v.clone() for k, v in model.state_dict().items()}
    new, state = grow_latents(model, 9, seed=2)
    assert (new.n_latents, new.remat, new.K, new.obj, new.beta, new.prior_components) == (
        9, True, 3, "dreg", 0.5, 4)
    grown = 0
    for k, v in state.items():
        o = old[k]
        if v.shape == o.shape:
            torch.testing.assert_close(v, o, rtol=0, atol=0)
            continue
        grown += 1
        axis = next(i for i, (a, b) in enumerate(zip(v.shape, o.shape)) if a != b)
        assert v.shape[axis] == o.shape[axis] + 3
        torch.testing.assert_close(v.narrow(axis, 0, o.shape[axis]), o, rtol=0, atol=0)
        pad = v.narrow(axis, o.shape[axis], 3)
        assert 0 < pad.abs().max().item() < 1e-2
    # mu and logvar weights and biases, pz_logvar, pz_mog_loc and _rawscale,
    # the decoder's Dense_0
    assert grown == 8
    _, again = grow_latents(model, 9, seed=2)
    assert all(torch.equal(state[k], again[k]) for k in state)
    same, kept = grow_latents(model, 6)
    assert same.n_latents == 6 and all(torch.equal(kept[k], old[k]) for k in old)
    with pytest.raises(ValueError, match="larger"):
        grow_latents(model, 5)


def test_grown_loss_matches_jax_on_its_padded_weights(monkeypatch):
    """JAX's grown tree bridged into the port's grown model gives JAX's
    grown ELBO on the same draws."""
    draws = _Draws(monkeypatch)
    jmodel = _jax_model(IMAGE, 6, "elbo", 2, 1)
    batch = _numpy_batch(IMAGE, 2)
    params = _jax_params(jmodel, batch, 4)
    jnew, jgrown = jgrow_latents(params, jmodel, 8, seed=1)

    def objective(p):
        draws.noise.clear()
        loss, metrics = jnew.apply(p, jax.tree_util.tree_map(jnp.asarray, batch),
                                   rngs={"sample": jax.random.PRNGKey(6)},
                                   method=jnew.objective)
        return loss, metrics, list(draws.noise)

    jloss, jmetrics, noise = jax.jit(objective)(jgrown)
    new, _ = grow_latents(_port_model(IMAGE, 6, "elbo", 2, 1, params), 8)
    load_flax_params(new, jax.tree_util.tree_map(np.asarray, jgrown))
    with torch.no_grad():
        loss, metrics = new.objective(_torch_batch(batch),
                                      eps=torch.from_numpy(np.array(noise[0])))
    np.testing.assert_allclose(loss.item(), float(jloss), **LOSS_TOL)
    for k, v in metrics.items():
        np.testing.assert_allclose(v.item(), float(jmetrics[k]), **LOSS_TOL, err_msg=k)
