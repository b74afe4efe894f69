"""MoPOE, DMVAE, POE2 and the ResNet-50 ``Enc_CNN`` of the port against the
JAX package, on the CPU.

The paper's four-model CdSprites+ comparison (``configs/reproduce_paper/``)
needs them.  Models share weights through ``bridge.load_flax_params``
(FrozenBatchNorm's statistics land in buffers), inputs are made with numpy
from a seed, and the port is fed JAX's own draws, recorded by patching the
JAX ``Normal.rsample`` (as ``tests/test_torch_train.py`` does).  JAX's PoE
and KL run as the JAX package's own model tests run them on the CPU.

Tolerances: loss and metrics as the training slice's (batch sums of ~1e4
in fp32); every gradient within 1e-4 of its leaf's max |g| + 1e-5; the
encoder's (mu, scale) within rtol/atol 1e-4 (fp32 sums in another order
through 53 convs); the mixture selection exactly.
"""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_vae_comparison_tpu.config import Config as JConfig
from multimodal_vae_comparison_tpu.models import distributions as jdist
from multimodal_vae_comparison_tpu.models import get_mixing as jget_mixing
from multimodal_vae_comparison_tpu.models.base import ModalitySpec as JSpec
from multimodal_vae_comparison_tpu.models.encoders import Enc_CNN as JEnc_CNN
from multimodal_vae_comparison_tpu.ops import fusion as jfusion
from multimodal_vae_comparison_tpu.training.trainer import build_model as jbuild_model
from multimodal_vae_comparison_tpu_torch.bridge import load_flax_params
from multimodal_vae_comparison_tpu_torch.config import Config
from multimodal_vae_comparison_tpu_torch.models import get_mixing
from multimodal_vae_comparison_tpu_torch.models.base import ModalitySpec
from multimodal_vae_comparison_tpu_torch.models.encoders import Enc_CNN, get_encoder
from multimodal_vae_comparison_tpu_torch.models.nets import FrozenBatchNorm
from multimodal_vae_comparison_tpu_torch.ops import fusion as tfusion
from multimodal_vae_comparison_tpu_torch.ops.kernels import telemetry
from multimodal_vae_comparison_tpu_torch.training.trainer import build_model_from_config
from test_torch_slice import NARROW, numpy_batch, spec_kwargs, torch_batch

LOSS_TOL = dict(rtol=1e-6, atol=1e-3)   # batch sums of ~1e4 in fp32
FWD_TOL = dict(rtol=1e-4, atol=1e-5)    # decoder means and posteriors
GRAD_REL, GRAD_ATOL = 1e-4, 1e-5
ENC_TOL = dict(rtol=1e-4, atol=1e-4)
PRIVATE = 3
K = 2
# the JAX functions compiled without LLVM's backend optimisation: XLA's own
# graph passes still run, and the compile, most of this file's time, halves
_jit = functools.partial(jax.jit, compiler_options={"xla_backend_optimization_level": 0})
PRESENTS = [("mod_1",), ("mod_2",), ("mod_1", "mod_2")]
# configs/reproduce_paper/<family>: the mixing each names
PAPER = {"mvae": "poe", "mmvae": "moe", "mopoe": "mopoe", "dmvae": "dmvae"}


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """PyTorch on half the cores: beside the threads XLA's CPU client keeps
    after a JAX call, PyTorch on all of them ran this file's ResNet-50 ten
    times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(max(1, n // 2))
    yield
    torch.set_num_threads(n)


def _kwargs(private=PRIVATE):
    return tuple(dict(k, private_latents=private) for k in spec_kwargs(NARROW))


def draw_params(shapes, seed):
    """numpy weights in flax's layout: kernels ~ N(0, 1/fan_in), norm scales
    around 1, FrozenBatchNorm variances in [0.5, 1.5], the rest ~ N(0, 0.1^2)."""
    rng = np.random.default_rng(seed)

    def draw(path, s):
        leaf = path[-1].key
        if leaf == "kernel":
            fan_in = s.shape[0] if len(s.shape) == 3 else math.prod(s.shape[:-1])
            return rng.normal(0, 1 / math.sqrt(fan_in), s.shape).astype(np.float32)
        if leaf == "var":
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        if leaf == "scale":
            return (1 + 0.1 * rng.normal(size=s.shape)).astype(np.float32)
        return (0.1 * rng.normal(size=s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


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


def _jax_pair(mixing, private=PRIVATE):
    """(JAX model, flax params as numpy, port model on the CPU, same weights)."""
    jmodel = jget_mixing(mixing)(specs=tuple(JSpec(**k) for k in _kwargs(private)),
                                 n_latents=NARROW["latents"], K=K)
    jb = jax.tree_util.tree_map(jnp.asarray, numpy_batch(NARROW, 0))
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)}, jb,
        method=jmodel.objective))
    params = draw_params(shapes, 0)
    return jmodel, params, _port(mixing, params, private)


def _port(mixing, params=None, private=PRIVATE):
    model = get_mixing(mixing)(tuple(ModalitySpec(**k) for k in _kwargs(private)),
                               NARROW["latents"], K=K, device="cpu")
    if params is not None:
        load_flax_params(model, params)
    return model


def _torch_batch(batch):
    return torch_batch(batch, tuple(batch))


def _eps(mixing, draws):
    """JAX's draws in the port's form: the one joint draw (MoPOE), one draw
    per subset (POE2), every draw in order (DMVAE)."""
    eps = [torch.from_numpy(np.array(d)) for d in draws]
    return eps[0] if mixing == "mopoe" else eps


def _assert_grads_match(model, jgrads, mixing):
    want = _port(mixing, jax.tree_util.tree_map(np.asarray, jgrads))
    for (name, p), g in zip(model.named_parameters(), want.parameters()):
        got = torch.zeros_like(p) if p.grad is None else p.grad
        err = (got - g).abs().max().item()
        limit = GRAD_REL * g.abs().max().item() + GRAD_ATOL
        assert err <= limit, f"{name}: max abs error {err:.3e} > {limit:.3e}"


# -- the stratified mixture selection ----------------------------------------------


@pytest.mark.parametrize("b", [24, 64, 250])
@pytest.mark.parametrize("s", [3, 7])
def test_mixture_component_selection_matches_jax_exactly(b, s):
    rng = np.random.default_rng(b + s)
    mus = rng.normal(size=(s, b, 5)).astype(np.float32)
    scales = rng.uniform(0.3, 2.0, (s, b, 5)).astype(np.float32)
    want = jfusion.mixture_component_selection(jnp.asarray(mus), jnp.asarray(scales))
    got = tfusion.mixture_component_selection(torch.from_numpy(mus), torch.from_numpy(scales))
    for g, w in zip(got, want):
        assert g.shape == (b, 5)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    sizes = [end - start for start, end in tfusion.mixture_splits(s, b)]
    assert sizes == [int(b / s)] * (s - 1) + [b - (s - 1) * int(b / s)]
    assert {(24, 3): [8, 8, 8], (64, 3): [21, 21, 22],
            (250, 3): [83, 83, 84]}.get((b, s), sizes) == sizes


# -- the ResNet-50 encoder ----------------------------------------------------------


def test_enc_cnn_resnet50_matches_jax_forward_and_gradients():
    """The full ResNet-50 trunk + SiLU + head at batch 2 of 64x64x3: (mu,
    scale), and every parameter's gradient under random cotangents; the
    FrozenBatchNorm statistics are buffers that the bridge fills.  fp32
    through 53 convs keeps the forward within 2e-6 of float64; what can
    move a gradient past the limit is a relu input within rounding of 0
    that the two packages put on opposite sides (one in five million at
    batch 24 moved a leaf by 1e-2 of its max |g|); none does here, at 1 to
    8 PyTorch threads."""
    rng = np.random.default_rng(3)
    x = rng.random((2, 64, 64, 3)).astype(np.float32)
    cot = [rng.normal(size=(2, 11)).astype(np.float32) for _ in range(2)]
    jenc = JEnc_CNN(latent_dim=8, data_dim=(64, 64, 3), latent_private=PRIVATE)
    params = draw_params(jax.eval_shape(lambda: jenc.init(jax.random.PRNGKey(0),
                                                          jnp.asarray(x))), 4)

    def run(p):
        out, vjp = jax.vjp(lambda q: jenc.apply(q, jnp.asarray(x)), p)
        return out, vjp(tuple(jnp.asarray(c) for c in cot))[0]

    (jmu, jscale), jgrads = _jit(run)(params)
    assert get_encoder("CNN") is Enc_CNN
    enc = Enc_CNN(8, (64, 64, 3), PRIVATE)
    load_flax_params(enc, params)
    bns = [m for m in enc.modules() if isinstance(m, FrozenBatchNorm)]
    assert len(bns) == 53 and not any(b.mean.requires_grad for b in bns)
    assert {n for n, _ in enc.named_buffers()} == {
        f"{n}.{s}" for n, m in enc.named_modules() if isinstance(m, FrozenBatchNorm)
        for s in ("mean", "var")}
    np.testing.assert_array_equal(
        enc.ResNet50_0.BottleneckBlock_0.FrozenBatchNorm_3.var.numpy(),
        params["params"]["ResNet50_0"]["BottleneckBlock_0"]["FrozenBatchNorm_3"]["var"])
    mu, scale = enc(torch.from_numpy(x))
    np.testing.assert_allclose(mu.detach().numpy(), np.asarray(jmu), **ENC_TOL)
    np.testing.assert_allclose(scale.detach().numpy(), np.asarray(jscale), **ENC_TOL)
    torch.autograd.backward((mu, scale), [torch.from_numpy(c) for c in cot])
    want = Enc_CNN(8, (64, 64, 3), PRIVATE)
    load_flax_params(want, jax.tree_util.tree_map(np.asarray, jgrads))
    for (name, p), g in zip(enc.named_parameters(), want.parameters()):
        err = (p.grad - g).abs().max().item()
        limit = GRAD_REL * g.abs().max().item() + GRAD_ATOL
        assert err <= limit, f"{name}: max abs error {err:.3e} > {limit:.3e}"


# -- MoPOE, DMVAE, POE2 ------------------------------------------------------------


@pytest.mark.parametrize("mixing,launches", [
    ("mopoe", {"poe:plain": 1, "poe_bwd:plain": 1}),
    ("dmvae", {"poe:plain": 1, "poe_bwd:plain": 1, "kl:plain": 1, "kl_bwd:plain": 1}),
    ("poe2", {"poe:plain": 1, "poe_bwd:plain": 1})])
def test_objective_loss_metrics_and_grads_match_jax(monkeypatch, mixing, launches):
    """Enc_CNN2/Dec_CNN + TxtTransformer at 3 private latents, K 2: loss,
    metrics and every gradient.  MoPOE fuses its subsets in one PoE call,
    DMVAE its joint in one and every private KL in one KL call."""
    rec = _Recorder(monkeypatch)
    jmodel, params, model = _jax_pair(mixing)
    batch = numpy_batch(NARROW, 1)
    jb = jax.tree_util.tree_map(jnp.asarray, batch)

    def loss_fn(p):
        rec.draws.clear()
        loss, metrics = jmodel.apply(p, jb, rngs={"sample": jax.random.PRNGKey(5)},
                                     method=jmodel.objective)
        return loss, (metrics, list(rec.draws))

    (jloss, (jmetrics, draws)), jgrads = _jit(
        jax.value_and_grad(loss_fn, has_aux=True))(params)
    telemetry.reset()
    loss, metrics = model.objective(_torch_batch(batch), eps=_eps(mixing, draws))
    loss.backward()
    assert {k: v for k, v in telemetry.summary().items()
            if not k.startswith("attention")} == launches
    np.testing.assert_allclose(loss.item(), float(jloss), **LOSS_TOL)
    assert sorted(metrics) == sorted(jmetrics)
    for k in metrics:
        np.testing.assert_allclose(metrics[k].item(), float(jmetrics[k]), **LOSS_TOL)
    _assert_grads_match(model, jgrads, mixing)


def _compare(a, b, what):
    np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), **FWD_TOL, err_msg=what)


@pytest.fixture(scope="module")
def jax_forwards():
    """{mixing: (port model, batch, {present: (JAX forward output, its
    draws)})}: the JAX forwards of all three present sets of one model in
    one jitted call, made at first use."""
    cache = {}

    def get(mixing):
        if mixing not in cache:
            with pytest.MonkeyPatch.context() as mp:
                rec = _Recorder(mp)
                jmodel, params, model = _jax_pair(mixing)
                batch = numpy_batch(NARROW, 2)

                def run(p):
                    outs = {}
                    for present in PRESENTS:
                        rec.draws.clear()
                        jb = {n: ({"data": jnp.asarray(m["data"]),
                                   "masks": None if m["masks"] is None
                                   else jnp.asarray(m["masks"])}
                                  if n in present else {"data": None, "masks": None})
                              for n, m in batch.items()}
                        out = jmodel.apply(p, jb, rngs={"sample": jax.random.PRNGKey(6)},
                                           method=lambda m, b, pr=present: m.forward(b, pr))
                        outs[present] = (out, list(rec.draws))
                    return outs

                cache[mixing] = (model, batch, _jit(run)(params))
        return cache[mixing]

    return get


@pytest.mark.parametrize("mixing", ["mopoe", "dmvae", "poe2"])
@pytest.mark.parametrize("present", PRESENTS, ids=["img", "txt", "both"])
def test_forward_matches_jax_for_each_present_subset(jax_forwards, mixing, present):
    """The joint posterior, the decoded means and (DMVAE) the joint and
    cross decodes, with a missing modality imputed: MoPOE mixes only the
    fully present subsets (the prior on none unless all are present),
    DMVAE takes the joint sample and a prior private draw."""
    model, batch, outs = jax_forwards(mixing)
    jout, draws = outs[present]
    eps = _eps(mixing, draws)
    if mixing == "poe2":
        eps = eps[0]
    with torch.inference_mode():
        tout = model.forward(torch_batch(batch, present), present, eps=eps)
    for name in ("mod_1", "mod_2"):
        jm, tm = jout.mods[name], tout.mods[name]
        _compare(tm.joint_dist.loc, jm.joint_dist.loc, f"{name} joint loc")
        _compare(tm.joint_dist.scale, jm.joint_dist.scale, f"{name} joint scale")
        _compare(tm.latents, jm.latents, f"{name} latents")
        _compare(tm.decoder_dist.mean, jm.decoder_dist.mean, f"{name} decoder mean")
        assert (tm.encoder_dist is None) == (name not in present)
        if mixing == "dmvae":
            _compare(tm.joint_decoder_dist.mean, jm.joint_decoder_dist.mean,
                     f"{name} joint decoder mean")
            assert sorted(tm.cross_decoder_dist) == sorted(jm.cross_decoder_dist)
            for other, dist in tm.cross_decoder_dist.items():
                _compare(dist.mean, jm.cross_decoder_dist[other].mean,
                         f"{name} cross from {other}")


def test_mopoe_gives_the_prior_to_the_full_set_only():
    """MoPOE's subset posteriors: a one-modality subset is its expert (no
    prior expert: scale sqrt(scale^2 + EPS)), the full set is the PoE of both
    experts and the prior; the joint takes rows [0, 8) from the first
    subset, [8, 16) from the second and [16, 24) from the full set at B 24."""
    model = _port("mopoe")
    g = torch.Generator().manual_seed(1)
    qz = {n: {"shared": (torch.randn(24, 8, generator=g),
                         torch.rand(24, 8, generator=g) + 0.3)} for n in model.mod_names}
    joint, subsets = model.mix(qz, model.mod_names)
    assert list(subsets) == ["mod_1", "mod_2", "mod_1_mod_2"]
    for name in model.mod_names:
        mu, scale = qz[name]["shared"]
        torch.testing.assert_close(subsets[name].loc, mu, rtol=2 ** -22, atol=0)
        torch.testing.assert_close(subsets[name].scale, (scale.square() + 1e-8).sqrt(),
                                   rtol=2 ** -22, atol=0)
    both = tfusion.product_of_experts(
        torch.stack([qz[n]["shared"][0] for n in model.mod_names]),
        torch.stack([qz[n]["shared"][1] for n in model.mod_names]), include_prior=True)
    torch.testing.assert_close(subsets["mod_1_mod_2"].loc, both[0], rtol=0, atol=0)
    for rows, dist in ((slice(0, 8), subsets["mod_1"]), (slice(8, 16), subsets["mod_2"]),
                       (slice(16, 24), subsets["mod_1_mod_2"])):
        torch.testing.assert_close(joint.loc[rows], dist.loc[rows], rtol=0, atol=0)
    single, only = model.mix(qz, ("mod_2",))
    assert list(only) == ["mod_2"]
    torch.testing.assert_close(single.scale, subsets["mod_2"].scale, rtol=0, atol=0)


def test_dmvae_draws_from_the_generator_and_checks_eps():
    model = _port("dmvae")
    tb = _torch_batch(numpy_batch(NARROW, 3))
    a, _ = model.objective(tb, generator=torch.Generator().manual_seed(3))
    b, _ = model.objective(tb, generator=torch.Generator().manual_seed(3))
    assert a.item() == b.item() and torch.isfinite(a)
    # joint, then per modality shared + private (present) or private alone
    # (missing), and one cross draw from each other present modality
    assert [s[-1] for s in model.eps_shapes(model.mod_names, 3)] == [8, 8, 3, 8, 8, 3, 8]
    assert model.eps_shapes(("mod_1",), 3) == [(K, 3, 8), (K, 3, 8), (K, 3, 3), (K, 3, 3),
                                               (K, 3, 8)]
    with pytest.raises(ValueError, match="7"):
        model.objective(tb, eps=[torch.zeros(K, 3, 8)])


def test_dmvae_without_private_latents_raises_as_jax_does():
    jmodel = jget_mixing("dmvae")(specs=tuple(JSpec(**k) for k in spec_kwargs(NARROW)),
                                  n_latents=NARROW["latents"])
    jb = jax.tree_util.tree_map(jnp.asarray, numpy_batch(NARROW, 0))
    with pytest.raises(AssertionError, match="private_latents"):
        jmodel.init({"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)},
                    jb, method=jmodel.objective)
    model = _port("dmvae", private=None)
    with pytest.raises(ValueError, match="private_latents"):
        model.objective(_torch_batch(numpy_batch(NARROW, 0)))


# -- the paper's configs ----------------------------------------------------------


def _paper_config(cls, family):
    cfg = cls(f"configs/reproduce_paper/{family}/level1/level1_0.yml", eval_only=True)
    for m, dims in zip(cfg.mods, ([64, 64, 3], [45, 27])):
        m.feature_dims = dims
    return cfg


@pytest.fixture(scope="module")
def paper_tree():
    """The flax parameter shapes of the JAX package's model built from the
    MVAE level-1 config (ResNet-50 image encoder, 16 shared + 10 private
    latents).  The four families' configs differ only in ``mixing``, and
    every mixing class of the JAX package holds the same submodules."""
    jmodel = jbuild_model(_paper_config(JConfig, "mvae"))
    batch = {"mod_1": {"data": jax.ShapeDtypeStruct((2, 64, 64, 3), jnp.float32),
                       "masks": None},
             "mod_2": {"data": jax.ShapeDtypeStruct((2, 45, 27), jnp.float32),
                       "masks": jax.ShapeDtypeStruct((2, 45), jnp.bool_)}}
    return jmodel.specs, jax.eval_shape(lambda b: jmodel.init(
        {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)}, b,
        method=lambda m, x: m.forward(x, ("mod_1", "mod_2"))), batch)


@pytest.mark.parametrize("family", PAPER)
def test_build_model_from_config_builds_the_paper_configs(family, paper_tree):
    """Each reproduce_paper level-1 config builds on the CPU through the
    port's Config and build_model_from_config: the mixing class the JAX
    package builds from it, Enc_CNN on the images, and a parameter and
    buffer set that the JAX package's model fills leaf for leaf."""
    model = build_model_from_config(_paper_config(Config, family), device="cpu")
    jmodel = jbuild_model(_paper_config(JConfig, family))
    specs, shapes = paper_tree
    assert jmodel.specs == specs and jmodel.n_latents == model.n_latents
    assert type(model).__name__ == type(jmodel).__name__
    assert type(model) is get_mixing(PAPER[family])
    assert model.device.type == "cpu"
    assert isinstance(model.enc_mod_1, Enc_CNN) and model.n_latents == 16
    assert [s.private_latents for s in model.specs] == [10, 10]
    load_flax_params(model, jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes))
