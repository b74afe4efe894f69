"""The perceptual loss ``feature_loss`` and the FID of the port against the
JAX package, on the CPU, on one synthetic torchvision-layout ``vgg19``
(and ``inception_v3``) file installed for both packages in a temporary
``MVAE_TPU_WEIGHTS_DIR``.

``feature_loss`` (loss and gradient with respect to the reconstruction,
``batch_ndims`` 1 and 2) within 1e-5 of the largest |value|; a POE ELBO
and a MOE IWAE objective with ``recon_loss: feature_loss``: loss, metrics
and every gradient at tests/test_torch_train.py's limits; the extractor
frozen and outside the model; its fixed random weights flax's init;
``frechet_distance`` on the same (mu, sigma) to 1e-12; the FID's features
within 1e-5 (VGG) and 1e-4 (Inception) of the largest |value|, the VGG
FID within 1e-3 relative; ``active_feature_net``'s labels; and
chip_smoke.py's launch tables of its CelebA ``feature_loss`` runs.
"""
import math
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_vae_comparison_tpu.eval import fid as jfid
from multimodal_vae_comparison_tpu.models import distributions as jdist
from multimodal_vae_comparison_tpu.models import get_mixing as jget_mixing
from multimodal_vae_comparison_tpu.models import perceptual as jperceptual
from multimodal_vae_comparison_tpu.models.base import ModalitySpec as JSpec
from multimodal_vae_comparison_tpu_torch.bridge import load_flax_params
from multimodal_vae_comparison_tpu_torch.eval import fid
from multimodal_vae_comparison_tpu_torch.eval import weights as W
from multimodal_vae_comparison_tpu_torch.models import get_mixing, objectives, perceptual
from multimodal_vae_comparison_tpu_torch.models.base import ModalitySpec
from test_torch_slice import draw_params, one_torch_thread  # noqa: F401 (autouse)
from test_torch_weights import torchvision_inception_sd, torchvision_vgg19_sd

FEATURE_TOL = 1e-5
INCEPTION_TOL = 1e-4
FID_RTOL = 1e-3
LOSS_TOL = dict(rtol=1e-6, atol=1e-3)   # tests/test_torch_train.py's
GRAD_REL = {"elbo": 1e-4, "iwae": 2e-3}


def _close(got, want, rel):
    err = np.abs(np.asarray(got) - np.asarray(want)).max()
    limit = rel * np.abs(np.asarray(want)).max()
    assert err <= limit, f"max abs error {err:.3e} > {limit:.3e}"


def _reset():
    perceptual.reset_extractor_cache()
    jperceptual.reset_extractor_cache()


@pytest.fixture
def weights_dir(tmp_path, monkeypatch):
    """An empty weights directory for both packages, their extractor caches
    reset before and after."""
    monkeypatch.setenv("MVAE_TPU_WEIGHTS_DIR", str(tmp_path))
    _reset()
    yield tmp_path
    _reset()


@pytest.fixture
def vgg19(weights_dir):
    """A synthetic torchvision vgg19 installed as ``vgg19.npz``."""
    sd = torchvision_vgg19_sd(np.random.default_rng(11))
    np.savez(weights_dir / "vgg19.npz", **sd)
    return sd


# -- the extractor ------------------------------------------------------------------------


def test_extractor_fixed_random_is_flax_init_and_frozen(weights_dir):
    """Without a vgg19 file: source ``fixed-random``; every kernel a normal
    of std 1 / sqrt(fan_in) cut at 2 std, biases 0, the same draw each
    time; the extractor takes no gradient and is cached per device and
    dtype."""
    assert perceptual.extractor_source() == "fixed-random"
    state = perceptual.extractor_params()
    for name, v in state.items():
        if name.endswith(".bias"):
            assert not v.any(), name
            continue
        std = 1 / math.sqrt(v[0].numel())
        assert v.abs().max().item() <= 2 * std / 0.87962566103423978 + 1e-7, name
        assert abs(v.std().item() / std - 1) < 0.05, name
    perceptual.reset_extractor_cache()
    for k, v in perceptual.extractor_params().items():
        assert torch.equal(v, state[k]), k
    net = perceptual.extractor("cpu")
    assert net is perceptual.extractor("cpu") and net is not perceptual.extractor(
        "cpu", torch.float64)
    assert not any(p.requires_grad for p in net.parameters())


def test_extractor_picks_up_an_installed_vgg19(vgg19):
    """With a vgg19 file: source ``torchvision-vgg19``, the converted file
    (as the JAX package's extractor reads it, bridged)."""
    assert perceptual.extractor_source() == jperceptual.extractor_source() == (
        "torchvision-vgg19")
    want = W.convert_vgg19(vgg19)
    for k, v in perceptual.extractor_params().items():
        assert torch.equal(v, want[k]), k
    net = perceptual.extractor("cpu")
    jnet = type(net)()
    load_flax_params(jnet, jperceptual.extractor_params())
    for (k, a), b in zip(net.state_dict().items(), jnet.state_dict().values()):
        assert torch.equal(a, b), k


# -- feature_loss against JAX ----------------------------------------------------------------


@pytest.mark.parametrize("lead", [(3,), (2, 3)], ids=["batch_ndims1", "batch_ndims2"])
def test_feature_loss_and_its_gradient_match_jax(vgg19, lead):
    """``feature_loss`` on (lead..., 16, 16, 3) reconstructions of (3, 16,
    16, 3) targets: the per-(K, B) values and the gradient of a weighted
    sum with respect to the reconstruction, within 1e-5 of the largest
    |value|; the target gets no gradient; a mask changes nothing.  The
    port's convs run PyTorch's native CPU kernels here: oneDNN's fp32 conv
    backward rounds the input gradient to ~1e-5 of its largest |value|
    (1.06e-5 against float64 at batch_ndims 2, where JAX's and the native
    kernels' are within 2e-7), which is the CPU library's, not the loss's."""
    rng = np.random.default_rng(12)
    recon = rng.random(lead + (16, 16, 3)).astype(np.float32)
    target = rng.random((3, 16, 16, 3)).astype(np.float32)
    up = rng.normal(size=lead).astype(np.float32)
    nd = len(lead)

    def jloss(r):
        dist = jdist.Normal(r, jnp.asarray(0.75))
        return jperceptual.feature_loss(dist, jnp.asarray(target), None, nd)

    want, vjp = jax.vjp(jloss, jnp.asarray(recon))
    (want_grad,) = vjp(jnp.asarray(up))
    r = torch.from_numpy(recon).requires_grad_(True)
    t = torch.from_numpy(target).requires_grad_(True)
    with torch.backends.mkldnn.flags(enabled=False):
        got = objectives.recon_log_prob("feature_loss", types.SimpleNamespace(mean=r), t,
                                        torch.ones(3, 16, dtype=torch.bool), nd)
        (got * torch.from_numpy(up)).sum().backward()
    assert got.shape == lead
    _close(got.detach().numpy(), want, FEATURE_TOL)
    _close(r.grad.numpy(), want_grad, FEATURE_TOL)
    assert t.grad is None
    with pytest.raises(AssertionError, match="feature_loss is for"):
        perceptual.feature_loss(types.SimpleNamespace(mean=r[..., 0]), t[..., 0], None, nd)


IMAGE = dict(name="mod_1", encoder="FNN", decoder="FNN", feature_dims=(16, 16, 3),
             mod_type="image", recon_loss="feature_loss")
VECTOR = dict(name="mod_2", encoder="FNN", decoder="FNN", feature_dims=(10,),
              recon_loss="mse")


def _batch(seed, b=4):
    rng = np.random.default_rng(seed)
    return {"mod_1": {"data": rng.random((b, 16, 16, 3)).astype(np.float32), "masks": None},
            "mod_2": {"data": rng.normal(size=(b, 10)).astype(np.float32), "masks": None}}


@pytest.mark.parametrize("mixing,obj,K", [("poe", "elbo", 1), ("moe", "iwae", 2)],
                         ids=["poe-elbo", "moe-iwae"])
def test_objective_with_feature_loss_matches_jax(vgg19, monkeypatch, mixing, obj, K):
    """A POE ELBO and a MOE IWAE K 2 objective over a feature_loss image and
    an mse vector, from bridged weights on JAX's draws: loss, metrics and
    every parameter gradient at tests/test_torch_train.py's limits; the
    extractor's weights are in neither model's parameters."""
    draws = []

    def rsample(dist, key, sample_shape=()):
        eps = jax.random.normal(key, tuple(sample_shape) + jnp.shape(dist.loc))
        draws.append(eps)
        return dist.loc + eps * dist.scale

    monkeypatch.setattr(jdist.Normal, "rsample", rsample)
    specs = (IMAGE, VECTOR)
    jmodel = jget_mixing(mixing)(specs=tuple(JSpec(**s) for s in specs), n_latents=6,
                                 obj=obj, K=K)
    batch = _batch(1)
    jb = jax.tree_util.tree_map(jnp.asarray, batch)
    params = draw_params(jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)}, jb,
        method=jmodel.objective)), 0)

    def loss_fn(p):
        draws.clear()
        loss, metrics = jmodel.apply(p, jb, rngs={"sample": jax.random.PRNGKey(5)},
                                     method=jmodel.objective)
        return loss, (metrics, list(draws))

    (jloss, (jmetrics, jdraws)), jgrads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(params)

    def port(p):
        model = get_mixing(mixing)(tuple(ModalitySpec(**s) for s in specs), 6, K=K, obj=obj,
                                   device="cpu")
        load_flax_params(model, jax.tree_util.tree_map(np.asarray, p))
        return model

    model = port(params)
    eps = [torch.from_numpy(np.array(d)) for d in jdraws]
    if mixing == "moe":
        eps = {s.name: e for s, e in zip(model.specs, eps)}
    tb = {n: {"data": torch.from_numpy(m["data"]), "masks": None} for n, m in batch.items()}
    loss, metrics = model.objective(tb, eps=eps)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), **LOSS_TOL)
    assert sorted(metrics) == sorted(jmetrics)
    for k in metrics:
        np.testing.assert_allclose(metrics[k].item(), float(jmetrics[k]), **LOSS_TOL,
                                   err_msg=k)
    want = port(jgrads)
    for (name, p), g in zip(model.named_parameters(), want.parameters()):
        got = torch.zeros_like(p) if p.grad is None else p.grad
        err = (got - g).abs().max().item()
        limit = GRAD_REL[obj] * g.abs().max().item() + 1e-6
        assert err <= limit, f"{name}: max abs error {err:.3e} > {limit:.3e}"
    ext = {id(p) for p in perceptual.extractor("cpu").parameters()}
    assert not ext & {id(p) for p in model.parameters()}
    assert not any(k.startswith("Conv_") for k in model.state_dict())


# -- FID ---------------------------------------------------------------------------------------


def test_frechet_distance_equals_jax():
    """On the same (mu, sigma): well conditioned, and a singular pair from
    fewer samples than features (sqrtm's ill-conditioned case)."""
    rng = np.random.default_rng(13)
    for n, d in ((200, 16), (8, 32)):
        a, b = rng.normal(size=(n, d)), rng.normal(size=(n, d)) + 0.3
        args = (a.mean(0), np.cov(a, rowvar=False), b.mean(0), np.cov(b, rowvar=False))
        np.testing.assert_allclose(fid.frechet_distance(*args), jfid.frechet_distance(*args),
                                   rtol=1e-12)


def _images(seed, n=20, size=32):
    return np.random.default_rng(seed).random((n, size, size, 3)).astype(np.float32)


def test_calculate_fid_given_data_matches_jax_on_vgg19(vgg19, capsys):
    """VGG19 features (the mean of the last pool map) of the port on the
    CPU and the JAX package on the same installed vgg19 within 1e-5; the
    FID of two sets within 1e-3 relative, each package printing the label
    ``vgg19_pretrained``."""
    real, generated = _images(14), np.clip(_images(15) * 0.5 + _images(14) * 0.5, 0, 1)
    got_fn, want_fn = fid.default_feature_fn(device="cpu"), jfid.default_feature_fn()
    got, want = got_fn(real), want_fn(real)
    assert got.shape == (20, 256)
    _close(got, want, FEATURE_TOL)
    capsys.readouterr()
    got_fid = fid.calculate_fid_given_data(real, generated, device="cpu")
    want_fid = jfid.calculate_fid_given_data(real, generated)
    assert capsys.readouterr().out.count("[fid] feature net: vgg19_pretrained") == 2
    assert got_fid > 0
    np.testing.assert_allclose(got_fid, want_fid, rtol=FID_RTOL)


def test_fid_uses_inception_when_installed(weights_dir):
    """With an inception_v3 file the default features are InceptionV3's
    2048 from the resize of 32 px images, as the JAX package's from the
    same file, and so their mean, within 1e-4 of the largest |value|.
    (Synthetic Inception weights map every image to nearly the same
    features, a covariance of ~1e-10 and an FID of ~1e-8 between any two
    sets: the FID itself is held on VGG's features above.)"""
    sd = torchvision_inception_sd(np.random.default_rng(16))
    np.savez(weights_dir / "inception_v3.npz", **sd)
    images = _images(17, n=4)
    got_fn, want_fn = fid.default_feature_fn(device="cpu"), jfid.default_feature_fn()
    got, want = got_fn(images), want_fn(images)
    assert got.shape == (4, 2048)
    _close(got, want, INCEPTION_TOL)
    _close(fid.activation_statistics(images, lambda x: got)[0],
           jfid.activation_statistics(images, lambda x: want)[0], INCEPTION_TOL)


def test_active_feature_net_labels(weights_dir):
    """The label follows the installed files, as the JAX package's:
    ``vgg19_fixed_random``, ``vgg19_pretrained`` with a vgg19 file,
    ``inception_v3`` once an inception_v3 file is there too."""
    assert fid.active_feature_net() == jfid.active_feature_net() == "vgg19_fixed_random"
    np.savez(weights_dir / "vgg19.npz", **torchvision_vgg19_sd(np.random.default_rng(19)))
    assert fid.active_feature_net() == jfid.active_feature_net() == "vgg19_pretrained"
    sd = torchvision_inception_sd(np.random.default_rng(20))
    np.savez(weights_dir / "inception_v3.npz", **sd)
    assert fid.active_feature_net() == jfid.active_feature_net() == "inception_v3"
    os.remove(weights_dir / "inception_v3.npz")
    assert fid.active_feature_net() == "vgg19_pretrained"


# -- chip_smoke.py's eval-remainder launch tables ----------------------------------------------


def _chip_smoke():
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, repo)
    try:
        import chip_smoke
    finally:
        sys.path.remove(repo)
    return chip_smoke


@pytest.mark.parametrize("key", ["celeba", "moe_iwae"])
def test_chip_smoke_eval_rest_launch_tables_hold_on_the_cpu(weights_dir, key):
    """chip_smoke.py's EVAL_REST_PER_OBJECTIVE and _PER_BACKWARD: one
    objective call of ``config_celeba.yml`` under ``feature_loss`` (as POE
    ELBO, and as MOE IWAE K 5) at bs 2, then its backward, take the
    kernels' plain versions exactly that many times."""
    from multimodal_vae_comparison_tpu_torch.ops.kernels import telemetry
    from multimodal_vae_comparison_tpu_torch.training.trainer import build_model_from_config
    cs = _chip_smoke()
    edit = {"celeba": cs._feature_loss_edit, "moe_iwae": cs._moe_iwae_edit}[key]
    cfg = cs.from_config(cs.EVAL_REST_CONFIG, {}, str(weights_dir), eval_only=True, edit=edit)
    for m, dims in zip(cfg.mods, ([64, 64, 3], [4, 2])):
        m.feature_dims = dims
    assert cfg.mods[0].recon_loss == "feature_loss"
    model = build_model_from_config(cfg, device="cpu")
    rng = np.random.default_rng(21)
    batch = {"mod_1": {"data": torch.from_numpy(rng.random((2, 64, 64, 3)).astype(np.float32)),
                       "masks": None},
             "mod_2": {"data": torch.from_numpy(np.eye(2, dtype=np.float32)[
                 rng.integers(0, 2, (2, 4))]), "masks": None}}
    telemetry.reset()
    loss, _ = model.objective(batch, generator=torch.Generator().manual_seed(0))
    call = {k.split(":")[0]: n for k, n in telemetry.summary().items()}
    loss.backward()
    after = {k.split(":")[0]: n for k, n in telemetry.summary().items()}
    backward = {k: n - call.get(k, 0) for k, n in after.items() if n != call.get(k, 0)}
    assert call == cs.EVAL_REST_PER_OBJECTIVE[key]
    assert backward == cs.EVAL_REST_PER_BACKWARD[key]
    assert torch.isfinite(loss)
