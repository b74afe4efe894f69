"""MNIST-SVHN in the port against the JAX package, on the CPU.

The port's copy of the 8x8 digits equals sklearn's ``load_digits``; its
copy of the pair builder writes the JAX builder's files from the same seed;
``MNIST_SVHN`` gives JAX's arrays, labels and decoded outputs from ``.npy``
and ``.pt`` index files; ``Laplace`` and ``lprob`` give JAX's values; the
SVHN and MNIST variants among the nets give JAX's outputs and gradients
from carried weights; the MOE DReG objective of ``config_mnistsvhn.yml``
with its Laplace posteriors (K 2, bs 4, 8 latents), the port fed JAX's
uniform draws, gives JAX's loss, metrics and gradients, which the old
Normal stop-gradient posterior does not; both configs build with the JAX
tree; cross and joint coherence give JAX's on bridged judges and the
benchmark JAX's stats and stats file on fixed ones; chip_smoke.py's launch
counts hold on the CPU.

Tolerances: the glyphs, the builder's files and the dataset's arrays
exactly; Laplace and lprob within rtol 1e-6; the nets' outputs within
1e-5 and their gradients within 1e-4 of each leaf's max |g| + 1e-5; the
DReG loss and metrics within rtol 1e-6 (+ atol 1e-3 for fp32 sums of
~1e4), its gradients within 2e-3 of each leaf's max |g| + 1e-6
(tests/test_torch_train.py's limit for the K-weighted bounds); the stats
within rtol 1e-12.
"""
import os
import sys
import types
import zipfile
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from multimodal_vae_comparison_tpu.config import Config as JConfig
from multimodal_vae_comparison_tpu.data import datasets as jdatasets
from multimodal_vae_comparison_tpu.data.datamodule import DataModule as JDataModule
from multimodal_vae_comparison_tpu.data_proc import mnistsvhn as jbuilder
from multimodal_vae_comparison_tpu.eval import classifiers as jclassifiers
from multimodal_vae_comparison_tpu.eval import eval_mnistsvhn as jmnistsvhn
from multimodal_vae_comparison_tpu.models import decoders as jdecoders
from multimodal_vae_comparison_tpu.models import distributions as jdist
from multimodal_vae_comparison_tpu.models import encoders as jencoders
from multimodal_vae_comparison_tpu.models import objectives as jobj
from multimodal_vae_comparison_tpu.training.trainer import build_model as jbuild_model
from multimodal_vae_comparison_tpu_torch.bridge import load_flax_params
from multimodal_vae_comparison_tpu_torch.config import Config
from multimodal_vae_comparison_tpu_torch.data import datasets
from multimodal_vae_comparison_tpu_torch.data.datamodule import DataModule
from multimodal_vae_comparison_tpu_torch.data_proc import digits
from multimodal_vae_comparison_tpu_torch.data_proc import mnistsvhn as builder
from multimodal_vae_comparison_tpu_torch.eval import classifiers, eval_mnistsvhn
from multimodal_vae_comparison_tpu_torch.models import decoders, distributions, encoders, mmvae
from multimodal_vae_comparison_tpu_torch.models import objectives
from multimodal_vae_comparison_tpu_torch.ops.kernels import telemetry
from multimodal_vae_comparison_tpu_torch.training.trainer import build_model_from_config
from test_torch_families import _assert_same_run, _fake_exps, _JaxJudge, _patch_judges, _PortJudge
from test_torch_slice import one_torch_thread  # noqa: F401 (autouse)
from test_torch_vilanro import _torch_batch
from test_torch_vilanro_cond import _init_all
from test_torch_zoo import draw_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = ("configs/config_mnistsvhn.yml", "configs/round2/config_mnistsvhn_r2.yml")
DIST_TOL = dict(rtol=1e-6, atol=1e-6)
NET_TOL = dict(rtol=1e-5, atol=1e-5)
LOSS_TOL = dict(rtol=1e-6, atol=1e-3)
GRAD_REL, GRAD_ATOL = 1e-4, 1e-5
DREG_GRAD_REL, DREG_GRAD_ATOL = 2e-3, 1e-6
SPLITS = ("train", "test")


def test_glyph_copy_equals_load_digits():
    """The committed copy gives sklearn's images (float64) and targets
    (int64) byte for byte."""
    sk = pytest.importorskip("sklearn.datasets").load_digits()
    got = digits.load_digits()
    for a, b in ((got.images, sk.images), (got.target, sk.target)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    assert got.images.shape == (1797, 8, 8)


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """The surrogate built by both packages' builders at 2 train and 1 test
    pairings, seed 3: (port's directory, JAX's directory)."""
    pytest.importorskip("cv2")
    pytest.importorskip("sklearn")
    root = tmp_path_factory.mktemp("mnistsvhn")
    dirs = []
    for tag, module in (("port", builder), ("jax", jbuilder)):
        d = str(root / tag)
        assert module.build_surrogate(d, pairs_train=2, pairs_test=1, seed=3) == d
        dirs.append(d)
    return tuple(dirs)


def test_builder_writes_the_jax_files_for_a_seed(built):
    """The same files; the index arrays and SURROGATE.txt byte for byte;
    each archive's members (``data.npy``, ``labels.npy``) byte for byte
    (the archives differ only in their members' zip timestamps)."""
    port_dir, jax_dir = built
    names = sorted(os.listdir(port_dir))
    assert names == sorted(os.listdir(jax_dir)) == sorted(
        ["SURROGATE.txt", "mnist.npz", "svhn.npz"]
        + [f"{m}_idx_{s}.npy" for m in ("mnist", "svhn") for s in SPLITS])
    for name in names:
        a, b = os.path.join(port_dir, name), os.path.join(jax_dir, name)
        if name.endswith(".npz"):
            with zipfile.ZipFile(a) as x, zipfile.ZipFile(b) as y:
                assert x.namelist() == y.namelist() == ["data.npy", "labels.npy"]
                for member in x.namelist():
                    assert x.read(member) == y.read(member), (name, member)
        else:
            with open(a, "rb") as x, open(b, "rb") as y:
                assert x.read() == y.read(), name
    with np.load(os.path.join(port_dir, "svhn.npz")) as f:
        assert f["data"].shape == (1797, 32, 32, 3) and f["data"].dtype == np.uint8


def _index_paths(d, as_pt, tmp_path):
    """(train, test) index files of ``d``: its ``.npy`` files, or the same
    arrays saved as ``.pt`` beside copies of the digit archives."""
    out = []
    for split in SPLITS:
        paths = {m: os.path.join(d, f"{m}_idx_{split}.npy") for m in ("mnist", "svhn")}
        if as_pt:
            for m, p in paths.items():
                dst = os.path.join(tmp_path, f"{split}-ms-{m}-idx.pt")
                torch.save(torch.from_numpy(np.load(p)), dst)
                paths[m] = dst
        out.append(paths)
    if as_pt:
        for name in ("mnist.npz", "svhn.npz"):
            os.link(os.path.join(d, name), os.path.join(tmp_path, name))
    return out


@pytest.mark.parametrize("as_pt", [False, True], ids=["npy", "pt"])
@pytest.mark.parametrize("mod_type", ["mnist", "svhn"])
def test_dataset_gives_jax_arrays_labels_and_decodes(built, tmp_path, mod_type, as_pt):
    """Train and test arrays (every 7th pair from the second, NHWC in
    [0, 1]), the digit labels, the feature dims and the decoded output
    equal the JAX class's, from ``.npy`` and ``.pt`` index files."""
    train, test = _index_paths(built[0], as_pt, tmp_path)
    got = datasets.get_dataset_class("mnist_svhn")(train[mod_type], test[mod_type], mod_type)
    want = jdatasets.get_dataset_class("mnist_svhn")(train[mod_type], test[mod_type], mod_type)
    for split in SPLITS:
        (gd, gm), (wd, wm) = got.get_data(split), want.get_data(split)
        assert gd.dtype == wd.dtype == np.float32 and gm is wm is None
        np.testing.assert_array_equal(gd, wd)
        np.testing.assert_array_equal(got.labels(), want.labels())
        np.testing.assert_array_equal(got.decode_output(gd[:5]), want.decode_output(wd[:5]))
    n_test = len(np.load(os.path.join(built[0], f"{mod_type}_idx_test.npy")))
    assert len(gd) == len(range(1, n_test, 7))
    assert gd.shape[1:] == tuple(got.feature_dims[mod_type])
    assert got.feature_dims == want.feature_dims and got.text2img_size == want.text2img_size
    assert got.eval_statistics_fn() is eval_mnistsvhn.mnistsvhn_eval


# -- Laplace and lprob ------------------------------------------------------------------


def _laplace_pair(seed, shape):
    rng = np.random.default_rng(seed)
    loc = rng.normal(size=shape).astype(np.float32)
    scale = rng.uniform(0.2, 2.0, shape).astype(np.float32)
    return (distributions.Laplace(torch.from_numpy(loc), torch.from_numpy(scale)),
            jdist.Laplace(jnp.asarray(loc), jnp.asarray(scale)))


def test_laplace_log_prob_kl_and_rsample_match_jax():
    """log_prob, the closed-form KL (also through kl_divergence) and
    rsample on JAX's own uniform draw (made with JAX's key, minval and
    maxval) within rtol 1e-6; ``get_dist`` names the family."""
    t, j = _laplace_pair(0, (3, 5))
    t2, j2 = _laplace_pair(1, (1, 5))
    x = np.random.default_rng(2).normal(size=(2, 3, 5)).astype(np.float32)
    np.testing.assert_allclose(t.log_prob(torch.from_numpy(x)).numpy(),
                               np.asarray(j.log_prob(jnp.asarray(x))), **DIST_TOL)
    np.testing.assert_allclose(t.kl(t2).numpy(), np.asarray(j.kl(j2)), **DIST_TOL)
    np.testing.assert_allclose(distributions.kl_divergence(t, t2).numpy(),
                               np.asarray(jdist.kl_divergence(j, j2)), **DIST_TOL)
    key = jax.random.PRNGKey(4)
    u = jax.random.uniform(key, (4, 3, 5), minval=-0.5 + 1e-7, maxval=0.5 - 1e-7)
    np.testing.assert_allclose(t.rsample((4,), eps=torch.from_numpy(np.array(u))).numpy(),
                               np.asarray(j.rsample(key, (4,))), **DIST_TOL)
    assert distributions.get_dist("Laplace") is distributions.Laplace
    assert (t.U_LOW, t.U_HIGH) == (-0.5 + 1e-7, 0.5 - 1e-7)


def test_laplace_rsample_draws_from_the_generator_inside_the_open_interval():
    """The generator's draw is reproducible, within the uniform's open
    interval (a finite sample at the edges), and a wrong eps shape raises;
    stop_gradient keeps the family and drops the graph."""
    loc = torch.zeros(2, 3, requires_grad=True)
    t = distributions.Laplace(loc, torch.ones(2, 3))
    a = t.rsample((50,), generator=torch.Generator().manual_seed(0))
    b = t.rsample((50,), generator=torch.Generator().manual_seed(0))
    assert a.shape == (50, 2, 3) and torch.equal(a, b) and torch.isfinite(a).all()
    edge = t.rsample((1,), eps=torch.full((1, 2, 3), t.U_HIGH))
    assert torch.isfinite(edge).all()
    with pytest.raises(ValueError, match="expected"):
        t.rsample((2,), eps=torch.zeros(3, 2, 3))
    q = distributions.stop_gradient(t)
    assert type(q) is distributions.Laplace and not q.loc.requires_grad


@pytest.mark.parametrize("masked", [False, True])
def test_lprob_value_and_gradient_match_jax(masked):
    """lprob of a (K=2, B=3, 6, 5) decoder Normal at scale 0.75 (a NaN term
    counted as 0), with and without a step mask: value and gradient in the
    mean within rtol 1e-6."""
    rng = np.random.default_rng(7)
    mean = rng.normal(size=(2, 3, 6, 5)).astype(np.float32)
    target = rng.normal(size=(3, 6, 5)).astype(np.float32)
    target[0, 0, 0] = np.nan
    mask = np.arange(6)[None] < np.array([[2], [6], [4]]) if masked else None
    tm = torch.from_numpy(mean).requires_grad_()
    got = objectives.recon_log_prob("lprob", distributions.Normal(tm, torch.tensor(0.75)),
                                    torch.from_numpy(target),
                                    None if mask is None else torch.from_numpy(mask), 2)
    got.sum().backward()

    def f(m):
        return jobj.recon_log_prob("lprob", jdist.Normal(m, jnp.asarray(0.75)),
                                   jnp.asarray(target),
                                   None if mask is None else jnp.asarray(mask), 2)

    want, vjp = jax.vjp(f, jnp.asarray(mean))
    assert got.shape == (2, 3) and torch.isfinite(got).all()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **DIST_TOL)
    np.testing.assert_allclose(tm.grad.numpy(), np.asarray(vjp(jnp.ones_like(want))[0]),
                               **DIST_TOL)


def test_lprob_is_ported_and_feature_loss_still_raises():
    """``lprob`` is in the port's loss table; ``feature_loss``, which raised
    until the perceptual loss was ported, is in it too, as in the JAX
    package's; a name neither table has still raises ``KeyError``."""
    from multimodal_vae_comparison_tpu.models import objectives as jobjectives
    for name in ("lprob", "feature_loss"):
        assert name in objectives.RECON_LOSSES and name in jobjectives.RECON_LOSSES
        objectives.check_ported(name)
    with pytest.raises(KeyError, match="no_such_loss"):
        objectives.check_ported("no_such_loss")


# -- the nets ---------------------------------------------------------------------------


NETS = [("enc", "SVHN", (32, 32, 3)), ("enc", "SVHN2", (32, 32, 3)),
        ("enc", "MNISTMoE", (28, 28, 1)), ("dec", "SVHN", (32, 32, 3)),
        ("dec", "SVHN2", (32, 32, 3)), ("dec", "MNIST2", (28, 28, 1))]
# XLA's CPU compile option of the comparisons: LLVM's expensive passes off
# shorten a compile; the DReG objective compiles with XLA's defaults
FAST_COMPILE = {"xla_llvm_disable_expensive_passes": True}


def lower_net(kind, name, dims, seed):
    """(port-side inputs, JAX's lowered function, its args) of the net
    ``name`` at 20 latents, bs 4, on numpy inputs from ``seed``: the
    function gives JAX's outputs and the gradient in every weight of a
    random cotangent of the first output."""
    rng = np.random.default_rng(seed)
    if kind == "enc":
        x = rng.uniform(size=(4,) + dims).astype(np.float32)
        jnet, net_cls = jencoders.ENCODERS[name](latent_dim=20, data_dim=dims), \
            encoders.get_encoder(name)
    else:
        x = rng.normal(size=(4, 20)).astype(np.float32)
        jnet, net_cls = jdecoders.DECODERS[name](latent_dim=20, data_dim=dims), \
            decoders.get_decoder(name)
    apply = lambda p: jnet.apply(p, jnp.asarray(x))
    params = draw_params(jax.eval_shape(lambda: jnet.init(jax.random.PRNGKey(0),
                                                          jnp.asarray(x))), seed + 1)
    cot = rng.normal(size=jax.eval_shape(apply, params)[0].shape).astype(np.float32)

    def out_and_grads(p):
        want, vjp = jax.vjp(apply, p)
        (grads,) = vjp((jnp.asarray(cot),) + tuple(jnp.zeros_like(w) for w in want[1:]))
        return want, grads

    side = types.SimpleNamespace(x=x, cot=cot, params=params, cls=net_cls, dims=dims)
    return side, jax.jit(out_and_grads).lower(params), (params,)


def compile_all(lowered):
    """{key: (port-side inputs, JAX's outputs as numpy)} from ``lowered``,
    an iterable of (key, (side, lowered function, args, compile options)):
    each function is compiled and run in a pool of threads as soon as it
    is lowered (XLA compiles without the GIL), so a compile overlaps the
    next trace."""
    def run(fn, args, options):
        return jax.tree_util.tree_map(np.array, fn.compile(compiler_options=options)(*args))

    with ThreadPoolExecutor(max_workers=4) as pool:
        pending = {k: (side, pool.submit(run, fn, args, options))
                   for k, (side, fn, args, options) in lowered}
        return {k: (side, fut.result()) for k, (side, fut) in pending.items()}


def check_net(side, out):
    """The port's net with JAX's weights carried through the bridge: its
    outputs within 1e-5 of JAX's, and its gradient of the cotangent in every
    weight within 1e-4 of the leaf's max |g| + 1e-5."""
    want, jgrads = out
    net = side.cls(20, side.dims)
    load_flax_params(net, side.params)
    got = net(torch.from_numpy(side.x))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_allclose(a.detach().numpy(), b, **NET_TOL)
    (got[0] * torch.from_numpy(side.cot)).sum().backward()
    want_net = side.cls(20, side.dims)
    load_flax_params(want_net, jgrads)
    grads_match(net, want_net, GRAD_REL, GRAD_ATOL)


def grads_match(model, want, rel, atol):
    for (name, p), g in zip(model.named_parameters(), want.parameters()):
        got = torch.zeros_like(p) if p.grad is None else p.grad
        err = (got - g).abs().max().item()
        limit = rel * g.abs().max().item() + atol
        assert err <= limit, f"{name}: max abs error {err:.3e} > {limit:.3e}"


def _config_params(path, data_dir, **over):
    with open(os.path.join(REPO, path)) as f:
        params = yaml.safe_load(f)
    for i, m in enumerate(("mnist", "svhn")):
        params[f"modality_{i + 1}"].update(
            path=os.path.join(data_dir, f"{m}_idx_train.npy"),
            test_datapath=os.path.join(data_dir, f"{m}_idx_test.npy"))
    params.update(over)
    return params


class _LaplaceRecorder:
    """Patch the JAX Laplace.rsample to keep each uniform draw."""

    def __init__(self, monkeypatch):
        self.draws = []

        def rsample(dist, key, sample_shape=()):
            shape = tuple(sample_shape) + jnp.shape(dist.loc)
            u = jax.random.uniform(key, shape, dtype=jnp.result_type(dist.loc),
                                   minval=-0.5 + 1e-7, maxval=0.5 - 1e-7)
            self.draws.append(u)
            return dist.loc - dist.scale * jnp.sign(u) * jnp.log1p(-2.0 * jnp.abs(u))

        monkeypatch.setattr(jdist.Laplace, "rsample", rsample)


def _lower_dreg(data_dir, tmp):
    """``config_mnistsvhn.yml`` (MOE, DReG, Laplace posteriors, lprob, llik
    auto) at K 2, bs 4, 8 latents on the surrogate's rows: the port's
    config, batch and drawn weights, and JAX's lowered loss, metrics,
    gradients and uniform draws."""
    params = _config_params(CONFIGS[0], data_dir, batch_size=4, K=2, n_latents=8)
    cfg, jcfg = Config(params, results_root=str(tmp / "port")), JConfig(
        params, results_root=str(tmp / "jax"))
    dm, jdm = DataModule(cfg), JDataModule(jcfg)
    dm.setup()
    jdm.setup()
    assert dm.feature_dims() == jdm.feature_dims()
    jmodel = jbuild_model(jcfg)
    jb = jax.tree_util.tree_map(jnp.asarray, next(jdm.batches("train")))
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)}, jb,
        method=_init_all))
    jparams = draw_params(shapes, 44)
    with pytest.MonkeyPatch.context() as mp:
        rec = _LaplaceRecorder(mp)

        def loss_fn(p):
            rec.draws.clear()
            loss, metrics = jmodel.apply(p, jb, rngs={"sample": jax.random.PRNGKey(8)},
                                         method=jmodel.objective)
            return loss, (metrics, list(rec.draws))

        lowered = jax.jit(jax.value_and_grad(loss_fn, has_aux=True)).lower(jparams)
    side = types.SimpleNamespace(cfg=cfg, batch=_torch_batch(next(dm.batches("train"))),
                                 params=jparams)
    return side, lowered, (jparams,)


@pytest.fixture(scope="module")
def jax_side(built, tmp_path_factory):
    """{key: (port-side inputs, JAX's outputs)} of every net and of the
    DReG objective (:func:`compile_all`)."""
    def lowered():
        yield "dreg", _lower_dreg(built[0], tmp_path_factory.mktemp("dreg")) + ({},)
        for i, (kind, name, dims) in enumerate(NETS):
            yield (kind, name), lower_net(kind, name, dims, 40 + 2 * i) + (FAST_COMPILE,)

    return compile_all(lowered())


@pytest.mark.parametrize("kind,name", [n[:2] for n in NETS],
                         ids=[f"{k}-{n}" for k, n, _ in NETS])
def test_digit_nets_match_jax_at_full_width(jax_side, kind, name):
    check_net(*jax_side[(kind, name)])


# -- the config's MOE DReG objective -------------------------------------------------------


@pytest.mark.parametrize("detach", ["family", "old_normal"])
def test_moe_dreg_laplace_objective_matches_jax(jax_side, monkeypatch, detach):
    """The port fed JAX's uniform draws: loss and metrics within LOSS_TOL
    and every gradient within 2e-3 of its leaf's max |g| + 1e-6; no kernel
    of any kind (DReG takes no KL, the posteriors are Laplace).  With the
    stop-gradient posterior made a Normal (``old_normal``), as the port
    once made it, lqz is taken under the wrong family and the loss misses
    JAX's."""
    r, ((jloss, (jmetrics, draws)), jgrads) = jax_side["dreg"]
    eps = {m.name: torch.from_numpy(d) for m, d in zip(r.cfg.mods, draws)}
    if detach == "old_normal":
        monkeypatch.setattr(mmvae, "stop_gradient",
                            lambda q: distributions.Normal(q.loc.detach(), q.scale.detach()))
    model = build_model_from_config(r.cfg, device="cpu")
    assert type(model).__name__ == "MOE" and model.obj == "dreg" and model.K == 2
    load_flax_params(model, r.params)
    telemetry.reset()
    loss, metrics = model.objective(r.batch, eps=eps)
    if detach == "old_normal":
        assert abs(loss.item() - jloss) > LOSS_TOL["rtol"] * abs(jloss) + LOSS_TOL["atol"]
        return
    loss.backward()
    assert telemetry.summary() == {}
    assert _chip_smoke().DIGITS_PER_OBJECTIVE["moe_dreg"] == {}
    np.testing.assert_allclose(loss.item(), jloss, **LOSS_TOL)
    assert sorted(metrics) == sorted(jmetrics)
    for k in metrics:
        np.testing.assert_allclose(metrics[k].item(), jmetrics[k], **LOSS_TOL)
    want = build_model_from_config(r.cfg, device="cpu")
    load_flax_params(want, jgrads)
    grads_match(model, want, DREG_GRAD_REL, DREG_GRAD_ATOL)


@pytest.mark.parametrize("path", CONFIGS)
def test_configs_build_with_the_jax_tree(path):
    """Each config builds with ``eval_only`` on MNIST-SVHN's feature dims:
    a MOE (DReG, K 30) of Enc/Dec_MNIST and Enc/Dec_SVHN with Laplace
    posteriors and lprob, whose parameters the JAX model fills leaf for
    leaf."""
    cfg, jcfg = (cls(os.path.join(REPO, path), eval_only=True) for cls in (Config, JConfig))
    for c in (cfg, jcfg):
        for m, dims in zip(c.mods, ([28, 28, 1], [32, 32, 3])):
            m.feature_dims = dims
    model = build_model_from_config(cfg, device="cpu")
    jmodel = jbuild_model(jcfg)
    assert type(model).__name__ == type(jmodel).__name__ == "MOE"
    assert (model.obj, model.K) == ("dreg", 30)
    assert [(s.encoder, s.decoder, s.recon_loss, s.prior) for s in model.specs] == [
        ("MNIST", "MNIST", "lprob", "laplace"), ("SVHN", "SVHN", "lprob", "laplace")]
    assert [s.llik_scaling for s in model.specs] == [s.llik_scaling for s in jmodel.specs]
    batch = {m.name: {"data": jax.ShapeDtypeStruct((2, *m.feature_dims), jnp.float32),
                      "masks": None} for m in jcfg.mods}
    shapes = jax.eval_shape(lambda b: jmodel.init(
        {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)}, b,
        method=_init_all), batch)
    load_flax_params(model, jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                                                   shapes))


# -- the benchmark ----------------------------------------------------------------------


def _digit_rows(d, n):
    """The first ``n`` rows of each modality of the port's surrogate, and
    their digits."""
    out = {}
    for m in ("mnist", "svhn"):
        ds = datasets.MNIST_SVHN(os.path.join(d, f"{m}_idx_train.npy"), None, m)
        out[m] = ds.get_data()[0][:n]
    return out, np.asarray(ds.labels()[:n])


def _with_labels(exps, labels):
    """The fakes' test samples with their digit labels."""
    for exp in exps:
        inner = exp.get_test_samples
        exp.get_test_samples = (lambda n, split="test", seed=0, inner=inner:
                                (inner(n, split, seed)[0], labels[:n]))
    return exps


def _generations(rows, n_test):
    """Fixed generations from the real rows: rolls, so that every stat
    lies strictly between 0 and 1."""
    mnist, svhn = rows["mnist"], rows["svhn"]
    test = {"mod_1": {"data": mnist[-n_test:], "masks": None},
            "mod_2": {"data": svhn[-n_test:], "masks": None}}
    cross = {"mod_1": {"mod_1": mnist[-n_test:], "mod_2": np.roll(svhn[-n_test:], 3, 0)},
             "mod_2": {"mod_1": np.concatenate([mnist[-n_test:][:10],
                                                np.roll(mnist[-n_test:][10:], 2, 0)]),
                       "mod_2": svhn[-n_test:]}}
    joint = {"mod_1": mnist[:12], "mod_2": np.roll(svhn[:12], 1, 0)}
    return test, cross, joint


def test_cross_and_joint_coherence_match_jax_on_bridged_judges(built, tmp_path):
    """cross_coherence and joint_coherence from the same generations, on
    judges of random weights (JAX's CNNClassifier, the port's through the
    bridge): the same shares and the same calls."""
    rows, labels = _digit_rows(built[0], 60)
    test, cross, joint = _generations(rows, 30)
    train = {"mod_1": (rows["mnist"], None), "mod_2": (rows["svhn"], None)}
    jexp, exp = _with_labels(_fake_exps(tmp_path, ("mnist", "svhn"), train, test, cross, joint),
                             labels[-30:])
    jjudges, judges = {}, {}
    for i, (name, dims) in enumerate((("mod_1", (28, 28, 1)), ("mod_2", (32, 32, 3)))):
        jnet = jclassifiers.CNNClassifier(num_classes=10)
        shapes = jax.eval_shape(lambda: jnet.init(jax.random.PRNGKey(0),
                                                  jnp.zeros((1,) + dims)))
        params = draw_params(shapes, 50 + i)
        # jitted: one compile a shape instead of one an op
        jjudges[name] = (types.SimpleNamespace(apply=jax.jit(jnet.apply)), params)
        judges[name] = classifiers.CNNClassifier(10, in_shape=dims)
        load_flax_params(judges[name], params)
    want = jmnistsvhn.cross_coherence(jexp, jjudges)
    got = eval_mnistsvhn.cross_coherence(exp, judges)
    assert list(got) == list(want) == ["mod_1_to_mod_2", "mod_2_to_mod_1"]
    for k in got:
        assert got[k] == want[k], k
    assert eval_mnistsvhn.joint_coherence(exp, judges, n=12) == \
        jmnistsvhn.joint_coherence(jexp, jjudges, n=12)
    assert exp.calls == jexp.calls


def test_mnistsvhn_eval_gives_jax_stats(built, tmp_path, monkeypatch):
    """mnistsvhn_eval's 6 stats, its judges' training data and its stats
    file against the JAX package's on fixed judges and generations, the
    latent probe fixed in both."""
    rows, labels = _digit_rows(built[0], 60)
    test, cross, joint = _generations(rows, 30)
    train = {"mod_1": (rows["mnist"][:30], None), "mod_2": (rows["svhn"][:30], None)}
    jexp, exp = _with_labels(_fake_exps(tmp_path, ("mnist", "svhn"), train, test, cross, joint),
                             labels[-30:])
    for e in (jexp, exp):
        e.datamod.labels_train = list(labels[:30])
        for m, dims in zip(e.config.mods, ([28, 28, 1], [32, 32, 3])):
            m.feature_dims = dims
    jtrained, trained = [], []
    _patch_judges(monkeypatch, jclassifiers, _JaxJudge, jtrained)
    _patch_judges(monkeypatch, classifiers, _PortJudge, trained)
    for module in (jmnistsvhn, eval_mnistsvhn):
        monkeypatch.setattr(module, "latent_digit_accuracy", lambda e: 0.375)
    jstats, stats = jmnistsvhn.mnistsvhn_eval(jexp), eval_mnistsvhn.mnistsvhn_eval(exp)
    assert list(stats) == ["latent_accuracy", "mod_1_judge_accuracy_real",
                           "mod_2_judge_accuracy_real", "mod_1_to_mod_2", "mod_2_to_mod_1",
                           "joint_coherence"]
    assert all(0 < stats[k] < 1 for k in stats)
    _assert_same_run(jexp, exp, jstats, stats, jtrained, trained, "mnist_svhn_stats.txt")


def _chip_smoke():
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    return chip_smoke
