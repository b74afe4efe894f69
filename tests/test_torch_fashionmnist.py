"""FashionMNIST in the port against the JAX package, on the CPU.

The port's copy of the surrogate builder writes JAX's arrays and notes
from the same seed; the ``FASHIONMNIST`` class gives JAX's arrays, labels,
feature dims and decoded outputs, read from a directory or a file;
``Enc_MNIST`` and ``Dec_MNIST`` at full width give JAX's outputs and
gradients from carried weights; both configs' POE objectives at bs 4, the
port fed JAX's draws, give JAX's loss, metrics and gradients;
``fashionmnist_eval`` computes JAX's stats and stats file from fixed judges
and generations; ``latent_digit_accuracy`` scores what the JAX package's
(sklearn's logistic regression) scores; the digit family and ``lprob``,
which this file once found refused, build; both configs build through
``build_model_from_config`` with the JAX tree; ``config_fashionmnist.yml``
trains and ends in its benchmark through ``Trainer`` with ``device="cpu"``,
launching the kernels' plain versions as chip_smoke.py counts them.

Tolerances: the builder's arrays exactly; the nets' outputs within 1e-5;
loss and metrics within rtol 1e-6 (+ atol 1e-3 for sums of ~1e4 in fp32);
every gradient within 1e-4 of its leaf's max |g| + 1e-5; the stats within
rtol 1e-12 and the probe's accuracy exactly.
"""
import os
import sys
import types
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from multimodal_vae_comparison_tpu.config import Config as JConfig
from multimodal_vae_comparison_tpu.data import datasets as jdatasets
from multimodal_vae_comparison_tpu.data.datamodule import DataModule as JDataModule
from multimodal_vae_comparison_tpu.data_proc import surrogates as jsurrogates
from multimodal_vae_comparison_tpu.eval import eval_fashionmnist as jfashion
from multimodal_vae_comparison_tpu.eval import eval_mnistsvhn as jmnistsvhn
from multimodal_vae_comparison_tpu.models import decoders as jdecoders
from multimodal_vae_comparison_tpu.models import encoders as jencoders
from multimodal_vae_comparison_tpu.training.trainer import build_model as jbuild_model
from multimodal_vae_comparison_tpu_torch.bridge import load_flax_params
from multimodal_vae_comparison_tpu_torch.config import Config
from multimodal_vae_comparison_tpu_torch.data import datasets
from multimodal_vae_comparison_tpu_torch.data.datamodule import DataModule
from multimodal_vae_comparison_tpu_torch.data_proc import surrogates
from multimodal_vae_comparison_tpu_torch.eval import eval_fashionmnist, eval_mnistsvhn
from multimodal_vae_comparison_tpu_torch.models import decoders, encoders, objectives
from multimodal_vae_comparison_tpu_torch.ops.kernels import telemetry
from multimodal_vae_comparison_tpu_torch.training.trainer import (
    Trainer, build_model_from_config)
from test_torch_families import _assert_same_run, _fake_exps, _JaxJudge, _patch_judges, _PortJudge
from test_torch_slice import one_torch_thread  # noqa: F401 (autouse)
from test_torch_vilanro import _jit, _Recorder, _torch_batch
from test_torch_zoo import draw_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = ("configs/config_fashionmnist.yml", "configs/round2/fashionmnist_r2.yml")
LOSS_TOL = dict(rtol=1e-6, atol=1e-3)
NET_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_REL, GRAD_ATOL = 1e-4, 1e-5
NPZ = ("fashionmnist.npz", "test/fashionmnist.npz")


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """The surrogate built by both packages' builders at 60 train and 24
    test rows, seed 3: (port's directory, JAX's directory)."""
    root = tmp_path_factory.mktemp("fashion")
    dirs = []
    for tag, module in (("port", surrogates), ("jax", jsurrogates)):
        d = str(root / tag)
        assert module.build_fashionmnist(d, n_train=60, n_test=24, seed=3) == d
        dirs.append(d)
    return tuple(dirs)


def test_surrogate_equals_jax_for_a_seed(built):
    """The same files; SURROGATE.txt byte for byte; each archive's members
    (``data.npy`` (N, 28, 28) uint8, ``labels.npy`` int64) byte for byte
    (the archives themselves differ only in their members' zip timestamps,
    which ``np.savez`` takes from the clock)."""
    port_dir, jax_dir = built
    files = lambda d: sorted(os.path.relpath(os.path.join(r, f), d)
                             for r, _, fs in os.walk(d) for f in fs)
    assert files(port_dir) == files(jax_dir) == sorted(NPZ + ("SURROGATE.txt",))
    with open(os.path.join(port_dir, "SURROGATE.txt"), "rb") as a, \
            open(os.path.join(jax_dir, "SURROGATE.txt"), "rb") as b:
        assert a.read() == b.read()
    for name in NPZ:
        with zipfile.ZipFile(os.path.join(port_dir, name)) as a, \
                zipfile.ZipFile(os.path.join(jax_dir, name)) as b:
            assert a.namelist() == b.namelist() == ["data.npy", "labels.npy"]
            for member in a.namelist():
                assert a.read(member) == b.read(member), (name, member)
    data = np.load(os.path.join(port_dir, NPZ[0]))
    assert data["data"].shape == (60, 28, 28) and data["data"].dtype == np.uint8
    assert set(np.unique(data["labels"])) <= set(range(10))


def test_surrogate_cli_writes_the_builder_files(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["surrogates", "fashionmnist", "--out", str(tmp_path),
                                      "--train", "12", "--test", "5"])
    surrogates.main()
    assert "fashionmnist ->" in capsys.readouterr().out
    assert len(np.load(tmp_path / NPZ[1])["labels"]) == 5


@pytest.mark.parametrize("mod_type", ["image", "label"])
@pytest.mark.parametrize("as_file", [False, True], ids=["directory", "file"])
def test_dataset_gives_jax_arrays_labels_and_decodes(built, mod_type, as_file):
    """Train and test arrays (images in [0, 1] NHWC, labels as one-hots),
    the integer labels, the feature dims and the decoded output equal the
    JAX class's, from the directory or the file itself."""
    d = built[0]
    path, test = ((os.path.join(d, NPZ[0]), os.path.join(d, NPZ[1])) if as_file
                  else (d, os.path.join(d, "test")))
    got = datasets.get_dataset_class("FashionMNIST")(path, test, mod_type)
    want = jdatasets.get_dataset_class("fashionmnist")(path, test, mod_type)
    for split in ("train", "test"):
        (gd, gm), (wd, wm) = got.get_data(split), want.get_data(split)
        assert gd.dtype == wd.dtype == np.float32 and gm is wm is None
        np.testing.assert_array_equal(gd, wd)
        assert got.labels() == want.labels()
        assert got.feature_dims == want.feature_dims and got.categorical == want.categorical
        out, ref = got.decode_output(gd[:5]), want.decode_output(wd[:5])
        assert np.array_equal(out, ref) if mod_type == "image" else out == ref
    assert gd.shape[1:] == ((28, 28, 1) if mod_type == "image" else (10,))
    assert got.text2img_size == want.text2img_size
    assert got.eval_statistics_fn() is eval_fashionmnist.fashionmnist_eval


def test_the_digit_family_and_lprob_still_raise_naming_item_7d():
    """Item 7d is done: the digit family's datasets and ``lprob`` build
    (test_torch_mnistsvhn.py and test_torch_polymnist.py hold them against
    the JAX package)."""
    assert datasets.get_dataset_class("mnist_svhn") is datasets.MNIST_SVHN
    assert datasets.get_dataset_class("polymnist") is datasets.POLYMNIST
    objectives.check_ported("lprob")
    assert objectives.RECON_LOSSES["lprob"] is objectives.lprob


@pytest.mark.parametrize("kind", ["enc", "dec"])
def test_mnist_nets_match_jax_at_full_width(kind):
    """Enc_MNIST and Dec_MNIST (width 400) at 32 latents, bs 4, on numpy
    inputs, JAX's weights carried through the bridge: outputs (the
    decoder's squashed mean, scale and clipped logits) within 1e-5, and the
    gradient of a random cotangent of the first output in every weight
    within 1e-4 of its leaf's max |g| + 1e-5."""
    rng = np.random.default_rng(30)
    dims = (28, 28, 1)
    if kind == "enc":
        x = rng.uniform(size=(4,) + dims).astype(np.float32)
        jnet, net_cls = jencoders.Enc_MNIST(latent_dim=32, data_dim=dims), encoders.Enc_MNIST
    else:
        x = rng.normal(size=(4, 32)).astype(np.float32)
        jnet, net_cls = jdecoders.Dec_MNIST(latent_dim=32, data_dim=dims), decoders.Dec_MNIST
    shapes = jax.eval_shape(lambda: jnet.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    params = draw_params(shapes, 31)
    want, vjp = jax.vjp(lambda p: jnet.apply(p, jnp.asarray(x)), params)
    cot = rng.normal(size=want[0].shape).astype(np.float32)
    (jgrads,) = vjp((jnp.asarray(cot),) + tuple(jnp.zeros_like(w) for w in want[1:]))
    net = net_cls(32, dims)
    load_flax_params(net, params)
    got = net(torch.from_numpy(x))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), **NET_TOL)
    (got[0] * torch.from_numpy(cot)).sum().backward()
    want_net = net_cls(32, dims)
    load_flax_params(want_net, jax.tree_util.tree_map(np.asarray, jgrads))
    _grads_match(net, want_net)


def _grads_match(model, want):
    for (name, p), g in zip(model.named_parameters(), want.parameters()):
        got = torch.zeros_like(p) if p.grad is None else p.grad
        err = (got - g).abs().max().item()
        limit = GRAD_REL * g.abs().max().item() + GRAD_ATOL
        assert err <= limit, f"{name}: max abs error {err:.3e} > {limit:.3e}"


def _params(path, data_dir, **over):
    with open(os.path.join(REPO, path)) as f:
        params = yaml.safe_load(f)
    for key in ("modality_1", "modality_2"):
        params[key].update(path=data_dir, test_datapath=os.path.join(data_dir, "test"))
    params.update(over)
    return params


@pytest.mark.parametrize("path", CONFIGS)
def test_config_objective_loss_metrics_and_grads_match_jax(built, tmp_path, monkeypatch,
                                                           path):
    """The config's POE objective (3 subsets; bce on the image, category_ce
    on the label, 32 or 16 latents) at bs 4 on the surrogate's rows, the
    port fed JAX's draws: loss and metrics within LOSS_TOL, every gradient
    within 1e-4 of its leaf's max |g| + 1e-5; the PoE kernel's plain
    version runs once and its backward once, as chip_smoke.py counts."""
    params = _params(path, built[0], batch_size=4)
    cfg, jcfg = Config(params, results_root=str(tmp_path / "port")), JConfig(
        params, results_root=str(tmp_path / "jax"))
    dm, jdm = DataModule(cfg), JDataModule(jcfg)
    dm.setup()
    jdm.setup()
    assert dm.feature_dims() == jdm.feature_dims()
    jmodel = jbuild_model(jcfg)
    jb = jax.tree_util.tree_map(jnp.asarray, next(jdm.batches("train")))
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)}, jb,
        method=jmodel.objective))
    jparams = draw_params(shapes, 32)
    rec = _Recorder(monkeypatch)

    def loss_fn(p):
        rec.draws.clear()
        loss, metrics = jmodel.apply(p, jb, rngs={"sample": jax.random.PRNGKey(6)},
                                     method=jmodel.objective)
        return loss, (metrics, list(rec.draws))

    (jloss, (jmetrics, draws)), jgrads = _jit(jax.value_and_grad(loss_fn, has_aux=True))(jparams)
    assert len(draws) == 3
    model = build_model_from_config(cfg, device="cpu")
    load_flax_params(model, jparams)
    telemetry.reset()
    loss, metrics = model.objective(_torch_batch(next(dm.batches("train"))),
                                    eps=[torch.from_numpy(np.array(d)) for d in draws])
    loss.backward()
    cs = _chip_smoke()
    assert {k.split(":")[0]: n for k, n in telemetry.summary().items()} == {
        **cs.FASHION_PER_OBJECTIVE["poe"], **cs.FASHION_PER_BACKWARD["poe"]}
    np.testing.assert_allclose(loss.item(), float(jloss), **LOSS_TOL)
    assert sorted(metrics) == sorted(jmetrics)
    for k in metrics:
        np.testing.assert_allclose(metrics[k].item(), float(jmetrics[k]), **LOSS_TOL)
    want = build_model_from_config(cfg, device="cpu")
    load_flax_params(want, jax.tree_util.tree_map(np.asarray, jgrads))
    _grads_match(model, want)


@pytest.mark.parametrize("path", CONFIGS)
def test_configs_build_with_the_jax_tree(path):
    """Each config builds with ``eval_only`` on FashionMNIST's feature dims:
    a POE of Enc_MNIST/Dec_MNIST and FNN over the label, whose parameters
    the JAX package's model fills leaf for leaf."""
    cfg, jcfg = (cls(os.path.join(REPO, path), eval_only=True) for cls in (Config, JConfig))
    for c in (cfg, jcfg):
        for m, dims in zip(c.mods, ([28, 28, 1], [10])):
            m.feature_dims = dims
    model = build_model_from_config(cfg, device="cpu")
    jmodel = jbuild_model(jcfg)
    assert type(model).__name__ == type(jmodel).__name__ == "POE"
    assert [(s.encoder, s.decoder, s.recon_loss) for s in model.specs] == [
        ("MNIST", "MNIST", "bce"), ("FNN", "FNN", "category_ce")]
    assert [s.llik_scaling for s in model.specs] == [s.llik_scaling for s in jmodel.specs]
    batch = {m.name: {"data": jax.ShapeDtypeStruct((2, *m.feature_dims), jnp.float32),
                      "masks": None} for m in jcfg.mods}
    shapes = jax.eval_shape(lambda b: jmodel.init(
        {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)}, b,
        method=jmodel.objective), batch)
    load_flax_params(model, jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                                                   shapes))


def _probe_exps(z, labels):
    """A JAX and a port stand-in of a run for the probe: its test rows'
    labels, and a forward whose joint posterior means are ``z``."""
    exps = []
    for tensor in (False, True):
        loc = torch.from_numpy(z) if tensor else jnp.asarray(z)
        mods = {"mod_1": types.SimpleNamespace(joint_dist=types.SimpleNamespace(loc=loc),
                                               encoder_dist=None)}
        exps.append(types.SimpleNamespace(
            mod_names=("mod_1", "mod_2"), datamod=types.SimpleNamespace(n_val=len(z)),
            get_test_samples=lambda n, split="test", seed=0: ({"mod_1": None, "mod_2": None},
                                                             labels[:n]),
            forward=lambda inputs, present: types.SimpleNamespace(mods=mods)))
    return exps


@pytest.mark.parametrize("n,classes", [(300, 10), (500, 4), (120, 10)])
def test_latent_digit_accuracy_matches_jax(n, classes):
    """The probe's held-out accuracy on posterior means of 32 latents whose
    classes overlap: the port's sklearn-free fit (C 1, max_iter 500) scores
    exactly what the JAX package's sklearn LogisticRegression scores, on
    the same shuffled 80/20 split."""
    pytest.importorskip("sklearn")
    rng = np.random.default_rng(33 + n)
    labels = rng.integers(0, classes, n)
    centers = rng.normal(size=(classes, 32))
    z = (centers[labels] + 1.5 * rng.normal(size=(n, 32))).astype(np.float32)
    jexp, exp = _probe_exps(z, labels)
    want = jmnistsvhn.latent_digit_accuracy(jexp)
    got = eval_mnistsvhn.latent_digit_accuracy(exp)
    assert got == want
    assert 1.0 / classes < got < 1.0


def test_fashionmnist_eval_gives_jax_stats(built, tmp_path, monkeypatch):
    """fashionmnist_eval's 5 stats, its judge's training data and its stats
    file against the JAX package's on one fixed judge and fixed generations
    (rolls of the real rows, so the stats are not 0 or 1), the latent probe
    fixed in both."""
    d = built[0]
    imgs, _ = datasets.FASHIONMNIST(d, None, "image").get_data()
    ds = datasets.FASHIONMNIST(d, None, "label")
    onehot, _ = ds.get_data()
    train = {"mod_1": (imgs[:40], None), "mod_2": (onehot[:40], None)}
    test = {"mod_1": {"data": imgs[40:], "masks": None},
            "mod_2": {"data": onehot[40:], "masks": None}}
    cross = {"mod_2": {"mod_1": np.roll(imgs[40:], 1, 0), "mod_2": onehot[40:]},
             "mod_1": {"mod_1": imgs[40:], "mod_2": np.concatenate(
                 [onehot[40:50], np.roll(onehot[50:], 2, 0)])}}
    joint = {"mod_1": imgs[:8], "mod_2": np.roll(onehot[:8], 3, 0)}
    jexp, exp = _fake_exps(tmp_path, ("image", "label"), train, test, cross, joint)
    exp.datamod.labels_train = ds.labels()[:40]
    for m, dims in zip(exp.config.mods, ([28, 28, 1], [10])):
        m.feature_dims = dims
    jtrained, trained = [], []
    _patch_judges(monkeypatch, jfashion, _JaxJudge, jtrained)
    _patch_judges(monkeypatch, eval_fashionmnist, _PortJudge, trained)
    for module in (jfashion, eval_fashionmnist):
        monkeypatch.setattr(module, "latent_digit_accuracy", lambda e: 0.375)
    jstats, stats = jfashion.fashionmnist_eval(jexp), eval_fashionmnist.fashionmnist_eval(exp)
    assert tuple(stats) == eval_fashionmnist.STATS_KEYS
    assert 0 < stats["label_to_image"] < 1 and 0 < stats["image_to_label"] < 1
    _assert_same_run(jexp, exp, jstats, stats, jtrained, trained, "fashionmnist_stats.txt")


def _chip_smoke():
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    return chip_smoke


def test_config_trains_and_scores_through_the_trainer_on_the_cpu(tmp_path, monkeypatch):
    """``config_fashionmnist.yml`` on a surrogate of 300 rows (270 train /
    30 val, bs 8) trained for 1 epoch through ``Trainer.fit`` with ``device="cpu"``,
    then ``test()``: the judge trained on the train split, the 5 stats in
    [0, 1] and the stats file written; the benchmark's forwards launch the
    PoE kernel's plain version as chip_smoke.FASHION_EVAL_LAUNCHES counts."""
    monkeypatch.setenv("FASHIONMNIST_CLASSIFIER_DIR", str(tmp_path / "judges"))
    data_dir = surrogates.build_fashionmnist(str(tmp_path / "data"), n_train=300, n_test=60,
                                             seed=4)
    params = _params(CONFIGS[0], data_dir, batch_size=8, epochs=1)
    trainer = Trainer(Config(params, results_root=str(tmp_path)), device="cpu",
                      enable_viz=False)
    trainer.init_state()
    metrics = trainer.fit(epochs=1, log_fn=None)
    assert np.isfinite(metrics["train_loss"]) and np.isfinite(metrics["val_loss"])
    tested = trainer.test()
    assert set(eval_fashionmnist.STATS_KEYS) <= set(tested)
    telemetry.reset()                  # the benchmark again, on the cached judge
    stats = eval_fashionmnist.fashionmnist_eval(trainer)
    assert {k.split(":")[0]: n for k, n in telemetry.summary().items()} == \
        _chip_smoke().FASHION_EVAL_LAUNCHES
    assert stats == {k: tested[k] for k in stats}
    assert tuple(stats) == eval_fashionmnist.STATS_KEYS
    assert all(0.0 <= v <= 1.0 for v in stats.values())
    assert os.path.isfile(tmp_path / "judges" / "fashionmnist_clf_v2.pt")
    with open(os.path.join(trainer.cfg.mPath, "fashionmnist_stats.txt")) as f:
        assert f.read().count("\n") >= 5
