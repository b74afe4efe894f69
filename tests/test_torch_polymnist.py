"""PolyMNIST in the port against the JAX package, on the CPU.

The port's copy of the PolyMNIST builder writes the JAX builder's files
from the same seed; ``POLYMNIST`` gives JAX's arrays and digit labels from
``.npy`` and ``.pt`` arrays; ``Enc_PolyMNIST`` and ``Dec_PolyMNIST`` (flax's
``SAME`` transposed convs and the centre crop) give JAX's outputs and
gradients from carried weights; the POE objective of
``config_polymnist.yml`` (31 subsets, bce) and the MoPoE objective of
``round2/polymnist_r2_mopoe.yml`` (lprob, beta 2.5) at bs 4, the port fed
JAX's draws, give JAX's loss, metrics and gradients and launch the PoE
lattice's plain version as chip_smoke.py counts it; both configs build with
the JAX tree; ``polymnist_eval`` gives JAX's 24 stats and stats file on
fixed judges; the benchmarks' forwards launch what chip_smoke.py counts.

Tolerances: the builder's files and the dataset's arrays exactly; the nets'
outputs within 1e-5 and gradients within 1e-4 of each leaf's max |g| +
1e-5; loss and metrics within rtol 1e-5 (+ atol 1e-3: fp32 sums of ~1e4
per-pixel terms, which XLA and PyTorch add in other orders; seen 1.9e-6),
every gradient within 1e-4 of its leaf's max |g| + 1e-5; the stats within
rtol 1e-12.
"""
import filecmp
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from multimodal_vae_comparison_tpu.config import Config as JConfig
from multimodal_vae_comparison_tpu.data import datasets as jdatasets
from multimodal_vae_comparison_tpu.data.datamodule import DataModule as JDataModule
from multimodal_vae_comparison_tpu.data_proc import polymnist as jbuilder
from multimodal_vae_comparison_tpu.eval import classifiers as jclassifiers
from multimodal_vae_comparison_tpu.eval import eval_mnistsvhn as jmnistsvhn
from multimodal_vae_comparison_tpu.eval import eval_polymnist as jpolymnist
from multimodal_vae_comparison_tpu.training.trainer import build_model as jbuild_model
from multimodal_vae_comparison_tpu_torch.bridge import load_flax_params
from multimodal_vae_comparison_tpu_torch.config import Config
from multimodal_vae_comparison_tpu_torch.data import datasets
from multimodal_vae_comparison_tpu_torch.data.datamodule import DataModule
from multimodal_vae_comparison_tpu_torch.data_proc import polymnist as builder
from multimodal_vae_comparison_tpu_torch.eval import (
    classifiers, eval_mnistsvhn, eval_polymnist)
from multimodal_vae_comparison_tpu_torch.eval.infer import MultimodalVAEInfer
from multimodal_vae_comparison_tpu_torch.ops.kernels import telemetry
from multimodal_vae_comparison_tpu_torch.training.trainer import build_model_from_config
from test_torch_families import _assert_same_run, _fake_exps, _JaxJudge, _patch_judges, _PortJudge
from test_torch_mnistsvhn import (
    FAST_COMPILE, _chip_smoke, _with_labels, check_net, compile_all, grads_match, lower_net)
from test_torch_slice import one_torch_thread  # noqa: F401 (autouse)
from test_torch_vilanro import _Recorder, _torch_batch
from test_torch_vilanro_cond import _init_all
from test_torch_zoo import draw_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = ("configs/config_polymnist.yml", "configs/round2/polymnist_r2_mopoe.yml")
LOSS_TOL = dict(rtol=1e-5, atol=1e-3)
GRAD_REL, GRAD_ATOL = 1e-4, 1e-5
MODS = tuple(f"m{i}" for i in range(5))


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """PolyMNIST built by both packages' builders at 200 train and 50 test
    rows, seed 3: (port's directory, JAX's directory)."""
    pytest.importorskip("cv2")
    pytest.importorskip("sklearn")
    root = tmp_path_factory.mktemp("polymnist")
    dirs = []
    for tag, module in (("port", builder), ("jax", jbuilder)):
        d = str(root / tag)
        assert module.build_surrogate(d, samples_train=200, samples_test=50, seed=3) == d
        dirs.append(d)
    return tuple(dirs)


def test_builder_writes_the_jax_files_for_a_seed(built):
    """The same 13 files, byte for byte: five modalities and the labels of
    each split, and SURROGATE.txt."""
    port_dir, jax_dir = built
    names = sorted(os.listdir(port_dir))
    assert names == sorted(os.listdir(jax_dir)) == sorted(
        [f"{t}{m}.npy" for t in ("", "test_") for m in MODS + ("labels",)] + ["SURROGATE.txt"])
    for name in names:
        assert filecmp.cmp(os.path.join(port_dir, name), os.path.join(jax_dir, name),
                           shallow=False), name
    m0 = np.load(os.path.join(port_dir, "m0.npy"))
    assert m0.shape == (200, 28, 28, 3) and m0.dtype == np.uint8
    assert np.load(os.path.join(port_dir, "test_labels.npy")).shape == (50,)


def test_builder_cli_writes_the_builder_files(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["polymnist", "--out", str(tmp_path), "--train", "12",
                                      "--test", "5", "--seed", "1"])
    builder.main()
    assert "PolyMNIST ->" in capsys.readouterr().out
    assert np.load(tmp_path / "test_m4.npy").shape == (5, 28, 28, 3)


@pytest.mark.parametrize("as_pt", [False, True], ids=["npy", "pt"])
@pytest.mark.parametrize("mod_type", ["m0", "m4"])
def test_dataset_gives_jax_arrays_labels_and_decodes(built, tmp_path, mod_type, as_pt):
    """Train and test arrays (NHWC in [0, 1]), the digit labels of each
    split, the feature dims and the decoded output equal the JAX class's,
    from the builder's ``.npy`` files or the same arrays saved as ``.pt``."""
    d = built[0]
    paths = [os.path.join(d, f"{t}{mod_type}.npy") for t in ("", "test_")]
    if as_pt:
        for i, p in enumerate(paths):
            paths[i] = os.path.join(tmp_path, os.path.basename(p)[:-4] + ".pt")
            torch.save(torch.from_numpy(np.load(p)), paths[i])
            name = ("test_" if i else "") + "labels.npy"
            os.link(os.path.join(d, name), os.path.join(tmp_path, name))
    got = datasets.get_dataset_class("polymnist")(*paths, mod_type)
    want = jdatasets.get_dataset_class("polymnist")(*paths, mod_type)
    for split, n in (("train", 200), ("test", 50)):
        (gd, gm), (wd, wm) = got.get_data(split), want.get_data(split)
        assert gd.dtype == wd.dtype == np.float32 and gm is wm is None
        assert gd.shape == (n, 28, 28, 3)
        np.testing.assert_array_equal(gd, wd)
        np.testing.assert_array_equal(got.labels(), want.labels())
        assert len(got.labels()) == n
        np.testing.assert_array_equal(got.decode_output(gd[:5]), want.decode_output(wd[:5]))
    assert got.feature_dims == want.feature_dims and got.text2img_size == want.text2img_size
    assert got.eval_statistics_fn() is eval_polymnist.polymnist_eval


# -- the nets and the configs' objectives --------------------------------------------------


def _config_params(path, data_dir, **over):
    with open(os.path.join(REPO, path)) as f:
        params = yaml.safe_load(f)
    for i, m in enumerate(MODS):
        params[f"modality_{i + 1}"].update(path=os.path.join(data_dir, f"{m}.npy"),
                                           test_datapath=os.path.join(data_dir, f"test_{m}.npy"))
    params.update(over)
    return params


def _lower_objective(path, data_dir, tmp):
    """The config's objective at bs 4 on the built rows: the port's config,
    batch and drawn weights, and JAX's lowered loss, metrics, gradients
    and standard-normal draws."""
    params = _config_params(path, data_dir, batch_size=4)
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
    jparams = draw_params(shapes, 62)
    with pytest.MonkeyPatch.context() as mp:
        rec = _Recorder(mp)

        def loss_fn(p):
            rec.draws.clear()
            loss, metrics = jmodel.apply(p, jb, rngs={"sample": jax.random.PRNGKey(9)},
                                         method=jmodel.objective)
            return loss, (metrics, list(rec.draws))

        lowered = jax.jit(jax.value_and_grad(loss_fn, has_aux=True)).lower(jparams)
    side = types.SimpleNamespace(cfg=cfg, batch=_torch_batch(next(dm.batches("train"))),
                                 params=jparams)
    return side, lowered, (jparams,)


@pytest.fixture(scope="module")
def jax_side(built, tmp_path_factory):
    """{key: (port-side inputs, JAX's outputs)} of both nets and both
    configs' objectives, compiled in a pool of threads (test_torch_mnistsvhn's
    :func:`compile_all`)."""
    def lowered():
        for path in CONFIGS:
            yield path, _lower_objective(path, built[0], tmp_path_factory.mktemp("obj")) \
                + (FAST_COMPILE,)
        for i, kind in enumerate(("enc", "dec")):
            yield kind, lower_net(kind, "PolyMNIST", (28, 28, 3), 60 + 2 * i) + (FAST_COMPILE,)

    return compile_all(lowered())


@pytest.mark.parametrize("kind", ["enc", "dec"])
def test_polymnist_nets_match_jax_at_full_width(jax_side, kind):
    """Enc_PolyMNIST and Dec_PolyMNIST at 20 latents, bs 4 (the checks of
    test_torch_mnistsvhn's nets)."""
    check_net(*jax_side[kind])


@pytest.mark.parametrize("path,mixing,draws", [(CONFIGS[0], "poe", 31), (CONFIGS[1], "mopoe", 1)],
                         ids=["poe", "mopoe"])
def test_config_objective_loss_metrics_and_grads_match_jax(jax_side, path, mixing, draws):
    """The config's objective at bs 4 over the 5 modalities, the port fed
    JAX's draws (POE: one per subset of the 31; MoPoE: the joint's): loss
    and metrics within LOSS_TOL, every gradient within 1e-4 of its leaf's
    max |g| + 1e-5; the PoE lattice's plain version runs once and its
    backward once, as chip_smoke.py's DIGITS tables count."""
    r, ((jloss, (jmetrics, jdraws)), jgrads) = jax_side[path]
    assert len(jdraws) == draws
    model = build_model_from_config(r.cfg, device="cpu")
    assert type(model).__name__ == {"poe": "POE", "mopoe": "MoPOE"}[mixing]
    load_flax_params(model, r.params)
    eps = [torch.from_numpy(d) for d in jdraws]
    telemetry.reset()
    loss, metrics = model.objective(r.batch, eps=eps if mixing == "poe" else eps[0])
    loss.backward()
    cs = _chip_smoke()
    assert {k.split(":")[0]: n for k, n in telemetry.summary().items()} == {
        **cs.DIGITS_PER_OBJECTIVE[mixing], **cs.DIGITS_PER_BACKWARD[mixing]}
    np.testing.assert_allclose(loss.item(), jloss, **LOSS_TOL)
    assert sorted(metrics) == sorted(jmetrics)
    for k in metrics:
        np.testing.assert_allclose(metrics[k].item(), jmetrics[k], **LOSS_TOL)
    want = build_model_from_config(r.cfg, device="cpu")
    load_flax_params(want, jgrads)
    grads_match(model, want, GRAD_REL, GRAD_ATOL)


@pytest.mark.parametrize("path", CONFIGS)
def test_configs_build_with_the_jax_tree(path):
    """Each config builds with ``eval_only`` on PolyMNIST's feature dims:
    POE (bce, 32 latents) or MoPoE (lprob, 24 latents, beta 2.5) over five
    Enc/Dec_PolyMNIST pairs, whose parameters the JAX model fills leaf for
    leaf."""
    cfg, jcfg = (cls(os.path.join(REPO, path), eval_only=True) for cls in (Config, JConfig))
    for c in (cfg, jcfg):
        for m in c.mods:
            m.feature_dims = [28, 28, 3]
    model = build_model_from_config(cfg, device="cpu")
    jmodel = jbuild_model(jcfg)
    assert type(model).__name__ == type(jmodel).__name__
    loss = "bce" if path == CONFIGS[0] else "lprob"
    assert [(s.encoder, s.decoder, s.recon_loss) for s in model.specs] == [
        ("PolyMNIST", "PolyMNIST", loss)] * 5
    batch = {m.name: {"data": jax.ShapeDtypeStruct((2, 28, 28, 3), jnp.float32),
                      "masks": None} for m in jcfg.mods}
    shapes = jax.eval_shape(lambda b: jmodel.init(
        {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)}, b,
        method=_init_all), batch)
    load_flax_params(model, jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                                                   shapes))


# -- the benchmark ----------------------------------------------------------------------


def test_polymnist_eval_gives_jax_stats(built, tmp_path, monkeypatch):
    """polymnist_eval's 24 stats, its judges' training data and its stats
    file against the JAX package's on fixed judges and generations (each
    modality's generation a roll of its real rows by its own shift), the
    latent probe fixed in both."""
    d = built[0]
    rows = [datasets.POLYMNIST(os.path.join(d, f"{m}.npy"), None, m).get_data()[0][:60]
            for m in MODS]
    labels = np.load(os.path.join(d, "labels.npy"))[:60]
    names = [f"mod_{i + 1}" for i in range(5)]
    train = {n: (r[:30], None) for n, r in zip(names, rows)}
    test = {n: {"data": r[30:], "masks": None} for n, r in zip(names, rows)}
    cross = {src: {n: np.roll(r[30:], (i + j) % 3, 0) for j, (n, r) in enumerate(zip(names, rows))}
             for i, src in enumerate(names)}
    joint = {n: np.roll(r[:12], i % 2, 0) for i, (n, r) in enumerate(zip(names, rows))}
    jexp, exp = _with_labels(_fake_exps(tmp_path, MODS, train, test, cross, joint), labels[30:])
    for e in (jexp, exp):
        e.datamod.labels_train = list(labels[:30])
        for m in e.config.mods:
            m.feature_dims = [28, 28, 3]
    jtrained, trained = [], []
    _patch_judges(monkeypatch, jclassifiers, _JaxJudge, jtrained)
    _patch_judges(monkeypatch, classifiers, _PortJudge, trained)
    for module in (jmnistsvhn, jpolymnist, eval_mnistsvhn, eval_polymnist):
        monkeypatch.setattr(module, "latent_digit_accuracy", lambda e: 0.375)
    jstats, stats = jpolymnist.polymnist_eval(jexp), eval_polymnist.polymnist_eval(exp)
    assert len(stats) == 24 and list(stats)[:3] == [
        "latent_accuracy", "judge_accuracy_real_mean", "cross_coherence_mean"]
    assert 0 < stats["cross_coherence_mean"] < 1
    _assert_same_run(jexp, exp, jstats, stats, jtrained, trained, "polymnist_stats.txt")


@pytest.mark.parametrize("path,key,dims", [
    ("configs/config_mnistsvhn.yml", "moe_dreg", ([28, 28, 1], [32, 32, 3])),
    (CONFIGS[0], "poe", ([28, 28, 3],) * 5),
    (CONFIGS[1], "mopoe", ([28, 28, 3],) * 5)], ids=["mnistsvhn", "poe", "mopoe"])
def test_chip_smoke_eval_launches_hold_on_the_cpu(tmp_path, monkeypatch, path, key, dims):
    """chip_smoke.py's DIGITS_EVAL_LAUNCHES: the benchmark over a config's
    model at K 1 (fixed judges, 6 random rows) launches exactly those
    kernels' plain versions: the probe's forward, a cross-generation per
    modality, and its prior joint, which decodes only."""
    eval_module = eval_mnistsvhn if key == "moe_dreg" else eval_polymnist
    _patch_judges(monkeypatch, classifiers, _PortJudge, [])
    cfg = Config(os.path.join(REPO, path), eval_only=True)
    for m, d in zip(cfg.mods, dims):
        m.feature_dims = d
    model = build_model_from_config(cfg, device="cpu")
    model.K = 1
    model.eval()
    rng = np.random.default_rng(63)
    rows = {m.name: {"data": rng.random((6, *m.feature_dims), dtype=np.float32), "masks": None}
            for m in cfg.mods}
    exp = MultimodalVAEInfer.__new__(MultimodalVAEInfer)
    exp.model, exp.device, exp.config, exp.run_dir = model, torch.device("cpu"), cfg, str(tmp_path)
    exp.datamod = types.SimpleNamespace(
        n_val=6, labels_train=list(range(6)),
        split_arrays=lambda i, split="train": (rows[f"mod_{i + 1}"]["data"], None))
    exp.get_test_samples = lambda n, split="test", seed=0: (rows, np.arange(6) % 3)
    # the joint generation decodes only: 8 samples launch what 500 do
    exp.joint_generate = lambda num, **kw: MultimodalVAEInfer.joint_generate(exp, min(num, 8),
                                                                             **kw)
    telemetry.reset()
    stats = getattr(eval_module, "mnistsvhn_stats" if key == "moe_dreg" else "polymnist_stats")(exp)
    assert {k.split(":")[0]: n for k, n in telemetry.summary().items()} == \
        _chip_smoke().DIGITS_EVAL_LAUNCHES[key]
    assert len(stats) == (6 if key == "moe_dreg" else 24)
    assert all(0.0 <= v <= 1.0 for v in stats.values())
