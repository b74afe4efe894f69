"""The port's SPRITES slice against the JAX package, on the CPU.

The generator's shards byte for byte; the dataset and its DataModule split;
the three video judges on bridged weights and one Adam epoch of a four-head
judge against optax; the MOE/DReG model built from a copy of
``configs/round4/sprites_r4_dreg_up.yml`` for loss, metrics and every
gradient on JAX's draws and importance weights; the whole benchmark
(``sprites_eval``) from one port-trained run carried to the JAX package,
the same JAX-trained judges and the same draws; the CLIs; the GIF writer.

The model and eval tests run on clips of ``CLIP`` = (4, 16, 16, 3): the
generator's clips with every other frame and 4x4 pixels averaged, so that
XLA's 3-D convolutions compile in seconds; the nets keep the config's
widths (64 channels, 4 residual blocks, 32 latents).
"""
import os
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from multimodal_vae_comparison_tpu import visualization as jviz
from multimodal_vae_comparison_tpu.config import Config as JConfig
from multimodal_vae_comparison_tpu.data import datasets as jdatasets
from multimodal_vae_comparison_tpu.data.datamodule import DataModule as JDataModule
from multimodal_vae_comparison_tpu.data_proc import sprites_gen as jsprites_gen
from multimodal_vae_comparison_tpu.eval import classifiers as jclassifiers
from multimodal_vae_comparison_tpu.eval import eval_sprites as jes
from multimodal_vae_comparison_tpu.models import distributions as jdist
from multimodal_vae_comparison_tpu.training.trainer import build_model as jbuild_model
from multimodal_vae_comparison_tpu_torch import bridge
from multimodal_vae_comparison_tpu_torch import main as port_main
from multimodal_vae_comparison_tpu_torch import visualization as viz
from multimodal_vae_comparison_tpu_torch.config import Config
from multimodal_vae_comparison_tpu_torch.data import datasets
from multimodal_vae_comparison_tpu_torch.data.datamodule import DataModule
from multimodal_vae_comparison_tpu_torch.data_proc import sprites_gen
from multimodal_vae_comparison_tpu_torch.eval import classifiers
from multimodal_vae_comparison_tpu_torch.eval import eval_sprites as es
from multimodal_vae_comparison_tpu_torch.eval import infer
from multimodal_vae_comparison_tpu_torch.eval import train_classifiers
from multimodal_vae_comparison_tpu_torch.models import distributions as tdist
from multimodal_vae_comparison_tpu_torch.models import objectives
from multimodal_vae_comparison_tpu_torch.ops.kernels import telemetry
from multimodal_vae_comparison_tpu_torch.training.trainer import (
    Trainer, build_model_from_config)
from test_torch_eval import JUDGE_REL, JUDGE_SHARE, NO_TB, _flax_tree, _jax_draws
from test_torch_modules import flax_params
from test_torch_train import _Recorder

REPO = Path(__file__).resolve().parents[1]
CONFIG = "configs/round4/sprites_r4_dreg_up.yml"
PER_COMBO, SEED = 2, 3
CLIP = (4, 16, 16, 3)
# the objective: loss and metrics within LOSS_RTOL, each gradient within
# GRAD_REL of its leaf's max |g| + GRAD_ATOL (fp32 sums in another order)
LOSS_RTOL, GRAD_REL, GRAD_ATOL = 1e-5, 1e-4, 1e-5
# the judges' logits on the same weights and clips
LOGIT_TOL = dict(rtol=1e-4, atol=1e-5)
# decoded means of the same weights and latents
DECODE_TOL = dict(rtol=1e-4, atol=1e-4)
EVAL_SAMPLES = 8


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """PyTorch on one thread: this file's ops are small, and beside the
    other test processes and XLA's CPU threads, PyTorch's pool on every core
    ran them tens of times slower than alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def sprites_params(data_dir, path=CONFIG, **over):
    """A shipped SPRITES config with its data paths on ``data_dir``."""
    with open(REPO / path) as f:
        params = yaml.safe_load(f)
    for key, block in params.items():
        if key.startswith("modality_"):
            block["path"] = str(data_dir)
            block["test_datapath"] = str(Path(data_dir) / "test")
    params.update(over)
    return params


def _small_shards(src: Path, dst: Path) -> None:
    """The shards of ``src`` at CLIP: frames 0, 2, 4, 6, each 4x4 block of
    pixels averaged; the attributes as they are."""
    for split_dir in (src, src / "test"):
        out = dst / split_dir.relative_to(src)
        out.mkdir(parents=True, exist_ok=True)
        for f in split_dir.glob("*.npy"):
            a = np.load(f)
            if "_frames_" in f.name:
                n, t, h, w, c = a.shape
                a = a[:, ::2].reshape(n, t // 2, h // 4, 4, w // 4, 4, c).mean((3, 5))
                a = a.astype(np.float32)
            np.save(out / f.name, a)


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    root = tmp_path_factory.mktemp("sprites")
    sprites_gen.generate(PER_COMBO, str(root / "port"), seed=SEED)
    jsprites_gen.generate(PER_COMBO, str(root / "jax"), seed=SEED)
    _small_shards(root / "port", root / "small")
    return root


# -- generator, dataset and split ---------------------------------------------------------


def test_generator_writes_the_jax_shards(shards):
    files = sorted(p.relative_to(shards / "port") for p in (shards / "port").rglob("*.npy"))
    assert files == sorted(p.relative_to(shards / "jax") for p in (shards / "jax").rglob("*.npy"))
    assert len(files) == 2 * 2 * 9
    for rel in files:
        assert (shards / "port" / rel).read_bytes() == (shards / "jax" / rel).read_bytes(), rel
    frames = np.load(shards / "port" / "walk_left_frames_train.npy")
    atts = np.load(shards / "port" / "test" / "slash_front_attributes_test.npy")
    assert frames.shape == (PER_COMBO, 8, 64, 64, 3) and frames.dtype == np.float32
    assert atts.shape == (1, 8, 4, 6) and (atts.sum(-1) == 1).all()
    assert 0 < frames.max() <= 1


def test_generator_cli(tmp_path, capsys):
    sprites_gen.main(["--per_combo", "1", "--out_dir", str(tmp_path), "--seed", "1"])
    assert "SPRITES: 1x9 train sequences" in capsys.readouterr().out
    assert len(list(tmp_path.glob("*_train.npy"))) == 18
    assert len(list((tmp_path / "test").glob("*_test.npy"))) == 18


@pytest.mark.parametrize("mod_type", ["frames", "attributes", "actions"])
def test_sprites_dataset_loads_the_jax_arrays(shards, mod_type):
    data = shards / "port"
    got = datasets.SPRITES(str(data), str(data / "test"), mod_type)
    want = jdatasets.SPRITES(str(data), str(data / "test"), mod_type)
    for split in ("train", "test"):
        (gd, gm), (wd, wm) = got.get_data(split), want.get_data(split)
        assert gm is None and wm is None
        assert gd.dtype == wd.dtype == np.float32 and np.array_equal(gd, wd), split
        assert gd.shape[1:] == tuple(datasets.SPRITES.feature_dims[mod_type])
        assert got.labels() == want.labels()
        assert np.array_equal(got.decode_output(gd[:2]), want.decode_output(wd[:2]))
    assert len(gd) == 9 and got.categorical == want.categorical
    for name in ("label_map", "attr_map", "att_names", "text2img_size", "feature_dims"):
        assert getattr(datasets.SPRITES, name) == getattr(jdatasets.SPRITES, name), name
    assert datasets.get_dataset_class("SPRITES") is datasets.SPRITES
    assert got.eval_statistics_fn() is es.sprites_eval


def test_datamodule_splits_sprites_as_jax(shards):
    params = sprites_params(shards / "port", test_split=0.25, seed=SEED, batch_size=4)
    dm, jdm = DataModule(Config(params, eval_only=True)), JDataModule(JConfig(params,
                                                                             eval_only=True))
    dm.setup()
    jdm.setup()
    assert dm.n_train == jdm.n_train == 13 and dm.n_val == jdm.n_val == 5
    assert dm.feature_dims() == jdm.feature_dims() == [[8, 64, 64, 3], [9], [4, 6]]
    for i in range(3):
        for split in ("train", "val"):
            a, b = dm.split_arrays(i, split), jdm.split_arrays(i, split)
            assert np.array_equal(a[0], b[0]) and a[1] is None and b[1] is None
        assert np.array_equal(dm._test[i]["data"], jdm._test[i]["data"])
    for split in ("labels_train", "labels_val", "labels_test"):
        assert getattr(dm, split) == getattr(jdm, split), split
    for kwargs in (dict(split="train", shuffle=True, seed=1), dict(split="val", drop_remainder=False),
                   dict(split="test", drop_remainder=False)):
        for got, want in zip(dm.batches(**kwargs), jdm.batches(**kwargs)):
            for name in ("mod_1", "mod_2", "mod_3"):
                assert np.array_equal(got[name]["data"], np.asarray(want[name]["data"]))


# -- the judges ---------------------------------------------------------------------------


def _judges(clip):
    """(port judge, flax judge) pairs of the three video judges and the
    mean-pooled judge with four heads."""
    return (
        (classifiers.VideoClassifier(9), jclassifiers.VideoClassifier(num_classes=9)),
        (classifiers.VideoClassifier(6, heads=4), jclassifiers.VideoClassifier(num_classes=6,
                                                                                heads=4)),
        (classifiers.FrameAttributeClassifier(6, heads=4, in_shape=clip[1:]),
         jclassifiers.FrameAttributeClassifier(num_classes=6, heads=4)),
        (classifiers.ActionVideoClassifier(9, in_shape=clip),
         jclassifiers.ActionVideoClassifier(num_classes=9)))


@pytest.mark.parametrize("clip", [CLIP, (8, 64, 64, 3)], ids=["small", "full"])
def test_video_judges_from_bridged_flax_params(clip):
    """Each judge on flax's weights (drawn from a seed, carried over by the
    bridge): logits of (B, heads, classes) or (B, classes) within
    LOGIT_TOL of the flax module's, and the same predictions."""
    x = np.random.default_rng(4).random((2,) + clip).astype(np.float32)
    for port, flax_judge in _judges(clip):
        params = flax_params(flax_judge, jnp.asarray(x), seed=5)
        bridge.load_flax_params(port, params)
        with torch.no_grad():
            got = port(torch.from_numpy(x)).numpy()
        want = np.asarray(flax_judge.apply(params, x))
        assert got.shape == want.shape, type(port).__name__
        np.testing.assert_allclose(got, want, **LOGIT_TOL, err_msg=type(port).__name__)
        assert np.array_equal(classifiers.predict(port, x),
                              jclassifiers.predict(flax_judge, params, x))


def test_judges_draw_their_weights_as_flax_does():
    """Each judge's kernels from flax's default, lecun_normal (a normal of
    variance 1 / fan_in cut at 2 sigma), and zero biases, from its seed:
    every leaf's spread within 10 % of flax's draw of a kernel of its shape,
    whose training recipe (epochs, lr) assumes that scale."""
    from flax import linen
    assert linen.Conv(1, (3, 3)).kernel_init is linen.Dense(1).kernel_init
    lecun = linen.Dense(1).kernel_init
    for port, _ in _judges(CLIP):
        for name, p in port.named_parameters():
            if name.endswith("bias"):
                assert not p.any(), name
                continue
            fan_in = p[0].numel()
            want = np.asarray(lecun(jax.random.PRNGKey(0), (fan_in, p.shape[0])))
            assert p.std().item() == pytest.approx(want.std(), rel=0.1), name
            assert p.abs().max().item() <= 2.001 * (1 / fan_in) ** 0.5 / 0.8796
    a = classifiers.FrameAttributeClassifier(6, seed=3)
    b = classifiers.FrameAttributeClassifier(6, seed=3)
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(), b.parameters()))


def test_train_classifier_one_epoch_of_a_multi_head_judge_matches_optax():
    """One Adam epoch (3 steps of 20 clips at lr 1e-3) of the four-head
    attribute judge from flax's init, the port against the JAX package, as
    the CdSprites+ judge is held (test_torch_eval)."""
    rng = np.random.default_rng(6)
    x = rng.random((60,) + CLIP).astype(np.float32)
    y = rng.integers(0, 6, (60, 4))
    jmodel = jclassifiers.FrameAttributeClassifier(num_classes=6, heads=4)
    init = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1,) + CLIP))
    trained = jclassifiers.train_classifier(jmodel, x, y, epochs=1, batch_size=20)
    model = classifiers.FrameAttributeClassifier(6, heads=4, in_shape=CLIP[1:])
    bridge.load_flax_params(model, jax.tree_util.tree_map(np.asarray, init))
    classifiers.train_classifier(model, x, y, epochs=1, batch_size=20)
    want = classifiers.FrameAttributeClassifier(6, heads=4, in_shape=CLIP[1:])
    bridge.load_flax_params(want, jax.tree_util.tree_map(np.asarray, trained))
    steps = 3
    for (name, p), w in zip(model.named_parameters(), want.parameters()):
        diff = (p - w).detach().abs()
        assert diff.max().item() <= 2 * 1e-3 * steps, name
        share = (diff <= JUDGE_REL * w.abs().max()).float().mean().item()
        assert share >= JUDGE_SHARE, f"{name}: {share:.6f} of the weights within {JUDGE_REL}"
    assert classifiers.predict(model, x).shape == (60, 4)
    assert (classifiers.classifier_accuracy(model, x, y)
            == jclassifiers.classifier_accuracy(jmodel, trained, x, y))


# -- the model from the config ------------------------------------------------------------


def _record_dreg_weights(monkeypatch):
    """Keep the DReG importance weights the JAX objective computes (the
    softmax over K of its (M, K, B) log-weights)."""
    kept, softmax = [], jax.nn.softmax

    def recording(x, axis=-1, **kwargs):
        out = softmax(x, axis=axis, **kwargs)
        if axis == 1 and jnp.ndim(x) == 3:
            kept.append(out)
        return out

    monkeypatch.setattr(jax.nn, "softmax", recording)
    return kept


@pytest.fixture(scope="module")
def objective(shards):
    """The JAX package's objective and gradients of the config's model at
    bs 2 and K 2 on numpy-drawn weights, with its draws and DReG weights."""
    params = sprites_params(shards / "small", K=2, batch_size=2, seed=SEED)
    jcfg = JConfig(params, eval_only=True)
    jdm = JDataModule(jcfg)
    jdm.setup()
    jmodel = jbuild_model(jcfg)
    batch = next(jdm.batches("train"))
    jb = jax.tree_util.tree_map(jnp.asarray, batch)
    with pytest.MonkeyPatch.context() as mp:
        rec = _Recorder(mp)
        weights = _record_dreg_weights(mp)
        shapes = jax.eval_shape(lambda: jmodel.init(
            {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)}, jb,
            method=jmodel.objective))
        from test_torch_slice import draw_params
        jparams = draw_params(shapes, 7)

        def loss_fn(p):
            rec.draws.clear()
            weights.clear()
            loss, metrics = jmodel.apply(p, jb, rngs={"sample": jax.random.PRNGKey(8)},
                                         method=jmodel.objective)
            return loss, (metrics, list(rec.draws), list(weights))

        # XLA's backend optimizations off: the same ops in the same order,
        # compiled in about half the time
        (loss, (metrics, draws, w)), grads = jax.jit(
            jax.value_and_grad(loss_fn, has_aux=True),
            compiler_options={"xla_backend_optimization_level": 0})(jparams)
    to_numpy = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
    return types.SimpleNamespace(params=params, batch=batch, jparams=jparams, loss=float(loss),
                                 metrics=to_numpy(metrics), draws=to_numpy(draws),
                                 weights=to_numpy(w), grads=to_numpy(grads))


def _port_from_config(params):
    cfg = Config(params, eval_only=True)
    DataModule(cfg).setup()
    return cfg, build_model_from_config(cfg, device="cpu")


def test_model_from_config_objective_and_grads_match_jax(objective, monkeypatch):
    """MOE + DReG at the config's widths (VideoGPT with axial attention,
    FNN actions and attributes, 32 latents, llik 600 on both categorical
    modalities, remat) at K 2, bs 2: loss and metrics within LOSS_RTOL and
    every gradient within GRAD_REL x its leaf's max |g| + GRAD_ATOL, on
    JAX's draws and on JAX's importance weights (they exponentiate
    log-weights of ~-2e3, whose fp32 rounding moves them by ~1e-4; the
    port's own are held to them within 1e-3).  Attention runs its plain
    version 60 times: 12 in the encoder (4 blocks x 3 axes), 12 in each of
    the decoder's two passes, and remat's 24 re-runs of the encoder and the
    second decoder pass in the backward."""
    cfg, model = _port_from_config(objective.params)
    assert (cfg.mixing, cfg.obj, cfg.K, cfg.n_latents, model.remat) == ("moe", "dreg", 2, 32,
                                                                        True)
    assert [s.llik_scaling for s in model.specs] == [1.0, 600.0, 600.0]
    assert [s.recon_loss for s in model.specs] == ["bce", "category_ce", "category_ce"]
    bridge.load_flax_params(model, objective.jparams)
    own = []

    def replay(lw, dim=0):
        own.append(torch.softmax(lw.detach(), dim=dim))
        return torch.from_numpy(np.array(objective.weights[0]))

    monkeypatch.setattr(objectives, "dreg_grad_weights", replay)
    batch = {n: {"data": torch.from_numpy(m["data"]), "masks": None}
             for n, m in objective.batch.items()}
    eps = {s.name: torch.from_numpy(np.array(d)) for s, d in zip(model.specs, objective.draws)}
    telemetry.reset()
    loss, metrics = model.objective(batch, eps=eps)
    loss.backward()
    assert telemetry.summary() == {"attention:plain": 60}
    assert len(objective.weights) == 1 and len(own) == 1
    np.testing.assert_allclose(own[0].numpy(), objective.weights[0], atol=1e-3)
    np.testing.assert_allclose(loss.item(), objective.loss, rtol=LOSS_RTOL)
    assert sorted(metrics) == sorted(objective.metrics)
    for k, v in metrics.items():
        np.testing.assert_allclose(v.item(), float(objective.metrics[k]), rtol=LOSS_RTOL,
                                   atol=1e-4, err_msg=k)
    _, want = _port_from_config(objective.params)
    bridge.load_flax_params(want, objective.grads)
    for (name, p), g in zip(model.named_parameters(), want.parameters()):
        got = torch.zeros_like(p) if p.grad is None else p.grad
        err = (got - g).abs().max().item()
        limit = GRAD_REL * g.abs().max().item() + GRAD_ATOL
        assert err <= limit, f"{name}: max abs error {err:.3e} > {limit:.3e}"


def _chip_smoke():
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    return chip_smoke


@pytest.mark.parametrize("path,mixing", [("configs/round4/sprites_r4_dreg_up.yml", "moe"),
                                         ("configs/round2/sprites_r2_poe.yml", "poe")])
def test_launch_counts_of_the_sprites_configs(shards, path, mixing):
    """The counts chip_smoke.py holds the card's runs to, from the plain
    versions' dispatches on the CPU: a train step (remat re-runs the nets)
    and a validation step of each config's model, at bs 2."""
    cs = _chip_smoke()
    params = sprites_params(shards / "small", path, batch_size=2, seed=SEED)
    cfg, model = _port_from_config(params)
    assert cfg.mixing == mixing and model.remat
    batch = {n: {"data": torch.from_numpy(m["data"]), "masks": None}
             for n, m in next(DataModule(cfg).batches("train")).items()}
    from multimodal_vae_comparison_tpu_torch.training.optim import make_optimizer
    from multimodal_vae_comparison_tpu_torch.training.trainer import (
        make_eval_step, make_train_step)
    tables = (cs.SPRITES_PER_OBJECTIVE, cs.SPRITES_PER_BACKWARD)
    for step, backward in ((make_train_step(model, make_optimizer("adam", 1e-4,
                                                                  model.parameters())), 1),
                           (make_eval_step(model), 0)):
        telemetry.reset()
        step(batch, generator=torch.Generator().manual_seed(0))
        want = cs.expected_launches(mixing, 1, backward, tables)
        assert telemetry.summary() == {f"{k}:plain": n for k, n in want.items()}


# -- the benchmark --------------------------------------------------------------------------


def _recording_predict(predict, log):
    def judge(model, *args, **kwargs):
        images = np.array(args[-1] if len(args) > 1 else args[0])
        out = predict(model, *args, **kwargs)
        log.append((images, np.asarray(out)))
        return out
    return judge


@pytest.fixture(scope="module")
def run(shards):
    """A port-trained run on the small shards (MOE/DReG from the config, 1
    epoch at bs 3 and K 2), its JAX twin through the inverse bridge, two
    judges trained by the JAX package on the train split and bridged into
    the port's cache, and the JAX eval with its draws and every batch its
    judges saw.  On 9 train clips the action judge reads the real test
    clips well above chance; the attribute judge, at 24 classes, near it:
    its verdicts still vary from clip to clip, which is what holding the
    two evals to the same verdicts needs."""
    root = shards / "eval"
    params = sprites_params(shards / "small", K=2, batch_size=3, epochs=1, seed=SEED,
                            test_split=0.5, exp_name="sprites_eval")
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, NO_TB, None)
        trainer = Trainer(Config(params, results_root=str(root / "port")), device="cpu",
                          enable_viz=False)
    trainer.fit(epochs=1, log_fn=None)
    pexp = infer.MultimodalVAEInfer(trainer.cfg.mPath, device="cpu")

    jcfg = JConfig(params, results_root=str(root / "jax"))
    jdm = JDataModule(jcfg)
    jdm.setup()
    jmodel = jbuild_model(jcfg)
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: jmodel.init({"params": key, "sample": key},
                                                next(jdm.batches("train")),
                                                method=jmodel.objective))
    jparams = {"params": _flax_tree(pexp.model, shapes["params"])}
    jtrainer = types.SimpleNamespace(cfg=jcfg, datamodule=jdm, model=jmodel,
                                     state=types.SimpleNamespace(params=jparams))
    # the judges: the JAX package's training, cached where both evals look
    frames, _ = jdm.split_arrays(0, "train")
    actions = np.argmax(jdm.split_arrays(1, "train")[0], -1)
    atts = np.argmax(jdm.split_arrays(2, "train")[0], -1)
    judges = {}
    for name, jjudge, port, y in (
            ("sprites_action_clf_v3", jclassifiers.ActionVideoClassifier(num_classes=9),
             classifiers.ActionVideoClassifier(9, in_shape=CLIP), actions),
            ("sprites_att_clf_v4", jclassifiers.FrameAttributeClassifier(num_classes=6, heads=4),
             classifiers.FrameAttributeClassifier(6, heads=4, in_shape=CLIP[1:]), atts)):
        trained = jclassifiers.train_classifier(jjudge, frames, y, epochs=10, lr=3e-3)
        jclassifiers.save_classifier(trained, str(root / "jclf" / f"{name}.pkl"))
        bridge.load_flax_params(port, jax.tree_util.tree_map(np.asarray, trained))
        classifiers.save_classifier(port, str(root / "pclf" / f"{name}.pt"))
        judges[name] = port

    draws, judged = [], []

    def record(dist, key, sample_shape=()):
        eps = jax.random.normal(key, tuple(sample_shape) + jnp.shape(dist.loc))
        draws.append(np.asarray(eps))
        return dist.loc + eps * dist.scale

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SPRITES_CLASSIFIER_DIR", str(root / "jclf"))
        mp.setenv("SPRITES_EVAL_SAMPLES", str(EVAL_SAMPLES))
        mp.setattr(jdist.Normal, "rsample", record)
        mp.setattr(jes, "predict", _recording_predict(jes.predict, judged))
        mp.setattr(jes, "labelled_tsne", lambda exp, n=250: None)
        want = jes.sprites_eval(jtrainer)
    return types.SimpleNamespace(root=root, params=params, trainer=trainer, pexp=pexp,
                                 jcfg=jcfg, want=want, draws=draws,
                                 judged=judged, judges=judges)


def test_sprites_eval_gives_the_jax_stats(run, monkeypatch, capsys):
    """The whole benchmark from the same weights, judges and draws: every
    clip a judge is shown within one uint8 level of the JAX package's
    (decoded means within DECODE_TOL), at most one verdict flipped per
    batch, and each of the 10 stats equal to the JAX package's or one
    judged row apart."""
    exp = infer.MultimodalVAEInfer(run.pexp.run_dir, device="cpu")
    n = min(EVAL_SAMPLES, exp.datamod.n_val)
    queue = list(run.draws)
    judged = []

    def replay(dist, sample_shape=(), generator=None, eps=None):
        return dist.loc + torch.from_numpy(np.array(queue.pop(0))) * dist.scale

    generate = exp.joint_generate

    def joint_generate(num, seed=0, source="prior", temperature=1.0):
        _, eps = _jax_draws(seed, source, num, exp.model.n_latents)
        return generate(num, seed, source, temperature, eps=np.array(eps))

    monkeypatch.setattr(tdist.Normal, "rsample", replay)
    monkeypatch.setattr(exp, "joint_generate", joint_generate)
    monkeypatch.setattr(es, "predict", _recording_predict(es.predict, judged))
    monkeypatch.setattr(es, "labelled_tsne", lambda exp, n=250: None)
    monkeypatch.setenv("SPRITES_CLASSIFIER_DIR", str(run.root / "pclf"))
    monkeypatch.setenv("SPRITES_EVAL_SAMPLES", str(EVAL_SAMPLES))
    telemetry.reset()
    got = es.sprites_eval(exp)
    # the launches chip_smoke.py holds the card's eval to (no t-SNE here)
    assert telemetry.summary() == {
        f"{k}:plain": n for k, n in _chip_smoke().sprites_eval_launches("moe", False).items()}
    print("JAX stats:", run.want)
    assert not queue and n == EVAL_SAMPLES
    assert list(got) == list(run.want) == list(es.STATS_KEYS)
    # real frames twice, actions->frames, atts->frames, joint twice
    assert len(judged) == len(run.judged) == 6
    for (images, verdicts), (jimages, jverdicts) in zip(judged, run.judged):
        assert images.shape == jimages.shape and images.shape[1:] == CLIP
        np.testing.assert_allclose(images, jimages, **DECODE_TOL)
        flips = int((verdicts != jverdicts).reshape(len(verdicts), -1).any(-1).sum())
        assert flips <= 1
    # the judges tell the real clips apart: not one verdict for all
    assert len(np.unique(judged[0][1])) > 1 and len(np.unique(judged[1][1])) > 1
    for k in es.STATS_KEYS:
        if got[k] != run.want[k]:
            print(f"{k}: port {got[k]}, JAX {run.want[k]} (one row is {1 / n})")
        assert abs(got[k] - run.want[k]) <= 1 / n + 1e-9, k
    for path in (exp.run_dir, run.jcfg.mPath):
        with open(os.path.join(path, "sprites_stats.txt")) as f:
            assert [line.split(":")[0] for line in f] == list(es.STATS_KEYS)
    assert "[judge] sprites_action_judge_accuracy_real" in capsys.readouterr().out


def test_trainer_test_scores_sprites_and_restores_k(run, monkeypatch):
    """``Trainer.test()`` ends in the SPRITES benchmark with the cached
    judges (loaded, not trained: their weights are the bridged ones) and
    leaves the trainer at its config's K."""
    monkeypatch.setenv("SPRITES_CLASSIFIER_DIR", str(run.root / "pclf"))
    monkeypatch.setenv("SPRITES_EVAL_SAMPLES", "4")
    monkeypatch.setattr(es, "labelled_tsne", lambda exp, n=250: None)
    stats = run.trainer.test()
    assert run.trainer.model.K == 2
    assert "eval_error" not in stats and set(es.STATS_KEYS) <= set(stats)
    assert all(0.0 <= stats[k] <= 1.0 for k in es.STATS_KEYS)
    exp = infer.MultimodalVAEInfer(run.pexp.run_dir, device="cpu")
    for name, judge in ((es._action_classifier, run.judges["sprites_action_clf_v3"]),
                        (es._attribute_classifier, run.judges["sprites_att_clf_v4"])):
        for a, b in zip(name(exp, str(run.root / "pclf")).parameters(), judge.parameters()):
            assert torch.equal(a, b)


@pytest.mark.parametrize("path,mixing", [("configs/round4/sprites_r4_dreg_up.yml", "moe"),
                                         ("configs/round2/sprites_r2_poe.yml", "poe")])
def test_sprites_eval_launches_with_the_tsne_forward(run, monkeypatch, path, mixing):
    """The benchmark of a fresh model of each config, with the cached
    judges and the labelled t-SNE's forward (sklearn missing, so nothing
    is drawn): the launches chip_smoke.py expects on a host with
    matplotlib."""
    params = sprites_params(Path(run.params["modality_1"]["path"]), path, batch_size=3,
                            seed=SEED, test_split=0.5, exp_name="launches")
    monkeypatch.setitem(sys.modules, NO_TB, None)
    monkeypatch.setitem(sys.modules, "sklearn", None)
    monkeypatch.setenv("SPRITES_CLASSIFIER_DIR", str(run.root / "pclf"))
    monkeypatch.setenv("SPRITES_EVAL_SAMPLES", "4")
    trainer = Trainer(Config(params, results_root=str(run.root / "launches")), device="cpu",
                      enable_viz=False).init_state()
    telemetry.reset()
    stats = es.sprites_eval(trainer)
    assert set(stats) == set(es.STATS_KEYS)
    assert telemetry.summary() == {
        f"{k}:plain": n for k, n in _chip_smoke().sprites_eval_launches(mixing, True).items()}


def test_labelled_tsne_writes_one_plot_per_modality_and_family(run, monkeypatch):
    """The plot names of the JAX package's, from a stand-in t-SNE (the
    projection itself is sklearn's); without sklearn nothing is drawn."""
    exp = infer.MultimodalVAEInfer(run.pexp.run_dir, device="cpu")
    visuals = Path(exp.run_dir) / "visuals"
    monkeypatch.setitem(sys.modules, "sklearn", None)
    es.labelled_tsne(exp, n=6)
    assert visuals.is_dir() and not list(visuals.glob("eval_tsne_*"))
    manifold = types.ModuleType("sklearn.manifold")
    manifold.TSNE = lambda **kwargs: types.SimpleNamespace(fit_transform=lambda z: z[:, :2])
    monkeypatch.setitem(sys.modules, "sklearn", types.ModuleType("sklearn"))
    monkeypatch.setitem(sys.modules, "sklearn.manifold", manifold)
    es.labelled_tsne(exp, n=6)
    families = ["action"] + datasets.SPRITES.attr_map
    assert sorted(p.name for p in visuals.glob("eval_tsne_*")) == sorted(
        f"eval_tsne_{m}_{f}.png" for m in exp.mod_names for f in families)


# -- CLIs and the GIF -----------------------------------------------------------------------


def test_main_trains_a_sprites_config_and_scores_it(shards, tmp_path, monkeypatch, capsys):
    """``main --device cpu`` on a copy of the config (1 epoch, bs 4, K 2 on
    the small shards): the judges are trained and cached, and the run ends
    in ``sprites_stats.txt`` with the 10 stats."""
    params = sprites_params(shards / "small", K=2, batch_size=4, epochs=1, exp_name="cli")
    cfg = tmp_path / "sprites.yml"
    cfg.write_text(yaml.safe_dump(params))
    monkeypatch.chdir(tmp_path)
    monkeypatch.setitem(sys.modules, NO_TB, None)
    monkeypatch.setenv("SPRITES_CLASSIFIER_DIR", str(tmp_path / "judges"))
    monkeypatch.setenv("SPRITES_EVAL_SAMPLES", "4")
    monkeypatch.setattr(es, "labelled_tsne", lambda exp, n=250: None)
    trainer = port_main.cli(["--cfg", str(cfg), "--device", "cpu", "--no_viz"])
    run_dir = Path(trainer.cfg.mPath)
    with open(run_dir / "sprites_stats.txt") as f:
        assert [line.split(":")[0] for line in f] == list(es.STATS_KEYS)
    assert sorted(os.listdir(tmp_path / "judges")) == ["sprites_action_clf_v3.pt",
                                                      "sprites_att_clf_v4.pt"]
    assert (run_dir / "model" / "last" / "state.pt").is_file()
    assert "test:" in capsys.readouterr().out


def test_train_classifiers_cli_saves_the_sprites_action_judge(shards, tmp_path, capsys):
    acc = train_classifiers.main(["--dataset", "sprites", "--path", str(shards / "small"),
                                  "--out_dir", str(tmp_path), "--device", "cpu"])
    assert 0.0 <= acc <= 1.0
    assert sorted(os.listdir(tmp_path)) == ["sprites_action_clf_v2.pt"]
    judge = classifiers.load_classifier(classifiers.VideoClassifier(9, seed=1),
                                        str(tmp_path / "sprites_action_clf_v2.pt"))
    assert "actions: holdout acc" in capsys.readouterr().out
    x = np.load(shards / "small" / "walk_front_frames_train.npy")
    assert classifiers.predict(judge, x).shape == (PER_COMBO,)


def test_save_video_gif_writes_the_jax_gif(tmp_path):
    imageio = pytest.importorskip("imageio")
    clips = np.random.default_rng(9).random((3,) + CLIP).astype(np.float32)
    viz.save_video_gif(clips, str(tmp_path / "port.gif"))
    jviz.save_video_gif(clips, str(tmp_path / "jax.gif"))
    assert (tmp_path / "port.gif").read_bytes() == (tmp_path / "jax.gif").read_bytes()
    frames = imageio.mimread(str(tmp_path / "port.gif"))
    assert len(frames) == CLIP[0] and frames[0].shape[:2] == (16, 3 * 16)


def test_epoch_visualizations_write_the_video_gif(run, tmp_path, monkeypatch):
    """The reconstructions of a video modality also go to a GIF."""
    monkeypatch.setitem(sys.modules, "sklearn", None)
    exp = infer.MultimodalVAEInfer(run.pexp.run_dir, device="cpu")
    cfg = types.SimpleNamespace(get_vis_dir=lambda: str(tmp_path))
    viz.save_reconstructions(types.SimpleNamespace(cfg=cfg, model=exp.model,
                                                   datamodule=exp.datamod), str(tmp_path))
    names = exp.mod_names
    assert (tmp_path / "recon_video_mod_1.gif").is_file()
    assert {f"recon_from_{'_'.join(p)}.png" for p in [(n,) for n in names] + [names]} \
        <= set(os.listdir(tmp_path))
