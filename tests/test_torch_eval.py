"""The port's CdSprites+ benchmark against the JAX package's, on the CPU.

One tiny run is trained by the port (level 1, 191 train and 64 val rows)
and carried to the JAX package by inverting ``bridge.load_flax_params``; a
judge is trained by the JAX package over the train split (it reads the val
rows well above chance) and carried to the port through the bridge.  With no test file the eval samples the val split, so that its
cross-generation, ex-post and joint batches all have 64 rows, and the JAX
package's op-by-op forwards compile once for all of them.
The JAX eval runs first and records its draws: each forward's by patching
``Normal.rsample``, the joint-generation draws recomputed from its keys.
The port replays them, so the two evals see the same weights, judge, data
and noise: every image batch the judge is shown (the real rows, then the
text->image and the three joint generations) must be the JAX package's to
one uint8 level, and each of the 12 stats within one judged row.  The
judge's arg-max is replayed as ``chip_smoke.same_branches`` replays relus
(a decision near a tie may go either way under fp32 sums taken in another
order, and one decision can flip a whole batch of near-identical generated
images): the port's judge is shown JAX's images and held to the JAX
judge's logits, and the port's eval takes JAX's verdicts.  Then
the pieces: the text analysis, the stats writers, the GMM fit, the seeded
test samples, the prior draw, the judge and its training step, joint
generation per source, ``Trainer.test`` and the epoch visualizations.
"""
import os
import shutil
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_vae_comparison_tpu import utils as jutils
from multimodal_vae_comparison_tpu import visualization as jviz
from multimodal_vae_comparison_tpu.config import Config as JConfig
from multimodal_vae_comparison_tpu.data.datamodule import DataModule as JDataModule
from multimodal_vae_comparison_tpu.eval import classifiers as jclassifiers
from multimodal_vae_comparison_tpu.eval import eval_cdsprites as jec
from multimodal_vae_comparison_tpu.eval import infer as jinfer
from multimodal_vae_comparison_tpu.models import distributions as jdist
from multimodal_vae_comparison_tpu.training.trainer import build_model as jbuild_model
from multimodal_vae_comparison_tpu_torch import bridge, utils
from multimodal_vae_comparison_tpu_torch import visualization as viz
from multimodal_vae_comparison_tpu_torch.config import Config
from multimodal_vae_comparison_tpu_torch.data.datamodule import DataModule
from multimodal_vae_comparison_tpu_torch.data.datasets import CDSPRITESPLUS
from multimodal_vae_comparison_tpu_torch.data_proc import cdsprites
from multimodal_vae_comparison_tpu_torch.eval import classifiers
from multimodal_vae_comparison_tpu_torch.eval import eval_cdsprites as ec
from multimodal_vae_comparison_tpu_torch.eval import infer
from multimodal_vae_comparison_tpu_torch.eval import train_classifiers
from multimodal_vae_comparison_tpu_torch.models import distributions as tdist
from multimodal_vae_comparison_tpu_torch.training.trainer import Trainer
from test_torch_data import cdsprites_params
from test_torch_slice import one_torch_thread  # noqa: F401 (autouse)

# 255 rows: 191 train, 64 val (test_split 0.25)
N_LATENTS, COUNT, JOINT_N, JUDGE_ROWS = 8, 255, 64, 60
# the eval's judge: JUDGE_EPOCHS epochs of 5 batches of 32 train rows (its
# default, 12 epochs of 128 rows, is one batch an epoch here, and 25 steps
# take 6-8 s); it must read the real val rows at JUDGE_MIN % or more (chance
# is 33 %; measured 71.9 %) and tell all 3 shapes apart
JUDGE_EPOCHS, JUDGE_MIN = 5, 60.0
# what the judge is shown, in the eval's order
JUDGED = ("real rows", "text->image", "prior joint", "ex-post joint", "fitted joint")
# the Trainers here log no TensorBoard: nothing reads it, and importing
# tensorboardX takes seconds (the Trainer runs without it where it is missing)
NO_TB = "tensorboardX"
# decoded means of the same weights and latents: fp32 sums in another order
# through the decoders
DECODE_TOL = dict(rtol=1e-4, atol=1e-4)
# one Adam epoch of the judge (3 steps at lr 1e-3) from the same init, optax
# against torch.optim: each leaf within JUDGE_REL of its max |w|.  Where a
# gradient is within rounding of zero (~1e-9 against Adam's eps of 1e-8)
# the step it takes is not fixed by fp32 and may be up to lr either way, so
# every weight is held to 2 lr a step and JUDGE_SHARE of each leaf to
# JUDGE_REL (measured: one weight over it in each of two leaves, of
# 16,384 and 131,072)
JUDGE_REL, JUDGE_SHARE = 1e-4, 0.999


def _flax_tree(model, shapes):
    """``model``'s weights as the flax tree of ``shapes``: each leaf inverts
    the bridge's layout map, found by mapping the leaf's flat indices."""
    params = dict(model.named_parameters())

    def leaf(path, sds):
        *mod_path, name = path
        module = model.get_submodule(".".join(mod_path))
        idx = np.arange(int(np.prod(sds.shape))).reshape(sds.shape)
        tname, mapped = (bridge._convert(module, name, idx)
                         if isinstance(module, bridge._LAYERS) else (name, idx))
        w = params[".".join(mod_path + [tname])].detach().numpy()
        out = np.empty(idx.size, np.float32)
        out[np.asarray(mapped).ravel()] = w.ravel()
        return out.reshape(sds.shape)

    def walk(tree, prefix):
        return {k: walk(v, prefix + (k,)) if isinstance(v, dict) else leaf(prefix + (k,), v)
                for k, v in tree.items()}

    return walk(shapes, ())


def _jax_draws(seed, source, n, d, n_rows=None, logw=None):
    """The draws of the JAX ``joint_generate`` for ``source``."""
    key = jax.random.PRNGKey(seed)
    if source == "prior":
        return None, np.asarray(jax.random.normal(key, (1, n, d)))
    k1, k2 = jax.random.split(key)
    if source == "expost":
        idx = jax.random.randint(k1, (n,), 0, n_rows)
    else:
        probs = np.exp(logw - logw.max())
        idx = jax.random.choice(k1, len(logw), (n,), p=jnp.asarray(probs / probs.sum()))
    return np.asarray(idx), np.asarray(jax.random.normal(k2, (n, d)))


def _recording(eval_with_classifier, log):
    """The JAX ``eval_with_classifier`` that also appends (att, images,
    verdicts, logits) to ``log``."""
    def judge(clf, image_batch, att):
        verdicts = eval_with_classifier(clf, image_batch, att)
        model, params = clf
        logits = np.asarray(model.apply(params, jnp.asarray(
            np.asarray(image_batch, np.float32) / 255.0)))
        log.append((att, np.array(image_batch), list(verdicts), logits))
        return verdicts
    return judge


def _replaying(jjudged, log):
    """The port's ``eval_with_classifier`` with the JAX eval's decisions:
    it appends (att, the port's images, the port judge's logits on JAX's
    images of the same call) to ``log`` and returns JAX's verdicts."""
    def judge(clf, image_batch, att):
        _, jimages, jverdicts, _ = jjudged[len(log)]
        clf.eval()
        with torch.no_grad():
            logits = clf(torch.from_numpy(jimages.astype(np.float32) / 255.0)).numpy()
        log.append((att, np.array(image_batch), logits))
        return list(jverdicts)
    return judge


def _as_flax_trainer(jcfg, jdm, jmodel, params):
    return types.SimpleNamespace(cfg=jcfg, datamodule=jdm, model=jmodel,
                                 state=types.SimpleNamespace(params=params))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """A port-trained run and its JAX twin, the JAX eval with its draws,
    and the JAX judge bridged into the port's cache."""
    root = tmp_path_factory.mktemp("eval")
    level = cdsprites.generate_level(1, COUNT, str(root / "data"), seed=0)
    params = cdsprites_params(level, batch_size=24, n_latents=N_LATENTS, lr=1e-3)
    for i in (1, 2):
        del params[f"modality_{i}"]["test_datapath"]
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
    batch = next(jdm.batches("train"))
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: jmodel.init({"params": key, "sample": key}, batch,
                                                method=jmodel.objective))
    jparams = {"params": _flax_tree(pexp.model, shapes["params"])}
    twin = type(pexp.model)(pexp.model.specs, N_LATENTS, device="cpu", seed=99)
    bridge.load_flax_params(twin, jparams)
    for (name, a), b in zip(twin.state_dict().items(), pexp.model.state_dict().values()):
        assert torch.equal(a, b), name
    jexp = jec._as_infer(_as_flax_trainer(jcfg, jdm, jmodel, jparams))
    # the judge: the JAX package's training over the train split, cached
    # where its eval looks
    name = "cdspritesplus_classifier_level1_shape_v2"
    images, _ = jdm.split_arrays(0, "train")
    y = np.array([jec.CLASS_MAPPINGS["shape"].index(t) for t in jdm.labels_train])
    jjudge = jclassifiers.train_classifier(jclassifiers.CNNClassifier(num_classes=3),
                                           images, y, epochs=JUDGE_EPOCHS, batch_size=32)
    # and one epoch over 60 rows, which test_train_classifier_... holds the
    # port's training against
    adam_data = (images[:JUDGE_ROWS], y[:JUDGE_ROWS])
    jadam = jclassifiers.train_classifier(jclassifiers.CNNClassifier(num_classes=3),
                                          *adam_data, epochs=1, batch_size=20)
    jclassifiers.save_classifier(jjudge, str(root / "jclf" / f"{name}.pkl"))
    judge = classifiers.CNNClassifier(3)
    bridge.load_flax_params(judge, jax.tree_util.tree_map(np.asarray, jjudge))
    classifiers.save_classifier(judge, str(root / "pclf" / f"{name}.pt"))

    draws, judged = [], []

    def record(dist, key, sample_shape=()):
        eps = jax.random.normal(key, tuple(sample_shape) + jnp.shape(dist.loc))
        draws.append(np.asarray(eps))
        return dist.loc + eps * dist.scale

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CDSPRITES_CLASSIFIER_DIR", str(root / "jclf"))
        mp.setattr(jdist.Normal, "rsample", record)
        mp.setattr(jec, "eval_with_classifier", _recording(jec.eval_with_classifier, judged))
        want = jec.eval_single_model(jexp, n_samples=250, log_fn=None)
    return types.SimpleNamespace(root=root, level=level, params=params, run_dir=trainer.cfg.mPath,
                                 pexp=pexp, jexp=jexp, jparams=jparams, jcfg=jcfg, jdm=jdm,
                                 jmodel=jmodel, want=want, draws=draws, judged=judged,
                                 judge=judge, jjudge=jjudge, adam_data=adam_data, jadam=jadam)


def _fresh_infer(run):
    return infer.MultimodalVAEInfer(run.run_dir, device="cpu")


# -- the slice whole ------------------------------------------------------------------


def test_eval_single_model_gives_the_jax_stats(run, monkeypatch, capsys):
    """The whole benchmark from the same weights, judge and draws: every
    image the judge is shown within one uint8 level of the JAX package's,
    the port's judge on JAX's images within DECODE_TOL of the JAX judge's
    logits, and, on JAX's verdicts, every stat equal to its, or off by at
    most one judged row."""
    jstats = {k: run.want[k] for k in ec.STATS_KEYS}
    # a judge whose verdicts depend on the images: well above chance on
    # the real rows, all 3 shapes told apart
    assert jstats["Judge Accuracy Real"] >= JUDGE_MIN
    assert run.judged[0][0] == "shape" and len(set(run.judged[0][2])) == 3
    exp = _fresh_infer(run)
    queue = list(run.draws)
    judged = []

    def replay(dist, sample_shape=(), generator=None, eps=None):
        return dist.loc + torch.from_numpy(queue.pop(0)) * dist.scale

    generate = exp.joint_generate
    n_rows = len(run.jexp._expost_cache[0])
    logw = run.jexp._fitted_cache[2]

    def joint_generate(num, seed=0, source="prior", temperature=1.0):
        idx, eps = _jax_draws(seed, source, num, N_LATENTS, n_rows, logw)
        return generate(num, seed, source, temperature, idx=idx, eps=eps)

    monkeypatch.setattr(tdist.Normal, "rsample", replay)
    monkeypatch.setattr(exp, "joint_generate", joint_generate)
    monkeypatch.setattr(ec, "eval_with_classifier", _replaying(run.judged, judged))
    monkeypatch.setenv("CDSPRITES_CLASSIFIER_DIR", str(run.root / "pclf"))
    got = ec.eval_single_model(exp, n_samples=250)
    assert "classifier[shape]: cached" in capsys.readouterr().out
    print("JAX stats:", jstats)
    assert not queue
    assert len(judged) == len(run.judged) == len(JUDGED)
    for what, (att, images, logits), (jatt, jimages, jverdicts, jlogits) in zip(
            JUDGED, judged, run.judged):
        assert att == jatt and images.shape == jimages.shape == (JOINT_N, 64, 64, 3), what
        # uint8 of decoded means within DECODE_TOL: a level apart at most
        assert np.abs(images.astype(int) - jimages.astype(int)).max() <= 1, what
        # the same judge on the same images: JAX's logits, and so its verdicts
        # wherever they are no tie
        np.testing.assert_allclose(logits, jlogits, **DECODE_TOL, err_msg=what)
        assert [ec.CLASS_MAPPINGS[att][i] for i in jlogits.argmax(-1)] == list(jverdicts), what
        top = np.sort(jlogits, -1)
        print(f"{what}: verdicts {dict(zip(*np.unique(jverdicts, return_counts=True)))}, "
              f"least arg-max margin {float((top[:, -1] - top[:, -2]).min()):.3g}")
    assert list(got) == list(run.want) == list(ec.STATS_KEYS)
    assert exp.datamod._test is None and exp.datamod.n_val == JOINT_N
    for k in ec.STATS_KEYS:
        rows = JOINT_N
        if got[k] != run.want[k]:
            print(f"{k}: port {got[k]}, JAX {run.want[k]} (one row is {100 / rows})")
        assert abs(got[k] - run.want[k]) <= 100 / rows + 1e-9, k
    assert np.isfinite(list(got.values())).all()
    for path in (exp.run_dir, run.jcfg.mPath):
        assert os.path.isfile(os.path.join(path, "cdspritesplus_stats.txt"))


# -- the pieces ---------------------------------------------------------------------------


def test_tables_and_text_analysis_match_jax(tmp_path):
    for name in ("COLORS", "SHAPENAMES", "SIZES", "LOCATIONS", "BACKGROUNDS",
                 "LEVEL_ATTRIBUTES", "SOURCES", "CLASS_MAPPINGS"):
        assert getattr(ec, name) == getattr(jec, name), name
    rng = np.random.default_rng(0)
    for level in range(1, 6):
        path = os.path.join(cdsprites.generate_level(level, 1, str(tmp_path), seed=0),
                            "testdata.h5")
        texts = [" ".join(l) if isinstance(l, list) else l
                 for l in CDSPRITESPLUS(path, None, "text").labels()]
        # and the same captions with letters knocked out, as a decoder writes them
        noisy = ["".join(c if rng.random() > 0.1 else "x" for c in t) for t in texts]
        for t, r in zip(texts, noisy):
            for att in ec.SOURCES:
                assert ec.get_attribute(att, t) == jec.get_attribute(att, t)
                if att in ec.LEVEL_ATTRIBUTES[level]:
                    assert (ec.get_attribute_from_recon(att, r, level)
                            == jec.get_attribute_from_recon(att, r, level))
            assert ec.try_retrieve_atts(r, level) == jec.try_retrieve_atts(r, level)
            assert ec.count_same_letters(r, t) == jec.count_same_letters(r, t)
        assert (ec.image_to_text_accuracy(texts, noisy, level)
                == jec.image_to_text_accuracy(texts, noisy, level))


def test_fit_diag_gmm_is_bit_equal_to_jax():
    x = np.random.default_rng(1).standard_normal((300, 6)) * [1, 2, 3, 1, 1, 0.5]
    for C, seed in ((16, 0), (4, 3), (500, 1)):
        got = infer._fit_diag_gmm(x, C, iters=20, seed=seed)
        want = jinfer._fit_diag_gmm(x, C, iters=20, seed=seed)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and np.array_equal(g, w)


@pytest.mark.parametrize("stdev", [False, True], ids=["single", "over-seeds"])
def test_print_save_stats_writes_the_jax_bytes(tmp_path, capsys, stdev):
    stats = {k: {"value": 100 * v, "stdev": 3.14159 * v if stdev else None}
             for k, v in zip(ec.STATS_KEYS, np.random.default_rng(2).random(12))}
    stats["Judge Accuracy Real"]["value"] = float("nan")
    printed = []
    for mod, name in ((utils, "port"), (jutils, "jax")):
        os.makedirs(tmp_path / name)
        mod.print_save_stats(stats, str(tmp_path / name), "cdspritesplus", 3)
        printed.append(capsys.readouterr().out.replace(name, ""))
    port, jax_bytes = ((tmp_path / n / "cdspritesplus_stats.txt").read_bytes()
                       for n in ("port", "jax"))
    assert port == jax_bytes and printed[0] == printed[1]


def test_aggregate_from_files_matches_jax(tmp_path, capsys):
    rng = np.random.default_rng(3)
    for name in ("port", "jax"):
        for seed in ("version_0", "version_1", "version_2", "empty"):
            os.makedirs(tmp_path / name / seed)
    for seed in ("version_0", "version_1", "version_2"):
        stats = {k: {"value": 100 * rng.random(), "stdev": None} for k in ec.STATS_KEYS}
        utils.print_save_stats(stats, str(tmp_path / "port" / seed), "cdspritesplus")
        shutil.copy(tmp_path / "port" / seed / "cdspritesplus_stats.txt",
                    tmp_path / "jax" / seed / "cdspritesplus_stats.txt")
    got = ec.aggregate_from_files(str(tmp_path / "port"), 2)
    want = jec.aggregate_from_files(str(tmp_path / "jax"), 2)
    assert got == want and list(got) == list(ec.STATS_KEYS)
    assert ((tmp_path / "port" / "cdspritesplus_stats.txt").read_bytes()
            == (tmp_path / "jax" / "cdspritesplus_stats.txt").read_bytes())
    with pytest.raises(FileNotFoundError):
        ec.aggregate_from_files(str(tmp_path / "port" / "empty"))
    capsys.readouterr()


@pytest.mark.parametrize("test_file", [True, False], ids=["test-split", "val-fallback"])
def test_get_test_samples_picks_the_jax_rows_and_labels(run, test_file):
    params = cdsprites_params(run.level, test_split=0.25) if test_file else run.params
    dm, jdm = DataModule(Config(params)), JDataModule(JConfig(params))
    dm.setup()
    jdm.setup()
    for n, split, seed in ((10, "test", 0), (1000, "test", 0), (7, "val", 3), (5, "train", 1)):
        batch, labels = infer.MultimodalVAEInfer.get_test_samples(
            types.SimpleNamespace(datamod=dm), n, split, seed)
        jbatch, jlabels = jinfer.MultimodalVAEInfer.get_test_samples(
            types.SimpleNamespace(datamod=jdm), n, split, seed)
        assert np.array_equal(labels, jlabels)
        for name in ("mod_1", "mod_2"):
            for k in ("data", "masks"):
                a, b = batch[name][k], jbatch[name][k]
                assert (a is None) == (b is None) and (a is None or np.array_equal(a, b))
    assert len(labels) == 5
    capped = infer.MultimodalVAEInfer.get_test_samples(types.SimpleNamespace(datamod=dm), 1000)
    assert len(capped[1]) == (24 if test_file else JOINT_N)


def test_sample_pz_with_the_jax_draw(run):
    key = jax.random.PRNGKey(5)
    want = run.jmodel.apply(run.jparams, key, 9, 0.7,
                            method=lambda m, k, n, t: m.sample_pz(k, n, t))
    eps = torch.from_numpy(np.asarray(jax.random.normal(key, (1, 9, N_LATENTS))))
    with torch.no_grad():
        got = run.pexp.model.sample_pz(9, 0.7, eps=eps)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    drawn = run.pexp.model.sample_pz(9, generator=torch.Generator().manual_seed(0))
    assert drawn.shape == (1, 9, N_LATENTS)
    with pytest.raises(ValueError, match="eps has shape"):
        run.pexp.model.sample_pz(9, eps=eps[:, :3])


def test_cnn_classifier_from_bridged_flax_params(run):
    """The judge (one head; the fixture's, bridged) and a four-head judge
    from flax's init: logits and accuracy as the flax module's."""
    x = run.pexp.get_test_samples(JOINT_N)[0]["mod_1"]["data"]   # the shapes the eval ran
    for heads, params in ((0, run.jjudge), (4, None)):
        jmodel = jclassifiers.CNNClassifier(num_classes=3, heads=heads)
        if params is None:
            params = jmodel.init(jax.random.PRNGKey(1), jnp.zeros((1, 64, 64, 3)))
        model = classifiers.CNNClassifier(3, heads=heads)
        bridge.load_flax_params(model, jax.tree_util.tree_map(np.asarray, params))
        with torch.no_grad():
            got = model(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, np.asarray(jmodel.apply(params, x)), rtol=1e-5,
                                   atol=1e-5)
        labels = np.random.default_rng(5).integers(0, 3, (len(x), heads) if heads else len(x))
        assert (classifiers.classifier_accuracy(model, x, labels)
                == jclassifiers.classifier_accuracy(jmodel, params, x, labels))


def test_digit_classifiers_train_one_judge_per_modality(tmp_path):
    rng = np.random.default_rng(6)
    data = [rng.random((40, 28, 28, 1)).astype(np.float32),
            rng.random((40, 32, 32, 3)).astype(np.float32)]
    dm = types.SimpleNamespace(split_arrays=lambda i, split: (data[i], None),
                               labels_train=list(rng.integers(0, 10, 40)))
    mods = [types.SimpleNamespace(name="mod_1", mod_type="mnist", feature_dims=[28, 28, 1]),
            types.SimpleNamespace(name="mod_2", mod_type="svhn", feature_dims=[32, 32, 3])]
    exp = types.SimpleNamespace(mod_names=("mod_1", "mod_2"), datamod=dm, device=torch.device("cpu"),
                                config=types.SimpleNamespace(mods=mods))
    judges = classifiers.digit_classifiers(exp, str(tmp_path), "mnist_svhn", epochs=1)
    assert sorted(os.listdir(tmp_path)) == ["mnist_svhn_digit_mod_1_v2.pt",
                                            "mnist_svhn_digit_mod_2_v2.pt"]
    for name, x in zip(exp.mod_names, data):
        assert classifiers.predict(judges[name], x).shape == (40,)
    assert (classifiers.mods_by_type(exp) == jclassifiers.mods_by_type(exp)
            == {"mnist": "mod_1", "svhn": "mod_2"})


def test_train_classifier_one_epoch_matches_optax_adam(run):
    """The port's training of the judge against the JAX package's of the
    fixture, from the same init (flax's, bridged) over the same 60 rows."""
    images, y = run.adam_data
    jmodel = jclassifiers.CNNClassifier(num_classes=3)
    init = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    model = classifiers.CNNClassifier(3)
    bridge.load_flax_params(model, jax.tree_util.tree_map(np.asarray, init))
    before = model.Dense_1.bias.detach().clone()
    classifiers.train_classifier(model, images, y, epochs=1, batch_size=20)
    assert not torch.equal(model.Dense_1.bias, before)
    want = classifiers.CNNClassifier(3)
    bridge.load_flax_params(want, jax.tree_util.tree_map(np.asarray, run.jadam))
    steps = 3
    for (name, p), w in zip(model.named_parameters(), want.parameters()):
        diff = (p - w).detach().abs()
        assert diff.max().item() <= 2 * 1e-3 * steps, name
        share = (diff <= JUDGE_REL * w.abs().max()).float().mean().item()
        assert share >= JUDGE_SHARE, f"{name}: {share:.6f} of the weights within {JUDGE_REL}"
    assert np.array_equal(classifiers.predict(model, images),
                          jclassifiers.predict(jmodel, run.jadam, images))


@pytest.mark.parametrize("source", ["prior", "expost", "fitted"])
def test_joint_generate_with_the_jax_draws(run, source):
    """The decode of each source's draws, the mixtures read from the same
    cached components (the fit itself: test_fitted_prior_...)."""
    exp = _fresh_infer(run)
    exp._expost_cache, exp._fitted_cache = run.jexp._expost_cache, run.jexp._fitted_cache
    idx, eps = _jax_draws(3, source, JOINT_N, N_LATENTS, len(exp._expost_cache[0]),
                          exp._fitted_cache[2])
    got = exp.joint_generate(JOINT_N, seed=3, source=source, temperature=0.8, idx=idx, eps=eps)
    want = run.jexp.joint_generate(JOINT_N, seed=3, source=source, temperature=0.8)
    for name in ("mod_1", "mod_2"):
        np.testing.assert_allclose(got[name], want[name], **DECODE_TOL, err_msg=name)
    drawn = exp.joint_generate(5, seed=3, source=source)
    assert drawn["mod_1"].shape == (5, 64, 64, 3) and drawn["mod_2"].shape == (5, 45, 27)
    again = exp.joint_generate(5, seed=3, source=source)
    assert all(np.array_equal(drawn[n], again[n]) for n in drawn)


def test_expost_and_fitted_prior_match_jax(run):
    exp = _fresh_infer(run)
    loc, scale = exp._expost_prior()
    jloc, jscale = run.jexp._expost_cache
    assert loc.shape == jloc.shape == (3 * 64, N_LATENTS)   # 191 rows, the last batch padded
    np.testing.assert_allclose(loc, jloc, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(scale, jscale, rtol=1e-4, atol=1e-6)
    assert exp._expost_prior() is exp._expost_cache
    exp._expost_cache = run.jexp._expost_cache
    for g, w in zip(exp._fitted_prior(), run.jexp._fitted_cache):
        assert np.array_equal(g, w)
    with pytest.raises(ValueError, match="source"):
        exp.joint_generate(4, source="posterior")


def test_trainer_test_writes_the_stats_and_restores_k(run, tmp_path, monkeypatch):
    monkeypatch.setenv("CDSPRITES_CLASSIFIER_DIR", str(run.root / "pclf"))
    monkeypatch.setenv("CDSPRITES_EVAL_SAMPLES", "12")
    monkeypatch.setitem(sys.modules, NO_TB, None)
    trainer = Trainer(Config(dict(run.params, K=3), results_root=str(tmp_path)),
                      device="cpu", enable_viz=False).init_state()
    stats = trainer.test()
    assert trainer.model.K == 3
    assert "eval_error" not in stats and set(ec.STATS_KEYS) <= set(stats)
    assert "val_loss" in stats
    with open(os.path.join(trainer.cfg.mPath, "cdspritesplus_stats.txt")) as f:
        assert [line.split(":")[0] for line in f] == list(ec.STATS_KEYS)
    assert CDSPRITESPLUS(None, None, "image").eval_statistics_fn() is ec.cdsprites_eval

    def broken(trainer_or_infer):
        with ec._as_infer(trainer_or_infer) as exp:
            assert exp.model.K == 1
            raise RuntimeError("no judge")

    monkeypatch.setattr(CDSPRITESPLUS, "eval_statistics_fn", lambda self: broken)
    stats = trainer.test()
    assert stats["eval_error"] == "RuntimeError: no judge" and trainer.model.K == 3


def test_epoch_visualizations_write_the_jax_files(run, tmp_path, monkeypatch):
    """The port's epoch visualizations write the files the JAX package's
    write (its names, from its traversal ranges) and, as it does, skip the
    t-SNE plot where sklearn does not import; the text tiles and grids are
    drawn byte for byte as the JAX package draws them.  (The JAX package's
    own run of them takes most of a minute here, compiling op by op.)"""
    monkeypatch.setitem(sys.modules, "sklearn", None)     # import sklearn raises
    exp = _fresh_infer(run)
    cfg = types.SimpleNamespace(get_vis_dir=lambda: str(tmp_path))
    viz.epoch_visualizations(types.SimpleNamespace(cfg=cfg, model=exp.model,
                                                   datamodule=exp.datamod), 4)
    names = exp.mod_names
    want = ({f"recon_from_{'_'.join(p)}.png" for p in [(n,) for n in names] + [names]}
            | {f"traversals_{n}_pm{r}.png" for n in names for r in jviz.TRAVERSAL_RANGES}
            | {f"{kind}_{n}.png" for n in names for kind in ("joint_samples", "kl_dims")})
    assert set(os.listdir(tmp_path / "epoch_4")) == want
    texts = ["square", "big red heart at top left on dark" * 2, ""]
    tiles = viz.turn_text2image(texts, (64, 70, 3))
    assert np.array_equal(tiles, jviz.turn_text2image(texts, (64, 70, 3)))
    ds = exp.datamod.datasets[0]
    rows = [viz._to_tiles(ds, tiles, ds.text2img_size), np.zeros((3, 30, 40, 3), np.uint8)]
    viz.save_grid(rows, str(tmp_path / "port.png"))
    jviz.save_grid(rows, str(tmp_path / "jax.png"))
    assert (tmp_path / "port.png").read_bytes() == (tmp_path / "jax.png").read_bytes()


def test_cached_judge_is_loaded_and_a_corrupt_cache_is_trained_again(run, tmp_path, capsys,
                                                                     monkeypatch):
    exp = _fresh_infer(run)
    cache = tmp_path / "cdspritesplus_classifier_level1_shape_v2.pt"
    shutil.copy(run.root / "pclf" / cache.name, cache)
    monkeypatch.setenv("CDSPRITES_CLASSIFIER_DIR", str(tmp_path))
    judges = ec.get_all_classifiers(exp, 1)
    for a, b in zip(judges["shape"].parameters(), run.judge.parameters()):
        assert torch.equal(a, b)
    cache.write_bytes(b"truncated")
    images, texts = exp.datamod.split_arrays(0, "train")[0], exp.datamod.labels_train
    judge = classifiers.get_or_train_classifier(
        str(cache), classifiers.CNNClassifier(3),
        lambda: (images[:40], np.array([ec.CLASS_MAPPINGS["shape"].index(t)
                                        for t in texts[:40]])), epochs=1)
    assert "discarding unreadable cache" in capsys.readouterr().out
    reloaded = classifiers.load_classifier(classifiers.CNNClassifier(3, seed=5), str(cache))
    for a, b in zip(judge.parameters(), reloaded.parameters()):
        assert torch.equal(a, b)
    with pytest.raises(FileNotFoundError):   # SPRITES is ported: it reads the shards
        train_classifiers.main(["--dataset", "sprites", "--path", str(tmp_path / "none"),
                                "--device", "cpu"])


def test_train_classifiers_cli_saves_the_evals_judges(run, tmp_path):
    path = os.path.join(run.level, "traindata.h5")
    accs = train_classifiers.train_cdsprites(path, 1, str(tmp_path), device="cpu")
    assert set(accs) == {"shape"} and 0 <= accs["shape"] <= 1
    saved = tmp_path / "cdspritesplus_classifier_level1_shape_v2.pt"
    assert saved.is_file() and not list(tmp_path.glob("*.tmp"))
