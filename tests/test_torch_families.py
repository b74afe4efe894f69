"""CelebA, CUB and the synthetic dataset in the port, against the JAX
package, on the CPU.

The port's copy of the surrogate builders writes the JAX package's files
byte for byte; the ``CELEBA``, ``CUB`` and ``SYNTHETIC`` classes (and the
DataModule over CUB's ``.npy`` images and 246-character ``.pkl`` captions)
give the JAX classes' arrays, masks and labels; the CUB caption grammar's
helpers read what JAX's read; ``celeba_eval`` and ``cub_eval`` compute
JAX's stats, and write its stats file, from the same judges' logits and
the same generations (both packages' judges and generators replaced by one
deterministic numpy function of their inputs); every config of the slice
builds through ``build_model_from_config`` with the parameter tree of the
JAX package's model; and ``configs/config_synthetic.yml`` trains.
"""
import os
import pickle
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
from multimodal_vae_comparison_tpu.data_proc import surrogates as jsurrogates
from multimodal_vae_comparison_tpu.eval import eval_celeba as jceleba
from multimodal_vae_comparison_tpu.eval import eval_cub as jcub
from multimodal_vae_comparison_tpu.eval import fid as jfid
from multimodal_vae_comparison_tpu.eval.infer import MultimodalVAEInfer as JInfer
from multimodal_vae_comparison_tpu.models import perceptual as jperceptual
from multimodal_vae_comparison_tpu.training.trainer import build_model as jbuild_model
from multimodal_vae_comparison_tpu_torch.bridge import load_flax_params
from multimodal_vae_comparison_tpu_torch.config import Config
from multimodal_vae_comparison_tpu_torch.data import datasets
from multimodal_vae_comparison_tpu_torch.data.datamodule import DataModule
from multimodal_vae_comparison_tpu_torch.data.text import encode_text_batch
from multimodal_vae_comparison_tpu_torch.data_proc import surrogates
from multimodal_vae_comparison_tpu_torch.eval import eval_celeba, eval_cub, fid
from multimodal_vae_comparison_tpu_torch.eval.infer import MultimodalVAEInfer
from multimodal_vae_comparison_tpu_torch.models import get_mixing, perceptual
from multimodal_vae_comparison_tpu_torch.training.trainer import (
    Trainer, build_model_from_config)
from test_torch_slice import one_torch_thread  # noqa: F401 (autouse)
from test_torch_weights import torchvision_vgg19_sd

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the slice's eight configs and the feature dims their data gives
CONFIGS = {
    "configs/round4/cdl1_r4_mog.yml": ([64, 64, 3], [45, 27]),
    "configs/round4/cdl2_r4_mog.yml": ([64, 64, 3], [45, 27]),
    "configs/round4/cdl3_r4_mog.yml": ([64, 64, 3], [45, 27]),
    "configs/config_celeba.yml": ([64, 64, 3], [4, 2]),
    "configs/round2/celeba_r2.yml": ([64, 64, 3], [4, 2]),
    "configs/config_cub.yml": ([64, 64, 3], [246, 27]),
    "configs/round2/cub_r2.yml": ([64, 64, 3], [246, 27]),
    "configs/config_synthetic.yml": ([64, 64, 3], [45, 27]),
}


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """Each family built by both packages' builders at a few rows, seed 3:
    {family: (port's directory, JAX's directory)}."""
    root = tmp_path_factory.mktemp("surrogates")
    sizes = {"celeba": (24, 12), "cub": (24, 30)}
    out = {}
    for family, (n_train, n_test) in sizes.items():
        dirs = []
        for tag, module in (("port", surrogates), ("jax", jsurrogates)):
            d = str(root / tag / family)
            getattr(module, f"build_{family}")(d, n_train=n_train, n_test=n_test, seed=3)
            dirs.append(d)
        out[family] = tuple(dirs)
    return out


def _files(d):
    return sorted(os.path.relpath(os.path.join(r, f), d)
                  for r, _, fs in os.walk(d) for f in fs)


@pytest.mark.parametrize("family", ["celeba", "cub"])
def test_surrogates_equal_jax_byte_for_byte(built, family):
    """Images, attributes, captions, labels and SURROGATE.txt: the same
    files with the same bytes from the same seed."""
    port_dir, jax_dir = built[family]
    assert _files(port_dir) == _files(jax_dir)
    assert "SURROGATE.txt" in _files(port_dir)
    for name in _files(port_dir):
        with open(os.path.join(port_dir, name), "rb") as a, \
                open(os.path.join(jax_dir, name), "rb") as b:
            assert a.read() == b.read(), name


@pytest.mark.parametrize("family,second", [("celeba", "test_atts.npy"),
                                           ("cub", "test_captions.pkl")])
def test_surrogate_cli_writes_the_builder_files(tmp_path, capsys, monkeypatch, family,
                                                second):
    """The CLI writes the builder's files at the asked row counts."""
    monkeypatch.setattr("sys.argv", ["surrogates", family, "--out", str(tmp_path / "c"),
                                     "--train", "5", "--test", "2", "--seed", "1"])
    surrogates.main()
    assert f"{family} ->" in capsys.readouterr().out
    assert np.load(tmp_path / "c" / "images.npy").shape == (5, 64, 64, 3)
    assert os.path.exists(tmp_path / "c" / second)
    assert np.load(tmp_path / "c" / "test_images.npy").shape == (2, 64, 64, 3)


def _dataset_pair(name, path, testpath, mod_type):
    return (datasets.get_dataset_class(name)(path, testpath, mod_type),
            jdatasets.get_dataset_class(name)(path, testpath, mod_type))


@pytest.mark.parametrize("family,mods", [
    ("celeba", (("image", "images.npy"), ("atts", "atts.npy"))),
    ("cub", (("image", "images.npy"), ("text", "captions.pkl"))),
    ("synthetic", (("image", "96"), ("text", "96")))])
def test_datasets_give_jax_arrays_masks_and_labels(built, family, mods):
    """Each modality's train and test arrays and masks, its labels, the
    feature dims and the decoded output equal the JAX class's."""
    d = built.get(family, (None,))[0]
    for mod_type, name in mods:
        path = name if d is None else os.path.join(d, name)
        test = None if d is None else os.path.join(d, "test_" + name)
        got, want = _dataset_pair(family, path, test, mod_type)
        for split in ("train", "test"):
            (gd, gm), (wd, wm) = got.get_data(split), want.get_data(split)
            assert gd.dtype == wd.dtype == np.float32
            np.testing.assert_array_equal(gd, wd)
            assert (gm is None) == (wm is None)
            if gm is not None:
                np.testing.assert_array_equal(gm, wm)
            assert got.labels() == want.labels()
        assert got.feature_dims == want.feature_dims
        assert got.text2img_size == want.text2img_size
        out, ref = got.decode_output(gd[:3], None if gm is None else gm[:3]), \
            want.decode_output(wd[:3], None if wm is None else wm[:3])
        assert np.array_equal(out, ref) if mod_type == "image" else out == ref
        fn = got.eval_statistics_fn()
        assert fn is None if family == "synthetic" else fn.__name__ == f"{family}_eval"
    if family == "cub":
        assert gd.shape[1:] == (246, 27) and gm.any(1).all() and not gm.all(1).any()
    if family == "synthetic":
        assert got.eval_statistics_fn() is None and len(gd) == 96


def _cub_params(d, **over):
    with open(os.path.join(REPO, "configs/round2/cub_r2.yml")) as f:
        params = yaml.safe_load(f)
    for i, stem in ((1, "images.npy"), (2, "captions.pkl")):
        params[f"modality_{i}"].update(path=os.path.join(d, stem),
                                       test_datapath=os.path.join(d, "test_" + stem))
    params.update(batch_size=8, **over)
    return params


def test_datamodule_stages_cub_npy_images_and_pkl_captions_as_jax(built, tmp_path):
    """The DataModule over CUB's .npy images and .pkl captions (246
    characters a caption, most of them padding): the same split, batches,
    masks and test split as the JAX DataModule."""
    params = _cub_params(built["cub"][0])
    dm = DataModule(Config(params, results_root=str(tmp_path)))
    jdm = JDataModule(JConfig(params, results_root=str(tmp_path)))
    dm.setup()
    jdm.setup()
    assert dm.feature_dims() == jdm.feature_dims() == [[64, 64, 3], [246, 27]]
    assert (dm.n_train, dm.n_val) == (jdm.n_train, jdm.n_val) == (21, 3)
    for split in ("train", "val"):
        for a, b in zip(dm.batches(split), jdm.batches(split)):
            for name in a:
                np.testing.assert_array_equal(a[name]["data"], np.asarray(b[name]["data"]))
                if a[name]["masks"] is not None:
                    np.testing.assert_array_equal(a[name]["masks"],
                                                  np.asarray(b[name]["masks"]))
    for a, b in zip(dm._test, jdm._test):
        np.testing.assert_array_equal(a["data"], np.asarray(b["data"]))


# -- the CUB grammar ---------------------------------------------------------------------


def test_cub_grammar_helpers_read_what_jax_reads(built):
    """_word_factor on every factor of every builder caption and of captions
    cut or altered, _color_labels and _factor_labels: equal to JAX's."""
    with open(os.path.join(built["cub"][0], "captions.pkl"), "rb") as f:
        caps = pickle.load(f)
    caps = caps + [c.replace("bird", "brid") for c in caps[:6]] + [
        c[: len(c) // 2] for c in caps[6:12]] + ["", "a yellow bird that is white"]
    for c in caps:
        for f in eval_cub.FACTORS:
            assert eval_cub._word_factor(c, f) == jcub._word_factor(c, f), (c, f)
    assert any(eval_cub._word_factor(c, "belly") == "" for c in caps[:24])
    for got, want in zip(eval_cub._color_labels(caps), jcub._color_labels(caps)):
        np.testing.assert_array_equal(got, want)
    got, want = eval_cub._factor_labels(caps), jcub._factor_labels(caps)
    assert list(got) == list(want) == list(eval_cub.FACTORS)
    for f in got:
        for a, b in zip(got[f], want[f]):
            np.testing.assert_array_equal(a, b)


# -- the two benchmarks, on fixed judges and generations -----------------------------------


def _logits(x, heads, num_classes):
    """A deterministic judge: numpy logits of an image batch."""
    x = np.asarray(x, np.float32).reshape(len(x), -1)
    n = max(heads, 1) * num_classes
    out = (x[:, 5:5 + 13 * n:13] - x[:, 7:7 + 13 * n:13]) * 10.0
    return out.reshape(len(x), heads, num_classes) if heads else out


class _PortJudge(torch.nn.Module):
    def __init__(self, num_classes, heads=0, **_):
        super().__init__()
        self.num_classes, self.heads = num_classes, heads
        self.anchor = torch.nn.Parameter(torch.zeros(1))

    def forward(self, x):
        return torch.from_numpy(_logits(x.numpy(), self.heads, self.num_classes))


class _JaxJudge:
    def __init__(self, num_classes, heads=0, **_):
        self.num_classes, self.heads = num_classes, heads

    def apply(self, params, x):
        return jnp.asarray(_logits(np.asarray(x), self.heads, self.num_classes))


def _patch_judges(monkeypatch, module, judge_cls, trained):
    """The eval's CNNClassifier replaced by a fixed judge, and its
    get_or_train_classifier by one that records each judge's training data
    (``trained``) and returns the judge (the JAX package's: and no params)."""
    monkeypatch.setattr(module, "CNNClassifier", judge_cls)
    jax_side = judge_cls is _JaxJudge

    def get_or_train(cache, model, data_fn, **kwargs):
        trained.append((os.path.basename(cache).split(".")[0], data_fn(), kwargs))
        return None if jax_side else model

    monkeypatch.setattr(module, "get_or_train_classifier", get_or_train)


def _fake_exps(tmp_path, mods, train, test, cross, joint):
    """A JAX and a port MultimodalVAEInfer over fixed arrays: the train
    split ``train`` (per modality (data, masks)), test rows ``test``,
    ``cross[source]`` the generation from a source modality, ``joint`` the
    prior's; each records the calls it gets."""
    names = [f"mod_{i + 1}" for i in range(len(mods))]
    config = types.SimpleNamespace(mods=[types.SimpleNamespace(name=n, mod_type=t)
                                         for n, t in zip(names, mods)], mPath=None)
    n_val = len(next(iter(test.values()))["data"])
    datamod = types.SimpleNamespace(n_val=n_val,
                                    split_arrays=lambda i, split="train": train[names[i]])
    exps = []
    for cls, tag in ((JInfer, "jax"), (MultimodalVAEInfer, "port")):
        exp = cls.__new__(cls)
        exp.model = types.SimpleNamespace(mod_names=tuple(names), K=1)
        exp.config, exp.datamod, exp.device = config, datamod, torch.device("cpu")
        exp.run_dir = str(tmp_path / tag)
        os.makedirs(exp.run_dir)
        exp.calls = []

        def get_test_samples(n, split="test", seed=0, exp=exp):
            exp.calls.append(("test", n))
            return {k: {"data": v["data"][:n], "masks": None if v["masks"] is None
                        else v["masks"][:n]} for k, v in test.items()}, None

        def cross_generate(source, data, masks=None, exp=exp):
            exp.calls.append(("cross", source, np.asarray(data).sum()))
            return {k: v[:len(data)] for k, v in cross[source].items()}

        def joint_generate(num, seed=0, exp=exp, **kwargs):
            exp.calls.append(("joint", num, seed))
            return {k: v[:num] for k, v in joint.items()}

        exp.get_test_samples, exp.cross_generate = get_test_samples, cross_generate
        exp.joint_generate = joint_generate
        exps.append(exp)
    return exps


def _assert_same_run(jexp, exp, jstats, stats, jtrained, trained, stats_file, close=()):
    """The same stats (to 1e-12; the keys in ``close``, computed through
    each package's own float32 nets, to 1e-3 relative), calls, judges'
    training data and stats file (its ``close`` lines to the 2 decimals
    written, within that tolerance)."""
    assert list(stats) == list(jstats)
    for k in stats:
        np.testing.assert_allclose(stats[k], jstats[k], rtol=1e-3 if k in close else 1e-12,
                                   err_msg=k)
    assert exp.calls == jexp.calls
    assert len(trained) == len(jtrained)
    for (name, (x, y), kw), (jname, (jx, jy), jkw) in zip(trained, jtrained):
        assert name == jname and kw == jkw
        np.testing.assert_array_equal(x, jx)
        np.testing.assert_array_equal(y, jy)
    with open(os.path.join(exp.run_dir, stats_file)) as a, \
            open(os.path.join(jexp.run_dir, stats_file)) as b:
        lines, jlines = a.read().splitlines(), b.read().splitlines()
    assert len(lines) == len(jlines)
    for line, jline in zip(lines, jlines):
        key, value = line.split(": ")
        jkey, jvalue = jline.split(": ")
        assert key == jkey
        if key in close:
            np.testing.assert_allclose(float(value), float(jvalue),
                                       rtol=1e-3, atol=0.005, err_msg=key)
        else:
            assert value == jvalue, key


def test_celeba_eval_gives_jax_stats(built, tmp_path, monkeypatch):
    """celeba_eval's 6 stats, its judge's training data and its stats file
    against the JAX package's, on one fixed judge and fixed generations
    (each generation a roll of the real rows, so the stats are not 0 or 1)."""
    d = built["celeba"][0]
    imgs = np.load(os.path.join(d, "images.npy")).astype(np.float32) / 255
    atts = datasets.CELEBA(os.path.join(d, "atts.npy"), None, "atts").get_data()[0]
    train = {"mod_1": (imgs[:16], None), "mod_2": (atts[:16], None)}
    test = {"mod_1": {"data": imgs[16:], "masks": None},
            "mod_2": {"data": atts[16:], "masks": None}}
    cross = {"mod_2": {"mod_1": np.roll(imgs[16:], 1, 0), "mod_2": atts[16:]},
             "mod_1": {"mod_1": imgs[16:], "mod_2": np.roll(atts[16:], 2, 0)}}
    joint = {"mod_1": imgs[:8], "mod_2": np.roll(atts[:8], 3, 0)}
    jexp, exp = _fake_exps(tmp_path, ("image", "atts"), train, test, cross, joint)
    jtrained, trained = [], []
    _patch_judges(monkeypatch, jceleba, _JaxJudge, jtrained)
    _patch_judges(monkeypatch, eval_celeba, _PortJudge, trained)
    jstats, stats = jceleba.celeba_eval(jexp), eval_celeba.celeba_eval(exp)
    assert tuple(stats) == eval_celeba.STATS_KEYS
    assert 0 < stats["atts_to_image_mean"] < 1 and 0 < stats["image_to_atts_mean"] < 1
    _assert_same_run(jexp, exp, jstats, stats, jtrained, trained, "celeba_stats.txt")


def test_cub_eval_gives_jax_stats(built, tmp_path, monkeypatch):
    """cub_eval's 14 stats, both judges' training data and the stats file
    against the JAX package's on fixed judges and generations (captions of
    other rows, some cut short so a factor does not parse; other rows'
    images).  Both compute
    ``fid``, the caption-generated images against the real ones, on one
    synthetic vgg19 installed for both packages (``vgg19_pretrained``
    features): within 1e-3 relative, written unscaled; the other 13 as
    before."""
    d = built["cub"][0]
    imgs = np.load(os.path.join(d, "images.npy")).astype(np.float32) / 255
    with open(os.path.join(d, "captions.pkl"), "rb") as f:
        caps = pickle.load(f)
    txt, masks = encode_text_batch(caps, 246)
    gen_caps = [c if i % 4 else c[:20] for i, c in enumerate(np.roll(np.array(caps), 1))]
    gen_txt = encode_text_batch(gen_caps, 246)[0]
    train = {"mod_1": (imgs[:16], None), "mod_2": (txt[:16], masks[:16])}
    test = {"mod_1": {"data": imgs[16:], "masks": None},
            "mod_2": {"data": txt[16:], "masks": masks[16:]}}
    # the caption-generated images: other birds (the first train rows), so
    # the FID against the real rows is not 0
    cross = {"mod_2": {"mod_1": imgs[:8], "mod_2": txt[16:]},
             "mod_1": {"mod_1": imgs[16:], "mod_2": gen_txt[16:]}}
    joint = {"mod_1": imgs[:8], "mod_2": gen_txt[:8]}
    jexp, exp = _fake_exps(tmp_path, ("image", "text"), train, test, cross, joint)
    jtrained, trained = [], []
    _patch_judges(monkeypatch, jcub, _JaxJudge, jtrained)
    _patch_judges(monkeypatch, eval_cub, _PortJudge, trained)

    weights = tmp_path / "weights"
    weights.mkdir()
    np.savez(weights / "vgg19.npz", **torchvision_vgg19_sd(np.random.default_rng(9)))
    monkeypatch.setenv("MVAE_TPU_WEIGHTS_DIR", str(weights))
    perceptual.reset_extractor_cache()
    jperceptual.reset_extractor_cache()
    try:
        assert fid.active_feature_net() == jfid.active_feature_net() == "vgg19_pretrained"
        jstats, stats = jcub.cub_eval(jexp), eval_cub.cub_eval(exp)
    finally:
        perceptual.reset_extractor_cache()
        jperceptual.reset_extractor_cache()
    assert tuple(stats) == eval_cub.STATS_KEYS and stats["fid"] > 0
    assert [t[0] for t in trained] == ["cub_color_clf_v2", "cub_factor_judge_v1"]
    assert 0 < stats["image_to_text_factors"] < 1
    _assert_same_run(jexp, exp, jstats, stats, jtrained, trained, "cub_stats.txt",
                     close=("fid",))


# -- the configs ------------------------------------------------------------------


@pytest.mark.parametrize("path", list(CONFIGS))
def test_build_model_from_config_builds_the_slice_configs(path):
    """Each of the slice's configs builds on the CPU: the JAX package's
    mixing class, K, objective, latents and prior, and a parameter and
    buffer set that the JAX package's model fills leaf for leaf (the three
    pz_mog_* leaves among them where prior_components > 1)."""
    cfg, jcfg = (cls(os.path.join(REPO, path), eval_only=True) for cls in (Config, JConfig))
    for c in (cfg, jcfg):
        for m, dims in zip(c.mods, CONFIGS[path]):
            m.feature_dims = dims
    model = build_model_from_config(cfg, device="cpu")
    jmodel = jbuild_model(jcfg)
    assert type(model) is get_mixing(cfg.mixing)
    assert type(model).__name__ == type(jmodel).__name__
    assert (model.K, model.obj, model.n_latents, model.prior_components) == (
        jmodel.K, jmodel.obj, jmodel.n_latents, jmodel.prior_components)
    assert [s.encoder for s in model.specs] == [s.encoder for s in jmodel.specs]
    assert [s.llik_scaling for s in model.specs] == [s.llik_scaling for s in jmodel.specs]
    if "mog" in path:
        assert model.prior_components == 50 and model.pz_mog_loc.shape == (50, 16)
    batch = {m.name: {"data": jax.ShapeDtypeStruct((2, *m.feature_dims), jnp.float32),
                      "masks": None if m.mod_type != "text"
                      else jax.ShapeDtypeStruct((2, m.feature_dims[0]), jnp.bool_)}
             for m in jcfg.mods}
    shapes = jax.eval_shape(lambda b: jmodel.init(
        {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)}, b,
        method=lambda m, x: m.forward(x, tuple(x))), batch)
    load_flax_params(model, jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes))


def test_config_synthetic_trains_on_the_cpu(tmp_path):
    """``configs/config_synthetic.yml`` as shipped (512 in-memory rows, MOE
    ELBO, CNN2 / CNN images, 45-character captions), one epoch of
    ``Trainer.fit`` on the CPU: the val loss falls; the dataset has no
    benchmark, so ``test()`` is the validation alone."""
    cfg = Config(os.path.join(REPO, "configs/config_synthetic.yml"),
                 results_root=str(tmp_path))
    trainer = Trainer(cfg, device="cpu", enable_viz=False)
    assert (trainer.datamodule.n_train, trainer.datamodule.n_val) == (460, 52)
    trainer.init_state()
    before = trainer.validate(0)["val_loss"]
    metrics = trainer.fit(epochs=1, log_fn=None)
    assert np.isfinite(metrics["train_loss"]) and metrics["val_loss"] < before
    assert sorted(trainer.test()) == sorted(k for k in metrics if k.startswith("val_"))


# -- chip_smoke.py's launch tables and bounds, held on the CPU -------------------------


def _chip_smoke():
    import sys
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    return chip_smoke


def _plain_counts():
    from multimodal_vae_comparison_tpu_torch.ops.kernels import telemetry
    return {k.split(":")[0]: n for k, n in telemetry.summary().items()}


def _config_model(path, over=None):
    cfg = Config(os.path.join(REPO, path), overrides=over, eval_only=True)
    for m, dims in zip(cfg.mods, CONFIGS[path]):
        m.feature_dims = dims
    return cfg, build_model_from_config(cfg, device="cpu")


def _random_batch(cfg, n, seed):
    rng = np.random.default_rng(seed)
    batch = {}
    for m in cfg.mods:
        dims = tuple(m.feature_dims)
        if m.mod_type == "image":
            data = rng.random((n,) + dims).astype(np.float32)
        else:
            data = np.eye(dims[-1], dtype=np.float32)[rng.integers(0, dims[-1], (n,) + dims[:-1])]
        masks = (np.arange(dims[0])[None] < rng.integers(1, dims[0] + 1, (n, 1))
                 if m.mod_type == "text" else None)
        batch[m.name] = {"data": torch.from_numpy(data),
                         "masks": None if masks is None else torch.from_numpy(masks)}
    return batch


@pytest.mark.parametrize("path,key,over", [
    ("configs/round4/cdl1_r4_mog.yml", "dreg", None),
    ("configs/round4/cdl1_r4_mog.yml", "poe_mog", {"mixing": "poe", "obj": "elbo", "K": 1}),
    ("configs/round4/cdl1_r4_mog.yml", "moe_mog", {"obj": "elbo", "K": 1}),
    ("configs/config_celeba.yml", "celeba", None),
    ("configs/round2/celeba_r2.yml", "celeba", None),
    ("configs/config_cub.yml", "moe", None),
    ("configs/round2/cub_r2.yml", "dreg", None),
    ("configs/config_synthetic.yml", "moe", None)],
    ids=["mog-dreg", "mog-poe", "mog-moe-elbo", "celeba", "celeba_r2", "cub", "cub_r2",
         "synthetic"])
def test_chip_smoke_launch_tables_hold_on_the_cpu(path, key, over):
    """chip_smoke.py's FAMILY_PER_OBJECTIVE and FAMILY_PER_BACKWARD: one
    objective call of each config's model at bs 2, then its backward, take
    the kernels' plain versions exactly that many times; the mixture prior
    takes no KL kernel."""
    from multimodal_vae_comparison_tpu_torch.ops.kernels import telemetry
    cs = _chip_smoke()
    cfg, model = _config_model(path, over)
    telemetry.reset()
    loss, _ = model.objective(_random_batch(cfg, 2, 4),
                              generator=torch.Generator().manual_seed(0))
    call = _plain_counts()
    loss.backward()
    backward = {k: n - call.get(k, 0) for k, n in _plain_counts().items()
                if n != call.get(k, 0)}
    assert call == cs.FAMILY_PER_OBJECTIVE[key]
    assert backward == cs.FAMILY_PER_BACKWARD[key]


@pytest.mark.parametrize("family,path", [("celeba", "configs/config_celeba.yml"),
                                         ("cub", "configs/config_cub.yml")])
def test_chip_smoke_eval_launches_hold_on_the_cpu(built, tmp_path, monkeypatch, family, path):
    """chip_smoke.py's FAMILY_EVAL_LAUNCHES: the benchmark over a config's
    model (fixed judges) launches exactly those kernels' plain versions:
    its cross-generations and its prior joint."""
    from multimodal_vae_comparison_tpu_torch.ops.kernels import telemetry
    cs = _chip_smoke()
    module = {"celeba": eval_celeba, "cub": eval_cub}[family]
    _patch_judges(monkeypatch, module, _PortJudge, [])
    cfg, model = _config_model(path)
    model.K = 1
    model.eval()
    rows = {n: {"data": b["data"].numpy(),
                "masks": None if b["masks"] is None else b["masks"].numpy()}
            for n, b in _random_batch(cfg, 6, 5).items()}
    if family == "cub":   # captions that parse
        with open(os.path.join(built["cub"][0], "captions.pkl"), "rb") as f:
            data, masks = encode_text_batch(pickle.load(f)[:6], 246)
        rows["mod_2"] = {"data": data, "masks": masks}
    exp = MultimodalVAEInfer.__new__(MultimodalVAEInfer)
    exp.model, exp.device, exp.config, exp.run_dir = model, torch.device("cpu"), cfg, str(tmp_path)
    exp.datamod = types.SimpleNamespace(
        n_val=6, split_arrays=lambda i, split="train": (rows[f"mod_{i + 1}"]["data"],
                                                        rows[f"mod_{i + 1}"]["masks"]))
    exp.get_test_samples = lambda n, split="test", seed=0: (rows, None)
    telemetry.reset()
    stats = getattr(module, f"{family}_stats")(exp)
    assert tuple(stats) == module.STATS_KEYS
    assert _plain_counts() == cs.FAMILY_EVAL_LAUNCHES[family]


def test_chip_smoke_attention_bound_counts_only_the_needed_keys():
    """chip_smoke.py's attention bound reads K and V and does the products
    only at a row's valid keys (all of them for a fully masked row, whose
    output is the mean of every value row); unmasked, every key counts."""
    cs = _chip_smoke()
    b, h, tq, tk, dh = 3, 2, 8, 10, 4
    lengths = torch.tensor([[0], [4], [10]])
    mask = torch.arange(tk)[None, :] < lengths
    assert cs.attended_keys(tk, mask) == 10 + 4 + 10
    keys = 24
    want_bytes = 4 * (2 * b * h * tq * dh + 2 * h * keys * dh) + b * tk
    want_ops = 4 * h * tq * keys * dh + 4 * h * tq * keys
    assert cs.attention_bound(b, h, tq, tk, dh, mask) == cs.bound_ms(want_bytes, want_ops)
    full = 4 * (2 * b * h * tq * dh + 2 * b * h * tk * dh)
    assert cs.attention_bound(b, h, tq, tk, dh) == cs.bound_ms(
        full, 4 * b * h * tq * tk * dh + 4 * b * h * tq * tk)
    assert cs.attention_bound(b, h, tq, tk, dh, mask)[0] < cs.attention_bound(
        b, h, tq, tk, dh)[0]
