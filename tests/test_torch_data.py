"""The port's config and data layer against the JAX package, on the CPU.

``Config`` on the shipped CdSprites+ configs, the CdSprites+ generator from
one seed, the ``DataModule``'s split, labels and batches (the padded tail
included), the loaders, and the native host kernels with and without their
library: the port keeps its own copies of these modules, and each must
give what the JAX package's gives, bit for bit.
"""
import dataclasses
import glob
import os
import pickle
from pathlib import Path

import numpy as np
import pytest
import torch

from multimodal_vae_comparison_tpu.config import Config as JConfig
from multimodal_vae_comparison_tpu.data import datasets as jdatasets
from multimodal_vae_comparison_tpu.data import native as jnative
from multimodal_vae_comparison_tpu.data.datamodule import DataModule as JDataModule
from multimodal_vae_comparison_tpu.data_proc import cdsprites as jcdsprites
from multimodal_vae_comparison_tpu_torch.config import Config
from multimodal_vae_comparison_tpu_torch.data import datasets, native
from multimodal_vae_comparison_tpu_torch.data.datamodule import DataModule, prefetch_to_device
from multimodal_vae_comparison_tpu_torch.data_proc import cdsprites
from multimodal_vae_comparison_tpu_torch.eval.eval_cdsprites import cdsprites_eval

REPO = Path(__file__).resolve().parents[1]
CONFIGS = sorted(glob.glob(str(REPO / "configs" / "round5" / "*.yml"))) + [
    str(REPO / "configs" / "config_cdspritesplus.yml")]


def _read_h5(path):
    import h5py
    with h5py.File(path, "r") as f:
        return {k: np.asarray(f[k]) for k in f.keys()}


@pytest.fixture(scope="module")
def level1(tmp_path_factory):
    """CdSprites+ level 1 at count 54: 54 train rows, 3 test rows."""
    out = tmp_path_factory.mktemp("cdsprites")
    return cdsprites.generate_level(1, 54, str(out), seed=0)


def cdsprites_params(level_dir, **over):
    params = {"batch_size": 8, "epochs": 1, "exp_name": "t", "lr": 1e-3, "n_latents": 16,
              "mixing": "poe", "obj": "elbo", "seed": 3, "test_split": 0.25,
              "dataset_name": "cdspritesplus", "labels": None}
    for i, (mod_type, enc) in enumerate((("image", "CNN2"), ("text", "TxtTransformer"))):
        params[f"modality_{i + 1}"] = {
            "encoder": enc, "decoder": "CNN" if mod_type == "image" else enc,
            "mod_type": mod_type, "recon_loss": "bce" if mod_type == "image" else "category_ce",
            "path": os.path.join(level_dir, "traindata.h5"),
            "test_datapath": os.path.join(level_dir, "testdata.h5")}
    params.update(over)
    return params


def _config_attrs(cfg):
    attrs = {k: v for k, v in vars(cfg).items() if k not in ("mods", "mPath", "results_root")}
    mods = [dict(dataclasses.asdict(m), name=m.name, extra=m.extra) for m in cfg.mods]
    return attrs, mods


# -- config ---------------------------------------------------------------------


@pytest.mark.parametrize("path", CONFIGS, ids=[os.path.basename(p) for p in CONFIGS])
def test_config_parses_to_the_jax_configs_attributes(path):
    got, want = Config(path, eval_only=True), JConfig(path, eval_only=True)
    assert _config_attrs(got) == _config_attrs(want)
    assert got.mPath is None and got.num_mods == len(want.mods) >= 2


def test_config_overrides_run_dir_and_dump_match_jax(tmp_path, level1):
    over = {"epochs": 7, "lr": 0.5, "K": 4, "nonexistent": 3, "cfg": "x", "seed": None}
    got = Config(cdsprites_params(level1), overrides=over, results_root=str(tmp_path / "p"))
    want = JConfig(cdsprites_params(level1), overrides=over, results_root=str(tmp_path / "j"))
    assert _config_attrs(got) == _config_attrs(want)
    assert (got.epochs, got.lr, got.K, got.seed) == (7, 0.5, 4, 3)
    assert not hasattr(got, "nonexistent")
    assert got.mPath == str(tmp_path / "p" / "t" / "version_0")
    assert os.path.isdir(os.path.join(got.mPath, "visuals"))
    assert Config(cdsprites_params(level1), results_root=str(tmp_path / "p")).mPath.endswith(
        "version_1")
    again = Config(got.mPath, eval_only=True)   # a run dir reads its config.yml
    assert again.params == got.params == JConfig(want.mPath, eval_only=True).params
    got.change_seed(9)
    assert got.seed == 9 and got.params["seed"] == 9
    with pytest.raises(ValueError, match="n_latents"):
        Config({k: v for k, v in cdsprites_params(level1).items() if k != "n_latents"},
               eval_only=True)
    with pytest.raises(ValueError, match="modality"):
        Config({"batch_size": 1, "epochs": 1, "lr": 1, "n_latents": 2}, eval_only=True)


@pytest.mark.parametrize("path", ["configs/round5/cdl1_r5_poe.yml",
                                  "configs/config_cdspritesplus.yml"])
def test_chip_smokes_from_config_reads_a_shipped_config_with_the_data_paths_replaced(
        tmp_path, level1, path):
    import sys

    import yaml
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    cfg = chip_smoke.from_config(path, level1, ".h5", str(tmp_path), epochs=2, iterseeds=1)
    with open(REPO / path) as f:
        want = yaml.safe_load(f)
    want.update(epochs=2, iterseeds=1)
    for key in [k for k in want if k.startswith("modality_")]:
        want[key].update(path=os.path.join(level1, "traindata.h5"),
                         test_datapath=os.path.join(level1, "testdata.h5"))
    assert cfg.params == want and cfg.mPath.startswith(str(tmp_path))
    with open(os.path.join(cfg.mPath, "config.yml")) as f:
        assert yaml.safe_load(f) == want


# -- the generator ------------------------------------------------------------------


@pytest.mark.parametrize("level", [1, 2, 3, 4, 5])
def test_generator_writes_the_jax_generators_arrays(tmp_path, level):
    got = cdsprites.generate_level(level, 60, str(tmp_path / "port"), seed=4)
    want = jcdsprites.generate_level(level, 60, str(tmp_path / "jax"), seed=4)
    for split in ("traindata", "testdata"):
        a, b = _read_h5(os.path.join(got, f"{split}.h5")), _read_h5(os.path.join(want, f"{split}.h5"))
        assert sorted(a) == sorted(b) == ["image", "text"]
        assert a["image"].dtype == np.uint8 and a["image"].shape[1:] == (64, 64, 3)
        np.testing.assert_array_equal(a["image"], b["image"])
        np.testing.assert_array_equal(a["text"], b["text"])


@pytest.mark.parametrize("level", [1, 3])
def test_generator_pkl_holds_the_arrays_of_its_h5(tmp_path, level):
    h5 = cdsprites.generate_level(level, 30, str(tmp_path / "h5"), seed=2)
    pkl = cdsprites.generate_level(level, 30, str(tmp_path / "pkl"), seed=2, fmt="pkl")
    for split in ("traindata", "testdata"):
        want = _read_h5(os.path.join(h5, f"{split}.h5"))
        got = datasets.load_data(os.path.join(pkl, f"{split}.pkl"))
        assert sorted(got) == ["image", "text"]
        np.testing.assert_array_equal(got["image"], want["image"])
        np.testing.assert_array_equal(got["text"], want["text"])
    with pytest.raises(ValueError, match="fmt"):
        cdsprites.generate_level(level, 30, str(tmp_path / "x"), fmt="npz")


def test_generator_cli_writes_one_level(tmp_path, monkeypatch):
    monkeypatch.setattr("sys.argv", ["cdsprites", "--level", "2", "--count", "12",
                                     "--out_dir", str(tmp_path), "--seed", "1"])
    cdsprites.main()
    data = _read_h5(tmp_path / "level2" / "traindata.h5")
    assert data["image"].shape == (12, 64, 64, 3)
    assert {t.decode().split(" ")[0] for t in data["text"]} <= set(cdsprites.SIZES)
    monkeypatch.setattr("sys.argv", ["cdsprites", "--level", "2", "--count", "12",
                                     "--out_dir", str(tmp_path / "pkl"), "--seed", "1",
                                     "--format", "pkl"])
    cdsprites.main()
    got = datasets.load_data(str(tmp_path / "pkl" / "level2" / "traindata.pkl"))
    np.testing.assert_array_equal(got["image"], data["image"])


def test_make_sample_matches_jax():
    for seed in range(3):
        a = cdsprites.make_sample(np.random.default_rng(seed), 5)
        b = jcdsprites.make_sample(np.random.default_rng(seed), 5)
        np.testing.assert_array_equal(a[0], b[0])
        assert a[1] == b[1]


# -- the DataModule ------------------------------------------------------------------


def _assert_batches_equal(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for name in w:
            for key in ("data", "masks"):
                if w[name][key] is None:
                    assert g[name][key] is None
                else:
                    assert g[name][key].dtype == w[name][key].dtype
                    np.testing.assert_array_equal(g[name][key], w[name][key])


@pytest.mark.parametrize("test_split", [0.25, 0.1])
def test_datamodule_split_labels_and_batches_are_the_jaxs(level1, test_split):
    params = cdsprites_params(level1, test_split=test_split)
    got = DataModule(Config(params, eval_only=True))
    want = JDataModule(JConfig(params, eval_only=True))
    got.setup()
    want.setup()
    assert (got.n_train, got.n_val) == (want.n_train, want.n_val)
    assert got.feature_dims() == want.feature_dims() == [[64, 64, 3], [45, 27]]
    for part in ("_train", "_val", "_test"):
        for g, w in zip(getattr(got, part), getattr(want, part)):
            np.testing.assert_array_equal(g["data"], w["data"])
            if w["masks"] is None:
                assert g["masks"] is None
            else:
                np.testing.assert_array_equal(g["masks"], w["masks"])
    assert got.labels_train == want.labels_train
    assert got.labels_val == want.labels_val
    assert got.labels_test == want.labels_test
    assert got.steps_per_epoch() == want.steps_per_epoch()
    _assert_batches_equal(got.batches("train", shuffle=True, seed=300012),
                          want.batches("train", shuffle=True, seed=300012))
    # the padded tail of eval, and a batch larger than the split (tiled pad)
    _assert_batches_equal(got.batches("val", drop_remainder=False),
                          want.batches("val", drop_remainder=False))
    _assert_batches_equal(got.batches("test", batch_size=7, drop_remainder=False),
                          want.batches("test", batch_size=7, drop_remainder=False))
    _assert_batches_equal(got.batches("val", batch_size=64, drop_remainder=False),
                          want.batches("val", batch_size=64, drop_remainder=False))
    for i in range(2):
        for split in ("train", "val"):
            for g, w in zip(got.split_arrays(i, split), want.split_arrays(i, split)):
                np.testing.assert_array_equal(g, w)


def test_datamodule_refuses_modalities_of_different_lengths(tmp_path, level1):
    import h5py
    short = tmp_path / "short.h5"
    data = _read_h5(os.path.join(level1, "traindata.h5"))
    with h5py.File(short, "w") as f:
        f.create_dataset("image", data=data["image"][:10])
        f.create_dataset("text", data=data["text"][:10])
    params = cdsprites_params(level1)
    params["modality_2"]["path"] = str(short)
    with pytest.raises(ValueError, match="disagree on sample count"):
        DataModule(Config(params, eval_only=True)).setup()


def test_prefetch_to_device_on_the_cpu_gives_the_batches_as_tensors(level1):
    dm = DataModule(Config(cdsprites_params(level1), eval_only=True))
    batches = list(dm.batches("train"))
    got = list(prefetch_to_device(iter(batches), "cpu", size=3))
    assert len(got) == len(batches)
    for g, w in zip(got, batches):
        for name in w:
            for key in ("data", "masks"):
                assert torch.is_tensor(g[name][key]) or w[name][key] is None
                if w[name][key] is not None:
                    np.testing.assert_array_equal(g[name][key].numpy(), w[name][key])
        assert g["mod_1"]["masks"] is None and g["mod_2"]["masks"].dtype == torch.bool


# -- datasets and loaders --------------------------------------------------------------


@pytest.mark.parametrize("suffix", [".pkl", ".npy", ".pt", ".h5", "dir"])
def test_load_data_reads_each_format_as_jax_does(tmp_path, suffix):
    rng = np.random.default_rng(0)
    arr = rng.integers(0, 256, (3, 8, 8, 3), dtype=np.uint8)
    path = tmp_path / f"d{suffix}"
    if suffix == ".pkl":
        path.write_bytes(pickle.dumps({"image": arr}))
    elif suffix == ".npy":
        np.save(path, arr)
    elif suffix == ".pt":
        torch.save(torch.from_numpy(arr), path)
    elif suffix == ".h5":
        import h5py
        with h5py.File(path, "w") as f:
            f.create_dataset("image", data=arr)
    else:
        import cv2
        path.mkdir()
        for i, img in enumerate(arr):
            cv2.imwrite(str(path / f"{i}.png"), img)
    got, want = datasets.load_data(str(path)), jdatasets.load_data(str(path))
    unwrap = (lambda d: np.asarray(d["image"] if isinstance(d, dict) else d))
    np.testing.assert_array_equal(unwrap(got), unwrap(want))
    with pytest.raises(FileNotFoundError):
        datasets.load_data(str(tmp_path / "missing.h5"))


def test_cdsprites_dataset_loads_and_decodes_as_jax(level1):
    path = os.path.join(level1, "traindata.h5")
    for mod_type in ("image", "text"):
        got = datasets.CDSPRITESPLUS(path, None, mod_type)
        want = jdatasets.CDSPRITESPLUS(path, None, mod_type)
        (gd, gm), (wd, wm) = got.get_data("train"), want.get_data("train")
        np.testing.assert_array_equal(gd, wd)
        assert (gm is None) == (wm is None)
        if wm is not None:
            np.testing.assert_array_equal(gm, wm)
        assert got.labels() == want.labels()
        assert got.text2img_size == want.text2img_size == (64, 70, 3)
        out, ref = got.decode_output(gd[:2], gm[:2] if gm is not None else None), \
            want.decode_output(wd[:2], wm[:2] if wm is not None else None)
        assert np.array_equal(out, ref) if mod_type == "image" else out == ref
    assert got.eval_statistics_fn() is cdsprites_eval   # the port's benchmark


def test_unported_and_unknown_datasets_raise():
    for name in ("cub", "mnist_svhn", "sprites", "celeba", "fashionmnist", "polymnist",
                 "vilanro", "synthetic"):
        assert name in jdatasets.DATASETS
        with pytest.raises(NotImplementedError, match="Queue A item 7"):
            datasets.get_dataset_class(name)
    assert datasets.get_dataset_class("CdSpritesPlus") is datasets.CDSPRITESPLUS
    with pytest.raises(KeyError):
        datasets.get_dataset_class("imagenet")


# -- native host kernels ------------------------------------------------------------------


@pytest.mark.parametrize("with_library", [True, False], ids=["library", "numpy"])
def test_native_kernels_match_jaxs_with_and_without_the_library(monkeypatch, with_library):
    if not with_library:
        monkeypatch.setattr(native, "_lib", False)
        monkeypatch.setattr(jnative, "_lib", False)
    assert native.available() == jnative.available() == with_library
    rng = np.random.default_rng(1)
    idx = rng.integers(0, 40, 25)
    for src in (rng.normal(size=(40, 7, 3)).astype(np.float32), rng.random((40, 12)) > 0.5,
                rng.integers(0, 256, (40, 8, 8, 3), dtype=np.uint8),
                rng.integers(0, 9, (40, 5))):
        got = native.gather(src, idx)
        assert got.dtype == src.dtype
        np.testing.assert_array_equal(got, jnative.gather(src, idx))
        np.testing.assert_array_equal(got, src[idx])
    img = rng.integers(0, 256, (40, 8, 8, 3), dtype=np.uint8)
    np.testing.assert_array_equal(native.gather_normalize(img, idx),
                                  jnative.gather_normalize(img, idx))
    texts = ["big red square", "Small HEART", "x" * 60, "", "at top-left!"]
    for got, want in zip(native.one_hot_text(texts, 45), jnative.one_hot_text(texts, 45)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    with pytest.raises(IndexError):
        native.gather(img, np.array([0, 40]))
    with pytest.raises(IndexError):
        native.gather_normalize(img, np.array([-1]))


def test_native_library_builds_outside_the_source_tree():
    assert native.available()
    path = native.library_path()
    assert path.exists() and path.parent == native.BUILD_DIR
    assert path.name.startswith("libmmvae_io_") and path.suffix == ".so"


def test_native_library_builds_serial_where_the_compiler_has_no_openmp(tmp_path, monkeypatch,
                                                                        capsys):
    """A compiler without OpenMP's runtime refuses -fopenmp: the library is
    built without it and gives the same results."""
    import shutil
    fake = tmp_path / "cxx"
    fake.write_text("#!/bin/sh\nfor a in \"$@\"; do [ \"$a\" = -fopenmp ] && "
                    "{ echo 'cannot read spec file libgomp.spec' >&2; exit 1; }; done\n"
                    f"exec {shutil.which('g++')} \"$@\"\n")
    fake.chmod(0o755)
    monkeypatch.setenv("CXX", str(fake))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    assert native.available()
    assert "without OpenMP" in capsys.readouterr().err
    rng = np.random.default_rng(2)
    src, idx = rng.normal(size=(30, 4)).astype(np.float32), rng.integers(0, 30, 9)
    np.testing.assert_array_equal(native.gather(src, idx), src[idx])
    monkeypatch.setenv("CXX", str(tmp_path / "missing"))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build2")
    monkeypatch.setattr(native, "_lib", None)
    assert not native.available()
    assert "falls back to numpy" in capsys.readouterr().err
