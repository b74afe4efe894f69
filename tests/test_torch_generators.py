"""The GeBiD generator and the grid-config generator of the port against the
JAX package's, on the CPU: from the same seed and arguments, the same
``attrs.pkl``, images and ``.h5`` pair at every GeBiD level, and the same
numbered YAML files from the same grid."""
import os
import pickle
import sys

import cv2
import h5py
import numpy as np
import pytest
import yaml

from multimodal_vae_comparison_tpu.data_proc import gebid as jgebid
from multimodal_vae_comparison_tpu.data_proc import generate_configs as jgenerate_configs
from multimodal_vae_comparison_tpu_torch.data_proc import gebid, generate_configs
from test_torch_slice import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tree(d):
    return sorted(os.path.relpath(os.path.join(r, f), d)
                  for r, _, files in os.walk(d) for f in files)


def test_gebid_vocabulary_is_jax_s():
    assert gebid.SHAPES == jgebid.SHAPES and gebid.COLORS == jgebid.COLORS
    assert gebid.SIZES == jgebid.SIZES and gebid.BACKGROUNDS == jgebid.BACKGROUNDS
    assert (gebid.LOCATIONS1, gebid.LOCATIONS2) == (jgebid.LOCATIONS1, jgebid.LOCATIONS2)


@pytest.mark.parametrize("level", [1, 2, 3, 4, 5])
def test_gebid_generate_equals_jax(tmp_path, level):
    """``generate`` at a level, 40 rows (every shape drawn), seed 3: the
    same attrs.pkl, the same PNG files byte for byte (so the same image
    arrays), and with ``write_h5`` the same traindata.h5 / testdata.h5
    arrays."""
    got = gebid.generate(level, 40, str(tmp_path / "port"), seed=3, write_h5=True)
    want = jgebid.generate(level, 40, str(tmp_path / "jax"), seed=3, write_h5=True)
    assert _tree(got) == _tree(want)
    with open(os.path.join(got, "attrs.pkl"), "rb") as a, \
            open(os.path.join(want, "attrs.pkl"), "rb") as b:
        attrs, jattrs = pickle.load(a), pickle.load(b)
    assert len(attrs) == 40 and [list(np.atleast_1d(x)) for x in attrs] == [
        list(np.atleast_1d(x)) for x in jattrs]
    assert set(gebid.SHAPES) <= {w for a in attrs for w in np.atleast_1d(a)}
    for name in _tree(os.path.join(got, "image")):
        with open(os.path.join(got, "image", name), "rb") as a, \
                open(os.path.join(want, "image", name), "rb") as b:
            assert a.read() == b.read(), name
    img = cv2.imread(os.path.join(got, "image", "img_000000.png"))
    assert img.shape == (64, 64, 3)
    for split in ("traindata", "testdata"):
        with h5py.File(os.path.join(got, f"{split}.h5"), "r") as a, \
                h5py.File(os.path.join(want, f"{split}.h5"), "r") as b:
            for key in ("image", "text"):
                np.testing.assert_array_equal(a[key][()], b[key][()])


def test_gebid_cli_writes_the_generator_files(tmp_path, monkeypatch, capsys):
    """``python -m ...data_proc.gebid`` writes what ``generate`` writes."""
    out = str(tmp_path / "cli")
    monkeypatch.setattr(sys, "argv", ["gebid", "--dir", out, "--level", "3", "--size", "12",
                                      "--seed", "1"])
    gebid.main()
    assert "GeBiD level 3: 12 samples" in capsys.readouterr().out
    want = jgebid.generate(3, 12, str(tmp_path / "jax"), seed=1)
    assert _tree(out) == _tree(want)
    for name in _tree(out):
        with open(os.path.join(out, name), "rb") as a, open(os.path.join(want, name), "rb") as b:
            assert a.read() == b.read(), name


GRID_ARGS = ["--mixing", "moe", "poe", "--lr", "1e-4", "5e-4", "--n_latents", "16", "24",
             "--obj", "dreg"]


@pytest.mark.parametrize("base", ["configs/config_cdspritesplus.yml",
                                  "configs/config_celeba.yml"])
def test_generate_configs_writes_jax_s_files(tmp_path, monkeypatch, capsys, base):
    """The grid CLI from the same base config and value lists: the same
    numbered YAML files, byte for byte (2 x 2 x 2 x 1 = 8), each naming its
    point in ``exp_name``."""
    for tag, module in (("port", generate_configs), ("jax", jgenerate_configs)):
        monkeypatch.setattr(sys, "argv", ["generate_configs", "--cfg",
                                          os.path.join(REPO, base), "--path",
                                          str(tmp_path / tag)] + GRID_ARGS)
        module.main()
    assert capsys.readouterr().out.count("wrote 8 configs") == 2
    files = _tree(tmp_path / "port")
    assert files == _tree(tmp_path / "jax") == [f"config_{i}.yml" for i in range(8)]
    for name in files:
        with open(tmp_path / "port" / name) as a, open(tmp_path / "jax" / name) as b:
            assert a.read() == b.read(), name
    with open(tmp_path / "port" / "config_7.yml") as f:
        last = yaml.safe_load(f)
    # YAML 1.1 reads a float only with a dot: "5e-4" stays a string, in
    # both packages
    assert (last["mixing"], last["lr"], last["n_latents"], last["obj"]) == (
        "poe", "5e-4", 24, "dreg")
    assert last["exp_name"].endswith("_mixingpoe_lr5e-4_n_latents24_objdreg")
