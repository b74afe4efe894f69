"""The port stands alone: no JAX, no JAX package, no card or compiler at
import, and entry points that refuse to drop to the CPU quietly."""
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from multimodal_vae_comparison_tpu_torch.device import resolve_device
from multimodal_vae_comparison_tpu_torch.models import get_mixing
from multimodal_vae_comparison_tpu_torch.models.base import ModalitySpec
from multimodal_vae_comparison_tpu_torch.ops.kernels import _build
from multimodal_vae_comparison_tpu_torch.serving.engine import (
    InferenceEngine, ModelHandle)

REPO = Path(__file__).resolve().parents[1]

_IMPORT_ALL = r"""
import importlib, pkgutil, subprocess, sys

def refuse(*args, **kwargs):
    raise AssertionError("a subprocess was started at import time")

subprocess.Popen = refuse
REQUIRED = {"multimodal_vae_comparison_tpu_torch." + m for m in (
    "bridge", "config", "data.datamodule", "data.datasets", "data.native", "data.text",
    "data_proc.cdsprites", "data_proc.digits", "data_proc.mnistsvhn", "data_proc.polymnist",
    "data_proc.sprites_gen", "data_proc.surrogates", "data_proc.gebid",
    "data_proc.generate_configs",
    "eval.classifiers", "eval.eval_cdsprites", "eval.eval_celeba", "eval.eval_cub",
    "eval.eval_fashionmnist", "eval.eval_mnistsvhn", "eval.eval_polymnist",
    "eval.eval_sprites", "eval.fid", "eval.infer", "eval.weights",
    "eval.vilanro_probe", "eval.vilanro_test",
    "eval.train_classifiers", "eval.cca", "eval.text_embeddings", "lanro", "lanro.arm", "lanro.collect", "lanro.env",
    "lanro.simulation", "main", "models.base", "models.contrib", "models.decoders",
    "models.distributions", "models.encoders", "models.inception", "models.init", "models.mmvae",
    "models.nets", "models.objectives", "models.perceptual", "ops.kernels.attention", "ops.kernels.kl_kernel",
    "ops.kernels.poe_kernel", "ops.kernels.sample_kernel", "ops.kernels.sparse_attention",
    "parallel", "parallel.dryrun", "parallel.launch", "parallel.mesh", "parallel.rows",
    "parallel.tensor_sharding",
    "serving.engine", "serving.server", "training.optim", "training.surgery",
    "training.trainer", "utils",
    "visualization")}
import multimodal_vae_comparison_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(n for n in sys.modules
             if n.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "triton",
                                    "multimodal_vae_comparison_tpu"))
missing = sorted(REQUIRED - set(names))
# the plotting, image and GIF packages load in the functions that draw
optional = sorted(n for n in sys.modules
                  if n.split(".")[0] in ("cv2", "imageio", "matplotlib", "sklearn"))
print(len(names), bad, missing, optional)
sys.exit(1 if bad or missing or optional else 0)
"""


def test_port_imports_no_jax_no_jax_package_and_no_triton():
    """Every module of the port (the training, video, config/data/Trainer,
    eval, model-zoo, SPRITES, CelebA/CUB, VILANRO, FashionMNIST and
    multi-device slices' among them), and
    chip_smoke.py, imported in a fresh process with no nvcc reachable: none
    pulls in jax, flax, optax, triton or the JAX package, none loads cv2,
    imageio, matplotlib or sklearn, and none starts a process (an nvcc build)
    at import."""
    env = dict(os.environ, PATH=os.path.dirname(sys.executable),
               CUDA_HOME=str(REPO / "no-cuda-here"))
    env.pop("CUDA_PATH", None)
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


_IMPORT_DATA = r"""
import os, subprocess, sys
from pathlib import Path

def refuse(*args, **kwargs):
    raise AssertionError("a build was started at import time")

subprocess.Popen = subprocess.run = refuse
os.environ["CXX"] = "/no/such/compiler"
before = set(Path("build/torch_kernels").glob("libmmvae_io_*")) \
    if Path("build/torch_kernels").is_dir() else set()
from multimodal_vae_comparison_tpu_torch.data import native
from multimodal_vae_comparison_tpu_torch.data_proc import cdsprites, sprites_gen, surrogates
from multimodal_vae_comparison_tpu_torch.data_proc import digits, mnistsvhn, polymnist
from multimodal_vae_comparison_tpu_torch.data import datamodule, datasets
glyphs = digits.load_digits()
assert glyphs.images.shape == (1797, 8, 8) and glyphs.target.shape == (1797,)
from multimodal_vae_comparison_tpu_torch.lanro import arm, collect, env, simulation
from multimodal_vae_comparison_tpu_torch.eval import vilanro_probe, vilanro_test
after = set(Path("build/torch_kernels").glob("libmmvae_io_*")) \
    if Path("build/torch_kernels").is_dir() else set()
loaded = sorted(n for n in ("cv2", "h5py", "yaml", "tensorboardX", "scipy", "sklearn", "jax")
                if n in sys.modules)
print(native._lib, after - before, loaded)
sys.exit(0 if native._lib is None and after == before and not loaded else 1)
"""


def test_importing_the_data_layer_starts_no_build_and_loads_no_optional_module():
    """``data.native`` compiles ``native/mmvae_io.cpp`` at first use and the
    generators (the surrogate builders, the MNIST-SVHN and PolyMNIST
    builders and the LANRO simulator and collector among them) import cv2
    and h5py where they draw and write, the VILANRO probe scipy where it
    fits: importing them (and the closed loop) starts no process, loads no
    library and no optional module, and loads neither sklearn nor jax; the
    8x8 digits load from the package's own copy without sklearn."""
    proc = subprocess.run([sys.executable, "-c", _IMPORT_DATA], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _specs():
    return (ModalitySpec("mod_1", "CNN2", "CNN", (32, 32, 3)),
            ModalitySpec("mod_2", "TxtTransformer", "TxtTransformer", (12, 27),
                         mod_type="text", has_masks=True))


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    model = get_mixing("poe")(_specs(), 8, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError):
        InferenceEngine(ModelHandle(model))
    with pytest.raises(RuntimeError):
        get_mixing("poe")(_specs(), 8)
    assert resolve_device("cpu") == torch.device("cpu")
    eng = InferenceEngine(ModelHandle(model), device="cpu")
    assert eng.device.type == "cpu" and model.device.type == "cpu"


def test_seeded_models_share_weights_and_other_seeds_do_not():
    a = get_mixing("poe")(_specs(), 8, seed=1, device="cpu")
    b = get_mixing("poe")(_specs(), 8, seed=1, device="cpu")
    c = get_mixing("poe")(_specs(), 8, seed=2, device="cpu")
    for (name, x), y, z in zip(a.state_dict().items(), b.state_dict().values(),
                               c.state_dict().values()):
        assert torch.equal(x, y), name
    assert not torch.equal(a.enc_mod_1.Conv_0.weight, c.enc_mod_1.Conv_0.weight)


def test_chip_smoke_fails_without_cuda(monkeypatch, capsys):
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert chip_smoke.main() == 1
    assert '"ok"' not in capsys.readouterr().out


@pytest.mark.parametrize("matmul,cudnn", [(False, False), (True, True), (False, True)])
def test_chip_smoke_children_compute_under_its_tf32_settings(tmp_path, monkeypatch,
                                                             matmul, cudnn):
    """chip_smoke holds a child process's stats against its own byte for
    byte.  ``module_argv`` starts the child as a user would, a plain
    ``python -m``, whatever this process's flags are; the entry point then
    sets the port's numerics itself (TF32 off, cuDNN's deterministic
    algorithms), so the child computes as the script does."""
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    # a stand-in that runs the eval CLI as ``-m`` would, and reads the flags
    # before it (a fresh process's) and after it (the entry point's)
    (tmp_path / "entry_probe.py").write_text(
        "import runpy, sys, torch\n"
        "def flags():\n"
        "    return (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,\n"
        "            torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)\n"
        "print(*flags(), sys.argv[1:])\n"
        "runpy.run_module('multimodal_vae_comparison_tpu_torch.eval.eval_cdsprites',\n"
        "                 run_name='__main__', alter_sys=True)\n"
        "print(*flags())\n")
    stats = tmp_path / "runs" / "version_0"
    stats.mkdir(parents=True)
    (stats / "cdspritesplus_stats.txt").write_text("Text-Image Strict: 50.0\n")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", matmul)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", cudnn)
    argv = chip_smoke.module_argv("entry_probe", "-a", str(tmp_path / "runs"))
    assert argv == [sys.executable, "-m", "entry_probe", "-a", str(tmp_path / "runs")]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(tmp_path), str(REPO)]))
    out = subprocess.run(argv, cwd=tmp_path, env=env, capture_output=True, text=True,
                         timeout=120, check=True).stdout.splitlines()
    runs = str(tmp_path / "runs")
    assert out[0] == f"False True False False ['-a', '{runs}']"   # PyTorch's own
    assert out[-1] == "False False True False"                     # the entry point's
    assert (tmp_path / "runs" / "cdspritesplus_stats.txt").is_file()


def test_build_keys_libraries_by_source_hash(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    src = tmp_path / "k.cu"
    src.write_text("// one\n")
    first = _build.library_path("k")
    assert _build.library_path("k") == first
    src.write_text("// two\n")
    assert _build.library_path("k") != first
    assert first.parent == _build.BUILD_DIR


def test_build_raises_without_nvcc(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    (tmp_path / "k.cu").write_text("// k\n")
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build(["k"])
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.library("k")


def test_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    """A failed nvcc run raises with its output; nothing is loaded."""
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    (tmp_path / "k.cu").write_text("// k\n")
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: no such arch' >&2\nexit 2\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build.shutil, "which", lambda name: str(fake))
    with pytest.raises(RuntimeError, match="no such arch"):
        _build.build(["k"])
    assert not _build.library_path("k").exists()


def test_sources_are_listed_and_present():
    for name in _build.SOURCES:
        text = (_build.CSRC / f"{name}.cu").read_text()
        assert 'extern "C"' in text and "error_string" in text
        assert "multimodal_vae_comparison_tpu/ops/pallas/" in text  # what it replaces
    assert set(_build.SOURCES) == {p.stem for p in _build.CSRC.glob("*.cu")}
