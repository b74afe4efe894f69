"""The port's one numerics policy (``device.set_numerics``), on the CPU.

Every entry point sets it: each case starts from a new process's PyTorch
flags (cuDNN's TF32 on and its algorithms chosen freely; TF32 in matmuls
too), runs one entry on a tiny config with ``--device cpu``, and reads the
policy's flags after it.  Then the reproducibility the policy is for: two
``main`` CLI processes under different ``PYTHONHASHSEED``s train the same
seed on the same rows and write the same bytes; and ``chip_smoke``'s op
tracer, which names the first op where two seeded runs part.
"""
import filecmp
import functools
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from multimodal_vae_comparison_tpu_torch import main as port_main
from multimodal_vae_comparison_tpu_torch.config import Config
from multimodal_vae_comparison_tpu_torch.data.datamodule import prefetch_to_device
from multimodal_vae_comparison_tpu_torch.data_proc import cdsprites
from multimodal_vae_comparison_tpu_torch.device import set_numerics
from multimodal_vae_comparison_tpu_torch.eval import (
    eval_cdsprites, fid, train_classifiers, vilanro_probe, vilanro_test)
from multimodal_vae_comparison_tpu_torch.eval.infer import MultimodalVAEInfer
from multimodal_vae_comparison_tpu_torch.lanro import collect
from multimodal_vae_comparison_tpu_torch.models import perceptual
from multimodal_vae_comparison_tpu_torch.models.base import ModalitySpec
from multimodal_vae_comparison_tpu_torch.parallel.launch import launch
from multimodal_vae_comparison_tpu_torch.serving import server
from multimodal_vae_comparison_tpu_torch.serving.engine import InferenceEngine
from multimodal_vae_comparison_tpu_torch.training.optim import make_optimizer
from multimodal_vae_comparison_tpu_torch.training.trainer import (
    Trainer, build_model, make_train_step)
from test_torch_data import cdsprites_params
from test_torch_slice import one_torch_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]
VILANRO_CONFIG = "configs/config_vilanro.yml"
VILANRO_STEMS = ("instructions_final.pkl", "endeff_actions_final.pkl", "image_final.pkl")

# what every entry point leaves behind, and a new process's flags (with
# TF32 in matmuls on as well, so that the policy is seen to turn it off)
POLICY = {"matmul.allow_tf32": False, "cudnn.allow_tf32": False,
          "cudnn.deterministic": True, "cudnn.benchmark": False}
FRESH = {"matmul.allow_tf32": True, "cudnn.allow_tf32": True,
         "cudnn.deterministic": False, "cudnn.benchmark": False}


def flags() -> dict:
    return {"matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
            "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
            "cudnn.deterministic": torch.backends.cudnn.deterministic,
            "cudnn.benchmark": torch.backends.cudnn.benchmark}


def rank_flags(ctx) -> dict:
    """A rank function of ``parallel.launch``: the flags the rank runs under."""
    return flags()


def _fresh_flags(monkeypatch) -> None:
    for (owner, name), value in zip(
            ((torch.backends.cuda.matmul, "allow_tf32"), (torch.backends.cudnn, "allow_tf32"),
             (torch.backends.cudnn, "deterministic"), (torch.backends.cudnn, "benchmark")),
            FRESH.values()):
        monkeypatch.setattr(owner, name, value)
    assert flags() == FRESH


@pytest.fixture(scope="module")
def cdsprites_run(tmp_path_factory):
    """CdSprites+ level 1 at 54 rows, its config, and one epoch through the
    CLI on the CPU: (root, level dir, config path, run dir); the judge is
    cached under ``root/judges``."""
    root = tmp_path_factory.mktemp("numerics")
    level = cdsprites.generate_level(1, 54, str(root / "data"), seed=0)
    cfg = root / "cfg.yml"
    cfg.write_text(yaml.safe_dump(cdsprites_params(level, exp_name="numerics")))
    cwd = os.getcwd()
    os.chdir(root)
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("CDSPRITES_CLASSIFIER_DIR", str(root / "judges"))
            mp.setenv("CDSPRITES_EVAL_SAMPLES", "12")
            trainer = port_main.cli(["--cfg", str(cfg), "--device", "cpu", "--epochs", "1",
                                     "--no_viz"])
    finally:
        os.chdir(cwd)
    return root, level, cfg, str(root / trainer.cfg.mPath)


@pytest.fixture(scope="module")
def vilanro_run(tmp_path_factory):
    """VILANRO collected at 20 episodes and ``config_vilanro.yml`` (cut to
    bs 4) trained for 1 epoch on the CPU: (collection dir, run dir)."""
    root = tmp_path_factory.mktemp("vilanro")
    data = str(root / "data")
    collect.collect("NLReach2-v0", 20, data, seed=3, chunk_every=5)
    with open(REPO / VILANRO_CONFIG) as f:
        params = yaml.safe_load(f)
    for i, stem in enumerate(VILANRO_STEMS):
        params[f"modality_{i + 1}"].update(path=os.path.join(data, stem), test_datapath=None)
    params.update(batch_size=4)
    trainer = Trainer(Config(params, results_root=str(root)), device="cpu", enable_viz=False)
    trainer.init_state()
    trainer.fit(epochs=1, log_fn=None)
    return data, trainer.cfg.mPath


def _in(path, fn):
    cwd = os.getcwd()
    os.chdir(path)
    try:
        return fn()
    finally:
        os.chdir(cwd)


def _main_cli(cdsprites_run, vilanro_run, tmp_path, monkeypatch):
    root, _, cfg, _ = cdsprites_run
    monkeypatch.setenv("CDSPRITES_CLASSIFIER_DIR", str(root / "judges"))
    monkeypatch.setenv("CDSPRITES_EVAL_SAMPLES", "12")
    trainer = _in(tmp_path, lambda: port_main.cli(
        ["--cfg", str(cfg), "--device", "cpu", "--epochs", "1", "--no_viz"]))
    assert trainer.step == 5


def _server(cdsprites_run, vilanro_run, tmp_path, monkeypatch):
    served = []
    monkeypatch.setattr(server, "serve", lambda engine, infer, port: served.append(engine))
    server.main(["--model", cdsprites_run[3], "--device", "cpu"])
    assert served[0].device.type == "cpu"


def _eval_cdsprites(cdsprites_run, vilanro_run, tmp_path, monkeypatch):
    root, _, _, run = cdsprites_run
    monkeypatch.setenv("CDSPRITES_CLASSIFIER_DIR", str(root / "judges"))
    monkeypatch.setenv("CDSPRITES_EVAL_SAMPLES", "12")
    stats = eval_cdsprites.main(["-p", run, "--device", "cpu"])
    assert "Text-Image Strict" in stats


def _train_classifiers(cdsprites_run, vilanro_run, tmp_path, monkeypatch):
    accs = train_classifiers.main(["--dataset", "cdspritesplus", "--path",
                                   os.path.join(cdsprites_run[1], "traindata.h5"),
                                   "--level", "1", "--out_dir", str(tmp_path), "--device", "cpu"])
    assert set(accs) == {"shape"}


def _vilanro_test(cdsprites_run, vilanro_run, tmp_path, monkeypatch):
    vilanro_test.main(["--model", vilanro_run[1], "--trials", "2", "--replan", "5",
                       "--device", "cpu"])
    assert os.path.isfile(os.path.join(vilanro_run[1], "vilanro_NLReach2-v0_replan5_stats.txt"))


def _vilanro_probe(cdsprites_run, vilanro_run, tmp_path, monkeypatch):
    vilanro_probe.main(["--model", vilanro_run[1], "--scenes", "20", "--device", "cpu"])
    assert os.path.isfile(os.path.join(vilanro_run[1], "vilanro_probe_NLReach2-v0_stats.txt"))


def _collect_dagger(cdsprites_run, vilanro_run, tmp_path, monkeypatch):
    monkeypatch.setattr(collect, "collect_dagger", functools.partial(
        collect.collect_dagger, batch=4, rollout_steps=3))
    collect.main(["--episodes", "4", "--out", str(tmp_path / "dagger"), "--dagger_model",
                  vilanro_run[1], "--device", "cpu"])
    assert (tmp_path / "dagger" / VILANRO_STEMS[1]).is_file()


def _trainer(cdsprites_run, vilanro_run, tmp_path, monkeypatch):
    params = cdsprites_params(cdsprites_run[1], exp_name="trainer")
    trainer = Trainer(Config(params, results_root=str(tmp_path)), device="cpu",
                      enable_viz=False)
    assert np.isfinite(trainer.fit(epochs=1, log_fn=None)["train_loss"])


def _build_model(cdsprites_run, vilanro_run, tmp_path, monkeypatch):
    specs = (ModalitySpec(name="mod_1", encoder="CNN2", decoder="CNN", feature_dims=(32, 32, 3),
                          mod_type="image", recon_loss="bce"),
             ModalitySpec(name="mod_2", encoder="FNN", decoder="FNN", feature_dims=(9,),
                          mod_type="actions", recon_loss="bce"))
    model = build_model(specs, "moe", 8, device="cpu")
    step = make_train_step(model, make_optimizer("adam", 1e-3, model.parameters()))
    rng = np.random.default_rng(0)
    batch = {"mod_1": {"data": torch.from_numpy(rng.random((2, 32, 32, 3), dtype=np.float32)),
                       "masks": None},
             "mod_2": {"data": torch.from_numpy(rng.random((2, 9), dtype=np.float32)),
                       "masks": None}}
    assert torch.isfinite(step(batch, generator=torch.Generator().manual_seed(0))["loss"])


def _launch_rank(cdsprites_run, vilanro_run, tmp_path, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    (got,) = launch(rank_flags, 1, device="cpu", deadline=120)
    return got   # a rank is a new process: its flags, not this one's


def _infer_and_engine(cdsprites_run, vilanro_run, tmp_path, monkeypatch):
    infer = MultimodalVAEInfer(cdsprites_run[3], device="cpu")
    _fresh_flags(monkeypatch)
    engine = InferenceEngine(infer, buckets=(2,), device="cpu")
    assert engine.device.type == "cpu"


def _fid(cdsprites_run, vilanro_run, tmp_path, monkeypatch):
    monkeypatch.setenv("MVAE_TPU_WEIGHTS_DIR", str(tmp_path))
    perceptual.reset_extractor_cache()
    try:
        feats = fid.default_feature_fn(device="cpu")(
            np.random.default_rng(0).random((2, 32, 32, 3), dtype=np.float32))
    finally:
        perceptual.reset_extractor_cache()
    assert feats.shape[0] == 2 and np.isfinite(feats).all()


def _prefetch(cdsprites_run, vilanro_run, tmp_path, monkeypatch):
    batches = [{"m": {"data": np.ones((2, 3), np.float32), "masks": None}}]
    (got,) = list(prefetch_to_device(iter(batches), "cpu"))
    assert torch.equal(got["m"]["data"], torch.ones(2, 3))


ENTRIES = {"main": _main_cli, "serving.server": _server, "eval_cdsprites": _eval_cdsprites,
           "train_classifiers": _train_classifiers, "vilanro_test": _vilanro_test,
           "vilanro_probe": _vilanro_probe, "lanro.collect --dagger_model": _collect_dagger,
           "Trainer": _trainer, "build_model": _build_model, "launch rank": _launch_rank,
           "MultimodalVAEInfer and InferenceEngine": _infer_and_engine,
           "fid.default_feature_fn": _fid, "prefetch_to_device": _prefetch}


@pytest.mark.parametrize("entry", list(ENTRIES))
def test_every_entry_point_leaves_the_numerics_policy(entry, cdsprites_run, vilanro_run,
                                                      tmp_path, monkeypatch):
    _fresh_flags(monkeypatch)
    got = ENTRIES[entry](cdsprites_run, vilanro_run, tmp_path, monkeypatch)
    assert (got or flags()) == POLICY


def test_set_numerics_sets_the_policy_and_is_the_same_twice(monkeypatch):
    _fresh_flags(monkeypatch)
    set_numerics()
    assert flags() == POLICY
    set_numerics()
    assert flags() == POLICY


def test_two_cli_processes_under_other_hash_seeds_write_the_same_bytes(cdsprites_run,
                                                                       tmp_path):
    """The same seed on the same rows in two processes, each with its own
    judge cache and another ``PYTHONHASHSEED``: the checkpoints, the judge
    and the stats file are equal byte for byte."""
    _, _, cfg, _ = cdsprites_run
    dirs = [tmp_path / f"run{i}" for i in range(2)]
    procs = []
    for d, hash_seed in zip(dirs, ("1", "2")):
        d.mkdir()
        env = dict(os.environ, PYTHONHASHSEED=hash_seed, OMP_NUM_THREADS="1",
                   PYTHONPATH=str(REPO), CDSPRITES_CLASSIFIER_DIR=str(d / "judges"),
                   CDSPRITES_EVAL_SAMPLES="12")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "multimodal_vae_comparison_tpu_torch.main", "--cfg", str(cfg),
             "--device", "cpu", "--epochs", "1", "--no_viz"], cwd=d, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for p in procs:
        out = p.communicate(timeout=240)[0]
        assert p.returncode == 0, out[-3000:]
    run = Path("results") / "numerics" / "version_0"
    files = [run / "model" / "last" / "state.pt", run / "model" / "best" / "state.pt",
             run / "cdspritesplus_stats.txt"]
    judges = sorted(os.listdir(dirs[0] / "judges"))
    assert judges and judges == sorted(os.listdir(dirs[1] / "judges"))
    files += [Path("judges") / j for j in judges]
    for rel in files:
        assert filecmp.cmp(dirs[0] / rel, dirs[1] / rel, shallow=False), rel


def _chip_smoke():
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    return chip_smoke


def _traced_step(chip_smoke, bump=None):
    """The op tracer's rows of the second of two train steps of a seeded
    net, ``bump(net)`` run between them outside the tracer."""
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Conv2d(3, 4, 3), torch.nn.ReLU(), torch.nn.Flatten(),
                                torch.nn.Linear(4 * 6 * 6, 2))
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    x = torch.from_numpy(np.random.default_rng(1).random((2, 3, 8, 8), dtype=np.float32))

    def step():
        opt.zero_grad()
        model(x).square().sum().backward()
        opt.step()
    step()
    if bump is not None:
        bump(model)
    with chip_smoke.op_tracer() as tracer:
        step()
    return tracer.rows()


@pytest.mark.parametrize("bump,says", [
    (None, None),
    (lambda m: m[0].weight.data.view(-1)[0:1].add_(1e-3), "its inputs differ"),
], ids=["same", "written-outside"])
def test_op_tracer_names_where_two_seeded_steps_part(bump, says):
    chip_smoke = _chip_smoke()
    a = _traced_step(chip_smoke)
    b = _traced_step(chip_smoke, bump)
    names = [r[0] for r in a]
    assert "aten.convolution_backward.default" in names     # the backward is traced too
    got = chip_smoke.first_differing_op(a, b)
    if says is None:
        assert got is None
    else:
        assert says in got and "aten.convolution.default" in got


def test_op_tracer_names_an_op_whose_same_inputs_gave_other_outputs():
    chip_smoke = _chip_smoke()
    x = torch.arange(6.0)
    rows = []
    for scale in (1.0, 1.5):   # a constant, not a tensor input: as a race would
        with chip_smoke.op_tracer() as tracer:
            x.exp().mul(scale).sum()
        rows.append(tracer.rows())
    got = chip_smoke.first_differing_op(*rows)
    assert got == "op 1 aten.mul.Tensor: the same inputs gave other outputs"


@pytest.mark.parametrize("dtype,rows,bias", [
    (torch.float64, 8, True), (torch.float32, 8, True), (torch.float32, 3, False),
    (torch.float32, 64, True)], ids=["f64", "f32", "f32-rows3-nobias", "f32-one-block"])
def test_blocked_weight_gradient_is_the_transposed_convs(monkeypatch, dtype, rows, bias):
    """A 3-D transposed conv in fp32 or wider sums its weight gradient over
    blocks of WGRAD_ROWS rows: the forward, the input and bias gradients
    are PyTorch's bit for bit, the weight gradient PyTorch's up to the order
    of the sum, also where the rows do not fill the last block."""
    from multimodal_vae_comparison_tpu_torch.models import precision
    monkeypatch.setattr(precision, "WGRAD_ROWS", rows)
    torch.manual_seed(0)
    conv = precision.ConvTranspose3d(5, 3, 4, stride=(1, 2, 2), padding=1, bias=bias).to(dtype)
    x = torch.randn(11, 5, 3, 6, 6, dtype=dtype, requires_grad=True)
    y = conv(x)
    assert y.grad_fn.name().endswith("_BlockedWeightGradBackward")
    want_y = torch.nn.functional.conv_transpose3d(x, conv.weight, conv.bias, conv.stride,
                                                  conv.padding)
    g = torch.randn_like(y)
    params = (x, conv.weight) + ((conv.bias,) if bias else ())
    got, want = (torch.autograd.grad(out, params, g) for out in (y, want_y))
    assert torch.equal(y, want_y) and torch.equal(got[0], want[0])
    if bias:
        assert torch.equal(got[2], want[2])
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    assert torch.allclose(got[1], want[1], rtol=tol, atol=tol * want[1].abs().max())


def test_bf16_and_2d_transposed_convs_keep_pytorchs_own():
    from multimodal_vae_comparison_tpu_torch.models import precision
    conv3 = precision.ConvTranspose3d(2, 2, 4)
    precision.set_compute_dtype(conv3, torch.bfloat16)
    conv2 = precision.ConvTranspose2d(2, 2, 4)
    y3 = conv3(torch.randn(2, 2, 3, 3, 3))
    y2 = conv2(torch.randn(2, 2, 3, 3))
    assert "Blocked" not in y3.grad_fn.name() and "Blocked" not in y2.grad_fn.name()
