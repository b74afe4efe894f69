"""The port's Trainer, checkpoints, CLI and ``--model`` server, on the CPU.

One epoch of the port's ``Trainer.run_epoch`` against the JAX package's on
the same tiny CdSprites+ file: the port starts from the JAX init through
``bridge.py`` and is fed JAX's own noise, recorded by patching the JAX
``Normal.rsample`` (as ``tests/test_torch_train.py`` does) and replayed by
patching the port's.  Then the port's own contracts: the resident epoch
runner against the per-batch loop, the seeded reshuffle, save / restore /
continue against an uninterrupted run, best_val and CSV resume, the CLI,
``MultimodalVAEInfer`` and the server on the run directory it wrote.
"""
import contextlib
import io
import json
import os
import threading
import urllib.request
from http.server import ThreadingHTTPServer

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from multimodal_vae_comparison_tpu.config import Config as JConfig
from multimodal_vae_comparison_tpu.data.datamodule import DataModule as JDataModule
from multimodal_vae_comparison_tpu.models import distributions as jdist
from multimodal_vae_comparison_tpu.parallel.mesh import make_mesh
from multimodal_vae_comparison_tpu.training.trainer import CSVLogger as JCSVLogger
from multimodal_vae_comparison_tpu.training.trainer import Trainer as JTrainer
from multimodal_vae_comparison_tpu.training.trainer import TrainState
from multimodal_vae_comparison_tpu.training.trainer import build_model as jbuild_model
from multimodal_vae_comparison_tpu.training.trainer import make_train_step as jmake_train_step
from multimodal_vae_comparison_tpu_torch import main as port_main
from multimodal_vae_comparison_tpu_torch.bridge import load_flax_params
from multimodal_vae_comparison_tpu_torch.config import Config
from multimodal_vae_comparison_tpu_torch.data_proc import cdsprites
from multimodal_vae_comparison_tpu_torch.eval.eval_cdsprites import STATS_KEYS
from multimodal_vae_comparison_tpu_torch.eval.infer import MultimodalVAEInfer
from multimodal_vae_comparison_tpu_torch.models import distributions as tdist
from multimodal_vae_comparison_tpu_torch.ops.kernels import telemetry
from multimodal_vae_comparison_tpu_torch.serving import server
from multimodal_vae_comparison_tpu_torch.serving.engine import InferenceEngine
from multimodal_vae_comparison_tpu_torch.training.trainer import (
    CSVLogger, Trainer, make_epoch_runner)
from test_torch_data import cdsprites_params
from test_torch_slice import one_torch_thread  # noqa: F401 (autouse)

# one epoch of 6 amsgrad steps at lr 1e-4 from bridged weights on JAX's
# draws.  Train metrics are batch sums of ~2e5 in fp32.  amsgrad moves a
# weight by up to lr a step whatever the size of its gradient, so where a
# gradient is within rounding of zero the two packages may step it in
# opposite directions: every weight is held to 2 lr a step, and 98 % of each
# leaf to PARAM_ATOL, 2 % of one step (measured: 99.1 % or more per leaf)
METRIC_RTOL = 1e-5
LR, STEPS = 1e-4, 6
PARAM_ATOL, PARAM_SHARE = 2e-6, 0.98


@pytest.fixture(scope="module")
def level1(tmp_path_factory):
    """CdSprites+ level 1 at count 54: 54 train rows, 3 test rows."""
    return cdsprites.generate_level(1, 54, str(tmp_path_factory.mktemp("data")), seed=0)


def port_trainer(level1, root, **over):
    params = cdsprites_params(level1, **over)
    return Trainer(Config(params, results_root=str(root)), device="cpu", enable_viz=False)


def _assert_state_equal(a, b):
    for (name, x), y in zip(a.model.state_dict().items(), b.model.state_dict().values()):
        assert torch.equal(x, y), name
    sa, sb = a.opt.state_dict()["state"], b.opt.state_dict()["state"]
    assert sorted(sa) == sorted(sb)
    for i in sa:
        assert sa[i]["count"] == sb[i]["count"]
        for k in ("mu", "nu", "nu_max"):
            assert torch.equal(sa[i][k], sb[i][k]), (i, k)
    assert a.step == b.step and a.best_val == b.best_val


# -- the slice against the JAX package ------------------------------------------------


def test_one_epoch_matches_the_jax_trainer_from_bridged_weights(tmp_path, level1, monkeypatch):
    """The flagship POE at full width, 48 train rows, bs 8, adam: the JAX
    Trainer's ``run_epoch`` (its host shuffle, prefetch and metric means;
    its step jitted and wrapped to hand back the draws it made) and the
    port's, same epoch seed."""
    params = cdsprites_params(level1, test_split=0.1, lr=LR)
    jtr = JTrainer(JConfig(params, results_root=str(tmp_path / "jax")), mesh=make_mesh(1),
                   enable_viz=False)
    # the JAX init (Trainer.init_state's, jitted), and a fresh amsgrad state
    batch = next(jtr.datamodule.batches("train"))
    key = jax.random.PRNGKey(jtr.cfg.seed)
    init = jax.jit(lambda k, b: jtr.model.init({"params": k, "sample": k}, b,
                                               method=jtr.model.objective))(key, batch)
    jtr.state = TrainState(params=init, opt_state=jtr.tx.init(init),
                           step=jnp.zeros((), jnp.int32))
    draws = []

    def record(dist, key, sample_shape=()):
        shape = tuple(sample_shape) + jnp.shape(dist.loc)
        eps = jax.random.normal(key, shape, dtype=jnp.result_type(dist.loc))
        draws.append(eps)
        return dist.loc + eps * dist.scale

    monkeypatch.setattr(jdist.Normal, "rsample", record)
    raw_step = jmake_train_step(jtr.model, jtr.tx, jit=False)

    def with_draws(state, batch, rng):
        draws.clear()
        new_state, metrics = raw_step(state, batch, rng)
        return new_state, metrics, list(draws)

    jitted, taken = jax.jit(with_draws), []

    def train_step(state, batch, rng):
        new_state, metrics, eps = jitted(state, batch, rng)
        taken.extend(torch.from_numpy(np.array(e)) for e in eps)
        return new_state, metrics

    jtr.train_step = train_step
    want = jtr.run_epoch(0)
    assert len(taken) == STEPS * 3   # one draw per subset

    ptr = port_trainer(level1, tmp_path / "port", test_split=0.1, lr=LR)
    ptr.init_state()
    load_flax_params(ptr.model, jax.tree_util.tree_map(np.asarray, init))
    queue = list(taken)

    def replay(dist, sample_shape=(), generator=None, eps=None):
        return dist.loc + queue.pop(0) * dist.scale

    monkeypatch.setattr(tdist.Normal, "rsample", replay)
    got = ptr.run_epoch(0)
    assert not queue and ptr.step == STEPS
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=METRIC_RTOL, err_msg=k)
    ref = port_trainer(level1, tmp_path / "ref", test_split=0.1)
    load_flax_params(ref.model, jax.tree_util.tree_map(np.asarray, jtr.state.params))
    for (name, p), w in zip(ptr.model.named_parameters(), ref.model.parameters()):
        diff = (p - w).detach().abs()
        assert diff.max().item() <= 2 * LR * STEPS, name
        if name.endswith("key.bias"):
            # a zero gradient in exact arithmetic (softmax is shift-invariant
            # per row): every element is such a weight
            continue
        share = (diff <= PARAM_ATOL).float().mean().item()
        assert share >= PARAM_SHARE, f"{name}: {share:.4f} of the weights within {PARAM_ATOL}"


# -- the port's own contracts ------------------------------------------------------------


def test_resident_epoch_equals_the_per_batch_loop_over_its_permutation(tmp_path, level1):
    a = port_trainer(level1, tmp_path / "a").init_state()
    b = port_trainer(level1, tmp_path / "b").init_state()
    got = a.run_epoch_scan(2)
    staged = b.stage_epoch_data()
    n_batches, bs = staged["mod_1"]["data"].shape[:2]
    generator = torch.Generator().manual_seed(b.cfg.seed * 100003 + 2)
    perm = torch.randperm(n_batches * bs, generator=generator)
    flat = {n: {k: None if v is None else v.flatten(0, 1)[perm] for k, v in m.items()}
            for n, m in staged.items()}
    total = {}
    for i in range(n_batches):
        batch = {n: {k: None if v is None else v[i * bs:(i + 1) * bs] for k, v in m.items()}
                 for n, m in flat.items()}
        for k, v in b.train_step(batch, generator=generator).items():
            total[k] = v if k not in total else total[k] + v
    want = {f"train_{k}": v.item() / n_batches for k, v in total.items()}
    assert got == want
    b.step += n_batches
    _assert_state_equal(a, b)


def test_validate_scan_equals_validate(tmp_path, level1):
    t = port_trainer(level1, tmp_path).init_state()
    assert t.datamodule.n_val // 8 == 1
    assert t.validate_scan(3) == t.validate(3)


def test_reshuffle_is_a_seeded_permutation_that_changes_between_epochs():
    seen = []

    def step(batch, generator=None):
        seen.append(torch.stack([batch["mod_1"]["data"], batch["mod_2"]["data"][:, 0]]))
        return {"loss": batch["mod_1"]["data"].sum()}

    rows = torch.arange(24.0)
    staged = {"mod_1": {"data": rows.view(4, 6), "masks": None},
              "mod_2": {"data": torch.stack([rows, -rows], 1).view(4, 6, 2), "masks": None}}

    def order(seed, reshuffle=True):
        seen.clear()
        metrics = make_epoch_runner(step, reshuffle)(staged, torch.Generator().manual_seed(seed))
        assert metrics == {"loss": rows.sum().item() / 4}
        out = torch.cat(seen, dim=1)
        assert torch.equal(out[0], out[1])   # one permutation for every modality
        return out[0]

    first = order(100003)
    assert torch.equal(first, order(100003))
    assert torch.equal(first.sort().values, rows)
    assert not torch.equal(first, order(100004))
    assert not torch.equal(first, rows)
    assert torch.equal(order(100003, reshuffle=False), rows)


@pytest.mark.parametrize("scan", [True, False], ids=["resident", "per-batch"])
def test_save_restore_and_continue_equals_an_uninterrupted_run(tmp_path, level1, scan):
    whole = port_trainer(level1, tmp_path / "whole", scan_epochs=scan)
    whole.fit(epochs=2, log_fn=None)
    first = port_trainer(level1, tmp_path / "cut", scan_epochs=scan)
    first.fit(epochs=1, log_fn=None)
    run_dir = first.cfg.mPath
    again = port_trainer(level1, tmp_path / "again", scan_epochs=scan, resume=True)
    again.cfg.mPath = run_dir      # the same run dir, as after a restart
    again._open_loggers(run_dir)
    again.init_state()
    _assert_state_equal(again, first)
    again.fit(epochs=2, log_fn=None)
    _assert_state_equal(again, whole)
    with open(os.path.join(run_dir, "metrics.csv")) as f:
        rows = f.read().strip().splitlines()
    assert [r.split(",")[0] for r in rows] == ["step", "0", "1"]
    again.fit(epochs=2, log_fn=None)    # every epoch done: nothing runs
    assert again.step == whole.step == 2 * 5


def test_best_val_follows_the_val_loss_and_csv_resume_appends(tmp_path, level1, monkeypatch):
    t = port_trainer(level1, tmp_path).init_state()
    losses = iter([3.0, 1.0, 2.0])
    monkeypatch.setattr(t, "validate_scan", lambda epoch: {"val_loss": next(losses)})
    t.fit(epochs=3, log_fn=None)
    ckpt = os.path.join(t.cfg.mPath, "model")
    best = torch.load(os.path.join(ckpt, "best", "state.pt"), weights_only=True)
    last = torch.load(os.path.join(ckpt, "last", "state.pt"), weights_only=True)
    assert (best["step"], best["best_val"]) == (10, 1.0)
    assert (last["step"], last["best_val"]) == (15, 1.0) and t.best_val == 1.0
    # the CSV sink against the JAX package's: same rows, a resumed writer
    # appends under the existing header
    logs = [(0, {"train_loss": 1.0, "val_loss": 2.5}), (1, {"train_loss": 0.9})]
    for cls, name in ((CSVLogger, "port"), (JCSVLogger, "jax")):
        path = str(tmp_path / name / "metrics.csv")
        cls(path).log(*logs[0])
        cls(path).log(*logs[1])
    port, jax_rows = (open(tmp_path / n / "metrics.csv").read() for n in ("port", "jax"))
    assert port == jax_rows == "step,train_loss,val_loss\n0,1.0,2.5\n1,0.9,\n"


def test_pre_trained_warm_starts_the_params_only(tmp_path, level1):
    src = port_trainer(level1, tmp_path / "src")
    src.fit(epochs=1, log_fn=None)
    warm = port_trainer(level1, tmp_path / "warm", pre_trained=src.cfg.mPath, seed=9)
    warm.init_state()
    for (name, x), y in zip(warm.model.state_dict().items(), src.model.state_dict().values()):
        assert torch.equal(x, y), name
    assert warm.step == 0 and not warm.opt.state


def test_init_state_reloads_the_seeds_weights_without_building_again(tmp_path, level1,
                                                                     monkeypatch):
    from multimodal_vae_comparison_tpu_torch.training import trainer as trainer_module
    t = port_trainer(level1, tmp_path)
    drawn = {k: v.clone() for k, v in t.model.state_dict().items()}
    t.init_state()
    t.fit(epochs=1, log_fn=None)

    def refuse(*args, **kwargs):
        raise AssertionError("init_state built the model again for an unchanged seed")

    monkeypatch.setattr(trainer_module, "build_model_from_config", refuse)
    t.init_state()
    for name, x in t.model.state_dict().items():
        assert torch.equal(x, drawn[name]), name


def test_reset_for_seed_repoints_the_run_and_redraws_the_weights(tmp_path, level1):
    """The iterseeds path: one Trainer, a new seed and run directory."""
    t = port_trainer(level1, tmp_path)
    t.fit(epochs=1, log_fn=None)
    first = t.cfg.mPath
    new_dir = os.path.join(os.path.dirname(first), "version_1")
    t.reset_for_seed(4, mPath=new_dir)
    assert t.step == 0 and t.best_val == float("inf") and not t.opt.state
    fresh = port_trainer(level1, tmp_path / "fresh", seed=4).init_state()
    for (name, x), y in zip(t.model.state_dict().items(), fresh.model.state_dict().values()):
        assert torch.equal(x, y), name
    t.fit(epochs=1, log_fn=None)
    for run in (first, new_dir):
        assert os.path.isfile(os.path.join(run, "model", "last", "state.pt"))
        with open(os.path.join(run, "metrics.csv")) as f:
            assert len(f.read().strip().splitlines()) == 2
    with open(os.path.join(new_dir, "config.yml")) as f:
        assert yaml.safe_load(f)["seed"] == 4


@pytest.fixture(scope="module")
def cli_run(level1, tmp_path_factory):
    """One epoch through the CLI on the CPU, its first epoch profiled, then
    the CdSprites+ benchmark of ``test()`` (its judge cached under the
    run's root); returns (root, trainer, printed output)."""
    root = tmp_path_factory.mktemp("cli")
    cfg = root / "cfg.yml"
    cfg.write_text(yaml.safe_dump(cdsprites_params(level1, exp_name="cli")))
    cwd = os.getcwd()
    os.chdir(root)
    out = io.StringIO()
    try:
        with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(out):
            mp.setenv("CDSPRITES_CLASSIFIER_DIR", str(root / "judges"))
            telemetry.reset()
            trainer = port_main.cli(["--cfg", str(cfg), "--device", "cpu", "--epochs", "1",
                                     "--no_viz", "--profile", str(root / "prof")])
    finally:
        os.chdir(cwd)
    return root, trainer, out.getvalue()


def test_cli_trains_one_epoch_into_its_run_directory(cli_run):
    root, trainer, printed = cli_run
    run = root / "results" / "cli" / "version_0"
    assert trainer.cfg.mPath == os.path.join("results", "cli", "version_0")
    for path in ("config.yml", "metrics.csv", "model/last/state.pt", "model/best/state.pt",
                 "tb", "visuals"):
        assert (run / path).exists(), path
    rows = (run / "metrics.csv").read_text().strip().splitlines()
    assert len(rows) == 2 and "val_loss" in rows[0].split(",")
    assert trainer.step == 5 and trainer.device.type == "cpu"
    assert yaml.safe_load((run / "config.yml").read_text())["epochs"] == 1
    trace = json.loads((root / "prof" / "trace.json").read_text())
    assert trace["traceEvents"]
    # the plain versions ran, 2 attention calls and 1 PoE call (the whole
    # lattice) per objective (5 train steps, 1 val batch, 1 test batch), and
    # 1 PoE backward per train step; then the benchmark of test(): a PoE
    # forward each for text->image (2 attention: text encoder and decoder),
    # image->text (1) and the one ex-post batch of the 40 train rows (2),
    # and a text decode (1 attention) for each of the 3 joint sources
    eval_attention, eval_poe = 2 + 1 + 2 + 3, 3
    assert telemetry.summary() == {"attention:plain": 2 * 7 + eval_attention,
                                   "poe:plain": 7 + eval_poe, "poe_bwd:plain": 5}
    stats = (run / "cdspritesplus_stats.txt").read_text().splitlines()
    assert [line.split(":")[0] for line in stats] == list(STATS_KEYS)
    test_line = next(line for line in printed.splitlines() if line.startswith("test: "))
    assert all(f"'{k}'" in test_line for k in STATS_KEYS) and "eval_error" not in test_line
    assert (root / "judges" / "cdspritesplus_classifier_level1_shape_v2.pt").is_file()


def test_infer_restores_the_run_and_the_server_serves_it(cli_run, monkeypatch):
    root, trainer, _ = cli_run
    run = str(root / "results" / "cli" / "version_0")
    infer = MultimodalVAEInfer(os.path.join(run, "model", "last"), device="cpu")
    assert infer.run_dir == run and infer.mod_names == ("mod_1", "mod_2")
    for (name, x), y in zip(infer.model.state_dict().items(),
                            trainer.model.state_dict().values()):
        assert torch.equal(x, y), name
    batch = next(infer.datamod.batches("val"))
    eps = torch.from_numpy(np.random.default_rng(0).standard_normal((1, 8, 16))
                           .astype(np.float32))
    present = ("mod_1", "mod_2")
    got = infer.forward(batch, present, eps=eps)
    trainer.model.eval()
    with torch.no_grad():
        want = trainer.model.forward(
            {n: {k: None if v is None else torch.from_numpy(v) for k, v in m.items()}
             for n, m in batch.items()}, present, eps=eps)
    for name in present:
        torch.testing.assert_close(got.mods[name].decoder_dist.mean,
                                   want.mods[name].decoder_dist.mean, rtol=0, atol=0)
    cross = infer.cross_generate("mod_2", batch["mod_2"]["data"], batch["mod_2"]["masks"])
    assert cross["mod_1"].shape == (8, 64, 64, 3) and cross["mod_2"].shape == (8, 45, 27)
    with pytest.raises(FileNotFoundError):
        MultimodalVAEInfer(str(root), device="cpu")

    served = {}
    monkeypatch.setattr(server, "serve", lambda engine, infer, port: served.update(
        engine=engine, infer=infer, port=port))
    server.main(["--model", run, "--port", "8765", "--device", "cpu"])
    assert served["port"] == 8765 and served["infer"].run_dir == run
    engine = served["engine"]
    assert isinstance(engine, InferenceEngine) and engine.device.type == "cpu"
    http = ThreadingHTTPServer(("127.0.0.1", 0), server.make_handler(engine, served["infer"]))
    thread = threading.Thread(target=http.serve_forever, daemon=True)
    thread.start()
    try:
        port = http.server_address[1]
        req = {"inputs": {"mod_1": {"data": batch["mod_1"]["data"][:2].tolist()}}, "seed": 1}
        resp = urllib.request.urlopen(urllib.request.Request(
            f"http://127.0.0.1:{port}/generate", data=json.dumps(req).encode()), timeout=60)
        assert resp.status == 200
        out = json.load(resp)
        assert np.asarray(out["mod_1"]).shape == (2, 64, 64, 3)
        assert np.asarray(out["mod_2"]).shape == (2, 45, 27)
    finally:
        http.shutdown()
        http.server_close()
        thread.join(timeout=30)
    assert not thread.is_alive()


@pytest.mark.parametrize("over,item", [
    ({"precision": "bf16"}, None),
    ({"prior_components": 4}, None),
    ({"aux_endpoint": 0.5}, None),
    ({"num_devices": 2}, None),
    ({"dataset_name": "mnist_svhn"}, None),
], ids=["bf16", "mixture-prior", "aux-endpoint", "devices", "dataset"])
def test_unported_options_raise_with_their_roadmap_item(tmp_path, level1, over, item):
    """Each option the port does not have raises naming its ROADMAP item;
    the mixture prior, the aux endpoint weight, the MNIST-SVHN dataset and
    ``precision: bf16`` (``item`` None), ported since, build: the weight on
    a config without an action-waypoint modality builds no endpoint head, as
    the JAX package's tree has none; the dataset name resolves to
    ``MNIST_SVHN``, which refuses CdSprites+'s modality types as the JAX
    class does; bf16 builds a bf16 model whose parameters stay fp32; two
    devices need two ranks (``main --num_devices 2``, which
    test_torch_parallel.py runs), and a Trainer outside a process group
    says so."""
    if "num_devices" in over:
        with pytest.raises(ValueError, match="needs that many ranks"):
            port_trainer(level1, tmp_path, **over)
        return
    if item is None and "dataset_name" in over:
        with pytest.raises(KeyError, match="Unsupported modality type image for MNIST_SVHN"):
            port_trainer(level1, tmp_path, **over)
        return
    if item is None:
        trainer = port_trainer(level1, tmp_path, **over)
        if "precision" in over:
            assert trainer.model.dtype == torch.bfloat16
            assert all(p.dtype == torch.float32 for p in trainer.model.parameters())
        elif "prior_components" in over:
            assert trainer.model.prior_components == 4
            assert trainer.model.pz_mog_loc.shape == (4, trainer.cfg.n_latents)
        else:
            assert trainer.model.aux_endpoint == 0.5
            assert trainer.model.endpoint_spec() is None
            assert not hasattr(trainer.model, "aux_head")
        return
    with pytest.raises(NotImplementedError, match=f"Queue A {item}"):
        port_trainer(level1, tmp_path, **over)


def test_a_single_modality_raises_with_its_roadmap_item(tmp_path, level1):
    """One modality block (the image alone) trains the unimodal VAE, as the
    JAX package's build_model makes it, an epoch into its checkpoint, which
    restores and serves."""
    params = cdsprites_params(level1)
    del params["modality_2"]
    trainer = Trainer(Config(params, results_root=str(tmp_path)), device="cpu",
                      enable_viz=False)
    assert type(trainer.model).__name__ == "UnimodalVAE"
    jcfg = JConfig(params, results_root=str(tmp_path / "j"))
    JDataModule(jcfg).setup()
    assert type(jbuild_model(jcfg)).__name__ == "UnimodalVAE"
    metrics = trainer.fit(log_fn=None)
    assert np.isfinite(metrics["train_loss"]) and "train_reconstruction_loss_mod_1" in metrics
    again = Trainer(Config(dict(params, pre_trained=trainer.cfg.mPath),
                           results_root=str(tmp_path / "again")), device="cpu",
                    enable_viz=False).init_state()
    for (name, x), y in zip(trainer.model.state_dict().items(),
                            again.model.state_dict().values()):
        assert torch.equal(x, y), name
    engine = InferenceEngine(MultimodalVAEInfer(trainer.cfg.mPath, device="cpu"), device="cpu")
    out = engine.generate({"mod_1": {"data": np.random.default_rng(0).random(
        (3, 64, 64, 3), dtype=np.float32)}})
    assert list(out) == ["mod_1"] and np.asarray(out["mod_1"]).shape == (3, 64, 64, 3)
