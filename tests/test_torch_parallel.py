"""Multi-device training of the port on the CPU: gloo ranks against one
process and against the JAX package's step on the same mesh.

Two spawned groups (2 ranks on a ``("data",)`` mesh, 4 on a 2x2 ``("data",
"model")`` mesh) run every step job once, through a module fixture; the
tests read their results.  A rank steps on its block of the global batch
(``parallel/mesh.shard_batch``), and the step is the global batch's:

* the gradient, the loss and the metrics are the ranks' SUM (the loss sums
  over rows), so each equals the one-process step on the whole batch;
* the noise is drawn at the global shape and sliced (``parallel/rows.py``):
  from the same generator seed the N-rank step equals one process's, MOE
  DReG's importance weights and MoPoE's subset rows included;
* ``grad_accum`` 2 takes chunk g as the global rows g mod 2;
* ``optimal_sigma``'s sigma is the global batch's;
* on the 2x2 mesh the parameters are DTensors, sharded by the reference's
  megatron or infer rule, and each rank's shard has the JAX device's shape;
* the 2-rank data step and the 2x2 hybrid step with ``grad_accum`` 2 equal
  JAX's ``make_train_step`` on ``make_mesh(2)`` and ``make_mesh(4, ("data",
  "model"), (2, 2))``, on bridged weights and JAX's own draws;
* a rank's ``step_flops`` is 1/N of one process's.

Then ``dryrun_multichip`` at 2, 3 and 4 ranks, ``main --device cpu
--num_devices 2`` on ``configs/config_synthetic.yml`` against one process,
and the launcher's failures: a raising rank and a hung one each end the
launch within its deadline.  Gradients are held per leaf within 1e-4 of
the leaf's max |g| + 1e-5, losses and metrics within 1e-5 relative.
"""
import concurrent.futures
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from multimodal_vae_comparison_tpu.models import distributions as jdist
from multimodal_vae_comparison_tpu.models import get_mixing as jget_mixing
from multimodal_vae_comparison_tpu.models.base import ModalitySpec as JSpec
from multimodal_vae_comparison_tpu.parallel import mesh as jmesh
from multimodal_vae_comparison_tpu.parallel import tensor_sharding as jts
from multimodal_vae_comparison_tpu.training.trainer import TrainState
from multimodal_vae_comparison_tpu.training.trainer import make_train_step as jmake_train_step
from multimodal_vae_comparison_tpu_torch import bridge
from multimodal_vae_comparison_tpu_torch.config import Config
from multimodal_vae_comparison_tpu_torch.main import cli
from multimodal_vae_comparison_tpu_torch.models.base import ModalitySpec
from multimodal_vae_comparison_tpu_torch.ops import flops
from multimodal_vae_comparison_tpu_torch.parallel import dryrun
from multimodal_vae_comparison_tpu_torch.parallel import launch as plaunch
from multimodal_vae_comparison_tpu_torch.parallel import mesh as pmesh
from multimodal_vae_comparison_tpu_torch.parallel.dryrun import (
    StepJob, dryrun_multichip, flagship_specs, run_steps)
from multimodal_vae_comparison_tpu_torch.training.optim import make_optimizer
from multimodal_vae_comparison_tpu_torch.training.trainer import (
    Trainer, build_model, data_parallel_size, make_train_step)
from test_torch_slice import draw_params, numpy_batch, one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRAD_REL, GRAD_ATOL, METRIC_RTOL = 1e-4, 1e-5, 1e-5
SEQ, LATENTS = 12, 8
SMALL = dict(img=(64, 64, 3), seq=SEQ, latents=LATENTS, batch=4)
# a group's whole run; each launch ends well inside it or fails its tests
DEADLINE = 240.0


def _specs(**over):
    return tuple(ModalitySpec(**{**s.__dict__, **over.get(s.name, {})})
                 for s in flagship_specs(SEQ))


def _eps(seed, n_draws, B, K=1):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((K, B, LATENTS)).astype(np.float32) for _ in range(n_draws)]


def _jax_model():
    specs = tuple(JSpec(**{k: v for k, v in s.__dict__.items()}) for s in flagship_specs(SEQ))
    return jget_mixing("poe")(specs=specs, n_latents=LATENTS, obj="elbo")


def _replaying(monkeypatch, draws):
    """Patch JAX's Normal.rsample to take the objective's i-th draw from
    ``draws[i % len(draws)]``: every trace of the objective (the step's,
    and its chunk loop's, which XLA runs for each chunk) calls it once per
    subset, in the port's order."""
    calls = []

    def rsample(dist, key, sample_shape=()):
        eps = jnp.asarray(draws[len(calls) % len(draws)])
        calls.append(1)
        assert eps.shape == tuple(sample_shape) + jnp.shape(dist.loc)
        return dist.loc + eps * dist.scale

    monkeypatch.setattr(jdist.Normal, "rsample", rsample)


def _port_state(params):
    """A one-device port state dict (numpy) from flax params."""
    model = build_model(flagship_specs(SEQ), "poe", LATENTS, device="cpu")
    bridge.load_flax_params(model, params)
    return {k: v.numpy() for k, v in model.state_dict().items()}


def _jax_reference(mesh, params, batch, grad_accum, chunk_eps, shardings=None):
    """JAX's step (optax.sgd(1.0), so the update is the gradient) on ``mesh``
    with the draws ``chunk_eps`` in every chunk, and the same step's global
    draws in the port's form (chunk g's rows g mod G).  Returns (metrics,
    grads as a port state, the global draws)."""
    mp = pytest.MonkeyPatch()
    _replaying(mp, chunk_eps)
    try:
        tx = optax.sgd(1.0)
        p = (jts.apply_param_sharding(params, shardings) if shardings is not None
             else jmesh.shard_params(params, mesh))
        b = jmesh.shard_batch(jax.tree_util.tree_map(jnp.asarray, batch), mesh)
        state = TrainState(params=p, opt_state=tx.init(p), step=jnp.zeros((), jnp.int32))
        state, metrics = jmake_train_step(_jax_model(), tx, grad_accum=grad_accum)(
            state, b, jax.random.PRNGKey(0))
    finally:
        mp.undo()
    grads = jax.tree_util.tree_map(lambda a, b: np.asarray(a) - np.asarray(b),
                                   params, jax.device_get(state.params))
    return {k: float(v) for k, v in metrics.items()}, _port_state(grads)


def _global_eps(chunk_eps, grad_accum):
    out = []
    for e in chunk_eps:
        g = np.empty((e.shape[0], e.shape[1] * grad_accum) + e.shape[2:], e.dtype)
        for c in range(grad_accum):
            g[:, c::grad_accum] = e
        out.append(g)
    return out


@pytest.fixture(scope="module")
def bridged():
    """Flax params of the small flagship and their port state."""
    jmodel = _jax_model()
    jb = jax.tree_util.tree_map(jnp.asarray, numpy_batch(SMALL, 0))
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)}, jb,
        method=jmodel.objective))
    params = draw_params(shapes, 3)
    return params, _port_state(params)


# the JAX comparisons' draws: one (1, B/G, D) a subset, the same in each chunk
JAX_DATA_EPS, JAX_HYBRID_EPS = _eps(21, 3, 4), _eps(22, 3, 2)
FACTS_BATCH = {"m": {"data": np.arange(24).reshape(12, 2), "masks": None}}


def _jobs2(bridged):
    batch4, batch8 = numpy_batch(SMALL, 1), numpy_batch(dict(SMALL, batch=8), 2)
    sigma = _specs(mod_1={"recon_loss": "optimal_sigma"})
    return {
        "sum": StepJob(_specs(), batch4, eps=_eps(4, 3, 4)),
        "draws-poe": StepJob(_specs(), batch4, gen_seed=5),
        "draws-moe-dreg": StepJob(_specs(), batch4, mixing="moe", obj="dreg", K=2,
                                  gen_seed=6),
        "draws-mopoe": StepJob(_specs(), numpy_batch(dict(SMALL, batch=6), 3),
                               mixing="mopoe", gen_seed=7),
        "accum": StepJob(_specs(), batch8, eps=_eps(8, 3, 8), grad_accum=2),
        "sigma": StepJob(sigma, batch4, gen_seed=9),
        "flops": StepJob(_specs(), batch4, eps=_eps(4, 3, 4), flops=True),
        "jax-data": StepJob(_specs(), batch4, state=bridged[1], eps=JAX_DATA_EPS,
                            optimizer="sgd", lr=1.0),
        "dryrun": dryrun.dryrun_job(2),
    }


def _jobs4(bridged):
    full = numpy_batch(dict(SMALL, seq=45, latents=16), 4)
    return {
        "megatron": StepJob(flagship_specs(45), full, n_latents=16, shape=(2, 2),
                            axes=("data", "model"), sharding="megatron", min_size=1024,
                            gen_seed=11),
        "infer": StepJob(flagship_specs(45), full, n_latents=16, shape=(2, 2),
                         axes=("data", "model"), sharding="infer", min_size=2048,
                         gen_seed=12),
        "jax-hybrid": StepJob(_specs(), numpy_batch(SMALL, 5), state=bridged[1],
                              eps=_global_eps(JAX_HYBRID_EPS, 2), shape=(2, 2),
                              axes=("data", "model"), sharding="megatron", min_size=1024,
                              grad_accum=2, optimizer="sgd", lr=1.0),
        "dryrun": dryrun.dryrun_job(4),
    }


@pytest.fixture(scope="module")
def groups(bridged):
    """The two groups' results, run in a thread while this process computes
    the JAX references: ({job name: per-rank results}, the jobs, the mesh
    facts of each rank of each group, the JAX references)."""
    jobs2, jobs4 = _jobs2(bridged), _jobs4(bridged)
    old = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    ranks = {}

    def run():
        ranks[2] = plaunch.launch(run_steps, 2, list(jobs2.values()), FACTS_BATCH,
                                  device="cpu", deadline=DEADLINE)
        ranks[4] = plaunch.launch(run_steps, 4, list(jobs4.values()), FACTS_BATCH,
                                  device="cpu", deadline=DEADLINE)

    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        running = pool.submit(run)
        try:
            params = bridged[0]
            mesh4 = jmesh.make_mesh(4, ("data", "model"), (2, 2))
            refs = {"jax-data": _jax_reference(jmesh.make_mesh(2), params,
                                               numpy_batch(SMALL, 1), 1, JAX_DATA_EPS),
                    "jax-hybrid": _jax_reference(
                        mesh4, params, numpy_batch(SMALL, 5), 2, JAX_HYBRID_EPS,
                        jts.megatron_param_sharding(params, mesh4, min_size=1024))}
        finally:
            running.result()
            if old is None:
                del os.environ["OMP_NUM_THREADS"]
            else:
                os.environ["OMP_NUM_THREADS"] = old
    out = {name: [r[1][i] for r in ranks[2]] for i, name in enumerate(jobs2)}
    out.update({f"{name}4" if name == "dryrun" else name: [r[1][i] for r in ranks[4]]
                for i, name in enumerate(jobs4)})
    facts = {n: [r[0] for r in ranks[n]] for n in ranks}
    return out, {**jobs2, **{("dryrun4" if k == "dryrun" else k): v
                             for k, v in jobs4.items()}}, facts, refs


def one_process(job: StepJob):
    """The same job in this process on the whole batch: (metrics, grads)."""
    model = build_model(job.specs, job.mixing, job.n_latents, obj=job.obj, K=job.K,
                        seed=job.seed, device="cpu")
    if job.state is not None:
        model.load_state_dict({k: torch.from_numpy(v) for k, v in job.state.items()})
    step = make_train_step(model, make_optimizer(job.optimizer, job.lr, model.parameters()),
                           grad_accum=job.grad_accum)
    batch = {n: {k: None if v is None else torch.from_numpy(v) for k, v in m.items()}
             for n, m in job.batch.items()}
    eps = None if job.eps is None else [torch.from_numpy(e) for e in job.eps]
    if job.mixing == "moe" and eps is not None:
        eps = dict(zip(model.mod_names, eps))
    gen = torch.Generator().manual_seed(job.gen_seed)
    if job.flops:
        return flops.step_flops(step, batch, eps=eps, generator=gen)["flops"], None
    metrics = step(batch, eps=eps, generator=gen)
    return ({k: float(v) for k, v in metrics.items()},
            {n: None if p.grad is None else p.grad.numpy() for n, p in model.named_parameters()})


def _assert_grads(got, want, what):
    for name, w in want.items():
        g = got[name]
        if w is None:
            assert g is None or not np.any(g), f"{what} {name}"
            continue
        scale = np.abs(w).max()
        if name.endswith("key.bias"):
            # an exact zero gradient (softmax is shift-invariant per row):
            # rounding noise, held at its key weight's scale
            scale = np.abs(want[name[:-len("bias")] + "weight"]).max()
        err = np.abs(g - w).max()
        limit = GRAD_REL * scale + GRAD_ATOL
        assert err <= limit, f"{what} {name}: max abs error {err:.3e} > {limit:.3e}"


def _assert_metrics(got, want, what):
    assert sorted(got) == sorted(want), what
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=METRIC_RTOL, atol=1e-3,
                                   err_msg=f"{what} {k}")


def _ranks_agree(results):
    """Every rank reads the same global metrics and gradients."""
    for r in results[1:]:
        assert r["metrics"] == results[0]["metrics"]
        for n, g in results[0]["grads"].items():
            np.testing.assert_array_equal(r["grads"][n], g, err_msg=n)


# -- the mesh -------------------------------------------------------------------------


@pytest.mark.parametrize("n", [2, 4])
def test_make_mesh_shapes_and_each_ranks_rows(groups, n):
    """The default mesh is all data; a batch's dim 0 is cut into the ranks'
    contiguous blocks (``P("data")``); a shape that does not hold the ranks
    raises."""
    data = FACTS_BATCH["m"]["data"]
    if n == 2:
        blocks = [pmesh.local_rows(data, r, 3) for r in range(3)]
        np.testing.assert_array_equal(np.concatenate(blocks), data)
        np.testing.assert_array_equal(blocks[1], data[4:8])
        with pytest.raises(ValueError, match="equal blocks"):
            pmesh.local_rows(np.zeros(5), 0, 2)
    b = len(data) // n
    for r, f in enumerate(groups[2][n]):
        assert f["default"] == ((n,), ("data",))
        assert f["hybrid"] == ((1, n), ("data", "model"))
        assert f["coords"] == (r, n)
        assert f["replicated"] == ["Replicate", "Replicate"]
        assert "does not hold" in f["bad_shape"]
        np.testing.assert_array_equal(f["rows"], data[b * r:b * (r + 1)])


# -- the data-parallel step -------------------------------------------------------------


@pytest.mark.parametrize("name", ["sum", "accum"])
def test_data_step_is_the_one_process_step(groups, name):
    """2 ranks, injected global draws: the summed gradient, loss and metrics
    of the whole batch (``grad_accum`` 2: chunk g the rows g mod 2 of the
    global batch, as one device's ``x[g::2]``)."""
    results, jobs, _, _ = groups
    want_metrics, want_grads = one_process(jobs[name])
    _ranks_agree(results[name])
    _assert_metrics(results[name][0]["metrics"], want_metrics, name)
    _assert_grads(results[name][0]["grads"], want_grads, name)


def test_gradient_is_the_sum_not_the_mean_of_the_ranks(groups):
    """Each rank's own half-batch gradient is about half the whole; the
    step's is their sum (DDP's mean would be half the one-process grad)."""
    results, jobs, _, _ = groups
    job = jobs["sum"]
    halves = []
    for r in range(2):
        half = StepJob(job.specs, {n: {k: None if v is None else v[2 * r:2 * r + 2]
                                       for k, v in m.items()} for n, m in job.batch.items()},
                       eps=[e[:, 2 * r:2 * r + 2] for e in job.eps])
        halves.append(one_process(half)[1])
    total = {n: halves[0][n] + halves[1][n] for n in halves[0] if halves[0][n] is not None}
    _assert_grads({n: results["sum"][0]["grads"][n] for n in total}, total, "sum of halves")


@pytest.mark.parametrize("name", ["draws-poe", "draws-moe-dreg", "draws-mopoe"])
def test_draws_are_made_at_the_global_shape(groups, name):
    """From one generator seed on every rank, each rank keeps its rows of the
    global draw: the step equals one process's from the same seed (MOE
    DReG's importance weights and MoPoE's per-subset rows with it)."""
    results, jobs, _, _ = groups
    want_metrics, want_grads = one_process(jobs[name])
    _ranks_agree(results[name])
    _assert_metrics(results[name][0]["metrics"], want_metrics, name)
    _assert_grads(results[name][0]["grads"], want_grads, name)


def test_optimal_sigma_takes_the_global_mean(groups):
    """sigma is the whole batch's: the 2-rank step equals one process's,
    which a per-rank sigma would not."""
    results, jobs, _, _ = groups
    want_metrics, want_grads = one_process(jobs["sigma"])
    _ranks_agree(results["sigma"])
    _assert_metrics(results["sigma"][0]["metrics"], want_metrics, "sigma")
    _assert_grads(results["sigma"][0]["grads"], want_grads, "sigma")


def test_step_flops_per_rank_is_one_over_n(groups):
    """The counterpart of ``test_per_device_program_shrinks_with_mesh``:
    each rank's step counts half one process's FLOPs, exactly."""
    results, jobs, _, _ = groups
    f1, _ = one_process(jobs["flops"])
    assert [r["flops"] for r in results["flops"]] == [f1 // 2, f1 // 2] and f1 % 2 == 0


def test_data_step_equals_jax_on_its_data_mesh(groups):
    """2 ranks against JAX's ``make_train_step`` on ``make_mesh(2)``, from
    bridged weights on JAX's draws: the sgd(1.0) update is the gradient."""
    results = groups[0]
    jmetrics, jgrads = groups[3]["jax-data"]
    _assert_metrics(results["jax-data"][0]["metrics"], jmetrics, "jax-data")
    _assert_grads(results["jax-data"][0]["grads"], jgrads, "jax-data")


# -- the model axis --------------------------------------------------------------------


def test_hybrid_step_with_grad_accum_equals_jax(groups):
    """4 ranks on the 2x2 mesh, megatron-sharded (min_size 1024),
    ``grad_accum`` 2, against JAX's step on ``make_mesh(4, ("data",
    "model"), (2, 2))`` with the same shardings, and against the port's
    one-process ``grad_accum`` 2 step."""
    results, jobs, _, _ = groups
    jmetrics, jgrads = groups[3]["jax-hybrid"]
    _ranks_agree(results["jax-hybrid"])
    _assert_metrics(results["jax-hybrid"][0]["metrics"], jmetrics, "jax-hybrid")
    _assert_grads(results["jax-hybrid"][0]["grads"], jgrads, "jax-hybrid")
    want_metrics, want_grads = one_process(jobs["jax-hybrid"])
    _assert_metrics(results["jax-hybrid"][0]["metrics"], want_metrics, "one process")
    _assert_grads(results["jax-hybrid"][0]["grads"], want_grads, "one process")
    # the sgd(1.0) update of the sharded parameters, gathered, is the gradient
    start = jobs["jax-hybrid"].state
    for name, p in results["jax-hybrid"][0]["params"].items():
        np.testing.assert_allclose(p, start[name] - results["jax-hybrid"][0]["grads"][name],
                                   rtol=1e-6, atol=0, err_msg=name)


@pytest.mark.parametrize("rule,name", [("megatron", "megatron"), ("infer", "infer")])
def test_shard_shapes_equal_jax(groups, rule, name):
    """Every flagship parameter's shard on each rank of the 2x2 mesh has the
    shape of the JAX device's shard (mapped through the bridge's layout),
    and the sharded full-width step equals one process's."""
    results, jobs, _, _ = groups
    job = jobs[name]
    jmodel = jget_mixing("poe")(specs=tuple(JSpec(**s.__dict__) for s in job.specs),
                                n_latents=16, obj="elbo")
    jb = jax.tree_util.tree_map(jnp.asarray, job.batch)
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)}, jb,
        method=jmodel.objective))["params"]
    mesh = jmesh.make_mesh(4, ("data", "model"), (2, 2))
    fn = jts.megatron_param_sharding if rule == "megatron" else jts.infer_param_sharding
    shardings = fn(shapes, mesh, min_size=job.min_size)
    model = build_model(job.specs, "poe", 16, device="cpu")
    want, n_sharded = {}, 0
    for path, sh in jax.tree_util.tree_flatten_with_path(shardings)[0]:
        keys = [k.key for k in path]
        leaf = shapes
        for k in keys:
            leaf = leaf[k]
        local = sh.shard_shape(leaf.shape)
        n_sharded += local != leaf.shape
        *mod_path, name_ = keys
        module = model.get_submodule(".".join(mod_path))
        tname, arr = (bridge._convert(module, name_, np.empty(local))
                      if isinstance(module, bridge._LAYERS) else (name_, np.empty(local)))
        want[".".join(mod_path + [tname])] = tuple(arr.shape)
    assert n_sharded >= 4
    for r in results[name]:
        assert r["shard_shape"] == want
    want_metrics, want_grads = one_process(job)
    _assert_metrics(results[name][0]["metrics"], want_metrics, name)
    _assert_grads(results[name][0]["grads"], want_grads, name)


@pytest.mark.parametrize("n", [2, 3, 4])
def test_dryrun_multichip(n, groups, capsys, monkeypatch):
    """The reference's dry run: a (n/2, 2) hybrid mesh at even n >= 4, its
    big kernels megatron-sharded, else all data; one amsgrad step with
    grad_accum 2 on 2 rows a data rank; a finite loss.  At 3 ranks through
    the entry point, which prints JAX's line; at 2 and 4 its step in the
    groups above."""
    if n == 3:
        monkeypatch.setenv("OMP_NUM_THREADS", "1")
        loss = dryrun_multichip(n, device="cpu", deadline=DEADLINE)
        assert np.isfinite(loss)
        assert ("dryrun_multichip OK: mesh={'data': 3}, grad_accum=2, loss="
                in capsys.readouterr().out)
        return
    results, jobs, _, _ = groups
    name = "dryrun" if n == 2 else "dryrun4"
    job = jobs[name]
    assert (tuple(job.shape), tuple(job.axes)) == (((2,), ("data",)) if n == 2 else
                                                   ((2, 2), ("data", "model")))
    assert job.grad_accum == 2 and job.batch["mod_1"]["data"].shape[0] == 4
    assert job.sharding == (None if n == 2 else "megatron")
    for r in results[name]:
        assert np.isfinite(r["metrics"]["loss"])
        sharded = [k for k, shape in r["shard_shape"].items()
                   if shape != r["params"][k].shape]
        assert (len(sharded) >= 4) == (n == 4), sharded


# -- the Trainer ----------------------------------------------------------------------------


def test_main_trains_on_two_gloo_ranks_as_one_process(tmp_path, monkeypatch):
    """``main --device cpu --num_devices 2`` on the synthetic config, one
    epoch: rank 0 writes one run directory and checkpoint, which restores
    into a one-process model, and the val loss is a one-process run's."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    cfg = os.path.join(REPO, "configs", "config_synthetic.yml")
    assert cli(["--cfg", cfg, "--device", "cpu", "--num_devices", "2", "--epochs", "1",
                "--no_viz"]) is None
    runs = sorted((tmp_path / "results" / "synthetic_moe").iterdir())
    assert [r.name for r in runs] == ["version_0"]
    run = runs[0]
    ckpts = sorted(p.relative_to(run).as_posix() for p in run.rglob("state.pt"))
    assert ckpts == ["model/best/state.pt", "model/last/state.pt"]
    rows = (run / "metrics.csv").read_text().splitlines()
    assert len(rows) == 2
    logged = dict(zip(rows[0].split(","), map(float, rows[1].split(","))))

    config = Config(cfg, overrides={"epochs": 1}, results_root=str(tmp_path / "one"))
    assert data_parallel_size(config, "cpu") == 1
    trainer = Trainer(config, device="cpu", enable_viz=False)
    trainer.init_state()
    trainer.fit(log_fn=None)
    one = dict(zip(*[line.split(",") for line in
                     open(os.path.join(config.mPath, "metrics.csv")).read().splitlines()]))
    for k in ("train_loss", "val_loss", "val_kld"):
        np.testing.assert_allclose(logged[k], float(one[k]), rtol=METRIC_RTOL, err_msg=k)
    state = torch.load(run / "model" / "last" / "state.pt", weights_only=True)
    restored = build_model(trainer.model.specs, "moe", trainer.cfg.n_latents, device="cpu")
    restored.load_state_dict(state["params"])
    assert state["step"] == trainer.step
    for (name, p), q in zip(restored.named_parameters(), trainer.model.parameters()):
        if name.endswith("key.bias"):
            # its exact gradient is 0 and amsgrad normalizes each side's
            # rounding noise: a step moves it by up to lr either way
            assert (p - q).abs().max().item() <= 2 * config.lr * trainer.step, name
            continue
        torch.testing.assert_close(p, q, rtol=1e-4, atol=1e-5, msg=name)


def test_iterseeds_on_two_ranks_write_one_run_directory_a_seed(tmp_path, monkeypatch):
    """``iterseeds: 2`` on two gloo ranks: rank 0 makes each seed's run
    directory and the ranks agree on it (``reset_for_seed``), each seed
    training from its own weights into its own checkpoint."""
    import yaml
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    with open(os.path.join(REPO, "configs", "config_synthetic.yml")) as f:
        params = yaml.safe_load(f)
    params.update(iterseeds=2, batch_size=8)
    for i in (1, 2):
        params[f"modality_{i}"]["path"] = "48"
    with open(tmp_path / "cfg.yml", "w") as f:
        yaml.safe_dump(params, f)
    cli(["--cfg", str(tmp_path / "cfg.yml"), "--device", "cpu", "--num_devices", "2",
         "--epochs", "1", "--no_viz"])
    runs = sorted((tmp_path / "results" / "synthetic_moe").iterdir())
    assert [r.name for r in runs] == ["version_0", "version_1"]
    seeds = [yaml.safe_load(open(r / "config.yml"))["seed"] for r in runs]
    assert seeds == [1, 2]
    states = [torch.load(r / "model" / "last" / "state.pt", weights_only=True)["params"]
              for r in runs]
    assert all(len((r / "metrics.csv").read_text().splitlines()) == 2 for r in runs)
    assert any(not torch.equal(states[0][k], states[1][k]) for k in states[0])


def test_data_parallel_size_shrinks_to_divide_the_batch():
    cfg = type("C", (), {"num_devices": 4, "batch_size": 30})()
    assert data_parallel_size(cfg, "cpu") == 3
    cfg.num_devices = None
    assert data_parallel_size(cfg, "cpu") == 1


# -- the launcher -------------------------------------------------------------------------


def test_a_raising_rank_ends_the_launch_with_its_traceback():
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed") as err:
        plaunch.launch(dryrun.check_rank, 2, 1, "raise", device="cpu", deadline=60)
    assert "ValueError: rank 1 raised on purpose" in str(err.value)


def test_a_hung_rank_fails_at_the_deadline():
    """Rank 1 never joins the barrier rank 0 waits in: the parent kills both
    at its deadline and raises."""
    with pytest.raises(TimeoutError, match="did not end within 5"):
        plaunch.launch(dryrun.check_rank, 2, 1, "hang", device="cpu", deadline=5)


def test_nccl_needs_the_card():
    with pytest.raises(ValueError, match="NCCL needs the card"):
        plaunch.launch(dryrun.check_rank, 2, 1, "raise", device="cpu", backend="nccl")
