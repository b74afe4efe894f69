"""VILANRO in the port against the JAX package, on the CPU.

The port's copy of the LANRO simulator and collector writes the JAX
collector's files byte for byte and steps, rewards and scores the scripted
rollouts as the JAX env does; the ``VILANRO`` dataset gives JAX's arrays,
masks, codebook, feature dims and decoded outputs for every modality type;
``optimal_sigma`` gives JAX's value and gradient; ``Enc_Transformer`` and
``Dec_Transformer`` at full width give JAX's outputs from carried weights;
``configs/config_vilanro.yml`` and ``round3/vilanro_r3_tokens.yml``, built
by both packages at bs 4 with the same weights and draws, give JAX's loss,
metrics and gradients; the closed loop gives JAX's stats and stats file
from the same decoded trajectories, and its calibration gain from carried
weights; the probe's fits agree with sklearn's.  All 13 first-slice
VILANRO configs build, and the port's entry points (collector, DAgger
round, closed loop, probe) run end to end with ``--device cpu``.

Tolerances: the collector's files and the dataset's arrays exactly;
``optimal_sigma`` within 1e-6; the nets' outputs within 1e-5; loss and
metrics within rtol 1e-5 (sums of ~1e5 whose optimal sigma is itself a
mean over every decoded pixel), every gradient within 1e-4 of its leaf's
max |g| + 1e-5; the closed-loop stats exactly; the calibration gain within
1e-5; the ridge R^2 within 1e-6 of sklearn's and the logistic accuracy
equal.
"""
import filecmp
import functools
import os
import pickle
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
from multimodal_vae_comparison_tpu.eval import infer as jinfer
from multimodal_vae_comparison_tpu.eval import vilanro_test as jvt
from multimodal_vae_comparison_tpu.lanro import collect as jcollect
from multimodal_vae_comparison_tpu.lanro import env as jenv
from multimodal_vae_comparison_tpu.models import decoders as jdecoders
from multimodal_vae_comparison_tpu.models import distributions as jdist
from multimodal_vae_comparison_tpu.models import encoders as jencoders
from multimodal_vae_comparison_tpu.models import objectives as jobj
from multimodal_vae_comparison_tpu.training.trainer import build_model as jbuild_model
from multimodal_vae_comparison_tpu_torch.bridge import load_flax_params
from multimodal_vae_comparison_tpu_torch.config import Config
from multimodal_vae_comparison_tpu_torch.data import datasets
from multimodal_vae_comparison_tpu_torch.data.datamodule import DataModule
from multimodal_vae_comparison_tpu_torch.eval import infer, vilanro_probe, vilanro_test
from multimodal_vae_comparison_tpu_torch.lanro import collect, env
from multimodal_vae_comparison_tpu_torch.models import decoders, encoders, distributions
from multimodal_vae_comparison_tpu_torch.models import objectives
from multimodal_vae_comparison_tpu_torch.ops.kernels import telemetry
from multimodal_vae_comparison_tpu_torch.training.trainer import (
    Trainer, build_model_from_config)
from test_torch_slice import one_torch_thread  # noqa: F401 (autouse)
from test_torch_zoo import draw_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_jit = functools.partial(jax.jit, compiler_options={"xla_backend_optimization_level": 0})
LOSS_RTOL = 1e-5
GRAD_REL, GRAD_ATOL = 1e-4, 1e-5
NET_TOL = dict(rtol=1e-5, atol=1e-5)
STEMS = ("instructions_final.pkl", "endeff_actions_final.pkl", "image_final.pkl")
# the collector's option sets: (tag, keyword arguments), 20 episodes each
COLLECT = (("default", {}), ("chunk5", {"chunk_every": 5}), ("waypoints", {"waypoints": True}),
           ("noise", {"noise": 0.1}), ("size128", {"img_size": 128}))
# the 13 first-slice configs
CONFIGS = ("configs/config_vilanro.yml",
           *(f"configs/round2/config_vilanro_r2{s}.yml"
             for s in ("", "_ax8", "_big", "_dagger", "_dart", "_dense", "_init")),
           *(f"configs/round3/vilanro_r3_{s}.yml"
             for s in ("cont_p2", "tokens", "tokens_p2", "way_p2", "way_p2b")))


@pytest.fixture(scope="module")
def collected(tmp_path_factory):
    """{tag: (port's directory, JAX's directory)}: each option set of
    COLLECT collected by both packages at seed 3."""
    root = tmp_path_factory.mktemp("vilanro")
    out = {}
    for tag, kw in COLLECT:
        dirs = []
        for side, module in (("port", collect), ("jax", jcollect)):
            d = str(root / side / tag)
            stats = module.collect("NLReach2-v0", 20, d, seed=3, **kw)
            assert stats["episodes"] == 20
            dirs.append(d)
        out[tag] = tuple(dirs)
    return out


# -- the simulator and the collector ---------------------------------------------


@pytest.mark.parametrize("tag", [t for t, _ in COLLECT])
def test_collector_writes_jax_files_byte_for_byte(collected, tag):
    port_dir, jax_dir = collected[tag]
    names = sorted(os.listdir(jax_dir))
    assert sorted(os.listdir(port_dir)) == names == sorted(STEMS + ("vocab.txt",))
    for name in names:
        assert filecmp.cmp(os.path.join(port_dir, name), os.path.join(jax_dir, name),
                           shallow=False), name


@pytest.mark.parametrize("env_id", ["NLReach2-v0", "NLPush3-v0", "NLLift2-v0", "NLLeft2-v0",
                                    "Slide-v0", "Stack2-v0", "PickAndPlace-v0",
                                    "PandaNLReach2-v0"])
def test_env_steps_rewards_and_success_equal_jax(env_id):
    """A scripted rollout of 40 steps in each package: the same frames,
    end-effector, reward, done and success at every step, and the same
    goal distance at the end."""
    a, b = env.make(env_id, seed=5, img_size=64), jenv.make(env_id, seed=5, img_size=64)
    oa, ob = a.reset(), b.reset()
    assert oa["instruction"] == ob["instruction"]
    np.testing.assert_array_equal(oa["rgb"], ob["rgb"])
    for _ in range(40):
        act = collect.scripted_policy(a)
        np.testing.assert_array_equal(act, jcollect.scripted_policy(b))
        (oa, ra, da, ia), (ob, rb, db, ib) = a.step(act), b.step(act)
        np.testing.assert_array_equal(oa["rgb"], ob["rgb"])
        np.testing.assert_array_equal(oa["ee"], ob["ee"])
        assert (ra, da, ia) == (rb, db, ib)
        assert a.is_success() == b.is_success()
        if da:
            break
    assert a._goal_distance() == b._goal_distance()


# -- the dataset -----------------------------------------------------------------


@pytest.fixture(scope="module")
def attributes(collected, tmp_path_factory):
    """The default collection with an attribute file and vocab_atts.txt
    beside it: each row two words of the attribute vocabulary."""
    d = tmp_path_factory.mktemp("atts")
    for name in os.listdir(collected["default"][0]):
        with open(os.path.join(collected["default"][0], name), "rb") as f, \
                open(d / name, "wb") as g:
            g.write(f.read())
    vocab = ["red", "green", "blue", "cube", "sphere", "cylinder"]
    (d / "vocab_atts.txt").write_text("\n".join(vocab) + "\n")
    rng = np.random.default_rng(7)
    rows = [[vocab[i] for i in rng.integers(0, 6, 2)] for _ in range(20)]
    with open(d / "atts.pkl", "wb") as f:
        pickle.dump(rows, f)
    return str(d)


# (mod_type, train collection, file) and whether the test split loads first:
# the sequence length and the token codebook are fitted on train and frozen
DATASET_CASES = [("front RGB", "default", STEMS[2], False),
                 ("front RGB", "size128", STEMS[2], False),
                 ("language", "default", STEMS[0], False),
                 ("language", "default", STEMS[0], True),
                 ("actions", "default", STEMS[1], False),
                 ("action_tokens", "default", STEMS[1], False),
                 ("action_tokens", "default", STEMS[1], True),
                 ("action_waypoints", "waypoints", STEMS[1], False),
                 ("objects", "atts", "atts.pkl", False),
                 ("shapes", "atts", "atts.pkl", False),
                 ("colors", "atts", "atts.pkl", False)]


@pytest.mark.parametrize("mod_type,source,stem,test_first", DATASET_CASES)
def test_dataset_gives_jax_arrays_masks_codebook_and_decodes(collected, attributes, mod_type,
                                                             source, stem, test_first):
    """Train (the collection) and test (the chunk-5 collection's file)
    arrays and masks, the feature dims, the action codebook, the labels
    and the decoded output equal the JAX class's."""
    d = attributes if source == "atts" else collected[source][0]
    path = os.path.join(d, stem)
    test = None if source in ("atts", "size128") else os.path.join(
        collected["waypoints" if source == "waypoints" else "chunk5"][0], stem)
    got = datasets.get_dataset_class("vilanro")(path, test, mod_type)
    want = jdatasets.get_dataset_class("vilanro")(path, test, mod_type)
    assert got.vocab == want.vocab and got.vocab_atts == want.vocab_atts
    for split in (("test", "train") if test_first else ("train", "test")):
        (gd, gm), (wd, wm) = got.get_data(split), want.get_data(split)
        assert gd.dtype == wd.dtype == np.float32
        np.testing.assert_array_equal(gd, wd)
        assert (gm is None) == (wm is None)
        if gm is not None:
            np.testing.assert_array_equal(gm, wm)
        assert got.feature_dims == want.feature_dims
        assert got.labels() == want.labels()
        if mod_type == "action_tokens":
            np.testing.assert_array_equal(got.action_bin_centers, want.action_bin_centers)
        out = got.decode_output(gd[:5], None if gm is None else gm[:5])
        ref = want.decode_output(wd[:5], None if wm is None else wm[:5])
        if isinstance(ref, list):
            assert out == ref
        else:
            np.testing.assert_array_equal(out, ref)
    assert got.get_forbidden_subsets() == want.get_forbidden_subsets() == []
    if mod_type == "front RGB":
        assert got.feature_dims["front RGB"] == [int(source[4:]) if source != "default"
                                                 else 64] * 2 + [3]
    if mod_type == "action_tokens":
        assert gd.shape[1:] == (100, 4, 41)


def test_vilanro_is_ported_and_the_others_still_raise():
    """VILANRO resolves, and since item 7d so does every other dataset name
    of the JAX package; an unknown one raises."""
    assert datasets.get_dataset_class("VILANRO") is datasets.VILANRO
    assert datasets.get_dataset_class("polymnist") is datasets.POLYMNIST
    with pytest.raises(KeyError, match="vilanro"):
        datasets.get_dataset_class("imagenet")


# -- optimal_sigma ---------------------------------------------------------------


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("lead", [(), (3,)])
def test_optimal_sigma_value_and_gradient_match_jax(masked, lead):
    """Value and gradient in the decoder mean, with and without a step
    mask (the mean over valid positions only), over (lead..., B=4, T=9,
    A=4); and the softclip at -6 where the error is tiny."""
    rng = np.random.default_rng(8)
    mean = rng.normal(size=lead + (4, 9, 4)).astype(np.float32)
    target = rng.normal(size=(4, 9, 4)).astype(np.float32)
    mask = np.arange(9)[None] < np.array([[2], [5], [9], [1]]) if masked else None
    bnd = len(lead) + 1
    for scale in (1.0, 1e-4):   # the second: log sigma below the softclip
        m = target + scale * (mean - target)
        tm = torch.from_numpy(m).requires_grad_()
        got = objectives.recon_log_prob(
            "optimal_sigma", distributions.Normal(tm, torch.tensor(0.75)),
            torch.from_numpy(target), None if mask is None else torch.from_numpy(mask), bnd)
        got.sum().backward()

        def f(x):
            return jobj.recon_log_prob("optimal_sigma", jdist.Normal(x, jnp.asarray(0.75)),
                                       jnp.asarray(target),
                                       None if mask is None else jnp.asarray(mask), bnd)

        want, vjp = jax.vjp(f, jnp.asarray(m))
        assert got.shape == lead + (4,)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6 * np.abs(np.asarray(want)).max())
        g = np.asarray(vjp(jnp.ones_like(want))[0])
        np.testing.assert_allclose(tm.grad.numpy(), g, rtol=1e-6,
                                   atol=1e-6 * np.abs(g).max())


def test_softclip_matches_jax():
    x = np.linspace(-20, 5, 101, dtype=np.float32)
    np.testing.assert_allclose(objectives.softclip(torch.from_numpy(x), -6.0).numpy(),
                               np.asarray(jobj.softclip(jnp.asarray(x), -6.0)), rtol=1e-6)


def _recon_loss_config(tmp_path, loss):
    with open(os.path.join(REPO, CONFIGS[0])) as f:
        params = yaml.safe_load(f)
    params["modality_2"]["recon_loss"] = loss
    cfg = Config(params, results_root=str(tmp_path), eval_only=True)
    for m, dims in zip(cfg.mods, ([4, 12], [100, 4], [64, 64, 3])):
        m.feature_dims = dims
    return cfg


def test_build_refuses_an_unported_recon_loss_at_build_time(tmp_path):
    """Every loss of the JAX package builds through build_model_from_config
    (``feature_loss``, ported since item 8, and ``lprob``, since item 7d);
    an unknown loss raises KeyError at build time."""
    cfg = _recon_loss_config(tmp_path, "feature_loss")
    assert build_model_from_config(cfg, device="cpu").specs[1].recon_loss == "feature_loss"
    cfg.mods[1].recon_loss = "lprob"
    assert build_model_from_config(cfg, device="cpu").specs[1].recon_loss == "lprob"
    cfg.mods[1].recon_loss = "no_such_loss"
    with pytest.raises(KeyError, match="no_such_loss"):
        build_model_from_config(cfg, device="cpu")


# -- the nets --------------------------------------------------------------------


def _actions(collected, n=4):
    ds = datasets.VILANRO(os.path.join(collected["default"][0], STEMS[1]), None, "actions")
    data, masks = ds.get_data()
    return data[:n], masks[:n]


@pytest.mark.parametrize("kind,dims", [("enc", (100, 4)), ("enc", (100, 4, 41)),
                                       ("dec", (100, 4)), ("dec", (100, 4, 41))],
                         ids=["enc-actions", "enc-tokens", "dec-actions", "dec-tokens"])
def test_transformer_nets_match_jax_at_full_width(collected, kind, dims):
    """Enc_Transformer (8 layers, ff 1024, 2 heads, d_model 32) and
    Dec_Transformer (4 layers) at 32 latents, bs 4, on the collected
    trajectories' own step masks, with the JAX parameters carried through
    the bridge: the outputs within 1e-5."""
    data, masks = _actions(collected)
    rng = np.random.default_rng(9)
    if len(dims) == 3:
        data = np.eye(41, dtype=np.float32)[rng.integers(0, 41, (4,) + dims[:2])]
    if kind == "enc":
        jnet = jencoders.Enc_Transformer(latent_dim=32, data_dim=dims)
        args = (jnp.asarray(data), jnp.asarray(masks))
        net = encoders.get_encoder("Transformer")(32, dims)
        targs = (torch.from_numpy(data), torch.from_numpy(masks))
    else:
        z = rng.normal(size=(4, 32)).astype(np.float32)
        jnet = jdecoders.Dec_Transformer(latent_dim=32, data_dim=dims)
        args = (jnp.asarray(z), jnp.asarray(masks))
        net = decoders.get_decoder("Transformer")(32, dims)
        targs = (torch.from_numpy(z), torch.from_numpy(masks))
    shapes = jax.eval_shape(lambda: jnet.init(jax.random.PRNGKey(0), *args))
    params = draw_params(shapes, 1)
    load_flax_params(net, params)
    want = jnet.apply(params, *args)
    with torch.no_grad():
        got = net(*targs)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **NET_TOL)
    if kind == "dec":
        assert got[0].shape == (4,) + dims and not got[0][~torch.from_numpy(masks)].any()
        assert net.d_model == 32 and not hasattr(net, "Dense_0")
    else:
        assert net.d_model == 32 and net.skel_embedding.in_features == int(np.prod(dims[1:]))


# -- the slice: two configs, both packages ----------------------------------------------


def _config_params(path, data_dir, **over):
    with open(os.path.join(REPO, path)) as f:
        params = yaml.safe_load(f)
    for i, stem in enumerate(STEMS):
        params[f"modality_{i + 1}"].update(path=os.path.join(data_dir, stem),
                                           test_datapath=None)
    params.update(over)
    return params


class _Recorder:
    """Patch the JAX Normal.rsample to keep each standard-normal draw."""

    def __init__(self, monkeypatch):
        self.draws = []

        def rsample(dist, key, sample_shape=()):
            shape = tuple(sample_shape) + jnp.shape(dist.loc)
            eps = jax.random.normal(key, shape, dtype=jnp.result_type(dist.loc))
            self.draws.append(eps)
            return dist.loc + eps * dist.scale

        monkeypatch.setattr(jdist.Normal, "rsample", rsample)


def _pair(path, data_dir, tmp_path, **over):
    """(port config, JAX config, port DataModule, JAX DataModule, JAX model,
    flax params, port model with them) of ``path`` on ``data_dir``."""
    params = _config_params(path, data_dir, **over)
    cfg = Config(params, results_root=str(tmp_path / "port"))
    jcfg = JConfig(params, results_root=str(tmp_path / "jax"))
    dm, jdm = DataModule(cfg), JDataModule(jcfg)
    dm.setup()
    jdm.setup()
    assert dm.feature_dims() == jdm.feature_dims()
    jmodel = jbuild_model(jcfg)
    jb = jax.tree_util.tree_map(jnp.asarray, next(jdm.batches("train")))
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)}, jb,
        method=jmodel.objective))
    flax_params = draw_params(shapes, 2)
    model = build_model_from_config(cfg, device="cpu")
    load_flax_params(model, flax_params)
    return cfg, jcfg, dm, jdm, jmodel, flax_params, model


def _torch_batch(batch):
    return {n: {"data": torch.from_numpy(m["data"]),
                "masks": None if m["masks"] is None else torch.from_numpy(m["masks"])}
            for n, m in batch.items()}


@pytest.mark.parametrize("path", [CONFIGS[0], "configs/round3/vilanro_r3_tokens.yml"])
def test_config_objective_loss_metrics_and_grads_match_jax(collected, tmp_path, monkeypatch,
                                                           path):
    """The config's POE objective (7 subsets; optimal_sigma or category_ce
    on the actions) at bs 4 on collected rows, the port fed JAX's draws:
    loss and metrics within rtol 1e-5, every gradient within 1e-4 of its
    leaf's max |g| + 1e-5; the kernels' plain versions run as chip_smoke.py
    counts them."""
    cfg, jcfg, dm, jdm, jmodel, params, model = _pair(path, collected["chunk5"][0], tmp_path,
                                                      batch_size=4)
    batch = next(dm.batches("train"))
    rec = _Recorder(monkeypatch)
    jb = jax.tree_util.tree_map(jnp.asarray, next(jdm.batches("train")))

    def loss_fn(p):
        rec.draws.clear()
        loss, metrics = jmodel.apply(p, jb, rngs={"sample": jax.random.PRNGKey(5)},
                                     method=jmodel.objective)
        return loss, (metrics, list(rec.draws))

    (jloss, (jmetrics, draws)), jgrads = _jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    assert len(draws) == 7
    telemetry.reset()
    loss, metrics = model.objective(_torch_batch(batch),
                                    eps=[torch.from_numpy(np.array(d)) for d in draws])
    loss.backward()
    cs = _chip_smoke()
    assert {k.split(":")[0]: n for k, n in telemetry.summary().items()} == {
        **cs.VILANRO_PER_OBJECTIVE["poe"], **cs.VILANRO_PER_BACKWARD["poe"]}
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=LOSS_RTOL)
    assert sorted(metrics) == sorted(jmetrics)
    for k in metrics:
        np.testing.assert_allclose(metrics[k].item(), float(jmetrics[k]), rtol=LOSS_RTOL)
    want = build_model_from_config(cfg, device="cpu")
    load_flax_params(want, jax.tree_util.tree_map(np.asarray, jgrads))
    for (name, p), g in zip(model.named_parameters(), want.parameters()):
        got = torch.zeros_like(p) if p.grad is None else p.grad
        err = (got - g).abs().max().item()
        limit = GRAD_REL * g.abs().max().item() + GRAD_ATOL
        assert err <= limit, f"{name}: max abs error {err:.3e} > {limit:.3e}"


# -- the closed loop -------------------------------------------------------------


def _fake_exp(cls, ds_cls, data_dir, act_type, trajectories, tensor, tmp_path, tag):
    """A ``MultimodalVAEInfer`` of ``cls`` over the three modalities of
    ``data_dir`` (language, ``act_type``, front RGB) whose forward decodes
    one of ``trajectories`` per row, picked by the row's pixels and words
    (the same in both packages), as a tensor or an array; its train split is
    the collection's first 16 rows."""
    names = ("mod_1", "mod_2", "mod_3")
    types_ = ("language", act_type, "front RGB")
    dsets = [ds_cls(os.path.join(data_dir, s), None, t) for s, t in zip(STEMS, types_)]
    arrays = [d.get_data() for d in dsets]
    mods = [types.SimpleNamespace(name=n, mod_type=t, feature_dims=list(a[0].shape[1:]))
            for n, t, a in zip(names, types_, arrays)]
    exp = cls.__new__(cls)
    exp.config = types.SimpleNamespace(mods=mods)
    exp.datamod = types.SimpleNamespace(datasets=dsets)
    exp.run_dir = str(tmp_path / tag)
    os.makedirs(exp.run_dir)

    def forward(inputs, present):
        assert present == ("mod_3", "mod_1")
        img, lang = inputs["mod_3"]["data"], inputs["mod_1"]["data"]
        pick = (np.round(img.reshape(len(img), -1).sum(1) * 7).astype(np.int64)
                + lang.argmax(-1).sum(1)) % len(trajectories)
        mean = trajectories[pick][None]
        mean = torch.from_numpy(mean) if tensor else mean
        return types.SimpleNamespace(mods={"mod_2": types.SimpleNamespace(
            decoder_dist=types.SimpleNamespace(mean=mean))})

    def get_test_samples(n, split="test", seed=0):
        assert split == "train"
        return {nm: {"data": a[0][:n], "masks": a[1] if a[1] is None else a[1][:n]}
                for nm, a in zip(names, arrays)}, None

    exp.forward, exp.get_test_samples = forward, get_test_samples
    return exp


@pytest.mark.parametrize("act_type,source,replan,calibrate", [
    ("actions", "default", 0, False), ("actions", "chunk5", 5, True),
    ("action_tokens", "chunk5", 0, False), ("action_waypoints", "waypoints", 5, True)])
def test_closed_loop_stats_and_file_equal_jax(collected, tmp_path, monkeypatch, act_type,
                                              source, replan, calibrate):
    """``vilanro_test``'s CLI over 12 trials, open loop or replanning every
    5 steps, with and without the train-split calibration gain: the stats
    printed and the stats file equal JAX's when both are fed the same
    decoded trajectories (the collection's own, the tokens as their
    scores)."""
    d = collected[source][0]
    results = {}
    for side, module, ds_cls, infer_mod, tensor in (
            ("jax", jvt, jdatasets.VILANRO, jinfer, False),
            ("port", vilanro_test, datasets.VILANRO, infer, True)):
        bank = ds_cls(os.path.join(d, STEMS[1]), None, act_type).get_data()[0]
        exp = _fake_exp(infer_mod.MultimodalVAEInfer, ds_cls, d, act_type, bank, tensor,
                        tmp_path, side)
        monkeypatch.setattr(infer_mod, "MultimodalVAEInfer", lambda *a, _e=exp, **k: _e)
        argv = ["vilanro_test", "--model", exp.run_dir, "--trials", "12", "--replan",
                str(replan)] + (["--calibrate"] if calibrate else [])
        monkeypatch.setattr(sys, "argv", argv + (["--device", "cpu"] if side == "port" else []))
        printed = []
        monkeypatch.setattr("builtins.print", lambda *a, **k: printed.append(" ".join(map(str, a))))
        module.main()
        monkeypatch.undo()
        name = f"vilanro_NLReach2-v0_replan{replan}" + ("_cal" if calibrate else "")
        with open(os.path.join(exp.run_dir, f"{name}_stats.txt")) as f:
            results[side] = ([line for line in printed if exp.run_dir not in line], f.read())
    assert results["port"] == results["jax"]
    assert "success_rate" in results["port"][1]


def test_calibration_gain_agrees_from_carried_weights(collected, tmp_path, monkeypatch):
    """``endpoint_calibration_gain`` of config_vilanro.yml's model in both
    packages, the same weights and (recorded) draws, on the first 16 train
    rows: the gains within 1e-5."""
    cfg, jcfg, dm, jdm, jmodel, params, model = _pair(CONFIGS[0], collected["chunk5"][0],
                                                      tmp_path, batch_size=4)
    jexp = jinfer.MultimodalVAEInfer.__new__(jinfer.MultimodalVAEInfer)
    jexp.model, jexp.params, jexp.config, jexp.datamod = jmodel, params, jcfg, jdm
    exp = infer.MultimodalVAEInfer.__new__(infer.MultimodalVAEInfer)
    exp.model, exp.config, exp.datamod, exp.device = model, cfg, dm, torch.device("cpu")
    model.eval()
    rec = _Recorder(monkeypatch)
    want = jvt.endpoint_calibration_gain(jexp, "mod_3", "mod_1", "mod_2", False, n=16)
    (draw,) = rec.draws
    forward = exp.forward
    exp.forward = lambda inputs, present: forward(
        inputs, present, eps=torch.from_numpy(np.array(draw)))
    got = vilanro_test.endpoint_calibration_gain(exp, "mod_3", "mod_1", "mod_2", False, n=16)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert 1.0 <= got <= 10.0


# -- the probe ---------------------------------------------------------------------


def _probe_data(n=400, d=32, k=6, seed=10):
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(n, d)).astype(np.float32)
    y = (z[:, :k] * 0.3 + rng.normal(size=(n, k)) * 0.5).astype(np.float32)
    return z, y


def test_ridge_r2_matches_sklearn():
    """The held-out ridge R^2 (alpha 1, intercept, uniform mean over
    targets) on the probe's own size: 400 scenes, 32 latents, 6 targets."""
    sklearn = pytest.importorskip("sklearn")
    from sklearn.linear_model import Ridge
    from sklearn.metrics import r2_score
    assert sklearn
    z, y = _probe_data()
    perm = np.random.default_rng(0).permutation(len(z))
    tr, te = perm[:320], perm[320:]
    want = r2_score(y[te], Ridge(alpha=1.0).fit(z[tr], y[tr]).predict(z[te]))
    assert abs(vilanro_probe._ridge_r2(z, y) - want) <= 1e-6


@pytest.mark.parametrize("classes", [2, 3, 6])
def test_logistic_accuracy_matches_sklearn(classes):
    """The held-out accuracy of L2 logistic regression (C 1; multinomial,
    binary for two classes) equals sklearn's LogisticRegression's, and the
    weights agree to the solvers' tolerance."""
    pytest.importorskip("sklearn")
    from sklearn.linear_model import LogisticRegression
    z, _ = _probe_data(seed=11)
    rng = np.random.default_rng(12)
    score = z[:, 0] * 2 + z[:, 1] + rng.normal(size=len(z))
    y = score.argsort().argsort() * classes // len(z)
    perm = np.random.default_rng(0).permutation(len(z))
    tr, te = perm[:320], perm[320:]
    ref = LogisticRegression(max_iter=2000).fit(z[tr], y[tr])
    assert vilanro_probe._logreg_acc(z, y) == ref.score(z[te], y[te])
    _, w, b = vilanro_probe.logreg_fit(z[tr], y[tr])
    np.testing.assert_allclose(w.T, ref.coef_, atol=1e-2)


def test_ridge_fits_a_constant_target_exactly():
    """A target constant over the rows (the objects' heights on the table)
    gets w = 0 and the constant as intercept, and scores 1; one the fit
    misses scores 0."""
    z, y = _probe_data(n=50, k=3)
    y[:, 2] = np.float32(0.02)
    w, b = vilanro_probe.ridge_fit(z, y)
    assert not w[:, 2].any() and b[2] == np.float32(0.02)
    pred = z.astype(np.float64) @ w + b
    assert vilanro_probe.r2_score(y[:, 2:], pred[:, 2:]) == 1.0
    assert vilanro_probe.r2_score(y[:, 2:], pred[:, 2:] + 1e-9) == 0.0


# -- the configs and chip_smoke's tables ------------------------------------------------


@pytest.mark.parametrize("path", CONFIGS)
def test_first_slice_configs_build(path):
    """Each config builds with ``eval_only`` on its data's feature dims: a
    trimodal POE (TxtTransformer language, Transformer actions, CNN2 / CNN
    images) whose parameters the JAX package's model fills leaf for leaf."""
    cfg, jcfg = (cls(os.path.join(REPO, path), eval_only=True) for cls in (Config, JConfig))
    tokens = cfg.mods[1].mod_type == "action_tokens"
    for c in (cfg, jcfg):
        for m, dims in zip(c.mods, ([4, 12], [100, 4, 41] if tokens else [100, 4],
                                    [64, 64, 3])):
            m.feature_dims = dims
    model = build_model_from_config(cfg, device="cpu")
    jmodel = jbuild_model(jcfg)
    assert type(model).__name__ == type(jmodel).__name__ == "POE"
    assert [s.encoder for s in model.specs] == ["TxtTransformer", "Transformer", "CNN2"]
    assert [s.recon_loss for s in model.specs] == [s.recon_loss for s in jmodel.specs]
    assert [s.llik_scaling for s in model.specs] == [s.llik_scaling for s in jmodel.specs]
    batch = {m.name: {"data": jax.ShapeDtypeStruct((2, *m.feature_dims), jnp.float32),
                      "masks": None if m.mod_type == "front RGB"
                      else jax.ShapeDtypeStruct((2, m.feature_dims[0]), jnp.bool_)}
             for m in jcfg.mods}
    shapes = jax.eval_shape(lambda b: jmodel.init(
        {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)}, b,
        method=lambda m, x: m.forward(x, tuple(x))), batch)
    load_flax_params(model, jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                                                   shapes))


def _chip_smoke():
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    return chip_smoke


@pytest.mark.parametrize("present", [("mod_3", "mod_1"), ("mod_3",), ("mod_1",)])
def test_chip_smoke_forward_launches_hold_on_the_cpu(collected, tmp_path, present):
    """chip_smoke.py's vilanro_forward_launches: an inference forward of the
    closed loop, the probe or the DAgger round (every modality decoded)
    takes the kernels' plain versions exactly that many times."""
    _, _, dm, *_, model = _pair(CONFIGS[0], collected["default"][0], tmp_path, batch_size=4)
    exp = infer.MultimodalVAEInfer.__new__(infer.MultimodalVAEInfer)
    exp.model, exp.device = model, torch.device("cpu")
    model.eval()
    batch = next(dm.batches("train"))
    telemetry.reset()
    out = exp.forward({n: batch[n] for n in present}, present=present)
    assert out.mods["mod_2"].decoder_dist.mean.shape == (1, 4, 100, 4)
    assert {k.split(":")[0]: n for k, n in telemetry.summary().items()} == \
        _chip_smoke().vilanro_forward_launches([present])


# -- the entry points, end to end on the CPU --------------------------------------------


def test_entry_points_run_on_the_cpu(collected, tmp_path, monkeypatch, capsys):
    """config_vilanro.yml (cut to bs 4) trained for 1 epoch through
    ``Trainer.fit`` on the chunk-5 collection, then from its run directory
    with ``--device cpu``: a DAgger round of 4 episodes mixed into the
    collection, ``vilanro_test`` replanning every 5 steps, and
    ``vilanro_probe`` on 20 scenes, each writing its files."""
    params = _config_params(CONFIGS[0], collected["chunk5"][0], batch_size=4)
    trainer = Trainer(Config(params, results_root=str(tmp_path)), device="cpu",
                      enable_viz=False)
    trainer.init_state()
    metrics = trainer.fit(epochs=1, log_fn=None)
    assert np.isfinite(metrics["train_loss"]) and np.isfinite(metrics["val_loss"])
    run = trainer.cfg.mPath
    monkeypatch.setattr(collect, "collect_dagger", functools.partial(
        collect.collect_dagger, batch=4, rollout_steps=3))
    out = str(tmp_path / "dagger")
    for module, argv in (
            (collect, ["--env", "NLReach2-v0", "--episodes", "4", "--out", out,
                       "--dagger_model", run, "--mix_dir", collected["chunk5"][0]]),
            (vilanro_test, ["--model", run, "--trials", "4", "--replan", "5"]),
            (vilanro_probe, ["--model", run, "--scenes", "20"])):
        monkeypatch.setattr(sys, "argv", [module.__name__] + argv + ["--device", "cpu"])
        module.main()
    printed = capsys.readouterr().out
    with open(os.path.join(out, STEMS[1]), "rb") as f:
        trajs = pickle.load(f)
    assert len(trajs) > 35 and "'mixed_from'" in printed
    for name in ("vilanro_NLReach2-v0_replan5", "vilanro_probe_NLReach2-v0"):
        with open(os.path.join(run, f"{name}_stats.txt")) as f:
            assert f.read().count("\n") >= 4
    assert "probe_lang_to_goal_color_acc" in printed
