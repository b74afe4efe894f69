"""VILANRO's conditioned configs in the port against the JAX package, on
the CPU.

``Enc_CNNCoord``, ``Enc_CNNSpatial`` (64 and 128 px) and
``Dec_TransformerCond`` (with a padded instruction, unpadded, and without
conditioning) at full width give JAX's outputs and gradients from carried
weights; ``aux_endpoint_loss`` gives JAX's value; the POE objectives of
``round4/vilanro_r4_cond`` (per-subset conditioned decodes and the aux
term) and ``vilanro_r4b_spatial`` (``cond_always``: one shared decode) at
bs 4, the port fed JAX's draws, give JAX's loss, metrics and gradients, and
``round3/vilanro_r3_way_p2d`` (MOE, DReG K 5) does on JAX's importance
weights; the counterparts of the JAX package's own cases in
``tests/test_cond_decoder.py`` hold (the aux term never reaches the action
encoder, ``cond_always`` supplies the instruction on subsets without it);
the 5 configs build, and chip_smoke.py's launch tables hold.

Tolerances: the nets' outputs within 1e-5 and every gradient within 1e-4 of
its leaf's max |g| + 1e-5; loss and metrics within rtol 1e-5 (sums of ~1e5
whose optimal sigma is itself a mean over every decoded value); the aux
loss within rtol 1e-6.
"""
import os
import sys
import types
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_vae_comparison_tpu.config import Config as JConfig
from multimodal_vae_comparison_tpu.data.datamodule import DataModule as JDataModule
from multimodal_vae_comparison_tpu.models import decoders as jdecoders
from multimodal_vae_comparison_tpu.models import encoders as jencoders
from multimodal_vae_comparison_tpu.models import get_mixing as jget_mixing
from multimodal_vae_comparison_tpu.models.base import ModalitySpec as JSpec
from multimodal_vae_comparison_tpu.training.trainer import build_model as jbuild_model
from multimodal_vae_comparison_tpu_torch.bridge import load_flax_params
from multimodal_vae_comparison_tpu_torch.config import Config
from multimodal_vae_comparison_tpu_torch.data.datamodule import DataModule
from multimodal_vae_comparison_tpu_torch.lanro import collect
from multimodal_vae_comparison_tpu_torch.models import decoders, encoders, get_mixing, objectives
from multimodal_vae_comparison_tpu_torch.models.base import ModalitySpec
from multimodal_vae_comparison_tpu_torch.ops.kernels import telemetry
from multimodal_vae_comparison_tpu_torch.training.trainer import build_model_from_config
from test_torch_vilanro import (GRAD_ATOL, GRAD_REL, LOSS_RTOL, NET_TOL, REPO,
                                _config_params, _Recorder, _torch_batch)
from test_torch_slice import one_torch_thread  # noqa: F401 (autouse)
from test_torch_zoo import draw_params

# the 5 configs of this slice: (path, mixing, image encoder, action decoder)
CONFIGS = (("configs/round3/vilanro_r3_way_p2c.yml", "POE", "CNNCoord", "Transformer"),
           ("configs/round3/vilanro_r3_way_p2d.yml", "MOE", "CNNCoord", "Transformer"),
           ("configs/round4/vilanro_r4_cond.yml", "POE", "CNNCoord", "TransformerCond"),
           ("configs/round4/vilanro_r4b_spatial.yml", "POE", "CNNSpatial", "TransformerCond"),
           ("configs/round5/vilanro_r5_128.yml", "POE", "CNNSpatial", "TransformerCond"))
LATENTS = 64
VOCAB = 12


@pytest.fixture(scope="module")
def waypoints(tmp_path_factory):
    """24 NLReach2 episodes by D1way_p2's recipe (hindsight chunks every 5,
    start-relative waypoints), collected by the port at seed 3."""
    d = str(tmp_path_factory.mktemp("way"))
    stats = collect.collect("NLReach2-v0", 24, d, seed=3, chunk_every=5, waypoints=True)
    assert stats["expert_success"] == 1.0
    return d


def _leaf_grads_match(net, want_net):
    """Every gradient within GRAD_REL of its leaf's max |g| + GRAD_ATOL of
    JAX's.  An attention layer's key bias has a gradient of exactly 0 (the
    softmax of a row is invariant to a shift all its keys share): both
    packages give rounding noise, far below the layer's key weight's
    gradient, so it is held to that leaf's scale instead of its own."""
    want = dict(want_net.named_parameters())
    for name, p in net.named_parameters():
        got = torch.zeros_like(p) if p.grad is None else p.grad
        g = want[name]
        scale = want[name[:-len("bias")] + "weight"] if name.endswith("key.bias") else g
        err = (got - g).abs().max().item()
        limit = GRAD_REL * scale.abs().max().item() + GRAD_ATOL
        assert err <= limit, f"{name}: max abs error {err:.3e} > {limit:.3e}"


def _net_case(case, rng):
    """(JAX net, port class, dims, port kwargs, positional inputs, keyword
    inputs) of one of NET_CASES."""
    if case.startswith("enc"):
        kind, px = case.split("-")[1], int(case.split("-")[2])
        dims = (px, px, 3)
        jcls = {"coord": jencoders.Enc_CNNCoord, "spatial": jencoders.Enc_CNNSpatial}[kind]
        x = rng.uniform(size=(4,) + dims).astype(np.float32)
        return jcls(latent_dim=LATENTS, data_dim=dims), encoders.get_encoder(
            {"coord": "CNNCoord", "spatial": "CNNSpatial"}[kind]), dims, {}, (x,), {}
    dims = (100, 4)
    z = rng.normal(size=(4, LATENTS)).astype(np.float32)
    mask = np.arange(100)[None] < np.array([[30], [100], [5], [61]])
    cond = np.eye(VOCAB, dtype=np.float32)[rng.integers(0, VOCAB, (4, 4))]
    kw = {"cond": cond, "cond_mask": np.arange(4)[None] < np.array([[2], [4], [1], [3]])}
    if case == "dec-nocond":
        kw = {}
    jnet = jdecoders.Dec_TransformerCond(latent_dim=LATENTS, data_dim=dims)
    return (jnet, decoders.get_decoder("TransformerCond"), dims,
            {"cond_features": VOCAB} if kw else {}, (z, mask), kw)


NET_CASES = ("enc-coord-64", "enc-spatial-64", "enc-spatial-128", "dec-cond-padded",
             "dec-nocond")
# the objectives compared: (config, whether JAX's DReG weights are kept)
OBJECTIVES = ((CONFIGS[2][0], False), (CONFIGS[1][0], True), (CONFIGS[3][0], False))
# XLA's CPU compile options: LLVM's backend passes off shorten a compile,
# but round the MOE DReG objective's image-decoder gradient past the limit of
# the port's float64 gradient (within it at XLA's defaults): that one is
# compiled with XLA's defaults
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def _init_all(m, b):
    """A JAX init method that creates every parameter the objective does
    at a fraction of its trace: every encoder, every decoder once
    (conditioned as on the full set) and the aux head."""
    m.encode(b, m.mod_names)
    z = jnp.zeros((1, len(b["mod_1"]["data"]), m.n_latents))
    for spec in m.specs:
        m.decode_mod(spec.name, z, b[spec.name].get("masks"),
                     cond=m._cond_for(spec.name, b, m.mod_names))
    if m.aux_endpoint > 0:
        m.aux_head(z)


def _lower_net(case):
    rng = np.random.default_rng(20)
    jnet, cls, dims, kwargs, args, kw = _net_case(case, rng)
    jargs = tuple(jnp.asarray(a) for a in args)
    jkw = {k: jnp.asarray(v) for k, v in kw.items()}
    shapes = jax.eval_shape(lambda: jnet.init(jax.random.PRNGKey(0), *jargs, **jkw))
    params = draw_params(shapes, 21)
    # the first output: (B, latents) from an encoder, (B,) + dims from the decoder
    cot = rng.normal(size=(4, LATENTS) if case.startswith("enc") else (4,) + dims
                     ).astype(np.float32)

    def both(p):
        want, vjp = jax.vjp(lambda p_: jnet.apply(p_, *jargs, **jkw), p)
        return want, vjp((jnp.asarray(cot),) + tuple(jnp.zeros_like(w) for w in want[1:]))[0]

    case_inputs = types.SimpleNamespace(cls=cls, dims=dims, kwargs=kwargs, args=args, kw=kw,
                                        params=params, cot=cot)
    return case_inputs, jax.jit(both).lower(params), (params,)


def _lower_objective(path, keep_weights, data_dir, root, batch_size=4):
    """The config's port model on JAX's weights, its batch, and JAX's
    value-and-gradient of the objective lowered (its draws and, for DReG,
    its importance weights among the outputs)."""
    params = _config_params(path, data_dir, batch_size=batch_size)
    cfg = Config(params, results_root=str(root / "port"))
    jcfg = JConfig(params, results_root=str(root / "jax"))
    dm, jdm = DataModule(cfg), JDataModule(jcfg)
    dm.setup()
    jdm.setup()
    jmodel = jbuild_model(jcfg)
    jb = jax.tree_util.tree_map(jnp.asarray, next(jdm.batches("train")))
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)}, jb,
        method=_init_all))
    jparams = draw_params(shapes, 2)
    model = build_model_from_config(cfg, device="cpu")
    load_flax_params(model, jparams)
    with pytest.MonkeyPatch.context() as mp:
        rec = _Recorder(mp)
        kept, softmax = [], jax.nn.softmax

        def recording(x, axis=-1, **kwargs):    # DReG's weights: over K of (M, K, B)
            out = softmax(x, axis=axis, **kwargs)
            if keep_weights and axis == 1 and jnp.ndim(x) == 3:
                kept.append(out)
            return out

        mp.setattr(jax.nn, "softmax", recording)

        def loss_fn(p):
            loss, metrics = jmodel.apply(p, jb, rngs={"sample": jax.random.PRNGKey(5)},
                                         method=jmodel.objective)
            return loss, (metrics, list(rec.draws), list(kept))

        lowered = jax.jit(jax.value_and_grad(loss_fn, has_aux=True)).lower(jparams)
    port = types.SimpleNamespace(cfg=cfg, model=model,
                                 batch=_torch_batch(next(dm.batches("train"))))
    return port, lowered, (jparams,)


@pytest.fixture(scope="module")
def jax_side(waypoints, tmp_path_factory):
    """{name: (port-side inputs, JAX's outputs)} for every net case and
    objective.  Each JAX function is traced here in turn and compiled and
    run in a pool of threads: XLA compiles without the GIL, so a compile
    overlaps the next trace (this file's JAX time falls by a third)."""
    def run(lowered, args, options):
        out = lowered.compile(compiler_options=options)(*args)
        return jax.tree_util.tree_map(np.array, out)

    pending = {}
    with ThreadPoolExecutor(max_workers=4) as pool:
        for path, dreg in OBJECTIVES:
            side, lowered, args = _lower_objective(path, dreg, waypoints,
                                                   tmp_path_factory.mktemp("obj"))
            pending[path] = (side, pool.submit(run, lowered, args,
                                               {} if dreg else FAST_COMPILE))
        for case in NET_CASES:
            side, lowered, args = _lower_net(case)
            pending[case] = (side, pool.submit(run, lowered, args, FAST_COMPILE))
        return {k: (side, fut.result()) for k, (side, fut) in pending.items()}


@pytest.mark.parametrize("case", NET_CASES)
def test_new_nets_match_jax_at_full_width(jax_side, case):
    """Each net at 64 latents, bs 4, on numpy inputs, with the JAX weights
    carried through the bridge: its outputs within 1e-5, and the gradient
    of a random cotangent of its first output in every weight within 1e-4
    of the leaf's max |g| + 1e-5.  The CoordConv's convs take C + 2
    channels; the spatial softmax reads 8x8 maps at 64 px and 16x16 at 128;
    the conditioned decoder's memory is the z token and the instruction's
    4 tokens under their padding (z always kept), or z alone."""
    c, (want, jgrads) = jax_side[case]
    net = c.cls(LATENTS, c.dims, **c.kwargs)
    load_flax_params(net, c.params)
    got = net(*(torch.from_numpy(a) for a in c.args),
              **{k: torch.from_numpy(v) for k, v in c.kw.items()})
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.detach().numpy(), b, **NET_TOL)
    (got[0] * torch.from_numpy(c.cot)).sum().backward()
    want_net = c.cls(LATENTS, c.dims, **c.kwargs)
    load_flax_params(want_net, jgrads)
    _leaf_grads_match(net, want_net)
    if case.startswith("enc-coord"):
        assert [getattr(net, f"Conv_{i}").in_channels for i in range(4)] == [5, 34, 34, 34]
    if case.startswith("enc-spatial"):
        assert net.ss_log_temp.grad is not None and net.ss_log_temp.grad.abs().item() > 0
    if case.startswith("dec"):
        assert hasattr(net, "cond_embed") == bool(c.kw)
        assert not got[0][~torch.from_numpy(c.args[1])].any()


def _waypoint_specs(spec_cls, cond_always=False):
    """Language (TxtTransformer), waypoints (TransformerCond conditioned on
    the language) and a front RGB image (FNN) at narrow widths."""
    return (spec_cls(name="mod_1", encoder="TxtTransformer", decoder="TxtTransformer",
                     feature_dims=(4, VOCAB, 1), mod_type="language",
                     recon_loss="category_ce", has_masks=True),
            spec_cls(name="mod_2", encoder="Transformer", decoder="TransformerCond",
                     feature_dims=(100, 4), mod_type="action_waypoints", recon_loss="mse",
                     has_masks=True, cond_on="mod_1", cond_always=cond_always),
            spec_cls(name="mod_3", encoder="FNN", decoder="FNN", feature_dims=(8, 8, 3),
                     mod_type="front RGB", recon_loss="bce"))


def _numpy_batch(rng, n=4):
    words = rng.integers(0, VOCAB, (n, 4))
    wmask = np.arange(4)[None] < rng.integers(1, 5, (n, 1))
    steps = rng.integers(20, 101, (n, 1))
    way = np.cumsum(rng.normal(scale=0.01, size=(n, 100, 4)), 1).astype(np.float32)
    smask = np.arange(100)[None] < steps
    # waypoints padded by repeating the last achieved position
    way = np.where(smask[..., None], way, way[np.arange(n), steps[:, 0] - 1][:, None])
    return {"mod_1": {"data": np.eye(VOCAB, dtype=np.float32)[words], "masks": wmask},
            "mod_2": {"data": way.astype(np.float32), "masks": smask},
            "mod_3": {"data": rng.uniform(size=(n, 8, 8, 3)).astype(np.float32),
                      "masks": None}}


def test_aux_endpoint_loss_matches_jax():
    """The weighted loss term and the per-row metric of the endpoint head on
    (K 3, bs 4) latents, the head's weights carried over: JAX's within rtol
    1e-6; the target is the first 3 features of the last (padded)
    waypoint."""
    rng = np.random.default_rng(22)
    batch = _numpy_batch(rng)
    jmodel = jget_mixing("poe")(specs=_waypoint_specs(JSpec), n_latents=16,
                                aux_endpoint=250.0)
    jb = jax.tree_util.tree_map(jnp.asarray, batch)
    z = jnp.asarray(rng.normal(size=(3, 4, 16)).astype(np.float32))
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), z, jb,
                                                method=jmodel.aux_endpoint_loss))
    params = draw_params(shapes, 23)
    want = jmodel.apply(params, z, jb, method=jmodel.aux_endpoint_loss)
    model = get_mixing("poe")(_waypoint_specs(ModalitySpec), 16, device="cpu",
                              aux_endpoint=250.0)
    load_flax_params(model.aux_head, params["params"]["aux_head"])
    assert model.endpoint_spec().name == "mod_2"
    got = model.aux_endpoint_loss(torch.from_numpy(np.array(z)), _torch_batch(batch))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.item(), float(b), rtol=1e-6)


def test_aux_term_skips_the_action_encoder():
    """Counterpart of the JAX package's test_aux_endpoint_skips_action_subset:
    the aux metric's gradient reaches the image encoder and not the action
    encoder (the head reads only the joint of the subset without the action
    modality), and the metric is in the objective's metrics only with the
    head."""
    rng = np.random.default_rng(24)
    batch = _torch_batch(_numpy_batch(rng))
    model = get_mixing("poe")(_waypoint_specs(ModalitySpec), 8, device="cpu",
                              aux_endpoint=100.0)
    loss, metrics = model.objective(batch, generator=torch.Generator().manual_seed(0))
    metrics["aux_endpoint_mse"].backward()
    grad_sum = lambda mod: sum(0.0 if p.grad is None else p.grad.abs().sum().item()
                               for p in mod.parameters())
    assert grad_sum(model.enc_mod_2) == 0.0 < grad_sum(model.enc_mod_3)
    assert grad_sum(model.aux_head) > 0.0
    plain = get_mixing("poe")(_waypoint_specs(ModalitySpec), 8, device="cpu")
    assert "aux_endpoint_mse" not in plain.objective(
        batch, generator=torch.Generator().manual_seed(0))[1]


def test_cond_always_supplies_cond_on_subsets_without_the_language():
    """Counterpart of test_cond_always_supplies_cond_on_condless_subsets:
    with ``cond_always`` the decoder gets the instruction on the subset
    without the language modality, without it None; with the language
    present both supply it.  Flipping the instruction moves the decoded
    waypoints of the image-only forward only under ``cond_always``."""
    rng = np.random.default_rng(26)
    batch = _torch_batch(_numpy_batch(rng))
    flipped = {k: dict(v) for k, v in batch.items()}
    flipped["mod_1"]["data"] = torch.roll(batch["mod_1"]["data"], 1, dims=-1)
    for always in (False, True):
        model = get_mixing("poe")(_waypoint_specs(ModalitySpec, always), 8,
                                  device="cpu")
        got = model._cond_for("mod_2", batch, present=("mod_2",))
        assert (got is None) != always
        if always:
            assert got[0].shape == (4, 4, VOCAB)
        assert model._cond_for("mod_2", batch, present=("mod_1", "mod_2")) is not None
        model.eval()
        eps = torch.from_numpy(rng.normal(size=(1, 4, 8)).astype(np.float32))
        with torch.no_grad():
            a, b = (model.forward(x, ("mod_3",), eps=eps).mods["mod_2"].decoder_dist.mean
                    for x in (batch, flipped))
        assert ((a - b).abs().max().item() > 1e-6) == always


def _check_objective(side, loss, metrics, jloss, jmetrics, jgrads):
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=LOSS_RTOL)
    assert sorted(metrics) == sorted(jmetrics)
    for k in metrics:
        np.testing.assert_allclose(metrics[k].item(), float(jmetrics[k]), rtol=LOSS_RTOL,
                                   atol=1e-4, err_msg=k)
    want = build_model_from_config(side.cfg, device="cpu")
    load_flax_params(want, jgrads)
    _leaf_grads_match(side.model, want)


@pytest.mark.parametrize("path", [CONFIGS[2][0], CONFIGS[3][0]],
                         ids=["vilanro_r4_cond", "vilanro_r4b_spatial"])
def test_cond_config_objective_loss_metrics_and_grads_match_jax(jax_side, path):
    """The config's POE objective (7 subsets, optimal_sigma, the aux term at
    weight 1e4) at bs 4 on collected rows, the port fed JAX's draws: loss,
    every metric (``aux_endpoint_mse`` among them) and every gradient match.
    ``vilanro_r4_cond`` decodes the actions per subset (conditioned where the
    language is present), ``vilanro_r4b_spatial`` once for the whole
    lattice, always conditioned; the kernels' plain versions run as
    chip_smoke.py counts them."""
    side, ((jloss, (jmetrics, draws, _)), jgrads) = jax_side[path]
    assert len(draws) == 7 and hasattr(side.model, "aux_head")
    telemetry.reset()
    loss, metrics = side.model.objective(side.batch, eps=[torch.from_numpy(d) for d in draws])
    loss.backward()
    cs = _chip_smoke()
    key = cs.vilanro_launch_key(side.cfg)
    assert key == ("poe_cond" if "r4_cond" in path else "poe")
    assert {k.split(":")[0]: n for k, n in telemetry.summary().items()} == {
        **cs.VILANRO_PER_OBJECTIVE[key], **cs.VILANRO_PER_BACKWARD[key]}
    assert "aux_endpoint_mse" in metrics
    _check_objective(side, loss, metrics, jloss, jmetrics, jgrads)


def test_dreg_config_matches_jax_on_its_importance_weights(jax_side, monkeypatch):
    """``vilanro_r3_way_p2d`` (MOE, DReG K 5, CoordConv) at bs 4: the port
    fed JAX's draws and JAX's DReG weights (a softmax over K of log-weights
    of ~-1e6; the port's own are held to them within 1e-3): loss, metrics
    and every gradient match."""
    side, ((jloss, (jmetrics, draws, weights)), jgrads) = jax_side[CONFIGS[1][0]]
    assert (side.cfg.mixing, side.cfg.obj, side.cfg.K) == ("moe", "dreg", 5)
    assert len(weights) == 1
    own = []

    def replay(lw, dim=0):
        own.append(torch.softmax(lw.detach(), dim=dim))
        return torch.from_numpy(weights[0])

    monkeypatch.setattr(objectives, "dreg_grad_weights", replay)
    eps = {s.name: torch.from_numpy(d) for s, d in zip(side.model.specs, draws)}
    telemetry.reset()
    loss, metrics = side.model.objective(side.batch, eps=eps)
    loss.backward()
    cs = _chip_smoke()
    assert cs.vilanro_launch_key(side.cfg) == "moe_dreg"
    assert {k.split(":")[0]: n for k, n in telemetry.summary().items()} == {
        **cs.VILANRO_PER_OBJECTIVE["moe_dreg"], **cs.VILANRO_PER_BACKWARD["moe_dreg"]}
    np.testing.assert_allclose(own[0].numpy(), weights[0], atol=1e-3)
    _check_objective(side, loss, metrics, jloss, jmetrics, jgrads)


@pytest.mark.parametrize("path,mixing,encoder,decoder", CONFIGS,
                         ids=[os.path.basename(c[0])[:-4] for c in CONFIGS])
def test_second_slice_configs_build(path, mixing, encoder, decoder):
    """Each config builds with ``eval_only`` on its data's feature dims (128
    px for ``vilanro_r5_128``): its mixing, image encoder, action decoder,
    conditioning, llik scalings and aux head as the JAX package's.  The
    JAX parameter tree fills ``vilanro_r5_128`` leaf for leaf; the
    objective tests load it into three others, and ``vilanro_r3_way_p2c``'s
    nets are ``vilanro_r3_way_p2d``'s (POE and MOE hold the same
    parameters)."""
    cfg, jcfg = (cls(os.path.join(REPO, path), eval_only=True) for cls in (Config, JConfig))
    px = 128 if "128" in path else 64
    for c in (cfg, jcfg):
        for m, dims in zip(c.mods, ([4, VOCAB, 1], [100, 4], [px, px, 3])):
            m.feature_dims = dims
    model = build_model_from_config(cfg, device="cpu")
    jmodel = jbuild_model(jcfg)
    assert type(model).__name__ == type(jmodel).__name__ == mixing
    assert [s.encoder for s in model.specs] == ["TxtTransformer", "Transformer", encoder]
    assert model.specs[1].decoder == decoder
    for a, b in zip(model.specs, jmodel.specs):
        assert (a.cond_on, a.cond_always, a.llik_scaling) == (b.cond_on, b.cond_always,
                                                              b.llik_scaling)
    assert model.aux_endpoint == jmodel.aux_endpoint
    assert hasattr(model, "aux_head") == (jmodel.aux_endpoint > 0)
    if path == CONFIGS[0][0]:
        assert sorted(n for n, _ in model.named_parameters()) == sorted(
            n for n, _ in build_model_from_config(_moe_of(cfg), device="cpu")
            .named_parameters())
    if path != CONFIGS[4][0]:
        return
    batch = {m.name: {"data": jax.ShapeDtypeStruct(
                          (2, *m.feature_dims[:2]) if m.mod_type == "language"
                          else (2, *m.feature_dims), jnp.float32),
                      "masks": None if m.mod_type == "front RGB"
                      else jax.ShapeDtypeStruct((2, m.feature_dims[0]), jnp.bool_)}
             for m in jcfg.mods}
    shapes = jax.eval_shape(lambda b: jmodel.init(
        {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)}, b,
        method=_init_all), batch)
    load_flax_params(model, jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                                                   shapes))


def _moe_of(cfg):
    """``cfg`` as ``vilanro_r3_way_p2d`` has it: MOE, DReG, K 5."""
    other = Config(os.path.join(REPO, CONFIGS[1][0]), eval_only=True)
    for m, n in zip(other.mods, cfg.mods):
        m.feature_dims = n.feature_dims
    return other


def _chip_smoke():
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    return chip_smoke
