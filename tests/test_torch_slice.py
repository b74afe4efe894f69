"""The serving slice of the port against the JAX package, on the CPU.

``POE.forward`` of both packages on the same numpy-drawn weights (carried
across by ``bridge.load_flax_params``), the same inputs and the same joint
sample: JAX's draw is recovered as ``(latents - joint.loc) / joint.scale``
and injected into the port.  Then the port's engine and HTTP server on
``device="cpu"``, mirroring tests/test_serving.py.
"""
import json
import math
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_vae_comparison_tpu.models import get_mixing as jget_mixing
from multimodal_vae_comparison_tpu.models.base import ModalitySpec as JSpec
from multimodal_vae_comparison_tpu_torch.bridge import load_flax_params
from multimodal_vae_comparison_tpu_torch.models import get_mixing
from multimodal_vae_comparison_tpu_torch.models.base import ModalitySpec
from multimodal_vae_comparison_tpu_torch.ops.kernels import telemetry
from multimodal_vae_comparison_tpu_torch.serving.engine import (
    InferenceEngine, ModelHandle)
from multimodal_vae_comparison_tpu_torch.serving.server import make_handler

TOL = dict(rtol=1e-4, atol=1e-5)
PRESENTS = [("mod_1",), ("mod_2",), ("mod_1", "mod_2")]
NARROW = dict(img=(32, 32, 3), seq=12, latents=8, batch=3)
FLAGSHIP = dict(img=(64, 64, 3), seq=45, latents=16, batch=2)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """PyTorch on one thread for a module's tests (autouse; the port's CPU
    test files import it): their tensors are small, and pytest-xdist runs
    several test processes at once, each of whose default pools (a thread
    per core) oversubscribed the host, running the port's tests tens of
    times slower than alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def spec_kwargs(cfg):
    return (
        dict(name="mod_1", encoder="CNN2", decoder="CNN", feature_dims=cfg["img"],
             mod_type="image", recon_loss="bce"),
        dict(name="mod_2", encoder="TxtTransformer", decoder="TxtTransformer",
             feature_dims=(cfg["seq"], 27), mod_type="text",
             recon_loss="category_ce", has_masks=True),
    )


def numpy_batch(cfg, seed):
    rng = np.random.default_rng(seed)
    b, t = cfg["batch"], cfg["seq"]
    img = rng.random((b,) + cfg["img"]).astype(np.float32)
    txt = np.eye(27, dtype=np.float32)[rng.integers(0, 27, (b, t))]
    mask = np.arange(t)[None, :] < rng.integers(1, t + 1, (b, 1))
    return {"mod_1": {"data": img, "masks": None},
            "mod_2": {"data": txt, "masks": mask}}


def draw_params(shapes, seed):
    """numpy weights in flax's layout: kernels ~ N(0, 1/fan_in), the rest
    ~ N(0, 0.1^2) (LayerNorm scales around 1)."""
    rng = np.random.default_rng(seed)

    def draw(path, s):
        leaf = path[-1].key
        if leaf == "kernel":
            fan_in = s.shape[0] if len(s.shape) == 3 else math.prod(s.shape[:-1])
            return rng.normal(0, 1 / math.sqrt(fan_in), s.shape).astype(np.float32)
        if leaf == "scale":
            return (1 + 0.1 * rng.normal(size=s.shape)).astype(np.float32)
        return (0.1 * rng.normal(size=s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def build_pair(cfg, seed=0):
    """(jax model, flax params as numpy, port model on the CPU, same weights)."""
    jmodel = jget_mixing("poe")(specs=tuple(JSpec(**k) for k in spec_kwargs(cfg)),
                                n_latents=cfg["latents"])
    jbatch = jax.tree_util.tree_map(jnp.asarray, numpy_batch(cfg, 0))
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)}, jbatch))
    params = draw_params(shapes, seed)
    tmodel = get_mixing("poe")(tuple(ModalitySpec(**k) for k in spec_kwargs(cfg)),
                               cfg["latents"], device="cpu")
    load_flax_params(tmodel, params)
    return jmodel, params, tmodel.eval()


def torch_batch(batch, present):
    return {name: ({"data": torch.from_numpy(mod["data"]),
                    "masks": None if mod["masks"] is None else torch.from_numpy(mod["masks"])}
                   if name in present else {"data": None, "masks": None})
            for name, mod in batch.items()}


def assert_forward_matches(jmodel, params, tmodel, batch, present):
    jb = {n: ({"data": jnp.asarray(m["data"]),
               "masks": None if m["masks"] is None else jnp.asarray(m["masks"])}
              if n in present else {"data": None, "masks": None})
          for n, m in batch.items()}
    jout = jmodel.apply(params, jb, rngs={"sample": jax.random.PRNGKey(5)},
                        method=lambda m, b: m.forward(b, present))
    joint = jout.mods["mod_1"].joint_dist
    eps = ((np.asarray(jout.mods["mod_1"].latents) - np.asarray(joint.loc))
           / np.asarray(joint.scale)).astype(np.float32)
    with torch.inference_mode():
        tout = tmodel.forward(torch_batch(batch, present), present,
                              eps=torch.from_numpy(eps))
    tjoint = tout.mods["mod_1"].joint_dist
    np.testing.assert_allclose(tjoint.loc.numpy(), np.asarray(joint.loc), **TOL)
    np.testing.assert_allclose(tjoint.scale.numpy(), np.asarray(joint.scale), **TOL)
    np.testing.assert_allclose(tout.mods["mod_1"].latents.numpy(),
                               np.asarray(jout.mods["mod_1"].latents), **TOL)
    for name in ("mod_1", "mod_2"):
        jm, tm = jout.mods[name], tout.mods[name]
        np.testing.assert_allclose(tm.decoder_dist.mean.numpy(),
                                   np.asarray(jm.decoder_dist.mean), **TOL)
        np.testing.assert_allclose(tm.decoder_dist.scale.numpy(),
                                   np.asarray(jm.decoder_dist.scale), **TOL)
        if name in present:
            for t, j in ((tm.encoder_dist.loc, jm.encoder_dist.loc),
                         (tm.encoder_dist.scale, jm.encoder_dist.scale)):
                np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)
        else:
            assert tm.encoder_dist is None and jm.encoder_dist is None
    np.testing.assert_allclose(tout.mods["mod_1"].decoder_dist.loc_logits.numpy(),
                               np.asarray(jout.mods["mod_1"].decoder_dist.loc_logits),
                               **TOL)


@pytest.fixture(scope="module")
def narrow():
    return build_pair(NARROW)


@pytest.mark.parametrize("present", PRESENTS)
def test_poe_forward_matches_jax_narrow(narrow, present):
    jmodel, params, tmodel = narrow
    assert_forward_matches(jmodel, params, tmodel, numpy_batch(NARROW, 1), present)


def test_poe_forward_matches_jax_flagship_widths():
    jmodel, params, tmodel = build_pair(FLAGSHIP, seed=3)
    assert sum(p.numel() for p in tmodel.parameters()) == 957902
    assert_forward_matches(jmodel, params, tmodel, numpy_batch(FLAGSHIP, 2),
                           ("mod_1", "mod_2"))


def test_bridge_consumes_every_leaf_once(narrow):
    _, params, _ = narrow
    leaves = jax.tree_util.tree_leaves(params)
    fresh = get_mixing("poe")(tuple(ModalitySpec(**k) for k in spec_kwargs(NARROW)),
                              NARROW["latents"], device="cpu", seed=9)
    load_flax_params(fresh, params)
    tparams = list(fresh.parameters())
    assert len(leaves) == len(tparams)
    assert sum(x.size for x in leaves) == sum(p.numel() for p in tparams)
    np.testing.assert_array_equal(fresh.pz_logvar.detach().numpy(),
                                  params["params"]["pz_logvar"])


def test_bridge_raises_on_missing_extra_or_misshapen_leaves(narrow):
    _, params, tmodel = narrow
    tree = jax.tree_util.tree_map(np.copy, params["params"])
    extra = dict(tree, pz_extra=np.zeros((1, 8), np.float32))
    with pytest.raises(KeyError):
        load_flax_params(tmodel, extra)
    missing = dict(tree)
    del missing["pz_logvar"]
    with pytest.raises(KeyError, match="pz_logvar"):
        load_flax_params(tmodel, missing)
    bad = jax.tree_util.tree_map(np.copy, tree)
    bad["enc_mod_1"]["Dense_0"]["kernel"] = bad["enc_mod_1"]["Dense_0"]["kernel"][:-1]
    with pytest.raises(ValueError):
        load_flax_params(tmodel, bad)
    load_flax_params(tmodel, tree)  # the fixture's model keeps its weights


def test_decode_mod_pads_shared_only_latents_and_rejects_other_widths(narrow):
    _, _, tmodel = narrow
    z = torch.zeros(2, 3, NARROW["latents"])
    dist = tmodel.decode_mod("mod_1", z)
    assert dist.mean.shape == (2, 3) + NARROW["img"]
    with pytest.raises(ValueError):
        tmodel.decode_mod("mod_1", torch.zeros(1, 3, NARROW["latents"] + 1))


def test_rsample_eps_shape_is_checked(narrow):
    _, _, tmodel = narrow
    batch = torch_batch(numpy_batch(NARROW, 4), ("mod_1",))
    with pytest.raises(ValueError):
        tmodel.forward(batch, ("mod_1",), eps=torch.zeros(1, 2, NARROW["latents"]))


# -- engine and server on the CPU -----------------------------------------


def engine_inputs(n, seed=0, present=("mod_1", "mod_2")):
    cfg = dict(NARROW, batch=n)
    batch = numpy_batch(cfg, seed)
    return {name: {k: v for k, v in batch[name].items() if v is not None}
            for name in present}


@pytest.fixture(scope="module")
def engine(narrow):
    _, _, tmodel = narrow
    handle = ModelHandle(tmodel)
    return InferenceEngine(handle, buckets=(2, 8), device="cpu"), handle


def test_engine_pads_to_bucket_and_trims(engine):
    eng, _ = engine
    out = eng.generate(engine_inputs(5, present=("mod_1",)))
    assert out["mod_1"].shape == (5,) + NARROW["img"]
    assert out["mod_2"].shape == (5, NARROW["seq"], 27)
    assert (("mod_1",), 8) in eng._warm
    assert eng.generate(engine_inputs(1, present=("mod_1",)))["mod_1"].shape[0] == 1
    assert (("mod_1",), 2) in eng._warm


def test_engine_chunks_at_the_largest_bucket(engine):
    """19 rows -> chunks of 8, 8 and 3 (padded to 8); every chunk draws its
    sample from the same seed, as the reference engine's PRNGKey(seed)."""
    eng, _ = engine
    inputs = engine_inputs(19, seed=1)
    out = eng.generate(inputs, seed=3)
    assert out["mod_1"].shape[0] == 19 and out["mod_2"].shape[0] == 19
    first = eng.generate({k: {kk: vv[:8] for kk, vv in v.items()}
                          for k, v in inputs.items()}, seed=3)
    for name in out:
        np.testing.assert_array_equal(out[name][:8], first[name])


def test_engine_matches_model_forward(engine):
    eng, handle = engine
    inputs = engine_inputs(8, seed=2)
    out = eng.generate(inputs, seed=11)
    batch = {n: {"data": torch.from_numpy(inputs[n]["data"]),
                 "masks": (torch.from_numpy(inputs[n]["masks"])
                           if "masks" in inputs[n] else None)} for n in inputs}
    with torch.inference_mode():
        ref = handle.model.forward(batch, ("mod_1", "mod_2"),
                                   generator=torch.Generator().manual_seed(11))
    for name in out:
        np.testing.assert_array_equal(out[name], ref.mods[name].decoder_dist.mean[0].numpy())


def test_engine_seed_decides_the_sample(engine):
    eng, _ = engine
    inputs = engine_inputs(3, seed=4, present=("mod_2",))
    a, b = eng.generate(inputs, seed=1), eng.generate(inputs, seed=1)
    c = eng.generate(inputs, seed=2)
    np.testing.assert_array_equal(a["mod_1"], b["mod_1"])
    assert not np.array_equal(a["mod_1"], c["mod_1"])


def test_engine_input_validation(engine):
    eng, _ = engine
    data = np.zeros((2,) + NARROW["img"], np.float32)
    with pytest.raises(ValueError):
        eng.generate({})
    with pytest.raises(KeyError):
        eng.generate({"mod_9": {"data": data}})
    with pytest.raises(ValueError):
        eng.generate({"mod_1": {"data": data},
                      "mod_2": {"data": np.zeros((3, NARROW["seq"], 27), np.float32)}})


def test_engine_concurrent_generate(engine):
    eng, _ = engine
    inputs = engine_inputs(2, seed=5, present=("mod_1",))
    results, errors = [None] * 4, []

    def hit(i):
        try:
            results[i] = eng.generate(inputs)
        except Exception as e:  # surface failures in the main thread
            errors.append(e)

    threads = [threading.Thread(target=hit, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors and not any(t.is_alive() for t in threads)
    for r in results[1:]:
        np.testing.assert_array_equal(r["mod_1"], results[0]["mod_1"])


def test_engine_decode_latents(engine):
    eng, _ = engine
    out = eng.decode_latents(np.zeros((3, NARROW["latents"]), np.float32))
    assert out["mod_1"].shape == (3,) + NARROW["img"]
    assert out["mod_2"].shape == (3, NARROW["seq"], 27)
    with pytest.raises(ValueError):
        eng.decode_latents(np.zeros((3, NARROW["latents"] + 2), np.float32))


def test_engine_on_cpu_takes_only_plain_versions(engine):
    eng, _ = engine
    telemetry.reset()
    eng.generate(engine_inputs(2, seed=6))
    assert telemetry.launches() == {}
    assert set(telemetry.summary()) == {"attention:plain", "poe:plain"}


@pytest.fixture
def server(engine):
    eng, handle = engine
    srv = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(eng, handle))
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    srv.server_close()
    thread.join(timeout=30)


def post(url, payload: bytes):
    return urllib.request.urlopen(urllib.request.Request(
        url, data=payload, headers={"Content-Type": "application/json"}), timeout=120)


def test_http_health_and_generate(server):
    health = json.load(urllib.request.urlopen(f"{server}/health", timeout=60))
    assert health == {"status": "ok", "model": "POE",
                      "modalities": ["mod_1", "mod_2"], "n_latents": NARROW["latents"]}
    inputs = engine_inputs(2, seed=7)
    req = {"inputs": {k: {kk: vv.tolist() for kk, vv in v.items()}
                      for k, v in inputs.items()}, "seed": 1}
    resp = json.load(post(f"{server}/generate", json.dumps(req).encode()))
    assert np.asarray(resp["mod_1"]).shape == (2,) + NARROW["img"]
    assert np.asarray(resp["mod_2"]).shape == (2, NARROW["seq"], 27)


def test_http_concurrent_requests(server):
    results, errors = [], []

    def hit(i):
        req = {"inputs": {"mod_1": {"data": np.full((2,) + NARROW["img"], i / 8.0).tolist()}},
               "seed": i}
        try:
            results.append(np.asarray(json.load(
                post(f"{server}/generate", json.dumps(req).encode()))["mod_2"]).shape)
        except Exception as e:  # surface in main thread
            errors.append(repr(e))

    threads = [threading.Thread(target=hit, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors, errors
    assert len(results) == 6 and all(s[0] == 2 for s in results)


def test_http_error_paths(server, engine, monkeypatch):
    eng, _ = engine
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(f"{server}/nope", timeout=60)
    assert e.value.code == 404
    with pytest.raises(urllib.error.HTTPError) as e:
        post(f"{server}/nope", b"{}")
    assert e.value.code == 404
    with pytest.raises(urllib.error.HTTPError) as e:
        post(f"{server}/generate", json.dumps({"inputs": {"mod_9": {"data": [[0.0]]}}}).encode())
    assert e.value.code == 400 and "mod_9" in json.load(e.value)["error"]
    for body in (b"{}", b"junk"):
        with pytest.raises(urllib.error.HTTPError) as e:
            post(f"{server}/generate", body)
        assert e.value.code == 400

    def boom(*args, **kwargs):
        raise RuntimeError("boom")

    monkeypatch.setattr(eng, "generate", boom)
    with pytest.raises(urllib.error.HTTPError) as e:
        post(f"{server}/generate", json.dumps({"inputs": {"mod_1": {"data": [[0.0]]}}}).encode())
    assert e.value.code == 500 and "boom" in json.load(e.value)["error"]
