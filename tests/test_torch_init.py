"""The port's fresh weights against the JAX package's own ``init``, leaf by
leaf, on the CPU.

The JAX package names no initializer in its nets, so each of its leaves
takes flax's default for its layer: lecun_normal kernels (a normal of
variance 1 / fan_in cut at two standard deviations), zero biases,
orthogonal ``GRUCell`` recurrent kernels, the norms' ones and zeros, and
the few leaves that name their own (``pz_mog_loc`` ~ N(0, 1), the ViT's
``pos_embed`` ~ N(0, 0.02)).  For every net of the JAX registries (at the
narrow widths of the net tests), and for the flagship POE built through
``build_model_from_config`` (plain, and with a mixture prior) and a VILANRO
POE with the aux endpoint head, the JAX ``init`` at key JAX_SEED is loaded
through ``bridge.load_flax_params`` into one port net, which decides which
port leaf holds which flax leaf, and a second port net is drawn fresh from
the torch seed PORT_SEED.  Then, per leaf:

* a leaf flax fills with a constant equals that constant exactly;
* a random leaf of MIN_KS or more elements passes a two-sample
  Kolmogorov-Smirnov test against its bridged JAX counterpart at p >=
  KS_P, and a truncated one stays within two of its rule's standard
  deviations (the cut);
* each H x H block of a GRU's recurrent kernel is orthogonal, W^T W = I
  within ORTHO_ATOL;
* the smaller random leaves of a net, each divided by its rule's scale,
  are pooled and pass the same test.

The judges' and the fixed VGG features' draws go through the same helper
and are pinned to their earlier values, so cached judges stay valid.
"""
import math
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats
from torch import nn

from multimodal_vae_comparison_tpu.config import Config as JConfig
from multimodal_vae_comparison_tpu.models import decoders as jdecoders
from multimodal_vae_comparison_tpu.models import encoders as jencoders
from multimodal_vae_comparison_tpu.training.trainer import build_model as jbuild_model
from multimodal_vae_comparison_tpu_torch.bridge import load_flax_params
from multimodal_vae_comparison_tpu_torch.config import Config
from multimodal_vae_comparison_tpu_torch.eval.classifiers import CNNClassifier
from multimodal_vae_comparison_tpu_torch.models import decoders, encoders, perceptual
from multimodal_vae_comparison_tpu_torch.models.init import TRUNCATED_STD
from multimodal_vae_comparison_tpu_torch.training.trainer import build_model_from_config
from test_torch_slice import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_SEED, PORT_SEED = 5, 7
KS_P = 1e-6
MIN_KS = 64
ORTHO_ATOL = 1e-5
# XLA's CPU compile options of the JAX inits: a draw's distribution does not
# hang on them, and without the expensive passes a compile takes half as long
FAST_COMPILE = {"xla_llvm_disable_expensive_passes": True,
                "xla_backend_optimization_level": 0}
LATENTS, B = 20, 2
TEXT, CLIP, VOCAB = (45, 27), (3, 64, 64, 3), 12
# leaves drawn from an untruncated normal of this std (flax's ``normal``)
NORMAL_LEAVES = {"pos_embed": 0.02, "pz_mog_loc": 1.0}
_CONVS = (nn.Conv1d, nn.Conv2d, nn.Conv3d, nn.ConvTranspose1d, nn.ConvTranspose2d,
          nn.ConvTranspose3d)

# (kind, registry name, data dims, constructor kwargs of both sides, masked)
NETS = {
    "enc-CNN": ("enc", "CNN", (32, 32, 3), {}, False),
    "enc-VIT": ("enc", "VIT", (64, 64, 3), {}, False),
    "enc-CNN2": ("enc", "CNN2", (64, 64, 3), {"hid_channels": 8, "hidden_dim": 32}, False),
    "enc-CNNCoord": ("enc", "CNNCoord", (64, 64, 3), {"hid_channels": 8, "hidden_dim": 32},
                     False),
    "enc-CNNSpatial": ("enc", "CNNSpatial", (64, 64, 3),
                       {"hid_channels": 8, "n_maps": 8, "hidden_dim": 32}, False),
    "enc-MNIST": ("enc", "MNIST", (28, 28, 1), {"hidden_dim": 40}, False),
    "enc-MNISTMoE": ("enc", "MNISTMoE", (28, 28, 1), {"hidden_dim": 40}, False),
    "enc-RESCNN": ("enc", "RESCNN", (64, 64, 3), {"ch": 16}, False),
    "enc-PolyMNIST": ("enc", "PolyMNIST", (28, 28, 3), {"hidden_dim": 40}, False),
    "enc-SVHN": ("enc", "SVHN", (32, 32, 3), {}, False),
    "enc-SVHN2": ("enc", "SVHN2", (32, 32, 3), {"fBase": 8}, False),
    "enc-FNN": ("enc", "FNN", (10,), {"hidden_dim": 32}, False),
    "enc-Transformer": ("enc", "Transformer", (6, 4),
                        {"ff_size": 32, "num_layers": 1}, True),
    "enc-TxtTransformer": ("enc", "TxtTransformer", TEXT, {}, True),
    "enc-ConvTxt": ("enc", "ConvTxt", TEXT, {"fBase": 8, "embed_dim": 8}, False),
    "enc-TxtRNN": ("enc", "TxtRNN", TEXT, {"hidden_size": 16}, True),
    "enc-TransformerIMG": ("enc", "TransformerIMG", CLIP,
                           {"hid_channels": 8, "ff_size": 32, "num_layers": 1}, True),
    "enc-VideoGPT": ("enc", "VideoGPT", (2, 16, 16, 3),
                     {"n_res_layers": 1, "hidden": 16}, False),
    "enc-VideoGPTSparse": ("enc", "VideoGPTSparse", (2, 32, 32, 3),
                           {"n_res_layers": 1, "hidden": 16}, False),
    "dec-CNN": ("dec", "CNN", (64, 64, 3), {"hid_channels": 8, "hidden_dim": 32}, False),
    "dec-SVHN": ("dec", "SVHN", (32, 32, 3), {}, False),
    "dec-SVHN2": ("dec", "SVHN2", (32, 32, 3), {"fBase": 8}, False),
    "dec-MNIST": ("dec", "MNIST", (28, 28, 1), {"hidden_dim": 40}, False),
    "dec-MNIST2": ("dec", "MNIST2", (28, 28, 1), {"hidden_dim": 40}, False),
    "dec-PolyMNIST": ("dec", "PolyMNIST", (28, 28, 3), {}, False),
    "dec-RESCNN": ("dec", "RESCNN", (64, 64, 3), {"ch": 32}, False),
    "dec-FNN": ("dec", "FNN", (10,), {"hidden_dim": 32}, False),
    "dec-Transformer": ("dec", "Transformer", (6, 4, 1),
                        {"ff_size": 32, "num_layers": 1}, True),
    "dec-TransformerCond": ("dec", "TransformerCond", (6, 4),
                            {"ff_size": 32, "num_layers": 1, "d_model": 32}, True),
    "dec-TxtTransformer": ("dec", "TxtTransformer", TEXT, {}, True),
    "dec-ConvTxt": ("dec", "ConvTxt", TEXT, {"fBase": 8}, False),
    "dec-TransformerIMG": ("dec", "TransformerIMG", CLIP,
                           {"hid_channels": 8, "ff_size": 32, "num_layers": 1}, False),
    "dec-VideoGPT": ("dec", "VideoGPT", (2, 16, 16, 3), {"n_res_layers": 1, "hidden": 16},
                     False),
    "dec-VideoGPTSparse": ("dec", "VideoGPTSparse", (2, 32, 32, 3),
                           {"n_res_layers": 1, "hidden": 16}, False),
}

# whole models through the user's entry point: (config, overrides, feature dims)
CDSPRITES_DIMS = ([64, 64, 3], [45, 27])
MODELS = {
    "flagship-poe": ("configs/round5/cdl1_r5_poe.yml", {}, CDSPRITES_DIMS),
    "flagship-poe-mixture-prior": ("configs/round5/cdl1_r5_poe.yml",
                                   {"prior_components": 3}, CDSPRITES_DIMS),
    "vilanro-aux-endpoint": ("configs/round5/vilanro_r5_128.yml", {},
                             ([4, VOCAB], [100, 4], [128, 128, 3])),
}


def flax_rule(model, name):
    """The flax initializer of the port leaf ``name``, by its layer: ("const",
    None), ("lecun", fan_in), ("orthogonal", H) or ("normal", std).  The
    fan-in is what flax's kernel contracts over: a Dense's inputs, a conv's
    input channels per group times its window, a transposed conv's input
    channels times its window."""
    mod_name, _, leaf = name.rpartition(".")
    module = model.get_submodule(mod_name)
    if isinstance(module, nn.GRU):
        return {"weight_ih_l0": ("lecun", module.input_size),
                "weight_hh_l0": ("orthogonal", module.hidden_size)}.get(leaf, ("const", None))
    if leaf == "weight" and isinstance(module, nn.Linear):
        return "lecun", module.in_features
    if leaf == "weight" and isinstance(module, _CONVS):
        channels = module.in_channels if module.transposed else \
            module.in_channels // module.groups
        return "lecun", channels * math.prod(module.kernel_size)
    if leaf in NORMAL_LEAVES:
        return "normal", NORMAL_LEAVES[leaf]
    return "const", None


def rule_scale(kind, arg):
    """The standard deviation a leaf of the rule has: 1 / sqrt(fan-in) or
    1 / sqrt(H), or the normal's own."""
    return arg if kind == "normal" else arg ** -0.5


def leaves(model):
    out = dict(model.named_parameters())
    out.update(model.named_buffers())
    return {k: v.detach().numpy().astype(np.float64) for k, v in out.items()}


def compare(port, bridged, label):
    """Hold the fresh port net ``port`` to ``bridged``, the same net holding
    the JAX package's init, leaf by leaf (the module docstring's rules)."""
    fresh, want = leaves(port), leaves(bridged)
    assert sorted(fresh) == sorted(want), label
    small_port, small_jax, checked = [], [], 0
    for name, w in want.items():
        got = fresh[name]
        kind, arg = flax_rule(port, name)
        where = f"{label}: {name} {got.shape}"
        if kind == "const":
            assert np.all(w == w.flat[0]), f"{where}: JAX's leaf is not a constant"
            np.testing.assert_array_equal(got, w, err_msg=where)
            continue
        assert w.size < 2 or np.ptp(w) > 0, f"{where}: JAX's leaf is a constant"
        scale = rule_scale(kind, arg)
        if kind == "lecun":
            cut = 2 * scale / TRUNCATED_STD
            assert np.abs(got).max() <= cut * (1 + 1e-6), \
                f"{where}: max |w| {np.abs(got).max():.4g} past flax's cut {cut:.4g}"
        if kind == "orthogonal":
            for block in got.reshape(-1, arg, arg):
                np.testing.assert_allclose(block.T @ block, np.eye(arg), rtol=0,
                                           atol=ORTHO_ATOL, err_msg=where)
        if w.size >= MIN_KS:
            p = stats.ks_2samp(got.ravel(), w.ravel()).pvalue
            assert p >= KS_P, (f"{where}: KS p {p:.3g} against JAX's draw; std "
                               f"{got.std():.4g} against {w.std():.4g}")
            checked += 1
        else:
            small_port.append(got.ravel() / scale)
            small_jax.append(w.ravel() / scale)
    if small_port:
        a, b = np.concatenate(small_port), np.concatenate(small_jax)
        p = stats.ks_2samp(a, b).pvalue
        assert p >= KS_P, f"{label}: pooled small leaves ({a.size}): KS p {p:.3g}"
    return checked


def _net_init(key):
    """JAX's ``init`` of the net ``key`` as a function of the key."""
    kind, name, dims, kwargs, masked = NETS[key]
    rng = np.random.default_rng(0)
    table = jencoders.ENCODERS if kind == "enc" else jdecoders.DECODERS
    jnet = table[name](latent_dim=LATENTS, data_dim=dims, **kwargs)
    x = (rng.uniform(size=(B,) + dims) if kind == "enc"
         else rng.normal(size=(B, LATENTS))).astype(np.float32)
    mask = jnp.ones((B, dims[0]), bool) if masked else None
    extra = {}
    if name == "TransformerCond":
        tokens = np.eye(VOCAB, dtype=np.float32)[rng.integers(0, VOCAB, (B, 4))]
        extra = {"cond": jnp.asarray(tokens), "cond_mask": jnp.ones((B, 4), bool)}
    return lambda k: jnet.init(k, jnp.asarray(x), mask, **extra)


def _port_net(key):
    kind, name, dims, kwargs, _ = NETS[key]
    if name == "TransformerCond":
        kwargs = dict(kwargs, cond_features=VOCAB)
    get = encoders.get_encoder if kind == "enc" else decoders.get_decoder
    return get(name)(LATENTS, dims, **kwargs)


def _fresh(build):
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(PORT_SEED)
        return build()


def test_every_registry_name_is_covered():
    assert {k for k in NETS if k.startswith("enc-")} == {f"enc-{n}" for n in jencoders.ENCODERS}
    assert {k for k in NETS if k.startswith("dec-")} == {f"dec-{n}" for n in jdecoders.DECODERS}


@pytest.fixture(scope="module")
def jax_inits():
    """{net or model key: the JAX package's init at JAX_SEED, as numpy}:
    each init traced in turn and compiled and run in a pool of threads as
    soon as it is lowered (XLA compiles without the GIL)."""
    key = jax.random.PRNGKey(JAX_SEED)

    def run(lowered):
        return jax.tree_util.tree_map(np.asarray, lowered.compile(FAST_COMPILE)(key))

    inits = {k: _net_init(k) for k in NETS}
    inits.update({k: _model_init(k) for k in MODELS})
    with ThreadPoolExecutor(max_workers=4) as pool:
        pending = {k: pool.submit(run, jax.jit(init).lower(key)) for k, init in inits.items()}
        return {k: fut.result() for k, fut in pending.items()}


@pytest.mark.parametrize("key", list(NETS))
def test_fresh_net_draws_its_leaves_as_flax_does(jax_inits, key):
    """One net of the registries: its fresh leaves against JAX's init."""
    params = jax_inits[key]
    bridged = _port_net(key)
    load_flax_params(bridged, params)
    compare(_fresh(lambda: _port_net(key)), bridged, key)


def _configs(key):
    path, overrides, dims = MODELS[key]
    cfgs = []
    for cls in (Config, JConfig):
        cfg = cls(os.path.join(REPO, path), overrides=dict(overrides), eval_only=True)
        for m, d in zip(cfg.mods, dims):
            m.feature_dims = list(d)
        cfgs.append(cfg)
    return cfgs


def _objective_batch(cfg):
    """A batch of zeros of every modality, all steps valid where it is masked."""
    batch = {}
    for m in cfg.mods:
        dims = tuple(m.feature_dims)
        masked = m.mod_type in ("text", "language", "actions", "sequence")
        batch[m.name] = {"data": jnp.zeros((B,) + dims, jnp.float32),
                         "masks": jnp.ones((B, dims[0]), bool) if masked else None}
    return batch


def _model_init(key):
    """The JAX Trainer's ``init`` of the model of MODELS[key] (its
    objective on a batch of zeros) as a function of the key."""
    jcfg = _configs(key)[1]
    jmodel, batch = jbuild_model(jcfg), _objective_batch(jcfg)
    return lambda k: jmodel.init({"params": k, "sample": k}, batch, method=jmodel.objective)


@pytest.mark.parametrize("key", list(MODELS))
def test_model_from_config_draws_its_leaves_as_flax_does(jax_inits, key):
    """A whole model as ``Trainer.init_state`` builds it, through the
    user's entry point, against the JAX Trainer's init of the same config
    (its priors, mixture parameters and the endpoint head too)."""
    cfg = _configs(key)[0]
    bridged = build_model_from_config(cfg, device="cpu")
    load_flax_params(bridged, jax_inits[key])
    cfg.seed = PORT_SEED
    port = build_model_from_config(cfg, device="cpu")
    assert compare(port, bridged, key) > 0
    if key == "vilanro-aux-endpoint":
        assert hasattr(port, "aux_head")
    if "mixture" in key:
        assert port.pz_mog_loc.shape[0] == 3


def _fsum(t):
    return math.fsum(t.detach().double().flatten().tolist())


def test_judges_and_fixed_vgg_features_keep_their_draws():
    """The judges and the fixed random VGG features draw through the same
    helper; their values are pinned (sums taken exactly), so a judge cached
    by an earlier version and the ``fixed-random`` features stay the same."""
    judge = CNNClassifier(5, seed=0)
    assert _fsum(judge.Conv_0.weight) == 1.6978728340473026
    assert _fsum(judge.Dense_0.weight) == -5.990245537034443
    assert _fsum(judge.Dense_1.bias) == 0.0
    state = perceptual._fixed_random_state()
    assert _fsum(state["Conv_0.weight"]) == 4.234079413021391
    assert _fsum(state["Conv_7.weight"]) == -8.079671421927628
