"""The pretrained-weight layer of the port against the JAX package, on the
CPU: ``VGGFeatures`` and ``InceptionV3`` on JAX's parameters through the
bridge; the three torchvision converters (``eval/weights.py``) on
synthetic torchvision-layout state dicts written here, as
tests/test_weights.py writes them (no weights file is shipped or
downloaded); ``install_pretrained`` and ``Trainer.init_state``'s install.

Tolerances: VGGFeatures within 1e-5 of the largest |value|, InceptionV3
within 1e-4 (rtol 1e-4 of the largest |value|, 42 conv layers); the
converters bit for bit.
"""
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from multimodal_vae_comparison_tpu.eval import weights as JW
from multimodal_vae_comparison_tpu.models.inception import InceptionV3 as JInceptionV3
from multimodal_vae_comparison_tpu.models.nets import ResNet50 as JResNet50
from multimodal_vae_comparison_tpu.models.nets import VGGFeatures as JVGGFeatures
from multimodal_vae_comparison_tpu_torch.bridge import load_flax_params
from multimodal_vae_comparison_tpu_torch.config import Config
from multimodal_vae_comparison_tpu_torch.data_proc import surrogates
from multimodal_vae_comparison_tpu_torch.eval import weights as W
from multimodal_vae_comparison_tpu_torch.models.encoders import Enc_CNN
from multimodal_vae_comparison_tpu_torch.models.inception import InceptionV3, resize_bilinear
from multimodal_vae_comparison_tpu_torch.models.nets import ResNet50, VGGFeatures
from multimodal_vae_comparison_tpu_torch.training.trainer import Trainer
from test_torch_slice import draw_params, one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VGG_TOL = 1e-5
INCEPTION_TOL = 1e-4


def _close(got, want, rel):
    """|got - want| within ``rel`` of the largest |want|."""
    err = np.abs(np.asarray(got) - np.asarray(want)).max()
    limit = rel * np.abs(np.asarray(want)).max()
    assert err <= limit, f"max abs error {err:.3e} > {limit:.3e}"


def _bn(sd, prefix, c, rng):
    sd[f"{prefix}.weight"] = rng.normal(size=(c,)).astype(np.float32)
    sd[f"{prefix}.bias"] = rng.normal(size=(c,)).astype(np.float32)
    sd[f"{prefix}.running_mean"] = rng.normal(size=(c,)).astype(np.float32)
    sd[f"{prefix}.running_var"] = (np.abs(rng.normal(size=(c,))) + 0.5).astype(np.float32)
    sd[f"{prefix}.num_batches_tracked"] = np.zeros((), np.int64)


def _conv(rng, cout, cin, kh, kw=None):
    """A torch-layout (OIHW) kernel scaled by its fan-in, so that deep
    synthetic nets stay finite in fp32."""
    kw = kh if kw is None else kw
    return (rng.normal(size=(cout, cin, kh, kw)) / math.sqrt(cin * kh * kw)).astype(np.float32)


def torchvision_vgg19_sd(rng):
    """torchvision vgg19's ``features.*`` convs by their module indices, and a
    classifier entry the converter drops."""
    sd = {}
    cin = 3
    for idx, cout in zip((0, 2, 5, 7, 10, 12, 14, 16), (64, 64, 128, 128, 256, 256, 256, 256)):
        sd[f"features.{idx}.weight"] = _conv(rng, cout, cin, 3)
        sd[f"features.{idx}.bias"] = (0.1 * rng.normal(size=(cout,))).astype(np.float32)
        cin = cout
    sd["classifier.0.weight"] = rng.normal(size=(8, 8)).astype(np.float32)
    return sd


def torchvision_resnet50_sd(rng):
    sd = {"conv1.weight": _conv(rng, 64, 3, 7),
          "fc.weight": (rng.normal(size=(1000, 2048)) / 45).astype(np.float32),
          "fc.bias": rng.normal(size=(1000,)).astype(np.float32)}
    _bn(sd, "bn1", 64, rng)
    cin = 64
    for s, n_blocks in enumerate((3, 4, 6, 3)):
        width = 64 * 2 ** s
        for j in range(n_blocks):
            t = f"layer{s + 1}.{j}"
            for c, (cout, ci, k) in enumerate(((width, cin, 1), (width, width, 3),
                                               (width * 4, width, 1))):
                sd[f"{t}.conv{c + 1}.weight"] = _conv(rng, cout, ci, k)
                _bn(sd, f"{t}.bn{c + 1}", cout, rng)
            if j == 0:
                sd[f"{t}.downsample.0.weight"] = _conv(rng, width * 4, cin, 1)
                _bn(sd, f"{t}.downsample.1", width * 4, rng)
            cin = width * 4
    return sd


def torchvision_inception_sd(rng):
    """torchvision inception_v3's layout (every ``<block>.conv.weight`` and
    ``<block>.bn.*``, ``num_batches_tracked`` among them) at the shapes of
    the port's modules, and the ``fc`` and ``AuxLogits`` entries the
    converter drops."""
    sd = {}
    for name, p in InceptionV3().state_dict().items():
        block, leaf = name.rsplit(".", 1)
        if block.endswith(".conv"):
            sd[name] = _conv(rng, *p.shape)
        elif leaf == "weight":
            _bn(sd, block, p.shape[0], rng)
    sd["fc.weight"] = rng.normal(size=(1000, 2048)).astype(np.float32)
    sd["fc.bias"] = rng.normal(size=(1000,)).astype(np.float32)
    sd["AuxLogits.fc.weight"] = rng.normal(size=(1000, 768)).astype(np.float32)
    return sd


def _bridged(module, flax_params):
    load_flax_params(module, flax_params)
    return module.state_dict()


def _assert_equal_states(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == torch.float32, k
        assert torch.equal(got[k], want[k]), k


# -- the feature nets against JAX's ---------------------------------------------------------


@pytest.fixture(scope="module")
def jax_vgg():
    shapes = jax.eval_shape(lambda: JVGGFeatures().init(jax.random.PRNGKey(0),
                                                        jnp.zeros((1, 32, 32, 3))))
    return draw_params(shapes, 3)


@pytest.mark.parametrize("taps", ["pool", "conv"])
def test_vgg_features_match_jax(jax_vgg, taps):
    """Both tap modes at 32x32, bs 2, on JAX's parameters: 3 pool maps or 8
    pre-relu conv maps, NHWC, within 1e-5 of the largest |value|."""
    x = np.random.default_rng(0).random((2, 32, 32, 3)).astype(np.float32)
    want = JVGGFeatures().apply(jax_vgg, jnp.asarray(x), taps=taps)
    net = VGGFeatures()
    load_flax_params(net, jax_vgg)
    with torch.no_grad():
        got = net(torch.from_numpy(x), taps=taps)
    assert len(got) == len(want) == (3 if taps == "pool" else 8)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        _close(g.numpy(), w, VGG_TOL)


@pytest.fixture(scope="module")
def jax_inception():
    """JAX's InceptionV3 parameters drawn from a seed, each FrozenBatchNorm's
    running variance made positive."""
    shapes = jax.eval_shape(lambda: JInceptionV3().init(jax.random.PRNGKey(0),
                                                        jnp.zeros((1, 75, 75, 3))))
    return jax.tree_util.tree_map_with_path(
        lambda path, v: np.abs(v) + 0.5 if path[-1].key == "var" else v,
        draw_params(shapes, 4))


@pytest.mark.parametrize("size,resize,channels", [(75, False, 3), (64, True, 1)])
def test_inception_v3_matches_jax(jax_inception, size, resize, channels):
    """InceptionV3 pool-3 features on JAX's parameters, bs 2: at 75 x 75
    without the resize, and from 64 px one-channel images through the
    resize to 299 and the repeat to three channels (the [-1, 1] rescale on
    both); within 1e-4."""
    x = np.random.default_rng(1).random((2, size, size, channels)).astype(np.float32)
    want = jax.jit(lambda p, v: JInceptionV3(resize_input=resize).apply(p, v))(
        jax_inception, jnp.asarray(x))
    net = InceptionV3(resize_input=resize)
    load_flax_params(net, jax_inception)
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    assert tuple(got.shape) == want.shape == (2, 2048)
    _close(got.numpy(), want, INCEPTION_TOL)


def _triangle_weights(n_in, n_out):
    """The (n_out, n_in) float64 weights of a half-pixel-centred bilinear
    resize, the triangle widened by the scale when it shrinks, normalised
    over the taps inside the image."""
    scale = n_in / n_out
    width = max(scale, 1.0)
    centres = (np.arange(n_out) + 0.5) * scale
    w = np.maximum(0.0, 1 - np.abs(np.arange(n_in)[None, :] + 0.5 - centres[:, None]) / width)
    return w / w.sum(1, keepdims=True)


# the largest |error| of a float32 resize: enlarging, both packages agree to
# rounding; shrinking, each float32 filter is ~3e-5 off the float64 one
RESIZE_ATOL = {64: 2e-6, 320: 5e-5}


@pytest.mark.parametrize("size", [64, 320])
def test_resize_matches_jax_image_resize_both_directions(size):
    """The resize to 299 against ``jax.image.resize(..., "bilinear")`` on
    images in [0, 1], 1 and 3 channels: enlarging 64 px (half-pixel
    centres, the borders clamped) and shrinking 320 px (antialiased), each
    within RESIZE_ATOL of JAX's; in float64 the port's equals the triangle
    filter itself."""
    rng = np.random.default_rng(size)
    exact = _triangle_weights(size, 299)
    for c in (1, 3):
        x = rng.random((2, size, size, c)).astype(np.float32)
        want = jax.image.resize(jnp.asarray(x), (2, 299, 299, c), "bilinear")
        got = resize_bilinear(torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=RESIZE_ATOL[size])
        got64 = resize_bilinear(torch.from_numpy(x.astype(np.float64)))
        np.testing.assert_allclose(got64.numpy(),
                                   np.einsum("ij,bjkc,lk->bilc", exact, x, exact, optimize=True),
                                   rtol=0, atol=1e-12)


# -- the converters --------------------------------------------------------------------


def test_convert_vgg19_equals_jax_converter_bridged():
    """The port's vgg19 conversion equals the JAX converter's flax tree
    bridged into VGGFeatures, bit for bit, and loads into VGGFeatures."""
    sd = torchvision_vgg19_sd(np.random.default_rng(0))
    got = W.convert_vgg19(sd)
    _assert_equal_states(got, _bridged(VGGFeatures(), JW.convert_vgg19(sd)))
    W.load_checked(VGGFeatures(), got)
    with pytest.raises(ValueError, match="need 8"):
        W.convert_vgg19({k: v for k, v in sd.items() if not k.startswith("features.16")})


def test_convert_resnet50_equals_jax_converter_bridged():
    """The same for the ResNet-50 (its fc is the trunk's Dense_0)."""
    sd = torchvision_resnet50_sd(np.random.default_rng(1))
    got = W.convert_resnet50(sd)
    _assert_equal_states(got, _bridged(ResNet50(), JW.convert_resnet50(sd)))
    torch.testing.assert_close(got["Dense_0.weight"], torch.from_numpy(sd["fc.weight"]),
                               rtol=0, atol=0)


def test_convert_inception_equals_jax_converter_bridged():
    """The same for InceptionV3; fc, AuxLogits and num_batches_tracked are
    dropped; an entry of no conv or bn raises as JAX's converter does."""
    sd = torchvision_inception_sd(np.random.default_rng(2))
    got = W.convert_inception(sd)
    _assert_equal_states(got, _bridged(InceptionV3(), JW.convert_inception(sd)))
    assert not any(k.startswith(("fc.", "AuxLogits.")) or "num_batches" in k for k in got)
    bad = dict(sd, **{"Mixed_5b.branch1x1.extra.weight": np.zeros(3, np.float32)})
    for convert in (W.convert_inception, JW.convert_inception):
        with pytest.raises(KeyError, match="unexpected inception_v3 entry"):
            convert(bad)


def test_convert_inception_value_golden():
    """A ramp tensor in torch's OIHW layout stays where it is (no transpose
    in the port), and JAX's HWIO kernel bridged back gives the same ramp;
    the BatchNorm fields land on FrozenBatchNorm's weight, bias, mean and
    var; fc is dropped (tests/test_weights.py's golden check)."""
    O, I, H, Wd = 5, 4, 3, 2
    ramp = np.arange(O * I * H * Wd, dtype=np.float32).reshape(O, I, H, Wd)
    sd = {"Conv2d_1a_3x3.conv.weight": ramp,
          "Conv2d_1a_3x3.bn.weight": np.arange(O, dtype=np.float32),
          "Conv2d_1a_3x3.bn.bias": np.arange(O, dtype=np.float32) + 100,
          "Conv2d_1a_3x3.bn.running_mean": np.arange(O, dtype=np.float32) + 200,
          "Conv2d_1a_3x3.bn.running_var": np.arange(O, dtype=np.float32) + 300,
          "Conv2d_1a_3x3.bn.num_batches_tracked": np.zeros((), np.int64),
          "fc.weight": np.zeros((7, 3), np.float32)}
    got = W.convert_inception(sd)
    assert sorted(got) == ["Conv2d_1a_3x3.bn.bias", "Conv2d_1a_3x3.bn.mean",
                           "Conv2d_1a_3x3.bn.var", "Conv2d_1a_3x3.bn.weight",
                           "Conv2d_1a_3x3.conv.weight"]
    np.testing.assert_array_equal(got["Conv2d_1a_3x3.conv.weight"].numpy(), ramp)
    jkern = JW.convert_inception(sd)["params"]["Conv2d_1a_3x3"]["conv"]["kernel"]
    conv = torch.nn.Conv2d(I, O, (H, Wd), bias=False)
    load_flax_params(conv, {"kernel": jkern})
    np.testing.assert_array_equal(conv.weight.detach().numpy(), ramp)
    for leaf, src in (("weight", "weight"), ("bias", "bias"), ("mean", "running_mean"),
                      ("var", "running_var")):
        np.testing.assert_array_equal(got[f"Conv2d_1a_3x3.bn.{leaf}"].numpy(),
                                      sd[f"Conv2d_1a_3x3.bn.{src}"])


# -- installing ------------------------------------------------------------------------


def _enc_cnn():
    torch.manual_seed(0)
    return Enc_CNN(4, (64, 64, 3))


def test_install_pretrained_noop_without_files(tmp_path, monkeypatch):
    monkeypatch.setenv("MVAE_TPU_WEIGHTS_DIR", str(tmp_path / "empty"))
    enc = _enc_cnn()
    before = {k: v.clone() for k, v in enc.state_dict().items()}
    assert W.install_pretrained(enc, verbose=False) == []
    _assert_equal_states(enc.state_dict(), before)
    assert W.find_weights_file("resnet50") is None
    assert W.vgg19_feature_params() is None and W.inception_feature_params() is None


@pytest.mark.parametrize("fmt", ["npz", "pt"])
def test_install_pretrained_fills_the_trunk_with_the_file(tmp_path, monkeypatch, fmt):
    """A resnet50 file (``.npz``, or ``.pt`` read by torch.load) lands in
    Enc_CNN's trunk: every tensor of the trunk equal to the file's, as JAX's
    install of the same file, bridged; the head untouched; the encoder
    runs."""
    monkeypatch.setenv("MVAE_TPU_WEIGHTS_DIR", str(tmp_path))
    sd = torchvision_resnet50_sd(np.random.default_rng(5))
    if fmt == "npz":
        np.savez(tmp_path / "resnet50.npz", **sd)
    else:
        torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, tmp_path / "resnet50.pt")
    enc = _enc_cnn()
    head = {k: v.clone() for k, v in enc.state_dict().items() if not k.startswith("ResNet50_0")}
    report = W.install_pretrained(enc, verbose=False)
    assert len(report) == 1 and "ResNet50_0" in report[0]
    trunk = {k[len("ResNet50_0."):]: v for k, v in enc.state_dict().items()
             if k.startswith("ResNet50_0.")}
    _assert_equal_states(trunk, _bridged(ResNet50(), JW.convert_resnet50(sd)))
    torch.testing.assert_close(trunk["Conv_0.weight"], torch.from_numpy(sd["conv1.weight"]),
                               rtol=0, atol=0)
    torch.testing.assert_close(trunk["FrozenBatchNorm_0.mean"],
                               torch.from_numpy(sd["bn1.running_mean"]), rtol=0, atol=0)
    for k, v in head.items():
        assert torch.equal(enc.state_dict()[k], v), k
    with torch.no_grad():
        mu, _ = enc(torch.ones(2, 64, 64, 3))
    assert mu.shape == (2, 4) and torch.isfinite(mu).all()


def test_install_pretrained_refuses_a_file_that_does_not_fit(tmp_path, monkeypatch):
    """A checkpoint cut short raises ValueError naming the shape mismatch,
    as JAX's install does, and leaves nothing half installed."""
    monkeypatch.setenv("MVAE_TPU_WEIGHTS_DIR", str(tmp_path))
    sd = torchvision_resnet50_sd(np.random.default_rng(6))
    sd["layer4.2.conv3.weight"] = sd["layer4.2.conv3.weight"][:32]
    np.savez(tmp_path / "resnet50.npz", **sd)
    enc = _enc_cnn()
    before = {k: v.clone() for k, v in enc.state_dict().items()}
    with pytest.raises(ValueError, match="shape mismatch"):
        W.install_pretrained(enc, verbose=False)
    _assert_equal_states(enc.state_dict(), before)
    jvars = jax.eval_shape(lambda: JResNet50().init(jax.random.PRNGKey(0),
                                                    jnp.zeros((1, 64, 64, 3))))
    jvars = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), jvars)
    with pytest.raises(ValueError, match="shape mismatch"):
        JW.install_pretrained({"params": {"ResNet50_0": jvars["params"]}}, verbose=False)
    with pytest.raises(KeyError, match="unknown entry"):
        W.load_checked(ResNet50(), {"Conv_9.weight": torch.zeros(1)})


def _celeba_trainer(tmp_path):
    """A Trainer of configs/config_celeba.yml (POE; modality_1 the
    ResNet-50 ``Enc_CNN``) on a 24-row CelebA surrogate, on the CPU."""
    d = str(tmp_path / "celeba")
    surrogates.build_celeba(d, n_train=24, n_test=8, seed=0)
    with open(os.path.join(REPO, "configs/config_celeba.yml")) as f:
        params = yaml.safe_load(f)
    for i, stem in ((1, "images.npy"), (2, "atts.npy")):
        params[f"modality_{i}"].update(path=os.path.join(d, stem),
                                       test_datapath=os.path.join(d, "test_" + stem))
    params.update(batch_size=8)
    return Trainer(Config(params, results_root=str(tmp_path / "results")), device="cpu",
                   enable_viz=False)


def test_trainer_init_state_installs_the_trunk(tmp_path, monkeypatch):
    """Trainer.init_state: without a resnet50 file, the seed's weights as
    they are; with one, the Enc_CNN trunk equal to the file and every
    other tensor the seed's; a file that does not fit raises (the JAX
    package's trainer prints "install skipped" instead)."""
    monkeypatch.setenv("MVAE_TPU_WEIGHTS_DIR", str(tmp_path / "weights"))
    trainer = _celeba_trainer(tmp_path)
    trainer.init_state()
    fresh = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    os.makedirs(tmp_path / "weights")
    sd = torchvision_resnet50_sd(np.random.default_rng(7))
    np.savez(tmp_path / "weights" / "resnet50.npz", **sd)
    trainer.init_state()
    want = W.convert_resnet50(sd)
    prefix = "enc_mod_1.ResNet50_0."
    state = trainer.model.state_dict()
    trunk = {k[len(prefix):]: v for k, v in state.items() if k.startswith(prefix)}
    assert sorted(trunk) == sorted(want)
    for k, v in want.items():
        assert torch.equal(trunk[k], v), k
    for k, v in state.items():
        if not k.startswith(prefix):
            assert torch.equal(v, fresh[k]), k
    sd["conv1.weight"] = sd["conv1.weight"][:, :1]
    np.savez(tmp_path / "weights" / "resnet50.npz", **sd)
    with pytest.raises(ValueError, match="shape mismatch"):
        trainer.init_state()
