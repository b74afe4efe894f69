"""``precision: bf16`` of the port against the JAX package's, on the CPU.

The JAX package trains in bf16 by building every layer with ``dtype=bf16``
(parameters fp32); the port casts at each layer the same way
(``models/precision.py``).  The two round in different places (XLA and
PyTorch fuse and accumulate differently), so no fixed fp32 tolerance
applies.  The yardstick: for an output, a loss, a metric or a gradient
leaf, the port's bf16 result may differ from the JAX package's bf16 result
by at most ``C`` times the JAX package's own bf16 error, |JAX bf16 - JAX
fp32|, plus ``ATOL``; arrays are measured by their max abs difference in
units of the JAX bf16 array's max |x| (a gradient leaf's max |g|), scalars
in units of their fp32 value.

The JAX bf16 result is jitted with ``xla_allow_excess_precision`` off
(:func:`_jit_bf16`), so that it rounds to bf16 wherever the model's ops
say, as op-by-op execution and PyTorch do (it equals JAX's un-jitted
result to 4e-8 of a leaf's max |g|, ten times faster): with the default
on, XLA drops the bf16 round trips inside its fusions, which put the
flagship MOE's image-decoder Dense gradients 3.6-4.4 times its own
(smaller) bf16 gap away from the port; rounding as written the worst leaf
is 1.8 times it.  The fp32 result is jitted as usual.

``C = 3``: measured against that, the port's gap to JAX bf16 is at most
1.8 times JAX's own bf16 gap, leaf by leaf (flagship POE and MOE).
``ATOL = 2 ** -8`` (bf16's unit roundoff): where JAX's bf16 lands within
rounding of its fp32 (a metric of fp32 posteriors, a leaf whose terms
cancel), the two packages may still differ by a bf16 rounding of it.
The video model is compared on the same relu branches: the JAX package's
fp32 run and the port take the branches of the JAX bf16 run
(``same_branches``).  Four residual blocks of GroupNorm and relu deep, its
encoder's relu inputs within bf16 rounding of 0 take either branch (355
of 245,760 in the port against float64, 420 in JAX, each on elements of
its own), and these carry most of its deep leaves' bf16 error: the port
rounds no worse
(``test_video_encoder_bf16_rounds_as_near_float64_as_jax``), but on its
own branches a few leaves sit more than 3 times JAX's gap away.  On the
same branches it is at most 1.9 times JAX's gap away, at 2 ** -8.  Run
this file as a script (``PYTHONPATH=. JAX_PLATFORMS=cpu python
tests/test_torch_bf16.py``) for the table and the worst leaf.

Weights are drawn with numpy in flax's layout and bridged; inputs and
noise come from numpy; DReG is not compared here (its weights are a
softmax of log-weights near -1e5, held in fp32 by ``test_torch_video.py``
and ``test_torch_sprites.py`` on replayed weights).
"""
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from multimodal_vae_comparison_tpu.models import get_mixing as jget_mixing
from multimodal_vae_comparison_tpu.models import nets as jnets
from multimodal_vae_comparison_tpu.models.base import ModalitySpec as JSpec
from multimodal_vae_comparison_tpu.models.distributions import Normal as JNormal
from multimodal_vae_comparison_tpu.models.encoders import Enc_CNN as JEnc_CNN
from multimodal_vae_comparison_tpu.ops.pallas import attention as jattn
from multimodal_vae_comparison_tpu_torch.bridge import load_flax_params
from multimodal_vae_comparison_tpu_torch.config import Config
from multimodal_vae_comparison_tpu_torch.eval.infer import MultimodalVAEInfer
from multimodal_vae_comparison_tpu_torch.models import get_mixing
from multimodal_vae_comparison_tpu_torch.models import nets as tnets
from multimodal_vae_comparison_tpu_torch.models import objectives as tobj
from multimodal_vae_comparison_tpu_torch.models import precision
from multimodal_vae_comparison_tpu_torch.models.base import ModalitySpec
from multimodal_vae_comparison_tpu_torch.models.decoders import _LOGIT_BOUND
from multimodal_vae_comparison_tpu_torch.models.distributions import Normal
from multimodal_vae_comparison_tpu_torch.models.encoders import Enc_CNN
from multimodal_vae_comparison_tpu_torch.ops.kernels import attention as tattn
from multimodal_vae_comparison_tpu_torch.ops.kernels import (
    kl_kernel, poe_kernel, sample_kernel, telemetry)
from multimodal_vae_comparison_tpu_torch.training.trainer import (
    Trainer, build_model, build_model_from_config, precision_dtype)
from test_torch_slice import (  # noqa: F401 (one_torch_thread: autouse)
    FLAGSHIP, draw_params, numpy_batch, one_torch_thread, spec_kwargs)
from test_torch_modules import flax_params
from test_torch_zoo import draw_params as zoo_draw_params

C = 3.0
ATOL = 2.0 ** -8
BF16 = torch.bfloat16


def _jit_bf16(fn, *args):
    """``fn(*args)`` jitted with XLA's excess precision off: every bf16
    value rounded where the program says, as un-jitted JAX rounds it."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32)) if not torch.is_tensor(x) \
        else x.detach().float().numpy()


def assert_within(got, jb, jf, what="", scale=None, atol=ATOL):
    """``got`` (the port's bf16) against the JAX package's bf16 ``jb`` and
    fp32 ``jf``: max |got - jb| <= C max |jb - jf| + atol, in units of
    ``scale`` (max |jb| unless given)."""
    got, jb, jf = _np(got), _np(jb), _np(jf)
    assert got.shape == jb.shape, (what, got.shape, jb.shape)
    s = float(np.abs(jb).max()) if scale is None else scale
    s = s if s > 0 else 1.0
    err, gap = np.abs(got - jb).max() / s, np.abs(jb - jf).max() / s
    assert np.all(np.isfinite(got)), what
    assert err <= C * gap + atol, f"{what}: port-JAX bf16 {err:.3e} > {C} x {gap:.3e} + {atol}"


def assert_scalar_within(got, jb, jf, what=""):
    got, jb, jf = float(got), float(jb), float(jf)
    limit = C * abs(jb - jf) + ATOL * max(abs(jf), 1e-6)
    assert abs(got - jb) <= limit, f"{what}: {got} vs JAX bf16 {jb} (fp32 {jf})"


def _bf16_round(x: np.ndarray) -> np.ndarray:
    """``x`` rounded to bf16's values, as the previous layer hands it on."""
    return np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


# -- per module ---------------------------------------------------------------------


def _module_case(jmod, make, x, seed=0):
    """The flax module ``jmod(dtype)`` at bf16 and fp32 and the port's
    ``make()`` at bf16 on one input ``x`` (one layout in both), weights
    bridged: the output and the gradients of ``sum(out * w)`` for a random
    ``w`` by the parameters and the input, each within the yardstick."""
    xj = jnp.asarray(x)
    params = flax_params(jmod(jnp.float32), xj, seed=seed)
    res = {}
    for name, dt in (("bf16", jnp.bfloat16), ("f32", jnp.float32)):
        m = jmod(dt)
        out = m.apply(params, xj)
        w = np.random.default_rng(seed + 1).normal(size=out.shape).astype(np.float32)
        f = lambda p, a, m=m: jnp.sum(m.apply(p, a).astype(jnp.float32) * w)
        res[name] = (out,) + jax.grad(f, argnums=(0, 1))(params, xj)
    tmod = make()
    load_flax_params(tmod, params)
    precision.set_compute_dtype(tmod, BF16)
    xt = torch.from_numpy(np.array(x)).requires_grad_()
    out = tmod(xt)
    (out.float() * torch.from_numpy(w)).sum().backward()
    assert out.dtype == BF16
    assert_within(out, res["bf16"][0], res["f32"][0], "output")
    assert_within(xt.grad, res["bf16"][2], res["f32"][2], "input grad")
    gb, gf = make(), make()
    load_flax_params(gb, jax.tree_util.tree_map(np.asarray, res["bf16"][1]))
    load_flax_params(gf, jax.tree_util.tree_map(np.asarray, res["f32"][1]))
    for (name, p), b, f in zip(tmod.named_parameters(), gb.parameters(), gf.parameters()):
        assert p.dtype == torch.float32, name
        assert_within(p.grad, b, f, name)


@pytest.mark.parametrize("shape", [(6, 12), (3, 5, 12)], ids=["2d", "3d"])
def test_dense_matches_flax_dense_in_bf16(shape):
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    _module_case(lambda dt: fnn.Dense(16, dtype=dt), lambda: precision.Linear(12, 16), x)


def test_layernorm_normalizes_in_fp32_and_returns_bf16():
    x = _bf16_round(np.random.default_rng(1).normal(2.0, 3.0, size=(4, 7, 16)))
    _module_case(lambda dt: fnn.LayerNorm(dtype=dt),
                 lambda: precision.LayerNorm(16, eps=tnets.LN_EPS), x)


@pytest.mark.parametrize("channels", [16, 12])
def test_group_norm_normalizes_in_fp32_and_returns_bf16(channels):
    x = _bf16_round(np.random.default_rng(2).normal(1.0, 2.0, size=(2, 3, 4, 4, channels)))
    _module_case(lambda dt: fnn.GroupNorm(num_groups=math.gcd(8, channels), dtype=dt),
                 lambda: tnets.GroupNorm(channels), x)


def test_frozen_batch_norm_rounds_its_folded_scale_to_bf16():
    """The reference's FrozenBatchNorm casts ``scale * rsqrt(var + eps)`` and
    the shift to the compute dtype; the port takes that elementwise form
    under a compute dtype (NCHW in the port, NHWC in the reference)."""
    rng = np.random.default_rng(3)
    x = _bf16_round(rng.normal(size=(2, 5, 5, 8)))
    jm = lambda dt: jnets.FrozenBatchNorm(dtype=dt)
    xj = jnp.asarray(x)
    params = flax_params(jm(jnp.float32), xj, seed=3)
    params = jax.tree_util.tree_map_with_path(
        lambda p, v: (np.abs(v) + 0.5).astype(np.float32) if p[-1].key == "var" else v, params)
    w = rng.normal(size=x.shape).astype(np.float32)
    res = {}
    for name, dt in (("bf16", jnp.bfloat16), ("f32", jnp.float32)):
        m = jm(dt)
        f = lambda p, a, m=m: jnp.sum(m.apply(p, a).astype(jnp.float32) * w)
        res[name] = (m.apply(params, xj.astype(dt)),) + jax.grad(f, argnums=(0, 1))(params, xj)
    tmod = tnets.FrozenBatchNorm(8)
    load_flax_params(tmod, params)
    precision.set_compute_dtype(tmod, BF16)
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).requires_grad_()
    out = tmod(xt)
    (out.float() * torch.from_numpy(w.transpose(0, 3, 1, 2).copy())).sum().backward()
    nchw = lambda a: _np(a).transpose(0, 3, 1, 2)
    assert out.dtype == BF16
    assert_within(out, nchw(res["bf16"][0]), nchw(res["f32"][0]), "output")
    assert_within(xt.grad, nchw(res["bf16"][2]), nchw(res["f32"][2]), "input grad")
    assert_within(tmod.weight.grad, res["bf16"][1]["params"]["scale"],
                  res["f32"][1]["params"]["scale"], "scale")
    assert_within(tmod.bias.grad, res["bf16"][1]["params"]["bias"],
                  res["f32"][1]["params"]["bias"], "bias")


def test_conv_transpose_2d_torch_matches_flax_in_bf16():
    x = np.random.default_rng(4).random((2, 6, 6, 8)).astype(np.float32)
    _module_case(lambda dt: jnets.ConvTranspose2dTorch(5, dtype=dt),
                 lambda: tnets.ConvTranspose2dTorch(8, 5), x)


def test_same_pad_conv3d_matches_flax_in_bf16():
    x = np.random.default_rng(5).random((2, 4, 8, 8, 6)).astype(np.float32)
    _module_case(lambda dt: jnets.SamePadConv3d(8, kernel=4, strides=(1, 2, 2), dtype=dt),
                 lambda: tnets.SamePadConv3d(6, 8, kernel=4, strides=(1, 2, 2)), x)


@pytest.fixture
def flash_interpret(monkeypatch):
    """The JAX package's Pallas attention in interpret mode, as its own
    tests run it on the CPU."""
    monkeypatch.setattr(jattn, "_INTERPRET", True)
    monkeypatch.setenv("MMVAE_TPU_FLASH_ATTN", "1")
    assert jattn.use_flash_attention()


@pytest.mark.parametrize("masked", [False, True])
def test_multi_head_attention_matches_the_pallas_kernel_path_in_bf16(flash_interpret, masked):
    """DenseGeneral q/k/v in bf16, the kernel on bf16 inputs (widened, fp32
    out), the output cast to bf16 and the out Dense in bf16."""
    rng = np.random.default_rng(6)
    b, t, d = 2, 9, 16
    x = rng.normal(size=(b, t, d)).astype(np.float32)
    mask = np.arange(t)[None, :] < np.array([[t], [4]]) if masked else None
    bias = None if mask is None else jnp.where(jnp.asarray(mask)[:, None, None, :], 0.0, -1e9)
    jm = lambda dt: jnets.MultiHeadAttention(num_heads=2, dtype=dt)
    xj = jnp.asarray(x)
    params = flax_params(jm(jnp.float32), xj, xj, bias, seed=6)
    w = rng.normal(size=x.shape).astype(np.float32)
    res = {}
    for name, dt in (("bf16", jnp.bfloat16), ("f32", jnp.float32)):
        m = jm(dt)
        f = lambda p, a, m=m: jnp.sum(m.apply(p, a, a, bias).astype(jnp.float32) * w)
        res[name] = (m.apply(params, xj, xj, bias),) + jax.grad(f, argnums=(0, 1))(params, xj)
    tmod = tnets.MultiHeadAttention(d, 2)
    load_flax_params(tmod, params)
    precision.set_compute_dtype(tmod, BF16)
    xt = torch.from_numpy(x).requires_grad_()
    telemetry.reset()
    out = tmod(xt, xt, None if mask is None else torch.from_numpy(mask))
    (out.float() * torch.from_numpy(w)).sum().backward()
    assert telemetry.summary() == {"attention:plain": 1}
    assert out.dtype == BF16
    assert_within(out, res["bf16"][0], res["f32"][0], "output")
    assert_within(xt.grad, res["bf16"][2], res["f32"][2], "input grad")
    gb, gf = tnets.MultiHeadAttention(d, 2), tnets.MultiHeadAttention(d, 2)
    load_flax_params(gb, jax.tree_util.tree_map(np.asarray, res["bf16"][1]))
    load_flax_params(gf, jax.tree_util.tree_map(np.asarray, res["f32"][1]))
    kw = dict(gb.named_parameters())["key.weight"].abs().max().item()
    for (name, p), gbp, gfp in zip(tmod.named_parameters(), gb.parameters(), gf.parameters()):
        # a key bias has an exact gradient of 0: its noise at its weight's scale
        assert_within(p.grad, gbp, gfp, name, scale=kw if name == "key.bias" else None)


def test_kernels_take_bf16_and_return_fp32_with_grads_in_the_inputs_dtype():
    """Both attention wrappers on bf16 q, k, v: an fp32 result equal to the
    plain version on the widened inputs, and dq, dk, dv in bf16, the
    widened inputs' gradients rounded once."""
    from multimodal_vae_comparison_tpu_torch.ops.kernels import sparse_attention as tsp
    rng = np.random.default_rng(7)
    cases = (("masked", (2, 2, 9, 8), lambda q, k, v: tattn.masked_attention(q, k, v)),
             ("sparse", (1, 2, 32, 8),
              lambda q, k, v: tsp.strided_block_sparse_attention(q, k, v, 8, 2)))
    for name, shape, fn in cases:
        qkv = [torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(BF16)
               for _ in range(3)]
        leaves = [x.clone().requires_grad_() for x in qkv]
        wide = [x.float().requires_grad_() for x in qkv]
        out, ref = fn(*leaves), fn(*wide)
        assert out.dtype == torch.float32, name
        torch.testing.assert_close(out, ref, rtol=0, atol=0)
        g = torch.from_numpy(rng.normal(size=out.shape).astype(np.float32))
        out.backward(g)
        ref.backward(g)
        for a, b in zip(leaves, wide):
            assert a.grad.dtype == BF16, name
            torch.testing.assert_close(a.grad, b.grad.to(BF16), rtol=0, atol=0)


def test_strided_sparse_block_matches_flax_in_bf16():
    """The sparse attention block (q/k/v DenseGeneral, the kernel, the output
    cast, the out Dense) in bf16 against the JAX package's dense jnp path."""
    rng = np.random.default_rng(8)
    x = rng.normal(size=(1, 28, 16)).astype(np.float32)   # padded to 32 inside
    _module_case(lambda dt: jnets.StridedSparseSelfAttention(num_heads=2, block=8,
                                                             block_stride=2, dtype=dt),
                 lambda: tnets.StridedSparseSelfAttention(16, 2, block=8, block_stride=2),
                 x, seed=8)


# -- the losses ----------------------------------------------------------------------


def test_bce_logits_path_finite_in_bf16_at_saturation():
    """The port's counterpart of tests/test_objectives.py's: in bf16 1 - 1e-6
    rounds to 1.0, and the logits path stays finite with finite gradients;
    the per-row sum is fp32."""
    x = torch.tensor([[40.0, -40.0, 0.0]], dtype=BF16)
    x_c = torch.clamp(x, -_LOGIT_BOUND, _LOGIT_BOUND).requires_grad_()
    t = torch.tensor([[0.0, 1.0, 1.0]], dtype=BF16)
    ll = tobj.bce(Normal(torch.sigmoid(x_c), torch.tensor(0.75), loc_logits=x_c), t)
    assert ll.dtype == torch.float32
    ll.sum().backward()
    assert torch.isfinite(ll).all() and torch.isfinite(x_c.grad.float()).all()
    # and the JAX package's value of the same
    from multimodal_vae_comparison_tpu.models import objectives as jobj
    jx = jnp.clip(jnp.asarray([[40.0, -40.0, 0.0]], jnp.bfloat16), -_LOGIT_BOUND, _LOGIT_BOUND)
    want = jobj.bce(JNormal(jax.nn.sigmoid(jx), jnp.float32(0.75), loc_logits=jx),
                    jnp.asarray([[0.0, 1.0, 1.0]], jnp.bfloat16))
    np.testing.assert_allclose(ll.detach().numpy(), np.asarray(want), rtol=1e-2)


def test_bf16_image_objective_end_to_end_finite():
    """The port's counterpart of tests/test_objectives.py's full-model
    regression: a bf16 PoE with a bce image modality (the ResNet-50 encoder)
    gives a finite loss and finite gradients, the parameters fp32."""
    specs = (ModalitySpec(name="mod_1", encoder="CNN", decoder="CNN",
                          feature_dims=(64, 64, 3), recon_loss="bce"),
             ModalitySpec(name="mod_2", encoder="FNN", decoder="FNN",
                          feature_dims=(6,), recon_loss="mse"))
    model = build_model(specs, "poe", 8, device="cpu", dtype=BF16)
    rng = np.random.default_rng(0)
    batch = {"mod_1": {"data": torch.from_numpy(rng.random((4, 64, 64, 3)).astype(np.float32)),
                       "masks": None},
             "mod_2": {"data": torch.ones(4, 6), "masks": None}}
    loss, _ = model.objective(batch, generator=torch.Generator().manual_seed(0))
    loss.backward()
    assert loss.dtype == torch.float32 and torch.isfinite(loss)
    for name, p in model.named_parameters():
        assert p.dtype == torch.float32, name
        assert p.grad is None or torch.isfinite(p.grad).all(), name


# -- per model -----------------------------------------------------------------------


class _Recorder:
    """Keep each standard-normal draw of the JAX Normal.rsample (in fp32:
    the posteriors are fp32 in bf16 too)."""

    def __init__(self, monkeypatch):
        from multimodal_vae_comparison_tpu.models import distributions as jdist
        self.draws = []

        def rsample(dist, key, sample_shape=()):
            shape = tuple(sample_shape) + jnp.shape(dist.loc)
            eps = jax.random.normal(key, shape, dtype=jnp.result_type(dist.loc))
            self.draws.append(eps)
            return dist.loc + eps * dist.scale

        monkeypatch.setattr(jdist.Normal, "rsample", rsample)


class _Branches:
    """flax's ``relu`` recording, in call order, the branch each element
    takes (the sign of its input), or, with ``replay`` set to such a
    record, taking those branches: ``relu(h)`` becomes ``h * mask``, whose
    value and gradient are relu's on the recorded side of 0."""

    def __init__(self, monkeypatch):
        self.signs, self.replay = [], None
        relu = fnn.relu

        def branch(h):
            if self.replay is None:
                self.signs.append(h > 0)
                return relu(h)
            mask = self.replay[len(self.signs)]
            self.signs.append(mask)
            return h * mask.astype(h.dtype)

        monkeypatch.setattr(fnn, "relu", branch)


def _jax_objective(monkeypatch, specs, n_latents, mixing, obj, k, batch, seed=0,
                   same_branches=False, **kw):
    """{dtype: (loss, metrics, grads, draws, relu signs)} of the JAX model at
    bf16 and fp32 on numpy-drawn weights, and the weights.  With
    ``same_branches`` the fp32 run takes the bf16 run's relu branches."""
    rec, branches = _Recorder(monkeypatch), _Branches(monkeypatch)
    jb = jax.tree_util.tree_map(jnp.asarray, batch)
    res, params = {}, None
    for name, dt in (("bf16", jnp.bfloat16), ("f32", jnp.float32)):
        jm = jget_mixing(mixing)(specs=tuple(JSpec(**s) for s in specs), n_latents=n_latents,
                                 obj=obj, K=k, dtype=dt, **kw)
        if params is None:
            params = draw_params(jax.eval_shape(lambda: jm.init(
                {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)}, jb,
                method=jm.objective)), seed)

        def loss_fn(p, jm=jm):
            rec.draws.clear()
            branches.signs = []
            loss, metrics = jm.apply(p, jb, rngs={"sample": jax.random.PRNGKey(5)},
                                     method=jm.objective)
            return loss, (metrics, list(rec.draws), list(branches.signs))

        step = jax.value_and_grad(loss_fn, has_aux=True)
        (loss, (metrics, draws, signs)), grads = (_jit_bf16(step, params) if dt == jnp.bfloat16
                                                  else jax.jit(step)(params))
        res[name] = (float(loss), {m: float(v) for m, v in metrics.items()},
                     jax.tree_util.tree_map(np.asarray, grads), draws,
                     [np.asarray(m) for m in signs])
        if same_branches:
            branches.replay = res[name][4]
    return res, params


_CASTING = (precision.Linear, precision._CastConv, precision._CastConvTranspose,
            precision.LayerNorm, precision.GroupNorm, tnets.FrozenBatchNorm)


def _hold_layers_to_bf16(model):
    """Forward hooks on every casting layer of ``model`` (the ``fp32_only``
    ones aside) that assert it returned bf16: a layer left in fp32 would
    pass the yardstick, which a port computing in fp32 meets too.  A plain
    PyTorch Linear, conv or norm, which cannot cast, fails at once.  Returns
    the list of the layers' names, one per call."""
    seen = []
    for name, m in model.named_modules():
        if isinstance(m, (torch.nn.Linear, torch.nn.modules.conv._ConvNd, torch.nn.LayerNorm,
                          torch.nn.GroupNorm)):
            assert isinstance(m, _CASTING), (name, type(m))
        if isinstance(m, _CASTING) and m.compute_dtype != torch.float32:
            def hook(mod, args, out, name=name):
                assert out.dtype == BF16, (name, out.dtype)
                seen.append(name)

            m.register_forward_hook(hook)
    return seen


def _assert_objective_within(model_fn, res, params, batch, eps, monkeypatch=None):
    """The port's bf16 model on JAX's fp32 draws: loss, metrics and every
    gradient leaf within the yardstick.  Given ``monkeypatch``, the port's
    ``F.relu`` takes the JAX bf16 run's branches (``_jax_objective``'s
    ``same_branches``), call by call."""
    model = model_fn(BF16)
    load_flax_params(model, params)
    tbatch = {n: {"data": torch.from_numpy(m["data"]),
                  "masks": None if m["masks"] is None else torch.from_numpy(m["masks"])}
              for n, m in batch.items()}
    signs = iter(res["bf16"][4])
    if monkeypatch is not None:
        def branch(x, inplace=False):
            mask = torch.from_numpy(next(signs))
            assert mask.shape == x.shape, (mask.shape, x.shape)
            return x * mask.to(x.dtype)

        monkeypatch.setattr(torch.nn.functional, "relu", branch)
    bf16_calls = _hold_layers_to_bf16(model)
    loss, metrics = model.objective(tbatch, eps=eps)
    assert bf16_calls
    if monkeypatch is not None:
        assert next(signs, None) is None, "the port ran fewer relus than the JAX package"
    loss.backward()
    assert loss.dtype == torch.float32
    assert_scalar_within(loss.item(), res["bf16"][0], res["f32"][0], "loss")
    assert sorted(metrics) == sorted(res["bf16"][1])
    for k, v in metrics.items():
        assert_scalar_within(v.item(), res["bf16"][1][k], res["f32"][1][k], k)
    gb, gf = model_fn(torch.float32), model_fn(torch.float32)
    load_flax_params(gb, res["bf16"][2])
    load_flax_params(gf, res["f32"][2])
    named = dict(gb.named_parameters())
    for (name, p), b, f in zip(model.named_parameters(), gb.parameters(), gf.parameters()):
        assert p.dtype == torch.float32, name
        got = torch.zeros_like(p) if p.grad is None else p.grad
        scale = None
        if name.endswith("key.bias"):   # an exact gradient of 0: its weight's scale
            scale = named[name[:-len("bias")] + "weight"].abs().max().item()
        assert_within(got, b, f, name, scale=scale)
    return model


@pytest.mark.parametrize("mixing", ["poe", "moe"])
def test_flagship_objective_and_gradients_within_the_bf16_yardstick(monkeypatch, mixing):
    """The flagship nets (Enc_CNN2 / Dec_CNN, the text transformers) at full
    width under POE and MOE ELBO, in bf16."""
    batch = numpy_batch(FLAGSHIP, 1)
    specs = spec_kwargs(FLAGSHIP)
    res, params = _jax_objective(monkeypatch, specs, FLAGSHIP["latents"], mixing, "elbo", 1,
                                 batch)
    draws = [torch.from_numpy(np.asarray(d)) for d in res["bf16"][3]]
    eps = draws if mixing == "poe" else {s["name"]: e for s, e in zip(specs, draws)}
    _assert_objective_within(
        lambda dt: get_mixing(mixing)(tuple(ModalitySpec(**s) for s in specs),
                                      FLAGSHIP["latents"], obj="elbo", device="cpu", dtype=dt),
        res, params, batch, eps)


def test_poe_kl_and_sample_kernels_see_fp32_under_bf16(monkeypatch):
    """PoE, KL and the sampling kernel stay fp32-only: under bf16 the
    posteriors leave every encoder in fp32, so their Functions get fp32
    inputs (the JAX package's contract)."""
    seen = []
    for fn_cls, name in ((poe_kernel._PoELattice, "poe"), (kl_kernel._KLStdMulti, "kl"),
                         (sample_kernel._SampleNormal, "sample")):
        def spy(*args, apply=fn_cls.apply, name=name):
            seen.append((name, {a.dtype for a in args if torch.is_tensor(a)}))
            return apply(*args)

        monkeypatch.setattr(fn_cls, "apply", spy)
    batch = numpy_batch(FLAGSHIP, 1)
    tb = {n: {"data": torch.from_numpy(m["data"]),
              "masks": None if m["masks"] is None else torch.from_numpy(m["masks"])}
          for n, m in batch.items()}
    for mixing in ("poe", "moe"):
        model = get_mixing(mixing)(tuple(ModalitySpec(**s) for s in spec_kwargs(FLAGSHIP)),
                                   FLAGSHIP["latents"], device="cpu", dtype=BF16)
        loss, _ = model.objective(tb, generator=torch.Generator().manual_seed(0))
        loss.backward()
        qz = model.posterior(model.specs[0], *model.encode(tb, model.mod_names)["mod_1"]["shared"])
        sample_kernel.sample_normal_fused(qz.loc.detach(), qz.scale.detach(), 0)
    assert {n for n, _ in seen} == {"poe", "kl", "sample"}, seen
    assert all(dts == {torch.float32} for _, dts in seen), seen


def test_resnet50_enc_cnn_step_within_the_bf16_yardstick():
    """Enc_CNN (the ResNet-50 trunk, its FrozenBatchNorms, SiLU, the heads)
    at a narrow input (2 x 32 x 32 x 3): (mu, scale) fp32 out, and the
    gradients of a random cotangent, within the yardstick."""
    rng = np.random.default_rng(9)
    x = rng.random((2, 32, 32, 3)).astype(np.float32)
    cot = [rng.normal(size=(2, 8)).astype(np.float32) for _ in range(2)]
    res, params = {}, None
    for name, dt in (("bf16", jnp.bfloat16), ("f32", jnp.float32)):
        jenc = JEnc_CNN(latent_dim=8, data_dim=(32, 32, 3), dtype=dt)
        if params is None:
            params = zoo_draw_params(jax.eval_shape(
                lambda: jenc.init(jax.random.PRNGKey(0), jnp.asarray(x))), 4)

        def run(p, jenc=jenc):
            out, vjp = jax.vjp(lambda q: jenc.apply(q, jnp.asarray(x)), p)
            return out, vjp(tuple(jnp.asarray(c) for c in cot))[0]

        res[name] = _jit_bf16(run, params) if dt == jnp.bfloat16 else jax.jit(run)(params)
    enc = Enc_CNN(8, (32, 32, 3))
    load_flax_params(enc, params)
    precision.set_compute_dtype(enc, BF16)
    bf16_calls = _hold_layers_to_bf16(enc)
    mu, scale = enc(torch.from_numpy(x))
    assert bf16_calls
    assert mu.dtype == scale.dtype == torch.float32
    assert_within(mu, res["bf16"][0][0], res["f32"][0][0], "mu")
    assert_within(scale, res["bf16"][0][1], res["f32"][0][1], "scale")
    torch.autograd.backward((mu, scale), [torch.from_numpy(c) for c in cot])
    gb, gf = Enc_CNN(8, (32, 32, 3)), Enc_CNN(8, (32, 32, 3))
    load_flax_params(gb, jax.tree_util.tree_map(np.asarray, res["bf16"][1]))
    load_flax_params(gf, jax.tree_util.tree_map(np.asarray, res["f32"][1]))
    for (name, p), b, f in zip(enc.named_parameters(), gb.parameters(), gf.parameters()):
        assert_within(p.grad, b, f, name)


def _video_encoder_relu_inputs(monkeypatch):
    """The input of each relu of Enc_VideoGPTSparse (2-frame 32 x 32 clips,
    batch 2) in the JAX package's bf16, the port's bf16 and the port's
    float64, in call order, on one set of weights."""
    from multimodal_vae_comparison_tpu.models.encoders import Enc_VideoGPTSparse as JEnc
    from multimodal_vae_comparison_tpu_torch.models.encoders import Enc_VideoGPTSparse
    clip = (2, 32, 32, 3)
    x = np.random.default_rng(10).random((2,) + clip).astype(np.float32)
    jenc = JEnc(latent_dim=8, data_dim=clip, dtype=jnp.bfloat16)
    params = zoo_draw_params(jax.eval_shape(
        lambda: jenc.init(jax.random.PRNGKey(0), jnp.asarray(x))), 4)
    seen = {"jax": [], "bf16": [], "f64": []}
    relu, trelu = fnn.relu, torch.nn.functional.relu

    def jrelu(h):
        seen["jax"].append(np.asarray(h, np.float64))
        return relu(h)

    with monkeypatch.context() as m:
        m.setattr(fnn, "relu", jrelu)
        jenc.apply(params, jnp.asarray(x))
        for name in ("bf16", "f64"):
            def record(h, inplace=False, name=name):
                seen[name].append(h.detach().double().numpy())
                return trelu(h)

            m.setattr(torch.nn.functional, "relu", record)
            enc = Enc_VideoGPTSparse(8, clip)
            load_flax_params(enc, params)
            xt = torch.from_numpy(x)
            if name == "f64":
                enc, xt = enc.double(), xt.double()
            else:
                precision.set_compute_dtype(enc, BF16)
            enc(xt)
    return seen


def _relu_rows(seen):
    """Per relu: elements, branches taken against float64's by the port's
    bf16 and by JAX's, and their max abs errors in units of max |float64|."""
    rows = []
    for ref, port, jx in zip(seen["f64"], seen["bf16"], seen["jax"]):
        s = np.abs(ref).max()
        rows.append((ref.size, int(((port > 0) != (ref > 0)).sum()),
                     int(((jx > 0) != (ref > 0)).sum()),
                     np.abs(port - ref).max() / s, np.abs(jx - ref).max() / s))
    return rows


def test_video_encoder_bf16_rounds_as_near_float64_as_jax(monkeypatch):
    """Why the video model is compared on the same relu branches: its bf16
    error is not an extra rounding of the port's.  The CPU's bf16 3-D conv
    accumulates in fp32 (its output and gradients as near float64 as the
    fp32 conv's rounded to bf16), and at each of the encoder's relus the
    port's bf16 input is as near float64 as JAX's; what separates the two
    are the elements within bf16 rounding of 0, which take the other branch
    in each package on elements of its own."""
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.normal(size=(2, 64, 4, 8, 8)).astype(np.float32)).to(BF16)
    w = torch.from_numpy(rng.normal(0, 1 / 42, size=(32, 64, 3, 3, 3)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(2, 32, 4, 8, 8)).astype(np.float32)).to(BF16)
    res = {}
    for dt in (BF16, torch.float32, torch.float64):
        a, b = (t.to(dt).detach().clone().requires_grad_() for t in (x, w.to(BF16)))
        y = torch.nn.functional.conv3d(a, b, padding=1)
        y.backward(g.to(dt))
        res[dt] = [t.detach().double() for t in (y, a.grad, b.grad)]
    for got, fp32, ref in zip(res[BF16], res[torch.float32], res[torch.float64]):
        s = ref.abs().max()
        rounded = (fp32.to(BF16).double() - ref).abs().max() / s
        assert (got - ref).abs().max() / s <= 2 * rounded
    rows = _relu_rows(_video_encoder_relu_inputs(monkeypatch))
    assert len(rows) == 14
    for n, _, _, port, jx in rows:
        assert port <= 1.5 * jx, (n, port, jx)
    assert sum(r[1] for r in rows) <= 1.25 * sum(r[2] for r in rows)


def test_video_sparse_model_within_the_bf16_yardstick(monkeypatch):
    """VideoGPTSparse beside an FNN modality under MOE ELBO at K 2, batch 2
    (one 128-token sparse block), in bf16."""
    clip = (2, 32, 32, 3)
    specs = (dict(name="mod_1", encoder="VideoGPTSparse", decoder="VideoGPTSparse",
                  feature_dims=clip, mod_type="frames", recon_loss="bce"),
             dict(name="mod_2", encoder="FNN", decoder="FNN", feature_dims=(9,),
                  mod_type="actions", recon_loss="bce"))
    rng = np.random.default_rng(10)
    batch = {"mod_1": {"data": rng.random((2,) + clip).astype(np.float32), "masks": None},
             "mod_2": {"data": rng.random((2, 9)).astype(np.float32), "masks": None}}
    res, params = _jax_objective(monkeypatch, specs, 8, "moe", "elbo", 2, batch,
                                 same_branches=True)
    eps = {s["name"]: torch.from_numpy(np.asarray(d)) for s, d in zip(specs, res["bf16"][3])}
    telemetry.reset()
    _assert_objective_within(
        lambda dt: build_model(tuple(ModalitySpec(**s) for s in specs), "moe", 8, obj="elbo",
                               K=2, device="cpu", dtype=dt), res, params, batch, eps,
        monkeypatch=monkeypatch)
    assert telemetry.summary()["sparse_attention:plain"] == 8


# -- the trainer -----------------------------------------------------------------------


@pytest.mark.parametrize("precision_name,dtype", [
    ("bf16", torch.bfloat16), ("bfloat16", torch.bfloat16), ("16", torch.float32),
    ("64", torch.float32), ("32", torch.float32)])
def test_precision_maps_as_the_reference_does(precision_name, dtype):
    """Only bf16 and bfloat16 select bf16; "16" and "64" run fp32, as the
    JAX trainer maps them."""
    assert precision_dtype(precision_name) == dtype


def test_trainer_trains_bf16_keeps_fp32_state_and_restores_fp32(tmp_path):
    """``config_synthetic.yml`` under ``precision: bf16`` for an epoch on the
    CPU: the val loss falls, parameters and optimizer state stay fp32, the
    checkpoint restores into an fp32 model (eval and serving run fp32), and
    that model's forward equals the trained one's weights in fp32; "16" and
    "64" build fp32."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = Config(os.path.join(repo, "configs", "config_synthetic.yml"),
                 results_root=str(tmp_path),
                 overrides={"precision": "bf16", "epochs": 2, "viz_freq": 1000,
                            "batch_size": 16})
    trainer = Trainer(cfg, device="cpu", enable_viz=False)
    assert trainer.model.dtype == BF16
    trainer.init_state()
    before = trainer.validate(epoch=0)["val_loss"]
    trainer.fit()
    after = trainer.validate(epoch=10 ** 6)["val_loss"]
    assert np.isfinite(after) and after < before
    assert all(p.dtype == torch.float32 for p in trainer.model.parameters())
    for state in trainer.opt.state.values():
        assert all(v.dtype == torch.float32 for v in state.values()
                   if torch.is_tensor(v) and v.is_floating_point())
    infer = MultimodalVAEInfer(cfg.mPath, device="cpu")
    assert infer.model.dtype == torch.float32
    for (n, a), (_, b) in zip(infer.model.state_dict().items(),
                              trainer.model.state_dict().items()):
        assert a.dtype == b.dtype and torch.equal(a, b), n
    live = MultimodalVAEInfer.from_trainer(trainer)
    assert live.model.dtype == torch.float32 and live.model is not trainer.model
    for other in ("16", "64"):
        cfg.precision = other
        assert build_model_from_config(cfg, "cpu").dtype == torch.float32


def test_aux_endpoint_head_ends_in_fp32_and_viz_decodes_a_bf16_model():
    """Under bf16 the endpoint head's last Dense computes in fp32, as the
    reference builds it (``nn.Dense(3, dtype=float32)``), taking the bf16
    hidden layer up; the epoch visualizations read a bf16 model's image
    means as fp32 numpy."""
    from multimodal_vae_comparison_tpu_torch import visualization
    specs = (ModalitySpec("mod_1", "CNN2", "CNN", (32, 32, 3), recon_loss="bce"),
             ModalitySpec("mod_2", "FNN", "FNN", (4, 3), mod_type="action_waypoints",
                          recon_loss="mse"))
    model = build_model(specs, "poe", 8, device="cpu", aux_endpoint=0.5, dtype=BF16)
    assert model.aux_head.Dense_0.compute_dtype == BF16
    assert model.aux_head.Dense_1.compute_dtype == torch.float32
    z = torch.randn(1, 3, 8)
    batch = {"mod_2": {"data": torch.randn(3, 4, 3), "masks": None}}
    loss, err = model.aux_endpoint_loss(z, batch)
    assert loss.dtype == err.dtype == torch.float32 and torch.isfinite(loss)
    assert model.aux_head(z).dtype == torch.float32
    img = visualization._decode(model, "mod_1", torch.randn(1, 2, 8))
    assert img.dtype == np.float32 and img.shape == (2, 32, 32, 3)


if __name__ == "__main__":
    # The table behind test_video_encoder_bf16_rounds_as_near_float64_as_jax:
    #   PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_bf16.py
    from _pytest.monkeypatch import MonkeyPatch
    table = _relu_rows(_video_encoder_relu_inputs(MonkeyPatch()))
    print("relu  elements  flips port  flips jax  max err port  max err jax")
    for i, (n, fp, fj, ep, ej) in enumerate(table):
        print(f"{i:4d}  {n:8d}  {fp:10d}  {fj:9d}  {ep:12.3e}  {ej:11.3e}")
    print(f"all   {sum(r[0] for r in table):8d}  {sum(r[1] for r in table):10d}  "
          f"{sum(r[2] for r in table):9d}")
    # the video model's yardstick on the same branches, leaf by leaf
    held, within = [], assert_within

    def assert_within(got, jb, jf, what="", scale=None, atol=ATOL):
        g, b, f = _np(got), _np(jb), _np(jf)
        s = float(np.abs(b).max()) if scale is None else scale
        err, gap = np.abs(g - b).max() / (s or 1.0), np.abs(b - f).max() / (s or 1.0)
        held.append((err / (C * gap + atol), err / gap if gap else 0.0, what))
        within(got, jb, jf, what, scale, atol)

    test_video_sparse_model_within_the_bf16_yardstick(MonkeyPatch())
    share, ratio, leaf = max(held)
    print(f"video model, {len(held)} leaves: worst {leaf}, {share:.3f} of the limit, "
          f"{ratio:.2f} times JAX's gap; largest ratio {max(r for _, r, _ in held):.2f}")
