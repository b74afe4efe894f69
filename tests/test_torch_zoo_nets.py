"""The nets that no shipped config names, in the port against the JAX
package, on the CPU: ``Enc_VIT`` (the ViT trunk at its full width),
``Enc_RESCNN`` / ``Dec_RESCNN`` (``ResDown`` / ``ResUp``), ``Enc_ConvTxt``
/ ``Dec_ConvTxt`` (1-D convs and flax ``SAME`` transposed convs),
``Enc_TxtRNN`` (a bidirectional GRU through the bridge's GRUCell rule, on
a mask of unequal lengths) and ``Enc_TransformerIMG`` /
``Dec_TransformerIMG`` (attention at Dh 64, a partly padded frame mask).
Each is given JAX's weights through the bridge; its outputs and the
gradient in every weight of a random cotangent are held to JAX's.  The
registries resolve every name of the JAX package's.

Tolerances: each output within rtol 1e-5 of its own max |x| + atol 1e-6
(elementwise, the RESCNN decoder's fp32 sums of 4,608 terms a pixel, in
another order on each side, move small logits by ~1e-5); gradients within
1e-4 of each leaf's max |g| + 1e-5 (the earlier net tests' rule).
"""
import types
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_vae_comparison_tpu.models import decoders as jdecoders
from multimodal_vae_comparison_tpu.models import encoders as jencoders
from multimodal_vae_comparison_tpu_torch.bridge import load_flax_params
from multimodal_vae_comparison_tpu_torch.models import decoders, encoders
from multimodal_vae_comparison_tpu_torch.ops.kernels import telemetry
from test_torch_slice import draw_params, one_torch_thread  # noqa: F401 (one_torch_thread: autouse)

OUT_REL, OUT_ATOL = 1e-5, 1e-6
GRAD_REL, GRAD_ATOL = 1e-4, 1e-5
LATENTS, B = 20, 3
# XLA's CPU compile option of the comparisons: LLVM's expensive passes off
# shorten a compile
FAST_COMPILE = {"xla_llvm_disable_expensive_passes": True}
TEXT, CLIP = (45, 27), (3, 64, 64, 3)

# (kind, registry name, data dims, constructor kwargs of both sides, masked,
#  attention launches of one forward)
NETS = {
    "enc-VIT": ("enc", "VIT", (64, 64, 3), {}, False, 6),
    # a conv bias before a GroupNorm of one channel a group has an exact
    # gradient of 0 (rounding noise on both sides): the widths keep every
    # group at 2 channels or more, as at the full width
    "enc-RESCNN": ("enc", "RESCNN", (64, 64, 3), {"ch": 16}, False, 0),
    "dec-RESCNN": ("dec", "RESCNN", (64, 64, 3), {"ch": 32}, False, 0),
    "enc-ConvTxt": ("enc", "ConvTxt", TEXT, {}, False, 0),
    "dec-ConvTxt": ("dec", "ConvTxt", TEXT, {}, False, 0),
    "enc-TxtRNN": ("enc", "TxtRNN", TEXT, {"hidden_size": 16}, True, 0),
    "enc-TransformerIMG": ("enc", "TransformerIMG", CLIP,
                           {"hid_channels": 8, "ff_size": 32}, True, 4),
    "dec-TransformerIMG": ("dec", "TransformerIMG", CLIP,
                           {"hid_channels": 8, "ff_size": 32}, False, 4),
}


def _mask(dims, rng):
    """(B, T) bool with unequal lengths, one row full and one of length 1."""
    t = dims[0]
    lengths = np.concatenate([[t, 1], rng.integers(1, t + 1, B - 2)])
    return np.arange(t)[None, :] < lengths[:, None]


def lower_net(key, seed):
    """(port-side inputs, JAX's lowered function, its args): JAX's outputs
    and the gradient in every weight of a random cotangent of the first."""
    kind, name, dims, kwargs, masked, _ = NETS[key]
    rng = np.random.default_rng(seed)
    table = jencoders.ENCODERS if kind == "enc" else jdecoders.DECODERS
    jnet = table[name](latent_dim=LATENTS, data_dim=dims, **kwargs)
    x = (rng.uniform(size=(B,) + dims) if kind == "enc"
         else rng.normal(size=(B, LATENTS))).astype(np.float32)
    mask = _mask(dims, rng) if masked else None
    args = (jnp.asarray(x), None if mask is None else jnp.asarray(mask))
    apply = lambda p: jnet.apply(p, *args)
    params = draw_params(jax.eval_shape(lambda: jnet.init(jax.random.PRNGKey(0), *args)),
                         seed + 1)
    cot = rng.normal(size=jax.eval_shape(apply, params)[0].shape).astype(np.float32)

    def out_and_grads(p):
        want, vjp = jax.vjp(apply, p)
        (grads,) = vjp((jnp.asarray(cot),) + tuple(jnp.zeros_like(w) for w in want[1:]))
        return want, grads

    side = types.SimpleNamespace(x=x, mask=mask, cot=cot, params=params, key=key)
    return side, jax.jit(out_and_grads).lower(params)


def _port_net(key):
    kind, name, dims, kwargs, _, _ = NETS[key]
    get = encoders.get_encoder if kind == "enc" else decoders.get_decoder
    return get(name)(LATENTS, dims, **kwargs)


@pytest.fixture(scope="module")
def jax_side():
    """{key: (port-side inputs, JAX's outputs as numpy)}: each net's
    function compiled and run in a pool of threads as soon as it is lowered
    (XLA compiles without the GIL)."""
    def run(fn, args):
        return jax.tree_util.tree_map(np.array, fn.compile(FAST_COMPILE)(*args))

    with ThreadPoolExecutor(max_workers=4) as pool:
        pending = {}
        for i, key in enumerate(NETS):
            side, fn = lower_net(key, 60 + 2 * i)
            pending[key] = (side, pool.submit(run, fn, (side.params,)))
        return {k: (side, fut.result()) for k, (side, fut) in pending.items()}


def _tensor(a):
    return None if a is None else torch.from_numpy(a)


@pytest.mark.parametrize("key", list(NETS))
def test_net_outputs_and_every_gradient_match_jax(jax_side, key):
    """Outputs within OUT_REL of their max |x| + OUT_ATOL of JAX's, the gradient of the cotangent in
    every weight within GRAD_REL of the leaf's max |g| + GRAD_ATOL, and the
    attention kernel's plain version launched as often as the net has
    attention layers."""
    side, (want, jgrads) = jax_side[key]
    net = _port_net(key)
    load_flax_params(net, side.params)
    telemetry.reset()
    got = net(torch.from_numpy(side.x), _tensor(side.mask))
    launches = NETS[key][5]
    assert telemetry.summary() == ({"attention:plain": launches} if launches else {})
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_allclose(a.detach().numpy(), b, rtol=0,
                                   atol=OUT_REL * np.abs(b).max() + OUT_ATOL)
    (got[0] * torch.from_numpy(side.cot)).sum().backward()
    want_net = _port_net(key)
    load_flax_params(want_net, jgrads)
    for (name, p), g in zip(net.named_parameters(), want_net.parameters()):
        grad = torch.zeros_like(p) if p.grad is None else p.grad
        err = (grad - g).abs().max().item()
        limit = GRAD_REL * g.abs().max().item() + GRAD_ATOL
        assert err <= limit, f"{name}: max abs error {err:.3e} > {limit:.3e}"


def test_registries_resolve_every_jax_name():
    """Every encoder and decoder name of the JAX package resolves, to a
    class of the same name; an unknown name raises KeyError."""
    assert sorted(encoders.ENCODERS) == sorted(jencoders.ENCODERS)
    assert sorted(decoders.DECODERS) == sorted(jdecoders.DECODERS)
    for name, cls in jencoders.ENCODERS.items():
        assert encoders.get_encoder(name).__name__ == cls.__name__
    for name, cls in jdecoders.DECODERS.items():
        assert decoders.get_decoder(name).__name__ == cls.__name__
    with pytest.raises(KeyError):
        encoders.get_encoder("ViT")
    with pytest.raises(KeyError):
        decoders.get_decoder("VIT")


def test_txtrnn_reads_each_row_to_its_end_both_ways():
    """The counterpart of the JAX package's regression test: the backward
    state depends on the first token (a full right-to-left pass), the
    padded steps do not move the encoding, and a row's result does not
    depend on the other rows' lengths."""
    net = encoders.Enc_TxtRNN(4, (6, 5), hidden_size=16)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.random((2, 6, 5)).astype(np.float32))
    mask = torch.tensor([[True] * 6, [True] * 3 + [False] * 3])
    with torch.no_grad():
        mu, _ = net(x, mask)
        x_first = x.clone()
        x_first[:, 0] += 1.0
        assert ((net(x_first, mask)[0] - mu).abs().amax(-1) > 1e-4).all()
        x_pad = x.clone()
        x_pad[1, 3:] = 5.0
        torch.testing.assert_close(net(x_pad, mask)[0], mu, rtol=0, atol=0)
        torch.testing.assert_close(net(x[1:], mask[1:])[0], mu[1:], rtol=1e-6, atol=1e-7)
        full, _ = net(x, None)
        torch.testing.assert_close(full[:1], mu[:1], rtol=0, atol=0)


def test_gru_bridge_rule_and_the_zero_hidden_gate_biases():
    """The bridge stacks a flax GRUCell's ten leaves in PyTorch's r, z, n
    order with [0, 0, b_hn] as the hidden bias; those two zero thirds start
    at 0 in a fresh net and their gradient is held at 0; a GRUCell missing
    a leaf raises."""
    jnet = jencoders.Enc_TxtRNN(latent_dim=4, data_dim=(6, 5), hidden_size=8)
    x = jnp.zeros((2, 6, 5))
    params = draw_params(jax.eval_shape(lambda: jnet.init(jax.random.PRNGKey(0), x)), 3)
    net = encoders.Enc_TxtRNN(4, (6, 5), hidden_size=8)
    assert not net.GRUCell_0.bias_hh_l0[:16].any()
    load_flax_params(net, params)
    cell = params["params"]["GRUCell_1"]
    np.testing.assert_array_equal(net.GRUCell_1.weight_ih_l0[8:16].detach().numpy(),
                                  cell["iz"]["kernel"].T)
    np.testing.assert_array_equal(net.GRUCell_1.weight_hh_l0[16:].detach().numpy(),
                                  cell["hn"]["kernel"].T)
    np.testing.assert_array_equal(net.GRUCell_1.bias_ih_l0[:8].detach().numpy(),
                                  cell["ir"]["bias"])
    np.testing.assert_array_equal(net.GRUCell_1.bias_hh_l0.detach().numpy(),
                                  np.concatenate([np.zeros(16, np.float32), cell["hn"]["bias"]]))
    mu, scale = net(torch.rand(2, 6, 5), torch.tensor([[True] * 6, [True] * 2 + [False] * 4]))
    (mu.sum() + scale.sum()).backward()
    for gru in (net.GRUCell_0, net.GRUCell_1):
        assert not gru.bias_hh_l0.grad[:16].any() and gru.bias_hh_l0.grad[16:].any()
    broken = {"params": dict(params["params"], GRUCell_0={
        k: v for k, v in params["params"]["GRUCell_0"].items() if k != "hz"})}
    with pytest.raises(KeyError, match="GRUCell_0"):
        load_flax_params(encoders.Enc_TxtRNN(4, (6, 5), hidden_size=8), broken)


# -- chip_smoke.py's zoo remainder phase on the CPU ---------------------------------------

# each modality's data dims, by mod_type, as the CdSprites+ and SPRITES
# datasets give them
PHASE_DIMS = {"image": (64, 64, 3), "text": (45, 27), "frames": (8, 64, 64, 3),
              "actions": (9,), "attributes": (4, 6)}


def _chip_smoke():
    import os
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, repo)
    try:
        import chip_smoke
    finally:
        sys.path.remove(repo)
    return chip_smoke


def _phase_batch(cfg, n, seed):
    rng = np.random.default_rng(seed)
    batch = {}
    for m in cfg.mods:
        dims = PHASE_DIMS[m.mod_type]
        if m.mod_type in ("image", "frames"):
            data = rng.random((n,) + dims).astype(np.float32)
        else:
            data = np.eye(dims[-1], dtype=np.float32)[rng.integers(0, dims[-1],
                                                                   (n,) + dims[:-1])]
        masks = (np.arange(dims[0])[None] < rng.integers(1, dims[0] + 1, (n, 1))
                 if m.mod_type == "text" else None)
        batch[m.name] = {"data": torch.from_numpy(data),
                         "masks": None if masks is None else torch.from_numpy(masks)}
    return batch


@pytest.mark.parametrize("part", range(6))
def test_chip_smoke_zoo_remainder_configs_and_launch_tables_hold_on_the_cpu(tmp_path, part):
    """chip_smoke.py's ZOO_REST_FROM_CONFIG: each edited shipped config
    builds the model the phase expects (the unimodal VAE for one modality,
    the swapped nets), and one objective call at bs 2 on the phase's noise
    (``zoo_rest_eps``), then its backward, take the kernels' plain versions
    exactly ZOO_REST_PER_OBJECTIVE and ZOO_REST_PER_BACKWARD times."""
    from multimodal_vae_comparison_tpu_torch.training.trainer import build_model_from_config
    cs = _chip_smoke()
    assert len(cs.ZOO_REST_FROM_CONFIG) == 6
    label, _, key, _, _, fixed = cs.ZOO_REST_FROM_CONFIG[part]
    cfg = cs.zoo_rest_config(label, {}, str(tmp_path), eval_only=True)
    for m in cfg.mods:
        m.feature_dims = list(PHASE_DIMS[m.mod_type])
    model = build_model_from_config(cfg, device="cpu")
    assert (type(model).__name__ == "UnimodalVAE") == key.startswith("vae")
    assert all(getattr(cfg, k) == v for k, v in fixed.items())
    eps = cs.zoo_rest_eps(np.random.default_rng(0), cfg, 2)
    eps = (torch.from_numpy(eps) if isinstance(eps, np.ndarray)
           else [torch.from_numpy(e) for e in eps])
    telemetry.reset()
    loss, _ = model.objective(_phase_batch(cfg, 2, part), eps=eps)
    plain = lambda: {k.split(":")[0]: n for k, n in telemetry.summary().items()}
    call = plain()
    loss.backward()
    backward = {k: n - call.get(k, 0) for k, n in plain().items() if n != call.get(k, 0)}
    assert torch.isfinite(loss)
    assert call == cs.ZOO_REST_PER_OBJECTIVE[key]
    assert backward == cs.ZOO_REST_PER_BACKWARD[key]
