"""The port's FLOP counter (``ops/flops.py``) against golden values and the
JAX package's ``mxu_flops`` (``ops/flops.py`` there), on the CPU.

``step_flops`` counts the products and convolutions PyTorch dispatches
(``torch.utils.flop_counter``), with each kernel of ``ops/kernels/``
counted by its function.  ``mxu_flops`` counts the jaxpr's products.  The
two agree on a Dense and on a stride-1 product; they differ, by amounts
that the tests compute from the shapes each module saw, in three named
places:

* TRANSPOSED_CONV: flax's ``ConvTranspose`` is a convolution over the
  stride-dilated input, so ``mxu_flops`` counts its forward and its kernel
  gradient s^2 times the taps that PyTorch's transposed convolution (and
  the counter) count; its input gradient the same;
* STRIDED_CONV_INPUT_GRAD: the input gradient of a stride-s convolution is
  a convolution over the stride-dilated cotangent in JAX, s^2 times
  PyTorch's count (only where the input needs one: not a net's first
  layer on the data);
* ATTENTION_RECOMPUTE: the port's attention backward recomputes Q K^T
  (2 B H Tq Tk Dh), which JAX's autodiff of its attention does not.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import __graft_entry__ as ge
from multimodal_vae_comparison_tpu.models import get_mixing as jget_mixing
from multimodal_vae_comparison_tpu.ops.flops import mxu_flops
from multimodal_vae_comparison_tpu.training.trainer import TrainState
from multimodal_vae_comparison_tpu.training.trainer import make_train_step as jmake_train_step
from multimodal_vae_comparison_tpu_torch.models import nets as tnets
from multimodal_vae_comparison_tpu_torch.models.base import ModalitySpec
from multimodal_vae_comparison_tpu_torch.ops.flops import kernel_flops, step_flops
from multimodal_vae_comparison_tpu_torch.ops.kernels import attention as tattn
from multimodal_vae_comparison_tpu_torch.ops.kernels import sparse_attention as tsp
from multimodal_vae_comparison_tpu_torch.training.optim import make_optimizer
from multimodal_vae_comparison_tpu_torch.training.trainer import build_model, make_train_step
from test_torch_slice import one_torch_thread  # noqa: F401 (autouse)
from torch.utils.flop_counter import FlopCounterMode


# -- the goldens of tests/test_flops.py, on the port ---------------------------------


def test_plain_matmul():
    a, b = torch.zeros(8, 16), torch.zeros(16, 32)
    got = step_flops(lambda x, y: x @ y, a, b)
    assert got == {"flops": 2 * 8 * 32 * 16, "lower_bound": False}


def test_batched_matmul():
    a, b = torch.zeros(4, 8, 16), torch.zeros(4, 16, 32)
    got = step_flops(lambda x, y: torch.einsum("bmk,bkn->bmn", x, y), a, b)
    assert got["flops"] == 2 * 4 * 8 * 32 * 16


def test_conv2d():
    conv = torch.nn.Conv2d(3, 32, 3, padding=1)
    x = torch.zeros(2, 3, 8, 8)
    # out elems (2*8*8*32) x in_ch 3 x kernel 9 x 2
    assert step_flops(conv, x)["flops"] == 2 * (2 * 8 * 8 * 32) * 3 * 9


def test_loop_counts_every_pass():
    """A Python loop stands for the reference's scan: its body counts once a
    pass, as ``mxu_flops`` multiplies a scan's body by its length."""
    w = torch.zeros(16, 16)

    def f(w):
        c = torch.zeros(4, 16)
        for _ in range(10):
            c = c @ w
        return c

    assert step_flops(f, w)["flops"] == 10 * 2 * 4 * 16 * 16


def test_grad_counts_backward_matmuls():
    x = torch.zeros(4, 16)
    w = torch.zeros(16, 16, requires_grad=True)
    fwd = step_flops(lambda: (x @ w).sum())["flops"]
    bwd = step_flops(lambda: (x @ w).sum().backward())["flops"]
    assert bwd >= 2 * fwd   # dL/dw = x^T @ dy


def test_kernel_flops_replaces_what_the_counter_saw_and_does_not_nest():
    a = torch.zeros(8, 16)

    def f():
        with kernel_flops(7):
            return a @ a.T
    assert step_flops(f)["flops"] == 7
    with kernel_flops(7):   # outside step_flops it does nothing
        a @ a.T
    with pytest.raises(RuntimeError, match="nest"):
        step_flops(lambda: step_flops(f))


# -- the kernels' reported FLOPs ----------------------------------------------------------


@pytest.mark.parametrize("b,h,tq,tk,dh", [(2, 2, 45, 45, 32), (3, 4, 100, 5, 32),
                                         (1, 4, 7, 19, 16)])
def test_attention_reports_the_products_its_plain_version_runs(b, h, tq, tk, dh):
    """The masked attention's forward counts 4 b h Tq Tk Dh: what its plain
    version's two products execute at the same shapes.  (At one key
    PyTorch's einsum turns q k^T into a multiply the counter does not see:
    the count from the shapes is what keeps the card and the CPU equal.)"""
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.normal(size=(b, h, tq, dh)).astype(np.float32))
    k, v = (torch.from_numpy(rng.normal(size=(b, h, tk, dh)).astype(np.float32))
            for _ in range(2))
    counter = FlopCounterMode(display=False)
    with counter:
        tattn.attention_reference(q, k, v)
    assert counter.get_total_flops() == tattn.attention_flops(b, h, tq, tk, dh)
    assert step_flops(tattn.masked_attention, q, k, v)["flops"] \
        == tattn.attention_flops(b, h, tq, tk, dh)


@pytest.mark.parametrize("shape,block,stride", [((1, 2, 64, 8), 16, 2), ((2, 2, 128, 16), 32, 4)])
def test_sparse_attention_counts_its_live_blocks_only(shape, block, stride):
    """The sparse attention counts 4 Dh FLOPs forward and 14 Dh backward per
    visible (query, key) pair of its live key blocks, not the dense
    emulation's T x T that its plain version executes."""
    b, h, t, dh = shape
    _, cells = tsp.sparse_work(t, block, stride)
    assert cells == sum(int(x) for x in tsp.visibility(t, block, stride).sum(-1))
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32)).requires_grad_()
               for _ in range(3))
    fwd = step_flops(tsp.strided_block_sparse_attention, q, k, v, block, stride)["flops"]
    assert fwd == 4 * b * h * dh * cells == tsp.sparse_flops(shape, block, stride)
    both = step_flops(lambda: tsp.strided_block_sparse_attention(
        q, k, v, block, stride).sum().backward())["flops"]
    assert both == (4 + 14) * b * h * dh * cells
    counter = FlopCounterMode(display=False)
    with counter:
        tsp.sparse_attention_reference(q, k, v, block, stride)
    assert counter.get_total_flops() == 4 * b * h * t * t * dh > fwd


# -- the flagship steps against mxu_flops --------------------------------------------------


class _Shapes:
    """The shapes each conv and attention call of a step saw, and the
    corrections they make (module docstring)."""

    def __init__(self, model, monkeypatch):
        self.transposed = self.strided = self.attention = 0
        for m in model.modules():
            if isinstance(m, (torch.nn.ConvTranspose2d, torch.nn.Conv2d)):
                m.register_forward_hook(self._conv)
        attention = tattn.masked_attention

        def spy(q, k, v, key_mask=None):
            b, h, tq, dh = q.shape
            self.attention += 2 * b * h * tq * k.shape[2] * dh
            return attention(q, k, v, key_mask)

        monkeypatch.setattr(tnets, "masked_attention", spy)

    def _conv(self, m, inputs, out):
        x = inputs[0]
        s2 = math.prod(m.stride)
        if s2 == 1:
            return
        transposed = isinstance(m, torch.nn.ConvTranspose2d)
        spatial = x.shape[2:] if transposed else out.shape[2:]
        taps = 2 * x.shape[0] * math.prod(spatial) * m.in_channels * m.out_channels \
            * math.prod(m.kernel_size) // m.groups
        if transposed:   # forward and kernel gradient
            self.transposed += (s2 - 1) * taps * (1 + int(m.weight.requires_grad))
        elif x.requires_grad:   # the input gradient
            self.strided += (s2 - 1) * taps

    def total(self) -> int:
        return self.transposed + self.strided - self.attention


@pytest.mark.parametrize("mixing", ["poe", "moe"])
def test_flagship_step_equals_mxu_flops_after_the_named_corrections(monkeypatch, mixing):
    """The flagship train step (bs 4, as tests/test_flops.py builds it) under
    POE and MOE: the port's count plus the three corrections equals the JAX
    package's ``mxu_flops`` exactly."""
    jm = ge._flagship()
    jm = jget_mixing(mixing)(specs=jm.specs, n_latents=16, obj="elbo")
    batch = ge._batch(4)
    rng = jax.random.PRNGKey(0)
    params = jm.init({"params": rng, "sample": rng}, batch, method=jm.objective)
    tx = optax.amsgrad(1e-4)
    state = TrainState(params=params, opt_state=tx.init(params),
                       step=jnp.zeros((), jnp.int32))
    want = mxu_flops(jmake_train_step(jm, tx), state, batch, rng)
    specs = tuple(ModalitySpec(name=s.name, encoder=s.encoder, decoder=s.decoder,
                               feature_dims=s.feature_dims, mod_type=s.mod_type,
                               recon_loss=s.recon_loss, has_masks=s.has_masks)
                  for s in jm.specs)
    model = build_model(specs, mixing, 16, device="cpu")
    step = make_train_step(model, make_optimizer("adam", 1e-4, model.parameters()))
    tb = {n: {"data": torch.from_numpy(np.array(m["data"])),
              "masks": None if m["masks"] is None else torch.from_numpy(np.array(m["masks"]))}
          for n, m in batch.items()}
    shapes = _Shapes(model, monkeypatch)
    got = step_flops(step, tb, generator=torch.Generator().manual_seed(0))
    assert not got["lower_bound"] and not want["lower_bound"]
    assert shapes.transposed > 0 and shapes.strided > 0 and shapes.attention > 0
    assert got["flops"] + shapes.total() == want["mxu_flops"], (
        got["flops"], shapes.transposed, shapes.strided, shapes.attention, want["mxu_flops"])


def test_video_step_counts_its_sparse_attention_by_the_live_blocks(monkeypatch):
    """The VideoGPTSparse MOE ELBO step: each sparse attention call counts 4
    Dh forward and 14 Dh backward per visible pair of its live blocks, in
    place of the 16 B H T^2 Dh its dense plain version executes (forward 4,
    the backward's recompute 4 and gradients 8), so the CPU reads what the
    card's kernels count."""
    clip = (2, 32, 32, 3)
    specs = (ModalitySpec("mod_1", "VideoGPTSparse", "VideoGPTSparse", clip,
                          mod_type="frames", recon_loss="bce"),
             ModalitySpec("mod_2", "FNN", "FNN", (9,), mod_type="actions", recon_loss="bce"))
    model = build_model(specs, "moe", 8, obj="elbo", K=2, device="cpu")
    step = make_train_step(model, make_optimizer("adam", 1e-4, model.parameters()))
    rng = np.random.default_rng(0)
    tb = {"mod_1": {"data": torch.from_numpy(rng.random((2,) + clip).astype(np.float32)),
                    "masks": None},
          "mod_2": {"data": torch.from_numpy(rng.random((2, 9)).astype(np.float32)),
                    "masks": None}}
    calls = []
    sparse = tsp.strided_block_sparse_attention

    def spy(q, k, v, block=128, block_stride=4):
        calls.append((tuple(q.shape), block, block_stride))
        return sparse(q, k, v, block, block_stride)

    monkeypatch.setattr(tnets, "strided_block_sparse_attention", spy)
    counter = FlopCounterMode(display=False)
    with counter:
        step(tb, generator=torch.Generator().manual_seed(0))
    dense = counter.get_total_flops()
    n_dense_calls = len(calls)
    got = step_flops(step, tb, generator=torch.Generator().manual_seed(0))["flops"]
    assert len(calls) == 2 * n_dense_calls == 16
    want = dense
    for (b, h, t, dh), block, stride in calls[:n_dense_calls]:
        _, cells = tsp.sparse_work(t, block, stride)
        want += 18 * b * h * dh * cells - 16 * b * h * t * t * dh
    assert got == want
