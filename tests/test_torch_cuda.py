"""The port's CUDA kernels against their plain versions, on a card.

Every test here is marked ``cuda`` and skips on a host without a CUDA
device.  The file imports no JAX, so it runs where only PyTorch is
installed; ``tests/conftest.py`` sets JAX up, so run it without:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

The first test to launch a kernel builds it with ``nvcc`` (seconds).
"""
import numpy as np
import pytest
import torch

from multimodal_vae_comparison_tpu_torch.models import get_mixing
from multimodal_vae_comparison_tpu_torch.models.base import ModalitySpec
from multimodal_vae_comparison_tpu_torch.ops.kernels import attention as tattn
from multimodal_vae_comparison_tpu_torch.ops.kernels import kl_kernel as tkl
from multimodal_vae_comparison_tpu_torch.ops.kernels import poe_kernel as tpoe
from multimodal_vae_comparison_tpu_torch.ops.kernels import telemetry
from multimodal_vae_comparison_tpu_torch.training.optim import make_optimizer
from multimodal_vae_comparison_tpu_torch.training.trainer import build_model, make_train_step

pytestmark = pytest.mark.cuda

ATTN_TOL = dict(rtol=2e-4, atol=2e-5)   # as tests/test_pallas.py
POE_TOL = dict(rtol=1e-5, atol=1e-6)    # elementwise fp32, one sum over E
# the closed-form PoE backward against autograd's chain through the plain
# version: the two orders differ where mu_e - mu cancels (seen: 2.1e-6)
POE_BWD_TOL = dict(rtol=1e-5, atol=1e-5)
KL_TOL = dict(rtol=1e-5, atol=1e-6)     # elementwise fp32, one sum over D
# whole model on the card (kernels, cuBLAS and cuDNN in fp32) against the
# CPU's plain path: sums in another order through a dozen layers
SLICE_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _qkv(seed, b, h, tq, tk, dh, masked, dev):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.normal(size=(b, h, t, dh)).astype(np.float32)).to(dev)
               for t in (tq, tk, tk))
    mask = None
    if masked:
        m = rng.random((b, tk)) > 0.3
        m[0] = False  # one row with every key masked
        mask = torch.from_numpy(m).to(dev)
    return q, k, v, mask


@pytest.mark.parametrize("b,h,tq,tk,dh,masked", [
    (128, 2, 45, 45, 32, True),    # encoder self-attention, bucket 128
    (128, 2, 45, 1, 8, False),     # decoder cross-attention
    (4, 2, 130, 130, 16, True),    # several key chunks
    (3, 1, 1, 7, 4, True),         # one query row
    (2, 2, 9, 33, 128, False),     # widest head
])
def test_attention_kernel_matches_plain(cuda, b, h, tq, tk, dh, masked):
    q, k, v, mask = _qkv(7, b, h, tq, tk, dh, masked, cuda)
    telemetry.reset()
    got = tattn.masked_attention(q, k, v, mask)
    assert telemetry.launches() == {"attention": 1}
    torch.cuda.synchronize()
    torch.testing.assert_close(got, tattn.attention_reference(q, k, v, mask), **ATTN_TOL)
    if masked:
        uniform = v[0].mean(dim=1, keepdim=True).expand_as(got[0])
        torch.testing.assert_close(got[0], uniform, **ATTN_TOL)


@pytest.mark.parametrize("shape", [(1, 128, 16), (2, 128, 16), (3, 128, 16),
                                   (2, 4096, 24), (3, 7, 5)])
def test_poe_kernel_matches_plain(cuda, shape):
    rng = np.random.default_rng(8)
    mus = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(cuda)
    scales = torch.from_numpy(rng.uniform(0.3, 2.0, shape).astype(np.float32)).to(cuda)
    telemetry.reset()
    got = tpoe.poe_fused(mus, scales, 1.0)
    assert telemetry.launches() == {"poe": 1}
    for g, w in zip(got, tpoe.poe_reference(mus, scales, 1.0)):
        torch.testing.assert_close(g, w, **POE_TOL)


def test_kernels_refuse_what_they_do_not_take(cuda):
    """Inputs that require grad get gradients; other dtypes, layouts and
    shapes raise."""
    q = torch.randn(1, 2, 3, 8, device=cuda, requires_grad=True)
    tattn.masked_attention(q, q.detach(), q.detach()).sum().backward()
    assert q.grad is not None and torch.isfinite(q.grad).all()
    with pytest.raises(TypeError):
        tattn.masked_attention(*(q.detach().double(),) * 3)
    with pytest.raises(ValueError):
        x = q.detach().transpose(2, 3)
        tattn.masked_attention(x, x, x)
    mus = torch.randn(2, 3, 4, device=cuda, requires_grad=True)
    sum(t.sum() for t in tpoe.poe_fused(mus, mus.detach().abs() + 0.5)).backward()
    assert mus.grad is not None and torch.isfinite(mus.grad).all()
    with pytest.raises(ValueError):
        tpoe.poe_fused(mus.detach(), torch.ones(2, 3, 5, device=cuda))
    with pytest.raises(ValueError):
        tkl.kl_normal_std_fused(torch.ones(3, 4, device=cuda).t(), torch.ones(4, 3, device=cuda))
    with pytest.raises(TypeError):
        tkl.kl_normal_std_fused(torch.ones(3, 4, device=cuda).double(),
                                torch.ones(3, 4, device=cuda).double())


@pytest.mark.parametrize("shape", [(24, 16), (256, 16), (4096, 24), (7, 5), (2, 3, 16)])
def test_kl_kernel_matches_plain(cuda, shape):
    rng = np.random.default_rng(9)
    mu = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(cuda)
    scale = torch.from_numpy(rng.uniform(0.3, 2.0, shape).astype(np.float32)).to(cuda)
    telemetry.reset()
    got = tkl.kl_normal_std_fused(mu, scale)
    assert telemetry.launches() == {"kl": 1}
    torch.testing.assert_close(got, tkl.kl_reference(mu, scale), **KL_TOL)


def _grads(fn, inputs, upstream):
    xs = [x.detach().clone().requires_grad_() for x in inputs]
    return torch.autograd.grad(fn(*xs), xs, upstream)


@pytest.mark.parametrize("b,h,tq,tk,dh,masked", [
    (24, 2, 45, 45, 32, True),     # encoder self-attention, bs 24
    (72, 2, 45, 1, 8, False),      # POE decoder cross-attention, S*K*B rows
    (4, 2, 130, 130, 16, True),
])
def test_attention_backward_matches_plain(cuda, b, h, tq, tk, dh, masked):
    q, k, v, mask = _qkv(10, b, h, tq, tk, dh, masked, cuda)
    d_out = torch.randn(q.shape, device=cuda)
    got = _grads(lambda *x: tattn.masked_attention(*x, mask), (q, k, v), d_out)
    want = _grads(lambda *x: tattn.attention_reference(*x, mask), (q, k, v), d_out)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        torch.testing.assert_close(g, w, **ATTN_TOL)


@pytest.mark.parametrize("shape", [(1, 24, 16), (2, 24, 16), (3, 24, 16), (2, 4096, 24)])
def test_poe_backward_matches_plain(cuda, shape):
    rng = np.random.default_rng(11)
    mus = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(cuda)
    scales = torch.from_numpy(rng.uniform(0.3, 2.0, shape).astype(np.float32)).to(cuda)
    ups = tuple(torch.randn(shape[1:], device=cuda) for _ in range(2))
    got = _grads(lambda m, s: tpoe.poe_fused(m, s, 1.0), (mus, scales), ups)
    want = _grads(lambda m, s: tpoe.poe_reference(m, s, 1.0), (mus, scales), ups)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **POE_BWD_TOL)


@pytest.mark.parametrize("shape", [(24, 16), (4096, 24), (2, 3, 16)])
def test_kl_backward_matches_plain(cuda, shape):
    rng = np.random.default_rng(12)
    mu = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(cuda)
    scale = torch.from_numpy(rng.uniform(0.3, 2.0, shape).astype(np.float32)).to(cuda)
    up = torch.randn(shape[:-1], device=cuda)
    got = _grads(tkl.kl_normal_std_fused, (mu, scale), up)
    want = _grads(tkl.kl_reference, (mu, scale), up)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **KL_TOL)


def _flagship_specs():
    return (ModalitySpec("mod_1", "CNN2", "CNN", (64, 64, 3)),
            ModalitySpec("mod_2", "TxtTransformer", "TxtTransformer", (45, 27),
                         mod_type="text", recon_loss="category_ce", has_masks=True))


@pytest.mark.parametrize("mixing,kernels", [("poe", {"attention": 2, "poe": 3}),
                                            ("moe", {"attention": 2, "kl": 2})])
def test_full_width_train_step_on_the_card(cuda, mixing, kernels):
    """One adam step of each training model at full width and bs 24: it
    launches exactly its kernels, and its loss and gradients match the
    CPU's plain path on the same weights, batch and eps (per leaf, within
    1e-4 of its max |g| + 1e-5: fp32 sums in another order, TF32 off)."""
    rng = np.random.default_rng(13)
    img = rng.random((24, 64, 64, 3)).astype(np.float32)
    txt = np.eye(27, dtype=np.float32)[rng.integers(0, 27, (24, 45))]
    mask = np.arange(45)[None, :] < rng.integers(1, 46, (24, 1))
    draws = [rng.standard_normal((1, 24, 16)).astype(np.float32)
             for _ in range(3 if mixing == "poe" else 2)]
    out = {}
    for dev in ("cuda", "cpu"):
        model = build_model(_flagship_specs(), mixing, 16, device=dev)
        batch = {"mod_1": {"data": torch.from_numpy(img).to(dev), "masks": None},
                 "mod_2": {"data": torch.from_numpy(txt).to(dev),
                           "masks": torch.from_numpy(mask).to(dev)}}
        eps = [torch.from_numpy(d).to(dev) for d in draws]
        if mixing == "moe":
            eps = dict(zip(("mod_1", "mod_2"), eps))
        step = make_train_step(model, make_optimizer("adam", 1e-3, model.parameters()))
        telemetry.reset()
        loss = step(batch, eps=eps)["loss"].item()
        if dev == "cuda":
            assert telemetry.launches() == kernels
        # the step leaves its gradients in .grad
        out[dev] = (loss, {n: (torch.zeros_like(p) if p.grad is None else p.grad).cpu()
                           for n, p in model.named_parameters()})
    assert out["cuda"][0] == pytest.approx(out["cpu"][0], rel=1e-5)
    for name, g in out["cpu"][1].items():
        err = (out["cuda"][1][name] - g).abs().max().item()
        assert err <= 1e-4 * g.abs().max().item() + 1e-5, f"{name}: {err}"


def test_poe_forward_on_the_card_matches_the_cpu(cuda):
    """The narrow model built from one seed on both devices, same inputs
    and injected eps: kernels on the card, plain versions on the CPU."""
    specs = (ModalitySpec("mod_1", "CNN2", "CNN", (32, 32, 3)),
             ModalitySpec("mod_2", "TxtTransformer", "TxtTransformer", (12, 27),
                          mod_type="text", has_masks=True))
    rng = np.random.default_rng(0)
    img = rng.random((3, 32, 32, 3)).astype(np.float32)
    txt = np.eye(27, dtype=np.float32)[rng.integers(0, 27, (3, 12))]
    mask = np.arange(12)[None, :] < rng.integers(1, 13, (3, 1))
    eps = rng.standard_normal((1, 3, 8)).astype(np.float32)
    outs = {}
    for dev in ("cuda", "cpu"):
        model = get_mixing("poe")(specs, 8, seed=0, device=dev).eval()
        batch = {"mod_1": {"data": torch.from_numpy(img).to(dev), "masks": None},
                 "mod_2": {"data": torch.from_numpy(txt).to(dev),
                           "masks": torch.from_numpy(mask).to(dev)}}
        telemetry.reset()
        with torch.inference_mode():
            out = model.forward(batch, ("mod_1", "mod_2"), eps=torch.from_numpy(eps).to(dev))
        if dev == "cuda":
            assert telemetry.launches() == {"attention": 2, "poe": 1}
        outs[dev] = {n: m.decoder_dist.mean.cpu() for n, m in out.mods.items()}
    for name in outs["cpu"]:
        torch.testing.assert_close(outs["cuda"][name], outs["cpu"][name], **SLICE_TOL)
