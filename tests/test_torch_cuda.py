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
from multimodal_vae_comparison_tpu_torch.ops.kernels import poe_kernel as tpoe
from multimodal_vae_comparison_tpu_torch.ops.kernels import telemetry

pytestmark = pytest.mark.cuda

ATTN_TOL = dict(rtol=2e-4, atol=2e-5)   # as tests/test_pallas.py
POE_TOL = dict(rtol=1e-5, atol=1e-6)    # elementwise fp32, one sum over E
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
    q = torch.randn(1, 2, 3, 8, device=cuda, requires_grad=True)
    with pytest.raises(NotImplementedError):
        tattn.masked_attention(q, q.detach(), q.detach())
    with pytest.raises(TypeError):
        tattn.masked_attention(*(q.detach().double(),) * 3)
    with pytest.raises(ValueError):
        x = q.detach().transpose(2, 3)
        tattn.masked_attention(x, x, x)
    mus = torch.randn(2, 3, 4, device=cuda, requires_grad=True)
    with pytest.raises(NotImplementedError):
        tpoe.poe_fused(mus, mus.detach().abs() + 0.5)
    with pytest.raises(ValueError):
        tpoe.poe_fused(mus.detach(), torch.ones(2, 3, 5, device=cuda))


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
