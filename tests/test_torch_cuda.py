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
from multimodal_vae_comparison_tpu_torch.ops.fusion import subset_lattice
from multimodal_vae_comparison_tpu_torch.ops.kernels import attention as tattn
from multimodal_vae_comparison_tpu_torch.ops.kernels import kl_kernel as tkl
from multimodal_vae_comparison_tpu_torch.ops.kernels import poe_kernel as tpoe
from multimodal_vae_comparison_tpu_torch.ops.kernels import sample_kernel as tsample
from multimodal_vae_comparison_tpu_torch.ops.kernels import sparse_attention as tsparse
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
SPARSE_TOL = dict(rtol=2e-4, atol=2e-5)      # as tests/test_pallas.py, forward
SPARSE_BWD_TOL = dict(rtol=2e-3, atol=2e-4)  # as tests/test_pallas.py, backward
# same generator, same libm: only the fused multiply-add of z = mu + scale * eps
# and the order of one product differ from the plain version
SAMPLE_TOL = dict(rtol=1e-5, atol=1e-6)
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


@pytest.mark.parametrize("b,h,tq,tk,dh,masked,variant", [
    (128, 2, 45, 45, 32, True, "resident"),    # encoder self-attention, bucket 128
    (128, 2, 45, 1, 8, False, "resident"),     # decoder cross-attention
    (4, 2, 130, 130, 16, True, "resident"),    # few heads: split by query rows
    (3, 1, 1, 7, 4, True, "resident"),         # one query row
    (2, 2, 9, 33, 128, False, "resident"),     # widest head
    (3, 2, 9, 1, 8, True, "resident"),         # one key, masked in one row
    (3, 2, 9, 31, 6, True, "resident"),        # one key per lane, Dh % 4 != 0
    (3, 2, 9, 32, 6, False, "resident"),
    (3, 2, 9, 33, 6, True, "resident"),        # two keys per lane
    (2, 2, 45, 45, 5, True, "resident"),
    (2, 3, 50, 200, 32, True, "resident"),     # eight keys per lane
    (1, 2, 1000, 45, 32, False, "resident"),   # many query rows, two heads
    (2, 2, 20, 1000, 16, True, "chunked"),     # Tk over the resident path's 256
    (2, 2, 20, 256, 128, True, "chunked"),     # K and V over its shared memory
    (1, 1, 300, 300, 64, False, "chunked"),
])
def test_attention_kernel_matches_plain(cuda, b, h, tq, tk, dh, masked, variant):
    q, k, v, mask = _qkv(7, b, h, tq, tk, dh, masked, cuda)
    telemetry.reset()
    got = tattn.masked_attention(q, k, v, mask)
    assert telemetry.launches() == {"attention": 1}
    assert telemetry.variants() == {f"attention:{variant}": 1}
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


def _experts_on(cuda, seed, m, shape):
    rng = np.random.default_rng(seed)
    mus = [torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(cuda)
           for _ in range(m)]
    scales = [torch.from_numpy(rng.uniform(0.3, 2.0, shape).astype(np.float32)).to(cuda)
              for _ in range(m)]
    return mus, scales


# (experts, lattice, rows, p0): serving's one subset of both experts, the
# flagship's lattice at bs 24 and 256, PolyMNIST's 5 experts (31 subsets),
# and the lattice without the prior
POE_LATTICE_CASES = [(2, ((0, 1),), 128, 1.0), (2, None, 24, 1.0), (2, None, 256, 1.0),
                     (5, None, 24, 1.0), (5, None, 256, 0.0), (3, None, 24, 0.0)]


@pytest.mark.parametrize("m,lattice,rows,prior", POE_LATTICE_CASES)
def test_poe_lattice_kernels_match_plain(cuda, m, lattice, rows, prior):
    """Forward and backward kernels, one launch each, against the plain
    versions within POE_TOL (the forward's division and square root are
    within 2 ulp; the backward rounds the plain closed form's operations one
    by one), the gradients also against autograd through the plain forward
    within POE_BWD_TOL."""
    lattice = lattice or subset_lattice(m)
    mus, scales = _experts_on(cuda, 14 + m, m, (rows, 16))
    ups = [torch.randn((len(lattice), rows, 16), device=cuda) for _ in range(2)]
    leaves = [x.clone().requires_grad_() for x in mus + scales]
    telemetry.reset()
    mu, scale = tpoe.poe_lattice(leaves[:m], leaves[m:], lattice, prior)
    got = torch.autograd.grad((mu, scale), leaves, ups)
    assert telemetry.launches() == {"poe": 1, "poe_bwd": 1}
    want_mu, want_scale = tpoe.poe_lattice_reference(mus, scales, lattice, prior)
    torch.testing.assert_close(mu, want_mu, **POE_TOL)
    torch.testing.assert_close(scale, want_scale, **POE_TOL)
    d_mus, d_scales = tpoe.poe_lattice_backward_reference(mus, scales, mu.detach(),
                                                          scale.detach(), *ups, lattice)
    for g, w in zip(got, d_mus + d_scales):
        torch.testing.assert_close(g, w, **POE_TOL)
    want = _grads(lambda *x: tpoe.poe_lattice_reference(x[:m], x[m:], lattice, prior),
                  mus + scales, ups)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **POE_BWD_TOL)


def test_poe_lattice_and_its_backward_replay_in_a_cuda_graph(cuda):
    """The flagship lattice's forward and backward captured in one CUDA
    graph: the lattice and the expert pointers are kernel parameters, so a
    replay on new inputs copied into the captured tensors gives the plain
    versions' results, and the capture counted one launch of each."""
    m, lattice = 2, subset_lattice(2)
    static = [x.clone() for x in sum(_experts_on(cuda, 30, m, (24, 16)), [])]
    ups = [torch.randn((len(lattice), 24, 16), device=cuda) for _ in range(2)]

    def run():
        leaves = [x.detach().requires_grad_() for x in static]
        mu, scale = tpoe.poe_lattice(leaves[:m], leaves[m:], lattice, 1.0)
        return (mu, scale) + torch.autograd.grad((mu, scale), leaves, ups)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            run()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    telemetry.reset()
    with torch.cuda.graph(graph):
        out = run()
    assert telemetry.launches() == {"poe": 1, "poe_bwd": 1}
    for seed in (31, 32):
        for dst, src in zip(static, sum(_experts_on(cuda, seed, m, (24, 16)), [])):
            dst.copy_(src)
        graph.replay()
        torch.cuda.synchronize()
        mus, scales = static[:m], static[m:]
        want = tpoe.poe_lattice_reference(mus, scales, lattice, 1.0)
        want += tuple(sum(tpoe.poe_lattice_backward_reference(
            mus, scales, *want, *ups, lattice), []))
        for g, w in zip(out, want):
            torch.testing.assert_close(g, w, **POE_TOL)


@pytest.mark.parametrize("m,rows,broadcast", [(1, 24, False), (2, 24, False), (2, 24, True),
                                              (2, 256, False), (5, 256, True)])
def test_kl_multi_kernels_match_plain(cuda, m, rows, broadcast):
    """Forward and backward kernels, one launch each, against the plain
    versions; ``broadcast``: the upstream gradient is the stride-0 view a
    sum's backward hands over, read in place."""
    mus, scales = _experts_on(cuda, 40 + m, m, (rows, 16))
    up = (torch.full((), 0.7, device=cuda).expand(m, rows) if broadcast
          else torch.randn((m, rows), device=cuda))
    leaves = [x.clone().requires_grad_() for x in mus + scales]
    telemetry.reset()
    got = tkl.kl_normal_std_multi(leaves[:m], leaves[m:])
    got_grads = torch.autograd.grad(got, leaves, up)
    assert telemetry.launches() == {"kl": 1, "kl_bwd": 1}
    assert got.shape == (m, rows)
    torch.testing.assert_close(got, tkl.kl_multi_reference(mus, scales), **KL_TOL)
    want = _grads(lambda *x: tkl.kl_multi_reference(x[:m], x[m:]), mus + scales, up)
    for g, w in zip(got_grads, want):
        torch.testing.assert_close(g, w, **KL_TOL)


def _flagship_specs():
    return (ModalitySpec("mod_1", "CNN2", "CNN", (64, 64, 3)),
            ModalitySpec("mod_2", "TxtTransformer", "TxtTransformer", (45, 27),
                         mod_type="text", recon_loss="category_ce", has_masks=True))


@pytest.mark.parametrize("mixing,kernels", [
    ("poe", {"attention": 2, "poe": 1, "poe_bwd": 1}),
    ("moe", {"attention": 2, "kl": 1, "kl_bwd": 1})])
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


SPARSE_SHAPES = [
    # b, h, t, dh, block, stride, the kernels the three launchers pick
    (1, 2, 2048, 32, 128, 4, "mma"),   # VideoGPTSparse, one clip
    (3, 2, 256, 32, 128, 4, "mma"),
    (2, 2, 64, 8, 8, 2, "fma"),        # block not a multiple of 16
    (2, 1, 96, 8, 8, 3, "fma"),
    (1, 2, 64, 16, 16, 1, "mma"),      # every earlier block live
    (2, 1, 128, 64, 16, 4, "mma"),     # widest head
    (1, 1, 16, 4, 4, 2, "fma"),
    (1, 3, 40, 12, 8, 3, "fma"),       # Dh padded from 12 to 16
    (2, 2, 128, 32, 128, 4, "mma"),    # T = one block
    (2, 2, 256, 8, 64, 1, "mma"),      # narrowest head of the tensor-core kernel
    (2, 1, 512, 16, 64, 4, "mma"),
    (1, 2, 1024, 64, 128, 4, "mma"),
    (2, 2, 320, 32, 80, 2, "mma"),     # block not a multiple of 32: a half-empty warp
    (1, 2, 160, 12, 16, 3, "mma"),     # Dh padded from 12 to 16, one row tile
    (2, 2, 96, 6, 16, 2, "fma"),       # Dh off the 16-byte grid
    (1, 2, 64, 4, 16, 2, "fma"),       # Dh under 8
]


def _sparse_inputs(seed, b, h, t, dh, dev):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=(b, h, t, dh)).astype(np.float32)).to(dev)
            for _ in range(4)]


@pytest.mark.parametrize("b,h,t,dh,block,stride,variant", SPARSE_SHAPES)
def test_sparse_attention_kernels_match_plain(cuda, b, h, t, dh, block, stride, variant):
    """Forward (out and lse), then dq, dk, dv against autograd through the
    plain version, same inputs and upstream gradient; each launcher takes
    the row's kernel."""
    q, k, v, d_out = _sparse_inputs(14, b, h, t, dh, cuda)
    telemetry.reset()
    out, lse = tsparse._launch_forward(q, k, v, block, stride)
    assert telemetry.launches() == {"sparse_attention": 1}
    assert telemetry.variants() == {f"sparse_attention:{variant}": 1}
    torch.cuda.synchronize()
    torch.testing.assert_close(out, tsparse.sparse_attention_reference(q, k, v, block, stride),
                               **SPARSE_TOL)
    visible = tsparse.visibility(t, block, stride, cuda)
    logits = (q @ k.transpose(-1, -2)) / dh ** 0.5
    want_lse = torch.logsumexp(logits.masked_fill(~visible, float("-inf")), dim=-1)
    torch.testing.assert_close(lse, want_lse, **SPARSE_TOL)

    telemetry.reset()
    got = _grads(lambda *x: tsparse.strided_block_sparse_attention(*x, block, stride),
                 (q, k, v), d_out)
    assert telemetry.launches() == {"sparse_attention": 1, "sparse_attention_dq": 1,
                                    "sparse_attention_dkv": 1}
    assert telemetry.summary() == {"sparse_attention:cuda": 1, "sparse_attention_bwd:cuda": 1}
    assert telemetry.variants() == {f"sparse_attention:{variant}": 1,
                                    f"sparse_attention_dq:{variant}": 1,
                                    f"sparse_attention_dkv:{variant}": 1}
    want = _grads(lambda *x: tsparse.sparse_attention_reference(*x, block, stride),
                  (q, k, v), d_out)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        torch.testing.assert_close(g, w, **SPARSE_BWD_TOL)


def test_sparse_attention_kernel_is_deterministic_and_refuses_bad_input(cuda):
    q, k, v, d_out = _sparse_inputs(15, 2, 2, 512, 32, cuda)
    first = _grads(lambda *x: tsparse.strided_block_sparse_attention(*x, 128, 4), (q, k, v), d_out)
    again = _grads(lambda *x: tsparse.strided_block_sparse_attention(*x, 128, 4), (q, k, v), d_out)
    for a, b in zip(first, again):
        assert torch.equal(a, b)
    # each kernel alone, on the tensor cores and in fp32 FMAs (block 8)
    for block, variant in ((128, "mma"), (64, "mma"), (8, "fma")):
        telemetry.reset()
        runs = [tsparse._launch_forward(q, k, v, block, 4) for _ in range(3)]
        for out, lse in runs[1:]:
            assert torch.equal(out, runs[0][0]) and torch.equal(lse, runs[0][1])
        out, lse = runs[0]
        args = (q, k, v, d_out, lse, (d_out * out).sum(-1), block, 4)
        dq = [tsparse._launch_dq(*args) for _ in range(3)]
        dkv = [tsparse._launch_dkv(*args) for _ in range(3)]
        assert telemetry.variants() == {f"sparse_attention:{variant}": 3,
                                        f"sparse_attention_dq:{variant}": 3,
                                        f"sparse_attention_dkv:{variant}": 3}
        for run in range(1, 3):
            assert torch.equal(dq[run], dq[0])
            assert torch.equal(dkv[run][0], dkv[0][0]) and torch.equal(dkv[run][1], dkv[0][1])
    with pytest.raises(TypeError):
        tsparse.strided_block_sparse_attention(q.double(), k.double(), v.double())
    with pytest.raises(ValueError):
        x = q.transpose(0, 1)
        tsparse.strided_block_sparse_attention(x, x, x)
    with pytest.raises(ValueError):
        wide = torch.zeros(1, 1, 128, 65, device=cuda)
        tsparse.strided_block_sparse_attention(wide, wide, wide)
    with pytest.raises(ValueError):
        tsparse.strided_block_sparse_attention(q, k, v, block=256)


def test_unaligned_inputs_take_the_kernels_that_need_no_alignment(cuda):
    """Contiguous tensors whose storage starts 4 bytes off a 16-byte line:
    the attention kernel stages by elements, the sparse forward, dq and dk/dv
    fall to the FMA kernels; all still match the plain versions."""
    def off_by_one(x):
        flat = torch.empty(x.numel() + 1, device=x.device)
        flat[1:] = x.reshape(-1)
        return flat[1:].view(x.shape)

    q, k, v, mask = _qkv(20, 4, 2, 45, 45, 32, True, cuda)
    q, k, v = (off_by_one(x) for x in (q, k, v))
    assert q.data_ptr() % 16 == 4 and q.is_contiguous()
    telemetry.reset()
    got = tattn.masked_attention(q, k, v, mask)
    assert telemetry.variants() == {"attention:resident": 1}
    torch.testing.assert_close(got, tattn.attention_reference(q, k, v, mask), **ATTN_TOL)
    q, k, v, d_out = _sparse_inputs(21, 1, 2, 256, 32, cuda)
    q, k, v = (off_by_one(x) for x in (q, k, v))
    telemetry.reset()
    out = tsparse.strided_block_sparse_attention(q, k, v, 64, 2)
    assert telemetry.variants() == {"sparse_attention:fma": 1}
    torch.testing.assert_close(out, tsparse.sparse_attention_reference(q, k, v, 64, 2),
                               **SPARSE_TOL)
    # the backward's launchers on the same unaligned q, k, v (autograd's
    # leaves would be fresh, aligned copies)
    _, lse = tsparse._launch_forward(q, k, v, 64, 2)
    args = (q, k, v, d_out, lse, (d_out * out).sum(-1), 64, 2)
    telemetry.reset()
    got = (tsparse._launch_dq(*args),) + tsparse._launch_dkv(*args)
    assert telemetry.variants() == {"sparse_attention_dq:fma": 1, "sparse_attention_dkv:fma": 1}
    want = _grads(lambda *x: tsparse.sparse_attention_reference(*x, 64, 2), (q, k, v), d_out)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **SPARSE_BWD_TOL)


@pytest.mark.parametrize("shape,seed", [((5, 8, 32), 0), ((1024, 1024), 7), ((7, 5), 2**40 + 3),
                                        ((3,), 2**64 - 1)])
def test_sample_kernel_matches_plain(cuda, shape, seed):
    rng = np.random.default_rng(16)
    mu = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(cuda)
    scale = torch.from_numpy(rng.uniform(0.3, 2.0, shape).astype(np.float32)).to(cuda)
    telemetry.reset()
    z, eps = tsample._launch(mu, scale, seed)
    assert telemetry.launches() == {"sample": 1}
    want_z, want_eps = tsample.sample_reference(mu, scale, seed)
    assert torch.isfinite(z).all()
    torch.testing.assert_close(eps, want_eps, **SAMPLE_TOL)
    torch.testing.assert_close(z, want_z, **SAMPLE_TOL)
    # the same seed on the CPU's plain version gives the same draw
    torch.testing.assert_close(eps.cpu(), tsample.sample_reference(mu.cpu(), scale.cpu(), seed)[1],
                               **SAMPLE_TOL)


def test_sample_normal_fused_on_the_card(cuda):
    mu = torch.full((1024, 1024), 2.0, device=cuda, requires_grad=True)
    scale = torch.full((1024, 1024), 0.5, device=cuda, requires_grad=True)
    z = tsample.sample_normal_fused(mu, scale, 7)
    eps = (z.detach() - 2.0) / 0.5
    assert abs(eps.mean().item()) < 0.01 and abs(eps.std().item() - 1.0) < 0.01
    upstream = torch.randn(z.shape, device=cuda)
    z.backward(upstream)
    torch.testing.assert_close(mu.grad, upstream)
    torch.testing.assert_close(scale.grad, upstream * eps, rtol=1e-4, atol=1e-5)
    assert torch.equal(tsample.sample_normal_fused(mu.detach(), scale.detach(), 7), z.detach())
    assert not torch.equal(tsample.sample_normal_fused(mu.detach(), scale.detach(), 8), z.detach())
    with pytest.raises(TypeError):
        tsample.sample_normal_fused(mu.detach().double(), scale.detach().double(), 7)
    with pytest.raises(ValueError):
        tsample.sample_normal_fused(mu.detach().t(), scale.detach().t(), 7)


def test_sparse_self_attention_module_pads_on_the_card(cuda):
    """T = 21 padded to 24 inside (block 8): the module on the card against
    the same weights on the CPU, output and input gradient."""
    from multimodal_vae_comparison_tpu_torch.models.nets import StridedSparseSelfAttention
    torch.manual_seed(0)
    cpu = StridedSparseSelfAttention(16, 2, block=8, block_stride=2)
    card = StridedSparseSelfAttention(16, 2, block=8, block_stride=2).to(cuda)
    card.load_state_dict(cpu.state_dict())
    x = torch.from_numpy(np.random.default_rng(19).normal(size=(2, 21, 16)).astype(np.float32))
    outs = []
    for module, inp in ((card, x.to(cuda)), (cpu, x)):
        inp = inp.requires_grad_()
        telemetry.reset()
        out = module(inp)
        out.square().sum().backward()
        outs.append((out.detach().cpu(), inp.grad.cpu()))
    assert telemetry.summary() == {"sparse_attention:plain": 1, "sparse_attention_bwd:plain": 1}
    assert outs[0][0].shape == (2, 21, 16)
    torch.testing.assert_close(outs[0][0], outs[1][0], **SPARSE_TOL)
    torch.testing.assert_close(outs[0][1], outs[1][1], **SPARSE_BWD_TOL)


def _video_specs(clip):
    return (ModalitySpec("mod_1", "VideoGPTSparse", "VideoGPTSparse", clip, mod_type="frames"),
            ModalitySpec("mod_2", "FNN", "FNN", (9,), mod_type="actions"))


# per leaf, as a fraction of its max |g|, against the CPU in float64 (fp32
# on the CPU is itself a poor referee for the GroupNorm remainders of the
# decoder's first layer); the limits chip_smoke.py holds the full-width clip
# to, where DReG's log-weights of ~-7e4 have an fp32 ulp of 8e-3
VIDEO_GRAD_REL = {"elbo": 1e-2, "dreg": 5e-2}


@pytest.mark.parametrize("obj,remat", [("elbo", False), ("dreg", False), ("dreg", True)])
def test_video_model_on_the_card_matches_the_cpu(cuda, obj, remat):
    """VideoGPTSparse MOE at the model's widths (64 channels, block 128,
    stride 4) on a (12, 32, 32, 3) clip, 768 tokens = 6 blocks of which the
    last two see a strided earlier one, K 2 and bs 2: launch counts, and loss
    and gradients on the card (kernels) against the CPU's plain path in
    float64, same weights, batch and eps.  The (8, 64, 64, 3) clip of 2048
    tokens is held the same way by chip_smoke.py."""
    clip = (12, 32, 32, 3)
    rng = np.random.default_rng(17)
    video = rng.random((2,) + clip).astype(np.float32)
    actions = rng.random((2, 9)).astype(np.float32)
    draws = {n: rng.standard_normal((2, 2, 32)).astype(np.float32) for n in ("mod_1", "mod_2")}
    out = {}
    for dev in ("cuda", "cpu"):
        model = build_model(_video_specs(clip), "moe", 32, obj=obj, K=2, device=dev,
                            remat=remat and dev == "cuda")
        dtype = torch.float32 if dev == "cuda" else torch.float64
        model = model.to(dtype)
        batch = {"mod_1": {"data": torch.from_numpy(video).to(dev, dtype), "masks": None},
                 "mod_2": {"data": torch.from_numpy(actions).to(dev, dtype), "masks": None}}
        eps = {n: torch.from_numpy(d).to(dev, dtype) for n, d in draws.items()}
        telemetry.reset()
        loss, _ = model.objective(batch, eps=eps)
        loss.backward()
        if dev == "cuda":
            launches = {k: n for k, n in telemetry.launches().items()
                        if k not in ("kl", "kl_bwd")}
            assert launches == {
                "sparse_attention": 8 if obj == "elbo" else 20 if remat else 12,
                "sparse_attention_dq": 8, "sparse_attention_dkv": 8}
            assert not any(k.endswith(":plain") for k in telemetry.summary())
        out[dev] = (loss.item(), {n: (torch.zeros_like(p) if p.grad is None
                                      else p.grad).float().cpu()
                                  for n, p in model.named_parameters()})
    assert out["cuda"][0] == pytest.approx(out["cpu"][0], rel=1e-5)
    for name, g in out["cpu"][1].items():
        err = (out["cuda"][1][name] - g).abs().max().item()
        assert err <= VIDEO_GRAD_REL[obj] * g.abs().max().item() + 1e-5, f"{name}: {err}"


def test_axial_videogpt_on_the_card_matches_the_cpu(cuda):
    """Enc/Dec_VideoGPT (axial attention through the masked attention kernel
    at B*H*W, B*T*W and B*T*H rows) under MOE/ELBO on a (4, 32, 32, 3) clip:
    loss and gradients on the card against the CPU in float64."""
    clip = (4, 32, 32, 3)
    specs = (ModalitySpec("mod_1", "VideoGPT", "VideoGPT", clip, mod_type="frames"),
             ModalitySpec("mod_2", "FNN", "FNN", (9,), mod_type="actions"))
    rng = np.random.default_rng(18)
    video = rng.random((2,) + clip).astype(np.float32)
    actions = rng.random((2, 9)).astype(np.float32)
    draws = {n: rng.standard_normal((1, 2, 16)).astype(np.float32) for n in ("mod_1", "mod_2")}
    out = {}
    for dev, dtype in (("cuda", torch.float32), ("cpu", torch.float64)):
        model = build_model(specs, "moe", 16, device=dev).to(dtype)
        batch = {"mod_1": {"data": torch.from_numpy(video).to(dev, dtype), "masks": None},
                 "mod_2": {"data": torch.from_numpy(actions).to(dev, dtype), "masks": None}}
        telemetry.reset()
        loss, _ = model.objective(
            batch, eps={n: torch.from_numpy(d).to(dev, dtype) for n, d in draws.items()})
        loss.backward()
        if dev == "cuda":
            # three axes per block, four blocks per net, encoder and decoder
            assert telemetry.launches() == {"attention": 24, "kl": 1, "kl_bwd": 1}
        out[dev] = (loss.item(), {n: p.grad.float().cpu() for n, p in model.named_parameters()
                                  if p.grad is not None})
    assert out["cuda"][0] == pytest.approx(out["cpu"][0], rel=1e-5)
    for name, g in out["cpu"][1].items():
        err = (out["cuda"][1][name] - g).abs().max().item()
        assert err <= VIDEO_GRAD_REL["elbo"] * g.abs().max().item() + 1e-5, f"{name}: {err}"


def _level1_trainers(tmp_path, count=90):
    """The flagship POE over generated CdSprites+ level 1 (``.pkl``: the
    card's host may lack h5py), one Trainer on each device from one seed."""
    from multimodal_vae_comparison_tpu_torch.config import Config
    from multimodal_vae_comparison_tpu_torch.data_proc.cdsprites import generate_level
    from multimodal_vae_comparison_tpu_torch.training.trainer import Trainer
    level = generate_level(1, count, str(tmp_path), seed=0, fmt="pkl")
    params = {"batch_size": 24, "epochs": 1, "exp_name": "eval", "lr": 1e-3, "n_latents": 16,
              "mixing": "poe", "obj": "elbo", "seed": 3, "test_split": 0.25,
              "dataset_name": "cdspritesplus", "labels": None}
    for i, (mod_type, enc, dec, loss) in enumerate(
            (("image", "CNN2", "CNN", "bce"),
             ("text", "TxtTransformer", "TxtTransformer", "category_ce"))):
        params[f"modality_{i + 1}"] = {
            "encoder": enc, "decoder": dec, "mod_type": mod_type, "recon_loss": loss,
            "path": f"{level}/traindata.pkl", "test_datapath": f"{level}/testdata.pkl"}
    return {dev: Trainer(Config(params), device=dev, enable_viz=False).init_state()
            for dev in ("cuda", "cpu")}


def test_judge_trains_on_the_card_as_on_the_cpu(cuda, tmp_path):
    """Two epochs of the CdSprites+ shape judge from one init on each
    device: the same weights (Adam's steps where a gradient is within
    rounding of zero aside) and the same predictions."""
    from multimodal_vae_comparison_tpu_torch.eval.classifiers import (
        CNNClassifier, predict, train_classifier)
    from multimodal_vae_comparison_tpu_torch.eval.eval_cdsprites import (
        CLASS_MAPPINGS, get_attribute)
    dm = _level1_trainers(tmp_path)["cpu"].datamodule
    images, _ = dm.split_arrays(0, "train")
    y = np.array([CLASS_MAPPINGS["shape"].index(get_attribute("shape", t))
                  for t in dm.labels_train])
    judges = {dev: train_classifier(CNNClassifier(3).to(dev), images, y, epochs=2,
                                    batch_size=16) for dev in ("cuda", "cpu")}
    for (name, a), b in zip(judges["cuda"].named_parameters(), judges["cpu"].parameters()):
        diff = (a.cpu() - b).detach().abs()
        assert diff.max().item() <= 2 * 1e-3 * 2 * (len(images) // 16), name
        share = (diff <= 1e-4 * b.abs().max()).float().mean().item()
        assert share >= 0.999, f"{name}: {share}"
    assert np.array_equal(predict(judges["cuda"], images), predict(judges["cpu"], images))


def test_eval_generation_on_the_card_matches_the_cpu(cuda, tmp_path):
    """The eval's cross-generation of the test rows and its prior joint
    generation, same weights and the eval's own seeded draws (a CPU
    generator's, so the same eps on both): kernels on the card (counted),
    plain versions on the CPU, decoder means within 1e-4."""
    from multimodal_vae_comparison_tpu_torch.eval.infer import MultimodalVAEInfer
    trainers = _level1_trainers(tmp_path)
    out = {}
    for dev, trainer in trainers.items():
        exp = MultimodalVAEInfer.from_trainer(trainer)
        batch, labels = exp.get_test_samples(250)
        telemetry.reset()
        t2i = exp.cross_generate("mod_2", batch["mod_2"]["data"], batch["mod_2"]["masks"])
        i2t = exp.cross_generate("mod_1", batch["mod_1"]["data"])
        joint = exp.joint_generate(64, seed=2)
        if dev == "cuda":
            assert telemetry.launches() == {"attention": 2 + 1 + 1, "poe": 2}
        out[dev] = (t2i, i2t, joint)
    for got, want in zip(out["cuda"], out["cpu"]):
        for name in want:
            np.testing.assert_allclose(got[name], want[name], **SLICE_TOL, err_msg=name)
