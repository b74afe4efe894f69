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

from multimodal_vae_comparison_tpu_torch.device import set_numerics
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
    set_numerics()
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
    (128, 2, 45, 1, 8, False, "few_keys"),     # decoder cross-attention
    (4, 2, 130, 130, 16, True, "resident"),    # few heads: split by query rows
    (3, 1, 1, 7, 4, True, "resident"),         # one query row
    (2, 2, 9, 33, 128, False, "resident"),     # widest head
    (3, 2, 9, 1, 8, True, "few_keys"),         # one key, masked in one row
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


# (experts, prior mask): every subset of E = 1 ... M experts, with the prior
# expert on no subset, on all (POE), or on the full set only (MoPoE)
PRIOR_MASK_CASES = [(m, kind) for m in (2, 3, 4, 5) for kind in ("none", "all", "full")]


@pytest.mark.parametrize("m,kind", PRIOR_MASK_CASES)
def test_poe_lattice_prior_mask_kernels_match_plain(cuda, m, kind):
    """The lattice with a per-subset prior bitmask: one forward and one
    backward launch, against the plain versions within POE_TOL, and the
    gradients against autograd through the plain forward within
    POE_BWD_TOL."""
    lattice = subset_lattice(m)
    mask = {"none": 0, "all": (1 << len(lattice)) - 1, "full": 1 << (len(lattice) - 1)}[kind]
    mus, scales = _experts_on(cuda, 50 + m, m, (24, 16))
    ups = [torch.randn((len(lattice), 24, 16), device=cuda) for _ in range(2)]
    leaves = [x.clone().requires_grad_() for x in mus + scales]
    telemetry.reset()
    mu, scale = tpoe.poe_lattice(leaves[:m], leaves[m:], lattice, 1.0, prior_mask=mask)
    got = torch.autograd.grad((mu, scale), leaves, ups)
    assert telemetry.launches() == {"poe": 1, "poe_bwd": 1}
    want_mu, want_scale = tpoe.poe_lattice_reference(mus, scales, lattice, 1.0, mask)
    torch.testing.assert_close(mu, want_mu, **POE_TOL)
    torch.testing.assert_close(scale, want_scale, **POE_TOL)
    d_mus, d_scales = tpoe.poe_lattice_backward_reference(mus, scales, mu.detach(),
                                                          scale.detach(), *ups, lattice)
    for g, w in zip(got, d_mus + d_scales):
        torch.testing.assert_close(g, w, **POE_TOL)
    want = _grads(lambda *x: tpoe.poe_lattice_reference(x[:m], x[m:], lattice, 1.0, mask),
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


@pytest.mark.parametrize("mixing,kernels", [
    ("mopoe", {"attention": 2, "poe": 1, "poe_bwd": 1}),
    ("dmvae", {"attention": 4, "poe": 1, "poe_bwd": 1, "kl": 1, "kl_bwd": 1})])
def test_zoo_objective_on_the_card_matches_the_cpu(cuda, mixing, kernels):
    """MoPoE and DMVAE on the flagship's nets with 10 private latents at bs
    24: one objective and its backward launch exactly their kernels (MoPoE's
    lattice with the prior on the full set only, DMVAE's joint without it
    and every private KL in one call), and the loss and every gradient
    match the CPU's plain path on the same weights, batch and draws, the CPU
    on the card's relu branches (chip_smoke.same_branches: from flax's zero
    biases one element within rounding of 0 moved DMVAE's decoder Dense 17
    times past the limit)."""
    import dataclasses
    import pathlib
    import sys
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    try:
        import chip_smoke
    finally:
        sys.path.pop(0)
    rng = np.random.default_rng(17)
    img = rng.random((24, 64, 64, 3)).astype(np.float32)
    txt = np.eye(27, dtype=np.float32)[rng.integers(0, 27, (24, 45))]
    mask = np.arange(45)[None, :] < rng.integers(1, 46, (24, 1))
    specs = tuple(dataclasses.replace(s, private_latents=10) for s in _flagship_specs())
    out, draws, branches = {}, None, []
    for dev in ("cuda", "cpu"):
        model = build_model(specs, mixing, 16, device=dev)
        if draws is None:
            shapes = ([(1, 24, 16)] if mixing == "mopoe"
                      else model.eps_shapes(model.mod_names, 24))
            draws = [rng.standard_normal(s).astype(np.float32) for s in shapes]
        eps = [torch.from_numpy(d).to(dev) for d in draws]
        batch = {"mod_1": {"data": torch.from_numpy(img).to(dev), "masks": None},
                 "mod_2": {"data": torch.from_numpy(txt).to(dev),
                           "masks": torch.from_numpy(mask).to(dev)}}
        telemetry.reset()
        with chip_smoke.same_branches(branches, dev == "cpu", {}):
            loss, _ = model.objective(batch, eps=eps[0] if mixing == "mopoe" else eps)
            loss.backward()
        if dev == "cuda":
            assert telemetry.launches() == kernels
        out[dev] = (loss.item(), {n: (torch.zeros_like(p) if p.grad is None
                                      else p.grad).float().cpu()
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


def test_video_judges_on_the_card_match_the_cpu(cuda):
    """The SPRITES judges (the action judge, the four-head frame attribute
    judge, and the mean-pooled judge of the judges' CLI) on seeded weights
    and (8, 64, 64, 3) clips: logits on the card (cuDNN, TF32 off) against
    the CPU's."""
    from multimodal_vae_comparison_tpu_torch.eval import classifiers as clf
    x = torch.from_numpy(np.random.default_rng(19).random((3, 8, 64, 64, 3)).astype(np.float32))
    for make in (lambda: clf.ActionVideoClassifier(9, seed=1),
                 lambda: clf.FrameAttributeClassifier(6, heads=4, seed=2),
                 lambda: clf.VideoClassifier(9, seed=3)):
        with torch.no_grad():
            got = make().to(cuda)(x.to(cuda)).cpu()
            want = make()(x)
        np.testing.assert_allclose(got.numpy(), want.numpy(), **SLICE_TOL)


def _sprites_config(path, clip):
    """A shipped SPRITES config at ``clip``, without data."""
    import pathlib

    from multimodal_vae_comparison_tpu_torch.config import Config
    cfg = Config(str(pathlib.Path(__file__).resolve().parents[1] / path), eval_only=True)
    for mod, dims in zip(cfg.mods, (clip, (9,), (4, 6))):
        mod.feature_dims = list(dims)
    return cfg


@pytest.mark.parametrize("path,kernels", [
    ("configs/round4/sprites_r4_dreg_up.yml", {"attention": 36}),
    ("configs/round2/sprites_r2_poe.yml", {"attention": 24, "poe": 1, "poe_bwd": 1})])
def test_sprites_objective_on_the_card_matches_the_cpu(cuda, path, kernels):
    """The SPRITES configs' models at their widths (VideoGPT with axial
    attention, MOE/DReG at K 5 and POE/ELBO) on (4, 32, 32, 3) clips at bs
    2, remat off: one objective and its backward launch exactly their
    kernels, and the loss and every gradient match the CPU's plain path in
    float64 on the same weights, batch and draws, the CPU on the card's
    relu branches and DReG weights (chip_smoke.same_branches,
    same_dreg_weights): the referee of chip_smoke.py's full-width check,
    where the CPU's fp32 is itself at the limit."""
    import pathlib
    import sys
    from multimodal_vae_comparison_tpu_torch.training.trainer import build_model_from_config
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    try:
        import chip_smoke
    finally:
        sys.path.pop(0)
    clip = (4, 32, 32, 3)
    cfg = _sprites_config(path, clip)
    rng = np.random.default_rng(20)
    data = {"mod_1": rng.random((2,) + clip).astype(np.float32),
            "mod_2": np.eye(9, dtype=np.float32)[rng.integers(0, 9, 2)],
            "mod_3": np.eye(6, dtype=np.float32)[rng.integers(0, 6, (2, 4))]}
    shape = (cfg.K, 2, cfg.n_latents)
    draws = ({n: rng.standard_normal(shape).astype(np.float32) for n in data}
             if cfg.mixing == "moe" else [rng.standard_normal(shape).astype(np.float32)
                                          for _ in range(7)])
    branches, weights, out = [], [], {}
    for dev, dtype in (("cuda", torch.float32), ("cpu", torch.float64)):
        model = build_model_from_config(cfg, device=dev).to(dtype)
        model.remat = False
        batch = {n: {"data": torch.from_numpy(d).to(dev, dtype), "masks": None}
                 for n, d in data.items()}
        eps = ({n: torch.from_numpy(d).to(dev, dtype) for n, d in draws.items()}
               if isinstance(draws, dict)
               else [torch.from_numpy(d).to(dev, dtype) for d in draws])
        telemetry.reset()
        with chip_smoke.same_branches(branches, dev == "cpu", {}), \
                chip_smoke.same_dreg_weights(weights, dev == "cpu", {}):
            loss, _ = model.objective(batch, eps=eps)
            loss.backward()
        if dev == "cuda":
            assert telemetry.launches() == kernels
            assert not any(k.endswith(":plain") for k in telemetry.summary())
        out[dev] = (loss.item(), {n: (torch.zeros_like(p) if p.grad is None
                                      else p.grad).float().cpu()
                                  for n, p in model.named_parameters()})
    assert out["cuda"][0] == pytest.approx(out["cpu"][0], rel=1e-5)
    for name, g in out["cpu"][1].items():
        err = (out["cuda"][1][name] - g).abs().max().item()
        assert err <= 1e-4 * g.abs().max().item() + 1e-5, f"{name}: {err}"


def _cub_masks(b, seed):
    """Key-padding masks of b captions of the CUB surrogate's grammar at its
    246 characters: 40-70 characters each, the rest padding."""
    lengths = np.random.default_rng(seed).integers(40, 71, (b, 1))
    return np.arange(246)[None, :] < lengths


@pytest.mark.parametrize("b,tk,dh,masked,variant", [
    (32, 246, 32, True, "resident"),     # cub_r2's text encoder: self-attention over captions
    (16, 246, 32, True, "resident"),     # config_cub's
    (640, 1, 8, False, "few_keys")])     # cub_r2's text decoder on M*K*B = 640 latents
def test_attention_at_cub_caption_length_matches_plain(cuda, b, tk, dh, masked, variant):
    """Masked attention at CUB's 246-character captions, the encoders on the
    resident kernel (Tk <= 256 keys, 8 a lane), the decoder's one key on the
    few-keys kernel: forward and the Function's backward against autograd
    through the plain version."""
    q, k, v, _ = _qkv(21, b, 2, 246, tk, dh, False, cuda)
    mask = torch.from_numpy(_cub_masks(b, 22)).to(cuda) if masked else None
    telemetry.reset()
    got = tattn.masked_attention(q, k, v, mask)
    assert telemetry.variants() == {f"attention:{variant}": 1}
    torch.testing.assert_close(got, tattn.attention_reference(q, k, v, mask), **ATTN_TOL)
    d_out = torch.randn(q.shape, device=cuda, generator=torch.Generator(cuda).manual_seed(3))
    leaves = [[x.detach().clone().requires_grad_() for x in (q, k, v)] for _ in range(2)]
    got = torch.autograd.grad(tattn.masked_attention(*leaves[0], mask), leaves[0], d_out)
    want = torch.autograd.grad(tattn.attention_reference(*leaves[1], mask), leaves[1], d_out)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, **ATTN_TOL)


@pytest.mark.parametrize("over,kernels", [
    ({}, {"attention": 3}),
    ({"mixing": "poe", "obj": "elbo", "K": 1}, {"attention": 2, "poe": 1, "poe_bwd": 1}),
    ({"obj": "elbo", "K": 1}, {"attention": 2})],
    ids=["moe-dreg", "poe-elbo", "moe-elbo"])
def test_mixture_prior_step_on_the_card_matches_the_cpu(cuda, over, kernels):
    """``configs/round4/cdl1_r4_mog.yml`` (50 mixture components) at its
    widths and bs 2: MOE/DReG at K 10, and POE and MOE ELBO under the same
    prior.  One objective and its backward launch exactly their kernels, no
    KL kernel (the KL to the mixture is a Monte-Carlo mean), and the loss
    and every gradient (pz_mog_* among them) match the CPU's plain path in
    float64 on the same weights, batch and draws, the CPU on the card's relu
    branches and DReG weights (chip_smoke.same_branches,
    same_dreg_weights)."""
    import pathlib
    import sys
    from multimodal_vae_comparison_tpu_torch.config import Config
    from multimodal_vae_comparison_tpu_torch.training.trainer import build_model_from_config
    root = pathlib.Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root))
    try:
        import chip_smoke
    finally:
        sys.path.pop(0)
    cfg = Config(str(root / "configs/round4/cdl1_r4_mog.yml"), overrides=over, eval_only=True)
    for mod, dims in zip(cfg.mods, ((64, 64, 3), (45, 27))):
        mod.feature_dims = list(dims)
    rng = np.random.default_rng(23)
    data = {"mod_1": rng.random((2, 64, 64, 3)).astype(np.float32),
            "mod_2": np.eye(27, dtype=np.float32)[rng.integers(0, 27, (2, 45))]}
    masks = np.arange(45)[None, :] < np.array([[20], [45]])
    shape = (cfg.K, 2, cfg.n_latents)
    draws = ({n: rng.standard_normal(shape).astype(np.float32) for n in data}
             if cfg.mixing == "moe" else [rng.standard_normal(shape).astype(np.float32)
                                          for _ in range(3)])
    branches, weights, out = [], [], {}
    for dev, dtype in (("cuda", torch.float32), ("cpu", torch.float64)):
        model = build_model_from_config(cfg, device=dev).to(dtype)
        assert model.prior_components == 50
        batch = {n: {"data": torch.from_numpy(d).to(dev, dtype),
                     "masks": torch.from_numpy(masks).to(dev) if n == "mod_2" else None}
                 for n, d in data.items()}
        eps = ({n: torch.from_numpy(d).to(dev, dtype) for n, d in draws.items()}
               if isinstance(draws, dict)
               else [torch.from_numpy(d).to(dev, dtype) for d in draws])
        telemetry.reset()
        with chip_smoke.same_branches(branches, dev == "cpu", {}), \
                chip_smoke.same_dreg_weights(weights, dev == "cpu", {}):
            loss, _ = model.objective(batch, eps=eps)
            loss.backward()
        if dev == "cuda":
            assert telemetry.launches() == kernels
            assert not any(k.endswith(":plain") for k in telemetry.summary())
        out[dev] = (loss.item(), {n: (torch.zeros_like(p) if p.grad is None
                                      else p.grad).float().cpu()
                                  for n, p in model.named_parameters()})
    assert out["cuda"][0] == pytest.approx(out["cpu"][0], rel=1e-5)
    for name, g in out["cpu"][1].items():
        err = (out["cuda"][1][name] - g).abs().max().item()
        assert err <= 1e-4 * g.abs().max().item() + 1e-5, f"{name}: {err}"
    assert all(out["cuda"][1][n].abs().sum() > 0 for n in ("pz_mog_loc", "pz_mog_rawscale",
                                                           "pz_mog_logits"))


def _vilanro(tmp_path, episodes, **options):
    """A VILANRO directory collected by the port's collector (NLReach2-v0,
    seed 0): 7-step reach trajectories padded to 100 steps, 4-word
    instructions."""
    from multimodal_vae_comparison_tpu_torch.lanro.collect import collect
    return collect("NLReach2-v0", episodes, str(tmp_path / "vilanro"), seed=0,
                   **options)["out_dir"]


@pytest.mark.parametrize("b,tq,tk,dh,masked,variant", [
    (64, 100, 100, 16, True, "resident"),   # the action encoder: ~93 % of keys padding
    (64, 4, 4, 32, True, "resident"),       # the language encoder
    (448, 100, 1, 16, False, "few_keys"),   # the action decoder on S*K*B = 7 * 64 latents
    (448, 4, 1, 16, False, "few_keys")],    # the language decoder
    ids=["action-encoder", "language-encoder", "action-decoder", "language-decoder"])
def test_attention_at_vilanro_shapes_matches_plain(cuda, tmp_path, b, tq, tk, dh, masked,
                                                   variant):
    """Masked attention at VILANRO's shapes (head dim 16 at 32 latents), the
    encoders on the resident kernel and the decoders' one key on the
    few-keys kernel, masked by the collected trajectories' and
    instructions' own padding: forward and the Function's backward against
    autograd through the plain version."""
    import os
    from multimodal_vae_comparison_tpu_torch.data.datasets import VILANRO
    q, k, v, _ = _qkv(31, b, 2, tq, tk, dh, False, cuda)
    mask = None
    if masked:
        d = _vilanro(tmp_path, b)
        mod_type, stem = (("actions", "endeff_actions_final.pkl") if tk == 100
                          else ("language", "instructions_final.pkl"))
        mask = torch.from_numpy(VILANRO(os.path.join(d, stem), None, mod_type)
                                .get_data()[1]).to(cuda)
        assert mask.shape == (b, tk)
        if tk == 100:
            assert mask.float().mean().item() < 0.1
    telemetry.reset()
    got = tattn.masked_attention(q, k, v, mask)
    assert telemetry.variants() == {f"attention:{variant}": 1}
    torch.testing.assert_close(got, tattn.attention_reference(q, k, v, mask), **ATTN_TOL)
    d_out = torch.randn(q.shape, device=cuda, generator=torch.Generator(cuda).manual_seed(4))
    leaves = [[x.detach().clone().requires_grad_() for x in (q, k, v)] for _ in range(2)]
    got = torch.autograd.grad(tattn.masked_attention(*leaves[0], mask), leaves[0], d_out)
    want = torch.autograd.grad(tattn.attention_reference(*leaves[1], mask), leaves[1], d_out)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, **ATTN_TOL)


def test_vilanro_step_on_the_card_matches_the_cpu(cuda, tmp_path):
    """``configs/config_vilanro.yml`` at its widths (8-layer action encoder,
    optimal_sigma on all three modalities) at bs 4 on collected rows: one
    objective and its backward launch exactly their kernels (attention 14,
    the lattice's PoE and its backward), and the loss, the metrics and
    every gradient match the CPU's plain path in float64 on the same
    weights, batch and draws, the CPU on the card's relu branches
    (chip_smoke.same_branches)."""
    import pathlib
    import sys
    import yaml
    from multimodal_vae_comparison_tpu_torch.config import Config
    from multimodal_vae_comparison_tpu_torch.data.datamodule import DataModule
    from multimodal_vae_comparison_tpu_torch.training.trainer import build_model_from_config
    root = pathlib.Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root))
    try:
        import chip_smoke
    finally:
        sys.path.pop(0)
    d = _vilanro(tmp_path, 20, chunk_every=5)
    with open(root / "configs/config_vilanro.yml") as f:
        params = yaml.safe_load(f)
    params.update(batch_size=4)
    params.update({f"modality_{i + 1}": dict(params[f"modality_{i + 1}"],
                                             path=str(pathlib.Path(d) / stem))
                   for i, stem in enumerate(chip_smoke.VILANRO_STEMS)})
    cfg = Config(params, results_root=str(tmp_path / "results"))
    dm = DataModule(cfg)
    dm.setup()
    raw = next(dm.batches("train"))
    rng = np.random.default_rng(24)
    draws = [rng.standard_normal((1, 4, cfg.n_latents)).astype(np.float32) for _ in range(7)]
    branches, out = [], {}
    for dev, dtype in (("cuda", torch.float32), ("cpu", torch.float64)):
        model = build_model_from_config(cfg, device=dev).to(dtype)
        batch = {n: {"data": torch.from_numpy(m["data"]).to(dev, dtype),
                     "masks": None if m["masks"] is None else torch.from_numpy(m["masks"]).to(dev)}
                 for n, m in raw.items()}
        telemetry.reset()
        with chip_smoke.same_branches(branches, dev == "cpu", {}):
            loss, metrics = model.objective(batch, eps=[torch.from_numpy(e).to(dev, dtype)
                                                        for e in draws])
            loss.backward()
        if dev == "cuda":
            assert telemetry.launches() == {"attention": 14, "poe": 1, "poe_bwd": 1}
            assert not any(k.endswith(":plain") for k in telemetry.summary())
        out[dev] = (loss.item(), {k: v.item() for k, v in metrics.items()},
                    {n: (torch.zeros_like(p) if p.grad is None else p.grad).float().cpu()
                     for n, p in model.named_parameters()})
    assert out["cuda"][0] == pytest.approx(out["cpu"][0], rel=1e-5)
    for k, v in out["cpu"][1].items():
        assert out["cuda"][1][k] == pytest.approx(v, rel=1e-5, abs=1e-4), k
    for name, g in out["cpu"][2].items():
        err = (out["cuda"][2][name] - g).abs().max().item()
        assert err <= 1e-4 * g.abs().max().item() + 1e-5, f"{name}: {err}"


@pytest.mark.parametrize("rows,tk,masked", [
    (448, 5, True),     # a cond_always lattice's one decode: S*K*B = 7 * 64 rows
    (64, 5, True),      # vilanro_r4_cond's per-subset decode with the instruction
    (64, 1, False)],    # and without it: the z token alone
    ids=["cond-always-lattice", "per-subset-conditioned", "per-subset-z-only"])
def test_attention_at_transformer_cond_shapes_matches_plain(cuda, tmp_path, rows, tk, masked):
    """Masked attention at Dec_TransformerCond's cross-attention (d_model
    128, 4 heads, head dim 32, 100 waypoint queries), its keys the z token
    and a collected instruction's 4 words under their padding (z always
    kept), on the few-keys kernel: forward and the Function's backward
    against autograd through the plain version."""
    import os
    from multimodal_vae_comparison_tpu_torch.data.datasets import VILANRO
    q, k, v, _ = _qkv(32, rows, 4, 100, tk, 32, False, cuda)
    mask = None
    if masked:
        d = _vilanro(tmp_path, 64)
        words = torch.from_numpy(VILANRO(os.path.join(d, "instructions_final.pkl"), None,
                                         "language").get_data()[1][:64])
        keep = torch.cat([torch.ones(64, 1, dtype=torch.bool), words], 1)
        mask = keep.repeat_interleave(rows // 64, 0).contiguous().to(cuda)
        assert mask.shape == (rows, tk) and mask[:, 0].all()
    telemetry.reset()
    got = tattn.masked_attention(q, k, v, mask)
    assert telemetry.variants() == {"attention:few_keys": 1}
    torch.testing.assert_close(got, tattn.attention_reference(q, k, v, mask), **ATTN_TOL)
    d_out = torch.randn(q.shape, device=cuda, generator=torch.Generator(cuda).manual_seed(5))
    leaves = [[x.detach().clone().requires_grad_() for x in (q, k, v)] for _ in range(2)]
    got = torch.autograd.grad(tattn.masked_attention(*leaves[0], mask), leaves[0], d_out)
    want = torch.autograd.grad(tattn.attention_reference(*leaves[1], mask), leaves[1], d_out)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, **ATTN_TOL)


def test_vilanro_r4_cond_step_on_the_card_matches_the_cpu(cuda, tmp_path):
    """``configs/round4/vilanro_r4_cond.yml`` at its widths (CoordConv,
    TransformerCond decoding per subset, the aux head at weight 1e4) at bs 4
    on collected waypoints: one objective and its backward launch exactly
    their kernels (attention 38, the lattice's PoE and its backward), and
    the loss, the metrics (``aux_endpoint_mse`` among them) and every
    gradient match the CPU's plain path in float64 on the same weights,
    batch and draws, on the card's relu branches; a key bias, whose exact
    gradient is 0, is held at its key weight's scale
    (chip_smoke._worst_leaf)."""
    import pathlib
    import sys
    import yaml
    from multimodal_vae_comparison_tpu_torch.config import Config
    from multimodal_vae_comparison_tpu_torch.data.datamodule import DataModule
    from multimodal_vae_comparison_tpu_torch.training.trainer import build_model_from_config
    root = pathlib.Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root))
    try:
        import chip_smoke
    finally:
        sys.path.pop(0)
    d = _vilanro(tmp_path, 20, chunk_every=5, waypoints=True)
    with open(root / "configs/round4/vilanro_r4_cond.yml") as f:
        params = yaml.safe_load(f)
    params.update(batch_size=4)
    params.update({f"modality_{i + 1}": dict(params[f"modality_{i + 1}"],
                                             path=str(pathlib.Path(d) / stem))
                   for i, stem in enumerate(chip_smoke.VILANRO_STEMS)})
    cfg = Config(params, results_root=str(tmp_path / "results"))
    dm = DataModule(cfg)
    dm.setup()
    raw = next(dm.batches("train"))
    rng = np.random.default_rng(25)
    draws = [rng.standard_normal((1, 4, cfg.n_latents)).astype(np.float32) for _ in range(7)]
    branches, out = [], {}
    for dev, dtype in (("cuda", torch.float32), ("cpu", torch.float64)):
        model = build_model_from_config(cfg, device=dev).to(dtype)
        batch = {n: {"data": torch.from_numpy(m["data"]).to(dev, dtype),
                     "masks": None if m["masks"] is None else torch.from_numpy(m["masks"]).to(dev)}
                 for n, m in raw.items()}
        telemetry.reset()
        with chip_smoke.same_branches(branches, dev == "cpu", {}):
            loss, metrics = model.objective(batch, eps=[torch.from_numpy(e).to(dev, dtype)
                                                        for e in draws])
            loss.backward()
        if dev == "cuda":
            assert telemetry.launches() == {"attention": 38, "poe": 1, "poe_bwd": 1}
            assert not any(k.endswith(":plain") for k in telemetry.summary())
        out[dev] = (loss.item(), {k: v.item() for k, v in metrics.items()},
                    {n: (torch.zeros_like(p) if p.grad is None else p.grad).float().cpu()
                     for n, p in model.named_parameters()})
    assert "aux_endpoint_mse" in out["cuda"][1]
    assert out["cuda"][0] == pytest.approx(out["cpu"][0], rel=1e-5)
    for k, v in out["cpu"][1].items():
        assert out["cuda"][1][k] == pytest.approx(v, rel=1e-5, abs=1e-4), k
    worst, name = chip_smoke._worst_leaf(out["cuda"][2], out["cpu"][2], 1e-4, 1e-5,
                                         key_bias_scale=True)
    assert worst <= 1.0, f"{name}: {worst:.3f} of its limit"


# PolyMNIST's lattice (M 5, all 31 subsets) at its configs' (rows, latents):
# config_polymnist's POE (bs 32, 32 latents; the prior expert on every
# subset) and polymnist_r2_mopoe's MoPoE (bs 128, 24 latents; the prior on
# the full set only), each also without the prior expert
POLYMNIST_LATTICE_CASES = [(32, 32, "all"), (32, 32, "none"), (128, 24, "full"),
                           (128, 24, "none")]


@pytest.mark.parametrize("rows,d,kind", POLYMNIST_LATTICE_CASES)
def test_poe_lattice_at_polymnist_shapes_matches_plain(cuda, rows, d, kind):
    """One forward and one backward launch over the 31 subsets of 5 experts,
    against the plain versions within POE_TOL, and the gradients against
    autograd through the plain forward within POE_BWD_TOL."""
    lattice = subset_lattice(5)
    mask = {"none": 0, "all": (1 << 31) - 1, "full": 1 << 30}[kind]
    mus, scales = _experts_on(cuda, 70 + rows + d, 5, (rows, d))
    ups = [torch.randn((31, rows, d), device=cuda) for _ in range(2)]
    leaves = [x.clone().requires_grad_() for x in mus + scales]
    telemetry.reset()
    mu, scale = tpoe.poe_lattice(leaves[:5], leaves[5:], lattice, 1.0, prior_mask=mask)
    got = torch.autograd.grad((mu, scale), leaves, ups)
    assert telemetry.launches() == {"poe": 1, "poe_bwd": 1}
    assert not any(k.endswith(":plain") for k in telemetry.summary())
    want_mu, want_scale = tpoe.poe_lattice_reference(mus, scales, lattice, 1.0, mask)
    torch.testing.assert_close(mu, want_mu, **POE_TOL)
    torch.testing.assert_close(scale, want_scale, **POE_TOL)
    want = _grads(lambda *x: tpoe.poe_lattice_reference(x[:5], x[5:], lattice, 1.0, mask),
                  mus + scales, ups)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **POE_BWD_TOL)


def test_laplace_dreg_step_on_the_card_matches_the_cpu(cuda):
    """``configs/config_mnistsvhn.yml`` at its widths (MOE, DReG at K 30,
    Laplace posteriors, lprob, llik auto) at bs 4 on random digit-sized
    rows and uniform draws: one objective and its backward launch no kernel
    and no plain version, and the loss, the metrics and every gradient
    match the CPU's plain path in float64 on the same weights, batch and
    draws, on the card's relu branches and DReG weights
    (chip_smoke.same_branches, same_dreg_weights)."""
    import pathlib
    import sys
    from multimodal_vae_comparison_tpu_torch.config import Config
    from multimodal_vae_comparison_tpu_torch.models.distributions import Laplace
    from multimodal_vae_comparison_tpu_torch.training.trainer import build_model_from_config
    root = pathlib.Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root))
    try:
        import chip_smoke
    finally:
        sys.path.pop(0)
    cfg = Config(str(root / "configs/config_mnistsvhn.yml"), eval_only=True)
    for mod, dims in zip(cfg.mods, ([28, 28, 1], [32, 32, 3])):
        mod.feature_dims = dims
    rng = np.random.default_rng(26)
    data = {m.name: rng.random((4, *m.feature_dims)).astype(np.float32) for m in cfg.mods}
    draws = {m.name: rng.uniform(Laplace.U_LOW, Laplace.U_HIGH, (cfg.K, 4, cfg.n_latents))
             .astype(np.float32) for m in cfg.mods}
    branches, weights, out = [], [], {}
    for dev, dtype in (("cuda", torch.float32), ("cpu", torch.float64)):
        model = build_model_from_config(cfg, device=dev).to(dtype)
        batch = {n: {"data": torch.from_numpy(d).to(dev, dtype), "masks": None}
                 for n, d in data.items()}
        telemetry.reset()
        with chip_smoke.same_branches(branches, dev == "cpu", {}), \
                chip_smoke.same_dreg_weights(weights, dev == "cpu", {}):
            loss, metrics = model.objective(batch, eps={n: torch.from_numpy(e).to(dev, dtype)
                                                        for n, e in draws.items()})
            loss.backward()
        if dev == "cuda":
            assert type(model.posterior(model.specs[0], *[torch.zeros(1)] * 2)) is Laplace
            assert telemetry.summary() == {}
        out[dev] = (loss.item(), {k: v.item() for k, v in metrics.items()},
                    {n: (torch.zeros_like(p) if p.grad is None else p.grad).float().cpu()
                     for n, p in model.named_parameters()})
    assert out["cuda"][0] == pytest.approx(out["cpu"][0], rel=1e-5)
    for k, v in out["cpu"][1].items():
        assert out["cuda"][1][k] == pytest.approx(v, rel=1e-5, abs=1e-4), k
    worst, name = chip_smoke._worst_leaf(out["cuda"][2], out["cpu"][2], 1e-4, 1e-5)
    assert worst <= 1.0, f"{name}: {worst:.3f} of its limit"


@pytest.mark.parametrize("b,h,tq,tk,dh,masked,variant", [
    (24, 8, 17, 17, 32, False, "resident"),    # Enc_VIT: 16 patch tokens and cls, width 256
    (16, 4, 8, 8, 64, True, "resident"),       # Enc_TransformerIMG over 8 frames, d_model 256
    (112, 4, 8, 1, 64, False, "few_keys"),     # Dec_TransformerIMG's cross-attention, 7 subsets
    (3, 4, 45, 45, 64, True, "resident")],     # head dim 64 at the text length
    ids=["vit", "transformer-img-enc", "transformer-img-dec", "dh64-text"])
def test_attention_at_head_dim_64_and_the_vit_shape_matches_plain(cuda, b, h, tq, tk, dh,
                                                                  masked, variant):
    """Masked attention at the new nets' shapes, head dim 64 among them, on
    the resident kernel (the decoder's one key on the few-keys kernel):
    forward and the Function's backward against autograd through the plain
    version (a partly padded key mask, one row with every key masked)."""
    q, k, v, mask = _qkv(64, b, h, tq, tk, dh, masked, cuda)
    telemetry.reset()
    got = tattn.masked_attention(q, k, v, mask)
    assert telemetry.variants() == {f"attention:{variant}": 1}
    torch.testing.assert_close(got, tattn.attention_reference(q, k, v, mask), **ATTN_TOL)
    d_out = torch.randn(q.shape, device=cuda, generator=torch.Generator(cuda).manual_seed(6))
    leaves = [[x.detach().clone().requires_grad_() for x in (q, k, v)] for _ in range(2)]
    got = torch.autograd.grad(tattn.masked_attention(*leaves[0], mask), leaves[0], d_out)
    want = torch.autograd.grad(tattn.attention_reference(*leaves[1], mask), leaves[1], d_out)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, **ATTN_TOL)


# the frozen feature nets, card (cuDNN fp32, TF32 off) against the CPU in
# float64, within this share of the largest |value|
FEATURE_NET_REL = 1e-4


def _rel_err(got, want):
    return ((got.double().cpu() - want).abs().max() / want.abs().max()).item()


@pytest.mark.parametrize("lead", [(8,), (3, 8)], ids=["batch_ndims1", "batch_ndims2"])
def test_feature_loss_gradient_on_the_card_matches_the_cpu(cuda, tmp_path, monkeypatch, lead):
    """``feature_loss`` through the frozen VGG extractor (its fixed random
    weights: no file in the weights directory) on (lead..., 64, 64, 3)
    reconstructions: the per-(K, B) values and the gradient of a weighted
    sum with respect to the reconstruction on the card, within 1e-4 of the
    largest |value| of the CPU's in float64, the CPU on the card's relu and
    max-pool branches (chip_smoke.same_branches: an argmax within rounding
    of a tie moves a pixel's gradient to its neighbour, seen at 2.5e-3 of
    the largest |value| without the replay); the extractor takes no
    gradient."""
    import pathlib
    import sys
    from multimodal_vae_comparison_tpu_torch.models import perceptual
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    try:
        import chip_smoke
    finally:
        sys.path.pop(0)
    monkeypatch.setenv("MVAE_TPU_WEIGHTS_DIR", str(tmp_path))
    perceptual.reset_extractor_cache()
    try:
        g = torch.Generator().manual_seed(7)
        recon = torch.rand(lead + (64, 64, 3), generator=g)
        target = torch.rand((8, 64, 64, 3), generator=g)
        up = torch.randn(lead, generator=g)
        branches, out = [], {}
        for dev, dtype in ((cuda, torch.float32), (torch.device("cpu"), torch.float64)):
            r = recon.to(dev, dtype).requires_grad_(True)
            dist = type("Dist", (), {"mean": r})()
            with chip_smoke.same_branches(branches, dev.type == "cpu", {}):
                ll = perceptual.feature_loss(dist, target.to(dev, dtype), None, len(lead))
                (ll * up.to(dev, dtype)).sum().backward()
            out[dev.type] = (ll.detach(), r.grad)
        assert out["cuda"][0].shape == lead
        for got, want in zip(out["cuda"], out["cpu"]):
            assert _rel_err(got, want) <= FEATURE_NET_REL
        assert not any(p.requires_grad for p in perceptual.extractor(cuda).parameters())
    finally:
        perceptual.reset_extractor_cache()


def test_inception_v3_on_the_card_matches_the_cpu(cuda):
    """InceptionV3 pool-3 features of 64 px images (the resize to 299 on the
    card) from seeded weights with non-trivial batch-norm statistics, card
    against the CPU in float64: within 1e-4 of the largest |value|."""
    from multimodal_vae_comparison_tpu_torch.models.inception import InceptionV3
    torch.manual_seed(8)
    net = InceptionV3()
    with torch.no_grad():
        for name, buf in net.named_buffers():
            buf.copy_(torch.rand_like(buf) + 0.5 if name.endswith("var")
                      else 0.1 * torch.randn_like(buf))
    x = torch.rand((4, 64, 64, 3), generator=torch.Generator().manual_seed(9))
    with torch.no_grad():
        want = net.double()(x.double())
        got = net.float().to(cuda)(x.to(cuda))
    assert got.shape == (4, 2048)
    assert _rel_err(got, want) <= FEATURE_NET_REL


# -- precision: bf16 -------------------------------------------------------------------


def _masked_tiles(mask):
    """Row 1 of the (B, Tk) mask sees keys 64-69 and Tk-3.. only: whole
    32-key tiles masked before, between and after its visible keys."""
    mask = mask.clone()
    mask[1] = False
    mask[1, 64:70] = True
    mask[1, -3:] = True
    return mask


@pytest.mark.parametrize("b,h,tq,tk,dh,masked,variant", [
    (24, 2, 45, 45, 32, True, "tc_bf16"),     # the flagship text encoder
    (32, 2, 246, 246, 32, True, "tc_bf16"),   # CUB's captions
    (640, 2, 246, 1, 8, False, "tc_bf16"),    # CUB's DReG decoder: one key
    (3, 2, 40, 300, 64, True, "tc_bf16"),     # Dh 64, Tk past the resident path's 256
    (3, 2, 40, 300, 68, True, "chunked"),     # Dh % 8 != 0, past 256 keys
    (2, 3, 9, 11, 6, True, "resident"),       # Dh 6: element staging
    (64, 2, 100, 100, 16, True, "tc_bf16"),   # VILANRO's action encoder, Dh 16
    (3, 2, 40, 100, 8, True, "tc_bf16"),      # Dh 8; Tk not a multiple of the key tile
    (3, 2, 70, 130, 64, False, "tc_bf16"),    # no mask
    (4, 2, 30, 200, 32, "tiles", "tc_bf16"),  # whole key tiles masked
    (64, 2, 8, 8, 32, False, "short_bf16"),   # Tq and Tk under the crossover (SPRITES' T axis)
    (64, 2, 8, 16, 32, True, "tc_bf16"),      # Tk at the crossover
], ids=["flagship", "cub-encoder", "cub-decoder", "tc-dh64", "chunked", "dh6", "vilanro",
        "tc-dh8", "tc-unmasked", "masked-tiles", "under-crossover", "at-crossover"])
def test_bf16_attention_launcher_equals_the_fp32_kernel_on_widened_inputs(
        cuda, b, h, tq, tk, dh, masked, variant):
    """The bf16 launcher takes the named variant (the tensor-core kernel
    where Tq or Tk is 16 or more, Dh % 8 == 0 and Dh <= 64, the short
    kernel where both are under 16, else the kernels on widened inputs)
    and gives an fp32 output within the
    tolerance the fp32 kernel meets against its plain version, of the fp32
    kernel on the widened inputs and of the plain version, the uniform
    average of V for the batch element with every key masked, and the same
    bits on a second launch."""
    q, k, v, mask = _qkv(40, b, h, tq, tk, dh, bool(masked), cuda)
    if masked == "tiles":
        mask = _masked_tiles(mask)
    q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
    telemetry.reset()
    got = tattn._launch(q, k, v, mask)
    assert telemetry.dtypes() == {f"attention:{variant}:bfloat16": 1}
    again = tattn._launch(q, k, v, mask)
    want = tattn._launch(q.float(), k.float(), v.float(), mask)
    plain = tattn.attention_reference(q, k, v, mask)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and torch.equal(got, again)
    torch.testing.assert_close(got, want, **ATTN_TOL)
    torch.testing.assert_close(got, plain, **ATTN_TOL)
    if masked:
        uniform = v[0].float().mean(-2, keepdim=True).expand(h, tq, dh)
        torch.testing.assert_close(got[0], uniform, **ATTN_TOL)
    # and through the Function: fp32 out, bf16 gradients, launched once
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = tattn.masked_attention(*leaves, mask)
    out.sum().backward()
    assert out.dtype == torch.float32 and all(x.grad.dtype == torch.bfloat16 for x in leaves)


def test_bf16_attention_crossover_yardsticks_agree(cuda):
    """The two yardsticks of the crossover, which the port never calls: the
    tensor-core kernel under it and the widening path over it, each within
    the tolerance of the launcher's result at the same inputs."""
    import ctypes
    from multimodal_vae_comparison_tpu_torch.ops.kernels import _build
    args = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
    for tq, tk, symbol in ((8, 8, "masked_attention_forward_bf16_tc"),
                           (45, 246, "masked_attention_forward_bf16_widened")):
        q, k, v, mask = _qkv(43, 8, 2, tq, tk, 32, True, cuda)
        q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
        fn = _build.function("attention", symbol, args)
        out = torch.empty(q.shape, dtype=torch.float32, device=cuda)
        _build.check("attention", fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                     mask.data_ptr(), out.data_ptr(), 8, 2, tq, tk, 32,
                                     32 ** -0.5, torch.cuda.current_stream().cuda_stream))
        torch.testing.assert_close(out, tattn._launch(q, k, v, mask), **ATTN_TOL)


@pytest.mark.parametrize("shape,block,stride,variants", [
    ((8, 2, 512, 32), 128, 4, ("tc_bf16",) * 3),   # the video model's
    ((2, 2, 64, 64), 32, 2, ("tc_bf16",) * 3),     # Dh 64
    ((2, 2, 96, 6), 16, 2, ("fma", "fma", "fma")),  # Dh 6: the FMA kernels
    ((2, 2, 96, 16), 16, 2, ("tc_bf16",) * 3),     # a block of 16
    ((2, 2, 256, 8), 64, 1, ("tc_bf16",) * 3),     # Dh 8: padded to 16
    ((2, 2, 320, 32), 80, 2, ("tc_bf16",) * 3),    # a block not a multiple of 32
    ((1, 2, 160, 12), 16, 3, ("mma", "mma", "mma")),  # Dh % 8 != 0: widened 3xTF32
], ids=["mma", "mma-dh64", "fma", "block16", "dh8", "block80", "dh12"])
def test_bf16_sparse_launchers_equal_the_fp32_kernels_on_widened_inputs(cuda, shape, block,
                                                                       stride, variants):
    """The forward, dq and dk/dv bf16 instances against the fp32 kernels on
    the widened inputs, each taking the named variant (forward, dq, dk/dv):
    fp32 out and lse within the forward tolerance of the fp32 kernel and of
    the plain version; dq/dk/dv in bf16 within the backward tolerance of
    the fp32 kernels' unrounded results plus the one rounding to bf16
    (2^-8 of each value), and, where the launcher widens, equal to them
    rounded once; the same bits on a second launch of each."""
    g = torch.Generator(device="cuda").manual_seed(41)
    q, k, v = (torch.randn(shape, generator=g, device="cuda").bfloat16() for _ in range(3))
    wide = [x.float() for x in (q, k, v)]
    telemetry.reset()
    out, lse = tsparse._launch_forward(q, k, v, block, stride)
    out2, lse2 = tsparse._launch_forward(q, k, v, block, stride)
    d_out = torch.randn(shape, generator=g, device="cuda")
    out32, lse32 = tsparse._launch_forward(*wide, block, stride)
    delta = (d_out * out32).sum(-1)
    args = (d_out, lse32, delta, block, stride)
    dq, (dk, dv) = tsparse._launch_dq(q, k, v, *args), tsparse._launch_dkv(q, k, v, *args)
    bf16_kinds = {x: n for x, n in telemetry.dtypes().items() if x.endswith(":bfloat16")}
    dq2, (dk2, dv2) = tsparse._launch_dq(q, k, v, *args), tsparse._launch_dkv(q, k, v, *args)
    dq32, (dk32, dv32) = tsparse._launch_dq(*wide, *args), tsparse._launch_dkv(*wide, *args)
    torch.cuda.synchronize()
    fwd, dq_v, dkv_v = variants
    assert bf16_kinds == {f"sparse_attention:{fwd}:bfloat16": 2,
                          f"sparse_attention_dq:{dq_v}:bfloat16": 1,
                          f"sparse_attention_dkv:{dkv_v}:bfloat16": 1}
    assert out.dtype == lse.dtype == torch.float32
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    torch.testing.assert_close(out, out32, **SPARSE_TOL)
    torch.testing.assert_close(lse, lse32, **SPARSE_TOL)
    torch.testing.assert_close(out, tsparse.sparse_attention_reference(q, k, v, block, stride),
                               **SPARSE_TOL)
    rounded_tol = dict(rtol=SPARSE_BWD_TOL["rtol"] + 2.0 ** -8, atol=SPARSE_BWD_TOL["atol"])
    for got, again, want, variant in ((dq, dq2, dq32, dq_v), (dk, dk2, dk32, dkv_v),
                                      (dv, dv2, dv32, dkv_v)):
        assert got.dtype == torch.bfloat16 and torch.equal(got, again)
        torch.testing.assert_close(got.float(), want, **rounded_tol)
        if variant != "tc_bf16":
            assert torch.equal(got, want.bfloat16())


@pytest.mark.parametrize("shape,block,stride", [((8, 2, 512, 32), 128, 4),
                                                ((2, 2, 64, 64), 32, 2),
                                                ((2, 2, 320, 32), 80, 2)],
                         ids=["video", "dh64", "block80"])
def test_bf16_sparse_widened_yardsticks_equal_the_fp32_kernels_rounded_once(cuda, shape, block,
                                                                           stride):
    """sparse_attention_dq_bf16_widened and _dkv_bf16_widened, the yardsticks
    of the bf16 tensor-core dq and dk/dv that the port never calls: the
    3xTF32 kernels on widened inputs, their bf16 results bit for bit the
    fp32 kernels' rounded once, at shapes the tensor-core kernels take."""
    from multimodal_vae_comparison_tpu_torch.ops.kernels import _build
    g = torch.Generator(device="cuda").manual_seed(44)
    q, k, v = (torch.randn(shape, generator=g, device="cuda").bfloat16() for _ in range(3))
    wide = [x.float() for x in (q, k, v)]
    d_out = torch.randn(shape, generator=g, device="cuda")
    out32, lse32 = tsparse._launch_forward(*wide, block, stride)
    delta = (d_out * out32).sum(-1)
    args = (d_out, lse32, delta, block, stride)
    dq32, (dk32, dv32) = tsparse._launch_dq(*wide, *args), tsparse._launch_dkv(*wide, *args)
    dq_fn = _build.function("sparse_attention", "sparse_attention_dq_bf16_widened",
                            tsparse._DQ_ARGTYPES[:-1])
    dkv_fn = _build.function("sparse_attention", "sparse_attention_dkv_bf16_widened",
                             tsparse._DKV_ARGTYPES[:-1])
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    rows = [x.data_ptr() for x in (q, k, v, d_out, lse32, delta)]
    shape_args = tsparse._shape_args(q, block, stride)
    _build.check("sparse_attention", dq_fn(*rows, dq.data_ptr(), *shape_args))
    _build.check("sparse_attention", dkv_fn(*rows, dk.data_ptr(), dv.data_ptr(), *shape_args))
    torch.cuda.synchronize()
    for got, want in ((dq, dq32), (dk, dk32), (dv, dv32)):
        assert torch.equal(got, want.bfloat16())


def _bf16_specs():
    return (ModalitySpec("mod_1", "CNN2", "CNN", (32, 32, 3), recon_loss="bce"),
            ModalitySpec("mod_2", "TxtTransformer", "TxtTransformer", (12, 27),
                         mod_type="text", recon_loss="category_ce", has_masks=True))


def _bf16_batch(dev, n=4):
    rng = np.random.default_rng(42)
    txt = np.eye(27, dtype=np.float32)[rng.integers(0, 27, (n, 12))]
    mask = np.arange(12)[None, :] < rng.integers(1, 13, (n, 1))
    return {"mod_1": {"data": torch.from_numpy(rng.random((n, 32, 32, 3), dtype=np.float32))
                      .to(dev), "masks": None},
            "mod_2": {"data": torch.from_numpy(txt).to(dev),
                      "masks": torch.from_numpy(mask).to(dev)}}


@pytest.mark.parametrize("mixing", ["poe", "moe"])
def test_bf16_step_on_the_card_matches_the_cpu_within_the_bf16_yardstick(cuda, mixing):
    """A bf16 objective and its gradients on the card (kernels on bf16
    inputs) against the port's CPU in bf16, same weights, batch and eps:
    within 3 x |CPU bf16 - CPU fp32| + 2^-8 of each leaf's max |g| (the
    yardstick of tests/test_torch_bf16.py, the CPU's fp32 as reference)."""
    eps_rng = np.random.default_rng(43)
    draws = [torch.from_numpy(eps_rng.standard_normal((1, 4, 8)).astype(np.float32))
             for _ in range(3 if mixing == "poe" else 2)]
    res = {}
    for key, dev, dt in (("card", "cuda", torch.bfloat16), ("bf16", "cpu", torch.bfloat16),
                         ("fp32", "cpu", torch.float32)):
        model = build_model(_bf16_specs(), mixing, 8, device=dev, dtype=dt)
        eps = [d.to(dev) for d in draws]
        eps = eps if mixing == "poe" else dict(zip(("mod_1", "mod_2"), eps))
        telemetry.reset()
        loss, _ = model.objective(_bf16_batch(dev), eps=eps)
        loss.backward()
        if dev == "cuda":
            assert not any(k.endswith(":plain") for k in telemetry.summary())
            assert any(x.endswith(":bfloat16") for x in telemetry.dtypes())
        res[key] = (loss.item(), {n: (torch.zeros_like(p) if p.grad is None else p.grad).cpu()
                                  for n, p in model.named_parameters()})
    (cl, cg), (bl, bg), (fl, fg) = res["card"], res["bf16"], res["fp32"]
    assert abs(cl - bl) <= 3 * abs(bl - fl) + 2 ** -8 * abs(fl)
    for n in bg:
        s = bg[n[:-4] + "weight" if n.endswith("key.bias") else n].abs().max().item() or 1.0
        err, gap = (cg[n] - bg[n]).abs().max().item() / s, (bg[n] - fg[n]).abs().max().item() / s
        assert torch.isfinite(cg[n]).all() and err <= 3 * gap + 2 ** -8, (n, err, gap)


def test_step_flops_reads_the_same_on_the_card_and_the_cpu(cuda):
    """ops.flops.step_flops of the POE and MOE train steps and of a
    VideoGPTSparse step: the CUDA kernels report their functions' FLOPs, so
    the card (kernels) and the CPU (plain versions) read one integer, in
    fp32 and in bf16."""
    from multimodal_vae_comparison_tpu_torch.ops.flops import step_flops
    video = (ModalitySpec("mod_1", "VideoGPTSparse", "VideoGPTSparse", (2, 32, 32, 3),
                          mod_type="frames", recon_loss="bce"),
             ModalitySpec("mod_2", "FNN", "FNN", (9,), mod_type="actions", recon_loss="bce"))
    rng = np.random.default_rng(44)
    vbatch = {"mod_1": rng.random((2, 2, 32, 32, 3), dtype=np.float32),
              "mod_2": rng.random((2, 9), dtype=np.float32)}
    for specs, mixing, kw, batch_of in (
            (_bf16_specs(), "poe", {}, _bf16_batch),
            (_bf16_specs(), "moe", {}, _bf16_batch),
            (video, "moe", dict(obj="dreg", K=2, remat=True),
             lambda dev: {n: {"data": torch.from_numpy(x).to(dev), "masks": None}
                          for n, x in vbatch.items()})):
        counts = {}
        for dev in ("cuda", "cpu"):
            for dt in (torch.float32, torch.bfloat16):
                model = build_model(specs, mixing, 8, device=dev, dtype=dt, **kw)
                step = make_train_step(model, make_optimizer("adam", 1e-3, model.parameters()))
                counts[(dev, dt)] = step_flops(step, batch_of(dev), generator=torch.Generator(
                    device=dev).manual_seed(0))["flops"]
        assert len(set(counts.values())) == 1, (mixing, counts)


def test_two_gloo_ranks_on_the_card_sum_to_the_one_process_step(cuda):
    """The flagship POE step at bs 24 on two gloo ranks of the one card (NCCL
    refuses two ranks on a device), each on its 12 rows: the summed gradient
    and the global metrics within the training limit of the one-process
    step, and each rank launching the attention and PoE kernels, forward and
    backward, with no plain version."""
    from multimodal_vae_comparison_tpu_torch.parallel.dryrun import (
        StepJob, flagship_specs, run_steps)
    from multimodal_vae_comparison_tpu_torch.parallel.launch import launch
    rng = np.random.default_rng(0)
    b, t = 24, 45
    txt = np.eye(27, dtype=np.float32)[rng.integers(0, 27, (b, t))]
    batch = {"mod_1": {"data": rng.random((b, 64, 64, 3), dtype=np.float32), "masks": None},
             "mod_2": {"data": txt, "masks": np.arange(t)[None] < rng.integers(1, t + 1, (b, 1))}}
    eps = [rng.standard_normal((1, b, 16)).astype(np.float32) for _ in range(3)]
    job = StepJob(flagship_specs(t), batch, n_latents=16, eps=eps)
    ranks = launch(run_steps, 2, [job], device="cuda", backend="gloo", deadline=300)
    model = build_model(flagship_specs(t), "poe", 16, seed=0, device="cuda")
    step = make_train_step(model, make_optimizer("adam", 1e-3, model.parameters()))
    metrics = step({n: {k: None if v is None else torch.from_numpy(v).to(cuda)
                        for k, v in m.items()} for n, m in batch.items()},
                   eps=[torch.from_numpy(e).to(cuda) for e in eps])
    for r, (_, (got,)) in enumerate(ranks):
        assert got["rows"] == 12, r
        assert got["launches"] == {"attention": 2, "poe": 1, "poe_bwd": 1}, r
        assert not any(k.endswith(":plain") for k in got["paths"]), got["paths"]
        for k, v in metrics.items():
            np.testing.assert_allclose(got["metrics"][k], v.item(), rtol=1e-5, atol=1e-4,
                                       err_msg=k)
        for name, p in model.named_parameters():
            g = p.grad.cpu().numpy()
            err = np.abs(got["grads"][name] - g).max()
            assert err <= 1e-4 * np.abs(g).max() + 1e-5, f"{name}: {err:.3e}"


# -- the few-keys and short bf16 attention kernels --------------------------------------


def _off_by_one(x):
    """``x`` in contiguous storage that starts one element past a 16-byte line."""
    flat = torch.empty(x.numel() + 1, device=x.device, dtype=x.dtype)
    flat[1:] = x.reshape(-1)
    return flat[1:].view(x.shape)


def _launched(q, k, v, mask, variant):
    """The launcher's output at (q, k, v, mask): it took ``variant`` once,
    and a second launch gives the same bits (NaN included)."""
    telemetry.reset()
    got = tattn._launch(q, k, v, mask)
    assert telemetry.dtypes() == {f"attention:{variant}:{str(q.dtype)[6:]}": 1}
    again = tattn._launch(q, k, v, mask)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    return got


@pytest.mark.parametrize("b,h,tq,tk,dh,masked", [
    (448, 4, 100, 5, 32, True),    # Dec_TransformerCond, a cond_always lattice's decode
    (64, 4, 100, 5, 32, True),     # Dec_TransformerCond per subset, with the instruction
    (64, 4, 100, 1, 32, False),    # and the z token alone
    (640, 2, 246, 1, 8, False),    # CUB's DReG text decoder
    (448, 2, 100, 1, 16, False),   # VILANRO's action decoder
    (448, 2, 4, 1, 16, False),     # VILANRO's language decoder
    (112, 4, 8, 1, 64, False),     # Dec_TransformerIMG
    (24, 2, 45, 1, 8, False),      # the flagship text decoder at bs 24
    (256, 2, 45, 1, 8, False)],    # and at the serving batch
    ids=["cond-lattice", "cond-subset", "cond-z-only", "cub-decoder", "vilanro-action",
         "vilanro-language", "transformer-img-dec", "flagship-24", "flagship-256"])
def test_few_keys_kernel_at_the_decoders_shapes_matches_plain(cuda, b, h, tq, tk, dh, masked):
    """The fp32 launcher gives every head of at most 8 keys under more query
    rows to the few-keys kernel, within the kernel tolerance of the plain
    version, the same bits twice, and the uniform average of V for the
    batch element whose keys are all masked."""
    q, k, v, mask = _qkv(50, b, h, tq, tk, dh, masked, cuda)
    got = _launched(q, k, v, mask, "few_keys")
    torch.testing.assert_close(got, tattn.attention_reference(q, k, v, mask), **ATTN_TOL)
    if masked:
        uniform = v[0].mean(dim=1, keepdim=True).expand_as(got[0])
        torch.testing.assert_close(got[0], uniform, **ATTN_TOL)


@pytest.mark.parametrize("b", [61440, 4096], ids=["sprites-mkb-240", "sprites-bs-16"])
def test_short_bf16_kernel_at_the_sprites_t_axis_matches_plain(cuda, b):
    """SPRITES' (B, 2, 8, 8, 32) T-axis heads on bf16 inputs take the short
    kernel: within the kernel tolerance of the plain version and of the fp32
    kernel on the widened inputs, the same bits twice."""
    q, k, v, _ = _qkv(51, b, 2, 8, 8, 32, False, cuda)
    q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
    got = _launched(q, k, v, None, "short_bf16")
    torch.testing.assert_close(got, tattn.attention_reference(q, k, v), **ATTN_TOL)
    torch.testing.assert_close(got, tattn._launch(q.float(), k.float(), v.float(), None),
                               **ATTN_TOL)


@pytest.mark.parametrize("b,h,tq,tk,dh,dtype,unaligned,variant", [
    (5, 2, 9, 8, 32, torch.float32, False, "few_keys"),      # the largest Tk, Tq just over it
    (5, 2, 8, 9, 32, torch.float32, False, "resident"),      # Tk over the few-keys kernel's 8
    (5, 2, 8, 8, 32, torch.float32, False, "resident"),      # Tq = Tk: SPRITES' fp32 heads
    (3, 2, 20, 3, 6, torch.float32, False, "few_keys"),      # Dh % 4 != 0: loads by element
    (3, 2, 20, 3, 12, torch.bfloat16, False, "few_keys"),    # bf16, Dh % 8 != 0, Tq >= 16
    (5, 2, 33, 4, 16, torch.float32, True, "few_keys"),      # inputs off a 16-byte line
    (5, 2, 12, 3, 32, torch.bfloat16, True, "few_keys"),     # bf16 off a 16-byte line
    (6, 2, 8, 8, 32, torch.bfloat16, True, "resident"),      # and Tq = Tk: widened
    (6, 4, 40, 3, 64, torch.float32, False, "few_keys"),     # Dh 64: 2 lanes a row
    (3, 2, 20, 2, 128, torch.float32, False, "few_keys"),    # Dh 128: 4 lanes a row
    (3, 2, 20, 2, 80, torch.float32, False, "few_keys"),     # Dh 80: the 4th lane holds none
    (3, 2, 333, 1, 8, torch.float32, False, "few_keys"),     # rows not a multiple of a block's
    (70, 3, 2, 1, 16, torch.float32, False, "few_keys"),     # 64 heads in a block
    (10, 2, 12, 9, 64, torch.bfloat16, False, "short_bf16"),  # Dh 64, 16 lanes a row
    (9, 2, 7, 5, 16, torch.bfloat16, False, "short_bf16"),   # a partial pass; 18 heads
    (7, 2, 15, 15, 8, torch.bfloat16, False, "short_bf16"),  # both sides at 15, Dh 8
], ids=["tk8", "tk9", "fp32-8x8", "dh6", "bf16-dh12", "unaligned", "bf16-unaligned",
        "bf16-unaligned-8x8", "dh64", "dh128", "dh80", "ragged-rows", "packed-heads",
        "short-dh64", "short-partial", "short-15x15"])
@pytest.mark.parametrize("masked", [True, False], ids=["masked", "unmasked"])
def test_few_keys_and_short_kernels_at_their_edges(cuda, b, h, tq, tk, dh, dtype, unaligned,
                                                   variant, masked):
    """The two kernels' routes and edges: the variant the launcher takes on
    each side of the crossovers, within the kernel tolerance of the plain
    version, the same bits twice, and the uniform average of V for the batch
    element with every key masked."""
    q, k, v, mask = _qkv(52, b, h, tq, tk, dh, masked, cuda)
    q, k, v = (x.to(dtype) for x in (q, k, v))
    if unaligned:
        q, k, v = (_off_by_one(x) for x in (q, k, v))
        assert q.data_ptr() % 16 != 0 and q.is_contiguous()
    got = _launched(q, k, v, mask, variant)
    torch.testing.assert_close(got, tattn.attention_reference(q, k, v, mask), **ATTN_TOL)
    if masked:
        uniform = v[0].float().mean(dim=1, keepdim=True).expand_as(got[0])
        torch.testing.assert_close(got[0], uniform, **ATTN_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_few_keys_kernel_gives_v_at_one_key(cuda, dtype):
    """At one key the softmax is 1 whether the key is visible or masked, so
    the output is exactly v, row for row (bf16 v widened exactly)."""
    q, k, v, mask = _qkv(53, 6, 2, 9, 1, 12, True, cuda)
    mask[1:3] = True
    q, k, v = (x.to(dtype) for x in (q, k, v))
    got = _launched(q, k, v, mask, "few_keys")
    assert torch.equal(got, v.float().expand_as(got))


def test_few_keys_kernel_gives_nan_where_q_is_nan(cuda):
    """Every score is computed from q: a NaN in a query row makes that row
    NaN, as the plain version does, and leaves every other row finite."""
    q, k, v, _ = _qkv(54, 4, 2, 30, 5, 32, False, cuda)
    q[1, 0, 3, 7] = float("nan")
    got = _launched(q, k, v, None, "few_keys")
    want = tattn.attention_reference(q, k, v)
    assert torch.isnan(got[1, 0, 3]).all() and torch.isnan(want[1, 0, 3]).all()
    got[1, 0, 3] = want[1, 0, 3] = 0.0
    torch.testing.assert_close(got, want, **ATTN_TOL)


def test_route_yardsticks_agree(cuda):
    """The yardsticks of the two new routes, which the port never calls: the
    resident route on fp32 at a few-keys shape, the few-keys kernel at a
    Tq = Tk shape the launcher keeps resident, and the widening route on
    bf16 at a short shape, each within the tolerance of the launcher."""
    import ctypes
    from multimodal_vae_comparison_tpu_torch.ops.kernels import _build
    args = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
    for tq, tk, dtype, symbol in (
            (45, 1, torch.float32, "masked_attention_forward_resident"),
            (8, 8, torch.float32, "masked_attention_forward_few_keys"),
            (8, 8, torch.bfloat16, "masked_attention_forward_bf16_widened")):
        q, k, v, mask = _qkv(55, 8, 2, tq, tk, 32, True, cuda)
        q, k, v = (x.to(dtype) for x in (q, k, v))
        fn = _build.function("attention", symbol, args)
        out = torch.empty(q.shape, dtype=torch.float32, device=cuda)
        _build.check("attention", fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                     mask.data_ptr(), out.data_ptr(), 8, 2, tq, tk, 32,
                                     32 ** -0.5, torch.cuda.current_stream().cuda_stream))
        torch.testing.assert_close(out, tattn._launch(q, k, v, mask), **ATTN_TOL)
