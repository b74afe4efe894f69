"""The port's lattice PoE and multi-posterior KL against the JAX package.

``poe_lattice`` fuses every subset of a lattice in one call and gives each
expert's gradient summed over the subsets that hold it; the JAX package
calls its ``poe_fused`` once per subset and lets autograd add the
gradients.  ``kl_normal_std_multi`` gives the KL of M posteriors at once
where the JAX package calls ``kl_normal_std_fused`` once per modality.  On
inputs made with numpy from a seed, the port's plain versions (what a CPU
tensor takes) are held against the JAX functions run as the JAX package's
own tests run them on the CPU: the Pallas kernels in interpret mode, under
``jax.vjp`` for the gradients.  The CUDA kernels themselves are held against
the plain versions by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.

Tolerance: 1e-6 relative, as rtol 1e-6 plus an atol of 1e-6 of the
tensor's largest magnitude (:func:`_close`).  The two sides round in other
places (JAX's kernel starts its precision sum at the prior and multiplies
by the reciprocal; its autograd adds a gradient's subset terms in its own
order), and where a subset's weighted means cancel the difference is an ulp
of the terms, not of the result: on these inputs it stays within 4.1e-7 of
the largest magnitude.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_vae_comparison_tpu.ops.pallas import kl_kernel as jkl
from multimodal_vae_comparison_tpu.ops.pallas import poe_kernel as jpoe
from multimodal_vae_comparison_tpu_torch.ops import fusion as tfusion
from multimodal_vae_comparison_tpu_torch.ops.kernels import kl_kernel as tkl
from multimodal_vae_comparison_tpu_torch.ops.kernels import poe_kernel as tpoe
from multimodal_vae_comparison_tpu_torch.ops.kernels import telemetry



def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(jpoe, "_INTERPRET", True)
    monkeypatch.setattr(jkl, "_INTERPRET", True)


def _experts(seed, m, rows, d):
    rng = np.random.default_rng(seed)
    mus = rng.normal(size=(m, rows, d)).astype(np.float32)
    scales = rng.uniform(0.3, 2.0, (m, rows, d)).astype(np.float32)
    return mus, scales, rng


def _jax_lattice(mus, scales, lattice, prior):
    """JAX ``poe_fused`` once per subset, stacked: (S, rows, D) mu and scale."""
    fused = [jpoe.poe_fused(mus[np.asarray(s)], scales[np.asarray(s)], prior) for s in lattice]
    return jnp.stack([f[0] for f in fused]), jnp.stack([f[1] for f in fused])


LATTICE_CASES = [(m, prior, rows) for m in (2, 3, 5) for prior in (1.0, 0.0)
                 for rows in (24, 256)]


@pytest.mark.parametrize("m,prior,rows", LATTICE_CASES)
def test_poe_lattice_matches_jax_per_subset(m, prior, rows):
    """Forward: row s of the port's (S, B, D) outputs is the JAX package's
    poe_fused of subset s's experts (M 5 is PolyMNIST's lattice of 31)."""
    mus, scales, _ = _experts(20 + m, m, rows, 16)
    lattice = tfusion.subset_lattice(m)
    assert len(lattice) == 2 ** m - 1
    want = jax.jit(lambda a, b: _jax_lattice(a, b, lattice, prior))(
        jnp.asarray(mus), jnp.asarray(scales))
    got = tfusion.poe_lattice(torch.from_numpy(mus), torch.from_numpy(scales), lattice, prior)
    for g, w in zip(got, want):
        assert g.shape == (len(lattice), rows, 16)
        _close(g.numpy(), w)


@pytest.mark.parametrize("m,prior,rows", LATTICE_CASES)
def test_poe_lattice_gradients_match_jax_vjp(m, prior, rows):
    """Backward: each expert's gradient, summed over the subsets that hold
    it, against jax.vjp of the per-subset outputs under random cotangents."""
    mus, scales, rng = _experts(40 + m, m, rows, 16)
    lattice = tfusion.subset_lattice(m)
    cot = [rng.normal(size=(len(lattice), rows, 16)).astype(np.float32) for _ in range(2)]
    _, vjp = jax.vjp(lambda a, b: _jax_lattice(a, b, lattice, prior),
                     jnp.asarray(mus), jnp.asarray(scales))
    want = jax.jit(vjp)(tuple(jnp.asarray(c) for c in cot))
    mt = [torch.from_numpy(x).requires_grad_() for x in mus]
    st = [torch.from_numpy(x).requires_grad_() for x in scales]
    out = tfusion.poe_lattice(mt, st, lattice, prior)
    torch.autograd.backward(out, [torch.from_numpy(c) for c in cot])
    for got, w in ((torch.stack([t.grad for t in mt]), want[0]),
                   (torch.stack([t.grad for t in st]), want[1])):
        _close(got.numpy(), w)


@pytest.mark.parametrize("m", [2, 3])
def test_poe_lattice_closed_form_backward_equals_autograd_of_the_plain_version(m):
    """The plain backward (the closed form summed in lattice order) against
    autograd through poe_lattice_reference, in float64, on a lattice that
    leaves one expert out of every subset and repeats one subset."""
    rng = np.random.default_rng(60 + m)
    mus = [torch.from_numpy(rng.normal(size=(5, 4))) for _ in range(m + 1)]
    scales = [torch.from_numpy(rng.uniform(0.3, 2.0, (5, 4))) for _ in range(m + 1)]
    lattice = tfusion.subset_lattice(m) + [(0, 1)]
    cot = [torch.from_numpy(rng.normal(size=(len(lattice), 5, 4))) for _ in range(2)]
    leaves = [t.clone().requires_grad_() for t in mus + scales]
    want = torch.autograd.grad(
        tpoe.poe_lattice_reference(leaves[:m + 1], leaves[m + 1:], lattice, 1.0), leaves, cot,
        allow_unused=True, materialize_grads=True)
    mu, scale = tpoe.poe_lattice_reference(mus, scales, lattice, 1.0)
    d_mus, d_scales = tpoe.poe_lattice_backward_reference(mus, scales, mu, scale, *cot,
                                                          lattice)
    for g, w in zip(d_mus + d_scales, want):
        torch.testing.assert_close(g, w, rtol=1e-12, atol=1e-12)
    assert not d_mus[m].any() and not d_scales[m].any()


def test_poe_lattice_without_the_prior_leaves_the_prior_out():
    """p0 = 0 (MoPoE, DMVAE): a singleton subset gives back its expert to
    an ulp, with scale sqrt(scale^2 + EPS); with p0 = 1 it does not."""
    mus, scales, _ = _experts(70, 3, 24, 16)
    args = (torch.from_numpy(mus), torch.from_numpy(scales), [(0,), (2,)])
    mu, scale = tfusion.poe_lattice(*args, 0.0)
    with_prior = tfusion.poe_lattice(*args, 1.0)
    for row, e in enumerate((0, 2)):
        np.testing.assert_allclose(mu[row].numpy(), mus[e], rtol=2 ** -22, atol=0)
        np.testing.assert_allclose(scale[row].numpy(),
                                   np.sqrt(np.square(scales[e]) + np.float32(1e-8)),
                                   rtol=2 ** -22, atol=0)
        assert (with_prior[1][row] < scale[row]).all()
        for a, b in zip((mu[row], scale[row]), tpoe.poe_fused(*(x[e:e + 1] for x in args[:2]),
                                                              0.0)):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_poe_fused_is_the_one_subset_case_of_poe_lattice():
    mus, scales, _ = _experts(71, 3, 7, 5)
    one = tpoe.poe_fused(torch.from_numpy(mus), torch.from_numpy(scales), 1.0)
    lat = tpoe.poe_lattice(torch.from_numpy(mus), torch.from_numpy(scales), [(0, 1, 2)], 1.0)
    for a, b in zip(one, lat):
        assert a.shape == (7, 5)
        torch.testing.assert_close(a, b[0], rtol=0, atol=0)


@pytest.mark.parametrize("lattice,m,error", [
    ([()], 2, "non-empty"),
    ([(0, 2)], 2, "below 2"),
    ([(0, 0)], 2, "non-empty set"),
    ([(0,)] * 33, 2, "1 to 32 subsets"),
    ([(0,)], 9, "1 to 8 experts"),
])
def test_poe_lattice_refuses_what_the_kernels_do_not_take(lattice, m, error):
    mus = [torch.ones(2, 3)] * m
    with pytest.raises(ValueError, match=error):
        tpoe.poe_lattice(mus, mus, lattice)


def test_poe_lattice_refuses_unequal_lists_and_other_devices():
    x = torch.ones(2, 3)
    with pytest.raises(ValueError):
        tpoe.poe_lattice([x, x], [x], [(0,)])
    m = torch.empty(2, 3, device="meta")
    with pytest.raises(ValueError):
        tpoe.poe_lattice([m], [m], [(0,)])
    with pytest.raises(ValueError):
        tkl.kl_normal_std_multi([m], [m])
    with pytest.raises(ValueError):
        tkl.kl_normal_std_multi([x, x], [x])


def test_cpu_lattice_and_multi_kl_take_the_plain_versions_forward_and_backward():
    mus, scales, _ = _experts(72, 2, 4, 3)
    mt = [torch.from_numpy(x).requires_grad_() for x in mus]
    st = [torch.from_numpy(x).requires_grad_() for x in scales]
    telemetry.reset()
    mu, scale = tpoe.poe_lattice(mt, st, tfusion.subset_lattice(2))
    (mu.sum() + scale.sum() + tkl.kl_normal_std_multi(mt, st).sum()).backward()
    assert telemetry.summary() == {"poe:plain": 1, "poe_bwd:plain": 1,
                                   "kl:plain": 1, "kl_bwd:plain": 1}
    assert telemetry.launches() == {}


def test_lattice_and_multi_kl_pass_gradcheck_in_float64():
    rng = np.random.default_rng(73)
    mus = [torch.from_numpy(rng.normal(size=(3, 4))).requires_grad_() for _ in range(3)]
    scales = [torch.from_numpy(rng.uniform(0.3, 2.0, (3, 4))).requires_grad_()
              for _ in range(3)]
    lattice = tfusion.subset_lattice(3)
    for prior in (1.0, 0.0):
        assert torch.autograd.gradcheck(
            lambda *x: tpoe.poe_lattice(x[:3], x[3:], lattice, prior), (*mus, *scales))
    assert torch.autograd.gradcheck(lambda *x: tkl.kl_normal_std_multi(x[:3], x[3:]),
                                    (*mus, *scales))


KL_CASES = [(m, rows) for m in (1, 2, 3, 5) for rows in (24, 256)]


@pytest.mark.parametrize("m,rows", KL_CASES)
def test_kl_multi_matches_jax_per_modality(m, rows):
    """Forward: row m of the (M, B) output is the JAX package's
    kl_normal_std_fused of posterior m; backward against jax.vjp of the
    per-modality KLs under a random cotangent."""
    mus, scales, rng = _experts(80 + m, m, rows, 16)
    cot = rng.normal(size=(m, rows)).astype(np.float32)

    def per_modality(a, b):
        return jnp.stack([jkl.kl_normal_std_fused(a[k], b[k]) for k in range(m)])

    want, vjp = jax.vjp(per_modality, jnp.asarray(mus), jnp.asarray(scales))
    want_grads = vjp(jnp.asarray(cot))
    mt = [torch.from_numpy(x).requires_grad_() for x in mus]
    st = [torch.from_numpy(x).requires_grad_() for x in scales]
    got = tkl.kl_normal_std_multi(mt, st)
    assert got.shape == (m, rows)
    _close(got.detach().numpy(), want)
    got.backward(torch.from_numpy(cot))
    for g, w in ((torch.stack([t.grad for t in mt]), want_grads[0]),
                 (torch.stack([t.grad for t in st]), want_grads[1])):
        _close(g.numpy(), w)


def test_kl_fused_is_the_one_posterior_case_of_kl_multi():
    mus, scales, _ = _experts(90, 1, 6, 16)
    one = tkl.kl_normal_std_fused(torch.from_numpy(mus[0]), torch.from_numpy(scales[0]))
    multi = tkl.kl_normal_std_multi(torch.from_numpy(mus), torch.from_numpy(scales))
    assert one.shape == (6,) and multi.shape == (1, 6)
    torch.testing.assert_close(one, multi[0], rtol=0, atol=0)


@pytest.mark.parametrize("priors", [("normal", "gaussian"), ("normal", "Normal")])
def test_moe_kl_of_all_modalities_is_one_multi_call_equal_to_per_modality_kld(priors):
    """MOE's KL term: kld_std_all gives the (M, B) stack of kld_std over the
    modalities, the Gaussian ones under a Gaussian prior through one call of
    the multi form; a prior that kld_std does not send to the kernel (here
    "Normal", which it matches case-sensitively) keeps its own path."""
    from multimodal_vae_comparison_tpu_torch.models import get_mixing
    from multimodal_vae_comparison_tpu_torch.models.base import ModalitySpec
    from multimodal_vae_comparison_tpu_torch.models.distributions import Normal
    specs = tuple(ModalitySpec(n, "FNN", "FNN", (9,), mod_type="actions", prior=p)
                  for n, p in zip(("mod_1", "mod_2"), priors))
    model = get_mixing("moe")(specs, 16, seed=0, device="cpu")
    mus, scales, _ = _experts(91, 2, 4, 16)
    dists = {n: Normal(torch.from_numpy(mus[k]), torch.from_numpy(scales[k]))
             for k, n in enumerate(("mod_1", "mod_2"))}
    telemetry.reset()
    got = model.kld_std_all(dists)
    assert telemetry.summary() == {"kl:plain": 1}
    want = torch.stack([model.kld_std(s, dists[s.name]) for s in specs])
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    want_jax = [jkl.kl_normal_std_fused(jnp.asarray(mus[k]), jnp.asarray(scales[k]))
                for k in range(2)]
    _close(got.numpy(), np.stack(want_jax))
