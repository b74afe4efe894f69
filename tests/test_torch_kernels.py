"""The port's kernel modules against the JAX package's kernels.

Each plain PyTorch version (what a CPU tensor takes) is held against the
Pallas kernel in interpret mode and against the JAX package's plain jnp
functions, on inputs made with numpy from a seed; each autograd Function's
backward against ``jax.vjp`` of the JAX function and against
``torch.autograd.gradcheck`` in float64.  The CUDA kernels themselves are
held against the plain versions by ``tests/test_torch_cuda.py`` (marked
``cuda``) and by ``chip_smoke.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_vae_comparison_tpu.models.nets import (
    dot_product_attention, key_padding_bias)
from multimodal_vae_comparison_tpu.ops import fusion as jfusion
from multimodal_vae_comparison_tpu.ops.pallas import attention as jattn
from multimodal_vae_comparison_tpu.ops.pallas import kl_kernel as jkl
from multimodal_vae_comparison_tpu.ops.pallas import poe_kernel as jpoe
from multimodal_vae_comparison_tpu_torch.ops import fusion as tfusion
from multimodal_vae_comparison_tpu_torch.ops.kernels import attention as tattn
from multimodal_vae_comparison_tpu_torch.ops.kernels import kl_kernel as tkl
from multimodal_vae_comparison_tpu_torch.ops.kernels import poe_kernel as tpoe
from multimodal_vae_comparison_tpu_torch.ops.kernels import sparse_attention as tsparse
from multimodal_vae_comparison_tpu_torch.ops.kernels import telemetry
from test_torch_slice import one_torch_thread  # noqa: F401 (autouse)

ATTN_TOL = dict(rtol=2e-4, atol=2e-5)   # as tests/test_pallas.py
POE_TOL = dict(rtol=1e-5, atol=1e-6)    # elementwise fp32, one sum over E
KL_TOL = dict(rtol=1e-5, atol=1e-6)     # elementwise fp32, one sum over D
SPARSE_TOL = dict(rtol=2e-4, atol=2e-5)  # as tests/test_pallas.py, forward
SPARSE_BWD_TOL = dict(rtol=2e-3, atol=2e-4)  # as tests/test_pallas.py, backward


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(jpoe, "_INTERPRET", True)
    monkeypatch.setattr(jattn, "_INTERPRET", True)
    monkeypatch.setattr(jkl, "_INTERPRET", True)


def _experts(seed, shape):
    rng = np.random.default_rng(seed)
    mus = rng.normal(size=shape).astype(np.float32)
    scales = rng.uniform(0.3, 2.0, shape).astype(np.float32)
    return mus, scales


@pytest.mark.parametrize("shape", [(1, 8, 16), (2, 8, 16), (3, 8, 16),
                                   (2, 4, 3, 24), (3, 7, 5)])
@pytest.mark.parametrize("prior", [1.0, 0.0])
def test_poe_plain_matches_pallas_interpret(shape, prior):
    mus, scales = _experts(0, shape)
    want = jpoe.poe_fused(jnp.asarray(mus), jnp.asarray(scales), prior)
    want_jnp = jfusion.poe_precision_fusion(jnp.asarray(mus), jnp.asarray(scales), prior)
    got = tpoe.poe_fused(torch.from_numpy(mus), torch.from_numpy(scales), prior)
    for g, w, wj in zip(got, want, want_jnp):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **POE_TOL)
        np.testing.assert_allclose(g.numpy(), np.asarray(wj), **POE_TOL)


@pytest.mark.parametrize("include_prior", [True, False])
def test_product_of_experts_matches_jax(include_prior):
    mus, scales = _experts(1, (2, 5, 16))
    want = jfusion.product_of_experts(jnp.asarray(mus), jnp.asarray(scales),
                                      include_prior=include_prior)
    got = tfusion.product_of_experts(torch.from_numpy(mus), torch.from_numpy(scales),
                                     include_prior=include_prior)
    got_plain = tfusion.poe_precision_fusion(torch.from_numpy(mus), torch.from_numpy(scales),
                                             1.0 if include_prior else 0.0)
    for g, gp, w in zip(got, got_plain, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **POE_TOL)
        np.testing.assert_array_equal(g.numpy(), gp.numpy())


def test_subset_lattice_matches_jax():
    for m in (1, 2, 3, 4):
        assert tfusion.subset_lattice(m) == jfusion.subset_lattice(m)
    assert tfusion.subset_lattice(3, [(2, 0)]) == jfusion.subset_lattice(3, [(2, 0)])


def _qkv(seed, b, h, tq, tk, dh):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, h, tq, dh)).astype(np.float32)
    k = rng.normal(size=(b, h, tk, dh)).astype(np.float32)
    v = rng.normal(size=(b, h, tk, dh)).astype(np.float32)
    return q, k, v, rng


@pytest.mark.parametrize("b,h,tq,tk,dh,block", [
    (2, 2, 8, 8, 4, 8),
    (2, 2, 45, 45, 32, 128),   # encoder self-attention
    (2, 2, 45, 1, 8, 128),     # decoder cross-attention (Tk = 1, Dh = 8)
    (2, 2, 4, 130, 16, 128),   # Tk over one kv block
    (1, 2, 6, 30, 8, 8),
])
@pytest.mark.parametrize("masked", [True, False])
def test_attention_plain_matches_pallas_interpret(b, h, tq, tk, dh, block, masked):
    q, k, v, rng = _qkv(3, b, h, tq, tk, dh)
    mask = None
    if masked:
        mask = rng.random((b, tk)) > 0.3
        mask[:, 0] = True
    jmask = None if mask is None else jnp.asarray(mask)
    want = jattn.masked_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                        jmask, kv_block=block)
    want_xla = dot_product_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                     key_padding_bias(jmask))
    got = tattn.masked_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v),
                                 None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATTN_TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_xla), **ATTN_TOL)


@pytest.mark.parametrize("tk,block", [(10, 8), (130, 128)])
def test_attention_fully_masked_row_is_uniform(tk, block):
    """A row whose keys are all masked: the uniform average of V, as both
    the Pallas kernel (-1e30 bias) and the XLA path (-1e9 bias) give."""
    q, k, v, rng = _qkv(4, 2, 2, 5, tk, 8)
    mask = rng.random((2, tk)) > 0.5
    mask[0] = False
    mask[1, 0] = True
    got = tattn.masked_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), torch.from_numpy(mask)).numpy()
    want = jattn.masked_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                        jnp.asarray(mask), kv_block=block)
    want_xla = dot_product_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                     key_padding_bias(jnp.asarray(mask)))
    np.testing.assert_allclose(got, np.asarray(want), **ATTN_TOL)
    np.testing.assert_allclose(got, np.asarray(want_xla), **ATTN_TOL)
    uniform = np.broadcast_to(v[0].mean(axis=1, keepdims=True), got[0].shape)
    np.testing.assert_allclose(got[0], uniform, **ATTN_TOL)


@pytest.mark.parametrize("b,h,tq,tk,dh,block,mask_kind", [
    (2, 2, 5, 1, 8, 128, None),                 # one key: every row is v[0]
    (2, 2, 5, 1, 8, 128, "fully-masked-row"),   # ... even where it is masked
    (2, 2, 9, 33, 6, 8, "padded"),              # one key past a warp, Dh % 4 != 0
    (2, 2, 9, 33, 6, 128, None),
    (2, 1, 7, 200, 32, 128, "fully-masked-row"),  # seven keys per lane
    (1, 2, 3, 200, 5, 128, "padded"),
])
def test_attention_edge_shapes_match_pallas_interpret(b, h, tq, tk, dh, block, mask_kind):
    """The key counts and head widths at which the CUDA launcher changes its
    plan (Tk 1, one past 32, several keys per lane; Dh off the 16-byte
    grid), through the wrapper on the CPU against the Pallas kernel."""
    q, k, v, rng = _qkv(14, b, h, tq, tk, dh)
    mask = None
    if mask_kind is not None:
        mask = rng.random((b, tk)) > 0.4
        mask[:, 0] = True
        if mask_kind == "fully-masked-row":
            mask[0] = False
    jmask = None if mask is None else jnp.asarray(mask)
    want = jattn.masked_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                        jmask, kv_block=block)
    got = tattn.masked_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v),
                                 None if mask is None else torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), **ATTN_TOL)
    if mask_kind == "fully-masked-row":
        uniform = np.broadcast_to(v[0].mean(axis=1, keepdims=True), got[0].shape)
        np.testing.assert_allclose(got[0], uniform, **ATTN_TOL)


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    telemetry.reset()
    q, k, v, _ = _qkv(5, 1, 2, 3, 4, 8)
    tattn.masked_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    mus, scales = _experts(5, (2, 3, 4))
    tpoe.poe_fused(torch.from_numpy(mus), torch.from_numpy(scales))
    tkl.kl_normal_std_fused(torch.from_numpy(mus[0]), torch.from_numpy(scales[0]))
    assert telemetry.summary() == {"attention:plain": 1, "poe:plain": 1, "kl:plain": 1}
    assert telemetry.launches() == {} and telemetry.variants() == {}
    telemetry.count_variant("attention", "resident")
    assert telemetry.variants() == {"attention:resident": 1}
    telemetry.reset()
    assert telemetry.summary() == {} and telemetry.launches() == {}
    assert telemetry.variants() == {}


def test_wrappers_refuse_devices_other_than_cuda_and_cpu():
    q = torch.empty(1, 1, 2, 4, device="meta")
    with pytest.raises(ValueError):
        tattn.masked_attention(q, q, q)
    with pytest.raises(ValueError):
        tpoe.poe_fused(torch.empty(2, 3, device="meta"), torch.empty(2, 3, device="meta"))
    with pytest.raises(ValueError):
        tkl.kl_normal_std_fused(torch.empty(2, 3, device="meta"),
                                torch.empty(2, 3, device="meta"))


def test_plain_versions_have_gradients_on_cpu():
    """CPU tensors that require grad go through each autograd Function's
    plain forward and closed-form or recompute backward."""
    q, k, v, _ = _qkv(6, 1, 2, 3, 4, 8)
    qt = torch.from_numpy(q).requires_grad_()
    tattn.masked_attention(qt, torch.from_numpy(k), torch.from_numpy(v)).sum().backward()
    assert qt.grad is not None and torch.isfinite(qt.grad).all()


# -- the KL kernel's plain version --------------------------------------------


@pytest.mark.parametrize("shape", [(24, 16), (7, 5), (2, 3, 16), (1, 1)])
def test_kl_plain_matches_pallas_interpret(shape):
    mu, scale = _experts(7, shape)
    want = jkl.kl_normal_std_fused(jnp.asarray(mu), jnp.asarray(scale))
    want_jnp = jkl._kl_reference(jnp.asarray(mu), jnp.asarray(scale))
    got = tkl.kl_normal_std_fused(torch.from_numpy(mu), torch.from_numpy(scale))
    assert got.shape == shape[:-1]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **KL_TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_jnp), **KL_TOL)


def test_kl_backward_matches_jax_grad():
    mu, scale = _experts(8, (6, 16))
    g = np.random.default_rng(9).normal(size=(6,)).astype(np.float32)
    want = jax.grad(lambda m, s: (jkl.kl_normal_std_fused(m, s) * g).sum(), argnums=(0, 1))(
        jnp.asarray(mu), jnp.asarray(scale))
    mt, st = (torch.from_numpy(x).requires_grad_() for x in (mu, scale))
    (tkl.kl_normal_std_fused(mt, st) * torch.from_numpy(g)).sum().backward()
    for got, w in zip((mt.grad, st.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), **KL_TOL)


# -- backwards of the attention and PoE Functions ---------------------------------


@pytest.mark.parametrize("b,h,tq,tk,dh,mask_kind", [
    (2, 2, 9, 9, 8, "fully-masked-row"),   # encoder self-attention
    (3, 2, 9, 1, 8, None),                 # decoder cross-attention (Tk = 1)
    (2, 1, 5, 12, 16, "padded"),
])
def test_attention_backward_matches_jax_vjp(b, h, tq, tk, dh, mask_kind):
    q, k, v, rng = _qkv(10, b, h, tq, tk, dh)
    d_out = rng.normal(size=q.shape).astype(np.float32)
    mask = None
    if mask_kind is not None:
        mask = rng.random((b, tk)) > 0.4
        mask[:, 0] = True
        if mask_kind == "fully-masked-row":
            mask[0] = False
    jmask = None if mask is None else jnp.asarray(mask)
    _, vjp = jax.vjp(lambda q_, k_, v_: jattn.masked_flash_attention(q_, k_, v_, jmask),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(d_out))
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = tattn.masked_attention(qt, kt, vt, None if mask is None else torch.from_numpy(mask))
    out.backward(torch.from_numpy(d_out))
    for got, w in zip((qt.grad, kt.grad, vt.grad), want):
        assert torch.isfinite(got).all()
        np.testing.assert_allclose(got.numpy(), np.asarray(w), **ATTN_TOL)


@pytest.mark.parametrize("shape", [(1, 4, 16), (2, 4, 16), (3, 2, 5, 8)])
@pytest.mark.parametrize("prior", [1.0, 0.0])
def test_poe_backward_matches_jax_vjp(shape, prior):
    mus, scales = _experts(11, shape)
    rng = np.random.default_rng(12)
    g_mu, g_scale = (rng.normal(size=shape[1:]).astype(np.float32) for _ in range(2))
    _, vjp = jax.vjp(lambda m, s: jpoe.poe_fused(m, s, prior),
                     jnp.asarray(mus), jnp.asarray(scales))
    want = vjp((jnp.asarray(g_mu), jnp.asarray(g_scale)))
    mt, st = (torch.from_numpy(x).requires_grad_() for x in (mus, scales))
    mu, scale = tpoe.poe_fused(mt, st, prior)
    torch.autograd.backward((mu, scale), (torch.from_numpy(g_mu), torch.from_numpy(g_scale)))
    for got, w in zip((mt.grad, st.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


def test_functions_pass_gradcheck_in_float64():
    rng = np.random.default_rng(13)
    q, k, v = (torch.from_numpy(rng.normal(size=s)).requires_grad_()
               for s in ((2, 2, 3, 4), (2, 2, 5, 4), (2, 2, 5, 4)))
    # no fully masked row here: its -1e30 bias swamps the logits, so the
    # numerical derivative is 0 where the recompute backward (as the
    # reference's) gives P(dP - rowsum(dP P)) K; that row is held against
    # jax.vjp above
    mask = torch.tensor([[True, False, True, True, False], [False, True, True, False, True]])
    assert torch.autograd.gradcheck(
        lambda q_, k_, v_: tattn.masked_attention(q_, k_, v_, mask), (q, k, v))
    mus = torch.from_numpy(rng.normal(size=(2, 3, 4))).requires_grad_()
    scales = torch.from_numpy(rng.uniform(0.3, 2.0, (2, 3, 4))).requires_grad_()
    for prior in (1.0, 0.0):
        assert torch.autograd.gradcheck(lambda m, s: tpoe.poe_fused(m, s, prior),
                                        (mus, scales))
    assert torch.autograd.gradcheck(tkl.kl_normal_std_fused, (mus[0], scales[0]))


# -- the arithmetic of the tensor-core sparse forward -------------------------


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 cut to TF32's 10 mantissa bits by masking the low 13."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _matmul_tf32(a, b):
    return _tf32(a) @ _tf32(b)


def _matmul_3xtf32(a, b):
    """x = hi + lo; lo_a hi_b + hi_a lo_b + hi_a hi_b, summed in fp32."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
    return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi


def _sparse_forward_with(matmul, q, k, v, block, stride):
    """The sparse forward as csrc/sparse_attention.cu sparse_fwd_mma computes
    it, with both products through ``matmul``: base-2 logits from a
    pre-scaled q, -1e30 on the masked pairs, p = 2^(s - max), out = p v / l,
    lse = (max + log2 l) ln 2."""
    t, dh = q.shape[2], q.shape[3]
    s = matmul(q * (1.4426950408889634 / dh ** 0.5), k.transpose(-1, -2))
    s = s.masked_fill(~tsparse.visibility(t, block, stride), tsparse.NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.exp2(s - m)
    l = p.sum(-1, keepdim=True)
    return matmul(p, v) / l, ((m + torch.log2(l)) * 0.6931471805599453).squeeze(-1)


def _plain_sparse(q, k, v, block, stride):
    out = tsparse.sparse_attention_reference(q, k, v, block, stride)
    logits = (q @ k.transpose(-1, -2)) / q.shape[-1] ** 0.5
    visible = tsparse.visibility(q.shape[2], block, stride)
    return out, torch.logsumexp(logits.masked_fill(~visible, float("-inf")), dim=-1)


SPARSE_EMULATION_SHAPES = [(2, 2, 128, 32, 16, 4), (1, 2, 256, 32, 64, 1),
                           (1, 1, 96, 8, 16, 2), (1, 2, 128, 64, 32, 4)]


@pytest.mark.parametrize("b,h,t,dh,block,stride", SPARSE_EMULATION_SHAPES)
@pytest.mark.parametrize("matmul", [torch.matmul, _matmul_3xtf32])
def test_sparse_forward_arithmetic_meets_the_tolerance(b, h, t, dh, block, stride, matmul):
    """The kernel's order of operations in fp32, and with each product as
    three TF32 products of the hi/lo split, stays within the forward
    tolerance of the plain version: what the tensor-core kernel is built on."""
    rng = np.random.default_rng(15)
    q, k, v = (torch.from_numpy(rng.normal(size=(b, h, t, dh)).astype(np.float32))
               for _ in range(3))
    want, want_lse = _plain_sparse(q, k, v, block, stride)
    got, got_lse = _sparse_forward_with(matmul, q, k, v, block, stride)
    torch.testing.assert_close(got, want, **SPARSE_TOL)
    torch.testing.assert_close(got_lse, want_lse, **SPARSE_TOL)


@pytest.mark.parametrize("b,h,t,dh,block,stride", SPARSE_EMULATION_SHAPES)
def test_sparse_forward_in_one_tf32_pass_misses_the_tolerance(b, h, t, dh, block, stride):
    """One TF32 product keeps three digits: the same forward with a single
    pass per product falls outside the tolerance, which is why the kernel
    pays for the split."""
    rng = np.random.default_rng(15)
    q, k, v = (torch.from_numpy(rng.normal(size=(b, h, t, dh)).astype(np.float32))
               for _ in range(3))
    want, _ = _plain_sparse(q, k, v, block, stride)
    got, _ = _sparse_forward_with(_matmul_tf32, q, k, v, block, stride)
    assert torch.isfinite(got).all()
    assert not torch.allclose(got, want, **SPARSE_TOL)
    err_1x = (got - want).abs().max().item()
    err_3x = (_sparse_forward_with(_matmul_3xtf32, q, k, v, block, stride)[0]
              - want).abs().max().item()
    assert err_1x > 50 * err_3x


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2.0 ** -10, 1.0 + 2.0 ** -11, -3.0 - 2.0 ** -12, 0.0])
    assert _tf32(x).tolist() == [1.0 + 2.0 ** -10, 1.0, -3.0, 0.0]
    y = torch.from_numpy(np.random.default_rng(16).normal(size=1000).astype(np.float32))
    hi = _tf32(y)
    assert ((y - hi).abs() <= y.abs() * 2.0 ** -10).all()
    assert torch.equal(hi + (y - hi), y)   # the split is exact before lo is rounded


# -- the arithmetic of the tensor-core sparse backward --------------------------


def _sparse_backward_with(matmul, q, k, v, d_out, block, stride, forward_matmul=None,
                          scale_after=False):
    """dq, dk, dv as csrc/sparse_attention.cu sparse_dq_mma and sparse_dkv_mma
    compute them, each of the five products (and the forward's two, which
    give lse and delta) through ``matmul``: base-2 logits from a pre-scaled q
    (dq) or k (dk/dv, transposed), P = 2^(s - lse log2 e) with the hidden
    pairs 0, dS = P (dP - delta), dq and dk scaled by 1/sqrt(Dh) at the
    end.  With ``scale_after`` the logits are the product of q and k as they
    are, scaled in fp32 (sparse_dq_tc and sparse_dkv_tc, on bf16 q and k)."""
    t, dh = q.shape[2], q.shape[3]
    scale, log2e = 1.0 / dh ** 0.5, 1.4426950408889634
    out, lse = _sparse_forward_with(forward_matmul or matmul, q, k, v, block, stride)
    delta = (d_out * out).sum(-1)
    visible = tsparse.visibility(t, block, stride)
    lse2 = lse * log2e

    def logits(a, b):
        if scale_after:
            return matmul(a, b.transpose(-1, -2)) * (scale * log2e)
        return matmul(a * (scale * log2e), b.transpose(-1, -2))
    # dq: query rows, keys as columns
    p = torch.exp2(logits(q, k) - lse2[..., None])
    p = p.masked_fill(~visible, 0.0)
    ds = p * (matmul(d_out, v.transpose(-1, -2)) - delta[..., None])
    dq = matmul(ds, k) * scale
    # dk/dv: key rows, queries as columns
    pt = torch.exp2(logits(k, q) - lse2[..., None, :])
    pt = pt.masked_fill(~visible.T, 0.0)
    dv = matmul(pt, d_out)
    dst = pt * (matmul(v, d_out.transpose(-1, -2)) - delta[..., None, :])
    dk = matmul(dst, q) * scale
    return dq, dk, dv


def _plain_sparse_grads(q, k, v, d_out, block, stride):
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = tsparse.sparse_attention_reference(*leaves, block, stride)
    return torch.autograd.grad(out, leaves, d_out)


def _sparse_bwd_inputs(b, h, t, dh):
    rng = np.random.default_rng(17)
    return [torch.from_numpy(rng.normal(size=(b, h, t, dh)).astype(np.float32))
            for _ in range(4)]


@pytest.mark.parametrize("b,h,t,dh,block,stride", SPARSE_EMULATION_SHAPES)
@pytest.mark.parametrize("matmul", [torch.matmul, _matmul_3xtf32])
def test_sparse_backward_arithmetic_meets_the_tolerance(b, h, t, dh, block, stride, matmul):
    """The backward kernels' order of operations in fp32, and with every
    product as three TF32 products of the hi/lo split, stays within the
    backward tolerance of autograd through the plain version."""
    q, k, v, d_out = _sparse_bwd_inputs(b, h, t, dh)
    want = _plain_sparse_grads(q, k, v, d_out, block, stride)
    got = _sparse_backward_with(matmul, q, k, v, d_out, block, stride)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **SPARSE_BWD_TOL)


@pytest.mark.parametrize("b,h,t,dh,block,stride", SPARSE_EMULATION_SHAPES)
def test_sparse_backward_in_one_tf32_pass_is_50x_worse(b, h, t, dh, block, stride):
    """One TF32 pass per backward product (lse and delta from the 3xTF32
    forward, as the kernels get them) has at least 50 times the error of
    the 3xTF32 split on the same inputs."""
    q, k, v, d_out = _sparse_bwd_inputs(b, h, t, dh)
    want = _plain_sparse_grads(q, k, v, d_out, block, stride)

    def worst(matmul):
        got = _sparse_backward_with(matmul, q, k, v, d_out, block, stride,
                                    forward_matmul=_matmul_3xtf32)
        assert all(torch.isfinite(g).all() for g in got)
        return max((g - w).abs().max().item() for g, w in zip(got, want))

    assert worst(_matmul_tf32) > 50 * worst(_matmul_3xtf32)


# -- the arithmetic of the fp32 tensor-core masked attention ------------------


def _mma_attention_with(matmul, q, k, v, mask, skip=True):
    """The masked attention as csrc/attention.cu masked_attention_mma
    computes it, with both products through ``matmul``: q pre-scaled so that
    scores are base-2 logits, keys walked 32 at a time with an online
    softmax (p = 2^(s - max), the running sum and output rescaled by
    2^(old max - new max)), the bias 0 or -1e30 per key and -inf for the
    keys past Tk in the last tile, and (``skip``) the tiles whose keys are
    all masked left out where the batch element has a visible key."""
    b, h, tq, dh = q.shape
    tk = k.shape[2]
    tiles = -(-tk // 32)
    pad = tiles * 32 - tk
    k = torch.nn.functional.pad(k, (0, 0, 0, pad))
    v = torch.nn.functional.pad(v, (0, 0, 0, pad))
    visible = torch.ones(b, tk, dtype=torch.bool) if mask is None else mask
    bias = torch.full((b, tiles * 32), float("-inf"))
    bias[:, :tk] = torch.where(visible, 0.0, tattn.NEG_INF)
    qs = q * (1.4426950408889634 / dh ** 0.5)
    out = torch.empty(b, h, tq, dh)
    for e in range(b):
        live = [c for c in range(tiles) if visible[e, 32 * c:32 * c + 32].any()]
        m = torch.full((h, tq, 1), tattn.NEG_INF)
        l = torch.zeros(h, tq, 1)
        acc = torch.zeros(h, tq, dh)
        for c in (live if live and skip else range(tiles)):
            keys = slice(32 * c, 32 * c + 32)
            s = matmul(qs[e], k[e, :, keys].transpose(-1, -2)) + bias[e, keys]
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(s - m_new)
            l = l * alpha + p.sum(-1, keepdim=True)
            acc = acc * alpha + matmul(p, v[e, :, keys])
            m = m_new
        out[e] = acc / l
    return out


# (B, H, Tq, Tk, Dh): heads past the resident kernel's 256 keys, Tk not a
# multiple of the 32-key tile
MMA_EMULATION_SHAPES = [(2, 2, 9, 300, 8), (1, 2, 5, 260, 16), (3, 1, 4, 290, 12)]


def _mma_inputs(b, h, tq, tk, dh):
    """q, k, v and a key-padding mask from a seed: element 0 masked whole,
    the others visible in a random share of keys and in two runs that leave
    whole 32-key tiles dead between and after them."""
    q, k, v, rng = _qkv(17, b, h, tq, tk, dh)
    mask = rng.random((b, tk)) > 0.5
    mask[1:, 40:100] = False
    mask[1:, 200:] = False
    mask[0] = False
    return q, k, v, mask


def _pallas(q, k, v, mask):
    return np.asarray(jattn.masked_flash_attention(jnp.asarray(q), jnp.asarray(k),
                                                   jnp.asarray(v), jnp.asarray(mask),
                                                   kv_block=128))


@pytest.mark.parametrize("b,h,tq,tk,dh", MMA_EMULATION_SHAPES)
def test_mma_attention_arithmetic_matches_pallas_interpret(b, h, tq, tk, dh):
    """The tensor-core kernel's order of operations, each product as three
    TF32 products of the hi/lo split, against the JAX package's Pallas
    kernel (interpreted) within the reference Pallas test's tolerance; the
    element masked whole is the mean of V (the tail keys past Tk add
    nothing to it)."""
    q, k, v, mask = _mma_inputs(b, h, tq, tk, dh)
    got = _mma_attention_with(_matmul_3xtf32, *(torch.from_numpy(x) for x in (q, k, v)),
                              torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, _pallas(q, k, v, mask), **ATTN_TOL)
    uniform = np.broadcast_to(v[0].mean(axis=1, keepdims=True), got[0].shape)
    np.testing.assert_allclose(got[0], uniform, **ATTN_TOL)


@pytest.mark.parametrize("b,h,tq,tk,dh", MMA_EMULATION_SHAPES)
def test_mma_attention_in_one_tf32_pass_misses_the_tolerance(b, h, tq, tk, dh):
    """With a single TF32 pass per product the same walk falls outside the
    tolerance of the Pallas kernel: why the kernel pays for the split."""
    q, k, v, mask = _mma_inputs(b, h, tq, tk, dh)
    want = _pallas(q, k, v, mask)
    tq_, tk_, tv_, tm_ = (torch.from_numpy(x) for x in (q, k, v, mask))
    got = _mma_attention_with(_matmul_tf32, tq_, tk_, tv_, tm_).numpy()
    assert np.isfinite(got).all()
    assert not np.allclose(got, want, **ATTN_TOL)
    err_3x = np.abs(_mma_attention_with(_matmul_3xtf32, tq_, tk_, tv_, tm_).numpy()
                    - want).max()
    assert np.abs(got - want).max() > 10 * err_3x


def test_mma_attention_skips_no_bit():
    """Leaving out the dead tiles is exact: the walk over every tile (the
    dense yardstick) gives the same bits in fp32, and NaN in the dead
    tiles' K and V does not reach the output."""
    q, k, v, mask = (torch.from_numpy(x) for x in _mma_inputs(2, 2, 9, 300, 8))
    got = _mma_attention_with(torch.matmul, q, k, v, mask)
    dead = torch.zeros(2, 300, dtype=torch.bool)
    for c in range(10):
        tile = slice(32 * c, 32 * c + 32)
        dead[1, tile] = not mask[1, tile].any()
    assert dead.any()
    hole = dead[:, None, :, None]
    poisoned = _mma_attention_with(torch.matmul, q, k.masked_fill(hole, float("nan")),
                                   v.masked_fill(hole, float("nan")), mask)
    assert torch.equal(got, poisoned)
    assert torch.equal(got, _mma_attention_with(torch.matmul, q, k, v, mask, skip=False))
