"""The arithmetic of the bf16 tensor-core kernels, emulated on the CPU.

``csrc/attention.cu`` (``masked_attention_tc``) and
``csrc/sparse_attention.cu`` (``sparse_fwd_tc``) compute the fp32 forward
from bf16 q, k and v on bf16 MMAs: S = Q K^T with q and k as they are (a
bf16 x bf16 product is exact in fp32), ``sm_scale * log2(e)`` applied to
the fp32 S, and P V with the fp32 P split into two bf16 planes, p = hi +
lo, hi = bf16(p), lo = bf16(p - hi), one product each, summed in fp32.
The masked attention also skips the 32-key tiles whose keys are all masked
in a batch element that has a visible key.  The sparse dq and dk/dv
(``sparse_dq_tc``, ``sparse_dkv_tc``) take every fp32 operand (P, dS and
the fp32 ``d_out``) in two such planes and sum hi hi + hi lo + lo hi.

Here that arithmetic runs in fp32 on the CPU on bf16-rounded inputs made
with numpy from a seed, and is held to the tolerance of the plain version
on the widened inputs and of the JAX package's Pallas kernels, interpreted
(they widen bf16 to fp32 exactly, so they are fed the same bf16-rounded
values in fp32); a single bf16 plane for P (and for P and dS in the
backward) has a larger error, which is why the kernels pay for the split;
and the skip leaves the emulated output bit-equal.  The kernels themselves
are held against the fp32 kernels by ``tests/test_torch_cuda.py`` and
``chip_smoke.py``.  ``PYTHONPATH=. JAX_PLATFORMS=cpu python
tests/test_torch_bf16_kernels.py`` prints the backward's error with one
plane and with two at each shape.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_vae_comparison_tpu.ops.pallas import attention as jattn
from multimodal_vae_comparison_tpu.ops.pallas import sparse_attention as jsparse
from multimodal_vae_comparison_tpu_torch.ops.kernels import attention as tattn
from multimodal_vae_comparison_tpu_torch.ops.kernels import sparse_attention as tsparse
from test_torch_kernels import SPARSE_BWD_TOL, _plain_sparse_grads, _sparse_backward_with
from test_torch_slice import one_torch_thread  # noqa: F401 (autouse)

ATTN_TOL = dict(rtol=2e-4, atol=2e-5)    # as tests/test_pallas.py
SPARSE_TOL = dict(rtol=2e-4, atol=2e-5)  # as tests/test_pallas.py, forward
LOG2E, LN2 = 1.4426950408889634, 0.6931471805599453
KEYS = 32                                # keys per step and per skipped tile


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(jattn, "_INTERPRET", True)
    monkeypatch.setattr(jsparse, "_INTERPRET", True)


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16 (to nearest, ties to even) and widened back."""
    return x.to(torch.bfloat16).to(torch.float32)


def _pv_split(p, v):
    """P V as the kernels take it: p = hi + lo in two bf16 planes."""
    hi = _bf16(p)
    return hi @ v + _bf16(p - hi) @ v


def _pv_one_plane(p, v):
    return _bf16(p) @ v


def _inputs(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [_bf16(torch.from_numpy(rng.normal(size=s).astype(np.float32))) for s in shapes], rng


# -- the sparse forward -----------------------------------------------------------


def _sparse_forward_tc(pv, q, k, v, block, stride):
    """sparse_fwd_tc's order of operations: the fp32 dot products of the
    bf16 q and k, then base-2 logits, -1e30 on the hidden pairs, p = 2^(s -
    max), out = P V / l through ``pv``, lse = (max + log2 l) ln 2."""
    t, dh = q.shape[2], q.shape[3]
    s = (q @ k.transpose(-1, -2)) * (LOG2E / dh ** 0.5)
    s = s.masked_fill(~tsparse.visibility(t, block, stride), tsparse.NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.exp2(s - m)
    l = p.sum(-1, keepdim=True)
    return pv(p, v) / l, ((m + torch.log2(l)) * LN2).squeeze(-1)


def _plain_sparse(q, k, v, block, stride):
    out = tsparse.sparse_attention_reference(q, k, v, block, stride)
    logits = (q @ k.transpose(-1, -2)) / q.shape[-1] ** 0.5
    visible = tsparse.visibility(q.shape[2], block, stride)
    return out, torch.logsumexp(logits.masked_fill(~visible, float("-inf")), dim=-1)


# (b, h, t, dh, block, stride): Dh a multiple of 8, as sparse_fwd_tc takes
SPARSE_SHAPES = [(2, 2, 128, 32, 16, 4), (1, 2, 256, 32, 64, 1), (1, 1, 96, 8, 16, 2),
                 (1, 2, 128, 64, 32, 4), (1, 2, 128, 16, 32, 2)]


@pytest.mark.parametrize("b,h,t,dh,block,stride", SPARSE_SHAPES)
def test_bf16_sparse_forward_arithmetic_meets_the_tolerance(b, h, t, dh, block, stride):
    """On bf16-rounded inputs the emulated forward and its lse stay within
    the forward tolerance of the plain version on the widened inputs."""
    (q, k, v), _ = _inputs(20, *[(b, h, t, dh)] * 3)
    want, want_lse = _plain_sparse(q, k, v, block, stride)
    got, got_lse = _sparse_forward_tc(_pv_split, q, k, v, block, stride)
    torch.testing.assert_close(got, want, **SPARSE_TOL)
    torch.testing.assert_close(got_lse, want_lse, **SPARSE_TOL)


@pytest.mark.parametrize("b,h,t,dh,block,stride", SPARSE_SHAPES)
def test_bf16_sparse_forward_with_one_plane_of_p_misses_the_tolerance(b, h, t, dh, block,
                                                                      stride):
    """P rounded once to bf16 keeps 8 bits: the same forward falls outside
    the tolerance, with many times the error of the two-plane split."""
    (q, k, v), _ = _inputs(20, *[(b, h, t, dh)] * 3)
    want, _ = _plain_sparse(q, k, v, block, stride)
    got, _ = _sparse_forward_tc(_pv_one_plane, q, k, v, block, stride)
    assert torch.isfinite(got).all()
    assert not torch.allclose(got, want, **SPARSE_TOL)
    err_split = (_sparse_forward_tc(_pv_split, q, k, v, block, stride)[0] - want).abs().max()
    assert (got - want).abs().max() > 20 * err_split


@pytest.mark.parametrize("shape,block,stride", [((2, 2, 64, 16), 16, 2),
                                                ((1, 2, 96, 8), 32, 3)])
def test_bf16_sparse_forward_arithmetic_matches_the_pallas_kernel(shape, block, stride):
    """At small shapes, within the forward tolerance of the JAX package's
    Pallas kernel (interpreted) and its lse on the same bf16 values."""
    (q, k, v), _ = _inputs(21, shape, shape, shape)
    b, h, t, dh = shape
    want, want_lse = jsparse._sparse_forward_with_lse(
        *(jnp.asarray(x.numpy()) for x in (q, k, v)), block, stride)
    got, got_lse = _sparse_forward_tc(_pv_split, q, k, v, block, stride)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SPARSE_TOL)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse).reshape(b, h, t),
                               **SPARSE_TOL)


# -- the sparse dq and dk/dv -------------------------------------------------------


def _matmul_planes(a, b, lhs_planes=2):
    """a b with each fp32 operand as two bf16 planes, x = hi + lo: hi hi +
    hi lo + lo hi, summed in fp32, as sparse_dq_tc and sparse_dkv_tc take
    their products (a bf16 operand has lo = 0, so its terms vanish as the
    kernels' MMAs on it are never issued).  ``lhs_planes=1`` keeps one
    plane of the left operand: P and dS in every product that takes them
    (and d_out in dq's dP = dO V^T)."""
    a_hi, b_hi = _bf16(a), _bf16(b)
    b_lo = _bf16(b - b_hi)
    if lhs_planes == 1:
        return a_hi @ b_lo + a_hi @ b_hi
    return (a_hi @ b_lo + _bf16(a - a_hi) @ b_hi) + a_hi @ b_hi


def _matmul_one_plane(a, b):
    return _matmul_planes(a, b, lhs_planes=1)


def _sparse_backward_tc(matmul, q, k, v, d_out, block, stride):
    """dq, dk, dv before their bf16 rounding, in the order of operations of
    the tensor-core backward (tests/test_torch_kernels.py), logits scaled
    after the exact bf16 product, every backward product through
    ``matmul``; lse and delta from the fp32 forward."""
    return _sparse_backward_with(matmul, q, k, v, d_out, block, stride,
                                 forward_matmul=torch.matmul, scale_after=True)


def _bwd_inputs(b, h, t, dh):
    """bf16-rounded q, k, v and an fp32 d_out (the kernels take d_out fp32)."""
    (q, k, v), rng = _inputs(26, *[(b, h, t, dh)] * 3)
    return q, k, v, torch.from_numpy(rng.normal(size=(b, h, t, dh)).astype(np.float32))


# (b, h, t, dh, block, stride): Dh 16, 32 and 64; blocks of 16 and 32 and
# one of 48, not a multiple of 32
SPARSE_BWD_SHAPES = [(2, 2, 128, 32, 16, 4), (1, 2, 256, 16, 32, 2), (1, 2, 192, 64, 48, 2),
                     (1, 2, 96, 32, 48, 1)]


@pytest.mark.parametrize("b,h,t,dh,block,stride", SPARSE_BWD_SHAPES)
def test_bf16_sparse_backward_arithmetic_meets_the_tolerance(b, h, t, dh, block, stride):
    """On bf16-rounded inputs the emulated dq, dk, dv stay within the
    backward tolerance of autograd through the plain version on the
    widened inputs."""
    q, k, v, d_out = _bwd_inputs(b, h, t, dh)
    want = _plain_sparse_grads(q, k, v, d_out, block, stride)
    got = _sparse_backward_tc(_matmul_planes, q, k, v, d_out, block, stride)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **SPARSE_BWD_TOL)


@pytest.mark.parametrize("b,h,t,dh,block,stride", SPARSE_BWD_SHAPES)
def test_bf16_sparse_backward_arithmetic_matches_the_pallas_kernels(b, h, t, dh, block, stride):
    """Within the backward tolerance of the JAX package's
    _sparse_backward_pallas (the dq and dk/dv Pallas kernels, interpreted)
    on the same bf16 values, with lse from its Pallas forward."""
    q, k, v, d_out = _bwd_inputs(b, h, t, dh)
    flat = [jnp.asarray(x.numpy().reshape(b * h, t, dh)) for x in (q, k, v, d_out)]
    out, lse = jsparse._sparse_forward_with_lse(*(jnp.asarray(x.numpy()) for x in (q, k, v)),
                                                block, stride, train=True)
    delta = jnp.sum(flat[3] * out.reshape(b * h, t, dh), axis=-1, keepdims=True)
    want = jsparse._sparse_backward_pallas(*flat, lse, delta, block, stride)
    got = _sparse_backward_tc(_matmul_planes, q, k, v, d_out, block, stride)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w).reshape(b, h, t, dh),
                                   **SPARSE_BWD_TOL)


def _bwd_errors(b, h, t, dh, block, stride):
    """(worst |error| with one plane of P and dS, with two) over dq, dk, dv
    against autograd through the plain version."""
    q, k, v, d_out = _bwd_inputs(b, h, t, dh)
    want = _plain_sparse_grads(q, k, v, d_out, block, stride)
    return tuple(max((g - w).abs().max().item() for g, w in zip(
        _sparse_backward_tc(mm, q, k, v, d_out, block, stride), want))
        for mm in (_matmul_one_plane, _matmul_planes))


@pytest.mark.parametrize("b,h,t,dh,block,stride", SPARSE_BWD_SHAPES)
def test_bf16_sparse_backward_with_one_plane_of_p_and_ds_is_worse(b, h, t, dh, block, stride):
    """P and dS rounded once to bf16 keep 8 bits: the backward's error
    against the plain version is larger than with the two-plane split."""
    one, two = _bwd_errors(b, h, t, dh, block, stride)
    assert np.isfinite(one) and one > two


# -- the masked attention -----------------------------------------------------------


def _attention_tc(pv, q, k, v, mask, skip=True):
    """masked_attention_tc's order of operations, 32 keys a step with the
    online softmax: base-2 logits s * sm_scale log2 e + bias (0, -1e30 for
    a masked key, -inf past Tk), the running max m from -1e30, alpha =
    2^(m - m_new), P V through ``pv``.  With ``skip`` each batch element
    that has a visible key walks only the tiles that hold one."""
    b, h, tq, dh = q.shape
    tk = k.shape[2]
    ntiles = -(-tk // KEYS)
    pad = ntiles * KEYS - tk
    kp = torch.nn.functional.pad(k, (0, 0, 0, pad))
    vp = torch.nn.functional.pad(v, (0, 0, 0, pad))
    visible = torch.ones((b, tk), dtype=torch.bool) if mask is None else mask
    bias = torch.full((b, ntiles * KEYS), float("-inf"))
    bias[:, :tk] = torch.where(visible, 0.0, tattn.NEG_INF)
    scale2 = torch.tensor(LOG2E / dh ** 0.5, dtype=torch.float32)
    out = torch.empty((b, h, tq, dh))
    for i in range(b):
        tiles = range(ntiles)
        if skip and visible[i].any():
            tiles = [t for t in tiles if visible[i, t * KEYS:(t + 1) * KEYS].any()]
        m = torch.full((h, tq, 1), tattn.NEG_INF)
        l = torch.zeros((h, tq, 1))
        acc = torch.zeros((h, tq, dh))
        for t in tiles:
            keys = slice(t * KEYS, (t + 1) * KEYS)
            s = (q[i] @ kp[i, :, keys].transpose(-1, -2)) * scale2 + bias[i, keys]
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(s - m_new)
            l = l * alpha + p.sum(-1, keepdim=True)
            acc = acc * alpha + pv(p, vp[i, :, keys])
            m = m_new
        out[i] = acc / l
    return out


def _mask(rng, b, tk, whole_tiles=False):
    """Key-padding rows of random lengths; the first batch element has no
    visible key; with ``whole_tiles`` the second sees only keys from 64 on
    and a few after a masked tile, so whole tiles before, between and
    after its visible keys are masked."""
    lengths = rng.integers(1, tk + 1, (b, 1))
    mask = np.arange(tk)[None, :] < lengths
    mask[0] = False
    if whole_tiles:
        mask[1] = False
        mask[1, 64:70] = True
        mask[1, 100:103] = True
    return torch.from_numpy(mask)


# (b, h, tq, tk, dh): CUB's caption encoder and VILANRO's action encoder cut
# to a few rows, a Tk that is not a multiple of 32, Dh 8 and 64, a key tile
# of one key
ATTN_SHAPES = [(4, 2, 20, 246, 32), (4, 2, 13, 100, 16), (3, 2, 9, 70, 8),
               (3, 1, 17, 130, 64), (3, 2, 5, 65, 32)]


@pytest.mark.parametrize("b,h,tq,tk,dh", ATTN_SHAPES)
@pytest.mark.parametrize("whole_tiles", [False, True])
def test_bf16_attention_arithmetic_meets_the_tolerance(b, h, tq, tk, dh, whole_tiles):
    """On bf16-rounded inputs the emulated forward (with the skip) stays
    within the tolerance of the plain version on the widened inputs; the
    batch element with every key masked gets the uniform average of V."""
    (q, k, v), rng = _inputs(22, (b, h, tq, dh), (b, h, tk, dh), (b, h, tk, dh))
    mask = _mask(rng, b, tk, whole_tiles)
    want = tattn.attention_reference(q, k, v, mask)
    got = _attention_tc(_pv_split, q, k, v, mask)
    torch.testing.assert_close(got, want, **ATTN_TOL)
    torch.testing.assert_close(got[0], v[0].mean(-2, keepdim=True).expand(h, tq, dh),
                               **ATTN_TOL)


@pytest.mark.parametrize("b,h,tq,tk,dh", ATTN_SHAPES)
def test_bf16_attention_with_one_plane_of_p_misses_the_tolerance(b, h, tq, tk, dh):
    (q, k, v), rng = _inputs(22, (b, h, tq, dh), (b, h, tk, dh), (b, h, tk, dh))
    mask = _mask(rng, b, tk)
    want = tattn.attention_reference(q, k, v, mask)
    got = _attention_tc(_pv_one_plane, q, k, v, mask)
    assert torch.isfinite(got).all()
    assert not torch.allclose(got, want, **ATTN_TOL)
    err_split = (_attention_tc(_pv_split, q, k, v, mask) - want).abs().max()
    assert (got - want).abs().max() > 20 * err_split


@pytest.mark.parametrize("b,h,tq,tk,dh", ATTN_SHAPES)
@pytest.mark.parametrize("whole_tiles", [False, True])
def test_bf16_attention_skip_of_masked_tiles_changes_no_bit(b, h, tq, tk, dh, whole_tiles):
    """Skipping the tiles whose keys are all masked leaves the emulated
    output bit-equal to walking every tile: a masked score is s - 1e30,
    whose 2^(s - max) is exactly 0 once the max comes from a visible key,
    and a tile walked before the first visible one is scaled by 0."""
    (q, k, v), rng = _inputs(23, (b, h, tq, dh), (b, h, tk, dh), (b, h, tk, dh))
    mask = _mask(rng, b, tk, whole_tiles)
    skipped = _attention_tc(_pv_split, q, k, v, mask, skip=True)
    walked = _attention_tc(_pv_split, q, k, v, mask, skip=False)
    assert torch.equal(skipped, walked)
    if whole_tiles:   # the skip had tiles to skip, before the first visible key too
        assert not mask[1, :KEYS].any() and mask[1, 64:70].all()


@pytest.mark.parametrize("masked", [True, False])
def test_bf16_attention_arithmetic_matches_the_pallas_kernel(masked):
    """At a small shape, within the tolerance of the JAX package's
    masked_flash_attention (Pallas, interpreted) on the same bf16 values."""
    b, h, tq, tk, dh = 3, 2, 11, 70, 16
    (q, k, v), rng = _inputs(24, (b, h, tq, dh), (b, h, tk, dh), (b, h, tk, dh))
    mask = _mask(rng, b, tk, whole_tiles=True) if masked else None
    want = jattn.masked_flash_attention(*(jnp.asarray(x.numpy()) for x in (q, k, v)),
                                        None if mask is None else jnp.asarray(mask.numpy()),
                                        kv_block=64)
    got = _attention_tc(_pv_split, q, k, v, mask)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATTN_TOL)


def test_two_bf16_planes_keep_sixteen_bits():
    """hi + lo of the split holds p to 2^-16 of itself, where hi alone holds
    it to 2^-8 (bf16 rounds to nearest with 8 significant bits)."""
    p = torch.from_numpy(np.random.default_rng(25).random(4096).astype(np.float32))
    hi = _bf16(p)
    lo = _bf16(p - hi)
    assert ((p - hi).abs() <= p * 2.0 ** -8).all()
    assert ((p - (hi + lo)).abs() <= p * 2.0 ** -16).all()
    assert torch.equal(_bf16(torch.tensor([1.0 + 2.0 ** -8, 1.0 + 3 * 2.0 ** -8])),
                       torch.tensor([1.0, 1.0 + 2.0 ** -6]))


def test_tensor_core_variants_are_named():
    """Each wrapper names the bf16 tensor-core kernel's variant, so the
    telemetry shows which kernel ran (the attention's few-keys and short
    bf16 kernels after it)."""
    assert tattn.VARIANTS == ("resident", "chunked", "tc_bf16", "few_keys", "short_bf16")
    assert tsparse.VARIANTS == ("mma", "fma", "tc_bf16")


def test_chip_smoke_bounds_the_tensor_core_kernels_in_their_unit():
    """chip_smoke.py's bounds of the bf16 sparse kernels at the video
    decoder's shape: the larger of their bytes and their products at the
    dense bf16 rate (bytes bind each: the forward 0.0317 ms, bf16 q, k, v
    read, fp32 out and lse written; dq 0.0383 ms and dk/dv 0.0446 ms, bf16
    q, k, v read and dq or dk, dv written, fp32 d_out, lse and delta read);
    and the bf16 MMAs each issues at that rate: the forward 3 a product
    pair (q k^T once, P v on two planes) 0.0163 ms, dq 5 for its three
    products 0.0272 ms, dk/dv 8 for its four 0.0435 ms."""
    import os
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, repo)
    try:
        import chip_smoke
    finally:
        sys.path.remove(repo)
    b, h, t, dh = chip_smoke.BF16_SPARSE_SHAPE
    cells = tsparse.sparse_work(t, chip_smoke.SPARSE_BLOCK, chip_smoke.SPARSE_STRIDE)[1]
    n, rows = b * h * t * dh, b * h * t
    for part, nbytes, per_cell, units, want, want_mma in (
            ("forward", 2 * 3 * n + 4 * (n + rows), 4, 1.5, 0.0317, 0.0163),
            ("dq", 2 * 4 * n + 4 * (n + 2 * rows), 6, 5 / 3, 0.0383, 0.0272),
            ("dkv", 2 * 5 * n + 4 * (n + 2 * rows), 8, 2, 0.0446, 0.0435)):
        flop = per_cell * dh * b * h * cells
        assert chip_smoke.BF16_TC_MMA_UNITS[part] == units
        bound, by, mma = chip_smoke.bf16_tc_bounds(nbytes, flop, units)
        assert by == "bytes" and want - 1e-4 < bound < want + 1e-4, (part, bound)
        assert mma == pytest.approx(units * flop / 989e12 * 1e3)
        assert want_mma - 1e-4 < mma < want_mma + 1e-4, (part, mma)


if __name__ == "__main__":
    for shape in SPARSE_BWD_SHAPES:
        one, two = _bwd_errors(*shape)
        print(f"bf16 sparse backward (b, h, t, dh, block, stride) {shape}: worst |error| "
              f"against the plain version with one plane of P and dS {one:.3e}, with two "
              f"{two:.3e}: {one / two:.1f}x")
