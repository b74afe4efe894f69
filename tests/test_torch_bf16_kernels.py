"""The arithmetic of the bf16 tensor-core kernels, emulated on the CPU.

``csrc/attention.cu`` (``masked_attention_tc``) and
``csrc/sparse_attention.cu`` (``sparse_fwd_tc``) compute the fp32 forward
from bf16 q, k and v on bf16 MMAs: S = Q K^T with q and k as they are (a
bf16 x bf16 product is exact in fp32), ``sm_scale * log2(e)`` applied to
the fp32 S, and P V with the fp32 P split into two bf16 planes, p = hi +
lo, hi = bf16(p), lo = bf16(p - hi), one product each, summed in fp32.
The masked attention also skips the 32-key tiles whose keys are all masked
in a batch element that has a visible key.

Here that arithmetic runs in fp32 on the CPU on bf16-rounded inputs made
with numpy from a seed, and is held to the forward tolerance of the plain
version on the widened inputs and of the JAX package's Pallas kernels,
interpreted (they widen bf16 to fp32 exactly, so they are fed the same
bf16-rounded values in fp32); a single bf16 plane for P misses that
tolerance, which is why the kernels pay for the split; and the skip leaves
the emulated output bit-equal.  The kernels themselves are held against
the fp32 kernels by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_vae_comparison_tpu.ops.pallas import attention as jattn
from multimodal_vae_comparison_tpu.ops.pallas import sparse_attention as jsparse
from multimodal_vae_comparison_tpu_torch.ops.kernels import attention as tattn
from multimodal_vae_comparison_tpu_torch.ops.kernels import sparse_attention as tsparse
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
    telemetry shows which kernel ran."""
    assert tattn.VARIANTS == ("resident", "chunked", "tc_bf16")
    assert tsparse.VARIANTS == ("mma", "fma", "tc_bf16")


def test_chip_smoke_bounds_the_tensor_core_kernels_in_their_unit():
    """chip_smoke.py's bounds of the bf16 sparse forward at the video
    decoder's shape: the larger of its bytes (bf16 q, k, v read, fp32 out
    and lse written: these bind, 0.0317 ms) and its two products at the
    dense bf16 rate; and its three bf16 MMAs a product pair (q k^T once,
    P v on two planes) at that rate, 0.0163 ms."""
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
    flop = 4 * dh * b * h * cells
    n, rows = b * h * t * dh, b * h * t
    bound, by, mma = chip_smoke.bf16_tc_bounds(2 * 3 * n + 4 * (n + rows), flop)
    assert by == "bytes" and 0.0316 < bound < 0.0318
    assert mma == pytest.approx(1.5 * flop / 989e12 * 1e3) and 0.0162 < mma < 0.0164
