"""Strided block-sparse causal self-attention: CUDA kernels and plain version.

Counterpart of ``ops/pallas/sparse_attention.py``
(``strided_block_sparse_attention``).  Each ``block``-sized query block
attends its own block, causally masked inside, and every
``block_stride``-th earlier block in full.  The kernels are in
``csrc/sparse_attention.cu``: the forward (which also writes the row
log-sum-exp), dq, and dk/dv.  Each of the three launchers picks by shape
between a tensor-core kernel (``"mma"``: 3xTF32 products at fp32-grade
accuracy, for a block that is a multiple of 16, Dh a multiple of 4 from 8 up
and 16-byte aligned tensors) and an fp32 FMA kernel (``"fma"``) that takes
every other shape.  :func:`sparse_attention_reference` is the same function
in plain PyTorch, over a dense additive bias.

:func:`strided_block_sparse_attention` is a ``torch.autograd.Function``.  On
CUDA tensors the forward launches the forward kernel and the backward
computes ``delta = rowsum(d_out * out)`` in a torch op and launches the dq
and dk/dv kernels; on CPU tensors the forward is the plain version and the
backward recomputes through it densely.  Every CUDA call launches its
kernels: there is no size threshold and no switch.

q, k and v come in fp32 or bf16 (``precision: bf16``).  The bf16 forward
runs on the bf16 tensor cores (``"tc_bf16"``: q and k as they are, P in two
bf16 planes) where the shape takes it (the ``"mma"`` rule and Dh a multiple
of 8); elsewhere, and for dq and dk/dv, each launcher's bf16 instance loads
bf16 and widens it to fp32 on the way in (exact), then runs the fp32
arithmetic.  The output and lse are fp32, as are ``d_out`` and delta, and
dq, dk, dv come back in the inputs' dtype, as the reference's
``_sparse_bwd`` casts them.  The plain version widens too.
Under ``ops.flops.step_flops`` the forward counts 4 Dh FLOPs and the
backward 14 Dh per visible (query, key) pair (:func:`sparse_flops`), the
products over the live key blocks, on the card as on the CPU.
"""
from __future__ import annotations

import ctypes
import math
from typing import List, Tuple

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from multimodal_vae_comparison_tpu_torch.ops.flops import kernel_flops
from multimodal_vae_comparison_tpu_torch.ops.kernels import _build, telemetry
from multimodal_vae_comparison_tpu_torch.ops.kernels.attention import widen

SOURCE = "sparse_attention"
KERNEL = "sparse_attention"          # dispatch and launch count of the forward
KERNEL_BWD = "sparse_attention_bwd"  # dispatch of the backward
KERNEL_DQ = "sparse_attention_dq"    # launch counts of the two backward kernels
KERNEL_DKV = "sparse_attention_dkv"
NEG_INF = -1e30
MAX_HEAD_DIM = 64   # csrc/sparse_attention.cu: widest padded head (registers)
MAX_BLOCK = 128     # csrc/sparse_attention.cu MAX_BLOCK: rows (threads) per tile
VARIANTS = ("mma", "fma", "tc_bf16")   # csrc/sparse_attention.cu: *variant of each launcher
_SHAPE = [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
# sparse_attention_forward(q, k, v, o, lse, bh, t, dh, block, stride, scale, stream,
#                          &variant)
_FWD_ARGTYPES = [ctypes.c_void_p] * 5 + _SHAPE + [ctypes.POINTER(ctypes.c_int)]
# sparse_attention_dq(q, k, v, d_out, lse, delta, dq, ..., &variant)
_DQ_ARGTYPES = [ctypes.c_void_p] * 7 + _SHAPE + [ctypes.POINTER(ctypes.c_int)]
# sparse_attention_dkv(q, k, v, d_out, lse, delta, dk, dv, ..., &variant)
_DKV_ARGTYPES = [ctypes.c_void_p] * 8 + _SHAPE + [ctypes.POINTER(ctypes.c_int)]
# the suffix of each launcher's instance for an input dtype
SUFFIX = {torch.float32: "", torch.bfloat16: "_bf16"}
# FLOPs per visible (query, key) pair and head dim: the forward's two
# products; dq's three (s, dp, ds k) and dk/dv's four (s, dv, dp, dk)
FLOPS_PER_PAIR = {"forward": 4, "backward": 6 + 8}


def _live_blocks(n_blocks: int, block_stride: int) -> List[List[int]]:
    """Per query block i: every block_stride-th earlier block, then its own
    (diagonal) block last."""
    return [[j for j in range(i) if (i - j) % block_stride == 0] + [i]
            for i in range(n_blocks)]


def _padded(rows: List[List[int]]) -> Tuple[np.ndarray, np.ndarray]:
    table = np.zeros((len(rows), max(len(r) for r in rows)), np.int32)
    for i, r in enumerate(rows):
        table[i, :len(r)] = r
    return table, np.array([len(r) for r in rows], np.int32)


def block_sparse_layout(seq_len: int, block: int, block_stride: int):
    """(kv_map, n_valid) int32 arrays: kv_map[i, j] is the key block of the
    j-th live block of query block i (0 beyond n_valid[i])."""
    if seq_len % block:
        raise ValueError(f"seq_len {seq_len} is not a multiple of block {block}")
    return _padded(_live_blocks(seq_len // block, block_stride))


def block_sparse_layout_T(seq_len: int, block: int, block_stride: int):
    """The transposed layout, (qv_map, n_valid): per key block, the query
    blocks that attend it, in increasing order."""
    if seq_len % block:
        raise ValueError(f"seq_len {seq_len} is not a multiple of block {block}")
    rows = _live_blocks(seq_len // block, block_stride)
    cols: List[List[int]] = [[] for _ in rows]
    for i, r in enumerate(rows):
        for j in r:
            cols[j].append(i)
    return _padded(cols)


def visibility(t: int, block: int, block_stride: int, device=None) -> torch.Tensor:
    """(T, T) bool, [query, key]: True where the pattern lets the query see
    the key (own block causally, every block_stride-th earlier block fully)."""
    pos = torch.arange(t, device=device)
    qb, kb = pos[:, None] // block, pos[None, :] // block
    strided = (kb < qb) & ((qb - kb) % block_stride == 0)
    return ((qb == kb) & (pos[None, :] <= pos[:, None])) | strided


def sparse_work(t: int, block: int, block_stride: int) -> Tuple[int, int]:
    """(live block pairs, visible (query, key) pairs) of a head: what the
    pattern needs, the diagonal blocks counted as their lower triangle."""
    nq = t // block
    pairs = sum(1 + i // block_stride for i in range(nq))
    return pairs, (pairs - nq) * block * block + nq * block * (block + 1) // 2


def sparse_flops(shape, block: int, block_stride: int, part: str = "forward") -> int:
    """FLOPs of the forward or the backward (dq and dk/dv) at q's (B, H, T,
    Dh) ``shape``, over the visible pairs of the live key blocks only."""
    b, h, t, dh = shape
    return FLOPS_PER_PAIR[part] * b * h * dh * sparse_work(t, block, block_stride)[1]


def sparse_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               block: int = 128, block_stride: int = 4) -> torch.Tensor:
    """Plain PyTorch version over a dense additive bias, (B, H, T, Dh) ->
    (B, H, T, Dh) in fp32 (fp64 for fp64 inputs); differentiable by
    autograd."""
    q, k, v = widen(q), widen(k), widen(v)
    t = q.shape[2]
    bias = torch.zeros((t, t), dtype=q.dtype, device=q.device).masked_fill(
        ~visibility(t, block, block_stride, q.device), NEG_INF)
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(q.shape[-1]) + bias
    return torch.einsum("bhqk,bhkd->bhqd", torch.softmax(logits, dim=-1), v)


def _check(q, k, v, block: int, block_stride: int) -> None:
    if q.dtype not in SUFFIX or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"sparse attention kernel takes float32 or bfloat16 q, k, v of "
                        f"one dtype; got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"sparse attention takes q, k, v of one shape (B, H, T, Dh); "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if any(x.device != q.device for x in (k, v)):
        raise ValueError("sparse attention inputs lie on different devices")
    if not all(x.is_contiguous() for x in (q, k, v)):
        raise ValueError("sparse attention kernel takes contiguous tensors")
    b, h, t, dh = q.shape
    if not 1 <= dh <= MAX_HEAD_DIM:
        raise ValueError(f"sparse attention kernel takes 1 <= Dh <= {MAX_HEAD_DIM}, "
                         f"got {dh}")
    if not 1 <= block <= MAX_BLOCK or block_stride < 1:
        raise ValueError(f"sparse attention kernel takes 1 <= block <= {MAX_BLOCK} "
                         f"and block_stride >= 1, got {block}, {block_stride}")
    if t < 1 or t % block:
        raise ValueError(f"T = {t} is not a positive multiple of block = {block}")
    if t // block > 65535 or b * h < 1 or b * h > 2 ** 31 - 1:
        raise ValueError(f"sparse attention kernel grid too large for {tuple(q.shape)}")


def _shape_args(q, block: int, block_stride: int):
    b, h, t, dh = q.shape
    return (b * h, t, dh, block, block_stride, 1.0 / math.sqrt(dh),
            torch.cuda.current_stream(q.device).cuda_stream)


def _launch_forward(q, k, v, block: int, block_stride: int):
    """(out (B, H, T, Dh), lse (B, H, T)) from the forward kernel."""
    _check(q, k, v, block, block_stride)
    fn = _build.function(SOURCE, "sparse_attention_forward" + SUFFIX[q.dtype],
                         _FWD_ARGTYPES)
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    variant = ctypes.c_int(-1)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             lse.data_ptr(), *_shape_args(q, block, block_stride),
             ctypes.byref(variant))
    _build.check(SOURCE, err)
    telemetry.count_launch(KERNEL)
    telemetry.count_variant(KERNEL, VARIANTS[variant.value], q.dtype)
    return out, lse


def _check_rows(q, d_out, lse, delta) -> None:
    if d_out.shape != q.shape or d_out.dtype != torch.float32 \
            or not d_out.is_contiguous() or d_out.device != q.device:
        raise ValueError("d_out must be contiguous float32 of q's shape and device")
    for name, x in (("lse", lse), ("delta", delta)):
        if x.shape != q.shape[:3] or x.dtype != torch.float32 \
                or not x.is_contiguous() or x.device != q.device:
            raise ValueError(f"{name} must be contiguous float32 (B, H, T) on q's device")


def _launch_dq(q, k, v, d_out, lse, delta, block: int, block_stride: int):
    _check(q, k, v, block, block_stride)
    _check_rows(q, d_out, lse, delta)
    fn = _build.function(SOURCE, "sparse_attention_dq" + SUFFIX[q.dtype], _DQ_ARGTYPES)
    dq = torch.empty_like(q)
    variant = ctypes.c_int(-1)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), d_out.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
             *_shape_args(q, block, block_stride), ctypes.byref(variant))
    _build.check(SOURCE, err)
    telemetry.count_launch(KERNEL_DQ)
    telemetry.count_variant(KERNEL_DQ, VARIANTS[variant.value], q.dtype)
    return dq


def _launch_dkv(q, k, v, d_out, lse, delta, block: int, block_stride: int):
    _check(q, k, v, block, block_stride)
    _check_rows(q, d_out, lse, delta)
    fn = _build.function(SOURCE, "sparse_attention_dkv" + SUFFIX[q.dtype], _DKV_ARGTYPES)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    variant = ctypes.c_int(-1)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), d_out.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
             *_shape_args(q, block, block_stride), ctypes.byref(variant))
    _build.check(SOURCE, err)
    telemetry.count_launch(KERNEL_DKV)
    telemetry.count_variant(KERNEL_DKV, VARIANTS[variant.value], q.dtype)
    return dk, dv


class _StridedBlockSparse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, block, block_stride):
        ctx.block, ctx.block_stride = block, block_stride
        with kernel_flops(sparse_flops(q.shape, block, block_stride)):
            if q.is_cuda:
                telemetry.record(KERNEL, "cuda")
                out, lse = _launch_forward(q, k, v, block, block_stride)
                ctx.save_for_backward(q, k, v, out, lse)
                return out
            telemetry.record(KERNEL, "plain")
            ctx.save_for_backward(q, k, v)
            return sparse_attention_reference(q, k, v, block, block_stride)

    @staticmethod
    @once_differentiable
    def backward(ctx, d_out):
        q, k, v, *saved = ctx.saved_tensors
        with kernel_flops(sparse_flops(q.shape, ctx.block, ctx.block_stride, "backward")):
            if saved:
                out, lse = saved
                telemetry.record(KERNEL_BWD, "cuda")
                d_out = d_out.contiguous()
                delta = (d_out * out).sum(-1)                        # (B, H, T)
                args = (q, k, v, d_out, lse, delta, ctx.block, ctx.block_stride)
                dk, dv = _launch_dkv(*args)
                return _launch_dq(*args), dk, dv, None, None
            telemetry.record(KERNEL_BWD, "plain")
            with torch.enable_grad():
                leaves = [widen(x).detach().requires_grad_() for x in (q, k, v)]
                out = sparse_attention_reference(*leaves, ctx.block, ctx.block_stride)
                dq, dk, dv = torch.autograd.grad(out, leaves, d_out)
            return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None


def strided_block_sparse_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                   block: int = 128, block_stride: int = 4) -> torch.Tensor:
    """Causal strided block-sparse self-attention, differentiable in q, k, v.

    :param q, k, v: (B, H, T, Dh) float32 or bfloat16, of one dtype, with
        T % block == 0
    :param block: sparsity block size (<= 128 on CUDA)
    :param block_stride: attend every block_stride-th earlier block
    :return: (B, H, T, Dh) float32 (float64 for float64 inputs, on the CPU)
    """
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"strided_block_sparse_attention runs on CUDA or the CPU, "
                         f"not {q.device}")
    if q.shape != k.shape or q.shape != v.shape or q.dim() != 4 \
            or q.shape[2] % block:
        raise ValueError(f"q, k, v must share one shape (B, H, T, Dh) with T a "
                         f"multiple of block {block}; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    return _StridedBlockSparse.apply(q, k, v, block, block_stride)
