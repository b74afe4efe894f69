"""Masked attention forward: CUDA kernel and its plain version.

Counterpart of ``ops/pallas/attention.py`` (``masked_flash_attention``).
The kernels are in ``csrc/attention.cu``, whose launcher picks by shape: a
head of at most 8 keys (the decoders' cross-attention over 1 latent or a few
conditioning tokens, SPRITES' 8 x 8 axial heads) goes to a kernel that gives
a query row a few lanes and keeps its scores in registers (``"few_keys"``);
a head with Dh a multiple of 4 from 8 and 16-byte aligned inputs goes to a
kernel that runs both products on the tensor cores as three TF32 products
each (3xTF32, fp32-grade) with an online softmax over 32-key tiles staged by
cp.async (``"mma"``) where it has more than 16 query rows and 16 keys or
where the resident kernel cannot hold it (more than 256 keys, or K and V
over the shared-memory budget); a head whose K and V fit shared memory is
otherwise computed whole by one thread block (``"resident"``), any other in
chunks of keys on FMAs (``"chunked"``); under a key mask the three leave out
the 32-key tiles whose keys are all masked, a decision the kernel takes from
the mask on the device.  On bf16 inputs, one key under more query rows takes
the few-keys kernel; with 16 query rows or 16 keys or more (Dh a multiple of
8 up to 64), a kernel on the bf16 tensor cores (``"tc_bf16"``) that skips
the key tiles whose keys are all masked too; with both sides under 16
(SPRITES' 8 x 8 axial heads; Dh a multiple of 8 up to 64, 16-byte aligned
inputs) a kernel that gives each head a warp and copies its bf16 rows as
they are (``"short_bf16"``); else the fp32 route on the bf16 inputs (the mma
kernel widening bf16 as it stages it).  :func:`attention_reference` is the
same function in plain PyTorch.  :func:`masked_attention` is a
``torch.autograd.Function`` whose forward launches the kernel for CUDA
tensors and takes the plain version only for CPU tensors.  Masking is
additive with ``NEG_INF`` per key, as in the TPU kernel, so a row whose keys
are all masked gets the uniform average of V.

q, k and v come in fp32 or bf16 (``precision: bf16``); the output is fp32
either way.  The resident, mma, chunked, few-keys and short kernels load
bf16 and widen it to fp32 (on the way into shared memory or out of it), which
is exact, and then run the fp32 arithmetic; the tensor-core kernel
multiplies q and k as they are (exact in fp32) and P, in two bf16 planes,
by v.  The plain version widens.  The caller casts the output to its
compute dtype, as the reference's ``MultiHeadAttention`` does.

The backward mirrors the reference's ``_flash_bwd``, which recomputes the
attention densely rather than running a kernel: P is recomputed from q, k
and the same additive bias, and dq, dk, dv follow in explicit torch ops.
The mask gets no gradient.  It runs in fp32 and casts dq, dk and dv back
to the inputs' dtypes.  Under ``ops.flops.step_flops`` the forward counts
its two products over Tq x Tk, on the card as on the CPU; the backward's
torch products count as they run.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch
from torch.autograd.function import once_differentiable

from multimodal_vae_comparison_tpu_torch.ops.flops import kernel_flops
from multimodal_vae_comparison_tpu_torch.ops.kernels import _build, telemetry

KERNEL = "attention"
NEG_INF = -1e30
MAX_HEAD_DIM = 128   # csrc/attention.cu MAX_DH
_ROWS = 8            # csrc/attention.cu CHUNK_ROWS: query rows per block, chunked path
_MMA_ROWS = 64       # csrc/attention.cu MMA_ROWS: query rows per block, mma path
_MMA_MAX_KEYS = 1 << 22   # csrc/attention.cu MMA_MAX_KEYS
# csrc/attention.cu Variant
VARIANTS = ("resident", "chunked", "tc_bf16", "few_keys", "short_bf16", "mma")
# the launcher of each input dtype: masked_attention_forward[_bf16](q, k, v,
# key_mask, out, B, H, Tq, Tk, Dh, scale, stream, &variant)
LAUNCHERS = {torch.float32: "masked_attention_forward",
             torch.bfloat16: "masked_attention_forward_bf16"}
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
    ctypes.c_float, ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]


def widen(x: torch.Tensor) -> torch.Tensor:
    """``x`` in fp32, or as it is where it is wider."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def attention_flops(b: int, h: int, tq: int, tk: int, dh: int) -> int:
    """FLOPs of the forward: q k^T and p v, 2 b h Tq Tk Dh each."""
    return 4 * b * h * tq * tk * dh


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        key_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch masked attention, (B, H, Tq, Dh) -> (B, H, Tq, Dh), in
    fp32 (fp64 for fp64 inputs) whatever narrower q, k and v come in."""
    q, k, v = widen(q), widen(k), widen(v)
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(q.shape[-1])
    if key_mask is not None:
        logits = logits + _bias(key_mask, logits.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", torch.softmax(logits, dim=-1), v)


def _launch(q, k, v, key_mask):
    tensors = (q, k, v) if key_mask is None else (q, k, v, key_mask)
    if q.dtype not in LAUNCHERS or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"attention kernel takes float32 or bfloat16 q, k, v of one "
                        f"dtype; got {q.dtype}, {k.dtype}, {v.dtype}")
    if any(t.device != q.device for t in tensors):
        raise ValueError("attention inputs lie on different devices")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("attention kernel takes contiguous tensors")
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4 \
            or q.shape[:2] != k.shape[:2] or q.shape[3] != k.shape[3]:
        raise ValueError(f"attention kernel takes q (B,H,Tq,Dh), k/v (B,H,Tk,Dh); "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, h, tq, dh = q.shape
    tk = k.shape[2]
    if not (1 <= dh <= MAX_HEAD_DIM) or tq < 1 or tk < 1:
        raise ValueError(f"attention kernel takes 1 <= Dh <= {MAX_HEAD_DIM}, "
                         f"Tq >= 1, Tk >= 1; got Dh={dh}, Tq={tq}, Tk={tk}")
    # the grid's query-row blocks: the mma kernel's where it takes the shape
    # (csrc/attention.cu mma_takes; the resident kernel's plan checks its own)
    aligned = all(t.data_ptr() % 16 == 0 for t in (q, k, v))
    rows = _MMA_ROWS if dh % 4 == 0 and dh >= 8 and tk <= _MMA_MAX_KEYS and aligned else _ROWS
    if -(-tq // rows) > 65535 or b * h > 2 ** 31 - 1:
        raise ValueError(f"attention kernel grid too large for {tuple(q.shape)}")
    if key_mask is not None and (key_mask.dtype != torch.bool
                                 or key_mask.shape != (b, tk)):
        raise ValueError(f"key_mask must be bool (B, Tk) = {(b, tk)}, got "
                         f"{key_mask.dtype} {tuple(key_mask.shape)}")
    fn = _build.function(KERNEL, LAUNCHERS[q.dtype], _ARGTYPES)
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    variant = ctypes.c_int(-1)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
             None if key_mask is None else key_mask.data_ptr(), out.data_ptr(),
             b, h, tq, tk, dh, 1.0 / math.sqrt(dh), stream, ctypes.byref(variant))
    _build.check(KERNEL, err)
    telemetry.count_launch(KERNEL)
    telemetry.count_variant(KERNEL, VARIANTS[variant.value], q.dtype)
    return out


def _bias(key_mask: torch.Tensor, dtype) -> torch.Tensor:
    """(B, Tk) bool -> (B, 1, 1, Tk) additive bias: 0 to attend, NEG_INF not."""
    bias = torch.zeros(key_mask.shape, dtype=dtype, device=key_mask.device)
    return bias.masked_fill(~key_mask, NEG_INF)[:, None, None, :]


class _MaskedAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, key_mask):
        ctx.save_for_backward(q, k, v, key_mask)
        with kernel_flops(attention_flops(*q.shape[:3], k.shape[2], q.shape[3])):
            if q.is_cuda:
                telemetry.record(KERNEL, "cuda")
                return _launch(q, k, v, key_mask)
            telemetry.record(KERNEL, "plain")
            return attention_reference(q, k, v, key_mask)

    @staticmethod
    @once_differentiable
    def backward(ctx, d_out):
        q_in, k_in, v_in, key_mask = ctx.saved_tensors
        q, k, v, d_out = widen(q_in), widen(k_in), widen(v_in), widen(d_out)
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
        s = torch.matmul(q, k.transpose(-1, -2)) * sm_scale
        if key_mask is not None:
            s = s + _bias(key_mask, s.dtype)
        p = torch.softmax(s, dim=-1)                            # (B, H, Tq, Tk)
        dv = torch.matmul(p.transpose(-1, -2), d_out)
        dp = torch.matmul(d_out, v.transpose(-1, -2))
        ds = p * (dp - (dp * p).sum(-1, keepdim=True))
        dq = torch.matmul(ds, k) * sm_scale
        dk = torch.matmul(ds.transpose(-1, -2), q) * sm_scale
        return dq.to(q_in.dtype), dk.to(k_in.dtype), dv.to(v_in.dtype), None


def masked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     key_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """softmax(q k^T / sqrt(Dh) + key-padding bias) v, differentiable in
    q, k and v.

    :param q: (B, H, Tq, Dh) float32 or bfloat16
    :param k, v: (B, H, Tk, Dh) of q's dtype
    :param key_mask: optional (B, Tk) bool, True = attend
    :return: (B, H, Tq, Dh) float32 (float64 for float64 inputs, on the CPU)
    """
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"masked_attention runs on CUDA or the CPU, not {q.device}")
    return _MaskedAttention.apply(q, k, v, key_mask)
