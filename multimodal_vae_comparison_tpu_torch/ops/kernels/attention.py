"""Masked attention forward: CUDA kernel and its plain version.

Counterpart of ``ops/pallas/attention.py`` (``masked_flash_attention``).
The kernel is ``csrc/attention.cu``; :func:`attention_reference` is the same
function in plain PyTorch.  :func:`masked_attention` launches the kernel for
CUDA tensors and takes the plain version only for CPU tensors.  Masking is
additive with ``NEG_INF`` per key, as in the TPU kernel, so a row whose keys
are all masked gets the uniform average of V.  Serving needs no gradient,
so a CUDA input that requires one raises; the training slice adds a
backward as a ``torch.autograd.Function`` (``_flash_bwd`` in the reference).
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from multimodal_vae_comparison_tpu_torch.ops.kernels import _build, telemetry

KERNEL = "attention"
NEG_INF = -1e30
MAX_HEAD_DIM = 128   # csrc/attention.cu MAX_DH
_ROWS = 8            # csrc/attention.cu ROWS: query rows per block
# masked_attention_forward(q, k, v, key_mask, out, B, H, Tq, Tk, Dh, scale, stream)
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_float,
                                                          ctypes.c_void_p]


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        key_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch masked attention, (B, H, Tq, Dh) -> (B, H, Tq, Dh)."""
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(q.shape[-1])
    if key_mask is not None:
        bias = torch.zeros(key_mask.shape, dtype=logits.dtype,
                           device=logits.device).masked_fill(~key_mask, NEG_INF)
        logits = logits + bias[:, None, None, :]
    return torch.einsum("bhqk,bhkd->bhqd", torch.softmax(logits, dim=-1), v)


def _launch(q, k, v, key_mask):
    tensors = (q, k, v) if key_mask is None else (q, k, v, key_mask)
    if any(t.dtype != torch.float32 for t in (q, k, v)):
        raise TypeError("attention kernel takes float32 q, k, v")
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
    if -(-tq // _ROWS) > 65535 or b * h > 2 ** 31 - 1:
        raise ValueError(f"attention kernel grid too large for {tuple(q.shape)}")
    if key_mask is not None and (key_mask.dtype != torch.bool
                                 or key_mask.shape != (b, tk)):
        raise ValueError(f"key_mask must be bool (B, Tk) = {(b, tk)}, got "
                         f"{key_mask.dtype} {tuple(key_mask.shape)}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "the CUDA attention kernel has no backward yet; it comes with "
            "the training slice (an autograd Function mirroring _flash_bwd)")
    fn = _build.function(KERNEL, "masked_attention_forward", _ARGTYPES)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
             None if key_mask is None else key_mask.data_ptr(), out.data_ptr(),
             b, h, tq, tk, dh, 1.0 / math.sqrt(dh), stream)
    _build.check(KERNEL, err)
    telemetry.count_launch(KERNEL)
    return out


def masked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     key_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """softmax(q k^T / sqrt(Dh) + key-padding bias) v.

    :param q: (B, H, Tq, Dh) float32
    :param k, v: (B, H, Tk, Dh) float32
    :param key_mask: optional (B, Tk) bool, True = attend
    :return: (B, H, Tq, Dh) float32
    """
    if q.is_cuda:
        telemetry.record(KERNEL, "cuda")
        return _launch(q, k, v, key_mask)
    if q.device.type != "cpu":
        raise ValueError(f"masked_attention runs on CUDA or the CPU, not {q.device}")
    telemetry.record(KERNEL, "plain")
    return attention_reference(q, k, v, key_mask)
