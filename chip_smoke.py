"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``multimodal_vae_comparison_tpu_torch/
csrc/``, holds each against its plain PyTorch version (forward, and the
backward of its autograd Function) at the main paths' shapes, then drives
three main paths at full width with random weights from a seed:

* serving: the CdSprites+ PoE model through ``InferenceEngine`` and its
  HTTP server;
* training: the flagship POE and the MOE of ``configs/config_cdspritesplus.yml``
  through ``build_model`` -> ``make_optimizer`` -> ``make_train_step``,
  after holding their loss, metrics and every gradient on the card against
  the CPU's plain path;
* video training: the VideoGPTSparse MOE of ``bench.py`` (DReG, K = 5, 32
  latents, (8, 64, 64, 3) clips at bs 8, remat) through the same entry
  points, every sparse-attention call through the block-sparse kernels,
  forward and backward; and the sampling op through its own entry point;
* train from config: CdSprites+ level 1 made at 10,000 samples,
  ``configs/round5/cdl1_r5_poe.yml`` trained for 2 resident epochs through
  ``main`` (the first under ``torch.profiler``) and 1 per-batch epoch,
  ``configs/config_cdspritesplus.yml`` (MOE) for 1 epoch; the run directory
  restored through ``MultimodalVAEInfer`` and served by
  ``serving/server.py --model`` in a process of its own;
* eval from config: each of those runs ends in ``Trainer.test()``, which
  trains the CdSprites+ judge on the card (once; the MOE run loads it),
  scores cross- and joint-coherence from the prior, ex-post and fitted-GMM
  sources and writes ``cdspritesplus_stats.txt``; the eval CLI
  (``eval_cdsprites -p``) gives the same stats from the cache in a process
  of its own, and cross- and prior joint generation agree with the CPU's.

Each path runs with the kernel counts set to 0 just before it and read just
after, and must have launched every kernel it goes through and taken no
plain version.  Then it times the kernels, the engine and the train step,
and times the POE and MOE train steps on the PoE and KL kernels' route
(one launch for the whole subset lattice, one for every modality's KL, and
one for each backward) in turns with the route before it
(``kernel_variants.old_route``), each profiled (``torch.profiler``).
It prints the card's name and power limit, one ``{"kernels": [...]}`` JSON
line, and as its last line ``{"ok": true, "device": {...}}``.  Any failed
phase raises, so the script exits non-zero before the last line; without
CUDA it exits 1 at once.  Imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM data sheet, at a 700 W limit: HBM rate and fp32 rate off the
# tensor cores; bound_ms is the larger of bytes / rate and flop / rate
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOP_PER_S = 67e12
# dense TF32 rate of the tensor cores: the second bound of a kernel that
# runs its fp32 products there as three TF32 products each
PEAK_TF32_FLOP_PER_S = 495e12

ATTN_RTOL, ATTN_ATOL = 2e-4, 2e-5   # as the reference's Pallas attention test
POE_RTOL, POE_ATOL = 1e-5, 1e-6     # elementwise fp32, one reduction over E
# the closed-form PoE backward against autograd's chain through the plain
# version: the two orders differ where mu_e - mu cancels
POE_BWD_RTOL, POE_BWD_ATOL = 1e-5, 1e-5
KL_RTOL, KL_ATOL = 1e-5, 1e-6       # elementwise fp32, one reduction over D
# as the reference's Pallas sparse attention tests: forward, then backward
SPARSE_RTOL, SPARSE_ATOL = 2e-4, 2e-5
SPARSE_BWD_RTOL, SPARSE_BWD_ATOL = 2e-3, 2e-4
# same generator and libm as the plain version; only the fused multiply-add
# of z = mu + scale * eps and the order of one product differ
SAMPLE_RTOL, SAMPLE_ATOL = 1e-5, 1e-6
# training on the card vs the CPU, per parameter: max abs error of the
# gradient <= GRAD_REL * max |grad of the leaf| + GRAD_ATOL (fp32 sums in
# another order, TF32 off); loss and metrics within TRAIN_RTOL
GRAD_REL, GRAD_ATOL, TRAIN_RTOL = 1e-4, 1e-5, 1e-5
TRAIN_BATCH, TRAIN_STEPS, TRAIN_LR = 24, 30, 1e-3
STEP_BATCHES = (24, 256)
# whole model, kernels + cuBLAS/cuDNN in fp32 (TF32 off) vs the CPU's plain
# path: sums are taken in another order through ~12 layers
SLICE_RTOL, SLICE_ATOL = 1e-4, 1e-4

# the video model: VideoGPTSparse + FNN under MOE/DReG, as bench.py builds it
VIDEO_CLIP, VIDEO_LATENTS, VIDEO_K, VIDEO_BATCH = (8, 64, 64, 3), 32, 5, 8
VIDEO_STEPS, VIDEO_LR = 20, 1e-3
SPARSE_BLOCK, SPARSE_STRIDE, VIDEO_TOKENS, VIDEO_HEADS, VIDEO_DH = 128, 4, 2048, 2, 32
# (B, H, T, Dh) of the sparse attention in the encoder (B rows) and in the
# decoder (M * K * B latent rows in one pass)
SPARSE_ENC = (VIDEO_BATCH, VIDEO_HEADS, VIDEO_TOKENS, VIDEO_DH)
SPARSE_DEC = (2 * VIDEO_K * VIDEO_BATCH, VIDEO_HEADS, VIDEO_TOKENS, VIDEO_DH)
# card (fp32) vs the CPU's plain path in float64 on the video model, per
# leaf as a fraction of its max |g|.  The reference is float64 because fp32
# on the CPU is itself 5.7e-2 off it at the decoder's first layer, whose
# gradient is the small remainder of the GroupNorm projections over groups
# of 16,384 elements; the card was 2.3e-3 off.  DReG: log-weights of ~-7e4
# (a bce sum over a whole clip) have an fp32 ulp of 8e-3, so the softmax
# over K that weights every gradient moves by about a percent
VIDEO_GRAD_REL = {"elbo": 1e-2, "dreg": 5e-2}
VIDEO_LOSS_RTOL = 1e-5

PRESENTS = (("mod_1",), ("mod_2",), ("mod_1", "mod_2"))
KERNEL_OF = {"masked_attention": "attention", "poe_lattice": "poe",
             "poe_lattice_backward": "poe_bwd", "kl_normal_std_multi": "kl",
             "kl_normal_std_multi_backward": "kl_bwd", "sample_normal_fused": "sample",
             "strided_block_sparse_attention": "sparse_attention",
             "strided_block_sparse_attention_dq": "sparse_attention_dq",
             "strided_block_sparse_attention_dkv": "sparse_attention_dkv"}
BUCKETS = (1, 8, 32, 128)
SERVE_SIZES = (1, 5, 32, 128, 300)
SEQ_LEN, VOCAB, N_LATENTS = 45, 27, 16

# train from config: the two CdSprites+ configs the port trains, on level 1
# at generate_level's own default count (9,999 train rows, 999 test rows)
FROM_CONFIG = (("POE cdl1_r5_poe", "configs/round5/cdl1_r5_poe.yml", 2),
               ("MOE cdspritesplus", "configs/config_cdspritesplus.yml", 1))
DATA_COUNT = 10000
# objective calls that launch each kernel once per the count given: the
# POE objective runs attention in the text encoder and the text decoder and
# PoE once for the whole subset lattice; the MOE objective the same
# attention and KL once for all modalities.  A train step and a validation
# batch both make one call; a train step also runs one backward of each
PER_OBJECTIVE = {"poe": {"attention": 2, "poe": 1}, "moe": {"attention": 2, "kl": 1}}
PER_BACKWARD = {"poe": {"poe_bwd": 1}, "moe": {"kl_bwd": 1}}
# launches a train step on each route of the PoE and KL kernels: the
# lattice route, and the route before it that kernel_variants.old_route
# keeps (a PoE launch per subset, a KL launch per modality, each backward
# in torch ops)
ROUTE_PER_STEP = {mixing: {"new": {**PER_OBJECTIVE[mixing], **PER_BACKWARD[mixing]}}
                  for mixing in PER_OBJECTIVE}
ROUTE_PER_STEP["poe"]["old"] = {"attention": 2, "poe": 3}
ROUTE_PER_STEP["moe"]["old"] = {"attention": 2, "kl": 2}
# poe_lattice's and kl_normal_std_multi's parity shapes: (experts, lattice
# or None for all subsets, rows of N_LATENTS, p0): serving's one subset of
# both experts, the flagship lattice at bs 24 and 256, PolyMNIST's five
# experts (31 subsets), and lattices without the prior expert
LATTICE_SHAPES = ((2, ((0, 1),), 128, 1.0), (2, None, TRAIN_BATCH, 1.0), (2, None, 256, 1.0),
                  (5, None, TRAIN_BATCH, 1.0), (5, None, 256, 0.0), (3, None, TRAIN_BATCH, 0.0))
# (posteriors, rows, upstream gradient broadcast from a sum's backward)
KL_MULTI_SHAPES = ((1, TRAIN_BATCH, False), (2, TRAIN_BATCH, False), (2, TRAIN_BATCH, True),
                   (2, 256, False), (5, 256, True))
# restored model vs the trainer's, eval mode, same eps
RESTORE_RTOL, RESTORE_ATOL = 1e-5, 1e-5
# the CdSprites+ benchmark (eval/eval_cdsprites.py): judged test rows, the
# ex-post mixture's rows and batch, joint samples per source
EVAL_ROWS, EXPOST_ROWS, EXPOST_BATCH, JOINT_ROWS = 250, 2048, 64, 64
JOINT_SOURCES = ("prior", "expost", "fitted")
# the judge's accuracy on real held-out images (chance is 33 %)
JUDGE_MIN = 90.0
# decoder means of the eval's generation on the card against the CPU's
# plain path, same weights and eps: fp32 through the whole model
EVAL_RTOL, EVAL_ATOL = 1e-4, 1e-4


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def flagship_specs():
    from multimodal_vae_comparison_tpu_torch.models.base import ModalitySpec
    return (
        ModalitySpec(name="mod_1", encoder="CNN2", decoder="CNN",
                     feature_dims=(64, 64, 3), mod_type="image",
                     recon_loss="bce"),
        ModalitySpec(name="mod_2", encoder="TxtTransformer",
                     decoder="TxtTransformer", feature_dims=(SEQ_LEN, VOCAB),
                     mod_type="text", recon_loss="category_ce", has_masks=True),
    )


def training_models():
    """(label, mixing, obj): the flagship of ``__graft_entry__._flagship``
    and the MOE of ``configs/config_cdspritesplus.yml`` (``mixing: moe``,
    ``obj: elbo``, 16 latents, the same two nets), both on
    ``flagship_specs()``."""
    return (("POE flagship", "poe", "elbo"), ("MOE cdspritesplus", "moe", "elbo"))


def torch_batch(raw, device):
    return {name: {"data": torch.from_numpy(mod["data"]).to(device),
                   "masks": None if mod.get("masks") is None
                   else torch.from_numpy(mod["masks"]).to(device)}
            for name, mod in raw.items()}


def numpy_eps(rng: np.random.Generator, mixing: str, n: int):
    """Standard-normal draws in the objective's form: one (1, n, D) per
    subset (POE, 3 subsets), one per modality (MOE)."""
    draws = [rng.standard_normal((1, n, N_LATENTS)).astype(np.float32)
             for _ in range(3 if mixing == "poe" else 2)]
    return draws if mixing == "poe" else dict(zip(("mod_1", "mod_2"), draws))


def eps_to(eps, device):
    if isinstance(eps, dict):
        return {k: torch.from_numpy(v).to(device) for k, v in eps.items()}
    return [torch.from_numpy(v).to(device) for v in eps]


def make_inputs(rng: np.random.Generator, n: int):
    img = rng.random((n, 64, 64, 3), dtype=np.float32)
    txt = np.eye(VOCAB, dtype=np.float32)[rng.integers(0, VOCAB, (n, SEQ_LEN))]
    lengths = rng.integers(1, SEQ_LEN + 1, (n, 1))
    mask = np.arange(SEQ_LEN)[None, :] < lengths
    return {"mod_1": {"data": img}, "mod_2": {"data": txt, "masks": mask}}


def graph_ms(fn, reps: int = 50, replays: int = 10) -> float:
    """Device ms per call of ``fn``: ``reps`` calls captured in one CUDA
    graph, replayed ``replays`` times between CUDA events (no host gaps)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * replays)


def eager_ms(fn, iters: int = 200) -> float:
    """ms per call of ``fn`` issued from Python, between CUDA events."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, flops: float):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FP32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def busy_ms(intervals):
    """Length of the union of (start, end) intervals, in ms."""
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total / 1e3


def attention_inputs(g: torch.Generator, b, h, tq, tk, dh, masked: bool):
    dev = "cuda"
    q = torch.randn(b, h, tq, dh, generator=g, device=dev)
    k = torch.randn(b, h, tk, dh, generator=g, device=dev)
    v = torch.randn(b, h, tk, dh, generator=g, device=dev)
    mask = None
    if masked:
        lengths = torch.randint(1, tk + 1, (b, 1), generator=g, device=dev)
        mask = torch.arange(tk, device=dev)[None, :] < lengths
        mask[0] = False  # one row with every key masked
        mask = mask.contiguous()
    return q, k, v, mask


def phase_parity():
    from multimodal_vae_comparison_tpu_torch.ops.kernels import attention, poe_kernel
    from multimodal_vae_comparison_tpu_torch.ops.kernels import telemetry
    g = torch.Generator(device="cuda").manual_seed(0)
    # (B, H, Tq, Tk, Dh), masked (with one fully masked row), the kernel the
    # launcher picks.  The model's two shapes, then the key counts around a
    # warp's 32 lanes and a lane's 1, 2, 4 and 8 keys, head widths off the
    # 16-byte grid, few heads (split by query rows), and two heads that the
    # resident path cannot hold (Tk > 256; K and V over the shared memory)
    for shape, masked, variant in (((128, 2, 45, 45, 32), True, "resident"),
                                   ((128, 2, 45, 1, 8), False, "resident"),
                                   ((4, 2, 130, 130, 16), True, "resident"),
                                   ((3, 2, 9, 1, 8), True, "resident"),
                                   ((3, 2, 9, 31, 6), True, "resident"),
                                   ((3, 2, 9, 32, 6), False, "resident"),
                                   ((3, 2, 9, 33, 6), True, "resident"),
                                   ((2, 2, 45, 45, 5), False, "resident"),
                                   ((2, 3, 50, 200, 32), True, "resident"),
                                   ((2, 2, 9, 33, 128), False, "resident"),
                                   ((1, 2, 1000, 45, 32), True, "resident"),
                                   ((2, 2, 20, 1000, 16), True, "chunked"),
                                   ((2, 2, 20, 256, 128), True, "chunked")):
        q, k, v, mask = attention_inputs(g, *shape, masked)
        telemetry.reset()
        got = attention.masked_attention(q, k, v, mask)
        took = telemetry.variants()
        want = attention.attention_reference(q, k, v, mask)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        ok = torch.allclose(got, want, rtol=ATTN_RTOL, atol=ATTN_ATOL)
        print(f"parity attention {shape} mask={masked} [{variant}]: max_abs_err={err:.3e} "
              f"(rtol {ATTN_RTOL}, atol {ATTN_ATOL})")
        check(took == {f"attention:{variant}": 1},
              f"attention at {shape} launched {took}, expected the {variant} kernel")
        check(ok, f"attention kernel disagrees with its plain version at {shape}")
        if masked:
            uniform = v[0].mean(dim=1, keepdim=True).expand_as(got[0])
            check(torch.allclose(got[0], uniform, rtol=ATTN_RTOL, atol=ATTN_ATOL),
                  "fully masked row is not the uniform average of V")
    for shape in [(e, 128, 16) for e in (1, 2, 3)] + [(2, 4096, 24), (3, 7, 5)]:
        mus = torch.randn(shape, generator=g, device="cuda")
        scales = torch.rand(shape, generator=g, device="cuda") * 1.7 + 0.3
        got = poe_kernel.poe_fused(mus, scales, 1.0)
        want = poe_kernel.poe_reference(mus, scales, 1.0)
        torch.cuda.synchronize()
        err = max((a - b).abs().max().item() for a, b in zip(got, want))
        ok = all(torch.allclose(a, b, rtol=POE_RTOL, atol=POE_ATOL)
                 for a, b in zip(got, want))
        print(f"parity poe {shape}: max_abs_err={err:.3e} "
              f"(rtol {POE_RTOL}, atol {POE_ATOL})")
        check(ok, f"poe kernel disagrees with its plain version at {shape}")


def phase_kl_parity():
    from multimodal_vae_comparison_tpu_torch.ops.kernels import kl_kernel
    g = torch.Generator(device="cuda").manual_seed(5)
    for shape in ((24, 16), (256, 16), (4096, 24), (7, 5), (2, 3, 16)):
        mu = torch.randn(shape, generator=g, device="cuda")
        scale = torch.rand(shape, generator=g, device="cuda") * 1.7 + 0.3
        got = kl_kernel.kl_normal_std_fused(mu, scale)
        want = kl_kernel.kl_reference(mu, scale)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        print(f"parity kl {shape}: max_abs_err={err:.3e} (rtol {KL_RTOL}, atol {KL_ATOL})")
        check(got.shape == shape[:-1], f"kl output shape {tuple(got.shape)} at {shape}")
        check(torch.allclose(got, want, rtol=KL_RTOL, atol=KL_ATOL),
              f"kl kernel disagrees with its plain version at {shape}")


def _grad_parity(label, fn, plain, inputs, upstream, rtol, atol):
    """Gradients of ``fn`` (kernel forward + the Function's backward) vs
    autograd through ``plain``, same CUDA inputs and upstream gradient."""
    got_in = [x.detach().clone().requires_grad_() for x in inputs]
    want_in = [x.detach().clone().requires_grad_() for x in inputs]
    got = torch.autograd.grad(fn(*got_in), got_in, upstream)
    want = torch.autograd.grad(plain(*want_in), want_in, upstream)
    torch.cuda.synchronize()
    err = max((a - b).abs().max().item() for a, b in zip(got, want))
    # the largest error as a share of what the tolerance allows it
    share = max(((a - b).abs() / (atol + rtol * b.abs())).max().item()
                for a, b in zip(got, want))
    print(f"parity backward {label}: max_abs_err={err:.3e}, {share:.3f} of its limit "
          f"(rtol {rtol}, atol {atol})")
    for a, b in zip(got, want):
        check(bool(torch.isfinite(a).all()), f"non-finite gradient in {label}")
        check(torch.allclose(a, b, rtol=rtol, atol=atol),
              f"backward of {label} disagrees with autograd through its plain version")


def phase_backward_parity():
    from multimodal_vae_comparison_tpu_torch.ops.kernels import (
        attention, kl_kernel, poe_kernel)
    g = torch.Generator(device="cuda").manual_seed(6)
    b = TRAIN_BATCH
    # encoder self-attention at bs 24; decoder cross-attention over the
    # lattice-batched (S*K*B) and MOE (M*K*B) rows
    for shape, masked in (((b, 2, SEQ_LEN, SEQ_LEN, 32), True),
                          ((3 * b, 2, SEQ_LEN, 1, 8), False),
                          ((2 * b, 2, SEQ_LEN, 1, 8), False)):
        q, k, v, mask = attention_inputs(g, *shape, masked)
        d_out = torch.randn(q.shape, generator=g, device="cuda")
        _grad_parity(f"attention {shape} mask={masked}",
                     lambda q_, k_, v_: attention.masked_attention(q_, k_, v_, mask),
                     lambda q_, k_, v_: attention.attention_reference(q_, k_, v_, mask),
                     (q, k, v), d_out, ATTN_RTOL, ATTN_ATOL)
    for shape in [(e, b, N_LATENTS) for e in (1, 2, 3)] + [(2, 4096, 24)]:
        mus = torch.randn(shape, generator=g, device="cuda")
        scales = torch.rand(shape, generator=g, device="cuda") * 1.7 + 0.3
        ups = tuple(torch.randn(shape[1:], generator=g, device="cuda") for _ in range(2))
        _grad_parity(f"poe {shape}", lambda m, s: poe_kernel.poe_fused(m, s, 1.0),
                     lambda m, s: poe_kernel.poe_reference(m, s, 1.0),
                     (mus, scales), ups, POE_RTOL, POE_ATOL)
    for shape in ((24, 16), (256, 16), (4096, 24), (7, 5), (2, 3, 16)):
        mu = torch.randn(shape, generator=g, device="cuda")
        scale = torch.rand(shape, generator=g, device="cuda") * 1.7 + 0.3
        up = torch.randn(shape[:-1], generator=g, device="cuda")
        _grad_parity(f"kl {shape}", kl_kernel.kl_normal_std_fused, kl_kernel.kl_reference,
                     (mu, scale), up, KL_RTOL, KL_ATOL)


def lattice_inputs(g: torch.Generator, m: int, rows: int):
    """M expert (or posterior) means and stddevs of (rows, N_LATENTS)."""
    mus = [torch.randn(rows, N_LATENTS, generator=g, device="cuda") for _ in range(m)]
    scales = [torch.rand(rows, N_LATENTS, generator=g, device="cuda") * 1.7 + 0.3
              for _ in range(m)]
    return mus, scales


def phase_lattice_parity():
    """poe_lattice and kl_normal_std_multi at the shapes of LATTICE_SHAPES
    and KL_MULTI_SHAPES: one forward and one backward launch per call; the
    forwards and the backward kernels against the plain versions (the
    closed forms summed in the same order), and the gradients against
    autograd through the plain forwards."""
    from multimodal_vae_comparison_tpu_torch.ops.fusion import subset_lattice
    from multimodal_vae_comparison_tpu_torch.ops.kernels import kl_kernel, poe_kernel
    from multimodal_vae_comparison_tpu_torch.ops.kernels import telemetry
    g = torch.Generator(device="cuda").manual_seed(7)
    for m, lattice, rows, prior in LATTICE_SHAPES:
        lattice = lattice or subset_lattice(m)
        mus, scales = lattice_inputs(g, m, rows)
        ups = [torch.randn((len(lattice), rows, N_LATENTS), generator=g, device="cuda")
               for _ in range(2)]
        leaves = [x.clone().requires_grad_() for x in mus + scales]
        telemetry.reset()
        mu, scale = poe_kernel.poe_lattice(leaves[:m], leaves[m:], lattice, prior)
        grads = torch.autograd.grad((mu, scale), leaves, ups)
        took = telemetry.launches()
        mu, scale = mu.detach(), scale.detach()
        want = poe_kernel.poe_lattice_reference(mus, scales, lattice, prior)
        want_grads = sum(poe_kernel.poe_lattice_backward_reference(
            mus, scales, mu, scale, *ups, lattice), [])
        torch.cuda.synchronize()
        label = f"poe_lattice M={m} S={len(lattice)} ({rows}, {N_LATENTS}) p0={prior}"
        err = max((a - b).abs().max().item() for a, b in zip((mu, scale), want))
        err_bwd = max((a - b).abs().max().item() for a, b in zip(grads, want_grads))
        print(f"parity {label}: forward max_abs_err={err:.3e}, backward kernel vs the plain "
              f"closed form max_abs_err={err_bwd:.3e} (rtol {POE_RTOL}, atol {POE_ATOL}); "
              f"launches {took}")
        check(took == {"poe": 1, "poe_bwd": 1}, f"{label} launched {took}")
        check(all(torch.allclose(a, b, rtol=POE_RTOL, atol=POE_ATOL)
                  for a, b in zip((mu, scale), want)),
              f"{label}: the forward kernel disagrees with its plain version")
        check(all(torch.allclose(a, b, rtol=POE_RTOL, atol=POE_ATOL)
                  for a, b in zip(grads, want_grads)),
              f"{label}: the backward kernel disagrees with its plain version")
        _grad_parity(label, lambda *x: poe_kernel.poe_lattice(x[:m], x[m:], lattice, prior),
                     lambda *x: poe_kernel.poe_lattice_reference(x[:m], x[m:], lattice, prior),
                     mus + scales, ups, POE_BWD_RTOL, POE_BWD_ATOL)
    for m, rows, broadcast in KL_MULTI_SHAPES:
        mus, scales = lattice_inputs(g, m, rows)
        up = (torch.full((), 0.7, device="cuda").expand(m, rows) if broadcast
              else torch.randn((m, rows), generator=g, device="cuda"))
        label = f"kl_normal_std_multi M={m} ({rows}, {N_LATENTS}) broadcast={broadcast}"
        telemetry.reset()
        got = kl_kernel.kl_normal_std_multi(mus, scales)
        took = telemetry.launches()
        want = kl_kernel.kl_multi_reference(mus, scales)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        print(f"parity {label}: forward max_abs_err={err:.3e} (rtol {KL_RTOL}, atol {KL_ATOL})")
        check(took == {"kl": 1} and got.shape == (m, rows), f"{label}: launched {took}")
        check(torch.allclose(got, want, rtol=KL_RTOL, atol=KL_ATOL),
              f"{label}: the forward kernel disagrees with its plain version")
        telemetry.reset()
        _grad_parity(label, lambda *x: kl_kernel.kl_normal_std_multi(x[:m], x[m:]),
                     lambda *x: kl_kernel.kl_multi_reference(x[:m], x[m:]),
                     mus + scales, up, KL_RTOL, KL_ATOL)
        took = telemetry.launches()
        check(took == {"kl": 1, "kl_bwd": 1}, f"{label} with its backward launched {took}")


def _objective_grads(model, batch, eps):
    loss, metrics = model.objective(batch, eps=eps)
    loss.backward()
    return (loss.item(), {k: v.item() for k, v in metrics.items()},
            {n: (torch.zeros_like(p) if p.grad is None else p.grad).cpu()
             for n, p in model.named_parameters()})


def _worst_leaf(got, want, rel, atol=1e-5):
    """(worst error as a share of its limit rel * max|g| + atol, leaf name)."""
    worst, worst_name = 0.0, None
    for n in want:
        ratio = (got[n] - want[n]).abs().max().item() \
            / (rel * want[n].abs().max().item() + atol)
        if ratio > worst:
            worst, worst_name = ratio, n
    return worst, worst_name


def phase_training_parity():
    """Each training model's objective and gradients on the card (kernels)
    vs the CPU (plain versions): same seeded weights, batch and eps."""
    from multimodal_vae_comparison_tpu_torch.training.trainer import build_model
    rng = np.random.default_rng(11)
    raw = make_inputs(rng, TRAIN_BATCH)
    for label, mixing, obj in training_models():
        eps = numpy_eps(rng, mixing, TRAIN_BATCH)
        out = {}
        for dev in ("cuda", "cpu"):
            model = build_model(flagship_specs(), mixing, N_LATENTS, obj=obj, seed=0,
                                device=dev)
            out[dev] = _objective_grads(model, torch_batch(raw, dev), eps_to(eps, dev))
        (gl, gm, gg), (cl, cm, cg) = out["cuda"], out["cpu"]
        print(f"train parity {label}: loss cuda {gl:.6f} cpu {cl:.6f}; metrics "
              + ", ".join(f"{k} {gm[k]:.6f}/{cm[k]:.6f}" for k in sorted(gm)))
        check(np.isfinite(gl) and abs(gl - cl) <= TRAIN_RTOL * abs(cl),
              f"{label}: loss {gl} on the card vs {cl} on the CPU")
        check(sorted(gm) == sorted(cm), f"{label}: metric keys differ")
        for k in gm:
            check(abs(gm[k] - cm[k]) <= TRAIN_RTOL * abs(cm[k]) + 1e-4,
                  f"{label}: metric {k} {gm[k]} on the card vs {cm[k]} on the CPU")
        worst, worst_name = _worst_leaf(gg, cg, GRAD_REL, GRAD_ATOL)
        print(f"train parity {label}: {len(cg)} gradient leaves, worst error "
              f"{worst:.3f} of its limit at {worst_name} (limit {GRAD_REL} x max|g| "
              f"+ {GRAD_ATOL})")
        check(worst <= 1.0, f"{label}: gradient of {worst_name} differs between "
              "the card and the CPU")


def phase_train():
    """The training main path: 30 steps per model on one fixed batch, then
    one step with grad_accum=2; returns {label: launches per step}."""
    from multimodal_vae_comparison_tpu_torch.ops.kernels import telemetry
    from multimodal_vae_comparison_tpu_torch.training.optim import make_optimizer
    from multimodal_vae_comparison_tpu_torch.training.trainer import (
        build_model, make_train_step)
    batch = torch_batch(make_inputs(np.random.default_rng(12), TRAIN_BATCH), "cuda")
    per_step = {}
    for label, mixing, obj in training_models():
        model = build_model(flagship_specs(), mixing, N_LATENTS, obj=obj, seed=0,
                            device="cuda")
        opt = make_optimizer("adam", TRAIN_LR, model.parameters())
        step = make_train_step(model, opt)
        gen = torch.Generator(device="cuda").manual_seed(13)
        before = telemetry.launches()
        losses = [step(batch, generator=gen)["loss"] for _ in range(TRAIN_STEPS)]
        losses = torch.stack(losses).cpu().numpy()
        after = telemetry.launches()
        per_step[label] = {k: (after[k] - before.get(k, 0)) / TRAIN_STEPS for k in after
                           if after[k] != before.get(k, 0)}
        metrics = make_train_step(model, opt, grad_accum=2)(batch, generator=gen)
        print(f"train {label}: loss {losses[0]:.3f} -> {losses[-1]:.3f} over "
              f"{TRAIN_STEPS} steps (adam, lr {TRAIN_LR}, batch {TRAIN_BATCH}); "
              f"grad_accum=2 step loss {metrics['loss'].item():.3f}; launches per "
              f"step {per_step[label]}")
        check(bool(np.isfinite(losses).all()), f"{label}: non-finite loss")
        check(losses[-5:].mean() < losses[0], f"{label}: the loss did not fall")
        check(all(bool(torch.isfinite(v).all()) for v in metrics.values()),
              f"{label}: non-finite grad_accum=2 metrics")
        want = ROUTE_PER_STEP[mixing]["new"]
        check(per_step[label] == want,
              f"{label}: launched {per_step[label]} a step, expected {want}")
    return per_step


def phase_slice_parity(model_gpu, model_cpu):
    """POE.forward on the card (kernels) vs on the CPU (plain versions),
    same weights, inputs and injected eps."""
    rng = np.random.default_rng(1)
    raw = make_inputs(rng, 32)
    eps = rng.standard_normal((1, 32, N_LATENTS)).astype(np.float32)
    for present in PRESENTS:
        outs = {}
        for model in (model_gpu, model_cpu):
            dev = model.device
            batch = {}
            for name in model.mod_names:
                mod = raw[name] if name in present else {"data": None}
                batch[name] = {
                    "data": None if mod["data"] is None
                    else torch.from_numpy(mod["data"]).to(dev),
                    "masks": None if mod.get("masks") is None
                    else torch.from_numpy(mod["masks"]).to(dev)}
            with torch.inference_mode():
                out = model.forward(batch, present, eps=torch.from_numpy(eps).to(dev))
            outs[dev.type] = {n: mo.decoder_dist.mean.cpu()
                              for n, mo in out.mods.items()}
        for name in model_gpu.mod_names:
            a, b = outs["cuda"][name], outs["cpu"][name]
            err = (a - b).abs().max().item()
            print(f"parity slice present={present} {name}: max_abs_err={err:.3e} "
                  f"(rtol {SLICE_RTOL}, atol {SLICE_ATOL})")
            check(bool(torch.isfinite(a).all()), f"non-finite output {present} {name}")
            check(torch.allclose(a, b, rtol=SLICE_RTOL, atol=SLICE_ATOL),
                  f"card and CPU disagree on {name} for present={present}")


def phase_serve(engine):
    """The main path: InferenceEngine.generate per present set and size."""
    rng = np.random.default_rng(2)
    for present in PRESENTS:
        for n in SERVE_SIZES:
            raw = make_inputs(rng, n)
            inputs = {k: raw[k] for k in present}
            out = engine.generate(inputs, seed=7)
            check(out["mod_1"].shape == (n, 64, 64, 3), f"mod_1 shape {out['mod_1'].shape}")
            check(out["mod_2"].shape == (n, SEQ_LEN, VOCAB), f"mod_2 shape {out['mod_2'].shape}")
            for name, arr in out.items():
                check(bool(np.isfinite(arr).all()), f"non-finite {name} for {present}, n={n}")
            if n == 5:
                again = engine.generate(inputs, seed=7)
                for name in out:
                    check(np.allclose(out[name], again[name], rtol=0, atol=1e-6),
                          f"same seed gave a different {name} for {present}")
        print(f"serve present={present}: sizes {SERVE_SIZES} ok")


def phase_http(engine, handle):
    from http.server import ThreadingHTTPServer
    from multimodal_vae_comparison_tpu_torch.serving.server import make_handler
    server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(engine, handle))
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        health = json.load(urllib.request.urlopen(
            f"http://127.0.0.1:{port}/health", timeout=60))
        check(health["status"] == "ok" and health["modalities"] == ["mod_1", "mod_2"],
              f"/health said {health}")
        results, errors = [None] * 6, []

        def hit(i):
            raw = make_inputs(np.random.default_rng(100 + i), 8)
            req = {"inputs": {k: {kk: vv.tolist() for kk, vv in v.items()}
                              for k, v in raw.items()}, "seed": i}
            try:
                resp = urllib.request.urlopen(urllib.request.Request(
                    f"http://127.0.0.1:{port}/generate",
                    data=json.dumps(req).encode(),
                    headers={"Content-Type": "application/json"}), timeout=120)
                results[i] = json.load(resp)
            except (urllib.error.URLError, OSError, ValueError) as e:
                errors.append(repr(e))

        threads = [threading.Thread(target=hit, args=(i,)) for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=180)
        check(not errors and all(not t.is_alive() for t in threads),
              f"concurrent /generate failed: {errors}")
        for r in results:
            check(np.asarray(r["mod_1"]).shape == (8, 64, 64, 3)
                  and np.asarray(r["mod_2"]).shape == (8, SEQ_LEN, VOCAB),
                  "bad /generate response shape")
        try:
            urllib.request.urlopen(urllib.request.Request(
                f"http://127.0.0.1:{port}/generate",
                data=json.dumps({"inputs": {"mod_9": {"data": [[0.0]]}}}).encode()),
                timeout=60)
            check(False, "unknown modality did not give 400")
        except urllib.error.HTTPError as e:
            check(e.code == 400, f"unknown modality gave {e.code}, not 400")
        print("http: /health ok, 6 concurrent /generate x 8 rows ok, 400 path ok")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)


def phase_kernel_route_times(card):
    """poe_lattice and kl_normal_std_multi, forward and backward kernels, at
    the main path's shapes (the flagship lattice, M 2 and S 3, and the MOE's
    2 posteriors, bs 24): device ms graphed and eager, the plain versions,
    the library call where one exists, the bound, and the same work on the
    route before these kernels (kernel_variants.old_route: a launch per
    subset or modality with two stacks, each backward in torch ops)."""
    import types
    from torch.distributions import Normal, kl_divergence
    import kernel_variants
    from multimodal_vae_comparison_tpu_torch.ops.fusion import subset_lattice
    from multimodal_vae_comparison_tpu_torch.ops.kernels import kl_kernel, poe_kernel
    g = torch.Generator(device="cuda").manual_seed(14)
    rows, b, d = [], TRAIN_BATCH, N_LATENTS
    n = b * d
    poe_src = "multimodal_vae_comparison_tpu_torch/csrc/poe.cu"
    kl_src = "multimodal_vae_comparison_tpu_torch/csrc/kl.cu"
    ref = "multimodal_vae_comparison_tpu/ops/pallas"
    # -- PoE over the flagship lattice
    m, lattice = 2, subset_lattice(2)
    s = len(lattice)
    masks = poe_kernel.lattice_masks(lattice, m)
    mus, scales = lattice_inputs(g, m, b)
    ups = [torch.randn((s, b, d), generator=g, device="cuda") for _ in range(2)]
    old_poe = kernel_variants._per_subset_poe()
    stacked = [(torch.stack([mus[e] for e in sub]), torch.stack([scales[e] for e in sub]))
               for sub in lattice]

    def fwd():
        return poe_kernel.poe_lattice(mus, scales, lattice, 1.0)

    def old_fwd():
        return [poe_kernel.poe_fused(torch.stack([mus[e] for e in sub]),
                                     torch.stack([scales[e] for e in sub]), 1.0)
                for sub in lattice]

    mu, scale = fwd()
    old_out = [old_poe.apply(*st, 1.0) for st in stacked]
    old_ctx = [types.SimpleNamespace(saved_tensors=(*st, *o)) for st, o in zip(stacked, old_out)]

    def bwd():
        return poe_kernel._launch_backward(mus, scales, masks, mu, scale, *ups)

    def plain_bwd():
        return poe_kernel.poe_lattice_backward_reference(mus, scales, mu, scale, *ups, lattice)

    def old_bwd():
        # each subset's torch-op backward, then autograd's sum per expert
        d_mus = [torch.zeros_like(x) for x in mus]
        d_scales = [torch.zeros_like(x) for x in scales]
        for k, (sub, ctx) in enumerate(zip(lattice, old_ctx)):
            dm, ds, _ = old_poe.backward(ctx, ups[0][k], ups[1][k])
            for j, e in enumerate(sub):
                d_mus[e] = d_mus[e] + dm[j]
                d_scales[e] = d_scales[e] + ds[j]
        return d_mus, d_scales

    serve = [torch.randn(2, 128, d, generator=g, device="cuda"),
             torch.rand(2, 128, d, generator=g, device="cuda") + 0.3]
    m5, s5 = lattice_inputs(g, 5, b)
    lattice5 = subset_lattice(5)
    times = {
        "fwd": graph_ms(fwd), "fwd_eager": eager_ms(fwd),
        "fwd_plain": graph_ms(lambda: poe_kernel.poe_lattice_reference(mus, scales, lattice, 1.0)),
        "fwd_old": graph_ms(old_fwd), "fwd_old_eager": eager_ms(old_fwd),
        "fwd_serving": graph_ms(lambda: poe_kernel.poe_fused(*serve, 1.0)),
        "fwd_m5": graph_ms(lambda: poe_kernel.poe_lattice(m5, s5, lattice5, 1.0)),
        "bwd": graph_ms(bwd), "bwd_eager": eager_ms(bwd), "bwd_plain": graph_ms(plain_bwd),
        "bwd_old": graph_ms(old_bwd), "bwd_old_eager": eager_ms(old_bwd)}
    times["fwd_again"], times["bwd_again"] = graph_ms(fwd), graph_ms(bwd)
    want = poe_kernel.poe_lattice_reference(mus, scales, lattice, 1.0)
    err_fwd = max((a - w).abs().max().item() for a, w in zip((mu, scale), want))
    err_bwd = max((a - w).abs().max().item()
                  for a, w in zip(sum(map(list, bwd()), []), sum(plain_bwd(), [])))
    sizes = sum(len(sub) for sub in lattice)
    # forward: per element a precision and a weighted mean per expert (4
    # operations), per subset two sums, the prior, a division, a reciprocal
    # and a square root; backward: per expert 6 operations, per subset 5,
    # per (subset, expert) pair 7
    fwd_bound = bound_ms(4 * (2 * m * n + 2 * s * n), n * (4 * m + 2 * sizes + 4 * s))
    bwd_bound = bound_ms(4 * (2 * m * n + 4 * s * n + 2 * m * n), n * (6 * m + 5 * s + 7 * sizes))
    at = f"flagship lattice M={m} S={s} ({b}, {d})"
    common = {"route": "cuda", "source": poe_src, "library_ms": None,
              "library_is": "none: no single PyTorch call takes a product of Gaussian experts"}
    rows.append({"name": "poe_lattice", "at": at, **common,
                 "replaces": f"{ref}/poe_kernel.py:48", "max_abs_err": err_fwd,
                 "ms": times["fwd"], "ms_again": times["fwd_again"],
                 "plain_ms": times["fwd_plain"], "bound_ms": fwd_bound[0],
                 "bound_by": fwd_bound[1], "eager_ms": times["fwd_eager"],
                 "old_route_ms": times["fwd_old"], "old_route_eager_ms": times["fwd_old_eager"],
                 "serving_one_subset_ms": times["fwd_serving"],
                 "m5_lattice_31_subsets_ms": times["fwd_m5"]})
    rows.append({"name": "poe_lattice_backward", "at": at, **common,
                 "replaces": f"{ref}/poe_kernel.py:124 (_poe_bwd, the VJP of :48)",
                 "max_abs_err": err_bwd, "ms": times["bwd"], "ms_again": times["bwd_again"],
                 "plain_ms": times["bwd_plain"], "bound_ms": bwd_bound[0],
                 "bound_by": bwd_bound[1], "eager_ms": times["bwd_eager"],
                 "old_route_ms": times["bwd_old"], "old_route_eager_ms": times["bwd_old_eager"]})
    print(f"time poe_lattice [{at}]: forward kernel {times['fwd']:.5f} and "
          f"{times['fwd_again']:.5f} ms (eager {times['fwd_eager']:.5f}), old route (a launch "
          f"and two stacks per subset) {times['fwd_old']:.5f} ms (eager "
          f"{times['fwd_old_eager']:.5f}); serving's one subset (2, 128, {d}) "
          f"{times['fwd_serving']:.5f} ms; M=5, 31 subsets {times['fwd_m5']:.5f} ms; backward "
          f"kernel {times['bwd']:.5f} and {times['bwd_again']:.5f} ms (eager "
          f"{times['bwd_eager']:.5f}), old route (torch ops per subset, summed) "
          f"{times['bwd_old']:.5f} ms (eager {times['bwd_old_eager']:.5f}); bounds "
          f"{fwd_bound[0]:.7f} and {bwd_bound[0]:.7f} ms on {card}")
    # -- KL of the MOE's two posteriors
    mus, scales = lattice_inputs(g, 2, b)
    up = torch.randn((2, b), generator=g, device="cuda")
    unit = Normal(torch.zeros((), device="cuda"), torch.ones((), device="cuda"),
                  validate_args=False)
    mu_st, scale_st = torch.stack(mus), torch.stack(scales)

    # the library's KL: torch.distributions without its argument checks
    # (they read the device on the host and cannot be graph-captured), on
    # the posteriors stacked beforehand
    def library():
        return kl_divergence(Normal(mu_st, scale_st, validate_args=False), unit).sum(-1)

    def kl_fwd():
        return kl_kernel.kl_normal_std_multi(mus, scales)

    def kl_old_fwd():
        return torch.stack([kl_kernel.kl_normal_std_fused(a, c) for a, c in zip(mus, scales)])

    def kl_bwd():
        return kl_kernel._launch_backward(mus, scales, up)

    def kl_plain_bwd():
        return ([up[k][:, None] * a for k, a in enumerate(mus)],
                [up[k][:, None] * (c - 1.0 / c) for k, c in enumerate(scales)])

    kt = {"fwd": graph_ms(kl_fwd), "fwd_eager": eager_ms(kl_fwd),
          "fwd_plain": graph_ms(lambda: kl_kernel.kl_multi_reference(mus, scales)),
          "fwd_old": graph_ms(kl_old_fwd), "fwd_old_eager": eager_ms(kl_old_fwd),
          "fwd_library": graph_ms(library),
          "fwd_library_eager": eager_ms(lambda: kl_divergence(
              Normal(mu_st, scale_st), Normal(0.0, 1.0)).sum(-1)),
          "bwd": graph_ms(kl_bwd), "bwd_eager": eager_ms(kl_bwd),
          "bwd_plain": graph_ms(kl_plain_bwd)}
    kt["fwd_again"], kt["bwd_again"] = graph_ms(kl_fwd), graph_ms(kl_bwd)
    want = kl_kernel.kl_multi_reference(mus, scales)
    err_fwd = (kl_fwd() - want).abs().max().item()
    lib_err = (library() - want).abs().max().item()
    check(lib_err <= 1e-3, f"the library's KL differs from the plain version by {lib_err}")
    err_bwd = max((a - w).abs().max().item()
                  for a, w in zip(sum(map(list, kl_bwd()), []), sum(kl_plain_bwd(), [])))
    kl_fwd_bound = bound_ms(4 * (2 * 2 * n + 2 * b), 2 * 8 * n)
    kl_bwd_bound = bound_ms(4 * (2 * 2 * n + 2 * b + 2 * 2 * n), 2 * 4 * n)
    at = f"M=2 ({b}, {d})"
    common = {"route": "cuda", "source": kl_src, "at": at}
    rows.append({"name": "kl_normal_std_multi", **common,
                 "replaces": f"{ref}/kl_kernel.py:30", "max_abs_err": err_fwd,
                 "ms": kt["fwd"], "ms_again": kt["fwd_again"], "plain_ms": kt["fwd_plain"],
                 "bound_ms": kl_fwd_bound[0], "bound_by": kl_fwd_bound[1],
                 "library_ms": kt["fwd_library"], "eager_ms": kt["fwd_eager"],
                 "library_is": "torch.distributions.kl.kl_divergence(Normal(mu, scale), "
                 "Normal(0, 1)).sum(-1) on the posteriors stacked beforehand, "
                 "validate_args=False, graphed",
                 "library_eager_ms": kt["fwd_library_eager"],
                 "old_route_ms": kt["fwd_old"], "old_route_eager_ms": kt["fwd_old_eager"]})
    rows.append({"name": "kl_normal_std_multi_backward", **common,
                 "replaces": f"{ref}/kl_kernel.py:72 (_kl_bwd, the VJP of :30)",
                 "max_abs_err": err_bwd, "ms": kt["bwd"], "ms_again": kt["bwd_again"],
                 "plain_ms": kt["bwd_plain"], "bound_ms": kl_bwd_bound[0],
                 "bound_by": kl_bwd_bound[1], "library_ms": None,
                 "library_is": "none: no single PyTorch call gives (g mu, g (scale - 1/scale))",
                 "eager_ms": kt["bwd_eager"],
                 "old_route_ms": kt["bwd_plain"],
                 "old_route_is": "the same torch ops as the plain version, one set per modality"})
    print(f"time kl_normal_std_multi [{at}]: forward kernel {kt['fwd']:.5f} and "
          f"{kt['fwd_again']:.5f} ms (eager {kt['fwd_eager']:.5f}), old route (a launch per "
          f"modality and a stack) {kt['fwd_old']:.5f} ms (eager {kt['fwd_old_eager']:.5f}), "
          f"library {kt['fwd_library']:.5f} ms (eager with argument checks "
          f"{kt['fwd_library_eager']:.5f}); backward kernel {kt['bwd']:.5f} and "
          f"{kt['bwd_again']:.5f} ms (eager {kt['bwd_eager']:.5f}), torch ops "
          f"{kt['bwd_plain']:.5f} ms; bounds {kl_fwd_bound[0]:.7f} and {kl_bwd_bound[0]:.7f} ms "
          f"on {card}")
    return rows


def phase_attention_backward_times(card):
    """The attention Function's backward at the encoder's training shape."""
    import types
    import torch.nn.functional as F
    from multimodal_vae_comparison_tpu_torch.ops.kernels import attention
    g = torch.Generator(device="cuda").manual_seed(19)
    # recompute + five products, device time back to back
    q, k, v, mask = attention_inputs(g, TRAIN_BATCH, 2, SEQ_LEN, SEQ_LEN, 32, True)
    d_out = torch.randn(q.shape, generator=g, device="cuda")
    ctx = types.SimpleNamespace(saved_tensors=(q, k, v, mask))
    bwd = attention._MaskedAttention.backward
    bwd_ms = graph_ms(lambda: bwd(ctx, d_out))
    bwd_eager = eager_ms(lambda: bwd(ctx, d_out))
    # five batched products (s, dv, dp, dq, dk); q, k, v, d_out and the mask
    # read, dq, dk, dv written
    cells = TRAIN_BATCH * 2 * SEQ_LEN * SEQ_LEN
    bwd_bound, bwd_by = bound_ms(4 * 7 * q.numel() + mask.numel(), 5 * 2 * cells * 32)
    # the library's backward on the same inputs and key-padding mask (its
    # one fully masked row comes out NaN there, the uniform average here)
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    sdpa_out = F.scaled_dot_product_attention(*leaves, attn_mask=mask[:, None, None, :])
    bwd_lib = eager_ms(lambda: torch.autograd.grad(sdpa_out, leaves, d_out, retain_graph=True))
    del leaves, sdpa_out
    print(f"time attention backward [({TRAIN_BATCH}, 2, {SEQ_LEN}, {SEQ_LEN}, 32) masked]: "
          f"{bwd_ms:.5f} ms (eager {bwd_eager:.5f}), SDPA's backward {bwd_lib:.5f} ms (eager), "
          f"bound {bwd_bound:.6f} ms ({bwd_by}) on {card}")
    return {"attention_bwd_ms": bwd_ms, "attention_bwd_eager_ms": bwd_eager,
            "attention_bwd_bound_ms": bwd_bound, "attention_bwd_bound_by": bwd_by,
            "attention_bwd_library_ms": bwd_lib,
            "attention_bwd_library_is": "torch.autograd.grad of "
            "F.scaled_dot_product_attention(q, k, v, attn_mask=key padding), eager"}

PROFILE_SYMBOLS = {"masked_attention": "masked_attention_", "poe_lattice": "poe_lattice_fwd",
                   "poe_lattice_backward": "poe_lattice_bwd",
                   "kl_normal_std_multi": "kl_std_multi_fwd",
                   "kl_normal_std_multi_backward": "kl_std_multi_bwd",
                   "sparse_fwd": "sparse_fwd", "sparse_dq": "sparse_dq",
                   "sparse_dkv": "sparse_dkv"}


def profile_steps(label, step, batch, gen, n, steps, card):
    """``steps`` warm train steps under ``torch.profiler``; one JSON line with
    host wall ms, device kernel ms, the device's busy share (union of kernel
    intervals over the wall time), launches per step, the port's kernels'
    device ms and the kernels that take the most device time."""
    import collections
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step(batch, generator=gen)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device events less the ranges that annotate them: the optimizer's
    # "Optimizer.step#..." span lies on the device timeline too
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and not e.name.startswith("Optimizer.")]
    check(bool(kernels), "the profiler recorded no CUDA kernel")
    per_name = collections.Counter()
    for e in kernels:
        per_name[e.name] += e.time_range.elapsed_us()
    busy = busy_ms([(e.time_range.start, e.time_range.end) for e in kernels])
    port_ms = {k: sum(us for name, us in per_name.items() if sym in name) / 1e3 / steps
               for k, sym in PROFILE_SYMBOLS.items()}
    numbers = {
        "model": label, "batch": n, "steps": steps,
        "wall_ms_per_step": wall_ms / steps,
        "kernel_ms_per_step": sum(per_name.values()) / 1e3 / steps,
        "device_busy_share": busy / wall_ms,
        "kernels_per_step": len(kernels) / steps,
        "port_kernels_ms_per_step": {k: ms for k, ms in port_ms.items() if ms},
        "top_kernels_ms_per_step": {
            name[:80]: us / 1e3 / steps for name, us in per_name.most_common(5)},
        "card": card}
    print("profile train step " + json.dumps(numbers))
    return numbers


def phase_route_times(card, blocks: int = 6, steps: int = 10, profiled: int = 10):
    """The POE and MOE train steps at each batch size on the PoE and KL
    kernels' route and on the route before it (kernel_variants.old_route):
    ``blocks`` blocks of ``steps`` steps on each route, in ABBA turns (new,
    old, old, new, ...) so that a drift of the host's speed cancels; the p50
    host ms over all of a route's steps and each block's p50; the port's
    launches a step checked exactly on both routes; then each route profiled
    over ``profiled`` steps for its kernels and device ms a step."""
    import kernel_variants
    from multimodal_vae_comparison_tpu_torch.ops.kernels import telemetry
    from multimodal_vae_comparison_tpu_torch.training.optim import make_optimizer
    from multimodal_vae_comparison_tpu_torch.training.trainer import (
        build_model, make_train_step)
    order = [r for _ in range(blocks // 2) for r in ("new", "old", "old", "new")]
    results = []
    for label, mixing, obj in training_models():
        model = build_model(flagship_specs(), mixing, N_LATENTS, obj=obj, seed=0,
                            device="cuda")
        step = make_train_step(model, make_optimizer("adam", TRAIN_LR, model.parameters()))
        gen = torch.Generator(device="cuda").manual_seed(15)
        for n in STEP_BATCHES:
            batch = torch_batch(make_inputs(np.random.default_rng(16), n), "cuda")
            for _ in range(3):
                step(batch, generator=gen)
            lat = {"new": [], "old": []}
            block_p50 = {"new": [], "old": []}
            for route in order:
                restore = kernel_variants.old_route(model) if route == "old" else None
                step(batch, generator=gen)       # the route's first step, untimed
                torch.cuda.synchronize()
                telemetry.reset()
                block = []
                for _ in range(steps):
                    t0 = time.perf_counter()
                    step(batch, generator=gen)
                    torch.cuda.synchronize()
                    block.append((time.perf_counter() - t0) * 1e3)
                launches = telemetry.launches()
                if restore:
                    restore()
                want = {k: v * steps for k, v in ROUTE_PER_STEP[mixing][route].items()}
                check(launches == want, f"{label} bs {n}, {route} route: launched "
                      f"{launches} in {steps} steps, expected {want}")
                lat[route] += block
                block_p50[route].append(statistics.median(block))
            prof = {}
            for route in ("new", "old"):
                restore = kernel_variants.old_route(model) if route == "old" else None
                prof[route] = profile_steps(f"{label} [{route} route]", step, batch, gen, n,
                                            profiled, card)
                if restore:
                    restore()
            p50 = {r: statistics.median(lat[r]) for r in lat}
            row = {"model": label, "batch": n, "card": card, "steps_per_route": len(lat["new"]),
                   **{f"{r}_p50_ms": p50[r] for r in p50},
                   **{f"{r}_block_p50_ms": block_p50[r] for r in block_p50},
                   **{f"{r}_kernels_per_step": prof[r]["kernels_per_step"] for r in prof},
                   **{f"{r}_kernel_ms_per_step": prof[r]["kernel_ms_per_step"] for r in prof},
                   **{f"{r}_port_launches_per_step": ROUTE_PER_STEP[mixing][r] for r in prof}}
            results.append(row)
            print(f"time train step {label} batch {n}: p50 new route {p50['new']:.3f} ms, old "
                  f"route {p50['old']:.3f} ms ({len(lat['new'])} steps each in ABBA blocks of "
                  f"{steps}; block p50s new {[round(x, 3) for x in block_p50['new']]}, old "
                  f"{[round(x, 3) for x in block_p50['old']]}); kernels a step "
                  f"{prof['new']['kernels_per_step']:.1f} vs {prof['old']['kernels_per_step']:.1f}"
                  f", device kernel ms a step {prof['new']['kernel_ms_per_step']:.4f} vs "
                  f"{prof['old']['kernel_ms_per_step']:.4f} on {card}")
    print("route times " + json.dumps(results))
    return results


def phase_times(engine, card):
    import ctypes
    import math
    import torch.nn.functional as F
    from multimodal_vae_comparison_tpu_torch.ops.kernels import _build, attention
    g = torch.Generator(device="cuda").manual_seed(3)
    rows = []
    # two yardsticks that csrc/attention.cu exports and the port never calls:
    # an empty kernel with the attention launch's grid, block and shared
    # memory, and the chunked kernel at a shape the launcher gives the
    # resident one
    empty = _build.function("attention", "empty_launch",
                            [ctypes.c_int] * 5 + [ctypes.c_void_p])
    chunked = _build.function("attention", "masked_attention_forward_chunked",
                              [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                              + [ctypes.c_float, ctypes.c_void_p])
    # attention at bucket 128: encoder self-attention (masked), decoder
    # cross-attention (Tk = 1, no mask)
    for label, shape, masked in (("encoder", (128, 2, 45, 45, 32), True),
                                 ("decoder", (128, 2, 45, 1, 8), False)):
        q, k, v, mask = attention_inputs(g, *shape, masked)
        b, h, tq, tk, dh = shape
        sdpa_mask = None if mask is None else mask[:, None, None, :]
        kern = graph_ms(lambda: attention.masked_attention(q, k, v, mask))
        plain = graph_ms(lambda: attention.attention_reference(q, k, v, mask))
        lib = graph_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=sdpa_mask))
        kern_eager = eager_ms(lambda: attention.masked_attention(q, k, v, mask))
        stream = torch.cuda.current_stream

        def launch_empty():
            _build.check("attention", empty(b, h, tq, tk, dh, stream().cuda_stream))

        scratch = torch.empty_like(q)

        def launch_chunked():
            _build.check("attention", chunked(
                q.data_ptr(), k.data_ptr(), v.data_ptr(),
                None if mask is None else mask.data_ptr(), scratch.data_ptr(),
                b, h, tq, tk, dh, 1.0 / math.sqrt(dh), stream().cuda_stream))

        floor = graph_ms(launch_empty)
        chunked_ms = graph_ms(launch_chunked)
        check(torch.allclose(scratch, attention.attention_reference(q, k, v, mask),
                             rtol=ATTN_RTOL, atol=ATTN_ATOL),
              f"the chunked attention kernel disagrees with the plain version at {shape}")
        kern_again = graph_ms(lambda: attention.masked_attention(q, k, v, mask))
        print(f"time masked_attention [{label} {shape}]: resident kernel {kern:.5f} and "
              f"{kern_again:.5f} ms, chunked kernel {chunked_ms:.5f} ms, SDPA {lib:.5f} ms, an "
              f"empty kernel launched the same way {floor:.5f} ms on {card}")
        nbytes = 4 * (2 * b * h * tq * dh + 2 * b * h * tk * dh) + (b * tk if masked else 0)
        flops = 4 * b * h * tq * tk * dh + 4 * b * h * tq * tk
        bound, by = bound_ms(nbytes, flops)
        err = (attention.masked_attention(q, k, v, mask)
               - attention.attention_reference(q, k, v, mask)).abs().max().item()
        rows.append({"name": "masked_attention", "at": f"{label} {shape}",
                     "route": "cuda",
                     "source": "multimodal_vae_comparison_tpu_torch/csrc/attention.cu",
                     "replaces": "multimodal_vae_comparison_tpu/ops/pallas/attention.py:77",
                     "max_abs_err": err,
                     "ms": kern, "plain_ms": plain, "bound_ms": bound, "bound_by": by,
                     "library_ms": lib, "eager_ms": kern_eager,
                     "empty_launch_ms": floor, "chunked_kernel_ms": chunked_ms})
    for r in rows:
        print(f"time {r['name']} [{r['at']}]: kernel {r['ms']:.5f} ms (eager "
              f"{r['eager_ms']:.5f}), plain {r['plain_ms']:.5f} ms, library "
              f"{'n/a' if r['library_ms'] is None else format(r['library_ms'], '.5f')} ms, "
              f"bound {r['bound_ms']:.6f} ms ({r['bound_by']}) on {card}")
    rng = np.random.default_rng(4)
    for bucket in BUCKETS:
        inputs = make_inputs(rng, bucket)
        engine.generate(inputs, seed=0)
        lat = []
        for _ in range(20):
            t0 = time.perf_counter()
            engine.generate(inputs, seed=0)
            lat.append((time.perf_counter() - t0) * 1e3)
        print(f"time generate both modalities N={bucket}: p50 {statistics.median(lat):.3f} ms, "
              f"min {min(lat):.3f} ms over 20 on {card}")
    return rows


def video_specs():
    """The specs of ``bench.py``'s ``videogpt_sparseattn_T2048_moe_dreg_k5_bs8``."""
    from multimodal_vae_comparison_tpu_torch.models.base import ModalitySpec
    return (
        ModalitySpec(name="mod_1", encoder="VideoGPTSparse", decoder="VideoGPTSparse",
                     feature_dims=VIDEO_CLIP, mod_type="frames", recon_loss="bce"),
        ModalitySpec(name="mod_2", encoder="FNN", decoder="FNN", feature_dims=(9,),
                     mod_type="actions", recon_loss="bce"),
    )


def video_inputs(rng: np.random.Generator, n: int, k: int):
    """(batch, eps) as numpy: uniform clips and action vectors, and one
    (k, n, D) standard-normal draw per modality."""
    raw = {"mod_1": {"data": rng.random((n,) + VIDEO_CLIP, dtype=np.float32)},
           "mod_2": {"data": rng.random((n, 9), dtype=np.float32)}}
    eps = {name: rng.standard_normal((k, n, VIDEO_LATENTS)).astype(np.float32)
           for name in raw}
    return raw, eps


def sparse_work(t: int, block: int, stride: int):
    """(live block pairs, visible (query, key) pairs) per head: what the
    pattern needs, the diagonal blocks counted as their lower triangle.
    Query block i sees itself and the i // stride earlier blocks j with
    j = i (mod stride)."""
    nq = t // block
    pairs = sum(1 + i // stride for i in range(nq))
    return pairs, (pairs - nq) * block * block + nq * block * (block + 1) // 2


def phase_sparse_parity():
    """Forward (out, lse) and backward (dq, dk, dv vs autograd through the
    plain version) at the encoder's and decoder's shapes and a few odd ones,
    through the public entry, each of the three launchers taking the row's
    kernel; the forward's launcher gives the lse, which the entry keeps to
    itself, and reruns of each launcher are bit-identical."""
    from multimodal_vae_comparison_tpu_torch.ops.kernels import sparse_attention as sp
    from multimodal_vae_comparison_tpu_torch.ops.kernels import telemetry
    g = torch.Generator(device="cuda").manual_seed(20)
    worst = 0.0
    # (B, H, T, Dh), block, stride, the kernel the three launchers pick:
    # the model's two shapes; block 16, 64 and 128 at stride 1 and 4 and Dh
    # 8, 32 and 64 on the tensor cores, with T = one block, a block that is
    # not a multiple of 32 and a Dh that is padded; and the shapes that fall
    # to the FMA kernel (block 8, Dh off the 16-byte grid)
    for shape, block, stride, variant in (
            (SPARSE_ENC, SPARSE_BLOCK, SPARSE_STRIDE, "mma"),
            (SPARSE_DEC, SPARSE_BLOCK, SPARSE_STRIDE, "mma"),
            ((1, 2, 128, 64), 16, 4, "mma"), ((3, 1, 256, 32), 128, 1, "mma"),
            ((2, 2, 128, 32), 128, 4, "mma"), ((2, 2, 256, 8), 64, 1, "mma"),
            ((2, 1, 512, 16), 64, 4, "mma"), ((1, 2, 1024, 64), 128, 4, "mma"),
            ((2, 2, 320, 32), 80, 2, "mma"), ((1, 2, 160, 12), 16, 3, "mma"),
            ((2, 2, 64, 8, ), 8, 2, "fma"), ((2, 1, 96, 8), 8, 3, "fma"),
            ((2, 3, 40, 12), 8, 3, "fma"), ((2, 2, 96, 6), 16, 2, "fma")):
        q, k, v, d_out = (torch.randn(shape, generator=g, device="cuda") for _ in range(4))
        telemetry.reset()
        out = sp.strided_block_sparse_attention(q, k, v, block, stride)
        took = telemetry.variants()
        check(took == {f"sparse_attention:{variant}": 1},
              f"sparse forward at {shape} launched {took}, expected the {variant} kernel")
        _, lse = sp._launch_forward(q, k, v, block, stride)
        want = sp.sparse_attention_reference(q, k, v, block, stride)
        visible = sp.visibility(shape[2], block, stride, "cuda")
        logits = (q @ k.transpose(-1, -2)) / shape[3] ** 0.5
        want_lse = torch.logsumexp(logits.masked_fill_(~visible, float("-inf")), dim=-1)
        del logits
        torch.cuda.synchronize()
        err = max((out - want).abs().max().item(), (lse - want_lse).abs().max().item())
        worst = max(worst, err)
        # the largest error as a share of what the tolerance allows it
        share = ((out - want).abs() / (SPARSE_ATOL + SPARSE_RTOL * want.abs())).max().item()
        print(f"parity sparse attention {shape} block {block} stride {stride} [{variant}]: "
              f"forward max_abs_err={err:.3e}, {share:.3f} of its limit (rtol {SPARSE_RTOL}, "
              f"atol {SPARSE_ATOL})")
        check(torch.allclose(out, want, rtol=SPARSE_RTOL, atol=SPARSE_ATOL)
              and torch.allclose(lse, want_lse, rtol=SPARSE_RTOL, atol=SPARSE_ATOL),
              f"sparse forward disagrees with its plain version at {shape}")
        again, lse_again = sp._launch_forward(q, k, v, block, stride)
        check(torch.equal(again, out) and torch.equal(lse_again, lse),
              f"two runs of the sparse forward differ at {shape}")
        args = (q, k, v, d_out, lse, (d_out * out).sum(-1), block, stride)
        telemetry.reset()
        runs = [(sp._launch_dq(*args),) + sp._launch_dkv(*args) for _ in range(2)]
        took = telemetry.variants()
        check(took == {f"sparse_attention_dq:{variant}": 2,
                       f"sparse_attention_dkv:{variant}": 2},
              f"sparse backward at {shape} launched {took}, expected the {variant} kernels")
        check(all(torch.equal(a, b) for a, b in zip(*runs)),
              f"two runs of the sparse backward differ at {shape}")
        del out, lse, want, want_lse, again, lse_again, args, runs
        telemetry.reset()
        _grad_parity(f"sparse attention {shape} block {block} stride {stride} [{variant}]",
                     lambda q_, k_, v_: sp.strided_block_sparse_attention(
                         q_, k_, v_, block, stride),
                     lambda q_, k_, v_: sp.sparse_attention_reference(
                         q_, k_, v_, block, stride),
                     (q, k, v), d_out, SPARSE_BWD_RTOL, SPARSE_BWD_ATOL)
        took = telemetry.variants()
        check(took == {f"sparse_attention:{variant}": 1, f"sparse_attention_dq:{variant}": 1,
                       f"sparse_attention_dkv:{variant}": 1},
              f"sparse attention with its backward at {shape} launched {took}")
    return worst


def phase_sample_parity():
    """z (the public entry's) and eps (the launcher's: the entry keeps it
    for its backward) against the plain version element by element; moments
    of eps; seeds; the backward."""
    from multimodal_vae_comparison_tpu_torch.ops.kernels import sample_kernel as sk
    g = torch.Generator(device="cuda").manual_seed(21)
    worst = 0.0
    for shape, seed in (((VIDEO_K, VIDEO_BATCH, VIDEO_LATENTS), 0), ((1024, 1024), 7),
                        ((7, 5), 2 ** 40 + 3), ((3,), 2 ** 64 - 1)):
        mu = torch.randn(shape, generator=g, device="cuda")
        scale = torch.rand(shape, generator=g, device="cuda") * 1.7 + 0.3
        z = sk.sample_normal_fused(mu, scale, seed)
        _, eps = sk._launch(mu, scale, seed)
        want_z, want_eps = sk.sample_reference(mu, scale, seed)
        torch.cuda.synchronize()
        err = max((z - want_z).abs().max().item(), (eps - want_eps).abs().max().item())
        worst = max(worst, err)
        print(f"parity sample {shape} seed {seed}: max_abs_err={err:.3e} "
              f"(rtol {SAMPLE_RTOL}, atol {SAMPLE_ATOL})")
        check(bool(torch.isfinite(z).all()), f"non-finite sample at {shape}")
        check(torch.allclose(eps, want_eps, rtol=SAMPLE_RTOL, atol=SAMPLE_ATOL)
              and torch.allclose(z, want_z, rtol=SAMPLE_RTOL, atol=SAMPLE_ATOL),
              f"sample kernel disagrees with its plain version at {shape}")
    n = 1 << 22
    mu = torch.zeros(n, device="cuda", requires_grad=True)
    scale = torch.ones(n, device="cuda", requires_grad=True)
    z = sk.sample_normal_fused(mu, scale, 11)
    mean, std = z.mean().item(), z.std().item()
    print(f"sample moments over {n} draws: mean {mean:.5f}, std {std:.5f} (within 0.01)")
    check(abs(mean) < 0.01 and abs(std - 1.0) < 0.01, "sample moments are off")
    up = torch.randn(n, generator=g, device="cuda")
    z.backward(up)
    check(torch.equal(mu.grad, up) and torch.allclose(scale.grad, up * z.detach()),
          "sample backward is not (g, g * eps)")
    check(torch.equal(sk.sample_normal_fused(mu.detach(), scale.detach(), 11), z.detach()),
          "one seed gave two draws")
    check(not torch.equal(sk.sample_normal_fused(mu.detach(), scale.detach(), 12),
                          z.detach()), "two seeds gave one draw")
    return worst


def phase_video_parity():
    """The video model at full width (2048 tokens, block 128, stride 4, 64
    channels), K 2 and bs 2: card (kernels, fp32) vs CPU (plain versions,
    float64), same seeded weights, batch and eps, under ELBO and DReG; then
    on the card at K 5 and bs 8, remat on vs off."""
    from multimodal_vae_comparison_tpu_torch.training.trainer import build_model
    rng = np.random.default_rng(22)
    raw, eps = video_inputs(rng, 2, 2)
    for obj in ("elbo", "dreg"):
        out = {}
        for dev in ("cuda", "cpu"):
            model = build_model(video_specs(), "moe", VIDEO_LATENTS, obj=obj, K=2, seed=0,
                                device=dev)
            batch, draws = torch_batch(raw, dev), eps_to(eps, dev)
            if dev == "cpu":
                model = model.double()
                batch = {n: {"data": m["data"].double(), "masks": None}
                         for n, m in batch.items()}
                draws = {n: e.double() for n, e in draws.items()}
            out[dev] = _objective_grads(model, batch, draws)
        (gl, gm, gg), (cl, cm, cg) = out["cuda"], out["cpu"]
        cg = {n: g.float() for n, g in cg.items()}
        worst, name = _worst_leaf(gg, cg, VIDEO_GRAD_REL[obj])
        print(f"video parity {obj}: loss cuda {gl:.4f} cpu {cl:.4f}; {len(cg)} gradient "
              f"leaves, worst error {worst:.3f} of its limit at {name} (limit "
              f"{VIDEO_GRAD_REL[obj]} x max|g| + 1e-05)")
        check(np.isfinite(gl) and abs(gl - cl) <= VIDEO_LOSS_RTOL * abs(cl),
              f"video {obj}: loss {gl} on the card vs {cl} on the CPU")
        for k in cm:
            check(abs(gm[k] - cm[k]) <= VIDEO_LOSS_RTOL * abs(cm[k]) + 1e-3,
                  f"video {obj}: metric {k} {gm[k]} on the card vs {cm[k]} on the CPU")
        check(worst <= 1.0, f"video {obj}: gradient of {name} differs between the card "
              "and the CPU")
    raw, eps = video_inputs(rng, VIDEO_BATCH, VIDEO_K)
    batch, eps = torch_batch(raw, "cuda"), eps_to(eps, "cuda")
    out = {}
    for remat in (True, False):
        model = build_model(video_specs(), "moe", VIDEO_LATENTS, obj="dreg", K=VIDEO_K,
                            seed=0, device="cuda", remat=remat)
        torch.cuda.reset_peak_memory_stats()
        out[remat] = _objective_grads(model, batch, eps)
        print(f"video remat={remat}: loss {out[remat][0]:.4f}, peak memory "
              f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB (bs {VIDEO_BATCH}, "
              f"K {VIDEO_K})")
        del model
    worst, name = _worst_leaf(out[True][2], out[False][2], VIDEO_GRAD_REL["dreg"])
    print(f"video remat on vs off: worst gradient error {worst:.3f} of its limit at {name}")
    check(abs(out[True][0] - out[False][0]) <= VIDEO_LOSS_RTOL * abs(out[False][0]),
          "remat changed the loss")
    check(worst <= 1.0, f"remat changed the gradient of {name}")


def phase_video_train():
    """The video main path: VIDEO_STEPS adam steps of the bench.py model on
    one fixed batch; returns launches per step."""
    from multimodal_vae_comparison_tpu_torch.ops.kernels import telemetry
    from multimodal_vae_comparison_tpu_torch.training.optim import make_optimizer
    from multimodal_vae_comparison_tpu_torch.training.trainer import (
        build_model, make_train_step)
    raw, _ = video_inputs(np.random.default_rng(23), VIDEO_BATCH, VIDEO_K)
    batch = torch_batch(raw, "cuda")
    model = build_model(video_specs(), "moe", VIDEO_LATENTS, obj="dreg", K=VIDEO_K, seed=0,
                        device="cuda", remat=True)
    n_params = sum(p.numel() for p in model.parameters())
    step = make_train_step(model, make_optimizer("adam", VIDEO_LR, model.parameters()))
    gen = torch.Generator(device="cuda").manual_seed(24)
    before = telemetry.launches()
    losses = torch.stack([step(batch, generator=gen)["loss"]
                          for _ in range(VIDEO_STEPS)]).cpu().numpy()
    after = telemetry.launches()
    per_step = {k: (after[k] - before.get(k, 0)) / VIDEO_STEPS for k in after
                if after[k] != before.get(k, 0)}
    print(f"train VideoGPTSparse MOE dreg K={VIDEO_K} ({n_params} parameters): loss "
          f"{losses[0]:.3f} -> {losses[-1]:.3f} over {VIDEO_STEPS} steps (adam, lr "
          f"{VIDEO_LR}, batch {VIDEO_BATCH}, remat); launches per step {per_step}")
    check(bool(np.isfinite(losses).all()), "video model: non-finite loss")
    check(losses[-5:].mean() < losses[0], "video model: the loss did not fall")
    # per step: the encoder's 4 blocks and the decoder's 4 in DReG's second
    # pass run twice under remat (forward, and again in the backward), the
    # decoder's 4 in the gradient-free first pass once; one dq and one dk/dv
    # launch per block that ran with gradients on
    want = {"sparse_attention": 20.0, "sparse_attention_dq": 8.0, "sparse_attention_dkv": 8.0}
    check(per_step == want, f"video model launched {per_step} per step, expected {want}")
    return per_step


def phase_sample_path():
    """The sampling op through its own entry point, as a VAE would draw its
    K samples: z = mu + scale * eps at (K, B, D), a new seed per step."""
    from multimodal_vae_comparison_tpu_torch.ops.kernels.sample_kernel import (
        sample_normal_fused)
    g = torch.Generator(device="cuda").manual_seed(25)
    shape = (VIDEO_K, VIDEO_BATCH, VIDEO_LATENTS)
    mu = torch.randn(shape, generator=g, device="cuda", requires_grad=True)
    scale = (torch.rand(shape, generator=g, device="cuda") + 0.3).requires_grad_()
    draws = []
    for seed in range(VIDEO_STEPS):
        z = sample_normal_fused(mu, scale, seed)
        z.square().sum().backward()
        draws.append(z.detach())
    check(all(bool(torch.isfinite(z).all()) and z.shape == shape for z in draws),
          "sample path: bad draw")
    check(bool(torch.isfinite(mu.grad).all() and torch.isfinite(scale.grad).all()),
          "sample path: non-finite gradient")
    check(not torch.equal(draws[0], draws[1]), "sample path: two seeds gave one draw")
    print(f"sample path: {VIDEO_STEPS} draws of {shape} with gradients ok")


def phase_video_times(card):
    """The sparse kernels at the decoder's and encoder's shapes, the sample
    kernel, and the video model's train step and peak memory.  Forward and
    sample times are the public entry's; the backward is timed whole (the
    Function's backward: delta, dk/dv, dq) and each of its two kernels
    through its launcher, since the entry launches them together.  Each
    tensor-core kernel is timed in turns with the fp32 FMA kernel of the
    same function (new, FMA, new), which the port never calls at these
    shapes; the library time of the backward is SDPA's backward, which
    gives dq, dk and dv at once."""
    import ctypes
    import types
    import torch.nn.functional as F
    from multimodal_vae_comparison_tpu_torch.ops.kernels import _build
    from multimodal_vae_comparison_tpu_torch.ops.kernels import sample_kernel as sk
    from multimodal_vae_comparison_tpu_torch.ops.kernels import sparse_attention as sp
    from multimodal_vae_comparison_tpu_torch.training.optim import make_optimizer
    from multimodal_vae_comparison_tpu_torch.training.trainer import (
        build_model, make_train_step)
    g = torch.Generator(device="cuda").manual_seed(26)
    src = "multimodal_vae_comparison_tpu_torch/csrc/sparse_attention.cu"
    ref = "multimodal_vae_comparison_tpu/ops/pallas/sparse_attention.py"
    block, stride = SPARSE_BLOCK, SPARSE_STRIDE
    rows = []
    # the fp32 FMA forward at the shapes the launcher gives the tensor-core
    # kernel: exported as a yardstick, never called by the port at these
    fma_forward = _build.function("sparse_attention", "sparse_attention_forward_fma",
                                  sp._FWD_ARGTYPES[:-1])
    fma_dq = _build.function("sparse_attention", "sparse_attention_dq_fma",
                             sp._DQ_ARGTYPES[:-1])
    fma_dkv = _build.function("sparse_attention", "sparse_attention_dkv_fma",
                              sp._DKV_ARGTYPES[:-1])
    sdpa_bwd_is = ("torch.autograd.grad of F.scaled_dot_product_attention(q, k, v, "
                   "attn_mask=visible), retain_graph: dq, dk and dv at once, eager")
    for label, shape in (("decoder", SPARSE_DEC), ("encoder", SPARSE_ENC)):
        b, h, t, dh = shape
        q, k, v, d_out = (torch.randn(shape, generator=g, device="cuda") for _ in range(4))
        out, lse = sp._launch_forward(q, k, v, block, stride)
        delta = (d_out * out).sum(-1)
        visible = sp.visibility(t, block, stride, "cuda")   # SDPA's dense mask
        args = (q, k, v, d_out, lse, delta, block, stride)
        ctx = types.SimpleNamespace(saved_tensors=(q, k, v, out, lse), block=block,
                                    block_stride=stride)

        def entry():
            return sp.strided_block_sparse_attention(q, k, v, block, stride)

        def entry_bwd():
            return sp._StridedBlockSparse.backward(ctx, d_out)

        def plain_bwd():
            leaves = [x.detach().requires_grad_() for x in (q, k, v)]
            return torch.autograd.grad(
                sp.sparse_attention_reference(*leaves, block, stride), leaves, d_out)

        fma_out, fma_lse = torch.empty_like(out), torch.empty_like(lse)
        fma_grads = [torch.empty_like(q) for _ in range(3)]   # dq, dk, dv
        bwd_ptrs = [x.data_ptr() for x in (q, k, v, d_out, lse, delta)]

        def fma():
            _build.check("sparse_attention", fma_forward(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), fma_out.data_ptr(),
                fma_lse.data_ptr(), *sp._shape_args(q, block, stride)))

        def dq_fma():
            _build.check("sparse_attention", fma_dq(
                *bwd_ptrs, fma_grads[0].data_ptr(), *sp._shape_args(q, block, stride)))

        def dkv_fma():
            _build.check("sparse_attention", fma_dkv(
                *bwd_ptrs, fma_grads[1].data_ptr(), fma_grads[2].data_ptr(),
                *sp._shape_args(q, block, stride)))

        few = dict(reps=5, replays=4)
        fwd = graph_ms(entry, **few)
        fwd_fma = graph_ms(fma, **few)
        fwd_again = graph_ms(entry, **few)
        check(torch.allclose(fma_out, out, rtol=SPARSE_RTOL, atol=SPARSE_ATOL)
              and torch.allclose(fma_lse, lse, rtol=SPARSE_RTOL, atol=SPARSE_ATOL),
              f"the two sparse forward kernels disagree at {shape}")
        bwd = graph_ms(entry_bwd, **few)
        dq = graph_ms(lambda: sp._launch_dq(*args), **few)
        dq_fma_ms = graph_ms(dq_fma, **few)
        dq_again = graph_ms(lambda: sp._launch_dq(*args), **few)
        dkv = graph_ms(lambda: sp._launch_dkv(*args), **few)
        dkv_fma_ms = graph_ms(dkv_fma, **few)
        dkv_again = graph_ms(lambda: sp._launch_dkv(*args), **few)
        mma_grads = (sp._launch_dq(*args),) + sp._launch_dkv(*args)
        err_routes = max((a - b).abs().max().item() for a, b in zip(mma_grads, fma_grads))
        check(all(torch.allclose(a, b, rtol=SPARSE_BWD_RTOL, atol=SPARSE_BWD_ATOL)
                  for a, b in zip(mma_grads, fma_grads)),
              f"the two routes of the sparse backward disagree at {shape}")
        del mma_grads
        fwd_eager = eager_ms(entry, iters=20)
        bwd_eager = eager_ms(entry_bwd, iters=20)
        dq_eager = eager_ms(lambda: sp._launch_dq(*args), iters=20)
        dkv_eager = eager_ms(lambda: sp._launch_dkv(*args), iters=20)
        plain = eager_ms(lambda: sp.sparse_attention_reference(q, k, v, block, stride),
                         iters=5)
        # the plain backward is autograd through the plain version: its
        # forward is timed with it, and it gives dq, dk and dv at once
        plain_b = eager_ms(plain_bwd, iters=5)
        lib = eager_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=visible),
                       iters=10)
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        sdpa_out = F.scaled_dot_product_attention(*leaves, attn_mask=visible)
        lib_bwd = eager_ms(lambda: torch.autograd.grad(sdpa_out, leaves, d_out,
                                                       retain_graph=True), iters=10)
        del leaves, sdpa_out
        want = sp.sparse_attention_reference(q, k, v, block, stride)
        err_fwd = (entry() - want).abs().max().item()
        del want
        want_g = plain_bwd()
        got_dq, got_dk, got_dv = entry_bwd()[:3]
        err_dq = (got_dq - want_g[0]).abs().max().item()
        err_dkv = max((got_dk - want_g[1]).abs().max().item(),
                      (got_dv - want_g[2]).abs().max().item())
        del want_g, got_dq, got_dk, got_dv
        pairs, cells = sparse_work(t, block, stride)
        n, n_rows = b * h * t * dh, b * h * t
        for name, line, ms, again, fma_ms, eager, err, plain_ms, lib_ms, nbytes, \
                flop_per_cell in (
                ("strided_block_sparse_attention", 165, fwd, fwd_again, fwd_fma, fwd_eager,
                 err_fwd, plain, lib, 4 * (4 * n + n_rows), 4 * dh),
                ("strided_block_sparse_attention_dq", 262, dq, dq_again, dq_fma_ms, dq_eager,
                 err_dq, plain_b, lib_bwd, 4 * (5 * n + 2 * n_rows), 6 * dh),
                ("strided_block_sparse_attention_dkv", 283, dkv, dkv_again, dkv_fma_ms,
                 dkv_eager, err_dkv, plain_b, lib_bwd, 4 * (6 * n + 2 * n_rows), 8 * dh)):
            bound, by = bound_ms(nbytes, b * h * cells * flop_per_cell)
            # the second bound, for the unit the kernel runs on: three TF32
            # MMAs per fp32 product at the tensor cores' dense TF32 rate
            tensor_bound = 3 * b * h * cells * flop_per_cell / PEAK_TF32_FLOP_PER_S * 1e3
            print(f"time {name} [{label} {shape}]: tensor-core kernel {ms:.5f} and "
                  f"{again:.5f} ms, fp32 FMA kernel {fma_ms:.5f} ms, bound of 3 TF32 MMAs "
                  f"per product at 495 TFLOP/s {tensor_bound:.6f} ms on {card}")
            rows.append({"name": name, "at": f"{label} {shape} block {block} stride {stride}",
                         "route": "cuda", "source": src, "replaces": f"{ref}:{line}",
                         "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                         "bound_ms": bound, "bound_by": by, "library_ms": lib_ms,
                         "eager_ms": eager, "live_block_pairs_per_head": pairs,
                         "fma_kernel_ms": fma_ms, "tensor_bound_ms": tensor_bound})
        rows[-3]["library_is"] = "F.scaled_dot_product_attention(q, k, v, attn_mask=visible)"
        # the whole backward as the Function runs it, beside its two kernels
        for r in rows[-2:]:
            r.update(backward_ms=bwd, backward_eager_ms=bwd_eager, library_is=sdpa_bwd_is,
                     max_abs_err_between_routes=err_routes)
        print(f"time sparse attention backward [{label} {shape}]: {bwd:.5f} ms (eager "
              f"{bwd_eager:.5f}): delta, dk/dv and dq as the Function launches them; SDPA's "
              f"backward {lib_bwd:.5f} ms (eager); tensor-core vs FMA kernels "
              f"max_abs_err={err_routes:.3e} on {card}")
        del q, k, v, d_out, out, lse, delta, args, ctx, fma_out, fma_lse, fma_grads
        torch.cuda.empty_cache()
    for shape in ((VIDEO_K, VIDEO_BATCH, VIDEO_LATENTS), (1 << 20,)):
        mu = torch.randn(shape, generator=g, device="cuda")
        scale = torch.rand(shape, generator=g, device="cuda") + 0.3
        kern = graph_ms(lambda: sk.sample_normal_fused(mu, scale, 3))
        plain = graph_ms(lambda: sk.sample_reference(mu, scale, 3), reps=10)
        kern_eager = eager_ms(lambda: sk.sample_normal_fused(mu, scale, 3))
        # the library's draw of N(mu, scale): another generator and no eps
        # kept, so it is timed for the record and compared by nothing.
        # torch.normal checks std >= 0 on the host, so it cannot be captured
        # in a graph and its time stands beside eager_ms; its two device
        # ops without the check (a draw, then mu + scale * eps) are captured
        lib = eager_ms(lambda: torch.normal(mu, scale))
        lib_graph = graph_ms(lambda: torch.addcmul(mu, scale, torch.randn_like(mu)))
        n = mu.numel()
        # per element: ten Philox rounds of four multiplies, four xors and
        # two adds, then Box-Muller and the affine
        bound, by = bound_ms(16 * n, 110 * n)
        want_z, want_eps = sk.sample_reference(mu, scale, 3)
        err = max((sk.sample_normal_fused(mu, scale, 3) - want_z).abs().max().item(),
                  (sk._launch(mu, scale, 3)[1] - want_eps).abs().max().item())
        rows.append({"name": "sample_normal_fused", "at": f"{shape}", "route": "cuda",
                     "source": "multimodal_vae_comparison_tpu_torch/csrc/sample.cu",
                     "replaces": "multimodal_vae_comparison_tpu/ops/pallas/sample_kernel.py:63",
                     "max_abs_err": err, "ms": kern, "plain_ms": plain, "bound_ms": bound,
                     "bound_by": by, "library_ms": lib, "eager_ms": kern_eager,
                     "library_is": "torch.normal(mu, scale), eager (not capturable)",
                     "library_two_ops_ms": lib_graph})
        print(f"time torch.normal [{shape}]: eager {lib:.5f} ms; randn_like + addcmul back "
              f"to back {lib_graph:.5f} ms on {card}")
    for r in rows:
        print(f"time {r['name']} [{r['at']}]: kernel {r['ms']:.5f} ms (eager "
              f"{r['eager_ms']:.5f}), plain {r['plain_ms']:.5f} ms, library "
              f"{'n/a' if r['library_ms'] is None else format(r['library_ms'], '.5f')} ms, "
              f"bound {r['bound_ms']:.6f} ms ({r['bound_by']}) on {card}")
    model = build_model(video_specs(), "moe", VIDEO_LATENTS, obj="dreg", K=VIDEO_K, seed=0,
                        device="cuda", remat=True)
    step = make_train_step(model, make_optimizer("adam", VIDEO_LR, model.parameters()))
    gen = torch.Generator(device="cuda").manual_seed(27)
    raw, _ = video_inputs(np.random.default_rng(28), VIDEO_BATCH, VIDEO_K)
    batch = torch_batch(raw, "cuda")
    for _ in range(2):
        step(batch, generator=gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    lat = []
    for _ in range(10):
        t0 = time.perf_counter()
        step(batch, generator=gen)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
    p50 = statistics.median(lat)
    print(f"time train step VideoGPTSparse MOE dreg K={VIDEO_K} batch {VIDEO_BATCH} remat: "
          f"p50 {p50:.3f} ms, min {min(lat):.3f} ms over 10, "
          f"{VIDEO_BATCH / p50 * 1e3:.2f} samples/s, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB on {card}")
    profile_steps("VideoGPTSparse MOE dreg", step, batch, gen, VIDEO_BATCH, 3, card)
    return rows


def make_cdsprites(root: str):
    """CdSprites+ level 1 at DATA_COUNT through the port's generator:
    (level dir, file suffix, route).  It writes .h5 where h5py imports and
    the same arrays as .pkl where it does not."""
    from multimodal_vae_comparison_tpu_torch.data_proc.cdsprites import generate_level
    try:
        import h5py  # noqa: F401
        fmt = "h5"
    except ImportError:
        fmt = "pkl"
    level_dir = generate_level(1, DATA_COUNT, root, seed=0, fmt=fmt)
    return level_dir, f".{fmt}", f"data_proc.cdsprites.generate_level(fmt={fmt!r})"


def from_config(path: str, level_dir: str, suffix: str, results_root: str, **over):
    """The Config of a shipped YAML with its data paths on the made files and
    its run directory under ``results_root``."""
    import yaml
    from multimodal_vae_comparison_tpu_torch.config import Config
    with open(os.path.join(HERE, path)) as f:
        params = yaml.safe_load(f)
    for key, block in params.items():
        if key.startswith("modality_"):
            block["path"] = os.path.join(level_dir, f"traindata{suffix}")
            block["test_datapath"] = os.path.join(level_dir, f"testdata{suffix}")
    params.update(over)
    return Config(params, results_root=results_root)


def expected_launches(mixing: str, objective_calls: int, train_steps: int) -> dict:
    """Launches of ``objective_calls`` objective calls of which
    ``train_steps`` (a train step's) also ran their backward."""
    want = {k: n * objective_calls for k, n in PER_OBJECTIVE[mixing].items()}
    want.update({k: n * train_steps for k, n in PER_BACKWARD[mixing].items()})
    return want


def eval_launches(mixing: str, n_train: int) -> dict:
    """Launches of one CdSprites+ benchmark (``eval_single_model``).

    Its forwards: text->image and image->text cross-generation, then one
    with both modalities per ex-post batch (64 train rows, up to 2048); its
    decodes: one per joint source.  A POE forward launches the PoE kernel
    once (one subset) and attention in the text encoder when text is
    present and in the text decoder; a MOE forward decodes text from each
    present modality's sample, and launches no KL.  A text decode is one
    attention launch."""
    batches = min(-(-n_train // EXPOST_BATCH), EXPOST_ROWS // EXPOST_BATCH)
    joint = len(JOINT_SOURCES)
    if mixing == "poe":
        return {"attention": 2 + 1 + 2 * batches + joint, "poe": 2 + batches}
    return {"attention": 2 + 2 + 3 * batches + joint}


@contextlib.contextmanager
def eval_stopwatch(times: dict):
    """Seconds of the benchmark's parts while the block runs, summed into
    ``times``: the judges (trained or loaded), cross-generation, each joint
    source, the GMM fit and the whole eval.  Each part ends in host numpy,
    so its clock reads finished device work."""
    from multimodal_vae_comparison_tpu_torch.eval import eval_cdsprites as ec
    from multimodal_vae_comparison_tpu_torch.eval.infer import MultimodalVAEInfer
    parts = ((ec, "get_all_classifiers", lambda a, k: "judges_s"),
             (ec, "calculate_cross_coherency", lambda a, k: "cross_s"),
             (ec, "calculate_joint_coherency",
              lambda a, k: f"joint_{k.get('source', 'prior')}_s"),
             (MultimodalVAEInfer, "_fitted_prior", lambda a, k: "gmm_fit_s"),
             (ec, "eval_single_model", lambda a, k: "eval_s"))
    saved = [(owner, name, getattr(owner, name)) for owner, name, _ in parts]

    def timed(fn, label):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                key = label(args, kwargs)
                times[key] = times.get(key, 0.0) + time.perf_counter() - t0
        return run

    for (owner, name, label), (_, _, fn) in zip(parts, saved):
        setattr(owner, name, timed(fn, label))
    try:
        yield times
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)


def check_stats(label: str, stats: dict) -> None:
    """The benchmark's 12 stats finite and in [0, 100] (a failed ex-post or
    fitted source reads NaN), no ``eval_error``, and the judge at least
    JUDGE_MIN on real images."""
    from multimodal_vae_comparison_tpu_torch.eval.eval_cdsprites import STATS_KEYS
    check("eval_error" not in stats, f"{label}: the eval failed: {stats.get('eval_error')}")
    bad = {k: stats.get(k) for k in STATS_KEYS
           if not (isinstance(stats.get(k), float) and 0.0 <= stats[k] <= 100.0)}
    check(not bad, f"{label}: stats missing, not finite or out of [0, 100]: {bad}")
    check(stats["Judge Accuracy Real"] >= JUDGE_MIN,
          f"{label}: the judge reads {stats['Judge Accuracy Real']:.2f} % on real images")


def kernel_busy_share(prof, wall_ms: float):
    """(device busy share, kernels) of a ``torch.profiler`` window: the union
    of the CUDA activity intervals over the host wall time, read from the
    raw kineto events (building the profiler's event list for a whole epoch
    takes longer than the epoch)."""
    from torch.autograd import DeviceType
    intervals = [(e.start_ns() / 1e3, e.end_ns() / 1e3)
                 for e in prof.profiler.kineto_results.events()
                 if e.device_type() == DeviceType.CUDA
                 and not getattr(e, "is_user_annotation", lambda: False)()
                 and not e.name().startswith("Optimizer.")]
    check(bool(intervals), "the profiler recorded no CUDA activity")
    return busy_ms(intervals) / wall_ms, len(intervals)


def _csv_rows(path: str):
    with open(path) as f:
        lines = f.read().strip().splitlines()
    keys = lines[0].split(",")
    return [dict(zip(keys, line.split(","))) for line in lines[1:]]


def serve_model_dir(run_dir: str, batch, log_path: str) -> dict:
    """``serving/server.py --model run_dir`` in its own process on a free
    port: /health until it answers, one /generate with both modalities of
    two val rows, then SIGINT; returns its timings."""
    import signal
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    started = time.perf_counter()
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "multimodal_vae_comparison_tpu_torch.serving.server",
             "--model", run_dir, "--port", str(port)],
            cwd=HERE, stdout=log, stderr=subprocess.STDOUT, stdin=subprocess.DEVNULL)
        try:
            while True:
                if proc.poll() is not None:
                    with open(log_path) as f:
                        raise RuntimeError(f"the --model server exited {proc.returncode}:\n"
                                           + f.read()[-4000:])
                try:
                    health = json.load(urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/health", timeout=5))
                    break
                except (urllib.error.URLError, OSError):
                    check(time.perf_counter() - started < 300, "the --model server never answered")
                    time.sleep(0.5)
            up_s = time.perf_counter() - started
            check(health["status"] == "ok" and health["model"] == "POE",
                  f"/health of the --model server said {health}")
            req = {"inputs": {name: {k: v[:2].tolist() for k, v in mod.items() if v is not None}
                              for name, mod in batch.items()}, "seed": 3}
            t0 = time.perf_counter()
            resp = urllib.request.urlopen(urllib.request.Request(
                f"http://127.0.0.1:{port}/generate", data=json.dumps(req).encode(),
                headers={"Content-Type": "application/json"}), timeout=120)
            out = json.load(resp)
            generate_ms = (time.perf_counter() - t0) * 1e3
            check(resp.status == 200, f"/generate of the --model server gave {resp.status}")
            check(np.asarray(out["mod_1"]).shape == (2, 64, 64, 3)
                  and np.asarray(out["mod_2"]).shape == (2, SEQ_LEN, VOCAB)
                  and all(np.isfinite(np.asarray(v)).all() for v in out.values()),
                  "bad /generate response of the --model server")
        finally:
            if proc.poll() is None:
                proc.send_signal(signal.SIGINT)
                try:
                    proc.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait(timeout=30)
    return {"server_up_s": up_s, "server_generate_ms": generate_ms}


def phase_eval_from_config(card: str, run_dir: str) -> dict:
    """The POE run's benchmark again, from its run directory: the eval CLI
    (``eval_cdsprites -p``) in a process of its own must load the judge
    from the cache and write the stats file ``test()`` wrote, byte for
    byte; then cross-generation of the same EVAL_ROWS test rows and prior
    joint generation of JOINT_ROWS, with the eval's own draws (from a CPU
    generator seeded 0, so the same eps on both), on the card and
    through the plain path on the CPU: decoder means within EVAL_RTOL /
    EVAL_ATOL, the judged text->image and image->text Strict equal or one
    row apart.  Returns its numbers."""
    from multimodal_vae_comparison_tpu_torch.data.text import onehot2text
    from multimodal_vae_comparison_tpu_torch.eval import eval_cdsprites as ec
    from multimodal_vae_comparison_tpu_torch.eval.infer import MultimodalVAEInfer

    numbers = {}
    path = os.path.join(run_dir, "cdspritesplus_stats.txt")
    with open(path) as f:
        written = f.read()
    check([line.split(":")[0] for line in written.splitlines()] == list(ec.STATS_KEYS),
          f"{path} does not hold the 12 stats:\n{written}")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "multimodal_vae_comparison_tpu_torch.eval.eval_cdsprites",
         "-p", run_dir], cwd=HERE, capture_output=True, text=True, timeout=600,
        stdin=subprocess.DEVNULL)
    numbers["eval_cli_s"] = time.perf_counter() - t0
    check(proc.returncode == 0, f"eval_cdsprites -p exited {proc.returncode}:\n"
          f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    check("classifier[shape]: cached" in proc.stdout,
          f"eval_cdsprites -p did not load the cached judge:\n{proc.stdout[-3000:]}")
    with open(path) as f:
        again = f.read()
    check(again == written, f"eval_cdsprites -p wrote other stats than test():\n{written}\n"
          f"against\n{again}")
    print(f"eval from config: eval_cdsprites -p {run_dir} in its own process, judge cached, "
          f"{numbers['eval_cli_s']:.2f} s: the stats test() wrote, byte for byte")

    card_exp, cpu_exp = MultimodalVAEInfer(run_dir), MultimodalVAEInfer(run_dir, device="cpu")
    batch, labels = card_exp.get_test_samples(EVAL_ROWS)
    texts = [" ".join(x) if isinstance(x, (list, tuple)) else str(x) for x in labels]
    mapping = ec._mod_mapping(batch)
    img, txt = mapping["image"], mapping["text"]
    gt_texts = onehot2text(batch[txt]["data"], batch[txt]["masks"])
    level = ec.dataset_level(card_exp)
    out = {}
    for name, exp in (("card", card_exp), ("cpu", cpu_exp)):
        judges = ec.get_all_classifiers(exp, level, log_fn=None)
        t0 = time.perf_counter()
        t2i = exp.cross_generate(txt, batch[txt]["data"], batch[txt]["masks"])
        i2t = exp.cross_generate(img, batch[img]["data"])
        joint = exp.joint_generate(JOINT_ROWS, source="prior")
        seconds = time.perf_counter() - t0
        images = (np.clip(t2i[img], 0, 1) * 255).astype(np.uint8)
        strict = (ec.text_to_image_accuracy(texts, images, judges, level)[0],
                  ec.image_to_text_accuracy(gt_texts, onehot2text(i2t[txt]), level)[0])
        out[name] = ({"text->image": t2i, "image->text": i2t, "prior joint": joint},
                     strict, seconds)
    worst = 0.0
    for what, card_means in out["card"][0].items():
        for mod, got in card_means.items():
            want = out["cpu"][0][what][mod]
            err = float(np.abs(got - want).max())
            worst = max(worst, err)
            check(np.allclose(got, want, rtol=EVAL_RTOL, atol=EVAL_ATOL),
                  f"eval on the card vs the CPU: {what} {mod} max_abs_err={err:.3e}")
    row = 100.0 / len(texts)
    (card_t2i, card_i2t), (cpu_t2i, cpu_i2t) = out["card"][1], out["cpu"][1]
    print(f"eval from config: card vs CPU over {len(texts)} test rows and {JOINT_ROWS} prior "
          f"samples, the eval's draws: decoder means max_abs_err={worst:.3e} (rtol {EVAL_RTOL}, atol "
          f"{EVAL_ATOL}); text->image Strict {card_t2i:.2f} / {cpu_t2i:.2f}, image->text "
          f"Strict {card_i2t:.2f} / {cpu_i2t:.2f} (one row is {row:.2f}); generation "
          f"{out['card'][2]:.3f} s on {card}, {out['cpu'][2]:.3f} s on the CPU")
    for what, a, b in (("text->image", card_t2i, cpu_t2i), ("image->text", card_i2t, cpu_i2t)):
        check(abs(a - b) <= row + 1e-9, f"judged {what} Strict {a} on the card, {b} on the CPU")
    numbers.update(eval_card_vs_cpu_max_abs_err=worst,
                   eval_strict_card=[card_t2i, card_i2t], eval_strict_cpu=[cpu_t2i, cpu_i2t],
                   eval_generation_card_s=out["card"][2], eval_generation_cpu_s=out["cpu"][2])
    return numbers


def phase_train_from_config(card: str, root: str):
    """The config -> data -> Trainer -> checkpoint -> --model server path.

    CdSprites+ level 1 is made at DATA_COUNT; ``cdl1_r5_poe.yml`` trains for
    2 epochs through ``main(config)`` on the resident path, its first epoch
    under ``torch.profiler`` as the CLI's ``--profile`` runs it (a Trainer,
    ``fit(epochs=1)``, then ``main(config, trainer)``); then one epoch through
    the per-batch ``run_epoch``, and ``config_cdspritesplus.yml`` (MOE) for 1
    epoch.  Each run is counted from zero and must launch exactly its
    objective calls (train steps + validation batches) times the kernels'
    counts per call, and the ``test()`` that ends each run the launches of
    its CdSprites+ benchmark (:func:`eval_launches`), whose stats are
    checked and, for POE, held again by :func:`phase_eval_from_config`.  The
    run directory is restored through ``MultimodalVAEInfer`` and served by
    ``serving/server.py --model``.  Returns (launches of the whole phase,
    its numbers)."""
    from multimodal_vae_comparison_tpu_torch.data import native
    from multimodal_vae_comparison_tpu_torch.eval.infer import MultimodalVAEInfer
    from multimodal_vae_comparison_tpu_torch.main import main as train_main
    from multimodal_vae_comparison_tpu_torch.ops.kernels import telemetry
    from multimodal_vae_comparison_tpu_torch.training.trainer import Trainer
    from torch.profiler import ProfilerActivity, profile

    numbers, total = {"card": card}, {}
    # the judges the POE run's test() trains, and the MOE run's and the
    # eval CLI's load
    os.environ["CDSPRITES_CLASSIFIER_DIR"] = os.path.join(root, "judges")
    t0 = time.perf_counter()
    level_dir, suffix, route = make_cdsprites(os.path.join(root, "data"))
    numbers["data_s"] = time.perf_counter() - t0
    print(f"train from config: data route {route}, {level_dir} in {numbers['data_s']:.2f} s; "
          f"native host kernels available: {native.available()}")

    def counted(label, mixing, calls, train_steps, run, extra=None):
        telemetry.reset()
        out = run()
        torch.cuda.synchronize()
        got, paths = telemetry.launches(), telemetry.summary()
        want = expected_launches(mixing, calls, train_steps)
        for k, n in (extra or {}).items():
            want[k] = want.get(k, 0) + n
        print(f"train from config {label}: launches {got}, expected {want} "
              f"({calls} objective calls, {train_steps} of them train steps"
              + (f", and the eval's {extra}" if extra else "") + f"); dispatch {paths}")
        check(got == want, f"{label}: launched {got}, expected {want}")
        check(not any(k.endswith(":plain") for k in paths),
              f"{label}: a plain version ran: {paths}")
        for k, n in got.items():
            total[k] = total.get(k, 0) + n
        return out

    for (label, path, epochs), mixing in zip(FROM_CONFIG, ("poe", "moe")):
        config = from_config(path, level_dir, suffix, os.path.join(root, "results"),
                             epochs=epochs, iterseeds=1)
        trainer = Trainer(config, enable_viz=False)
        trainer.init_state()
        stats, times = {}, {}

        def test_and_keep(trainer=trainer, stats=stats):
            stats.update(Trainer.test(trainer))
            return stats

        trainer.test = test_and_keep    # main() prints test()'s stats; keep them
        dm, bs = trainer.datamodule, config.batch_size
        steps, val_batches = dm.n_train // bs, dm.n_val // bs
        check(config.mixing == mixing and trainer.use_scan() and trainer.device.type == "cuda",
              f"{label}: mixing {config.mixing}, resident {trainer.use_scan()}")
        t0 = time.perf_counter()
        trainer.stage_epoch_data()
        trainer.stage_val_data()
        torch.cuda.synchronize()
        stage_s = time.perf_counter() - t0
        staged_bytes = sum(t.numel() * t.element_size()
                           for staged in (trainer.stage_epoch_data(), trainer.stage_val_data())
                           for mod in staged.values() for t in mod.values() if t is not None)
        untrained = trainer.validate_scan(epochs - 1)["val_loss"]
        torch.cuda.reset_peak_memory_stats()
        # fit, then test(): validation and the CdSprites+ benchmark
        calls = epochs * (steps + val_batches) + val_batches
        evals = eval_launches(mixing, dm.n_train)
        if mixing == "poe":
            def run():
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    t1 = time.perf_counter()
                    trainer.fit(epochs=1)
                    torch.cuda.synchronize()
                    wall_ms = (time.perf_counter() - t1) * 1e3
                with eval_stopwatch(times):
                    train_main(config, trainer=trainer, enable_viz=False)
                return prof, wall_ms
            prof, wall_ms = counted(label, mixing, calls, epochs * steps, run, evals)
            share, n_events = kernel_busy_share(prof, wall_ms)
            del prof
        else:
            def run():
                with eval_stopwatch(times):
                    train_main(config, trainer=trainer, enable_viz=False)
            counted(label, mixing, calls, epochs * steps, run, evals)
        check_stats(label, stats)
        check(trainer.model.K == config.K, f"{label}: test() left the model at K "
              f"{trainer.model.K}, the config has {config.K}")
        print(f"eval from config {label}: " + ", ".join(
            f"{k} {stats[k]:.2f}" for k in stats if not k.startswith("val_"))
            + f"; launches of the eval {evals}; seconds " + ", ".join(
                f"{k[:-2]} {v:.3f}" for k, v in times.items()) + f" on {card}")
        numbers.update({f"{mixing}_eval_stats": {k: v for k, v in stats.items()
                                                 if not k.startswith("val_")},
                        f"{mixing}_eval_s": times, f"{mixing}_eval_launches": evals})
        if mixing == "poe":
            numbers.update(phase_eval_from_config(card, config.mPath))
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        rows = _csv_rows(os.path.join(config.mPath, "metrics.csv"))
        trained = float(rows[-1]["val_loss"])
        print(f"train from config {label}: {trainer.n_params()} parameters, {dm.n_train} train "
              f"/ {dm.n_val} val rows, {steps} steps of {bs} an epoch; staged "
              f"{staged_bytes / 1e9:.3f} GB in {stage_s:.3f} s; val_loss untrained "
              f"{untrained:.2f} -> {trained:.2f}; epochs "
              + "; ".join(f"{r['step']}: {float(r['epoch_time_s']):.3f} s, "
                          f"{float(r['samples_per_s']):.1f} samples/s" for r in rows)
              + f"; peak memory {peak:.3f} GiB on {card}")
        check(len(rows) == epochs, f"{label}: metrics.csv has {len(rows)} rows for {epochs} "
              "epochs")
        check(np.isfinite(trained) and trained < untrained,
              f"{label}: val_loss {trained} after training, {untrained} before")
        for tag in ("last", "best"):
            check(os.path.isfile(os.path.join(config.mPath, "model", tag, "state.pt")),
                  f"{label}: no model/{tag} checkpoint")
        key = mixing
        numbers.update({f"{key}_staged_bytes": staged_bytes, f"{key}_stage_s": stage_s,
                        f"{key}_val_loss_untrained": untrained, f"{key}_val_loss": trained,
                        f"{key}_peak_memory_gib": peak, f"{key}_steps_per_epoch": steps,
                        f"{key}_epochs": [{k: float(v) for k, v in r.items()} for r in rows]})
        if mixing == "moe":
            break
        numbers.update(poe_profiled_epoch_wall_ms=wall_ms, poe_profiled_busy_share=share,
                       poe_profiled_device_events=n_events)
        print(f"train from config {label}: resident epoch 0 under torch.profiler: wall "
              f"{wall_ms:.1f} ms, device busy share {share:.4f} ({n_events} CUDA activities)")
        # restore model/last on the card: the same weights, the same forward
        infer = MultimodalVAEInfer(config.mPath)
        for (n, a), b in zip(infer.model.state_dict().items(),
                             trainer.model.state_dict().values()):
            check(torch.equal(a, b), f"restored {n} differs from the trainer's")
        batch = next(dm.batches("val"))
        eps = torch.from_numpy(np.random.default_rng(30).standard_normal(
            (1, bs, N_LATENTS)).astype(np.float32)).to(trainer.device)
        present = ("mod_1", "mod_2")
        got = infer.forward(batch, present, eps=eps)
        trainer.model.eval()
        with torch.inference_mode():
            want = trainer.model.forward(torch_batch(batch, trainer.device), present, eps=eps)
        err = max((got.mods[n].decoder_dist.mean - want.mods[n].decoder_dist.mean)
                  .abs().max().item() for n in present)
        print(f"train from config {label}: MultimodalVAEInfer({config.mPath}) forward vs the "
              f"trainer's model: max_abs_err={err:.3e} (rtol {RESTORE_RTOL}, atol "
              f"{RESTORE_ATOL})")
        for n in present:
            check(torch.allclose(got.mods[n].decoder_dist.mean, want.mods[n].decoder_dist.mean,
                                 rtol=RESTORE_RTOL, atol=RESTORE_ATOL),
                  f"the restored model's forward differs at {n}")
        del infer
        t0 = time.perf_counter()
        trainer.validate_scan(epochs)
        val_scan_s = time.perf_counter() - t0
        # one epoch through the per-batch path: host shuffle, prefetch
        timed = {}

        def per_batch():
            t1 = time.perf_counter()
            timed["train"] = trainer.run_epoch(epochs)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            timed["val"] = trainer.validate(epochs)
            timed["train_s"], timed["val_s"] = t2 - t1, time.perf_counter() - t2

        counted(f"{label} per-batch epoch", mixing, steps + val_batches, steps, per_batch)
        resident = rows[-1]
        numbers.update(
            poe_resident_val_s=val_scan_s, poe_per_batch_train_s=timed["train_s"],
            poe_per_batch_val_s=timed["val_s"],
            poe_per_batch_epoch_s=timed["train_s"] + timed["val_s"],
            poe_per_batch_samples_per_s=steps * bs / (timed["train_s"] + timed["val_s"]),
            poe_per_batch_train_loss=timed["train"]["train_loss"])
        print(f"train from config {label}: resident epoch {float(resident['epoch_time_s']):.3f} "
              f"s ({float(resident['samples_per_s']):.1f} samples/s, validation on the staged "
              f"split {val_scan_s:.3f} s); per-batch epoch {timed['train_s']:.3f} s + "
              f"validation {timed['val_s']:.3f} s ({numbers['poe_per_batch_samples_per_s']:.1f} "
              f"samples/s) on {card}")
        check(np.isfinite(timed["train"]["train_loss"]), "per-batch epoch: non-finite loss")
        numbers.update(serve_model_dir(config.mPath, batch, os.path.join(root, "server.log")))
        print(f"train from config {label}: serving/server.py --model answered /health after "
              f"{numbers['server_up_s']:.2f} s, /generate (2 rows, both modalities) 200 in "
              f"{numbers['server_generate_ms']:.1f} ms")
    os.environ.pop("CDSPRITES_CLASSIFIER_DIR")
    return total, numbers


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from multimodal_vae_comparison_tpu_torch.models import get_mixing
    from multimodal_vae_comparison_tpu_torch.ops.kernels import _build, telemetry
    from multimodal_vae_comparison_tpu_torch.serving.engine import (
        InferenceEngine, ModelHandle)

    # 1. device
    card = card_line()
    print(card)
    kind = torch.cuda.get_device_name(0)
    print(f"device: {kind}, count {torch.cuda.device_count()}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("tf32: torch.backends.cuda.matmul.allow_tf32=False, "
          "torch.backends.cudnn.allow_tf32=False")

    # 2. build
    t0 = time.perf_counter()
    built = _build.build()
    print(f"build: {sorted(built)} in {time.perf_counter() - t0:.2f} s")
    check(all(_build.library_path(name).exists() for name in _build.SOURCES),
          f"not every source of {_build.SOURCES} has its library")
    for name, (_, log) in sorted(built.items()):
        entry = name
        for line in log.splitlines():
            found = re.search(r"Compiling entry function '\w*?cu_[0-9a-f]{8}\d+"
                              r"([A-Za-z_]+?)(?:I((?:Li\d+E)+))?E", line)
            if found:
                params = ", ".join(re.findall(r"\d+", found.group(2) or ""))
                entry = found.group(1) + (f"<{params}>" if params else "")
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name} {entry}: {line.strip()}")

    tile = 4 * SPARSE_BLOCK * VIDEO_DH   # the kernels size their shared memory at launch
    padded = 4 * SPARSE_BLOCK * (VIDEO_DH + 4)
    print(f"  sparse_attention dynamic shared memory at block {SPARSE_BLOCK}, Dh "
          f"{VIDEO_DH}: {4 * padded} B (sparse_fwd_mma, sparse_dq_mma: two stages of a K and "
          f"a V tile, rows padded by 4 floats), {2 * (2 * padded + 8 * SPARSE_BLOCK)} B "
          f"(sparse_dkv_mma: two stages of a q and a d_out tile, lse and delta), {2 * tile} B "
          f"(sparse_fwd, sparse_dq), {2 * tile + 8 * SPARSE_BLOCK} B (sparse_dkv)")

    # 3. kernel parity: forwards, then the Functions' backwards
    phase_parity()
    phase_kl_parity()
    phase_backward_parity()
    phase_lattice_parity()
    phase_sparse_parity()
    phase_sample_parity()

    # 4. serving slice at full width
    model_gpu = get_mixing("poe")(flagship_specs(), N_LATENTS, seed=0, device="cuda")
    model_cpu = get_mixing("poe")(flagship_specs(), N_LATENTS, seed=0, device="cpu")
    n_params = sum(p.numel() for p in model_gpu.parameters())
    for (n, a), (_, b) in zip(model_gpu.state_dict().items(),
                              model_cpu.state_dict().items()):
        check(torch.equal(a.cpu(), b), f"seeded weights differ at {n}")
    print(f"model: POE flagship, {n_params} parameters")
    phase_slice_parity(model_gpu, model_cpu)
    handle = ModelHandle(model_gpu)
    engine = InferenceEngine(handle, buckets=BUCKETS, device="cuda")

    telemetry.reset()          # counts of the serving path only, from here
    phase_serve(engine)
    phase_http(engine, handle)
    torch.cuda.synchronize()
    serve_launches, paths = telemetry.launches(), telemetry.summary()
    print(f"serving path launches: {serve_launches}; dispatch: {paths}")
    # per request chunk: attention 2 (both), 1 (image only), 2 (text only);
    # poe 1 each
    chunks = sum(-(-n // BUCKETS[-1]) for n in SERVE_SIZES) + 1  # +1: seed repeat
    want_attn = chunks * (2 + 1 + 2) + 6 * 2
    want_poe = chunks * 3 + 6
    check(serve_launches.get("attention") == want_attn,
          f"attention launches {serve_launches.get('attention')} != {want_attn}")
    check(serve_launches.get("poe") == want_poe,
          f"poe launches {serve_launches.get('poe')} != {want_poe}")
    check(not any(k.endswith(":plain") for k in paths),
          f"a plain version ran on the serving path: {paths}")

    # 5. training slice at full width: card vs CPU
    phase_training_parity()

    # 6. the POE/MOE training path: 30 steps each + one accumulated step
    telemetry.reset()          # counts of the training path only, from here
    per_step = phase_train()
    torch.cuda.synchronize()
    train_launches, paths = telemetry.launches(), telemetry.summary()
    print(f"training path launches: {train_launches}; dispatch: {paths}")
    check(not any(k.endswith(":plain") for k in paths),
          f"a plain version ran on the training path: {paths}")
    check(all(train_launches.get(k, 0) > 0
              for k in ("attention", "poe", "poe_bwd", "kl", "kl_bwd")),
          f"a kernel of the training path never launched: {train_launches}")

    # 7. the video slice at full width: card vs CPU, remat on vs off
    phase_video_parity()

    # 8. the video training path and the sampling op's own path
    telemetry.reset()          # counts of these two paths only, from here
    video_per_step = phase_video_train()
    phase_sample_path()
    torch.cuda.synchronize()
    video_launches, paths = telemetry.launches(), telemetry.summary()
    print(f"video and sample path launches: {video_launches}; dispatch: {paths}")
    check(not any(k.endswith(":plain") for k in paths),
          f"a plain version ran on the video or sample path: {paths}")
    video_kernels = ("sparse_attention", "sparse_attention_dq", "sparse_attention_dkv",
                     "sample")
    check(all(video_launches.get(k, 0) > 0 for k in video_kernels),
          f"a kernel of the video or sample path never launched: {video_launches}")
    check(paths.get("sparse_attention_bwd:cuda", 0) == 8 * VIDEO_STEPS,
          f"sparse_attention_bwd ran {paths.get('sparse_attention_bwd:cuda')} times")

    # 9. the main path of the last two slices: CdSprites+ from the configs
    # through the data layer, Trainer, checkpoints and the --model server,
    # each run ending in test() and its benchmark ("eval from config")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        config_launches, config_numbers = phase_train_from_config(card, tmp)
    config_numbers["phase_s"] = time.perf_counter() - t0
    print("train from config " + json.dumps(config_numbers))

    # 10. times
    rows = phase_times(engine, card)
    rows += phase_kernel_route_times(card)
    extra = phase_attention_backward_times(card)
    rows += phase_video_times(card)
    phase_route_times(card)
    print(card)
    # one entry per kernel, at its heaviest main-path shape (the first row
    # of each); the other shapes are on the "time" lines above.  launches:
    # each kernel's count on the path that runs it, the train-from-config
    # path (this slice's main path) or the video training and sampling
    # paths, with the fixed-batch training and serving paths' beside it
    primary = list({r["name"]: r for r in reversed(rows)}.values())[::-1]
    per_step["VideoGPTSparse MOE dreg"] = video_per_step
    for r in primary:
        kernel = KERNEL_OF[r["name"]]
        r["launches"] = (video_launches if kernel in video_kernels
                         else config_launches).get(kernel, 0)
        r["launches_fixed_batch_training_path"] = train_launches.get(kernel, 0)
        r["launches_serving_path"] = serve_launches.get(kernel, 0)
        r["launches_per_train_step"] = {label: n.get(kernel, 0)
                                        for label, n in per_step.items()}
    primary[0].update(extra)   # masked_attention: its backward's time
    # the launch floor beside the kernels that run at the cost of one launch:
    # an empty kernel launched as the attention kernel is, in this run
    for r in primary:
        if r["name"] in ("poe_lattice", "poe_lattice_backward", "kl_normal_std_multi",
                         "kl_normal_std_multi_backward", "sample_normal_fused"):
            r["empty_launch_ms"] = primary[0]["empty_launch_ms"]
    print(json.dumps({"kernels": primary}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
