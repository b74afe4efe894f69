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
* train from config: CdSprites+ level 1 made at 6,000 samples,
  ``configs/round5/cdl1_r5_poe.yml`` trained for 1 resident epoch through
  ``main`` (under ``torch.profiler``) and 1 per-batch epoch,
  ``configs/config_cdspritesplus.yml`` (MOE) for 1 epoch; the run directory
  restored through ``MultimodalVAEInfer`` and served by
  ``serving/server.py --model`` in a process of its own;
* eval from config: each of those runs ends in ``Trainer.test()``, which
  trains the CdSprites+ judge on the card (once; the MOE run loads it),
  scores cross- and joint-coherence from the prior, ex-post and fitted-GMM
  sources and writes ``cdspritesplus_stats.txt``; the eval CLI
  (``eval_cdsprites -p``) gives the same stats from the cache in a process
  of its own, started as a plain ``python -m``, and cross- and prior joint
  generation agree with the CPU's;
* the paper's MoPoE and DMVAE configs trained and scored with the same
  judge ("zoo from config"), on a second level-1 set of 3,000 rows
  (ZOO_DATA_COUNT), as the mixture prior's, the zoo remainder's and the
  trunk install's runs below;
* SPRITES from its configs ("sprites from config"): the clips made by the
  port's generator, ``configs/round4/sprites_r4_dreg_up.yml`` (MOE, DReG,
  K 5) trained for 1 resident epoch through ``main`` and
  ``configs/round2/sprites_r2_poe.yml`` (POE) for 1, each ending in
  ``Trainer.test()`` and the SPRITES benchmark (its two video judges
  trained on the card, then cached); the judges' CLI, and the judges and
  both models on the card against the CPU;
* the mixture prior from its config ("mog from config"):
  ``configs/round4/cdl1_r4_mog.yml`` (MOE, DReG K 10, 50 components)
  trained for 1 resident epoch on the 3,000 rows, ending in
  ``Trainer.test()``; its step on the card against the CPU in float64, and
  POE's and MOE ELBO's under the mixture;
* CelebA, CUB and the synthetic set from their configs ("celeba and cub
  from config"): the surrogates made by the port's builders, masked
  attention at CUB's 246-character captions against its plain version,
  the two CelebA (POE), two CUB (MOE, MOE DReG K 10) and the synthetic
  configs trained for 1 resident epoch each, each family's first ending in
  ``Trainer.test()`` and its benchmark (judges trained on the card);
* VILANRO from its configs ("vilanro from config"): the data collected by
  the port's LANRO collector (2,000 episodes by each of three recipes),
  masked attention at its head dim 16 and the PoE lattice at its shapes
  against their plain versions, ``configs/config_vilanro.yml``,
  ``round3/vilanro_r3_tokens.yml`` and ``round3/vilanro_r3_way_p2.yml``
  (the three action encodings) trained for 1 resident epoch each under
  ``torch.profiler``; on the first, the closed loop (``vilanro_test``
  open loop and replanning), the grounding probe, a DAgger round, and its
  step on the card against the CPU; then VILANRO's conditioned configs
  ("vilanro cond from config", their data at 2,000 episodes a recipe) and
  FashionMNIST ("fashionmnist from config");
* MNIST-SVHN and PolyMNIST from their configs ("digits from config"): both
  surrogates made by the port's builders from the 8x8 digits (PolyMNIST
  at 4,000 train rows, POLYMNIST_COUNTS), the two
  MNIST-SVHN configs (MOE, DReG K 30, Laplace posteriors; no kernel at
  all) and the two PolyMNIST configs (POE and MoPoE over 5 modalities,
  the PoE lattice at M 5) trained for 1 resident epoch each, the first of
  each family ending in ``Trainer.test()`` and its benchmark; a DReG and
  a MoPoE step on the card against the CPU in float64;
* the rest of the model zoo ("zoo remainder from config"): shipped configs
  edited in the run, trained for 1 resident epoch each on the 3,000
  CdSprites+ rows and SPRITES clips above: the unimodal VAE (the image alone under
  ELBO, ending in ``Trainer.test()``, and under DReG K 10; the text alone
  under ``prior: gumbel``), two CdSprites+ POE configs with the ViT, GRU
  and conv-text nets and the residual conv nets, and a SPRITES POE config
  with the TransformerIMG nets; each restored, and a step of each on the
  card against the CPU in float64; masked attention at the new nets'
  shapes (head dim 64 among them) and the KL kernel at M 1 timed;
* the rest of eval ("eval remainder from config"): ``config_celeba.yml``
  with its image loss edited to the perceptual ``feature_loss`` (the
  frozen VGG extractor's fixed random weights) trained for 1 resident
  epoch on the CelebA surrogate above, its steps profiled, a step as POE
  ELBO and as MOE IWAE K 5 on the card against the CPU in float64, the
  FID on the card against the CPU; then synthetic torchvision-layout
  ``vgg19``, ``inception_v3`` and ``resnet50`` files: VGGFeatures and
  InceptionV3 on the card against the CPU in float64, and the ResNet-50
  trunk installed by ``Trainer.init_state``.  CUB's ``test()`` in the
  families phase reports its ``fid`` with the feature net's label;
* precision bf16 ("bf16 steps", "bf16 from config"): each bf16 launcher
  (masked attention, the sparse forward, dq, dk/dv) against the fp32
  kernel on the widened inputs and the plain version, the variant it took
  and two launches bit for bit; the bf16 tensor-core attention and sparse
  forward, dq and dk/dv timed in turns with the widening kernels they
  replace (the attention at every bf16 shape with the tensor-core kernel
  too: the crossover's A/B; the sparse ones' widening yardsticks bit for
  bit the fp32 kernels rounded once) and entered in the kernels line with
  their launches on the bf16 paths; the flagship POE and MOE steps and the
  VideoGPTSparse step in bf16, card against the CPU's bf16 within the bf16
  yardstick, their p50 in fp32 and bf16 at bs 24 and 256 and their
  ``ops.flops.step_flops``, equal on the card and the CPU; then
  ``cdl1_r5_poe.yml`` through the CLI with ``--precision bf16`` beside the
  same epoch in fp32, each ending in ``Trainer.test()``, the bf16 run
  restored into an fp32 model, and ``sprites_r4_dreg_up`` 1 epoch in bf16,
  profiled;
* multi-device training on the one card ("multi-device"; not scaling: one
  card): the flagship POE and MOE steps through the data-parallel path in a
  world-1 NCCL group, bit for bit the one-process steps, and on two gloo
  ranks of the card (each on its half of the batch, the gradients summed)
  within the training limit of the one-process step, each rank's launches
  counted; then ``parallel.dryrun.dryrun_multichip(4)`` on four gloo ranks
  (the 2x2 hybrid mesh, megatron-sharded DTensor parameters);
* seeded runs reproduce ("seeded reruns"): two plain ``python -m
  multimodal_vae_comparison_tpu_torch.main`` children train
  ``cdl1_r5_poe.yml`` for 1 epoch on the same 3,000 rows, each training its
  own judge, and write the same checkpoints, judge weights and stats byte
  for byte; the SPRITES MOE of ``sprites_r4_dreg_up.yml``, the
  VideoGPTSparse step and the ResNet-50 MoPoE family, each a few steps
  twice in this process in fp32 and in bf16, bit for bit leaf by leaf.

The script sets no numerics of its own: the port's entry points set them
(``device.set_numerics``: fp32 without TF32, cuDNN's deterministic
algorithms), and it checks and prints them once the first has resolved the
card.  ``python3 chip_smoke.py numerics_cost`` times what that policy costs
against PyTorch's defaults, and ``python3 chip_smoke.py seeded_prints``
prints the reruns' leaves for a comparison across processes.

Each path runs with the kernel counts set to 0 just before it and read just
after, and must have launched every kernel it goes through and taken no
plain version (the masked attention's few-keys kernel on the serving and
training paths, its short bf16 kernel on the bf16 configs').  Then it times
the kernels (the few-keys kernel at every decoder shape beside the resident
route before it), the engine and the train step,
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
# at 6,000 rows (5,399 train, 599 test), cut from generate_level's own
# default of 10,000 to keep the script within its time limit with the
# seeded reruns; the POE config 1 resident epoch, then 1 per-batch one (its
# second resident epoch was cut for the same reason)
FROM_CONFIG = (("POE cdl1_r5_poe", "configs/round5/cdl1_r5_poe.yml", 1),
               ("MOE cdspritesplus", "configs/config_cdspritesplus.yml", 1))
DATA_COUNT = 6000
# the rows of the numerics cost's cdl1_r5_poe epoch: the level's default,
# as quality_run.py trains it
COST_DATA_COUNT = 10000
# the CdSprites+ level of the phases after "train from config" (the paper's
# MoPoE and DMVAE, the mixture prior, the zoo remainder, the trunk
# install): 2,699 train rows, cut from DATA_COUNT to keep the script within
# its time limit on a slow host; the judge they score with is the one
# "train from config" caches
ZOO_DATA_COUNT = 3000
# objective calls that launch each kernel once per the count given: the
# POE objective runs attention in the text encoder and the text decoder and
# PoE once for the whole subset lattice; the MOE objective the same
# attention and KL once for all modalities.  A train step and a validation
# batch both make one call; a train step also runs one backward of each
PER_OBJECTIVE = {"poe": {"attention": 2, "poe": 1}, "moe": {"attention": 2, "kl": 1},
                 # MoPoE: PoE once for the fully present subsets, one text
                 # decode; DMVAE: the joint's PoE, every private KL in one
                 # launch, the text decoded from its own, the joint and the
                 # image's shared sample
                 "mopoe": {"attention": 2, "poe": 1},
                 "dmvae": {"attention": 4, "poe": 1, "kl": 1}}
PER_BACKWARD = {"poe": {"poe_bwd": 1}, "moe": {"kl_bwd": 1}, "mopoe": {"poe_bwd": 1},
                "dmvae": {"poe_bwd": 1, "kl_bwd": 1}}
# launches a train step on each route of the PoE and KL kernels: the
# lattice route, and the route before it that kernel_variants.old_route
# keeps (a PoE launch per subset, a KL launch per modality, each backward
# in torch ops)
ROUTE_PER_STEP = {mixing: {"new": {**PER_OBJECTIVE[mixing], **PER_BACKWARD[mixing]}}
                  for mixing in ("poe", "moe")}
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
# poe_lattice's per-subset prior bitmask: every subset of M experts (E = 1
# ... M each) with the prior expert on none, on all (POE) and on the full
# set only (MoPoE); and PolyMNIST's MoPoE shape, M 5 of (128, 24)
PRIOR_MASK_EXPERTS = (2, 3, 4, 5)
PRIOR_MASKS = ("none", "all", "full")
POLYMNIST_ROWS, POLYMNIST_LATENTS = 128, 24
# the paper's four-model CdSprites+ comparison, level 1: (label, config,
# mixing).  ResNet-50 (Enc_CNN) images, 16 shared + 10 private latents
ZOO = (("MVAE", "configs/reproduce_paper/mvae/level1/level1_0.yml", "poe"),
       ("MMVAE", "configs/reproduce_paper/mmvae/level1/level1_0.yml", "moe"),
       ("MoPoE", "configs/reproduce_paper/mopoe/level1/level1_0.yml", "mopoe"),
       ("DMVAE", "configs/reproduce_paper/dmvae/level1/level1_0.yml", "dmvae"))
# the two the port newly trains from their configs: 1 resident epoch each
ZOO_FROM_CONFIG = ("MoPoE", "DMVAE")
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


def module_argv(module: str, *args: str) -> list:
    """``python -m module args``, as a user starts an entry point: nothing of
    this process's settings goes with it.  The entry point sets the port's
    numerics itself (``device.set_numerics``), so a child whose results are
    held against this process's computes as this process does."""
    return [sys.executable, "-m", module, *args]


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
    if isinstance(eps, np.ndarray):
        return torch.from_numpy(eps).to(device)
    return [torch.from_numpy(v).to(device) for v in eps]


def paper_config(path: str):
    """The Config of a reproduce_paper YAML for its model alone: no run
    directory, CdSprites+'s feature dims filled in."""
    from multimodal_vae_comparison_tpu_torch.config import Config
    cfg = Config(os.path.join(HERE, path), eval_only=True)
    for mod, dims in zip(cfg.mods, ([64, 64, 3], [SEQ_LEN, VOCAB])):
        mod.feature_dims = dims
    return cfg


def zoo_eps(model, rng: np.random.Generator, n: int):
    """Standard-normal draws, as numpy, in the form the model's objective and
    its forward over every modality take: one (K, n, D) per subset (POE),
    per modality (MOE), the joint's one (MoPOE), or DMVAE's list in its
    order of draws."""
    kind, shape = type(model).__name__, (model.K, n, model.n_latents)
    if kind == "DMVAE":
        return [rng.standard_normal(s).astype(np.float32)
                for s in model.eps_shapes(model.mod_names, n)]
    if kind == "MoPOE":
        return rng.standard_normal(shape).astype(np.float32)
    if kind == "MOE":
        return {name: rng.standard_normal(shape).astype(np.float32)
                for name in model.mod_names}
    return [rng.standard_normal(shape).astype(np.float32)
            for _ in range(2 ** len(model.specs) - 1)]


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


def attended_keys(tk: int, mask: torch.Tensor) -> int:
    """The keys masked attention needs under the (B, Tk) key ``mask``,
    summed over the batch: a masked key adds exactly 0 to its row's output,
    so a row needs only its valid keys (all ``tk`` where every key of the
    row is masked: its output is then the mean of every value row)."""
    valid = mask.sum(dim=1)
    return int(torch.where(valid == 0, tk, valid).sum().item())


def attention_bound(b, h, tq, tk, dh, mask=None):
    """:func:`bound_ms` of masked attention's forward over the keys it
    needs (:func:`attended_keys`): Q read and O written in full, K and V
    read at the needed keys, the mask read; two products and the softmax's
    four operations per needed (query, key) pair."""
    keys = b * tk if mask is None else attended_keys(tk, mask)
    nbytes = 4 * (2 * b * h * tq * dh + 2 * h * keys * dh) + (0 if mask is None else b * tk)
    return bound_ms(nbytes, 4 * h * tq * keys * dh + 4 * h * tq * keys)


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


def resident_fits(b, h, tq, tk, dh) -> bool:
    """Whether csrc/attention.cu's plan_resident gives the head to the
    resident kernel: at most 256 keys (8 a lane) and K, V, Q's rows and the
    probabilities within 200 KB of shared memory at its row split."""
    kpl = -(-tk // 32)
    if kpl > 8:
        return False
    kpl = kpl if kpl <= 2 else 4 if kpl <= 4 else 8
    dh4, tk4, tkp = (dh + 3) & ~3, (tk + 3) & ~3, kpl * 32
    kstride = 4 * (((dh + 3) >> 2) | 1)
    bh, sms = b * h, 132
    split = min(1 if bh >= sms else -(-2 * sms // bh), -(-tq // 16))
    while True:
        rows = -(-(-(-tq // split)) // 4) * 4
        nsplit, nwarps = -(-tq // rows), min(rows // 4, 16)
        smem = 4 * (tk * kstride + tk4 * dh4 + rows * dh4 + tkp + nwarps * 4 * tkp)
        if smem <= 200 * 1024 or rows == 4:
            return smem <= 200 * 1024 and nsplit <= 65535
        split *= 2


def attention_variant(shape, dtype=torch.float32) -> str:
    """The kernel csrc/attention.cu's launcher takes at a model path's
    (B, H, Tq, Tk, Dh) on 16-byte aligned ``dtype`` inputs: on bf16 the
    few-keys kernel for one key under more query rows, else the tensor-core
    kernel from a side of 16 (Dh % 8 == 0, Dh <= 64, Tk <= 8192), under it
    the short kernel; else (fp32, or bf16 widened) the few-keys kernel for
    at most 8 keys, the fp32 tensor-core kernel (``mma``: Dh a multiple of
    4 from 8, Tk <= 2^22) where the resident kernel cannot hold the head
    (:func:`resident_fits`) or Tq and Tk both exceed 16, the resident
    kernel where it holds the head, or the chunked one."""
    b, h, tq, tk, dh = shape
    if dtype == torch.bfloat16:
        if tk == 1 and tq > 1:
            return "few_keys"
        if dh % 8 == 0 and dh <= 64 and (tq >= 16 or tk >= 16) and tk <= 8192:
            return "tc_bf16"
        if dh % 8 == 0 and dh <= 64 and tq < 16 and tk < 16:
            return "short_bf16"
    if tk <= 8:
        return "few_keys"
    fits = resident_fits(b, h, tq, tk, dh)
    if dh % 4 == 0 and dh >= 8 and tk <= 1 << 22 and (not fits or (tq > 16 and tk > 16)):
        return "mma"
    return "resident" if fits else "chunked"


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


def dead_key_tiles(mask: torch.Tensor) -> torch.Tensor:
    """(B, Tk) bool: the keys that the resident, mma and chunked attention
    kernels skip, those of the 32-key tiles (keys 32c .. 32c + 31) whose
    keys are all masked in a batch element that has a visible key."""
    b, tk = mask.shape
    tiles = -(-tk // 32)
    padded = torch.zeros(b, tiles * 32, dtype=torch.bool, device=mask.device)
    padded[:, :tk] = mask
    live = padded.view(b, tiles, 32).any(-1).repeat_interleave(32, dim=1)[:, :tk]
    return ~live & mask.any(dim=1, keepdim=True)


def attention_yardstick(symbol: str, q, k, v, mask):
    """An exported entry point of csrc/attention.cu that the port never
    calls (the launcher's arguments less ``variant``), at (q, k, v, mask):
    returns (run, out), ``run`` launching it into ``out`` on the current
    stream."""
    import ctypes
    import math
    from multimodal_vae_comparison_tpu_torch.ops.kernels import _build
    fn = _build.function("attention", symbol, [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                         + [ctypes.c_float, ctypes.c_void_p])
    b, h, tq, dh = q.shape
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)

    def run():
        _build.check("attention", fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), None if mask is None else mask.data_ptr(),
            out.data_ptr(), b, h, tq, k.shape[2], dh, 1.0 / math.sqrt(dh),
            torch.cuda.current_stream().cuda_stream))
    return run, out


def padded_tiles_check(card: str, label: str, q, k, v, mask, got) -> dict:
    """The skipping of all-masked key tiles at a key-padded fp32 shape of
    the resident, mma or chunked route, ``got`` being the launcher's output:
    equal (``torch.equal``) to the dense design that skips nothing
    (``masked_attention_forward_dense``) and to the launcher's output with
    the dead tiles' K and V rows set to NaN (skipped, not multiplied by 0);
    then the launcher and the dense design timed in turns (device ms,
    graphed).  Returns the numbers."""
    from multimodal_vae_comparison_tpu_torch.ops.kernels import attention
    dense_run, dense = attention_yardstick("masked_attention_forward_dense", q, k, v, mask)
    dense_run()
    dead = dead_key_tiles(mask)
    hole = dead[:, None, :, None]
    poisoned = attention._launch(q, k.masked_fill(hole, float("nan")),
                                 v.masked_fill(hole, float("nan")), mask)
    torch.cuda.synchronize()
    check(torch.equal(got, dense), f"attention {label}: the tile skipping differs from the "
          f"dense design by {(got - dense).abs().max().item():.3e}")
    check(torch.equal(got, poisoned), f"attention {label}: NaN in the dead key tiles reached "
          f"the output ({int(torch.isnan(poisoned).sum())} NaN)")
    launcher = lambda: attention._launch(q, k, v, mask)  # noqa: E731
    ms = [graph_ms(launcher)]
    dense_ms = [graph_ms(dense_run), graph_ms(dense_run)]
    ms.append(graph_ms(launcher))
    numbers = {"dead_key_share": dead.float().mean().item(), "ms": ms, "dense_ms": dense_ms}
    print(f"time masked_attention dead tiles [{label}]: dead keys {numbers['dead_key_share']:.3f}"
          f", skipping {ms[0]:.5f} / {ms[1]:.5f} ms, dense {dense_ms[0]:.5f} / "
          f"{dense_ms[1]:.5f} ms; equal to the dense design and with NaN in the dead tiles "
          f"on {card}")
    return numbers


# (B, H, Tq, Tk, Dh), masked: the few-keys kernel's shapes on the model
# paths: Dec_TransformerCond's cond_always lattice and per-subset decodes
# (z and the instruction's 4 words, or z alone), CUB's DReG text decoder,
# VILANRO's action and language decoders, Dec_TransformerIMG, the flagship
# text decoder at bs 24 and at the serving batch
FEW_KEYS_SHAPES = (((448, 4, 100, 5, 32), True), ((64, 4, 100, 5, 32), True),
                   ((64, 4, 100, 1, 32), False), ((640, 2, 246, 1, 8), False),
                   ((448, 2, 100, 1, 16), False), ((448, 2, 4, 1, 16), False),
                   ((112, 4, 8, 1, 64), False), ((24, 2, 45, 1, 8), False),
                   ((256, 2, 45, 1, 8), False))


def phase_parity():
    from multimodal_vae_comparison_tpu_torch.ops.kernels import attention, poe_kernel
    from multimodal_vae_comparison_tpu_torch.ops.kernels import telemetry
    g = torch.Generator(device="cuda").manual_seed(0)
    # (B, H, Tq, Tk, Dh), masked (with one fully masked row), the kernel the
    # launcher picks.  The model's two shapes, then the key counts around a
    # warp's 32 lanes and a lane's 1, 2, 4 and 8 keys, head widths off the
    # 16-byte grid, few heads (split by query rows), the resident kernel's
    # heads of 16 query rows beside the fp32 tensor-core kernel's from 17,
    # heads that the resident path cannot hold (Tk > 256, not a multiple of
    # 32; K and V over the shared memory) on the tensor-core kernel, a head
    # of Dh 6 past 256 keys that still takes the chunked kernel, and the few-keys
    # kernel at every decoder shape of the model paths (Dec_TransformerCond,
    # CUB, VILANRO, Dec_TransformerIMG, the flagship)
    for shape, masked, variant in (((128, 2, 45, 45, 32), True, "mma"),
                                   ((128, 2, 45, 1, 8), False, "few_keys"),
                                   ((4, 2, 130, 130, 16), True, "mma"),
                                   ((4, 2, 16, 130, 16), True, "resident"),
                                   ((3, 2, 9, 1, 8), True, "few_keys"),
                                   ((3, 2, 9, 31, 6), True, "resident"),
                                   ((3, 2, 9, 32, 6), False, "resident"),
                                   ((3, 2, 9, 33, 6), True, "resident"),
                                   ((2, 2, 45, 45, 5), False, "resident"),
                                   ((2, 3, 50, 200, 32), True, "mma"),
                                   ((2, 3, 16, 200, 32), True, "resident"),
                                   ((2, 2, 9, 33, 128), False, "resident"),
                                   ((1, 2, 1000, 45, 32), True, "mma"),
                                   ((2, 2, 20, 1000, 16), True, "mma"),
                                   ((2, 2, 20, 256, 128), True, "mma"),
                                   ((1, 1, 300, 300, 64), True, "mma"),
                                   ((3, 2, 40, 300, 68), True, "mma"),
                                   ((2, 2, 20, 300, 6), True, "chunked"),
                                   *((shape, masked, "few_keys") for shape, masked in
                                     FEW_KEYS_SHAPES)):
        q, k, v, mask = attention_inputs(g, *shape, masked)
        telemetry.reset()
        got = attention.masked_attention(q, k, v, mask)
        took = telemetry.variants()
        again = attention.masked_attention(q, k, v, mask)
        want = attention.attention_reference(q, k, v, mask)
        torch.cuda.synchronize()
        check(torch.equal(got, again), f"attention at {shape}: two launches differ")
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


def lattice_inputs(g: torch.Generator, m: int, rows: int, d: int = N_LATENTS):
    """M expert (or posterior) means and stddevs of (rows, d)."""
    mus = [torch.randn(rows, d, generator=g, device="cuda") for _ in range(m)]
    scales = [torch.rand(rows, d, generator=g, device="cuda") * 1.7 + 0.3
              for _ in range(m)]
    return mus, scales


def prior_mask(kind: str, subsets: int) -> int:
    """The prior bitmask of ``kind`` over a whole lattice, whose last subset
    is the full set: on no subset, on all, or on the full set only."""
    return {"none": 0, "all": (1 << subsets) - 1, "full": 1 << (subsets - 1)}[kind]


def _lattice_case(g, m, lattice, rows, prior, mask=None, d=N_LATENTS):
    """poe_lattice at one shape, (rows, d) an expert: one forward and one
    backward launch; the kernels against the plain versions (the closed
    forms summed in the same order), the gradients against autograd through
    the plain forward."""
    from multimodal_vae_comparison_tpu_torch.ops.kernels import poe_kernel
    from multimodal_vae_comparison_tpu_torch.ops.kernels import telemetry
    mus, scales = lattice_inputs(g, m, rows, d)
    ups = [torch.randn((len(lattice), rows, d), generator=g, device="cuda")
           for _ in range(2)]
    leaves = [x.clone().requires_grad_() for x in mus + scales]
    telemetry.reset()
    mu, scale = poe_kernel.poe_lattice(leaves[:m], leaves[m:], lattice, prior, mask)
    grads = torch.autograd.grad((mu, scale), leaves, ups)
    took = telemetry.launches()
    mu, scale = mu.detach(), scale.detach()
    want = poe_kernel.poe_lattice_reference(mus, scales, lattice, prior, mask)
    want_grads = sum(poe_kernel.poe_lattice_backward_reference(
        mus, scales, mu, scale, *ups, lattice), [])
    torch.cuda.synchronize()
    label = (f"poe_lattice M={m} S={len(lattice)} ({rows}, {d}) p0={prior}"
             + ("" if mask is None else f" prior mask {mask:#x}"))
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
    _grad_parity(label, lambda *x: poe_kernel.poe_lattice(x[:m], x[m:], lattice, prior, mask),
                 lambda *x: poe_kernel.poe_lattice_reference(x[:m], x[m:], lattice, prior,
                                                             mask),
                 mus + scales, ups, POE_BWD_RTOL, POE_BWD_ATOL)


def phase_lattice_parity():
    """poe_lattice and kl_normal_std_multi at the shapes of LATTICE_SHAPES
    and KL_MULTI_SHAPES, and poe_lattice with each prior bitmask of
    PRIOR_MASKS at every M of PRIOR_MASK_EXPERTS: one forward and one
    backward launch per call, each checked by :func:`_lattice_case` (the
    KL's likewise)."""
    from multimodal_vae_comparison_tpu_torch.ops.fusion import subset_lattice
    from multimodal_vae_comparison_tpu_torch.ops.kernels import kl_kernel
    from multimodal_vae_comparison_tpu_torch.ops.kernels import telemetry
    g = torch.Generator(device="cuda").manual_seed(7)
    for m, lattice, rows, prior in LATTICE_SHAPES:
        _lattice_case(g, m, lattice or subset_lattice(m), rows, prior)
    for m in PRIOR_MASK_EXPERTS:
        lattice = subset_lattice(m)
        for kind in PRIOR_MASKS:
            _lattice_case(g, m, lattice, TRAIN_BATCH, 1.0, prior_mask(kind, len(lattice)))
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


def _worst_leaf(got, want, rel, atol=1e-5, key_bias_scale=False):
    """(worst error as a share of its limit rel * max|g| + atol, leaf name).

    With ``key_bias_scale`` an attention layer's key bias is held to the
    max |g| of its key weight: its exact gradient is 0 (a row's softmax is
    invariant to a shift all its keys share), so each side's is rounding
    noise far below the key weight's, which at the gradients of VILANRO's
    second-slice configs (llik 600, the aux term at weight 1e4) exceeds
    the 1e-5 floor."""
    worst, worst_name = 0.0, None
    for n in want:
        scale = want[n[:-len("bias")] + "weight"] if (
            key_bias_scale and n.endswith("key.bias")) else want[n]
        ratio = (got[n] - want[n]).abs().max().item() \
            / (rel * scale.abs().max().item() + atol)
        if ratio > worst:
            worst, worst_name = ratio, n
    return worst, worst_name


def phase_training_parity():
    """Each training model's objective and gradients on the card (kernels)
    vs the CPU (plain versions): same seeded weights, batch and eps, the
    CPU on the card's relu branches (:func:`same_branches`; from flax's
    zero biases an element within rounding of 0 turned up in the flagship
    decoder's transposed convs, 14 times the limit on its own)."""
    from multimodal_vae_comparison_tpu_torch.training.trainer import build_model
    rng = np.random.default_rng(11)
    raw = make_inputs(rng, TRAIN_BATCH)
    for label, mixing, obj in training_models():
        eps = numpy_eps(rng, mixing, TRAIN_BATCH)
        out, branches, flips = {}, [], {}
        for dev in ("cuda", "cpu"):
            model = build_model(flagship_specs(), mixing, N_LATENTS, obj=obj, seed=0,
                                device=dev)
            with same_branches(branches, dev == "cpu", flips):
                out[dev] = _objective_grads(model, torch_batch(raw, dev), eps_to(eps, dev))
        (gl, gm, gg), (cl, cm, cg) = out["cuda"], out["cpu"]
        print(f"train parity {label}: loss cuda {gl:.6f} cpu {cl:.6f}; metrics "
              + ", ".join(f"{k} {gm[k]:.6f}/{cm[k]:.6f}" for k in sorted(gm))
              + f"; elements where the CPU's own branch differs from the card's {flips} "
              f"of {sum(x.numel() for x in branches)} recorded")
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


@contextlib.contextmanager
def same_branches(branches: list, replay: bool, flips: dict):
    """``F.relu`` and ``F.max_pool2d`` that record, in call order, the branch
    each element took (the sign of the relu's input, the pool's argmax),
    or, with ``replay``, take the branches another run recorded: ``relu(x)``
    becomes ``x * mask`` and the pool gathers at the recorded argmax.
    ``flips`` counts the elements whose own branch differs from the
    recorded one.  Two fp32 runs that round in another order can put an
    input within rounding of a kink on either side of it, and one such
    element moves its layer's gradient by about 1e-2 of max |g| (seen: the
    ResNet-50 at its seeded init, one relu of about five million, both on
    the CPU against float64 and on the card against the CPU); on the same
    branches the gradients are smooth functions of the rounding.  A replay
    that has used every recorded branch takes the ops' own from there (the
    timed steps after a checked one)."""
    import torch.nn.functional as F
    relu, pool = F.relu, F.max_pool2d
    recorded = iter(branches)

    def relu_(x, inplace=False):
        if not replay:
            branches.append(x.detach() > 0)
            return relu(x, inplace=inplace)
        mask = next(recorded, None)
        if mask is None:
            return relu(x, inplace=inplace)
        mask = mask.to(x.device)
        flips["relu"] = flips.get("relu", 0) + int((mask != (x.detach() > 0)).sum())
        return x * mask.to(x.dtype)

    def pool_(x, kernel_size, stride=None, padding=0, dilation=1, ceil_mode=False,
              return_indices=False):
        out, idx = pool(x, kernel_size, stride, padding, dilation, ceil_mode,
                        return_indices=True)
        recorded_idx = next(recorded, None) if replay else None
        if recorded_idx is not None:
            own, idx = idx, recorded_idx.to(x.device)
            flips["max_pool2d"] = flips.get("max_pool2d", 0) + int((own != idx).sum())
            out = x.flatten(2).gather(2, idx.flatten(2)).view(idx.shape)
        elif not replay:
            branches.append(idx.detach())
        return (out, idx) if return_indices else out

    F.relu, F.max_pool2d = relu_, pool_
    try:
        yield
    finally:
        F.relu, F.max_pool2d = relu, pool


def phase_zoo_parity():
    """The paper's four families (ZOO) built from their level-1 configs at
    full width (ResNet-50 images, 16 + 10 latents): on one batch of
    TRAIN_BATCH, the objective's loss, metrics and every gradient on the
    card (kernels, TF32 off) against the CPU's plain path, on the same
    seeded weights and draws, the CPU on the branches of relu and max-pool
    that the card took (:func:`same_branches`; the elements where its own
    would differ are counted); the card's call launches each kernel of its
    family once forward and once backward, and no plain version.  Returns
    {label: numbers}."""
    from multimodal_vae_comparison_tpu_torch.models.encoders import Enc_CNN
    from multimodal_vae_comparison_tpu_torch.ops.kernels import telemetry
    from multimodal_vae_comparison_tpu_torch.training.trainer import build_model_from_config
    rng = np.random.default_rng(18)
    raw = make_inputs(rng, TRAIN_BATCH)
    numbers = {}
    for label, path, mixing in ZOO:
        cfg = paper_config(path)
        out, seconds, eps, branches, flips = {}, {}, None, [], {}
        for dev in ("cuda", "cpu"):
            model = build_model_from_config(cfg, device=dev)
            check(cfg.mixing == mixing and isinstance(model.enc_mod_1, Enc_CNN),
                  f"{label}: {path} built {type(model).__name__} on "
                  f"{type(model.enc_mod_1).__name__}")
            if eps is None:
                eps = zoo_eps(model, rng, TRAIN_BATCH)
            n_params = sum(p.numel() for p in model.parameters())
            telemetry.reset()
            t0 = time.perf_counter()
            with same_branches(branches, dev == "cpu", flips):
                out[dev] = _objective_grads(model, torch_batch(raw, dev), eps_to(eps, dev))
            seconds[dev] = time.perf_counter() - t0
            if dev == "cuda":
                launches, paths = telemetry.launches(), telemetry.summary()
            del model
        (gl, gm, gg), (cl, cm, cg) = out["cuda"], out["cpu"]
        want = expected_launches(mixing, 1, 1)
        worst, worst_name = _worst_leaf(gg, cg, GRAD_REL, GRAD_ATOL)
        print(f"zoo parity {label} ({path}, {n_params} parameters): loss cuda {gl:.6f} cpu "
              f"{cl:.6f}; metrics " + ", ".join(f"{k} {gm[k]:.6f}/{cm[k]:.6f}" for k in sorted(gm))
              + f"; {len(cg)} gradient leaves, worst error {worst:.3f} of its limit at "
              f"{worst_name} (limit {GRAD_REL} x max|g| + {GRAD_ATOL}); launches {launches}, "
              f"expected {want}; elements where the CPU's own branch differs from the card's "
              f"{flips} of {sum(x.numel() for x in branches)} recorded; objective + backward "
              f"{seconds['cuda']:.3f} s on the card, {seconds['cpu']:.3f} s on the CPU")
        check(launches == want, f"{label}: launched {launches}, expected {want}")
        check(not any(k.endswith(":plain") for k in paths),
              f"{label}: a plain version ran on the card: {paths}")
        check(np.isfinite(gl) and abs(gl - cl) <= TRAIN_RTOL * abs(cl),
              f"{label}: loss {gl} on the card vs {cl} on the CPU")
        check(sorted(gm) == sorted(cm), f"{label}: metric keys differ")
        for k in gm:
            check(abs(gm[k] - cm[k]) <= TRAIN_RTOL * abs(cm[k]) + 1e-4,
                  f"{label}: metric {k} {gm[k]} on the card vs {cm[k]} on the CPU")
        check(worst <= 1.0, f"{label}: gradient of {worst_name} differs between the card "
              "and the CPU")
        numbers[label] = {"params": n_params, "loss_cuda": gl, "loss_cpu": cl,
                          "worst_grad_share_of_limit": worst, "worst_leaf": worst_name,
                          "launches": launches, "branch_flips": flips,
                          "card_s": seconds["cuda"], "cpu_s": seconds["cpu"]}
    return numbers


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
    # the prior bitmask's route, as MoPoE takes it (the prior expert on the
    # full set only), beside the same lattice without a mask: at the
    # flagship's lattice and at PolyMNIST's M 5 of (128, 24)
    full_only = prior_mask("full", s)
    times["fwd_mask"] = graph_ms(lambda: poe_kernel.poe_lattice(mus, scales, lattice, 1.0,
                                                                full_only))
    pm, ps = lattice_inputs(g, 5, POLYMNIST_ROWS, POLYMNIST_LATENTS)
    k5, n5 = len(lattice5), POLYMNIST_ROWS * POLYMNIST_LATENTS
    masks5, full5 = poe_kernel.lattice_masks(lattice5, 5), prior_mask("full", k5)
    ups5 = [torch.randn((k5, POLYMNIST_ROWS, POLYMNIST_LATENTS), generator=g, device="cuda")
            for _ in range(2)]
    mu5, scale5 = poe_kernel.poe_lattice(pm, ps, lattice5, 1.0, full5)

    def bwd5():
        return poe_kernel._launch_backward(pm, ps, masks5, mu5, scale5, *ups5)

    times["fwd_m5_poly"] = graph_ms(lambda: poe_kernel.poe_lattice(pm, ps, lattice5, 1.0))
    times["fwd_m5_poly_mask"] = graph_ms(lambda: poe_kernel.poe_lattice(pm, ps, lattice5, 1.0,
                                                                        full5))
    times["fwd_m5_poly_plain"] = graph_ms(lambda: poe_kernel.poe_lattice_reference(
        pm, ps, lattice5, 1.0, full5))
    times["bwd_m5_poly"] = graph_ms(bwd5)
    times["bwd_m5_poly_plain"] = graph_ms(lambda: poe_kernel.poe_lattice_backward_reference(
        pm, ps, mu5, scale5, *ups5, lattice5))
    want5 = poe_kernel.poe_lattice_reference(pm, ps, lattice5, 1.0, full5)
    err_mask = max((a - w).abs().max().item() for a, w in zip((mu5, scale5), want5))
    check(err_mask <= POE_ATOL + POE_RTOL * max(w.abs().max().item() for w in want5),
          f"poe_lattice M 5 of (128, 24) with the prior on the full set: max_abs_err {err_mask}")
    sizes5 = sum(len(sub) for sub in lattice5)
    fwd5_bound = bound_ms(4 * (2 * 5 * n5 + 2 * k5 * n5), n5 * (4 * 5 + 2 * sizes5 + 4 * k5))
    bwd5_bound = bound_ms(4 * (2 * 5 * n5 + 4 * k5 * n5 + 2 * 5 * n5),
                          n5 * (6 * 5 + 5 * k5 + 7 * sizes5))
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
                 "m5_lattice_31_subsets_ms": times["fwd_m5"],
                 "prior_mask_full_set_only_ms": times["fwd_mask"],
                 "polymnist_m5_128x24_ms": times["fwd_m5_poly"],
                 "polymnist_m5_128x24_prior_mask_full_set_only_ms": times["fwd_m5_poly_mask"],
                 "polymnist_m5_128x24_plain_ms": times["fwd_m5_poly_plain"],
                 "polymnist_m5_128x24_bound_ms": fwd5_bound[0],
                 "polymnist_m5_128x24_bound_by": fwd5_bound[1],
                 "polymnist_m5_128x24_prior_mask_max_abs_err": err_mask})
    rows.append({"name": "poe_lattice_backward", "at": at, **common,
                 "replaces": f"{ref}/poe_kernel.py:124 (_poe_bwd, the VJP of :48)",
                 "max_abs_err": err_bwd, "ms": times["bwd"], "ms_again": times["bwd_again"],
                 "plain_ms": times["bwd_plain"], "bound_ms": bwd_bound[0],
                 "bound_by": bwd_bound[1], "eager_ms": times["bwd_eager"],
                 "old_route_ms": times["bwd_old"], "old_route_eager_ms": times["bwd_old_eager"],
                 "polymnist_m5_128x24_prior_mask_full_set_only_ms": times["bwd_m5_poly"],
                 "polymnist_m5_128x24_plain_ms": times["bwd_m5_poly_plain"],
                 "polymnist_m5_128x24_bound_ms": bwd5_bound[0],
                 "polymnist_m5_128x24_bound_by": bwd5_bound[1]})
    print(f"time poe_lattice prior mask (full set only) [{at}]: forward {times['fwd_mask']:.5f} "
          f"ms (no mask {times['fwd']:.5f}); [M=5 S=31 ({POLYMNIST_ROWS}, {POLYMNIST_LATENTS})]: "
          f"forward {times['fwd_m5_poly_mask']:.5f} ms (no mask {times['fwd_m5_poly']:.5f}, "
          f"plain {times['fwd_m5_poly_plain']:.5f}, bound {fwd5_bound[0]:.7f} by "
          f"{fwd5_bound[1]}, max_abs_err {err_mask:.3e}), backward {times['bwd_m5_poly']:.5f} ms "
          f"(plain {times['bwd_m5_poly_plain']:.5f}, bound {bwd5_bound[0]:.7f} by "
          f"{bwd5_bound[1]}) on {card}")
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
    # five batched products (s, dv, dp, dq, dk) over the needed keys; q,
    # d_out and the mask read and dq written in full, k and v read at the
    # needed keys, dk and dv written in full
    keys = attended_keys(SEQ_LEN, mask)
    cells = 2 * SEQ_LEN * keys
    bwd_bound, bwd_by = bound_ms(4 * (5 * q.numel() + 2 * 2 * keys * 32) + mask.numel(),
                                 5 * 2 * cells * 32)
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


# the host calls that each put one kernel, copy or set on a stream (the
# CUDA API's, as torch.profiler names them)
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                "cudaMemcpyAsync", "cudaMemsetAsync", "cudaLaunchCooperativeKernel")


def profile_steps(label, step, batch, gen, n, steps, card):
    """``steps`` warm train steps under ``torch.profiler``; one JSON line with
    host wall ms, device kernel ms, the device's busy share, kernels per step
    (the host's launch calls) beside the device events the profiler kept,
    the port's kernels' device ms and the kernels that take the most device
    time (:func:`device_activity`)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step(batch, generator=gen)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    act = device_activity(prof, wall_ms)
    per_name = act["ms_by_name"]
    port_ms = {k: sum(ms for name, ms in per_name.items() if sym in name) / steps
               for k, sym in PROFILE_SYMBOLS.items()}
    numbers = {
        "model": label, "batch": n, "steps": steps,
        "wall_ms_per_step": wall_ms / steps,
        "kernel_ms_per_step": act["ms"] / steps,
        "device_busy_share": act["busy_share"],
        "kernels_per_step": act["launch_calls"] / steps,
        "device_events_per_step": act["events"] / steps,
        "port_kernels_ms_per_step": {k: ms for k, ms in port_ms.items() if ms},
        "top_kernels_ms_per_step": {
            name[:80]: ms / steps for name, ms in per_name.most_common(5)},
        "card": card}
    print("profile train step " + json.dumps(numbers))
    return numbers


def device_activity(prof, wall_ms: float) -> dict:
    """The CUDA activities of a ``torch.profiler`` window, read from the raw
    kineto events (building the profiler's event list for a whole epoch
    takes longer than the epoch), less the ranges that annotate them (the
    optimizer's "Optimizer.step#..." span lies on the device timeline too):
    their number (``events``), device ``ms`` and ``ms_by_name`` (a Counter),
    the device's ``busy_share`` (the union of their intervals over
    ``wall_ms``), and the host's ``launch_calls``, one CUDA API call
    (LAUNCH_CALLS) for each kernel, copy or set.  Kernels are counted by
    the launch calls: the device record keeps fewer (on an H100, ~2.3 of a
    POE step's 1,498, and at times far more), and its device ms and busy
    share lose those with them."""
    import collections
    from torch.autograd import DeviceType
    intervals, ms_by_name, calls = [], collections.Counter(), 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CPU:
            calls += e.name() in LAUNCH_CALLS
        elif (e.device_type() == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", lambda: False)()
              and not e.name().startswith("Optimizer.")):
            intervals.append((e.start_ns() / 1e3, e.end_ns() / 1e3))
            ms_by_name[e.name()] += (e.end_ns() - e.start_ns()) / 1e6
    check(bool(intervals), "the profiler recorded no CUDA activity")
    return {"events": len(intervals), "ms": sum(ms_by_name.values()),
            "ms_by_name": ms_by_name, "busy_share": busy_ms(intervals) / wall_ms,
            "launch_calls": calls}


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
                            [ctypes.c_int] * 7 + [ctypes.c_void_p])
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
            _build.check("attention", empty(b, h, tq, tk, dh, 0, 0, stream().cuda_stream))

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
        print(f"time masked_attention [{label} {shape}]: kernel {kern:.5f} and "
              f"{kern_again:.5f} ms, chunked kernel {chunked_ms:.5f} ms, SDPA {lib:.5f} ms, an "
              f"empty kernel launched the same way {floor:.5f} ms on {card}")
        bound, by = attention_bound(b, h, tq, tk, dh, mask)
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
        if mask is not None:   # the encoder: the mma kernel skips the dead tiles
            rows[-1]["dead_tiles"] = padded_tiles_check(
                card, f"{label} {shape}", q, k, v, mask, attention.masked_attention(q, k, v, mask))
    for r in rows:
        print(f"time {r['name']} [{r['at']}]: kernel {r['ms']:.5f} ms (eager "
              f"{r['eager_ms']:.5f}), plain {r['plain_ms']:.5f} ms, library "
              f"{'n/a' if r['library_ms'] is None else format(r['library_ms'], '.5f')} ms, "
              f"bound {r['bound_ms']:.6f} ms ({r['bound_by']}) on {card}")
    long_keys = long_keys_times(card, g)
    few_keys = few_keys_times(card, g)
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
    return rows, few_keys, long_keys


# a masked head past the resident kernel's 256 keys: the fp32 tensor-core
# kernel, timed against the chunked kernel that took it before
CHUNKED_SHAPE = (16, 2, 512, 512, 32)
# (B, H, Tq, Tk, Dh), masked: the heads past the resident kernel's reach
# that long_keys_times holds and times, CHUNKED_SHAPE first; Tk 1000 and
# 300 not multiples of the 32-key tile, Dh 128 over the shared memory
LONG_KEY_SHAPES = ((CHUNKED_SHAPE, True), ((2, 2, 20, 1000, 16), True),
                   ((2, 2, 20, 256, 128), True), ((1, 1, 300, 300, 64), False))


def attention_mma_bound(b, h, tq, tk, dh, mask=None) -> float:
    """The least time of the fp32 tensor-core attention's work on the
    tensor cores: its two products over the needed keys as three TF32
    products each at the dense TF32 rate, or its bytes (as
    :func:`attention_bound`), whichever is longer (ms)."""
    keys = b * tk if mask is None else attended_keys(tk, mask)
    nbytes = 4 * (2 * b * h * tq * dh + 2 * h * keys * dh) + (0 if mask is None else b * tk)
    return max(nbytes / PEAK_BYTES_PER_S, 3 * 4 * h * tq * keys * dh / PEAK_TF32_FLOP_PER_S) * 1e3


def long_keys_times(card: str, g: torch.Generator) -> dict:
    """The fp32 tensor-core attention kernel (``masked_attention_mma``) at
    every shape of :data:`LONG_KEY_SHAPES`, the masked ones under random key
    lengths (one batch element masked whole): the route the launcher takes,
    its error against the plain version, its same bits twice, under a mask
    the mean of V for the element masked whole and its skipping of the
    all-masked key tiles (:func:`padded_tiles_check`: the dense design's
    bits, NaN in the dead tiles left out), then in turns the kernel, the
    chunked kernel that took these heads before
    (``masked_attention_forward_chunked``, a yardstick the port never calls)
    twice and the kernel again, beside the fp32 operation bound over the
    needed keys, the 3xTF32 MMA bound, the plain version and SDPA under the
    same mask (device ms, graphed).  Returns its kernels-line entry at
    :data:`CHUNKED_SHAPE`, every shape's numbers under "shapes"."""
    import torch.nn.functional as F
    from multimodal_vae_comparison_tpu_torch.ops.kernels import attention, telemetry
    shapes = []
    for shape, masked in LONG_KEY_SHAPES:
        b, h, tq, tk, dh = shape
        q, k, v, mask = attention_inputs(g, *shape, masked)
        telemetry.reset()
        got = attention.masked_attention(q, k, v, mask)
        took = telemetry.variants()
        again = attention.masked_attention(q, k, v, mask)
        want = attention.attention_reference(q, k, v, mask)
        chunked_run, old = attention_yardstick("masked_attention_forward_chunked", q, k, v, mask)
        chunked_run()
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        check(took == {"attention:mma": 1}, f"attention at {shape} launched {took}")
        check(torch.allclose(got, want, rtol=ATTN_RTOL, atol=ATTN_ATOL)
              and torch.equal(got, again), f"the mma attention kernel at {shape}: max_abs_err "
              f"{err}, same bits twice {torch.equal(got, again)}")
        check(torch.allclose(old, want, rtol=ATTN_RTOL, atol=ATTN_ATOL),
              f"the chunked attention kernel disagrees with the plain version at {shape}")
        dead = None
        if masked:
            uniform = v[0].mean(dim=1, keepdim=True).expand_as(got[0])
            check(torch.allclose(got[0], uniform, rtol=ATTN_RTOL, atol=ATTN_ATOL),
                  f"attention at {shape}: the element masked whole is not the mean of V")
            dead = padded_tiles_check(card, f"mma {shape}", q, k, v, mask, got)
        launcher = lambda: attention.masked_attention(q, k, v, mask)  # noqa: E731
        ms = [graph_ms(launcher)]
        chunked_ms = [graph_ms(chunked_run), graph_ms(chunked_run)]
        ms.append(graph_ms(launcher))
        plain = graph_ms(lambda: attention.attention_reference(q, k, v, mask))
        sdpa_mask = None
        if masked:
            sdpa_mask = mask[:, None, None, :].clone()
            sdpa_mask[0] = True   # SDPA's all-masked row would be NaN; its time is what counts
        lib = graph_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=sdpa_mask))
        bound, by = attention_bound(b, h, tq, tk, dh, mask)
        mma_bound = attention_mma_bound(b, h, tq, tk, dh, mask)
        shapes.append({"at": str(shape), "masked": masked, "max_abs_err": err, "ms": ms[0],
                       "ms_again": ms[1], "chunked_kernel_ms": chunked_ms, "plain_ms": plain,
                       "library_ms": lib, "bound_ms": bound, "bound_by": by,
                       "mma_bound_ms": mma_bound, "dead_tiles": dead})
        print(f"time masked_attention mma [{shape} mask={masked}]: kernel {ms[0]:.5f} / "
              f"{ms[1]:.5f} ms, chunked kernel {chunked_ms[0]:.5f} / {chunked_ms[1]:.5f} ms, "
              f"plain {plain:.5f} ms, SDPA {lib:.5f} ms, bound {bound:.6f} ms ({by}), 3xTF32 "
              f"MMA bound {mma_bound:.6f} ms, max_abs_err {err:.3e} on {card}")
    first = shapes[0]
    return {"name": "masked_attention_mma", "route": "cuda",
            "source": "multimodal_vae_comparison_tpu_torch/csrc/attention.cu",
            "kernel": "masked_attention_mma",
            "replaces": "multimodal_vae_comparison_tpu/ops/pallas/attention.py:77",
            **{key: first[key] for key in ("at", "max_abs_err", "ms", "plain_ms", "bound_ms",
                                           "bound_by", "mma_bound_ms", "library_ms",
                                           "chunked_kernel_ms")},
            "library_is": "F.scaled_dot_product_attention(q, k, v, attn_mask=the key "
                          "padding), graphed", "shapes": shapes}


def few_keys_times(card: str, g: torch.Generator) -> dict:
    """The few-keys kernel at every shape of :data:`FEW_KEYS_SHAPES`: the
    route it takes, its error against the plain version and its same bits
    twice, then in turns the kernel, the resident route before it
    (``masked_attention_forward_resident``, a yardstick the port never
    calls) and the kernel again, beside the byte bound, an empty kernel
    launched as the few-keys kernel is, the plain version and SDPA under
    the same mask (device ms, graphed).  Returns its kernels-line entry at
    the first shape, every shape's numbers under "shapes"."""
    import ctypes
    import math
    import torch.nn.functional as F
    from multimodal_vae_comparison_tpu_torch.ops.kernels import _build, attention, telemetry
    resident = _build.function("attention", "masked_attention_forward_resident",
                               [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                               + [ctypes.c_float, ctypes.c_void_p])
    empty = _build.function("attention", "empty_launch", [ctypes.c_int] * 7 + [ctypes.c_void_p])
    shapes = []
    for shape, masked in FEW_KEYS_SHAPES:
        b, h, tq, tk, dh = shape
        q, k, v, mask = attention_inputs(g, *shape, masked)
        telemetry.reset()
        got = attention.masked_attention(q, k, v, mask)
        took = telemetry.variants()
        again = attention.masked_attention(q, k, v, mask)
        want = attention.attention_reference(q, k, v, mask)
        old = torch.empty_like(q)
        stream = torch.cuda.current_stream

        def launch_resident():
            _build.check("attention", resident(
                q.data_ptr(), k.data_ptr(), v.data_ptr(),
                None if mask is None else mask.data_ptr(), old.data_ptr(), b, h, tq, tk, dh,
                1.0 / math.sqrt(dh), stream().cuda_stream))

        launch_resident()
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        check(took == {"attention:few_keys": 1}, f"attention at {shape} launched {took}")
        check(torch.allclose(got, want, rtol=ATTN_RTOL, atol=ATTN_ATOL)
              and torch.equal(got, again), f"few-keys kernel at {shape}: max_abs_err {err}, "
              f"same bits twice {torch.equal(got, again)}")
        check(torch.allclose(old, want, rtol=ATTN_RTOL, atol=ATTN_ATOL),
              f"the resident route disagrees with the plain version at {shape}")
        kern = graph_ms(lambda: attention.masked_attention(q, k, v, mask))
        old_ms = graph_ms(launch_resident)
        old_again = graph_ms(launch_resident)
        kern_again = graph_ms(lambda: attention.masked_attention(q, k, v, mask))
        floor = graph_ms(lambda: _build.check("attention", empty(b, h, tq, tk, dh, 0, 0,
                                                                 stream().cuda_stream)))
        plain = graph_ms(lambda: attention.attention_reference(q, k, v, mask))
        sdpa_mask = None if mask is None else mask[:, None, None, :]
        lib = graph_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=sdpa_mask))
        bound, by = attention_bound(b, h, tq, tk, dh, mask)
        shapes.append({"at": str(shape), "masked": masked, "max_abs_err": err,
                       "ms": kern, "ms_again": kern_again,
                       "resident_route_ms": [old_ms, old_again], "empty_launch_ms": floor,
                       "plain_ms": plain, "library_ms": lib, "bound_ms": bound,
                       "bound_by": by})
        print(f"time masked_attention few_keys [{shape} mask={masked}]: kernel {kern:.5f} / "
              f"{kern_again:.5f} ms, resident route {old_ms:.5f} / {old_again:.5f} ms, bound "
              f"{bound:.6f} ms ({by}), empty launch {floor:.5f} ms, plain {plain:.5f} ms, "
              f"SDPA {lib:.5f} ms, max_abs_err {err:.3e} on {card}")
    first = shapes[0]
    return {"name": "masked_attention_few_keys", "route": "cuda",
            "source": "multimodal_vae_comparison_tpu_torch/csrc/attention.cu",
            "kernel": "masked_attention_few_keys",
            "replaces": "multimodal_vae_comparison_tpu/ops/pallas/attention.py:77",
            "at": first["at"], "max_abs_err": first["max_abs_err"], "ms": first["ms"],
            "plain_ms": first["plain_ms"], "bound_ms": first["bound_ms"],
            "bound_by": first["bound_by"], "library_ms": first["library_ms"],
            "library_is": "F.scaled_dot_product_attention(q, k, v, attn_mask=the key "
                          "padding or none), graphed",
            "empty_launch_ms": first["empty_launch_ms"],
            "resident_route_ms": first["resident_route_ms"], "shapes": shapes}


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
    float64, on the card's relu branches: :func:`same_branches`), same
    seeded weights, batch and eps, under ELBO and DReG; then on the card at
    K 5 and bs 8, remat on vs off."""
    from multimodal_vae_comparison_tpu_torch.training.trainer import build_model
    rng = np.random.default_rng(22)
    raw, eps = video_inputs(rng, 2, 2)
    for obj in ("elbo", "dreg"):
        out, branches, flips = {}, [], {}
        for dev in ("cuda", "cpu"):
            model = build_model(video_specs(), "moe", VIDEO_LATENTS, obj=obj, K=2, seed=0,
                                device=dev)
            batch, draws = torch_batch(raw, dev), eps_to(eps, dev)
            if dev == "cpu":
                model = model.double()
                batch = {n: {"data": m["data"].double(), "masks": None}
                         for n, m in batch.items()}
                draws = {n: e.double() for n, e in draws.items()}
            with same_branches(branches, dev == "cpu", flips):
                out[dev] = _objective_grads(model, batch, draws)
        (gl, gm, gg), (cl, cm, cg) = out["cuda"], out["cpu"]
        cg = {n: g.float() for n, g in cg.items()}
        worst, name = _worst_leaf(gg, cg, VIDEO_GRAD_REL[obj])
        print(f"video parity {obj}: loss cuda {gl:.4f} cpu {cl:.4f}; {len(cg)} gradient "
              f"leaves, worst error {worst:.3f} of its limit at {name} (limit "
              f"{VIDEO_GRAD_REL[obj]} x max|g| + 1e-05); elements where the CPU's own "
              f"branch differs from the card's {flips}")
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


def make_cdsprites(root: str, count: int = DATA_COUNT):
    """CdSprites+ level 1 at ``count`` rows (DATA_COUNT unless given)
    through the port's generator: (level dir, file suffix, route).  It
    writes .h5 where h5py imports and the same arrays as .pkl where it does
    not."""
    from multimodal_vae_comparison_tpu_torch.data_proc.cdsprites import generate_level
    try:
        import h5py  # noqa: F401
        fmt = "h5"
    except ImportError:
        fmt = "pkl"
    level_dir = generate_level(1, count, root, seed=0, fmt=fmt)
    return level_dir, f".{fmt}", f"data_proc.cdsprites.generate_level(fmt={fmt!r})"


def from_config(path: str, data_paths: dict, results_root: str, eval_only=False, edit=None,
                **over):
    """The Config of a shipped YAML with each modality's ``path`` and
    ``test_datapath`` set from ``data_paths`` (the made data, one dict per
    ``modality_i`` key; a modality without one keeps its config's) and its
    run directory under ``results_root``; ``edit(params)``, where given,
    changes the YAML's dict first."""
    import yaml
    from multimodal_vae_comparison_tpu_torch.config import Config
    with open(os.path.join(HERE, path)) as f:
        params = yaml.safe_load(f)
    if edit is not None:
        edit(params)
    for key, block in params.items():
        if key.startswith("modality_"):
            block.update(data_paths.get(key, {}))
    params.update(over)
    return Config(params, results_root=results_root, eval_only=eval_only)


def cdsprites_paths(data) -> dict:
    """Each modality's data paths in :func:`make_cdsprites`'s level (both
    modalities read the same files)."""
    level_dir, suffix = data[0], data[1]
    paths = {"path": os.path.join(level_dir, f"traindata{suffix}"),
             "test_datapath": os.path.join(level_dir, f"testdata{suffix}")}
    return {f"modality_{i}": paths for i in (1, 2)}


def expected_launches(mixing: str, objective_calls: int, train_steps: int,
                      tables=(PER_OBJECTIVE, PER_BACKWARD)) -> dict:
    """Launches of ``objective_calls`` objective calls of which
    ``train_steps`` (a train step's) also ran their backward, from the
    per-call and per-backward ``tables``."""
    per_objective, per_backward = tables
    want = {k: n * objective_calls for k, n in per_objective[mixing].items()}
    for k, n in per_backward[mixing].items():
        want[k] = want.get(k, 0) + n * train_steps
    return {k: n for k, n in want.items() if n}


def eval_launches(mixing: str, n_train: int) -> dict:
    """Launches of one CdSprites+ benchmark (``eval_single_model``).

    Its forwards: text->image and image->text cross-generation, then one
    with both modalities per ex-post batch (64 train rows, up to 2048); its
    decodes: one per joint source.  A POE or MoPoE forward launches the PoE
    kernel once (one subset, or MoPoE's fully present subsets) and attention
    in the text encoder when text is present and in the text decoder; a MOE
    forward decodes text from each present modality's sample, and launches
    no KL; a DMVAE forward launches PoE once (the joint) and decodes text
    from its own or the joint sample, from the joint sample, and from each
    other present modality's.  A text decode is one attention launch."""
    batches = min(-(-n_train // EXPOST_BATCH), EXPOST_ROWS // EXPOST_BATCH)
    joint = len(JOINT_SOURCES)
    if mixing in ("poe", "mopoe"):
        return {"attention": 2 + 1 + 2 * batches + joint, "poe": 2 + batches}
    if mixing == "dmvae":
        return {"attention": 3 + 3 + 4 * batches + joint, "poe": 2 + batches}
    return {"attention": 2 + 2 + 3 * batches + joint}


# launches by kernel variant over every run :func:`counted` drives (the
# from-config paths), for the kernels-line entries of one variant
PATH_VARIANTS: dict = {}


def counted(label, mixing, calls, train_steps, run, total, extra=None,
            tables=(PER_OBJECTIVE, PER_BACKWARD), kinds=None):
    """``run()`` with the kernel counts set to 0 just before it and read
    just after: it must launch exactly ``calls`` objective calls' kernels
    (``train_steps`` of them with their backward; :func:`expected_launches`
    from ``tables``), plus ``extra``, and take no plain version; the
    launches are added into ``total`` (and the launches by variant and
    dtype into ``kinds``, where given; by variant into
    :data:`PATH_VARIANTS`)."""
    from multimodal_vae_comparison_tpu_torch.ops.kernels import telemetry
    telemetry.reset()
    out = run()
    torch.cuda.synchronize()
    got, paths = telemetry.launches(), telemetry.summary()
    want = expected_launches(mixing, calls, train_steps, tables)
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
    for k, n in telemetry.variants().items():
        PATH_VARIANTS[k] = PATH_VARIANTS.get(k, 0) + n
    for k, n in (telemetry.dtypes() if kinds is not None else {}).items():
        kinds[k] = kinds.get(k, 0) + n
    return out


@contextlib.contextmanager
def stopwatch(parts, times: dict):
    """Seconds of ``parts`` ((owner, function name, key of the call's args
    and kwargs)) while the block runs, summed into ``times``.  Each part
    ends in host numpy, so its clock reads finished device work."""
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


def eval_stopwatch(times: dict):
    """:func:`stopwatch` over the CdSprites+ benchmark's parts: the judges
    (trained or loaded), cross-generation, each joint source, the GMM fit
    and the whole eval."""
    from multimodal_vae_comparison_tpu_torch.eval import eval_cdsprites as ec
    from multimodal_vae_comparison_tpu_torch.eval.infer import MultimodalVAEInfer
    return stopwatch(((ec, "get_all_classifiers", lambda a, k: "judges_s"),
                      (ec, "calculate_cross_coherency", lambda a, k: "cross_s"),
                      (ec, "calculate_joint_coherency",
                       lambda a, k: f"joint_{k.get('source', 'prior')}_s"),
                      (MultimodalVAEInfer, "_fitted_prior", lambda a, k: "gmm_fit_s"),
                      (ec, "eval_single_model", lambda a, k: "eval_s")), times)


def sprites_stopwatch(times: dict):
    """:func:`stopwatch` over the SPRITES benchmark's parts: each judge
    (trained or loaded) and the whole eval."""
    from multimodal_vae_comparison_tpu_torch.eval import eval_sprites as es
    return stopwatch(((es, "_action_classifier", lambda a, k: "action_judge_s"),
                      (es, "_attribute_classifier", lambda a, k: "attribute_judge_s"),
                      (es, "sprites_stats", lambda a, k: "eval_s")), times)


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
            module_argv("multimodal_vae_comparison_tpu_torch.serving.server",
                        "--model", run_dir, "--port", str(port)),
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
    (``eval_cdsprites -p``) in a process of its own, a plain ``python -m``
    that sets the port's numerics itself, must load the judge from the
    cache and write the stats file ``test()`` wrote, byte for byte; then cross-generation of the same EVAL_ROWS test rows and prior
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
        module_argv("multimodal_vae_comparison_tpu_torch.eval.eval_cdsprites", "-p", run_dir),
        cwd=HERE, capture_output=True, text=True, timeout=600,
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


def config_trainer(label: str, path: str, mixing: str, data_paths: dict, root: str,
                   epochs: int, edit=None):
    """A Trainer of the shipped config ``path`` (changed by ``edit``, see
    :func:`from_config`) on the made data (``data_paths``), its run
    directory under ``root``, at ``epochs`` and one seed, its state
    initialised; its ``test()`` keeps the stats it returns in the dict
    returned beside it.  Checks the mixing and the resident path on the
    card."""
    from multimodal_vae_comparison_tpu_torch.training.trainer import Trainer
    config = from_config(path, data_paths, os.path.join(root, "results"), edit=edit,
                         epochs=epochs, iterseeds=1)
    trainer = Trainer(config, enable_viz=False)
    trainer.init_state()
    stats = {}

    def test_and_keep():
        stats.update(Trainer.test(trainer))
        return stats

    trainer.test = test_and_keep    # main() prints test()'s stats; keep them
    check(config.mixing == mixing and trainer.use_scan() and trainer.device.type == "cuda",
          f"{label}: mixing {config.mixing}, resident {trainer.use_scan()}")
    return config, trainer, stats


def check_restored(label: str, run_dir: str, trainer, batch, eps, forward=None) -> float:
    """``model/last`` of ``run_dir`` restored on the card through
    ``MultimodalVAEInfer``: the trainer's weights and buffers, and the
    trainer's forward over every modality on ``batch`` and ``eps`` (one
    sample, as the restored model draws) within RESTORE_RTOL /
    RESTORE_ATOL; ``forward(model, batch, eps)``, where given (the gumbel
    path's), runs on both models in place of their forwards.  Returns the
    largest difference."""
    from multimodal_vae_comparison_tpu_torch.eval.infer import MultimodalVAEInfer
    infer = MultimodalVAEInfer(run_dir)
    for (n, a), b in zip(infer.model.state_dict().items(),
                         trainer.model.state_dict().values()):
        check(torch.equal(a, b), f"{label}: restored {n} differs from the trainer's")
    present = trainer.model.mod_names
    tb = torch_batch(batch, trainer.device)
    trainer.model.eval()
    K, trainer.model.K = trainer.model.K, 1
    try:
        with torch.inference_mode():
            if forward is None:
                got = infer.forward(batch, present, eps=eps)
                want = trainer.model.forward(tb, present, eps=eps)
            else:
                got, want = forward(infer.model, tb, eps), forward(trainer.model, tb, eps)
    finally:
        trainer.model.K = K
    err = max((got.mods[n].decoder_dist.mean - want.mods[n].decoder_dist.mean)
              .abs().max().item() for n in present)
    print(f"train from config {label}: MultimodalVAEInfer({run_dir}) forward vs the "
          f"trainer's model: max_abs_err={err:.3e} (rtol {RESTORE_RTOL}, atol {RESTORE_ATOL})")
    for n in present:
        check(torch.allclose(got.mods[n].decoder_dist.mean, want.mods[n].decoder_dist.mean,
                             rtol=RESTORE_RTOL, atol=RESTORE_ATOL),
              f"{label}: the restored model's forward differs at {n}")
    return err


def phase_train_from_config(card: str, root: str, data):
    """The config -> data -> Trainer -> checkpoint -> --model server path.

    CdSprites+ level 1 is made at DATA_COUNT; ``cdl1_r5_poe.yml`` trains for
    1 epoch through ``main(config)`` on the resident path, the epoch
    under ``torch.profiler`` as the CLI's ``--profile`` runs it (a Trainer,
    ``fit(epochs=1)``, then ``main(config, trainer)``); then one epoch through
    the per-batch ``run_epoch``, and ``config_cdspritesplus.yml`` (MOE) for 1
    epoch.  Each run is counted from zero and must launch exactly its
    objective calls (train steps + validation batches) times the kernels'
    counts per call, and the ``test()`` that ends each run the launches of
    its CdSprites+ benchmark (:func:`eval_launches`), whose stats are
    checked and, for POE, held again by :func:`phase_eval_from_config`.  The
    run directory is restored through ``MultimodalVAEInfer`` and served by
    ``serving/server.py --model``.  ``data`` is :func:`make_cdsprites`'s
    result and its seconds.  Returns (launches of the whole phase, its
    numbers)."""
    from multimodal_vae_comparison_tpu_torch.data import native
    from multimodal_vae_comparison_tpu_torch.main import main as train_main
    from torch.profiler import ProfilerActivity, profile

    numbers, total = {"card": card}, {}
    # the judges the POE run's test() trains, and the MOE run's and the
    # eval CLI's load
    os.environ["CDSPRITES_CLASSIFIER_DIR"] = os.path.join(root, "judges")
    level_dir, _, route, numbers["data_s"] = data
    print(f"train from config: data route {route}, {level_dir} in {numbers['data_s']:.2f} s; "
          f"native host kernels available: {native.available()}")

    for (label, path, epochs), mixing in zip(FROM_CONFIG, ("poe", "moe")):
        config, trainer, stats = config_trainer(label, path, mixing, cdsprites_paths(data),
                                                root, epochs)
        times = {}
        dm, bs = trainer.datamodule, config.batch_size
        steps, val_batches = dm.n_train // bs, dm.n_val // bs
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
            prof, wall_ms = counted(label, mixing, calls, epochs * steps, run, total, evals)
            act = device_activity(prof, wall_ms)
            share, n_events = act["busy_share"], act["events"]
            del prof
        else:
            def run():
                with eval_stopwatch(times):
                    train_main(config, trainer=trainer, enable_viz=False)
            counted(label, mixing, calls, epochs * steps, run, total, evals)
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
        batch = next(dm.batches("val"))
        check_restored(label, config.mPath, trainer, batch, torch.from_numpy(
            np.random.default_rng(30).standard_normal((1, bs, N_LATENTS)).astype(np.float32)
        ).to(trainer.device))
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

        counted(f"{label} per-batch epoch", mixing, steps + val_batches, steps, per_batch,
                total)
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


def phase_zoo_from_config(card: str, root: str, data):
    """This slice's main path: the MoPoE and DMVAE level-1 configs of
    ``configs/reproduce_paper`` trained for 1 resident epoch each through
    ``main(config)`` on the ZOO_DATA_COUNT rows of level 1, each
    ending in ``Trainer.test()`` with the judge that phase cached.  Each run
    is counted from zero: exactly its objective calls (train steps +
    validation batches, and test()'s validation) times the kernels' counts
    per call, and its benchmark's launches (:func:`eval_launches`), no plain
    version; the val loss falls; the 12 stats are finite and in [0, 100];
    ``model/last`` restored through ``MultimodalVAEInfer`` gives the
    trainer's forward within RESTORE_RTOL / RESTORE_ATOL.  Returns
    (launches of the whole phase, its numbers)."""
    from multimodal_vae_comparison_tpu_torch.main import main as train_main

    numbers, total = {"card": card}, {}
    os.environ["CDSPRITES_CLASSIFIER_DIR"] = os.path.join(root, "judges")
    zoo = {label: (path, mixing) for label, path, mixing in ZOO}
    for label in ZOO_FROM_CONFIG:
        path, mixing = zoo[label]
        config, trainer, stats = config_trainer(label, path, mixing, cdsprites_paths(data),
                                                root, 1)
        times = {}
        dm, bs = trainer.datamodule, config.batch_size
        steps, val_batches = dm.n_train // bs, dm.n_val // bs
        trainer.stage_epoch_data()
        trainer.stage_val_data()
        untrained = trainer.validate_scan(0)["val_loss"]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        evals = eval_launches(mixing, dm.n_train)

        def run(trainer=trainer, config=config, times=times):
            with eval_stopwatch(times):
                train_main(config, trainer=trainer, enable_viz=False)

        t0 = time.perf_counter()
        counted(label, mixing, steps + 2 * val_batches, steps, run, total, evals)
        run_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        check_stats(label, stats)
        rows = _csv_rows(os.path.join(config.mPath, "metrics.csv"))
        trained = float(rows[-1]["val_loss"])
        epoch_s, samples_s = float(rows[-1]["epoch_time_s"]), float(rows[-1]["samples_per_s"])
        print(f"eval from config {label}: " + ", ".join(
            f"{k} {stats[k]:.2f}" for k in stats if not k.startswith("val_"))
            + f"; launches of the eval {evals}; seconds " + ", ".join(
                f"{k[:-2]} {v:.3f}" for k, v in times.items()) + f" on {card}")
        print(f"train from config {label} ({path}): {trainer.n_params()} parameters, "
              f"{dm.n_train} train / {dm.n_val} val rows, {steps} steps of {bs}; val_loss "
              f"untrained {untrained:.2f} -> {trained:.2f}; epoch {epoch_s:.3f} s, "
              f"{samples_s:.1f} samples/s; main() with test() {run_s:.2f} s; peak memory "
              f"{peak:.3f} GiB on {card}")
        check(len(rows) == 1, f"{label}: metrics.csv has {len(rows)} rows for 1 epoch")
        check(np.isfinite(trained) and trained < untrained,
              f"{label}: val_loss {trained} after training, {untrained} before")
        for tag in ("last", "best"):
            check(os.path.isfile(os.path.join(config.mPath, "model", tag, "state.pt")),
                  f"{label}: no model/{tag} checkpoint")
        err = check_restored(label, config.mPath, trainer, next(dm.batches("val")), eps_to(
            zoo_eps(trainer.model, np.random.default_rng(31), bs), trainer.device))
        numbers[label] = {
            "config": path, "params": trainer.n_params(), "steps": steps,
            "val_loss_untrained": untrained, "val_loss": trained, "epoch_s": epoch_s,
            "samples_per_s": samples_s, "main_with_test_s": run_s, "peak_memory_gib": peak,
            "eval_stats": {k: v for k, v in stats.items() if not k.startswith("val_")},
            "eval_s": times, "eval_launches": evals, "restore_max_abs_err": err}
        del trainer
    os.environ.pop("CDSPRITES_CLASSIFIER_DIR")
    return total, numbers


def phase_zoo_times(card: str, steps: int = 5) -> dict:
    """The MoPoE and DMVAE train steps of ZOO_FROM_CONFIG at TRAIN_BATCH
    profiled (:func:`profile_steps`), and the ResNet-50 trunk's forward +
    backward alone (``Enc_CNN`` at the same batch): its device kernel ms
    and kernels a call under ``torch.profiler``."""
    import collections
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from multimodal_vae_comparison_tpu_torch.training.optim import make_optimizer
    from multimodal_vae_comparison_tpu_torch.training.trainer import (
        build_model_from_config, make_train_step)
    zoo = {label: (path, mixing) for label, path, mixing in ZOO}
    batch = torch_batch(make_inputs(np.random.default_rng(32), TRAIN_BATCH), "cuda")
    numbers = {}
    for label in ZOO_FROM_CONFIG:
        cfg = paper_config(zoo[label][0])
        model = build_model_from_config(cfg, device="cuda")
        step = make_train_step(model, make_optimizer(cfg.optimizer, cfg.lr, model.parameters()))
        gen = torch.Generator(device="cuda").manual_seed(33)
        for _ in range(3):
            step(batch, generator=gen)
        numbers[label] = profile_steps(f"{label} {zoo[label][0]}", step, batch, gen,
                                       TRAIN_BATCH, steps, card)
    enc, x = model.enc_mod_1, batch["mod_1"]["data"]
    ups = [torch.randn(TRAIN_BATCH, enc.out_dim, device="cuda") for _ in range(2)]

    def trunk():
        torch.autograd.backward(enc(x), ups)

    for _ in range(3):
        trunk()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            trunk()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    per_name = collections.Counter()
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
            per_name[e.name] += e.time_range.elapsed_us()
    check(bool(per_name), "the profiler recorded no kernel of the ResNet-50 trunk")
    n_kernels = sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA
                    and not getattr(e, "is_user_annotation", False)) / steps
    numbers["resnet50_trunk"] = {
        "batch": TRAIN_BATCH, "device_kernel_ms": sum(per_name.values()) / 1e3 / steps,
        "wall_ms": wall_ms, "kernels": n_kernels,
        "top_kernels_ms": {n[:80]: us / 1e3 / steps for n, us in per_name.most_common(4)},
        "card": card}
    print("time resnet50 trunk " + json.dumps(numbers["resnet50_trunk"]))
    return numbers


# -- SPRITES from the configs ------------------------------------------------

# the generator's default: 64 clips a combination, 576 train and 108 test
SPRITES_PER_COMBO = 64
# (label, config, mixing, epochs): the MOE/DReG run at its config's widths
# (K 5, bs 16, 32 latents, remat, llik 600 on both categorical modalities)
# and the POE/ELBO run (K 1, bs 32, 10 latents); only the epochs are cut
# (the MOE run's second epoch too, to keep the script within its limit)
SPRITES_FROM_CONFIG = (
    ("MOE sprites_r4_dreg_up", "configs/round4/sprites_r4_dreg_up.yml", "moe", 1),
    ("POE sprites_r2_poe", "configs/round2/sprites_r2_poe.yml", "poe", 1))
# launches of one SPRITES objective call (a train step or a validation
# batch) and of a train step's backward.  Each call of the VideoGPT encoder
# or decoder runs masked attention in 4 blocks x 3 axes = 12 times.
# MOE/DReG: the encoder, and the decoder on all M*K*B samples twice (the
# gradient-free pass for the importance weights and the weighted one); its
# backward re-runs the encoder and the weighted decode (remat).  POE: the
# encoder, one decode of all S*K*B subset samples, one PoE launch for the
# lattice; its backward re-runs both nets and launches the PoE backward.
# DReG takes no KL, and POE's is closed form against the learned prior
SPRITES_PER_OBJECTIVE = {"moe": {"attention": 36}, "poe": {"attention": 24, "poe": 1}}
SPRITES_PER_BACKWARD = {"moe": {"attention": 24}, "poe": {"attention": 24, "poe_bwd": 1}}
SPRITES_VIDEO_CALL = 12
# card against CPU: one objective and its backward of each config's model at
# its widths on SPRITES_PARITY_BATCH real clips, remat off (it recomputes
# the same activations), the CPU in float64 on the card's relu branches and
# DReG importance weights (same_branches, same_dreg_weights)
SPRITES_PARITY_BATCH = 2
# the largest change a replay may make to a run's own DReG weights (an
# H100 against the CPU in float64: ~2e-4 at the MOE config's widths)
DREG_WEIGHT_ATOL = 1e-2


@contextlib.contextmanager
def same_dreg_weights(weights: list, replay: bool, moved: dict):
    """``objectives.dreg_grad_weights`` that records the DReG importance
    weights in call order or, with ``replay``, returns those another run
    recorded, in this run's dtype and device, after checking that they are
    within DREG_WEIGHT_ATOL of the run's own; ``moved`` gets the largest
    change.  The weights are a softmax over K of log-weights of ~-1.5e5 (a
    bce sum over a 98,304-value clip), whose fp32 rounding moves them by
    about 1e-4, and every gradient is weighted by them: two runs that sum
    in another order weight their gradients differently, by more than the
    gradient limit at the MOE config's widths.  On the same weights the
    gradients are smooth functions of the rounding."""
    from multimodal_vae_comparison_tpu_torch.models import objectives
    own = objectives.dreg_grad_weights
    recorded = iter(list(weights))

    def weights_(lw, dim=0):
        w = own(lw, dim)
        if not replay:
            weights.append(w.cpu())
            return w
        took = next(recorded).to(device=w.device, dtype=w.dtype)
        change = (took - w).abs().max().item()
        moved["dreg_weights"] = max(moved.get("dreg_weights", 0.0), change)
        check(change <= DREG_WEIGHT_ATOL, f"the recorded DReG weights differ from this "
              f"run's own by {change:.3e} (limit {DREG_WEIGHT_ATOL})")
        return took

    objectives.dreg_grad_weights = weights_
    try:
        yield
    finally:
        objectives.dreg_grad_weights = own


def make_sprites(root: str):
    """SPRITES at the generator's default SPRITES_PER_COMBO through the
    port's generator: (data directory, seconds)."""
    from multimodal_vae_comparison_tpu_torch.data_proc import sprites_gen
    t0 = time.perf_counter()
    sprites_gen.generate(SPRITES_PER_COMBO, root, seed=0)
    return root, time.perf_counter() - t0


def sprites_paths(data_dir: str) -> dict:
    """Each modality's data paths in :func:`make_sprites`'s shards (the
    three modalities read the same shards)."""
    paths = {"path": data_dir, "test_datapath": os.path.join(data_dir, "test")}
    return {f"modality_{i}": paths for i in (1, 2, 3)}


def sprites_eval_launches(mixing: str, tsne: bool) -> dict:
    """Launches of one SPRITES benchmark (``eval_sprites.sprites_stats``).

    Its forwards: cross-generation from the actions, the attributes and the
    frames, and, where matplotlib imports, the labelled t-SNE's forward with
    every modality; its decode: one prior joint generation.  A frames encode
    or decode is SPRITES_VIDEO_CALL attention launches.  A MOE forward
    decodes the frames from the first present modality's sample and again
    from every present modality's other than the frames' own; a POE forward
    launches the PoE kernel once and decodes the frames once, from the
    joint."""
    call = SPRITES_VIDEO_CALL
    if mixing == "moe":
        attention = 2 * call + 2 * call + (call + call) + call
        return {"attention": attention + (call + 3 * call if tsne else 0)}
    attention = call + call + (call + call) + call
    return {"attention": attention + (2 * call if tsne else 0), "poe": 3 + (1 if tsne else 0)}


def check_sprites_stats(label: str, stats: dict) -> None:
    """The benchmark's 10 stats (fractions) finite and in [0, 1], and no
    ``eval_error``."""
    from multimodal_vae_comparison_tpu_torch.eval.eval_sprites import STATS_KEYS
    check("eval_error" not in stats, f"{label}: the eval failed: {stats.get('eval_error')}")
    bad = {k: stats.get(k) for k in STATS_KEYS
           if not (isinstance(stats.get(k), float) and 0.0 <= stats[k] <= 1.0)}
    check(not bad, f"{label}: stats missing, not finite or out of [0, 1]: {bad}")


def phase_sprites_parity():
    """The kernels at the SPRITES path's shapes against their plain
    versions: masked attention forward at every axial shape the two runs
    and their evals launch (T, H and W of an (8, 16, 16) volume: the
    encoder's batches, MOE's M*K*B and POE's S*K*B decodes, the eval's
    decode of the test rows at once) and its backward at the train steps'
    encoder shapes; the PoE lattice forward and backward at M 3, S 7,
    (32, 10)."""
    from multimodal_vae_comparison_tpu_torch.ops.fusion import subset_lattice
    from multimodal_vae_comparison_tpu_torch.ops.kernels import attention, telemetry
    g = torch.Generator(device="cuda").manual_seed(41)
    n_val = SPRITES_PER_COMBO * 9 - int(SPRITES_PER_COMBO * 9 * 0.9)
    # the parity call's bs-2 encoder and decodes, the MOE run's bs-16
    # encoder (and its restore's decode), its M*K*B decode, the POE run's
    # bs-32 encoder and S*K*B decode, the eval's test rows and the t-SNE's
    for clips in (2, 7 * 2, 3 * 5 * 2, 16, 3 * 5 * 16, 32, 7 * 32, n_val, 108):
        for shape in axial_shapes(clips):
            q, k, v, _ = attention_inputs(g, *shape, False)
            telemetry.reset()
            got = attention.masked_attention(q, k, v)
            took = telemetry.variants()
            want = attention.attention_reference(q, k, v)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            print(f"parity attention sprites {clips} clips {shape}: max_abs_err={err:.3e} "
                  f"(rtol {ATTN_RTOL}, atol {ATTN_ATOL}); {took}")
            check(took == {f"attention:{attention_variant(shape)}": 1},
                  f"attention at {shape} launched {took}")
            check(torch.allclose(got, want, rtol=ATTN_RTOL, atol=ATTN_ATOL),
                  f"attention kernel disagrees with its plain version at {shape}")
    for shape in axial_shapes(16)[:2]:
        q, k, v, _ = attention_inputs(g, *shape, False)
        d_out = torch.randn(q.shape, generator=g, device="cuda")
        _grad_parity(f"attention sprites {shape}",
                     lambda q_, k_, v_: attention.masked_attention(q_, k_, v_),
                     attention.attention_reference, (q, k, v), d_out, ATTN_RTOL, ATTN_ATOL)
    _lattice_case(g, 3, subset_lattice(3), 32, 1.0, d=10)


def axial_shapes(clips: int):
    """(B, H, Tq, Tk, Dh) of the three axial attentions of ``clips`` clips
    in a VideoGPT block: an (8, 16, 16) volume of 64 channels, 2 heads."""
    t, h, w = 8, 16, 16
    return ((clips * h * w, 2, t, t, 32), (clips * t * w, 2, h, h, 32),
            (clips * t * h, 2, w, w, 32))


def phase_sprites_from_config(card: str, root: str):
    """This slice's main path: SPRITES made by the port's generator at
    SPRITES_PER_COMBO, then each config of SPRITES_FROM_CONFIG trained at
    its widths through ``main(config)`` on the resident path (the MOE run's
    first epoch under ``torch.profiler``), ending in ``Trainer.test()`` and
    the SPRITES benchmark: the MOE run trains both judges on the card, the
    POE run loads them.  Each run is counted from zero: exactly its
    objective calls (train steps + validation batches, and test()'s
    validation) times SPRITES_PER_OBJECTIVE, its train steps times
    SPRITES_PER_BACKWARD, and its benchmark's launches
    (:func:`sprites_eval_launches`), no plain version; the val loss falls;
    the 10 stats are in [0, 1]; ``model/last`` restored through
    ``MultimodalVAEInfer`` gives the trainer's forward within RESTORE_RTOL /
    RESTORE_ATOL.  Then the judges' CLI, the judges and each model's
    objective and gradients on the card against the CPU.  Returns
    (launches of the two runs, the phase's numbers)."""
    import importlib.util
    from torch.profiler import ProfilerActivity, profile
    from multimodal_vae_comparison_tpu_torch.main import main as train_main

    numbers, total = {"card": card}, {}
    data_dir, numbers["data_s"] = make_sprites(os.path.join(root, "sprites"))
    judges_dir = os.path.join(root, "sprites_judges")
    os.environ["SPRITES_CLASSIFIER_DIR"] = judges_dir
    tsne = importlib.util.find_spec("matplotlib") is not None
    tables = (SPRITES_PER_OBJECTIVE, SPRITES_PER_BACKWARD)
    parity_batch = None
    for label, path, mixing, epochs in SPRITES_FROM_CONFIG:
        config, trainer, stats = config_trainer(label, path, mixing, sprites_paths(data_dir),
                                                root, epochs)
        dm, bs = trainer.datamodule, config.batch_size
        check(trainer.model.remat and trainer.model.K == config.K,
              f"{label}: remat {trainer.model.remat}, K {trainer.model.K}")
        steps, val_batches = dm.n_train // bs, dm.n_val // bs
        t0 = time.perf_counter()
        staged = (trainer.stage_epoch_data(), trainer.stage_val_data())
        torch.cuda.synchronize()
        stage_s = time.perf_counter() - t0
        staged_bytes = sum(t.numel() * t.element_size() for split in staged
                           for mod in split.values() for t in mod.values() if t is not None)
        untrained = trainer.validate_scan(epochs - 1)["val_loss"]
        torch.cuda.reset_peak_memory_stats()
        evals = sprites_eval_launches(mixing, tsne)
        times, profiled = {}, {}

        def run(trainer=trainer, config=config, times=times, profiled=profiled, mixing=mixing):
            if mixing == "moe":
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    t1 = time.perf_counter()
                    trainer.fit(epochs=1)
                    torch.cuda.synchronize()
                    profiled["wall_ms"] = (time.perf_counter() - t1) * 1e3
                act = device_activity(prof, profiled["wall_ms"])
                profiled.update(busy_share=act["busy_share"], device_events=act["events"],
                                device_ms=act["ms"], top_kernels_ms={
                                    n[:80]: ms for n, ms in act["ms_by_name"].most_common(6)})
            with sprites_stopwatch(times):
                train_main(config, trainer=trainer, enable_viz=False)

        t0 = time.perf_counter()
        counted(label, mixing, epochs * (steps + val_batches) + val_batches, epochs * steps,
                run, total, evals, tables)
        run_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        check_sprites_stats(label, stats)
        check(trainer.model.K == config.K, f"{label}: test() left the model at K "
              f"{trainer.model.K}, the config has {config.K}")
        for name in ("sprites_action_clf_v3.pt", "sprites_att_clf_v4.pt"):
            check(os.path.isfile(os.path.join(judges_dir, name)), f"{label}: no judge {name}")
        rows = _csv_rows(os.path.join(config.mPath, "metrics.csv"))
        trained = float(rows[-1]["val_loss"])
        check(len(rows) == epochs, f"{label}: metrics.csv has {len(rows)} rows for {epochs} "
              "epochs")
        check(np.isfinite(trained) and trained < untrained,
              f"{label}: val_loss {trained} after training, {untrained} before")
        check(os.path.isfile(os.path.join(config.mPath, "sprites_stats.txt")),
              f"{label}: test() wrote no sprites_stats.txt")
        for tag in ("last", "best"):
            check(os.path.isfile(os.path.join(config.mPath, "model", tag, "state.pt")),
                  f"{label}: no model/{tag} checkpoint")
        batch = next(dm.batches("val"))
        rng = np.random.default_rng(42)
        draw = lambda: rng.standard_normal((1, bs, config.n_latents)).astype(np.float32)
        eps = ({n: draw() for n in trainer.model.mod_names} if mixing == "moe" else draw())
        err = check_restored(label, config.mPath, trainer, batch, eps_to(eps, trainer.device))
        per_call = step_launches(label, trainer, batch, mixing)
        if parity_batch is None:
            parity_batch = {n: {"data": m["data"][:SPRITES_PARITY_BATCH], "masks": None}
                            for n, m in batch.items()}
        print(f"sprites from config {label} ({path}): {trainer.n_params()} parameters, "
              f"{dm.n_train} train / {dm.n_val} val / {len(dm._test[0]['data'])} test clips, "
              f"{steps} steps of {bs} at K {config.K}; staged {staged_bytes / 1e9:.3f} GB in "
              f"{stage_s:.3f} s; val_loss untrained {untrained:.2f} -> {trained:.2f}; epochs "
              + "; ".join(f"{r['step']}: {float(r['epoch_time_s']):.3f} s, "
                          f"{float(r['samples_per_s']):.1f} samples/s" for r in rows)
              + f"; main() with test() {run_s:.2f} s; peak memory {peak:.3f} GiB on {card}")
        print(f"eval from config {label}: " + ", ".join(
            f"{k} {100 * stats[k]:.2f}" for k in stats if not k.startswith("val_"))
            + f" (%); launches of the eval {evals}; seconds " + ", ".join(
                f"{k[:-2]} {v:.3f}" for k, v in times.items()) + f" on {card}")
        numbers[label] = {
            "config": path, "params": trainer.n_params(), "steps": steps, "batch": bs,
            "K": config.K, "val_loss_untrained": untrained, "val_loss": trained,
            "epochs": [{k: float(v) for k, v in r.items()} for r in rows],
            "staged_bytes": staged_bytes, "stage_s": stage_s, "main_with_test_s": run_s,
            "peak_memory_gib": peak,
            "stats_percent": {k: 100 * v for k, v in stats.items() if not k.startswith("val_")},
            "eval_s": times, "eval_launches": evals, "restore_max_abs_err": err,
            **per_call}
        if profiled:
            numbers[label].update({f"profiled_epoch_{k}": v for k, v in profiled.items()})
            print(f"sprites from config {label}: resident epoch 0 under torch.profiler: wall "
                  f"{profiled['wall_ms']:.1f} ms, device busy share "
                  f"{profiled['busy_share']:.4f} ({profiled['device_events']} CUDA activities, "
                  f"{profiled['device_ms']:.1f} device ms); the largest by device ms "
                  + json.dumps(profiled["top_kernels_ms"]))
        del trainer, staged
    numbers["judges_cli"] = phase_sprites_judges(card, data_dir, judges_dir, parity_batch)
    numbers["card_vs_cpu"] = phase_sprites_card_vs_cpu(card, data_dir, root, parity_batch)
    os.environ.pop("SPRITES_CLASSIFIER_DIR")
    return total, numbers


def step_launches(label: str, trainer, batch, mixing: str, calls: int = 2,
                  tables=(SPRITES_PER_OBJECTIVE, SPRITES_PER_BACKWARD),
                  phase: str = "sprites from config") -> dict:
    """Launches of one objective call (the trainer's eval step), of one
    train step (its objective and backward, remat as the config trains) and
    of the backward alone, each the count's change over ``calls`` calls on
    ``batch`` at the config's K; held to ``tables[0][mixing]`` and
    ``tables[1][mixing]`` (SPRITES' unless given).  The train steps update
    the trainer's weights: run it after whatever reads them."""
    from multimodal_vae_comparison_tpu_torch.ops.kernels import telemetry
    tb = torch_batch(batch, trainer.device)
    gen = torch.Generator(device=trainer.device).manual_seed(45)
    per = {}
    for key, step in (("objective_call", trainer.eval_step),
                      ("train_step", trainer.train_step)):
        before = telemetry.launches()
        for _ in range(calls):
            step(tb, generator=gen)
        torch.cuda.synchronize()
        after = telemetry.launches()
        per[key] = {k: (n - before.get(k, 0)) / calls for k, n in after.items()
                    if n != before.get(k, 0)}
    per["backward"] = {k: n - per["objective_call"].get(k, 0)
                       for k, n in per["train_step"].items()
                       if n != per["objective_call"].get(k, 0)}
    print(f"{phase} {label}: launches per call, measured over {calls} calls "
          f"of each step at bs {len(tb['mod_1']['data'])}: " + json.dumps(per))
    per_objective, per_backward = tables[0][mixing], tables[1][mixing]
    check(per["objective_call"] == per_objective and per["backward"] == per_backward,
          f"{label}: launches per call {per}, expected {per_objective} per "
          f"objective call and {per_backward} per backward")
    return {f"launches_per_{k}": v for k, v in per.items()}


def phase_sprites_judges(card: str, data_dir: str, judges_dir: str, batch) -> dict:
    """``train_classifiers --dataset sprites`` on the card (its
    ``VideoClassifier`` action judge), then the three judges' logits on the
    card against the CPU's on the same weights (the two the eval trained,
    and the CLI's) and the real clips of ``batch``, within EVAL_RTOL /
    EVAL_ATOL."""
    from multimodal_vae_comparison_tpu_torch.eval import classifiers as clf
    from multimodal_vae_comparison_tpu_torch.eval import train_classifiers
    t0 = time.perf_counter()
    acc = train_classifiers.main(["--dataset", "sprites", "--path", data_dir,
                                  "--out_dir", judges_dir])
    cli_s = time.perf_counter() - t0
    x = torch.from_numpy(np.ascontiguousarray(batch["mod_1"]["data"]))
    worst = {}
    for name, make, cache in (
            ("ActionVideoClassifier", lambda: clf.ActionVideoClassifier(9), "sprites_action_clf_v3.pt"),
            ("FrameAttributeClassifier", lambda: clf.FrameAttributeClassifier(6, heads=4),
             "sprites_att_clf_v4.pt"),
            ("VideoClassifier", lambda: clf.VideoClassifier(9), "sprites_action_clf_v2.pt")):
        logits = {}
        for dev in ("cuda", "cpu"):
            judge = clf.load_classifier(make().to(dev), os.path.join(judges_dir, cache))
            with torch.no_grad():
                logits[dev] = judge(x.to(dev)).cpu()
        worst[name] = (logits["cuda"] - logits["cpu"]).abs().max().item()
        check(torch.allclose(logits["cuda"], logits["cpu"], rtol=EVAL_RTOL, atol=EVAL_ATOL),
              f"judge {name}: logits on the card vs the CPU max_abs_err {worst[name]:.3e}")
    print(f"sprites judges: train_classifiers --dataset sprites {cli_s:.2f} s (holdout acc "
          f"{acc:.3f}); logits card vs CPU on {len(x)} real clips max_abs_err "
          + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
          + f" (rtol {EVAL_RTOL}, atol {EVAL_ATOL}) on {card}")
    return {"train_classifiers_s": cli_s, "train_classifiers_holdout_acc": acc,
            "logits_card_vs_cpu_max_abs_err": worst}


def phase_sprites_card_vs_cpu(card: str, data_dir: str, root: str, batch) -> dict:
    """One objective and its backward of each SPRITES config's model at its
    widths (seeded weights, real clips of ``batch``, drawn eps, remat off):
    the card (kernels, fp32, TF32 off) against the CPU's plain path in
    float64 on the card's relu branches and DReG weights: loss and metrics
    within TRAIN_RTOL, every gradient within GRAD_REL x its leaf's max |g| +
    GRAD_ATOL.  The referee is float64 because the CPU's fp32 is itself
    about at that limit off float64 at the MOE decoder's last
    transposed-conv weight, whose gradient sums ~10^6 products an element.
    The card's launches: exactly one objective call and one backward
    without remat."""
    from multimodal_vae_comparison_tpu_torch.ops.kernels import telemetry
    from multimodal_vae_comparison_tpu_torch.training.trainer import build_model_from_config
    rng = np.random.default_rng(43)
    n = SPRITES_PARITY_BATCH
    numbers = {}
    for label, path, mixing, _ in SPRITES_FROM_CONFIG:
        cfg = from_config(path, sprites_paths(data_dir), root, eval_only=True)
        for i, mod in enumerate(cfg.mods):
            mod.feature_dims = list(batch[f"mod_{i + 1}"]["data"].shape[1:])
        shape = (cfg.K, n, cfg.n_latents)
        eps = ({m: rng.standard_normal(shape).astype(np.float32)
                for m in ("mod_1", "mod_2", "mod_3")} if mixing == "moe"
               else [rng.standard_normal(shape).astype(np.float32) for _ in range(7)])
        branches, weights, out, moved, seconds = [], [], {}, {}, {}
        for dev, dtype in (("cuda", torch.float32), ("cpu", torch.float64)):
            model = build_model_from_config(cfg, device=dev).to(dtype)
            model.remat = False
            tb = {k: {"data": v["data"].to(dtype), "masks": None}
                  for k, v in torch_batch(batch, dev).items()}
            te = eps_to(eps, dev)
            te = ({k: v.to(dtype) for k, v in te.items()} if isinstance(te, dict)
                  else [v.to(dtype) for v in te])
            telemetry.reset()
            t0 = time.perf_counter()
            with same_branches(branches, dev == "cpu", moved), \
                    same_dreg_weights(weights, dev == "cpu", moved):
                out[dev] = _objective_grads(model, tb, te)
            seconds[dev] = time.perf_counter() - t0
            if dev == "cuda":
                launches, paths = telemetry.launches(), telemetry.summary()
            del model
        want_launches = dict(SPRITES_PER_OBJECTIVE[mixing])
        if mixing == "poe":
            want_launches["poe_bwd"] = 1
        (gl, gm, gg), (cl, cm, cg) = out["cuda"], out["cpu"]
        worst, worst_name = _worst_leaf(gg, {k: v.float() for k, v in cg.items()}, GRAD_REL,
                                        GRAD_ATOL)
        print(f"sprites card vs CPU {label} ({path}, bs {n}, K {cfg.K}): loss cuda {gl:.6f}, "
              f"cpu float64 {cl:.6f}; worst gradient leaf {worst:.3f} of its limit at "
              f"{worst_name} (limit {GRAD_REL} x max|g| + {GRAD_ATOL}); replayed on the CPU: "
              f"{moved} (relu elements whose own branch differs, the largest DReG weight "
              f"change, limit {DREG_WEIGHT_ATOL}); launches {launches}, expected "
              f"{want_launches}; {seconds['cuda']:.3f} s on the card, {seconds['cpu']:.3f} s "
              f"on the CPU")
        check(launches == want_launches, f"{label}: launched {launches}, expected "
              f"{want_launches}")
        check(not any(k.endswith(":plain") for k in paths),
              f"{label}: a plain version ran on the card: {paths}")
        check(np.isfinite(gl) and abs(gl - cl) <= TRAIN_RTOL * abs(cl),
              f"{label}: loss {gl} on the card vs {cl} on the CPU")
        check(sorted(gm) == sorted(cm), f"{label}: metric keys differ")
        for k in gm:
            check(abs(gm[k] - cm[k]) <= TRAIN_RTOL * abs(cm[k]) + 1e-4,
                  f"{label}: metric {k} {gm[k]} on the card vs {cm[k]} on the CPU")
        check(worst <= 1.0, f"{label}: gradient of {worst_name} differs between the card "
              "and the CPU")
        numbers[label] = {"loss_cuda": gl, "loss_cpu64": cl,
                          "worst_grad_share_of_limit_vs_cpu64": worst,
                          "worst_leaf_vs_cpu64": worst_name, "replayed": moved,
                          "launches": launches, "card_s": seconds["cuda"],
                          "cpu64_s": seconds["cpu"]}
    return numbers


def poe_lattice_time_rows(g: torch.Generator, m: int, rows_: int, d: int, label: str):
    """The PoE lattice forward and backward over every subset of ``m``
    experts at (``rows_``, ``d``), timed (device ms, graphed) beside their
    plain versions and bounds: two rows of the kernels line."""
    from multimodal_vae_comparison_tpu_torch.ops.fusion import subset_lattice
    from multimodal_vae_comparison_tpu_torch.ops.kernels import poe_kernel
    src = "multimodal_vae_comparison_tpu_torch/csrc/"
    ref = "multimodal_vae_comparison_tpu/ops/pallas/"
    lattice = subset_lattice(m)
    s, n = len(lattice), rows_ * d
    mus, scales = lattice_inputs(g, m, rows_, d)
    masks = poe_kernel.lattice_masks(lattice, m)
    ups = [torch.randn((s, rows_, d), generator=g, device="cuda") for _ in range(2)]
    mu, scale = poe_kernel.poe_lattice(mus, scales, lattice, 1.0)
    want = poe_kernel.poe_lattice_reference(mus, scales, lattice, 1.0)
    sizes = sum(len(sub) for sub in lattice)
    at = f"{label} M={m} S={s} ({rows_}, {d})"
    common = {"route": "cuda", "source": src + "poe.cu", "library_ms": None}
    rows = [{"name": "poe_lattice", "at": at, **common,
             "replaces": ref + "poe_kernel.py:48",
             "max_abs_err": max((a - w).abs().max().item()
                                for a, w in zip((mu, scale), want)),
             "within_tolerance": all(torch.allclose(a, w, rtol=POE_RTOL, atol=POE_ATOL)
                                     for a, w in zip((mu, scale), want)),
             "ms": graph_ms(lambda: poe_kernel.poe_lattice(mus, scales, lattice, 1.0)),
             "plain_ms": graph_ms(lambda: poe_kernel.poe_lattice_reference(
                 mus, scales, lattice, 1.0)),
             **dict(zip(("bound_ms", "bound_by"), bound_ms(
                 4 * (2 * m * n + 2 * s * n), n * (4 * m + 2 * sizes + 4 * s))))}]
    bwd = lambda: poe_kernel._launch_backward(mus, scales, masks, mu, scale, *ups)
    plain_bwd = lambda: poe_kernel.poe_lattice_backward_reference(mus, scales, mu, scale,
                                                                  *ups, lattice)
    pairs = list(zip(sum(map(list, bwd()), []), sum(plain_bwd(), [])))
    rows.append({"name": "poe_lattice_backward", "at": at, **common,
                 "replaces": ref + "poe_kernel.py:124 (_poe_bwd, the VJP of :48)",
                 "max_abs_err": max((a - w).abs().max().item() for a, w in pairs),
                 "within_tolerance": all(torch.allclose(a, w, rtol=POE_BWD_RTOL,
                                                        atol=POE_BWD_ATOL) for a, w in pairs),
                 "ms": graph_ms(bwd), "plain_ms": graph_ms(plain_bwd),
                 **dict(zip(("bound_ms", "bound_by"), bound_ms(
                     4 * (2 * m * n + 4 * s * n + 2 * m * n),
                     n * (6 * m + 5 * s + 7 * sizes))))})
    return rows


def phase_sprites_times(card: str):
    """The SPRITES path's kernel shapes timed (device ms, graphed) beside
    their plain versions, their bounds and the library's call: masked
    attention on the T, H and W axes of a bs-16 encoder call, of a K*B = 80
    clip decode and of the MOE run's lattice-batched decode of M*K*B = 240
    clips (W's shape is H's); the PoE lattice forward and backward at the
    POE run's M 3, S 7, (32, 10).  Returns one row per shape."""
    import torch.nn.functional as F
    from multimodal_vae_comparison_tpu_torch.ops.kernels import attention
    g = torch.Generator(device="cuda").manual_seed(44)
    rows = []
    src = "multimodal_vae_comparison_tpu_torch/csrc/"
    ref = "multimodal_vae_comparison_tpu/ops/pallas/"
    for label, clips in (("encoder bs 16", 16), ("decoder K*B 80", 80),
                         ("decoder M*K*B 240", 240)):
        for axis, shape in zip("TH", axial_shapes(clips)[:2]):
            q, k, v, _ = attention_inputs(g, *shape, False)
            b, h, tq, tk, dh = shape
            kern = graph_ms(lambda: attention.masked_attention(q, k, v))
            plain = graph_ms(lambda: attention.attention_reference(q, k, v))
            try:
                lib = graph_ms(lambda: F.scaled_dot_product_attention(q, k, v))
                lib_note = "F.scaled_dot_product_attention(q, k, v), graphed"
            except RuntimeError as e:   # the library's limits, not the port's
                lib, lib_note = None, f"SDPA refused the shape: {str(e)[:120]}"
            err = (attention.masked_attention(q, k, v)
                   - attention.attention_reference(q, k, v)).abs().max().item()
            bound, by = attention_bound(b, h, tq, tk, dh)
            rows.append({"name": "masked_attention", "at": f"sprites {label}, {axis} {shape}",
                         "route": "cuda", "source": src + "attention.cu",
                         "replaces": ref + "attention.py:77", "max_abs_err": err, "ms": kern,
                         "plain_ms": plain, "bound_ms": bound, "bound_by": by,
                         "library_ms": lib, "library_is": lib_note})
    rows += poe_lattice_time_rows(g, 3, 32, 10, "sprites POE")
    for r in rows:
        print(f"time {r['name']} [{r['at']}]: kernel {r['ms']:.5f} ms, plain "
              f"{r['plain_ms']:.5f} ms, library "
              f"{'n/a' if r['library_ms'] is None else format(r['library_ms'], '.5f')} ms "
              f"(SDPA, no mask), bound {r['bound_ms']:.6f} ms ({r['bound_by']}), max_abs_err "
              f"{r['max_abs_err']:.3e} on {card}")
    return rows


# -- the mixture prior, and the CelebA, CUB and synthetic configs ------------

# the mixture-prior config (MOE, DReG K 10, 50 components, bs 24) on the
# CdSprites+ level-1 rows "train from config" makes: 1 resident epoch (not
# 150), profiled, then test()
MOG_FROM_CONFIG = ("MOE mog cdl1_r4_mog", "configs/round4/cdl1_r4_mog.yml")
# launches of one objective call and of a train step's backward, by run.
# DReG: the text encoder once and the text decoder on all M*K*B samples in
# each of its two passes, and no KL kernel: DReG takes no KL.  MOE ELBO:
# attention 2 and the KL kernel once for all modalities, but under the
# mixture prior no KL kernel (the KL is a Monte-Carlo mean).  POE under the
# mixture: attention 2 and the lattice's PoE.  CelebA's POE: no text, the
# lattice's PoE alone
FAMILY_PER_OBJECTIVE = {"dreg": {"attention": 3}, "moe": {"attention": 2, "kl": 1},
                        "moe_mog": {"attention": 2}, "poe_mog": {"attention": 2, "poe": 1},
                        "celeba": {"poe": 1}}
FAMILY_PER_BACKWARD = {"dreg": {}, "moe": {"kl_bwd": 1}, "moe_mog": {},
                       "poe_mog": {"poe_bwd": 1}, "celeba": {"poe_bwd": 1}}
FAMILY_TABLES = (FAMILY_PER_OBJECTIVE, FAMILY_PER_BACKWARD)
# card (fp32) against the CPU in float64 under the mixture prior, at the
# config's widths and bs MOG_PARITY_BATCH: (label, overrides of the config,
# launches key).  The POE and MOE ELBO steps are the config with another
# mixing or objective: POE's KL to the prior and MOE's are the other
# Monte-Carlo paths
MOG_PARITY_BATCH = 2
MOG_PARITY = (("MOE dreg K 10", {}, "dreg"),
              ("POE elbo", {"mixing": "poe", "obj": "elbo", "K": 1}, "poe_mog"),
              ("MOE elbo", {"obj": "elbo", "K": 1}, "moe_mog"))
# the surrogates made in the run, (train rows, test rows) at seed 0: cut
# from the builders' 8,000 / 1,000 (CelebA) and 6,000 / 800 (CUB)
CELEBA_COUNTS, CUB_COUNTS = (2000, 400), (1500, 300)
# (label, config, data, launches key, test()): 1 resident epoch each (not
# 200-600); each family's first config ends in test() and its benchmark
FAMILIES_FROM_CONFIG = (
    ("POE celeba", "configs/config_celeba.yml", "celeba", "celeba", True),
    ("POE celeba_r2", "configs/round2/celeba_r2.yml", "celeba", "celeba", False),
    ("MOE cub", "configs/config_cub.yml", "cub", "moe", True),
    ("MOE cub_r2", "configs/round2/cub_r2.yml", "cub", "dreg", False),
    ("MOE synthetic", "configs/config_synthetic.yml", "synthetic", "moe", True))
# launches of each benchmark: CelebA's two POE cross-generations (the PoE
# kernel once each, no text); CUB's image->text forward (the text decoded
# from the image's sample and as its cross), text->image (the text encoder
# and its own decode) and the prior joint's text decode; the synthetic set
# has none
FAMILY_EVAL_LAUNCHES = {"celeba": {"poe": 2}, "cub": {"attention": 5}, "synthetic": {}}
CUB_TEXT = 246


def phase_mog_from_config(card: str, root: str, data):
    """Queue A item 2a's main path: ``cdl1_r4_mog.yml`` (MOE, DReG K 10, a
    50-component mixture prior) trained for 1 resident epoch through
    ``main(config)`` on the ZOO_DATA_COUNT rows of level 1, the
    epoch under ``torch.profiler``, ending in ``Trainer.test()`` with the
    judge that phase cached.  Counted from zero: exactly its objective
    calls' attention (FAMILY_PER_OBJECTIVE["dreg"]) and no KL launch, plus
    the benchmark's (:func:`eval_launches`); the val loss falls; the 12
    stats are in range; the benchmark's prior joint draws once from the
    mixture; ``model/last`` restored through ``MultimodalVAEInfer`` gives
    the trainer's forward within RESTORE_RTOL / RESTORE_ATOL, and the prior
    joint on the card that of the CPU, whose draw is the mixture's own.
    Then the launches per call and step, and :func:`phase_mog_card_vs_cpu`.
    Returns (launches of the run, its numbers)."""
    from torch.profiler import ProfilerActivity, profile
    from multimodal_vae_comparison_tpu_torch.eval.infer import MultimodalVAEInfer
    from multimodal_vae_comparison_tpu_torch.main import main as train_main
    from multimodal_vae_comparison_tpu_torch.models.distributions import MixtureNormal

    numbers, total = {"card": card}, {}
    os.environ["CDSPRITES_CLASSIFIER_DIR"] = os.path.join(root, "judges")
    label, path = MOG_FROM_CONFIG
    config, trainer, stats = config_trainer(label, path, "moe", cdsprites_paths(data), root, 1)
    model = trainer.model
    check(isinstance(model.pz(), MixtureNormal) and model.prior_components == 50
          and model.K == 10 and model.obj == "dreg",
          f"{label}: prior {type(model.pz()).__name__} of {model.prior_components}, "
          f"K {model.K}, obj {model.obj}")
    dm, bs = trainer.datamodule, config.batch_size
    steps, val_batches = dm.n_train // bs, dm.n_val // bs
    trainer.stage_epoch_data()
    trainer.stage_val_data()
    untrained = trainer.validate_scan(0)["val_loss"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    evals = eval_launches("moe", dm.n_train)
    times, profiled, prior_draws = {}, {}, []
    own_sample = MixtureNormal.sample

    def counting_sample(self, num, *args, **kwargs):
        prior_draws.append(num)
        return own_sample(self, num, *args, **kwargs)

    def run():
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            trainer.fit(epochs=1)
            torch.cuda.synchronize()
            profiled["wall_ms"] = (time.perf_counter() - t1) * 1e3
        act = device_activity(prof, profiled["wall_ms"])
        profiled.update(busy_share=act["busy_share"], device_events=act["events"],
                        device_ms=act["ms"], top_kernels_ms={
                            n[:80]: ms for n, ms in act["ms_by_name"].most_common(6)})
        MixtureNormal.sample = counting_sample
        try:
            with eval_stopwatch(times):
                train_main(config, trainer=trainer, enable_viz=False)
        finally:
            MixtureNormal.sample = own_sample

    t0 = time.perf_counter()
    counted(label, "dreg", steps + 2 * val_batches, steps, run, total, evals, FAMILY_TABLES)
    run_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check_stats(label, stats)
    check(prior_draws == [JOINT_ROWS], f"{label}: the benchmark drew {prior_draws} rows from "
          f"the mixture prior, expected one prior joint of {JOINT_ROWS}")
    check(trainer.model.K == config.K, f"{label}: test() left the model at K {trainer.model.K}")
    rows = _csv_rows(os.path.join(config.mPath, "metrics.csv"))
    trained = float(rows[-1]["val_loss"])
    epoch_s, samples_s = float(rows[-1]["epoch_time_s"]), float(rows[-1]["samples_per_s"])
    check(len(rows) == 1, f"{label}: metrics.csv has {len(rows)} rows for 1 epoch")
    check(np.isfinite(trained) and trained < untrained,
          f"{label}: val_loss {trained} after training, {untrained} before")
    for tag in ("last", "best"):
        check(os.path.isfile(os.path.join(config.mPath, "model", tag, "state.pt")),
              f"{label}: no model/{tag} checkpoint")
    batch = next(dm.batches("val"))
    rng = np.random.default_rng(50)
    err = check_restored(label, config.mPath, trainer, batch, eps_to(
        {n: rng.standard_normal((1, bs, config.n_latents)).astype(np.float32)
         for n in trainer.model.mod_names}, trainer.device))
    # the prior joint on the card and on the CPU from the run directory: the
    # CPU generator's draw is the mixture's (its component, then eps) on both
    card_exp, cpu_exp = MultimodalVAEInfer(config.mPath), MultimodalVAEInfer(config.mPath,
                                                                          device="cpu")
    check(cpu_exp.model.prior_components == 50, f"{label}: restored without the mixture")
    pz = cpu_exp.model.pz()
    g = torch.Generator().manual_seed(0)
    idx = torch.multinomial(torch.softmax(pz.logits.detach(), -1), JOINT_ROWS,
                            replacement=True, generator=g)
    eps = torch.randn(JOINT_ROWS, config.n_latents, generator=g)
    with torch.no_grad():
        want_z = pz.locs[idx] + pz.scales[idx] * eps
        got_z = cpu_exp.model.sample_pz(JOINT_ROWS, generator=torch.Generator().manual_seed(0))
    check(torch.allclose(got_z[0], want_z), f"{label}: sample_pz is not the mixture's draw")
    joints = {name: exp.joint_generate(JOINT_ROWS, source="prior")
              for name, exp in (("card", card_exp), ("cpu", cpu_exp))}
    joint_err = max(float(np.abs(joints["card"][m] - joints["cpu"][m]).max())
                    for m in joints["cpu"])
    check(all(np.allclose(joints["card"][m], joints["cpu"][m], rtol=EVAL_RTOL, atol=EVAL_ATOL)
              for m in joints["cpu"]),
          f"{label}: prior joint on the card vs the CPU max_abs_err {joint_err:.3e}")
    per_call = step_launches(label, trainer, batch, "dreg", tables=FAMILY_TABLES,
                             phase="mog from config")
    print(f"eval from config {label}: " + ", ".join(
        f"{k} {stats[k]:.2f}" for k in stats if not k.startswith("val_"))
        + f"; launches of the eval {evals}; seconds " + ", ".join(
            f"{k[:-2]} {v:.3f}" for k, v in times.items()) + f" on {card}")
    print(f"mog from config {label} ({path}): {trainer.n_params()} parameters "
          f"(pz_mog_* {50 * (2 * config.n_latents + 1)}), {dm.n_train} train / {dm.n_val} val "
          f"rows, {steps} steps of {bs} at K {config.K}; val_loss untrained {untrained:.2f} -> "
          f"{trained:.2f}; epoch {epoch_s:.3f} s, {samples_s:.1f} samples/s (profiled: wall "
          f"{profiled['wall_ms']:.1f} ms, busy {profiled['busy_share']:.4f}, "
          f"{profiled['device_ms']:.1f} device ms); main() with test() {run_s:.2f} s; peak "
          f"memory {peak:.3f} GiB; prior joint card vs CPU max_abs_err {joint_err:.3e}; "
          f"largest by device ms {json.dumps(profiled['top_kernels_ms'])} on {card}")
    numbers.update({
        "config": path, "params": trainer.n_params(), "steps": steps, "batch": bs,
        "K": config.K, "prior_components": 50, "val_loss_untrained": untrained,
        "val_loss": trained, "epoch_s": epoch_s, "samples_per_s": samples_s,
        "main_with_test_s": run_s, "peak_memory_gib": peak,
        "eval_stats": {k: v for k, v in stats.items() if not k.startswith("val_")},
        "eval_s": times, "eval_launches": evals, "restore_max_abs_err": err,
        "prior_joint_card_vs_cpu_max_abs_err": joint_err,
        **{f"profiled_epoch_{k}": v for k, v in profiled.items()}, **per_call})
    del trainer, card_exp, cpu_exp
    numbers["card_vs_cpu"] = phase_mog_card_vs_cpu(card, root, data, batch)
    os.environ.pop("CDSPRITES_CLASSIFIER_DIR")
    return total, numbers


def phase_mog_card_vs_cpu(card: str, root: str, data, batch) -> dict:
    """One objective and its backward under the mixture prior at the
    config's widths (50 components, seeded weights, MOG_PARITY_BATCH real
    rows of ``batch``, drawn eps) for each of MOG_PARITY: the card (kernels,
    fp32, TF32 off) against the CPU's plain path in float64 on the card's
    relu branches and DReG weights (:func:`same_branches`,
    :func:`same_dreg_weights`): loss and metrics within TRAIN_RTOL, every
    gradient (the pz_mog_* leaves among them, each nonzero) within GRAD_REL
    x its leaf's max |g| + GRAD_ATOL; the card launches exactly one
    objective call's and one backward's kernels, no KL kernel."""
    from multimodal_vae_comparison_tpu_torch.ops.kernels import telemetry
    from multimodal_vae_comparison_tpu_torch.training.trainer import build_model_from_config
    label0, path = MOG_FROM_CONFIG
    n, rng = MOG_PARITY_BATCH, np.random.default_rng(51)
    rows = {k: {"data": v["data"][:n], "masks": None if v["masks"] is None else v["masks"][:n]}
            for k, v in batch.items()}
    numbers = {}
    for label, over, key in MOG_PARITY:
        cfg = from_config(path, cdsprites_paths(data), root, eval_only=True, **over)
        for i, mod in enumerate(cfg.mods):
            mod.feature_dims = list(rows[f"mod_{i + 1}"]["data"].shape[1:])
        shape = (cfg.K, n, cfg.n_latents)
        eps = ({m: rng.standard_normal(shape).astype(np.float32) for m in rows}
               if cfg.mixing == "moe"
               else [rng.standard_normal(shape).astype(np.float32) for _ in range(3)])
        branches, weights, out, moved, seconds = [], [], {}, {}, {}
        for dev, dtype in (("cuda", torch.float32), ("cpu", torch.float64)):
            model = build_model_from_config(cfg, device=dev).to(dtype)
            tb = {k: {"data": v["data"].to(dtype), "masks": v["masks"]}
                  for k, v in torch_batch(rows, dev).items()}
            te = eps_to(eps, dev)
            te = ({k: v.to(dtype) for k, v in te.items()} if isinstance(te, dict)
                  else [v.to(dtype) for v in te])
            telemetry.reset()
            t0 = time.perf_counter()
            with same_branches(branches, dev == "cpu", moved), \
                    same_dreg_weights(weights, dev == "cpu", moved):
                out[dev] = _objective_grads(model, tb, te)
            seconds[dev] = time.perf_counter() - t0
            if dev == "cuda":
                launches, paths = telemetry.launches(), telemetry.summary()
            del model
        want = expected_launches(key, 1, 1, FAMILY_TABLES)
        (gl, gm, gg), (cl, cm, cg) = out["cuda"], out["cpu"]
        worst, worst_name = _worst_leaf(gg, {k: v.float() for k, v in cg.items()}, GRAD_REL,
                                        GRAD_ATOL)
        print(f"mog card vs CPU {label} ({path}, 50 components, bs {n}, K {cfg.K}): loss cuda "
              f"{gl:.6f}, cpu float64 {cl:.6f}; worst gradient leaf {worst:.3f} of its limit at "
              f"{worst_name} (limit {GRAD_REL} x max|g| + {GRAD_ATOL}); replayed on the CPU: "
              f"{moved}; launches {launches}, expected {want}; {seconds['cuda']:.3f} s on the "
              f"card, {seconds['cpu']:.3f} s on the CPU ({card})")
        check(launches == want, f"{label}: launched {launches}, expected {want}")
        check(not any(k.endswith(":plain") for k in paths),
              f"{label}: a plain version ran on the card: {paths}")
        check(np.isfinite(gl) and abs(gl - cl) <= TRAIN_RTOL * abs(cl),
              f"{label}: loss {gl} on the card vs {cl} on the CPU")
        check(sorted(gm) == sorted(cm), f"{label}: metric keys differ")
        for k in gm:
            check(abs(gm[k] - cm[k]) <= TRAIN_RTOL * abs(cm[k]) + 1e-4,
                  f"{label}: metric {k} {gm[k]} on the card vs {cm[k]} on the CPU")
        check(worst <= 1.0, f"{label}: gradient of {worst_name} differs between the card "
              "and the CPU")
        check(all(gg[k].abs().sum().item() > 0 for k in gg if k.startswith("pz_mog_")),
              f"{label}: a pz_mog_* leaf got no gradient")
        numbers[label] = {"loss_cuda": gl, "loss_cpu64": cl,
                          "worst_grad_share_of_limit_vs_cpu64": worst,
                          "worst_leaf_vs_cpu64": worst_name, "replayed": moved,
                          "launches": launches, "card_s": seconds["cuda"],
                          "cpu64_s": seconds["cpu"]}
    return numbers


def make_surrogates(root: str):
    """CelebA at CELEBA_COUNTS and CUB at CUB_COUNTS through the port's
    surrogate builders (seed 0): ({family: directory}, seconds)."""
    from multimodal_vae_comparison_tpu_torch.data_proc import surrogates
    t0 = time.perf_counter()
    dirs = {family: getattr(surrogates, f"build_{family}")(
        os.path.join(root, family), n_train=counts[0], n_test=counts[1], seed=0)
        for family, counts in (("celeba", CELEBA_COUNTS), ("cub", CUB_COUNTS))}
    return dirs, time.perf_counter() - t0


def family_paths(family: str, dirs: dict) -> dict:
    """Each modality's data paths in the surrogate of ``family`` (the
    synthetic set keeps its config's row count)."""
    stems = {"celeba": ("images.npy", "atts.npy"), "cub": ("images.npy", "captions.pkl"),
             "synthetic": ()}[family]
    return {f"modality_{i + 1}": {"path": os.path.join(dirs[family], s),
                                  "test_datapath": os.path.join(dirs[family], "test_" + s)}
            for i, s in enumerate(stems)}


def cub_attention_cases(cub_dir: str):
    """(label, (B, H, Tq, Tk, Dh), key mask or None) of every masked
    attention the CUB runs launch: the text encoder's self-attention at the
    two configs' batches and the eval's val rows, each masked by real
    captions' padding (the surrogate's first B train captions), and the
    text decoder's cross-attention at their decode batches (cub_r2's M*K*B
    = 640)."""
    import pickle
    from multimodal_vae_comparison_tpu_torch.data.text import encode_text_batch
    with open(os.path.join(cub_dir, "captions.pkl"), "rb") as f:
        captions = pickle.load(f)
    n_val = CUB_COUNTS[0] - int(CUB_COUNTS[0] * 0.9)
    cases = []
    for label, b in (("cub_r2 encoder bs 32", 32), ("config_cub encoder bs 16", 16),
                     (f"eval encoder {n_val} rows", n_val)):
        mask = torch.from_numpy(encode_text_batch(captions[:b], CUB_TEXT)[1]).cuda()
        cases.append((label, (b, 2, CUB_TEXT, CUB_TEXT, 32), mask))
    for label, b in (("cub_r2 decoder M*K*B 640", 640), ("config_cub decoder M*K*B 32", 32),
                     (f"eval decoder {n_val} rows", n_val)):
        cases.append((label, (b, 2, CUB_TEXT, 1, 8), None))
    return cases


def phase_cub_attention(card: str, cub_dir: str):
    """Masked attention at CUB's 246-character captions against its plain
    version: the forward at every shape of :func:`cub_attention_cases` on
    the kernel its route gives it, the encoders' skipping of the dead key
    tiles (:func:`padded_tiles_check`), the backward (the autograd
    Function's) at the two train batches' encoder and cub_r2's decoder; then
    the train shapes timed (device ms, graphed) beside the plain version,
    the byte bound and SDPA with the same key-padding mask.  Returns (parity
    numbers, time rows)."""
    import torch.nn.functional as F
    from multimodal_vae_comparison_tpu_torch.ops.kernels import attention, telemetry
    g = torch.Generator(device="cuda").manual_seed(52)
    parity, rows = {}, []
    cases = cub_attention_cases(cub_dir)
    for label, shape, mask in cases:
        q, k, v, _ = attention_inputs(g, *shape, False)
        telemetry.reset()
        got = attention.masked_attention(q, k, v, mask)
        took = telemetry.variants()
        want = attention.attention_reference(q, k, v, mask)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        padded = 0.0 if mask is None else 1.0 - mask.float().mean().item()
        print(f"parity attention cub {label} {shape} (padded keys {padded:.3f}): "
              f"max_abs_err={err:.3e} (rtol {ATTN_RTOL}, atol {ATTN_ATOL}); {took}")
        check(took == {f"attention:{attention_variant(shape)}": 1},
              f"attention at {shape} launched {took}")
        check(torch.allclose(got, want, rtol=ATTN_RTOL, atol=ATTN_ATOL),
              f"attention kernel disagrees with its plain version at {shape}")
        parity[f"{label} {shape}"] = {"max_abs_err": err, "padded_keys": padded}
        if mask is not None:   # the encoders: the mma kernel skips the dead tiles
            parity[f"{label} {shape}"]["dead_tiles"] = padded_tiles_check(
                card, f"cub {label} {shape}", q, k, v, mask, got)
    for label, shape, mask in (cases[0], cases[1], cases[3]):
        q, k, v, _ = attention_inputs(g, *shape, False)
        d_out = torch.randn(q.shape, generator=g, device="cuda")
        _grad_parity(f"attention cub {label} {shape}",
                     lambda q_, k_, v_: attention.masked_attention(q_, k_, v_, mask),
                     lambda q_, k_, v_: attention.attention_reference(q_, k_, v_, mask),
                     (q, k, v), d_out, ATTN_RTOL, ATTN_ATOL)
    src = "multimodal_vae_comparison_tpu_torch/csrc/attention.cu"
    for label, shape, mask in (cases[0], cases[1], cases[3]):
        q, k, v, _ = attention_inputs(g, *shape, False)
        b, h, tq, tk, dh = shape
        lib_mask = None if mask is None else mask[:, None, None, :]
        kern = graph_ms(lambda: attention.masked_attention(q, k, v, mask))
        plain = graph_ms(lambda: attention.attention_reference(q, k, v, mask))
        try:
            lib = graph_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=lib_mask))
            lib_note = "graphed"
        except RuntimeError as e:   # the library's limits, not the port's
            lib, lib_note = eager_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=lib_mask)), f"eager (graph capture refused: {str(e)[:80]})"
        err = (attention.masked_attention(q, k, v, mask)
               - attention.attention_reference(q, k, v, mask)).abs().max().item()
        bound, by = attention_bound(b, h, tq, tk, dh, mask)
        rows.append({"name": "masked_attention", "at": f"cub {label}, {shape}",
                     "masked": mask is not None, "route": "cuda", "source": src,
                     "replaces": "multimodal_vae_comparison_tpu/ops/pallas/attention.py:77",
                     "max_abs_err": err, "ms": kern, "plain_ms": plain, "bound_ms": bound,
                     "bound_by": by, "library_ms": lib,
                     "library_is": "F.scaled_dot_product_attention(q, k, v, attn_mask=the "
                                   f"key padding or none), {lib_note}",
                     "dead_tiles": parity[f"{label} {shape}"].get("dead_tiles")})
        print(f"time masked_attention [cub {label} {shape}]: kernel {kern:.5f} ms, plain "
              f"{plain:.5f} ms, SDPA {lib:.5f} ms, bound {bound:.6f} ms ({by}), max_abs_err "
              f"{err:.3e} on {card}")
    return parity, rows


def family_stopwatch(times: dict):
    """:func:`stopwatch` over the CelebA and CUB benchmarks' judges (trained
    or loaded), CUB's FID and the whole evals."""
    from multimodal_vae_comparison_tpu_torch.eval import eval_celeba, eval_cub, fid
    return stopwatch(((eval_celeba, "_att_judge", lambda a, k: "judges_s"),
                      (eval_celeba, "celeba_stats", lambda a, k: "eval_s"),
                      (eval_cub, "_judges", lambda a, k: "judges_s"),
                      (fid, "calculate_fid_given_data", lambda a, k: "fid_s"),
                      (eval_cub, "cub_stats", lambda a, k: "eval_s")), times)


def check_family_stats(label: str, family: str, stats: dict) -> None:
    """The benchmark's stats (fractions) all there, finite and in [0, 1],
    CUB's ``fid`` finite and positive, and no ``eval_error``."""
    from multimodal_vae_comparison_tpu_torch.eval import eval_celeba, eval_cub
    keys = {"celeba": eval_celeba.STATS_KEYS, "cub": eval_cub.STATS_KEYS}[family]
    check("eval_error" not in stats, f"{label}: the eval failed: {stats.get('eval_error')}")
    bad = {k: stats.get(k) for k in keys if k != "fid"
           and not (isinstance(stats.get(k), float) and 0.0 <= stats[k] <= 1.0)}
    check(not bad, f"{label}: stats missing, not finite or out of [0, 1]: {bad}")
    if family == "cub":
        check(isinstance(stats.get("fid"), float) and np.isfinite(stats["fid"])
              and stats["fid"] > 0, f"{label}: fid {stats.get('fid')}")


def phase_families_from_config(card: str, root: str):
    """Queue A item 7a's main path: the CelebA and CUB surrogates made by
    the port's builders at CELEBA_COUNTS and CUB_COUNTS, masked attention
    at CUB's caption length (:func:`phase_cub_attention`), then each config
    of FAMILIES_FROM_CONFIG trained for 1 resident epoch; each family's
    first config through ``main(config)``, ending in ``Trainer.test()`` and
    its benchmark (the judges trained on the card), the others through
    ``fit``.  Each run is counted from zero: exactly its objective calls
    (train steps + validation batches, and test()'s validation) times
    FAMILY_PER_OBJECTIVE, its train steps times FAMILY_PER_BACKWARD and its
    benchmark's FAMILY_EVAL_LAUNCHES, no plain version; the val loss falls;
    the stats are in [0, 1]; a tested run's ``model/last`` restored through
    ``MultimodalVAEInfer`` gives the trainer's forward within RESTORE_RTOL /
    RESTORE_ATOL; then the launches per call and step.  Returns (launches
    of the runs, the phase's numbers, the attention time rows)."""
    from multimodal_vae_comparison_tpu_torch.main import main as train_main

    numbers, total = {"card": card}, {}
    dirs, numbers["data_s"] = make_surrogates(os.path.join(root, "surrogates"))
    dirs["synthetic"] = None
    numbers["cut"] = {"celeba_train_test": CELEBA_COUNTS, "cub_train_test": CUB_COUNTS,
                      "epochs": 1}
    for family in ("CELEBA", "CUB"):
        os.environ[f"{family}_CLASSIFIER_DIR"] = os.path.join(root, "family_judges")
    numbers["attention_parity"], rows = phase_cub_attention(card, dirs["cub"])
    for label, path, family, key, test in FAMILIES_FROM_CONFIG:
        mixing = "poe" if key == "celeba" else "moe"
        config, trainer, stats = config_trainer(label, path, mixing,
                                                family_paths(family, dirs), root, 1)
        dm, bs = trainer.datamodule, config.batch_size
        steps, val_batches = dm.n_train // bs, dm.n_val // bs
        t0 = time.perf_counter()
        staged = (trainer.stage_epoch_data(), trainer.stage_val_data())
        torch.cuda.synchronize()
        stage_s = time.perf_counter() - t0
        staged_bytes = sum(t.numel() * t.element_size() for split in staged
                           for mod in split.values() for t in mod.values() if t is not None)
        untrained = trainer.validate_scan(0)["val_loss"]
        torch.cuda.reset_peak_memory_stats()
        evals = dict(FAMILY_EVAL_LAUNCHES[family]) if test else {}
        times = {}

        def run(trainer=trainer, config=config, times=times, test=test):
            if not test:
                trainer.fit(epochs=1)
                return
            with family_stopwatch(times):
                train_main(config, trainer=trainer, enable_viz=False)

        t0 = time.perf_counter()
        counted(label, key, steps + val_batches + (val_batches if test else 0), steps, run,
                total, evals, FAMILY_TABLES)
        run_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        rows_csv = _csv_rows(os.path.join(config.mPath, "metrics.csv"))
        trained = float(rows_csv[-1]["val_loss"])
        epoch_s = float(rows_csv[-1]["epoch_time_s"])
        samples_s = float(rows_csv[-1]["samples_per_s"])
        check(len(rows_csv) == 1, f"{label}: metrics.csv has {len(rows_csv)} rows for 1 epoch")
        check(np.isfinite(trained) and trained < untrained,
              f"{label}: val_loss {trained} after training, {untrained} before")
        for tag in ("last", "best"):
            check(os.path.isfile(os.path.join(config.mPath, "model", tag, "state.pt")),
                  f"{label}: no model/{tag} checkpoint")
        batch = next(dm.batches("val"))
        err = None
        if test:
            check(trainer.model.K == config.K, f"{label}: test() left the model at K "
                  f"{trainer.model.K}")
            if family != "synthetic":
                check_family_stats(label, family, stats)
                check(os.path.isfile(os.path.join(config.mPath, f"{family}_stats.txt")),
                      f"{label}: test() wrote no {family}_stats.txt")
            rng = np.random.default_rng(53)
            draw = lambda: rng.standard_normal((1, bs, config.n_latents)).astype(np.float32)
            eps = {n: draw() for n in trainer.model.mod_names} if mixing == "moe" else draw()
            err = check_restored(label, config.mPath, trainer, batch,
                                 eps_to(eps, trainer.device))
        per_call = step_launches(label, trainer, batch, key, tables=FAMILY_TABLES,
                                 phase="families from config")
        judged = {k: v for k, v in stats.items() if not k.startswith("val_")}
        print(f"families from config {label} ({path}): {trainer.n_params()} parameters, "
              f"{dm.n_train} train / {dm.n_val} val rows, {steps} steps of {bs} at K "
              f"{config.K}; staged {staged_bytes / 1e9:.3f} GB in {stage_s:.3f} s; val_loss "
              f"untrained {untrained:.2f} -> {trained:.2f}; epoch {epoch_s:.3f} s, "
              f"{samples_s:.1f} samples/s; run {run_s:.2f} s; peak memory {peak:.3f} GiB on "
              f"{card}")
        fid = judged.pop("fid", None)
        feature_net = None
        if fid is not None:
            from multimodal_vae_comparison_tpu_torch.eval.fid import active_feature_net
            feature_net = active_feature_net()
        if judged:
            print(f"eval from config {label}: " + ", ".join(
                f"{k} {100 * v:.2f}" for k, v in judged.items())
                + f" (%; the judge_* stats are the judges' accuracy on real surrogate "
                f"images)" + (f"; fid {fid:.6e} ({feature_net} features)" if fid else "")
                + f"; launches of the eval {evals}; seconds " + ", ".join(
                    f"{k[:-2]} {v:.3f}" for k, v in times.items()) + f" on {card}")
        numbers[label] = {
            "config": path, "params": trainer.n_params(), "steps": steps, "batch": bs,
            "K": config.K, "val_loss_untrained": untrained, "val_loss": trained,
            "epoch_s": epoch_s, "samples_per_s": samples_s, "run_s": run_s,
            "staged_bytes": staged_bytes, "stage_s": stage_s, "peak_memory_gib": peak,
            "stats_percent": {k: 100 * v for k, v in judged.items()},
            **({"fid": fid, "fid_feature_net": feature_net} if fid is not None else {}),
            "eval_s": times,
            "eval_launches": evals, "restore_max_abs_err": err, **per_call}
        del trainer, staged
    for family in ("CELEBA", "CUB"):
        os.environ.pop(f"{family}_CLASSIFIER_DIR")
    return total, numbers, rows


# -- VILANRO (ROADMAP Queue A item 7b) ---------------------------------------

# the data the three trained configs name, collected in the run by the port's
# collector (NLReach2-v0, seed 0) at its default 2,000 episodes, each by its
# recipe: D1 the defaults; D1chunk hindsight chunks every 5 steps; D1way_p2
# those chunks as start-relative waypoints
VILANRO_EPISODES = 2000
VILANRO_DATA = (("D1", {}), ("D1chunk", {"chunk_every": 5}),
                ("D1way_p2", {"chunk_every": 5, "waypoints": True}))
VILANRO_STEMS = ("instructions_final.pkl", "endeff_actions_final.pkl", "image_final.pkl")
# (label, config, data): the three action encodings, 1 resident epoch each
# (not 400-600) under torch.profiler; the first ends in test() and drives the
# closed loop, the probe and a DAgger round
VILANRO_FROM_CONFIG = (
    ("POE vilanro", "configs/config_vilanro.yml", "D1"),
    ("POE vilanro_r3_tokens", "configs/round3/vilanro_r3_tokens.yml", "D1chunk"),
    ("POE vilanro_r3_way_p2", "configs/round3/vilanro_r3_way_p2.yml", "D1way_p2"))
# launches of one objective call and of a train step's backward: attention
# in the language encoder (1 layer), the action encoder (8), the language
# decoder (1) and the action decoder (4); PoE once for the whole lattice
VILANRO_PER_OBJECTIVE = {"poe": {"attention": 14, "poe": 1}, "poe_cond": {"attention": 38, "poe": 1},
                         "moe_dreg": {"attention": 19}}
VILANRO_PER_BACKWARD = {"poe": {"poe_bwd": 1}, "poe_cond": {"poe_bwd": 1}, "moe_dreg": {}}
VILANRO_TABLES = (VILANRO_PER_OBJECTIVE, VILANRO_PER_BACKWARD)
# the closed loop (trials, open loop and replanning every 5 steps), the probe's
# scenes and the DAgger round's episodes (one batch of rollouts)
VILANRO_TRIALS, VILANRO_REPLAN, VILANRO_SCENES, VILANRO_DAGGER = 200, 5, 400, 20
VILANRO_PARITY_BATCH = 4
VILANRO_LANGUAGE = "mod_1"   # modality_1 of every VILANRO config


def vilanro_launch_key(cfg) -> str:
    """The key of a VILANRO config's rows in VILANRO_PER_OBJECTIVE and
    _PER_BACKWARD: "moe_dreg" for the MOE DReG config (attention in the two
    encoders, 1 + 8, and in each DReG pass's language and action decodes of
    the three samples stacked, 1 + 4); "poe_cond" where the action decoder
    is conditioned only on subsets with the language (it decodes per
    subset: 7 x 4 layers); "poe" for the others, ``cond_always`` among them
    (one decode for the whole lattice)."""
    if cfg.mixing == "moe":
        return "moe_dreg"
    if any(getattr(m, "cond_on", None) and not getattr(m, "cond_always", False)
           for m in cfg.mods):
        return "poe_cond"
    return "poe"


def vilanro_forward_launches(presents) -> dict:
    """Launches of the inference forwards with the modalities ``presents``
    (one tuple a forward): each decodes every modality (attention in the
    language decoder and the action decoder's 4 layers), encodes the
    language where it is present (1) and fuses the present experts (PoE
    once)."""
    attention = sum(5 + (VILANRO_LANGUAGE in p) for p in presents)
    return {k: n for k, n in (("attention", attention), ("poe", len(presents))) if n}


def make_vilanro(root: str, data=VILANRO_DATA, episodes: int = VILANRO_EPISODES):
    """``data`` (VILANRO_DATA unless given) collected by the port's
    collector, ``episodes`` each: ({name: directory}, {name: the
    collector's stats and seconds})."""
    from multimodal_vae_comparison_tpu_torch.lanro.collect import collect
    dirs, stats = {}, {}
    for name, options in data:
        t0 = time.perf_counter()
        st = collect("NLReach2-v0", episodes, os.path.join(root, name), seed=0, **options)
        st["seconds"] = time.perf_counter() - t0
        print(f"vilanro collect {name} {options}: {st['episodes']} episodes, {st['samples']} "
              f"samples, expert success {100 * st['expert_success']:.1f} %, vocabulary "
              f"{st['vocab_size']} words, {st['seconds']:.2f} s on the host")
        check(st["expert_success"] == 1.0, f"vilanro {name}: the scripted expert succeeded in "
              f"{100 * st['expert_success']:.1f} % of episodes")
        dirs[name], stats[name] = st["out_dir"], st
    return dirs, stats


def vilanro_paths(data_dir: str) -> dict:
    """Each modality's data path in a collected directory (language,
    actions, front RGB; no test file)."""
    return {f"modality_{i + 1}": {"path": os.path.join(data_dir, stem), "test_datapath": None}
            for i, stem in enumerate(VILANRO_STEMS)}


def attention_case(card: str, g: torch.Generator, label: str, shape, mask, at: str):
    """Masked attention at ``shape`` (B, H, Tq, Tk, Dh) under the (B, Tk)
    key ``mask`` or none, on the kernel its route gives the shape
    (:func:`attention_variant`) against its plain version,
    forward (on the resident or mma kernel under a mask, its skipping of
    the dead key tiles too: :func:`padded_tiles_check`) and the Function's
    backward,
    then timed (device ms, graphed)
    beside the plain version, SDPA under the same mask and the bound over
    the keys each row needs (:func:`attention_bound`).  Returns (parity
    numbers, the time row, whose "at" is ``at``)."""
    import torch.nn.functional as F
    from multimodal_vae_comparison_tpu_torch.ops.kernels import attention, telemetry
    q, k, v, _ = attention_inputs(g, *shape, False)
    telemetry.reset()
    got = attention.masked_attention(q, k, v, mask)
    took = telemetry.variants()
    want = attention.attention_reference(q, k, v, mask)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    padded = 0.0 if mask is None else 1.0 - mask.float().mean().item()
    print(f"parity attention {label} {shape} (padded keys {padded:.3f}): "
          f"max_abs_err={err:.3e} (rtol {ATTN_RTOL}, atol {ATTN_ATOL}); {took}")
    check(took == {f"attention:{attention_variant(shape)}": 1},
          f"attention at {shape} launched {took}")
    check(torch.allclose(got, want, rtol=ATTN_RTOL, atol=ATTN_ATOL),
          f"attention kernel disagrees with its plain version at {shape}")
    numbers = {"max_abs_err": err, "padded_keys": padded}
    if mask is not None and attention_variant(shape) in ("resident", "mma"):
        numbers["dead_tiles"] = padded_tiles_check(card, f"{label} {shape}", q, k, v, mask,
                                                   got)
    d_out = torch.randn(q.shape, generator=g, device="cuda")
    _grad_parity(f"attention {label} {shape}",
                 lambda q_, k_, v_: attention.masked_attention(q_, k_, v_, mask),
                 lambda q_, k_, v_: attention.attention_reference(q_, k_, v_, mask),
                 (q, k, v), d_out, ATTN_RTOL, ATTN_ATOL)
    b, h, tq, tk, dh = shape
    lib_mask = None if mask is None else mask[:, None, None, :]
    kern = graph_ms(lambda: attention.masked_attention(q, k, v, mask))
    plain = graph_ms(lambda: attention.attention_reference(q, k, v, mask))
    try:
        lib = graph_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=lib_mask))
        lib_note = "graphed"
    except RuntimeError as e:   # the library's limits, not the port's
        lib, lib_note = eager_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=lib_mask)), f"eager (graph capture refused: {str(e)[:80]})"
    bound, by = attention_bound(b, h, tq, tk, dh, mask)
    row = {"name": "masked_attention", "at": at, "masked": mask is not None,
           "padded_keys": padded, "route": "cuda",
           "source": "multimodal_vae_comparison_tpu_torch/csrc/attention.cu",
           "replaces": "multimodal_vae_comparison_tpu/ops/pallas/attention.py:77",
           "max_abs_err": err, "ms": kern, "plain_ms": plain, "bound_ms": bound,
           "bound_by": by, "library_ms": lib,
           "library_is": "F.scaled_dot_product_attention(q, k, v, attn_mask=the "
                         f"key padding or none), {lib_note}", **numbers}
    print(f"time masked_attention [{label} {shape}]: kernel {kern:.5f} ms, plain "
          f"{plain:.5f} ms, SDPA {lib:.5f} ms, bound {bound:.6f} ms ({by}), "
          f"{kern / bound:.1f}x the bound, max_abs_err {err:.3e} on {card}")
    return numbers, row


def phase_vilanro_attention(card: str, data_dir: str, batch: int, decodes: int):
    """Masked attention at VILANRO's shapes (head dim 16 at 32 latents)
    against its plain version, forward and the Function's backward: the
    action encoder's self-attention over ``batch`` collected trajectories
    (100 steps, their own step masks), the language encoder's over their
    instructions, and the two sequence decoders' cross-attention to one
    memory token on the lattice's ``decodes`` rows.  Then each timed
    (device ms, graphed) beside the plain version, SDPA with the same mask
    and the bound over the keys each row needs.  Returns (parity numbers,
    time rows)."""
    from multimodal_vae_comparison_tpu_torch.data.datasets import VILANRO
    masks = {t: torch.from_numpy(VILANRO(os.path.join(data_dir, stem), None, t)
                                 .get_data()[1][:batch]).cuda()
             for t, stem in (("actions", VILANRO_STEMS[1]), ("language", VILANRO_STEMS[0]))}
    steps, words = masks["actions"].shape[1], masks["language"].shape[1]
    cases = ((f"action encoder bs {batch}", (batch, 2, steps, steps, 16), masks["actions"]),
             (f"language encoder bs {batch}", (batch, 2, words, words, 32), masks["language"]),
             (f"action decoder S*K*B {decodes}", (decodes, 2, steps, 1, 16), None),
             (f"language decoder S*K*B {decodes}", (decodes, 2, words, 1, 16), None))
    g = torch.Generator(device="cuda").manual_seed(60)
    parity, rows = {}, []
    for label, shape, mask in cases:
        parity[f"{label} {shape}"], row = attention_case(card, g, f"vilanro {label}", shape,
                                                         mask, f"vilanro {label}, {shape}")
        rows.append(row)
    rows += checked_poe_rows(card, g, 3, batch, 32, "vilanro POE")
    return parity, rows


def phase_vilanro_closed_loop(card: str, run_dir: str, root: str, total: dict,
                              replans=(0, VILANRO_REPLAN), dagger: bool = True) -> dict:
    """The closed loop on a trained run, through the port's entry points on
    the card: ``vilanro_test`` over VILANRO_TRIALS trials for each of
    ``replans`` (0: open loop; else replanning every that many steps),
    ``vilanro_probe`` over VILANRO_SCENES scenes (both CLIs, each restoring
    the run and writing its stats file), then, with ``dagger``, one
    ``collect_dagger`` round of VILANRO_DAGGER episodes from the run.
    Counted from zero: exactly the launches of the forwards they made
    (:func:`vilanro_forward_launches`), no plain version.  Returns the
    numbers: stats, seconds, launches."""
    from multimodal_vae_comparison_tpu_torch.data.datasets import VILANRO
    from multimodal_vae_comparison_tpu_torch.eval import vilanro_probe, vilanro_test
    from multimodal_vae_comparison_tpu_torch.eval.infer import MultimodalVAEInfer
    from multimodal_vae_comparison_tpu_torch.lanro import collect
    presents, stats, seconds = [], {}, {}
    own_forward = MultimodalVAEInfer.forward
    own_loop, own_probe = vilanro_test.infer_loop, vilanro_probe.probe_report
    dagger_dir = os.path.join(root, "vilanro_dagger")

    def counting_forward(self, inputs, present, *args, **kwargs):
        presents.append(tuple(present))
        return own_forward(self, inputs, present, *args, **kwargs)

    def keeping(fn, key):
        def run(*args, **kwargs):
            stats[key] = fn(*args, **kwargs)
            return stats[key]
        return run

    def run():
        argv = sys.argv
        MultimodalVAEInfer.forward = counting_forward
        try:
            for replan in replans:
                vilanro_test.infer_loop = keeping(own_loop, f"replan{replan}")
                sys.argv = ["vilanro_test", "--model", run_dir, "--trials",
                            str(VILANRO_TRIALS), "--replan", str(replan)]
                t0 = time.perf_counter()
                vilanro_test.main()
                seconds[f"vilanro_test_replan{replan}_s"] = time.perf_counter() - t0
            vilanro_probe.probe_report = keeping(own_probe, "probe")
            sys.argv = ["vilanro_probe", "--model", run_dir, "--scenes", str(VILANRO_SCENES)]
            t0 = time.perf_counter()
            vilanro_probe.main()
            seconds["vilanro_probe_s"] = time.perf_counter() - t0
            if dagger:
                t0 = time.perf_counter()
                stats["dagger"] = collect.collect_dagger("NLReach2-v0", VILANRO_DAGGER,
                                                         dagger_dir, run_dir,
                                                         batch=VILANRO_DAGGER)
                seconds["collect_dagger_s"] = time.perf_counter() - t0
        finally:
            sys.argv = argv
            MultimodalVAEInfer.forward = own_forward
            vilanro_test.infer_loop, vilanro_probe.probe_report = own_loop, own_probe

    from multimodal_vae_comparison_tpu_torch.ops.kernels import telemetry
    telemetry.reset()
    run()
    torch.cuda.synchronize()
    got, paths = telemetry.launches(), telemetry.summary()
    want = vilanro_forward_launches(presents)
    print(f"vilanro closed loop: {len(presents)} forwards, launches {got}, expected {want}; "
          f"dispatch {paths}")
    check(got == want, f"vilanro closed loop: launched {got}, expected {want}")
    check(not any(k.endswith(":plain") for k in paths),
          f"vilanro closed loop: a plain version ran: {paths}")
    for k, n in got.items():
        total[k] = total.get(k, 0) + n
    for replan in replans:
        st = stats[f"replan{replan}"]
        check(st["trials"] == VILANRO_TRIALS and 0.0 <= st["success_rate"] <= 1.0
              and all(np.isfinite(v) for v in st.values()),
              f"vilanro_test replan {replan}: {st}")
        check(os.path.isfile(os.path.join(run_dir, f"vilanro_NLReach2-v0_replan{replan}"
                                                   "_stats.txt")),
              f"vilanro_test replan {replan} wrote no stats file")
    check(all(np.isfinite(v) for v in stats["probe"].values())
          and os.path.isfile(os.path.join(run_dir, "vilanro_probe_NLReach2-v0_stats.txt")),
          f"vilanro_probe: {stats['probe']}")
    if dagger:
        dagger_actions, dagger_masks = VILANRO(os.path.join(dagger_dir, VILANRO_STEMS[1]),
                                               None, "actions").get_data()
        check(stats["dagger"]["samples"] == len(dagger_actions) > 0
              and dagger_masks.any(1).all(), f"collect_dagger: {stats['dagger']}")
    for key in [f"replan{r}" for r in replans] + ["probe"]:
        print(f"vilanro closed loop {key}: " + json.dumps(stats[key]) + f" on {card}")
    print(f"vilanro closed loop: DAgger round {json.dumps(stats.get('dagger'))}; seconds "
          + json.dumps(seconds) + f" on {card}")
    return {"stats": stats, "seconds": seconds, "forwards": len(presents), "launches": got}


def phase_vilanro_card_vs_cpu(card: str, path: str, data_dir: str, root: str, batch,
                              key_bias_scale: bool = False) -> dict:
    """One objective and its backward of ``path`` at its widths on
    VILANRO_PARITY_BATCH collected rows of ``batch`` and drawn eps: the
    card (kernels, fp32, TF32 off) against the CPU's plain path in float64
    on the card's relu branches (and, for DReG, the card's importance
    weights: :func:`same_dreg_weights`): loss and metrics within
    TRAIN_RTOL, every gradient within GRAD_REL x its leaf's max |g| +
    GRAD_ATOL (with ``key_bias_scale`` a key bias at its key weight's
    scale: :func:`_worst_leaf`); the card launches exactly one
    objective call's and one backward's kernels (VILANRO_TABLES at
    :func:`vilanro_launch_key`)."""
    from multimodal_vae_comparison_tpu_torch.ops.kernels import telemetry
    from multimodal_vae_comparison_tpu_torch.training.trainer import build_model_from_config
    n, rng = VILANRO_PARITY_BATCH, np.random.default_rng(61)
    rows = {k: {"data": v["data"][:n], "masks": None if v["masks"] is None else v["masks"][:n]}
            for k, v in batch.items()}
    cfg = from_config(path, vilanro_paths(data_dir), root, eval_only=True)
    for i, mod in enumerate(cfg.mods):
        mod.feature_dims = list(rows[f"mod_{i + 1}"]["data"].shape[1:])
    key = vilanro_launch_key(cfg)
    shape = (cfg.K, n, cfg.n_latents)
    eps = ({m.name: rng.standard_normal(shape).astype(np.float32) for m in cfg.mods}
           if cfg.mixing == "moe" else
           [rng.standard_normal(shape).astype(np.float32) for _ in range(7)])
    branches, weights, out, moved, seconds = [], [], {}, {}, {}
    for dev, dtype in (("cuda", torch.float32), ("cpu", torch.float64)):
        model = build_model_from_config(cfg, device=dev).to(dtype)
        tb = {k: {"data": v["data"].to(dtype), "masks": v["masks"]}
              for k, v in torch_batch(rows, dev).items()}
        dev_eps = eps_to(eps, dev)
        dev_eps = ({k: v.to(dtype) for k, v in dev_eps.items()} if isinstance(dev_eps, dict)
                   else [e.to(dtype) for e in dev_eps])
        telemetry.reset()
        t0 = time.perf_counter()
        with same_branches(branches, dev == "cpu", moved), \
                same_dreg_weights(weights, dev == "cpu", moved):
            out[dev] = _objective_grads(model, tb, dev_eps)
        seconds[dev] = time.perf_counter() - t0
        if dev == "cuda":
            launches, paths = telemetry.launches(), telemetry.summary()
        del model
    want = expected_launches(key, 1, 1, VILANRO_TABLES)
    (gl, gm, gg), (cl, cm, cg) = out["cuda"], out["cpu"]
    worst, worst_name = _worst_leaf(gg, {k: v.float() for k, v in cg.items()}, GRAD_REL,
                                    GRAD_ATOL, key_bias_scale=key_bias_scale)
    print(f"vilanro card vs CPU ({path}, bs {n}): loss cuda {gl:.6f}, cpu float64 {cl:.6f}; "
          "metrics " + ", ".join(f"{k} {gm[k]:.6f}/{cm[k]:.6f}" for k in sorted(gm))
          + f"; worst gradient leaf {worst:.3f} of its limit at {worst_name} (limit "
          f"{GRAD_REL} x max|g| + {GRAD_ATOL}" + (", key biases at their key weight's "
                                                   "scale" if key_bias_scale else "")
          + f"); relu branches and DReG weights replayed on the CPU: {moved}; "
          f"launches {launches}, expected {want}; {seconds['cuda']:.3f} s on the card, "
          f"{seconds['cpu']:.3f} s on the CPU ({card})")
    check(launches == want, f"vilanro card vs CPU: launched {launches}, expected {want}")
    check(not any(k.endswith(":plain") for k in paths),
          f"vilanro card vs CPU: a plain version ran on the card: {paths}")
    check(np.isfinite(gl) and abs(gl - cl) <= TRAIN_RTOL * abs(cl),
          f"vilanro card vs CPU: loss {gl} on the card vs {cl} on the CPU")
    check(sorted(gm) == sorted(cm), "vilanro card vs CPU: metric keys differ")
    for k in gm:
        check(abs(gm[k] - cm[k]) <= TRAIN_RTOL * abs(cm[k]) + 1e-4,
              f"vilanro card vs CPU: metric {k} {gm[k]} on the card vs {cm[k]} on the CPU")
    check(worst <= 1.0, f"vilanro card vs CPU: gradient of {worst_name} differs")
    return {"loss_cuda": gl, "loss_cpu64": cl, "worst_grad_share_of_limit_vs_cpu64": worst,
            "worst_leaf_vs_cpu64": worst_name, "replayed": moved, "launches": launches,
            "card_s": seconds["cuda"], "cpu64_s": seconds["cpu"]}


def one_epoch_checks(label: str, config, untrained: float):
    """A run of 1 epoch wrote one row of ``metrics.csv`` whose val loss is
    below ``untrained`` and both checkpoints: (val loss, epoch s, samples/s)."""
    csv = _csv_rows(os.path.join(config.mPath, "metrics.csv"))
    trained = float(csv[-1]["val_loss"])
    check(len(csv) == 1, f"{label}: metrics.csv has {len(csv)} rows for 1 epoch")
    check(np.isfinite(trained) and trained < untrained,
          f"{label}: val_loss {trained} after training, {untrained} before")
    for tag in ("last", "best"):
        check(os.path.isfile(os.path.join(config.mPath, "model", tag, "state.pt")),
              f"{label}: no model/{tag} checkpoint")
    return trained, float(csv[-1]["epoch_time_s"]), float(csv[-1]["samples_per_s"])


def vilanro_config_run(card: str, label: str, path: str, data: str, data_dir: str, root: str,
                       total: dict, test: bool = False, profiled: bool = True):
    """One VILANRO config trained for 1 resident epoch at its full width and
    batch on ``data_dir`` (collected by ``data``'s recipe), under
    ``torch.profiler`` with ``profiled``, and with ``test`` through
    ``main(config)`` (ending in ``Trainer.test()``, its validation: VILANRO
    has no benchmark).  Counted from zero: exactly its objective calls
    (train steps + validation batches, and test()'s) times
    VILANRO_PER_OBJECTIVE and its train steps times VILANRO_PER_BACKWARD
    (both at :func:`vilanro_launch_key`), no plain version; the val loss
    falls; ``model/last`` restored through ``MultimodalVAEInfer`` gives the
    trainer's forward within RESTORE_RTOL / RESTORE_ATOL; then the launches
    per call and step.  Returns (the config, its numbers, a val batch)."""
    import yaml
    from torch.profiler import ProfilerActivity, profile
    from multimodal_vae_comparison_tpu_torch.main import main as train_main
    with open(os.path.join(HERE, path)) as f:
        mixing = yaml.safe_load(f)["mixing"]
    config, trainer, stats = config_trainer(label, path, mixing, vilanro_paths(data_dir),
                                            root, 1)
    key = vilanro_launch_key(config)
    dm, bs = trainer.datamodule, config.batch_size
    steps, val_batches = dm.n_train // bs, dm.n_val // bs
    t0 = time.perf_counter()
    staged = (trainer.stage_epoch_data(), trainer.stage_val_data())
    torch.cuda.synchronize()
    stage_s = time.perf_counter() - t0
    untrained = trainer.validate_scan(0)["val_loss"]
    torch.cuda.reset_peak_memory_stats()
    prof = {}

    def run():
        t1 = time.perf_counter()
        if profiled:
            with profile(activities=[ProfilerActivity.CUDA]) as p:
                trainer.fit(epochs=1)
                torch.cuda.synchronize()
                prof["wall_ms"] = (time.perf_counter() - t1) * 1e3
            act = device_activity(p, prof["wall_ms"])
            prof.update(busy_share=act["busy_share"], device_events=act["events"],
                        device_ms=act["ms"], top_kernels_ms={
                            n[:80]: ms for n, ms in act["ms_by_name"].most_common(6)})
        else:
            trainer.fit(epochs=1)
        if test:
            train_main(config, trainer=trainer, enable_viz=False)

    t0 = time.perf_counter()
    counted(label, key, steps + val_batches * (2 if test else 1), steps, run, total, None,
            VILANRO_TABLES)
    run_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    trained, epoch_s, samples_s = one_epoch_checks(label, config, untrained)
    if test:
        check(stats and all(k.startswith("val_") for k in stats),
              f"{label}: test() returned {stats}")
    batch = next(dm.batches("val"))
    rng = np.random.default_rng(62)
    draw = lambda: rng.standard_normal((1, bs, config.n_latents)).astype(np.float32)
    eps = {m.name: draw() for m in config.mods} if config.mixing == "moe" else draw()
    err = check_restored(label, config.mPath, trainer, batch, eps_to(eps, trainer.device))
    per_call = step_launches(label, trainer, batch, key, tables=VILANRO_TABLES,
                             phase="vilanro from config")
    types_ = [m.mod_type for m in config.mods]
    staged_bytes = sum(t.numel() * t.element_size() for split in staged
                       for mod in split.values() for t in mod.values() if t is not None)
    busy = (f" (profiled: wall {prof['wall_ms']:.1f} ms, busy {prof['busy_share']:.4f}, "
            f"{prof['device_ms']:.1f} device ms)" if profiled else "")
    print(f"vilanro from config {label} ({path}, {types_}, {config.mods[1].recon_loss} on the "
          f"actions, {[m.encoder for m in config.mods]} / {[m.decoder for m in config.mods]}): "
          f"{trainer.n_params()} parameters, {dm.n_train} train / {dm.n_val} val rows of "
          f"{data}, {steps} steps of {bs}; feature dims {dm.feature_dims()}; staged "
          f"{staged_bytes / 1e9:.3f} GB in {stage_s:.3f} s; val_loss untrained "
          f"{untrained:.2f} -> {trained:.2f}; epoch {epoch_s:.3f} s, {samples_s:.1f} "
          f"samples/s{busy}; run {run_s:.2f} s; peak memory {peak:.3f} GiB"
          + (f"; largest by device ms {json.dumps(prof['top_kernels_ms'])}" if profiled else "")
          + f" on {card}")
    numbers = {"config": path, "data": data, "params": trainer.n_params(), "steps": steps,
               "batch": bs, "feature_dims": dm.feature_dims(), "val_loss_untrained": untrained,
               "val_loss": trained, "epoch_s": epoch_s, "samples_per_s": samples_s,
               "run_s": run_s, "staged_bytes": staged_bytes, "stage_s": stage_s,
               "peak_memory_gib": peak, "restore_max_abs_err": err,
               **{f"profiled_epoch_{k}": v for k, v in prof.items()}, **per_call}
    del trainer, staged
    return config, numbers, batch


def phase_vilanro_from_config(card: str, root: str):
    """Queue A item 7b's main path: VILANRO_DATA collected by the port's
    collector, masked attention and the PoE lattice at VILANRO's shapes
    (:func:`phase_vilanro_attention`), then each config of
    VILANRO_FROM_CONFIG trained for 1 resident epoch under
    ``torch.profiler`` (:func:`vilanro_config_run`), the first ending in
    ``Trainer.test()``.  On the first run: the closed loop, the probe and a
    DAgger round (:func:`phase_vilanro_closed_loop`), and its step on the
    card against the CPU (:func:`phase_vilanro_card_vs_cpu`).  Returns
    (launches of the runs, the phase's numbers, the time rows)."""
    numbers, total = {"card": card}, {}
    dirs, numbers["collect"] = make_vilanro(os.path.join(root, "vilanro"))
    numbers["cut"] = {"epochs": 1}
    first = from_config(VILANRO_FROM_CONFIG[0][1], {}, root, eval_only=True)
    bs = first.batch_size
    decodes = (2 ** len(first.mods) - 1) * first.K * bs
    numbers["attention_parity"], rows = phase_vilanro_attention(
        card, dirs[VILANRO_FROM_CONFIG[0][2]], bs, decodes)
    for i, (label, path, data) in enumerate(VILANRO_FROM_CONFIG):
        config, numbers[label], batch = vilanro_config_run(card, label, path, data, dirs[data],
                                                           root, total, test=i == 0)
        if i == 0:
            numbers[label]["closed_loop"] = phase_vilanro_closed_loop(card, config.mPath, root,
                                                                      total)
            numbers[label]["card_vs_cpu"] = phase_vilanro_card_vs_cpu(card, path, dirs[data],
                                                                      root, batch)
    return total, numbers, rows


# -- VILANRO's conditioned second slice (ROADMAP Queue A item 7c) ---------------

# the data of the slice's 5 configs: D1way_p2 the earlier phase's, D1way_r4
# and D1way_r5 collected here by their recipes (lanro/collect.py) at a
# quarter of the recipes' 8,000 episodes, as many as the first VILANRO
# phase's (depth cut to keep the script within its time limit; the
# recipes' options and image sizes as they are)
VILANRO_COND_EPISODES = 2000
VILANRO_COND_DATA = (("D1way_r4", {"chunk_every": 5, "waypoints": True}),
                     ("D1way_r5", {"chunk_every": 5, "waypoints": True, "img_size": 128}))
# (label, config, data): 1 resident epoch each (not 300-600), the first
# profiled; the r5 run ends in test() and drives the closed loop and the probe
VILANRO_COND_FROM_CONFIG = (
    ("POE vilanro_r3_way_p2c", "configs/round3/vilanro_r3_way_p2c.yml", "D1way_p2"),
    ("MOE vilanro_r3_way_p2d", "configs/round3/vilanro_r3_way_p2d.yml", "D1way_p2"),
    ("POE vilanro_r4_cond", "configs/round4/vilanro_r4_cond.yml", "D1way_p2"),
    ("POE vilanro_r4b_spatial", "configs/round4/vilanro_r4b_spatial.yml", "D1way_r4"),
    ("POE vilanro_r5_128", "configs/round5/vilanro_r5_128.yml", "D1way_r5"))
VILANRO_COND_LOOP = "POE vilanro_r5_128"
# held card against CPU float64: per-subset conditioned decodes with the aux
# term, and MOE DReG K 5
VILANRO_COND_PARITY = ("POE vilanro_r4_cond", "MOE vilanro_r3_way_p2d")
# Dec_TransformerCond's cross-attention: d_model 128, 4 heads (head dim 32),
# 100 waypoint queries, the z key and the instruction's 4 word keys
COND_HEADS, COND_DH, COND_KEYS = 4, 32, 5


def phase_vilanro_cond_attention(card: str, data_dir: str, batch: int, lattice: int):
    """Masked attention at Dec_TransformerCond's shapes against its plain
    version, forward and the Function's backward, then timed (device ms,
    graphed) beside the plain version, SDPA under the same mask and the
    bound over the keys each row needs (:func:`attention_bound`): the one
    decode of a ``cond_always`` lattice (``lattice`` = S*K*B rows, each
    row's keys the z token and its instruction's words under their padding),
    and vilanro_r4_cond's per-subset decodes of ``batch`` rows, conditioned
    (5 keys) and not (the z token alone).  Then the PoE lattice at M 3, S 7
    over 64 latents.  Returns (parity numbers, time rows)."""
    from multimodal_vae_comparison_tpu_torch.data.datasets import VILANRO
    words = torch.from_numpy(VILANRO(os.path.join(data_dir, VILANRO_STEMS[0]), None,
                                     "language").get_data()[1][:batch]).cuda()
    check(words.shape == (batch, COND_KEYS - 1), f"instruction masks {tuple(words.shape)}")
    keep = torch.cat([torch.ones(batch, 1, dtype=torch.bool, device="cuda"), words], 1)
    cases = ((f"cond_always lattice decode S*K*B {lattice}",
              (lattice, COND_HEADS, 100, COND_KEYS, COND_DH),
              keep.repeat_interleave(lattice // batch, 0).contiguous()),
             (f"per-subset conditioned decode B {batch}",
              (batch, COND_HEADS, 100, COND_KEYS, COND_DH), keep.contiguous()),
             (f"per-subset unconditioned decode B {batch}",
              (batch, COND_HEADS, 100, 1, COND_DH), None))
    g = torch.Generator(device="cuda").manual_seed(63)
    parity, rows = {}, []
    for label, shape, mask in cases:
        parity[f"{label} {shape}"], row = attention_case(
            card, g, f"vilanro cond {label}", shape, mask,
            f"vilanro TransformerCond {label}, {shape}")
        rows.append(row)
    rows += checked_poe_rows(card, g, 3, batch, 64, "vilanro cond POE")
    return parity, rows


def checked_poe_rows(card: str, g: torch.Generator, m: int, rows_: int, d: int, label: str):
    """:func:`poe_lattice_time_rows`, each row printed and held to its plain
    version."""
    out = poe_lattice_time_rows(g, m, rows_, d, label)
    for r in out:
        print(f"time {r['name']} [{r['at']}]: kernel {r['ms']:.5f} ms, plain "
              f"{r['plain_ms']:.5f} ms, bound {r['bound_ms']:.6f} ms ({r['bound_by']}), "
              f"max_abs_err {r['max_abs_err']:.3e} on {card}")
        check(r["within_tolerance"], f"{r['name']} at {r['at']} disagrees with its plain "
              f"version: max_abs_err {r['max_abs_err']:.3e}")
    return out


def phase_vilanro_cond_from_config(card: str, root: str, collected: dict):
    """Queue A item 7c's main path: VILANRO_COND_DATA collected by the
    port's collector beside the earlier phase's D1way_p2 (``collected``,
    its collector stats), attention at Dec_TransformerCond's shapes and the
    PoE lattice at 64 latents (:func:`phase_vilanro_cond_attention`), then
    each config of VILANRO_COND_FROM_CONFIG trained for 1 resident epoch
    (:func:`vilanro_config_run`; the first profiled, VILANRO_COND_LOOP
    ending in ``Trainer.test()``).  On VILANRO_COND_LOOP's run the closed
    loop (open loop) and the probe; VILANRO_COND_PARITY's steps on the card
    against the CPU in float64.  Returns (launches of the runs, the phase's
    numbers, the time rows)."""
    numbers, total = {"card": card}, {}
    dirs, numbers["collect"] = make_vilanro(os.path.join(root, "vilanro"), VILANRO_COND_DATA,
                                            VILANRO_COND_EPISODES)
    dirs["D1way_p2"] = collected["D1way_p2"]["out_dir"]
    numbers["cut"] = {"epochs": 1, "closed_loop": "open loop only, no DAgger round",
                      "episodes": f"{VILANRO_COND_EPISODES} of the recipes' 8000"}
    first = from_config(VILANRO_COND_FROM_CONFIG[0][1], {}, root, eval_only=True)
    lattice = (2 ** len(first.mods) - 1) * first.K * first.batch_size
    numbers["attention_parity"], rows = phase_vilanro_cond_attention(
        card, dirs["D1way_p2"], first.batch_size, lattice)
    for i, (label, path, data) in enumerate(VILANRO_COND_FROM_CONFIG):
        loop = label == VILANRO_COND_LOOP
        config, numbers[label], batch = vilanro_config_run(card, label, path, data, dirs[data],
                                                           root, total, test=loop,
                                                           profiled=i == 0)
        if loop:
            numbers[label]["closed_loop"] = phase_vilanro_closed_loop(
                card, config.mPath, root, total, replans=(0,), dagger=False)
        if label in VILANRO_COND_PARITY:
            numbers[label]["card_vs_cpu"] = phase_vilanro_card_vs_cpu(
                card, path, dirs[data], root, batch, key_bias_scale=True)
    return total, numbers, rows


# -- FashionMNIST (ROADMAP Queue A item 7d's first part) -------------------------

# the two configs, 1 resident epoch each (not 200-600) on the surrogate made
# in the run at the builder's default 10,000 / 2,000 rows; the first ends in
# test() and its benchmark
FASHION_FROM_CONFIG = (("POE fashionmnist", "configs/config_fashionmnist.yml"),
                       ("POE fashionmnist_r2", "configs/round2/fashionmnist_r2.yml"))
# an objective call launches the PoE lattice once (M 2, S 3) and no attention;
# a backward its backward once
FASHION_PER_OBJECTIVE = {"poe": {"poe": 1}}
FASHION_PER_BACKWARD = {"poe": {"poe_bwd": 1}}
FASHION_TABLES = (FASHION_PER_OBJECTIVE, FASHION_PER_BACKWARD)
# the benchmark's forwards: the latent probe's (both modalities) and the two
# cross-generations, a PoE launch each; the joint generation decodes only
FASHION_EVAL_LAUNCHES = {"poe": 3}


def phase_fashionmnist_from_config(card: str, root: str):
    """FashionMNIST's main path: the surrogate built in the run by the
    port's builder at its default 10,000 / 2,000 rows, then each config of
    FASHION_FROM_CONFIG trained for 1 resident epoch at its batch, the
    first through ``main(config)``, ending in ``Trainer.test()`` and the
    benchmark (its judge trained on the card at first use).  Each run is
    counted from zero: exactly its objective calls times
    FASHION_PER_OBJECTIVE, its train steps times FASHION_PER_BACKWARD and
    the benchmark's FASHION_EVAL_LAUNCHES, no plain version; the val loss
    falls; the restored forward is within RESTORE_RTOL / RESTORE_ATOL; the
    5 stats lie in [0, 1].  Then the PoE lattice at both configs' shapes.
    Returns (launches of the runs, the phase's numbers, the time rows)."""
    from multimodal_vae_comparison_tpu_torch.data_proc.surrogates import build_fashionmnist
    from multimodal_vae_comparison_tpu_torch.eval.eval_fashionmnist import STATS_KEYS
    from multimodal_vae_comparison_tpu_torch.main import main as train_main
    numbers, total = {"card": card, "cut": {"epochs": 1}}, {}
    t0 = time.perf_counter()
    data_dir = build_fashionmnist(os.path.join(root, "fashionmnist"))
    numbers["build_s"] = time.perf_counter() - t0
    judges = os.environ.get("FASHIONMNIST_CLASSIFIER_DIR")
    os.environ["FASHIONMNIST_CLASSIFIER_DIR"] = os.path.join(root, "fashion_judges")
    try:
        for i, (label, path) in enumerate(FASHION_FROM_CONFIG):
            paths = {"path": data_dir}
            if i:   # round2 names its test split; config_fashionmnist none
                paths["test_datapath"] = os.path.join(data_dir, "test")
            config, trainer, stats = config_trainer(label, path, "poe", {
                "modality_1": paths, "modality_2": paths}, root, 1)
            dm, bs = trainer.datamodule, config.batch_size
            steps, val_batches = dm.n_train // bs, dm.n_val // bs
            untrained = trainer.validate_scan(0)["val_loss"]
            torch.cuda.reset_peak_memory_stats()

            def run(trainer=trainer, config=config, test=i == 0):
                trainer.fit(epochs=1)
                if test:
                    train_main(config, trainer=trainer, enable_viz=False)

            t0 = time.perf_counter()
            counted(label, "poe", steps + val_batches * (2 if i == 0 else 1), steps, run, total,
                    FASHION_EVAL_LAUNCHES if i == 0 else None, FASHION_TABLES)
            run_s = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            trained, epoch_s, samples_s = one_epoch_checks(label, config, untrained)
            if i == 0:
                check(all(k in stats and 0.0 <= stats[k] <= 1.0 for k in STATS_KEYS),
                      f"{label}: test() returned {stats}")
                check(os.path.isfile(os.path.join(config.mPath, "fashionmnist_stats.txt")),
                      f"{label}: no fashionmnist_stats.txt")
            batch = next(dm.batches("val"))
            eps = np.random.default_rng(64).standard_normal(
                (1, bs, config.n_latents)).astype(np.float32)
            err = check_restored(label, config.mPath, trainer, batch, eps_to(eps, trainer.device))
            per_call = step_launches(label, trainer, batch, "poe", tables=FASHION_TABLES,
                                     phase="fashionmnist from config")
            print(f"fashionmnist from config {label} ({path}): {trainer.n_params()} "
                  f"parameters, {dm.n_train} train / {dm.n_val} val rows, {steps} steps of "
                  f"{bs}; val_loss untrained {untrained:.2f} -> {trained:.2f}; epoch "
                  f"{epoch_s:.3f} s, {samples_s:.1f} samples/s; run {run_s:.2f} s; peak "
                  f"memory {peak:.3f} GiB"
                  + (f"; stats {json.dumps({k: stats[k] for k in STATS_KEYS})}" if i == 0
                     else "") + f" on {card}")
            numbers[label] = {"config": path, "params": trainer.n_params(), "steps": steps,
                              "batch": bs, "val_loss_untrained": untrained,
                              "val_loss": trained, "epoch_s": epoch_s,
                              "samples_per_s": samples_s, "run_s": run_s,
                              "peak_memory_gib": peak, "restore_max_abs_err": err,
                              **({"stats": {k: stats[k] for k in STATS_KEYS}} if i == 0
                                 else {}), **per_call}
            del trainer
    finally:
        if judges is None:
            os.environ.pop("FASHIONMNIST_CLASSIFIER_DIR", None)
        else:
            os.environ["FASHIONMNIST_CLASSIFIER_DIR"] = judges
    g = torch.Generator(device="cuda").manual_seed(65)
    rows = []
    for label, path in FASHION_FROM_CONFIG:
        cfg = from_config(path, {}, root, eval_only=True)
        rows += checked_poe_rows(card, g, 2, cfg.batch_size, cfg.n_latents,
                                 f"fashionmnist POE ({label})")
    return total, numbers, rows


# -- MNIST-SVHN and PolyMNIST (ROADMAP Queue A item 7d) ---------------------------

# the four configs, 1 resident epoch each (not 150-600) on the surrogates
# made in the run at the builders' defaults (MNIST-SVHN pairs 20 / 5,
# PolyMNIST 10,000 / 2,000 rows); each first one ends in test() and its
# benchmark: (label, config, launch key, paths key)
DIGITS_FROM_CONFIG = (
    ("MOE mnistsvhn", "configs/config_mnistsvhn.yml", "moe_dreg", "mnistsvhn_pt"),
    ("MOE mnistsvhn_r2", "configs/round2/config_mnistsvhn_r2.yml", "moe_dreg", "mnistsvhn"),
    ("POE polymnist", "configs/config_polymnist.yml", "poe", "polymnist_pt"),
    ("MoPoE polymnist_r2_mopoe", "configs/round2/polymnist_r2_mopoe.yml", "mopoe", "polymnist"))
DIGITS_TEST = ("MOE mnistsvhn", "POE polymnist")
# MNIST-SVHN (MOE, DReG, Laplace posteriors) launches no kernel: DReG takes
# no KL, the KL kernel is for Gaussian posteriors, and there is no attention
# or PoE; PolyMNIST's POE and MoPoE launch the PoE lattice once a call (M 5,
# all 31 subsets; MoPoE's full set with the prior expert) and its backward
# once a step
DIGITS_PER_OBJECTIVE = {"moe_dreg": {}, "poe": {"poe": 1}, "mopoe": {"poe": 1}}
DIGITS_PER_BACKWARD = {"moe_dreg": {}, "poe": {"poe_bwd": 1}, "mopoe": {"poe_bwd": 1}}
DIGITS_TABLES = (DIGITS_PER_OBJECTIVE, DIGITS_PER_BACKWARD)
# the benchmarks' forwards: the latent probe's (every modality) and one
# cross-generation per modality, a PoE launch each on PolyMNIST; the joint
# generation decodes only
DIGITS_EVAL_LAUNCHES = {"moe_dreg": {}, "poe": {"poe": 6}, "mopoe": {"poe": 6}}
# the card against the CPU in float64 at this batch: (label, config)
DIGITS_PARITY = (("MOE mnistsvhn", "configs/config_mnistsvhn.yml"),
                 ("MoPoE polymnist_r2_mopoe", "configs/round2/polymnist_r2_mopoe.yml"))
DIGITS_PARITY_BATCH = 4
# the stats of each benchmark: MNIST-SVHN's 6 and PolyMNIST's 24 (3 summary
# stats, the 20 ordered pairs, joint coherence)
DIGITS_STATS = {"MOE mnistsvhn": 6, "POE polymnist": 24}


# PolyMNIST's train and test rows: its test rows at the builder's default,
# its train rows cut from 10,000 to keep the script within its time limit
POLYMNIST_COUNTS = (4000, 2000)


def make_digits(root: str):
    """MNIST-SVHN through the port's builder at its defaults and PolyMNIST at
    POLYMNIST_COUNTS, and
    the ``.pt`` files ``config_mnistsvhn.yml`` and ``config_polymnist.yml``
    name (``torch.save`` of the builders' arrays): ({paths key: the
    modalities' data paths}, seconds of each build)."""
    from multimodal_vae_comparison_tpu_torch.data_proc import mnistsvhn, polymnist
    seconds = {}
    t0 = time.perf_counter()
    ms = mnistsvhn.build_surrogate(os.path.join(root, "mnist_svhn"))
    seconds["mnistsvhn"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    pm = polymnist.build_surrogate(os.path.join(root, "polymnist"), *POLYMNIST_COUNTS)
    seconds["polymnist"] = time.perf_counter() - t0
    paths = {"mnistsvhn": {}, "mnistsvhn_pt": {}, "polymnist": {}, "polymnist_pt": {}}
    for i, m in enumerate(("mnist", "svhn")):
        key = f"modality_{i + 1}"
        paths["mnistsvhn"][key] = {"path": os.path.join(ms, f"{m}_idx_train.npy"),
                                   "test_datapath": os.path.join(ms, f"{m}_idx_test.npy")}
        pt = os.path.join(ms, f"train-ms-{m}-idx.pt")
        torch.save(torch.from_numpy(np.load(paths["mnistsvhn"][key]["path"])), pt)
        paths["mnistsvhn_pt"][key] = {"path": pt}
    for i in range(5):
        key = f"modality_{i + 1}"
        paths["polymnist"][key] = {"path": os.path.join(pm, f"m{i}.npy"),
                                   "test_datapath": os.path.join(pm, f"test_m{i}.npy")}
        pt = os.path.join(pm, f"m{i}.pt")
        torch.save(torch.from_numpy(np.load(paths["polymnist"][key]["path"])), pt)
        paths["polymnist_pt"][key] = {"path": pt}
    return paths, seconds


def digits_eps(rng: np.random.Generator, config, mixing: str, k: int, n: int):
    """Draws in the form the config's forward (and MOE's and MoPoE's
    objective) takes: MOE's Laplace posteriors a uniform (k, n, D) draw per
    modality in the open interval of their sampler, the joint of POE and
    MoPoE one standard-normal (k, n, D) draw."""
    from multimodal_vae_comparison_tpu_torch.models.distributions import Laplace
    shape = (k, n, config.n_latents)
    if mixing == "moe":
        return {m.name: rng.uniform(Laplace.U_LOW, Laplace.U_HIGH, shape).astype(np.float32)
                for m in config.mods}
    return rng.standard_normal(shape).astype(np.float32)


def card_vs_cpu_step(card: str, phase: str, label: str, cfg, rows: dict, eps, key: str,
                     tables, grad_rel: float = GRAD_REL) -> dict:
    """One objective and its backward of ``cfg``'s model at its widths and K
    on the numpy ``rows`` and draws ``eps`` (an array, a list or a dict of
    arrays): the card (kernels, fp32, TF32 off) against the CPU's plain
    path in float64 on the card's relu branches and DReG importance weights
    (:func:`same_branches`, :func:`same_dreg_weights`): loss and metrics
    within TRAIN_RTOL, every gradient within ``grad_rel`` (GRAD_REL unless
    given) x its leaf's max |g| + GRAD_ATOL; the card launches exactly one
    objective call's and one backward's kernels (``tables`` at ``key``) and
    no plain version."""
    from multimodal_vae_comparison_tpu_torch.ops.kernels import telemetry
    from multimodal_vae_comparison_tpu_torch.training.trainer import build_model_from_config
    branches, weights, out, moved, seconds = [], [], {}, {}, {}
    for dev, dtype in (("cuda", torch.float32), ("cpu", torch.float64)):
        model = build_model_from_config(cfg, device=dev).to(dtype)
        tb = {k: {"data": v["data"].to(dtype), "masks": v["masks"]}
              for k, v in torch_batch(rows, dev).items()}
        dev_eps = eps_to(eps, dev)
        dev_eps = ({k: v.to(dtype) for k, v in dev_eps.items()} if isinstance(dev_eps, dict)
                   else [e.to(dtype) for e in dev_eps] if isinstance(dev_eps, list)
                   else dev_eps.to(dtype))
        telemetry.reset()
        t0 = time.perf_counter()
        with same_branches(branches, dev == "cpu", moved), \
                same_dreg_weights(weights, dev == "cpu", moved):
            out[dev] = _objective_grads(model, tb, dev_eps)
        seconds[dev] = time.perf_counter() - t0
        if dev == "cuda":
            launches, dispatch = telemetry.launches(), telemetry.summary()
        del model
    want = expected_launches(key, 1, 1, tables)
    (gl, gm, gg), (cl, cm, cg) = out["cuda"], out["cpu"]
    worst, worst_name = _worst_leaf(gg, {k: v.float() for k, v in cg.items()}, grad_rel,
                                    GRAD_ATOL)
    n = len(next(iter(rows.values()))["data"])
    print(f"{phase} card vs CPU {label} (bs {n}, K {cfg.K}): loss cuda {gl:.6f}, cpu "
          "float64 {:.6f}; metrics ".format(cl)
          + ", ".join(f"{k} {gm[k]:.6f}/{cm[k]:.6f}" for k in sorted(gm))
          + f"; worst gradient leaf {worst:.3f} of its limit at {worst_name} (limit "
          f"{grad_rel} x max|g| + {GRAD_ATOL}); relu branches and DReG weights replayed on "
          f"the CPU: {moved}; launches {launches}, expected {want}; dispatch {dispatch}; "
          f"{seconds['cuda']:.3f} s on the card, {seconds['cpu']:.3f} s on the CPU ({card})")
    check(launches == want, f"{label} card vs CPU: launched {launches}, expected {want}")
    check(not any(k.endswith(":plain") for k in dispatch),
          f"{label} card vs CPU: a plain version ran on the card: {dispatch}")
    check(np.isfinite(gl) and abs(gl - cl) <= TRAIN_RTOL * abs(cl),
          f"{label} card vs CPU: loss {gl} on the card vs {cl} on the CPU")
    check(sorted(gm) == sorted(cm), f"{label} card vs CPU: metric keys differ")
    for k in gm:
        check(abs(gm[k] - cm[k]) <= TRAIN_RTOL * abs(cm[k]) + 1e-4,
              f"{label} card vs CPU: metric {k} {gm[k]} on the card vs {cm[k]} on the CPU")
    check(worst <= 1.0, f"{label} card vs CPU: gradient of {worst_name} differs")
    return {"loss_cuda": gl, "loss_cpu64": cl, "worst_grad_share_of_limit_vs_cpu64": worst,
            "worst_leaf_vs_cpu64": worst_name, "replayed": moved, "launches": launches,
            "card_s": seconds["cuda"], "cpu64_s": seconds["cpu"]}


def phase_digits_card_vs_cpu(card: str, label: str, path: str, paths: dict, root: str, key: str,
                             batch) -> dict:
    """:func:`card_vs_cpu_step` of ``path`` on DIGITS_PARITY_BATCH rows of
    ``batch`` and drawn eps (DIGITS_TABLES at ``key``: no launch for
    MNIST-SVHN)."""
    n = DIGITS_PARITY_BATCH
    rows = {k: {"data": v["data"][:n], "masks": None} for k, v in batch.items()}
    cfg = from_config(path, paths, root, eval_only=True)
    for i, mod in enumerate(cfg.mods):
        mod.feature_dims = list(rows[f"mod_{i + 1}"]["data"].shape[1:])
    eps = digits_eps(np.random.default_rng(66), cfg, cfg.mixing, cfg.K, n)
    return card_vs_cpu_step(card, "digits", label, cfg, rows, eps, key, DIGITS_TABLES)


def phase_digits_from_config(card: str, root: str):
    """Queue A item 7d's main path: both surrogates built in the run by the
    port's builders (:func:`make_digits`), then each config of
    DIGITS_FROM_CONFIG trained for 1 resident epoch at its batch and K, at
    full width, the DIGITS_TEST ones through ``main(config)``, ending in
    ``Trainer.test()`` and the dataset's benchmark (its judges trained on
    the card at first use).  Each run is counted from zero: exactly its
    objective calls times DIGITS_PER_OBJECTIVE, its train steps times
    DIGITS_PER_BACKWARD and the benchmark's DIGITS_EVAL_LAUNCHES (nothing
    at all on MNIST-SVHN), no plain version; the val loss falls; the
    restored forward is within RESTORE_RTOL / RESTORE_ATOL; the stats lie
    in [0, 1].  DIGITS_PARITY's steps on the card against the CPU in
    float64, then the PoE lattice at M 5 at both PolyMNIST configs'
    shapes.  Returns (launches of the runs, the phase's numbers, the time
    rows)."""
    from multimodal_vae_comparison_tpu_torch.main import main as train_main
    numbers, total = {"card": card, "cut": {"epochs": 1}}, {}
    paths, numbers["build_s"] = make_digits(os.path.join(root, "digits"))
    saved = {k: os.environ.get(k) for k in ("MNISTSVHN_CLASSIFIER_DIR",
                                            "POLYMNIST_CLASSIFIER_DIR")}
    for k in saved:
        os.environ[k] = os.path.join(root, k.split("_")[0].lower() + "_judges")
    parity = dict(DIGITS_PARITY)
    try:
        for label, path, key, data in DIGITS_FROM_CONFIG:
            test = label in DIGITS_TEST
            mixing = key.split("_")[0]
            config, trainer, stats = config_trainer(label, path, mixing, paths[data], root, 1)
            dm, bs = trainer.datamodule, config.batch_size
            steps, val_batches = dm.n_train // bs, dm.n_val // bs
            untrained = trainer.validate_scan(0)["val_loss"]
            torch.cuda.reset_peak_memory_stats()

            def run(trainer=trainer, config=config, test=test):
                trainer.fit(epochs=1)
                if test:
                    train_main(config, trainer=trainer, enable_viz=False)

            t0 = time.perf_counter()
            counted(label, key, steps + val_batches * (2 if test else 1), steps, run, total,
                    DIGITS_EVAL_LAUNCHES[key] if test else None, DIGITS_TABLES)
            run_s = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            trained, epoch_s, samples_s = one_epoch_checks(label, config, untrained)
            if test:
                # test()'s validation, then the benchmark's stats
                stats = {k: v for k, v in stats.items() if not k.startswith("val_")}
                check(len(stats) == DIGITS_STATS[label] and all(
                    isinstance(v, float) and 0.0 <= v <= 1.0 for v in stats.values()),
                      f"{label}: test() returned {stats}")
                name = "mnist_svhn" if mixing == "moe" else "polymnist"
                check(os.path.isfile(os.path.join(config.mPath, f"{name}_stats.txt")),
                      f"{label}: no {name}_stats.txt")
            batch = next(dm.batches("val"))
            eps = digits_eps(np.random.default_rng(64), config, mixing, 1, bs)
            err = check_restored(label, config.mPath, trainer, batch, eps_to(eps, trainer.device))
            per_call = step_launches(label, trainer, batch, key, tables=DIGITS_TABLES,
                                     phase="digits from config")
            print(f"digits from config {label} ({path}): {trainer.n_params()} parameters, "
                  f"{dm.n_train} train / {dm.n_val} val rows, {steps} steps of {bs} at K "
                  f"{config.K}; val_loss untrained {untrained:.2f} -> {trained:.2f}; epoch "
                  f"{epoch_s:.3f} s, {samples_s:.1f} samples/s; run {run_s:.2f} s; peak "
                  f"memory {peak:.3f} GiB"
                  + (f"; stats {json.dumps(stats)}" if test else "") + f" on {card}")
            numbers[label] = {"config": path, "params": trainer.n_params(), "steps": steps,
                              "batch": bs, "K": config.K, "val_loss_untrained": untrained,
                              "val_loss": trained, "epoch_s": epoch_s,
                              "samples_per_s": samples_s, "run_s": run_s,
                              "peak_memory_gib": peak, "restore_max_abs_err": err,
                              **({"stats": stats} if test else {}), **per_call}
            if label in parity:
                numbers[label]["card_vs_cpu"] = phase_digits_card_vs_cpu(
                    card, label, parity[label], paths[data], root, key, batch)
            del trainer
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    g = torch.Generator(device="cuda").manual_seed(67)
    rows = []
    for label, path, key, _ in DIGITS_FROM_CONFIG:
        if key != "moe_dreg":
            cfg = from_config(path, {}, root, eval_only=True)
            rows += checked_poe_rows(card, g, 5, cfg.batch_size, cfg.n_latents,
                                     f"digits {label}")
    return total, numbers, rows

# -- the rest of the model zoo (ROADMAP Queue A items 11 and 3) -------------------------


def _drop(block: str):
    """A config edit that removes the ``block`` modality (a one-modality
    config, which builds the unimodal VAE)."""
    return lambda p: p.pop(block)


def _nets(**mods):
    """A config edit setting each named modality's (encoder, decoder)."""
    def edit(p):
        for key, (enc, dec) in mods.items():
            p[key].update(encoder=enc, decoder=dec)
    return edit


def _gumbel_text(p):
    """The text modality alone under ``prior: gumbel``: 54 latents, two
    categoricals of the alphabet's 27 classes."""
    p.pop("modality_1")
    p["modality_2"]["prior"] = "gumbel"
    p["n_latents"] = 54


# (label, base config, launch key, data, config edit, overrides): each
# trained 1 resident epoch at the classes' default widths (not 150-400)
ZOO_REST_FROM_CONFIG = (
    ("VAE cdsprites image elbo", "configs/config_cdspritesplus.yml", "vae_elbo", "cdsprites",
     _drop("modality_2"), {"obj": "elbo"}),
    ("VAE cdsprites image dreg", "configs/config_cdspritesplus.yml", "vae_dreg", "cdsprites",
     _drop("modality_2"), {"obj": "dreg", "K": 10}),
    ("VAE cdsprites text gumbel", "configs/config_cdspritesplus.yml", "vae_gumbel",
     "cdsprites", _gumbel_text, {"obj": "elbo"}),
    ("POE cdl1 VIT TxtRNN", "configs/round5/cdl1_r5_poe.yml", "poe_vit", "cdsprites",
     _nets(modality_1=("VIT", "CNN"), modality_2=("TxtRNN", "ConvTxt")), {}),
    ("POE cdl1 RESCNN ConvTxt", "configs/round5/cdl1_r5_poe.yml", "poe", "cdsprites",
     _nets(modality_1=("RESCNN", "RESCNN"), modality_2=("ConvTxt", "ConvTxt")), {}),
    ("POE sprites TransformerIMG", "configs/config_sprites.yml", "poe_sprites", "sprites",
     _nets(modality_1=("TransformerIMG", "TransformerIMG")), {}))
# the unimodal image ELBO ends in test(): the CdSprites+ benchmark needs
# both modalities and raises, in the JAX package too, which test() records
ZOO_REST_TEST = "VAE cdsprites image elbo"
ZOO_REST_EVAL_ERROR = "KeyError: 'mod_2'"
# a call's launches: the unimodal ELBO's KL through the KL kernel (M 1), no
# kernel under DReG, the gumbel text nets' attention (encoder, decoder);
# POE's lattice, with the ViT's 6 layers of attention, or TransformerIMG's
# 4 encoder and 4 decoder layers (every subset decoded in one call)
ZOO_REST_PER_OBJECTIVE = {"vae_elbo": {"kl": 1}, "vae_dreg": {}, "vae_gumbel": {"attention": 2},
                          "poe_vit": {"attention": 6, "poe": 1}, "poe": {"poe": 1},
                          "poe_sprites": {"attention": 8, "poe": 1}}
ZOO_REST_PER_BACKWARD = {"vae_elbo": {"kl_bwd": 1}, "vae_dreg": {}, "vae_gumbel": {},
                         "poe_vit": {"poe_bwd": 1}, "poe": {"poe_bwd": 1},
                         "poe_sprites": {"poe_bwd": 1}}
ZOO_REST_TABLES = (ZOO_REST_PER_OBJECTIVE, ZOO_REST_PER_BACKWARD)
ZOO_REST_PARITY_BATCH = 4


def zoo_rest_edit(edit, fixed: dict):
    """The config edit of a ZOO_REST_FROM_CONFIG part: ``edit``, then the
    ``fixed`` top-level values."""
    def apply(params):
        edit(params)
        params.update(fixed)
    return apply


def zoo_rest_config(label: str, data_paths: dict, root: str, eval_only=False, **over):
    """The Config of ZOO_REST_FROM_CONFIG's ``label`` on ``data_paths``."""
    _, path, _, _, edit, fixed = next(p for p in ZOO_REST_FROM_CONFIG if p[0] == label)
    return from_config(path, data_paths, root, eval_only=eval_only,
                       edit=zoo_rest_edit(edit, fixed), **over)


def zoo_rest_eps(rng: np.random.Generator, cfg, n: int):
    """Draws in the form the config's objective takes: the unimodal VAE one
    standard-normal (K, n, D) draw, or on its gumbel path the (K, n,
    groups, cats) Gumbel noise; POE one (K, n, D) draw per subset."""
    K, D, first = cfg.K, cfg.n_latents, cfg.mods[0]
    if len(cfg.mods) > 1:
        return [rng.standard_normal((K, n, D)).astype(np.float32)
                for _ in range(2 ** len(cfg.mods) - 1)]
    if _gumbel(cfg):
        cats = int(first.feature_dims[1])
        u = rng.uniform(np.finfo(np.float32).tiny, 1.0, (K, n, D // cats, cats))
        return (-np.log(-np.log(u))).astype(np.float32)
    return rng.standard_normal((K, n, D)).astype(np.float32)


def _gumbel(cfg) -> bool:
    """Whether a one-modality config trains the unimodal VAE's gumbel path."""
    return len(cfg.mods) == 1 and (cfg.obj == "elbo_gumbel" or cfg.mods[0].prior == "gumbel")


def phase_zoo_rest_card_vs_cpu(card: str, label: str, paths: dict, root: str, key: str,
                               batch) -> dict:
    """:func:`card_vs_cpu_step` of ``label``'s config on
    ZOO_REST_PARITY_BATCH rows of ``batch`` and drawn noise
    (ZOO_REST_TABLES at ``key``)."""
    n = ZOO_REST_PARITY_BATCH
    rows = {k: {"data": v["data"][:n], "masks": None if v.get("masks") is None
                else v["masks"][:n]} for k, v in batch.items()}
    cfg = zoo_rest_config(label, paths, root, eval_only=True)
    for i, mod in enumerate(cfg.mods):
        mod.feature_dims = list(rows[f"mod_{i + 1}"]["data"].shape[1:])
    eps = zoo_rest_eps(np.random.default_rng(71), cfg, n)
    return card_vs_cpu_step(card, "zoo remainder", label, cfg, rows, eps, key,
                            ZOO_REST_TABLES)


def kl_m1_rows(card: str, g: torch.Generator, b: int, d: int, label: str):
    """The KL kernel at M 1, the unimodal ELBO's call, at (b, d): forward
    and backward on the card against the plain versions, then timed
    (graphed) beside them and the library's KL, with their bounds."""
    from torch.distributions import Normal
    from torch.distributions.kl import kl_divergence
    from multimodal_vae_comparison_tpu_torch.ops.kernels import kl_kernel
    mu = torch.randn((b, d), generator=g, device="cuda")
    scale = torch.rand((b, d), generator=g, device="cuda") + 0.1
    up = torch.randn((1, b), generator=g, device="cuda")
    unit = Normal(torch.zeros((), device="cuda"), torch.ones((), device="cuda"),
                  validate_args=False)

    def fwd():
        return kl_kernel.kl_normal_std_fused(mu, scale)

    def bwd():
        return kl_kernel._launch_backward([mu], [scale], up)

    def plain_bwd():
        return up[0][:, None] * mu, up[0][:, None] * (scale - 1.0 / scale)

    def library():
        return kl_divergence(Normal(mu, scale, validate_args=False), unit).sum(-1)

    err_fwd = (fwd() - kl_kernel.kl_reference(mu, scale)).abs().max().item()
    (d_mu,), (d_scale,) = bwd()
    want_mu, want_scale = plain_bwd()
    err_bwd = max((d_mu - want_mu).abs().max().item(),
                  (d_scale - want_scale).abs().max().item())
    check(err_fwd <= KL_ATOL + KL_RTOL * kl_kernel.kl_reference(mu, scale).abs().max().item()
          and torch.allclose(d_mu, want_mu, rtol=KL_RTOL, atol=KL_ATOL)
          and torch.allclose(d_scale, want_scale, rtol=KL_RTOL, atol=KL_ATOL),
          f"the KL kernel at M 1 ({b}, {d}) disagrees with its plain version: "
          f"{err_fwd:.3e} forward, {err_bwd:.3e} backward")
    n = b * d
    fb, bb = bound_ms(4 * (2 * n + b), 8 * n), bound_ms(4 * (2 * n + b + 2 * n), 4 * n)
    at = f"M=1 ({b}, {d}) [{label}]"
    common = {"route": "cuda", "at": at,
              "source": "multimodal_vae_comparison_tpu_torch/csrc/kl.cu"}
    ref = "multimodal_vae_comparison_tpu/ops/pallas/kl_kernel.py"
    rows = [{"name": "kl_normal_std_multi", **common, "replaces": f"{ref}:30",
             "max_abs_err": err_fwd, "ms": graph_ms(fwd),
             "plain_ms": graph_ms(lambda: kl_kernel.kl_reference(mu, scale)),
             "bound_ms": fb[0], "bound_by": fb[1], "library_ms": graph_ms(library),
             "library_is": "torch.distributions.kl.kl_divergence(Normal(mu, scale), "
                           "Normal(0, 1)).sum(-1), validate_args=False, graphed"},
            {"name": "kl_normal_std_multi_backward", **common,
             "replaces": f"{ref}:72 (_kl_bwd, the VJP of :30)", "max_abs_err": err_bwd,
             "ms": graph_ms(bwd), "plain_ms": graph_ms(plain_bwd), "bound_ms": bb[0],
             "bound_by": bb[1], "library_ms": None,
             "library_is": "none: no single PyTorch call gives (g mu, g (scale - 1/scale))"}]
    for r in rows:
        print(f"time {r['name']} [{at}]: kernel {r['ms']:.5f} ms, plain {r['plain_ms']:.5f} "
              f"ms" + (f", library {r['library_ms']:.5f} ms" if r["library_ms"] else "")
              + f", bound {r['bound_ms']:.7f} ms ({r['bound_by']}), max_abs_err "
              f"{r['max_abs_err']:.3e} on {card}")
    return rows


def phase_zoo_rest_attention(card: str, vit_batch: int, clip_batch: int, frames: int,
                             subsets: int):
    """Masked attention at the new nets' shapes, on the kernel its route
    gives each (the fp32 tensor-core kernel, the few-keys kernel) against
    its plain version (forward and backward), timed beside the
    plain version, SDPA on the same mask and the bound over the keys each
    row needs: the ViT's (B, 8, 17, 17, 32) without a mask,
    Enc_TransformerIMG's (B, 4, T, T, 64) under a partly padded frame mask
    and Dec_TransformerIMG's cross-attention (S B, 4, T, 1, 64) to the z
    token.  Returns (parity numbers, time rows)."""
    g = torch.Generator(device="cuda").manual_seed(72)
    lengths = torch.randint(1, frames + 1, (clip_batch, 1), generator=g, device="cuda")
    lengths[0] = frames
    frame_mask = (torch.arange(frames, device="cuda")[None, :] < lengths).contiguous()
    # the ViT: width 256 over 8 heads; TransformerIMG: d_model 256 over 4
    cases = (("Enc_VIT", (vit_batch, 8, 17, 17, 32), None),
             ("Enc_TransformerIMG", (clip_batch, 4, frames, frames, 64), frame_mask),
             ("Dec_TransformerIMG", (subsets * clip_batch, 4, frames, 1, 64), None))
    parity, rows = {}, []
    for label, shape, mask in cases:
        parity[label], row = attention_case(card, g, label, shape, mask,
                                            f"{label} {tuple(shape)}")
        rows.append(row)
    return parity, rows


def config_mixing(path: str) -> str:
    """The ``mixing`` a shipped YAML names."""
    import yaml
    with open(os.path.join(HERE, path)) as f:
        return yaml.safe_load(f)["mixing"]


def phase_zoo_rest_from_config(card: str, root: str, data, sprites_dir: str):
    """Queue A items 11 and 3's main path: each config of
    ZOO_REST_FROM_CONFIG, a shipped YAML with the unported nets swapped in
    or one modality removed, trained for 1 resident epoch at the classes'
    default widths on the CdSprites+ level 1 rows and the SPRITES clips
    made earlier in the run (``data``, ``sprites_dir``), ZOO_REST_TEST
    ending in ``Trainer.test()``, whose ``eval_error`` must be the
    benchmark's refusal of one modality.  Each run is counted from zero:
    exactly its objective calls times ZOO_REST_PER_OBJECTIVE and its train
    steps times ZOO_REST_PER_BACKWARD, no plain version; the val loss
    falls; ``model/last`` restored gives the trainer's forward; one step
    on the card against the CPU in float64.  Then the attention kernel at
    the new nets' shapes and the KL kernel at M 1.  Returns (launches of
    the runs, the phase's numbers, the time rows)."""
    numbers, total = {"card": card, "cut": {"epochs": 1}}, {}
    data_paths = {"cdsprites": cdsprites_paths(data), "sprites": sprites_paths(sprites_dir)}
    saved = os.environ.get("CDSPRITES_CLASSIFIER_DIR")
    os.environ["CDSPRITES_CLASSIFIER_DIR"] = os.path.join(root, "judges")
    try:
        for label, path, key, data_key, edit, fixed in ZOO_REST_FROM_CONFIG:
            test = label == ZOO_REST_TEST
            paths = data_paths[data_key]
            config, trainer, stats = config_trainer(label, path, config_mixing(path), paths,
                                                    root, 1, edit=zoo_rest_edit(edit, fixed))
            for k, v in fixed.items():
                check(getattr(config, k) == v, f"{label}: {k} is {getattr(config, k)}")
            model = trainer.model
            uni = type(model).__name__ == "UnimodalVAE"
            check(uni == key.startswith("vae"), f"{label}: built {type(model).__name__}")
            dm, bs = trainer.datamodule, config.batch_size
            steps, val_batches = dm.n_train // bs, dm.n_val // bs
            untrained = trainer.validate_scan(0)["val_loss"]
            torch.cuda.reset_peak_memory_stats()

            def run(trainer=trainer, test=test):
                trainer.fit(epochs=1, log_fn=None)
                if test:
                    trainer.test()

            t0 = time.perf_counter()
            counted(label, key, steps + val_batches * (2 if test else 1), steps, run, total,
                    None, ZOO_REST_TABLES)
            run_s = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            trained, epoch_s, samples_s = one_epoch_checks(label, config, untrained)
            if test:
                check(stats.get("eval_error") == ZOO_REST_EVAL_ERROR,
                      f"{label}: test() gave eval_error {stats.get('eval_error')!r}, "
                      f"expected {ZOO_REST_EVAL_ERROR!r}")
            batch = next(dm.batches("val"))
            # one sample, as the restored model draws: the posterior's, or POE's joint
            eps = zoo_rest_eps(np.random.default_rng(70), config, bs)
            eps = eps_to(eps[:1] if uni else eps[0][:1], trainer.device)
            gumbel = (lambda m, b, e: m._gumbel_forward(b, eps=e)) if _gumbel(config) else None
            err = check_restored(label, config.mPath, trainer, batch, eps, forward=gumbel)
            per_call = step_launches(label, trainer, batch, key, tables=ZOO_REST_TABLES,
                                     phase="zoo remainder from config")
            print(f"zoo remainder from config {label} ({path}, {type(model).__name__}, "
                  + ", ".join(f"{s.name} {s.encoder}/{s.decoder}" for s in model.specs)
                  + f"): {trainer.n_params()} parameters, {dm.n_train} train / {dm.n_val} "
                  f"val rows, {steps} steps of {bs} at K {config.K}; val_loss untrained "
                  f"{untrained:.2f} -> {trained:.2f}; epoch {epoch_s:.3f} s, {samples_s:.1f} "
                  f"samples/s; run {run_s:.2f} s; peak memory {peak:.3f} GiB"
                  + (f"; test() eval_error {stats.get('eval_error')!r}" if test else "")
                  + f" on {card}")
            numbers[label] = {"config": path, "model": type(model).__name__,
                              "nets": {s.name: [s.encoder, s.decoder] for s in model.specs},
                              "params": trainer.n_params(), "steps": steps, "batch": bs,
                              "K": config.K, "val_loss_untrained": untrained,
                              "val_loss": trained, "epoch_s": epoch_s,
                              "samples_per_s": samples_s, "run_s": run_s,
                              "peak_memory_gib": peak, "restore_max_abs_err": err,
                              **({"eval_error": stats.get("eval_error")} if test else {}),
                              **per_call}
            numbers[label]["card_vs_cpu"] = phase_zoo_rest_card_vs_cpu(
                card, label, paths, root, key, batch)
            del trainer, model
    finally:
        if saved is None:
            os.environ.pop("CDSPRITES_CLASSIFIER_DIR", None)
        else:
            os.environ["CDSPRITES_CLASSIFIER_DIR"] = saved
    vit = zoo_rest_config("POE cdl1 VIT TxtRNN", {}, root, eval_only=True)
    clip = zoo_rest_config("POE sprites TransformerIMG", {}, root, eval_only=True)
    numbers["attention_parity"], rows = phase_zoo_rest_attention(
        card, vit.batch_size, clip.batch_size, 8, 2 ** len(clip.mods) - 1)
    uni = zoo_rest_config(ZOO_REST_TEST, {}, root, eval_only=True)
    rows += kl_m1_rows(card, torch.Generator(device="cuda").manual_seed(73), uni.batch_size,
                       uni.n_latents, ZOO_REST_TEST)
    return total, numbers, rows


# -- the rest of eval (ROADMAP Queue A item 8) ------------------------------------

# the CelebA config whose image loss is edited to feature_loss and trained 1
# resident epoch on the families phase's surrogate rows; the ResNet-50
# config whose trunk Trainer.init_state fills from an installed file
EVAL_REST_CONFIG = "configs/config_celeba.yml"
EVAL_REST_INSTALL = "configs/reproduce_paper/mvae/level1/level1_0.yml"
# a call's launches: POE's lattice once (the CelebA nets have no attention);
# the same config as MOE under IWAE launches none (no KL on the K-weighted path)
EVAL_REST_PER_OBJECTIVE = {"celeba": {"poe": 1}, "moe_iwae": {}}
EVAL_REST_PER_BACKWARD = {"celeba": {"poe_bwd": 1}, "moe_iwae": {}}
EVAL_REST_TABLES = (EVAL_REST_PER_OBJECTIVE, EVAL_REST_PER_BACKWARD)
EVAL_REST_PARITY_BATCH, EVAL_REST_MOE_K = 4, 5
# the IWAE step's gradient limit, a share of each leaf's max |g|: its weights
# are a softmax over K of log-weights near -7.9e3, whose fp32 ulp is 4.9e-4
# (tests/test_torch_train.py holds the K-weighted bounds to 2e-3 too; DReG's
# weights are replayed instead, IWAE's sit inside log_mean_exp's backward)
EVAL_REST_IWAE_GRAD_REL = 2e-3
INCEPTION_BATCH = 16
FEATURE_NET_REL = 1e-4      # of the largest |value|, card fp32 vs CPU float64
FID_RTOL = 1e-3
VGG19_CONV_INDICES = (0, 2, 5, 7, 10, 12, 14, 16)   # torchvision vgg19's features.*
_TORCHVISION_BN = {"weight": "weight", "bias": "bias", "mean": "running_mean",
                   "var": "running_var"}


def _synthetic_tensor(rng: np.random.Generator, name: str, shape) -> np.ndarray:
    """A conv or dense kernel ~ N(0, 1 / fan_in); a BatchNorm's variance in
    [0.5, 1.5) and its weight (the one 1-d ``weight``) near 1; a bias or
    mean near 0."""
    leaf = name.rsplit(".", 1)[-1]
    if len(shape) > 1:
        return (rng.normal(size=shape) / np.sqrt(np.prod(shape[1:]))).astype(np.float32)
    if leaf == "running_var":
        return (0.5 + rng.random(shape)).astype(np.float32)
    base = 1.0 if leaf == "weight" else 0.0
    return (base + 0.1 * rng.normal(size=shape)).astype(np.float32)


def torchvision_state(kind: str, rng: np.random.Generator) -> dict:
    """A synthetic torchvision-layout ``vgg19``, ``inception_v3`` or
    ``resnet50`` state dict (numpy), named as torchvision names it: the
    port module's keys mapped back through its converter's key map, with
    the entries the converters drop (classifier, fc, AuxLogits,
    num_batches_tracked) where torchvision has them."""
    from multimodal_vae_comparison_tpu_torch.models.inception import InceptionV3
    from multimodal_vae_comparison_tpu_torch.models.nets import ResNet50, VGGFeatures
    out = {}
    if kind == "vgg19":
        for name, p in VGGFeatures().state_dict().items():
            conv, leaf = name.split(".")
            key = f"features.{VGG19_CONV_INDICES[int(conv.split('_')[1])]}.{leaf}"
            out[key] = _synthetic_tensor(rng, key, tuple(p.shape))
        out["classifier.0.weight"] = _synthetic_tensor(rng, "classifier.0.weight", (16, 32))
        return out
    if kind == "inception_v3":
        for name, p in InceptionV3().state_dict().items():
            block, leaf = name.rsplit(".", 1)
            key = f"{block}.{_TORCHVISION_BN[leaf]}" if block.endswith(".bn") else name
            out[key] = _synthetic_tensor(rng, key, tuple(p.shape))
            if block.endswith(".bn") and leaf == "var":
                out[f"{block}.num_batches_tracked"] = np.zeros((), np.int64)
        for key, shape in (("fc.weight", (1000, 2048)), ("fc.bias", (1000,)),
                           ("AuxLogits.fc.weight", (1000, 768))):
            out[key] = _synthetic_tensor(rng, key, shape)
        return out
    blocks = [(s, j) for s, n in enumerate((3, 4, 6, 3)) for j in range(n)]
    for name, p in ResNet50().state_dict().items():
        parts = name.split(".")
        if parts[0] == "Dense_0":
            key = f"fc.{parts[1]}"
        elif parts[0] in ("Conv_0", "FrozenBatchNorm_0"):
            key = ("conv1." if parts[0] == "Conv_0" else "bn1.") + _TORCHVISION_BN.get(
                parts[1], parts[1])
        else:
            s, j = blocks[int(parts[0].split("_")[1])]
            c = int(parts[1].split("_")[1])
            sub = (f"conv{c + 1}" if c < 3 else "downsample.0") if parts[1].startswith(
                "Conv") else (f"bn{c + 1}" if c < 3 else "downsample.1")
            key = f"layer{s + 1}.{j}.{sub}.{_TORCHVISION_BN.get(parts[2], parts[2])}"
        out[key] = _synthetic_tensor(rng, key, tuple(p.shape))
    return out


def _feature_net_error(got, want) -> float:
    """The largest |card - CPU float64| over outputs, as a share of the
    largest |CPU float64 value|."""
    got, want = (got, want) if isinstance(got, list) else ([got], [want])
    return max((g.double().cpu() - w).abs().max().item() / w.abs().max().item()
               for g, w in zip(got, want))


def phase_feature_nets(card: str, files: dict) -> dict:
    """VGGFeatures (pool and conv taps, 64 px, bs 16) and InceptionV3 (64 px
    resized to 299, bs INCEPTION_BATCH) loaded from the synthetic files by
    their converters, on the card (fp32, TF32 off) against the CPU in
    float64: within FEATURE_NET_REL of the largest |value|."""
    import copy
    from multimodal_vae_comparison_tpu_torch.eval import weights as W
    from multimodal_vae_comparison_tpu_torch.models.inception import InceptionV3
    from multimodal_vae_comparison_tpu_torch.models.nets import VGGFeatures
    g = torch.Generator().manual_seed(81)
    x = torch.rand((INCEPTION_BATCH, 64, 64, 3), generator=g)
    numbers = {}
    vgg, inception = VGGFeatures(), InceptionV3()
    W.load_checked(vgg, W.convert_vgg19(files["vgg19"]))
    W.load_checked(inception, W.convert_inception(files["inception_v3"]))
    for label, net, kwargs in (("VGGFeatures pool taps", vgg, {"taps": "pool"}),
                               ("VGGFeatures conv taps", vgg, {"taps": "conv"}),
                               ("InceptionV3 64 px resized to 299", inception, {})):
        with torch.inference_mode():
            t0 = time.perf_counter()
            want = copy.deepcopy(net).double()(x.double(), **kwargs)
            cpu_s = time.perf_counter() - t0
            card_net = copy.deepcopy(net).cuda()
            got = card_net(x.cuda(), **kwargs)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(5):
                card_net(x.cuda(), **kwargs)
            torch.cuda.synchronize()
            card_ms = (time.perf_counter() - t0) / 5 * 1e3
        err = _feature_net_error(got, want)
        shapes = [tuple(t.shape) for t in (got if isinstance(got, list) else [got])]
        print(f"eval remainder {label}: bs {INCEPTION_BATCH}, outputs {shapes}; card fp32 vs "
              f"CPU float64 {err:.3e} of the largest |value| (limit {FEATURE_NET_REL}); "
              f"{card_ms:.3f} ms a forward on the card (host clock), {cpu_s:.3f} s on the "
              f"CPU in float64 ({card})")
        check(err <= FEATURE_NET_REL, f"{label} on the card differs from the CPU: {err:.3e}")
        numbers[label] = {"rel_err_vs_cpu64": err, "card_ms": card_ms, "cpu64_s": cpu_s,
                          "outputs": shapes}
    return numbers


def phase_install_from_config(card: str, root: str, data, files: dict) -> dict:
    """``Trainer.init_state`` of EVAL_REST_INSTALL (POE, the ResNet-50
    ``Enc_CNN``) with the synthetic ``resnet50`` installed: its trunk on the
    card equal to the converted file, every other tensor the seed's."""
    from multimodal_vae_comparison_tpu_torch.eval import weights as W
    want = W.convert_resnet50(files["resnet50"])
    config, trainer, _ = config_trainer("install", EVAL_REST_INSTALL, "poe",
                                        cdsprites_paths(data), root, 1)
    prefix = "enc_mod_1.ResNet50_0."
    state = trainer.model.state_dict()
    trunk = {k[len(prefix):]: v for k, v in state.items() if k.startswith(prefix)}
    check(sorted(trunk) == sorted(want) and all(
        v.device.type == "cuda" and torch.equal(v.cpu(), want[k]) for k, v in trunk.items()),
          "the installed ResNet-50 trunk differs from the file")
    fresh = trainer._fresh[1]
    others = [k for k in state if not k.startswith(prefix)]
    check(all(torch.equal(state[k].cpu(), fresh[k].cpu()) for k in others),
          "install_pretrained changed a tensor outside the trunk")
    print(f"eval remainder install: Trainer.init_state of {EVAL_REST_INSTALL} filled "
          f"{len(trunk)} trunk tensors ({sum(v.numel() for v in trunk.values())} values) on "
          f"the card equal to the resnet50 file; {len(others)} other tensors the seed's "
          f"({card})")
    del trainer
    return {"config": EVAL_REST_INSTALL, "trunk_tensors": len(trunk), "other_tensors":
            len(others)}


def _feature_loss_edit(params):
    """``modality_1`` (the image) trained under ``feature_loss``."""
    params["modality_1"]["recon_loss"] = "feature_loss"


def _moe_iwae_edit(params):
    _feature_loss_edit(params)
    params.update(mixing="moe", obj="iwae", K=EVAL_REST_MOE_K)


def phase_fid_card_vs_cpu(card: str, celeba_dir: str) -> dict:
    """``calculate_fid_given_data`` of the surrogate's first 256 train
    images against its 256 test images on the card and on the CPU (the
    default VGG features, fixed random): within FID_RTOL relative."""
    from multimodal_vae_comparison_tpu_torch.eval import fid
    real = np.load(os.path.join(celeba_dir, "images.npy"))[:256].astype(np.float32) / 255
    other = np.load(os.path.join(celeba_dir, "test_images.npy"))[:256].astype(np.float32) / 255
    out, seconds = {}, {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        out[dev] = fid.calculate_fid_given_data(real, other, device=dev)
        seconds[dev] = time.perf_counter() - t0
    rel = abs(out["cuda"] - out["cpu"]) / abs(out["cpu"])
    label = fid.active_feature_net()
    print(f"eval remainder FID ({label}) of 256 train against 256 test CelebA surrogate "
          f"images: card {out['cuda']:.6e} ({seconds['cuda']:.3f} s), CPU {out['cpu']:.6e} "
          f"({seconds['cpu']:.3f} s), relative difference {rel:.3e} (limit {FID_RTOL}) "
          f"({card})")
    check(np.isfinite(out["cuda"]) and out["cpu"] > 0 and rel <= FID_RTOL,
          f"FID on the card {out['cuda']} vs the CPU {out['cpu']}")
    return {"feature_net": label, "fid_cuda": out["cuda"], "fid_cpu": out["cpu"],
            "rel_diff": rel, "card_s": seconds["cuda"], "cpu_s": seconds["cpu"]}


def phase_eval_rest_from_config(card: str, root: str, data, plain_epoch_s: float):
    """Queue A item 8's main path.  With no weights file (the perceptual
    extractor's fixed random weights): ``EVAL_REST_CONFIG`` with its image
    loss edited to ``feature_loss``, trained for 1 resident epoch on the
    CelebA surrogate the families phase made, counted from zero (PoE 1 a
    call, its backward 1 a step, no plain version); the val loss falls;
    its train steps profiled; one step on the card against the CPU in
    float64 at bs EVAL_REST_PARITY_BATCH as POE ``elbo`` and as MOE
    ``iwae`` K EVAL_REST_MOE_K (its gradients within
    EVAL_REST_IWAE_GRAD_REL); the FID card vs CPU.  Then synthetic
    torchvision ``vgg19``, ``inception_v3`` and ``resnet50`` files in a
    weights directory of the run: the feature nets card vs CPU float64 and
    the trunk install through ``Trainer.init_state``.  Returns (launches of
    the training run, the phase's numbers)."""
    from multimodal_vae_comparison_tpu_torch.models import perceptual
    numbers, total = {"card": card, "cut": {"epochs": 1}}, {}
    celeba_dir = os.path.join(root, "surrogates", "celeba")
    paths = family_paths("celeba", {"celeba": celeba_dir})
    saved = os.environ.get("MVAE_TPU_WEIGHTS_DIR")
    weights_dir = os.path.join(root, "weights")
    os.environ["MVAE_TPU_WEIGHTS_DIR"] = weights_dir
    perceptual.reset_extractor_cache()
    try:
        label = "POE celeba feature_loss"
        config, trainer, _ = config_trainer(label, EVAL_REST_CONFIG, "poe", paths, root, 1,
                                            edit=_feature_loss_edit)
        check(config.mods[0].recon_loss == "feature_loss", f"{label}: the edit did not hold")
        numbers["extractor_source"] = perceptual.extractor_source()
        check(numbers["extractor_source"] == "fixed-random",
              f"the extractor's source is {numbers['extractor_source']}")
        dm, bs = trainer.datamodule, config.batch_size
        steps, val_batches = dm.n_train // bs, dm.n_val // bs
        untrained = trainer.validate_scan(0)["val_loss"]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        counted(label, "celeba", steps + val_batches, steps,
                lambda: trainer.fit(epochs=1, log_fn=None), total, None, EVAL_REST_TABLES)
        run_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        trained, epoch_s, samples_s = one_epoch_checks(label, config, untrained)
        ext = {id(p) for p in perceptual.extractor(trainer.device).parameters()}
        check(not ext & {id(p) for p in trainer.model.parameters()}
              and not any(k.startswith("Conv_") for k in trainer.model.state_dict()),
              f"{label}: the extractor is inside the model")
        batch = next(dm.batches("val"))
        per_call = step_launches(label, trainer, batch, "celeba", tables=EVAL_REST_TABLES,
                                 phase="eval remainder from config")
        prof = profile_steps(label, trainer.train_step, torch_batch(batch, trainer.device),
                             torch.Generator(device="cuda").manual_seed(82), bs, 10, card)
        print(f"eval remainder from config {label} ({EVAL_REST_CONFIG}, modality_1 "
              f"recon_loss feature_loss, extractor {numbers['extractor_source']}): "
              f"{trainer.n_params()} parameters, {dm.n_train} train / {dm.n_val} val rows, "
              f"{steps} steps of {bs}; val_loss untrained {untrained:.2f} -> {trained:.2f}; "
              f"epoch {epoch_s:.3f} s ({plain_epoch_s:.3f} s under bce in this run), "
              f"{samples_s:.1f} samples/s; run {run_s:.2f} s; peak memory {peak:.3f} GiB on "
              f"{card}")
        numbers[label] = {"config": EVAL_REST_CONFIG, "params": trainer.n_params(),
                          "steps": steps, "batch": bs, "val_loss_untrained": untrained,
                          "val_loss": trained, "epoch_s": epoch_s,
                          "epoch_s_under_bce_this_run": plain_epoch_s,
                          "samples_per_s": samples_s, "run_s": run_s, "peak_memory_gib": peak,
                          "profile": prof, **per_call}
        del trainer
        n = EVAL_REST_PARITY_BATCH
        rows = {k: {"data": v["data"][:n], "masks": None} for k, v in batch.items()}
        rng = np.random.default_rng(83)
        for key, edit in (("celeba", _feature_loss_edit), ("moe_iwae", _moe_iwae_edit)):
            cfg = from_config(EVAL_REST_CONFIG, paths, root, eval_only=True, edit=edit)
            for i, mod in enumerate(cfg.mods):
                mod.feature_dims = list(rows[f"mod_{i + 1}"]["data"].shape[1:])
            shape = (cfg.K, n, cfg.n_latents)
            eps = ({m.name: rng.standard_normal(shape).astype(np.float32) for m in cfg.mods}
                   if cfg.mixing == "moe" else
                   [rng.standard_normal(shape).astype(np.float32) for _ in range(3)])
            numbers[f"card_vs_cpu {cfg.mixing} {cfg.obj} K {cfg.K}"] = card_vs_cpu_step(
                card, "eval remainder", f"{cfg.mixing.upper()} celeba feature_loss {cfg.obj}",
                cfg, rows, eps, key, EVAL_REST_TABLES,
                EVAL_REST_IWAE_GRAD_REL if cfg.obj == "iwae" else GRAD_REL)
        numbers["fid"] = phase_fid_card_vs_cpu(card, celeba_dir)
        # the synthetic torchvision files, installed for the rest of the phase
        os.makedirs(weights_dir, exist_ok=True)
        rng = np.random.default_rng(84)
        files = {kind: torchvision_state(kind, rng)
                 for kind in ("vgg19", "inception_v3", "resnet50")}
        for kind, sd in files.items():
            np.savez(os.path.join(weights_dir, f"{kind}.npz"), **sd)
        perceptual.reset_extractor_cache()
        numbers["feature_nets"] = phase_feature_nets(card, files)
        numbers["install"] = phase_install_from_config(card, root, data, files)
    finally:
        perceptual.reset_extractor_cache()
        if saved is None:
            os.environ.pop("MVAE_TPU_WEIGHTS_DIR", None)
        else:
            os.environ["MVAE_TPU_WEIGHTS_DIR"] = saved
    return total, numbers

# -- precision: bf16 ----------------------------------------------------------------

# tests/test_torch_bf16.py's yardstick: a bf16 result may differ from its
# reference's bf16 by BF16_C times the reference's own bf16 error (bf16
# against fp32) plus BF16_ATOL, in units of the reference array's max |x|
# (scalars: of their fp32 value); here the card against the CPU, both the
# port, the CPU's fp32 taking the reference's place
BF16_C, BF16_ATOL = 3.0, 2.0 ** -8
BF16_BATCHES = (24, 256)          # the flagship steps timed in both precisions
BF16_TIMED_STEPS = 20             # steps behind each p50
BF16_VIDEO_FLOPS = (2, 2)         # (batch, K) of the video step counted on both devices
PEAK_BF16_FLOP_PER_S = 989e12     # dense bf16 tensor cores, the H100 SXM data sheet
# the bf16 launchers against the fp32 kernel at the main paths' shapes, (label,
# (b, h, tq, tk, dh), masked); the sparse (b, h, t, dh) of the video decoder
BF16_ATTENTION_CASES = (("flagship text encoder", (24, 2, 45, 45, 32), True),
                        ("CUB caption encoder", (32, 2, 246, 246, 32), True),
                        ("CUB DReG decoder", (640, 2, 246, 1, 8), False),
                        ("SPRITES encoder bs 16, T", axial_shapes(16)[0], False),
                        ("SPRITES encoder bs 16, H", axial_shapes(16)[1], False),
                        ("SPRITES decoder M*K*B 240, T", axial_shapes(240)[0], False),
                        ("SPRITES decoder M*K*B 240, H", axial_shapes(240)[1], False),
                        ("VILANRO action encoder", (64, 2, 100, 100, 16), True))
BF16_SPARSE_SHAPE = (80, 2, 2048, 32)
# bf16 MMAs each bf16 tensor-core sparse kernel issues per product of its
# function: the forward 3 for q k^T and P v (P in two planes), dq 5 for its
# three (dO V^T and dS K on two planes), dk/dv 8 for its four (P^T dO on
# both operands' planes: 3)
BF16_TC_MMA_UNITS = {"forward": 3 / 2, "dq": 5 / 3, "dkv": 8 / 4}
# the bf16 attention launcher's yardsticks (the arguments of
# masked_attention_forward_bf16 less `variant`), which the port never calls
BF16_ATTENTION_YARDSTICKS = ("masked_attention_forward_bf16_widened",
                             "masked_attention_forward_bf16_tc")


def bf16_tc_bounds(nbytes: float, flop: float, units: float = 1.5):
    """(bound ms, by, the kernel's own MMA bound ms) of a bf16 tensor-core
    kernel whose products take ``flop``: the larger of ``nbytes`` at the
    HBM rate and ``flop`` at the dense bf16 rate; and the MMAs it issues,
    ``units`` per product (1.5 for q k^T once and P v twice, P in two bf16
    planes; BF16_TC_MMA_UNITS), at the same rate."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flop / PEAK_BF16_FLOP_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            units * t_ops)


def _yard_worst(got: dict, b: dict, f: dict, key_bias_scale: bool = True):
    """(worst share of its limit, leaf): each leaf of ``got`` against ``b``
    within BF16_C * max|b - f| + BF16_ATOL, in units of max |b| (an
    attention key bias at its key weight's)."""
    worst, name = 0.0, None
    for n in b:
        ref = b[n[:-len("bias")] + "weight"] if key_bias_scale and n.endswith("key.bias") \
            else b[n]
        s = ref.abs().max().item() or 1.0
        limit = BF16_C * (b[n] - f[n]).abs().max().item() / s + BF16_ATOL
        share = (got[n] - b[n]).abs().max().item() / s / limit
        if share > worst:
            worst, name = share, n
    return worst, name


def _scalar_share(got: float, b: float, f: float) -> float:
    return abs(got - b) / (BF16_C * abs(b - f) + BF16_ATOL * max(abs(f), 1e-6))


def phase_bf16_kernels(card: str) -> dict:
    """Each bf16 launcher (the masked attention's forward, the sparse
    forward, dq and dk/dv) against the fp32 kernel on the widened inputs and
    against the plain version, at the main paths' shapes, within the
    tolerance the fp32 kernel meets against its plain version (dq, dk, dv:
    plus their one rounding to bf16): the variant it took (telemetry), the
    same bits on a second launch, its ms beside the fp32 kernel's, the
    widening kernel's (timed in turns with it) and, for the attention, the
    tensor-core kernel's at every shape (the crossover's A/B, its two
    yardsticks), its bounds (:func:`bound_ms` over its bytes at 2 a bf16
    element and its operations at the fp32 rate; the tensor-core kernels'
    in their own unit, :func:`bf16_tc_bounds`), the plain version's ms and
    SDPA's bf16 time.  Returns ({kernel row name: [numbers]}, {tensor-core
    kernel, and the attention's short bf16 kernel: its kernels-line entry at
    its main shape})."""
    import ctypes
    import torch.nn.functional as F
    from multimodal_vae_comparison_tpu_torch.ops.kernels import _build, attention, telemetry
    from multimodal_vae_comparison_tpu_torch.ops.kernels import sparse_attention as sp
    g = torch.Generator(device="cuda").manual_seed(71)
    rows, entries = {}, {}
    src = "multimodal_vae_comparison_tpu_torch/csrc/"
    ref = "multimodal_vae_comparison_tpu/ops/pallas/"
    yard_args = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
    widened_fn, tc_fn = (_build.function("attention", name, yard_args)
                         for name in BF16_ATTENTION_YARDSTICKS)
    for label, (b, h, tq, tk, dh), masked in BF16_ATTENTION_CASES:
        q, k, v, mask = attention_inputs(g, b, h, tq, tk, dh, masked)
        q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
        wide = (q.float(), k.float(), v.float())
        telemetry.reset()
        got = attention._launch(q, k, v, mask)
        took = telemetry.dtypes()
        again = attention._launch(q, k, v, mask)
        want = attention._launch(*wide, mask)
        plain = attention.attention_reference(q, k, v, mask)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        err_plain = (got - plain).abs().max().item()
        check(got.dtype == torch.float32 and torch.allclose(got, want, rtol=ATTN_RTOL,
                                                            atol=ATTN_ATOL)
              and torch.allclose(got, plain, rtol=ATTN_RTOL, atol=ATTN_ATOL),
              f"bf16 attention {label}: max_abs_err {err} against the fp32 kernel, "
              f"{err_plain} against the plain version")
        check(torch.equal(got, again), f"bf16 attention {label}: two launches differ")
        expect = attention_variant((b, h, tq, tk, dh), torch.bfloat16)
        check(took == {f"attention:{expect}:bfloat16": 1},
              f"bf16 attention {label}: launched {took}, expected the {expect} kernel")
        yard = {}
        for name, fn in zip(("widened", "tc"), (widened_fn, tc_fn)):
            out = torch.empty_like(got)

            def call(fn=fn, out=out):
                _build.check("attention", fn(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    None if mask is None else mask.data_ptr(), out.data_ptr(), b, h, tq, tk,
                    dh, dh ** -0.5, torch.cuda.current_stream().cuda_stream))
            call()
            torch.cuda.synchronize()
            check(torch.allclose(out, want, rtol=ATTN_RTOL, atol=ATTN_ATOL),
                  f"bf16 attention {label}: the {name} yardstick against the fp32 kernel")
            yard[name] = call
        # the launcher, the widening path and the tensor-core kernel in turns
        ms = graph_ms(lambda: attention._launch(q, k, v, mask))
        widened_ms, tc_ms = graph_ms(yard["widened"]), graph_ms(yard["tc"])
        tc_again, widened_again = graph_ms(yard["tc"]), graph_ms(yard["widened"])
        ms_again = graph_ms(lambda: attention._launch(q, k, v, mask))
        fp32_ms = graph_ms(lambda: attention._launch(*wide, mask))
        plain_ms = graph_ms(lambda: attention.attention_reference(q, k, v, mask))
        bias = None if mask is None else torch.zeros(b, 1, 1, tk, device="cuda",
                                                     dtype=torch.bfloat16).masked_fill(
            ~mask[:, None, None, :], float("-inf"))
        if bias is not None:
            bias[0] = 0.0    # SDPA's all-masked row would be NaN; its time is what counts
        try:
            sdpa = graph_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=bias))
        except RuntimeError:   # the library's limits, not the port's
            sdpa = None
        keys = b * tk if mask is None else attended_keys(tk, mask)
        nbytes = 2 * (b * h * tq * dh + 2 * h * keys * dh) + 4 * b * h * tq * dh \
            + (0 if mask is None else b * tk)
        products = 4 * h * tq * keys * dh
        bound, by = bound_ms(nbytes, products + 4 * h * tq * keys)
        tc_bound, tc_by, mma_bound = bf16_tc_bounds(nbytes, products)
        row = {"at": f"{label} {(b, h, tq, tk, dh)}", "variant": sorted(took),
               "padding_share": 1 - keys / (b * tk), "max_abs_err_vs_fp32_kernel": err,
               "max_abs_err_vs_plain": err_plain, "ms": ms, "ms_again": ms_again,
               "widened_ms": [widened_ms, widened_again], "tc_ms": [tc_ms, tc_again],
               "fp32_kernel_ms": fp32_ms, "plain_ms": plain_ms, "bound_ms": bound,
               "bound_by": by, "bf16_tc_bound_ms": tc_bound, "bf16_tc_bound_by": tc_by,
               "tc_mma_bound_ms": mma_bound, "library_ms": sdpa,
               "library_is": "F.scaled_dot_product_attention on bf16 q, k, v"}
        rows.setdefault("masked_attention", []).append(row)
        print(f"bf16 attention {label} {(b, h, tq, tk, dh)}: {sorted(took)}, padding "
              f"{row['padding_share']:.3f}, max_abs_err {err:.3e} against the fp32 kernel on "
              f"the widened inputs, {err_plain:.3e} against the plain version; launcher "
              f"{ms:.5f} / {ms_again:.5f} ms, tensor-core kernel {tc_ms:.5f} / {tc_again:.5f}, "
              f"widening path {widened_ms:.5f} / {widened_again:.5f}, fp32 kernel "
              f"{fp32_ms:.5f}, plain {plain_ms:.5f}; bound {bound:.6f} ms ({by}, fp32 ops), "
              f"{tc_bound:.6f} ({tc_by}, products at 989 TFLOP/s bf16), the tensor-core "
              f"kernel's MMAs {mma_bound:.6f}; SDPA bf16 "
              + ("refused" if sdpa is None else f"{sdpa:.5f}") + f" ms on {card}")
        if label == "CUB caption encoder":
            entries["masked_attention_bf16_tc"] = {
                "name": "masked_attention_bf16_tc", "route": "cuda",
                "source": src + "attention.cu", "kernel": "masked_attention_tc",
                "header": src + "bf16_tc.cuh", "replaces": ref + "attention.py:77",
                "inputs": "bf16",
                "at": row["at"], "max_abs_err": err, "max_abs_err_vs_plain": err_plain,
                "ms": ms, "plain_ms": plain_ms, "bound_ms": tc_bound, "bound_by": tc_by,
                "library_ms": sdpa, "library_is": row["library_is"],
                "tc_mma_bound_ms": mma_bound, "widened_ms": widened_ms,
                "fp32_kernel_ms": fp32_ms}
        if label == "SPRITES decoder M*K*B 240, T":
            entries["masked_attention_short_bf16"] = {
                "name": "masked_attention_short_bf16", "route": "cuda",
                "source": src + "attention.cu", "kernel": "masked_attention_short_bf16",
                "replaces": ref + "attention.py:77", "inputs": "bf16",
                "at": row["at"], "max_abs_err": err_plain, "max_abs_err_vs_fp32_kernel": err,
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
                "library_ms": sdpa, "library_is": row["library_is"],
                "widened_ms": [widened_ms, widened_again], "tc_ms": [tc_ms, tc_again],
                "fp32_kernel_ms": fp32_ms}
    b, h, t, dh = BF16_SPARSE_SHAPE
    q, k, v = (torch.randn(BF16_SPARSE_SHAPE, generator=g, device="cuda").bfloat16()
               for _ in range(3))
    wide = [x.float() for x in (q, k, v)]
    blk, stride = SPARSE_BLOCK, SPARSE_STRIDE
    telemetry.reset()
    out, lse = sp._launch_forward(q, k, v, blk, stride)
    out32, lse32 = sp._launch_forward(*wide, blk, stride)
    d_out = torch.randn(BF16_SPARSE_SHAPE, generator=g, device="cuda")
    delta = (d_out * out32).sum(-1)
    args16 = (q, k, v, d_out, lse32, delta, blk, stride)
    args32 = (*wide, d_out, lse32, delta, blk, stride)
    dq, (dk, dv) = sp._launch_dq(*args16), sp._launch_dkv(*args16)
    took = telemetry.dtypes()
    dq_again, (dk_again, dv_again) = sp._launch_dq(*args16), sp._launch_dkv(*args16)
    dq32, (dk32, dv32) = sp._launch_dq(*args32), sp._launch_dkv(*args32)
    out_again, lse_again = sp._launch_forward(q, k, v, blk, stride)
    plain = sp.sparse_attention_reference(q, k, v, blk, stride)
    torch.cuda.synchronize()
    check(dq.dtype == dk.dtype == dv.dtype == torch.bfloat16 and out.dtype == torch.float32,
          f"bf16 sparse: out {out.dtype}, dq/dk/dv {dq.dtype}/{dk.dtype}/{dv.dtype}")
    check(torch.equal(out, out_again) and torch.equal(lse, lse_again),
          "bf16 sparse forward: two launches differ")
    check(torch.equal(dq, dq_again) and torch.equal(dk, dk_again) and torch.equal(dv, dv_again),
          "bf16 sparse dq or dk/dv: two launches differ")
    del dq_again, dk_again, dv_again
    # dq, dk, dv are the bf16 roundings of the kernels' own fp32 sums: held to
    # the backward tolerance plus that one rounding (2^-8 of each value)
    bwd_rtol = SPARSE_BWD_RTOL + 2.0 ** -8

    def bwd_err(got, want):
        return (got.float() - want).abs().max().item()

    def bwd_close(got, want):
        return torch.allclose(got.float(), want, rtol=bwd_rtol, atol=SPARSE_BWD_ATOL)

    errs = {"forward": max((out - out32).abs().max().item(), (lse - lse32).abs().max().item()),
            "dq": bwd_err(dq, dq32), "dkv": max(bwd_err(dk, dk32), bwd_err(dv, dv32))}
    err_plain = {"forward": (out - plain).abs().max().item()}
    check(torch.allclose(out, out32, rtol=SPARSE_RTOL, atol=SPARSE_ATOL)
          and torch.allclose(lse, lse32, rtol=SPARSE_RTOL, atol=SPARSE_ATOL)
          and torch.allclose(out, plain, rtol=SPARSE_RTOL, atol=SPARSE_ATOL),
          f"bf16 sparse forward: {errs['forward']} against the fp32 kernel, "
          f"{err_plain['forward']} against the plain version")
    del plain
    for name, got, want in (("dq", dq, dq32), ("dk", dk, dk32), ("dv", dv, dv32)):
        check(bwd_close(got, want), f"bf16 sparse {name}: {bwd_err(got, want)} against the "
              f"fp32 kernel's, beyond the backward tolerance and one bf16 rounding")
    # the plain version's gradients: autograd through it on the widened inputs
    leaves = [x.detach().requires_grad_() for x in wide]

    def plain_bwd():
        return torch.autograd.grad(sp.sparse_attention_reference(*leaves, blk, stride), leaves,
                                   d_out)
    want_g = plain_bwd()
    err_plain["dq"] = bwd_err(dq, want_g[0])
    err_plain["dkv"] = max(bwd_err(dk, want_g[1]), bwd_err(dv, want_g[2]))
    for name, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), want_g):
        check(bwd_close(got, want), f"bf16 sparse {name}: {bwd_err(got, want)} against the "
              f"plain version's gradient, beyond the backward tolerance and one bf16 rounding")
    del want_g
    torch.cuda.synchronize()
    plain_ms = {"forward": eager_ms(lambda: sp.sparse_attention_reference(q, k, v, blk, stride),
                                    iters=5)}
    plain_ms["dq"] = plain_ms["dkv"] = eager_ms(plain_bwd, iters=3)
    del leaves
    visible = sp.visibility(t, blk, stride, "cuda")
    sdpa = graph_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=visible))
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    sdpa_out = F.scaled_dot_product_attention(*leaves, attn_mask=visible)
    sdpa_bwd = eager_ms(lambda: torch.autograd.grad(sdpa_out, leaves, d_out.bfloat16(),
                                                    retain_graph=True), iters=10)
    del leaves, sdpa_out
    # the bf16 launchers that widen (3xTF32 on widened inputs), the
    # yardsticks of the tensor-core kernels, each into buffers of its own
    w_out, w_lse, w_dq, w_dk, w_dv = (torch.empty_like(x) for x in (out, lse, dq, dk, dv))
    rows_in = [x.data_ptr() for x in (q, k, v, d_out, lse32, delta)]
    widened = {}
    for part, argtypes, outs in (("forward", sp._FWD_ARGTYPES, (w_out, w_lse)),
                                 ("dq", sp._DQ_ARGTYPES, (w_dq,)),
                                 ("dkv", sp._DKV_ARGTYPES, (w_dk, w_dv))):
        fn = _build.function("sparse_attention", f"sparse_attention_{part}_bf16_widened",
                             argtypes[:-1])
        ins = rows_in[:3] if part == "forward" else rows_in

        def call(fn=fn, ins=ins, outs=outs):
            _build.check("sparse_attention", fn(*ins, *(x.data_ptr() for x in outs),
                                                *sp._shape_args(q, blk, stride)))
        widened[part] = call
    _, cells = sp.sparse_work(t, blk, stride)
    n, n_rows = b * h * t * dh, b * h * t
    names = {"forward": ("strided_block_sparse_attention", "sparse_attention", "sparse_fwd_tc",
                         165),
             "dq": ("strided_block_sparse_attention_dq", "sparse_attention_dq", "sparse_dq_tc",
                    262),
             "dkv": ("strided_block_sparse_attention_dkv", "sparse_attention_dkv",
                     "sparse_dkv_tc", 283)}
    for part, fn, fn32, nbytes, per_cell, lib in (
            ("forward", lambda: sp._launch_forward(q, k, v, blk, stride),
             lambda: sp._launch_forward(*wide, blk, stride),
             2 * 3 * n + 4 * (n + n_rows), 4 * dh, sdpa),
            ("dq", lambda: sp._launch_dq(*args16), lambda: sp._launch_dq(*args32),
             2 * 4 * n + 4 * (n + 2 * n_rows), 6 * dh, sdpa_bwd),
            ("dkv", lambda: sp._launch_dkv(*args16), lambda: sp._launch_dkv(*args32),
             2 * 5 * n + 4 * (n + 2 * n_rows), 8 * dh, sdpa_bwd)):
        row, key, kernel, line = names[part]
        # the tensor-core kernel and its widening yardstick in turns
        ms = graph_ms(fn, reps=10)
        widened_ms = [graph_ms(widened[part], reps=10)]
        ms_again = graph_ms(fn, reps=10)
        widened_ms.append(graph_ms(widened[part], reps=10))
        fp32_ms = graph_ms(fn32, reps=10)
        torch.cuda.synchronize()
        check(torch.equal(w_out, out32) and torch.equal(w_lse, lse32) if part == "forward"
              else torch.equal(w_dq, dq32.bfloat16()) if part == "dq"
              else torch.equal(w_dk, dk32.bfloat16()) and torch.equal(w_dv, dv32.bfloat16()),
              f"the widening bf16 sparse {part} is no longer the fp32 kernel on widened "
              f"inputs, rounded once")
        flop = b * h * cells * per_cell
        bound, by = bound_ms(nbytes, flop)
        # the unit the widening kernels run on, as the fp32 rows give it:
        # three TF32 MMAs per widened product at the tensor cores' TF32 rate
        tensor_bound = 3 * flop / PEAK_TF32_FLOP_PER_S * 1e3
        tc_bound, tc_by, mma_bound = bf16_tc_bounds(nbytes, flop, BF16_TC_MMA_UNITS[part])
        rows[row] = [{"at": f"video decoder {BF16_SPARSE_SHAPE} block {blk} stride {stride}",
                      "variant": sorted(x for x in took if x.startswith(key + ":")),
                      "max_abs_err_vs_fp32_kernel": errs[part],
                      "max_abs_err_vs_plain": err_plain[part], "ms": ms, "ms_again": ms_again,
                      "widened_ms": widened_ms, "fp32_kernel_ms": fp32_ms,
                      "plain_ms": plain_ms[part], "bound_ms": bound, "bound_by": by,
                      "tensor_bound_ms": tensor_bound, "bf16_tc_bound_ms": tc_bound,
                      "bf16_tc_bound_by": tc_by, "tc_mma_bound_ms": mma_bound,
                      "library_ms": lib, "library_is": "F.scaled_dot_product_attention(q, k, "
                      "v, attn_mask=visible) on bf16, " + ("forward" if part == "forward"
                                                           else "its backward (eager)")}]
        entries[row + "_bf16_tc"] = {
            "name": row + "_bf16_tc", "route": "cuda", "source": src + "sparse_attention.cu",
            "kernel": kernel, "header": src + "bf16_tc.cuh",
            "replaces": ref + f"sparse_attention.py:{line}", "inputs": "bf16",
            "at": rows[row][0]["at"], "max_abs_err": errs[part],
            "max_abs_err_vs_plain": err_plain[part], "ms": ms, "plain_ms": plain_ms[part],
            "bound_ms": tc_bound, "bound_by": tc_by, "library_ms": lib,
            "library_is": rows[row][0]["library_is"], "tc_mma_bound_ms": mma_bound,
            "widened_ms": widened_ms[0], "fp32_kernel_ms": fp32_ms}
        print(f"bf16 {row} {BF16_SPARSE_SHAPE}: {rows[row][0]['variant']}, max_abs_err "
              f"{errs[part]:.3e} against the fp32 kernel, {err_plain[part]:.3e} against the "
              f"plain version; {ms:.5f} / {ms_again:.5f} ms, widening kernel "
              f"{widened_ms[0]:.5f} / {widened_ms[1]:.5f} ms, fp32 kernel {fp32_ms:.5f} ms, "
              f"plain {plain_ms[part]:.5f} ms; bound {tc_bound:.6f} ms ({tc_by}; products at "
              f"989 TFLOP/s bf16), of its {round(BF16_TC_MMA_UNITS[part] * per_cell / (2 * dh))} "
              f"bf16 MMAs a pair {mma_bound:.6f} ms, of the widening kernel's 3 TF32 MMAs a "
              f"product at 495 TFLOP/s {tensor_bound:.6f} ms; SDPA bf16 {lib:.5f} ms on {card}")
    del q, k, v, wide, out, lse, out32, lse32, d_out, delta, args16, args32
    del dq, dk, dv, dq32, dk32, dv32, w_out, w_lse, w_dq, w_dk, w_dv, widened
    torch.cuda.empty_cache()
    return rows, entries


def _p50_step_ms(step, batch, gen, steps: int = BF16_TIMED_STEPS) -> float:
    """Median wall ms of ``steps`` train steps, each ended by a synchronize,
    after 3 warm ones."""
    for _ in range(3):
        step(batch, generator=gen)
    torch.cuda.synchronize()
    times = []
    for _ in range(steps):
        t0 = time.perf_counter()
        step(batch, generator=gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def phase_bf16_steps(card: str) -> dict:
    """The flagship POE and MOE train steps and the VideoGPTSparse MOE DReG
    step under ``dtype=bf16``.  Card against the port's CPU in bf16 on the
    same weights, batch and eps, the CPU on the card's relu branches
    (:func:`same_branches`), held to the bf16 yardstick with the CPU's fp32
    as the reference's fp32 (loss, metrics, every gradient leaf); exact
    launches a step and no plain version; p50 step ms in fp32 and bf16 side
    by side at BF16_BATCHES; ``ops.flops.step_flops`` of each step on the
    card and on the CPU, equal, and the TFLOP/s it gives."""
    from multimodal_vae_comparison_tpu_torch.ops.flops import step_flops
    from multimodal_vae_comparison_tpu_torch.ops.kernels import telemetry
    from multimodal_vae_comparison_tpu_torch.training.optim import make_optimizer
    from multimodal_vae_comparison_tpu_torch.training.trainer import (
        build_model, make_train_step)
    bf16, numbers = torch.bfloat16, {"card": card}
    rng = np.random.default_rng(72)
    raw = make_inputs(rng, TRAIN_BATCH)
    for label, mixing, obj in training_models():
        eps = numpy_eps(rng, mixing, TRAIN_BATCH)
        out, branches, flips = {}, [], {}
        for key, dev, dt in (("card", "cuda", bf16), ("cpu_bf16", "cpu", bf16),
                             ("cpu_fp32", "cpu", torch.float32)):
            model = build_model(flagship_specs(), mixing, N_LATENTS, obj=obj, seed=0,
                                device=dev, dtype=dt)
            telemetry.reset()
            with same_branches(branches, dev == "cpu", flips):
                out[key] = _objective_grads(model, torch_batch(raw, dev), eps_to(eps, dev))
            if dev == "cuda":
                launches, kinds, paths = (telemetry.launches(), telemetry.dtypes(),
                                          telemetry.summary())
        (gl, gm, gg), (bl, bm, bg), (fl, fm, fg) = out["card"], out["cpu_bf16"], out["cpu_fp32"]
        worst, worst_name = _yard_worst(gg, bg, fg)
        shares = {"loss": _scalar_share(gl, bl, fl),
                  **{k: _scalar_share(gm[k], bm[k], fm[k]) for k in gm}}
        print(f"bf16 parity {label}: loss card {gl:.6f}, CPU bf16 {bl:.6f}, CPU fp32 {fl:.6f}; "
              f"worst scalar {max(shares.values()):.3f} of its limit; {len(gg)} gradient "
              f"leaves, worst {worst:.3f} of its limit at {worst_name} (limit {BF16_C} x "
              f"|CPU bf16 - CPU fp32| + {BF16_ATOL} of max|g|); branch flips {flips}; "
              f"launches {launches}, {kinds}")
        check(np.isfinite(gl) and all(bool(torch.isfinite(x).all()) for x in gg.values()),
              f"bf16 {label}: non-finite loss or gradient on the card")
        check(max(shares.values()) <= 1.0, f"bf16 {label}: loss or metric off: {shares}")
        check(worst <= 1.0, f"bf16 {label}: gradient of {worst_name} off the yardstick")
        check(launches == expected_launches(mixing, 1, 1) and not any(
            p.endswith(":plain") for p in paths), f"bf16 {label}: launched {launches}, {paths}")
        # the text encoder on the bf16 tensor-core kernel, the decoders' one
        # latent key on the few-keys kernel
        check(kinds.get("attention:tc_bf16:bfloat16", 0) > 0
              and kinds.get("attention:tc_bf16:bfloat16", 0)
              + kinds.get("attention:few_keys:bfloat16", 0) == launches.get("attention"),
              f"bf16 {label}: the attention launches did not all take the bf16 "
              f"tensor-core or few-keys kernel: {kinds}")
        numbers[label] = {"loss_card": gl, "loss_cpu_bf16": bl, "loss_cpu_fp32": fl,
                          "worst_grad_share_of_limit": worst, "worst_leaf": worst_name,
                          "scalar_shares_of_limit": shares, "branch_flips": flips,
                          "launches_objective_and_backward": launches, "variants": kinds}
        steps_info = {}
        for n in BF16_BATCHES:
            batch = torch_batch(make_inputs(np.random.default_rng(73), n), "cuda")
            for dt in (torch.float32, bf16):
                model = build_model(flagship_specs(), mixing, N_LATENTS, obj=obj, seed=0,
                                    device="cuda", dtype=dt)
                step = make_train_step(model, make_optimizer("adam", TRAIN_LR,
                                                             model.parameters()))
                gen = torch.Generator(device="cuda").manual_seed(74)
                telemetry.reset()
                metrics = step(batch, generator=gen)
                torch.cuda.synchronize()
                per_step, paths = telemetry.launches(), telemetry.summary()
                check(per_step == ROUTE_PER_STEP[mixing]["new"] and not any(
                    p.endswith(":plain") for p in paths),
                    f"bf16 {label} bs {n} {dt}: launched {per_step} a step, {paths}")
                check(all(bool(torch.isfinite(v).all()) for v in metrics.values())
                      and all(p.grad is None or bool(torch.isfinite(p.grad).all())
                              for p in model.parameters()),
                      f"bf16 {label} bs {n} {dt}: non-finite metrics or gradients")
                flops = step_flops(step, batch, generator=gen)["flops"]
                p50 = _p50_step_ms(step, batch, gen)
                steps_info[f"bs{n}_{str(dt)[6:]}"] = {
                    "p50_step_ms": p50, "flops": flops,
                    "tflop_per_s": flops / p50 / 1e9,
                    "share_of_peak": flops / p50 / 1e9 / (
                        PEAK_BF16_FLOP_PER_S if dt == bf16 else PEAK_FP32_FLOP_PER_S) * 1e12}
                del model, step
            cpu_flops = {}
            if n == TRAIN_BATCH:
                for dt in (torch.float32, bf16):
                    model = build_model(flagship_specs(), mixing, N_LATENTS, obj=obj,
                                        seed=0, device="cpu", dtype=dt)
                    step = make_train_step(model, make_optimizer("adam", TRAIN_LR,
                                                                 model.parameters()))
                    cpu_flops[str(dt)[6:]] = step_flops(
                        step, torch_batch(make_inputs(np.random.default_rng(73), n), "cpu"),
                        generator=torch.Generator().manual_seed(74))["flops"]
                    check(cpu_flops[str(dt)[6:]] == steps_info[f"bs{n}_{str(dt)[6:]}"]["flops"],
                          f"{label} bs {n} {dt}: step_flops {cpu_flops} on the CPU, "
                          f"{steps_info[f'bs{n}_{str(dt)[6:]}']['flops']} on the card")
            a, b_ = steps_info[f"bs{n}_float32"], steps_info[f"bs{n}_bfloat16"]
            print(f"bf16 step {label} bs {n}: p50 fp32 {a['p50_step_ms']:.3f} ms, bf16 "
                  f"{b_['p50_step_ms']:.3f} ms; step_flops {a['flops']} (card"
                  + (f", CPU {cpu_flops}" if cpu_flops else "") + f"): {a['tflop_per_s']:.4f} "
                  f"TFLOP/s fp32 ({100 * a['share_of_peak']:.4f} % of 67), "
                  f"{b_['tflop_per_s']:.4f} bf16 ({100 * b_['share_of_peak']:.4f} % of 989; "
                  f"495 TF32) on {card}")
        numbers[label]["steps"] = steps_info
    # the video step: its three sparse launchers on bf16 inputs
    raw_v, eps_v = video_inputs(np.random.default_rng(75), VIDEO_BATCH, VIDEO_K)
    batch = torch_batch(raw_v, "cuda")
    video = {}
    for dt in (torch.float32, bf16):
        model = build_model(video_specs(), "moe", VIDEO_LATENTS, obj="dreg", K=VIDEO_K, seed=0,
                            device="cuda", remat=True, dtype=dt)
        step = make_train_step(model, make_optimizer("adam", VIDEO_LR, model.parameters()))
        gen = torch.Generator(device="cuda").manual_seed(76)
        telemetry.reset()
        metrics = step(batch, generator=gen)
        torch.cuda.synchronize()
        per_step, kinds, paths = telemetry.launches(), telemetry.dtypes(), telemetry.summary()
        want = {"sparse_attention": 20, "sparse_attention_dq": 8, "sparse_attention_dkv": 8}
        check(per_step == want and not any(p.endswith(":plain") for p in paths),
              f"video {dt}: launched {per_step} a step, expected {want}; {paths}")
        check(bool(torch.isfinite(metrics["loss"])), f"video {dt}: non-finite loss")
        if dt == bf16:
            want_kinds = {"sparse_attention:tc_bf16:bfloat16": 20,
                          "sparse_attention_dq:tc_bf16:bfloat16": 8,
                          "sparse_attention_dkv:tc_bf16:bfloat16": 8}
            check(kinds == want_kinds,
                  f"video bf16: the sparse launchers took {kinds}, expected {want_kinds}")
        flops = step_flops(step, batch, generator=gen)["flops"]
        p50 = _p50_step_ms(step, batch, gen, steps=10)
        video[str(dt)[6:]] = {"p50_step_ms": p50, "flops": flops, "variants": kinds,
                              "launches_per_step": per_step, "tflop_per_s": flops / p50 / 1e9}
        del model, step
    # the same integer on both devices, at a batch the CPU steps in seconds
    nb, kb = BF16_VIDEO_FLOPS
    raw_s, _ = video_inputs(np.random.default_rng(77), nb, kb)
    counts = {}
    for dev, dt in (("cuda", torch.float32), ("cuda", bf16), ("cpu", torch.float32)):
        model = build_model(video_specs(), "moe", VIDEO_LATENTS, obj="dreg", K=kb, seed=0,
                            device=dev, remat=True, dtype=dt)
        step = make_train_step(model, make_optimizer("adam", VIDEO_LR, model.parameters()))
        gen = torch.Generator(device=dev).manual_seed(78)
        counts[f"{dev}_{str(dt)[6:]}"] = step_flops(step, torch_batch(raw_s, dev),
                                                    generator=gen)["flops"]
    check(counts["cuda_float32"] == counts["cpu_float32"] == counts["cuda_bfloat16"],
          f"video step_flops differ between devices: {counts}")
    video["step_flops_card_and_cpu"] = {"batch": nb, "K": kb, **counts}
    print(f"bf16 video step (bs {VIDEO_BATCH}, K {VIDEO_K}, DReG, remat): p50 fp32 "
          f"{video['float32']['p50_step_ms']:.3f} ms, bf16 {video['bfloat16']['p50_step_ms']:.3f}"
          f" ms; step_flops {video['float32']['flops']}: "
          f"{video['float32']['tflop_per_s']:.4f} / {video['bfloat16']['tflop_per_s']:.4f} "
          f"TFLOP/s; sparse launchers {video['bfloat16']['variants']}; step_flops at bs {nb}, "
          f"K {kb} on card and CPU {counts} on {card}")
    numbers["VideoGPTSparse MOE dreg"] = video
    return numbers


def phase_bf16_from_config(card: str, root: str, data, sprites_dir: str,
                           sprites_fp32: dict) -> dict:
    """``cdl1_r5_poe.yml`` with ``--precision bf16`` through the port's CLI
    (``main.cli``) on the ZOO_DATA_COUNT rows of level 1 for 1 epoch and
    ``test()``, beside the same epoch in fp32: exact launches, no plain
    version, the val loss falls, the 12 stats in range, and ``model/last``
    restored through ``MultimodalVAEInfer`` into an fp32 model whose weights
    are the trainer's and whose forward is that of the trainer's weights in
    fp32 within RESTORE_RTOL / RESTORE_ATOL.  Then ``sprites_r4_dreg_up``
    under ``precision: bf16`` for 1 epoch on the SPRITES clips made before,
    under ``torch.profiler``, beside the fp32 epoch of "sprites from
    config"."""
    import yaml
    from torch.profiler import ProfilerActivity, profile
    from multimodal_vae_comparison_tpu_torch.eval.infer import MultimodalVAEInfer
    from multimodal_vae_comparison_tpu_torch.main import cli
    from multimodal_vae_comparison_tpu_torch.training.trainer import Trainer
    numbers, total, kinds = {"card": card}, {}, {}
    os.environ["CDSPRITES_CLASSIFIER_DIR"] = os.path.join(root, "judges")
    path = "configs/round5/cdl1_r5_poe.yml"
    with open(os.path.join(HERE, path)) as f:
        params = yaml.safe_load(f)
    for key, block in cdsprites_paths(data).items():
        params[key].update(block)
    params.update(iterseeds=1, epochs=1, exp_name="cdl1_r5_poe_bf16")
    yml = os.path.join(root, "cdl1_r5_poe_bf16.yml")
    with open(yml, "w") as f:
        yaml.safe_dump(params, f)
    stats, runs = {}, {}
    original_test = Trainer.test

    def test_and_keep(self):
        stats.clear()
        stats.update(original_test(self))
        return stats

    cwd = os.getcwd()
    os.chdir(root)
    Trainer.test = test_and_keep
    try:
        for precision in ("32", "bf16"):
            probe = Trainer(from_config(path, cdsprites_paths(data), os.path.join(
                root, "probe"), eval_only=False, precision=precision, iterseeds=1,
                epochs=1), enable_viz=False)
            probe.init_state()
            untrained = probe.validate(0)["val_loss"]
            dm, bs = probe.datamodule, probe.cfg.batch_size
            steps, val_batches = dm.n_train // bs, dm.n_val // bs
            del probe
            args = ["--cfg", yml, "--precision", precision, "--no_viz"]
            if precision == "32":
                args += ["--exp_name", "cdl1_r5_poe_fp32"]
            trainer = counted(f"POE cdl1_r5_poe precision {precision}", "poe",
                              steps + 2 * val_batches, steps, lambda: cli(args), total,
                              eval_launches("poe", dm.n_train), kinds=kinds)
            check_stats(f"bf16 cdl1_r5_poe {precision}", stats)
            rows = _csv_rows(os.path.join(trainer.cfg.mPath, "metrics.csv"))
            trained = float(rows[-1]["val_loss"])
            check(np.isfinite(trained) and trained < untrained,
                  f"cdl1_r5_poe precision {precision}: val_loss {trained}, untrained {untrained}")
            dt = torch.bfloat16 if precision == "bf16" else torch.float32
            check(trainer.model.dtype == dt and all(
                p.dtype == torch.float32 for p in trainer.model.parameters()),
                f"cdl1_r5_poe precision {precision}: model {trainer.model.dtype}")
            runs[precision] = {"val_loss_untrained": untrained, "val_loss": trained,
                               "epoch_s": float(rows[-1]["epoch_time_s"]),
                               "samples_per_s": float(rows[-1]["samples_per_s"]),
                               "stats": {k: v for k, v in stats.items()
                                         if not k.startswith("val_")}}
            if precision == "bf16":
                infer = MultimodalVAEInfer(trainer.cfg.mPath)
                live = MultimodalVAEInfer.from_trainer(trainer)
                check(infer.model.dtype == live.model.dtype == torch.float32,
                      "the restored bf16 run is not fp32")
                for (n, a), b in zip(infer.model.state_dict().items(),
                                     trainer.model.state_dict().values()):
                    check(torch.equal(a, b), f"bf16 cdl1_r5_poe: restored {n} differs")
                batch = next(dm.batches("val"))
                eps = eps_to(np.random.default_rng(79).standard_normal(
                    (1, bs, trainer.cfg.n_latents)).astype(np.float32), trainer.device)
                live.model.eval()
                live.model.K = 1
                with torch.inference_mode():
                    got = infer.forward(batch, trainer.model.mod_names, eps=eps)
                    want = live.model.forward(torch_batch(batch, trainer.device),
                                              trainer.model.mod_names, eps=eps)
                err = max((got.mods[n].decoder_dist.mean - want.mods[n].decoder_dist.mean)
                          .abs().max().item() for n in trainer.model.mod_names)
                check(err <= RESTORE_ATOL + RESTORE_RTOL, f"bf16 cdl1_r5_poe: the restored "
                      f"fp32 forward differs by {err}")
                runs[precision]["restore_fp32_max_abs_err"] = err
            print(f"bf16 from config cdl1_r5_poe --precision {precision}: {dm.n_train} train "
                  f"rows, {steps} steps of {bs}; val_loss {untrained:.2f} -> {trained:.2f}; "
                  f"epoch {runs[precision]['epoch_s']:.3f} s, "
                  f"{runs[precision]['samples_per_s']:.1f} samples/s; stats "
                  + ", ".join(f"{k} {v:.2f}" for k, v in runs[precision]["stats"].items())
                  + f" on {card}")
            del trainer
    finally:
        Trainer.test = original_test
        os.chdir(cwd)
        os.environ.pop("CDSPRITES_CLASSIFIER_DIR")
    numbers["cdl1_r5_poe"] = runs
    # sprites_r4_dreg_up, one epoch in bf16 on the clips of "sprites from config"
    config, trainer, _ = config_trainer("MOE sprites_r4_dreg_up bf16",
                                        "configs/round4/sprites_r4_dreg_up.yml", "moe",
                                        sprites_paths(sprites_dir), root, 1,
                                        edit=lambda p: p.update(precision="bf16"))
    check(trainer.model.dtype == torch.bfloat16, "sprites bf16: the model is not bf16")
    dm, bs = trainer.datamodule, config.batch_size
    steps, val_batches = dm.n_train // bs, dm.n_val // bs
    trainer.stage_epoch_data()
    trainer.stage_val_data()
    untrained = trainer.validate_scan(0)["val_loss"]
    profiled = {}

    def run():
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            trainer.fit(epochs=1)
            torch.cuda.synchronize()
            profiled["wall_ms"] = (time.perf_counter() - t0) * 1e3
        profiled.update(device_activity(prof, profiled["wall_ms"]))

    counted("MOE sprites_r4_dreg_up bf16", "moe", steps + val_batches, steps, run, total,
            tables=(SPRITES_PER_OBJECTIVE, SPRITES_PER_BACKWARD), kinds=kinds)
    trained = trainer.validate_scan(1)["val_loss"]
    check(np.isfinite(trained) and trained < untrained,
          f"sprites bf16: val_loss {trained}, untrained {untrained}")
    fp32 = sprites_fp32.get("MOE sprites_r4_dreg_up", {})
    fp32_epoch = (fp32.get("epochs") or [{}])[0].get("epoch_time_s")
    numbers["sprites_r4_dreg_up"] = {
        "epoch_wall_s": profiled["wall_ms"] / 1e3, "device_ms": profiled["ms"],
        "busy_share": profiled["busy_share"], "val_loss_untrained": untrained,
        "val_loss": trained, "fp32_epoch_s": fp32_epoch,
        "fp32_device_ms": fp32.get("profiled_epoch_device_ms"),
        "top_kernels_ms": {n[:80]: ms for n, ms in profiled["ms_by_name"].most_common(6)}}
    print(f"bf16 from config sprites_r4_dreg_up: {steps} steps of {bs}; val_loss "
          f"{untrained:.2f} -> {trained:.2f}; epoch {profiled['wall_ms'] / 1e3:.3f} s, "
          f"{profiled['ms']:.1f} device ms, busy {profiled['busy_share']:.4f} (fp32: epoch "
          f"{fp32_epoch} s, {fp32.get('profiled_epoch_device_ms')} device ms); the largest by "
          f"device ms " + json.dumps(numbers["sprites_r4_dreg_up"]["top_kernels_ms"])
          + f" on {card}")
    del trainer
    # the bf16 runs' attention on the bf16 tensor-core kernel: the text
    # encoder and decoders of cdl1_r5_poe, SPRITES' H and W axes
    numbers["launches_by_variant"] = kinds
    print(f"bf16 from config launches by variant and dtype: {kinds}")
    check(kinds.get("attention:tc_bf16:bfloat16", 0) > 0,
          f"bf16 from config: no attention launch took the bf16 tensor-core kernel: {kinds}")
    return total, numbers


# -- the numerics policy: seeded reruns, and its cost -----------------------------

# the port's numerics (device.set_numerics) as every flag must read once an
# entry point has resolved the card, and PyTorch's own in a new process
POLICY_FLAGS = {"matmul.allow_tf32": False, "cudnn.allow_tf32": False,
                "cudnn.deterministic": True, "cudnn.benchmark": False}
PYTORCH_DEFAULT_FLAGS = {"matmul.allow_tf32": False, "cudnn.allow_tf32": True,
                         "cudnn.deterministic": False, "cudnn.benchmark": False}
# the checks' numerics before the policy: TF32 off, cuDNN's algorithms free
FREE_ALGORITHM_FLAGS = {"matmul.allow_tf32": False, "cudnn.allow_tf32": False,
                        "cudnn.deterministic": False, "cudnn.benchmark": False}
# train steps of each in-process rerun; the configs of the CLI children and
# of the SPRITES and ResNet-50 reruns (the video model is bench.py's)
SEEDED_STEPS = 3
SEEDED_CLI_CONFIG = "configs/round5/cdl1_r5_poe.yml"
SEEDED_SPRITES = "configs/round4/sprites_r4_dreg_up.yml"
SEEDED_RESNET = "configs/reproduce_paper/mopoe/level1/level1_0.yml"
# ops whose outputs are memory not yet written: their bits are whatever the
# allocator held, so the op tracer leaves them out
_UNWRITTEN_OPS = {"empty", "empty_strided", "new_empty", "new_empty_strided", "empty_like",
                  "resize_", "set_"}


def numerics_flags() -> dict:
    """The flags of the numerics policy as they read now."""
    return {"matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
            "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
            "cudnn.deterministic": torch.backends.cudnn.deterministic,
            "cudnn.benchmark": torch.backends.cudnn.benchmark}


@contextlib.contextmanager
def numerics_under(flags: dict):
    """The block under other cuDNN numerics than the policy's (``flags``, in
    :func:`numerics_flags`' keys; the matmuls' TF32 stays off): an arm of
    the policy's cost.  No entry point may run in the block, since each sets
    the policy: the flags are checked at its end."""
    with torch.backends.cudnn.flags(enabled=True, benchmark=flags["cudnn.benchmark"],
                                    deterministic=flags["cudnn.deterministic"],
                                    allow_tf32=flags["cudnn.allow_tf32"]):
        yield
        check(numerics_flags() == flags, f"{flags} did not hold through the block: "
              f"{numerics_flags()}")


def pytorch_defaults():
    """PyTorch's numerics in a new process (cuDNN's TF32 on, its algorithms
    chosen freely, not only the deterministic ones)."""
    return numerics_under(PYTORCH_DEFAULT_FLAGS)


def free_algorithms():
    """TF32 off with cuDNN's algorithms chosen freely: what every check ran
    under before the policy."""
    return numerics_under(FREE_ALGORITHM_FLAGS)


def _bits_print(t):
    """Two int64 sums of a tensor's bits, plain and weighted by position, on
    its device (None for what has no plain bits): two runs whose prints
    agree computed the same bits, but for a collision."""
    if (not isinstance(t, torch.Tensor) or t.layout != torch.strided or t.is_complex()
            or t.device.type == "meta"):
        return None
    x = t.detach().reshape(-1)
    if x.dtype.is_floating_point:
        x = x.view({1: torch.int8, 2: torch.int16, 4: torch.int32,
                    8: torch.int64}[x.element_size()])
    x = x.to(torch.int64)
    w = torch.arange(1, x.numel() + 1, device=x.device, dtype=torch.int64) % 65521
    return torch.stack([x.sum(), (x * w).sum()])


def op_tracer():
    """A ``TorchDispatchMode`` that records every aten op run under it, the
    autograd backward's too: its name and the bits prints of its inputs
    (taken before it runs) and outputs.  ``rows()`` gives them as
    ``(op, input prints, output prints)``."""
    from torch.utils import _pytree as pytree
    from torch.utils._python_dispatch import TorchDispatchMode

    class OpTracer(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops, self.prints = [], []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if func.overloadpacket.__name__ in _UNWRITTEN_OPS:
                return func(*args, **kwargs)
            ins = [p for p in map(_bits_print, pytree.tree_leaves((args, kwargs)))
                   if p is not None]
            out = func(*args, **kwargs)
            outs = [p for p in map(_bits_print, pytree.tree_leaves(out)) if p is not None]
            self.ops.append((str(func), len(ins), len(outs)))
            self.prints += ins + outs
            return out

        def rows(self):
            values, by_device = [None] * len(self.prints), {}
            for i, p in enumerate(self.prints):
                by_device.setdefault(p.device, []).append(i)
            for idx in by_device.values():
                got = torch.stack([self.prints[i] for i in idx]).cpu().tolist()
                for i, v in zip(idx, got):
                    values[i] = tuple(v)
            rows, at = [], 0
            for name, n_in, n_out in self.ops:
                rows.append((name, values[at:at + n_in], values[at + n_in:at + n_in + n_out]))
                at += n_in + n_out
            return rows

    return OpTracer()


def first_differing_op(a: list, b: list):
    """The first op of two traced runs (:func:`op_tracer`'s rows) whose
    outputs differ, and what its inputs say of the cause; None when every
    output agreed.  An op whose inputs differ while every earlier op's
    outputs agreed read a value written outside the dispatcher: by a
    hand-written kernel, or copied from the host."""
    for i, ((na, ia, oa), (nb, ib, ob)) in enumerate(zip(a, b)):
        if na != nb:
            return f"op {i}: {na} in one run, {nb} in the other"
        if oa != ob:
            if ia == ib:
                return f"op {i} {na}: the same inputs gave other outputs"
            return (f"op {i} {na}: its inputs differ while every earlier op's outputs "
                    "agreed (written outside the dispatcher: a hand-written kernel or a "
                    "copy from the host)")
    if len(a) != len(b):
        return f"the runs ran {len(a)} and {len(b)} ops"
    return None


def _leaves(model, opt) -> dict:
    """Every parameter, gradient, buffer and optimizer state entry, cloned."""
    out = {}
    for n, p in model.named_parameters():
        out[f"param {n}"] = p.detach().clone()
        if p.grad is not None:
            out[f"grad {n}"] = p.grad.detach().clone()
    out.update({f"buffer {n}": b.detach().clone() for n, b in model.named_buffers()})
    for i, state in opt.state_dict()["state"].items():
        for k, v in state.items():
            out[f"opt {i} {k}"] = v.detach().clone() if torch.is_tensor(v) else v
    return out


def _leaf_prints(leaves: dict) -> dict:
    """Each leaf's bits print (:func:`_bits_print`) as a list, or its value."""
    return {k: (_bits_print(v).tolist() if torch.is_tensor(v) else v)
            for k, v in leaves.items()}


def _batch_device(batch) -> torch.device:
    return next(iter(batch.values()))["data"].device


def _seeded_steps(build, batch, steps: int, each=None, trace_at=None):
    """``steps`` train steps of a fresh ``build()`` ((model, optimizer, step))
    on ``batch``, the draws from a generator seeded 0 on the batch's
    device: ``each(i, leaves)`` after step i; with ``trace_at`` the traced
    rows of that step (and no later one)."""
    model, opt, step = build()
    gen = torch.Generator(device=_batch_device(batch)).manual_seed(0)
    for i in range(steps):
        if i == trace_at:
            with op_tracer() as tracer:
                step(batch, generator=gen)
            return tracer.rows()
        step(batch, generator=gen)
        if each is not None:
            each(i, _leaves(model, opt))
    return None


def nondeterministic_ops(build, batch) -> list:
    """The ops of one train step for which PyTorch has no deterministic CUDA
    kernel: the step under ``torch.use_deterministic_algorithms(True,
    warn_only=True)``, whose warnings name them (cuBLAS's workspace notice
    left out: one stream, one workspace, as every step here)."""
    import warnings
    model, opt, step = build()
    gen = torch.Generator(device=_batch_device(batch)).manual_seed(0)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            step(batch, generator=gen)
            if gen.device.type == "cuda":
                torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    return sorted({str(w.message).split(" does not have a deterministic")[0]
                   for w in caught if "does not have a deterministic" in str(w.message)})


def seeded_rerun(label: str, build, batch) -> dict:
    """The same SEEDED_STEPS seeded steps twice in this process: after each
    step every leaf of the second run (:func:`_leaves`) must equal the
    first's bit for bit.  Where one differs, both runs are traced at that
    step to name the first op whose outputs differ
    (:func:`first_differing_op`) and the ops without a deterministic CUDA
    kernel (:func:`nondeterministic_ops`), and the check fails."""
    t0 = time.perf_counter()
    first, diff = [], []
    _seeded_steps(build, batch, SEEDED_STEPS, each=lambda i, leaves: first.append(leaves))

    def compare(i, leaves):
        for k, v in first[i].items():
            same = torch.equal(v, leaves[k]) if torch.is_tensor(v) else v == leaves[k]
            if not diff and not same:
                diff.append((i, k))
    _seeded_steps(build, batch, SEEDED_STEPS, each=compare)
    n_leaves = len(first[0])
    prints = _leaf_prints(first[-1])
    del first
    out = {"steps": SEEDED_STEPS, "leaves": n_leaves, "bit_equal": not diff, "prints": prints}
    if diff:
        at, leaf = diff[0]
        out.update(first_step=at, first_leaf=leaf, first_op=first_differing_op(
            _seeded_steps(build, batch, at + 1, trace_at=at),
            _seeded_steps(build, batch, at + 1, trace_at=at)),
            nondeterministic_ops=nondeterministic_ops(build, batch))
    out["s"] = time.perf_counter() - t0
    print(f"seeded reruns {label}: {SEEDED_STEPS} steps twice, {n_leaves} leaves after each "
          + ("bit for bit equal" if not diff else
             f"DIFFER from step {out['first_step']} at {out['first_leaf']}; first differing "
             f"op: {out['first_op']}; ops without a deterministic CUDA kernel: "
             f"{out['nondeterministic_ops']}")
          + f"; {out['s']:.1f} s")
    check(not diff, f"seeded reruns {label}: step {diff and diff[0]} differs; "
          f"{out.get('first_op')}; {out.get('nondeterministic_ops')}")
    return out


def seeded_builds(sprites_dir: str, root: str):
    """The in-process reruns' paths, each in fp32 and bf16: ((label, build,
    batch), ...).  The SPRITES MOE of SEEDED_SPRITES (3-D convs, DReG K 5)
    on a batch of the clips in ``sprites_dir``; bench.py's VideoGPTSparse
    MOE DReG step (bs 8, K 5, remat); the ResNet-50 MoPoE of SEEDED_RESNET
    and the POE of SEEDED_CLI_CONFIG (the flagship's nets and kernels) on
    the same TRAIN_BATCH rows.  Each build is a config's model, its optimizer and
    ``make_train_step``, as the Trainer makes them."""
    from multimodal_vae_comparison_tpu_torch.data.datamodule import DataModule
    from multimodal_vae_comparison_tpu_torch.training.optim import make_optimizer
    from multimodal_vae_comparison_tpu_torch.training.trainer import (
        build_model, build_model_from_config, make_train_step)

    def from_cfg(cfg, dtype):
        def build():
            model = build_model_from_config(cfg, device="cuda", dtype=dtype)
            opt = make_optimizer(cfg.optimizer, cfg.lr, model.parameters())
            return model, opt, make_train_step(model, opt)
        return build

    def video(dtype):
        def build():
            model = build_model(video_specs(), "moe", VIDEO_LATENTS, obj="dreg", K=VIDEO_K,
                                seed=0, device="cuda", remat=True, dtype=dtype)
            opt = make_optimizer("adam", VIDEO_LR, model.parameters())
            return model, opt, make_train_step(model, opt)
        return build

    sprites = from_config(SEEDED_SPRITES, sprites_paths(sprites_dir), root, eval_only=True)
    dm = DataModule(sprites)
    dm.setup()
    sprites_batch = torch_batch(next(dm.batches("train")), "cuda")
    resnet, poe = paper_config(SEEDED_RESNET), paper_config(SEEDED_CLI_CONFIG)
    rows = torch_batch(make_inputs(np.random.default_rng(91), TRAIN_BATCH), "cuda")
    video_batch = torch_batch(video_inputs(np.random.default_rng(92), VIDEO_BATCH,
                                           VIDEO_K)[0], "cuda")
    out = []
    for name, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        out += [(f"SPRITES MOE sprites_r4_dreg_up {name}", from_cfg(sprites, dtype),
                 sprites_batch),
                (f"VideoGPTSparse MOE dreg {name}", video(dtype), video_batch),
                (f"ResNet-50 MoPoE {name}", from_cfg(resnet, dtype), rows),
                (f"POE cdl1_r5_poe {name}", from_cfg(poe, dtype), rows)]
    return out


def seeded_cli_children(card: str, root: str, data) -> dict:
    """Two plain ``python -m multimodal_vae_comparison_tpu_torch.main``
    children, started together, each train SEEDED_CLI_CONFIG for 1 epoch on
    the same rows of ``data`` (:func:`make_cdsprites`'s level) from its own
    directory with its own judges directory, so that each ``test()`` trains
    its own judge: their checkpoints, judge weights and stats files must be
    equal byte for byte.  The children set the numerics themselves: nothing
    of this process's reaches them."""
    import yaml
    with open(os.path.join(HERE, SEEDED_CLI_CONFIG)) as f:
        params = yaml.safe_load(f)
    for key, block in cdsprites_paths(data).items():
        params[key].update(block)
    params.update(iterseeds=1, epochs=1, exp_name="seeded")
    yml = os.path.join(root, "seeded_cli.yml")
    with open(yml, "w") as f:
        yaml.safe_dump(params, f)
    dirs = [os.path.join(root, f"seeded_cli_{i}") for i in range(2)]
    procs = []
    t0 = time.perf_counter()
    for d in dirs:
        os.makedirs(d)
        env = {k: v for k, v in os.environ.items() if not k.endswith("_CLASSIFIER_DIR")}
        env.update(CDSPRITES_CLASSIFIER_DIR=os.path.join(d, "judges"),
                   PYTHONPATH=os.pathsep.join([HERE] + [p for p in [env.get("PYTHONPATH")] if p]))
        log = open(os.path.join(d, "log.txt"), "w")
        procs.append((subprocess.Popen(
            module_argv("multimodal_vae_comparison_tpu_torch.main", "--cfg", yml, "--no_viz"),
            cwd=d, env=env, stdout=log, stderr=subprocess.STDOUT, stdin=subprocess.DEVNULL),
            log))
    return {"dirs": dirs, "procs": procs, "t0": t0, "card": card}


def check_seeded_cli_children(started: dict) -> dict:
    """Wait for :func:`seeded_cli_children` and hold their files byte for
    byte."""
    import filecmp
    dirs = started["dirs"]
    for (proc, log), d in zip(started["procs"], dirs):
        try:
            code = proc.wait(timeout=900)
        finally:
            log.close()
            if proc.poll() is None:
                proc.kill()
        with open(os.path.join(d, "log.txt")) as f:
            text = f.read()
        check(code == 0, f"seeded reruns: the CLI child in {d} exited {code}:\n{text[-3000:]}")
    seconds = time.perf_counter() - started["t0"]
    run = os.path.join("results", "seeded", "version_0")
    files = [os.path.join(run, "model", tag, "state.pt") for tag in ("last", "best")]
    files.append(os.path.join(run, "cdspritesplus_stats.txt"))
    judges = sorted(os.listdir(os.path.join(dirs[0], "judges")))
    check(judges and judges == sorted(os.listdir(os.path.join(dirs[1], "judges"))),
          f"seeded reruns: the children wrote other judges: {judges}")
    files += [os.path.join("judges", j) for j in judges]
    for rel in files:
        a, b = (os.path.join(d, rel) for d in dirs)
        check(os.path.isfile(a) and filecmp.cmp(a, b, shallow=False),
              f"seeded reruns: {rel} differs between the two CLI children")
    with open(os.path.join(dirs[0], files[2])) as f:
        stats = f.read()
    print(f"seeded reruns: two plain `python -m multimodal_vae_comparison_tpu_torch.main` "
          f"children, {SEEDED_CLI_CONFIG} 1 epoch on the same rows, each training its own "
          f"judge, in {seconds:.1f} s together: " + ", ".join(files)
          + " equal byte for byte; stats " + "; ".join(stats.strip().splitlines())
          + f" on {started['card']}")
    return {"cli_children_s": seconds, "files_equal": files}


def phase_seeded_reruns(card: str, root: str, small, sprites_dir: str) -> dict:
    """A seeded run reproduces on the card, across processes and within
    one: the two CLI children of :func:`seeded_cli_children` and a
    :func:`seeded_prints` child (all started first, checked last), and in
    between the in-process reruns of :func:`seeded_builds` in fp32 and bf16,
    bit for bit leaf by leaf (:func:`seeded_rerun`); the child's prints of
    every leaf after the reruns' steps must be this process's."""
    t0 = time.perf_counter()
    started = seeded_cli_children(card, root, small)
    prints_log = open(os.path.join(root, "seeded_prints.txt"), "w")
    started["procs"].append((subprocess.Popen(
        [sys.executable, os.path.join(HERE, "chip_smoke.py"), "seeded_prints"], cwd=root,
        stdout=prints_log, stderr=subprocess.STDOUT, stdin=subprocess.DEVNULL), prints_log))
    numbers = {"card": card}
    try:
        for label, build, batch in seeded_builds(sprites_dir, root):
            numbers[label] = seeded_rerun(label, build, batch)
    except BaseException:
        for proc, log in started["procs"]:
            proc.kill()
            proc.wait(timeout=60)
            log.close()
        raise
    prints_proc, _ = started["procs"].pop()
    try:
        code = prints_proc.wait(timeout=600)
    finally:
        prints_log.close()
    with open(os.path.join(root, "seeded_prints.txt")) as f:
        lines = [line for line in f if line.startswith("seeded prints ")]
    check(code == 0 and lines, f"seeded reruns: the seeded_prints child exited {code}; its "
          f"log is {os.path.join(root, 'seeded_prints.txt')}")
    other = json.loads(lines[-1][len("seeded prints "):])
    check(sorted(other) == sorted(k for k in numbers if k != "card"),
          f"seeded reruns: the seeded_prints child ran {sorted(other)}")
    for label, got in other.items():
        want = numbers[label].pop("prints")
        differ = [k for k in want if got.get(k) != want[k]]
        print(f"seeded reruns {label}: another process's {len(got)} leaves after "
              f"{SEEDED_STEPS} steps " + ("bit for bit this one's" if not differ
                                          else f"DIFFER at {differ[:3]}"))
        check(not differ and len(got) == len(want),
              f"seeded reruns {label}: another process's leaves differ at {differ[:3]}")
        numbers[label]["across_processes_bit_equal"] = True
    numbers.update(check_seeded_cli_children(started))
    numbers["phase_s"] = time.perf_counter() - t0
    return numbers


def _abba(run, other, names) -> dict:
    """``run()`` (seconds or ms) as it stands and under ``other()`` (a
    context) in turns: one warm call of each, then A, B, B, A.
    {names[0]: [t, t], names[1]: [t, t], "<names[0]>_over_<names[1]>":
    the ratio of their means}."""
    out = {name: [] for name in names}
    for i, arm in enumerate((0, 1, 0, 1, 1, 0)):
        with other() if arm else contextlib.nullcontext():
            t = run()
        if i >= 2:
            out[names[arm]].append(t)
    out[f"{names[0]}_over_{names[1]}"] = (statistics.mean(out[names[0]])
                                          / statistics.mean(out[names[1]]))
    return out


def cost_arms(run, fp32: bool, blocks: bool) -> dict:
    """:func:`_abba` of ``run`` under the policy against PyTorch's defaults;
    in fp32 also against TF32 off with cuDNN's algorithms free (the cost of
    the deterministic algorithms alone); with ``blocks`` also against one
    weight-gradient call (:func:`one_wgrad_block`), under the policy."""
    out = {"against_defaults": _abba(run, pytorch_defaults, ("policy", "defaults"))}
    if fp32:
        out["against_free_algorithms"] = _abba(run, free_algorithms,
                                               ("policy", "free_algorithms"))
    if blocks:
        out["against_one_wgrad_block"] = _abba(run, one_wgrad_block, ("blocks", "one_block"))
    return out


@contextlib.contextmanager
def one_wgrad_block():
    """3-D transposed convs take their weight gradient in one call for the
    block (``models.precision.WGRAD_ROWS`` past any batch)."""
    from multimodal_vae_comparison_tpu_torch.models import precision
    rows = precision.WGRAD_ROWS
    precision.WGRAD_ROWS = 1 << 30
    try:
        yield
    finally:
        precision.WGRAD_ROWS = rows


def _epoch_s(trainer) -> float:
    """Seconds of one resident epoch of ``trainer`` and its validation, as
    ``fit`` times an epoch (both end in host reads)."""
    t0 = time.perf_counter()
    trainer.run_epoch_scan(0)
    trainer.validate_scan(0)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def numerics_cost() -> int:
    """What the numerics policy costs: in one process, epochs and steps
    timed in turns under the port's numerics (fp32 without TF32, cuDNN's
    deterministic algorithms) and under PyTorch's defaults in a new process
    (cuDNN's TF32 on, its algorithms chosen freely; :func:`_abba`):

        python3 chip_smoke.py numerics_cost

    the SPRITES MOE epoch (SEEDED_SPRITES on the generator's clips) in fp32
    and bf16, bench.py's VideoGPTSparse step (bs 8, K 5) p50 in fp32 and
    bf16, the flagship POE and MOE fp32 steps (:func:`training_models`) p50
    at STEP_BATCHES, a ``cdl1_r5_poe`` epoch on COST_DATA_COUNT rows and a
    ResNet-50 MoPoE epoch (SEEDED_RESNET) on ZOO_DATA_COUNT rows
    (:func:`cost_arms`: the fp32 ones also against TF32 off with cuDNN's
    algorithms free, and the fp32 SPRITES epoch and video step against their
    3-D transposed convs' weight gradient in one call).  Prints one
    ``numerics cost`` JSON line beside the card's name and power limit."""
    if not torch.cuda.is_available():
        print("chip_smoke numerics_cost: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from multimodal_vae_comparison_tpu_torch.device import resolve_device
    from multimodal_vae_comparison_tpu_torch.ops.kernels import _build
    from multimodal_vae_comparison_tpu_torch.training.optim import make_optimizer
    from multimodal_vae_comparison_tpu_torch.training.trainer import (
        build_model, make_train_step)
    card = card_line()
    print(card)
    resolve_device()
    check(numerics_flags() == POLICY_FLAGS, f"numerics {numerics_flags()}")
    _build.build()
    rows = {"card": card}

    def epochs(label, path, mixing, data_paths, root, precision="32", blocks=False):
        _, trainer, _ = config_trainer(label, path, mixing, data_paths, root, 1,
                                       edit=lambda p: p.update(precision=precision))
        trainer.stage_epoch_data()
        trainer.stage_val_data()
        rows[f"{label}, epoch s"] = cost_arms(lambda: _epoch_s(trainer), precision == "32",
                                              blocks)
        print(f"numerics cost {label}, epoch s: {rows[f'{label}, epoch s']} on {card}")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_cost_") as tmp:
        sprites_dir, _ = make_sprites(os.path.join(tmp, "sprites"))
        for precision in ("32", "bf16"):
            epochs(f"SPRITES MOE sprites_r4_dreg_up precision {precision}", SEEDED_SPRITES,
                   "moe", sprites_paths(sprites_dir), tmp, precision, precision == "32")
        batch = torch_batch(video_inputs(np.random.default_rng(23), VIDEO_BATCH,
                                         VIDEO_K)[0], "cuda")
        for dtype in (torch.float32, torch.bfloat16):
            model = build_model(video_specs(), "moe", VIDEO_LATENTS, obj="dreg", K=VIDEO_K,
                                seed=0, device="cuda", remat=True, dtype=dtype)
            step = make_train_step(model, make_optimizer("adam", VIDEO_LR, model.parameters()))
            gen = torch.Generator(device="cuda").manual_seed(24)
            label = (f"VideoGPTSparse MOE dreg step bs {VIDEO_BATCH} K {VIDEO_K} {dtype}, "
                     "p50 ms")
            fp32 = dtype == torch.float32
            rows[label] = cost_arms(lambda: _p50_step_ms(step, batch, gen, 10), fp32, fp32)
            print(f"numerics cost {label}: {rows[label]} on {card}")
            del model, step
        for name, mixing, obj in training_models():
            for n in STEP_BATCHES:
                batch = torch_batch(make_inputs(np.random.default_rng(73), n), "cuda")
                model = build_model(flagship_specs(), mixing, N_LATENTS, obj=obj, seed=0,
                                    device="cuda")
                step = make_train_step(model, make_optimizer("adam", TRAIN_LR,
                                                             model.parameters()))
                gen = torch.Generator(device="cuda").manual_seed(74)
                label = f"{name} step bs {n} fp32, p50 ms"
                rows[label] = cost_arms(lambda: _p50_step_ms(step, batch, gen), True, False)
                print(f"numerics cost {label}: {rows[label]} on {card}")
                del model, step
        data = make_cdsprites(os.path.join(tmp, "data"), COST_DATA_COUNT)
        epochs(f"POE cdl1_r5_poe ({COST_DATA_COUNT} rows)", SEEDED_CLI_CONFIG, "poe",
               cdsprites_paths(data), tmp)
        small = make_cdsprites(os.path.join(tmp, "small"), ZOO_DATA_COUNT)
        epochs(f"ResNet-50 MoPoE level1_0 ({ZOO_DATA_COUNT} rows)", SEEDED_RESNET, "mopoe",
               cdsprites_paths(small), tmp)
    print(card)
    print("numerics cost " + json.dumps(rows))
    return 0


def seeded_prints() -> int:
    """The in-process reruns' paths (:func:`seeded_builds`) once each in
    this process, SEEDED_STEPS steps: one JSON line of every leaf's bits
    print after the last step, which "seeded reruns" holds against its own
    process's (two processes' lines equal: the paths reproduce across
    processes):

        python3 chip_smoke.py seeded_prints"""
    if not torch.cuda.is_available():
        print("chip_smoke seeded_prints: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from multimodal_vae_comparison_tpu_torch.device import resolve_device
    resolve_device()
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_prints_") as tmp:
        sprites_dir, _ = make_sprites(os.path.join(tmp, "sprites"))
        for label, build, batch in seeded_builds(sprites_dir, tmp):
            last = {}
            _seeded_steps(build, batch, SEEDED_STEPS,
                          each=lambda i, leaves: last.update(leaves))
            out[label] = _leaf_prints(last)
    print("seeded prints " + json.dumps(out))
    return 0


MULTI_TIMED_STEPS = 10
MULTI_GLOO_RANKS = 2
MULTI_DEADLINE = 300.0


def _multi_reference(mixing: str, raw, eps):
    """The one-process flagship step of ``mixing`` on the card: (metrics,
    numpy grads, p50 ms of MULTI_TIMED_STEPS more steps, the relu branches
    of its checked step on the CPU, :func:`same_branches`)."""
    from multimodal_vae_comparison_tpu_torch.parallel.dryrun import step_ms_p50
    from multimodal_vae_comparison_tpu_torch.training.optim import make_optimizer
    from multimodal_vae_comparison_tpu_torch.training.trainer import (
        build_model, make_train_step)
    model = build_model(flagship_specs(), mixing, N_LATENTS, seed=0, device="cuda")
    step = make_train_step(model, make_optimizer("adam", TRAIN_LR, model.parameters()))
    batch, gen = torch_batch(raw, "cuda"), torch.Generator(device="cuda").manual_seed(0)
    branches = []
    with same_branches(branches, False, {}):
        metrics = {k: float(v) for k, v in step(batch, eps=eps_to(eps, "cuda"),
                                                generator=gen).items()}
    grads = {n: p.grad.cpu().numpy() for n, p in model.named_parameters()
             if p.grad is not None}
    return metrics, grads, step_ms_p50(step, batch, eps_to(eps, "cuda"), gen,
                                       MULTI_TIMED_STEPS), [b.cpu() for b in branches]


def steps_on_branches(ctx, jobs, branches):
    """A rank's ``parallel.dryrun.run_steps`` with the checked step of job
    i on this rank's rows of ``branches[i]``, the relu branches the
    one-process step took on the whole batch (each tensor's rows are the
    ranks' blocks in rank order, as the flagship's encoders and lattice
    decodes lay them out), the timed steps after it on their own.  Returns
    (None, [each job's result with its "relu_flips"]): the elements where
    the rank's own branch differs, inputs within rounding of a kink that
    the rank's convs (at its batch) put on the other side."""
    from multimodal_vae_comparison_tpu_torch.parallel.dryrun import train_step_on_mesh
    results = []
    for job, recorded in zip(jobs, branches):
        flips = {}
        mine = [t.chunk(ctx.world_size, 0)[ctx.rank] for t in recorded]
        with same_branches(mine, True, flips):
            out = train_step_on_mesh(ctx, job)
        out["relu_flips"] = flips.get("relu", 0)
        results.append(out)
    return None, results


def world_one_group(ctx, fn, *args):
    """``fn(ctx, *args)`` in a process group of this process alone (a
    file rendezvous in a temporary directory), destroyed after."""
    import torch.distributed as dist
    with tempfile.TemporaryDirectory(prefix="chip_smoke_pg_") as tmp:
        dist.init_process_group(ctx.backend, init_method=f"file://{tmp}/rendezvous",
                                rank=0, world_size=1)
        try:
            return fn(ctx, *args)
        finally:
            dist.destroy_process_group()


def phase_multi_device(card: str):
    """Multi-device training on the one card (not scaling: one card).

    (a) a world-1 NCCL group on cuda:0, made in this process, runs the
    flagship POE and MOE steps through the data-parallel path, bit for bit
    the one-process steps (both under the port's numerics, whose cuDNN
    algorithms are deterministic); (b) two gloo ranks on
    the card run the same steps at bs TRAIN_BATCH, each on its 12 rows and
    on the relu branches the one-process step took there
    (:func:`steps_on_branches`; a conv at half the batch may round an input
    within rounding of 0 to the kink's other side, and one such element
    moves its layer's gradient by about 1e-2 of max |g|), the gradients
    summed: within the training limit of the one-process step, each rank
    launching attention, PoE and KL at its rows and taking no plain version; (c) ``dryrun_multichip(4)`` on four gloo ranks (the
    2x2 hybrid mesh, megatron-sharded DTensor parameters).  Returns rank
    0's launches over (b) and the phase's numbers."""
    from multimodal_vae_comparison_tpu_torch.parallel.dryrun import (
        StepJob, dryrun_multichip, run_steps)
    from multimodal_vae_comparison_tpu_torch.parallel.launch import Rank, launch
    t_phase = time.perf_counter()
    rng = np.random.default_rng(31)
    raw = make_inputs(rng, TRAIN_BATCH)
    raw["mod_1"]["masks"] = None
    eps = {mixing: numpy_eps(rng, mixing, TRAIN_BATCH) for mixing in ("poe", "moe")}
    numbers = {"note": "not scaling: one card", "card": card, "batch": TRAIN_BATCH}
    launches = {}
    for label, world, backend in (("world-1 nccl", 1, "nccl"),
                                  (f"{MULTI_GLOO_RANKS} gloo ranks", MULTI_GLOO_RANKS, "gloo")):
        # one rank sums as one process does: bit for bit; two ranks sum
        # their halves' gradients in another order: within the training limit
        bit_equal = world == 1
        jobs = [StepJob(flagship_specs(), raw, mixing=m, n_latents=N_LATENTS, eps=eps[m],
                        lr=TRAIN_LR, timed_steps=MULTI_TIMED_STEPS) for m in ("poe", "moe")]
        references = [_multi_reference(m, raw, eps[m]) for m in ("poe", "moe")]
        t0 = time.perf_counter()
        if world == 1:
            ranks = [world_one_group(Rank(0, 1, torch.device("cuda", 0), backend), run_steps,
                                     jobs)]
        else:
            ranks = launch(steps_on_branches, world, jobs, [r[3] for r in references],
                           device="cuda", backend=backend, deadline=MULTI_DEADLINE)
        numbers[label] = {"launch_s": time.perf_counter() - t0}
        for i, mixing in enumerate(("poe", "moe")):
            metrics, grads, one_p50, _ = references[i]
            results = [r[1][i] for r in ranks]
            got = results[0]
            want_launches = {**PER_OBJECTIVE[mixing], **PER_BACKWARD[mixing]}
            for r, res in enumerate(results):
                check(res["rows"] == TRAIN_BATCH // world,
                      f"multi-device {label} {mixing}: rank {r} stepped on {res['rows']} rows")
                check(res["launches"] == want_launches,
                      f"multi-device {label} {mixing}: rank {r} launched {res['launches']}, "
                      f"expected {want_launches}")
                check(not any(k.endswith(":plain") for k in res["paths"]),
                      f"multi-device {label} {mixing}: a plain version ran: {res['paths']}")
                check(res["metrics"] == got["metrics"],
                      f"multi-device {label} {mixing}: ranks read other metrics")
            if bit_equal:
                check(got["metrics"] == metrics,
                      f"multi-device {label} {mixing}: metrics {got['metrics']} != {metrics}")
                for n, g in grads.items():
                    check(np.array_equal(got["grads"][n], g),
                          f"multi-device {label} {mixing}: gradient of {n} differs")
                worst = 0.0
            else:
                for k, v in metrics.items():
                    check(abs(got["metrics"][k] - v) <= TRAIN_RTOL * abs(v) + 1e-4,
                          f"multi-device {label} {mixing}: metric {k} {got['metrics'][k]} "
                          f"vs one process {v}")
                worst, worst_name = _worst_leaf(
                    {n: torch.from_numpy(got["grads"][n]) for n in grads},
                    {n: torch.from_numpy(g) for n, g in grads.items()}, GRAD_REL, GRAD_ATOL)
                check(worst <= 1.0, f"multi-device {label} {mixing}: gradient of "
                      f"{worst_name} is {worst:.3f} of its limit")
                for k, v in got["launches"].items():
                    launches[k] = launches.get(k, 0) + v
            numbers[label][mixing] = {
                "rank_step_ms_p50": [r["step_ms_p50"] for r in results],
                "one_process_step_ms_p50": one_p50, "launches_per_rank": got["launches"],
                "rows_per_rank": got["rows"], "worst_grad_share": worst,
                "bit_equal": bit_equal,
                "relu_flips_per_rank": [r.get("relu_flips") for r in results]}
    t0 = time.perf_counter()
    loss = dryrun_multichip(4, device="cuda", backend="gloo", deadline=MULTI_DEADLINE)
    check(np.isfinite(loss), f"dryrun_multichip(4): loss {loss}")
    numbers["dryrun_multichip(4) gloo"] = {"loss": loss, "s": time.perf_counter() - t0}
    numbers["phase_s"] = time.perf_counter() - t_phase
    return launches, numbers


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from multimodal_vae_comparison_tpu_torch.device import resolve_device
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
    # the port's entry points resolve the card and set its numerics; this
    # script sets none of them itself
    resolve_device()
    flags = numerics_flags()
    print("numerics after the entry point resolved the card: " + ", ".join(
        f"torch.backends.{k}={v}" for k, v in flags.items()))
    check(flags == POLICY_FLAGS, f"the entry point left the numerics at {flags}, not the "
          f"port's policy {POLICY_FLAGS}")

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
    phase_sprites_parity()

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
    serve_variants = telemetry.variants()
    print(f"serving path launches: {serve_launches}; dispatch: {paths}; variants "
          f"{serve_variants}")
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
    train_variants = telemetry.variants()
    print(f"training path launches: {train_launches}; dispatch: {paths}; variants "
          f"{train_variants}")
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

    # 8b. precision: bf16: the bf16 launchers against the fp32 kernels, the
    # flagship and video steps in bf16 card vs CPU, their times and FLOPs
    t0 = time.perf_counter()
    bf16_kernel_rows, bf16_tc_entries = phase_bf16_kernels(card)
    bf16_steps = phase_bf16_steps(card)
    bf16_steps["phase_s"] = time.perf_counter() - t0
    print("bf16 steps " + json.dumps(bf16_steps))

    # 8c. multi-device training on the one card: a world-1 NCCL group bit
    # for bit one process, two gloo ranks summed, the 4-rank hybrid dry run
    multi_launches, multi_numbers = phase_multi_device(card)
    print(card)
    print("multi-device " + json.dumps(multi_numbers))
    check(all(multi_launches.get(k, 0) > 0 for k in ("attention", "poe", "poe_bwd", "kl",
                                                      "kl_bwd")),
          f"a kernel of the multi-device path never launched: {multi_launches}")

    # 9. the paper's four families at full width: card vs CPU
    t0 = time.perf_counter()
    zoo_parity = phase_zoo_parity()
    print(f"zoo parity in {time.perf_counter() - t0:.1f} s: " + json.dumps(zoo_parity))

    # 10. the main path of the last three slices: CdSprites+ from the
    # configs through the data layer, Trainer, checkpoints and the --model
    # server, each run ending in test() and its benchmark ("eval from
    # config"); then, on the same rows and judge, this slice's MoPoE and
    # DMVAE configs of the paper's comparison
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        t0 = time.perf_counter()
        data = make_cdsprites(os.path.join(tmp, "data"))
        data += (time.perf_counter() - t0,)
        config_launches, config_numbers = phase_train_from_config(card, tmp, data)
        config_numbers["phase_s"] = time.perf_counter() - t0
        print("train from config " + json.dumps(config_numbers))
        t0 = time.perf_counter()
        small = make_cdsprites(os.path.join(tmp, "data_small"), ZOO_DATA_COUNT)
        print(f"CdSprites+ level 1 at {ZOO_DATA_COUNT} rows for the later phases in "
              f"{time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        zoo_launches, zoo_numbers = phase_zoo_from_config(card, tmp, small)
        zoo_numbers["phase_s"] = time.perf_counter() - t0
        print("zoo from config " + json.dumps(zoo_numbers))
        # this slice's main path: SPRITES from its configs, each run ending
        # in test() and the SPRITES benchmark; the judges and the models on
        # the card against the CPU
        t0 = time.perf_counter()
        sprites_launches, sprites_numbers = phase_sprites_from_config(card, tmp)
        sprites_numbers["phase_s"] = time.perf_counter() - t0
        print("sprites from config " + json.dumps(sprites_numbers))
        # this slice's main paths: the mixture-prior config on the CdSprites+
        # rows, and the CelebA, CUB and synthetic configs on their surrogates
        t0 = time.perf_counter()
        mog_launches, mog_numbers = phase_mog_from_config(card, tmp, small)
        mog_numbers["phase_s"] = time.perf_counter() - t0
        print("mog from config " + json.dumps(mog_numbers))
        t0 = time.perf_counter()
        family_launches, family_numbers, cub_rows = phase_families_from_config(card, tmp)
        family_numbers["phase_s"] = time.perf_counter() - t0
        print("celeba and cub from config " + json.dumps(family_numbers))
        # this slice's main path: VILANRO collected, trained from three
        # configs, then the closed loop, the probe and a DAgger round
        t0 = time.perf_counter()
        vilanro_launches, vilanro_numbers, vilanro_rows = phase_vilanro_from_config(card, tmp)
        vilanro_numbers["phase_s"] = time.perf_counter() - t0
        print("vilanro from config " + json.dumps(vilanro_numbers))
        # this slice's main paths: VILANRO's conditioned configs (CoordConv,
        # spatial softmax, TransformerCond, the aux head, 128 px data), then
        # FashionMNIST from its surrogate through its benchmark
        t0 = time.perf_counter()
        cond_launches, cond_numbers, cond_rows = phase_vilanro_cond_from_config(
            card, tmp, vilanro_numbers["collect"])
        cond_numbers["phase_s"] = time.perf_counter() - t0
        print("vilanro cond from config " + json.dumps(cond_numbers))
        t0 = time.perf_counter()
        fashion_launches, fashion_numbers, fashion_rows = phase_fashionmnist_from_config(card, tmp)
        fashion_numbers["phase_s"] = time.perf_counter() - t0
        print("fashionmnist from config " + json.dumps(fashion_numbers))
        # this slice's main path: MNIST-SVHN and PolyMNIST from their
        # surrogates through their benchmarks, and the PoE lattice at M 5
        t0 = time.perf_counter()
        digits_launches, digits_numbers, digits_rows = phase_digits_from_config(card, tmp)
        digits_numbers["phase_s"] = time.perf_counter() - t0
        print("digits from config " + json.dumps(digits_numbers))
        # this slice's main path: the unimodal VAE (ELBO, DReG, the gumbel
        # path) and the nets no shipped config names, from shipped configs
        # edited in the run, on the CdSprites+ rows and SPRITES clips above
        t0 = time.perf_counter()
        zoo_rest_launches, zoo_rest_numbers, zoo_rest_rows = phase_zoo_rest_from_config(
            card, tmp, small, os.path.join(tmp, "sprites"))
        zoo_rest_numbers["phase_s"] = time.perf_counter() - t0
        print("zoo remainder from config " + json.dumps(zoo_rest_numbers))
        # this slice's main path: CelebA trained under the perceptual
        # feature_loss on the families phase's rows, the FID, the feature
        # nets and the pretrained-trunk install from torchvision-layout files
        t0 = time.perf_counter()
        eval_rest_launches, eval_rest_numbers = phase_eval_rest_from_config(
            card, tmp, small, family_numbers["POE celeba"]["epoch_s"])
        eval_rest_numbers["phase_s"] = time.perf_counter() - t0
        print("eval remainder from config " + json.dumps(eval_rest_numbers))
        # this slice's main path: precision bf16 from the CLI, cdl1_r5_poe
        # on the rows above and sprites_r4_dreg_up on the clips above
        t0 = time.perf_counter()
        bf16_launches, bf16_numbers = phase_bf16_from_config(
            card, tmp, small, os.path.join(tmp, "sprites"), sprites_numbers)
        bf16_numbers["phase_s"] = time.perf_counter() - t0
        print("bf16 from config " + json.dumps(bf16_numbers))
        # seeded runs reproduce: two plain CLI children byte for byte, and
        # the SPRITES, video and ResNet-50 steps rerun in this process bit
        # for bit, in fp32 and bf16
        seeded_numbers = phase_seeded_reruns(card, tmp, small, os.path.join(tmp, "sprites"))
        print("seeded reruns " + json.dumps(seeded_numbers))

    # 11. times
    rows, few_keys_entry, long_keys_entry = phase_times(engine, card)
    rows += phase_kernel_route_times(card)
    extra = phase_attention_backward_times(card)
    rows += phase_video_times(card)
    sprites_rows = phase_sprites_times(card)
    phase_route_times(card)
    print("zoo times " + json.dumps(phase_zoo_times(card)))
    print(card)
    # one entry per kernel, at its heaviest main-path shape (the first row
    # of each); the other shapes are on the "time" lines above.  launches:
    # each kernel's count on the path that runs it, the train-from-config
    # path (the POE and MOE configs, the MoPoE and DMVAE configs and this
    # slice's SPRITES configs, the last two also apart) or the video
    # training and sampling paths, with the fixed-batch training and serving
    # paths' beside it; the SPRITES path's shapes of a kernel beside its row
    primary = list({r["name"]: r for r in reversed(rows)}.values())[::-1]
    per_step["VideoGPTSparse MOE dreg"] = video_per_step
    for label, _, _, _ in SPRITES_FROM_CONFIG:
        per_step[f"SPRITES {label}"] = sprites_numbers[label]["launches_per_train_step"]
    per_step[f"CdSprites+ {MOG_FROM_CONFIG[0]}"] = mog_numbers["launches_per_train_step"]
    for label, *_ in FAMILIES_FROM_CONFIG:
        per_step[label] = family_numbers[label]["launches_per_train_step"]
    for label, *_ in VILANRO_FROM_CONFIG + VILANRO_COND_FROM_CONFIG:
        run_numbers = (vilanro_numbers if label in vilanro_numbers else cond_numbers)[label]
        per_step[f"VILANRO {label}"] = run_numbers["launches_per_train_step"]
    for label, _ in FASHION_FROM_CONFIG:
        per_step[f"FashionMNIST {label}"] = fashion_numbers[label]["launches_per_train_step"]
    for label, *_ in DIGITS_FROM_CONFIG:
        per_step[f"digits {label}"] = digits_numbers[label]["launches_per_train_step"]
    for label, *_ in ZOO_REST_FROM_CONFIG:
        per_step[f"zoo remainder {label}"] = zoo_rest_numbers[label]["launches_per_train_step"]
    per_step["eval remainder POE celeba feature_loss"] = eval_rest_numbers[
        "POE celeba feature_loss"]["launches_per_train_step"]
    for r in primary:
        kernel = KERNEL_OF[r["name"]]
        r["launches"] = (video_launches.get(kernel, 0) if kernel in video_kernels
                         else config_launches.get(kernel, 0) + zoo_launches.get(kernel, 0)
                         + sprites_launches.get(kernel, 0) + mog_launches.get(kernel, 0)
                         + family_launches.get(kernel, 0) + vilanro_launches.get(kernel, 0)
                         + cond_launches.get(kernel, 0) + fashion_launches.get(kernel, 0)
                         + digits_launches.get(kernel, 0) + zoo_rest_launches.get(kernel, 0)
                         + eval_rest_launches.get(kernel, 0) + bf16_launches.get(kernel, 0)
                         + multi_launches.get(kernel, 0))
        r["launches_zoo_from_config_path"] = zoo_launches.get(kernel, 0)
        r["launches_sprites_from_config_path"] = sprites_launches.get(kernel, 0)
        r["launches_mog_from_config_path"] = mog_launches.get(kernel, 0)
        r["launches_families_from_config_path"] = family_launches.get(kernel, 0)
        r["launches_vilanro_from_config_path"] = vilanro_launches.get(kernel, 0)
        r["launches_vilanro_cond_from_config_path"] = cond_launches.get(kernel, 0)
        r["launches_fashionmnist_from_config_path"] = fashion_launches.get(kernel, 0)
        r["launches_digits_from_config_path"] = digits_launches.get(kernel, 0)
        r["launches_zoo_rest_from_config_path"] = zoo_rest_launches.get(kernel, 0)
        r["launches_eval_rest_from_config_path"] = eval_rest_launches.get(kernel, 0)
        r["launches_bf16_from_config_path"] = bf16_launches.get(kernel, 0)
        r["launches_multi_device_path_per_rank"] = multi_launches.get(kernel, 0)
        # the bf16 launcher beside the fp32 kernel, where the kernel has one
        if r["name"] in bf16_kernel_rows:
            # the bf16 path's launches: the video step's for the sparse
            # kernels, the bf16 configs' for the attention
            n = (bf16_steps["VideoGPTSparse MOE dreg"]["bfloat16"]["launches_per_step"]
                 .get(kernel, 0) if kernel in video_kernels else bf16_launches.get(kernel, 0))
            r["bf16"] = [dict(x, launches=n) for x in bf16_kernel_rows[r["name"]]]
        r["sprites_shapes"] = [{k: v for k, v in x.items()
                                if k not in ("name", "route", "source", "replaces")}
                               for x in sprites_rows if x["name"] == r["name"]]
        r["cub_shapes"] = [{k: v for k, v in x.items()
                            if k not in ("name", "route", "source", "replaces")}
                           for x in cub_rows if x["name"] == r["name"]]
        for key, extra_rows in (("vilanro_shapes", vilanro_rows),
                                ("vilanro_cond_shapes", cond_rows),
                                ("fashionmnist_shapes", fashion_rows),
                                ("digits_shapes", digits_rows),
                                ("zoo_rest_shapes", zoo_rest_rows)):
            r[key] = [{k: v for k, v in x.items()
                       if k not in ("name", "route", "source", "replaces")}
                      for x in extra_rows if x["name"] == r["name"]]
        r["launches_fixed_batch_training_path"] = train_launches.get(kernel, 0)
        r["launches_serving_path"] = serve_launches.get(kernel, 0)
        r["launches_per_train_step"] = {label: n.get(kernel, 0)
                                        for label, n in per_step.items()}
    primary[0].update(extra)   # masked_attention: its backward's time
    # the bf16 tensor-core kernels, each with its launches on the main path
    # that runs it: the bf16 configs' (attention) and a bf16 video step's
    # (the sparse forward, dq and dk/dv), counted from zero just before each
    bf16_video_kinds = bf16_steps["VideoGPTSparse MOE dreg"]["bfloat16"]["variants"]
    for name, key, n in (
            ("masked_attention_bf16_tc", "launches_bf16_from_config_path",
             bf16_numbers["launches_by_variant"].get("attention:tc_bf16:bfloat16", 0)),
            *((f"strided_block_sparse_attention{part}_bf16_tc", "launches_per_bf16_video_step",
               bf16_video_kinds.get(f"sparse_attention{part}:tc_bf16:bfloat16", 0))
              for part in ("", "_dq", "_dkv"))):
        check(n > 0, f"{name}: launched no time on its main path")
        primary.append(dict(bf16_tc_entries[name], launches=n, **{key: n}))
    # the two kernels of the masked attention's short routes: the few-keys
    # kernel's launches on the serving and training paths (the flagship text
    # decoder's one latent key), the short bf16 kernel's on the bf16 configs'
    # (SPRITES' 8 x 8 T-axis heads)
    few = {"serving": serve_variants.get("attention:few_keys", 0),
           "training": train_variants.get("attention:few_keys", 0),
           "from config": PATH_VARIANTS.get("attention:few_keys", 0)}
    check(all(few.values()), f"masked_attention_few_keys: launched no time on a main path: "
                             f"{few}")
    primary.append(dict(few_keys_entry, launches=sum(few.values()),
                        launches_serving_path=few["serving"],
                        launches_fixed_batch_training_path=few["training"],
                        launches_from_config_paths=few["from config"]))
    # the fp32 tensor-core attention kernel: its launches on the model paths
    # (serving, fixed-batch training, the from-config paths: the text and
    # caption encoders, VILANRO's action encoder, Enc_VIT)
    mma = {"serving": serve_variants.get("attention:mma", 0),
           "training": train_variants.get("attention:mma", 0),
           "from config": PATH_VARIANTS.get("attention:mma", 0)}
    check(all(mma.values()), f"masked_attention_mma: launched no time on a main path: {mma}")
    primary.append(dict(long_keys_entry, launches=sum(mma.values()),
                        launches_serving_path=mma["serving"],
                        launches_fixed_batch_training_path=mma["training"],
                        launches_from_config_paths=mma["from config"]))
    n = bf16_numbers["launches_by_variant"].get("attention:short_bf16:bfloat16", 0)
    check(n > 0, "masked_attention_short_bf16: launched no time on its main path")
    primary.append(dict(bf16_tc_entries["masked_attention_short_bf16"], launches=n,
                        launches_bf16_from_config_path=n))
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
    sys.exit({"numerics_cost": numerics_cost, "seeded_prints": seeded_prints}.get(
        sys.argv[1] if len(sys.argv) > 1 else "", main)())
