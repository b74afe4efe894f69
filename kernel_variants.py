"""Design choices of the redesigned kernels, measured against each other.

    python3 kernel_variants.py [variant ...]
    python3 kernel_variants.py --against DIR [variant]

For each named variant (all of them with no arguments) this copies the
port's package into ``build/archive/variant_<name>/``, edits one constant or
line of a CUDA source there, builds it, and in a process of its own prints:

* the error of the sparse forward against its plain version and its time at
  the video model's decoder and encoder shapes, the same for the sparse
  backward's dq and dk/dv kernels (error of the Function's gradients against
  autograd through the plain version; registers at Dh 32 from ptxas), and the
  masked attention's time beside its plain version's at the text encoder's
  and decoder's shapes, the flagship's 45 characters and CUB's 246 (device
  ms per call, launches back to back in a CUDA graph, as ``chip_smoke.py``
  times them);
* the video model's card-vs-float64 gradient check of ``chip_smoke.py``
  (``phase_video_parity``): the worst leaf as a share of its limit.

``shipped`` is the source as it stands.  The variants:

* ``one_row_tile``: a warp of the sparse forward owns one tile of 16 query
  rows, not two;
* ``keys_64``: 64 keys per online-softmax step, not 32;
* ``lo_rounded``: the low half of the 3xTF32 split rounded to TF32 by a
  second ``cvt.rna``, not handed over as it is;
* ``exp2f``: libm's ``exp2f`` in place of one ``ex2.approx``;
* ``one_accumulator``: the cross terms of the split accumulated on top of the
  hi hi term, so that 3 * Dh / 8 tensor-core accumulations chain per score;
* ``rows_3``: the resident attention kernel with 3 query rows a warp;
* ``split_heads``: it splits a head's query rows over blocks up to four
  blocks an SM, not only where the heads do not fill the card;
* ``rows_64_per_block``: it splits every head into blocks of at most 64
  query rows (one row group a warp), however many heads there are;
* ``bwd_three_blocks``: the sparse dq and dk/dv kernels compiled for three
  thread blocks an SM (at most 168 registers a thread), not two;
* ``bwd_rows_in_smem``: their resident operands at Dh 32 (q and d_out, k
  and v) read from rows staged in shared memory, as for Dh 64, not held in
  registers;
* ``bf16_widened``: the bf16 launchers of the masked attention and the
  sparse forward, dq and dk/dv never take the bf16 tensor-core kernels
  (``masked_attention_tc``, ``sparse_fwd_tc``, ``sparse_dq_tc``,
  ``sparse_dkv_tc``), as before them: bf16 is widened into the fp32 kernels
  (``shipped`` against it is the A/B of the whole bf16 video step that
  made the tensor-core kernels the default);
* ``tc_four_blocks``: ``sparse_fwd_tc`` compiled for four thread blocks an
  SM (at most 128 registers a thread), not the three its registers allow;
* ``tc_three_stages``: ``sparse_fwd_tc`` with three key blocks in flight,
  not two;
* ``attention_tc_two_stages``: ``masked_attention_tc`` with two key tiles
  in flight, not three;
* ``scores_every_tile``: the resident attention kernel scores every key
  tile, the dead ones too (from shared memory it did not stage), and leaves
  the dead tiles out only from the softmax and p v (a yardstick for the
  ``--against`` arm: its scores loop without a branch);
* ``skip_from_three_tiles``: the resident kernel's skipping instance only
  for heads of more than 64 keys (KPL 4 and 8), the dense one below (the
  flagship's 45 keys);
* ``skip_flat_pv``: the skipping instance's p v walks every value row in
  one loop, jumping over a dead tile, at 4 and 8 tiles too (not a loop a
  live tile there);
* ``first_tile_early``: the skipping instance stages the first key tile's
  K and V before it reads the mask (live for every padded sequence, whose
  visible keys come first), the other live tiles after.

Every variant also prints the bf16 launchers' variant and time at the
sparse decoder's shape and at the attention shapes above, the registers of
the bf16 tensor-core backward kernels at Dh 32, and the bf16 VideoGPTSparse
step's p50 and profiled device ms, the sparse forward's, dq's and dk/dv's
kernels apart (:func:`video_step_bf16`).

Two arms edit nothing and A/B the masked attention's routes on the source
as it stands (:func:`measure_routes`, ~1 min each), at every shape of its
table: the route the launcher takes, its largest error against the plain
version (within ``chip_smoke.ATTN_RTOL/ATOL``) and whether two launches give
the same bits; then the launcher, the yardstick before it and the launcher
again, in turns, beside the byte bound (:func:`chip_smoke.attention_bound`),
an empty kernel launched as the route launches its kernel, the plain
version and SDPA (device ms, graphed):

* ``few_keys``: fp32 heads of at most 8 keys, the resident route
  (``masked_attention_forward_resident``) against the few-keys kernel
  (``masked_attention_few_keys``), which the yardstick
  ``masked_attention_forward_few_keys`` also runs where the launcher does
  not give it the shape (Tq <= Tk: SPRITES' fp32 8 x 8 heads);
* ``few_keys_bf16``: bf16 heads of at most 8 keys under more query rows
  (the decoders' cross-attention), the tensor-core kernel
  (``masked_attention_forward_bf16_tc``) against the few-keys kernel on
  bf16 (``masked_attention_forward_bf16_few_keys`` where the launcher does
  not take it);
* ``short_bf16``: bf16 heads with both sides under 16, the widening route
  (``masked_attention_forward_bf16_widened``) against the short kernel
  (``masked_attention_short_bf16``), beside the tensor-core kernel
  (``masked_attention_forward_bf16_tc``) and the fp32 launcher on the
  widened inputs.

A third arm, ``padded_tiles`` (:func:`measure_padded`, ~1 min), A/Bs the
resident, mma and chunked kernels' skipping of the 32-key tiles whose keys are
all masked: at the key-padded encoders (CUB's captions, VILANRO's action
trajectories, the flagship's text, a chunked head past 256 keys) and at
shapes without a dead tile, the route as it stands
(``masked_attention_forward_resident``) against the dense design that
skips nothing (``masked_attention_forward_dense``), in turns, beside the
bound over the needed keys, the plain version and SDPA under the same
mask; and whether the two give the same bits, also with the dead tiles' K
and V rows set to NaN.

A fourth arm, ``long_keys`` (:func:`measure_long_keys`, ~2 min), A/Bs the
fp32 tensor-core kernel (``masked_attention_mma``) against the kernels on
either side of it: at the heads past the resident kernel's reach
(:data:`LONG_KEY_SHAPES`) the launcher, which gives them to it, against
the chunked kernel that took them before
(``masked_attention_forward_chunked``); at the padded encoders and the
short heads the resident kernel holds (:data:`CROSSOVER_SHAPES`: CUB's,
VILANRO's action encoder, the flagship's, Enc_VIT's, SPRITES' H axis, and
heads on either side of the crossover's 16 rows and 16 keys) the resident
kernel (``masked_attention_forward_resident_only``) against the
tensor-core kernel there (``masked_attention_forward_mma``), each in turns
A B B A twice, with each side's spread (its largest less its smallest
time), beside both bounds, the plain version and SDPA under the same mask,
and each side's error and bits twice.

The ``poe_`` variants edit ``csrc/poe.cu`` and are measured apart: the
lattice forward and backward kernels' device ms (graphed, as above) at
serving's one subset (2 experts of (128, 16)), the flagship lattice (2
experts, 3 subsets, (24, 16)) and PolyMNIST's (5 experts, 31 subsets), and
their largest error against the plain versions:

* ``poe_shipped``: the source as it stands;
* ``poe_loads_in_order``: the forward loads each expert right before its
  reciprocal, not all experts first;
* ``poe_ieee_div``: the forward's per-subset division and square root
  IEEE-rounded (``/`` and ``sqrtf(1 / x)``), not ``__fdividef`` and
  ``rsqrtf``.

It also keeps the route the PoE and KL kernels took before they covered
the whole lattice and every modality in one launch, as a yardstick that
``chip_smoke.py`` times the train step against and the port never calls:
:func:`old_route` makes a POE or MOE model fuse each subset with one PoE
launch on its stacked experts and take the KL of each modality with one
launch, each backward in torch ops.

``--against DIR`` compares the masked attention of this checkout with that
of an earlier one unpacked into ``DIR`` (``git archive`` into a directory
that ``.gitignore`` lists, e.g. ``build/archive/parent``): the launcher at
every shape of the ``padded_tiles`` and ``long_keys`` arms and the resident
route at SPRITES' fp32 8 x 8 heads, in four processes in turns (the earlier checkout, this
one, this one, the earlier one; :func:`measure_launcher`), with the resident
kernel's registers; with a variant named after ``DIR``, that variant's copy
in place of this checkout.

Needs one NVIDIA GPU and ``nvcc``; imports nothing of JAX.
"""
from __future__ import annotations

import os
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PACKAGE = "multimodal_vae_comparison_tpu_torch"
SPARSE = f"{PACKAGE}/csrc/sparse_attention.cu"
ATTENTION = f"{PACKAGE}/csrc/attention.cu"
POE = f"{PACKAGE}/csrc/poe.cu"

# name -> [(source, text to find exactly once or more, its replacement)]
VARIANTS = {
    "shipped": [],
    "one_row_tile": [(SPARSE, "LAUNCH(8, 2) : dh <= 16 ? LAUNCH(16, 2) : LAUNCH(32, 2)",
                      "LAUNCH(8, 1) : dh <= 16 ? LAUNCH(16, 1) : LAUNCH(32, 1)")],
    "keys_64": [(SPARSE, "constexpr int MMA_KEYS = 32;", "constexpr int MMA_KEYS = 64;")],
    "lo_rounded": [(SPARSE, "lo = __float_as_uint(x - __uint_as_float(hi));",
                    'asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(lo) '
                    ': "f"(x - __uint_as_float(hi)));')],
    "exp2f": [(SPARSE, 'asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));',
               "y = exp2f(x);")],
    "one_accumulator": [(SPARSE, "mma_tf32(small[m][n],", "mma_tf32(big[m][n],")],
    "rows_3": [(ATTENTION, "constexpr int ROWS = 4; ", "constexpr int ROWS = 3; ")],
    "split_heads": [(ATTENTION, "bh >= SM_COUNT ? 1 : (2 * SM_COUNT + bh - 1) / bh;",
                     "(4 * SM_COUNT + bh - 1) / bh;")],
    "rows_64_per_block": [(ATTENTION, "bh >= SM_COUNT ? 1 : (2 * SM_COUNT + bh - 1) / bh;",
                           "(tq + 63) / 64;")],
    "bwd_three_blocks": [(SPARSE, f"__launch_bounds__(MMA_WARPS * 32)\n{name}(",
                          f"__launch_bounds__(MMA_WARPS * 32, 3)\n{name}(")
                         for name in ("sparse_dq_mma", "sparse_dkv_mma")],
    "bwd_rows_in_smem": [(SPARSE, "rows_in_smem(int dhp) { return dhp > 32; }",
                          "rows_in_smem(int dhp) { return dhp > 16; }")],
    "tc_four_blocks": [(SPARSE, "__launch_bounds__(MMA_WARPS * 32)\nsparse_fwd_tc(",
                        "__launch_bounds__(MMA_WARPS * 32, 4)\nsparse_fwd_tc(")],
    "tc_three_stages": [(SPARSE, "constexpr int TC_STAGES = 2;", "constexpr int TC_STAGES = 3;")],
    "attention_tc_two_stages": [(ATTENTION, "constexpr int TC_STAGES = 3;",
                                 "constexpr int TC_STAGES = 2;")],
    "bf16_widened": [(ATTENTION, "if (tc_takes(q, k, v, tq, tk, dh)) {", "if (false) {"),
                     (SPARSE, "if (tc_takes(address_bits(q, k, v, o), t, dh, block)) {",
                      "if (false) {"),
                     (SPARSE, "if (tc_takes(address_bits(q, k, v, d_out, lse, delta, dq), t, dh, "
                      "block)) {", "if (false) {"),
                     (SPARSE, "if (tc_takes(address_bits(q, k, v, d_out, lse, delta, dk, dv), t, "
                      "dh, block)) {", "if (false) {")],
    "few_keys": [],
    "few_keys_bf16": [],
    "short_bf16": [],
    "padded_tiles": [],
    "long_keys": [],
    "scores_every_tile": [(ATTENTION, """        if (!tile(c)) continue;
        const float4 kv""", """        const float4 kv""")],
    "skip_from_three_tiles": [(ATTENTION, "if (KPL > 1 && skip && key_mask != nullptr)",
                               "if (KPL > 2 && skip && key_mask != nullptr)")],
    "skip_flat_pv": [(ATTENTION, "if (SKIP && KPL > 2) {", "if (false) {")],
    "first_tile_early": [(ATTENTION, """    if (SKIP) {
      if (tr < rstep)
        for (int r = tr; r < rows; r += rstep)
          stage4(qs + r * dh4 + tc, qh + (size_t)r * dh + tc);
      live = live_tiles<KPL>(key_mask + (size_t)b * tk, tk, lane);
    }
    if (tr < rstep) {
      for (int r = tr; r < tk; r += rstep)
        if (tile(r / WARP)) {""", """    if (SKIP) {
      if (tr < rstep) {
        for (int r = tr; r < WARP; r += rstep) {
          stage4(ks + r * kstride + tc, kh + (size_t)r * dh + tc);
          stage4(vs + r * dh4 + tc, vh + (size_t)r * dh + tc);
        }
        for (int r = tr; r < rows; r += rstep)
          stage4(qs + r * dh4 + tc, qh + (size_t)r * dh + tc);
      }
      live = live_tiles<KPL>(key_mask + (size_t)b * tk, tk, lane);
    }
    if (tr < rstep) {
      for (int r = tr; r < tk; r += rstep)
        if ((!SKIP || r >= WARP) && tile(r / WARP)) {""")],
    "poe_shipped": [],
    "poe_loads_in_order": [(POE, """    load_experts(ex, experts, i, mu, scale);
#pragma unroll
    for (int e = 0; e < MAX_EXPERTS; ++e) {
      prec[e] = weighted[e] = 0.f;
      if (e < experts) {
""", """#pragma unroll
    for (int e = 0; e < MAX_EXPERTS; ++e) {
      prec[e] = weighted[e] = 0.f;
      if (e < experts) {
        scale[e] = ex.scale[e][i];
        mu[e] = ex.mu[e][i];
""")],
    "poe_ieee_div": [(POE, """      mu_out[k * n + i] = __fdividef(acc_mu, denom);
      scale_out[k * n + i] = rsqrtf(denom);""", """      mu_out[k * n + i] = acc_mu / denom;
      scale_out[k * n + i] = sqrtf(1.f / denom);""")],
}


def make_variant(name: str) -> str:
    """A copy of the package with the variant's edits; returns its root."""
    root = os.path.join(HERE, "build", "archive", f"variant_{name}")
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(os.path.join(HERE, PACKAGE), os.path.join(root, PACKAGE),
                    ignore=shutil.ignore_patterns("__pycache__"))
    for source, old, new in VARIANTS[name]:
        path = os.path.join(root, source)
        with open(path) as f:
            text = f.read()
        if old not in text:
            raise RuntimeError(f"variant {name}: {source} no longer holds {old!r}")
        with open(path, "w") as f:
            f.write(text.replace(old, new))
    return root


def measure(name: str, root: str) -> None:
    """Runs in the variant's own process: ``root`` comes first on the path,
    so the package and the libraries it builds are the variant's."""
    sys.path.insert(0, root)
    import torch
    import chip_smoke as cs
    from multimodal_vae_comparison_tpu_torch.device import set_numerics
    from multimodal_vae_comparison_tpu_torch.ops.kernels import _build, attention, telemetry
    from multimodal_vae_comparison_tpu_torch.ops.kernels import sparse_attention as sp
    if not os.path.abspath(_build.CSRC).startswith(os.path.abspath(root)):
        raise RuntimeError(f"the package was imported from {_build.CSRC}, not from {root}")
    set_numerics()
    card = cs.card_line()
    built = _build.build(("attention", "sparse_attention"))
    print(f"variant {name}: built in {max((t for t, _ in built.values()), default=0.0):.2f} s on {card}")
    kernel = None
    for line in built["sparse_attention"][1].splitlines():
        if "Compiling entry function" in line:
            kernel = next((k for k in ("sparse_dq_mmaIfLi32", "sparse_dkv_mmaIfLi32",
                                       "sparse_dq_tcILi32", "sparse_dkv_tcILi32") if k in line),
                          None)
        elif kernel and ("registers" in line or "spill" in line):
            print(f"variant {name}: ptxas {kernel[:-5]}<32>: {line.strip()}")
    g = torch.Generator(device="cuda").manual_seed(30)
    block, stride = cs.SPARSE_BLOCK, cs.SPARSE_STRIDE
    for label, shape in (("decoder", cs.SPARSE_DEC), ("encoder", cs.SPARSE_ENC)):
        q, k, v = (torch.randn(shape, generator=g, device="cuda") for _ in range(3))
        want = sp.sparse_attention_reference(q, k, v, block, stride)
        got = sp.strided_block_sparse_attention(q, k, v, block, stride)
        err = (got - want).abs().max().item()
        ok = torch.allclose(got, want, rtol=cs.SPARSE_RTOL, atol=cs.SPARSE_ATOL)
        del want, got
        ms = [cs.graph_ms(lambda: sp.strided_block_sparse_attention(q, k, v, block, stride),
                          reps=5, replays=4) for _ in range(2)]
        print(f"variant {name}: sparse forward {label} {shape}: {ms[0]:.5f} and {ms[1]:.5f} "
              f"ms, max_abs_err {err:.3e}, within tolerance: {ok}")
        d_out = torch.randn(shape, generator=g, device="cuda")
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        want = torch.autograd.grad(sp.sparse_attention_reference(*leaves, block, stride),
                                   leaves, d_out)
        got = torch.autograd.grad(sp.strided_block_sparse_attention(*leaves, block, stride),
                                  leaves, d_out)
        err = max((a - b).abs().max().item() for a, b in zip(got, want))
        ok = all(torch.allclose(a, b, rtol=cs.SPARSE_BWD_RTOL, atol=cs.SPARSE_BWD_ATOL)
                 for a, b in zip(got, want))
        del leaves, want, got
        out, lse = sp._launch_forward(q, k, v, block, stride)
        args = (q, k, v, d_out, lse, (d_out * out).sum(-1), block, stride)
        dq = [cs.graph_ms(lambda: sp._launch_dq(*args), reps=5, replays=4) for _ in range(2)]
        dkv = [cs.graph_ms(lambda: sp._launch_dkv(*args), reps=5, replays=4) for _ in range(2)]
        print(f"variant {name}: sparse dq {label} {shape}: {dq[0]:.5f} and {dq[1]:.5f} ms; "
              f"dk/dv {dkv[0]:.5f} and {dkv[1]:.5f} ms; gradients max_abs_err {err:.3e}, "
              f"within tolerance: {ok}")
        del out, lse, args
    for label, shape, masked in (("encoder", (128, 2, 45, 45, 32), True),
                                 ("decoder", (128, 2, 45, 1, 8), False),
                                 ("cub encoder", (32, 2, 246, 246, 32), True),
                                 ("cub decoder", (640, 2, 246, 1, 8), False)):
        q, k, v, mask = cs.attention_inputs(g, *shape, masked)
        ok = torch.allclose(attention.masked_attention(q, k, v, mask),
                            attention.attention_reference(q, k, v, mask),
                            rtol=cs.ATTN_RTOL, atol=cs.ATTN_ATOL)
        ms = [cs.graph_ms(lambda: attention.masked_attention(q, k, v, mask)) for _ in range(2)]
        plain = cs.graph_ms(lambda: attention.attention_reference(q, k, v, mask))
        print(f"variant {name}: masked attention {label} {shape}: {ms[0]:.5f} and "
              f"{ms[1]:.5f} ms (plain {plain:.5f}), within tolerance: {ok}")
    # the bf16 launchers: the variant each takes, its time and its error
    # against the fp32 kernel on the widened inputs
    for label, shape, masked in (("flagship", (24, 2, 45, 45, 32), True),
                                 ("cub encoder", (32, 2, 246, 246, 32), True),
                                 ("cub decoder", (640, 2, 246, 1, 8), False),
                                 ("sprites T", (4096, 2, 8, 8, 32), False),
                                 ("sprites H", (2048, 2, 16, 16, 32), False),
                                 ("vilanro action encoder", (64, 2, 100, 100, 16), True)):
        q, k, v, mask = cs.attention_inputs(g, *shape, masked)
        q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
        telemetry.reset()
        got = attention._launch(q, k, v, mask)
        took = sorted(telemetry.dtypes())
        err = (got - attention._launch(q.float(), k.float(), v.float(), mask)).abs().max()
        ms = [cs.graph_ms(lambda: attention._launch(q, k, v, mask)) for _ in range(2)]
        print(f"variant {name}: bf16 masked attention {label} {shape}: {took}, {ms[0]:.5f} "
              f"and {ms[1]:.5f} ms, max_abs_err {err.item():.3e} against the fp32 kernel")
    shape = cs.BF16_SPARSE_SHAPE
    q, k, v = (torch.randn(shape, generator=g, device="cuda").bfloat16() for _ in range(3))
    telemetry.reset()
    out, lse = sp._launch_forward(q, k, v, block, stride)
    took = sorted(telemetry.dtypes())
    out32, _ = sp._launch_forward(q.float(), k.float(), v.float(), block, stride)
    ms = [cs.graph_ms(lambda: sp._launch_forward(q, k, v, block, stride), reps=10)
          for _ in range(2)]
    print(f"variant {name}: bf16 sparse forward {shape}: {took}, {ms[0]:.5f} and {ms[1]:.5f} "
          f"ms, max_abs_err {(out - out32).abs().max().item():.3e} against the fp32 kernel")
    del q, k, v, out, lse, out32
    video_step_bf16(name)
    try:
        cs.phase_video_parity()
    except RuntimeError as e:   # a failed check of chip_smoke: the finding, not a fault
        print(f"variant {name}: {e}")


def video_step_bf16(name: str) -> None:
    """The bf16 VideoGPTSparse MOE DReG step of ``chip_smoke.py`` ("bf16
    steps": bs 8, K 5, remat): its wall p50 over 10 steps, twice, and its
    device ms a step from ``torch.profiler`` over 3 steps, with the sparse
    forward's, dq's and dk/dv's kernels' share of it."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    import chip_smoke as cs
    from multimodal_vae_comparison_tpu_torch.training.optim import make_optimizer
    from multimodal_vae_comparison_tpu_torch.training.trainer import (
        build_model, make_train_step)
    raw, _ = cs.video_inputs(np.random.default_rng(75), cs.VIDEO_BATCH, cs.VIDEO_K)
    batch = cs.torch_batch(raw, "cuda")
    model = build_model(cs.video_specs(), "moe", cs.VIDEO_LATENTS, obj="dreg", K=cs.VIDEO_K,
                        seed=0, device="cuda", remat=True, dtype=torch.bfloat16)
    step = make_train_step(model, make_optimizer("adam", cs.VIDEO_LR, model.parameters()))
    gen = torch.Generator(device="cuda").manual_seed(76)
    p50 = [cs._p50_step_ms(step, batch, gen, steps=10) for _ in range(2)]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            step(batch, generator=gen)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    act = cs.device_activity(prof, wall_ms)
    sparse = {part: sum(ms for n, ms in act["ms_by_name"].items() if f"sparse_{part}" in n) / 3
              for part in ("fwd", "dq", "dkv")}
    print(f"variant {name}: bf16 video step (bs {cs.VIDEO_BATCH}, K {cs.VIDEO_K}): p50 "
          f"{p50[0]:.3f} and {p50[1]:.3f} ms; {act['ms'] / 3:.3f} device ms a step over 3 "
          f"profiled, busy {act['busy_share']:.4f}, of it the sparse forward kernels "
          f"{sparse['fwd']:.3f} ms, dq {sparse['dq']:.3f} ms, dk/dv {sparse['dkv']:.3f} ms")


# (label, (B, H, Tq, Tk, Dh), masked) of each route arm: the decoders'
# cross-attention over 1 latent or 5 conditioning tokens, the flagship text
# decoder's at the serving batch and bs 24, and SPRITES' fp32 8 x 8 T-axis
# heads (the resident kernel's, on the other side of the crossover)
FEW_KEYS_SHAPES = (
    ("Dec_TransformerCond cond_always lattice", (448, 4, 100, 5, 32), True),
    ("Dec_TransformerCond per subset, conditioned", (64, 4, 100, 5, 32), True),
    ("Dec_TransformerCond per subset, z only", (64, 4, 100, 1, 32), False),
    ("CUB DReG text decoder", (640, 2, 246, 1, 8), False),
    ("VILANRO action decoder", (448, 2, 100, 1, 16), False),
    ("VILANRO language decoder", (448, 2, 4, 1, 16), False),
    ("Dec_TransformerIMG", (112, 4, 8, 1, 64), False),
    ("flagship text decoder bs 24", (24, 2, 45, 1, 8), False),
    ("flagship text decoder bs 256", (256, 2, 45, 1, 8), False),
    ("SPRITES fp32 T axis, M*K*B 240", (61440, 2, 8, 8, 32), False),
    ("SPRITES fp32 T axis, bs 16", (4096, 2, 8, 8, 32), False),
    ("Enc_TransformerIMG", (16, 4, 8, 8, 64), True),
    ("VILANRO language encoder", (64, 2, 4, 4, 32), True))
# the decoders' shapes on bf16 inputs
FEW_KEYS_BF16_SHAPES = (
    ("CUB DReG text decoder", (640, 2, 246, 1, 8), False),
    ("VILANRO action decoder", (448, 2, 100, 1, 16), False),
    ("Dec_TransformerCond cond_always lattice", (448, 4, 100, 5, 32), True))
SHORT_BF16_SHAPES = (
    ("SPRITES bf16 T axis, M*K*B 240", (61440, 2, 8, 8, 32), False),
    ("SPRITES bf16 T axis, bs 16", (4096, 2, 8, 8, 32), False))


def measure_routes(name: str, root: str) -> None:
    """The ``few_keys``, ``few_keys_bf16`` or ``short_bf16`` arm, in the
    variant's process."""
    sys.path.insert(0, root)
    import ctypes
    import torch
    import torch.nn.functional as F
    import chip_smoke as cs
    from multimodal_vae_comparison_tpu_torch.device import set_numerics
    from multimodal_vae_comparison_tpu_torch.ops.kernels import _build, attention, telemetry
    set_numerics()
    card = cs.card_line()
    built = _build.build(("attention",))
    print(f"variant {name}: built in {max((t for t, _ in built.values()), default=0.0):.2f} s "
          f"on {card}")
    kernel = None
    for line in built.get("attention", (0, ""))[1].splitlines():
        if "Compiling entry function" in line:
            kernel = next((k for k in ("few_keys", "short_bf16") if k in line), None)
            entry = line.split("'")[1] if "'" in line else line
        elif kernel and ("registers" in line or "spill" in line):
            print(f"variant {name}: ptxas {entry}: {line.strip()}")
    args = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
    yard = {n: _build.function("attention", n, args) for n in (
        "masked_attention_forward_resident", "masked_attention_forward_few_keys",
        "masked_attention_forward_bf16_widened", "masked_attention_forward_bf16_tc",
        "masked_attention_forward_bf16_few_keys")}
    empty = _build.function("attention", "empty_launch", [ctypes.c_int] * 7 + [ctypes.c_void_p])
    g = torch.Generator(device="cuda").manual_seed(23)
    bf16 = name != "few_keys"
    shapes = {"few_keys": FEW_KEYS_SHAPES, "few_keys_bf16": FEW_KEYS_BF16_SHAPES,
              "short_bf16": SHORT_BF16_SHAPES}[name]
    for label, (b, h, tq, tk, dh), masked in shapes:
        q, k, v, mask = cs.attention_inputs(g, b, h, tq, tk, dh, masked)
        if bf16:
            q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
        mptr = None if mask is None else mask.data_ptr()
        telemetry.reset()
        got = attention._launch(q, k, v, mask)
        took = sorted(telemetry.dtypes())
        again = attention._launch(q, k, v, mask)
        plain = attention.attention_reference(q, k, v, mask)
        torch.cuda.synchronize()
        err = (got - plain).abs().max().item()
        ok = torch.allclose(got, plain, rtol=cs.ATTN_RTOL, atol=cs.ATTN_ATOL)

        def call(symbol):
            out = torch.empty(q.shape, dtype=torch.float32, device="cuda")

            def run():
                _build.check("attention", yard[symbol](
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), mptr, out.data_ptr(), b, h, tq,
                    tk, dh, dh ** -0.5, torch.cuda.current_stream().cuda_stream))
            run()
            torch.cuda.synchronize()
            yerr = (out - plain).abs().max().item()
            return run, yerr, torch.allclose(out, plain, rtol=cs.ATTN_RTOL, atol=cs.ATTN_ATOL)

        def floor(resident):
            return cs.graph_ms(lambda: _build.check("attention", empty(
                b, h, tq, tk, dh, int(bf16), int(resident),
                torch.cuda.current_stream().cuda_stream)))

        old_sym = {"few_keys": "masked_attention_forward_resident",
                   "few_keys_bf16": "masked_attention_forward_bf16_tc",
                   "short_bf16": "masked_attention_forward_bf16_widened"}[name]
        old_run, old_err, old_ok = call(old_sym)
        launcher = lambda: attention._launch(q, k, v, mask)  # noqa: E731
        ms = cs.graph_ms(launcher)
        old_ms = cs.graph_ms(old_run)
        old_again = cs.graph_ms(old_run)
        ms_again = cs.graph_ms(launcher)
        extra = ""
        if name == "short_bf16":
            tc_run, tc_err, tc_ok = call("masked_attention_forward_bf16_tc")
            wide = (q.float(), k.float(), v.float())
            extra = (f"; tensor-core kernel {cs.graph_ms(tc_run):.5f} ms (max_abs_err "
                     f"{tc_err:.3e}, within {tc_ok}), fp32 launcher on the widened inputs "
                     f"{cs.graph_ms(lambda: attention._launch(*wide, mask)):.5f} ms")
        elif "few_keys" not in took[0]:
            fk_run, fk_err, fk_ok = call(f"masked_attention_forward_{'bf16_' * bf16}few_keys")
            extra = (f"; few-keys kernel (yardstick) {cs.graph_ms(fk_run):.5f} ms "
                     f"(max_abs_err {fk_err:.3e}, within {fk_ok})")
        if bf16:
            keys = b * tk if mask is None else cs.attended_keys(tk, mask)
            bound, by = cs.bound_ms(2 * (b * h * tq * dh + 2 * h * keys * dh)
                                    + 4 * b * h * tq * dh + (0 if mask is None else b * tk),
                                    4 * h * tq * keys * dh + 4 * h * tq * keys)
        else:
            bound, by = cs.attention_bound(b, h, tq, tk, dh, mask)
        plain_ms = cs.graph_ms(lambda: attention.attention_reference(q, k, v, mask))
        sdpa_mask = None if mask is None else torch.zeros(
            b, 1, 1, tk, device="cuda", dtype=q.dtype).masked_fill(
            ~mask[:, None, None, :], float("-inf"))
        if sdpa_mask is not None:
            sdpa_mask[0] = 0.0   # SDPA's all-masked row would be NaN; its time is what counts
        try:
            sdpa = format(cs.graph_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=sdpa_mask)), ".5f")
        except RuntimeError:   # the library's limits, not the port's
            sdpa = "refused"
        print(f"variant {name}: {label} {(b, h, tq, tk, dh)}{' bf16' if bf16 else ''}: "
              f"{took}; max_abs_err {err:.3e} within tolerance {ok}, same bits twice "
              f"{torch.equal(got, again)}; launcher {ms:.5f} / {ms_again:.5f} ms, "
              f"{old_sym[len('masked_attention_forward_'):]} route {old_ms:.5f} / "
              f"{old_again:.5f} ms (max_abs_err {old_err:.3e}, within {old_ok}){extra}; bound "
              f"{bound:.6f} ms ({by}); empty launch {floor(False):.5f} ms (resident's "
              f"{floor(True):.5f}); plain {plain_ms:.5f} ms; SDPA {sdpa} ms on {card}")


# (label, (B, H, Tq, Tk, Dh), mask) of the padded_tiles arm: the key-padded
# encoders (CUB's captions, 40-70 of 246 characters; VILANRO's 5-7-step
# trajectories padded to 100; the flagship's text and a head past 256 keys,
# random lengths with one batch element masked whole), then shapes without
# a dead tile
PADDED_SHAPES = (
    ("CUB cub_r2 encoder", (32, 2, 246, 246, 32), (40, 70)),
    ("CUB config_cub encoder", (16, 2, 246, 246, 32), (40, 70)),
    ("VILANRO action encoder", (64, 2, 100, 100, 16), (5, 7)),
    ("flagship text encoder", (128, 2, 45, 45, 32), "random"),
    ("chunked, 512 keys", (16, 2, 512, 512, 32), "random"),
    ("flagship text encoder, unmasked", (128, 2, 45, 45, 32), None),
    ("CUB encoder, unmasked", (32, 2, 246, 246, 32), None),
    ("SPRITES fp32 H axis, bs 16", (2048, 2, 16, 16, 32), None),
    ("SPRITES fp32 H axis, M*K*B 240", (30720, 2, 16, 16, 32), None),
    ("Enc_VIT", (24, 8, 17, 17, 32), None),
    ("Enc_TransformerIMG (resident)", (16, 4, 8, 8, 64), "random"),
    ("chunked, unmasked", (1, 1, 300, 300, 64), None))


def _length_mask(g, b: int, tk: int, lo: int, hi: int):
    """(B, Tk) key-padding mask of sequences of lo .. hi keys each."""
    import torch
    lengths = torch.randint(lo, hi + 1, (b, 1), generator=g, device="cuda")
    return (torch.arange(tk, device="cuda")[None, :] < lengths).contiguous()


def measure_padded(name: str, root: str) -> None:
    """The ``padded_tiles`` arm, in the variant's process: at every shape
    of :data:`PADDED_SHAPES` the resident, mma or chunked route as it stands
    (``masked_attention_forward_resident``) and the dense design
    (``masked_attention_forward_dense``), their bits against each other and
    with the dead tiles' K and V NaN, their error against the plain
    version, then in turns A B B A (device ms, graphed) beside the bound
    over the needed keys, the plain version and SDPA under the same mask."""
    sys.path.insert(0, root)
    import torch
    import torch.nn.functional as F
    import chip_smoke as cs
    from multimodal_vae_comparison_tpu_torch.device import set_numerics
    from multimodal_vae_comparison_tpu_torch.ops.kernels import _build, attention
    set_numerics()
    card = cs.card_line()
    built = _build.build(("attention",))
    print(f"variant {name}: built in {max((t for t, _ in built.values()), default=0.0):.2f} s "
          f"on {card}")
    entry = None
    for line in built.get("attention", (0, ""))[1].splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1] if "resident" in line or "chunked" in line else None
        elif entry and ("registers" in line or "spill" in line):
            print(f"variant {name}: ptxas {entry}: {line.strip()}")
    g = torch.Generator(device="cuda").manual_seed(24)
    for label, (b, h, tq, tk, dh), kind in PADDED_SHAPES:
        q, k, v, mask = cs.attention_inputs(g, b, h, tq, tk, dh, kind == "random")
        if isinstance(kind, tuple):
            mask = _length_mask(g, b, tk, *kind)
        skip_run, skipped = cs.attention_yardstick("masked_attention_forward_resident",
                                                   q, k, v, mask)
        dense_run, dense = cs.attention_yardstick("masked_attention_forward_dense",
                                                  q, k, v, mask)
        skip_run()
        dense_run()
        plain = attention.attention_reference(q, k, v, mask)
        dead = 0.0
        same_poisoned = True
        if mask is not None:
            hole = cs.dead_key_tiles(mask)
            dead = hole.float().mean().item()
            nan = float("nan")
            kp = k.masked_fill(hole[:, None, :, None], nan)
            vp = v.masked_fill(hole[:, None, :, None], nan)
            poison_run, poisoned = cs.attention_yardstick("masked_attention_forward_resident",
                                                          q, kp, vp, mask)
            poison_run()
            torch.cuda.synchronize()
            same_poisoned = torch.equal(poisoned, skipped)
        torch.cuda.synchronize()
        err = (skipped - plain).abs().max().item()
        ok = torch.allclose(skipped, plain, rtol=cs.ATTN_RTOL, atol=cs.ATTN_ATOL)
        ms = [cs.graph_ms(skip_run)]
        dense_ms = [cs.graph_ms(dense_run), cs.graph_ms(dense_run)]
        ms.append(cs.graph_ms(skip_run))
        bound, by = cs.attention_bound(b, h, tq, tk, dh, mask)
        plain_ms = cs.graph_ms(lambda: attention.attention_reference(q, k, v, mask))
        sdpa_mask = None if mask is None else mask[:, None, None, :].clone()
        if sdpa_mask is not None:
            sdpa_mask[~mask.any(1)] = True   # SDPA's all-masked row would be NaN
        sdpa = cs.graph_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=sdpa_mask))
        print(f"variant {name}: {label} {(b, h, tq, tk, dh)}: dead keys {dead:.3f}; "
              f"skipping {ms[0]:.5f} / {ms[1]:.5f} ms, dense {dense_ms[0]:.5f} / "
              f"{dense_ms[1]:.5f} ms (dense / skipping {sum(dense_ms) / sum(ms):.3f}); same bits "
              f"as dense {torch.equal(skipped, dense)}, with NaN in the dead tiles "
              f"{same_poisoned}; max_abs_err {err:.3e} within tolerance {ok}; bound "
              f"{bound:.6f} ms ({by}); plain {plain_ms:.5f} ms; SDPA {sdpa:.5f} ms on {card}")


# (label, (B, H, Tq, Tk, Dh), mask) of the long_keys arm: the heads past
# the resident kernel's reach (chip_smoke.LONG_KEY_SHAPES), and the heads
# it takes on the model paths, on which the resident -> mma crossover is
# decided
LONG_KEY_SHAPES = (
    ("chunked shape, 512 keys", (16, 2, 512, 512, 32), "random"),
    ("1000 keys, Dh 16", (2, 2, 20, 1000, 16), "random"),
    ("256 keys, Dh 128", (2, 2, 20, 256, 128), "random"),
    ("300 keys, Dh 64, unmasked", (1, 1, 300, 300, 64), None))
CROSSOVER_SHAPES = (
    ("CUB cub_r2 encoder", (32, 2, 246, 246, 32), (40, 70)),
    ("CUB config_cub encoder", (16, 2, 246, 246, 32), (40, 70)),
    ("CUB encoder, 150 captions", (150, 2, 246, 246, 32), (40, 70)),
    ("CUB encoder, unmasked", (32, 2, 246, 246, 32), None),
    ("VILANRO action encoder", (64, 2, 100, 100, 16), (5, 7)),
    ("flagship text encoder", (128, 2, 45, 45, 32), "random"),
    ("Enc_VIT", (24, 8, 17, 17, 32), None),
    ("SPRITES fp32 H axis, M*K*B 240", (30720, 2, 16, 16, 32), None),
    ("SPRITES fp32 H axis, bs 16", (2048, 2, 16, 16, 32), None),
    ("many query rows, two heads", (1, 2, 1000, 45, 32), None),
    ("few heads, 130 keys", (4, 2, 130, 130, 16), "random"),
    ("17 rows, 200 keys", (8, 2, 17, 200, 32), "random"),
    ("100 rows, 17 keys", (64, 2, 100, 17, 32), None),
    ("Dh 64 at the text length", (24, 4, 45, 45, 64), "random"))


def measure_long_keys(name: str, root: str) -> None:
    """The ``long_keys`` arm, in its own process: at every shape of
    :data:`LONG_KEY_SHAPES` the launcher (``masked_attention_mma``) against
    the chunked kernel, at every shape of :data:`CROSSOVER_SHAPES` the
    resident kernel (where it holds the head) against the tensor-core
    kernel; each side's route, error against the plain version and bits
    twice, then A B B A twice (device ms, graphed) with each side's spread,
    beside the fp32 operation bound over the needed keys, the 3xTF32 MMA
    bound, the plain version and SDPA under the same mask."""
    sys.path.insert(0, root)
    import torch
    import torch.nn.functional as F
    import chip_smoke as cs
    from multimodal_vae_comparison_tpu_torch.device import set_numerics
    from multimodal_vae_comparison_tpu_torch.ops.kernels import _build, attention, telemetry
    set_numerics()
    card = cs.card_line()
    built = _build.build(("attention",))
    print(f"variant {name}: built in {max((t for t, _ in built.values()), default=0.0):.2f} s "
          f"on {card}")
    entry = None
    for line in built.get("attention", (0, ""))[1].splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1] if "attention_mma" in line else None
        elif entry and ("registers" in line or "spill" in line):
            print(f"variant {name}: ptxas {entry}: {line.strip()}")
    g = torch.Generator(device="cuda").manual_seed(26)
    for arm, shapes, old_sym, new_sym in (
            ("long keys", LONG_KEY_SHAPES, "masked_attention_forward_chunked", None),
            ("crossover", CROSSOVER_SHAPES, "masked_attention_forward_resident_only",
             "masked_attention_forward_mma")):
        for label, (b, h, tq, tk, dh), kind in shapes:
            q, k, v, mask = cs.attention_inputs(g, b, h, tq, tk, dh, kind == "random")
            if isinstance(kind, tuple):
                mask = _length_mask(g, b, tk, *kind)
            old_run, old = cs.attention_yardstick(old_sym, q, k, v, mask)
            if new_sym is None:
                new_out = {}

                def new_run():
                    new_out["out"] = attention._launch(q, k, v, mask)
            else:
                new_run, new = cs.attention_yardstick(new_sym, q, k, v, mask)
            telemetry.reset()
            new_run()
            took = telemetry.variants()
            first = (new_out["out"] if new_sym is None else new).clone()
            new_run()
            old_run()
            plain = attention.attention_reference(q, k, v, mask)
            torch.cuda.synchronize()
            got = new_out["out"] if new_sym is None else new
            errs = [(x - plain).abs().max().item() for x in (got, old)]
            oks = [torch.allclose(x, plain, rtol=cs.ATTN_RTOL, atol=cs.ATTN_ATOL)
                   for x in (got, old)]
            times = {"new": [], "old": []}
            for side in ("new", "old", "old", "new") * 2:
                times[side].append(cs.graph_ms(new_run if side == "new" else old_run))
            spread = {s_: max(t) - min(t) for s_, t in times.items()}
            bound, by = cs.attention_bound(b, h, tq, tk, dh, mask)
            mma_bound = cs.attention_mma_bound(b, h, tq, tk, dh, mask)
            plain_ms = cs.graph_ms(lambda: attention.attention_reference(q, k, v, mask))
            sdpa_mask = None if mask is None else mask[:, None, None, :].clone()
            if sdpa_mask is not None:
                sdpa_mask[~mask.any(1)] = True   # SDPA's all-masked row would be NaN
            sdpa = cs.graph_ms(lambda: F.scaled_dot_product_attention(q, k, v,
                                                                       attn_mask=sdpa_mask))
            old_name = old_sym[len("masked_attention_forward_"):]
            print(f"variant {name}: {arm}: {label} {(b, h, tq, tk, dh)}: mma "
                  f"{'launcher ' + str(took) if new_sym is None else 'yardstick'} "
                  f"{min(times['new']):.5f} .. {max(times['new']):.5f} ms (spread "
                  f"{spread['new']:.5f}), {old_name} {min(times['old']):.5f} .. "
                  f"{max(times['old']):.5f} ms (spread {spread['old']:.5f}); "
                  f"{old_name} / mma {sum(times['old']) / sum(times['new']):.3f}; max_abs_err "
                  f"mma {errs[0]:.3e} ({oks[0]}), {old_name} {errs[1]:.3e} ({oks[1]}); same "
                  f"bits twice {torch.equal(first, got)}; bound {bound:.6f} ms ({by}), 3xTF32 "
                  f"MMA bound {mma_bound:.6f} ms; plain {plain_ms:.5f} ms; SDPA {sdpa:.5f} ms "
                  f"on {card}")


def measure_launcher(root: str) -> None:
    """The ``--against`` arm's process, the package and ``chip_smoke``
    imported from ``root`` (this checkout or an unpacked earlier one): the
    fp32 launcher's device ms (graphed, twice) at every shape of
    :data:`PADDED_SHAPES` and the resident route
    (``masked_attention_forward_resident``) at SPRITES' fp32 8 x 8 heads,
    on inputs drawn from one seed in every process, and ptxas's registers
    of the resident kernel's fp32 instances.  It uses only what an earlier
    ``chip_smoke.py`` has too (``graph_ms``, ``attention_inputs``)."""
    sys.path.insert(0, root)
    import ctypes
    import torch
    import chip_smoke as cs
    from multimodal_vae_comparison_tpu_torch.device import set_numerics
    from multimodal_vae_comparison_tpu_torch.ops.kernels import _build, attention
    if not os.path.abspath(_build.CSRC).startswith(os.path.abspath(root)):
        raise RuntimeError(f"the package was imported from {_build.CSRC}, not from {root}")
    set_numerics()
    tag = os.path.relpath(root, HERE)
    built = _build.build(("attention",))
    entry = None
    for line in built.get("attention", (0, ""))[1].splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1] if "residentIf" in line else None
        elif entry and "registers" in line:
            kpl_slots = entry.split("residentIfLi")[1].split("EEEv")[0].replace("ELi", ",")
            print(f"against {tag}: resident<float,{kpl_slots}> {line.split(':')[-1].strip()}")
    resident = _build.function("attention", "masked_attention_forward_resident",
                               [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                               + [ctypes.c_float, ctypes.c_void_p])
    g = torch.Generator(device="cuda").manual_seed(25)
    cases = [(label, shape, kind, False)
             for label, shape, kind in PADDED_SHAPES + LONG_KEY_SHAPES[1:]] + [
        ("SPRITES fp32 T axis, M*K*B 240 (resident route)", (61440, 2, 8, 8, 32), None, True),
        ("SPRITES fp32 T axis, bs 16 (resident route)", (4096, 2, 8, 8, 32), None, True)]
    for label, (b, h, tq, tk, dh), kind, yard in cases:
        q, k, v, mask = cs.attention_inputs(g, b, h, tq, tk, dh, kind == "random")
        if isinstance(kind, tuple):
            mask = _length_mask(g, b, tk, *kind)
        out = torch.empty(q.shape, device="cuda")

        def run():
            if not yard:
                return attention._launch(q, k, v, mask)
            return _build.check("attention", resident(
                q.data_ptr(), k.data_ptr(), v.data_ptr(),
                None if mask is None else mask.data_ptr(), out.data_ptr(), b, h, tq, tk, dh,
                dh ** -0.5, torch.cuda.current_stream().cuda_stream))
        ms = [cs.graph_ms(run), cs.graph_ms(run)]
        print(f"against {tag}: {label} {(b, h, tq, tk, dh)}: {ms[0]:.5f} / {ms[1]:.5f} ms on "
              f"{cs.card_line()}")


def _per_subset_poe():
    """The PoE Function of the old route: the kernel on one subset's stacked
    (E, ..., D) experts, the closed form of ``_poe_bwd`` in torch ops."""
    import torch
    from torch.autograd.function import once_differentiable
    from multimodal_vae_comparison_tpu_torch.constants import EPS
    from multimodal_vae_comparison_tpu_torch.ops.kernels import poe_kernel

    class PerSubsetPoE(torch.autograd.Function):
        @staticmethod
        def forward(ctx, mus, scales, prior_precision):
            mu, scale = poe_kernel._launch_forward(
                mus.unbind(0), scales.unbind(0), poe_kernel.lattice_masks(
                    [tuple(range(mus.shape[0]))], mus.shape[0]), prior_precision, 1)
            mu, scale = mu[0], scale[0]
            ctx.save_for_backward(mus, scales, mu, scale)
            return mu, scale

        @staticmethod
        @once_differentiable
        def backward(ctx, g_mu, g_scale):
            mus, scales, mu, scale = ctx.saved_tensors
            var = scales.square() + EPS
            inv_denom = scale.square()
            d_mus = g_mu[None] * (1.0 / var) * inv_denom[None]
            g_prec = (g_mu * inv_denom)[None] * (mus - mu[None]) \
                + (g_scale * (-0.5) * inv_denom * scale)[None]
            return d_mus, g_prec * (-2.0 * scales / var.square()), None

    return PerSubsetPoE


def _per_modality_kl():
    """The KL Function of the old route: the kernel on one posterior, the
    closed form of ``_kl_bwd`` in torch ops."""
    import torch
    from torch.autograd.function import once_differentiable
    from multimodal_vae_comparison_tpu_torch.ops.kernels import kl_kernel

    class PerModalityKL(torch.autograd.Function):
        @staticmethod
        def forward(ctx, mu, scale):
            ctx.save_for_backward(mu, scale)
            return kl_kernel._launch_forward([mu], [scale], mu.shape[:-1])

        @staticmethod
        @once_differentiable
        def backward(ctx, g):
            mu, scale = ctx.saved_tensors
            g = g[..., None]
            return g * mu, g * (scale - 1.0 / scale)

    return PerModalityKL


def old_route(model):
    """Make ``model`` (POE or MOE, on the card) take the old route until the
    returned function is called: per subset two ``torch.stack``s and one PoE
    launch (``POE.lattice_joints``), per modality one KL launch and then a
    stack (``MMVAE.kld_std_all``), each backward in torch ops."""
    import types
    import torch
    from multimodal_vae_comparison_tpu_torch.models.distributions import Normal
    poe, kl = _per_subset_poe(), _per_modality_kl()

    def lattice_joints(self, qz_params, lattice):
        joints = []
        for subset in lattice:
            present = [self.mod_names[i] for i in subset]
            mus = torch.stack([qz_params[n]["shared"][0] for n in present])
            scales = torch.stack([qz_params[n]["shared"][1] for n in present])
            joints.append(Normal(*poe.apply(mus, scales, 1.0)))
        return joints

    def kld_std_all(self, dists):
        return torch.stack([kl.apply(dists[s.name].loc.contiguous(),
                                     dists[s.name].scale.contiguous()) for s in self.specs])

    model.lattice_joints = types.MethodType(lattice_joints, model)
    model.kld_std_all = types.MethodType(kld_std_all, model)

    def restore():
        del model.lattice_joints, model.kld_std_all
    return restore


def measure_poe(name: str, root: str) -> None:
    """The ``poe_`` variants, in their own process as :func:`measure`."""
    sys.path.insert(0, root)
    import torch
    import chip_smoke as cs
    from multimodal_vae_comparison_tpu_torch.ops.fusion import subset_lattice
    from multimodal_vae_comparison_tpu_torch.ops.kernels import _build, poe_kernel
    if not os.path.abspath(_build.CSRC).startswith(os.path.abspath(root)):
        raise RuntimeError(f"the package was imported from {_build.CSRC}, not from {root}")
    card = cs.card_line()
    built = _build.build(("poe",))
    regs = [line.split("Used")[1].split(",")[0].strip() for line in built["poe"][1].splitlines()
            if "registers" in line and "Used" in line]
    print(f"variant {name}: built, ptxas {regs} (backward, forward) on {card}")
    g = torch.Generator(device="cuda").manual_seed(31)
    for m, lattice, rows in ((2, [(0, 1)], 128), (2, subset_lattice(2), cs.TRAIN_BATCH),
                             (5, subset_lattice(5), cs.TRAIN_BATCH)):
        mus, scales = cs.lattice_inputs(g, m, rows)
        masks = poe_kernel.lattice_masks(lattice, m)
        bits = poe_kernel.prior_bits(None, len(lattice))
        ups = [torch.randn((len(lattice), rows, cs.N_LATENTS), generator=g, device="cuda")
               for _ in range(2)]
        mu, scale = poe_kernel._launch_forward(mus, scales, masks, 1.0, bits)
        grads = poe_kernel._launch_backward(mus, scales, masks, mu, scale, *ups)
        want = poe_kernel.poe_lattice_reference(mus, scales, lattice, 1.0)
        want_grads = poe_kernel.poe_lattice_backward_reference(mus, scales, mu, scale, *ups,
                                                               lattice)
        err = max((a - b).abs().max().item() for a, b in zip((mu, scale), want))
        err_bwd = max((a - b).abs().max().item()
                      for a, b in zip(sum(map(list, grads), []), sum(want_grads, [])))
        fwd = [cs.graph_ms(lambda: poe_kernel._launch_forward(mus, scales, masks, 1.0, bits))
               for _ in range(2)]
        bwd = [cs.graph_ms(lambda: poe_kernel._launch_backward(mus, scales, masks, mu, scale,
                                                               *ups)) for _ in range(2)]
        print(f"variant {name}: poe_lattice M={m} S={len(lattice)} ({rows}, {cs.N_LATENTS}): "
              f"forward {fwd[0]:.5f} and {fwd[1]:.5f} ms, max_abs_err {err:.3e}; backward "
              f"{bwd[0]:.5f} and {bwd[1]:.5f} ms, max_abs_err {err_bwd:.3e}")


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--launcher":
        measure_launcher(os.path.abspath(sys.argv[2]))
        return 0
    if len(sys.argv) in (3, 4) and sys.argv[1] == "--against":
        # the earlier checkout, this one (or a variant's), this one, the
        # earlier one: each a process of its own on the same card
        other = os.path.abspath(sys.argv[2])
        if len(sys.argv) == 4:
            make_variant(sys.argv[3])
        this = (os.path.join(HERE, "build", "archive", f"variant_{sys.argv[3]}")
                if len(sys.argv) == 4 else HERE)
        for root in (other, this, this, other):
            done = subprocess.run([sys.executable, os.path.abspath(__file__), "--launcher", root],
                                  cwd=HERE, capture_output=True, text=True, timeout=600)
            print("\n".join(x for x in done.stdout.splitlines() if x.startswith("against")),
                  flush=True)
            if done.returncode != 0:
                print(f"against {root}: failed\n{done.stderr[-3000:]}", flush=True)
                return 1
        return 0
    if len(sys.argv) == 3 and sys.argv[1] == "--measure":
        name = sys.argv[2]
        (measure_poe if name.startswith("poe_")
         else measure_routes if name in ("few_keys", "few_keys_bf16", "short_bf16")
         else measure_padded if name == "padded_tiles"
         else measure_long_keys if name == "long_keys" else measure)(
            name, os.path.join(HERE, "build", "archive", f"variant_{name}"))
        return 0
    names = sys.argv[1:] or list(VARIANTS)
    unknown = [n for n in names if n not in VARIANTS]
    if unknown:
        print(f"unknown variants {unknown}; known: {list(VARIANTS)}", file=sys.stderr)
        return 2
    for name in names:
        make_variant(name)
        done = subprocess.run([sys.executable, os.path.abspath(__file__), "--measure", name],
                              cwd=HERE, capture_output=True, text=True, timeout=900)
        lines = [line for line in done.stdout.splitlines()
                 if line.startswith(("variant", "video parity"))]
        print("\n".join(lines), flush=True)
        if done.returncode != 0:
            print(f"variant {name}: failed\n{done.stderr[-3000:]}", flush=True)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
