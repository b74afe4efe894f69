"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``multimodal_vae_comparison_tpu_torch/
csrc/``, holds each against its plain PyTorch version (forward, and the
backward of its autograd Function) at the main paths' shapes, then drives
two main paths at full width with random weights from a seed:

* serving: the CdSprites+ PoE model through ``InferenceEngine`` and its
  HTTP server;
* training: the flagship POE and the MOE of ``configs/config_cdspritesplus.yml``
  through ``build_model`` -> ``make_optimizer`` -> ``make_train_step``,
  after holding their loss, metrics and every gradient on the card against
  the CPU's plain path.

Each path runs with the kernel counts set to 0 just before it and read just
after, and must have launched every kernel it goes through and taken no
plain version.  Then it times the kernels, the engine and the train step,
and profiles the train step (``torch.profiler``).
It prints the card's name and power limit, one ``{"kernels": [...]}`` JSON
line, and as its last line ``{"ok": true, "device": {...}}``.  Any failed
phase raises, so the script exits non-zero before the last line; without
CUDA it exits 1 at once.  Imports nothing of JAX.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
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

ATTN_RTOL, ATTN_ATOL = 2e-4, 2e-5   # as the reference's Pallas attention test
POE_RTOL, POE_ATOL = 1e-5, 1e-6     # elementwise fp32, one reduction over E
KL_RTOL, KL_ATOL = 1e-5, 1e-6       # elementwise fp32, one reduction over D
# training on the card vs the CPU, per parameter: max abs error of the
# gradient <= GRAD_REL * max |grad of the leaf| + GRAD_ATOL (fp32 sums in
# another order, TF32 off); loss and metrics within TRAIN_RTOL
GRAD_REL, GRAD_ATOL, TRAIN_RTOL = 1e-4, 1e-5, 1e-5
TRAIN_BATCH, TRAIN_STEPS, TRAIN_LR = 24, 30, 1e-3
STEP_BATCHES = (24, 256)
# whole model, kernels + cuBLAS/cuDNN in fp32 (TF32 off) vs the CPU's plain
# path: sums are taken in another order through ~12 layers
SLICE_RTOL, SLICE_ATOL = 1e-4, 1e-4

PRESENTS = (("mod_1",), ("mod_2",), ("mod_1", "mod_2"))
KERNEL_OF = {"masked_attention": "attention", "poe_fused": "poe",
             "kl_normal_std_fused": "kl"}
BUCKETS = (1, 8, 32, 128)
SERVE_SIZES = (1, 5, 32, 128, 300)
SEQ_LEN, VOCAB, N_LATENTS = 45, 27, 16


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
    g = torch.Generator(device="cuda").manual_seed(0)
    for shape, masked in (((128, 2, 45, 45, 32), True),
                          ((128, 2, 45, 1, 8), False),
                          ((4, 2, 130, 130, 16), True)):
        q, k, v, mask = attention_inputs(g, *shape, masked)
        got = attention.masked_attention(q, k, v, mask)
        want = attention.attention_reference(q, k, v, mask)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        ok = torch.allclose(got, want, rtol=ATTN_RTOL, atol=ATTN_ATOL)
        print(f"parity attention {shape} mask={masked}: max_abs_err={err:.3e} "
              f"(rtol {ATTN_RTOL}, atol {ATTN_ATOL})")
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
    print(f"parity backward {label}: max_abs_err={err:.3e} (rtol {rtol}, atol {atol})")
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
            loss, metrics = model.objective(torch_batch(raw, dev), eps=eps_to(eps, dev))
            loss.backward()
            out[dev] = (loss.item(), {k: v.item() for k, v in metrics.items()},
                        {n: (torch.zeros_like(p) if p.grad is None else p.grad).cpu()
                         for n, p in model.named_parameters()})
        (gl, gm, gg), (cl, cm, cg) = out["cuda"], out["cpu"]
        print(f"train parity {label}: loss cuda {gl:.6f} cpu {cl:.6f}; metrics "
              + ", ".join(f"{k} {gm[k]:.6f}/{cm[k]:.6f}" for k in sorted(gm)))
        check(np.isfinite(gl) and abs(gl - cl) <= TRAIN_RTOL * abs(cl),
              f"{label}: loss {gl} on the card vs {cl} on the CPU")
        check(sorted(gm) == sorted(cm), f"{label}: metric keys differ")
        for k in gm:
            check(abs(gm[k] - cm[k]) <= TRAIN_RTOL * abs(cm[k]) + 1e-4,
                  f"{label}: metric {k} {gm[k]} on the card vs {cm[k]} on the CPU")
        worst, worst_name = 0.0, None
        for n in cg:
            limit = GRAD_REL * cg[n].abs().max().item() + GRAD_ATOL
            ratio = (gg[n] - cg[n]).abs().max().item() / limit
            if ratio > worst:
                worst, worst_name = ratio, n
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
        want = {"attention", "poe"} if mixing == "poe" else {"attention", "kl"}
        check(set(per_step[label]) == want,
              f"{label}: launched {sorted(per_step[label])}, expected {sorted(want)}")
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


def phase_train_times(card):
    """The KL kernel, the attention backward at the encoder training shape,
    and the train step of each model at each batch size."""
    import types
    from multimodal_vae_comparison_tpu_torch.ops.kernels import attention, kl_kernel
    from multimodal_vae_comparison_tpu_torch.training.optim import make_optimizer
    from multimodal_vae_comparison_tpu_torch.training.trainer import (
        build_model, make_train_step)
    g = torch.Generator(device="cuda").manual_seed(14)
    rows, d = [], N_LATENTS
    mu = torch.randn(TRAIN_BATCH, d, generator=g, device="cuda")
    scale = torch.rand(TRAIN_BATCH, d, generator=g, device="cuda") + 0.3
    kern = graph_ms(lambda: kl_kernel.kl_normal_std_fused(mu, scale))
    plain = graph_ms(lambda: kl_kernel.kl_reference(mu, scale))
    kern_eager = eager_ms(lambda: kl_kernel.kl_normal_std_fused(mu, scale))
    n = TRAIN_BATCH * d
    bound, by = bound_ms(4 * (2 * n + TRAIN_BATCH), 8 * n)
    err = (kl_kernel.kl_normal_std_fused(mu, scale)
           - kl_kernel.kl_reference(mu, scale)).abs().max().item()
    rows.append({"name": "kl_normal_std_fused", "at": f"({TRAIN_BATCH}, {d})",
                 "route": "cuda",
                 "source": "multimodal_vae_comparison_tpu_torch/csrc/kl.cu",
                 "replaces": "multimodal_vae_comparison_tpu/ops/pallas/kl_kernel.py:30",
                 "max_abs_err": err, "ms": kern, "plain_ms": plain, "bound_ms": bound,
                 "bound_by": by, "library_ms": None, "eager_ms": kern_eager})
    print(f"time kl_normal_std_fused [({TRAIN_BATCH}, {d})]: kernel {kern:.5f} ms (eager "
          f"{kern_eager:.5f}), plain {plain:.5f} ms, library ms: none, bound "
          f"{bound:.7f} ms ({by}) on {card}")
    # the attention Function's backward (recompute + five products), device
    # time back to back, at the encoder's training shape
    q, k, v, mask = attention_inputs(g, TRAIN_BATCH, 2, SEQ_LEN, SEQ_LEN, 32, True)
    d_out = torch.randn(q.shape, generator=g, device="cuda")
    ctx = types.SimpleNamespace(saved_tensors=(q, k, v, mask))
    bwd = attention._MaskedAttention.backward
    bwd_ms = graph_ms(lambda: bwd(ctx, d_out))
    bwd_eager = eager_ms(lambda: bwd(ctx, d_out))
    print(f"time attention backward [({TRAIN_BATCH}, 2, {SEQ_LEN}, {SEQ_LEN}, 32) masked]: "
          f"{bwd_ms:.5f} ms (eager {bwd_eager:.5f}) on {card}")
    for label, mixing, obj in training_models():
        model = build_model(flagship_specs(), mixing, N_LATENTS, obj=obj, seed=0,
                            device="cuda")
        step = make_train_step(model, make_optimizer("adam", TRAIN_LR, model.parameters()))
        gen = torch.Generator(device="cuda").manual_seed(15)
        for n in STEP_BATCHES:
            batch = torch_batch(make_inputs(np.random.default_rng(16), n), "cuda")
            for _ in range(3):
                step(batch, generator=gen)
            torch.cuda.synchronize()
            lat = []
            for _ in range(20):
                t0 = time.perf_counter()
                step(batch, generator=gen)
                torch.cuda.synchronize()
                lat.append((time.perf_counter() - t0) * 1e3)
            p50 = statistics.median(lat)
            print(f"time train step {label} batch {n}: p50 {p50:.3f} ms, min "
                  f"{min(lat):.3f} ms over 20, {n / p50 * 1e3:.1f} samples/s on {card}")
    return rows, {"attention_bwd_ms": bwd_ms, "attention_bwd_eager_ms": bwd_eager}


def phase_train_profile(card, steps: int = 10):
    """Where a train step's time goes: ``steps`` steps per model and batch
    size under ``torch.profiler``; one JSON line each with host wall ms,
    device kernel ms, the device's busy share (union of kernel intervals
    over the wall time), launches per step, the port's kernels' device ms
    and the kernels that take the most device time."""
    import collections
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from multimodal_vae_comparison_tpu_torch.training.optim import make_optimizer
    from multimodal_vae_comparison_tpu_torch.training.trainer import (
        build_model, make_train_step)
    symbols = {"masked_attention": "masked_attention_fwd", "poe_fused": "poe_fwd",
               "kl_normal_std_fused": "kl_std_fwd"}
    for label, mixing, obj in training_models():
        model = build_model(flagship_specs(), mixing, N_LATENTS, obj=obj, seed=0,
                            device="cuda")
        step = make_train_step(model, make_optimizer("adam", TRAIN_LR, model.parameters()))
        gen = torch.Generator(device="cuda").manual_seed(17)
        for n in STEP_BATCHES:
            batch = torch_batch(make_inputs(np.random.default_rng(18), n), "cuda")
            for _ in range(3):
                step(batch, generator=gen)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(steps):
                    step(batch, generator=gen)
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
            # device events less the ranges that annotate them: the
            # optimizer's "Optimizer.step#..." span lies on the device
            # timeline too
            kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
                       and not getattr(e, "is_user_annotation", False)
                       and not e.name.startswith("Optimizer.")]
            check(bool(kernels), "the profiler recorded no CUDA kernel")
            per_name = collections.Counter()
            for e in kernels:
                per_name[e.name] += e.time_range.elapsed_us()
            busy = busy_ms([(e.time_range.start, e.time_range.end) for e in kernels])
            print("profile train step " + json.dumps({
                "model": label, "batch": n, "steps": steps,
                "wall_ms_per_step": wall_ms / steps,
                "kernel_ms_per_step": sum(per_name.values()) / 1e3 / steps,
                "device_busy_share": busy / wall_ms,
                "kernels_per_step": len(kernels) / steps,
                "port_kernels_ms_per_step": {
                    k: sum(us for name, us in per_name.items() if sym in name) / 1e3 / steps
                    for k, sym in symbols.items()},
                "top_kernels_ms_per_step": {
                    name[:80]: us / 1e3 / steps for name, us in per_name.most_common(5)},
                "card": card}))


def phase_times(engine, card):
    import torch.nn.functional as F
    from multimodal_vae_comparison_tpu_torch.ops.kernels import attention, poe_kernel
    g = torch.Generator(device="cuda").manual_seed(3)
    rows = []
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
                     "library_ms": lib, "eager_ms": kern_eager})
    for e in (2, 1):
        mus = torch.randn(e, 128, N_LATENTS, generator=g, device="cuda")
        scales = torch.rand(e, 128, N_LATENTS, generator=g, device="cuda") + 0.3
        kern = graph_ms(lambda: poe_kernel.poe_fused(mus, scales, 1.0))
        plain = graph_ms(lambda: poe_kernel.poe_reference(mus, scales, 1.0))
        kern_eager = eager_ms(lambda: poe_kernel.poe_fused(mus, scales, 1.0))
        n = 128 * N_LATENTS
        bound, by = bound_ms(4 * (2 * e * n + 2 * n), 5 * e * n + 3 * n)
        err = max((a - b).abs().max().item() for a, b in zip(
            poe_kernel.poe_fused(mus, scales, 1.0), poe_kernel.poe_reference(mus, scales, 1.0)))
        rows.append({"name": "poe_fused", "at": f"E={e} (128, {N_LATENTS})",
                     "route": "cuda",
                     "source": "multimodal_vae_comparison_tpu_torch/csrc/poe.cu",
                     "replaces": "multimodal_vae_comparison_tpu/ops/pallas/poe_kernel.py:48",
                     "max_abs_err": err,
                     "ms": kern, "plain_ms": plain, "bound_ms": bound, "bound_by": by,
                     "library_ms": None, "eager_ms": kern_eager})
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
    for name, (_, log) in sorted(built.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")

    # 3. kernel parity: forwards, then the Functions' backwards
    phase_parity()
    phase_kl_parity()
    phase_backward_parity()

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

    # 6. the training path: POE and MOE, 30 steps each + one accumulated step
    telemetry.reset()          # counts of the training path only, from here
    per_step = phase_train()
    torch.cuda.synchronize()
    train_launches, paths = telemetry.launches(), telemetry.summary()
    print(f"training path launches: {train_launches}; dispatch: {paths}")
    check(not any(k.endswith(":plain") for k in paths),
          f"a plain version ran on the training path: {paths}")
    check(all(train_launches.get(k, 0) > 0 for k in ("attention", "poe", "kl")),
          f"a kernel of the training path never launched: {train_launches}")

    # 7. times
    rows = phase_times(engine, card)
    kl_rows, extra = phase_train_times(card)
    rows += kl_rows
    phase_train_profile(card)
    print(card)
    # one entry per kernel, at its heaviest main-path shape (the first row
    # of each); the other shapes are on the "time" lines above.  launches:
    # the training path's run (this slice's main path), with the serving
    # path's beside it
    primary = list({r["name"]: r for r in reversed(rows)}.values())[::-1]
    for r in primary:
        kernel = KERNEL_OF[r["name"]]
        r["launches"] = train_launches.get(kernel, 0)
        r["launches_serving_path"] = serve_launches.get(kernel, 0)
        r["launches_per_train_step"] = {label: n.get(kernel, 0)
                                        for label, n in per_step.items()}
    primary[0].update(extra)   # masked_attention: its backward's time
    print(json.dumps({"kernels": primary}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
