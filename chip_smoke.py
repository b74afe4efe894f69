"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``multimodal_vae_comparison_tpu_torch/
csrc/``, holds each against its plain PyTorch version at the serving
path's shapes, serves the full-width CdSprites+ PoE model (random weights
from a seed) through ``InferenceEngine`` and its HTTP server, checks that
the served path launched every kernel and never took a plain version, and
times the kernels and the engine.  It prints the card's name and power
limit, one ``{"kernels": [...]}`` JSON line, and as its last line
``{"ok": true, "device": {...}}``.  Any failed phase raises, so the script
exits non-zero before the last line; without CUDA it exits 1 at once.
Imports nothing of JAX.
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
# whole model, kernels + cuBLAS/cuDNN in fp32 (TF32 off) vs the CPU's plain
# path: sums are taken in another order through ~12 layers
SLICE_RTOL, SLICE_ATOL = 1e-4, 1e-4

PRESENTS = (("mod_1",), ("mod_2",), ("mod_1", "mod_2"))
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


def phase_times(engine, launches, card):
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
                     "launches": launches.get("attention", 0), "max_abs_err": err,
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
                     "launches": launches.get("poe", 0), "max_abs_err": err,
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

    # 3. kernel parity
    phase_parity()

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

    telemetry.reset()          # counts of the main path only, from here
    phase_serve(engine)
    phase_http(engine, handle)
    torch.cuda.synchronize()
    launches, paths = telemetry.launches(), telemetry.summary()
    print(f"main path launches: {launches}; dispatch: {paths}")
    # per request chunk: attention 2 (both), 1 (image only), 2 (text only);
    # poe 1 each
    chunks = sum(-(-n // BUCKETS[-1]) for n in SERVE_SIZES) + 1  # +1: seed repeat
    want_attn = chunks * (2 + 1 + 2) + 6 * 2
    want_poe = chunks * 3 + 6
    check(launches.get("attention") == want_attn,
          f"attention launches {launches.get('attention')} != {want_attn}")
    check(launches.get("poe") == want_poe, f"poe launches {launches.get('poe')} != {want_poe}")
    check(not any(k.endswith(":plain") for k in paths),
          f"a plain version ran on the main path: {paths}")

    # 6. times
    rows = phase_times(engine, launches, card)
    print(card)
    # one entry per kernel, at its heaviest main-path shape (the first row
    # of each); the other shapes are on the "time" lines above
    primary = list({r["name"]: r for r in reversed(rows)}.values())[::-1]
    print(json.dumps({"kernels": primary}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
