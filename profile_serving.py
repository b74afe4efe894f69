"""Where the time of ``InferenceEngine.generate`` goes on the card.

    python3 profile_serving.py [--calls 20] [--out build/serving_profile]

Builds the full-width CdSprites+ PoE model of the PyTorch port (random
weights from a seed) on CUDA, warms every bucket, then for each bucket size
profiles ``--calls`` calls of ``generate`` with both modalities present
under ``torch.profiler`` (CPU and CUDA activities).  Prints one JSON line
per bucket: host wall ms per call, device kernel ms per call, the device's
busy share (union of kernel intervals over the wall time), kernel launches
per call, the device ms per call of each of the port's own kernels, and
the kernels that take the most device time.  A Chrome trace
per bucket goes under ``--out``.  Needs a CUDA device; imports no JAX.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from chip_smoke import BUCKETS, N_LATENTS, busy_ms, flagship_specs, make_inputs

# the port's kernels by a part of the name of their __global__ functions in csrc/
PORT_KERNELS = {"masked_attention": "masked_attention_", "poe_fused": "poe_lattice_fwd"}


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--calls", type=int, default=20)
    parser.add_argument("--out", default="build/serving_profile")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_serving: needs a CUDA device", file=sys.stderr)
        return 1
    from multimodal_vae_comparison_tpu_torch.device import set_numerics
    from multimodal_vae_comparison_tpu_torch.models import get_mixing
    from multimodal_vae_comparison_tpu_torch.serving.engine import (
        InferenceEngine, ModelHandle)

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    print(card)
    set_numerics()
    os.makedirs(args.out, exist_ok=True)
    model = get_mixing("poe")(flagship_specs(), N_LATENTS, seed=0, device="cuda")
    engine = InferenceEngine(ModelHandle(model), buckets=BUCKETS, device="cuda")
    rng = np.random.default_rng(0)
    for bucket in BUCKETS:
        inputs = make_inputs(rng, bucket)
        for _ in range(3):
            engine.generate(inputs, seed=0)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(args.calls):
                engine.generate(inputs, seed=0)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if not kernels:
            raise RuntimeError("the profiler recorded no CUDA kernel")
        per_name = collections.Counter()
        for e in kernels:
            per_name[e.name] += e.time_range.elapsed_us()
        device_ms = sum(per_name.values()) / 1e3
        busy = busy_ms([(e.time_range.start, e.time_range.end) for e in kernels])
        prof.export_chrome_trace(os.path.join(args.out, f"generate_n{bucket}.json"))
        print(json.dumps({
            "bucket": bucket, "present": ["mod_1", "mod_2"], "calls": args.calls,
            "wall_ms_per_call": wall_ms / args.calls,
            "kernel_ms_per_call": device_ms / args.calls,
            "device_busy_share": busy / wall_ms,
            "kernels_per_call": len(kernels) / args.calls,
            "port_kernels_ms_per_call": {
                kernel: sum(us for name, us in per_name.items() if symbol in name)
                / 1e3 / args.calls
                for kernel, symbol in PORT_KERNELS.items()},
            "top_kernels_ms_per_call": {
                name[:80]: us / 1e3 / args.calls
                for name, us in per_name.most_common(8)},
            "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
