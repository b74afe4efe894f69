"""Design choices of the redesigned kernels, measured against each other.

    python3 kernel_variants.py [variant ...]

For each named variant (all of them with no arguments) this copies the
port's package into ``build/archive/variant_<name>/``, edits one constant or
line of a CUDA source there, builds it, and in a process of its own prints:

* the error of the sparse forward against its plain version and its time at
  the video model's decoder and encoder shapes, the same for the sparse
  backward's dq and dk/dv kernels (error of the Function's gradients against
  autograd through the plain version; registers at Dh 32 from ptxas), and the
  masked attention's time at the text encoder's and decoder's shapes (device
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
* ``bwd_three_blocks``: the sparse dq and dk/dv kernels compiled for three
  thread blocks an SM (at most 168 registers a thread), not two;
* ``bwd_rows_in_smem``: their resident operands at Dh 32 (q and d_out, k
  and v) read from rows staged in shared memory, as for Dh 64, not held in
  registers.

Needs one NVIDIA GPU and ``nvcc``; imports nothing of JAX.
"""
from __future__ import annotations

import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
PACKAGE = "multimodal_vae_comparison_tpu_torch"
SPARSE = f"{PACKAGE}/csrc/sparse_attention.cu"
ATTENTION = f"{PACKAGE}/csrc/attention.cu"

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
    "bwd_three_blocks": [(SPARSE, f"__launch_bounds__(MMA_WARPS * 32)\n{name}(",
                          f"__launch_bounds__(MMA_WARPS * 32, 3)\n{name}(")
                         for name in ("sparse_dq_mma", "sparse_dkv_mma")],
    "bwd_rows_in_smem": [(SPARSE, "rows_in_smem(int dhp) { return dhp > 32; }",
                          "rows_in_smem(int dhp) { return dhp > 16; }")],
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
    from multimodal_vae_comparison_tpu_torch.ops.kernels import _build, attention
    from multimodal_vae_comparison_tpu_torch.ops.kernels import sparse_attention as sp
    if not os.path.abspath(_build.CSRC).startswith(os.path.abspath(root)):
        raise RuntimeError(f"the package was imported from {_build.CSRC}, not from {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    built = _build.build(("attention", "sparse_attention"))
    print(f"variant {name}: built in {max((t for t, _ in built.values()), default=0.0):.2f} s on {card}")
    kernel = None
    for line in built["sparse_attention"][1].splitlines():
        if "Compiling entry function" in line:
            kernel = next((k for k in ("sparse_dq_mmaILi32", "sparse_dkv_mmaILi32") if k in line),
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
                                 ("decoder", (128, 2, 45, 1, 8), False)):
        q, k, v, mask = cs.attention_inputs(g, *shape, masked)
        ok = torch.allclose(attention.masked_attention(q, k, v, mask),
                            attention.attention_reference(q, k, v, mask),
                            rtol=cs.ATTN_RTOL, atol=cs.ATTN_ATOL)
        ms = [cs.graph_ms(lambda: attention.masked_attention(q, k, v, mask)) for _ in range(2)]
        print(f"variant {name}: masked attention {label} {shape}: {ms[0]:.5f} and "
              f"{ms[1]:.5f} ms, within tolerance: {ok}")
    try:
        cs.phase_video_parity()
    except RuntimeError as e:   # a failed check of chip_smoke: the finding, not a fault
        print(f"variant {name}: {e}")


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--measure":
        measure(sys.argv[2], os.path.join(HERE, "build", "archive", f"variant_{sys.argv[2]}"))
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
