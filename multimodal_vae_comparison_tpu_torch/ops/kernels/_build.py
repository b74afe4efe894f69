"""Build the CUDA sources under ``csrc/`` at first use and load them.

Each source is compiled by one ``nvcc`` call for ``sm_90a`` into a shared
library with a plain C interface, loaded with ``ctypes``.  The library goes
into ``build/torch_kernels/`` at the root of the checkout, under a name that
carries a hash of the source, the headers it may include (``csrc/*.cuh``)
and the flags, so an edited source or header is rebuilt and an unchanged
one is not.  A failed build raises with nvcc's output.

Nothing here runs at import time: the CPU tests import every module of the
port on hosts that have no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Tuple

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
SOURCES = ("attention", "poe", "kl", "sparse_attention", "sample")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            f"nvcc not found on PATH or at {path}; the CUDA kernels need "
            "the CUDA toolkit to build")
    return path


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` goes, keyed by a hash of it,
    the headers beside it (``csrc/*.cuh``) and the flags."""
    text = (CSRC / f"{name}.cu").read_bytes() + b"".join(
        h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def _build_locked(names: Iterable[str]) -> Dict[str, Tuple[float, str]]:
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    started = time.perf_counter()
    procs = {}
    for name in todo:  # one nvcc per source, all started together
        out = library_path(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    results, failures = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"--- {name}.cu (nvcc exit {proc.returncode})\n{log}")
            continue
        os.replace(tmp, out)
        results[name] = (time.perf_counter() - started, log)
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return results


def build(names: Iterable[str] = SOURCES) -> Dict[str, Tuple[float, str]]:
    """Compile every named source not built yet, in parallel.

    :return: {name -> (seconds from start until it was built, nvcc output)}
        for the sources this call compiled
    """
    with _lock:
        return _build_locked(tuple(names))


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            _build_locked((name,))
            lib = ctypes.CDLL(str(library_path(name)))
            _libs[name] = lib
        return lib


def function(name: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """``symbol`` of ``csrc/<name>.cu`` with its argument types set; the C
    functions all return an ``int`` (a ``cudaError_t``)."""
    lib = library(name)
    fn = getattr(lib, symbol)
    if fn.argtypes is None:
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return fn


def check(name: str, err: int) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch.

    Every source exports ``error_string(int)`` (``cudaGetErrorString``)."""
    if err != 0:
        describe = library(name).error_string
        describe.argtypes = [ctypes.c_int]
        describe.restype = ctypes.c_char_p
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err} "
                           f"({describe(err).decode()})")
